"""Persisted per-platform tuning profiles (PyTorch port of
``repro/tune/profile.py``; the JSON is the reference's, key for key, so
either package loads the other's profiles).

A profile is one JSON file, ``tuned_<platform>.json``, under
``src/repro_torch/configs/`` by default. It records:

* ``knobs`` — the winning sweep point: ``tile``, ``leaf_width``,
  ``histogram_max_pages``, ``queue_min_flush``, ``queue_deadline_s``,
  ``specialize``.
* ``objective`` — the registry-derived score of that point: per path
  (``lookup`` / ``scan`` / ``flush``) the p50/p99 bucket bounds, the
  exact mean, and the observation count, straight from
  ``obs.Registry.merged_histogram("engine_op_seconds", path=...)``.
* ``trials`` — every swept point with its score (the sweep's audit
  trail).
* ``registry`` — the winning trial's full registry snapshot.

``IndexConfig.from_tuned`` maps ``knobs`` into config fields and applies
``histogram_max_pages`` to ``engine.schedule`` (a module-global plan
threshold — machine-wide, not per-config). A profile holds times of the
device it was tuned on: the reference's CPU profile does not carry over to
the card, and the port commits none.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional

PROFILE_VERSION = 1

# knob -> IndexConfig field (identity unless renamed here)
_CONFIG_KNOBS = {
    "tile": "tile",
    "leaf_width": "leaf_width",
    "specialize": "specialize",
    "queue_min_flush": "queue_min_flush",
    "queue_deadline_s": "queue_deadline_s",
}


def platform_key(platform: Optional[str] = None) -> str:
    """Filesystem-safe platform id: the explicit name, else the current
    backend by the names ``jax.default_backend()`` gives: "gpu" when a
    CUDA card is present, else "cpu"."""
    if platform is None:
        import torch
        platform = "gpu" if torch.cuda.is_available() else "cpu"
    key = re.sub(r"[^a-zA-Z0-9_]+", "_", str(platform)).strip("_").lower()
    if not key:
        raise ValueError(f"empty platform key from {platform!r}")
    return key


def default_profile_dir() -> str:
    return os.path.normpath(
        os.path.join(os.path.dirname(__file__), os.pardir, "configs"))


def profile_path(platform: Optional[str] = None,
                 profile_dir: Optional[str] = None) -> str:
    return os.path.join(profile_dir or default_profile_dir(),
                        f"tuned_{platform_key(platform)}.json")


@dataclasses.dataclass
class TunedProfile:
    platform: str                 # filesystem key (the backend by default)
    backend: str                  # "gpu" / "cpu" at tune time
    device_kind: str              # torch.cuda.get_device_name(), or "cpu"
    knobs: Dict[str, Any]         # winning sweep point
    objective: Dict[str, Any]     # per-path {p50, p99, mean, count} + score
    trials: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    registry: Dict[str, Any] = dataclasses.field(default_factory=dict)
    version: int = PROFILE_VERSION

    def config_kwargs(self) -> Dict[str, Any]:
        """The profile's knobs as ``IndexConfig`` keyword args (tiered
        kind implied — that is the engine the tuner measures)."""
        kw: Dict[str, Any] = {"kind": "tiered"}
        for knob, field in _CONFIG_KNOBS.items():
            if knob in self.knobs and self.knobs[knob] is not None:
                kw[field] = self.knobs[knob]
        return kw

    def apply_thresholds(self) -> None:
        """Apply the module-global plan thresholds the profile carries
        (currently ``histogram_max_pages``) to ``engine.schedule``."""
        hmp = self.knobs.get("histogram_max_pages")
        if hmp is not None:
            from ..engine import schedule
            schedule.set_plan_thresholds(max_pages=int(hmp))

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TunedProfile":
        ver = int(d.get("version", 0))
        if ver > PROFILE_VERSION:
            raise ValueError(
                f"tuned profile version {ver} is newer than this build "
                f"understands ({PROFILE_VERSION}); re-run the autotuner")
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def save_profile(prof: TunedProfile,
                 profile_dir: Optional[str] = None) -> str:
    """Write the profile atomically (tmp + rename) and return its path."""
    path = profile_path(prof.platform, profile_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(prof.to_json(), f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_profile(platform: Optional[str] = None,
                 profile_dir: Optional[str] = None) -> TunedProfile:
    path = profile_path(platform, profile_dir)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no tuned profile at {path}; run "
            f"`python -m repro_torch.tune.autotune` (or pass profile_dir)")
    with open(path) as f:
        return TunedProfile.from_json(json.load(f))
