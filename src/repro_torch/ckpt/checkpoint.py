"""Manifest-verified snapshots (PyTorch port of ``repro/ckpt/checkpoint.py``
for the single-host path): atomic, keep-N, newest-verifying restore.

Layout: ``<dir>/step_<n>/arrays.host0.npz + manifest.json``, written to a
temporary directory and renamed (atomic on POSIX), so a crash while saving
never leaves a snapshot that restore would trust; restore takes the newest
step whose manifest and arrays verify and warns when it falls back. Trees
are nested dicts of arrays, flattened to ``"a/b"`` names in sorted key
order, the names the reference's pytree flatten gives, so either package
restores what the other wrote.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import warnings
from typing import Any, Optional

import numpy as np


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b": array} for a nested dict / list / tuple of arrays, keys in
    the reference's order: sorted dict keys, positional sequence indices."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Write ``tree`` as snapshot ``step`` and keep the newest ``keep``
    snapshots. Returns the snapshot's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    arrays = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.host0.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "hosts": 1,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            try:
                out.append(int(d.split("_")[1].split(".")[0]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _verify(path: str, manifest: dict) -> bool:
    """Deep verification: every manifest key present, every member read
    in full (np.load is lazy; reading each array forces the zip member's
    CRC32 check, which catches bit flips and truncation), and shape and
    dtype as the manifest says."""
    try:
        with np.load(os.path.join(path, "arrays.host0.npz")) as z:
            if sorted(z.files) != manifest["keys"]:
                return False
            for k in z.files:
                a = z[k]
                if list(a.shape) != manifest["shapes"][k] or \
                        str(a.dtype) != manifest["dtypes"][k]:
                    return False
        return True
    except Exception:
        return False


def restore(ckpt_dir: str, step: Optional[int] = None) -> tuple[dict, int]:
    """The newest verifying snapshot (or ``step``) as its raw ``{"a/b":
    array}`` dict with the stored dtypes, and its step; a corrupt or torn
    newer snapshot is skipped with a RuntimeWarning. Raises
    FileNotFoundError when no snapshot verifies. (The reference's
    ``restore(ckpt_dir, None)``; its pytree ``target`` has no caller
    here.)"""
    candidates = [step] if step is not None \
        else list(reversed(all_steps(ckpt_dir)))
    for i, s in enumerate(candidates):
        path = os.path.join(ckpt_dir, f"step_{s:08d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except Exception:
            continue
        if not _verify(path, manifest):
            continue                            # torn checkpoint: skip back
        if i > 0:
            warnings.warn(
                f"checkpoint step {candidates[0]} in {ckpt_dir} failed "
                f"verification; falling back to step {s}",
                RuntimeWarning, stacklevel=2)
        with np.load(os.path.join(path, "arrays.host0.npz")) as z:
            return {k: z[k] for k in z.files}, s
    raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
