"""The port's autotuner (``repro_torch/tune``) against the reference's
cases (``tests/test_tune.py``), on the CPU: trials read their objective
from the metrics registry, the winning profile persists as a platform
config, ``IndexConfig.from_tuned`` round-trips it with the module-global
plan threshold, and the profile JSON is the reference's, key for key, so
either package loads the other's."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import IndexConfig as RefIndexConfig
from repro.engine import schedule as ref_schedule
from repro.tune import profile as ref_profile

from repro_torch.core import IndexConfig, build_index
from repro_torch.engine import schedule
from repro_torch.tune import (TunedProfile, autotune, load_profile,
                              platform_key, profile_path, run_trial,
                              save_profile, verify_profile)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_thresholds():
    prev = schedule.set_plan_thresholds()
    ref_prev = ref_schedule.set_plan_thresholds()
    yield
    schedule.set_plan_thresholds(**prev)
    ref_schedule.set_plan_thresholds(**ref_prev)


KNOBS = {"tile": 256, "leaf_width": 512, "histogram_max_pages": 16,
         "queue_min_flush": 128, "queue_deadline_s": 0.001,
         "specialize": True}
OBJECTIVE = {"lookup": {"p50": 1e-4, "p99": 2e-4, "mean": 1.2e-4,
                        "count": 8}}


def _profile(**knobs):
    return TunedProfile(platform="testplat", backend="cpu",
                        device_kind="fake", knobs=dict(KNOBS, **knobs),
                        objective=OBJECTIVE)


def test_profile_round_trip(tmp_path):
    prof = _profile()
    path = save_profile(prof, str(tmp_path))
    assert path == profile_path("testplat", str(tmp_path))
    with open(path) as f:
        assert json.load(f)["version"] == prof.version
    got = load_profile("testplat", str(tmp_path))
    assert got.knobs == prof.knobs
    assert got.objective == prof.objective


def test_from_tuned_maps_knobs_and_thresholds(tmp_path):
    save_profile(_profile(), str(tmp_path))
    cfg = IndexConfig.from_tuned("testplat", profile_dir=str(tmp_path))
    assert cfg.kind == "tiered"
    assert cfg.tile == 256 and cfg.leaf_width == 512
    assert cfg.specialize is True
    assert cfg.queue_min_flush == 128
    assert cfg.queue_deadline_s == pytest.approx(0.001)
    # histogram_max_pages is a module-global plan threshold, applied as a
    # side effect, not a config field
    assert schedule.HISTOGRAM_MAX_PAGES == 16
    # overrides win over the profile
    cfg2 = IndexConfig.from_tuned("testplat", profile_dir=str(tmp_path),
                                  tile=128, mutable=True)
    assert cfg2.tile == 128 and cfg2.mutable is True


def test_from_tuned_missing_profile_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="autotune"):
        IndexConfig.from_tuned("absent", profile_dir=str(tmp_path))


def test_newer_profile_version_rejected(tmp_path):
    prof = _profile()
    prof.version = 99
    path = save_profile(prof, str(tmp_path))
    assert os.path.exists(path)
    with pytest.raises(ValueError, match="newer"):
        load_profile("testplat", str(tmp_path))


def test_platform_key_sanitizes():
    assert platform_key("NVIDIA A100-SXM!") == "nvidia_a100_sxm"
    assert platform_key() == ("gpu" if torch.cuda.is_available() else "cpu")
    assert platform_key("NVIDIA A100-SXM!") == \
        ref_profile.platform_key("NVIDIA A100-SXM!")


def test_run_trial_objective_comes_from_registry():
    t = run_trial({"tile": 128, "leaf_width": None,
                   "histogram_max_pages": 32, "queue_min_flush": 32,
                   "queue_deadline_s": 1e-3}, n=2000, q_n=256, reps=2,
                   device="cpu")
    obj = t["objective"]
    for path in ("lookup", "scan", "flush"):
        assert obj[path]["count"] > 0, path
        assert obj[path]["p50"] > 0.0
        assert obj[path]["p99"] >= obj[path]["p50"]
        assert obj[path]["mean"] > 0.0
    assert obj["lookup"]["count"] == 2 and obj["scan"]["count"] == 2
    assert t["score"][0] > 0.0
    # the trial ran under its own registry
    assert "engine_op_seconds" in t["registry"]


def test_autotune_smoke_persists_and_verifies(tmp_path):
    prof, path = autotune(smoke=True, n=2000, q_n=256, reps=2,
                          platform="smoketest", profile_dir=str(tmp_path),
                          device="cpu")
    assert os.path.exists(path)
    assert prof.knobs["specialize"] is True
    assert prof.backend == "cpu" and prof.device_kind == "cpu"
    assert len(prof.trials) == 3            # 2-point stage A + 1-point B
    # the persisted profile loads through the public entry point and
    # builds a working specialized store
    cfg = IndexConfig.from_tuned("smoketest", profile_dir=str(tmp_path),
                                 mutable=True)
    keys = np.sort(np.random.RandomState(0).choice(
        1 << 16, 500, replace=False)).astype(np.int32)
    idx = build_index(keys, None, cfg, device="cpu")
    assert idx._spec_fused is not None
    res = idx.lookup(keys[:32])
    assert bool(res.found.all())
    idx.close()
    v = verify_profile(prof, profile_dir=str(tmp_path), n=2000, q_n=256,
                       reps=2, device="cpu")
    assert set(v) >= {"ok", "fresh_p50", "recorded_p50"}
    assert v["fresh_p50"] > 0.0 and v["config"]["specialize"] is True


def test_profiles_cross_between_packages(tmp_path):
    """A profile the reference writes loads through the port's from_tuned
    with the same knobs and threshold, and the reverse; the JSON keys are
    the same."""
    ref = ref_profile.TunedProfile(platform="refplat", backend="cpu",
                                   device_kind="cpu", knobs=dict(KNOBS),
                                   objective=OBJECTIVE)
    ref_path = ref_profile.save_profile(ref, str(tmp_path))
    got = IndexConfig.from_tuned("refplat", profile_dir=str(tmp_path),
                                 mutable=True)
    want = RefIndexConfig.from_tuned("refplat", profile_dir=str(tmp_path),
                                     mutable=True)
    assert {f: getattr(got, f) for f in IndexConfig.__dataclass_fields__} \
        == {f: getattr(want, f) for f in IndexConfig.__dataclass_fields__}
    assert schedule.HISTOGRAM_MAX_PAGES == ref_schedule.HISTOGRAM_MAX_PAGES \
        == 16
    port_path = save_profile(dataclasses.replace(_profile(), platform="pt"),
                             str(tmp_path))
    back = ref_profile.load_profile("pt", str(tmp_path))
    assert back.knobs == KNOBS and back.objective == OBJECTIVE
    with open(ref_path) as f, open(port_path) as g:
        assert set(json.load(f)) == set(json.load(g))
