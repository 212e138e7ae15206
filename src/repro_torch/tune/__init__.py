"""Platform autotuner (DESIGN.md §10), PyTorch port of ``repro.tune``.

Sweeps the index/queue knobs — ``tile`` × ``leaf_width`` ×
``HISTOGRAM_MAX_PAGES`` × queue ``flush_at`` / ``queue_deadline_s`` — on
one device, reading its objective from the metrics registry between
trials (p50/p99 of ``engine_op_seconds``; there is NO parallel timing
harness), and persists the winning knobs plus the registry snapshot as a
platform profile under ``src/repro_torch/configs/``.
``IndexConfig.from_tuned(platform)`` loads it back.
"""
from .profile import (  # noqa: F401
    TunedProfile, platform_key, profile_path, default_profile_dir,
    save_profile, load_profile)
from .autotune import autotune, run_trial, verify_profile  # noqa: F401
