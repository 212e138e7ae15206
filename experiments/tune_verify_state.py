#!/usr/bin/env python3
"""The autotuner's lookup timing in a fresh process and after
``chip_smoke.py``'s phases 1-14d, on the card.

    python3 experiments/tune_verify_state.py fresh|smoke OUT.json

``smoke`` runs ``chip_smoke.py``'s ``main`` up to phase 14e and measures
there instead of 14e (then stops); ``fresh`` builds the kernels and
measures at once. At the autotuner's workload (2^24 keys, 2^16 queries)
it prints one JSON object (also written to OUT.json):

- ``state``: live threads, Python heap objects, device memory;
- the host time of a specialized store lookup's dispatch (µs), median of
  each window of 32 of 256 reps (the device idle before each rep), and
  p10 / p50 / p90: right after the build (``A_after_build``), with the
  cyclic collector off (``A_gc_off``), after a scan (``A_after_scan``),
  on a new store after ``gc.collect()`` (``B_after_collect``) and with
  the heap frozen (``C_frozen``);
- a ``cProfile`` of 128 lookups (``cprofile``);
- four smoke sweeps with ``verify_profile`` at 128 reps, the last two
  with the heap frozen: every trial's lookup p50 and mean (µs), the
  fresh and recorded p50, ok.
"""
import cProfile
import gc
import io
import json
import os
import pstats
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

N_KEYS, N_QUERIES, REPS = 1 << 24, 1 << 16, 128


def state() -> dict:
    return {"threads": [t.name for t in threading.enumerate()],
            "gc_objects": len(gc.get_objects()),
            "gc_count": gc.get_count(), "gc_thr": gc.get_threshold(),
            "mem_alloc": torch.cuda.memory_allocated(),
            "mem_reserved": torch.cuda.memory_reserved(),
            "loadavg": os.getloadavg(),
            "affinity": len(os.sched_getaffinity(0))}


def windows(store, qd, n: int = 256, w: int = 32) -> dict:
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        store.lookup(qd)
        ts.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    ts = np.array(ts)
    return {"win_p50": [float(np.median(ts[i:i + w]))
                        for i in range(0, n, w)],
            "p10_50_90": np.percentile(ts, [10, 50, 90]).tolist()}


def fresh_store(keys, qd, cfg, dev):
    from repro_torch.core import build_index
    store = build_index(keys, None, cfg, device=dev)
    store.lookup(qd)
    torch.cuda.synchronize()
    return store


def experiments(dev) -> dict:
    from repro_torch.core import IndexConfig
    from repro_torch.engine import schedule
    from repro_torch.tune import autotune, verify_profile
    from repro_torch.tune.autotune import _workload
    out = {"state": state()}
    keys, q, lo, hi = _workload(N_KEYS, N_QUERIES, 0)
    qd = torch.from_numpy(q).to(dev)
    lod, hid = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
    cfg = IndexConfig(kind="tiered", mutable=True, specialize=True,
                      tile=256)
    store = fresh_store(keys, qd, cfg, dev)
    out["A_after_build"] = windows(store, qd)
    gc.disable()
    out["A_gc_off"] = windows(store, qd)
    gc.enable()
    store.scan_range(lod, hid)
    torch.cuda.synchronize()
    out["A_after_scan"] = windows(store, qd)
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(128):
        store.lookup(qd)
        torch.cuda.synchronize()
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(25)
    out["cprofile"] = s.getvalue()[-6000:]
    store.close()
    del store
    gc.collect()
    out["state_after_collect"] = state()
    store = fresh_store(keys, qd, cfg, dev)
    out["B_after_collect"] = windows(store, qd)
    store.close()
    del store
    gc.collect()
    gc.freeze()
    store = fresh_store(keys, qd, cfg, dev)
    out["C_frozen"] = windows(store, qd)
    store.close()
    del store
    gc.unfreeze()
    sweeps = []
    for freeze in (False, False, True, True):
        if freeze:
            gc.collect()
            gc.freeze()
        d = tempfile.mkdtemp(prefix="tune_state_")
        prev = schedule.set_plan_thresholds()
        try:
            prof, _ = autotune(smoke=True, n=N_KEYS, q_n=N_QUERIES,
                               reps=REPS, profile_dir=d)
            v = verify_profile(prof, profile_dir=d, n=N_KEYS,
                               q_n=N_QUERIES, reps=REPS)
        finally:
            schedule.set_plan_thresholds(**prev)
            gc.unfreeze()
        sweeps.append({"freeze": freeze, "trials": [
            [t["objective"]["lookup"]["p50"] * 1e6,
             t["objective"]["lookup"]["mean"] * 1e6] for t in prof.trials],
            "fresh": v["fresh_p50"] * 1e6,
            "recorded": v["recorded_p50"] * 1e6, "ok": v["ok"]})
        print(json.dumps(sweeps[-1]), flush=True)
    out["sweeps"] = sweeps
    return out


class _Stop(Exception):
    pass


def main() -> int:
    if len(sys.argv) != 3 or sys.argv[1] not in ("fresh", "smoke"):
        print(__doc__.splitlines()[3].strip(), file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tune_verify_state: no CUDA card", file=sys.stderr)
        return 1
    mode, path = sys.argv[1], sys.argv[2]
    dev = torch.device("cuda")
    if mode == "fresh":
        from repro_torch.kernels import _build
        _build.build()
        res = experiments(dev)
    else:
        import chip_smoke
        box = {}

        def in_place_of_14e(d):
            box["res"] = experiments(d)
            raise _Stop()
        chip_smoke.spec_autotune_path = in_place_of_14e
        sys.argv = ["chip_smoke.py"]
        try:
            chip_smoke.main()
        except _Stop:
            pass
        res = box["res"]
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "cprofile"}))
    print(res["cprofile"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
