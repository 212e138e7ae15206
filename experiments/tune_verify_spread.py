#!/usr/bin/env python3
"""The spread of the autotuner's lookup objective on the card.

    python3 experiments/tune_verify_spread.py [--reps 8 32] [--runs 2]
                                              [--out F]

The autotuner (``repro_torch/tune``) scores a sweep point by the p50 of
``engine_op_seconds{path="lookup"}``, on the card the time from a store
lookup's call to the device's completion (the reference times the
call's dispatch boundary), in sqrt-2 buckets, and ``verify_profile``
accepts a profile when a fresh p50 lies within 10% or one bucket of the
recorded one. This
prints, on the autotuner's own workload at 2^24 keys and 2^16 queries:

- the host dispatch times (µs, p10 / p50 / p90 of 64 after one warm-up,
  the device idle before each) of the specialized and the args store's
  lookup at tile 256;
- for each ``--reps``, ``--runs`` smoke sweeps with ``verify_profile``:
  every trial's lookup p50 and mean, the fresh and recorded p50, ok.

The last line of the output is one JSON object; ``--out`` writes it to a
file too.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

N_KEYS, N_QUERIES = 1 << 24, 1 << 16


def dispatch_us(specialize: bool, keys, q, dev) -> list:
    from repro_torch.core import IndexConfig, build_index
    store = build_index(keys, None, IndexConfig(
        kind="tiered", mutable=True, specialize=specialize, tile=256),
        device=dev)
    qd = torch.from_numpy(q).to(dev)
    store.lookup(qd)
    torch.cuda.synchronize()
    out = []
    for _ in range(64):
        t0 = time.perf_counter()
        store.lookup(qd)
        out.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    store.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_verify_spread: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.engine import schedule
    from repro_torch.tune import autotune, verify_profile
    from repro_torch.tune.autotune import _workload
    dev = torch.device("cuda")
    keys, q, _, _ = _workload(N_KEYS, N_QUERIES, 0)
    result = {"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "dispatch_us": {}, "sweeps": []}
    for spec in (True, False):
        ts = dispatch_us(spec, keys, q, dev)
        result["dispatch_us"]["spec" if spec else "args"] = \
            np.percentile(ts, [10, 50, 90]).tolist()
        print(f"{'spec' if spec else 'args'} dispatch µs p10/p50/p90 "
              f"{np.percentile(ts, [10, 50, 90]).round(1).tolist()}",
              flush=True)
    for reps in args.reps:
        for _ in range(args.runs):
            d = tempfile.mkdtemp(prefix="tune_spread_")
            prev = schedule.set_plan_thresholds()
            try:
                prof, _ = autotune(smoke=True, n=N_KEYS, q_n=N_QUERIES,
                                   reps=reps, profile_dir=d)
                v = verify_profile(prof, profile_dir=d, n=N_KEYS,
                                   q_n=N_QUERIES, reps=reps)
            finally:
                schedule.set_plan_thresholds(**prev)
            row = {"reps": reps,
                   "trial_lookup_p50_mean_us": [
                       [t["objective"]["lookup"]["p50"] * 1e6,
                        t["objective"]["lookup"]["mean"] * 1e6]
                       for t in prof.trials],
                   "fresh_p50_us": v["fresh_p50"] * 1e6,
                   "recorded_p50_us": v["recorded_p50"] * 1e6,
                   "ok": v["ok"]}
            result["sweeps"].append(row)
            print(json.dumps(row), flush=True)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
