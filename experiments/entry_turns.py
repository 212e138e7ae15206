#!/usr/bin/env python3
"""Time the index entry points of the port on one NVIDIA card, with many
repetitions, for comparing two trees in alternating processes.

    PYTHONPATH=<tree>/src python3 experiments/entry_turns.py [--reps 41]

Builds chip_smoke.py's main-path index (2^24 unique int32 keys with int32
values, seed 0) and its 2^18 scan ranges, then times each entry point
(CUDA events around each call, after warm-up) and prints one JSON line:
per entry the median and quartiles in ms and the profiler's summed
kernel time of one call. Whichever ``repro_torch`` is first on the path
is measured, so the same script times a parent and a change: run it in
turns (parent, change, change, parent) within one machine.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

I32 = np.iinfo(np.int32)
N_KEYS, N_RANGES, N_MAT, MAT_K = 1 << 24, 1 << 18, 1 << 16, 64


def event_ms(fn, reps: int) -> list[float]:
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def kernels_ms(fn) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=41)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("entry_turns: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch import IndexConfig, build_index
    rng = np.random.default_rng(0)
    keys = (I32.min + 1 + np.arange(N_KEYS, dtype=np.int64) * 255
            + rng.integers(0, 255, N_KEYS)).astype(np.int32)
    values = rng.integers(I32.min, I32.max, N_KEYS, dtype=np.int64
                          ).astype(np.int32)
    idx = build_index(keys[rng.permutation(N_KEYS)], values,
                      IndexConfig(kind="tiered"))
    dev = torch.device("cuda")
    w = np.minimum(np.exp(rng.uniform(0, np.log(1 << 17), N_RANGES))
                   .astype(np.int64), 1 << 17)
    r = rng.integers(0, N_KEYS - w + 1)
    lo = torch.from_numpy(keys[r]).to(dev)
    hi = torch.from_numpy(keys[r + w - 1]).to(dev)
    q = torch.from_numpy(keys[rng.integers(0, N_KEYS, 1 << 20)]).to(dev)
    calls = {
        "lookup": lambda: idx.lookup(q),
        "scan_range": lambda: idx.scan_range(lo, hi),
        "search_range": lambda: idx.search_range(lo, hi),
        "scan_range_materialize": lambda: idx.scan_range(
            lo[:N_MAT], hi[:N_MAT], materialize=MAT_K),
    }
    out = {"tree": repro_torch.__file__, "reps": args.reps,
           "device": torch.cuda.get_device_name(0),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip()}
    for name, fn in calls.items():
        t = np.array(event_ms(fn, args.reps))
        out[name] = {"median_ms": float(np.median(t)),
                     "q1_ms": float(np.percentile(t, 25)),
                     "q3_ms": float(np.percentile(t, 75)),
                     "kernels_ms": kernels_ms(fn)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
