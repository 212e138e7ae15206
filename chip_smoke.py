#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero with its traceback:

  1. print the card's name and power limit (nvidia-smi), build the CUDA
     kernels from src/repro_torch/csrc (one nvcc per source, in parallel);
  2. the page-search kernel against its plain PyTorch version, bit for bit:
     int32 and float32 keys, lw_pad 128 and 2048, stride leaf_width and
     lw_pad, steps_used < grid, skewed buckets, Q = 0;
  3. the k-ary kernel against its plain version, bit for bit: depth 1 and
     2, int32 keys near INT32_MIN and INT32_MAX - 1, float32 keys with
     +-0, negatives, large magnitudes and subnormals;
  4. the main path at full size: build_index over 2^24 unique int32 keys
     with int32 values on the card, one lookup of 2^20 queries (half hits,
     half uniform) with both launch counters set to 0 before it and read
     after it, under torch.cuda.set_sync_debug_mode("error"); rank, found
     and values against np.searchsorted on the host; then CUDA-event times
     of the lookup, its stages and each kernel at the main path's shapes,
     each kernel held against its plain version on those inputs, and one
     lookup under torch.profiler (device time by op, summed kernel time);
  5. coverage runs against the oracle: 32,768 keys (NitroGen top), 2^20
     float32 keys, a duplicate-heavy key set, plan="host";
  6. one line {"kernels": [...]} with each kernel's launches, times and
     bound; the last line {"ok": true, "device": {...}}.

Without a CUDA card the script exits non-zero at once and prints no
result: the kernels exist only on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

I32 = np.iinfo(np.int32)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# A compare is one 32-bit instruction. The H100 SXM's published 67 TFLOP/s
# float32 peak counts an FMA as two operations: 33.5e12 instructions/s.
COMPARES_PER_S = 33.5e12
N_KEYS = 1 << 24
N_QUERIES = 1 << 20


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times, after warm-up calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_profile(fn, top: int = 8) -> dict:
    """One call of `fn` under torch.profiler: the device time of the
    heaviest aten ops (inclusive: an op's kernels and its children's) and
    the summed time of the kernels themselves, which against the call's
    CUDA-event time gives the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: e.device_time_total, reverse=True)
    return {"kernels_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "kernel_launches": sum(e.count for e in kernels),
            "ops_ms": {e.key: e.device_time_total / 1e3 for e in ops[:top]}}


def bound(bytes_moved: float, compares: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = compares / COMPARES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sorted_count_compares(width: int) -> int:
    """Compares a binary search needs to count the keys below a query in a
    sorted row of `width` keys: ceil(log2(width + 1))."""
    return int(width).bit_length()


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def oracle(keys_sorted: np.ndarray, values_sorted: np.ndarray | None,
           queries: np.ndarray):
    rank = np.searchsorted(keys_sorted, queries, side="left")
    safe = np.minimum(rank, keys_sorted.size - 1)
    found = (rank < keys_sorted.size) & (keys_sorted[safe] == queries)
    vals = None if values_sorted is None else values_sorted[safe]
    return rank.astype(np.int32), found, vals


def check_lookup(res, want, what: str) -> None:
    rank, found, vals = want
    check(res.rank.dtype == torch.int32, f"{what}: ranks are not int32")
    check(np.array_equal(res.rank.cpu().numpy(), rank), f"{what}: ranks")
    check(np.array_equal(res.found.cpu().numpy(), found), f"{what}: found")
    if vals is not None:
        check(np.array_equal(res.values.cpu().numpy(), vals),
              f"{what}: values")


# --------------------------------------------------------------- phase 2
def page_inputs(index, q: torch.Tensor):
    """The page kernel's operands exactly as the device-plan pipeline
    builds them: (qb [g_cap, tile], step_pages, steps_used)."""
    from repro_torch.engine import schedule
    q_n, tile = q.shape[0], index.tile
    g_cap = schedule.ladder_grid(q_n, tile, index.num_pages)
    plan = schedule.device_plan(index.page_of(q), tile, g_cap,
                                index.num_pages)
    qb = torch.zeros(g_cap * tile, dtype=q.dtype, device=q.device) \
        .scatter_(0, plan.dest.long(), q).view(g_cap, tile)
    return qb, plan.step_pages, plan.steps_used


def phase_page(dev, rng) -> int:
    from repro_torch.engine import tiered
    from repro_torch.kernels import page_search as pk
    worst, surplus = 0, False
    for dtype in (np.int32, np.float32):
        for leaf_width in (100, 2000):                    # lw_pad 128, 2048
            n = leaf_width * 300 - 17
            if dtype == np.int32:
                keys = rng.integers(I32.min + 1, I32.max - 1, n).astype(dtype)
                q = rng.integers(I32.min + 1, I32.max - 1, 20000).astype(dtype)
            else:
                keys = (rng.normal(size=n) * 1e4).astype(dtype)
                q = (rng.normal(size=20000) * 1e4).astype(dtype)
            idx = tiered.build(keys, leaf_width=leaf_width, device=dev)
            skew = q.copy()
            skew[: q.size * 3 // 4] = np.sort(keys)[leaf_width * 7 + 3]
            for qs in (q, skew, q[:0]):
                qd = torch.from_numpy(qs).to(dev)
                qb, sp, used = page_inputs(idx, qd)
                u = int(used)
                surplus |= u < sp.shape[0]
                for stride in (idx.leaf_width, idx.lw_pad):
                    got = pk.page_search_bucketed(qb, sp, idx.pages,
                                                  stride=stride,
                                                  steps_used=used)
                    full = pk.page_search_bucketed(qb, sp, idx.pages,
                                                   stride=stride)
                    want = pk.page_search_plain(qb, sp, idx.pages,
                                                stride=stride)
                    torch.cuda.synchronize()
                    check(torch.equal(got[:u], want[:u]),
                          f"page kernel != plain ({dtype.__name__}, "
                          f"lw_pad {idx.lw_pad}, stride {stride})")
                    check(torch.equal(full, want),
                          "page kernel over every step != plain")
                    worst = max(worst, max_abs_err(got[:u], want[:u]))
    check(surplus, "no case had steps_used below the grid")
    return worst


# --------------------------------------------------------------- phase 3
def kary_cases(rng):
    lo = I32.min + np.arange(4096)
    hi = I32.max - 1 - np.arange(4096)
    tiny = np.float32(1e-45)
    mags = (rng.normal(size=8000) * 10.0 ** rng.integers(-30, 30, 8000))
    floats = np.unique(np.concatenate([
        mags, [0.0, -1.0, -3.4e38, 3.4e38, tiny, -tiny, 2 * tiny]])
        .astype(np.float32))
    ints = np.unique(rng.integers(I32.min + 1, I32.max - 1, 8192)
                     ).astype(np.int32)
    return [("int32 depth 1", ints[:100]), ("int32 depth 2", ints),
            ("int32 extremes", np.concatenate([lo, hi]).astype(np.int32)),
            ("float32 depth 1", floats[::80]), ("float32 depth 2", floats)]


def phase_kary(dev, rng) -> int:
    from repro_torch.core import kary as kary_core
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import ops
    worst = 0
    for what, keys in kary_cases(rng):
        idx = kary_core.build(keys, node_width=127, device=dev)
        flat, offsets = kk.flatten_levels(ops.kary_levels(idx, 128))
        if keys.dtype == np.int32:
            q = np.concatenate([
                rng.integers(I32.min, I32.max, 50000, dtype=np.int64),
                keys, np.maximum(keys.astype(np.int64) - 1, I32.min),
                [I32.min, I32.max - 1, I32.max - 2]])
        else:
            q = np.concatenate([rng.normal(size=50000) * 1e20, keys,
                                np.nextafter(keys, np.float32(-np.inf)),
                                [0.0, -0.0, -np.inf, 1e-45, -1e-45]])
        q = q.astype(keys.dtype)
        qd = torch.from_numpy(q).to(dev)
        got = kk.kary_search_levels(qd, flat, offsets, fanout=128, wpad=128)
        want = kk.kary_search_plain(qd, flat, offsets, fanout=128, wpad=128)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"k-ary kernel != plain ({what})")
        ref = np.searchsorted(np.sort(keys), q, side="left")
        check(np.array_equal(np.minimum(got.cpu().numpy(), keys.size), ref),
              f"k-ary kernel != np.searchsorted ({what})")
        worst = max(worst, max_abs_err(got, want))
    empty = kk.kary_search_levels(qd[:0], flat, offsets, fanout=128, wpad=128)
    check(empty.shape == (0,), "empty k-ary batch")
    return worst


# --------------------------------------------------------------- phase 4
def main_path(dev, rng):
    from repro_torch import IndexConfig, build_index
    from repro_torch.engine import schedule, tiered
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import ops
    from repro_torch.kernels import page_search as pk

    # 2^24 unique int32 keys spread over the whole int32 range, shuffled
    keys_sorted = (I32.min + 1 + np.arange(N_KEYS, dtype=np.int64) * 255
                   + rng.integers(0, 255, N_KEYS)).astype(np.int32)
    perm = rng.permutation(N_KEYS)
    keys = keys_sorted[perm]
    values = rng.integers(I32.min, I32.max, N_KEYS, dtype=np.int64
                          ).astype(np.int32)
    values_sorted = np.empty_like(values)
    values_sorted[perm] = values
    queries = rng.permutation(np.concatenate([
        keys[rng.integers(0, N_KEYS, N_QUERIES // 2)],
        rng.integers(I32.min + 1, I32.max - 1, N_QUERIES - N_QUERIES // 2
                     ).astype(np.int32)]))
    want = oracle(keys_sorted, values_sorted, queries)

    t0 = time.perf_counter()
    idx = build_index(keys, values, IndexConfig(kind="tiered"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    impl = idx.impl
    check((impl.top_kind, impl.num_pages, impl.leaf_width)
          == ("kary", 8192, 2048), "main path layout is not the k-ary top "
          f"over 8192 pages: {impl.top_kind}, {impl.num_pages}")
    q_dev = torch.from_numpy(queries).to(dev)
    torch.cuda.synchronize()

    pk.page_search_bucketed.launches = 0
    kk.kary_search_levels.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = idx.lookup(q_dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = {"page_search_bucketed": pk.page_search_bucketed.launches,
                "kary_search_levels": kk.kary_search_levels.launches}
    torch.cuda.synchronize()
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path did not launch: {launches}")
    check_lookup(res, want, "main path")

    # times: the lookup, its stages, and each kernel at these shapes
    tile, P = impl.tile, impl.num_pages
    pids = impl.page_of(q_dev)
    g_cap = schedule.ladder_grid(N_QUERIES, tile, P)
    qb, step_pages, used_t = page_inputs(impl, q_dev)
    used = int(used_t)
    stages = {
        "lookup_ms": cuda_ms(lambda: idx.lookup(q_dev)),
        "search_ms": cuda_ms(lambda: tiered.search(impl, q_dev)),
        "top_descent_ms": cuda_ms(lambda: impl.page_of(q_dev)),
        "device_plan_ms": cuda_ms(
            lambda: schedule.device_plan(pids, tile, g_cap, P)),
        "host_plan_search_ms": cuda_ms(
            lambda: tiered.search(impl, q_dev, plan="host"), reps=5),
    }
    stages["queries_per_s"] = N_QUERIES / (stages["lookup_ms"] * 1e-3)
    stages["profile"] = device_profile(lambda: idx.lookup(q_dev))

    levels = ops.kary_levels(impl.top, 128)
    flat, offsets = kk.flatten_levels(levels)
    wpad = int(levels[0].shape[1])
    k_args = (q_dev, flat, offsets)
    k_kw = dict(fanout=impl.top.fanout, wpad=wpad)
    k_got = kk.kary_search_levels(*k_args, **k_kw)
    k_plain = kk.kary_search_plain(*k_args, **k_kw)
    # each level's row is sorted, so a query needs a binary search per level
    k_bound = bound(2 * N_QUERIES * 4 + flat.numel() * 4,
                    N_QUERIES * len(offsets) * sorted_count_compares(wpad))
    kary_row = {
        "name": "kary_search_levels", "route": "cuda",
        "source": "src/repro_torch/csrc/kary_search.cu",
        "replaces": "src/repro/kernels/kary_search.py:75",
        "launches": launches["kary_search_levels"],
        "max_abs_err": max_abs_err(k_got, k_plain),
        "ms": cuda_ms(lambda: kk.kary_search_levels(*k_args, **k_kw)),
        "plain_ms": cuda_ms(lambda: kk.kary_search_plain(*k_args, **k_kw),
                            reps=5),
        "bound_ms": k_bound[0], "bound_by": k_bound[1],
        "library_ms": cuda_ms(lambda: torch.searchsorted(impl.seps, q_dev)),
    }

    p_args = (qb, step_pages, impl.pages)
    p_got = pk.page_search_bucketed(*p_args, stride=impl.leaf_width,
                                    steps_used=used_t)
    p_plain = pk.page_search_plain(*p_args, stride=impl.leaf_width)
    touched = int(torch.unique(step_pages[:used]).numel())
    lanes = used * tile
    # pages are sorted leaves: a binary search per used lane
    p_bound = bound(lanes * 4 * 2 + used * 4 + touched * impl.lw_pad * 4,
                    lanes * sorted_count_compares(impl.lw_pad))
    page_row = {
        "name": "page_search_bucketed", "route": "cuda",
        "source": "src/repro_torch/csrc/page_search.cu",
        "replaces": "src/repro/kernels/page_search.py:59",
        "launches": launches["page_search_bucketed"],
        "max_abs_err": max_abs_err(p_got[:used], p_plain[:used]),
        "ms": cuda_ms(lambda: pk.page_search_bucketed(
            *p_args, stride=impl.leaf_width, steps_used=used_t)),
        "plain_ms": cuda_ms(lambda: pk.page_search_plain(
            *p_args, stride=impl.leaf_width), reps=3),
        "bound_ms": p_bound[0], "bound_by": p_bound[1],
        "library_ms": cuda_ms(lambda: torch.searchsorted(idx.keys_sorted,
                                                         q_dev)),
    }
    check(kary_row["max_abs_err"] == 0 and page_row["max_abs_err"] == 0,
          "a kernel disagrees with its plain version at the main path's "
          "shapes")
    shape = {"keys": N_KEYS, "queries": N_QUERIES, "leaf_width":
             impl.leaf_width, "num_pages": P, "top": impl.top_kind,
             "grid": g_cap, "steps_used": used, "pages_touched": touched,
             "build_s": build_s}
    return [page_row, kary_row], dict(shape, **stages)


# --------------------------------------------------------------- phase 5
def coverage(dev, rng) -> dict:
    from repro_torch import IndexConfig, build_index
    out = {}

    def run(name, keys, q, **cfg):
        values = np.arange(keys.size, dtype=np.int32)
        order = np.argsort(keys, kind="stable")
        want = oracle(keys[order], values[order], q)
        idx = build_index(keys, values, IndexConfig(kind="tiered", **cfg))
        q_dev = torch.from_numpy(q).to(dev)
        check_lookup(idx.lookup(q_dev), want, name)
        out[name] = {"top": idx.impl.top_kind, "pages": idx.impl.num_pages,
                     "lookup_ms": cuda_ms(lambda: idx.lookup(q_dev), reps=10)}
        return idx, q_dev

    n = 32768
    keys = rng.integers(I32.min + 1, I32.max - 1, n).astype(np.int32)
    q = np.concatenate([keys[rng.integers(0, n, 1 << 15)],
                        rng.integers(I32.min + 1, I32.max - 1, 1 << 15)
                        ]).astype(np.int32)
    idx, q_dev = run("nitrogen_top_32768", keys, q)
    check(idx.impl.top_kind == "nitrogen", "32,768 keys take the NitroGen top")
    out["nitrogen_top_32768"]["top_descent_ms"] = cuda_ms(
        lambda: idx.impl.page_of(q_dev))
    out["nitrogen_top_32768"]["queries"] = int(q.size)

    n = 1 << 20
    keys = np.concatenate([(rng.normal(size=n - 4) * 10.0 **
                            rng.integers(-20, 20, n - 4)),
                           [0.0, -0.0, -3.4e38, 3.4e38]]).astype(np.float32)
    q = np.concatenate([keys[rng.integers(0, n, 1 << 16)],
                        rng.normal(size=1 << 16) * 1e10,
                        [-0.0, 0.0, np.inf, -np.inf]]).astype(np.float32)
    run("float32_1048576", keys, q)

    keys = rng.integers(0, 5000, n).astype(np.int32)
    q = np.arange(-3, 5004, dtype=np.int32)
    run("duplicates_1048576", keys, q)

    keys = rng.integers(I32.min + 1, I32.max - 1, n).astype(np.int32)
    q = np.concatenate([keys[rng.integers(0, n, 1 << 16)],
                        rng.integers(I32.min + 1, I32.max - 1, 1 << 16)
                        ]).astype(np.int32)
    run("host_plan_1048576", keys, q, plan="host")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's kernels run only on one",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    t0 = time.perf_counter()
    _build.build()
    print(f"phase 1: built {_build.sources()} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    print(f"phase 2: page kernel == plain, max_abs_err "
          f"{phase_page(dev, rng)}", flush=True)
    print(f"phase 3: k-ary kernel == plain, max_abs_err "
          f"{phase_kary(dev, rng)}", flush=True)
    rows, main = main_path(dev, rng)
    print("phase 4: main path " + json.dumps(main), flush=True)
    print("phase 5: coverage " + json.dumps(coverage(dev, rng)), flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
