#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero with its traceback:

  1. print the card's name and power limit (nvidia-smi), build the CUDA
     kernels from src/repro_torch/csrc (one nvcc per source, in parallel)
     and print each kernel's registers, shared memory and spills as
     ptxas reported them;
  2. the page-search kernel against its plain PyTorch version, bit for bit:
     int32 and float32 keys, lw_pad 128, 2048 and 5120 (pages wider than
     one staged chunk), stride leaf_width and lw_pad, steps_used < grid,
     skewed buckets, Q = 0; then operands built directly at TQ 1, 33 and
     1024 (lw_pad 2048 and 5120) with step pages in page order and
     shuffled, and float32 pages with NaN, +-inf and +-0.0 queries;
  3. the k-ary kernel against its plain version, bit for bit: depth 1, 2
     and 3 (the third level searched in device memory), int32 keys near
     INT32_MIN and INT32_MAX - 1 and with duplicate runs, float32 keys
     with +-0, negatives, large magnitudes and subnormals;
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
  6. the page-scan kernel in each of count, sum and full mode, with and
     without a value mask, and the page-prefix kernel with and without
     values, against their plain versions: int32 and float32, lw_pad 128,
     2048 and 5120, steps_used < grid, skewed buckets, inert bound pairs,
     int32 sums that wrap, Q = 0; the direct operands of phase 2 (TQ 1,
     33, 1024, shuffled step pages); float32 value pages holding NaN,
     +-inf, +-1e30, -0.0 and +0.0 inside and outside the ranges (min and
     max NaN where a NaN value is in range, -0.0 and +0.0 where a range
     takes in both zeros); counts, int32 sums, min and max bit for bit
     (NaN at the same lanes, the sign of every zero), float sums to rtol
     1e-4;
  7. the range-scan path at full size on phase 4's index: scan_range over
     2^18 ranges (full aggregates), search_range, scan_range with
     materialize=64, scan_groups with G = 64 (count/sum through the prefix
     kernel, full through the span expansion, top_k=8), scan_multi (union
     and intersect), all under set_sync_debug_mode("error") with the
     launch counters set to 0 before and read after; every result against
     a numpy oracle (counts, ranks and wrapped int32 sums on every query,
     min, max, rows and top-K on a 4096-query subset); then CUDA-event
     times of each entry point, its stages and each new kernel;
  8. the CDF-inversion kernel against its plain version, bit for bit:
     B in {1, 3, 8, 64, 256} by V in {1, 7, 100, 1000, 2048, 152,064},
     softmax-sorted rows with flat runs and +inf tails and u at 0, 1e-6,
     on a cdf entry, above cdf[-1] and in a flat run
     (np.searchsorted(..., "left") clipped to V - 1 agrees there), each
     V - 1 and a base off 16-byte alignment (the
     scalar path), rows that are not monotone (the count differs from a
     binary search) and NaN in rows and in u; 70,000 rows (the row loop
     past the grid) and B = 0. Then at V = 152,064 and B in {1, 8, 64,
     256} the kernel's CUDA-event and profiler device time beside
     torch.searchsorted, the plain version and the byte bound. With
     --earlier-cdf SRC (the replaced design's cdf_search.cu, e.g. from
     `git show 2ff2086:src/repro_torch/csrc/cdf_search.cu`) that design
     is built beside phase 1's builds, held to the plain version and
     timed in turns with the new one (earlier, new, new, earlier);
     without it its times are null;
  9. the serving path at qwen3-0.6b's full width (28 layers, d_model
     1024, vocab 151,936 padded to 152,064; 596,180,992 float32
     parameters from the seed): ServeEngine on its default prefix store,
     the mutable tiered store, 8 prompts of 48 tokens sharing 32 (the
     reference launcher's prompts), 32 sampled decode steps (temperature
     0.8, top-p 0.9), two rounds, with the launch counters set to 0
     before and read after; then the same on the wholesale store (the
     immutable index rebuilt on the probe after an insert), same weights.
     Checks: (a) prefill computed/reused 288/480 and the store stats and
     write-path counters the reference launcher prints for each posture;
     (b) warm prefill logits equal cold ones within 2e-3; (c) greedy
     tokens equal the argmax of a full forward where the top-2 margin
     exceeds 2e-3; (d) every sampled token inside its top-p nucleus
     (float64, 1e-4 slack); (e) one cdf_search launch per decode step and
     the kernel equal to its plain version on every captured (cdf, u);
     the mutable store keeps its 10 page hashes in the delta buffer and
     launches no page kernel, the wholesale store's page kernel equals
     its plain version on every probe, at the store's own shapes; (f) one
     decode step (sample + decode_step) under set_sync_debug_mode
     ("error"); (g) the mutable prefix store saved after its two rounds
     and restored into a fresh engine on the same weights: one more round
     there reuses as many tokens as round 2 and launches the CDF kernel
     once a decode step. Then CUDA-event times of prefill (cold, warm, on each
     store), the decode step and its parts, the kernel at B in {8, 64,
     256} beside torch.searchsorted, their bounds, one profiled decode
     step and one profiled sampler call;
 10. the mutable store at full size: build_index(IndexConfig(kind=
     "tiered", mutable=True)) over phase 4's 2^24 keys and values (10,923
     gapped pages of 2,048 slots, 1,536 live, a depth-2 k-ary top), then
     8 rounds of the reference's update benchmark mix: 2,048 new keys,
     1,024 upserts and 1,024 deletes (seals and backpressure folds),
     maintain(), and a lookup of 2^20 queries (half resident, a quarter
     written this round, a quarter misses) under set_sync_debug_mode
     ("error") with the launch counters set to 0 before and read after;
     round 4 crowds one page with 600 keys: a repack and a re-derived
     top. Each round: found and values against a numpy oracle, the slot
     address of every base hit holding its key, n, every page sorted;
     the page and k-ary kernels against their plain versions on the
     store's own operands before and after the repack. Then CUDA-event
     times of the lookup, the delta probe and the base pipeline beside
     phase 4's immutable lookup, host µs a write, fold and repack ms,
     and one profiled lookup;
 11. the store's range scans at full size: phase 7's traffic (scan_range
     count / sum / full over 2^18 ranges, search_range, materialize 64
     over 2^16, scan_groups G = 64 over 2^14 in count / sum (the prefix
     kernel) and full, top_k=8 over 2^12, scan_multi R = 4 union and
     intersect over 2^16) on phase 10's store, after round 8's
     maintain() and again after 1,536 more writes that leave both delta
     tiers with live entries, upserts and tombstones; the last 64 of the
     2^18 ranges have hi = INT32_MAX. Each pass under
     set_sync_debug_mode("error") with the launch counters set to 0
     before and read after (the first pass after the writes rebuilds the
     scan state); every result against a numpy oracle of the live keys,
     slot addresses read back through the store's arrays, the sentinel
     rows recorded beside numpy's counts. Then each entry's CUDA-event
     time beside phase 7's, one profiled scan_range (idle share), the
     page-aggregate and tier-view rebuilds, the first scan after a write,
     the peak device memory, and the page-scan and page-prefix kernels
     against their plain versions on the store's own operands (lw_pad,
     the tombstone mask), with times and bounds;
 12. durability at full size, in a temporary directory removed at the
     end: save() (ms, bytes), a journaled round of phase 10's writes (µs
     a write beside phase 10's, and the journal's append alone), a crash (the store dropped without
     close, the newest segment cut inside its last record),
     restore_index (ms, records replayed), then 2^20 lookups and 2^18
     scan ranges of the restored store under set_sync_debug_mode
     ("error") against the oracle of the surviving writes;
 13. the micro-batch queues and telemetry:
     a. the probe queue (engine/queue.py, admission.py) over phase 12's
        restored store and over phase 4's immutable index: tenants t0-t3
        weighted 1, 1, 2 and 4, capacity 2^16, share cap 0.5, adaptive
        deadline, no timer; 256 numpy submits of 4,096 queries (half
        hits) interleaved across the tenants, with the launch counters
        set to 0 before and read after, and the submits, flushes, result
        slices and the last feedback drain under set_sync_debug_mode
        ("error"); every caller's result equal to a direct lookup of its
        own queries bit for bit, and to numpy. Prints flushes, mean batch,
        each tenant's admitted share, the flush_at trajectory, host µs a
        submit, the CUDA-event ms of the submit that fills 2^16 queries
        and flushes them beside the lookup and the upload alone, the
        launches a flush and the idle share (profiler);
     b. the decode queue: phase 9's serving (same weights, prompts and
        sampler, two rounds of 32 steps) inline, with decode_batching=
        True, then with tenants t0-t3 twice over: tokens equal the inline
        run's bit for bit for the same generator seed, one cdf_search
        launch a step, EngineStats' registry views; then one decode step
        of each kind timed in turns (CUDA events), profiled (launches a
        step, idle share), the tenant step under sync-debug "error",
        beside phase 9's inline numbers;
     c. telemetry: the tenant run's registry scraped from
        start_http_server(0) on 127.0.0.1 and parsed back (queue series
        of both paths), a trace of probe-queue flushes exported as JSON
        (queue.flush, queue.dispatch, tiered.search spans), and phase 4's
        2^20-query lookup timed with metrics off and on, in turns;
 14. specialization (IndexConfig(specialize=True)): the index bound into
     CUDA graphs, beside the args posture on the same data and calls.
     Every kernel that a capture records is held to its plain version on
     the operands and output of the graph's replay; the counted runs are
     under set_sync_debug_mode("error") with the launch counters set to 0
     before and read after (a replay raises them by the kernels it holds).
     a. the frozen index over phase 4's keys: 2^20 lookups and searches
        bit for bit with phase 4's index and numpy, an earlier result
        unchanged by a later replay; ms in turns, launches (the host's
        runtime launch calls and the device's kernels, profiler), idle
        share, capture ms, memory reserved; then the reference's §10.3
        gate cells, tile {128, 256} x leaf_width {2048, 4096}: whether
        the specialized search is no slower than args by more than 10% in
        every cell and faster in one (printed, not checked);
     b. phase 7's entry points at phase 7's shapes on that index, bit for
        bit with phase 4's index, each in turns with it;
     c. phase 10's eight write rounds on a specialize=True store in
        lockstep with an args store: stats and 2^20 lookups equal every
        round (found / values against numpy), the twin re-armed and a
        graph captured at round 4's repack only; ms in turns, launches;
     d. phase 13a's probe queue over that store: a first pass captures
        the padded flush sizes, the counted pass captures none; every
        caller's result against numpy and a direct lookup; the ms of the
        submit that fills and flushes 2^16 queries;
     e. autotune(smoke=True) at 2^24 keys and 2^16 queries into a
        temporary directory, then verify_profile (checked ok), each leg
        measured 32 times (the tuner's default is 8);
 15. one line {"kernels": [...]} with each kernel's launches, times
     (CUDA events, and the profiler's device time beside the library
     call's) and bound, for the page and k-ary kernels the store's
     launches a lookup and their launches on the probe-queue runs, for
     the scan kernels the store's launches, times and bound (phase 11),
     for the CDF kernel its launches on the decode-queue runs, and for
     kernels 1-4 their launches inside phase 14's replays; the last
     line {"ok": true, "device": {...}}.

Without a CUDA card the script exits non-zero at once and prints no
result: the kernels exist only on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import types

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
    heaviest aten ops (inclusive: an op's kernels and its children's), of
    the heaviest kernels with their launch counts, and the summed time of
    the kernels themselves, which against the call's CUDA-event time gives
    the idle share."""
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
    heavy = sorted(kernels, key=lambda e: e.self_device_time_total,
                   reverse=True)[:top]
    return {"kernels_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "kernel_launches": sum(e.count for e in kernels),
            "ops_ms": {e.key: e.device_time_total / 1e3 for e in ops[:top]},
            "kernels_top_ms_count": {e.key[:60]: [
                e.self_device_time_total / 1e3, e.count] for e in heavy}}


def device_ms(fn, reps: int = 20, tries: int = 3) -> float | None:
    """Device time of one call of `fn`: the summed time of the kernels it
    launches, over `reps` calls under torch.profiler, per call. Unlike a
    per-call event time it leaves out the gaps in which the device waits
    for the host, which set the event time of a call of a few
    microseconds of device work. A profile that recorded no device event
    is taken again, up to `tries` times; then the time is None (not
    measured), never 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    return None


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


DIRECT_CASES = ((2048, 1), (2048, 33), (2048, 1024), (5120, 33))  # lw_pad, TQ
STEP_PAGES = [0, 0, 0, 1, 2, 2, 3, 5, 5, 5, 5, 6]    # sorted, with runs


def direct_case(rng, dtype, lw_pad: int, tq: int, shuffled: bool, dev):
    """Kernel operands built directly, at any TQ: 7 sorted sentinel-padded
    pages with duplicate runs (float32: -0.0 and +0.0 tie), the steps of
    STEP_PAGES (in page order, or shuffled) then 4 surplus steps, bounds
    drawn from each step's keys, their neighbours and the domain's
    specials (float32: +-0.0, +-inf, NaN), most lanes with lo <= hi, and
    int32 values near +-2^31 (sums wrap): (lo_b, hi_b, step_pages,
    steps_used, kpages, vpages)."""
    n_pages, fill = 7, lw_pad * 3 // 4
    keys = np.sort(rng.integers(-40, 40, (n_pages, fill)), axis=1)
    if dtype == np.int32:
        pages = np.full((n_pages, lw_pad), I32.max, np.int32)
        pages[:, :fill] = keys
        special = [I32.min, I32.max - 1, I32.max]
        vals = rng.integers(2**31 - 1000, 2**31, (n_pages, lw_pad))
        vals = np.where(rng.random(vals.shape) < 0.5, vals, -vals)
    else:
        pages = np.full((n_pages, lw_pad), np.inf, np.float32)
        pages[:, :fill] = keys * 0.5
        zeros = pages == 0
        pages[zeros] = np.where(rng.random(zeros.sum()) < 0.5, -0.0, 0.0)
        special = [0.0, -0.0, np.inf, -np.inf, np.nan]
        vals = rng.normal(size=(n_pages, lw_pad))
    vals = vals.astype(dtype)
    vals.reshape(-1)[::11] = MASK_VALUE
    used = len(STEP_PAGES)
    order = rng.permutation(used) if shuffled else np.arange(used)
    step_pages = np.array([STEP_PAGES[i] for i in order] + [0] * 4, np.int32)
    lo = np.empty((step_pages.size, tq), dtype)
    hi = np.empty_like(lo)
    for g, page in enumerate(step_pages):
        row = pages[page, :fill]
        pool = np.concatenate([row, row + 1, row - 1, special]).astype(dtype)
        a, b = rng.choice(pool, tq), rng.choice(pool, tq)
        flip = rng.random(tq) < 0.7
        lo[g] = np.where(flip, np.minimum(a, b), a)
        hi[g] = np.where(flip, np.maximum(a, b), b)
    return [torch.from_numpy(x).to(dev) for x in (
        lo, hi, step_pages, np.array([used], np.int32), pages, vals)]


# in this order at sorted random slots of a row: an infinity or a NaN lies
# between every +1e30 and -1e30, so no range sums a cancelling pair (whose
# float sum would depend on the order of the adds)
SPECIAL_VALUES = np.array([1e30, np.nan, -0.0, 0.0, np.inf, 1e30, -np.inf,
                           -1e30, -0.0, np.nan, -1e30, 0.0], np.float32)


def special_case(rng, dev, lw_pad: int = 2048, tq: int = 128):
    """Sorted float32 pages of distinct keys whose values hold NaN, +-inf,
    +-1e30, -0.0 and +0.0 (page 0 only signed zeros), and bound pairs over
    random slot runs, so special values fall inside and outside the
    lanes' ranges; inert, whole-page and NaN bounds too: (lo_b, hi_b,
    step_pages, kpages, vpages)."""
    P, G, live = 6, 12, lw_pad * 7 // 8
    keys = np.arange(P * live, dtype=np.float32).reshape(P, live) * 0.5
    kpages = np.full((P, lw_pad), np.inf, np.float32)
    kpages[:, :live] = keys
    vals = rng.normal(size=(P, lw_pad)).astype(np.float32)
    for p in range(1, P):
        vals[p, np.sort(rng.choice(live, SPECIAL_VALUES.size,
                                   replace=False))] = SPECIAL_VALUES
    vals[0] = np.where(rng.random(lw_pad) < 0.5, -0.0, 0.0)
    vals[:, 5::11] = MASK_VALUE
    sp = np.sort(rng.integers(0, P, G)).astype(np.int32)
    a = rng.integers(0, live, (G, tq))
    b = np.minimum(a + rng.integers(0, lw_pad // 4, (G, tq)), live - 1)
    lo, hi = keys[sp[:, None], a], keys[sp[:, None], b]
    lo[0, :3], hi[0, :3] = np.inf, -np.inf           # inert
    lo[1, :3], hi[1, :3] = -np.inf, np.finfo(np.float32).max
    lo[2, :2], hi[2, 2:4] = np.nan, np.nan
    return [torch.from_numpy(x).to(dev) for x in (lo, hi, sp, kpages, vals)]


def phase_page(dev, rng) -> int:
    from repro_torch.engine import tiered
    from repro_torch.kernels import page_search as pk
    worst, surplus = 0, False
    for dtype in (np.int32, np.float32):
        for leaf_width in (100, 2000, 5000):        # lw_pad 128, 2048, 5120
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
    # TQ 1, 33, 1024 and shuffled step pages; NaN, +-inf and +-0.0 queries
    cases = [(f"{dtype.__name__} lw_pad {lw} TQ {tq} shuffled {sh}",
              direct_case(rng, dtype, lw, tq, sh, dev))
             for dtype in (np.int32, np.float32)
             for lw, tq in DIRECT_CASES for sh in (False, True)]
    lo, _, sp, kp, _ = special_case(rng, dev)
    cases.append(("float32 special", [lo, None, sp, None, kp]))
    for what, (q, _, sp, used_t, kp, *_) in cases:
        lw_pad = kp.shape[1]
        for used, stride in ((used_t, lw_pad), (None, lw_pad - 37)):
            u = sp.shape[0] if used is None else int(used)
            got = pk.page_search_bucketed(q, sp, kp, stride=stride,
                                          steps_used=used)
            want = pk.page_search_plain(q, sp, kp, stride=stride)
            torch.cuda.synchronize()
            check(torch.equal(got[:u], want[:u]),
                  f"page kernel != plain ({what}, stride {stride})")
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
    # depth 3: level 2 (16,384 rows) is searched in device memory. Keys
    # and queries come from a generator of their own, so the later phases'
    # data stay as they were before these cases.
    own = np.random.default_rng(3)
    deep = np.sort(own.integers(I32.min + 1, I32.max - 1, 20000)
                   ).astype(np.int32)
    deep[1::3] = deep[::3][:deep[1::3].size]      # duplicate runs
    return [("int32 depth 1", ints[:100], rng), ("int32 depth 2", ints, rng),
            ("int32 extremes", np.concatenate([lo, hi]).astype(np.int32),
             rng),
            ("float32 depth 1", floats[::80], rng),
            ("float32 depth 2", floats, rng),
            ("int32 depth 3", deep, own),
            ("float32 depth 3", deep.astype(np.float32) * np.float32(1e-3),
             own)]


def phase_kary(dev, rng) -> int:
    from repro_torch.core import kary as kary_core
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import ops
    worst = 0
    for what, keys, qrng in kary_cases(rng):
        idx = kary_core.build(keys, node_width=127, device=dev)
        flat, offsets = kk.flatten_levels(ops.kary_levels(idx, 128))
        if keys.dtype == np.int32:
            q = np.concatenate([
                qrng.integers(I32.min, I32.max, 50000, dtype=np.int64),
                keys, np.maximum(keys.astype(np.int64) - 1, I32.min),
                [I32.min, I32.max - 1, I32.max - 2, I32.max]])
        else:
            q = np.concatenate([qrng.normal(size=50000) * 1e20, keys,
                                np.nextafter(keys, np.float32(-np.inf)),
                                [0.0, -0.0, -np.inf, np.inf, 1e-45,
                                 -1e-45]])
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
        "device_ms": device_ms(lambda: kk.kary_search_levels(*k_args,
                                                              **k_kw)),
        "library_device_ms": device_ms(
            lambda: torch.searchsorted(impl.seps, q_dev)),
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
        "device_ms": device_ms(lambda: pk.page_search_bucketed(
            *p_args, stride=impl.leaf_width, steps_used=used_t)),
        "library_device_ms": device_ms(
            lambda: torch.searchsorted(idx.keys_sorted, q_dev)),
    }
    check(kary_row["max_abs_err"] == 0 and page_row["max_abs_err"] == 0,
          "a kernel disagrees with its plain version at the main path's "
          "shapes")
    shape = {"keys": N_KEYS, "queries": N_QUERIES, "leaf_width":
             impl.leaf_width, "num_pages": P, "top": impl.top_kind,
             "grid": g_cap, "steps_used": used, "pages_touched": touched,
             "build_s": build_s}
    return [page_row, kary_row], dict(shape, **stages), \
        (idx, keys_sorted, values_sorted)


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


# --------------------------------------------------------------- phase 6
MASK_VALUE = -7          # a value sentinel the masked kernel modes drop


def bucketed_lanes(index, bounds: list):
    """[Q] bound arrays scattered into [g_cap, tile] kernel lanes, bucketed
    by the page of the first array as the device plan buckets them:
    (lanes, step_pages, steps_used, plan)."""
    from repro_torch.engine import schedule
    q = bounds[0]
    g_cap = schedule.ladder_grid(q.shape[0], index.tile, index.num_pages)
    plan = schedule.edge_scan_plan(index.page_of(q), index.tile, g_cap,
                                   index.num_pages)
    lanes = [torch.zeros(g_cap * index.tile, dtype=b.dtype, device=b.device)
             .scatter_(0, plan.dest.long(), b).view(g_cap, index.tile)
             for b in bounds]
    return lanes, plan.step_pages, plan.steps_used, plan


def compare_outputs(got, want, used: int, sum_at: int, what: str,
                    worst: dict) -> None:
    """Counts, int32 sums, min and max bit for bit, float min and max too
    (the sign bit of every non-NaN lane: -0.0 != +0.0); float sums to rtol
    1e-4 (the kernel adds in double in its own order, the plain version in
    float32 in torch's). A float NaN passes only where both sides have it.
    Folds the largest errors into ``worst``."""
    check(len(got) == len(want), f"{what}: {len(got)} outputs, want "
          f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g[:used], w[:used]
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{what}: output {i} is {g.dtype} {tuple(g.shape)}")
        if g.numel() == 0:
            continue
        if not g.is_floating_point():
            check(torch.equal(g, w), f"{what}: output {i} != plain")
            worst["max_abs_err"] = max(worst["max_abs_err"],
                                       max_abs_err(g, w))
            continue
        nan = torch.isnan(g)
        check(torch.equal(nan, torch.isnan(w)),
              f"{what}: output {i} has NaN at other lanes than plain")
        g, w = g[~nan], w[~nan]
        if i == sum_at:
            check(torch.allclose(g, w, rtol=1e-4, atol=1e-4),
                  f"{what}: float sums beyond rtol 1e-4")
            fin = torch.isfinite(w)
            if bool(fin.any()):
                rel = (g[fin] - w[fin]).abs() / w[fin].abs().clamp_min(1.0)
                worst["float_sum_rel_err"] = max(worst["float_sum_rel_err"],
                                                 float(rel.max()))
        else:
            check(torch.equal(g, w) and torch.equal(torch.signbit(g),
                                                    torch.signbit(w)),
                  f"{what}: output {i} != plain bit for bit")


def phase_scan_kernels(dev, rng) -> dict:
    from repro_torch.engine import scan as escan
    from repro_torch.engine import tiered
    from repro_torch.kernels import page_scan as ps
    worst = {"max_abs_err": 0, "float_sum_rel_err": 0.0, "cases": 0}
    surplus = wrapped = False
    for dtype in (np.int32, np.float32):
        lo_min, hi_cap, inert_lo, inert_hi = escan._domain_consts(dtype)
        for leaf_width in (100, 2000, 5000):        # lw_pad 128, 2048, 5120
            n, q_n = leaf_width * 300 - 17, 20000
            if dtype == np.int32:
                keys = rng.integers(I32.min + 1, I32.max - 1, n)
                lo = rng.integers(I32.min + 1, I32.max - 1, q_n)
                hi = np.clip(lo + rng.integers(-2**20, 2**26, q_n), I32.min,
                             I32.max - 1)
            else:
                keys = rng.normal(size=n) * 1e4
                lo = rng.normal(size=q_n) * 1e4
                hi = lo + rng.normal(size=q_n) * 300
            keys, lo, hi = (a.astype(dtype) for a in (keys, lo, hi))
            idx = tiered.build(keys, leaf_width=leaf_width, device=dev)
            lo[: q_n * 3 // 4] = np.sort(keys)[leaf_width * 7 + 3]  # hot page
            lo[-8:-4], hi[-8:-4] = inert_lo, inert_hi      # inert pairs
            lo[-4:], hi[-4:] = lo_min, hi_cap              # whole domain
            if dtype == np.int32:                          # sums that wrap
                vals = rng.integers(I32.min, I32.max, idx.pages.shape,
                                    dtype=np.int64).astype(dtype)
                live = idx.pages.cpu().numpy() < I32.max
                wrapped |= bool((np.abs(np.where(live, vals, 0).astype(
                    np.int64).sum(1)) > I32.max).any())
            else:
                vals = rng.normal(size=idx.pages.shape).astype(dtype)
            vals.reshape(-1)[::13] = MASK_VALUE
            vp = torch.from_numpy(vals).to(dev)
            lanes, sp, used_t, _ = bucketed_lanes(
                idx, [torch.from_numpy(a).to(dev) for a in (lo, hi)])
            used = int(used_t)
            surplus |= used < sp.shape[0]
            what = f"{dtype.__name__} lw_pad {idx.lw_pad}"
            for mode in ps.MODES:
                for mask in (None,) if mode == "count" else (None, MASK_VALUE):
                    vpm = None if mode == "count" else vp
                    got = ps.page_scan_bucketed(*lanes, sp, idx.pages, vpm,
                                                mode=mode, mask_value=mask,
                                                steps_used=used_t)
                    want = ps.page_scan_plain(*lanes, sp, idx.pages, vpm,
                                              mode=mode, mask_value=mask)
                    torch.cuda.synchronize()
                    compare_outputs(got, want, used, 2, f"page_scan {mode} "
                                    f"mask {mask} {what}", worst)
                    worst["cases"] += 1
            every = ps.page_scan_bucketed(*lanes, sp, idx.pages, vp,
                                          mode="full")
            compare_outputs(every, ps.page_scan_plain(*lanes, sp, idx.pages,
                                                      vp, mode="full"),
                            sp.shape[0], 2, f"page_scan every step {what}",
                            worst)
            for vpm, mask in ((None, None), (vp, None), (vp, MASK_VALUE)):
                got = ps.page_prefix_bucketed(lanes[0], sp, idx.pages, vpm,
                                              mask_value=mask,
                                              steps_used=used_t)
                want = ps.page_prefix_plain(lanes[0], sp, idx.pages, vpm,
                                            mask_value=mask)
                torch.cuda.synchronize()
                if vpm is None:
                    got, want = (got,), (want,)
                compare_outputs(got, want, used, 1, f"page_prefix values "
                                f"{vpm is not None} mask {mask} {what}",
                                worst)
                worst["cases"] += 1
    # TQ 1, 33, 1024 and shuffled step pages
    for dtype in (np.int32, np.float32):
        for lw_pad, tq in DIRECT_CASES:
            for shuffled in (False, True):
                lo_b, hi_b, sp_d, used_d, kp, vp_d = direct_case(
                    rng, dtype, lw_pad, tq, shuffled, dev)
                u = int(used_d)
                what = (f"{dtype.__name__} lw_pad {lw_pad} TQ {tq} "
                        f"shuffled {shuffled}")
                for mode in ps.MODES:
                    for mask in ((None,) if mode == "count"
                                 else (None, MASK_VALUE)):
                        vpm = None if mode == "count" else vp_d
                        got = ps.page_scan_bucketed(
                            lo_b, hi_b, sp_d, kp, vpm, mode=mode,
                            mask_value=mask, steps_used=used_d)
                        want = ps.page_scan_plain(lo_b, hi_b, sp_d, kp, vpm,
                                                  mode=mode, mask_value=mask)
                        torch.cuda.synchronize()
                        compare_outputs(got, want, u, 2, f"page_scan {mode} "
                                        f"mask {mask} {what}", worst)
                        worst["cases"] += 1
                got = ps.page_prefix_bucketed(lo_b, sp_d, kp, vp_d,
                                              steps_used=used_d)
                want = ps.page_prefix_plain(lo_b, sp_d, kp, vp_d)
                torch.cuda.synchronize()
                compare_outputs(got, want, u, 1, f"page_prefix {what}", worst)
                worst["cases"] += 1
    # NaN, +-inf, +-1e30 and signed zeros among the values
    lo_b, hi_b, sp_s, kp, vp_s = special_case(rng, dev)
    nan_lanes = 0
    for mode in ("sum", "full"):
        for mask in (None, MASK_VALUE):
            got = ps.page_scan_bucketed(lo_b, hi_b, sp_s, kp, vp_s, mode=mode,
                                        mask_value=mask)
            want = ps.page_scan_plain(lo_b, hi_b, sp_s, kp, vp_s, mode=mode,
                                      mask_value=mask)
            torch.cuda.synchronize()
            compare_outputs(got, want, sp_s.shape[0], 2, f"page_scan {mode} "
                            f"mask {mask} special values", worst)
            worst["cases"] += 1
            if mode == "full":
                nan_lanes = int(torch.isnan(got[3]).sum())
                # page 0 holds only signed zeros: -0.0 the min, +0.0 the max
                zeros = (got[3] == 0) & (got[4] == 0)
                neg_min = zeros & torch.signbit(got[3])
                pos_max = zeros & ~torch.signbit(got[4])
                worst[f"special_min_-0_max_+0_lanes_mask_{mask}"] = int(
                    (neg_min & pos_max).sum())
    check(nan_lanes > 0, "no lane had a NaN value in range")
    check(worst[f"special_min_-0_max_+0_lanes_mask_{MASK_VALUE}"] > 0,
          "no lane took in both signed zeros")
    worst["special_nan_lanes"] = nan_lanes
    # Q = 0: the plan's one empty step (steps_used 0), and a zero-step grid
    z = torch.zeros(0, dtype=idx.pages.dtype, device=dev)
    lanes, sp, used_t, _ = bucketed_lanes(idx, [z, z])
    check(int(used_t) == 0 and sp.shape[0] == 1, "Q = 0 plan")
    for mode in ps.MODES:
        ps.page_scan_bucketed(*lanes, sp, idx.pages, vp, mode=mode,
                              steps_used=used_t)
    ps.page_prefix_bucketed(lanes[0], sp, idx.pages, vp, steps_used=used_t)
    none = ps.page_scan_bucketed(lanes[0][:0], lanes[1][:0], sp[:0],
                                 idx.pages, vp, mode="full")
    torch.cuda.synchronize()
    check(all(t.shape == (0, idx.tile) for t in none), "zero-step grid")
    check(surplus, "no case had steps_used below the grid")
    check(wrapped, "no case had an int32 page sum that wraps")
    return worst


# --------------------------------------------------------------- phase 7
N_RANGES = 1 << 18
N_MAT, MAT_K = 1 << 16, 64
N_GROUP_RANGES, N_GROUPS = 1 << 14, 64
N_TOPK_RANGES, TOP_K = 1 << 12, 8
N_MULTI, MULTI_R = 1 << 16, 4
N_SUBSET = 4096
MAX_WIDTH = 1 << 17          # keys a scan range matches, at most
MULTI_HALF_WIDTH = 1 << 15


def wrap32(x: np.ndarray) -> np.ndarray:
    """int64 -> int32 with two's-complement wrap (numpy's int32 sums)."""
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32) \
        .view(np.int32)


def log_uniform(rng, hi: int, size) -> np.ndarray:
    """Integers log-uniform over [1, hi]."""
    return np.minimum(np.exp(rng.uniform(0, np.log(hi + 1), size))
                      .astype(np.int64), hi)


def scan_ranges(rng, ks: np.ndarray, q_n: int):
    """lo drawn from the keys, widths log-uniform from 1 to 2^17 matching
    keys (spans of one to about 64 pages), every 16th range inverted, and
    four whole-domain or empty ranges first."""
    n = ks.size
    w = log_uniform(rng, MAX_WIDTH, q_n)
    r = rng.integers(0, n - w + 1)
    lo, hi = ks[r], ks[r + w - 1]
    inv = np.arange(0, q_n, 16)
    lo[inv], hi[inv] = hi[inv], lo[inv] - 1
    lo[:4] = [I32.min, I32.min, ks[-1] + 1, ks[0]]
    hi[:4] = [I32.max - 1, ks[0] - 1, I32.max - 1, ks[-1]]
    return lo, hi


def range_oracle(ks, cs, lo, hi):
    """(r_lo, r_hi_excl, count, wrapped int32 sum) per range."""
    r_lo = np.searchsorted(ks, lo, "left")
    r_hi = np.where(lo > hi, r_lo, np.searchsorted(ks, hi, "right"))
    return r_lo, r_hi, r_hi - r_lo, wrap32(cs[r_hi] - cs[r_lo])


def seg_minmax(vs, a, b):
    """min / max of vs[a[i]:b[i]] per i (identities when empty)."""
    mn = np.full(len(a), I32.max, np.int32)
    mx = np.full(len(a), I32.min, np.int32)
    for i, (x, y) in enumerate(zip(a, b)):
        if y > x:
            mn[i], mx[i] = vs[x:y].min(), vs[x:y].max()
    return mn, mx


def group_oracle(ks, cs, lo, hi, G):
    """Bucket edges by their definition (e_g = min(lo + g * width, hi + 1),
    width = (hi - lo) // G + 1, int64), ranks, counts, wrapped sums."""
    l64 = lo.astype(np.int64)[:, None]
    s = hi.astype(np.int64)[:, None] - l64
    g = np.arange(G + 1)[None, :]
    e = np.minimum(l64 + g * (s // G + 1), l64 + s + 1)
    e = np.where((lo > hi)[:, None], l64, e).astype(np.int32)
    r_edge = np.searchsorted(ks, e, "left")
    return (e, r_edge, np.diff(r_edge, axis=1),
            wrap32(np.diff(cs[r_edge], axis=1)))


def bucket_minmax(vs, r_edge):
    """Per-bucket min / max over consecutive rank intervals of each row."""
    Q, G = r_edge.shape[0], r_edge.shape[1] - 1
    mn = np.full((Q, G), I32.max, np.int32)
    mx = np.full((Q, G), I32.min, np.int32)
    for q in range(Q):
        a, b = r_edge[q, :-1], r_edge[q, 1:]
        ne = b > a
        if ne.any():
            seg = vs[a[0]:b[-1]]
            st = a[ne] - a[0]
            mn[q, ne] = np.minimum.reduceat(seg, st)
            mx[q, ne] = np.maximum.reduceat(seg, st)
    return mn, mx


def topk_oracle(vs, r_edge, K, C):
    """Per bucket the top-K of its first C values (descending, ties to the
    lower rank), their ranks, and the overflow flag."""
    s = r_edge[:, :-1].reshape(-1)
    cnt = np.diff(r_edge, axis=1).reshape(-1)
    ranks = s[:, None] + np.arange(C)[None, :]
    valid = np.arange(C)[None, :] < cnt[:, None]
    cand = np.where(valid, vs[np.minimum(ranks, vs.size - 1)].astype(
        np.int64), -2**40)
    order = np.argsort(-cand, axis=1, kind="stable")[:, :K]
    kvalid = np.arange(K)[None, :] < np.minimum(cnt, C)[:, None]
    topv = np.where(kvalid, np.take_along_axis(cand, order, 1), 0)
    topr = np.where(kvalid, np.take_along_axis(ranks, order, 1), -1)
    return topv.astype(np.int32), topr.astype(np.int32), cnt > C


def multi_ranges(rng, ks, q_n, R):
    """R ranges per query around one shared key (so intersections are not
    empty), half-widths log-uniform up to 2^15 keys, every 16th member
    inverted."""
    n = ks.size
    c = rng.integers(0, n, q_n)[:, None]
    a = np.clip(c - log_uniform(rng, MULTI_HALF_WIDTH, (q_n, R)) + 1, 0,
                n - 1)
    b = np.clip(c + log_uniform(rng, MULTI_HALF_WIDTH, (q_n, R)) - 1, 0,
                n - 1)
    lo, hi = ks[a], ks[b]
    flo, fhi = lo.reshape(-1), hi.reshape(-1)
    flo[::16], fhi[::16] = fhi[::16], flo[::16] - 1
    return np.stack([lo, hi], axis=-1)


def multi_oracle(ks, cs, ranges, op):
    """(count, wrapped sum, hull r_lo, hull r_hi, pieces) per query in rank
    space; pieces are the disjoint [start, end) rank runs of the match."""
    lo, hi = ranges[..., 0], ranges[..., 1]
    a = np.searchsorted(ks, lo, "left")
    b = np.where(lo > hi, a, np.searchsorted(ks, hi, "right"))
    if op == "union":
        order = np.argsort(a, axis=1, kind="stable")
        a, b = np.take_along_axis(a, order, 1), np.take_along_axis(b, order, 1)
        prev = np.concatenate([np.full((a.shape[0], 1), -1),
                               np.maximum.accumulate(b, axis=1)[:, :-1]], 1)
        start = np.maximum(a, prev)
        live = b > start
        ne = b > a
        r_lo = np.where(ne, a, I32.max).min(1)
        r_hi = np.where(ne, b, -1).max(1)
    else:
        ok = ~(lo > hi).any(1) & (lo.max(1) <= hi.min(1))
        start = np.searchsorted(ks, lo.max(1), "left")[:, None]
        b = np.where(ok, np.searchsorted(ks, hi.min(1), "right"),
                     start[:, 0])[:, None]
        live = b > start
        r_lo, r_hi = start[:, 0], b[:, 0]
    cnt = np.where(live, b - start, 0).sum(1)
    vsum = wrap32(np.where(live, cs[b] - cs[np.minimum(start, b)], 0).sum(1))
    r_lo, r_hi = np.where(cnt > 0, r_lo, 0), np.where(cnt > 0, r_hi, 0)
    return cnt, vsum, r_lo, r_hi, (start, b, live)


def pieces_minmax(vs, pieces, rows):
    start, end, live = pieces
    mn = np.full(len(rows), I32.max, np.int32)
    mx = np.full(len(rows), I32.min, np.int32)
    for i, q in enumerate(rows):
        segs = [vs[x:y] for x, y, ok in zip(start[q], end[q], live[q]) if ok]
        if segs:
            mn[i] = min(sg.min() for sg in segs)
            mx[i] = max(sg.max() for sg in segs)
    return mn, mx


def same(got, want, what: str) -> None:
    got = got.cpu().numpy()
    check(got.shape == np.shape(want) and np.array_equal(got, want),
          f"scan path: {what} differs from the numpy oracle")


def capture_call(caller, name: str, fn):
    """Run ``fn`` with the kernel module that ``caller`` knows as
    ``_pscan`` swapped for a copy whose ``name`` also keeps its last
    call's arguments: the kernel's operands exactly as the path built
    them. The kernel module itself is left alone (its wrappers count
    launches on their own function objects)."""
    kernels = caller._pscan
    orig = getattr(kernels, name)
    seen = {}

    def record(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        return orig(*args, **kw)

    caller._pscan = types.SimpleNamespace(**{**vars(kernels), name: record})
    try:
        fn()
    finally:
        caller._pscan = kernels
    torch.cuda.synchronize()
    return seen["args"], seen["kw"]


def kernel_row(name, mode, launches, args, kw, plain, n_items, real,
               sum_at, library):
    """One ``kernels`` row: the kernel on the path's own operands against
    its plain version, times, and the bound from this run's inputs."""
    from repro_torch.kernels import page_scan as ps
    kernel = getattr(ps, name)
    used_t = kw["steps_used"]
    used = int(used_t)
    pkw = {k: v for k, v in kw.items() if k != "steps_used"}
    got = kernel(*args, **kw)
    want = plain(*args, **pkw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    worst = {"max_abs_err": 0, "float_sum_rel_err": 0.0}
    compare_outputs(got, want, used, sum_at, f"{name}[{mode}] at the path's "
                    "shapes", worst)
    lanes = got[0].shape[1]
    kpages = args[3 if name == "page_scan_bucketed" else 2]
    vpages = args[4 if name == "page_scan_bucketed" else 3] \
        if len(args) > (4 if name == "page_scan_bucketed" else 3) else None
    step_pages = args[2 if name == "page_scan_bucketed" else 1]
    touched = int(torch.unique(step_pages[:used]).numel())
    lw_pad = kpages.shape[1]
    real = real.view(-1, lanes)[:used]
    n_in = 2 if name == "page_scan_bucketed" else 1
    value_pages = vpages is not None and mode != "count"
    bytes_moved = (n_items * 4 * (n_in + len(got)) + used * 4
                   + touched * lw_pad * 4 * (2 if value_pages else 1))
    compares = n_items * n_in * sorted_count_compares(lw_pad)
    if value_pages:
        # one add per in-range slot (sum), plus a min and a max (full)
        if name == "page_scan_bucketed":
            slots = (got[1][:used] - got[0][:used]).clamp_min(0)
        else:
            slots = got[0][:used]
        per_slot = 3 if mode == "full" else 1
        compares += per_slot * int(slots[real].sum())
    b = bound(bytes_moved, compares)
    return {
        "name": f"{name}[{mode}]", "route": "cuda",
        "source": "src/repro_torch/csrc/page_scan.cu",
        "replaces": "src/repro/kernels/page_scan.py:"
                    + ("155" if name == "page_scan_bucketed" else "230"),
        "launches": launches,
        "max_abs_err": worst["max_abs_err"],
        "float_sum_rel_err": worst["float_sum_rel_err"],
        "ms": cuda_ms(lambda: kernel(*args, **kw)),
        "plain_ms": cuda_ms(lambda: plain(*args, **pkw), reps=3, warmup=1),
        "bound_ms": b[0], "bound_by": b[1],
        "library_ms": None if library is None else cuda_ms(library),
        "device_ms": device_ms(lambda: kernel(*args, **kw)),
        "library_device_ms": None if library is None
        else device_ms(library),
        "steps_used": used, "grid": int(step_pages.shape[0]),
        "pages_touched": touched, "items": n_items,
        "bytes_bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
        "ops_bound_ms": compares / COMPARES_PER_S * 1e3,
    }


def scan_calls(index, lo_d, hi_d, r_d) -> dict:
    """Phase 7's entry points at phase 7's shapes, on the immutable index
    (phase 7) or the mutable store (phase 11)."""
    glo, ghi = lo_d[:N_GROUP_RANGES], hi_d[:N_GROUP_RANGES]
    tlo, thi = lo_d[:N_TOPK_RANGES], hi_d[:N_TOPK_RANGES]
    G = N_GROUPS
    return {
        "scan_range": lambda: index.scan_range(lo_d, hi_d),
        "search_range": lambda: index.search_range(lo_d, hi_d),
        "scan_range_sum": lambda: index.scan_range(lo_d, hi_d,
                                                   aggs=("count", "sum")),
        "scan_range_materialize": lambda: index.scan_range(
            lo_d[:N_MAT], hi_d[:N_MAT], materialize=MAT_K),
        "scan_groups_count": lambda: index.scan_groups(glo, ghi, G,
                                                       aggs=("count",)),
        "scan_groups_sum": lambda: index.scan_groups(glo, ghi, G,
                                                     aggs=("count", "sum")),
        "scan_groups_full": lambda: index.scan_groups(glo, ghi, G),
        "scan_groups_top_k": lambda: index.scan_groups(tlo, thi, G,
                                                       top_k=TOP_K),
        "scan_multi_union": lambda: index.scan_multi(r_d, op="union"),
        "scan_multi_intersect": lambda: index.scan_multi(r_d,
                                                         op="intersect"),
    }


def scan_path(dev, rng, idx, ks, vs):
    from repro_torch.engine import groupby, scan, schedule
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import page_scan as ps
    from repro_torch.kernels import page_search as pk
    impl = idx.impl
    n, tile, P = ks.size, impl.tile, impl.num_pages
    cs = np.zeros(n + 1, np.int64)
    cs[1:] = np.cumsum(vs.astype(np.int64))
    lo, hi = scan_ranges(rng, ks, N_RANGES)
    ranges = multi_ranges(rng, ks, N_MULTI, MULTI_R)
    lo_d, hi_d = (torch.from_numpy(a).to(dev) for a in (lo, hi))
    glo, ghi = lo_d[:N_GROUP_RANGES], hi_d[:N_GROUP_RANGES]
    r_d = torch.from_numpy(ranges).to(dev)
    G = N_GROUPS
    calls = scan_calls(idx, lo_d, hi_d, r_d)
    t0 = time.perf_counter()
    for fn in calls.values():               # builds the scanner, warms up
        fn()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    counters = (pk.page_search_bucketed, kk.kary_search_levels,
                ps.page_scan_bucketed, ps.page_prefix_bucketed)
    for c in counters:
        c.launches = 0
        if hasattr(c, "mode_launches"):
            c.mode_launches = dict.fromkeys(c.mode_launches, 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = {k: fn() for k, fn in calls.items()}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = {c.__name__: c.launches for c in counters}
    mode_launches = {
        "page_scan_bucketed": dict(ps.page_scan_bucketed.mode_launches),
        "page_prefix_bucketed": dict(ps.page_prefix_bucketed.mode_launches)}
    torch.cuda.synchronize()
    check(all(v > 0 for m in mode_launches.values() for v in m.values()),
          f"a scan kernel mode did not launch on the path: {mode_launches}")
    check(launches["kary_search_levels"] > 0, "the span descent did not go "
          "through the k-ary kernel")

    # ---- every query: counts, ranks, wrapped int32 sums
    r_lo, r_hi, cnt, vsum = range_oracle(ks, cs, lo, hi)
    for key in ("scan_range", "scan_range_sum"):
        r = res[key]
        same(r.count, cnt, f"{key} count")
        same(r.r_lo, r_lo, f"{key} r_lo")
        same(r.r_hi_excl, r_hi, f"{key} r_hi_excl")
        same(r.vsum, vsum, f"{key} vsum")
    check(res["scan_range_sum"].vmin is None, "sum depth returned a min")
    for got, want, f in zip(res["search_range"], (r_lo, r_hi, cnt),
                            ("r_lo", "r_hi_excl", "count")):
        same(got, want, f"search_range {f}")
    sub = np.arange(N_SUBSET)
    mn, mx = seg_minmax(vs, r_lo[sub], r_hi[sub])
    same(res["scan_range"].vmin[:N_SUBSET], mn, "scan_range vmin")
    same(res["scan_range"].vmax[:N_SUBSET], mx, "scan_range vmax")

    m = res["scan_range_materialize"]
    mr = r_lo[:N_MAT, None] + np.arange(MAT_K)[None, :]
    mvalid = np.arange(MAT_K)[None, :] < cnt[:N_MAT, None]
    same(m.ranks, np.where(mvalid, mr, -1), "materialized ranks")
    same(m.values, np.where(mvalid, vs[np.minimum(mr, n - 1)], 0),
         "materialized values")
    same(m.overflow, cnt[:N_MAT] > MAT_K, "materialize overflow")
    same(m.count, cnt[:N_MAT], "materialize count")

    e, r_edge, gcnt, gsum = group_oracle(ks, cs, lo[:N_GROUP_RANGES],
                                         hi[:N_GROUP_RANGES], G)
    for key in ("scan_groups_count", "scan_groups_sum", "scan_groups_full"):
        g = res[key]
        same(g.edges, e, f"{key} edges")
        same(g.r_edge, r_edge, f"{key} r_edge")
        same(g.count, gcnt, f"{key} count")
        if key != "scan_groups_count":
            same(g.vsum, gsum, f"{key} vsum")
    check(res["scan_groups_count"].vsum is None, "count depth gave sums")
    gmn, gmx = bucket_minmax(vs, r_edge[:N_SUBSET])
    same(res["scan_groups_full"].vmin[:N_SUBSET], gmn, "scan_groups vmin")
    same(res["scan_groups_full"].vmax[:N_SUBSET], gmx, "scan_groups vmax")
    t = res["scan_groups_top_k"]
    C = max(2 * TOP_K, 32)
    topv, topr, over = topk_oracle(vs, r_edge[:N_TOPK_RANGES], TOP_K, C)
    same(t.topk_values.reshape(-1, TOP_K), topv, "top-K values")
    same(t.topk_ranks.reshape(-1, TOP_K), topr, "top-K ranks")
    same(t.overflow.reshape(-1), over, "top-K overflow")
    same(t.count, gcnt[:N_TOPK_RANGES], "top-K bucket counts")

    multi = {}
    for op in ("union", "intersect"):
        mc, msum, mlo, mhi, pieces = multi_oracle(ks, cs, ranges, op)
        r = res[f"scan_multi_{op}"]
        same(r.count, mc, f"scan_multi {op} count")
        same(r.vsum, msum, f"scan_multi {op} vsum")
        same(r.r_lo, mlo, f"scan_multi {op} r_lo")
        same(r.r_hi_excl, mhi, f"scan_multi {op} r_hi_excl")
        pmn, pmx = pieces_minmax(vs, pieces, sub)
        same(r.vmin[:N_SUBSET], pmn, f"scan_multi {op} vmin")
        same(r.vmax[:N_SUBSET], pmx, f"scan_multi {op} vmax")
        multi[op] = {"empty": int((mc == 0).sum()), "matches": int(mc.sum())}

    # ---- times: each entry point, its stages, each kernel and mode
    sc = scan.scanner_for(impl, idx.values_sorted)
    times = {f"{k}_ms": cuda_ms(fn, reps=7, warmup=1)
             for k, fn in calls.items()}
    plo, phi = sc.span_of(lo_d, hi_d)
    g_cap = schedule.ladder_grid(2 * N_RANGES, tile, P)
    _, plan = schedule.span_scan_plan(plo, phi, tile, g_cap, P)
    aux = sc.aux

    def interior():
        a, b = plo + 1, phi
        has = b > a
        al, bl = a.long(), b.long()
        return (torch.where(has, aux.cum_cnt[bl] - aux.cum_cnt[al], 0),
                torch.where(has, aux.cum_sum[bl] - aux.cum_sum[al], 0),
                scan._table_range(aux.st_min, a, b, torch.minimum, I32.max),
                scan._table_range(aux.st_max, a, b, torch.maximum, I32.min))

    edges = groupby.group_edges(glo, ghi, G, np.int32).reshape(-1)
    epids = impl.page_of(edges)
    e_cap = schedule.ladder_grid(edges.shape[0], tile, P)
    eplan = schedule.edge_scan_plan(epids, tile, e_cap, P)
    times.update({
        "span_descent_ms": cuda_ms(lambda: sc.span_of(lo_d, hi_d)),
        "span_plan_ms": cuda_ms(lambda: schedule.span_scan_plan(
            plo, phi, tile, g_cap, P)),
        "interior_ms": cuda_ms(interior),
        "group_edges_ms": cuda_ms(lambda: groupby.group_edges(
            glo, ghi, G, np.int32)),
        "edge_descent_ms": cuda_ms(lambda: impl.page_of(edges)),
        "edge_plan_ms": cuda_ms(lambda: schedule.edge_scan_plan(
            epids, tile, e_cap, P)),
    })
    times["ranges_per_s"] = N_RANGES / (times["scan_range_ms"] * 1e-3)
    times["profile_scan_range"] = device_profile(calls["scan_range"])
    times["profile_scan_groups_sum"] = device_profile(
        calls["scan_groups_sum"])

    real = torch.zeros(g_cap * tile, dtype=torch.bool, device=dev) \
        .index_fill_(0, plan.dest.long(), True)
    ereal = torch.zeros(e_cap * tile, dtype=torch.bool, device=dev) \
        .index_fill_(0, eplan.dest.long(), True)
    item_lo = torch.cat([lo_d, lo_d])        # the library call's operands
    item_hi = torch.cat([hi_d, hi_d])
    rows = []
    for mode, key in (("count", "search_range"), ("sum", "scan_range_sum"),
                      ("full", "scan_range")):
        args, kw = capture_call(scan, "page_scan_bucketed", calls[key])
        lib = (lambda: (torch.searchsorted(idx.keys_sorted, item_lo),
                        torch.searchsorted(idx.keys_sorted, item_hi,
                                           right=True))) \
            if mode == "count" else None
        rows.append(kernel_row(
            "page_scan_bucketed", mode,
            mode_launches["page_scan_bucketed"][mode], args, kw,
            ps.page_scan_plain, 2 * N_RANGES, real, 2, lib))
    for mode, key in (("count", "scan_groups_count"),
                      ("sum", "scan_groups_sum")):
        args, kw = capture_call(groupby, "page_prefix_bucketed",
                                calls[key])
        lib = (lambda: torch.searchsorted(idx.keys_sorted, edges)) \
            if mode == "count" else None
        rows.append(kernel_row(
            "page_prefix_bucketed", mode,
            mode_launches["page_prefix_bucketed"][mode], args, kw,
            ps.page_prefix_plain, edges.shape[0], ereal, 1, lib))
    check(all(r["max_abs_err"] == 0 for r in rows), "a scan kernel "
          "disagrees with its plain version at the path's shapes")
    shape = {"ranges": N_RANGES, "materialize": [N_MAT, MAT_K],
             "group_ranges": N_GROUP_RANGES, "groups": G,
             "top_k_ranges": N_TOPK_RANGES, "top_k": TOP_K,
             "multi": [N_MULTI, MULTI_R], "span_grid": g_cap,
             "span_steps_used": int(plan.steps_used), "edges":
             int(edges.shape[0]), "edge_grid": e_cap,
             "edge_steps_used": int(eplan.steps_used),
             "empty_ranges": int((cnt == 0).sum()),
             "matches": int(cnt.sum()), "multi": multi,
             "launches": launches, "mode_launches": mode_launches,
             "warm_up_s": warm_s}
    return rows, dict(shape, **times)


# --------------------------------------------------------------- phase 8
CDF_BATCHES = (1, 3, 8, 64, 256)
CDF_VOCABS = (1, 7, 100, 1000, 2048, 152_064)
CDF_TIMED = (1, 8, 64, 256)        # batch sizes timed at V = 152,064
CDF_ROW_LOOP = (70_000, 12)        # past the grid's 65,535 clusters
# The design the kernel replaced (a zeroed output, one atomicAdd a
# 1,024-entry chunk, a clamp after: three launches a call) is timed beside
# it only when --earlier-cdf names its source; else its times are null.


def cdf_rows(rng, B: int, V: int):
    """(cdf, u) on the host: rows from softmax + sort + cumsum of seeded
    logits; every 4th row with a flat run over [V/4, V/2); every 5th
    padded with +inf from 3V/4; u at 0, at 1e-6, equal to a cdf entry,
    above cdf[-1] (which gives V - 1) and inside a flat run."""
    x = rng.normal(size=(B, V)).astype(np.float32) * 3
    p = np.exp(x - x.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    cdf = np.cumsum(-np.sort(-p, axis=-1), -1).astype(np.float32)
    cdf[1::4, V // 4:V // 2] = cdf[1::4, V // 4:V // 4 + 1]
    u = rng.uniform(0, 1, B).astype(np.float32)
    u[0::6], u[1::6] = 0.0, 1e-6
    u[2::6] = cdf[2::6, V // 3]
    u[3::6] = cdf[3::6, -1] + 0.25
    u[5::6] = cdf[5::6, V // 4]                 # row 5 mod 4 == 1: flat run
    cdf[4::5, 3 * V // 4:] = np.inf
    return cdf, u


def start_earlier_cdf(src: str | None):
    """Start nvcc on the replaced CDF kernel's source `src` into
    build/earlier/, beside phase 1's builds: (process, library), or None
    when no source is given."""
    from repro_torch.kernels import _build
    if src is None:
        return None
    lib = _build.BUILD_DIR.parent / "earlier" / "libcdf_search_earlier.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def earlier_cdf_fn(started):
    """Wait for start_earlier_cdf's build; the replaced design as a
    function of (cdf, u), called as its wrapper called it (zero fill,
    kernel, clamp), or None."""
    import ctypes
    from repro_torch.kernels import _build
    if started is None:
        return None
    proc, lib = started
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"earlier cdf_search.cu did not build:\n{log}")
    fn = ctypes.CDLL(str(lib)).cdf_search_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(cdf, u):
        B, V = cdf.shape
        out = torch.zeros(B, dtype=torch.int32, device=cdf.device)
        vec = int(V % 4 == 0 and cdf.data_ptr() % 16 == 0)
        _build.check(fn(cdf.data_ptr(), u.data_ptr(), out.data_ptr(), B, V,
                        vec, torch.cuda.current_stream().cuda_stream),
                     "earlier cdf_search")
        return out.clamp_max_(V - 1)
    return call


def cdf_variants(dev, rng, cdf, u):
    """(name, cdf, u) on the card for one host case: the rows as given
    (sorted: np.searchsorted agrees), the odd width V - 1 (the scalar
    path), a base one float past 16-byte alignment (the scalar path at V
    % 4 == 0), rows that are not monotone (uniform noise, u in [0.2,
    0.8]: the count and a binary search differ) and NaN inside rows and
    in u."""
    B, V = cdf.shape
    cd, ud = torch.from_numpy(cdf).to(dev), torch.from_numpy(u).to(dev)
    shifted = torch.empty(B * V + 1, device=dev)[1:].view(B, V)
    shifted.copy_(cd)
    rough = torch.from_numpy(rng.random((B, V), dtype=np.float32)).to(dev)
    mid = torch.from_numpy(rng.uniform(0.2, 0.8, B).astype(np.float32)
                           ).to(dev)
    nan_rows, nan_u = cd.clone(), ud.clone()
    nan_rows[::2, V // 3] = float("nan")
    nan_u[1::3] = float("nan")
    out = [("sorted", cd, ud), ("unaligned base", shifted, ud),
           ("not monotone", rough, mid), ("NaN", nan_rows, nan_u)]
    if V > 1:
        out.append(("odd width", cd[:, 1:].contiguous(), ud))
    return out


def phase_cdf(dev, rng, earlier) -> dict:
    """The CDF kernel against its plain version, bit for bit, on every
    variant of every (B, V), np.searchsorted(..., "left") clipped to
    V - 1 on the sorted rows, the row loop past the grid and B = 0; the
    replaced design on the sorted rows. Then times at V = 152,064 and B
    in CDF_TIMED, the replaced design and the new one in turns (earlier,
    new, new, earlier), each call's event and device time beside
    searchsorted's, the plain version's and the byte bound."""
    from repro_torch.kernels import cdf_search as cs
    cases, worst, differs = 0, 0, 0
    for B in CDF_BATCHES:
        for V in CDF_VOCABS:
            cdf, u = cdf_rows(rng, B, V)
            ref = np.minimum([np.searchsorted(cdf[b], u[b], "left")
                              for b in range(B)], V - 1)
            for name, c, uu in cdf_variants(dev, rng, cdf, u):
                want = cs.invert_cdf(c, uu)
                got = cs.cdf_search(c, uu)
                torch.cuda.synchronize()
                check(got.dtype == torch.int32 and torch.equal(got, want),
                      f"cdf kernel != plain ({name}, B {B}, V {c.shape[1]})")
                worst = max(worst, max_abs_err(got, want))
                cases += 1
                if name == "sorted":
                    check(np.array_equal(want.cpu().numpy(), ref),
                          f"cdf plain != np.searchsorted (B {B}, V {V})")
                    if earlier is not None:
                        check(torch.equal(earlier(c, uu), want),
                              f"earlier cdf kernel != plain (B {B}, V {V})")
                if name == "not monotone":
                    rows = c.cpu().numpy()
                    mid = uu.cpu().numpy()
                    search = np.minimum([np.searchsorted(rows[b], mid[b])
                                         for b in range(B)], V - 1)
                    differs += int((search != want.cpu().numpy()).sum())
    check(differs > 0, "no rough row told the count from a binary search")
    B, V = CDF_ROW_LOOP
    c = torch.rand((B, V), device=dev)
    uu = torch.rand(B, device=dev)
    check(torch.equal(cs.cdf_search(c, uu), cs.invert_cdf(c, uu)),
          "row loop")
    cases += 1
    empty = cs.cdf_search(torch.zeros((0, 8), device=dev),
                          torch.zeros(0, device=dev))
    check(empty.shape == (0,), "B = 0")

    V = 152_064
    gen = torch.Generator(dev).manual_seed(int(rng.integers(1 << 30)))
    timed = {}
    for B in CDF_TIMED:
        p = torch.softmax(torch.randn((B, V), generator=gen, device=dev) * 3,
                          dim=-1)
        c = torch.cumsum(torch.sort(p, dim=-1, descending=True)[0], dim=-1)
        uu = torch.rand(B, generator=gen, device=dev)
        want = cs.invert_cdf(c, uu)
        fns = {"new": lambda: cs.cdf_search(c, uu)}
        if earlier is not None:
            fns["earlier"] = lambda: earlier(c, uu)
        turns = ["earlier", "new", "new", "earlier"]
        row = {k: {"ms": [], "device_ms": []} for k in fns}
        for name in turns:
            if name not in fns:
                continue
            check(torch.equal(fns[name](), want), f"{name} != plain, B {B}")
            row[name]["ms"].append(cuda_ms(fns[name]))
            row[name]["device_ms"].append(device_ms(fns[name]))
        if earlier is None:
            row["earlier"] = {"ms": None, "device_ms": None}
        bnd = bound(B * V * 4 + 8 * B, B * V)
        row.update(
            searchsorted_ms=cuda_ms(lambda: torch.searchsorted(c, uu[:, None])),
            searchsorted_device_ms=device_ms(
                lambda: torch.searchsorted(c, uu[:, None])),
            plain_ms=cuda_ms(lambda: cs.invert_cdf(c, uu)),
            plain_device_ms=device_ms(lambda: cs.invert_cdf(c, uu)),
            bound_ms=bnd[0], bound_by=bnd[1])
        timed[B] = row
    return {"cases": cases, "max_abs_err": worst,
            "rough_rows_count_ne_search": differs,
            "earlier_design": earlier is not None, "V": V, "times": timed}


# --------------------------------------------------------------- phase 9
SERVE_ARCH = "qwen3-0.6b"
SERVE_STEPS, SERVE_ROUNDS = 32, 2
TOP_P, TEMPERATURE = 0.9, 0.8
GREEDY_TOL = 2e-3          # the reference's warm/cold prefill tolerance
# what the reference launcher prints for --no-decode-queue --rounds 2 with
# its default prompts (8 x 48 tokens, 32 shared), on its default prefix
# store (the mutable one) and with --wholesale: the counts depend on the
# prompt structure only, not on the model's width
WANT_REUSE = (288, 480)
WANT_STORE = {"lookups": 23, "hits": 15, "rebuilds": 9, "verify_rejects": 0}
WANT_STORE_MUTABLE = dict(WANT_STORE, rebuilds=0)
WANT_WRITE_PATH = {"inserts": 10, "upserts": 0, "deletes": 0, "merges": 0,
                   "splits": 0, "pages_touched": 0, "rows_rewritten": 0,
                   "top_derives": 0, "base_rebuilds": 0, "shadowed": 0,
                   "seals": 0, "maintains": 0, "journal_replayed": 0}


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of fn() ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def in_nucleus(logits: np.ndarray, tokens: np.ndarray) -> bool:
    """Every token inside its row's top-p nucleus, in float64: the mass of
    the strictly more probable tokens stays below top_p (+1e-4 slack)."""
    x = logits.astype(np.float64) / TEMPERATURE
    p = np.exp(x - x.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    pt = np.take_along_axis(p, tokens[:, None].astype(np.int64), -1)
    above = np.where(p > pt, p, 0.0).sum(-1)
    return bool((above < TOP_P + 1e-4).all())


def served_run(eng, prompts, gen):
    """Two rounds of eng.generate with the kernel launch counters set to 0
    before and read after, keeping the sampler's logits and (cdf, u) and
    the operands of every page-kernel call the prefix store makes."""
    from repro_torch.engine import tiered
    from repro_torch.kernels import cdf_search as cs
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import page_scan as ps
    from repro_torch.kernels import page_search as pk
    from repro_torch.serve import engine as E
    from repro_torch.serve import sampler as S

    seen = {"logits": [], "tokens": [], "cdf_u": [], "probes": []}
    real_sample, real_kops = E.sample, S.kops

    def rec_sample(logits, cfg_, *, generator=None):
        seen["logits"].append(logits.clone())
        tok = real_sample(logits, cfg_, generator=generator)
        seen["tokens"].append(tok)
        return tok

    def rec_topp(cdf, u):
        seen["cdf_u"].append((cdf.clone(), u.clone()))
        return real_kops.topp_search(cdf, u)

    # the prefix store's probes reach the page kernel through the tiered
    # engine's ``_page``: keep each call's operands as the path built them
    real_page = tiered._page

    def rec_page(qb, step_pages, pages, *, stride, steps_used=None):
        seen["probes"].append((qb.clone(), step_pages.clone(), pages.clone(),
                               stride, None if steps_used is None
                               else steps_used.clone()))
        return real_page.page_search_bucketed(qb, step_pages, pages,
                                              stride=stride,
                                              steps_used=steps_used)

    counters = (pk.page_search_bucketed, kk.kary_search_levels,
                ps.page_scan_bucketed, ps.page_prefix_bucketed, cs.cdf_search)
    for c in counters:
        c.launches = 0
    E.sample = rec_sample
    S.kops = types.SimpleNamespace(topp_search=rec_topp)
    tiered._page = types.SimpleNamespace(
        **{**vars(real_page), "page_search_bucketed": rec_page})
    t0 = time.perf_counter()
    seen["reused_by_round"] = []
    try:
        for _ in range(SERVE_ROUNDS):
            before = eng.stats.reused_tokens
            out = eng.generate(prompts, SERVE_STEPS, generator=gen)
            seen["reused_by_round"].append(eng.stats.reused_tokens - before)
    finally:
        E.sample, S.kops, tiered._page = real_sample, real_kops, real_page
    torch.cuda.synchronize()
    seen["generate_s"] = time.perf_counter() - t0
    seen["launches"] = {c.__name__: c.launches for c in counters}
    seen["out"] = out
    return seen


def check_served(cfg, eng, seen, prompts, want_store, want_write_path,
                 what: str) -> dict:
    """Checks (a), (d) and (e) of one posture's counted run."""
    from repro_torch.kernels import cdf_search as cs
    from repro_torch.kernels import page_search as pk
    launches, out = seen["launches"], seen["out"]
    steps = SERVE_STEPS * SERVE_ROUNDS
    check(launches["cdf_search"] == steps, f"{what}: cdf_search launched "
          f"{launches['cdf_search']} times, want one a decode step ({steps})")
    # (a) prefix reuse as the reference launcher counts it
    st = eng.stats
    reuse, store_stats = (st.prefill_tokens, st.reused_tokens), \
        dict(eng.store.stats)
    check(reuse == WANT_REUSE, f"{what}: prefill computed/reused {reuse}")
    check(store_stats == want_store, f"{what}: store stats {store_stats}")
    check(eng.store.index_stats == want_write_path,
          f"{what}: write path {eng.store.index_stats}")
    check(st.decode_tokens == steps * len(prompts), "decode tokens")
    check(tuple(out.shape) == (len(prompts), SERVE_STEPS)
          and out.dtype == torch.int32, f"tokens out {tuple(out.shape)}")
    # (d) every sampled token in its nucleus, (e) kernel == plain on every
    # captured (cdf, u)
    check(len(seen["logits"]) == steps and len(seen["cdf_u"]) == steps,
          "captured steps")
    for lg, tok in zip(seen["logits"], seen["tokens"]):
        tok = tok.cpu().numpy()
        check(bool((tok < cfg.vocab).all()), "a padded vocabulary column "
              "was sampled")
        check(in_nucleus(lg.cpu().numpy(), tok), "a sampled token lies "
              "outside its top-p nucleus")
    cdf_err = 0
    for cdf, u in seen["cdf_u"]:
        got, want = cs.cdf_search(cdf, u), cs.invert_cdf(cdf, u)
        check(torch.equal(got, want), "cdf kernel != plain on a captured "
              "decode step")
        cdf_err = max(cdf_err, max_abs_err(got, want))
    # the page kernel == plain on every probe the store made, at the store's
    # own shapes (a few pages, ~24 hashes a probe, few steps of the grid)
    check(len(seen["probes"]) == launches["page_search_bucketed"],
          "captured store probes")
    probe_err, probe_shapes = 0, set()
    for qb, sp, pages, stride, used_t in seen["probes"]:
        got = pk.page_search_bucketed(qb, sp, pages, stride=stride,
                                      steps_used=used_t)
        want = pk.page_search_plain(qb, sp, pages, stride=stride)
        u = sp.shape[0] if used_t is None else int(used_t)
        check(torch.equal(got[:u], want[:u]), "page kernel != plain on a "
              f"store probe (grid {tuple(qb.shape)}, {pages.shape[0]} "
              f"pages, {u} steps used)")
        probe_err = max(probe_err, max_abs_err(got[:u], want[:u]))
        probe_shapes.add((*qb.shape, pages.shape[0], u))
    return {"launches": launches, "prefill_computed_reused": list(reuse),
            "prefix_store": store_stats,
            "write_path": eng.store.index_stats,
            "store_probes_checked": len(seen["probes"]),
            "store_probe_max_abs_err": probe_err,
            "store_probe_shapes_g_tq_pages_used": sorted(probe_shapes),
            "cdf_max_abs_err": cdf_err, "generate_s": seen["generate_s"]}


def restored_round(dev, eng, fresh, prompts, gen, reused_by_round) -> dict:
    """The mutable prefix store saved after its two rounds and restored
    (its index from its own snapshot and journal) into a fresh engine on
    the same weights, then one more round there: it reuses as many tokens
    as round 2 did, and the CDF kernel runs once a decode step."""
    import tempfile
    from repro_torch.kernels import cdf_search as cs
    from repro_torch.serve.kv_cache import PrefixPageStore
    d = tempfile.mkdtemp(prefix="chip_smoke_prefix_")
    try:
        t0 = time.perf_counter()
        eng.store.save(d)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        fresh.store = PrefixPageStore.restore(
            d, index_config=eng.store.index_config, device=dev)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(fresh.store.hashes == eng.store.hashes
          and fresh.store._index.n == eng.store._index.n,
          "the restored prefix store differs from the saved one")
    cs.cdf_search.launches = 0
    fresh.generate(prompts, SERVE_STEPS, generator=gen)
    torch.cuda.synchronize()
    reused = fresh.stats.reused_tokens
    check(reused == reused_by_round[-1], f"the restored store reused "
          f"{reused} tokens, round 2 reused {reused_by_round[-1]}")
    check(cs.cdf_search.launches == SERVE_STEPS, "cdf_search launched "
          f"{cs.cdf_search.launches} times after the restore, want "
          f"{SERVE_STEPS}")
    return {"reused_by_round": reused_by_round, "restored_reused": reused,
            "pages": len(fresh.store.hashes), "save_ms": save_ms,
            "restore_ms": restore_ms,
            "cdf_launches": cs.cdf_search.launches,
            "prefix_store": dict(fresh.store.stats),
            "write_path": fresh.store.index_stats}


def serve_path(dev, seed: int):
    """Phase 9: ServeEngine.generate at qwen3-0.6b's full width, on the
    mutable prefix store (the default) and on the wholesale one."""
    from repro_torch.configs import get_config
    from repro_torch.core import IndexConfig
    from repro_torch.kernels import cdf_search as cs
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import transformer as T
    from repro_torch.serve import SamplerConfig, ServeEngine
    from repro_torch.serve import sampler as S

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = T.param_count(params)
    check(n_params == 596_180_992, f"{n_params} parameters")
    scfg = SamplerConfig(temperature=TEMPERATURE, top_p=TOP_P)

    def engine(sampler, wholesale=False):
        config = IndexConfig(kind="tiered", plan="device", mutable=False) \
            if wholesale else None            # None: the mutable default
        return ServeEngine(cfg, params, max_len=256, page_size=16,
                           index_config=config, decode_batching=False,
                           sampler=sampler)

    prompts = make_prompts(cfg.vocab)
    steps = SERVE_STEPS * SERVE_ROUNDS
    # ---- the counted runs: the mutable default (the main path), then the
    # wholesale posture on the same weights
    eng = engine(scfg)
    check(eng.store.index_config.mutable, "the default store is not mutable")
    gen = torch.Generator(dev).manual_seed(seed)
    seen = served_run(eng, prompts, gen)
    posture = {"mutable": check_served(cfg, eng, seen, prompts,
                                       WANT_STORE_MUTABLE, WANT_WRITE_PATH,
                                       "mutable store")}
    # all 10 page hashes stay in the 1,024-entry delta buffer: the probes
    # are delta probes and reach no page kernel (phase 10 holds it)
    launches = seen["launches"]
    check(launches["page_search_bucketed"] == 0
          and launches["kary_search_levels"] == 0,
          f"the mutable store launched a base kernel: {launches}")
    check(eng.store._index.base is None, "the mutable store built a base")
    posture["mutable_restored"] = restored_round(dev, eng, engine(scfg),
                                                 prompts, gen,
                                                 seen["reused_by_round"])
    whole = engine(scfg, wholesale=True)
    seen_w = served_run(whole, prompts,
                        torch.Generator(dev).manual_seed(seed))
    posture["wholesale"] = check_served(cfg, whole, seen_w, prompts,
                                        WANT_STORE, {}, "wholesale store")
    check(seen_w["launches"]["page_search_bucketed"] > 0,
          "the wholesale store's probes did not reach the page kernel")
    cdf_err = posture["mutable"]["cdf_max_abs_err"]

    # (b) warm prefill (two pages reused) == cold prefill, on both stores
    cold_eng = engine(scfg)
    cold_whole = engine(scfg, wholesale=True)
    cold, _ = cold_eng.prefill_one(prompts[0])
    warm_err = 0.0
    for e in (eng, whole):
        warm, _ = e.prefill_one(prompts[0])
        check(torch.allclose(warm, cold, atol=GREEDY_TOL, rtol=GREEDY_TOL),
              "warm prefill logits differ from cold beyond 2e-3: "
              f"{float((warm - cold).abs().max())}")
        warm_err = max(warm_err, float((warm - cold).abs().max()))

    # (c) greedy tokens are the argmax of a full forward, where the top-2
    # margin exceeds the tolerance
    greedy = engine(SamplerConfig(temperature=0.0))
    g_out = greedy.generate(prompts[:2], 4).cpu().numpy()
    checked = 0
    for b in range(2):
        toks = np.concatenate([prompts[b], g_out[b]]).astype(np.int32)
        h, _ = T.forward(cfg, params, torch.from_numpy(toks[None, :-1])
                         .to(dev), compute_dtype=torch.float32)
        lg = T.logits_of(cfg, params, h)[0, -4:]
        top2 = torch.topk(lg, 2, dim=-1)
        margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
        arg = top2.indices[:, 0].cpu().numpy()
        ok = margin > GREEDY_TOL
        check(np.array_equal(arg[ok], g_out[b][ok]), "a greedy token is "
              "not the argmax of the full forward")
        checked += int(ok.sum())
    check(checked > 0, "no greedy token had a top-2 margin above 2e-3")

    # (f) no host sync inside one decode step: sample + decode_step on the
    # batch prefill of the same prompts
    tok8 = torch.from_numpy(np.stack(prompts).astype(np.int32)).to(dev)
    lg8, cache = T.prefill(cfg, params, tok8, max_len=256,
                           compute_dtype=torch.float32)
    torch.cuda.synchronize()

    def step():
        nxt = S.sample(lg8, scfg, generator=gen)
        return T.decode_step(cfg, params, nxt, cache,
                             compute_dtype=torch.float32)

    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    # ---- times
    B, V = lg8.shape
    order, cdf8 = S.nucleus_cdf(lg8, scfg)
    u8 = S.draw_u(cdf8, scfg, gen)
    probs = torch.softmax(lg8 / TEMPERATURE, dim=-1)
    p_sorted = torch.sort(probs, dim=-1, descending=True, stable=True)[0]
    nxt = S.sample(lg8, scfg, generator=gen)
    st = eng.stats
    times = {
        # host clock, median of 5, on the mutable store and the wholesale
        "prefill_cold_ms": host_ms(
            lambda: cold_eng.prefill_one(prompts[0], probe=(0, []))),
        "prefill_warm_ms": host_ms(lambda: eng.prefill_one(prompts[0])),
        "wholesale_prefill_cold_ms": host_ms(
            lambda: cold_whole.prefill_one(prompts[0], probe=(0, []))),
        "wholesale_prefill_warm_ms": host_ms(
            lambda: whole.prefill_one(prompts[0])),
        "decode_step_ms": cuda_ms(step),
        "model_ms": cuda_ms(lambda: T.decode_step(
            cfg, params, nxt, cache, compute_dtype=torch.float32)),
        "sample_ms": cuda_ms(lambda: S.sample(lg8, scfg, generator=gen)),
        "softmax_ms": cuda_ms(lambda: torch.softmax(lg8 / TEMPERATURE,
                                                    dim=-1)),
        "argsort_ms": cuda_ms(lambda: torch.sort(
            probs, dim=-1, descending=True, stable=True)),
        "cumsum_ms": cuda_ms(lambda: torch.cumsum(p_sorted, dim=-1)),
        "cdf_kernel_ms": cuda_ms(lambda: cs.cdf_search(cdf8, u8)),
        "sample_device_ms": device_ms(
            lambda: S.sample(lg8, scfg, generator=gen), reps=5),
        "model_device_ms": device_ms(lambda: T.decode_step(
            cfg, params, nxt, cache, compute_dtype=torch.float32), reps=3),
    }
    times["tokens_per_s"] = B / (times["decode_step_ms"] * 1e-3)
    times["sampler_share"] = times["sample_ms"] / times["decode_step_ms"]
    times["engine_decode_ms_per_step"] = st.decode_s / steps * 1e3
    times["engine_tokens_per_s"] = st.decode_tokens / st.decode_s
    prof = device_profile(step)
    prof["idle_share"] = 1 - prof["kernels_ms"] / times["decode_step_ms"]
    times["profile_decode_step"] = prof
    # the sampler alone: its launches a step, the CDF kernel's among them
    times["profile_sample"] = device_profile(
        lambda: S.sample(lg8, scfg, generator=gen))

    sweep = {}
    for b in (8, 64, 256):
        x = torch.randn((b, V), generator=gen, device=dev) * 3
        _, c = S.nucleus_cdf(x, scfg)
        uu = S.draw_u(c, scfg, gen)
        got, want = cs.cdf_search(c, uu), cs.invert_cdf(c, uu)
        check(torch.equal(got, want), f"cdf kernel != plain at B {b}")
        bnd = bound(b * V * 4 + 8 * b, b * V)
        sweep[b] = {"ms": cuda_ms(lambda: cs.cdf_search(c, uu)),
                    "device_ms": device_ms(lambda: cs.cdf_search(c, uu)),
                    "plain_ms": cuda_ms(lambda: cs.invert_cdf(c, uu)),
                    "plain_device_ms": device_ms(
                        lambda: cs.invert_cdf(c, uu)),
                    "searchsorted_ms": cuda_ms(
                        lambda: torch.searchsorted(c, uu[:, None])),
                    "searchsorted_device_ms": device_ms(
                        lambda: torch.searchsorted(c, uu[:, None])),
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "compares_ms": b * V / COMPARES_PER_S * 1e3}
    times["cdf_kernel_sweep"] = sweep

    # bounds: the float32 weights once a step, plus the KV cache read
    L = int(cache["lengths"][0]) + 1
    kv_bytes = B * cfg.n_layers * L * cfg.n_kv_heads * cfg.hd * 2 * 4
    w_bytes = n_params * 4
    times["decode_step_bound_ms"] = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    times["decode_step_bound_bytes"] = w_bytes + kv_bytes

    cdf_p, u_p = seen["cdf_u"][-1]           # the path's own operands
    k_bound = bound(cdf_p.numel() * 4 + 8 * cdf_p.shape[0], cdf_p.numel())
    row = {
        "name": "cdf_search", "route": "cuda",
        "source": "src/repro_torch/csrc/cdf_search.cu",
        "replaces": "src/repro/kernels/cdf_search.py:47",
        "launches": launches["cdf_search"], "max_abs_err": cdf_err,
        "ms": cuda_ms(lambda: cs.cdf_search(cdf_p, u_p)),
        "plain_ms": cuda_ms(lambda: cs.invert_cdf(cdf_p, u_p)),
        "bound_ms": k_bound[0], "bound_by": k_bound[1],
        "library_ms": cuda_ms(lambda: torch.searchsorted(cdf_p,
                                                         u_p[:, None])),
        "shape": list(cdf_p.shape),
        # the kernel's, the plain version's and the library call's device
        # time (the event times above are set by the host at this size)
        "device_ms": device_ms(lambda: cs.cdf_search(cdf_p, u_p)),
        "plain_device_ms": device_ms(lambda: cs.invert_cdf(cdf_p, u_p)),
        "library_device_ms": device_ms(
            lambda: torch.searchsorted(cdf_p, u_p[:, None])),
    }
    shape = {"arch": SERVE_ARCH, "params": n_params, "requests": len(prompts),
             "prompt_len": int(prompts[0].size), "steps": SERVE_STEPS,
             "rounds": SERVE_ROUNDS, "launches": launches,
             "postures": posture, "greedy_tokens_checked": checked,
             "warm_cold_max_abs_diff": warm_err, "init_s": init_s,
             "kv_len": L}
    return row, dict(shape, **times)


# -------------------------------------------------------------- phase 10
# The reference's update benchmark (benchmarks/bench_updates.py: rounds of
# write batches and lookup batches, a delete-heavy mix) at phase 4's size:
# each round writes 2,048 new keys, 1,024 upserts and 1,024 deletes of
# resident keys (four crossings of the 1,024-entry delta buffer: seals and
# backpressure folds), folds, then looks up 2^20 keys. One round also
# crowds one page past leaf_width: a repack and a re-derived top.
STORE_ROUNDS = 8
STORE_NEW, STORE_UPSERTS, STORE_DELETES = 2048, 1024, 1024
STORE_SPLIT_ROUND, STORE_SPLIT_KEYS = 4, 600


def capture_store_kernels(store, q_dev):
    """One store lookup with the operands of its page-kernel and k-ary
    kernel calls kept, as the store's pipeline built them."""
    from repro_torch.engine import tiered
    real_page, real_kary = tiered._page, tiered._kary
    seen = {}

    def rec_page(*args, **kw):
        seen["page"] = (args, kw)
        return real_page.page_search_bucketed(*args, **kw)

    def rec_kary(*args, **kw):
        seen["kary"] = (args, kw)
        return real_kary.kary_search_levels(*args, **kw)

    tiered._page = types.SimpleNamespace(
        **{**vars(real_page), "page_search_bucketed": rec_page})
    tiered._kary = types.SimpleNamespace(
        **{**vars(real_kary), "kary_search_levels": rec_kary})
    try:
        store.lookup(q_dev)
    finally:
        tiered._page, tiered._kary = real_page, real_kary
    torch.cuda.synchronize()
    return seen


def store_kernels_vs_plain(store, q_dev) -> dict:
    """The page and k-ary kernels on the store's own operands against their
    plain versions, bit for bit (the steps the plan used), and their
    times at these shapes."""
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import page_search as pk
    seen = capture_store_kernels(store, q_dev)
    (qb, sp, pages), pkw = seen["page"]
    used = int(pkw["steps_used"])
    plain_kw = {k: v for k, v in pkw.items() if k != "steps_used"}
    p_got = pk.page_search_bucketed(qb, sp, pages, **pkw)
    p_want = pk.page_search_plain(qb, sp, pages, **plain_kw)
    check(torch.equal(p_got[:used], p_want[:used]), "page kernel != plain "
          "on the store's gapped pages")
    kargs, kkw = seen["kary"]
    k_got = kk.kary_search_levels(*kargs, **kkw)
    k_want = kk.kary_search_plain(*kargs, **kkw)
    check(torch.equal(k_got, k_want), "k-ary kernel != plain on the store's "
          "top")
    return {"num_pages": int(pages.shape[0]), "lw_pad": int(pages.shape[1]),
            "stride": pkw["stride"], "steps_used": used,
            "grid": int(sp.shape[0]),
            "kary_depth": len(kargs[2]),
            "page_max_abs_err": max_abs_err(p_got[:used], p_want[:used]),
            "kary_max_abs_err": max_abs_err(k_got, k_want),
            "page_ms": cuda_ms(lambda: pk.page_search_bucketed(
                qb, sp, pages, **pkw)),
            "kary_ms": cuda_ms(lambda: kk.kary_search_levels(*kargs,
                                                             **kkw))}


def store_oracle_write(ok, ov, ins_k, ins_v, del_k):
    """The oracle's sorted (keys, values) after upserting (ins_k, ins_v)
    (unique keys) and then deleting del_k."""
    pos = np.searchsorted(ok, ins_k)
    hit = (pos < ok.size) & (ok[np.minimum(pos, ok.size - 1)] == ins_k)
    ov = ov.copy()
    ov[pos[hit]] = ins_v[hit]
    order = np.argsort(ins_k[~hit])
    new_k, new_v = ins_k[~hit][order], ins_v[~hit][order]
    at = np.searchsorted(ok, new_k)
    ok, ov = np.insert(ok, at, new_k), np.insert(ov, at, new_v)
    pos = np.searchsorted(ok, del_k)
    hit = (pos < ok.size) & (ok[np.minimum(pos, ok.size - 1)] == del_k)
    return np.delete(ok, pos[hit]), np.delete(ov, pos[hit])


def fresh_keys(rng, ok, lo, hi, n):
    """n distinct keys in [lo, hi) that the oracle does not hold."""
    out = np.empty(0, np.int32)
    while out.size < n:
        c = np.unique(rng.integers(lo, hi, 2 * n, dtype=np.int64)
                      .astype(np.int32))
        pos = np.minimum(np.searchsorted(ok, c), ok.size - 1)
        out = np.union1d(out, c[ok[pos] != c])
    return rng.permutation(out)[:n]


def store_path(dev, rng, keys_sorted, values_sorted, immutable_ms):
    """Phase 10: the mutable store at 2^24 keys, rounds of writes, folds
    and 2^20-query lookups against a numpy oracle."""
    from repro_torch import IndexConfig, build_index
    from repro_torch.engine import delta as D
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import page_search as pk

    t0 = time.perf_counter()
    store = build_index(keys_sorted, values_sorted,
                        IndexConfig(kind="tiered", mutable=True))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    base = store.base
    check((base.top_kind, base.leaf_width, base.num_pages, base.lw_pad)
          == ("kary", 2048, 10923, 2048) and len(base.top.level_offsets) == 2,
          f"store layout {base.top_kind} {base.leaf_width} "
          f"{base.num_pages} {base.lw_pad}")
    check(store.delta.capacity == 1024 and store._mode == "deferred",
          "store defaults")
    ok, ov = keys_sorted, values_sorted
    pages0 = base.num_pages
    rounds, kernel_checks, insert_us, delete_us, fold_ms = [], [], [], [], []
    repack_ms = None
    for r in range(STORE_ROUNDS):
        new_k = fresh_keys(rng, ok, I32.min + 1, I32.max - 1, STORE_NEW)
        pick = rng.choice(ok.size, STORE_UPSERTS + STORE_DELETES,
                          replace=False)
        up_k, del_k = ok[pick[:STORE_UPSERTS]], ok[pick[STORE_UPSERTS:]]
        ins_k = rng.permutation(np.concatenate([new_k, up_k]))
        ins_v = rng.integers(I32.min + 1, I32.max, ins_k.size,
                             dtype=np.int64).astype(np.int32)
        # two halves of (inserts, deletes), so that the active tier holds
        # live entries and tombstones when the round's lookup runs
        t_ins = t_del = 0.0
        for h in (0, 1):
            ih = slice(h * ins_k.size // 2, (h + 1) * ins_k.size // 2)
            dh = slice(h * del_k.size // 2, (h + 1) * del_k.size // 2)
            t0 = time.perf_counter()
            store.insert(ins_k[ih], ins_v[ih])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            store.delete(del_k[dh])
            torch.cuda.synchronize()
            t_ins += t1 - t0
            t_del += time.perf_counter() - t1
        insert_us.append(t_ins * 1e6 / ins_k.size)
        delete_us.append(t_del * 1e6 / del_k.size)
        ok, ov = store_oracle_write(ok, ov, ins_k, ins_v, del_k)
        t0 = time.perf_counter()
        folded = store.maintain()
        torch.cuda.synchronize()
        check(folded, "maintain() found no sealed buffer to fold")
        fold_ms.append((time.perf_counter() - t0) * 1e3)
        written = np.concatenate([ins_k, del_k])
        if r == STORE_SPLIT_ROUND:
            store.flush()
            b = store.base
            p = b.num_pages // 2
            split_k = fresh_keys(rng, ok, int(b.seps[p - 1]) + 1,
                                 int(b.seps[p]), STORE_SPLIT_KEYS)
            split_v = np.arange(split_k.size, dtype=np.int32)
            splits0, derives0 = store.stats["splits"], b.derives
            store.insert(split_k, split_v)
            ok, ov = store_oracle_write(ok, ov, split_k, split_v,
                                        split_k[:0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            store.flush()
            torch.cuda.synchronize()
            repack_ms = (time.perf_counter() - t0) * 1e3
            check(store.stats["splits"] > splits0
                  and store.base.num_pages != pages0
                  and store.base.derives > derives0,
                  f"no split: {store.stats}, {store.base.num_pages} pages")
            written = np.concatenate([written, split_k])
        # 2^20 queries: half resident keys, a quarter written this round
        # (deletes included), a quarter uniform misses
        half, quarter = N_QUERIES // 2, N_QUERIES // 4
        q = rng.permutation(np.concatenate([
            ok[rng.integers(0, ok.size, half)],
            written[rng.integers(0, written.size, quarter)],
            rng.integers(I32.min + 1, I32.max - 1, quarter,
                         dtype=np.int64).astype(np.int32)]))
        q_dev = torch.from_numpy(q).to(dev)
        if r in (0, STORE_SPLIT_ROUND):        # before and after the repack
            kernel_checks.append(store_kernels_vs_plain(store, q_dev))
        torch.cuda.synchronize()
        pk.page_search_bucketed.launches = 0
        kk.kary_search_levels.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = store.lookup(q_dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launches = {"page_search_bucketed": pk.page_search_bucketed.launches,
                    "kary_search_levels": kk.kary_search_levels.launches}
        check(launches == {"page_search_bucketed": 1,
                           "kary_search_levels": 1},
              f"round {r}: store lookup launches {launches}")
        # found / values against the oracle; the slot address holds the
        # key wherever the base answers (a hit in no delta tier)
        pos = np.minimum(np.searchsorted(ok, q), ok.size - 1)
        want_found = ok[pos] == q
        found = res.found.cpu().numpy()
        vals = res.values.cpu().numpy()
        rank = res.rank.cpu().numpy()
        check(np.array_equal(found, want_found), f"round {r}: found")
        check(np.array_equal(vals[found], ov[pos][found]), f"round {r}: "
              "values")
        b = store.base
        in_delta = np.isin(q, np.concatenate([store.delta.live()[0],
                                              store.sealed.live()[0]]))
        from_base = found & ~in_delta
        check(np.array_equal(b.keys.reshape(-1)[rank[from_base]],
                             q[from_base]), f"round {r}: slot addresses")
        check(store.n == ok.size, f"round {r}: n {store.n} != {ok.size}")
        check(bool((b.keys[:, 1:] >= b.keys[:, :-1]).all()),
              f"round {r}: a page is not sorted")
        rounds.append({"round": r, "n": int(ok.size),
                       "num_pages": b.num_pages, "hits": int(found.sum()),
                       "from_base": int(from_base.sum()),
                       "delta_entries": int(store.delta.count)})
    check(len(kernel_checks) == 2 and kernel_checks[0]["num_pages"]
          != kernel_checks[1]["num_pages"], "kernel checks around the repack")

    # ---- times, on the last round's queries and store state
    ak, av, asp = store.delta.device_state()
    atb = store.delta.device_bits()[2]
    sk, sv, ssp = store.sealed.device_state()
    stb = store.sealed.device_bits()[2]
    b = store.base
    lookup_ms = cuda_ms(lambda: store.lookup(q_dev))
    probe_ms = cuda_ms(lambda: (D.probe_full(q_dev, ak, av, atb, asp),
                                D.probe_full(q_dev, sk, sv, stb, ssp)))
    prof = device_profile(lambda: store.lookup(q_dev))
    prof["idle_share"] = 1 - prof["kernels_ms"] / lookup_ms
    summary = {
        "keys": int(keys_sorted.size), "build_s": build_s,
        "leaf_width": b.leaf_width, "num_pages_start": pages0,
        "num_pages_end": b.num_pages, "top": b.top_kind,
        "device_bytes": (b.dev_keys.numel() * b.dev_keys.element_size()
                         + b.dev_vals.numel() * b.dev_vals.element_size()),
        "rounds": rounds, "stats": dict(store.stats),
        "kernel_checks": kernel_checks,
        "lookup_ms": lookup_ms, "immutable_lookup_ms": immutable_ms,
        "queries_per_s": N_QUERIES / (lookup_ms * 1e-3),
        "delta_probe_ms": probe_ms, "delta_probe_share": probe_ms / lookup_ms,
        "base_pipeline_ms": cuda_ms(lambda: b.pipeline_stats(q_dev,
                                                             b.dev_keys)),
        "launches_per_lookup": prof["kernel_launches"],
        "insert_us_per_op": float(np.median(insert_us)),
        "delete_us_per_op": float(np.median(delete_us)),
        "insert_us_per_op_rounds": insert_us,
        "delete_us_per_op_rounds": delete_us,
        "fold_ms": float(np.median(fold_ms)), "fold_ms_rounds": fold_ms,
        "repack_ms": repack_ms, "profile_lookup": prof,
        "launches": launches,
    }
    return summary, store, ok, ov


# -------------------------------------------------------------- phase 11
# Phase 7's traffic on phase 10's store. The last ranges of the 2^18 have
# hi at the key sentinel (INT32_MAX): the reference counts gap slots
# there (ROADMAP Queue 3 item 10), so those rows are recorded, not held to
# numpy. The second state's writes leave both tiers with live entries,
# upserts and tombstones: about one and a half delta buffers.
N_SENTINEL_RANGES = 64
SCAN_STATE_NEW, SCAN_STATE_UPSERTS, SCAN_STATE_DELETES = 768, 384, 384


def slot_keys(store) -> np.ndarray:
    """The key at every slot address a store scan gives: the base pages,
    then the sealed tier, then the active tier."""
    return np.concatenate([store.base.keys.reshape(-1),
                           store.sealed.h_keys.reshape(-1),
                           store.delta.h_keys.reshape(-1)])


def check_store_scans(store, res, ok, ov, lo, hi, ranges) -> dict:
    """Every result of one state against the numpy oracle of the live
    merged keys (ok, ov): counts, ranks and wrapped sums on every range
    below the sentinel, min / max / rows / top-K on a 4096-range subset;
    materialized and top-K slot addresses read back through the store's
    host arrays. The sentinel rows are recorded."""
    n_ok = lo.size - N_SENTINEL_RANGES
    cs = np.zeros(ok.size + 1, np.int64)
    cs[1:] = np.cumsum(ov.astype(np.int64))
    r_lo, r_hi, cnt, vsum = range_oracle(ok, cs, lo, hi)
    for key in ("scan_range", "scan_range_sum"):
        r = res[key]
        same(r.count[:n_ok], cnt[:n_ok], f"store {key} count")
        same(r.r_lo[:n_ok], r_lo[:n_ok], f"store {key} r_lo")
        same(r.r_hi_excl[:n_ok], r_hi[:n_ok], f"store {key} r_hi_excl")
        same(r.vsum[:n_ok], vsum[:n_ok], f"store {key} vsum")
    for got, want, f in zip(res["search_range"], (r_lo, r_hi, cnt),
                            ("r_lo", "r_hi_excl", "count")):
        same(got[:n_ok], want[:n_ok], f"store search_range {f}")
    sub = np.arange(N_SUBSET)
    mn, mx = seg_minmax(ov, r_lo[sub], r_hi[sub])
    same(res["scan_range"].vmin[:N_SUBSET], mn, "store scan_range vmin")
    same(res["scan_range"].vmax[:N_SUBSET], mx, "store scan_range vmax")

    keys_at = slot_keys(store)
    m = res["scan_range_materialize"]
    mr = r_lo[:N_MAT, None] + np.arange(MAT_K)[None, :]
    mvalid = np.arange(MAT_K)[None, :] < cnt[:N_MAT, None]
    addr = m.ranks.cpu().numpy()
    check(np.array_equal(addr >= 0, mvalid), "store materialize: rows")
    check(np.array_equal(keys_at[addr[mvalid]],
                         ok[np.minimum(mr, ok.size - 1)][mvalid]),
          "store materialize: slot addresses do not hold the keys")
    same(m.values, np.where(mvalid, ov[np.minimum(mr, ok.size - 1)], 0),
         "store materialized values")
    same(m.overflow, cnt[:N_MAT] > MAT_K, "store materialize overflow")

    G = N_GROUPS
    e, r_edge, gcnt, gsum = group_oracle(ok, cs, lo[:N_GROUP_RANGES],
                                         hi[:N_GROUP_RANGES], G)
    for key in ("scan_groups_count", "scan_groups_sum", "scan_groups_full"):
        g = res[key]
        same(g.edges, e, f"store {key} edges")
        same(g.r_edge, r_edge, f"store {key} r_edge")
        same(g.count, gcnt, f"store {key} count")
        if key != "scan_groups_count":
            same(g.vsum, gsum, f"store {key} vsum")
    gmn, gmx = bucket_minmax(ov, r_edge[:N_SUBSET])
    same(res["scan_groups_full"].vmin[:N_SUBSET], gmn, "store groups vmin")
    same(res["scan_groups_full"].vmax[:N_SUBSET], gmx, "store groups vmax")
    t = res["scan_groups_top_k"]
    C = max(2 * TOP_K, 32)
    topv, topr, over = topk_oracle(ov, r_edge[:N_TOPK_RANGES], TOP_K, C)
    same(t.topk_values.reshape(-1, TOP_K), topv, "store top-K values")
    tr = t.topk_ranks.reshape(-1, TOP_K).cpu().numpy()
    check(np.array_equal(tr >= 0, topr >= 0), "store top-K rows")
    check(np.array_equal(keys_at[tr[tr >= 0]], ok[topr[topr >= 0]]),
          "store top-K slot addresses do not hold the keys")
    same(t.overflow.reshape(-1), over, "store top-K overflow")

    multi = {}
    for op in ("union", "intersect"):
        mc, msum, mlo, mhi, pieces = multi_oracle(ok, cs, ranges, op)
        r = res[f"scan_multi_{op}"]
        same(r.count, mc, f"store scan_multi {op} count")
        same(r.vsum, msum, f"store scan_multi {op} vsum")
        same(r.r_lo, mlo, f"store scan_multi {op} r_lo")
        same(r.r_hi_excl, mhi, f"store scan_multi {op} r_hi_excl")
        pmn, pmx = pieces_minmax(ov, pieces, sub)
        same(r.vmin[:N_SUBSET], pmn, f"store scan_multi {op} vmin")
        same(r.vmax[:N_SUBSET], pmx, f"store scan_multi {op} vmax")
        multi[op] = {"empty": int((mc == 0).sum()),
                     "matches": int(mc.sum())}
    got_s = res["scan_range"].count[n_ok:].cpu().numpy()
    return {"ranges_checked": n_ok, "matches": int(cnt[:n_ok].sum()),
            "multi": multi, "sentinel_rows": {
                "rows": N_SENTINEL_RANGES,
                "port_count_sum": int(got_s.sum()),
                "numpy_count_sum": int(cnt[n_ok:].sum()),
                "rows_differing": int((got_s != cnt[n_ok:]).sum()),
                "port_count_first": got_s[:4].tolist(),
                "numpy_count_first": cnt[n_ok:][:4].tolist()}}


def run_store_scans(dev, store, calls) -> tuple:
    """Every call once under set_sync_debug_mode("error") with the scan
    kernels' launch counters set to 0 just before and read just after;
    the first call pays the scan state's rebuild (dirty rows, page
    aggregates, tier views) after a write."""
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import page_scan as ps
    from repro_torch.kernels import page_search as pk
    counters = (pk.page_search_bucketed, kk.kary_search_levels,
                ps.page_scan_bucketed, ps.page_prefix_bucketed)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
        if hasattr(c, "mode_launches"):
            c.mode_launches = dict.fromkeys(c.mode_launches, 0)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = {k: fn() for k, fn in calls.items()}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    mode_launches = {
        "page_scan_bucketed": dict(ps.page_scan_bucketed.mode_launches),
        "page_prefix_bucketed": dict(ps.page_prefix_bucketed.mode_launches)}
    check(all(v > 0 for m in mode_launches.values() for v in m.values()),
          f"a scan kernel mode did not launch on the store: {mode_launches}")
    check(launches["kary_search_levels"] > 0, "the store's span descent did "
          "not go through the k-ary kernel")
    return res, {"launches": launches, "mode_launches": mode_launches,
                 "wall_s": wall_s}


def store_scan_path(dev, rng, store, ok, ov, immutable: dict):
    """Phase 11: phase 7's scans on phase 10's store at 2^24 keys, after
    round 8's maintain() and again with unfolded writes in both tiers."""
    from repro_torch.engine import groupby, scan, schedule, tiered
    from repro_torch.engine.store import TOMBSTONE
    from repro_torch.kernels import page_scan as ps
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    states = {}
    for state in ("after_maintain", "unfolded_tiers"):
        if state == "unfolded_tiers":
            new_k = fresh_keys(rng, ok, I32.min + 1, I32.max - 1,
                               SCAN_STATE_NEW)
            pick = rng.choice(ok.size, SCAN_STATE_UPSERTS
                              + SCAN_STATE_DELETES, replace=False)
            up_k = ok[pick[:SCAN_STATE_UPSERTS]]
            del_k = ok[pick[SCAN_STATE_UPSERTS:]]
            ins_k = rng.permutation(np.concatenate([new_k, up_k]))
            ins_v = rng.integers(I32.min + 1, I32.max, ins_k.size,
                                 dtype=np.int64).astype(np.int32)
            for h in (0, 1):
                ih = slice(h * ins_k.size // 2, (h + 1) * ins_k.size // 2)
                dh = slice(h * del_k.size // 2, (h + 1) * del_k.size // 2)
                store.insert(ins_k[ih], ins_v[ih])
                store.delete(del_k[dh])
            ok, ov = store_oracle_write(ok, ov, ins_k, ins_v, del_k)
            check(store.sealed.count > 0 and store.sealed.tombs > 0
                  and store.delta.tombs > 0 and store._dirty_rows,
                  "the write round left a tier without tombstones")
        lo, hi = scan_ranges(rng, ok, N_RANGES)
        hi[-N_SENTINEL_RANGES:] = I32.max
        lo[-N_SENTINEL_RANGES:] = np.where(
            np.arange(N_SENTINEL_RANGES) % 2 == 0, I32.min,
            ok[rng.integers(0, ok.size, N_SENTINEL_RANGES)])
        ranges = multi_ranges(rng, ok, N_MULTI, MULTI_R)
        lo_d, hi_d = (torch.from_numpy(a).to(dev) for a in (lo, hi))
        r_d = torch.from_numpy(ranges).to(dev)
        calls = scan_calls(store, lo_d, hi_d, r_d)
        tiers = {"sealed": [store.sealed.count, store.sealed.tombs],
                 "active": [store.delta.count, store.delta.tombs],
                 "dirty_rows": len(store._dirty_rows)}
        res, counted = run_store_scans(dev, store, calls)
        check(not store._dirty_rows, "the scan did not push the dirty rows")
        checked = check_store_scans(store, res, ok, ov, lo, hi, ranges)
        # the warm pass: the scan state is cached, still no sync
        _, warm = run_store_scans(dev, store, calls)
        states[state] = dict(checked, tiers_count_tombs=tiers,
                             first_pass=counted, warm_pass=warm)
    del res

    # ---- times on the second state, beside phase 7's immutable index
    times = {}
    for k, fn in calls.items():
        times[k] = {"ms": cuda_ms(fn, reps=5, warmup=1),
                    "immutable_ms": immutable.get(f"{k}_ms")}
    prof = device_profile(calls["scan_range"])
    prof["idle_share"] = 1 - prof["kernels_ms"] / times["scan_range"]["ms"]
    profs = {}
    for k in ("scan_range_materialize", "scan_groups_top_k"):
        profs[k] = device_profile(calls[k])
        profs[k]["idle_share"] = 1 - profs[k]["kernels_ms"] / times[k]["ms"]
    b = store.base
    aux_ms = host_ms(lambda: scan.build_page_aux(
        b.cnt, b.vals, np.int32, mask_value=TOMBSTONE,
        device=dev))
    views_ms = host_ms(lambda: [scan.tier_view(
        t.h_keys, t.h_vals, t.h_shadow, t.h_ss, t.h_tomb, dev)
        for t in (store.sealed, store.delta)])

    def first_scan_after_write():
        store.insert(ok[:1], ov[:1])          # an upsert: same state
        return store.scan_range(lo_d, hi_d)

    first_ms = host_ms(first_scan_after_write, reps=3)
    peak = torch.cuda.max_memory_allocated()

    # ---- kernels 3 and 4 on the store's own operands at stride lw_pad
    tile, P = b.tile, b.num_pages
    span_of = tiered._make_span_of(b.page_of_raw, b.dtype)
    plo, phi = span_of(lo_d, hi_d)
    g_cap = schedule.ladder_grid(2 * N_RANGES, tile, P)
    _, plan = schedule.span_scan_plan(plo, phi, tile, g_cap, P)
    real = torch.zeros(g_cap * tile, dtype=torch.bool, device=dev) \
        .index_fill_(0, plan.dest.long(), True)
    edges = groupby.group_edges(lo_d[:N_GROUP_RANGES], hi_d[:N_GROUP_RANGES],
                                N_GROUPS, np.int32).reshape(-1)
    e_cap = schedule.ladder_grid(edges.shape[0], tile, P)
    eplan = schedule.edge_scan_plan(b.page_of_raw(edges).int(), tile, e_cap,
                                    P)
    ereal = torch.zeros(e_cap * tile, dtype=torch.bool, device=dev) \
        .index_fill_(0, eplan.dest.long(), True)
    ok_d = torch.from_numpy(ok).to(dev)         # the live keys, sorted
    item_lo, item_hi = torch.cat([lo_d, lo_d]), torch.cat([hi_d, hi_d])
    launches = states["unfolded_tiers"]["warm_pass"]["mode_launches"]
    rows = {}
    for mode, key in (("count", "search_range"), ("sum", "scan_range_sum"),
                      ("full", "scan_range")):
        args, kw = capture_call(scan, "page_scan_bucketed", calls[key])
        check(kw.get("mask_value") == TOMBSTONE or mode == "count",
              "the store's scan kernel ran without the tombstone mask")
        lib = (lambda: (torch.searchsorted(ok_d, item_lo),
                        torch.searchsorted(ok_d, item_hi, right=True))) \
            if mode == "count" else None
        rows[f"page_scan_bucketed[{mode}]"] = kernel_row(
            "page_scan_bucketed", mode,
            launches["page_scan_bucketed"][mode], args, kw,
            ps.page_scan_plain, 2 * N_RANGES, real, 2, lib)
    for mode, key in (("count", "scan_groups_count"),
                      ("sum", "scan_groups_sum")):
        args, kw = capture_call(groupby, "page_prefix_bucketed", calls[key])
        lib = (lambda: torch.searchsorted(ok_d, edges)) \
            if mode == "count" else None
        rows[f"page_prefix_bucketed[{mode}]"] = kernel_row(
            "page_prefix_bucketed", mode,
            launches["page_prefix_bucketed"][mode], args, kw,
            ps.page_prefix_plain, edges.shape[0], ereal, 1, lib)
    check(all(r["max_abs_err"] == 0 for r in rows.values()), "a scan kernel "
          "disagrees with its plain version on the store's operands")
    check(all(int(r["grid"]) > 0 and r["steps_used"] > 0
              for r in rows.values()), "empty store kernel capture")
    summary = {
        "keys": int(ok.size), "num_pages": P, "lw_pad": b.lw_pad,
        "delta_capacity": store.delta.capacity, "states": states,
        "times": times, "profile_scan_range": prof,
        "profile_materialize_top_k": profs,
        "scan_aux_rebuild_ms": aux_ms, "tier_views_rebuild_ms": views_ms,
        "first_scan_after_write_ms": first_ms,
        "peak_memory_bytes": peak, "memory_before_bytes": mem0,
        "shape": {"ranges": N_RANGES, "sentinel_ranges": N_SENTINEL_RANGES,
                  "materialize": [N_MAT, MAT_K],
                  "group_ranges": N_GROUP_RANGES, "groups": N_GROUPS,
                  "top_k_ranges": N_TOPK_RANGES, "top_k": TOP_K,
                  "multi": [N_MULTI, MULTI_R]},
    }
    return summary, rows, ok, ov


# -------------------------------------------------------------- phase 12
def store_durability_path(dev, rng, holder: list, ok, ov, write_us: float):
    """Phase 12: save the 2^24-key store, a journaled write round, a
    simulated crash (the store dropped without close, the newest segment
    cut inside its last record), restore_index, then lookups and scans of
    the restored store against the oracle of the surviving writes.
    Returns the summary, the restored store (its journal closed) and that
    oracle (sorted live keys and their values)."""
    import gc
    import tempfile
    from repro_torch import IndexConfig
    from repro_torch.ckpt import journal
    from repro_torch.core import restore_index
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import page_search as pk
    store = holder.pop()                      # the last reference to it
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = store.save(d)
        save_ms = (time.perf_counter() - t0) * 1e3
        snap_bytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
        # a journaled round of phase 10's mix; the round's last record
        # (one delete) is the one the crash tears
        new_k = fresh_keys(rng, ok, I32.min + 1, I32.max - 1, STORE_NEW)
        pick = rng.choice(ok.size, STORE_UPSERTS + STORE_DELETES,
                          replace=False)
        up_k, del_k = ok[pick[:STORE_UPSERTS]], ok[pick[STORE_UPSERTS:]]
        ins_k = rng.permutation(np.concatenate([new_k, up_k]))
        ins_v = rng.integers(I32.min + 1, I32.max, ins_k.size,
                             dtype=np.int64).astype(np.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.insert(ins_k, ins_v)
        store.delete(del_k[:-1])
        torch.cuda.synchronize()
        journaled_us = (time.perf_counter() - t0) * 1e6 \
            / (ins_k.size + del_k.size - 1)
        store.delete(del_k[-1:])
        ok, ov = store_oracle_write(ok, ov, ins_k, ins_v, del_k[:-1])
        # the journal's own share: the same records appended to a file
        # that is no segment (replay reads journal_*.log only)
        side = journal.Journal(os.path.join(d, "append_timing.log"),
                               np.int32)
        t0 = time.perf_counter()
        side.append_many(ins_k, ins_v)
        side.append_many(del_k, np.zeros(del_k.size, np.int32), delete=True)
        side.flush()
        append_us = (time.perf_counter() - t0) * 1e6 \
            / (ins_k.size + del_k.size)
        side.close()
        seg = journal.scan_dir(d)[-1][1]
        seg_bytes = os.path.getsize(seg)
        del store                             # no close: a crash
        gc.collect()
        torch.cuda.empty_cache()
        with open(seg, "r+b") as f:           # cut inside the last record
            f.truncate(seg_bytes - journal.RECORD.size // 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = restore_index(d, IndexConfig(kind="tiered", mutable=True))
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        replayed = got.stats["journal_replayed"]
        check(replayed == ins_k.size + del_k.size - 1,
              f"replayed {replayed} records")
        check(got.n == ok.size, f"restored n {got.n} != {ok.size}")
        # 2^20 lookups (half resident, a quarter written, a quarter
        # misses, the torn delete's key among them) and a scan batch
        written = np.concatenate([ins_k, del_k])
        q = rng.permutation(np.concatenate([
            ok[rng.integers(0, ok.size, N_QUERIES // 2)],
            written[rng.integers(0, written.size, N_QUERIES // 4 - 1)],
            del_k[-1:],
            rng.integers(I32.min + 1, I32.max - 1, N_QUERIES // 4,
                         dtype=np.int64).astype(np.int32)]))
        q_dev = torch.from_numpy(q).to(dev)
        lo, hi = scan_ranges(rng, ok, N_RANGES)
        lo_d, hi_d = (torch.from_numpy(a).to(dev) for a in (lo, hi))
        got.lookup(q_dev)                     # first lookup after restore
        torch.cuda.synchronize()
        pk.page_search_bucketed.launches = 0
        kk.kary_search_levels.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = got.lookup(q_dev)
            scan_res = got.scan_range(lo_d, hi_d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = {"page_search_bucketed": pk.page_search_bucketed.launches,
                    "kary_search_levels": kk.kary_search_levels.launches}
        check(launches == {"page_search_bucketed": 1,
                           "kary_search_levels": 2},
              f"restored store launches {launches}")
        pos = np.minimum(np.searchsorted(ok, q), ok.size - 1)
        want_found = ok[pos] == q
        found = res.found.cpu().numpy()
        check(np.array_equal(found, want_found), "restored store: found")
        check(np.array_equal(res.values.cpu().numpy()[found],
                             ov[pos][found]), "restored store: values")
        check(bool(found[q == del_k[-1]].all()), "the torn delete applied")
        cs = np.zeros(ok.size + 1, np.int64)
        cs[1:] = np.cumsum(ov.astype(np.int64))
        r_lo, r_hi, cnt, vsum = range_oracle(ok, cs, lo, hi)
        same(scan_res.count, cnt, "restored scan count")
        same(scan_res.r_lo, r_lo, "restored scan r_lo")
        same(scan_res.vsum, vsum, "restored scan vsum")
        got.close()                           # the journal; still readable
        return {"save_ms": save_ms, "snapshot_bytes": snap_bytes,
                "journal_us_per_write": journaled_us,
                "phase10_us_per_write": write_us,
                "journal_append_us_per_write": append_us,
                "journaled_writes": int(ins_k.size + del_k.size),
                "segment_bytes": seg_bytes, "restore_ms": restore_ms,
                "journal_replayed": replayed, "restored_n": int(got.n),
                "restored_pages": got.base.num_pages,
                "lookups": N_QUERIES, "hits": int(found.sum()),
                "scan_ranges": N_RANGES, "launches": launches}, got, ok, ov
    finally:
        shutil.rmtree(d, ignore_errors=True)


# -------------------------------------------------------------- phase 13
# 13a: the probe queue over phase 12's restored store (phase 10's store
# after one more journaled round) and over phase 4's immutable index: four
# tenants weighted 1, 1, 2 and 4, capacity 2^16, a share cap of one half,
# the adaptive deadline on and no timer thread; 256 submits of 4,096
# queries each (2^20 in all, half hits), interleaved across the tenants.
QUEUE_TENANTS = {"t0": 1.0, "t1": 1.0, "t2": 2.0, "t3": 4.0}
QUEUE_SUBMITS, QUEUE_SUBMIT_Q = 256, 4096
QUEUE_CAPACITY = 1 << 16
QUEUE_TIMED_REPS = 8


def queue_submits(rng, keys: np.ndarray) -> list:
    """QUEUE_SUBMITS host arrays of QUEUE_SUBMIT_Q int32 queries, half
    drawn from `keys`, half uniform."""
    half = QUEUE_SUBMIT_Q // 2
    return [rng.permutation(np.concatenate([
        keys[rng.integers(0, keys.size, half)],
        rng.integers(I32.min + 1, I32.max - 1, half, dtype=np.int64
                     ).astype(np.int32)])) for _ in range(QUEUE_SUBMITS)]


def make_probe_queue(index, **kw):
    from repro_torch.engine.queue import MicroBatchQueue, index_probe_fn
    q = MicroBatchQueue(index_probe_fn(index), capacity=QUEUE_CAPACITY,
                        max_share=0.5, adaptive_deadline=True, timer=False,
                        record_flushes=True, path="probe", **kw)
    for t, w in QUEUE_TENANTS.items():
        q.set_tenant_weight(t, w)
    return q


def probe_queue_run(dev, rng, index, keys, check_host, what: str) -> dict:
    """The counted run of 13a on one index: the launch counters set to 0
    before, read after; submits, flushes, the results' slices and the
    last feedback drain under sync-debug "error"; every caller's result
    against a direct lookup of its own queries (bit for bit) and against
    numpy (`check_host(queries, result)`); half the queries come from
    `keys`. Then the host µs a submit, the
    CUDA-event ms of the submit that fills 2^16 queries and flushes them,
    the same lookup, upload and admission plan alone, and one profiled
    flush."""
    from repro_torch.core.util import upload_async
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import page_search as pk
    subs = queue_submits(rng, keys)
    names = list(QUEUE_TENANTS)
    pk.page_search_bucketed.launches = kk.kary_search_levels.launches = 0
    index.lookup(torch.from_numpy(subs[0]).to(dev))
    per_lookup = {"page_search_bucketed": pk.page_search_bucketed.launches,
                  "kary_search_levels": kk.kary_search_levels.launches}
    q = make_probe_queue(index)
    torch.cuda.synchronize()
    trajectory = [q.flush_at]
    pk.page_search_bucketed.launches = kk.kary_search_levels.launches = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        futs = []
        for i, sub in enumerate(subs):
            futs.append(q.submit(sub, tenant=names[i % len(names)]))
            if q.flush_at != trajectory[-1]:
                trajectory.append(q.flush_at)
        q.flush()
        results = [f.result() for f in futs]
        q.drain_feedback()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"page_search_bucketed": pk.page_search_bucketed.launches,
                "kary_search_levels": kk.kary_search_levels.launches}
    st = q.stats
    check(st.flushes > 0 and all(v > 0 for v in per_lookup.values()) and all(
        launches[k] == st.flushes * per_lookup[k] for k in launches),
        f"{what}: {launches} launches in {st.flushes} flushes, "
        f"{per_lookup} a lookup")
    check(sum(e["total"] for e in q.flush_log) == QUEUE_SUBMITS
          * QUEUE_SUBMIT_Q, f"{what}: queries lost or duplicated")
    for sub, res in zip(subs, results):
        direct = index.lookup(torch.from_numpy(sub).to(dev))
        for name in ("rank", "found", "values"):
            check(torch.equal(getattr(res, name), getattr(direct, name)),
                  f"{what}: a caller's {name} != a direct lookup")
        check_host(sub, res)
    total = st.queries
    share = {t: st.tenants[t].admitted / total for t in names}

    # ---- times: fill 2^16 queries (16 submits), the last one flushes
    tq = make_probe_queue(index, min_flush=QUEUE_CAPACITY, adapt=False)
    batch = subs[:QUEUE_CAPACITY // QUEUE_SUBMIT_Q]
    submit_us, flush_ms = [], []

    def fill():
        for i, sub in enumerate(batch[:-1]):
            tq.submit(sub, tenant=names[i % len(names)])
        return tq.submit(batch[-1], tenant=names[-1])

    fill().result()
    torch.cuda.synchronize()
    for _ in range(QUEUE_TIMED_REPS):
        for i, sub in enumerate(batch[:-1]):
            t0 = time.perf_counter()
            tq.submit(sub, tenant=names[i % len(names)])
            submit_us.append((time.perf_counter() - t0) * 1e6)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tq.submit(batch[-1], tenant=names[-1])
        end.record()
        end.synchronize()
        flush_ms.append(start.elapsed_time(end))
    check(tq.stats.flushes == QUEUE_TIMED_REPS + 1
          and tq.stats.max_batch == QUEUE_CAPACITY,
          f"{what}: the timed queue flushed {tq.stats.flushes} times")
    joined = np.concatenate(batch)
    q_dev = torch.from_numpy(joined).to(dev)
    lanes = {t: [QUEUE_SUBMIT_Q] * (len(batch) // len(names)) for t in names}
    plan_us = []
    for _ in range(9):                       # the flush's admission plan
        policy = make_probe_queue(index).admission
        t0 = time.perf_counter()
        policy.plan(lanes)
        plan_us.append((time.perf_counter() - t0) * 1e6)
    prof = device_profile(lambda: fill().result())
    flush_med = float(np.median(flush_ms))
    prof["idle_share"] = 1 - prof["kernels_ms"] / flush_med
    return {
        "queries": total, "flushes": st.flushes, "mean_batch": st.mean_batch,
        "max_batch": st.max_batch, "capped_flushes": st.capped_flushes,
        "reasons": {r: getattr(st, f"{r}_flushes") for r in
                    ("capacity", "deadline", "demand", "manual")},
        "admitted_share": share,
        "deferred": {t: st.tenants[t].deferred for t in names},
        "flush_at_trajectory": trajectory,
        "mean_occupancy": st.mean_occupancy,
        "launches": launches, "launches_per_lookup": per_lookup,
        "counted_run_s": wall_s,
        "submit_us_median": float(np.median(submit_us)),
        "flush_ms_median": flush_med, "flush_ms": flush_ms,
        "lookup_2e16_ms": cuda_ms(lambda: index.lookup(q_dev)),
        "upload_concat_2e16_ms": cuda_ms(
            lambda: upload_async(np.concatenate(batch), dev)),
        "admission_plan_2e16_us": float(np.median(plan_us)),
        "launches_per_flush": prof["kernel_launches"],
        "profile_flush": prof,
    }


def probe_queue_path(dev, rng, store, ok, ov, index, keys_sorted,
                     values_sorted) -> dict:
    """13a on the restored mutable store and on the immutable index."""
    def store_host(sub, res):
        pos = np.minimum(np.searchsorted(ok, sub), ok.size - 1)
        found = res.found.cpu().numpy()
        check(np.array_equal(found, ok[pos] == sub), "queue: found")
        check(np.array_equal(res.values.cpu().numpy()[found],
                             ov[pos][found]), "queue: values")

    def index_host(sub, res):
        check_lookup(res, oracle(keys_sorted, values_sorted, sub),
                     "queue over the immutable index")

    out = {"mutable_store": probe_queue_run(dev, rng, store, ok, store_host,
                                            "mutable store"),
           "immutable_index": probe_queue_run(dev, rng, index, keys_sorted,
                                              index_host, "immutable index")}
    out["store_pages"] = store.base.num_pages
    out["store_keys"] = int(store.n)
    return out


def decode_queue_path(dev, seed: int, phase9: dict):
    """13b: phase 9's serving at full width, two rounds of 32 sampled
    steps, inline, through the decode queue, and through it with four
    tenants; the tokens equal the inline run's bit for bit (the same
    generator seed) and each run launches the CDF kernel once a step.
    Then one decode step of each kind timed in turns in CUDA events,
    profiled, and the tenant step under sync-debug "error". Returns the
    summary and the tenant run's registry."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import cdf_search as cs
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import transformer as T
    from repro_torch.serve import SamplerConfig, ServeEngine
    from repro_torch.serve import sampler as S
    cfg = get_config(SERVE_ARCH)
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    scfg = SamplerConfig(temperature=TEMPERATURE, top_p=TOP_P)
    prompts = make_prompts(cfg.vocab)
    tenants = [f"t{i}" for i in range(4)] * 2
    steps = SERVE_STEPS * SERVE_ROUNDS
    runs, out, queues = {}, {}, {}
    for name, batching, tn in (("inline", False, None),
                               ("queue", True, None),
                               ("tenants", True, tenants)):
        with obs.use_registry() as reg:
            eng = ServeEngine(cfg, params, max_len=256, page_size=16,
                              decode_batching=batching, sampler=scfg)
            gen = torch.Generator(dev).manual_seed(seed)
            cs.cdf_search.launches = 0
            toks = [eng.generate(prompts, SERVE_STEPS, generator=gen,
                                 tenants=tn) for _ in range(SERVE_ROUNDS)]
            torch.cuda.synchronize()
            launches = cs.cdf_search.launches
            st = eng.stats
            runs[name] = torch.cat(toks, dim=1)
            out[name] = {
                "cdf_launches": launches,
                "engine_decode_ms_per_step": st.decode_s / steps * 1e3,
                "probe_batches": st.probe_batches,
                "decode_flushes": st.decode_flushes,
                "decode_occupancy": st.decode_occupancy,
                "tenants": {f"{p}:{t}": [r.submits, r.queries, r.flushes,
                                         r.admitted, r.deferred]
                            for (p, t), r in st.tenants.items()},
                "reuse": [st.prefill_tokens, st.reused_tokens]}
            check(launches == steps, f"decode {name}: {launches} cdf_search "
                  f"launches in {steps} steps")
            if batching:
                check(st.decode_flushes == steps and st.probe_batches == 1,
                      f"decode {name}: {st.decode_flushes} decode flushes, "
                      f"{st.probe_batches} probe flushes")
                queues[name] = eng.decode_queue()
        if name == "tenants":
            tenant_reg = reg
    for name in ("queue", "tenants"):
        check(torch.equal(runs[name], runs["inline"]), f"decode {name}: "
              "tokens differ from the inline sampler's")

    # one decode step of each kind, on the batch prefill of the prompts
    tok8 = torch.from_numpy(np.stack(prompts).astype(np.int32)).to(dev)
    lg8, cache = T.prefill(cfg, params, tok8, max_len=256,
                           compute_dtype=torch.float32)
    gen = torch.Generator(dev).manual_seed(seed)

    def stepper(kind):
        def step():
            if kind == "inline":
                nxt = S.sample(lg8, scfg, generator=gen)
            else:
                nxt = S.sample_queued(
                    lg8, scfg, queues[kind], generator=gen,
                    tenants=tenants if kind == "tenants" else None)
            return T.decode_step(cfg, params, nxt, cache,
                                 compute_dtype=torch.float32)
        return step

    torch.cuda.synchronize()
    cs.cdf_search.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        stepper("tenants")()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(cs.cdf_search.launches == 1, "a queued step with tenants "
          f"launched cdf_search {cs.cdf_search.launches} times")
    step_ms = {k: [] for k in ("inline", "queue", "tenants")}
    for kind in ("inline", "queue", "tenants", "tenants", "queue",
                 "inline"):
        step_ms[kind].append(cuda_ms(stepper(kind), reps=9, warmup=2))
    profiles = {}
    for kind in step_ms:
        prof = device_profile(stepper(kind))
        prof["idle_share"] = 1 - prof["kernels_ms"] / min(step_ms[kind])
        profiles[kind] = prof
    summary = {"runs": out, "decode_step_ms": step_ms,
               "launches_per_step": {k: p["kernel_launches"]
                                     for k, p in profiles.items()},
               "profiles": profiles,
               "phase9_inline_decode_step_ms": phase9["decode_step_ms"],
               "phase9_engine_decode_ms_per_step":
                   phase9["engine_decode_ms_per_step"]}
    return summary, tenant_reg


def telemetry_path(dev, rng, index, keys_sorted, registry) -> dict:
    """13c: the tenant run's registry scraped over HTTP on 127.0.0.1 and
    parsed back; a trace of probe-queue flushes over the immutable index
    exported with the tracer enabled; phase 4's 2^20-query lookup timed
    with metrics off and on, in turns."""
    import tempfile
    import urllib.request
    from repro_torch import obs
    srv, port = obs.start_http_server(0, registry=registry)
    try:
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
    parsed = obs.parse_prometheus(body)
    for series in (("repro_queue_submits_total",
                    '{path="decode",tenant="t0"}'),
                   ("repro_queue_submits_total",
                    '{path="probe",tenant="t3"}'),
                   ("repro_queue_flushes_total",
                    '{path="decode",reason="demand"}'),
                   ("repro_engine_op_seconds_count", '{path="probe"}'),
                   ("repro_engine_op_seconds_count", '{path="decode"}')):
        check(series in parsed, f"scrape: no {series}")
    check(parsed[("repro_queue_flushes_total",
                  '{path="decode",reason="demand"}')]
          == SERVE_STEPS * SERVE_ROUNDS, "scrape: decode flushes")

    subs = queue_submits(rng, keys_sorted)[:8]
    tracer = obs.TRACER
    tracer.clear()
    tracer.enable()
    try:
        q = make_probe_queue(index)
        futs = [q.submit(s, tenant="t0") for s in subs]
        q.flush()
        [f.result() for f in futs]
    finally:
        tracer.disable()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="chip_smoke_trace_")
    os.close(fd)
    try:
        tracer.export(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    names = {e["name"] for e in doc["traceEvents"]}
    check({"queue.flush", "queue.dispatch", "tiered.search"} <= names,
          f"trace: spans {sorted(names)}")
    tracer.clear()

    q_dev = torch.from_numpy(rng.integers(
        I32.min + 1, I32.max - 1, N_QUERIES, dtype=np.int64
    ).astype(np.int32)).to(dev)
    lookup_ms = {"metrics_off": [], "metrics_on": []}
    try:
        for on in (False, True, True, False):
            obs.configure(metrics=on)
            lookup_ms["metrics_on" if on else "metrics_off"].append(
                cuda_ms(lambda: index.lookup(q_dev)))
    finally:
        obs.configure()
    return {"scrape_samples": len(parsed), "scrape_bytes": len(body),
            "trace_events": len(doc["traceEvents"]),
            "trace_spans": sorted(names), "lookup_ms": lookup_ms}


# -------------------------------------------------------------- phase 14
# Specialization (DESIGN.md §10): the index bound into CUDA graphs
# (engine/capture.py), beside the args posture on the same data and the
# same calls. The reference's §10.3 gate cells: tile x leaf_width.
GATE_TILES = (128, 256)
GATE_LEAF_WIDTHS = (None, 4096)          # None: the planner's 2048
SPEC_TIMED_REPS = 15
# Reps of each measured leg of the autotuner (its default is 8). The
# lookup p50s of a sweep's trials span about three sqrt-2 buckets on the
# card (host dispatch jitter, experiments/tune_verify_spread.py), and the
# median of 8 once moved two buckets between a sweep and its verify, so
# here the sweep and verify_profile take the median of 32 (the rule, 10%
# or one bucket, is unchanged).
TUNE_REPS = 32


class ReplayRecorder:
    """Inside the ``with``, every kernel call made while a CUDA graph is
    being captured keeps its operands and its output: the tensors a graph
    replay then reads and writes (they stay referenced, so the capture
    reuses none of their memory). Calls outside a capture pass through
    unrecorded. Patches the engine modules' kernel namespaces, not the
    kernel modules (their wrappers count launches on their own function
    objects)."""

    SITES = (("tiered", "_page", "page_search_bucketed"),
             ("tiered", "_kary", "kary_search_levels"),
             ("scan", "_pscan", "page_scan_bucketed"),
             ("groupby", "_pscan", "page_prefix_bucketed"))

    def __init__(self):
        self.calls = []
        self._saved = []

    def __enter__(self):
        import importlib
        for mod_name, attr, fn_name in self.SITES:
            mod = importlib.import_module(f"repro_torch.engine.{mod_name}")
            real = getattr(mod, attr)
            orig = getattr(real, fn_name)

            def record(*args, _orig=orig, _name=fn_name, **kw):
                out = _orig(*args, **kw)
                if torch.cuda.is_current_stream_capturing():
                    self.calls.append((_name, args, kw, out))
                return out

            self._saved.append((mod, attr, real))
            setattr(mod, attr, types.SimpleNamespace(
                **{**vars(real), fn_name: record}))
        return self

    def __exit__(self, *exc):
        for mod, attr, real in reversed(self._saved):
            setattr(mod, attr, real)
        self._saved = []
        return False


def replayed_kernels_vs_plain(calls, what: str) -> dict:
    """Each kernel recorded inside a capture, on the operands and with the
    output of the graph's last replay, against its plain version: the
    steps the plan used bit for bit (float sums to rtol 1e-4). Returns
    per kernel the calls checked and the largest error."""
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import page_scan as ps
    from repro_torch.kernels import page_search as pk
    plain = {"page_search_bucketed": (pk.page_search_plain, -1),
             "kary_search_levels": (kk.kary_search_plain, -1),
             "page_scan_bucketed": (ps.page_scan_plain, 2),
             "page_prefix_bucketed": (ps.page_prefix_plain, 1)}
    torch.cuda.synchronize()
    check(calls, f"{what}: no kernel was recorded inside a capture")
    out = {}
    for name, args, kw, got in calls:
        fn, sum_at = plain[name]
        steps = kw.get("steps_used")
        want = fn(*args, **{k: v for k, v in kw.items()
                            if k != "steps_used"})
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        used = int(steps) if steps is not None else got[0].shape[0]
        worst = {"max_abs_err": 0, "float_sum_rel_err": 0.0}
        compare_outputs(got, want, used, sum_at,
                        f"{what}: {name} inside a replay", worst)
        row = out.setdefault(name, {"calls": 0, "max_abs_err": 0})
        row["calls"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], worst["max_abs_err"])
    return out


def reset_launches() -> list:
    from repro_torch.engine.capture import kernel_wrappers
    ws = kernel_wrappers()
    for w in ws:
        w.launches = 0
        if hasattr(w, "mode_launches"):
            w.mode_launches = dict.fromkeys(w.mode_launches, 0)
    return ws


def read_launches(ws) -> dict:
    return {w.__name__: w.launches for w in ws if w.launches}


def same_fields(a, b, what: str) -> None:
    """Two results (a tensor, a tuple, a LookupResult or a scan result)
    equal field for field, bit for bit."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    if not isinstance(a, tuple):
        names = list(vars(b))
        a, b = ([getattr(x, f) for f in names] for x in (a, b))
    for i, (x, y) in enumerate(zip(a, b)):
        check((x is None) == (y is None), f"{what}: field {i} None-ness")
        if y is not None:
            check(x.dtype == y.dtype and torch.equal(x, y),
                  f"{what}: field {i} differs from the args posture")


def launch_profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler: the device kernels (count
    and summed time) and the host's launch calls by runtime API name (a
    graph replay is one cudaGraphLaunch)."""
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
    api = {e.key: e.count for e in events
           if e.key.startswith("cuda") and "Launch" in e.key
           or e.key in ("cudaMemcpyAsync", "cudaMemsetAsync")}
    return {"kernels_ms": sum(e.self_device_time_total for e in kernels)
            / 1e3, "device_kernels": sum(e.count for e in kernels),
            "host_launch_calls": api,
            "host_launches": sum(api.values())}


def in_turns(fns: dict, reps: int = SPEC_TIMED_REPS) -> dict:
    """CUDA-event ms of each callable, in turns a, b, b, a (two medians
    each)."""
    names = list(fns)
    order = names + names[::-1]
    out = {k: [] for k in names}
    for k in order:
        out[k].append(cuda_ms(fns[k], reps=reps, warmup=2))
    return out


def spec_frozen_path(dev, rng, args_idx, keys_sorted, values_sorted) -> dict:
    """14a: the frozen index built with specialize=True beside phase 4's
    args index: 2^20 lookups replayed from one graph, bit for bit with the
    args posture and numpy; the kernels inside the replay against their
    plain versions; ms in turns, launches, idle share, capture cost and
    memory; then the §10.3 gate cells."""
    from repro_torch import IndexConfig, build_index
    queries = rng.permutation(np.concatenate([
        keys_sorted[rng.integers(0, N_KEYS, N_QUERIES // 2)],
        rng.integers(I32.min + 1, I32.max - 1, N_QUERIES - N_QUERIES // 2
                     ).astype(np.int32)]))
    q_dev = torch.from_numpy(queries).to(dev)
    t0 = time.perf_counter()
    spec = build_index(keys_sorted, values_sorted,
                       IndexConfig(kind="tiered", specialize=True))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(spec.impl.num_pages == args_idx.impl.num_pages, "layouts differ")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()          # the capture empties the cache too
    memory0 = [torch.cuda.memory_reserved(), torch.cuda.memory_allocated()]
    with ReplayRecorder() as rec:
        t0 = time.perf_counter()
        first = spec.lookup(q_dev)
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
    memory1 = [torch.cuda.memory_reserved(), torch.cuda.memory_allocated()]
    kernels = replayed_kernels_vs_plain(rec.calls, "frozen lookup")
    want = args_idx.lookup(q_dev)
    same_fields(first, want, "frozen lookup (first call)")
    spec.search(q_dev)                        # captures the search graph
    torch.cuda.synchronize()
    ws = reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = spec.lookup(q_dev)
        ranks = spec.search(q_dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = read_launches(ws)
    torch.cuda.synchronize()
    check(launches == {"page_search_bucketed": 2, "kary_search_levels": 2},
          f"frozen replays: launches {launches}")
    same_fields(res, want, "frozen lookup")
    same_fields(ranks, args_idx.search(q_dev), "frozen search")
    check_lookup(res, oracle(keys_sorted, values_sorted, queries),
                 "frozen specialized lookup")
    # a later replay leaves an earlier result alone
    keep = res.rank.clone()
    spec.lookup(q_dev.flip(0).contiguous())
    check(torch.equal(res.rank, keep), "a replay changed an earlier result")
    times = in_turns({"args": lambda: args_idx.lookup(q_dev),
                      "spec": lambda: spec.lookup(q_dev)})
    search_times = in_turns({"args": lambda: args_idx.search(q_dev),
                             "spec": lambda: spec.search(q_dev)})
    prof = {k: launch_profile(fn) for k, fn in (
        ("args", lambda: args_idx.lookup(q_dev)),
        ("spec", lambda: spec.lookup(q_dev)))}
    for k, p in prof.items():
        p["idle_share"] = 1 - p["kernels_ms"] / min(times[k])
    return {"build_s": build_s, "capture_ms": capture_ms,
            "captures": spec.impl.captures.n,
            "memory_reserved_allocated_before": memory0,
            "memory_reserved_allocated_after": memory1,
            "replayed_kernels": kernels, "launches": launches,
            "lookup_ms": times, "search_ms": search_times,
            "profile": prof}, spec


def spec_gate(dev, rng, keys_sorted, values_sorted) -> dict:
    """The reference's §10.3 cells: for tile x leaf_width, the search
    dispatch of the args and the specialized index on the same 2^20
    queries, in turns; whether the specialized one is no slower than args
    by more than 10% in every cell and faster in one (a finding, not a
    gate here)."""
    from repro_torch import IndexConfig, build_index
    q_dev = torch.from_numpy(rng.permutation(np.concatenate([
        keys_sorted[rng.integers(0, N_KEYS, N_QUERIES // 2)],
        rng.integers(I32.min + 1, I32.max - 1, N_QUERIES - N_QUERIES // 2
                     ).astype(np.int32)]))).to(dev)
    cells = []
    for tile in GATE_TILES:
        for lw in GATE_LEAF_WIDTHS:
            pair = {s: build_index(keys_sorted, values_sorted, IndexConfig(
                kind="tiered", tile=tile, leaf_width=lw, specialize=s))
                for s in (False, True)}
            same_fields(pair[True].search(q_dev), pair[False].search(q_dev),
                        f"gate cell tile={tile} leaf_width={lw}")
            t = in_turns({"args": lambda: pair[False].search(q_dev),
                          "spec": lambda: pair[True].search(q_dev)})
            a, s = float(np.median(t["args"])), float(np.median(t["spec"]))
            cells.append({"tile": tile,
                          "leaf_width": pair[True].impl.leaf_width,
                          "num_pages": pair[True].impl.num_pages,
                          "args_ms": t["args"], "spec_ms": t["spec"],
                          "spec_over_args": s / a})
            del pair
    ratios = [c["spec_over_args"] for c in cells]
    return {"cells": cells,
            "holds": bool(max(ratios) <= 1.10 and min(ratios) < 1.0)}


def spec_scan_path(dev, rng, args_idx, spec_idx, ks) -> dict:
    """14b: phase 7's entry points at phase 7's shapes on the specialized
    index, bit for bit with the args posture; the kernels inside each
    replay against their plain versions; a counted run under sync-debug
    "error"; each entry's ms in turns."""
    lo, hi = scan_ranges(rng, ks, N_RANGES)
    ranges = multi_ranges(rng, ks, N_MULTI, MULTI_R)
    lo_d, hi_d = (torch.from_numpy(a).to(dev) for a in (lo, hi))
    r_d = torch.from_numpy(ranges).to(dev)
    calls = scan_calls(spec_idx, lo_d, hi_d, r_d)
    args_calls = scan_calls(args_idx, lo_d, hi_d, r_d)
    t0 = time.perf_counter()
    with ReplayRecorder() as rec:
        for fn in calls.values():               # one capture each
            fn()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    kernels = replayed_kernels_vs_plain(rec.calls, "specialized scans")
    ws = reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = {k: fn() for k, fn in calls.items()}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = read_launches(ws)
    mode_launches = {w.__name__: dict(w.mode_launches) for w in ws
                     if hasattr(w, "mode_launches")}
    torch.cuda.synchronize()
    check(all(v > 0 for m in mode_launches.values() for v in m.values())
          and launches.get("kary_search_levels", 0) > 0,
          f"specialized scans: launches {launches} {mode_launches}")
    for k, fn in args_calls.items():
        same_fields(res[k], fn(), f"specialized {k}")
    times = {}
    for k in calls:
        t = in_turns({"args": args_calls[k], "spec": calls[k]}, reps=7)
        times[k] = t
    prof = {k: launch_profile(fn) for k, fn in (
        ("args", args_calls["scan_range"]), ("spec", calls["scan_range"]))}
    for k, p in prof.items():
        p["idle_share"] = 1 - p["kernels_ms"] / min(times["scan_range"][k])
    return {"capture_s": capture_s, "captures": spec_idx.impl.captures.n,
            "replayed_kernels": kernels, "launches": launches,
            "mode_launches": mode_launches,
            "ms": times, "profile_scan_range": prof}


def spec_store_path(dev, rng, keys_sorted, values_sorted) -> tuple:
    """14c: phase 10's eight write rounds on a specialize=True store in
    lockstep with an args store over phase 4's 2^24 keys: lookups equal
    every round (and found / values equal numpy), the capture count rising
    at round 4's repack only; the kernels inside each capture's replay
    against their plain versions; then ms in turns and launches."""
    from repro_torch import IndexConfig, build_index
    stores = {s: build_index(keys_sorted, values_sorted, IndexConfig(
        kind="tiered", mutable=True, specialize=s)) for s in (False, True)}
    spec, args = stores[True], stores[False]
    ok, ov = keys_sorted, values_sorted
    rounds, kernels = [], {}
    reserved = []
    for r in range(STORE_ROUNDS):
        new_k = fresh_keys(rng, ok, I32.min + 1, I32.max - 1, STORE_NEW)
        pick = rng.choice(ok.size, STORE_UPSERTS + STORE_DELETES,
                          replace=False)
        up_k, del_k = ok[pick[:STORE_UPSERTS]], ok[pick[STORE_UPSERTS:]]
        ins_k = rng.permutation(np.concatenate([new_k, up_k]))
        ins_v = rng.integers(I32.min + 1, I32.max, ins_k.size,
                             dtype=np.int64).astype(np.int32)
        twin = spec._spec_fused
        for s in (args, spec):
            for h in (0, 1):
                ih = slice(h * ins_k.size // 2, (h + 1) * ins_k.size // 2)
                dh = slice(h * del_k.size // 2, (h + 1) * del_k.size // 2)
                s.insert(ins_k[ih], ins_v[ih])
                s.delete(del_k[dh])
            s.maintain()
        ok, ov = store_oracle_write(ok, ov, ins_k, ins_v, del_k)
        written = np.concatenate([ins_k, del_k])
        if r == STORE_SPLIT_ROUND:
            for s in (args, spec):
                s.flush()
            b = spec.base
            p = b.num_pages // 2
            split_k = fresh_keys(rng, ok, int(b.seps[p - 1]) + 1,
                                 int(b.seps[p]), STORE_SPLIT_KEYS)
            split_v = np.arange(split_k.size, dtype=np.int32)
            for s in (args, spec):
                s.insert(split_k, split_v)
                s.flush()
            ok, ov = store_oracle_write(ok, ov, split_k, split_v,
                                        split_k[:0])
            written = np.concatenate([written, split_k])
            check(spec.stats["splits"] > 0, "round 4 did not repack")
        check(spec.stats == args.stats, f"round {r}: stats differ")
        check((spec._spec_fused is twin) == (r != STORE_SPLIT_ROUND),
              f"round {r}: the twin was re-armed outside a repack")
        half, quarter = N_QUERIES // 2, N_QUERIES // 4
        q = rng.permutation(np.concatenate([
            ok[rng.integers(0, ok.size, half)],
            written[rng.integers(0, written.size, quarter)],
            rng.integers(I32.min + 1, I32.max - 1, quarter,
                         dtype=np.int64).astype(np.int32)]))
        q_dev = torch.from_numpy(q).to(dev)
        caps0 = spec.captures.n
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        with ReplayRecorder() as rec:
            spec.lookup(q_dev)                 # captures when re-armed
        if rec.calls:
            reserved.append([before, torch.cuda.memory_reserved()])
            for k, v in replayed_kernels_vs_plain(
                    rec.calls, f"store round {r}").items():
                row = kernels.setdefault(k, {"calls": 0, "max_abs_err": 0})
                row["calls"] += v["calls"]
                row["max_abs_err"] = max(row["max_abs_err"],
                                         v["max_abs_err"])
        torch.cuda.synchronize()
        ws = reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = spec.lookup(q_dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launches = read_launches(ws)
        check(launches == {"page_search_bucketed": 1,
                           "kary_search_levels": 1},
              f"round {r}: specialized store launches {launches}")
        same_fields(res, args.lookup(q_dev), f"store round {r}")
        pos = np.minimum(np.searchsorted(ok, q), ok.size - 1)
        found = res.found.cpu().numpy()
        check(np.array_equal(found, ok[pos] == q), f"round {r}: found")
        check(np.array_equal(res.values.cpu().numpy()[found],
                             ov[pos][found]), f"round {r}: values")
        rounds.append({"round": r, "captures": spec.captures.n,
                       "new_captures": spec.captures.n - caps0,
                       "num_pages": spec.base.num_pages,
                       "derives": spec.base.derives,
                       "merges": spec.stats["merges"],
                       "splits": spec.stats["splits"]})
    caps = [x["captures"] for x in rounds]
    check(caps[:STORE_SPLIT_ROUND] == [1] * STORE_SPLIT_ROUND
          and caps[STORE_SPLIT_ROUND:]
          == [2] * (STORE_ROUNDS - STORE_SPLIT_ROUND),
          f"captures by round {caps}: not only at round 4's repack")
    times = in_turns({"args": lambda: args.lookup(q_dev),
                      "spec": lambda: spec.lookup(q_dev)})
    prof = {k: launch_profile(fn) for k, fn in (
        ("args", lambda: args.lookup(q_dev)),
        ("spec", lambda: spec.lookup(q_dev)))}
    for k, p in prof.items():
        p["idle_share"] = 1 - p["kernels_ms"] / min(times[k])
    args.close()
    del args, stores
    return {"rounds": rounds, "replayed_kernels": kernels,
            "launches": launches,
            "memory_reserved_around_captures": reserved,
            "lookup_ms": times, "profile": prof}, spec, ok, ov


def spec_queue_path(dev, rng, store, ok, ov) -> dict:
    """14d: phase 13a's probe queue over the specialized store: a first
    pass captures each padded flush size; the second pass (the counted
    one, under sync-debug "error") captures nothing, and every caller's
    result equals a direct lookup of its queries and numpy; then the ms
    of the submit that fills and flushes 2^16 queries."""
    subs = queue_submits(rng, ok)
    names = list(QUEUE_TENANTS)
    caps0 = store.captures.n
    with ReplayRecorder() as rec:
        q = make_probe_queue(store)
        futs = [q.submit(s, tenant=names[i % len(names)])
                for i, s in enumerate(subs)]
        q.flush()
        [f.result() for f in futs]
    kernels = replayed_kernels_vs_plain(rec.calls, "probe-queue flushes")
    caps1 = store.captures.n
    torch.cuda.synchronize()
    q = make_probe_queue(store)
    ws = reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        futs = [q.submit(s, tenant=names[i % len(names)])
                for i, s in enumerate(subs)]
        q.flush()
        results = [f.result() for f in futs]
        q.drain_feedback()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = read_launches(ws)
    torch.cuda.synchronize()
    st = q.stats
    check(store.captures.n == caps1, "the counted pass captured again")
    check(launches.get("page_search_bucketed") == st.flushes,
          f"queue: {launches} launches in {st.flushes} flushes")
    for sub, res in zip(subs, results):
        pos = np.minimum(np.searchsorted(ok, sub), ok.size - 1)
        found = res.found.cpu().numpy()
        check(np.array_equal(found, ok[pos] == sub), "queue: found")
        check(np.array_equal(res.values.cpu().numpy()[found],
                             ov[pos][found]), "queue: values")
    for sub, res in zip(subs[:16], results[:16]):
        same_fields(res, store.lookup(torch.from_numpy(sub).to(dev)),
                    "queue caller vs a direct lookup")
    tq = make_probe_queue(store, min_flush=QUEUE_CAPACITY, adapt=False)
    batch = subs[:QUEUE_CAPACITY // QUEUE_SUBMIT_Q]

    def fill():
        for i, sub in enumerate(batch[:-1]):
            tq.submit(sub, tenant=names[i % len(names)])
        return tq.submit(batch[-1], tenant=names[-1])

    fill().result()
    torch.cuda.synchronize()
    flush_ms = []
    for _ in range(QUEUE_TIMED_REPS):
        for i, sub in enumerate(batch[:-1]):
            tq.submit(sub, tenant=names[i % len(names)])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tq.submit(batch[-1], tenant=names[-1])
        end.record()
        end.synchronize()
        flush_ms.append(start.elapsed_time(end))
    q_dev = torch.from_numpy(np.concatenate(batch)).to(dev)
    return {"flushes": st.flushes, "mean_batch": st.mean_batch,
            "flush_at_end": q.flush_at,
            "captures_first_pass": caps1 - caps0,
            "captures_counted_pass": store.captures.n - caps1,
            "replayed_kernels": kernels, "launches": launches,
            "flush_ms_median": float(np.median(flush_ms)),
            "flush_ms": flush_ms,
            "lookup_2e16_ms": cuda_ms(lambda: store.lookup(q_dev))}


def spec_autotune_path(dev) -> dict:
    """14e: the autotuner's smoke sweep at 2^24 keys and 2^16 queries into
    a temporary profile directory, then verify_profile, each leg
    measured TUNE_REPS times."""
    import tempfile
    from repro_torch.engine import schedule
    from repro_torch.tune import autotune, verify_profile
    prev = schedule.set_plan_thresholds()
    d = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        t0 = time.perf_counter()
        prof, path = autotune(smoke=True, n=N_KEYS, q_n=1 << 16,
                              reps=TUNE_REPS, profile_dir=d)
        tune_s = time.perf_counter() - t0
        v = verify_profile(prof, profile_dir=d, n=N_KEYS, q_n=1 << 16,
                           reps=TUNE_REPS)
    finally:
        schedule.set_plan_thresholds(**prev)
        shutil.rmtree(d, ignore_errors=True)
    check(v["ok"], f"verify_profile: {v}")
    return {"tune_s": tune_s, "knobs": prof.knobs,
            "device_kind": prof.device_kind, "backend": prof.backend,
            "objective": prof.objective,
            "trials": [{"knobs": t["knobs"], "score": t["score"],
                        **{p: t["objective"][p] for p in
                           ("lookup", "scan", "flush")}}
                       for t in prof.trials],
            "verify": v}


def kernel_resources() -> dict:
    """Registers, static shared memory, stack and spills of every kernel,
    as ptxas reported them at the build (-Xptxas -v), by source."""
    from repro_torch.kernels import _build
    out = {}
    for name in _build.sources():
        rows = _build.resource_usage(name)
        if rows and shutil.which("c++filt"):
            names = subprocess.run(
                ["c++filt"], input="\n".join(r["kernel"] for r in rows),
                capture_output=True, text=True, check=True).stdout.split("\n")
            for r, demangled in zip(rows, names):
                r["kernel"] = demangled.replace("(anonymous namespace)::", "")
        out[name] = rows
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--earlier-cdf", metavar="SRC",
                    help="the replaced CDF kernel's source, timed in "
                         "phase 8 beside the new one")
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
    started = start_earlier_cdf(args.earlier_cdf)   # beside phase 1
    try:
        _build.build()
    finally:
        earlier_cdf = earlier_cdf_fn(started)
    print(f"phase 1: built {_build.sources()} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print("phase 1: ptxas " + json.dumps(kernel_resources()), flush=True)

    print(f"phase 2: page kernel == plain, max_abs_err "
          f"{phase_page(dev, rng)}", flush=True)
    print(f"phase 3: k-ary kernel == plain, max_abs_err "
          f"{phase_kary(dev, rng)}", flush=True)
    rows, main, state = main_path(dev, rng)
    print("phase 4: main path " + json.dumps(main), flush=True)
    print("phase 5: coverage " + json.dumps(coverage(dev, rng)), flush=True)
    print("phase 6: scan kernels == plain " + json.dumps(
        phase_scan_kernels(dev, rng)), flush=True)
    scan_rows, scan_main = scan_path(dev, rng, *state)
    print("phase 7: scan path " + json.dumps(scan_main), flush=True)
    imm_idx, keys_sorted, values_sorted = state   # phases 10 and 13
    del state
    print("phase 8: cdf kernel == plain " + json.dumps(
        phase_cdf(dev, rng, earlier_cdf)), flush=True)
    cdf_row, serve_main = serve_path(dev, args.seed)
    print("phase 9: serve path " + json.dumps(serve_main), flush=True)
    store_main, store, ok, ov = store_path(dev, rng, keys_sorted,
                                           values_sorted, main["lookup_ms"])
    print("phase 10: mutable store " + json.dumps(store_main), flush=True)
    scan11, store_rows, ok, ov = store_scan_path(dev, rng, store, ok, ov,
                                                 scan_main)
    print("phase 11: store scans " + json.dumps(scan11), flush=True)
    holder = [store]
    del store
    durable, store, ok, ov = store_durability_path(
        dev, rng, holder, ok, ov, store_main["insert_us_per_op"])
    print("phase 12: durability " + json.dumps(durable), flush=True)
    probe13 = probe_queue_path(dev, rng, store, ok, ov, imm_idx, keys_sorted,
                               values_sorted)
    print("phase 13a: probe queue " + json.dumps(probe13), flush=True)
    decode13, tenant_reg = decode_queue_path(dev, args.seed, serve_main)
    print("phase 13b: decode queue " + json.dumps(decode13), flush=True)
    print("phase 13c: telemetry " + json.dumps(telemetry_path(
        dev, rng, imm_idx, keys_sorted, tenant_reg)), flush=True)
    del store
    frozen14, spec_idx = spec_frozen_path(dev, rng, imm_idx, keys_sorted,
                                          values_sorted)
    print("phase 14a: specialized lookup " + json.dumps(frozen14),
          flush=True)
    scan14 = spec_scan_path(dev, rng, imm_idx, spec_idx, keys_sorted)
    print("phase 14b: specialized scans " + json.dumps(scan14), flush=True)
    del spec_idx
    gate14 = spec_gate(dev, rng, keys_sorted, values_sorted)
    print("phase 14a: gate cells " + json.dumps(gate14), flush=True)
    store14, spec_store, sok, sov = spec_store_path(dev, rng, keys_sorted,
                                                    values_sorted)
    print("phase 14c: specialized store " + json.dumps(store14), flush=True)
    queue14 = spec_queue_path(dev, rng, spec_store, sok, sov)
    print("phase 14d: probe queue on it " + json.dumps(queue14), flush=True)
    spec_store.close()
    del spec_store
    print("phase 14e: autotune " + json.dumps(spec_autotune_path(dev)),
          flush=True)
    for row, key in zip(rows, ("page", "kary")):
        checks = store_main["kernel_checks"]
        row["store_launches_per_lookup"] = store_main["launches"][row["name"]]
        row["store_max_abs_err"] = max(c[f"{key}_max_abs_err"]
                                       for c in checks)
        row["store_ms_before_after_repack"] = [c[f"{key}_ms"] for c in checks]
        row["probe_queue_launches"] = {
            k: {"launches": v["launches"][row["name"]],
                "flushes": v["flushes"]}
            for k, v in probe13.items() if isinstance(v, dict)}
    for row in scan_rows:                # the store's scans (phase 11)
        st = store_rows[row["name"]]
        row["store"] = {k: st[k] for k in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "device_ms", "library_device_ms",
            "steps_used", "grid", "pages_touched", "items")}
    for row in rows:                     # inside graph replays (phase 14)
        n = row["name"]
        row["specialized"] = {
            "lookup_and_search_launches": frozen14["launches"][n],
            "store_lookup_launches": store14["launches"][n],
            "probe_queue_launches": queue14["launches"].get(n, 0),
            "probe_queue_flushes": queue14["flushes"],
            "max_abs_err_in_replays": max(
                d["replayed_kernels"].get(n, {"max_abs_err": 0})
                ["max_abs_err"] for d in (frozen14, store14, queue14))}
    for row in scan_rows:
        n, mode = row["name"].rstrip("]").split("[")
        row["specialized"] = {
            "launches": scan14["mode_launches"][n][mode],
            "max_abs_err_in_replays":
                scan14["replayed_kernels"][n]["max_abs_err"]}
    cdf_row["decode_queue_launches"] = {
        k: {"launches": v["cdf_launches"], "flushes": v["decode_flushes"]}
        for k, v in decode13["runs"].items() if k != "inline"}
    print(json.dumps({"kernels": rows + scan_rows + [cdf_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
