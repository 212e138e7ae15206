#!/usr/bin/env python3
"""The flat kinds' kernels of one checkout of the port, timed on the card.

    python3 experiments/flat_before_after.py --root DIR [--out FILE]
        [--run-starts]

Imports the port (DIR/src) and DIR/chip_smoke.py's timers from the
checkout DIR, so that two commits run the same measurements in one call:
unpack the earlier commit under a git-ignored directory (``git archive
COMMIT | tar -x -C build/parent``) and run both in turns (earlier, this,
this, earlier). Over 2^24 int32 keys (steps of 255 with a seeded jitter,
as experiments/flat_variants.py draws them) and 2^20 queries (half hits)
it measures, for each flat configuration of chip_smoke.py phase 15
(binary c1 / c8, css w128 / w16 with both intra-node searches, kary w127,
FAST w15 / w127 at page depth 2 and FAST's descent alone):

  * the index's device bytes (``torch.cuda.memory_allocated`` around the
    build) and build seconds;
  * the search's ms with every launch counted (events around a CUDA graph
    of 20 searches, divided by 20, median of 7: graph_amortised_ms), over
    the 2^20 queries (``ms``) and over their first 4,096 and 32,768
    (``ms_4096``, ``ms_32768``: batches too small to fill a persistent
    grid, as Figs. 5.1 / 5.3 and the stores send them);

and, beside them, torch.searchsorted over the same keys at each batch,
the css w128 lookup through build_index (CUDA-event ms: phase 15a's
``lookup_ms``), the wholesale fold of the css store (the default kind,
delta capacity 1,024: chip_smoke.py phase 16c's ``fold_ms``, here three
folds of a sealed delta of 1,024 fresh keys, each a rebuild of its base
through build_index), csb_search (kernel 9: chip_smoke.py phase 15a's
CSBTree over 2^20 of the keys, w 8, its build and 4,096 inserts of new
keys: ``insert_us`` a key, ``snapshot_upload_ms`` of the snapshot after
them, the search's graph_amortised_ms at 2^20, 32,768 and 4,096 queries)
and NitroGen's generated kernel (kernel 6, 3 levels of 3 separators,
binary bottom) over the 2^24; and phase 4's main path: the tiered
lookup of 2^20 queries over build_index's default tiered index of the
2^24 keys (``lookup_ms``, CUDA events; ``lookup_graph_ms``, every launch
counted), its device plan alone (``device_plan_ms``), the specialized
lookup's, and the lookup's heaviest kernels under torch.profiler with
the cummax events (ops and kernels) in it. Every result is checked
against numpy. Prints one JSON line with the card's name and power limit
(and writes it to FILE).

With --run-starts it also times, on the lookup's sorted page ids, three
ways to the run start of each one (the first index of its run), each
checked against the others: the running max of the run-start indices
(``torch.cummax``), the left search of the pages in themselves
(``torch.searchsorted``) and a hand-written CUDA pass (each element
gallops back to its run's first index, then bisects), built here with
nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SMALL = (4096, 32_768)
RUN_START_CU = r"""
#include <cuda_runtime.h>
// the first index of sp[i]'s run in the sorted sp: gallop back, bisect
__global__ void run_start(const int* __restrict__ sp, int n,
                          int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int v = sp[i];
  int hi = i, step = 1, lo = i - 1;      // sp[hi] == v; sp[lo] probed
  while (lo >= 0 && sp[lo] == v) {
    hi = lo;
    step <<= 1;
    lo = hi - step;
  }
  if (lo < -1) lo = -1;                  // sp[lo] < v, or lo before 0
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (sp[mid] == v) hi = mid; else lo = mid;
  }
  out[i] = hi;
}
extern "C" int run_start_launch(const void* sp, int n, void* out,
                                void* stream) {
  run_start<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sp), n, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


def profiled_events(fn) -> dict:
    """Every event of one call of ``fn`` under torch.profiler (its aten ops
    and device kernels), with its count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.device_type == DeviceType.CUDA)
            for e in prof.key_averages()}


def main_path(cs, keys, rng, dev) -> dict:
    """Phase 4's lookup over ``keys`` (build_index's default tiered index)
    and its device plan; returns the times, the profile and the sorted
    page ids the plan sorts (for --run-starts)."""
    import torch
    from repro_torch import IndexConfig, build_index
    from repro_torch.engine import schedule
    vals = rng.integers(-2**31, 2**31 - 1, keys.size).astype(np.int32)
    q = np.concatenate([rng.choice(keys, cs.N_QUERIES // 2),
                        rng.integers(-2**31 + 1, 2**31 - 1,
                                     cs.N_QUERIES // 2).astype(np.int32)])
    q = rng.permutation(q)
    qd = torch.from_numpy(q).to(dev)
    rank = np.searchsorted(keys, q).astype(np.int32)
    out = {}
    for spec in (False, True):
        idx = build_index(keys, vals, IndexConfig(kind="tiered",
                                                  specialize=spec))
        res = idx.lookup(qd)
        if not np.array_equal(res.rank.cpu().numpy(), rank):
            raise AssertionError(f"tiered lookup (specialize={spec}) "
                                 "!= np.searchsorted")
        tag = "spec_" if spec else ""
        out[tag + "lookup_ms"] = cs.cuda_ms(lambda: idx.lookup(qd))
        if spec:
            break
        out["lookup_graph_ms"] = cs.graph_amortised_ms(lambda: idx.lookup(qd))
        impl = idx.impl
        pids = impl.page_of(qd)
        g_cap = schedule.ladder_grid(cs.N_QUERIES, impl.tile, impl.num_pages)
        out["device_plan_ms"] = cs.cuda_ms(lambda: schedule.device_plan(
            pids, impl.tile, g_cap, impl.num_pages))
        out["device_plan_graph_ms"] = cs.graph_amortised_ms(
            lambda: schedule.device_plan(pids, impl.tile, g_cap,
                                         impl.num_pages))
        out["profile"] = cs.device_profile(lambda: idx.lookup(qd))
        events = profiled_events(lambda: idx.lookup(qd))
        out["kernels_a_lookup"] = sum(n for n, dev in events.values()
                                      if dev)
        out["cummax_events"] = {k: n for k, (n, _) in events.items()
                                if "cummax" in k.lower()}
        sp = torch.sort(pids).values
        del idx, impl
        torch.cuda.empty_cache()
    return out, sp


def run_starts(cs, sp) -> dict:
    """The three ways to each sorted page id's run start, timed (every
    launch counted) and checked against each other."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    src = _build.BUILD_DIR / "run_start_variant.cu"
    lib = src.with_suffix(".so")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(RUN_START_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).run_start_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    n = sp.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=sp.device)

    def by_cummax():
        new_run = torch.ones(n, dtype=torch.bool, device=sp.device)
        new_run[1:] = sp[1:] != sp[:-1]
        return torch.cummax(idx * new_run, dim=0).values

    def by_search():
        return torch.searchsorted(sp, sp, out_int32=True)

    def by_pass():
        out = torch.empty_like(sp)
        _build.check(fn(sp.data_ptr(), n, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream),
                     "run_start")
        return out

    want = by_cummax()
    out = {}
    for name, f in (("cummax", by_cummax), ("searchsorted", by_search),
                    ("hand_pass", by_pass)):
        if not torch.equal(f(), want):
            raise AssertionError(f"run starts by {name} != cummax's")
        out[name] = [cs.graph_amortised_ms(f) for _ in range(2)]
    out["runs"] = int(torch.unique_consecutive(sp).numel())
    return out
CONFIGS = (
    ("binary_c1", "sorted_array", dict(linear_cutoff=1)),
    ("binary_c8", "sorted_array", dict(linear_cutoff=8)),
    ("css_w128", "css_tree", dict(node_width=128)),
    ("css_w128_binary", "css_tree", dict(node_width=128, intra="binary")),
    ("css_w16", "css_tree", dict(node_width=16)),
    ("css_w16_binary", "css_tree", dict(node_width=16, intra="binary")),
    ("kary_w127", "kary", dict(node_width=127)),
    ("fast_w15_pd2", "fast_tree", dict(node_width=15, page_depth=2)),
    ("fast_w127_pd2", "fast_tree", dict(node_width=127, page_depth=2)),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the checkout to time")
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--run-starts", action="store_true",
                    help="also time the three ways to the plan's run starts")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    if not torch.cuda.is_available():
        print("flat_before_after: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import IndexConfig, build_index, core
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"root": args.root, "card": card}
    rng = np.random.default_rng(0)
    keys = (cs.I32.min + 1 + np.arange(cs.N_KEYS, dtype=np.int64) * 255
            + rng.integers(0, 255, cs.N_KEYS)).astype(np.int32)
    q = cs.mixed_queries(rng, keys, cs.N_QUERIES)
    want = np.searchsorted(keys, q).astype(np.int32)
    qd = torch.from_numpy(q).to(dev)
    ks = torch.from_numpy(keys).to(dev)
    out["searchsorted_ms"] = cs.graph_amortised_ms(
        lambda: torch.searchsorted(ks, qd))
    for q_n in SMALL:
        out[f"searchsorted_ms_{q_n}"] = cs.graph_amortised_ms(
            lambda: torch.searchsorted(ks, qd[:q_n]))

    def check(got, what):
        if not np.array_equal(got.cpu().numpy(), want[:got.shape[0]]):
            raise AssertionError(f"{what} != np.searchsorted")

    for name, mod_name, kw in CONFIGS:
        mod = getattr(core, mod_name)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        idx = mod.build(keys, **kw, device=dev)
        torch.cuda.synchronize()
        row = {"build_s": time.perf_counter() - t0,
               "device_bytes": torch.cuda.memory_allocated() - base}
        for q_n in (cs.N_QUERIES, *SMALL):
            qs, tag = qd[:q_n], "" if q_n == cs.N_QUERIES else f"_{q_n}"
            check(mod.search(idx, qs), f"{name} at {q_n}")
            row["ms" + tag] = cs.graph_amortised_ms(
                lambda: mod.search(idx, qs))
            if mod_name == "fast_tree":
                page = mod.leaf_page_of(idx, qs)
                if not torch.equal(page, mod.leaf_page_of_plain(idx, qs)):
                    raise AssertionError(f"{name} leaf_page_of != plain")
                row["leaf_page_of_ms" + tag] = cs.graph_amortised_ms(
                    lambda: mod.leaf_page_of(idx, qs))
        out[name] = row
        print(name, json.dumps(row), flush=True)
        del idx
        torch.cuda.empty_cache()

    vals = np.arange(keys.size, dtype=np.int32)
    idx = build_index(keys, vals, IndexConfig(kind="css"))
    res = idx.lookup(qd)
    check(res.rank, "css lookup")
    out["css_w128_lookup_ms"] = cs.cuda_ms(lambda: idx.lookup(qd))
    del idx
    store = build_index(keys, vals, IndexConfig(mutable=True,
                                                delta_capacity=1024))
    held, folds = keys, []
    for _ in range(3):            # a delta's worth and one: the last seals
        new = cs.fresh_keys(rng, held, cs.I32.min + 1, cs.I32.max - 1,
                            1024 + 1)
        store.insert(new, np.arange(new.size, dtype=np.int32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not store.maintain():
            raise AssertionError("the css store did not fold")
        torch.cuda.synchronize()
        folds.append((time.perf_counter() - t0) * 1e3)
        held = np.union1d(held, new)
    if not np.array_equal(store.lookup(qd).found.cpu().numpy(),
                          np.isin(q, held)):
        raise AssertionError("css store found != np.isin")
    out["css_store_fold_ms"] = folds
    store.close()
    del store
    ng = build_index(keys, config=IndexConfig(
        kind="nitrogen", levels=3, compiled_node_width=3, bottom="binary"))
    check(ng.search(qd), "nitrogen")
    out["nitrogen_binary_ms"] = cs.graph_amortised_ms(lambda: ng.search(qd))
    del ng
    torch.cuda.empty_cache()
    sub = np.sort(rng.choice(keys, cs.N_CSB_KEYS, replace=False))
    t0 = time.perf_counter()
    tree = core.CSBTree.build(sub, w=8)
    out["csb_build_s"] = time.perf_counter() - t0
    new = cs.fresh_keys(rng, sub, cs.I32.min + 1, cs.I32.max - 1,
                        cs.CSB_INSERTS)
    t0 = time.perf_counter()
    for k in new:
        if not tree.insert(k):
            raise AssertionError("a new key read as present")
    out["csb_insert_us"] = (time.perf_counter() - t0) * 1e6 / new.size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree.snapshot()
    torch.cuda.synchronize()
    out["csb_snapshot_upload_ms"] = (time.perf_counter() - t0) * 1e3
    held = np.union1d(sub, new)
    cq = torch.from_numpy(cs.mixed_queries(rng, held, cs.N_QUERIES)).to(dev)
    found = tree.search(cq)
    if not np.array_equal(found.cpu().numpy(), np.isin(cq.cpu().numpy(),
                                                        held)):
        raise AssertionError("csb != np.isin")
    out["csb_height"] = tree.height
    out["csb_w8_ms"] = cs.graph_amortised_ms(lambda: tree.search(cq))
    for q_n in SMALL:
        qs = cq[:q_n]
        out[f"csb_w8_ms_{q_n}"] = cs.graph_amortised_ms(
            lambda: tree.search(qs))
    del tree
    torch.cuda.empty_cache()
    out["main_path"], sp = main_path(cs, keys, rng, dev)
    print("main_path", json.dumps(out["main_path"]), flush=True)
    if args.run_starts:
        out["run_starts"] = run_starts(cs, sp)
        print("run_starts", json.dumps(out["run_starts"]), flush=True)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
