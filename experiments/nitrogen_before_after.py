#!/usr/bin/env python3
"""The NitroGen paths of one checkout of the port, timed on the card.

    python3 experiments/nitrogen_before_after.py --root DIR [--parts abcdef]
        [--out FILE]

Imports the port (DIR/src) and DIR/chip_smoke.py's timers from the
checkout DIR, so that two commits run the same measurements in one call:
unpack the earlier commit under a git-ignored directory (``git archive
COMMIT | tar -x -C build/parent``) and run both, in turns (earlier, this,
this, earlier). On the card it measures, over seeded data:

  (a) the top descent of a tiered index over 32,768 keys (256 pages, a
      NitroGen top) at 4,096 and 2^20 queries: CUDA-event ms, the
      device's kernels and their summed ms (profiler), the ms of one
      CUDA-graph replay of the same descent;
  (b) NitroGen (3 levels of 3 separators; binary and css-16 bottoms)
      over 2^24 keys through build_index: build s, lookups of 2^20 and
      4,096 queries with and without specialize=True, each timed in turns;
  (c) Fig. 5.1's NitroGen variants at 16,384 keys: searches of 4,096 and
      2^20 uniform queries, event / device / graph ms;
  (d) a mutable tiered store of 20,000 keys (leaf width 128, ~209 pages):
      build s and the ms of 4 flushes that each repack one crowded page
      and derive a new top;
  (e) chip_smoke.py's phase 16d (qwen3-0.6b at full width served over a
      NitroGen prefix index, mutable and wholesale, beside the tiered
      store): prefill ms and decode ms a step of each;
  (f) the kernel alone on chip_smoke.py phase 21's indexes, one for each
      bottom and the tiered top (NitroGen-binary and -css16 over 2^24 int32
      keys, the vector bottom over 2^20 float32 keys in 256 blocks of
      4,096, the 256-page top of 32,768 keys): build s and nvcc's
      compile_s, and at 2^20 and 4,096 queries the ms of a search with
      every launch counted (events around a CUDA graph of 20 searches,
      divided by 20, median of 7) beside torch.searchsorted's over the
      same keys; the tiered index's lookup ms (events);
then prints one JSON line with the card's name and power limit (and
writes it to FILE). Every result is checked against numpy.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the checkout to time")
    ap.add_argument("--parts", default="abcdef",
                    help="the parts to run, of abcdef (default: all)")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    if not torch.cuda.is_available():
        print("nitrogen_before_after: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import IndexConfig, build_index
    from repro_torch.core import nitrogen
    from repro_torch.engine.capture import Captures, Specialized
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"root": args.root, "card": card}
    rng = np.random.default_rng(27)

    def timed(fn, qd, graph=True) -> dict:
        prof = cs.launch_profile(lambda: fn(qd))
        r = {"ms": cs.cuda_ms(lambda: fn(qd)),
             "device_kernels": prof["device_kernels"],
             "device_ms": cs.device_ms(lambda: fn(qd), reps=5)}
        if graph:
            spec = Specialized(fn, device=dev, captures=Captures())
            r["graph_ms"] = cs.cuda_ms(lambda: spec(qd))
        return r

    parts = set(args.parts)
    # (a) the 256-page top
    tk = rng.integers(cs.I32.min + 1, cs.I32.max - 1, 32_768
                      ).astype(np.int32)
    tidx = build_index(tk, config=IndexConfig(kind="tiered"))
    assert tidx.impl.top_kind == "nitrogen" and tidx.impl.num_pages == 256
    srt = np.sort(tk)
    out["top_256_pages"] = {}
    for n in (4096, 1 << 20) if "a" in parts else ():
        q = cs.mixed_queries(rng, srt, n)
        qd = torch.from_numpy(q).to(dev)
        pages = tidx.impl.page_of(qd).cpu().numpy()
        want = np.minimum(np.searchsorted(tidx.impl.seps.cpu().numpy(), q),
                          255)
        assert np.array_equal(pages, want), "top descent != numpy"
        out["top_256_pages"][str(n)] = timed(tidx.impl.page_of, qd)
    del tidx

    # (b) NitroGen over 2^24 keys, args and specialized
    keys = np.unique(rng.integers(cs.I32.min + 1, cs.I32.max - 1,
                                  int(cs.N_KEYS * 1.05)).astype(np.int32))
    keys = rng.permutation(keys)[:cs.N_KEYS]
    vals = rng.integers(-1000, 1000, keys.size).astype(np.int32)
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], vals[order]
    q = cs.mixed_queries(rng, ks, 1 << 20)
    want = cs.oracle(ks, vs, q)
    out["ng_2^24"] = {}
    for bottom in ("binary", "css") if "b" in parts else ():
        cfg = dict(kind="nitrogen", levels=3, compiled_node_width=3,
                   bottom=bottom, node_width=16)
        t0 = time.perf_counter()
        idx = build_index(keys, vals, IndexConfig(**cfg))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        spec = build_index(keys, vals, IndexConfig(**cfg, specialize=True))
        row = {"build_s": build_s}
        for n in (1 << 20, 4096):
            qd = torch.from_numpy(q[:n]).to(dev)
            for x in (idx, spec):
                res = x.lookup(qd)
                assert np.array_equal(res.rank.cpu().numpy(), want[0][:n])
                assert np.array_equal(res.values.cpu().numpy(),
                                      want[2][:n])
            row[str(n)] = cs.in_turns({"args": lambda: idx.lookup(qd),
                                       "spec": lambda: spec.lookup(qd)},
                                      reps=7)
            row[f"{n}_device_kernels"] = cs.launch_profile(
                lambda: idx.lookup(qd))["device_kernels"]
        out["ng_2^24"][bottom] = row
        del idx, spec
        torch.cuda.empty_cache()

    # (c) Fig. 5.1's NitroGen variants at 16,384 keys
    fk = np.unique(np.random.default_rng(7).integers(
        0, 2**31 - 2, int(16_384 * 1.1)).astype(np.int32))[:16_384]
    out["fig5_1_16384"] = {}
    for name, bottom in (("ng-binary", "binary"), ("ng-css", "css")) \
            if "c" in parts else ():
        idx = build_index(fk, config=IndexConfig(
            kind="nitrogen", levels=3, compiled_node_width=3, bottom=bottom,
            node_width=16))
        for n in (4096, 1 << 20):
            qs = cs.uniform_queries(0, 2**31 - 2, n)
            qd = torch.from_numpy(qs).to(dev)
            assert np.array_equal(idx.search(qd).cpu().numpy(),
                                  np.searchsorted(fk, qs))
            out["fig5_1_16384"][f"{name}/Q={n}"] = timed(idx.search, qd)

    # (d) a small store's repacks
    if "d" in parts:
        out["small_store"] = small_store(rng, dev, build_index, IndexConfig)
    # (e) phase 16d
    if "e" in parts:
        serve, _ = cs.flat_serve_path(dev, 0)
        out["phase_16d"] = {k: {f: v[f] for f in ("prefill_ms",
                                                  "decode_ms_per_step")}
                            for k, v in serve.items()}
    # (f) the kernel alone on each bottom and the tiered top
    if "f" in parts:
        fk, fq = cs.ng_float_keys(rng, cs.NG_FLOAT_KEYS)
        cases = (("ng_l3_binary_2^24", ks, dict(bottom="binary"), q, None),
                 ("ng_l3_css16_2^24", ks, dict(bottom="css"), q, None),
                 ("ng_l4_vector_f32_2^20", fk, dict(levels=4,
                                                    bottom="vector"), fq,
                  None),
                 ("tiered_top_32768", tk, None,
                  cs.mixed_queries(rng, srt, 1 << 20), 255))
        out["bottoms"] = {}
        for name, keys_, cfg, qs, clip in cases:
            t0 = time.perf_counter()
            if cfg is None:
                idx = build_index(keys_, np.arange(keys_.size,
                                                   dtype=np.int32),
                                  IndexConfig(kind="tiered"))
                impl = idx.impl.top
            else:
                idx = build_index(keys_, config=IndexConfig(**{
                    "kind": "nitrogen", "levels": 3,
                    "compiled_node_width": 3, "node_width": 16, **cfg}))
                impl = idx.impl
            torch.cuda.synchronize()
            row = {"build_s": time.perf_counter() - t0,
                   "compile_s": impl.kernel.compile_s}
            qd = torch.from_numpy(qs).to(dev)
            got = nitrogen.search(impl, qd, clip=clip).cpu().numpy()
            real = ~np.isnan(qs)
            want = np.searchsorted(impl.keys.cpu().numpy(), qs[real])
            assert np.array_equal(got[real], want if clip is None
                                  else np.minimum(want, clip)), name
            for n in (1 << 20, 4096):
                x = qd[:n].contiguous()
                row[str(n)] = {
                    "kernel_graph_ms": graph_ms(
                        lambda: nitrogen.search(impl, x, clip=clip)),
                    "searchsorted_graph_ms": graph_ms(
                        lambda: torch.searchsorted(impl.keys, x))}
            if cfg is None:
                row["lookup_ms"] = cs.cuda_ms(lambda: idx.lookup(qd))
            out["bottoms"][name] = row
            del idx, impl
            torch.cuda.empty_cache()
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


def graph_ms(fn, launches: int = 20, reps: int = 7) -> float:
    """Events around a CUDA graph of ``launches`` calls of ``fn``, divided
    by their number: the median of ``reps`` replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def small_store(rng, dev, build_index, IndexConfig) -> dict:
    """(d): a small store's build and 4 repacks, each deriving a new top."""
    import torch
    sk = np.unique(rng.integers(0, 10**8, 40_000).astype(np.int32))[:20_000]
    t0 = time.perf_counter()
    store = build_index(sk, sk, IndexConfig(
        kind="tiered", mutable=True, leaf_width=128, delta_capacity=1024))
    torch.cuda.synchronize()
    rep = {"build_s": time.perf_counter() - t0, "repack_ms": []}
    allk = sk
    for r in range(4):
        b = store.base
        p = b.num_pages // 3 + 17 * r
        free = np.setdiff1d(np.arange(b.seps[p - 1] + 1, b.seps[p] + 1,
                                      dtype=np.int64), allk)
        new = free[:: free.size // 64][:64].astype(np.int32)
        splits = store.stats["splits"]
        store.insert(new, new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.flush()
        torch.cuda.synchronize()
        rep["repack_ms"].append((time.perf_counter() - t0) * 1e3)
        assert store.stats["splits"] > splits
        allk = np.union1d(allk, new)
        res = store.lookup(torch.from_numpy(allk).to(dev))
        assert bool(res.found.all())
    rep["pages"] = store.base.num_pages
    store.close()
    return rep


if __name__ == "__main__":
    sys.exit(main())
