#!/usr/bin/env python3
"""The flat kinds' kernels (kernels/flat_search.py) at other stage budgets,
timed on one card.

    python3 experiments/flat_variants.py [--out FILE] [--only csb]

Builds chip_smoke.py phase 15's flat indexes over 2^24 int32 keys (binary
at cutoffs 1 and 8, css w128 and w16 with both intra-node searches, kary
w127, FAST w15 and w127 at page depth 2, FAST's descent alone) and its
CSB+-tree over 2^20 of them (w 8), draws 2^20 queries (half hits), and
times each kernel's search with its index's stage rebuilt at a budget of
B bytes (``flat_search.STAGE_BYTES``, patched for the build; flat_descent:
0, nothing staged, every level read in place, 4, 16 and 96 KB, the port's;
flat_binary: 0, 16, 48 and 96 KB). (The kernel's queries a thread and
lanes a query were chosen the same way, with instances since removed:
PERF.md §6.)

csb_search (kernel 9) over the CSB+-tree: its stage rebuilt at budgets
of 0, 16 KB, 96 KB and the port's 160 KB (``flat_search.csb_stage``,
``CSB_STAGE_BYTES``; 2^20
queries, the persistent grid; 4,096 and 32,768 queries read it in place),
and the blocks an SM its launch bounds ask for (``kCsbBlocks``: 1, 2 and
3, a register cap of 128, 64 and 42, each a build of csrc/flat_search.cu
with that constant, under build/variants/, called in place of the port's
library), at each batch. (Two and four queries a thread, and two lanes a
query, were tried the same way: PERF.md §6.) With --only csb only kernel
9 is timed.

Each search is held to the kind's plain composition bit for bit first.
Times are events around a CUDA graph of 20 back-to-back calls, divided by
their number (median of 7 replays, chip_smoke.graph_amortised_ms), in
turns: each variant once, then again in reverse order; torch.searchsorted
over the same keys beside them. The result is the last line of the
output, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import (CSBTree, css_tree, fast_tree, kary,  # noqa: E402
                              sorted_array)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flat_search as fs  # noqa: E402

BUDGETS = (0, 4 * 1024, 16 * 1024, 96 * 1024)
BINARY_BUDGETS = (0, 16 * 1024, 48 * 1024, 96 * 1024)
CONFIGS = (
    ("css_w128", css_tree, dict(node_width=128)),
    ("css_w128_binary", css_tree, dict(node_width=128, intra="binary")),
    ("css_w16", css_tree, dict(node_width=16)),
    ("css_w16_binary", css_tree, dict(node_width=16, intra="binary")),
    ("kary_w127", kary, dict(node_width=127)),
    ("fast_w15_pd2", fast_tree, dict(node_width=15, page_depth=2)),
    ("fast_w127_pd2", fast_tree, dict(node_width=127, page_depth=2)),
)
BINARY = (("binary_c1", dict(linear_cutoff=1)),
          ("binary_c8", dict(linear_cutoff=8)))
CSB_BUDGETS = (0, 16 * 1024, 96 * 1024, fs.CSB_STAGE_BYTES)
CSB_BLOCKS = (1, 2, 3)
CSB_LINE = "constexpr int kCsbBlocks = 1;"


def in_turns(names, setup, search, want) -> dict:
    """Each variant's graph-amortised ms, in turns (each once, then again
    in reverse order); ``setup(name)`` switches to a variant."""
    out = {k: [] for k in names}
    for name in [*names, *reversed(names)]:
        setup(name)
        cs.check(torch.equal(search(), want), f"{name}: kernel != plain")
        out[name].append(cs.graph_amortised_ms(search))
    return out


def restaged(mod, idx, budget: int):
    """``idx`` with its stage rebuilt at a budget of ``budget`` bytes."""
    port = fs.STAGE_BYTES
    fs.STAGE_BYTES = budget
    try:
        if mod is sorted_array:
            st = fs.binary_stage(idx.keys_pad, idx.n_pad, idx.linear_cutoff,
                                 device=idx.keys_pad.device)
        else:
            nodes = {css_tree: "dir_keys", kary: "tree",
                     fast_tree: "pages"}[mod]
            leaf = (idx.leaf_pad, idx.leaf_width) if mod is not kary \
                else ()
            st = fs.descent_stage(getattr(idx, nodes),
                                  mod.descent_args(idx), *leaf, n=idx.n,
                                  device=idx.keys.device)
    finally:
        fs.STAGE_BYTES = port
    return dataclasses.replace(idx, stage=st)


def variants(name, mod, idx, qd, search, plain) -> dict:
    """Each stage budget in turns."""
    want = plain(idx)
    budgets = BINARY_BUDGETS if mod is sorted_array else BUDGETS
    staged = {b: restaged(mod, idx, b) for b in budgets}
    cur = {}

    def use(v):
        cur["idx"] = staged[int(v)]
    res = {"ms": in_turns([str(b) for b in budgets], use,
                          lambda: search(cur["idx"]), want)}
    res["stage_levels"] = {
        str(b): getattr(s.stage, "levels", None) or getattr(
            s.stage, "stage_levels", 0) for b, s in staged.items()}
    return res


def csb_libraries() -> dict:
    """flat_search.cu built once for each count of CSB_BLOCKS (nvcc runs at
    once), loaded: {count: library}."""
    src = (_build.CSRC / "flat_search.cu").read_text()
    if CSB_LINE not in src:
        raise RuntimeError(f"{CSB_LINE!r} is not in flat_search.cu")
    out_dir = _build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i in CSB_BLOCKS:
        cu = out_dir / f"flat_search_csb_b{i}.cu"
        cu.write_text(src.replace(CSB_LINE,
                                  f"constexpr int kCsbBlocks = {i};"))
        procs[i] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for i, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"kCsbBlocks = {i}: nvcc failed\n{log}")
        libs[i] = ctypes.CDLL(str(so))
        so.with_suffix(".log").write_text(log)
    return libs


def csb_variants(tree, cq) -> dict:
    """Kernel 9 at each stage budget and each register cap."""
    snap = tree.snapshot()
    n = tree._n_nodes
    want = fs.csb_search_plain(cq, *snap[:3], root=tree.root,
                               height=tree.height)
    port = fs.CSB_STAGE_BYTES
    stages = {}
    for b in CSB_BUDGETS:
        fs.CSB_STAGE_BYTES = b
        try:
            stages[str(b)] = fs.csb_stage(tree.keys[:n], tree.child[:n],
                                          tree.root, tree.height,
                                          device=cq.device)
        finally:
            fs.CSB_STAGE_BYTES = port
    cur, res = {}, {}

    def search():
        return fs.csb_search(cq[:cur["q_n"]], *snap[:3], root=tree.root,
                             height=tree.height, stage=cur["stage"])

    for q_n in (cs.N_QUERIES, 4096, 32_768):
        cur["q_n"] = q_n

        def use(b):
            cur["stage"] = stages[b]
        res[f"budgets_{q_n}"] = in_turns(list(stages), use, search,
                                         want[:q_n])
    res["stage_levels"] = {b: s.levels for b, s in stages.items()}
    res["stage_bytes"] = {b: s.nbytes for b, s in stages.items()}
    libs = csb_libraries()
    real = fs._fn
    cur.update(q_n=cs.N_QUERIES, stage=tree.stage)

    def use_lib(i):
        lib = libs[int(i)]

        def fn(kernel, dtype):
            f = getattr(lib, f"{kernel}_{fs._SUFFIX[dtype]}")
            f.argtypes, f.restype = fs._ARGTYPES[kernel], ctypes.c_int
            return f
        fs._fn = fn
    try:
        for q_n in (cs.N_QUERIES, 4096, 32_768):
            cur["q_n"] = q_n
            res[f"blocks_{q_n}"] = in_turns([str(i) for i in CSB_BLOCKS],
                                            use_lib, search, want[:q_n])
    finally:
        fs._fn = real
    res["ptxas"] = {i: [r for r in _build.log_usage(
        _build.BUILD_DIR.parent / "variants" / f"flat_search_csb_b{i}.log")
        if "csb" in r["kernel"]] for i in CSB_BLOCKS}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result line to this file")
    ap.add_argument("--only", choices=["csb"],
                    help="time kernel 9 alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flat_variants: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    keys = (cs.I32.min + 1 + np.arange(cs.N_KEYS, dtype=np.int64) * 255
            + rng.integers(0, 255, cs.N_KEYS)).astype(np.int32)
    q = cs.mixed_queries(rng, keys, cs.N_QUERIES)
    qd = torch.from_numpy(q).to(dev)
    ks = torch.from_numpy(keys).to(dev)
    res = {"card": smi, "keys": cs.N_KEYS, "queries": cs.N_QUERIES,
           "STAGE_BYTES": fs.STAGE_BYTES,
           "searchsorted_ms": cs.graph_amortised_ms(
               lambda: torch.searchsorted(ks, qd))}
    for name, kw in BINARY if not args.only else ():
        idx = sorted_array.build(keys, **kw, device=dev)
        res[name] = variants(name, sorted_array, idx, qd,
                             lambda i: sorted_array.search(i, qd),
                             lambda i: sorted_array.search_plain(i, qd))
        print(name, json.dumps(res[name]), flush=True)
        del idx
        torch.cuda.empty_cache()
    for name, mod, kw in CONFIGS if not args.only else ():
        idx = mod.build(keys, **kw, device=dev)
        res[name] = variants(name, mod, idx, qd,
                             lambda i, mod=mod: mod.search(i, qd),
                             lambda i, mod=mod: mod.search_plain(i, qd))
        print(name, json.dumps(res[name]), flush=True)
        if mod is fast_tree:
            res[name + "_descent"] = variants(
                name, mod, idx, qd, lambda i: fast_tree.leaf_page_of(i, qd),
                lambda i: fast_tree.leaf_page_of_plain(i, qd))
            print(name + "_descent", json.dumps(res[name + "_descent"]),
                  flush=True)
        del idx
        torch.cuda.empty_cache()
    sub = np.sort(rng.choice(keys, cs.N_CSB_KEYS, replace=False))
    tree = CSBTree.build(sub, w=8)
    for k in cs.fresh_keys(rng, sub, cs.I32.min + 1, cs.I32.max - 1,
                           cs.CSB_INSERTS):
        tree.insert(k)
    cq = torch.from_numpy(cs.mixed_queries(rng, sub, cs.N_QUERIES)).to(dev)
    res["csb_w8"] = csb_variants(tree, cq)
    print("csb_w8", json.dumps(res["csb_w8"]), flush=True)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
