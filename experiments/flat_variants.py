#!/usr/bin/env python3
"""The flat kinds' kernels (kernels/flat_search.py) at other stage budgets,
timed on one card.

    python3 experiments/flat_variants.py [--out FILE]

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

Each search is held to the kind's plain composition bit for bit first.
Times are events around a CUDA graph of 20 back-to-back calls, divided by
their number (median of 7 replays, chip_smoke.graph_amortised_ms), in
turns: each variant once, then again in reverse order; torch.searchsorted
over the same keys beside them, and csb_search (kernel 9, unchanged) at
its own rule. The result is the last line of the output, with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result line to this file")
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
    for name, kw in BINARY:
        idx = sorted_array.build(keys, **kw, device=dev)
        res[name] = variants(name, sorted_array, idx, qd,
                             lambda i: sorted_array.search(i, qd),
                             lambda i: sorted_array.search_plain(i, qd))
        print(name, json.dumps(res[name]), flush=True)
        del idx
        torch.cuda.empty_cache()
    for name, mod, kw in CONFIGS:
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
    cq = torch.from_numpy(cs.mixed_queries(rng, sub, cs.N_QUERIES)).to(dev)
    snap = tree.snapshot()
    want = fs.csb_search_plain(cq, *snap[:3], root=tree.root,
                               height=tree.height)
    cs.check(torch.equal(tree.search(cq), want), "csb: kernel != plain")
    res["csb_w8"] = [cs.graph_amortised_ms(lambda: tree.search(cq))
                     for _ in range(2)]
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
