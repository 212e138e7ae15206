#!/usr/bin/env python3
"""The flat kinds' kernels (kernels/flat_search.py) at other lane groups,
timed on one card.

    python3 experiments/flat_variants.py [--out FILE]

Builds chip_smoke.py phase 15's flat indexes over 2^24 int32 keys (css
w128 and w16, kary w127, FAST w15 and w127 at page depth 2) and its
CSB+-tree over 2^20 of them (w 8), draws 2^20 queries (half hits), and
times each kernel's search under each rule for the lanes a query
(``flat_search.group_lanes``, patched for the run):

  port      the port's rule: a power of two near w / 4 (so that the
            kernel's four rounds of loads in flight cover a node), at
            most 4 lanes: a wider node takes several batches of rounds;
  quarter   the power of two near w / 4, at most a warp (w 128: 32);
  whole     the width rounded up to a power of two, at most a warp: a
            round covers a node, four times fewer queries in flight;
  capC      the quarter rule capped at C lanes (C = 2, 8, 16; 4 is the
            port's): C lanes a query keep 32 / C queries a warp in
            flight;

and css at intra="binary" (one thread a query, a lower bound in each
node and leaf block) beside them. Each search is held to the kind's plain
composition bit for bit first. Times are events around a CUDA graph of
20 back-to-back calls, divided by their number (median of 7 replays,
chip_smoke.graph_amortised_ms), in turns: each rule once, then
again in reverse order; torch.searchsorted over the same keys beside them.
The result is the last line of the output, with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
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
from repro_torch.core import CSBTree, css_tree, fast_tree, kary  # noqa: E402
from repro_torch.kernels import flat_search as fs  # noqa: E402

PORT = fs.group_lanes


def quarter(w: int) -> int:
    return min(32, 1 << max(-(-int(w) // fs.ROUNDS) - 1, 0).bit_length())


RULES = {
    "port": PORT,
    "quarter": quarter,
    "whole": lambda w: min(32, 1 << max(int(w) - 1, 0).bit_length()),
    **{f"cap{c}": (lambda w, c=c: min(c, quarter(w))) for c in (2, 8, 16)},
}
CONFIGS = (
    ("css_w128", css_tree, dict(node_width=128)),
    ("css_w16", css_tree, dict(node_width=16)),
    ("kary_w127", kary, dict(node_width=127)),
    ("fast_w15_pd2", fast_tree, dict(node_width=15, page_depth=2)),
    ("fast_w127_pd2", fast_tree, dict(node_width=127, page_depth=2)),
)
BINARY = (("css_w128_binary", dict(node_width=128, intra="binary")),
          ("css_w16_binary", dict(node_width=16, intra="binary")))


def timed_rules(search, plain) -> dict:
    """Each rule's graph-amortised ms, in turns (each once, then again in
    reverse order)."""
    want = plain()
    out = {k: [] for k in RULES}
    for name in [*RULES, *reversed(RULES)]:
        fs.group_lanes = RULES[name]
        cs.check(torch.equal(search(), want), f"{name}: kernel != plain")
        out[name].append(cs.graph_amortised_ms(search))
    fs.group_lanes = PORT
    return out


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
           "searchsorted_ms": cs.graph_amortised_ms(
               lambda: torch.searchsorted(ks, qd))}
    for name, mod, kw in CONFIGS:
        idx = mod.build(keys, **kw, device=dev)
        res[name] = timed_rules(lambda: mod.search(idx, qd),
                                lambda: mod.search_plain(idx, qd))
        print(name, json.dumps(res[name]), flush=True)
        del idx
        torch.cuda.empty_cache()
    for name, kw in BINARY:
        idx = css_tree.build(keys, **kw, device=dev)
        want = css_tree.search_plain(idx, qd)
        cs.check(torch.equal(css_tree.search(idx, qd), want),
                 f"{name}: kernel != plain")
        res[name] = [cs.graph_amortised_ms(lambda: css_tree.search(idx, qd))
                     for _ in range(2)]
        print(name, json.dumps(res[name]), flush=True)
        del idx
        torch.cuda.empty_cache()
    sub = np.sort(rng.choice(keys, cs.N_CSB_KEYS, replace=False))
    tree = CSBTree.build(sub, w=8)
    cq = torch.from_numpy(cs.mixed_queries(rng, sub, cs.N_QUERIES)).to(dev)
    snap = tree.snapshot()
    res["csb_w8"] = timed_rules(
        lambda: tree.search(cq),
        lambda: fs.csb_search_plain(cq, *snap[:3], root=tree.root,
                                    height=tree.height))
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
