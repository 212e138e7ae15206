#!/usr/bin/env python3
"""The flat kinds' kernels of one checkout of the port, timed on the card.

    python3 experiments/flat_before_after.py --root DIR [--out FILE]

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
through build_index), csb_search (kernel 9) over 2^20 of the keys and NitroGen's
generated kernel (kernel 6, 3 levels of 3 separators, binary bottom) over
the 2^24. Every result is checked against numpy. Prints one JSON line
with the card's name and power limit (and writes it to FILE).
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
    tree = core.CSBTree.build(sub, w=8)
    cq = torch.from_numpy(cs.mixed_queries(rng, sub, cs.N_QUERIES)).to(dev)
    found = tree.search(cq)
    if not np.array_equal(found.cpu().numpy(), np.isin(cq.cpu().numpy(),
                                                        sub)):
        raise AssertionError("csb != np.isin")
    out["csb_w8_ms"] = cs.graph_amortised_ms(lambda: tree.search(cq))
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
