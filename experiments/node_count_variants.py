#!/usr/bin/env python3
"""Time the node step of the flat index kinds in several compositions on
the card.

    python3 experiments/node_count_variants.py [--queries 1048576] [--out F]

Every flat kind (css, kary, fast, the NitroGen css bottom) descends a
level by reading one row of ``w`` sorted keys a query and counting the
keys below the query. Over 2^24 sorted int32 keys (phase 4's recipe of
``chip_smoke.py``) and ``--queries`` queries (half hits), at css node
widths 16, 17, 128 and 129, this times one such step on the deepest directory
level in turns:

- ``index_sum``: the row by advanced indexing (``util.take_rows``), the
  count as ``(node < q).sum(-1, dtype=int32)``;
- ``select_sum``: the row by ``index_select``, the same count;
- ``index_searchsorted``: the row by advanced indexing, the count by a
  batched ``torch.searchsorted`` of each query in its own row (a binary
  search: the rows are sorted);
- ``index_int_sum``: the compare cast to int32 before the sum;
- ``addr_index_sum`` / ``addr_take_sum``: the reference's form, the
  ``[Q, w]`` addresses ``row * w + arange(w)`` gathered from the flat
  buffer by advanced indexing / ``torch.take``, the same count;
- ``gather_expand_sum`` / ``gather_expand_searchsorted``: the row by
  ``torch.gather`` with the row index expanded over the lanes (a stride-0
  view, no address tensor), then the sum or the batched searchsorted;
- ``probe_binary``: no row at all, a binary search in the row with one
  ``[Q]`` gather a step (``ceil(log2(w + 1))`` steps).

Each variant is checked against ``index_sum``. Then the whole css search
of the port under the profiler: device time by kernel. The last line of
the output is one JSON object; ``--out`` writes it to a file too.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def variants(flat: torch.Tensor, w: int, rows: torch.Tensor,
             q: torch.Tensor) -> dict:
    from repro_torch.core.util import take_rows
    two = flat.view(-1, w)

    def index_sum():
        return (take_rows(flat, w, rows) < q[:, None]).sum(
            -1, dtype=torch.int32)

    def select_sum():
        node = two.index_select(0, rows.long())
        return (node < q[:, None]).sum(-1, dtype=torch.int32)

    def index_searchsorted():
        node = take_rows(flat, w, rows)
        return torch.searchsorted(node, q[:, None], out_int32=True)[:, 0]

    def index_int_sum():
        return (take_rows(flat, w, rows) < q[:, None]).int().sum(-1)

    lanes = torch.arange(w, dtype=torch.int64, device=flat.device)

    def addr_index_sum():
        node = flat[rows.long()[:, None] * w + lanes]
        return (node < q[:, None]).sum(-1, dtype=torch.int32)

    def addr_take_sum():
        node = torch.take(flat, rows.long()[:, None] * w + lanes)
        return (node < q[:, None]).sum(-1, dtype=torch.int32)

    def gather_expand_sum():
        node = torch.gather(two, 0, rows.long()[:, None].expand(-1, w))
        return (node < q[:, None]).sum(-1, dtype=torch.int32)

    def gather_expand_searchsorted():
        node = torch.gather(two, 0, rows.long()[:, None].expand(-1, w))
        return torch.searchsorted(node, q[:, None], out_int32=True)[:, 0]

    def probe_binary():
        base = rows.long() * w
        lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
        size = w
        while size > 0:
            half = (size + 1) // 2
            probe = flat[base + lo + (half - 1)]
            lo = torch.where(probe < q, lo + half, lo)
            size -= half
        return lo.int()

    return {"index_sum": index_sum, "select_sum": select_sum,
            "index_searchsorted": index_searchsorted,
            "index_int_sum": index_int_sum, "addr_index_sum": addr_index_sum,
            "addr_take_sum": addr_take_sum,
            "gather_expand_sum": gather_expand_sum,
            "gather_expand_searchsorted": gather_expand_searchsorted,
            "probe_binary": probe_binary}


def main() -> int:
    import chip_smoke as cs
    from repro_torch import IndexConfig, build_index
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=1 << 20)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("node_count_variants: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = cs.N_KEYS
    keys = (cs.I32.min + 1 + np.arange(n, dtype=np.int64) * 255
            + rng.integers(0, 255, n)).astype(np.int32)
    q = cs.mixed_queries(rng, keys, args.queries)
    qd = torch.from_numpy(q).to(dev)
    out = {"device": smi, "keys": n, "queries": args.queries}
    for w in (16, 17, 128, 129):
        idx = build_index(keys, config=IndexConfig(kind="css", node_width=w))
        impl = idx.impl
        lvl = impl.depth - 1
        off = impl.level_offsets[lvl]
        n_rows = (impl.dir_keys.numel() - off) // w
        rows = torch.from_numpy(rng.integers(0, n_rows, args.queries)
                                .astype(np.int32)).to(dev) + off // w
        fns = variants(impl.dir_keys, w, rows, qd)
        want = fns["index_sum"]()
        res = {}
        for name, fn in fns.items():
            cs.check(torch.equal(fn().int(), want), f"{name} differs")
            res[name] = {"ms": [], "device_ms": cs.device_ms(fn, reps=5)}
        for name in list(fns) + list(fns)[::-1]:
            res[name]["ms"].append(cs.cuda_ms(fns[name], reps=10))
        res["search_profile"] = cs.device_profile(lambda: idx.search(qd),
                                                  top=10)
        res["search_ms"] = cs.cuda_ms(lambda: idx.search(qd), reps=10)
        out[f"css_w{w}"] = res
        print(json.dumps({f"css_w{w}": res}), flush=True)
        del idx, impl
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
