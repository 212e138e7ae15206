#!/usr/bin/env python3
"""Time the mutable store's delta probe in two compositions on the card.

    python3 experiments/delta_probe_turns.py [--queries 1048576] [--out F]

Both compute ``engine/delta.py::probe_full`` over one full delta tier of
the store's default capacity (1,024 entries in 64 nodes of 16, a quarter
of them tombstones) for ``--queries`` int32 queries (half hits):

- ``literal``: the reference's jnp code word for word in torch — the node
  as the count of node maxima below the query (a [Q, 64] compare and a
  sum) and the node's rows by advanced indexing;
- ``port``: the port's probe — one ``torch.searchsorted`` over the whole
  buffer with its gap slots routed as their node's maximum, then three
  one-element gathers a query.

It checks that both give the same (hit, tomb, value), then times them in
turns (literal, port, port, literal, twice) by CUDA events (median of 15
calls after 3) and by the profiler's device time. The last line of the
output is one JSON object; ``--out`` writes it to a file too.
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


def literal_probe_full(q, d_keys, d_vals, d_tomb, d_seps):
    """``repro/engine/delta.py::probe_full`` transcribed op for op."""
    nn = d_seps.shape[0]
    j = (d_seps[None, :] < q[:, None]).sum(-1).clamp_max(nn - 1)
    row = d_keys[j]
    eq = row == q[:, None]
    hit = eq.any(-1)
    tomb = (eq & d_tomb[j]).any(-1)
    val = torch.where(eq, d_vals[j], 0).sum(-1, dtype=torch.int32)
    return hit, tomb, val


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("delta_probe_turns: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms, device_ms
    from repro_torch.engine import delta as D

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    buf = D.DeltaBuffer(1024, device=dev)
    keys = rng.choice(np.arange(-2**31 + 1, 2**31 - 1, 4099), 1024,
                      replace=False).astype(np.int32)
    for i, k in enumerate(keys.tolist()):
        buf.insert(k, i, tomb=i % 4 == 0)
    q = rng.permutation(np.concatenate([
        keys[rng.integers(0, keys.size, args.queries // 2)],
        rng.integers(-2**31 + 1, 2**31 - 1, args.queries - args.queries // 2,
                     dtype=np.int64).astype(np.int32)]))
    qd = torch.from_numpy(q).to(dev)
    dk, dv, ds = buf.device_state()
    dtb = buf.device_bits()[2]
    ops = (qd, dk, dv, dtb, ds)
    fns = {"literal": lambda: literal_probe_full(*ops),
           "port": lambda: D.probe_full(*ops)}
    for a, b in zip(fns["literal"](), fns["port"]()):
        if not torch.equal(a, b):
            raise AssertionError("the two compositions disagree")
    turns = []
    for name in ("literal", "port", "port", "literal") * 2:
        turns.append({"name": name, "ms": cuda_ms(fns[name]),
                      "device_ms": device_ms(fns[name])})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    line = json.dumps({"device": smi, "queries": args.queries,
                       "nodes": buf.nn, "node_width": buf.node_width,
                       "entries": buf.count, "turns": turns})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
