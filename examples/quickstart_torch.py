"""Quickstart of the PyTorch port: build every index structure over 1M keys
on the CUDA card, run a batch of point queries, verify them against numpy,
and print throughputs.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import IndexConfig, build_index
from repro_torch.core.util import resolve_device

CONFIGS = {
    "binary search (Alg 2.1)": IndexConfig(kind="binary", linear_cutoff=8),
    "CSS-tree (Alg 3.1)": IndexConfig(kind="css", node_width=128),
    "k-ary tree [SGL09]": IndexConfig(kind="kary", node_width=127),
    "FAST blocked [KCS+10]": IndexConfig(kind="fast", node_width=127,
                                         page_depth=2),
    "NitroGen compiled (Ch. 4)": IndexConfig(kind="nitrogen", levels=3,
                                             compiled_node_width=3),
    "tiered engine (DESIGN §4)": IndexConfig(kind="tiered"),
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device=None, n: int = 1_000_000, q: int = 8_192,
         reps: int = 5) -> dict:
    """Every kind over ``n`` keys and ``q`` queries (half hits, half
    misses) on ``device`` (default: the CUDA card); asserts each against
    ``np.searchsorted`` and returns {kind: build ms, ns a query, index
    bytes}."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 2**31 - 2, int(n * 1.1))
                     .astype(np.int32))[:n]
    values = np.arange(keys.size, dtype=np.int32) * 10
    queries = np.concatenate([keys[rng.integers(0, n, q // 2)],
                              rng.integers(0, 2**31 - 2, q - q // 2)
                              .astype(np.int32)])
    oracle = np.searchsorted(keys, queries, side="left").astype(np.int32)
    qd = torch.from_numpy(queries).to(device)

    print(f"{n:,} keys, {q:,} queries (half hits / half misses) "
          f"on {device}\n")
    out = {}
    for name, cfg in CONFIGS.items():
        t0 = time.perf_counter()
        idx = build_index(keys, values, cfg, device=device)
        _sync(device)
        build_s = time.perf_counter() - t0
        got = idx.search(qd).cpu().numpy()              # first call + check
        assert np.array_equal(got, oracle), name
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            idx.search(qd)
        _sync(device)
        q_ns = (time.perf_counter() - t0) / reps / q * 1e9
        res = idx.lookup(qd[:4])
        hit, val = bool(res.found[0]), int(res.values[0])
        assert hit and val == values[oracle[0]], name
        print(f"{name:28s} build {build_s*1e3:7.1f} ms   "
              f"{q_ns:8.1f} ns/query   index bytes {idx.tree_bytes:>10,}  "
              f"(sample hit={hit}, value={val})")
        out[cfg.kind] = {"build_ms": build_s * 1e3, "ns_per_query": q_ns,
                         "index_bytes": idx.tree_bytes}
    print("\nAll structures agree with np.searchsorted.")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
