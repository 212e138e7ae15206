"""The port's mutable-store scans (``MutableIndex.scan_range``,
``search_range``, materialize, ``scan_groups``, ``scan_multi``) against
the reference's, bit for bit.

Each trace sends the same writes and folds to a reference store and a port
store and then the same scans: the reference runs its Pallas kernels in
interpret mode, the port the kernels' plain versions on the CPU. Every
field of every result must be equal bit for bit: values are int32 (sums
wrap mod 2^32), so no tolerance is needed, and none is used. Where a
bound is below the key sentinel, a numpy oracle of the live merged key set
checks the results besides; at ``hi == sentinel`` the port is held to the
reference only, which counts gap slots there (ROADMAP Queue 3 item 10).
The reference compiles a scan once a derive, mode and shape (1.5-3 s), so
the traces keep one query shape and reuse their stores. Also: the tier
terms from the sorted view against the reference's dense masks, and
port-only hypothesis traces against the oracle."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
import jax.numpy as jnp

import repro.core as ref_core
from repro.engine import scan as ref_scan
from repro.engine import groupby as ref_gb

import repro_torch.core as pt_core
from repro_torch.engine import groupby as pt_gb
from repro_torch.engine import scan as pt_scan

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
Q = 48                         # ranges a scan, fixed per trace
G, K_MAT, K_TOP = 8, 8, 3
SCAN_FIELDS = ("count", "r_lo", "r_hi_excl", "vsum", "vmin", "vmax",
               "ranks", "values", "overflow")
GROUP_FIELDS = ("count", "edges", "r_edge", "vsum", "vmin", "vmax",
                "topk_values", "topk_ranks", "overflow")


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype != bool else a


def same(want, got, fields, what):
    for f in fields:
        w, g = getattr(want, f, None), getattr(got, f, None)
        assert (w is None) == (g is None), f"{what}.{f}"
        if w is None:
            continue
        g = g.numpy()
        assert g.dtype == np.asarray(w).dtype, f"{what}.{f} dtype"
        np.testing.assert_array_equal(bits(g), bits(w),
                                      err_msg=f"{what}.{f}")


class Twin:
    """A reference store and a port store fed the same calls, and a dict
    oracle of the live (key -> value) pairs."""

    def __init__(self, keys, vals, dtype=np.int32, **cfg):
        keys = np.asarray(keys, dtype)
        cfg = dict(kind="tiered", mutable=True, **cfg)
        self.dtype = np.dtype(dtype)
        self.ref = ref_core.build_index(keys, vals,
                                        ref_core.IndexConfig(**cfg))
        self.pt = pt_core.build_index(keys, vals, pt_core.IndexConfig(**cfg),
                                      device="cpu")
        self.oracle = dict(zip(keys.tolist(), np.asarray(
            vals if vals is not None else np.arange(keys.size)).tolist()))

    def insert(self, ks, vs):
        ks, vs = np.asarray(ks, self.dtype), np.asarray(vs, np.int32)
        self.ref.insert(ks, vs)
        self.pt.insert(ks, vs)
        self.oracle.update(zip(ks.tolist(), vs.tolist()))

    def delete(self, ks):
        ks = np.asarray(ks, self.dtype)
        self.ref.delete(ks)
        self.pt.delete(ks)
        for k in ks.tolist():
            self.oracle.pop(k, None)

    def call(self, name):
        assert getattr(self.ref, name)() == getattr(self.pt, name)()

    def merged(self):
        mk = np.array(sorted(self.oracle), self.dtype)
        mv = np.array([self.oracle[k] for k in mk.tolist()], np.int32)
        return mk, mv

    def resident(self, rng, n):
        live = np.fromiter(self.oracle, self.dtype, len(self.oracle))
        return rng.choice(live, min(n, live.size), replace=False)

    # ------------------------------------------------------------ the scans
    def scan_range(self, lo, hi, **kw):
        want = self.ref.scan_range(lo, hi, **kw)
        got = self.pt.scan_range(torch.from_numpy(lo), torch.from_numpy(hi),
                                 **kw)
        same(want, got, SCAN_FIELDS, f"scan_range{kw}")
        return got

    def search_range(self, lo, hi):
        want = self.ref.search_range(lo, hi)
        got = self.pt.search_range(torch.from_numpy(lo),
                                   torch.from_numpy(hi))
        for w, g, f in zip(want, got, ("r_lo", "r_hi_excl", "count")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f)
        return got

    def scan_groups(self, lo, hi, **kw):
        want = self.ref.scan_groups(lo, hi, G, **kw)
        got = self.pt.scan_groups(torch.from_numpy(lo), torch.from_numpy(hi),
                                  G, **kw)
        same(want, got, GROUP_FIELDS, f"scan_groups{kw}")
        return got

    def scan_multi(self, ranges, op, **kw):
        want = self.ref.scan_multi(ranges, op=op, **kw)
        got = self.pt.scan_multi(torch.from_numpy(ranges), op=op, **kw)
        same(want, got, SCAN_FIELDS, f"scan_multi[{op}]")
        return got


# ------------------------------------------------------------ the oracle
def oracle_scan(mk, mv, lo, hi):
    r_lo = np.searchsorted(mk, lo, "left")
    r_hi = np.where(lo > hi, r_lo, np.searchsorted(mk, hi, "right"))
    cnt = r_hi - r_lo
    vsum = np.zeros(lo.size, np.int32)
    vmin = np.full(lo.size, I32.max, np.int32)
    vmax = np.full(lo.size, I32.min, np.int32)
    for i in range(lo.size):
        if cnt[i]:
            seg = mv[r_lo[i]:r_hi[i]]
            vsum[i] = seg.sum(dtype=np.int32)
            vmin[i], vmax[i] = seg.min(), seg.max()
    return r_lo, r_hi, cnt, vsum, vmin, vmax


def check_oracle(tw, lo, hi, r, rows):
    """The port's scan_range result against the oracle on ``rows``."""
    mk, mv = tw.merged()
    want = oracle_scan(mk, mv, lo[rows], hi[rows])
    for got, w, f in zip((r.r_lo, r.r_hi_excl, r.count, r.vsum, r.vmin,
                          r.vmax), want, ("r_lo", "r_hi", "count", "vsum",
                                          "vmin", "vmax")):
        np.testing.assert_array_equal(got.numpy()[rows], w, err_msg=f)


def ranges_for(tw, rng, n=Q):
    """Ranges from resident and written keys: points, short and long
    spans, inverted ones (lo > hi), whole-domain ones, and the last two
    with ``hi`` at the key sentinel."""
    mk, _ = tw.merged()
    a = mk[rng.integers(0, mk.size, n)]
    span = np.where(rng.random(n) < 0.5, rng.integers(0, 200, n),
                    rng.integers(0, 100_000, n))
    lo = a.astype(np.int64) - rng.integers(0, 50, n)
    hi = lo + span
    lo[:3] = [I32.min, a[0] + 1, a[1]]
    hi[:3] = [I32.max - 1, a[0] - 5, a[1]]
    lo[3::11], hi[3::11] = hi[3::11], lo[3::11] - 1       # inverted
    hi[-2:] = I32.max                                     # the sentinel
    lo[-1] = I32.min
    return lo.astype(np.int32), hi.astype(np.int32)


def multi_for(lo, hi, rng, R=4):
    """[Q/4, R, 2] ranges from the scan ranges (sentinel rows included)."""
    q = lo.size // R
    r = np.stack([lo[:q * R], hi[:q * R]], -1).reshape(q, R, 2)
    return r[rng.permutation(q)]


def all_scans(tw, rng, lo, hi, *, oracle=True, groups=True):
    """Every scan kind on both stores, bit for bit; the oracle on the
    rows whose hi is below the sentinel."""
    r = tw.scan_range(lo, hi)
    for aggs in (("count",), ("count", "sum")):
        tw.scan_range(lo, hi, aggs=aggs)
    tw.search_range(lo, hi)
    m = tw.scan_range(lo, hi, materialize=K_MAT)
    if oracle:
        rows = np.flatnonzero(hi < I32.max)
        check_oracle(tw, lo, hi, r, rows)
        mk, mv = tw.merged()
        w_lo, _, cnt, *_ = oracle_scan(mk, mv, lo, hi)
        for i in rows:
            k = min(int(cnt[i]), K_MAT)
            np.testing.assert_array_equal(m.values.numpy()[i, :k],
                                          mv[w_lo[i]:w_lo[i] + k])
            assert bool(m.overflow[i]) == (cnt[i] > K_MAT)
    if groups:
        for aggs in (("count",), ("count", "sum"), None):
            tw.scan_groups(lo, hi, aggs=aggs)
        tw.scan_groups(lo, hi, top_k=K_TOP)
        ranges = multi_for(lo, hi, rng)
        for op in ("union", "intersect"):
            tw.scan_multi(ranges, op)
    return r, m


def decode_addresses(tw, m, lo, hi):
    """Materialized slot addresses read back through the port's host
    arrays (base, then sealed, then active) give the merged keys in key
    order."""
    mk, _ = tw.merged()
    pt = tw.pt
    flat = np.concatenate([pt.base.keys.reshape(-1),
                           pt.sealed.h_keys.reshape(-1),
                           pt.delta.h_keys.reshape(-1)])
    w_lo = np.searchsorted(mk, lo, "left")
    cnt = m.count.numpy()
    for i in np.flatnonzero(hi < I32.max):
        k = min(int(cnt[i]), K_MAT)
        addr = m.ranks.numpy()[i, :k]
        np.testing.assert_array_equal(flat[addr], mk[w_lo[i]:w_lo[i] + k])


# ------------------------------------------------------------ the traces
@pytest.fixture(scope="module")
def paged():
    """An int32 store (capacity 32, leaf width 128) with values near the
    int32 limits, so that sums wrap."""
    rng = np.random.default_rng(3)
    init = np.unique(rng.integers(0, 300_000, 1500)).astype(np.int32)
    vals = rng.integers(I32.max - 2000, I32.max, init.size).astype(np.int32)
    vals[::2] = rng.integers(I32.min + 1, I32.min + 2000, vals[::2].size)
    return rng, Twin(init, vals, delta_capacity=32, leaf_width=128)


def test_scans_shadowed_upserts_tombstones_both_tiers(paged):
    """Shadowed upserts, deletes (tombstones in the active and sealed
    tiers, tombstone-synced base slots), re-inserted keys, and new keys,
    with the sealed tier unfolded: every scan kind against the reference
    and the oracle, ``hi`` at the sentinel included."""
    rng, tw = paged
    big = lambda n: rng.integers(I32.max - 5000, I32.max, n)  # noqa: E731
    tw.insert(rng.integers(0, 300_000, 30), big(30))          # new keys
    tw.insert(tw.resident(rng, 12), big(12))                  # shadows
    gone = tw.resident(rng, 10)
    tw.delete(np.concatenate([gone, [400_001, 400_003]]))     # + absent
    tw.insert(gone[:3], [7, 8, 9])                            # revived
    assert tw.pt.sealed.count > 0 and tw.pt.delta.tombs > 0
    assert tw.pt.stats["shadowed"] > 0 and tw.pt._dirty_rows
    lo, hi = ranges_for(tw, rng)
    r, m = all_scans(tw, rng, lo, hi)
    assert not tw.pt._dirty_rows                # the first scan pushed them
    decode_addresses(tw, m, lo, hi)
    assert r.vsum.numpy()[0] != np.int64(sum(tw.oracle.values()))  # wraps
    # the sentinel rows take the gap slots in, as the reference's do
    assert (r.count.numpy()[-2:] != oracle_scan(
        *tw.merged(), lo[-2:], hi[-2:])[2]).all()


def test_scans_after_folds_and_more_writes(paged):
    """A fold (page-local merges, dirty rows), then new writes on top:
    the scan state is rebuilt at the first scan after each mutation."""
    rng, tw = paged
    tw.call("maintain")
    lo, hi = ranges_for(tw, rng)
    all_scans(tw, rng, lo, hi, groups=False)
    tw.insert(tw.resident(rng, 20), rng.integers(-10**6, 10**6, 20))
    tw.delete(tw.resident(rng, 8))
    lo, hi = ranges_for(tw, rng)
    r, m = all_scans(tw, rng, lo, hi)
    decode_addresses(tw, m, lo, hi)
    assert tw.pt.stats["merges"] > 0 and tw.pt.n == len(tw.oracle)


def test_scans_across_a_repack(paged):
    """Crowding one page past its leaf width repacks the store (a new
    derive): the scan functions are rebuilt on the new pages."""
    rng, tw = paged
    tw.call("flush")
    b = tw.pt.base
    p = b.num_pages // 2
    lo_k, hi_k = int(b.seps[p - 1]) + 1, int(b.seps[p])
    crowd = np.setdiff1d(np.arange(lo_k, hi_k, dtype=np.int32),
                         np.fromiter(tw.oracle, np.int32))[:140]
    pages0, derives0 = b.num_pages, b.derives
    tw.insert(crowd, np.arange(crowd.size))
    tw.call("flush")
    assert tw.pt.base.derives > derives0 and tw.pt.base.num_pages != pages0
    tw.delete(tw.resident(rng, 5))
    lo, hi = ranges_for(tw, rng)
    tw.scan_range(lo, hi)
    m = tw.scan_range(lo, hi, materialize=K_MAT)
    decode_addresses(tw, m, lo, hi)


def test_scans_float32_keys():
    """float32 keys (negative, +-0.0, large magnitudes; +inf is the
    sentinel): scan_range, materialize and the grouped prefix path."""
    rng = np.random.default_rng(5)
    init = np.unique((rng.normal(size=900) * 1e4).astype(np.float32))
    init = np.concatenate([init, [np.float32(0.0), np.float32(-3e38)]])
    tw = Twin(np.unique(init), rng.integers(-10**6, 10**6,
                                            np.unique(init).size)
              .astype(np.int32), dtype=np.float32, delta_capacity=32,
              leaf_width=128)
    tw.insert((rng.normal(size=40) * 1e4).astype(np.float32),
              rng.integers(-10**6, 10**6, 40))
    tw.insert(np.asarray([-0.0], np.float32), [5])       # the 0.0 twin
    tw.delete(tw.resident(rng, 6))
    lo = (rng.normal(size=Q) * 1e4).astype(np.float32)
    hi = (lo + np.abs(rng.normal(size=Q)) * 5e3).astype(np.float32)
    # no bound whose successor is subnormal (hi = 0.0): XLA's CPU backend
    # flushes subnormals to zero in compares, the reference's answer there
    # is that artifact's
    lo[:4] = [-np.inf, 0.0, -0.0, 1.0]
    hi[:4] = [np.inf, 0.5, 2.0, -1.0]
    hi[-1] = np.inf
    r = tw.scan_range(lo, hi)
    tw.scan_range(lo, hi, aggs=("count",))
    tw.scan_range(lo, hi, materialize=K_MAT)
    tw.scan_groups(lo, hi, aggs=("count", "sum"))
    rows = np.flatnonzero(hi < np.inf)
    check_oracle(tw, lo, hi, r, rows)


def test_scans_delta_only_store():
    """A store with no base yet (every write in the delta tiers, sealed
    and active): the base-less scan family, every kind."""
    rng = np.random.default_rng(7)
    tw = Twin(np.empty(0, np.int32), None, delta_capacity=32)
    tw.insert(rng.integers(0, 5000, 40), rng.integers(-100, 100, 40))
    tw.insert(rng.integers(0, 5000, 20), rng.integers(-100, 100, 20))
    tw.delete(tw.resident(rng, 5))
    assert tw.pt.base is None and tw.pt.sealed.count > 0
    lo = rng.integers(-10, 5000, Q).astype(np.int32)
    hi = (lo + rng.integers(-100, 3000, Q)).astype(np.int32)
    hi[-1] = I32.max
    r = tw.scan_range(lo, hi)
    check_oracle(tw, lo, hi, r, np.flatnonzero(hi < I32.max))
    tw.search_range(lo, hi)
    tw.scan_range(lo, hi, materialize=K_MAT)
    tw.scan_range(lo, hi, materialize=80)            # K past 2 * capacity
    tw.scan_groups(lo, hi, aggs=None)
    tw.scan_groups(lo, hi, top_k=K_TOP)
    tw.scan_multi(multi_for(lo, hi, rng), "union")


def test_scans_delta_only_small_case():
    """The reference's delta-only example, on the port alone."""
    m = pt_core.build_index(None, None, pt_core.IndexConfig(
        kind="tiered", mutable=True, delta_capacity=64), device="cpu")
    m.insert(np.array([5, 1, 9, 3], np.int32),
             np.array([50, 10, 90, 30], np.int32))
    r = m.scan_range(np.array([1, 4, 9, 7], np.int32),
                     np.array([5, 2, 9, 3], np.int32))
    assert r.count.tolist() == [3, 0, 1, 0]
    assert r.vsum.tolist() == [90, 0, 90, 0]
    assert r.vmin.tolist() == [10, I32.max, 90, I32.max]
    assert r.r_lo.tolist() == [0, 2, 3, 3]


# ------------------------------------------------------- the tier terms
@pytest.mark.parametrize("hi_at_sentinel", [False, True])
def test_tier_terms_match_the_dense_masks(hi_at_sentinel):
    """One tier's terms from its sorted view equal the reference's
    [Q, capacity] masks: counts, corrections, wrapping sums, min / max
    and the below-lo pair, with gap slots, tombstones, sb and ss bits."""
    rng = np.random.default_rng(9)
    nn, w = 8, 16
    keys = np.full((nn, w), I32.max, np.int32)
    vals = np.zeros((nn, w), np.int32)
    occ = rng.random((nn, w)) < 0.6
    ks = np.sort(rng.choice(10_000, occ.sum(), replace=False)).astype(
        np.int32)
    keys[occ] = ks
    keys.sort(axis=1)
    vals[keys < I32.max] = rng.integers(I32.max - 100, I32.max,
                                        occ.sum())
    sb = (rng.random((nn, w)) < 0.3) & (keys < I32.max)
    ss = (rng.random((nn, w)) < 0.3) & (keys < I32.max) & ~sb
    tomb = (rng.random((nn, w)) < 0.2) & (keys < I32.max)
    lo = rng.integers(-10, 10_000, 64).astype(np.int32)
    hi = (lo + rng.integers(-50, 5_000, 64)).astype(np.int32)
    if hi_at_sentinel:
        hi[::2] = I32.max
    want = ref_scan._tier_terms(jnp.asarray(lo), jnp.asarray(hi),
                                *(jnp.asarray(a.reshape(-1)) for a in
                                  (keys, vals, sb, ss, tomb)))
    view = pt_scan.tier_view(keys, vals, sb, ss, tomb, "cpu")
    got = pt_scan._tier_terms(torch.from_numpy(lo), torch.from_numpy(hi),
                              view)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    e = np.concatenate([lo, hi, [I32.max]]).astype(np.int32)
    pwant = ref_gb._tier_prefix_terms(
        jnp.asarray(e), *(jnp.asarray(a.reshape(-1)) for a in
                          (keys, vals, sb, ss, tomb)))
    pgot = pt_gb._tier_prefix_terms(torch.from_numpy(e), view)
    for k in pwant:
        np.testing.assert_array_equal(pgot[k].numpy(), np.asarray(pwant[k]),
                                      err_msg=k)


def test_materialize_window_is_chunked_by_rows(monkeypatch):
    """A materialize in row chunks gives what one chunk gives."""
    rng = np.random.default_rng(13)
    keys = np.unique(rng.integers(0, 50_000, 800)).astype(np.int32)
    m = pt_core.build_index(keys, np.arange(keys.size, dtype=np.int32),
                            pt_core.IndexConfig(kind="tiered", mutable=True,
                                                delta_capacity=32,
                                                leaf_width=128),
                            device="cpu")
    m.insert(keys[:10], np.arange(10) + 5)
    m.delete(keys[20:25])
    lo = rng.integers(0, 50_000, 40).astype(np.int32)
    hi = lo + 3000
    whole = m.scan_range(lo, hi, materialize=K_MAT)
    monkeypatch.setattr(pt_scan, "_MAT_CHUNK_ELEMS", 300)  # 1 row a chunk
    parts = m.scan_range(lo, hi, materialize=K_MAT)
    for f in ("ranks", "values", "overflow", "count"):
        assert torch.equal(getattr(whole, f), getattr(parts, f)), f
    empty = m.scan_range(lo[:0], hi[:0], materialize=K_MAT)
    assert tuple(empty.ranks.shape) == (0, K_MAT)


# -------------------------------------------- port-only property traces
def _oracle_groups(mk, mv, lo, hi, G_):
    edges = pt_gb.group_edges_host(lo, hi, G_)
    r_edge = np.searchsorted(mk, edges.reshape(-1), "left").reshape(
        -1, G_ + 1)
    cs = np.zeros(mk.size + 1, np.int64)
    cs[1:] = np.cumsum(mv.astype(np.int64))
    vsum = ((np.diff(cs[r_edge], axis=1) & 0xFFFFFFFF).astype(np.uint32)
            .view(np.int32))
    return edges, r_edge, np.diff(r_edge, axis=1), vsum


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10_000), capacity=st.sampled_from([16, 64]))
def test_port_store_scans_match_oracle(seed, capacity):
    """Interleaved inserts (upsert-heavy batches: shadows), deletes and
    scans over the port's store, through merges and repacks: scan_range
    and scan_groups against the numpy oracle."""
    rng = np.random.default_rng(seed)
    n0 = int(rng.integers(0, 1200))
    init = np.unique(rng.integers(0, 30_000, n0)).astype(np.int32)
    vals = rng.integers(-1000, 1000, init.size).astype(np.int32)
    idx = pt_core.build_index(init, vals if init.size else None,
                              pt_core.IndexConfig(
                                  kind="tiered", mutable=True,
                                  delta_capacity=capacity, leaf_width=128),
                              device="cpu")
    ref = dict(zip(init.tolist(), vals.tolist()))
    for _ in range(int(rng.integers(2, 4))):
        size = int(rng.integers(1, 300))
        if ref and rng.random() < 0.4:
            pool = np.fromiter(ref, np.int32)
            ks = pool[rng.integers(0, pool.size, size)]
        else:
            ks = rng.integers(0, 30_000, size).astype(np.int32)
        vs = rng.integers(-1000, 1000, size).astype(np.int32)
        idx.insert(ks, vs)
        ref.update(zip(ks.tolist(), vs.tolist()))
        if rng.random() < 0.6:
            pool = np.fromiter(ref, np.int32)
            dk = pool[rng.integers(0, pool.size, min(30, pool.size))]
            idx.delete(dk)
            for k in dk.tolist():
                ref.pop(k, None)
        mk = np.array(sorted(ref), np.int32)
        mv = np.array([ref[k] for k in mk.tolist()], np.int32)
        q = int(rng.integers(1, 40))
        lo = rng.integers(-100, 30_100, q).astype(np.int32)
        hi = (lo + rng.integers(-200, 30_000, q)).astype(np.int32)
        r = idx.scan_range(lo, hi)
        want = oracle_scan(mk, mv, lo, hi)
        for got, w in zip((r.r_lo, r.r_hi_excl, r.count, r.vsum, r.vmin,
                           r.vmax), want):
            np.testing.assert_array_equal(got.numpy(), w)
        g = idx.scan_groups(lo, hi, 4, aggs=("count", "sum"))
        for got, w in zip((g.edges, g.r_edge, g.count, g.vsum),
                          _oracle_groups(mk, mv, lo, hi, 4)):
            np.testing.assert_array_equal(got.numpy(), w)
        assert idx.n == len(ref)


def test_scans_under_thread_maintenance_match_oracle():
    """maintenance="thread": a timer thread folds each sealed buffer
    (rewriting page rows in place) while the main thread scans. A fold
    does not change the live key set, so every scan_range, scan_groups
    and scan_multi must equal the oracle of the writes made so far,
    wherever the folds land."""
    rng = np.random.default_rng(41)
    init = np.arange(0, 6000, 2, dtype=np.int32)
    vals = rng.integers(-1000, 1000, init.size).astype(np.int32)
    idx = pt_core.build_index(init, vals, pt_core.IndexConfig(
        kind="tiered", mutable=True, delta_capacity=16, leaf_width=128,
        maintenance="thread", maintenance_interval_s=0.0005), device="cpu")
    ref = dict(zip(init.tolist(), vals.tolist()))
    lo = rng.integers(-10, 6000, 64).astype(np.int32)
    hi = (lo + rng.integers(0, 3000, 64)).astype(np.int32)
    ranges = np.stack([lo, hi], -1).reshape(16, 4, 2)
    try:
        for _ in range(12):
            ks = rng.integers(0, 6000, 24).astype(np.int32)
            vs = rng.integers(-1000, 1000, 24).astype(np.int32)
            idx.insert(ks, vs)
            ref.update(zip(ks.tolist(), vs.tolist()))
            dk = ks[:4] + 1
            idx.delete(dk)
            for k in dk.tolist():
                ref.pop(k, None)
            mk = np.array(sorted(ref), np.int32)
            mv = np.array([ref[k] for k in mk.tolist()], np.int32)
            want = oracle_scan(mk, mv, lo, hi)
            want_g = _oracle_groups(mk, mv, lo, hi, 4)
            cover = [np.isin(mk, np.concatenate([
                mk[(mk >= a) & (mk <= b)] for a, b in rs])) for rs in ranges]
            for _ in range(4):               # folds land between these
                r = idx.scan_range(lo, hi)
                for got, w in zip((r.r_lo, r.r_hi_excl, r.count, r.vsum,
                                   r.vmin, r.vmax), want):
                    np.testing.assert_array_equal(got.numpy(), w)
                g = idx.scan_groups(lo, hi, 4, aggs=("count", "sum"))
                for got, w in zip((g.edges, g.r_edge, g.count, g.vsum),
                                  want_g):
                    np.testing.assert_array_equal(got.numpy(), w)
                m = idx.scan_multi(ranges, op="union", aggs=("count",))
                np.testing.assert_array_equal(
                    m.count.numpy(), [int(c.sum()) for c in cover])
        assert idx.stats["maintains"] >= 1
    finally:
        idx.close()
