"""The port's mutable store (``repro_torch/engine/store.py``) against the
reference's (``repro/engine/store.py``).

Each trace sends the same writes, folds and lookups to both stores, the
reference's lookup running its Pallas kernels in interpret mode and the
port's the kernels' plain versions on the CPU. After every step the
lookup's ``rank`` (a slot address into the gapped pages), ``found`` and
``values`` must be equal bit for bit, and so must ``stats``, ``n``, the
host page arrays (``keys``, ``vals``, ``cnt``, ``seps``) and both delta
tiers' arrays. A dict oracle checks found / values besides. Query batches
keep one shape a trace, so the reference compiles its lookup once a
derive. Also: every page stays nondecreasing through merges, splits and
repacks (the page kernel's binary search needs it), a port-only property
test against a numpy oracle, and the unported surface."""
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref_core

import repro_torch.core as pt_core
from repro_torch.engine import store as pt_store
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels import page_search as pt_page

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
Q = 96                               # queries a lookup, fixed per trace
BASE_ARRAYS = ("keys", "vals", "cnt", "seps")
DELTA_ARRAYS = ("h_keys", "h_vals", "h_shadow", "h_ss", "h_tomb", "h_cnt",
                "node_max")


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype != bool else a


class Twin:
    """One reference store and one port store fed the same calls, and a
    dict oracle of the live (key -> value) pairs."""

    def __init__(self, keys, vals=None, dtype=np.int32, **cfg):
        keys = np.asarray(keys, dtype)
        cfg = dict(kind="tiered", mutable=True, **cfg)
        self.ref = ref_core.build_index(keys, vals,
                                        ref_core.IndexConfig(**cfg))
        self.pt = pt_core.build_index(keys, vals, pt_core.IndexConfig(**cfg),
                                      device="cpu")
        self.dtype = np.dtype(dtype)
        vals = np.arange(keys.size, dtype=np.int32) if vals is None else vals
        self.oracle = dict(zip(keys.tolist(), np.asarray(vals).tolist()))
        self.written = []
        self.check_state()

    def insert(self, ks, vs):
        ks, vs = np.asarray(ks, self.dtype), np.asarray(vs, np.int32)
        self.ref.insert(ks, vs)
        self.pt.insert(ks, vs)
        self.oracle.update(zip(ks.tolist(), vs.tolist()))
        self.written += ks.tolist()
        self.check_state()

    def delete(self, ks):
        ks = np.asarray(ks, self.dtype)
        self.ref.delete(ks)
        self.pt.delete(ks)
        for k in ks.tolist():
            self.oracle.pop(k, None)
        self.written += ks.tolist()
        self.check_state()

    def call(self, name):
        assert getattr(self.ref, name)() == getattr(self.pt, name)()
        self.check_state()

    def check_state(self):
        assert self.pt.stats == self.ref.stats
        assert list(self.pt.stats) == list(self.ref.stats)
        assert self.pt.n == self.ref.n == len(self.oracle)
        assert self.pt.tree_bytes == self.ref.tree_bytes
        for tier in ("delta", "sealed"):
            a, b = getattr(self.ref, tier), getattr(self.pt, tier)
            for name in DELTA_ARRAYS:
                np.testing.assert_array_equal(
                    bits(getattr(a, name)), bits(getattr(b, name)),
                    err_msg=f"{tier}.{name}")
            assert (a.count, a.tombs, a.respreads) == \
                (b.count, b.tombs, b.respreads)
        if self.ref.base is None:
            assert self.pt.base is None
            return
        rb, pb = self.ref.base, self.pt.base
        for name in BASE_ARRAYS:
            np.testing.assert_array_equal(bits(getattr(rb, name)),
                                          bits(getattr(pb, name)),
                                          err_msg=f"base.{name}")
        assert (rb.top_kind, rb.num_pages, rb.leaf_width, rb.lw_pad,
                rb.derives) == (pb.top_kind, pb.num_pages, pb.leaf_width,
                                pb.lw_pad, pb.derives)
        assert sorted(self.ref._dirty_rows) == sorted(self.pt._dirty_rows)
        # the device mirrors hold the host pages wherever no value was
        # host-synced since the rows were last written
        clean = np.setdiff1d(np.arange(pb.num_pages),
                             sorted(self.pt._dirty_rows))
        np.testing.assert_array_equal(pb.dev_keys.numpy(), pb.keys)
        np.testing.assert_array_equal(pb.dev_vals.numpy()[clean],
                                      pb.vals[clean])

    def queries(self, rng, extra=()):
        """Q queries: recent writes, resident keys, misses, the sentinel
        and ``extra``."""
        live = np.fromiter(self.oracle, self.dtype, len(self.oracle))
        pool = [np.asarray(self.written[-40:], self.dtype),
                rng.choice(live, min(live.size, 30)) if live.size else [],
                rng.integers(-1000, 250_000, 20),
                np.asarray(extra, self.dtype)]
        pool = np.concatenate([np.asarray(p, self.dtype) for p in pool])
        fixed = np.concatenate([[self.sentinel()], np.asarray(extra,
                                                              self.dtype)])
        rest = rng.choice(pool, Q - fixed.size)
        return np.concatenate([fixed, rest]).astype(self.dtype)

    def sentinel(self):
        return self.pt.delta.sentinel

    def lookup(self, rng, extra=()):
        q = self.queries(rng, extra)
        want = self.ref.lookup(q)
        got = self.pt.lookup(torch.from_numpy(q))
        for name in ("rank", "found", "values"):
            w, g = np.asarray(getattr(want, name)), getattr(got, name)
            assert g.dtype == torch.from_numpy(np.array(w)).dtype, name
            np.testing.assert_array_equal(bits(g.numpy()), bits(w),
                                          err_msg=name)
        found, vals = got.found.numpy(), got.values.numpy()
        for i, k in enumerate(q.tolist()):
            if k == self.sentinel() or k != k:
                continue                  # the sentinel quirk; NaN
            assert found[i] == (k in self.oracle), k
            if found[i]:
                assert vals[i] == self.oracle[k], k
        if self.dtype.kind == "f":
            assert not found[np.isnan(q)].any()
        return got


def resident(tw, rng, n):
    live = np.fromiter(tw.oracle, tw.dtype, len(tw.oracle))
    return rng.choice(live, n, replace=False)


def write_round(tw, rng, *, new=40, up=12, dele=10, revive=3):
    """One round: new keys, upserts and deletes of resident keys, deletes
    of absent keys, then deleted keys inserted again, each batch followed
    by a lookup."""
    ks = rng.integers(0, 200_000, new)
    tw.insert(ks, rng.integers(-10**6, 10**6, new))
    tw.lookup(rng)
    tw.insert(resident(tw, rng, up), rng.integers(-10**6, 10**6, up))
    gone = resident(tw, rng, dele)
    tw.delete(np.concatenate([gone, rng.integers(300_000, 400_000, 2)]))
    tw.lookup(rng, extra=gone[:4])
    tw.insert(gone[:revive], np.arange(revive) + 7)
    tw.lookup(rng, extra=gone[:revive])


# ------------------------------------------------------------ the traces
def test_trace_merges_split_recency_and_tombstones():
    """Deferred maintenance, capacity 32, leaf width 128: duplicate
    initial keys (last wins), page-local merges under backpressure,
    recency across active / sealed / base, deletes and re-inserts, a
    forced split and repack, and the sentinel query throughout."""
    rng = np.random.default_rng(11)
    init = rng.integers(0, 200_000, 1200).astype(np.int32)
    init[100:110] = init[:10]                        # duplicates: last wins
    vals = rng.integers(-10**6, 10**6, init.size).astype(np.int32)
    tw = Twin(init, vals, delta_capacity=32, leaf_width=128)
    assert tw.pt.base.top_kind == "nitrogen"
    assert len(tw.oracle) == tw.pt.n < init.size
    for r in range(4):
        write_round(tw, rng)
        if r % 2:
            tw.call("maintain")
            tw.lookup(rng)
    assert tw.pt.stats["merges"] > 0 and tw.pt.stats["seals"] > 2
    # recency: one base key with a value in the sealed and active tiers
    k = resident(tw, rng, 1)
    tw.call("flush")
    tw.insert(k, [101])
    tw.insert(np.arange(500_000, 500_032), np.arange(32))  # full: seals
    assert tw.pt.sealed.find(k[0]) is not None
    tw.insert(k, [102])
    assert tw.pt.delta.find(k[0]) is not None
    assert tw.lookup(rng, extra=k).values[1] == 102
    tw.delete(k)
    assert not tw.lookup(rng, extra=k).found[1]
    tw.insert(k, [103])
    tw.call("flush")
    assert tw.lookup(rng, extra=k).values[1] == 103
    # forced split: overflow one full page by its own key range
    base = tw.pt.base
    p = 1 + int(np.argmax(base.cnt[1:]))
    lo, hi = int(base.seps[p - 1]) + 1, int(base.seps[p])
    fresh = np.setdiff1d(np.arange(lo, hi, dtype=np.int32),
                         base.keys[p, :base.cnt[p]])
    grow = base.leaf_width - int(base.cnt[p]) + 5
    pages0, derives0 = base.num_pages, base.derives
    tw.insert(rng.choice(fresh, grow, replace=False), np.arange(grow))
    tw.call("flush")
    assert tw.pt.stats["splits"] >= 1
    assert tw.pt.base.num_pages != pages0 and tw.pt.base.derives > derives0
    for _ in range(2):
        write_round(tw, rng)
        tw.lookup(rng)
    tw.call("flush")
    tw.lookup(rng)
    fb = tw.pt.pop_plan_feedback()
    assert tw.pt.pop_plan_feedback() is None
    want = tw.ref.pop_plan_feedback()
    assert fb() == want()


def test_trace_empty_start():
    """No initial keys: lookups over the delta tiers alone, then the
    first fold builds the base; everything deleted before that fold
    builds nothing."""
    rng = np.random.default_rng(12)
    tw = Twin(np.empty(0, np.int32), delta_capacity=16)
    assert tw.pt.base is None and tw.pt._key_dtype == np.int32
    tw.lookup(rng)
    ks = rng.choice(5000, 12, replace=False)
    tw.insert(ks, np.arange(12))
    tw.delete(ks[:4])
    tw.lookup(rng)
    tw.delete(np.concatenate([ks[4:], np.arange(6000, 6004)]))
    assert tw.pt.delta.full and tw.pt.delta.live_count == 0
    tw.insert([7000], [1])             # seals a tier of tombstones only
    tw.call("maintain")
    assert tw.pt.base is None
    tw.lookup(rng)
    for _ in range(3):
        tw.insert(rng.integers(0, 5000, 14), rng.integers(0, 99, 14))
        tw.lookup(rng)
    assert tw.pt.base is not None
    tw.delete(resident(tw, rng, 5))
    tw.call("flush")
    tw.lookup(rng)


def test_trace_float32_signed_zeros_and_nan():
    """float32 keys: -0.0 and +0.0 are one key for the build, the delta,
    the merge and the lookup; NaN queries never hit; +inf is the
    sentinel."""
    rng = np.random.default_rng(13)
    init = (rng.normal(size=700) * 1000).astype(np.float32)
    init[:3] = [0.0, -0.0, 1.5]                      # -0.0 overrides 0.0
    tw = Twin(init, rng.integers(0, 10**6, init.size).astype(np.int32),
              dtype=np.float32, delta_capacity=16, leaf_width=128)
    edge = np.array([0.0, -0.0, np.nan, -np.inf, 1e30], np.float32)
    tw.lookup(rng, extra=edge)
    tw.insert(np.array([-0.0, 2.25], np.float32), [5, 6])  # upsert of 0.0
    tw.lookup(rng, extra=edge)
    tw.delete(np.array([0.0], np.float32))
    tw.lookup(rng, extra=edge)
    tw.insert((rng.normal(size=20) * 1000).astype(np.float32),
              np.arange(20))                                # seal
    tw.insert(np.array([-0.0], np.float32), [9])            # revive
    tw.lookup(rng, extra=edge)
    tw.call("flush")
    got = tw.lookup(rng, extra=edge)
    assert got.found[1] and got.found[2] and got.values[1] == 9
    assert not got.found[3]                                 # NaN


def test_trace_inline_maintenance():
    """maintenance="inline": every seal folds at once, so the sealed tier
    is always empty after a write."""
    rng = np.random.default_rng(14)
    tw = Twin(np.arange(0, 3000, 3, dtype=np.int32), delta_capacity=16,
              leaf_width=128, maintenance="inline")
    for _ in range(3):
        write_round(tw, rng, new=20, up=6, dele=6)
        assert tw.pt.sealed.count == 0
    assert tw.pt.stats["maintains"] == tw.pt.stats["seals"] > 0


def test_thread_maintenance_folds_off_the_write_path():
    """maintenance="thread": a timer folds each sealed buffer. When the
    folds run depends on the clock, so the two stores are compared by
    found / values against the oracle and each other once both have
    folded; close() is idempotent and stops the timer."""
    rng = np.random.default_rng(15)
    keys = np.arange(0, 3000, 3, dtype=np.int32)
    cfg = dict(kind="tiered", mutable=True, delta_capacity=16,
               maintenance="thread", maintenance_interval_s=0.01)
    stores = [ref_core.build_index(keys, config=ref_core.IndexConfig(**cfg)),
              pt_core.build_index(keys, config=pt_core.IndexConfig(**cfg),
                                  device="cpu")]
    oracle = dict(zip(keys.tolist(), range(keys.size)))
    for _ in range(6):
        ks = rng.integers(0, 4000, 12).astype(np.int32)
        vs = rng.integers(0, 4000, 12).astype(np.int32)
        for s in stores:
            s.insert(ks, vs)
        oracle.update(zip(ks.tolist(), vs.tolist()))
    deadline = time.time() + 10.0
    while any(s.sealed.count for s in stores) and time.time() < deadline:
        time.sleep(0.02)
    assert not any(s.sealed.count for s in stores)
    assert stores[1].stats["maintains"] >= 1
    q = np.arange(0, 4000, 7, dtype=np.int32)
    want, got = stores[0].lookup(q), stores[1].lookup(q)
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    hit = got.found.numpy()
    np.testing.assert_array_equal(got.values.numpy()[hit],
                                  np.asarray(want.values)[hit])
    assert hit.tolist() == [k in oracle for k in q.tolist()]
    assert stores[1].n == stores[0].n == len(oracle)
    for s in stores:
        s.close()
        s.close()
    assert stores[1]._timer is None


# ------------------------------------------- sorted pages, port-only checks
def bound_mirror(rows, q):
    """The page kernel's branch-free lower-bound search
    (csrc/sorted_page.cuh), step for step, over pairs (rows[i], q[i])."""
    at = np.arange(q.size)
    base = np.zeros(q.size, np.int64)
    n = rows.shape[1]
    while n > 1:
        half = n >> 1
        base = np.where(rows[at, base + half] < q, base + half, base)
        n -= half
    return base + (rows[at, base] < q)


def assert_rows_sorted_and_searchable(rows, rng):
    assert (rows[:, 1:] >= rows[:, :-1]).all()
    pick = rng.integers(0, rows.shape[0], 3000)
    own = rows[pick, rng.integers(0, rows.shape[1], 3000)]
    near = np.clip(own.astype(np.int64) + rng.integers(-1, 2, 3000),
                   I32.min, I32.max).astype(rows.dtype)
    q = np.concatenate([own, near])
    r = rows[np.concatenate([pick, pick])]
    np.testing.assert_array_equal(bound_mirror(r, q), (r < q[:, None]).sum(1))


def test_pages_stay_sorted_through_merges_splits_and_repacks():
    """Every page (live prefix, then sentinel gaps) and every row of the
    re-derived k-ary top stays nondecreasing after inserts, deletes,
    page-local merges, splits and repacks, so the page kernel's binary
    search equals the TPU kernel's count on them; the plain page kernel at
    stride lw_pad gives the store's own slot addresses."""
    rng = np.random.default_rng(16)
    keys = np.unique(rng.integers(0, 10**7, 26_000).astype(np.int32))
    idx = pt_core.build_index(keys, config=pt_core.IndexConfig(
        kind="tiered", mutable=True, delta_capacity=256, leaf_width=128),
        device="cpu")
    assert idx.base.top_kind == "kary"
    pages0 = idx.base.num_pages
    for step in range(8):
        idx.insert(rng.integers(0, 10**7, 300), rng.integers(0, 99, 300))
        live = idx.base.keys[rng.integers(0, idx.base.num_pages, 200), 0]
        idx.delete(live[live != idx.base.sentinel])
        if step == 5:                  # crowd one page's range: a split
            p = idx.base.num_pages // 2
            idx.insert(np.arange(idx.base.seps[p - 1] + 1,
                                 idx.base.seps[p] + 1, dtype=np.int64)
                       [:200].astype(np.int32), np.arange(200))
        idx.flush()
        b = idx.base
        assert_rows_sorted_and_searchable(b.keys, rng)
        assert (b.cnt <= b.leaf_width).all()
        for lvl in pt_ops.kary_levels(b.top, 128):
            assert_rows_sorted_and_searchable(lvl.numpy(), rng)
        # the plain page kernel over the store's pages at stride lw_pad
        pids = rng.integers(0, b.num_pages, 8).astype(np.int32)
        qb = b.keys[pids[:, None], rng.integers(0, b.lw_pad, (8, 64))]
        got = pt_page.page_search_plain(
            torch.from_numpy(qb), torch.from_numpy(pids), b.dev_keys,
            stride=b.lw_pad).numpy()
        want = pids[:, None] * b.lw_pad + (
            b.keys[pids, None, :] < qb[:, :, None]).sum(-1)
        np.testing.assert_array_equal(got, want)
    assert idx.stats["splits"] >= 1 and idx.base.num_pages != pages0


@pytest.mark.parametrize("what,cfg,item", [
    ("kind", dict(kind="css", mutable=True), "item 12"),
    ("specialize", dict(kind="tiered", mutable=True, specialize=True),
     "item 11"),
    ("kind", dict(kind="nitrogen", mutable=True), "item 12")])
def test_unported_store_options_raise(what, cfg, item):
    """The other kinds raise naming their ROADMAP item; specialize (once
    unported, item 11) builds the store with its specialized twin armed."""
    if what == "specialize":
        idx = pt_core.build_index(np.arange(10, dtype=np.int32),
                                  config=pt_core.IndexConfig(**cfg),
                                  device="cpu")
        assert idx._spec_fused is not None and idx.captures.n == 1
        assert idx.lookup([3, 11]).found.tolist() == [True, False]
        return
    with pytest.raises(NotImplementedError, match=item):
        pt_core.build_index(np.arange(10, dtype=np.int32),
                            config=pt_core.IndexConfig(**cfg), device="cpu")


def test_store_surface_and_validation():
    idx = pt_core.build_index(np.arange(10, dtype=np.int32),
                              config=pt_core.IndexConfig(kind="tiered",
                                                         mutable=True),
                              device="cpu")
    # the scans run (tests/test_torch_store_scan.py holds them to the
    # reference); save needs a directory
    assert idx.scan_range([0], [1]).count.tolist() == [2]
    assert [t.tolist() for t in idx.search_range([2], [4])] == \
        [[2], [5], [3]]
    assert idx.scan_groups([0], [9], 2).count.tolist() == [[5, 5]]
    assert idx.scan_multi(np.asarray([[[0, 3], [2, 5]]], np.int32)) \
        .count.tolist() == [6]
    with pytest.raises(ValueError, match="no checkpoint directory"):
        idx.save()
    with pytest.raises(ValueError, match="num_groups"):
        idx.scan_groups([0], [1], 0)
    with pytest.raises(ValueError, match="multi-range op"):
        idx.scan_multi(np.zeros((1, 1, 2), np.int32), op="xor")
    with pytest.raises(ValueError, match="tombstone sentinel"):
        idx.insert([3], [pt_store.TOMBSTONE])
    with pytest.raises(ValueError, match="align"):
        idx.insert([3, 4], [1])
    with pytest.raises(ValueError, match="device plan only"):
        pt_core.build_index(np.arange(10, dtype=np.int32),
                            config=pt_core.IndexConfig(
                                kind="tiered", mutable=True, plan="host"),
                            device="cpu")
    with pytest.raises(ValueError, match="tombstone sentinel"):
        pt_core.build_index(np.arange(3, dtype=np.int32),
                            np.full(3, pt_store.TOMBSTONE, np.int32),
                            pt_core.IndexConfig(kind="tiered", mutable=True),
                            device="cpu")


def test_store_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_core.build_index(np.arange(10, dtype=np.int32),
                            config=pt_core.IndexConfig(kind="tiered",
                                                       mutable=True))


# --------------------------------------------------------- property test
UNIVERSE = 2_000


def oracle_lookup(ks, vs, q):
    """Sorted live keys and their values -> (found, value where found)."""
    if not ks.size:
        return np.zeros(q.shape, bool), np.zeros(q.shape, np.int32)
    pos = np.minimum(np.searchsorted(ks, q), ks.size - 1)
    return ks[pos] == q, vs[pos]


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10_000), n0=st.integers(0, 400),
       capacity=st.sampled_from([16, 32, 64]),
       trace=st.lists(st.tuples(st.integers(0, 4), st.integers(1, 30),
                                st.integers(0, 10_000)),
                      min_size=4, max_size=14))
def test_store_matches_numpy_oracle(seed, n0, capacity, trace):
    """Random insert / delete / probe / maintain traces on the port alone
    against sorted numpy arrays (upserts, deletes and re-inserts), across
    merge and repack boundaries; every page stays sorted."""
    rng = np.random.default_rng(seed)
    init = np.unique(rng.integers(0, UNIVERSE, n0).astype(np.int32))
    vals = np.arange(init.size, dtype=np.int32) * 5
    idx = pt_core.build_index(init, vals, pt_core.IndexConfig(
        kind="tiered", mutable=True, delta_capacity=capacity,
        leaf_width=128), device="cpu")
    ks, vs = init, vals
    for op, size, bseed in trace:
        br = np.random.default_rng(bseed)
        q = br.integers(0, UNIVERSE, size).astype(np.int32)
        if op <= 1:
            v = br.integers(0, 10**6, size).astype(np.int32)
            idx.insert(q, v)
            last = np.unique(q[::-1], return_index=True)[1]
            uk, uv = q[::-1][last], v[::-1][last]        # last write wins
            keep = ~np.isin(ks, uk)
            ks, vs = np.concatenate([ks[keep], uk]), \
                np.concatenate([vs[keep], uv])
            order = np.argsort(ks)
            ks, vs = ks[order], vs[order]
        elif op == 2:
            idx.delete(q)
            keep = ~np.isin(ks, q)
            ks, vs = ks[keep], vs[keep]
        else:
            if op == 4:
                idx.flush()
            got = idx.lookup(torch.from_numpy(q))
            found, want = oracle_lookup(ks, vs, q)
            np.testing.assert_array_equal(got.found.numpy(), found)
            np.testing.assert_array_equal(got.values.numpy()[found],
                                          want[found])
        assert idx.n == ks.size
        if idx.base is not None:
            b = idx.base.keys
            assert (b[:, 1:] >= b[:, :-1]).all()


def test_kary_top_trace():
    """Past 256 pages the top is the k-ary tree (the full-size store's
    top): merges, then a repack that re-derives it."""
    rng = np.random.default_rng(17)
    keys = np.unique(rng.integers(0, 10**7, 26_000).astype(np.int32))
    tw = Twin(keys, delta_capacity=64, leaf_width=128)
    assert tw.pt.base.top_kind == "kary" and tw.pt.tree_bytes > 0
    write_round(tw, rng, new=70, up=20, dele=20)
    base = tw.pt.base
    p = 1 + int(np.argmax(base.cnt[1:]))
    ks = np.arange(base.seps[p - 1] + 1, base.seps[p], dtype=np.int64)
    ks = np.setdiff1d(ks, base.keys[p])[:base.leaf_width]
    tw.insert(ks, np.arange(ks.size))
    tw.call("flush")
    assert tw.pt.stats["splits"] >= 1
    tw.lookup(rng)


def test_sentinel_query_reads_as_found_as_in_the_reference():
    """A query equal to the key sentinel matches the gap slots of its page
    and of its delta node (``key == q``): found, value 0. The reference
    answers so; the port keeps it."""
    keys = np.arange(1000, dtype=np.int32)
    cfg = dict(kind="tiered", mutable=True, delta_capacity=64)
    ref = ref_core.build_index(keys, config=ref_core.IndexConfig(**cfg))
    pt = pt_core.build_index(keys, config=pt_core.IndexConfig(**cfg),
                             device="cpu")
    q = np.array([I32.max, 999, 1000], np.int32)
    want, got = ref.lookup(q), pt.lookup(q)
    assert got.found.tolist() == [True, True, False]
    assert got.values.tolist()[0] == 0
    for name in ("rank", "found", "values"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
