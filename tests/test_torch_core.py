"""The port's index kinds (binary, CSS, k-ary, FAST, NitroGen, the CSB+-tree)
and their kernel wrappers against the reference.

The same numpy keys and queries (seeded) go through ``repro`` (JAX; the
Pallas kernels in interpret mode) and ``repro_torch`` (on the CPU, where
the kernel wrappers run their plain versions): ranks, found flags, values,
counts and every built array must be bit-identical. No tolerance: all of
them are integers or copies of keys. Subnormal floats stay out of the JAX
comparisons (XLA's CPU backend flushes them in compares) and are held to
numpy instead."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref_core
from repro.core import csb_tree as ref_csb
from repro.core import css_tree as ref_css
from repro.core import fast_tree as ref_fast
from repro.core import kary as ref_kary
from repro.core import nitrogen as ref_nitrogen
from repro.core import sorted_array as ref_sorted
from repro.kernels import ops as ref_ops

import repro_torch.core as pt_core
from repro_torch.core import csb_tree as pt_csb
from repro_torch.core import css_tree as pt_css
from repro_torch.core import fast_tree as pt_fast
from repro_torch.core import kary as pt_kary
from repro_torch.core import nitrogen as pt_nitrogen
from repro_torch.core import sorted_array as pt_sorted
from repro_torch.kernels import ops as pt_ops

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
FLAT = ["binary", "css", "kary", "fast", "nitrogen"]

# tests/test_core_index.py's CONFIGS, as (kind, kwargs) for both packages
CONFIGS = [
    dict(kind="binary"),
    dict(kind="binary", linear_cutoff=8),
    dict(kind="css", node_width=4),
    dict(kind="css", node_width=4, intra="binary"),
    dict(kind="css", node_width=16, leaf_width=8),
    dict(kind="kary", node_width=3),
    dict(kind="kary", node_width=7),
    dict(kind="fast", node_width=3, page_depth=2),
    dict(kind="fast", node_width=4, page_depth=3, leaf_width=6),
    dict(kind="nitrogen", levels=2, compiled_node_width=3),
    dict(kind="nitrogen", levels=3, compiled_node_width=1, bottom="vector"),
    dict(kind="nitrogen", levels=2, compiled_node_width=2, bottom="css",
         node_width=4),
]
IDS = ["-".join(f"{v}" for v in c.values()) for c in CONFIGS]


def both(keys, values=None, **cfg):
    """(reference Index, port Index) over the same keys."""
    ref = ref_core.build_index(keys, values, ref_core.IndexConfig(**cfg))
    pt = pt_core.build_index(keys, values, pt_core.IndexConfig(**cfg),
                             device="cpu")
    return ref, pt


def same(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_rank_matches_reference_int32(cfg):
    rng = np.random.default_rng(0)
    keys = rng.choice(200_000, size=3_000, replace=False).astype(np.int32)
    queries = np.concatenate([
        rng.integers(0, 200_000, 512).astype(np.int32), keys[:256],
        np.array([0, 199_999, I32.min, I32.max - 1], np.int32)])
    ref, pt = both(keys, np.arange(keys.size, dtype=np.int32), **cfg)
    want = np.asarray(ref.search(queries))
    same(pt.search(queries), want)
    np.testing.assert_array_equal(
        want, np.searchsorted(np.sort(keys), queries).astype(np.int32))
    assert pt.tree_bytes == ref.tree_bytes


@pytest.mark.parametrize("cfg", CONFIGS[:6], ids=IDS[:6])
def test_rank_matches_reference_float32(cfg):
    rng = np.random.default_rng(1)
    keys = np.unique(rng.normal(size=2_000).astype(np.float32))
    queries = np.concatenate([rng.normal(size=300).astype(np.float32),
                              keys[::7], [np.inf, -np.inf]]).astype(np.float32)
    ref, pt = both(keys, **cfg)
    same(pt.search(queries), ref.search(queries))


@pytest.mark.parametrize("kind", FLAT)
def test_lookup_found_and_values(kind):
    rng = np.random.default_rng(2)
    keys = rng.choice(50_000, 1_500, replace=False).astype(np.int32)
    vals = rng.integers(I32.min, I32.max, keys.size).astype(np.int32)
    q = np.concatenate([keys[::3], rng.integers(-10, 50_010, 400)
                        ]).astype(np.int32)
    ref, pt = both(keys, vals, kind=kind, node_width=8, levels=2)
    want, got = ref.lookup(q), pt.lookup(q)
    same(got.rank, want.rank)
    same(got.found, want.found)
    same(got.values, want.values)


@pytest.mark.parametrize("kind", pt_core.KINDS)
def test_duplicate_keys_return_first_occurrence(kind):
    keys = np.array([2, 2, 2, 5, 5, 8], np.int32)
    q = np.array([1, 2, 3, 5, 8, 9], np.int32)
    ref, pt = both(keys, kind=kind, node_width=3, levels=1,
                   compiled_node_width=1)
    same(pt.search(q), ref.search(q))
    np.testing.assert_array_equal(pt.search(q).numpy(), [0, 0, 3, 3, 5, 6])


def test_default_config_builds_css_and_matches_reference():
    rng = np.random.default_rng(3)
    keys = rng.choice(10**6, 20_000, replace=False).astype(np.int32)
    vals = np.arange(keys.size, dtype=np.int32)
    q = np.concatenate([keys[::5], rng.integers(0, 10**6, 2_000)
                        ]).astype(np.int32)
    ref = ref_core.build_index(keys, vals)
    pt = pt_core.build_index(keys, vals, device="cpu")
    assert pt.config.kind == "css" and pt_core.PORTED_KINDS == pt_core.KINDS
    want, got = ref.lookup(q), pt.lookup(q)
    same(got.rank, want.rank)
    same(got.found, want.found)
    same(got.values, want.values)
    assert pt.tree_bytes == ref.tree_bytes


# ------------------------------------------------------- built structures
def _arr(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


STRUCTS = {
    "binary": (lambda k: ref_sorted.build(k, linear_cutoff=8),
               lambda k: pt_sorted.build(k, linear_cutoff=8, device="cpu"),
               ("keys", "keys_pad", "n", "n_pad", "linear_cutoff")),
    "css": (lambda k: ref_css.build(k, node_width=5, leaf_width=7),
            lambda k: pt_css.build(k, node_width=5, leaf_width=7,
                                   device="cpu"),
            ("keys", "leaf_pad", "dir_keys", "level_offsets", "depth")),
    "kary": (lambda k: ref_kary.build(k, node_width=6),
             lambda k: pt_kary.build(k, node_width=6, device="cpu"),
             ("keys", "tree", "level_offsets", "depth")),
    "fast": (lambda k: ref_fast.build(k, node_width=3, page_depth=2),
             lambda k: pt_fast.build(k, node_width=3, page_depth=2,
                                     device="cpu"),
             ("keys", "leaf_pad", "pages", "group_offsets", "group_depths",
              "depth", "page_keys")),
    "nitrogen-binary": (lambda k: ref_nitrogen.build(k, levels=2),
                        lambda k: pt_nitrogen.build(k, levels=2,
                                                    device="cpu"),
                        ("keys", "block_pad", "block_width",
                         "block_pad_width", "num_blocks", "bottom")),
    "nitrogen-css": (lambda k: ref_nitrogen.build(k, levels=2, bottom="css",
                                                  css_node_width=5),
                     lambda k: pt_nitrogen.build(k, levels=2, bottom="css",
                                                 css_node_width=5,
                                                 device="cpu"),
                     ("keys", "block_pad", "block_pad_width", "css_dirs",
                      "css_offsets", "css_depth", "css_w", "css_leaf_width",
                      "css_dir_len", "css_leaf_len")),
}


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("name", list(STRUCTS))
def test_built_arrays_match_reference(name, dtype):
    """Every array a structure holds, its layout constants and tree_bytes,
    bit for bit (the NitroGen default bottom is the reference's binary)."""
    rng = np.random.default_rng(len(name))
    keys = rng.choice(100_000, 2_345, replace=False).astype(dtype)
    ref_build, pt_build, fields = STRUCTS[name]
    ref, pt = ref_build(keys), pt_build(keys)
    for f in fields:
        want, got = _arr(getattr(ref, f)), _arr(getattr(pt, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert pt.tree_bytes == ref.tree_bytes


def test_nitrogen_searcher_and_default_bottom():
    keys = np.arange(0, 1000, 7, dtype=np.int32)
    idx = pt_nitrogen.build(keys, levels=2, node_width=3, device="cpu")
    assert idx.bottom == ref_nitrogen.build(keys).bottom == "binary"
    assert idx.tree_bytes == 0
    qs = np.array([0, 7, 8, 993, 10_000], np.int32)
    same(pt_nitrogen.searcher(idx)(qs),
         ref_nitrogen.searcher(ref_nitrogen.build(keys, levels=2))(qs))
    with pytest.raises(ValueError, match="unknown nitrogen bottom"):
        pt_nitrogen.build(keys, bottom="bogus", device="cpu")


# ----------------------------------------------------------- search_range
@pytest.mark.parametrize("kind", FLAT)
def test_search_range_matches_reference(kind):
    """Duplicates at both ends, lo > hi (the empty interval at r_lo), and
    the hi = INT32_MAX row: hi + 1 wraps to INT32_MIN in both packages
    (ROADMAP Queue 3, not a fault of the port), recorded as it is."""
    rng = np.random.default_rng(4)
    keys = np.sort(np.concatenate([
        np.full(40, -5), np.full(30, 1_000), rng.integers(0, 10**5, 1_500),
        np.full(25, 99_999)])).astype(np.int32)
    lo = np.concatenate([rng.integers(-10, 10**5, 200), [-5, 1_000, 500, -5],
                         [7]]).astype(np.int32)
    hi = np.concatenate([lo[:200] + rng.integers(-50, 5_000, 200),
                         [-5, 99_999, 400, 1_000], [I32.max]]).astype(np.int32)
    ref, pt = both(keys, kind=kind, node_width=8, levels=2,
                   compiled_node_width=3)
    for got, want in zip(pt.search_range(lo, hi), ref.search_range(lo, hi)):
        same(got, want)
    r_lo, r_hi, cnt = (t.numpy() for t in pt.search_range(lo, hi))
    ok = hi < I32.max
    want_lo = np.searchsorted(keys, lo)
    want_hi = np.where(lo > hi, want_lo, np.searchsorted(keys, hi, "right"))
    np.testing.assert_array_equal(r_lo, want_lo)
    np.testing.assert_array_equal(r_hi[ok], want_hi[ok])
    np.testing.assert_array_equal(cnt[ok], np.maximum(want_hi - want_lo,
                                                      0)[ok])
    assert (r_hi[-1], cnt[-1]) == (0, 0)     # numpy: 1,594 keys in [7, max]
    assert (cnt[200], cnt[202]) == (40, 0)


@pytest.mark.parametrize("kind", FLAT)
def test_search_range_float_duplicates(kind):
    """Float duplicates at both ends through nextafter(hi): against the
    reference away from zero, and against numpy with signed zeros and
    subnormals (which XLA's CPU compares flush)."""
    rng = np.random.default_rng(5)
    base = np.concatenate([np.full(20, -2.5), np.full(15, 0.75),
                           rng.normal(size=600) + 3.0])
    keys = base.astype(np.float32)
    lo = np.array([-2.5, 0.75, -3.0, 1.0, 4.0], np.float32)
    hi = np.array([0.75, 0.75, -2.5, 0.5, 5.0], np.float32)
    ref, pt = both(keys, kind=kind, node_width=8, levels=2,
                   compiled_node_width=3)
    for got, want in zip(pt.search_range(lo, hi), ref.search_range(lo, hi)):
        same(got, want)
    tiny = np.float32(1e-45)
    keys = np.concatenate([keys, [-0.0, 0.0, 0.0, tiny, tiny, -tiny]]
                          ).astype(np.float32)
    srt = np.sort(keys)
    lo = np.array([-0.0, 0.0, -tiny, tiny, 0.0], np.float32)
    hi = np.array([0.0, -0.0, tiny, tiny, -tiny], np.float32)
    pt = pt_core.build_index(keys, config=pt_core.IndexConfig(
        kind=kind, node_width=8, levels=2, compiled_node_width=3),
        device="cpu")
    r_lo, r_hi, cnt = (t.numpy() for t in pt.search_range(lo, hi))
    want_lo = np.searchsorted(srt, lo)
    want_hi = np.where(lo > hi, want_lo, np.searchsorted(srt, hi, "right"))
    np.testing.assert_array_equal(r_lo, want_lo)
    np.testing.assert_array_equal(r_hi, want_hi)
    np.testing.assert_array_equal(cnt, want_hi - want_lo)


def test_flat_kinds_raise_item_12b_for_the_rest_of_the_api():
    """The rest of the API over the flat kinds (once unported, item 12B)
    answers: the scans of a fast index, a specialized binary index and a
    mutable k-ary store, against numpy (tests/test_torch_flat_api.py and
    tests/test_torch_flat_store.py hold them to the reference)."""
    keys = np.arange(100, dtype=np.int32)
    idx = pt_core.build_index(keys, keys, pt_core.IndexConfig(kind="fast"),
                              device="cpu")
    lo, hi = np.array([1], np.int32), np.array([5], np.int32)
    r = idx.scan_range(lo, hi)
    assert (r.count.tolist(), r.vsum.tolist(), r.vmin.tolist(),
            r.vmax.tolist()) == ([5], [15], [1], [5])
    g = idx.scan_groups(lo, hi, 2)
    assert g.count.tolist() == [[3, 2]] and g.vsum.tolist() == [[6, 9]]
    m = idx.scan_multi(np.array([[[1, 5], [4, 9]]], np.int32))
    assert m.count.tolist() == [9] and m.vsum.tolist() == [45]
    spec = pt_core.build_index(keys, config=pt_core.IndexConfig(
        kind="binary", specialize=True), device="cpu")
    assert spec.captures.n == 1
    assert spec.search(np.array([-1, 7, 100], np.int32)).tolist() == [0, 7,
                                                                      100]
    store = pt_core.build_index(keys, config=pt_core.IndexConfig(
        kind="kary", mutable=True), device="cpu")
    store.insert([200], [7])
    store.delete([3])
    res = store.lookup(np.array([3, 4, 200], np.int32))
    assert res.found.tolist() == [False, True, True]
    assert res.values[1:].tolist() == [4, 7] and store.n == 100


# --------------------------------------------------------------- numpy only
def _subnormal_case():
    tiny = np.float32(1e-45)
    keys = np.concatenate([[-0.0, 0.0, tiny, -tiny, 3 * tiny, -1e-38, 1e-38,
                            -3e38, 3e38, 1.0, 1.0]]).astype(np.float32)
    q = np.concatenate([keys, [0.0, -0.0, 2 * tiny, -2 * tiny, np.inf,
                               -np.inf, 5 * tiny]]).astype(np.float32)
    return keys, q


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_subnormal_and_signed_zero_keys_match_numpy(cfg):
    keys, q = _subnormal_case()
    pt = pt_core.build_index(keys, config=pt_core.IndexConfig(**cfg),
                             device="cpu")
    np.testing.assert_array_equal(pt.search(q).numpy(),
                                  np.searchsorted(np.sort(keys), q))


@settings(max_examples=40, deadline=None)
@given(keys=st.lists(st.integers(-2**20, 2**20), min_size=1, max_size=300),
       qs=st.lists(st.integers(-2**20 - 5, 2**20 + 5), min_size=0,
                   max_size=64),
       kind=st.sampled_from(FLAT),
       w=st.sampled_from([1, 2, 3, 7]),
       variant=st.sampled_from(["binary", "vector", "css"]))
def test_property_all_kinds_match_numpy(keys, qs, kind, w, variant):
    """Every kind (NitroGen with each bottom, CSS with each intra, binary
    with and without a cutoff) against numpy, duplicates included."""
    keys = np.array(keys, np.int32)
    qs = np.array(qs, np.int32)
    cfg = pt_core.IndexConfig(
        kind=kind, node_width=w, compiled_node_width=w, levels=2,
        page_depth=2, bottom=variant,
        intra="binary" if variant == "binary" else "vector",
        linear_cutoff=4 if variant == "css" else 1)
    idx = pt_core.build_index(keys, np.arange(keys.size, dtype=np.int32),
                              cfg, device="cpu")
    srt = np.sort(keys)
    np.testing.assert_array_equal(idx.search(qs).numpy(),
                                  np.searchsorted(srt, qs))
    np.testing.assert_array_equal(idx.lookup(qs).found.numpy(),
                                  np.isin(qs, keys))


# ------------------------------------------------------------------ CSB+
def test_csb_build_and_membership():
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 10**6, 5_000).astype(np.int32))
    probe = np.concatenate([keys[::7],
                            rng.integers(0, 10**6, 500).astype(np.int32)])
    t = pt_csb.CSBTree.build(keys, w=8, device="cpu")
    ref = ref_csb.CSBTree.build(keys, w=8)
    same(t.search(probe), ref.search(probe))
    np.testing.assert_array_equal(t.search(probe).numpy(),
                                  np.isin(probe, keys))


def test_csb_incremental_insert_no_rebuild_for_leaf_room():
    t = pt_core.CSBTree.build(np.arange(0, 1000, 10, dtype=np.int32), w=8,
                              device="cpu")
    assert not t.insert(20)                      # duplicate
    assert t.insert(15)
    assert bool(t.search(np.array([15], np.int32))[0])
    assert not bool(t.search(np.array([16], np.int32))[0])
    np.testing.assert_array_equal(
        np.sort(t.iter_keys()),
        np.sort(np.append(np.arange(0, 1000, 10, dtype=np.int32), 15)))


@settings(max_examples=15, deadline=None)
@given(base=st.lists(st.integers(0, 10**6), min_size=1, max_size=300,
                     unique=True),
       extra=st.lists(st.integers(0, 10**6), min_size=1, max_size=60,
                      unique=True),
       w=st.sampled_from([4, 8]))
def test_csb_property_inserts_preserve_membership(base, extra, w):
    base = np.array(base, np.int32)
    t = pt_csb.CSBTree.build(base, w=w, device="cpu")
    for e in extra:
        t.insert(np.int32(e))
    allk = np.union1d(base, np.array(extra, np.int32))
    probe = np.concatenate([allk, allk + 1]).astype(np.int32)
    np.testing.assert_array_equal(t.search(probe).numpy(),
                                  np.isin(probe, allk))


def test_csb_one_reference_per_node_invariant():
    t = pt_csb.CSBTree.build(np.arange(500, dtype=np.int32), w=4,
                             device="cpu")
    internal = t.child[: t._n_nodes] >= 0
    assert internal.sum() >= 1
    for nid in np.where(internal)[0]:
        base, ln = int(t.child[nid]), int(t.nlen[nid])
        assert base + ln < t._n_nodes


CSB_FIELDS = ("keys", "child", "nlen", "leaf_keys", "root", "height",
              "_n_nodes")


@pytest.mark.parametrize("start", [[10, 20], list(range(0, 600, 3))])
def test_csb_node_arrays_match_reference_through_inserts(start, monkeypatch):
    """The same build and insert trace through both trees: every node
    array equal after each insert, through leaf splits, a root split (the
    first start is a lone leaf) and the rebuild fallback when a parent is
    full; int32 keys stay int32 across the rebuild."""
    builds = {"ref": 0, "pt": 0}
    for name, cls in (("ref", ref_csb.CSBTree), ("pt", pt_csb.CSBTree)):
        def counted(klass, *a, _orig=cls.build.__func__, _name=name, **kw):
            builds[_name] += 1
            return _orig(klass, *a, **kw)
        monkeypatch.setattr(cls, "build", classmethod(counted))
    rng = np.random.default_rng(len(start))
    start = np.array(start, np.int32)
    ref = ref_csb.CSBTree.build(start, w=4)
    pt = pt_csb.CSBTree.build(start, w=4, device="cpu")
    heights = [ref.height]
    for k in rng.integers(0, 700, 150).astype(np.int32):
        assert pt.insert(k) == ref.insert(k)
        heights.append(ref.height)
        for f in CSB_FIELDS:
            np.testing.assert_array_equal(getattr(pt, f), getattr(ref, f),
                                          err_msg=f)
    assert builds["pt"] == builds["ref"] >= 2         # a rebuild fallback
    assert heights[0] == 1 or len(start) > 2          # a root split ...
    assert heights[0] > 1 or heights[-1] > 2          # ... and more
    assert pt.keys.dtype == np.int32
    probe = np.arange(-1, 701, dtype=np.int32)
    same(pt.search(probe), ref.search(probe))


# ------------------------------------------------------- kernel wrappers
@pytest.mark.parametrize("n_keys", [5, 63, 257, 4000])
@pytest.mark.parametrize("w", [3, 7])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_kary_search_matches_reference(n_keys, w, dtype):
    """tests/test_kernels.py's cases: ops.kary_search (the kernel's plain
    version here) against the reference's Pallas kernel in interpret
    mode; the operand is laid out once per index and lane."""
    rng = np.random.default_rng(n_keys * 7 + w)
    if dtype == np.int32:
        keys = np.unique(rng.integers(-2**30, 2**30, n_keys).astype(dtype))
        qs = np.concatenate([rng.integers(-2**30, 2**30, 100).astype(dtype),
                             keys[:50]])
    else:
        keys = np.unique(rng.normal(scale=1e3, size=n_keys).astype(dtype))
        qs = np.concatenate([rng.normal(scale=1e3, size=100).astype(dtype),
                             keys[:50]])
    ref = ref_kary.build(keys, node_width=w)
    pt = pt_kary.build(keys, node_width=w, device="cpu")
    want = ref_ops.kary_search(ref, qs, lane=8, tile_rows=2)
    same(pt_ops.kary_search(pt, qs, lane=8, tile_rows=2), want)
    same(pt_ops.kary_search(pt, qs, lane=8, tile_rows=2), want)
    assert list(pt.kernel_operands) == [("kary_levels", 8)]


def test_kary_search_large_ints_and_vmem_guard():
    keys = np.array([-2**31 + 1, -2**24 - 3, 0, 2**24 + 1, 2**30 + 7],
                    np.int32)
    qs = np.array([-2**31 + 1, -2**24 - 3, 2**24 + 1, 2**24 + 2, 2**30 + 7,
                   5], np.int32)
    same(pt_ops.kary_search(pt_kary.build(keys, node_width=3, device="cpu"),
                            qs, lane=8, tile_rows=2),
         ref_ops.kary_search(ref_kary.build(keys, node_width=3), qs, lane=8,
                             tile_rows=2))
    # the guard raises the reference's error on the same trees: depth 7 at
    # node_width 7 (262,144 keys) and a deep binary tree
    for n, w, lane, rows in ((20_000, 1, 128, 8), (262_144, 7, 8, 2)):
        keys = np.arange(n, dtype=np.int32)
        with pytest.raises(ValueError) as want:
            ref_ops.kary_search(ref_kary.build(keys, node_width=w), keys[:8],
                                lane=lane, tile_rows=rows)
        with pytest.raises(ValueError) as got:
            pt_ops.kary_search(pt_kary.build(keys, node_width=w,
                                             device="cpu"),
                               keys[:8], lane=lane, tile_rows=rows)
        assert str(got.value) == str(want.value)
    # the largest tree it admits at lane 8: 262,143 keys, depth 6
    assert pt_kary.build(np.arange(262_143, dtype=np.int32), node_width=7,
                         device="cpu").depth == 6


@pytest.mark.parametrize("n_keys,w,pd,tile", [
    (100, 3, 2, 8), (5000, 7, 2, 16), (2048, 15, 1, 32)])
def test_fast_page_search_matches_reference(n_keys, w, pd, tile):
    rng = np.random.default_rng(n_keys + w)
    keys = np.unique(rng.integers(0, 10**8, n_keys).astype(np.int32))
    qs = np.concatenate([rng.integers(0, 10**8, 300).astype(np.int32),
                         keys[:100]])
    ref = ref_fast.build(keys, node_width=w, page_depth=pd)
    pt = pt_fast.build(keys, node_width=w, page_depth=pd, device="cpu")
    same(pt_ops.fast_page_search(pt, qs, tile=tile),
         ref_ops.fast_page_search(ref, qs, tile=tile))
    same(pt_fast.leaf_page_of(pt, qs), ref_fast.leaf_page_of(ref, qs))
    pages = pt_ops.fast_leaf_pages(pt)
    assert pages.shape[1] == 128 and pages is pt_ops.fast_leaf_pages(pt)


def test_fast_page_search_skewed_and_empty():
    keys = np.arange(0, 4096, dtype=np.int32)
    ref = ref_fast.build(keys, node_width=7, page_depth=2)
    pt = pt_fast.build(keys, node_width=7, page_depth=2, device="cpu")
    qs = np.concatenate([np.full(500, 17, np.int32),       # one hot page
                         np.arange(0, 4096, 97, np.int32)])
    same(pt_ops.fast_page_search(pt, qs, tile=64),
         ref_ops.fast_page_search(ref, qs, tile=64))
    empty = np.zeros((0,), np.int32)
    got = pt_ops.fast_page_search(pt, empty)
    assert got.shape == (0,) and got.dtype == torch.int32
    assert np.asarray(ref_ops.fast_page_search(ref, empty)).shape == (0,)
