"""The port's grouped and composite analytics (engine/groupby.py and the
``Index.scan_groups`` / ``scan_multi`` facade) against the reference.

The same seeded numpy inputs go through ``repro`` (JAX, Pallas kernels in
interpret mode) and ``repro_torch`` (on the CPU, the kernels' plain
versions). Edges, ranks, counts, int32 sums, min, max and top-K must be
bit-identical (a float's sign bit too, so -0.0 != +0.0; NaN at the same
lanes); float32 sums agree to rtol 1e-4, atol 1e-4 (the reference's
tolerance: the reduction order differs). No subnormal floats: XLA's CPU
backend flushes them to zero in compares."""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as ref_core
from repro.engine import groupby as ref_gb

import repro_torch.core as pt_core
from repro_torch.engine import groupby as pt_gb

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
F32_MAX = np.finfo(np.float32).max


def assert_same(got, want, what=""):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype, what
    if np.issubdtype(got.dtype, np.floating) and what.endswith("vsum"):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)
        if np.issubdtype(got.dtype, np.floating):
            num = ~np.isnan(want)
            np.testing.assert_array_equal(np.signbit(got[num]),
                                          np.signbit(want[num]),
                                          err_msg=f"{what}: sign bits")


def group_queries(dtype, q_n, seed, keys=None):
    """Random, point (narrower than G), inverted and whole-domain ranges;
    lower bounds partly drawn from ``keys``."""
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        lo = rng.integers(-2**30, 2**30, q_n)
        hi = lo + rng.integers(-2**22, 2**27, q_n)
        whole = [(I32.min, I32.max - 1), (I32.min, I32.min),
                 (I32.max - 1, I32.max - 1), (-5, 2)]
    else:
        lo = rng.normal(size=q_n) * 1e3
        hi = lo + rng.normal(size=q_n) * 400
        whole = [(-np.inf, F32_MAX), (-F32_MAX, F32_MAX), (-1.0, -1.0),
                 (0.5, 0.25)]
    if keys is not None:
        lo[: q_n // 2] = keys[rng.integers(0, keys.size, q_n // 2)]
    lo[-len(whole):], hi[-len(whole):] = zip(*whole)
    lo, hi = lo.astype(dtype), hi.astype(dtype)
    hi[:3] = lo[:3]                                     # point ranges
    return lo, hi


# ------------------------------------------------------------- group edges
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_group_edges_match_reference_and_host_twin(dtype):
    lo, hi = group_queries(dtype, 200, seed=1)
    for G in (1, 7, 1000):
        got = pt_gb.group_edges(torch.from_numpy(lo), torch.from_numpy(hi),
                                G, dtype)
        assert got.shape == (lo.size, G + 1)
        assert_same(got, ref_gb.group_edges(jnp.asarray(lo), jnp.asarray(hi),
                                            G, dtype), f"G={G}")
        assert_same(got, ref_gb.group_edges_host(lo, hi, G), f"host G={G}")
        np.testing.assert_array_equal(pt_gb.group_edges_host(lo, hi, G),
                                      ref_gb.group_edges_host(lo, hi, G))


def test_group_edges_whole_domain_no_wrap():
    lo = np.array([I32.min], np.int32)
    hi = np.array([I32.max - 1], np.int32)
    for G in (1, 3, 8, 65, 65_536):
        e = pt_gb.group_edges(torch.from_numpy(lo), torch.from_numpy(hi), G,
                              np.int32).numpy()
        assert e.shape == (1, G + 1)
        assert int(e[0, 0]) == I32.min and int(e[0, -1]) == I32.max
        assert np.all(np.diff(e[0].astype(np.int64)) >= 0)
        np.testing.assert_array_equal(e, ref_gb.group_edges_host(lo, hi, G))
    np.testing.assert_array_equal(e, np.asarray(ref_gb.group_edges(
        jnp.asarray(lo), jnp.asarray(hi), G, np.int32)))


# ------------------------------------------------------------ sorting rules
def multi_ranges(dtype, Q, R, seed):
    """[Q, R, 2] range sets with empty, touching, nested and duplicate
    member ranges."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(-100, 3000, (Q, R)).astype(dtype)
    hi = (lo + rng.integers(-50, 1500, (Q, R))).astype(dtype)
    hi[0, 0] = lo[0, 0] - 1                               # empty member
    lo[1, 1], hi[1, 1] = hi[1, 0] + 1, hi[1, 0] + 40     # touching (ints)
    lo[2, 1], hi[2, 1] = lo[2, 0] + 1, lo[2, 0] + 2       # nested
    lo[3, 1], hi[3, 1] = lo[3, 0], hi[3, 0]               # duplicate
    return np.stack([lo, hi], axis=-1)


@pytest.mark.parametrize("op", ["union", "intersect"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_coverage_ranges_match_reference(dtype, op):
    r = multi_ranges(dtype, 64, 3, seed=7)
    want = ref_gb.coverage_ranges(jnp.asarray(r[..., 0]),
                                  jnp.asarray(r[..., 1]), op=op,
                                  key_dtype=dtype)
    got = pt_gb.coverage_ranges(torch.from_numpy(r[..., 0]),
                                torch.from_numpy(r[..., 1]), op=op,
                                key_dtype=dtype)
    for g, w in zip(got, want):
        assert_same(g, w, op)
    with pytest.raises(ValueError, match="unknown multi-range op"):
        pt_gb.coverage_ranges(torch.from_numpy(r[..., 0]),
                              torch.from_numpy(r[..., 1]), op="xor",
                              key_dtype=dtype)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_masked_topk_ties_match_reference(dtype):
    """Many tied values, the dtype minimum among the valid candidates, and
    counts below, at and above the window: ties go to the lower index."""
    rng = np.random.default_rng(5)
    N, C, K = 300, 16, 5
    vals = rng.integers(0, 4, (N, C)).astype(dtype)
    vals[::7, 0] = ref_gb.agg_identities(dtype)[1]      # ties the padding
    ranks = np.arange(N * C, dtype=np.int32).reshape(N, C)
    count = rng.integers(0, C + 5, N).astype(np.int32)
    want = ref_gb.masked_topk(jnp.asarray(vals), jnp.asarray(ranks),
                              jnp.asarray(count), K)
    got = pt_gb.masked_topk(torch.from_numpy(vals), torch.from_numpy(ranks),
                            torch.from_numpy(count), K)
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("mode", ["count", "sum", "full"])
def test_multi_reduce_matches_reference(mode):
    rng = np.random.default_rng(9)
    Q, R = 50, 4
    cnt = np.where(rng.random(Q * R) < 0.4, 0,
                   rng.integers(1, 100, Q * R)).astype(np.int32)
    vs = rng.integers(I32.min, I32.max, Q * R).astype(np.int32)  # wraps
    mn = rng.integers(-9, 9, Q * R).astype(np.int32)
    rlo = rng.integers(0, 1000, Q * R).astype(np.int32)
    args = (cnt, vs, mn, mn + 3, rlo, rlo + cnt)
    want = ref_gb._multi_reduce(R, mode, *map(jnp.asarray, args))
    got = pt_gb._multi_reduce(R, mode, *map(torch.from_numpy, args))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert_same(g, w, mode)


def test_multi_reduce_signed_zeros_match_reference():
    """Float32 partial minima and maxima of +-0.0 (and a NaN, +-inf)
    folded over R: -0.0 is the min and +0.0 the max whatever the order,
    as jnp.min / jnp.max give them."""
    rng = np.random.default_rng(10)
    Q, R = 64, 4
    cnt = rng.integers(0, 3, Q * R).astype(np.int32)
    zeros = np.where(rng.random((2, Q * R)) < 0.5, -0.0, 0.0)
    mn, mx = zeros.astype(np.float32)
    mn[:3], mx[:3] = np.nan, np.inf
    mn[3:5] = -np.inf
    vs = rng.normal(size=Q * R).astype(np.float32)
    rlo = rng.integers(0, 1000, Q * R).astype(np.int32)
    args = (cnt, vs, mn, mx, rlo, rlo + cnt)
    want = ref_gb._multi_reduce(R, "full", *map(jnp.asarray, args))
    got = pt_gb._multi_reduce(R, "full", *map(torch.from_numpy, args))
    for f, g, w in zip(("count", "vsum", "vmin", "vmax"), got, want):
        assert_same(g, w, f)
    assert np.signbit(np.asarray(want[2])).sum() > Q // 2


# ------------------------------------------------------------ the slice
def make_index_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = int(name.split("_")[1])
    if name.startswith("zeros_"):   # values +-0.0, a few NaN and +-inf
        keys = (rng.normal(size=n) * 1e3).astype(np.float32)
        vals = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
        vals[rng.choice(n, 12, replace=False)] = np.repeat(
            [np.nan, np.inf, -np.inf], 4)
    elif name.startswith("i32_"):
        keys = rng.integers(-2**30, 2**30, n).astype(np.int32)
        vals = rng.integers(I32.min, I32.max, n).astype(np.int32)
    else:
        keys = (rng.normal(size=n) * 1e3).astype(np.float32)
        keys[:2] = [0.0, -0.0]
        vals = rng.normal(size=n).astype(np.float32)
    return keys, vals


GROUP_CASES = ["i32_32769", "f32_32768"]
G = 8


@pytest.fixture(scope="module")
def indexes():
    cache = {}

    def get(name):
        if name not in cache:
            keys, vals = make_index_case(name)
            # the small signed-zero index over pages of 128, so ranges
            # cross interior pages (read from the sparse tables)
            kw = {"leaf_width": 128} if name.startswith("zeros_") else {}
            cache[name] = (
                keys,
                ref_core.build_index(keys, vals, ref_core.IndexConfig(
                    kind="tiered", **kw)),
                pt_core.build_index(keys, vals, pt_core.IndexConfig(
                    kind="tiered", **kw), device="cpu"))
        return cache[name]
    return get


GROUP_FIELDS = ("count", "edges", "r_edge", "vsum", "vmin", "vmax",
                "topk_values", "topk_ranks", "overflow")


def assert_groups_same(got, want):
    for f in GROUP_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert_same(g, w, f)


@pytest.mark.parametrize("aggs", [("count",), ("count", "sum"), None],
                         ids=["count", "sum", "full"])
@pytest.mark.parametrize("name", GROUP_CASES)
def test_scan_groups_match_reference(name, aggs, indexes):
    keys, ref_idx, pt_idx = indexes(name)
    lo, hi = group_queries(keys.dtype, 48, seed=3, keys=keys)
    want = ref_idx.scan_groups(lo, hi, G, aggs=aggs)
    got = pt_idx.scan_groups(lo, hi, G, aggs=aggs)
    assert_groups_same(got, want)
    assert int(want.count.sum()) > 0


@pytest.mark.parametrize("name", GROUP_CASES)
def test_scan_groups_top_k_matches_reference(name, indexes):
    keys, ref_idx, pt_idx = indexes(name)
    lo, hi = group_queries(keys.dtype, 24, seed=4, keys=keys)
    want = ref_idx.scan_groups(lo, hi, G, top_k=3, candidates=6)
    got = pt_idx.scan_groups(lo, hi, G, top_k=3, candidates=6)
    assert_groups_same(got, want)
    assert bool(want.overflow.any()) and not bool(want.overflow.all())


@pytest.mark.parametrize("name,op", [("i32_32769", "union"),
                                     ("f32_32768", "intersect")])
def test_scan_multi_matches_reference(name, op, indexes):
    keys, ref_idx, pt_idx = indexes(name)
    r = multi_ranges(keys.dtype, 40, 3, seed=8)
    r[4:, :, :] = np.sort(keys[np.random.default_rng(1).integers(
        0, keys.size, (36, 3, 2))], axis=-1)
    want = ref_idx.scan_multi(r, op=op)
    got = pt_idx.scan_multi(r, op=op)
    for f in ("count", "r_lo", "r_hi_excl", "vsum", "vmin", "vmax"):
        assert_same(getattr(got, f), getattr(want, f), f"{op} {f}")
    assert int(want.count.sum()) > 0


def test_scan_groups_signed_zeros_match_reference(indexes):
    """Full-mode groups over values of +-0.0 with a few NaN and +-inf:
    bucket min -0.0 and max +0.0 wherever a bucket takes in both zeros
    and no NaN, bit for bit with the reference."""
    keys, ref_idx, pt_idx = indexes("zeros_4097")
    lo, hi = group_queries(keys.dtype, 48, seed=6, keys=keys)
    want = ref_idx.scan_groups(lo, hi, G)
    got = pt_idx.scan_groups(lo, hi, G)
    assert_groups_same(got, want)
    mn, mx = np.asarray(want.vmin), np.asarray(want.vmax)
    assert (np.signbit(mn) & (mn == 0)).sum() > 10
    assert (~np.signbit(mx) & (mx == 0)).sum() > 10
    assert np.isnan(mn).any()


def test_scan_groups_and_multi_validation_match_reference(indexes):
    keys, ref_idx, pt_idx = indexes("i32_32769")
    lo, hi = np.array([0], np.int32), np.array([99], np.int32)
    calls = [lambda i: i.scan_groups(lo, hi, 0),
             lambda i: i.scan_groups(lo, hi, pt_gb.MAX_GROUPS + 1),
             lambda i: i.scan_groups(lo, hi, 4, top_k=0),
             lambda i: i.scan_groups(lo, hi, 4, aggs=("avg",)),
             lambda i: i.scan_multi(np.zeros((2, 3), np.int32)),
             lambda i: i.scan_multi(np.zeros((1, 0, 2), np.int32)),
             lambda i: i.scan_multi(np.zeros((1, 2, 2), np.int32), op="xor")]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(ref_idx)
        with pytest.raises(ValueError) as got:
            call(pt_idx)
        assert str(got.value) == str(want.value)
    rank_only = pt_core.build_index(keys, None,
                                    pt_core.IndexConfig(kind="tiered"),
                                    device="cpu")
    with pytest.raises(ValueError, match="top_k needs an index built with"):
        rank_only.scan_groups(lo, hi, 4, top_k=2)
