"""The port's range scans (kernels/page_scan.py, engine/scan.py and the
``Index.search_range`` / ``scan_range`` facade) against the reference.

The same seeded numpy inputs go through ``repro`` (JAX, Pallas kernels in
interpret mode) and ``repro_torch`` (on the CPU, the kernels' plain
versions). Ranks, counts, int32 sums, min, max and materialized rows must
be bit-identical (a float's sign bit too, so -0.0 != +0.0; NaN at the same
lanes); float32 sums agree to the reference's own tolerance (rtol 1e-4,
atol 1e-4: the reduction order differs). Subnormal floats stay out of the
inputs: XLA's CPU backend flushes them to zero in compares."""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as ref_core
from repro.engine import scan as ref_scan
from repro.kernels import page_scan as ref_pscan

import repro_torch.core as pt_core
from repro_torch.engine import scan as pt_scan
from repro_torch.engine import tiered as pt_tiered
from repro_torch.kernels import page_scan as pt_pscan

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
MASK = -7                       # a value sentinel the mask drops


def assert_sums(got, want):
    got = np.asarray(got)
    if np.issubdtype(got.dtype, np.floating):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


def assert_bits(got, want, what=""):
    """Equal as values with NaN at the same lanes, and every other lane
    with the same sign bit: -0.0 and +0.0 differ here, as their bits do."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)
    if np.issubdtype(got.dtype, np.floating):
        num = ~np.isnan(want)
        np.testing.assert_array_equal(np.signbit(got[num]),
                                      np.signbit(want[num]),
                                      err_msg=f"{what}: sign bits")


# ------------------------------------------------------------------ kernels
def scan_case(dtype, lw_pad, seed):
    """Sorted sentinel-padded pages with aligned values, and [G, TQ] bound
    pairs bucketed by page: narrow, wide, inverted (inert) and whole-page
    pairs; int32 values large enough for the sums to wrap."""
    rng = np.random.default_rng(seed)
    P, G, TQ = 6, 9, 32
    live = lw_pad - 37                                    # a padded tail
    if dtype == np.int32:
        keys = np.sort(rng.integers(-5000, 5000, P * live)).astype(dtype)
        vals = rng.integers(I32.min // 2, I32.max // 2, (P, lw_pad))
        lo = rng.integers(-5200, 5200, (G, TQ))
        sent = I32.max
    else:
        keys = np.sort(rng.normal(scale=3e3, size=P * live)).astype(dtype)
        vals = rng.normal(size=(P, lw_pad))
        lo = rng.normal(scale=3e3, size=(G, TQ))
        sent = np.inf
    kpages = np.full((P, lw_pad), sent, dtype)
    kpages[:, :live] = keys.reshape(P, live)
    vals = vals.astype(dtype)
    vals[:, ::11] = MASK                                  # some masked slots
    lo = lo.astype(dtype)
    hi = (lo + rng.integers(-300, 3000, (G, TQ))).astype(dtype)
    lo_min, hi_cap, inert_lo, inert_hi = ref_scan._domain_consts(dtype)
    lo[0, :4], hi[0, :4] = inert_lo, inert_hi             # inert lanes
    lo[1, :4], hi[1, :4] = lo_min, hi_cap                 # whole pages
    page_ids = rng.integers(0, P, G).astype(np.int32)
    return lo, hi, page_ids, kpages, vals


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("mode", ["count", "sum", "full"])
@pytest.mark.parametrize("dtype,lw_pad", [(np.int32, 128), (np.float32, 256)],
                         ids=["i32_128", "f32_256"])
def test_page_scan_plain_matches_reference(dtype, lw_pad, mode, mask):
    lo, hi, pids, kp, vp = scan_case(dtype, lw_pad, seed=lw_pad)
    mv = MASK if mask else None
    want = ref_pscan.page_scan_bucketed(
        *map(jnp.asarray, (lo, hi, pids, kp, vp)), mode=mode,
        mask_value=mv, interpret=True)
    got = pt_pscan.page_scan_bucketed(
        *map(torch.from_numpy, (lo, hi, pids, kp, vp)), mode=mode,
        mask_value=mv)
    assert len(got) == len(want) == {"count": 2, "sum": 3, "full": 5}[mode]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.numpy().dtype == (np.int32 if i < 2 else vp.dtype)
        if i == 2:
            assert_sums(g.numpy(), w)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if dtype == np.int32 and mode != "count":             # the sums wrap
        lanes = np.where(np.arange(kp.shape[1]) < kp.shape[1] - 37, vp, 0)
        assert np.abs(lanes.astype(np.int64).sum(1)).max() > I32.max


@pytest.mark.parametrize("with_values", [False, True], ids=["count", "sum"])
@pytest.mark.parametrize("dtype,lw_pad", [(np.int32, 128), (np.float32, 256)],
                         ids=["i32_128", "f32_256"])
def test_page_prefix_plain_matches_reference(dtype, lw_pad, with_values):
    e, _, pids, kp, vp = scan_case(dtype, lw_pad, seed=lw_pad + 1)
    for mv in ((None, MASK) if with_values else (None,)):
        vals = vp if with_values else None
        want = ref_pscan.page_prefix_bucketed(
            jnp.asarray(e), jnp.asarray(pids), jnp.asarray(kp),
            None if vals is None else jnp.asarray(vals), mask_value=mv,
            interpret=True)
        got = pt_pscan.page_prefix_bucketed(
            torch.from_numpy(e), torch.from_numpy(pids), torch.from_numpy(kp),
            None if vals is None else torch.from_numpy(vals), mask_value=mv)
        if not with_values:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            continue
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert_sums(got[1].numpy(), want[1])


# in this order at sorted random slots of a row: an infinity or a NaN lies
# between every +1e30 and -1e30, so no range sums a cancelling pair (whose
# float sum would depend on the order of the adds)
SPECIAL_VALUES = np.array([1e30, np.nan, -0.0, 0.0, np.inf, 1e30, -np.inf,
                           -1e30, -0.0, np.nan, -1e30, 0.0], np.float32)


def special_scan_case(seed):
    """Sorted float32 pages of distinct keys whose values hold NaN, +-inf,
    +-1e30, -0.0 and +0.0 (page 0 only signed zeros), and [G, TQ] bound
    pairs over random slot runs, so special values fall both inside and
    outside the lanes' ranges; inert, whole-page and NaN bounds too."""
    rng = np.random.default_rng(seed)
    P, G, TQ, lw_pad, live = 4, 8, 32, 256, 219
    keys = np.arange(P * live, dtype=np.float32).reshape(P, live) * 0.5
    kpages = np.full((P, lw_pad), np.inf, np.float32)
    kpages[:, :live] = keys
    vals = rng.normal(size=(P, lw_pad)).astype(np.float32)
    for p in range(1, P):
        vals[p, np.sort(rng.choice(live, SPECIAL_VALUES.size,
                                   replace=False))] = SPECIAL_VALUES
    vals[0] = np.where(rng.random(lw_pad) < 0.5, -0.0, 0.0)
    vals[:, 5::11] = MASK
    page_ids = rng.integers(0, P, G).astype(np.int32)
    a = rng.integers(0, live, (G, TQ))
    b = np.minimum(a + rng.integers(0, 40, (G, TQ)), live - 1)
    lo = keys[page_ids[:, None], a]
    hi = keys[page_ids[:, None], b]
    lo_min, hi_cap, inert_lo, inert_hi = ref_scan._domain_consts(np.float32)
    lo[0, :3], hi[0, :3] = inert_lo, inert_hi
    lo[1, :3], hi[1, :3] = lo_min, hi_cap
    lo[2, :2], hi[2, 2:4] = np.nan, np.nan
    return lo, hi, page_ids, kpages, vals


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("mode", ["sum", "full"])
def test_page_scan_plain_special_values_match_reference(mode, mask):
    """NaN, +-inf, +-1e30 and signed zeros inside and outside the ranges:
    sums and counts as the reference gives them, min and max NaN where a
    NaN value is in range (jnp.min / jnp.max propagate it) and bit for bit
    elsewhere: -0.0 is the min and +0.0 the max of {-0.0, +0.0}."""
    lo, hi, pids, kp, vp = special_scan_case(seed=5)
    mv = MASK if mask else None
    want = ref_pscan.page_scan_bucketed(
        *map(jnp.asarray, (lo, hi, pids, kp, vp)), mode=mode,
        mask_value=mv, interpret=True)
    got = pt_pscan.page_scan_bucketed(
        *map(torch.from_numpy, (lo, hi, pids, kp, vp)), mode=mode,
        mask_value=mv)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 2:
            assert_sums(g.numpy(), w)
        else:                     # NaN only where both have it
            assert_bits(g.numpy(), w, f"output {i}")
    if mode == "full":            # the pages put NaN in some ranges, not all
        nan = np.isnan(got[3].numpy())
        assert nan.any() and not nan.all()
        np.testing.assert_array_equal(nan, np.isnan(got[4].numpy()))
        # page 0 holds only signed zeros: min -0.0 and max +0.0 where a
        # lane's range takes in both
        mn, mx = got[3].numpy(), got[4].numpy()
        assert (np.signbit(mn) & (mn == 0)).any()
        assert (~np.signbit(mx) & (mx == 0)).any()
    assert np.isinf(got[2].numpy()).any()


def test_page_scan_wrappers_take_plain_on_cpu():
    lo, hi, pids, kp, vp = scan_case(np.int32, 128, seed=3)
    args = [torch.from_numpy(a) for a in (lo, hi, pids, kp, vp)]
    got = pt_pscan.page_scan_bucketed(*args, mode="full")
    want = pt_pscan.page_scan_plain(*args, mode="full")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # count mode ignores the value pages and the mask (counts stay physical)
    cnt = pt_pscan.page_scan_bucketed(*args, mode="count", mask_value=MASK)
    assert all(torch.equal(g, w) for g, w in zip(cnt, want[:2]))
    pre = pt_pscan.page_prefix_bucketed(args[0], args[2], args[3])
    assert torch.equal(pre, want[0])
    assert pt_pscan.page_scan_bucketed.launches == 0
    assert pt_pscan.page_prefix_bucketed.launches == 0
    with pytest.raises(ValueError, match="needs value pages"):
        pt_pscan.page_scan_bucketed(*args[:4], mode="sum")
    with pytest.raises(ValueError, match="unknown scan mode"):
        pt_pscan.page_scan_bucketed(*args, mode="avg")
    empty = pt_pscan.page_scan_bucketed(
        torch.zeros((0, 32), dtype=torch.int32),
        torch.zeros((0, 32), dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), args[3], args[4], mode="full")
    assert [tuple(t.shape) for t in empty] == [(0, 32)] * 5


# -------------------------------------------------------------------- state
def test_agg_identities_and_domain_consts_match_reference():
    for dt in (np.int32, np.float32):
        assert pt_pscan.agg_identities(dt) == ref_pscan.agg_identities(dt)
        assert pt_scan._domain_consts(dt) == ref_scan._domain_consts(dt)
    for aggs in (None, ("count",), ("sum",), ("count", "max"), ("min",)):
        for has in (True, False):
            assert pt_scan.mode_for_aggs(aggs, has) == \
                ref_scan.mode_for_aggs(aggs, has)
    with pytest.raises(ValueError, match="unknown aggregates"):
        pt_scan.mode_for_aggs(("avg",), False)


@pytest.mark.parametrize("vdtype", [np.int32, np.float32])
def test_build_page_aux_matches_reference(vdtype):
    rng = np.random.default_rng(11)
    P, lw_pad = 37, 128
    cnt = np.full(P, 120)
    cnt[-1] = 17
    if vdtype == np.int32:
        vals = rng.integers(I32.min, I32.max, (P, lw_pad)).astype(vdtype)
    else:
        vals = rng.normal(size=(P, lw_pad)).astype(vdtype)
    vals[:, ::5] = MASK
    for mv in (None, MASK):
        want = ref_scan.build_page_aux(cnt, vals, vdtype, mask_value=mv)
        got = pt_scan.build_page_aux(cnt, vals, vdtype, mask_value=mv,
                                     device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    no_vals = pt_scan.build_page_aux(cnt, None, vdtype, device="cpu")
    for g, w in zip(no_vals, ref_scan.build_page_aux(cnt, None, vdtype)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    per = rng.integers(-99, 99, 1000).astype(np.int32)
    np.testing.assert_array_equal(
        pt_scan.sparse_table(per, np.maximum, I32.min),
        ref_scan.sparse_table(per, np.maximum, I32.min))


def test_floor_log2_exact_past_2_24():
    ks = np.arange(20, 31)
    x = np.unique(np.concatenate([
        np.arange(1, 4100), 2 ** ks - 1, 2 ** ks, 2 ** ks + 1,
        [2 ** 31 - 1, 2 ** 31 - 64, 2 ** 31 - 65, 2 ** 24 + 3]]))
    x = x.astype(np.int32)
    got = pt_scan._floor_log2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_scan._floor_log2(
        jnp.asarray(x))))
    np.testing.assert_array_equal(
        got, [int(v).bit_length() - 1 for v in x.tolist()])


def test_table_range_matches_reference():
    rng = np.random.default_rng(2)
    per = rng.integers(-1000, 1000, 300).astype(np.int32)
    st = pt_scan.sparse_table(per, np.minimum, I32.max)
    a = rng.integers(0, 301, 500).astype(np.int32)
    b = rng.integers(0, 301, 500).astype(np.int32)
    got = pt_scan._table_range(torch.from_numpy(st), torch.from_numpy(a),
                               torch.from_numpy(b), torch.minimum, I32.max)
    want = ref_scan._table_range(jnp.asarray(st), jnp.asarray(a),
                                 jnp.asarray(b), jnp.minimum, I32.max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ the slice
def make_case(name):
    """(keys, values, lo, hi, build kwargs) of a named scan case: hits,
    misses, point, inverted, one-page and whole-domain ranges."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    kw = {}
    if name.startswith("i32_"):
        n = int(name[4:])
        keys = rng.integers(-2**30, 2**30, n).astype(np.int32)
        vals = rng.integers(I32.min, I32.max, n).astype(np.int32)
        lo = np.concatenate([keys[rng.integers(0, n, 200)],
                             rng.integers(-2**30, 2**30, 100)])
        width = rng.integers(-2**24, 2**27, lo.size)
        whole = ([I32.min, I32.min], [I32.max - 1, 0])
    elif name.startswith("f32_"):
        n = int(name[4:])
        keys = (rng.normal(size=n) * 1e3).astype(np.float32)
        keys[:2] = [0.0, -0.0]
        vals = rng.normal(size=n).astype(np.float32)
        lo = np.concatenate([keys[rng.integers(0, n, 200)],
                             rng.normal(size=100) * 1e3])
        width = rng.normal(size=lo.size) * 300
        whole = ([-np.inf, -3.4e38], [3.4e38, 0.0])
    elif name == "zeros":          # values +-0.0, a few NaN and +-inf
        n = 4097
        keys = (rng.normal(size=n) * 1e3).astype(np.float32)
        keys[:2] = [0.0, -0.0]
        vals = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
        vals[rng.choice(n, 12, replace=False)] = np.repeat(
            [np.nan, np.inf, -np.inf], 4)
        lo = np.concatenate([keys[rng.integers(0, n, 200)],
                             rng.normal(size=100) * 1e3])
        width = np.abs(rng.normal(size=lo.size)) \
            * 10.0 ** rng.integers(0, 4, lo.size)
        whole = ([-np.inf, -3.4e38], [3.4e38, 0.0])
        kw = {"leaf_width": 128}
    else:                          # duplicate runs across narrow pages
        n = 5000
        keys = rng.integers(0, 40, n).astype(np.int32)
        vals = rng.integers(-100, 100, n).astype(np.int32)
        lo = np.concatenate([np.arange(-2, 44), np.zeros(46)])
        width = np.concatenate([np.zeros(46), np.arange(-2, 44)])
        whole = ([I32.min], [I32.max - 1])
        kw = {"leaf_width": 128}
    lo = np.concatenate([lo, whole[0]]).astype(keys.dtype)
    hi = np.concatenate([lo[:-len(whole[0])] + width, whole[1]]) \
        .astype(keys.dtype)
    hi[:7] = lo[:7]                                        # point ranges
    return keys, vals, lo, hi, kw


SLICE_CASES = ["i32_32768", "i32_32769", "f32_32769", "dups"]
MAT_K = 8


@pytest.fixture(scope="module")
def indexes():
    """(reference Index, port Index) per case, built once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            keys, vals, _, _, kw = make_case(name)
            cache[name] = (
                ref_core.build_index(keys, vals,
                                     ref_core.IndexConfig(kind="tiered",
                                                          **kw)),
                pt_core.build_index(keys, vals,
                                    pt_core.IndexConfig(kind="tiered", **kw),
                                    device="cpu"))
        return cache[name]
    return get


def assert_scan_same(got, want, fields):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
        elif f == "vsum":
            assert_sums(g.numpy(), w)
        else:
            assert_bits(g.numpy(), w, f)


ALL_FIELDS = ("count", "r_lo", "r_hi_excl", "vsum", "vmin", "vmax", "ranks",
              "values", "overflow")


@pytest.mark.parametrize("name", SLICE_CASES)
def test_scan_range_full_and_materialize_match_reference(name, indexes):
    ref_idx, pt_idx = indexes(name)
    _, _, lo, hi, _ = make_case(name)
    assert pt_idx.impl.top_kind == ref_idx.impl.top_kind
    want = ref_idx.scan_range(lo, hi, materialize=MAT_K)
    got = pt_idx.scan_range(lo, hi, materialize=MAT_K)
    assert_scan_same(got, want, ALL_FIELDS)
    assert bool(want.overflow.any()) and not bool(want.overflow.all())
    assert bool((lo > hi).any())
    # without materialize, the same aggregates
    assert_scan_same(pt_idx.scan_range(lo, hi), want, ALL_FIELDS[:6])
    # the scanner's value pages and aux are the reference's, bit for bit
    ref_sc = ref_scan.scanner_for(ref_idx.impl, ref_idx.values_sorted)
    pt_sc = pt_scan.scanner_for(pt_idx.impl, pt_idx.values_sorted)
    np.testing.assert_array_equal(pt_sc.vpages.numpy(),
                                  np.asarray(ref_sc.vpages))
    for g, w in zip(pt_sc.aux, ref_sc.aux):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scan_range_signed_zeros_match_reference(indexes):
    """Float32 keys whose values are +-0.0 with a few NaN and +-inf, over
    pages of 128 (interior pages come from the sparse tables): the full
    aggregates bit for bit, so vmin is -0.0 and vmax +0.0 wherever a range
    takes in both zeros and no NaN, as jnp.min / jnp.max give them."""
    ref_idx, pt_idx = indexes("zeros")
    _, _, lo, hi, _ = make_case("zeros")
    want = ref_idx.scan_range(lo, hi)
    got = pt_idx.scan_range(lo, hi)
    assert_scan_same(got, want, ALL_FIELDS[:6])
    mn, mx = np.asarray(want.vmin), np.asarray(want.vmax)
    assert (np.signbit(mn) & (mn == 0)).sum() > 10
    assert (~np.signbit(mx) & (mx == 0)).sum() > 10
    assert np.isnan(mn).any() and np.isinf(mn).any()


@pytest.mark.parametrize("name", ["i32_32768", "f32_32769", "dups"])
def test_search_range_and_count_depth_match_reference(name, indexes):
    ref_idx, pt_idx = indexes(name)
    _, _, lo, hi, _ = make_case(name)
    want = ref_idx.scan_range(lo, hi, aggs=("count",))
    got = pt_idx.scan_range(lo, hi, aggs=("count",))
    assert got.vsum is None and got.vmin is None
    assert_scan_same(got, want, ALL_FIELDS[:6])
    for g, w in zip(pt_idx.search_range(lo, hi), ref_idx.search_range(lo, hi)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bare = pt_tiered.search_range(pt_idx.impl, lo, hi)
    r_lo, r_hi, cnt = pt_tiered.search_range_raw(pt_idx.impl)(
        torch.from_numpy(lo), torch.from_numpy(hi), pt_idx.impl.pages)
    for a, b in zip((r_lo, r_hi, cnt), bare):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(bare[2].numpy(), np.asarray(want.count))


def test_scan_range_sum_depth_matches_reference(indexes):
    name = "i32_32769"
    ref_idx, pt_idx = indexes(name)
    _, _, lo, hi, _ = make_case(name)
    want = ref_idx.scan_range(lo, hi, aggs=("count", "sum"))
    got = pt_idx.scan_range(lo, hi, aggs=("count", "sum"))
    assert got.vmin is None and got.vmax is None
    assert_scan_same(got, want, ALL_FIELDS[:6])


def test_scan_empty_batch_matches_reference(indexes):
    ref_idx, pt_idx = indexes("i32_32769")
    z = np.zeros(0, np.int32)
    want = ref_idx.scan_range(z, z)
    got = pt_idx.scan_range(z, z)
    assert_scan_same(got, want, ALL_FIELDS[:6])
    m = pt_idx.scan_range(z, z, materialize=4)
    assert m.ranks.shape == m.values.shape == (0, 4)
    assert all(t.shape == (0,) for t in pt_idx.search_range(z, z))
    g = pt_idx.scan_groups(z, z, 4)
    assert g.edges.shape == (0, 5) and g.count.shape == (0, 4)
    mu = pt_idx.scan_multi(np.zeros((0, 3, 2), np.int32))
    assert mu.count.shape == (0,)


def test_scan_rank_only_index():
    keys = np.arange(0, 1000, 3, dtype=np.int32)
    ref_idx = ref_core.build_index(keys, config=ref_core.IndexConfig(
        kind="tiered", leaf_width=128))
    pt_idx = pt_core.build_index(keys, config=pt_core.IndexConfig(
        kind="tiered", leaf_width=128), device="cpu")
    lo, hi = np.array([0, 10, 5], np.int32), np.array([9, 8, 700], np.int32)
    got = pt_idx.scan_range(lo, hi)
    assert got.count.tolist() == [4, 0, 232]
    assert got.vsum is None and got.vmin is None and got.vmax is None
    m = pt_idx.scan_range(lo, hi, materialize=3)
    want = ref_idx.scan_range(lo, hi, materialize=3)
    assert m.values is None and want.values is None
    np.testing.assert_array_equal(m.ranks.numpy(), np.asarray(want.ranks))


def test_mutable_and_flat_scan_parts_raise():
    """The flat kinds' FlatAggregator (once unported, item 12B) aggregates
    rank intervals as numpy does (tests/test_torch_flat_api.py holds it
    to the reference's)."""
    v = np.array([4, -1, 7, 2], np.int32)
    fa = pt_scan.FlatAggregator(v, device="cpu")
    vsum, vmin, vmax = fa(np.array([0, 1, 2], np.int32),
                          np.array([4, 3, 2], np.int32))
    assert vsum.tolist() == [12, 6, 0]
    assert vmin.tolist() == [-1, -1, np.iinfo(np.int32).max]
    assert vmax.tolist() == [7, 7, np.iinfo(np.int32).min]
    # the mutable store's scan parts are ported (item 5B), and held to the
    # reference in tests/test_torch_store_scan.py
    make_agg, make_mat = pt_scan.make_delta_scan_fns(np.int32)
    assert callable(make_agg("full")) and callable(make_mat(4, "count"))
