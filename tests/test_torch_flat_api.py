"""The non-tiered kinds (binary, css, kary, fast, nitrogen) under the rest
of the facade, against the reference, on the CPU.

* ``engine.scan.FlatAggregator``: prefix sums and sparse tables built on
  the host as the reference builds them, so int32 sums wrap and float32
  sums are the reference's bits; min / max with its signed zeros; empty
  intervals, n = 1 and unsupported value dtypes;
* ``Index.scan_range`` / ``scan_groups`` / ``scan_multi`` of every flat
  kind, int32 and float32, field for field and bit for bit, with the
  mirrors of the reference's endpoint tests (float duplicates at hi,
  inverted bounds, unknown aggregates);
* ``specialize=True``: the kind's searcher bound to its arrays answers as
  the reference's specialized and args postures, and its scans as the
  port's args posture.

One query shape a reference jit: each compiles once a case.
"""
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.engine import scan as ref_scan

import repro_torch.core as pt_core
from repro_torch.engine import scan as pt_scan

torch.set_num_threads(1)

FLAT_KINDS = ("binary", "css", "kary", "fast", "nitrogen")
SCAN_FIELDS = ("count", "r_lo", "r_hi_excl", "vsum", "vmin", "vmax",
               "ranks", "values", "overflow")
GROUP_FIELDS = ("count", "edges", "r_edge", "vsum", "vmin", "vmax",
                "topk_values", "topk_ranks", "overflow")
# small structures, so a few thousand keys span several levels
SHAPE = dict(node_width=8, levels=2, compiled_node_width=3, page_depth=2)


def bits(x):
    a = np.asarray(x)
    return a if a.dtype == bool else a.view(np.uint8)


def assert_fields(got, want, fields, what):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f"{what}: {f} None-ness"
        if w is not None:
            np.testing.assert_array_equal(bits(g), bits(w),
                                          err_msg=f"{what}: {f}")


def _data(dtype, n=2000, seed=0):
    """Unique keys; values of the key dtype that wrap an int32 sum or hold
    signed zeros; ranges with inverted and whole-domain rows."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        keys = np.unique(rng.normal(size=n).astype(dtype))
        vals = rng.normal(size=keys.size).astype(dtype)
        vals[::5] = 0.0
        vals[1::5] = -0.0
        lo = np.sort(rng.normal(size=48)).astype(dtype)
        hi = (lo + rng.uniform(-0.1, 1.0, 48)).astype(dtype)
        lo[:2], hi[:2] = -np.inf, np.finfo(dtype).max
    else:
        keys = np.sort(rng.choice(1 << 20, n, replace=False)).astype(dtype)
        vals = rng.integers(-(1 << 31) + 1, (1 << 31) - 1,
                            keys.size).astype(np.int32)
        lo = np.sort(rng.integers(0, 1 << 20, 48)).astype(dtype)
        hi = (lo + rng.integers(-1000, 1 << 18, 48)).astype(dtype)
        lo[:2], hi[:2] = np.iinfo(dtype).min, np.iinfo(dtype).max - 1
    return keys, vals, lo, hi


def _both(kind, dtype, values=True, **cfg):
    keys, vals, lo, hi = _data(dtype)
    v = vals if values else None
    c = dict(SHAPE, kind=kind, **cfg)
    return (ref_core.build_index(keys, v, ref_core.IndexConfig(**c)),
            pt_core.build_index(keys, v, pt_core.IndexConfig(**c),
                                device="cpu"), lo, hi)


# --------------------------------------------------------- FlatAggregator
AGG_CASES = {
    "int32_wrap": np.array([2**31 - 1, 5, 2**31 - 7, -3, -2**31 + 1, 9,
                            2**30, 2**30, 2**30], np.int32),
    "float32": np.array([1e30, 1.5, -1e30, 3.25, 1e-7, -2.5, 7.0, 1e20],
                        np.float32),
    "signed_zeros": np.array([0.0, -0.0, 0.0, -0.0, -0.0, 0.0, 1.0, -0.0],
                             np.float32),
    "n1": np.array([-4], np.int32),
}


@pytest.mark.parametrize("case", list(AGG_CASES))
def test_flat_aggregator_matches_reference(case):
    v = AGG_CASES[case]
    n = v.size
    a, b = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    a, b = a.reshape(-1).astype(np.int32), b.reshape(-1).astype(np.int32)
    keep = b >= a                        # every interval, the empty ones too
    a, b = a[keep], b[keep]
    want = ref_scan.FlatAggregator(v)(a, b)
    fa = pt_scan.FlatAggregator(v, device="cpu")
    assert fa.ok and fa.device_bytes > 0
    got = fa(torch.from_numpy(a), torch.from_numpy(b))
    for g, w, f in zip(got, want, ("vsum", "vmin", "vmax")):
        np.testing.assert_array_equal(bits(g), bits(w), err_msg=f)
    # the same from a tensor of values, which keeps its device
    again = pt_scan.FlatAggregator(torch.from_numpy(v))(a, b)
    for g, w in zip(again, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.int16])
def test_flat_aggregator_unsupported_dtypes_not_ok(dtype):
    v = np.arange(6).astype(dtype)
    assert not ref_scan.FlatAggregator(v).ok
    assert not pt_scan.FlatAggregator(v, device="cpu").ok


def test_flat_aggregator_of_nothing_answers_identities():
    fa = pt_scan.FlatAggregator(np.zeros(0, np.int32), device="cpu")
    vsum, vmin, vmax = fa(torch.zeros(3, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32))
    assert vsum.tolist() == [0] * 3
    assert vmin.tolist() == [2**31 - 1] * 3
    assert vmax.tolist() == [-2**31] * 3


# -------------------------------------------------------- the kinds' scans
@pytest.mark.parametrize("kind", FLAT_KINDS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_flat_scans_match_reference(kind, dtype):
    ref, pt, lo, hi = _both(kind, dtype)
    assert_fields(pt.scan_range(lo, hi, materialize=6),
                  ref.scan_range(lo, hi, materialize=6), SCAN_FIELDS,
                  "scan_range")
    assert_fields(pt.scan_range(lo, hi, aggs=("count", "sum")),
                  ref.scan_range(lo, hi, aggs=("count", "sum")),
                  SCAN_FIELDS, "scan_range sum")
    assert_fields(pt.scan_groups(lo[:16], hi[:16], 8, top_k=3),
                  ref.scan_groups(lo[:16], hi[:16], 8, top_k=3),
                  GROUP_FIELDS, "scan_groups")
    ranges = np.stack([lo[:40].reshape(10, 4), hi[:40].reshape(10, 4)], -1)
    for op in ("union", "intersect"):
        assert_fields(pt.scan_multi(ranges, op=op),
                      ref.scan_multi(ranges, op=op), SCAN_FIELDS[:6],
                      f"scan_multi {op}")
    # the aggregator is built once and kept on the index
    assert pt._flat_agg() is pt._flat_agg()


@pytest.mark.parametrize("kind", ["binary", "nitrogen"])
def test_flat_scans_without_values_match_reference(kind):
    ref, pt, lo, hi = _both(kind, np.int32, values=False)
    assert_fields(pt.scan_range(lo, hi, materialize=4),
                  ref.scan_range(lo, hi, materialize=4), SCAN_FIELDS,
                  "scan_range")
    g = pt.scan_groups(lo[:8], hi[:8], 4)
    assert_fields(g, ref.scan_groups(lo[:8], hi[:8], 4), GROUP_FIELDS[:6],
                  "scan_groups")
    assert g.vsum is None
    with pytest.raises(ValueError, match="top_k needs"):
        pt.scan_groups(lo[:8], hi[:8], 4, top_k=2)


@pytest.mark.parametrize("kind", FLAT_KINDS)
def test_flat_scan_float_duplicates_at_hi_exact(kind):
    """Mirror of tests/test_engine_scan.py:134 through the scans: float
    keys equal to hi all count, and their values all sum."""
    keys = np.repeat(np.array([0.25, 0.5, 0.75], np.float32), 5)
    vals = np.arange(keys.size, dtype=np.int32)
    c = dict(SHAPE, kind=kind)
    pt = pt_core.build_index(keys, vals, pt_core.IndexConfig(**c),
                             device="cpu")
    ref = ref_core.build_index(keys, vals, ref_core.IndexConfig(**c))
    lo = np.array([0.25, 0.5], np.float32)
    hi = np.array([0.5, 0.5], np.float32)
    got = pt.scan_range(lo, hi)
    assert got.count.tolist() == [10, 5] and got.r_hi_excl.tolist() == [10,
                                                                       10]
    assert got.vsum.tolist() == [45, 35]
    assert_fields(got, ref.scan_range(lo, hi), SCAN_FIELDS[:6], kind)


@pytest.mark.parametrize("kind", FLAT_KINDS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_flat_scan_inverted_bounds_normalize_empty(kind, dtype):
    """Mirror of tests/test_engine_scan.py:149 through scan_range: lo > hi
    is the empty interval anchored at rank(lo), identities for min / max."""
    keys = np.arange(0, 100, 1).astype(dtype)
    pt = pt_core.build_index(keys, keys.astype(np.int32),
                             pt_core.IndexConfig(**SHAPE, kind=kind),
                             device="cpu")
    r = pt.scan_range(np.array([50, 10, 99], dtype),
                      np.array([10, 50, 0], dtype))
    assert r.count.tolist() == [0, 41, 0]
    assert r.r_lo.tolist() == [50, 10, 99]
    assert r.r_hi_excl.tolist() == [50, 51, 99]
    assert r.vsum.tolist() == [0, 1230, 0]
    assert r.vmin.tolist() == [2**31 - 1, 10, 2**31 - 1]
    assert r.vmax.tolist() == [-2**31, 50, -2**31]


def test_flat_scan_rejects_unknown_aggs():
    """Mirror of tests/test_engine_scan.py:450 on css, valued and
    value-less alike; the other entry points validate too."""
    keys = np.arange(64, dtype=np.int32)
    lo, hi = np.array([1], np.int32), np.array([5], np.int32)
    for vals in (keys, None):
        idx = pt_core.build_index(keys, vals, pt_core.IndexConfig(kind="css"),
                                  device="cpu")
        with pytest.raises(ValueError, match="unknown aggregates"):
            idx.scan_range(lo, hi, aggs=("avg",))
        with pytest.raises(ValueError, match="unknown aggregates"):
            idx.scan_groups(lo, hi, 2, aggs=("avg",))
    with pytest.raises(ValueError, match="num_groups"):
        idx.scan_groups(lo, hi, 0)
    with pytest.raises(ValueError, match="multi-range op"):
        idx.scan_multi(np.zeros((1, 1, 2), np.int32), op="xor")
    with pytest.raises(ValueError, match=r"\[Q, R, 2\]"):
        idx.scan_multi(np.zeros((1, 2), np.int32))


# ------------------------------------------------------- specialization
def _spec_data(dtype, n=4000, seed=0):
    """tests/test_specialize.py's data: unique keys, values 0..n-1, every
    seventh key and misses."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        keys = np.unique(rng.normal(size=n).astype(dtype))
        qs = np.concatenate([keys[::7], rng.normal(
            size=n // 4).astype(dtype)])
    else:
        keys = np.sort(rng.choice(1 << 20, n, replace=False)).astype(dtype)
        qs = np.concatenate([keys[::7], (keys[::11] + 1).astype(dtype)])
    return keys, np.arange(keys.size, dtype=np.int32), qs


@pytest.mark.parametrize("kind", FLAT_KINDS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_specialized_matches_args_posture(kind, dtype):
    """Mirror of tests/test_specialize.py::test_specialized_matches_args_
    posture over the flat kinds: the bound searcher (the closure armed
    once on the CPU) answers searches and lookups as the reference's
    specialized and args postures, and its scans as the port's args
    posture."""
    keys, vals, qs = _spec_data(dtype)
    refs = [ref_core.build_index(keys, vals, ref_core.IndexConfig(
        kind=kind, specialize=s)) for s in (True, False)]
    args = pt_core.build_index(keys, vals, pt_core.IndexConfig(kind=kind),
                               device="cpu")
    spec = pt_core.build_index(keys, vals, pt_core.IndexConfig(
        kind=kind, specialize=True), device="cpu")
    assert args.captures is None and args.spec_search is None
    assert spec.captures.n == 1
    for ref in refs:
        np.testing.assert_array_equal(spec.search(qs).numpy(),
                                      np.asarray(ref.search(qs)))
        got, want = spec.lookup(qs), ref.lookup(qs)
        for f in ("rank", "found", "values"):
            np.testing.assert_array_equal(bits(getattr(got, f)),
                                          bits(getattr(want, f)), err_msg=f)
    lo = keys[::131]
    hi = lo + (np.float32(0.5) if np.dtype(dtype).kind == "f"
               else np.int32(5000))
    assert_fields(spec.scan_range(lo, hi, materialize=4),
                  args.scan_range(lo, hi, materialize=4), SCAN_FIELDS,
                  "specialized scan_range")
    assert spec.captures.n == 1          # calls replay, they arm nothing
