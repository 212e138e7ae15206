"""Kernel modules of the PyTorch port against the reference Pallas kernels.

The same numpy inputs go through the reference kernel (interpret mode, as
tests/test_kernels.py runs it) and the port's plain PyTorch version on the
CPU; ranks must be bit-identical. The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import kary as ref_kary_core
from repro.engine import schedule as ref_schedule
from repro.kernels import kary_search as ref_kary
from repro.kernels import ops as ref_ops
from repro.kernels import page_search as ref_page

from repro_torch.core import kary as pt_kary_core
from repro_torch.kernels import kary_search as pt_kary
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels import page_scan as pt_pscan
from repro_torch.kernels import page_search as pt_page

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)


# ------------------------------------------------------------- page search
def page_case(dtype, leaf_width, num_pages, q_n, tile, seed, skew=False):
    """Sentinel-padded pages, a query batch bucketed by page with the
    reference host plan: (qb [G, tile], step_pages [G], pages)."""
    rng = np.random.default_rng(seed)
    n = leaf_width * num_pages - leaf_width // 3          # partial last page
    if dtype == np.int32:
        keys = np.sort(rng.integers(-2**30, 2**30, n)).astype(np.int32)
        q = rng.integers(-2**30, 2**30, q_n).astype(np.int32)
        sent = I32.max
    else:
        keys = np.sort(rng.normal(scale=1e3, size=n)).astype(np.float32)
        q = rng.normal(scale=1e3, size=q_n).astype(np.float32)
        sent = np.inf
    if skew:
        q[: q_n * 3 // 4] = keys[leaf_width + 5]          # one hot page
    lw_pad = -(-leaf_width // 128) * 128
    pages = np.full((num_pages, lw_pad), sent, dtype)
    flat = np.full(num_pages * leaf_width, sent, dtype)
    flat[:n] = keys
    pages[:, :leaf_width] = flat.reshape(num_pages, leaf_width)
    pids = np.minimum(np.searchsorted(pages[:, leaf_width - 1], q),
                      num_pages - 1).astype(np.int32)
    plan = ref_schedule.bucket_plan(pids, tile)
    src = q if q_n else np.zeros(1, dtype)
    qb = src[plan.gather].reshape(plan.grid, tile)
    return qb, plan.step_pages, pages, lw_pad


def ref_page_search(qb, step_pages, pages, stride):
    return np.asarray(ref_page.page_search_bucketed(
        jnp.asarray(qb), jnp.asarray(step_pages), jnp.asarray(pages),
        stride=stride, interpret=True))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("leaf_width", [100, 200])        # lw_pad 128, 256
@pytest.mark.parametrize("stride_of", ["leaf_width", "lw_pad"])
def test_page_search_plain_matches_reference(dtype, leaf_width, stride_of):
    qb, sp, pages, lw_pad = page_case(dtype, leaf_width, 12, 700, 64,
                                      seed=leaf_width)
    stride = leaf_width if stride_of == "leaf_width" else lw_pad
    got = pt_page.page_search_plain(torch.from_numpy(qb),
                                    torch.from_numpy(sp),
                                    torch.from_numpy(pages), stride=stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  ref_page_search(qb, sp, pages, stride))


def test_page_search_plain_skewed_buckets():
    """Most queries hit one page, so its bucket spans several steps."""
    qb, sp, pages, _ = page_case(np.int32, 128, 9, 900, 64, seed=5,
                                 skew=True)
    assert (sp == 1).sum() >= 2                           # page 1 is hot
    got = pt_page.page_search_plain(torch.from_numpy(qb),
                                    torch.from_numpy(sp),
                                    torch.from_numpy(pages), stride=128)
    np.testing.assert_array_equal(got.numpy(),
                                  ref_page_search(qb, sp, pages, 128))


def test_page_search_plain_chunks_over_steps(monkeypatch):
    """Chunking the [steps, TQ, lw_pad] compare changes nothing."""
    qb, sp, pages, _ = page_case(np.float32, 128, 20, 1500, 32, seed=9)
    args = (torch.from_numpy(qb), torch.from_numpy(sp),
            torch.from_numpy(pages))
    whole = pt_page.page_search_plain(*args, stride=128)
    monkeypatch.setattr(pt_page, "_PLAIN_CHUNK_ELEMS", 32 * 128 * 3)
    np.testing.assert_array_equal(
        pt_page.page_search_plain(*args, stride=128).numpy(), whole.numpy())


def test_page_search_empty_batch():
    """Q == 0: the host plan's one all-masked step, and a zero-step grid."""
    qb, sp, pages, _ = page_case(np.int32, 128, 4, 0, 64, seed=1)
    assert qb.shape == (1, 64)
    got = pt_page.page_search_bucketed(torch.from_numpy(qb),
                                       torch.from_numpy(sp),
                                       torch.from_numpy(pages), stride=128)
    np.testing.assert_array_equal(got.numpy(),
                                  ref_page_search(qb, sp, pages, 128))
    none = pt_page.page_search_bucketed(
        torch.zeros((0, 64), dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), torch.from_numpy(pages),
        stride=128)
    assert none.shape == (0, 64)


def test_page_search_wrapper_takes_plain_on_cpu():
    qb, sp, pages, _ = page_case(np.int32, 128, 6, 300, 64, seed=2)
    before = pt_page.page_search_bucketed.launches
    args = (torch.from_numpy(qb), torch.from_numpy(sp),
            torch.from_numpy(pages))
    got = pt_page.page_search_bucketed(*args, stride=128)
    assert pt_page.page_search_bucketed.launches == before == 0
    np.testing.assert_array_equal(
        got.numpy(), pt_page.page_search_plain(*args, stride=128).numpy())


# ------------------------------------------------------------- k-ary search
def kary_keys(kind, n, rng):
    if kind == "int32":
        return np.unique(rng.integers(-2**30, 2**30, n)).astype(np.int32)
    if kind == "int32_extremes":
        lo = I32.min + np.arange(n // 2)
        hi = I32.max - 1 - np.arange(n - n // 2)
        return np.unique(np.concatenate([lo, hi])).astype(np.int32)
    # no subnormals: XLA's CPU backend flushes them to zero in compares, so
    # the reference is not IEEE there (test_kary_plain_subnormal_keys)
    mags = rng.normal(size=n) * 10.0 ** rng.integers(-30, 30, n)
    vals = np.concatenate([mags, [0.0, -0.0, -1.0, 3.4e38, -3.4e38]])
    return np.sort(vals.astype(np.float32), kind="stable")


def kary_queries(keys, rng, q_n=900):
    if keys.dtype == np.int32:
        extra = np.array([I32.min, I32.min + 1, I32.max - 1, I32.max - 2, 0,
                          -1], np.int32)
        rand = rng.integers(I32.min, I32.max - 1, q_n,
                            dtype=np.int64).astype(np.int32)
    else:
        extra = np.array([0.0, -0.0, -np.inf, 3.4e38, -3.4e38, 1.2e-38,
                          -1.2e-38], np.float32)
        rand = (rng.normal(size=q_n) * 10.0 ** rng.integers(-30, 30, q_n)
                ).astype(np.float32)
    return np.concatenate([rand, keys[::7], extra]).astype(keys.dtype)


@pytest.mark.parametrize("kind", ["int32", "int32_extremes", "float32"])
@pytest.mark.parametrize("n_keys", [100, 8192])             # depth 1 and 2
def test_kary_plain_matches_reference(kind, n_keys):
    rng = np.random.default_rng(n_keys)
    keys = kary_keys(kind, n_keys, rng)
    ref_idx = ref_kary_core.build(keys, node_width=127)
    pt_idx = pt_kary_core.build(keys, node_width=127, device="cpu")
    assert pt_idx.depth == ref_idx.depth == (1 if n_keys < 127 else 2)
    np.testing.assert_array_equal(pt_idx.tree.numpy(),
                                  np.asarray(ref_idx.tree))
    ref_levels = ref_ops.kary_levels(ref_idx, 128)
    pt_levels = pt_ops.kary_levels(pt_idx, 128)
    for a, b in zip(pt_levels, ref_levels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    q = kary_queries(keys, rng)
    pad = -(-q.size // 1024) * 1024 - q.size
    want = np.asarray(ref_kary.kary_search_tiled(
        jnp.asarray(np.concatenate([q, np.zeros(pad, q.dtype)]))
        .reshape(-1, 128), ref_levels, fanout=128, tile_rows=8,
        interpret=True)).reshape(-1)[:q.size]
    flat, offsets = pt_kary.flatten_levels(pt_levels)
    got = pt_kary.kary_search_plain(torch.from_numpy(q), flat, offsets,
                                    fanout=128, wpad=128)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the core's plain search gives the same rank, clipped to n
    np.testing.assert_array_equal(
        pt_kary_core.search(pt_idx, torch.from_numpy(q)).numpy(),
        np.minimum(want, keys.size))


def test_kary_plain_subnormal_keys():
    """Subnormal keys compare as IEEE says (as numpy does), where the
    reference on XLA's CPU backend flushes them to zero."""
    tiny = np.float32(1e-45)
    keys = np.array([-2 * tiny, -tiny, -0.0, tiny, 2 * tiny, 1.0], np.float32)
    idx = pt_kary_core.build(keys, node_width=3, device="cpu")
    q = np.concatenate([keys, [0.0, 3 * tiny, -3 * tiny]]).astype(np.float32)
    np.testing.assert_array_equal(
        pt_kary_core.search(idx, torch.from_numpy(q)).numpy(),
        np.searchsorted(keys, q, side="left"))


@pytest.mark.parametrize("w", [3, 7])
def test_kary_plain_narrow_nodes_match_reference(w):
    """Narrow nodes and lanes (tests/test_kernels.py's shapes): depth > 2."""
    rng = np.random.default_rng(w)
    keys = np.unique(rng.integers(-2**30, 2**30, 257)).astype(np.int32)
    ref_idx = ref_kary_core.build(keys, node_width=w)
    pt_idx = pt_kary_core.build(keys, node_width=w, device="cpu")
    ref_levels = ref_ops.kary_levels(ref_idx, 8)
    q = kary_queries(keys, rng, q_n=100)[:112]
    want = np.asarray(ref_kary.kary_search_tiled(
        jnp.asarray(q).reshape(-1, 8), ref_levels, fanout=w + 1,
        tile_rows=2, interpret=True)).reshape(-1)
    flat, offsets = pt_kary.flatten_levels(pt_ops.kary_levels(pt_idx, 8))
    got = pt_kary.kary_search_levels(torch.from_numpy(q), flat, offsets,
                                     fanout=w + 1, wpad=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kary_wrapper_takes_plain_on_cpu_and_empty_batch():
    keys = np.arange(0, 40000, 5, dtype=np.int32)
    idx = pt_kary_core.build(keys, node_width=127, device="cpu")
    flat, offsets = pt_kary.flatten_levels(pt_ops.kary_levels(idx, 128))
    q = torch.arange(-3, 40010, 7, dtype=torch.int32)
    got = pt_kary.kary_search_levels(q, flat, offsets, fanout=128, wpad=128)
    assert pt_kary.kary_search_levels.launches == 0
    np.testing.assert_array_equal(
        got.numpy(), np.searchsorted(keys, q.numpy(), side="left"))
    empty = pt_kary.kary_search_levels(torch.zeros(0, dtype=torch.int32),
                                       flat, offsets, fanout=128, wpad=128)
    assert empty.shape == (0,) and empty.dtype == torch.int32


# ------------------------------------- the sorted-row contract of the kernels
def bound_mirror(rows: np.ndarray, q: np.ndarray, pred=np.less) -> np.ndarray:
    """The CUDA kernels' branch-free binary search (csrc/sorted_page.cuh:
    ``lower_bound`` with ``pred`` <, ``upper_bound_le`` with <=;
    csrc/kary_search.cu), step for step, over pairs (rows[i], q[i]): the
    answer lies in [base, base + n] and each step halves n."""
    at = np.arange(q.size)
    base = np.zeros(q.size, np.int64)
    n = rows.shape[1]
    while n > 1:
        half = n >> 1
        base = np.where(pred(rows[at, base + half], q), base + half, base)
        n -= half
    return base + pred(rows[at, base], q)


def contract_keys(dtype, n, rng):
    """Heavy duplicate runs; float32 keys mix -0.0 and +0.0."""
    keys = rng.integers(-500, 500, n)
    if dtype == np.int32:
        return keys.astype(np.int32)
    keys = (keys * 0.25).astype(np.float32)
    zeros = np.flatnonzero(keys == 0)
    keys[zeros[::2]] = -0.0
    return keys


@pytest.mark.parametrize("pred", [np.less, np.less_equal],
                         ids=["lower_bound", "upper_bound_le"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("n", [32768, 32769])    # NitroGen / k-ary top
def test_kernel_rows_are_sorted_and_binary_search_equals_count(dtype, n,
                                                               pred):
    """The k-ary, page-search and page-scan kernels replace the TPU
    kernels' counts #{row < q} and #{row <= q} by binary searches, exact
    only on nondecreasing rows: every row of ops.kary_levels and every page
    of the tiered index is sorted, and on them the kernels' search loops
    equal the counts, for ties, the sentinel, signed zeros, infinities and
    NaN (the k-ary kernel takes only the lower bound)."""
    from repro_torch.engine import tiered as pt_tiered
    rng = np.random.default_rng(n)
    keys = contract_keys(dtype, n, rng)
    idx = pt_tiered.build(keys, device="cpu")
    assert idx.top_kind == ("nitrogen" if n == 32768 else "kary")
    tops = [pt_kary_core.build(keys, node_width=127, device="cpu")]
    if idx.top_kind == "kary":
        tops.append(idx.top)
    row_sets = [idx.pages.numpy()] + [lvl.numpy() for top in tops
                                      for lvl in pt_ops.kary_levels(top, 128)]
    if dtype == np.int32:
        special = np.array([I32.min, -1, 0, I32.max - 1, I32.max], dtype)
    else:
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-30],
                           dtype)
    for rows in row_sets:
        assert (rows[:, 1:] >= rows[:, :-1]).all()
        pick = rng.integers(0, rows.shape[0], 6000)
        own = rows[pick, rng.integers(0, rows.shape[1], 6000)]
        if dtype == np.int32:
            near = own.astype(np.int64) + rng.integers(-1, 2, 6000)
            near = np.clip(near, I32.min, I32.max).astype(dtype)
        else:
            near = np.nextafter(own, np.where(rng.random(6000) < 0.5,
                                              dtype(-np.inf), dtype(np.inf)))
        q = np.concatenate([own, near, np.resize(special, 6000)])
        r = rows[np.concatenate([pick, pick, pick])]
        np.testing.assert_array_equal(bound_mirror(r, q, pred),
                                      pred(r, q[:, None]).sum(1))


# ------------------------------- the page-scan kernel's range aggregates
GROUP, GROUPS = 8, 256                  # csrc/page_scan.cu kGroup, kGroups


def nan_min(a, b):
    return a if (a < b or a != a) else b     # the kernel's NaN-first combine


def nan_max(a, b):
    return a if (a > b or a != a) else b


@np.errstate(over="ignore", invalid="ignore")   # int32 wraps, inf - inf
def range_aggregate_mirror(v, a, b, mask=None):
    """The page-scan kernel's value-mode query (csrc/page_scan.cu), step for
    step, over slots [a, b) of one staged value row v of at most 2048
    slots: group aggregates over 8 slots (slots past the row and masked
    slots left out), a segment tree of group sums and sparse tables of
    group minima and maxima built once, then per range at most 7 edge
    slots at each end, the tree over the whole groups and two overlapping
    table windows. Sums in uint32 (int32) or float64 (float32)."""
    acc = np.uint32 if v.dtype == np.int32 else np.float64
    id_min, id_max = pt_pscan.agg_identities(v.dtype)
    take = np.ones(v.size, bool) if mask is None else v != mask
    pad = GROUP * GROUPS - v.size
    tree = np.zeros(2 * GROUPS, acc)
    tree[GROUPS:] = np.pad(np.where(take, v, 0).astype(acc), (0, pad)
                           ).reshape(GROUPS, GROUP).sum(1, dtype=acc)
    for n0 in (128, 64, 32, 16, 8, 4, 2, 1):
        tree[n0:2 * n0] = tree[2 * n0:4 * n0:2] + tree[2 * n0 + 1:4 * n0:2]
    tmin = np.full((8, GROUPS), id_min, v.dtype)
    tmax = np.full((8, GROUPS), id_max, v.dtype)
    for t, ident, comb in ((tmin, id_min, np.minimum), (tmax, id_max,
                                                         np.maximum)):
        # np.minimum / np.maximum propagate NaN, as nan_min / nan_max do
        t[0] = comb.reduce(np.pad(np.where(take, v, ident), (0, pad),
                                  constant_values=ident
                                  ).reshape(GROUPS, GROUP), axis=1)
        for j in range(1, 8):
            w = 1 << (j - 1)
            t[j, :GROUPS - 2 * w + 1] = comb(t[j - 1, :GROUPS - 2 * w + 1],
                                             t[j - 1, w:GROUPS - w + 1])
    out = []
    for lo, hi in zip(a, b):
        s_, mn, mx = acc(0), id_min, id_max
        if hi > lo:
            ga, gb = -(-lo // GROUP), hi // GROUP
            whole = ga < gb
            edge = list(range(lo, ga * GROUP if whole else hi))
            if whole:
                edge += list(range(gb * GROUP, hi))
            for s in edge:
                if take[s]:
                    s_ += acc(v[s])
                    mn, mx = nan_min(mn, v[s]), nan_max(mx, v[s])
            if whole:
                l, r = ga + GROUPS, gb + GROUPS
                while l < r:
                    if l & 1:
                        s_ += tree[l]
                        l += 1
                    if r & 1:
                        r -= 1
                        s_ += tree[r]
                    l, r = l >> 1, r >> 1
                k = min(int(gb - ga).bit_length() - 1, 7)
                mn = nan_min(mn, nan_min(tmin[k, ga], tmin[k, gb - (1 << k)]))
                mx = nan_max(mx, nan_max(tmax[k, ga], tmax[k, gb - (1 << k)]))
        out.append((s_, mn, mx))
    return [np.array(x) for x in zip(*out)]


@pytest.mark.parametrize("mask", [None, -7])
@pytest.mark.parametrize("dtype,n", [(np.int32, 2048), (np.float32, 2048),
                                     (np.float32, 130)])
@np.errstate(over="ignore", invalid="ignore")
def test_range_aggregate_mirror_equals_masked_reduction(dtype, n, mask):
    """On runs [a, b) of one row, the kernel's range query equals the
    direct masked reduction: empty, single-slot and whole-row runs, runs
    that start or end on an 8-slot group boundary, masked slots; float
    rows hold NaN, +-inf, +-1e30 and signed zeros inside and outside the
    runs (min and max NaN where a NaN is in the run, and no infinity or
    NaN outside a run reaches its sum)."""
    rng = np.random.default_rng(n + (mask or 0))
    if dtype == np.int32:
        v = rng.integers(I32.min, I32.max, n, dtype=np.int64).astype(dtype)
    else:
        v = rng.normal(size=n).astype(dtype)
        v[np.sort(rng.choice(n, 12, replace=False))] = [
            1e30, np.nan, -0.0, 0.0, np.inf, 1e30, -np.inf, -1e30, -0.0,
            np.nan, -1e30, 0.0]
    v[3::11] = -7
    a = rng.integers(0, n + 1, 200)
    b = np.minimum(a + rng.integers(0, 300, 200), n)
    g = rng.integers(0, n // GROUP, 40) * GROUP
    a = np.concatenate([a, [0, 0, n, 5, 5, 9, 17], g, g + 1, g - 1 + (g == 0)])
    b = np.concatenate([b, [n, 0, n, 5, 6, 4, 23], np.minimum(g + 64, n),
                        g + 8, np.minimum(g + GROUP * 3, n)])
    got = range_aggregate_mirror(v, a, b, mask)
    acc = np.uint32 if dtype == np.int32 else np.float64
    id_min, id_max = pt_pscan.agg_identities(dtype)
    take = np.ones(n, bool) if mask is None else v != mask
    want = [[], [], []]
    for lo, hi in zip(a, b):
        m = np.zeros(n, bool)
        m[lo:hi] = take[lo:hi]
        want[0].append(np.where(m, v, 0).astype(acc).sum(dtype=acc))
        want[1].append(np.where(m, v, id_min).min())
        want[2].append(np.where(m, v, id_max).max())
    if dtype == np.int32:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    if dtype == np.float32:
        assert np.isnan(got[1]).any() and not np.isnan(got[1]).all()
