"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip on a machine without an NVIDIA card (a CUDA
kernel has no CPU mode). This file imports neither jax nor the reference
package, so it runs where only the port's dependencies are installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.core import kary as kary_core
from repro_torch.engine import schedule, tiered
from repro_torch.kernels import kary_search as kk
from repro_torch.kernels import ops
from repro_torch.kernels import page_scan as ps
from repro_torch.kernels import page_search as pk

I32 = np.iinfo(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("leaf_width", [100, 2000])       # lw_pad 128, 2048
def test_page_kernel_matches_plain(cuda, dtype, leaf_width):
    rng = np.random.default_rng(leaf_width)
    keys = rng.normal(size=leaf_width * 300) * 1e6
    q = rng.normal(size=5000) * 1e6
    idx = tiered.build(keys.astype(dtype), leaf_width=leaf_width, device=cuda)
    qd = torch.from_numpy(q.astype(dtype)).to(cuda)
    g_cap = schedule.ladder_grid(qd.shape[0], idx.tile, idx.num_pages)
    plan = schedule.device_plan(idx.page_of(qd), idx.tile, g_cap,
                                idx.num_pages)
    qb =torch.zeros(g_cap * idx.tile, dtype=qd.dtype, device=cuda) \
        .scatter_(0, plan.dest.long(), qd).view(g_cap, idx.tile)
    used = int(plan.steps_used)
    assert used < g_cap
    got = pk.page_search_bucketed(qb, plan.step_pages, idx.pages,
                                  stride=idx.lw_pad,
                                  steps_used=plan.steps_used)
    want = pk.page_search_plain(qb, plan.step_pages, idx.pages,
                                stride=idx.lw_pad)
    torch.cuda.synchronize()
    assert torch.equal(got[:used], want[:used])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("n_keys,depth", [(100, 1), (8192, 2), (20000, 3)])
def test_kary_kernel_matches_plain(cuda, dtype, n_keys, depth):
    """Depth 1 and 2 are staged in shared memory; at depth 3 the third
    level (16,384 rows) is binary-searched in device memory. Keys carry
    duplicate runs; queries include the sentinel and, for float32, signed
    zeros, infinities and NaN."""
    rng = np.random.default_rng(4 + n_keys)
    if dtype == np.int32:
        half = n_keys // 2
        keys = np.concatenate([I32.min + np.arange(half),
                               I32.max - 1 - np.arange(n_keys - half)])
        q = rng.integers(I32.min, I32.max, 20000, dtype=np.int64)
        edge = [I32.min, I32.min + 1, I32.max - 1, I32.max]
    else:
        keys = rng.normal(size=n_keys) * 10.0 ** rng.integers(-30, 30, n_keys)
        keys[:4] = [0.0, -0.0, 0.0, -0.0]
        q = rng.normal(size=20000) * 10.0 ** rng.integers(-30, 30, 20000)
        edge = [0.0, -0.0, np.inf, -np.inf, np.nan]
    keys = np.sort(keys.astype(dtype))
    keys[1::4] = keys[::4][:keys[1::4].size]             # duplicate runs
    keys = np.sort(keys)
    idx = kary_core.build(keys, node_width=127, device=cuda)
    assert idx.depth == depth
    flat, offsets = kk.flatten_levels(ops.kary_levels(idx, 128))
    qd = torch.from_numpy(np.concatenate([q, keys, edge]).astype(dtype)
                          ).to(cuda)
    got = kk.kary_search_levels(qd, flat, offsets, fanout=128, wpad=128)
    want = kk.kary_search_plain(qd, flat, offsets, fanout=128, wpad=128)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kk.kary_search_levels(qd[:0], flat, offsets, fanout=128,
                                 wpad=128).shape == (0,)


@pytest.mark.cuda
def test_kary_kernel_rejects_a_level_zero_row_too_wide(cuda):
    limit = kk.smem_limit(cuda)
    wpad = limit // 4 + 4
    flat = torch.full((wpad,), I32.max, dtype=torch.int32, device=cuda)
    q = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        kk.kary_search_levels(q, flat, (0,), fanout=wpad + 1, wpad=wpad)


def scan_lanes(cuda, dtype, leaf_width, rng):
    """Bound pairs bucketed by page as the span pipeline buckets them:
    (index, lo_b, hi_b, step_pages, steps_used, value pages)."""
    keys = rng.normal(size=leaf_width * 300) * 1e6
    idx = tiered.build(keys.astype(dtype), leaf_width=leaf_width, device=cuda)
    lo = torch.from_numpy((rng.normal(size=5000) * 1e6).astype(dtype)).to(cuda)
    hi = lo + torch.from_numpy(
        (rng.normal(size=5000) * 1e4).astype(dtype)).to(cuda)
    g_cap = schedule.ladder_grid(lo.shape[0], idx.tile, idx.num_pages)
    plan = schedule.edge_scan_plan(idx.page_of(lo), idx.tile, g_cap,
                                   idx.num_pages)
    lanes = [torch.zeros(g_cap * idx.tile, dtype=lo.dtype, device=cuda)
             .scatter_(0, plan.dest.long(), x).view(g_cap, idx.tile)
             for x in (lo, hi)]
    vals = rng.integers(-2**31, 2**31 - 1, idx.pages.shape) \
        if dtype == np.int32 else rng.normal(size=idx.pages.shape)
    vpages = torch.from_numpy(vals.astype(dtype)).to(cuda)
    vpages.view(-1)[::13] = -7
    return idx, *lanes, plan.step_pages, plan.steps_used, vpages


def same_values(g, w):
    """Equal as values, NaN only where both have it (-0.0 == 0.0); integer
    tensors bit for bit."""
    if not g.is_floating_point():
        return torch.equal(g, w)
    nan = torch.isnan(g)
    return torch.equal(nan, torch.isnan(w)) and torch.equal(g[~nan], w[~nan])


def same_bits(g, w):
    """As same_values, and every non-NaN lane with the same sign bit:
    -0.0 and +0.0 differ here, as their bits do."""
    if not same_values(g, w):
        return False
    if not g.is_floating_point():
        return True
    num = ~torch.isnan(w)
    return torch.equal(torch.signbit(g[num]), torch.signbit(w[num]))


def assert_kernel_matches(got, want, used, sum_at):
    """Counts, int32 sums, min and max bit for bit (NaN where the plain
    version has it, -0.0 where it has -0.0); float sums to rtol 1e-4, NaN
    at the same lanes (the kernel adds in double in its own order, the
    plain version in float32 in torch's)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if i == sum_at and g.dtype == torch.float32:
            torch.testing.assert_close(g[:used], w[:used], rtol=1e-4,
                                       atol=1e-4, equal_nan=True)
        else:
            assert same_bits(g[:used], w[:used]), f"output {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [None, -7])
@pytest.mark.parametrize("mode", ["count", "sum", "full"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("leaf_width", [100, 2000])       # lw_pad 128, 2048
def test_page_scan_kernel_matches_plain(cuda, dtype, leaf_width, mode, mask):
    rng = np.random.default_rng(leaf_width + 7)
    idx, lo_b, hi_b, sp, used_t, vpages = scan_lanes(cuda, dtype, leaf_width,
                                                      rng)
    used = int(used_t)
    assert used < sp.shape[0]
    got = ps.page_scan_bucketed(lo_b, hi_b, sp, idx.pages, vpages, mode=mode,
                                mask_value=mask, steps_used=used_t)
    want = ps.page_scan_plain(lo_b, hi_b, sp, idx.pages,
                              None if mode == "count" else vpages, mode=mode,
                              mask_value=None if mode == "count" else mask)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    assert_kernel_matches(got, want, used, sum_at=2)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [None, -7])
@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("leaf_width", [100, 2000])       # lw_pad 128, 2048
def test_page_prefix_kernel_matches_plain(cuda, dtype, with_values, mask,
                                          leaf_width):
    rng = np.random.default_rng(11)
    idx, e_b, _, sp, used_t, vpages = scan_lanes(cuda, dtype, leaf_width,
                                                  rng)
    used = int(used_t)
    vp = vpages if with_values else None
    got = ps.page_prefix_bucketed(e_b, sp, idx.pages, vp, mask_value=mask,
                                  steps_used=used_t)
    want = ps.page_prefix_plain(e_b, sp, idx.pages, vp,
                                mask_value=mask if with_values else None)
    torch.cuda.synchronize()
    if not with_values:
        got, want = (got,), (want,)
    assert_kernel_matches(got, want, used, sum_at=1)


STEP_PAGES = [0, 0, 0, 1, 2, 2, 3, 5, 5, 5, 5, 6]    # sorted, with runs


def prefix_case(dtype, lw_pad, tq, rng):
    """Sorted pages with duplicate runs and a sentinel tail, edges tied to
    the runs (and, for float32, signed zeros, infinities and NaN), the
    steps of STEP_PAGES followed by surplus steps, and int32 values near
    +-2^31 so the sums wrap: (e_b, step_pages, steps_used, kpages,
    vpages)."""
    n_pages, fill = 7, lw_pad * 3 // 4
    keys = np.sort(rng.integers(-40, 40, (n_pages, fill)), axis=1)
    if dtype == np.int32:
        pages = np.full((n_pages, lw_pad), I32.max, np.int32)
        pages[:, :fill] = keys
        special = [I32.min, I32.max - 1, I32.max]
        vals = rng.integers(2**31 - 1000, 2**31, (n_pages, lw_pad))
        vals = np.where(rng.random(vals.shape) < 0.5, vals, -vals)
    else:
        pages = np.full((n_pages, lw_pad), np.inf, np.float32)
        pages[:, :fill] = keys * 0.5
        zeros = pages == 0                            # -0.0 and +0.0 tie
        pages[zeros] = np.where(rng.random(zeros.sum()) < 0.5, -0.0, 0.0)
        special = [0.0, -0.0, np.inf, -np.inf, np.nan]
        vals = rng.normal(size=(n_pages, lw_pad)) * 1e3
    vals = vals.astype(dtype)
    vals.reshape(-1)[::11] = -7                       # the mask value
    grid = len(STEP_PAGES) + 4
    step_pages = np.array(STEP_PAGES + [0] * 4, np.int32)
    e_b = np.empty((grid, tq), dtype)
    for g, page in enumerate(step_pages):
        row = pages[page, :fill]
        pool = np.concatenate([row, row + 1, row - 1, special]).astype(dtype)
        e_b[g] = rng.choice(pool, tq)
    return (torch.from_numpy(e_b), torch.from_numpy(step_pages),
            torch.tensor([len(STEP_PAGES)], dtype=torch.int32),
            torch.from_numpy(pages), torch.from_numpy(vals))


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [None, -7])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("lw_pad,tq", [(128, 128), (2048, 128), (2048, 100),
                                       (130, 16), (4100, 64)])
def test_page_prefix_kernel_ties_runs_and_wraps(cuda, dtype, lw_pad, tq,
                                                mask):
    """Edges tied to duplicate runs, consecutive steps on one page,
    steps_used below the grid and wrapping int32 sums; partial warps (TQ
    100, 16), an unaligned row width (130) and pages wider than one staged
    chunk (4100). Counts and int32 sums bit for bit; float sums, which
    cancel here, against the plain version run in float64 (the kernel adds
    in double, so it is within a float32 rounding of the exact sum)."""
    rng = np.random.default_rng(lw_pad + tq)
    e_b, sp, used_t, kpages, vpages = (
        t.to(cuda) for t in prefix_case(dtype, lw_pad, tq, rng))
    used = int(used_t)
    for vp in (None, vpages):
        for steps_used in (used_t, None):
            n = used if steps_used is not None else sp.shape[0]
            got = ps.page_prefix_bucketed(e_b, sp, kpages, vp,
                                          mask_value=mask,
                                          steps_used=steps_used)
            if vp is None:
                want = ps.page_prefix_plain(e_b, sp, kpages)
                torch.cuda.synchronize()
                assert torch.equal(got[:n], want[:n])
                continue
            exact = vp.double() if dtype == np.float32 else vp
            want = ps.page_prefix_plain(e_b, sp, kpages, exact,
                                        mask_value=mask)
            torch.cuda.synchronize()
            assert torch.equal(got[0][:n], want[0][:n])
            if dtype == np.float32:
                torch.testing.assert_close(got[1][:n].double(), want[1][:n],
                                           rtol=1e-6, atol=1e-6)
            else:
                assert torch.equal(got[1][:n], want[1][:n])


@pytest.mark.cuda
@pytest.mark.parametrize("unsorted", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("lw_pad,tq", [(5120, 64), (2048, 1), (2048, 33),
                                       (2048, 1024), (130, 33)])
def test_page_search_and_scan_wide_pages_partial_warps(cuda, dtype, lw_pad,
                                                       tq, unsorted):
    """The page-search kernel and every page-scan mode on pages wider than
    one staged chunk (5120 slots), one-lane, partial-warp and full blocks
    (TQ 1, 33, 1024), an unaligned row width (130), steps_used below the
    grid and every step, and step pages in page order or shuffled (a
    restage at nearly every step). Counts, ranks, int32 sums, min and max
    bit for bit; float sums, which cancel here, against the plain version
    run in float64."""
    rng = np.random.default_rng(lw_pad + tq + unsorted)
    lo_b, sp, used_t, kpages, vpages = prefix_case(dtype, lw_pad, tq, rng)
    used = int(used_t)
    hi_b = lo_b[:, torch.from_numpy(rng.permutation(tq))]
    order = torch.from_numpy(rng.random(lo_b.shape) < 0.7)   # most lo <= hi
    lo_b, hi_b = (torch.where(order, torch.minimum(lo_b, hi_b), lo_b),
                  torch.where(order, torch.maximum(lo_b, hi_b), hi_b))
    if unsorted:
        perm = torch.from_numpy(np.concatenate(
            [rng.permutation(used), np.arange(used, sp.shape[0])]))
        lo_b, hi_b, sp = lo_b[perm], hi_b[perm], sp[perm].contiguous()
    lo_b, hi_b, sp, used_t, kpages, vpages = (
        t.contiguous().to(cuda)
        for t in (lo_b, hi_b, sp, used_t, kpages, vpages))
    exact = vpages.double() if dtype == np.float32 else vpages
    for steps_used in (used_t, None):
        n = used if steps_used is not None else sp.shape[0]
        for stride in (lw_pad, lw_pad - 37):
            got = pk.page_search_bucketed(lo_b, sp, kpages, stride=stride,
                                          steps_used=steps_used)
            want = pk.page_search_plain(lo_b, sp, kpages, stride=stride)
            torch.cuda.synchronize()
            assert torch.equal(got[:n], want[:n])
        for mode in ps.MODES:
            for mask in ((None,) if mode == "count" else (None, -7)):
                vp = None if mode == "count" else vpages
                got = ps.page_scan_bucketed(lo_b, hi_b, sp, kpages, vp,
                                            mode=mode, mask_value=mask,
                                            steps_used=steps_used)
                want = ps.page_scan_plain(lo_b, hi_b, sp, kpages, vp,
                                          mode=mode, mask_value=mask)
                torch.cuda.synchronize()
                if mode != "count" and dtype == np.float32:
                    w64 = ps.page_scan_plain(lo_b, hi_b, sp, kpages, exact,
                                             mode="sum", mask_value=mask)
                    torch.testing.assert_close(got[2][:n].double(),
                                               w64[2][:n], rtol=1e-6,
                                               atol=1e-6)
                    got, want = got[:2] + got[3:], want[:2] + want[3:]
                assert_kernel_matches(got, want, n, sum_at=None)


# in this order at sorted random slots of a row: an infinity or a NaN lies
# between every +1e30 and -1e30, so no range sums a cancelling pair
SPECIAL_VALUES = np.array([1e30, np.nan, -0.0, 0.0, np.inf, 1e30, -np.inf,
                           -1e30, -0.0, np.nan, -1e30, 0.0], np.float32)


def special_scan_case(rng, lw_pad=2048, tq=128):
    """Sorted float32 pages of distinct keys whose values hold NaN, +-inf,
    +-1e30, -0.0 and +0.0 (page 0 only signed zeros), and bound pairs over
    random slot runs, so special values fall inside and outside the
    lanes' ranges; inert, whole-page and NaN bounds too."""
    P, G, live = 6, 12, lw_pad * 7 // 8
    keys = np.arange(P * live, dtype=np.float32).reshape(P, live) * 0.5
    kpages = np.full((P, lw_pad), np.inf, np.float32)
    kpages[:, :live] = keys
    vals = rng.normal(size=(P, lw_pad)).astype(np.float32)
    for p in range(1, P):
        vals[p, np.sort(rng.choice(live, SPECIAL_VALUES.size,
                                   replace=False))] = SPECIAL_VALUES
    vals[0] = np.where(rng.random(lw_pad) < 0.5, -0.0, 0.0)
    vals[:, 5::11] = -7
    sp = np.sort(rng.integers(0, P, G)).astype(np.int32)
    a = rng.integers(0, live, (G, tq))
    b = np.minimum(a + rng.integers(0, lw_pad // 4, (G, tq)), live - 1)
    lo, hi = keys[sp[:, None], a], keys[sp[:, None], b]
    lo[0, :3], hi[0, :3] = np.inf, -np.inf           # inert
    lo[1, :3], hi[1, :3] = -np.inf, np.finfo(np.float32).max
    lo[2, :2], hi[2, 2:4] = np.nan, np.nan
    return [torch.from_numpy(x) for x in (lo, hi, sp, kpages, vals)]


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [None, -7])
@pytest.mark.parametrize("mode", ["sum", "full"])
def test_page_scan_kernel_special_values(cuda, mode, mask):
    """NaN, +-inf, +-1e30 and signed zeros in the value pages: the kernel
    equals the plain version bit for bit, with min and max NaN at every
    lane whose range holds a NaN value (jnp.min / jnp.max propagate it),
    min -0.0 and max +0.0 at every lane of page 0 (only signed zeros)
    whose range takes in both zeros and nothing else, and no infinity or
    NaN outside a range in its sum."""
    case = special_scan_case(np.random.default_rng(21))
    lo, hi, sp, kp, vp = (t.to(cuda) for t in case)
    got = ps.page_scan_bucketed(lo, hi, sp, kp, vp, mode=mode,
                                mask_value=mask)
    want = ps.page_scan_plain(lo, hi, sp, kp, vp, mode=mode, mask_value=mask)
    torch.cuda.synchronize()
    assert_kernel_matches(got, want, sp.shape[0], sum_at=2)
    assert bool(torch.isinf(got[2]).any())
    if mode == "full":
        nan = torch.isnan(want[3])
        assert bool(nan.any()) and not bool(nan.all())
        assert torch.equal(torch.isnan(got[3]), nan)
        assert torch.equal(torch.isnan(got[4]), nan)
        # page 0: lanes whose masked range holds only zeros, of both signs
        lo_h, hi_h, sp_h, kp_h, vp_h = (t.numpy() for t in case)
        k, v = kp_h[0], vp_h[0]
        rows = np.flatnonzero(sp_h == 0)
        m = (k >= lo_h[rows, :, None]) & (k <= hi_h[rows, :, None])
        if mask is not None:
            m &= v != mask
        zero = v == 0
        both = (~(m & ~zero).any(-1) & (m & zero & np.signbit(v)).any(-1)
                & (m & zero & ~np.signbit(v)).any(-1))
        mn, mx = got[3].cpu().numpy()[rows], got[4].cpu().numpy()[rows]
        assert np.all((mn[both] == 0) & np.signbit(mn[both]))
        assert np.all((mx[both] == 0) & ~np.signbit(mx[both]))
        if mask is not None:
            assert both.sum() > 10


@pytest.mark.cuda
def test_page_kernels_zero_step_grids(cuda):
    """A zero-step grid launches nothing and returns empty outputs; a grid
    whose steps_used is 0 runs and writes no lane (nothing to compare)."""
    e_b, sp, _, kpages, vpages = (t.to(cuda) for t in prefix_case(
        np.int32, 128, 32, np.random.default_rng(3)))
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)
    launches = (pk.page_search_bucketed.launches,
                ps.page_scan_bucketed.launches)
    assert pk.page_search_bucketed(e_b[:0], sp[:0], kpages,
                                   stride=128).shape == (0, 32)
    for mode in ps.MODES:
        outs = ps.page_scan_bucketed(e_b[:0], e_b[:0], sp[:0], kpages,
                                     vpages, mode=mode)
        assert [tuple(t.shape) for t in outs] == [(0, 32)] * len(outs)
    assert (pk.page_search_bucketed.launches,
            ps.page_scan_bucketed.launches) == launches
    pk.page_search_bucketed(e_b, sp, kpages, stride=128, steps_used=zero)
    for mode in ps.MODES:
        ps.page_scan_bucketed(e_b, e_b, sp, kpages, vpages, mode=mode,
                              steps_used=zero)
    torch.cuda.synchronize()


def cdf_rows(rng, B: int, V: int):
    """(cdf, u) with rows from softmax + sort + cumsum of seeded logits,
    flat runs, +inf tails, and u at 0, 1e-6, on a cdf entry, above
    cdf[-1] and inside a flat run."""
    x = rng.normal(size=(B, V)) * 3
    p = np.exp(x - x.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    cdf = np.cumsum(-np.sort(-p, axis=-1), -1).astype(np.float32)
    cdf[1::4, V // 4:V // 2] = cdf[1::4, V // 4:V // 4 + 1]
    u = rng.uniform(0, 1, B).astype(np.float32)
    u[0::6], u[1::6] = 0.0, 1e-6
    u[2::6] = cdf[2::6, V // 3]
    u[3::6] = cdf[3::6, -1] + 0.25
    u[5::6] = cdf[5::6, V // 4]                  # row 5 is flat (5 % 4 == 1)
    cdf[4::5, 3 * V // 4:] = np.inf
    return cdf, u


def cdf_kernel_cases(cd, ud, rng):
    """(name, cdf, u) on the card: the rows as given; an odd width (V - 1,
    the scalar path); a base one float past 16-byte alignment (V % 4 == 0,
    still the scalar path); rows that are not monotone, on which the count
    and a binary search differ; NaN inside rows and in u."""
    B, V = cd.shape
    buf = torch.empty(B * V + 1, dtype=torch.float32, device=cd.device)
    shifted = buf[1:].view(B, V)
    shifted.copy_(cd)
    rough = torch.from_numpy(rng.random((B, V), dtype=np.float32)).to(cd.device)
    nan_rows = cd.clone()
    nan_rows[::2, V // 3] = float("nan")
    nan_u = ud.clone()
    nan_u[1::3] = float("nan")
    cases = [("as given", cd, ud), ("unaligned base", shifted, ud),
             ("not monotone", rough, ud),
             ("NaN in rows and u", nan_rows, nan_u)]
    if V > 1:
        cases.append(("odd width", cd[:, 1:].contiguous(), ud))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("B,V", [(1, 100), (3, 1000), (8, 2048),
                                 (64, 152_064), (256, 1000), (1, 152_064),
                                 (8, 152_064), (256, 152_064), (5, 1),
                                 (6, 7)])
def test_cdf_kernel_matches_plain(cuda, B, V):
    """The kernel against its plain version, exactly: the serving shapes
    (V = 152,064 at B = 1, 8, 64, 256), V = 1 and 7, slices shorter than
    a block (V = 100, 1000), the scalar path, rows that are not monotone
    and NaN; np.searchsorted agrees on the sorted rows, and differs from
    the count on some rough ones."""
    from repro_torch.kernels import cdf_search as cs
    rng = np.random.default_rng(B + V)
    cdf, u = cdf_rows(rng, B, V)
    cd, ud = torch.from_numpy(cdf).to(cuda), torch.from_numpy(u).to(cuda)
    got = cs.cdf_search(cd, ud)
    torch.cuda.synchronize()
    ref = np.array([np.searchsorted(cdf[b], u[b], "left") for b in range(B)])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), np.minimum(ref, V - 1))
    for name, c, uu in cdf_kernel_cases(cd, ud, rng):
        got = cs.cdf_search(c, uu)
        want = cs.invert_cdf(c, uu)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
    if V >= 1000:                 # the count is not a binary search there
        rough = rng.random((B, V), dtype=np.float32)
        mid = rng.uniform(0.2, 0.8, B).astype(np.float32)
        count = cs.cdf_search(torch.from_numpy(rough).to(cuda),
                              torch.from_numpy(mid).to(cuda))
        search = [np.searchsorted(rough[b], mid[b], "left")
                  for b in range(B)]
        assert not np.array_equal(count.cpu().numpy(),
                                  np.minimum(search, V - 1))
    assert cs.cdf_search(cd[:0], ud[:0]).shape == (0,)


@pytest.mark.cuda
def test_cdf_kernel_row_loop(cuda):
    """More rows than one launch's grid holds (65,535 clusters): the
    clusters loop over rows, and every row is counted."""
    from repro_torch.kernels import cdf_search as cs
    rng = np.random.default_rng(7)
    B, V = 70_000, 12
    cdf = torch.from_numpy(rng.random((B, V), dtype=np.float32)).to(cuda)
    u = torch.from_numpy(rng.random(B, dtype=np.float32)).to(cuda)
    got = cs.cdf_search(cdf, u)
    want = cs.invert_cdf(cdf, u)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cdf_kernel_one_launch_a_call(cuda):
    """One call makes one device kernel, the CDF kernel: no fill of the
    output and no clamp after it (the profiler's device events), and adds
    one to the launch counter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import cdf_search as cs
    cdf, u = cdf_rows(np.random.default_rng(1), 8, 152_064)
    cd, ud = torch.from_numpy(cdf).to(cuda), torch.from_numpy(u).to(cuda)
    cs.cdf_search(cd, ud)
    torch.cuda.synchronize()
    before = cs.cdf_search.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.cdf_search(cd, ud)
        torch.cuda.synchronize()
    assert cs.cdf_search.launches == before + 1
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "cdf_search_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_sampled_generate_on_the_card(cuda, monkeypatch):
    """A reduced qwen3-0.6b served on the card, sampled: one CDF kernel
    launch per decode step, page-search launches for the store probes, and
    every token inside its row's top-p nucleus."""
    from repro_torch.configs import get_config
    from repro_torch.core import IndexConfig
    from repro_torch.kernels import cdf_search as cs
    from repro_torch.models import transformer as T
    from repro_torch.serve import SamplerConfig, ServeEngine
    from repro_torch.serve import engine as engine_mod
    cfg = get_config("qwen3-0.6b").reduced()
    params = T.init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    scfg = SamplerConfig(temperature=0.8, top_p=0.9)
    eng = ServeEngine(cfg, params, max_len=64, page_size=8,
                      index_config=IndexConfig(kind="tiered", mutable=False),
                      sampler=scfg, decode_batching=False)
    seen = []
    real = engine_mod.sample

    def record(logits, cfg_, *, generator=None):
        seen.append(logits.clone())
        tok = real(logits, cfg_, generator=generator)
        seen.append(tok)
        return tok

    monkeypatch.setattr(engine_mod, "sample", record)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 16)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 7)])
               for _ in range(2)]
    cs.cdf_search.launches = pk.page_search_bucketed.launches = 0
    for _ in range(2):
        out = eng.generate(prompts, 4)
    assert cs.cdf_search.launches == 8
    assert pk.page_search_bucketed.launches > 0
    assert out.shape == (2, 4) and out.device.type == cuda.type
    assert eng.stats.reused_tokens > 0
    for logits, tok in zip(seen[::2], seen[1::2]):
        p = torch.softmax(logits.double() / 0.8, -1)
        pt = p.gather(1, tok[:, None].long())
        above = torch.where(p > pt, p, 0.0).sum(-1)
        assert bool((above < 0.9 + 1e-4).all())


# ------------------------------------------------------- the mutable store
def store_pair(cuda, n_keys=40_000, capacity=256):
    """The same mutable store on the card and on the CPU, after one write
    batch (inserts, upserts, deletes) and a fold: a k-ary top over gapped
    pages, a delta tier with tombstones and a host-synced base row."""
    from repro_torch.core import IndexConfig, build_index
    rng = np.random.default_rng(21)
    keys = np.unique(rng.integers(0, 10**8, n_keys).astype(np.int32))
    cfg = IndexConfig(kind="tiered", mutable=True, delta_capacity=capacity,
                      leaf_width=128)
    stores = [build_index(keys, config=cfg, device=d) for d in (cuda, "cpu")]
    writes = [("insert", rng.integers(0, 10**8, 600).astype(np.int32),
               rng.integers(0, 10**6, 600).astype(np.int32)),
              ("delete", keys[rng.integers(0, keys.size, 150)]),
              ("insert", keys[rng.integers(0, keys.size, 100)],
               rng.integers(0, 10**6, 100).astype(np.int32))]
    for s in stores:
        for op, *args in writes:
            getattr(s, op)(*args)
    q = np.concatenate([writes[0][1][::3], writes[1][1], keys[::40],
                        rng.integers(0, 10**8, 2000).astype(np.int32),
                        [I32.max, I32.max - 1, 0]]).astype(np.int32)
    return stores, q


@pytest.mark.cuda
def test_store_lookup_on_the_card_matches_the_cpu_store(cuda):
    """The fused lookup on the card (page and k-ary kernels, delta probe)
    against the same store on the CPU (plain versions): slot addresses,
    found and values equal, before and after a repack; the kernels
    launched."""
    stores, q = store_pair(cuda)
    gpu, cpu = stores
    assert gpu.base.top_kind == "kary" and gpu.sealed.count > 0
    for step in range(2):
        pk.page_search_bucketed.launches = kk.kary_search_levels.launches = 0
        got = gpu.lookup(torch.from_numpy(q).to(cuda))
        assert pk.page_search_bucketed.launches == 1
        assert kk.kary_search_levels.launches == 1
        want = cpu.lookup(torch.from_numpy(q))
        for name in ("rank", "found", "values"):
            assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
        if step == 0:                     # crowd one page: a repack
            b = cpu.base
            p = b.num_pages // 2
            ks = np.arange(b.seps[p - 1] + 1, b.seps[p] + 1)[:300]
            for s in stores:
                s.insert(ks.astype(np.int32), np.arange(ks.size))
                s.flush()
            assert gpu.stats["splits"] >= 1
            assert gpu.base.num_pages == cpu.base.num_pages


@pytest.mark.cuda
def test_warm_store_lookup_after_writes_makes_no_sync(cuda):
    """A write batch uploads the delta tiers; the lookup after it only
    reads tensors on the card: no host sync, no copy."""
    stores, q = store_pair(cuda)
    gpu = stores[0]
    qd = torch.from_numpy(q).to(cuda)
    gpu.insert(np.arange(5, 500, 7, dtype=np.int32),
               np.arange(71, dtype=np.int32))
    gpu.delete(np.arange(5, 50, 7, dtype=np.int32))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = gpu.lookup(qd)
        fb = gpu.pop_plan_feedback()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert 0 < fb() <= 1
    assert res.found.device == qd.device
    want = stores[1]
    want.insert(np.arange(5, 500, 7, dtype=np.int32),
                np.arange(71, dtype=np.int32))
    want.delete(np.arange(5, 50, 7, dtype=np.int32))
    ref = want.lookup(torch.from_numpy(q))
    assert torch.equal(res.found.cpu(), ref.found)
    assert torch.equal(res.values.cpu(), ref.values)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_page_kernel_on_gapped_pages_at_stride_lw_pad(cuda, dtype):
    """The page kernel over the store's gapped pages (a live prefix, then
    sentinel gaps, some pages empty after deletes) at stride lw_pad, on
    the operands the store's own pipeline builds, equals its plain
    version."""
    from repro_torch.core import IndexConfig, build_index
    rng = np.random.default_rng(22)
    keys = np.unique((rng.normal(size=30_000) * 1e6).astype(dtype))
    store = build_index(keys, config=IndexConfig(
        kind="tiered", mutable=True, delta_capacity=1024, leaf_width=2000),
        device=cuda)
    b = store.base
    store.delete(b.keys[3, :b.cnt[3]])           # page 3 goes empty
    store.delete(keys[::5])
    store.flush()
    b = store.base
    assert b.cnt[3] == 0 and b.lw_pad == 2048
    q = np.concatenate([keys[::7], (rng.normal(size=4000) * 1e6),
                        [b.sentinel]]).astype(dtype)
    qd = torch.from_numpy(q).to(cuda)
    g_cap = schedule.ladder_grid(qd.shape[0], b.tile, b.num_pages)
    plan = schedule.device_plan(b.page_of_raw(qd), b.tile, g_cap,
                                b.num_pages)
    qb = torch.zeros(g_cap * b.tile, dtype=qd.dtype, device=cuda) \
        .scatter_(0, plan.dest.long(), qd).view(g_cap, b.tile)
    used = int(plan.steps_used)
    got = pk.page_search_bucketed(qb, plan.step_pages, b.dev_keys,
                                  stride=b.lw_pad,
                                  steps_used=plan.steps_used)
    want = pk.page_search_plain(qb, plan.step_pages, b.dev_keys,
                                stride=b.lw_pad)
    torch.cuda.synchronize()
    assert torch.equal(got[:used], want[:used])


# ------------------------------------------------- the mutable store's scans
def store_scans(store, lo, hi, ranges):
    """Every scan kind of the store, as (name, result) pairs."""
    return [("scan_range", store.scan_range(lo, hi)),
            ("scan_range_count", store.scan_range(lo, hi, aggs=("count",))),
            ("materialize", store.scan_range(lo, hi, materialize=16)),
            ("groups_count", store.scan_groups(lo, hi, 16,
                                               aggs=("count",))),
            ("groups_sum", store.scan_groups(lo, hi, 16,
                                             aggs=("count", "sum"))),
            ("groups_full", store.scan_groups(lo, hi, 16)),
            ("groups_top_k", store.scan_groups(lo, hi, 16, top_k=4)),
            ("multi_union", store.scan_multi(ranges, op="union")),
            ("multi_intersect", store.scan_multi(ranges, op="intersect"))]


def scan_inputs(rng, device):
    lo = rng.integers(0, 10**8, 2048).astype(np.int32)
    hi = (lo + rng.integers(-1000, 10**6, 2048)).astype(np.int32)
    hi[-4:] = I32.max                             # the sentinel bound
    ranges = np.stack([lo[:1024].reshape(256, 4), hi[:1024].reshape(256, 4)],
                      -1)
    return [torch.from_numpy(a).to(device) for a in (lo, hi, ranges)]


@pytest.mark.cuda
def test_store_scans_on_the_card_match_the_cpu_store_with_no_sync(cuda):
    """Every scan kind on the card (page-scan and page-prefix kernels at
    stride lw_pad with the tombstone mask, the tiers' sorted views)
    against the same store on the CPU (plain versions), field for field;
    the first scan after a write round (dirty rows pushed, page
    aggregates and tier views rebuilt) and the next make no host sync."""
    stores, _ = store_pair(cuda)
    gpu, cpu = stores
    rng = np.random.default_rng(31)
    for s in stores:                     # both tiers hold writes again
        s.insert(np.arange(10, 300_000, 997, dtype=np.int32),
                 np.arange(301, dtype=np.int32))
        s.delete(np.arange(10, 150_000, 1994, dtype=np.int32))
    assert gpu.sealed.count > 0 and gpu._dirty_rows
    lo, hi, ranges = scan_inputs(rng, cuda)
    for _ in range(2):
        ps.page_scan_bucketed.launches = ps.page_prefix_bucketed.launches = 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = store_scans(gpu, lo, hi, ranges)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert ps.page_scan_bucketed.launches > 0
        assert ps.page_prefix_bucketed.launches == 2
    want = store_scans(cpu, lo.cpu(), hi.cpu(), ranges.cpu())
    for (name, g), (_, w) in zip(got, want):
        for f, wv in vars(w).items():
            gv = getattr(g, f)
            assert (gv is None) == (wv is None), (name, f)
            if wv is not None:
                assert torch.equal(gv.cpu(), wv), (name, f)


@pytest.mark.cuda
def test_scan_kernels_on_store_operands_match_plain(cuda):
    """The page-scan kernel (count, sum, full) and the page-prefix kernel
    (count, sum) on the operands the store's own scans build (gapped
    pages at lw_pad, the TOMBSTONE value mask, tombstone-synced slots)
    equal their plain versions over the steps the plan used."""
    from repro_torch.engine import groupby, scan
    stores, _ = store_pair(cuda)
    gpu = stores[0]
    lo, hi, _ = scan_inputs(np.random.default_rng(33), cuda)
    cases = [(scan, "page_scan_bucketed", ps.page_scan_plain,
              lambda m: gpu.scan_range(lo, hi, aggs=m), a)
             for a in (("count",), ("count", "sum"), None)]
    cases += [(groupby, "page_prefix_bucketed", ps.page_prefix_plain,
               lambda m: gpu.scan_groups(lo, hi, 16, aggs=m), a)
              for a in (("count",), ("count", "sum"))]
    for mod, name, plain, call, aggs in cases:
        seen = {}
        real = getattr(mod._pscan, name)

        def record(*args, **kw):
            seen["args"], seen["kw"] = args, kw
            return real(*args, **kw)

        kernels = mod._pscan
        mod._pscan = types.SimpleNamespace(**{**vars(kernels), name: record})
        try:
            call(aggs)
        finally:
            mod._pscan = kernels
        args, kw = seen["args"], seen["kw"]
        used = int(kw["steps_used"])
        got = real(*args, **kw)
        want = plain(*args, **{k: v for k, v in kw.items()
                               if k != "steps_used"})
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert args[2 if name == "page_scan_bucketed" else 1].dtype \
            == torch.int32
        for a, b in zip(got, want):
            assert torch.equal(a[:used], b[:used]), (name, aggs)


@pytest.mark.cuda
def test_store_save_restore_round_trip_on_the_card(cuda, tmp_path):
    """save, journaled writes, a dropped store and a torn last record,
    then restore_index on the card: lookups and scans equal a store on
    the CPU that made every write but the torn one."""
    from repro_torch.ckpt import journal
    from repro_torch.core import IndexConfig, build_index, restore_index
    rng = np.random.default_rng(35)
    keys = np.unique(rng.integers(0, 10**8, 30_000).astype(np.int32))
    cfg = IndexConfig(kind="tiered", mutable=True, delta_capacity=256,
                      leaf_width=128)
    gpu = build_index(keys, config=cfg, device=cuda)
    cpu = build_index(keys, config=cfg, device="cpu")
    d = str(tmp_path / "ck")
    gpu.save(d)
    new = rng.integers(0, 10**8, 700).astype(np.int32)
    gone = keys[rng.integers(0, keys.size, 200)]
    for s in (gpu, cpu):
        s.insert(new, np.arange(700, dtype=np.int32))
        s.delete(gone[:-1])
    gpu.delete(gone[-1:])                        # the record torn below
    del gpu
    seg = journal.scan_dir(d)[-1][1]
    with open(seg, "r+b") as f:
        f.truncate(f.seek(0, 2) - 9)
    got = restore_index(d, cfg, device=cuda)
    assert got.stats["journal_replayed"] == 700 + 199
    assert got.device.type == "cuda" and got.base.dev_keys.is_cuda
    q = np.concatenate([new, gone, keys[::13]]).astype(np.int32)
    a, b = got.lookup(torch.from_numpy(q).to(cuda)), \
        cpu.lookup(torch.from_numpy(q))
    assert torch.equal(a.found.cpu(), b.found)
    assert torch.equal(a.values.cpu()[b.found], b.values[b.found])
    lo, hi, _ = scan_inputs(rng, cuda)
    ga, wa = got.scan_range(lo, hi), cpu.scan_range(lo.cpu(), hi.cpu())
    for f in ("count", "vsum", "vmin", "vmax", "r_lo"):
        assert torch.equal(getattr(ga, f).cpu(), getattr(wa, f)), f
    got.close()


# ------------------------------------------------ the micro-batch queues
@pytest.mark.cuda
def test_probe_queue_flush_makes_no_sync_and_equals_lookup(cuda):
    """Probe-queue submits (numpy chains joined on the host and uploaded
    once; tensors joined on the card) on three tenants, their flushes and
    the feedback drain of the earlier flush, all under sync-debug
    "error": each caller's result equals a direct lookup of its own
    queries, and the drained occupancy equals the CPU store's."""
    from repro_torch.engine.queue import MicroBatchQueue, index_probe_fn
    stores, q = store_pair(cuda)
    gpu, cpu = stores
    parts = np.array_split(q, 6)
    pq, cq = (MicroBatchQueue(index_probe_fn(s), capacity=1 << 14,
                              min_flush=1 << 14, timer=False)
              for s in (gpu, cpu))
    gpu.lookup(torch.from_numpy(q).to(cuda))
    on_card = [torch.from_numpy(p).to(cuda) for p in parts]
    torch.cuda.synchronize()
    futs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for subs in (parts, on_card):
            for i, (p, sub) in enumerate(zip(parts, subs)):
                futs.append((p, pq.submit(sub, tenant=f"t{i % 3}")))
            pq.flush()                   # the second drains the first's
        results = [(p, f.result()) for p, f in futs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pq.drain_feedback()
    for p, r in results:
        want = gpu.lookup(torch.from_numpy(p).to(cuda))
        for name in ("rank", "found", "values"):
            assert torch.equal(getattr(r, name), getattr(want, name))
    for _ in range(2):
        for i, p in enumerate(parts):
            cq.submit(p, tenant=f"t{i % 3}")
        cq.flush()
    cq.drain_feedback()
    assert pq.stats.flushes == 2 and pq.stats.occ_n == 2
    assert pq.stats.occ_sum == cq.stats.occ_sum > 0


@pytest.mark.cuda
def test_decode_queue_flush_makes_no_sync_and_equals_the_kernel(cuda):
    """(cdf, u) rows of three tenants through the decode queue under
    sync-debug "error": one cdf_search launch a flush, each caller's rows
    equal a direct kernel call; sample_queued with tenants gives the
    inline sampler's tokens for the same generator, with no sync."""
    from repro_torch.engine.queue import MicroBatchQueue
    from repro_torch.kernels import cdf_search as cs
    from repro_torch.serve import sampler as S
    gen = torch.Generator(cuda).manual_seed(3)
    logits = torch.randn((8, 152_064), generator=gen, device=cuda) * 3
    scfg = S.SamplerConfig(temperature=0.8, top_p=0.9)
    _, cdf = S.nucleus_cdf(logits, scfg)
    u = S.draw_u(cdf, scfg, gen)
    dq = MicroBatchQueue(cs.cdf_probe_fn(), timer=False, path="decode")
    torch.cuda.synchronize()
    cs.cdf_search.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        futs = [dq.submit((cdf[a:b], u[a:b]), tenant=f"t{i}")
                for i, (a, b) in enumerate(((0, 3), (3, 5), (5, 8)))]
        dq.flush()
        got = [f.result() for f in futs]
        dq.drain_feedback()
        toks = S.sample_queued(logits, scfg, dq, tenants=list("abcabcab"),
                               generator=torch.Generator(cuda).manual_seed(9))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cs.cdf_search.launches == 2 and dq.stats.flushes == 2
    assert torch.equal(torch.cat(got), cs.cdf_search(cdf, u))
    want = S.sample(logits, scfg,
                    generator=torch.Generator(cuda).manual_seed(9))
    assert torch.equal(toks, want)


# ------------------------------------------- specialization (CUDA graphs)
def spec_pair(cuda, mutable: bool, **cfg):
    """The same index specialized (graph replays) and not, on the card:
    40,000 int32 keys at leaf_width 128, a k-ary top."""
    from repro_torch.core import IndexConfig, build_index
    rng = np.random.default_rng(41)
    keys = np.unique(rng.integers(0, 10**8, 40_000).astype(np.int32))
    vals = rng.integers(-10**6, 10**6, keys.size).astype(np.int32)
    out = [build_index(keys, vals, IndexConfig(
        kind="tiered", mutable=mutable, specialize=s, leaf_width=128, **cfg),
        device=cuda) for s in (True, False)]
    q = np.concatenate([keys[::9], rng.integers(0, 10**8, 3000)]
                       ).astype(np.int32)
    return out, keys, torch.from_numpy(q).to(cuda)


def assert_fields_equal(a, b, what):
    for f in vars(b):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (what, f)
        if y is not None:
            assert torch.equal(x, y), (what, f)


@pytest.mark.cuda
def test_graph_replays_equal_the_args_posture(cuda):
    """Frozen lookups, searches and every scan kind, and the store's
    lookups, replayed from CUDA graphs equal the args posture bit for bit;
    the kernels launched inside the replays are counted."""
    (spec, args), keys, q = spec_pair(cuda, mutable=False)
    assert spec.impl.top_kind == "kary"
    lo = q[:2048]
    hi = lo + 50_000
    ranges = torch.stack([lo.view(512, 4), hi.view(512, 4)], -1)
    for rep in range(3):                      # capture, then replays
        pk.page_search_bucketed.launches = kk.kary_search_levels.launches = 0
        got = spec.lookup(q)
        # the first call runs the warm-up and the first replay
        assert pk.page_search_bucketed.launches == (2 if rep == 0 else 1)
        assert kk.kary_search_levels.launches == (2 if rep == 0 else 1)
        assert_fields_equal(got, args.lookup(q), "lookup")
        assert torch.equal(spec.search(q), args.search(q))
        for name, call in (
                ("scan", lambda ix: ix.scan_range(lo, hi)),
                ("mat", lambda ix: ix.scan_range(lo, hi, materialize=8)),
                ("groups", lambda ix: ix.scan_groups(lo, hi, 8)),
                ("topk", lambda ix: ix.scan_groups(lo, hi, 8, top_k=2)),
                ("multi", lambda ix: ix.scan_multi(ranges, op="union"))):
            assert_fields_equal(call(spec), call(args), name)
    assert spec.impl.captures.n == 7          # one graph a dispatch shape
    (sspec, sargs), _, _ = spec_pair(cuda, mutable=True, delta_capacity=256)
    for s in (sspec, sargs):
        s.insert(np.arange(5, 5000, 7, dtype=np.int32),
                 np.arange(714, dtype=np.int32))
        s.delete(keys[::50])
    for _ in range(2):
        assert_fields_equal(sspec.lookup(q), sargs.lookup(q), "store")
    assert sspec.captures.n == 1


@pytest.mark.cuda
def test_replay_results_are_fresh_and_sync_free(cuda):
    """A later replay never changes an earlier result (outputs are cloned
    out of the graph), and warm replays, the tier copy-in and the feedback
    drain make no host sync."""
    (spec, _), keys, q = spec_pair(cuda, mutable=False)
    (store, _), _, _ = spec_pair(cuda, mutable=True)
    q2 = q.flip(0).contiguous()
    q3 = torch.tensor([3, 5], device=cuda, dtype=torch.int32)
    for ix in (spec, store):                  # capture every shape first
        ix.lookup(q)
    store.lookup(q3)
    spec.scan_range(q[:512], q[:512])
    store.insert(np.asarray([3, 5], np.int32), np.asarray([30, 50], np.int32))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = spec.lookup(q)
        b = store.lookup(q)
        s1 = spec.scan_range(q[:512], q[:512] + 1000)
        spec.lookup(q2)
        store.lookup(q2)
        spec.scan_range(q[:512] + 7, q[:512] + 9)
        c = store.lookup(q3)            # the written tiers copied in
        fb = store.pop_plan_feedback()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert 0 < fb() <= 1
    assert c.values.tolist() == [30, 50]
    want_a, want_b = spec.lookup(q), store.lookup(q)
    assert_fields_equal(a, want_a, "frozen")
    assert_fields_equal(b, want_b, "store")
    assert_fields_equal(s1, spec.scan_range(q[:512], q[:512] + 1000), "scan")


@pytest.mark.cuda
def test_store_captures_after_a_fold_and_a_repack(cuda):
    """The store's graph survives a page-local fold (rows are written in
    place) with answers equal to the args store, and is captured again
    only after a repack re-derives the base."""
    (spec, args), keys, q = spec_pair(cuda, mutable=True, delta_capacity=64)
    spec.lookup(q)
    assert spec.captures.n == 1
    rng = np.random.default_rng(43)
    new = rng.integers(0, 10**8, 64).astype(np.int32)
    for s in (spec, args):
        s.insert(new, new % 1000)
        s.flush()                             # page-local fold
    assert spec.stats["merges"] == 1 and spec.stats["splits"] == 0
    assert_fields_equal(spec.lookup(q), args.lookup(q), "after the fold")
    assert spec.captures.n == 1
    b = spec.base
    p = b.num_pages // 2
    crowd = np.arange(b.seps[p - 1] + 1, b.seps[p] + 1)[:300]
    for s in (spec, args):
        s.insert(crowd.astype(np.int32), np.arange(crowd.size))
        s.flush()
    assert spec.stats["splits"] >= 1
    assert_fields_equal(spec.lookup(q), args.lookup(q), "after the repack")
    assert spec.captures.n == 2


KIND_CONFIGS = [
    dict(kind="binary"), dict(kind="binary", linear_cutoff=8),
    dict(kind="css"), dict(kind="css", node_width=16, intra="binary"),
    dict(kind="kary", node_width=127), dict(kind="fast", node_width=15),
    dict(kind="nitrogen"), dict(kind="nitrogen", levels=4, bottom="vector"),
    dict(kind="nitrogen", bottom="css", node_width=16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("cfg", KIND_CONFIGS,
                         ids=lambda c: "-".join(map(str, c.values())))
def test_every_kind_on_the_card_matches_numpy_with_no_sync(cuda, cfg, dtype):
    """Each of the paper's kinds built on the card: lookup and search_range
    make no host sync and equal numpy (and the CPU build) bit for bit, over
    more queries than one gather slice takes."""
    from repro_torch.core import IndexConfig, build_index
    rng = np.random.default_rng(len(cfg))
    if dtype == np.int32:
        keys = rng.integers(I32.min + 1, I32.max - 1, 200_000)
        q = rng.integers(I32.min, I32.max - 2000, 300_000)   # q + 1000 fits
    else:
        keys = rng.normal(size=200_000) * 1e6
        keys[:4] = [0.0, -0.0, 1e-45, -1e-45]
        q = rng.normal(size=300_000) * 1e6
    keys = keys.astype(dtype)
    q = np.concatenate([q.astype(dtype), keys[:50_000]])
    vals = np.arange(keys.size, dtype=np.int32)
    idx = build_index(keys, vals, IndexConfig(**cfg))
    qd = torch.from_numpy(q).to(cuda)
    hi = qd + (1000 if dtype == np.int32 else 10.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = idx.lookup(qd)
        r_lo, r_hi, cnt = idx.search_range(qd, hi)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    srt = np.sort(keys, kind="stable")
    rank = np.searchsorted(srt, q)
    assert np.array_equal(res.rank.cpu().numpy(), rank)
    found = (rank < srt.size) & (srt[np.minimum(rank, srt.size - 1)] == q)
    assert np.array_equal(res.found.cpu().numpy(), found)
    want_hi = np.searchsorted(srt, hi.cpu().numpy(), "right")
    assert np.array_equal(r_lo.cpu().numpy(), rank)
    assert np.array_equal(r_hi.cpu().numpy(), want_hi)
    assert np.array_equal(cnt.cpu().numpy(), want_hi - rank)
    cpu = build_index(keys, vals, IndexConfig(**cfg), device="cpu")
    assert torch.equal(cpu.lookup(q[:4096]).values,
                       res.values[:4096].cpu())


@pytest.mark.cuda
def test_csb_tree_search_on_the_card_makes_no_sync(cuda):
    from repro_torch.core import CSBTree
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(0, 10**7, 100_000).astype(np.int32))
    t = CSBTree.build(keys, w=8)
    extra = rng.integers(0, 10**7, 500).astype(np.int32)
    for k in extra:
        t.insert(k)
    t.snapshot()
    q = rng.integers(0, 10**7, 200_000).astype(np.int32)
    qd = torch.from_numpy(q).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        found = t.search(qd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.array_equal(found.cpu().numpy(),
                          np.isin(q, np.union1d(keys, extra)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("n_keys,w,lane,rows", [
    (16_383, 127, 128, 8), (262_143, 7, 8, 2), (4000, 3, 8, 2),
    (1000, 5, 3, 2)])
def test_ops_kary_search_launches_the_kernel_once(cuda, dtype, n_keys, w,
                                                  lane, rows):
    """ops.kary_search at the largest trees its guard admits (and a lane
    that is no multiple of 4): one kernel launch, equal to the plain
    version on the same operand and to numpy; the guard raises past it."""
    rng = np.random.default_rng(n_keys)
    keys = np.sort(rng.normal(size=n_keys) * 1e6).astype(dtype)
    q = np.concatenate([rng.normal(size=70_000) * 1e6, keys]).astype(dtype)
    idx = kary_core.build(keys, node_width=w, device=cuda)
    qd = torch.from_numpy(q).to(cuda)
    kk.kary_search_levels.launches = 0
    got = ops.kary_search(idx, qd, lane=lane, tile_rows=rows)
    assert kk.kary_search_levels.launches == 1
    (flat, offsets, wpad), = idx.kernel_operands.values()
    want = kk.kary_search_plain(qd, flat, offsets, fanout=w + 1, wpad=wpad)
    torch.cuda.synchronize()
    assert wpad % 4 == 0
    assert torch.equal(got, want.clamp_max(n_keys))
    assert np.array_equal(got.cpu().numpy(), np.searchsorted(keys, q))
    if (n_keys, w) in ((16_383, 127), (262_143, 7)):
        big = kary_core.build(np.arange(n_keys + 1, dtype=dtype),
                              node_width=w, device=cuda)
        with pytest.raises(ValueError, match="too large"):
            ops.kary_search(big, qd, lane=lane, tile_rows=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys,w,pd,tile", [
    (100, 3, 2, 8), (300_000, 15, 2, 128), (100_000, 127, 2, 64)])
def test_ops_fast_page_search_launches_the_page_kernel_once(cuda, n_keys, w,
                                                            pd, tile):
    from repro_torch.core import fast_tree
    rng = np.random.default_rng(n_keys)
    keys = np.unique(rng.integers(0, 10**9, n_keys).astype(np.int32))
    q = np.concatenate([rng.integers(-5, 10**9 + 5, 50_000), keys[:20_000],
                        np.full(3000, keys[7])]).astype(np.int32)
    idx = fast_tree.build(keys, node_width=w, page_depth=pd, device=cuda)
    qd = torch.from_numpy(q).to(cuda)
    pk.page_search_bucketed.launches = 0
    got = ops.fast_page_search(idx, qd, tile=tile)
    assert pk.page_search_bucketed.launches == 1
    assert np.array_equal(got.cpu().numpy(), np.searchsorted(keys, q))
    empty = ops.fast_page_search(idx, qd[:0], tile=tile)
    assert empty.shape == (0,) and pk.page_search_bucketed.launches == 2


FLAT_KIND_CONFIGS = [dict(kind="binary", linear_cutoff=8),
                     dict(kind="css", node_width=16), dict(kind="kary"),
                     dict(kind="fast", node_width=15), dict(kind="nitrogen"),
                     dict(kind="nitrogen", bottom="css", node_width=16)]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", FLAT_KIND_CONFIGS,
                         ids=lambda c: "-".join(map(str, c.values())))
def test_specialized_flat_kind_replays_and_equals_args(cuda, cfg):
    """A flat kind built with specialize=True captures its searcher into
    one graph a query shape, with no host sync in the capture or the
    replays, and answers searches, lookups and scans as the args posture
    bit for bit."""
    from repro_torch.core import IndexConfig, build_index
    rng = np.random.default_rng(11)
    keys = rng.choice(1 << 30, 300_000, replace=False).astype(np.int32)
    vals = rng.integers(-1000, 1000, keys.size).astype(np.int32)
    args = build_index(keys, vals, IndexConfig(**cfg))
    spec = build_index(keys, vals, IndexConfig(**cfg, specialize=True))
    q = torch.from_numpy(np.concatenate([
        keys[:40_000], rng.integers(0, 1 << 30, 40_000).astype(np.int32)])
        ).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [spec.lookup(q) for _ in range(3)]        # capture, replays
        ranks = spec.search(q[:4096])                   # another shape
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert spec.captures.n == 2
    want = args.lookup(q)
    for g in got:
        assert_fields_equal(g, want, "lookup")
    assert torch.equal(ranks, args.search(q[:4096]))
    lo, hi = q[:2048], q[:2048] + 100_000
    assert_fields_equal(spec.scan_range(lo, hi, materialize=4),
                        args.scan_range(lo, hi, materialize=4), "scan")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_flat_aggregator_on_the_card_equals_the_cpu(cuda, dtype):
    """The same values aggregated on the card and on the CPU: int32 sums
    wrapping, float32 sums (prefix built on the host either way), min /
    max with signed zeros, empty intervals; no host sync in a query."""
    from repro_torch.engine.scan import FlatAggregator
    rng = np.random.default_rng(3)
    if dtype == np.int32:
        v = rng.integers(I32.min + 1, I32.max, 100_000).astype(np.int32)
    else:
        v = (rng.normal(size=100_000) * 1e6).astype(np.float32)
        v[::7] = 0.0
        v[3::7] = -0.0
    a = rng.integers(0, v.size + 1, 50_000)
    b = np.minimum(a + rng.integers(0, 5000, a.size), v.size)
    a, b = a.astype(np.int32), b.astype(np.int32)
    cpu = FlatAggregator(v, device="cpu")(a, b)
    fa = FlatAggregator(v, device=cuda)
    ad, bd = (torch.from_numpy(x).to(cuda) for x in (a, b))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fa(ad, bd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, cpu):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_flat_store_lookup_and_fold_make_no_sync(cuda):
    """The mutable css store on the card: writes, a wholesale fold and
    lookups make no host sync, and answer as the same store on the CPU;
    its host-path scans equal the CPU store's."""
    from repro_torch.core import IndexConfig, build_index
    rng = np.random.default_rng(8)
    keys = rng.choice(1 << 24, 200_000, replace=False).astype(np.int32)
    cfg = IndexConfig(kind="css", mutable=True, delta_capacity=256)
    stores = [build_index(keys, None, cfg, device=d) for d in (cuda, "cpu")]
    new = rng.integers(0, 1 << 24, 300).astype(np.int32)
    q = np.concatenate([keys[:5000], new, new + 1])
    qd = torch.from_numpy(q).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        store = stores[0]
        store.insert(new, np.arange(300, dtype=np.int32))
        store.delete(keys[:100])
        store.flush()                                   # wholesale folds
        got = store.lookup(qd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu = stores[1]
    cpu.insert(new, np.arange(300, dtype=np.int32))
    cpu.delete(keys[:100])
    cpu.flush()
    assert store.stats == cpu.stats and store.stats["base_rebuilds"] >= 2
    want = cpu.lookup(q)
    for f in ("rank", "found", "values"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    lo = np.sort(q[:512])
    hi = lo + 50_000
    hi[-4:] = I32.max
    for s in (store, cpu):
        s.insert(new[:10], np.arange(10, dtype=np.int32) + 7)
    a = store.scan_range(lo, hi, materialize=4)
    b = cpu.scan_range(lo, hi, materialize=4)
    for f in ("count", "r_lo", "r_hi_excl", "vsum", "vmin", "vmax", "ranks",
              "values", "overflow"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


# ---- the flat kinds' search kernels (kernels/flat_search.py)
FLAT_KERNELS = {   # name: (core module, build kwargs)
    "binary_c1": ("sorted_array", dict(linear_cutoff=1)),
    "binary_c8": ("sorted_array", dict(linear_cutoff=8)),
    "css_w128": ("css_tree", dict(node_width=128)),
    "css_w128_binary": ("css_tree", dict(node_width=128, intra="binary")),
    "css_w16": ("css_tree", dict(node_width=16)),
    "css_w16_binary": ("css_tree", dict(node_width=16, intra="binary")),
    "kary_w127": ("kary", dict(node_width=127)),
    "fast_w15_pd2": ("fast_tree", dict(node_width=15, page_depth=2)),
    "fast_w127_pd2": ("fast_tree", dict(node_width=127, page_depth=2)),
}


@functools.lru_cache(maxsize=4)
def flat_edge_case(dtype, n_keys: int, n_q: int, seed: int = 29):
    """Sorted keys with duplicate runs and the ends of the key domain
    (INT32_MIN, INT32_MAX - 1; float32: +-0.0, subnormals, +-3.4e38) and
    queries over the domain, every third key, the sentinel, NaN, +-0.0 and
    subnormals. Cached: callers read the arrays, never write them."""
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        keys = np.concatenate([[I32.min, I32.min, I32.min + 1, I32.max - 1,
                                I32.max - 1],
                               rng.integers(I32.min, I32.max - 1,
                                            n_keys - 5)])
        rand = rng.integers(I32.min, I32.max, n_q)
        edge = [I32.min, I32.min + 1, I32.max - 2, I32.max - 1, I32.max, 0]
    else:
        keys = np.concatenate([[0.0, -0.0, 1e-45, -1e-45, 3e-45, -3.4e38,
                                3.4e38],
                               rng.normal(size=n_keys - 7) * 10.0
                               ** rng.integers(-40, 30, n_keys - 7)])
        rand = rng.normal(size=n_q) * 10.0 ** rng.integers(-40, 30, n_q)
        edge = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 2e-45]
    keys = np.sort(keys.astype(dtype))
    keys[1::7] = keys[::7][:keys[1::7].size]                # duplicate runs
    keys = np.sort(keys)
    q = np.concatenate([rand, keys[::3][:n_q], edge]).astype(dtype)
    return keys, q


def flat_rank(keys, q) -> np.ndarray:
    """searchsorted-left, a NaN query at 0 (no key is below it)."""
    return np.where(np.isnan(q.astype(np.float64)), 0,
                    np.searchsorted(keys, q)).astype(np.int32)


def flat_nodes(mod_name: str, idx):
    return getattr(idx, {"css_tree": "dir_keys", "kary": "tree",
                         "fast_tree": "pages"}[mod_name])


def flat_emulated(fs, mod, mod_name: str, idx, qd):
    """The wrapper's plain version over the index's arrays and stage."""
    if mod_name == "sorted_array":
        return fs.flat_binary_plain(idx.keys_pad, qd, n_pad=idx.n_pad,
                                    cutoff=idx.linear_cutoff, n=idx.n,
                                    stage=idx.stage)
    leaf = (idx.leaf_pad, idx.leaf_width) if mod_name != "kary" else ()
    return fs.flat_descent_plain(
        qd, flat_nodes(mod_name, idx), mod.descent_args(idx), *leaf,
        ending="leaf" if leaf else "rank", n=idx.n, stage=idx.stage)


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys", [4096, 1 << 24])      # in and past L2
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("name", list(FLAT_KERNELS))
def test_flat_kernel_equals_plain(cuda, name, dtype, n_keys, monkeypatch):
    """Each flat kind's search on the card: one launch of its kernel with
    no host sync, bit for bit with the kind's plain composition on the same
    card tensors, with the wrapper's plain version (the kernel's loop over
    the level table, the stage and the samples) and with numpy; FAST's
    leaf_page_of too. 20,000 queries are too few to fill the persistent
    grid (the staged levels read in place), 2^20 fill it. A CUDA tensor
    never reaches a plain version."""
    from repro_torch import core
    from repro_torch.kernels import flat_search as fs
    mod_name, kw = FLAT_KERNELS[name]
    mod = getattr(core, mod_name)
    keys, q = flat_edge_case(dtype, n_keys, 1 << 20 if n_keys > 4096
                             else 20_000)
    idx = mod.build(keys, **kw, device=cuda)
    qd = torch.from_numpy(q).to(cuda)
    plain = mod.search_plain(idx, qd)
    want_page = mod.leaf_page_of_plain(idx, qd) if mod_name == "fast_tree" \
        else None
    emulated = flat_emulated(fs, mod, mod_name, idx, qd)

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    for m, f in ((mod, "search_plain"), (mod, "leaf_page_of_plain"),
                 (fs, "flat_binary_plain"), (fs, "flat_descent_plain")):
        if hasattr(m, f):
            monkeypatch.setattr(m, f, refuse)
    wrapper = fs.flat_binary if mod_name == "sorted_array" \
        else fs.flat_descent
    wrapper.launches = 0
    got = sync_free(lambda: mod.search(idx, qd))
    assert wrapper.launches == 1
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    assert torch.equal(got, emulated)
    assert np.array_equal(got.cpu().numpy(), flat_rank(keys, q))
    if want_page is not None:
        page = sync_free(lambda: mod.leaf_page_of(idx, qd))
        assert wrapper.launches == 2
        assert fs.flat_descent.mode_launches["fast_descent"] >= 1
        assert torch.equal(page, want_page)
    launched = wrapper.launches
    assert mod.search(idx, qd[:0]).shape == (0,)
    assert wrapper.launches == launched                 # Q = 0: no launch


# widths whose rows are not 16-byte aligned (w 127, 15, 3, 1; leaf blocks
# of 129 and 17 keys) beside aligned ones, a leaf width of 16, FAST at page
# depths 1 and 2, and cutoffs 1, 8 and 64
FLAT_WIDTHS = {
    "binary_c64": ("sorted_array", dict(linear_cutoff=64)),
    "css_w1": ("css_tree", dict(node_width=1)),
    "css_w3": ("css_tree", dict(node_width=3)),
    "css_w15_lw16": ("css_tree", dict(node_width=15, leaf_width=16)),
    "css_w127": ("css_tree", dict(node_width=127)),
    "css_w128_binary": ("css_tree", dict(node_width=128, intra="binary")),
    "kary_w15": ("kary", dict(node_width=15)),
    "kary_w128": ("kary", dict(node_width=128)),
    "fast_w15_pd1": ("fast_tree", dict(node_width=15, page_depth=1)),
    "fast_w127_pd2": ("fast_tree", dict(node_width=127, page_depth=2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64,
                                   np.float64])
@pytest.mark.parametrize("name", list(FLAT_WIDTHS))
def test_flat_kernel_widths_and_key_types(cuda, name, dtype):
    """The redesigned kernels at unaligned widths and 8-byte keys: over
    300,000 keys, 3,000 and 40,000 queries (the staged levels read in
    place, one query a thread, by blocks of 32 and 256 threads spread over
    the SMs) and 2^20 (a persistent grid stages them), each search one
    launch with no host sync, bit for bit with the wrapper's plain version
    over the same stage and samples and with numpy; FAST's descent alone
    too."""
    from repro_torch import core
    from repro_torch.kernels import flat_search as fs
    mod_name, kw = FLAT_WIDTHS[name]
    mod = getattr(core, mod_name)
    base = np.float32 if np.dtype(dtype).kind == "f" else np.int32
    keys, q = flat_edge_case(base, 300_000, 1 << 20, seed=33)
    keys, q = keys.astype(dtype), q.astype(dtype)
    idx = mod.build(keys, **kw, device=cuda)
    wrapper = fs.flat_binary if mod_name == "sorted_array" \
        else fs.flat_descent
    for n_q in (3_000, 40_000, q.size):
        qd = torch.from_numpy(q[:n_q]).to(cuda)
        want = flat_emulated(fs, mod, mod_name, idx, qd)
        wrapper.launches = 0
        got = sync_free(lambda: mod.search(idx, qd))
        assert wrapper.launches == 1
        assert torch.equal(got, want), f"{name} {n_q}"
        assert np.array_equal(got.cpu().numpy(), flat_rank(keys, q[:n_q]))
        if mod_name == "fast_tree":
            page = sync_free(lambda: mod.leaf_page_of(idx, qd))
            assert torch.equal(page, fs.flat_descent_plain(
                qd, idx.pages, mod.descent_args(idx), ending="descent",
                stage=idx.stage))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("n_keys", [4096, 1 << 20])
def test_csb_kernel_equals_plain_through_splits(cuda, dtype, n_keys,
                                                monkeypatch):
    """CSBTree.search on the card: one csb_search launch with no host sync,
    equal to the plain composition and to the wrapper's plain version on
    the same snapshot and to np.isin, from a root leaf through its split
    and on a large tree after inserts."""
    from repro_torch.core import CSBTree, csb_tree
    from repro_torch.kernels import flat_search as fs
    keys, q = flat_edge_case(dtype, n_keys, 20_000, seed=30)
    keys = np.unique(keys)
    real = q != (I32.max if dtype == np.int32 else np.inf)
    rng = np.random.default_rng(31)
    tree = CSBTree.build(keys[:4], w=8)
    stages = [keys[4:9], rng.choice(keys, 4000 if n_keys > 4096 else 500)]
    for new in stages:
        for k in new:
            tree.insert(k)
        snap = tree.snapshot()
        qd = torch.from_numpy(q).to(cuda)
        plain = tree.search_plain(qd)
        emulated = fs.csb_search_plain(qd, *snap[:3], root=snap[3],
                                       height=snap[4])
        with monkeypatch.context() as mp:
            mp.setattr(csb_tree, "_search", None)     # never reached
            mp.setattr(fs, "csb_search_plain", None)
            fs.csb_search.launches = 0
            got = sync_free(lambda: tree.search(qd))
            assert fs.csb_search.launches == 1
        torch.cuda.synchronize()
        assert torch.equal(got, plain) and torch.equal(got, emulated)
        assert np.array_equal(got.cpu().numpy()[real],
                              np.isin(q, tree.iter_keys())[real])
    assert tree.height > 2
    big = CSBTree.build(keys, w=8)
    for k in rng.choice(keys, 2000):
        big.insert(k + (1 if dtype == np.int32 else 0.5))
    qd = torch.from_numpy(q).to(cuda)
    got = sync_free(lambda: big.search(qd))
    assert torch.equal(got, fs.csb_search_plain(
        qd, *big.snapshot()[:3], root=big.root, height=big.height))
    assert big.search(qd[:0]).shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64,
                                   np.float64])
def test_csb_kernel_staged_and_in_place(cuda, dtype, monkeypatch):
    """The redesigned csb_search over ~450,000 keys (w 8, 4,096 inserts,
    height 7, 5 levels staged): at 4,096 and 32,768 queries it reads its
    stage in place, at 2^20 a
    persistent grid stages it in shared memory, and with a stage of
    nothing (a budget of 0) it reads every level in place; each search one
    launch with no host sync, bit for bit with the wrapper's plain version
    over the same stage, with the plain descent and (real queries) with
    np.isin, for each key type."""
    from repro_torch.core import CSBTree
    from repro_torch.kernels import flat_search as fs
    base = np.float32 if np.dtype(dtype).kind == "f" else np.int32
    keys, q = flat_edge_case(base, 1 << 20, 1 << 20, seed=34)
    keys, q = np.unique(keys).astype(dtype), q.astype(dtype)
    rng = np.random.default_rng(35)
    tree = CSBTree.build(keys[::2], w=8)
    for k in rng.choice(keys[1::2], 4096, replace=False):
        tree.insert(k)
    assert tree.height == 7
    assert tree.stage.levels == 5
    sent = np.iinfo(dtype).max if np.dtype(dtype).kind == "i" else np.inf
    held = np.sort(tree.iter_keys())
    qd = torch.from_numpy(q).to(cuda)
    snap = tree.snapshot()
    stages = {"port": tree.stage}
    monkeypatch.setattr(fs, "CSB_STAGE_BYTES", 0)
    stages["none"] = fs.csb_stage(*(a.cpu() for a in snap[:2]), snap[3],
                                  snap[4], device=cuda)
    assert stages["none"].levels == 0
    for name, st in stages.items():
        for n_q in (4096, 32_768, q.size):
            qs = qd[:n_q]
            fs.csb_search.launches = 0
            got = sync_free(lambda: fs.csb_search(
                qs, *snap[:3], root=snap[3], height=snap[4], stage=st))
            assert fs.csb_search.launches == 1
            assert fs.csb_search.staged == (name == "port"
                                             and n_q == q.size)
            assert torch.equal(got, fs.csb_search_plain(
                qs, *snap[:3], root=snap[3], height=snap[4], stage=st))
            assert torch.equal(got, tree.search_plain(qs))
            real = q[:n_q] != sent
            assert np.array_equal(got.cpu().numpy()[real],
                                  np.isin(q[:n_q], held)[real])
    with pytest.raises(ValueError, match="needs the snapshot's CSBStage"):
        fs.csb_search(qd, *snap[:3], root=snap[3], height=snap[4])


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["sort", "histogram"])
def test_device_plan_card_equals_cpu_and_runs_no_cummax(cuda, method):
    """The device plan on the card bit for bit with the CPU's (dest,
    step_pages, steps_used) at 2^20 queries over 8,192 pages (sort) and
    over 64 (histogram), with no host sync; a tiered search (2^20 queries
    over 2^22 keys, the k-ary top) runs no cummax: none of its profiled
    ops or kernels (torch.cummax's kernel, a scan, does not name it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(36)
    pages = 8192 if method == "sort" else 64
    page_of = np.minimum(rng.zipf(1.2, 1 << 20) - 1, pages - 1).astype(
        np.int32)
    tile = 128
    g_cap = schedule.ladder_grid(page_of.size, tile, pages)
    pd = torch.from_numpy(page_of).to(cuda)
    got = sync_free(lambda: schedule.device_plan(pd, tile, g_cap, pages,
                                                 method=method))
    want = schedule.device_plan(torch.from_numpy(page_of), tile, g_cap,
                                pages, method=method)
    for f in ("dest", "step_pages", "steps_used"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    if method == "histogram":
        return
    keys = np.arange(1 << 22, dtype=np.int64) * 7 - (1 << 24)
    idx = tiered.build(keys.astype(np.int32), leaf_width=512, device=cuda)
    assert idx.num_pages == 8192 and idx.top_kind == "kary"
    qd = torch.from_numpy(rng.integers(-(1 << 24), 1 << 25, 1 << 20)
                          .astype(np.int32)).to(cuda)
    tiered.search(idx, qd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rank = tiered.search(idx, qd)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any(e.device_type == DeviceType.CUDA for e in prof.events())
    assert not [k for k in names if "cummax" in k.lower()]
    assert np.array_equal(rank.cpu().numpy(), np.searchsorted(
        keys.astype(np.int32), qd.cpu().numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    dict(kind="binary"), dict(kind="css", node_width=16, intra="binary"),
    dict(kind="css"), dict(kind="kary", node_width=127),
    dict(kind="fast", node_width=15), dict(kind="binary", linear_cutoff=8),
    dict(kind="css", node_width=16), dict(kind="css", intra="binary"),
    dict(kind="fast", node_width=127)],
    ids=lambda c: "-".join(map(str, c.values())))
def test_flat_kernel_inside_a_graph(cuda, cfg):
    """specialize=True: the capture records the kind's one kernel launch,
    each replay counts one, and replays equal the args posture."""
    from repro_torch.core import IndexConfig, build_index
    from repro_torch.kernels import flat_search as fs
    keys, q = flat_edge_case(np.int32, 300_000, 50_000, seed=32)
    args = build_index(keys, config=IndexConfig(**cfg))
    spec = build_index(keys, config=IndexConfig(**cfg, specialize=True))
    qd = torch.from_numpy(q).to(cuda)
    wrapper = fs.flat_binary if cfg["kind"] == "binary" else fs.flat_descent
    sync_free(lambda: spec.search(qd))                  # capture
    wrapper.launches = 0
    got = [sync_free(lambda: spec.search(qd)) for _ in range(2)]
    assert wrapper.launches == 2 and spec.captures.n == 1
    want = args.search(qd)
    assert all(torch.equal(g, want) for g in got)
    assert np.array_equal(want.cpu().numpy(), flat_rank(np.sort(keys), q))


@pytest.mark.cuda
def test_flat_descent_alone_inside_a_graph_and_the_table_ends(cuda):
    """FAST's leaf_page_of replayed from a CUDA graph equals the call; a
    css directory of depth 0 (one leaf block) and css w 1 over 2^24 keys
    (23 levels, the deepest table the reference builds there) equal their
    plain versions and numpy, the deep one past the persistent grid."""
    from repro_torch.core import css_tree, fast_tree
    from repro_torch.engine.capture import Captures, Specialized
    from repro_torch.kernels import flat_search as fs
    keys, q = flat_edge_case(np.int32, 300_000, 50_000, seed=34)
    f = fast_tree.build(keys, node_width=127, page_depth=2, device=cuda)
    qd = torch.from_numpy(q).to(cuda)
    spec = Specialized(lambda x: fast_tree.leaf_page_of(f, x), device=cuda,
                       captures=Captures())
    want = fast_tree.leaf_page_of(f, qd)
    sync_free(lambda: spec(qd))                         # capture
    fs.flat_descent.launches = 0
    got = [sync_free(lambda: spec(qd)) for _ in range(2)]
    assert fs.flat_descent.launches == 2 and spec.captures.n == 1
    assert all(torch.equal(g, want) for g in got)
    assert torch.equal(want, fast_tree.leaf_page_of_plain(f, qd))
    small = np.sort(keys[:100])
    for ks, w in ((small, 128), (np.arange(0, 1 << 25, 2, dtype=np.int32),
                                 1)):
        c = css_tree.build(ks, node_width=w, device=cuda)
        assert c.depth == (0 if w == 128 else 23)
        qq = torch.from_numpy(np.concatenate([q, ks[::97]])).to(cuda)
        got = sync_free(lambda: css_tree.search(c, qq))
        assert torch.equal(got, fs.flat_descent_plain(
            qq, c.dir_keys, css_tree.descent_args(c), c.leaf_pad,
            c.leaf_width, ending="leaf", n=c.n, stage=c.stage))
        assert np.array_equal(got.cpu().numpy(),
                              flat_rank(ks, qq.cpu().numpy()))


@pytest.mark.cuda
def test_flat_kernels_refuse_what_they_cannot_take(cuda):
    from repro_torch.core import css_tree, sorted_array
    from repro_torch.kernels import flat_search as fs
    keys = np.arange(0, 3000, 3, dtype=np.int32)
    c = css_tree.build(keys, node_width=16, device=cuda)
    d = css_tree.descent_args(c)
    q16 = torch.zeros(4, dtype=torch.int16, device=cuda)
    with pytest.raises(TypeError, match="int32, float32"):
        fs.flat_descent(q16, c.dir_keys, d, c.leaf_pad, c.leaf_width,
                        ending="leaf", n=c.n, stage=c.stage)
    qf = torch.zeros(4, dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError, match="must be torch.float32"):
        fs.flat_descent(qf, c.dir_keys, d, c.leaf_pad, c.leaf_width,
                        ending="leaf", n=c.n, stage=c.stage)
    b = sorted_array.build(keys, device=cuda)
    on_cpu = sorted_array.build(keys, device="cpu")
    with pytest.raises(ValueError, match="contiguous on the queries'"):
        fs.flat_binary(on_cpu.keys_pad, qf.int(), n_pad=b.n_pad, cutoff=1,
                       n=b.n, stage=b.stage)
    with pytest.raises(ValueError, match="BinaryStage"):
        fs.flat_binary(b.keys_pad, qf.int(), n_pad=b.n_pad, cutoff=2,
                       n=b.n, stage=b.stage)
    with pytest.raises(ValueError, match="DescentStage"):
        fs.flat_descent(qf.int(), c.dir_keys, d, c.leaf_pad, c.leaf_width,
                        ending="leaf", n=c.n, stage=b.stage)
    qd = torch.from_numpy(keys[::2].copy()).to(cuda)
    strided = sorted_array.search(b, torch.from_numpy(keys).to(cuda)[::2])
    assert torch.equal(strided, sorted_array.search(b, qd))


# ---- the generated NitroGen kernel (kernels/nitrogen_codegen.py)
NG_CONFIGS = {
    "l2w3-binary": dict(levels=2, node_width=3),
    "l3w1-vector": dict(levels=3, node_width=1, bottom="vector"),
    "l2w2-css4": dict(levels=2, node_width=2, bottom="css",
                      css_node_width=4),
}


def ng_keys(dtype, rng, n=20_000):
    """Keys with a run of INT32_MIN / -0.0 that holds separators,
    duplicates, subnormals (float32) and wide magnitudes."""
    n_edge, n_dup = n // 4, n // 20
    m = n - n_edge - n_dup
    if dtype == np.int32:
        body = rng.integers(I32.min, I32.max - 1, m, dtype=np.int64)
        edge = np.full(n_edge, I32.min)
    else:
        body = rng.normal(size=m) * 10.0 ** rng.integers(-20, 20, m)
        body[:6] = [1e-45, -1e-45, 3e-45, 1e-39, 3.4e38, -3.4e38]
        edge = np.full(n_edge, -0.0)
    keys = np.concatenate([body, edge, rng.choice(body, n_dup)])
    return keys.astype(dtype)[rng.permutation(n)]


def ng_queries(keys, rng):
    if keys.dtype == np.int32:
        extra = [I32.min, I32.min + 1, I32.max, I32.max - 1, 0]
        rand = rng.integers(I32.min, I32.max, 50_000, dtype=np.int64)
    else:
        extra = [np.inf, -np.inf, 0.0, -0.0, np.nan, 1e-45, -1e-45, 2e-45]
        rand = rng.normal(size=50_000) * 10.0 ** rng.integers(-20, 20,
                                                               50_000)
    return np.concatenate([keys, rand, extra]).astype(keys.dtype)


def ng_case(cuda, name, dtype):
    """(card index, CPU index, queries): a tiered top when ``name`` is a
    page count, else a flat NitroGen index of NG_CONFIGS."""
    from repro_torch.core import nitrogen
    rng = np.random.default_rng(5)
    if isinstance(name, int):
        keys = ng_keys(dtype, rng, name * 128 - (50 if name == 37 else 0))
        idx = [tiered.build(keys, leaf_width=128, device=d).top
               for d in (cuda, "cpu")]
    else:
        keys = ng_keys(dtype, rng)
        idx = [nitrogen.build(keys, **NG_CONFIGS[name], device=d)
               for d in (cuda, "cpu")]
    return idx[0], idx[1], ng_queries(keys, rng)


def sync_free(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("name", [*NG_CONFIGS, 256, 37])
def test_generated_nitrogen_kernel_equals_plain(cuda, name, dtype):
    """Each index's generated kernel: one launch a search with no host
    sync, bit for bit with the plain network and bottom on the same card
    tensors, with the CPU build and (real queries) with numpy; the tiered
    top's clip to the last page inside the same launch. The source holds
    every separator as a literal."""
    from repro_torch.core import nitrogen
    from repro_torch.kernels import nitrogen_codegen as cg
    idx, cpu, q = ng_case(cuda, name, dtype)
    assert idx.kernel is not None and cpu.kernel is None
    assert idx.library.endswith(".cubin") and idx.tree_bytes == 0
    src = idx.kernel.source
    assert src == nitrogen.kernel_source(cpu)
    f = idx.node_width + 1
    assert cg.read_literals(src, dtype).size == \
        idx.node_width * (f**idx.levels - 1) // (f - 1)
    clip = name - 1 if isinstance(name, int) else None
    qd = torch.from_numpy(q).to(cuda)
    cg.nitrogen_search.launches = 0
    got = sync_free(lambda: nitrogen.search(idx, qd, clip=clip))
    assert cg.nitrogen_search.launches == 1
    fn = nitrogen.searcher(idx)
    assert torch.equal(sync_free(lambda: fn(qd)),
                       nitrogen.search(idx, qd))
    want = nitrogen.search_plain(idx, qd, clip)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), nitrogen.search(cpu, q, clip=clip))
    if clip is None:
        real = ~np.isnan(q) if dtype == np.float32 else slice(None)
        assert np.array_equal(got.cpu().numpy()[real],
                              np.searchsorted(cpu.keys.numpy(), q[real]))
    empty = nitrogen.search(idx, qd[:0])
    assert empty.shape == (0,) and cg.nitrogen_search.launches == 3


# each way the kernel reads a bottom (kernels/nitrogen_codegen.layout), at
# sizes where the lower bound reads all its arrays: (build arguments, keys)
NG_BOTTOMS = {
    # rows of 32,768 slots: the stage array, the sample (a level and its
    # window), the row's window
    "binary": (dict(levels=3, node_width=3), 1_200_000),
    # phase 21's float pass: 256 rows of 4,096, stage, sample window, window
    "vector-wide": (dict(levels=4, node_width=3, bottom="vector"),
                    256 * 4096),
    # rows of 30,001 keys (not whole 16-byte pieces): staged levels, then
    # 4-byte probes of the row and its last slot, no window
    "vector-odd": (dict(levels=2, node_width=2, bottom="vector"),
                   9 * 30_001),
    # 4-key rows (the tiered top's): counted key by key, 16 bytes a load
    "vector-short": (dict(levels=3, node_width=3, bottom="vector"), 256),
    # 3 directory levels of 16 keys, leaves of 17
    "css": (dict(levels=3, node_width=3, bottom="css", css_node_width=16),
            400_000),
}
NG_DTYPES = [np.int32, np.float32, np.int64, np.float64]


def ng_wide_keys(dtype, rng, n):
    """Keys of ``dtype`` with a run of the domain's low edge (the minimum,
    or -0.0), duplicates across block edges and, for floats, subnormals,
    signed zeros and wide magnitudes."""
    dtype = np.dtype(dtype)
    n_edge, n_dup = n // 5, n // 10
    m = n - n_edge - n_dup
    if dtype.kind == "i":
        info = np.iinfo(dtype)
        body = rng.integers(info.min, info.max - 1, m, dtype=np.int64)
        edge = np.full(n_edge, info.min)
    else:
        tiny = np.finfo(dtype).smallest_subnormal
        body = rng.normal(size=m) * 10.0 ** rng.integers(-20, 20, m)
        body[:6] = [tiny, -tiny, 3 * tiny, 0.0, np.finfo(dtype).max,
                    -np.finfo(dtype).max]
        edge = np.full(n_edge, -0.0)
    keys = np.concatenate([body, edge, np.repeat(rng.choice(body, n_dup // 5),
                                                 5)])
    return keys.astype(dtype)[rng.permutation(keys.size)]


def ng_wide_queries(keys, rng, n):
    """``n`` queries: the keys, random values of the domain, its edges and
    the sentinel; for floats also +-inf, +-0.0, NaN and subnormals."""
    dtype = keys.dtype
    if dtype.kind == "i":
        info = np.iinfo(dtype)
        extra = [info.min, info.min + 1, info.max, info.max - 1, 0, -1]
        rand = rng.integers(info.min, info.max, n, dtype=np.int64)
    else:
        tiny = np.finfo(dtype).smallest_subnormal
        extra = [np.inf, -np.inf, 0.0, -0.0, np.nan, -np.nan, tiny, -tiny,
                 2 * tiny, np.finfo(dtype).max]
        rand = rng.normal(size=n) * 10.0 ** rng.integers(-20, 20, n)
    q = np.concatenate([extra, rng.choice(keys, n // 2), rand]).astype(dtype)
    return q[:n]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NG_DTYPES,
                         ids=["int32", "float32", "int64", "float64"])
@pytest.mark.parametrize("name", list(NG_BOTTOMS))
def test_generated_bottoms_equal_plain(cuda, name, dtype):
    """Every bottom's read path, for each key type: the kernel equals the
    plain network and bottom bit for bit at 1 query, at a block of threads
    and one, and past one persistent grid's worth of queries (a staging
    launch: every block copies the stage array into shared memory, each
    thread takes several queries); with a clip; replayed from a CUDA
    graph; one launch a call, no host sync; and numpy's searchsorted on
    the queries that are not NaN."""
    from repro_torch.core import nitrogen
    from repro_torch.engine.capture import Captures, Specialized
    from repro_torch.kernels import nitrogen_codegen as cg
    cfg, n = NG_BOTTOMS[name]
    rng = np.random.default_rng(13)
    keys = ng_wide_keys(dtype, rng, n)
    idx = nitrogen.build(keys, **cfg, device=cuda)
    top, dev = idx.kernel, cuda.index or 0
    lay = {k: cg.defined(top.source, k, -1)
           for k in ("NG_LINEAR", "NG_STAGE_LEVELS", "NG_SAMPLE")}
    lower_bound = name in ("binary", "vector-wide", "vector-odd")
    assert lay["NG_LINEAR"] == (name == "vector-short")
    assert (lay["NG_STAGE_LEVELS"] > 0) == lower_bound
    assert lay["NG_SAMPLE"] == (name in ("binary", "vector-wide"))
    assert top.shared == idx.stage.numel() * idx.stage.element_size()
    blocks, threads, _, staging = top.launch(dev, 1 << 30)
    assert staging == lower_bound
    n_full = blocks * threads + 12_345 if staging else 100_000
    assert top.launch(dev, n_full)[3] == staging
    assert top.launch(dev, 257)[3] == 0
    q = ng_wide_queries(keys, rng, n_full)
    qd = torch.from_numpy(q).to(cuda)
    srt = np.sort(keys)
    real = ~np.isnan(q) if q.dtype.kind == "f" else np.ones(q.size, bool)
    for n_q in (1, 257, q.size):
        x = qd[:n_q]
        cg.nitrogen_search.launches = 0
        got = sync_free(lambda: nitrogen.search(idx, x))
        assert cg.nitrogen_search.launches == 1
        assert torch.equal(got, nitrogen.search_plain(idx, x)), n_q
    assert np.array_equal(got.cpu().numpy()[real],
                          np.searchsorted(srt, q[real]))
    clip = idx.n // 3
    got = nitrogen.search(idx, qd, clip=clip)
    assert torch.equal(got, nitrogen.search_plain(idx, qd, clip))
    spec = Specialized(lambda x: nitrogen.search(idx, x), device=cuda,
                       captures=Captures())
    spec(qd)                                    # warm-up and capture
    cg.nitrogen_search.launches = 0
    replay = sync_free(lambda: spec(qd))
    assert cg.nitrogen_search.launches == 1
    assert torch.equal(replay, nitrogen.search_plain(idx, qd))


@pytest.mark.cuda
def test_small_tiered_index_never_runs_the_eager_network(cuda):
    """A tiered index of 256 pages on the card: its lookup, search_range
    and scans go through one launch of the top's generated kernel a
    descent, never the plain network; a specialized twin replays it and
    the replay counts the launch."""
    from repro_torch.core import IndexConfig, build_index
    from repro_torch.kernels import nitrogen_codegen as cg
    rng = np.random.default_rng(6)
    keys = rng.choice(1 << 30, 32_768, replace=False).astype(np.int32)
    vals = np.arange(keys.size, dtype=np.int32)
    args, spec = (build_index(keys, vals, IndexConfig(
        kind="tiered", specialize=s)) for s in (False, True))
    for idx in (args, spec):
        assert idx.impl.top_kind == "nitrogen" and idx.impl.num_pages == 256

        def boom(q):
            raise AssertionError("the eager network ran on the card")
        object.__setattr__(idx.impl.top, "network", boom)
    q = torch.from_numpy(np.concatenate([
        keys[:20_000], rng.integers(0, 1 << 30, 20_000).astype(np.int32)])
        ).to(cuda)
    cg.nitrogen_search.launches = 0
    got = sync_free(lambda: args.lookup(q))
    assert cg.nitrogen_search.launches == 1
    srt = np.sort(keys)
    assert np.array_equal(got.rank.cpu().numpy(),
                          np.searchsorted(srt, q.cpu().numpy()))
    lo, hi = q[:4096], q[:4096] + 50_000
    cg.nitrogen_search.launches = 0
    r_lo, r_hi, cnt = sync_free(lambda: args.search_range(lo, hi))
    assert cg.nitrogen_search.launches == 1          # both ends at once
    assert np.array_equal(r_hi.cpu().numpy(),
                          np.searchsorted(srt, hi.cpu().numpy(), "right"))
    args.scan_range(lo, hi)
    first = sync_free(lambda: spec.lookup(q))         # warm-up and capture
    cg.nitrogen_search.launches = 0
    for _ in range(2):
        assert_fields_equal(sync_free(lambda: spec.lookup(q)), got,
                            "specialized lookup")
    torch.cuda.synchronize()
    assert_fields_equal(first, got, "specialized lookup (capture)")
    assert spec.impl.captures.n == 1
    assert cg.nitrogen_search.launches == 2          # one a replay


@pytest.mark.cuda
def test_generated_kernel_builds_and_launches_from_another_thread(cuda):
    """A thread that has made no CUDA call loads a generated kernel and is
    left with no current context; it builds an index (nvcc, the cubin
    loaded into the card's context, one launch) and searches it; the main
    thread's searches of it equal the thread's, and the main thread's
    context is the one it had."""
    import threading
    from repro_torch.core import nitrogen
    from repro_torch.kernels import _driver
    from repro_torch.kernels import nitrogen_codegen as cg
    keys = np.arange(0, 3 * 70_001, 3, dtype=np.int32)
    q = torch.arange(-5, 3 * 70_001 + 5, 7, dtype=torch.int32, device=cuda)
    out = {}
    ctx = _driver.current_context()

    def work():
        try:
            # the driver pushes the card's context for its call and pops
            # it: the thread is left as it was, with no context
            image = cg.compile_top(cg.generate(
                7, dtype=np.int32, bottom="binary", n=1, block_width=1,
                block_pad_width=1, block_pad_len=1), torch.int32)._image
            module, _ = _driver.load_function(image, cuda.index or 0,
                                              cg.KERNEL)
            out["ctx"] = _driver.current_context()
            _driver.unload({cuda.index or 0: module})
            out["idx"] = idx = nitrogen.build(keys, levels=2, node_width=3,
                                              device=cuda)
            out["got"] = nitrogen.search(idx, q)
            torch.cuda.synchronize()
        except Exception as e:          # re-raised in the test's thread
            out["error"] = e

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "error" not in out, out.get("error")
    assert out["ctx"] is None
    want = np.searchsorted(keys, q.cpu().numpy())
    assert np.array_equal(out["got"].cpu().numpy(), want)
    assert torch.equal(nitrogen.search(out["idx"], q), out["got"])
    assert _driver.current_context() == ctx


@pytest.mark.cuda
def test_small_store_repack_derives_a_new_kernel(cuda):
    """A mutable tiered store of ~40 pages on the card: a repack
    re-derives the top into another generated kernel; lookups before and
    after equal numpy and launch the top's kernel once. The superseded
    kernel is released with the old top: its module unloaded, its build
    files deleted."""
    import weakref
    from pathlib import Path
    from repro_torch.core import IndexConfig, build_index
    from repro_torch.kernels import nitrogen_codegen as cg
    rng = np.random.default_rng(12)
    keys = np.unique(rng.integers(0, 10**6, 4_000).astype(np.int32))
    store = build_index(keys, keys, IndexConfig(
        kind="tiered", mutable=True, leaf_width=128, delta_capacity=256))
    assert store.base.top_kind == "nitrogen"
    lib0, pages0 = store.base.top.library, store.base.num_pages
    old = weakref.ref(store.base.top.kernel)
    assert Path(lib0).exists()
    b = store.base
    p = b.num_pages // 2
    new = np.setdiff1d(np.arange(b.seps[p - 1] + 1, b.seps[p] + 1),
                       keys)[:200].astype(np.int32)
    store.insert(new, new)
    store.flush()
    assert store.stats["splits"] >= 1 and store.base.num_pages != pages0
    assert store.base.top.library != lib0
    assert old() is None and cg.release_unused() >= 1
    assert not Path(lib0).exists()
    assert not Path(lib0).with_suffix(".cu").exists()
    assert Path(store.base.top.library).exists()
    allk = np.union1d(keys, new)
    q = np.concatenate([allk, rng.integers(0, 10**6, 5_000)]
                       ).astype(np.int32)
    cg.nitrogen_search.launches = 0
    qd = torch.from_numpy(q).to(cuda)
    got = sync_free(lambda: store.lookup(qd))
    assert cg.nitrogen_search.launches == 1
    found = np.isin(q, allk)
    assert np.array_equal(got.found.cpu().numpy(), found)
    assert np.array_equal(got.values.cpu().numpy()[found], q[found])


def reduced_model(arch, device, seed=0):
    """A reduced model of ``arch`` with weights drawn on the CPU, and the
    same weights on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    cpu = T.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(device)
    return cfg, cpu, to(cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,groups", [(8.0, 1), (0.5, 1), (1.25, 4)])
def test_moe_block_on_the_card_matches_the_cpu(cuda, cap, groups):
    """moe_block on the card == the CPU port at reduced width: the routing
    bit for bit (the same router logits go through both), the outputs and
    aux loss to 1e-4; with ample capacity, with drops, grouped."""
    import dataclasses
    from repro_torch.models import moe as M
    cfg, cpu, dev = reduced_model("mixtral-8x7b", cuda)
    cfg = dataclasses.replace(cfg, capacity_factor=cap, moe_groups=groups)
    p_cpu, p_dev = cpu["layers"][0]["moe"], dev["layers"][0]["moe"]
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y, aux = M.moe_block(cfg, p_cpu, x)
    yd, auxd = M.moe_block(cfg, p_dev, x.to(cuda))
    torch.testing.assert_close(yd.cpu(), y, rtol=0, atol=1e-4)
    torch.testing.assert_close(auxd.cpu(), aux, rtol=0, atol=1e-5)
    logits = torch.randn(48, cfg.n_experts, generator=torch.Generator()
                         .manual_seed(2))
    logits[::3] = logits[::3].round()                     # ties
    for a, b in zip(M.tournament_topk(logits, cfg.topk),
                    M.tournament_topk(logits.to(cuda), cfg.topk)):
        assert torch.equal(a, b.cpu())
    ids = torch.randint(0, cfg.n_experts, (3, 40),
                        generator=torch.Generator().manual_seed(3))
    for C in (1, 4, 40):
        for a, b in zip(M._dispatch_slots(ids, cfg.n_experts, C),
                        M._dispatch_slots(ids.to(cuda), cfg.n_experts, C)):
            assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_mamba_decode_step_on_the_card_matches_the_cpu(cuda):
    """A mamba2 prefill and two decode steps on the card == the CPU port:
    the logits and the conv / SSM states to 1e-4."""
    from repro_torch.models import transformer as T
    cfg, cpu, dev = reduced_model("mamba2-370m", cuda)
    toks = torch.randint(0, cfg.vocab, (3, 11),
                         generator=torch.Generator().manual_seed(4))
    f32 = dict(compute_dtype=torch.float32)
    lg, c = T.prefill(cfg, cpu, toks, max_len=16, **f32)
    lgd, cd = T.prefill(cfg, dev, toks.to(cuda), max_len=16, **f32)
    for step in range(2):
        torch.testing.assert_close(lgd.cpu(), lg, rtol=0, atol=1e-4)
        for name in ("conv", "ssm"):
            torch.testing.assert_close(cd[name].cpu(), c[name], rtol=0,
                                       atol=1e-4)
        tok = lg.argmax(-1).int()
        lg, c = T.decode_step(cfg, cpu, tok, c, **f32)
        lgd, cd = T.decode_step(cfg, dev, tok.to(cuda), cd, **f32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b"])
def test_moe_and_hybrid_decode_step_make_no_sync(cuda, arch):
    """One sampled decode step (sample + decode_step) of an MoE and of a
    hybrid model under sync-debug mode "error"; its logits equal the same
    step's on the CPU to 1e-4."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import SamplerConfig
    from repro_torch.serve import sampler as S
    cfg, cpu, dev = reduced_model(arch, cuda)
    toks = torch.randint(0, cfg.vocab, (4, 9),
                         generator=torch.Generator().manual_seed(5))
    f32 = dict(compute_dtype=torch.float32)
    lgd, cd = T.prefill(cfg, dev, toks.to(cuda), max_len=32, **f32)
    scfg = SamplerConfig(temperature=0.8, top_p=0.9)
    gen = torch.Generator(cuda).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nxt = S.sample(lgd, scfg, generator=gen)
        out, cd = T.decode_step(cfg, dev, nxt, cd, **f32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, c = T.prefill(cfg, cpu, toks, max_len=32, **f32)
    want, _ = T.decode_step(cfg, cpu, nxt.cpu(), c, **f32)
    torch.testing.assert_close(out.cpu(), want, rtol=0, atol=1e-4)
    assert bool(torch.isfinite(out[:, :cfg.vocab]).all())


@pytest.mark.cuda
def test_tune_legs_on_the_card_time_each_rep_to_completion(cuda, tmp_path):
    """On the card a trial's lookup and scan legs hold one observation a
    rep, each from the call to the device's completion: at a batch whose
    device time is many times its dispatch time, the lookup's mean is at
    least that device time. verify_profile times its lookups so too."""
    from repro_torch.core import IndexConfig, build_index
    from repro_torch.tune import autotune, run_trial, verify_profile
    from repro_torch.tune.autotune import _workload
    n, q_n = 1 << 22, 1 << 20
    knobs = {"tile": 128, "leaf_width": None, "histogram_max_pages": 32,
             "queue_min_flush": 32, "queue_deadline_s": 1e-3}
    prev = schedule.set_plan_thresholds()
    try:
        keys, q, _, _ = _workload(n, q_n)
        store = build_index(keys, None, IndexConfig(
            kind="tiered", mutable=True, specialize=True, tile=128),
            device=cuda)
        qd = torch.from_numpy(q).to(cuda)
        store.lookup(qd)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        store.lookup(qd)
        end.record()
        torch.cuda.synchronize()
        store.close()
        device_s = start.elapsed_time(end) / 1e3
        t = run_trial(knobs, n=n, q_n=q_n, reps=4, device=cuda)
        obj = t["objective"]
        assert obj["lookup"]["count"] == 4 and obj["scan"]["count"] == 4
        assert obj["lookup"]["mean"] >= 0.8 * device_s, (obj, device_s)
        d = str(tmp_path)
        prof, _ = autotune(smoke=True, n=n, q_n=q_n, reps=4,
                           profile_dir=d, device=cuda)
        v = verify_profile(prof, profile_dir=d, n=n, q_n=q_n, reps=4,
                           device=cuda)
        # p50 is its bucket's upper bound, so at least the median
        assert v["fresh_p50"] >= 0.8 * device_s, (v, device_s)
    finally:
        schedule.set_plan_thresholds(**prev)


# ------------------------------------------------------------------ training
def _two_train_steps(cfg, host_params, device, seed: int = 0) -> list:
    """[loss, grad norm] of two float32 train steps on ``device`` from
    copies of ``host_params``, on the data pipeline's batches."""
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig, init_state
    from repro_torch.train import make_train_step
    params = T.from_reference_params(cfg, T.to_reference_params(
        cfg, host_params), device=device)
    state = init_state(params)
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=10),
                           compute_dtype=torch.float32, ce_chunk=8,
                           attn_chunks=(8, 8))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=seed)
    out = []
    for s in range(2):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in batch_at(dcfg, s).items()}
        params, state, m = step(params, state, batch)
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced dense and MoE model: two steps (chunked attention, remat,
    chunked CE, AdamW) on the card and on the CPU from the same params;
    float32 with TF32 off, so the losses and grad norms differ only by
    summation order (rtol 1e-4)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    host = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = np.array(_two_train_steps(cfg, host, cuda))
    cpu = np.array(_two_train_steps(cfg, host, torch.device("cpu")))
    assert np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_chunked_attention_on_the_card_matches_plain(cuda, dtype, tol):
    """Forward and grads of the chunked attention (GQA, causal, a ragged
    sequence) against autograd through masked_attention; errors over the
    largest value (bf16: one rounding of the outputs)."""
    from repro_torch.models.flash_attention import (flash_attention,
                                                    masked_attention)
    g = torch.Generator(cuda).manual_seed(1)
    B, S, Hq, Hkv, D = 2, 300, 8, 2, 64
    ins = [torch.randn(shape, generator=g, device=cuda).to(dtype)
           for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    dout = torch.randn((B, S, Hq, D), generator=g, device=cuda).to(dtype)
    pos = torch.arange(S, device=cuda)
    ok = (pos[:, None] >= pos[None, :])[None]
    res = []
    for fn in (lambda a, b, c: flash_attention(a, b, c, True, None, 128, 64),
               lambda a, b, c: masked_attention(a, b, c, ok)):
        xs = [x.detach().clone().requires_grad_() for x in ins]
        out = fn(*xs)
        res.append([out.detach(), *torch.autograd.grad(out, xs, dout)])
    for got, want in zip(*res):
        assert got.dtype == dtype and torch.isfinite(got).all()
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max())


@pytest.mark.cuda
def test_trainer_save_resume_on_the_card(cuda, tmp_path):
    """A reduced model's Trainer on the card saves at step 2; a second one
    resumes there and its steps 3-4 match the first's (rtol 1e-4: the
    embedding's backward scatter-adds in any order)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer, TrainConfig
    cfg = get_config("qwen3-0.6b").reduced()
    args = (cfg, OptConfig(lr=1e-3, warmup_steps=1, total_steps=10),
            DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4),
            TrainConfig(steps=4, ckpt_dir=str(tmp_path), ckpt_every=2))
    a = Trainer(*args, log=lambda s: None, device=cuda)
    a.run(2)
    b = Trainer(*args, log=lambda s: None, device=cuda)
    assert b.state.step == 2
    assert all(t.is_cuda for t in b.state.params["layers"][0].values()
               if isinstance(t, torch.Tensor))
    a.run()
    b.run()
    want = [h["loss"] for h in a.metrics_history[2:]]
    got = [h["loss"] for h in b.metrics_history]
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ------------------------------------------------------------- multi-rank
def card_world(fn, world, tmp, *args, backend="gloo"):
    """``fn`` in ``world`` ranks on the one card (gloo: NCCL refuses two
    ranks on one GPU; NCCL at world 1)."""
    import torch_dist_worlds as W
    return W.run_world(fn, world, tmp, *args, backend=backend)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_sharded_search_on_the_card(cuda, tmp_path, backend, world):
    import torch_dist_worlds as W
    res = card_world(W.card_search_case, world, tmp_path, backend=backend)
    keys, qs = res[0]["keys"], res[0]["queries"]
    want = np.searchsorted(np.sort(keys), qs)
    for r in res:
        np.testing.assert_array_equal(r["ranks"], want)
        np.testing.assert_array_equal(r["small"], want[:100])
        assert all(n > 0 for n in r["launches"]), r["launches"]
        assert r["page_equal"] and r["kary_equal"]


@pytest.mark.cuda
def test_compression_on_the_card_matches_the_cpu(cuda):
    from repro_torch.dist import compression as C
    from repro_torch.dist.sharding import MeshShape
    g = torch.Generator(cuda).manual_seed(3)
    for d in (4, 3):
        grads = {"w": torch.randn((d, 256, 64), generator=g, device=cuda),
                 "b": torch.randn((d, 9), generator=g, device=cuda) * 1e3}
        cpu = {k: v.cpu() for k, v in grads.items()}
        f = C.make_compressed_allreduce(MeshShape((d,), ("data",)), "data")
        err, err_c = C.init_error_state(grads), C.init_error_state(cpu)
        for _ in range(2):
            (out, err), (out_c, err_c) = f(grads, err), f(cpu, err_c)
            for k in grads:
                assert torch.equal(out[k].cpu(), out_c[k])
                assert torch.equal(err[k].cpu(), err_c[k])


@pytest.mark.cuda
def test_sharded_train_step_on_the_card(cuda, tmp_path):
    """One float32 step of reduced qwen3 at mesh (2, 1), two ranks on the
    card, against the single-device step on the card: loss, grad norm and
    lr to 1e-5, params to 1e-6 where |m| > 1e-6 and within 2 lr."""
    import torch_dist_worlds as W
    from repro_torch.configs import get_config
    from repro_torch.core.util import tree_leaves
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig, init_state
    from repro_torch.train import make_train_step
    cfg = get_config("qwen3-0.6b").reduced()
    host = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = T.to_reference_params(cfg, host)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["labels"][1, 4:] = -1
    res = card_world(W.train_case, 2, tmp_path, cfg, _numpy_tree(ref),
                     batch, 1e-3, 2, (2, 1), "cuda")
    params = T.from_reference_params(cfg, ref, device=cuda)
    opt = init_state(params)
    step = make_train_step(cfg, OptConfig(lr=1e-3), microbatches=2,
                           compute_dtype=torch.float32)
    params, opt, m = step(params, opt, {k: torch.from_numpy(v).to(cuda)
                                        for k, v in batch.items()})
    for r in res:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(r[k], float(m[k]), rtol=1e-5)
    got = res[0]["state"]["params"]
    want = T.to_reference_params(cfg, params)
    mom = T.to_reference_opt_state(cfg, opt)["m"]
    for x, y, mm in zip(tree_leaves(got), tree_leaves(want),
                        tree_leaves(mom)):
        d = (x - y).abs()
        assert float(d.max()) <= 2e-3
        sig = mm.abs() > 1e-6
        if bool(sig.any()):
            assert float(d[sig].max()) <= 1e-6


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()
