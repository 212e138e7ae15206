"""Grouped and composite analytics (DESIGN.md §8.3) — PyTorch port of
``repro/engine/groupby.py`` for the immutable tiered index: GROUP BY
bucket(key) aggregates, per-group top-K, and multi-range set predicates
(IN-lists as unions, conjunctive predicates as intersections), with no host
sync.

* **Group edges** (:func:`group_edges`) split each ``(lo, hi)`` range into
  ``G`` equal-width buckets by G+1 edges, with exact integer arithmetic
  (int64 here) and float edges whose bucket width has its low mantissa
  bits cut, so that every ``g * width`` is exact and the edges are
  bit-identical to the reference and to the numpy twin
  :func:`group_edges_host`.
* **Edge-prefix reduction** (:func:`make_edge_prefix`): count/sum bucket
  aggregates need only the prefix at each edge, one single-ended kernel
  lane per edge (``kernels.page_scan.page_prefix_bucketed``) plus the
  ``ScanAux`` prefixes; the buckets are adjacent-edge differences. min/max
  are not prefix-invertible, so "full" mode takes the Q·G span expansion.
* **Coverage-count composition** (:func:`coverage_ranges`): an R-range
  predicate becomes at most R disjoint canonical ranges, scanned through
  the span pipeline and folded back per query.

Over the mutable store the same paths are delta-aware: each delta tier's
prefix terms (:func:`_tier_prefix_terms`) apply the shadow correction of
DESIGN.md §6.3 to each edge's prefix, and the composite / full / top-K
paths reuse ``scan.make_paged_scan_fns`` (:func:`make_paged_group_fns`,
:func:`make_delta_group_fns`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..core.util import numpy_dtype
from ..kernels import page_scan as _pscan
from ..kernels.page_scan import agg_identities
from ..obs import annotate
from . import scan as _scan
from .schedule import edge_scan_plan, ladder_grid, run_scheduled_multi

MAX_GROUPS = 65536     # the reference's bound (its uint32 edge arithmetic)
MULTI_OPS = ("union", "intersect")


# ----------------------------------------------------------------- results
@dataclass(frozen=True)
class GroupScanResult:
    """Batched grouped-scan result; [Q, G] per bucket unless noted.

    count    int32 matches per bucket
    edges    [Q, G+1] bucket edges: bucket g covers ``[edges[g],
             edges[g+1])``; ``edges[0] = lo``, ``edges[G] = succ(hi)``;
             an empty query (lo > hi) pins every edge to lo
    r_edge   [Q, G+1] int32 searchsorted-left rank of each edge
    vsum/vmin/vmax  per-bucket aggregates (None above the requested depth
             or without values); empty buckets report 0 / dtype-max /
             dtype-min, int32 sums wrap
    topk_values  [Q, G, K] the top-K values per bucket, descending (0 past
             the bucket's min(count, K)); None unless top_k was asked
    topk_ranks   [Q, G, K] their global ranks (-1 past count)
    overflow bool [Q, G]: the bucket held more than the candidate window
    """
    count: torch.Tensor
    edges: torch.Tensor
    r_edge: torch.Tensor
    vsum: Optional[torch.Tensor] = None
    vmin: Optional[torch.Tensor] = None
    vmax: Optional[torch.Tensor] = None
    topk_values: Optional[torch.Tensor] = None
    topk_ranks: Optional[torch.Tensor] = None
    overflow: Optional[torch.Tensor] = None


# ------------------------------------------------------------- group edges
def _succ_of(x, kd):
    if np.issubdtype(kd, np.floating):
        return torch.nextafter(x, torch.full_like(x, float("inf")))
    return x + 1


def _pred_of(x, kd):
    if np.issubdtype(kd, np.floating):
        return torch.nextafter(x, torch.full_like(x, float("-inf")))
    return x - 1


def _width_drop_bits(G: int, kd) -> int:
    """Mantissa bits to cut from a float bucket width so that every product
    ``g * width`` (g <= G) is exact in key precision: an exact product
    makes ``lo + g * width`` one rounding, fused or not."""
    return int(G).bit_length()


def _trunc_mantissa(w: torch.Tensor, drop: int) -> torch.Tensor:
    it = torch.int32 if w.dtype == torch.float32 else torch.int64
    return (w.view(it) & ~((1 << drop) - 1)).view(w.dtype)


def group_edges(lo: torch.Tensor, hi: torch.Tensor, num_groups: int,
                key_dtype) -> torch.Tensor:
    """[Q, G+1] bucket edges for Q ``(lo, hi)`` ranges.

    Integer keys: exactly ``e_g = min(lo + g * width, hi + 1)`` with
    ``width = (hi - lo) // G + 1``, in int64, as ``group_edges_host``.
    Floats: ``e_g = min(lo + g * width, nextafter(hi))``, ``width`` the
    product ``(hi - lo) * float32(1/G)`` (a multiply by a float32 tensor,
    never a division) with its mantissa cut so ``g * width`` is exact, the
    endpoints pinned exactly. Empty queries (lo > hi) pin all edges to lo.
    """
    G = int(num_groups)
    kd = np.dtype(key_dtype)
    empty = (lo > hi)[:, None]
    if np.issubdtype(kd, np.floating):
        succ = _succ_of(hi, kd)[:, None]
        g = torch.arange(G + 1, dtype=lo.dtype, device=lo.device)[None, :]
        inv_g = torch.full((), float(kd.type(1.0 / G)), dtype=lo.dtype,
                           device=lo.device)
        width = _trunc_mantissa((hi - lo) * inv_g,
                                _width_drop_bits(G, kd))[:, None]
        e = torch.minimum(lo[:, None] + g * width, succ)
        # lo = -inf with an infinite width makes interior edges NaN
        # (-inf + inf): bucket 0 takes the whole range then
        e = torch.where(torch.isnan(e), succ, e)
        # endpoints pinned exactly (also kills the 0 * inf NaN when the
        # span overflows to an infinite width)
        e[:, 0] = lo
        e[:, G] = succ[:, 0]
    else:
        l64 = lo.long()[:, None]
        s = hi.long()[:, None] - l64
        width = torch.div(s, G, rounding_mode="floor") + 1
        g = torch.arange(G + 1, dtype=torch.int64, device=lo.device)[None, :]
        e = torch.minimum(l64 + g * width, l64 + s + 1).to(lo.dtype)
    return torch.where(empty, lo[:, None], e)


def group_edges_host(lo, hi, num_groups: int) -> np.ndarray:
    """Numpy twin of :func:`group_edges` (bit-identical): int64 exact math
    for integer keys, the same key-precision float ops for floats."""
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    G = int(num_groups)
    kd = lo.dtype
    if np.issubdtype(kd, np.floating):
        succ = np.nextafter(hi, kd.type(np.inf))[:, None]
        g = np.arange(G + 1, dtype=kd)[None, :]
        it = np.int32 if kd == np.float32 else np.int64
        drop = _width_drop_bits(G, kd)
        width = ((hi - lo) * kd.type(1.0 / G)).view(it)
        width = (width & it(~((1 << drop) - 1))).view(kd)[:, None]
        with np.errstate(invalid="ignore"):
            e = np.minimum(lo[:, None] + g * width, succ)
            e = np.where(np.isnan(e), succ, e)
        e[:, 0] = lo
        e[:, -1] = succ[:, 0]
        e = e.astype(kd)
    else:
        l64 = lo.astype(np.int64)[:, None]
        s = hi.astype(np.int64)[:, None] - l64
        width = s // G + 1
        g = np.arange(G + 1, dtype=np.int64)[None, :]
        e = np.minimum(l64 + g * width, l64 + s + 1).astype(kd)
    return np.where((lo > hi)[:, None], lo[:, None], e)


# ------------------------------------------------- coverage-count composite
def coverage_ranges(lo_r: torch.Tensor, hi_r: torch.Tensor, *, op: str,
                    key_dtype):
    """Canonical decomposition of Q R-range predicates into at most R
    disjoint ascending ranges each ([Q, R] ``slo``/``shi``, inert-padded).

    2R endpoint events per query (+1 at lo, -1 at succ(hi); empty ranges
    weigh 0) are stably sorted by value: starts occupy the lower columns,
    so a start at the value of an end sorts first and touching segments
    merge. A running coverage sum marks where at least 1 (union) / all R
    (intersect) ranges cover the domain; each covered segment's rise
    scatters its start and its fall ``pred(value)`` into the j-th output
    column. Every rise consumes a distinct +1 event, so at most R segments
    exist; the other events scatter into a spare column R, cut off after.
    """
    if op not in MULTI_OPS:
        raise ValueError(f"unknown multi-range op {op!r}; "
                         f"want one of {MULTI_OPS}")
    kd = np.dtype(key_dtype)
    _, _, inert_lo, inert_hi = (x.item() for x in _scan._domain_consts(kd))
    Qn, R = lo_r.shape
    emptyr = lo_r > hi_r
    vals = torch.cat([lo_r, _succ_of(hi_r, kd)], dim=1)
    live = (~emptyr).int()
    deltas = torch.cat([live, -live], dim=1)
    order = torch.argsort(vals, dim=1, stable=True)
    sv = torch.gather(vals, 1, order)
    sd = torch.gather(deltas, 1, order)
    cov = torch.cumsum(sd, dim=1, dtype=torch.int32)
    covered = cov >= (1 if op == "union" else R)
    prev = torch.zeros_like(covered)
    prev[:, 1:] = covered[:, :-1]
    rise = covered & ~prev
    fall = ~covered & prev
    ridx = torch.where(rise, torch.cumsum(rise, 1, dtype=torch.int32) - 1, R)
    fidx = torch.where(fall, torch.cumsum(fall, 1, dtype=torch.int32) - 1, R)
    slo = torch.full((Qn, R + 1), inert_lo, dtype=lo_r.dtype,
                     device=lo_r.device).scatter_(1, ridx.long(), sv)
    shi = torch.full((Qn, R + 1), inert_hi, dtype=lo_r.dtype,
                     device=lo_r.device).scatter_(1, fidx.long(),
                                                  _pred_of(sv, kd))
    return slo[:, :R], shi[:, :R]


# -------------------------------------------------- edge-prefix reduction
def make_edge_prefix(page_of_raw: Callable, *, num_pages: int, tile: int,
                     with_sum: bool, mask_value=None) -> Callable:
    """The edge-prefix pass ``prefix(e, kpages, vpages, aux) -> (pcnt,
    psum)`` over N flat edge values: each edge descends the top tier to its
    page, one single-ended kernel lane counts (and, with ``with_sum``,
    sums) the in-page keys strictly below it, and the ``ScanAux`` prefixes
    supply the earlier pages. ``psum`` is None without ``with_sum`` (the
    value pages are never read)."""

    def prefix(e, kpages, vpages, aux: _scan.ScanAux):
        n_items = e.shape[0]
        with annotate("groupby/edge_of"):
            pids = page_of_raw(e).int()
        with annotate("groupby/edge_plan"):
            g_cap = ladder_grid(n_items, tile, num_pages)
            plan = edge_scan_plan(pids, tile, g_cap, num_pages)

        def body(qbs, step_pages, steps_used):
            outs = _pscan.page_prefix_bucketed(
                qbs[0], step_pages, kpages, vpages if with_sum else None,
                mask_value=mask_value, steps_used=steps_used)
            return outs if with_sum else (outs,)

        with annotate("groupby/page_prefix"):
            outs = run_scheduled_multi(plan, (e,), tile, g_cap, body)
        pl = pids.long()
        pcnt = aux.cum_cnt[pl] + outs[0]
        psum = aux.cum_sum[pl] + outs[1] if with_sum else None
        return pcnt, psum

    return prefix


def _tier_prefix_terms(e, t: _scan.TierView) -> dict:
    """Per-edge prefix terms of one delta tier, the strictly-below half of
    ``scan._tier_terms``: live keys below the edge, the sb / ss count
    correction (each such entry's base / sealed twin is physically counted
    below the same edge) and the matching value sums (only live sb / ss
    values subtract). One binary search an edge in the tier's sorted
    view, where the reference compares each edge with every slot."""
    p = t.pre[:, torch.searchsorted(t.keys, e).long()]
    return dict(below=p[0], below_sub=p[1], below_vsum=p[2],
                below_sub_vsum=p[3])


# ------------------------------------------------------------ top-K select
def masked_topk(vals: torch.Tensor, ranks: torch.Tensor,
                count: torch.Tensor, K: int):
    """[N, C] candidate windows (each row's valid candidates are the
    prefix of length ``min(count, C)``, in ascending key order) -> top-K
    by value, descending: ``(values [N, K], locators [N, K])`` with 0/-1
    past each row's ``min(count, C, K)``. Invalid lanes score the dtype's
    minimum. Ties go to the lower index, as ``lax.top_k`` breaks them: a
    stable descending sort, then the first K (``torch.topk`` promises no
    tie order), so a valid minimum-valued candidate beats the padding.
    Floats rank in ``lax.top_k``'s total order, +0.0 above -0.0: the sort
    runs on their bits mapped to an int32 of that order."""
    C = vals.shape[1]
    low = agg_identities(numpy_dtype(vals.dtype))[1].item()
    ar = torch.arange(max(C, K), dtype=torch.int32, device=vals.device)
    score = torch.where(ar[None, :C] < count[:, None], vals, low)
    key = score
    if score.dtype == torch.float32:
        b = score.view(torch.int32)
        key = b ^ ((b >> 31) & 0x7FFFFFFF)
    _, tidx = torch.sort(key, dim=1, descending=True, stable=True)
    tidx = tidx[:, :K]
    topv = torch.gather(score, 1, tidx)
    topr = torch.gather(ranks, 1, tidx)
    kvalid = ar[None, :K] < count.clamp_max(C)[:, None]
    return torch.where(kvalid, topv, 0), torch.where(kvalid, topr, -1)


# --------------------------------------------------------- generic makers
def _rs(x, *shape):
    return None if x is None else x.reshape(*shape)


def _multi_reduce(R: int, mode: str, cnt, vs, mn, mx, rlo, rhi):
    """Fold the [Q*R] per-subrange aggregates of a coverage decomposition
    back to [Q]: counts/sums add (int32 wraps), min/max combine (empty
    subranges carry identities), hull ranks span the nonempty subranges
    ((0, 0) when the whole predicate is empty)."""
    cnt = cnt.reshape(-1, R)
    count = cnt.sum(1, dtype=torch.int32)
    nz = cnt > 0
    imax = np.iinfo(np.int32).max
    r_lo = torch.where(count > 0,
                       torch.where(nz, rlo.reshape(-1, R), imax).amin(1),
                       0).int()
    r_hi = torch.where(count > 0,
                       torch.where(nz, rhi.reshape(-1, R), -1).amax(1),
                       0).int()
    vsum = vs.reshape(-1, R).sum(1, dtype=vs.dtype) if mode != "count" \
        else None
    # as jnp.min / jnp.max: -0.0 below +0.0 whatever the order
    vmin = _pscan.amin(mn.reshape(-1, R), 1) if mode == "full" else None
    vmax = _pscan.amax(mx.reshape(-1, R), 1) if mode == "full" else None
    return count, vsum, vmin, vmax, r_lo, r_hi


def make_group_makers(make_agg: Callable, make_mat: Optional[Callable],
                      key_dtype, *, prefix_path: Callable = None):
    """Assemble the grouped/composite functions from a scan family.

    * ``make_agg(mode) -> agg(lo, hi, *rest) -> (count, vsum, vmin, vmax,
      below, above)``;
    * ``make_mat(C, mode) -> mat(lo, hi, *rest) -> (..., ranks, vals,
      over)`` for the top-K candidates (None disables ``make_gtopk``);
    * ``prefix_path(with_sum) -> prefix(e, kpages, vpages, aux)`` enables
      the (G+1)-edge count/sum path; ``rest[:3]`` is then ``(kpages,
      vpages, aux)`` and the trailing operands after them that are delta
      tiers get their prefix corrections (:func:`_tier_prefix_terms`).
      The reference passes each tier as a group of five trailing operands
      (keys, vals, sb, ss, tomb) and ignores a tail that is not a multiple
      of five (the immutable scanner's flat values); here a tier is one
      ``scan.TierView`` operand (the same five planes, key-sorted with
      their prefixes), and any other trailing operand is ignored.

    Returns ``(make_gagg, make_gtopk, make_magg)``:

    * ``make_gagg(G, mode) -> gagg(lo, hi, *rest) -> (edges [Q, G+1],
      r_edge [Q, G+1], count [Q, G], vsum, vmin, vmax)``
    * ``make_gtopk(G, mode, K, C) -> gtopk(lo, hi, *rest) -> (edges,
      r_edge, count, vsum, vmin, vmax, topv [Q,G,K], topr, overflow)``
    * ``make_magg(R, op, mode) -> magg(lo_r [Q,R], hi_r [Q,R], *rest) ->
      (count [Q], vsum, vmin, vmax, r_lo, r_hi_excl)``
    """
    kd = np.dtype(key_dtype)
    inert_hi = _scan._domain_consts(kd)[3].item()

    def _bucket_bounds(lo, hi, G):
        """Per-bucket inclusive bound pairs [(e_g, pred(e_{g+1}))]; empty
        queries keep lo as the (inert) lower bound so rank anchors match
        scan_range's empty normalization."""
        edges = group_edges(lo, hi, G, kd)
        glo = edges[:, :-1]
        ghi = _pred_of(edges[:, 1:], kd).masked_fill((lo > hi)[:, None],
                                                     inert_hi)
        return edges, glo.reshape(-1), ghi.reshape(-1)

    def _r_edge(below, above, G):
        return torch.cat([below.reshape(-1, G),
                          above.reshape(-1, G)[:, -1:]], dim=1)

    def make_gagg(G: int, mode: str):
        if prefix_path is not None and mode in ("count", "sum"):
            pf = prefix_path(mode == "sum")

            def gagg(lo, hi, *rest):
                kpages, vpages, aux = rest[:3]
                edges = group_edges(lo, hi, G, kd)
                ef = edges.reshape(-1)
                pcnt, psum = pf(ef, kpages, vpages, aux)
                for t in rest[3:]:
                    if not isinstance(t, _scan.TierView):
                        continue
                    d = _tier_prefix_terms(ef, t)
                    pcnt = pcnt + d["below"] - d["below_sub"]
                    if psum is not None:
                        psum = psum + d["below_vsum"] - d["below_sub_vsum"]
                r_edge = pcnt.reshape(-1, G + 1)
                vsum = None if psum is None else \
                    torch.diff(psum.reshape(-1, G + 1), dim=1)
                return (edges, r_edge, torch.diff(r_edge, dim=1), vsum,
                        None, None)
            return gagg
        agg = make_agg(mode)

        def gagg(lo, hi, *rest):
            edges, glo, ghi = _bucket_bounds(lo, hi, G)
            count, vsum, vmin, vmax, below, above = agg(glo, ghi, *rest)
            return (edges, _r_edge(below, above, G), count.reshape(-1, G),
                    _rs(vsum, -1, G), _rs(vmin, -1, G), _rs(vmax, -1, G))
        return gagg

    def make_gtopk(G: int, mode: str, K: int, C: int):
        if make_mat is None:
            raise ValueError("top_k needs a materialize family")
        mat = make_mat(C, mode)

        def gtopk(lo, hi, *rest):
            edges, glo, ghi = _bucket_bounds(lo, hi, G)
            count, vsum, vmin, vmax, below, above, ranks, vals, over = \
                mat(glo, ghi, *rest)
            topv, topr = masked_topk(vals, ranks, count, K)
            return (edges, _r_edge(below, above, G), count.reshape(-1, G),
                    _rs(vsum, -1, G), _rs(vmin, -1, G), _rs(vmax, -1, G),
                    topv.reshape(-1, G, K), topr.reshape(-1, G, K),
                    over.reshape(-1, G))
        return gtopk

    def make_magg(R: int, op: str, mode: str):
        agg = make_agg(mode)

        def magg(lo_r, hi_r, *rest):
            slo, shi = coverage_ranges(lo_r, hi_r, op=op, key_dtype=kd)
            cnt, vs, mn, mx, rlo, rhi = agg(slo.reshape(-1),
                                            shi.reshape(-1), *rest)
            return _multi_reduce(R, mode, cnt, vs, mn, mx, rlo, rhi)
        return magg

    return make_gagg, make_gtopk, make_magg


def make_paged_group_fns(span_of: Callable, page_of_raw: Callable, *,
                         num_pages: int, lw_pad: int, tile: int, key_dtype,
                         mask_value=None):
    """The mutable paged store's grouped / composite family over the
    ``(lo, hi, kpages, vpages, aux, sealed, active)`` operands of
    ``scan.make_paged_scan_fns``, with the count / sum grouped path on the
    (G+1)-edge prefix pipeline plus the tiers' prefix corrections."""
    make_agg, make_mat = _scan.make_paged_scan_fns(
        span_of, num_pages=num_pages, lw_pad=lw_pad, tile=tile,
        key_dtype=key_dtype, mask_value=mask_value)
    prefixes = {}

    def prefix_path(with_sum: bool):
        p = prefixes.get(with_sum)
        if p is None:
            p = prefixes[with_sum] = make_edge_prefix(
                page_of_raw, num_pages=num_pages, tile=tile,
                with_sum=with_sum, mask_value=mask_value)
        return p

    return make_group_makers(make_agg, make_mat, key_dtype,
                             prefix_path=prefix_path)


def make_delta_group_fns(key_dtype):
    """The base-less twin (a mutable store before its first fold): the
    same makers over ``scan.make_delta_scan_fns``'s ``(sealed, active)``
    operands; every path goes through the per-bucket expansion."""
    make_agg, make_mat = _scan.make_delta_scan_fns(key_dtype)
    return make_group_makers(make_agg, make_mat, key_dtype)
