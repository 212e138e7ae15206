"""Batched range scans with aggregation pushdown (DESIGN.md §8) — PyTorch
port of ``repro/engine/scan.py`` for the immutable tiered index.

Q ``(lo, hi)`` range queries run as one pass with no host sync:

1. **Doubled-endpoint descent** — ``[lo; succ(hi)]`` descends the top tier
   once (``tiered._make_span_of``), giving each query its inclusive page
   span ``[page_lo, page_hi]``.
2. **Span expansion** — every span contributes exactly its two boundary
   scan items, endpoint-masked (a one-page span carries both bounds on the
   lower item and the upper item is inert). Interior pages are never
   scanned: their contribution comes from per-page aggregate arrays
   (``ScanAux``), prefix sums for count/sum and power-of-two sparse tables
   for min/max, O(1) per query.
3. **Scheduling** — the 2Q boundary items are bucketed by page through the
   device plan (``schedule.span_scan_plan``).
4. **Pushdown kernel** — ``kernels/page_scan.py`` scans one page row per
   grid step and returns per lane the endpoint-masked count / sum / min /
   max and the below-lo count that anchors the ranks. Matches are never
   written out unless ``materialize=K`` asks for the first K of each query.

The reference caches one ``jax.jit`` dispatch per shape; here the
pipelines are plain functions. Left out: the mutable store's delta-aware
scans (ROADMAP Queue 1 item 5B), the non-tiered kinds' ``FlatAggregator``
(item 12), the specialized index (item 11) and the scan's telemetry spans
and counters (item 10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.util import (as_queries, not_ported, numpy_dtype,
                         resolve_device, take)
from ..kernels import page_scan as _pscan
from ..kernels.page_scan import MODES, agg_identities
from . import tiered as _tiered
from .schedule import ladder_grid, run_scheduled_multi, span_scan_plan

VALUE_DTYPES = (np.dtype(np.int32), np.dtype(np.float32))


# ----------------------------------------------------------------- results
@dataclass(frozen=True)
class ScanResult:
    """Batched range-scan result; [Q]-shaped unless noted.

    count      int32 matches per query
    r_lo       searchsorted-left rank of lo
    r_hi_excl  r_lo + count (== searchsorted-right(hi); lo > hi normalizes
               to the empty interval at r_lo)
    vsum/vmin/vmax  pushed-down aggregates over int32/float32 values (None
               above the requested depth or without such values); an empty
               range reports 0 / dtype-max / dtype-min; int32 sums wrap,
               float32 sums depend on the reduction order (per-page
               partials + prefix differences); count/min/max are exact
    ranks      [Q, K] materialize mode: the matches' global ranks in key
               order, -1 past count
    values     [Q, K] the matching values (0 past count); None when the
               index has no values
    overflow   bool [Q]: count exceeded the materialize capacity K
    """
    count: torch.Tensor
    r_lo: torch.Tensor
    r_hi_excl: torch.Tensor
    vsum: Optional[torch.Tensor] = None
    vmin: Optional[torch.Tensor] = None
    vmax: Optional[torch.Tensor] = None
    ranks: Optional[torch.Tensor] = None
    values: Optional[torch.Tensor] = None
    overflow: Optional[torch.Tensor] = None


def mode_for_aggs(aggs, has_values: bool = True) -> str:
    """Map a requested aggregate set to the kernel's static pushdown mode
    ("count" | "sum" | "full"). ``aggs=None`` means the deepest mode the
    index supports. Names are validated regardless of ``has_values``."""
    if aggs is not None:
        want = set(aggs)
        unknown = want - {"count", "sum", "min", "max"}
        if unknown:
            raise ValueError(f"unknown aggregates {sorted(unknown)}; "
                             "want a subset of count/sum/min/max")
    if not has_values:
        return "count"
    if aggs is None:
        return "full"
    if want & {"min", "max"}:
        return "full"
    return "sum" if "sum" in want else "count"


# ------------------------------------------------------- domain constants
def _domain_consts(key_dtype):
    """(lo_min, hi_cap, inert_lo, inert_hi) for ``key_dtype``: the widest
    in-domain bound pair (every user key, never a sentinel slot) and an
    impossible pair (lo maximal, hi minimal) whose mask is empty for every
    slot, which is how a lane is switched off."""
    kd = np.dtype(key_dtype)
    if np.issubdtype(kd, np.floating):
        return (kd.type(-np.inf), np.finfo(kd).max,
                kd.type(np.inf), kd.type(-np.inf))
    info = np.iinfo(kd)
    return (kd.type(info.min), kd.type(info.max - 1),
            kd.type(info.max), kd.type(info.min))


# ------------------------------------------------- per-page aggregate aux
class ScanAux(NamedTuple):
    """Interior-page aggregates on the device.

    cum_cnt: [P+1] int32 exclusive prefix of per-page live counts;
    cum_sum: [P+1] value-dtype exclusive prefix of per-page value sums
             (int32 wraps);
    st_min/st_max: [L, P] power-of-two sparse tables over per-page value
             min/max (min/max are not prefix-invertible).
    """
    cum_cnt: torch.Tensor
    cum_sum: torch.Tensor
    st_min: torch.Tensor
    st_max: torch.Tensor


def sparse_table(per_page: np.ndarray, op, identity) -> np.ndarray:
    """[L, P] table: st[k, p] reduces pages [p, min(p + 2^k, P)).
    Range reduce over [a, b), b > a: k = floor(log2(b-a)),
    op(st[k, a], st[k, b - 2^k])."""
    P = int(per_page.size)
    L = max(P.bit_length(), 1)
    st = np.full((L, P), identity, per_page.dtype)
    if P:
        st[0] = per_page
    for k in range(1, L):
        h = 1 << (k - 1)
        st[k, :P - h] = op(st[k - 1, :P - h], st[k - 1, h:])
        st[k, P - h:] = st[k - 1, P - h:]
    return st


def page_aggregates(vals: np.ndarray, cnt: np.ndarray, mask_value=None):
    """Host-side per-page (sum, min, max) over the live prefix of each
    value row ([P, lw_pad] + [P] live counts). ``mask_value`` excludes
    matching values, as the kernel's mask does."""
    W = vals.shape[1]
    vd = vals.dtype
    id_min, id_max = agg_identities(vd)
    live = np.arange(W)[None, :] < np.asarray(cnt)[:, None]
    if mask_value is not None:
        live = live & (vals != vd.type(mask_value))
    psum = np.where(live, vals, 0).sum(axis=1, dtype=vd)
    # numpy, as the reference: its sign of a zero min / max depends on the
    # order (unlike jnp's), and these tables must be the reference's bits
    pmin = np.where(live, vals, id_min).min(axis=1)
    pmax = np.where(live, vals, id_max).max(axis=1)
    return psum, pmin, pmax


def build_page_aux(cnt: np.ndarray, vals: Optional[np.ndarray],
                   val_dtype=np.int32, mask_value=None, *,
                   device=None) -> ScanAux:
    """ScanAux on ``device`` (default: the CUDA card) from host truth:
    per-page live counts plus optional [P, lw_pad] value rows. With no
    values the sum/min/max members are identity-filled (never read).
    ``cum_cnt`` stays physical under ``mask_value``."""
    device = resolve_device(device)
    cnt = np.asarray(cnt, np.int64)
    P = cnt.size
    vd = np.dtype(val_dtype)
    cum_cnt = np.zeros(P + 1, np.int32)
    cum_cnt[1:] = np.cumsum(cnt)
    id_min, id_max = agg_identities(vd)
    if vals is not None:
        psum, pmin, pmax = page_aggregates(np.asarray(vals, vd), cnt,
                                           mask_value)
    else:
        psum = np.zeros(P, vd)
        pmin = np.full(P, id_min, vd)
        pmax = np.full(P, id_max, vd)
    cum_sum = np.zeros(P + 1, vd)
    cum_sum[1:] = np.cumsum(psum, dtype=vd)
    # np.minimum / np.maximum, as the reference builds them (see above)
    return ScanAux(*(torch.from_numpy(a).to(device) for a in (
        cum_cnt, cum_sum, sparse_table(pmin, np.minimum, id_min),
        sparse_table(pmax, np.maximum, id_max))))


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(x)) for int32 x >= 1. The float candidate can be
    off by one either way (2^k - 1 rounds up to 2^k past the 24-bit
    mantissa; a library log2 can round exact powers down), so it is
    corrected against integer shifts both ways. The up-shift is clamped to
    30: x < 2^31 keeps the true floor at most 30, and 1 << 31 wraps to
    INT32_MIN, which the down-correction's compare then never takes."""
    k = torch.floor(torch.log2(x.float())).int()
    one = torch.ones_like(k)
    k = torch.where(torch.bitwise_left_shift(one, k) > x, k - 1, k)
    kp = (k + 1).clamp_max(30)
    return torch.where(torch.bitwise_left_shift(one, kp) <= x, kp, k)


def _table_range(st: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 combine, identity):
    """Sparse-table reduce over pages [a, b); ``identity`` where the range
    is empty. ``a``/``b`` are [Q] int32 with 0 <= a, b <= P; both table
    columns are clamped into [0, P-1] (torch has no clipping gather)."""
    P = st.shape[1]
    ln = b - a
    k = _floor_log2(ln.clamp_min(1))
    half = torch.bitwise_left_shift(torch.ones_like(k), k)
    a1 = a.clamp(0, P - 1).long()
    a2 = (b - half).clamp(0, P - 1).long()
    kl = k.long()
    return torch.where(ln > 0, combine(st[kl, a1], st[kl, a2]), identity)


# ------------------------------------------------------------ the pipeline
class SpanScan(NamedTuple):
    """Raw per-query quantities of one span scan: ``count`` (and, per the
    pipeline's mode, ``vsum``/``vmin``/``vmax``, None otherwise) over the
    whole [lo, hi] span, ``plo`` the lower boundary page, ``lt_lo`` the
    in-page key count below lo (the rank anchor)."""
    count: torch.Tensor
    vsum: Optional[torch.Tensor]
    vmin: Optional[torch.Tensor]
    vmax: Optional[torch.Tensor]
    plo: torch.Tensor
    lt_lo: torch.Tensor


def make_span_pipeline(span_of: Callable, *, num_pages: int, tile: int,
                       key_dtype, val_dtype, mode: str = "full",
                       mask_value=None) -> Callable:
    """The span scan as a function ``pipeline(lo, hi, kpages, vpages, aux)
    -> SpanScan`` at the static pushdown ``mode`` (count mode never reads
    the value pages). ``lo > hi`` queries run with inert masks: count 0,
    identities for the value aggregates, ``lt_lo`` still anchored at lo."""
    if mode not in MODES:
        raise ValueError(f"unknown scan mode {mode!r}; want one of {MODES}")
    lo_min, hi_cap, inert_lo, inert_hi = (
        x.item() for x in _domain_consts(key_dtype))
    id_min, id_max = (x.item() for x in agg_identities(val_dtype))

    def pipeline(lo, hi, kpages, vpages, aux: ScanAux) -> SpanScan:
        q_n = lo.shape[0]
        empty = lo > hi
        plo, phi = span_of(lo, hi)
        single = plo == phi
        # item i scans the lower boundary page: its lower bound stays lo
        # even for empty ranges (the below-lo count anchors r_lo); its upper
        # bound closes at hi on a one-page span, else admits the whole page
        hib_a = torch.where(empty, inert_hi,
                            torch.where(single, hi, hi_cap))
        # item Q+i scans the upper boundary page (every key there is >= lo
        # when the span has two or more pages); inert otherwise
        off = empty | single
        lob_b = torch.full_like(lo, lo_min).masked_fill(off, inert_lo)
        hib_b = hi.masked_fill(off, inert_hi)
        g_cap = ladder_grid(2 * q_n, tile, num_pages)
        _, plan = span_scan_plan(plo, phi, tile, g_cap, num_pages)

        def body(qbs, step_pages, steps_used):
            return _pscan.page_scan_bucketed(
                qbs[0], qbs[1], step_pages, kpages, vpages, mode=mode,
                mask_value=mask_value, steps_used=steps_used)

        outs = run_scheduled_multi(plan, (torch.cat([lo, lob_b]),
                                          torch.cat([hib_a, hib_b])),
                                   tile, g_cap, body)
        lt, le = outs[0], outs[1]
        # in-range count per item; the clamp zeroes inert bound pairs
        cnt = (le - lt).clamp_min(0)
        cnt = cnt[:q_n] + cnt[q_n:]
        # interior pages (plo, phi): aggregated, never scanned; an empty
        # range has phi == plo, so its interval is empty by construction
        a, b = plo + 1, phi
        has = b > a
        al, bl = a.long(), b.long()
        icnt = torch.where(has, aux.cum_cnt[bl] - aux.cum_cnt[al], 0)
        vsum = vmin = vmax = None
        if mode != "count":
            isum = torch.where(has, aux.cum_sum[bl] - aux.cum_sum[al], 0)
            vsum = outs[2][:q_n] + outs[2][q_n:] + isum
        if mode == "full":
            # the reference combines with jnp.minimum / jnp.maximum: -0.0
            # ranks below +0.0 whatever the order
            mn = _pscan.minimum(outs[3][:q_n], outs[3][q_n:])
            mx = _pscan.maximum(outs[4][:q_n], outs[4][q_n:])
            vmin = _pscan.minimum(mn, _table_range(aux.st_min, a, b,
                                                   _pscan.minimum, id_min))
            vmax = _pscan.maximum(mx, _table_range(aux.st_max, a, b,
                                                   _pscan.maximum, id_max))
        return SpanScan(count=(cnt + icnt).int(), vsum=vsum, vmin=vmin,
                        vmax=vmax, plo=plo, lt_lo=lt[:q_n])

    return pipeline


# --------------------------------------------- immutable tiered front-end
class TieredScanner:
    """Batched range scans over an immutable TieredIndex.

    One instance owns the value pages and the interior aggregate arrays.
    Built lazily and cached on the index by :func:`scanner_for`; pass
    ``values`` (the facade's sorted payload) to enable value-aggregate
    pushdown (int32/float32) and materialize-mode value gathers (any
    dtype). Building it reads the values back to the host once.
    """

    def __init__(self, index, values=None):
        P, lw, lwp = index.num_pages, index.leaf_width, index.lw_pad
        n = index.n
        dev = index.pages.device
        kd = numpy_dtype(index.pages.dtype)
        self.index = index
        self.key_dtype = kd
        cnt = np.full(P, lw, np.int64)
        cnt[-1] = n - (P - 1) * lw
        self.values_dev = None
        self.has_values = False
        vp_host = None
        vd = kd
        if values is not None:
            v = values.cpu().numpy() if isinstance(values, torch.Tensor) \
                else np.asarray(values)
            if v.dtype in VALUE_DTYPES:
                self.has_values = True
                vd = v.dtype
                flat = np.zeros(P * lw, vd)
                flat[:n] = v
                vp_host = np.zeros((P, lwp), vd)
                vp_host[:, :lw] = flat.reshape(P, lw)
            else:
                # other dtypes keep a flat device copy for materialize
                # gathers only; pushdown dtypes gather from the value pages
                self.values_dev = torch.as_tensor(v).to(dev)
        self.vpages = None if vp_host is None \
            else torch.from_numpy(vp_host).to(dev)
        self.aux = build_page_aux(cnt, vp_host, vd, device=dev)
        self._n, self._lw = n, lw
        self.span_of = _tiered._make_span_of(index.page_of, kd)
        self._pipes = {m: make_span_pipeline(
            self.span_of, num_pages=P, tile=index.tile, key_dtype=kd,
            val_dtype=vd, mode=m) for m in MODES}
        self._makers = None

    def _rank_raw(self, mode, lo, hi, kpages, vpages, aux):
        s = self._pipes[mode](lo, hi, kpages, vpages, aux)
        r_lo = (s.plo * self._lw + s.lt_lo).clamp_max(self._n)
        return s, r_lo, r_lo + s.count

    def _agg(self, mode, lo, hi, kpages, vpages, aux, flat_vals=None):
        """(count, vsum, vmin, vmax, r_lo, r_hi_excl), None above ``mode``.
        ``flat_vals`` completes the operand convention; unused here."""
        s, r_lo, r_hi = self._rank_raw(
            mode, lo, hi, kpages, vpages if mode != "count" else None, aux)
        return s.count, s.vsum, s.vmin, s.vmax, r_lo, r_hi

    def _mat(self, K, mode, lo, hi, kpages, vpages, aux, flat_vals):
        """``_agg`` plus the first K matches' ranks and values per query
        and the overflow flag. Values come from ``flat_vals`` when given,
        else from the value pages (dense rank -> padded slot address)."""
        out = self._agg(mode, lo, hi, kpages, vpages, aux)
        ranks, vals, over = materialize_interval(out[4], out[0], flat_vals,
                                                 K=K)
        if vals is None and vpages is not None:
            rr = ranks.clamp_min(0)
            addr = (rr // self._lw) * self.index.lw_pad + rr % self._lw
            vals = torch.where(ranks >= 0, take(vpages.reshape(-1), addr), 0)
        return (*out, ranks, vals, over)

    def range_raw(self, lo, hi, pages):
        """``(lo, hi, pages) -> (r_lo, r_hi_excl, count)`` in count mode,
        with no value operands."""
        s, r_lo, r_hi = self._rank_raw("count", lo, hi, pages, None,
                                       self.aux)
        return r_lo, r_hi, s.count

    def _coerce(self, *xs):
        return tuple(as_queries(x, self.index.pages) for x in xs)

    def _operands(self):
        return self.index.pages, self.vpages, self.aux, self.values_dev

    def scan_range(self, lo, hi, *, aggs=None,
                   materialize: Optional[int] = None) -> ScanResult:
        lo, hi = self._coerce(lo, hi)
        mode = mode_for_aggs(aggs, self.has_values)
        if materialize is None:
            cnt, vs, mn, mx, r_lo, r_hi = self._agg(mode, lo, hi,
                                                    *self._operands())
            return ScanResult(count=cnt, r_lo=r_lo, r_hi_excl=r_hi,
                              vsum=vs, vmin=mn, vmax=mx)
        # materialize composes with the requested aggregates in the same
        # pass (aggs=("count",) for the lean locator-only form)
        cnt, vs, mn, mx, r_lo, r_hi, ranks, vals, over = self._mat(
            int(materialize), mode, lo, hi, *self._operands())
        return ScanResult(count=cnt, r_lo=r_lo, r_hi_excl=r_hi, vsum=vs,
                          vmin=mn, vmax=mx, ranks=ranks, values=vals,
                          overflow=over)

    def search_range(self, lo, hi):
        """(r_lo, r_hi_excl, count): one count-mode scan, which never reads
        the value pages."""
        r = self.scan_range(lo, hi, aggs=("count",))
        return r.r_lo, r.r_hi_excl, r.count

    # ------------------------------------ grouped / composite (DESIGN §8.3)
    def _group_makers(self):
        """The grouped/composite makers over this scanner. The immutable
        operand convention is ``rest = (kpages, vpages, aux, flat_vals)``."""
        if self._makers is None:
            from . import groupby as _gb
            idx = self.index
            prefixes = {w: _gb.make_edge_prefix(
                idx.page_of, num_pages=idx.num_pages, tile=idx.tile,
                with_sum=w) for w in (False, True)}

            def agg_factory(mode):
                return lambda lo, hi, *rest: self._agg(mode, lo, hi, *rest)

            def mat_factory(C, mode):
                return lambda lo, hi, *rest: self._mat(C, mode, lo, hi,
                                                       *rest)

            self._makers = _gb.make_group_makers(
                agg_factory, mat_factory, self.key_dtype,
                prefix_path=prefixes.__getitem__)
        return self._makers

    def scan_groups(self, lo, hi, num_groups: int, *, aggs=None,
                    top_k: Optional[int] = None,
                    candidates: Optional[int] = None):
        """Equal-width GROUP BY bucket(key) aggregates over [lo, hi]: G
        buckets per query, count/sum through the (G+1)-edge prefix
        pipeline, min/max through the per-bucket span expansion, optional
        per-bucket top-K by value (``candidates`` bounds the materialized
        window, default max(2K, 32)). Returns
        :class:`groupby.GroupScanResult`."""
        from . import groupby as _gb
        lo, hi = self._coerce(lo, hi)
        G = int(num_groups)
        if not 1 <= G <= _gb.MAX_GROUPS:
            raise ValueError(f"num_groups must be in [1, {_gb.MAX_GROUPS}]"
                             f", got {num_groups}")
        mode = mode_for_aggs(aggs, self.has_values)
        mk_gagg, mk_gtopk, _ = self._group_makers()
        if top_k is None:
            out = mk_gagg(G, mode)(lo, hi, *self._operands())
        else:
            K = int(top_k)
            if K < 1:
                raise ValueError(f"top_k must be positive, got {top_k}")
            if not self.has_values and self.values_dev is None:
                raise ValueError("top_k needs an index built with values")
            C = max(int(candidates) if candidates is not None
                    else max(2 * K, 32), K)
            out = mk_gtopk(G, mode, K, C)(lo, hi, *self._operands())
        names = ("edges", "r_edge", "count", "vsum", "vmin", "vmax",
                 "topk_values", "topk_ranks", "overflow")
        return _gb.GroupScanResult(**dict(zip(names, out)))

    def scan_multi(self, ranges, *, op: str = "union", aggs=None):
        """Composite R-range predicates: ``ranges`` is [Q, R, 2] inclusive
        (lo, hi) pairs per query, combined as a union (IN-list) or an
        intersection (conjunctive predicate) through the coverage-count
        decomposition. Returns a :class:`ScanResult` whose r_lo/r_hi_excl
        are the rank hull of the matching set ((0, 0) when empty)."""
        from . import groupby as _gb
        if op not in _gb.MULTI_OPS:
            raise ValueError(f"unknown multi-range op {op!r}; "
                             f"want one of {_gb.MULTI_OPS}")
        (r,) = self._coerce(ranges)
        if r.dim() != 3 or r.shape[-1] != 2:
            raise ValueError(f"ranges must be [Q, R, 2], got "
                             f"{tuple(r.shape)}")
        R = int(r.shape[1])
        if R < 1:
            raise ValueError("ranges needs at least one range per query")
        mode = mode_for_aggs(aggs, self.has_values)
        _, _, mk_magg = self._group_makers()
        count, vsum, vmin, vmax, r_lo, r_hi = mk_magg(R, op, mode)(
            r[..., 0], r[..., 1], *self._operands())
        return ScanResult(count=count, r_lo=r_lo, r_hi_excl=r_hi,
                          vsum=vsum, vmin=vmin, vmax=vmax)


def scanner_for(index, values=None) -> TieredScanner:
    """The (lazily built) scanner of a TieredIndex, cached on the index:
    one slot for the rank-only form, one for the valued form. A rank-only
    request is served by an existing valued scanner (its count mode never
    reads the value pages)."""
    if values is None:
        sc = getattr(index, "_scanner_values", None)
        if sc is not None:
            return sc
    attr = "_scanner_ranks" if values is None else "_scanner_values"
    sc = getattr(index, attr, None)
    if sc is None:
        sc = TieredScanner(index, values)
        object.__setattr__(index, attr, sc)
    return sc


# ------------------------------------------------ materialize (dense rank)
def materialize_interval(r_lo: torch.Tensor, count: torch.Tensor,
                         flat_vals: Optional[torch.Tensor], *, K: int):
    """The first K ranks of each query's interval [r_lo, r_lo + count)
    (-1 past count), their values from ``flat_vals`` (0 past count; None
    without values), and the overflow flag ``count > K``."""
    ar = torch.arange(K, dtype=torch.int32, device=r_lo.device)[None, :]
    ranks = r_lo[:, None] + ar
    valid = ar < count[:, None]
    vals = None
    if flat_vals is not None:
        vals = torch.where(valid, take(flat_vals, ranks), 0)
    return torch.where(valid, ranks, -1), vals, count > K


# ------------------------------------------------------- not ported yet
class FlatAggregator:
    """Rank-interval aggregates for the non-tiered kinds (ROADMAP Queue 1
    item 12)."""

    def __init__(self, values):
        raise not_ported("FlatAggregator", "item 12 (the other index kinds)")


def _tier_terms(*args, **kwargs):
    raise not_ported("scan._tier_terms",
                     "item 5B (the mutable store's scans)")


def make_paged_scan_fns(*args, **kwargs):
    raise not_ported("scan.make_paged_scan_fns",
                     "item 5B (the mutable store's scans)")


def make_delta_scan_fns(*args, **kwargs):
    raise not_ported("scan.make_delta_scan_fns",
                     "item 5B (the mutable store's scans)")
