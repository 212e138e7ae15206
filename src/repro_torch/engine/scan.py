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

Over the mutable store (``engine/store.py``) the same span pipeline runs
on the gapped leaf pages with the tombstone masked out of the value
aggregates, and each delta tier adds its live terms and subtracts its
shadow corrections (:func:`make_paged_scan_fns`). A tier's terms come
from its key-sorted view (:class:`TierView`): two binary searches and
prefix differences a query, where the reference compares each query with
every slot.

The reference caches one ``jax.jit`` dispatch per shape; here the
pipelines are plain functions. Each entry point of :class:`TieredScanner`
records the reference's ``scan.dispatch`` span and its
``engine_op_seconds`` / ``engine_ops`` (paths ``scan``, ``scan_groups``,
``scan_multi``); the span pipeline's stages carry ``obs.annotate``
ranges while the tracer is enabled. On an index built with
``specialize=True`` each entry point's pipeline has the key / value
pages and the ``ScanAux`` arrays bound in, the ranges its only arguments
(a CUDA graph replay per shape on the card, ``engine/capture.py``); the
store's scans keep their data as arguments, as the reference's do. Left
out: the non-tiered kinds' ``FlatAggregator`` (item 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.util import (as_queries, not_ported, numpy_dtype,
                         resolve_device, sentinel_for, take, upload_async)
from ..kernels import page_scan as _pscan
from ..kernels.page_scan import MODES, agg_identities
from ..obs import annotate, timed_op
from . import tiered as _tiered
from .capture import Specialized
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
    # np.minimum / np.maximum, as the reference builds them (see above);
    # the copies do not wait for the stream: the mutable store rebuilds
    # these inside a scan
    return ScanAux(*(upload_async(a, device) for a in (
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
        with annotate("scan/span_of"):
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
        with annotate("scan/span_plan"):
            g_cap = ladder_grid(2 * q_n, tile, num_pages)
            _, plan = span_scan_plan(plo, phi, tile, g_cap, num_pages)

        def body(qbs, step_pages, steps_used):
            return _pscan.page_scan_bucketed(
                qbs[0], qbs[1], step_pages, kpages, vpages, mode=mode,
                mask_value=mask_value, steps_used=steps_used)

        with annotate("scan/page_kernel"):
            outs = run_scheduled_multi(plan, (torch.cat([lo, lob_b]),
                                              torch.cat([hib_a, hib_b])),
                                       tile, g_cap, body)
        lt, le = outs[0], outs[1]
        # in-range count per item; the clamp zeroes inert bound pairs
        cnt = (le - lt).clamp_min(0)
        cnt = cnt[:q_n] + cnt[q_n:]
        # interior pages (plo, phi): aggregated, never scanned; an empty
        # range has phi == plo, so its interval is empty by construction
        with annotate("scan/interior"):
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
        # specialization (DESIGN.md §10): on a specialize=True index each
        # dispatch has the key / value pages and the aux arrays bound in,
        # the scan twin of the point pipeline's bound pages. A frozen index
        # never mutates, so the binding cannot go stale (the store's scans
        # keep their operands as arguments: its aux changes per write)
        self._spec = bool(index.specialize)
        self._specs = {}              # dispatch key -> Specialized

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

    def _dispatch(self, key, fn: Callable, *queries):
        """``fn(*queries, *operands)``; on a specialized index through the
        dispatch bound to the operands under ``key`` (built on first use)."""
        if not self._spec:
            return fn(*queries, *self._operands())
        spec = self._specs.get(key)
        if spec is None:
            ops = self._operands()
            spec = self._specs[key] = Specialized(
                lambda *qs: fn(*qs, *ops), device=self.index.pages.device,
                captures=self.index.captures)
        return spec(*queries)

    def scan_range(self, lo, hi, *, aggs=None,
                   materialize: Optional[int] = None) -> ScanResult:
        lo, hi = self._coerce(lo, hi)
        mode = mode_for_aggs(aggs, self.has_values)
        if materialize is None:
            with timed_op("scan.dispatch", "scan", mode=mode):
                cnt, vs, mn, mx, r_lo, r_hi = self._dispatch(
                    ("agg", mode),
                    lambda *a: self._agg(mode, *a), lo, hi)
            return ScanResult(count=cnt, r_lo=r_lo, r_hi_excl=r_hi,
                              vsum=vs, vmin=mn, vmax=mx)
        # materialize composes with the requested aggregates in the same
        # pass (aggs=("count",) for the lean locator-only form)
        K = int(materialize)
        with timed_op("scan.dispatch", "scan", mode=mode, materialize=K):
            cnt, vs, mn, mx, r_lo, r_hi, ranks, vals, over = self._dispatch(
                ("mat", K, mode), lambda *a: self._mat(K, mode, *a), lo, hi)
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
            key, fn = ("groups", G, mode), mk_gagg(G, mode)
        else:
            K = int(top_k)
            if K < 1:
                raise ValueError(f"top_k must be positive, got {top_k}")
            if not self.has_values and self.values_dev is None:
                raise ValueError("top_k needs an index built with values")
            C = max(int(candidates) if candidates is not None
                    else max(2 * K, 32), K)
            key, fn = ("topk", G, mode, K, C), mk_gtopk(G, mode, K, C)
        with timed_op("scan.dispatch", "scan_groups", mode=mode, groups=G):
            out = self._dispatch(key, fn, lo, hi)
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
        magg = self._group_makers()[2](R, op, mode)
        with timed_op("scan.dispatch", "scan_multi", mode=mode, op=op):
            count, vsum, vmin, vmax, r_lo, r_hi = self._dispatch(
                ("multi", R, op, mode),
                lambda rr, *ops: magg(rr[..., 0], rr[..., 1], *ops), r)
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




# -------------------------------------------------- mutable (paged) store
class TierView(NamedTuple):
    """One delta tier (sealed or active) as the mutable store's scans
    read it (built by :func:`tier_view`, cached by the store until its
    next mutation).

    The reference compares every query with every slot of a tier: masks
    of [Q, capacity] per term. Here the tier's slots are sorted by key
    once (stably, so the sentinel gap slots sort last in slot order) and
    carry exclusive prefix sums and sparse tables over that order. The
    slots with ``lo <= key <= hi`` are the run ``[a, b)`` between two
    binary searches, and each of the reference's masked sums is the
    difference of two prefix entries (int32, so sums wrap mod 2^32 as the
    reference's do) and each masked min / max a sparse-table reduce. Gap
    slots stay in the view with their sentinel key, value 0 and clear
    bits, so a bound equal to the sentinel takes them in exactly as the
    reference's masks do.

    keys    [cap] key dtype, ascending
    order   [cap] int32 flat slot of each sorted position
    vals    [cap] int32 values in that order
    tomb    [cap] bool tombstone bits in that order
    pre     [4, cap + 1] int32 exclusive prefixes of: live (not tomb);
            the count correction ``sb | (ss & live)``; the live value;
            the corrected value ``(sb | ss) & live``
    st      [2, L, cap] int32 sparse tables of the live values' min and
            max (identities elsewhere)
    lg, half  [cap + 1] int32: floor(log2(n)) and its power of two for a
            run of n slots (0 at n = 0), so that a run's min / max is
            two table reads and no arithmetic on logarithms
    """
    keys: torch.Tensor
    order: torch.Tensor
    vals: torch.Tensor
    tomb: torch.Tensor
    pre: torch.Tensor
    st: torch.Tensor
    lg: torch.Tensor
    half: torch.Tensor


def tier_view(keys: np.ndarray, vals: np.ndarray, sb: np.ndarray,
              ss: np.ndarray, tomb: np.ndarray, device) -> TierView:
    """The :class:`TierView` of one tier's host arrays ([nn, w] each,
    flattened in slot order as the reference flattens them), built in
    numpy and moved to ``device`` in one copy that does not wait for the
    stream (``upload_async``)."""
    fk = np.asarray(keys).reshape(-1)
    cap = fk.size
    order = np.argsort(fk, kind="stable")
    sk = fk[order]
    sv = np.asarray(vals, np.int32).reshape(-1)[order]
    fsb, fss, ftb = (np.asarray(b, bool).reshape(-1)[order]
                     for b in (sb, ss, tomb))
    live = ~ftb
    terms = np.stack([live, fsb | (fss & live), np.where(live, sv, 0),
                      np.where((fsb | fss) & live, sv, 0)]).astype(np.int64)
    pre = np.zeros((4, cap + 1), np.int64)
    np.cumsum(terms, axis=1, out=pre[:, 1:])
    id_min, id_max = agg_identities(np.int32)
    st = np.stack([
        sparse_table(np.where(live, sv, id_min), np.minimum, id_min),
        sparse_table(np.where(live, sv, id_max), np.maximum, id_max)])
    L = st.shape[1]
    lg = np.zeros(cap + 1, np.int32)
    lg[1:] = np.log2(np.arange(1, cap + 1)).astype(np.int32)  # exact: ints
    half = np.where(np.arange(cap + 1) > 0, 1 << lg, 0).astype(np.int32)
    parts = [sk.view(np.int32), order.astype(np.int32), sv,
             ftb.astype(np.int32), pre.astype(np.int32).ravel(), st.ravel(),
             lg, half]
    buf = upload_async(np.concatenate(parts), resolve_device(device))
    at = np.cumsum([0] + [p.size for p in parts])
    sl = [buf[at[i]:at[i + 1]] for i in range(len(parts))]
    return TierView(
        keys=sl[0].view(torch.float32) if fk.dtype == np.float32 else sl[0],
        order=sl[1], vals=sl[2], tomb=sl[3] != 0,
        pre=sl[4].view(4, cap + 1), st=sl[5].view(2, L, cap), lg=sl[6],
        half=sl[7])


def _tier_run(lo, hi, t: TierView):
    """[a, b): the sorted positions with ``lo <= key <= hi`` (b = a when
    the run is empty)."""
    a = torch.searchsorted(t.keys, lo, out_int32=True)
    b = torch.searchsorted(t.keys, hi, right=True, out_int32=True)
    return a, torch.maximum(a, b)


def _tier_terms(lo, hi, t: TierView, mode: str = "full") -> dict:
    """The reference's per-tier terms (DESIGN.md §6.3) from one tier's
    sorted view, per query:

      cnt / vsum / vmin / vmax  the tier's own LIVE contribution in
                                [lo, hi];
      sub      the count correction: one per in-range sb entry (its base
               twin is physically counted, live or tombstone-synced) and
               one per in-range live ss entry (its sealed twin is synced
               live and counted twice);
      sub_sum  the value correction: a live sb / ss entry's lower twin
               carries its value, so subtracting it removes the duplicate;
      below / below_sub  the same pair over keys < lo (rank anchors).

    ``mode`` "count" leaves out the value terms, "sum" the min / max."""
    a, b = _tier_run(lo, hi, t)
    al, bl = a.long(), b.long()
    pa, pb = t.pre[:, al], t.pre[:, bl]
    d = pb - pa
    out = dict(cnt=d[0], sub=d[1], below=pa[0], below_sub=pa[1])
    if mode != "count":
        out.update(vsum=d[2], sub_sum=d[3])
    if mode == "full":
        # the run [a, b) as two overlapping power-of-two blocks: the
        # table's rows k = floor(log2(b - a)) at a and at b - 2^k
        cap = t.keys.shape[0]
        n = bl - al
        k = t.lg[n].long()
        i2 = (bl - t.half[n]).clamp(0, cap - 1)     # n = 0: masked
        mm = torch.stack([t.st[:, k, al.clamp_max(cap - 1)],
                          t.st[:, k, i2]])                  # [2, 2, Q]
        id_min, id_max = (x.item() for x in agg_identities(np.int32))
        empty = n == 0
        out.update(
            vmin=torch.minimum(mm[0, 0], mm[1, 0]).masked_fill(empty,
                                                               id_min),
            vmax=torch.maximum(mm[0, 1], mm[1, 1]).masked_fill(empty,
                                                               id_max))
    return out


def _sorted_tier_window(t: TierView, lo, hi, offset: int):
    """The in-range run of one tier per query, over the tier's full
    ``capacity`` columns from the run's start (tombstoned entries
    interleave with live ones, so no shorter window is safe): (mask —
    in range and live, keys, slot addresses ``offset + flat slot``,
    values)."""
    cap = t.keys.shape[0]
    start = torch.searchsorted(t.keys, lo, out_int32=True)
    idx = start[:, None] + torch.arange(cap, dtype=torch.int32,
                                        device=lo.device)[None, :]
    at = idx.clamp(0, cap - 1).long()
    key = t.keys[at]
    ok = (idx < cap) & (key >= lo[:, None]) & (key <= hi[:, None]) \
        & ~t.tomb[at]
    return ok, key, offset + t.order[at], t.vals[at]


def _member(sorted_keys, query_keys):
    """[Q, W] bool: each query key occupies a slot of the sorted tier
    (gap sentinels sort last; a sentinel query finds them)."""
    cap = sorted_keys.shape[0]
    pos = torch.searchsorted(sorted_keys, query_keys).clamp(0, cap - 1)
    return sorted_keys[pos] == query_keys


# rows of a materialize window computed at once: the window is
# K + 4 * capacity columns wide (about 4,000 at the default capacity), and
# each chunk keeps its [rows, width] intermediates near 2^25 elements
_MAT_CHUNK_ELEMS = 1 << 25


def _order_bits(keys: torch.Tensor) -> torch.Tensor:
    """int64 values that order as ``keys`` compare: int32 keys as they
    are; float32 keys by their bits, negatives flipped, with -0.0 taken
    as +0.0 (the two compare equal, and a sort keeps them in place)."""
    if keys.dtype != torch.float32:
        return keys.long()
    b = (keys + 0.0).view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).long()


def _first_k_rows(K: int, q_n: int, width: int, window, sent):
    """Per query row, the K entries of smallest key of the windows that
    ``window(rows)`` returns (a list of (ok, key, addr, val) [rows, w]
    blocks): keys outside ``ok`` become the sentinel, and the K smallest
    of (key, column) are taken, which is the head of the reference's
    stable argsort of the concatenated blocks (ties keep block, then
    column order). Each (key, column) pair is one int64, so
    ``torch.topk`` selects the K without sorting the whole row. Rows go
    in chunks so the intermediates stay bounded. Returns (addr [Q, K],
    val [Q, K])."""
    step = max(1, _MAT_CHUNK_ELEMS // max(width, 1))
    shift = max(1, (width - 1).bit_length())
    outs = []
    for s in range(0, q_n, step):
        blocks = window(slice(s, min(s + step, q_n)))
        keys = torch.cat([torch.where(ok, k, sent)
                          for ok, k, _, _ in blocks], 1)
        addr = torch.cat([a for _, _, a, _ in blocks], 1)
        val = torch.cat([v for _, _, _, v in blocks], 1)
        col = torch.arange(keys.shape[1], device=keys.device)
        packed = ((_order_bits(keys) + (1 << 31)) << shift) | col
        head = torch.topk(packed, K, dim=1, largest=False).values
        ordx = head & ((1 << shift) - 1)
        outs.append((torch.gather(addr, 1, ordx), torch.gather(val, 1, ordx)))
    if not outs:
        blocks = window(slice(0, 0))
        z = torch.zeros((0, min(K, width)), dtype=torch.int32,
                        device=blocks[0][0].device)
        return z, z.clone()
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def make_paged_scan_fns(span_of: Callable, *, num_pages: int, lw_pad: int,
                        tile: int, key_dtype, mask_value=None):
    """The scan over a gapped paged base and BOTH delta tiers (sealed,
    active) with the three-tier shadow / tombstone correction (DESIGN.md
    §6.3, §8.2). Returns ``(make_agg, make_mat)``:

    * ``make_agg(mode)`` -> ``agg(lo, hi, kpages, vpages, aux, sealed,
      active) -> (count, vsum, vmin, vmax, r_lo, r_hi_excl)`` at the
      pushdown depth ``mode`` (fields beyond it None; count mode never
      reads the value pages). ``sealed`` / ``active`` are the tiers'
      :class:`TierView`. Base terms come from the span pipeline (physical
      counts; tombstone values masked by the kernels' ``mask_value``),
      each tier's live terms are added and its sb / ss corrections
      subtracted (:func:`_tier_terms`); min / max need no correction, as
      the write path value-syncs every lower twin.
    * ``make_mat(K, mode)`` -> the same plus the first K merged live
      matches' slot addresses (base region, then sealed at
      ``P*lw_pad + slot``, then active at ``P*lw_pad + capacity + slot``)
      and values in key order, and the overflow flag: a base window of
      K + 2·capacity physical ordinals (each exclusion needs a tier twin)
      and each tier's in-range run, merged per row. Base candidates with
      a twin in either tier are dropped, sealed ones with an active twin
      likewise, tombstones everywhere.
    """
    sent = sentinel_for(key_dtype).item()
    base_sz = num_pages * lw_pad
    pipes = {}

    def pipe(mode):
        p = pipes.get(mode)
        if p is None:
            p = pipes[mode] = make_span_pipeline(
                span_of, num_pages=num_pages, tile=tile, key_dtype=key_dtype,
                val_dtype=np.int32, mode=mode, mask_value=mask_value)
        return p

    def core(mode, lo, hi, kpages, vpages, aux, tiers):
        s = pipe(mode)(lo, hi, kpages, vpages if mode != "count" else None,
                       aux)
        count, vsum, vmin, vmax = s.count, s.vsum, s.vmin, s.vmax
        o_lo = aux.cum_cnt[s.plo.long()] + s.lt_lo
        below = o_lo
        for t in tiers:
            d = _tier_terms(lo, hi, t, mode)
            count = count + d["cnt"] - d["sub"]
            below = below + d["below"] - d["below_sub"]
            if mode != "count":
                vsum = vsum + d["vsum"] - d["sub_sum"]
            if mode == "full":
                vmin = torch.minimum(vmin, d["vmin"])
                vmax = torch.maximum(vmax, d["vmax"])
        return o_lo, count, vsum, vmin, vmax, below

    def make_agg(mode: str):
        def agg(lo, hi, kpages, vpages, aux, sealed, active):
            _, count, vsum, vmin, vmax, below = core(
                mode, lo, hi, kpages, vpages, aux, (sealed, active))
            return count, vsum, vmin, vmax, below, below + count
        return agg

    def make_mat(K: int, mode: str = "count"):
        def mat(lo, hi, kpages, vpages, aux, sealed, active):
            o_lo, count, vsum, vmin, vmax, below = core(
                mode, lo, hi, kpages, vpages, aux, (sealed, active))
            cap = sealed.keys.shape[0]
            W = K + 2 * cap
            jw = torch.arange(W, dtype=torch.int32, device=lo.device)
            kflat, vflat = kpages.reshape(-1), vpages.reshape(-1)
            cum = aux.cum_cnt

            def window(rows):
                l, h = lo[rows], hi[rows]
                # base candidates: physical ordinals from the first
                # in-range slot; keys are sorted across pages, so the
                # in-range test bounds the window (overshoot reads larger
                # keys or sentinels)
                ords = o_lo[rows, None] + jw[None, :]
                pg = (torch.searchsorted(cum, ords, right=True,
                                         out_int32=True) - 1) \
                    .clamp(0, num_pages - 1)
                addr = (pg * lw_pad + (ords - cum[pg.long()])) \
                    .clamp(0, base_sz - 1)
                bkey, bval = kflat[addr.long()], vflat[addr.long()]
                bok = (bkey >= l[:, None]) & (bkey <= h[:, None])
                sok, skey, saddr, sval = _sorted_tier_window(
                    sealed, l, h, base_sz)
                aok, akey, aaddr, aval = _sorted_tier_window(
                    active, l, h, base_sz + cap)
                # any tier twin outranks a base copy; an active twin a
                # sealed one (tomb twins delete them)
                bok = bok & ~_member(sealed.keys, bkey) \
                    & ~_member(active.keys, bkey)
                sok = sok & ~_member(active.keys, skey)
                return [(bok, bkey, addr, bval), (sok, skey, saddr, sval),
                        (aok, akey, aaddr, aval)]

            rk, vv = _first_k_rows(K, lo.shape[0], W + 2 * cap, window, sent)
            valid = torch.arange(K, dtype=torch.int32,
                                 device=lo.device)[None, :] < count[:, None]
            return (count, vsum, vmin, vmax, below, below + count,
                    torch.where(valid, rk, -1), torch.where(valid, vv, 0),
                    count > K)
        return mat

    return make_agg, make_mat


def make_delta_scan_fns(key_dtype):
    """The base-less twin of :func:`make_paged_scan_fns`: a mutable store
    before its first fold. Two tiers (sealed, active), no base: sb bits are
    never set, ss corrections apply unchanged. ``make_agg(mode)`` /
    ``make_mat(K, mode)`` take ``(lo, hi, sealed, active)``; materialize
    addresses are sealed at ``slot``, active at ``capacity + slot``."""
    sent = sentinel_for(key_dtype).item()
    id_min, id_max = (x.item() for x in agg_identities(np.int32))

    def _terms(lo, hi, tiers):
        z = torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)
        count = below = vsum = z
        vmin = torch.full_like(z, id_min)
        vmax = torch.full_like(z, id_max)
        for t in tiers:
            d = _tier_terms(lo, hi, t)
            count = count + d["cnt"] - d["sub"]
            below = below + d["below"] - d["below_sub"]
            vsum = vsum + d["vsum"] - d["sub_sum"]
            vmin = torch.minimum(vmin, d["vmin"])
            vmax = torch.maximum(vmax, d["vmax"])
        return count, vsum, vmin, vmax, below

    def _depth(mode, vsum, vmin, vmax):
        if mode == "count":
            return None, None, None
        return (vsum, None, None) if mode == "sum" else (vsum, vmin, vmax)

    def make_agg(mode: str):
        def agg(lo, hi, sealed, active):
            count, vsum, vmin, vmax, below = _terms(lo, hi,
                                                    (sealed, active))
            return (count, *_depth(mode, vsum, vmin, vmax), below,
                    below + count)
        return agg

    def make_mat(K: int, mode: str = "count"):
        def mat(lo, hi, sealed, active):
            count, vsum, vmin, vmax, below = _terms(lo, hi,
                                                    (sealed, active))
            cap = sealed.keys.shape[0]

            def window(rows):
                l, h = lo[rows], hi[rows]
                sok, skey, saddr, sval = _sorted_tier_window(sealed, l, h, 0)
                aok, akey, aaddr, aval = _sorted_tier_window(active, l, h,
                                                             cap)
                sok = sok & ~_member(active.keys, skey)
                return [(sok, skey, saddr, sval), (aok, akey, aaddr, aval)]

            Kc = min(K, 2 * cap)
            rk, vv = _first_k_rows(Kc, lo.shape[0], 2 * cap, window, sent)
            if Kc < K:                   # as the reference's jnp.pad
                rk = torch.nn.functional.pad(rk, (0, K - Kc))
                vv = torch.nn.functional.pad(vv, (0, K - Kc))
            valid = torch.arange(K, dtype=torch.int32,
                                 device=lo.device)[None, :] < count[:, None]
            return (count, *_depth(mode, vsum, vmin, vmax), below,
                    below + count, torch.where(valid, rk, -1),
                    torch.where(valid, vv, 0), count > K)
        return mat

    return make_agg, make_mat
