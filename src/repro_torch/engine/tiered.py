"""Tiered batch-search engine (DESIGN.md §4) — PyTorch port of
``repro/engine/tiered.py``, point lookups only.

Composition per batch:

  1. **Top tier** — map each query to its leaf-page id,
     ``page_of(q) == |{p : seps[p] < q}|`` clipped to the last page. Up to
     256 pages the top is the NitroGen select network (plain torch, the
     separators as Python scalars); past that, the k-ary tree over the page
     separators, descended by the CUDA kernel ``kernels/kary_search.py``.
  2. **Schedule** — sort-and-bucket the batch by page id
     (``engine/schedule.py``). ``plan="device"`` (default) builds the plan
     on the device at the static worst-case grid, so nothing waits for the
     host; ``plan="host"`` builds the numpy plan after one host sync.
  3. **Bottom tier** — the CUDA page kernel ``kernels/page_search.py``,
     one leaf page per grid step; steps past the plan's count exit at once.
  4. **Un-permute** — gather the ranks back to request order, clip to n.

Range queries (``search_range``) descend both endpoints of each range in
one pass (``_make_span_of``) and run through the range-scan subsystem,
``engine/scan.py``.

Specialization (DESIGN.md §10): ``build(..., specialize=True)`` also
binds the pipeline to the built leaf pages (``search_spec``, the query
batch its only argument), which ``search`` then dispatches; on the card
that is a CUDA graph replay per batch shape (``engine/capture.py``).

Tier sizing (``plan_tiers``) keeps the reference's arithmetic, so the
layout matches it for every n. ``search`` records the reference's
``tiered.search`` span and its ``engine_op_seconds`` / ``engine_ops`` at
``path=search``; the pipeline's stages carry ``obs.annotate`` ranges
(``tiered/top_descent``, ``tiered/device_plan``, ``tiered/page_kernel``)
while the tracer is enabled.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..core import kary, nitrogen
from ..core.util import (as_queries, as_sorted_numpy, ceil_to, next_pow,
                         pad_to, resolve_device, sentinel_for)
from ..kernels import ops
from ..kernels import kary_search as _kary
from ..kernels import page_search as _page
from ..obs import annotate, timed_op
from .capture import Captures, Specialized
from .schedule import (BucketPlan, bucket_plan, device_plan, ladder_grid,
                       run_scheduled)

# Tops at or below this page count use the NitroGen select network;
# larger tops use the k-ary kernel (the reference's crossover).
NITROGEN_TOP_MAX_PAGES = 256
KARY_LANE = 128                  # separator row width of the k-ary top

PLAN_MODES = ("device", "host")


def plan_tiers(n: int, *, tile: int = 128,
               vmem_budget: int = ops.VMEM_BUDGET_BYTES):
    """Automatic tier sizing: the smallest tile-aligned leaf width whose
    page-boundary top tier passes the reference's k-ary VMEM budget (half
    the budget is reserved for query tiles and the streamed page)."""
    budget = vmem_budget // 2
    max_pages = tile
    while ops.kary_vmem_bytes(max_pages * 2) <= budget:
        max_pages *= 2
    leaf_width = max(tile, ceil_to(-(-n // max_pages), tile))
    num_pages = -(-n // leaf_width)
    top_kind = "nitrogen" if num_pages <= NITROGEN_TOP_MAX_PAGES else "kary"
    return leaf_width, num_pages, top_kind


@dataclass(frozen=True)
class TieredIndex:
    pages: torch.Tensor          # [num_pages, lw_pad] sentinel-padded leaves
    seps: torch.Tensor           # [num_pages] last slot of each page
    n: int
    leaf_width: int
    lw_pad: int
    num_pages: int
    tile: int                    # queries per grid step (bucket width)
    top_kind: str                # 'nitrogen' | 'kary' | 'trivial'
    top: Any                     # the inner index over `seps` (None if trivial)
    page_of: Callable            # q[batch] -> leaf-page id
    search_raw: Callable         # (q, pages) -> ranks, the device-plan pipeline
    plan: str = "device"         # default schedule placement
    specialize: bool = False     # leaf pages bound into the dispatch
    search_spec: Any = None      # q -> ranks over the bound pages
    #                              (None unless built with specialize=True)
    captures: Captures = field(default_factory=Captures)  # graphs / arms

    @property
    def tree_bytes(self) -> int:
        # the leaf pages replace the sorted array; the resident top tier is
        # the seps structure (a NitroGen top lives in the program: 0 bytes)
        if self.top_kind == "kary":
            return self.top.tree.numel() * self.top.tree.element_size()
        return 0


def _make_page_of_raw(top_kind: str, top, num_pages: int) -> Callable:
    """Top-tier descent: query batch -> int32 page id."""
    if top_kind == "trivial":
        return lambda q: torch.zeros(q.shape, dtype=torch.int32,
                                     device=q.device)
    if top_kind == "nitrogen":
        return lambda q: nitrogen.search(top, q).clamp_max(num_pages - 1)
    # kary: flatten the per-level rows into one kernel operand once, here
    levels = ops.kary_levels(top, KARY_LANE)
    flat, offsets = _kary.flatten_levels(levels)
    wpad = int(levels[0].shape[1])

    def page_of(q):
        ranks = _kary.kary_search_levels(q, flat, offsets,
                                         fanout=top.fanout, wpad=wpad)
        return ranks.clamp_max(num_pages - 1)

    return page_of


def _make_pipeline(page_of_raw: Callable, *, num_pages: int, stride: int,
                   tile: int, clip: int, with_stats: bool = False
                   ) -> Callable:
    """The device-plan pipeline: top descent -> device plan at the static
    worst-case grid -> page kernel (early exit past ``steps_used``) ->
    un-permute -> clip. No host sync anywhere in it.

    ``stride`` is the per-page rank base fed to the page kernel:
    ``leaf_width`` for global searchsorted ranks (this engine), ``lw_pad``
    for slot addresses into gapped storage (the mutable store,
    ``engine/store.py``). Results are clipped to ``clip``.
    ``with_stats=True`` also returns the plan's step count as a 0-d device
    tensor (the executed-occupancy feedback), with no extra sync."""

    def pipeline(q, pages):
        q_n = q.shape[0]
        with annotate("tiered/top_descent"):
            pids = page_of_raw(q)
        with annotate("tiered/device_plan"):
            g_cap = ladder_grid(q_n, tile, num_pages)
            plan = device_plan(pids, tile, g_cap, num_pages)

        def body(qb, step_pages, steps_used):
            return _page.page_search_bucketed(qb, step_pages, pages,
                                              stride=stride,
                                              steps_used=steps_used)

        with annotate("tiered/page_kernel"):
            out = run_scheduled(plan, q, tile, g_cap, body).clamp_max(clip)
        return (out, plan.steps_used) if with_stats else out

    return pipeline


def build_top(seps: np.ndarray, *, top: str = "auto",
              vmem_budget: int = ops.VMEM_BUDGET_BYTES, device=None):
    """Top-tier index over the page-last-keys array: (top_kind, top_idx)."""
    if top not in ("auto", "nitrogen", "kary"):
        raise ValueError(f"unknown top tier {top!r}; "
                         "want 'auto', 'nitrogen' or 'kary'")
    num_pages = int(seps.size)
    top_kind = top
    if top == "auto":
        top_kind = "nitrogen" if num_pages <= NITROGEN_TOP_MAX_PAGES \
            else "kary"
    if num_pages == 1:
        top_kind = "trivial"
    if top_kind == "nitrogen":
        levels = max(1, next_pow(4, num_pages) - 1)
        top_idx = nitrogen.build(seps, levels=levels, node_width=3,
                                 bottom="vector", device=device)
    elif top_kind == "kary":
        top_idx = kary.build(seps, node_width=127, device=device)
        vmem = ops.kary_vmem_bytes(num_pages, node_width=127)
        if vmem > vmem_budget:
            raise ValueError(
                f"top tier over {num_pages} pages needs ~{vmem/2**20:.1f} MiB "
                "VMEM; increase leaf_width or lower vmem_budget pressure")
    else:                                   # trivial: single-page index
        top_idx = None
    return top_kind, top_idx


def _assemble(pages: np.ndarray, seps: np.ndarray, *, n: int, leaf_width: int,
              tile: int, top_kind: str, top_idx, plan: str,
              device: torch.device, specialize: bool) -> TieredIndex:
    num_pages = int(pages.shape[0])
    page_of = _make_page_of_raw(top_kind, top_idx, num_pages)
    pipeline = _make_pipeline(page_of, num_pages=num_pages,
                              stride=leaf_width, tile=tile, clip=n)
    pages_dev = torch.from_numpy(pages).to(device)
    captures = Captures()
    search_spec = None
    if specialize:
        # specialization mode (DESIGN.md §10): the same pipeline with the
        # device leaf array bound in, so a dispatch takes the query batch
        # alone. The frozen index never mutates, so the binding can never
        # go stale; the mutable store's discipline is in engine/store.py.
        search_spec = Specialized(lambda q: pipeline(q, pages_dev),
                                  device=device, captures=captures)
    return TieredIndex(
        pages=pages_dev,
        seps=torch.from_numpy(seps).to(device), n=n, leaf_width=leaf_width,
        lw_pad=int(pages.shape[1]), num_pages=num_pages, tile=tile,
        top_kind=top_kind, top=top_idx, page_of=page_of,
        search_raw=pipeline, plan=plan, specialize=bool(specialize),
        search_spec=search_spec, captures=captures)


def build(keys, *, leaf_width: int | None = None, tile: int = 128,
          top: str = "auto", plan: str = "device",
          vmem_budget: int = ops.VMEM_BUDGET_BYTES,
          device=None, specialize: bool = False) -> TieredIndex:
    if plan not in PLAN_MODES:
        raise ValueError(f"unknown plan mode {plan!r}; "
                         f"want one of {PLAN_MODES}")
    device = resolve_device(device)
    srt = as_sorted_numpy(keys)
    n = int(srt.size)
    auto_lw, _, _ = plan_tiers(n, tile=tile, vmem_budget=vmem_budget)
    lw = int(leaf_width) if leaf_width else auto_lw
    num_pages = -(-n // lw)
    lw_pad = ceil_to(lw, 128)
    pages = np.full((num_pages, lw_pad), sentinel_for(srt.dtype), srt.dtype)
    pages[:, :lw] = pad_to(srt, num_pages * lw).reshape(num_pages, lw)
    seps = pages[:, lw - 1].copy()          # ascending; sentinel on partial tail
    top_kind, top_idx = build_top(seps, top=top, vmem_budget=vmem_budget,
                                  device=device)
    return _assemble(pages, seps, n=n, leaf_width=lw, tile=int(tile),
                     top_kind=top_kind, top_idx=top_idx, plan=plan,
                     device=device, specialize=specialize)


def from_reference_arrays(state: dict, *, device,
                          specialize: bool = False) -> TieredIndex:
    """The port's TieredIndex from the numpy form of a reference one:
    ``pages``, ``seps``, ``n``, ``leaf_width``, ``lw_pad``, ``num_pages``,
    ``tile`` and ``top_kind``, plus ``top_tree`` and ``top_level_offsets``
    when the top is k-ary (``plan`` optional, default "device"). A NitroGen
    top is code, not data, so it is regenerated from ``seps``.
    ``specialize`` binds the pipeline to the pages, as ``build``'s."""
    device = resolve_device(device)
    pages = np.array(state["pages"])          # copies: torch wants writable
    seps = np.array(state["seps"])
    if pages.shape != (int(state["num_pages"]), int(state["lw_pad"])):
        raise ValueError(f"pages {pages.shape} do not match num_pages "
                         f"{state['num_pages']} x lw_pad {state['lw_pad']}")
    top_kind = str(state["top_kind"])
    if top_kind == "kary":
        offsets = tuple(int(o) for o in state["top_level_offsets"])
        top_idx = kary.KaryTreeIndex(
            keys=torch.from_numpy(np.sort(seps, kind="stable")).to(device),
            tree=torch.from_numpy(np.array(state["top_tree"])).to(device),
            level_offsets=offsets, n=int(seps.size), node_width=127,
            depth=len(offsets))
    else:                   # 'nitrogen', or 'trivial' for a single page
        top_kind, top_idx = build_top(seps, top="nitrogen", device=device)
    return _assemble(pages, seps, n=int(state["n"]),
                     leaf_width=int(state["leaf_width"]),
                     tile=int(state["tile"]), top_kind=top_kind,
                     top_idx=top_idx, plan=str(state.get("plan", "device")),
                     device=device, specialize=specialize)


def _finish(q, pages, gather, valid, step_pages, *, leaf_width: int, n: int):
    """Gather sorted tiles -> page kernel over every step -> un-permute to
    request order. The grid comes from `gather`'s (ladder-padded) shape."""
    tile = gather.shape[0] // step_pages.shape[0]
    q_n = q.shape[0]
    q_src = q if q_n else torch.zeros(1, dtype=q.dtype, device=q.device)
    qb = q_src[gather.clamp_max(q_src.shape[0] - 1).long()] \
        .view(step_pages.shape[0], tile)
    flat = _page.page_search_bucketed(qb, step_pages, pages,
                                      stride=leaf_width).view(-1)
    # padded lanes scatter into a dump slot at index q_n, then cut off
    dest = torch.where(valid, gather, q_n).long()
    out = torch.zeros(q_n + 1, dtype=torch.int32, device=q.device) \
        .scatter_(0, dest, flat)[:q_n]
    return out.clamp_max(n)


def search_with_plan(index: TieredIndex, queries) -> tuple:
    """Host-scheduled tiered search; also returns the BucketPlan (stats).
    This is the ``plan="host"`` path: one host sync between the top descent
    and the page kernel, in exchange for an inspectable plan."""
    q = as_queries(queries, index.pages)
    pids = index.page_of(q).cpu().numpy()
    plan: BucketPlan = bucket_plan(pids, index.tile)
    dev = index.pages.device
    ranks = _finish(q, index.pages, torch.from_numpy(plan.gather).to(dev),
                    torch.from_numpy(plan.valid).to(dev),
                    torch.from_numpy(plan.step_pages).to(dev),
                    leaf_width=index.leaf_width, n=index.n)
    return ranks, plan


def search(index: TieredIndex, queries, *, plan: str | None = None
           ) -> torch.Tensor:
    """Tiered search, int32 searchsorted-left ranks. ``plan`` overrides the
    index default: "device" runs the pipeline with no host sync; "host"
    computes the bucket plan in numpy (stats/debug)."""
    mode = plan or index.plan
    if mode not in PLAN_MODES:
        raise ValueError(f"unknown plan mode {mode!r}; "
                         f"want one of {PLAN_MODES}")
    if mode == "host":
        ranks, _ = search_with_plan(index, queries)
        return ranks
    q = as_queries(queries, index.pages)
    # dispatch-boundary timer: the pipeline (or the graph replay) returns
    # once its kernels are issued, so observing it adds no sync. A
    # specialized index dispatches on the query alone: the leaf pages are
    # bound into search_spec, not passed.
    with timed_op("tiered.search", "search", n=int(q.shape[0])):
        if index.search_spec is not None:
            return index.search_spec(q)
        return index.search_raw(q, index.pages)


def searcher(index: TieredIndex) -> Callable:
    """The engine's serving entry point: a closure over the index."""
    def run(queries):
        return search(index, queries)
    return run


# ---------------------------------------------------------------- ranges
def _make_span_of(page_of_raw: Callable, key_dtype) -> Callable:
    """Doubled-endpoint descent (DESIGN.md §8): ``(lo, hi) -> (page_lo,
    page_hi)``, the inclusive boundary pages of each query's page span,
    both endpoint batches in one 2Q descent. The upper endpoint descends
    as its successor (``hi+1`` for ints, ``nextafter`` for floats:
    searchsorted-right routing), since separators repeat across pages when
    a key run crosses a boundary and routing ``hi`` itself would close the
    span one page early."""
    is_float = np.issubdtype(np.dtype(key_dtype), np.floating)

    def span_of(lo, hi):
        q_n = lo.shape[0]
        hi_next = torch.nextafter(hi, torch.full_like(hi, float("inf"))) \
            if is_float else hi + 1
        pids = page_of_raw(torch.cat([lo, hi_next]))
        plo = pids[:q_n].int()
        # the max only disciplines inverted (empty) ranges: the descent is
        # monotone, so hi >= lo gives page_hi >= page_lo already
        phi = torch.maximum(pids[q_n:].int(), plo)
        return plo, phi

    return span_of


def search_range_raw(index: TieredIndex) -> Callable:
    """``(lo, hi, pages) -> (r_lo, r_hi_excl, count)`` over the range-scan
    subsystem (``engine/scan.py``): the doubled descent, the boundary-page
    kernel in count mode and the interior count prefix."""
    from .scan import scanner_for
    return scanner_for(index).range_raw


def search_range(index: TieredIndex, lo, hi):
    """Batched range ranks: for each ``lo[i] <= hi[i]`` the half-open rank
    interval [r_lo, r_hi_excl) of keys in ``[lo, hi]`` plus the count, exact
    for duplicate keys at either endpoint; ``lo > hi`` normalizes to the
    empty interval at r_lo. No host sync."""
    from .scan import scanner_for
    return scanner_for(index).search_range(lo, hi)
