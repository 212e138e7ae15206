"""Sort-and-bucket scheduling for batched index search (DESIGN.md §2.1) —
PyTorch port of ``repro/engine/schedule.py``.

A query batch that descends the top tier yields one leaf-page id per query;
sorting the batch by page id turns the bottom tier into one sweep over the
distinct pages touched. The plan exists in two equivalent forms, with plans
bit-identical to the reference's:

* ``bucket_plan`` — host-side numpy, grid padded to the next power of two
  (``plan="host"``, stats/debug);
* ``device_plan`` — the torch twin, sized at the **static worst-case grid**
  ``ladder_grid(Q, tile, P)`` so nothing between the top descent and the
  un-permute waits for the host (``plan="device"``, the default). It has
  the reference's two constructions, packed sort and histogram, chosen
  statically per (Q, num_pages) by :func:`plan_method`.

The reference picked the executed grid rung on device with ``lax.switch``.
CUDA has no such form: :func:`run_scheduled_multi` launches the static
worst-case grid, and the page kernel's blocks at or past the plan's
``steps_used`` (read from device memory) return at once.

Every index here stays in range by construction (the reference's
``mode="drop"`` / ``mode="clip"`` are total in JAX; in torch on CUDA an
out-of-range index is a device-side assert), and every scatter and gather
takes int64 indices.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch


@dataclass(frozen=True)
class BucketPlan:
    """DMA plan for one sorted batch (host form, numpy).

    gather:     [G_pad * tile] int32 — indices into the request-order query
                array; slot k holds the query served in grid step k // tile,
                lane k % tile. Padded slots point at query 0 and are masked.
    valid:      [G_pad * tile] bool — True where `gather` is a real query.
    step_pages: [G_pad] int32 — the one leaf page read by each grid step
                (padded steps re-read page 0; their lanes are invalid).
    grid:       G_pad (static, power of two).
    steps_used: the un-padded grid size G (for stats / occupancy).
    """
    gather: np.ndarray
    valid: np.ndarray
    step_pages: np.ndarray
    grid: int
    steps_used: int

    @property
    def occupancy(self) -> float:
        """Fraction of kernel lanes doing real work."""
        return float(self.valid.sum()) / max(self.valid.size, 1)


class DevicePlan(NamedTuple):
    """Device twin of :class:`BucketPlan` at a static grid, in
    *request-order form*:

    dest:       [Q] int32 — request-order query index -> kernel lane
                (step * tile + lane); all-distinct, so a lane is real iff
                it appears here.
    step_pages: [grid] int32 — as BucketPlan (padded steps: page 0).
    steps_used: [] int32 on the device — the un-padded grid size; the page
                kernel's blocks at or past it return at once.
    """
    dest: torch.Tensor
    step_pages: torch.Tensor
    steps_used: torch.Tensor


def lane_arrays(plan: DevicePlan, tile: int):
    """Materialize a DevicePlan's (gather, valid) lane arrays — the
    BucketPlan form. Test/stats helper; the pipeline never builds these."""
    lanes = plan.step_pages.shape[0] * tile
    q_n = plan.dest.shape[0]
    dev = plan.dest.device
    dest = plan.dest.long()
    gather = torch.zeros(lanes, dtype=torch.int32, device=dev).scatter_(
        0, dest, torch.arange(q_n, dtype=torch.int32, device=dev))
    valid = torch.zeros(lanes, dtype=torch.bool, device=dev).index_fill_(
        0, dest, True)
    return gather, valid


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def worst_case_steps(q_n: int, tile: int, num_pages: int) -> int:
    """Tight upper bound on the un-padded grid size G for any Q-query batch:
    every distinct page opens at most one run and each run wastes less than
    one tile, so G <= floor((Q-R)/tile) + R with R = min(num_pages, Q);
    every step serves at least one query, so also G <= Q."""
    if q_n <= 0:
        return 0
    r = min(num_pages, q_n)
    return min((q_n - r) // tile + r, q_n)


def ladder_grid(q_n: int, tile: int, num_pages: int) -> int:
    """Static worst-case grid for the device plan: ``worst_case_steps``
    rounded onto the power-of-two ladder (minimum one step, so the plan and
    the page kernel behind it stay total for Q == 0)."""
    return _next_pow2(worst_case_steps(q_n, tile, num_pages))


def ladder_rungs(q_n: int, tile: int, g_cap: int) -> list[int]:
    """The power-of-two grids a Q-query batch can execute at: from the
    smallest grid that can hold Q lanes up to the static cap ``g_cap``."""
    g = _next_pow2(-(-q_n // tile)) if q_n else 1
    rungs = [g]
    while g < g_cap:
        g *= 2
        rungs.append(g)
    return rungs


def ladder_for(q_n: int, tile: int, num_pages: int) -> tuple[int, list[int]]:
    """``(g_cap, rungs)`` — the full grid ladder of a Q-query batch."""
    g_cap = ladder_grid(q_n, tile, num_pages)
    return g_cap, ladder_rungs(q_n, tile, g_cap)


def executed_occupancy(q_n: int, steps_used: int, tile: int,
                       num_pages: int) -> float:
    """Lane occupancy of the smallest ladder rung holding ``steps_used``
    steps: Q real lanes out of rung * tile. The reference executes that
    rung; the CUDA pipeline launches the cap but computes only the used
    steps, so this stays the signal the micro-batch queue steers with."""
    if q_n <= 0:
        return 0.0
    g_cap = ladder_grid(q_n, tile, num_pages)
    rungs = ladder_rungs(q_n, tile, g_cap)
    rung = next((g for g in rungs if g >= steps_used), rungs[-1])
    return q_n / float(rung * tile)


def occupancy_shares(counts: dict, occupancy: float) -> dict:
    """Attribute one flush's occupancy to its tenants by lane share; the
    shares sum to the flush occupancy, zero-count tenants get 0.0."""
    total = sum(counts.values())
    if total <= 0:
        return {t: 0.0 for t in counts}
    return {t: occupancy * (n / total) for t, n in counts.items()}


def run_scheduled_multi(plan: DevicePlan, qs: tuple, tile: int, g_cap: int,
                        body: Callable) -> tuple:
    """Run a per-(step, lane) ``body`` over a DevicePlan at the static grid
    ``g_cap``. Every [Q] array in ``qs`` is scattered into kernel lanes
    through ``dest``; ``body(qbs, step_pages [g_cap], steps_used)`` gets the
    tuple of [g_cap, tile] lane arrays and returns a tuple of [g_cap, tile]
    outputs, each gathered back to request order through ``dest``. Lanes no
    query maps to (and whole steps at or past ``steps_used``) are never read
    back, so ``body`` may leave them undefined."""
    dest = plan.dest.long()
    qbs = tuple(
        torch.zeros(g_cap * tile, dtype=q.dtype, device=q.device)
        .scatter_(0, dest, q).view(g_cap, tile)
        for q in qs)
    outs = body(qbs, plan.step_pages, plan.steps_used)
    return tuple(o.reshape(-1).gather(0, dest) for o in outs)


def run_scheduled(plan: DevicePlan, q: torch.Tensor, tile: int, g_cap: int,
                  body: Callable) -> torch.Tensor:
    """Single-operand form of :func:`run_scheduled_multi`:
    ``body(qb [g_cap, tile], step_pages, steps_used) -> [g_cap, tile]``."""
    (out,) = run_scheduled_multi(
        plan, (q,), tile, g_cap,
        lambda qbs, step_pages, steps_used: (
            body(qbs[0], step_pages, steps_used),))
    return out


def span_scan_plan(page_lo: torch.Tensor, page_hi: torch.Tensor, tile: int,
                   grid: int, num_pages: int | None = None,
                   method: str | None = None):
    """Span expansion + scan-step plan (DESIGN.md §8): a query's inclusive
    page span ``[page_lo, page_hi]`` contributes exactly its two boundary
    scan items (item i is query i's lower-boundary page, item Q+i its
    upper one), so a span is a pair of page buckets and the point-lookup
    device plan applies unchanged; interior pages are aggregated, never
    scanned. Returns (item_pages [2Q], DevicePlan over the 2Q items) at the
    static grid ``grid`` (use ``ladder_grid(2Q, tile, num_pages)``)."""
    pages = torch.cat([page_lo, page_hi]).int()
    return pages, device_plan(pages, tile, grid, num_pages, method=method)


def edge_scan_plan(pages: torch.Tensor, tile: int, grid: int,
                   num_pages: int | None = None,
                   method: str | None = None) -> DevicePlan:
    """Single-ended twin of :func:`span_scan_plan` for the grouped-scan edge
    pipeline (DESIGN.md §8.3): each item is one edge targeting one page, so
    the plan is the point-lookup device plan at the static grid ``grid``
    (use ``ladder_grid(N, tile, num_pages)``)."""
    return device_plan(pages.int(), tile, grid, num_pages, method=method)


def _empty_plan(tile: int) -> BucketPlan:
    # Q == 0: one fully-masked step on page 0 keeps every downstream shape
    # non-degenerate (the page kernel still launches; all lanes drop).
    return BucketPlan(gather=np.zeros(tile, np.int32),
                      valid=np.zeros(tile, bool),
                      step_pages=np.zeros(1, np.int32),
                      grid=1, steps_used=0)


def bucket_plan(page_of: np.ndarray, tile: int) -> BucketPlan:
    """Group queries by leaf page into grid steps of `tile` lanes (numpy).
    A page with more than `tile` queries spans consecutive steps; an empty
    batch yields the trivial one-step all-masked plan."""
    page_of = np.asarray(page_of)
    q_n = page_of.size
    if q_n == 0:
        return _empty_plan(tile)
    order = np.argsort(page_of, kind="stable")
    sp = page_of[order]                                  # sorted page ids
    new_run = np.empty(q_n, bool)
    new_run[0] = True
    np.not_equal(sp[1:], sp[:-1], out=new_run[1:])
    run_id = np.cumsum(new_run) - 1                      # [Q] run index
    run_start = np.flatnonzero(new_run)                  # [R]
    run_len = np.diff(np.append(run_start, q_n))         # [R]
    tiles_per_run = -(-run_len // tile)                  # ceil
    tile_off = np.concatenate(([0], np.cumsum(tiles_per_run)[:-1]))
    slot = np.arange(q_n) - run_start[run_id]            # position within run
    step = (tile_off[run_id] + slot // tile).astype(np.int64)
    pos = slot % tile
    G = int(tiles_per_run.sum())
    G_pad = _next_pow2(G)

    gather = np.zeros(G_pad * tile, np.int32)
    valid = np.zeros(G_pad * tile, bool)
    flat = step * tile + pos
    gather[flat] = order
    valid[flat] = True
    step_pages = np.zeros(G_pad, np.int32)
    step_pages[step] = sp                                # every step of a run
    return BucketPlan(gather=gather, valid=valid, step_pages=step_pages,
                      grid=G_pad, steps_used=G)


# Static selection between the two device-plan constructions. The
# thresholds are the reference's, measured on its CPU backend; they are
# kept so plans match, and say nothing about the H100 (ROADMAP).
HISTOGRAM_MAX_PAGES = 32          # never above this page count
HISTOGRAM_MIN_QUERIES = 4096      # never below this batch depth
HISTOGRAM_MIN_DEPTH = 128         # and require Q >= P * this

PLAN_METHODS = ("sort", "histogram")


def set_plan_thresholds(*, max_pages: int | None = None,
                        min_queries: int | None = None,
                        min_depth: int | None = None) -> dict:
    """Override the sort-vs-histogram crossover thresholds (process-wide,
    as in the reference). Returns the PREVIOUS values so callers (and
    :func:`plan_thresholds`) can restore them."""
    global HISTOGRAM_MAX_PAGES, HISTOGRAM_MIN_QUERIES, HISTOGRAM_MIN_DEPTH
    prev = {"max_pages": HISTOGRAM_MAX_PAGES,
            "min_queries": HISTOGRAM_MIN_QUERIES,
            "min_depth": HISTOGRAM_MIN_DEPTH}
    if max_pages is not None:
        if max_pages < 1:
            raise ValueError(f"max_pages must be >= 1, got {max_pages}")
        HISTOGRAM_MAX_PAGES = int(max_pages)
    if min_queries is not None:
        HISTOGRAM_MIN_QUERIES = int(min_queries)
    if min_depth is not None:
        HISTOGRAM_MIN_DEPTH = int(min_depth)
    return prev


@contextlib.contextmanager
def plan_thresholds(**kw):
    """Scoped :func:`set_plan_thresholds`."""
    prev = set_plan_thresholds(**kw)
    try:
        yield
    finally:
        set_plan_thresholds(**prev)


def plan_method(q_n: int, num_pages: int | None) -> str:
    """Static (shape-derived) choice of device-plan construction:
    "histogram" when the page count is small relative to a deep Q, "sort"
    otherwise (including Q == 0 and unknown page counts)."""
    if not q_n or num_pages is None:
        return "sort"
    if num_pages <= HISTOGRAM_MAX_PAGES and \
            q_n >= HISTOGRAM_MIN_QUERIES and \
            q_n >= num_pages * HISTOGRAM_MIN_DEPTH:
        return "histogram"
    return "sort"


def _plan_sort(page_of: torch.Tensor, tile: int, grid: int) -> DevicePlan:
    """Packed-sort construction: one stable value sort of the int64 key
    ``page * Q + index`` (order-isomorphic to a stable sort by page), run
    starts by a left search of the sorted pages in themselves (the first
    index of each one's run: the reference's running max, without a scan
    over the batch), steps via a cumsum over tile starts — the host plan's
    step numbering exactly."""
    q_n = page_of.shape[0]
    dev = page_of.device
    step_pages = torch.zeros(grid, dtype=torch.int32, device=dev)
    if q_n == 0:
        return DevicePlan(dest=torch.zeros(0, dtype=torch.int32, device=dev),
                          step_pages=step_pages,
                          steps_used=torch.zeros((), dtype=torch.int32,
                                                 device=dev))
    idx = torch.arange(q_n, dtype=torch.int32, device=dev)
    packed = torch.sort(page_of.long() * q_n + idx, stable=True).values
    order = packed % q_n
    sp = (packed // q_n).int()
    run_start = torch.searchsorted(sp, sp, out_int32=True)
    pos = (idx - run_start) % tile                       # lane within the step
    step = torch.cumsum(pos == 0, dim=0, dtype=torch.int32) - 1
    dest = torch.empty(q_n, dtype=torch.int32, device=dev).scatter_(
        0, order, step * tile + pos)                     # order: a permutation
    step_pages.scatter_(0, step.long(), sp)              # equal values per step
    return DevicePlan(dest=dest, step_pages=step_pages,
                      steps_used=step[-1] + 1)


def _plan_histogram(page_of: torch.Tensor, tile: int, grid: int,
                    num_pages: int) -> DevicePlan:
    """Counting-sort construction, no sort: per-page histogram and the
    within-page stable rank from an int32 prefix sum over the [Q, P]
    one-hot of page ids, then pure arithmetic in request order."""
    p = page_of.int()
    pages = torch.arange(num_pages, dtype=torch.int32, device=p.device)
    prefix = torch.cumsum(p[:, None] == pages[None, :], dim=0,
                          dtype=torch.int32)                     # [Q, P]
    within = prefix.gather(1, p[:, None].long())[:, 0] - 1
    tiles_per_page = (prefix[-1] + tile - 1) // tile
    tile_off = torch.cumsum(tiles_per_page, 0, dtype=torch.int32) \
        - tiles_per_page                                         # exclusive
    step = tile_off[p.long()] + within // tile
    dest = step * tile + within % tile
    step_pages = torch.zeros(grid, dtype=torch.int32, device=p.device) \
        .scatter_(0, step.long(), p)
    return DevicePlan(dest=dest, step_pages=step_pages,
                      steps_used=tiles_per_page.sum(dtype=torch.int32))


def device_plan(page_of: torch.Tensor, tile: int, grid: int,
                num_pages: int | None = None,
                method: str | None = None) -> DevicePlan:
    """Torch twin of :func:`bucket_plan` at the static grid ``grid`` (use
    :func:`ladder_grid`; it must be >= ``worst_case_steps``). The packed
    sort (``method="sort"``) and the histogram (``method="histogram"``,
    needs ``num_pages``) give bit-identical plans; ``method=None`` selects
    statically via :func:`plan_method`. No host sync."""
    if method is not None and method not in PLAN_METHODS:
        raise ValueError(f"unknown plan method {method!r}; "
                         f"want one of {PLAN_METHODS}")
    q_n = page_of.shape[0]
    if method is None:
        method = plan_method(q_n, num_pages)
    if method == "histogram":
        if num_pages is None:
            raise ValueError("histogram plan needs num_pages")
        if q_n:
            return _plan_histogram(page_of, tile, grid, num_pages)
    return _plan_sort(page_of, tile, grid)
