"""Key-space-sharded tiered search over a device mesh (DESIGN.md §4.2;
PyTorch port of ``repro/engine/sharded.py``).

The sorted key array is split into D contiguous, sentinel-padded shards —
one per rank along a mesh axis; each rank holds only its shard, on its
device. Each rank runs the two-tier search of its shard (page-boundary top
+ in-page count) against the *replicated* query batch, producing its local
``|{k in shard : k < q}|``. Because searchsorted-left rank is a pure count
of keys below q, the global rank is the sum of the local counts: one
``all_reduce(SUM)`` of int32 counts over the axis's process group (the
twin of ``lax.psum``), with no query routing and no rank renumbering.

The top counts ``|{s in seps : s < q}|`` without the reference's
``[Q, P]`` compare: up to 256 pages with the NitroGen top compiled into a
generated kernel (one launch; each rank compiles its own shard's), past
that with the k-ary tree over the shard's separators, descended by the
CUDA kernel ``kernels/kary_search.py`` (the tiered engine's tops,
``tiered.build_top``). The bottom is the reference's static, shape-derived
choice: deep-bucket batches (``ladder_grid(Q, tile, P) * tile <= 4Q``) run
the scheduled bottom — ``schedule.device_plan`` and one page row a grid
step, the CUDA page kernel ``kernels/page_search.py`` — and low-locality
batches keep the per-query row gather. Every stage is a count, so ranks
are bit-identical to ``np.searchsorted(keys, q, "left")`` clipped to n.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core import kary, nitrogen
from ..core.util import (as_queries, as_sorted_numpy, by_chunks,
                         ceil_to as _ceil_to, sentinel_for, take)
from ..dist import sharding as SH
from ..kernels import kary_search as _kary
from ..kernels import ops
from ..kernels import page_search as _page
from .schedule import device_plan, ladder_grid, run_scheduled
from .tiered import KARY_LANE, NITROGEN_TOP_MAX_PAGES, build_top


@dataclass(frozen=True)
class ShardedTieredIndex:
    mesh: object
    axis: str
    pages: DTensor               # [D, pages_per_shard, lw] sentinel padded
    seps: DTensor                # [D, pages_per_shard] page-last-keys
    n: int
    leaf_width: int
    shard_size: int              # padded keys per shard
    page_count: Callable         # q -> |{s in this rank's seps : s < q}|

    @property
    def num_shards(self) -> int:
        return int(self.pages.shape[0])


def _count_top(seps: np.ndarray, device) -> Callable:
    """q -> int32 ``|{s in seps : s < q}|`` in [0, P] (not clipped)."""
    p_n = int(seps.size)
    if p_n > NITROGEN_TOP_MAX_PAGES:
        top = kary.build(seps, node_width=127, device=device)
        levels = ops.kary_levels(top, KARY_LANE)
        flat, offsets = _kary.flatten_levels(levels)
        wpad = int(levels[0].shape[1])
        return lambda q: _kary.kary_search_levels(
            q, flat, offsets, fanout=top.fanout, wpad=wpad)
    if p_n > 1:
        _, top = build_top(seps, top="nitrogen", device=device)
        return lambda q: nitrogen.search(top, q)
    sep = torch.from_numpy(seps).to(device)
    return lambda q: (sep < q).to(torch.int32)


def build(keys, mesh, *, axis: str = "data",
          leaf_width: int = 128) -> ShardedTieredIndex:
    """Split the sorted key space into one contiguous shard per rank on
    `mesh`'s `axis`; each rank keeps its shard's pages and boundary seps
    and builds the top over them. Every rank of the mesh calls it with the
    same keys."""
    srt = as_sorted_numpy(keys)
    n = int(srt.size)
    d = SH.axis_sizes(mesh)[axis]
    lw = int(leaf_width)
    shard_size = _ceil_to(max(-(-n // d), 1), lw)
    pages_per_shard = shard_size // lw
    flat = np.full(d * shard_size, sentinel_for(srt.dtype), srt.dtype)
    flat[:n] = srt
    pages = flat.reshape(d, pages_per_shard, lw)
    seps = pages[:, :, -1].copy()
    pages_sh = SH.distribute(pages, SH.Sharding(mesh, (axis, None, None)))
    seps_sh = SH.distribute(seps, SH.Sharding(mesh, (axis, None)))
    c = mesh.get_coordinate()[list(SH.axis_sizes(mesh)).index(axis)]
    return ShardedTieredIndex(
        mesh=mesh, axis=axis, pages=pages_sh, seps=seps_sh, n=n,
        leaf_width=lw, shard_size=shard_size,
        page_count=_count_top(seps[c], SH.mesh_device(mesh)))


def _scheduled_local_ranks(pages, q, page_c, *, tile: int):
    """Scheduled per-shard bottom: sort-and-bucket `page_c` on device, one
    page row a grid step through the page kernel (steps past the plan's
    count exit at once), un-permute. Returns the shard-local
    searchsorted rank for queries whose (clamped) page is page_c."""
    p_n, lw = pages.shape
    q_n = q.shape[0]
    g_cap = ladder_grid(q_n, tile, p_n)
    plan = device_plan(page_c, tile, g_cap, p_n)

    def body(qb, step_pages, steps_used):
        return _page.page_search_bucketed(qb, step_pages, pages, stride=lw,
                                          steps_used=steps_used)

    return run_scheduled(plan, q, tile, g_cap, body)


def local_count(index: ShardedTieredIndex, q: torch.Tensor,
                tile: int = 128) -> torch.Tensor:
    """This rank's ``|{k in its shard : k < q}|``, int32 [Q]."""
    pages = index.pages.to_local()[0]                  # [P, lw]
    p_n, lw = pages.shape
    q_n = q.shape[0]
    page = index.page_count(q)
    page_c = page.clamp_max(p_n - 1)
    if ladder_grid(q_n, tile, p_n) * tile <= 4 * max(q_n, 1):
        planned = _scheduled_local_ranks(pages, q, page_c, tile=tile)
    else:                                # one [Q, lw] row a query
        planned = by_chunks(lw, lambda qq, pc: pc * lw + (
            take(pages, pc) < qq[:, None]).sum(-1, dtype=torch.int32),
            q, page_c)
    # pages fully below are full of real keys (padding is trailing-only)
    return torch.where(page >= p_n, p_n * lw, planned).to(torch.int32)


def search(index: ShardedTieredIndex, queries, *, tile: int = 128
           ) -> torch.Tensor:
    """Replicated ranks for a replicated query batch: per-shard two-tier
    count, summed over the key-space axis. Every rank of the mesh calls it
    with the same queries and gets every rank."""
    q = as_queries(queries, index.pages.to_local())
    counts = local_count(index, q, tile)
    dist.all_reduce(counts, group=index.mesh.get_group(index.axis))
    return counts.clamp_max(index.n)
