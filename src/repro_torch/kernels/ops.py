"""Wrappers binding the CUDA kernels to the core index structures, and the
sampler's CDF inversion — PyTorch port of ``repro/kernels/ops.py``.

``kary_search`` runs the k-ary kernel (``kernels/kary_search.py``) over a
``core/kary.py`` tree; ``fast_page_search`` is the two-phase FAST search:
the directory descent, the host bucket plan, then the page kernel
(``kernels/page_search.py``) streaming one leaf page a grid step. Each
lays out its kernel operand once per index, on the index's device.

``VMEM_BUDGET_BYTES`` and ``kary_vmem_bytes`` keep the reference's TPU
arithmetic on purpose: ``engine/tiered.plan_tiers`` sizes the tiers from
them, and identical arithmetic gives identical ``leaf_width``, page counts
and top kinds for every n, so ranks and layouts match the reference. A
sizing rule drawn from the H100's shared memory is later work (ROADMAP).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.fast_tree import FastTreeIndex, leaf_page_of
from ..core.kary import KaryTreeIndex
from ..core.util import (as_queries, ceil_to, next_pow, numpy_dtype,
                         sentinel_for, upload_async)
from . import cdf_search as _cdf
from . import kary_search as _kary
from . import page_search as _page

VMEM_BUDGET_BYTES = 12 * 2**20     # the reference's per-core VMEM budget


def kary_vmem_bytes(n_keys: int, *, node_width: int = 127, lane: int = 128,
                    tile_rows: int = 8) -> int:
    """The reference kernel's VMEM need for a tree over `n_keys`:
    lane-padded per-level operands plus the deepest level's one-hot gather
    matrix. Kept only as the tier-sizing rule (DESIGN.md §3)."""
    f = node_width + 1
    depth = max(next_pow(f, n_keys + 1), 1)
    wpad = ceil_to(node_width, lane)
    tree = sum(f**l * wpad for l in range(depth)) * 4
    onehot = tile_rows * lane * f ** (depth - 1) * 4
    return tree + onehot


def kary_levels(index: KaryTreeIndex, lane: int) -> list[torch.Tensor]:
    """Split the flat level-major tree into per-level [n_l, wpad] rows,
    sentinel-padded to the lane width, on the tree's device (no host
    copy)."""
    w, f = index.node_width, index.fanout
    tree = index.tree
    sent = sentinel_for(numpy_dtype(tree.dtype)).item()
    wpad = ceil_to(w, lane)
    out = []
    for l in range(index.depth):
        n_l = f**l
        off = index.level_offsets[l]
        full = torch.full((n_l, wpad), sent, dtype=tree.dtype,
                          device=tree.device)
        full[:, :w] = tree[off:off + n_l * w].view(n_l, w)
        out.append(full)
    return out


def kary_search(index: KaryTreeIndex, queries, *, lane: int = 128,
                tile_rows: int = 8) -> torch.Tensor:
    """Batched k-ary search on the linearised tree through the k-ary
    kernel; int32 ranks [Q] clipped to n. Trees past the reference's
    in-VMEM budget raise its ``ValueError``, computed on the caller's
    ``lane`` and ``tile_rows`` (the guard admits depth 6 at most, within
    the kernel's ``MAX_DEPTH``). The kernel's rows are the lane-padded
    rows widened to a multiple of 4 (its vector loads) with sentinels,
    which no query counts; they are laid out once per index and lane."""
    w, f = index.node_width, index.fanout
    wpad = ceil_to(w, lane)
    tq = tile_rows * lane
    deepest = f ** (index.depth - 1)
    vmem = sum(f**l for l in range(index.depth)) * wpad * 4 \
        + tq * deepest * 4
    if vmem > VMEM_BUDGET_BYTES:
        raise ValueError(
            f"tree too large for the in-VMEM kernel (~{vmem/2**20:.1f} MiB); "
            "use fast_page_search (HBM streaming)")
    key = ("kary_levels", lane)
    if key not in index.kernel_operands:
        kwpad = ceil_to(wpad, 4)
        flat, offsets = _kary.flatten_levels(kary_levels(index, kwpad))
        index.kernel_operands[key] = (flat, offsets, kwpad)
    flat, offsets, kwpad = index.kernel_operands[key]
    q = as_queries(queries, index.keys)
    ranks = _kary.kary_search_levels(q, flat, offsets, fanout=f, wpad=kwpad)
    return ranks.clamp_max(index.n)


PAGE_LANE = 128                    # leaf pages are padded to this width


def fast_leaf_pages(index: FastTreeIndex) -> torch.Tensor:
    """The leaf blocks as page-kernel rows [num_pages, lw_pad], lw_pad =
    leaf_width rounded up to 128 with sentinels; laid out once per index
    on its device."""
    if "leaf_pages" not in index.kernel_operands:
        lw = index.leaf_width
        num_pages = index.leaf_pad.numel() // lw
        sent = sentinel_for(numpy_dtype(index.keys.dtype)).item()
        pages = torch.full((num_pages, ceil_to(lw, PAGE_LANE)), sent,
                           dtype=index.leaf_pad.dtype,
                           device=index.leaf_pad.device)
        pages[:, :lw] = index.leaf_pad.view(num_pages, lw)
        index.kernel_operands["leaf_pages"] = pages
    return index.kernel_operands["leaf_pages"]


def fast_page_operands(index: FastTreeIndex, q: torch.Tensor, plan):
    """The page kernel's bucketed queries [grid, tile] for a host
    ``BucketPlan``, and each query's lane and its request index as int64
    device tensors. Lanes no query takes hold q[0], as the reference's
    gather of the plan gives them."""
    lanes = np.flatnonzero(plan.valid)
    src = plan.gather[lanes].astype(np.int64)
    lanes_d = upload_async(lanes.astype(np.int64), q.device)
    src_d = upload_async(src, q.device)
    q_src = q if q.shape[0] else torch.zeros(1, dtype=q.dtype,
                                             device=q.device)
    tile = plan.gather.size // plan.grid
    qb = q_src[:1].repeat(plan.grid * tile)
    qb[lanes_d] = q_src[src_d]
    return qb.view(plan.grid, tile), lanes_d, src_d


def fast_page_search(index: FastTreeIndex, queries, *,
                     tile: int = 128) -> torch.Tensor:
    """Two-phase FAST search: the directory descent (``leaf_page_of``),
    then the page kernel over the queries grouped by leaf page, one page a
    grid step at ``stride = leaf_width``; int32 ranks [Q] in request
    order, clipped to n. The bucket plan is numpy
    (``engine/schedule.py::bucket_plan``), so this wrapper waits for the
    descent, as the reference does; Q = 0 rides its trivial one-step
    plan."""
    # lazy: kernels -> engine would cycle through engine/__init__
    from ..engine.schedule import bucket_plan
    q = as_queries(queries, index.keys)
    plan = bucket_plan(leaf_page_of(index, q).cpu().numpy(), tile)
    qb, lanes, src = fast_page_operands(index, q, plan)
    step_pages = upload_async(plan.step_pages, q.device)
    ranks = _page.page_search_bucketed(qb, step_pages, fast_leaf_pages(index),
                                       stride=index.leaf_width)
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    out[src] = ranks.view(-1)[lanes]
    return out.clamp_max(index.n)


def topp_search(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Nucleus-sampling CDF inversion: [B] int32, the first index with
    cdf >= u per row, clipped to V - 1. The reference pads batch and
    vocabulary to its TPU tiles; the CUDA kernel takes any shape, so
    nothing is padded."""
    return _cdf.cdf_search(cdf, u)
