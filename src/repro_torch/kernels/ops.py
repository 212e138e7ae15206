"""Layout helpers binding the k-ary kernel to the core index structures,
and the sampler's CDF inversion (PyTorch port of the sizing half of
``repro/kernels/ops.py`` and of its ``topp_search``).

``VMEM_BUDGET_BYTES`` and ``kary_vmem_bytes`` keep the reference's TPU
arithmetic on purpose: ``engine/tiered.plan_tiers`` sizes the tiers from
them, and identical arithmetic gives identical ``leaf_width``, page counts
and top kinds for every n, so ranks and layouts match the reference. A
sizing rule drawn from the H100's shared memory is later work (ROADMAP).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.kary import KaryTreeIndex
from ..core.util import ceil_to, next_pow, sentinel_for
from . import cdf_search as _cdf

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
    sentinel-padded to the lane width, on the tree's device."""
    w, f = index.node_width, index.fanout
    tree = index.tree.cpu().numpy()
    sent = sentinel_for(tree.dtype)
    wpad = ceil_to(w, lane)
    out = []
    for l in range(index.depth):
        n_l = f**l
        lvl = tree[index.level_offsets[l]:index.level_offsets[l] + n_l * w]
        full = np.full((n_l, wpad), sent, tree.dtype)
        full[:, :w] = lvl.reshape(n_l, w)
        out.append(torch.from_numpy(full).to(index.tree.device))
    return out


def topp_search(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Nucleus-sampling CDF inversion: [B] int32, the first index with
    cdf >= u per row, clipped to V - 1. The reference pads batch and
    vocabulary to its TPU tiles; the CUDA kernel takes any shape, so
    nothing is padded."""
    return _cdf.cdf_search(cdf, u)
