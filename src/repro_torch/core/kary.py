"""k-ary search on a linearized tree ([SGL09], thesis §3.3) — PyTorch port
of ``repro/core/kary.py``.

The linearized tree is a *permutation* of the sorted keys: every key
appears exactly once, placed so each node's k-1 keys are contiguous. The
rank accumulates digit by digit (rank = rank*f + c), so no back-pointers or
final permutation inversion are needed. On the card ``search`` is one
launch of ``kernels/flat_search.py``'s ``flat_descent``; on the CPU it runs
``search_plain``, a PyTorch composition (a ``[Q, w]`` row gather a level,
over slices of the batch). The tiered engine's top tier and
``kernels/ops.py::kary_search`` descend the same tree, lane-padded, with
the kernel in ``kernels/kary_search.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from ..kernels import flat_search
from .util import (as_queries, as_sorted_numpy, by_chunks, next_pow, pad_to,
                   resolve_device, take_rows, upload_async)


@dataclass(frozen=True)
class KaryTreeIndex:
    keys: torch.Tensor         # [n] sorted (kept as the value-rank reference)
    tree: torch.Tensor         # [f**depth - 1] permuted level-major tree
    level_offsets: Tuple[int, ...]
    n: int
    node_width: int            # w = k - 1 keys per node
    depth: int
    # operands that kernels/ops.py lays out once per index (flat levels)
    kernel_operands: dict = field(default_factory=dict, compare=False,
                                  repr=False)
    # flat_descent's stage and samples (kernels/flat_search.py), held by
    # an index on the card (None on the CPU: search runs search_plain)
    stage: flat_search.DescentStage | None = field(
        default=None, compare=False, repr=False)

    @property
    def fanout(self) -> int:
        return self.node_width + 1

    @property
    def tree_bytes(self) -> int:
        # the tree replaces the sorted array; extra storage is only padding
        return (self.tree.numel() - self.n) * self.tree.element_size()


def perm_ranks(depth: int, w: int) -> np.ndarray:
    """tree_slot -> sorted rank for a complete (w+1)-ary tree, level-major.

    Level l, node j, slot i holds rank  j*f**(depth-l) + (i+1)*f**(depth-l-1) - 1.
    """
    f = w + 1
    out = []
    for l in range(depth):
        js = np.arange(f**l, dtype=np.int64)
        i = np.arange(w, dtype=np.int64)
        r = js[:, None] * f ** (depth - l) + (i[None, :] + 1) * f ** (depth - l - 1) - 1
        out.append(r.reshape(-1))
    return np.concatenate(out)


def build(keys, node_width: int = 128, *, device=None) -> KaryTreeIndex:
    device = resolve_device(device)
    srt = as_sorted_numpy(keys)
    f = node_width + 1
    depth = max(next_pow(f, srt.size + 1), 1)
    padded = pad_to(srt, f**depth - 1)
    tree = padded[perm_ranks(depth, node_width)]
    offsets, off = [], 0
    for l in range(depth):
        offsets.append(off)
        off += node_width * f**l
    return KaryTreeIndex(
        keys=upload_async(srt, device),
        tree=upload_async(tree, device),
        level_offsets=tuple(offsets), n=int(srt.size),
        node_width=int(node_width), depth=int(depth),
        stage=kernel_stage(tree, offsets, node_width, srt.size, device),
    )


def kernel_stage(tree: np.ndarray, level_offsets, node_width: int, n: int,
                 device: torch.device):
    """flat_descent's stage of a k-ary tree (its host array) for an index
    on ``device``: None on the CPU, whose search runs ``search_plain``."""
    if device.type != "cuda":
        return None
    d = flat_search.level_descent("kary", tuple(level_offsets),
                                  int(node_width))
    return flat_search.descent_stage(tree, d, n=int(n), device=device)


def _search(index: KaryTreeIndex, q: torch.Tensor) -> torch.Tensor:
    w, f = index.node_width, index.fanout
    # the node index IS the accumulated rank: j_{l+1} = j_l * f + c_l, and
    # after the last level  j == sum_l c_l * f**(depth-1-l) == searchsorted rank
    j = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    for l in range(index.depth):
        node = take_rows(index.tree, w, index.level_offsets[l] // w + j)
        c = (node < q[:, None]).sum(-1, dtype=torch.int32)
        j = j * f + c
    return j


def search_plain(index: KaryTreeIndex, q: torch.Tensor) -> torch.Tensor:
    """The PyTorch composition of ``search`` on the queries' device."""
    return by_chunks(index.node_width, lambda qq: _search(index, qq), q) \
        .clamp_max(index.n)


def descent_args(index: KaryTreeIndex) -> flat_search.Descent:
    """The tree's level table for ``flat_descent`` (cached)."""
    return flat_search.level_descent("kary", index.level_offsets,
                                     index.node_width)


def search(index: KaryTreeIndex, queries) -> torch.Tensor:
    """searchsorted-left rank of each query, in [0, n]; int32 [Q]. On the
    card one ``flat_descent`` launch, on the CPU ``search_plain``."""
    q = as_queries(queries, index.keys)
    if q.device.type == "cpu":
        return search_plain(index, q)
    return flat_search.flat_descent(q, index.tree, descent_args(index),
                                    ending="rank", n=index.n,
                                    stage=index.stage)
