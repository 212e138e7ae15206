"""CSS-tree (thesis Alg 3.1 / [RR99]) — PyTorch port of
``repro/core/css_tree.py``.

A pointer-free directory of separator keys over the sorted data array, all
levels linearised level-major in one contiguous buffer; child addresses are
pure arithmetic (``j*fanout + c``). The node width defaults to the
reference's 128 keys. Inside a node, ``intra='vector'`` counts the
separators below the query in one wide compare; ``intra='binary'`` is the
paper's binary range search (``log2 w`` dependent steps). Both read the
same node and give the same child.

On the card ``search`` is one launch of ``kernels/flat_search.py``'s
``flat_descent`` (the level table from ``descent_args``). On the CPU it
runs ``search_plain``, which gathers a ``[Q, w]`` node a level and a
``[Q, leaf_width]`` leaf block as row gathers (``util.take_rows``), over
slices of the batch (``util.by_chunks``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from ..kernels import flat_search
from .util import (as_queries, as_sorted_numpy, by_chunks, next_pow, pad_to,
                   resolve_device, sentinel_for, take_rows, upload_async)

INTRAS = ("vector", "binary")


@dataclass(frozen=True)
class CSSTreeIndex:
    keys: torch.Tensor        # [n] sorted data array (the leaves)
    leaf_pad: torch.Tensor    # [num_leaves * leaf_width] padded leaf storage
    dir_keys: torch.Tensor    # flat level-major directory
    level_offsets: Tuple[int, ...]
    n: int
    node_width: int           # separators per directory node (w)
    leaf_width: int
    depth: int                # number of directory levels (D)
    intra: str = "vector"     # 'vector' | 'binary'
    # flat_descent's stage and samples (kernels/flat_search.py), held by
    # an index on the card (None on the CPU: search runs search_plain)
    stage: flat_search.DescentStage | None = field(
        default=None, compare=False, repr=False)

    @property
    def fanout(self) -> int:
        return self.node_width + 1

    @property
    def tree_bytes(self) -> int:
        return self.dir_keys.numel() * self.dir_keys.element_size()


def _directory(srt: np.ndarray, w: int, leaf_width: int):
    """Build the level-major separator directory (vectorised per level)."""
    f = w + 1
    num_leaves = -(-srt.size // leaf_width)
    depth = next_pow(f, num_leaves)
    sent = sentinel_for(srt.dtype)
    n = srt.size
    levels = []
    offsets = []
    off = 0
    for l in range(depth):
        js = np.arange(f**l, dtype=np.int64)
        i = np.arange(w, dtype=np.int64)
        # separator i of node j = max key covered by child i
        child_span = f ** (depth - 1 - l) * leaf_width       # keys per child
        rank = (js[:, None] * f + i[None, :] + 1) * child_span - 1
        sep = np.where(rank < n, srt[np.minimum(rank, n - 1)], sent)
        levels.append(sep.reshape(-1).astype(srt.dtype))
        offsets.append(off)
        off += levels[-1].size
    dir_keys = (
        np.concatenate(levels) if levels else np.empty(0, dtype=srt.dtype)
    )
    return dir_keys, tuple(offsets), depth


def build(keys, node_width: int = 128, leaf_width: int | None = None,
          intra: str = "vector", *, device=None) -> CSSTreeIndex:
    if intra not in INTRAS:
        raise ValueError(f"unknown intra-node search {intra!r}; "
                         f"want one of {INTRAS}")
    device = resolve_device(device)
    srt = as_sorted_numpy(keys)
    if leaf_width is None:
        leaf_width = node_width + 1
    dir_keys, offsets, depth = _directory(srt, node_width, leaf_width)
    num_leaves = (node_width + 1) ** depth
    leaf_pad = pad_to(srt, num_leaves * leaf_width)
    stage = None
    if device.type == "cuda":           # on the CPU search runs search_plain
        stage = flat_search.descent_stage(
            dir_keys, flat_search.level_descent("css", offsets,
                                                int(node_width), intra),
            leaf_pad, int(leaf_width), n=int(srt.size), device=device)
    return CSSTreeIndex(
        keys=upload_async(srt, device),
        leaf_pad=upload_async(leaf_pad, device),
        dir_keys=upload_async(dir_keys, device),
        level_offsets=offsets, n=int(srt.size), node_width=int(node_width),
        leaf_width=int(leaf_width), depth=int(depth), intra=intra,
        stage=stage,
    )


def _node_child(node_keys: torch.Tensor, q: torch.Tensor, w: int,
                intra: str) -> torch.Tensor:
    """Index of the child branch: count of separators < q (searchsorted-left
    descent). 'vector' = one wide compare; 'binary' = the paper's
    intra-node binary range search (log2 w dependent steps)."""
    if intra == "vector":
        return (node_keys < q[:, None]).sum(-1, dtype=torch.int32)
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    size = w
    while size > 0:
        half = (size + 1) // 2
        probe = node_keys.gather(1, (lo + (half - 1)).long()[:, None])[:, 0]
        lo = torch.where(probe < q, lo + half, lo)
        size -= half
    return lo


def leaf_rank(leaf_pad: torch.Tensor, j: torch.Tensor, q: torch.Tensor,
              leaf_width: int) -> torch.Tensor:
    """Rank of each query inside its leaf block j: j * leaf_width plus the
    keys of the block below it."""
    blk = take_rows(leaf_pad, leaf_width, j)
    return j * leaf_width + (blk < q[:, None]).sum(-1, dtype=torch.int32)


def _search(index: CSSTreeIndex, q: torch.Tensor) -> torch.Tensor:
    w, f = index.node_width, index.fanout
    j = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    for l in range(index.depth):
        node = take_rows(index.dir_keys, w, index.level_offsets[l] // w + j)
        j = j * f + _node_child(node, q, w, index.intra)
    return leaf_rank(index.leaf_pad, j, q, index.leaf_width)


def search_plain(index: CSSTreeIndex, q: torch.Tensor) -> torch.Tensor:
    """The PyTorch composition of ``search`` on the queries' device."""
    width = max(index.node_width, index.leaf_width)
    return by_chunks(width, lambda qq: _search(index, qq), q) \
        .clamp_max(index.n)


def descent_args(index: CSSTreeIndex) -> flat_search.Descent:
    """The directory's level table for ``flat_descent`` (cached)."""
    return flat_search.level_descent("css", index.level_offsets,
                                     index.node_width, index.intra)


def search(index: CSSTreeIndex, queries) -> torch.Tensor:
    """searchsorted-left rank of each query, in [0, n]; int32 [Q]. On the
    card one ``flat_descent`` launch, on the CPU ``search_plain``."""
    q = as_queries(queries, index.keys)
    if q.device.type == "cpu":
        return search_plain(index, q)
    return flat_search.flat_descent(q, index.dir_keys, descent_args(index),
                                    index.leaf_pad, index.leaf_width,
                                    ending="leaf", n=index.n,
                                    stage=index.stage)
