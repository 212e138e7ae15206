"""FAST — hierarchically blocked tree search ([KCS+10], thesis §3.4) —
PyTorch port of ``repro/core/fast_tree.py``.

The CSS directory re-blocked into pages: a vector node is ``node_width``
keys compared in one wide op, and a page is ``page_depth`` consecutive
node levels of one subtree, stored contiguously. Rank math is identical to
the CSS directory; only the *address* of a node changes: within a page,
levels are level-major; pages of one page-level are consecutive;
page-levels are concatenated. A search therefore touches one contiguous
page per ``page_depth`` levels.

``leaf_page_of`` is the directory descent alone; ``kernels/ops.py::
fast_page_search`` feeds it to the leaf-page kernel (two-phase search).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from .css_tree import _directory, leaf_rank
from .util import (as_queries, as_sorted_numpy, by_chunks, pad_to,
                   resolve_device, take_rows, upload_async)


@dataclass(frozen=True)
class FastTreeIndex:
    keys: torch.Tensor           # [n] sorted data array
    leaf_pad: torch.Tensor       # padded leaf storage
    pages: torch.Tensor          # flat hierarchically-blocked directory
    group_offsets: Tuple[int, ...]   # start of each page-level group
    group_depths: Tuple[int, ...]    # directory levels inside each group
    n: int
    node_width: int
    leaf_width: int
    depth: int                   # total directory levels
    # operands that kernels/ops.py lays out once per index (leaf pages)
    kernel_operands: dict = field(default_factory=dict, compare=False,
                                  repr=False)

    @property
    def fanout(self) -> int:
        return self.node_width + 1

    @property
    def page_keys(self) -> int:
        """keys stored in one (full-depth) page"""
        f, d = self.fanout, self.group_depths[0]
        return self.node_width * (f**d - 1) // (f - 1)

    @property
    def tree_bytes(self) -> int:
        return self.pages.numel() * self.pages.element_size()


def _page_size(w: int, d: int) -> int:
    f = w + 1
    return w * (f**d - 1) // (f - 1)


def build(keys, node_width: int = 128, leaf_width: int | None = None,
          page_depth: int = 2, *, device=None) -> FastTreeIndex:
    device = resolve_device(device)
    srt = as_sorted_numpy(keys)
    if leaf_width is None:
        leaf_width = node_width + 1
    # flat level-major directory first (same separators as a CSS tree) ...
    dir_keys, level_offsets, depth = _directory(srt, node_width, leaf_width)
    f = node_width + 1
    # ... then re-blocked into pages of `page_depth` levels
    group_depths = []
    rem = depth
    while rem > 0:
        group_depths.append(min(page_depth, rem))
        rem -= group_depths[-1]
    chunks, group_offsets, off = [], [], 0
    lvl = 0
    for d in group_depths:
        n_pages = f**lvl                       # pages in this group
        psize = _page_size(node_width, d)
        block = np.zeros(n_pages * psize, dtype=dir_keys.dtype)
        for dl in range(d):                    # local level dl inside the page
            lo = level_offsets[lvl + dl]
            lev = dir_keys[lo: lo + node_width * f**(lvl + dl)]
            lev = lev.reshape(n_pages, f**dl * node_width)
            loff = _page_size(node_width, dl)
            idx = (np.arange(n_pages)[:, None] * psize + loff
                   + np.arange(f**dl * node_width)[None, :])
            block[idx.reshape(-1)] = lev.reshape(-1)
        chunks.append(block)
        group_offsets.append(off)
        off += block.size
        lvl += d
    pages = np.concatenate(chunks) if chunks else np.empty(0, dtype=srt.dtype)
    leaf_pad = pad_to(srt, f**depth * leaf_width)
    return FastTreeIndex(
        keys=upload_async(srt, device),
        leaf_pad=upload_async(leaf_pad, device),
        pages=upload_async(pages, device),
        group_offsets=tuple(group_offsets), group_depths=tuple(group_depths),
        n=int(srt.size), node_width=int(node_width),
        leaf_width=int(leaf_width), depth=int(depth),
    )


def _descend(index: FastTreeIndex, q: torch.Tensor) -> torch.Tensor:
    """Directory descent -> leaf block index j (== rank // leaf_width path)."""
    w, f = index.node_width, index.fanout
    j = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    for g, d in enumerate(index.group_depths):
        # node rows (of w keys): every page and in-page level starts at a
        # multiple of w; the node index at the group top is the page
        psize = _page_size(w, d)
        page_row = index.group_offsets[g] // w + j * (psize // w)
        j_local = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
        for dl in range(d):
            row = page_row + _page_size(w, dl) // w + j_local
            node = take_rows(index.pages, w, row)
            c = (node < q[:, None]).sum(-1, dtype=torch.int32)
            j_local = j_local * f + c
            j = j * f + c
    return j


def search(index: FastTreeIndex, queries) -> torch.Tensor:
    """searchsorted-left rank of each query, in [0, n]; int32 [Q]."""
    q = as_queries(queries, index.keys)

    def run(qq):
        return leaf_rank(index.leaf_pad, _descend(index, qq), qq,
                         index.leaf_width)

    width = max(index.node_width, index.leaf_width)
    return by_chunks(width, run, q).clamp_max(index.n)


def leaf_page_of(index: FastTreeIndex, queries) -> torch.Tensor:
    """Leaf-block id per query (the directory descent only): the first
    phase of the two-phase page-kernel search."""
    q = as_queries(queries, index.keys)
    return by_chunks(index.node_width, lambda qq: _descend(index, qq), q)
