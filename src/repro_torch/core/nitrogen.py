"""NitroGen — index compilation (thesis Ch. 4), PyTorch port of
``repro/core/nitrogen.py``.

The thesis generates code in which the *top levels of the index are
literal constants in the instruction stream*. Here, as in the reference,
``_gen_network`` builds in Python a branch-free select network whose
separator keys are Python scalars: each comparison is ``q <= sep`` against a
scalar operand, so there is no separator tensor and no gather. A float32
query compared with a Python float stays a float32 compare (the separators
come from float32 keys, so they convert back exactly).

The reference's jit folds the network into one executable; in eager
PyTorch it is one ``torch.where`` launch per separator (63 at 3 levels of
3 separators, the tiered top's 256 pages). The selected block is then
searched by the data-resident bottom, the thesis' hybrid: ``binary`` (the
uniform lower_bound over the block padded to a power of two), ``vector``
(one compare against the whole block: ``[Q, block_width]``, so only for
narrow blocks) or ``css`` (a CSS directory per block, stacked).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from . import css_tree
from .util import (as_queries, as_sorted_numpy, by_chunks, next_pow, pad_to,
                   resolve_device, take, take_rows, upload_async)

BOTTOMS = ("binary", "vector", "css")


@dataclass(frozen=True)
class NitroGenIndex:
    keys: torch.Tensor           # [n] sorted data array
    block_pad: torch.Tensor      # [num_blocks * block_pad_width] bottom storage
    n: int
    levels: int                  # compiled levels
    node_width: int              # separators per compiled node
    num_blocks: int
    block_width: int             # keys per bottom block (before padding)
    block_pad_width: int
    bottom: str                  # 'binary' | 'vector' | 'css'
    network: Callable            # q[batch] -> block id  (the compiled top)
    # bottom='css': a CSS directory per block, stacked (the thesis' hybrid —
    # compiled top levels, base-structure search below)
    css_dirs: Optional[torch.Tensor] = None      # [num_blocks * dir_len]
    css_offsets: tuple = ()
    css_depth: int = 0
    css_w: int = 0
    css_leaf_width: int = 0
    css_dir_len: int = 0
    css_leaf_len: int = 0

    @property
    def fanout(self) -> int:
        return self.node_width + 1

    @property
    def tree_bytes(self) -> int:
        # the compiled top lives in the program, not in a data buffer
        return 0


def _const(k, q: torch.Tensor) -> torch.Tensor:
    return k(q) if callable(k) else torch.full(q.shape, k, dtype=torch.int32,
                                                device=q.device)


def _gen_network(srt: np.ndarray, levels: int, w: int, block_width: int):
    """Recursively emit the constant select network: f(q) -> block index,
    where every separator is a Python scalar and every leaf a Python int."""
    f = w + 1
    n = srt.size

    def sep_at(block_boundary: int):
        rank = min(block_boundary * block_width - 1, n - 1)
        return srt[rank].item()          # python scalar, not a tensor

    def rec(b0: int, span: int):
        if span == 1:
            return b0                     # leaf: constant block id
        child = span // f
        kids = [rec(b0 + i * child, child) for i in range(f)]
        seps = [sep_at(b0 + (i + 1) * child) for i in range(w)]

        def apply(q):
            out = _const(kids[-1], q)
            for i in reversed(range(w)):
                out = torch.where(q <= seps[i], _const(kids[i], q), out)
            return out

        return apply

    top = rec(0, f**levels)
    return lambda q: _const(top, q)


def build(keys, levels: int = 3, node_width: int = 3, bottom: str = "binary",
          css_node_width: int = 16, *, device=None) -> NitroGenIndex:
    if bottom not in BOTTOMS:
        raise ValueError(f"unknown nitrogen bottom {bottom!r}; "
                         f"want one of {BOTTOMS}")
    device = resolve_device(device)
    srt = as_sorted_numpy(keys)
    f = node_width + 1
    num_blocks = f**levels
    block_width = -(-srt.size // num_blocks)
    css = {}
    if bottom == "binary":
        # +1: the in-block uniform lower_bound needs a sentinel slot to be
        # able to return offset == block_width (q above the whole block)
        bw_pad = 1 << next_pow(2, max(block_width, 1) + 1)
    elif bottom == "css":
        # the thesis' hybrid proper: a CSS directory under the compiled top.
        # Every block gets an identically-shaped directory, stacked flat.
        w = css_node_width
        dirs, leaves = [], []
        for b in range(num_blocks):
            # pad every block to block_width first so all per-block
            # directories share one shape (stackable, arithmetic-addressable)
            blk = pad_to(srt[b * block_width: (b + 1) * block_width],
                         block_width)
            d, offs, depth = css_tree._directory(blk, w, w + 1)
            num_leaves = (w + 1) ** depth
            dirs.append(d)
            leaves.append(pad_to(blk, num_leaves * (w + 1)))
        css = dict(css_dirs=upload_async(np.concatenate(dirs), device),
                   css_offsets=offs, css_depth=depth, css_w=w,
                   css_leaf_width=w + 1, css_dir_len=int(dirs[0].size),
                   css_leaf_len=int(leaves[0].size))
        bw_pad = int(leaves[0].size)
        block_pad = np.concatenate(leaves)
    else:
        bw_pad = block_width
    if bottom != "css":
        block_pad = np.stack([
            pad_to(srt[b * block_width: (b + 1) * block_width], bw_pad)
            for b in range(num_blocks)
        ]).reshape(-1)
    return NitroGenIndex(
        keys=upload_async(srt, device),
        block_pad=upload_async(block_pad, device),
        n=int(srt.size), levels=int(levels), node_width=int(node_width),
        num_blocks=int(num_blocks), block_width=int(block_width),
        block_pad_width=int(bw_pad), bottom=bottom,
        network=_gen_network(srt, levels, node_width, block_width), **css,
    )


def _bottom_binary(index: NitroGenIndex, b, q):
    """Generic data-resident lower_bound inside the selected block."""
    bw_pad = index.block_pad_width
    pos = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    base = b * bw_pad
    step = bw_pad // 2
    while step >= 1:
        probe = take(index.block_pad, base + pos + (step - 1))
        pos = torch.where(probe < q, pos + step, pos)
        step //= 2
    return pos


def _bottom_vector(index: NitroGenIndex, b, q):
    blk = take_rows(index.block_pad, index.block_pad_width, b)
    return (blk < q[:, None]).sum(-1, dtype=torch.int32)


def _bottom_css(index: NitroGenIndex, b, q):
    """Per-block CSS descent (block-offset arithmetic on stacked dirs, in
    rows of css_w keys: every directory and level starts at a multiple)."""
    w, f = index.css_w, index.css_w + 1
    j = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    drow = b * (index.css_dir_len // w)
    for l in range(index.css_depth):
        node = take_rows(index.css_dirs, w,
                         drow + index.css_offsets[l] // w + j)
        j = j * f + (node < q[:, None]).sum(-1, dtype=torch.int32)
    lw = index.css_leaf_width
    blk = take_rows(index.block_pad, lw, b * (index.css_leaf_len // lw) + j)
    return j * lw + (blk < q[:, None]).sum(-1, dtype=torch.int32)


_BOTTOM_FNS = {"binary": _bottom_binary, "vector": _bottom_vector,
               "css": _bottom_css}


def _bottom_width(index: NitroGenIndex) -> int:
    """Widest block a query gathers in the bottom (1: none)."""
    if index.bottom == "vector":
        return index.block_pad_width
    if index.bottom == "css":
        return index.css_leaf_width
    return 1


def search(index: NitroGenIndex, queries) -> torch.Tensor:
    """searchsorted-left rank of each query, in [0, n]; int32 [Q]."""
    q = as_queries(queries, index.keys)
    b = index.network(q)                               # compiled top (constants)
    off = by_chunks(_bottom_width(index), lambda qq, bb: _BOTTOM_FNS[
        index.bottom](index, bb, qq), q, b)
    rank = b * index.block_width + off.clamp_max(index.block_width)
    return rank.clamp_max(index.n)


def searcher(index: NitroGenIndex) -> Callable:
    """The 'compiled index' artifact: a closure over the built index whose
    top is the constant network (the reference jits it; here it runs
    eagerly)."""
    return lambda q: search(index, q)
