"""NitroGen — index compilation (thesis Ch. 4), PyTorch port of
``repro/core/nitrogen.py``.

The thesis generates code in which the *top levels of the index are
literal constants in the instruction stream*. ``walk`` follows the
reference's ``_gen_network`` recursion and gives the top as a tree whose
separators are Python scalars, taken at the same ranks (``sep_at``). Two
things are made from that one walk, so they cannot drift apart:

* on the card, ``build`` generates a CUDA kernel for the index, every
  separator a literal, compiles it with nvcc into a cubin, loads it and
  launches it once (``kernels/nitrogen_codegen.py``): the reference's
  jitted executable. ``search`` is then one launch, the compiled top and
  the data-resident bottom together. A compile or launch failure raises;
* on the CPU, the plain version: the branch-free select network in
  PyTorch, one ``torch.where`` per separator against a scalar operand (no
  separator tensor, no gather), then the bottom. A float32 query compared
  with a Python float stays a float32 compare (the separators come from
  float32 keys, so they convert back exactly).

The selected block is searched by the data-resident bottom, the thesis'
hybrid: ``binary`` (the uniform lower_bound over the block padded to a
power of two), ``vector`` (one compare against the whole block:
``[Q, block_width]`` in the plain version, so only for narrow blocks) or
``css`` (a CSS directory per block, stacked).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..kernels import nitrogen_codegen as _codegen
from . import css_tree
from .util import (as_queries, as_sorted_numpy, by_chunks, next_pow,
                   numpy_dtype, pad_to, resolve_device, sentinel_for, take,
                   take_rows, upload_async)

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
    network: Callable            # q[batch] -> block id: the plain top
    # bottom='css': a CSS directory per block, stacked (the thesis' hybrid —
    # compiled top levels, base-structure search below)
    css_dirs: Optional[torch.Tensor] = None      # [num_blocks * dir_len]
    css_offsets: tuple = ()
    css_depth: int = 0
    css_w: int = 0
    css_leaf_width: int = 0
    css_dir_len: int = 0
    css_leaf_len: int = 0
    # the generated kernel's copies of the row slots its lower bound reads
    # first (kernels/nitrogen_codegen.layout; empty when it reads none):
    # the first levels' (copied into shared memory) and every window's
    # width's
    stage: Optional[torch.Tensor] = None
    sample: Optional[torch.Tensor] = None
    stage_levels: int = 0
    # the generated kernel (kernels/nitrogen_codegen.CompiledTop): the top
    # and the bottom in one launch. None on the CPU.
    kernel: Any = None

    @property
    def fanout(self) -> int:
        return self.node_width + 1

    @property
    def library(self) -> Optional[str]:
        """Path of the kernel's cubin (None on the CPU)."""
        return None if self.kernel is None else str(self.kernel.library)

    @property
    def tree_bytes(self) -> int:
        # the compiled top lives in the program, not in a data buffer
        return 0


def walk(srt: np.ndarray, levels: int, w: int, block_width: int):
    """The compiled top as the reference's recursion emits it: a leaf is
    its block id (a Python int), a node the pair (separators, kids) with
    ``w`` separators (Python scalars) and ``w + 1`` kids."""
    f = w + 1
    n = srt.size

    def sep_at(block_boundary: int):
        rank = min(block_boundary * block_width - 1, n - 1)
        return srt[rank].item()          # python scalar, not a tensor

    def rec(b0: int, span: int):
        if span == 1:
            return b0                     # leaf: constant block id
        child = span // f
        kids = tuple(rec(b0 + i * child, child) for i in range(f))
        seps = tuple(sep_at(b0 + (i + 1) * child) for i in range(w))
        return seps, kids

    return rec(0, f**levels)


def _plain_network(tree) -> Callable:
    """The walked top as PyTorch: f(q) -> block index, the reference's
    select at every node, each separator a scalar operand."""

    def apply(node, q):
        if isinstance(node, int):
            return torch.full(q.shape, node, dtype=torch.int32,
                              device=q.device)
        seps, kids = node
        out = apply(kids[-1], q)
        for i in reversed(range(len(seps))):
            out = torch.where(q <= seps[i], apply(kids[i], q), out)
        return out

    return lambda q: apply(tree, q)


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
    tree = walk(srt, levels, node_width, block_width)
    stage_levels, stage, sample = _samples(block_pad, bottom, num_blocks,
                                           bw_pad)
    index = NitroGenIndex(
        keys=upload_async(srt, device),
        block_pad=upload_async(block_pad, device),
        n=int(srt.size), levels=int(levels), node_width=int(node_width),
        num_blocks=int(num_blocks), block_width=int(block_width),
        block_pad_width=int(bw_pad), bottom=bottom,
        network=_plain_network(tree), stage=upload_async(stage, device),
        sample=upload_async(sample, device), stage_levels=stage_levels,
        **css,
    )
    if device.type != "cuda":
        return index
    return _compiled(index, tree)


def _samples(block_pad: np.ndarray, bottom: str, num_blocks: int,
             block_pad_width: int) -> tuple:
    """The generated kernel's staged levels and its stage and sample
    arrays (``_codegen.layout``): the slots of every row, padded to a
    power of two (the sentinel past the row), that the lower bound's first
    levels probe (slot (i + 1) * 2^(levels - staged) - 1 for i < 2^staged
    - 1, padded with the sentinel to whole 16-byte pieces), and every
    window's width's (slot (m + 1) * window - 1); empty when the kernel
    reads none."""
    lay = _codegen.layout(block_pad.dtype, bottom, num_blocks,
                          block_pad_width)
    log2 = _codegen.row_log2(block_pad_width)
    rows = block_pad.reshape(num_blocks, -1)
    sent = sentinel_for(block_pad.dtype)

    def every(shift: int, count: int) -> np.ndarray:
        slots = (np.arange(1, count + 1) << shift) - 1
        return np.where(slots < block_pad_width,
                        rows[:, np.minimum(slots, block_pad_width - 1)],
                        sent).reshape(-1)

    stage = sample = block_pad[:0]
    if lay["stage_levels"]:
        lev = lay["stage_levels"]
        stage = every(log2 - lev, 2**lev - 1)
        stage = pad_to(stage, _codegen.stage_bytes(stage.dtype, num_blocks,
                                                   lev) // stage.itemsize)
    if lay["sample"]:
        win = lay["win_log2"]
        sample = every(win, 2 ** (log2 - win))
    return lay["stage_levels"], stage.copy(), sample.copy()


def kernel_source(index: NitroGenIndex, tree=None) -> str:
    """The CUDA source of the index's generated kernel; ``tree`` is its
    walked top (walked again from the keys when not given)."""
    if tree is None:
        tree = walk(index.keys.cpu().numpy(), index.levels, index.node_width,
                    index.block_width)
    return _codegen.generate(
        tree, dtype=numpy_dtype(index.keys.dtype), bottom=index.bottom,
        n=index.n, block_width=index.block_width,
        block_pad_width=index.block_pad_width,
        block_pad_len=int(index.block_pad.numel()), css_w=index.css_w,
        css_leaf_width=index.css_leaf_width, css_depth=index.css_depth,
        css_dir_len=index.css_dir_len, css_leaf_len=index.css_leaf_len,
        css_dirs_len=0 if index.css_dirs is None
        else int(index.css_dirs.numel()),
        css_offsets=tuple(index.css_offsets),
        stage_levels=index.stage_levels)


def _compiled(index: NitroGenIndex, tree) -> NitroGenIndex:
    """``index`` with its generated kernel, built and launched once here
    (on one query), so that neither the build nor the module's lazy load
    ever falls inside a search or a CUDA-graph capture."""
    index = dataclasses.replace(index, kernel=_codegen.compile_top(
        kernel_source(index, tree), index.keys.dtype))
    _launch(index, index.keys[:1], index.n)
    return index


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


def search_plain(index: NitroGenIndex, q: torch.Tensor,
                 clip: Optional[int] = None) -> torch.Tensor:
    """The generated kernel's plain version: the select network, then the
    bottom, then ``min(rank, n, clip)``; on the tensors' device."""
    b = index.network(q)                               # the top (constants)
    off = by_chunks(_bottom_width(index), lambda qq, bb: _BOTTOM_FNS[
        index.bottom](index, bb, qq), q, b)
    rank = b * index.block_width + off.clamp_max(index.block_width)
    rank = rank.clamp_max(index.n)
    return rank if clip is None else rank.clamp_max(clip)


def _launch(index: NitroGenIndex, q: torch.Tensor, clip: int):
    if index.kernel is None:
        raise RuntimeError("this NitroGen index has no compiled kernel: it "
                           f"was built on {index.keys.device}")
    return _codegen.nitrogen_search(index.kernel, q, index.block_pad,
                                    index.css_dirs, index.stage,
                                    index.sample, clip=clip)


def search(index: NitroGenIndex, queries, *,
           clip: Optional[int] = None) -> torch.Tensor:
    """searchsorted-left rank of each query, in [0, n]; int32 [Q]. With
    ``clip``, ``min(rank, clip)`` (the tiered top's last page). On the
    card one launch of the index's generated kernel; on the CPU the plain
    version."""
    q = as_queries(queries, index.keys)
    if q.device.type == "cpu":
        return search_plain(index, q, clip)
    return _launch(index, q, index.n if clip is None else clip)


def searcher(index: NitroGenIndex) -> Callable:
    """The 'compiled index' artifact: a closure over the built index; on
    the card over its generated kernel (the reference jits the network
    with its bottom)."""
    return lambda q: search(index, q)
