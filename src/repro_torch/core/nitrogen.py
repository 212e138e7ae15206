"""NitroGen — index compilation (thesis Ch. 4), PyTorch port of
``repro/core/nitrogen.py`` with the ``vector`` bottom only.

The thesis generates code in which the *top levels of the index are
literal constants in the instruction stream*. Here, as in the reference,
``_gen_network`` builds in Python a branch-free select network whose
separator keys are Python scalars: each comparison is ``q <= sep`` against a
scalar operand, so there is no separator tensor and no gather. A float32
query compared with a Python float stays a float32 compare (the separators
come from float32 keys, so they convert back exactly).

The reference's jit folds the network into one executable; in eager
PyTorch it is one ``torch.where`` launch per separator (63 for the tiered
top's 256 pages). The ``binary`` and ``css`` bottoms come with ROADMAP
Queue 1 item 12 (the other index kinds).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .util import as_sorted_numpy, pad_to, resolve_device, take

BOTTOMS = ("vector",)


@dataclass(frozen=True)
class NitroGenIndex:
    keys: torch.Tensor           # [n] sorted data array
    block_pad: torch.Tensor      # [num_blocks * block_pad_width] bottom storage
    n: int
    levels: int                  # compiled levels
    node_width: int              # separators per compiled node
    num_blocks: int
    block_width: int             # keys per bottom block
    block_pad_width: int
    bottom: str                  # 'vector'
    network: Callable            # q[batch] -> block id  (the compiled top)

    @property
    def fanout(self) -> int:
        return self.node_width + 1


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


def build(keys, levels: int = 3, node_width: int = 3, bottom: str = "vector",
          *, device=None) -> NitroGenIndex:
    if bottom not in BOTTOMS:
        raise NotImplementedError(
            f"nitrogen bottom {bottom!r} is not ported yet; it comes with "
            "ROADMAP Queue 1 item 12 (the other index kinds)")
    device = resolve_device(device)
    srt = as_sorted_numpy(keys)
    f = node_width + 1
    num_blocks = f**levels
    block_width = -(-srt.size // num_blocks)
    block_pad = np.stack([
        pad_to(srt[b * block_width: (b + 1) * block_width], block_width)
        for b in range(num_blocks)
    ]).reshape(-1)
    return NitroGenIndex(
        keys=torch.from_numpy(srt).to(device),
        block_pad=torch.from_numpy(block_pad).to(device),
        n=int(srt.size), levels=int(levels), node_width=int(node_width),
        num_blocks=int(num_blocks), block_width=int(block_width),
        block_pad_width=int(block_width), bottom=bottom,
        network=_gen_network(srt, levels, node_width, block_width),
    )


def _bottom_vector(block_pad, b, q, bw_pad):
    base = b * bw_pad
    lanes = torch.arange(bw_pad, dtype=torch.int32, device=q.device)
    blk = take(block_pad, base[..., None] + lanes)
    return (blk < q[..., None]).sum(-1, dtype=torch.int32)


def search(index: NitroGenIndex, queries: torch.Tensor) -> torch.Tensor:
    q = queries
    b = index.network(q)                               # compiled top (constants)
    off = _bottom_vector(index.block_pad, b, q, index.block_pad_width)
    rank = b * index.block_width + off.clamp_max(index.block_width)
    return rank.clamp_max(index.n)
