"""Sorted-array binary search (thesis Alg 2.1, with the linear-search cutoff
refinement from §5.1) — PyTorch port of ``repro/core/sorted_array.py``.

The search is the branch-free fixed-trip-count lower_bound: the array is
padded to a power of two with sentinels, and ``log2(n_pad)`` halving steps
run unconditionally over the whole batch (the thesis' early exit on
equality becomes the final equality check of ``Index.lookup``).

With ``linear_cutoff=c`` the last ``log2(c)`` halving steps are replaced by
one vectorised compare over the remaining block of ``c`` keys — the thesis'
"switch to linear search below a threshold", tuned for a vector unit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .util import (as_queries, as_sorted_numpy, by_chunks, next_pow, pad_to,
                   resolve_device, take, upload_async)


@dataclass(frozen=True)
class SortedArrayIndex:
    keys: torch.Tensor         # [n] sorted, original (unpadded)
    keys_pad: torch.Tensor     # [n_pad] padded to power of two
    n: int
    n_pad: int
    linear_cutoff: int = 1     # 1 => pure binary; >1 => vectorised tail scan
    tree_bytes: int = 0        # extra index storage beyond data


def build(keys, linear_cutoff: int = 1, *, device=None) -> SortedArrayIndex:
    device = resolve_device(device)
    srt = as_sorted_numpy(keys)
    # pad to a power of two with AT LEAST one sentinel slot: the uniform
    # lower_bound returns at most n_pad-1, so rank == n must hit a sentinel
    levels = next_pow(2, srt.size + 1)
    n_pad = max(1 << levels, max(linear_cutoff, 1))
    return SortedArrayIndex(
        keys=upload_async(srt, device),
        keys_pad=upload_async(pad_to(srt, n_pad), device),
        n=int(srt.size), n_pad=int(n_pad),
        linear_cutoff=int(max(linear_cutoff, 1)),
    )


def _search_pad(keys_pad: torch.Tensor, q: torch.Tensor, n_pad: int,
                cutoff: int) -> torch.Tensor:
    """Branch-free lower_bound over the padded array. Returns the rank in
    [0, n_pad] == number of keys < q."""
    pos = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    step = n_pad // 2
    while step >= max(cutoff, 1):
        # probe the key just left of the midpoint of the remaining range
        probe = take(keys_pad, pos + (step - 1))
        pos = torch.where(probe < q, pos + step, pos)
        step //= 2
    if cutoff > 1:
        # vectorised "linear search" over the final block of `cutoff` keys
        offs = pos[:, None] + torch.arange(cutoff, dtype=torch.int32,
                                           device=q.device)
        blk = take(keys_pad, offs)
        pos = pos + (blk < q[:, None]).sum(-1, dtype=torch.int32)
    return pos


def search(index: SortedArrayIndex, queries) -> torch.Tensor:
    """searchsorted-left rank of each query, in [0, n]; int32 [Q]."""
    q = as_queries(queries, index.keys)
    cutoff = index.linear_cutoff
    rank = by_chunks(cutoff, lambda qq: _search_pad(
        index.keys_pad, qq, index.n_pad, cutoff), q)
    return rank.clamp_max(index.n)


def reference_rank(keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Oracle: numpy searchsorted-left over the unpadded sorted keys."""
    return np.searchsorted(np.asarray(keys), np.asarray(queries),
                           side="left").astype(np.int32)
