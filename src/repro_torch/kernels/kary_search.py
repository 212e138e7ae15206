"""Batched k-ary descent, the tiered engine's top tier past 256 pages.

Replaces the Pallas TPU kernel ``repro/kernels/kary_search.py::
kary_search_tiled`` (``_kernel``, ``pallas_call`` at line 75) with the
hand-written CUDA kernel ``csrc/kary_search.cu``. Per query it descends
``depth`` levels of separator rows ``[n_l, wpad]``:
``j = j * fanout + #{s : level_l[j][s] < q}``, and returns j, the
searchsorted rank among the tree's keys (callers clip it).

The TPU kernel fetched row j through an exact one-hot f32 matmul only to
use its matrix unit; the CUDA kernel loads the row directly, one thread a
query. Its bound on the H100 is set by bytes (queries, ranks and levels),
at one binary search a level; the kernel does ``depth * wpad`` compares a
query, and whether those or memory limit it was not measured.

The levels travel flattened into one contiguous tensor, level-major, with
the element offset of each level (``flatten_levels``). ``kary_search_plain``
is the same function in plain PyTorch; the wrapper uses it for CPU tensors
only, and for a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_DTYPES = {torch.int32: "kary_search_i32", torch.float32: "kary_search_f32"}
MAX_DEPTH = 8                       # kMaxDepth in the source
_PLAIN_CHUNK = 1 << 16              # queries per gathered [chunk, wpad] block


def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("kary_search"), _DTYPES[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flatten_levels(levels: list[torch.Tensor]
                   ) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Per-level [n_l, wpad] rows -> (one contiguous flat tensor, element
    offset of each level)."""
    offsets, off = [], 0
    for lvl in levels:
        offsets.append(off)
        off += lvl.numel()
    return torch.cat([lvl.reshape(-1) for lvl in levels]), tuple(offsets)


def kary_search_plain(queries: torch.Tensor, flat: torch.Tensor,
                      offsets: tuple[int, ...], *, fanout: int,
                      wpad: int) -> torch.Tensor:
    """Plain PyTorch version: gather row j of each level and count, in
    chunks of queries so the [chunk, wpad] gather stays bounded."""
    lanes = torch.arange(wpad, dtype=torch.int64, device=flat.device)
    out = torch.empty(queries.shape, dtype=torch.int32, device=flat.device)
    for s in range(0, queries.shape[0], _PLAIN_CHUNK):
        q = queries[s:s + _PLAIN_CHUNK]
        j = torch.zeros(q.shape, dtype=torch.int32, device=flat.device)
        for off in offsets:
            node = flat[off + j.long()[:, None] * wpad + lanes]
            j = j * fanout + (node < q[:, None]).sum(-1, dtype=torch.int32)
        out[s:s + _PLAIN_CHUNK] = j
    return out


def kary_search_levels(queries: torch.Tensor, flat: torch.Tensor,
                       offsets: tuple[int, ...], *, fanout: int,
                       wpad: int) -> torch.Tensor:
    """queries: [Q]; flat: the levels from ``flatten_levels``, in the
    queries' dtype. Returns the int32 rank [Q] of each query among the
    tree's keys."""
    if queries.device.type == "cpu":
        return kary_search_plain(queries, flat, offsets, fanout=fanout,
                                 wpad=wpad)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    if queries.dtype not in _DTYPES or flat.dtype != queries.dtype:
        raise TypeError("queries and levels must share dtype int32 or "
                        f"float32, got {queries.dtype} and {flat.dtype}")
    depth = len(offsets)
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must be in [1, {MAX_DEPTH}], got {depth}")
    if wpad % 4 or wpad * 4 > 48 * 1024:
        raise ValueError(f"wpad must be a multiple of 4 and fit 48 KB of "
                         f"shared memory, got {wpad}")
    for t in (queries, flat):
        if t.device != queries.device or not t.is_contiguous() \
                or t.dim() != 1:
            raise ValueError("queries and levels must be contiguous 1-D "
                             "tensors on one device")
    if flat.data_ptr() % 16:
        raise ValueError("levels must be 16-byte aligned (vector loads)")
    n_q = queries.shape[0]
    out = torch.empty((n_q,), dtype=torch.int32, device=queries.device)
    if n_q == 0:
        return out
    offs = np.asarray(offsets, np.int64)
    rows = (np.diff(np.append(offs, flat.numel())) // wpad).astype(np.int32)
    err = _fn(queries.dtype)(
        queries.data_ptr(), n_q, flat.data_ptr(),
        offs.ctypes.data, rows.ctypes.data, depth, fanout, wpad,
        out.data_ptr(), torch.cuda.current_stream(queries.device).cuda_stream)
    _build.check(err, "kary_search")
    kary_search_levels.launches += 1
    return out


kary_search_levels.launches = 0
