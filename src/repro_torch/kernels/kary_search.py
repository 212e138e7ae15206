"""Batched k-ary descent, the tiered engine's top tier past 256 pages.

Replaces the Pallas TPU kernel ``repro/kernels/kary_search.py::
kary_search_tiled`` (``_kernel``, ``pallas_call`` at line 75) with the
hand-written CUDA kernel ``csrc/kary_search.cu``. Per query it descends
``depth`` levels of separator rows ``[n_l, wpad]``:
``j = j * fanout + #{s : level_l[j][s] < q}``, and returns j, the
searchsorted rank among the tree's keys (callers clip it).

Contract: every row is nondecreasing with a sentinel tail (DESIGN.md
§2.3), as ``ops.kary_levels`` lays out the sorted, linearized tree. On
such a row the count ``#{s : row[s] < q}`` equals the lower bound of q, so
the CUDA kernel finds it by a branch-free binary search (``log2(wpad) + 1``
reads a level instead of the TPU kernel's ``wpad`` compares); ranks stay
bit-identical to the count for duplicates, the sentinel, signed zeros and
NaN. The kernel runs persistent blocks that stage every top level fitting
200 KB of shared memory once (levels 0-1 at wpad 128, trees up to 16,384
pages) and search deeper levels in device memory. Its bound on the H100 is
set by bytes: the queries in and the ranks out.

The levels travel flattened into one contiguous tensor, level-major, with
the element offset of each level (``flatten_levels``). ``kary_search_plain``
is the same function in plain PyTorch, counting as the reference does; the
wrapper uses it for CPU tensors only, and for a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

_DTYPES = {torch.int32: "kary_search_i32", torch.float32: "kary_search_f32"}
MAX_DEPTH = 8                       # kMaxDepth in the source
_PLAIN_CHUNK = 1 << 16              # queries per gathered [chunk, wpad] block
_SMEM_LIMIT: dict[int, int] = {}    # device index -> smem_limit()


def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("kary_search"), _DTYPES[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def smem_limit(device: torch.device) -> int:
    """Bytes of levels the kernel may stage in shared memory on ``device``:
    the card's opt-in limit per block, capped at the kernel's budget."""
    idx = torch.cuda.current_device() if device.index is None \
        else device.index
    if idx not in _SMEM_LIMIT:
        fn = _build.load("kary_search").kary_search_smem_limit
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            _build.check(fn(ctypes.byref(out)), "kary_search_smem_limit")
        _SMEM_LIMIT[idx] = out.value
    return _SMEM_LIMIT[idx]


@functools.lru_cache(maxsize=64)
def _layout(offsets: tuple[int, ...], numel: int, wpad: int):
    """The kernel's host arrays for one flattened tree: (element offset,
    rows) of each level, checked to lie level-major from element 0."""
    offs = np.asarray(offsets, np.int64)
    sizes = np.diff(np.append(offs, numel))
    if offsets[0] != 0 or (sizes <= 0).any() or (sizes % wpad).any():
        raise ValueError("levels must lie level-major from element 0, each "
                         "a positive number of wpad-wide rows")
    return offs, (sizes // wpad).astype(np.int32)


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
    if wpad < 4 or wpad % 4:
        raise ValueError(f"wpad must be a positive multiple of 4, got {wpad}")
    for t in (queries, flat):
        if t.device != queries.device or not t.is_contiguous() \
                or t.dim() != 1:
            raise ValueError("queries and levels must be contiguous 1-D "
                             "tensors on one device")
    if flat.data_ptr() % 16:
        raise ValueError("levels must be 16-byte aligned (vector loads)")
    offs, rows = _layout(tuple(offsets), flat.numel(), wpad)
    limit = smem_limit(queries.device)
    # staged rows are padded: one entry in 32, one a row
    row_bytes = (wpad + wpad // 32 + 1) * flat.element_size()
    if row_bytes > limit:
        raise ValueError(f"a level-0 row of {row_bytes} bytes does not fit "
                         f"the kernel's {limit} bytes of shared memory")
    n_q = queries.shape[0]
    out = torch.empty((n_q,), dtype=torch.int32, device=queries.device)
    if n_q == 0:
        return out
    err = _fn(queries.dtype)(
        queries.data_ptr(), n_q, flat.data_ptr(),
        offs.ctypes.data, rows.ctypes.data, depth, fanout, wpad,
        out.data_ptr(), torch.cuda.current_stream(queries.device).cuda_stream)
    _build.check(err, "kary_search")
    kary_search_levels.launches += 1
    return out


kary_search_levels.launches = 0
