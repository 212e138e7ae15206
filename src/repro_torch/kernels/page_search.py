"""Leaf-page search, the tiered engine's bottom tier.

Replaces the Pallas TPU kernel ``repro/kernels/page_search.py::
page_search_bucketed`` (``_kernel``, ``pallas_call`` at line 59) with the
hand-written CUDA kernel ``csrc/page_search.cu``. Grid step g serves the TQ
queries of ``queries_bucketed[g]``, which all live in leaf page
``page_ids[g]``; each lane returns
``page_ids[g] * stride + min(#{s : page[s] < q}, stride)``.

Every page is nondecreasing with a sentinel tail (DESIGN.md §2.3), so the
count is the lower bound of the query: the kernel finds it by a
branch-free binary search over the page staged in shared memory,
bit-identical to the TPU kernel's count. Persistent blocks walk contiguous
runs of the page-sorted steps and restage a page only when it changes;
pages wider than one staged chunk are searched chunk by chunk. Its bound
on the H100 is set by bytes: the lanes in and out and the touched page
rows. The design and the reasons for it are in the source and in
``csrc/sorted_page.cuh``, which the page-prefix kernel shares.

``page_search_plain`` is the same function in plain PyTorch. The wrapper
uses it for CPU tensors only; for a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.int32: "page_search_i32", torch.float32: "page_search_f32"}
_PLAIN_CHUNK_ELEMS = 1 << 24       # bound on one [steps, TQ, lw_pad] compare


def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("page_search"), _DTYPES[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def page_search_plain(queries_bucketed: torch.Tensor, page_ids: torch.Tensor,
                      pages: torch.Tensor, *, stride: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel over every step, chunked over
    grid steps so the [steps, TQ, lw_pad] compare stays bounded."""
    G, TQ = queries_bucketed.shape
    lw_pad = pages.shape[1]
    out = torch.empty((G, TQ), dtype=torch.int32, device=pages.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // (TQ * lw_pad))
    for s in range(0, G, step):
        pid = page_ids[s:s + step]
        rows = pages[pid.long()]                             # [c, lw_pad]
        cnt = (rows[:, None, :] < queries_bucketed[s:s + step, :, None]
               ).sum(-1, dtype=torch.int32)
        out[s:s + step] = pid[:, None] * stride + cnt.clamp_max(stride)
    return out


def page_search_bucketed(queries_bucketed: torch.Tensor,
                         page_ids: torch.Tensor, pages: torch.Tensor, *,
                         stride: int,
                         steps_used: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """queries_bucketed: [G, TQ]; page_ids: [G] int32; pages:
    [num_pages, lw_pad] sentinel-padded leaves in the queries' dtype.
    Returns ``page_ids[g] * stride + in-page count`` per lane, [G, TQ].

    ``steps_used`` (a 0-d int32 tensor on the device) is the device plan's
    step count: steps at or past it are not computed and their lanes hold
    no defined value; callers read only lanes of earlier steps. ``None``
    computes every step. ``stride`` is ``leaf_width`` for global ranks and
    ``lw_pad`` for slot addresses, as in the reference."""
    if queries_bucketed.device.type == "cpu":
        return page_search_plain(queries_bucketed, page_ids, pages,
                                 stride=stride)
    G, TQ = queries_bucketed.shape
    lw_pad = pages.shape[1]
    if queries_bucketed.device.type != "cuda":
        raise ValueError(f"unsupported device {queries_bucketed.device}")
    if queries_bucketed.dtype not in _DTYPES \
            or pages.dtype != queries_bucketed.dtype:
        raise TypeError("queries and pages must share dtype int32 or float32,"
                        f" got {queries_bucketed.dtype} and {pages.dtype}")
    if page_ids.dtype != torch.int32 or page_ids.shape != (G,):
        raise TypeError(f"page_ids must be int32 [{G}]")
    if not 1 <= TQ <= 1024:
        raise ValueError(f"TQ must be in [1, 1024] (one thread a lane), got {TQ}")
    tensors = [queries_bucketed, page_ids, pages]
    if steps_used is not None:
        if steps_used.dtype != torch.int32 or steps_used.numel() != 1:
            raise TypeError("steps_used must be a one-element int32 tensor")
        tensors.append(steps_used)
    for t in tensors:
        if t.device != pages.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
    out = torch.empty((G, TQ), dtype=torch.int32, device=pages.device)
    if G == 0:
        return out
    err = _fn(pages.dtype)(
        queries_bucketed.data_ptr(), page_ids.data_ptr(), pages.data_ptr(),
        None if steps_used is None else steps_used.data_ptr(),
        out.data_ptr(), G, TQ, lw_pad, int(stride),
        torch.cuda.current_stream(pages.device).cuda_stream)
    _build.check(err, "page_search")
    page_search_bucketed.launches += 1
    return out


page_search_bucketed.launches = 0
