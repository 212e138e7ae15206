"""Batched CDF inversion for nucleus (top-p) sampling.

Replaces the Pallas TPU kernel ``repro/kernels/cdf_search.py::cdf_search``
(``_kernel``, ``pallas_call`` at line 47) with the hand-written CUDA kernel
``csrc/cdf_search.cu``. Every sampled decode step inverts each row's
sorted-probability CDF: for row b, the first index v with
``cdf[b, v] >= u[b]``, computed as the count ``|{v : cdf[b, v] < u[b]}|``
and clipped to V - 1.

Its bound on the H100 is set by bytes: B * V * 4 bytes of cdf read once.
The kernel reads each entry once: one launch a call, one thread-block
cluster of 8 blocks a row, each block counting a slice with several
16-byte loads in flight a thread, the blocks' counts added by rank 0
through distributed shared memory, which clips and stores the row; no
atomics, no zero fill, no clamp after. The design is in the source.

``invert_cdf`` is the same function in plain PyTorch. ``cdf_search`` uses
it for CPU tensors only; for a CUDA tensor it launches the kernel or
raises.

Decode-step micro-batching (DESIGN.md §7.1): one request's decode step is
a B=1 inversion, a near-empty launch. :func:`cdf_probe_fn` adapts the
inversion to the micro-batch queue's ``search_fn`` contract over
``(cdf, u)`` submissions, so the decode steps of concurrent requests
flush as one launch.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

from . import _build


def _fn():
    fn = _build.load("cdf_search").cdf_search_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def invert_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`cdf_search`: ``sum(cdf < u)`` per row as
    int32, clipped to V - 1."""
    idx = (cdf < u[:, None]).sum(-1, dtype=torch.int32)
    return idx.clamp_max(cdf.shape[-1] - 1)


def cdf_search(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """cdf: [B, V] float32, row-wise nondecreasing (a tail padded with
    +inf is allowed); u: [B] float32. Returns [B] int32: the first index
    with cdf >= u, clipped to V - 1 (the count of entries below u, as
    the reference counts, on any row)."""
    if cdf.device.type == "cpu":
        return invert_cdf(cdf, u)
    if cdf.device.type != "cuda":
        raise ValueError(f"unsupported device {cdf.device}")
    if cdf.dim() != 2 or u.shape != cdf.shape[:1]:
        raise ValueError(f"want cdf [B, V] and u [B], got {tuple(cdf.shape)} "
                         f"and {tuple(u.shape)}")
    if cdf.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"cdf and u must be float32, got {cdf.dtype} and "
                        f"{u.dtype}")
    for t in (cdf, u):
        if t.device != cdf.device or not t.is_contiguous():
            raise ValueError("cdf and u must be contiguous on one device")
    B, V = cdf.shape
    if V < 1:
        raise ValueError("the vocabulary must hold at least one entry")
    out = torch.empty(B, dtype=torch.int32, device=cdf.device)
    if B == 0:
        return out
    vec = int(V % 4 == 0 and cdf.data_ptr() % 16 == 0)
    err = _fn()(cdf.data_ptr(), u.data_ptr(), out.data_ptr(), B, V, vec,
                torch.cuda.current_stream(cdf.device).cuda_stream)
    _build.check(err, "cdf_search")
    cdf_search.launches += 1
    return out


cdf_search.launches = 0


def cdf_probe_fn() -> Callable:
    """Adapt CDF inversion to the micro-batch queue's ``search_fn``
    contract (``engine.queue.MicroBatchQueue``), the decode-step twin of
    ``engine.queue.index_probe_fn``.

    Submissions are ``(cdf [b, V], u [b])`` tensors on one device; the
    queue joins them along the batch axis (one engine, one vocabulary)
    and pads with zero rows, whose inversion lands on index 0 and is never
    read back through any caller's slice. The probe is one
    :func:`cdf_search` over the flushed batch: one kernel launch on the
    card, ``invert_cdf`` on the CPU.

    Occupancy feedback: the inversion has no bucket schedule, so the
    probe reports 1.0 and the queue scales it by real/dispatched rows,
    making the feedback exactly the pad waste."""

    def probe(batch):
        cdf, u = batch
        if cdf.shape[0] == 0:
            return torch.zeros(0, dtype=torch.int32, device=cdf.device), None
        return cdf_search(cdf, u), (lambda: 1.0)

    return probe
