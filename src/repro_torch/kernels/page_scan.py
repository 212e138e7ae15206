"""Endpoint-masked leaf-page scan and single-ended page prefix, the range
scan's bottom tier (DESIGN.md §8).

Replaces the Pallas TPU kernels of ``repro/kernels/page_scan.py`` with the
hand-written CUDA kernels of ``csrc/page_scan.cu``:

* ``page_scan_bucketed`` (``_kernel_count`` / ``_kernel_values``,
  ``pallas_call`` at line 155): grid step g serves the TQ scan items of
  ``lo_b[g]`` / ``hi_b[g]``, which all target leaf page ``page_ids[g]``;
  per lane the below-lo count ``lt``, the at-most-hi count ``le`` and, per
  the static ``mode``, the sum / min / max of the values in range;
* ``page_prefix_bucketed`` (``_kernel_prefix_count`` /
  ``_kernel_prefix_sum``, ``pallas_call`` at line 230): per lane the count
  of keys below one edge and, with values, their sum.

Every page is nondecreasing with a sentinel tail (DESIGN.md §2.3), so
both kernels replace the TPU kernels' counts (every lane against all
``lw_pad`` slots) by branch-free binary searches over the page staged in
shared memory, bit-identical to the counts: ``#{k < lo}`` is the lower
bound of lo, ``#{k <= hi}`` the upper bound of hi. Persistent blocks walk
contiguous runs of the page-sorted steps and restage a page only when it
changes. In the scan's value modes the in-range slots are the run
``[lt, max(lt, le))``; once a page the block builds a segment tree of
group sums and, in full mode, sparse tables of group minima and maxima,
so a lane reads O(log) entries plus at most 7 edge slots at each end, and
a float sum adds only in-range values (never a difference of prefixes).
Min and max propagate NaN and rank -0.0 below +0.0 as ``jnp.min`` /
``jnp.max`` do (``minimum``, ``maximum``, ``amin``, ``amax`` here give
the plain version and the engine's combines the same). In sum mode
the prefix kernel scans the page's (masked) group sums once and reads
each lane's sum at its lower bound. Both are bound on the H100 by the
bytes of the lanes and the touched pages. Design and arithmetic notes
(uint32 accumulation for the int32 wrap, double for float sums, the early
exit past ``steps_used``) are in the source and ``csrc/sorted_page.cuh``.

``page_scan_plain`` and ``page_prefix_plain`` are the same functions in
plain PyTorch. The wrappers use them for CPU tensors only; for a CUDA
tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.util import numpy_dtype
from . import _build

MODES = ("count", "sum", "full")
_N_OUT = {"count": 2, "sum": 3, "full": 5}
_VALUE_DTYPES = (torch.int32, torch.float32)
_PLAIN_CHUNK_ELEMS = 1 << 24       # bound on one [steps, TQ, lw_pad] compare


def agg_identities(val_dtype):
    """(min-identity, max-identity) for masked reductions over ``val_dtype``:
    the values empty scans report (count 0 ⇒ min is the dtype's max)."""
    vd = np.dtype(val_dtype)
    if np.issubdtype(vd, np.floating):
        return vd.type(np.inf), vd.type(-np.inf)
    info = np.iinfo(vd)
    return vd.type(info.max), vd.type(info.min)


# jnp.min / jnp.minimum rank -0.0 below +0.0 in either order (and jnp.max
# +0.0 above -0.0); torch.amin / torch.minimum return whichever zero the
# order gives. These four give the reference's bits: NaN propagates, a
# zero result takes the sign the reference gives it, integers are as is.
def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.minimum`` with ``jnp.minimum``'s signed zeros."""
    m = torch.minimum(a, b)
    if not m.is_floating_point():
        return m
    return torch.where((m == 0) & (a.signbit() | b.signbit()), -0.0, m)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.maximum`` with ``jnp.maximum``'s signed zeros."""
    m = torch.maximum(a, b)
    if not m.is_floating_point():
        return m
    return torch.where((m == 0) & ~(a.signbit() & b.signbit()), 0.0, m)


def amin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.amin(dim)`` with ``jnp.min``'s signed zeros: a zero minimum
    (every entry >= 0, none NaN) is -0.0 if any entry is -0.0."""
    m = x.amin(dim)
    if not m.is_floating_point():
        return m
    return torch.where((m == 0) & x.signbit().any(dim), -0.0, m)


def amax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.amax(dim)`` with ``jnp.max``'s signed zeros: a zero maximum
    (every entry <= 0, none NaN) is +0.0 unless every entry is -0.0."""
    m = x.amax(dim)
    if not m.is_floating_point():
        return m
    return torch.where((m == 0) & ~x.signbit().all(dim), 0.0, m)


def _mask_scalar(mask_value, dtype: torch.dtype):
    """The mask as a Python scalar of the value dtype's range (the
    reference casts it with ``vd.type``)."""
    return numpy_dtype(dtype).type(mask_value).item()


def _mask_bits(mask_value, dtype: torch.dtype) -> int:
    """The mask's 32 bits as a signed int, as the C entry points take it."""
    return int(np.array(mask_value, numpy_dtype(dtype)).view(np.int32))


# ------------------------------------------------------------ plain versions
def page_scan_plain(lo_b: torch.Tensor, hi_b: torch.Tensor,
                    page_ids: torch.Tensor, kpages: torch.Tensor,
                    vpages: torch.Tensor | None = None, *,
                    mode: str = "full", mask_value=None) -> tuple:
    """Plain PyTorch version of the scan kernel over every step, chunked
    over grid steps so the [steps, TQ, lw_pad] compare stays bounded."""
    if mode not in MODES:
        raise ValueError(f"unknown scan mode {mode!r}; want one of {MODES}")
    G, TQ = lo_b.shape
    lw_pad = kpages.shape[1]
    dev = kpages.device
    outs = [torch.empty((G, TQ), dtype=torch.int32, device=dev)
            for _ in range(2)]
    if mode != "count":
        vd = vpages.dtype
        outs += [torch.empty((G, TQ), dtype=vd, device=dev)
                 for _ in range(_N_OUT[mode] - 2)]
        id_min, id_max = (x.item() for x in agg_identities(numpy_dtype(vd)))
        mask = None if mask_value is None else _mask_scalar(mask_value, vd)
    step = max(1, _PLAIN_CHUNK_ELEMS // (TQ * lw_pad))
    for s in range(0, G, step):
        pid = page_ids[s:s + step].long()
        k = kpages[pid][:, None, :]                          # [c, 1, lw_pad]
        below = k < lo_b[s:s + step, :, None]
        le = k <= hi_b[s:s + step, :, None]
        outs[0][s:s + step] = below.sum(-1, dtype=torch.int32)
        outs[1][s:s + step] = le.sum(-1, dtype=torch.int32)
        if mode == "count":
            continue
        v = vpages[pid][:, None, :]
        m = ~below & le
        if mask is not None:
            m = m & (v != mask)
        outs[2][s:s + step] = torch.where(m, v, 0).sum(-1, dtype=vd)
        if mode == "full":
            outs[3][s:s + step] = amin(torch.where(m, v, id_min), -1)
            outs[4][s:s + step] = amax(torch.where(m, v, id_max), -1)
    return tuple(outs)


def page_prefix_plain(e_b: torch.Tensor, page_ids: torch.Tensor,
                      kpages: torch.Tensor,
                      vpages: torch.Tensor | None = None, *,
                      mask_value=None):
    """Plain PyTorch version of the prefix kernel over every step."""
    G, TQ = e_b.shape
    lw_pad = kpages.shape[1]
    dev = kpages.device
    lt = torch.empty((G, TQ), dtype=torch.int32, device=dev)
    psum = None
    if vpages is not None:
        psum = torch.empty((G, TQ), dtype=vpages.dtype, device=dev)
        mask = None if mask_value is None \
            else _mask_scalar(mask_value, vpages.dtype)
    step = max(1, _PLAIN_CHUNK_ELEMS // (TQ * lw_pad))
    for s in range(0, G, step):
        pid = page_ids[s:s + step].long()
        blw = kpages[pid][:, None, :] < e_b[s:s + step, :, None]
        lt[s:s + step] = blw.sum(-1, dtype=torch.int32)
        if vpages is None:
            continue
        v = vpages[pid][:, None, :]
        m = blw if mask is None else blw & (v != mask)
        psum[s:s + step] = torch.where(m, v, 0).sum(-1, dtype=v.dtype)
    return lt if vpages is None else (lt, psum)


# ------------------------------------------------------------------ kernels
def _fn(name: str):
    fn = getattr(_build.load("page_scan"), name)
    if fn.argtypes is None:
        n_ptr = 11 if name == "page_scan" else 7
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * n_ptr \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_operands(what: str, lanes: list, page_ids, kpages, vpages,
                    steps_used) -> None:
    """Device, dtype, shape and contiguity checks shared by both wrappers."""
    G, TQ = lanes[0].shape
    if lanes[0].device.type != "cuda":
        raise ValueError(f"unsupported device {lanes[0].device}")
    if kpages.dtype not in _VALUE_DTYPES or any(
            t.dtype != kpages.dtype or t.shape != (G, TQ) for t in lanes):
        raise TypeError(f"{what}: bounds and key pages must share dtype int32"
                        f" or float32 and shape [G, TQ], got "
                        f"{[(t.dtype, tuple(t.shape)) for t in lanes]} and "
                        f"{kpages.dtype}")
    if page_ids.dtype != torch.int32 or page_ids.shape != (G,):
        raise TypeError(f"page_ids must be int32 [{G}]")
    if not 1 <= TQ <= 1024:
        raise ValueError(f"TQ must be in [1, 1024] (one thread a lane), "
                         f"got {TQ}")
    tensors = [*lanes, page_ids, kpages]
    if vpages is not None:
        if vpages.dtype not in _VALUE_DTYPES \
                or vpages.shape != kpages.shape:
            raise TypeError(f"{what}: value pages must be int32 or float32 "
                            f"{tuple(kpages.shape)}, got {vpages.dtype} "
                            f"{tuple(vpages.shape)}")
        tensors.append(vpages)
    if steps_used is not None:
        if steps_used.dtype != torch.int32 or steps_used.numel() != 1:
            raise TypeError("steps_used must be a one-element int32 tensor")
        tensors.append(steps_used)
    for t in tensors:
        if t.device != kpages.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def page_scan_bucketed(lo_b: torch.Tensor, hi_b: torch.Tensor,
                       page_ids: torch.Tensor, kpages: torch.Tensor,
                       vpages: torch.Tensor | None = None, *,
                       mode: str = "full", mask_value=None,
                       steps_used: torch.Tensor | None = None) -> tuple:
    """lo_b, hi_b: [G, TQ] per-lane inclusive bounds; step g's lanes all
    scan page ``page_ids[g]`` of ``kpages`` [num_pages, lw_pad]
    (sentinel-padded) and, in the value modes, the aligned ``vpages``.

      "count"  ->  (lt, le)                       int32 [G, TQ] each
      "sum"    ->  (lt, le, vsum)
      "full"   ->  (lt, le, vsum, vmin, vmax)

    ``lt = #{k < lo}``, ``le = #{k <= hi}``; vsum / vmin / vmax reduce the
    values with ``lo <= k <= hi`` (int32 sums wrap; an empty mask reports
    0 and ``agg_identities``). ``mask_value`` (value modes) also drops
    slots whose value equals it from the value aggregates (the mutable
    store's tombstone); counts stay physical. Count mode never reads the
    value pages. ``steps_used`` (a 0-d int32 device tensor) is the device
    plan's step count: later steps are not computed and their lanes hold
    no defined value. ``None`` computes every step.

    Every page must be nondecreasing (sentinel-padded, DESIGN.md §2.3):
    the CUDA kernel takes ``lt`` and ``le`` as binary searches' bounds and
    the mask as the run of slots between them, which equal the counts and
    the mask only on sorted pages. Float sums are taken in double over
    the in-range slots and agree with the plain version to rounding (rtol
    1e-4); min and max are NaN where a NaN value is in range."""
    if mode not in MODES:
        raise ValueError(f"unknown scan mode {mode!r}; want one of {MODES}")
    if mode != "count" and vpages is None:
        raise ValueError(f"scan mode {mode!r} needs value pages")
    vp = vpages if mode != "count" else None
    if vp is None:
        mask_value = None                # counts stay physical
    if lo_b.device.type == "cpu":
        return page_scan_plain(lo_b, hi_b, page_ids, kpages, vp, mode=mode,
                               mask_value=mask_value)
    _check_operands("page_scan", [lo_b, hi_b], page_ids, kpages, vp,
                    steps_used)
    G, TQ = lo_b.shape
    dev = kpages.device
    outs = [torch.empty((G, TQ), dtype=torch.int32, device=dev)
            for _ in range(2)]
    if vp is not None:
        outs += [torch.empty((G, TQ), dtype=vp.dtype, device=dev)
                 for _ in range(_N_OUT[mode] - 2)]
    if G == 0:
        return tuple(outs)
    ptrs = [_ptr(t) for t in outs] + [None] * (5 - len(outs))
    err = _fn("page_scan")(
        int(kpages.dtype == torch.float32),
        int(vp is not None and vp.dtype == torch.float32),
        MODES.index(mode), int(mask_value is not None),
        0 if mask_value is None else _mask_bits(mask_value, vp.dtype),
        lo_b.data_ptr(), hi_b.data_ptr(), page_ids.data_ptr(),
        kpages.data_ptr(), _ptr(vp), _ptr(steps_used), *ptrs,
        G, TQ, kpages.shape[1], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "page_scan")
    page_scan_bucketed.launches += 1
    page_scan_bucketed.mode_launches[mode] += 1
    return tuple(outs)


page_scan_bucketed.launches = 0
page_scan_bucketed.mode_launches = dict.fromkeys(MODES, 0)


def page_prefix_bucketed(e_b: torch.Tensor, page_ids: torch.Tensor,
                         kpages: torch.Tensor,
                         vpages: torch.Tensor | None = None, *,
                         mask_value=None,
                         steps_used: torch.Tensor | None = None):
    """e_b: [G, TQ] per-lane edges; step g's lanes all reduce page
    ``page_ids[g]`` to ``lt = #{k < e}`` (int32 [G, TQ]) and, with
    ``vpages``, ``psum`` = the sum of the values with ``k < e`` (less those
    equal to ``mask_value``). Returns ``lt``, or ``(lt, psum)`` with
    values. ``steps_used`` as for :func:`page_scan_bucketed`.

    Every page must be nondecreasing (sentinel-padded, DESIGN.md §2.3):
    the CUDA kernel takes ``lt`` as a binary search's lower bound, which
    equals the count only on sorted pages. Int32 sums wrap bit-exactly;
    float sums are taken in double in the kernel's scan order and agree
    with the plain version to rounding (rtol 1e-4)."""
    if vpages is None:
        mask_value = None                # lt stays physical
    if e_b.device.type == "cpu":
        return page_prefix_plain(e_b, page_ids, kpages, vpages,
                                 mask_value=mask_value)
    _check_operands("page_prefix", [e_b], page_ids, kpages, vpages,
                    steps_used)
    G, TQ = e_b.shape
    dev = kpages.device
    lt = torch.empty((G, TQ), dtype=torch.int32, device=dev)
    psum = None if vpages is None else torch.empty((G, TQ), dtype=vpages.dtype,
                                                   device=dev)
    if G == 0:
        return lt if psum is None else (lt, psum)
    err = _fn("page_prefix")(
        int(kpages.dtype == torch.float32),
        int(vpages is not None and vpages.dtype == torch.float32),
        int(vpages is not None), int(mask_value is not None),
        0 if mask_value is None else _mask_bits(mask_value, vpages.dtype),
        e_b.data_ptr(), page_ids.data_ptr(), kpages.data_ptr(),
        _ptr(vpages), _ptr(steps_used), lt.data_ptr(), _ptr(psum),
        G, TQ, kpages.shape[1], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "page_prefix")
    page_prefix_bucketed.launches += 1
    page_prefix_bucketed.mode_launches[
        "count" if vpages is None else "sum"] += 1
    return lt if psum is None else (lt, psum)


page_prefix_bucketed.launches = 0
page_prefix_bucketed.mode_launches = {"count": 0, "sum": 0}
