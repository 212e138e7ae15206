"""The part of the CUDA driver API that the generated kernels need, over
ctypes: load a cubin into a device's primary context (the one PyTorch
uses), find a kernel in it, size and launch the kernel on a stream,
unload the module once no index uses it.

A generated kernel (``kernels/nitrogen_codegen.py``) is built by nvcc as a
cubin, with no host code: that skips the host compile and the link of a
shared library, most of nvcc's time for so small a source. Every call
runs with the device's primary context current: when the calling thread
has another context current (another card's) or none (a store's
maintenance thread that has made no CUDA call yet), the primary context
is pushed for the call and popped after it, so the thread's context, and
with it PyTorch's current device, is as it was. Errors raise with the
driver's error name.
"""
from __future__ import annotations

import ctypes
import threading
from contextlib import contextmanager

_lock = threading.Lock()
_lib = None
_primary: dict[int, int] = {}        # device -> its primary context

_SIGNATURES = {
    "cuInit": [ctypes.c_uint],
    "cuDeviceGet": [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
    "cuCtxGetCurrent": [ctypes.POINTER(ctypes.c_void_p)],
    "cuCtxPushCurrent_v2": [ctypes.c_void_p],
    "cuCtxPopCurrent_v2": [ctypes.POINTER(ctypes.c_void_p)],
    "cuCtxSynchronize": [],
    "cuDevicePrimaryCtxRetain": [ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.c_int],
    "cuModuleLoadData": [ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p],
    "cuModuleGetFunction": [ctypes.POINTER(ctypes.c_void_p),
                            ctypes.c_void_p, ctypes.c_char_p],
    "cuModuleUnload": [ctypes.c_void_p],
    "cuFuncSetAttribute": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int],
    "cuOccupancyMaxActiveBlocksPerMultiprocessor": [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_size_t],
    "cuLaunchKernel": [ctypes.c_void_p] + [ctypes.c_uint] * 7
    + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p],
    "cuGetErrorName": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)],
}


def _cuda():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL("libcuda.so.1")
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _check(lib.cuInit(0), "cuInit", lib)
            _lib = lib
        return _lib


def _check(err: int, what: str, lib=None) -> None:
    if err:
        name = ctypes.c_char_p()
        (lib or _lib).cuGetErrorName(err, ctypes.byref(name))
        raise RuntimeError(f"{what} failed: "
                           f"{(name.value or b'?').decode()} ({err})")


def _primary_context(lib, device: int) -> int:
    ctx = _primary.get(device)
    if ctx is None:
        with _lock:
            ctx = _primary.get(device)
            if ctx is None:
                dev, c = ctypes.c_int(), ctypes.c_void_p()
                _check(lib.cuDeviceGet(ctypes.byref(dev), device),
                       "cuDeviceGet")
                _check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(c), dev),
                       "cuDevicePrimaryCtxRetain")
                ctx = _primary[device] = c.value
    return ctx


@contextmanager
def _on(lib, device: int):
    """The device's primary context current for the body; the thread's
    own context, if another, current again after it."""
    ctx = _primary_context(lib, device)
    cur = ctypes.c_void_p()
    _check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value == ctx:
        yield
        return
    _check(lib.cuCtxPushCurrent_v2(ctypes.c_void_p(ctx)), "cuCtxPushCurrent")
    try:
        yield
    finally:
        _check(lib.cuCtxPopCurrent_v2(ctypes.byref(cur)), "cuCtxPopCurrent")


def current_context() -> int | None:
    """The calling thread's current context (None when it has none)."""
    lib = _cuda()
    cur = ctypes.c_void_p()
    _check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    return cur.value


def load_function(image: bytes, device: int,
                  name: str) -> tuple[int, ctypes.c_void_p]:
    """Load a cubin into ``device``'s primary context: (the module, its
    kernel ``name``, an ``extern "C"`` name). The module stays loaded
    until ``unload``."""
    lib = _cuda()
    module, fn = ctypes.c_void_p(), ctypes.c_void_p()
    with _on(lib, device):
        _check(lib.cuModuleLoadData(ctypes.byref(module), image),
               "cuModuleLoadData")
        err = lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                      name.encode())
        if err:
            lib.cuModuleUnload(module)
        _check(err, f"cuModuleGetFunction({name})")
    return module.value, fn


def unload(modules: dict) -> None:
    """Unload ``modules`` ({device: module}) once the work queued on each
    device has ended: a launch of theirs may still be queued behind the
    search that made it."""
    lib = _lib or _cuda()
    for device, module in modules.items():
        with _on(lib, device):
            _check(lib.cuCtxSynchronize(), "cuCtxSynchronize")
            _check(lib.cuModuleUnload(ctypes.c_void_p(module)),
                   "cuModuleUnload")


# CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
_MAX_DYNAMIC_SHARED = 8


def allow_shared(fn: ctypes.c_void_p, device: int, nbytes: int) -> None:
    """Let ``fn`` launch with ``nbytes`` of dynamic shared memory (above 48
    KB a kernel has to ask)."""
    lib = _lib or _cuda()
    with _on(lib, device):
        _check(lib.cuFuncSetAttribute(fn, _MAX_DYNAMIC_SHARED, nbytes),
               "cuFuncSetAttribute")


def max_active_blocks(fn: ctypes.c_void_p, device: int, block: int,
                      shared: int) -> int:
    """Blocks of ``block`` threads and ``shared`` bytes of dynamic shared
    memory that one SM holds at once (registers counted too)."""
    lib = _lib or _cuda()
    n = ctypes.c_int()
    with _on(lib, device):
        _check(lib.cuOccupancyMaxActiveBlocksPerMultiprocessor(
            ctypes.byref(n), fn, block, shared),
            "cuOccupancyMaxActiveBlocksPerMultiprocessor")
    return n.value


def launch(fn: ctypes.c_void_p, device: int, grid: int, block: int,
           stream: int, args: list, shared: int = 0) -> None:
    """One launch of ``fn`` on ``stream`` (a ``cudaStream_t`` as an int),
    ``args`` the kernel's arguments as ctypes values, in order, with
    ``shared`` bytes of dynamic shared memory."""
    lib = _lib or _cuda()
    params = (ctypes.c_void_p * len(args))(
        *[ctypes.addressof(a) for a in args])
    with _on(lib, device):
        _check(lib.cuLaunchKernel(fn, grid, 1, 1, block, 1, 1, shared,
                                  stream, params, None), "cuLaunchKernel")
