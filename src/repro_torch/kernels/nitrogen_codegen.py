"""NitroGen's compilation step on the card: one generated CUDA kernel an
index, with the separators of its compiled top as immediates.

The thesis compiles the top levels of an index into code (Ch. 4); the
reference does it by making every separator a Python scalar, which XLA
folds into its executable as a literal, and jitting the network with its
data-resident bottom (``repro/core/nitrogen.py``, ``searcher``). This
module is the port's twin of that executable. It replaces no
``pallas_call``.

``generate`` writes a CUDA C++ source from the top's tree
(``core.nitrogen.walk``, the reference's recursion, which the plain
network evaluates too): ``ng_network(q)`` keeps the reference's select at
every node, ``out = last kid; for i from w-1 down to 0: out = (q <= sep_i)
? kid_i : out``, branch-free, every separator compared, each one a literal
(an int by value, ``INT32_MIN`` as ``(-2147483647 - 1)``, a float by its
bits). The literals appear in the source in the order in which the
reference's trace compares them. The bottoms, the rank and the kernel are
``csrc/nitrogen_template.cuh``, specialized by the constants ``generate``
defines. ``compile_top`` builds the source with nvcc into a cubin
(``_build.build_generated``: cached by a hash of the text, the headers and
the flags, on disk and in the process), which ``kernels/_driver.py``
loads into the device's context; the module is unloaded once no index
holds the kernel. ``nitrogen_search`` launches it through
the driver on the current stream: one launch answers a search, top and
bottom together.

What bounds it on the H100 (``chip_smoke.py`` phase 21 computes it for
each index): the larger of the bytes (each query read, each rank written,
the block rows a query's bottom reads) over 3.35 TB/s and the compares a
search needs (a binary search of a node's separators at each level of the
top, then of the bottom's rows; the select itself compares every
separator) over 33.5e12 a second.
"""
from __future__ import annotations

import ctypes
import re
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import torch

from . import _build, _driver

STEM = "nitrogen"
TEMPLATE = "nitrogen_template.cuh"
KERNEL = "ng_search_kernel"
THREADS = 256                    # threads a block, one a query
BOTTOM_IDS = {"binary": "NG_BOTTOM_BINARY", "vector": "NG_BOTTOM_VECTOR",
              "css": "NG_BOTTOM_CSS"}
# the key dtypes the kernel takes: C type, and how a separator is written
_KEY_TYPES = {np.dtype(np.int32): "int", np.dtype(np.int64): "long long",
              np.dtype(np.float32): "float", np.dtype(np.float64): "double"}
_LITERAL = re.compile(r"q <= (\(-\d+ - 1\)|-?\d+(?:LL)?|"
                      r"ng_f(?:32|64)\(0x[0-9a-f]+u(?:ll)?\))\)")


def literal(sep, dtype: np.dtype) -> str:
    """A separator as a C literal of the key type, exact in every bit."""
    if dtype == np.int32:
        v = int(sep)
        return "(-2147483647 - 1)" if v == -2**31 else str(v)
    if dtype == np.int64:
        v = int(sep)
        return "(-9223372036854775807LL - 1)" if v == -2**63 else f"{v}LL"
    if dtype == np.float32:
        return f"ng_f32(0x{int(np.float32(sep).view(np.uint32)):08x}u)"
    return f"ng_f64(0x{int(np.float64(sep).view(np.uint64)):016x}ull)"


def read_literals(source: str, dtype) -> np.ndarray:
    """The separators a generated source compares, in source order, as
    an array of the key dtype (their bits, for the floats)."""
    dtype = np.dtype(dtype)
    vals = []
    for lit in _LITERAL.findall(source):
        if lit.startswith("ng_f"):                 # a float by its bits
            vals.append(int(lit[lit.index("0x"):].rstrip("ul)"), 16))
        elif lit.startswith("("):                  # the type's minimum
            vals.append(int(lit[1:].split()[0].rstrip("L")) - 1)
        else:
            vals.append(int(lit.rstrip("L")))
    if dtype.kind == "f":
        bits = np.uint32 if dtype == np.float32 else np.uint64
        return np.array(vals, bits).view(dtype)
    return np.array(vals, dtype)


def _network_lines(tree, dtype: np.dtype) -> list[str]:
    """The body of ng_network: each node a local, its kids first."""
    lines, count = [], [0]

    def emit(node) -> str:
        if isinstance(node, int):
            return str(node)                   # leaf: its block id
        seps, kids = node
        out = f"n{count[0]}"
        count[0] += 1
        lines.append(f"  int {out} = {emit(kids[-1])};")
        for i in reversed(range(len(seps))):
            kid = emit(kids[i])
            lines.append(f"  {out} = (q <= {literal(seps[i], dtype)}) "
                         f"? {kid} : {out};")
        return out

    lines.append(f"  return {emit(tree)};")
    return lines


def generate(tree, *, dtype, bottom: str, n: int, block_width: int,
             block_pad_width: int, block_pad_len: int, css_w: int = 0,
             css_leaf_width: int = 0, css_depth: int = 0,
             css_dir_len: int = 0, css_leaf_len: int = 0,
             css_dirs_len: int = 0, css_offsets: tuple = ()) -> str:
    """The CUDA C++ source of one index's kernel: its constants, the
    template header, and ``ng_network`` with every separator a literal."""
    dtype = np.dtype(dtype)
    if dtype not in _KEY_TYPES:
        raise TypeError(f"the generated NitroGen kernel takes int32, int64, "
                        f"float32 or float64 keys, not {dtype}")
    if bottom not in BOTTOM_IDS:
        raise ValueError(f"unknown nitrogen bottom {bottom!r}")
    log2 = int(block_pad_width).bit_length() - 1
    consts = {
        "NG_KEY": _KEY_TYPES[dtype], "NG_THREADS": THREADS,
        "NG_BOTTOM": BOTTOM_IDS[bottom],
        "NG_N": n, "NG_BLOCK_WIDTH": block_width,
        "NG_BLOCK_PAD_WIDTH": block_pad_width,
        "NG_BLOCK_PAD_LEN": block_pad_len,
        "NG_BLOCK_PAD_LOG2": log2 if bottom == "binary" else 0,
        "NG_CSS_W": max(css_w, 1), "NG_CSS_LEAF_WIDTH": max(css_leaf_width, 1),
        "NG_CSS_DEPTH": css_depth, "NG_CSS_DIR_LEN": css_dir_len,
        "NG_CSS_LEAF_LEN": css_leaf_len,
        "NG_CSS_DIRS_LEN": max(css_dirs_len, 1),
        "NG_CSS_OFFSETS": "{" + ", ".join(
            str(int(o)) for o in (css_offsets or (0,))) + "}"}
    return "\n".join([
        "// Generated by repro_torch/kernels/nitrogen_codegen.py: one "
        "NitroGen index",
        f"// compiled to code ({bottom} bottom, {n} keys). Every separator "
        "of the top",
        "// is a literal below; the rest is csrc/nitrogen_template.cuh.",
        *(f"#define {k} {v}" for k, v in consts.items()),
        f'#include "{TEMPLATE}"',
        "",
        "NG_FN int ng_network(NG_KEY q) {",
        *_network_lines(tree, dtype),
        "}",
        ""])


class CompiledTop:
    """One index's built kernel: the cubin and its source, what its build
    cost (``compile_s``: nvcc's seconds when this process built it, 0.0
    when it found it built), and the kernel loaded into each device's
    context on first use.

    It lives as long as an index (or a captured graph's closure) holds
    it. Then its modules are unloaded, at the next ``compile_top`` or
    ``release_unused`` (never from the collector's thread, which may be
    inside a capture), and, if ``retire`` was called (a mutable store's
    superseded top), its build files are deleted with them."""

    def __init__(self, cubin: Path, image: bytes, source: str,
                 dtype: torch.dtype, compile_s: float):
        self.library = cubin
        self.source = source
        self.dtype = dtype
        self.compile_s = compile_s
        self.load_s = 0.0
        self._image = image
        self._functions: dict = {}
        self._lock = threading.Lock()
        # what the release needs, apart from self: device -> module, and
        # the build files to delete (set by retire)
        self._held = {"modules": {}, "files": ()}
        weakref.finalize(self, _pending.append, self._held)

    def function(self, device: int):
        """The kernel in ``device``'s context, loaded on first use."""
        fn = self._functions.get(device)
        if fn is None:
            with self._lock:
                fn = self._functions.get(device)
                if fn is None:
                    t0 = time.perf_counter()
                    module, fn = _driver.load_function(self._image, device,
                                                       KERNEL)
                    self.load_s += time.perf_counter() - t0
                    self._held["modules"][device] = module
                    self._functions[device] = fn
        return fn

    def retire(self) -> None:
        """Delete the build files (source, cubin, log) when this kernel is
        released: nothing in the process will build its index again."""
        self._held["files"] = tuple(self.library.with_suffix(s)
                                    for s in (".cu", ".cubin", ".log"))

    @property
    def resources(self) -> list[dict]:
        """Registers, shared memory, stack and spills as ptxas reported
        them (``-Xptxas -v``); empty if the cubin was built elsewhere."""
        return _build.log_usage(self.library.with_suffix(".log"))


# cubin path -> its one live CompiledTop; released ones wait in _pending
_tops: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
_pending: list = []
_tops_lock = threading.Lock()


def release_unused() -> int:
    """Unload the modules of every released kernel, after the work queued
    on their devices has ended, and delete the build files of the retired
    ones. Returns the number of modules unloaded."""
    n = 0
    with _tops_lock:
        while _pending:
            held = _pending.pop()
            if held["modules"]:
                _driver.unload(held["modules"])
                n += len(held["modules"])
            if held["files"] and str(held["files"][1]) not in _tops:
                for f in held["files"]:
                    f.unlink(missing_ok=True)
    return n


def compile_top(source: str, dtype: torch.dtype) -> CompiledTop:
    """Build (or find) the cubin of a generated source. One CompiledTop a
    cubin in the process: indexes of the same source share its kernel.
    Releases the kernels no index holds any more first."""
    release_unused()
    with _tops_lock:
        cubin = _build.generated_path(STEM, source)
        top = _tops.get(str(cubin))
        if top is None:
            cubin, compile_s, image = _build.build_generated(STEM, source)
            top = _tops[str(cubin)] = CompiledTop(cubin, image, source,
                                                  dtype, compile_s)
        top._held["files"] = ()          # live again: keep its files
        return top


def loaded() -> int:
    """Generated kernels alive in this process (released ones excluded)."""
    return len(_tops)


def nitrogen_search(top: CompiledTop, q: torch.Tensor,
                    block_pad: torch.Tensor, css_dirs, *,
                    clip: int) -> torch.Tensor:
    """One launch of an index's generated kernel: int32 ``min(rank,
    clip)`` for each query, on the current stream. A CUDA tensor only: on
    the CPU the index runs the plain network and bottom
    (``core.nitrogen.search_plain``)."""
    if q.device.type != "cuda":
        raise ValueError(f"the generated NitroGen kernel runs on the card; "
                         f"got a tensor on {q.device}")
    if q.dtype != top.dtype or block_pad.dtype != top.dtype:
        raise TypeError(f"queries and blocks must be {top.dtype}, got "
                        f"{q.dtype} and {block_pad.dtype}")
    if q.dim() != 1 or q.shape[0] >= 2**31:
        raise ValueError(f"queries must be 1-D, fewer than 2^31, got shape "
                         f"{tuple(q.shape)}")
    for t in (block_pad, css_dirs):
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError("blocks must be contiguous on the queries' "
                             "device")
    q = q.contiguous()
    n = int(q.shape[0])
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    if n == 0:
        return out
    device = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    _driver.launch(
        top.function(device), device, -(-n // THREADS), THREADS,
        torch.cuda.current_stream(q.device).cuda_stream,
        [ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(block_pad.data_ptr()),
         ctypes.c_void_p(0 if css_dirs is None else css_dirs.data_ptr()),
         ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n),
         ctypes.c_int(int(clip))])
    nitrogen_search.launches += 1
    return out


nitrogen_search.launches = 0
