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
the block slots a query's bottom reads) over 3.35 TB/s and the compares a
search needs (a binary search of a node's separators at each level of the
top, then of the bottom's rows; the select itself compares every
separator) over 33.5e12 a second. What holds it back is the loads a query
scatters (one thread a query: each lane's load is a transaction of its
own) and, past the L2, the sectors they drag in. So ``layout`` picks,
from the index's shape, how the kernel reads the bottom: a short row key
by key (16 bytes a load where rows are aligned); a longer one by a lower
bound whose first levels read a small sample of every row (``stage``,
copied into shared memory when the batch fills a persistent grid:
``CompiledTop.launch``), whose next levels read a sample at every
window's width (``sample``) and whose last levels read one aligned
32-byte window of the sample and one of the row; a CSS directory and its
leaves 16 bytes a load.
"""
from __future__ import annotations

import ctypes
import re
import threading
import time
import weakref
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import _build, _driver

STEM = "nitrogen"
TEMPLATE = "nitrogen_template.cuh"
KERNEL = "ng_search_kernel"
THREADS = 256                    # threads a block, a query each
# a staging launch: blocks of 1,024 threads with at most STAGE_BYTES of
# shared memory each, two an SM (all its 2,048 threads), so that the SM's
# L1 keeps ~100 KB of its 256 KB
STAGE_THREADS = 1024
STAGE_BYTES = 65_536
LINEAR_BYTES = 64                # a row this short is counted key by key
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


def row_log2(width: int) -> int:
    """ceil(log2(width)): the levels of a lower bound over ``width`` slots."""
    return max(int(width) - 1, 0).bit_length()


def layout(dtype, bottom: str, num_blocks: int, block_pad_width: int,
           css_w: int = 0, stage_levels: Optional[int] = None) -> dict:
    """How the kernel reads an index's bottom (the template's constants):

    * ``linear``: a binary or vector row of at most ``LINEAR_BYTES``,
      counted key by key (``vec_rows``: 16 bytes a load, the rows being
      whole 16-byte pieces);
    * else, for a binary or vector row, a lower bound of
      ``row_log2(block_pad_width)`` levels: the first ``stage_levels``
      read the stage array (every row's 2^levels - 1 slots that those
      levels probe: as many levels as fit in ``STAGE_BYTES``); with
      ``sample`` the levels below, down to the last two windows, read
      the sample array (every ``2^win_log2``-th slot of every row), then
      one window of it; the last ``win_log2`` levels read one aligned
      window of the row, 2 x 16 bytes (rows of whole 16-byte pieces);
    * a CSS bottom reads every directory row 16 bytes a load when
      ``css_vec``, and its leaves through aligned 16-byte pieces.

    ``stage_levels``, when given, is an index's own (its stage array's)."""
    item = np.dtype(dtype).itemsize
    vec = 16 // item
    out = dict(linear=0, vec_rows=int(block_pad_width % vec == 0),
               win_log2=0, stage_levels=0, sample=0,
               css_vec=int(css_w > 0 and css_w % vec == 0))
    if bottom == "css":
        return out
    if block_pad_width * item <= LINEAR_BYTES:
        out["linear"] = 1
        return out
    log2 = row_log2(block_pad_width)
    win = (2 * vec).bit_length() - 1
    if out["vec_rows"] and log2 >= win:
        out["win_log2"] = win
    lev = stage_levels or 0
    while (stage_levels is None and lev < log2 - out["win_log2"]
           and num_blocks * (2 ** (lev + 1) - 1) * item <= STAGE_BYTES):
        lev += 1
    out["stage_levels"] = lev
    out["sample"] = int(out["win_log2"] > 0 and log2 - lev >= 2 * win)
    return out


def stage_bytes(dtype, num_blocks: int, stage_levels: int) -> int:
    """Bytes of the stage array: every block's 2^levels - 1 staged keys,
    rounded up to a whole number of 16-byte pieces."""
    keys = num_blocks * (2**stage_levels - 1)
    return -(-keys * np.dtype(dtype).itemsize // 16) * 16


def generate(tree, *, dtype, bottom: str, n: int, block_width: int,
             block_pad_width: int, block_pad_len: int, css_w: int = 0,
             css_leaf_width: int = 0, css_depth: int = 0,
             css_dir_len: int = 0, css_leaf_len: int = 0,
             css_dirs_len: int = 0, css_offsets: tuple = (),
             stage_levels: Optional[int] = None) -> str:
    """The CUDA C++ source of one index's kernel: its constants (``layout``,
    with the index's ``stage_levels``), the template header, and
    ``ng_network`` with every separator a literal."""
    dtype = np.dtype(dtype)
    if dtype not in _KEY_TYPES:
        raise TypeError(f"the generated NitroGen kernel takes int32, int64, "
                        f"float32 or float64 keys, not {dtype}")
    if bottom not in BOTTOM_IDS:
        raise ValueError(f"unknown nitrogen bottom {bottom!r}")
    num_blocks = block_pad_len // (css_leaf_len if bottom == "css"
                                   else block_pad_width)
    lay = layout(dtype, bottom, num_blocks, block_pad_width, css_w,
                 stage_levels)
    consts = {
        "NG_KEY": _KEY_TYPES[dtype],
        "NG_THREADS": STAGE_THREADS if lay["stage_levels"] else THREADS,
        "NG_BOTTOM": BOTTOM_IDS[bottom],
        "NG_N": n, "NG_BLOCK_WIDTH": block_width,
        "NG_BLOCK_PAD_WIDTH": block_pad_width,
        "NG_BLOCK_PAD_LEN": block_pad_len,
        "NG_ROW_LOG2": row_log2(block_pad_width),
        "NG_LINEAR": lay["linear"], "NG_VEC_ROWS": lay["vec_rows"],
        "NG_WIN_LOG2": lay["win_log2"],
        "NG_STAGE_LEVELS": lay["stage_levels"],
        "NG_STAGE_BYTES": stage_bytes(dtype, num_blocks,
                                      lay["stage_levels"]),
        "NG_SAMPLE": lay["sample"],
        "NG_CSS_W": max(css_w, 1), "NG_CSS_LEAF_WIDTH": max(css_leaf_width, 1),
        "NG_CSS_DEPTH": css_depth, "NG_CSS_DIR_LEN": css_dir_len,
        "NG_CSS_LEAF_LEN": css_leaf_len,
        "NG_CSS_DIRS_LEN": max(css_dirs_len, 1),
        "NG_CSS_OFFSETS": "{" + ", ".join(
            str(int(o)) for o in (css_offsets or (0,))) + "}",
        "NG_CSS_VEC": lay["css_vec"]}
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


def defined(source: str, name: str, default: int) -> int:
    """The integer a generated source #defines as ``name`` (``default``
    when it defines none)."""
    m = re.search(rf"^#define {name} (\d+)$", source, re.M)
    return default if m is None else int(m.group(1))


class CompiledTop:
    """One index's built kernel: the cubin and its source, what its build
    cost (``compile_s``: nvcc's seconds when this process built it, 0.0
    when it found it built), and the kernel loaded into each device's
    context on first use, with what a launch needs (``launch``): a
    staging launch's ``threads`` a block and ``shared`` bytes of shared
    memory (the stage array; 0 when the kernel stages nothing).

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
        self.threads = defined(source, "NG_THREADS", THREADS)
        self.shared = defined(source, "NG_STAGE_BYTES", 0)
        self._image = image
        self._functions: dict = {}
        self._cap: dict = {}
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
                    if self.shared > 48 * 1024:
                        _driver.allow_shared(fn, device, self.shared)
                    self.load_s += time.perf_counter() - t0
                    self._held["modules"][device] = module
                    self._functions[device] = fn
        return fn

    def launch(self, device: int, n: int) -> tuple[int, int, int, int]:
        """(blocks, threads a block, shared bytes, staging) of a search of
        ``n`` queries: a staging launch when the kernel stages and the
        batch fills a persistent grid (as many blocks as the card holds
        at once, each staging once), else THREADS a block and as many
        blocks as the queries need."""
        if self.shared:
            cap = self._cap.get(device)
            if cap is None:
                props = torch.cuda.get_device_properties(device)
                cap = self._cap[device] = _driver.max_active_blocks(
                    self.function(device), device, self.threads,
                    self.shared) * props.multi_processor_count
            if cap and n >= cap * self.threads:
                return cap, self.threads, self.shared, 1
        return -(-n // THREADS), THREADS, 0, 0

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
                    block_pad: torch.Tensor, css_dirs, stage, sample, *,
                    clip: int) -> torch.Tensor:
    """One launch of an index's generated kernel: int32 ``min(rank,
    clip)`` for each query, on the current stream. ``stage`` and
    ``sample`` are the index's copies of its rows' slots that the lower
    bound reads first (``layout``; empty when it reads none). A CUDA
    tensor only: on the CPU the index runs the plain network and bottom
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
    for t in (block_pad, css_dirs, stage, sample):
        if t is not None and (t.device != q.device or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError("blocks must be contiguous and 16-byte aligned "
                             "on the queries' device")
    if top.shared and (stage is None
                       or stage.numel() * stage.element_size() < top.shared):
        raise ValueError(f"the kernel stages {top.shared} bytes; got "
                         f"{None if stage is None else stage.numel()} keys")
    q = q.contiguous()
    n = int(q.shape[0])
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    if n == 0:
        return out
    device = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())
    blocks, threads, shared, staging = top.launch(device, n)
    _driver.launch(
        top.function(device), device, blocks, threads,
        torch.cuda.current_stream(q.device).cuda_stream,
        [ptr(q), ptr(block_pad), ptr(css_dirs), ptr(stage), ptr(sample),
         ptr(out), ctypes.c_int(n), ctypes.c_int(int(clip)),
         ctypes.c_int(staging)], shared=shared)
    nitrogen_search.launches += 1
    return out


nitrogen_search.launches = 0
