"""The paper's flat index kinds on the card: one kernel launch a search.

Three wrappers over ``csrc/flat_search.cu``. They twin no ``pallas_call``:
each twins the XLA program that ``jax.jit`` makes of a reference searcher,
which the port ran as a chain of PyTorch ops (about three launches and a
``[Q, w]`` row gather a level):

* ``flat_binary``: ``repro/core/sorted_array.py:53`` ``_search_pad``, one
  thread a query, steps ``n_pad / 2`` down to the cutoff, then the
  cutoff's tail block, clamped to n;
* ``flat_descent``: ``repro/core/css_tree.py:112`` ``_search``,
  ``kary.py:78`` ``_search`` and ``fast_tree.py:109`` ``_descend`` (with
  ``fast_tree.search``'s leaf count, or alone for ``leaf_page_of``). All
  compute ``j = j * fanout + |{node < q}|`` over rows of w keys; only a
  row's address differs, which ``Descent`` (the index's level table,
  built once an index on the host) gives the kernel;
* ``csb_search``: ``repro/core/csb_tree.py:213`` ``_search``, membership
  through the CSB+-tree's child groups.

Each wrapper runs the kernel for a CUDA tensor (on the current stream,
output from ``torch.empty``, no host sync, so graph capture records it)
and raises when it cannot; for a CPU tensor it runs its plain version,
``*_plain``: the kernel's per-query loop re-stated in PyTorch, reading only
the wrapper's arguments, so that a CPU test holds those arguments (the
level tables, the modes) to the reference. The kinds' ``search`` in
``core`` picks the device itself: its own composition, ``search_plain``,
on the CPU, this module's wrapper on the card. Each wrapper counts its
launches (``launches``; ``flat_descent.mode_launches`` by kind and
ending).

The key types are int32, float32, int64 and float64; ranks are int32.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from ..core.util import by_chunks, take, take_rows

_SUFFIX = {torch.int32: "i32", torch.float32: "f32", torch.int64: "i64",
           torch.float64: "f64"}
MAX_LEVELS = 64                     # kMaxLevels in the source
INTRAS = ("vector", "binary")
ENDINGS = {"rank": 0, "leaf": 1, "descent": 2}
_I32_MAX = 2**31 - 1

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "flat_binary": [_P, _LL, _P, _I, _I, _I, _I, _P, _P],
    "flat_descent": [_P, _LL, _P, _I, _I, _I, _I, _P, _P, _P,
                     ctypes.c_ulonglong, _I, _I, _P, _I, _I, _I, _I, _P, _P],
    "csb_search": [_P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
}


def _fn(kernel: str, dtype: torch.dtype):
    fn = getattr(_build.load("flat_search"), f"{kernel}_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[kernel]
        fn.restype = ctypes.c_int
    return fn


ROUNDS = 4                          # kRounds in the source
MAX_GROUP = 4


def group_lanes(width: int) -> int:
    """Lanes that read a node of ``width`` keys together: the power of two
    that covers the node in ``ROUNDS`` rounds of loads (which the kernel
    keeps in flight at once), at most ``MAX_GROUP`` (w <= 4: 1; w 5-8: 2;
    wider: 4). A wider node takes several batches of rounds: fewer lanes
    a query keep more queries in flight, which set the time on the H100
    (``experiments/flat_variants.py``)."""
    quarter = 1 << max(-(-int(width) // ROUNDS) - 1, 0).bit_length()
    return min(MAX_GROUP, quarter)


@dataclass(frozen=True)
class Descent:
    """``flat_descent``'s level table for one index. Level l reads the row
    ``page + level_row[l] + j_local`` of ``nodes`` viewed as rows of
    ``node_width`` keys, where a level whose bit is set in ``starts``
    begins a page, ``page = page_row[l] + j * page_rows[l]``, and restarts
    ``j_local`` at 0; after it ``j = j * fanout + c`` and ``j_local =
    j_local * fanout + c``, c the keys of the row below the query."""
    kind: str                    # 'css' | 'kary' | 'fast' (counter key)
    node_width: int
    page_row: tuple[int, ...]
    page_rows: tuple[int, ...]
    level_row: tuple[int, ...]
    starts: int
    intra: str = "vector"        # 'vector' | 'binary' (css)

    @property
    def fanout(self) -> int:
        return self.node_width + 1

    @property
    def depth(self) -> int:
        return len(self.level_row)

    @property
    def group(self) -> int:
        """Lanes a query: one for the binary range search."""
        return 1 if self.intra == "binary" else group_lanes(self.node_width)

    @functools.cached_property
    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The table as the int32 host arrays the C entry point copies."""
        return tuple(np.ascontiguousarray(x, np.int32) for x in
                     (self.page_row, self.page_rows, self.level_row))


def _checked(d: Descent) -> Descent:
    if d.intra not in INTRAS:
        raise ValueError(f"unknown intra-node search {d.intra!r}")
    if d.node_width < 1 or d.depth > MAX_LEVELS:
        raise ValueError(f"the kernel takes node widths >= 1 and at most "
                         f"{MAX_LEVELS} levels, got {d.node_width} and "
                         f"{d.depth}")
    if max((*d.page_row, *d.page_rows, *d.level_row), default=0) > _I32_MAX:
        raise ValueError("a row index past int32")
    return d


@functools.lru_cache(maxsize=256)
def level_descent(kind: str, level_offsets: tuple[int, ...],
                  node_width: int, intra: str = "vector") -> Descent:
    """The table of a level-major tree (css directory, k-ary tree): every
    level its own page of one row, at ``level_offsets[l] / w``."""
    w = node_width
    if any(off % w for off in level_offsets):
        raise ValueError("every level must start at a multiple of w")
    depth = len(level_offsets)
    return _checked(Descent(
        kind=kind, node_width=w,
        page_row=tuple(off // w for off in level_offsets),
        page_rows=(1,) * depth, level_row=(0,) * depth,
        starts=(1 << depth) - 1, intra=intra))


@functools.lru_cache(maxsize=256)
def page_descent(group_offsets: tuple[int, ...],
                 group_depths: tuple[int, ...], node_width: int) -> Descent:
    """The table of FAST's page-blocked directory: page-level group g
    starts a page at ``group_offsets[g] / w + j * psize_g / w``, and
    in-page level dl lies ``page_size(w, dl) / w`` rows into its page."""
    w, f = node_width, node_width + 1

    def page_size(d: int) -> int:   # core.fast_tree._page_size
        return w * (f**d - 1) // (f - 1)

    page_row, page_rows, level_row, starts, lvl = [], [], [], 0, 0
    for off, d in zip(group_offsets, group_depths):
        if off % w:
            raise ValueError("every page-level group must start at a "
                             "multiple of w")
        starts |= 1 << lvl
        for dl in range(d):
            page_row.append(off // w if dl == 0 else 0)
            page_rows.append(page_size(d) // w if dl == 0 else 0)
            level_row.append(page_size(dl) // w)
        lvl += d
    return _checked(Descent(kind="fast", node_width=w,
                            page_row=tuple(page_row),
                            page_rows=tuple(page_rows),
                            level_row=tuple(level_row), starts=starts))


def _device_args(q: torch.Tensor, *arrays: torch.Tensor):
    """What every kernel checks: a 1-D CUDA query tensor of a key type the
    kernel takes, and index arrays contiguous on its device, each of fewer
    than 2^31 entries. Returns the queries contiguous."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"the flat kernels take int32, float32, int64 or "
                        f"float64 keys, got {q.dtype}")
    if q.dim() != 1:
        raise ValueError(f"queries must be 1-D, got {tuple(q.shape)}")
    for t in arrays:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("index arrays must be contiguous on the "
                             "queries' device")
        if t.numel() > _I32_MAX:
            raise ValueError("an index array past 2^31 entries")
    return q.contiguous()


def _lower_bound(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``sorted_row::lower_bound`` on each query's row of ``rows`` [Q, w]:
    the branch-free halving the kernel's one-lane searches run."""
    base = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    n = rows.shape[1]
    while n > 1:
        half = n >> 1
        probe = rows.gather(1, (base + half).long()[:, None])[:, 0]
        base = torch.where(probe < q, base + half, base)
        n -= half
    last = rows.gather(1, base.long()[:, None])[:, 0]
    return base + (last < q).to(torch.int32)


def _row_count(rows: torch.Tensor, q: torch.Tensor,
               binary: bool) -> torch.Tensor:
    """The keys of each query's row below it: one lane's lower bound
    (``binary``) or the group's count of the whole row."""
    if binary:
        return _lower_bound(rows, q)
    return (rows < q[:, None]).sum(-1, dtype=torch.int32)


def flat_binary_plain(keys_pad: torch.Tensor, q: torch.Tensor, *,
                      n_pad: int, cutoff: int, n: int) -> torch.Tensor:
    """Plain version: the kernel's loop in PyTorch, over slices of the
    batch: probes ``pos + step - 1`` (clamped) for steps ``n_pad / 2`` down
    to ``cutoff``, counts the ``cutoff``-key block at ``pos`` when the
    cutoff is above 1, clamps to n."""
    def run(qq):
        pos = torch.zeros(qq.shape, dtype=torch.int32, device=qq.device)
        step = n_pad // 2
        while step >= cutoff:
            pos = torch.where(take(keys_pad, pos + (step - 1)) < qq,
                              pos + step, pos)
            step //= 2
        if cutoff > 1:
            blk = take(keys_pad, pos[:, None] + torch.arange(
                cutoff, dtype=torch.int32, device=qq.device))
            pos = pos + (blk < qq[:, None]).sum(-1, dtype=torch.int32)
        return pos.clamp_max(n)

    return by_chunks(cutoff, run, q)


def flat_binary(keys_pad: torch.Tensor, q: torch.Tensor, *, n_pad: int,
                cutoff: int, n: int) -> torch.Tensor:
    """searchsorted-left ranks [Q] (int32) over the power-of-two padded
    ``keys_pad`` of n keys: the lower bound in steps ``n_pad / 2`` down to
    ``cutoff``, then the ``cutoff``-key block counted, clamped to n."""
    if q.device.type == "cpu":
        return flat_binary_plain(keys_pad, q, n_pad=n_pad, cutoff=cutoff,
                                 n=n)
    q = _device_args(q, keys_pad)
    if keys_pad.dtype != q.dtype or keys_pad.numel() < 1 or cutoff < 1:
        raise ValueError("keys_pad must be non-empty in the queries' dtype "
                         "and the cutoff at least 1")
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:
        return out
    err = _fn("flat_binary", q.dtype)(
        q.data_ptr(), q.shape[0], keys_pad.data_ptr(), keys_pad.numel(),
        n_pad, cutoff, n, out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flat_binary")
    flat_binary.launches += 1
    return out


flat_binary.launches = 0


def flat_descent_plain(q: torch.Tensor, nodes: torch.Tensor, d: Descent,
                       leaves: torch.Tensor | None = None,
                       leaf_width: int = 0, *, ending: str,
                       n: int = 0) -> torch.Tensor:
    """Plain version: the kernel's per-query loop over the level table, in
    PyTorch (int32 index arithmetic, rows clamped as ``util.take`` clamps
    them): each node and leaf block counted whole (``intra="vector"``) or
    by one lane's lower bound (``"binary"``)."""
    w, f, binary = d.node_width, d.fanout, d.intra == "binary"

    def run(qq):
        j = torch.zeros(qq.shape, dtype=torch.int32, device=qq.device)
        j_local, page = torch.zeros_like(j), torch.zeros_like(j)
        for l in range(d.depth):
            if d.starts >> l & 1:
                page = d.page_row[l] + j * d.page_rows[l]
                j_local = torch.zeros_like(j)
            node = take_rows(nodes, w, page + d.level_row[l] + j_local)
            c = _row_count(node, qq, binary)
            j, j_local = j * f + c, j_local * f + c
        if ending == "leaf":
            blk = take_rows(leaves, leaf_width, j)
            j = j * leaf_width + _row_count(blk, qq, binary)
        return j

    rank = by_chunks(max(w, leaf_width), run, q)
    return rank if ending == "descent" else rank.clamp_max(n)


def flat_descent(q: torch.Tensor, nodes: torch.Tensor, d: Descent,
                 leaves: torch.Tensor | None = None, leaf_width: int = 0, *,
                 ending: str, n: int = 0) -> torch.Tensor:
    """The descent of ``d`` over ``nodes`` for each query, int32 [Q]. The
    ending: ``"rank"`` j clamped to n (k-ary), ``"leaf"`` j * leaf_width
    plus the keys below q in leaf block j of ``leaves``, clamped to n (css,
    FAST), ``"descent"`` j itself (FAST's ``leaf_page_of``)."""
    if ending not in ENDINGS:
        raise ValueError(f"unknown ending {ending!r}; want one of "
                         f"{tuple(ENDINGS)}")
    if q.device.type == "cpu":
        return flat_descent_plain(q, nodes, d, leaves, leaf_width,
                                  ending=ending, n=n)
    leaf = ending == "leaf"
    if leaf and (leaves is None or leaf_width < 1
                 or leaves.numel() < leaf_width):
        raise ValueError("a leaf count needs leaf blocks of leaf_width >= 1")
    q = _device_args(q, nodes, *([leaves] if leaf else []))
    if nodes.dtype != q.dtype or (leaf and leaves.dtype != q.dtype):
        raise TypeError(f"nodes and leaves must be {q.dtype}")
    if nodes.numel() % d.node_width or (d.depth and nodes.numel() == 0):
        raise ValueError("nodes must be whole rows of node_width keys")
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:
        return out
    page_row, page_rows, level_row = d.arrays
    err = _fn("flat_descent", q.dtype)(
        q.data_ptr(), q.shape[0], nodes.data_ptr(),
        nodes.numel() // d.node_width, d.node_width, d.fanout, d.depth,
        page_row.ctypes.data, page_rows.ctypes.data, level_row.ctypes.data,
        d.starts, int(d.intra == "binary"), d.group,
        leaves.data_ptr() if leaf else None,
        leaves.numel() // leaf_width if leaf else 0,
        leaf_width if leaf else 0, ENDINGS[ending], n, out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flat_descent")
    flat_descent.launches += 1
    mode = d.kind if ending != "descent" else f"{d.kind}_descent"
    flat_descent.mode_launches[mode] += 1
    return out


flat_descent.launches = 0
flat_descent.mode_launches = {"css": 0, "kary": 0, "fast": 0,
                              "fast_descent": 0}


def csb_search_plain(q: torch.Tensor, keys: torch.Tensor,
                     child: torch.Tensor, leaf_keys: torch.Tensor, *,
                     root: int, height: int) -> torch.Tensor:
    """Plain version: the kernel's loop in PyTorch, over slices of the
    batch: from ``root``, ``height - 1`` steps to child ``child[node] + c``
    (c the node's keys below q), staying put where ``child`` is negative,
    then whether the leaf holds q. Rows are clamped as ``util.take``
    clamps them."""
    def run(qq):
        nid = torch.full(qq.shape, root, dtype=torch.int32, device=qq.device)
        for _ in range(height - 1):
            c = (take(keys, nid) < qq[:, None]).sum(-1, dtype=torch.int32)
            base = take(child, nid)
            nid = torch.where(base < 0, nid, base + c)
        return (take(leaf_keys, nid) == qq[:, None]).any(-1)

    return by_chunks(keys.shape[1], run, q)


def csb_search(q: torch.Tensor, keys: torch.Tensor, child: torch.Tensor,
               leaf_keys: torch.Tensor, *, root: int,
               height: int) -> torch.Tensor:
    """Membership of each query in a CSB+-tree's snapshot (``keys`` and
    ``leaf_keys`` [N, w], ``child`` int32 [N], -1 at a leaf): bool [Q]."""
    if q.device.type == "cpu":
        return csb_search_plain(q, keys, child, leaf_keys, root=root,
                                height=height)
    q = _device_args(q, keys, child, leaf_keys)
    if keys.dtype != q.dtype or leaf_keys.dtype != q.dtype \
            or child.dtype != torch.int32:
        raise TypeError(f"keys must be {q.dtype} and child int32")
    if keys.dim() != 2 or leaf_keys.shape != keys.shape \
            or child.shape != keys.shape[:1] or keys.shape[0] < 1:
        raise ValueError("want keys and leaf_keys [N, w], child [N], N >= 1")
    out = torch.empty(q.shape, dtype=torch.bool, device=q.device)
    if q.shape[0] == 0:
        return out
    w = keys.shape[1]
    err = _fn("csb_search", q.dtype)(
        q.data_ptr(), q.shape[0], keys.data_ptr(), child.data_ptr(),
        leaf_keys.data_ptr(), keys.shape[0], w, root, height,
        group_lanes(w), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "csb_search")
    csb_search.launches += 1
    return out


csb_search.launches = 0

