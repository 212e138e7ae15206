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
  through the CSB+-tree's child groups, one thread a query.

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

The kernels read each index through a stage built once an index
(``binary_stage``, ``descent_stage``, held by the index beside its
arrays; ``csb_stage``, built by each ``CSBTree.snapshot``): ``flat_binary``
the probe keys of its first levels in Eytzinger order and a sample of
every 32-byte window's last key (read through ``csrc/staged_bound.cuh``'s
steps, as kernel 6 reads its own); ``flat_descent`` the number of levels
whose rows it copies into shared memory, each level's live nodes (past
them a node is all sentinel and counts 0) and, for each live node and live
leaf block wider than ``whole_keys``, the last key of each of its 64-byte
blocks; ``csb_search`` a copy of the tree's first inner levels in
breadth-first order, each staged node's key row and its link (its first
child's place in the copy, or past the copy its child group's id). The
plain versions read the same arrays through the same windows, so that the
CPU tests hold them to the reference.

The key types are int32, float32, int64 and float64; ranks are int32.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from ..core.util import (by_chunks, numpy_dtype, sentinel_for, take,
                         take_rows, upload_async)

_SUFFIX = {torch.int32: "i32", torch.float32: "f32", torch.int64: "i64",
           torch.float64: "f64"}
MAX_LEVELS = 64                     # kMaxLevels in the source
INTRAS = ("vector", "binary")
ENDINGS = {"rank": 0, "leaf": 1, "descent": 2}
_I32_MAX = 2**31 - 1

# Shared memory a persistent block may stage: the first levels of
# flat_descent's rows, padded as sorted_row::padded_stride pads them, or
# flat_binary's probe keys (experiments/flat_variants.py times others)
STAGE_BYTES = 96 * 1024
# csb_search's: its first inner levels (five, 128 KB, of a 2^20-key tree
# at w 8: one block an SM, as its registers allow anyway)
CSB_STAGE_BYTES = 160 * 1024

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "flat_binary": [_P, _LL, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    "flat_descent": [_P, _LL, _P, _I, _I, _I, _I, _P, ctypes.c_ulonglong,
                     _I, _I, _I, _P, _LL, _I, _P, _I, _I, _LL, _I, _I, _I,
                     _P, _P],
    "csb_search": [_P, _LL, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I,
                   _P, _P, ctypes.POINTER(ctypes.c_int)],
}


def _fn(kernel: str, dtype: torch.dtype):
    fn = getattr(_build.load("flat_search"), f"{kernel}_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[kernel]
        fn.restype = ctypes.c_int
    return fn


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

    @functools.cached_property
    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The table as int32 host arrays (the first three of the table
        the C entry point copies, ``DescentStage.table``)."""
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


def block_keys(dtype) -> int:
    """Keys of a sampled block: 64 bytes (16 of 4 bytes, 8 of 8)."""
    return 64 // np.dtype(dtype).itemsize


def whole_keys(dtype) -> int:
    """The widest row the kernel counts whole, in one round of five 16-byte
    loads (a block and a key, at any alignment); a wider row is read
    through its sample."""
    return block_keys(dtype) + 1


def window_keys(dtype) -> int:
    """Keys of flat_binary's window: 32 bytes."""
    return 32 // np.dtype(dtype).itemsize


def dead(keys: np.ndarray) -> np.ndarray:
    """Keys below no query: the int max, or +inf and NaN. A sorted row
    whose first key is dead is dead whole and counts 0."""
    if np.issubdtype(keys.dtype, np.floating):
        return ~(keys < np.inf)
    return keys == sentinel_for(keys.dtype)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _sample_rows(rows: np.ndarray, width: int) -> tuple[np.ndarray, int]:
    """The sample of ``rows`` [R, width]: each block's last key but the
    last block's (a block of ``block_keys``), padded with the sentinel to
    a whole number of 16-byte pieces. Returns (rows' samples, width)."""
    blk = block_keys(rows.dtype)
    s = -(-width // blk) - 1
    sw = 1 << max(s - 1, 0).bit_length()
    sw = max(sw, 16 // rows.dtype.itemsize)
    out = np.full((rows.shape[0], sw), sentinel_for(rows.dtype), rows.dtype)
    out[:, :s] = rows[:, blk - 1: s * blk: blk]
    return out, sw


def stride_bytes(width: int, itemsize: int) -> int:
    """Bytes of a staged row: sorted_row::padded_stride keys."""
    return (width + (width >> 5) + 1) * itemsize


@dataclass(frozen=True, eq=False)
class DescentStage:
    """What ``flat_descent`` reads of one index beyond its arrays.
    ``table`` is the kernel's level table, 5 x depth int32: the
    ``Descent``'s page_row, page_rows and level_row, each level's live
    nodes (node j of level l counts 0 unless j < live[l]) and its first
    row of ``sample``. ``sample`` holds the directory's sample rows
    (``sample_width`` keys a live node, level after level; none when
    w <= a block or the intra-node search is binary), then the leaf
    blocks' (``leaf_sample_width`` keys a block j with j * leaf_width < n,
    from key ``leaf_sample_at``). The first ``stage_levels`` levels lie in
    the first ``stage_rows`` rows, which a persistent block stages."""
    table: np.ndarray
    sample: torch.Tensor
    sample_width: int
    leaf_sample_at: int
    leaf_sample_width: int
    stage_levels: int
    stage_rows: int
    n: int

    @property
    def live(self) -> tuple[int, ...]:
        d = self.table.size // 5
        return tuple(int(x) for x in self.table[3 * d: 4 * d])

    @property
    def sample_row(self) -> tuple[int, ...]:
        d = self.table.size // 5
        return tuple(int(x) for x in self.table[4 * d:])

    @property
    def nbytes(self) -> int:
        return self.sample.numel() * self.sample.element_size()


def _level_rows(d: Descent, level: int, j: np.ndarray) -> np.ndarray:
    """The rows of ``nodes`` that nodes ``j`` (int64) of ``level`` read, by
    the level table (clamped as the kernel clamps them is the caller's)."""
    start = max((s for s in range(level + 1) if d.starts >> s & 1),
                default=-1)
    if start < 0:
        return d.level_row[level] + j
    span = d.fanout ** (level - start)
    return (d.page_row[start] + (j // span) * d.page_rows[start]
            + d.level_row[level] + j % span)


def _live_nodes(rows: np.ndarray, d: Descent, level: int) -> int:
    """The live nodes of ``level``: a level's first keys rise with the node
    index (its rows are sorted and cover the keys in order), so the dead
    ones (first key dead) are a suffix, found by bisection."""
    lo, hi = 0, d.fanout ** level
    while lo < hi:
        mid = (lo + hi) // 2
        r = int(np.clip(_level_rows(d, level, np.int64(mid)), 0,
                        rows.shape[0] - 1))
        if dead(rows[r, :1])[0]:
            hi = mid
        else:
            lo = mid + 1
    return lo


def descent_stage(nodes, d: Descent, leaves=None, leaf_width: int = 0, *,
                  n: int, device) -> DescentStage:
    """``flat_descent``'s stage of one index, from its ``nodes`` (and its
    leaf blocks ``leaves`` of ``leaf_width`` keys, for a leaf count) and
    its level table ``d``, on ``device``: built once, when an index is
    built on the card, from host arrays (uploaded without a host sync)."""
    nodes = _host(nodes)
    w, f = d.node_width, d.fanout
    n_rows = nodes.size // w
    rows = nodes.reshape(n_rows, w) if n_rows else nodes.reshape(0, w)
    vector = d.intra == "vector" and w > whole_keys(nodes.dtype)
    live, first, samples, at = [], [], [], 0
    for lev in range(d.depth):
        if f ** lev > _I32_MAX:
            raise ValueError("a level past 2^31 nodes")
        k = _live_nodes(rows, d, lev) if n_rows else 0
        live.append(k)
        first.append(at)
        if vector:
            r = np.clip(_level_rows(d, lev, np.arange(k, dtype=np.int64)),
                        0, n_rows - 1)
            smp, sw = _sample_rows(rows[r], w)
            samples.append(smp.reshape(-1))
            at += k
    sw = _sample_rows(rows[:0], w)[1] if vector else 0
    leaf_at, lsw = at * sw, 0
    if leaves is not None and d.intra == "vector" \
            and leaf_width > whole_keys(nodes.dtype):
        leaves = _host(leaves)
        n_leaves = leaves.size // leaf_width
        m = -(-n // leaf_width)         # the blocks that hold keys
        blocks = leaves[:min(m, n_leaves) * leaf_width].reshape(-1,
                                                                leaf_width)
        if m > n_leaves:                # clamped as the kernel clamps
            blocks = blocks[np.clip(np.arange(m), 0, n_leaves - 1)]
        smp, lsw = _sample_rows(blocks, leaf_width)
        samples.append(smp.reshape(-1))
    # the largest prefix of rows that holds whole levels (or FAST's whole
    # page groups) within the budget
    stage_levels = stage_rows = 0
    row_bytes = stride_bytes(w, nodes.dtype.itemsize)
    for lev in range(d.depth, 0, -1):
        if lev < d.depth and not d.starts >> lev & 1:
            continue
        r = n_rows if lev == d.depth else d.page_row[lev]
        if 0 < r <= n_rows and r * row_bytes <= STAGE_BYTES:
            stage_levels, stage_rows = lev, r
            break
    sample = np.concatenate(samples) if samples \
        else np.zeros(0, nodes.dtype)
    table = np.concatenate([*d.arrays, np.asarray(live, np.int32),
                            np.asarray(first, np.int32)])
    return DescentStage(
        table=np.ascontiguousarray(table, np.int32),
        sample=upload_async(sample, torch.device(device)),
        sample_width=sw, leaf_sample_at=leaf_at, leaf_sample_width=lsw,
        stage_levels=stage_levels, stage_rows=stage_rows, n=int(n))


@dataclass(frozen=True, eq=False)
class BinaryStage:
    """What ``flat_binary`` reads of one padded array beyond it. Its
    levels are k = top .. last (steps 2^k; none when top < last); the
    first ``levels`` of them read ``stage`` (their probe keys in
    Eytzinger order: entry h - 1 is heap node h), the rest ``sample``
    (keys_pad's last key of every window of ``window_keys``, up to its
    first dead key) and a window of keys_pad."""
    stage: torch.Tensor
    sample: torch.Tensor
    levels: int
    top: int
    last: int
    n_pad: int
    cutoff: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.stage, self.sample))


def binary_stage(keys_pad, n_pad: int, cutoff: int, *,
                 device) -> BinaryStage:
    """``flat_binary``'s stage of a padded array (``sorted_array.build``'s
    ``keys_pad``) searched with ``cutoff``, on ``device``."""
    keys = _host(keys_pad)
    if keys.size != n_pad or cutoff < 1 or cutoff > n_pad:
        raise ValueError("keys_pad must hold n_pad keys and the cutoff be "
                         "in [1, n_pad]")
    power = n_pad & (n_pad - 1) == 0
    if not power and n_pad // 2 >= cutoff:
        raise ValueError("n_pad must be a power of two below the cutoff")
    top = n_pad.bit_length() - 2 if power else -1
    last = (cutoff - 1).bit_length()
    most = 0
    while (2 ** (most + 1) - 1) * keys.itemsize <= STAGE_BYTES:
        most += 1
    levels = min(max(top - last + 1, 0), most)
    stage = np.empty(2 ** levels - 1, keys.dtype)
    for s in range(levels):
        t = np.arange(2 ** s, dtype=np.int64)
        stage[2 ** s - 1 + t] = keys[((2 * t + 1) << (top - s)) - 1]
    win = window_keys(keys.dtype)
    # keys_pad is sorted: its dead keys (the sentinel; +inf, NaN) end it
    n_live = int(np.searchsorted(keys, sentinel_for(keys.dtype)))
    sample = keys[win - 1: (n_live // win) * win: win]
    return BinaryStage(
        stage=upload_async(stage, torch.device(device)),
        sample=upload_async(sample, torch.device(device)),
        levels=levels, top=top, last=last, n_pad=int(n_pad),
        cutoff=int(cutoff))


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


def _count_range(a: torch.Tensor, start: torch.Tensor, stop: torch.Tensor,
                 most: int, q: torch.Tensor) -> torch.Tensor:
    """The kernel's ``count_range``: #{x in [start, stop) : a[x] < q} for
    each query (int64 bounds, ranges of at most ``most`` keys), read as
    the aligned 16-byte pieces that cover the range, masked to it and to
    the array."""
    if a.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    v = 16 // a.element_size()
    pieces = (most + 2 * v - 2) // v
    at = (start - start % v)[:, None] + torch.arange(
        pieces * v, dtype=torch.int64, device=q.device)
    keep = (at >= start[:, None]) & (at < stop[:, None]) & (at < a.numel())
    keys = a[at.clamp(0, a.numel() - 1)]
    return ((keys < q[:, None]) & keep).sum(-1, dtype=torch.int32)


def _row_count(a: torch.Tensor, row: torch.Tensor, width: int,
               sample: torch.Tensor, samp: torch.Tensor, sample_width: int,
               q: torch.Tensor) -> torch.Tensor:
    """The kernel's ``row_count`` of the sorted rows of ``width`` keys at
    ``row`` (int64 key offsets): through the sample row at ``samp`` when
    the row is wider than ``whole_keys`` (its count b picks block b, which
    is counted next), else the row whole."""
    dtype = numpy_dtype(a.dtype)
    blk = block_keys(dtype)
    if width <= whole_keys(dtype):
        return _count_range(a, row, row + width, width, q)
    b = _count_range(sample, samp, samp + sample_width, sample_width, q)
    start = row + b.long() * blk
    stop = torch.minimum(start + blk, row + width)
    return b * blk + _count_range(a, start, stop, blk, q)


def flat_binary_plain(keys_pad: torch.Tensor, q: torch.Tensor, *,
                      n_pad: int, cutoff: int, n: int,
                      stage: BinaryStage) -> torch.Tensor:
    """Plain version: the kernel's loop in PyTorch, over slices of the
    batch: the staged levels through ``stage.stage`` (Eytzinger order),
    one ``stage.sample`` entry a level down to a step of 2 windows, one
    window of the sample, then one window of keys_pad for the levels left
    and the cutoff's tail (a wider tail: its ``cutoff`` keys), clamped to
    n. The same ranks as ``sorted_array._search_pad`` over keys_pad."""
    _check_binary(stage, keys_pad, n_pad, cutoff)
    win = window_keys(numpy_dtype(keys_pad.dtype))
    wl = win.bit_length() - 1
    top, last, levels = stage.top, stage.last, stage.levels
    n_sample = stage.sample.numel()

    def sample_levels(pos, hi, lo, shift, below):
        """staged_bound::sample_levels: levels hi .. lo, the probe of
        level k at entry (pos + 2^k) / 2^shift - 1 of a sample."""
        for k in range(hi, lo - 1, -1):
            m = ((pos + (1 << k)) >> shift) - 1
            pos = pos + below(m).long() * (1 << k)
        return pos

    def run(qq):
        pos = torch.zeros(qq.shape, dtype=torch.int64, device=qq.device)
        k = top
        if levels:
            h = torch.ones_like(pos)
            for _ in range(levels):
                h = 2 * h + (stage.stage[h - 1] < qq).long()
            pos = (h - (1 << levels)) << (top + 1 - levels)
            k = top - levels
        single = max(2 * wl, last)
        pos = sample_levels(pos, k, single, wl, lambda m: (
            m < n_sample) & (take(stage.sample, m) < qq) if n_sample
            else torch.zeros_like(m, dtype=torch.bool))
        k = min(k, single - 1)
        lo = max(wl, last)
        if k >= lo:
            span = 1 << (k + 1 - wl)
            first = pos >> wl
            c = _count_range(stage.sample, first, first + span - 1, span, qq)
            pos = pos + ((c.long() >> (lo - wl)) << lo)
            k = lo - 1
        if k >= last:
            span = 1 << (k + 1)
            c = _count_range(keys_pad, pos, pos + span, win, qq).long()
            p = pos + ((c >> last).clamp_max((span >> last) - 1) << last)
            pos = p + (c - (p - pos)).clamp_max(cutoff) if cutoff > 1 else p
        elif cutoff > 1:
            pos = pos + _count_range(keys_pad, pos, pos + cutoff, cutoff,
                                     qq).long()
        return pos.clamp_max(n).to(torch.int32)

    return by_chunks(max(cutoff, win), run, q)


_NO_BINARY_STAGE = ("flat_binary needs the array's BinaryStage "
                    "(binary_stage: an index built on the card holds it) "
                    "for its n_pad and cutoff")
_NO_DESCENT_STAGE = ("flat_descent needs the index's DescentStage "
                     "(descent_stage: an index built on the card holds it) "
                     "for its level table")


def _check_binary(stage: BinaryStage, keys_pad: torch.Tensor, n_pad: int,
                  cutoff: int) -> None:
    if not isinstance(stage, BinaryStage) or stage.n_pad != n_pad \
            or stage.cutoff != cutoff or keys_pad.numel() != n_pad:
        raise ValueError(_NO_BINARY_STAGE)
    if stage.sample.device != keys_pad.device \
            or stage.sample.dtype != keys_pad.dtype:
        raise ValueError("the stage must lie on keys_pad's device in its "
                         "dtype")


def flat_binary(keys_pad: torch.Tensor, q: torch.Tensor, *, n_pad: int,
                cutoff: int, n: int, stage: BinaryStage) -> torch.Tensor:
    """searchsorted-left ranks [Q] (int32) over the power-of-two padded
    ``keys_pad`` of n keys: the lower bound in steps ``n_pad / 2`` down to
    ``cutoff``, then the ``cutoff``-key block counted, clamped to n.
    ``stage`` is the array's ``binary_stage``."""
    if q.device.type == "cpu":
        return flat_binary_plain(keys_pad, q, n_pad=n_pad, cutoff=cutoff,
                                 n=n, stage=stage)
    if not isinstance(stage, BinaryStage):
        raise ValueError(_NO_BINARY_STAGE)
    q = _device_args(q, keys_pad, stage.stage, stage.sample)
    if keys_pad.dtype != q.dtype:
        raise ValueError("keys_pad must be in the queries' dtype")
    _check_binary(stage, keys_pad, n_pad, cutoff)
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:
        return out
    err = _fn("flat_binary", q.dtype)(
        q.data_ptr(), q.shape[0], keys_pad.data_ptr(), n_pad,
        stage.stage.data_ptr(), stage.levels, stage.sample.data_ptr(),
        stage.sample.numel(), stage.top, stage.last, cutoff, n,
        out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flat_binary")
    flat_binary.launches += 1
    return out


flat_binary.launches = 0


def _check_descent(stage: DescentStage, d: Descent, nodes: torch.Tensor,
                   n: int, leaf: bool) -> None:
    if not isinstance(stage, DescentStage) or stage.table.size != 5 * d.depth \
            or stage.stage_rows > nodes.numel() // d.node_width:
        raise ValueError(_NO_DESCENT_STAGE)
    if leaf and stage.n != n:
        raise ValueError(f"the stage was built for n = {stage.n}, not {n}")
    if stage.sample.device != nodes.device \
            or stage.sample.dtype != nodes.dtype:
        raise ValueError("the stage must lie on the nodes' device in their "
                         "dtype")


def flat_descent_plain(q: torch.Tensor, nodes: torch.Tensor, d: Descent,
                       leaves: torch.Tensor | None = None,
                       leaf_width: int = 0, *, ending: str, n: int = 0,
                       stage: DescentStage) -> torch.Tensor:
    """Plain version: the kernel's per-query loop over the level table, in
    PyTorch (int32 index arithmetic, rows clamped as ``util.take`` clamps
    them): a node past its level's live nodes counts 0; the others, and
    the leaf block j while j * leaf_width < n (else the rank is n), are
    counted through their sample rows and one block (``intra="vector"``)
    or by one lane's lower bound (``"binary"``)."""
    leaf = ending == "leaf"
    _check_descent(stage, d, nodes, n, leaf)
    w, f, binary = d.node_width, d.fanout, d.intra == "binary"
    live, first = stage.live, stage.sample_row
    n_rows = nodes.numel() // w
    sw, lsw = stage.sample_width, stage.leaf_sample_width

    def run(qq):
        j = torch.zeros(qq.shape, dtype=torch.int32, device=qq.device)
        j_local, page = torch.zeros_like(j), torch.zeros_like(j)
        for lev in range(d.depth):
            if d.starts >> lev & 1:
                page = d.page_row[lev] + j * d.page_rows[lev]
                j_local = torch.zeros_like(j)
            r = (page + d.level_row[lev] + j_local).clamp(0, n_rows - 1)
            on = j < live[lev]
            if binary:
                c = _lower_bound(take_rows(nodes, w, r), qq)
            else:
                samp = (first[lev] + torch.where(on, j, 0).long()) * sw
                c = _row_count(nodes, r.long() * w, w, stage.sample, samp,
                               sw, qq)
            c = torch.where(on, c, 0)
            j, j_local = j * f + c, j_local * f + c
        if leaf:
            on = j.long() * leaf_width < n
            r = j.clamp(0, leaves.numel() // leaf_width - 1)
            if binary:
                c = _lower_bound(take_rows(leaves, leaf_width, r), qq)
            else:
                samp = stage.leaf_sample_at + torch.where(on, j, 0).long() \
                    * lsw
                c = _row_count(leaves, r.long() * leaf_width, leaf_width,
                               stage.sample, samp, lsw, qq)
            j = torch.where(on, j * leaf_width + c, n)
        return j

    rank = by_chunks(max(w, leaf_width), run, q)
    return rank if ending == "descent" else rank.clamp_max(n)


def flat_descent(q: torch.Tensor, nodes: torch.Tensor, d: Descent,
                 leaves: torch.Tensor | None = None, leaf_width: int = 0, *,
                 ending: str, n: int = 0,
                 stage: DescentStage) -> torch.Tensor:
    """The descent of ``d`` over ``nodes`` for each query, int32 [Q]. The
    ending: ``"rank"`` j clamped to n (k-ary), ``"leaf"`` j * leaf_width
    plus the keys below q in leaf block j of ``leaves``, clamped to n (css,
    FAST), ``"descent"`` j itself (FAST's ``leaf_page_of``). ``stage`` is
    the index's ``descent_stage``."""
    if ending not in ENDINGS:
        raise ValueError(f"unknown ending {ending!r}; want one of "
                         f"{tuple(ENDINGS)}")
    if q.device.type == "cpu":
        return flat_descent_plain(q, nodes, d, leaves, leaf_width,
                                  ending=ending, n=n, stage=stage)
    leaf = ending == "leaf"
    if leaf and (leaves is None or leaf_width < 1
                 or leaves.numel() < leaf_width):
        raise ValueError("a leaf count needs leaf blocks of leaf_width >= 1")
    if not isinstance(stage, DescentStage):
        raise ValueError(_NO_DESCENT_STAGE)
    q = _device_args(q, nodes, stage.sample, *([leaves] if leaf else []))
    if nodes.dtype != q.dtype or (leaf and leaves.dtype != q.dtype):
        raise TypeError(f"nodes and leaves must be {q.dtype}")
    if nodes.numel() % d.node_width or (d.depth and nodes.numel() == 0):
        raise ValueError("nodes must be whole rows of node_width keys")
    _check_descent(stage, d, nodes, n, leaf)
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:
        return out
    err = _fn("flat_descent", q.dtype)(
        q.data_ptr(), q.shape[0], nodes.data_ptr(),
        nodes.numel() // d.node_width, d.node_width, d.fanout, d.depth,
        stage.table.ctypes.data, d.starts, stage.stage_levels,
        stage.stage_rows, int(d.intra == "binary"),
        stage.sample.data_ptr(), stage.sample.numel(), stage.sample_width,
        leaves.data_ptr() if leaf else None,
        leaves.numel() // leaf_width if leaf else 0,
        leaf_width if leaf else 0, stage.leaf_sample_at,
        stage.leaf_sample_width, ENDINGS[ending], n, out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flat_descent")
    flat_descent.launches += 1
    mode = d.kind if ending != "descent" else f"{d.kind}_descent"
    flat_descent.mode_launches[mode] += 1
    return out


flat_descent.launches = 0
flat_descent.mode_launches = {"css": 0, "kary": 0, "fast": 0,
                              "fast_descent": 0}


@dataclass(frozen=True, eq=False)
class CSBStage:
    """What ``csb_search`` reads of one CSB+-tree snapshot beyond its
    arrays: the first ``levels`` inner levels, ``nodes`` nodes copied in
    breadth-first order from the root, in one 16-byte aligned buffer
    ``buf``: each staged node's key row, sentinel padded to ``stride`` keys
    (whole 16-byte pieces), then each one's int32 link. Below a staged node
    of an upper level the search goes to staged node ``link + c`` (c the
    row's keys below the query), below one of the last staged level to
    node id ``link + c`` of the snapshot: the link is the first copied
    child, or the node's child group. Every staged node is inner (its
    child id >= 0), and each one's children ``0 .. m`` are copied, m the
    keys of its row below the sentinel (no query counts more), so the
    search leaves the copy on the node the plain descent reaches."""
    buf: torch.Tensor
    levels: int
    nodes: int
    stride: int
    root: int
    height: int
    n_nodes: int
    dtype: torch.dtype

    @property
    def rows(self) -> torch.Tensor:
        """The staged key rows, [nodes, stride]."""
        if not self.nodes:
            return torch.empty((0, self.stride), dtype=self.dtype,
                               device=self.buf.device)
        n = self.nodes * self.stride * self.dtype.itemsize
        return self.buf[:n].view(self.dtype).view(self.nodes, self.stride)

    @property
    def link(self) -> torch.Tensor:
        """The staged nodes' links, int32 [nodes]."""
        if not self.nodes:
            return torch.empty(0, dtype=torch.int32, device=self.buf.device)
        at = self.nodes * self.stride * self.dtype.itemsize
        return self.buf[at:at + 4 * self.nodes].view(torch.int32)

    @property
    def nbytes(self) -> int:
        return self.buf.numel()


def csb_stage_bytes(nodes: int, stride_bytes: int) -> int:
    """Bytes of a stage of ``nodes`` rows of ``stride_bytes``: the rows,
    then the links padded to a whole 16-byte piece."""
    return nodes * stride_bytes + -(-4 * nodes // 16) * 16


def csb_stage(keys, child, root: int, height: int, *,
              device) -> CSBStage:
    """``csb_search``'s stage of a snapshot's host arrays ``keys`` [N, w]
    and ``child`` [N], on ``device``: the largest number of inner levels
    from the root whose nodes all have a child group and whose copy fits
    ``CSB_STAGE_BYTES``. Node ids are clamped as ``util.take`` clamps them,
    and a child id ``base + c`` is formed in int32, as the plain descent
    forms it."""
    keys, child = _host(keys), _host(child).astype(np.int64)
    if keys.ndim != 2 or keys.shape[0] < 1 or child.shape != keys.shape[:1]:
        raise ValueError("want keys [N, w] and child [N], N >= 1")
    n, w = keys.shape
    item = keys.dtype.itemsize
    v = 16 // item
    stride = -(-w // v) * v
    ids, levels, kids, total = np.clip([root], 0, n - 1), [], [], 0
    while len(levels) < height - 1:
        base = child[ids]
        if (base < 0).any() or csb_stage_bytes(
                total + ids.size, stride * item) > CSB_STAGE_BYTES:
            break
        levels.append(ids)
        total += ids.size
        # children 0 .. m of a node, m its keys below the sentinel
        kids.append((~dead(keys[ids])).sum(1) + 1)
        c = np.arange(kids[-1].sum()) - np.repeat(
            np.cumsum(kids[-1]) - kids[-1], kids[-1])
        ids = np.clip((np.repeat(base, kids[-1]) + c).astype(np.int32), 0,
                      n - 1)
    staged = np.concatenate(levels) if levels else np.zeros(0, np.int64)
    rows = np.full((total, stride), sentinel_for(keys.dtype), keys.dtype)
    rows[:, :w] = keys[staged]
    link, at = np.empty(total, np.int64), 0
    for lev, ids in enumerate(levels):
        if lev + 1 < len(levels):        # the first copied child's place
            link[at:at + ids.size] = at + ids.size + np.cumsum(kids[lev]) \
                - kids[lev]
        else:                            # past the copy: the child group
            link[at:at + ids.size] = child[ids]
        at += ids.size
    buf = np.zeros(csb_stage_bytes(total, stride * item), np.uint8)
    buf[:rows.nbytes] = rows.reshape(-1).view(np.uint8)
    buf[rows.nbytes:rows.nbytes + 4 * total] = link.astype(np.int32).view(
        np.uint8)
    return CSBStage(buf=upload_async(buf, torch.device(device)),
                    levels=len(levels), nodes=total, stride=stride,
                    root=int(root), height=int(height), n_nodes=n,
                    dtype=torch.from_numpy(keys[:0]).dtype)


_NO_CSB_STAGE = ("csb_search needs the snapshot's CSBStage (csb_stage: "
                 "CSBTree.snapshot builds it on the card) for its root, "
                 "height and node count")


def _check_csb(stage: CSBStage, keys: torch.Tensor, root: int,
               height: int) -> None:
    if not isinstance(stage, CSBStage) or stage.root != root \
            or stage.height != height or stage.n_nodes != keys.shape[0]:
        raise ValueError(_NO_CSB_STAGE)
    if stage.buf.device != keys.device or stage.dtype != keys.dtype \
            or stage.stride < keys.shape[1]:
        raise ValueError("the stage must lie on the keys' device, in their "
                         "dtype and width")


def csb_search_plain(q: torch.Tensor, keys: torch.Tensor,
                     child: torch.Tensor, leaf_keys: torch.Tensor, *,
                     root: int, height: int,
                     stage: CSBStage | None = None) -> torch.Tensor:
    """Plain version: the kernel's loop in PyTorch, over slices of the
    batch: from ``root``, ``height - 1`` steps to child ``child[node] + c``
    (c the node's keys below q), staying put where ``child`` is negative,
    then whether the leaf holds q. Rows are clamped as ``util.take``
    clamps them. With a ``stage``, the first ``stage.levels`` steps read
    it, as the kernel reads it: from staged node 0, the next one (or,
    past the last staged level, the node id) is ``link + c``."""
    levels = 0
    if stage is not None:
        _check_csb(stage, keys, root, height)
        levels, rows, link = stage.levels, stage.rows, stage.link

    def run(qq):
        nid = torch.full(qq.shape, root, dtype=torch.int32, device=qq.device)
        if levels:
            nid = torch.zeros_like(nid)
        for _ in range(levels):
            c = (rows[nid.long()] < qq[:, None]).sum(-1, dtype=torch.int32)
            nid = link[nid.long()] + c
        for _ in range(levels, height - 1):
            c = (take(keys, nid) < qq[:, None]).sum(-1, dtype=torch.int32)
            base = take(child, nid)
            nid = torch.where(base < 0, nid, base + c)
        return (take(leaf_keys, nid) == qq[:, None]).any(-1)

    return by_chunks(max(keys.shape[1], stage.stride if levels else 0), run,
                     q)


def csb_search(q: torch.Tensor, keys: torch.Tensor, child: torch.Tensor,
               leaf_keys: torch.Tensor, *, root: int, height: int,
               stage: CSBStage | None = None) -> torch.Tensor:
    """Membership of each query in a CSB+-tree's snapshot (``keys`` and
    ``leaf_keys`` [N, w], ``child`` int32 [N], -1 at a leaf): bool [Q].
    ``stage`` is the snapshot's ``csb_stage`` (the card needs it; on the
    CPU the plain version reads it when given). ``csb_search.staged``
    says whether the last launch staged it in shared memory (a persistent
    grid) or read it in place."""
    if q.device.type == "cpu":
        return csb_search_plain(q, keys, child, leaf_keys, root=root,
                                height=height, stage=stage)
    if not isinstance(stage, CSBStage):
        raise ValueError(_NO_CSB_STAGE)
    q = _device_args(q, keys, child, leaf_keys, stage.buf)
    if keys.dtype != q.dtype or leaf_keys.dtype != q.dtype \
            or child.dtype != torch.int32:
        raise TypeError(f"keys must be {q.dtype} and child int32")
    if keys.dim() != 2 or leaf_keys.shape != keys.shape \
            or child.shape != keys.shape[:1] or keys.shape[0] < 1:
        raise ValueError("want keys and leaf_keys [N, w], child [N], N >= 1")
    _check_csb(stage, keys, root, height)
    out = torch.empty(q.shape, dtype=torch.bool, device=q.device)
    if q.shape[0] == 0:
        return out
    staged = ctypes.c_int(0)
    err = _fn("csb_search", q.dtype)(
        q.data_ptr(), q.shape[0], keys.data_ptr(), child.data_ptr(),
        leaf_keys.data_ptr(), keys.shape[0], keys.shape[1], root, height,
        stage.buf.data_ptr(), stage.levels, stage.nodes, stage.stride,
        out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
        ctypes.byref(staged))
    _build.check(err, "csb_search")
    csb_search.launches += 1
    csb_search.staged = bool(staged.value)
    return out


csb_search.launches = 0
csb_search.staged = False
