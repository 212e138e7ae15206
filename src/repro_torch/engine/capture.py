"""Specialization (DESIGN.md §10): an index's pipeline bound to its data,
replayed as CUDA graphs on the card.

The reference compiles the built index into the program: it re-stages a
pipeline with the leaf pages closed over as constants and jits it, so a
dispatch takes the query batch alone (``repro/engine/tiered.py``,
``const_pages``). In PyTorch the construct that fixes data addresses,
shapes and the launch grid at build time is a CUDA graph, and this module
is the port's binding mechanism for it. It has no counterpart file in
``repro``.

:class:`Specialized` wraps ``fn(*args)``, a pipeline closed over an
index's device tensors (pages, aux arrays):

* **On the card** it keeps one ``torch.cuda.CUDAGraph`` per shapes and
  dtypes of the arguments. The first call at a shape copies the arguments
  into static buffers, runs ``fn`` once on a side stream (the lazy nvcc
  build, the launch helpers' caches and the allocator's growth happen
  there, never inside the capture), captures ``fn`` into the graph and
  replays it. Every call copies its arguments into the static buffers
  (device to device), replays, and returns fresh outputs: the graph's
  outputs are packed into one byte buffer inside the graph, which one
  clone copies out, so a later replay never changes an earlier result. A
  failure during capture raises; nothing falls back to eager there. An
  argument with no elements runs ``fn`` eagerly (a graph of no work).
* **On the CPU** (the caller asked for it, as the tests do) it is the
  closure itself: ``fn`` called with the arguments, no graph.

``operands=k`` marks the last k arguments as operands that change rarely
(the mutable store's delta tiers): one is copied into its graph's buffer
only when it is another tensor object than the one copied there last, so
its owner must replace such an operand when its contents change, never
write it in place. The leading arguments (the queries) are copied on
every call.

Every :class:`Specialized` adds to its index's :class:`Captures`: one for
each graph captured on the card, one when it is built on the CPU (the
closure armed). Kernel launches inside a replay are counted: the launch
counters that rose while a graph was captured (capture records, it runs
nothing) are set back, and raised by the same amounts at every replay.

Bound: at most ``MAX_GRAPHS`` graphs for one callable, the least recently
used evicted first. The graphs of one callable share one memory pool:
they replay one at a time on the caller's stream, and each graph's
buffers stay allocated while it lives, so the pool holds about the
largest graph's intermediates rather than their sum. The plan
construction (sort or histogram, ``engine/schedule.py``) is fixed at
capture, as the reference fixes it when it traces.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import torch

MAX_GRAPHS = 16          # graphs one specialized callable keeps
_ALIGN = 16              # byte alignment of each packed output


class Captures:
    """An index's count of specializations: graphs captured on the card,
    closures armed on the CPU."""

    def __init__(self):
        self.n = 0


def kernel_wrappers() -> list:
    """The kernel wrappers whose launch counters a replay raises: each
    one's ``launches`` and, where it has them, its ``mode_launches``."""
    from ..kernels import cdf_search, kary_search, page_scan, page_search
    return [page_search.page_search_bucketed,
            kary_search.kary_search_levels, page_scan.page_scan_bucketed,
            page_scan.page_prefix_bucketed, cdf_search.cdf_search]


def _counts(wrappers) -> list:
    return [(w.launches, dict(getattr(w, "mode_launches", {})))
            for w in wrappers]


def _launch_deltas(wrappers, before) -> tuple:
    """What the capture added to each counter, set back to ``before`` (a
    capture runs nothing): ((wrapper, n, {mode: n}), ...)."""
    out = []
    for w, (n0, modes0) in zip(wrappers, before):
        modes = getattr(w, "mode_launches", {})
        dm = {m: modes[m] - modes0.get(m, 0) for m in modes
              if modes[m] != modes0.get(m, 0)}
        if w.launches != n0 or dm:
            out.append((w, w.launches - n0, dm))
            w.launches = n0
            modes.update(modes0)
    return tuple(out)


class _Graph:
    """One captured graph: static inputs, the packed output buffer and how
    to cut it, and the kernel launches one replay makes."""

    def __init__(self, graph, inputs, packed, layout, single, launches):
        self.graph = graph
        self.inputs = inputs            # static argument buffers
        self.copied = [None] * len(inputs)   # operand last copied in
        self.packed = packed            # uint8 buffer of every output
        self.layout = layout            # (offset, nbytes, dtype, shape) | None
        self.single = single            # fn returned one tensor, not a tuple
        self.launches = launches        # (wrapper, n, {mode: n}) a replay


def _flat(out) -> tuple[tuple, bool]:
    if isinstance(out, torch.Tensor):
        return (out,), True
    if not isinstance(out, tuple):
        raise TypeError("a specialized function returns a tensor or a "
                        f"tuple of tensors and None, got {type(out)}")
    return out, False


def _pack(outs: tuple):
    """Inside the capture: one uint8 buffer holding every output tensor,
    each at a 16-byte aligned offset. Returns (buffer, layout)."""
    layout, off = [], 0
    for t in outs:
        if t is None:
            layout.append(None)
            continue
        nbytes = t.numel() * t.element_size()
        layout.append((off, nbytes, t.dtype, tuple(t.shape)))
        off += -(-nbytes // _ALIGN) * _ALIGN
    device = next(t.device for t in outs if t is not None)
    packed = torch.empty(max(off, _ALIGN), dtype=torch.uint8, device=device)
    for t, slot in zip(outs, layout):
        if slot is not None:
            _view(packed, slot).copy_(t)
    return packed, layout


def _view(buf: torch.Tensor, slot) -> torch.Tensor:
    off, nbytes, dtype, shape = slot
    return buf[off:off + nbytes].view(dtype).view(shape)


class Specialized:
    """``fn`` bound to its index's data: CUDA graphs on the card, the
    plain closure on the CPU (module docstring)."""

    def __init__(self, fn: Callable, *, device: torch.device,
                 captures: Captures, operands: int = 0):
        self.fn = fn
        self.device = torch.device(device)
        self.captures = captures
        self.operands = int(operands)
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self._pool = None
        self._lock = threading.Lock()
        if self.device.type != "cuda":
            captures.n += 1                  # the closure is armed

    def __call__(self, *args):
        if self.device.type != "cuda":
            return self.fn(*args)
        if any(a.numel() == 0 for a in args):
            return self.fn(*args)
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        with self._lock:
            g = self._graphs.get(key)
            if g is None:
                g = self._capture(key, args)
            else:
                self._graphs.move_to_end(key)
            first_operand = len(args) - self.operands
            for i, (dst, a) in enumerate(zip(g.inputs, args)):
                if i >= first_operand:
                    if g.copied[i] is a:
                        continue
                    g.copied[i] = a
                dst.copy_(a)
            g.graph.replay()
            for wrapper, n, modes in g.launches:
                wrapper.launches += n
                for m, k in modes.items():
                    wrapper.mode_launches[m] += k
            return self._unpack(g)

    def _unpack(self, g: _Graph):
        if g.single:
            return g.packed.clone()
        out = g.packed.clone()
        return tuple(None if slot is None else _view(out, slot)
                     for slot in g.layout)

    def _capture(self, key, args) -> _Graph:
        if len(self._graphs) >= MAX_GRAPHS:
            self._graphs.popitem(last=False)           # least recently used
        inputs = [torch.empty_like(a, memory_format=torch.contiguous_format)
                  for a in args]
        for dst, a in zip(inputs, args):
            dst.copy_(a)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.fn(*inputs)                         # warm-up, not captured
        cur.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        wrappers = kernel_wrappers()
        before = _counts(wrappers)
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads' runtime calls (a timer thread's
        # upload) neither break this capture nor are refused during it
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            outs, single = _flat(self.fn(*inputs))
            if single:
                packed, layout = outs[0], None
            else:
                packed, layout = _pack(outs)
        g = self._graphs[key] = _Graph(graph, inputs, packed, layout, single,
                                       _launch_deltas(wrappers, before))
        self.captures.n += 1
        return g

