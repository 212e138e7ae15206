"""Host-side tracing spans with Chrome/Perfetto export (DESIGN.md §9.2),
PyTorch port of ``repro/obs/trace.py``.

``with span("queue.flush", tenant="t0"):`` records one complete ("X")
``trace_event`` into a fixed-capacity ring buffer: wall-clock ``ts`` and
``dur`` in microseconds, the recording thread's id as ``tid`` (so nested
spans on one thread render as a flame graph by timestamp containment),
and any keyword labels as ``args``. ``Tracer.export()`` writes the
``{"traceEvents": [...]}`` JSON that chrome://tracing and ui.perfetto.dev
load directly (``launch/serve.py --trace-out``).

Disabled is the default posture and it must cost ~nothing: ``span()``
then returns a shared no-op context manager after one attribute check —
no allocation, no clock read. When enabled, a span also enters
``torch.profiler.record_function`` and, with a CUDA card, an NVTX range,
so device profiles carry the same names as the host timeline. Eager torch
pays for both on every call (the reference's ``jax.named_scope`` costs
nothing at run time), so they are entered only while the tracer is
enabled; :func:`annotate` is that device-profile marker alone, for the
stages inside one dispatch (``tiered/page_kernel``, ``scan/span_plan``,
...). Recording never touches device values: the ring buffer holds only
host floats and strings, so no instrumentation point can add a sync.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

DEFAULT_CAPACITY = 65536


class _NullSpan:
    """Shared do-nothing context manager handed out while disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()
_nvtx_ok: Optional[bool] = None        # decided at the first annotation


def _nvtx_enabled() -> bool:
    """Whether NVTX ranges can be pushed here: a CUDA card and a torch
    built with NVTX. Decided once, at the first enabled annotation."""
    global _nvtx_ok
    if _nvtx_ok is None:
        _nvtx_ok = False
        if torch.cuda.is_available():
            try:
                torch.cuda.nvtx.range_push("repro_torch")
                torch.cuda.nvtx.range_pop()
                _nvtx_ok = True
            except RuntimeError:       # a build without NVTX: profiler only
                pass
    return _nvtx_ok


class _Annotation:
    """A device-profile range: ``record_function`` plus, on the card, an
    NVTX range of the same name."""
    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._nvtx = _nvtx_enabled()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False


class _Span:
    """One live span: records an "X" event on exit."""
    __slots__ = ("_tracer", "name", "args", "_t0", "_annot")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._annot = _Annotation(self.name).__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        self._annot.__exit__(*exc)
        self._tracer._record(self.name, self._t0, dur, self.args)
        return False


class Tracer:
    """Ring-buffered trace-event recorder.

    Events are stored newest-wins in a circular list so a long serving
    run keeps the most recent ``capacity`` spans; ``events()`` returns
    them in chronological order.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._ring: List[Optional[dict]] = []
        self._head = 0
        self._dropped = 0
        self.enabled = False
        self._epoch = time.perf_counter()

    # ------------------------------------------------------------- control
    def enable(self, capacity: Optional[int] = None):
        with self._lock:
            if capacity is not None and capacity != self._capacity:
                self._capacity = int(capacity)
                self._ring = []
                self._head = 0
            self.enabled = True

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._ring = []
            self._head = 0
            self._dropped = 0
            self._epoch = time.perf_counter()

    # ----------------------------------------------------------- recording
    def span(self, name: str, **args):
        """Context manager timing a span. Near-free when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args):
        """Record a zero-duration instant event (scope: thread)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        ev = {
            "name": name, "ph": "i", "s": "t",
            "ts": (now - self._epoch) * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        self._push(ev)

    def _record(self, name: str, t0: float, dur: float,
                args: Dict[str, Any]):
        ev = {
            "name": name, "ph": "X",
            "ts": (t0 - self._epoch) * 1e6,
            "dur": dur * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        self._push(ev)

    def _push(self, ev: dict):
        with self._lock:
            if len(self._ring) < self._capacity:
                self._ring.append(ev)
            else:
                self._ring[self._head] = ev
                self._head = (self._head + 1) % self._capacity
                self._dropped += 1

    # ------------------------------------------------------------- reading
    def events(self) -> List[dict]:
        """Recorded events, oldest first."""
        with self._lock:
            out = self._ring[self._head:] + self._ring[:self._head]
        return sorted(out, key=lambda e: e["ts"])

    @property
    def dropped(self) -> int:
        return self._dropped

    def export(self, path: Optional[str] = None) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON; written to ``path`` when
        given, returned either way."""
        doc = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self._dropped},
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


TRACER = Tracer()


def span(name: str, **args):
    """Module-level shorthand for ``TRACER.span`` — the one-attribute-check
    fast path every hot instrumentation point uses."""
    if not TRACER.enabled:
        return _NULL_SPAN
    return _Span(TRACER, name, args)


def annotate(name: str):
    """A device-profile range (``record_function``, and NVTX on the card)
    without a host trace event, entered only while the tracer is enabled:
    the stages inside one dispatch, where the reference has
    ``jax.named_scope``."""
    if not TRACER.enabled:
        return _NULL_SPAN
    return _Annotation(name)


def instant(name: str, **args):
    TRACER.instant(name, **args)
