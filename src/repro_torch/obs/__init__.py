"""Unified observability subsystem (DESIGN.md §9), PyTorch port of
``repro/obs``.

Three pieces, all host-side and sync-free by construction:

* ``obs.metrics`` — a process-wide registry of named counters, gauges and
  log-bucketed (power-of-√2) latency histograms with labeled series
  (path / tenant / kind), snapshot-able and exportable as Prometheus text
  exposition (``start_http_server``, bound to 127.0.0.1).
* ``obs.trace`` — host-side tracing spans (``with span("queue.flush")``)
  recorded into a ring buffer and exportable as Chrome/Perfetto
  ``trace_event`` JSON; enabled spans also enter
  ``torch.profiler.record_function`` (and NVTX ranges on the card) so
  device profiles line up with the host timeline.
* Device-side attribution of the stages inside one dispatch rides on
  ``trace.annotate`` ranges (engine/tiered.py, engine/scan.py,
  engine/groupby.py), entered only while the tracer is enabled.

The hard rule every instrumentation point obeys: **never add a host
sync**. Timers wrap dispatch boundaries (the host cost of issuing the
kernels), occupancy and step counts ride the lazy feedback thunks, and
nothing in this package reads a device value.
"""
import time as _time
from contextlib import contextmanager as _contextmanager

from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, Registry, REGISTRY, NULL_REGISTRY,
    get_registry, set_registry, use_registry, metrics_enabled,
    start_http_server, parse_prometheus)
from .trace import TRACER, Tracer, annotate, span  # noqa: F401


def configure(*, metrics: bool = True, trace: bool = False,
              trace_capacity: int | None = None):
    """One-call switchboard: route metric updates to the process registry
    (or the null sink) and enable/disable span recording. The off posture
    is the baseline an overhead measurement compares against."""
    set_registry(REGISTRY if metrics else NULL_REGISTRY)
    if trace:
        TRACER.enable(capacity=trace_capacity)
    else:
        TRACER.disable()


@_contextmanager
def timed_op(name: str, path: str, **labels):
    """The span ``name`` around a dispatch boundary, then one
    ``engine_op_seconds`` observation and one ``engine_ops`` count at
    ``path`` (nothing is recorded when the block raises), as the
    reference's instrumentation points write them inline."""
    with span(name, **labels):
        t0 = _time.perf_counter()
        yield
        reg = get_registry()
        reg.histogram("engine_op_seconds", path=path).observe(
            _time.perf_counter() - t0)
        reg.counter("engine_ops", path=path).inc()


def snapshot() -> dict:
    """The active registry's snapshot."""
    return get_registry().snapshot()
