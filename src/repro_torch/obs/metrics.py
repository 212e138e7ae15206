"""Process-wide metrics registry (DESIGN.md §9.1), PyTorch port of
``repro/obs/metrics.py``: the same series, bucketing and Prometheus text,
byte for byte, for the same updates.

Counters, gauges and **log-bucketed latency histograms** keyed by
``(name, labels)``. Histogram buckets are powers of √2 (``le_k = 2^(k/2)``),
which gives ~10 buckets per decade at a fixed relative error of ≤ √2 per
quantile read — cheap enough to observe on every fused dispatch, and two
histograms with the same bucketing merge exactly (bucket-wise addition),
so per-queue / per-tenant series aggregate without raw samples.

Exposition:

* ``Registry.snapshot()`` — plain JSON-able dict (``chip_smoke.py``
  prints from it).
* ``Registry.prometheus_text()`` — Prometheus text format v0.0.4
  (counters as ``<ns>_<name>_total``, histograms as cumulative
  ``_bucket{le=...}`` + ``_sum`` + ``_count``), served over HTTP by
  ``start_http_server`` (``launch/serve.py --metrics-port``).

The module-level *active* registry is what instrumented code reaches via
``get_registry()``; swapping in ``NULL_REGISTRY`` turns every update into
a no-op (the "off" leg of ``chip_smoke.py``'s overhead check), and ``use_registry`` scopes
a fresh registry for tests. Nothing here touches torch: updates are pure
host-side Python and can never add a device sync.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

# Bucket index k covers (2^((k-1)/2), 2^(k/2)]. The clamp range spans
# ~0.001us (1e-9 s) to 2^64 (counts/batch sizes), beyond which
# observations saturate into the edge buckets.
BUCKET_MIN = -60
BUCKET_MAX = 128


def bucket_index(v: float) -> int:
    """Smallest k with ``v <= 2^(k/2)`` (clamped); non-positive values
    land in the lowest bucket."""
    if v <= 0.0 or v != v:                       # <=0 and NaN: floor bucket
        return BUCKET_MIN
    k = math.ceil(2.0 * math.log2(v))
    # float-rounding discipline at exact boundaries: enforce the invariant
    # 2^((k-1)/2) < v <= 2^(k/2) with at most one step either way
    if 2.0 ** (k / 2.0) < v:
        k += 1
    elif k > BUCKET_MIN and 2.0 ** ((k - 1) / 2.0) >= v:
        k -= 1
    return max(min(k, BUCKET_MAX), BUCKET_MIN)


def bucket_upper(k: int) -> float:
    """Inclusive upper bound of bucket k."""
    return 2.0 ** (k / 2.0)


class Counter:
    """Monotone counter (int or float increments)."""
    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Point-in-time value (last write wins)."""
    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = float(v)

    def inc(self, n=1):
        self.value += n


class Histogram:
    """Log-bucketed (√2) histogram: mergeable, with p50/p99 quantile reads
    and exact count/sum/min/max sidecars."""
    kind = "histogram"
    __slots__ = ("_lock", "buckets", "count", "sum", "min", "max")

    def __init__(self):
        self._lock = threading.Lock()
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v):
        v = float(v)
        k = bucket_index(v)
        with self._lock:
            self.buckets[k] = self.buckets.get(k, 0) + 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @contextmanager
    def time(self):
        """Observe the elapsed wall time of a with-block (seconds)."""
        import time as _time
        t0 = _time.perf_counter()
        try:
            yield
        finally:
            self.observe(_time.perf_counter() - t0)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold another histogram into this one (exact: same bucketing)."""
        with other._lock:
            ob = dict(other.buckets)
            oc, os_, omn, omx = other.count, other.sum, other.min, other.max
        with self._lock:
            for k, n in ob.items():
                self.buckets[k] = self.buckets.get(k, 0) + n
            self.count += oc
            self.sum += os_
            self.min = min(self.min, omn)
            self.max = max(self.max, omx)
        return self

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile observation
        (conservative: true quantile is within a factor of √2 below).
        0.0 when empty."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return 0.0
            target = max(1, math.ceil(q * self.count))
            cum = 0
            for k in sorted(self.buckets):
                cum += self.buckets[k]
                if cum >= target:
                    return bucket_upper(k)
        return bucket_upper(BUCKET_MAX)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _label_key(name: str, labels: dict) -> LabelKey:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


class Registry:
    """Named, labeled metric series. One metric *name* has one kind (a
    counter registered as a histogram elsewhere raises); each distinct
    label set is its own series object, created on first touch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, Any] = {}
        self._kinds: Dict[str, type] = {}
        self._help: Dict[str, str] = {}

    def _get(self, cls, name: str, help_: str, labels: dict):
        key = _label_key(name, labels)
        m = self._series.get(key)
        if m is not None:
            if type(m) is not cls:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, not {cls.kind}")
            return m
        with self._lock:
            m = self._series.get(key)
            if m is None:
                kind = self._kinds.get(name)
                if kind is not None and kind is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{kind.kind}, not {cls.kind}")
                self._kinds[name] = cls
                if help_:
                    self._help[name] = help_
                m = self._series[key] = cls()
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return self._get(Histogram, name, help, labels)

    def series(self, name: str) -> Iterator[Tuple[dict, Any]]:
        """(labels_dict, metric) pairs of one metric name."""
        with self._lock:
            items = list(self._series.items())
        for (n, lk), m in items:
            if n == name:
                yield dict(lk), m

    def value(self, name: str, **labels) -> Optional[Any]:
        """The series object at exactly these labels, or None."""
        return self._series.get(_label_key(name, labels))

    def total(self, name: str, **match) -> float:
        """Sum of a counter/gauge family over every series whose labels
        include ``match`` (partial-label aggregation for views)."""
        out = 0.0
        for labels, m in self.series(name):
            if all(labels.get(k) == str(v) for k, v in match.items()):
                out += m.value
        return out

    def merged_histogram(self, name: str, **match) -> Histogram:
        """A fresh histogram holding the merge of every matching series —
        the mergeability contract in action."""
        h = Histogram()
        for labels, m in self.series(name):
            if all(labels.get(k) == str(v) for k, v in match.items()):
                h.merge(m)
        return h

    def snapshot(self) -> dict:
        """JSON-able view: {name: [{"labels": {...}, ...}]} with counters
        and gauges carrying ``value`` and histograms carrying count / sum /
        min / max / p50 / p99 + sparse ``buckets`` (upper-bound keyed)."""
        with self._lock:
            items = list(self._series.items())
        out: Dict[str, List[dict]] = {}
        for (name, lk), m in sorted(items, key=lambda kv: kv[0]):
            row: Dict[str, Any] = {"labels": dict(lk)}
            if isinstance(m, Histogram):
                with m._lock:
                    row.update(
                        count=m.count, sum=m.sum,
                        min=m.min if m.count else 0.0,
                        max=m.max if m.count else 0.0,
                        buckets={f"{bucket_upper(k):.6g}": n
                                 for k, n in sorted(m.buckets.items())})
                row["p50"] = m.quantile(0.5)
                row["p99"] = m.quantile(0.99)
            else:
                row["value"] = m.value
            out.setdefault(name, []).append(row)
        return out

    # ----------------------------------------------------------- exposition
    def prometheus_text(self, namespace: str = "repro") -> str:
        """Prometheus text exposition v0.0.4. Counters gain the ``_total``
        suffix; histograms expose cumulative ``_bucket{le=...}`` series
        plus ``_sum``/``_count``, ending at ``le="+Inf"``."""
        with self._lock:
            items = sorted(self._series.items(), key=lambda kv: kv[0])
            kinds = dict(self._kinds)
            helps = dict(self._help)
        lines: List[str] = []
        seen_type = set()
        for (name, lk), m in items:
            full = f"{namespace}_{name}" if namespace else name
            if name not in seen_type:
                seen_type.add(name)
                if name in helps:
                    lines.append(f"# HELP {full} {helps[name]}")
                lines.append(f"# TYPE {full} {kinds[name].kind}")
            base = dict(lk)
            if isinstance(m, Counter):
                lines.append(f"{full}_total{_fmt_labels(base)} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"{full}{_fmt_labels(base)} {m.value}")
            else:
                with m._lock:
                    buckets = sorted(m.buckets.items())
                    count, total = m.count, m.sum
                cum = 0
                for k, n in buckets:
                    cum += n
                    lab = dict(base, le=f"{bucket_upper(k):.6g}")
                    lines.append(f"{full}_bucket{_fmt_labels(lab)} {cum}")
                lab = dict(base, le="+Inf")
                lines.append(f"{full}_bucket{_fmt_labels(lab)} {count}")
                lines.append(f"{full}_sum{_fmt_labels(base)} {total}")
                lines.append(f"{full}_count{_fmt_labels(base)} {count}")
        return "\n".join(lines) + "\n"

    def reset(self):
        with self._lock:
            self._series.clear()
            self._kinds.clear()
            self._help.clear()


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def parse_prometheus(text: str) -> Dict[Tuple[str, str], float]:
    """Minimal exposition parser: {(metric_name, label_block): value}.
    Used by the serve launcher's scrape self-test and the round-trip unit
    test — not a general Prometheus client."""
    out: Dict[Tuple[str, str], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if not head:
            continue
        if "{" in head:
            name, _, rest = head.partition("{")
            labels = "{" + rest
        else:
            name, labels = head, ""
        try:
            out[(name, labels)] = float(val)
        except ValueError:
            continue
    return out


# ----------------------------------------------------------- null sink
class _NullMetric:
    """Absorbs every update; returned for all kinds by NULL_REGISTRY."""
    __slots__ = ()

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    @contextmanager
    def time(self):
        yield


_NULL_METRIC = _NullMetric()


class _NullRegistry:
    """The metrics off-switch: every accessor hands back the shared no-op
    metric, snapshots are empty. Swapped in by
    ``obs.configure(metrics=False)`` for an overhead check's baseline
    leg."""

    def counter(self, name, help="", **labels):
        return _NULL_METRIC

    gauge = counter
    histogram = counter

    def series(self, name):
        return iter(())

    def value(self, name, **labels):
        return None

    def total(self, name, **match):
        return 0.0

    def merged_histogram(self, name, **match):
        return Histogram()

    def snapshot(self):
        return {}

    def prometheus_text(self, namespace="repro"):
        return ""

    def reset(self):
        pass


REGISTRY = Registry()                 # the process-wide default
NULL_REGISTRY = _NullRegistry()
_active: Any = REGISTRY


def get_registry():
    """The active registry — what every instrumentation point reads, live
    (so configure()/use_registry() swaps take effect immediately)."""
    return _active


def set_registry(reg) -> Any:
    """Swap the active registry; returns the previous one."""
    global _active
    prev, _active = _active, reg
    return prev


def metrics_enabled() -> bool:
    return _active is not NULL_REGISTRY


@contextmanager
def use_registry(reg: Optional[Registry] = None):
    """Scope a registry (default: a fresh one) as the active registry —
    the test-isolation idiom."""
    reg = reg if reg is not None else Registry()
    prev = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(prev)


# ----------------------------------------------------------- HTTP server
def start_http_server(port: int = 0, registry=None,
                      addr: str = "127.0.0.1"):
    """Serve ``prometheus_text`` at ``/metrics`` (and ``/``) on a daemon
    thread. ``port=0`` binds an ephemeral port. Returns
    ``(server, bound_port)``; ``server.shutdown()`` stops it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path not in ("/", "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            reg = registry if registry is not None else get_registry()
            body = reg.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):          # no request spam on stderr
            pass

    srv = ThreadingHTTPServer((addr, int(port)), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="repro-metrics")
    t.start()
    return srv, srv.server_address[1]
