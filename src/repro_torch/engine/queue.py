"""Cross-request micro-batch scheduler (DESIGN.md §7) with a multi-tenant
admission tier (§7.1), PyTorch port of ``repro/engine/queue.py``.

The batch-oriented structures in this repo only pay off when batches are
deep: the sort-and-bucket schedule's occupancy (DESIGN.md §2.1) collapses
at low per-request concurrency — a single request's handful of point
lookups launches a near-empty grid. This module is the scale lever in
front of the tiered engine: an **aggregation queue** that accumulates point
lookups across serving requests and feeds them to the sync-free lookup as
one deep batch.

Mechanics (the reference's, series and labels included):

* ``submit(queries, tenant=...)`` enqueues one caller's point lookups on
  its tenant's lane and returns a :class:`QueueFuture`; each future
  resolves to exactly its own results, in its own submitted order.
  Submissions may be nested tuples, lists, dicts, NamedTuples or
  dataclasses whose tensor / numpy leaves share a leading batch axis (the
  decode path submits ``(cdf, u)`` pairs — ``kernels.cdf_search.
  cdf_probe_fn``); results come back in the same form (a ``LookupResult``
  for an index probe), each leaf sliced to the caller's rows.
* A flush — ONE dispatch of ``search_fn`` — triggers on **capacity**
  (pending queries reach the adaptive ``flush_at`` threshold, or the hard
  ``capacity``), on **deadline** (the oldest pending submit has waited the
  *effective* window; a daemon timer guards callers that never block), or
  on **demand** (a caller blocks on ``result()``). What a flush admits is
  decided by the weighted-fair admission policy (``engine/admission.py``).
* **Adaptive deadline**: an EWMA arrival-rate estimate scales the flush
  window (``admission.effective_deadline``).
* **Occupancy feedback**: the executed plan's step count rides back out of
  the lookup (``engine/store.py``) as a thunk that waits on a CUDA event
  recorded behind a non-blocking copy of the count, never on the stream.
  Thunks resolve at the start of the *next* flush, so enqueueing a
  request never waits for the device; low occupancy raises ``flush_at``,
  occupancy at the target halves it back toward ``min_flush``.

Batches are joined where their submits live: numpy submits (the prefix
store's hash chains) are concatenated on the host, and the probe
(:func:`index_probe_fn`) uploads the batch once through page-locked
memory; tensor submits are joined with ``torch.cat`` on their device, with
the pad rows made there. No step of a flush reads a device value.

Locks: a flush holds the queue's lock while it calls ``search_fn``, and a
mutable store's lookup takes the store's lock inside it, so the order is
always queue, then store. Nothing here is called with a store's lock held,
so a timer-thread flush cannot deadlock against a thread-mode fold.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.util import tree_leaves, tree_map, upload_async
from ..obs import get_registry, span
from .admission import (AdmissionPolicy, QueueOverflow, RateEstimator,
                        TenantStats, effective_deadline)
from .schedule import _next_pow2, occupancy_shares

DEFAULT_TENANT = "default"


# ------------------------------------------------------- nested submissions
@dataclass(frozen=True)
class _LeafSpec:
    """Trailing shape, dtype and device of one submission leaf; a leaf
    with ``device`` None is a numpy array."""
    shape: tuple
    dtype: Any
    device: Any = None

    @classmethod
    def of(cls, leaf) -> "_LeafSpec":
        if isinstance(leaf, torch.Tensor):
            return cls(tuple(leaf.shape[1:]), leaf.dtype, leaf.device)
        return cls(tuple(leaf.shape[1:]), np.dtype(leaf.dtype))

    def zeros(self, rows: int):
        if self.device is None:
            return np.zeros((rows,) + self.shape, self.dtype)
        return torch.zeros((rows,) + self.shape, dtype=self.dtype,
                           device=self.device)


def _is_spec(x) -> bool:
    return isinstance(x, _LeafSpec)


def _leading_dim(queries) -> int:
    leaves = tree_leaves(queries)
    if not leaves:
        return 0
    n = int(leaves[0].shape[0])
    for leaf in leaves[1:]:
        if int(leaf.shape[0]) != n:
            raise ValueError("submission leaves must share a leading axis")
    return n


@dataclass
class QueueStats:
    """Counters + executed-plan occupancy aggregate (mean over flushes that
    reported feedback). ``flush_at`` mirrors the current adaptive
    threshold so callers can watch the steering; ``tenants`` carries the
    per-tenant ledger (admission.TenantStats)."""
    submits: int = 0
    queries: int = 0
    flushes: int = 0
    capacity_flushes: int = 0
    deadline_flushes: int = 0
    demand_flushes: int = 0
    manual_flushes: int = 0
    capped_flushes: int = 0       # flushes that left admissible work behind
    drops: int = 0                # submits rejected by a backlog limit
    max_batch: int = 0
    occ_sum: float = 0.0
    occ_n: int = 0
    flush_at: int = 0
    tenants: Dict[Any, TenantStats] = field(default_factory=dict)

    @property
    def mean_occupancy(self) -> float:
        return self.occ_sum / self.occ_n if self.occ_n else 0.0

    @property
    def mean_batch(self) -> float:
        return self.queries / self.flushes if self.flushes else 0.0

    def tenant(self, key) -> TenantStats:
        ts = self.tenants.get(key)
        if ts is None:
            ts = self.tenants[key] = TenantStats()
        return ts


class QueueFuture:
    """Result handle for one ``submit``. ``result()`` flushes the queue on
    demand if the batch has not gone out yet (so a lone synchronous caller
    pays one dispatch, not one deadline); under admission caps the demand
    loop keeps flushing until *this* caller's submit is admitted.

    Resolution stores the *shared* flush result plus this caller's slice
    bounds; the per-caller slice (a view on the device) is taken lazily on
    first ``result()``."""

    def __init__(self, queue: "MicroBatchQueue"):
        self._queue = queue
        self._event = threading.Event()
        self._raw: Any = None
        self._bounds: Optional[tuple] = None
        self._value: Any = None
        self._sliced = False
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until resolved WITHOUT demand-flushing — the passive twin
        of ``result()`` for callers (and tests) that want the queue's own
        triggers (deadline timer, other callers) to do the flushing."""
        return self._event.wait(timeout)

    def _resolve(self, shared_result: Any, lo: int, hi: int):
        self._raw = shared_result
        self._bounds = (lo, hi)
        self._event.set()

    def _reject(self, err: BaseException):
        self._error = err
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> Any:
        with span("queue.result", path=self._queue.path):
            return self._result(timeout)

    def _result(self, timeout: Optional[float]) -> Any:
        while not self._event.is_set():
            # demand-flush until OUR submit is admitted: a capped flush can
            # serve other tenants first, so one flush is not always enough
            if self._queue.flush(reason="demand") == 0 and \
                    not self._event.is_set():
                break                         # nothing pending anywhere
        if not self._event.wait(timeout):
            raise TimeoutError("micro-batch result not ready")
        if self._error is not None:
            raise self._error
        if not self._sliced:
            lo, hi = self._bounds
            self._value = tree_map(lambda leaf: leaf[lo:hi], self._raw)
            self._raw = None                  # drop the shared batch ref
            self._sliced = True
        return self._value


class MicroBatchQueue:
    """Deadline/capacity micro-batcher over a batched ``search_fn``, with
    per-tenant weighted-fair admission.

    ``search_fn(queries) -> (result, occupancy_thunk)`` — one dispatch over
    the whole batch; ``result`` is a tensor or a nest of tensors whose
    leaves have the batch as their leading axis (ranks, a LookupResult,
    ...); ``occupancy_thunk`` is a zero-arg callable yielding the executed
    plan's lane occupancy (or None when the engine has no feedback to
    give). ``MutableIndex.lookup`` + ``pop_plan_feedback`` is the
    canonical pairing — see :func:`index_probe_fn`; the decode-step twin
    is ``kernels.cdf_search.cdf_probe_fn``.

    ``flush_at`` (the adaptive capacity trigger) starts at ``min_flush``
    and is steered within [min_flush, capacity] by occupancy feedback;
    ``capacity`` is both the hard trigger and the flush budget the
    admission policy packs against. A single submit larger than capacity
    is legal — it flushes as one deep batch (admission never splits a
    caller). ``max_share`` caps any tenant's slice of one flush;
    ``set_weight`` steers the round-robin interleave. ``max_backlog`` (>0)
    rejects a tenant's submits once its pending backlog exceeds that many
    queries (``admission.QueueOverflow``). ``adaptive_deadline`` scales the
    flush window by the EWMA arrival rate (``deadline_floor_s`` bounds it
    below). ``now_fn``/``timer`` exist for deterministic tests.

    Flushed batches are padded to the next power of two (``pad_pow2``)
    with zero-queries whose lanes no caller slice ever reads, as in the
    reference, which re-traces its fused dispatch for each distinct size;
    here the pad keeps the flush shapes (and the grids they size) to
    O(log Q) distinct values.
    """

    def __init__(self, search_fn: Callable, *, capacity: int = 4096,
                 deadline_s: float = 0.002, min_flush: int = 64,
                 adapt: bool = True, occupancy_target: float = 0.5,
                 pad_pow2: bool = True, max_share: float = 1.0,
                 quantum: int = 32, max_backlog: int = 0,
                 adaptive_deadline: bool = False,
                 deadline_floor_s: float = 1e-4, rate_alpha: float = 0.3,
                 record_flushes: bool = False,
                 now_fn: Callable[[], float] = time.monotonic,
                 timer: bool = True, path: str = "probe"):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if deadline_s < 0:
            raise ValueError(f"deadline must be >= 0, got {deadline_s}")
        if max_backlog < 0:
            raise ValueError(f"max_backlog must be >= 0, got {max_backlog}")
        self._search_fn = search_fn
        self.path = str(path)       # registry/span label: "probe", "decode"
        self.capacity = int(capacity)
        self.pad_pow2 = bool(pad_pow2)
        self.deadline_s = float(deadline_s)
        self.deadline_floor_s = min(float(deadline_floor_s), self.deadline_s)
        self.adaptive_deadline = bool(adaptive_deadline)
        self.min_flush = max(1, min(int(min_flush), self.capacity))
        self.adapt = bool(adapt)
        self.occupancy_target = float(occupancy_target)
        self.flush_at = self.min_flush
        self.max_backlog = int(max_backlog)
        self.admission = AdmissionPolicy(self.capacity, max_share=max_share,
                                         quantum=quantum)
        self._rate = RateEstimator(alpha=rate_alpha)
        self._now = now_fn
        self._use_timer = bool(timer)
        self._lock = threading.RLock()
        # per-tenant FIFO lanes of (queries, q_n, future, t_enqueued)
        self._lanes: Dict[Any, deque] = {}
        self._pending_queries = 0
        self._oldest_t: Optional[float] = None
        self._timer: Optional[threading.Timer] = None
        self._closed = False
        # unresolved (occ_thunk, real, dispatched, tenant_counts)
        self._feedback: list = []
        # per-flush admission ledger (reason/counts/total) for the fairness
        # parity tests; None unless requested
        self.flush_log: Optional[list] = [] if record_flushes else None
        # leaf specs of the last non-empty submission, for the all-empty
        # flush (default: one int32 numpy leaf, as the reference's)
        self._spec: Any = _LeafSpec((), np.dtype(np.int32))
        self.stats = QueueStats(flush_at=self.flush_at)

    # ------------------------------------------------------------- tenants
    def set_tenant_weight(self, tenant, weight: float):
        """Live round-robin weight reconfiguration (default 1.0): under
        contention a weight-w tenant earns admission credit w times as
        fast. Taken under the queue lock — flushes hold the same lock, so
        the rescaled deficit can never be observed mid-``plan()``."""
        with self._lock:
            self.admission.set_weight(tenant, weight)

    # legacy spelling
    set_weight = set_tenant_weight

    def set_max_share(self, max_share: float):
        """Live per-flush share-cap reconfiguration: carried deficits are
        re-clamped under the queue lock, so a tightened cap binds from
        the very next flush."""
        with self._lock:
            self.admission.set_max_share(max_share)

    def effective_deadline(self) -> float:
        """The flush window currently in force: ``deadline_s`` scaled by
        the EWMA arrival rate when ``adaptive_deadline`` is on."""
        if not self.adaptive_deadline:
            return self.deadline_s
        need = min(self.flush_at, self.capacity) - self._pending_queries
        return effective_deadline(self.deadline_s, self.deadline_floor_s,
                                  self._rate.rate, need)

    # ------------------------------------------------------------- enqueue
    def submit(self, queries, tenant=DEFAULT_TENANT) -> QueueFuture:
        """Enqueue one caller's point lookups on ``tenant``'s lane; returns
        a future for exactly those results in the caller's order. May flush
        inline (capacity trigger). Never blocks on the device: feedback
        resolution happens at the next flush, not here."""
        if not isinstance(queries, (torch.Tensor, np.ndarray, tuple, list,
                                    dict)):
            queries = np.asarray(queries)
        q_n = _leading_dim(queries)
        fut = QueueFuture(self)
        reg = get_registry()
        with span("queue.submit", path=self.path, tenant=tenant, n=q_n), \
                self._lock:
            if self._closed:
                raise RuntimeError("submit on a closed MicroBatchQueue")
            ts = self.stats.tenant(tenant)
            lane = self._lanes.get(tenant)
            if lane is None:
                lane = self._lanes[tenant] = deque()
            if self.max_backlog and q_n and \
                    self._lane_queries(lane) + q_n > self.max_backlog:
                ts.drops += 1
                self.stats.drops += 1
                reg.counter("queue_drops", path=self.path,
                            tenant=str(tenant)).inc()
                fut._reject(QueueOverflow(
                    f"tenant {tenant!r} backlog over {self.max_backlog} "
                    f"queries"))
                return fut
            now = self._now()
            if q_n:
                self._spec = tree_map(_LeafSpec.of, queries)
                self._rate.observe(now, q_n)
            lane.append((queries, q_n, fut, now))
            self._pending_queries += q_n
            if self._oldest_t is None:
                self._oldest_t = now
            self.stats.submits += 1
            self.stats.queries += q_n
            ts.submits += 1
            ts.queries += q_n
            reg.counter("queue_submits", path=self.path,
                        tenant=str(tenant)).inc()
            reg.counter("queue_queries", path=self.path,
                        tenant=str(tenant)).inc(q_n)
            if self._pending_queries >= min(self.flush_at, self.capacity):
                # admission packs at most `capacity` per flush; keep going
                # until the backlog is back under the trigger
                while self._pending_queries >= min(self.flush_at,
                                                   self.capacity):
                    if self._flush_locked("capacity") == 0:
                        break
            elif self._use_timer and self._timer is None:
                self._arm_timer(self.effective_deadline())
        return fut

    def submit_many(self, submissions) -> list:
        """``submit`` each ``(queries, tenant)`` pair, holding the queue's
        lock across them: one arrival that no deadline flush can split (a
        capacity flush still may). The futures, in order."""
        with self._lock:
            return [self.submit(q, tenant=t) for q, t in submissions]

    @staticmethod
    def _lane_queries(lane) -> int:
        return sum(n for _, n, _, _ in lane)

    # -------------------------------------------------------------- flush
    def flush(self, reason: str = "manual") -> int:
        """Dispatch one admitted batch as ONE ``search_fn`` call; returns
        the number of queries dispatched (0 when nothing was pending).
        Under admission caps a flush may leave work behind — it re-arms
        the deadline timer for the leftovers."""
        with self._lock:
            return self._flush_locked(reason)

    def drain(self) -> int:
        """Flush until nothing is pending (close/shutdown helper);
        returns total queries dispatched."""
        total = 0
        with self._lock:
            while self._pending_queries or any(self._lanes.values()):
                n = self._flush_locked("manual")
                total += n
                if n == 0 and not any(self._lanes.values()):
                    break
        return total

    def _flush_locked(self, reason: str) -> int:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not any(self._lanes.values()):
            return 0
        with span("queue.flush", path=self.path, reason=reason):
            return self._flush_admitted(reason)

    def _flush_admitted(self, reason: str) -> int:
        reg = get_registry()
        # resolve the previous flush's occupancy feedback now: its dispatch
        # was issued a flush ago, so its event has usually completed, and
        # draining here never stalls an enqueueing caller
        self.drain_feedback()
        with span("queue.admit", path=self.path):
            admit = self.admission.plan(
                {t: [n for _, n, _, _ in lane]
                 for t, lane in self._lanes.items() if lane})
        now = self._now()
        batch = []                          # (queries, q_n, fut, tenant)
        for t in admit.service:
            queries, q_n, fut, t_enq = self._lanes[t].popleft()
            batch.append((queries, q_n, fut, t))
            ts = self.stats.tenant(t)
            ts.admitted += q_n
            wait = max(now - t_enq, 0.0)
            ts.wait_s += wait
            ts.wait_max_s = max(ts.wait_max_s, wait)
            reg.counter("queue_admitted", path=self.path,
                        tenant=str(t)).inc(q_n)
            reg.histogram("queue_wait_seconds", path=self.path,
                          tenant=str(t)).observe(wait)
        if not batch:
            return 0
        total = admit.total
        self._pending_queries -= total
        leftovers = False
        for t, lane in self._lanes.items():
            if lane:
                leftovers = True
                self.stats.tenant(t).deferred += len(lane)
                reg.counter("queue_deferred", path=self.path,
                            tenant=str(t)).inc(len(lane))
        self._oldest_t = min(
            (lane[0][3] for lane in self._lanes.values() if lane),
            default=None)
        self.stats.flushes += 1
        if leftovers:
            self.stats.capped_flushes += 1
        self.stats.max_batch = max(self.stats.max_batch, total)
        served = {b[3] for b in batch}
        for t, n in admit.counts.items():
            if n or t in served:
                self.stats.tenant(t).flushes += 1
                reg.counter("queue_tenant_flushes", path=self.path,
                            tenant=str(t)).inc()
        if self.flush_log is not None:
            subs: Dict[Any, int] = {}
            for t in admit.service:
                subs[t] = subs.get(t, 0) + 1
            self.flush_log.append({"reason": reason,
                                   "counts": dict(admit.counts),
                                   "submits": subs, "total": total})
        counter = f"{reason}_flushes"
        if not hasattr(self.stats, counter):   # free-text reason: file under
            counter = "manual_flushes"         # manual instead of raising
        setattr(self.stats, counter, getattr(self.stats, counter) + 1)
        reg.counter("queue_flushes", path=self.path, reason=reason).inc()
        reg.histogram("queue_batch_size", path=self.path).observe(total)
        reg.gauge("queue_flush_at", path=self.path).set(self.flush_at)
        try:
            parts = [q for q, n, _, _ in batch if n]
            pad = (_next_pow2(total) - total) if (self.pad_pow2 and total) \
                else 0
            q = self._concat(parts, pad)
            # dispatch-boundary timer: the host cost of issuing the
            # search (it returns without waiting on the device), so
            # observing it adds no sync
            with span("queue.dispatch", path=self.path, n=total, pad=pad):
                t0 = time.perf_counter()
                result, occ_thunk = self._search_fn(q)
                reg.histogram("engine_op_seconds", path=self.path).observe(
                    time.perf_counter() - t0)
                reg.counter("engine_ops", path=self.path).inc()
            if occ_thunk is not None:
                # the engine saw the padded batch; scale its occupancy back
                # to real queries so pad lanes never flatter the steering
                self._feedback.append((occ_thunk, total, total + pad,
                                       dict(admit.counts)))
            lo = 0
            for _, n, fut, _ in batch:
                hi = lo + n
                fut._resolve(result, lo, hi)
                lo = hi
        except BaseException as e:            # noqa: BLE001 — futures must not hang
            for _, _, fut, _ in batch:
                fut._reject(e)
            raise
        finally:
            if leftovers and self._use_timer and not self._closed \
                    and self._timer is None:
                age = self._now() - (self._oldest_t or self._now())
                self._arm_timer(self.effective_deadline() - age)
        return total

    def _concat(self, parts: list, pad: int):
        """Join submissions (nests of one structure) leaf-wise along the
        batch axis, appending ``pad`` zero rows: numpy leaves on the host,
        tensor leaves with ``torch.cat`` on their device (numpy parts of a
        mixed leaf uploaded without a sync); an all-empty flush builds
        zero-length leaves from the recorded spec."""
        if not parts:
            return tree_map(lambda s: s.zeros(0), self._spec,
                            is_leaf=_is_spec)

        def cat(*leaves):
            arrs = list(leaves)
            dev = next((a.device for a in arrs
                        if isinstance(a, torch.Tensor)), None)
            if pad:                           # pad rows where the batch is
                arrs.append(_LeafSpec.of(arrs[0]).zeros(pad) if dev is None
                            else torch.zeros((pad,) + tuple(arrs[0].shape[1:]),
                                             dtype=arrs[0].dtype, device=dev))
            if len(arrs) == 1:
                return arrs[0]
            if dev is None:
                return np.concatenate(arrs)
            return torch.cat([a if isinstance(a, torch.Tensor)
                              else upload_async(a, dev) for a in arrs])

        return tree_map(cat, *parts)

    # ----------------------------------------------------------- deadline
    def _arm_timer(self, delay: Optional[float] = None):
        timer_box = []
        timer = threading.Timer(max(delay if delay is not None
                                    else self.deadline_s, 1e-4),
                                lambda: self._on_deadline(timer_box[0]))
        timer_box.append(timer)
        timer.daemon = True
        self._timer = timer
        timer.start()

    def _on_deadline(self, me: threading.Timer):
        with self._lock:
            if self._closed or self._timer is not me:
                return                        # closed, or cancelled and
            self._timer = None                # superseded: a newer timer
            if not any(self._lanes.values()):  # owns the batch
                return
            window = self.effective_deadline()
            age = self._now() - (self._oldest_t or 0.0)
            if age + 1e-6 >= window:
                self._flush_locked("deadline")
            else:                             # raced a fresh batch: re-arm
                self._arm_timer(window - age)

    def poll(self) -> int:
        """Timer-free deadline check (manual drivers and tests): flush iff
        the oldest pending submit has aged past the effective window."""
        with self._lock:
            if any(self._lanes.values()) and \
                    self._now() - self._oldest_t >= self.effective_deadline():
                return self._flush_locked("deadline")
        return 0

    # ----------------------------------------------------------- feedback
    def drain_feedback(self):
        """Resolve executed-plan occupancy thunks (each waits on the event
        of an earlier lookup — called at the next flush, from stats
        readers, or explicitly; never from submit) and steer ``flush_at``:
        shallow buckets -> wait deeper; target met -> decay back toward
        min_flush. Occupancy is scaled to *real* queries so the pow2 pad
        lanes never flatter the signal, and attributed to the flush's
        tenants by lane share for the per-tenant ledger."""
        with self._lock:
            pending, self._feedback = self._feedback, []
        reg = get_registry()
        for thunk, real, dispatched, counts in pending:
            occ = float(thunk()) * (real / dispatched if dispatched else 0.0)
            self.stats.occ_sum += occ
            self.stats.occ_n += 1
            reg.histogram("queue_flush_occupancy",
                          path=self.path).observe(occ)
            for t, share in occupancy_shares(counts, occ).items():
                ts = self.stats.tenant(t)
                ts.occ_sum += share
                ts.occ_n += 1
                reg.histogram("queue_occupancy", path=self.path,
                              tenant=str(t)).observe(share)
            if not self.adapt:
                continue
            if occ < self.occupancy_target:
                self.flush_at = min(self.flush_at * 2, self.capacity)
            else:
                self.flush_at = max(self.flush_at // 2, self.min_flush)
        self.stats.flush_at = self.flush_at

    # -------------------------------------------------------------- admin
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self):
        """Drain leftovers and cancel the deadline timer. Idempotent, and
        safe against a timer firing concurrently: the close flag is set
        under the lock before the final drain, so a racing timer callback
        (which re-checks the flag and its own identity under the same
        lock) can never flush into a shut-down queue; submits after close
        raise instead of landing on a dead lane."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            while any(self._lanes.values()):
                if self._flush_locked("manual") == 0:
                    break                     # defensive: cannot starve
        self.drain_feedback()


@dataclass
class TenantRow:
    """One (path, tenant) line of the serving dashboard, rendered from the
    metrics registry — the single source the per-tenant printout and
    ``EngineStats.tenants`` both read."""
    path: str
    tenant: str
    submits: int = 0
    queries: int = 0
    flushes: int = 0
    admitted: int = 0
    deferred: int = 0
    drops: int = 0
    wait_mean_us: float = 0.0
    wait_max_us: float = 0.0
    occupancy: float = 0.0


def tenant_summary(registry=None) -> list:
    """Render every (path, tenant) series in the registry as
    :class:`TenantRow` views, sorted by (path, tenant): wait moments come
    from the ``queue_wait_seconds`` histogram, occupancy from
    ``queue_occupancy``, counts from the queue counter families."""
    reg = registry if registry is not None else get_registry()
    keys = set()
    for name in ("queue_submits", "queue_queries", "queue_drops"):
        for labels, _ in reg.series(name):
            if "path" in labels and "tenant" in labels:
                keys.add((labels["path"], labels["tenant"]))
    rows = []
    for path, tenant in sorted(keys):
        def count(name):
            m = reg.value(name, path=path, tenant=tenant)
            return int(m.value) if m is not None else 0

        wait = reg.value("queue_wait_seconds", path=path, tenant=tenant)
        occ = reg.value("queue_occupancy", path=path, tenant=tenant)
        rows.append(TenantRow(
            path=path, tenant=tenant,
            submits=count("queue_submits"),
            queries=count("queue_queries"),
            flushes=count("queue_tenant_flushes"),
            admitted=count("queue_admitted"),
            deferred=count("queue_deferred"),
            drops=count("queue_drops"),
            wait_mean_us=wait.mean * 1e6 if wait is not None else 0.0,
            wait_max_us=(wait.max * 1e6
                         if wait is not None and wait.count else 0.0),
            occupancy=occ.mean if occ is not None else 0.0))
    return rows


def index_probe_fn(index) -> Callable:
    """Adapt an index into the queue's ``search_fn`` contract: one
    ``lookup`` returning (LookupResult, occupancy_thunk). Works with
    ``engine.store.MutableIndex`` (full feedback via ``pop_plan_feedback``)
    and any ``core.api.Index`` (no feedback). A numpy batch (joined on the
    host) is uploaded once, through page-locked memory, without a sync."""
    pop = getattr(index, "pop_plan_feedback", None)
    device = getattr(index, "device", None)
    if device is None:
        device = index.keys_sorted.device

    def probe(q):
        if isinstance(q, np.ndarray):
            q = upload_async(q, device)
        res = index.lookup(q)
        return res, (pop() if pop is not None else None)

    return probe
