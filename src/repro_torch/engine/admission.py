"""Multi-tenant admission control for the micro-batch queue (DESIGN.md §7.1),
PyTorch port of ``repro/engine/admission.py``: pure Python, its arithmetic
copied unchanged, so both packages admit the same submits in the same
order with the same carried deficits.

The micro-batch queue (engine/queue.py) turns many shallow callers into one
deep fused dispatch — but a FIFO flush hands the whole dispatch to whoever
submitted first, so one bursty tenant can starve everyone else out of the
deep-dispatch capacity the engine exists to exploit. This module is the
admission layer in front of the flush:

* :class:`AdmissionPolicy` — weighted deficit-round-robin selection of whole
  submits into a flush, with a **hard cap** on any tenant's share of the
  flush (hog-proof) and a work-conserving guarantee: a flush goes out below
  capacity only when every pending tenant is either drained, at its cap, or
  would not fit the remaining budget. Submits are never split — a caller's
  queries stay one contiguous slice of one flush (the queue's per-caller
  future contract).
* :class:`RateEstimator` — EWMA arrival-rate (queries/sec) over the submit
  stream, driven by the queue's injected clock so virtual-clock tests and
  benchmarks stay deterministic.
* :func:`effective_deadline` — the adaptive flush window: scale the
  configured deadline by the fraction of the needed batch depth the
  estimated rate can actually deliver within it, so light traffic stops
  paying the full window for a batch that cannot deepen.

All three are pure/deterministic given their inputs — the parity suite
(tests/test_torch_queue.py) drives them and the reference's with the same
interleaved traces, independent of the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Mapping, Sequence

Tenant = Hashable


class QueueOverflow(RuntimeError):
    """A tenant's backlog limit rejected a submit (the drop path)."""


@dataclass
class TenantStats:
    """Per-tenant counters surfaced through ``QueueStats.tenants`` and
    folded into ``serve.EngineStats``."""
    submits: int = 0
    queries: int = 0
    flushes: int = 0          # flushes this tenant had queries admitted in
    admitted: int = 0         # queries admitted across all flushes
    deferred: int = 0         # submit-deferral events (left pending by a
                              # capped/over-budget flush; one submit can
                              # defer across several flushes)
    drops: int = 0            # submits rejected by the backlog limit
    wait_s: float = 0.0       # total in-queue wait of admitted submits
    wait_max_s: float = 0.0
    occ_sum: float = 0.0      # executed-occupancy share attributed (see
    occ_n: int = 0            # schedule.occupancy_shares)

    @property
    def mean_wait_s(self) -> float:
        return self.wait_s / self.submits if self.submits else 0.0

    @property
    def mean_occ_share(self) -> float:
        return self.occ_sum / self.occ_n if self.occ_n else 0.0


@dataclass
class FlushAdmit:
    """One flush's admission decision.

    service: tenant key per admitted submit, in service order — the queue
             pops that tenant's oldest pending submit for each entry, so
             within-tenant FIFO (and hence per-caller request order) is
             preserved by construction.
    counts:  admitted query count per tenant (the flush-share ledger the
             cap invariant is checked against).
    total:   total admitted queries.
    """
    service: List[Tenant] = field(default_factory=list)
    counts: Dict[Tenant, int] = field(default_factory=dict)
    total: int = 0


class AdmissionPolicy:
    """Weighted deficit-round-robin admission with a per-flush share cap.

    ``plan(pending)`` selects whole submits from per-tenant FIFO lanes into
    one flush of at most ``capacity`` queries. Invariants (property-tested):

    * **cap** — a tenant's admitted queries never exceed
      ``cap_queries = ceil(max_share * capacity)`` unless a *single* submit
      alone does (submits are never split; the first non-empty submit of a
      tenant is always admissible so oversized callers make progress).
    * **budget** — the flush never exceeds ``capacity`` unless a single
      submit alone does (the existing oversized-submit contract).
    * **work-conserving** — when the flush closes below capacity, every
      tenant with pending submits was stopped by its cap or by the
      remaining budget, never skipped: deficit shortage only *defers within
      the round-robin*, and rounds continue until no tenant is eligible.
    * **FIFO per tenant** — admitted submits are each lane's prefix.

    Weights steer the interleaving (a weight-2 tenant earns credit twice as
    fast, so under contention it lands ~2x the queries before the budget
    runs out); the cap is the hard hog-proof guarantee on top. Deficits
    persist across flushes (standard DRR memory) but are clamped to the cap
    so a long-capped tenant cannot hoard credit.
    """

    def __init__(self, capacity: int, *, max_share: float = 1.0,
                 quantum: int = 32, default_weight: float = 1.0):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if not (0.0 < max_share <= 1.0):
            raise ValueError(
                f"max_share must be in (0, 1], got {max_share}")
        if default_weight <= 0:
            raise ValueError(
                f"default_weight must be positive, got {default_weight}")
        self.capacity = int(capacity)
        self.max_share = float(max_share)
        self.quantum = max(int(quantum), 1)
        self.default_weight = float(default_weight)
        self._weights: Dict[Tenant, float] = {}
        self._deficit: Dict[Tenant, float] = {}
        self._order: List[Tenant] = []      # rotation order, first-seen
        self._cursor = 0

    @property
    def cap_queries(self) -> int:
        """Hard per-flush share cap in queries (at least 1)."""
        return max(1, math.ceil(self.max_share * self.capacity))

    def weight(self, tenant: Tenant) -> float:
        return self._weights.get(tenant, self.default_weight)

    def set_weight(self, tenant: Tenant, weight: float):
        """Live weight reconfiguration. The tenant's carried DRR deficit
        is rescaled by the weight ratio so accumulated credit keeps its
        *rounds-of-service* meaning (credit earned at weight w and spent
        at weight 2w would otherwise be worth half the service it was
        granted for), then re-clamped to the share cap."""
        if weight <= 0:
            raise ValueError(f"weight must be positive, got {weight}")
        old = self.weight(tenant)
        self._weights[tenant] = float(weight)
        if tenant in self._deficit:
            self._deficit[tenant] = min(
                self._deficit[tenant] * (float(weight) / old),
                float(self.cap_queries))

    def set_max_share(self, max_share: float):
        """Live share-cap reconfiguration: every carried deficit is
        re-clamped to the new cap immediately, so a cap reduction takes
        full effect on the very next ``plan()`` (no tenant spends credit
        hoarded under the old, looser cap)."""
        if not (0.0 < max_share <= 1.0):
            raise ValueError(
                f"max_share must be in (0, 1], got {max_share}")
        self.max_share = float(max_share)
        cap = float(self.cap_queries)
        for t in self._deficit:
            self._deficit[t] = min(self._deficit[t], cap)

    def _rotation(self, pending: Mapping[Tenant, Sequence[int]]
                  ) -> List[Tenant]:
        for t in pending:
            if t not in self._deficit:
                self._deficit[t] = 0.0
                self._order.append(t)
        if not self._order:
            return []
        k = self._cursor % len(self._order)
        rot = self._order[k:] + self._order[:k]
        return [t for t in rot if len(pending.get(t, ())) > 0]

    def plan(self, pending: Mapping[Tenant, Sequence[int]]) -> FlushAdmit:
        """Admission decision over per-tenant FIFO submit sizes.

        ``pending[t]`` is tenant t's queue of submit sizes, oldest first.
        Returns the service order + per-tenant admitted query counts; the
        caller pops each lane's head submit per service entry.
        """
        order = self._rotation(pending)
        out = FlushAdmit(counts={t: 0 for t in order})
        if not order:
            return out
        cap = self.cap_queries
        taken = {t: 0 for t in order}
        active = dict.fromkeys(order)       # insertion-ordered set
        total = 0
        while active and total < self.capacity:
            for t in list(active):
                # one round of credit; a tenant that runs out of deficit
                # stays active and earns more next round (work conservation)
                self._deficit[t] += self.quantum * self.weight(t)
                lane = pending[t]
                while taken[t] < len(lane):
                    size = int(lane[taken[t]])
                    if out.counts[t] and out.counts[t] + size > cap:
                        active.pop(t, None)          # hard cap
                        break
                    if total and total + size > self.capacity:
                        active.pop(t, None)          # flush budget
                        break
                    if out.counts[t] and size > self._deficit[t]:
                        break                        # out of round credit
                    out.counts[t] += size
                    taken[t] += 1
                    total += size
                    self._deficit[t] -= size
                    out.service.append(t)
                else:
                    active.pop(t, None)              # lane drained
                    self._deficit[t] = 0.0           # DRR: no credit hoard
                if total >= self.capacity:
                    active.clear()
        out.total = total
        for t in order:                              # bound capped tenants'
            self._deficit[t] = min(self._deficit[t], float(cap))  # credit
        if order:
            # round-robin: the next flush starts past this flush's first
            # tenant, so positional bias never compounds
            self._cursor = (self._order.index(order[0]) + 1) \
                % len(self._order)
        return out


class RateEstimator:
    """EWMA arrival-rate estimate (queries/sec) over a submit stream.

    Driven by the queue's injected clock (``now_fn``) so virtual-clock
    tests see deterministic rates. Same-instant bursts accumulate and are
    attributed to the next non-zero inter-arrival gap; until two distinct
    timestamps have been seen the rate is 0.0 ("no estimate" — the
    adaptive deadline then pays the full window)."""

    def __init__(self, alpha: float = 0.3):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.rate = 0.0
        self._last: Any = None
        self._acc = 0.0

    def observe(self, now: float, n: int) -> float:
        if self._last is None:
            self._last, self._acc = now, float(n)
            return self.rate
        dt = now - self._last
        if dt <= 0.0:
            self._acc += n
            return self.rate
        inst = self._acc / dt
        self.rate = inst if self.rate == 0.0 else \
            self.rate + self.alpha * (inst - self.rate)
        self._last, self._acc = now, float(n)
        return self.rate


def effective_deadline(deadline_s: float, floor_s: float, rate: float,
                       need: int) -> float:
    """Adaptive flush window (DESIGN.md §7.1).

    The configured window ``deadline_s`` only buys latency worth paying if
    arrivals can deepen the batch within it. ``rate * deadline_s`` is the
    expected new queries over the full window; scaling the window by
    ``min(1, rate * deadline_s / need)`` (``need`` = queries still missing
    from the flush threshold) waits exactly the pro-rated fraction the
    estimated traffic can fill — light traffic collapses the window toward
    ``floor_s``, heavy traffic keeps the full window (and capacity-flushes
    long before it anyway). ``rate <= 0`` means no estimate yet: pay the
    full window rather than guess."""
    if need <= 0:
        return max(floor_s, 0.0)        # threshold met: flush asap
    if rate <= 0.0:
        return deadline_s
    frac = min(1.0, (rate * deadline_s) / need)
    return min(max(floor_s, deadline_s * frac), deadline_s)
