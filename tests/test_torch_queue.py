"""The port's micro-batch queue and admission tier
(``repro_torch/engine/queue.py``, ``engine/admission.py``) and the decode
queue (``kernels/cdf_search.cdf_probe_fn``, ``serve/sampler.sample_queued``)
against the reference's.

* **admission** — the same pending lanes through both packages'
  ``AdmissionPolicy``: the same ``FlushAdmit`` (service order, counts,
  total) and the same carried deficits and rotation after every plan;
  ``RateEstimator`` and ``effective_deadline`` give equal floats.
* **queue traces** — the cases of ``tests/test_queue_property.py`` and
  ``tests/test_admission_property.py`` run as traces through both
  packages' queues over the same mutable store (the reference's running
  its kernels in interpret mode, the port's on ``device="cpu"``), on one
  manual clock: equal per-caller results (also equal to the port's direct
  ``lookup``), ``flush_log``, ``QueueStats`` with the per-tenant
  ``TenantStats``, and ``flush_at`` trajectory, step by step.
* **decode queue** — the cases of ``tests/test_decode_batching.py``: the
  port's ``cdf_probe_fn`` queue against the reference's ``invert_cdf``,
  its padded wrapper and its Pallas kernel in interpret mode on
  adversarial CDFs, and ``sample_queued`` equal to ``sample`` for the same
  generator, with and without tenants.

Exact everywhere: the counts and the manual-clock floats come from the
same Python arithmetic. Tests that start a real timer thread bound every
wait they make."""
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.core import IndexConfig as RefIndexConfig
from repro.core import build_index as ref_build_index
from repro.engine import admission as ref_adm
from repro.engine import queue as ref_queue
from repro.kernels import cdf_search as ref_cdf
from repro.kernels import ops as ref_ops

from repro_torch.core import IndexConfig, build_index
from repro_torch.engine import admission as pt_adm
from repro_torch.engine import queue as pt_queue
from repro_torch.engine import schedule
from repro_torch.kernels import cdf_search as pt_cdf
from repro_torch.serve import sampler as pt_sampler
from repro_torch.serve.sampler import SamplerConfig

torch.set_num_threads(1)

N_KEYS = 4096


# ------------------------------------------------------------- admission
def plan_log(policy, pending) -> tuple:
    """One plan and the policy state it leaves behind."""
    a = policy.plan(pending)
    return (list(a.service), dict(a.counts), a.total, dict(policy._deficit),
            list(policy._order), policy._cursor)


def policy_trace(adm, seed: int) -> list:
    """The reference property suite's policy trace (random capacity,
    share, quantum, weights; rounds of arrivals and flushes, then a drain)
    on ``adm``'s AdmissionPolicy; returns every plan's log."""
    rng = np.random.default_rng(seed)
    capacity = int(rng.integers(8, 256))
    policy = adm.AdmissionPolicy(capacity,
                                 max_share=float(rng.uniform(0.1, 1.0)),
                                 quantum=int(rng.integers(1, 64)))
    tenants = [f"t{i}" for i in range(int(rng.integers(1, 6)))]
    for t in tenants:
        if rng.random() < 0.5:
            policy.set_weight(t, float(rng.uniform(0.25, 4.0)))
    lanes = {t: [] for t in tenants}
    log = []

    def one_flush():
        pending = {t: list(lane) for t, lane in lanes.items() if lane}
        if not pending:
            return False
        log.append(plan_log(policy, pending))
        for t in log[-1][0]:
            lanes[t] = lanes[t][1:]
        return True

    for r in range(int(rng.integers(3, 12))):
        for t in tenants:
            for _ in range(int(rng.integers(0, 4))):
                lanes[t].append(int(rng.choice(
                    [0, 1, int(rng.integers(1, 16)),
                     int(rng.integers(1, capacity + 40))])))
        if r % 3 == 2:                     # live reconfiguration mid-trace
            policy.set_max_share(float(rng.uniform(0.1, 1.0)))
            policy.set_weight(tenants[0], float(rng.uniform(0.25, 4.0)))
        one_flush()
    for _ in range(10_000):
        if not one_flush():
            break
    assert not any(lanes.values())
    return log


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_admission_policy_traces_match_reference(seed):
    assert policy_trace(pt_adm, seed) == policy_trace(ref_adm, seed)


def scenario_log(adm, name: str) -> list:
    """The reference suite's fairness and live-reconfiguration units, as
    plan logs of ``adm``'s policy."""
    P = adm.AdmissionPolicy
    if name == "cap_blocks_hog":
        p = P(100, max_share=0.25)
        return [plan_log(p, {"hog": [20] * 4, "a": [5], "b": [5]})]
    if name == "weights_steer":
        p = P(64, quantum=8)
        p.set_weight("heavy", 2.0)
        return [plan_log(p, {"heavy": [1] * 100, "light": [1] * 100})]
    if name == "oversized_first":
        p = P(32, max_share=0.5)
        log = [plan_log(p, {"big": [80]})]
        lanes = {"big": [80], "small": [4] * 8}
        while any(lanes.values()):
            log.append(plan_log(p, {t: v for t, v in lanes.items() if v}))
            for t in log[-1][0]:
                lanes[t] = lanes[t][1:]
        return log
    if name == "rotation":
        p = P(8, quantum=8)
        return [plan_log(p, {"a": [4, 4], "b": [4, 4], "c": [4, 4]})
                for _ in range(4)]
    if name == "live_weight":
        p = P(64, quantum=8)
        log = [plan_log(p, {"a": [1] * 100, "b": [1] * 100})]
        p.set_weight("a", 3.0)
        log.append(dict(p._deficit))
        return log + [plan_log(p, {"a": [1] * 200, "b": [1] * 200})]
    assert name == "live_max_share"
    p = P(100, max_share=1.0, quantum=64)
    log = [plan_log(p, {"hog": [20] * 3, "a": [5]})]
    p.set_max_share(0.25)
    return log + [plan_log(p, {"hog": [20] * 4, "a": [5], "b": [5]})]


@pytest.mark.parametrize("name", ["cap_blocks_hog", "weights_steer",
                                  "oversized_first", "rotation",
                                  "live_weight", "live_max_share"])
def test_admission_scenarios_match_reference(name):
    """The same logs, and the reference suite's claims hold on the
    port's."""
    log = scenario_log(pt_adm, name)
    assert log == scenario_log(ref_adm, name)
    service, counts, total = log[0][:3]
    if name in ("cap_blocks_hog", "live_max_share"):
        # the (tightened) cap binds the hog at once; light tenants land
        capped = log[-1][1]
        assert capped["hog"] <= 25 and capped["a"] == capped["b"] == 5
        assert all(d <= 25.0 for d in log[-1][3].values())
    if name == "weights_steer":
        assert total == 64 and counts["heavy"] > counts["light"]
    if name == "live_weight":
        # carried credit rescaled by the weight ratio, capped; the new
        # weight steers the next contended flush
        assert log[1]["a"] == min(log[0][3]["a"] * 3.0, 64.0)
        assert log[2][1]["a"] > log[2][1]["b"]
    if name == "oversized_first":
        assert counts == {"big": 80} and total == 80
    if name == "rotation":
        assert len({entry[0][0] for entry in log}) > 1


def test_live_reconfiguration_rejects_bad_values():
    for adm in (pt_adm, ref_adm):
        p = adm.AdmissionPolicy(64)
        with pytest.raises(ValueError):
            p.set_weight("a", 0.0)
        for bad in (0.0, 1.5, -0.1):
            with pytest.raises(ValueError):
                p.set_max_share(bad)
        with pytest.raises(ValueError):
            adm.RateEstimator(alpha=0.0)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.sampled_from([0.0, 0.0, 1e-4, 0.003, 0.02,
                                           1.5]),
                          st.integers(0, 300)), min_size=1, max_size=40),
       st.floats(0.05, 1.0))
def test_rate_and_deadline_match_reference(arrivals, alpha):
    """EWMA rates over the same arrival stream (same-instant bursts
    included), and the effective window for each, as equal floats."""
    est = [ref_adm.RateEstimator(alpha=alpha),
           pt_adm.RateEstimator(alpha=alpha)]
    now = 0.0
    for dt, n in arrivals:
        now += dt
        rates = [e.observe(now, n) for e in est]
        assert rates[0] == rates[1]
        for need in (0, 1, n, 4096):
            args = (0.002, 1e-4, rates[0], need)
            assert ref_adm.effective_deadline(*args) == \
                pt_adm.effective_deadline(*args)


# ---------------------------------------------------------- queue traces
@pytest.fixture(scope="module")
def stores():
    """The reference suite's store (4,096 keys in [0, 2^30), values 5 * i,
    folded into a paged base) in both packages."""
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 2**30, int(N_KEYS * 1.2)
                                  ).astype(np.int32))[:N_KEYS]
    vals = np.arange(keys.size, dtype=np.int32) * 5
    ref = ref_build_index(keys, vals, RefIndexConfig(kind="tiered",
                                                     mutable=True))
    port = build_index(keys, vals, IndexConfig(kind="tiered", mutable=True),
                       device="cpu")
    ref.flush()
    port.flush()
    return keys, vals, ref, port


def asdict(stats) -> dict:
    return dataclasses.asdict(stats)


class Pair:
    """One queue in each package over the same store and one manual clock,
    driven in lockstep; ``check`` holds the port's ledger to the
    reference's."""

    def __init__(self, stores, **kw):
        self.keys, self.vals, self.ref_idx, self.pt_idx = stores
        self.clock = {"now": 0.0}
        kw.setdefault("timer", False)
        kw.setdefault("record_flushes", True)
        now = lambda: self.clock["now"]             # noqa: E731
        self.ref = ref_queue.MicroBatchQueue(
            ref_queue.index_probe_fn(self.ref_idx), now_fn=now, **kw)
        self.pt = pt_queue.MicroBatchQueue(
            pt_queue.index_probe_fn(self.pt_idx), now_fn=now, **kw)
        self.subs = []                    # (queries, ref future, port future)
        self.flush_at = [self.pt.flush_at]

    def submit(self, qs, tenant="default"):
        self.subs.append((qs, self.ref.submit(qs, tenant=tenant),
                          self.pt.submit(qs, tenant=tenant)))
        self.check()
        return self.subs[-1][2]

    def both(self, name, *args, **kw):
        got = [getattr(q, name)(*args, **kw) for q in (self.ref, self.pt)]
        assert got[0] == got[1], (name, got)
        self.check()
        return got[1]

    def result(self, i):
        qs, rf, pf = self.subs[i]
        want, got = rf.result(), pf.result()
        self.check()
        for name in ("rank", "found", "values"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        direct = self.pt_idx.lookup(qs)
        for name in ("rank", "found", "values"):
            assert torch.equal(getattr(got, name), getattr(direct, name))
        return got

    def check(self):
        r, p = self.ref, self.pt
        assert asdict(p.stats) == asdict(r.stats)
        assert p.flush_at == r.flush_at and p.flush_log == r.flush_log
        assert p._pending_queries == r._pending_queries
        assert [f.done() for _, f, _ in self.subs] == \
            [f.done() for _, _, f in self.subs]
        if p.flush_at != self.flush_at[-1]:
            self.flush_at.append(p.flush_at)


def queue_trace(stores, seed: int):
    """The reference suite's end-to-end trace (submits on random tenants,
    virtual time passing with polls, callers blocking) through both
    queues."""
    keys = stores[0]
    rng = np.random.default_rng(seed)
    capacity = int(rng.choice([32, 64, 128]))
    pair = Pair(stores, capacity=capacity,
                min_flush=int(rng.integers(1, capacity + 1)),
                deadline_s=0.01,
                max_share=float(rng.choice([0.25, 0.5, 1.0])),
                adapt=bool(rng.integers(0, 2)),
                adaptive_deadline=bool(rng.integers(0, 2)))
    tenants = [f"t{i}" for i in range(int(rng.integers(1, 5)))]
    for _ in range(int(rng.integers(4, 30))):
        ev = rng.random()
        if ev < 0.7:
            k = int(rng.choice([0, 1, 3, 8, 21]))
            qs = np.concatenate([
                keys[rng.integers(0, keys.size, k)],
                rng.integers(0, 2**30, int(rng.integers(0, 3))
                             ).astype(np.int32)])
            pair.submit(qs, tenants[int(rng.integers(0, len(tenants)))])
        elif ev < 0.9:
            pair.clock["now"] += float(rng.uniform(0.001, 0.02))
            pair.both("poll")
        elif pair.subs:
            pair.result(int(rng.integers(0, len(pair.subs))))
    pair.both("close")
    for i in range(len(pair.subs)):
        pair.result(i)
    total = sum(e["total"] for e in pair.pt.flush_log)
    assert total == sum(len(qs) for qs, _, _ in pair.subs)
    return pair


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_queue_multi_tenant_traces_match_reference(stores, seed):
    queue_trace(stores, seed)


def test_queue_results_equal_unqueued_search_in_request_order(stores):
    keys = stores[0]
    rng = np.random.default_rng(1)
    pair = Pair(stores, capacity=1024, min_flush=1024)
    for _ in range(7):
        pair.submit(np.concatenate([keys[rng.integers(0, keys.size, 5)],
                                    rng.integers(0, 2**30, 3
                                                 ).astype(np.int32)]))
    assert pair.pt.stats.flushes == 0
    pair.result(0)                                  # demand-flush the lot
    assert pair.pt.stats.flushes == 1
    for i in range(7):
        pair.result(i)
    assert pair.pt.stats.flushes == pair.pt.stats.demand_flushes == 1


def test_queue_capacity_and_deadline_triggers(stores):
    keys = stores[0]
    pair = Pair(stores, capacity=64, min_flush=16, adapt=False)
    f1 = pair.submit(keys[:10])
    assert not f1.done()
    pair.submit(keys[10:26])                        # 26 >= 16: flush
    assert f1.done() and pair.pt.stats.capacity_flushes == 1
    pair = Pair(stores, capacity=1024, min_flush=1024, deadline_s=0.5)
    f = pair.submit(keys[:4])
    for now, want in ((0.0, 0), (0.499, 0), (0.5, 4)):
        pair.clock["now"] = now
        assert pair.both("poll") == want
    assert f.done() and pair.pt.stats.deadline_flushes == 1


def test_queue_close_is_idempotent_and_races_the_timer(stores):
    """close drains and is idempotent, late submits raise; a deadline
    callback captured before close and run after it flushes nothing."""
    keys = stores[0]
    pair = Pair(stores, capacity=1024, min_flush=1024, deadline_s=0.5,
                timer=True)
    pair.submit(keys[:4])
    timers = [q._timer for q in (pair.ref, pair.pt)]
    assert all(t is not None for t in timers)
    pair.both("close")
    pair.both("close")
    assert pair.pt.stats.flushes == 1 and pair.pt.closed
    pair.clock["now"] = 10.0
    for t in timers:
        t.function()                                # the racing callback
    pair.check()
    assert pair.both("poll") == 0
    for q in (pair.ref, pair.pt):
        with pytest.raises(RuntimeError, match="closed"):
            q.submit(keys[:4])


def test_queue_deadline_timer_thread_and_close_race(stores):
    """The port's real timer flushes a caller that never blocks; a timer
    short enough to fire mid-close never flushes after close returns.
    Every wait is bounded."""
    keys, vals, _, port = stores
    q = pt_queue.MicroBatchQueue(pt_queue.index_probe_fn(port),
                                 capacity=1024, min_flush=1024,
                                 deadline_s=0.05)
    f = q.submit(keys[:4])
    assert f.wait(30.0), "deadline timer never flushed"
    assert q.stats.deadline_flushes == 1
    np.testing.assert_array_equal(f.result(timeout=10).values.numpy(),
                                  vals[:4])
    q.close()
    for trial in range(8):
        q = pt_queue.MicroBatchQueue(pt_queue.index_probe_fn(port),
                                     capacity=1024, min_flush=1024,
                                     deadline_s=0.001)
        f = q.submit(keys[:4])
        q.close()
        assert f.done(), f"trial {trial}: close lost a pending submit"
        flushes = q.stats.flushes
        assert f.wait(0.1)
        assert q.stats.flushes == flushes, f"trial {trial}: late flush"


def test_queue_empty_and_oversized_submissions(stores):
    keys = stores[0]
    pair = Pair(stores, capacity=32, min_flush=32)
    f_empty = pair.submit(np.zeros(0, np.int32))
    f_big = pair.submit(keys[:300])                 # one deep flush, unsplit
    assert f_big.done() and f_empty.done()
    assert pair.pt.stats.flushes == 1 and pair.pt.stats.max_batch == 300
    pair.result(1)
    assert pair.result(0).found.shape == (0,)
    f2 = pair.submit(np.zeros(0, np.int32))
    assert pair.both("flush", reason="shutdown") == 0 or f2.done()
    pair.result(2)
    assert not hasattr(pair.pt.stats, "shutdown_flushes")


def test_queue_occupancy_feedback_matches_reference(stores):
    """Shallow executed occupancy doubles flush_at, a deep report halves
    it; the port's trajectory and occupancy sums are the reference's, and
    the occupancy is the host plan's for the same batch."""
    keys = stores[0]
    pair = Pair(stores, capacity=4096, min_flush=16, occupancy_target=0.5)
    pair.submit(keys[:16])                          # capacity flush @ 16
    pair.both("drain_feedback")
    assert pair.pt.flush_at == 32
    pair.submit(keys[:32])
    pair.both("drain_feedback")
    assert pair.pt.flush_at == 64
    for q in (pair.ref, pair.pt):                   # a deep report
        q._feedback.append((lambda: 0.9, 64, 64, {"default": 64}))
    pair.both("drain_feedback")
    assert pair.flush_at == [16, 32, 64, 32]
    assert pair.pt.stats.occ_n == 3
    # one 256-query flush: its occupancy is the host plan's
    rng = np.random.default_rng(3)
    qs = keys[rng.integers(0, keys.size, 256)]
    pair = Pair(stores, capacity=256, min_flush=256)
    pair.submit(qs)
    pair.both("drain_feedback")
    base = pair.pt_idx.base
    pids = np.minimum(np.searchsorted(base.seps, qs, side="left"),
                      base.num_pages - 1)
    host = schedule.bucket_plan(pids, base.tile)
    assert pair.pt.stats.mean_occupancy == schedule.executed_occupancy(
        qs.size, host.steps_used, base.tile, base.num_pages)


def test_queue_live_reconfiguration_and_adaptive_deadline(stores):
    keys = stores[0]
    pair = Pair(stores, capacity=64, deadline_s=60.0, max_share=1.0)
    for q in (pair.ref, pair.pt):
        q.set_tenant_weight("heavy", 2.0)
        q.set_weight("legacy", 4.0)
        q.set_max_share(0.5)
    assert pair.pt.admission.cap_queries == 32
    pair.submit(keys[:8], "heavy")
    pair.submit(keys[8:12] + 1, "legacy")
    pair.both("flush")
    assert bool(pair.result(0).found.all())
    assert not bool(pair.result(1).found.any())
    pair = Pair(stores, capacity=1024, min_flush=1024, deadline_s=0.5,
                adaptive_deadline=True, deadline_floor_s=0.01)
    for i in range(5):
        pair.clock["now"] = i * 0.01
        pair.submit(keys[i:i + 1])
    eff = pair.both("effective_deadline")
    assert eff < 0.5
    pair.clock["now"] += eff + 1e-6
    assert pair.both("poll") > 0 and pair.pt.stats.deadline_flushes == 1


class Pt(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def test_queue_joins_submits_where_they_live():
    """numpy submits reach ``search_fn`` as one numpy batch (zero pad rows
    on the host); tensor submits as one tensor; nested dicts and
    NamedTuples come back sliced per caller; an all-empty flush is built
    from the last spec; one flush is one ``search_fn`` call."""
    seen = []

    def echo(batch):
        seen.append(batch)
        return batch, None

    q = pt_queue.MicroBatchQueue(echo, capacity=64, min_flush=64,
                                 timer=False)
    fa = q.submit(np.arange(3, dtype=np.int32))
    fb = q.submit(np.arange(10, 12, dtype=np.int32))
    q.flush()
    assert isinstance(seen[-1], np.ndarray)
    np.testing.assert_array_equal(seen[-1], [0, 1, 2, 10, 11, 0, 0, 0])
    np.testing.assert_array_equal(fb.result(), [10, 11])
    assert fa.result().shape == (3,)
    sub = {"x": Pt(torch.arange(4.0), torch.ones(4, 2)),
           "y": torch.arange(4)}
    f1 = q.submit(sub, tenant="a")
    f2 = q.submit({"x": Pt(torch.arange(4.0, 5.0), torch.zeros(1, 2)),
                   "y": torch.tensor([9])}, tenant="b")
    q.flush()
    assert isinstance(seen[-1]["x"], Pt) and seen[-1]["y"].shape == (8,)
    assert torch.equal(seen[-1]["x"].b[5:], torch.zeros(3, 2))
    got = f2.result()
    assert torch.equal(got["y"], torch.tensor([9]))
    assert torch.equal(got["x"].a, torch.tensor([4.0]))
    assert torch.equal(f1.result()["x"].b, torch.ones(4, 2))
    f0 = q.submit({"x": Pt(torch.zeros(0), torch.zeros(0, 2)),
                   "y": torch.zeros(0, dtype=torch.int64)})
    q.flush()
    assert seen[-1]["x"].b.shape == (0, 2) and f0.done()
    assert len(seen) == 3 and q.stats.flushes == 3
    with pytest.raises(ValueError, match="leading axis"):
        q.submit((torch.zeros(3), torch.zeros(2)))


def test_lookup_batch_submits_one_arrival(stores):
    """``submit_many`` holds the lock across its submits: a deadline
    timer that fires meanwhile waits, then flushes them all at once."""
    keys, vals, _, port = stores
    q = pt_queue.MicroBatchQueue(pt_queue.index_probe_fn(port),
                                 capacity=1024, min_flush=1024,
                                 deadline_s=0.001)
    with q._lock:
        futs = q.submit_many([(keys[i:i + 3], f"t{i % 2}")
                              for i in range(0, 24, 3)])
        time.sleep(0.01)                 # the timer fires, and waits
    assert futs[0].wait(30.0)
    assert all(f.wait(1.0) for f in futs) and q.stats.flushes == 1
    np.testing.assert_array_equal(futs[-1].result(timeout=10).values,
                                  vals[21:24])
    q.close()


# ---------------------------------------------------------- decode queue
V = 64


def adversarial_cdfs(rng, b):
    """The reference suite's [b, V] CDFs: ties, zero-mass runs, dead tails,
    u at 1.0, 0.0 and exactly on a tie value."""
    p = rng.random((b, V)).astype(np.float32)
    p[rng.random((b, V)) < 0.4] = 0.0
    k = rng.integers(1, V, b)
    for i in range(b):
        p[i, k[i]:] *= rng.random() < 0.5
        if p[i].sum() == 0.0:
            p[i, 0] = 1.0
    cdf = np.cumsum(p / p.sum(-1, keepdims=True), -1).astype(np.float32)
    cdf[:, -1] = np.maximum(cdf[:, -1], 1.0)
    u = rng.random(b).astype(np.float32)
    u[0::4] = 1.0
    u[1::4] = 0.0
    u[2::4] = cdf[2::4, V // 2]
    return cdf, u


@pytest.mark.parametrize("seed", range(4))
def test_queued_inversion_equals_reference_paths(seed):
    """One flush of interleaved submits on two tenants: each caller's
    rows equal the reference's jnp oracle, its padded wrapper, its Pallas
    kernel (interpret mode) row by row, and the reference queue's
    flush through its kernel."""
    rng = np.random.default_rng(100 + seed)
    kw = dict(capacity=256, min_flush=256, timer=False, now_fn=lambda: 0.0)
    q = pt_queue.MicroBatchQueue(pt_cdf.cdf_probe_fn(), **kw)
    rq = ref_queue.MicroBatchQueue(ref_cdf.cdf_probe_fn(use_kernel=True),
                                   **kw)
    subs = []
    for b in [1, 4, 2, 1, 5]:
        cdf, u = adversarial_cdfs(rng, b)
        tenant = f"t{len(subs) % 2}"
        subs.append((cdf, u, q.submit((torch.from_numpy(cdf),
                                       torch.from_numpy(u)), tenant=tenant),
                     rq.submit((jnp.asarray(cdf), jnp.asarray(u)),
                               tenant=tenant)))
    q.flush()
    rq.flush()
    assert q.stats.flushes == 1 and asdict(q.stats) == asdict(rq.stats)
    for cdf, u, fut, rfut in subs:
        got = fut.result().numpy()
        assert fut.result().dtype == torch.int32
        np.testing.assert_array_equal(got, np.asarray(rfut.result()))
        np.testing.assert_array_equal(got, np.asarray(
            ref_cdf.invert_cdf(jnp.asarray(cdf), jnp.asarray(u))))
        np.testing.assert_array_equal(got, np.asarray(
            ref_ops.topp_search(cdf, u)))
        for i in range(cdf.shape[0]):
            row = jnp.asarray(np.repeat(cdf[i:i + 1], 8, axis=0))
            uu = jnp.asarray(np.repeat(u[i:i + 1], 8))
            assert got[i] == int(np.asarray(
                ref_cdf.cdf_search(row, uu, chunk=V))[0])


@pytest.mark.parametrize("cfg", [
    SamplerConfig(temperature=0.8, top_p=0.9),
    SamplerConfig(temperature=1.3, top_p=0.5, top_k=8),
    SamplerConfig(temperature=0.0)], ids=["nucleus", "top_k", "greedy"])
def test_sample_queued_equals_sample(cfg):
    """Tokens through the decode queue equal the inline sampler's for the
    same generator, with and without tenant grouping; one flush a call."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(size=(6, V)).astype(np.float32) * 3)
    q = pt_queue.MicroBatchQueue(pt_cdf.cdf_probe_fn(), capacity=64,
                                 min_flush=64, timer=False, path="decode")
    want = pt_sampler.sample(logits, cfg,
                             generator=torch.Generator().manual_seed(42))
    for tenants in (None, ["a", "b", "a", "c", "b", "a"]):
        got = pt_sampler.sample_queued(
            logits, cfg, q, tenants=tenants,
            generator=torch.Generator().manual_seed(42))
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert q.stats.flushes == (0 if cfg.temperature == 0.0 else 2)
    if cfg.temperature:
        assert set(q.stats.tenants) == {"default", "a", "b", "c"}
    with pytest.raises(ValueError, match="one id per row"):
        pt_sampler.sample_queued(logits, SamplerConfig(), q, tenants=["a"])
    q.close()
