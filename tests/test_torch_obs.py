"""The port's observability layer (``repro_torch/obs``) and its hooks
against the reference's (``repro/obs``), the cases of
``tests/test_obs.py``.

* **histogram units and registry** — √2 buckets, quantiles, merges,
  label series, kind conflicts, partial totals, snapshots and the null
  registry give the reference's values; the Prometheus text is the
  reference's byte for byte for the same update sequence, and parses
  back; the HTTP scrape serves it on 127.0.0.1.
* **tracing** — ring-buffer capacity and drops, nested-span containment in
  the exported trace JSON, the disabled no-op posture, and enabled spans
  showing up in a ``torch.profiler`` trace.
* **hooks** — an instrumented queue flush is one dispatch; the queue's
  tenant summary, ``EngineStats``' views and the journal's counters equal
  the reference's after the same writes; the engine paths (search, scan,
  lookup, seal, fold, journal, snapshots) count the same ops in both
  packages.

Exact everywhere: both packages run the same Python arithmetic, on a
manual clock where a time feeds a count."""
import dataclasses
import json
import math
import urllib.request

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro import obs as ref_obs
from repro.ckpt import journal as ref_jr
from repro.engine import queue as ref_queue
from repro.obs import metrics as ref_metrics
from repro.serve.engine import EngineStats as RefEngineStats

import repro_torch.core as pt_core
from repro_torch import obs
from repro_torch.ckpt import journal as jr
from repro_torch.engine import queue as pt_queue
from repro_torch.obs import metrics as pt_metrics
from repro_torch.obs import trace as pt_trace
from repro_torch.serve.engine import EngineStats

torch.set_num_threads(1)

PACKAGES = ((ref_metrics, ref_obs), (pt_metrics, obs))


# ---------------------------------------------------------------- buckets
def test_bucket_functions_match_reference():
    vals = [0.0, -1.0, float("nan"), 1e-30, 1e-9, 1e-6, 0.5, 1.0,
            math.sqrt(2.0), 1.5, 2.0, 3.0, 1000.0, 2.0 ** 64, 1e30]
    vals += list(np.random.default_rng(0).lognormal(0, 8, 200))
    for v in vals:
        assert pt_metrics.bucket_index(v) == ref_metrics.bucket_index(v)
    for k in range(pt_metrics.BUCKET_MIN, pt_metrics.BUCKET_MAX + 1):
        assert pt_metrics.bucket_upper(k) == ref_metrics.bucket_upper(k)
    # the reference suite's fixed points
    assert [pt_metrics.bucket_index(v) for v in (1.0, 2.0, 0.5,
                                                 math.sqrt(2.0))] == \
        [0, 2, -2, 1]
    assert pt_metrics.bucket_index(1e30) == 128
    assert pt_metrics.bucket_index(1e-30) == -60


def test_histogram_units_match_reference():
    out = []
    for m, _ in PACKAGES:
        h = m.Histogram()
        for v in (1.0, 1.0, 1.0, 100.0, 1e30, 1e-30):
            h.observe(v)
        a, b = m.Histogram(), m.Histogram()
        for v in (0.25, 1.0, 4.0):
            a.observe(v)
        for v in (1.0, 64.0):
            b.observe(v)
        merged = m.Histogram().merge(a).merge(b)
        with h.time():
            pass
        c = m.Counter()
        c.inc(3)
        with pytest.raises(ValueError):
            c.inc(-1)
        with pytest.raises(ValueError):
            h.quantile(1.5)
        out.append(([merged.quantile(q) for q in (0.1, 0.5, 0.9, 0.99)],
                    merged.count, merged.sum, merged.min, merged.max,
                    merged.buckets, a.count, b.count, h.count - 1,
                    h.quantile(0.5), h.quantile(0.99), c.value))
    assert out[0] == out[1]
    assert out[1][1:5] == (5, 70.25, 0.25, 64.0)


def random_updates(reg, seed: int):
    """A seeded sequence of counter / gauge / histogram updates over a
    few names and label sets (escapes included)."""
    rng = np.random.default_rng(seed)
    labels = [{}, {"path": "probe"}, {"path": "decode", "tenant": "t1"},
              {"path": "probe", "tenant": 'we"ird\\t\nx'}]
    for _ in range(300):
        lab = labels[int(rng.integers(len(labels)))]
        kind = int(rng.integers(3))
        if kind == 0:
            inc = int(rng.integers(0, 5)) if rng.random() < 0.7 \
                else float(rng.random())
            reg.counter("queue_submits", help="submits", **lab).inc(inc)
        elif kind == 1:
            g = reg.gauge("queue_flush_at", **lab)
            g.set(float(rng.integers(1, 4096))) if rng.random() < 0.5 \
                else g.inc(int(rng.integers(1, 3)))
        else:
            v = float(rng.choice([0.0, -1.0, float("nan"), 1e-7, 3.0,
                                  float(rng.lognormal(-8, 4))]))
            reg.histogram("engine_op_seconds", **lab).observe(v)


@pytest.mark.parametrize("seed", range(3))
def test_prometheus_text_and_snapshot_equal_the_reference(seed):
    regs = [m.Registry() for m, _ in PACKAGES]
    for reg in regs:
        random_updates(reg, seed)
    assert regs[1].prometheus_text() == regs[0].prometheus_text()
    assert regs[1].prometheus_text(namespace="") == \
        regs[0].prometheus_text(namespace="")
    assert json.dumps(regs[1].snapshot()) == json.dumps(regs[0].snapshot())
    parsed = pt_metrics.parse_prometheus(regs[1].prometheus_text())
    assert repr(sorted(parsed.items())) == repr(sorted(
        ref_metrics.parse_prometheus(regs[0].prometheus_text()).items()))
    by_name = {}
    for (n, lab), v in parsed.items():
        by_name.setdefault(n, {})[lab] = v
    assert set(by_name) >= {"repro_queue_submits_total",
                            "repro_queue_flush_at",
                            "repro_engine_op_seconds_bucket"}
    counts = by_name["repro_engine_op_seconds_count"]
    assert sum(v for lab, v in by_name["repro_engine_op_seconds_bucket"]
               .items() if 'le="+Inf"' in lab) == sum(counts.values())


def test_registry_series_totals_and_conflicts_match_reference():
    out = []
    for m, _ in PACKAGES:
        reg = m.Registry()
        reg.counter("ops", path="probe", tenant="a").inc(2)
        reg.counter("ops", path="probe", tenant="b").inc(3)
        reg.counter("ops", path="decode", tenant="a").inc(5)
        reg.histogram("lat", path="probe", tenant="a").observe(1.0)
        reg.histogram("lat", path="probe", tenant="b").observe(4.0)
        reg.histogram("lat", path="decode", tenant="a").observe(64.0)
        with pytest.raises(ValueError):
            reg.histogram("ops", path="probe", tenant="a")
        with pytest.raises(ValueError):
            reg.gauge("ops", path="new")
        assert reg.counter("x", path="a") is reg.counter("x", path="a")
        mh = reg.merged_histogram("lat", path="probe")
        out.append((reg.total("ops"), reg.total("ops", path="probe"),
                    reg.total("ops", path="probe", tenant="b"),
                    reg.total("missing"),
                    sorted(tuple(sorted(lab.items()))
                           for lab, _ in reg.series("ops")),
                    mh.count, mh.sum, reg.merged_histogram("lat").count,
                    reg.merged_histogram("nope").count,
                    reg.value("ops", path="probe", tenant="a").value,
                    reg.value("ops", path="nope"), reg.snapshot()["ops"]))
        reg.reset()
        assert reg.snapshot() == {}
    assert out[0] == out[1]
    assert out[1][:4] == (10, 5, 3, 0)


def test_null_registry_and_configure():
    null = obs.NULL_REGISTRY
    c = null.counter("ops", path="probe")
    c.inc()
    c.set(3)
    c.observe(1.0)
    with c.time():
        pass
    assert c is null.histogram("lat", path="x") is null.gauge("g")
    assert null.total("ops") == 0.0 and null.value("ops") is None
    assert null.merged_histogram("lat").count == 0
    assert list(null.series("ops")) == [] and null.snapshot() == {}
    assert null.prometheus_text() == ""
    try:
        obs.configure(metrics=False, trace=True, trace_capacity=8)
        assert not obs.metrics_enabled() and obs.TRACER.enabled
        assert obs.get_registry() is null and obs.snapshot() == {}
    finally:
        obs.configure()
    assert obs.metrics_enabled() and not obs.TRACER.enabled
    with obs.use_registry() as reg:
        assert obs.get_registry() is reg is not obs.REGISTRY
    assert obs.get_registry() is obs.REGISTRY


def test_http_scrape_serves_the_registry_on_localhost():
    reg = obs.Registry()
    reg.counter("ops", path="probe").inc(1)
    srv, port = obs.start_http_server(0, registry=reg)
    try:
        assert srv.server_address[0] == "127.0.0.1"
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/other",
                                   timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()
    assert body == reg.prometheus_text()
    assert obs.parse_prometheus(body)[("repro_ops_total",
                                       '{path="probe"}')] == 1.0


# ----------------------------------------------------------------- tracing
def test_span_nesting_export_and_ring(tmp_path):
    tr = pt_trace.Tracer()
    tr.enable()
    with tr.span("outer", kind="test"):
        with tr.span("inner"):
            pass
        with tr.span("inner2", obj=object()):
            pass
    tr.instant("mark", n=3)
    path = str(tmp_path / "trace.json")
    tr.export(path)
    with open(path) as f:
        doc = json.load(f)
    evs = {e["name"]: e for e in doc["traceEvents"]}
    assert set(evs) == {"outer", "inner", "inner2", "mark"}
    outer = evs["outer"]
    assert outer["args"] == {"kind": "test"} and evs["mark"]["ph"] == "i"
    assert isinstance(evs["inner2"]["args"]["obj"], str)
    for e in (evs["inner"], evs["inner2"]):
        assert e["ph"] == "X" and e["tid"] == outer["tid"]
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert doc["otherData"]["dropped_events"] == 0
    ring = pt_trace.Tracer(capacity=4)
    ring.enable()
    for i in range(10):
        with ring.span(f"s{i}"):
            pass
    assert [e["name"] for e in ring.events()] == ["s6", "s7", "s8", "s9"]
    assert ring.dropped == 6 and ring.export()["otherData"][
        "dropped_events"] == 6
    ring.clear()
    assert ring.events() == [] and ring.dropped == 0


def test_disabled_tracer_records_nothing_and_enabled_spans_reach_the_profiler(
        monkeypatch):
    tr = pt_trace.Tracer()
    with tr.span("never"):
        pass
    tr.instant("never")
    assert tr.events() == [] and tr.dropped == 0
    assert pt_trace.span("x") is pt_trace.annotate("y")     # the no-op
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(pt_trace, "TRACER", tr)
    tr.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pt_trace.span("queue.flush", path="probe"):
            with pt_trace.annotate("tiered/page_kernel"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"queue.flush", "tiered/page_kernel"} <= names
    assert [e["name"] for e in tr.events()] == ["queue.flush"]


# ----------------------------------------------------------------- hooks
def small_store(core, n=2048, **cfg):
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 2**31 - 2, int(n * 1.1)
                                  ).astype(np.int32))[:n]
    vals = np.arange(keys.size, dtype=np.int32)
    kw = {} if core is ref_core else {"device": "cpu"}
    return keys, vals, core.build_index(
        keys, vals, core.IndexConfig(kind="tiered", mutable=True, **cfg),
        **kw)


def test_instrumented_flush_is_one_dispatch():
    """Metrics AND tracing on: a flush of four tensor submits is one
    ``search_fn`` call, one boundary observation, and the spans nest
    queue.flush > queue.dispatch > store.lookup > tiered stages."""
    keys, vals, idx = small_store(pt_core)
    calls = []
    probe = pt_queue.index_probe_fn(idx)

    def counted(q):
        calls.append(q.shape)
        return probe(q)

    reqs = [torch.from_numpy(keys[i * 8:(i + 1) * 8]) for i in range(4)]
    tr = pt_trace.Tracer()
    tr.enable()
    old, pt_trace.TRACER = pt_trace.TRACER, tr
    try:
        with obs.use_registry() as reg:
            q = pt_queue.MicroBatchQueue(counted, capacity=32, min_flush=32,
                                         timer=False, path="probe")
            futs = [q.submit(r) for r in reqs]
            q.flush()
            got = [f.result().values.numpy() for f in futs]
    finally:
        pt_trace.TRACER = old
    assert calls == [torch.Size([32])] and q.stats.flushes == 1
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, vals[i * 8:(i + 1) * 8])
    assert reg.total("engine_ops", path="probe") == 1
    assert reg.merged_histogram("engine_op_seconds", path="probe").count == 1
    assert reg.total("engine_ops", path="lookup") == 1
    assert reg.total("queue_submits", path="probe") == 4
    assert reg.total("queue_flushes", path="probe") == 1
    names = [e["name"] for e in tr.events()]
    for name in ("queue.submit", "queue.flush", "queue.admit",
                 "queue.dispatch", "store.lookup", "queue.result"):
        assert name in names, name


def test_tenant_summary_matches_reference():
    """Two tenants through both packages' queues on one manual clock: the
    registry's rows (waits and occupancy included) are equal."""
    rows = []
    for core, qm, o in ((ref_core, ref_queue, ref_obs),
                        (pt_core, pt_queue, obs)):
        keys, _, idx = small_store(core)
        idx.flush()
        clock = {"now": 0.0}
        with o.use_registry(o.Registry()) as reg:
            q = qm.MicroBatchQueue(qm.index_probe_fn(idx), capacity=32,
                                   min_flush=32, timer=False, path="probe",
                                   max_share=0.5,
                                   now_fn=lambda: clock["now"])
            q.submit(keys[:8], tenant="a")
            clock["now"] = 0.001
            q.submit(keys[8:16], tenant="b")
            q.submit(keys[16:40], tenant="a")
            clock["now"] = 0.004
            q.flush()
            q.flush()
            q.drain_feedback()
            rows.append([dataclasses.asdict(r)
                         for r in qm.tenant_summary(reg)])
            rows.append({k: dataclasses.asdict(v)
                         for k, v in q.stats.tenants.items()})
            assert reg.merged_histogram("queue_batch_size",
                                        path="probe").count == 2
    assert rows[2:] == rows[:2]
    assert {(r["path"], r["tenant"]) for r in rows[2]} == {("probe", "a"),
                                                          ("probe", "b")}
    assert rows[2][0]["queries"] == 32 and rows[2][0]["deferred"] == 1


def test_engine_stats_views_match_reference():
    regs = [m.Registry() for m, _ in PACKAGES]
    for reg in regs:
        reg.counter("queue_flushes", path="probe", reason="capacity").inc(3)
        reg.counter("queue_flushes", path="decode", reason="demand").inc(2)
        reg.histogram("queue_flush_occupancy", path="probe").observe(0.5)
        reg.histogram("queue_flush_occupancy", path="decode").observe(1.0)
        reg.counter("queue_submits", path="probe", tenant="t0").inc(4)
        reg.counter("queue_queries", path="probe", tenant="t0").inc(32)
    ref, port = RefEngineStats(registry=regs[0]), EngineStats(
        registry=regs[1])
    for view in ("probe_batches", "probe_occupancy", "decode_flushes",
                 "decode_occupancy"):
        assert getattr(port, view) == getattr(ref, view), view
    assert port.probe_batches == 3 and port.decode_flushes == 2
    assert {k: dataclasses.asdict(v) for k, v in port.tenants.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.tenants.items()}
    assert port.tenants[("probe", "t0")].queries == 32
    with obs.use_registry() as reg:             # None: the active registry
        reg.counter("queue_flushes", path="probe", reason="demand").inc()
        assert EngineStats().probe_batches == 1


def test_journal_counters_match_reference(tmp_path):
    """Per fsync policy, five acknowledged single-record batches, then a
    compaction: syncs, appends, bytes and compaction counters equal the
    reference's; durability is independent of the policy."""
    got = []
    for pkg, (m, o) in zip((ref_jr, jr), PACKAGES):
        with o.use_registry(m.Registry()) as reg:
            syncs = {}
            for policy in pkg.FSYNC_POLICIES:
                path = str(tmp_path / f"{pkg.__name__}-{policy}.journal")
                j = pkg.Journal(path, np.dtype(np.int32), fsync=policy)
                for k in range(5):
                    if pkg is jr:
                        j.append_many([k % 3], [k * 10])
                    else:
                        j.append(k % 3, k * 10)
                    j.flush()
                j.close()
                syncs[policy] = j.syncs
                assert len(pkg.read_segment(path)[1]) == 5
            dropped = pkg.compact_segment(path)
            got.append((syncs, dropped, json.dumps(reg.snapshot())))
    assert got[1] == got[0]
    assert got[1][0] == {"never": 0, "rotate": 1, "always": 5}
    assert got[1][1] == 2


def test_journal_policy_validation_and_config_reach_the_store(tmp_path):
    with pytest.raises(ValueError):
        jr.Journal(str(tmp_path / "x.journal"), np.dtype(np.int32),
                   fsync="sometimes")
    with pytest.raises(ValueError):
        pt_core.IndexConfig(kind="tiered", journal_fsync="sometimes")
    _, _, idx = small_store(pt_core, n=512, journal_fsync="always",
                            ckpt_dir=str(tmp_path))
    with obs.use_registry() as reg:
        idx.insert(np.array([7, 11], np.int32), np.array([1, 2], np.int32))
    assert idx._journal.fsync == "always" and idx._journal.syncs >= 1
    assert reg.total("journal_syncs", policy="always") == 1
    assert reg.total("journal_appends") == 2
    assert reg.total("engine_ops", path="journal") == 1


def test_engine_paths_count_the_references_ops(tmp_path):
    """The same calls in both packages — an immutable index's lookup and
    scans, a journaled store's writes, seals, folds, lookup, scans, save
    and restore — leave the same engine_ops counts, journal counters and
    histogram counts in the registry."""
    rng = np.random.default_rng(4)
    lo = np.sort(rng.integers(0, 2**31 - 2, 16).astype(np.int32))
    hi = lo + np.int32(2**24)
    snaps = []
    for core, (m, o) in zip((ref_core, pt_core), PACKAGES):
        kw = {} if core is ref_core else {"device": "cpu"}
        keys, vals, _ = small_store(core, n=80)        # keys only
        with o.use_registry(m.Registry()) as reg:
            idx = core.build_index(keys, vals,
                                   core.IndexConfig(kind="tiered"), **kw)
            idx.lookup(keys[:4])
            idx.scan_range(lo, hi)
            idx.scan_range(lo, hi, materialize=4)
            _, _, st = small_store(core, n=600, delta_capacity=32,
                                   leaf_width=128,
                                   ckpt_dir=str(tmp_path / core.__name__))
            st.insert(keys, vals)                      # seals, a fold
            st.delete(keys[:6])
            st.maintain()
            st.lookup(keys[:8])
            st.scan_range(lo, hi)
            st.save()
            st.insert(keys[6:10], vals[6:10] + 1)
            st.close()
            core.restore_index(str(tmp_path / core.__name__),
                               core.IndexConfig(kind="tiered", mutable=True),
                               **kw)
            snap = {}
            for name, rows in reg.snapshot().items():
                for row in rows:
                    key = (name, json.dumps(row["labels"], sort_keys=True))
                    snap[key] = row.get("value", row.get("count"))
            snaps.append(snap)
    assert snaps[1] == snaps[0]
    paths = {json.loads(k[1]).get("path") for k in snaps[1]
             if k[0] == "engine_ops"}
    assert paths == {"search", "scan", "journal", "seal", "fold", "lookup",
                     "snapshot_save", "snapshot_restore"}
