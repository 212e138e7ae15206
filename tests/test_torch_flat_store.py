"""The mutable store over a non-tiered base against the reference's, on
the CPU: ``IndexConfig(kind=<binary|css|kary|fast|nitrogen>,
mutable=True)``.

* the css store traced step by step (mirror of
  tests/test_engine_scan.py:275): inserts, upserts, deletes, wholesale
  folds, delete-to-empty; lookups (rank, found, values), stats and ``n``;
  the host-path scans (scan_range with materialize, including rows at
  ``hi = INT32_MAX``, scan_groups with top-K, scan_multi union /
  intersect) bit for bit; the probe queue gets no plan feedback;
* every flat kind's store, specialized or not, through writes;
* a "flat" snapshot and its journal restored across the packages;
* the launcher's printed counts with ``--index nitrogen``.

Each reference fold rebuilds its base and compiles its fused lookup
again, so the traces fold at most three times.
"""
import contextlib
import io
import sys

import numpy as np
import pytest
import torch

import repro.core as ref_core

import repro_torch.core as pt_core
from repro_torch import obs
from repro_torch.engine import queue as pt_queue
from repro_torch.engine import schedule as pt_schedule
from repro_torch.launch import serve as pt_launch
from repro_torch.tune import profile as pt_profile

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
SCAN_FIELDS = ("count", "r_lo", "r_hi_excl", "vsum", "vmin", "vmax",
               "ranks", "values", "overflow")
GROUP_FIELDS = ("count", "edges", "r_edge", "vsum", "vmin", "vmax",
                "topk_values", "topk_ranks", "overflow")
Q = 96                                   # one lookup shape a trace


def assert_fields(got, want, fields, what):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f"{what}: {f} None-ness"
        if w is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{what}: {f}")


def _cfg(core, kind="css", capacity=64, **kw):
    return core.IndexConfig(kind=kind, node_width=16, levels=2,
                            mutable=True, delta_capacity=capacity, **kw)


def _pair(keys, vals, **kw):
    return (ref_core.build_index(keys, vals, _cfg(ref_core, **kw)),
            pt_core.build_index(keys, vals, _cfg(pt_core, **kw),
                                device="cpu"))


def _same_lookup(ref, pt, q, what):
    want, got = ref.lookup(q), pt.lookup(torch.from_numpy(q))
    for f in ("rank", "found", "values"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what}: {f}")


def _same_state(ref, pt, rng, live, what):
    """Lookups, stats, n and the three scan families, port == reference."""
    q = np.concatenate([rng.choice(live, Q // 2) if live.size else
                        rng.integers(0, 1 << 20, Q // 2),
                        rng.integers(0, 1 << 20, Q // 2)]).astype(np.int32)
    _same_lookup(ref, pt, q, what)
    assert pt.stats == ref.stats, what
    assert pt.n == ref.n, what
    lo = np.sort(rng.integers(0, 1 << 20, 32)).astype(np.int32)
    hi = (lo + rng.integers(-2000, 1 << 17, 32)).astype(np.int32)
    lo[:2], hi[:2] = I32.min, I32.max - 1
    # the host path is exact at the sentinel (no hi + 1 wrap)
    lo[2], hi[2:4] = lo[3], I32.max
    assert_fields(pt.scan_range(lo, hi, materialize=5),
                  ref.scan_range(lo, hi, materialize=5), SCAN_FIELDS,
                  f"{what} scan_range")
    assert_fields(pt.scan_range(lo, hi, aggs=("count", "sum")),
                  ref.scan_range(lo, hi, aggs=("count", "sum")),
                  SCAN_FIELDS, f"{what} scan_range sum")
    # bucket edges wrap past INT32_MAX - 1 in both packages (the
    # reference's host path then fails), so the groups stay below it
    glo, ghi = lo[4:20], hi[4:20]
    assert_fields(pt.scan_groups(glo, ghi, 8, top_k=3),
                  ref.scan_groups(glo, ghi, 8, top_k=3), GROUP_FIELDS,
                  f"{what} scan_groups")
    ranges = np.stack([lo.reshape(8, 4), hi.reshape(8, 4)], -1)
    for op in ("union", "intersect"):
        assert_fields(pt.scan_multi(ranges, op=op),
                      ref.scan_multi(ranges, op=op), SCAN_FIELDS[:6],
                      f"{what} scan_multi {op}")


def test_flat_store_traces_the_reference():
    rng = np.random.default_rng(31)
    keys = rng.choice(1 << 20, 3000, replace=False).astype(np.int32)
    vals = rng.integers(-(1 << 31) + 1, (1 << 31) - 1,
                        keys.size).astype(np.int32)
    ref, pt = _pair(keys, vals)
    live = dict(zip(keys.tolist(), vals.tolist()))
    assert pt.stats["base_rebuilds"] == 1 and pt._host_scans
    _same_state(ref, pt, rng, keys, "built")
    for rnd in range(2):
        # 40 new keys, 20 upserts, 30 deletes: one seal a round, and the
        # second round's seal folds the first round's tier
        new = rng.integers(0, 1 << 20, 40).astype(np.int32)
        old = rng.choice(np.array(sorted(live), np.int32), 50,
                         replace=False)
        up = old[:20]
        nv = rng.integers(0, 1000, 60).astype(np.int32)
        wk = np.concatenate([new, up])
        for store in (ref, pt):
            store.insert(wk, nv)
            store.delete(old[20:])
        live.update(zip(wk.tolist(), nv.tolist()))
        for k in old[20:].tolist():
            live.pop(k, None)
        _same_state(ref, pt, rng, np.array(sorted(live), np.int32),
                    f"round {rnd}")
    assert pt.stats["maintains"] == 1 and pt.stats["base_rebuilds"] == 2
    assert pt.n == len(live)

    # the probe queue over the flat store: answers, and no plan feedback
    assert pt.pop_plan_feedback() is None
    q = pt_queue.MicroBatchQueue(pt_queue.index_probe_fn(pt), capacity=256,
                                 timer=False)
    probe = np.array(sorted(live), np.int32)[:100]
    fut = q.submit(probe)
    q.flush()
    np.testing.assert_array_equal(fut.result().values.numpy(),
                                  [live[k] for k in probe.tolist()])
    q.close()
    assert q.stats.occ_n == 0 and q.stats.flushes == 1


def test_flat_store_deletes_to_empty_and_back():
    """Deleting every key folds the base away (base None): lookups and
    scans answer from the delta tiers, as the reference's do; the next
    fold builds a base from the delta again."""
    rng = np.random.default_rng(5)
    keys = rng.choice(1 << 16, 40, replace=False).astype(np.int32)
    vals = np.arange(40, dtype=np.int32)
    ref, pt = _pair(keys, vals, capacity=64)
    for store in (ref, pt):
        store.delete(keys)
        store.flush()
    assert pt.base is None and ref.base is None and pt.n == 0
    _same_state(ref, pt, rng, np.zeros(0, np.int32), "emptied")
    new = rng.choice(1 << 16, 10, replace=False).astype(np.int32)
    for store in (ref, pt):
        store.insert(new, new)
        store.flush()
    assert pt.stats["base_rebuilds"] == 2 and pt.n == 10
    _same_lookup(ref, pt, np.concatenate([new, new + 1]), "refilled")


@pytest.mark.parametrize("kind", ["binary", "kary", "fast", "nitrogen"])
def test_every_flat_kind_store_answers_as_the_reference(kind):
    """The other kinds' stores, specialized (the base's searcher bound to
    its arrays) against the reference's args posture, through a write
    round held in the delta tiers."""
    rng = np.random.default_rng(2)
    keys = rng.choice(1 << 18, 700, replace=False).astype(np.int32)
    ref = ref_core.build_index(keys, None, _cfg(ref_core, kind=kind))
    pt = pt_core.build_index(keys, None, _cfg(pt_core, kind=kind,
                                              specialize=True), device="cpu")
    assert pt.base.captures.n == 1 and pt._spec_fused is None
    new = rng.integers(0, 1 << 18, 20).astype(np.int32)
    for store in (ref, pt):
        store.insert(new, np.arange(20, dtype=np.int32) + 5)
        store.delete(keys[:10])
    q = np.concatenate([keys[::8], new, new + 1]).astype(np.int32)
    _same_lookup(ref, pt, q, kind)
    assert pt.stats == ref.stats and pt.n == ref.n
    lo = np.sort(q[:16])
    hi = lo + 4000
    assert_fields(pt.scan_range(lo, hi), ref.scan_range(lo, hi),
                  SCAN_FIELDS[:6], f"{kind} scan_range")


def test_flat_snapshot_restores_across_packages(tmp_path):
    """A css store's "flat" snapshot and journal tail, written by either
    package, restores in the other, equal to the live writer."""
    rng = np.random.default_rng(23)
    init = np.unique(rng.integers(0, 1 << 16, 300)).astype(np.int32)
    keys = rng.choice(1 << 17, 80, replace=False).astype(np.int32)
    q = np.concatenate([keys, keys + 1, init[::5]]).astype(np.int32)
    lo = np.sort(keys)[::4]
    hi = lo + 5000
    for writer, reader in (("ref", "port"), ("port", "ref")):
        d = str(tmp_path / writer)
        core = ref_core if writer == "ref" else pt_core
        kw = {} if writer == "ref" else {"device": "cpu"}
        live = core.build_index(init, None, _cfg(core, capacity=32,
                                                 ckpt_dir=d), **kw)
        live.insert(keys[:40], np.arange(40, dtype=np.int32))
        live.delete(init[:10])
        live.save()
        live.insert(keys[40:], np.arange(40, dtype=np.int32) + 100)
        live.delete(keys[:5])
        if reader == "port":
            back = pt_core.restore_index(d, _cfg(pt_core, capacity=32),
                                         device="cpu")
            ref, pt = live, back
        else:
            back = ref_core.restore_index(d, _cfg(ref_core, capacity=32))
            ref, pt = back, live
        assert back.stats["journal_replayed"] == 45
        assert back.stats["base_rebuilds"] >= 1
        _same_lookup(ref, pt, q, f"{writer} -> {reader}")
        assert_fields(pt.scan_range(lo, hi), ref.scan_range(lo, hi),
                      SCAN_FIELDS[:6], f"{writer} -> {reader} scan_range")
        assert pt.n == ref.n
        live.close()
        back.close()


# What the reference launcher prints for ``--reduced --rounds 2 --steps 2
# --index nitrogen`` (and with ``--wholesale``): the mutable store keeps
# all 10 page hashes in its delta buffer; the wholesale index rebuilds 9
# times. A flat kind gives the probe queue no plan feedback (occupancy 0).
NITROGEN_LINES = {
    "mutable": ["prefix store: {'lookups': 23, 'hits': 15, 'rebuilds': 0, "
                "'verify_rejects': 0}",
                "write path:   {'inserts': 10, 'upserts': 0, 'deletes': 0, "
                "'merges': 0, 'splits': 0, 'pages_touched': 0, "
                "'rows_rewritten': 0, 'top_derives': 0, 'base_rebuilds': 0,"
                " 'shadowed': 0, 'seals': 0, 'maintains': 0, "
                "'journal_replayed': 0}"],
    "wholesale": ["prefix store: {'lookups': 23, 'hits': 15, 'rebuilds': 9, "
                  "'verify_rejects': 0}"],
}


@pytest.mark.parametrize("posture", list(NITROGEN_LINES))
def test_launcher_index_nitrogen_prints_the_reference_lines(monkeypatch,
                                                            posture):
    argv = ["serve", "--reduced", "--device", "cpu", "--rounds", "2",
            "--steps", "2", "--index", "nitrogen"]
    if posture == "wholesale":
        argv.append("--wholesale")
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with obs.use_registry(), contextlib.redirect_stdout(out):
        pt_launch.main()
    out = out.getvalue()
    assert "prefix-index=nitrogen" in out
    assert "prefill computed/reused: 288/480" in out
    assert ("probe queue:  1 fused batches in " in out and
            "mean executed-plan occupancy 0.000" in out)
    assert "decode queue: 4 fused inversion batches" in out
    for line in NITROGEN_LINES[posture]:
        assert line in out
    assert ("write path:" in out) == (posture == "mutable")


def test_launcher_tuned_profile_over_a_flat_kind(monkeypatch, tmp_path):
    """--tuned-profile with --index other than tiered applies only the
    profile's kind-agnostic knobs (queue_min_flush, queue_deadline_s,
    specialize), as the reference launcher does: the tiered knobs stay
    at their defaults, and the specialized css index serves."""
    monkeypatch.setattr(pt_profile, "default_profile_dir",
                        lambda: str(tmp_path))
    pt_profile.save_profile(pt_profile.TunedProfile(
        platform="testplat", backend="cpu", device_kind="cpu",
        knobs={"tile": 256, "leaf_width": 512, "histogram_max_pages": 16,
               "queue_min_flush": 64, "queue_deadline_s": 0.002,
               "specialize": True},
        objective={}))
    monkeypatch.setattr(sys, "argv", [
        "serve", "--reduced", "--device", "cpu", "--rounds", "2", "--steps",
        "2", "--index", "css", "--wholesale", "--tuned-profile", "testplat"])
    out = io.StringIO()
    prev = pt_schedule.set_plan_thresholds()
    try:
        with obs.use_registry(), contextlib.redirect_stdout(out):
            pt_launch.main()
    finally:
        pt_schedule.set_plan_thresholds(**prev)
    out = out.getvalue()
    assert "tuned profile: tile=128 leaf_width=None specialize=True" in out
    assert "prefill computed/reused: 288/480" in out
    assert ("prefix store: {'lookups': 23, 'hits': 15, 'rebuilds': 9, "
            "'verify_rejects': 0}") in out
