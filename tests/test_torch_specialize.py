"""Specialization of the port (``IndexConfig(specialize=True)``, DESIGN.md
§10) against the reference's, for the tiered kind, on the CPU.

The reference binds the built index into a jitted program; the port binds
it into CUDA graphs on the card (``engine/capture.py``) and, on the CPU,
into the same pipeline closed over its pages with the query-only
signature. Contracts under test:

* bit-identity: the port's specialized posture answers as the reference's
  specialized and args postures (ranks, found, values, counts, int sums,
  min / max, materialized rows by bits), int32 and float32, under both
  plan constructions;
* the store's twin through writes: it stays armed across a page-local
  fold (the port writes rows in place) with answers unchanged, and re-arms
  once at a repack and at a restore; writes between derives add no arm
  (the port's own count, ``captures``, where the reference's tests read
  jax trace events);
* one ``engine_ops`` observation a call at the reference's paths.
"""
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.engine import schedule as ref_schedule

import repro_torch.core as pt_core
from repro_torch.engine import schedule as pt_schedule
from repro_torch.obs import Registry, use_registry

torch.set_num_threads(1)

SCAN_FIELDS = ("count", "r_lo", "r_hi_excl", "vsum", "vmin", "vmax",
               "ranks", "values", "overflow")


def _data(dtype, n=4000, seed=0):
    """The reference test's data: unique keys, values 0..n-1, every
    seventh key and misses."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        keys = np.unique(rng.normal(size=n).astype(dtype))
        qs = np.concatenate([keys[::7], rng.normal(
            size=n // 4).astype(dtype)])
    else:
        keys = np.sort(rng.choice(1 << 20, n, replace=False)).astype(dtype)
        qs = np.concatenate([keys[::7], (keys[::11] + 1).astype(dtype)])
    vals = np.arange(keys.size, dtype=np.int32)
    return keys, vals, qs


def bits(x):
    a = np.asarray(x)
    return a if a.dtype == bool else a.view(np.uint8)


def assert_same(got, want, what):
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=what)


def assert_lookups(pt, refs, q):
    got = pt.lookup(q)
    for ref in refs:
        want = ref.lookup(q)
        for f in ("rank", "found", "values"):
            assert_same(getattr(got, f), getattr(want, f), f)


def pt_index(keys, vals, **cfg):
    return pt_core.build_index(keys, vals, pt_core.IndexConfig(**cfg),
                               device="cpu")


# ------------------------------------------------------- bit-identity oracle
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_specialized_matches_reference_postures(dtype):
    keys, vals, qs = _data(dtype)
    refs = [ref_core.build_index(keys, vals, ref_core.IndexConfig(
        kind="tiered", specialize=s)) for s in (True, False)]
    args = pt_index(keys, vals, kind="tiered")
    spec = pt_index(keys, vals, kind="tiered", specialize=True)
    assert spec.impl.search_spec is not None and args.impl.search_spec is None
    for ref in refs:
        assert_same(spec.search(qs), ref.search(qs), "search")
    assert_lookups(spec, refs, qs)
    lo = keys[::131]
    hi = lo + (np.float32(0.5) if np.dtype(dtype).kind == "f"
               else np.int32(5000))
    want = refs[0].scan_range(lo, hi, materialize=4)
    for got in (spec.scan_range(lo, hi, materialize=4),
                args.scan_range(lo, hi, materialize=4)):
        for f in SCAN_FIELDS:
            assert_same(getattr(got, f), getattr(want, f), f)
    # the grouped and composite dispatches, specialized against args
    ranges = np.stack([np.stack([lo, hi], -1), np.stack([lo, lo], -1)], 1)
    for call in (lambda ix: ix.scan_range(lo, hi),
                 lambda ix: ix.scan_range(lo, hi, aggs=("count",)),
                 lambda ix: ix.search_range(lo, hi),
                 lambda ix: ix.scan_groups(lo, hi, 4),
                 lambda ix: ix.scan_groups(lo, hi, 4, top_k=2),
                 lambda ix: ix.scan_multi(ranges, op="union"),
                 lambda ix: ix.scan_multi(ranges, op="intersect")):
        a, b = call(spec), call(args)
        pairs = zip(a, b) if isinstance(a, tuple) else (
            (getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)
        for x, y in pairs:
            assert (x is None) == (y is None)
            if x is not None:
                assert_same(x, y, "scan")
    # one arm for search, one for the lookup, one a scan dispatch
    assert spec.impl.captures.n == 9 and args.impl.captures.n == 0


@pytest.mark.parametrize("thresholds", [
    {"max_pages": 1},                      # force the sort plan
    {"max_pages": 1 << 16, "min_queries": 1, "min_depth": 1},  # histogram
])
def test_specialized_matches_across_plan_constructions(thresholds):
    """Both plan methods give the specialized answers of the reference."""
    keys, vals, qs = _data(np.int32)
    with ref_schedule.plan_thresholds(**thresholds), \
            pt_schedule.plan_thresholds(**thresholds):
        ref = ref_core.build_index(keys, vals, ref_core.IndexConfig(
            kind="tiered", specialize=True))
        spec = pt_index(keys, vals, kind="tiered", specialize=True)
        args = pt_index(keys, vals, kind="tiered")
        want = np.asarray(ref.search(qs))
        assert_same(spec.search(qs), want, "search")
        assert_same(args.search(qs), want, "search")


def test_specialize_rejects_host_plan():
    for cfg in (pt_core.IndexConfig, ref_core.IndexConfig):
        with pytest.raises(ValueError, match="device plan"):
            cfg(kind="tiered", plan="host", specialize=True)


# ------------------------------------------------------------- mutable store
def store_pair(keys, vals, **cfg):
    cfg = dict(kind="tiered", mutable=True, **cfg)
    ref = ref_core.build_index(keys, vals, ref_core.IndexConfig(
        specialize=True, **cfg))
    spec = pt_index(keys, vals, specialize=True, **cfg)
    args = pt_index(keys, vals, **cfg)
    return ref, spec, args


def test_mutable_specialized_tracks_reference_through_writes():
    """Lockstep with the reference's specialized store and the port's args
    store: delta-only writes, a page-local fold (the port's twin stays
    armed, with no new arm), then a fold that repacks (one re-arm)."""
    keys, vals, qs = _data(np.int32, n=3000)
    ref, spec, args = store_pair(keys, vals, delta_capacity=64,
                                 leaf_width=128)
    assert spec._spec_fused is not None and args._spec_fused is None
    assert spec.captures.n == 1
    probe = np.concatenate([qs, np.arange(64, dtype=np.int32) * 5 + 1])[:96]
    rng = np.random.default_rng(3)
    stores = (ref, spec, args)
    assert_lookups(spec, (ref, args), probe)
    for _ in range(2):
        newk = rng.choice(1 << 20, 24, replace=False).astype(np.int32)
        for idx in stores:
            idx.insert(newk, newk % 1000)
            idx.delete(newk[:4])
        assert_lookups(spec, (ref, args), probe)
    derives = spec.base.derives
    for idx in stores:
        idx.flush()                           # page-local folds
    assert spec.stats == ref.stats == args.stats
    assert spec.stats["merges"] > 0 and spec.base.derives == derives
    assert spec._spec_fused is not None and spec.captures.n == 1
    assert_lookups(spec, (ref, args), probe)
    # one fold that must repack: a run of new keys inside one page
    crowd = (keys[10] + 1 + np.arange(100)).astype(np.int32)
    crowd = crowd[~np.isin(crowd, keys)][:60]
    for idx in stores:
        idx.insert(crowd, crowd % 7)
        idx.flush()
    assert spec.stats["splits"] >= 1 and spec.base.derives == derives + 1
    assert spec.stats == ref.stats
    assert spec._spec_fused is not None and spec.captures.n == 2
    assert_lookups(spec, (ref, args), probe)
    # the store's scans keep their operands as arguments: equal anyway
    lo, hi = np.asarray([0], np.int32), np.asarray([1 << 21], np.int32)
    for f in ("count", "vsum"):
        assert_same(getattr(spec.scan_range(lo, hi), f),
                    getattr(ref.scan_range(lo, hi), f), f)
    for idx in stores:
        idx.close()


def test_snapshot_restore_rearms_specialization(tmp_path):
    """A restore is a derive boundary: the restored store comes back with
    the twin armed (one arm) and the answers of before the save."""
    keys, vals, qs = _data(np.int32, n=1500)
    cfg = pt_core.IndexConfig(kind="tiered", mutable=True, specialize=True,
                              delta_capacity=64,
                              ckpt_dir=str(tmp_path / "ck"))
    idx = pt_core.build_index(keys, vals, cfg, device="cpu")
    idx.insert(np.asarray([7, 9], np.int32), np.asarray([70, 90], np.int32))
    idx.save()
    want = idx.lookup(qs)
    idx.close()
    got = pt_core.restore_index(str(tmp_path / "ck"), cfg, device="cpu")
    assert got._spec_fused is not None and got.captures.n == 1
    res = got.lookup(qs)
    for f in ("rank", "found", "values"):
        assert_same(getattr(res, f), getattr(want, f), f)
    got.close()


@pytest.mark.parametrize("specialize", [False, True])
def test_upserts_between_derives_add_no_arm(specialize):
    """After warm-up, insert -> lookup cycles that stay between derives (no
    seal, no fold) arm nothing, in both postures, and answer the oracle."""
    keys, vals, _ = _data(np.int32, n=2000)
    idx = pt_index(keys, vals, kind="tiered", mutable=True,
                   specialize=specialize, delta_capacity=1024)
    q = torch.from_numpy(keys[:256])
    batch = np.arange(16, dtype=np.int32)
    idx.insert(batch * 2 + 1, batch)
    idx.lookup(q)
    derives0, arms0 = idx.base.derives, idx.captures.n
    assert arms0 == int(specialize)
    for r in range(1, 6):
        idx.insert(batch * 2 + 1, batch + r)         # upserts: no growth
        res = idx.lookup(torch.from_numpy(batch * 2 + 1))
        np.testing.assert_array_equal(res.values.numpy(), batch + r)
        idx.lookup(q)
    assert idx.base.derives == derives0 and idx.captures.n == arms0
    idx.close()


# ----------------------------------------------------------- one op a call
def test_specialized_paths_record_one_op_a_call():
    """One engine_ops observation a call, at the reference's paths: the
    store's lookup at path=lookup, the frozen search and lookup at
    path=search."""
    keys, vals, _ = _data(np.int32, n=2000)
    store = pt_index(keys, vals, kind="tiered", mutable=True,
                     specialize=True)
    frozen = pt_index(keys, vals, kind="tiered", specialize=True)
    q = torch.from_numpy(keys[:128])
    store.lookup(q)
    frozen.lookup(q)
    with use_registry(Registry()) as reg:
        res = store.lookup(q)
        assert reg.total("engine_ops", path="lookup") == 1
        assert reg.merged_histogram("engine_op_seconds",
                                    path="lookup").count == 1
        out = frozen.search(q)
        assert reg.total("engine_ops", path="search") == 1
        hit = frozen.lookup(q)
        assert reg.total("engine_ops", path="search") == 2
    assert bool(res.found.all()) and bool(hit.found.all())
    assert torch.equal(out, hit.rank)
    np.testing.assert_array_equal(hit.values.numpy(), vals[:128])
    store.close()
