"""Durability of the port's mutable store (``repro_torch/ckpt``,
``MutableIndex.save`` / ``restore``, ``core.restore_index``) on the CPU.

The seven cases of the reference's ``tests/test_durability.py``, on the
port: bit-flipped and truncated snapshots fall back to the previous step,
snapshot plus journal replay, the kill point on a torn journal, a
corrupted latest snapshot, the segment round trip, compaction and the
rotation that compacts. Restored stores are compared with live ones
through lookups and a range scan, bit for bit (int32 values: no
tolerance). Besides: the port's journal segments equal the reference's
byte for byte for the same writes (int32 and float32 keys), and a
checkpoint directory written by either package restores in the other."""
import os
import warnings

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.ckpt import journal as ref_jr

import repro_torch.core as pt_core
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import journal as jr
from repro_torch.engine import store as pt_store

torch.set_num_threads(1)


def _cfg(tmp=None, capacity=32, core=pt_core, **kw):
    return core.IndexConfig(kind="tiered", mutable=True,
                            delta_capacity=capacity, leaf_width=128,
                            ckpt_dir=tmp, **kw)


def _build(keys, vals, cfg):
    return pt_core.build_index(keys, vals, cfg, device="cpu")


def _restore(d, cfg=None):
    return pt_core.restore_index(d, cfg or _cfg(), device="cpu")


def _flip_byte(path, where=0.5):
    sz = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(int(sz * where))
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def _snapshot_results(idx, probe):
    """(found, values, count, sum) of a lookup and a scan, on the host."""
    port = isinstance(idx, pt_store.MutableIndex)
    q = torch.from_numpy(np.asarray(probe, np.int32)) if port \
        else np.asarray(probe, np.int32)
    res = idx.lookup(q)
    scan = idx.scan_range(np.asarray([0], np.int32),
                          np.asarray([1 << 20], np.int32))
    return (np.asarray(res.found), np.asarray(res.values),
            int(np.asarray(scan.count)[0]), int(np.asarray(scan.vsum)[0]))


def _assert_same(a, b):
    fa, va, ca, sa = a
    fb, vb, cb, sb = b
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(va[fa], vb[fb])
    assert (ca, sa) == (cb, sb)


# --------------------------------------------------------------- checkpoint
def test_checkpoint_bitflip_and_truncation_fall_back(tmp_path):
    """A bit-flipped or truncated newest snapshot fails deep verification
    and degrades, with a warning, to the previous step."""
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": np.arange(64, dtype=np.int32)})
    ckpt.save(d, 2, {"w": np.arange(64, dtype=np.int32) * 7})
    _flip_byte(os.path.join(d, "step_00000002", "arrays.host0.npz"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tree, step = ckpt.restore(d)
    assert step == 1 and np.array_equal(tree["w"], np.arange(64))
    assert any("falling back to step 1" in str(x.message) for x in w)

    ckpt.save(d, 3, {"w": np.arange(64, dtype=np.int32) * 9})
    npz = os.path.join(d, "step_00000003", "arrays.host0.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("ignore")
        tree, step = ckpt.restore(d)
    assert step == 1                       # step 2 still corrupt, falls to 1
    tree, step = ckpt.restore(d, step=1)
    assert step == 1 and tree["w"][5] == 5


def test_checkpoint_names_match_the_reference(tmp_path):
    """Nested trees flatten to the reference's "a/b" names, so each
    package's checkpoint module reads the other's snapshots."""
    from repro.ckpt import checkpoint as ref_ckpt
    tree = {"b": {"y": np.arange(3), "x": np.ones((2, 2), np.float32)},
            "a": np.int64(4), "c": [np.zeros(1), np.ones(1)]}
    flat = ckpt._flatten(tree)
    assert list(flat) == list(ref_ckpt._flatten(tree)[0])
    d = str(tmp_path / "ck")
    ref_ckpt.save(d, 1, tree)
    raw, step = ckpt.restore(d)
    assert step == 1 and sorted(raw) == sorted(flat)
    ckpt.save(d, 2, tree)
    raw, step = ref_ckpt.restore(d, None)
    assert step == 2
    for k in flat:
        np.testing.assert_array_equal(raw[k], flat[k])


# ------------------------------------------------------------ journal replay
def test_snapshot_plus_journal_replay_is_bit_identical(tmp_path):
    """save -> more writes (deletes, re-inserts of deleted keys) -> close
    -> restore: the restored store answers lookups and scans bit for bit,
    without an O(n) rebuild, and keeps journaling."""
    d = str(tmp_path / "ck")
    rng = np.random.default_rng(7)
    init = np.sort(rng.choice(1 << 18, 150, replace=False)).astype(np.int32)
    idx = _build(init, np.arange(150, dtype=np.int32), _cfg(d))
    keys = rng.choice(1 << 19, 120, replace=False).astype(np.int32)
    idx.insert(keys[:60], keys[:60] * 2)
    idx.delete(keys[:20])
    idx.save()
    idx.insert(keys[60:], keys[60:] * 3)
    idx.delete(keys[60:80])
    idx.insert(keys[60:70], keys[60:70] * 5)
    probe = np.concatenate([init[::7], keys, [np.int32((1 << 19) + 1)]])
    want = _snapshot_results(idx, probe)
    idx.close()

    got = _restore(d)
    assert got.stats["journal_replayed"] == 60 + 20 + 10
    _assert_same(want, _snapshot_results(got, probe))
    got.insert(np.asarray([3], np.int32), np.asarray([33], np.int32))
    want2 = _snapshot_results(got, probe)
    got.close()
    again = _restore(d)
    _assert_same(want2, _snapshot_results(again, probe))
    again.close()


def test_kill_point_torn_journal_serves_write_prefix(tmp_path):
    """The journal's final record is torn mid-write: restore serves the
    state of a never-crashed store that made every write but that one."""
    d = str(tmp_path / "ck")
    rng = np.random.default_rng(11)
    init = np.sort(rng.choice(1 << 16, 100, replace=False)).astype(np.int32)
    vals = np.arange(100, dtype=np.int32)
    keys = rng.choice(1 << 17, 40, replace=False).astype(np.int32)
    idx = _build(init, vals, _cfg(d))
    idx.insert(keys[:20], keys[:20] * 2)
    idx.save()
    idx.insert(keys[20:], keys[20:] * 3)
    idx.delete(keys[:5])
    idx.insert(np.asarray([keys[0]], np.int32), np.asarray([999], np.int32))
    idx.close()

    oracle = _build(init, vals, _cfg())
    oracle.insert(keys[:20], keys[:20] * 2)
    oracle.insert(keys[20:], keys[20:] * 3)
    oracle.delete(keys[:5])

    last = jr.scan_dir(d)[-1][1]
    with open(last, "r+b") as f:                 # tear mid-record
        f.truncate(os.path.getsize(last) - 7)
    got = _restore(d)
    probe = np.concatenate([init[::5], keys])
    _assert_same(_snapshot_results(oracle, probe),
                 _snapshot_results(got, probe))
    got.close()


def test_corrupted_latest_snapshot_degrades_without_data_loss(tmp_path):
    """A corrupted newest snapshot falls back to the previous step with a
    warning, and that step's journal segment covers the gap."""
    d = str(tmp_path / "ck")
    rng = np.random.default_rng(13)
    init = np.sort(rng.choice(1 << 16, 80, replace=False)).astype(np.int32)
    idx = _build(init, np.arange(80, dtype=np.int32), _cfg(d))
    keys = rng.choice(1 << 17, 30, replace=False).astype(np.int32)
    idx.insert(keys[:10], keys[:10] * 2)
    idx.save()                                       # step 1
    idx.insert(keys[10:20], keys[10:20] * 3)
    idx.delete(keys[:4])
    idx.save()                                       # step 2
    idx.insert(keys[20:], keys[20:] * 4)
    probe = np.concatenate([init[::4], keys])
    want = _snapshot_results(idx, probe)
    idx.close()

    _flip_byte(os.path.join(d, "step_00000002", "arrays.host0.npz"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _restore(d)
    assert any("falling back" in str(x.message) for x in w)
    _assert_same(want, _snapshot_results(got, probe))
    got.close()


def test_journal_segment_roundtrip_and_torn_tail(tmp_path, monkeypatch):
    """CRC-checked records round-trip, a torn tail truncates to the valid
    prefix, and the reader stops there."""
    p = str(tmp_path / "journal_00000000.log")
    fsyncs = []
    real_fsync = os.fsync
    monkeypatch.setattr(jr.os, "fsync",
                        lambda fd: (fsyncs.append(fd), real_fsync(fd)))
    j = jr.Journal(p, np.dtype(np.int32))
    j.append_many([5], [50])
    j.flush()
    j.append_many([9], [-1], delete=True)
    j.append_many([7], [70])
    j.flush()
    assert fsyncs == []                              # "rotate": not a flush
    j.close()
    assert len(fsyncs) == 1                          # "rotate": at close
    monkeypatch.undo()
    dtype, recs = jr.read_segment(p)
    assert dtype == np.dtype(np.int32)
    assert [(r[1], r[2]) for r in recs] == [
        (jr.OP_INSERT, 5), (jr.OP_DELETE, 9), (jr.OP_INSERT, 7)]
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 3)
    assert len(jr.read_segment(p)[1]) == 2
    jr.truncate_torn(p)
    _, recs2 = jr.read_segment(p)
    assert len(recs2) == 2 and os.path.getsize(p) == jr.HEADER.size \
        + 2 * jr.RECORD.size
    with pytest.raises(ValueError, match="fsync"):
        jr.Journal(p, np.int32, fsync="sometimes")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_append_many_batch_equals_single_records(tmp_path, dtype):
    """A batch packed at once is the records of one-key batches written
    one by one (float keys as float64 bits, signed zero and infinities
    too)."""
    rng = np.random.default_rng(29)
    keys = rng.integers(-2**31, 2**31 - 1, 50).astype(dtype)
    if dtype == np.float32:
        keys[:3] = [-0.0, np.inf, -np.inf]
    vals = rng.integers(-2**31, 2**31 - 1, 50).astype(np.int32)
    blobs = []
    for name in ("one", "many"):
        p = str(tmp_path / f"journal_{name}.log")
        j = jr.Journal(p, np.dtype(dtype), next_seq=7)
        if name == "one":
            for k, v in zip(keys, vals):
                j.append_many([k], [v])
            for k in keys[:5]:
                j.append_many([k], [0], delete=True)
        else:
            j.append_many(keys, vals)
            j.append_many(keys[:5], np.zeros(5, np.int32), delete=True)
            j.append_many(keys[:0], vals[:0])
        assert j.seq == 7 + 55
        j.close()
        with open(p, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]


def test_compact_segment_keeps_last_writer_per_key(tmp_path):
    """N overwrites of a key collapse to the final record (a final
    tombstone survives), sequence numbers stay monotone, and a minimal
    segment is left alone."""
    p = str(tmp_path / "journal_00000000.log")
    j = jr.Journal(p, np.dtype(np.int32))
    for r in range(5):
        j.append_many([10], [r])
    j.append_many([20], [7])
    j.append_many([30], [1])
    j.append_many([30], [-1], delete=True)
    j.close()
    assert jr.compact_segment(p) == 5
    _, recs = jr.read_segment(p)
    assert [(r[1], r[2], r[3]) for r in recs] == [
        (jr.OP_INSERT, 10, 4), (jr.OP_INSERT, 20, 7),
        (jr.OP_DELETE, 30, -1)]
    seqs = [r[0] for r in recs]
    assert seqs == sorted(seqs)
    assert jr.compact_segment(p) == 0
    assert os.path.getsize(p) == jr.HEADER.size + 3 * jr.RECORD.size


def test_rotation_compacts_upsert_heavy_segment(tmp_path):
    """Rotation compacts the closed segment to one record a key, and a
    restore that falls back to the previous snapshot replays the compacted
    segment to the live store's state."""
    d = str(tmp_path / "ck")
    rng = np.random.default_rng(17)
    init = np.sort(rng.choice(1 << 16, 100, replace=False)).astype(np.int32)
    hot = np.arange(8, dtype=np.int32) + (1 << 18)
    idx = _build(init, np.arange(100, dtype=np.int32), _cfg(d, capacity=16))
    idx.save()                                       # step 1
    for r in range(1, 11):
        idx.insert(hot, np.full(8, r, np.int32))
    idx.delete(hot[:2])
    idx.save()                                       # step 2: compacts 1
    _, recs = jr.read_segment(jr.segment_path(d, 1))
    assert len(recs) == 8                            # 82 records -> 8
    seqs = [r[0] for r in recs]
    assert seqs == sorted(seqs)
    by_key = {k: (op, v) for _, op, k, v in recs}
    for k in hot[:2]:
        assert by_key[int(k)][0] == jr.OP_DELETE
    for k in hot[2:]:
        assert by_key[int(k)] == (jr.OP_INSERT, 10)
    probe = np.concatenate([init[::5], hot])
    want = _snapshot_results(idx, probe)
    idx.close()
    _flip_byte(os.path.join(d, "step_00000002", "arrays.host0.npz"))
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        got = _restore(d)
    assert got.stats["journal_replayed"] == 8
    _assert_same(want, _snapshot_results(got, probe))
    got.close()


# ------------------------------------------------ the reference's files
def _writes(store, keys, dtype):
    """Saves, inserts, deletes, upserts and a seal: the same calls to
    either package's store."""
    k = keys.astype(dtype)
    store.insert(k[:30], np.arange(30, dtype=np.int32) * 3)
    store.delete(k[:5])
    store.save()
    store.insert(k[30:], np.arange(k.size - 30, dtype=np.int32) - 7)
    store.insert(k[10:20], np.full(10, 11, np.int32))
    store.delete(k[40:45])
    store.save()
    store.insert(k[:3], np.asarray([1, 2, 3], np.int32))
    store.close()


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_journal_bytes_equal_the_reference(tmp_path, dtype):
    """The same writes journal the same segment files, byte for byte, in
    either package (float keys as float64 bit patterns)."""
    rng = np.random.default_rng(19)
    init = np.unique(rng.integers(0, 1 << 16, 200)).astype(dtype)
    keys = rng.choice(1 << 17, 80, replace=False)
    dirs = [str(tmp_path / name) for name in ("ref", "port")]
    _writes(ref_core.build_index(init, None, _cfg(dirs[0], core=ref_core)),
            keys, dtype)
    _writes(_build(init, None, _cfg(dirs[1])), keys, dtype)
    segs = [jr.scan_dir(d) for d in dirs]
    assert [s for s, _ in segs[0]] == [s for s, _ in segs[1]] == [1, 2]
    for (_, a), (_, b) in zip(*segs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)
    assert ref_jr.read_segment(segs[1][-1][1]) == \
        jr.read_segment(segs[1][-1][1])


def _probe_both(live_ref, store, keys):
    """A restored port store answers as the live reference store does."""
    q = np.concatenate([keys, keys + 1])
    lo = np.sort(keys)[::4]
    hi = lo + 5000
    want = live_ref.lookup(q)
    got = store.lookup(torch.from_numpy(q))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    np.testing.assert_array_equal(got.values.numpy()[got.found.numpy()],
                                  np.asarray(want.values)[np.asarray(
                                      want.found)])
    w = live_ref.scan_range(lo, hi)
    g = store.scan_range(torch.from_numpy(lo), torch.from_numpy(hi))
    for f in ("count", "vsum", "vmin", "vmax", "r_lo"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(w, f)), err_msg=f)


def test_checkpoints_restore_across_packages(tmp_path):
    """A directory the reference wrote (snapshots and a journal tail with
    a torn last record) restores in the port, and one the port wrote
    restores in the reference, each equal to the live writer."""
    rng = np.random.default_rng(23)
    init = np.unique(rng.integers(0, 1 << 16, 300)).astype(np.int32)
    keys = rng.choice(1 << 17, 80, replace=False).astype(np.int32)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    live = ref_core.build_index(init, None, _cfg(d_ref, core=ref_core))
    _writes(live, keys, np.int32)
    got = _restore(d_ref)
    assert got.stats["journal_replayed"] == 3
    _probe_both(live, got, keys)
    got.close()

    port = _build(init, None, _cfg(d_port))
    _writes(port, keys, np.int32)
    back = ref_core.restore_index(d_port, _cfg(core=ref_core))
    assert back.stats["journal_replayed"] == 3
    _probe_both(back, _restore(d_port), keys)
    back.close()


def test_save_restore_surface():
    idx = _build(np.arange(10, dtype=np.int32), None, _cfg())
    with pytest.raises(ValueError, match="no checkpoint directory"):
        idx.save()
    with pytest.raises(ValueError, match="mutable"):
        pt_core.restore_index("unused", pt_core.IndexConfig(kind="tiered"))
    frozen = pt_core.build_index(np.arange(10, dtype=np.int32),
                                 config=pt_core.IndexConfig(kind="tiered"),
                                 device="cpu")
    for call in (lambda: frozen.save("unused"), lambda: frozen.delete([1])):
        with pytest.raises(TypeError, match="immutable"):
            call()
