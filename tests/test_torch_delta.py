"""The port's delta buffer (``repro_torch/engine/delta.py``) against the
reference's (``repro/engine/delta.py``).

The same writes go to both buffers: their host arrays (keys, values, the
sb / ss / tombstone bit planes, node counts, node maxima) and counters
must stay equal bit for bit through inserts, upserts, respreads,
``sync``, ``promote_ss`` and ``drain``; the port's torch probes must equal
the reference's jnp probes bit for bit, the sentinel quirk included (a
query equal to the key sentinel matches every gap slot of its node)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import delta as ref_delta

from repro_torch.engine import delta as pt_delta

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
ARRAYS = ("h_keys", "h_vals", "h_shadow", "h_ss", "h_tomb", "h_cnt",
          "node_max")
COUNTERS = ("capacity", "nn", "node_width", "count", "tombs", "respreads")


def pair(capacity, dtype=np.int32, node_width=pt_delta.DEFAULT_NODE_WIDTH):
    return (ref_delta.DeltaBuffer(capacity, dtype, node_width),
            pt_delta.DeltaBuffer(capacity, dtype, node_width, device="cpu"))


def assert_same(ref, pt, counters=COUNTERS):
    for name in ARRAYS:
        a, b = getattr(ref, name), getattr(pt, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)
    for name in counters:
        assert getattr(ref, name) == getattr(pt, name), name


def both(bufs, method, *args, **kw):
    """Call ``method`` on both buffers; their results (or errors) agree."""
    out = []
    for buf in bufs:
        try:
            out.append(("ok", getattr(buf, method)(*args, **kw)))
        except ValueError as e:
            out.append(("raises", str(e)))
    (ka, a), (kb, b) = out
    assert ka == kb, (method, out)
    if ka == "raises":
        assert a == b
    assert_same(*bufs)
    return a, b


def same_results(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same_results(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_results(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# ------------------------------------------------------ host write traces
def test_sorted_gapped_trace_matches_reference():
    """Mirror of the reference's sorted-and-gapped test: 60 keys into 8
    nodes of 8 slots (respreads on node overflow), then upserts that flip
    each bit plane, syncs, promote_ss and drain — equal after every call."""
    bufs = pair(64, node_width=8)
    rng = np.random.default_rng(0)
    ks = rng.permutation(np.arange(0, 300, 5)).astype(np.int32)[:60]
    for i, k in enumerate(ks.tolist()):
        a, b = both(bufs, "insert", k, i, shadows=bool(i % 3 == 0),
                    shadows_sealed=bool(i % 5 == 0), tomb=bool(i % 7 == 0))
        assert a is b is True
    assert bufs[1].respreads > 0
    for i, k in enumerate(ks[::4].tolist()):          # upserts flip the bits
        a, b = both(bufs, "insert", k, -i, shadows=bool(i % 2),
                    shadows_sealed=bool(i % 3), tomb=bool(i % 2 == 0))
        assert a is b is False
    for k in (0, 5, 7, 299, 1000):
        same_results(*both(bufs, "find", k))
    for k in ks[:10].tolist():
        slot = bufs[1].find(k)
        both(bufs, "sync", slot, 77, bool(k % 2))
    same_results(*both(bufs, "entries"))
    same_results(*both(bufs, "live"))
    both(bufs, "promote_ss")
    same_results(*both(bufs, "state"))
    same_results(*both(bufs, "drain"))
    assert bufs[1].count == 0 and bufs[1].tombs == 0


def test_full_upsert_and_capacity_match_reference():
    bufs = pair(16, node_width=4)
    for k in range(16):
        both(bufs, "insert", k, k)
    assert bufs[1].full
    a, b = both(bufs, "insert", 3, 999)              # upsert: no raise
    assert a is b is False
    both(bufs, "insert", 100, 1)                     # full: both raise
    both(bufs, "insert", I32.max, 1)                 # the sentinel key
    ks, vs, tb = both(bufs, "drain")[1]
    assert not tb.any() and dict(zip(ks.tolist(), vs.tolist()))[3] == 999
    for cap in (1, 5, 100, 1024):
        assert pt_delta.DeltaBuffer(cap, device="cpu").capacity == \
            ref_delta.DeltaBuffer(cap).capacity
    for cap in (0, -3):
        with pytest.raises(ValueError, match="positive"):
            pt_delta.DeltaBuffer(cap, device="cpu")


def test_float32_signed_zeros_are_one_key():
    bufs = pair(32, dtype=np.float32, node_width=4)
    for i, k in enumerate([0.0, 1.5, -2.0, -0.0, 3.0, 0.0, -1e30, 1e30]):
        both(bufs, "insert", np.float32(k), i, tomb=bool(i == 5))
    assert bufs[1].count == 6 and bufs[1].tombs == 1
    same_results(*both(bufs, "find", np.float32(-0.0)))
    both(bufs, "insert", np.float32(np.inf), 1)      # the float sentinel


def test_state_round_trip():
    _, buf = pair(64, node_width=8)
    rng = np.random.default_rng(3)
    for k in rng.integers(0, 500, 50).astype(np.int32).tolist():
        buf.insert(k, k * 3, shadows=bool(k % 2), tomb=bool(k % 11 == 0))
    back = pt_delta.DeltaBuffer.from_state(buf.state(), device="cpu")
    assert buf.respreads > 0 and back.respreads == 0  # not in the snapshot
    assert_same(buf, back, [c for c in COUNTERS if c != "respreads"])
    ref = ref_delta.DeltaBuffer.from_state(buf.state())
    assert_same(ref, back)
    bad = dict(buf.state(), keys=np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="shape mismatch"):
        pt_delta.DeltaBuffer.from_state(bad, device="cpu")


def test_device_mirrors_are_cached_copies():
    _, buf = pair(32, node_width=4)
    buf.insert(5, 50)
    dk, dv, ds = buf.device_state()
    assert buf.device_state()[0] is dk               # cached until mutation
    assert dk.dtype == torch.int32 and dv.dtype == torch.int32
    assert ds.shape == (buf.nn,) and dk.shape == (buf.nn, 4)
    assert buf.device_bits()[2].dtype == torch.bool
    before = dk.clone()
    buf.insert(6, 60)                                 # the mirror is a copy
    assert torch.equal(dk, before) and buf.device_state()[0] is not dk
    assert torch.equal(buf.device_state()[0], torch.from_numpy(buf.h_keys))
    assert not torch.equal(dk, buf.device_state()[0])


# ----------------------------------------------------------------- probes
def probe_case(dtype, seed):
    """A buffer with respread nodes, tombstones and gap slots, and queries:
    hits, misses, the sentinel, and for float32 signed zeros, infinities
    and NaN."""
    rng = np.random.default_rng(seed)
    ref, pt = pair(64, dtype=dtype, node_width=8)
    if dtype == np.int32:
        ks = rng.integers(-1000, 1000, 50)
        edge = [I32.min, I32.min + 1, -1, 0, I32.max - 1, I32.max]
    else:
        ks = rng.normal(size=50) * 100
        ks[:2] = [0.0, -1e30]
        edge = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e30, -1e30]
    vals = rng.integers(I32.min + 1, I32.max, ks.size)
    for i, k in enumerate(ks.astype(dtype).tolist()):
        for buf in (ref, pt):
            buf.insert(k, int(vals[i]) if i % 4 else I32.min,
                       tomb=bool(i % 4 == 0))
    q = np.concatenate([ks[::2], rng.normal(size=40) * 1000,
                        edge]).astype(dtype)
    return ref, pt, q


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_probes_match_reference_bit_for_bit(dtype):
    ref, pt, q = probe_case(dtype, 7)
    assert_same(ref, pt)
    rk, rv, rs = ref.device_state()
    _, _, rtb = ref.device_bits()
    pk, pv, ps = pt.device_state()
    _, _, ptb = pt.device_bits()
    qt = torch.from_numpy(q)
    want = ref_delta.probe(jnp.asarray(q), rk, rv, rs)
    got = pt_delta.probe(qt, pk, pv, ps)
    want_full = ref_delta.probe_full(jnp.asarray(q), rk, rv, rtb, rs)
    got_full = pt_delta.probe_full(qt, pk, pv, ptb, ps)
    for w, g in zip((*want, *want_full), (*got, *got_full)):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)
    hit, tomb, val = got_full
    assert tomb.any() and (val[tomb] == I32.min).all()
    sentinel = torch.from_numpy(q == pt.sentinel)
    assert hit[sentinel].all()         # the reference's quirk, kept: a gap
    assert (val[sentinel] == 0).all()  # slot holds the sentinel, value 0
    if dtype == np.float32:
        assert not hit[torch.isnan(qt)].any()


def test_probe_of_an_empty_buffer_never_hits():
    ref, pt = pair(32)
    q = np.array([-5, 0, 7, I32.max - 1], np.int32)
    dk, dv, ds = pt.device_state()
    hit, tomb, val = pt_delta.probe_full(torch.from_numpy(q), dk, dv,
                                         pt.device_bits()[2], ds)
    assert not hit.any() and not tomb.any() and not val.any()
    want = ref_delta.probe(jnp.asarray(q), *ref.device_state())
    got = pt_delta.probe(torch.from_numpy(q), *pt.device_state())
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_probe_layouts_match_reference(dtype):
    """Every fill of a buffer of four 4-slot nodes, keys inserted in
    ascending and in random order: empty tail nodes, a full last node
    after nodes with gaps, a full buffer. The sentinel query hits exactly
    where the reference's node for it has a gap slot; keys, their
    neighbours, -0.0 and NaN agree too."""
    rng = np.random.default_rng(9)
    layouts = set()
    for n in range(17):
        for order in ("ascending", "random", "random"):
            ref, pt = pair(16, dtype=dtype, node_width=4)
            ks = rng.choice(200, n, replace=False) - 100
            if order == "ascending":
                ks = np.sort(ks)
            for i, k in enumerate(ks.astype(dtype).tolist()):
                for buf in (ref, pt):
                    buf.insert(k, i + 1, tomb=i % 3 == 0)
            cnt = pt.h_cnt
            layouts.add("empty node" if (cnt == 0).any() else
                        "last node full" if cnt[-1] == 4 else "last gap")
            body = np.concatenate([[-1000, 1000, -0.0], ks, ks + 1,
                                   [np.nan] if dtype == np.float32 else []])
            # one query shape: the reference's jnp ops compile once
            q = np.append(np.resize(body, 39), pt.sentinel).astype(dtype)
            rk, rv, rs = ref.device_state()
            pk, pv, ps = pt.device_state()
            want = ref_delta.probe_full(jnp.asarray(q), rk, rv,
                                        ref.device_bits()[2], rs)
            got = pt_delta.probe_full(torch.from_numpy(q), pk, pv,
                                      pt.device_bits()[2], ps)
            want += ref_delta.probe(jnp.asarray(q), rk, rv, rs)
            got += pt_delta.probe(torch.from_numpy(q), pk, pv, ps)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), np.array(w))
                assert g.dtype == torch.from_numpy(np.array(w)).dtype
            assert bool(got[0][-1]) == (pt.count < pt.capacity and (
                (cnt == 0).any() or cnt[-1] < 4))
    assert layouts == {"empty node", "last node full", "last gap"}
