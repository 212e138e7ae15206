"""The port's serving stack against the reference: the CDF inversion
(``kernels/cdf_search.py``, ``ops.topp_search``), the sampler, the prefix
page store, the engine as a whole, and the launcher (its count lines for
the queue, tenant and telemetry flags are the reference launcher's).

On the CPU the port's inversion is its plain version; it must be
bit-identical to the reference's Pallas kernel (interpret mode), its jnp
oracle ``invert_cdf`` and the numpy oracle ``cdf_search_ref``. The engine
runs the reference's weights (``from_reference_params``) at
``qwen3-0.6b``'s reduced width through the immutable tiered prefix store
and through the mutable store, the default: greedy tokens, prefix-reuse
counts, store stats and the mutable store's write-path counters must be
identical."""
import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.core import IndexConfig as RefIndexConfig
from repro.kernels import cdf_search as ref_cdf
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.models import transformer as ref_T
from repro.serve import SamplerConfig as RefSamplerConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import kv_cache as ref_kv
from repro.serve import sampler as ref_sampler

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import IndexConfig
from repro_torch.engine import schedule as pt_schedule
from repro_torch.engine.queue import MicroBatchQueue, tenant_summary
from repro_torch.kernels import cdf_search as pt_cdf
from repro_torch.kernels import ops as pt_ops
from repro_torch.launch import serve as pt_launch
from repro_torch.models import transformer as pt_T
from repro_torch.serve import SamplerConfig, ServeEngine
from repro_torch.serve import kv_cache as pt_kv
from repro_torch.serve import sampler as pt_sampler
from repro_torch.tune import profile as pt_profile

torch.set_num_threads(1)

WHOLESALE = dict(kind="tiered", plan="device", mutable=False)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def sorted_cdfs(rng, B: int, V: int) -> np.ndarray:
    p = rng.dirichlet(np.ones(V), size=B).astype(np.float32)
    return np.cumsum(np.sort(p, axis=-1)[:, ::-1], axis=-1)


def all_inversions_agree(cdf: np.ndarray, u: np.ndarray,
                         searchable=slice(None)) -> np.ndarray:
    """The port's three entry points against the reference's Pallas
    kernel (interpret mode) and jnp oracle, bit for bit, and on the
    ``searchable`` rows (nondecreasing, no NaN) against the numpy binary
    search; returns the indices."""
    want = np.asarray(ref_cdf.invert_cdf(jnp.asarray(cdf), jnp.asarray(u)))
    np.testing.assert_array_equal(
        np.asarray(ref_ops.topp_search(cdf, u, tile_b=4, chunk=128)), want)
    np.testing.assert_array_equal(
        ref_oracles.cdf_search_ref(cdf[searchable], u[searchable]),
        want[searchable])
    for fn in (pt_cdf.invert_cdf, pt_cdf.cdf_search, pt_ops.topp_search):
        got = fn(t(cdf), t(u))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    return want


# ------------------------------------------------------------- the kernel
@pytest.mark.parametrize("B,V", [(4, 100), (8, 512), (3, 1000), (16, 2048)])
def test_cdf_inversion_matches_pallas_kernel(B, V):
    rng = np.random.default_rng(B * V)
    cdf = sorted_cdfs(rng, B, V)
    u = rng.uniform(0, 1, B).astype(np.float32)
    all_inversions_agree(cdf, u)


def test_cdf_inversion_edges():
    """u at 0, 1e-6, on a cdf entry, above cdf[-1] (V - 1), inside a flat
    run; rows padded with +inf; a NaN in u or cdf compares false; a row
    that is not monotone counts, as the reference does."""
    V = 16
    base = np.linspace(0.05, 1.0, V).astype(np.float32)
    flat = base.copy()
    flat[4:10] = flat[4]
    padded = base.copy()
    padded[12:] = np.inf
    rough = base[::-1].copy()                         # not monotone
    nan_row = base.copy()
    nan_row[3] = np.nan
    cdf = np.stack([base, base, base, base, flat, flat, padded, padded,
                    rough, nan_row, base])
    u = np.array([0.0, 1e-6, base[5], 1.5, flat[4], flat[4] + 1e-3,
                  base[11], 2.0, 0.5, 0.9, np.nan], np.float32)
    got = all_inversions_agree(cdf, u, searchable=slice(0, 8))
    assert (got[8], got[9]) == (8, 13)          # counts, not a binary search
    assert got[0] == 0 and got[3] == V - 1 and got[7] == 12    # +inf tail
    assert got[10] == 0
    empty = pt_cdf.cdf_search(torch.zeros((0, V)), torch.zeros(0))
    assert empty.shape == (0,) and empty.dtype == torch.int32


def test_cdf_search_rejects_bad_operands():
    with pytest.raises(ValueError, match="unsupported device"):
        pt_cdf.cdf_search(torch.zeros((1, 4), device="meta"),
                          torch.zeros(1, device="meta"))


# ------------------------------------------------------------- the sampler
@pytest.mark.parametrize("temperature,top_p,top_k,V",
                         [(1.0, 0.8, 0, 100), (0.7, 0.9, 0, 512),
                          (0.8, 0.95, 50, 512)])
def test_sampler_matches_reference(temperature, top_p, top_k, V):
    """The CDF build within 1e-6 and the same order where probabilities
    are apart; the port's inversion on the reference's (cdf, u) gives the
    reference's tokens, bit for bit."""
    rng = np.random.default_rng(V + top_k)
    logits = (rng.normal(size=(16, V)) * 3).astype(np.float32)
    rcfg = RefSamplerConfig(temperature=temperature, top_p=top_p, top_k=top_k)
    cfg = SamplerConfig(temperature=temperature, top_p=top_p, top_k=top_k)
    key = jax.random.PRNGKey(V)
    r_order, r_cdf, r_u = (np.asarray(a) for a in ref_sampler._nucleus_cdf(
        jnp.asarray(logits), key, rcfg))
    order, cdf = pt_sampler.nucleus_cdf(t(logits), cfg)
    np.testing.assert_allclose(cdf.numpy(), r_cdf, rtol=0, atol=1e-6)
    p = np.take_along_axis(np.asarray(jax.nn.softmax(
        jnp.asarray(logits) / temperature, -1)), r_order, -1)
    apart = np.ones_like(p, bool)
    apart[:, 1:] &= np.abs(np.diff(p, axis=-1)) > 1e-6
    apart[:, :-1] &= np.abs(np.diff(p, axis=-1)) > 1e-6
    if top_k:
        apart[:, top_k:] = False                 # masked: all probability 0
    np.testing.assert_array_equal(order.numpy()[apart], r_order[apart])
    idx = pt_ops.topp_search(t(r_cdf), t(r_u))
    toks = np.take_along_axis(r_order, idx.numpy()[:, None].astype(np.int64),
                              -1)[:, 0]
    np.testing.assert_array_equal(
        toks, np.asarray(ref_sampler.sample(jnp.asarray(logits), key, rcfg)))


def test_sample_greedy_and_nucleus_membership():
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(16, 100)) * 3).astype(np.float32)
    g = pt_sampler.sample(t(logits), SamplerConfig(temperature=0.0))
    np.testing.assert_array_equal(g.numpy(), logits.argmax(-1))
    assert g.dtype == torch.int32
    gen = torch.Generator().manual_seed(1)
    cfg = SamplerConfig(temperature=1.0, top_p=0.8)
    toks = pt_sampler.sample(t(logits), cfg, generator=gen)
    assert toks.shape == (16,) and toks.dtype == torch.int32
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    for b in range(16):
        order = np.argsort(-probs[b])
        cdf = np.cumsum(probs[b][order])
        nucleus = set(order[: int(np.searchsorted(cdf, 0.8, "left") + 1)])
        assert int(toks[b]) in nucleus
    _, cdf = pt_sampler.nucleus_cdf(t(logits), cfg)
    u = pt_sampler.draw_u(cdf, cfg, torch.Generator().manual_seed(3))
    assert bool(((u >= 1e-6 * 0.8 * 0.99) & (u < 0.8)).all())
    # the decode queue gives the inline sampler's tokens, one flush a call
    q = MicroBatchQueue(pt_cdf.cdf_probe_fn(), timer=False, path="decode")
    queued = pt_sampler.sample_queued(t(logits), cfg, q,
                                      generator=torch.Generator()
                                      .manual_seed(1))
    assert torch.equal(queued, toks) and q.stats.flushes == 1


# ------------------------------------------------------------- prefix store
def test_chain_hashes_match_reference():
    rng = np.random.default_rng(0)
    for page in (1, 4, 8, 16):
        for n in (0, 1, 7, 33, 128):
            toks = rng.integers(-2**40, 2**40, n)
            want = ref_kv.chain_hashes(toks, page)
            np.testing.assert_array_equal(pt_kv.chain_hashes(toks, page), want)
            np.testing.assert_array_equal(pt_kv.chain_hashes_ref(toks, page),
                                          want)


def test_prefix_store_forced_collision_truncates_at_verify():
    """Tokens differing by 2^31 in page 0 collide in the 31-bit hash:
    verification rejects the chain at page 0, on the port's tiered
    store as on the reference's."""
    stored = np.array([5, 6, 7], np.int64)
    probe = np.array([5 + 2**31, 6, 7], np.int64)
    np.testing.assert_array_equal(pt_kv.chain_hashes(stored, 1),
                                  pt_kv.chain_hashes(probe, 1))
    stores = [pt_kv.PrefixPageStore(1, IndexConfig(**WHOLESALE),
                                    device="cpu"),
              ref_kv.PrefixPageStore(1, RefIndexConfig(**WHOLESALE))]
    for store in stores:
        store.insert(stored, [{"pay": i} for i in range(3)])
        assert store.lookup(probe) == (0, [])
        n, p = store.lookup(stored)
        assert n == 3 and [x["pay"] for x in p] == [0, 1, 2]
        batch = store.lookup_batch([probe, stored, stored[:0]])
        assert [b[0] for b in batch] == [0, 3, 0]
    assert stores[0].stats == stores[1].stats


def test_prefix_store_mutable_default_matches_reference():
    """The mutable posture with a delta buffer of 4 (16, one node, once
    rounded): inserts go through the store's seals and folds (a base gets
    built, pages merge), never a rebuild. Probes (single and batched), stats and the write-path
    counters equal the reference's after every step."""
    cfg = dict(kind="tiered", plan="device", mutable=True, delta_capacity=4)
    stores = [pt_kv.PrefixPageStore(2, IndexConfig(**cfg), device="cpu"),
              ref_kv.PrefixPageStore(2, RefIndexConfig(**cfg))]
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 50, 8)
    prompts = [np.concatenate([shared[:int(rng.integers(2, 9))],
                               rng.integers(0, 50, 10)]) for _ in range(12)]

    def pay(i, p):
        return [{"pay": (i, j)} for j in range(len(p) // 2)]

    for i, p in enumerate(prompts):
        got = [s.lookup(p) for s in stores]
        assert got[0][0] == got[1][0]
        assert [x["pay"] for x in got[0][1]] == [x["pay"] for x in got[1][1]]
        for s in stores:
            s.insert(p, pay(i, p))
        assert stores[0].stats == stores[1].stats
        assert stores[0].index_stats == stores[1].index_stats
    batch = [s.lookup_batch(prompts + [prompts[0][:1]]) for s in stores]
    assert [b[0] for b in batch[0]] == [b[0] for b in batch[1]]
    assert all(b[0] for b in batch[0][:-1]) and batch[0][-1] == (0, [])
    assert stores[0].stats == stores[1].stats
    assert stores[0].stats["rebuilds"] == 0
    ist = stores[0].index_stats
    assert ist == stores[1].index_stats
    assert ist["seals"] > 0 and ist["merges"] > 0 and ist["inserts"] == \
        len(stores[0].hashes)
    assert stores[0]._index.base is not None


@pytest.mark.parametrize("mutable", [True, False])
def test_prefix_store_save_restore_matches_reference(tmp_path, mutable):
    """save, restore, then the same probes and one more insert round: the
    restored port store answers and counts as the restored reference
    store does (the mutable one through its index's snapshot and journal,
    the wholesale one through a rebuild), and its payloads come back."""
    cfg = dict(kind="tiered", plan="device", mutable=mutable,
               delta_capacity=4)
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 50, 8)
    prompts = [np.concatenate([shared[:int(rng.integers(2, 9))],
                               rng.integers(0, 50, 10)]) for _ in range(10)]
    port = pt_kv.PrefixPageStore(2, IndexConfig(**cfg), device="cpu")
    ref = ref_kv.PrefixPageStore(2, RefIndexConfig(**cfg))

    def pay(i, p):
        return [{"k": torch.full((2, 1, 2), float(i * 100 + j)),
                 "v": torch.full((2, 1, 2), -float(j))}
                for j in range(len(p) // 2)]

    for i, p in enumerate(prompts[:6]):
        port.insert(p, pay(i, p))
        ref.insert(p, [{"l0": {"k": np.asarray(x["k"]),
                               "v": np.asarray(x["v"])}}
                       for x in pay(i, p)])
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    stores = [pt_kv.PrefixPageStore.restore(str(tmp_path / "port"),
                                            IndexConfig(**cfg),
                                            device="cpu"),
              ref_kv.PrefixPageStore.restore(str(tmp_path / "ref"),
                                             RefIndexConfig(**cfg))]
    assert stores[0].hashes == stores[1].hashes == port.hashes
    assert stores[0].index_stats == stores[1].index_stats
    for s in stores:
        for i, p in enumerate(prompts[6:]):
            s.insert(p, pay(i + 6, p) if s is stores[0] else
                     [{"l0": {"k": 0, "v": 0}}] * (len(p) // 2))
    got = [s.lookup_batch(prompts) for s in stores]
    assert [g[0] for g in got[0]] == [g[0] for g in got[1]]
    assert stores[0].stats == stores[1].stats
    assert stores[0].index_stats == stores[1].index_stats
    n, payloads = stores[0].lookup(prompts[0])
    want = port.lookup(prompts[0])[1]
    assert n == len(want) > 0
    for a, b in zip(payloads, want):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_prefix_store_unported_surface_raises():
    """Per-tenant probes (once unported) answer as the untenanted ones,
    on the tenants' lanes of the store's probe queue, as the reference's
    store does."""
    default = pt_kv.PrefixPageStore(8, device="cpu")  # the mutable default
    assert default.index_config.mutable and default.index_stats == {}
    prompts = [np.arange(8), np.arange(16), np.arange(3)]
    stores = [pt_kv.PrefixPageStore(8, IndexConfig(**WHOLESALE),
                                    device="cpu"),
              ref_kv.PrefixPageStore(8, RefIndexConfig(**WHOLESALE))]
    for store in stores:
        store.insert(np.arange(16), [{"pay": 0}, {"pay": 1}])
        plain = store.lookup_batch(prompts)
        tenanted = store.lookup_batch(prompts, tenants=["a", "b", "a"])
        assert [n for n, _ in plain] == [n for n, _ in tenanted] == [1, 2, 0]
    q = stores[0].probe_queue()
    assert set(q.stats.tenants) == {"default", "a", "b"}
    assert q.stats.flushes == 2              # one a lookup_batch
    assert stores[0].stats == stores[1].stats


# ------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def engines():
    """The reference engine and the port's, on the same weights."""
    rcfg = ref_get_config("qwen3-0.6b").reduced()
    cfg = get_config("qwen3-0.6b").reduced()
    rp = ref_T.init_params(rcfg, jax.random.PRNGKey(0))
    pp = pt_T.from_reference_params(cfg, rp, device="cpu")
    ref = RefServeEngine(rcfg, rp, max_len=64, page_size=8,
                         index_config=RefIndexConfig(**WHOLESALE),
                         decode_batching=False)
    port = ServeEngine(cfg, pp, max_len=64, page_size=8,
                       index_config=IndexConfig(**WHOLESALE),
                       decode_batching=False)
    return cfg, pp, ref, port


def test_engine_greedy_matches_reference(engines):
    """Two prompts sharing a 24-token prefix, 4 steps, two rounds:
    identical tokens, reuse counts and store stats."""
    cfg, _, ref, port = engines
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 24)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 9)])
               for _ in range(2)]
    for _ in range(2):
        want = np.asarray(ref.generate(prompts, 4))
        got = port.generate(prompts, 4)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    for f in ("prefill_tokens", "reused_tokens", "decode_tokens"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    assert port.stats.reused_tokens > 0
    assert port.store.stats == ref.store.stats


def test_engine_on_the_mutable_default_matches_reference(engines):
    """Both engines on their default prefix store, the mutable tiered
    store: greedy tokens, reuse counts, store stats and write-path
    counters equal over two rounds."""
    cfg, pp, _, _ = engines
    rcfg = ref_get_config("qwen3-0.6b").reduced()
    rp = ref_T.init_params(rcfg, jax.random.PRNGKey(0))
    ref = RefServeEngine(rcfg, rp, max_len=64, page_size=8,
                         decode_batching=False)
    port = ServeEngine(cfg, pp, max_len=64, page_size=8,
                       decode_batching=False)
    assert port.store.index_config.mutable
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab, 16)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 9)])
               for _ in range(3)]
    for _ in range(2):
        want = np.asarray(ref.generate(prompts, 3))
        np.testing.assert_array_equal(port.generate(prompts, 3).numpy(),
                                      want)
    for f in ("prefill_tokens", "reused_tokens", "decode_tokens"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    assert port.stats.reused_tokens > 0
    assert port.store.stats == ref.store.stats
    assert port.store.stats["rebuilds"] == 0
    assert port.store.index_stats == ref.store.index_stats
    assert port.store.index_stats["inserts"] == len(port.store.hashes)


def test_engine_warm_prefill_matches_cold(engines):
    cfg, pp, _, _ = engines
    eng = ServeEngine(cfg, pp, max_len=64, page_size=8,
                      index_config=IndexConfig(**WHOLESALE))
    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab, 24)
    p1, p2 = (np.concatenate([shared, rng.integers(0, cfg.vocab, 9)])
              for _ in range(2))
    eng.prefill_one(p1)
    warm, _ = eng.prefill_one(p2)
    assert eng.stats.reused_tokens == 24
    cold, _ = ServeEngine(cfg, pp, max_len=64, page_size=8,
                          index_config=IndexConfig(**WHOLESALE)).prefill_one(p2)
    np.testing.assert_allclose(warm.numpy(), cold.numpy(), atol=2e-3,
                               rtol=2e-3)


def test_engine_sampled_decode_stays_in_nucleus(engines):
    cfg, pp, _, _ = engines
    eng = ServeEngine(cfg, pp, max_len=64, page_size=8,
                      index_config=IndexConfig(**WHOLESALE),
                      sampler=SamplerConfig(temperature=0.8, top_p=0.9),
                      decode_batching=False)
    prompts = [np.arange(12) % cfg.vocab, np.arange(5, 17) % cfg.vocab]
    a = eng.generate(prompts, 3, generator=torch.Generator().manual_seed(4))
    b = eng.generate(prompts, 3, generator=torch.Generator().manual_seed(4))
    assert a.shape == (2, 3) and torch.equal(a, b)   # seeded: reproducible
    assert bool(((a >= 0) & (a < cfg.vocab)).all())


def test_engine_unported_surface_raises(engines):
    """The decode queue, the default, serves (once unported): with and
    without tenants its sampled tokens are the inline sampler's for the
    same generator, one decode flush a step, and EngineStats' views read
    the flushes back from the registry."""
    cfg, pp, _, _ = engines
    default = ServeEngine(cfg, pp)                    # the mutable default
    assert default.store.index_config == IndexConfig(kind="tiered",
                                                     plan="device",
                                                     mutable=True)
    assert default.decode_batching
    prompts = [np.arange(8), np.arange(5, 17) % cfg.vocab]
    scfg = SamplerConfig(temperature=0.8)
    inline = ServeEngine(cfg, pp, index_config=IndexConfig(**WHOLESALE),
                         sampler=scfg, decode_batching=False)
    want = inline.generate(prompts, 3,
                           generator=torch.Generator().manual_seed(5))
    for tenants in (None, ["a", "b"]):
        with obs.use_registry() as reg:
            queued = ServeEngine(cfg, pp,
                                 index_config=IndexConfig(**WHOLESALE),
                                 sampler=scfg)
            got = queued.generate(prompts, 3, tenants=tenants,
                                  generator=torch.Generator().manual_seed(5))
            assert torch.equal(got, want)
            st = queued.stats
            assert st.decode_flushes == 3 and st.decode_occupancy > 0
            assert st.probe_batches == 0 and st.probe_occupancy == 0.0
            rows = st.tenants
            assert sum(r.queries for k, r in rows.items()
                       if k[0] == "decode") == 6
            assert {k[1] for k in rows} == set(tenants or ["default"])
            assert reg.total("queue_flushes", path="decode") == 3
    with pytest.raises(ValueError, match="one id per prompt"):
        queued.generate([np.arange(8)], 2, tenants=["a", "b"])


# ------------------------------------------------------------- the launcher
def run_launcher(monkeypatch, *argv) -> str:
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pt_launch.main()
    return out.getvalue()


def test_launcher_prints_the_reference_counts(monkeypatch):
    """The reference launcher's flags and prompts print
    ``prefill computed/reused: 288/480`` and these store stats for two
    rounds; they depend on the prompt structure, not on the width."""
    out = run_launcher(monkeypatch, "--reduced", "--device", "cpu",
                       "--wholesale", "--no-decode-queue", "--rounds", "2",
                       "--steps", "2")
    assert "tokens out: (8, 2)" in out
    assert "prefill computed/reused: 288/480" in out
    assert ("prefix store: {'lookups': 23, 'hits': 15, 'rebuilds': 9, "
            "'verify_rejects': 0}") in out


def test_launcher_on_the_mutable_store_prints_the_reference_lines(
        monkeypatch):
    """Without --wholesale the launcher serves on the mutable store and
    prints the reference launcher's lines for the same flags: no
    rebuilds, and all 10 page hashes inserted through the delta buffer."""
    out = run_launcher(monkeypatch, "--reduced", "--device", "cpu",
                       "--no-decode-queue", "--rounds", "2", "--steps", "2")
    assert "prefill computed/reused: 288/480" in out
    assert ("prefix store: {'lookups': 23, 'hits': 15, 'rebuilds': 0, "
            "'verify_rejects': 0}") in out
    assert ("write path:   {'inserts': 10, 'upserts': 0, 'deletes': 0, "
            "'merges': 0, 'splits': 0, 'pages_touched': 0, "
            "'rows_rewritten': 0, 'top_derives': 0, 'base_rebuilds': 0, "
            "'shadowed': 0, 'seals': 0, 'maintains': 0, "
            "'journal_replayed': 0}") in out


def test_launcher_saves_and_restores_with_the_reference_lines(
        monkeypatch, tmp_path):
    """--ckpt-dir saves the prefix store after the run; a second run with
    --restore serves from it: the reference launcher prints these lines
    for the same flags (the restored store starts with all 10 pages in
    its index's delta buffer and inserts none)."""
    d = str(tmp_path / "ck")
    argv = ("--reduced", "--device", "cpu", "--no-decode-queue",
            "--rounds", "2", "--steps", "2", "--ckpt-dir", d)
    out = run_launcher(monkeypatch, *argv)
    assert "prefill computed/reused: 288/480" in out
    assert f"saved prefix store: 10 pages -> {d}/step_00000001" in out
    out = run_launcher(monkeypatch, *argv, "--restore")
    assert f"restored prefix store: 10 pages from {d}" in out
    assert "prefill computed/reused: 256/512" in out
    assert ("prefix store: {'lookups': 16, 'hits': 16, 'rebuilds': 0, "
            "'verify_rejects': 0}") in out
    assert ("write path:   {'inserts': 0, 'upserts': 0, 'deletes': 0, "
            "'merges': 0, 'splits': 0, 'pages_touched': 0, "
            "'rows_rewritten': 0, 'top_derives': 0, 'base_rebuilds': 0, "
            "'shadowed': 0, 'seals': 0, 'maintains': 0, "
            "'journal_replayed': 0}") in out
    assert "snapshot+journal-replay to servable" in out
    assert f"saved prefix store: 10 pages -> {d}/step_00000002" in out
    assert sorted(os.listdir(os.path.join(d, "index"))) == [
        "journal_00000001.log", "journal_00000002.log", "step_00000001",
        "step_00000002"]
    with pytest.raises(SystemExit):
        run_launcher(monkeypatch, "--reduced", "--device", "cpu",
                     "--no-decode-queue", "--restore")


@pytest.mark.parametrize("argv,item", [
    (("--wholesale", "--no-decode-queue", "--index", "css"), "item 12"),
    (("--wholesale", "--no-decode-queue", "--tuned-profile", "auto"),
     "item 11"),
    (("--wholesale", "--no-decode-queue", "--tune"), "item 11")])
def test_launcher_unported_flags_exit(monkeypatch, tmp_path, argv, item):
    """The flags once unported serve. --index other than tiered (item 12)
    prints the reference launcher's lines for the same flags (a css index
    rebuilt 9 times). The item-11 flags, with the profile directory in
    tmp_path: --tuned-profile raises FileNotFoundError naming the
    autotuner where no profile was persisted, and --tune runs the
    autotuner's smoke sweep, persists its profile and serves with it,
    printing the reference launcher's lines."""
    if item != "item 11":
        with obs.use_registry():
            out = run_launcher(monkeypatch, "--reduced", "--device", "cpu",
                               "--rounds", "2", "--steps", "2", *argv)
        assert "prefix-index=css" in out
        assert "prefill computed/reused: 288/480" in out
        assert ("prefix store: {'lookups': 23, 'hits': 15, 'rebuilds': 9, "
                "'verify_rejects': 0}") in out
        assert ("probe queue:  1 fused batches in " in out
                and "mean executed-plan occupancy 0.000" in out)
        return
    monkeypatch.setattr(pt_profile, "default_profile_dir",
                        lambda: str(tmp_path))
    prev = pt_schedule.set_plan_thresholds()
    try:
        if "--tune" not in argv:
            with pytest.raises(FileNotFoundError, match="autotune"):
                run_launcher(monkeypatch, "--reduced", "--device", "cpu",
                             *argv)
            return
        out = run_launcher(monkeypatch, "--reduced", "--device", "cpu",
                           "--rounds", "2", "--steps", "2", *argv)
    finally:
        pt_schedule.set_plan_thresholds(**prev)
    assert f"-> {tmp_path}/tuned_cpu.json" in out
    assert re.search(r"tuned profile: tile=(128|256) leaf_width=None "
                     r"specialize=True", out)
    assert "prefill computed/reused: 288/480" in out
    assert ("prefix store: {'lookups': 23, 'hits': 15, 'rebuilds': 9, "
            "'verify_rejects': 0}") in out


# What the reference launcher prints (and its registry holds) for
# ``--reduced --rounds 2 --steps 2`` plus each case's flags: probe-queue
# and decode-queue flushes, prefix-store rebuilds, and per (path, tenant)
# row (submits, queries, flushes, admitted, deferred). Round 1 probes an
# empty store (no flush); round 2's 8 probes of 3 hashes go out as one
# flush, or as a capacity flush of 5 and a demand flush of 3 at
# --queue-capacity 16; each of the 4 sampled steps is one decode flush.
ONE_TENANT = {("decode", "default"): (4, 32, 4, 32, 0),
              ("probe", "default"): (8, 24, 1, 24, 0)}
LAUNCHER_CASES = {
    "default": ((), 1, 4, 0, ONE_TENANT),
    "wholesale": (("--wholesale",), 1, 4, 9, ONE_TENANT),
    "tenants": (("--tenants", "2"), 1, 4, 0, {
        ("decode", "t0"): (4, 16, 4, 16, 0),
        ("decode", "t1"): (4, 16, 4, 16, 0),
        ("probe", "t0"): (4, 12, 1, 12, 0),
        ("probe", "t1"): (4, 12, 1, 12, 0)}),
    "capacity": (("--queue-capacity", "16"), 2, 4, 0, {
        **ONE_TENANT, ("probe", "default"): (8, 24, 2, 24, 1)}),
    "deadline": (("--queue-deadline-us", "500"), 1, 4, 0, ONE_TENANT),
    "no_adapt": (("--no-queue-adapt",), 1, 4, 0, ONE_TENANT),
    "max_share": (("--queue-max-share", "0.5"), 1, 4, 0, ONE_TENANT),
    "no_adaptive_deadline": (("--no-adaptive-deadline",), 1, 4, 0,
                             ONE_TENANT),
    "metrics": (("--metrics-port", "0", "--metrics-selftest"), 1, 4, 0,
                ONE_TENANT),
    "trace": (("--trace-out", "TRACE"), 1, 4, 0, ONE_TENANT),
    "tuned_profile": (("--tuned-profile", "testplat"), 1, 4, 0, ONE_TENANT),
}
TENANT_ROW = re.compile(r"tenant\[(\w+):(\w+)\]: (\d+) queries / (\d+) "
                        r"flushes, admitted (\d+), deferred (\d+), drops 0")


@pytest.mark.parametrize("case", list(LAUNCHER_CASES))
def test_launcher_queue_and_telemetry_flags_print_the_reference_lines(
        monkeypatch, tmp_path, case):
    """The flags that once exited as unported (the decode queue by
    default, tenants, each probe-queue flag, the metrics server, the
    trace) serve and print the reference launcher's count lines for the
    same flags; times are not compared."""
    flags, probe, decode, rebuilds, rows = LAUNCHER_CASES[case]
    trace = str(tmp_path / "trace.json")
    flags = tuple(trace if f == "TRACE" else f for f in flags)
    if case == "tuned_profile":
        # a persisted profile with the default queue knobs, so the counts
        # are the default case's; the store is specialized
        monkeypatch.setattr(pt_profile, "default_profile_dir",
                            lambda: str(tmp_path))
        pt_profile.save_profile(pt_profile.TunedProfile(
            platform="testplat", backend="cpu", device_kind="cpu",
            knobs={"tile": 256, "leaf_width": 512,
                   "histogram_max_pages": 16, "queue_min_flush": 64,
                   "queue_deadline_s": 0.002, "specialize": True},
            objective={}))
    prev = pt_schedule.set_plan_thresholds()
    try:
        with obs.use_registry() as reg:
            out = run_launcher(monkeypatch, "--reduced", "--device", "cpu",
                               "--rounds", "2", "--steps", "2", *flags)
            submits = {(r.path, r.tenant): r.submits
                       for r in tenant_summary(reg)}
    finally:
        pt_schedule.set_plan_thresholds(**prev)
    if case == "tuned_profile":
        assert "tuned profile: tile=256 leaf_width=512 specialize=True" \
            in out
    assert "prefill computed/reused: 288/480" in out
    assert (f"prefix store: {{'lookups': 23, 'hits': 15, 'rebuilds': "
            f"{rebuilds}, 'verify_rejects': 0}}") in out
    assert f"probe queue:  {probe} fused batches in " in out
    assert f"decode queue: {decode} fused inversion batches, mean " \
        "occupancy 1.000" in out
    printed = {(m[0], m[1]): tuple(int(x) for x in m[2:])
               for m in TENANT_ROW.findall(out)}
    assert {k: (submits[k], *v) for k, v in printed.items()} == rows
    if case == "metrics":
        assert re.search(r"metrics: http://127\.0\.0\.1:\d+/metrics", out)
        assert "series ok" in out
    if case == "trace":
        with open(trace) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
        assert {"serve.generate", "serve.probe_batch", "serve.prefill",
                "serve.decode_step", "queue.flush", "store.lookup"} <= names
        assert f"events -> {trace}" in out
        obs.TRACER.disable()
        obs.TRACER.clear()
