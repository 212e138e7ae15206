"""Every model family of the port against the reference: dense, moe, ssm,
hybrid, vlm and audio.

For each LM architecture's ``reduced()`` config the reference's
parameters (``init_params`` from a JAX key) are carried into the port
with ``from_reference_params``; the same numpy tokens (and, for vlm and
audio, the same numpy memory) then go through both packages' forward
(hidden and aux loss), prefill (logits and every cache entry, compared in
the reference's layout through ``to_reference_cache``) and three ragged
decode steps, in float32, to 1e-4 (float32 matmuls summed in another
order; measured differences are at most about 1e-5, on jamba). The
reference's routing keeps ``capacity_factor=8.0`` there, so no token
drops. Then the port alone: prefill then decode equal to the full forward
(2e-3, the reference's smoke tolerance), causality for mixtral and jamba,
the sliding window's receptive field, and the padded vocabulary; the
serving engine per family against the reference engine (greedy tokens,
prefill / reuse counts, store stats; reused 0 for the families that are
not pageable); and the launcher's count lines, one arch a family."""
import contextlib
import dataclasses
import functools
import io
import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_T
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import engine as ref_engine

from repro_torch import obs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve as pt_launch
from repro_torch.models import transformer as pt_T
from repro_torch.serve import ServeEngine

torch.set_num_threads(1)

ATOL = 1e-4
SMOKE_TOL = 2e-3
F32 = dict(compute_dtype=jnp.float32)
LM_ARCHS = [a for a in ARCH_IDS if a != "nitrogen-db"]
S, EXTRA, MAX_LEN = 10, 3, 16


@functools.lru_cache(maxsize=None)
def model(arch: str):
    """The reference's reduced model and its port, with the reference's
    entry points compiled once."""
    rcfg = ref_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    rp = ref_T.init_params(rcfg, jax.random.PRNGKey(0))
    return types.SimpleNamespace(
        rcfg=rcfg, cfg=cfg, rp=rp,
        pp=pt_T.from_reference_params(cfg, rp, device="cpu"),
        forward=jax.jit(lambda p, t, m: ref_T.forward(
            rcfg, p, t, m, remat=False, **F32)),
        prefill=jax.jit(lambda p, t, m: ref_T.prefill(
            rcfg, p, t, m, max_len=MAX_LEN, **F32)),
        decode=jax.jit(lambda p, t, c: ref_T.decode_step(rcfg, p, t, c,
                                                         **F32)))


def tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def memory(cfg, B, seed=9):
    """Stub-frontend embeddings for vlm / audio, else None."""
    if cfg.family not in ("vlm", "audio"):
        return None
    return np.random.default_rng(seed).normal(
        size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def both(a):
    """(jax, torch) views of a numpy array or None."""
    return (None, None) if a is None else (jnp.asarray(a), torch.from_numpy(a))


def close(got, want, what: str, atol: float = ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


def close_caches(cfg, cache, want, what: str):
    got = pt_T.to_reference_cache(cfg, cache)
    np.testing.assert_array_equal(got["lengths"], np.asarray(want["lengths"]))
    assert got["layers"].keys() == want["layers"].keys()
    for p, ent in want["layers"].items():
        assert got["layers"][p].keys() == ent.keys(), (p, ent.keys())
        for name, arr in ent.items():
            assert got["layers"][p][name].dtype == arr.dtype, (p, name)
            close(got["layers"][p][name], arr, f"{what}: {p}.{name}")


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_matches_reference(arch):
    for cfg, rcfg in ((get_config(arch), ref_get_config(arch)),
                      (get_config(arch).reduced(),
                       ref_get_config(arch).reduced())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert (cfg.hd, cfg.padded_vocab, cfg.period) == \
            (rcfg.hd, rcfg.padded_vocab, rcfg.period)
        assert [cfg.layer_spec(i) for i in range(cfg.period)] == \
            [rcfg.layer_spec(i) for i in range(rcfg.period)]


# ------------------------------------------------------- against the reference
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(arch):
    m = model(arch)
    t = tokens((2, S + EXTRA), 1, m.cfg.vocab)
    mj, mt = both(memory(m.cfg, 2))
    hw, aw = m.forward(m.rp, jnp.asarray(t), mj)
    h, aux = pt_T.forward(m.cfg, m.pp, torch.from_numpy(t), mt,
                          compute_dtype=torch.float32)
    assert pt_T.param_count(m.pp) == ref_T.param_count(m.rp)
    close(h, hw, "forward hidden")
    close(aux, aw, "aux loss", 1e-6)
    if m.cfg.n_experts:
        assert float(aux) > 0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_ragged_decode_match_reference(arch):
    """Prefill of 2 rows (logits, every cache entry), then 3 decode steps
    with ragged lengths, one row at the cache's end where the write
    position clamps to max_len - 1."""
    m = model(arch)
    t = tokens((2, S), 2, m.cfg.vocab)
    mj, mt = both(memory(m.cfg, 2))
    lw, cw = m.prefill(m.rp, jnp.asarray(t), mj)
    lg, c = pt_T.prefill(m.cfg, m.pp, torch.from_numpy(t), mt,
                         max_len=MAX_LEN, compute_dtype=torch.float32)
    close(lg, lw, "prefill logits")
    close_caches(m.cfg, c, cw, "prefill cache")
    lens = np.array([S - 3, MAX_LEN - 1], np.int32)
    cw["lengths"] = jnp.asarray(lens)
    c["lengths"] = torch.from_numpy(lens.copy())
    tok = np.array([5, 7], np.int32)
    for step in range(3):
        lw, cw = m.decode(m.rp, jnp.asarray(tok), cw)
        lg, c = pt_T.decode_step(m.cfg, m.pp, torch.from_numpy(tok), c,
                                 compute_dtype=torch.float32)
        close(lg, lw, f"decode logits, step {step}")
        close_caches(m.cfg, c, cw, f"decode cache, step {step}")
        tok = np.asarray(jnp.argmax(lw, -1)).astype(np.int32)


# ------------------------------------------------------------ the port alone
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    m = model(arch)
    t = torch.from_numpy(tokens((2, S + EXTRA), 5, m.cfg.vocab))
    mt = both(memory(m.cfg, 2))[1]
    h, _ = pt_T.forward(m.cfg, m.pp, t, mt, compute_dtype=torch.float32)
    want = pt_T.logits_of(m.cfg, m.pp, h)
    lg, cache = pt_T.prefill(m.cfg, m.pp, t[:, :S], mt, max_len=S + EXTRA,
                             compute_dtype=torch.float32)
    close(lg, want[:, S - 1], "prefill logits", SMOKE_TOL)
    for i in range(EXTRA):
        lg, cache = pt_T.decode_step(m.cfg, m.pp, t[:, S + i], cache,
                                     compute_dtype=torch.float32)
        close(lg, want[:, S + i], f"decode step {i}", SMOKE_TOL)


def port_model(arch, seed=0, **overrides):
    cfg = get_config(arch).reduced(**overrides)
    return cfg, pt_T.init_params(cfg, torch.Generator().manual_seed(seed),
                                 "cpu")


def last_logits(cfg, params, toks, mem=None):
    h, _ = pt_T.forward(cfg, params, toks, mem, compute_dtype=torch.float32)
    return pt_T.logits_of(cfg, params, h)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "jamba-v0.1-52b"])
def test_causality_future_tokens_do_not_change_past_logits(arch):
    cfg, params = port_model(arch)
    t_ = 7
    toks = torch.from_numpy(tokens((1, 12), 1, cfg.vocab))
    toks2 = toks.clone()
    toks2[:, t_ + 1:] = (toks2[:, t_ + 1:] + 13) % cfg.vocab
    lg1, lg2 = (last_logits(cfg, params, x) for x in (toks, toks2))
    close(lg1[:, :t_ + 1], lg2[:, :t_ + 1], "past logits")
    assert not torch.allclose(lg1[:, -1], lg2[:, -1])


def test_swa_window_limits_receptive_field():
    """One layer of attention with window 4: a token more than 4 back does
    not reach the last logits."""
    cfg, params = port_model("mixtral-8x7b", seed=4, n_layers=1, window=4)
    toks = torch.from_numpy(tokens((1, 16), 3, cfg.vocab))
    far = 16 - 1 - cfg.window - 3
    toks2 = toks.clone()
    toks2[:, far] = (toks2[:, far] + 7) % cfg.vocab
    close(last_logits(cfg, params, toks)[:, -1],
          last_logits(cfg, params, toks2)[:, -1], "outside the window")
    near = 16 - 2
    toks2[:, near] = (toks2[:, near] + 7) % cfg.vocab
    assert not torch.allclose(last_logits(cfg, params, toks)[:, -1],
                              last_logits(cfg, params, toks2)[:, -1])


def test_padded_vocab_columns_are_masked():
    cfg, params = port_model("whisper-small", vocab=500)     # pads to 512
    mem = torch.randn(1, cfg.encoder_seq, cfg.d_model,
                      generator=torch.Generator().manual_seed(6))
    lg = last_logits(cfg, params, torch.zeros((1, 4), dtype=torch.int32),
                     mem)
    assert lg.shape[-1] == 512 and bool((lg[..., 500:] < -1e29).all())


def test_init_params_matches_reference_shapes():
    """The port's own draw has the reference's tree: layer l of the port
    is the reference's blocks[p{l % period}][l // period], and the
    encoder's blocks are carried too."""
    for arch in ("jamba-v0.1-52b", "whisper-small", "llama-3.2-vision-11b"):
        m = model(arch)
        mine = pt_T.init_params(m.cfg, torch.Generator().manual_seed(0),
                                "cpu")
        shape = lambda t: {k: shape(v) if isinstance(v, dict)  # noqa: E731
                           else tuple(v.shape) for k, v in t.items()}
        assert [shape(x) for x in mine["layers"]] == \
            [shape(x) for x in m.pp["layers"]]
        assert pt_T.param_count(mine) == ref_T.param_count(m.rp)
        if m.cfg.is_encoder_decoder:
            assert len(mine["encoder"]["layers"]) == m.cfg.encoder_layers


def test_prefill_continue_refuses_unpageable_archs():
    m = model("mamba2-370m")
    cache = pt_T.init_cache(m.cfg, 1, MAX_LEN, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="pageable"):
        pt_T.prefill_continue(m.cfg, m.pp, torch.zeros((1, 2), dtype=torch
                                                       .int32), cache, 8)


# ------------------------------------------------------------------ serving
def reference_engine(monkeypatch, m, **kw):
    """The reference engine with its prefill and prefill_continue compiled
    once a shape (eagerly, their scans compile at every call), and its
    decode step the one compiled for the decode test (the same function
    at the same shapes)."""
    pre = jax.jit(lambda p, t, mem, n: ref_T.prefill(
        m.rcfg, p, t, mem, max_len=n, **F32), static_argnums=3)
    cont = jax.jit(lambda p, t, c, start: ref_T.prefill_continue(
        m.rcfg, p, t, c, start, **F32), static_argnums=3)
    monkeypatch.setattr(ref_engine, "T", types.SimpleNamespace(
        **{k: getattr(ref_T, k) for k in ("init_cache", "decode_step")},
        prefill=lambda cfg, p, t, memory=None, *, compute_dtype, max_len:
            pre(p, t, memory, max_len),
        prefill_continue=lambda cfg, p, t, c, start, *, compute_dtype:
            cont(p, t, c, start)))
    eng = RefServeEngine(m.rcfg, m.rp, **kw)
    eng._jit_decode = m.decode
    return eng


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b",
                                  "mamba2-370m", "llama-3.2-vision-11b",
                                  "whisper-small"])
def test_engine_matches_reference(monkeypatch, arch):
    """Two prompts of 10 tokens sharing 8, 3 greedy steps: the MoE
    model's second prompt continues from the first one's shared page, the
    other families skip the store (reused 0). Tokens, counts and store
    stats equal."""
    m = model(arch)
    ref = reference_engine(monkeypatch, m, max_len=MAX_LEN, page_size=8,
                           decode_batching=False)
    port = ServeEngine(m.cfg, m.pp, max_len=MAX_LEN, page_size=8,
                       decode_batching=False)
    assert port.pageable == ref.pageable == (m.cfg.family == "moe")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, m.cfg.vocab, 8)
    prompts = [np.concatenate([shared, rng.integers(0, m.cfg.vocab, S - 8)])
               for _ in range(2)]
    mj, mt = both(memory(m.cfg, 1, seed=5))
    want = np.asarray(ref.generate(prompts, 3, memory=mj))
    np.testing.assert_array_equal(
        port.generate(prompts, 3, memory=mt).numpy(), want)
    for f in ("prefill_tokens", "reused_tokens", "decode_tokens"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    assert (port.stats.reused_tokens > 0) == port.pageable
    assert port.store.stats == ref.store.stats


def test_ssm_arch_skips_prefix_reuse():
    m = model("mamba2-370m")
    eng = ServeEngine(m.cfg, m.pp, max_len=64, page_size=8)
    assert not eng.pageable
    p = np.arange(20) % m.cfg.vocab
    eng.prefill_one(p)
    eng.prefill_one(p)
    assert eng.stats.reused_tokens == 0
    assert eng.store.stats["lookups"] == 0 and not eng.store.hashes


def run_launcher(monkeypatch, *argv) -> str:
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), obs.use_registry():
        pt_launch.main()
    return out.getvalue()


# what the reference launcher prints for --reduced --rounds 2 --steps 2
# (the counts depend on the prompts and the family, not on the width)
PAGEABLE_LINES = (
    "prefill computed/reused: 288/480",
    "prefix store: {'lookups': 23, 'hits': 15, 'rebuilds': 0, "
    "'verify_rejects': 0}",
    "decode queue: 4 fused inversion batches",
    "write path:   {'inserts': 10, 'upserts': 0, 'deletes': 0, 'merges': 0, "
    "'splits': 0, 'pages_touched': 0, 'rows_rewritten': 0, 'top_derives': 0, "
    "'base_rebuilds': 0, 'shadowed': 0, 'seals': 0, 'maintains': 0, "
    "'journal_replayed': 0}")
UNPAGEABLE_LINES = (
    "prefill computed/reused: 768/0",
    "prefix store: {'lookups': 0, 'hits': 0, 'rebuilds': 0, "
    "'verify_rejects': 0}",
    "probe queue:  0 fused batches",
    "decode queue: 4 fused inversion batches",
    "write path:   {}")


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "mamba2-370m",
                                  "jamba-v0.1-52b", "llama-3.2-vision-11b",
                                  "whisper-small"])
def test_launcher_prints_the_reference_lines(monkeypatch, arch):
    out = run_launcher(monkeypatch, "--arch", arch, "--reduced", "--device",
                       "cpu", "--rounds", "2", "--steps", "2")
    assert f"arch={arch} " in out and "tokens out: (8, 2)" in out
    lines = PAGEABLE_LINES if get_config(arch).family == "moe" \
        else UNPAGEABLE_LINES
    for line in lines:
        assert line in out, (line, out)
