"""The port's dense transformer against the reference.

The reference's parameters (``init_params`` from a JAX key) are carried
into the port with ``from_reference_params``; the same numpy tokens then
go through both packages' forward, prefill, prefill_continue and
decode_step in float32, at ``qwen3-0.6b``'s reduced width. Logits and the
K/V cache must agree to 1e-4 (float32 matmuls summed in another order;
measured differences are about 1e-6). Also the layers the blocks do not
reach here (the sqrelu and gelu MLPs, windowed and non-causal attention,
cross attention), the configs of every architecture, and an MoE variant
of the same model (tests/test_torch_families.py holds every family)."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import flash_attention as ref_fa
from repro.models import layers as ref_L
from repro.models import transformer as ref_T

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import flash_attention as pt_fa
from repro_torch.models import layers as pt_L
from repro_torch.models import transformer as pt_T

torch.set_num_threads(1)

ATOL = 1e-4
F32 = dict(compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params, jits)."""
    rcfg = ref_get_config("qwen3-0.6b").reduced()
    cfg = get_config("qwen3-0.6b").reduced()
    rp = ref_T.init_params(rcfg, jax.random.PRNGKey(0))
    jits = {
        "forward": jax.jit(lambda p, t: ref_T.logits_of(
            rcfg, p, ref_T.forward(rcfg, p, t, remat=False, **F32)[0])),
        "prefill": jax.jit(lambda p, t: ref_T.prefill(
            rcfg, p, t, max_len=32, **F32)),
        "decode": jax.jit(lambda p, t, c: ref_T.decode_step(
            rcfg, p, t, c, **F32)),
    }
    return rcfg, cfg, rp, pt_T.from_reference_params(cfg, rp, device="cpu"), \
        jits


def tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def close(got: torch.Tensor, want, what: str, atol: float = ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


def test_configs_match_reference():
    """All 11 ids, at full width and reduced."""
    assert len(ARCH_IDS) == 11
    for arch in ARCH_IDS:
        for cfg, rcfg in ((get_config(arch), ref_get_config(arch)),
                          (get_config(arch).reduced(),
                           ref_get_config(arch).reduced())):
            assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg), arch
            assert (cfg.hd, cfg.padded_vocab, cfg.period) == \
                (rcfg.hd, rcfg.padded_vocab, rcfg.period)
            if cfg.n_layers:
                assert cfg.repeats == rcfg.repeats
            assert [cfg.layer_spec(i) for i in range(cfg.period)] == \
                [rcfg.layer_spec(i) for i in range(rcfg.period)]
    assert get_config("qwen3-0.6b").padded_vocab == 152_064


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "qwen3-0.6b"])
def test_unported_archs_raise(arch):
    """Every id resolves (once item 13 was to bring them) to the
    reference's config; an unknown id still raises KeyError."""
    cfg = get_config(arch)
    assert type(cfg).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get_config(arch))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_unported_family_raises(model):
    """An MoE variant of the model (top-2 of 4 experts on every layer)
    initialises and runs forward as the reference does on its weights,
    and cross attention answers as the reference's."""
    rcfg, cfg, _, _, _ = model
    moe = dataclasses.replace(cfg, family="moe", n_experts=4, topk=2)
    rmoe = dataclasses.replace(rcfg, family="moe", n_experts=4, topk=2)
    mine = pt_T.init_params(moe, torch.Generator().manual_seed(0), "cpu")
    assert set(mine["layers"][0]) == {"ln1", "attn", "ln2", "moe"}
    rp = ref_T.init_params(rmoe, jax.random.PRNGKey(1))
    assert pt_T.param_count(mine) == ref_T.param_count(rp)
    pp = pt_T.from_reference_params(moe, rp, device="cpu")
    t = tokens((2, 12), 8, cfg.vocab)
    hw, aw = jax.jit(lambda p, t: ref_T.forward(rmoe, p, t, remat=False,
                                                **F32))(rp, jnp.asarray(t))
    h, aux = pt_T.forward(moe, pp, torch.from_numpy(t),
                          compute_dtype=torch.float32)
    close(h, hw, "moe forward hidden")
    close(aux, aw, "moe aux loss", 1e-6)
    # cross attention over a memory of 7 rows, then reusing its K/V
    ap = ref_L.init_attention(rcfg, jax.random.PRNGKey(2))
    x, mem = (np.random.default_rng(s).normal(size=shape).astype(np.float32)
              for s, shape in ((9, (2, 3, cfg.d_model)),
                               (10, (2, 7, cfg.d_model))))
    want, (wk, wv) = ref_L.cross_attention_block(
        rcfg, ap, jnp.asarray(x), jnp.asarray(mem), return_kv=True)
    app = {k: torch.from_numpy(np.array(v)) for k, v in ap.items()}
    got, (k, v) = pt_L.cross_attention_block(
        cfg, app, torch.from_numpy(x), torch.from_numpy(mem), return_kv=True)
    close(got, want, "cross attention")
    close(k, wk, "cross K")
    close(v, wv, "cross V")
    close(pt_L.cross_attention_block(cfg, app, torch.from_numpy(x), None,
                                     kv=(k, v)), want, "cross, cached K/V")


def test_init_params_shapes_and_count(model):
    rcfg, cfg, rp, pp, _ = model
    mine = pt_T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert pt_T.param_count(mine) == ref_T.param_count(rp) \
        == pt_T.param_count(pp)
    assert mine["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict)  # noqa: E731
                        else tuple(v.shape) for k, v in t.items()}
    assert [shapes(x) for x in mine["layers"]] == \
        [shapes(x) for x in pp["layers"]]
    # the reference's scales: embed 0.02, dense fan_in ** -0.5, norms 1
    assert abs(float(mine["embed"].std()) - 0.02) < 2e-3
    wq = mine["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert torch.equal(mine["layers"][1]["ln1"], torch.ones(cfg.d_model))


def test_forward_matches_reference(model):
    rcfg, cfg, rp, pp, jits = model
    t = tokens((2, 20), 1, cfg.vocab)
    want = jits["forward"](rp, jnp.asarray(t))
    h, aux = pt_T.forward(cfg, pp, torch.from_numpy(t),
                          compute_dtype=torch.float32)
    got = pt_T.logits_of(cfg, pp, h)
    close(got, want, "forward logits")
    assert float(aux) == 0.0


def test_prefill_matches_reference(model):
    rcfg, cfg, rp, pp, jits = model
    t = tokens((2, 20), 2, cfg.vocab)
    lw, cw = jits["prefill"](rp, jnp.asarray(t))
    lg, c = pt_T.prefill(cfg, pp, torch.from_numpy(t), max_len=32,
                         compute_dtype=torch.float32)
    close(lg, lw, "prefill logits")
    close(c["k"], cw["layers"]["p0"]["k"], "prefill K cache")
    close(c["v"], cw["layers"]["p0"]["v"], "prefill V cache")
    np.testing.assert_array_equal(c["lengths"].numpy(), cw["lengths"])


def test_mask_padded_vocab_matches_reference():
    """Full width: columns 151,936 to 152,063 are padding."""
    cfg = get_config("qwen3-0.6b")
    x = np.random.default_rng(7).normal(size=(2, cfg.padded_vocab)).astype(
        np.float32)
    got = pt_T.mask_padded_vocab(cfg, torch.from_numpy(x))
    want = ref_T.mask_padded_vocab(ref_get_config("qwen3-0.6b"),
                                   jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got[:, cfg.vocab:] == -1e30).all())


def test_prefill_continue_matches_reference(model):
    """Warm from start: the first 16 tokens' cache from a prefill, the
    remaining 7 continued; logits and cache equal the reference's, and the
    cold prefill of all 23 tokens."""
    rcfg, cfg, rp, pp, jits = model
    t = tokens((1, 23), 3, cfg.vocab)
    _, cw = ref_T.prefill(rcfg, rp, jnp.asarray(t[:, :16]), max_len=32, **F32)
    lw, cw = ref_T.prefill_continue(rcfg, rp, jnp.asarray(t[:, 16:]), cw, 16,
                                    **F32)
    _, c = pt_T.prefill(cfg, pp, torch.from_numpy(t[:, :16]), max_len=32,
                        compute_dtype=torch.float32)
    lg, c = pt_T.prefill_continue(cfg, pp, torch.from_numpy(t[:, 16:]), c, 16,
                                  compute_dtype=torch.float32)
    close(lg, lw, "prefill_continue logits")
    close(c["k"], cw["layers"]["p0"]["k"], "prefill_continue K cache")
    close(c["v"], cw["layers"]["p0"]["v"], "prefill_continue V cache")
    np.testing.assert_array_equal(c["lengths"].numpy(), cw["lengths"])
    cold, _ = pt_T.prefill(cfg, pp, torch.from_numpy(t), max_len=32,
                           compute_dtype=torch.float32)
    close(lg, cold.numpy(), "warm vs cold prefill", atol=2e-3)


def test_decode_steps_ragged_match_reference(model):
    """Three decode steps with ragged lengths (one row at the cache's
    end, where the write position clamps to max_len - 1)."""
    rcfg, cfg, rp, pp, jits = model
    t = tokens((3, 20), 4, cfg.vocab)
    _, cw = jits["prefill"](rp, jnp.asarray(t))
    _, c = pt_T.prefill(cfg, pp, torch.from_numpy(t), max_len=32,
                        compute_dtype=torch.float32)
    lens = np.array([20, 13, 31], np.int32)
    cw["lengths"] = jnp.asarray(lens)
    c["lengths"] = torch.from_numpy(lens.copy())
    tok = np.array([5, 7, 11], np.int32)
    for step in range(3):
        lw, cw = jits["decode"](rp, jnp.asarray(tok), cw)
        lg, c = pt_T.decode_step(cfg, pp, torch.from_numpy(tok), c,
                                 compute_dtype=torch.float32)
        close(lg, lw, f"decode logits, step {step}")
        close(c["k"], cw["layers"]["p0"]["k"], f"decode K cache, step {step}")
        close(c["v"], cw["layers"]["p0"]["v"], f"decode V cache, step {step}")
        np.testing.assert_array_equal(c["lengths"].numpy(), cw["lengths"])
        tok = np.asarray(jnp.argmax(lw, -1)).astype(np.int32)


@pytest.mark.parametrize("act", ["swiglu", "sqrelu", "gelu"])
def test_mlp_block_matches_reference(model, act):
    rcfg, cfg, _, _, _ = model
    rcfg, cfg = (dataclasses.replace(c, mlp_act=act) for c in (rcfg, cfg))
    rp = ref_L.init_mlp(rcfg, jax.random.PRNGKey(1))
    pp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = np.random.default_rng(5).normal(size=(2, 3, cfg.d_model)).astype(
        np.float32)
    close(pt_L.mlp_block(cfg, pp, torch.from_numpy(x)),
          ref_L.mlp_block(rcfg, rp, jnp.asarray(x)), f"mlp {act}")


@pytest.mark.parametrize("causal,window", [(True, None), (True, 4),
                                           (False, None)])
def test_attention_matches_reference(causal, window):
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = ref_fa.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal, window)
    got = pt_fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal, window)
    close(got, want, f"attention causal={causal} window={window}", 1e-5)
