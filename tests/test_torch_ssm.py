"""The port's Mamba2 block (``models/ssm.py``) against its own naive
recurrence and against the reference's.

The cases of ``tests/test_ssm.py`` on the port: the chunked SSD scan equal
to the per-step recurrence for chunk {4, 8, 16} x groups {1, 2, 4}, a
state carried across calls, and prefill then one decode step equal to the
whole sequence. The same numpy inputs also go through the reference's
``ssd_chunked`` and ``mamba_block`` (prefill with padding to the chunk,
the decode branch, the returned conv and SSM states). Tolerance 1e-4
absolute and relative, as the reference's own tests hold it: the
three-operand einsum of the boundary states and the decays sum in another
order than the reference's (measured differences are about 1e-6)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import ArchConfig as RefArchConfig
from repro.models import ssm as ref_ssm

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm as pt_ssm

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
# the reference's calls, compiled once a shape (eagerly, its scan over the
# chunks would compile at every call)
ref_ssd = jax.jit(ref_ssm.ssd_chunked, static_argnums=5)
ref_prefill = jax.jit(lambda cfg, p, x, chunk: ref_ssm.mamba_block(
    cfg, p, x, chunk=chunk, return_state=True), static_argnums=(0, 3))
ref_decode = jax.jit(lambda cfg, p, x, conv, h: ref_ssm.mamba_block(
    cfg, p, x, conv_state=conv, ssm_state=h, return_state=True),
    static_argnums=0)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def inputs(seed, B=2, S=16, H=4, P=8, G=2, N=8):
    """The reference test's input recipe, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P))
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)) - 1))
    a_log = -np.exp(rng.normal(size=(B, S, H)) * 0.3) * dt
    B_ = rng.normal(size=(B, S, G, N))
    C_ = rng.normal(size=(B, S, G, N))
    return [a.astype(np.float32) for a in (x, a_log, dt, B_, C_)]


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_ssd_chunked_matches_naive_and_reference(chunk, G):
    arrs = inputs(0, G=G)
    y, h = pt_ssm.ssd_chunked(*map(t, arrs), chunk)
    yn, hn = pt_ssm.naive_recurrence(*map(t, arrs))
    assert y.dtype == h.dtype == torch.float32
    close(y, yn, "chunked vs naive y")
    close(h, hn, "chunked vs naive h")
    yr, hr = ref_ssd(*map(jnp.asarray, arrs), chunk)
    close(y, yr, "chunked vs reference y")
    close(h, hr, "chunked vs reference h")


def test_ssd_carried_state_across_calls():
    arrs = [t(a) for a in inputs(1, S=16)]
    y_full, h_full = pt_ssm.ssd_chunked(*arrs, 8)
    y1, h1 = pt_ssm.ssd_chunked(*(a[:, :8] for a in arrs), 8)
    y2, h2 = pt_ssm.ssd_chunked(*(a[:, 8:] for a in arrs), 8, h0=h1)
    close(torch.cat([y1, y2], 1), y_full, "carried y")
    close(h2, h_full, "carried h")
    _, hn = pt_ssm.naive_recurrence(*(a[:, 8:] for a in arrs), h0=h1)
    close(h2, hn, "carried h vs naive")


def test_ssd_masks_the_overflowing_upper_triangle():
    """Strong decay: exp(cum_t - cum_s) of the upper triangle overflows
    to inf, and the select keeps it out (a multiply by 0 would be NaN)."""
    x, a_log, dt, B_, C_ = inputs(2, S=16)
    a_log = a_log * 200.0
    y, h = pt_ssm.ssd_chunked(*map(t, (x, a_log, dt, B_, C_)), 16)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    close(y, pt_ssm.naive_recurrence(*map(t, (x, a_log, dt, B_, C_)))[0],
          "strong decay")


def cfgs(groups: int):
    args = dict(name="t", family="ssm", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=4, d_ff=0, vocab=64, ssm_state=8, ssm_headdim=8,
                ssm_groups=groups)
    return RefArchConfig(**args), ArchConfig(**args)


@pytest.fixture(scope="module")
def block():
    """(reference cfg, port cfg, reference params, port params, x)."""
    rcfg, cfg = cfgs(groups=2)
    rp = ref_ssm.init_mamba(rcfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(1).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    return rcfg, cfg, rp, {k: t(v) for k, v in rp.items()}, x


def test_mamba_block_prefill_then_decode_matches_full(block):
    _, cfg, _, pp, x = block
    x = t(x)
    full = pt_ssm.mamba_block(cfg, pp, x, chunk=4)
    y_pre, (conv_s, ssm_s) = pt_ssm.mamba_block(cfg, pp, x[:, :11], chunk=11,
                                                return_state=True)
    y_dec, (conv_d, ssm_d) = pt_ssm.mamba_block(
        cfg, pp, x[:, 11:12], conv_state=conv_s, ssm_state=ssm_s,
        return_state=True)
    close(y_pre, full[:, :11], "prefill")
    close(y_dec, full[:, 11:12], "decode")
    assert ssm_d.dtype == torch.float32
    assert conv_d.shape == (2, cfg.ssm_conv - 1, pt_ssm.dims(cfg)[2])


@pytest.mark.parametrize("S,chunk", [(12, 4), (12, 256), (11, 8)])
def test_mamba_block_matches_reference(block, S, chunk):
    """Prefill (padded to a multiple of chunk, then cut to min(chunk,
    S_padded)) and its states, then two decode steps on those states."""
    rcfg, cfg, rp, pp, x = block
    got, (conv_s, ssm_s) = pt_ssm.mamba_block(cfg, pp, t(x[:, :S]),
                                              chunk=chunk, return_state=True)
    want, (rconv, rssm) = ref_prefill(rcfg, rp, jnp.asarray(x[:, :S]), chunk)
    close(got, want, "prefill out")
    close(conv_s, rconv, "conv state")
    close(ssm_s, rssm, "ssm state")
    for s in range(2):
        x1 = x[:, s:s + 1] * 0.5
        got, (conv_s, ssm_s) = pt_ssm.mamba_block(
            cfg, pp, t(x1), conv_state=conv_s, ssm_state=ssm_s,
            return_state=True)
        want, (rconv, rssm) = ref_decode(rcfg, rp, jnp.asarray(x1), rconv,
                                         rssm)
        close(got, want, f"decode {s} out")
        close(conv_s, rconv, f"decode {s} conv state")
        close(ssm_s, rssm, f"decode {s} ssm state")


def test_init_mamba_matches_reference_shapes(block):
    rcfg, cfg, rp, _, _ = block
    pp = pt_ssm.init_mamba(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in pp.items()} == \
        {k: tuple(v.shape) for k, v in rp.items()}
    for k in ("A_log", "D", "dt_bias", "gate_norm"):
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(rp[k]))
