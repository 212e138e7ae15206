"""The port's chunked attention (``models/flash_attention.py``) against the
reference's, forward and grads.

The same numpy inputs go through the reference's ``flash_attention``
(jitted once a case, its custom VJP for the grads) and the port's
``torch.autograd.Function`` at the same chunk sizes, over the cases of
tests/test_flash_attention.py: causal, GQA with a ragged sequence, a
sliding window, cross attention with ragged kv, MQA. Float32 outputs and
grads agree to 2e-5 (the reference's own tolerance against its oracle;
measured differences are about 1e-6). bf16 inputs accumulate in float32
and agree with the float32 oracle to 2e-2, as in the reference; the
output is the same across chunk sizes; the plain ``masked_attention``
and ``attention_reference`` give the same function."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.models import flash_attention as ref_fa

from repro_torch.models import flash_attention as pt_fa

torch.set_num_threads(1)

TOL = 2e-5

CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window, qc, kc)
    (2, 32, 32, 4, 4, 16, True, None, 8, 8),
    (1, 33, 33, 4, 2, 8, True, None, 8, 16),      # GQA + ragged seq
    (2, 24, 24, 4, 4, 8, True, 7, 8, 8),          # sliding window
    (2, 16, 40, 2, 2, 8, False, None, 8, 16),     # cross attention, ragged kv
    (1, 64, 64, 8, 1, 8, True, None, 16, 32),     # MQA
]
IDS = [str(c) for c in CASES]


def inputs(case, seed):
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, Hq, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))


def close(got: torch.Tensor, want, what: str, tol: float = TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_reference(case):
    causal, window, qc, kc = case[6:]
    q, k, v = inputs(case, 0)
    want = jax.jit(lambda a, b, c: ref_fa.flash_attention(
        a, b, c, causal, window, qc, kc))(q, k, v)
    got = pt_fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal,
                                window, qc, kc)
    close(got, want, "forward")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grads_match_reference(case):
    """d(sum sin(out)) / dq, dk, dv through both custom backwards."""
    causal, window, qc, kc = case[6:]
    q, k, v = inputs(case, 3)
    want = jax.jit(jax.grad(lambda a, b, c: jnp.sum(jnp.sin(
        ref_fa.flash_attention(a, b, c, causal, window, qc, kc))),
        argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = pt_fa.flash_attention(*ts, causal, window, qc, kc)
    got = torch.autograd.grad(torch.sin(out).sum(), ts)
    for g, w, name in zip(got, want, "qkv"):
        close(g, w, f"d{name}", 3e-5)


def test_grads_match_the_plain_version():
    """The chunked backward against autograd through masked_attention."""
    case = CASES[2]
    causal, window, qc, kc = case[6:]
    q, k, v = inputs(case, 5)
    S = q.shape[1]
    pos = torch.arange(S)
    ok = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :]
                                           < window)
    grads = []
    for fn in (lambda a, b, c: pt_fa.flash_attention(a, b, c, causal,
                                                     window, qc, kc),
               lambda a, b, c: pt_fa.masked_attention(a, b, c, ok[None])):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        grads.append(torch.autograd.grad(torch.sin(fn(*ts)).sum(), ts))
    for g, w, name in zip(*grads, "qkv"):
        close(g, w.numpy(), f"d{name}", 3e-5)


def test_bf16_inputs_f32_accumulation():
    q, k, v = inputs((1, 32, 32, 2, 2, 16), 7)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = pt_fa.flash_attention(tq, tk, tv, True, None, 8, 8)
    want = jax.jit(lambda a, b, c: ref_fa.attention_reference(
        a, b, c, True, None))(*(t.float().numpy() for t in (tq, tk, tv)))
    assert got.dtype == torch.bfloat16
    close(got, want, "bf16", 2e-2)
    # the reference's bf16 forward on the same bf16 inputs
    ref_bf16 = jax.jit(lambda a, b, c: ref_fa.flash_attention(
        a, b, c, True, None, 8, 8))(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (tq, tk, tv)))
    close(got, ref_bf16.astype(jnp.float32), "bf16 vs the reference", 2e-2)
    g = torch.autograd.grad(
        pt_fa.flash_attention(*(t.requires_grad_() for t in (tq, tk, tv)),
                              True, None, 8, 8).float().sum(), (tq, tk, tv))
    assert all(x.dtype == torch.bfloat16 and torch.isfinite(x).all()
               for x in g)


def test_chunks_equivalence():
    q, k, v = map(torch.from_numpy, inputs((1, 48, 48, 2, 2, 8), 1))
    full = pt_fa.flash_attention(q, k, v, True, None, 48, 48)
    tiny = pt_fa.flash_attention(q, k, v, True, None, 8, 4)
    close(tiny, full.numpy(), "chunks")


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_plain_versions_match_the_oracle(causal, window):
    """masked_attention (decode's) and attention_reference against the
    reference's oracle."""
    q, k, v = inputs((2, 12, 12, 4, 2, 16), 9)
    want = jax.jit(lambda a, b, c: ref_fa.attention_reference(
        a, b, c, causal, window))(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    close(pt_fa.attention_reference(tq, tk, tv, causal, window), want,
          "attention_reference")
    pos = torch.arange(12)
    ok = torch.ones(12, 12, dtype=torch.bool)
    if causal:
        ok &= pos[:, None] >= pos[None, :]
    if window is not None:
        ok &= pos[:, None] - pos[None, :] < window
    close(pt_fa.masked_attention(tq, tk, tv, ok[None]), want,
          "masked_attention")


def test_causal_requires_equal_lengths():
    q, k, v = map(torch.from_numpy, inputs((1, 4, 6, 2, 2, 8), 2))
    with pytest.raises(ValueError, match="Sq == Skv"):
        pt_fa.flash_attention(q, k, v, True)
