"""The port's mixture-of-experts FFN (``models/moe.py``) against the
reference's.

Routing is held bit for bit: ``tournament_topk`` on given scores (ties
included: the lowest index wins, as ``lax.top_k`` has it) and
``_dispatch_slots`` on given expert ids at every capacity from 1 to the
number of routed pairs, one group and several. ``moe_block`` runs the
reference's weights (numpy copies) on the same inputs in float32 with
ample capacity, with drops, with the shared expert and with grouped
dispatch (``moe_groups`` > 1, and the fallback to one group when T % G);
outputs agree to 1e-5 (the same products summed in another order,
measured differences are about 1e-7) and the aux loss to 1e-6."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import ArchConfig as RefArchConfig
from repro.models import moe as ref_moe

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as pt_moe

torch.set_num_threads(1)

ATOL = 1e-5


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def cfgs(E=4, k=2, cap=8.0, **kw):
    """(reference cfg, port cfg) of a small MoE layer."""
    args = dict(name="t", family="moe", n_layers=2, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=32, vocab=64, n_experts=E, topk=k,
                capacity_factor=cap, **kw)
    return RefArchConfig(**args), ArchConfig(**args)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_tournament_topk_matches_reference(k):
    x = np.random.default_rng(k).normal(size=(64, 16)).astype(np.float32)
    # a third of the rows hold ties: small integers
    x[::3] = np.random.default_rng(k + 10).integers(0, 3, (22, 16))
    v, i = pt_moe.tournament_topk(t(x), k)
    vr, ir = ref_moe.tournament_topk(jnp.asarray(x), k)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    np.testing.assert_array_equal(
        i.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1]))


def test_tournament_topk_ties_lowest_index():
    _, i = pt_moe.tournament_topk(torch.tensor([[1.0, 3.0, 3.0, 0.0]]), 2)
    assert i[0].tolist() == [1, 2]
    _, i = pt_moe.tournament_topk(torch.zeros(2, 5), 3)
    assert i.tolist() == [[0, 1, 2]] * 2


# the reference's dispatch per group, as its moe_block vmaps it
ref_dispatch = jax.jit(jax.vmap(ref_moe._dispatch_slots, (0, None, None)),
                       static_argnums=(1, 2))


@pytest.mark.parametrize("E,Tk", [(4, 16), (3, 7)])
def test_dispatch_slots_bit_for_bit_at_every_capacity(E, Tk):
    """Skewed ids (half of them on expert 0) so that every capacity below
    Tk drops pairs; four groups in one call and the first group alone,
    against the reference's call per group."""
    rng = np.random.default_rng(E * Tk)
    ids = np.where(rng.random((4, Tk)) < 0.5, 0,
                   rng.integers(0, E, (4, Tk))).astype(np.int32)
    for C in range(1, Tk + 1):
        rs, rt = (np.asarray(a) for a in ref_dispatch(jnp.asarray(ids), E, C))
        slot, tok = pt_moe._dispatch_slots(t(ids), E, C)
        assert slot.dtype == tok.dtype == torch.int32
        np.testing.assert_array_equal(slot.numpy(), rs)
        np.testing.assert_array_equal(tok.numpy(), rt)
        slot, tok = pt_moe._dispatch_slots(t(ids[0]), E, C)
        np.testing.assert_array_equal(slot.numpy(), rs[0])
        np.testing.assert_array_equal(tok.numpy(), rt[0])
        if C == 1:
            assert bool((slot == E).any()), "capacity 1 dropped no pair"


MOE_CASES = {
    "ample": dict(cfg=dict(E=4, k=2, cap=8.0), x=(2, 8)),
    "drops": dict(cfg=dict(E=4, k=2, cap=0.25), x=(2, 16)),
    "capacity_1.25": dict(cfg=dict(E=4, k=2, cap=1.25), x=(2, 16)),
    "shared_top1": dict(cfg=dict(E=4, k=1, cap=8.0, shared_expert=True),
                        x=(1, 8)),
    "grouped": dict(cfg=dict(E=4, k=2, cap=8.0, moe_groups=4), x=(2, 16)),
    "grouped_drops": dict(cfg=dict(E=4, k=2, cap=0.5, moe_groups=2),
                          x=(2, 16)),
    "grouped_fallback": dict(cfg=dict(E=4, k=2, cap=1.0, moe_groups=3),
                             x=(1, 8)),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_reference(case):
    spec = MOE_CASES[case]
    rcfg, cfg = cfgs(**spec["cfg"])
    rp = ref_moe.init_moe(rcfg, jax.random.PRNGKey(len(case)))
    pp = jax.tree.map(t, rp)
    x = np.random.default_rng(len(case)).normal(
        size=(*spec["x"], cfg.d_model)).astype(np.float32)
    y, aux = pt_moe.moe_block(cfg, pp, t(x))
    yr, auxr = jax.jit(lambda p, x: ref_moe.moe_block(rcfg, p, x))(
        rp, jnp.asarray(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=0,
                               atol=ATOL, err_msg=case)
    np.testing.assert_allclose(float(aux), float(auxr), rtol=0, atol=1e-6)
    # the routing under it is the reference's, bit for bit
    T = x.shape[0] * x.shape[1]
    logits = (t(x).reshape(T, -1) @ pp["router"]).numpy()
    _, i = pt_moe.tournament_topk(t(logits), cfg.topk)
    _, ir = ref_moe.tournament_topk(jnp.asarray(logits), cfg.topk)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))


def test_moe_drops_zero_the_dropped_pairs():
    """Capacity 1 per expert and group: all but E pairs drop; a token
    whose pairs all dropped gets the zero row (plus nothing else)."""
    rcfg, cfg = cfgs(E=4, k=1, cap=1e-6)
    rp = ref_moe.init_moe(rcfg, jax.random.PRNGKey(3))
    pp = jax.tree.map(t, rp)
    x = np.random.default_rng(3).normal(size=(1, 12, 16)).astype(np.float32)
    y, _ = pt_moe.moe_block(cfg, pp, t(x))
    kept = int((y.abs().sum(-1) > 0).sum())
    assert 1 <= kept <= cfg.n_experts
    want = jax.jit(lambda p, x: ref_moe.moe_block(rcfg, p, x)[0])(
        rp, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_shared_expert_is_added():
    rcfg, cfg = cfgs(E=4, k=1, cap=8.0, shared_expert=True)
    pp = pt_moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(1, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with_shared, _ = pt_moe.moe_block(cfg, pp, x)
    zero = dict(pp, shared={k: torch.zeros_like(v)
                            for k, v in pp["shared"].items()})
    assert not torch.allclose(with_shared, pt_moe.moe_block(cfg, zero, x)[0])


def test_init_moe_shapes_and_scales():
    """The reference's shapes; experts drawn at fan_in ** -0.5 of D (up,
    gate) and F (down)."""
    rcfg, cfg = cfgs(E=4, k=2, shared_expert=True)
    cfg = dataclasses.replace(cfg, d_model=64, d_ff=256)
    rcfg = dataclasses.replace(rcfg, d_model=64, d_ff=256)
    pp = pt_moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    rp = ref_moe.init_moe(rcfg, jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), rp)
    assert jax.tree.map(lambda a: tuple(a.shape), pp) == shapes
    for name, fan in (("w_gate", 64), ("w_up", 64), ("w_down", 256)):
        assert abs(float(pp[name].std()) * fan ** 0.5 - 1) < 0.05, name
