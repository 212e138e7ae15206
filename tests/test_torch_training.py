"""The port's training stack against the reference's: data pipeline,
AdamW, chunked CE, the train step with microbatches and remat, the
Trainer with resume and watchdog, the launcher, and the grads of the MoE
and Mamba blocks.

The cases of tests/test_training.py run on the port, and the same inputs
(numpy seeds; the reference's parameters carried over with
``from_reference_params``) go through both packages in float32:

  * data batches are the reference's bit for bit;
  * schedules, AdamW on the same grads, the decay mask (on the reference's
    stacked rank) agree to 1e-6 relative;
  * two steps of ``make_train_step`` on reduced qwen3-0.6b, microbatches 1
    and 2 x remat False / "group" / "block", each from the reference's
    state before it: loss, grad norm and lr to 1e-5 relative (measured
    about 1e-7); the moments to 1e-5 of each leaf's largest (measured
    2e-6); the params to 1e-6 where the grad stands above float32 noise
    (|m| > 1e-6; measured 3e-8), and within 2 lr everywhere (Adam divides
    m by sqrt(v): a grad at noise level gives a step that is itself
    noise, up to lr);
  * a checkpoint written by either package's Trainer resumes in the other
    and gives the same next loss (1e-5 relative);
  * MoE and Mamba block grads to 1e-5 (measured about 1e-7).

Hybrid, vlm and audio models are held to finite grads, as in the
reference."""
import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.ckpt import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.configs.base import ArchConfig as RefArchConfig
from repro.data import DataConfig as RefDataConfig
from repro.data import batch_at as ref_batch_at
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_T
from repro.optim import adamw as ref_adamw
from repro.train import Trainer as RefTrainer
from repro.train import TrainConfig as RefTrainConfig
from repro.train import chunked_ce_loss as ref_chunked_ce
from repro.train import make_train_step as ref_make_train_step

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.util import tree_leaves, tree_map
from repro_torch.data import DataConfig, batch_at, iterate
from repro_torch.launch import train as train_launcher
from repro_torch.models import moe as pt_moe
from repro_torch.models import ssm as pt_ssm
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import (Trainer, TrainConfig, chunked_ce_loss,
                               make_train_step)

torch.set_num_threads(1)

RTOL = 1e-5
LM_ARCHS = [a for a in ARCH_IDS if a != "nitrogen-db"]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel(got, want, what: str, rtol: float = RTOL):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol,
                               err_msg=what)


def ref_leaves(tree) -> list:
    """The leaves of a tree in the reference's layout (JAX arrays, or the
    port's tensors from ``to_reference_params``) in the reference's
    flatten order, as numpy."""
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed,step,host_id,num_hosts", [
    (0, 0, 0, 1), (3, 17, 0, 1), (0, 5, 1, 2), (7, 2, 3, 4)])
def test_batches_bit_for_bit(seed, step, host_id, num_hosts):
    kw = dict(vocab=1000, seq_len=24, global_batch=8, seed=seed,
              num_hosts=num_hosts, host_id=host_id)
    got, want = batch_at(DataConfig(**kw), step), \
        ref_batch_at(RefDataConfig(**kw), step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    it = iterate(DataConfig(**kw), start_step=step)
    for s in range(step, step + 3):
        np.testing.assert_array_equal(next(it)["tokens"], ref_batch_at(
            RefDataConfig(**kw), s)["tokens"])


def test_data_deterministic_and_host_disjoint():
    c0 = DataConfig(vocab=100, seq_len=8, global_batch=4, num_hosts=2,
                    host_id=0)
    c1 = dataclasses.replace(c0, host_id=1)
    b0a, b0b = batch_at(c0, 3), batch_at(c0, 3)
    np.testing.assert_array_equal(b0a["tokens"], b0b["tokens"])
    b1 = batch_at(c1, 3)
    assert not np.array_equal(b0a["tokens"], b1["tokens"])
    bf = batch_at(DataConfig(vocab=100, seq_len=8, global_batch=4), 3)
    np.testing.assert_array_equal(
        np.concatenate([b0a["tokens"], b1["tokens"]]), bf["tokens"])
    with pytest.raises(ValueError, match="split"):
        DataConfig(vocab=100, seq_len=8, global_batch=3, num_hosts=2) \
            .host_batch


# ------------------------------------------------------------------ optimizer
def test_adamw_decreases_quadratic():
    cfg = adamw.OptConfig(lr=0.1, schedule="const", warmup_steps=0,
                          weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([[3.0, -2.0]])}
    state = adamw.init_state(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_schedules_shapes_and_values():
    for sched in ("cosine", "wsd", "linear", "const"):
        kw = dict(lr=1.0, schedule=sched, warmup_steps=10, total_steps=100)
        cfg, rcfg = adamw.OptConfig(**kw), ref_adamw.OptConfig(**kw)
        lrs = [float(adamw.schedule_fn(cfg, torch.tensor(s, dtype=torch.int32)))
               for s in range(101)]
        want = [float(ref_adamw.schedule_fn(rcfg, jnp.asarray(s)))
                for s in range(101)]
        np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=1e-7,
                                   err_msg=sched)
        assert lrs[0] == 0.0 and abs(lrs[10] - 1.0) < 1e-6
        if sched == "wsd":                      # flat middle, decaying tail
            assert abs(lrs[50] - 1.0) < 1e-6 and lrs[99] < 0.2
        if sched != "const":
            assert lrs[100] < 0.05


def test_grad_clip_caps_global_norm():
    cfg = adamw.OptConfig(lr=0.0, clip_norm=1.0, schedule="const")
    params = {"w": torch.zeros(4)}
    _, _, m = adamw.apply_updates(cfg, params, {"w": torch.full((4,), 100.0)},
                                  adamw.init_state(params))
    assert float(m["grad_norm"]) > 100.0        # reported pre-clip


@pytest.fixture(scope="module")
def hybrid():
    """Reduced jamba at a period of 2 (a Mamba block with an MoE FFN, then
    an attention block with a dense one; jamba's own period of 8 makes the
    reference's init take seconds): (port cfg, reference params)."""
    kw = dict(attn_every=2, attn_index=1, moe_every=2, moe_offset=0,
              n_layers=4)
    rcfg = dataclasses.replace(
        ref_get_config("jamba-v0.1-52b").reduced(), **kw)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(), **kw)
    return cfg, ref_T.init_params(rcfg, jax.random.PRNGKey(0))


def test_adamw_matches_reference_on_the_same_grads(hybrid):
    """Three clipped, decayed steps on a hybrid model's parameters with
    grads from numpy: every param and moment, the grad norm and lr."""
    cfg, rp = hybrid
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=5, weight_decay=0.1,
              clip_norm=1.0)
    ocfg, rocfg = adamw.OptConfig(**kw), ref_adamw.OptConfig(**kw)
    rng = np.random.default_rng(0)
    pp = T.from_reference_params(cfg, rp, device="cpu")
    po, ro = adamw.init_state(pp), ref_adamw.init_state(rp)
    ref_update = jax.jit(lambda p, g, o: ref_adamw.apply_updates(
        rocfg, p, g, o))
    for _ in range(3):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32) * 0.1, rp)
        rp, ro, rm = ref_update(rp, g, ro)
        pp, po, pm = adamw.apply_updates(
            ocfg, pp, T.from_reference_params(cfg, g, device="cpu"), po)
        rel(pm["grad_norm"], rm["grad_norm"], "grad norm", 1e-6)
        rel(pm["lr"], rm["lr"], "lr", 1e-6)
    assert int(po["count"]) == int(ro["count"]) == 3
    got = T.to_reference_opt_state(cfg, po)
    for name, a, b in (("params", T.to_reference_params(cfg, pp), rp),
                       ("m", got["m"], ro["m"]), ("v", got["v"], ro["v"])):
        for x, y in zip(ref_leaves(a), ref_leaves(b)):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7,
                                       err_msg=name)


def test_decay_mask_uses_the_reference_stacked_rank(hybrid):
    """The port's layers are one dim shorter than the reference's stacked
    blocks: a block's norm scale (1-D here, [repeats, D] there) and the
    Mamba heads' A_log / D / dt_bias are decayed in both, the final norm
    in neither. With zero grads a step is the decay alone."""
    cfg, rp = hybrid
    pp = T.from_reference_params(cfg, rp, device="cpu")
    want = [ref_adamw._decay_mask(x) for x in jax.tree.leaves(rp)]
    # the port's mask per layer leaf, stacked into the reference's layout
    stacked = ref_leaves(T.to_reference_params(cfg, tree_map(
        torch.tensor, adamw.decay_mask(pp))))
    assert [bool(m.all()) for m in stacked] == \
        [bool(m.any()) for m in stacked] == want
    assert want.count(False) == 1 and not adamw.decay_mask(
        {"w": torch.ones(3)})["w"]              # final_norm alone
    kw = dict(lr=0.5, schedule="const", warmup_steps=0, weight_decay=0.1)
    zeros = jax.tree.map(jnp.zeros_like, rp)
    rp2, _, _ = jax.jit(lambda p, g, o: ref_adamw.apply_updates(
        ref_adamw.OptConfig(**kw), p, g, o))(rp, zeros,
                                             ref_adamw.init_state(rp))
    pp, _, _ = adamw.apply_updates(adamw.OptConfig(**kw), pp, T.from_reference_params(
        cfg, zeros, device="cpu"), adamw.init_state(pp))
    layer0 = pp["layers"][0]
    np.testing.assert_array_equal(layer0["ln1"].numpy(),
                                  np.asarray(rp2["blocks"]["p0"]["ln1"][0]))
    assert np.allclose(layer0["ln1"].numpy(), 1 - 0.5 * 0.1)
    mamba = layer0["mamba"]
    for k in ("A_log", "D", "dt_bias"):
        np.testing.assert_array_equal(
            mamba[k].numpy(), np.asarray(rp2["blocks"]["p0"]["mamba"][k][0]))
    np.testing.assert_allclose(mamba["D"].numpy(), 1 - 0.5 * 0.1)
    assert torch.equal(pp["final_norm"], torch.ones(cfg.d_model))
    np.testing.assert_array_equal(np.asarray(rp2["final_norm"]), 1.0)


# ------------------------------------------------------------------ loss
def test_chunked_ce_matches_full_and_reference():
    rcfg = ref_get_config("qwen3-0.6b").reduced()
    cfg = get_config("qwen3-0.6b").reduced()
    rp = ref_T.init_params(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    h = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    labels[1, -3:] = -1                          # ignored
    pp = T.from_reference_params(cfg, rp, device="cpu")
    got = chunked_ce_loss(cfg, pp, t(h), t(labels), chunk=5)  # ragged
    rel(got, ref_chunked_ce(rcfg, rp, jnp.asarray(h), jnp.asarray(labels),
                            chunk=5), "chunked CE vs the reference")
    logits = torch.from_numpy(h) @ pp["embed"].T
    valid = torch.from_numpy(labels >= 0)
    full = (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, t(labels).clamp(min=0).long()[..., None])[..., 0])
    rel(got, full[valid].mean(), "chunked CE vs the full CE")


# ------------------------------------------------------------------ step
@pytest.fixture(scope="module")
def step_case():
    """Reduced qwen3-0.6b, two batches, and the reference's two steps at
    microbatches 1 and 2: per step (params and opt state before it, its
    metrics, params and opt state after it). Remat does not change the
    reference's values (its recompute is the same arithmetic), so it runs
    without."""
    rcfg = ref_get_config("qwen3-0.6b").reduced()
    cfg = get_config("qwen3-0.6b").reduced()
    rp = ref_T.init_params(rcfg, jax.random.PRNGKey(0))
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    ref = {}
    for mb in (1, 2):
        step = jax.jit(ref_make_train_step(
            rcfg, ref_adamw.OptConfig(**kw), microbatches=mb,
            compute_dtype=jnp.float32, remat=False, ce_chunk=8,
            attn_chunks=(8, 8)))
        p, o, steps = rp, ref_adamw.init_state(rp), []
        for b in batches:
            p2, o2, m = step(p, o, b)
            steps.append(((p, o), {k: float(v) for k, v in m.items()},
                          (p2, o2)))
            p, o = p2, o2
        ref[mb] = steps
    return cfg, adamw.OptConfig(**kw), batches, ref


@pytest.mark.parametrize("remat", [False, "group", "block"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(step_case, microbatches, remat):
    """Each of two steps from the reference's state before it (so that the
    noise Adam amplifies in one step does not compound into the next)."""
    cfg, ocfg, batches, ref = step_case
    step = make_train_step(cfg, ocfg, microbatches=microbatches,
                           compute_dtype=torch.float32,
                           remat=True if remat == "group" else remat,
                           ce_chunk=8, attn_chunks=(8, 8))
    for b, ((rp, ro), want, (rp2, ro2)) in zip(batches, ref[microbatches]):
        params = T.from_reference_params(cfg, rp, device="cpu")
        opt = T.from_reference_opt_state(cfg, ro, device="cpu")
        params, opt, m = step(params, opt, {k: t(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            rel(m[k], want[k], k)
        got = T.to_reference_opt_state(cfg, opt)
        assert int(got["count"]) == int(ro2["count"])
        for name in ("m", "v"):
            for x, y in zip(ref_leaves(got[name]), ref_leaves(ro2[name])):
                np.testing.assert_allclose(x, y, rtol=0,
                                           atol=RTOL * np.abs(y).max(),
                                           err_msg=name)
        for x, y, mom in zip(ref_leaves(T.to_reference_params(cfg, params)),
                             ref_leaves(rp2), ref_leaves(ro2["m"])):
            d = np.abs(x - y)
            assert d.max() <= 2 * want["lr"]
            assert d[np.abs(mom) > 1e-6].max(initial=0) <= 1e-6


def test_microbatch_grads_match_full_batch():
    cfg = get_config("minicpm-2b").reduced()
    opt = adamw.OptConfig(lr=1e-3, schedule="const", clip_norm=None)
    rng = np.random.default_rng(1)
    batch = {k: t(rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32))
             for k in ("tokens", "labels")}
    out = []
    for mb in (1, 2):
        p = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(cfg, opt, microbatches=mb,
                               compute_dtype=torch.float32)
        out.append(step(p, adamw.init_state(p), batch))
    (p1, _, m1), (p2, _, m2) = out
    rel(m1["loss"], m2["loss"], "loss")
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert float(m1["grad_norm"]) > 0


def test_cast_params_once_keeps_float32_params():
    """A bf16 copy differentiated once a step, grads widened back: the
    params and moments stay float32 and the loss is the bf16 step's."""
    cfg = get_config("qwen3-0.6b").reduced()
    opt = adamw.OptConfig(lr=1e-3)
    rng = np.random.default_rng(2)
    batch = {k: t(rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32))
             for k in ("tokens", "labels")}
    losses = []
    for once in (False, True):
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(cfg, opt, microbatches=2,
                               compute_dtype=torch.bfloat16,
                               cast_params_once=once)
        params, state, m = step(params, adamw.init_state(params), batch)
        assert all(x.dtype == torch.float32 for x in tree_leaves(params))
        assert all(x.dtype == torch.float32 for x in tree_leaves(state["m"]))
        assert np.isfinite(float(m["grad_norm"]))
        losses.append(float(m["loss"]))
    rel(losses[1], losses[0], "bf16 loss", 2e-2)


# bf16 compute against the reference's bf16 step (XLA on the CPU runs the
# bf16 dots and reductions at a higher internal precision, so the gap is
# mostly the port's own bf16 rounding): loss 1e-4 relative (measured
# 1.9e-5), grad norm 3e-3 (measured 6.4e-4), each moment leaf (the first
# step's m is a tenth of its clipped grad) 3e-2 in norm (measured 1.5e-2;
# a grad leaf mis-scaled by 5% shows 4.5%).
BF16_LOSS_RTOL, BF16_GNORM_RTOL, BF16_LEAF_RTOL = 1e-4, 3e-3, 3e-2


@pytest.mark.parametrize("cast_params_once", [False, True])
def test_bf16_train_step_matches_reference(cast_params_once):
    """One bf16 step at microbatches 2 from the reference's state: the
    loss, the grad norm and every leaf's grad (through the first moment)
    against the reference's bf16 step; params and moments stay float32."""
    rcfg = ref_get_config("qwen3-0.6b").reduced()
    cfg = get_config("qwen3-0.6b").reduced()
    rp = ref_T.init_params(rcfg, jax.random.PRNGKey(0))
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    _, ro2, want = jax.jit(ref_make_train_step(
        rcfg, ref_adamw.OptConfig(**kw), microbatches=2,
        compute_dtype=jnp.bfloat16, remat=False, ce_chunk=8,
        attn_chunks=(8, 8), cast_params_once=cast_params_once))(
        rp, ref_adamw.init_state(rp), batch)
    step = make_train_step(cfg, adamw.OptConfig(**kw), microbatches=2,
                           compute_dtype=torch.bfloat16, ce_chunk=8,
                           attn_chunks=(8, 8),
                           cast_params_once=cast_params_once)
    params, opt, m = step(
        T.from_reference_params(cfg, rp, device="cpu"),
        T.from_reference_opt_state(cfg, ref_adamw.init_state(rp),
                                   device="cpu"),
        {k: t(v) for k, v in batch.items()})
    rel(m["loss"], want["loss"], "bf16 loss", BF16_LOSS_RTOL)
    rel(m["grad_norm"], want["grad_norm"], "bf16 grad norm", BF16_GNORM_RTOL)
    assert all(x.dtype == torch.float32 for x in tree_leaves(params))
    got = T.to_reference_opt_state(cfg, opt)
    for x, y in zip(ref_leaves(got["m"]), ref_leaves(ro2["m"])):
        assert x.dtype == np.float32 and x.shape == y.shape
        assert np.linalg.norm(x - y) <= BF16_LEAF_RTOL * np.linalg.norm(y)


# ------------------------------------------------------------------ trainer
def make_trainer(tmpdir, steps=6, arch="qwen3-0.6b", pkg="port", **tkw):
    """The reference test's trainer: reduced arch, a schedule horizon fixed
    apart from ``steps`` (a resumed and a straight run follow the same lr),
    checkpoints every 2 steps."""
    torch_pkg = pkg == "port"
    acfg = (get_config if torch_pkg else ref_get_config)(arch).reduced()
    okw = dict(lr=1e-3, schedule="cosine", warmup_steps=2, total_steps=100)
    dkw = dict(vocab=acfg.vocab, seq_len=16, global_batch=4)
    tkw = dict(steps=steps, ckpt_dir=os.path.join(tmpdir, "ck"),
               ckpt_every=2, log_every=100, **tkw)
    if torch_pkg:
        return Trainer(acfg, adamw.OptConfig(**okw), DataConfig(**dkw),
                       TrainConfig(**tkw), log=lambda s: None, device="cpu")
    return RefTrainer(acfg, ref_adamw.OptConfig(**okw), RefDataConfig(**dkw),
                      RefTrainConfig(**tkw), log=lambda s: None)


def test_trainer_loss_decreases_and_checkpoints(tmp_path):
    tr = make_trainer(str(tmp_path), steps=6)
    hist = tr.run()
    assert len(hist) == 6
    assert hist[-1]["loss"] < hist[0]["loss"] * 1.05
    assert ckpt.latest_step(str(tmp_path / "ck")) == 6
    assert len(tr.save_seconds) == 3             # steps 2, 4, 6 once each


def test_restart_resumes_exactly(tmp_path):
    tr1 = make_trainer(str(tmp_path), steps=4)
    tr1.run()
    tr2 = make_trainer(str(tmp_path), steps=8)
    assert tr2.state.step == 4 and tr2.restore_seconds is not None
    tr2.run()
    shutil.rmtree(tmp_path / "ck")
    tr3 = make_trainer(str(tmp_path), steps=8)
    tr3.run()
    for a, b in zip(*(ref_leaves(T.to_reference_params(tr.acfg,
                                                        tr.state.params))
                      for tr in (tr2, tr3))):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_straggler_watchdog_flags_slow_step(tmp_path):
    times = iter([0.0, 1.0,   # step 1: 1s
                  1.0, 2.0,   # step 2: 1s
                  2.0, 12.0,  # step 3: 10s -> flagged
                  12.0, 13.0])
    tr = make_trainer(str(tmp_path), steps=4, straggler_factor=3.0)
    logged = []
    tr.clock, tr.log = (lambda: next(times)), logged.append
    tr.run()
    assert tr.straggler_flags == 1
    assert any("[watchdog] step 2" in s for s in logged)


@pytest.fixture(scope="module")
def ref_resumed(tmp_path_factory):
    """The reference's trainer: 2 steps saved at step 2 in one directory,
    then its step 3; the step function it compiled (for the trainer that
    resumes the port's checkpoint: same configs, so one compile)."""
    d = str(tmp_path_factory.mktemp("ref"))
    tr = make_trainer(d, steps=3, pkg="ref")
    tr.run(2)
    saved = os.path.join(d, "ck2")
    shutil.copytree(os.path.join(d, "ck"), saved)
    tr.run(3)
    return saved, tr.metrics_history, tr._step_fn


def test_reference_checkpoint_resumes_in_the_port(tmp_path, ref_resumed):
    saved, ref_hist, _ = ref_resumed
    shutil.copytree(saved, tmp_path / "ck")
    tr = make_trainer(str(tmp_path), steps=3)
    assert tr.state.step == 2 and int(tr.state.opt_state["count"]) == 2
    hist = tr.run()
    assert [h["step"] for h in hist] == [3]
    for k in ("loss", "grad_norm", "lr"):
        rel(hist[0][k], ref_hist[2][k], k)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, ref_resumed):
    tr = make_trainer(str(tmp_path), steps=3)
    tr.run(2)
    rtr = make_trainer(str(tmp_path), steps=3, pkg="ref")
    assert rtr.state.step == 2 and int(rtr.state.opt_state["count"]) == 2
    rtr._step_fn = ref_resumed[2]                # same configs: no recompile
    tr.run(3)
    rtr.run()
    rel(rtr.metrics_history[-1]["loss"], tr.metrics_history[-1]["loss"],
        "step-3 loss")


def test_checkpoint_atomicity_skips_torn(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones(2, 2)}}
    ckpt.save(d, 1, tree)
    ckpt.save(d, 2, {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2}})
    os.remove(os.path.join(d, "step_00000002", "arrays.host0.npz"))
    with pytest.warns(RuntimeWarning, match="falling back to step 1"):
        got, step = ckpt.restore(d, tree)
    assert step == 1
    assert torch.equal(got["a"], torch.arange(4.0))


def test_checkpoint_keeps_dtypes_and_fills_a_target(tmp_path):
    """bfloat16 bits, int32 and float32 leaves in dicts and lists; a
    target's tensor leaves set dtype and device, numpy leaves the dtype,
    placeholders keep the stored dtype; the reference reads the float32
    and int32 leaves."""
    d = str(tmp_path / "ck")
    bf = torch.randn(3, 5).to(torch.bfloat16)
    tree = {"bf": bf, "n": [torch.arange(3, dtype=torch.int32),
                            np.float32([1.5, -2.0])]}
    ckpt.save(d, 7, tree)
    raw, step = ckpt.restore(d)
    assert step == 7 and torch.equal(raw["bf"], bf)
    assert raw["n/0"].dtype == np.int32
    target = {"bf": torch.empty(0, dtype=torch.bfloat16),
              "n": [torch.empty(0, dtype=torch.int64), object()]}
    got, _ = ckpt.restore(d, target, 7)
    assert got["bf"].dtype == torch.bfloat16 and torch.equal(got["bf"], bf)
    assert got["n"][0].dtype == torch.int64 and got["n"][0].tolist() == [
        0, 1, 2]
    assert got["n"][1].dtype == np.float32
    ckpt.save(str(tmp_path / "plain"), 1, {"n": tree["n"]})
    ref_got, _ = ref_ckpt.restore(str(tmp_path / "plain"),
                                  {"n": [np.zeros(0, np.int32),
                                         np.zeros(0, np.float32)]})
    np.testing.assert_array_equal(ref_got["n"][0], [0, 1, 2])
    np.testing.assert_array_equal(ref_got["n"][1], [1.5, -2.0])


# ------------------------------------------------------------------ launcher
def test_train_launcher_reduced(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen3-0.6b", "--reduced", "--steps", "3",
        "--seq-len", "16", "--global-batch", "2", "--device", "cpu"])
    train_launcher.main()
    assert "done: step 3" in capsys.readouterr().out


def test_train_launcher_refuses_multi_device_flags(monkeypatch, capsys):
    """The multi-device flags are ported (tests/test_torch_dist.py runs
    them); the launcher refuses the ones it cannot use: a coordinator that
    is neither host:port nor a URL, and a host id outside the hosts."""
    for flags, what in ((["--coordinator", "x"], "--coordinator"),
                        (["--coordinator", "h:1", "--num-hosts", "2",
                          "--host-id", "2"], "--host-id")):
        monkeypatch.setattr(sys, "argv", ["train", *flags, "--device",
                                          "cpu"])
        with pytest.raises(SystemExit) as e:
            train_launcher.main()
        assert e.value.code == 2
        assert what in capsys.readouterr().err


# ------------------------------------------------------------------ grads
def moe_cfgs(**kw):
    args = dict(name="t", family="moe", n_layers=2, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=32, vocab=64, n_experts=4, topk=2, **kw)
    return RefArchConfig(**args), ArchConfig(**args)


def grads_close(got: dict, want, what: str):
    for name, g in got.items():
        w = np.asarray(want[name]) if not isinstance(g, dict) else None
        if isinstance(g, dict):
            grads_close(g, want[name], f"{what}/{name}")
            continue
        assert torch.isfinite(g).all(), f"{what}/{name}"
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=RTOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=f"{what}/{name}")


def torch_grads(params: dict, loss_fn) -> dict:
    leaves = [x.requires_grad_() for x in tree_leaves(params)]
    gs = iter(torch.autograd.grad(loss_fn(params), leaves))
    return tree_map(lambda _: next(gs), params)


@pytest.mark.parametrize("groups,cap", [(1, 8.0), (2, 8.0), (1, 0.5)])
def test_moe_grads_match_reference(groups, cap):
    """tests/test_moe.py's grad cases (one group and grouped dispatch),
    and one with drops: the grad reaches the experts and the router
    through the gathers and the gate-weighted combine."""
    rcfg, cfg = moe_cfgs(moe_groups=groups, capacity_factor=cap)
    rp = ref_moe.init_moe(rcfg, jax.random.PRNGKey(7))
    x = np.random.default_rng(8).normal(size=(1, 8, 16)).astype(np.float32)

    def ref_loss(p):
        y, aux = ref_moe.moe_block(rcfg, p, jnp.asarray(x))
        return jnp.sum(y ** 2) + 0.01 * aux

    def pt_loss(p):
        y, aux = pt_moe.moe_block(cfg, p, t(x))
        return torch.sum(y ** 2) + 0.01 * aux

    want = jax.jit(jax.grad(ref_loss))(rp)
    got = torch_grads({k: t(v) for k, v in rp.items()}, pt_loss)
    grads_close(got, want, "moe")
    assert float(got["router"].abs().max()) > 0


def test_mamba_block_grads_match_reference():
    args = dict(name="t", family="ssm", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=4, d_ff=0, vocab=64, ssm_state=8, ssm_headdim=8,
                ssm_groups=1)
    rcfg, cfg = RefArchConfig(**args), ArchConfig(**args)
    rp = ref_ssm.init_mamba(rcfg, jax.random.PRNGKey(2))
    x = np.random.default_rng(3).normal(size=(1, 8, 32)).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(ref_ssm.mamba_block(
        rcfg, p, jnp.asarray(x), chunk=4) ** 2)))(rp)
    got = torch_grads({k: t(v) for k, v in rp.items()}, lambda p: torch.sum(
        pt_ssm.mamba_block(cfg, p, t(x), chunk=4) ** 2))
    grads_close(got, want, "mamba")


def test_ssd_grads_stay_finite_where_the_decay_overflows():
    """A chunk whose summed log decay passes 88 overflows exp in float32
    in the unused upper triangle; the select before the exp keeps the
    backward free of inf * 0."""
    rng = np.random.default_rng(4)
    x = t(rng.normal(size=(1, 8, 2, 4)).astype(np.float32)).requires_grad_()
    a_log = torch.full((1, 8, 2), -30.0, requires_grad=True)
    dt = torch.full((1, 8, 2), 0.5, requires_grad=True)
    B_, C_ = (t(rng.normal(size=(1, 8, 1, 4)).astype(np.float32))
              for _ in range(2))
    y, _ = pt_ssm.ssd_chunked(x, a_log, dt, B_, C_, 8)
    gs = torch.autograd.grad(y.sum(), (x, a_log, dt))
    assert all(torch.isfinite(g).all() for g in gs)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_one_train_grad_step_finite(arch):
    """tests/test_models_smoke.py's grad step on every family's reduced
    model: the loss and every grad finite, through remat and the chunked
    attention."""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    rng = np.random.default_rng(3)
    tokens = t(rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32))
    mem = None
    if cfg.family in ("vlm", "audio"):
        mem = t(rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32))

    def loss_fn(p):
        h, aux = T.forward(cfg, p, tokens, mem, remat=True,
                           compute_dtype=torch.float32, chunks=(8, 8))
        lg = T.logits_of(cfg, p, h)
        return -torch.log_softmax(lg, -1)[..., 0].mean() + 0.01 * aux

    grads = torch_grads(params, loss_fn)
    for g in tree_leaves(grads):
        assert torch.isfinite(g).all()
    assert any(float(g.abs().max()) > 0 for g in tree_leaves(grads))
