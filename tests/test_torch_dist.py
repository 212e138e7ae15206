"""The port's multi-device layer against the reference's: the sharding
rules, int8 gradient compression, the key-space-sharded index, the
sharded train step, meshes, elastic resharding, restore under shardings
and the launcher's process group.

The rules are pure functions of the mesh's axis names and sizes, so they
are held leaf for leaf to the reference's, evaluated in this process on
``jax.sharding.AbstractMesh`` (the port's on ``MeshShape``), over the
stacked parameter layout, for reduced and full-width configs ("meta"
tensors: no memory). Compression is single-process (the stacked-device
form) and bit for bit. The multi-rank cases run in one world of 8 gloo
ranks on the CPU (``torch_dist_worlds.cpu_world``), spawned once for the
module and rendezvousing through a ``file://`` store under a temporary
directory; this process computes the reference's answers:

  * sharded ranks equal ``np.searchsorted`` and the reference's dense
    tiered search bit for bit (the reference test's keys and both
    bottoms, shards of padding, int32 extremes, float32 keys, a k-ary top);
  * one sharded step of reduced qwen3 at mesh (4, 2), microbatches 2,
    float32, labels holding -1: loss, grad norm and lr to 1e-5 relative,
    moments to 1e-5 of each leaf's largest, params to 1e-6 where |m| >
    1e-6 and within 2 lr everywhere (``test_torch_training.py``'s
    tolerances);
  * the same step of reduced mixtral at its capacity factor and at 0.5
    (where the capacity binds and pairs drop) and of a period-2 reduced
    jamba (a Mamba block with a MoE FFN, then an attention block), at the
    same tolerances: each MoE layer routes the whole global microbatch,
    as the reference's one SPMD program does;
  * resharding minicpm from 8 ranks to 4 keeps every value exactly.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro.ckpt import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.dist import compression as ref_comp
from repro.dist import sharding as ref_SH
from repro.engine import tiered as ref_tiered
from repro.models import transformer as ref_T
from repro.optim import adamw as ref_adamw
from repro.train import make_train_step as ref_make_train_step

from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import compression, sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.launch import train as train_launcher
from repro_torch.models import transformer as T

import torch_dist_worlds as W

torch.set_num_threads(1)

RTOL = 1e-5
LR = 1e-3
I32 = np.iinfo(np.int32)
# every model config; nitrogen-db is the index service's, with no model
# (the reference's init_params fails on its zero widths)
LM_ARCHS = [a for a in ARCH_IDS if a != "nitrogen-db"]
MESHES = {"4x2": ((4, 2), ("data", "model")), "8": ((8,), ("data",)),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model"))}


def meshes(name):
    shape, axes = MESHES[name]
    return SH.MeshShape(shape, axes), AbstractMesh(shape, axes)


def ref_specs(tree) -> dict:
    """{"a/b": PartitionSpec as a tuple} of a reference sharding tree."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_leaves_with_path(tree)}


def port_specs(tree) -> dict:
    return {k: s.spec for k, s in _flatten(tree).items()}


def placements_of(spec, axes) -> tuple:
    """The DTensor placements a reference spec means on a mesh of `axes`."""
    out = []
    for name in axes:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(f"S({dims[0]})" if dims else "R")
    return tuple(out)


def check_same(port_tree, ref_tree, axes):
    got, want = port_specs(port_tree), ref_specs(ref_tree)
    assert got == want
    for k, s in _flatten(port_tree).items():
        assert tuple(str(p) for p in s.placements) == \
            placements_of(want[k], axes), k


@pytest.fixture(scope="module")
def abstract_trees():
    """(reference abstract params, port "meta" params in the reference's
    layout) per (arch, reduced), made once."""
    out = {}

    def get(arch, reduced):
        if (arch, reduced) not in out:
            rc, pc = ref_get_config(arch), get_config(arch)
            if reduced:
                rc, pc = rc.reduced(), pc.reduced()
            ref = jax.eval_shape(lambda: ref_T.init_params(
                rc, jax.random.PRNGKey(0)))
            port = T.to_reference_params(
                pc, T.init_params(pc, None, "meta"), device="meta")
            out[(arch, reduced)] = (rc, pc, ref, port)
        return out[(arch, reduced)]
    return get


# ------------------------------------------------------------- placements
@pytest.mark.parametrize("arch,reduced", [
    ("qwen3-0.6b", True), ("minicpm-2b", True), ("jamba-v0.1-52b", True)]
    + [(a, False) for a in LM_ARCHS])
def test_param_and_opt_placements_match_reference(abstract_trees, arch,
                                                  reduced):
    _, _, ref, port = abstract_trees(arch, reduced)
    assert {k: tuple(v.shape) for k, v in _flatten(port).items()} == {
        "/".join(str(getattr(k, "key", k)) for k in p): tuple(x.shape)
        for p, x in jax.tree_util.tree_leaves_with_path(ref)}
    for name in MESHES:
        pm, am = meshes(name)
        psh, rsh = SH.params_shardings(pm, port), \
            ref_SH.params_shardings(am, ref)
        check_same(psh, rsh, pm.axis_names)
        opt = SH.opt_state_shardings(pm, None, psh)
        ropt = ref_SH.opt_state_shardings(am, None, rsh)
        check_same(opt, ropt, pm.axis_names)


@pytest.mark.parametrize("name", list(MESHES))
def test_batch_placements_match_reference(name):
    pm, am = meshes(name)
    for has_memory in (False, True):
        for batch in (None, 8, 6, 512, 3):
            got = SH.batch_shardings(pm, has_memory, batch)
            want = ref_SH.batch_shardings(am, has_memory, batch)
            check_same(got, want, pm.axis_names)


@pytest.mark.parametrize("arch,reduced", [
    ("qwen3-0.6b", True), ("minicpm-2b", True), ("jamba-v0.1-52b", True)]
    + [(a, False) for a in LM_ARCHS])
@pytest.mark.parametrize("kv_shard", ["hd", "heads"])
def test_cache_placements_match_reference(arch, reduced, kv_shard):
    """The port's cache stacks each state kind over its layers and the
    reference over repeats a pattern position; the rule reads dims 1 and
    the last two, so each reference leaf's spec is its kind's."""
    rc, pc = ref_get_config(arch), get_config(arch)
    if reduced:
        rc, pc = rc.reduced(), pc.reduced()
    mem = 16 if pc.family in ("vlm", "audio") else 0
    for B in (8, 6, 16):
        ref = jax.eval_shape(lambda: ref_T.init_cache(rc, B, 32,
                                                      memory_len=mem))
        port = T.init_cache(pc, B, 32, memory_len=mem, device="meta")
        for name in MESHES:
            pm, am = meshes(name)
            got = {k: s.spec for k, s in SH.cache_shardings(
                pm, port, B, kv_shard).items()}
            want = ref_specs(ref_SH.cache_shardings(am, ref, B, kv_shard))
            assert want.pop("lengths") == got.pop("lengths")
            for path, spec in want.items():
                assert got[path.split("/")[-1]] == spec, (path, name, B)


def test_activation_constraint_is_identity_on_plain_tensors():
    x = torch.randn(4, 3, 2)
    assert SH.constrain_activations(x) is x
    with SH.activation_sharding(meshes("4x2")[0], seq_axis="model"):
        assert SH.constrain_activations(x) is x
    assert SH.constrain_activations(x) is x


def test_activation_constraint_shards_a_dtensor_batch(world):
    """Inside the context a replicated [B, S, D] DTensor comes back with
    its batch over the data axis, values unchanged."""
    for res in world["res"]:
        placements, local, equal = res["train"]["activation"]
        assert placements == ("S(0)", "R") and local == (2, 2, 3) and equal


# ------------------------------------------------------------- compression
@pytest.mark.parametrize("shape", [(8, 64, 32), (8, 5), (8, 3, 7, 2),
                                   (6, 33), (3, 9)])
def test_compression_bit_for_bit(shape):
    rng = np.random.default_rng(sum(shape))
    g = {"g": rng.normal(size=shape).astype(np.float32),
         "h": (rng.normal(size=shape) * 1e3).astype(np.float32),
         "z": np.zeros(shape, np.float32)}
    pm, am = SH.MeshShape(shape[:1], ("data",)), \
        AbstractMesh(shape[:1], ("data",))
    f, rf = compression.make_compressed_allreduce(pm, "data"), \
        ref_comp.make_compressed_allreduce(am, "data")
    gt = {k: torch.from_numpy(v) for k, v in g.items()}
    err, rerr = compression.init_error_state(gt), \
        ref_comp.init_error_state({k: jnp.asarray(v) for k, v in g.items()})
    for _ in range(3):
        out, err = f(gt, err)
        rout, rerr = rf({k: jnp.asarray(v) for k, v in g.items()}, rerr)
        for k in g:
            np.testing.assert_array_equal(err[k].numpy(),
                                          np.asarray(rerr[k]))
            np.testing.assert_array_equal(out[k].numpy(),
                                          np.asarray(rout[k]))
            assert out[k].shape == shape


def test_compression_error_feedback():
    """The reference test's claims, on the port."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(8, 64, 32)).astype(np.float32))
    truth = g.numpy().mean(0)
    f = compression.make_compressed_allreduce(meshes("8")[0], "data")
    out1, err1 = f({"g": g}, compression.init_error_state({"g": g}))
    out2, _ = f({"g": g}, err1)
    rel1 = np.linalg.norm(out1["g"][0].numpy() - truth) / \
        np.linalg.norm(truth)
    comp = (out1["g"][0].numpy() + out2["g"][0].numpy()) / 2
    rel2 = np.linalg.norm(comp - truth) / np.linalg.norm(truth)
    assert rel1 < 0.02
    assert rel2 <= rel1 * 1.01
    assert np.abs(err1["g"].numpy()).max() > 0


# ------------------------------------------------------------- meshes
def test_production_mesh_requires_devices():
    with pytest.raises(RuntimeError, match="256"):
        M.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="512"):
        M.make_production_mesh(multi_pod=True, device_type="cpu")


def test_train_launcher_coordinator_world_1(tmp_path, monkeypatch, capsys):
    import sys
    store = "file://" + str(tmp_path / "store")
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen3-0.6b", "--reduced", "--steps", "2",
        "--seq-len", "16", "--global-batch", "2", "--device", "cpu",
        "--coordinator", store, "--num-hosts", "1", "--host-id", "0",
        "--mesh", "host:2x2"])
    train_launcher.main()
    assert "done: step 2" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------- the world
def search_cases():
    """(keys, [query batches], leaf_width) per case."""
    rng = np.random.default_rng(0)                   # the reference test's
    keys = rng.integers(0, 2**31 - 2, 50_000).astype(np.int32)
    qs = np.concatenate([keys[rng.integers(0, keys.size, 1024)],
                         rng.integers(0, 2**31 - 2, 1024).astype(np.int32)])
    cases = [(keys, [qs, qs[:64]], 128)]
    r = np.random.default_rng(1)
    pad = r.integers(-1000, 1000, 300).astype(np.int32)   # shards 3-7 empty
    cases.append((pad, [np.arange(-1100, 1100, 3, dtype=np.int32)], 128))
    ext = np.concatenate([[I32.min, I32.min + 1, I32.max - 1, I32.max - 2],
                          r.integers(I32.min, I32.max - 1, 5000)]
                         ).astype(np.int32)
    eq = np.concatenate([[I32.min, I32.min + 1, I32.max - 1, 0],
                         ext[:500], r.integers(I32.min, I32.max - 1, 1500)]
                        ).astype(np.int32)
    cases.append((ext, [eq, eq[:40]], 128))
    fk = (r.normal(size=20_000) * 1e4).astype(np.float32)
    fq = np.concatenate([fk[:1000], (r.normal(size=1048) * 1.2e4)
                         .astype(np.float32)])
    cases.append((fk, [fq, fq[:64]], 256))
    big = r.integers(0, 2**30, 8 * 300 * 128).astype(np.int32)  # k-ary tops
    bq = np.concatenate([big[:1 << 14], r.integers(0, 2**30, 1 << 14)
                         .astype(np.int32)])
    cases.append((big, [bq, bq[:512]], 128))
    return cases


SEARCH_IDS = ["reference_test", "padding_shards", "int32_extremes",
              "float32", "kary_top"]


def train_inputs():
    cfg = ref_get_config("qwen3-0.6b").reduced()
    params = jax.tree.map(np.asarray, ref_T.init_params(
        cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
    labels[1, 5:] = -1                  # microbatch 0: uneven counts
    labels[6, :] = -1                   # microbatch 1: a row of none
    labels[7, :9] = -1
    return cfg, params, {"tokens": tokens, "labels": labels}


# the MoE cases: (arch, overrides of the reduced config); jamba at the
# period of 2 of test_torch_training.py's ``hybrid`` fixture
MOE_CASES = {
    "mixtral": ("mixtral-8x7b", {}),
    "mixtral_capacity_0.5": ("mixtral-8x7b", {"capacity_factor": 0.5}),
    "jamba_period_2": ("jamba-v0.1-52b", dict(
        attn_every=2, attn_index=1, moe_every=2, moe_offset=0, n_layers=4)),
}


def moe_train_inputs():
    """{case: (reference cfg, port cfg, reference params, batch)}."""
    out = {}
    for i, (name, (arch, kw)) in enumerate(MOE_CASES.items()):
        rcfg = dataclasses.replace(ref_get_config(arch).reduced(), **kw)
        params = jax.tree.map(np.asarray, ref_T.init_params(
            rcfg, jax.random.PRNGKey(3 + i)))
        rng = np.random.default_rng(10 + i)
        batch = {k: rng.integers(0, rcfg.vocab, (8, 16)).astype(np.int32)
                 for k in ("tokens", "labels")}
        batch["labels"][2, 3:] = -1
        out[name] = (rcfg, dataclasses.replace(
            get_config(arch).reduced(), **kw), params, batch)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    cases = search_cases()
    rcfg, rparams, batch = train_inputs()
    moe = moe_train_inputs()
    mcfg = ref_get_config("minicpm-2b").reduced()
    mparams = jax.tree.map(np.asarray, ref_T.init_params(
        mcfg, jax.random.PRNGKey(1)))
    ckpt_dir = str(tmp / "ckpt")
    ref_ckpt.save(ckpt_dir, 3, {"params": mparams})
    res = W.run_world(
        W.cpu_world, 8, tmp, cases,
        (get_config("qwen3-0.6b").reduced(), rparams, batch, LR, 2, (4, 2)),
        (get_config("minicpm-2b").reduced(), mparams), ckpt_dir,
        [(pc, p, b, LR, 2, (4, 2)) for _, pc, p, b in moe.values()])
    return {"res": res, "cases": cases, "train": (rcfg, rparams, batch),
            "moe": moe, "minicpm": (mcfg, mparams)}


@pytest.mark.parametrize("case", range(len(SEARCH_IDS)), ids=SEARCH_IDS)
def test_sharded_search_matches_numpy_and_reference(world, case):
    keys, batches, lw = world["cases"][case]
    srt = np.sort(keys)
    dense = ref_tiered.build(keys)
    for q, ranks in zip(batches, world["res"][0]["search"][case]["ranks"]):
        np.testing.assert_array_equal(
            ranks, np.asarray(ref_tiered.search(dense, q)))
    for r, res in enumerate(world["res"]):
        got = res["search"][case]
        assert got["shards"] == 8 and got["n"] == keys.size
        for q, ranks in zip(batches, got["ranks"]):
            want = np.searchsorted(srt, q, side="left")
            assert ranks.dtype == np.int32
            np.testing.assert_array_equal(ranks, want, err_msg=f"rank {r}")


def test_sharded_index_holds_one_shard_a_rank(world):
    for (keys, _, lw), res in zip(world["cases"],
                                  world["res"][0]["search"]):
        shard = -(-max(-(-keys.size // 8), 1) // lw) * lw
        assert res["local_pages"] == (1, shard // lw, lw)


def test_sharded_train_step_matches_reference(world):
    rcfg, rparams, batch = world["train"]
    check_step_against_reference(
        rcfg, rparams, batch, [res["train"] for res in world["res"]])


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_sharded_moe_train_step_matches_reference(world, case):
    """A MoE model's sharded step is the reference's step: the router
    logits of each global microbatch are gathered over the data ranks, so
    the capacity, the drops and the aux loss are the whole microbatch's."""
    rcfg, _, rparams, batch = world["moe"][case]
    i = list(MOE_CASES).index(case)
    check_step_against_reference(
        rcfg, rparams, batch, [res["moe_train"][i] for res in world["res"]])


def check_step_against_reference(rcfg, rparams, batch, ranks):
    """One reference step (jit, microbatches 2, float32) against every
    rank's metrics and rank 0's whole updated state."""
    step = jax.jit(ref_make_train_step(
        rcfg, ref_adamw.OptConfig(lr=LR), microbatches=2,
        compute_dtype=jnp.float32))
    p2, o2, m = step(rparams, ref_adamw.init_state(rparams),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    for res in ranks:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(res[k], float(m[k]),
                                       rtol=RTOL, err_msg=k)
    got = ranks[0]["state"]
    assert int(got["count"]) == int(o2["count"]) == 1
    flat = {k: v.numpy() for k, v in _flatten(got["params"]).items()}
    mflat = {k: v.numpy() for k, v in _flatten(got["m"]).items()}
    vflat = {k: v.numpy() for k, v in _flatten(got["v"]).items()}
    for path, y in jax.tree_util.tree_leaves_with_path(p2):
        k = "/".join(str(p.key) for p in path)
        mom = np.asarray(_at(o2["m"], path))
        for name, mine, ref in (("m", mflat[k], mom),
                                ("v", vflat[k], np.asarray(_at(o2["v"],
                                                               path)))):
            np.testing.assert_allclose(mine, ref, rtol=0,
                                       atol=RTOL * np.abs(ref).max(),
                                       err_msg=f"{name} {k}")
        d = np.abs(flat[k] - np.asarray(y))
        assert d.max() <= 2 * LR, k
        assert d[np.abs(mom) > 1e-6].max(initial=0) <= 1e-6, k


def _at(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_sharded_train_step_shards_wq_over_8_ranks(world):
    """As the reference test: ``wq`` [R, D, H*hd] lies over data x model,
    every rank a different block, with the model axis among its
    placements; every leaf's local shape follows its placements."""
    rcfg, rparams, _ = world["train"]
    coords = set()
    for res in world["res"]:
        shape, placements = res["train"]["local"]["blocks"]["p0"]["attn"][
            "wq"]
        full = rparams["blocks"]["p0"]["attn"]["wq"].shape
        assert placements == ("S(1)", "S(2)")
        assert shape == (full[0], full[1] // 4, full[2] // 2)
        coords.add(tuple(res["train"]["coord"]))
        for k, (shape, placements) in _flatten_pairs(
                res["train"]["local"]).items():
            want = list(_leaf(rparams, k).shape)
            for size, p in zip((4, 2), placements):
                if p != "R":
                    want[int(p[2:-1])] //= size
            assert shape == tuple(want), k
    assert len(coords) == 8


def _flatten_pairs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten_pairs(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _leaf(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_elastic_reshard_8_to_4_ranks(world):
    mcfg, mparams = world["minicpm"]
    holders = [r["elastic"]["holds_embed"] for r in world["res"]]
    assert sum(holders) <= 4 and holders[:4] == [True] * 4
    for r in world["res"][:4]:
        e = r["elastic"]
        assert e["on_mesh4"] and e["mesh4"] == {"data": 2, "model": 2}
        for k, v in _flatten(e["resharded"]).items():
            np.testing.assert_array_equal(v.numpy(), _leaf(mparams, k))
    ab = jax.eval_shape(lambda: ref_T.init_params(mcfg,
                                                  jax.random.PRNGKey(1)))
    want = ref_specs(ref_SH.params_shardings(
        AbstractMesh((2, 2), ("data", "model")), ab))
    assert _flatten_pairs(world["res"][0]["elastic"]["specs4"]) == want
    assert all(not r["elastic"]["on_mesh4"] for r in world["res"][4:])


def test_restore_with_shardings_from_reference_checkpoint(world):
    for r in world["res"][:4]:
        e = r["elastic"]
        assert e["step"] == 3 and e["restored_local_equal"]
        assert e["restored_placements"]["blocks"]["p0"]["attn"]["wq"] == \
            ("S(1)", "S(2)")
        assert e["restored_placements"]["final_norm"] == ("R", "R")


def test_production_mesh_refused_in_a_world_of_8(world):
    for r in world["res"]:
        assert "need 256 devices" in r["elastic"]["production"]
