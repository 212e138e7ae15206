"""The port's dry run and perf_iter against the reference's.

  * the twin of ``tests/test_launchers.py::test_dryrun_cli_single_small_
    cell``: ``python -m repro_torch.launch.dryrun`` on whisper-small x
    decode_32k x single in a subprocess writes a record with a dominant
    term and counted FLOPs > 0; its per-device param bytes equal those of
    the reference's ``params_shardings`` on ``AbstractMesh((16, 16))``
    over ``jax.eval_shape`` (bf16, as the reference lowers decode);
  * a train cell of reduced qwen3 and mixtral (``get_config`` patched to
    ``.reduced()``) in-process: param bytes against the reference's
    shardings (float32), the even split of the counted pass, the FSDP and
    the port's own collective bytes;
  * ``perf_iter`` appends one record under ``tmp_path``;
  * ``parse_kv`` agrees with the reference's, which runs in a subprocess:
    ``repro.launch.dryrun`` and ``repro.launch.perf_iter`` set XLA_FLAGS
    to 512 host devices at import, so this process never imports them.
"""
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref_SH
from repro.models import transformer as ref_T

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, perf_iter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ref_param_bytes(rcfg, dtype, mesh_shape=(16, 16)) -> int:
    """Per-device bytes of the reference's params under its rules."""
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    ap = jax.eval_shape(lambda: ref_T.init_params(rcfg,
                                                  jax.random.PRNGKey(0)))
    ap = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        x.shape, dtype if x.dtype == jnp.float32 else x.dtype), ap)
    sh = ref_SH.params_shardings(mesh, ap)
    return int(sum(
        np.prod(NamedSharding(mesh, s.spec).shard_shape(x.shape))
        * x.dtype.itemsize
        for x, s in zip(jax.tree.leaves(ap), jax.tree.leaves(sh))))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return env


def test_dryrun_cli_single_small_cell(tmp_path):
    out_file = tmp_path / "d.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-small", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out_file)], capture_output=True, text=True,
        env=_env(), cwd=ROOT, timeout=300, check=True).stdout
    assert "ok count=" in out
    rec = json.loads(out_file.read_text().splitlines()[0])
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["hlo"]["flops_per_chip"] > 0
    assert rec["device"] == "meta" and rec["chips"] == 256
    assert rec["memory"]["param_bytes_per_device"] == ref_param_bytes(
        ref_get_config("whisper-small"), jnp.bfloat16)
    assert rec["memory"]["argument_bytes"] > \
        rec["memory"]["param_bytes_per_device"]          # + the cache
    p = rec["pass"]
    assert p["rows"] == 128 // 16 and p["passes_in_cell"] == 16
    assert rec["hlo"]["flops_per_chip"] == p["flops"] * 16 / 256
    assert rec["hlo"]["collectives"]["all-gather"] > 0
    assert rec["port_schedule"] is None


def test_dryrun_train_cell_reduced(monkeypatch):
    """Train cells of reduced configs: one microbatch's forward and
    backward at a data rank's rows, counted, times data ranks x
    microbatches, plus the update; the rules' FSDP bytes below the port's
    whole-param schedule."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    monkeypatch.setitem(dryrun.SHAPES, "train_4k", dict(
        seq_len=64, global_batch=64, kind="train"))
    for arch, v in (("qwen3-0.6b", None),
                    ("mixtral-8x7b", {"microbatches": 2,
                                      "cast_params_once": True})):
        rec = dryrun.lower_cell(arch, "train_4k", False, v)
        assert rec["memory"]["param_bytes_per_device"] == ref_param_bytes(
            ref_get_config(arch).reduced(), jnp.float32), arch
        p, h = rec["pass"], rec["hlo"]
        mb = rec["microbatches"]
        assert mb == (v or {}).get("microbatches", 1)
        assert p["rows"] == 64 // 16 // mb and p["passes_in_cell"] == 16 * mb
        assert h["flops_per_chip"] == p["flops"] * 16 * mb / 256
        assert h["bytes_per_chip"] == (p["bytes"] * 16 * mb
                                       + p["update_bytes"]) / 256
        assert rec["memory"]["temp_bytes"] == p["peak_live_bytes"] > 0
        assert set(h["collectives"]) >= {"all-gather", "reduce-scatter"}
        assert rec["port_schedule"]["total"] > h["collective_bytes_per_chip"]
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")


def test_perf_iter_appends_one_record(tmp_path, capsys):
    out = tmp_path / "iters" / "p.jsonl"
    argv = ["--arch", "whisper-small", "--shape", "decode_32k", "--name",
            "heads", "--set", "kv_shard=heads", "--out", str(out)]
    perf_iter.main(argv)
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(recs) == 1
    assert recs[0]["variant_name"] == "heads"
    assert recs[0]["variant"] == {"kv_shard": "heads"}
    assert "heads: dom=" in capsys.readouterr().out


def test_parse_kv_matches_reference():
    pairs = ["ssd_chunk=128", "seq_axis=model", "cast_params_once=true",
             "remat=false", "attn_chunks=512,1024", "kv_shard=heads",
             "microbatches=4"]
    ref = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; from repro.launch.perf_iter import parse_kv; "
         "print(json.dumps(parse_kv(sys.argv[1:])))", *pairs],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=120,
        check=True).stdout
    assert json.loads(json.dumps(perf_iter.parse_kv(pairs))) == \
        json.loads(ref)
    assert perf_iter.parse_kv(["attn_chunks=512,1024"]) == {
        "attn_chunks": (512, 1024)}
