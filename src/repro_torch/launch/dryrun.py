"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device
(PyTorch port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell on 512 forced host devices and
reads XLA's memory analysis and HLO. Neither exists in torch, and no
process group of 256 ranks is needed: the port builds the params, the
AdamW state, the inputs and, for decode, the cache as ``meta`` tensors
(shapes, no memory), places them under the sharding rules on a
``MeshShape`` of (16, 16) or (2, 16, 16) with the reference's axis names,
and counts one pass of the cell's function op by op
(``roofline.analysis.count_ops``). A record keeps the reference's keys;
``key_meanings`` says what each key means here where that differs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-small \\
        --shape decode_32k --mesh single --out experiments/dryrun_torch.jsonl

What a record gives, per device of the cell's mesh:
  * ``memory.argument_bytes``: the blocks of the params (and AdamW state,
    inputs, cache) that the rules place on one device;
  * ``memory.temp_bytes``: the peak of live storage in one pass at a data
    rank's rows (for training one microbatch's forward and backward), the
    arguments not counted;
  * ``hlo.flops_per_chip`` / ``bytes_per_chip``: that pass's counted
    FLOPs and bytes, times the passes of the cell (data ranks, and
    microbatches when training), plus the AdamW update, split evenly over
    the chips;
  * ``hlo.collective_bytes_per_chip``: the FSDP schedule the rules imply,
    at ring volumes (n - 1) / n: each parameter block all-gathered over
    the data axes once a microbatch (once a step with
    ``cast_params_once``), the grads reduce-scattered once a step;
    ``port_schedule`` the bytes of the port's sharded train step today,
    which gathers whole params and all-reduces whole grads;
  * ``roofline``: the three terms at the H100's constants.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..core.util import tree_leaves, tree_map
from ..dist import sharding as SH
from ..models import transformer as T
from ..optim import adamw
from ..roofline import analysis as RA
from ..train.train_step import make_loss_fn

LM_ARCHS = tuple(a for a in ARCH_IDS if a != "nitrogen-db")
FITS_BYTES = 80 * 2**30          # the H100's 80 GB, as "fits_80GB" reads it

KEY_MEANINGS = {
    "compile_s": "host seconds of the counted pass on the meta device "
                 "(nothing is compiled)",
    "memory.argument_bytes": "per-device blocks of the arguments under "
                             "the sharding rules",
    "memory.output_bytes": "0: the step updates its arguments in place "
                           "(train) or returns what the pass counted",
    "memory.temp_bytes": "peak live storage of one pass at a data rank's "
                         "rows (one microbatch when training)",
    "memory.alias_bytes": "0 (no donation to subtract)",
    "cost_analysis": "the counted FLOPs and bytes of the whole cell (no "
                     "XLA cost analysis exists)",
    "hlo": "counted aten ops, not HLO: flops_per_chip and bytes_per_chip "
           "are the whole cell's split evenly over the chips; "
           "collective_bytes_per_chip comes from the placements (FSDP "
           "schedule); while_loops is empty",
}


def _microbatches(cfg, rows_per_dp: int) -> int:
    """Grad-accum split: big models go to 1 row per DP shard per microbatch."""
    if cfg.d_model >= 8192:
        return max(rows_per_dp, 1)
    if cfg.d_model >= 4096:
        return max(rows_per_dp // 4, 1)
    return 1


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape_name: str):
    """``meta`` stand-ins for every model input of this cell."""
    sh = SHAPES[shape_name]
    S, B = sh["seq_len"], sh["global_batch"]
    specs = {}
    if sh["kind"] in ("train", "prefill"):
        specs["tokens"] = _meta((B, S), torch.int32)
        if sh["kind"] == "train":
            specs["labels"] = _meta((B, S), torch.int32)
        if cfg.family in ("vlm", "audio"):
            specs["memory"] = _meta((B, cfg.encoder_seq, cfg.d_model))
    else:  # decode
        specs["token"] = _meta((B,), torch.int32)
    return specs


def local_bytes(x, sharding: SH.Sharding) -> int:
    """Bytes of the block of ``x`` that one device holds under
    ``sharding``."""
    n = x.numel()
    for size, e in zip(x.shape, sharding.spec):
        if e is not None:
            n = n // size * (size // SH._axis_size(sharding.mesh, e))
    return n * x.element_size()


def tree_local_bytes(tree, shardings) -> int:
    return int(sum(local_bytes(x, s) for x, s in zip(
        tree_leaves(tree), tree_leaves(shardings))))


def _dp_extent(mesh, spec) -> int:
    """Devices a leaf's block is split over along the data axes."""
    dp = set(SH.dp_axes(mesh))
    n = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            if a in dp:
                n *= SH.axis_sizes(mesh)[a]
    return n


def fsdp_collectives(mesh, params, psh, *, gathers: int, gather_bytes: int,
                     grad_bytes: int = 0) -> dict:
    """Ring bytes a device of the rules' FSDP schedule: each leaf's block
    all-gathered over the data axes ``gathers`` times at ``gather_bytes``
    an element, and, where ``grad_bytes`` (bytes an element of a grad) >
    0, its grad reduce-scattered over them (all-reduced where the leaf is
    not split over the data axes) once."""
    n_dp = int(np.prod([SH.axis_sizes(mesh)[a] for a in SH.dp_axes(mesh)]))
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    for x, s in zip(tree_leaves(params), tree_leaves(psh)):
        k = _dp_extent(mesh, s.spec)
        # elements of the leaf's model-axis block, which the gather rebuilds
        gathered = local_bytes(x, s) // x.element_size() * k
        if k > 1:
            out["all-gather"] += gathers * (k - 1) / k * gathered \
                * gather_bytes
        if grad_bytes:
            g = gathered * grad_bytes
            if k > 1:
                out["reduce-scatter"] += (k - 1) / k * g
            elif n_dp > 1:
                out["all-reduce"] += 2 * (n_dp - 1) / n_dp * g
    return {k: v for k, v in out.items() if v}


def port_schedule_collectives(mesh, params, psh, cfg, *, tokens: int,
                              microbatches: int, remat) -> dict:
    """Ring bytes a device of ``train.make_sharded_train_step`` today: the
    whole params gathered over every mesh dim once a step, the whole
    float32 grads all-reduced over the data axes, and a MoE layer's
    router logits ([tokens of a microbatch, experts] float32) all-gathered
    in its forward (again in the recompute under remat) and all-reduced in
    its backward."""
    sizes = SH.axis_sizes(mesh)
    n_dp = int(np.prod([sizes[a] for a in SH.dp_axes(mesh)]))
    gather = reduce = 0.0
    for x, s in zip(tree_leaves(params), tree_leaves(psh)):
        whole = x.numel() * x.element_size()
        k = whole // max(local_bytes(x, s), 1)
        gather += (k - 1) / k * whole
        reduce += 2 * (n_dp - 1) / n_dp * x.numel() * 4
    moe_layers = sum(1 for i in range(cfg.n_layers)
                     if cfg.layer_spec(i % cfg.period)["ffn"] == "moe")
    if moe_layers and n_dp > 1:
        logits = tokens // microbatches * cfg.n_experts * 4
        per = (n_dp - 1) / n_dp * logits
        gather += moe_layers * microbatches * per * (2 if remat else 1)
        reduce += moe_layers * microbatches * 2 * per
    return {"all-gather": gather, "all-reduce": reduce,
            "total": gather + reduce}


def _production_mesh(multi_pod: bool) -> SH.MeshShape:
    if multi_pod:
        return SH.MeshShape((2, 16, 16), ("pod", "data", "model"))
    return SH.MeshShape((16, 16), ("data", "model"))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: dict | None = None):
    """variant (perf-iteration knobs, as the reference's): seq_axis,
    ssd_chunk, moe_groups, cast_params_once, kv_shard, attn_chunks,
    ce_chunk, microbatches, remat."""
    v = variant or {}
    cfg = get_config(arch)
    if "ssd_chunk" in v:
        cfg = dataclasses.replace(cfg, ssd_chunk=v["ssd_chunk"])
    if "moe_groups" in v:
        cfg = dataclasses.replace(cfg, moe_groups=v["moe_groups"])
    sh = SHAPES[shape_name]
    S, B, kind = sh["seq_len"], sh["global_batch"], sh["kind"]
    mesh = _production_mesh(multi_pod)
    chips = 512 if multi_pod else 256
    dp_size = 32 if multi_pod else 16
    rows = B // dp_size if B % dp_size == 0 else B      # a data rank's
    port = T.init_params(cfg, None, "meta")
    stacked = T.to_reference_params(cfg, port, device="meta")
    specs = input_specs(cfg, shape_name)
    bsh = SH.batch_shardings(mesh, has_memory="memory" in specs, batch=B)
    meta = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
            "seq_len": S, "global_batch": B, "kind": kind,
            "variant": v or "baseline", "device": "meta",
            "key_meanings": KEY_MEANINGS}
    if "seq_axis" in v:
        meta["seq_axis_note"] = (
            "activation_sharding pins DTensor activations only; the "
            "counted pass runs plain tensors, so its counts do not move")
    cast_once = bool(v.get("cast_params_once", False))
    remat = v.get("remat", True)

    t0 = time.time()
    with SH.activation_sharding(mesh, seq_axis=v.get("seq_axis")):
        if kind == "train":
            psh = SH.params_shardings(mesh, stacked)
            mb = v.get("microbatches", _microbatches(cfg, rows))
            meta["microbatches"] = mb
            param_bytes = tree_local_bytes(stacked, psh)
            args = param_bytes * 3 + 4           # params, m, v, count
            pass_rows = max(rows // mb, 1)
            stats, update = _train_pass(cfg, port, specs, pass_rows, v,
                                        cast_once, remat)
            total_passes = dp_size * mb
            coll = fsdp_collectives(mesh, stacked, psh,
                                    gathers=1 if cast_once else mb,
                                    gather_bytes=2 if cast_once else 4,
                                    grad_bytes=4)
            meta["port_schedule"] = port_schedule_collectives(
                mesh, stacked, psh, cfg, tokens=B * S, microbatches=mb,
                remat=remat)
        else:
            p16 = tree_map(lambda t: _meta(t.shape, torch.bfloat16)
                           if t.dtype == torch.float32 else t, stacked)
            psh = SH.params_shardings(mesh, p16)
            param_bytes = args = tree_local_bytes(p16, psh)
            pass_rows = rows
            port16 = tree_map(lambda t: _meta(t.shape, torch.bfloat16)
                              if t.dtype == torch.float32 else t, port)
            if kind == "prefill":
                stats = _prefill_pass(cfg, port16, specs, rows)
                meta["attn_chunks_note"] = (
                    "the port's prefill attends unchunked "
                    "(masked_attention); attn_chunks acts on training only")
            else:
                cache = T.init_cache(cfg, B, S, torch.bfloat16,
                                     memory_len=cfg.encoder_seq,
                                     device="meta")
                csh = SH.cache_shardings(mesh, cache, B,
                                         kv_shard=v.get("kv_shard", "hd"))
                tok_sh = SH.Sharding(mesh, (SH._maybe(
                    mesh, SH.dp_axes(mesh), B),))
                args += tree_local_bytes(cache, csh) + local_bytes(
                    specs["token"], tok_sh)
                stats = _decode_pass(cfg, port16, S, rows)
            update = RA.OpStats()
            total_passes = dp_size if rows < B else 1
            coll = fsdp_collectives(mesh, p16, psh, gathers=1,
                                    gather_bytes=2)
            meta["port_schedule"] = None
            meta["port_schedule_note"] = (
                "the port serves a model on one card: no sharded schedule")
    meta["compile_s"] = round(time.time() - t0, 1)
    args += sum(local_bytes(x, bsh[k]) for k, x in specs.items() if k in bsh)
    meta["pass"] = {"rows": pass_rows, "ops": stats.ops,
                    "flops": stats.flops, "bytes": stats.bytes_hbm,
                    "peak_live_bytes": stats.peak_live_bytes,
                    "passes_in_cell": total_passes,
                    "update_flops": update.flops,
                    "update_bytes": update.bytes_hbm}

    meta["memory"] = {
        "argument_bytes": int(args), "output_bytes": 0,
        "temp_bytes": int(stats.peak_live_bytes), "code_bytes": 0,
        "alias_bytes": 0, "param_bytes_per_device": int(param_bytes)}
    peak = meta["memory"]["argument_bytes"] + meta["memory"]["temp_bytes"]
    meta["memory"]["peak_bytes_per_device"] = peak
    meta["memory"]["fits_80GB"] = bool(peak < FITS_BYTES)
    flops = stats.flops * total_passes + update.flops
    nbytes = stats.bytes_hbm * total_passes + update.bytes_hbm
    meta["cost_analysis"] = {"flops": flops, "bytes_accessed": nbytes}
    per_chip = RA.OpStats(flops=flops / chips, bytes_hbm=nbytes / chips,
                          collective_bytes=float(sum(coll.values())),
                          dots=stats.dots)
    mf = RA.model_flops(cfg, kind, S, B)
    roof = RA.roofline_terms(per_chip, model_flops_total=mf, chips=chips)
    meta["hlo"] = {
        "flops_per_chip": per_chip.flops,
        "bytes_per_chip": per_chip.bytes_hbm,
        "collective_bytes_per_chip": per_chip.collective_bytes,
        "collectives": coll,
        "while_loops": {},
        "n_dots": stats.dots,
    }
    meta["roofline"] = roof.to_dict()
    return meta


def _train_pass(cfg, port, specs, rows, v, cast_once, remat):
    """One microbatch's forward and backward at ``rows`` rows, counted;
    and the AdamW update of the whole params, counted once (a step runs
    it once whatever its microbatches)."""
    dt = torch.bfloat16
    work = tree_map(lambda t: _meta(t.shape, dt) if cast_once
                    and t.dtype == torch.float32 else _meta(t.shape, t.dtype),
                    port)
    leaves = [t.requires_grad_() for t in tree_leaves(work)]
    loss_fn = make_loss_fn(cfg, compute_dtype=dt, remat=remat,
                           ce_chunk=v.get("ce_chunk", 1024),
                           attn_chunks=tuple(v.get("attn_chunks",
                                                   (512, 1024))))
    tokens = specs["tokens"][:rows]
    memory = specs["memory"][:rows] if "memory" in specs else None

    def fwd_bwd():
        loss, _ = loss_fn(work, tokens, specs["labels"][:rows], memory)
        return torch.autograd.grad(loss, leaves, allow_unused=True)
    _, stats = RA.count_ops(fwd_bwd)
    grads = tree_map(lambda t: _meta(t.shape), port)
    _, update = RA.count_ops(lambda: adamw.apply_updates(
        adamw.OptConfig(), tree_map(lambda t: _meta(t.shape, t.dtype), port),
        grads, adamw.init_state(tree_map(lambda t: _meta(t.shape, t.dtype),
                                         port))))
    return stats, update


def _prefill_pass(cfg, port16, specs, rows):
    memory = specs["memory"][:rows] if "memory" in specs else None
    with torch.no_grad():
        _, stats = RA.count_ops(T.prefill, cfg, port16,
                                specs["tokens"][:rows], memory,
                                compute_dtype=torch.bfloat16)
    return stats


def _decode_pass(cfg, port16, S, rows):
    cache = T.init_cache(cfg, rows, S, torch.bfloat16,
                         memory_len=cfg.encoder_seq, device="meta")
    with torch.no_grad():
        _, stats = RA.count_ops(T.decode_step, cfg, port16,
                                _meta((rows,), torch.int32), cache,
                                compute_dtype=torch.bfloat16)
    return stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="comma list or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="experiments/dryrun.jsonl")
    args = ap.parse_args()
    archs = LM_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except (ValueError, KeyError):
                    pass
    with open(args.out, "a") as f:
        for mesh_kind in meshes:
            multi = mesh_kind == "multi"
            mname = "2x16x16" if multi else "16x16"
            for arch in archs:
                cfg = get_config(arch)
                for shape in shapes:
                    if (arch, shape, mname) in done:
                        continue
                    ok, why = shape_applicable(cfg, shape)
                    if not ok:
                        rec = {"arch": arch, "shape": shape, "mesh": mname,
                               "skipped": why}
                        f.write(json.dumps(rec) + "\n")
                        f.flush()
                        print(f"[skip] {arch} x {shape} x {mname}: {why}")
                        continue
                    print(f"[cell] {arch} x {shape} x {mname} ...", flush=True)
                    try:
                        rec = lower_cell(arch, shape, multi)
                        r = rec["roofline"]
                        print(f"  ok count={rec['compile_s']}s "
                              f"dom={r['dominant']} "
                              f"c={r['compute_s']*1e3:.1f}ms "
                              f"m={r['memory_s']*1e3:.1f}ms "
                              f"x={r['collective_s']*1e3:.1f}ms", flush=True)
                    except Exception as e:   # a failing cell is a record
                        rec = {"arch": arch, "shape": shape, "mesh": mname,
                               "error": f"{type(e).__name__}: {e}",
                               "trace": traceback.format_exc()[-2000:]}
                        print(f"  FAIL {type(e).__name__}: {e}", flush=True)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()


if __name__ == "__main__":
    main()
