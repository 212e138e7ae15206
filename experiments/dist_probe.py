#!/usr/bin/env python3
"""Probe of torch.distributed on one CUDA card, for the port's multi-rank
paths: which collectives gloo takes on CUDA tensors when W ranks share the
card (NCCL refuses two ranks on one GPU), and whether a 2-D DeviceMesh,
DTensor placement and the port's sharded search and train step run there.

    python3 experiments/dist_probe.py [--out DIR]

Each rank logs every step to DIR/rank<r>.<world>.log as it goes (a hang
shows as the last line), and the result is one JSON line: per world (gloo
at 2 and 4 ranks, NCCL at 1), each collective "ok" with its seconds or its
error, then the mesh steps.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _collectives(dev, w, r, log) -> dict:
    out = {}

    def run(name, fn):
        log(f"op {name}")
        try:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[name] = ["ok", time.perf_counter() - t0]
        except Exception as e:  # noqa: BLE001 - the probe records it
            out[name] = ["fail", f"{type(e).__name__}: {str(e)[:300]}"]
    x = torch.full((8,), float(r + 1), device=dev)
    run("all_reduce", lambda: dist.all_reduce(x))
    run("broadcast", lambda: dist.broadcast(x, 0))
    run("all_gather", lambda: dist.all_gather(
        [torch.empty_like(x) for _ in range(w)], x))
    run("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        torch.empty(8 * w, device=dev), x))
    run("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        torch.empty(8, device=dev), torch.ones(8 * w, device=dev)))
    big = torch.ones(64 << 20, device=dev)             # 256 MB float32
    run("all_reduce_256MB", lambda: dist.all_reduce(big))
    run("all_gather_256MB", lambda: dist.all_gather(
        [torch.empty_like(big) for _ in range(w)], big))
    return out


def _mesh_steps(dev, w, r, log) -> dict:
    """The port's path on a (2, 2) mesh: DeviceMesh, distribute / gather,
    a sharded search, one sharded train step of reduced qwen3."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as SH
    from repro_torch.engine import sharded
    from repro_torch.launch.elastic import reshard_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig, init_state
    from repro_torch.train import make_sharded_train_step
    out = {}
    log("mesh")
    mesh = make_host_mesh((2, 2), ("data", "model"), "cuda")
    out["groups"] = [dist.get_backend(mesh.get_group(i)) for i in range(2)]
    log(f"mesh ok {out['groups']}")
    full = torch.arange(48, dtype=torch.float32).view(4, 12)
    dt = SH.distribute(full, SH.Sharding(mesh, ("data", "model")))
    log("distributed")
    out["gather_equal"] = bool(torch.equal(SH.gather(dt).cpu(), full))
    log("gathered")
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**31 - 2, 50_000).astype(np.int32)
    qs = np.concatenate([keys[:1024], rng.integers(0, 2**31 - 2, 1024)
                         .astype(np.int32)])
    idx = sharded.build(keys, mesh, leaf_width=128)
    log("built")
    got = sharded.search(idx, qs).cpu().numpy()
    out["search_equal"] = bool(np.array_equal(
        got, np.searchsorted(np.sort(keys), qs)))
    log("searched")
    cfg = get_config("qwen3-0.6b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_state(params)
    state = reshard_state({"params": T.to_reference_params(cfg, params),
                           "opt": T.to_reference_opt_state(cfg, opt)}, mesh,
                          T.to_reference_params(cfg, params, device="meta"))
    step = make_sharded_train_step(cfg, OptConfig(lr=1e-3), mesh,
                                   microbatches=2,
                                   compute_dtype=torch.float32)
    bsh = SH.batch_shardings(mesh)
    batch = {k: SH.distribute(torch.from_numpy(
        rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)), bsh[k])
        for k in ("tokens", "labels")}
    log("stepping")
    _, _, m = step(state["params"], state["opt"], batch)
    out["loss"] = float(m["loss"])
    log(f"stepped {out['loss']}")
    return out


def _rank(r, w, init, backend, logdir, q):
    path = os.path.join(logdir, f"rank{r}.{backend}{w}.log")

    def log(msg):
        with open(path, "a") as f:
            f.write(f"{time.time():.3f} {msg}\n")
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=init, world_size=w,
                                rank=r)
        log("init")
        dev = torch.device("cuda", 0)
        res = {"rank": r, "collectives": _collectives(dev, w, r, log)}
        if w == 4 or backend == "nccl":
            res["mesh"] = _mesh_steps(dev, w, r, log) if w == 4 else None
        q.put(res)
        dist.barrier()
        dist.destroy_process_group()
        log("done")
    except Exception:  # noqa: BLE001 - reported to the parent
        log(traceback.format_exc())
        q.put({"rank": r, "error": traceback.format_exc()[-2000:]})


def world(w: int, backend: str, logdir: str) -> dict:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        t0 = time.perf_counter()
        ps = [ctx.Process(target=_rank, args=(r, w, init, backend, logdir, q))
              for r in range(w)]
        for p in ps:
            p.start()
        res = []
        try:
            for _ in range(w):
                res.append(q.get(timeout=120))
        except Exception:  # noqa: BLE001 - a hang is a result here
            res.append({"error": "timed out"})
        for p in ps:
            p.join(30)
            if p.is_alive():
                p.kill()
        return {"backend": backend, "world": w,
                "wall_s": time.perf_counter() - t0,
                "ranks": sorted(res, key=lambda x: x.get("rank", -1))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dist_probe")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    from repro_torch.kernels import _build
    _build.build()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    out = {}
    for w, be in ((2, "gloo"), (4, "gloo"), (1, "nccl")):
        out[f"{be}{w}"] = world(w, be, args.out)
        print(json.dumps(out[f"{be}{w}"]), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
