"""Rank workers of the port's multi-rank tests, and the launcher that
spawns them. Spawned ranks import this module by name, so it imports no
JAX and nothing of the reference: the parent test computes the
reference's answers and holds the ranks' results to them.

``run_world(fn, world, tmp, *args)`` starts ``world`` processes that meet
through a ``file://`` store under ``tmp`` (no fixed TCP port: the suite
runs several workers at once), each calling ``fn(rank, *args)`` inside the
default process group; it returns their results in rank order and raises
with the first failing rank's traceback.
"""
from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_world(fn, world: int, tmp, *args, backend: str = "gloo",
              timeout: float = 240.0) -> list:
    ctx = mp.get_context("spawn")
    tmp = str(tmp)
    init = "file://" + os.path.join(tmp, "store")
    # the arguments travel in a file: a spawned child reads its pipe only
    # after importing the parent's main module, so a large pickle there
    # would start the ranks one after another
    torch.save((fn, args), os.path.join(tmp, "args.pt"))
    procs = [ctx.Process(target=_rank, args=(r, world, init, backend, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pt")
        res = torch.load(path, weights_only=False) if os.path.exists(path) \
            else {"error": f"no result (exit code {procs[r].exitcode})"}
        out.append(res)
    for r, res in enumerate(out):
        if isinstance(res, dict) and "error" in res:
            raise RuntimeError(f"rank {r} of {world}:\n{res['error']}")
    return out


def _rank(rank, world, init, backend, tmp):
    torch.set_num_threads(1)
    try:
        fn, args = torch.load(os.path.join(tmp, "args.pt"),
                              weights_only=False)
        if torch.cuda.is_available():
            torch.cuda.set_device(0)          # every rank on the one card
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank)
        res = fn(rank, *args)
    except BaseException:
        res = {"error": traceback.format_exc()}
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    if dist.is_initialized() and "error" not in (res or {}):
        dist.destroy_process_group()


# ------------------------------------------------------------- the CPU world
def _tensors(tree):
    """numpy leaves of nested dicts -> CPU tensors."""
    return _map(lambda a: torch.from_numpy(np.array(a)), tree)


def search_cases(rank, cases, device_type="cpu"):
    """Each case (keys, [query batches], leaf_width) on a mesh of every
    rank: the ranks of each batch, the local pages' shape, the shard
    count."""
    from repro_torch.engine import sharded
    from repro_torch.launch.mesh import make_host_mesh
    world = dist.get_world_size()
    mesh = make_host_mesh((world,), ("data",), device_type)
    out = []
    for keys, batches, lw in cases:
        idx = sharded.build(keys, mesh, leaf_width=lw)
        out.append({
            "ranks": [sharded.search(idx, q).cpu().numpy() for q in batches],
            "local_pages": tuple(idx.pages.to_local().shape),
            "shards": idx.num_shards, "n": idx.n})
    return out


def train_case(rank, cfg, ref_params, batch, lr, microbatches, mesh_shape,
               device_type="cpu"):
    """One sharded train step of ``cfg`` from the reference's params (its
    stacked layout, numpy) on ``batch`` over a mesh of ``mesh_shape``:
    loss, grad norm, lr, the whole updated params and moments (host
    copies), and each leaf's local shape and placements."""
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.elastic import reshard_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import make_sharded_train_step
    mesh = make_host_mesh(mesh_shape, ("data", "model"), device_type)
    params = _tensors(ref_params)
    state = reshard_state({"params": params, "opt": {
        "m": _zeros(params), "v": _zeros(params),
        "count": torch.zeros((), dtype=torch.int32)}}, mesh,
        _meta(params))
    step = make_sharded_train_step(
        cfg, OptConfig(lr=lr), mesh, microbatches=microbatches,
        compute_dtype=torch.float32)
    bsh = SH.batch_shardings(mesh)
    b = {k: SH.distribute(torch.from_numpy(v), bsh[k])
         for k, v in batch.items()}
    p2, o2, m = step(state["params"], state["opt"], b)
    act = SH.distribute(torch.arange(48.0).view(8, 2, 3),
                        SH.Sharding(mesh, ()))
    with SH.activation_sharding(mesh):
        pinned = SH.constrain_activations(act)
    host = {"params": _map(SH.host_copy, p2),
            "m": _map(SH.host_copy, o2["m"]),
            "v": _map(SH.host_copy, o2["v"]),
            "count": SH.host_copy(o2["count"])}
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]), "state": host if rank == 0 else None,
            "coord": mesh.get_coordinate(),
            "activation": (tuple(str(p) for p in pinned.placements),
                           tuple(pinned.to_local().shape),
                           bool(torch.equal(SH.gather(pinned).cpu(),
                                            torch.arange(48.0)
                                            .view(8, 2, 3)))),
            "local": _map(lambda d: (tuple(d.to_local().shape),
                                     tuple(str(p) for p in d.placements)),
                          p2)}


def elastic_case(rank, cfg, ref_params, ckpt_dir):
    """Reshard a (4, 2) state of ``cfg`` onto ``choose_mesh(4,
    prefer_model=2)`` from host copies, and restore the reference's
    checkpoint in ``ckpt_dir`` under the (2, 2) rules: whole values where
    the rank is on the new mesh, and which ranks hold a block."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.elastic import choose_mesh, reshard_state
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    mesh8 = make_host_mesh((4, 2), ("data", "model"), "cpu")
    params = _tensors(ref_params)
    psh8 = SH.params_shardings(mesh8, params)
    params8 = _map2(SH.distribute, params, psh8)
    state = {"params": params8, "opt": {
        "m": _map2(SH.distribute, _zeros(params), psh8),
        "v": _map2(SH.distribute, _zeros(params), psh8),
        "count": SH.distribute(torch.zeros((), dtype=torch.int32),
                               SH.Sharding(mesh8, ()))}}
    mesh4 = choose_mesh(4, prefer_model=2, device_type="cpu")
    state4 = reshard_state(state, mesh4, _meta(params))
    target = {"params": _map(lambda t: torch.empty(0, dtype=t.dtype),
                             params)}
    psh4 = SH.params_shardings(mesh4, _meta(params))
    restored, step = ckpt.restore(ckpt_dir, target,
                                  shardings={"params": psh4})
    on4 = mesh4.get_coordinate() is not None
    res = {"on_mesh4": on4, "mesh4": SH.axis_sizes(mesh4),
           "holds_embed": state4["params"]["embed"].to_local().numel() > 0,
           "specs4": _map(lambda s: s.spec, psh4), "step": step}
    try:
        make_production_mesh(device_type="cpu")
        res["production"] = "built"
    except RuntimeError as e:
        res["production"] = str(e)
    if on4:
        res["resharded"] = _map(SH.host_copy, state4["params"])
        res["restored_local_equal"] = all(_leaves(_map2(
            lambda d, full: bool(torch.equal(d.to_local(), SH.local_slice(
                full, mesh4, d.placements, mesh4.get_coordinate()))),
            restored["params"], params)))
        res["restored_placements"] = _map(
            lambda d: tuple(str(p) for p in d.placements),
            restored["params"])
    return res


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _zeros(tree):
    return _map(lambda t: torch.zeros_like(t, dtype=torch.float32), tree)


def _meta(tree):
    return _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                tree)


def cpu_world(rank, search, train, elastic, ckpt_dir):
    """The CPU tests' one world of 8 ranks: the sharded search cases, one
    sharded train step at mesh (4, 2), the elastic reshard and restore."""
    return {"search": search_cases(rank, search),
            "train": train_case(rank, *train),
            "elastic": elastic_case(rank, *elastic, ckpt_dir)}


# ------------------------------------------------------------- the card
def card_search_case(rank):
    """The sharded search on the card, one shard a rank: the ranks of a
    scheduled batch (2^15 queries, k-ary tops of 300 pages) and of a
    low-locality one, the launch counts of kernels 1-2 in the search,
    and each kernel against its plain version on this rank's operands."""
    import types
    from repro_torch.engine import sharded
    from repro_torch.kernels import kary_search as kk
    from repro_torch.kernels import page_search as pk
    from repro_torch.launch.mesh import make_host_mesh
    world = dist.get_world_size()
    mesh = make_host_mesh((world,), ("data",))
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**31 - 2, world * 300 * 128).astype(np.int32)
    qs = np.concatenate([keys[:1 << 14], rng.integers(0, 2**31 - 2, 1 << 14)
                         .astype(np.int32)])
    idx = sharded.build(keys, mesh)
    seen = {}

    def recorder(kernels, name):
        orig = getattr(kernels, name)

        def record(*a, **kw):
            seen[name] = (a, kw)
            return orig(*a, **kw)
        return types.SimpleNamespace(**{**vars(kernels), name: record})
    pk.page_search_bucketed.launches = kk.kary_search_levels.launches = 0
    page, kary = sharded._page, sharded._kary
    sharded._page = recorder(page, "page_search_bucketed")
    sharded._kary = recorder(kary, "kary_search_levels")
    try:
        got = sharded.search(idx, qs).cpu().numpy()
    finally:
        sharded._page, sharded._kary = page, kary
    launches = [pk.page_search_bucketed.launches,
                kk.kary_search_levels.launches]
    small = sharded.search(idx, qs[:100]).cpu().numpy()
    (pa, pkw), (ka, kkw) = seen["page_search_bucketed"], \
        seen["kary_search_levels"]
    used = int(pkw["steps_used"])
    return {
        "ranks": got, "small": small, "launches": launches,
        "page_equal": bool(torch.equal(
            pk.page_search_bucketed(*pa, **pkw)[:used],
            pk.page_search_plain(*pa, stride=pkw["stride"])[:used])),
        "kary_equal": bool(torch.equal(kk.kary_search_levels(*ka, **kkw),
                                       kk.kary_search_plain(*ka, **kkw))),
        "keys": keys, "queries": qs}
