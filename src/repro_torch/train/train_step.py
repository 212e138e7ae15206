"""Training step: chunked cross-entropy, microbatch gradient accumulation
and remat (PyTorch port of ``repro/train/train_step.py``).

Memory design, as in the reference:
  * remat inside the model forward (``transformer._run_blocks``): the
    backward recomputes each layer group from its input;
  * the [B, S, V] logits never exist at once: the CE runs in sequence
    chunks under ``torch.utils.checkpoint``, and the backward recomputes
    each chunk's logits;
  * microbatches add into one float32 grad accumulator;
  * the optimizer updates the parameters and moments in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..core.util import tree_leaves, tree_map
from ..dist import sharding as SH
from ..models import transformer as T
from ..optim import adamw


def _ce_chunk(cfg, hx, lx, w, row_w=None):
    """(summed CE over the valid labels, each row's weighted by ``row_w``
    when given, and their count) of one chunk."""
    logits = T.mask_padded_vocab(cfg, (hx @ w.to(hx.dtype)).float())
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lx.clamp(min=0).long()[..., None])[..., 0]
    valid = (lx >= 0).float()
    weight = valid if row_w is None else valid * row_w[:, None]
    return torch.sum((logz - ll) * weight), torch.sum(valid)


def chunked_ce_loss(cfg, params, hidden, labels, chunk: int = 1024):
    """Mean CE over [B, S] without materializing [B, S, V]: S padded to a
    chunk multiple with label -1 (ignored), each chunk's logits against
    the tied embedding or ``lm_head``, padded vocab columns masked."""
    tot, n = chunked_ce_sum(cfg, params, hidden, labels, chunk)
    return tot / torch.clamp(n, min=1.0)


def chunked_ce_sum(cfg, params, hidden, labels, chunk: int = 1024,
                   row_weights=None):
    """(summed CE over the valid labels, their count) of ``chunked_ce_loss``;
    with ``row_weights`` [B], each row's CE weighted by it."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros_like(tot)
    for c in range(0, hidden.shape[1], chunk):
        hx, lx = hidden[:, c:c + chunk], labels[:, c:c + chunk]
        if torch.is_grad_enabled():
            t, k = checkpoint(_ce_chunk, cfg, hx, lx, w, row_weights,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            t, k = _ce_chunk(cfg, hx, lx, w, row_weights)
        tot, n = tot + t, n + k
    return tot, n


def make_loss_fn(cfg, *, compute_dtype=torch.bfloat16, remat=True,
                 ce_chunk=1024, aux_weight=0.01, attn_chunks=(512, 512)):
    def loss_fn(params, tokens, labels, memory=None):
        hidden, aux = T.forward(cfg, params, tokens, memory=memory,
                                remat=remat, compute_dtype=compute_dtype,
                                chunks=attn_chunks)
        ce = chunked_ce_loss(cfg, params, hidden, labels, ce_chunk)
        return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}
    return loss_fn


def make_train_step(cfg, opt_cfg: adamw.OptConfig, *, microbatches: int = 1,
                    compute_dtype=torch.bfloat16, remat=True, ce_chunk=1024,
                    aux_weight=0.01, attn_chunks=(512, 512),
                    has_memory: bool = False, cast_params_once: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). batch: {tokens, labels[, memory]} tensors on the params'
    device, with leading dim B divisible by ``microbatches``. The params
    and the state's moments are updated in place; metrics ``loss``,
    ``grad_norm`` (before the clip) and ``lr`` are float32 device tensors,
    so the step reads nothing on the host.

    cast_params_once: differentiate with respect to a ``compute_dtype``
    copy of the float32 params, cast once outside the microbatch loop;
    its grads are widened back to float32 by the update. remat: False |
    True / "group" | "block" (see ``transformer._run_blocks``)."""
    loss_fn = make_loss_fn(cfg, compute_dtype=compute_dtype, remat=remat,
                           ce_chunk=ce_chunk, aux_weight=aux_weight,
                           attn_chunks=attn_chunks)

    def value_and_grad(work, work_params, tokens, labels, memory):
        loss, _ = loss_fn(work_params, tokens, labels, memory)
        grads = torch.autograd.grad(loss, work, allow_unused=True)
        return loss.detach(), [torch.zeros_like(w) if g is None else g
                               for w, g in zip(work, grads)]

    def train_step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        memory = batch.get("memory") if has_memory else None
        B = tokens.shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{microbatches} microbatches")
        leaves = tree_leaves(params)
        if cast_params_once:
            work = [(p.detach().to(compute_dtype)
                     if p.dtype == torch.float32 else p.detach())
                    .requires_grad_() for p in leaves]
        else:
            work = [p.detach().requires_grad_() for p in leaves]
        it = iter(work)
        work_params = tree_map(lambda _: next(it), params)

        if microbatches == 1:
            loss, grads = value_and_grad(work, work_params, tokens, labels,
                                         memory)
        else:
            mb = B // microbatches
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(microbatches):
                sl = slice(i * mb, (i + 1) * mb)
                l, g = value_and_grad(
                    work, work_params, tokens[sl], labels[sl],
                    None if memory is None else memory[sl])
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                loss = loss + l
                del g
            for acc in grads:
                acc.div_(microbatches)
            loss = loss / microbatches
        del work, work_params      # the compute-dtype copy, before the update
        it = iter(grads)
        params, opt_state, om = adamw.apply_updates(
            opt_cfg, params, tree_map(lambda _: next(it), params), opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_sharded_train_step(cfg, opt_cfg: adamw.OptConfig, mesh, *,
                            microbatches: int = 1,
                            compute_dtype=torch.bfloat16, remat=True,
                            ce_chunk=1024, aux_weight=0.01,
                            attn_chunks=(512, 512),
                            has_memory: bool = False):
    """The twin of ``jax.jit(make_train_step(...), in_shardings=(psh, osh,
    bsh))`` over ``mesh``: returns train_step(params, opt_state, batch) ->
    (params, opt_state, metrics), every rank of the mesh calling it. The
    params and AdamW moments are DTensors in the reference's stacked layout
    (``transformer.to_reference_params``) under ``params_shardings``, the
    count a replicated DTensor, the batch's leaves DTensors whose rows
    shard over every data axis (``batch_shardings``). The params and
    moments are updated in place, shard by shard; the metrics are the
    single-device step's.

    The schedule is simple and exact, with no tensor-parallel compute:
    each rank gathers the whole params, runs the forward and backward of
    its rows in ``microbatches`` pieces, the grads are summed over the
    data axes, and each rank updates its own blocks. The loss is the
    reference's: for each global microbatch (rows ``[i * mb, (i + 1) *
    mb)`` of the global batch) sum(CE * valid) / sum(valid), averaged over
    the microbatches. Each row's CE is weighted by 1 / (microbatches x its
    microbatch's count of valid labels over all ranks), so that the sums
    over the data ranks give exactly that, also where labels hold -1. The
    global-norm clip reads the norm of the whole summed grads, which every
    rank holds, so each leaf counts once. A MoE's auxiliary loss is each
    rank's own, averaged over the data ranks."""
    sizes = SH.axis_sizes(mesh)
    names = list(sizes)
    dp_dims = [names.index(a) for a in SH.dp_axes(mesh)]
    n_dp = int(np.prod([sizes[names[d]] for d in dp_dims]))
    dev = SH.mesh_device(mesh)

    def reduce_dp(t):
        for d in dp_dims:
            dist.all_reduce(t, group=mesh.get_group(d))
        return t

    def train_step(params, opt_state, batch):
        coord = mesh.get_coordinate()
        tokens = batch["tokens"].to_local()
        labels = batch["labels"].to_local()
        memory = batch["memory"].to_local() if has_memory else None
        B, lb = batch["tokens"].shape[0], tokens.shape[0]
        if B % microbatches or lb % microbatches or lb * n_dp != B:
            raise ValueError(
                f"batch {B} must shard its rows over the data axes "
                f"({n_dp} ranks) into {microbatches} microbatches each")
        row0 = 0
        for d in dp_dims:
            row0 = row0 * sizes[names[d]] + coord[d]
        row0 *= lb
        # each row's weight: 1 / (microbatches x its global microbatch's
        # count of valid labels)
        mb_of = torch.div(row0 + torch.arange(lb, device=dev),
                          B // microbatches, rounding_mode="floor")
        counts = torch.zeros(microbatches, dtype=torch.float32, device=dev)
        counts.index_add_(0, mb_of, (labels >= 0).sum(1).float())
        reduce_dp(counts)
        row_w = 1.0 / (microbatches * torch.clamp(counts, min=1.0))[mb_of]

        with torch.no_grad():
            full = tree_map(lambda d: SH.gather(d).detach(), params)
        work = [w.requires_grad_() for w in tree_leaves(full)]
        grads = None
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        piece = lb // microbatches
        for j in range(microbatches):
            sl = slice(j * piece, (j + 1) * piece)
            port = T.from_reference_params(cfg, full, device=dev)
            hidden, aux = T.forward(
                cfg, port, tokens[sl],
                memory=None if memory is None else memory[sl],
                remat=remat, compute_dtype=compute_dtype,
                chunks=attn_chunks)
            tot, _ = chunked_ce_sum(cfg, port, hidden, labels[sl], ce_chunk,
                                    row_weights=row_w[sl])
            lj = tot + aux_weight * aux / (microbatches * n_dp)
            g = torch.autograd.grad(lj, work, allow_unused=True)
            g = [torch.zeros_like(w) if x is None else x
                 for w, x in zip(work, g)]
            if grads is None:
                grads = g
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x)
            loss = loss + lj.detach()
            del port, hidden, g
        del work, full
        reduce_dp(loss)
        for g in grads:
            reduce_dp(g)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        gnorm = adamw.global_norm(grads)

        def local(x):
            return x.to_local()
        with torch.no_grad():
            local_grads = tree_map(
                lambda g, d: SH.local_slice(g, mesh, d.placements, coord),
                grads, params)
            _, st, om = adamw.apply_updates(
                opt_cfg, tree_map(local, params), local_grads,
                {"m": tree_map(local, opt_state["m"]),
                 "v": tree_map(local, opt_state["v"]),
                 "count": opt_state["count"].to_local()}, gnorm=gnorm)
        count = DTensor.from_local(st["count"], mesh,
                                   opt_state["count"].placements,
                                   run_check=False)
        return params, {"m": opt_state["m"], "v": opt_state["v"],
                        "count": count}, {"loss": loss, **om}

    return train_step
