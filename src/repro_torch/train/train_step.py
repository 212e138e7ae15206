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

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.util import tree_leaves, tree_map
from ..models import transformer as T
from ..optim import adamw


def _ce_chunk(cfg, hx, lx, w):
    """(summed CE over the valid labels, their count) of one chunk."""
    logits = T.mask_padded_vocab(cfg, (hx @ w.to(hx.dtype)).float())
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lx.clamp(min=0).long()[..., None])[..., 0]
    valid = (lx >= 0).float()
    return torch.sum((logz - ll) * valid), torch.sum(valid)


def chunked_ce_loss(cfg, params, hidden, labels, chunk: int = 1024):
    """Mean CE over [B, S] without materializing [B, S, V]: S padded to a
    chunk multiple with label -1 (ignored), each chunk's logits against
    the tied embedding or ``lm_head``, padded vocab columns masked."""
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
            t, k = checkpoint(_ce_chunk, cfg, hx, lx, w, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            t, k = _ce_chunk(cfg, hx, lx, w)
        tot, n = tot + t, n + k
    return tot / torch.clamp(n, min=1.0)


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
