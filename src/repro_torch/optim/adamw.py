"""AdamW with global-norm clipping and WSD / cosine / linear schedules
(PyTorch port of ``repro/optim/adamw.py``).

The state is ``{m, v, count}``: float32 moments in the parameters' tree
and an int32 step count, all on the parameters' device. The update keeps
the reference's order (count, schedule, clip from the norm of all grads,
float32 bias corrections, decoupled decay) and writes the parameters and
moments in place under ``torch.no_grad()``: the reference donates them to
its jitted step, and in place the step holds params, grads and two
moments, nothing more. Nothing in it reads a device value on the host.

Parameter trees are nested dicts and lists of tensors. The reference
stacks every block leaf ``[repeats, ...]``; the port keeps a list of
layers, whose leaves are one dim shorter. The decay mask is the
reference's (decay a leaf of rank >= 2) on the reference's rank: a leaf
inside a list counts one more dim, so that every block leaf is decayed
there as here (norm scales and the Mamba heads' vectors included) and
only the top-level 1-D leaves (the final norms) are not.

WSD (warmup-stable-decay) is minicpm-2b's schedule: linear warmup, a long
flat phase, a short decay tail.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..core.util import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"          # cosine | wsd | linear | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    wsd_decay_frac: float = 0.1       # fraction of total spent in decay


# ------------------------------------------------------------------ decay
def decay_mask(tree, stacked: int = 0):
    """A tree of bools in ``tree``'s structure: whether each leaf takes
    weight decay, the reference's ``ndim >= 2`` on its stacked layout (a
    leaf inside a list of layers counts one dim more)."""
    if isinstance(tree, dict):
        return {k: decay_mask(v, stacked) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(decay_mask(v, 1) for v in tree)
    return tree.ndim + stacked >= 2


# ------------------------------------------------------------------ schedule
def schedule_fn(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a device tensor), as a
    float32 tensor on the step's device."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step)
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        mult = 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        decay_start = 1.0 - cfg.wsd_decay_frac
        mult = torch.where(t < decay_start, 1.0,
                           1.0 - (t - decay_start) / cfg.wsd_decay_frac)
        mult = torch.clamp(mult, min=0.0)
    elif cfg.schedule == "linear":
        mult = 1.0 - t
    elif cfg.schedule == "const":
        mult = 1.0
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * mult


# ------------------------------------------------------------------ update
def init_state(params) -> dict:
    """Zero float32 moments in the parameters' tree and count 0."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    with torch.no_grad():
        return torch.sqrt(torch.stack([
            torch.sum(torch.square(x.float())) for x in tree_leaves(tree)
        ]).sum())


def apply_updates(cfg: OptConfig, params, grads, state, *, gnorm=None):
    """One AdamW step. Updates ``params`` and the state's moments in place
    and returns (params, new_state, {"grad_norm" (before the clip),
    "lr"}), the metrics as float32 device tensors. ``gnorm``: the global
    norm of the whole grads, where ``grads`` are one rank's shards of them
    (the sharded step); by default the norm of ``grads``."""
    with torch.no_grad():
        count = state["count"] + 1
        lr = schedule_fn(cfg, count)
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = None
        if cfg.clip_norm is not None:
            scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        b1, b2 = cfg.betas
        bc1 = 1 - torch.pow(b1, count.float())
        bc2 = 1 - torch.pow(b2, count.float())

        def upd(p, g, m, v, decay):
            g = g.float()
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            step = (m / bc1) / ((v / bc2).sqrt_() + cfg.eps)
            if decay:
                step.add_(p.float(), alpha=cfg.weight_decay)
            step.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(step)
            else:
                p.copy_(p.float() - step)

        # leaves matched by their place in params (dict keys, list slots)
        tree_map(upd, params, grads, state["m"], state["v"],
                 decay_mask(params))
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
