"""Token sampling (PyTorch port of ``repro/serve/sampler.py``).

Nucleus (top-p) sampling inverts each row's sorted-probability CDF: the
thesis' search problem, once per sequence per decode step. The inversion
is ``kernels.ops.topp_search``: the CUDA kernel ``cdf_search`` for a
tensor on the card, its plain version for one on the CPU. The device
decides, as in every wrapper of the port; ``SamplerConfig.use_kernel`` is
kept field for field with the reference and routes nothing.

The reference's ``_nucleus_cdf`` is split in two: ``nucleus_cdf`` builds
the order and the CDF, ``draw_u`` draws the per-row point to invert, so a
test can feed the reference's draw into the port's inversion.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.util import not_ported
from ..kernels import ops as kops


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0                   # 0 = off
    use_kernel: bool = False         # kept for parity; the device decides


def nucleus_cdf(logits: torch.Tensor, cfg: SamplerConfig):
    """Temperature, top-k mask, softmax, stable descending sort and CDF.
    Returns (order [B, V], cdf [B, V]): the token is
    ``order[b, first v with cdf[b, v] >= u[b]]``. The sort is stable, so
    equal probabilities keep index order, as ``jnp.argsort(-probs)``
    does."""
    logits = logits / cfg.temperature
    if cfg.top_k:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    p_sorted, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return order, torch.cumsum(p_sorted, dim=-1)


def draw_u(cdf: torch.Tensor, cfg: SamplerConfig,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-row u, uniform in [1e-6, 1) and scaled into the top-p nucleus:
    ``u * min(top_p, cdf[:, -1])``."""
    r = torch.rand(cdf.shape[0], generator=generator, device=cdf.device)
    u = 1e-6 + (1.0 - 1e-6) * r
    return u * cdf[:, -1].clamp_max(cfg.top_p)


def sample(logits: torch.Tensor, cfg: SamplerConfig = SamplerConfig(), *,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: [B, V] -> token ids [B] int32. Greedy (temperature 0) is
    argmax; otherwise one CDF inversion for the whole batch."""
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    order, cdf = nucleus_cdf(logits, cfg)
    idx = kops.topp_search(cdf, draw_u(cdf, cfg, generator))
    return order.gather(1, idx[:, None].long())[:, 0].to(torch.int32)


def sample_queued(logits, cfg: SamplerConfig, queue, tenants=None, *,
                  generator=None):
    raise not_ported("sample_queued (the decode micro-batch queue)",
                     "item 9 (queue and admission)")
