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

``sample_queued`` routes the inversion through a decode micro-batch queue
(``kernels.cdf_search.cdf_probe_fn`` behind ``engine.queue``, DESIGN.md
§7.1): rows are submitted per tenant and the flush inverts all pending
decode steps in one launch. Its tokens are bit-identical to ``sample``
with the same generator: the same CDF, the same draw, the same count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.util import upload_async
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


def sample_queued(logits: torch.Tensor, cfg: SamplerConfig, queue,
                  tenants=None, *,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """``sample`` with the CDF inversion routed through a decode
    micro-batch queue (``MicroBatchQueue(cdf_probe_fn())``): each tenant's
    rows are one submit, so concurrent requests' decode steps aggregate
    into one inversion a flush, admission-fairly shared.

    ``tenants``: optional per-row tenant ids ([B]); the rows of one tenant
    submit together, gathered on the device, and their inversions are
    scattered back on the device (no host round trip). Greedy decoding
    (temperature 0) has no inversion to batch and bypasses the queue."""
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    order, cdf = nucleus_cdf(logits, cfg)
    u = draw_u(cdf, cfg, generator)
    if tenants is None:
        idx = queue.submit((cdf, u)).result()
    else:
        tenants = list(tenants)
        B = cdf.shape[0]
        if len(tenants) != B:
            raise ValueError(f"tenants must have one id per row: "
                             f"{len(tenants)} != {B}")
        groups: dict = {}
        for row, t in enumerate(tenants):
            groups.setdefault(t, []).append(row)
        # rows grouped by tenant, in first-seen tenant order: one upload
        # of the permutation, one gather, a view a tenant
        perm = upload_async(np.concatenate(
            [np.asarray(rows, np.int64) for rows in groups.values()]),
            cdf.device)
        cdf_g, u_g = cdf.index_select(0, perm), u.index_select(0, perm)
        futs, at = [], 0
        for t, rows in groups.items():
            n = len(rows)
            futs.append(queue.submit((cdf_g[at:at + n], u_g[at:at + n]),
                                     tenant=t))
            at += n
        got = torch.cat([f.result() for f in futs])
        idx = torch.empty_like(got).scatter_(0, perm, got)
    return order.gather(1, idx[:, None].long())[:, 0].to(torch.int32)
