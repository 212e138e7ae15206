"""Self and cross attention, forward only (PyTorch port of
``repro/models/flash_attention.py``).

The reference is plain JAX, not Pallas: a chunked online-softmax scan with
a custom VJP, so that training at long context never holds the [Sq, Skv]
scores. Serving prompts are short, so the port computes the same function
as plain masked attention: f32 scores and softmax, with the reference's
causal and sliding-window bias (``NEG_INF`` where masked), which is
``attention_reference`` there. The chunked form and the backward come
with training (ROADMAP Queue 1 item 15).

Shapes: q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D]; Hq % Hkv == 0.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask_ok(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    """[Sq, Skv] bool: True where attending (the reference's ``_mask_bias``
    is 0 there and NEG_INF elsewhere)."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
    return ok


def masked_attention(q, k, v, ok: torch.Tensor) -> torch.Tensor:
    """q [B, Sq, Hq, D] over k/v [B, Skv, Hkv, D] with the bool mask ``ok``
    ([B|1, Sq|1, Skv]); f32 scores and softmax, NEG_INF where masked.
    Returns [B, Sq, Hq, D] in q's dtype."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (D ** -0.5)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Masked attention of q over all of k/v (the reference's chunk sizes
    are tiling knobs of its scan; the plain form has no tiles)."""
    Sq, Skv = q.shape[1], k.shape[1]
    if causal and Sq != Skv:
        raise ValueError("causal flash attention requires Sq == Skv; "
                         "decode uses serve-side attention")
    ok = _mask_ok(torch.arange(Sq, device=q.device),
                  torch.arange(Skv, device=q.device), causal, window)
    return masked_attention(q, k, v, ok[None])
