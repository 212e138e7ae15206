"""Shared neural net layers: norms, RoPE, attention blocks, MLPs (PyTorch
port of ``repro/models/layers.py``).

Plain functions on tensors: params are dicts of tensors, and every
``init_*`` returns such a dict drawn from an explicit ``torch.Generator``
on an explicit device. Compute runs in the activations' dtype with f32
norms, scores and softmax, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_attention import attend, masked_attention


def _dense_init(gen: torch.Generator, shape: tuple, device,
                fan_in: int | None = None) -> torch.Tensor:
    """Normal weights scaled by fan_in ** -0.5 (fan_in = shape[0] unless
    given: the stacked experts' [E, D, F] draw as E matrices [D, F])."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_((fan_in or shape[0]) ** -0.5)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * weight).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, D]; positions: [B, S] or [S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                  # [B,S,half]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------ attention
def init_attention(cfg, gen: torch.Generator, device) -> dict:
    hd = cfg.hd
    p = {
        "wq": _dense_init(gen, (cfg.d_model, cfg.n_heads * hd), device),
        "wk": _dense_init(gen, (cfg.d_model, cfg.n_kv_heads * hd), device),
        "wv": _dense_init(gen, (cfg.d_model, cfg.n_kv_heads * hd), device),
        "wo": _dense_init(gen, (cfg.n_heads * hd, cfg.d_model), device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, device=device)
        p["k_norm"] = torch.ones(hd, device=device)
    return p


def _project_qkv(cfg, p, x, kv_src, positions, kv_positions, use_rope: bool):
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads, hd)
    k = (kv_src @ p["wk"].to(x.dtype)).reshape(B, kv_src.shape[1],
                                               cfg.n_kv_heads, hd)
    v = (kv_src @ p["wv"].to(x.dtype)).reshape(B, kv_src.shape[1],
                                               cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def attention_block(cfg, p, x, positions, *, causal=True, window=None,
                    q_chunk=512, kv_chunk=512, return_kv=False):
    """Self attention over x; used by forward and prefill."""
    q, k, v = _project_qkv(cfg, p, x, x, positions, positions, use_rope=True)
    o = attend(q, k, v, causal, window, q_chunk, kv_chunk)
    o = o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"].to(x.dtype)
    return (o, (k, v)) if return_kv else o


def cross_attention_block(cfg, p, x, memory, *, return_kv=False, kv=None):
    """Cross attention to encoder or vision memory (no mask, no RoPE);
    ``kv`` reuses the cached K/V at decode."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if kv is None:
        m = memory.to(x.dtype)
        k = (m @ p["wk"].to(x.dtype)).reshape(B, m.shape[1], cfg.n_kv_heads,
                                              hd)
        v = (m @ p["wv"].to(x.dtype)).reshape(B, m.shape[1], cfg.n_kv_heads,
                                              hd)
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    else:
        k, v = kv
    o = attend(q, k, v, False, None, 512, 512)
    o = o.reshape(B, S, -1) @ p["wo"].to(x.dtype)
    return (o, (k, v)) if return_kv else o


def _grouped_attention(cfg, p, q, k_cache, v_cache, ok):
    """q [B, Sq, Hq, hd] against the whole cache with the [B|1, Sq|1, Skv]
    mask ``ok``, projected by wo."""
    B, Sq = q.shape[:2]
    o = masked_attention(q, k_cache, v_cache, ok)
    return o.reshape(B, Sq, cfg.n_heads * cfg.hd) @ p["wo"].to(q.dtype)


def decode_attention(cfg, p, x1, k_cache, v_cache, lengths, positions):
    """One-token attention against a (possibly longer) KV cache.

    x1: [B, 1, D]; k_cache/v_cache: [B, Smax, Hkv, hd]; lengths: [B] valid
    prefix per sequence (the new token is already written at lengths-1).
    """
    B = x1.shape[0]
    hd = cfg.hd
    q = (x1 @ p["wq"].to(x1.dtype)).reshape(B, 1, cfg.n_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    q = rope(q, positions[:, None], cfg.rope_theta)
    k_pos = torch.arange(k_cache.shape[1], device=x1.device)
    ok = k_pos[None, :] < lengths[:, None]
    if cfg.window is not None:
        ok = ok & (k_pos[None, :] > lengths[:, None] - 1 - cfg.window)
    return _grouped_attention(cfg, p, q, k_cache, v_cache, ok[:, None, :])


def append_attention(cfg, p, x, k_cache, v_cache, start: int, *,
                     window=None):
    """Prefix-continue attention: St new tokens (already written into the
    cache at [start, start+St)) attend causally over cache[0:start+St).
    Used by prefill with prefix reuse; x: [B, St, D]; start: int."""
    B, St, _ = x.shape
    hd = cfg.hd
    positions = start + torch.arange(St, device=x.device)
    q = (x @ p["wq"].to(x.dtype)).reshape(B, St, cfg.n_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k_pos = torch.arange(k_cache.shape[1], device=x.device)
    ok = k_pos[None, :] <= positions[:, None]            # causal, absolute pos
    if window is not None:
        ok = ok & (positions[:, None] - k_pos[None, :] < window)
    return _grouped_attention(cfg, p, q, k_cache, v_cache, ok[None])


def project_kv_token(cfg, p, x1, positions):
    """K/V for one new token (decode cache append)."""
    B = x1.shape[0]
    hd = cfg.hd
    k = (x1 @ p["wk"].to(x1.dtype)).reshape(B, 1, cfg.n_kv_heads, hd)
    v = (x1 @ p["wv"].to(x1.dtype)).reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    k = rope(k, positions[:, None], cfg.rope_theta)
    return k, v


# ------------------------------------------------------------------ MLP
def init_mlp(cfg, gen: torch.Generator, device) -> dict:
    if cfg.mlp_act == "swiglu":
        return {
            "w_gate": _dense_init(gen, (cfg.d_model, cfg.d_ff), device),
            "w_up": _dense_init(gen, (cfg.d_model, cfg.d_ff), device),
            "w_down": _dense_init(gen, (cfg.d_ff, cfg.d_model), device),
        }
    return {
        "w_up": _dense_init(gen, (cfg.d_model, cfg.d_ff), device),
        "w_down": _dense_init(gen, (cfg.d_ff, cfg.d_model), device),
    }


def mlp_block(cfg, p, x):
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    elif cfg.mlp_act == "sqrelu":                 # nemotron-4: squared ReLU
        h = torch.square(F.relu(x @ p["w_up"].to(x.dtype)))
    elif cfg.mlp_act == "gelu":                   # the reference's tanh form
        h = F.gelu(x @ p["w_up"].to(x.dtype), approximate="tanh")
    else:
        raise ValueError(cfg.mlp_act)
    return h @ p["w_down"].to(x.dtype)
