"""Decoder LM of the dense family: init, forward, prefill, prefill with a
reused prefix, and batched decode (PyTorch port of
``repro/models/transformer.py``).

The reference stacks its blocks ``[repeats, ...]`` per pattern position
and scans over them. The port keeps one dict of tensors per layer in
``params["layers"]`` and loops over them, and keeps the decode cache as
one ``[n_layers, B, max_len, Hkv, hd]`` tensor each for K and V:
``from_reference_params`` converts the reference's parameters, and a
dense model's reference cache ``layers.p0.k`` has the same shape as the
port's ``k``. Prefill and decode write the cache in place.

The other families (moe, ssm, hybrid, vlm, audio) raise
``NotImplementedError`` naming ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.util import not_ported, resolve_device, take
from . import layers as L

PORTED_FAMILIES = ("dense",)


def _check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise not_ported(f"model family {cfg.family!r}",
                         "item 13 (serving stack)")


# =============================================================== init
def _init_block(cfg, gen: torch.Generator, device) -> dict:
    return {
        "ln1": torch.ones(cfg.d_model, device=device),
        "attn": L.init_attention(cfg, gen, device),
        "ln2": torch.ones(cfg.d_model, device=device),
        "mlp": L.init_mlp(cfg, gen, device),
    }


def init_params(cfg, generator: torch.Generator, device=None) -> dict:
    """Random float32 parameters with the reference's shapes and scales,
    drawn from ``generator`` (which must live on ``device``)."""
    _check_family(cfg)
    device = resolve_device(device)
    vp = cfg.padded_vocab            # padded columns are masked in logits
    params = {
        "embed": torch.randn(vp, cfg.d_model, generator=generator,
                             device=device) * 0.02,
        "final_norm": torch.ones(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._dense_init(generator, (cfg.d_model, vp),
                                          device)
    params["layers"] = [_init_block(cfg, generator, device)
                        for _ in range(cfg.n_layers)]
    return params


def from_reference_params(cfg, params, *, device=None) -> dict:
    """The port's parameters from the reference's parameter pytree (numpy
    or JAX arrays, blocks stacked ``[repeats, ...]`` under ``p0``), so
    that both packages compute the same function."""
    _check_family(cfg)
    device = resolve_device(device)

    def conv(tree, r=None):
        if isinstance(tree, dict):
            return {k: conv(v, r) for k, v in tree.items()}
        a = np.array(tree)
        return torch.from_numpy(a if r is None else a[r]).to(device)

    out = {k: conv(v) for k, v in params.items() if k != "blocks"}
    out["layers"] = [conv(params["blocks"]["p0"], r)
                     for r in range(cfg.n_layers)]
    return out


def param_count(params) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel()
    return count(params)


# =============================================================== forward
def _embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return take(params["embed"], tokens).to(dtype)


def _run_blocks(cfg, params, x, positions):
    """Every layer over x; returns (x, [(k, v) per layer])."""
    kvs = []
    for lp in params["layers"]:
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, kv = L.attention_block(cfg, lp["attn"], h, positions, causal=True,
                                  window=cfg.window, return_kv=True)
        kvs.append(kv)
        x = x + h
        x = x + L.mlp_block(cfg, lp["mlp"],
                            L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    return x, kvs


def forward(cfg, params, tokens: torch.Tensor, *,
            compute_dtype=torch.bfloat16):
    """Forward over whole sequences -> (hidden [B,S,D], aux loss). Logits
    are computed by the caller (last token for serving)."""
    _check_family(cfg)
    x = _embed(params, tokens, compute_dtype)
    positions = torch.arange(tokens.shape[1], device=x.device)
    x, _ = _run_blocks(cfg, params, x, positions)
    aux = torch.zeros((), device=x.device)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def mask_padded_vocab(cfg, logits: torch.Tensor) -> torch.Tensor:
    """-1e30 in the padded logit columns (cols >= real vocab)."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(col >= cfg.vocab, -1e30)


def logits_of(cfg, params, hidden: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return mask_padded_vocab(cfg, (hidden @ w.to(hidden.dtype)).float())


# =============================================================== serving
def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device) -> dict:
    """Zeroed decode cache: per-row valid lengths and K/V of every
    layer."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"lengths": torch.zeros(batch, dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(cfg, params, tokens: torch.Tensor, *,
            compute_dtype=torch.bfloat16, max_len: Optional[int] = None):
    """Run the prompt, build the decode cache. Returns (last_logits, cache)."""
    _check_family(cfg)
    B, S = tokens.shape
    x = _embed(params, tokens, compute_dtype)
    positions = torch.arange(S, device=x.device)
    x, kvs = _run_blocks(cfg, params, x, positions)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache = init_cache(cfg, B, max_len or S, compute_dtype, device=x.device)
    cache["lengths"].fill_(S)
    for i, (k, v) in enumerate(kvs):
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return logits_of(cfg, params, hidden[:, -1:])[:, 0], cache


def prefill_continue(cfg, params, tokens: torch.Tensor, cache: dict,
                     start: int, *, compute_dtype=torch.bfloat16):
    """Continue a prefill from position ``start`` (prefix pages already in
    the cache): the serving path behind prefix reuse. Writes the new K/V
    into ``cache`` in place."""
    _check_family(cfg)
    B, St = tokens.shape
    x = _embed(params, tokens, compute_dtype)
    positions = start + torch.arange(St, device=x.device)
    for i, lp in enumerate(params["layers"]):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        k1, v1 = L._project_qkv(cfg, lp["attn"], h, h, positions, positions,
                                use_rope=True)[1:]
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, start:start + St] = k1
        vc[:, start:start + St] = v1
        x = x + L.append_attention(cfg, lp["attn"], h, kc, vc, start,
                                   window=cfg.window)
        x = x + L.mlp_block(cfg, lp["mlp"],
                            L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_of(cfg, params, hidden[:, -1:])[:, 0]
    return logits, dict(cache, lengths=torch.full_like(cache["lengths"],
                                                       start + St))


def decode_step(cfg, params, token: torch.Tensor, cache: dict, *,
                compute_dtype=torch.bfloat16):
    """One token for every sequence. token: [B] int. Returns (logits
    [B, V], cache). Ragged lengths per row: row b writes its K/V at
    ``min(lengths[b], max_len - 1)``, in place, with no host sync."""
    _check_family(cfg)
    B = token.shape[0]
    lengths = cache["lengths"]                      # valid BEFORE this step
    x = _embed(params, token, compute_dtype)[:, None]
    kv_len = cache["k"].shape[2]
    wpos = lengths.clamp_max(kv_len - 1).long()
    at = wpos.view(B, 1, 1, 1).expand(B, 1, cfg.n_kv_heads, cfg.hd)
    valid = lengths + 1
    for i, lp in enumerate(params["layers"]):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        k1, v1 = L.project_kv_token(cfg, lp["attn"], h, lengths)
        kc, vc = cache["k"][i], cache["v"][i]
        kc.scatter_(1, at, k1.to(kc.dtype))
        vc.scatter_(1, at, v1.to(vc.dtype))
        x = x + L.decode_attention(cfg, lp["attn"], h, kc, vc, valid,
                                   lengths)
        x = x + L.mlp_block(cfg, lp["mlp"],
                            L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_of(cfg, params, hidden)[:, 0]
    return logits, dict(cache, lengths=valid)
