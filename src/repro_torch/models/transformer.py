"""Config-driven transformer family: decoder LMs (dense, moe, ssm, hybrid),
the encoder-decoder (audio) and the cross-attention backbone (vlm):
init, the differentiable forward with remat that training runs, encode,
prefill, prefill with a reused prefix, and batched decode (PyTorch port
of ``repro/models/transformer.py``).

The reference stacks its blocks ``[repeats, ...]`` per pattern position
and scans over them. The port keeps one dict of tensors per layer in
``params["layers"]`` (layer ``l = r * period + p`` is the reference's
``blocks[f"p{p}"][r]``) and loops over them; ``from_reference_params``
and ``to_reference_params`` convert parameters (and, with
``*_reference_opt_state``, the optimizer's moments) between the two
layouts. The decode cache stacks each state
kind over the layers that carry it:

    lengths  [B] int32
    k, v     [L_attn, B, max_len, Hkv, hd]      attention layers
    conv     [L_mamba, B, ssm_conv - 1, conv_dim]   mamba layers (cache dtype)
    ssm      [L_mamba, B, H, P, N] float32          mamba layers
    ck, cv   [L_cross, B, memory_len, Hkv, hd]  cross layers

so a dense or MoE model's ``k`` / ``v`` are ``[n_layers, ...]`` and page as
they are. ``to_reference_cache`` gives the reference's layout. Prefill and
decode write the cache in place. Modality frontends are stubs, as in the
reference: vlm and audio take precomputed embeddings at d_model
("memory").
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint

from ..core.util import resolve_device, take, tree_map
from ..dist.sharding import constrain_activations
from . import layers as L
from . import moe as MOE
from . import ssm as SSM

PAGEABLE_FAMILIES = ("dense", "moe")
STATE_KINDS = {"attn": ("k", "v"), "mamba": ("conv", "ssm"),
               "cross": ("ck", "cv")}


def _specs(cfg) -> list:
    """The resolved block structure of every layer."""
    return [cfg.layer_spec(i % cfg.period) for i in range(cfg.n_layers)]


def _slots(cfg) -> list:
    """Per layer, {kind: its index in the cache's stack of that kind}."""
    count = {"attn": 0, "mamba": 0, "cross": 0}
    out = []
    for spec in _specs(cfg):
        kinds = [spec["mixer"]] + (["cross"] if spec["cross"] else [])
        out.append({kd: count[kd] for kd in kinds})
        for kd in kinds:
            count[kd] += 1
    return out


# =============================================================== init
def _init_block(cfg, spec, gen: torch.Generator, device) -> dict:
    ones = lambda: torch.ones(cfg.d_model, device=device)  # noqa: E731
    p = {"ln1": ones()}
    if spec["mixer"] == "attn":
        p["attn"] = L.init_attention(cfg, gen, device)
    else:
        p["mamba"] = SSM.init_mamba(cfg, gen, device)
    if spec["cross"]:
        p["ln_cross"] = ones()
        p["cross"] = L.init_attention(cfg, gen, device)
    if spec["ffn"] == "dense":
        p["ln2"] = ones()
        p["mlp"] = L.init_mlp(cfg, gen, device)
    elif spec["ffn"] == "moe":
        p["ln2"] = ones()
        p["moe"] = MOE.init_moe(cfg, gen, device)
    return p


ENCODER_SPEC = {"mixer": "attn", "cross": False, "ffn": "dense"}


def init_params(cfg, generator: torch.Generator, device=None) -> dict:
    """Random float32 parameters with the reference's shapes and scales,
    drawn from ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    vp = cfg.padded_vocab            # padded columns are masked in logits
    params = {
        "embed": torch.randn(vp, cfg.d_model, generator=generator,
                             device=device).mul_(0.02),
        "final_norm": torch.ones(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._dense_init(generator, (cfg.d_model, vp),
                                          device)
    params["layers"] = [_init_block(cfg, spec, generator, device)
                        for spec in _specs(cfg)]
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": [_init_block(cfg, ENCODER_SPEC, generator, device)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": torch.ones(cfg.d_model, device=device),
        }
    return params


def from_reference_params(cfg, params, *, device=None) -> dict:
    """The port's parameters from the reference's parameter pytree (numpy,
    JAX arrays or tensors, blocks stacked ``[repeats, ...]`` per pattern
    position), so that both packages compute the same function. Tensors
    keep their dtype and, on ``device`` already, are used as they are (a
    layer of a stacked tensor is a view of it)."""
    device = resolve_device(device)

    def conv(tree, r=None):
        if isinstance(tree, dict):
            return {k: conv(v, r) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return (tree if r is None else tree[r]).to(device)
        a = np.array(tree)
        return torch.from_numpy(a if r is None else a[r]).to(device)

    out = {k: conv(v) for k, v in params.items()
           if k not in ("blocks", "encoder")}
    blocks, period = params["blocks"], cfg.period
    out["layers"] = [conv(blocks[f"p{i % period}"], i // period)
                     for i in range(cfg.n_layers)]
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "layers": [conv(enc["blocks"], r)
                       for r in range(cfg.encoder_layers)],
            "final_norm": conv(enc["final_norm"])}
    return out


def to_reference_params(cfg, params, *, device="cpu") -> dict:
    """The reference's parameter pytree from the port's, as tensors on
    ``device`` (the CPU by default; "meta" for shapes alone) in their own
    dtype (copies: later in-place updates of ``params`` do not reach
    them): ``layers[r * period + p]`` stacked into ``blocks[f"p{p}"][r]``,
    the encoder's layers into ``encoder["blocks"]``. The inverse of
    ``from_reference_params``; the trainer's checkpoints and the sharded
    train state hold this layout, under the reference's names."""
    def host(t):
        return t.detach().to(device, copy=True)

    def stack(*ts):          # where the layers live: one copy to `device`
        return torch.stack([t.detach() for t in ts]).to(device)

    out = {k: tree_map(host, v) for k, v in params.items()
           if k not in ("layers", "encoder")}
    layers, period = params["layers"], cfg.period
    out["blocks"] = {f"p{p}": tree_map(stack, *layers[p::period])
                     for p in range(period)}
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"blocks": tree_map(stack, *enc["layers"]),
                          "final_norm": host(enc["final_norm"])}
    return out


def to_reference_opt_state(cfg, state: dict) -> dict:
    """The optimizer state ``{m, v, count}`` in the reference's layout (see
    ``to_reference_params``)."""
    return {"m": to_reference_params(cfg, state["m"]),
            "v": to_reference_params(cfg, state["v"]),
            "count": state["count"].detach().to("cpu", copy=True)}


def from_reference_opt_state(cfg, state: dict, *, device=None) -> dict:
    """The port's optimizer state from the reference's ``{m, v, count}``
    (moments in its parameter layout, an int32 count)."""
    device = resolve_device(device)
    count = state["count"]
    if not isinstance(count, torch.Tensor):
        count = torch.from_numpy(np.array(count))
    return {"m": from_reference_params(cfg, state["m"], device=device),
            "v": from_reference_params(cfg, state["v"], device=device),
            "count": count.to(device=device, dtype=torch.int32)}


def param_count(params) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel()
    return count(params)


# =============================================================== blocks
def _embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return take(params["embed"], tokens).to(dtype)


def _ffn(cfg, spec, lp, x, share=None):
    """The block's FFN residual: (x, aux). ``share``: a data rank's part
    of a microbatch that routes as one (``moe.RowShare``)."""
    if spec["ffn"] == "dense":
        return x + L.mlp_block(cfg, lp["mlp"],
                               L.rms_norm(x, lp["ln2"], cfg.norm_eps)), None
    if spec["ffn"] == "moe":
        y, aux = MOE.moe_block(cfg, lp["moe"],
                               L.rms_norm(x, lp["ln2"], cfg.norm_eps), share)
        return x + y, aux
    return x, None


def _apply_block(cfg, spec, lp, x, positions, memory, chunks=(512, 512),
                 share=None):
    """One pre-norm residual block over whole sequences. Returns (x, aux,
    the states it leaves for the cache)."""
    states = {}
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if spec["mixer"] == "attn":
        h, (states["k"], states["v"]) = L.attention_block(
            cfg, lp["attn"], h, positions, causal=True, window=cfg.window,
            q_chunk=chunks[0], kv_chunk=chunks[1], return_kv=True)
    else:
        h, (states["conv"], states["ssm"]) = SSM.mamba_block(
            cfg, lp["mamba"], h, chunk=cfg.ssd_chunk, return_state=True)
    x = x + h
    if spec["cross"]:
        h = L.rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        h, (states["ck"], states["cv"]) = L.cross_attention_block(
            cfg, lp["cross"], h, memory, return_kv=True)
        x = x + h
    x, aux = _ffn(cfg, spec, lp, x, share)
    return x, aux, states


def _blocks_fn(cfg, specs, lps, positions, memory, chunks, share=None):
    """(x, aux) -> (x, aux + the blocks' aux) through the blocks ``lps``,
    keeping no states: the function that remat checkpoints. The running
    aux goes through it, so that the sum's order is the one without
    remat."""
    def run(x, aux):
        for spec, lp in zip(specs, lps):
            x, a, _ = _apply_block(cfg, spec, lp, x, positions, memory,
                                   chunks, share)
            if a is not None:
                aux = aux + a
        return x, aux
    return run


def _run_blocks(cfg, params, x, positions, memory, *, remat=False,
                chunks=(512, 512), share=None):
    """Every layer over x; returns (x, aux summed over blocks, [states per
    layer]).

    remat, as in the reference: False | True / "group" (checkpoint each
    period group of layers, the reference's ``nothing_saveable`` policy on
    its scan body) | "block" (checkpoint every block: the backward's
    working set is one block, not a period group). Under remat the
    backward recomputes each checkpointed span from its input, and the
    states are not kept (training needs none): the list is empty. Without
    grad there is nothing to recompute, and remat is moot."""
    specs, layers = _specs(cfg), params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if remat and torch.is_grad_enabled():
        size = 1 if remat == "block" else cfg.period
        for s in range(0, len(layers), size):
            # the blocks draw no random numbers: no RNG state to replay
            x, aux = checkpoint(_blocks_fn(cfg, specs[s:s + size],
                                           layers[s:s + size], positions,
                                           memory, chunks, share),
                                x, aux, use_reentrant=False,
                                preserve_rng_state=False)
            if (s + size) % cfg.period == 0:
                x = constrain_activations(x)    # after each period group
        return x, aux, []
    states = []
    for i, (spec, lp) in enumerate(zip(specs, layers)):
        x, a, st = _apply_block(cfg, spec, lp, x, positions, memory, chunks,
                                share)
        if a is not None:
            aux = aux + a
        if (i + 1) % cfg.period == 0:
            x = constrain_activations(x)        # no-op outside a context
        states.append(st)
    return x, aux, states


# =============================================================== public api
def encode(cfg, params, memory: torch.Tensor, compute_dtype=torch.bfloat16):
    """The encoder stack over stub-frontend embeddings (audio): non-causal
    self attention with RoPE at arange(S), then the encoder's final
    norm."""
    x = memory.to(compute_dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    for lp in params["encoder"]["layers"]:
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + L.attention_block(cfg, lp["attn"], h, pos, causal=False)
        x = x + L.mlp_block(cfg, lp["mlp"],
                            L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    return L.rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def _memory(cfg, params, memory, compute_dtype):
    """Encoded memory for the encoder-decoder, cast memory otherwise."""
    if cfg.is_encoder_decoder:
        return encode(cfg, params, memory, compute_dtype)
    return None if memory is None else memory.to(compute_dtype)


def forward(cfg, params, tokens: torch.Tensor, memory=None, *,
            remat=True, compute_dtype=torch.bfloat16, chunks=(512, 512),
            share=None):
    """Training and prefill forward over whole sequences -> (hidden
    [B,S,D], aux loss), differentiable in the parameters. Logits are
    computed by the caller (chunked CE for training, the last token for
    serving). ``remat``: see ``_run_blocks``; ``chunks``: the attention's
    (q, kv) chunk sizes; ``share``: these rows are a data rank's part of a
    microbatch whose MoE layers route as one (``moe.RowShare``)."""
    x = _embed(params, tokens, compute_dtype)
    positions = torch.arange(tokens.shape[1], device=x.device)
    memory = _memory(cfg, params, memory, compute_dtype)
    x, aux, _ = _run_blocks(cfg, params, x, positions, memory, remat=remat,
                            chunks=chunks, share=share)
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
               memory_len: int = 0, device) -> dict:
    """Zeroed decode cache: per-row valid lengths and each state kind
    stacked over the layers that carry it (see the module's docstring).
    Mixtral's sliding window keeps a full-length cache and masks by
    window, as the reference does."""
    n = Counter(kind for slots in _slots(cfg) for kind in slots)
    cache = {"lengths": torch.zeros(batch, dtype=torch.int32, device=device)}
    kv = (cfg.n_kv_heads, cfg.hd)
    if n["attn"]:
        for name in ("k", "v"):
            cache[name] = torch.zeros((n["attn"], batch, max_len, *kv),
                                      dtype=dtype, device=device)
    if n["mamba"]:
        H, _, conv_dim = SSM.dims(cfg)
        cache["conv"] = torch.zeros((n["mamba"], batch, cfg.ssm_conv - 1,
                                     conv_dim), dtype=dtype, device=device)
        cache["ssm"] = torch.zeros((n["mamba"], batch, H, cfg.ssm_headdim,
                                    cfg.ssm_state), dtype=torch.float32,
                                   device=device)
    if n["cross"]:
        for name in ("ck", "cv"):
            cache[name] = torch.zeros((n["cross"], batch, memory_len, *kv),
                                      dtype=dtype, device=device)
    return cache


def prefill(cfg, params, tokens: torch.Tensor, memory=None, *,
            compute_dtype=torch.bfloat16, max_len: Optional[int] = None):
    """Run the prompt, build the decode cache. Returns (last_logits, cache)."""
    B, S = tokens.shape
    x = _embed(params, tokens, compute_dtype)
    positions = torch.arange(S, device=x.device)
    memory = _memory(cfg, params, memory, compute_dtype)
    x, _, states = _run_blocks(cfg, params, x, positions, memory)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache = init_cache(cfg, B, max_len or S, compute_dtype,
                       memory_len=0 if memory is None else memory.shape[1],
                       device=x.device)
    cache["lengths"].fill_(S)
    for slots, st in zip(_slots(cfg), states):
        for kind, i in slots.items():
            for name in STATE_KINDS[kind]:
                dst = cache[name][i]
                if name in ("k", "v"):
                    dst = dst[:, :S]
                dst.copy_(st[name])
    return logits_of(cfg, params, hidden[:, -1:])[:, 0], cache


def prefill_continue(cfg, params, tokens: torch.Tensor, cache: dict,
                     start: int, *, compute_dtype=torch.bfloat16):
    """Continue a prefill from position ``start`` (prefix pages already in
    the cache): the serving path behind prefix reuse, for pageable
    (pure-attention) archs only, as in the reference. Writes the new K/V
    into ``cache`` in place."""
    if cfg.family not in PAGEABLE_FAMILIES:
        raise ValueError("prefix-continue requires a pageable "
                         f"(pure-attention) arch, got {cfg.family}")
    B, St = tokens.shape
    x = _embed(params, tokens, compute_dtype)
    positions = start + torch.arange(St, device=x.device)
    for i, (spec, lp) in enumerate(zip(_specs(cfg), params["layers"])):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        k1, v1 = L._project_qkv(cfg, lp["attn"], h, h, positions, positions,
                                use_rope=True)[1:]
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, start:start + St] = k1
        vc[:, start:start + St] = v1
        x = x + L.append_attention(cfg, lp["attn"], h, kc, vc, start,
                                   window=cfg.window)
        x, _ = _ffn(cfg, spec, lp, x)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_of(cfg, params, hidden[:, -1:])[:, 0]
    return logits, dict(cache, lengths=torch.full_like(cache["lengths"],
                                                       start + St))


def decode_step(cfg, params, token: torch.Tensor, cache: dict, *,
                compute_dtype=torch.bfloat16):
    """One token for every sequence. token: [B] int. Returns (logits
    [B, V], cache). Ragged lengths per row: row b writes its K/V at
    ``min(lengths[b], max_len - 1)``; K/V and the mamba states are
    written in place, with no host sync."""
    B = token.shape[0]
    lengths = cache["lengths"]                      # valid BEFORE this step
    x = _embed(params, token, compute_dtype)[:, None]
    valid = lengths + 1
    if "k" in cache:
        kv_len = cache["k"].shape[2]
        wpos = lengths.clamp_max(kv_len - 1).long()
        at = wpos.view(B, 1, 1, 1).expand(B, 1, cfg.n_kv_heads, cfg.hd)
    for spec, slots, lp in zip(_specs(cfg), _slots(cfg), params["layers"]):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if spec["mixer"] == "attn":
            i = slots["attn"]
            k1, v1 = L.project_kv_token(cfg, lp["attn"], h, lengths)
            kc, vc = cache["k"][i], cache["v"][i]
            kc.scatter_(1, at, k1.to(kc.dtype))
            vc.scatter_(1, at, v1.to(vc.dtype))
            h = L.decode_attention(cfg, lp["attn"], h, kc, vc, valid, lengths)
        else:
            j = slots["mamba"]
            h, (conv_s, ssm_s) = SSM.mamba_block(
                cfg, lp["mamba"], h, conv_state=cache["conv"][j],
                ssm_state=cache["ssm"][j], return_state=True)
            cache["conv"][j].copy_(conv_s)
            cache["ssm"][j].copy_(ssm_s)
        x = x + h
        if spec["cross"]:
            c = slots["cross"]
            h = L.rms_norm(x, lp["ln_cross"], cfg.norm_eps)
            x = x + L.cross_attention_block(cfg, lp["cross"], h, None,
                                            kv=(cache["ck"][c],
                                                cache["cv"][c]))
        x, _ = _ffn(cfg, spec, lp, x)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_of(cfg, params, hidden)[:, 0]
    return logits, dict(cache, lengths=valid)


def to_reference_cache(cfg, cache: dict) -> dict:
    """The cache in the reference's layout, as numpy: ``{"lengths",
    "layers": {"p{i}": {name: [repeats, B, ...]}}}``."""
    layers = {}
    period = cfg.period
    for l, slots in enumerate(_slots(cfg)):
        ent = layers.setdefault(f"p{l % period}", {})
        for kind, i in slots.items():
            for name in STATE_KINDS[kind]:
                ent.setdefault(name, []).append(cache[name][i].cpu().numpy())
    return {"lengths": cache["lengths"].cpu().numpy(),
            "layers": {p: {n: np.stack(v) for n, v in ent.items()}
                       for p, ent in layers.items()}}
