"""Mixture-of-experts FFN with capacity-based gather/scatter dispatch
(PyTorch port of ``repro/models/moe.py``).

Routing top-k is a tournament (iterated wide argmax, ties to the lowest
index, as ``lax.top_k`` breaks them). Dispatch materialises each expert's
token slots as integer indices: a stable argsort of the routed expert
ids, bucket starts from ``searchsorted``, capacity ``C`` slots an expert
and a group, pairs past it dropped (to the slot ``E*C``, whose output row
is zero). Every expert then runs its SwiGLU on its ``C`` slots as one
batched matrix product. Capacity comes from static shapes, and nothing in
the routing or the dispatch reads a device value on the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _dense_init


def tournament_topk(scores: torch.Tensor, k: int):
    """Top-k over the last axis by iterated argmax (ties -> lowest index,
    matching ``lax.top_k``). scores: [..., E]. Returns (values, int32
    indices), each [..., k]."""
    vals, idxs = [], []
    s = scores
    for _ in range(k):
        i = torch.argmax(s, dim=-1, keepdim=True)
        vals.append(torch.gather(s, -1, i))
        idxs.append(i)
        s = s.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1).to(torch.int32)


def init_moe(cfg, gen: torch.Generator, device) -> dict:
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": _dense_init(gen, (D, E), device),
        "w_gate": _dense_init(gen, (E, D, F_), device, fan_in=D),
        "w_up": _dense_init(gen, (E, D, F_), device, fan_in=D),
        "w_down": _dense_init(gen, (E, F_, D), device, fan_in=F_),
    }
    if cfg.shared_expert:
        p["shared"] = {
            "w_gate": _dense_init(gen, (D, F_), device),
            "w_up": _dense_init(gen, (D, F_), device),
            "w_down": _dense_init(gen, (F_, D), device),
        }
    return p


def _dispatch_slots(expert_ids: torch.Tensor, E: int, C: int):
    """expert_ids: [..., Tk] flattened (token, k) assignments, one row a
    group. Returns slot_of [..., Tk] in [0, E*C] (E*C = dropped) and
    token_of_slot [..., E*C] (Tk where a slot is empty), both int32."""
    Tk = expert_ids.shape[-1]
    lead = expert_ids.shape[:-1]
    e = expert_ids.long()
    order = torch.argsort(e, dim=-1, stable=True)
    sorted_e = torch.gather(e, -1, order)
    # position of each routed pair within its expert bucket
    experts = torch.arange(E, device=e.device).expand(*lead, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts)
    pos = torch.arange(Tk, device=e.device) - torch.gather(starts, -1,
                                                           sorted_e)
    slot_sorted = torch.where(pos < C, sorted_e * C + pos, E * C)
    slot_of = torch.empty_like(slot_sorted).scatter_(-1, order, slot_sorted)
    # only the cut slot E*C takes duplicate indices
    token_of_slot = torch.full((*lead, E * C + 1), Tk, dtype=torch.long,
                               device=e.device).scatter_(-1, slot_sorted,
                                                         order)
    return slot_of.to(torch.int32), token_of_slot[..., :E * C].to(torch.int32)


def moe_block(cfg, p: dict, x: torch.Tensor):
    """x: [B, S, D] -> ([B, S, D], aux loss). Routing and dispatch in f32.

    ``cfg.moe_groups`` > 1: GShard-style grouped dispatch, the argsort and
    capacity machinery run independently inside each group of T/G tokens
    with capacity per group; T % G != 0 (decode at B < G) falls back to one
    group, as the reference does."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.topk
    T = B * S
    G = max(getattr(cfg, "moe_groups", 1), 1)
    if T % G:
        G = 1
    Tg = T // G
    xt = x.reshape(T, D)
    logits = (xt @ p["router"].to(x.dtype)).float()
    gate_v, gate_i = tournament_topk(logits, k)            # [T, k]
    weights = torch.softmax(gate_v, dim=-1)                # mixtral renorm
    C = max(int(Tg * k / E * cfg.capacity_factor), 1)      # per group

    slot_of, token_of_slot = _dispatch_slots(gate_i.reshape(G, Tg * k), E, C)
    # gather tokens into [E, G*C, D] (an empty slot reads the zero row Tg)
    xp = torch.cat([xt.reshape(G, Tg, D), xt.new_zeros(G, 1, D)], dim=1)
    src = torch.clamp_max(token_of_slot.long() // k, Tg)   # [G, E*C]
    grouped = torch.gather(xp, 1, src[..., None].expand(G, E * C, D))
    grouped = grouped.view(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    # every expert's SwiGLU on its slots, one batched product a weight
    h = F.silu(torch.bmm(grouped, p["w_gate"].to(x.dtype))) \
        * torch.bmm(grouped, p["w_up"].to(x.dtype))
    y_grouped = torch.bmm(h, p["w_down"].to(x.dtype))       # [E, G*C, D]

    # scatter back: each routed pair reads its slot (dropped -> zero row)
    y_flat = torch.cat([
        y_grouped.view(E, G, C, D).transpose(0, 1).reshape(G, E * C, D),
        y_grouped.new_zeros(G, 1, D)], dim=1)
    per_pair = torch.gather(y_flat, 1, slot_of.long()[..., None].expand(
        G, Tg * k, D)).reshape(T, k, D)
    y = torch.sum(per_pair * weights[..., None].to(x.dtype), dim=1)

    if cfg.shared_expert:
        sp = p["shared"]
        hs = F.silu(xt @ sp["w_gate"].to(x.dtype)) * (xt @ sp["w_up"].to(x.dtype))
        y = y + hs @ sp["w_down"].to(x.dtype)

    # switch-style load balance loss
    probs = torch.softmax(logits, dim=-1)
    routed = (gate_i[..., None] == torch.arange(E, device=x.device)).any(1)
    frac_routed = routed.float().mean(0)
    aux = E * torch.sum(frac_routed * probs.mean(0))
    return y.reshape(B, S, D), aux
