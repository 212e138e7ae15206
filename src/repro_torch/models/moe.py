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

Under data parallelism (``RowShare``) a microbatch's rows lie on several
ranks, but the reference routes the whole microbatch as one: each rank
gathers the router logits of every row, plans the global dispatch, and
runs the experts only on the pairs its own rows keep.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

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


@dataclass(frozen=True)
class RowShare:
    """A data rank's part of a microbatch that routes as one: this rank's
    rows are block ``index`` of ``ranks`` equal blocks in the microbatch's
    row order, and ``gather`` all-gathers a ``[T_rank, ...]`` tensor into
    ``[T, ...]`` in that order, differentiably (its backward sums the
    ranks' grads and keeps this rank's block)."""
    gather: Callable[[torch.Tensor], torch.Tensor]
    index: int
    ranks: int


def _groups(cfg, T: int) -> tuple:
    """(groups G, tokens a group Tg, capacity C an expert and a group) of
    a microbatch of T tokens: ``cfg.moe_groups``, one group where T does
    not divide."""
    G = max(getattr(cfg, "moe_groups", 1), 1)
    if T % G:
        G = 1
    Tg = T // G
    return G, Tg, max(int(Tg * cfg.topk / cfg.n_experts
                          * cfg.capacity_factor), 1)


def _swiglu_slots(p: dict, grouped: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its slots [E, n, D], one batched product
    a weight."""
    dt = grouped.dtype
    h = F.silu(torch.bmm(grouped, p["w_gate"].to(dt))) \
        * torch.bmm(grouped, p["w_up"].to(dt))
    return torch.bmm(h, p["w_down"].to(dt))


def _load_balance(logits: torch.Tensor, gate_i: torch.Tensor, E: int):
    """Switch-style load balance loss over every row of ``logits``."""
    probs = torch.softmax(logits, dim=-1)
    routed = (gate_i[..., None] == torch.arange(E, device=logits.device)
              ).any(1)
    return E * torch.sum(routed.float().mean(0) * probs.mean(0))


def moe_block(cfg, p: dict, x: torch.Tensor, share: RowShare | None = None):
    """x: [B, S, D] -> ([B, S, D], aux loss). Routing and dispatch in f32.

    ``cfg.moe_groups`` > 1: GShard-style grouped dispatch, the argsort and
    capacity machinery run independently inside each group of T/G tokens
    with capacity per group; T % G != 0 (decode at B < G) falls back to one
    group, as the reference does. With ``share``, x is one data rank's
    block of a microbatch that routes as one (``_moe_shared``)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.topk
    T = B * S
    xt = x.reshape(T, D)
    logits = (xt @ p["router"].to(x.dtype)).float()
    if share is not None:
        y, aux = _moe_shared(cfg, p, xt, logits, share)
    else:
        G, Tg, C = _groups(cfg, T)                             # C per group
        gate_v, gate_i = tournament_topk(logits, k)            # [T, k]
        weights = torch.softmax(gate_v, dim=-1)                # mixtral renorm

        slot_of, token_of_slot = _dispatch_slots(gate_i.reshape(G, Tg * k),
                                                 E, C)
        # gather tokens into [E, G*C, D] (an empty slot reads the zero row)
        xp = torch.cat([xt.reshape(G, Tg, D), xt.new_zeros(G, 1, D)], dim=1)
        src = torch.clamp_max(token_of_slot.long() // k, Tg)   # [G, E*C]
        grouped = torch.gather(xp, 1, src[..., None].expand(G, E * C, D))
        grouped = grouped.view(G, E, C, D).transpose(0, 1).reshape(
            E, G * C, D)
        y_grouped = _swiglu_slots(p, grouped)                  # [E, G*C, D]

        # scatter back: each routed pair reads its slot (dropped -> zero row)
        y_flat = torch.cat([
            y_grouped.view(E, G, C, D).transpose(0, 1).reshape(G, E * C, D),
            y_grouped.new_zeros(G, 1, D)], dim=1)
        per_pair = torch.gather(y_flat, 1, slot_of.long()[..., None].expand(
            G, Tg * k, D)).reshape(T, k, D)
        y = torch.sum(per_pair * weights[..., None].to(x.dtype), dim=1)
        aux = _load_balance(logits, gate_i, E)

    if cfg.shared_expert:
        sp = p["shared"]
        hs = F.silu(xt @ sp["w_gate"].to(x.dtype)) * (xt @ sp["w_up"].to(x.dtype))
        y = y + hs @ sp["w_down"].to(x.dtype)
    return y.reshape(B, S, D), aux


def _moe_shared(cfg, p: dict, xt: torch.Tensor, logits: torch.Tensor,
                share: RowShare):
    """The routed experts' (y, aux) of this rank's ``T_r`` rows of a
    microbatch of ``T = T_r * ranks`` rows, as ``moe_block`` gives them
    on the whole microbatch. Every rank gathers the router logits of all
    T rows and plans the global dispatch (top-k, capacity C from T, each
    pair's slot in global row order, the drops); the aux is then the
    whole microbatch's on every rank. The experts run only on this rank's
    kept pairs, packed by a local dispatch whose capacity holds every one
    of them: an expert keeps at most C pairs a group and one a row."""
    Tr, D = xt.shape
    E, k = cfg.n_experts, cfg.topk
    T = Tr * share.ranks
    G, Tg, C = _groups(cfg, T)
    glogits = share.gather(logits)                         # [T, E]
    gate_v, gate_i = tournament_topk(glogits, k)
    slot_of, _ = _dispatch_slots(gate_i.reshape(G, Tg * k), E, C)
    mine = slice(share.index * Tr, (share.index + 1) * Tr)
    kept = slot_of.reshape(T, k)[mine] < E * C
    weights = torch.softmax(gate_v[mine], dim=-1)
    # dropped pairs go to bucket E, which no expert reads
    own_e = torch.where(kept, gate_i[mine], E).reshape(1, Tr * k)
    groups_touched = (mine.stop - 1) // Tg - mine.start // Tg + 1
    Cl = min(C * groups_touched, Tr)
    lslot, ltoken = _dispatch_slots(own_e, E + 1, Cl)
    xp = torch.cat([xt, xt.new_zeros(1, D)])
    src = torch.clamp_max(ltoken[0, :E * Cl].long() // k, Tr)
    y_grouped = _swiglu_slots(p, xp[src].view(E, Cl, D))   # [E, Cl, D]
    y_flat = torch.cat([y_grouped.reshape(E * Cl, D),
                        y_grouped.new_zeros(1, D)])
    per_pair = y_flat[torch.clamp_max(lslot[0].long(), E * Cl)].view(Tr, k, D)
    y = torch.sum(per_pair * weights[..., None].to(xt.dtype), dim=1)
    return y, _load_balance(glogits, gate_i, E)
