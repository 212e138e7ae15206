"""Chunked (flash) attention with its backward, and plain masked attention
(PyTorch port of ``repro/models/flash_attention.py``).

The reference is plain JAX, not Pallas: an online-softmax scan over q and
kv chunks with a custom VJP that recomputes the scores chunk by chunk, so
that training at long context holds O(S * chunk) activations, never the
[Sq, Skv] scores. ``flash_attention`` is that algorithm as a
``torch.autograd.Function``: float32 scores, softmax statistics and
accumulators (bf16 inputs are widened, which keeps their products exact),
the sequence padded to the chunk multiple, the reference's additive
``NEG_INF`` bias for the causal and sliding-window masks and the padding.
The backward recomputes each block's probabilities from the saved
log-sum-exp, with ``delta = sum(dout * out)``. A block that the mask covers
whole adds exactly zero to every sum, so it is skipped: under a causal
mask about half of them.

``masked_attention`` is the plain version (the f32 scores and softmax of
the reference's ``attention_reference`` under any bool mask): decode and
the prefix-continue path use it, and the tests hold the chunked form to
it. ``attend``, the model layers' entry, takes the chunked form where a
backward will run through it (training, whose memory the chunks bound)
and the plain form elsewhere: serving keeps the answers it has given
since the port began (the same function, to float32 rounding).

Shapes: q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D]; Hq % Hkv == 0.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               k_valid: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """[Cq, Ck] additive bias: 0 where attending, NEG_INF where masked."""
    ok = k_valid[None, :].expand(q_pos.shape[0], k_pos.shape[0])
    if causal:
        ok = ok & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
    return torch.where(ok, 0.0, NEG_INF)


def _mask_ok(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    """[Sq, Skv] bool: True where attending (``_mask_bias`` is 0 there)."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
    return ok


def _check_causal(causal: bool, Sq: int, Skv: int) -> None:
    if causal and Sq != Skv:
        raise ValueError("causal flash attention requires Sq == Skv; "
                         "decode uses serve-side attention")


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


def attention_reference(q, k, v, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(S^2) oracle (tests only), the reference's of the same
    name."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    sc = (D ** -0.5) if scale is None else scale
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * sc
    s = s + _mask_bias(torch.arange(Sq, device=q.device),
                       torch.arange(Skv, device=q.device),
                       torch.ones(Skv, dtype=torch.bool, device=q.device),
                       causal, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


# ------------------------------------------------------------------ chunked
class _Blocks:
    """The chunk grid of one call: sizes, the padded float32 layouts
    ([B, Hkv, G, S, D] for q-shaped tensors, [B, Hkv, S, D] for k/v) and
    each (q chunk, kv chunk) block's mask bias, None for a block the mask
    covers whole."""

    def __init__(self, q, k, causal, window, q_chunk, kv_chunk, scale):
        B, Sq, Hq, D = q.shape
        _, Skv, Hkv, _ = k.shape
        _check_causal(causal, Sq, Skv)
        self.B, self.Hkv, self.G, self.D = B, Hkv, Hq // Hkv, D
        self.Sq, self.Skv = Sq, Skv
        self.qck, self.kck = min(q_chunk, Sq), min(kv_chunk, Skv)
        self.nq, self.nk = -(-Sq // self.qck), -(-Skv // self.kck)
        self.causal, self.window = causal, window
        self.scale = (D ** -0.5) if scale is None else scale
        self.device = q.device

    def q_layout(self, x: torch.Tensor) -> torch.Tensor:
        """[B, Sq, Hq, D] -> float32 [B, Hkv, G, nq*qck, D], zero padded."""
        x = F.pad(x.float(), (0, 0, 0, 0, 0, self.nq * self.qck - self.Sq))
        return x.view(self.B, -1, self.Hkv, self.G, self.D) \
            .permute(0, 2, 3, 1, 4).contiguous()

    def kv_layout(self, x: torch.Tensor) -> torch.Tensor:
        """[B, Skv, Hkv, D] -> float32 [B, Hkv, nk*kck, D], zero padded."""
        x = F.pad(x.float(), (0, 0, 0, 0, 0, self.nk * self.kck - self.Skv))
        return x.permute(0, 2, 1, 3).contiguous()

    def q_back(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """The inverse of q_layout, cut to Sq and cast."""
        return x.permute(0, 3, 1, 2, 4).reshape(
            self.B, -1, self.Hkv * self.G, self.D)[:, :self.Sq].to(dtype)

    def kv_back(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return x.permute(0, 2, 1, 3)[:, :self.Skv].to(dtype)

    def qs(self, i: int) -> slice:
        return slice(i * self.qck, (i + 1) * self.qck)

    def ks(self, j: int) -> slice:
        return slice(j * self.kck, (j + 1) * self.kck)

    def bias(self, i: int, j: int) -> Optional[torch.Tensor]:
        q0, k0 = i * self.qck, j * self.kck
        q1, k1 = q0 + self.qck - 1, k0 + self.kck - 1
        if self.causal and k0 > q1:
            return None
        if self.window is not None and q0 - k1 >= self.window:
            return None
        pos = torch.arange(max(q1, k1) + 1, device=self.device)
        k_pos = pos[k0:k1 + 1]
        return _mask_bias(pos[q0:q1 + 1], k_pos, k_pos < self.Skv,
                          self.causal, self.window)

    def scores(self, qi, kj, bias) -> torch.Tensor:
        """[B, Hkv, G, Cq, Ck] float32 scores of one block, biased."""
        return torch.einsum("bhgqd,bhkd->bhgqk", qi, kj) * self.scale + bias


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk, scale):
        blk = _Blocks(q, k, causal, window, q_chunk, kv_chunk, scale)
        qf, kf, vf = blk.q_layout(q), blk.kv_layout(k), blk.kv_layout(v)
        out = torch.empty_like(qf)
        lse = torch.empty(qf.shape[:-1], dtype=torch.float32,
                          device=q.device)
        for i in range(blk.nq):
            qi = qf[..., blk.qs(i), :]
            m = torch.full(qi.shape[:-1], NEG_INF, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros_like(qi)
            for j in range(blk.nk):
                bias = blk.bias(i, j)
                if bias is None:
                    continue
                s = blk.scores(qi, kf[:, :, blk.ks(j)], bias)
                m2 = torch.maximum(m, s.amax(dim=-1))
                m_safe = torch.where(m2 <= NEG_INF, 0.0, m2)
                corr = torch.exp(m - m_safe)
                p = torch.exp(s - m_safe[..., None])
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bhgqk,bhkd->bhgqd", p, vf[:, :, blk.ks(j)])
                m = m2
            l = torch.clamp(l, min=1e-30)
            out[..., blk.qs(i), :] = acc / l[..., None]
            lse[..., blk.qs(i)] = m + torch.log(l)
        out = blk.q_back(out, q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_chunk, kv_chunk, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        blk = _Blocks(q, k, *ctx.args)
        qf, kf, vf = blk.q_layout(q), blk.kv_layout(k), blk.kv_layout(v)
        do = blk.q_layout(dout)
        delta = (do * blk.q_layout(out)).sum(dim=-1)       # [B,Hkv,G,Sq]
        dq = torch.zeros_like(qf)
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
        for j in range(blk.nk):
            kj, vj = kf[:, :, blk.ks(j)], vf[:, :, blk.ks(j)]
            dkj, dvj = dk[:, :, blk.ks(j)], dv[:, :, blk.ks(j)]
            for i in range(blk.nq):
                bias = blk.bias(i, j)
                if bias is None:
                    continue
                qi, doi = qf[..., blk.qs(i), :], do[..., blk.qs(i), :]
                s = blk.scores(qi, kj, bias)
                p = torch.exp(s - lse[..., blk.qs(i), None])
                dvj += torch.einsum("bhgqk,bhgqd->bhkd", p, doi)
                dp = torch.einsum("bhgqd,bhkd->bhgqk", doi, vj)
                ds = p * (dp - delta[..., blk.qs(i), None]) * blk.scale
                dkj += torch.einsum("bhgqk,bhgqd->bhkd", ds, qi)
                dq[..., blk.qs(i), :] += torch.einsum(
                    "bhgqk,bhkd->bhgqd", ds, kj)
        return (blk.q_back(dq, q.dtype), blk.kv_back(dk, k.dtype),
                blk.kv_back(dv, v.dtype), None, None, None, None, None)


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None, q_chunk: int = 512,
                    kv_chunk: int = 512,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q over k/v, chunked (see the module's docstring);
    differentiable in q, k and v. Returns [B, Sq, Hq, D] in q's dtype."""
    return _FlashAttention.apply(q, k, v, causal, window, q_chunk,
                                 kv_chunk, scale)


def attend(q, k, v, causal: bool = True, window: Optional[int] = None,
           q_chunk: int = 512, kv_chunk: int = 512) -> torch.Tensor:
    """Attention as the model layers run it: ``flash_attention`` when a
    backward will run through it, else the plain masked form."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_attention(q, k, v, causal, window, q_chunk, kv_chunk)
    Sq, Skv = q.shape[1], k.shape[1]
    _check_causal(causal, Sq, Skv)
    ok = _mask_ok(torch.arange(Sq, device=q.device),
                  torch.arange(Skv, device=q.device), causal, window)
    return masked_attention(q, k, v, ok[None])
