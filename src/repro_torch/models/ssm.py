"""Mamba2 block: the SSD (state-space duality) chunked scan and the decode
recurrence (PyTorch port of ``repro/models/ssm.py``).

Recurrence per head h (state N, head dim P):
    h_t = a_t * h_{t-1} + dt_t * (B_t outer x_t)        a_t = exp(-exp(A_log) dt_t)
    y_t = C_t . h_t + D * x_t
SSD form: the sequence is chunked; within a chunk the contribution is a
masked quadratic form (the "attention-like" dual), across chunks a loop
over the chunks carries the [H, P, N] state in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _dense_init, rms_norm


def dims(cfg):
    H = cfg.d_model * 2 // cfg.ssm_headdim          # expand factor 2
    d_inner = H * cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return H, d_inner, conv_dim


def init_mamba(cfg, gen: torch.Generator, device) -> dict:
    H, d_inner, conv_dim = dims(cfg)
    d_in_proj = 2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _dense_init(gen, (cfg.d_model, d_in_proj), device),
        "conv_w": torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                              **f32).mul_(0.2),
        "A_log": torch.zeros(H, **f32),              # A = -exp(A_log) = -1
        "D": torch.ones(H, **f32),
        "dt_bias": torch.full((H,), -2.0, **f32),    # softplus(-2) ~ 0.12
        "gate_norm": torch.ones(d_inner, **f32),
        "out_proj": _dense_init(gen, (d_inner, cfg.d_model), device),
    }


def _causal_conv(xbc, w, state=None):
    """Depthwise causal conv, kernel k. xbc: [B, S, C]; state: [B, k-1, C]
    (the decode carry, in the cache's dtype). Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        state = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    full = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    S = xbc.shape[1]
    y = sum(full[:, i: i + S] * w[i][None, None, :].to(xbc.dtype)
            for i in range(k))
    return F.silu(y), full[:, full.shape[1] - (k - 1):]


def _split_proj(cfg, zxbcdt):
    H, d_inner, _ = dims(cfg)
    GN = cfg.ssm_groups * cfg.ssm_state
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * GN]
    dt = zxbcdt[..., 2 * d_inner + 2 * GN:]
    return z, xbc, dt


def _expand_heads(t, H):
    """[B,...,G,N] -> [B,...,H,N]: head h reads group h // (H//G)."""
    G = t.shape[-2]
    if G == H:
        return t
    return t.unsqueeze(-2).expand(*t.shape[:-1], H // G, t.shape[-1]) \
        .reshape(*t.shape[:-2], H, t.shape[-1])


def ssd_chunked(x, a_log, dt, B_, C_, chunk: int, h0=None):
    """x: [B,S,H,P]; a_log: [B,S,H] (log decay, <=0); dt: [B,S,H];
    B_, C_: [B,S,G,N]. Returns (y [B,S,H,P] f32, h_final [B,H,P,N] f32)."""
    Bb, S, H, P = x.shape
    N = B_.shape[3]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    nc, cs = S // chunk, chunk

    def resh(t):
        return t.reshape((Bb, nc, cs) + tuple(t.shape[2:]))

    xc = resh(x).float()
    ac, dtc = resh(a_log), resh(dt)
    Bh = _expand_heads(resh(B_), H).float()               # [B,nc,cs,H,N]
    Ch = _expand_heads(resh(C_), H).float()
    cum = torch.cumsum(ac, dim=2)                         # [B,nc,cs,H]

    # intra-chunk (the quadratic dual):
    #   y_t += sum_{s<=t} exp(cum_t - cum_s) dt_s (C_t . B_s) x_s
    # the upper triangle's exp may overflow to inf: masked by a select,
    # not a multiply (inf * 0 is NaN), and before the exp as well, so that
    # the backward's exp' * 0 is no inf * 0 either
    CB = torch.einsum("bcthn,bcshn->bchts", Ch, Bh)       # [B,nc,H,cs,cs]
    q_cum = cum.permute(0, 1, 3, 2)                       # [B,nc,H,cs]
    mask = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                 device=x.device))
    decay = torch.exp(torch.where(
        mask, q_cum[..., :, None] - q_cum[..., None, :], float("-inf")))
    M = torch.where(mask, CB * decay, 0.0)
    M = M * dtc.permute(0, 1, 3, 2)[..., None, :]         # * dt_s
    y_intra = torch.einsum("bchts,bcshp->bcthp", M, xc)

    # per-chunk boundary state: sum_s exp(cum_T - cum_s) dt_s (B_s outer x_s)
    last = cum[:, :, -1:, :]                              # [B,nc,1,H]
    w = torch.exp(last - cum) * dtc                       # [B,nc,cs,H]
    states = torch.einsum("bcsh,bcshn,bcshp->bchpn", w, Bh, xc)
    chunk_decay = torch.exp(last[:, :, 0, :])             # [B,nc,H]

    # the carried state: h_prev of chunk c, then h after it
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                 # [B,nc,H,P,N]

    # inter-chunk: y_t += exp(cum_t) * (C_t . h_prev)
    y_inter = torch.einsum("bcthn,bchpn->bcthp", Ch, h_prevs) \
        * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(Bb, S, H, P), h


def mamba_block(cfg, p, x, conv_state=None, ssm_state=None, chunk=256,
                return_state=False):
    """Full mamba2 mixer. x: [B,S,D]. For decode pass S == 1 with states;
    the SSM state stays float32 throughout."""
    H, d_inner, conv_dim = dims(cfg)
    P, G, N = cfg.ssm_headdim, cfg.ssm_groups, cfg.ssm_state
    B_, S, _ = x.shape
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    decode = S == 1 and ssm_state is not None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], conv_state)
    xs = xbc[..., :d_inner].reshape(B_, S, H, P)
    Bmat = xbc[..., d_inner: d_inner + G * N].reshape(B_, S, G, N)
    Cmat = xbc[..., d_inner + G * N:].reshape(B_, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])                      # [B,S,H]
    a_log = -torch.exp(p["A_log"])[None, None, :] * dt              # [B,S,H]

    if decode:
        a = torch.exp(a_log[:, 0])                                  # [B,H]
        Bh = _expand_heads(Bmat[:, 0], H).float()                   # [B,H,N]
        Ch = _expand_heads(Cmat[:, 0], H).float()
        upd = (dt[:, 0, :, None, None] * Bh[:, :, None, :]
               * xs[:, 0, :, :, None].float())
        h_final = ssm_state * a[..., None, None] + upd
        y = torch.einsum("bhn,bhpn->bhp", Ch, h_final)
        y = y[:, None] + p["D"][None, None, :, None] * xs.float()
    else:
        # padded positions carry a_log = dt = 0: they leave the state alone
        pad = (-S) % chunk
        xs_p, a_p, dt_p, B_p, C_p = xs, a_log, dt, Bmat, Cmat
        if pad:
            xs_p, B_p, C_p = (F.pad(t, (0, 0, 0, 0, 0, pad))
                              for t in (xs, Bmat, Cmat))
            a_p, dt_p = (F.pad(t, (0, 0, 0, pad)) for t in (a_log, dt))
        y, h_final = ssd_chunked(xs_p, a_p, dt_p, B_p, C_p,
                                 min(chunk, xs_p.shape[1]), h0=ssm_state)
        y = y[:, :S] + p["D"][None, None, :, None] * xs.float()

    y = y.reshape(B_, S, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["gate_norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, (new_conv, h_final)
    return out


def naive_recurrence(x, a_log, dt, B_, C_, h0=None):
    """O(S) per-step oracle for tests. Same shapes as ssd_chunked."""
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    h = torch.zeros((Bb, H, P, N), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    ys = []
    for t in range(S):
        a = torch.exp(a_log[:, t])                                 # [B,H]
        Bh = _expand_heads(B_[:, t], H)
        Ch = _expand_heads(C_[:, t], H)
        h = h * a[..., None, None] + (dt[:, t, :, None, None]
                                      * Bh[:, :, None, :] * x[:, t, :, :, None])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch, h))
    return torch.stack(ys, dim=1), h
