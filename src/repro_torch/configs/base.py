"""Architecture config schema and registry (PyTorch port of
``repro/configs/base.py``, copied so the port imports nothing of the
reference).

One file per architecture lives next to this module, each a copy of the
reference's; ``get_config`` resolves every id of ``ARCH_IDS``.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass
from typing import Optional

ARCH_IDS = (
    "stablelm-12b", "minicpm-2b", "qwen3-0.6b", "nemotron-4-340b",
    "llama4-scout-17b-a16e", "mixtral-8x7b", "mamba2-370m",
    "llama-3.2-vision-11b", "whisper-small", "jamba-v0.1-52b",
    "nitrogen-db",           # the paper's own workload as a config
)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | vlm | audio | hybrid | index
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # attention flavor
    qk_norm: bool = False
    window: Optional[int] = None          # sliding-window attention
    mlp_act: str = "swiglu"               # swiglu | gelu | sqrelu
    # mixture of experts
    n_experts: int = 0
    topk: int = 0
    shared_expert: bool = False
    moe_every: int = 1                    # MoE on layers with i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1                   # GShard grouped dispatch (perf knob)
    # state space (mamba2)
    ssm_state: int = 0                    # N
    ssm_headdim: int = 64                 # P
    ssm_groups: int = 1                   # G
    ssm_conv: int = 4
    ssd_chunk: int = 256                  # SSD chunk length (perf knob)
    # hybrid interleave (jamba): one attn layer per `attn_every`
    attn_every: int = 0
    attn_index: int = 3
    # multimodal cross attention
    cross_attn_every: int = 0
    cross_attn_index: int = 3
    encoder_layers: int = 0
    encoder_seq: int = 0                  # stub-frontend sequence length
    is_encoder_decoder: bool = False
    # misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    schedule: str = "cosine"              # minicpm: "wsd"
    tie_embeddings: bool = False
    # long-context applicability: pure full-attn archs skip long_500k
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/logit tables pad the vocab to a 512 multiple so they
        shard on any production mesh axis (jit rejects uneven input
        shardings); padded logit columns are masked to -inf everywhere."""
        return -(-self.vocab // 512) * 512

    @property
    def period(self) -> int:
        """Layer-pattern period: the scan over layers runs in groups of this."""
        p = 1
        if self.family == "hybrid" and self.attn_every:
            p = math.lcm(p, self.attn_every)
        if self.cross_attn_every:
            p = math.lcm(p, self.cross_attn_every)
        if self.moe_every > 1:
            p = math.lcm(p, self.moe_every)
        return p

    @property
    def repeats(self) -> int:
        assert self.n_layers % self.period == 0, (self.name, self.n_layers, self.period)
        return self.n_layers // self.period

    def layer_spec(self, i: int) -> dict:
        """Resolved block structure for layer i (within a pattern period)."""
        if self.family == "ssm":
            mixer = "mamba"
        elif self.family == "hybrid":
            mixer = "attn" if (self.attn_every and i % self.attn_every == self.attn_index) else "mamba"
        else:
            mixer = "attn"
        cross = bool(
            self.is_encoder_decoder
            or (self.cross_attn_every and i % self.cross_attn_every == self.cross_attn_index)
        )
        if self.n_experts and (i % self.moe_every == self.moe_offset):
            ffn = "moe"
        elif self.family == "ssm":
            ffn = "none"                    # mamba2 block has no separate FFN
        else:
            ffn = "dense"
        return {"mixer": mixer, "cross": cross, "ffn": ffn}

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        period = self.period
        small = dict(
            n_layers=period * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            head_dim=16,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            # ample capacity: smoke tests check prefill==decode==forward,
            # which only holds when no token is dropped
            capacity_factor=8.0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=8 if self.ssm_state else 64,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=24 if self.encoder_seq else 0,
            window=min(self.window, 16) if self.window else None,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


_MODULE_OF = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULE_OF:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULE_OF)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[arch_id]}")
    return mod.CONFIG


# ---- input shapes assigned to the LM pool (seq_len, global_batch) ----------
SHAPES = {
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(applicable, reason-if-not). Skips recorded per DESIGN.md §5."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "pure full attention at 524k context (see DESIGN.md §5)"
    if cfg.family == "index":
        return False, "index-search workload has its own benchmark shapes"
    return True, ""
