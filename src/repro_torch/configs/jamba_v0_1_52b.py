"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave (1 attn layer per 8),
MoE every other layer.  [arXiv:2403.19887; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, mlp_act="swiglu",
    n_experts=16, topk=2, moe_every=2, moe_offset=1,
    ssm_state=16, ssm_headdim=64, ssm_groups=1,
    attn_every=8, attn_index=4,
    subquadratic=True,
)
