"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA window 4096 (SWA makes decode KV effectively
bounded -> long_500k applicable).  [arXiv:2401.04088; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, mlp_act="swiglu",
    n_experts=8, topk=2, window=4096, subquadratic=True,
)
