"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 + shared expert; early-fusion multimodality is a
stub per the assignment.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, mlp_act="swiglu",
    n_experts=16, topk=1, shared_expert=True,
)
