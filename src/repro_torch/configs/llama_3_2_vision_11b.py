"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer; vision frontend is a
stub (input_specs provides patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, mlp_act="swiglu",
    cross_attn_every=5, cross_attn_index=3, encoder_seq=1601,
    rope_theta=500_000.0,
)
