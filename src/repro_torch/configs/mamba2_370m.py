"""mamba2-370m [ssm] — 48L d_model=1024 attn-free, vocab=50280,
ssm_state=128 (SSD).  [arXiv:2405.21060; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_groups=1,
    subquadratic=True, tie_embeddings=True,
)
