"""whisper-small [audio] — 12L d_model=768 12H d_ff=3072 vocab=51865 —
enc-dec; conv frontend is a stub (input_specs provides 1500 frame
embeddings).  [arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, mlp_act="gelu",
    is_encoder_decoder=True, encoder_layers=12, encoder_seq=1500,
)
