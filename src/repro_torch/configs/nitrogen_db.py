"""The paper's own workload: an OLAP point-query index service (no LM).
Used by examples/index_db.py and the paper-figure benchmarks."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nitrogen-db", family="index",
    n_layers=0, d_model=0, n_heads=1, n_kv_heads=1, d_ff=0, vocab=0,
)
