# Model-architecture configs (PyTorch port of repro.configs): the
# ArchConfig schema and get_config for the architectures the port runs.
from .base import ARCH_IDS, ArchConfig, get_config  # noqa: F401
