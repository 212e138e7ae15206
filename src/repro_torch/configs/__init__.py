# Model-architecture configs (PyTorch port of repro.configs): the
# ArchConfig schema, get_config for the architectures the port runs, and
# the LM pool's input shapes (SHAPES, shape_applicable).
from .base import (ARCH_IDS, SHAPES, ArchConfig, get_config,  # noqa: F401
                   shape_applicable)
