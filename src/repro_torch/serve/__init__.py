# Serving stack (PyTorch port of repro.serve): the prefix-page store over
# the tiered index, nucleus sampling through the CDF-inversion kernel, and
# the batched engine.
from .engine import EngineStats, ServeEngine  # noqa: F401
from .sampler import SamplerConfig, sample  # noqa: F401
from . import kv_cache  # noqa: F401
