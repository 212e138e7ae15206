"""PyTorch + CUDA port of ``repro`` for the NVIDIA H100.

The JAX package ``repro`` stays the reference; this package grows beside
it with the same module layout. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``. Its hand-written Hopper kernels live in
``csrc/`` and build with nvcc at first use (``kernels/_build.py``).
"""
from .core import IndexConfig, LookupResult, build_index  # noqa: F401
