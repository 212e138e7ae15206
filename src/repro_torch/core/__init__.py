# PyTorch port of repro.core: the key-domain helpers, the k-ary tree and
# the NitroGen select network that the tiered engine's top tier uses, and
# the public facade (build_index / IndexConfig / LookupResult).
from .api import (Index, IndexConfig, LookupResult, build_index,  # noqa: F401
                  check_ported, from_reference_arrays, restore_index, KINDS)
from . import kary, nitrogen, util  # noqa: F401
