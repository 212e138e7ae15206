# PyTorch port of repro.core: the paper's main-memory index structures
# (binary / CSS / CSB+ / k-ary / FAST) and NitroGen index compilation, the
# key-domain helpers, and the public facade (build_index / IndexConfig /
# LookupResult).
from .api import (Index, IndexConfig, LookupResult, build_index,  # noqa: F401
                  from_reference_arrays, restore_index, KINDS, PORTED_KINDS)
from . import (sorted_array, css_tree, csb_tree, kary, fast_tree,  # noqa: F401
               nitrogen, util)
from .csb_tree import CSBTree  # noqa: F401
