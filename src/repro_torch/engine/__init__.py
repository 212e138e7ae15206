# Tiered batch-search engine (PyTorch port of repro.engine): the
# sort-and-bucket schedule (host numpy plan and its device twin), the
# single-device tiered engine behind IndexConfig(kind="tiered"), its
# range scans and grouped analytics (scan, groupby), and the mutable store
# behind IndexConfig(mutable=True) with its delta buffer (store, delta),
# specialization's binding of an index into CUDA graphs (capture), and the
# key-space-sharded index over a device mesh (sharded).
from .schedule import (BucketPlan, DevicePlan, bucket_plan,  # noqa: F401
                       device_plan, executed_occupancy, ladder_for,
                       ladder_grid, ladder_rungs, lane_arrays,
                       occupancy_shares, plan_method, run_scheduled,
                       run_scheduled_multi, span_scan_plan,
                       worst_case_steps)
from .tiered import (TieredIndex, build, from_reference_arrays,  # noqa: F401
                     plan_tiers, search, search_range, search_with_plan,
                     searcher)
from .scan import ScanResult, TieredScanner, scanner_for  # noqa: F401
from .delta import DeltaBuffer  # noqa: F401
from .store import TOMBSTONE, MutableIndex  # noqa: F401
from . import sharded  # noqa: F401
