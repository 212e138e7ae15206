# Tiered batch-search engine (PyTorch port of repro.engine): the
# sort-and-bucket schedule (host numpy plan and its device twin) and the
# single-device tiered engine behind IndexConfig(kind="tiered").
from .schedule import (BucketPlan, DevicePlan, bucket_plan,  # noqa: F401
                       device_plan, executed_occupancy, ladder_for,
                       ladder_grid, ladder_rungs, lane_arrays,
                       occupancy_shares, plan_method, run_scheduled,
                       run_scheduled_multi, worst_case_steps)
from .tiered import (TieredIndex, build, from_reference_arrays,  # noqa: F401
                     plan_tiers, search, search_with_plan, searcher)
