from .adamw import (OptConfig, apply_updates, global_norm,  # noqa: F401
                    init_state, schedule_fn)
