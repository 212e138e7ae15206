from .train_step import (chunked_ce_loss, chunked_ce_sum,  # noqa: F401
                         make_loss_fn, make_sharded_train_step,
                         make_train_step)
from .trainer import Trainer, TrainConfig, TrainState                   # noqa: F401
