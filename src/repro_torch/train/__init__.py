from .train_step import chunked_ce_loss, make_loss_fn, make_train_step  # noqa: F401
from .trainer import Trainer, TrainConfig, TrainState                   # noqa: F401
