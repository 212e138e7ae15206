# Distribution layer (PyTorch port of repro.dist): the sharding rules shared
# by training and the sharded index, the placement of tensors under them
# over torch.distributed, and gradient compression for the data-parallel
# all-reduce.
from . import sharding, compression  # noqa: F401
