# Roofline terms on the H100 (PyTorch port of repro.roofline): the card's
# constants, op counting on the meta device, model FLOPs.
from . import analysis  # noqa: F401
