"""Elastic scaling: rebuild the mesh for a changed device count and reshard
training state — the recovery path after node failure / preemption
(PyTorch port of ``repro/launch/elastic.py``).

Protocol: the watchdog (train/trainer.py) or the cluster scheduler reports
a new world size -> ``choose_mesh`` picks the largest valid (data, model)
grid -> ``reshard_state`` re-places the checkpointed state under the
standard rules -> training resumes from the exact step (the data pipeline
is deterministic in (seed, step), so no batch is lost or repeated).

Both are collectives: every rank of the world calls them. The state is in
the reference's stacked layout (``transformer.to_reference_params``), the
layout the rules and the sharded train step read.
"""
from __future__ import annotations

from ..core.util import tree_map
from ..dist import sharding as SH
from .mesh import make_host_mesh


def choose_mesh(n_devices: int, *, prefer_model: int = 16, device_type=None):
    """Largest (data, model) grid for n_devices: model axis as close to
    `prefer_model` as divides, rest data-parallel; over the first
    ``data * model`` ranks of the world."""
    model = min(prefer_model, n_devices)
    while n_devices % model:
        model -= 1
    data = n_devices // model
    return make_host_mesh((data, model), ("data", "model"), device_type)


def reshard_state(state: dict, new_mesh, abstract_params) -> dict:
    """Re-place {params, opt} onto `new_mesh` under the standard rules.
    Works from host copies, so it accepts state restored from a checkpoint
    (tensors or arrays) or live DTensor state from the old (possibly
    degraded) mesh; ``abstract_params`` gives the shapes (e.g. "meta"
    tensors)."""
    psh = SH.params_shardings(new_mesh, abstract_params)
    count = SH.Sharding(new_mesh, ())

    def put(x, s):
        return SH.distribute(SH.host_copy(x), s)

    return {
        "params": tree_map(put, state["params"], psh),
        "opt": {
            "m": tree_map(put, state["opt"]["m"], psh),
            "v": tree_map(put, state["opt"]["v"], psh),
            "count": put(state["opt"]["count"], count),
        },
    }
