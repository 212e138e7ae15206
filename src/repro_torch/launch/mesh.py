"""Production and host meshes as ``torch.distributed`` device meshes
(PyTorch port of ``repro/launch/mesh.py``).

A mesh is a ``DeviceMesh`` over the ranks of the default process group,
its ``mesh_dim_names`` the reference's axis names. Functions, not
module-level constants, so that importing this module touches no process
group. The device type is the card unless the caller asks for ``"cpu"``
(gloo on the CPU, as the tests run it). Building a mesh is a collective:
every rank of the world calls it, also a rank that the mesh leaves out.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def world_size() -> int:
    """Ranks in the default process group; 1 when there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type(device_type) -> str:
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device_type='cpu' to "
                "build the mesh over gloo on the CPU")
        return "cuda"
    return str(device_type)


def _make_mesh(shape, axes, device_type) -> DeviceMesh:
    n = int(np.prod(shape))
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    if world_size() < n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                           f"world has {world_size()}")
    return DeviceMesh(_device_type(device_type),
                      torch.arange(n).view(*shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None
                         ) -> DeviceMesh:
    """16x16 = 256 ranks per pod; multi_pod adds a leading pod=2 axis
    (512 ranks). The world must hold that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if world_size() < n:
        raise RuntimeError(
            f"need {n} devices for {'multi' if multi_pod else 'single'}-pod "
            f"mesh, have {world_size()} — run under a process group of "
            f"{n} ranks (one a device) on real hardware")
    return _make_mesh(shape, axes, device_type)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device_type=None
                   ) -> DeviceMesh:
    """A small mesh over the first ranks of the world (tests, one card)."""
    return _make_mesh(tuple(shape), tuple(axes), device_type)
