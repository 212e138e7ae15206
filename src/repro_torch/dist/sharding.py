"""Sharding rules for every mesh, and the placement of tensors under them
(PyTorch port of ``repro/dist/sharding.py``).

One policy, applied uniformly by shape — FSDP x tensor-parallel:

  * >=2-D parameters shard their second-to-last dim over the data axes
    (FSDP) and their last dim over the ``model`` axis (tensor parallel);
  * 1-D / scalar leaves (norms, counters) are replicated;
  * batches shard their leading dim over the data axes;
  * decode caches shard batch over data and (configurably) head_dim or the
    kv-head dim over ``model``.

Every rule is divisibility-guarded (``_maybe``): a dim that does not
divide its mesh axes stays unsharded instead of erroring.

A rule gives a *spec*, the twin of ``PartitionSpec``: a tuple with one
entry a tensor dim (None, an axis name, or a tuple of axis names, major
first), ``()`` for a replicated leaf. The rules read only the mesh's axis
names and sizes, so they run on a ``MeshShape`` (the twin of JAX's
``AbstractMesh``) as well as on a ``DeviceMesh``. ``Sharding(mesh, spec)``
is the twin of ``NamedSharding``; its ``placements`` are the
``torch.distributed.tensor`` ones, ``Shard(d)`` or ``Replicate()`` a mesh
dim.

The rules apply to the reference's stacked parameter layout
(``transformer.to_reference_params``): a layer's norm weight there is
``[R, D]`` and sharded, where a lone ``[D]`` leaf is replicated. The
sharded train step holds its state in that layout.

Placement moves whole values between one rank's copy and ``DTensor``
blocks: ``distribute`` keeps this rank's block (no collective), ``gather``
all-gathers the blocks over each mesh dim's process group. Several ranks
that share one card meet over gloo (NCCL refuses two ranks on one GPU);
gloo takes CUDA tensors for ``all_gather`` and ``all_reduce``
(``experiments/dist_probe.py``), so no buffer is staged by hand.

``activation_sharding`` / ``constrain_activations`` are the activation
side: inside the context a ``[B, S, D]`` DTensor activation is
redistributed to (data-sharded batch, optional sequence axis); a plain
tensor, or any tensor outside the context, passes unchanged.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core.util import tree_map


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names without devices or process groups:
    what the rules read."""
    shape: tuple
    axis_names: tuple


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a MeshShape, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, (int(s) for s in mesh.shape)))


def dp_axes(mesh) -> tuple:
    """Data-parallel axis names of a mesh: every axis that is not 'model'."""
    return tuple(a for a in axis_sizes(mesh) if a != "model")


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in axes]))


def _maybe(mesh, axes, size: int):
    """`axes` if `size` divides the total mesh extent of `axes`, else None
    (replicate rather than error on uneven shapes)."""
    if axes is None:
        return None
    ext = _axis_size(mesh, axes)
    if ext <= 1 or size % ext:
        return None
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _leaf_spec(mesh, shape) -> tuple:
    """FSDP x TP rule for one parameter leaf."""
    if len(shape) < 2:
        return ()
    dp = dp_axes(mesh)
    dims = [None] * len(shape)
    dims[-2] = _maybe(mesh, dp, shape[-2])
    dims[-1] = (_maybe(mesh, "model", shape[-1])
                if "model" in axis_sizes(mesh) else None)
    return tuple(dims)


class Sharding:
    """A mesh and a spec: the twin of ``NamedSharding``. A leaf of the
    trees that ``tree_map`` walks (not a dataclass)."""
    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)

    def __eq__(self, other) -> bool:
        return isinstance(other, Sharding) and self.spec == other.spec \
            and axis_sizes(self.mesh) == axis_sizes(other.mesh)

    def __repr__(self) -> str:
        return f"Sharding({axis_sizes(self.mesh)}, {self.spec})"

    @property
    def placements(self) -> tuple:
        """``Shard(d)`` for each mesh dim that the spec names at tensor dim
        d, ``Replicate()`` for the others."""
        out = []
        for name in axis_sizes(self.mesh):
            dim = next((d for d, e in enumerate(self.spec)
                        if e == name or (isinstance(e, tuple) and name in e)),
                       None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)


def params_shardings(mesh, params):
    """Sharding tree matching `params` (tensors, "meta" tensors or anything
    with a ``shape``)."""
    return tree_map(lambda x: Sharding(mesh, _leaf_spec(mesh, x.shape)),
                    params)


def opt_state_shardings(mesh, opt_state, param_shardings):
    """AdamW moments follow the parameters; the step counter is replicated."""
    return {"m": param_shardings, "v": param_shardings,
            "count": Sharding(mesh, ())}


def batch_shardings(mesh, has_memory: bool = False, batch: int | None = None):
    """Input shardings: batch dim over the data axes, everything else
    replicated, keyed as the train / prefill batch dicts. Pass `batch` to
    divisibility-guard the batch dim like every other rule; without it the
    caller asserts divisibility."""
    dp = dp_axes(mesh)
    if batch is not None:
        dp_spec = _maybe(mesh, dp, batch)
    else:
        dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    out = {"tokens": Sharding(mesh, (dp_spec, None)),
           "labels": Sharding(mesh, (dp_spec, None))}
    if has_memory:
        out["memory"] = Sharding(mesh, (dp_spec, None, None))
    return out


def cache_shardings(mesh, abstract_cache, batch: int, kv_shard: str = "hd"):
    """Decode-cache shardings. Leaves are [R, B, ...] (the port's stacks
    over layers as the reference's over repeats): B shards over data;
    kv_shard picks the model-parallel dim of attention entries — 'hd'
    (head_dim, the last dim) or 'heads' (the kv-head dim)."""
    dp = dp_axes(mesh)
    b_axis = _maybe(mesh, dp, batch)
    has_model = "model" in axis_sizes(mesh)

    def one(x):
        shape = x.shape
        if len(shape) == 1:                       # lengths [B]
            return Sharding(mesh, (b_axis,))
        dims = [None] * len(shape)
        if len(shape) >= 2:
            dims[1] = b_axis
        if len(shape) >= 3 and has_model:
            tp_dim = len(shape) - 1 if kv_shard == "hd" else len(shape) - 2
            if tp_dim > 1:
                dims[tp_dim] = _maybe(mesh, "model", shape[tp_dim])
        return Sharding(mesh, tuple(dims))

    return tree_map(one, abstract_cache)


# ------------------------------------------------------------- placement
def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` holds its shards on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_slice(full: torch.Tensor, mesh, placements, coord
                ) -> torch.Tensor:
    """The block of ``full`` that the rank at mesh coordinate ``coord``
    holds under ``placements``: each sharded mesh dim, in mesh order,
    splits its tensor dim into equal blocks (the rules shard only what
    divides)."""
    sizes = list(axis_sizes(mesh).values())
    out = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = out.shape[p.dim] // sizes[i]
            out = out.narrow(p.dim, coord[i] * n, n)
    return out


def distribute(value, sharding: Sharding) -> DTensor:
    """A DTensor of ``value`` (a whole tensor or array on this rank) under
    ``sharding``: this rank keeps its block, copied to its mesh device. No
    collective. A rank outside the mesh keeps an empty block."""
    full = value if isinstance(value, torch.Tensor) \
        else torch.from_numpy(np.asarray(value))
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    if coord is None:
        local = torch.empty(0, dtype=full.dtype, device=mesh_device(mesh))
    else:
        local = local_slice(full, mesh, sharding.placements, coord).to(
            mesh_device(mesh), copy=True).contiguous()
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=full.shape,
                              stride=torch.empty(full.shape,
                                                 device="meta").stride())


def gather(x: DTensor) -> torch.Tensor:
    """The whole value of a DTensor on this rank's device: each sharded
    mesh dim all-gathered over its group, innermost first."""
    mesh = x.device_mesh
    out = x.to_local()
    for i in reversed(range(len(x.placements))):
        p = x.placements[i]
        group = mesh.get_group(i)
        if isinstance(p, Shard) and dist.get_world_size(group) > 1:
            parts = [torch.empty_like(out) for _ in range(
                dist.get_world_size(group))]
            dist.all_gather(parts, out.contiguous(), group=group)
            out = torch.cat(parts, dim=p.dim)
    return out


def host_copy(x) -> torch.Tensor:
    """A whole CPU copy of a DTensor (a collective over its mesh), a tensor
    or an array."""
    if isinstance(x, DTensor):
        return gather(x).cpu()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.asarray(x))


# ----------------------------------------------------------- activations
_ctx = threading.local()


@contextmanager
def activation_sharding(mesh, seq_axis: Optional[str] = None):
    """Inside this context, ``constrain_activations`` pins [B, S, D]
    activations to (data-sharded batch, seq_axis-sharded sequence).
    Nestable; a no-op everywhere outside."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, seq_axis)
    try:
        yield
    finally:
        _ctx.state = prev


def constrain_activations(x):
    """Redistribute a [B, S, D] DTensor activation to the context's spec;
    the identity outside an ``activation_sharding`` context and on a plain
    tensor."""
    state = getattr(_ctx, "state", None)
    if state is None or not isinstance(x, DTensor):
        return x
    mesh, seq_axis = state
    dims = [None] * x.ndim
    dims[0] = _maybe(mesh, dp_axes(mesh), x.shape[0])
    if seq_axis is not None and x.ndim >= 2:
        dims[1] = _maybe(mesh, seq_axis, x.shape[1])
    return x.redistribute(mesh, Sharding(mesh, tuple(dims)).placements)
