"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback (PyTorch port of
``repro/dist/compression.py``).

As in the reference, the functions operate on the *stacked-device* form:
every gradient leaf carries a leading device axis ``[D, ...]`` (row d =
device d's local gradient). One round:

    c_d   = Q8(g_d + e_d)          per-device quantize with carried error
    e_d'  = (g_d + e_d) - c_d      residual kept locally (error feedback)
    out   = mean_d(c_d)            the all-reduce, broadcast back to [D, ...]

The residual re-enters the next round's quantizer, so quantization error
averages out across steps instead of accumulating. Rounding is half to
even, as ``jnp.round``; the dequantized values, the residuals and the
mean equal the reference's bit for bit.
"""
from __future__ import annotations

import torch

from ..core.util import tree_leaves, tree_map
from .sharding import axis_sizes


def init_error_state(grads):
    """Zeroed error-feedback residuals, one per gradient leaf."""
    return tree_map(torch.zeros_like, grads)


def _scalar(x: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` as a 0-d tensor beside ``x``. CUDA divides by a Python number
    as a multiply by its reciprocal, which can differ from the quotient in
    the last bit; by a tensor it divides."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def _quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Per-device-slice symmetric int8 quantization. x: [D, ...]; the scale
    is per leading row (each device scales its own tensor)."""
    red = tuple(range(1, x.ndim))
    scale = torch.amax(torch.abs(x), dim=red, keepdim=True) \
        / _scalar(x, 127.0)
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q * scale                                   # dequantized


def make_compressed_allreduce(mesh, axis: str):
    """Returns f(grads, err) -> (reduced, err'): int8-compressed mean over
    the device axis with error feedback. `grads` / `err` are trees whose
    leaves carry the leading [D] device axis (D = the size of `axis` on
    `mesh`, a DeviceMesh or a MeshShape); the reduced mean is broadcast
    back to the same shape."""
    n_dev = axis_sizes(mesh)[axis]

    def one(g, e):
        assert g.shape[0] == n_dev, (g.shape, n_dev)
        compensated = g + e
        deq = _quantize_int8(compensated)
        new_err = compensated - deq
        # the devices' rows added in order, times float32(1 / D): XLA's
        # mean over a leading axis, so it equals the reference's bit for bit
        acc = deq[0].clone()
        for d in range(1, n_dev):
            acc += deq[d]
        return (acc * _scalar(acc, 1.0 / n_dev)).expand(g.shape), new_err

    def f(grads, err):
        pairs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                           tree_leaves(err))]
        outs, errs = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
        return (tree_map(lambda _: next(outs), grads),
                tree_map(lambda _: next(errs), grads))

    return f
