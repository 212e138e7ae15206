"""Shared helpers for the index-search core (PyTorch port of
``repro/core/util.py``).

Key-domain conventions (DESIGN.md §2.3), unchanged from the reference:
  * keys are int32 or float32, sorted ascending;
  * the sentinel (int32 max / +inf) pads incomplete structures — user keys
    must be strictly below it;
  * every searcher returns the searchsorted-left rank: the index of the
    first key >= q in the sorted array.

Device placement: entry points take ``device=None``, which means the CUDA
card. Without one they raise rather than quietly run on the CPU; callers
that want the CPU (the parity tests) pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

_INT_SENTINELS = {
    np.dtype(np.int32): np.int32(np.iinfo(np.int32).max),
    np.dtype(np.int64): np.int64(np.iinfo(np.int64).max),
}


def sentinel_for(dtype) -> np.generic:
    """Largest representable value for ``dtype``; pads incomplete nodes."""
    dtype = np.dtype(dtype)
    if dtype in _INT_SENTINELS:
        return _INT_SENTINELS[dtype]
    if np.issubdtype(dtype, np.floating):
        return dtype.type(np.inf)
    raise TypeError(f"unsupported key dtype {dtype}")


def as_sorted_numpy(keys) -> np.ndarray:
    keys = np.asarray(keys)
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    if keys.size == 0:
        raise ValueError("empty key set")
    return np.sort(keys, kind="stable")


def ceil_to(x: int, m: int) -> int:
    """Round x up to a multiple of m (tile/lane alignment everywhere)."""
    return -(-x // m) * m


def next_pow(base: int, n: int) -> int:
    """Smallest base**L with base**L >= n; returns the exponent L."""
    level, cap = 0, 1
    while cap < n:
        cap *= base
        level += 1
    return level


def pad_to(keys: np.ndarray, size: int) -> np.ndarray:
    if keys.size > size:
        raise ValueError("cannot pad down")
    out = np.full(size, sentinel_for(keys.dtype), dtype=keys.dtype)
    out[: keys.size] = keys
    return out


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (int32 -> np.int32, ...)."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def tree_map(fn: Callable, *trees, is_leaf: Optional[Callable] = None):
    """Map ``fn`` over the leaves of trees of one structure, keeping the
    structure: dicts (visited in sorted key order, as JAX's pytrees are),
    lists, tuples (NamedTuples too) and dataclasses; a None stays None.
    Tensors, arrays, whatever ``is_leaf`` accepts and any other object
    are leaves."""
    head = trees[0]
    if head is None:
        return None
    if isinstance(head, (torch.Tensor, np.ndarray)) or \
            (is_leaf is not None and is_leaf(head)):
        return fn(*trees)

    def sub(*parts):
        return tree_map(fn, *parts, is_leaf=is_leaf)
    if isinstance(head, dict):
        return {k: sub(*(t[k] for t in trees)) for k in sorted(head)}
    if dataclasses.is_dataclass(head) and not isinstance(head, type):
        return type(head)(**{
            f.name: sub(*(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(head)})
    if isinstance(head, (tuple, list)):
        kids = [sub(*parts) for parts in zip(*trees)]
        if hasattr(head, "_fields"):                     # a NamedTuple
            return type(head)(*kids)
        return type(head)(kids)
    return fn(*trees)


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    """The leaves of ``tree`` in tree_map's order."""
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along axis 0 with the index clamped into range — the torch
    form of ``jnp.take(mode="clip")``. On CUDA an out-of-range index is a
    device-side assert that kills the context, so the clamp is not
    optional."""
    return arr[idx.clamp(0, arr.shape[0] - 1).long()]


# queries a searcher handles at once: a [chunk, width] gathered block (the
# keys and the compare mask) keeps near 2^25 elements
GATHER_ELEMS = 1 << 25


def by_chunks(width: int, fn, *cols: torch.Tensor) -> torch.Tensor:
    """``fn(*cols)`` over slices of the query axis, ``GATHER_ELEMS //
    width`` queries a slice, so that the ``[chunk, width]`` blocks a
    searcher gathers stay bounded (a [2^20, 129] block of int32 keys is
    over 500 MB). One slice when the batch fits."""
    q_n = cols[0].shape[0]
    chunk = max(1, GATHER_ELEMS // max(int(width), 1))
    if q_n <= chunk:
        return fn(*cols)
    return torch.cat([fn(*(c[s:s + chunk] for c in cols))
                      for s in range(0, q_n, chunk)])


def take_rows(flat: torch.Tensor, width: int, rows: torch.Tensor
              ) -> torch.Tensor:
    """Rows of ``flat`` viewed as ``[-1, width]``, one row index a query:
    the ``[Q, width]`` nodes a searcher reads. The reference takes
    ``row * width + arange(width)`` from the flat buffer; every node and
    leaf block starts at a multiple of its width, so one row gather reads
    the same keys without a ``[Q, width]`` address tensor."""
    return take(flat.view(-1, width), rows)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raise when there is none, so that no
    entry point falls back to the CPU without being asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def upload_async(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host array that does not wait for the stream:
    staged through page-locked memory and copied with ``non_blocking``.
    The caching host allocator keeps the staging block until the copy has
    run, so the caller may drop it (and mutate ``arr``) at once. On the
    CPU it is a plain copy."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


def as_queries(queries, like: torch.Tensor) -> torch.Tensor:
    """Queries as a 1-D tensor on ``like``'s device in its dtype (the
    reference's ``jnp.asarray`` canonicalises 64-bit inputs to 32 bits the
    same way). A tensor already on the device in that dtype is used as is,
    so no copy or host sync is added."""
    q = torch.as_tensor(queries, device=like.device)
    return q if q.dtype == like.dtype else q.to(like.dtype)
