"""Manifest-verified snapshots (PyTorch port of ``repro/ckpt/checkpoint.py``
for the single-host path): atomic, keep-N, newest-verifying restore.

Layout: ``<dir>/step_<n>/arrays.host0.npz + manifest.json``, written to a
temporary directory and renamed (atomic on POSIX), so a crash while saving
never leaves a snapshot that restore would trust; restore takes the newest
step whose manifest and arrays verify and warns when it falls back. Trees
are nested dicts and lists of arrays or tensors (on any device),
flattened to ``"a/b"`` names in sorted key order, the names the
reference's pytree flatten gives, so either package restores what the
other wrote.

Leaves are stored in their own dtype. numpy has no bfloat16: a bfloat16
tensor is stored as its uint16 bit pattern under the manifest dtype
``bfloat16`` and restored as a bfloat16 tensor. (The reference stores
numpy's bfloat16 extension type as raw bytes that its own verification
refuses, so neither package restores the other's bfloat16 leaves.)
"""
from __future__ import annotations

import json
import os
import shutil
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from ..core.util import tree_map
from ..dist import sharding as SH

# manifest dtype -> the dtype of the array that stores it
_STORED_AS = {"bfloat16": "uint16"}


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b": leaf} for a nested dict / list / tuple of arrays or
    tensors: sorted dict keys and positional sequence indices, the
    reference's names, in ``tree_map``'s leaf order."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the host array to store, and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = t.numpy()
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _stored_value(a: np.ndarray, dtype: str):
    """A stored array as its leaf: a bfloat16 tensor for a bfloat16
    leaf, the array otherwise."""
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return a


def _fill(target, values: dict):
    """``target``'s tree with each leaf replaced by its stored value: a
    tensor leaf gives a tensor of its dtype on its device, a leaf with a
    ``dtype`` an array of it, any other leaf (a placeholder) the stored
    value as it is."""
    names = iter(_flatten(target))

    def leaf(t):
        v = values[next(names)]
        if isinstance(t, torch.Tensor):
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
            return v.to(device=t.device, dtype=t.dtype)
        if hasattr(t, "dtype"):
            if isinstance(v, torch.Tensor):
                v = v.float().numpy()
            return np.asarray(v).astype(t.dtype)
        return v
    return tree_map(leaf, target)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Write ``tree`` as snapshot ``step`` and keep the newest ``keep``
    snapshots. Returns the snapshot's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    flat = {k: _host(v) for k, v in _flatten(tree).items()}
    arrays = {k: a for k, (a, _) in flat.items()}
    np.savez(os.path.join(tmp, "arrays.host0.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: dtype for k, (_, dtype) in flat.items()},
        "hosts": 1,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            try:
                out.append(int(d.split("_")[1].split(".")[0]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_verified(path: str, manifest: dict) -> Optional[dict]:
    """The snapshot's arrays after deep verification, None if it fails:
    every manifest key present, every member read in full (np.load is
    lazy; reading each array forces the zip member's CRC32 check, which
    catches bit flips and truncation), and shape and dtype as the
    manifest says (a bfloat16 leaf's bits stored as uint16). One read of
    each member serves the check and the restore."""
    try:
        with np.load(os.path.join(path, "arrays.host0.npz")) as z:
            if sorted(z.files) != manifest["keys"]:
                return None
            arrays = {}
            for k in z.files:
                a = z[k]
                dtype = manifest["dtypes"][k]
                if list(a.shape) != manifest["shapes"][k] or \
                        str(a.dtype) != _STORED_AS.get(dtype, dtype):
                    return None
                arrays[k] = _stored_value(a, dtype)
        return arrays
    except Exception:
        return None


def restore(ckpt_dir: str, target: Any = None,
            step: Optional[int] = None,
            shardings: Any = None) -> tuple[Any, int]:
    """Fill ``target``'s tree from the newest verifying snapshot (or
    ``step``); a corrupt or torn newer snapshot is skipped with a
    RuntimeWarning (graceful degradation to the previous step). A tensor
    leaf of ``target`` gives the stored value as a tensor of its dtype on
    its device, a leaf with a ``dtype`` an array cast to it, any other
    leaf (a placeholder) the stored value in its stored dtype; the stored
    shapes are kept. ``target=None`` returns the raw ``{"a/b": array}``
    dict with the stored dtypes (bfloat16 leaves as tensors), for callers
    whose tree is known only from the snapshot. ``shardings``, a tree of
    ``dist.sharding.Sharding`` in ``target``'s structure, distributes each
    restored leaf under its own (this rank keeps its block, a DTensor on
    the mesh's device), as the reference's ``device_put``. Returns (tree,
    step). Raises FileNotFoundError when no snapshot verifies."""
    candidates = [step] if step is not None \
        else list(reversed(all_steps(ckpt_dir)))
    for i, s in enumerate(candidates):
        path = os.path.join(ckpt_dir, f"step_{s:08d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except Exception:
            continue
        values = _load_verified(path, manifest)
        if values is None:
            continue                            # torn checkpoint: skip back
        if i > 0:
            warnings.warn(
                f"checkpoint step {candidates[0]} in {ckpt_dir} failed "
                f"verification; falling back to step {s}",
                RuntimeWarning, stacklevel=2)
        if target is None:
            return values, s
        tree = _fill(target, values)
        if shardings is not None:
            tree = tree_map(SH.distribute, tree, shardings)
        return tree, s
    raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
