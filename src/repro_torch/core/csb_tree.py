"""CSB+-tree (thesis §3.2 / [RR00]) — PyTorch port of
``repro/core/csb_tree.py``: the update-friendly compromise the thesis
describes (Alg 3.2).

Structure: all children of a node live in one contiguous *node group*, so
each internal node stores exactly ONE child reference (the group's base
index) — pointer overhead is 1/f of a B+-tree's. Groups are independently
allocated, so leaf splits rewrite one group instead of rebuilding the
whole array: ``insert`` is incremental.

Layout (host numpy arrays, as the reference keeps them):
  keys       [N, w]   separator keys, sentinel-padded
  child      [N]      base index of the child group (first child), -1 = leaf
  nlen       [N]      live separators (or leaf keys) in the node
  leaf_keys  [N, w]   sorted keys of the leaves

The build and the updates are host-side and structural, as in the
reference. ``search`` runs on the tree's device: the snapshot of the live
nodes is uploaded once after a build or an insert, never by a search, so a
search makes no host sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .util import as_queries, by_chunks, resolve_device, sentinel_for, take, \
    upload_async


@dataclass
class CSBTree:
    """Mutable host-side CSB+-tree; ``snapshot()`` gives its device arrays."""
    w: int = 8                                 # max keys per node
    keys: Optional[np.ndarray] = None          # [N, w]
    child: Optional[np.ndarray] = None         # [N] group base, -1 = leaf
    nlen: Optional[np.ndarray] = None          # [N]
    leaf_keys: Optional[np.ndarray] = None     # [N, w] (leaves only)
    root: int = 0
    _n_nodes: int = 0
    height: int = 1
    device: Any = None                         # where search runs
    _snap: Optional[tuple] = None              # device snapshot, or stale

    # ------------------------------------------------------------ build
    @classmethod
    def build(cls, keys, w: int = 8, *, device=None) -> "CSBTree":
        t = cls(w=w, device=resolve_device(device))
        srt = np.unique(np.asarray(keys))
        sent = sentinel_for(srt.dtype)
        cap = max(64, 4 * (srt.size // max(w // 2, 1) + 8))
        t.keys = np.full((cap, w), sent, srt.dtype)
        t.child = np.full(cap, -1, np.int64)
        t.nlen = np.zeros(cap, np.int64)
        t.leaf_keys = np.full((cap, w), sent, srt.dtype)
        # bulk-load leaves half full (standard B+ bulk load)
        per = max(w // 2, 1)
        leaves = [srt[i: i + per] for i in range(0, max(srt.size, 1), per)]
        ids = []
        for lk in leaves:
            nid = t._alloc_group(1)
            t._write_leaf(nid, lk)
            ids.append(nid)
        level = ids
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level), w + 1):
                grp = level[i: i + w + 1]
                grp = t._regroup(grp)            # children must be contiguous
                nid = t._alloc_group(1)
                seps = [t._max_key(c) for c in grp[:-1]]
                t.keys[nid, : len(seps)] = seps
                t.nlen[nid] = len(seps)
                t.child[nid] = grp[0]
                nxt.append(nid)
            level = nxt
            t.height += 1
        t.root = level[0]
        return t

    # ------------------------------------------------------------ internals
    def _alloc_group(self, n: int) -> int:
        if self._n_nodes + n > self.keys.shape[0]:
            grow = max(self.keys.shape[0], n)
            sent = sentinel_for(self.keys.dtype)
            self.keys = np.concatenate(
                [self.keys, np.full((grow, self.w), sent, self.keys.dtype)])
            self.leaf_keys = np.concatenate(
                [self.leaf_keys, np.full((grow, self.w), sent,
                                         self.keys.dtype)])
            self.child = np.concatenate([self.child,
                                         np.full(grow, -1, np.int64)])
            self.nlen = np.concatenate([self.nlen, np.zeros(grow, np.int64)])
        base = self._n_nodes
        self._n_nodes += n
        return base

    def _write_leaf(self, nid: int, lk: np.ndarray):
        sent = sentinel_for(self.keys.dtype)
        self.leaf_keys[nid, :] = sent
        self.leaf_keys[nid, : lk.size] = lk
        self.nlen[nid] = lk.size
        self.child[nid] = -1

    def _regroup(self, ids: list) -> list:
        """Copy nodes into one contiguous group (CSB+ invariant)."""
        base = self._alloc_group(len(ids))
        out = []
        for j, nid in enumerate(ids):
            dst = base + j
            self.keys[dst] = self.keys[nid]
            self.leaf_keys[dst] = self.leaf_keys[nid]
            self.child[dst] = self.child[nid]
            self.nlen[dst] = self.nlen[nid]
            out.append(dst)
        return out

    def _max_key(self, nid: int):
        if self.child[nid] == -1:
            return self.leaf_keys[nid, self.nlen[nid] - 1]
        return self._max_key(self.child[nid] + self.nlen[nid])

    # ------------------------------------------------------------ update
    def insert(self, key) -> bool:
        """Incremental insert (no full rebuild — the CSB+ selling point).
        Returns False if the key already exists."""
        self._snap = None
        key = np.asarray(key).item()
        path = []
        nid = self.root
        while self.child[nid] != -1:
            ks, ln = self.keys[nid], self.nlen[nid]
            c = int(np.sum(ks[:ln] < key))
            path.append((nid, c))
            nid = int(self.child[nid]) + c
        lk = self.leaf_keys[nid][: self.nlen[nid]]
        if key in lk:
            return False
        if self.nlen[nid] < self.w:              # easy: leaf has room
            new = np.sort(np.append(lk, key))
            self._write_leaf(nid, new)
            return True
        # leaf split: rewrite ONE child group (grow by one), update parent
        new = np.sort(np.append(lk, key))
        lo, hi = new[: new.size // 2], new[new.size // 2:]
        if not path:                             # root is a leaf
            g = self._alloc_group(2)
            self._write_leaf(g, lo)
            self._write_leaf(g + 1, hi)
            r = self._alloc_group(1)
            self.keys[r, 0] = lo[-1]
            self.nlen[r] = 1
            self.child[r] = g
            self.root = r
            self.height += 1
            return True
        pid, c = path[-1]
        old_base = int(self.child[pid])
        n_kids = int(self.nlen[pid]) + 1
        g = self._alloc_group(n_kids + 1)
        for j in range(n_kids):                  # copy siblings, split at c
            src = old_base + j
            dst = g + j + (1 if j > c else 0)
            self.keys[dst] = self.keys[src]
            self.leaf_keys[dst] = self.leaf_keys[src]
            self.child[dst] = self.child[src]
            self.nlen[dst] = self.nlen[src]
        self._write_leaf(g + c, lo)
        self._write_leaf(g + c + 1, hi)
        if self.nlen[pid] < self.w:              # parent has room
            ks = list(self.keys[pid][: self.nlen[pid]])
            ks.insert(c, lo[-1])
            self.keys[pid, : len(ks)] = ks
            self.nlen[pid] += 1
            self.child[pid] = g
            return True
        # a parent split would recurse; as the reference does, fall back to
        # a rebuild above fan-out pressure (thesis: split propagation is
        # rare at the top — §4.1 motivates NitroGen-compiling only the top)
        allk = np.sort(self.iter_keys())
        # dtype-preserving append: np.append would promote int32 + a Python
        # int to int64, whose sentinel differs from the int32 one
        allk = np.concatenate([allk, np.array([key], dtype=allk.dtype)])
        rebuilt = CSBTree.build(allk, self.w, device=self.device)
        self.__dict__.update(rebuilt.__dict__)
        return True

    def iter_keys(self) -> np.ndarray:
        out = []

        def rec(nid):
            if self.child[nid] == -1:
                out.append(self.leaf_keys[nid][: self.nlen[nid]])
                return
            for j in range(int(self.nlen[nid]) + 1):
                rec(int(self.child[nid]) + j)

        rec(self.root)
        return np.concatenate(out) if out else np.empty(0, self.keys.dtype)

    # ------------------------------------------------------------ search
    def snapshot(self):
        """(keys, child, leaf_keys, root, height) with the arrays on the
        tree's device: the live nodes, child ids as int32. Uploaded once
        after each build or insert (page-locked, non-blocking)."""
        if self._snap is None:
            n, dev = self._n_nodes, self.device
            self._snap = (upload_async(self.keys[:n], dev),
                          upload_async(self.child[:n].astype(np.int32), dev),
                          upload_async(self.leaf_keys[:n], dev))
        return (*self._snap, self.root, self.height)

    def search(self, queries) -> torch.Tensor:
        """Batched membership search -> found, bool [Q]. Alg 3.2: child
        address = group base + offset arithmetic (one stored reference)."""
        keys, child, leaf_keys, root, height = self.snapshot()
        q = as_queries(queries, keys)
        return by_chunks(self.w, lambda qq: _search(
            keys, child, leaf_keys, qq, root, height), q)


def _search(keys, child, leaf_keys, q, root: int, height: int):
    nid = torch.full(q.shape, root, dtype=torch.int32, device=q.device)
    for _ in range(height - 1):
        node = take(keys, nid)                      # [Q, w]
        c = (node < q[:, None]).sum(-1, dtype=torch.int32)
        base = take(child, nid)
        # stop early on ragged paths
        nid = torch.where(base < 0, nid, base + c)
    leaf = take(leaf_keys, nid)
    return (leaf == q[:, None]).any(-1)
