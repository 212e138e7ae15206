"""Sorted delta buffer, the mutable side of the delta-merge write path
(DESIGN.md §6) — PyTorch port of ``repro/engine/delta.py``.

A small **gapped** sorted buffer of power-of-two capacity absorbs writes;
the merge policy in ``engine/store.py`` folds it into the tiered leaf pages
when it overflows. Layout, a one-level CSB+ leaf group kept on the host in
numpy (the reference's arrays, bit for bit):

    h_keys   [nn, w]   node-structured slots; live keys in each node's
                       sorted prefix, sentinel in the gaps
    h_vals   [nn, w]   payload per slot (int32)
    h_cnt    [nn]      occupied slots per node
    node_max [nn]      max occupied key per node (sentinel when empty)

plus three per-slot bit planes for the mutable store's three-tier algebra:
``h_shadow`` (sb: a base twin exists), ``h_ss`` (ss: a sealed twin exists,
set in the active buffer only) and ``h_tomb`` (the key is deleted).

Invariant: concatenating the node prefixes in node order yields the live
(key, value) pairs globally sorted by key; ``node_max`` is ascending with
empty nodes (sentinel) only at the tail.

The device probe (:func:`probe`, :func:`probe_full`) is plain torch and
gives the reference's answers bit for bit: where the reference compares
a query with every slot of its node, one binary search over the buffer
(gap slots routed as their node's maximum) finds the one slot that can
hold it. The store runs it inside its lookup over
tensors uploaded once a write batch (:meth:`DeltaBuffer.device_state`),
so a lookup moves nothing from the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.util import (numpy_dtype, resolve_device, sentinel_for,
                         upload_async)
from .schedule import _next_pow2

DEFAULT_NODE_WIDTH = 16


class DeltaBuffer:
    """Gapped sorted (key -> value) buffer; host-mutable, device-probeable.
    ``device`` (default: the CUDA card) holds the probe's mirrors."""

    def __init__(self, capacity: int, dtype=np.int32,
                 node_width: int = DEFAULT_NODE_WIDTH, *, device=None):
        if capacity <= 0:
            raise ValueError(
                f"delta capacity must be positive, got {capacity}")
        self.device = resolve_device(device)
        self.node_width = int(node_width)
        self.capacity = max(_next_pow2(capacity), self.node_width)
        self.dtype = np.dtype(dtype)
        self.sentinel = sentinel_for(self.dtype)
        self.nn = self.capacity // self.node_width
        w = self.node_width
        self.h_keys = np.full((self.nn, w), self.sentinel, self.dtype)
        self.h_vals = np.zeros((self.nn, w), np.int32)
        # bit planes (docstring above): sb / ss / tombstone per slot
        self.h_shadow = np.zeros((self.nn, w), bool)
        self.h_ss = np.zeros((self.nn, w), bool)
        self.h_tomb = np.zeros((self.nn, w), bool)
        self.h_cnt = np.zeros(self.nn, np.int64)
        self.node_max = np.full(self.nn, self.sentinel, self.dtype)
        self.count = 0
        self.tombs = 0
        self.respreads = 0
        self._dev = None
        self._dev_bits = None

    @property
    def full(self) -> bool:
        return self.count >= self.capacity

    @property
    def live_count(self) -> int:
        """Occupied entries that are not tombstones."""
        return self.count - self.tombs

    def _invalidate(self):
        self._dev = None
        self._dev_bits = None

    # ---------------------------------------------------------------- write
    def insert(self, key, value: int, shadows: bool = False,
               shadows_sealed: bool = False, tomb: bool = False) -> bool:
        """Upsert one entry. Returns True when a *new* key was added
        (False: existing entry overwritten — value AND all three bits).
        ``shadows`` (sb) marks a physical base twin this entry corrects
        for; ``shadows_sealed`` (ss) a sealed-buffer twin; ``tomb`` records
        a delete. The caller must seal/fold a full buffer first
        (``engine/store.py`` double-buffers on overflow)."""
        key = self.dtype.type(key)
        if key == self.sentinel:
            raise ValueError("key equals the sentinel; out of key domain")
        w = self.node_width
        # a key above every node max appends into the last node (mirrors the
        # device probe's clip; the node's max then grows to the key)
        j = min(int(np.searchsorted(self.node_max, key, side="left")),
                self.nn - 1)
        cnt = int(self.h_cnt[j])
        pos = int(np.searchsorted(self.h_keys[j, :cnt], key, side="left"))
        if pos < cnt and self.h_keys[j, pos] == key:
            self.h_vals[j, pos] = value
            self.h_shadow[j, pos] = shadows
            self.h_ss[j, pos] = shadows_sealed
            self.tombs += int(tomb) - int(self.h_tomb[j, pos])
            self.h_tomb[j, pos] = tomb
            self._invalidate()
            return False
        if self.full:
            raise ValueError("delta buffer full; merge before inserting")
        if cnt == w:
            # node overflow: flatten, place the key, re-open gaps everywhere
            keys, vals, sh, ss, tb = self.entries()
            p = int(np.searchsorted(keys, key, side="left"))
            self._respread(np.insert(keys, p, key),
                           np.insert(vals, p, np.int32(value)),
                           np.insert(sh, p, bool(shadows)),
                           np.insert(ss, p, bool(shadows_sealed)),
                           np.insert(tb, p, bool(tomb)))
        else:
            # shift the node tail one slot right (numpy buffers overlapping
            # basic-slice assignment) and drop the key in — at most w moves
            self.h_keys[j, pos + 1: cnt + 1] = self.h_keys[j, pos: cnt]
            self.h_vals[j, pos + 1: cnt + 1] = self.h_vals[j, pos: cnt]
            self.h_shadow[j, pos + 1: cnt + 1] = self.h_shadow[j, pos: cnt]
            self.h_ss[j, pos + 1: cnt + 1] = self.h_ss[j, pos: cnt]
            self.h_tomb[j, pos + 1: cnt + 1] = self.h_tomb[j, pos: cnt]
            self.h_keys[j, pos] = key
            self.h_vals[j, pos] = value
            self.h_shadow[j, pos] = shadows
            self.h_ss[j, pos] = shadows_sealed
            self.h_tomb[j, pos] = tomb
            self.h_cnt[j] = cnt + 1
            self.node_max[j] = self.h_keys[j, cnt]
        self.count += 1
        self.tombs += int(tomb)
        self._invalidate()
        return True

    def find(self, key):
        """(node, pos) of an occupied key, or None — the host twin of the
        device probe (tombstoned entries are found too: the write path
        needs the physical slot, aliveness is the h_tomb bit)."""
        key = self.dtype.type(key)
        j = min(int(np.searchsorted(self.node_max, key, side="left")),
                self.nn - 1)
        cnt = int(self.h_cnt[j])
        pos = int(np.searchsorted(self.h_keys[j, :cnt], key, side="left"))
        if pos < cnt and self.h_keys[j, pos] == key:
            return j, pos
        return None

    def sync(self, slot, value: int, tomb: bool):
        """Overwrite value + tombstone of an occupied slot IN PLACE, keeping
        its sb/ss bits — the write path's lower-twin sync (a newer tier's
        write makes every older physical copy mirror the newest state)."""
        j, pos = slot
        self.h_vals[j, pos] = value
        self.tombs += int(tomb) - int(self.h_tomb[j, pos])
        self.h_tomb[j, pos] = tomb
        self._invalidate()

    def promote_ss(self):
        """Post-fold bit rewrite (engine/store.py maintain): the sealed
        buffer this one's ss bits pointed at has been folded into the base.
        A live ss entry's twin is now a physical base copy (ss -> sb); a
        tombstoned ss entry's twin was removed with the fold (ss -> clear,
        no base twin remains)."""
        live_ss = self.h_ss & ~self.h_tomb
        self.h_shadow |= live_ss
        self.h_ss[:] = False
        self._invalidate()

    def _respread(self, keys, vals, shadows, ss, tomb):
        """Redistribute occupied entries evenly across nodes (empties at
        tail)."""
        w, nn = self.node_width, self.nn
        self.h_keys[:] = self.sentinel
        self.h_vals[:] = 0
        self.h_shadow[:] = False
        self.h_ss[:] = False
        self.h_tomb[:] = False
        self.h_cnt[:] = 0
        self.node_max[:] = self.sentinel
        n = keys.size
        base, extra = divmod(n, nn)
        off = 0
        for j in range(nn):
            take = min(base + (1 if j < extra else 0), w)
            if take == 0:
                break
            self.h_keys[j, :take] = keys[off: off + take]
            self.h_vals[j, :take] = vals[off: off + take]
            self.h_shadow[j, :take] = shadows[off: off + take]
            self.h_ss[j, :take] = ss[off: off + take]
            self.h_tomb[j, :take] = tomb[off: off + take]
            self.h_cnt[j] = take
            self.node_max[j] = keys[off + take - 1]
            off += take
        if off != n:
            raise RuntimeError("respread lost entries")
        self.respreads += 1
        self._invalidate()

    # ---------------------------------------------------------------- read
    def live(self):
        """Occupied (keys, vals) in globally sorted key order (tombstoned
        entries included — callers needing aliveness use :meth:`entries`)."""
        if self.count == 0:
            return (np.empty(0, self.dtype), np.empty(0, np.int32))
        ks = [self.h_keys[j, : self.h_cnt[j]] for j in range(self.nn)
              if self.h_cnt[j]]
        vs = [self.h_vals[j, : self.h_cnt[j]] for j in range(self.nn)
              if self.h_cnt[j]]
        return np.concatenate(ks), np.concatenate(vs)

    def entries(self):
        """(keys, vals, sb, ss, tomb) of the occupied slots in globally
        sorted key order."""
        keys, vals = self.live()
        if self.count == 0:
            e = np.empty(0, bool)
            return keys, vals, e, e.copy(), e.copy()
        sh, ss, tb = [], [], []
        for j in range(self.nn):
            c = int(self.h_cnt[j])
            if c:
                sh.append(self.h_shadow[j, :c])
                ss.append(self.h_ss[j, :c])
                tb.append(self.h_tomb[j, :c])
        return (keys, vals, np.concatenate(sh), np.concatenate(ss),
                np.concatenate(tb))

    def drain(self):
        """Occupied (keys, vals, tomb flags), then clear — the fold path's
        one-shot read (tomb rows direct the fold to REMOVE the key from the
        base pages)."""
        keys, vals, _, _, tomb = self.entries()
        self.h_keys[:] = self.sentinel
        self.h_vals[:] = 0
        self.h_shadow[:] = False
        self.h_ss[:] = False
        self.h_tomb[:] = False
        self.h_cnt[:] = 0
        self.node_max[:] = self.sentinel
        self.count = 0
        self.tombs = 0
        self._invalidate()
        return keys, vals, tomb

    def device_state(self):
        """(d_keys [nn, w], d_vals [nn, w], d_seps [nn]) device mirrors,
        cached until the next mutation and copied without waiting for the
        stream (``upload_async``). The store calls this at the end of each
        write batch, so a lookup never copies from the host."""
        if self._dev is None:
            self._dev = (upload_async(self.h_keys, self.device),
                         upload_async(self.h_vals, self.device),
                         upload_async(self.node_max, self.device))
        return self._dev

    def device_bits(self):
        """(d_sb, d_ss, d_tomb) [nn, w] bool device mirrors, cached like
        ``device_state`` (the fused lookup uses d_tomb alone)."""
        if self._dev_bits is None:
            self._dev_bits = (upload_async(self.h_shadow, self.device),
                              upload_async(self.h_ss, self.device),
                              upload_async(self.h_tomb, self.device))
        return self._dev_bits

    # ------------------------------------------------------------ snapshot
    def state(self) -> dict:
        """Snapshot of the full buffer as a dict of arrays + counters (the
        crash-recovery checkpoint payload; DESIGN.md §6.5)."""
        return {
            "keys": self.h_keys.copy(), "vals": self.h_vals.copy(),
            "shadow": self.h_shadow.copy(), "ss": self.h_ss.copy(),
            "tomb": self.h_tomb.copy(), "cnt": self.h_cnt.copy(),
            "node_max": self.node_max.copy(),
            "meta": np.asarray([self.count, self.tombs, self.capacity,
                                self.node_width], np.int64),
        }

    @classmethod
    def from_state(cls, st: dict, *, device=None) -> "DeltaBuffer":
        """Rebuild a buffer from :meth:`state` without replaying inserts
        (the warm-restore path)."""
        count, tombs, capacity, node_width = (int(x) for x in st["meta"])
        keys = np.asarray(st["keys"])
        buf = cls(capacity, dtype=keys.dtype, node_width=node_width,
                  device=device)
        if buf.h_keys.shape != keys.shape:
            raise ValueError("delta snapshot shape mismatch: "
                             f"{keys.shape} vs {buf.h_keys.shape}")
        buf.h_keys[:] = keys
        buf.h_vals[:] = st["vals"]
        buf.h_shadow[:] = np.asarray(st["shadow"], bool)
        buf.h_ss[:] = np.asarray(st["ss"], bool)
        buf.h_tomb[:] = np.asarray(st["tomb"], bool)
        buf.h_cnt[:] = st["cnt"]
        buf.node_max[:] = st["node_max"]
        buf.count = count
        buf.tombs = tombs
        return buf


def _slots(q: torch.Tensor, d_keys: torch.Tensor, d_seps: torch.Tensor):
    """Each query's candidate slot in the flattened buffer, by one binary
    search, and the key there.

    The reference picks the node by counting the node maxima below q and
    then compares q with all ``w`` slots of that node. Here every gap slot
    (it holds the sentinel, which no key equals) is routed as its node's
    maximum instead: the routed buffer is then nondecreasing, its left
    insertion point of q is q's own slot when q is an occupied key, and
    otherwise a slot whose key differs from q, save one case that the
    reference shares: q equal to the sentinel lands on a gap slot exactly
    when the node the reference picks for it has one (the first empty
    node, else the last node's tail). A NaN query finds no slot in
    either."""
    flat = d_keys.reshape(-1)
    gap = d_keys == flat.new_full((), sentinel_for(numpy_dtype(flat.dtype)))
    route = torch.where(gap, d_seps[:, None], d_keys).reshape(-1)
    at = torch.searchsorted(route, q).clamp_max(flat.shape[0] - 1)
    return at, flat[at]


def probe(q: torch.Tensor, d_keys: torch.Tensor, d_vals: torch.Tensor,
          d_seps: torch.Tensor):
    """Branch-free delta probe: the slot of q among the occupied keys (one
    binary search, :func:`_slots`), the hit where that slot holds q and
    its value (0 where there is no hit, as the reference's masked sum
    gives). Returns (hit [Q] bool, value [Q] int32)."""
    at, key = _slots(q, d_keys, d_seps)
    hit = key == q
    return hit, torch.where(hit, d_vals.reshape(-1)[at], 0)


def probe_full(q: torch.Tensor, d_keys: torch.Tensor, d_vals: torch.Tensor,
               d_tomb: torch.Tensor, d_seps: torch.Tensor):
    """:func:`probe` extended with the tombstone plane: returns
    (hit [Q] bool — the key occupies a slot, tombstoned or not;
    tomb [Q] bool — the occupying entry is a tombstone; value [Q] int32).
    The store's fused lookup resolves recency with these: a newer tier's
    hit decides found = hit & ~tomb before any older tier is consulted."""
    at, key = _slots(q, d_keys, d_seps)
    hit = key == q
    return (hit, hit & d_tomb.reshape(-1)[at],
            torch.where(hit, d_vals.reshape(-1)[at], 0))
