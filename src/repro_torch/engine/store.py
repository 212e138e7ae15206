"""MutableIndex — the delta-merge write path over a read-optimized base
(DESIGN.md §6), PyTorch port of ``repro/engine/store.py``.

* **writes** land in a small gapped delta buffer (``engine/delta.py``,
  CSB+-style incremental insert, power-of-two capacity);
* **reads** probe the base and both delta tiers in one pass with no host
  sync: the tiered pipeline over gapped leaf pages (the CUDA page and
  k-ary kernels on the card) plus the delta probe, newest tier first;
* **merges** fold an overflowing buffer into the leaf pages
  *page-locally*: only touched pages are rewritten (host row surgery, then
  the touched rows copied in place on the device) and the top tier keeps
  routing on its separators. It is re-derived only when a page overflows
  ``leaf_width`` and the store repacks, i.e. when ``num_pages`` changes.

Leaf pages are **gapped**: packed at ``MERGE_FILL`` so most merges absorb
locally. Each page is nondecreasing — a sorted live prefix, then sentinel
gaps — so the page kernel's binary search counts the live-prefix slot,
and the pipeline (stride ``lw_pad``) yields a flat storage address
instead of a dense rank. A delete keeps the base key and changes only its
value to ``TOMBSTONE`` until the next fold removes the row.

**Scans** (``scan_range``, ``search_range``, ``scan_groups``,
``scan_multi``) run the immutable index's span pipeline over the gapped
pages (tombstone values masked) and correct it per delta tier from the
tier's key-sorted view (``engine/scan.py``); the first scan after a write
pushes the host-synced value rows and rebuilds the page aggregates, with
no host sync. **Durability** (DESIGN.md §6.5): with ``ckpt_dir`` every
write batch is journaled ahead of application (``ckpt/journal.py``),
``save`` snapshots the store and rotates the journal, and ``restore``
adopts the newest verifying snapshot and replays the journal; the files
are the reference's, so either package restores the other's.

**Telemetry**: the reference's ``store.*`` and ``journal.*`` spans and
its ``engine_op_seconds`` / ``engine_ops`` paths (lookup, seal, fold,
journal, scan, scan_groups, scan_multi, snapshot_save, snapshot_restore),
at the same boundaries. The executed plan's step count leaves a lookup
through :meth:`MutableIndex.pop_plan_feedback`, whose thunk waits on a
CUDA event instead of the stream.

**Specialization** (DESIGN.md §10): with ``specialize=True`` every
derive (build, repack, restore) also arms ``_spec_fused``, the fused
lookup with the base's key and value pages bound in; on the card it
replays one CUDA graph per batch shape (``engine/capture.py``), the
delta tiers copied into the graph's buffers when they change. Unlike the
reference, a page-local fold or a value-row sync keeps it armed: the port
rewrites base rows in place, so the bound pages stay the live ones.

**A non-tiered base** (``kind`` binary, css, kary, fast or nitrogen) is
the frozen ``core.api.Index`` of that kind, rebuilt wholesale at every
fold from the host copy of its sorted keys and values (``_flat``): the
lookup is the base's lookup plus the same delta overlay, with no plan
feedback; writes test membership against the host keys; the scans take
the reference's host path over the merged live snapshot (``_merged_host``)
— answered here with searchsorted and a ``scan.FlatAggregator`` over that
snapshot instead of a loop a query, the same bits — and a snapshot stores
the base as ``flat/keys`` and ``flat/vals``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..ckpt import checkpoint as _ckpt
from ..ckpt import journal as _jr
from ..core.util import (as_queries, ceil_to, resolve_device, sentinel_for,
                         take, upload_async)
from ..kernels import ops
from ..obs import get_registry, span, timed_op
from . import delta as _delta
from . import groupby as _gb
from . import scan as _scan
from . import tiered
from .capture import Captures, Specialized
from .schedule import executed_occupancy

# Target page fill after a pack or split: the remaining (1-fill)·leaf_width
# gap slots are what lets a merge stay page-local instead of splitting.
MERGE_FILL = 0.75

# Reserved VALUE sentinel marking a deleted key (DESIGN.md §6.4). Values
# are always int32 regardless of key dtype; user inserts of this value are
# rejected. A tombstone-synced base slot keeps its key but holds this
# value, and is removed for real at the next fold or repack.
TOMBSTONE = int(np.iinfo(np.int32).min)

MAINTENANCE_MODES = ("deferred", "inline", "thread")


def _retire(old, new) -> None:
    """A superseded top or base: its generated NitroGen kernel, if it has
    one that the new one does not share, deletes its build files when it
    is released (kernels/nitrogen_codegen.py), so that repacks leave no
    files behind. The module itself goes when nothing holds it."""
    kernel = getattr(old, "kernel", None)
    if kernel is not None and kernel is not getattr(new, "kernel", None):
        kernel.retire()


def _dedup_last(keys: np.ndarray, values: np.ndarray):
    """Sort by key, keep the LAST duplicate (upsert semantics: later wins)."""
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], values[order]
    if ks.size:
        keep = np.append(ks[1:] != ks[:-1], True)
        ks, vs = ks[keep], vs[keep]
    return ks, vs


class _PagedBase:
    """Gapped-leaf tiered base: host (numpy) truth + device mirrors + the
    rank pipeline. All mutation goes through ``merge``."""

    def __init__(self, keys_sorted: np.ndarray, vals_sorted: np.ndarray, *,
                 leaf_width: Optional[int] = None, tile: int = 128,
                 top: str = "auto", vmem_budget: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        self.dtype = keys_sorted.dtype
        self.sentinel = sentinel_for(self.dtype)
        self.tile = int(tile)
        self.top_cfg = top
        self.vmem_budget = vmem_budget or ops.VMEM_BUDGET_BYTES
        n = int(keys_sorted.size)
        auto_lw, _, _ = tiered.plan_tiers(n, tile=tile,
                                          vmem_budget=self.vmem_budget)
        self.leaf_width = int(leaf_width) if leaf_width else auto_lw
        self.lw_pad = ceil_to(self.leaf_width, 128)
        per = max(1, int(self.leaf_width * MERGE_FILL))
        chunks = [keys_sorted[i: i + per] for i in range(0, n, per)] or \
                 [keys_sorted]
        self._alloc(len(chunks))
        for p, ck in enumerate(chunks):
            m = ck.size
            self.keys[p, :m] = ck
            self.vals[p, :m] = vals_sorted[p * per: p * per + m]
            self.cnt[p] = m
            self.seps[p] = ck[-1] if m else self.sentinel
        self.derives = 0
        self._derive()

    def _alloc(self, num_pages: int):
        self.keys = np.full((num_pages, self.lw_pad), self.sentinel,
                            self.dtype)
        self.vals = np.zeros((num_pages, self.lw_pad), np.int32)
        self.cnt = np.zeros(num_pages, np.int64)
        self.seps = np.full(num_pages, self.sentinel, self.dtype)

    @property
    def num_pages(self) -> int:
        return self.keys.shape[0]

    @property
    def n(self) -> int:
        return int(self.cnt.sum())

    def find_slot(self, key):
        """(page, pos) of a live key in the gapped leaves, or None — the
        host twin of the device probe, used by the insert path's
        shadowed-key tracking (DESIGN.md §8.2)."""
        p = min(int(np.searchsorted(self.seps, key, side="left")),
                self.num_pages - 1)
        cnt = int(self.cnt[p])
        pos = int(np.searchsorted(self.keys[p, :cnt], key, side="left"))
        if pos < cnt and self.keys[p, pos] == key:
            return p, pos
        return None

    def _derive(self):
        """(Re-)derive the top tier + pipeline from the current pages and
        upload the pages. Called at build and on repack (num_pages
        change) — never on a page-local merge."""
        P = self.num_pages
        old = getattr(self, "top", None)
        self.top_kind, self.top = tiered.build_top(
            self.seps, top=self.top_cfg, vmem_budget=self.vmem_budget,
            device=self.device)
        _retire(old, self.top)
        self.page_of_raw = tiered._make_page_of_raw(self.top_kind, self.top,
                                                    P)
        # stride = lw_pad: the pipeline returns flat slot addresses into the
        # gapped [P, lw_pad] storage (the clip keeps the address
        # gatherable); with_stats: it also yields the plan's step count
        self.pipeline_stats = tiered._make_pipeline(
            self.page_of_raw, num_pages=P, stride=self.lw_pad,
            tile=self.tile, clip=P * self.lw_pad - 1, with_stats=True)
        self.dev_keys = upload_async(self.keys, self.device)
        self.dev_vals = upload_async(self.vals, self.device)
        self.derives += 1

    # ---------------------------------------------------------------- merge
    def merge(self, dk: np.ndarray, dv: np.ndarray,
              dt: Optional[np.ndarray] = None) -> dict:
        """Fold sorted unique delta entries into the leaf pages. Page-local
        when every touched page stays within leaf_width; otherwise the
        store repacks (num_pages changes, top re-derived). ``dt`` flags
        tombstone rows: a tombstone with a resident twin REMOVES the twin
        (the page may go empty — its stale separator keeps routing,
        reclaimed at the next repack); one without a twin is dropped."""
        if dt is None:
            dt = np.zeros(dk.shape, bool)
        P, lw = self.num_pages, self.leaf_width
        pids = np.minimum(np.searchsorted(self.seps, dk, side="left"), P - 1)
        merged = {}
        overflow = False
        for p in np.unique(pids):
            sel = pids == p
            ks, vs, ts = dk[sel], dv[sel], dt[sel]
            cnt = int(self.cnt[p])
            pk = self.keys[p, :cnt]
            pv = self.vals[p, :cnt].copy()
            pos = np.searchsorted(pk, ks, side="left")
            if cnt:
                isdup = (pos < cnt) & (pk[np.minimum(pos, cnt - 1)] == ks)
            else:
                isdup = np.zeros(ks.shape, bool)
            upd = isdup & ~ts
            pv[pos[upd]] = vs[upd]                   # live upsert
            keep = np.ones(cnt, bool)
            keep[pos[isdup & ts]] = False            # tombstone: remove row
            ins = ~isdup & ~ts                       # twin-less tomb: drop
            mk = np.concatenate([pk[keep], ks[ins]])
            mv = np.concatenate([pv[keep], vs[ins]])
            order = np.argsort(mk, kind="stable")
            merged[int(p)] = (mk[order], mv[order])
            overflow |= mk.size > lw
        if not overflow:
            self._write_rows(merged)
            return {"touched": len(merged), "split": False,
                    "rows_rewritten": len(merged)}
        return self._repack(merged)

    def _write_rows(self, merged: dict):
        idx = np.fromiter(sorted(merged), np.int64, len(merged))
        for p in idx:
            mk, mv = merged[int(p)]
            m = mk.size
            self.keys[p, :] = self.sentinel
            self.vals[p, :] = 0
            self.keys[p, :m] = mk
            self.vals[p, :m] = mv
            self.cnt[p] = m
            if m and mk[-1] > self.seps[p]:
                self.seps[p] = mk[-1]            # grow-only (last page)
            # separators NEVER shrink (tombstone removals can lower a
            # page's max): the top routes on its derive-time seps, so host
            # routing must agree with it — a stale larger sep keeps both
            # consistent, the vacated span just misses correctly. An empty
            # page likewise keeps its sep until the next repack.
        # device: the touched rows copied over their mirrors in place, on
        # the current stream (after any lookup already queued on it)
        rows = torch.from_numpy(idx).to(self.device)
        self.dev_keys.index_copy_(0, rows, upload_async(self.keys[idx],
                                                          self.device))
        self.dev_vals.index_copy_(0, rows, upload_async(self.vals[idx],
                                                          self.device))

    def _repack(self, merged: dict) -> dict:
        """A page overflowed leaf_width: repack ALL live entries at
        MERGE_FILL so every page regains gap headroom, and re-derive the
        top tier (num_pages changed). O(n) row moves but NO re-sort (pages
        concatenate in key order), amortized over the ~(1-MERGE_FILL)·n
        inserts it takes to overflow again."""
        splits = sum(mk.size > self.leaf_width for mk, _ in merged.values())
        parts_k, parts_v = [], []
        for p in range(self.num_pages):
            if p in merged:
                mk, mv = merged[p]
            else:
                c = int(self.cnt[p])
                mk, mv = self.keys[p, :c], self.vals[p, :c]
            parts_k.append(mk)
            parts_v.append(mv)
        ks = np.concatenate(parts_k)
        vs = np.concatenate(parts_v)
        per = max(1, int(self.leaf_width * MERGE_FILL))
        num_pages = max(1, -(-ks.size // per))
        self._alloc(num_pages)
        for p in range(num_pages):
            ck = ks[p * per: (p + 1) * per]
            m = ck.size
            self.keys[p, :m] = ck
            self.vals[p, :m] = vs[p * per: p * per + m]
            self.cnt[p] = m
            self.seps[p] = ck[-1] if m else self.sentinel
        self._derive()
        return {"touched": len(merged), "split": True, "splits": splits,
                "rows_rewritten": num_pages, "num_pages": num_pages}

    # ------------------------------------------------------------ snapshot
    def state(self) -> dict:
        """Snapshot of the leaf storage — everything a warm restore needs
        to skip the O(n) sort/chunk build (the top tier is re-derived from
        ``seps``, never persisted)."""
        return {"keys": self.keys.copy(), "vals": self.vals.copy(),
                "cnt": self.cnt.copy(), "seps": self.seps.copy(),
                "meta": np.asarray([self.leaf_width, self.tile], np.int64)}

    @classmethod
    def from_state(cls, st: dict, *, top: str = "auto",
                   vmem_budget: Optional[int] = None,
                   device=None) -> "_PagedBase":
        """Adopt snapshot arrays directly (no sort, no chunking) and
        re-derive the top — the restore path's O(pages) build."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        keys = np.array(st["keys"])
        self.dtype = keys.dtype
        self.sentinel = sentinel_for(self.dtype)
        meta = np.asarray(st["meta"])
        self.leaf_width = int(meta[0])
        self.tile = int(meta[1])
        self.top_cfg = top
        self.vmem_budget = vmem_budget or ops.VMEM_BUDGET_BYTES
        self.lw_pad = keys.shape[1]
        self.keys = keys
        self.vals = np.array(st["vals"], np.int32)
        self.cnt = np.array(st["cnt"], np.int64)
        self.seps = np.array(st["seps"], self.dtype)
        self.derives = 0
        self._derive()
        return self


class MutableIndex:
    """Mutable point-lookup store: delta buffer over a read-optimized base.

    Built through ``core.api.build_index(..., IndexConfig(mutable=True))``,
    on ``device`` (default: the CUDA card). ``lookup`` returns the
    facade's LookupResult; under a tiered base, ``rank`` is a flat *slot
    address* into the gapped leaf storage (pages carry gap slots, so dense
    searchsorted ranks do not exist here); under another kind's base it
    is the base's rank. The found/values contract is unchanged. Keys are
    unique (inserting an existing key overwrites its value — recency
    wins).
    """

    def __init__(self, config, keys=None, values=None, *, device=None):
        self.config = config
        if config.kind == "tiered" and config.plan != "device":
            # the fused base+delta lookup exists only in device-plan form;
            # silently ignoring plan="host" would mask a misconfiguration
            raise ValueError(
                "the mutable store runs the device plan only; "
                "plan='host' (BucketPlan stats) requires mutable=False")
        self.device = resolve_device(device)
        keys = np.asarray([] if keys is None else keys)
        if keys.size and values is None:
            values = np.arange(keys.size, dtype=np.int32)
        self._key_dtype = keys.dtype if keys.size else np.dtype(np.int32)
        self.delta = _delta.DeltaBuffer(config.delta_capacity,
                                        dtype=self._key_dtype,
                                        device=self.device)
        # the frozen twin: a full active buffer swaps here and is folded
        # into the base off the hot path (maintain); same capacity so the
        # swap is O(1) and the lookup sees one shape
        self.sealed = _delta.DeltaBuffer(self.delta.capacity,
                                         dtype=self._key_dtype,
                                         device=self.device)
        self._mode = getattr(config, "maintenance", "deferred")
        if self._mode not in MAINTENANCE_MODES:
            raise ValueError(f"unknown maintenance mode {self._mode!r}; "
                             f"want one of {MAINTENANCE_MODES}")
        self._interval = getattr(config, "maintenance_interval_s", 0.05)
        self._lock = threading.RLock()
        self._timer = None
        self._closed = False
        self.base: Any = None
        self.stats = {"inserts": 0, "upserts": 0, "deletes": 0, "merges": 0,
                      "splits": 0, "pages_touched": 0, "rows_rewritten": 0,
                      "top_derives": 0, "base_rebuilds": 0, "shadowed": 0,
                      "seals": 0, "maintains": 0, "journal_replayed": 0}
        self._last_plan = None        # (q_n, steps, tile, P) of last lookup
        self._rev = 0                 # mutation revision (scan-state cache)
        self._dirty_rows = set()      # pages with host-synced shadow values
        self._scan_fns = None         # scan fns per base structure
        self._scan_state = None       # (rev, ScanAux, tier views)
        self._host_state = None       # (rev, keys, values, FlatAggregator)
        self.captures = Captures()    # specialized lookups armed / captured
        self._spec_fused = None
        if keys.size:
            ks, vs = _dedup_last(keys, np.asarray(values, np.int32))
            if np.any(vs == TOMBSTONE):
                raise ValueError("value equals the tombstone sentinel "
                                 f"({TOMBSTONE}); out of value domain")
            self._build_base(ks, vs)
        self._fused = self._make_lookup()
        self._upload_tiers()
        # durability (DESIGN.md §6.5): with a checkpoint dir configured,
        # every write is journaled ahead of application; save() snapshots
        # and rotates the journal segment
        self._ckpt_dir = config.ckpt_dir
        self._ckpt_keep = config.ckpt_keep
        self._journal = None
        if self._ckpt_dir:
            self._open_journal(self._ckpt_dir)

    # ---------------------------------------------------------------- build
    def _build_base(self, ks: np.ndarray, vs: np.ndarray):
        c = self.config
        if c.kind == "tiered":
            self.base = _PagedBase(ks, vs, leaf_width=c.leaf_width,
                                   tile=c.tile, top=c.top, device=self.device)
            self.stats["top_derives"] = self.base.derives
            return
        from ..core.api import build_index
        old = getattr(self.base, "impl", None)
        self.base = build_index(ks, vs, dataclasses.replace(c, mutable=False),
                                device=self.device)
        _retire(old, self.base.impl)
        self._flat = (ks, vs)
        self.stats["base_rebuilds"] += 1

    @property
    def _paged(self) -> bool:
        return isinstance(self.base, _PagedBase)

    def _upload_tiers(self):
        """Refresh the cached device mirrors of both delta tiers. A write
        batch, a seal and a fold end here, so that ``lookup`` only reads
        tensors already on the device and never waits on a copy."""
        for buf in (self.delta, self.sealed):
            buf.device_state()
            buf.device_bits()

    def _make_lookup(self):
        """Fused three-tier lookup: (rank, found, values, plan_steps) over
        base + sealed + active delta with no host sync. Recency resolves
        newest-first — an active hit decides found = hit & ~tomb before
        the sealed tier is consulted, sealed before the base — and a
        tombstone anywhere reads as not-found. ``plan_steps`` is the
        executed device plan's step count (a 0-d device tensor), None
        without a base.

        With ``specialize=True`` it also (re-)arms ``self._spec_fused``:
        the same lookup with the base's freshly derived key and value
        pages bound in, the tiers still arguments. Armed only here, and
        _make_lookup runs exactly at the derive boundaries (build, repack,
        restore), so writes between derives never re-arm it. Unlike the
        reference, which disarms it at every row scatter (its donation
        deletes the bound buffers), the port writes base rows in place
        (``_write_rows``, ``_ensure_scan``): the bound pages stay the live
        ones and the twin stays armed."""
        probe_full = _delta.probe_full
        self._spec_fused = None

        def overlay(q, bfound, bval, tiers):
            # tiers newest-first: [(dk, dv, dtb, dsp), ...]
            found, val = bfound, bval
            for dk, dv, dtb, dsp in reversed(tiers):   # oldest applied first
                hit, tomb, tval = probe_full(q, dk, dv, dtb, dsp)
                found = torch.where(hit, ~tomb, found)
                val = torch.where(hit, tval, val)
            return found, val

        if self.base is None:
            def fused(q, ak, av, atb, asp, sk, sv, stb, ssp):
                found, val = overlay(
                    q, torch.zeros(q.shape, dtype=torch.bool,
                                   device=q.device),
                    torch.zeros(q.shape, dtype=torch.int32, device=q.device),
                    [(ak, av, atb, asp), (sk, sv, stb, ssp)])
                return torch.zeros(q.shape, dtype=torch.int32,
                                   device=q.device), found, val, None
            return fused
        if not self._paged:
            base = self.base                # another kind's frozen Index

            def fused(q, ak, av, atb, asp, sk, sv, stb, ssp):
                res = base.lookup(q)
                found, val = overlay(q, res.found, res.values,
                                     [(ak, av, atb, asp), (sk, sv, stb, ssp)])
                return res.rank, found, val, None
            return fused
        pipeline = self.base.pipeline_stats

        def fused(q, pages, vpages, ak, av, atb, asp, sk, sv, stb, ssp):
            addr, steps = pipeline(q, pages)
            bval = take(vpages.reshape(-1), addr)
            # a tombstone-synced base slot is a deleted key: its tier twin
            # answers first anyway, the value guard is the restore path's
            # belt-and-braces
            bfound = (take(pages.reshape(-1), addr) == q) \
                & (bval != TOMBSTONE)
            found, val = overlay(q, bfound, bval, [(ak, av, atb, asp),
                                                   (sk, sv, stb, ssp)])
            return addr, found, val, steps
        if self.config.specialize:
            pages, vpages = self.base.dev_keys, self.base.dev_vals
            # the tiers are replaced (never written in place) when they
            # change, which is what operands= asks of them
            self._spec_fused = Specialized(
                lambda q, *tiers: fused(q, pages, vpages, *tiers),
                device=self.device, captures=self.captures, operands=8)
        return fused

    # ---------------------------------------------------------------- write
    def insert(self, keys, values):
        """Upsert a batch. O(w) per key on the hot path: a full active
        buffer SWAPS with the empty sealed twin (O(1)) instead of merging
        inline — the fold into the leaf pages runs off the hot path
        (:meth:`maintain`, explicit / inline / timer-thread per the
        ``maintenance`` config knob). Writes sync every lower twin of the
        key to the newest state (sealed value+tomb, base value)."""
        keys = np.atleast_1d(np.asarray(keys, self._key_dtype))
        values = np.atleast_1d(np.asarray(values, np.int32))
        if keys.shape != values.shape:
            raise ValueError("keys/values must align")
        if np.any(values == TOMBSTONE):
            raise ValueError("value equals the tombstone sentinel "
                             f"({TOMBSTONE}); out of value domain")
        self._write(keys, values, delete=False)

    def delete(self, keys):
        """Delete a batch by key — a tombstone through the same delta path
        as insert (idempotent; deleting an absent key is a no-op
        tombstone). Lookups read the key as not-found immediately; the
        fold physically removes the base row and the repack reclaims the
        slot."""
        keys = np.atleast_1d(np.asarray(keys, self._key_dtype))
        self._write(keys, np.full(keys.shape, TOMBSTONE, np.int32),
                    delete=True)

    def _write(self, keys, values, *, delete: bool):
        with self._lock:
            jr = self._journal
            if jr is not None:
                # write-ahead for the WHOLE batch, then apply: replay is an
                # idempotent upsert, so batch-level WAL ordering is
                # equivalent to per-key interleaving, and it puts the
                # journal cost in one measured place; a delete journals
                # value 0, as the reference's does
                with timed_op("journal.append", "journal",
                              n=int(keys.size)):
                    jr.append_many(keys, np.zeros(keys.shape, np.int32)
                                   if delete else values, delete=delete)
                    jr.flush()
            for k, v in zip(keys, values):
                if self.delta.full:
                    self._seal()
                # ---- lower-twin sync + bit derivation (DESIGN.md §6.3):
                # sb = no sealed twin AND a base twin exists (this entry
                # carries the base copy's correction); ss = a sealed twin
                # exists (the sealed entry keeps carrying any sb)
                sslot = self.sealed.find(k)
                ss = sslot is not None
                if ss:
                    self.sealed.sync(sslot, int(v), delete)
                sb = False
                base = self.base
                if base is not None and not self._paged:
                    # a non-tiered base is rebuilt at the fold: membership
                    # of its host keys decides the shadow bit, no sync
                    bk = self._flat[0]
                    pos = int(np.searchsorted(bk, k, side="left"))
                    sb = (not ss) and pos < bk.size and bool(bk[pos] == k)
                elif base is not None:
                    slot = base.find_slot(k)
                    if slot is not None:
                        sb = not ss
                        p, pos = slot
                        nv = TOMBSTONE if delete else v
                        if base.vals[p, pos] != nv:
                            base.vals[p, pos] = nv
                            self._dirty_rows.add(int(p))
                if self.delta.insert(k, v, shadows=sb, shadows_sealed=ss,
                                     tomb=delete):
                    self.stats["deletes" if delete else "inserts"] += 1
                    if sb:
                        self.stats["shadowed"] += 1
                else:
                    self.stats["upserts"] += 1
            self._rev += 1
            self._upload_tiers()

    def _seal(self):
        """Swap the full active buffer with the (empty) sealed twin — the
        O(1) hot-path hand-off. Backpressure: if the previous sealed
        buffer has not been folded yet, fold it now (the only path where
        a writer still pays a merge)."""
        with span("store.seal"):
            if self.sealed.count:
                self.maintain()
            self.delta, self.sealed = self.sealed, self.delta
            self.stats["seals"] += 1
            get_registry().counter("engine_ops", path="seal").inc()
            self._rev += 1
            if self._mode == "inline":
                self.maintain()
            elif self._mode == "thread":
                self._arm_timer()

    def maintain(self) -> bool:
        """Fold the sealed buffer into the base — the off-hot-path
        maintenance step. Returns True when a fold ran. After the fold
        the active buffer's ss bits are promoted (live ss -> sb: the twin
        is now a physical base copy) or cleared (tombstoned ss: the twin
        was removed with the fold)."""
        with self._lock:
            if self.sealed.count == 0:
                return False
            dk, dv, dt = self.sealed.drain()
            self.stats["maintains"] += 1
            self.stats["merges"] += 1
            self._rev += 1
            with timed_op("store.fold", "fold", n=int(dk.size)):
                self._fold(dk, dv, dt)
            self.delta.promote_ss()
            self._upload_tiers()
            return True

    def _fold(self, dk, dv, dt):
        live = ~dt
        if self.base is None:
            if live.any():
                self._build_base(dk[live], dv[live])
                self._dirty_rows.clear()
                self._fused = self._make_lookup()
            return
        if not self._paged:
            self._fold_wholesale(dk, dv, dt)
            return
        info = self.base.merge(dk, dv, dt)
        self.stats["pages_touched"] += info["touched"]
        self.stats["rows_rewritten"] += info["rows_rewritten"]
        self.stats["top_derives"] = self.base.derives
        if info["split"]:
            # repack renumbered the pages; stale dirty-row ids die here
            self._dirty_rows.clear()
            self.stats["splits"] += info["splits"]
            self._fused = self._make_lookup()
        # a page-local merge keeps the pipeline and the specialized twin:
        # its rows were copied into the bound device pages in place (the
        # reference disarms the twin here; its scatter donates them)

    def _fold_wholesale(self, dk, dv, dt):
        """A non-tiered base's fold: upserts, removals and inserts applied
        to the host arrays, then a rebuild (or no base when everything was
        deleted)."""
        live = ~dt
        bk, bv = self._flat
        pos = np.searchsorted(bk, dk, side="left")
        if bk.size:
            isdup = (pos < bk.size) & \
                (bk[np.minimum(pos, bk.size - 1)] == dk)
        else:
            isdup = np.zeros(dk.shape, bool)
        bv = bv.copy()
        upd = isdup & live
        bv[pos[upd]] = dv[upd]
        keep = np.ones(bk.size, bool)
        keep[pos[isdup & dt]] = False
        ins = ~isdup & live
        mk = np.concatenate([bk[keep], dk[ins]])
        mv = np.concatenate([bv[keep], dv[ins]])
        if mk.size:
            order = np.argsort(mk, kind="stable")
            self._build_base(mk[order], mv[order])
        else:
            self.base = None                     # everything deleted
        self._fused = self._make_lookup()

    def flush(self):
        """Force-fold everything (sealed, then active) into the base —
        tests/benchmarks and the pre-snapshot quiesce."""
        with self._lock:
            if self.delta.count:
                self._seal()                     # folds old sealed first
            self.maintain()

    # ------------------------------------------------------- worker thread
    def _arm_timer(self):
        """Arm the one-shot maintenance timer (``maintenance="thread"``):
        identity-checked under the lock, idempotent, dead after close()."""
        with self._lock:
            if self._closed or self._timer is not None:
                return
            t = threading.Timer(self._interval, self._tick)
            t.daemon = True
            self._timer = t
            t.start()

    def _tick(self):
        with self._lock:
            self._timer = None
            if self._closed:
                return
            self.maintain()

    def close(self):
        """Cancel the maintenance timer and close the journal (idempotent;
        the store stays readable)."""
        with self._lock:
            self._closed = True
            t, self._timer = self._timer, None
            jr, self._journal = self._journal, None
        if t is not None:
            t.cancel()
        if jr is not None:
            jr.close()

    # ---------------------------------------------------------------- read
    def lookup(self, queries):
        """Lookup over base + delta (newest tier wins) with no host sync:
        on the card, the page and k-ary kernels and the delta probe, over
        tensors already on the device. Returns core.api.LookupResult. The
        executed plan's step count (a device scalar) is retained for
        :meth:`pop_plan_feedback`."""
        from ..core.api import LookupResult
        # the lock spans the whole dispatch: a maintenance thread's fold
        # rewrites rows in place on the same stream, after these kernels.
        # The timer measures the host cost of issuing the kernels, which
        # return without waiting on the device: no sync added
        with self._lock:
            ak, av, asp = self.delta.device_state()
            _, _, atb = self.delta.device_bits()
            sk, sv, ssp = self.sealed.device_state()
            _, _, stb = self.sealed.device_bits()
            tiers = (ak, av, atb, asp, sk, sv, stb, ssp)
            q = as_queries(queries, ak)
            with timed_op("store.lookup", "lookup", n=int(q.shape[0])):
                if not self._paged:
                    rank, found, vals, _ = self._fused(q, *tiers)
                    self._last_plan = None
                else:
                    if self._spec_fused is not None:     # pages bound in
                        out = self._spec_fused(q, *tiers)
                    else:
                        out = self._fused(q, self.base.dev_keys,
                                          self.base.dev_vals, *tiers)
                    rank, found, vals, steps = out
                    self._last_plan = (int(q.shape[0]), steps,
                                       self.base.tile, self.base.num_pages)
        return LookupResult(rank=rank, found=found, values=vals)

    def pop_plan_feedback(self):
        """Executed-plan occupancy of the most recent lookup, as a lazy
        thunk (or None when the base is not paged / nothing ran), with no host
        sync here or in the thunk's normal case. On the card the step
        count is copied now, behind the lookup's kernels, into page-locked
        host memory without blocking, and a CUDA event is recorded after
        the copy; the thunk waits on that event alone (not on the stream),
        and a caller that resolves it a dispatch later (the micro-batch
        queue, at its next flush) finds it complete."""
        fb, self._last_plan = self._last_plan, None
        if fb is None:
            return None
        q_n, steps, tile, num_pages = fb
        if steps.device.type != "cuda":
            return lambda: executed_occupancy(q_n, int(steps), tile,
                                              num_pages)
        host = torch.empty((), dtype=steps.dtype, pin_memory=True)
        host.copy_(steps, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(steps.device))

        def thunk():
            copied.synchronize()
            return executed_occupancy(q_n, int(host), tile, num_pages)
        return thunk

    # ---------------------------------------------------------------- scan
    def _ensure_scan(self):
        """(scan fns, device ScanAux, (sealed, active) tier views) for the
        range scans, rebuilt lazily: the fns when the base structure
        changed (a derive); the aux arrays, the dirty value rows and both
        tiers' sorted views (``scan.TierView``) when any mutation happened
        (keyed on ``_rev``). Nothing here waits for the stream: rows, aux
        and views go up through page-locked staging (``upload_async``)."""
        base = self.base
        key = -1 if base is None else base.derives
        if self._scan_fns is None or self._scan_fns["key"] != key:
            kd = self._key_dtype
            if base is None:
                make_agg, make_mat = _scan.make_delta_scan_fns(kd)
                gmk = _gb.make_delta_group_fns(kd)
            else:
                span_of = tiered._make_span_of(base.page_of_raw, kd)
                shape = dict(num_pages=base.num_pages, lw_pad=base.lw_pad,
                             tile=base.tile, key_dtype=kd,
                             mask_value=TOMBSTONE)
                make_agg, make_mat = _scan.make_paged_scan_fns(span_of,
                                                               **shape)
                gmk = _gb.make_paged_group_fns(span_of, base.page_of_raw,
                                               **shape)
            self._scan_fns = {"key": key, "make_agg": make_agg,
                              "make_mat": make_mat, "gmk": gmk}
        if self._scan_state is None or self._scan_state[0] != self._rev:
            aux = None
            if base is not None:
                if self._dirty_rows:
                    # push the host-synced shadowed values to the device
                    # rows (the keys of these rows did not change)
                    idx = np.fromiter(sorted(self._dirty_rows), np.int64,
                                      len(self._dirty_rows))
                    base.dev_vals.index_copy_(
                        0, upload_async(idx, self.device),
                        upload_async(base.vals[idx], self.device))
                    self._dirty_rows.clear()
                aux = _scan.build_page_aux(base.cnt, base.vals, np.int32,
                                           mask_value=TOMBSTONE,
                                           device=self.device)
            tiers = tuple(_scan.tier_view(t.h_keys, t.h_vals, t.h_shadow,
                                          t.h_ss, t.h_tomb, self.device)
                          for t in (self.sealed, self.delta))
            self._scan_state = (self._rev, aux, tiers)
        return self._scan_fns, *self._scan_state[1:]

    def _scan_args(self, *queries):
        """The scan operands: (scan fns, the query tensors, then ``kpages,
        vpages, aux`` (with a base) and the sealed and active tiers'
        views). The caller holds the lock across the whole dispatch: a
        maintenance thread's fold rewrites page rows in place on the same
        stream, and a scan's later kernels must not read them against the
        aux and views of before the fold."""
        fns, aux, tiers = self._ensure_scan()
        qs = tuple(as_queries(x, tiers[0].keys).contiguous()
                   for x in queries)
        if self.base is None:
            return fns, (*qs, *tiers)
        b = self.base
        return fns, (*qs, b.dev_keys, b.dev_vals, aux, *tiers)

    def scan_range(self, lo, hi, *, aggs=None, materialize=None):
        """Batched delta-aware range scan (DESIGN.md §8.2): count / sum /
        min / max over the live values in [lo, hi] and exact merged
        searchsorted ranks, with no host sync (span pipeline over the
        gapped pages, each tier's sorted view, the shadow corrections).
        ``aggs`` caps the pushdown depth as on the immutable index (count
        mode never reads the value pages). ``materialize=K`` also returns
        the first K matches' slot addresses (base region, then the delta
        region at ``P*lw_pad + slot``) and values in key order, with an
        overflow flag. Returns ``engine.scan.ScanResult``. A non-tiered
        base takes the host path (:meth:`_scan_host`)."""
        mode = _scan.mode_for_aggs(aggs)
        with self._lock:                 # across the dispatch, as lookup
            if self._host_scans:
                return self._scan_host(*self._host_queries(lo, hi), mode,
                                       materialize)
            fns, args = self._scan_args(lo, hi)
            if materialize is None:
                with timed_op("store.scan", "scan", mode=mode):
                    count, vsum, vmin, vmax, r_lo, r_hi = \
                        fns["make_agg"](mode)(*args)
                return _scan.ScanResult(count=count, r_lo=r_lo,
                                        r_hi_excl=r_hi, vsum=vsum,
                                        vmin=vmin, vmax=vmax)
            K = int(materialize)
            with timed_op("store.scan", "scan", mode=mode, materialize=K):
                count, vsum, vmin, vmax, r_lo, r_hi, ranks, vals, over = \
                    fns["make_mat"](K, mode)(*args)
        return _scan.ScanResult(count=count, r_lo=r_lo, r_hi_excl=r_hi,
                                vsum=vsum, vmin=vmin, vmax=vmax,
                                ranks=ranks, values=vals, overflow=over)

    def search_range(self, lo, hi):
        """Exact merged range ranks over base + delta: for each ``lo[i] <=
        hi[i]`` the half-open interval [r_lo, r_hi_excl) among the live
        merged keys, and the match count; lo > hi normalizes to the empty
        interval at r_lo. A count-mode scan: the value pages are never
        read."""
        r = self.scan_range(lo, hi, aggs=("count",))
        return r.r_lo, r.r_hi_excl, r.count

    def scan_groups(self, lo, hi, num_groups, *, aggs=None, top_k=None,
                    candidates=None):
        """Delta-aware GROUP BY bucket(key) over [lo, hi] (DESIGN.md
        §8.3): G equal-width buckets per query; count / sum through the
        (G+1)-edge prefix pipeline with per-tier shadow corrections, min /
        max through the per-bucket span expansion, optional per-bucket
        ``top_k`` by value over a ``candidates``-bounded merged window.
        Returns ``engine.groupby.GroupScanResult`` (topk_ranks are slot
        addresses, as materialize gives). A non-tiered base takes the host
        path (:meth:`_scan_groups_host`)."""
        mode = _scan.mode_for_aggs(aggs)
        G = int(num_groups)
        if not 1 <= G <= _gb.MAX_GROUPS:
            raise ValueError(f"num_groups must be in [1, {_gb.MAX_GROUPS}]"
                             f", got {num_groups}")
        K = C = None
        if top_k is not None:
            K = int(top_k)
            if K < 1:
                raise ValueError(f"top_k must be positive, got {top_k}")
            C = max(int(candidates) if candidates is not None
                    else max(2 * K, 32), K)
        with self._lock:                 # across the dispatch, as lookup
            if self._host_scans:
                return self._scan_groups_host(*self._host_queries(lo, hi),
                                              G, mode, K, C)
            fns, args = self._scan_args(lo, hi)
            mk_gagg, mk_gtopk, _ = fns["gmk"]
            with timed_op("store.scan", "scan_groups", mode=mode, groups=G):
                out = (mk_gagg(G, mode) if K is None
                       else mk_gtopk(G, mode, K, C))(*args)
        names = ("edges", "r_edge", "count", "vsum", "vmin", "vmax",
                 "topk_values", "topk_ranks", "overflow")
        return _gb.GroupScanResult(**dict(zip(names, out)))

    def scan_multi(self, ranges, *, op="union", aggs=None):
        """Delta-aware composite R-range predicates ([Q, R, 2] inclusive
        pairs; union = IN-list, intersect = conjunction) through the
        coverage-count decomposition. Returns ``engine.scan.ScanResult``
        whose r_lo / r_hi_excl are the merged-rank hull of the matching
        set ((0, 0) when empty). A non-tiered base takes the host path
        (:meth:`_scan_multi_host`)."""
        if op not in _gb.MULTI_OPS:
            raise ValueError(f"unknown multi-range op {op!r}; "
                             f"want one of {_gb.MULTI_OPS}")
        mode = _scan.mode_for_aggs(aggs)
        with self._lock:                 # across the dispatch, as lookup
            host = self._host_scans
            if host:
                fns, args = None, self._host_queries(ranges)
            else:
                fns, args = self._scan_args(ranges)
            r = args[0]
            if r.dim() != 3 or r.shape[-1] != 2:
                raise ValueError(f"ranges must be [Q, R, 2], got "
                                 f"{tuple(r.shape)}")
            R = int(r.shape[1])
            if R < 1:
                raise ValueError("ranges needs at least one range per "
                                 "query")
            if host:
                return self._scan_multi_host(r, op, mode)
            _, _, mk_magg = fns["gmk"]
            with timed_op("store.scan", "scan_multi", mode=mode, op=op):
                count, vsum, vmin, vmax, r_lo, r_hi = mk_magg(R, op, mode)(
                    r[..., 0], r[..., 1], *args[1:])
        return _scan.ScanResult(count=count, r_lo=r_lo, r_hi_excl=r_hi,
                                vsum=vsum, vmin=vmin, vmax=vmax)

    # ------------------------------------------------ host path (flat base)
    @property
    def _host_scans(self) -> bool:
        """The scans of a non-tiered base take the host path (the fused
        span machinery is the paged store's)."""
        return self.base is not None and not self._paged

    def _host_queries(self, *queries):
        like = self.delta.device_state()[0]
        return tuple(as_queries(x, like).contiguous() for x in queries)

    def _merged_host(self):
        """Numpy snapshot of the LIVE sorted (keys, values) view: base +
        delta tiers overlaid newest-last (active wins over sealed wins over
        base; a tombstone anywhere above the base deletes the key)."""
        if self.base is not None:
            bk, bv = self._flat
        else:
            bk = np.empty(0, self._key_dtype)
            bv = np.empty(0, np.int32)
        ov = {}
        for buf in (self.sealed, self.delta):
            k, v, _, _, tb = buf.entries()
            for i in range(k.size):
                ov[k[i].item()] = (int(v[i]), bool(tb[i]))
        if not ov:
            return bk, bv
        okeys = np.asarray(sorted(ov), self._key_dtype)
        # the base keys are unique and sorted: overlaid ones are found by
        # binary search (the reference's np.isin), and the live overlay
        # keys merge in by position (its stable argsort of the union)
        pos = np.searchsorted(bk, okeys)
        hit = pos < bk.size
        hit[hit] = bk[pos[hit]] == okeys[hit]
        keep = np.ones(bk.size, bool)
        keep[pos[hit]] = False
        lk = [k for k in sorted(ov) if not ov[k][1]]
        lk, lv = (np.asarray(lk, self._key_dtype),
                  np.asarray([ov[k][0] for k in lk], np.int32))
        kk = bk[keep]
        at = np.searchsorted(kk, lk)
        return np.insert(kk, at, lk), np.insert(bv[keep], at, lv)

    def _host_view(self):
        """(merged keys, merged values, their FlatAggregator) on the
        device, rebuilt when the store changed since the last scan (keyed
        on ``_rev``). Uploads do not wait for the stream."""
        st = self._host_state
        if st is None or st[0] != self._rev:
            mk, mv = self._merged_host()
            st = self._host_state = (
                self._rev, upload_async(mk, self.device),
                upload_async(mv, self.device),
                _scan.FlatAggregator(mv, device=self.device))
        return st[1:]

    def _ranks(self, mk, lo, hi):
        """Merged searchsorted ranks [r_lo, r_hi) of lo <= key <= hi, exact
        at every bound (``hi`` at the sentinel included); lo > hi gives the
        empty interval at r_lo."""
        r_lo = torch.searchsorted(mk, lo).int()
        r_hi = torch.searchsorted(mk, hi, right=True).int()
        return r_lo, torch.where(lo > hi, r_lo, r_hi)

    @staticmethod
    def _window(r_lo, cnt, mv, K):
        """materialize_interval over the merged values (an empty store has
        none to gather: every lane is past its count)."""
        if mv.numel() == 0:
            mv = torch.zeros(1, dtype=mv.dtype, device=mv.device)
        return _scan.materialize_interval(r_lo, cnt, mv, K=K)

    def _scan_host(self, lo, hi, mode, materialize):
        """Host-path scan for a non-tiered base: the reference's answers
        over the merged snapshot (searchsorted ranks, then per-query
        sums / min / max of the matching values), computed as two
        searches and FlatAggregator lookups instead of a loop a query."""
        mk, mv, fa = self._host_view()
        r_lo, r_hi = self._ranks(mk, lo, hi)
        cnt = r_hi - r_lo
        vsum, vmin, vmax = _scan.at_depth(mode, *fa(r_lo, r_hi))
        res = _scan.ScanResult(count=cnt, r_lo=r_lo, r_hi_excl=r_hi,
                               vsum=vsum, vmin=vmin, vmax=vmax)
        if materialize is None:
            return res
        ranks, vals, over = self._window(r_lo, cnt, mv, int(materialize))
        return dataclasses.replace(res, ranks=ranks, values=vals,
                                   overflow=over)

    def _scan_groups_host(self, lo, hi, G, mode, K, C):
        """Host-path grouped scan for a non-tiered base: searchsorted over
        the bucket edges on the merged snapshot; top-K over each bucket's
        first C values, ties to the lower rank."""
        mk, mv, fa = self._host_view()
        edges = _gb.group_edges(lo, hi, G, self._key_dtype)
        r_edge = torch.searchsorted(mk, edges.reshape(-1)).int() \
            .reshape(-1, G + 1)
        cnt = torch.diff(r_edge, dim=1)
        a, b = r_edge[:, :-1].reshape(-1), r_edge[:, 1:].reshape(-1)
        vsum, vmin, vmax = _scan.at_depth(
            mode, *(x.reshape(-1, G) for x in fa(a, b)))
        res = _gb.GroupScanResult(count=cnt, edges=edges, r_edge=r_edge,
                                  vsum=vsum, vmin=vmin, vmax=vmax)
        if K is None:
            return res
        ranks, vals, over = self._window(a, cnt.reshape(-1), mv, C)
        topv, topr = _gb.masked_topk(vals, ranks, cnt.reshape(-1), K)
        return dataclasses.replace(res, topk_values=topv.reshape(-1, G, K),
                                   topk_ranks=topr.reshape(-1, G, K),
                                   overflow=over.reshape(-1, G))

    def _scan_multi_host(self, r, op, mode):
        """Host-path composite-range scan for a non-tiered base: the keys
        one subrange (union) or every subrange (intersect) holds, in rank
        space. Each subrange is a rank interval of the merged snapshot;
        the union sorts them by start and trims each past its
        predecessors' reach into disjoint pieces, the intersection is
        [max start, min end). Pieces aggregate through FlatAggregator."""
        mk, mv, fa = self._host_view()
        a, b = self._ranks(mk, r[..., 0].contiguous(),
                           r[..., 1].contiguous())            # [Q, R]
        if op == "union":
            order = torch.argsort(a, dim=1, stable=True)
            a, b = torch.gather(a, 1, order), torch.gather(b, 1, order)
            reach = torch.cummax(b, dim=1).values
            prev = torch.cat([torch.full_like(a[:, :1], -1), reach[:, :-1]],
                             dim=1)
            start = torch.maximum(a, prev)
        else:
            start, b = a.amax(1, keepdim=True), b.amin(1, keepdim=True)
        live = b > start
        end = torch.where(live, b, start)
        R = start.shape[1]
        vs, mn, mx = (x.reshape(-1, R) for x in fa(start.reshape(-1),
                                                     end.reshape(-1)))
        count = (end - start).sum(1, dtype=torch.int32)
        nz = count > 0
        imax = np.iinfo(np.int32).max
        r_lo = torch.where(nz, torch.where(live, start, imax).amin(1), 0)
        r_hi = torch.where(nz, torch.where(live, end, -1).amax(1), 0)
        vsum, vmin, vmax = _scan.at_depth(
            mode, vs.sum(1, dtype=torch.int32), mn.amin(1), mx.amax(1))
        return _scan.ScanResult(count=count, r_lo=r_lo.int(),
                                r_hi_excl=r_hi.int(), vsum=vsum, vmin=vmin,
                                vmax=vmax)

    # ----------------------------------------------------------- durability
    def _open_journal(self, ckpt_dir: str):
        """Open (or continue) the journal segment of the latest snapshot
        step, cutting any torn tail and resuming the sequence counter
        after the last valid record."""
        os.makedirs(ckpt_dir, exist_ok=True)
        step = _ckpt.latest_step(ckpt_dir) or 0
        path = _jr.segment_path(ckpt_dir, step)
        seq = 0
        if os.path.exists(path):
            _jr.truncate_torn(path)
            _, recs = _jr.read_segment(path)
            if recs:
                seq = recs[-1][0] + 1
        self._journal = _jr.Journal(path, self._key_dtype, next_seq=seq,
                                    fsync=self._fsync_policy())

    def _fsync_policy(self) -> str:
        return self.config.journal_fsync or "rotate"

    def save(self, ckpt_dir: Optional[str] = None) -> str:
        """Snapshot the whole store (leaf pages, both delta tiers) through
        the manifest-verified checkpoint writer, then rotate the journal
        to a fresh segment keyed by the new step. A crash between journal
        writes and the next save loses nothing: the previous snapshot and
        its segment's replay rebuild this state (DESIGN.md §6.5). Returns
        the snapshot's directory."""
        with self._lock, timed_op("store.snapshot_save", "snapshot_save"):
            d = ckpt_dir or self._ckpt_dir
            if d is None:
                raise ValueError("no checkpoint directory: pass ckpt_dir "
                                 "or set IndexConfig.ckpt_dir")
            step = (_ckpt.latest_step(d) or 0) + 1
            tree = {"active": self.delta.state(),
                    "sealed": self.sealed.state()}
            if self._paged:
                tree["base"] = self.base.state()
            elif self.base is not None:
                bk, bv = self._flat
                tree["flat"] = {"keys": bk.copy(), "vals": bv.copy()}
            path = _ckpt.save(d, step, tree, keep=self._ckpt_keep)
            self._rotate_journal(d, step)
            return path

    def _rotate_journal(self, ckpt_dir: str, step: int):
        with span("journal.rotate", step=step):
            old, seq = self._journal, 0
            if old is not None:
                seq = old.seq
                old.close()
                # the rotated segment is immutable from here on: collapse
                # each key's overwrite chain to its last writer
                _jr.compact_segment(old.path)
            self._journal = _jr.Journal(_jr.segment_path(ckpt_dir, step),
                                        self._key_dtype, next_seq=seq,
                                        fsync=self._fsync_policy())
            get_registry().counter("journal_rotations").inc()
        self._ckpt_dir = self._ckpt_dir or ckpt_dir
        # drop the segments no retained snapshot can replay from
        retained = _ckpt.all_steps(ckpt_dir)
        floor = min(retained) if retained else 0
        for s, p in _jr.scan_dir(ckpt_dir):
            if s < floor and s != step:
                try:
                    os.remove(p)
                except OSError:
                    pass

    @classmethod
    def restore(cls, ckpt_dir: str, config, *, device=None
                ) -> "MutableIndex":
        """Bring a store back from the newest VERIFYING snapshot (a
        corrupt or torn latest degrades to the previous step) plus a
        replay of every journaled write after it, on ``device`` (default:
        the CUDA card): array adoption, one top derive and at most the
        un-snapshotted writes, never an O(n) rebuild. Journaling resumes
        on the restored store. Reads what either package wrote."""
        cfg = dataclasses.replace(config, ckpt_dir=None) \
            if config.ckpt_dir else config
        with timed_op("store.snapshot_restore", "snapshot_restore"):
            return cls._restore(cfg, config, ckpt_dir, device)

    @classmethod
    def _restore(cls, cfg, config, ckpt_dir: str, device) -> "MutableIndex":
        self = cls(cfg, device=device)
        try:
            raw, step = _ckpt.restore(ckpt_dir)
        except FileNotFoundError:
            raw, step = None, 0                  # journal-only recovery
        if raw is not None:
            def sub(prefix):
                return {k[len(prefix) + 1:]: v for k, v in raw.items()
                        if k.startswith(prefix + "/")}
            self.delta = _delta.DeltaBuffer.from_state(sub("active"),
                                                       device=self.device)
            self.sealed = _delta.DeltaBuffer.from_state(sub("sealed"),
                                                        device=self.device)
            self._key_dtype = self.delta.dtype
            if "base/keys" in raw:
                self.base = _PagedBase.from_state(sub("base"),
                                                  top=config.top,
                                                  device=self.device)
                self.stats["top_derives"] = self.base.derives
            elif "flat/keys" in raw:
                self._build_base(np.asarray(raw["flat/keys"]),
                                 np.asarray(raw["flat/vals"], np.int32))
            self._fused = self._make_lookup()
            self._upload_tiers()
            self._rev += 1
        applied, last_seq = self._replay(ckpt_dir, step)
        self.stats["journal_replayed"] = applied
        segs = [s for s, _ in _jr.scan_dir(ckpt_dir) if s >= step]
        path = _jr.segment_path(ckpt_dir, max(segs) if segs else step)
        if os.path.exists(path):
            _jr.truncate_torn(path)
        self._ckpt_dir = ckpt_dir
        self._journal = _jr.Journal(path, self._key_dtype,
                                    next_seq=last_seq + 1,
                                    fsync=self._fsync_policy())
        return self

    def _replay(self, ckpt_dir: str, from_step: int):
        """Apply the journaled writes of every segment at or after the
        restored step, in step order, stopping at the first torn or
        corrupt record or sequence regression (everything before it is
        intact by CRC). Returns (records applied, last sequence number)."""
        applied, last = 0, -1
        run_op, run_k, run_v = None, [], []

        def flush_run():
            if not run_k:
                return
            ks = np.asarray(run_k, self._key_dtype)
            if run_op == _jr.OP_DELETE:
                self.delete(ks)
            else:
                self.insert(ks, np.asarray(run_v, np.int32))

        for s, p in _jr.scan_dir(ckpt_dir):
            if s < from_step:
                continue
            _, recs = _jr.read_segment(p)
            for seq, op, k, v in recs:
                if seq <= last:
                    flush_run()                 # replay order broken: stop
                    return applied, last
                last = seq
                # consecutive records of one op go in one write call:
                # _write applies keys in order, so this equals applying
                # them one by one
                if op != run_op:
                    flush_run()
                    run_op, run_k, run_v = op, [], []
                run_k.append(k)
                run_v.append(v)
                applied += 1
        flush_run()
        return applied, last

    @property
    def n(self) -> int:
        """Exact live key count — the full-range instance of the scan
        algebra: physical base count, plus each tier's live entries, minus
        its corrections (every sb entry has exactly one physical base
        copy — live duplicate or tombstone-synced slot — and every live
        ss entry a synced sealed duplicate)."""
        base_n = 0
        if self._paged:
            base_n = self.base.n
        elif self.base is not None:
            base_n = int(self._flat[0].size)
        for buf in (self.sealed, self.delta):
            _, _, sb, ss, tb = buf.entries()
            live = ~tb
            base_n += int(live.sum()) - int(sb.sum()) \
                - int((ss & live).sum())
        return base_n

    @property
    def tree_bytes(self) -> int:
        if self._paged and self.base.top_kind == "kary":
            tree = self.base.top.tree
            return int(tree.numel() * tree.element_size())
        return 0
