"""Public facade over the index-search core — PyTorch port of
``repro/core/api.py`` for ``kind="tiered"``.

    idx = build_index(keys, values, IndexConfig(kind="tiered"))  # on cuda
    hit = idx.lookup(queries)        # -> LookupResult(rank, found, values)
    r = idx.scan_range(lo, hi)       # -> engine.scan.ScanResult
    store = build_index(keys, values, IndexConfig(kind="tiered",
                                                  mutable=True))
    store.insert(new_keys, new_values); store.delete(old_keys)
    store.save(ckpt_dir); store = restore_index(ckpt_dir)

``build_index`` places the index on the CUDA card unless the caller passes
``device``; without a card it raises unless ``device="cpu"``. Kinds,
options and methods that are not ported yet raise ``NotImplementedError``
naming the ROADMAP item that brings them; none falls back to something
else.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..engine import scan, tiered
from .util import as_queries, not_ported, resolve_device

KINDS = ("binary", "css", "kary", "fast", "nitrogen", "tiered")
PORTED_KINDS = ("tiered",)


@dataclass(frozen=True)
class IndexConfig:
    kind: str = "css"
    node_width: int = 128        # css/kary/fast: keys per node
    leaf_width: Optional[int] = None
    linear_cutoff: int = 1       # binary: switch-to-linear threshold
    page_depth: int = 2          # fast: directory levels per page
    levels: int = 3              # nitrogen: compiled levels
    compiled_node_width: int = 3  # nitrogen: separators per compiled node
    bottom: str = "binary"       # nitrogen: base approach under the code
    intra: str = "vector"        # css: intra-node search style
    top: str = "auto"            # tiered: top tier ('auto'|'nitrogen'|'kary')
    tile: int = 128              # tiered: queries per bucket / grid step
    plan: str = "device"         # tiered: schedule placement ('device'|'host')
    specialize: bool = False     # compile the index into the program
    mutable: bool = False        # delta-merge write path
    delta_capacity: int = 1024   # mutable: delta buffer size (rounded to pow2)
    maintenance: str = "deferred"  # 'deferred'|'inline'|'thread' fold policy
    maintenance_interval_s: float = 0.05  # thread mode: fold timer delay
    ckpt_dir: Optional[str] = None  # journal + snapshot dir (None = off)
    ckpt_keep: int = 3           # snapshots retained by Index.save rotation
    journal_fsync: str = "rotate"  # WAL sync: 'never'|'rotate'|'always'
    queue_capacity: int = 4096   # hard flush trigger (pending queries)
    queue_deadline_s: float = 0.002  # max time a submit may wait in-queue
    queue_min_flush: int = 64    # floor of the adaptive flush threshold
    queue_adapt: bool = True     # occupancy feedback steers the threshold
    queue_max_share: float = 1.0  # hard cap on one tenant's share of a flush
    queue_adaptive_deadline: bool = True  # EWMA rate scales the flush window
    queue_deadline_floor_s: float = 1e-4  # lower bound of the scaled window
    queue_max_backlog: int = 0   # per-tenant pending-query limit (0 = off)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown index kind {self.kind!r}; want one of {KINDS}")
        if self.plan not in ("device", "host"):
            raise ValueError(
                f"unknown plan mode {self.plan!r}; want 'device' or 'host'")
        if self.specialize and self.kind == "tiered" and self.plan == "host":
            raise ValueError(
                "specialize=True requires the device plan for kind='tiered' "
                "(the host BucketPlan reads per-batch stats that cannot be "
                "baked into the executable); use plan='device'")
        if self.mutable and self.delta_capacity <= 0:
            raise ValueError(
                f"delta_capacity must be positive, got {self.delta_capacity}")
        if self.maintenance not in ("deferred", "inline", "thread"):
            raise ValueError(
                f"unknown maintenance mode {self.maintenance!r}; want "
                "'deferred', 'inline' or 'thread'")
        if self.maintenance_interval_s < 0:
            raise ValueError(
                f"maintenance_interval_s must be >= 0, got "
                f"{self.maintenance_interval_s}")
        if self.ckpt_keep <= 0:
            raise ValueError(
                f"ckpt_keep must be positive, got {self.ckpt_keep}")
        if self.journal_fsync not in ("never", "rotate", "always"):
            raise ValueError(
                f"unknown journal_fsync policy {self.journal_fsync!r}; "
                "want 'never', 'rotate' or 'always'")
        if self.queue_capacity <= 0:
            raise ValueError(
                f"queue_capacity must be positive, got {self.queue_capacity}")
        if self.queue_deadline_s < 0:
            raise ValueError(
                f"queue_deadline_s must be >= 0, got {self.queue_deadline_s}")
        if not (0.0 < self.queue_max_share <= 1.0):
            raise ValueError(
                f"queue_max_share must be in (0, 1], got "
                f"{self.queue_max_share}")
        if self.queue_deadline_floor_s < 0:
            raise ValueError(
                f"queue_deadline_floor_s must be >= 0, got "
                f"{self.queue_deadline_floor_s}")
        if self.queue_max_backlog < 0:
            raise ValueError(
                f"queue_max_backlog must be >= 0, got "
                f"{self.queue_max_backlog}")

    @classmethod
    def from_tuned(cls, platform: Optional[str] = None, **overrides):
        raise not_ported("IndexConfig.from_tuned",
                         "item 11 (specialization and autotune)")


@dataclass(frozen=True)
class LookupResult:
    rank: torch.Tensor           # searchsorted-left rank, int32 [Q]
    found: torch.Tensor          # bool [Q]
    values: Optional[torch.Tensor]  # payload for hits (arbitrary for misses)


@dataclass(frozen=True)
class Index:
    config: IndexConfig
    impl: Any
    keys_sorted: torch.Tensor
    values_sorted: Optional[torch.Tensor]
    n: int

    def search(self, queries) -> torch.Tensor:
        return tiered.search(self.impl, queries)

    def lookup(self, queries) -> LookupResult:
        q = as_queries(queries, self.keys_sorted)
        rank = self.search(q)
        safe = rank.clamp_max(self.n - 1).long()
        found = (rank < self.n) & (self.keys_sorted[safe] == q)
        vals = None
        if self.values_sorted is not None:
            vals = self.values_sorted[safe]
        return LookupResult(rank=rank, found=found, values=vals)

    def search_range(self, lo, hi) -> tuple:
        """Range query: for each pair, the half-open rank interval
        [r_lo, r_hi_excl) of keys with lo <= key <= hi, plus the match
        count. Exact under duplicate keys at either endpoint; ``lo > hi``
        normalizes to the empty interval at r_lo. Runs through the
        range-scan subsystem (``engine/scan.py``): both endpoints descend
        the top tier in one pass, with no host sync."""
        return tiered.search_range(self.impl, lo, hi)

    def scan_range(self, lo, hi, *, aggs=None,
                   materialize: Optional[int] = None):
        """Batched range scan with aggregation pushdown: per query the
        match count, rank interval and, when the index carries
        int32/float32 values, their sum / min / max, without materializing
        matches. ``aggs`` (e.g. ``("count", "sum")``) caps the pushdown
        depth: the kernel then reads and computes strictly less.
        ``materialize=K`` also returns the first K matching ranks (and
        values) per query with an overflow flag. Returns
        ``engine.scan.ScanResult``."""
        return self._scanner().scan_range(lo, hi, aggs=aggs,
                                          materialize=materialize)

    def scan_groups(self, lo, hi, num_groups, *, aggs=None,
                    top_k: Optional[int] = None,
                    candidates: Optional[int] = None):
        """Grouped range analytics: each ``(lo, hi)`` range splits into
        ``num_groups`` equal-width key buckets with per-bucket count / sum /
        min / max (``aggs`` caps the depth) and optional per-bucket
        ``top_k`` values (``candidates`` bounds the window read per
        bucket). Count/sum ride a (G+1)-edge prefix pipeline that never
        scans interior pages. Returns ``engine.groupby.GroupScanResult``."""
        return self._scanner().scan_groups(lo, hi, num_groups, aggs=aggs,
                                           top_k=top_k,
                                           candidates=candidates)

    def scan_multi(self, ranges, *, op: str = "union", aggs=None):
        """Composite multi-range predicates: ``ranges`` is [Q, R, 2]
        inclusive (lo, hi) pairs per query, combined as a union (IN-list of
        ranges) or an intersection (conjunctive predicate). Returns
        ``engine.scan.ScanResult`` whose r_lo/r_hi_excl are the rank hull
        of the matching set."""
        return self._scanner().scan_multi(ranges, op=op, aggs=aggs)

    def _scanner(self):
        return scan.scanner_for(self.impl, self.values_sorted)

    def delete(self, keys):
        """Frozen indexes have no write path: deletes need the mutable
        store (``IndexConfig(mutable=True)``)."""
        raise TypeError(
            "this index is immutable; build with "
            "IndexConfig(mutable=True) for insert/delete support")

    def save(self, ckpt_dir=None):
        """Snapshot / restore is the mutable store's durability contract
        (``MutableIndex.save``); frozen indexes are rebuilt from their
        source arrays."""
        raise TypeError(
            "this index is immutable; build with "
            "IndexConfig(mutable=True) for save/restore support")


def check_ported(config: IndexConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item when
    ``config`` asks for a kind or option the port does not have yet."""
    if config.kind not in PORTED_KINDS:
        raise not_ported(f"kind={config.kind!r}",
                         "item 12 (the other index kinds)")
    if config.specialize:
        raise not_ported("IndexConfig(specialize=True)",
                         "item 11 (specialization and autotune)")


def build_index(keys, values=None, config: IndexConfig = IndexConfig(),
                device=None):
    """Build an index on ``device`` (default: the CUDA card). With
    ``config.mutable`` it returns the delta-merge store,
    ``engine.store.MutableIndex`` (lookup, insert, delete, maintain),
    which also accepts an empty initial key set."""
    check_ported(config)
    device = resolve_device(device)
    if config.mutable:
        from ..engine.store import MutableIndex
        return MutableIndex(config, keys, values, device=device)
    keys = np.asarray(keys)
    order = np.argsort(keys, kind="stable")
    srt = keys[order]
    vals = None
    if values is not None:
        values = np.asarray(values)
        if values.shape[0] != keys.shape[0]:
            raise ValueError("values must align with keys")
        vals = torch.from_numpy(values[order]).to(device)
    c = config
    impl = tiered.build(srt, leaf_width=c.leaf_width, tile=c.tile, top=c.top,
                        plan=c.plan, device=device)
    return Index(config=c, impl=impl, keys_sorted=torch.from_numpy(srt)
                 .to(device), values_sorted=vals, n=int(srt.size))


def restore_index(ckpt_dir: str, config: IndexConfig = IndexConfig(
        kind="tiered", mutable=True), device=None):
    """Warm-restart a mutable index from its checkpoint directory on
    ``device`` (default: the CUDA card): the newest verifying snapshot (a
    corrupt latest degrades to the previous step with a warning) plus a
    replay of the journaled writes after it, with no O(n) rebuild
    (DESIGN.md §6.5). Reads directories the reference wrote."""
    if not config.mutable:
        raise ValueError("restore_index requires IndexConfig(mutable=True)")
    check_ported(config)
    from ..engine.store import MutableIndex
    return MutableIndex.restore(ckpt_dir, config,
                                device=resolve_device(device))


def from_reference_arrays(state: dict, config: IndexConfig = IndexConfig(
        kind="tiered"), *, device) -> Index:
    """The port's Index from the numpy form of a reference tiered Index:
    the arrays ``tiered.from_reference_arrays`` takes, plus
    ``keys_sorted`` and optionally ``values_sorted``."""
    check_ported(config)
    if config.mutable:
        raise ValueError("from_reference_arrays builds the immutable index; "
                         "pass a config with mutable=False")
    device = resolve_device(device)
    srt = np.array(state["keys_sorted"])
    vals = state.get("values_sorted")
    return Index(
        config=config,
        impl=tiered.from_reference_arrays(dict(state, plan=config.plan),
                                          device=device),
        keys_sorted=torch.from_numpy(srt).to(device),
        values_sorted=None if vals is None else torch.from_numpy(
            np.array(vals)).to(device),
        n=int(srt.size))
