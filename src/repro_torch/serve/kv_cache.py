"""Paged prefix KV store with index-compiled lookup (PyTorch port of
``repro/serve/kv_cache.py``).

Prompt tokens split into pages of ``page_size`` tokens; each page's
*chained* hash identifies the whole prefix up to and including that page.
Cached (hash -> page payload) entries sit in one of the port's indexes
(``IndexConfig.kind``, any kind), probed on the card. Every hit is verified against the stored tokens
before reuse, so a hash collision truncates the reuse and never corrupts
it.

The default probe is the mutable tiered store (``engine/store.py``), as
in the reference: inserts go through its delta buffer and page-local
merges, never a wholesale rebuild. With ``mutable=False`` inserts mark
the immutable snapshot dirty and the next probe rebuilds it (the
reference's wholesale posture). ``save`` / ``restore`` snapshot the pages
(and the mutable index's own snapshot and journal) as the reference does.
Batched probes (``lookup_batch``) go through the store's micro-batch
queue (``probe_queue``, DESIGN.md §7), each prompt's hash chain on its
tenant's admission lane. Payloads are device tensors: cloned slices of
the prefill cache.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..ckpt import checkpoint as _ckpt
from ..core import IndexConfig, build_index
from ..core.util import resolve_device
from ..engine.queue import DEFAULT_TENANT, MicroBatchQueue, index_probe_fn

_MASK31 = (1 << 31) - 1
_SEED = 0x9E3779B1
_MULT = 1_000_003
_ADD = 0x7F4A7C15


def chain_hashes_ref(tokens: np.ndarray, page_size: int) -> np.ndarray:
    """Scalar reference for :func:`chain_hashes` (per-token Python loop)."""
    tokens = np.asarray(tokens, np.int64)
    n_pages = len(tokens) // page_size
    hs, h = [], np.int64(_SEED)
    for i in range(n_pages):
        blk = tokens[i * page_size: (i + 1) * page_size]
        for t in blk:                                  # simple polynomial mix
            h = (h * _MULT + t + _ADD) & _MASK31
        # emitted hashes stay strictly below the int32 sentinel (the index
        # key-domain contract); 2^31-1 folds onto 2^31-2, one more tolerated
        # collision, caught by token verification like any other
        hs.append(min(int(h), _MASK31 - 1))
    return np.asarray(hs, np.int32)


def chain_hashes(tokens: np.ndarray, page_size: int) -> np.ndarray:
    """Chained per-page hashes of a token sequence (int32, 31-bit).

    Vectorized form of :func:`chain_hashes_ref`: a Horner pass over token
    positions (``page_size`` steps, each vectorized across all pages)
    computes every page's polynomial block value, then a loop over pages
    chains them (h_i = h_{i-1}·M^s + b_i mod 2^31). Bit-identical to the
    scalar loop: every op is +/× followed by the 31-bit mask, and int64
    wraparound is harmless because x mod 2^64 determines x mod 2^31.
    """
    tokens = np.asarray(tokens, np.int64)
    n_pages = len(tokens) // page_size
    if n_pages == 0:
        return np.empty(0, np.int32)
    blk = tokens[: n_pages * page_size].reshape(n_pages, page_size)
    b = np.zeros(n_pages, np.int64)
    for j in range(page_size):                 # Horner, vectorized over pages
        b = (b * _MULT + blk[:, j] + _ADD) & _MASK31
    mult_page = pow(_MULT, page_size, 1 << 31)
    hs = np.empty(n_pages, np.int64)
    h = np.int64(_SEED)
    for i in range(n_pages):                   # O(pages) chain, not O(tokens)
        h = (h * mult_page + b[i]) & _MASK31
        hs[i] = h
    # clamp below the int32 sentinel (see chain_hashes_ref); the chain state
    # itself stays unclamped in both forms
    return np.minimum(hs, _MASK31 - 1).astype(np.int32)


@dataclass
class PrefixPageStore:
    page_size: int
    # default probe: the mutable tiered store (DESIGN.md §6) — inserts go
    # through the delta buffer, never a wholesale rebuild
    index_config: IndexConfig = field(default_factory=lambda: IndexConfig(
        kind="tiered", plan="device", mutable=True))
    device: Any = None                               # None: the CUDA card
    hashes: list = field(default_factory=list)       # int32 chained hash per page
    tokens: list = field(default_factory=list)       # np [page tokens] per page
    payloads: list = field(default_factory=list)     # per-page payload (KV slices)
    _index: Any = None
    _dirty: bool = True
    _known: set = field(default_factory=set)         # hashes, kept incrementally
    _queue: Any = None                               # lazy MicroBatchQueue
    revision: int = 0                                # bumps when pages land
    stats: dict = field(default_factory=lambda: {
        "lookups": 0, "hits": 0, "rebuilds": 0, "verify_rejects": 0})

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ---------------------------------------------------------------- write
    def insert(self, prompt_tokens: np.ndarray, page_payloads: list):
        """Store pages of a finished prefill. page_payloads[i] is the KV
        payload for page i (len == full pages in the prompt)."""
        hs = chain_hashes(prompt_tokens, self.page_size)
        new_keys, new_slots = [], []
        for i, h in enumerate(hs[: len(page_payloads)]):
            h = int(h)
            if h in self._known:
                continue
            new_slots.append(len(self.hashes))
            new_keys.append(h)
            self.hashes.append(h)
            self.tokens.append(np.asarray(
                prompt_tokens[: (i + 1) * self.page_size], np.int32))
            self.payloads.append(page_payloads[i])
            self._known.add(h)
        if not new_keys:
            return
        self.revision += 1          # batched probes can tell their snapshot aged
        if self.index_config.mutable:
            # the delta path: O(delta work) per new page, page-local merges
            if self._index is None:
                self._index = build_index(np.empty(0, np.int32),
                                          config=self.index_config,
                                          device=self.device)
            self._index.insert(np.asarray(new_keys, np.int32),
                               np.asarray(new_slots, np.int32))
            self._dirty = False
        else:
            self._dirty = True                       # wholesale posture

    def rebuild_index(self):
        """Batch rebuild: the read-optimized structure is regenerated over
        every stored hash, with the slot as its value. The mutable default
        never calls this."""
        if not self.hashes:
            self._index = None
        else:
            self._index = build_index(
                np.asarray(self.hashes, np.int32),
                values=np.arange(len(self.hashes), dtype=np.int32),
                config=self.index_config, device=self.device)
        self._dirty = False
        self.stats["rebuilds"] += 1

    @property
    def index_stats(self) -> dict:
        """Write-path counters of the mutable index (empty when wholesale)."""
        return dict(getattr(self._index, "stats", {}) or {})

    # ---------------------------------------------------------------- read
    def _verify(self, prompt_tokens: np.ndarray, hs: np.ndarray,
                found: np.ndarray, slot: np.ndarray):
        """Turn an index probe over a prompt's chained hashes into the
        longest *verified* payload chain (hash collisions truncate)."""
        out = []
        for i in range(len(hs)):
            if not found[i]:
                break
            s = int(slot[i])
            want = np.asarray(prompt_tokens[: (i + 1) * self.page_size], np.int32)
            if (self.tokens[s].shape != want.shape) or not np.array_equal(
                    self.tokens[s], want):
                self.stats["verify_rejects"] += 1
                break                                  # hash collision
            out.append(self.payloads[s])
        if out:
            self.stats["hits"] += 1
        return len(out), out

    def _probe(self, hs: np.ndarray):
        """One index lookup over the hashes -> (found, slot) on the host."""
        res = self._index.lookup(torch.from_numpy(hs).to(self.device))
        return res.found.cpu().numpy(), res.values.cpu().numpy()

    def lookup(self, prompt_tokens: np.ndarray):
        """Longest reusable prefix. Returns (n_pages_hit, payloads[list])."""
        self.stats["lookups"] += 1
        if self._dirty and not self.index_config.mutable:
            self.rebuild_index()
        if self._index is None:
            return 0, []
        hs = chain_hashes(prompt_tokens, self.page_size)
        if hs.size == 0:
            return 0, []
        return self._verify(prompt_tokens, hs, *self._probe(hs))

    def probe_queue(self):
        """The store's cross-request micro-batch queue (DESIGN.md §7),
        lazily built from the IndexConfig queue knobs. All batched probes
        (:meth:`lookup_batch`) aggregate through it, so concurrent callers
        share one index lookup a flush."""
        if self._queue is None:
            c = self.index_config
            self._queue = MicroBatchQueue(
                # late-bound: rebuild_index / the mutable store may swap
                # self._index between flushes
                lambda q: index_probe_fn(self._index)(q),
                capacity=c.queue_capacity, deadline_s=c.queue_deadline_s,
                min_flush=c.queue_min_flush, adapt=c.queue_adapt,
                max_share=c.queue_max_share,
                adaptive_deadline=c.queue_adaptive_deadline,
                deadline_floor_s=c.queue_deadline_floor_s,
                max_backlog=c.queue_max_backlog, path="probe")
        return self._queue

    def lookup_batch(self, prompts: list, tenants: Optional[list] = None):
        """Longest reusable prefix for MANY prompts with ONE index probe:
        every prompt's hash chain is submitted to the micro-batch queue,
        the first blocking result demand-flushes the lot as one lookup
        (the chains joined on the host and uploaded once), and each prompt
        verifies its own slice. Returns ``[(n_pages_hit, payloads), ...]``
        in prompt order.

        ``tenants`` (optional, one id per prompt) lands each prompt's probe
        on that tenant's admission lane (DESIGN.md §7.1), and per-tenant
        wait / occupancy stats accrue in the queue's ledger. The chains
        are submitted as one arrival (``submit_many``): the queue's
        deadline timer cannot flush part of them ahead of the rest.

        Probes in one batch see the same store snapshot: a prompt cannot
        reuse pages another prompt of the *same* batch is about to
        insert."""
        self.stats["lookups"] += len(prompts)
        if self._dirty and not self.index_config.mutable:
            self.rebuild_index()
        if self._index is None:
            return [(0, [])] * len(prompts)
        hs_list = [chain_hashes(p, self.page_size) for p in prompts]
        queue = self.probe_queue()
        tenants = tenants or [DEFAULT_TENANT] * len(prompts)
        live = [i for i, hs in enumerate(hs_list) if hs.size]
        futs = dict(zip(live, queue.submit_many(
            [(hs_list[i], tenants[i]) for i in live])))
        out = []
        for i, (prompt, hs) in enumerate(zip(prompts, hs_list)):
            fut = futs.get(i)
            if fut is None:
                out.append((0, []))
                continue
            res = fut.result()
            out.append(self._verify(prompt, hs, res.found.cpu().numpy(),
                                    res.values.cpu().numpy()))
        return out

    # ---------------------------------------------------------------- durability
    def save(self, ckpt_dir: str) -> str:
        """Snapshot the page store (hashes, tokens, payloads) plus, for the
        mutable posture, the index's own snapshot and journal under
        ``ckpt_dir/index`` (DESIGN.md §6.5). Payloads are copied to the
        host. Returns the snapshot's directory."""
        tree = {
            "meta": np.asarray([self.page_size, len(self.hashes)], np.int64),
            "hashes": np.asarray(self.hashes, np.int32),
            "tok": {str(i): np.asarray(t, np.int32)
                    for i, t in enumerate(self.tokens)},
            "pay": {str(i): {name: t.cpu().numpy() for name, t in ent.items()}
                    for i, ent in enumerate(self.payloads)},
        }
        step = (_ckpt.latest_step(ckpt_dir) or 0) + 1
        path = _ckpt.save(ckpt_dir, step, tree)
        if self.index_config.mutable and self._index is not None:
            self._index.save(os.path.join(ckpt_dir, "index"))
        return path

    @classmethod
    def restore(cls, ckpt_dir: str, index_config: Optional[IndexConfig] = None,
                device=None) -> "PrefixPageStore":
        """A servable store from the newest verifying snapshot, on
        ``device`` (default: the CUDA card). The mutable index restores
        from its own snapshot and journal replay (no O(n) rebuild); the
        wholesale posture marks the index dirty, rebuilt at the first
        lookup."""
        raw, _step = _ckpt.restore(ckpt_dir)
        page_size, n = (int(x) for x in np.asarray(raw["meta"]))
        kw = {"page_size": page_size, "device": device}
        if index_config is not None:
            kw["index_config"] = index_config
        store = cls(**kw)
        store.hashes = [int(h) for h in np.asarray(raw["hashes"])[:n]]
        store.tokens = [np.asarray(raw[f"tok/{i}"], np.int32)
                        for i in range(n)]
        # one pass over the snapshot's "pay/<page>/<name>" entries
        store.payloads = [{} for _ in range(n)]
        for k, v in raw.items():
            if k.startswith("pay/"):
                i, name = k[len("pay/"):].split("/", 1)
                if int(i) < n:
                    store.payloads[int(i)][name] = \
                        torch.from_numpy(v).to(store.device)
        store._known = set(store.hashes)
        idx_dir = os.path.join(ckpt_dir, "index")
        if store.index_config.mutable and os.path.isdir(idx_dir):
            from ..engine.store import MutableIndex
            store._index = MutableIndex.restore(idx_dir, store.index_config,
                                                device=store.device)
            store._dirty = False
        else:
            store._dirty = True          # wholesale: rebuilt on lookup
        return store


# --------------------------------------------------------------- KV slicing
def slice_cache_pages(cfg, cache: dict, n_tokens: int, page_size: int):
    """Split a prefill cache's K/V into per-page payloads
    ``{"k": [L, B, page_size, Hkv, hd], "v": ...}``, cloned so that later
    writes into the cache leave them alone."""
    payloads = []
    for i in range(n_tokens // page_size):
        lo, hi = i * page_size, (i + 1) * page_size
        payloads.append({"k": cache["k"][:, :, lo:hi].clone(),
                         "v": cache["v"][:, :, lo:hi].clone()})
    return payloads


def write_pages_into_cache(cache: dict, payloads: list, page_size: int):
    """Install reused page payloads at the head of a fresh cache, in
    place."""
    for i, ent in enumerate(payloads):
        lo = i * page_size
        cache["k"][:, :, lo:lo + page_size] = ent["k"]
        cache["v"][:, :, lo:lo + page_size] = ent["v"]
    cache["lengths"].clamp_min_(len(payloads) * page_size)
    return cache
