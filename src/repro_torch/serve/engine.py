"""Batched serving engine: prefix-reuse prefill + batched decode (PyTorch
port of ``repro/serve/engine.py``).

Flow per request: probe the PrefixPageStore (by default the mutable tiered
store on the card) for the longest cached page chain -> install hit pages
into a fresh cache -> prefill only the uncached tail
(``prefill_continue``) -> store the new pages. The batch's probes go out
as one flush of the store's micro-batch queue. Requests then decode
together as one batch; each sampled step's CDF inversions go through the
decode queue (``decode_batching=True``, the default: one CDF-kernel
launch a step, per-tenant admission lanes with ``tenants``) or inline.
``EngineStats``' queue views read the metrics registry; the loop records
the reference's ``serve.*`` spans.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import IndexConfig
from ..engine.queue import MicroBatchQueue, tenant_summary
from ..kernels.cdf_search import cdf_probe_fn
from ..models import transformer as T
from ..obs import get_registry, span
from . import kv_cache as KV
from .sampler import SamplerConfig, sample, sample_queued


@dataclass
class EngineStats:
    """Serving counters. The wall-clock fields are engine-loop-local
    host-clock seconds; the queue-derived fields (probe / decode flushes,
    occupancy, per-tenant rows) are VIEWS over the metrics registry — the
    queues write there once and this dataclass reads it back (DESIGN.md
    §9)."""
    prefill_tokens: int = 0
    reused_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    probe_s: float = 0.0          # wall time in batched store probes
    registry: object = None       # metrics registry (None = process default)

    def _reg(self):
        return self.registry if self.registry is not None else get_registry()

    @property
    def probe_batches(self) -> int:
        """Probe-queue flushes (one index lookup each)."""
        return int(self._reg().total("queue_flushes", path="probe"))

    @property
    def probe_occupancy(self) -> float:
        """Mean executed-plan lane occupancy of the probe path."""
        return self._reg().merged_histogram("queue_flush_occupancy",
                                            path="probe").mean

    @property
    def decode_flushes(self) -> int:
        """Decode-queue flushes (one CDF inversion each)."""
        return int(self._reg().total("queue_flushes", path="decode"))

    @property
    def decode_occupancy(self) -> float:
        return self._reg().merged_histogram("queue_flush_occupancy",
                                            path="decode").mean

    @property
    def tenants(self) -> dict:
        """{(path, tenant): TenantRow} across the probe and decode queues,
        rendered from the registry by ``engine.queue.tenant_summary``."""
        return {(r.path, r.tenant): r
                for r in tenant_summary(self._reg())}


class ServeEngine:
    def __init__(self, cfg, params, *, max_len: int = 256, page_size: int = 16,
                 index_config: Optional[IndexConfig] = None,
                 sampler: SamplerConfig = SamplerConfig(temperature=0.0),
                 decode_batching: bool = True,
                 compute_dtype=torch.float32, registry=None):
        self.cfg, self.params = cfg, params
        self.device = params["embed"].device
        self.max_len, self.page_size = max_len, page_size
        self.sampler = sampler
        self.decode_batching = decode_batching
        self.dtype = compute_dtype
        self.pageable = cfg.family in T.PAGEABLE_FAMILIES
        # the default probe is the mutable tiered store, as in the reference
        self.store = KV.PrefixPageStore(
            page_size, index_config or IndexConfig(kind="tiered",
                                                   plan="device",
                                                   mutable=True),
            device=self.device)
        self.stats = EngineStats(registry=registry)
        self._decode_queue = None

    def decode_queue(self):
        """The decode-step micro-batch queue (DESIGN.md §7.1), lazily built
        from the store's IndexConfig queue knobs: every sampled step's CDF
        inversions submit per tenant and flush as one launch. Timer-free —
        ``generate`` drives flushes synchronously (each step's blocking
        ``result()`` demand-flushes), so no daemon thread races the decode
        loop."""
        if self._decode_queue is None:
            c = self.store.index_config
            self._decode_queue = MicroBatchQueue(
                cdf_probe_fn(),
                capacity=c.queue_capacity, deadline_s=c.queue_deadline_s,
                min_flush=c.queue_min_flush, adapt=c.queue_adapt,
                max_share=c.queue_max_share,
                adaptive_deadline=c.queue_adaptive_deadline,
                deadline_floor_s=c.queue_deadline_floor_s,
                max_backlog=c.queue_max_backlog, timer=False,
                path="decode")
        return self._decode_queue

    # ------------------------------------------------------------- prefill
    def prefill_one(self, tokens: np.ndarray, memory=None, probe=None):
        """Returns (last_logits [1,V], cache). Uses prefix reuse when the
        arch is pageable (dense, moe); the others (ssm, hybrid, vlm,
        audio) skip the store. ``memory`` is the vlm / audio frontend's
        embeddings [1, encoder_seq, d_model]. ``probe`` carries a
        precomputed (n_hit, payloads) from a batched store probe
        (:meth:`_probe_batch`); without it the store is probed inline, one
        request at a time."""
        t0 = time.perf_counter()
        tokens = np.asarray(tokens, np.int32)[None]        # B=1
        S = tokens.shape[1]
        if probe is not None:
            n_hit, payloads = probe
        else:
            n_hit, payloads = (self.store.lookup(tokens[0]) if self.pageable
                               else (0, []))
        # keep at least one tail token so the last logits are computed fresh
        n_hit = min(n_hit, (S - 1) // self.page_size)
        payloads = payloads[:n_hit]
        start = n_hit * self.page_size
        tok = torch.from_numpy(tokens).to(self.device)
        if start > 0:
            cache = T.init_cache(self.cfg, 1, self.max_len, self.dtype,
                                 device=self.device)
            cache = KV.write_pages_into_cache(cache, payloads, self.page_size)
            logits, cache = T.prefill_continue(
                self.cfg, self.params, tok[:, start:], cache, start,
                compute_dtype=self.dtype)
            self.stats.reused_tokens += start
            self.stats.prefill_tokens += S - start
        else:
            if memory is not None:
                memory = torch.as_tensor(memory, device=self.device)
            logits, cache = T.prefill(self.cfg, self.params, tok,
                                      memory=memory,
                                      compute_dtype=self.dtype,
                                      max_len=self.max_len)
            self.stats.prefill_tokens += S
        if self.pageable:
            payloads_new = KV.slice_cache_pages(self.cfg, cache, S,
                                                self.page_size)
            self.store.insert(tokens[0], payloads_new)
        self.stats.prefill_s += time.perf_counter() - t0
        return logits, cache

    # ------------------------------------------------------------- probes
    def _probe_batch(self, prompts: list, tenants=None):
        """One store probe for the whole prompt batch, routed through the
        store's micro-batch queue (DESIGN.md §7): B prompts submit their
        hash chains (on their tenants' admission lanes when given) and the
        queue flushes them as ONE index lookup over the pre-batch store
        snapshot (see PrefixPageStore.lookup_batch). Returns per-prompt
        (n_hit, payloads); the queue's occupancy feedback is drained into
        the registry."""
        if not self.pageable:
            return [None] * len(prompts)
        with span("serve.probe_batch", n=len(prompts)):
            t0 = time.perf_counter()
            probes = self.store.lookup_batch(
                [np.asarray(p, np.int32) for p in prompts], tenants=tenants)
            self.stats.probe_s += time.perf_counter() - t0
            self.store.probe_queue().drain_feedback()
        return probes

    # ------------------------------------------------------------- decode
    def generate(self, prompts: list, steps: int,
                 generator: Optional[torch.Generator] = None,
                 memory=None, tenants=None) -> torch.Tensor:
        """Prefill each prompt (with reuse), then decode ``steps`` tokens
        for the whole batch. Store probes for all B prompts go out as one
        micro-batch before the prefill loop; sampled decode steps route
        their CDF inversions through the decode queue (one launch a step)
        unless ``decode_batching=False``, which samples inline.
        ``tenants`` (one id per prompt) lands both the probes and the
        decode submissions on per-tenant admission lanes; ``memory``
        goes to every prompt's prefill (vlm, audio). ``generator``
        (on the engine's device) drives the sampled draws; None seeds one
        with 0, and the queued and inline samplers give the same tokens
        for the same generator. Returns [B, steps] int32 token ids on the
        engine's device; the decode loop synchronizes once, at its end."""
        if tenants is not None and len(tenants) != len(prompts):
            raise ValueError(f"tenants must have one id per prompt: "
                             f"{len(tenants)} != {len(prompts)}")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        with span("serve.generate", batch=len(prompts), steps=steps):
            return self._generate(prompts, steps, generator, memory,
                                  tenants)

    def _generate(self, prompts, steps, generator, memory, tenants):
        probes = self._probe_batch(prompts, tenants=tenants)
        revision = self.store.revision
        logits_list, caches = [], []
        for p, probe in zip(prompts, probes):
            # batched probes share the pre-batch snapshot; if earlier
            # prefills of THIS batch grew the store and this probe was not
            # already a full hit, re-probe inline so intra-batch prefix
            # sharing still reuses (steady-state warm batches skip this)
            if probe is not None and self.store.revision != revision:
                full = probe[0] >= (len(p) - 1) // self.page_size
                if not full:
                    probe = None
            with span("serve.prefill", tokens=len(p)):
                lg, c = self.prefill_one(p, memory=memory, probe=probe)
            logits_list.append(lg)
            caches.append(c)
        # stack along batch: lengths on axis 0, every state [L, B, ...] on 1
        cache = {name: torch.cat([c[name] for c in caches],
                                 dim=0 if name == "lengths" else 1)
                 for name in caches[0]}
        del caches
        logits = torch.cat(logits_list, dim=0)
        toks_out = []
        use_queue = self.decode_batching and self.sampler.temperature != 0.0
        dq = self.decode_queue() if use_queue else None
        t0 = time.perf_counter()
        for i in range(steps):
            with span("serve.decode_step", step=i):
                if use_queue:
                    nxt = sample_queued(logits, self.sampler, dq,
                                        tenants=tenants,
                                        generator=generator)
                else:
                    nxt = sample(logits, self.sampler, generator=generator)
                toks_out.append(nxt)
                logits, cache = T.decode_step(self.cfg, self.params, nxt,
                                              cache,
                                              compute_dtype=self.dtype)
        if logits.is_cuda:
            torch.cuda.synchronize(logits.device)
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.decode_tokens += steps * len(prompts)
        if dq is not None:
            dq.drain_feedback()
        return torch.stack(toks_out, dim=1)
