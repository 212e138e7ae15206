"""Batched serving engine: prefix-reuse prefill + batched decode (PyTorch
port of ``repro/serve/engine.py``).

Flow per request: probe the PrefixPageStore (by default the mutable tiered
store on the card) for the longest cached page chain -> install hit pages into a fresh cache
-> prefill only the uncached tail (``prefill_continue``) -> store the new
pages. Requests then decode together as one batch, each step sampling
inline: for a sampled config, one CDF-inversion kernel launch a step.

Not ported yet, and raising ``NotImplementedError`` naming their ROADMAP
item: the decode micro-batch queue (``decode_batching=True`` with a
sampled config) and tenants (item 9), and the registry views of
``EngineStats`` (item 10). The reference's tracing spans are left out
with them (item 10).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import IndexConfig
from ..core.util import not_ported
from ..models import transformer as T
from . import kv_cache as KV
from .sampler import SamplerConfig, sample


def _registry_view(name: str):
    def view(self):
        raise not_ported(f"EngineStats.{name}", "item 10 (telemetry)")
    return property(view, doc=f"Registry view {name} (not ported yet).")


@dataclass
class EngineStats:
    """Serving counters of the engine loop; the wall-clock fields are
    host-clock seconds."""
    prefill_tokens: int = 0
    reused_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    probe_s: float = 0.0          # wall time in batched store probes

    probe_batches = _registry_view("probe_batches")
    probe_occupancy = _registry_view("probe_occupancy")
    decode_flushes = _registry_view("decode_flushes")
    decode_occupancy = _registry_view("decode_occupancy")
    tenants = _registry_view("tenants")


class ServeEngine:
    def __init__(self, cfg, params, *, max_len: int = 256, page_size: int = 16,
                 index_config: Optional[IndexConfig] = None,
                 sampler: SamplerConfig = SamplerConfig(temperature=0.0),
                 decode_batching: bool = True,
                 compute_dtype=torch.float32):
        self.cfg, self.params = cfg, params
        self.device = params["embed"].device
        self.max_len, self.page_size = max_len, page_size
        self.sampler = sampler
        self.decode_batching = decode_batching
        self.dtype = compute_dtype
        self.pageable = cfg.family in ("dense", "moe")
        # the default probe is the mutable tiered store, as in the reference
        self.store = KV.PrefixPageStore(
            page_size, index_config or IndexConfig(kind="tiered",
                                                   plan="device",
                                                   mutable=True),
            device=self.device)
        self.stats = EngineStats()

    # ------------------------------------------------------------- prefill
    def prefill_one(self, tokens: np.ndarray, probe=None):
        """Returns (last_logits [1,V], cache). Uses prefix reuse when the
        arch is pageable. ``probe`` carries a precomputed (n_hit, payloads)
        from a batched store probe (:meth:`_probe_batch`); without it the
        store is probed inline, one request at a time."""
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
            logits, cache = T.prefill(self.cfg, self.params, tok,
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
        """One store probe for the whole prompt batch: every prompt's hash
        chain in one index lookup over the pre-batch store snapshot (see
        PrefixPageStore.lookup_batch). Returns per-prompt (n_hit,
        payloads)."""
        if not self.pageable:
            return [None] * len(prompts)
        t0 = time.perf_counter()
        probes = self.store.lookup_batch(
            [np.asarray(p, np.int32) for p in prompts], tenants=tenants)
        self.stats.probe_s += time.perf_counter() - t0
        return probes

    # ------------------------------------------------------------- decode
    def generate(self, prompts: list, steps: int,
                 generator: Optional[torch.Generator] = None,
                 tenants=None) -> torch.Tensor:
        """Prefill each prompt (with reuse), then decode ``steps`` tokens
        for the whole batch, sampling inline. Store probes for all B
        prompts go out as one batched lookup before the prefill loop.
        ``generator`` (on the engine's device) drives the sampled draws;
        None seeds one with 0. Returns [B, steps] int32 token ids on the
        engine's device; the decode loop synchronizes once, at its end."""
        if tenants is not None and len(tenants) != len(prompts):
            raise ValueError(f"tenants must have one id per prompt: "
                             f"{len(tenants)} != {len(prompts)}")
        if self.decode_batching and self.sampler.temperature != 0.0:
            raise not_ported("the decode micro-batch queue (pass "
                             "decode_batching=False)",
                             "item 9 (queue and admission)")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
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
            lg, c = self.prefill_one(p, probe=probe)
            logits_list.append(lg)
            caches.append(c)
        # stack along batch: lengths on axis 0, K/V [L, B, ...] on axis 1
        cache = {"lengths": torch.cat([c["lengths"] for c in caches]),
                 "k": torch.cat([c["k"] for c in caches], dim=1),
                 "v": torch.cat([c["v"] for c in caches], dim=1)}
        del caches
        logits = torch.cat(logits_list, dim=0)
        toks_out = []
        t0 = time.perf_counter()
        for _ in range(steps):
            nxt = sample(logits, self.sampler, generator=generator)
            toks_out.append(nxt)
            logits, cache = T.decode_step(self.cfg, self.params, nxt, cache,
                                          compute_dtype=self.dtype)
        if logits.is_cuda:
            torch.cuda.synchronize(logits.device)
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.decode_tokens += steps * len(prompts)
        return torch.stack(toks_out, dim=1)
