"""Deterministic synthetic token pipeline, host-sharded (PyTorch port of
``repro/data/pipeline.py``, which is numpy under a JAX import it never
uses; the numpy code is copied, so batches are the reference's bit for
bit).

Each host makes only its slice of the global batch (disjoint by host id),
and a step's batch is a function of (seed, step) alone: a restarted job
regenerates exactly the batches it would have seen. A real corpus loader
would replace ``_synth_tokens`` behind the same interface.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


def _synth_tokens(cfg: DataConfig, step: int, row: int) -> np.ndarray:
    """One [seq_len+1] row, deterministic in (seed, step, global_row)."""
    rng = np.random.default_rng(
        np.uint64(cfg.seed) * np.uint64(1_000_003)
        + np.uint64(step) * np.uint64(65_521) + np.uint64(row))
    # mixture of a ramp + noise so losses are learnable but non-trivial
    base = (np.arange(cfg.seq_len + 1) * (1 + row % 7)) % cfg.vocab
    noise = rng.integers(0, cfg.vocab, cfg.seq_len + 1)
    mask = rng.random(cfg.seq_len + 1) < 0.3
    return np.where(mask, noise, base).astype(np.int32)


def batch_at(cfg: DataConfig, step: int) -> dict:
    """The host's shard of global batch ``step``: {tokens, labels}, int32
    [host_batch, seq_len], rows [host_id*hb, (host_id+1)*hb)."""
    hb = cfg.host_batch
    rows = np.arange(cfg.host_id * hb, (cfg.host_id + 1) * hb)
    seqs = np.stack([_synth_tokens(cfg, step, int(r)) for r in rows])
    return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def iterate(cfg: DataConfig, start_step: int = 0,
            prefetch: int = 2) -> Iterator[dict]:
    """Batches from ``start_step`` on, ``prefetch`` steps made ahead
    (thread-free: numpy is cheap here; the interface is what a real
    loader would keep)."""
    buf = {}
    step = start_step
    while True:
        for s in range(step, step + prefetch + 1):
            if s not in buf:
                buf[s] = batch_at(cfg, s)
        yield buf.pop(step)
        step += 1
