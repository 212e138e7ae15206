"""Training loop with fault tolerance: resume from the newest valid
checkpoint, periodic atomic saves and a straggler watchdog (PyTorch port
of ``repro/train/trainer.py``).

Checkpoints hold ``{"params", "opt"}`` in the reference's names and
stacked layout (``transformer.to_reference_params``), so a run saved by
either package resumes in the other. Each step reads the device once, for
its loss, grad norm and learning rate together (the reference's
``block_until_ready`` and its reads). A step slower than
``straggler_factor`` x the EWMA of the step times is flagged; the clock
and the log are injectable, so tests drive the watchdog with a fake clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ckpt import checkpoint as ckpt
from ..core.util import resolve_device, tree_map
from ..data import pipeline
from ..models import transformer as T
from ..optim import adamw
from .train_step import make_train_step

MEMORY_FAMILIES = ("vlm", "audio")


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    microbatches: int = 1
    straggler_factor: float = 3.0
    seed: int = 0


@dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int = 0


class Trainer:
    """``compute_dtype`` defaults to float32, as in the reference; params
    and the AdamW state stay float32 whatever it is. ``device`` defaults
    to the CUDA card. ``save_seconds`` and ``restore_seconds`` record the
    checkpoint's wall times."""

    def __init__(self, arch_cfg, opt_cfg: adamw.OptConfig,
                 data_cfg: pipeline.DataConfig, train_cfg: TrainConfig,
                 *, compute_dtype=None,
                 clock: Callable[[], float] = time.perf_counter,
                 log: Callable[[str], None] = print, device=None):
        self.acfg, self.ocfg, self.dcfg, self.tcfg = (
            arch_cfg, opt_cfg, data_cfg, train_cfg)
        self.clock, self.log = clock, log
        self.device = resolve_device(device)
        self.save_seconds: list = []
        self.restore_seconds: Optional[float] = None
        self._saved_step: Optional[int] = None
        self.state = self._init_or_resume()
        self._step_fn = make_train_step(
            arch_cfg, opt_cfg, microbatches=train_cfg.microbatches,
            compute_dtype=compute_dtype or torch.float32,
            has_memory=arch_cfg.family in MEMORY_FAMILIES)
        self.metrics_history: list = []
        self.straggler_flags = 0

    # ------------------------------------------------------------- state
    def _init_or_resume(self) -> TrainState:
        """The newest verifying checkpoint's state; without one, parameters
        drawn from a generator on the device seeded ``TrainConfig.seed``
        and a fresh AdamW state."""
        if self.tcfg.ckpt_dir:
            t0 = time.perf_counter()
            try:
                tree, step = ckpt.restore(self.tcfg.ckpt_dir, self._target())
            except FileNotFoundError:
                pass
            else:
                params = T.from_reference_params(self.acfg, tree["params"],
                                                 device=self.device)
                opt_state = T.from_reference_opt_state(
                    self.acfg, tree["opt"], device=self.device)
                self.restore_seconds = time.perf_counter() - t0
                self._saved_step = step
                self.log(f"[trainer] resumed from step {step}")
                return TrainState(params, opt_state, step)
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = T.init_params(self.acfg, gen, self.device)
        return TrainState(params, adamw.init_state(params), 0)

    def _target(self) -> dict:
        """The checkpoint's tree in the reference's layout, each leaf an
        empty CPU tensor of its dtype: what restore fills. The structure
        comes from parameters on the "meta" device, which draw nothing
        and hold no memory."""
        params = T.init_params(self.acfg, None, "meta")
        ref = T.to_reference_params(self.acfg, tree_map(
            lambda p: torch.empty(0, dtype=p.dtype), params))
        return {"params": ref, "opt": {
            "m": ref, "v": ref, "count": torch.empty(0, dtype=torch.int32)}}

    def _save(self):
        """Save the state at its step; a step saved already (the periodic
        save before the final one, or the step resumed from) holds the
        same arrays and is not written again."""
        if not self.tcfg.ckpt_dir or self._saved_step == self.state.step:
            return
        t0 = time.perf_counter()
        ckpt.save(self.tcfg.ckpt_dir, self.state.step, {
            "params": T.to_reference_params(self.acfg, self.state.params),
            "opt": T.to_reference_opt_state(self.acfg,
                                            self.state.opt_state)},
            keep=self.tcfg.keep)
        self.save_seconds.append(time.perf_counter() - t0)
        self._saved_step = self.state.step

    def _memory(self) -> Optional[torch.Tensor]:
        """The stub frontend's embeddings for the vlm and audio families,
        [host_batch, encoder_seq, d_model] from a generator on the device
        seeded 7 (the reference draws them from ``PRNGKey(7)``, which has
        no torch counterpart); None for the other families."""
        if self.acfg.family not in MEMORY_FAMILIES:
            return None
        return torch.randn(
            (self.dcfg.host_batch, self.acfg.encoder_seq, self.acfg.d_model),
            generator=torch.Generator(self.device).manual_seed(7),
            device=self.device)

    # ------------------------------------------------------------- loop
    def run(self, steps: Optional[int] = None):
        total = steps if steps is not None else self.tcfg.steps
        ewma = None
        memory = self._memory()
        while self.state.step < total:
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in
                     pipeline.batch_at(self.dcfg, self.state.step).items()}
            if memory is not None:
                batch["memory"] = memory
            t0 = self.clock()
            self.state.params, self.state.opt_state, m = self._step_fn(
                self.state.params, self.state.opt_state, batch)
            # the step's one host read
            loss, gnorm, lr = torch.stack(
                [m["loss"], m["grad_norm"], m["lr"]]).tolist()
            dt = self.clock() - t0
            # straggler watchdog
            if ewma is not None and dt > self.tcfg.straggler_factor * ewma:
                self.straggler_flags += 1
                self.log(f"[watchdog] step {self.state.step} took {dt:.3f}s "
                         f"(ewma {ewma:.3f}s) — flagged straggler")
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            self.state.step += 1
            rec = {"step": self.state.step, "loss": loss, "grad_norm": gnorm,
                   "lr": lr, "sec": dt}
            self.metrics_history.append(rec)
            if self.state.step % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {rec['step']} loss {loss:.4f} "
                         f"gnorm {gnorm:.3f} lr {lr:.2e} {dt*1e3:.0f}ms")
            if self.state.step % self.tcfg.ckpt_every == 0:
                self._save()
        self._save()
        return self.metrics_history
