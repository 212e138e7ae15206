"""End-to-end training example of the PyTorch port: a small minicpm-family
model (WSD schedule) trains a few hundred steps on the synthetic pipeline
on the CUDA card, with a mid-run simulated crash + auto-resume from
checkpoint.

    PYTHONPATH=src python examples/train_tiny_torch.py [--steps 200] \\
        [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.configs import get_config
from repro_torch.core.util import resolve_device
from repro_torch.data import DataConfig
from repro_torch.optim import OptConfig
from repro_torch.train import Trainer, TrainConfig


def main(device=None, steps: int = 200, ckpt_every: int = 25) -> dict:
    """Trains ``steps`` steps on ``device`` (default: the CUDA card),
    crashing at 60% and resuming from the newest checkpoint; asserts the
    resume and returns the losses and the resumed step."""
    device = resolve_device(device)
    acfg = get_config("minicpm-2b").reduced(d_model=128, n_layers=4,
                                            vocab=1024)
    ocfg = OptConfig(lr=3e-3, schedule="wsd", warmup_steps=20,
                     total_steps=steps, wsd_decay_frac=0.2)
    dcfg = DataConfig(vocab=acfg.vocab, seq_len=64, global_batch=8)
    ckpt_dir = tempfile.mkdtemp(prefix="train_tiny_ck_")
    tcfg = TrainConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                       log_every=ckpt_every)
    try:
        print(f"arch=minicpm-family reduced  schedule={ocfg.schedule}  "
              f"steps={steps}  ckpt={ckpt_dir}  device={device}")

        # phase 1: train to ~60% and "crash"
        crash_at = int(steps * 0.6)
        t1 = Trainer(acfg, ocfg, dcfg, tcfg, device=device)
        first = t1.run(steps=crash_at)
        print(f"\n--- simulated crash at step {t1.state.step} "
              "(process lost) ---\n")
        del t1

        # phase 2: a fresh trainer in the same dir must auto-resume and
        # finish
        t2 = Trainer(acfg, ocfg, dcfg, tcfg, device=device)
        resumed = t2.state.step
        assert resumed >= crash_at - tcfg.ckpt_every, "resume failed"
        hist = t2.run()

        last = hist[-1]["loss"]
        print(f"\nfinal loss {last:.4f} (resumed at step {resumed})")
        print(f"straggler flags: {t2.straggler_flags}")
        print("OK: crash/restart training completed.")
        return {"first_loss": first[0]["loss"] if first else None,
                "final_loss": last, "crash_at": crash_at,
                "resumed_at": resumed, "steps": t2.state.step,
                "straggler_flags": t2.straggler_flags}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args()
    main(a.device, a.steps)
