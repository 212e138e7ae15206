"""Training launcher, on the CUDA card (PyTorch port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 100 --ckpt-dir /tmp/ck
    # off the card, at a tiny width:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --steps 3 --seq-len 16 --global-batch 2 --device cpu

The flags and defaults are the reference's; ``--device`` picks the torch
device (the default is the card). Weights are random, from the seed 0; the
batches are the reference pipeline's. On a cluster the launcher runs once
a host: ``--coordinator host:port`` (or an ``init_method`` URL such as
``tcp://host:port`` or ``file:///shared/path``) joins the default process
group of ``--num-hosts`` ranks as rank ``--host-id``, over NCCL on the card
and gloo with ``--device cpu``, and each host trains on its slice of the
global batch. ``--mesh`` is parsed and, as in the reference, not acted on:
the Trainer holds no mesh (the sharded step is
``train.make_sharded_train_step``).
"""
from __future__ import annotations

import argparse

import torch.distributed as dist


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default=None, help="default: arch's own")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized same-family config")
    ap.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card")
    ap.add_argument("--mesh", default=None,
                    help="host:DxM; parsed and not acted on (the Trainer "
                         "holds no mesh), as in the reference")
    ap.add_argument("--coordinator", default=None,
                    help="host:port (or an init_method URL: tcp://..., "
                         "file://...) of the multi-host process group")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    args = ap.parse_args()
    if not 0 <= args.host_id < args.num_hosts:
        ap.error(f"--host-id {args.host_id} is not a rank of --num-hosts "
                 f"{args.num_hosts}")
    if args.coordinator:
        init = args.coordinator
        if "://" not in init:
            host, _, port = init.rpartition(":")
            if not host or not port.isdigit():
                ap.error(f"--coordinator {init!r} is neither host:port nor "
                         "an init_method URL")
            init = f"tcp://{init}"
        on_cpu = args.device is not None and \
            str(args.device).startswith("cpu")
        dist.init_process_group("gloo" if on_cpu else "nccl",
                                init_method=init, world_size=args.num_hosts,
                                rank=args.host_id)
    try:
        train(args)
    finally:
        if args.coordinator:
            dist.destroy_process_group()


def train(args):
    from ..configs import get_config
    from ..data import DataConfig
    from ..optim import OptConfig
    from ..train import Trainer, TrainConfig

    acfg = get_config(args.arch)
    if args.reduced:
        acfg = acfg.reduced()
    ocfg = OptConfig(lr=args.lr, schedule=args.schedule or acfg.schedule,
                     warmup_steps=max(args.steps // 20, 1),
                     total_steps=args.steps)
    dcfg = DataConfig(vocab=acfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch,
                      num_hosts=args.num_hosts, host_id=args.host_id)
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every,
                       microbatches=args.microbatches)
    trainer = Trainer(acfg, ocfg, dcfg, tcfg, device=args.device)
    trainer.run()
    print(f"done: step {trainer.state.step}, "
          f"final loss {trainer.metrics_history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
