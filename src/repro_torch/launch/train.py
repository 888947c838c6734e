"""Training launcher of the port: --arch <id> with the fault-tolerant
trainer (port of ``repro.launch.train``).

The model trains on the CUDA device; ``--device cpu`` runs the
reduced configs on the CPU (the checkpoint kernels' plain versions):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --reduced --steps 30 --grad-compression
"""
from __future__ import annotations

import argparse

from repro_torch.models.config import reduced_for_smoke
from repro_torch.models.registry import ARCHITECTURES, get_arch
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHITECTURES)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).config
    if args.reduced:
        cfg = reduced_for_smoke(cfg)

    tc = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        global_batch=args.batch,
        seq_len=args.seq,
        base_lr=args.lr,
        grad_compression=args.grad_compression,
        metrics_path=f"{args.ckpt_dir}.metrics.jsonl",
    )
    trainer = Trainer(
        cfg, tc,
        on_straggler=lambda s, dt: print(f"[straggler] step {s}: {dt:.2f}s"),
        device=args.device,
    )
    trainer.run(0, resume=not args.no_resume)
    losses = trainer.state.losses
    print(f"{args.arch}: {trainer.state.step} steps; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"retries={trainer.state.retries} "
          f"stragglers={trainer.state.straggler_events}")


if __name__ == "__main__":
    main()
