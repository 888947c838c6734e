"""End-to-end training run on the PyTorch/CUDA port: a
qwen2.5-family model with the full fault-tolerance stack:
LOPC-compressed checkpoints (lossless: kernels 8 and 9 on every save),
resume-exactly semantics, straggler logging, optional int8 +
error-feedback gradient compression.

    PYTHONPATH=src python examples/train_lopc_checkpoints_torch.py --steps 30
    PYTHONPATH=src python examples/train_lopc_checkpoints_torch.py --steps 300 \\
        --d-model 768 --layers 12     # the ~100M run
    PYTHONPATH=src python examples/train_lopc_checkpoints_torch.py --device cpu

The port of ``examples/train_lopc_checkpoints.py`` (it imports neither
``jax`` nor ``repro``).  Kill it mid-run and start it again: it resumes
from the last atomic checkpoint with bit-exact state and a
deterministic data stream.
"""
import argparse

from repro_torch.models import get_arch
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def example_config(d_model: int = 256, layers: int = 4, vocab: int = 8192):
    """The qwen2.5-family model of the example (``d_model`` 256, 4
    layers and vocab 8192 by default: ~6M parameters)."""
    return get_arch("qwen2.5-3b").config.scaled(
        n_layers=layers,
        d_model=d_model,
        n_heads=max(4, d_model // 64),
        n_kv_heads=max(2, d_model // 128),
        head_dim=64,
        d_ff=d_model * 4,
        vocab=vocab,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_example")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = example_config(args.d_model, args.layers, args.vocab)
    tc = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=max(5, args.steps // 5),
        ckpt_dir=args.ckpt_dir,
        global_batch=args.batch,
        seq_len=args.seq,
        base_lr=1e-3,
        grad_compression=args.grad_compression,
        metrics_path=args.ckpt_dir + ".metrics.jsonl",
    )
    trainer = Trainer(cfg, tc, device=args.device,
                      on_straggler=lambda s, dt: print(f"straggler: step {s} "
                                                       f"took {dt:.2f}s"))
    model, opt = trainer.init_state(0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f}M params")
    trainer.run(params=model, opt=opt)
    losses = trainer.state.losses
    if losses:
        print(f"steps {trainer.state.step} | first losses "
              f"{[round(v, 3) for v in losses[:3]]} -> last "
              f"{[round(v, 3) for v in losses[-3:]]}")
    m = trainer.ckpt.last_manifest
    if m:
        print(f"last checkpoint: {m['raw_bytes'] / 1e6:.1f} MB raw -> "
              f"{m['stored_bytes'] / 1e6:.1f} MB stored "
              f"({m['raw_bytes'] / max(m['stored_bytes'], 1):.2f}x)")


if __name__ == "__main__":
    main()
