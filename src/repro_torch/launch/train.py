"""Training entrypoint of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --reduced \
        --steps 50 --ckpt-dir build/run1 [--device cpu]

The counterpart of the reference package's `launch/train.py`, on one
device: the card unless `--device cpu`. The loop (checkpoint, resume,
straggler monitor) is `runtime.train_loop`.
"""
from __future__ import annotations

import argparse

import repro_torch.configs as configs
from repro_torch.runtime import TrainLoopConfig, train_loop


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = train_loop(
        cfg,
        TrainLoopConfig(
            steps=args.steps,
            seq_len=args.seq_len,
            global_batch=args.global_batch,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            peak_lr=args.peak_lr,
            grad_compression=args.grad_compression,
        ),
        device=args.device,
    )
    print(f"final loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
