"""End-to-end training example of the PyTorch port: a ~100M-param LM on the
synthetic token stream.

The counterpart of `examples/train_lm.py`: AdamW + warmup-cosine,
deterministic data, periodic async checkpoints, straggler monitor,
resume-on-restart, on the card unless `--device cpu`. A granite-family
config scaled to ~100M params.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --small --device cpu --steps 20
    (rerun the same command after a crash: it resumes from the checkpoint)
"""
import argparse
import dataclasses
from pathlib import Path

import repro_torch.configs as configs
from repro_torch.runtime import TrainLoopConfig, train_loop

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "train_lm_torch"


def config_100m():
    base = configs.get("granite-3-2b")
    return dataclasses.replace(
        base,
        name="granite-100m",
        n_layers=10,
        d_model=640,
        n_heads=10,
        n_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=32_000,
        attn_chunk=128,
        loss_chunk=128,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--small", action="store_true", help="~10M variant for quick demos")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = config_100m()
    if args.small:
        cfg = dataclasses.replace(
            cfg, name="granite-10m", n_layers=4, d_model=256, n_heads=4,
            n_kv_heads=2, d_ff=1024, vocab_size=8_000,
        )
    n = cfg.param_count()
    print(f"[train] {cfg.name}: {n/1e6:.0f}M params, {args.steps} steps on {args.device}")
    out = train_loop(
        cfg,
        TrainLoopConfig(
            steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=50,
            seq_len=args.seq_len,
            global_batch=args.batch,
            peak_lr=3e-4,
            warmup=min(50, args.steps // 5),
            log_every=10,
        ),
        device=args.device,
    )
    print(
        f"[train] loss {out['first_loss']:.3f} -> {out['final_loss']:.3f}; "
        f"{len(out['slow_steps'])} straggler steps flagged"
    )


if __name__ == "__main__":
    main()
