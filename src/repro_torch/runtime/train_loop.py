"""Fault-tolerant training loop.

The port of the reference package's `runtime/train_loop.py`:
  * periodic async checkpoints (params + optimizer + step), atomic on disk;
  * resume-from-latest on start -- the deterministic TokenStream makes the
    data pipeline stateless, so restart at step k replays nothing;
  * failure injection (`fail_at_step`) so tests prove a crashed run resumed
    from its last checkpoint follows the same trajectory;
  * straggler monitor: per-step wall-time EWMA; steps slower than
    `straggler_factor` x EWMA are recorded;
  * optional int8 error-feedback gradient compression (cross-pod DP trick);
  * the parameters and the optimizer state updated in place (the
    counterpart of the reference's donated step state).

A step is one autograd pass (`LM.loss`, then `backward`) and one AdamW
update on the device; the reference's `jax.jit` of the step and its
`jit_kwargs` have no counterpart. The loop runs on the card unless asked
for the CPU (`device="cpu"`); where there is no card it raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..checkpoint import CheckpointManager, latest_step, load_checkpoint
from ..configs.base import ModelConfig
from ..data import TokenStream
from ..kernels.common import resolve_device
from ..models.transformer import LM, init_params, lm_loss
from ..optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine
from ..optim.compression import compression_init, ef_int8_compress
from ..tree import flat_dict


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    peak_lr: float = 3e-4
    warmup: int = 20
    seed: int = 0
    seq_len: int = 128
    global_batch: int = 8
    fail_at_step: int | None = None      # failure injection (raises)
    straggler_factor: float = 3.0
    grad_compression: bool = False
    log_every: int = 10


class InjectedFailure(RuntimeError):
    pass


def make_train_step(lm: LM, tcfg: TrainLoopConfig, opt_cfg: AdamWConfig = AdamWConfig()):
    """step(params, opt_state, comp_state, batch) -> (params, opt_state,
    comp_state, metrics): the loss and its gradients, optional int8 error
    feedback, then AdamW at the schedule's lr for the step before the
    increment (0 at the first step). `params` must require gradients; the
    metrics are device scalars."""
    cfg = lm.cfg

    def train_step(params, opt_state, comp_state, batch):
        for p in params.parameters():
            p.grad = None
        loss, metrics = lm_loss(cfg, params, batch)
        loss.backward()
        grads = {k: p.grad for k, p in flat_dict(params).items()}
        if tcfg.grad_compression:
            grads, comp_state = ef_int8_compress(grads, comp_state)
        lr = warmup_cosine(opt_state.step, peak=tcfg.peak_lr, warmup=tcfg.warmup, total=tcfg.steps)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params, lr, opt_cfg)
        metrics = {**metrics, **opt_metrics, "loss": loss.detach()}
        return params, opt_state, comp_state, metrics

    return train_step


def train_loop(
    cfg: ModelConfig,
    tcfg: TrainLoopConfig,
    *,
    params: Any = None,
    device: str | torch.device = "cuda",
    on_step: Callable[[int, dict], None] | None = None,
) -> dict:
    """Run (or resume) a training run on `device`. Returns a summary dict:
    the losses, the straggler steps, each step's host seconds (from the
    batch on the device to the metrics on the host), the final `params` and
    `opt_state`.

    `params` (a `ParamTree`, moved to `device`) or random ones drawn there
    from `tcfg.seed`; they are trained in place."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(dev).manual_seed(tcfg.seed), dev)
    params = params.to(dev)
    opt_state = adamw_init(params)
    # The residuals exist only with compression on (the reference makes them
    # always: 4 bytes a parameter).
    comp_state = compression_init(params) if tcfg.grad_compression else None

    frontend = None
    if cfg.frontend != "none":
        frontend = (cfg.frontend_len, cfg.d_model)
    stream = TokenStream(
        cfg.vocab_size,
        tcfg.seq_len if cfg.frontend != "vision_stub" else tcfg.seq_len - cfg.frontend_len,
        tcfg.global_batch,
        seed=tcfg.seed,
        frontend=frontend,
    )

    start = 0
    manager = None
    if tcfg.ckpt_dir:
        manager = CheckpointManager(tcfg.ckpt_dir, every=tcfg.ckpt_every)
        if latest_step(tcfg.ckpt_dir) is not None:
            (params, opt_state), start = load_checkpoint(tcfg.ckpt_dir, (params, opt_state),
                                                         device=dev)
    params.requires_grad_(True)
    step_fn = make_train_step(LM(cfg, params), tcfg)

    ewma = None
    losses, slow_steps, step_s = [], [], []
    for step in range(start, tcfg.steps):
        if tcfg.fail_at_step is not None and step == tcfg.fail_at_step:
            if manager:
                manager.wait()
            raise InjectedFailure(f"injected failure at step {step}")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in stream.batch_at(step).items()}
        t0 = time.perf_counter()
        params, opt_state, comp_state, metrics = step_fn(params, opt_state, comp_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        step_s.append(dt)
        # Straggler monitor (per-step EWMA; skip the first step).
        if step > start:
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if ewma and dt > tcfg.straggler_factor * ewma:
                slow_steps.append((step, dt, ewma))
        losses.append(metrics["loss"])
        if on_step:
            on_step(step, metrics)
        if manager:
            manager.maybe_save(step + 1, (params, opt_state), extra={"loss": metrics["loss"]})
        if tcfg.log_every and step % tcfg.log_every == 0:
            print(
                f"step {step:5d} loss {metrics['loss']:.4f} "
                f"gnorm {metrics['grad_norm']:.3f} lr {metrics['lr']:.2e} {dt*1e3:.0f}ms"
            )
    if manager:
        manager.maybe_save(tcfg.steps, (params, opt_state), force=True)
        manager.wait()
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "first_loss": losses[0] if losses else float("nan"),
        "losses": losses,
        "slow_steps": slow_steps,
        "step_s": step_s,
        "params": params,
        "opt_state": opt_state,
    }
