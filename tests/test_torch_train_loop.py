"""The fault-tolerant training loop of the port, its entry point and its
example.

`train_loop` against the reference's for 8 steps from the same parameters
(reduced configs at float32, warmup 2, peak lr 3e-4), with and without int8
error feedback: the loss and the gradient norm at each step, and the
parameters at the end (at float32 they are the master copies). Failure and
resume on the CPU, bit-equal to an uninterrupted run of the port. The CLI
and the example run a few steps on the CPU in a process of their own.

Bounds. Losses within rtol 1e-5 and grad norms within 1e-4 at every step.
The final parameters: every entry within 2e-6 of the reference's, save a
few where the two runs took opposite steps. Adam's normalised update
mhat / sqrt(nhat) is about +-1 for any gradient well above eps, so where a
gradient component is near 0 -- or, with error feedback, where the int8
round trip puts it on the other side of a rounding boundary -- a last-bit
difference of the gradients can flip the step's sign and move that entry
by up to 2 lr. Those entries are allowed up to 2 sum(lr) over the run, and
at most 1 in 1,000 entries may use that allowance (with error feedback 122
of 197,184 entries of the reduced granite do, without it none).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models.transformer import LM as RLM
from repro.optim import schedule as rschedule
from repro.runtime import TrainLoopConfig as RTrainLoopConfig
from repro.runtime import train_loop as rtrain_loop
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.runtime import TrainLoopConfig, train_loop
from repro_torch.runtime.train_loop import InjectedFailure
from repro_torch.tree import flat_dict

from _lm_parity import KEY

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

ROOT = Path(__file__).resolve().parents[1]
LOOP = dict(steps=8, seq_len=16, global_batch=2, warmup=2, peak_lr=3e-4, log_every=0)
FLIP_SHARE = 1e-3


def _ref_and_port(name: str, **loop):
    """8 steps of both loops from the reference's parameters of `name`
    (reduced, float32). Returns the two summaries, each step's metrics, the
    config and the run's learning rates."""
    rcfg = rconfigs.get(name).reduced(dtype="float32")
    cfg = configs.get(name).reduced(dtype="float32")
    rparams = RLM(rcfg).init(KEY)
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    kw = {**LOOP, **loop}
    rsteps, steps = [], []
    ref = rtrain_loop(rcfg, RTrainLoopConfig(**kw), params=rparams,
                      on_step=lambda s, m: rsteps.append(m))
    out = train_loop(cfg, TrainLoopConfig(**kw), params=params, device="cpu",
                     on_step=lambda s, m: steps.append(m))
    lrs = [float(rschedule.warmup_cosine(s, peak=kw["peak_lr"], warmup=kw["warmup"],
                                         total=kw["steps"])) for s in range(kw["steps"])]
    return ref, out, rsteps, steps, cfg, lrs


def _hold_params(got, ref_params, cfg, lrs) -> int:
    """The bound of the module docstring; returns how many entries used the
    allowance for a flipped step."""
    ref = flat_dict(convert.lm_params_from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                                     device="cpu"))
    flipped, total = 0, 0
    for k, p in flat_dict(got).items():
        d = (p.detach() - ref[k].detach()).abs()
        assert float(d.max()) <= 2 * sum(lrs), k
        flipped += int((d > 2e-6).sum())
        total += d.numel()
    assert flipped <= FLIP_SHARE * total, (flipped, total)
    return flipped


@pytest.mark.parametrize("name,compression", [("granite-3-2b", False), ("phi3.5-moe-42b-a6.6b", False),
                                              ("mamba2-2.7b", False), ("granite-3-2b", True)],
                         ids=["granite", "phi3.5-moe", "mamba2", "granite-int8-ef"])
def test_train_loop_matches_reference(name, compression):
    ref, out, rsteps, steps, cfg, lrs = _ref_and_port(name, grad_compression=compression)
    assert len(out["losses"]) == len(ref["losses"]) == 8 == len(out["step_s"])
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose([m["grad_norm"] for m in steps], [m["grad_norm"] for m in rsteps],
                               rtol=1e-4)
    # The reference's lr is computed inside its jitted step, where XLA may
    # round the cosine an ulp away from the eager value.
    np.testing.assert_allclose([m["lr"] for m in steps], [m["lr"] for m in rsteps], rtol=1e-6)
    assert steps[0]["lr"] == 0.0 and sorted(steps[0]) == sorted(rsteps[0])
    flipped = _hold_params(out["params"], ref["params"], cfg, lrs)
    if not compression:
        assert flipped == 0
    # At float32 the parameters are the master copies.
    master = out["opt_state"].master
    assert all(torch.equal(p.detach(), master[k]) for k, p in flat_dict(out["params"]).items())


def test_failure_and_resume_bit_equal(tmp_path):
    """tests/test_checkpoint.py::test_train_loop_failure_and_resume on the
    port (reduced granite, bf16): the run fails at step 7, resumes from the
    step-6 checkpoint, and ends bit-equal to an uninterrupted run -- the
    losses of steps 6 and 7, every parameter and the optimizer state."""
    cfg = configs.get("granite-3-2b").reduced()
    common = dict(steps=8, ckpt_dir=str(tmp_path), ckpt_every=3, seq_len=16, global_batch=2,
                  log_every=0)
    with pytest.raises(InjectedFailure):
        train_loop(cfg, TrainLoopConfig(fail_at_step=7, **common), device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000006"]
    out = train_loop(cfg, TrainLoopConfig(**common), device="cpu")
    assert len(out["losses"]) == 2   # resumed from step 6: steps 6 and 7 remained
    ref = train_loop(cfg, TrainLoopConfig(steps=8, seq_len=16, global_batch=2, log_every=0),
                     device="cpu")
    assert out["losses"] == ref["losses"][6:]
    for a, b in ((out["params"], ref["params"]), (out["opt_state"].master, ref["opt_state"].master),
                 (out["opt_state"].mu, ref["opt_state"].mu)):
        fa, fb = flat_dict(a), flat_dict(b)
        assert fa.keys() == fb.keys() and all(torch.equal(fa[k].detach(), fb[k].detach()) for k in fa)
    assert int(out["opt_state"].step) == 8 and "step_00000008" in os.listdir(tmp_path)


def test_train_loop_logs_and_calls_on_step(capsys):
    cfg = configs.get("mamba2-2.7b").reduced()
    seen = []
    out = train_loop(cfg, TrainLoopConfig(steps=3, seq_len=16, global_batch=2, log_every=2),
                     device="cpu", on_step=lambda s, m: seen.append((s, sorted(m))))
    assert [s for s, _ in seen] == [0, 1, 2]
    assert seen[0][1] == sorted(["ce", "load_balance", "router_z", "dropped_frac", "grad_norm", "lr",
                                 "loss"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and "gnorm" in lines[0]
    assert all(np.isfinite(out["losses"])) and isinstance(out["slow_steps"], list)


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, *args], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_example_and_cli_train_on_cpu(tmp_path):
    """`examples/train_lm_torch.py --small --device cpu` and `python -m
    repro_torch.launch.train --reduced --device cpu`, a few steps each; the
    example resumes from its checkpoint when run again."""
    ckpt = tmp_path / "ckpt"
    args = [str(ROOT / "examples" / "train_lm_torch.py"), "--small", "--device", "cpu",
            "--steps", "3", "--seq-len", "32", "--batch", "2", "--ckpt-dir", str(ckpt)]
    out = _run(args, tmp_path)
    assert "granite-10m" in out and "loss" in out and "on cpu" in out
    assert sorted(os.listdir(ckpt)) == ["step_00000003"]
    again = _run(args, tmp_path)   # resumed at the end: no step left
    assert "loss nan -> nan" in again
    out = _run(["-m", "repro_torch.launch.train", "--arch", "whisper-medium", "--reduced",
                "--device", "cpu", "--steps", "2", "--seq-len", "16", "--global-batch", "2"], tmp_path)
    assert out.strip().splitlines()[-1].startswith("final loss: ")
