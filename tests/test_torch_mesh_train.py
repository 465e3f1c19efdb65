"""The mesh training step on gloo ranks, held against the reference's
one-device step.

`launch.specs.step_and_specs` binds the port's training step for the dense
and vlm families: FSDP over `data` and Megatron TP over `model`, each rank
holding its blocks of the parameters and AdamW's state and its slice of the
batch. Its ranks run in subprocesses (one a rank, a file store, JAX and
the reference blocked) on meshes (2, 1), (1, 2), (2, 2) and (1, 4) of the
reduced glm4-9b the reference's `tests/test_multidevice.py` trains (d_model
128, 8 heads, 2 KV heads, head_dim 16, d_ff 256, vocab 512), at
`ShapeSpec("t", "train", 64, 8)`; the reference's `value_and_grad` and
`adamw_update` at lr 1e-4 run here, in this process, on the same
parameters (`convert.lm_params_from_reference`) and batches (numpy seeds).
(1, 4) cuts the KV projections inside a head: they are gathered whole over
`model`. Also held: an odd vocabulary (257, the head left whole over
`model`), a batch of 6 on 4 data ranks (replicated), the reduced
internvl2-1b (vlm) on (2, 2), two head layouts of other routes on (1, 4)
(against the port's plain one-device step),
the sharded global norm on (2, 2), `compressed_psum` on 4 gloo ranks
against the reference's under `shard_map` on 4 host devices (bit-equal), a
checkpoint of the (2, 2) state restored onto (2, 1) that continues as the
run that never stopped, whisper's placements on a shape-only mesh, and
the (1, 1) step bit-equal to the plain one. The moe family's mesh steps:
tests/test_torch_mesh_moe.py; the ssm and hybrid families':
tests/test_torch_mesh_ssm.py; the encdec family's:
tests/test_torch_mesh_encdec.py.

Bounds (ROADMAP C15, C18: the row-parallel all-reduces, the vocabulary-
parallel logsumexp and the sharded global norm sum in other orders): the
loss within rtol 1e-5; the gathered gradients within rtol 1e-4, atol 1e-5;
the gathered parameters after a step within 2e-6, save at most 1 in 1,000
entries, which stay within 2 lr (Adam's normalised step flips where a
gradient is near 0); the global norm within rtol 1e-6.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models.transformer import LM as RLM
from repro.optim import adamw_init as radamw_init
from repro.optim import adamw_update as radamw_update
from repro.optim.adamw import global_norm as rglobal_norm
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import AbstractMesh, make_mesh, shard_tree
from repro_torch.launch.specs import step_and_specs
from repro_torch.models import LM, init_params
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.compression import stacked_key
from repro_torch.tree import flat_dict

SRC = Path(__file__).resolve().parents[1] / "src"
KEY = jax.random.PRNGKey(0)
SEQ, LR = 64, 1e-4
GLM = dict(d_model=128, n_heads=8, n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512)
# case -> (arch, overrides of the reduced config, batch, steps). The two
# head layouts are held against the port's plain one-device step (itself
# held against the reference in tests/test_torch_train.py); the rest against
# the reference's.
CASES = {
    "glm4": ("glm4-9b", GLM, 8, 2),
    "odd_vocab": ("glm4-9b", dict(GLM, vocab_size=257), 8, 1),
    "batch6": ("glm4-9b", GLM, 6, 1),
    "vlm": ("internvl2-1b", {}, 8, 1),
    # On (1, 4): query heads cut inside a head (6 x 18 over 4: every rank
    # computes every head, its columns of the output meet its rows of wo),
    # KV weights whole (54 columns), d_ff 250 whole: the FFN on every rank.
    "q_whole": ("glm4-9b", dict(GLM, n_heads=6, n_kv_heads=3, head_dim=18, d_ff=250), 8, 1),
    # 12 query heads over 4 ranks read 3 KV heads unevenly (ranks 1 and 2
    # read two): the KV projections gathered whole, one KV head a query head.
    "kv_uneven": ("glm4-9b", dict(GLM, n_heads=12, n_kv_heads=3, head_dim=8), 8, 1),
}


def _cfgs(case):
    arch, over, _, _ = CASES[case]
    return (rconfigs.get(arch).reduced(dtype="float32", **over),
            configs.get(arch).reduced(dtype="float32", **over))


def _batch(cfg, B: int, seed: int, seq: int = SEQ) -> dict:
    rng = np.random.default_rng(seed)
    S = seq - (cfg.frontend_len if cfg.frontend == "vision_stub" else 0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision_stub":
        batch["frontend"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def _port_flat(tree, cfg) -> dict:
    """A reference tree of the parameters' structure as {port path: array}."""
    return {k: v.detach().numpy() for k, v in flat_dict(convert.lm_params_from_reference(
        jax.tree.map(np.asarray, tree), cfg, device="cpu")).items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's one-device steps of every case: its parameters and
    batches saved for the ranks, its losses, gradients (first step),
    parameters after each step and global norm kept here."""
    work = tmp_path_factory.mktemp("mesh_train")
    out = {}
    for case, (_, _, B, steps) in CASES.items():
        rcfg, cfg = _cfgs(case)
        rlm = RLM(rcfg)
        params = rlm.init(KEY)
        np.savez(work / f"params_{case}.npz", **_port_flat(params, cfg))
        batches = [_batch(cfg, B, seed=10 + s) for s in range(steps)]
        for s, batch in enumerate(batches):
            np.savez(work / f"batch_{case}_{s}.npz", **batch)
        run = _plain_steps if case in PLAIN_CASES else _reference_steps
        out[case] = run(rlm, params, cfg, batches)
    (work / "rank.py").write_text(textwrap.dedent(RANK))
    return work, out


PLAIN_CASES = ("q_whole", "kv_uneven")


def _reference_steps(rlm, params, cfg, batches) -> dict:
    vg = jax.jit(jax.value_and_grad(lambda p, b: rlm.loss(p, b), has_aux=True))
    upd = jax.jit(lambda g, s, p: radamw_update(g, s, p, LR))
    state = radamw_init(params)
    res = {"loss": [], "params": []}
    for s, batch in enumerate(batches):
        (loss, _), grads = vg(params, {k: jnp.asarray(v) for k, v in batch.items()})
        if s == 0:
            res["grads"] = _port_flat(grads, cfg)
            res["grad_norm"] = float(rglobal_norm(grads))
        params, state, _ = upd(grads, state, params)
        res["loss"].append(float(loss))
        res["params"].append(_port_flat(params, cfg))
    return res


def _plain_steps(rlm, params, cfg, batches) -> dict:
    """The port's plain one-device steps from the reference's parameters."""
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    lm, state = LM(cfg, params), adamw_init(params)
    params.requires_grad_(True)
    res = {"loss": [], "params": []}
    for s, batch in enumerate(batches):
        for p in params.parameters():
            p.grad = None
        loss, _ = lm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
        grads = {k: p.grad for k, p in flat_dict(params).items()}
        if s == 0:
            res["grads"] = {k: g.numpy().copy() for k, g in grads.items() if g is not None}
        _, state, _ = adamw_update(grads, state, params, LR)
        res["loss"].append(loss.item())
        res["params"].append({k: p.detach().numpy().copy() for k, p in flat_dict(params).items()})
    return res


RANK = r"""
import datetime, json, sys
import numpy as np

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
import torch.distributed as dist

rank, world, work, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
jobs = json.loads(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out}/group", rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
import repro_torch.configs as configs
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import gather_tensor, gather_tree, make_mesh, shard_tree
from repro_torch.distributed.partitioning import shard_slices
from repro_torch.launch.specs import param_specs, step_and_specs
from repro_torch.optim import CompressionState, adamw_init, compressed_psum, global_norm
from repro_torch.tree import flat_dict, flatten_with_path, path_key, unflatten


def cfg_of(c):
    return configs.get(c["arch"]).reduced(dtype="float32", **c["over"])


def bind(c, mesh):
    return step_and_specs(cfg_of(c), ShapeSpec("t", "train", c["seq"], c["batch"]), mesh)


def full_params(cfg, name):
    arrays = np.load(f"{work}/params_{name}.npz")
    template = param_specs(cfg)
    return unflatten(template, [torch.from_numpy(arrays[path_key(p)]) for p, _ in flatten_with_path(template)])


def batch_at(name, s):
    return {k: torch.from_numpy(v) for k, v in np.load(f"{work}/batch_{name}_{s}.npz").items()}


def run(c, name, mesh, params, opt, steps):
    step, _, place = bind(c, mesh)
    sp = flat_dict(place[0])
    res = {}
    for s in steps:
        params, opt, loss = step(params, opt, shard_tree(batch_at(name, s), place[2], mesh))
        res[f"loss_{s}"] = float(loss)
        if s == 0:
            for k, p in flat_dict(params).items():
                if p.grad is not None:
                    res[f"g/{k}"] = gather_tensor(p.grad, sp[k], mesh).numpy()
        for k, v in flat_dict(gather_tree(params, place[0], mesh)).items():
            res[f"p{s}/{k}"] = v.detach().numpy()
        if c.get("ckpt") and s == 0:   # the state after the first step, gathered
            state = gather_tree((params, opt), place[:2], mesh)
            if rank == 0:
                save_checkpoint(f"{out}/ckpt", 1, state)
            dist.barrier()
    return res


res = {}
for D, S, cases in jobs:
    mesh = make_mesh((D, S), ("data", "model"), "cpu")
    for name, c in cases.items():
        at = f"{D}x{S}/{name}/"
        if name == "norm":   # the reference's gradients, cut to this rank's blocks
            _, _, place = bind(c, mesh)
            g = np.load(c["grads"])
            sp = flat_dict(place[0])
            keys = list(sp)
            blocks = [torch.from_numpy(g[k])[shard_slices(g[k].shape, sp[k], mesh)] if k in g else None
                      for k in keys]
            res[at + "sharded"] = float(global_norm(blocks, mesh=mesh, specs=[sp[k] for k in keys]))
            res[at + "full"] = float(global_norm(torch.from_numpy(g[k]) if k in g else None for k in keys))
        elif name == "psum":
            arrays = np.load(c["inputs"])
            grads = {k: torch.from_numpy(arrays[f"g/{k}"][rank]) for k in c["keys"]}
            err = {k: torch.from_numpy(arrays[f"e/{k}"][rank]) for k in c["keys"]}
            deq, state = compressed_psum(grads, mesh.group("data"), CompressionState(err))
            for k in c["keys"]:
                res[f"{at}deq/{k}/{rank}"] = deq[k].numpy()
                res[f"{at}err/{k}/{rank}"] = state.err[k].numpy()
        elif name == "elastic":   # a checkpoint of another mesh's state, cut to this one
            _, arg_specs, place = bind(c, mesh)
            flat_place = flat_dict(place[:2])
            state, step_no = load_checkpoint(
                c["ckpt"], arg_specs[:2], device="cpu",
                placement_fn=lambda k, a: a[shard_slices(a.shape, flat_place[k], mesh)])
            assert step_no == 1 and int(state[1].step) == 1
            res.update({at + k: v for k, v in run(c, c["batch_of"], mesh, *state, [1]).items()})
        else:
            _, _, place = bind(c, mesh)
            params = shard_tree(full_params(cfg_of(c), name), place[0], mesh)
            res.update({at + k: v for k, v in run(c, name, mesh, params, adamw_init(params),
                                                  range(c["steps"])).items()})
if rank == 0 or any("/psum/" in k for k in res):
    np.savez(f"{out}/out.{rank}.npz", **res)
# Every rank past its last collective before any tears its groups down.
dist.barrier()
dist.destroy_process_group()
open(f"{out}/ok.{rank}", "w").write("OK")
"""

LAUNCH = r"""
import subprocess, sys
script, world = sys.argv[1], int(sys.argv[2])
procs = [subprocess.Popen([sys.executable, script, str(r), *sys.argv[2:]]) for r in range(world)]
rc = 0
try:
    for p in procs:
        rc |= p.wait(timeout=150)
finally:
    for p in procs:
        if p.poll() is None:
            p.kill()
sys.exit(rc)
"""


def _launch(work: Path, world: int, jobs: list) -> dict:
    """One launch of `world` gloo ranks running `jobs` [(D, S, cases)] in
    order, each on its mesh; rank 0's results (and every rank's
    `compressed_psum` results), keyed "DxS/case/...". """
    out = work / f"run_{world}"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-c", LAUNCH, str(work / "rank.py"), str(world), str(work), str(out),
         json.dumps(jobs)],
        env=env, capture_output=True, text=True, timeout=170,
    )
    assert res.returncode == 0, f"stdout:\n{res.stdout[-3000:]}\nstderr:\n{res.stderr[-6000:]}"
    assert sorted(f.name for f in out.glob("ok.*")) == [f"ok.{r}" for r in range(world)]
    merged = {}
    for f in out.glob("out.*.npz"):
        merged.update(dict(np.load(f)))
    return merged


def _case_args(case: str, **extra) -> dict:
    arch, over, B, steps = CASES[case]
    return dict(dict(arch=arch, over=over, batch=B, steps=1, seq=SEQ), **extra)


@pytest.fixture(scope="module")
def runs(reference):
    """Two launches of ranks: four ranks on (2, 2) -- whose state after
    its first step is saved --, (1, 4) and (4, 1); then two on (2, 1),
    which restores that state, and (1, 2). Returns {mesh: {case/key: array}}."""
    work, ref = reference
    np.savez(work / "psum.npz", **_psum_inputs())   # the reference's run reads it too
    np.savez(work / "grads_glm4.npz", **ref["glm4"]["grads"])
    four = [(2, 2, {"glm4": _case_args("glm4", steps=CASES["glm4"][3], ckpt=True),
                    "odd_vocab": _case_args("odd_vocab"), "vlm": _case_args("vlm"),
                    "norm": _case_args("glm4", grads=str(work / "grads_glm4.npz"))}),
            (1, 4, {"glm4": _case_args("glm4"), "q_whole": _case_args("q_whole"),
                    "kv_uneven": _case_args("kv_uneven")}),
            (4, 1, {"batch6": _case_args("batch6"),
                    "psum": dict(inputs=str(work / "psum.npz"), keys=sorted(PSUM_SHAPES))})]
    two = [(2, 1, {"glm4": _case_args("glm4"),
                   "elastic": _case_args("glm4", ckpt=str(work / "run_4" / "ckpt"), batch_of="glm4")}),
           (1, 2, {"glm4": _case_args("glm4")})]
    merged = {**_launch(work, 4, four), **_launch(work, 2, two)}
    out = {}
    for key, v in merged.items():
        mesh, rest = key.split("/", 1)
        out.setdefault(tuple(int(n) for n in mesh.split("x")), {})[rest] = v
    return ref, out, work


def _hold_loss(got: float, want: float) -> None:
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _hold_grads(got: dict, prefix: str, want: dict) -> None:
    keys = [k for k in want if f"{prefix}{k}" in got]
    assert len(keys) == len([k for k in got if k.startswith(prefix)]) > 0
    for k in keys:
        np.testing.assert_allclose(got[f"{prefix}{k}"], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    # every parameter the loss reads has a gradient (the codebooks do not)
    assert {k for k in want if "bangkv" not in k} <= set(keys)


def _hold_params(got: dict, prefix: str, want: dict, n_steps: int = 1) -> None:
    worst, over, total = 0.0, 0, 0
    for k, w in want.items():
        d = np.abs(got[f"{prefix}{k}"] - w)
        worst = max(worst, float(d.max()))
        over += int((d > 2e-6).sum())
        total += d.size
    assert over <= 1e-3 * total and worst <= 2 * LR * n_steps, (worst, over, total)


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2), (1, 4)])
def test_train_step_matches_reference(runs, mesh):
    """Reduced glm4-9b: the loss, the gathered gradients and the gathered
    parameters after the step against the reference's one-device step."""
    ref, out, _ = runs
    got, want = out[mesh], ref["glm4"]
    _hold_loss(got["glm4/loss_0"], want["loss"][0])
    _hold_grads(got, "glm4/g/", want["grads"])
    _hold_params(got, "glm4/p0/", want["params"][0])
    if mesh == (2, 2):   # its second step, from its own state
        _hold_loss(got["glm4/loss_1"], want["loss"][1])
        _hold_params(got, "glm4/p1/", want["params"][1], 2)


@pytest.mark.parametrize("case,mesh", [("odd_vocab", (2, 2)), ("batch6", (4, 1)), ("vlm", (2, 2)),
                                       ("q_whole", (1, 4)), ("kv_uneven", (1, 4))])
def test_train_step_layouts_match_reference(runs, case, mesh):
    """An odd vocabulary (the embedding and the head whole over `model`,
    the cross-entropy on every `model` rank), a batch of 6 replicated over
    4 data ranks and the vlm with its patches against the reference's
    one-device step; two head layouts against the port's plain one."""
    ref, out, _ = runs
    got, want = out[mesh], ref[case]
    _hold_loss(got[f"{case}/loss_0"], want["loss"][0])
    _hold_grads(got, f"{case}/g/", want["grads"])
    _hold_params(got, f"{case}/p0/", want["params"][0])


def test_global_norm_counts_each_parameter_once(runs):
    """On (2, 2), the reference's gradients cut into blocks: the sharded
    norm equals the one-device norm (a replica counted twice would not)."""
    ref, out, _ = runs
    got = out[(2, 2)]
    np.testing.assert_allclose(got["norm/sharded"], got["norm/full"], rtol=1e-6)
    np.testing.assert_allclose(got["norm/sharded"], ref["glm4"]["grad_norm"], rtol=1e-6)


def test_elastic_checkpoint_from_2x2_onto_2x1(runs):
    """The (2, 2) state after one step, gathered and saved, restored onto
    (2, 1) with each rank's blocks cut by `placement_fn`: its second step
    continues as the (2, 2) run that never stopped, and as the reference's."""
    ref, out, _ = runs
    got, whole = out[(2, 1)], out[(2, 2)]
    _hold_loss(got["elastic/loss_1"], whole["glm4/loss_1"])
    _hold_loss(got["elastic/loss_1"], ref["glm4"]["loss"][1])
    keys = [k[len("glm4/p1/"):] for k in whole if k.startswith("glm4/p1/")]
    _hold_params(got, "elastic/p1/", {k: whole[f"glm4/p1/{k}"] for k in keys}, 2)
    _hold_params(got, "elastic/p1/", ref["glm4"]["params"][1], 2)


PSUM_SHAPES = {"a": (5, 7), "b/c": (13,), "layers/0/w": (4, 3), "layers/1/w": (4, 3)}


def _psum_inputs() -> dict:
    """Four ranks' gradients and residuals, from numpy seeds."""
    rng = np.random.default_rng(5)
    out = {}
    for k, shape in PSUM_SHAPES.items():
        out[f"g/{k}"] = rng.standard_normal((4, *shape)).astype(np.float32)
        out[f"e/{k}"] = (0.01 * rng.standard_normal((4, *shape))).astype(np.float32)
    return out


PSUM_REFERENCE = r'''
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.optim.compression import CompressionState, compressed_psum

inp, out = sys.argv[1], sys.argv[2]
a = np.load(inp)

def tree(prefix):
    return {"a": a[f"{prefix}/a"], "b": {"c": a[f"{prefix}/b/c"]},
            "layers": {"w": np.stack([a[f"{prefix}/layers/0/w"], a[f"{prefix}/layers/1/w"]], 1)}}

mesh = make_mesh((4,), ("data",))

def body(g, e):
    g, e = jax.tree.map(lambda x: x[0], (g, e))
    deq, state = compressed_psum(g, "data", CompressionState(e))
    return jax.tree.map(lambda x: x[None], (deq, state.err))

fn = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")))
deq, err = jax.jit(fn)(tree("g"), tree("e"))
res = {}
for name, t in (("deq", deq), ("err", err)):
    res[f"{name}/a"] = np.asarray(t["a"])
    res[f"{name}/b/c"] = np.asarray(t["b"]["c"])
    for i in range(2):
        res[f"{name}/layers/{i}/w"] = np.asarray(t["layers"]["w"])[:, i]
np.savez(out, **res)
'''


def test_compressed_psum_matches_reference_bit_for_bit(runs, tmp_path):
    """`compressed_psum` over the data group of 4 gloo ranks against the
    reference's under `shard_map` on 4 host devices, on the same inputs:
    the dequantised sums bit-equal (the stacked leaf's two layers share one
    scale, ROADMAP C16). The residual x - q * scale is the port's with q *
    scale rounded first (as `ef_int8_compress`); XLA:CPU fuses it into one
    rounding in its vectorised lanes and not in its scalar remainder (the
    last of each row of 3 here), so each of the reference's residuals is
    one of the two roundings, and equals the port's where it is the
    unfused one (ROADMAP C19)."""
    _, out, work = runs
    (tmp_path / "ref.py").write_text(PSUM_REFERENCE)
    inputs = work / "psum.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, str(tmp_path / "ref.py"), str(inputs), str(tmp_path / "ref.npz")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    want = np.load(tmp_path / "ref.npz")
    got, inputs = out[(4, 1)], np.load(inputs)
    xs = {k: inputs[f"g/{k}"] + inputs[f"e/{k}"] for k in PSUM_SHAPES}   # (rank, ...)
    scales = {}
    for k, x in xs.items():   # the largest of the ranks' scales of each stacked leaf
        s = max(np.abs(x[r]).max() / np.float32(127.0) + np.float32(1e-12) for r in range(4))
        key = stacked_key(k)
        scales[key] = max(scales.get(key, np.float32(0)), np.float32(s))
    fused_lanes = 0
    for k, x in xs.items():
        scale = scales[stacked_key(k)]
        for r in range(4):
            a, b = got[f"psum/deq/{k}/{r}"], want[f"deq/{k}"][r]
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), ("deq", k, r)
            q = np.clip(np.round(x[r] / scale), -127, 127)
            unfused = x[r] - (q * scale).astype(np.float32)
            fused = (x[r].astype(np.float64) - q * np.float64(scale)).astype(np.float32)
            err, ref_err = got[f"psum/err/{k}/{r}"], want[f"err/{k}"][r]
            assert np.array_equal(err, unfused), ("err", k, r)
            assert np.all((ref_err == unfused) | (ref_err == fused)), ("reference err", k, r)
            fused_lanes += int((ref_err != unfused).sum())
    assert fused_lanes > 0   # the reference does fuse, so the two roundings were told apart


@pytest.mark.parametrize("name", ["whisper-medium"])
def test_other_families_refuse_a_mesh(name):
    """The encdec family's training placements on a shape-only (2, 2) mesh
    are the rules': the cross block's and the encoder's weights FSDP over
    `data` and Megatron TP over `model`, the table of 51,865 rows (odd)
    whole over `model` and cut over `data` on d_model, the frames' batch
    over `data`; the step refuses to run on that mesh. Its steps on
    runnable meshes: tests/test_torch_mesh_encdec.py (moe:
    tests/test_torch_mesh_moe.py; ssm and hybrid: tests/test_torch_mesh_ssm.py)."""
    cfg = configs.get(name)
    mesh = AbstractMesh({"data": 2, "model": 2})
    step, specs, place = step_and_specs(cfg, ShapeSpec("t", "train", SEQ, 8), mesh)
    params = place[0]
    assert params["layers"][0]["cross"]["wq"] == ("data", "model")
    assert params["layers"][3]["cross"]["wo"] == ("model", "data")
    assert params["encoder"]["layers"][0]["attn"]["wk"] == ("data", "model")
    assert params["encoder"]["layers"][0]["ffn"]["w_down"] == ("model", "data")
    assert params["embed"] == (None, "data") and "lm_head" not in params
    assert place[2]["frontend"] == ("data", None, None)
    assert tuple(specs[2]["frontend"].shape) == (8, cfg.frontend_len, cfg.d_model)
    with pytest.raises(TypeError, match="runnable"):
        step(None, None, None)


def test_train_step_on_a_shape_only_mesh():
    """On a shape-only mesh the training step's placements are the rules'
    (FSDP over `data`, Megatron TP over `model`), and the step refuses to
    run. Prefill and decode on a mesh: tests/test_torch_mesh_serve.py."""
    cfg = configs.get("glm4-9b").reduced(dtype="float32", **GLM)
    mesh = AbstractMesh({"data": 2, "model": 2})
    step, _, place = step_and_specs(cfg, ShapeSpec("t", "train", SEQ, 8), mesh)
    assert place[0]["layers"][0]["attn"]["wq"] == ("data", "model")
    with pytest.raises(TypeError, match="runnable"):
        step(None, None, None)


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process, made for this module and
    destroyed after it."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    yield mesh
    if made and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("name,dtype", [("glm4-9b", "float32"), ("granite-3-2b", "bfloat16"),
                                        ("internvl2-1b", "float32")])
def test_one_rank_mesh_step_is_bit_equal_to_the_plain_step(one_rank, name, dtype):
    """On a (1, 1) mesh every collective is over one rank (a copy) and the
    vocabulary-parallel logsumexp takes the same operations as
    `torch.logsumexp`: three steps give the plain step's losses and
    parameters bit for bit (granite's odd vocabulary runs its head whole)."""
    cfg = configs.get(name).reduced(dtype=dtype)
    B = 4
    step, _, place = step_and_specs(cfg, ShapeSpec("t", "train", 32, B), one_rank)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    plain = shard_tree(params, place[0], one_rank)     # a copy on one rank
    mesh_params = shard_tree(params, place[0], one_rank)
    opt, plain_opt = adamw_init(mesh_params), adamw_init(plain)
    lm = LM(cfg, plain)
    plain.requires_grad_(True)
    for s in range(3):
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B, seed=20 + s, seq=32).items()}
        mesh_params, opt, loss = step(mesh_params, opt, shard_tree(batch, place[2], one_rank))
        for p in plain.parameters():
            p.grad = None
        plain_loss, _ = lm.loss(batch)
        plain_loss.backward()
        _, plain_opt, _ = adamw_update({k: p.grad for k, p in flat_dict(plain).items()}, plain_opt,
                                       plain, LR)
        assert loss.item() == plain_loss.item(), s
    a, b = flat_dict(mesh_params), flat_dict(plain)
    assert all(torch.equal(a[k].detach(), b[k].detach()) for k in a)
    assert all(torch.equal(opt.master[k], plain_opt.master[k]) for k in a)
    counts = step.mesh_context.counts
    assert counts["all_gather"] > 0 and counts["all_reduce"] > 0


@pytest.mark.parametrize("remat", [True, False])
def test_remat_gathers_each_weight_again_in_backward(one_rank, remat):
    """The weights are gathered inside the rematerialised layer body: with
    remat each of a layer's 7 weights is gathered in the forward and again
    in the recompute, without it once; the embedding twice (the lookup and
    the cross-entropy) either way. The losses agree."""
    import dataclasses

    cfg = dataclasses.replace(configs.get("glm4-9b").reduced(dtype="float32"), remat=remat)
    step, _, place = step_and_specs(cfg, ShapeSpec("t", "train", 32, 2), one_rank)
    params = shard_tree(init_params(cfg, torch.Generator().manual_seed(1), "cpu"), place[0], one_rank)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, seed=30, seq=32).items()}
    _, _, loss = step(params, adamw_init(params), batch)
    per_layer = 7 * (2 if remat else 1)
    assert step.mesh_context.counts["all_gather"] == per_layer * cfg.n_layers + 2
    assert np.isfinite(loss.item())
