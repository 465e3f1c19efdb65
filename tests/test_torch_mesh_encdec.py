"""The encdec family's mesh steps -- training, prefill and decode -- held
against the reference's one-device path.

`launch.specs.step_and_specs` binds whisper's steps on a `data` x `model`
mesh: each rank holds its blocks of the parameters (every weight of the
encoder, the self-attention, the cross-attention and the FFN FSDP over
`data` and Megatron TP over `model`; the table cut over `model` where the
vocabulary divides it, else whole there), its slice of the batch (tokens
and frames) and its blocks of the decode caches (the self caches'
sequence over `model`; the cross K and V cut over the batch on `data`
only, whole over `model`). The encoder runs its heads and its block of
d_ff on each `model` rank and its memory comes out whole; `cross_kv`
gathers `cross/wk` and `cross/wv` whole over `model`, so every rank holds
every KV head of the cross K and V and each decoder layer's cross block
reads the heads its query heads take (`attention.cross_attention_block`).

Its ranks run in subprocesses (one a rank, a file store, JAX and the
reference blocked), every case of a world size in one launch: 2 ranks on
meshes (2, 1) and (1, 2), 4 on (2, 2) and (1, 4). The cases, reduced
whisper at float32 with 12 frames:

  * "whisper": 4 heads, 2 KV heads, vocabulary 256, 4 requests of 24
    tokens: the table, the heads, the batch cut on every mesh;
  * "uneven": vocabulary 255 (odd, so the table and the tied head stay
    whole over `model`, as whisper-medium's 51,865 rows do), 3 requests of
    28 tokens (the batch whole over `data` 2); on `model` 4 the 4 query
    heads are cut while the 2 KV heads are whole (`wk` and `wv` gathered
    at their use, each rank reading one KV head of the cross K and V).

Each case trains 2 steps of the train step, prefills its prompt, then
decodes 4 greedy exact-KV steps and 4 greedy BANG-KV steps (hierarchical
top-L) from the reference's prompt state cut into each rank's blocks
(`shard_caches`), as tests/test_torch_mesh_ssm.py does; the reference runs
the same parameters (`convert.lm_params_from_reference`) and inputs (numpy
seeds) in this process, its top-L ids read by an ordered host callback.
Bounds (ROADMAP C11, C15, C18): losses within rtol 1e-5; gradients within
rtol 1e-4, atol 1e-5; parameters within 2e-6 save 1 in 1,000 entries,
within 2 lr a step; logits and gathered caches (self K and V, cross K and
V) within rtol 1e-5, atol 1e-6; greedy tokens, the cache index, BANG-KV
codes and top-L ids equal, the reference's top two logits of every step at
least 1e-4 apart. On a one-rank gloo group in this process the steps are
bit-equal to the plain path.
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
from repro.models import retrieval_attention as rbkv
from repro.models.transformer import LM as RLM
from repro.optim import adamw_init as radamw_init
from repro.optim import adamw_update as radamw_update
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import make_mesh, shard_caches, shard_tree
from repro_torch.launch.specs import LR, step_and_specs
from repro_torch.models import LM, init_params
from repro_torch.models import retrieval_attention as bkv
from repro_torch.models.transformer import clone_caches
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import flat_dict

from _lm_parity import bang_from_kv, pad_kv

SRC = Path(__file__).resolve().parents[1] / "src"
KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6
MARGIN = 1e-4          # the reference's top two logits of a greedy step at least this far apart
STEPS, TRAIN_STEPS = 4, 2
ARCH = "whisper-medium"
FRAMES = 12
# case -> (overrides of the reduced config, tokens a request, requests, seed)
CASES = {
    "whisper": ({}, 24, 4, 1),
    "uneven": (dict(vocab_size=255), 28, 3, 2),
}
MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]


def _cfgs(case):
    over = dict(CASES[case][0], frontend_len=FRAMES, opt_hier_topk=True)
    return (rconfigs.get(ARCH).reduced(dtype="float32", **over),
            configs.get(ARCH).reduced(dtype="float32", **over))


def _inputs(cfg, case) -> dict:
    """The prompt (B, S) and its frames (B, FRAMES, D), and TRAIN_STEPS
    training batches of (B, S) tokens and labels and their frames."""
    _, S, B, seed = CASES[case]
    rng = np.random.default_rng(seed)
    frames = lambda: rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)   # noqa: E731
    out = {"prompt": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32), "frames": frames()}
    for s in range(TRAIN_STEPS):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out[f"tokens_{s}"], out[f"labels_{s}"] = toks[:, :-1], toks[:, 1:]
        out[f"frames_{s}"] = frames()
    return out


def _batch(inputs, s: int) -> dict:
    return {"tokens": inputs[f"tokens_{s}"], "labels": inputs[f"labels_{s}"],
            "frontend": inputs[f"frames_{s}"]}


def _port_flat(tree, cfg) -> dict:
    return {k: v.detach().numpy() for k, v in flat_dict(convert.lm_params_from_reference(
        jax.tree.map(np.asarray, tree), cfg, device="cpu")).items()}


def _argmax(logits) -> np.ndarray:
    return np.asarray(logits)[:, 0].argmax(-1)[:, None].astype(np.int32)


def _margin(logits) -> float:
    top = np.sort(np.asarray(logits)[:, 0], axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


def _fields(caches) -> dict:
    """A decode state's arrays by name: the self caches' k, v, index (and
    codes), the cross K and V."""
    own, (ck, cv) = caches
    return {**dict(zip(own._fields, own)), "cross_k": ck, "cross_v": cv}


_UPDATE = jax.jit(lambda g, s, p: radamw_update(g, s, p, LR))   # one compile a parameter shape


def _reference_train(rlm, params, cfg, inputs) -> dict:
    vg = jax.jit(jax.value_and_grad(lambda p, b: rlm.loss(p, b), has_aux=True))
    state = radamw_init(params)
    res = {}
    for s in range(TRAIN_STEPS):
        (loss, _), grads = vg(params, jax.tree.map(jnp.asarray, _batch(inputs, s)))
        if s == 0:
            res["grads"] = _port_flat(grads, cfg)
        params, state, _ = _UPDATE(grads, state, params)
        res[f"loss_{s}"] = float(loss)
        res[f"params_{s}"] = _port_flat(params, cfg)
    return res


def _reference_run(case) -> dict:
    """The reference's training steps, then its jitted prefill, 4 greedy
    exact-KV steps and 4 greedy BANG-KV steps from the prompt's state with
    every slot encoded (its top-L ids recorded)."""
    rcfg, cfg = _cfgs(case)
    rlm = RLM(rcfg)
    params = rlm.init(KEY)
    inputs = _inputs(cfg, case)
    out = {"params": _port_flat(params, cfg), "inputs": inputs, "margins": []}
    out.update(_reference_train(rlm, params, cfg, inputs))
    prompt = {"tokens": jnp.asarray(inputs["prompt"]), "frontend": jnp.asarray(inputs["frames"])}
    logits, (own, cross) = jax.jit(rlm.prefill)(params, prompt)
    out["prefill"] = np.asarray(logits)
    caches = (pad_kv(own, STEPS), cross)
    out["prefill_caches"] = {k: np.asarray(v) for k, v in _fields(caches).items()}
    out["start"] = {k: v.numpy() for k, v in _fields(convert.lm_caches_from_reference(
        jax.tree.map(np.asarray, caches), cfg, device="cpu")).items()}
    first = _argmax(logits)
    out["margins"].append(_margin(logits))
    bang = (bang_from_kv(params["bangkv_codebooks"], caches[0]), cross)
    for kind, state in (("exact", caches), ("bang", bang)):
        tok, ids = first, []
        top_l = rbkv._retrieve_top_l

        def recording(*args, **kwargs):
            top = top_l(*args, **kwargs)
            jax.debug.callback(lambda t: ids.append(np.asarray(t)), top, ordered=True)
            return top

        rbkv._retrieve_top_l = recording
        try:
            step = jax.jit(lambda p, c, t, b=kind == "bang": rlm.decode_step(p, c, t, bangkv=b))
            for s in range(STEPS):
                logits, state = step(params, state, jnp.asarray(tok))
                out[f"{kind}/logits_{s}"] = np.asarray(logits)
                out["margins"].append(_margin(logits))
                out[f"{kind}/tokens_{s}"] = tok
                tok = _argmax(logits)
            jax.effects_barrier()
        finally:
            rbkv._retrieve_top_l = top_l
        out[f"{kind}/caches"] = {k: np.asarray(v) for k, v in _fields(state).items()}
    out["bang/ids"] = np.stack(ids)   # (steps x layers, B, H, L)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference run, its parameters, inputs and prompt state
    saved for the ranks."""
    work = tmp_path_factory.mktemp("mesh_encdec")
    ref = {}
    for case in CASES:
        ref[case] = _reference_run(case)
        np.savez(work / f"params_{case}.npz", **ref[case]["params"])
        np.savez(work / f"inputs_{case}.npz", **ref[case]["inputs"])
        np.savez(work / f"start_{case}.npz", **ref[case]["start"])
    (work / "rank.py").write_text(textwrap.dedent(RANK))
    return work, ref


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
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import (P, gather_caches, gather_tensor, gather_tree, make_mesh,
                                     shard_caches, shard_tree)
from repro_torch.distributed.collectives import MeshContext
from repro_torch.launch.specs import param_specs, step_and_specs
from repro_torch.models import retrieval_attention as bkv
from repro_torch.models.attention import HeadPlan, KVCache
from repro_torch.optim import adamw_init
from repro_torch.tree import flat_dict, flatten_with_path, path_key, unflatten

ids, taken = [], bkv._retrieve_top_l


def recording_top_l(*args, **kwargs):
    top = taken(*args, **kwargs)
    ids.append(top)
    return top


bkv._retrieve_top_l = recording_top_l


def full_params(cfg, name):
    arrays = np.load(f"{work}/params_{name}.npz")
    template = param_specs(cfg)
    return unflatten(template, [torch.from_numpy(arrays[path_key(p)]) for p, _ in flatten_with_path(template)])


def whole(x, mesh, cut):
    # This rank's requests' rows gathered over `data` where the batch is cut.
    return gather_tensor(x, P("data" if cut else None), mesh).numpy()


def fields(caches):
    own, (ck, cv) = caches
    return {**{f: getattr(own, f) for f in own._fields}, "cross_k": ck, "cross_v": cv}


res = {}
for D, S, cases in jobs:
    mesh = make_mesh((D, S), ("data", "model"), "cpu")
    for case, c in cases.items():
        at = f"{D}x{S}/{case}/"
        cfg = configs.get(c["arch"]).reduced(dtype="float32", frontend_len=c["frames"],
                                             opt_hier_topk=True, **c["over"])
        B, seq = c["batch"], c["seq"]
        s_max = seq + c["steps"]
        cut = B % D == 0
        inputs = np.load(f"{work}/inputs_{case}.npz")
        mc = MeshContext(mesh, cfg)
        plan = HeadPlan(mc, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        res[at + "routes"] = np.array([plan.q_use == "shard", plan.kv_use == "shard",
                                       mc.vocab_block("embed") is not None, cut])

        # Training.
        train, _, place = step_and_specs(cfg, ShapeSpec("t", "train", seq, B), mesh)
        sp = flat_dict(place[0])
        params = shard_tree(full_params(cfg, case), place[0], mesh)
        opt = adamw_init(params)
        for s in range(c["train_steps"]):
            batch = {"tokens": torch.from_numpy(inputs[f"tokens_{s}"]),
                     "labels": torch.from_numpy(inputs[f"labels_{s}"]),
                     "frontend": torch.from_numpy(inputs[f"frames_{s}"])}
            params, opt, loss = train(params, opt, shard_tree(batch, place[2], mesh))
            res[f"{at}loss_{s}"] = float(loss)
            if s == 0:
                for k, p in flat_dict(params).items():
                    if p.grad is not None:
                        res[f"{at}g/{k}"] = gather_tensor(p.grad, sp[k], mesh).numpy()
            for k, v in flat_dict(gather_tree(params, place[0], mesh)).items():
                res[f"{at}p{s}/{k}"] = v.detach().numpy()
        res[at + "train_counts"] = np.array([train.mesh_context.counts[k]
                                             for k in ("all_gather", "all_reduce")])

        # Serving, from the initial parameters.
        prefill, _, (p_place, b_place) = step_and_specs(cfg, ShapeSpec("p", "prefill", seq, B), mesh)
        serve, _, _ = step_and_specs(cfg, ShapeSpec("d", "decode", s_max, B), mesh)
        bang, _, _ = step_and_specs(cfg, ShapeSpec("long_500k", "decode", s_max, B), mesh)
        params = shard_tree(full_params(cfg, case), p_place, mesh)
        prompt = {"tokens": torch.from_numpy(inputs["prompt"]),
                  "frontend": torch.from_numpy(inputs["frames"])}
        logits, caches = prefill(params, shard_tree(prompt, b_place, mesh), s_max=s_max)
        res[at + "prefill"] = whole(logits, mesh, cut)
        first = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        for f, t in fields(caches).items():
            res[f"{at}shape/{f}"] = np.array(t.shape)
        full = gather_caches(caches, mesh, s_max=s_max, batch_divisible=cut)
        for f, t in fields(full).items():
            res[f"{at}prefill_{f}"] = t.numpy()
        # Decode from the reference's prompt state, cut into this rank's blocks.
        start = {k: torch.from_numpy(v) for k, v in np.load(f"{work}/start_{case}.npz").items()}
        start_c = (KVCache(start["k"], start["v"], start["index"]), (start["cross_k"], start["cross_v"]))
        start_c = shard_caches(start_c, mesh, batch_divisible=cut)
        cb = params["bangkv_codebooks"]
        kv = KVCache(*(t.clone() for t in start_c[0]))
        codes = torch.stack([bkv.encode_keys(cb[i], kv.k[i]) for i in range(kv.k.shape[0])])
        bang_c = (bkv.BangKVCache(codes, kv.k, kv.v, kv.index), start_c[1])
        for kind, step, st in (("exact", serve, start_c), ("bang", bang, bang_c)):
            tok = first
            ids.clear()
            for s in range(c["steps"]):
                res[f"{at}{kind}/tokens_{s}"] = whole(tok, mesh, cut)
                logits, st = step(params, st, tok)
                res[f"{at}{kind}/logits_{s}"] = whole(logits, mesh, cut)
                tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            full = gather_caches(st, mesh, s_max=s_max, batch_divisible=cut)
            for f, t in fields(full).items():
                res[f"{at}{kind}/cache/{f}"] = t.numpy()
            if kind == "bang":
                res[at + "bang/ids"] = np.stack([whole(t, mesh, cut) for t in ids])
            res[f"{at}{kind}/counts"] = np.array([step.mesh_context.counts[k]
                                                  for k in ("all_gather", "all_reduce")])
if rank == 0:
    np.savez(f"{out}/out.npz", **res)
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
    order, each on its mesh; rank 0's results, keyed "DxS/case/..."."""
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
    return dict(np.load(out / "out.npz"))


def _case_args(case: str) -> dict:
    over, S, B, _ = CASES[case]
    return dict(arch=ARCH, over=over, frames=FRAMES, batch=B, seq=S, steps=STEPS,
                train_steps=TRAIN_STEPS)


@pytest.fixture(scope="module")
def runs(reference):
    """Two launches: two ranks on (2, 1) and (1, 2), four on (2, 2) and
    (1, 4), every case on each mesh. Returns {mesh: {case/key: array}}."""
    work, ref = reference
    jobs = {w: [(D, S, {case: _case_args(case) for case in CASES}) for D, S in MESHES if D * S == w]
            for w in (2, 4)}
    merged = {**_launch(work, 2, jobs[2]), **_launch(work, 4, jobs[4])}
    out = {}
    for key, v in merged.items():
        mesh, rest = key.split("/", 1)
        out.setdefault(tuple(int(n) for n in mesh.split("x")), {})[rest] = v
    return ref, out


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _hold_params(got: dict, prefix: str, want: dict, n_steps: int) -> None:
    worst, over, total = 0.0, 0, 0
    for k, w in want.items():
        d = np.abs(got[f"{prefix}{k}"] - w)
        worst = max(worst, float(d.max()))
        over += int((d > 2e-6).sum())
        total += d.size
    assert over <= 1e-3 * total and worst <= 2 * LR * n_steps, (worst, over, total)


def _hold_caches(got: dict, prefix: str, want: dict, what: str) -> None:
    assert {k for k in got if k.startswith(prefix)} == {prefix + f for f in want}, what
    for f, w in want.items():
        g = got[prefix + f]
        assert g.shape == w.shape, (what, f, g.shape, w.shape)
        if f in ("index", "codes"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")
        else:
            _close(g, w.astype(np.float32), f"{what} {f}")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_encdec_train_step_matches_reference(runs, mesh, case):
    """2 training steps: the loss, the gathered gradients of the first step
    (the encoder's and the cross block's included) and the gathered
    parameters after each step against the reference's one-device
    steps."""
    ref, out = runs
    got, want = out[mesh], ref[case]
    for s in range(TRAIN_STEPS):
        np.testing.assert_allclose(got[f"{case}/loss_{s}"], want[f"loss_{s}"], rtol=1e-5)
        _hold_params(got, f"{case}/p{s}/", want[f"params_{s}"], s + 1)
    prefix = f"{case}/g/"
    keys = [k for k in want["grads"] if prefix + k in got]
    assert len(keys) == len([k for k in got if k.startswith(prefix)]) > 0
    assert {k for k in want["grads"] if "bangkv" not in k} <= set(keys)
    for k in keys:
        np.testing.assert_allclose(got[prefix + k], want["grads"][k], rtol=1e-4, atol=1e-5, err_msg=k)
    n_gather, n_reduce = got[f"{case}/train_counts"]
    assert n_gather > 0 and n_reduce > 0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_encdec_prefill_and_decode_match_reference(runs, mesh, case):
    """The prefill's last-position logits and gathered caches (self K and
    V, cross K and V), then 4 greedy exact-KV and 4 greedy BANG-KV steps
    with the hierarchical top-L: logits at every step, the caches after
    them, the tokens, the codes and the top-L ids against the reference's
    one-device path."""
    ref, out = runs
    got, want = out[mesh], ref[case]
    assert min(want["margins"]) > MARGIN   # no near tie in the greedy draw
    _close(got[f"{case}/prefill"], want["prefill"], "prefill logits")
    _hold_caches(got, f"{case}/prefill_", want["prefill_caches"], "prefill")
    for kind in ("exact", "bang"):
        for s in range(STEPS):
            np.testing.assert_array_equal(got[f"{case}/{kind}/tokens_{s}"], want[f"{kind}/tokens_{s}"])
            _close(got[f"{case}/{kind}/logits_{s}"], want[f"{kind}/logits_{s}"], f"{kind} step {s}")
        _hold_caches(got, f"{case}/{kind}/cache/", want[f"{kind}/caches"], kind)
        n_gather, n_reduce = got[f"{case}/{kind}/counts"]
        assert n_gather > 0 and n_reduce > 0
    np.testing.assert_array_equal(got[f"{case}/bang/ids"], want["bang/ids"])


@pytest.mark.parametrize("mesh", MESHES)
def test_routes_follow_the_config_and_the_mesh(runs, mesh):
    """The routes each case takes (query heads cut, KV projections cut, the
    table cut over `model`, the batch cut over `data`), and the prefill's
    caches are this rank's blocks: the self caches' sequence over `model`,
    the cross K and V over the batch only (every frame and KV head on every
    `model` rank)."""
    _, out = runs
    got = out[mesh]
    D, M = mesh
    for case, (over, S, B, _) in CASES.items():
        cfg = _cfgs(case)[1]
        cut = B % D == 0
        want = (True, cfg.n_kv_heads % M == 0, cfg.vocab_size % M == 0, cut)
        assert tuple(got[f"{case}/routes"]) == want, case
        B_r = B // D if cut else B
        assert tuple(got[f"{case}/shape/k"]) == (cfg.n_layers, B_r, (S + STEPS) // M, cfg.n_kv_heads,
                                                 cfg.head_dim)
        for f in ("cross_k", "cross_v"):
            assert tuple(got[f"{case}/shape/{f}"]) == (cfg.n_layers, B_r, FRAMES, cfg.n_kv_heads,
                                                       cfg.head_dim)
    if mesh == (1, 4):   # the uneven case's KV heads whole, its table whole
        assert tuple(got["uneven/routes"]) == (True, False, False, True)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_rank_encdec_train_step_is_bit_equal_to_the_plain_step(one_rank, dtype):
    """On a (1, 1) mesh every collective is a copy and the encoder, the
    cross K and V and the cross block take the plain path's operations:
    three steps give the plain step's losses and parameters bit for bit."""
    cfg = configs.get(ARCH).reduced(dtype=dtype, frontend_len=FRAMES)
    B, S = 4, 24
    step, _, place = step_and_specs(cfg, ShapeSpec("t", "train", S, B), one_rank)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    plain = shard_tree(params, place[0], one_rank)     # a copy on one rank
    mesh_params = shard_tree(params, place[0], one_rank)
    opt, plain_opt = adamw_init(mesh_params), adamw_init(plain)
    lm = LM(cfg, plain)
    plain.requires_grad_(True)
    rng = np.random.default_rng(20)
    for s in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
        frames = torch.from_numpy(rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frontend": frames}
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_rank_encdec_serve_is_bit_equal_to_the_plain_path(one_rank, dtype):
    """On a (1, 1) mesh the prefill's logits and caches (self and cross)
    and 4 decode steps' logits and caches, exact-KV and BANG-KV with the
    hierarchical top-L, are the plain path's bit for bit; the cross K and
    V pass through the decode steps unchanged."""
    cfg = configs.get(ARCH).reduced(dtype=dtype, frontend_len=FRAMES, opt_hier_topk=True)
    B, S = 2, 24
    s_max = S + STEPS
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, S + STEPS), generator=g)
    batch = {"tokens": toks[:, :S], "frontend": torch.randn((B, FRAMES, cfg.d_model), generator=g)}
    prefill, _, (p_place, b_place) = step_and_specs(cfg, ShapeSpec("p", "prefill", S, B), one_rank)
    serve, _, _ = step_and_specs(cfg, ShapeSpec("d", "decode", s_max, B), one_rank)
    bang, _, _ = step_and_specs(cfg, ShapeSpec("long_500k", "decode", s_max, B), one_rank)
    mesh_params = shard_tree(params, p_place, one_rank)
    lm = LM(cfg, params)
    got, caches = prefill(mesh_params, shard_tree(batch, b_place, one_rank), s_max=s_max)
    want, plain = lm.prefill(batch, s_max=s_max)
    leaves = lambda c: list(_fields(c).values())   # noqa: E731
    assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(leaves(caches), leaves(plain)))
    cb = params["bangkv_codebooks"]
    kv, cross = clone_caches(plain)
    codes = torch.stack([bkv.encode_keys(cb[i], kv.k[i]) for i in range(kv.k.shape[0])])
    plain_bang = (bkv.BangKVCache(codes, kv.k, kv.v, kv.index), cross)
    mesh_bang = shard_caches(clone_caches(plain_bang), one_rank, batch_divisible=True)
    for step, mesh_c, plain_c, bangkv in ((serve, caches, plain, False),
                                          (bang, mesh_bang, plain_bang, True)):
        for s in range(STEPS):
            tok = toks[:, S + s:S + s + 1]
            got, mesh_c = step(mesh_params, mesh_c, tok)
            want, plain_c = lm.decode_step(plain_c, tok, bangkv=bangkv)
            assert torch.equal(got, want), (bangkv, s)
        assert all(torch.equal(x, y) for x, y in zip(leaves(mesh_c), leaves(plain_c)))
        assert torch.equal(mesh_c[1][0], plain[1][0]) and torch.equal(mesh_c[1][1], plain[1][1])
    counts = serve.mesh_context.counts
    assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
    assert bang.mesh_context.counts["all_gather"] > counts["all_gather"]   # the top-L's candidates
