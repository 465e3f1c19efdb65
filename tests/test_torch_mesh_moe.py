"""The moe family's mesh steps -- training, prefill and decode -- held
against the reference's one-device path.

`launch.specs.step_and_specs` binds the moe family's steps on a `data` x
`model` mesh: each rank holds its blocks of the parameters (the experts
over `model` by `_MOE_RULES`, d_model over `data`), its slice of the batch
and its blocks of the decode caches. The MoE block keeps the reference's
global semantics (`models.moe`): the capacity of the global token count,
each (token, slot)'s position within its expert continued over the data
ranks before this one, the auxiliary terms as global means, the experts'
partial outputs summed over `model`.

Its ranks run in subprocesses (one a rank, a file store, JAX and the
reference blocked), every case of a world size in one launch: 2 ranks on
meshes (2, 1) and (1, 2), 4 on (2, 2) and (1, 4). The cases, reduced
configs at float32 cut to 2 layers:

  * "phi_drop": phi3.5-moe (4 experts, top-2) at capacity factor 0.5, 4
    requests of 24 tokens: T = 96 < 128, so C = 24 against about 48
    assignments an expert; assignments are dropped in training, prefill
    and decode, and on both data ranks of (2, 1) and (2, 2);
  * "phi_round": phi3.5-moe at 1.25, 4 x 56 tokens (T = 224: C rounded to
    256, where a data rank's 112 tokens alone would not round);
  * "scout": llama4-scout (top-1, a shared expert) at 1.25, 4 x 56, with 4
    BANG-KV steps whose top-L is the hierarchical one;
  * "whole": llama4-scout with 3 experts and 3 requests of 57 tokens: the
    experts whole over `model` 2 and 4 (every `model` rank runs all of
    them; the shared expert is still cut), the batch whole over `data` 2,
    the 61-position cache whole over `model` 2 and 4.

Each case trains 2 steps of the train step, then prefills its prompt and
decodes 4 greedy exact-KV steps; the reference runs the same parameters
(`convert.lm_params_from_reference`) and inputs (numpy seeds) in this
process, its per-layer dropped fractions and top-L ids read by ordered
host callbacks. Bounds: losses and the metrics ce, load_balance, router_z
and dropped_frac within rtol 1e-5; gradients within rtol 1e-4, atol 1e-5,
parameters within 2e-6 save 1 in 1,000 entries, within 2 lr a step
(ROADMAP C15, C18); logits and gathered caches within rtol 1e-5, atol
1e-6; greedy tokens, the cache index, every layer's dropped fraction at
every serve step, BANG-KV codes and top-L ids equal. On a one-rank gloo
group in this process the steps are bit-equal to the plain path.
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
from repro.models import transformer as rtransformer
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
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import flat_dict

from _lm_parity import bang_from_kv, pad_kv

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

SRC = Path(__file__).resolve().parents[1] / "src"
KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6
MARGIN = 1e-4          # the reference's top two logits of a greedy step at least this far apart
STEPS, TRAIN_STEPS = 4, 2
PHI, SCOUT = "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"
# case -> (arch, overrides of the reduced config, tokens a request,
# requests, seed, BANG-KV steps too)
CASES = {
    "phi_drop": (PHI, dict(n_layers=2, capacity_factor=0.5), 24, 4, 1, False),
    "phi_round": (PHI, dict(n_layers=2, capacity_factor=1.25), 56, 4, 2, False),
    "scout": (SCOUT, dict(n_layers=2, capacity_factor=1.25), 56, 4, 3, True),
    "whole": (SCOUT, dict(n_layers=2, capacity_factor=1.25, n_experts=3), 57, 3, 4, False),
}
MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
METRICS = ("ce", "load_balance", "router_z", "dropped_frac")


def _cfgs(case):
    arch, over = CASES[case][:2]
    over = dict(over, opt_hier_topk=True)
    return (rconfigs.get(arch).reduced(dtype="float32", **over),
            configs.get(arch).reduced(dtype="float32", **over))


def _inputs(cfg, case) -> dict:
    """The prompt (B, S) and TRAIN_STEPS training batches of (B, S) tokens
    and labels."""
    _, _, S, B, seed, _ = CASES[case]
    rng = np.random.default_rng(seed)
    out = {"prompt": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    for s in range(TRAIN_STEPS):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out[f"tokens_{s}"], out[f"labels_{s}"] = toks[:, :-1], toks[:, 1:]
    return out


def _port_flat(tree, cfg) -> dict:
    return {k: v.detach().numpy() for k, v in flat_dict(convert.lm_params_from_reference(
        jax.tree.map(np.asarray, tree), cfg, device="cpu")).items()}


def _argmax(logits) -> np.ndarray:
    return np.asarray(logits)[:, 0].argmax(-1)[:, None].astype(np.int32)


def _margin(logits) -> float:
    top = np.sort(np.asarray(logits)[:, 0], axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


class _Recorder:
    """The reference's per-layer dropped fractions (`moe_block` wrapped in
    its transformer module) and BANG-KV top-L ids, read by ordered host
    callbacks as the traced layers take them."""

    def __init__(self):
        self.drops, self.ids = [], []

    def __enter__(self):
        self.moe, self.top_l = rtransformer.moe_block, rbkv._retrieve_top_l

        def moe_block(*args, **kwargs):
            y, aux = self.moe(*args, **kwargs)
            jax.debug.callback(lambda d: self.drops.append(float(d)), aux.dropped_frac, ordered=True)
            return y, aux

        def top_l(*args, **kwargs):
            top = self.top_l(*args, **kwargs)
            jax.debug.callback(lambda t: self.ids.append(np.asarray(t)), top, ordered=True)
            return top

        rtransformer.moe_block, rbkv._retrieve_top_l = moe_block, top_l
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        rtransformer.moe_block, rbkv._retrieve_top_l = self.moe, self.top_l


_UPDATE = jax.jit(lambda g, s, p: radamw_update(g, s, p, LR))   # one compile a parameter shape


def _reference_train(rlm, params, cfg, inputs) -> dict:
    vg = jax.jit(jax.value_and_grad(lambda p, b: rlm.loss(p, b), has_aux=True))
    upd = _UPDATE
    state = radamw_init(params)
    res = {}
    for s in range(TRAIN_STEPS):
        batch = {"tokens": jnp.asarray(inputs[f"tokens_{s}"]), "labels": jnp.asarray(inputs[f"labels_{s}"])}
        (loss, metrics), grads = vg(params, batch)
        if s == 0:
            res["grads"] = _port_flat(grads, cfg)
        params, state, _ = upd(grads, state, params)
        res[f"loss_{s}"] = float(loss)
        for k in METRICS:
            res[f"{k}_{s}"] = float(metrics[k])
        res[f"params_{s}"] = _port_flat(params, cfg)
    return res


def _reference_run(case) -> dict:
    """The reference's training steps, then its jitted prefill and 4 greedy
    exact-KV steps (and 4 greedy BANG-KV steps from the prompt's state with
    every slot encoded), each layer's dropped fraction recorded."""
    rcfg, cfg = _cfgs(case)
    rlm = RLM(rcfg)
    params = rlm.init(KEY)
    inputs = _inputs(cfg, case)
    out = {"params": _port_flat(params, cfg), "inputs": inputs, "margins": []}
    out.update(_reference_train(rlm, params, cfg, inputs))
    with _Recorder() as rec:
        logits, caches = jax.jit(rlm.prefill)(params, {"tokens": jnp.asarray(inputs["prompt"])})
        jax.effects_barrier()
    out["prefill"], out["prefill_drops"] = np.asarray(logits), np.array(rec.drops)
    caches = pad_kv(caches, STEPS)
    out["prefill_k"], out["prefill_v"] = np.asarray(caches.k), np.asarray(caches.v)
    first = _argmax(logits)
    out["margins"].append(_margin(logits))
    kinds = [("exact", caches)]
    if CASES[case][5]:
        kinds.append(("bang", bang_from_kv(params["bangkv_codebooks"], caches)))
    for kind, state in kinds:
        tok = first
        with _Recorder() as rec:
            step = jax.jit(lambda p, c, t, b=kind == "bang": rlm.decode_step(p, c, t, bangkv=b))
            for s in range(STEPS):
                logits, state = step(params, state, jnp.asarray(tok))
                out[f"{kind}/logits_{s}"] = np.asarray(logits)
                out["margins"].append(_margin(logits))
                out[f"{kind}/tokens_{s}"] = tok
                tok = _argmax(logits)
        out[f"{kind}/drops"] = np.array(rec.drops)
        for name in state._fields:
            out[f"{kind}/cache_{name}"] = np.asarray(getattr(state, name))
        if kind == "bang":
            out["bang/ids"] = np.stack(rec.ids)   # (steps x layers, B, H, L)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference run, its parameters and inputs saved for the
    ranks."""
    work = tmp_path_factory.mktemp("mesh_moe")
    ref = {}
    for case in CASES:
        ref[case] = _reference_run(case)
        np.savez(work / f"params_{case}.npz", **ref[case]["params"])
        np.savez(work / f"inputs_{case}.npz", **ref[case]["inputs"])
    (work / "rank.py").write_text(textwrap.dedent(RANK))
    return work, ref


RANK = r"""
import dataclasses, datetime, json, sys
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
from repro_torch.distributed import P, gather_caches, gather_tensor, gather_tree, make_mesh, shard_tree
from repro_torch.launch.specs import param_specs, step_and_specs
from repro_torch.models import moe, transformer
from repro_torch.models import retrieval_attention as bkv
from repro_torch.optim import adamw_init
from repro_torch.tree import flat_dict, flatten_with_path, path_key, unflatten

# Each layer's dropped fraction (the block's, global on a mesh), this
# rank's dropped assignments (`route`'s keep is this rank's tokens'), and
# each BANG-KV top-L selection.
drops, local_drops, ids = [], [], []
block, route, taken = transformer.moe_block, moe.route, bkv._retrieve_top_l


def recording_block(*args, **kwargs):
    y, aux = block(*args, **kwargs)
    drops.append(float(aux.dropped_frac))
    return y, aux


def recording_route(*args, **kwargs):
    r = route(*args, **kwargs)
    local_drops.append(int((~r.keep).sum()))
    return r


def recording_top_l(*args, **kwargs):
    top = taken(*args, **kwargs)
    ids.append(top)
    return top


transformer.moe_block, moe.route, bkv._retrieve_top_l = recording_block, recording_route, recording_top_l


def full_params(cfg, name):
    arrays = np.load(f"{work}/params_{name}.npz")
    template = param_specs(cfg)
    return unflatten(template, [torch.from_numpy(arrays[path_key(p)]) for p, _ in flatten_with_path(template)])


def whole(x, mesh, cut):
    # This rank's requests' rows gathered over `data` where the batch is cut.
    return gather_tensor(x, P("data" if cut else None), mesh).numpy()


def by_data_rank(n, mesh):
    # One count a data rank, in data order.
    return gather_tensor(torch.tensor([n]), P("data"), mesh).numpy()


res = {}
for D, S, cases in jobs:
    mesh = make_mesh((D, S), ("data", "model"), "cpu")
    for case, c in cases.items():
        at = f"{D}x{S}/{case}/"
        cfg = configs.get(c["arch"]).reduced(dtype="float32", opt_hier_topk=True, **c["over"])
        B, seq = c["batch"], c["seq"]
        s_max = seq + c["steps"]
        cut = B % D == 0
        inputs = np.load(f"{work}/inputs_{case}.npz")

        # Training.
        train, _, place = step_and_specs(cfg, ShapeSpec("t", "train", seq, B), mesh)
        sp = flat_dict(place[0])
        params = shard_tree(full_params(cfg, case), place[0], mesh)
        opt = adamw_init(params)
        local_drops.clear()
        for s in range(c["train_steps"]):
            batch = {"tokens": torch.from_numpy(inputs[f"tokens_{s}"]),
                     "labels": torch.from_numpy(inputs[f"labels_{s}"])}
            params, opt, loss = train(params, opt, shard_tree(batch, place[2], mesh))
            res[f"{at}loss_{s}"] = float(loss)
            for k, v in train.metrics.items():
                res[f"{at}{k}_{s}"] = float(v)
            if s == 0:
                for k, p in flat_dict(params).items():
                    if p.grad is not None:
                        res[f"{at}g/{k}"] = gather_tensor(p.grad, sp[k], mesh).numpy()
            for k, v in flat_dict(gather_tree(params, place[0], mesh)).items():
                res[f"{at}p{s}/{k}"] = v.detach().numpy()
        res[at + "train_local_drops"] = by_data_rank(sum(local_drops), mesh)
        res[at + "train_counts"] = np.array([train.mesh_context.counts[k]
                                             for k in ("all_gather", "all_reduce")])

        # Serving, from the initial parameters.
        prefill, _, (p_place, b_place) = step_and_specs(cfg, ShapeSpec("p", "prefill", seq, B), mesh)
        serve, _, _ = step_and_specs(cfg, ShapeSpec("d", "decode", s_max, B), mesh)
        bang, _, _ = step_and_specs(cfg, ShapeSpec("long_500k", "decode", s_max, B), mesh)
        params = shard_tree(full_params(cfg, case), p_place, mesh)
        drops.clear(), local_drops.clear()
        prompt = {"tokens": torch.from_numpy(inputs["prompt"])}
        logits, caches = prefill(params, shard_tree(prompt, b_place, mesh), s_max=s_max)
        res[at + "prefill"] = whole(logits, mesh, cut)
        res[at + "prefill_drops"] = np.array(drops)
        res[at + "prefill_local_drops"] = by_data_rank(sum(local_drops), mesh)
        full = gather_caches(caches, mesh, s_max=s_max, batch_divisible=cut)
        res[at + "prefill_k"], res[at + "prefill_v"] = full.k.numpy(), full.v.numpy()
        res[at + "prefill_index"] = full.index.numpy()
        first = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        runs = [("exact", serve, caches)]
        if c["bang"]:
            cb = params["bangkv_codebooks"]
            state = transformer.clone_caches(caches)
            codes = torch.stack([bkv.encode_keys(cb[i], state.k[i]) for i in range(cfg.n_layers)])
            runs.append(("bang", bang, bkv.BangKVCache(codes, *state[:2], state.index)))
        for kind, step, st in runs:
            tok = first
            drops.clear(), local_drops.clear(), ids.clear()
            for s in range(c["steps"]):
                res[f"{at}{kind}/tokens_{s}"] = whole(tok, mesh, cut)
                logits, st = step(params, st, tok)
                res[f"{at}{kind}/logits_{s}"] = whole(logits, mesh, cut)
                tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            res[f"{at}{kind}/drops"] = np.array(drops)
            res[f"{at}{kind}/local_drops"] = by_data_rank(sum(local_drops), mesh)
            full = gather_caches(st, mesh, s_max=s_max, batch_divisible=cut)
            for field in full._fields:
                res[f"{at}{kind}/cache_{field}"] = getattr(full, field).numpy()
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
    arch, over, S, B, _, bang = CASES[case]
    return dict(arch=arch, over=over, batch=B, seq=S, steps=STEPS, train_steps=TRAIN_STEPS, bang=bang)


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


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_moe_train_step_matches_reference(runs, mesh, case):
    """2 training steps: the loss and the metrics ce, load_balance,
    router_z and dropped_frac (global means over the batch), the gathered
    gradients of the first step and the gathered parameters after each
    step against the reference's one-device steps."""
    ref, out = runs
    got, want = out[mesh], ref[case]
    for s in range(TRAIN_STEPS):
        np.testing.assert_allclose(got[f"{case}/loss_{s}"], want[f"loss_{s}"], rtol=1e-5)
        for k in METRICS:
            np.testing.assert_allclose(got[f"{case}/{k}_{s}"], want[f"{k}_{s}"], rtol=1e-5, err_msg=k)
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
def test_mesh_moe_prefill_and_decode_match_reference(runs, mesh, case):
    """The prefill's last-position logits and gathered caches, then 4 greedy
    exact-KV steps (and for scout 4 greedy BANG-KV steps with the
    hierarchical top-L): logits at every step, the caches after them, the
    tokens, every layer's dropped fraction at every step, the codes and
    the top-L ids against the reference's one-device path."""
    ref, out = runs
    got, want = out[mesh], ref[case]
    assert min(want["margins"]) > MARGIN   # no near tie in the greedy draw
    s_max = want["prefill_k"].shape[2]
    _close(got[f"{case}/prefill"], want["prefill"], "prefill logits")
    _close(got[f"{case}/prefill_k"], want["prefill_k"], "prefill K")
    _close(got[f"{case}/prefill_v"], want["prefill_v"], "prefill V")
    assert np.all(got[f"{case}/prefill_index"] == s_max - STEPS)
    np.testing.assert_array_equal(got[f"{case}/prefill_drops"], want["prefill_drops"])
    kinds = ("exact", "bang") if CASES[case][5] else ("exact",)
    for kind in kinds:
        for s in range(STEPS):
            np.testing.assert_array_equal(got[f"{case}/{kind}/tokens_{s}"], want[f"{kind}/tokens_{s}"])
            _close(got[f"{case}/{kind}/logits_{s}"], want[f"{kind}/logits_{s}"], f"{kind} step {s}")
        for field in ("k", "v"):
            _close(got[f"{case}/{kind}/cache_{field}"], want[f"{kind}/cache_{field}"], f"{kind} {field}")
        assert np.all(got[f"{case}/{kind}/cache_index"] == s_max)
        np.testing.assert_array_equal(got[f"{case}/{kind}/drops"], want[f"{kind}/drops"])
        n_gather, n_reduce = got[f"{case}/{kind}/counts"]
        assert n_gather > 0 and n_reduce > 0
    if "bang" in kinds:
        np.testing.assert_array_equal(got[f"{case}/bang/cache_codes"], want["bang/cache_codes"])
        np.testing.assert_array_equal(got[f"{case}/bang/ids"], want["bang/ids"])


@pytest.mark.parametrize("mesh", MESHES)
def test_capacity_drops_fall_on_every_data_rank(runs, mesh):
    """phi_drop drops assignments in training, prefill and decode; on (2, 1)
    and (2, 2) on both data ranks (the second rank's slots start after the
    first rank's assignments); the rounded cases drop none in prefill."""
    ref, out = runs
    got, want = out[mesh], ref["phi_drop"]
    assert want["dropped_frac_0"] > 0 and np.all(want["prefill_drops"] > 0)
    assert np.all(want["exact/drops"] > 0)
    for what in ("train_local_drops", "prefill_local_drops", "exact/local_drops"):
        local = got[f"phi_drop/{what}"]
        assert len(local) == mesh[0] and np.all(local > 0), (what, local)
    for case in ("phi_round", "scout"):   # 1 - 448 x float32(1/448) rounded once: -4.5e-8
        assert np.all(np.abs(ref[case]["prefill_drops"]) < 1e-7)
        assert np.all(got[f"{case}/prefill_local_drops"] == 0)


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


ONE_RANK = [(PHI, "float32", dict(n_layers=2)), (SCOUT, "float32", dict(n_layers=2)),
            (PHI, "bfloat16", dict(n_layers=2, capacity_factor=0.5))]


@pytest.mark.parametrize("name,dtype,over", ONE_RANK)
def test_one_rank_moe_train_step_is_bit_equal_to_the_plain_step(one_rank, name, dtype, over):
    """On a (1, 1) mesh every collective is a copy and the MoE block takes
    the plain path's operations: three steps give the plain step's losses,
    metrics and parameters bit for bit (bf16 with dropping too: 96 tokens,
    C = 24)."""
    cfg = configs.get(name).reduced(dtype=dtype, **over)
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
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        mesh_params, opt, loss = step(mesh_params, opt, shard_tree(batch, place[2], one_rank))
        for p in plain.parameters():
            p.grad = None
        plain_loss, metrics = lm.loss(batch)
        plain_loss.backward()
        _, plain_opt, _ = adamw_update({k: p.grad for k, p in flat_dict(plain).items()}, plain_opt,
                                       plain, LR)
        assert loss.item() == plain_loss.item(), s
        assert all(torch.equal(step.metrics[k], metrics[k]) for k in METRICS), s
    if "capacity_factor" in over:
        assert float(metrics["dropped_frac"]) > 0
    a, b = flat_dict(mesh_params), flat_dict(plain)
    assert all(torch.equal(a[k].detach(), b[k].detach()) for k in a)
    assert all(torch.equal(opt.master[k], plain_opt.master[k]) for k in a)
    counts = step.mesh_context.counts
    assert counts["all_gather"] > 0 and counts["all_reduce"] > 0


@pytest.mark.parametrize("name,dtype,over", ONE_RANK)
def test_one_rank_moe_serve_is_bit_equal_to_the_plain_path(one_rank, name, dtype, over):
    """On a (1, 1) mesh the moe prefill's logits and caches, 4 exact-KV and
    4 BANG-KV (hierarchical top-L) steps' logits and caches are the plain
    path's bit for bit."""
    cfg = configs.get(name).reduced(dtype=dtype, opt_hier_topk=True, **over)
    B, S = 2, 24
    s_max = S + STEPS
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, S + STEPS), generator=g)
    prefill, _, (p_place, b_place) = step_and_specs(cfg, ShapeSpec("p", "prefill", S, B), one_rank)
    serve, _, _ = step_and_specs(cfg, ShapeSpec("d", "decode", s_max, B), one_rank)
    bang, _, _ = step_and_specs(cfg, ShapeSpec("long_500k", "decode", s_max, B), one_rank)
    mesh_params = shard_tree(params, p_place, one_rank)
    lm = LM(cfg, params)
    got, caches = prefill(mesh_params, shard_tree({"tokens": toks[:, :S]}, b_place, one_rank),
                          s_max=s_max)
    want, plain = lm.prefill({"tokens": toks[:, :S]}, s_max=s_max)
    assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(caches, plain))
    cb = params["bangkv_codebooks"]
    codes = torch.stack([bkv.encode_keys(cb[i], plain.k[i]) for i in range(cfg.n_layers)])
    plain_bang = bkv.BangKVCache(codes, plain.k.clone(), plain.v.clone(), plain.index.clone())
    bang_caches = shard_caches(plain_bang, one_rank, batch_divisible=True)
    for s in range(STEPS):
        tok = toks[:, S + s:S + s + 1]
        got, caches = serve(mesh_params, caches, tok)
        want, plain = lm.decode_step(plain, tok)
        assert torch.equal(got, want), ("exact", s)
        got, bang_caches = bang(mesh_params, bang_caches, tok)
        want, plain_bang = lm.decode_step(plain_bang, tok, bangkv=True)
        assert torch.equal(got, want), ("BANG-KV", s)
    for a, b in ((caches, plain), (bang_caches, plain_bang)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    counts = serve.mesh_context.counts
    assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
