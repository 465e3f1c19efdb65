"""The ssm and hybrid families' mesh steps -- training, prefill and decode --
held against the reference's one-device path.

`launch.specs.step_and_specs` binds the steps of mamba2 and zamba2 on a
`data` x `model` mesh: each rank holds its blocks of the parameters (the
Mamba2 block cut over `model` by the rules: in_proj's columns, the conv
channels, the heads and di; d_model over `data`), its slice of the batch
and its blocks of the decode caches (the conv window's channels, the
state's heads, zamba2's attention caches' sequence). The block's re-layout
between the reference's two `constrain` hints is written out
(`models.ssm.SSMLayout`): the projection and the conv output all-gathered
over `model`, the SSD on this rank's heads, the gated norm's sum of squares
and out_proj's partial sums all-reduced over `model`.

Its ranks run in subprocesses (one a rank, a file store, JAX and the
reference blocked), every case of a world size in one launch: 2 ranks on
meshes (2, 1) and (1, 2), 4 on (2, 2) and (1, 4). The cases, reduced
configs at float32:

  * "mamba": mamba2 (4 layers), 4 requests of 24 tokens: every width cut
    on every mesh;
  * "uneven": mamba2 with d_model 48 (di 96, 6 heads, 230 in_proj columns,
    128 conv channels), 3 requests of 24 tokens: the batch whole over
    `data` 2; on `model` 4 the heads and in_proj's columns whole while di
    and the conv channels are cut, so a block of norm_w holds 1.5 heads;
  * "zamba": zamba2 (4 layers, 2 shared-attention calls), 4 requests of 28
    tokens, with 4 BANG-KV steps whose top-L is the hierarchical one.

Each case trains 2 steps of the train step, then prefills its prompt and
decodes 4 greedy exact-KV steps from the reference's prompt state, cut
into each rank's blocks (`shard_caches`); the reference runs the same
parameters (`convert.lm_params_from_reference`) and inputs (numpy seeds)
in this process, its top-L ids read by an ordered host callback. Bounds
(ROADMAP C12, C14, C15, C18, C21): losses within rtol 1e-5; gradients
within rtol 1e-4, atol 1e-5; parameters within 2e-6 save 1 in 1,000
entries, within 2 lr a step; logits and gathered caches (conv, state, K,
V) within rtol 1e-5, atol 1e-6, save the prefill's bf16-rounded conv
window, whose entries may also lie one bf16 ulp from the reference's (at
most 1 in 1,000; the plain path's do too, and a decode from such a window
moves the logits past that bound, hence the reference's prompt state);
greedy tokens, the cache index, BANG-KV codes and top-L ids equal. On a
one-rank gloo group in this process the steps are bit-equal to the plain
path.
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

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

SRC = Path(__file__).resolve().parents[1] / "src"
KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6
MARGIN = 1e-4          # the reference's top two logits of a greedy step at least this far apart
STEPS, TRAIN_STEPS = 4, 2
MAMBA, ZAMBA = "mamba2-2.7b", "zamba2-2.7b"
# case -> (arch, overrides of the reduced config, tokens a request,
# requests, seed, BANG-KV steps too)
CASES = {
    "mamba": (MAMBA, {}, 24, 4, 1, False),
    "uneven": (MAMBA, dict(d_model=48), 24, 3, 2, False),
    "zamba": (ZAMBA, {}, 28, 4, 3, True),
}
MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]


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


def _fields(caches) -> dict:
    """A decode state's arrays by field name: an SSM cache's conv and
    state, an attention cache's k, v, index (and codes)."""
    if hasattr(caches, "_fields"):
        return dict(zip(caches._fields, caches))
    return {k: v for part in caches for k, v in _fields(part).items()}


_UPDATE = jax.jit(lambda g, s, p: radamw_update(g, s, p, LR))   # one compile a parameter shape


def _reference_train(rlm, params, cfg, inputs) -> dict:
    vg = jax.jit(jax.value_and_grad(lambda p, b: rlm.loss(p, b), has_aux=True))
    state = radamw_init(params)
    res = {}
    for s in range(TRAIN_STEPS):
        batch = {"tokens": jnp.asarray(inputs[f"tokens_{s}"]), "labels": jnp.asarray(inputs[f"labels_{s}"])}
        (loss, _), grads = vg(params, batch)
        if s == 0:
            res["grads"] = _port_flat(grads, cfg)
        params, state, _ = _UPDATE(grads, state, params)
        res[f"loss_{s}"] = float(loss)
        res[f"params_{s}"] = _port_flat(params, cfg)
    return res


def _reference_run(case) -> dict:
    """The reference's training steps, then its jitted prefill and 4 greedy
    exact-KV steps (for zamba2 also 4 greedy BANG-KV steps from the
    prompt's state with every slot encoded, its top-L ids recorded)."""
    rcfg, cfg = _cfgs(case)
    rlm = RLM(rcfg)
    params = rlm.init(KEY)
    inputs = _inputs(cfg, case)
    out = {"params": _port_flat(params, cfg), "inputs": inputs, "margins": []}
    out.update(_reference_train(rlm, params, cfg, inputs))
    logits, caches = jax.jit(rlm.prefill)(params, {"tokens": jnp.asarray(inputs["prompt"])})
    out["prefill"] = np.asarray(logits)
    if cfg.family == "hybrid":
        caches = (caches[0], pad_kv(caches[1], STEPS))
    out["prefill_caches"] = {k: np.asarray(v) for k, v in _fields(caches).items()}
    out["start"] = {k: v.numpy() for k, v in _fields(convert.lm_caches_from_reference(
        jax.tree.map(np.asarray, caches), cfg, device="cpu")).items()}
    first = _argmax(logits)
    out["margins"].append(_margin(logits))
    kinds = [("exact", caches)]
    if CASES[case][5]:
        kinds.append(("bang", (caches[0], bang_from_kv(params["bangkv_codebooks"], caches[1]))))
    for kind, state in kinds:
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
        if kind == "bang":
            out["bang/ids"] = np.stack(ids)   # (steps x groups, B, H, L)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference run, its parameters and inputs saved for the
    ranks."""
    work = tmp_path_factory.mktemp("mesh_ssm")
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
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache, SSMLayout
from repro_torch.models.transformer import clone_caches
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
    if hasattr(caches, "_fields"):
        return {f: getattr(caches, f) for f in caches._fields}
    return {k: v for part in caches for k, v in fields(part).items()}


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
        lay = SSMLayout(MeshContext(mesh, cfg), cfg.d_model, expand=cfg.ssm_expand,
                        state=cfg.ssm_state, head_dim=cfg.ssm_head_dim, groups=cfg.ssm_groups)
        res[at + "layout"] = np.array([lay.cut_in, lay.cut_conv, lay.cut_h, lay.cut_di, cut])

        # Training.
        train, _, place = step_and_specs(cfg, ShapeSpec("t", "train", seq, B), mesh)
        sp = flat_dict(place[0])
        params = shard_tree(full_params(cfg, case), place[0], mesh)
        opt = adamw_init(params)
        for s in range(c["train_steps"]):
            batch = {"tokens": torch.from_numpy(inputs[f"tokens_{s}"]),
                     "labels": torch.from_numpy(inputs[f"labels_{s}"])}
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
        params = shard_tree(full_params(cfg, case), p_place, mesh)
        prompt = {"tokens": torch.from_numpy(inputs["prompt"])}
        logits, caches = prefill(params, shard_tree(prompt, b_place, mesh), s_max=s_max)
        res[at + "prefill"] = whole(logits, mesh, cut)
        for f, t in fields(caches).items():
            res[f"{at}shape/{f}"] = np.array(t.shape)
        full = gather_caches(caches, mesh, s_max=s_max, batch_divisible=cut, cfg=cfg)
        for f, t in fields(full).items():
            res[f"{at}prefill_{f}"] = t.numpy()
        first = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        # Decode from the reference's prompt state, cut into this rank's blocks.
        start = {k: torch.from_numpy(v) for k, v in np.load(f"{work}/start_{case}.npz").items()}
        start_c = SSMCache(start["conv"], start["state"])
        if "k" in start:
            start_c = (start_c, KVCache(start["k"], start["v"], start["index"]))
        start_c = shard_caches(start_c, mesh, batch_divisible=cut)
        runs = [("exact", serve, start_c)]
        if c["bang"]:
            bang, _, _ = step_and_specs(cfg, ShapeSpec("long_500k", "decode", s_max, B), mesh)
            cb = params["bangkv_codebooks"]
            ssm_c, kv = clone_caches(start_c)
            codes = torch.stack([bkv.encode_keys(cb[i], kv.k[i]) for i in range(kv.k.shape[0])])
            runs.append(("bang", bang, (ssm_c, bkv.BangKVCache(codes, kv.k, kv.v, kv.index))))
        for kind, step, st in runs:
            tok = first
            ids.clear()
            for s in range(c["steps"]):
                res[f"{at}{kind}/tokens_{s}"] = whole(tok, mesh, cut)
                logits, st = step(params, st, tok)
                res[f"{at}{kind}/logits_{s}"] = whole(logits, mesh, cut)
                tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            full = gather_caches(st, mesh, s_max=s_max, batch_divisible=cut, cfg=cfg)
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


def _hold_window(got, want, what):
    """The prefill's conv window holds the projections rounded to bf16
    (ROADMAP C14): an entry whose float32 projection the mesh's summation
    orders (C18) move across a bf16 rounding boundary lands one bf16 ulp
    from the reference's, as the plain path's do (1 to 3 of these 7,680).
    Every other entry within rtol 1e-5, atol 1e-6; those at most 1 in
    1,000."""
    want = want.astype(np.float32)
    d = np.abs(got - want)
    off = d > ATOL + RTOL * np.abs(want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    step = d[off] / ulp[off]   # 1, or 1/2 for the neighbour below a power of two
    assert np.all((step == 1) | (step == 0.5)) and off.sum() <= 1e-3 * d.size, (
        what, int(off.sum()), d.max())


def _hold_caches(got: dict, prefix: str, want: dict, what: str) -> None:
    assert {k for k in got if k.startswith(prefix)} == {prefix + f for f in want}, what
    for f, w in want.items():
        g = got[prefix + f]
        assert g.shape == w.shape, (what, f, g.shape, w.shape)
        if f in ("index", "codes"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")
        elif f == "conv" and what == "prefill":
            _hold_window(g, w, what)
        else:
            _close(g, w.astype(np.float32), f"{what} {f}")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_ssm_train_step_matches_reference(runs, mesh, case):
    """2 training steps: the loss, the gathered gradients of the first step
    and the gathered parameters after each step against the reference's
    one-device steps."""
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
def test_mesh_ssm_prefill_and_decode_match_reference(runs, mesh, case):
    """The prefill's last-position logits and gathered caches, then 4 greedy
    exact-KV steps (and for zamba2 4 greedy BANG-KV steps with the
    hierarchical top-L): logits at every step, the caches after them, the
    tokens, the codes and the top-L ids against the reference's one-device
    path."""
    ref, out = runs
    got, want = out[mesh], ref[case]
    assert min(want["margins"]) > MARGIN   # no near tie in the greedy draw
    _close(got[f"{case}/prefill"], want["prefill"], "prefill logits")
    _hold_caches(got, f"{case}/prefill_", want["prefill_caches"], "prefill")
    kinds = ("exact", "bang") if CASES[case][5] else ("exact",)
    for kind in kinds:
        for s in range(STEPS):
            np.testing.assert_array_equal(got[f"{case}/{kind}/tokens_{s}"], want[f"{kind}/tokens_{s}"])
            _close(got[f"{case}/{kind}/logits_{s}"], want[f"{kind}/logits_{s}"], f"{kind} step {s}")
        _hold_caches(got, f"{case}/{kind}/cache/", want[f"{kind}/caches"], kind)
        n_gather, n_reduce = got[f"{case}/{kind}/counts"]
        assert n_gather > 0 and n_reduce > 0
    if "bang" in kinds:
        np.testing.assert_array_equal(got[f"{case}/bang/ids"], want["bang/ids"])


# (in_proj's columns, conv channels, heads, di cut over `model`; the batch cut over `data`)
LAYOUTS = {
    ("mamba", (2, 1)): (True, True, True, True, True),
    ("uneven", (2, 1)): (True, True, True, True, False),
    ("uneven", (1, 2)): (True, True, True, True, True),
    ("uneven", (2, 2)): (True, True, True, True, False),
    ("uneven", (1, 4)): (False, True, False, True, True),
}


@pytest.mark.parametrize("mesh", MESHES)
def test_widths_are_released_leaf_by_leaf(runs, mesh):
    """Each width is cut where it divides the `model` ranks and whole where
    it does not, independently of the others (on (1, 4) the uneven case's
    heads and in_proj columns are whole, its conv channels and di cut),
    and the prefill's caches are this rank's blocks: its channels of the
    conv window, its heads of the state, its sequence of zamba2's KV."""
    _, out = runs
    got = out[mesh]
    D, M = mesh
    for case in CASES:
        cfg = _cfgs(case)[1]
        want = LAYOUTS.get((case, mesh), (True,) * 4 + (CASES[case][3] % D == 0,))
        assert tuple(got[f"{case}/layout"]) == want, case
        di = cfg.ssm_expand * cfg.d_model
        ch, H = di + 2 * cfg.ssm_groups * cfg.ssm_state, di // cfg.ssm_head_dim
        B = CASES[case][3] // (D if want[4] else 1)
        assert tuple(got[f"{case}/shape/conv"]) == (
            cfg.n_layers, B, cfg.ssm_conv - 1, ch // M if want[1] else ch)
        assert tuple(got[f"{case}/shape/state"]) == (
            cfg.n_layers, B, H // M if want[2] else H, cfg.ssm_head_dim, cfg.ssm_state)
        if cfg.family == "hybrid":
            assert got[f"{case}/shape/k"][2] == (CASES[case][2] + STEPS) // M


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


ONE_RANK = [(MAMBA, "float32"), (ZAMBA, "float32"), (MAMBA, "bfloat16")]


@pytest.mark.parametrize("name,dtype", ONE_RANK)
def test_one_rank_ssm_train_step_is_bit_equal_to_the_plain_step(one_rank, name, dtype):
    """On a (1, 1) mesh every collective is a copy and the Mamba2 block
    takes the plain path's operations (the gated norm's mean written out
    on both): three steps give the plain step's losses and parameters bit
    for bit."""
    cfg = configs.get(name).reduced(dtype=dtype)
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


@pytest.mark.parametrize("name,dtype", ONE_RANK)
def test_one_rank_ssm_serve_is_bit_equal_to_the_plain_path(one_rank, name, dtype):
    """On a (1, 1) mesh the prefill's logits and caches and 4 decode steps'
    logits and caches (zamba2: exact-KV and BANG-KV with the hierarchical
    top-L) are the plain path's bit for bit."""
    cfg = configs.get(name).reduced(dtype=dtype, opt_hier_topk=True)
    B, S = 2, 24
    s_max = S + STEPS
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S + STEPS), generator=torch.Generator().manual_seed(2))
    prefill, _, (p_place, b_place) = step_and_specs(cfg, ShapeSpec("p", "prefill", S, B), one_rank)
    serve, _, _ = step_and_specs(cfg, ShapeSpec("d", "decode", s_max, B), one_rank)
    bang, _, _ = step_and_specs(cfg, ShapeSpec("long_500k", "decode", s_max, B), one_rank)
    mesh_params = shard_tree(params, p_place, one_rank)
    lm = LM(cfg, params)
    got, caches = prefill(mesh_params, shard_tree({"tokens": toks[:, :S]}, b_place, one_rank),
                          s_max=s_max)
    want, plain = lm.prefill({"tokens": toks[:, :S]}, s_max=s_max)
    leaves = lambda c: list(_fields(c).values())   # noqa: E731
    assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(leaves(caches), leaves(plain)))
    runs = [(serve, caches, plain, False)]
    if cfg.family == "hybrid":
        cb = params["bangkv_codebooks"]
        ssm_c, kv = clone_caches(plain)
        codes = torch.stack([bkv.encode_keys(cb[i], kv.k[i]) for i in range(kv.k.shape[0])])
        plain_bang = (ssm_c, bkv.BangKVCache(codes, kv.k, kv.v, kv.index))
        mesh_bang = shard_caches(clone_caches(plain_bang), one_rank, batch_divisible=True)
        runs.append((bang, mesh_bang, plain_bang, True))
    for step, mesh_c, plain_c, bangkv in runs:
        for s in range(STEPS):
            tok = toks[:, S + s:S + s + 1]
            got, mesh_c = step(mesh_params, mesh_c, tok)
            want, plain_c = lm.decode_step(plain_c, tok, bangkv=bangkv)
            assert torch.equal(got, want), (bangkv, s)
        assert all(torch.equal(x, y) for x, y in zip(leaves(mesh_c), leaves(plain_c)))
    counts = serve.mesh_context.counts
    assert counts["all_gather"] > 0 and counts["all_reduce"] > 0

