"""Prefill and decode on a mesh, held against the reference's one-device
serve path.

`launch.specs.step_and_specs` binds the port's prefill and decode steps
for the dense and vlm families (and moe: tests/test_torch_mesh_moe.py,
ssm and hybrid: tests/test_torch_mesh_ssm.py; their placements are held
here too): each rank holds its blocks of the
parameters (FSDP over `data`, Megatron TP over `model`), its slice of the
batch, and its blocks of the decode caches (`cache_pspecs`: the sequence
cut over `model`, the batch over `data`). Its ranks run in subprocesses
(one a rank, a file store, JAX and the reference blocked), all cases of a
world size in one launch: 2 ranks on meshes (2, 1) and (1, 2), 4 on (2, 2)
and (1, 4). The cases are the reduced glm4-9b at the `GLM` widths (d_model
128, 8 heads, 2 KV heads, vocabulary 512; the head untied), the reduced
internvl2-1b (vlm, its patches prepended) and the reduced gemma3-27b (its
sliding window of 16 over caches cut into blocks of 30 and 15 positions),
all float32 with `opt_hier_topk` on. Each prefills a prompt, then decodes
4 greedy exact-KV steps and, from the prompt's state with every slot
encoded by the codebooks, 4 greedy BANG-KV steps whose top-L is the
hierarchical one (each rank's top-L of its block, then the global top-L
of the gathered candidates). The reference runs the same parameters
(`convert.lm_params_from_reference`) and inputs (numpy seeds) here, its
top-L ids of each layer read by a host callback.

Bounds: logits within rtol 1e-5, atol 1e-6 of the reference's at every
step, the gathered caches within the same (the row-parallel all-reduces
and the softmax's sums cross ranks, ROADMAP C18); the cache `index`, the
greedy tokens, the BANG-KV codes and the top-L ids of every layer and step
equal (the draw has no near ties: the reference's top two logits of every
step are 1e-4 apart, ROADMAP C11). On the data-only mesh (2, 1) no sum
crosses ranks: the gathered prefill caches equal the port's plain ones bit
for bit. On a one-rank gloo group in this process the mesh steps are
bit-equal to the plain `LM.prefill` and `LM.decode_step`.
"""
import dataclasses
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
from repro.compat import abstract_mesh
from repro.configs.base import LM_SHAPES as R_LM_SHAPES
from repro.launch import specs as rspecs
from repro.models import retrieval_attention as rbkv
from repro.models.transformer import LM as RLM
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.configs.base import LM_SHAPES, ShapeSpec
from repro_torch.distributed import AbstractMesh, make_mesh, shard_caches, shard_tree
from repro_torch.launch.specs import step_and_specs
from repro_torch.models import LM, init_params
from repro_torch.models import retrieval_attention as bkv
from repro_torch.tree import flat_dict, flatten_with_path, path_key

from _lm_parity import bang_from_kv, pad_kv

SRC = Path(__file__).resolve().parents[1] / "src"
KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6
MARGIN = 1e-4          # the reference's top two logits of a greedy step at least this far apart
STEPS = 4
GLM = dict(d_model=128, n_heads=8, n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512)
# case -> (arch, overrides of the reduced config, prompt tokens, requests,
# seed). The caches hold the prompt (and a vlm's 4 patches) and the 4
# steps: 60 positions, blocks of 30 on `model` 2 and of 15 on `model` 4.
# "whole" keeps what does not divide whole: 61 positions on every `model`
# rank (its first counts them), 3 requests on every `data` rank.
CASES = {
    "glm4": ("glm4-9b", GLM, 56, 4, 1),
    "vlm": ("internvl2-1b", {}, 52, 4, 2),
    "gemma3": ("gemma3-27b", {}, 56, 4, 3),
    "whole": ("glm4-9b", GLM, 57, 3, 4),
}
MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]


def _cfgs(case, **extra):
    arch, over = CASES[case][:2]
    over = dict(over, opt_hier_topk=True, **extra)
    return (rconfigs.get(arch).reduced(dtype="float32", **over),
            configs.get(arch).reduced(dtype="float32", **over))


def _inputs(cfg, case) -> dict:
    _, _, S, B, seed = CASES[case]
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["frontend"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def _s_all(cfg, case) -> int:
    return CASES[case][2] + cfg.frontend_len


def _port_flat(tree, cfg) -> dict:
    return {k: v.detach().numpy() for k, v in flat_dict(convert.lm_params_from_reference(
        jax.tree.map(np.asarray, tree), cfg, device="cpu")).items()}


def _argmax(logits) -> np.ndarray:
    return np.asarray(logits)[:, 0].argmax(-1)[:, None].astype(np.int32)


def _margin(logits) -> float:
    top = np.sort(np.asarray(logits)[:, 0], axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


def _reference_run(case) -> dict:
    """The reference's jitted prefill, 4 greedy exact steps, then 4 greedy
    BANG-KV steps from the prompt's state with every slot encoded, the
    top-L ids of each layer read as they are taken (an ordered host
    callback in the traced selection)."""
    rcfg, cfg = _cfgs(case)
    rlm = RLM(rcfg)
    params = rlm.init(KEY)
    batch = _inputs(cfg, case)
    s_all = _s_all(cfg, case)
    out = {"params": _port_flat(params, cfg), "batch": batch, "margins": []}
    logits, caches = jax.jit(rlm.prefill)(params, jax.tree.map(jnp.asarray, batch))
    out["prefill"] = np.asarray(logits)
    caches = pad_kv(caches, STEPS)
    out["prefill_k"], out["prefill_v"] = np.asarray(caches.k), np.asarray(caches.v)
    first = _argmax(logits)
    out["margins"].append(_margin(logits))
    for kind, state in (("exact", caches), ("bang", bang_from_kv(params["bangkv_codebooks"], caches))):
        tok, ids = first, []
        taken = rbkv._retrieve_top_l

        def recording(*args, **kwargs):
            top = taken(*args, **kwargs)
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
            rbkv._retrieve_top_l = taken
        for name in state._fields:
            out[f"{kind}/cache_{name}"] = np.asarray(getattr(state, name))
        if kind == "bang":
            out["bang/ids"] = np.stack(ids)          # (steps x layers, B, H, L)
    assert s_all + STEPS == out["prefill_k"].shape[2]
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference run, its parameters and inputs saved for the
    ranks."""
    work = tmp_path_factory.mktemp("mesh_serve")
    ref = {}
    for case in CASES:
        ref[case] = _reference_run(case)
        np.savez(work / f"params_{case}.npz", **ref[case]["params"])
        np.savez(work / f"batch_{case}.npz", **ref[case]["batch"])
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
from repro_torch.distributed import P, gather_caches, gather_tensor, make_mesh, shard_tree
from repro_torch.launch.specs import param_specs, step_and_specs
from repro_torch.models import LM
from repro_torch.models import retrieval_attention as bkv
from repro_torch.models.transformer import clone_caches
from repro_torch.tree import flatten_with_path, path_key, unflatten

taken, ids = bkv._retrieve_top_l, []


def recording(*args, **kwargs):
    top = taken(*args, **kwargs)
    ids.append(top)
    return top


bkv._retrieve_top_l = recording


def full_params(cfg, name):
    arrays = np.load(f"{work}/params_{name}.npz")
    template = param_specs(cfg)
    return unflatten(template, [torch.from_numpy(arrays[path_key(p)]) for p, _ in flatten_with_path(template)])


def whole(x, mesh, cut):
    # This rank's requests' rows gathered over `data` where the batch is cut.
    return gather_tensor(x, P("data" if cut else None), mesh).numpy()


res = {}
for D, S, cases in jobs:
    mesh = make_mesh((D, S), ("data", "model"), "cpu")
    for case, c in cases.items():
        at = f"{D}x{S}/{case}/"
        cfg = dataclasses.replace(configs.get(c["arch"]).reduced(dtype="float32", **c["over"]),
                                  opt_hier_topk=c["hier"])
        name = c["inputs"]
        B, s_all, steps = c["batch"], c["s_all"], c["steps"]
        s_max = s_all + steps
        cut = B % D == 0
        prefill, _, (p_place, b_place) = step_and_specs(cfg, ShapeSpec("p", "prefill", s_all, B), mesh)
        serve, _, _ = step_and_specs(cfg, ShapeSpec("d", "decode", s_max, B), mesh)
        bang, _, _ = step_and_specs(cfg, ShapeSpec("long_500k", "decode", s_max, B), mesh)
        params = shard_tree(full_params(cfg, name), p_place, mesh)
        batch = {k: torch.from_numpy(v) for k, v in np.load(f"{work}/batch_{name}.npz").items()}
        logits, caches = prefill(params, shard_tree(batch, b_place, mesh), s_max=s_max)
        res[at + "prefill"] = whole(logits, mesh, cut)
        full = gather_caches(caches, mesh, s_max=s_max, batch_divisible=cut)
        res[at + "prefill_k"], res[at + "prefill_v"] = full.k.numpy(), full.v.numpy()
        res[at + "prefill_index"] = full.index.numpy()
        res[at + "block"] = np.array(caches.k.shape)
        zero = LM(cfg, params).init_decode_caches(B, s_max, bangkv=True, fill=s_all,
                                                  mesh=serve.mesh_context)
        res[at + "init_block"] = np.array([*zero.codes.shape, *zero.k.shape, int(zero.index[0])])
        first = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        cb = params["bangkv_codebooks"]
        state = clone_caches(caches)
        codes = torch.stack([bkv.encode_keys(cb[i], state.k[i]) for i in range(cfg.n_layers)])
        runs = (("exact", serve, caches), ("bang", bang, bkv.BangKVCache(codes, *state[:2], state.index)))
        for kind, step, st in runs:
            tok = first
            ids.clear()
            for s in range(steps):
                res[f"{at}{kind}/tokens_{s}"] = whole(tok, mesh, cut)
                logits, st = step(params, st, tok)
                res[f"{at}{kind}/logits_{s}"] = whole(logits, mesh, cut)
                tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            full = gather_caches(st, mesh, s_max=s_max, batch_divisible=cut)
            for field in full._fields:
                res[f"{at}{kind}/cache_{field}"] = getattr(full, field).numpy()
            if kind == "bang":
                res[at + "bang/ids"] = np.stack([whole(t, mesh, cut) for t in ids])
            res[f"{at}{kind}/counts"] = np.array(
                [step.mesh_context.counts[k] for k in ("all_gather", "all_reduce")])
        if c.get("fit"):   # codebooks fitted on the mesh against one device's fit of the whole cache
            mc = serve.mesh_context
            seq = mc.seq_block(s_max)
            cbs, fitted = bkv.fit_bangkv_caches(caches, s_all, cfg.bangkv_m, iters=3, seq=seq,
                                                batch_cut=cut)
            whole_caches = gather_caches(caches, mesh, s_max=s_max, batch_divisible=cut)
            want_cbs, want = bkv.fit_bangkv_caches(whole_caches, s_all, cfg.bangkv_m, iters=3)
            codes = gather_caches(fitted, mesh, s_max=s_max, batch_divisible=cut).codes
            res[at + "fit_equal"] = np.array([torch.equal(cbs, want_cbs), torch.equal(codes, want.codes)])
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


def _case_args(case: str, ref: dict, hier: bool = True) -> dict:
    arch, over, _, B, _ = CASES[case]
    s_all = ref["prefill_k"].shape[2] - STEPS
    return dict(arch=arch, over=over, batch=B, steps=STEPS, s_all=s_all, inputs=case, hier=hier,
                fit=case == "glm4")


@pytest.fixture(scope="module")
def runs(reference):
    """Two launches: two ranks on (2, 1) and (1, 2), four on (2, 2) and
    (1, 4), every case on each mesh, and on (1, 4) glm4 with the flat
    top-L too ("glm4_flat"). Returns {mesh: {case/key: array}}."""
    work, ref = reference
    jobs = {w: [(D, S, {case: _case_args(case, ref[case]) for case in CASES})
                for D, S in MESHES if D * S == w] for w in (2, 4)}
    jobs[4][-1][2]["glm4_flat"] = _case_args("glm4", ref["glm4"], hier=False)
    merged = {**_launch(work, 2, jobs[2]), **_launch(work, 4, jobs[4])}
    out = {}
    for key, v in merged.items():
        mesh, rest = key.split("/", 1)
        out.setdefault(tuple(int(n) for n in mesh.split("x")), {})[rest] = v
    return ref, out


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_prefill_and_decode_match_reference(runs, mesh, case):
    """The last position's logits and the gathered caches of the prefill,
    then 4 greedy exact-KV and 4 greedy BANG-KV (hierarchical top-L) steps:
    logits at every step, the caches after them, the tokens, the codes and
    every layer's top-L ids against the reference's one-device path."""
    ref, out = runs
    _hold(out[mesh], case, ref[case], mesh)


def test_flat_top_l_on_a_mesh_matches_reference(runs):
    """Without `opt_hier_topk` each rank's block of the BANG-KV scores is
    gathered over `model` and the top-L taken flat: on (1, 4) the reduced
    glm4-9b matches the reference as the hierarchical selection does."""
    ref, out = runs
    assert out[(1, 4)]["glm4_flat/bang/counts"][0] < out[(1, 4)]["glm4/bang/counts"][0]
    _hold(out[(1, 4)], "glm4_flat", ref["glm4"], (1, 4))


def _hold(got: dict, case: str, want: dict, mesh: tuple) -> None:
    assert min(want["margins"]) > MARGIN   # no near tie in the greedy draw
    (D, M), (L, B, s_max) = mesh, want["prefill_k"].shape[:3]
    block = (L, B // D if B % D == 0 else B, s_max // M if s_max % M == 0 else s_max)
    assert tuple(got[f"{case}/block"]) == (*block, *want["prefill_k"].shape[3:])
    m = want["bang/cache_codes"].shape[-1]   # `init_decode_caches` makes blocks of that shape
    assert tuple(got[f"{case}/init_block"]) == (*block, want["prefill_k"].shape[3], m, *block,
                                                *want["prefill_k"].shape[3:], s_max - STEPS)
    _close(got[f"{case}/prefill"], want["prefill"], "prefill logits")
    _close(got[f"{case}/prefill_k"], want["prefill_k"], "prefill K")
    _close(got[f"{case}/prefill_v"], want["prefill_v"], "prefill V")
    assert np.all(got[f"{case}/prefill_index"] == s_max - STEPS)
    for kind in ("exact", "bang"):
        for s in range(STEPS):
            np.testing.assert_array_equal(got[f"{case}/{kind}/tokens_{s}"], want[f"{kind}/tokens_{s}"])
            _close(got[f"{case}/{kind}/logits_{s}"], want[f"{kind}/logits_{s}"], f"{kind} step {s}")
        for field in ("k", "v"):
            _close(got[f"{case}/{kind}/cache_{field}"], want[f"{kind}/cache_{field}"], f"{kind} {field}")
        assert np.all(got[f"{case}/{kind}/cache_index"] == s_max)
        n_gather, n_reduce = got[f"{case}/{kind}/counts"]
        assert n_gather > 0 and n_reduce > 0
    np.testing.assert_array_equal(got[f"{case}/bang/cache_codes"], want["bang/cache_codes"])
    np.testing.assert_array_equal(got[f"{case}/bang/ids"], want["bang/ids"])


def test_data_only_mesh_caches_are_the_plain_caches(runs):
    """On (2, 1) no sum crosses ranks: each data rank prefills its requests
    with whole weights, and the gathered caches equal the port's plain
    prefill's bit for bit."""
    ref, out = runs
    for case in CASES:
        _, cfg = _cfgs(case)
        lm = LM(cfg, _params_from_flat(cfg, ref[case]["params"]))
        batch = {k: torch.from_numpy(v) for k, v in ref[case]["batch"].items()}
        _, caches = lm.prefill(batch, s_max=ref[case]["prefill_k"].shape[2])
        got = out[(2, 1)]
        np.testing.assert_array_equal(got[f"{case}/prefill_k"], caches.k.numpy())
        np.testing.assert_array_equal(got[f"{case}/prefill_v"], caches.v.numpy())


def _params_from_flat(cfg, flat: dict):
    from repro_torch.launch.specs import param_specs
    from repro_torch.tree import unflatten

    template = param_specs(cfg)
    return unflatten(template, [torch.from_numpy(flat[path_key(p)]) for p, _ in flatten_with_path(template)])


@pytest.mark.parametrize("mesh", MESHES)
def test_codebooks_fitted_on_a_mesh_are_one_devices(runs, mesh):
    """`fit_bangkv_caches` on the mesh gathers each layer's keys from every
    rank: the codebooks equal one device's fit of the whole cache bit for
    bit, on every rank, and the codes each rank encodes are its block of
    that fit's."""
    _, out = runs
    assert out[mesh]["glm4/fit_equal"].tolist() == [True, True]


@pytest.mark.parametrize("M,top_l", [(2, 4), (3, 8), (4, 8), (4, 12)])
def test_hierarchical_top_l_is_the_flat_selection(M, top_l):
    """Each of M blocks' top-L (`_local_top_l`), laid out block after block,
    then the global top-L (`_merge_top_l`), gives the flat selection's ids
    exactly, on scores full of ties: -inf outside the retrieval region and
    repeated finite values, a block of 10 shorter than L = 12 included."""
    rng = np.random.default_rng(M * 100 + top_l)
    n = 10
    a = rng.integers(-3, 4, (2, 3, M * n)).astype(np.float32)   # exact ties
    a[rng.random(a.shape) < 0.4] = -np.inf
    a[0, 0, :] = -np.inf                                         # a row of -inf only
    approx = torch.from_numpy(a)
    flat = bkv._retrieve_top_l(approx, top_l)
    blocks = [bkv._local_top_l(approx[..., r * n:(r + 1) * n], top_l, r * n) for r in range(M)]
    vals = torch.cat([v for v, _ in blocks], -1)
    ids = torch.cat([i for _, i in blocks], -1)
    assert torch.equal(bkv._merge_top_l(vals, ids, top_l), flat)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(a), top_l)[1]))


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


@pytest.mark.parametrize("name,dtype,over", [("glm4-9b", "float32", GLM), ("internvl2-1b", "float32", {}),
                                             ("gemma3-27b", "float32", {}), ("granite-3-2b", "bfloat16", {})])
def test_one_rank_mesh_serve_is_bit_equal_to_the_plain_path(one_rank, name, dtype, over):
    """On a (1, 1) mesh every collective is a copy, the decode's softmax
    takes the plain path's operations and the hierarchical top-L over one
    block is the flat one: the prefill's logits and caches, 4 exact-KV and
    4 BANG-KV steps' logits and caches are the plain path's bit for bit
    (granite's odd vocabulary runs its head whole)."""
    cfg = configs.get(name).reduced(dtype=dtype, opt_hier_topk=True, **over)
    B, S = 2, 24
    S_all = S + cfg.frontend_len
    s_max = S_all + STEPS
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 2 * STEPS), generator=g)
    batch = {"tokens": toks[:, :S]}
    if cfg.frontend_len:
        batch["frontend"] = torch.randn(B, cfg.frontend_len, cfg.d_model, generator=g)
    prefill, _, (p_place, b_place) = step_and_specs(cfg, ShapeSpec("p", "prefill", S_all, B), one_rank)
    serve, _, _ = step_and_specs(cfg, ShapeSpec("d", "decode", s_max, B), one_rank)
    bang, _, _ = step_and_specs(cfg, ShapeSpec("long_500k", "decode", s_max, B), one_rank)
    mesh_params = shard_tree(params, p_place, one_rank)
    lm = LM(cfg, params)
    got, caches = prefill(mesh_params, shard_tree(batch, b_place, one_rank), s_max=s_max)
    want, plain = lm.prefill(batch, s_max=s_max)
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
    assert bang.mesh_context.counts["all_gather"] > counts["all_gather"]   # the top-L's candidates


SPEC_MESHES = {
    "16x16": (("data", 16), ("model", 16)),
    "2x16x16": (("pod", 2), ("data", 16), ("model", 16)),
    "2x2": (("data", 2), ("model", 2)),
}
SERVE_ARCHS = sorted(configs.ARCHS)


def _spec_leaves(tree) -> list:
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _per_layer(ref_specs, cfg) -> list:
    """The reference's parameter specs in the port's order, a stacked
    layer's leading None dropped (the port keeps one tensor a layer; the
    decoder's and whisper's encoder's stacks)."""
    from repro.distributed import partitioning as rpart

    flat, _ = jax.tree_util.tree_flatten_with_path(
        ref_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    ref = {"/".join(rpart._key_str(p) for p in path): tuple(s) for path, s in flat}
    out = {}
    for key, spec in ref.items():
        stack = next((s for s in ("layers/", "encoder/layers/") if key.startswith(s)), None)
        if stack is None:
            out[key] = spec
            continue
        n = cfg.n_layers if stack == "layers/" else cfg.n_encoder_layers
        for i in range(n):
            out[key.replace(stack, f"{stack}{i}/", 1)] = spec[1:]
    return out


@pytest.mark.parametrize("mesh_name", sorted(SPEC_MESHES))
@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_serve_placements_match_reference(name, mesh_name):
    """`step_and_specs`'s prefill (prefill_32k) and decode (decode_32k, and
    long_500k with BANG-KV) placements equal the reference's on shape-only
    meshes: parameters, the batch, the caches (the batch-divisibility rule
    included) and the tokens; the meta caches have the reference's shapes;
    the steps run on a runnable mesh only."""
    jmesh, mesh = abstract_mesh(SPEC_MESHES[mesh_name]), AbstractMesh(dict(SPEC_MESHES[mesh_name]))
    rcfg, cfg = rconfigs.get(name), configs.get(name)
    for shape_name in ("prefill_32k", "decode_32k", "long_500k"):
        shape, rshape = LM_SHAPES[shape_name], R_LM_SHAPES[shape_name]
        step, specs, place = step_and_specs(cfg, shape, mesh)
        _, rspecs_, rplace = rspecs.step_and_specs(rcfg, rshape, jmesh)
        params = {path_key(p): s for p, s in flatten_with_path(place[0])}
        assert params == _per_layer(rplace[0], cfg), shape_name
        if shape.kind == "prefill":
            assert {k: v for k, v in place[1].items()} == {k: tuple(v) for k, v in rplace[1].items()}
        else:
            assert [s for _, s in flatten_with_path(place[1])] == _spec_leaves(rplace[1]), shape_name
            assert [tuple(x.shape) for _, x in flatten_with_path(specs[1])] == [
                tuple(x.shape) for x in jax.tree_util.tree_leaves(rspecs_[1])]
            assert place[2] == tuple(rplace[2]) and tuple(specs[2].shape) == rspecs_[2].shape
            assert step.bangkv == rspecs.uses_bangkv(rcfg, rshape) == (
                shape_name == "long_500k" and cfg.family != "ssm")
        with pytest.raises(TypeError, match="runnable"):
            step(None, None, None)


@pytest.mark.parametrize("name", ["whisper-medium"])
def test_other_families_refuse_to_serve_on_a_mesh(name):
    """The encdec family's prefill and decode placements on a shape-only
    (2, 2) mesh, for prefill_32k, decode_32k and long_500k: `cross/wq` FSDP
    over `data` and Megatron TP over `model`, the table of 51,865 rows
    whole over `model`; the prefill's frames over `data`; the self caches'
    sequence over `model`, the cross K and V (L, B, 1,500, Hkv, hd) over
    the batch on `data` only (whole where long_500k's one request does not
    divide it); the steps refuse to run on that mesh. Its steps on
    runnable meshes: tests/test_torch_mesh_encdec.py."""
    cfg = configs.get(name)
    mesh = AbstractMesh({"data": 2, "model": 2})
    for shape_name in ("prefill_32k", "decode_32k", "long_500k"):
        _whisper_placements(cfg, shape_name, mesh)


def _whisper_placements(cfg, shape_name: str, mesh) -> None:
    shape = LM_SHAPES[shape_name]
    step, specs, place = step_and_specs(cfg, shape, mesh)
    assert place[0]["layers"][0]["cross"]["wq"] == ("data", "model")
    assert place[0]["embed"] == (None, "data")
    if shape.kind == "prefill":
        assert place[1]["frontend"] == ("data", None, None)
        assert tuple(specs[1]["frontend"].shape) == (shape.global_batch, cfg.frontend_len, cfg.d_model)
    else:
        own, cross = place[1]
        bspec = "data" if shape.global_batch % 2 == 0 else None
        assert own.k == own.v == (None, bspec, "model", None, None)
        assert list(cross) == [(None, bspec, None, None, None)] * 2
        assert tuple(specs[1][1][0].shape) == (cfg.n_layers, shape.global_batch, cfg.frontend_len,
                                               cfg.n_kv_heads, cfg.head_dim)
        assert step.bangkv == (shape_name == "long_500k")
    with pytest.raises(TypeError, match="runnable"):
        step(None, None, None)
