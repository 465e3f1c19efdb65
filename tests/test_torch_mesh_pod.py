"""The mesh steps and the sharded search on a ("pod", "data", "model")
mesh, held against the reference's one-device paths.

A (P, D, S) mesh places rank r at pod r // (D S), data (r // S) % D and
model r % S. `pod` is pure data parallelism: the weights are whole over
it, the FSDP gathers stay over `data`, the batch is cut over pod x data,
and every batch-wide sum (the loss, every gradient, the MoE's counts and
auxiliary sums) runs over the pod x data group.

One launch of 4 gloo ranks (subprocesses, JAX and the reference blocked)
runs two meshes in one process group, (2, 1, 2) and (2, 2, 1), and on
each the reduced configs at float32 cut to 2 layers:

  * "granite": granite-3-2b, 4 requests of 16 tokens;
  * "phi_drop": phi3.5-moe (4 experts, top-2) at capacity factor 0.5, 4
    requests of 24 tokens: T = 96, C = 24 against about 48 assignments an
    expert, so assignments are dropped, and the slots of a batch rank
    start after those of the ranks before it across the pods;

2 training steps, a prefill and 2 greedy exact-KV decode steps, each
against the reference's jitted one-device steps on the same parameters
and inputs. Bounds (ROADMAP C15, C18): losses and the MoE's metrics
within rtol 1e-5; gradients within rtol 1e-4, atol 1e-5; parameters
within 2e-6 save 1 in 1,000 entries, within 2 lr a step; logits and
gathered caches within rtol 1e-5, atol 1e-6; greedy tokens, the cache
index and every layer's dropped fraction equal. On each mesh the sharded
search (`core.distributed.make_sharded_search`, the queries over pod x
data) over the shared `small_ann_index` gives the reference executor's
ids.

A fifth process of the same launch runs the same cells shape-only on a
fake group of 4 ranks (`launch.dryrun`); its collective counts, kind by
kind, equal the gloo ranks' for each step, and the shape-only search's
seed, hop and re-rank add up to the gloo search's collectives and bytes.
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
from repro.data import uniform_queries
from repro.models import transformer as rtransformer
from repro.models.transformer import LM as RLM
from repro.optim import adamw_init as radamw_init
from repro.optim import adamw_update as radamw_update
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.launch.specs import LR
from repro_torch.tree import flat_dict

from _lm_parity import pad_kv

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

SRC = Path(__file__).resolve().parents[1] / "src"
KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6
MARGIN = 1e-4          # the reference's top two logits of a greedy step at least this far apart
STEPS, TRAIN_STEPS = 2, 2
# case -> (arch, overrides of the reduced config, tokens a request, requests, seed)
CASES = {
    "granite": ("granite-3-2b", dict(n_layers=2), 16, 4, 1),
    "phi_drop": ("phi3.5-moe-42b-a6.6b", dict(n_layers=2, capacity_factor=0.5), 24, 4, 2),
}
MESHES = [(2, 1, 2), (2, 2, 1)]
METRICS = ("ce", "load_balance", "router_z", "dropped_frac")
ANN_K, ANN_T, ANN_QUERIES = 5, 32, 12


def _cfgs(case):
    arch, over = CASES[case][:2]
    return rconfigs.get(arch).reduced(dtype="float32", **over), configs.get(arch).reduced(dtype="float32", **over)


def _inputs(cfg, case) -> dict:
    _, _, S, B, seed = CASES[case]
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


class _Drops:
    """The reference's per-layer dropped fractions, read by ordered host
    callbacks as the traced MoE layers take them."""

    def __enter__(self):
        self.drops, self.moe = [], rtransformer.moe_block

        def moe_block(*args, **kwargs):
            y, aux = self.moe(*args, **kwargs)
            jax.debug.callback(lambda d: self.drops.append(float(d)), aux.dropped_frac, ordered=True)
            return y, aux

        rtransformer.moe_block = moe_block
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        rtransformer.moe_block = self.moe


def _reference_run(case) -> dict:
    """The reference's training steps, then its prefill and greedy
    exact-KV steps from the initial parameters."""
    rcfg, cfg = _cfgs(case)
    rlm = RLM(rcfg)
    params = rlm.init(KEY)
    inputs = _inputs(cfg, case)
    out = {"params": _port_flat(params, cfg), "inputs": inputs, "margins": []}
    vg = jax.jit(jax.value_and_grad(lambda p, b: rlm.loss(p, b), has_aux=True))
    upd = jax.jit(lambda g, s, p: radamw_update(g, s, p, LR))
    state, trained = radamw_init(params), params
    for s in range(TRAIN_STEPS):
        batch = {"tokens": jnp.asarray(inputs[f"tokens_{s}"]), "labels": jnp.asarray(inputs[f"labels_{s}"])}
        (loss, metrics), grads = vg(trained, batch)
        if s == 0:
            out["grads"] = _port_flat(grads, cfg)
        trained, state, _ = upd(grads, state, trained)
        out[f"loss_{s}"] = float(loss)
        for k in METRICS:
            if k in metrics:
                out[f"{k}_{s}"] = float(metrics[k])
        out[f"params_{s}"] = _port_flat(trained, cfg)
    with _Drops() as rec:
        logits, caches = jax.jit(rlm.prefill)(params, {"tokens": jnp.asarray(inputs["prompt"])})
        jax.effects_barrier()
    out["prefill"], out["prefill_drops"] = np.asarray(logits), np.array(rec.drops)
    caches = pad_kv(caches, STEPS)
    out["prefill_k"], out["prefill_v"] = np.asarray(caches.k), np.asarray(caches.v)
    out["margins"].append(_margin(logits))
    tok = _argmax(logits)
    step = jax.jit(lambda p, c, t: rlm.decode_step(p, c, t))
    with _Drops() as rec:
        for s in range(STEPS):
            logits, caches = step(params, caches, jnp.asarray(tok))
            out[f"logits_{s}"], out[f"tokens_{s}"] = np.asarray(logits), tok
            out["margins"].append(_margin(logits))
            tok = _argmax(logits)
    out["decode_drops"] = np.array(rec.drops)
    out["cache_k"], out["cache_v"] = np.asarray(caches.k), np.asarray(caches.v)
    return out


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
from repro_torch.convert import index_from_reference
from repro_torch.core import SearchConfig
from repro_torch.core.distributed import local_rows, make_sharded_search
from repro_torch.distributed import POD_AXES, P, gather_caches, gather_tensor, gather_tree, make_mesh, shard_tree
from repro_torch.launch.dryrun import CollectiveMode
from repro_torch.launch.specs import param_specs, step_and_specs
from repro_torch.models import transformer
from repro_torch.optim import adamw_init
from repro_torch.tree import flat_dict, flatten_with_path, path_key, unflatten

drops = []
block = transformer.moe_block


def recording_block(*args, **kwargs):
    y, aux = block(*args, **kwargs)
    drops.append(float(aux.dropped_frac))
    return y, aux


transformer.moe_block = recording_block
BATCH = P(("pod", "data"))


def full_params(cfg, name):
    arrays = np.load(f"{work}/params_{name}.npz")
    template = param_specs(cfg)
    return unflatten(template, [torch.from_numpy(arrays[path_key(p)]) for p, _ in flatten_with_path(template)])


res, counts = {}, {}
index = index_from_reference(dict(np.load(f"{work}/index.npz")), device="cpu")
queries = torch.from_numpy(np.load(f"{work}/queries.npy"))
ann = json.loads(open(f"{work}/ann.json").read())
for shape, cases in jobs:
    mesh = make_mesh(shape, POD_AXES, "cpu")
    at0 = "x".join(map(str, shape)) + "/"
    for case, c in cases.items():
        at = f"{at0}{case}/"
        cfg = configs.get(c["arch"]).reduced(dtype="float32", **c["over"])
        B, seq = c["batch"], c["seq"]
        s_max = seq + c["steps"]
        inputs = np.load(f"{work}/inputs_{case}.npz")

        train, _, place = step_and_specs(cfg, ShapeSpec("t", "train", seq, B), mesh)
        sp = flat_dict(place[0])
        params = shard_tree(full_params(cfg, case), place[0], mesh)
        opt = adamw_init(params)
        for s in range(c["train_steps"]):
            batch = {"tokens": torch.from_numpy(inputs[f"tokens_{s}"]),
                     "labels": torch.from_numpy(inputs[f"labels_{s}"])}
            params, opt, loss = train(params, opt, shard_tree(batch, place[2], mesh))
            res[f"{at}loss_{s}"] = float(loss)
            for k, v in train.metrics.items():
                res[f"{at}{k}_{s}"] = float(v)
            if s == 0:
                counts[f"{at}train"] = dict(train.mesh_context.counts)
                for k, p in flat_dict(params).items():
                    if p.grad is not None:
                        res[f"{at}g/{k}"] = gather_tensor(p.grad, sp[k], mesh).numpy()
            for k, v in flat_dict(gather_tree(params, place[0], mesh)).items():
                res[f"{at}p{s}/{k}"] = v.detach().numpy()

        prefill, _, (p_place, b_place) = step_and_specs(cfg, ShapeSpec("p", "prefill", seq, B), mesh)
        serve, _, _ = step_and_specs(cfg, ShapeSpec("d", "decode", s_max, B), mesh)
        params = shard_tree(full_params(cfg, case), p_place, mesh)
        drops.clear()
        logits, caches = prefill(params, shard_tree({"tokens": torch.from_numpy(inputs["prompt"])}, b_place, mesh),
                                 s_max=s_max)
        counts[f"{at}prefill"] = dict(prefill.mesh_context.counts)
        res[at + "prefill"] = gather_tensor(logits, BATCH, mesh).numpy()
        res[at + "prefill_drops"] = np.array(drops)
        full = gather_caches(caches, mesh, s_max=s_max, batch_divisible=True)
        res[at + "prefill_k"], res[at + "prefill_v"] = full.k.numpy(), full.v.numpy()
        tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        drops.clear()
        for s in range(c["steps"]):
            res[f"{at}tokens_{s}"] = gather_tensor(tok, BATCH, mesh).numpy()
            logits, caches = serve(params, caches, tok)
            if s == 0:
                counts[f"{at}decode"] = dict(serve.mesh_context.counts)
            res[f"{at}logits_{s}"] = gather_tensor(logits, BATCH, mesh).numpy()
            tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        res[at + "decode_drops"] = np.array(drops)
        full = gather_caches(caches, mesh, s_max=s_max, batch_divisible=True)
        res[at + "cache_k"], res[at + "cache_v"] = full.k.numpy(), full.v.numpy()
        res[at + "cache_index"] = full.index.numpy()

    # The sharded search: this rank's rows of the index over `model`, the
    # queries over (pod, data).
    S, s = mesh.shape["model"], mesh.index("model")
    fn = make_sharded_search(mesh, index.graph.medoid, ann["k"], SearchConfig(t=ann["t"], bloom_z=ann["bloom_z"]))
    with CollectiveMode() as cm:
        ids, dists = fn(queries, index.codec.codebooks, local_rows(index.codes, s, S, 0),
                        local_rows(index.graph.adjacency, s, S, -1), local_rows(index.data_host, s, S, 0.0))
    counts[at0 + "ann"] = cm.snapshot()
    res[at0 + "ann_ids"], res[at0 + "ann_dists"] = ids.numpy(), dists.numpy()
if rank == 0:
    np.savez(f"{out}/out.npz", **res)
    open(f"{out}/counts.json", "w").write(json.dumps(counts))
dist.barrier()
dist.destroy_process_group()
open(f"{out}/ok.{rank}", "w").write("OK")
"""

# The same cells shape-only, rank 0 of a fake group of 4 (`launch.dryrun`).
FAKE = r"""
import json, sys
import torch
torch.set_num_threads(1)
import repro_torch.configs as configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun

work, out, jobs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
a = json.loads(open(f"{work}/ann.json").read())
counts = {}
for shape, cases in jobs:
    for case, c in cases.items():
        cfg = configs.get(c["arch"]).reduced(dtype="float32", **c["over"])
        B, seq = c["batch"], c["seq"]
        for kind, sh in (("train", ShapeSpec("t", "train", seq, B)), ("prefill", ShapeSpec("p", "prefill", seq, B)),
                         ("decode", ShapeSpec("d", "decode", seq + c["steps"], B))):
            rec = dryrun.run_cell(case, kind, True, f"{out}/fake", force=True, cfg=cfg, shape=sh,
                                  mesh_shape=tuple(shape))
            assert rec["status"] == "ok", rec.get("traceback")
            counts["x".join(map(str, shape)) + f"/{case}/{kind}"] = rec["counts"]
    rec = dryrun.sharded_search_dryrun(a["n"], a["d"], a["m"], a["R"], a["B"], a["k"], t=a["t"],
                                       bloom_z=a["bloom_z"], max_iters=a["max_iters"], mesh_shape=tuple(shape))
    assert rec["status"] == "ok", rec.get("traceback")
    counts["x".join(map(str, shape)) + "/ann"] = rec
open(f"{out}/fake_counts.json", "w").write(json.dumps(counts))
"""

LAUNCH = r"""
import subprocess, sys
script, fake, world, work, out, jobs = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6]
procs = [subprocess.Popen([sys.executable, script, str(r), str(world), work, out, jobs]) for r in range(world)]
procs.append(subprocess.Popen([sys.executable, fake, work, out, jobs]))
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


@pytest.fixture(scope="module")
def runs(small_ann_index, tmp_path_factory):
    """The reference's runs, then one launch of 4 gloo ranks (and the fake
    group's process) over both meshes. Returns (reference, {mesh: {key:
    array}}, gloo counts, fake counts)."""
    from repro.core import SearchConfig as JSearchConfig

    work = tmp_path_factory.mktemp("mesh_pod")
    ref = {}
    for case in CASES:
        ref[case] = _reference_run(case)
        np.savez(work / f"params_{case}.npz", **ref[case]["params"])
        np.savez(work / f"inputs_{case}.npz", **ref[case]["inputs"])
    data, idx = small_ann_index
    np.savez(work / "index.npz", codebooks=np.asarray(idx.codec.codebooks), codes=np.asarray(idx.codes),
             adjacency=np.asarray(idx.graph.adjacency), medoid=idx.graph.medoid, data=np.asarray(idx.data_np))
    queries = uniform_queries(data, ANN_QUERIES, seed=75)
    np.save(work / "queries.npy", queries)
    jcfg = JSearchConfig(t=ANN_T, bloom_z=4096)
    ids, dists = idx.executor("inmem").search(queries, ANN_K, cfg=jcfg, kernel_mode="reference")
    (work / "ann.json").write_text(json.dumps(dict(
        n=data.shape[0], d=data.shape[1], m=int(idx.codes.shape[1]), R=int(idx.graph.adjacency.shape[1]),
        B=ANN_QUERIES, k=ANN_K, t=ANN_T, bloom_z=4096, max_iters=jcfg.max_iters)))
    ref["ann"] = {"ids": np.asarray(ids), "dists": np.asarray(dists)}
    (work / "rank.py").write_text(textwrap.dedent(RANK))
    (work / "fake.py").write_text(textwrap.dedent(FAKE))
    out = work / "run"
    out.mkdir()
    jobs = [(list(m), {case: dict(arch=CASES[case][0], over=CASES[case][1], batch=CASES[case][3],
                                  seq=CASES[case][2], steps=STEPS, train_steps=TRAIN_STEPS)
                       for case in CASES}) for m in MESHES]
    res = subprocess.run(
        [sys.executable, "-c", LAUNCH, str(work / "rank.py"), str(work / "fake.py"), "4", str(work),
         str(out), json.dumps(jobs)],
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True, text=True, timeout=170,
    )
    assert res.returncode == 0, f"stdout:\n{res.stdout[-3000:]}\nstderr:\n{res.stderr[-6000:]}"
    assert sorted(f.name for f in out.glob("ok.*")) == [f"ok.{r}" for r in range(4)]
    got = {}
    for key, v in np.load(out / "out.npz").items():
        mesh, rest = key.split("/", 1)
        got.setdefault(tuple(int(n) for n in mesh.split("x")), {})[rest] = v
    return (ref, got, json.loads((out / "counts.json").read_text()),
            json.loads((out / "fake_counts.json").read_text()))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_pod_mesh_train_step_matches_reference(runs, mesh, case):
    """2 training steps: the loss (and the MoE's metrics, global means),
    the gathered gradients of the first step and the gathered parameters
    after each step against the reference's one-device steps."""
    ref, out, _, _ = runs
    got, want = out[mesh], ref[case]
    for s in range(TRAIN_STEPS):
        np.testing.assert_allclose(got[f"{case}/loss_{s}"], want[f"loss_{s}"], rtol=1e-5)
        for k in METRICS:
            if f"{k}_{s}" in want:
                np.testing.assert_allclose(got[f"{case}/{k}_{s}"], want[f"{k}_{s}"], rtol=1e-5, err_msg=k)
        worst, over, total = 0.0, 0, 0
        for k, w in want[f"params_{s}"].items():
            d = np.abs(got[f"{case}/p{s}/{k}"] - w)
            worst, over, total = max(worst, float(d.max())), over + int((d > 2e-6).sum()), total + d.size
        assert over <= 1e-3 * total and worst <= 2 * LR * (s + 1), (worst, over, total)
    prefix = f"{case}/g/"
    keys = [k for k in want["grads"] if prefix + k in got]
    assert {k for k in want["grads"] if "bangkv" not in k} <= set(keys)
    for k in keys:
        np.testing.assert_allclose(got[prefix + k], want["grads"][k], rtol=1e-4, atol=1e-5, err_msg=k)
    if case == "phi_drop":
        assert want["dropped_frac_0"] > 0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_pod_mesh_prefill_and_decode_match_reference(runs, mesh, case):
    """The prefill's logits and gathered caches, then 2 greedy exact-KV
    steps: logits, tokens, every layer's dropped fraction and the caches
    after them."""
    ref, out, _, _ = runs
    got, want = out[mesh], ref[case]
    assert min(want["margins"]) > MARGIN
    _close(got[f"{case}/prefill"], want["prefill"], "prefill logits")
    _close(got[f"{case}/prefill_k"], want["prefill_k"], "prefill K")
    _close(got[f"{case}/prefill_v"], want["prefill_v"], "prefill V")
    np.testing.assert_array_equal(got[f"{case}/prefill_drops"], want["prefill_drops"])
    for s in range(STEPS):
        np.testing.assert_array_equal(got[f"{case}/tokens_{s}"], want[f"tokens_{s}"])
        _close(got[f"{case}/logits_{s}"], want[f"logits_{s}"], f"step {s}")
    np.testing.assert_array_equal(got[f"{case}/decode_drops"], want["decode_drops"])
    _close(got[f"{case}/cache_k"], want["cache_k"], "K")
    _close(got[f"{case}/cache_v"], want["cache_v"], "V")
    assert np.all(got[f"{case}/cache_index"] == want["prefill_k"].shape[2])
    if case == "phi_drop":
        assert np.all(want["prefill_drops"] > 0) and np.all(want["decode_drops"] > 0)


@pytest.mark.parametrize("mesh", MESHES)
def test_pod_mesh_sharded_search_matches_reference(runs, mesh):
    """The queries over (pod, data), the index over `model`: the whole
    batch's ids equal the reference executor's, distances within rtol 1e-6,
    atol 1e-5 (ROADMAP C6)."""
    ref, out, _, _ = runs
    np.testing.assert_array_equal(out[mesh]["ann_ids"], ref["ann"]["ids"])
    np.testing.assert_allclose(out[mesh]["ann_dists"], ref["ann"]["dists"], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_fake_group_counts_equal_gloo_counts(runs, mesh):
    """Each step's collectives, kind by kind, shape-only on a fake group
    of 4 ranks equal those rank 0 issued on the gloo ranks; a pod mesh's
    training step sums over pod x data and pod."""
    _, _, counts, fake = runs
    at = "x".join(map(str, mesh))
    keys = [k for k in counts if k.startswith(at + "/") and k != at + "/ann"]
    assert len(keys) == 2 * len(CASES) + len(CASES)
    for k in keys:
        assert fake[k] == counts[k], k
        assert counts[k]["all_gather"] > 0 and counts[k]["all_reduce"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_fake_search_counts_add_up_to_gloo_search(runs, mesh):
    """`launch.dryrun.sharded_search_dryrun` at the gloo search's shapes on
    a fake group of 4: its seed, n of its hop and its re-rank give rank 0's
    collectives in the gloo search, kind by kind, count and bytes, for the
    n that the all-reduces imply (between 1 and max_iters - 1)."""
    _, _, counts, fake = runs
    at = "x".join(map(str, mesh))
    got, rec = counts[at + "/ann"], fake[at + "/ann"]
    seed, hop, rerank = (rec["collectives"][p] for p in ("seed", "hop", "rerank"))
    assert hop["all-reduce"]["count"] == 2 and hop["all-gather"]["count"] == 0
    n, rest = divmod(got["all-reduce"]["count"] - seed["all-reduce"]["count"] - rerank["all-reduce"]["count"],
                     hop["all-reduce"]["count"])
    assert rest == 0 and 1 <= n < rec["max_iters"], (n, rest)
    for kind, v in got.items():
        if kind == "total_bytes":
            assert v == seed[kind] + n * hop[kind] + rerank[kind]
            continue
        for f in ("count", "bytes"):
            assert v[f] == seed[kind][f] + n * hop[kind][f] + rerank[kind][f], (kind, f)
    assert got["all-gather"]["count"] == 2 and got["total_bytes"] > 0
