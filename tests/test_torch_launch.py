"""The launch slice: the ANN serve CLI and the shape-only dry run.

`launch.serve.main` builds an index and prints each batch's QPS and
recall@10, as the reference's CLI. `launch.dryrun` runs a cell's step
shape-only as rank 0 of a fake process group of the mesh's ranks, under
fake tensors; its records are estimates from shapes:

  * the bytes of a rank's blocks of the step's arguments equal those the
    reference's own partition specs give for the same leaves, for every
    arch and shape on the 16 x 16 and 2 x 16 x 16 meshes (shape arithmetic,
    no compile);
  * the model FLOPs are the reference's formula for all 40 (arch, shape)
    pairs;
  * a reduced dense cell whose heads, widths and vocabulary divide `model`
    4 counts a quarter of the one-rank FLOPs on (1, 4), within 1%;
  * reduced configs of every family run "ok" in all four shapes on a fake
    (2, 2, 2) group;
  * `--dryrun-sharded` at n = 4,000 on a fake (2, 2, 2) group reports the
    bytes a rank holds: its codes, adjacency and vectors rows, and its
    queries.

The fake group is the default process group, so the dry-run cases run in
one subprocess and the tests read its results. The fake group's collective
counts against a real run's: tests/test_torch_mesh_pod.py.
"""
import json
import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.compat import abstract_mesh
from repro.configs.base import LM_SHAPES as R_LM_SHAPES
from repro.launch import specs as rspecs
import repro_torch.configs as configs
from repro_torch.configs.base import LM_SHAPES
from repro_torch.distributed import AbstractMesh
from repro_torch.launch import dryrun
from repro_torch.launch import serve
from repro_torch.launch.specs import step_and_specs

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}
ARCHS = sorted(configs.ARCHS)

SUB = r"""
import json, sys
import torch
torch.set_num_threads(1)
import repro_torch.configs as configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun

out = sys.argv[1]
res = {}
# Every family, reduced, in all four shapes on a fake (2, 2, 2) group.
shapes = {"train_4k": ShapeSpec("train_4k", "train", 32, 8),
          "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32, 8),
          "decode_32k": ShapeSpec("decode_32k", "decode", 32, 8),
          "long_500k": ShapeSpec("long_500k", "decode", 64, 1)}
for name in ("granite-3-2b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b", "zamba2-2.7b",
             "internvl2-1b", "whisper-medium"):
    cfg = configs.get(name).reduced(dtype="float32", n_layers=2)   # zamba2: one group
    for sname, sh in shapes.items():
        rec = dryrun.run_cell(name, sname, True, f"{out}/cells", force=True, cfg=cfg, shape=sh,
                              mesh_shape=(2, 2, 2))
        res[f"{name}/{sname}"] = rec
# FLOPs across ranks: a dense cell whose heads, KV heads, widths and
# vocabulary divide `model` 4, on (1, 4) and on one rank.
cfg = configs.get("granite-3-2b").reduced(dtype="float32", n_layers=2, n_kv_heads=4)
sh = ShapeSpec("t", "train", 32, 2)
for mesh in ((1, 4), (1, 1)):
    rec = dryrun.run_cell("granite", "t", False, f"{out}/flops", force=True, cfg=cfg, shape=sh,
                          mesh_shape=mesh)
    res["flops/" + "x".join(map(str, mesh))] = rec
res["sharded"] = dryrun.sharded_search_dryrun(n=4000, mesh_shape=(2, 2, 2))
open(f"{out}/res.json", "w").write(json.dumps(res))
"""


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB), str(out)],
                         env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True, text=True,
                         timeout=150)
    assert res.returncode == 0, f"stdout:\n{res.stdout[-3000:]}\nstderr:\n{res.stderr[-6000:]}"
    return json.loads((out / "res.json").read_text())


def _reference_bytes(arg_specs, shardings, jmesh) -> int:
    """The bytes of a rank's blocks under the reference's own specs: each
    dim over the product of its axes' sizes."""
    sizes = dict(jmesh.shape)
    specs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    leaves = jax.tree_util.tree_leaves(arg_specs)
    assert len(specs) == len(leaves)
    total = 0
    for leaf, spec in zip(leaves, specs):
        shape = list(leaf.shape)
        for i, entry in enumerate(tuple(spec)):
            names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            div = math.prod(sizes[n] for n in names)
            assert shape[i] % div == 0
            shape[i] //= div
        total += math.prod(shape) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("name", ARCHS)
def test_argument_bytes_match_reference_specs(name):
    """For every shape on the 16 x 16 and 2 x 16 x 16 meshes: a rank's
    argument bytes from the port's placements equal those of the
    reference's arguments under its partition specs."""
    for mesh_name, axes in MESHES.items():
        jmesh, mesh = abstract_mesh(axes), AbstractMesh(dict(axes))
        for shape_name in LM_SHAPES:
            _, rargs, rplace = rspecs.step_and_specs(rconfigs.get(name), R_LM_SHAPES[shape_name], jmesh)
            want = _reference_bytes(rargs, rplace, jmesh)
            _, specs, place = step_and_specs(configs.get(name), LM_SHAPES[shape_name], mesh)
            assert dryrun.argument_bytes(specs, place, mesh) == want, (mesh_name, shape_name)


def test_model_flops_are_the_reference_formula():
    """6 N_active tokens for training, 2 N_active tokens for prefill and
    decode (tokens: a decode step's batch), for all 40 (arch, shape)
    pairs."""
    for name in ARCHS:
        rcfg = rconfigs.get(name)
        for shape_name, shape in LM_SHAPES.items():
            rshape = R_LM_SHAPES[shape_name]
            tokens = rshape.global_batch * (rshape.seq_len if rshape.kind != "decode" else 1)
            want = (6.0 if rshape.kind == "train" else 2.0) * rcfg.active_param_count() * tokens
            assert dryrun.model_flops(configs.get(name), shape) == want, (name, shape_name)


def test_flops_add_up_across_model_ranks(dry):
    """Rank 0's counted FLOPs on (1, 4), times 4, equal the one-rank
    step's within 1%."""
    four, one = dry["flops/1x4"], dry["flops/1x1"]
    assert four["status"] == one["status"] == "ok"
    f4, f1 = four["cost"]["flops"], one["cost"]["flops"]
    assert f1 > 0 and abs(4 * f4 - f1) <= 0.01 * f1, (f4, f1)
    assert one["roofline"]["useful_flop_ratio"] > 0


@pytest.mark.parametrize("name", ["granite-3-2b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b", "zamba2-2.7b",
                                  "internvl2-1b", "whisper-medium"])
def test_every_family_runs_shape_only(dry, name):
    """Each of the four shapes runs "ok" on a fake (2, 2, 2) group: the
    record's memory, cost, collectives and roofline are filled, the peak
    holds at least the arguments, and the collectives are MeshContext's."""
    for shape_name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        rec = dry[f"{name}/{shape_name}"]
        assert rec["status"] == "ok", rec.get("traceback")
        mem = rec["memory"]
        assert 0 < mem["argument_size_in_bytes"] <= mem["peak_bytes"] and mem["fits"]
        assert rec["cost"]["flops"] > 0 and 0 < rec["cost"]["matmul bytes"] < rec["cost"]["bytes accessed"]
        coll = rec["collectives"]
        assert coll["all-gather"]["count"] == rec["counts"]["all_gather"] > 0
        assert coll["total_bytes"] == sum(v["bytes"] for k, v in coll.items() if k != "total_bytes") > 0
        roof = rec["roofline"]
        assert roof["memory_s"] < roof["memory_s_unfused"]
        assert roof["dominant"] == max(("compute", "memory", "collective"), key=lambda t: roof[f"{t}_s"])
        assert rec["n_chips"] == 8 and rec["mesh"] == "2x2x2"
        assert rec["bangkv"] == (shape_name == "long_500k" and name != "mamba2-2.7b")


def test_dryrun_sharded_bytes_a_rank(dry):
    """n = 4,000 over `model` 2: 2,000 rows a rank of the codes (32 B), the
    adjacency (64 x 4 B) and the vectors (96 x 4 B); 10,240 queries over
    pod x data 4: 2,560 a rank. One hop: two all-reduces of (2,560, 64)
    4-byte lanes."""
    rec = dry["sharded"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_loc"] == 2000 and rec["queries_a_rank"] == 2560
    assert rec["bytes_a_rank"] == {"codes": 2000 * 32, "adjacency": 2000 * 64 * 4,
                                   "vectors": 2000 * 96 * 4, "queries": 2560 * 96 * 4,
                                   "total": 2000 * (32 + 256 + 384) + 2560 * 384}
    hop = rec["collectives"]["hop"]
    assert hop["all-reduce"] == {"count": 2, "bytes": 2 * 2560 * 64 * 4}
    assert rec["search_bound"]["count"]["all-reduce"] == 2 * rec["max_iters"] == 400


def test_serve_cli_on_cpu(capsys, monkeypatch):
    """`serve.main` at n = 400 on the CPU against the reference's CLI
    (`repro.launch.serve.main`, JAX on the CPU) with the same arguments:
    one line a batch in the reference's format with the reference's
    recall@10; for each batch the index searched (graph and codes), the
    queries, the search's t, bloom size and hop cap, and the ids returned
    equal the reference's."""
    import repro.core as rcore
    import repro_torch
    from repro.launch import serve as rserve

    found = {"reference": [], "port": []}
    for who, cls in (("reference", rcore.BangIndex), ("port", repro_torch.BangIndex)):
        def search(self, q, k, *, cfg, _search=cls.search, _who=who):
            ids, dists = _search(self, q, k, cfg=cfg)
            found[_who].append({
                "adjacency": np.asarray(self.graph.adjacency), "codes": np.asarray(self.codes.cpu() if _who == "port"
                                                                                   else self.codes),
                "queries": np.asarray(q), "k": k, "cfg": (cfg.t, cfg.bloom_z, cfg.iters()),
                "ids": np.asarray(ids.cpu() if _who == "port" else ids)})
            return ids, dists

        monkeypatch.setattr(cls, "search", search)
    args = ["--n", "400", "--batches", "2", "--batch-size", "32", "--t", "16"]
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    rserve.main()
    want = capsys.readouterr().out.strip().splitlines()
    rows = serve.main([*args, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(want) == len(rows) == len(found["port"]) == len(found["reference"]) == 2
    pattern = r"batch (\d+): (\d+) QPS recall@10=(\d\.\d{3})"
    for b, (line, ref) in enumerate(zip(lines, want)):
        m, r = re.fullmatch(pattern, line), re.fullmatch(pattern, ref)
        assert m and r and int(m.group(1)) == b and int(m.group(2)) > 0
        assert m.group(3) == r.group(3) and abs(float(m.group(3)) - rows[b]["recall_at_10"]) <= 5e-4
        got, exp = found["port"][b], found["reference"][b]
        for key in ("adjacency", "codes", "queries", "ids"):
            np.testing.assert_array_equal(got[key], exp[key], err_msg=key)
        assert (got["k"], got["cfg"]) == (exp["k"], exp["cfg"])
