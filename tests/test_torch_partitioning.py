"""The port's sharding rules held against the reference's, and its blocks.

`distributed.partitioning.param_pspecs` (parameters and the AdamW state),
`cache_pspecs` (decode caches at decode_32k and long_500k) and
`batch_pspec` must equal the reference's specs leaf by leaf, for all ten
configs on the production meshes 16 x 16 and 2 x 16 x 16 and on (4, 2)
and (1, 4), all shape-only (the reference's `AbstractMesh`, the port's).
The port keeps one tensor a layer where the reference stacks (L, ...): a
per-layer spec equals the reference's with its leading None dropped. The
port's meta specs (`launch.specs`) have the reference's shapes and dtypes.
`shard_tensor` then `gather_tensor` gives the tensor back on gloo ranks
(one subprocess a rank, importing no JAX), a dim that does not divide its
axis included. Specs are exact: no tolerance applies.
"""
import itertools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as rconfigs
from repro.compat import abstract_mesh
from repro.configs.base import LM_SHAPES as R_LM_SHAPES
from repro.distributed import partitioning as rpart
from repro.launch import specs as rspecs
from repro.optim import adamw_init as radamw_init
import repro_torch.configs as configs
from repro_torch.configs.base import LM_SHAPES
from repro_torch.distributed import AbstractMesh, P, partitioning
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import specs
from repro_torch.optim import adamw_init
from repro_torch.optim.compression import stacked_key
from repro_torch.tree import flatten_with_path, path_key

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = sorted(configs.ARCHS)
MESHES = {
    "16x16": (("data", 16), ("model", 16)),
    "2x16x16": (("pod", 2), ("data", 16), ("model", 16)),
    "4x2": (("data", 4), ("model", 2)),
    "1x4": (("data", 1), ("model", 4)),
}


def _meshes(name):
    pairs = MESHES[name]
    return abstract_mesh(pairs), AbstractMesh(dict(pairs))


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(rpart._key_str(p) for p in path): leaf for path, leaf in flat}


def _port_flat(tree) -> dict:
    return {path_key(p): leaf for p, leaf in flatten_with_path(tree)}


def _ref_key(key: str) -> tuple[str, bool]:
    """The reference's leaf of a port path, and whether it is stacked."""
    s = stacked_key(key)
    return s.replace("layers/*/", "layers/").replace("layers/*", "layers"), "*" in s


def _hold_per_leaf(port: dict, ref: dict) -> None:
    seen = set()
    for key, spec in port.items():
        rkey, stacked = _ref_key(key)
        want = tuple(ref[rkey])
        if stacked and want:
            assert want[0] is None, (key, want)
            want = want[1:]
        assert spec == want, (key, spec, want)
        seen.add(rkey)
    assert seen == set(ref), sorted(set(ref) ^ seen)


_REF_PARAMS: dict = {}


def _ref_param_specs(name):
    if name not in _REF_PARAMS:
        p = rspecs.param_specs(rconfigs.get(name))
        _REF_PARAMS[name] = (p, jax.eval_shape(radamw_init, p))
    return _REF_PARAMS[name]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_param_pspecs_match_reference(name, mesh_name):
    """Parameters and the AdamW state (step, mu, nu, master), leaf by leaf;
    the meta parameters have the reference's shapes and dtypes."""
    jmesh, mesh = _meshes(mesh_name)
    rparams, ropt = _ref_param_specs(name)
    params = specs.param_specs(configs.get(name))
    got = _port_flat(partitioning.param_pspecs(params, mesh))
    _hold_per_leaf(got, _ref_flat(rpart.param_pspecs(rparams, jmesh)))
    rshapes = _ref_flat(rparams)
    for key, leaf in _port_flat(params).items():
        rkey, stacked = _ref_key(key)
        want = rshapes[rkey].shape[1:] if stacked else rshapes[rkey].shape
        assert leaf.device.type == "meta" and tuple(leaf.shape) == tuple(want), key
        assert str(leaf.dtype).split(".")[-1] == str(rshapes[rkey].dtype), key
    ropt_specs = rpart.param_pspecs(ropt, jmesh)
    opt_specs = partitioning.param_pspecs(adamw_init(params), mesh)
    assert opt_specs.step == tuple(ropt_specs.step) == ()
    for field in ("mu", "nu", "master"):
        _hold_per_leaf(getattr(opt_specs, field), _ref_flat(getattr(ropt_specs, field)))


@pytest.mark.parametrize("name", ARCHS)
def test_cache_pspecs_match_reference(name):
    """Decode caches at decode_32k and long_500k (BANG-KV's), on the four
    meshes, with the reference's batch-divisibility rule; the meta caches
    have the reference's shapes and dtypes, leaf by leaf."""
    for shape_name in ("decode_32k", "long_500k"):
        rcache = rspecs.cache_specs(rconfigs.get(name), R_LM_SHAPES[shape_name])
        cache = specs.cache_specs(configs.get(name), LM_SHAPES[shape_name])
        rleaves = jax.tree_util.tree_leaves(rcache)
        leaves = [leaf for _, leaf in flatten_with_path(cache)]
        assert [tuple(x.shape) for x in leaves] == [tuple(x.shape) for x in rleaves], shape_name
        assert [str(x.dtype).split(".")[-1] for x in leaves] == [str(x.dtype) for x in rleaves]
        assert all(x.device.type == "meta" for x in leaves)
        for mesh_name in MESHES:
            jmesh, mesh = _meshes(mesh_name)
            dp = int(np.prod([s for a, s in MESHES[mesh_name] if a in ("pod", "data")]))
            div = LM_SHAPES[shape_name].global_batch % dp == 0
            want = jax.tree_util.tree_leaves(rpart.cache_pspecs(rcache, jmesh, batch_divisible=div),
                                             is_leaf=lambda x: isinstance(x, JP))
            got = [s for _, s in flatten_with_path(partitioning.cache_pspecs(cache, mesh,
                                                                              batch_divisible=div))]
            assert got == [tuple(s) for s in want], (shape_name, mesh_name)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_pspec_and_batch_specs_match_reference(mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    assert partitioning.batch_pspec(mesh) == tuple(rpart.batch_pspec(jmesh))
    for name in ARCHS:
        for shape_name in ("train_4k", "prefill_32k"):
            ref = rspecs.batch_specs(rconfigs.get(name), R_LM_SHAPES[shape_name])
            got = specs.batch_specs(configs.get(name), LM_SHAPES[shape_name])
            assert sorted(got) == sorted(ref)
            for k, v in got.items():
                assert tuple(v.shape) == ref[k].shape and str(v.dtype).split(".")[-1] == str(ref[k].dtype)
                assert v.device.type == "meta"
            place = specs._batch_pspec_tree(got, mesh)
            rplace = rspecs._batch_pspec_tree(rconfigs.get(name), ref, jmesh)
            assert all(place[k] == tuple(rplace[k]) for k in ref)


def test_granite_pins_and_production_mesh():
    """The reference's own pins (tests/test_dryrun_tools.py): granite's odd
    vocabulary leaves the embedding whole over `model`; the production
    meshes are shape-only, and the card's constants are the H100's."""
    mesh = launch_mesh.make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16}
    assert launch_mesh.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16,
                                                                       "model": 16}
    sp = partitioning.param_pspecs(specs.param_specs(configs.get("granite-3-2b")), mesh)
    assert sp["embed"] == (None, "data") and sp["embed"] == P(None, "data")
    assert sp["layers"][0]["attn"]["wq"] == ("data", "model")
    assert (launch_mesh.PEAK_FLOPS_BF16, launch_mesh.HBM_BW,
            launch_mesh.NVLINK_BW_PER_DIRECTION) == (989e12, 3.35e12, 450e9)
    assert specs.uses_bangkv(configs.get("glm4-9b"), LM_SHAPES["long_500k"])
    assert not specs.uses_bangkv(configs.get("mamba2-2.7b"), LM_SHAPES["long_500k"])
    assert not specs.uses_bangkv(configs.get("glm4-9b"), LM_SHAPES["decode_32k"])


class _FakeRank:
    """A mesh's shape and one rank's coordinates, for cutting blocks."""

    def __init__(self, shape: dict, coords: dict):
        self.shape, self.coords = shape, coords

    def index(self, axis: str) -> int:
        return self.coords[axis]


@pytest.mark.parametrize("spec,shape", [
    (P("data", "model"), (8, 6)),
    (P("data", "model"), (7, 6)),                  # 7 does not divide data = 2: whole
    (P(None, ("pod", "data"), None), (3, 8, 5)),   # one dim over two axes
    (P(("data", "model"),), (12, 3)),
    (P(), (4, 4)),
])
def test_blocks_tile_the_tensor(spec, shape):
    """Every rank's block, cut by `shard_slices`, tiles the tensor once."""
    sizes = {"pod": 2, "data": 2, "model": 3}
    seen = np.zeros(shape, int)
    fitted = partitioning.fit_spec(spec, shape, _FakeRank(sizes, {}))
    replicas = 1
    for axis, n in sizes.items():
        if all(axis not in a for a in partitioning.dim_axes(fitted, len(shape), _FakeRank(sizes, {}))):
            replicas *= n
    for coords in itertools.product(*(range(n) for n in sizes.values())):
        rank = _FakeRank(sizes, dict(zip(sizes, coords)))
        seen[partitioning.shard_slices(shape, spec, rank)] += 1
    assert (seen == replicas).all()


ROUNDTRIP = r'''
import datetime, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
import torch.distributed as dist

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{work}/group", rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.distributed import P, gather_tensor, make_mesh, shard_tensor
from repro_torch.distributed.partitioning import fit_spec

g = torch.Generator().manual_seed(0)
cases = [((8, 12), P("data", "model")), ((7, 12), P("data", "model")), ((6, 5, 4), P(None, "model", "data")),
         ((16, 3), P(("data", "model"))), ((5,), P(None)), ((9, 8), P("model", None))]
tensors = [torch.randn(shape, generator=g) for shape, _ in cases]
for D, S in ((2, 2), (1, 4)):
    mesh = make_mesh((D, S), ("data", "model"), "cpu")
    for x, (shape, spec) in zip(tensors, cases):
        fitted = fit_spec(spec, shape, mesh)
        block = shard_tensor(x, spec, mesh)
        assert block.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
        n = {"data": D, "model": S}
        for d, entry in enumerate(fitted):
            names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            k = 1
            for a in names:
                k *= n[a]
            assert block.shape[d] * k == shape[d], (shape, spec, block.shape)
        back = gather_tensor(block, fitted, mesh)
        assert torch.equal(back, x), ((D, S), shape, spec)
# Every rank past its last collective before any tears its groups down.
dist.barrier()
dist.destroy_process_group()
open(f"{work}/ok.{rank}", "w").write("OK")
'''


def test_shard_then_gather_on_gloo_ranks(tmp_path):
    """On four gloo ranks, meshes (2, 2) and (1, 4): `shard_tensor` cuts a
    block of its own, of the fitted spec's shape (a dim that does not
    divide stays whole), and `gather_tensor` rebuilds the tensor on every
    rank."""
    (tmp_path / "rank.py").write_text(textwrap.dedent(ROUNDTRIP))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "rank.py"), str(r), "4", str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        errs = [p.communicate(timeout=100)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    assert sorted(f.name for f in tmp_path.glob("ok.*")) == [f"ok.{r}" for r in range(4)]
