"""Shape-only dry run of every (arch x shape x mesh) cell on a fake process group.

The port of the reference package's `launch/dryrun.py`. The reference
lowers and compiles each cell's step on 512 fake XLA devices; here the
step runs eagerly, shape-only, as one rank of a mesh no host holds:

  * a fake process group (`backend="fake"`, torch's `FakeStore`) of the
    mesh's 256 (16 x 16) or 512 (2 x 16 x 16) ranks is made, this process
    as rank 0; its collectives return at once and move nothing;
  * under `FakeTensorMode` (tensors with shapes and dtypes, no storage)
    the cell's step from `launch.specs.step_and_specs` runs whole and at
    full depth on the cell's global shapes: "train" forward, backward and
    AdamW; "prefill"; "decode" one step on caches filled to seq_len - 1.
    The parameters, the optimizer state, the batch and the caches are rank
    0's blocks of their placements. The eager step runs every layer, so
    the reference's layer-delta cost model (XLA counts a scan body once)
    has no counterpart.

A step that reads a device value on the host cannot run shape-only: the
cell then gets `status: "error"` and its traceback, as in the reference.

The record of a cell (one JSON file under `--out`) keeps the reference's
keys where the meaning is the same. Its numbers are estimates from shapes
and the H100's data-sheet constants (`launch.mesh`), not measurements:

  * `memory.argument_size_in_bytes`: rank 0's blocks of the step's
    arguments, from the placements; `memory.peak_bytes`: the largest total
    of live tensors over the step (`torch.distributed._tools.mem_tracker.
    MemTracker` on the fake tensors, the arguments included); `fits`:
    peak_bytes under the H100's 80 GB;
  * `cost.flops`: rank 0's FLOPs by `torch.utils.flop_counter.
    FlopCounterMode` (matmuls, convolutions and attention; elementwise
    work uncounted); `cost["bytes accessed"]`: each operator's operand and
    result bytes summed over the step, as XLA's cost analysis counts an
    HLO op's: an upper bound on the memory traffic (no fusion, views
    free); `cost["matmul bytes"]`: those of the operators FlopCounterMode
    counts alone, each reading its operands and writing its result once,
    every other operator taken to fuse into them: the traffic of a fused
    step, an estimate;
  * `collectives`: the step's collectives by kind (`all-gather`,
    `all-reduce`, ... as the reference names them), their count and their
    payload's bytes a rank, from `MeshContext`'s counts (AdamW's three
    scalar all-reduces of the global norm are not among them);
  * `roofline`: compute_s (flops over the bf16 peak), memory_s (matmul
    bytes over HBM bandwidth), memory_s_unfused (bytes accessed over it,
    the upper bound), collective_s (collective bytes over NVLink's
    bandwidth each way), the dominant of compute_s, memory_s and
    collective_s, and the reference's model FLOPs (6 N_active tokens for
    training, 2 N_active tokens otherwise) against the ranks' counted
    FLOPs.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
# MeshContext's kinds, and the c10d operators, under the reference's names.
_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "allgather_": "all-gather", "allreduce_": "all-reduce"}
H100_HBM_BYTES = 80e9        # one H100 SXM's device memory (data sheet)


def fake_group(world: int) -> None:
    """Make the default process group a fake one of `world` ranks with this
    process as rank 0 (an earlier fake group of another size is torn down
    first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore   # registers "fake"

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group exists in this process; the dry run needs "
                               "a process of its own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def fake_mesh(shape: tuple[int, ...]):
    """Rank 0 of a runnable mesh of `shape` ((D, S), or (P, D, S) with a pod
    axis) over a fake group of its ranks."""
    from ..distributed.mesh import AXES, POD_AXES, make_mesh

    fake_group(math.prod(shape))
    return make_mesh(shape, POD_AXES if len(shape) == 3 else AXES, "cpu")


def block_shape(shape: tuple, spec, mesh) -> tuple:
    """The shape of a rank's block of a tensor of `shape` under `spec` (the
    blocks are even): on a runnable mesh or a shape-only one."""
    from ..distributed.partitioning import dim_axes, fit_spec

    spec = fit_spec(spec, shape, mesh)
    return tuple(d // math.prod(mesh.shape[a] for a in names)
                 for d, names in zip(shape, dim_axes(spec, len(shape), mesh)))


def argument_bytes(specs, place, mesh) -> int:
    """The bytes of a rank's blocks of a step's arguments: `specs` and
    `place` as `step_and_specs` gives them (the parameters, AdamW's state
    and the batch; the parameters and the batch; the parameters, the caches
    and the tokens)."""
    from ..tree import flat_dict, flatten_with_path, path_key

    total = 0
    for tree, ptree in zip(specs, place):
        sp = flat_dict(ptree)
        for p, leaf in flatten_with_path(tree):
            if isinstance(leaf, torch.Tensor):
                total += math.prod(block_shape(tuple(leaf.shape), sp[path_key(p)], mesh)) * leaf.element_size()
    return total


def rank_blocks(tree, specs, mesh):
    """`tree` (meta tensors) with each tensor replaced by an empty tensor of
    this rank's block of it under its spec in `specs`, made in the current
    mode (fake tensors under `FakeTensorMode`)."""
    from ..tree import flat_dict, flatten_with_path, path_key, unflatten

    sp = flat_dict(specs)
    return unflatten(tree, [
        torch.empty(block_shape(tuple(leaf.shape), sp[path_key(p)], mesh), dtype=leaf.dtype)
        if isinstance(leaf, torch.Tensor) else leaf
        for p, leaf in flatten_with_path(tree)])


class BytesMode(TorchDispatchMode):
    """The bytes a step moves, two ways: `unfused`, each operator's operand
    and result bytes summed (views and collectives excluded), the upper
    bound if nothing fuses; `matmul`, those of the operators
    FlopCounterMode counts (matmuls, convolutions, attention) alone."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._matmuls = flop_registry
        self.unfused = 0
        self.matmul = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace != "c10d" and not func.is_view:
            moved = _bytes(args) + _bytes(kwargs) + _bytes(out)
            self.unfused += moved
            if func.overloadpacket in self._matmuls:
                self.matmul += moved
        return out


class CollectiveMode(TorchDispatchMode):
    """The collectives issued, by kind, with their payload's bytes a rank
    (an all-gather's result, an all-reduce's tensor): on fake tensors or
    on a real group's."""

    def __init__(self):
        super().__init__()
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _KIND.get(func.__name__.split(".")[0]) if func.namespace == "c10d" else None
        if kind is not None:
            self.collectives[kind]["count"] += 1
            self.collectives[kind]["bytes"] += _bytes(out if kind == "all-gather" else args[0])
        return out

    def snapshot(self) -> dict:
        return _with_totals(self.collectives)


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_bytes(v) for v in x.values())
    return 0


def _with_totals(coll: dict) -> dict:
    coll = {k: dict(v) for k, v in coll.items() if k in COLLECTIVES}
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
    return coll


def model_flops(cfg, shape) -> float:
    """The reference's model FLOPs of a step, global: 6 N_active tokens for
    training, 2 N_active tokens for prefill and decode."""
    if shape.kind == "train":
        return 6.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    return 2.0 * cfg.active_param_count() * shape.global_batch


def roofline(flops: float, matmul_bytes: float, unfused_bytes: float, collective_bytes: float) -> dict:
    from .mesh import HBM_BW, NVLINK_BW_PER_DIRECTION, PEAK_FLOPS_BF16

    terms = {"compute_s": flops / PEAK_FLOPS_BF16, "memory_s": matmul_bytes / HBM_BW,
             "memory_s_unfused": unfused_bytes / HBM_BW,
             "collective_s": collective_bytes / NVLINK_BW_PER_DIRECTION}
    terms["dominant"] = max(("compute", terms["compute_s"]), ("memory", terms["memory_s"]),
                            ("collective", terms["collective_s"]), key=lambda kv: kv[1])[0]
    return terms


def run_step(cfg, shape, mesh) -> dict:
    """Run the cell's step shape-only on `mesh` (rank 0 of a fake group):
    {memory, cost, collectives, counts} of this rank."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from ..optim import adamw_init
    from .specs import step_and_specs

    step, specs, place = step_and_specs(cfg, shape, mesh)
    with FakeTensorMode():
        tracker, flops, cost = MemTracker(), FlopCounterMode(display=False), BytesMode()
        with tracker, flops, cost:
            if shape.kind == "train":
                params = rank_blocks(specs[0], place[0], mesh)
                opt_state = adamw_init(params)
                args = (params, opt_state, rank_blocks(specs[2], place[2], mesh))
            else:
                args = tuple(rank_blocks(s, p, mesh) for s, p in zip(specs, place))
            step(*args)
        peak = sum(v.get("Total", 0) for v in tracker.get_tracker_snapshot("peak").values())
    mc = step.mesh_context
    coll = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for kind, n in mc.counts.items():
        coll[_KIND[kind]] = {"count": n, "bytes": mc.bytes[kind]}
    return {
        "memory": {"argument_size_in_bytes": argument_bytes(specs, place, mesh), "peak_bytes": peak,
                   "fits": peak < H100_HBM_BYTES},
        "cost": {"flops": float(flops.get_total_flops()), "bytes accessed": float(cost.unfused),
                 "matmul bytes": float(cost.matmul)},
        "collectives": _with_totals(coll),
        "counts": dict(mc.counts),
    }


MESHES = {"pod16x16": (16, 16), "pod2x16x16": (2, 16, 16)}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, force: bool = False,
             opts: tuple[str, ...] = (), *, cfg=None, shape=None, mesh_shape=None) -> dict:
    """One cell's record, written to `out_dir` (and read back from there
    unless `force`). `cfg`, `shape` and `mesh_shape` stand in for the
    registry's config, `LM_SHAPES[shape_name]` and the production mesh
    (reduced cells in the tests)."""
    import repro_torch.configs as configs
    from repro_torch.configs.base import LM_SHAPES

    from .specs import uses_bangkv

    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    mesh_shape = tuple(mesh_shape or MESHES[mesh_name])
    if mesh_shape != MESHES[mesh_name]:
        mesh_name = "x".join(map(str, mesh_shape))
    tag = ("__opt-" + "-".join(o.removeprefix("opt_") for o in opts)) if opts else ""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}{tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = cfg or configs.get(arch)
    if opts:
        cfg = dataclasses.replace(cfg, **{o: True for o in opts})
    shape = shape or LM_SHAPES[shape_name]
    n_chips = math.prod(mesh_shape)
    t0 = time.time()
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "n_chips": n_chips,
              "kind": shape.kind, "opts": list(opts), "bangkv": uses_bangkv(cfg, shape),
              "status": "error"}
    try:
        res = run_step(cfg, shape, fake_mesh(mesh_shape))
        flops = res["cost"]["flops"]
        mflops = model_flops(cfg, shape)
        record.update(
            status="ok", memory=res["memory"], cost=res["cost"], collectives=res["collectives"],
            counts=res["counts"],
            roofline=dict(roofline(flops, res["cost"]["matmul bytes"], res["cost"]["bytes accessed"],
                                   res["collectives"]["total_bytes"]),
                          model_flops_global=mflops, flops_per_rank=flops,
                          useful_flop_ratio=mflops / (flops * n_chips) if flops else None),
        )
    except Exception:  # noqa: BLE001
        record["traceback"] = traceback.format_exc()
    record["wall_s"] = round(time.time() - t0, 2)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


class _OneHop:
    """A neighbour source for `bang_search` that serves the model group's
    rows for one hop and then ends the loop, with no host read (the stop
    test's `any(active)` cannot be read from fake tensors). It takes the
    collectives counted before each fetch, which split the search into the
    seed, one hop, and the re-rank with the batch's all-gather."""

    def __init__(self, fn, counter: CollectiveMode) -> None:
        self.fn, self.counter, self.marks = fn, counter, []

    def fetch(self, u, active):
        self.marks.append(self.counter.snapshot())
        return self.fn(u) if len(self.marks) == 1 else None


def _minus(a: dict, b: dict) -> dict:
    out = {k: {"count": v["count"] - b[k]["count"], "bytes": v["bytes"] - b[k]["bytes"]}
           for k, v in a.items() if k in COLLECTIVES}
    return _with_totals(out)


def sharded_search_dryrun(n: int = 2_000_000, d: int = 96, m: int = 32, R: int = 64,
                          B: int = 10_240, k: int = 10, *, t: int = 152, bloom_z: int = 399_887,
                          max_iters: int = 200, mesh_shape: tuple = (2, 16, 16)) -> dict:
    """The pod-scale sharded search shape-only: the reference's
    `serve --dryrun-sharded` shapes on a fake mesh, the codes, the graph
    and the vectors over `model`, the queries over the batch group (`pod`,
    `data`), in kernel mode "reference" as the reference lowers it. It runs
    `core.distributed.make_sharded_search` whole with a neighbour source
    that serves one hop (the hop loop's stop test reads the device), under
    a collective counter: the bytes a rank holds, the collectives of the
    seed, of one hop and of the re-rank and final all-gather, and max_iters
    times the hop's as the bound of a search."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..core.distributed import make_sharded_search, sharded_neighbor_fn
    from ..core.search import SearchConfig

    t0 = time.time()
    record = {"n": n, "d": d, "m": m, "R": R, "B": B, "k": k, "mesh": "x".join(map(str, mesh_shape)),
              "n_chips": math.prod(mesh_shape), "status": "error"}
    try:
        mesh = fake_mesh(tuple(mesh_shape))
        n_batch = mesh.shape["data"] * mesh.shape.get("pod", 1)
        n_loc = -(-n // mesh.shape["model"])
        cfg = SearchConfig(t=t, bloom_z=bloom_z, max_iters=max_iters, kernel_mode="reference")
        with FakeTensorMode(), CollectiveMode() as counter:
            queries = torch.empty((B, d), dtype=torch.float32)
            codebooks = torch.empty((m, 256, d // m), dtype=torch.float32)
            held = {"codes": torch.empty((n_loc, m), dtype=torch.uint8),
                    "adjacency": torch.empty((n_loc, R), dtype=torch.int32),
                    "vectors": torch.empty((n_loc, d), dtype=torch.float32)}
            hops = _OneHop(sharded_neighbor_fn(held["adjacency"], mesh.group("model")), counter)
            fn = make_sharded_search(mesh, 0, k, cfg, neighbor_fn=hops)
            fn(queries, codebooks, held["codes"], None, held["vectors"])
            seed, after_hop = hops.marks
            phases = {"seed": seed, "hop": _minus(after_hop, seed),
                      "rerank": _minus(counter.snapshot(), after_hop)}
        hop, C = phases["hop"], cfg.iters()
        bytes_a_rank = {name: x.numel() * x.element_size() for name, x in held.items()}
        bytes_a_rank["queries"] = B // n_batch * d * queries.element_size()
        record.update(
            status="ok", n_loc=n_loc, queries_a_rank=B // n_batch, max_iters=C,
            bytes_a_rank=dict(bytes_a_rank, total=sum(bytes_a_rank.values())),
            collectives=phases,
            search_bound={"count": {kind: v["count"] * C for kind, v in hop.items() if kind in COLLECTIVES},
                          "total_bytes": hop["total_bytes"] * C + phases["seed"]["total_bytes"]
                          + phases["rerank"]["total_bytes"]},
        )
    except Exception:  # noqa: BLE001
        record["traceback"] = traceback.format_exc()
    record["wall_s"] = round(time.time() - t0, 2)
    return record


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--opts", default="",
                    help="comma list of ModelConfig opt_* flags to enable (results tagged)")
    args = ap.parse_args(argv)
    opts = tuple(o if o.startswith("opt_") else f"opt_{o}" for o in args.opts.split(",") if o)

    import repro_torch.configs as configs
    from repro_torch.configs.base import LM_SHAPES

    archs = sorted(configs.ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(LM_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.out, force=args.force, opts=opts)
                ok = rec["status"] == "ok"
                failures += 0 if ok else 1
                dom = rec.get("roofline", {}).get("dominant", "-")
                mem, coll = rec.get("memory", {}), rec.get("collectives", {})
                peak = "-" if not mem else f"{mem['peak_bytes'] / 1e9:.2f}GB fits={mem['fits']}"
                counts = "-" if not coll else "/".join(str(coll[k]["count"]) for k in ("all-gather", "all-reduce"))
                print(f"[{'OK' if ok else 'FAIL':4s}] {arch:26s} {shape:12s} {rec['mesh']:10s} "
                      f"wall={rec.get('wall_s', '-')}s peak={peak} dominant={dom} "
                      f"gathers/reduces={counts}", flush=True)
                if not ok:
                    tb = rec.get("traceback", "")
                    print(tb.splitlines()[-1] if tb else "?", flush=True)
    print(f"dry-run complete: {failures} failures", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
