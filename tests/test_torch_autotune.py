"""The port's autotuner (`repro_torch.kernels.autotune`) vs the reference's
(`repro.kernels.autotune`), on the CPU.

Held here: the winners file's schema and key format (a file either package
writes loads in the other), corrupt and missing files falling back to an
empty cache with a warning and raising under `strict=`, `apply` replacing
only on a winner, a saved and reloaded cache reproducing an executor's
pipeline keys and ids, the sweep recording one winner and restoring the
executor's own cache, the card's tile candidates `(0,)`, the device kind,
`min_bucket` validation, and executors cached per tuning file.
"""
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.convert import index_from_reference
from repro_torch.core import SearchConfig
from repro_torch.kernels import autotune as at
from repro_torch.runtime import SearchExecutor, bucket_size

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

R, M = 16, 8          # small_ann_index build parameters (R=16, m=8)


@pytest.fixture(scope="module")
def port_index(small_ann_index):
    data, idx = small_ann_index
    arrays = {"codebooks": np.asarray(idx.codec.codebooks), "codes": np.asarray(idx.codes),
              "adjacency": np.asarray(idx.graph.adjacency), "medoid": idx.graph.medoid,
              "data": np.asarray(idx.data_np)}
    return data, index_from_reference(arrays, device="cpu")


def _queries(data, n, seed):
    rng = np.random.default_rng(seed)
    return data[rng.integers(len(data), size=n)] + np.float32(0.01)


def _search_keys(tidx, cache, queries, cfg=None):
    """Pipeline keys after one fused search through a fresh executor."""
    ex = SearchExecutor.from_index(tidx, "inmem", autotune=cache)
    ids, _ = ex.search(queries, 5, cfg=cfg or SearchConfig(t=16, bloom_z=4096, kernel_mode="fused"))
    return set(ex._cache), ids.numpy()


@pytest.mark.parametrize("eager", [True, False])
def test_roundtrip_reproduces_pipeline_keys(port_index, tmp_path, eager):
    data, tidx = port_index
    queries = _queries(data, 6, 3)
    dk = at.device_kind("cpu")
    cache = at.AutotuneCache()
    # Bucket 8 serves the 6-query batch; the tile changes no bit on any
    # device of the port, the eager flavour may change ids.
    cache.put(dk, 8, R, M, eager=eager, codes_tile_rows=64, per_hop_us=1.0)
    keys1, ids1 = _search_keys(tidx, cache, queries)
    path = tmp_path / "winners.json"
    cache.save(path)
    keys2, ids2 = _search_keys(tidx, at.AutotuneCache.load(path), queries)
    assert keys1 == keys2
    np.testing.assert_array_equal(ids1, ids2)
    # The winner rode the key: the pipeline was built for the tuned config.
    (key,) = keys1
    cfg_in_key = next(c for c in key if isinstance(c, SearchConfig))
    assert cfg_in_key.codes_tile_rows == 64 and cfg_in_key.eager is eager
    # The winner's config given by hand: the same ids.
    tuned = SearchConfig(t=16, bloom_z=4096, kernel_mode="fused", eager=eager, codes_tile_rows=64)
    np.testing.assert_array_equal(_search_keys(tidx, None, queries, tuned)[1], ids1)
    # Untuned: another key; with the caller's eager the same ids (the tile
    # changes no bit).
    keys3, ids3 = _search_keys(tidx, None, queries)
    assert keys3 != keys1
    if eager:
        np.testing.assert_array_equal(ids1, ids3)
    # A winner for another shape leaves the executor untuned.
    other = at.AutotuneCache()
    other.put(dk, 128, R, M, eager=not eager, codes_tile_rows=64, per_hop_us=1.0)
    assert _search_keys(tidx, other, queries)[0] == keys3


def test_cache_json_schema_and_key_format(tmp_path):
    cache = at.AutotuneCache()
    cache.put("NVIDIA H100 80GB HBM3", 64, 32, 16, eager=True, codes_tile_rows=0, per_hop_us=12.5)
    path = tmp_path / "w.json"
    cache.save(path)
    raw = json.loads(path.read_text())
    assert raw["version"] == at.SCHEMA_VERSION == jat.SCHEMA_VERSION
    assert raw["winners"] == {
        "NVIDIA H100 80GB HBM3|bucket=64|R=32|m=16": {
            "eager": True, "codes_tile_rows": 0, "per_hop_us": 12.5,
        },
    }
    assert at.autotune_key("cpu", 8, R, M) == jat.autotune_key("cpu", 8, R, M)
    loaded = at.AutotuneCache.load(path, strict=True)
    assert len(loaded) == 1
    assert loaded.lookup("NVIDIA H100 80GB HBM3", 64, 32, 16)["per_hop_us"] == 12.5
    assert loaded.lookup("NVIDIA H100 80GB HBM3", 64, 32, 99) is None


def test_winners_files_load_in_both_packages(tmp_path):
    """The port writes and reads the reference's JSON, byte for byte."""
    winners = [("cpu", 8, R, M, False, 0, 3.25), ("NVIDIA H100 80GB HBM3", 1024, 64, 32, True, 0, 41.0)]
    ours, theirs = at.AutotuneCache(), jat.AutotuneCache()
    for dk, b, r, m, eager, tile, us in winners:
        ours.put(dk, b, r, m, eager=eager, codes_tile_rows=tile, per_hop_us=us)
        theirs.put(dk, b, r, m, eager=eager, codes_tile_rows=tile, per_hop_us=us)
    ours.save(tmp_path / "port.json")
    theirs.save(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    assert jat.AutotuneCache.load(tmp_path / "port.json", strict=True).winners == ours.winners
    assert at.AutotuneCache.load(tmp_path / "ref.json", strict=True).winners == theirs.winners


@pytest.mark.parametrize("content", [
    "{not json",                                               # unparseable
    json.dumps([1, 2]),                                        # not an object
    json.dumps({"version": 99, "winners": {}}),                # bad version
    json.dumps({"version": 1, "winners": [1]}),                # bad winners
    json.dumps({"version": 1, "winners": {"k": {"eager": 1,    # int != bool
                "codes_tile_rows": 0, "per_hop_us": 1.0}}}),
    json.dumps({"version": 1, "winners": {"k": {"eager": True,  # missing field
                "per_hop_us": 1.0}}}),
    json.dumps({"version": 1, "winners": {"k": {"eager": True,  # negative tile
                "codes_tile_rows": -8, "per_hop_us": 1.0}}}),
    json.dumps({"version": 1, "winners": {"k": {"eager": True,  # bool tile
                "codes_tile_rows": True, "per_hop_us": 1.0}}}),
])
def test_corrupt_cache_falls_back_to_defaults(tmp_path, content):
    """A bad tuning file never takes serving down: a plain load warns and
    returns an empty cache, a strict load raises -- as the reference."""
    path = tmp_path / "bad.json"
    path.write_text(content)
    with pytest.warns(UserWarning, match="falling back"):
        cache = at.AutotuneCache.load(path)
    assert len(cache) == 0
    with pytest.raises((ValueError, TypeError, KeyError)):
        at.AutotuneCache.load(path, strict=True)
    with pytest.warns(UserWarning, match="falling back"):
        assert len(jat.AutotuneCache.load(path)) == 0


def test_missing_cache_file_falls_back(tmp_path):
    with pytest.warns(UserWarning, match="falling back"):
        cache = at.AutotuneCache.load(tmp_path / "nope.json")
    assert len(cache) == 0
    with pytest.raises(OSError):
        at.AutotuneCache.load(tmp_path / "nope.json", strict=True)


def test_apply_replaces_only_on_winner():
    cache = at.AutotuneCache()
    cfg = SearchConfig(t=16, kernel_mode="fused")
    assert cache.apply(cfg, "cpu", 8, R, M) is cfg     # no winner: untouched
    cache.put("cpu", 8, R, M, eager=False, codes_tile_rows=32, per_hop_us=2.0)
    tuned = cache.apply(cfg, "cpu", 8, R, M)
    assert tuned.eager is False and tuned.codes_tile_rows == 32
    assert tuned.t == cfg.t and tuned.kernel_mode == "fused"
    assert cache.apply(cfg, "cpu", 16, R, M) is cfg    # other bucket: no
    assert cache.apply(cfg, "NVIDIA H100 80GB HBM3", 8, R, M) is cfg   # other device: no


@pytest.mark.parametrize("n,m", [(1200, 8), (10**6, 32), (10**9, 64)])
def test_default_tile_candidates_are_zero_alone(n, m):
    """The card's hop kernel has no placement to decide: 0 alone, at any n,
    where the reference sweeps tiles once its codes outgrow VMEM."""
    assert at.default_tile_candidates(n, m) == (0,)


def test_device_kind():
    assert at.device_kind("cpu") == "cpu" == at.device_kind(torch.device("cpu"))
    if torch.cuda.is_available():
        assert at.device_kind("cuda") == torch.cuda.get_device_name(0)


def test_autotune_executor_sweep_records_winner(port_index):
    """The sweep times real fused searches, records exactly one winner for
    the queries' bucket, keeps every candidate's times, and leaves the
    executor's own autotune cache as it found it."""
    data, tidx = port_index
    own = at.AutotuneCache()
    ex = SearchExecutor.from_index(tidx, "inmem", autotune=own)
    queries = _queries(data, 4, 5)
    cache = at.autotune_executor(ex, queries, k=4, t=16, repeats=2, eager_options=(True, False))
    assert len(cache) == 1 and len(own) == 0
    w = cache.lookup(at.device_kind("cpu"), ex._bucket_for(4), R, M)
    assert w is not None and w["codes_tile_rows"] == 0 and w["per_hop_us"] > 0
    assert [(s["eager"], s["codes_tile_rows"]) for s in cache.last_sweep] == [(True, 0), (False, 0)]
    assert all(len(s["per_hop_us"]) == 2 and min(s["per_hop_us"]) > 0 for s in cache.last_sweep)
    assert w["per_hop_us"] == min(min(s["per_hop_us"]) for s in cache.last_sweep)
    assert ex._autotune is own                          # restored, not leaked
    # Every candidate built its own pipeline, in fused mode.
    cfgs = {next(c for c in key if isinstance(c, SearchConfig)) for key in ex._cache}
    assert {(c.eager, c.kernel_mode) for c in cfgs} == {(True, "fused"), (False, "fused")}


@pytest.mark.parametrize("min_bucket", [0, 3, 12, -8])
def test_min_bucket_must_be_a_power_of_two(port_index, min_bucket):
    _, tidx = port_index
    with pytest.raises(ValueError, match="min_bucket"):
        bucket_size(5, min_bucket=min_bucket)
    with pytest.raises(ValueError, match="min_bucket"):
        SearchExecutor.from_index(tidx, "inmem", min_bucket=min_bucket)


@pytest.mark.parametrize("min_bucket,batch,bucket", [(1, 1, 1), (1, 5, 8), (16, 4, 16), (16, 17, 32)])
def test_min_bucket_sets_the_smallest_bucket(port_index, min_bucket, batch, bucket):
    data, tidx = port_index
    ex = SearchExecutor.from_index(tidx, "inmem", min_bucket=min_bucket)
    _, _, st = ex.search(_queries(data, batch, 7), 5, cfg=SearchConfig(t=16, bloom_z=4096),
                         return_stats=True)
    assert st.bucket == bucket == ex._bucket_for(batch)
    assert {key[0] for key in ex._cache} == {bucket}


def test_index_executors_cached_per_tuning_file(port_index):
    _, tidx = port_index
    a, b = at.AutotuneCache(), at.AutotuneCache()
    ex_a = tidx.executor("inmem", autotune=a)
    assert tidx.executor("inmem", autotune=a) is ex_a
    assert tidx.executor("inmem", autotune=b) is not ex_a
    assert tidx.executor("inmem") is not ex_a and ex_a._autotune is a
