"""The host-I/O exchange's pinned staging on the card.

On a CUDA index the prefetched exchange copies each ticket's frontier into
a pinned slot behind a CUDA event, the workers write the rows straight into
the slot's pinned buffer, and the ring stays small. These cases need an
NVIDIA GPU and skip elsewhere (`cuda` marker); they import no JAX, so they
run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_hostio_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch import BangIndex, SearchConfig
from repro_torch.data import gaussian_mixture, uniform_queries
from repro_torch.runtime.hostio import HostIOConfig
from repro_torch.runtime.hostio import prefetch as prefetch_mod

K = 5
MODES = ("reference", "staged", "fused")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned staging ring and its CUDA events exist only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hio", [dict(workers=1), dict(workers=2, hot_cache_rows=64, prefetch=True),
                                 dict(workers=4, prefetch=True)])
def test_hostio_base_on_the_card(cuda, mode, hio):
    data = gaussian_mixture(1200, 32, n_clusters=24, seed=3)
    cpu = BangIndex.build(data, m=8, R=16, L_build=24, kmeans_iters=6, device="cpu")
    idx = BangIndex.from_arrays(cpu.codec.codebooks, cpu.codes, cpu.graph.adjacency, cpu.graph.medoid,
                                data, device=cuda)
    q = uniform_queries(data, 16, seed=97)
    cfg = SearchConfig(t=32, bloom_z=8192)
    cfg_io = HostIOConfig(**hio)
    ids_p, d_p = idx.search(q, K, cfg=cfg, variant="base", kernel_mode=mode)
    ex = idx.executor("base", hostio=cfg_io)
    try:
        for _ in range(3):
            ids, d = idx.search(q, K, cfg=cfg, variant="base", kernel_mode=mode, hostio=cfg_io)
            assert torch.equal(ids, ids_p) and torch.equal(d, d_p)
        ring = ex.neighbors._ring
        assert 1 <= len(ring) <= prefetch_mod._RING_SLOTS
        assert all(s.rows.is_pinned() and s.frontier.is_pinned() for s in ring)
        s = ex.hostio_runtime.stats()
        assert s["prefetch_misses"] == 0 and s["hedged_gathers"] == 0 and s["degraded_lanes"] == 0
        assert (s["prefetch_hits"] > 0) == cfg_io.prefetch
    finally:
        ex.hostio_runtime.stop()
    # The CPU index's host-I/O base gives the card's ids.
    ids_c, _ = cpu.search(q, K, cfg=cfg, variant="base", kernel_mode=mode, hostio=cfg_io)
    np.testing.assert_array_equal(ids_c.numpy(), ids.cpu().numpy())
    cpu.executor("base", hostio=cfg_io).hostio_runtime.stop()
