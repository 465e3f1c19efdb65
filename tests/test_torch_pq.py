"""Port vs reference: the PQ codec (stage 1) on the same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import pq as jpq
from repro_torch.core import pq as tpq

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

RTOL, ATOL = 1e-6, 1e-5


def _codebooks(rng, m, dsub):
    return rng.standard_normal((m, 256, dsub)).astype(np.float32)


@pytest.mark.parametrize("B,m,dsub,d", [(1, 1, 4, 4), (7, 6, 11, 64), (13, 8, 4, 32), (4, 5, 7, 33)])
def test_build_dist_table_matches_reference(B, m, dsub, d):
    rng = np.random.default_rng(10 + m)
    cb = _codebooks(rng, m, dsub)
    q = rng.standard_normal((B, d)).astype(np.float32)
    ref = np.asarray(jpq.build_dist_table(jpq.PQCodec(jnp.asarray(cb)), jnp.asarray(q)))
    out = tpq.build_dist_table(tpq.PQCodec(torch.from_numpy(cb)), torch.from_numpy(q))
    assert out.is_contiguous() and out.shape == (B, m, 256)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,R,m", [(1, 4, 4), (3, 17, 9), (8, 64, 32), (5, 31, 16)])
def test_adc_distance_matches_reference(B, R, m):
    rng = np.random.default_rng(20 + m)
    table = (rng.standard_normal((B, m, 256)).astype(np.float32)) ** 2
    codes = rng.integers(0, 256, (B, R, m)).astype(np.uint8)
    ref = np.asarray(jpq.adc_distance(jnp.asarray(table), jnp.asarray(codes)))
    out = tpq.adc_distance(torch.from_numpy(table), torch.from_numpy(codes))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    # On an integer-valued table every order of summation is exact.
    itable = rng.integers(0, 1000, (B, m, 256)).astype(np.float32)
    np.testing.assert_array_equal(
        tpq.adc_distance(torch.from_numpy(itable), torch.from_numpy(codes)).numpy(),
        np.asarray(jpq.adc_distance(jnp.asarray(itable), jnp.asarray(codes))),
    )


def test_pq_encode_decode_match_reference():
    rng = np.random.default_rng(30)
    cb = _codebooks(rng, 8, 4)
    x = rng.standard_normal((500, 30)).astype(np.float32)     # d padded to 32
    jcodec, tcodec = jpq.PQCodec(jnp.asarray(cb)), tpq.PQCodec(torch.from_numpy(cb))
    ref = np.asarray(jpq.pq_encode(jcodec, jnp.asarray(x)))
    out = tpq.pq_encode(tcodec, torch.from_numpy(x), chunk=128)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        tpq.pq_decode(tcodec, out).numpy(), np.asarray(jpq.pq_decode(jcodec, jnp.asarray(ref)))
    )


def test_train_pq_matches_reference():
    """Two Lloyd iterations from the same strided initialisation, with a
    sample cap below n so the strided subsample is exercised too."""
    from repro.data import gaussian_mixture

    x = gaussian_mixture(900, 16, n_clusters=12, seed=5)
    ref = np.asarray(jpq.train_pq(jnp.asarray(x), 4, iters=2, sample=600).codebooks)
    out = tpq.train_pq(torch.from_numpy(x), 4, iters=2, sample=600).codebooks
    assert out.shape == (4, 256, 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_gaussian_mixture_matches_reference_and_spans_its_subspaces():
    from repro.data import gaussian_mixture as j_mixture
    from repro_torch.data import gaussian_mixture

    np.testing.assert_array_equal(gaussian_mixture(500, 24, n_clusters=5, seed=3),
                                  j_mixture(500, 24, n_clusters=5, seed=3))
    x = gaussian_mixture(600, 24, n_clusters=3, seed=3, intrinsic_dim=4)
    assert x.shape == (600, 24) and x.dtype == np.float32
    # Same draw of centres and assignments: each cluster's offsets from its
    # centre span exactly `intrinsic_dim` dimensions.
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((3, 24)).astype(np.float32)
    assign = rng.integers(0, 3, 600)
    for c in range(3):
        sv = np.linalg.svd(x[assign == c] - centers[c], compute_uv=False)
        assert sv[3] > 1e-2 and sv[4] < 1e-4 * sv[0]
    with pytest.raises(ValueError, match="intrinsic_dim"):
        gaussian_mixture(10, 4, intrinsic_dim=5)
