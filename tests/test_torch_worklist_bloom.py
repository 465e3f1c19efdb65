"""Port vs reference: worklist sort/merge and the bloom filter, bit-exact.

Values are drawn with seeded numpy and contain no subnormals: the reference
runs on XLA:CPU, which flushes subnormals to zero when it compares, while
torch orders them, so a subnormal draw would test the two backends' float
modes instead of the algorithm.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bloom as jbloom
from repro.core import worklist as jwl
from repro_torch.core import bloom as tbloom
from repro_torch.core import worklist as twl

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core


def _normal_f32(rng, shape, scale=100.0):
    """Finite float32 draws with no subnormals (and some repeated values,
    so the id tie-break is exercised)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[np.abs(x) < np.finfo(np.float32).tiny] = 0.0
    grid = (rng.integers(-20, 20, shape) * 0.37).astype(np.float32)
    return np.where(rng.random(shape) < 0.5, grid, x)


@pytest.mark.parametrize("B,R", [(1, 1), (3, 17), (8, 64), (2, 100)])
def test_sort_candidates_matches_reference(B, R):
    rng = np.random.default_rng(100 + R)
    d = _normal_f32(rng, (B, R))
    d[:, ::3] = np.inf
    i = rng.integers(0, 5000, (B, R)).astype(np.int32)
    jd, ji = jwl.sort_candidates(jnp.asarray(d), jnp.asarray(i))
    td, ti = twl.sort_candidates(torch.from_numpy(d), torch.from_numpy(i))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("B,t,R", [(1, 4, 4), (6, 16, 12), (3, 64, 64), (2, 33, 7)])
def test_merge_worklist_matches_reference(B, t, R):
    rng = np.random.default_rng(200 + t)
    wd = np.sort(_normal_f32(rng, (B, t)), axis=-1)
    wi = rng.integers(0, 1000, (B, t)).astype(np.int32)
    order = np.lexsort((wi, wd), axis=-1)
    wd, wi = np.take_along_axis(wd, order, -1), np.take_along_axis(wi, order, -1)
    wv = rng.random((B, t)) > 0.5
    cd = _normal_f32(rng, (B, R))
    ci = rng.integers(1000, 2000, (B, R)).astype(np.int32)
    cd[:, -2:] = np.inf
    ci[:, -2:] = jwl.INVALID_ID
    cd, ci = [np.array(a) for a in jwl.sort_candidates(jnp.asarray(cd), jnp.asarray(ci))]
    ref = jwl.merge_worklist(jwl.Worklist(jnp.asarray(wd), jnp.asarray(wi), jnp.asarray(wv)),
                             jnp.asarray(cd), jnp.asarray(ci))
    out = twl.merge_worklist(
        twl.Worklist(torch.from_numpy(wd), torch.from_numpy(wi), torch.from_numpy(wv)),
        torch.from_numpy(cd), torch.from_numpy(ci),
    )
    np.testing.assert_array_equal(out.dists.numpy(), np.asarray(ref.dists))
    np.testing.assert_array_equal(out.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(out.visited.numpy(), np.asarray(ref.visited))


def test_worklist_init_first_unvisited_mark_visited():
    rng = np.random.default_rng(3)
    B, t = 4, 8
    init_j, init_t = jwl.worklist_init(B, t), twl.worklist_init(B, t, "cpu")
    for a, b in zip(init_j, init_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    ids = rng.integers(0, 100, (B, t)).astype(np.int32)
    vis = rng.random((B, t)) > 0.6
    vis[1] = True                                     # nothing unvisited
    d = np.sort(_normal_f32(rng, (B, t)), -1)
    jw = jwl.Worklist(jnp.asarray(d), jnp.asarray(ids), jnp.asarray(vis))
    tw = twl.Worklist(torch.from_numpy(d), torch.from_numpy(ids), torch.from_numpy(vis))
    ju, jf = jwl.first_unvisited(jw)
    tu, tf = twl.first_unvisited(tw)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    mark = ids[:, 2].copy()
    mark[0] = jwl.INVALID_ID
    np.testing.assert_array_equal(
        twl.mark_visited(tw, torch.from_numpy(mark)).visited.numpy(),
        np.asarray(jwl.mark_visited(jw, jnp.asarray(mark)).visited),
    )


@pytest.mark.parametrize("z", [512, 4096, 399_887])
def test_bloom_hashes_match_reference(z):
    rng = np.random.default_rng(z)
    ids = rng.integers(-1, 2**31 - 1, (3, 64)).astype(np.int32)
    ids[0, :4] = [0, -1, 2**31 - 1, 1]
    j1, j2 = jbloom.bloom_hashes(jnp.asarray(ids), z)
    t1, t2 = tbloom.bloom_hashes(torch.from_numpy(ids), z)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


def test_bloom_query_and_set_matches_reference():
    """Duplicate ids in a row are both fresh (query-all-then-set), and a lane
    with valid 0 colliding with a lane with valid 1 leaves the bit set."""
    rng = np.random.default_rng(7)
    B, R, z = 4, 24, 64                      # small z: many slot collisions
    filt_j = jbloom.bloom_init(B, z)
    filt_t = tbloom.bloom_init(B, z, "cpu")
    for hop in range(4):
        ids = rng.integers(0, 300, (B, R)).astype(np.int32)
        ids[:, 1] = ids[:, 0]                # duplicate id in one row
        ids[:, 3] = ids[:, 2]
        valid = rng.random((B, R)) > 0.3
        valid[:, 2], valid[:, 3] = False, True   # same slots, flags 0 and 1
        fj, filt_j = jbloom.bloom_query_and_set(filt_j, jnp.asarray(ids), jnp.asarray(valid))
        ft, filt_t = tbloom.bloom_query_and_set(filt_t, torch.from_numpy(ids), torch.from_numpy(valid))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(filt_t.numpy(), np.asarray(filt_j))
        assert tbloom.bloom_query(filt_t, torch.from_numpy(ids))[torch.from_numpy(valid)].all()
