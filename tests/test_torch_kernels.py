"""Port kernels vs the reference's Pallas kernels (interpret mode) and ref.py.

On the CPU every `ops.py` wrapper runs its plain PyTorch version, so the
parity cases below hold `repro_torch.kernels.<name>.ref` against the JAX
package on the same numpy inputs. Integer-valued tables and vectors keep
every sum exact in float32, so those comparisons are bitwise whatever the
order of summation; float inputs are compared within rtol 1e-6, atol 1e-5.

The cases marked `cuda` launch the CUDA kernels and hold them against their
plain versions on the card. They need an NVIDIA GPU and skip elsewhere; the
JAX package is imported lazily so that this file also runs where JAX is not
installed: `python -m pytest -q -m cuda tests/test_torch_kernels.py`.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core.worklist import INVALID_ID, Worklist
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_table import ops as table_ops
from repro_torch.kernels.rerank_l2 import ops as rr_ops
from repro_torch.kernels.search_step import ops as step_ops

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

RTOL, ATOL = 1e-6, 1e-5
STEP_SHAPES = [
    (1, 1, 4, 1, 16),          # degenerate single-candidate step
    (3, 17, 24, 9, 120),       # non-pow2 R and t, odd m
    (8, 32, 32, 8, 256),       # pow2 everywhere
    (2, 24, 33, 6, 90),        # t just past a pow2 boundary
]
# (4, 1, 32): the medoid seed (R = 1); (4, 64, 32): the staged mode's
# distances at the main path's R = 64, m = 32.
ADC_SHAPES = [(1, 4, 4), (3, 17, 9), (8, 64, 74), (5, 31, 16), (4, 1, 32), (4, 64, 32)]
TRAVERSE_SHAPES = [(1, 4, 8), (5, 31, 16), (9, 16, 64)]         # tests/test_kernels.py:155
RERANK_SHAPES = [(1, 1, 8), (5, 19, 37), (4, 200, 128), (2, 7, 129)]
# (B, R, m, n_loc): tests/test_kernels.py:344, and the main path's B, R, m on
# a quarter of n = 10**6 rows.
LOCAL_ADC_SHAPES = [(5, 13, 9, 120), (1, 1, 4, 1), (64, 64, 32, 250_000)]
TABLE_SHAPES = [(1, 1, 4), (7, 6, 11), (13, 8, 16), (4, 74, 2)]   # tests/test_kernels.py:39
# Subspace widths of K8 on both sides of its tile regime's limit
# (table_ops.TILE_MAX_DSUB = 16): the main path's 4, the shapes above, and
# d = 32 and 128 at m = 1.
TABLE_DSUB = [1, 2, 4, 11, 16, 32, 128]
# K8's tiles (queries a tile), and its general regime (0).
TABLE_TILES = [0, 8, 16, 32, 64, 128]
# Card-only shapes of K2's two regimes (global lookups below
# adc_ops.SHARED_TABLE_MIN_R candidates, a shared table from it on): R on
# both sides of the crossover and at it, m a multiple of 8 and not.
ADC_REGIME_R = [1, 2, 8, 16, 63, 64, 100]
ADC_REGIME_M = [9, 32, 74]
# Card-only shapes of K3's tiles: C not a multiple of the tile, d not a
# multiple of 8 or 4, and B = 1.
RERANK_TILE_SHAPES = [(b, c, d) for b in (1, 3) for c in (1, 19, 104, 200) for d in (37, 128, 129)]
# Card-only widths of K1's and K7's global lookups (a window of 32
# subspaces read in two 16-byte loads where m % 16 == 0, else byte by byte):
# m a multiple of 16, of 4 only, and odd; R = 1 is K7's medoid seed.
LOOKUP_M = [9, 32, 74]
LOCAL_ADC_LOOKUP_R = [1, 64]
# (R, t) of the hop's tail (K1 and K6), with its merge row's P: both sides of
# the warp regime's limit (step_ops.WARP_MAX_P = 512), a partial warp at
# P < 32, and the paper's sweep to t = 152 at the main path's R = 64.
TAIL_RT_P = [(1, 1, 2), (4, 8, 16), (31, 16, 64), (64, 64, 128), (64, 152, 256), (64, 448, 512),
             (64, 500, 1024)]
# Batches that are and are not a multiple of K6's queries a block.
TAIL_B = [1, 5, 1023, 1024]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _step_inputs(rng, B, R, t, m, n, integer_table=True):
    """Random hop state as numpy arrays (the shapes and draws of the
    reference's tests/test_kernels.py:_random_step_inputs)."""
    if integer_table:
        table = rng.integers(0, 1000, (B, m, 256)).astype(np.float32)
    else:
        table = (rng.standard_normal((B, m, 256)) ** 2).astype(np.float32)
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    nbrs = rng.integers(0, n, (B, R)).astype(np.int32)
    fresh = rng.random((B, R)) > 0.3
    wd = np.sort(rng.integers(0, 5000, (B, t)).astype(np.float32), axis=-1)
    wi = rng.permutation(np.arange(n, n + t * B)).reshape(B, t).astype(np.int32)
    order = np.lexsort((wi, wd), axis=-1)
    wd, wi = np.take_along_axis(wd, order, -1), np.take_along_axis(wi, order, -1)
    wv = rng.random((B, t)) > 0.5
    active = rng.random((B,)) > 0.2
    return table, codes, nbrs, fresh, wd, wi, wv, active


def _port_step(inputs, eager, tile_rows=0, device="cpu"):
    table, codes, nbrs, fresh, wd, wi, wv, active = [
        torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in inputs
    ]
    wl, u, a = step_ops.fused_step(
        table, codes, Worklist(wd, wi, wv), nbrs, fresh, active,
        eager=eager, tile_rows=tile_rows,
    )
    return [x.cpu().numpy() for x in (wl.dists, wl.ids, wl.visited, u, a)]


def _traverse_inputs(rng, B, R, t):
    """Precomputed candidates (the draw of the reference's
    test_fused_traverse_matches_oracle) and a random hop state."""
    fresh = rng.random((B, R)) > 0.3
    cd = np.where(fresh, rng.integers(0, 5000, (B, R)).astype(np.float32), np.float32(np.inf))
    ci = np.where(fresh, rng.integers(0, 10_000, (B, R)).astype(np.int32), np.int32(INVALID_ID))
    _, _, _, _, wd, wi, wv, active = _step_inputs(rng, B, R, t, 1, 16)
    return cd.astype(np.float32), ci.astype(np.int32), wd, wi, wv, active


def _port_traverse(inputs, eager, device="cpu"):
    cd, ci, wd, wi, wv, active = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in inputs]
    wl, u, a = step_ops.fused_traverse(Worklist(wd, wi, wv), cd, ci, active, eager=eager)
    return [x.cpu().numpy() for x in (wl.dists, wl.ids, wl.visited, u, a)]


def _tail_inputs(rng, B, R, t, m=16, n=3000):
    """Hop state for K1 (table, codes, nbrs, fresh, wd, wi, wv, active) whose
    rows cycle through the cases the tail must keep to the plain version's
    bits. Row b % 5 == 0: random; 1: distances tied among the candidates and
    with the worklist, ids distinct (a 0/1 table); 2: a worklist all
    visited; 3: no fresh lane; 4: a worklist ending in (+inf, INVALID,
    visited) pads. Ids are distinct within a row; about a fifth of the
    queries are inactive."""
    kind = np.arange(B) % 5
    table = rng.integers(0, 1000, (B, m, 256)).astype(np.float32)
    table[kind == 1] = rng.integers(0, 2, (int((kind == 1).sum()), m, 256))
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    nbrs = np.stack([rng.choice(n, R, replace=False) for _ in range(B)]).astype(np.int32)
    fresh = rng.random((B, R)) > 0.3
    fresh[kind == 3] = False
    wd = rng.integers(0, 5000, (B, t)).astype(np.float32)
    wd[kind == 1] = rng.integers(0, m + 1, (int((kind == 1).sum()), t))
    wi = (n + rng.permutation(t * B)).reshape(B, t).astype(np.int32)
    wv = rng.random((B, t)) > 0.5
    wv[kind == 2] = True
    for b in np.flatnonzero(kind == 4):
        w = int(rng.integers(0, t + 1))
        wd[b, w:], wi[b, w:], wv[b, w:] = np.inf, INVALID_ID, True
    order = np.lexsort((wi, wd), axis=-1)
    wd, wi, wv = (np.take_along_axis(x, order, -1) for x in (wd, wi, wv))
    active = rng.random((B,)) > 0.2
    return table, codes, nbrs, fresh, wd, wi, wv, active


def _tail_traverse_inputs(rng, B, R, t):
    """K6's inputs from the same rows: the candidates' distances drawn
    (small integers on the tied rows), +inf and INVALID where not fresh."""
    _, _, nbrs, fresh, wd, wi, wv, active = _tail_inputs(rng, B, R, t)
    cd = rng.integers(0, 5000, (B, R)).astype(np.float32)
    cd[np.arange(B) % 5 == 1] = rng.integers(0, 17, (int((np.arange(B) % 5 == 1).sum()), R))
    cd = np.where(fresh, cd, np.float32(np.inf)).astype(np.float32)
    ci = np.where(fresh, nbrs, np.int32(INVALID_ID)).astype(np.int32)
    return cd, ci, wd, wi, wv, active


def _exactly(rng, counts, R):
    """(len(counts), R) bool flags, row b with exactly counts[b] set lanes."""
    flags = np.zeros((len(counts), R), dtype=bool)
    for b, f in enumerate(counts):
        flags[b, rng.permutation(R)[:f]] = True
    return flags


def _lane_counts(R):
    """Scored lanes a query, one query each: none, one, a quarter, half, all
    but one and all, clipped to [0, R]."""
    return sorted({min(f, R) for f in (0, 1, R // 4, R // 2, max(R - 1, 0), R)})


def _assert_same(outs, refs):
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, np.asarray(r))


# --------------------------------------------------------------- K1 (CPU)
@pytest.mark.parametrize("B,R,t,m,n", STEP_SHAPES)
@pytest.mark.parametrize("eager", [True, False])
def test_search_step_ref_matches_pallas_and_reference_oracle(B, R, t, m, n, eager):
    import jax
    import jax.numpy as jnp
    from repro.kernels.common import interpret_mode
    from repro.kernels.search_step import ref as jref
    from repro.kernels.search_step.search_step import fused_step_pallas

    inputs = _step_inputs(np.random.default_rng(B * 1000 + R), B, R, t, m, n)
    j = [jnp.asarray(a) for a in inputs]
    outs = _port_step(inputs, eager)
    assert interpret_mode()
    _assert_same(outs, fused_step_pallas(*j, eager=eager, interpret=True))
    _assert_same(outs, jax.jit(jref.step_ref, static_argnames="eager")(*j, eager=eager))


@pytest.mark.parametrize("tile_rows", [8, 64])
def test_search_step_tile_rows_bit_identical(tile_rows):
    inputs = _step_inputs(np.random.default_rng(41), 3, 17, 24, 9, 120)
    base = _port_step(inputs, True, 0)
    _assert_same(_port_step(inputs, True, tile_rows), base)
    with pytest.raises(ValueError, match="tile_rows"):
        _port_step(inputs, True, -1)


# --------------------------------------------------------------- K6 (CPU)
@pytest.mark.parametrize("B,R,t", TRAVERSE_SHAPES)
@pytest.mark.parametrize("eager", [True, False])
def test_fused_traverse_ref_matches_pallas_and_reference_oracle(B, R, t, eager):
    import jax
    import jax.numpy as jnp
    from repro.kernels.search_step import ref as jref
    from repro.kernels.search_step.search_step import fused_traverse_pallas

    inputs = _traverse_inputs(np.random.default_rng(B * 100 + R + t), B, R, t)
    j = [jnp.asarray(a) for a in inputs]
    outs = _port_traverse(inputs, eager)
    _assert_same(outs, fused_traverse_pallas(*j, eager=eager, interpret=True))
    _assert_same(outs, jax.jit(jref.traverse_ref, static_argnames="eager")(*j, eager=eager))


@pytest.mark.parametrize("R,t,P", TAIL_RT_P)
def test_tail_regime_choice(R, t, P):
    """K1's and K6's tail: the warp regime, TRAVERSE_WARPS queries a block,
    up to WARP_MAX_P merge slots; the block regime beyond. On the CPU both
    wrappers run their plain versions and count no launch. Integer-valued
    inputs only (no random floats)."""
    assert step_ops.merge_slots(R, t) == P
    warps = step_ops.traverse_warps(P)
    assert warps == (step_ops.TRAVERSE_WARPS if P <= step_ops.WARP_MAX_P else 0)
    assert 1 <= step_ops.TRAVERSE_WARPS <= 8 and step_ops.WARP_MAX_P == 512
    B, m, n = 3, 4, 50
    table = (torch.arange(B * m * 256) % 97).float().reshape(B, m, 256)
    codes = (torch.arange(n * m) % 256).to(torch.uint8).reshape(n, m)
    nbrs = (torch.arange(B * R, dtype=torch.int32) % n).reshape(B, R)
    fresh = (torch.arange(B * R) % 3 != 0).reshape(B, R)
    wl = Worklist((torch.arange(B * t) % t).float().reshape(B, t) * 10,
                  (n + torch.arange(B * t, dtype=torch.int32)).reshape(B, t),
                  (torch.arange(B * t) % 2 == 0).reshape(B, t))
    active = torch.tensor([True, False, True])
    cd = torch.where(fresh, (torch.arange(B * R) % 7).float().reshape(B, R), float("inf"))
    ci = torch.where(fresh, nbrs, INVALID_ID)
    before = (step_ops.fused_step.launches, step_ops.fused_traverse.launches)
    for eager in (True, False):
        got = step_ops.fused_traverse(wl, cd, ci, active, eager=eager)
        want = step_ops.traverse_ref(cd, ci, wl.dists, wl.ids, wl.visited, active, eager=eager)
        for a, b in zip((*got[0], got[1], got[2]), want):
            assert torch.equal(a, b)
        for w in (0, 1, warps):
            got = step_ops._traverse(wl, cd, ci, active, eager=eager, warps=w)
            for a, b in zip((*got[0], got[1], got[2]), want):
                assert torch.equal(a, b)
        step_ops.fused_step(table, codes, wl, nbrs, fresh, active, eager=eager)
    assert (step_ops.fused_step.launches, step_ops.fused_traverse.launches) == before


# --------------------------------------------------------------- K2 (CPU)
@pytest.mark.parametrize("B,R,m", ADC_SHAPES)
@pytest.mark.parametrize("variant", ["onehot", "gather"])
def test_pq_adc_ref_matches_pallas_and_reference_oracle(B, R, m, variant):
    import jax.numpy as jnp
    from repro.kernels.pq_adc.pq_adc import adc_pallas
    from repro.kernels.pq_adc.ref import adc_ref as jadc_ref

    rng = np.random.default_rng(B * 100 + m)
    itable = rng.integers(0, 1000, (B, m, 256)).astype(np.float32)
    ftable = (rng.standard_normal((B, m, 256)) ** 2).astype(np.float32)
    codes = rng.integers(0, 256, (B, R, m)).astype(np.int32)
    valid = rng.random((B, R)) > 0.25
    for table, exact in ((itable, True), (ftable, False)):
        out = adc_ops.adc(torch.from_numpy(table), torch.from_numpy(codes),
                          torch.from_numpy(valid), variant=variant).numpy()
        for ref in (
            adc_pallas(jnp.asarray(table), jnp.asarray(codes), jnp.asarray(valid),
                       variant=variant, interpret=True),
            jadc_ref(jnp.asarray(table), jnp.asarray(codes), jnp.asarray(valid)),
        ):
            ref = np.asarray(ref)
            if exact:
                np.testing.assert_array_equal(out, ref)
            else:
                np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="variant"):
        adc_ops.adc(torch.from_numpy(itable), torch.from_numpy(codes),
                    torch.from_numpy(valid), variant="mxu")


# --------------------------------------------------------------- K3 (CPU)
@pytest.mark.parametrize("B,C,d", RERANK_SHAPES)
def test_rerank_l2_ref_matches_pallas_and_reference_oracle(B, C, d):
    import jax.numpy as jnp
    from repro.kernels.rerank_l2.ref import exact_sq_dists_ref as jrr_ref
    from repro.kernels.rerank_l2.rerank_l2 import exact_sq_dists_pallas

    rng = np.random.default_rng(C * 10 + d)
    for exact in (True, False):
        if exact:
            q = rng.integers(-20, 20, (B, d)).astype(np.float32)
            v = rng.integers(-20, 20, (B, C, d)).astype(np.float32)
        else:
            q = rng.standard_normal((B, d)).astype(np.float32)
            v = rng.standard_normal((B, C, d)).astype(np.float32)
        out = rr_ops.exact_sq_dists(torch.from_numpy(q), torch.from_numpy(v)).numpy()
        for ref in (exact_sq_dists_pallas(jnp.asarray(q), jnp.asarray(v), interpret=True),
                    jrr_ref(jnp.asarray(q), jnp.asarray(v))):
            ref = np.asarray(ref)
            if exact:
                np.testing.assert_array_equal(out, ref)
            else:
                np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------- K8 (CPU)
@pytest.mark.parametrize("dsub", TABLE_DSUB)
def test_table_regime_choice(dsub):
    """K8: the tile regime, TABLE_QUERIES queries a tile, up to TILE_MAX_DSUB;
    the general regime beyond. On the CPU the wrapper runs its plain version
    at every tile and counts no launch. Integer-valued inputs only
    (no random floats)."""
    queries = table_ops.table_queries(dsub)
    assert queries == (table_ops.TABLE_QUERIES if dsub <= table_ops.TILE_MAX_DSUB else 0)
    assert table_ops.TILE_MAX_DSUB == 16 and table_ops.TABLE_QUERIES >= 1
    B, m = 5, 3
    q = ((torch.arange(B * m * dsub) % 11) - 5).float().reshape(B, m, dsub)
    cb = ((torch.arange(m * 256 * dsub) % 13) - 6).float().reshape(m, 256, dsub)
    want = table_ops.dist_table_ref(q, cb)
    before = table_ops.dist_table.launches
    outs = [table_ops.dist_table(q, cb), table_ops._dist_table(q, cb, queries=0),
            table_ops._dist_table(q, cb, queries=queries or 1)]
    for got in outs:
        assert torch.equal(got, want)
    assert table_ops.dist_table.launches == before


def test_wrappers_reject_mixed_devices_and_bad_dtypes():
    q = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="devices"):
        rr_ops.exact_sq_dists(q, torch.zeros(2, 3, 8, device="meta"))
    from repro_torch.kernels import common

    with pytest.raises(TypeError, match="float32"):
        common.check(torch.zeros(2, dtype=torch.float64), "x", torch.float32, (2,))
    with pytest.raises(ValueError, match="contiguous"):
        common.check(torch.zeros(4, 4).T, "x", torch.float32, (4, 4))


# ------------------------------------------------------ CUDA kernels (card)
@pytest.mark.cuda
@pytest.mark.parametrize("B,R,t,m,n", STEP_SHAPES + [(64, 64, 64, 32, 5000)])
@pytest.mark.parametrize("eager", [True, False])
@pytest.mark.parametrize("integer_table", [True, False])
def test_search_step_kernel_matches_plain(cuda, B, R, t, m, n, eager, integer_table):
    """Same order of summation, so bit-equal on float tables too."""
    inputs = _step_inputs(np.random.default_rng(B + R + t), B, R, t, m, n, integer_table)
    before = step_ops.fused_step.launches
    outs = _port_step(inputs, eager, device=cuda)
    assert step_ops.fused_step.launches == before + 1
    _assert_same(outs, _port_step(inputs, eager, device="cpu"))
    for tile_rows in (8, 64):
        _assert_same(_port_step(inputs, eager, tile_rows, device=cuda), outs)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,t", TRAVERSE_SHAPES + [(1024, 64, 64)])
@pytest.mark.parametrize("eager", [True, False])
def test_fused_traverse_kernel_matches_plain(cuda, B, R, t, eager):
    inputs = _traverse_inputs(np.random.default_rng(B + R + t), B, R, t)
    before = step_ops.fused_traverse.launches
    outs = _port_traverse(inputs, eager, device=cuda)
    assert step_ops.fused_traverse.launches == before + 1
    _assert_same(outs, _port_traverse(inputs, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("R,t,P", TAIL_RT_P)
@pytest.mark.parametrize("B", TAIL_B)
@pytest.mark.parametrize("eager", [True, False])
def test_fused_traverse_regimes_match_plain(cuda, R, t, P, B, eager):
    """K6 on both sides of the warp regime's limit, with tied distances, all
    visited worklists, rows with no fresh lane, pads and inactive queries:
    the plain version's bits, one launch a call."""
    inputs = _tail_traverse_inputs(np.random.default_rng(R * 1000 + t + B), B, R, t)
    before = step_ops.fused_traverse.launches
    outs = _port_traverse(inputs, eager, device=cuda)
    assert step_ops.fused_traverse.launches == before + 1
    _assert_same(outs, _port_traverse(inputs, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("R,t,P", TAIL_RT_P)
@pytest.mark.parametrize("B", TAIL_B)
@pytest.mark.parametrize("eager", [True, False])
def test_search_step_regimes_match_plain(cuda, R, t, P, B, eager):
    """K1 with the same rows (ties from a 0/1 table): its tail on both sides
    of the warp regime's limit, the plain version's bits."""
    inputs = _tail_inputs(np.random.default_rng(R * 1000 + t + B + 7), B, R, t)
    before = step_ops.fused_step.launches
    outs = _port_step(inputs, eager, device=cuda)
    assert step_ops.fused_step.launches == before + 1
    _assert_same(outs, _port_step(inputs, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("R,t", [(64, 64), (31, 16), (64, 448)])
def test_fused_traverse_block_shapes_match_plain(cuda, warps, R, t):
    """Every queries-a-block count that chip_smoke.py times, and the block
    regime (warps = 0) below the limit too, give the same bits."""
    inputs = _tail_traverse_inputs(np.random.default_rng(warps + R + t), 1023, R, t)
    dev = [torch.from_numpy(a).to(cuda) for a in inputs]
    for eager in (True, False):
        wl, u, a = step_ops._traverse(Worklist(*dev[2:5]), dev[0], dev[1], dev[5], eager=eager, warps=warps)
        _assert_same([x.cpu().numpy() for x in (wl.dists, wl.ids, wl.visited, u, a)],
                     _port_traverse(inputs, eager))


@pytest.mark.cuda
def test_fused_traverse_warp_regime_refuses_what_it_cannot_hold(cuda):
    """Beyond WARP_MAX_P slots, or beyond 8 queries a block, the warp regime
    refuses the launch."""
    for t, warps in ((500, 4), (64, 9)):
        inputs = _tail_traverse_inputs(np.random.default_rng(0), 4, 64, t)
        dev = [torch.from_numpy(a).to(cuda) for a in inputs]
        with pytest.raises(RuntimeError, match="fused_traverse"):
            step_ops._traverse(Worklist(*dev[2:5]), dev[0], dev[1], dev[5], eager=True, warps=warps)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,m", ADC_SHAPES)
def test_pq_adc_kernel_matches_plain(cuda, B, R, m):
    rng = np.random.default_rng(B + R + m)
    table = torch.from_numpy((rng.standard_normal((B, m, 256)) ** 2).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (B, R, m)).astype(np.int32))
    valid = torch.from_numpy(rng.random((B, R)) > 0.25)
    before = adc_ops.adc.launches
    out = adc_ops.adc(table.to(cuda), codes.to(cuda), valid.to(cuda))
    assert adc_ops.adc.launches == before + 1
    np.testing.assert_array_equal(out.cpu().numpy(), adc_ops.adc_ref(table, codes, valid).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,d", RERANK_SHAPES)
def test_rerank_l2_kernel_matches_plain(cuda, B, C, d):
    rng = np.random.default_rng(B + C + d)
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, C, d)).astype(np.float32))
    before = rr_ops.exact_sq_dists.launches
    out = rr_ops.exact_sq_dists(q.to(cuda), v.to(cuda))
    assert rr_ops.exact_sq_dists.launches == before + 1
    np.testing.assert_array_equal(out.cpu().numpy(), rr_ops.exact_sq_dists_ref(q, v).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("R", ADC_REGIME_R)
@pytest.mark.parametrize("m", ADC_REGIME_M)
@pytest.mark.parametrize("code_dtype", [torch.int32, torch.uint8])
def test_pq_adc_regimes_match_plain(cuda, R, m, code_dtype):
    """Both regimes, and the wrapper's choice between them, bit-equal to the
    plain version, on all-valid and owner-style masked flags and under both
    variant names; one launch a call."""
    B = 3
    rng = np.random.default_rng(R * 100 + m)
    table = torch.from_numpy((rng.standard_normal((B, m, 256)) ** 2).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (B, R, m))).to(code_dtype)
    for valid in (torch.ones((B, R), dtype=torch.bool), torch.from_numpy(rng.random((B, R)) > 0.75)):
        plain = adc_ops.adc_ref(table, codes, valid).numpy()
        dev = [x.to(cuda) for x in (table, codes, valid)]
        for variant in ("onehot", "gather"):
            before = adc_ops.adc.launches
            out = adc_ops.adc(*dev, variant=variant)
            assert adc_ops.adc.launches == before + 1
            np.testing.assert_array_equal(out.cpu().numpy(), plain)
        for shared_table in (False, True):
            before = adc_ops.adc.launches
            out = adc_ops._adc_regime(*dev, shared_table=shared_table)
            assert adc_ops.adc.launches == before + 1
            np.testing.assert_array_equal(out.cpu().numpy(), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,d", RERANK_TILE_SHAPES)
def test_rerank_l2_tiles_match_plain(cuda, B, C, d):
    rng = np.random.default_rng(B * 1000 + C + d)
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    v = torch.from_numpy((rng.standard_normal((B, C, d)) + 3.0).astype(np.float32))
    before = rr_ops.exact_sq_dists.launches
    out = rr_ops.exact_sq_dists(q.to(cuda), v.to(cuda))
    assert rr_ops.exact_sq_dists.launches == before + 1
    np.testing.assert_array_equal(out.cpu().numpy(), rr_ops.exact_sq_dists_ref(q, v).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1e-30, 1e-19, 1.0, 1e18, 1e30])
def test_rerank_l2_rounding_edges(cuda, scale):
    """K3 rounds its partials to float32 in float64 arithmetic while they stay
    in float32's normal range and falls back to conversions elsewhere: tiny
    and huge values, zeros, and overflow to inf and NaN give the plain
    version's bits."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    B, C, d = 4, 104, 128
    q = (rng.standard_normal((B, d)) * scale).astype(np.float32)
    v = (rng.standard_normal((B, C, d)) * scale).astype(np.float32)
    v[rng.random(v.shape) < 0.5] = 0.0
    q[rng.random(q.shape) < 0.3] = 0.0
    q, v = torch.from_numpy(q).to(cuda), torch.from_numpy(v).to(cuda)
    out = rr_ops.exact_sq_dists(q, v)
    # The plain version on the card too: it makes the same NaN as the kernel.
    ref = rr_ops.exact_sq_dists_ref(q, v)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_rerank_l2_largest_d(cuda):
    """K3's shared memory grows with d (csrc/rerank_l2.cu): d = 7,380 is the
    largest that fits the H100's 227 KB at C >= 128 and gives the plain
    version's bits; one float4 wider, the launch is refused and raises, and
    the next launch runs."""
    B, C, d_max = 1, 128, 7380
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((B, d_max)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, C, d_max)).astype(np.float32))
    out = rr_ops.exact_sq_dists(q.to(cuda), v.to(cuda))
    np.testing.assert_array_equal(out.cpu().numpy(), rr_ops.exact_sq_dists_ref(q, v).numpy())
    with pytest.raises(RuntimeError):
        rr_ops.exact_sq_dists(torch.zeros((B, d_max + 4), device=cuda),
                              torch.zeros((B, C, d_max + 4), device=cuda))
    out = rr_ops.exact_sq_dists(q.to(cuda), v.to(cuda))
    np.testing.assert_array_equal(out.cpu().numpy(), rr_ops.exact_sq_dists_ref(q, v).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m", LOOKUP_M)
@pytest.mark.parametrize("eager", [True, False])
@pytest.mark.parametrize("integer_table", [True, False])
def test_search_step_fresh_counts_match_plain(cuda, m, eager, integer_table):
    """K1 at the main path's R = t = 64, one launch whose queries hold none,
    one, a quarter, half, all but one and all lanes fresh: the plain
    version's bits; one launch a call."""
    R, t, n = 64, 64, 5000
    counts = _lane_counts(R)
    rng = np.random.default_rng(m * 4 + 2 * eager + integer_table)
    inputs = list(_step_inputs(rng, len(counts), R, t, m, n, integer_table))
    inputs[3] = _exactly(rng, counts, R)
    before = step_ops.fused_step.launches
    outs = _port_step(inputs, eager, device=cuda)
    assert step_ops.fused_step.launches == before + 1
    _assert_same(outs, _port_step(inputs, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("m", LOOKUP_M)
@pytest.mark.parametrize("R", LOCAL_ADC_LOOKUP_R)
@pytest.mark.parametrize("integer_table", [True, False])
def test_local_adc_owned_counts_match_plain(cuda, m, R, integer_table):
    """K7, one launch whose queries own none, one, a quarter, half, all but
    one and all lanes (at R = 1, the medoid seed: none or the one lane):
    the plain version's bits, exact zeros where not owned; one launch a
    call."""
    n_loc = 3000
    counts = _lane_counts(R)
    rng = np.random.default_rng(m * 10 + R + integer_table)
    if integer_table:
        table = rng.integers(0, 1000, (len(counts), m, 256)).astype(np.float32)
    else:
        table = (rng.standard_normal((len(counts), m, 256)) ** 2).astype(np.float32)
    codes = rng.integers(0, 256, (n_loc, m)).astype(np.uint8)
    rel = rng.integers(0, n_loc, (len(counts), R)).astype(np.int32)
    own = _exactly(rng, counts, R)
    cpu = [torch.from_numpy(x) for x in (table, codes, rel, own)]
    before = step_ops.local_adc.launches
    out = step_ops.local_adc(*(x.to(cuda) for x in cpu)).cpu()
    assert step_ops.local_adc.launches == before + 1
    np.testing.assert_array_equal(out.numpy(), step_ops.local_adc_ref(*cpu).numpy())
    assert (out[~cpu[3]] == 0.0).all()


@pytest.mark.cuda
def test_search_step_and_local_adc_take_any_table_width(cuda):
    """K1 and K7 look the table up in global memory and keep no copy of it in
    shared memory, so they serve tables of any width (m = 256: 256 KB a
    query, beyond one block's shared memory)."""
    B, R, t, m, n = 2, 64, 4, 256, 50
    inputs = list(_step_inputs(np.random.default_rng(5), B, R, t, m, n))
    _assert_same(_port_step(inputs, True, device=cuda), _port_step(inputs, True))
    table, codes, nbrs, fresh = (torch.from_numpy(x) for x in inputs[:4])
    out = step_ops.local_adc(*(x.to(cuda) for x in (table, codes, nbrs, fresh)))
    np.testing.assert_array_equal(out.cpu().numpy(), step_ops.local_adc_ref(table, codes, nbrs, fresh).numpy())


@pytest.mark.cuda
def test_kernels_take_unaligned_inputs(cuda):
    """Contiguous views that start off a 16-byte boundary take the kernels'
    narrower copies, with the same bits."""
    rng = np.random.default_rng(7)
    B, R, m, C, d = 3, 64, 32, 104, 128
    table = torch.from_numpy((rng.standard_normal((B, m, 256)) ** 2).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (B, R, m)).astype(np.uint8))
    valid = torch.from_numpy(rng.random((B, R)) > 0.25)
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, C, d)).astype(np.float32))

    def shifted(x):   # a contiguous copy of x, one element past an aligned start
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        out = buf[1:].view(x.shape)
        out.copy_(x.to(cuda))
        return out

    for shared_table in (False, True):
        out = adc_ops._adc_regime(shifted(table), shifted(codes), valid.to(cuda), shared_table=shared_table)
        np.testing.assert_array_equal(out.cpu().numpy(), adc_ops.adc_ref(table, codes, valid).numpy())
    out = rr_ops.exact_sq_dists(shifted(q), shifted(v))
    np.testing.assert_array_equal(out.cpu().numpy(), rr_ops.exact_sq_dists_ref(q, v).numpy())
    # K1 and K7: code rows off a 16-byte boundary are read byte by byte.
    inputs = list(_step_inputs(rng, B, R, 64, m, 500))
    tb, rows, nbrs, fresh, wd, wi, wv, active = (torch.from_numpy(x) for x in inputs)
    dev = [shifted(x) for x in (tb, rows, nbrs, fresh, wd, wi, wv, active)]
    wl, u, a = step_ops.fused_step(dev[0], dev[1], Worklist(*dev[4:7]), dev[2], dev[3], dev[7])
    _assert_same([x.cpu().numpy() for x in (wl.dists, wl.ids, wl.visited, u, a)], _port_step(inputs, True))
    out = step_ops.local_adc(*dev[:4])
    np.testing.assert_array_equal(out.cpu().numpy(), step_ops.local_adc_ref(tb, rows, nbrs, fresh).numpy())
    # K5 in both regimes: rows off a 4-byte (flags) and 16-byte boundary.
    from repro_torch.kernels.bitonic import ops as bitonic_ops

    cd = torch.from_numpy(np.sort(rng.integers(0, 5000, (B, R)).astype(np.float32), axis=-1))
    ci = torch.from_numpy(np.arange(B * R, dtype=np.int32).reshape(B, R) + 10_000)
    for per_block in (0, bitonic_ops.MERGE_ROWS):
        out = bitonic_ops._merge(Worklist(*dev[4:7]), shifted(cd), shifted(ci), rows=per_block)
        for o, r in zip(out, bitonic_ops.merge_ref(wd, wi, wv, cd, ci)):
            assert torch.equal(o.cpu(), r)
    # K8 in both regimes: query and codebook rows off a 16-byte boundary.
    for dsub in (4, 32):
        qs = torch.from_numpy(rng.standard_normal((B, m, dsub)).astype(np.float32))
        cb = torch.from_numpy(rng.standard_normal((m, 256, dsub)).astype(np.float32))
        out = table_ops.dist_table(shifted(qs), shifted(cb))
        np.testing.assert_array_equal(out.cpu().numpy(), table_ops.dist_table_ref(qs, cb).numpy())


@pytest.mark.cuda
def test_wrappers_raise_on_bad_cuda_inputs(cuda):
    q = torch.zeros(2, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        rr_ops.exact_sq_dists(q, torch.zeros(2, 3, 8, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="devices"):
        rr_ops.exact_sq_dists(torch.zeros(2, 8), torch.zeros(2, 3, 8, device=cuda))


@pytest.mark.cuda
def test_kernels_raise_beyond_shared_memory(cuda):
    # m = 256: a 256 KB table per block, beyond the H100's 227 KB. K2 copies
    # the table to shared memory only from SHARED_TABLE_MIN_R candidates on;
    # K1 keeps no copy of it and serves this width
    # (test_search_step_and_local_adc_take_any_table_width).
    B, m = 2, 256
    R = adc_ops.SHARED_TABLE_MIN_R
    table = torch.zeros((B, m, 256), device=cuda)
    codes = torch.zeros((B, R, m), dtype=torch.int32, device=cuda)
    valid = torch.ones((B, R), dtype=torch.bool, device=cuda)
    with pytest.raises(RuntimeError, match="pq_adc"):
        adc_ops.adc(table, codes, valid)
    # The refusals leave no error behind for the next launch to report.
    m = 32
    out = adc_ops.adc(torch.zeros((B, m, 256), device=cuda),
                      torch.zeros((B, R, m), dtype=torch.int32, device=cuda), valid)
    assert torch.equal(out.cpu(), torch.zeros((B, R)))


@pytest.mark.cuda
def test_pq_adc_global_lookups_need_no_shared_memory(cuda):
    """Below SHARED_TABLE_MIN_R, K2 serves tables of any width (m = 256:
    256 KB a query, beyond one block's shared memory)."""
    B, R, m = 2, 1, 256
    rng = np.random.default_rng(3)
    table = torch.from_numpy((rng.standard_normal((B, m, 256)) ** 2).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (B, R, m)).astype(np.uint8))
    valid = torch.ones((B, R), dtype=torch.bool)
    out = adc_ops.adc(table.to(cuda), codes.to(cuda), valid.to(cuda))
    np.testing.assert_array_equal(out.cpu().numpy(), adc_ops.adc_ref(table, codes, valid).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,m,n_loc", LOCAL_ADC_SHAPES)
@pytest.mark.parametrize("integer_table", [True, False])
def test_local_adc_kernel_matches_plain(cuda, B, R, m, n_loc, integer_table):
    """Bit-equal on float tables too (the same chunked sum); exact zeros on
    the lanes not owned; tile_rows changes no bit."""
    rng = np.random.default_rng(B + R + m)
    if integer_table:
        table = rng.integers(0, 1000, (B, m, 256)).astype(np.float32)
    else:
        table = (rng.standard_normal((B, m, 256)) ** 2).astype(np.float32)
    codes = rng.integers(0, 256, (n_loc, m)).astype(np.uint8)
    rel = rng.integers(0, n_loc, (B, R)).astype(np.int32)
    own = rng.random((B, R)) > 0.4
    cpu = [torch.from_numpy(x) for x in (table, codes, rel, own)]
    dev = [x.to(cuda) for x in cpu]
    before = step_ops.local_adc.launches
    out = step_ops.local_adc(*dev)
    assert step_ops.local_adc.launches == before + 1
    np.testing.assert_array_equal(out.cpu().numpy(), step_ops.local_adc_ref(*cpu).numpy())
    assert (out.cpu()[~cpu[3]] == 0.0).all()
    for tile_rows in (8, 4096):
        assert torch.equal(step_ops.local_adc(*dev, tile_rows=tile_rows), out)


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,dsub", TABLE_SHAPES + [(1024, 32, 4)])
def test_dist_table_kernel_matches_plain(cuda, B, m, dsub):
    """The same sums in the same order: bit-equal."""
    rng = np.random.default_rng(B + m + dsub)
    q = torch.from_numpy(rng.standard_normal((B, m, dsub)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((m, 256, dsub)).astype(np.float32))
    before = table_ops.dist_table.launches
    out = table_ops.dist_table(q.to(cuda), cb.to(cuda))
    assert table_ops.dist_table.launches == before + 1
    np.testing.assert_array_equal(out.cpu().numpy(), table_ops.dist_table_ref(q, cb).numpy())


@functools.cache
def _table_case(dsub):
    """K8's inputs at dsub and their plain table, made once for every tile:
    B = 1031, not a multiple of any tile, and m = 256 / dsub subspaces."""
    B, m = 1031, max(1, 256 // dsub)
    rng = np.random.default_rng(dsub)
    q = torch.from_numpy(rng.standard_normal((B, m, dsub)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((m, 256, dsub)).astype(np.float32))
    return q, cb, table_ops.dist_table_ref(q, cb)


@pytest.mark.cuda
@pytest.mark.parametrize("dsub", TABLE_DSUB)
@pytest.mark.parametrize("queries", TABLE_TILES)
def test_dist_table_regimes_match_plain(cuda, dsub, queries):
    """K8 at every tile chip_smoke.py times and in its general
    regime: the plain version's bits. Beyond TILE_MAX_DSUB the tile regime
    refuses the launch."""
    q, cb, want = _table_case(dsub)
    if queries and dsub > table_ops.TILE_MAX_DSUB:
        with pytest.raises(RuntimeError, match="pq_table"):
            table_ops._dist_table(q.to(cuda), cb.to(cuda), queries=queries)
        return
    out = table_ops._dist_table(q.to(cuda), cb.to(cuda), queries=queries)
    assert torch.equal(out.cpu(), want)
