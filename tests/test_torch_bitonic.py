"""Port kernels K4 (bitonic sort) and K5 (bitonic worklist merge) vs the
reference's Pallas kernels (interpret mode) and its ref.py oracles.

On the CPU the wrappers run their plain versions, which run the Pallas
kernels' compare-exchange network stage by stage: dists, ids and visited
flags must equal `sort_kv_pallas` / `merge_pallas` bit for bit, the visited
flags of (+inf, INVALID) pad slots included. Against the reference's stable
lax.sort oracles, dists and ids are bit-exact and the visited flags of real
entries too (real (dist, id) keys are unique; only pads tie).

The `cuda` cases hold the CUDA kernels against their plain versions on the
card; they skip where there is no GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.worklist import INVALID_ID, Worklist
from repro_torch.kernels.bitonic import ops
from repro_torch.kernels.common import next_pow2

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

SORT_SHAPES = [(1, 2), (5, 16), (9, 23), (3, 64), (2, 100)]     # tests/test_kernels.py:52
MERGE_SHAPES = [(1, 4, 4), (6, 16, 12), (3, 64, 64), (2, 33, 7)]  # tests/test_kernels.py:66
# Row lengths of K4 around a warp (32), the main path's R (64) and the warp
# regime's limit (ops.WARP_MAX_P = 512).
SORT_N = [1, 2, 3, 31, 32, 33, 64, 100, 512, 513, 1000]
# (t, R) of K5 with the merge row's p = next_pow2(t + R): p from 2 to 1024,
# a partial warp at p < 32, t + R not a power of two, the main path's
# t = R = 64, the paper's t = 152 and both sides of the warp regime's limit
# (ops.WARP_MAX_P = 512).
MERGE_TR_P = [(1, 1, 2), (4, 4, 8), (3, 10, 16), (33, 7, 64), (64, 64, 128), (152, 64, 256),
              (448, 64, 512), (100, 300, 512), (500, 64, 1024), (513, 1, 1024)]
# Batches that are and are not a multiple of K5's rows a block.
MERGE_B = [1, 5, 1023, 1024]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sort_inputs(rng, B, n):
    """The reference test's draw: duplicate dists exercise the id tie-break."""
    d = rng.standard_normal((B, n)).astype(np.float32)
    d = np.concatenate([d[:, : n // 2], d[:, : n - n // 2]], axis=-1)
    i = rng.integers(0, 10_000, (B, n)).astype(np.int32)
    return d, i


def _merge_inputs(rng, B, t, R, pads: bool):
    """Sorted worklist (ids < 1000) and sorted candidates (ids >= 1000).
    With `pads`, each row ends in a random number of (+inf, INVALID) pads:
    visited in the worklist, unvisited among the candidates."""
    wd = np.sort(rng.standard_normal((B, t)).astype(np.float32), axis=-1)
    wi = rng.integers(0, 1000, (B, t)).astype(np.int32)
    wv = rng.random((B, t)) > 0.5
    cd = np.sort(rng.standard_normal((B, R)).astype(np.float32), axis=-1)
    ci = rng.integers(1000, 2000, (B, R)).astype(np.int32)
    if pads:
        for b in range(B):
            w, c = int(rng.integers(0, t + 1)), int(rng.integers(0, R + 1))
            wd[b, w:], wi[b, w:], wv[b, w:] = np.inf, INVALID_ID, True
            cd[b, c:], ci[b, c:] = np.inf, INVALID_ID
    return wd, wi, wv, cd, ci


def _port_merge(inputs, device="cpu"):
    wd, wi, wv, cd, ci = (torch.from_numpy(a).to(device) for a in inputs)
    out = ops.merge_worklist(Worklist(wd, wi, wv), cd, ci)
    return [x.cpu().numpy() for x in out]


@pytest.mark.parametrize("B,n", SORT_SHAPES)
def test_sort_ref_matches_pallas_and_reference_oracle(B, n):
    import jax.numpy as jnp
    from repro.kernels.bitonic.bitonic import sort_kv_pallas
    from repro.kernels.bitonic.ref import sort_kv_ref as jsort_ref

    d, i = _sort_inputs(np.random.default_rng(B * 100 + n), B, n)
    sd, si = (x.numpy() for x in ops.sort_kv(torch.from_numpy(d), torch.from_numpy(i)))
    for ref in (sort_kv_pallas(jnp.asarray(d), jnp.asarray(i), interpret=True),
                jsort_ref(jnp.asarray(d), jnp.asarray(i))):
        np.testing.assert_array_equal(sd, np.asarray(ref[0]))
        np.testing.assert_array_equal(si, np.asarray(ref[1]))


@pytest.mark.parametrize("B,t,R", MERGE_SHAPES)
@pytest.mark.parametrize("pads", [False, True])
def test_merge_ref_matches_pallas_and_reference_oracle(B, t, R, pads):
    import jax.numpy as jnp
    from repro.kernels.bitonic.bitonic import merge_pallas
    from repro.kernels.bitonic.ref import merge_ref as jmerge_ref

    inputs = _merge_inputs(np.random.default_rng(B * 1000 + t * 10 + R), B, t, R, pads)
    j = [jnp.asarray(a) for a in inputs]
    md, mi, mv = _port_merge(inputs)
    # Bit for bit against the Pallas network, pad slots' visited flags included.
    for o, r in zip((md, mi, mv), merge_pallas(*j, t=t, interpret=True)):
        np.testing.assert_array_equal(o, np.asarray(r))
    rd, ri, rv = (np.asarray(x) for x in jmerge_ref(*j, t))
    np.testing.assert_array_equal(md, rd)
    np.testing.assert_array_equal(mi, ri)
    real = mi != INVALID_ID
    np.testing.assert_array_equal(mv[real], rv[real])


def test_merge_with_many_pads_matches_pallas():
    """Rows that are mostly pads, so the kept t slots hold pads of both
    lists: the visited flag each keeps is the network's choice."""
    import jax.numpy as jnp
    from repro.kernels.bitonic.bitonic import merge_pallas

    rng = np.random.default_rng(7)
    for B, t, R in ((16, 16, 12), (16, 64, 64), (8, 8, 24)):
        inputs = _merge_inputs(rng, B, t, R, pads=True)
        outs = _port_merge(inputs)
        assert (outs[1] == INVALID_ID).any()
        for o, r in zip(outs, merge_pallas(*map(jnp.asarray, inputs), t=t, interpret=True)):
            np.testing.assert_array_equal(o, np.asarray(r))


def test_wrappers_check_inputs_on_the_cpu_and_count_no_launch():
    d, i = _sort_inputs(np.random.default_rng(0), 2, 8)
    before = (ops.sort_kv.launches, ops.merge_worklist.launches)
    ops.sort_kv(torch.from_numpy(d), torch.from_numpy(i))
    _port_merge(_merge_inputs(np.random.default_rng(0), 2, 4, 4, pads=False))
    assert (ops.sort_kv.launches, ops.merge_worklist.launches) == before
    with pytest.raises(ValueError, match="devices"):
        ops.sort_kv(torch.from_numpy(d), torch.from_numpy(i).to("meta"))


@pytest.mark.parametrize("n", SORT_N)
def test_sort_regime_choice(n):
    """K4: the warp regime, SORT_ROWS rows a block, up to WARP_MAX_P; the
    block regime beyond. On the CPU the wrapper runs its plain version at
    every block shape and counts no launch. Integer-valued inputs only (no
    random floats)."""
    p = next_pow2(n)
    rows = ops.sort_rows(p)
    assert rows == (ops.SORT_ROWS if p <= ops.WARP_MAX_P else 0)
    assert 1 <= ops.SORT_ROWS <= 8 and ops.WARP_MAX_P == 512
    d = ((torch.arange(3 * n) * 7) % 5).float().reshape(3, n)
    i = torch.arange(3 * n, dtype=torch.int32).flip(0).reshape(3, n)
    want = ops.sort_kv_ref(d, i)
    before = ops.sort_kv.launches
    for got in (ops.sort_kv(d, i), ops._sort(d, i, rows=0), ops._sort(d, i, rows=rows)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.sort_kv.launches == before


@pytest.mark.parametrize("t,R,p", MERGE_TR_P)
def test_merge_regime_choice(t, R, p):
    """K5: the warp regime, MERGE_ROWS rows a block, up to WARP_MAX_P; the
    block regime beyond. On the CPU the wrapper runs its plain version at
    every block shape and counts no launch. Integer-valued inputs only (no
    random floats), sorted by (dist, id), with pads in both lists."""
    assert next_pow2(t + R) == p
    rows = ops.merge_rows(p)
    assert rows == (ops.MERGE_ROWS if p <= ops.WARP_MAX_P else 0)
    assert 1 <= ops.MERGE_ROWS <= 8
    B = 3
    wd = (torch.arange(B * t) % t // 2).float().reshape(B, t)
    wi = torch.arange(B * t, dtype=torch.int32).reshape(B, t)
    wv = (torch.arange(B * t) % 3 == 0).reshape(B, t)
    wd[0, t // 2 :], wi[0, t // 2 :], wv[0, t // 2 :] = float("inf"), INVALID_ID, True
    cd = (torch.arange(B * R) % R // 3).float().reshape(B, R)
    ci = (10_000 + torch.arange(B * R, dtype=torch.int32)).reshape(B, R)
    cd[1, R // 2 :], ci[1, R // 2 :] = float("inf"), INVALID_ID
    wl = Worklist(wd, wi, wv)
    want = ops.merge_ref(wd, wi, wv, cd, ci)
    before = ops.merge_worklist.launches
    for got in (ops.merge_worklist(wl, cd, ci), ops._merge(wl, cd, ci, rows=0),
                ops._merge(wl, cd, ci, rows=rows)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert ops.merge_worklist.launches == before


# ------------------------------------------------------ CUDA kernels (card)
@pytest.mark.cuda
@pytest.mark.parametrize("B,n", SORT_SHAPES + [(1024, 64)])
def test_sort_kernel_matches_plain(cuda, B, n):
    d, i = (torch.from_numpy(a) for a in _sort_inputs(np.random.default_rng(B + n), B, n))
    before = ops.sort_kv.launches
    out = ops.sort_kv(d.to(cuda), i.to(cuda))
    assert ops.sort_kv.launches == before + 1
    for o, r in zip(out, ops.sort_kv_ref(d, i)):
        assert torch.equal(o.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("B,t,R", MERGE_SHAPES + [(1024, 64, 64)])
@pytest.mark.parametrize("pads", [False, True])
def test_merge_kernel_matches_plain(cuda, B, t, R, pads):
    inputs = _merge_inputs(np.random.default_rng(B + t + R), B, t, R, pads)
    before = ops.merge_worklist.launches
    outs = _port_merge(inputs, device=cuda)
    assert ops.merge_worklist.launches == before + 1
    for o, r in zip(outs, _port_merge(inputs)):
        np.testing.assert_array_equal(o, r)


def _tied_sort_inputs(rng, B, n):
    """Distances from a few values, so most keys tie on the distance, beside
    ids distinct within a row."""
    d = rng.integers(0, 4, (B, n)).astype(np.float32)
    i = np.stack([rng.permutation(10 * n)[:n] for _ in range(B)]).astype(np.int32)
    return d, i


@pytest.mark.cuda
@pytest.mark.parametrize("n", SORT_N)
@pytest.mark.parametrize("B", [5, 1023])
def test_sort_regimes_match_plain_on_tied_distances(cuda, n, B):
    """K4 on both sides of the warp regime's limit, B not a multiple of the
    rows a block: the plain version's bits, one launch a call."""
    d, i = (torch.from_numpy(a) for a in _tied_sort_inputs(np.random.default_rng(n + B), B, n))
    before = ops.sort_kv.launches
    out = ops.sort_kv(d.to(cuda), i.to(cuda))
    assert ops.sort_kv.launches == before + 1
    for o, r in zip(out, ops.sort_kv_ref(d, i)):
        assert torch.equal(o.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("n", [33, 64, 512])
def test_sort_block_shapes_match_plain(cuda, rows, n):
    """Every rows-a-block count that chip_smoke.py times, and the block
    regime (rows = 0) below the limit too, give the same bits."""
    d, i = (torch.from_numpy(a) for a in _tied_sort_inputs(np.random.default_rng(rows + n), 1023, n))
    out = ops._sort(d.to(cuda), i.to(cuda), rows=rows)
    for o, r in zip(out, ops.sort_kv_ref(d, i)):
        assert torch.equal(o.cpu(), r)


@pytest.mark.cuda
def test_sort_warp_regime_refuses_what_it_cannot_hold(cuda):
    """Beyond WARP_MAX_P, or beyond 8 rows a block, the warp regime refuses
    the launch."""
    for n, rows in ((513, 4), (64, 9)):
        d = torch.zeros((2, n), device=cuda)
        with pytest.raises(RuntimeError, match="bitonic sort"):
            ops._sort(d, torch.zeros((2, n), dtype=torch.int32, device=cuda), rows=rows)


def _merge_case_inputs(rng, B, t, R):
    """Sorted worklists and candidates whose rows cycle through the cases
    K5 must keep to the plain version's bits. Row b % 5 == 0: random; 1:
    distances from a few values, tied within and across the two lists, ids
    distinct; 2: a worklist all visited; 3: pads ending both lists; 4: rows
    mostly pads, so the kept slots hold pads of both lists. Worklist pads
    are (+inf, INVALID, visited), candidate pads (+inf, INVALID). Both lists
    are sorted by (dist, id), as the merge assumes."""
    kind = np.arange(B) % 5
    wd = rng.integers(0, 5000, (B, t)).astype(np.float32)
    cd = rng.integers(0, 5000, (B, R)).astype(np.float32)
    wd[kind == 1] = rng.integers(0, 4, (int((kind == 1).sum()), t))
    cd[kind == 1] = rng.integers(0, 4, (int((kind == 1).sum()), R))
    ids = np.stack([rng.permutation(10 * (t + R))[: t + R] for _ in range(B)]).astype(np.int32)
    wi, ci = ids[:, :t].copy(), ids[:, t:].copy()
    wv = rng.random((B, t)) > 0.5
    wv[kind == 2] = True
    for b in np.flatnonzero(kind >= 3):
        most = kind[b] == 4
        w = int(rng.integers(0, t // 4 + 1 if most else t + 1))
        c = int(rng.integers(0, R // 4 + 1 if most else R + 1))
        wd[b, w:], wi[b, w:], wv[b, w:] = np.inf, INVALID_ID, True
        cd[b, c:], ci[b, c:] = np.inf, INVALID_ID
    wo, co = np.lexsort((wi, wd), axis=-1), np.lexsort((ci, cd), axis=-1)
    wd, wi, wv = (np.take_along_axis(x, wo, -1) for x in (wd, wi, wv))
    cd, ci = (np.take_along_axis(x, co, -1) for x in (cd, ci))
    return wd, wi, wv, cd, ci


@pytest.mark.cuda
@pytest.mark.parametrize("t,R,p", MERGE_TR_P)
@pytest.mark.parametrize("B", MERGE_B)
def test_merge_regimes_match_plain(cuda, t, R, p, B):
    """K5 on both sides of the warp regime's limit, B a multiple of the rows
    a block and not: the plain version's bits, visited flags of pad slots
    included, one launch a call."""
    inputs = _merge_case_inputs(np.random.default_rng(t * 7 + R + B), B, t, R)
    before = ops.merge_worklist.launches
    outs = _port_merge(inputs, device=cuda)
    assert ops.merge_worklist.launches == before + 1
    for o, r in zip(outs, _port_merge(inputs)):
        np.testing.assert_array_equal(o, r)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("t,R", [(4, 4), (33, 7), (64, 64), (448, 64)])
def test_merge_block_shapes_match_plain(cuda, rows, t, R):
    """Every rows-a-block count that chip_smoke.py times, and the block
    regime (rows = 0) below the limit too, give the same bits."""
    inputs = _merge_case_inputs(np.random.default_rng(rows + t + R), 1023, t, R)
    wd, wi, wv, cd, ci = (torch.from_numpy(a) for a in inputs)
    out = ops._merge(Worklist(wd.to(cuda), wi.to(cuda), wv.to(cuda)), cd.to(cuda), ci.to(cuda),
                     rows=rows)
    for o, r in zip(out, ops.merge_ref(wd, wi, wv, cd, ci)):
        assert torch.equal(o.cpu(), r)


@pytest.mark.cuda
def test_merge_warp_regime_refuses_what_it_cannot_hold(cuda):
    """Beyond WARP_MAX_P, or beyond 8 rows a block, the warp regime refuses
    the launch."""
    for t, R, rows in ((500, 64, 4), (64, 64, 9)):
        wl = Worklist(torch.zeros((2, t), device=cuda), torch.zeros((2, t), dtype=torch.int32, device=cuda),
                      torch.zeros((2, t), dtype=torch.bool, device=cuda))
        with pytest.raises(RuntimeError, match="bitonic merge"):
            ops._merge(wl, torch.zeros((2, R), device=cuda),
                       torch.zeros((2, R), dtype=torch.int32, device=cuda), rows=rows)
