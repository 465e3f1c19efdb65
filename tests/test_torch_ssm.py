"""The ssm and hybrid families (mamba2, zamba2): the port held against the
reference.

Modules at reduced widths within rtol 1e-5, atol 1e-6, except where a
docstring names the operation whose order sets a looser bound; whole models
at float32 within rtol 1e-4, atol 1e-5 (prefill logits, every cache field,
3 exact-KV steps and, for zamba2, 3 BANG-KV steps from one state), and one
bf16 case per family at the reference's 2e-2. torch's float32 `cumsum` on
the CPU accumulates in float64 and XLA:CPU's in another order, so the port
is not bit-equal to the reference's SSD (ROADMAP C12).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as rssm
from repro_torch import convert
from repro_torch.models import ssm
from repro_torch.models.transformer import _pick_chunk

from _lm_parity import (ATOL, BF16_TOL, MODEL_ATOL, MODEL_RTOL, RTOL, bang_from_kv, close,
                        close_caches, pad_kv, pair, prompt, randn, t)

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core


def _ssd_inputs(seed, B, S, H, P, G, N, *, bc_scale=1.0, init=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0)).astype(np.float32)   # softplus
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    Bm = (bc_scale * rng.standard_normal((B, S, G, N))).astype(np.float32)
    Cm = (bc_scale * rng.standard_normal((B, S, G, N))).astype(np.float32)
    st = rng.standard_normal((B, H, P, N)).astype(np.float32) if init else None
    return x, dt, A, Bm, Cm, st


def _ssd_both(args, chunk):
    x, dt, A, Bm, Cm, st = args
    ref = rssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                           None if st is None else jnp.asarray(st))
    got = ssm.ssd_chunked(*map(t, (x, dt, A, Bm, Cm)), chunk, None if st is None else t(st))
    return got, ref


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [12, 2])
def test_causal_conv_matches_reference(S):
    """K = 4 taps summed in sequence; S = 2 is shorter than the window."""
    p = {"conv_w": randn(1, 4, 24, scale=0.5), "conv_b": randn(2, 24, scale=0.1)}
    xbc = randn(3, 2, S, 24)
    ref = rssm._causal_conv({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xbc))
    close(ssm._causal_conv({k: t(v) for k, v in p.items()}, t(xbc)), ref)


def test_segsum_matches_reference():
    """The two cumsums' difference: torch's float64 accumulation on the CPU
    against XLA's float32 order (ROADMAP C12)."""
    a = -np.abs(randn(4, 3, 5, 16, scale=0.3))
    ref = np.asarray(rssm._segsum(jnp.asarray(a)))
    got = ssm._segsum(t(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 9])
def test_associative_scan_equals_jax(n):
    """The odd/even recursion of `jax.lax.associative_scan`, step for step:
    the same products in the same order, so bit-equal at every length."""
    d = np.abs(randn(n, 3, n, 4)) + 0.5
    s = randn(n + 1, 3, n, 4, 2, 5)
    ref = jax.lax.associative_scan(
        lambda e1, e2: (e1[0] * e2[0], e1[1] * e2[0][..., None, None] + e2[1]),
        (jnp.asarray(d), jnp.asarray(s)), axis=1)
    got = ssm._associative_scan(ssm._combine, (t(d), t(s)), axis=1)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("nc", [1, 2, 3, 5])
def test_ssd_chunked_matches_reference(nc, G, init):
    Q = 8
    args = _ssd_inputs(nc * 10 + G, 2, nc * Q, 4, 8, G, 16, init=init)
    (y, st), (ry, rst) = _ssd_both(args, Q)
    close(y, ry)
    close(st, rst)


def test_ssd_chunked_at_the_real_chunk():
    """Q = 256, N = 128, P = 64, two chunks. The B·C dot products over N =
    128 and the sums over 256 positions round differently in the two
    packages (rtol 1e-4, atol 1e-5). B and C at the scale the model feeds
    (a tenth-scale conv of small projections): at unit scale |y| reaches 93
    and both packages lie 1e-4 from a float64 evaluation."""
    args = _ssd_inputs(7, 1, 512, 4, 64, 1, 128, bc_scale=0.5, init=True)
    (y, st), (ry, rst) = _ssd_both(args, 256)
    assert float(np.abs(np.asarray(ry)).max()) > 10.0
    close(y, ry, MODEL_RTOL, MODEL_ATOL)
    close(st, rst, MODEL_RTOL, MODEL_ATOL)


@pytest.mark.parametrize("S,Q,rtol,atol", [(15, 15, RTOL, ATOL), (2047, 89, MODEL_RTOL, MODEL_ATOL)])
def test_ssd_chunked_takes_any_prompt_length(S, Q, rtol, atol):
    """`_pick_chunk(S, 256)`, as the model picks it: the largest divisor of
    S up to the config's chunk (15 is one chunk of 15, 2,047 = 23 x 89).
    At 2,047 the sums over 89 positions and the state carried through 23
    chunks round differently in the two packages (each lies up to 4e-6
    from a float64 evaluation), so that case takes the real chunk's rtol
    1e-4, atol 1e-5."""
    assert _pick_chunk(S, 256) == Q
    args = _ssd_inputs(S, 1, S, 4, 8, 1, 16, bc_scale=0.5)
    (y, st), (ry, rst) = _ssd_both(args, Q)
    close(y, ry, rtol, atol)
    close(st, rst, rtol, atol)


def _block_params(seed, D=32, expand=2, N=8, K=4, P=8, G=2):
    di = expand * D
    H = di // P
    rng = np.random.default_rng(seed)
    p = {"in_proj": (0.2 * rng.standard_normal((D, 2 * di + 2 * G * N + H))).astype(np.float32),
         "conv_w": (0.3 * rng.standard_normal((K, di + 2 * G * N))).astype(np.float32),
         "conv_b": (0.1 * rng.standard_normal(di + 2 * G * N)).astype(np.float32),
         "A_log": (0.3 * rng.standard_normal(H)).astype(np.float32),
         "D": (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32),
         "dt_bias": (-2.0 + 0.3 * rng.standard_normal(H)).astype(np.float32),
         "norm_w": (0.1 * rng.standard_normal(di)).astype(np.float32),
         "out_proj": (0.2 * rng.standard_normal((di, D))).astype(np.float32)}
    return p, dict(expand=expand, state=N, conv=K, head_dim=P, groups=G)


@pytest.mark.parametrize("S", [12, 2])
def test_ssm_block_prefill_and_decode_match_reference(S):
    """Prefill with `return_cache` (S = 2 pads the conv window), then 3
    decode steps from the reference's cache carried across: outputs and
    both cache fields. The float32 model's window holds float32 entries
    from the second step on, as the reference's promoted concatenation."""
    p, kw = _block_params(S)
    x = randn(S + 1, 2, S + 3, 32)
    rp, tp = {k: jnp.asarray(v) for k, v in p.items()}, {k: t(v) for k, v in p.items()}
    ry, rc = rssm.ssm_block(rp, jnp.asarray(x[:, :S]), chunk=_pick_chunk(S, 4), return_cache=True,
                            **kw)
    y, c = ssm.ssm_block(tp, t(x[:, :S]), chunk=_pick_chunk(S, 4), return_cache=True, **kw)
    close(y, ry)
    assert rc.conv.dtype == jnp.bfloat16 and c.conv.dtype == torch.float32
    close_caches(c, rc, RTOL, ATOL)
    cache = convert.ssm_caches_from_reference(jax.tree.map(np.asarray, rc), dtype=torch.float32,
                                              device="cpu")
    for s in range(S, S + 3):
        ry, rc = rssm.ssm_block(rp, jnp.asarray(x[:, s:s + 1]), chunk=1, cache=rc, **kw)
        y, cache = ssm.ssm_block(tp, t(x[:, s:s + 1]), chunk=1, cache=cache, **kw)
        close(y, ry)
        close_caches(cache, rc, RTOL, ATOL)
    assert rc.conv.dtype == jnp.float32


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def _run_both(name, dtype, S, steps, rtol, atol):
    """Prefill both packages from one state; then `steps` exact-KV steps
    and, for zamba2, `steps` BANG-KV steps (the reference's codebooks, the
    prompt's keys encoded by the reference) from the reference's caches
    carried across: every logit and every cache within the bound."""
    rlm, rparams, lm = pair(name, dtype=dtype)
    cfg = lm.cfg
    B = 2
    tokens, batch = prompt(cfg, len(name) + S, B, S, steps)
    rl, rc = jax.jit(rlm.prefill)(rparams, jax.tree.map(jnp.asarray, batch))
    pl, pc = lm.prefill(jax.tree.map(t, batch), s_max=S + steps)
    close(pl, rl, rtol, atol)
    hybrid = cfg.family == "hybrid"
    if hybrid:
        rc = (rc[0], pad_kv(rc[1], steps))
    close_caches(pc, rc, rtol, atol)

    ref_caches = {False: rc}
    if hybrid:
        ref_caches[True] = (rc[0], bang_from_kv(rparams["bangkv_codebooks"], rc[1]))
    for bangkv, ref in ref_caches.items():
        caches = convert.lm_caches_from_reference(jax.tree.map(np.asarray, ref), cfg, device="cpu")
        step = jax.jit(lambda p, c, tok, b=bangkv: rlm.decode_step(p, c, tok, bangkv=b))
        for s in range(steps):
            tok = tokens[:, S + s: S + s + 1]
            rlog, ref = step(rparams, ref, jnp.asarray(tok))
            plog, caches = lm.decode_step(caches, t(tok), bangkv=bangkv)
            close(plog, rlog, rtol, atol)
        close_caches(caches, ref, rtol, atol, codes_equal=dtype == "float32")
        if hybrid:
            n_groups = cfg.n_layers // cfg.hybrid_attn_every
            assert caches[1].index.tolist() == [S + steps] * n_groups


@pytest.mark.parametrize("S", [20, 15])
@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-2.7b"])
def test_model_matches_reference_float32(name, S):
    """S = 20 runs 4 chunks of 5, S = 15 three of 5 (`_pick_chunk`)."""
    _run_both(name, "float32", S, 3, MODEL_RTOL, MODEL_ATOL)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-2.7b"])
def test_model_matches_reference_bf16(name):
    """One bf16 case per family, the reference's 2e-2."""
    _run_both(name, "bfloat16", 16, 1, BF16_TOL, BF16_TOL)


def test_decode_updates_ssm_caches_in_place():
    """A decode step writes the conv window and the state into the caches
    it is given; zamba2's attention caches advance their index."""
    import repro_torch.configs as configs
    from repro_torch.models import LM

    for name in ("mamba2-2.7b", "zamba2-2.7b"):
        cfg = configs.get(name).reduced(dtype="float32")
        lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
        tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(6))
        _, caches = lm.prefill({"tokens": tokens[:, :8]}, s_max=10)
        ssm_c = caches if cfg.family == "ssm" else caches[0]
        assert ssm_c.conv.shape == (cfg.n_layers, 2, cfg.ssm_conv - 1,
                                    cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
        assert ssm_c.state.shape == (cfg.n_layers, 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        state0 = ssm_c.state.clone()
        _, new = lm.decode_step(caches, tokens[:, 8:9])
        new_ssm = new if cfg.family == "ssm" else new[0]
        assert new_ssm.state is ssm_c.state and not torch.equal(ssm_c.state, state0)
        if cfg.family == "hybrid":
            assert new[1].k is caches[1].k and new[1].index.tolist() == [9, 9]
