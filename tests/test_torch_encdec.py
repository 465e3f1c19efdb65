"""The encoder-decoder family (whisper): the port held against the reference.

The encoder's bidirectional attention and the decoder's cross-attention at
reduced widths within rtol 1e-5, atol 1e-6; the whole model at float32
within rtol 1e-4, atol 1e-5 (prefill logits, the self and cross caches, 3
exact-KV and 3 BANG-KV decode steps from one state), and one bf16 case at
the reference's 2e-2. The audio front end is a stub in both packages:
precomputed frame embeddings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as rattn
from repro.models import transformer as rtransformer
from repro_torch import convert
from repro_torch.models import attention, transformer

from _lm_parity import (BF16_TOL, MODEL_ATOL, MODEL_RTOL, bang_from_kv, close, close_caches,
                        pad_kv, pair, prompt, randn, t)

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

ARCH = "whisper-medium"


@pytest.mark.parametrize("S,M,H,Hkv", [(5, 11, 4, 2), (1, 7, 4, 4), (6, 6, 8, 2)])
def test_cross_attention_matches_reference(S, M, H, Hkv):
    hd = 16
    q, k, v = randn(S, 2, S, H, hd), randn(M, 2, M, Hkv, hd), randn(H, 2, M, Hkv, hd)
    ref = rattn.cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    close(attention.cross_attention(t(q), t(k), t(v)), ref)


@pytest.mark.parametrize("S,Hkv", [(9, 2), (16, 4)])
def test_bidirectional_attention_block_matches_reference(S, Hkv):
    """The encoder's branch of `attention_block`: RoPE on q and k at
    positions 0..S-1, then attention with no mask."""
    D, H, hd = 32, 4, 8
    p = {"wq": randn(1, D, H * hd, scale=0.2), "wk": randn(2, D, Hkv * hd, scale=0.2),
         "wv": randn(3, D, Hkv * hd, scale=0.2), "wo": randn(4, H * hd, D, scale=0.2)}
    x = randn(S, 2, S, D)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd, rope_theta=1e4, attn_chunk=4,
              window=S + 1, causal=False)
    ry, (rk, rv) = rattn.attention_block({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                         **kw)
    y, (k, v) = attention.attention_block({k: t(v) for k, v in p.items()}, t(x), **kw)
    close(y, ry)
    close(k, rk)
    close(v, rv)


def test_encoder_and_cross_kv_match_reference():
    """`encoder_stack` over the frame embeddings and `cross_kv`'s (L, B, M,
    Hkv, hd) stacks."""
    rlm, rparams, lm = pair(ARCH, dtype="float32")
    mem = randn(5, 2, lm.cfg.frontend_len, lm.cfg.d_model)
    rmem = rtransformer.encoder_stack(rlm.cfg, rparams, jnp.asarray(mem))
    got = transformer.encoder_stack(lm.cfg, lm.params, t(mem))
    close(got, rmem, MODEL_RTOL, MODEL_ATOL)
    rk, rv = rtransformer.cross_kv(rlm.cfg, rparams, rmem)
    k, v = transformer.cross_kv(lm.cfg, lm.params, got)
    assert tuple(k.shape) == rk.shape == (lm.cfg.n_layers, 2, lm.cfg.frontend_len,
                                          lm.cfg.n_kv_heads, lm.cfg.head_dim)
    close(k, rk, MODEL_RTOL, MODEL_ATOL)
    close(v, rv, MODEL_RTOL, MODEL_ATOL)


def _run_both(dtype, S, steps, rtol, atol):
    """Prefill both packages (encoder, cross K/V, decoder) from one state;
    then `steps` exact-KV and `steps` BANG-KV decode steps (the reference's
    codebooks, the prompt's keys encoded by the reference) from the
    reference's caches carried across: every logit and cache within the
    bound."""
    rlm, rparams, lm = pair(ARCH, dtype=dtype)
    cfg = lm.cfg
    tokens, batch = prompt(cfg, S, 2, S, steps)
    rl, (rself, rcross) = jax.jit(rlm.prefill)(rparams, jax.tree.map(jnp.asarray, batch))
    pl, pc = lm.prefill(jax.tree.map(t, batch), s_max=S + steps)
    close(pl, rl, rtol, atol)
    rself = pad_kv(rself, steps)
    close_caches(pc, (rself, rcross), rtol, atol)
    assert pc[0].index.tolist() == [S] * cfg.n_layers

    for bangkv in (False, True):
        self_c = bang_from_kv(rparams["bangkv_codebooks"], rself) if bangkv else rself
        ref = (self_c, rcross)
        caches = convert.lm_caches_from_reference(jax.tree.map(np.asarray, ref), cfg, device="cpu")
        step = jax.jit(lambda p, c, tok, b=bangkv: rlm.decode_step(p, c, tok, bangkv=b))
        for s in range(steps):
            tok = tokens[:, S + s: S + s + 1]
            rlog, ref = step(rparams, ref, jnp.asarray(tok))
            plog, caches = lm.decode_step(caches, t(tok), bangkv=bangkv)
            close(plog, rlog, rtol, atol)
        close_caches(caches, ref, rtol, atol, codes_equal=dtype == "float32")
        assert caches[0].index.tolist() == [S + steps] * cfg.n_layers


@pytest.mark.parametrize("S", [20, 5])
def test_model_matches_reference_float32(S):
    """S = 5: a short prompt, whose 8 slots just hold BANG-KV's top-L (the
    reference's `top_k` needs as many slots as it takes)."""
    _run_both("float32", S, 3, MODEL_RTOL, MODEL_ATOL)


def test_model_matches_reference_bf16():
    """The reference's 2e-2."""
    _run_both("bfloat16", 12, 1, BF16_TOL, BF16_TOL)


def test_prefill_and_caches_layout():
    """`prefill` returns (self caches, (cross_k, cross_v)) sized by `s_max`;
    `init_decode_caches(memory_len=)` sizes the cross caches; a decode step
    writes the self caches in place and passes the cross caches through."""
    import repro_torch.configs as configs
    from repro_torch.models import LM

    cfg = configs.get(ARCH).reduced(dtype="float32")
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (2, 7), generator=g)
    frames = torch.randn((2, 10, cfg.d_model), generator=g)
    logits, (self_c, (ck, cv)) = lm.prefill({"tokens": tokens[:, :6], "frontend": frames}, s_max=9)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert self_c.k.shape == (cfg.n_layers, 2, 9, cfg.n_kv_heads, cfg.head_dim)
    assert ck.shape == cv.shape == (cfg.n_layers, 2, 10, cfg.n_kv_heads, cfg.head_dim)
    _, (new_self, cross) = lm.decode_step((self_c, (ck, cv)), tokens[:, 6:7])
    assert new_self.k is self_c.k and cross[0] is ck and new_self.index.tolist() == [7] * cfg.n_layers
    zeros = lm.init_decode_caches(2, 9, memory_len=10)
    assert zeros[1][0].shape == ck.shape and zeros[0].k.shape == self_c.k.shape
    assert lm.init_decode_caches(2, 9)[1][0].shape[2] == cfg.frontend_len
