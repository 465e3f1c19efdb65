"""BANG-KV retrieval attention: the port held against the reference.

Inputs are drawn from numpy seeds and handed to both packages as numpy
arrays; the reference runs on JAX for the CPU in this process. Codes and
retrieved positions must be equal, outputs within rtol 1e-5, atol 1e-6
(float32). k-means parity holds where B*S >= 256 only (ROADMAP C8); the n <
256 case is tested by behaviour, as the reference's own tests do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import retrieval_attention as rbkv
from repro.models.attention import KVCache as RKVCache
from repro.models.attention import decode_attention as r_decode_attention
from repro_torch.models import retrieval_attention as bkv
from repro_torch.models.attention import KVCache, decode_attention

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _cache(seed, B, S, Hkv, hd, m, fill):
    """Random K/V with zeros past `fill`, random codebooks, their codes."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    k[:, fill:] = 0
    v[:, fill:] = 0
    cb = rng.standard_normal((Hkv, m, 256, hd // m)).astype(np.float32)
    return k, v, cb


@pytest.mark.parametrize("B,S,Hkv,hd,m", [(2, 96, 2, 16, 4), (1, 200, 1, 32, 8), (3, 40, 4, 16, 16)])
def test_encode_keys_codes_bit_equal(B, S, Hkv, hd, m):
    k, _, cb = _cache(B * S + m, B, S, Hkv, hd, m, S)
    ref = np.asarray(rbkv.encode_keys(jnp.asarray(cb), jnp.asarray(k)))
    got = bkv.encode_keys(_t(cb), _t(k))
    assert got.dtype == torch.uint8 and got.shape == (B, S, Hkv, m)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("B,S,Hkv,hd,m", [(1, 256, 2, 16, 4), (2, 160, 1, 32, 8)])
def test_fit_codebooks_matches_reference(B, S, Hkv, hd, m):
    """B*S >= 256 keys a head: the strided initialisation draws distinct
    points, and the port's batched k-means equals the reference's vmap."""
    rng = np.random.default_rng(S)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    ref = np.asarray(rbkv.fit_codebooks(jnp.asarray(k), m, iters=6))
    got = bkv.fit_codebooks(_t(k), m, iters=6)
    assert got.shape == (Hkv, m, 256, hd // m)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=RTOL)


# (G, S, fill, top_l, window, adc_lite): history shorter than L (fill -
# window < top_l), index shorter than the window (fill < window), and the
# general case, for G = 1, 2 and 4, and the bf16 table.
DECODE_CASES = [
    (1, 64, 50, 8, 8, False),
    (2, 64, 50, 8, 8, False),
    (4, 64, 50, 8, 8, False),
    (2, 64, 12, 8, 8, False),     # history 4 < L: ties at -inf
    (4, 48, 5, 8, 8, False),      # index 5 < window 8: underflowing window
    (1, 32, 3, 4, 8, False),
    (2, 64, 50, 8, 8, True),      # adc_lite
    (4, 96, 90, 16, 16, True),
]


@pytest.mark.parametrize("G,S,fill,top_l,window,adc_lite", DECODE_CASES)
def test_bangkv_decode_attention_matches_reference(G, S, fill, top_l, window, adc_lite):
    B, Hkv, hd, m = 2, 2, 16, 4
    H = Hkv * G
    k, v, cb = _cache(S * G + fill, B, S, Hkv, hd, m, fill)
    q = np.random.default_rng(fill).standard_normal((B, 1, H, hd)).astype(np.float32)
    rcache = rbkv.BangKVCache(codes=rbkv.encode_keys(jnp.asarray(cb), jnp.asarray(k)),
                              k=jnp.asarray(k), v=jnp.asarray(v), index=jnp.int32(fill))
    ref = np.asarray(rbkv.bangkv_decode_attention(jnp.asarray(cb), jnp.asarray(q), rcache,
                                                  top_l=top_l, window=window, adc_lite=adc_lite))
    cache = bkv.BangKVCache(_t(np.asarray(rcache.codes)), _t(k), _t(v),
                            torch.tensor(fill, dtype=torch.int32))
    out, top = bkv.bangkv_decode_attention(_t(cb), _t(q), cache, top_l=top_l, window=window,
                                           adc_lite=adc_lite, return_top_idx=True)
    # The reference's selection, recomputed from its own stages 1-2.
    np.testing.assert_array_equal(top.numpy(), _reference_top_idx(cb, q, rcache, top_l, window,
                                                                  adc_lite))
    assert out.shape == (B, 1, H, hd)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def _reference_top_idx(cb, q, rcache, top_l, window, adc_lite):
    """Stages 1-2 as `repro.models.retrieval_attention.bangkv_decode_attention`
    computes them (`:157-181`), run on JAX: the reference does not return
    its selection."""
    B, _, H, hd = q.shape
    _, S, Hkv, m = rcache.codes.shape
    G = H // Hkv
    qf = jnp.asarray(q).reshape(B, H, m, hd // m)
    table = jnp.einsum("bhjd,hjcd->bhjc", qf, jnp.repeat(jnp.asarray(cb), G, axis=0))
    idx_q = jnp.repeat(rcache.codes.astype(jnp.int32), G, axis=2)
    tbl = table.astype(jnp.bfloat16) if adc_lite else table
    gathered = jnp.take_along_axis(tbl[:, None], idx_q[..., None], axis=4)[..., 0]
    approx = jnp.sum(gathered.astype(jnp.float32), axis=-1).transpose(0, 2, 1)
    pos = jnp.arange(S, dtype=jnp.int32)
    in_window = (pos[None, :] >= rcache.index - window) & (pos[None, :] < rcache.index)
    valid_hist = (pos[None, :] < rcache.index) & ~in_window
    approx = jnp.where(valid_hist[:, None], approx, -jnp.inf)
    return np.asarray(rbkv._retrieve_top_l(approx, top_l, False))


def test_retrieve_top_l_takes_the_lowest_position_among_ties():
    """ROADMAP C2: equal scores (the -inf slots outside the retrieval
    region, equal codes) come out lowest position first, as lax.top_k."""
    rng = np.random.default_rng(7)
    approx = rng.integers(0, 4, (3, 5, 40)).astype(np.float32)
    approx[:, :, 25:] = -np.inf
    ref = np.asarray(rbkv._retrieve_top_l(jnp.asarray(approx), 32, False))
    np.testing.assert_array_equal(bkv._retrieve_top_l(_t(approx), 32).numpy(), ref)
    with pytest.raises(ValueError, match="top_l"):
        bkv._retrieve_top_l(_t(approx), 41)


@pytest.mark.parametrize("G,index", [(1, 0), (2, 5), (4, 15)])
def test_bangkv_attention_block_cache_update_bit_equal(G, index):
    """The new key, value and codes land at `index` in place, bit-equal to
    the reference's functional update; the output within the bound."""
    B, S, Hkv, hd, m = 2, 16, 2, 16, 4
    H, D = Hkv * G, 48
    rng = np.random.default_rng(G + index)
    k, v, cb = _cache(G, B, S, Hkv, hd, m, index)
    p = {name: (0.2 * rng.standard_normal(shape)).astype(np.float32) for name, shape in
         (("wq", (D, H * hd)), ("wk", (D, Hkv * hd)), ("wv", (D, Hkv * hd)), ("wo", (H * hd, D)))}
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    codes = np.asarray(rbkv.encode_keys(jnp.asarray(cb), jnp.asarray(k)))
    rcache = rbkv.BangKVCache(codes=jnp.asarray(codes), k=jnp.asarray(k), v=jnp.asarray(v),
                              index=jnp.int32(index))
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd, rope_theta=1e4, top_l=4, window=4)
    ry, rnew = rbkv.bangkv_attention_block({n: jnp.asarray(a) for n, a in p.items()},
                                           jnp.asarray(cb), jnp.asarray(x), rcache, **kw)
    cache = bkv.BangKVCache(_t(codes.copy()), _t(k.copy()), _t(v.copy()),
                            torch.tensor(index, dtype=torch.int32))
    y, new = bkv.bangkv_attention_block({n: _t(a) for n, a in p.items()}, _t(cb), _t(x),
                                        cache, **kw)
    assert int(new.index) == index + 1 and new.k.data_ptr() == cache.k.data_ptr()
    for name in ("codes", "k", "v"):
        np.testing.assert_array_equal(getattr(new, name).numpy(), np.asarray(getattr(rnew, name)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=RTOL, atol=ATOL)


def test_fit_bangkv_caches_fits_each_layer_and_shares_kv():
    """Stage 0 over a stack: per-layer codebooks from the filled keys, those
    keys encoded, the rest of the codes 0, index = fill, K/V shared."""
    L, B, S, Hkv, hd, m, fill = 2, 1, 300, 2, 16, 4, 280
    rng = np.random.default_rng(11)
    k = _t(rng.standard_normal((L, B, S, Hkv, hd)).astype(np.float32))
    v = _t(rng.standard_normal((L, B, S, Hkv, hd)).astype(np.float32))
    cbs, cache = bkv.fit_bangkv_caches(KVCache(k, v, torch.zeros(L, dtype=torch.int32)),
                                       fill, m, iters=3)
    assert cbs.shape == (L, Hkv, m, 256, hd // m) and cache.codes.shape == (L, B, S, Hkv, m)
    assert cache.k is k and cache.v is v and cache.index.tolist() == [fill] * L
    for layer in range(L):
        cb = bkv.fit_codebooks(k[layer, :, :fill], m, iters=3)
        assert torch.equal(cbs[layer], cb)
        assert torch.equal(cache.codes[layer, :, :fill], bkv.encode_keys(cb, k[layer, :, :fill]))
    assert not cache.codes[:, :, fill:].any()


# ---------------------------------------------------------------------------
# The reference's behaviour tests (tests/test_retrieval_attention.py), on
# the port: fewer keys than centroids, where parity is not held (C8).
# ---------------------------------------------------------------------------

def test_encode_keys_roundtrip_when_codebook_contains_keys():
    """With <= 256 distinct keys per head, fitted codebooks quantise exactly."""
    B, S, Hkv, hd, m = 1, 24, 2, 16, 4
    k = _t(np.random.default_rng(0).standard_normal((B, S, Hkv, hd)).astype(np.float32))
    cb = bkv.fit_codebooks(k, m, iters=30)
    codes = bkv.encode_keys(cb, k)
    assert codes.shape == (B, S, Hkv, m)
    dsub = hd // m
    rec = torch.stack([cb[h, j, codes[0, :, h, j].long()] for h in range(Hkv) for j in range(m)],
                      dim=1).reshape(S, Hkv, m, dsub)
    np.testing.assert_allclose(rec.numpy(), k.numpy().reshape(B, S, Hkv, m, dsub)[0],
                               atol=2e-2, rtol=2e-2)


def test_bangkv_matches_exact_attention_with_perfect_codebooks():
    """When PQ is lossless and L + window covers history, BANG-KV == exact."""
    B, S, Hkv, G, hd, m = 1, 32, 2, 2, 16, 4
    H = Hkv * G
    fill = 28
    window, top_l = 8, fill
    k, v, _ = _cache(3, B, S, Hkv, hd, m, fill)
    k, v = _t(k), _t(v)
    cb = bkv.fit_codebooks(k[:, :fill], m, iters=40)
    cache = bkv.BangKVCache(bkv.encode_keys(cb, k), k, v, torch.tensor(fill, dtype=torch.int32))
    q = _t(np.random.default_rng(4).standard_normal((B, 1, H, hd)).astype(np.float32))
    out_bang = bkv.bangkv_decode_attention(cb, q, cache, top_l=top_l, window=window)
    out_exact = decode_attention(q, KVCache(k, v, torch.tensor(fill, dtype=torch.int32)),
                                 window=S + 1)
    np.testing.assert_allclose(out_bang.numpy(), out_exact.numpy(), rtol=3e-3, atol=3e-3)
    # and the reference's exact attention gives the same
    ref = r_decode_attention(jnp.asarray(q.numpy()), RKVCache(k=jnp.asarray(k.numpy()),
                             v=jnp.asarray(v.numpy()), index=jnp.int32(fill)),
                             window=jnp.int32(S + 1))
    np.testing.assert_allclose(out_exact.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_bangkv_retrieval_finds_planted_heavy_key():
    """A key aligned with q outside the window must be retrieved."""
    B, S, Hkv, hd, m = 1, 64, 1, 16, 4
    fill = 60
    rng = np.random.default_rng(5)
    k = 0.01 * rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    q = rng.standard_normal((B, 1, 1, hd)).astype(np.float32)
    planted = 7
    k[0, planted, 0] = 10.0 * q[0, 0, 0] / np.linalg.norm(q[0, 0, 0])
    k[:, fill:] = 0
    kt, vt = _t(k), _t(v)
    cb = bkv.fit_codebooks(kt[:, :fill], m, iters=40)
    cache = bkv.BangKVCache(bkv.encode_keys(cb, kt), kt, vt, torch.tensor(fill, dtype=torch.int32))
    out, top = bkv.bangkv_decode_attention(cb, _t(q), cache, top_l=4, window=8, return_top_idx=True)
    assert planted in top[0, 0].tolist()
    np.testing.assert_allclose(out.numpy()[0, 0, 0], v[0, planted, 0], rtol=0.15, atol=0.15)


def test_bangkv_cache_append():
    B, S, Hkv, hd, m = 2, 16, 2, 16, 4
    cache = bkv.bangkv_init(B, S, Hkv, hd, m, dtype=torch.float32, device="cpu")
    assert cache.codes.dtype == torch.uint8 and int(cache.index) == 0
    cb = _t(np.random.default_rng(0).standard_normal((Hkv, m, 256, hd // m)).astype(np.float32))
    eye = torch.eye(Hkv * 2 * hd)
    p = {"wq": eye, "wk": eye[:, : Hkv * hd], "wv": eye[:, : Hkv * hd], "wo": eye}
    x = _t(np.random.default_rng(1).standard_normal((B, 1, Hkv * 2 * hd)).astype(np.float32))
    y, new = bkv.bangkv_attention_block(p, cb, x, cache, n_heads=Hkv * 2, n_kv_heads=Hkv,
                                        head_dim=hd, rope_theta=1e4, top_l=4, window=4)
    assert int(new.index) == 1 and y.shape == x.shape
    assert bool((new.k[:, 0] != 0).any()) and not new.k[:, 1:].any()
    if torch.cuda.is_available():
        assert bkv.bangkv_init(B, S, Hkv, hd, m).k.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            bkv.bangkv_init(B, S, Hkv, hd, m)
