"""The decoder LM's serve path: the port held against the reference.

The reference's parameters (`repro.models.transformer.LM(cfg).init`) are
carried across with `convert.lm_params_from_reference`, inputs are drawn
from numpy seeds, and both packages run in this process (the reference on
JAX for the CPU). Bounds: rtol 1e-5, atol 1e-6 for the modules at float32;
rtol 1e-4, atol 1e-5 for whole models at float32; the reference's own 2e-2
for one bf16 model of each family (XLA:CPU and torch round bf16 products at
other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import moe as rmoe
from repro.models import retrieval_attention as rbkv
from repro.models.ffn import swiglu as r_swiglu
from repro.models.transformer import LM as RLM
from repro.models.transformer import layer_flags as r_layer_flags
from repro.models.transformer import static_layer_flags as r_static_layer_flags
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.models import LM, init_params
from repro_torch.models import attention, layers, moe
from repro_torch.models.ffn import swiglu
from repro_torch.models import retrieval_attention as bkv
from repro_torch.models.transformer import (attention_caches, layer_flags, static_layer_flags,
                                            with_attention_caches)

from _lm_parity import KEY, MODEL_ATOL, MODEL_RTOL
from _lm_parity import close as _close
from _lm_parity import configs_pair as _configs
from _lm_parity import leaves as _flat
from _lm_parity import pair as _pair
from _lm_parity import prompt as _prompt
from _lm_parity import randn as _randn
from _lm_parity import t as _t

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

DECODER_ARCHS = ["gemma3-27b", "phi3-medium-14b", "granite-3-2b", "glm4-9b",
                 "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e", "internvl2-1b"]
ALL_ARCHS = sorted(configs.ARCHS)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    x, w, b = _randn(1, 3, 7, 64, scale=3.0), _randn(2, 64, scale=0.1), _randn(3, 64)
    p = {"w": w, "b": b} if kind == "layernorm" else {"w": w}
    ref = rlayers.norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, kind, 1e-6)
    _close(layers.norm(_t(x), {k: _t(v) for k, v in p.items()}, kind, 1e-6), ref)


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (64, 1e4), (128, 1e4), (128, 1e6)])
def test_apply_rope_matches_reference_up_to_32k(hd, theta):
    """Positions up to 32,768: an ulp of a frequency would move the angle
    there by 2e-3, so the frequencies must equal XLA's bit for bit."""
    rng = np.random.default_rng(hd)
    pos = np.sort(rng.integers(0, 32_769, (2, 40))).astype(np.int32)
    pos[0, -1] = 32_768
    x = _randn(hd, 2, 40, 3, hd)
    np.testing.assert_array_equal(layers.rope_frequencies(hd, theta).numpy(),
                                  np.asarray(rlayers.rope_frequencies(hd, theta)))
    ref = rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(layers.apply_rope(_t(x), _t(pos), theta), ref)


def test_swiglu_matches_reference():
    p = {"w_gate": _randn(1, 64, 96, scale=0.1), "w_up": _randn(2, 64, 96, scale=0.1),
         "w_down": _randn(3, 96, 64, scale=0.1)}
    x = _randn(4, 2, 5, 64)
    ref = r_swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    _close(swiglu({k: _t(v) for k, v in p.items()}, _t(x)), ref)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

# (window, band, bf16_scores): full causal, sliding, sliding with the static
# band, bf16 score inputs.
ATTN_CASES = {"full": (33, None, False), "sliding": (5, None, False), "band": (5, 16, False),
              "bf16_scores": (33, None, True)}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_causal_attention_matches_reference(case):
    window, band, bf16 = ATTN_CASES[case]
    B, S, H, Hkv, hd = 2, 32, 4, 2, 8
    q, k, v = _randn(1, B, S, H, hd), _randn(2, B, S, Hkv, hd), _randn(3, B, S, Hkv, hd)
    kw = dict(chunk=8, window=window, bf16_scores=bf16, band=band)
    ref = rattn.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    _close(attention.chunked_causal_attention(_t(q), _t(k), _t(v), **kw), ref)


@pytest.mark.parametrize("window,index", [(41, 20), (6, 20), (41, 1)])
def test_decode_attention_matches_reference(window, index):
    B, S, H, Hkv, hd = 2, 40, 8, 2, 16
    q, k, v = _randn(1, B, 1, H, hd), _randn(2, B, S, Hkv, hd), _randn(3, B, S, Hkv, hd)
    ref = rattn.decode_attention(
        jnp.asarray(q), rattn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.int32(index)),
        window=window)
    got = attention.decode_attention(
        _t(q), attention.KVCache(_t(k), _t(v), torch.tensor(index, dtype=torch.int32)),
        window=window)
    _close(got, ref)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

# (top_k, n_shared, capacity_factor, T): top-1 with a shared expert, top-2,
# a capacity that drops tokens, and C rounded to 128 from 128 tokens on.
MOE_CASES = {"top1_shared": (1, 1, 1.25, 24), "top2": (2, 0, 16.0, 24),
             "dropping": (2, 0, 0.5, 24), "rounded_c": (2, 1, 1.0, 160)}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_reference(case):
    top_k, n_shared, cf, T = MOE_CASES[case]
    E, D, F = 4, 32, 48
    rng = np.random.default_rng(T + top_k)
    p = {"router": (0.3 * rng.standard_normal((D, E))).astype(np.float32),
         "w_gate": (0.1 * rng.standard_normal((E, D, F))).astype(np.float32),
         "w_up": (0.1 * rng.standard_normal((E, D, F))).astype(np.float32),
         "w_down": (0.1 * rng.standard_normal((E, F, D))).astype(np.float32)}
    if n_shared:
        p["shared"] = {"w_gate": _randn(5, D, F, scale=0.1), "w_up": _randn(6, D, F, scale=0.1),
                       "w_down": _randn(7, F, D, scale=0.1)}
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=top_k, capacity_factor=cf)
    ry, raux = rmoe.moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), **kw)
    tp = jax.tree.map(_t, p)
    y, aux = moe.moe_block(tp, _t(x), **kw)
    _close(y, ry)
    for got, ref in zip(aux, raux):
        _close(got, ref)
    # `keep`, as the reference's moe_block computes it (`moe.py:70-87`).
    C = moe.capacity(T, top_k, cf, E)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(T, D)) @ jnp.asarray(p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    flat = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(T * top_k, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=-1).reshape(T, top_k)
    routing = moe.route(tp["router"], _t(x.reshape(T, D)), top_k, C)
    np.testing.assert_array_equal(routing.expert_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(routing.keep.numpy(), np.asarray(pos < C))
    if case == "dropping":
        assert 0.0 < float(aux.dropped_frac) < 1.0
    if case == "rounded_c":
        assert C % 128 == 0


def test_router_ties_take_the_lowest_expert():
    """ROADMAP C2 in the router: equal probabilities, lowest expert first."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]], np.float32)
    _, ref = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(moe.stable_top_k(_t(probs), 2)[1].numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def _run_both(name, dtype, steps, rtol, atol):
    """Prefill both packages from one state, then `steps` exact-KV and
    `steps` BANG-KV decode steps (the reference's codebooks, the prompt's
    keys encoded by the reference), every logit within the bound."""
    rlm, rparams, lm = _pair(name, dtype=dtype)
    cfg = lm.cfg
    B, S = 2, 20
    tokens, batch = _prompt(cfg, len(name), B, S, steps)
    S_all = S + cfg.frontend_len
    rl, rc = jax.jit(rlm.prefill)(rparams, jax.tree.map(jnp.asarray, batch))
    pl, pc = lm.prefill(jax.tree.map(_t, batch), s_max=S_all + steps)
    _close(pl, rl, rtol, atol)
    pad = lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0)))
    rc = rattn.KVCache(pad(rc.k), pad(rc.v), rc.index)
    for got, ref in zip(pc, rc):
        _close(got, ref, rtol, atol)

    cb = rparams["bangkv_codebooks"]
    codes = jnp.stack([rbkv.encode_keys(cb[i], rc.k[i]) for i in range(cfg.n_layers)])
    rb = rbkv.BangKVCache(codes=codes, k=rc.k, v=rc.v, index=rc.index)
    if dtype == "float32":
        mine = torch.stack([bkv.encode_keys(lm.params["bangkv_codebooks"][i], pc.k[i])
                            for i in range(cfg.n_layers)])
        np.testing.assert_array_equal(mine.numpy(), np.asarray(codes))
    host = jax.tree.map(np.asarray, (rc, rb))
    caches = {False: convert.kv_caches_from_reference(host[0], device="cpu"),
              True: convert.bangkv_caches_from_reference(host[1], device="cpu")}
    ref_caches = {False: rc, True: rb}
    for bangkv in (False, True):
        step = jax.jit(lambda p, c, t, b=bangkv: rlm.decode_step(p, c, t, bangkv=b))
        for s in range(steps):
            tok = tokens[:, S + s: S + s + 1]
            rlog, ref_caches[bangkv] = step(rparams, ref_caches[bangkv], jnp.asarray(tok))
            plog, caches[bangkv] = lm.decode_step(caches[bangkv], _t(tok), bangkv=bangkv)
            _close(plog, rlog, rtol, atol)
        assert caches[bangkv].index.tolist() == [S_all + steps] * cfg.n_layers
        for name_, got, ref in zip(caches[bangkv]._fields, caches[bangkv], ref_caches[bangkv]):
            if name_ != "codes":
                _close(got, ref, rtol, atol)
            elif dtype == "float32":
                # In bf16 a new key an ulp apart may take another code.
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", DECODER_ARCHS)
def test_model_matches_reference_float32(name):
    _run_both(name, "float32", 3, MODEL_RTOL, MODEL_ATOL)


@pytest.mark.parametrize("name", ["glm4-9b", "phi3.5-moe-42b-a6.6b", "internvl2-1b"])
def test_model_matches_reference_bf16(name):
    """One bf16 case per family (dense, moe, vlm), the reference's 2e-2."""
    _run_both(name, "bfloat16", 1, 2e-2, 2e-2)


def _kinds(tree):
    """A cache's structure: NamedTuple names and plain tuples, leaves as None."""
    if hasattr(tree, "_fields"):
        return type(tree).__name__
    if isinstance(tree, tuple):
        return tuple(_kinds(x) for x in tree)
    return None


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_init_matches_reference_shapes(name):
    """`init_params` draws the reference's tree: names, shapes and dtypes
    (each stacked layer axis a list: `layers`, whisper's `encoder.layers`),
    and `init_decode_caches` its caches, every family's layout."""
    rcfg, cfg = _configs(name)
    rlm = RLM(rcfg)
    rparams = jax.eval_shape(rlm.init, KEY)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = {k: v for k, v in params.named_parameters()}
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(rparams):
        keys = [p.key for p in path]
        stacked = {("layers",): cfg.n_layers, ("encoder", "layers"): cfg.n_encoder_layers}
        lead = next((k for k in stacked if tuple(keys[:len(k)]) == k), None)
        if lead is not None:
            for i in range(stacked[lead]):
                want[".".join([*lead, str(i), *keys[len(lead):]])] = (leaf.shape[1:], leaf.dtype)
        else:
            want[".".join(keys)] = (leaf.shape, leaf.dtype)
    assert set(flat) == set(want)
    for k, p in flat.items():
        assert tuple(p.shape) == tuple(want[k][0]) and str(p.dtype).split(".")[1] == str(want[k][1])
    assert not any(p.requires_grad for p in params.parameters())
    lm = LM(cfg, params)
    for bangkv in (False, True):
        ref = rlm.init_decode_caches(2, 24, bangkv=bangkv, fill=5)
        got = lm.init_decode_caches(2, 24, bangkv=bangkv, fill=5)
        assert _kinds(got) == _kinds(ref)
        ref_leaves = jax.tree_util.tree_leaves(ref)
        assert len(_flat(got)) == len(ref_leaves)
        for g, r in zip(_flat(got), ref_leaves):
            assert tuple(g.shape) == r.shape and str(g.dtype).split(".")[1] == str(r.dtype)
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_every_config_serves_on_cpu(name):
    """`LM(cfg, device="cpu")` constructs for every config, and `prefill`,
    an exact-KV and, where the family has attention, a BANG-KV decode step
    give finite logits of the vocabulary's width; the training mode of the
    stack makes no caches."""
    cfg = configs.get(name).reduced(dtype="float32")
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    tokens, batch = _prompt(cfg, 3, 2, 10, 1)
    logits, caches = lm.prefill(jax.tree.map(_t, batch), s_max=20 + cfg.frontend_len)
    for bangkv in (False, True) if "bangkv_codebooks" in lm.params else (False,):
        out, _ = lm.decode_step(caches, _t(tokens[:, 10 + bangkv:11 + bangkv]), bangkv=bangkv)
        for x in (logits, out):
            assert x.shape == (2, 1, cfg.vocab_size) and bool(torch.isfinite(x).all())
        if not bangkv and "bangkv_codebooks" in lm.params:
            kv = attention_caches(cfg, caches)
            codes = torch.stack([bkv.encode_keys(lm.params["bangkv_codebooks"][i], kv.k[i])
                                 for i in range(kv.k.shape[0])])
            caches = with_attention_caches(cfg, caches, bkv.BangKVCache(codes, kv.k, kv.v, kv.index))
    # Training runs too (tests/test_torch_train.py holds it): no caches.
    from repro_torch.models.transformer import decoder_stack
    h, _, caches = decoder_stack(cfg, lm.params, torch.zeros((1, 4, cfg.d_model)), mode="train")
    assert caches is None and h.shape == (1, 4, cfg.d_model) and bool(torch.isfinite(h).all())
    with pytest.raises(ValueError, match="mode"):
        decoder_stack(cfg, lm.params, torch.zeros((1, 4, cfg.d_model)), mode="encode")


@pytest.mark.parametrize("name", ["gemma3-27b", "glm4-9b"])
def test_layer_flags_match_reference(name):
    cfg = configs.get(name)
    rflags = r_layer_flags(rconfigs.get(name), 4096)
    flags = layer_flags(cfg, 4096)
    for k in ("window", "theta"):
        np.testing.assert_array_equal(flags[k].numpy(), np.asarray(rflags[k]))
    assert static_layer_flags(cfg, 4096) == r_static_layer_flags(rconfigs.get(name), 4096)


def test_every_config_resolves_as_the_reference():
    """The copied configs equal the reference's, field for field."""
    assert sorted(configs.ARCHS) == sorted(rconfigs.ARCHS)
    for name, cfg in configs.ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rconfigs.get(name))
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(rconfigs.get(name).reduced())
        assert cfg.param_count() == rconfigs.get(name).param_count()
    assert {k: dataclasses.asdict(v) for k, v in configs.LM_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rconfigs.LM_SHAPES.items()}
    with pytest.raises(KeyError):
        configs.get("no-such-arch")


def test_decode_writes_caches_in_place():
    """A decode step writes at the device index into the caches it is given
    and returns them with index + 1: the same storage."""
    cfg = configs.get("glm4-9b").reduced(dtype="float32")
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    tokens = torch.randint(0, cfg.vocab_size, (2, 10), generator=torch.Generator().manual_seed(4))
    _, caches = lm.prefill({"tokens": tokens[:, :8]}, s_max=12)
    assert caches.k.shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads, cfg.head_dim)
    assert not caches.k[:, :, 8:].any() and caches.index.tolist() == [8] * cfg.n_layers
    _, new = lm.decode_step(caches, tokens[:, 8:9])
    assert new.k is caches.k and new.index.tolist() == [9] * cfg.n_layers
    assert caches.k[:, :, 8].any() and not caches.k[:, :, 9:].any()
    with pytest.raises(ValueError, match="s_max"):
        lm.prefill({"tokens": tokens[:, :8]}, s_max=7)


def test_long_context_decode_example_runs_on_cpu(capsys):
    """examples/long_context_decode_torch.py at a small context."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "long_context_decode_torch.py"
    spec = importlib.util.spec_from_file_location("long_context_decode_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--context", "96", "--decode-steps", "3"])
    assert out["steps"] == 3 and len(out["corr"]) == 3 and out["device"] == "cpu"
    assert all(-1.0 <= c <= 1.0 for c in out["corr"]) and 0 <= out["agree"] <= 3
    text = capsys.readouterr().out
    assert "[bangkv] prefill 96 tokens" in text and "[bangkv] argmax agreement:" in text
    assert "8B vs exact 64B" in text


def _load_example():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "long_context_decode_torch.py"
    spec = importlib.util.spec_from_file_location("long_context_decode_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,caches", [("zamba2-2.7b", 2), ("whisper-medium", 4)])
def test_long_context_decode_example_other_families_on_cpu(arch, caches, capsys):
    """The example's `--arch` for the hybrid (the shared block's caches, one
    a group) and whisper (the decoder's self-attention caches)."""
    out = _load_example().main(["--device", "cpu", "--arch", arch, "--context", "96",
                                "--decode-steps", "3"])
    assert out["steps"] == 3 and len(out["corr"]) == 3 and out["arch"] == f"{arch}-reduced"
    assert all(-1.0 <= c <= 1.0 for c in out["corr"]) and 0 <= out["agree"] <= 3
    text = capsys.readouterr().out
    assert f"prefill keys of {caches} attention caches" in text and "[bangkv] argmax agreement:" in text
    assert ("encoder over 4 stub frame embeddings" in text) == (arch == "whisper-medium")


def test_long_context_decode_example_refuses_mamba2(capsys):
    """An attention-free model has no KV to retrieve from: exit 2, said plainly."""
    with pytest.raises(SystemExit) as exc:
        _load_example().main(["--device", "cpu", "--arch", "mamba2-2.7b"])
    assert exc.value.code == 2
    assert "attention-free" in capsys.readouterr().err
