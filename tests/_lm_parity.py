"""Shared helpers of the LM parity tests: the port held against the
reference package on the same inputs (numpy seeds) and parameters
(`convert.lm_params_from_reference`), both run in one process, the
reference on JAX for the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as rconfigs
from repro.models import attention as rattn
from repro.models import retrieval_attention as rbkv
from repro.models.transformer import LM as RLM
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.models import LM

RTOL, ATOL = 1e-5, 1e-6            # modules, float32
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
BF16_TOL = 2e-2                    # the reference's own bound for bf16 models
KEY = jax.random.PRNGKey(0)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, ref, rtol=RTOL, atol=ATOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=rtol, atol=atol)


def randn(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def configs_pair(name: str, **overrides):
    """The reduced `name` in both packages. A MoE's capacity depends on the
    routed batch: dropping is removed so prefill and decode route alike (as
    tests/test_models.py does)."""
    rcfg = rconfigs.get(name).reduced(**overrides)
    cfg = configs.get(name).reduced(**overrides)
    if cfg.n_experts:
        rcfg = dataclasses.replace(rcfg, capacity_factor=16.0)
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    return rcfg, cfg


def pair(name: str, **overrides):
    """The reference's LM and parameters for the reduced `name`, and the
    port's LM on the same parameters (on the CPU)."""
    rcfg, cfg = configs_pair(name, **overrides)
    rlm = RLM(rcfg)
    rparams = rlm.init(KEY)
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return rlm, rparams, LM(cfg, params)


def prompt(cfg, seed: int, B: int, S: int, steps: int):
    """Tokens for the prompt and 2 * steps decode steps, and the prefill
    batch (frame or patch embeddings where the config has a front end)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 2 * steps)).astype(np.int32)
    batch = {"tokens": tokens[:, :S]}
    if cfg.frontend != "none":
        batch["frontend"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return tokens, batch


def pad_kv(c, n: int):
    """A reference `KVCache` stack (L, B, S, Hkv, hd) with n more slots."""
    pad = lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))  # noqa: E731
    return rattn.KVCache(pad(c.k), pad(c.v), c.index)


def bang_from_kv(codebooks, c):
    """The reference's BANG-KV stack over a `KVCache` stack: every slot's
    key encoded with its layer's (or group's) codebooks."""
    codes = jnp.stack([rbkv.encode_keys(codebooks[i], c.k[i]) for i in range(c.k.shape[0])])
    return rbkv.BangKVCache(codes=codes, k=c.k, v=c.v, index=c.index)


def leaves(tree) -> list:
    """The tensors of a (nested) cache tuple, in field order."""
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in leaves(item)]
    return [tree]


def close_caches(got, ref, rtol, atol, codes_equal: bool = True) -> None:
    """Every cache tensor within the bound; BANG-KV codes (uint8) equal when
    `codes_equal` (in bf16 a key an ulp apart may take another code)."""
    got_l, ref_l = leaves(got), jax.tree_util.tree_leaves(ref)
    assert len(got_l) == len(ref_l)
    for g, r in zip(got_l, ref_l):
        assert tuple(g.shape) == tuple(r.shape)
        if g.dtype == torch.uint8:
            if codes_equal:
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            close(g, r, rtol, atol)
