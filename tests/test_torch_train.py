"""The LM's training path: the port held against the reference.

`LM.loss` and its metrics for all ten reduced configs at float32, the
gradients against the reference's `jax.grad` for one config of each family
(dense, moe with and without dropping, vlm, ssm, hybrid, encdec), the
sequence-chunked cross-entropy, gradchecks of the modules that write in
place, remat, and an SGD step in bf16. The reference's parameters are
carried across with `convert.lm_params_from_reference` (its gradient tree
too: it has the parameters' structure) and inputs come from numpy seeds.

Bounds: the cross-entropy and the gradchecked modules within rtol 1e-5,
atol 1e-6 (float32) or gradcheck's own (float64); whole models -- the loss,
its metrics and every gradient -- within `_lm_parity`'s rtol 1e-4, atol
1e-5, the bound the serve path's parity holds (the worst gradient entry
takes about 3% of it on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import layers as rlayers
from repro.models.transformer import LM as RLM
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.models import LM, attention, layers, moe, ssm
from repro_torch.models.transformer import decoder_stack
from repro_torch.tree import flat_dict

from _lm_parity import KEY, MODEL_ATOL, MODEL_RTOL
from _lm_parity import close as _close
from _lm_parity import randn as _randn
from _lm_parity import t as _t

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

ALL_ARCHS = sorted(configs.ARCHS)
# One config of each family for the gradients; the MoE with its reduced
# config's dropping (capacity factor 1.25) and without it (16).
GRAD_CASES = [("granite-3-2b", None), ("phi3.5-moe-42b-a6.6b", None),
              ("phi3.5-moe-42b-a6.6b", 16.0), ("internvl2-1b", None), ("mamba2-2.7b", None),
              ("zamba2-2.7b", None), ("whisper-medium", None)]


def _pair(name: str, dtype: str = "float32", capacity_factor: float | None = None):
    """The reduced `name` in both packages at `dtype`, the reference's LM and
    parameters, and the port's LM on the same parameters (on the CPU)."""
    rcfg = rconfigs.get(name).reduced(dtype=dtype)
    cfg = configs.get(name).reduced(dtype=dtype)
    if capacity_factor is not None:
        rcfg = dataclasses.replace(rcfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    rlm = RLM(rcfg)
    rparams = rlm.init(KEY)
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return rlm, rparams, LM(cfg, params)


def _batch(cfg, seed: int = 3, B: int = 2, S: int = 24) -> dict:
    """Next-token batch of S positions (a vlm's patches count among them)."""
    rng = np.random.default_rng(seed)
    S_tok = S - cfg.frontend_len if cfg.frontend == "vision_stub" else S
    toks = rng.integers(0, cfg.vocab_size, (B, S_tok + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend != "none":
        batch["frontend"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def _port(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close_metrics(metrics: dict, ref: dict) -> None:
    assert sorted(metrics) == sorted(ref) == ["ce", "dropped_frac", "load_balance", "router_z"]
    for k in metrics:
        _close(metrics[k], ref[k], MODEL_RTOL, MODEL_ATOL)


# ---------------------------------------------------------------------------
# The sequence-chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [32, 37])
def test_unembed_chunked_matches_reference(S):
    """The mean over the tokens it keeps, and its gradients: at S = 37 and
    chunk 8 four chunks of 9 are kept and the last position is dropped, as
    the reference's scan drops it."""
    B, D, V, chunk = 2, 16, 50, 8
    h, table = _randn(1, B, S, D), _randn(2, V, D, scale=0.5)
    labels = np.random.default_rng(3).integers(0, V, (B, S)).astype(np.int32)
    ref_fn = lambda h, t: rlayers.unembed_chunked(h, t, jnp.asarray(labels), chunk)  # noqa: E731
    ref, (rdh, rdt) = jax.value_and_grad(ref_fn, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(table))
    th, tt = _t(h).requires_grad_(), _t(table).requires_grad_()
    got = layers.unembed_chunked(th, tt, _t(labels), chunk)
    got.backward()
    _close(got.detach(), ref)
    _close(th.grad, rdh)
    _close(tt.grad, rdt)
    if S % chunk:
        assert float(th.grad[:, 36:].abs().max()) == 0.0   # the dropped position


def test_unembed_chunked_gradcheck():
    """float64 gradcheck of the custom backward (it recomputes each chunk's
    softmax), with a position dropped and the head as a transposed view."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 7, 4, dtype=torch.float64, generator=g, requires_grad=True)
    head = torch.randn(4, 9, dtype=torch.float64, generator=g, requires_grad=True)
    labels = torch.randint(0, 9, (2, 7), generator=g)
    assert torch.autograd.gradcheck(lambda h, w: layers.unembed_chunked(h, w.T, labels, 3), (h, head))


def test_unembed_chunked_holds_one_chunk_of_logits():
    """Under autograd the loss keeps the inputs and one float32 value a
    position (the logsumexp), never the (B, c, V) logits."""
    B, S, D, V = 2, 64, 8, 1000
    h = torch.randn(B, S, D, requires_grad=True)
    table = torch.randn(V, D, requires_grad=True)
    labels = torch.randint(0, V, (B, S))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = layers.unembed_chunked(h, table, labels, 16)
    assert max(saved) <= V * D and sum(saved) < B * 16 * V   # less than one chunk of logits
    loss.backward()
    assert h.grad.shape == h.shape and table.grad.shape == table.shape


# ---------------------------------------------------------------------------
# The modules that write in place, under autograd
# ---------------------------------------------------------------------------

def test_chunked_attention_gradcheck():
    """`scores.masked_fill_` (causal and sliding-window masks, two query
    chunks) at float64."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 8, 4, 4, dtype=torch.float64, generator=g, requires_grad=True)
    k = torch.randn(1, 8, 2, 4, dtype=torch.float64, generator=g, requires_grad=True)
    v = torch.randn(1, 8, 2, 4, dtype=torch.float64, generator=g, requires_grad=True)
    for window in (9, 3):
        fn = lambda q, k, v: attention.chunked_causal_attention(q, k, v, chunk=4, window=window)  # noqa: E731,B023
        assert torch.autograd.gradcheck(fn, (q, k, v))


@pytest.mark.parametrize("capacity_factor", [1.0, 16.0])
def test_moe_block_gradcheck(capacity_factor):
    """The dispatch's `buf.index_put_(..., accumulate=True)` and the combine
    at float64, with tokens dropped (capacity 1.0) and without: the output
    and the aux terms, through the router too."""
    g = torch.Generator().manual_seed(2)
    D, F, E = 4, 6, 4
    rnd = lambda *s: (0.5 * torch.randn(*s, dtype=torch.float64, generator=g)).requires_grad_()  # noqa: E731
    p = {"router": rnd(D, E), "w_gate": rnd(E, D, F), "w_up": rnd(E, D, F), "w_down": rnd(E, F, D)}
    x = rnd(2, 5, D)

    def fn(x, router, wg, wu, wd):
        y, aux = moe.moe_block({"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}, x,
                               n_experts=E, top_k=2, capacity_factor=capacity_factor)
        return y, aux.load_balance, aux.router_z

    _, aux = moe.moe_block(p, x, n_experts=E, top_k=2, capacity_factor=capacity_factor)
    assert (float(aux.dropped_frac) > 0) == (capacity_factor == 1.0)
    assert torch.autograd.gradcheck(fn, (x, *p.values()))


def test_ssd_train_mode_equals_prefill():
    """The out-of-place SSD (training) gives the in-place form's values bit
    for bit, and its gradients pass gradcheck at float64."""
    g = torch.Generator().manual_seed(4)
    B, S, H, P, G, N, Q = 2, 12, 4, 3, 2, 5, 4
    x, Bm, Cm = (torch.randn(*s, generator=g) for s in ((B, S, H, P), (B, S, G, N), (B, S, G, N)))
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.rand(H, generator=g) - 0.5
    y0, s0 = ssm.ssd_chunked(x, dt, A, Bm, Cm, Q)
    y1, s1 = ssm.ssd_chunked(x, dt, A, Bm, Cm, Q, in_place=False)
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    args = tuple(t.double().requires_grad_() for t in (x, dt, Bm, Cm))
    fn = lambda x, dt, Bm, Cm: ssm.ssd_chunked(x, dt, A.double(), Bm, Cm, Q, in_place=False)  # noqa: E731
    assert torch.autograd.gradcheck(fn, args)


# ---------------------------------------------------------------------------
# The loss and the gradients against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL_ARCHS)
def test_loss_matches_reference(name):
    rlm, rparams, lm = _pair(name)
    batch = _batch(lm.cfg)
    ref_loss, ref_metrics = jax.jit(rlm.loss)(rparams, _ref(batch))
    loss, metrics = lm.loss(_port(batch))
    _close(loss, ref_loss, MODEL_RTOL, MODEL_ATOL)
    _close_metrics(metrics, ref_metrics)
    if lm.cfg.n_experts:
        assert float(metrics["load_balance"]) > 0 and float(metrics["router_z"]) > 0


@pytest.mark.parametrize("name,capacity_factor", GRAD_CASES,
                         ids=[n if c is None else f"{n}-no-drop" for n, c in GRAD_CASES])
def test_grads_match_reference(name, capacity_factor):
    """Every gradient leaf against the reference's `jax.grad`; a leaf the
    loss does not read (the BANG-KV codebooks) has no gradient in the port
    and a zero one in the reference."""
    rlm, rparams, lm = _pair(name, capacity_factor=capacity_factor)
    batch = _batch(lm.cfg)
    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        rlm.loss, has_aux=True))(rparams, _ref(batch))
    if capacity_factor is None and lm.cfg.n_experts:
        assert float(ref_metrics["dropped_frac"]) > 0
    lm.params.requires_grad_(True)
    loss, metrics = lm.loss(_port(batch))
    loss.backward()
    _close(loss.detach(), ref_loss, MODEL_RTOL, MODEL_ATOL)
    _close_metrics(metrics, ref_metrics)
    ref_flat = flat_dict(convert.lm_params_from_reference(jax.tree.map(np.asarray, ref_grads),
                                                          lm.cfg, device="cpu"))
    got = flat_dict(lm.params)
    assert sorted(got) == sorted(ref_flat)
    for key, p in got.items():
        ref = ref_flat[key].detach()
        if p.grad is None:
            assert key == "bangkv_codebooks" and not bool(ref.any()), key
            continue
        np.testing.assert_allclose(p.grad.numpy(), ref.numpy(), rtol=MODEL_RTOL, atol=MODEL_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["glm4-9b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_remat_changes_nothing(name):
    """Remat recomputes each layer in backward: the loss and every gradient
    equal those of a run that keeps the activations, bit for bit."""
    _, _, lm = _pair(name)
    batch = _port(_batch(lm.cfg))
    out = []
    for remat in (True, False):
        m = LM(dataclasses.replace(lm.cfg, remat=remat), lm.params)
        m.params.requires_grad_(True)
        m.params.zero_grad(set_to_none=True)
        loss, _ = m.loss(batch)
        loss.backward()
        out.append((loss.detach(), {k: p.grad.clone() for k, p in flat_dict(m.params).items()
                                    if p.grad is not None}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1) and g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_train_mode_makes_no_caches():
    """Training keeps no K and V: every family's stack returns no caches."""
    for name in ("granite-3-2b", "mamba2-2.7b", "zamba2-2.7b"):
        _, _, lm = _pair(name)
        h = torch.randn(2, 8, lm.cfg.d_model)
        out, aux, caches = decoder_stack(lm.cfg, lm.params, h, mode="train")
        assert caches is None and out.shape == h.shape and float(aux.load_balance) == 0.0
    with pytest.raises(ValueError, match="mode"):
        decoder_stack(lm.cfg, lm.params, h, mode="encode")


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_arch_train_step(name):
    """The counterpart of tests/test_models.py::test_arch_train_step, in
    bf16 on the port's own random parameters: a finite scalar loss, and an
    SGD step at some step size lowers it on the same batch."""
    cfg = configs.get(name).reduced()
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = _port(_batch(cfg, seed=5))
    lm.params.requires_grad_(True)
    loss, _ = lm.loss(batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    loss.backward()
    improved = False
    with torch.no_grad():
        base = {k: p.detach().clone() for k, p in flat_dict(lm.params).items()}
        for lr in (0.5, 0.1, 0.02):
            for k, p in flat_dict(lm.params).items():
                if p.grad is not None:
                    p.copy_((base[k].float() - lr * p.grad.float()).to(p.dtype))
            loss2, _ = lm.loss(batch)
            assert bool(torch.isfinite(loss2))
            if float(loss2) < float(loss):
                improved = True
                break
    assert improved, f"no step size reduced the loss for {name}"
