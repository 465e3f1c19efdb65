"""The optimizer, the schedule and int8 error feedback: the port held
against the reference package's `optim/` on the same inputs, and the
reference's own behavioural tests (tests/test_optim.py) run on the port.

Bounds: `warmup_cosine` and `ef_int8_compress` bit-equal; AdamW's moments,
master copies and parameters within rtol 1e-6, atol 1e-8 after three steps.
The global norm sums its leaves in another order (the reference's layers
are stacked, the port's are not), so under clipping the scale and with it
every gradient differ in the last bit; a master entry near 0 then moves by
a few float32 ulps of the step (lr 1e-2) and of entries at the init scale
(2e-2: an ulp is 1.9e-9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as rconfigs
from repro.models.transformer import LM as RLM
from repro.optim import adamw as radamw
from repro.optim import compression as rcomp
from repro.optim import schedule as rschedule
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.optim import (AdamWConfig, CompressionState, adamw_init, adamw_update,
                               compression_init, ef_int8_compress, global_norm, warmup_cosine)
from repro_torch.tree import flat_dict

from _lm_parity import KEY

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core

ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-8


def _eq(got: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_warmup_cosine_matches_reference():
    for step in [0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 140]:
        kw = dict(peak=3e-4, warmup=10, total=100)
        _eq(warmup_cosine(step, **kw), rschedule.warmup_cosine(step, **kw))
        _eq(warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw),
            rschedule.warmup_cosine(jnp.int32(step), **kw))
    for step in range(6):   # warmup 0 and a total no longer than the warmup
        _eq(warmup_cosine(step, peak=1.0, warmup=0, total=4, floor=0.2),
            rschedule.warmup_cosine(step, peak=1.0, warmup=0, total=4, floor=0.2))
        _eq(warmup_cosine(step, peak=1.0, warmup=3, total=2),
            rschedule.warmup_cosine(step, peak=1.0, warmup=3, total=2))


def test_warmup_cosine_shape():
    """tests/test_optim.py::test_warmup_cosine_shape on the port."""
    assert float(warmup_cosine(0, peak=1.0, warmup=10, total=100)) == 0.0
    assert float(warmup_cosine(10, peak=1.0, warmup=10, total=100)) == 1.0
    assert 0.05 < float(warmup_cosine(100, peak=1.0, warmup=10, total=100)) < 0.2


def _model_state():
    """The reduced granite's reference parameters (float32) in both
    packages, and the port's LM tree."""
    cfg = configs.get("granite-3-2b").reduced(dtype="float32")
    rparams = RLM(rconfigs.get("granite-3-2b").reduced(dtype="float32")).init(KEY)
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, rparams, params


def _grads(rparams, seed: int):
    """Random gradients of the parameters' structure; the codebooks' are 0,
    as the loss gives them."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(rparams)
    leaves = []
    for path, leaf in flat:
        if "bangkv_codebooks" in jax.tree_util.keystr(path):
            leaves.append(jnp.zeros_like(leaf))
        else:
            leaves.append(jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * 0.3))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def test_adamw_update_matches_reference():
    """Three steps at the schedule's lr for the step before the increment
    (0 at the first step: nothing moves), every leaf updated: the codebooks,
    whose gradient is None in the port and zero in the reference, move by
    weight decay alone from the second step on."""
    cfg, rparams, params = _model_state()
    rstate, state = radamw.adamw_init(rparams), adamw_init(params)
    cb0 = params["bangkv_codebooks"].detach().clone()
    opt = AdamWConfig()
    for i in range(3):
        rg = _grads(rparams, i)
        grads = {k: v.detach() for k, v in flat_dict(convert.lm_params_from_reference(
            jax.tree.map(np.asarray, rg), cfg, device="cpu")).items()}
        grads["bangkv_codebooks"] = None
        kw = dict(peak=1e-2, warmup=1, total=10)
        rlr = rschedule.warmup_cosine(rstate.step, **kw)
        lr = warmup_cosine(state.step, **kw)
        assert (float(lr) == 0.0) == (i == 0)
        rparams, rstate, rmet = radamw.adamw_update(rg, rstate, rparams, rlr, opt)
        params, state, met = adamw_update(grads, state, params, lr, opt)
        np.testing.assert_allclose(float(met["grad_norm"]), float(rmet["grad_norm"]), rtol=1e-6)
        assert float(met["lr"]) == float(rmet["lr"])
        if i == 0:
            assert torch.equal(params["bangkv_codebooks"], cb0)
    assert int(state.step) == int(rstate.step) == 3
    ref_state = convert.adamw_state_from_reference(jax.tree.map(np.asarray, rstate), cfg, device="cpu")
    ref_params = flat_dict(convert.lm_params_from_reference(jax.tree.map(np.asarray, rparams), cfg,
                                                           device="cpu"))
    for k, p in flat_dict(params).items():
        for got, ref in ((state.mu[k], ref_state.mu[k]), (state.nu[k], ref_state.nu[k]),
                         (state.master[k], ref_state.master[k]), (p.detach(), ref_params[k])):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=ADAM_RTOL, atol=ADAM_ATOL,
                                       err_msg=k)
    # Weight decay alone moved the codebooks: mu and nu stay 0.
    assert not bool(state.mu["bangkv_codebooks"].any()) and not bool(state.nu["bangkv_codebooks"].any())
    assert float((params["bangkv_codebooks"] - cb0).abs().max()) > 0


def test_adamw_bf16_params_follow_master():
    """bf16 parameters are the float32 master copies rounded once."""
    p = {"w": torch.randn(64).to(torch.bfloat16)}
    state = adamw_init(p)
    assert state.master["w"].dtype == torch.float32 and state.master["w"].data_ptr() != p["w"].data_ptr()
    for _ in range(2):
        adamw_update({"w": torch.randn(64)}, state, p, 0.01)
    assert torch.equal(p["w"], state.master["w"].to(torch.bfloat16))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal(s).astype(np.float32) for s in ((3, 5), (17,), (2, 2, 2))]
    np.testing.assert_allclose(float(global_norm([torch.from_numpy(x) for x in xs] + [None])),
                               float(radamw.global_norm([jnp.asarray(x) for x in xs])), rtol=1e-6)


def test_grad_clipping():
    """tests/test_optim.py::test_grad_clipping on the port: the raw norm is
    reported."""
    params = {"w": torch.zeros(4)}
    _, _, metrics = adamw_update({"w": torch.full((4,), 1e6)}, adamw_init(params), params, 0.1,
                                 AdamWConfig(clip_norm=1.0))
    assert float(metrics["grad_norm"]) > 1e5


def _quadratic(rng):
    w_star = torch.from_numpy(rng.standard_normal((16,)).astype(np.float32))
    return lambda w: torch.sum((w - w_star) ** 2)


def _run_quadratic(seed: int, compress: bool) -> float:
    loss = _quadratic(np.random.default_rng(seed))
    params = {"w": torch.zeros(16)}
    state, comp = adamw_init(params), compression_init(params)
    for _ in range(300):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(loss(w), w)
        grads = {"w": g}
        if compress:
            grads, comp = ef_int8_compress(grads, comp)
        adamw_update(grads, state, params, 0.05, AdamWConfig(weight_decay=0.0))
    return float(loss(params["w"]))


def test_adamw_converges_on_quadratic():
    """tests/test_optim.py's quadratic on the port."""
    assert _run_quadratic(0, compress=False) < 1e-2


def test_compressed_grads_converge_like_uncompressed():
    l_plain, l_comp = _run_quadratic(0, False), _run_quadratic(0, True)
    assert l_comp < max(10 * l_plain, 1e-2)


def test_ef_int8_compress_matches_reference():
    """Ten rounds of error feedback bit-equal to the reference's: the
    dequantised gradients and the residuals (half-to-even rounding in both;
    one tensor with ties at .5 of its scale, one all zero)."""
    rng = np.random.default_rng(11)
    shapes = {"a": (33, 7), "b": (5,), "c": (4, 4)}
    comp = compression_init({k: torch.zeros(s) for k, s in shapes.items()})
    rcomp_state = rcomp.CompressionState(err={k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()})
    for i in range(10):
        g = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
             "b": (np.array([-254, -1, 1, 3, 254], np.float32) / 2.0) * (i + 1),
             "c": np.zeros(shapes["c"], np.float32)}
        deq, comp = ef_int8_compress({k: torch.from_numpy(v) for k, v in g.items()}, comp)
        rdeq, rcomp_state = rcomp.ef_int8_compress({k: jnp.asarray(v) for k, v in g.items()},
                                                   rcomp_state)
        for k in shapes:
            _eq(deq[k], rdeq[k])
            _eq(comp.err[k], rcomp_state.err[k])


def test_ef_int8_none_is_a_zero_gradient():
    comp = CompressionState(err={"w": torch.tensor([0.5, -0.25, 0.0])})
    deq, new = ef_int8_compress({"w": None}, comp)
    deq0, new0 = ef_int8_compress({"w": torch.zeros(3)}, comp)
    assert torch.equal(deq["w"], deq0["w"]) and torch.equal(new.err["w"], new0.err["w"])


def test_error_feedback_residual_bounded():
    """tests/test_optim.py::test_error_feedback_residual_bounded on the port."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal((64,)).astype(np.float32))}
    comp = compression_init(g)
    for _ in range(50):
        _, comp = ef_int8_compress(g, comp)
    scale = float(g["w"].abs().max()) / 127.0
    assert float(comp.err["w"].abs().max()) <= 2 * scale + 1e-6


def test_states_from_reference():
    """The reference's AdamW and compression states carried across keep
    every value, keyed by the port's parameter paths."""
    cfg, rparams, params = _model_state()
    rstate = radamw.adamw_init(rparams)
    rstate = rstate._replace(step=jnp.int32(5), mu=_grads(rparams, 1), nu=_grads(rparams, 2))
    state = convert.adamw_state_from_reference(jax.tree.map(np.asarray, rstate), cfg, device="cpu")
    assert int(state.step) == 5 and state.step.dtype == torch.int32
    assert sorted(state.mu) == sorted(flat_dict(params))
    np.testing.assert_array_equal(state.mu["layers/1/attn/wq"].numpy(),
                                  np.asarray(rstate.mu["layers"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(state.master["embed"].numpy(), np.asarray(rparams["embed"]))
    err = rcomp.CompressionState(err=_grads(rparams, 3))
    comp = convert.compression_state_from_reference(jax.tree.map(np.asarray, err), cfg, device="cpu")
    np.testing.assert_array_equal(comp.err["layers/0/ffn/w_up"].numpy(),
                                  np.asarray(err.err["layers"]["ffn"]["w_up"][0]))
