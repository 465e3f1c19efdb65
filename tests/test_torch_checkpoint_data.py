"""The token stream and the checkpoints of the port.

`TokenStream` is a copy of the reference's: its batches equal the
reference's element for element. The checkpoint tests are the reference's
own (tests/test_checkpoint.py: round trip, GC, torn writes, the async
manager, placement on restore) run on the port, plus the training state's
round trip (a `ParamTree` and an `AdamWState`) and the on-disk layout.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.data import TokenStream as RTokenStream
import repro_torch.configs as configs
from repro_torch.checkpoint import CheckpointManager, latest_step, load_checkpoint, save_checkpoint
from repro_torch.data import TokenStream
from repro_torch.models import LM
from repro_torch.models.layers import ParamTree
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import flat_dict, leaves

torch.set_num_threads(1)   # one intra-op thread: the suite runs a pytest-xdist worker a core


@pytest.mark.parametrize("kw", [dict(vocab_size=1000, seq_len=32, global_batch=4, seed=5),
                                dict(vocab_size=49_155, seq_len=64, global_batch=8, seed=1,
                                     shard=1, n_shards=2),
                                dict(vocab_size=500, seq_len=16, global_batch=2, seed=2,
                                     frontend=(6, 32))])
def test_token_stream_equals_reference(kw):
    kw = dict(kw)
    args = (kw.pop("vocab_size"), kw.pop("seq_len"), kw.pop("global_batch"))
    ours, ref = TokenStream(*args, **kw), RTokenStream(*args, **kw)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_token_stream_prefetch_and_labels():
    s = TokenStream(500, 16, 2, seed=2)
    gen = s.prefetch(start_step=4)
    step, batch = next(gen)
    assert step == 4
    np.testing.assert_array_equal(batch["tokens"], s.batch_at(4)["tokens"])
    gen.close()
    b = s.batch_at(3)
    np.testing.assert_array_equal(b["tokens"][0, 1:], b["labels"][0, :-1])


def _tree(rng):
    return {
        "a": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
        "b": {"c": torch.from_numpy(rng.integers(0, 100, (3,)).astype(np.int32))},
        "d": torch.from_numpy(rng.standard_normal((5,)).astype(np.float32)).to(torch.bfloat16),
    }


def test_roundtrip_bit_exact(tmp_path):
    tree = _tree(np.random.default_rng(0))
    save_checkpoint(str(tmp_path), 7, tree)
    restored, step = load_checkpoint(str(tmp_path), tree)
    assert step == 7
    for a, b in zip(leaves(tree), leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_layout_matches_reference(tmp_path):
    """step_%08d/arrays.npz + manifest.json; bf16 stored as a uint16 view,
    its dtype named in the manifest."""
    tree = _tree(np.random.default_rng(1))
    path = save_checkpoint(str(tmp_path), 3, tree, extra={"loss": 1.5})
    assert os.path.basename(path) == "step_00000003"
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["dtypes"] == {"a": "float32", "b/c": "int32", "d": "bfloat16"}
    assert manifest["step"] == 3 and manifest["n_arrays"] == 3 and manifest["extra"] == {"loss": 1.5}
    data = np.load(os.path.join(path, "arrays.npz"))
    assert data["d"].dtype == np.uint16
    np.testing.assert_array_equal(data["d"], tree["d"].view(torch.int16).numpy().view(np.uint16))


def test_gc_keeps_last(tmp_path):
    tree = _tree(np.random.default_rng(0))
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, tree, keep_last=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]


def test_latest_step_ignores_torn_writes(tmp_path):
    tree = _tree(np.random.default_rng(0))
    save_checkpoint(str(tmp_path), 3, tree)
    os.makedirs(tmp_path / "step_00000009.tmp")  # simulated torn write
    os.makedirs(tmp_path / "step_00000010")      # no manifest -> invalid
    assert latest_step(str(tmp_path)) == 3
    assert latest_step(str(tmp_path / "missing")) is None


def test_async_manager_snapshots_before_the_thread(tmp_path):
    """The manager copies the tensors to the host before its thread starts:
    an in-place update right after `maybe_save` does not reach the file."""
    tree = _tree(np.random.default_rng(0))
    before = tree["a"].clone()
    mgr = CheckpointManager(str(tmp_path), every=2, keep_last=5)
    assert not mgr.maybe_save(1, tree)       # not on cadence
    assert mgr.maybe_save(2, tree)
    tree["a"].add_(1.0)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 2
    restored, _ = load_checkpoint(str(tmp_path), tree)
    assert torch.equal(restored["a"], before)


def test_restore_respects_placement_fn(tmp_path):
    """placement_fn(key, array) places each array -- the counterpart of the
    reference's sharding_fn; None falls back to `device`, then to the
    template leaf's device."""
    tree = _tree(np.random.default_rng(0))
    save_checkpoint(str(tmp_path), 1, tree)
    calls = []

    def placement_fn(key, arr):
        calls.append((key, arr.shape))
        return "cpu" if key == "a" else None

    restored, _ = load_checkpoint(str(tmp_path), tree, placement_fn=placement_fn, device="cpu")
    assert sorted(k for k, _ in calls) == ["a", "b/c", "d"]
    assert all(x.device.type == "cpu" for x in leaves(restored))


def test_training_state_roundtrip(tmp_path):
    """(params, AdamWState) of a reduced bf16 LM after a step: a new
    `ParamTree` comes back, trainable as its template, every tensor equal;
    the keys are the port's tree paths."""
    cfg = configs.get("granite-3-2b").reduced()
    params = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).params
    params.requires_grad_(True)
    state = adamw_init(params)
    grads = {k: torch.randn(p.shape) for k, p in flat_dict(params).items()}
    params, state, _ = adamw_update(grads, state, params, 0.01)
    save_checkpoint(str(tmp_path), 1, (params, state))
    data = np.load(tmp_path / "step_00000001" / "arrays.npz")
    assert "0/layers/1/attn/wq" in data and "1/master/layers/1/attn/wq" in data and "1/step" in data
    (p2, s2), step = load_checkpoint(str(tmp_path), (params, state))
    assert step == 1 and isinstance(p2, ParamTree) and p2 is not params
    assert all(p.requires_grad for p in p2.parameters())
    assert flat_dict(p2).keys() == flat_dict(params).keys()
    for a, b in zip(leaves((params, state)), leaves((p2, s2))):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())
    assert LM(cfg, p2).params["layers"][1]["attn"]["wq"].dtype == torch.bfloat16
