"""The port's checkpoint store against the reference's, on the CPU.

The reference's own checkpoint tests (``tests/test_train_ft.py``:
atomicity, the crc32 corruption error, retention, ``save_async``) run
against the port; its keys equal the reference's ``_flatten`` of the same
``TrainState``; and a checkpoint crosses between the packages both ways,
bit for bit: a ``TrainState`` of bf16 parameters saved by
``repro.checkpoint.save_checkpoint`` restores into the port's per-layer
parameters, and the port's save restores in
``repro.checkpoint.restore_checkpoint``.
"""

import glob
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.checkpoint.store import _flatten as ref_flatten
from repro.configs import get_smoke as ref_get_smoke
from repro.models.model import LM as RefLM
from repro.train import optim as ref_optim
from repro.train.train_step import TrainState as RefTrainState

from repro_torch.checkpoint import (CheckpointManager, available_steps,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke
from repro_torch.interop import (lm_arrays_from_state_dict,
                                 lm_reference_name,
                                 lm_state_dict_from_arrays)
from repro_torch.models.model import LM
from repro_torch.train import optim
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)

# depth tier, beside tests/test_train_ft.py
pytestmark = pytest.mark.slow


def test_checkpoint_atomicity_and_integrity(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.int32),
            "b": {"c": torch.ones((3, 3))}}
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, tree)
    save_checkpoint(d, 2, {"a": tree["a"] + 1, "b": {"c": tree["b"]["c"] + 1}})
    assert available_steps(d) == [1, 2]
    assert not glob.glob(os.path.join(d, "*.tmp"))
    back, step, extra = restore_checkpoint(d, tree)
    assert step == 2 and extra == {}
    assert torch.equal(back["a"], torch.arange(10, dtype=torch.int32) + 1)
    assert torch.equal(back["b"]["c"], torch.full((3, 3), 2.0))
    back1, step1, _ = restore_checkpoint(d, tree, step=1)
    assert step1 == 1 and torch.equal(back1["a"], tree["a"])

    # corruption is detected
    victim = glob.glob(os.path.join(d, "step_0000000002", "a.bin"))[0]
    with open(victim, "r+b") as f:
        f.seek(0)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(d, tree)


def test_a_crash_before_the_commit_leaves_the_last_checkpoint(tmp_path,
                                                              monkeypatch):
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, {"w": torch.zeros(4)})

    def torn(directory, leaf):
        raise OSError("disk gone")

    monkeypatch.setattr(store, "_write_leaf", torn)
    with pytest.raises(OSError, match="disk gone"):
        save_checkpoint(d, 2, {"w": torch.ones(4)})
    assert available_steps(d) == [1]
    back, step, _ = restore_checkpoint(d, {"w": torch.ones(4)})
    assert step == 1 and torch.equal(back["w"], torch.zeros(4))


def test_checkpoint_manager_retention_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "r"), keep=2)
    tree = {"w": torch.zeros((4,))}
    for s in (1, 2, 3, 4):
        mgr.save_async(s, {"w": tree["w"] + s})
    mgr.wait()
    assert available_steps(str(tmp_path / "r")) == [3, 4]
    assert mgr.latest_step() == 4


def test_save_async_copies_the_state_before_it_returns(tmp_path,
                                                       monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "r"))
    w = torch.arange(6, dtype=torch.float32)
    gate = threading.Event()
    commit = store._commit

    def slow_commit(*args):
        assert gate.wait(10.0)
        return commit(*args)

    monkeypatch.setattr(store, "_commit", slow_commit)
    mgr.save_async(1, {"w": w}, extra={"batcher": {"cursor": 3}})
    w.add_(100.0)                     # the training step goes on
    gate.set()
    mgr.wait()
    back, step, extra = mgr.restore({"w": w})
    assert step == 1 and extra == {"batcher": {"cursor": 3}}
    assert torch.equal(back["w"], torch.arange(6, dtype=torch.float32))


def test_a_failed_async_save_raises_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "r"))

    def broken(*args):
        raise OSError("no space left")

    monkeypatch.setattr(store, "_commit", broken)
    mgr.save_async(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError, match="no space left"):
        mgr.wait()
    mgr.wait()                        # reported once


def test_restore_into_writes_the_state_in_place(tmp_path):
    d = str(tmp_path / "c")
    save_checkpoint(d, 3, {"w": torch.arange(4.0), "s": torch.tensor(7)})
    like = {"w": torch.zeros(4), "s": torch.tensor(0)}
    w = like["w"]
    back, step, _ = restore_checkpoint(d, like, into=True)
    assert back["w"] is w and torch.equal(w, torch.arange(4.0))
    assert int(like["s"]) == 7
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, {"w": torch.zeros(5), "s": torch.tensor(0)},
                           into=True)


# ---------------------------------------------------------------------------
# the reference's format
# ---------------------------------------------------------------------------

def ref_state(arch, seed=0):
    """The reference's TrainState of the smoke model (bf16 parameters),
    with a non-zero step and moments."""
    cfg = ref_get_smoke(arch)
    params = RefLM(cfg).init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    moments = [{k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
                for k, v in params.items()} for _ in range(2)]
    return RefTrainState(params, ref_optim.AdamWState(
        jnp.asarray(5, jnp.int32), *moments))


def port_state(arch):
    lm = LM(get_smoke(arch), device="cpu")
    return lm, init_train_state(lm)


@pytest.mark.parametrize("arch", ["qwen3_8b", "gemma3_4b",
                                  "deepseek_v2_236b"])
def test_keys_equal_the_reference_flatten(arch):
    ref_items = ref_flatten(ref_state(arch))[0]
    _, state = port_state(arch)
    leaves = store._flatten(state)
    assert [l.key for l in leaves] == [k for k, _ in ref_items]
    ref_leaves = dict(ref_items)
    for l in leaves:
        assert l.shape == list(ref_leaves[l.key].shape), l.key
        assert l.dtype == str(ref_leaves[l.key].dtype), l.key


@pytest.mark.parametrize("arch", ["qwen3_8b", "gemma3_4b",
                                  "granite_moe_1b_a400m"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    rs = ref_state(arch)
    d = str(tmp_path / "c")
    ref_save(d, 5, rs, extra={"batcher": {"cursor": 9, "epoch": 1}})
    manifest = json.load(open(os.path.join(d, "step_0000000005",
                                           "manifest.json")))
    assert {l["dtype"] for l in manifest["leaves"]} == {"bfloat16",
                                                        "float32", "int32"}
    lm, state = port_state(arch)
    back, step, extra = restore_checkpoint(d, state, into=True)
    assert step == 5 and extra == {"batcher": {"cursor": 9, "epoch": 1}}
    assert int(back.opt.step) == 5 and back.opt.step.dtype == torch.int32
    for name, p in lm.named_parameters():
        ref_name, idx = lm_reference_name(name)
        assert back.params[name] is p
        assert str(p.dtype) == f"torch.{rs.params[ref_name].dtype}"
        want = np.asarray(rs.params[ref_name].astype(jnp.float32))[idx]
        np.testing.assert_array_equal(p.detach().float().numpy(), want,
                                      err_msg=name)
        for tree, ref_tree in ((back.opt.m, rs.opt.m),
                               (back.opt.v, rs.opt.v)):
            np.testing.assert_array_equal(
                tree[name].numpy(), np.asarray(ref_tree[ref_name])[idx],
                err_msg=name)
    # and without into=: new tensors of the checkpoint's dtype
    fresh, _, _ = restore_checkpoint(d, state)
    assert all(fresh.params[n] is not p and torch.equal(fresh.params[n], p)
               for n, p in lm.named_parameters())


@pytest.mark.parametrize("arch", ["qwen3_8b", "gemma3_4b",
                                  "granite_moe_1b_a400m"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    lm, state = port_state(arch)
    rng = np.random.default_rng(1)
    b = {k: torch.from_numpy(rng.integers(0, lm.cfg.vocab, (2, 16)))
         for k in ("tokens", "labels")}
    state, _ = make_train_step(lm, optim.AdamWConfig())(state, b)
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, state, extra={"batcher": {"cursor": 4}})
    like = ref_state(arch)
    back, step, extra = ref_restore(d, like)
    assert step == 1 and extra == {"batcher": {"cursor": 4}}
    assert int(back.opt.step) == 1
    want = lm_arrays_from_state_dict(dict(lm.named_parameters()))
    assert set(want) == set(back.params)
    for k, v in want.items():
        assert back.params[k].dtype == like.params[k].dtype
        np.testing.assert_array_equal(np.asarray(back.params[k], np.float32),
                                      v, err_msg=k)
    for mine, theirs in ((state.opt.m, back.opt.m), (state.opt.v,
                                                     back.opt.v)):
        for k, v in lm_arrays_from_state_dict(mine).items():
            np.testing.assert_array_equal(np.asarray(theirs[k]), v,
                                          err_msg=k)


def test_bfloat16_is_stored_as_its_raw_words(tmp_path):
    w = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, {"w": w})
    path = os.path.join(d, "step_0000000001")
    leaf = json.load(open(os.path.join(path, "manifest.json")))["leaves"][0]
    assert leaf["dtype"] == "bfloat16" and leaf["shape"] == [3]
    raw = open(os.path.join(path, leaf["file"]), "rb").read()
    assert raw == w.view(torch.int16).numpy().tobytes()
    back, _, _ = restore_checkpoint(d, {"w": torch.zeros(3)})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], w)


def test_a_stack_with_a_missing_layer_is_refused(tmp_path):
    tree = {"segments.blocks.0.w": torch.zeros(2),
            "segments.blocks.2.w": torch.zeros(2)}
    with pytest.raises(ValueError, match="do not fill"):
        save_checkpoint(str(tmp_path / "c"), 1, tree)
