"""The port's CheckpointManager (vqa_tpu_torch/engine/checkpoint.py) under
injected crashes, as tests/test_failure_recovery.py holds the JAX package's
Orbax manager: a crash at any point of a save leaves ``--resume`` a
complete directory. Also: the info.json the port writes equals the JAX
manager's for the same calls, and the optimizer state round-trips through
its named arrays bit for bit."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch import nn

from vqa_tpu_torch.config import OptimOptions
from vqa_tpu_torch.engine import optim
from vqa_tpu_torch.engine.checkpoint import CheckpointManager
from vqa_tpu_torch.engine.steps import create_state
from vqa_tpu_torch.models.layers import Dense

torch.set_num_threads(1)


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = Dense(3, 4, dtype=torch.float32, device="cpu")
        self.requires_grad_(True)


def _state(value: float, knobs=None):
    model = _Tiny()
    with torch.no_grad():
        model.dense.kernel.fill_(value)
    return create_state(model, optim.factory(OptimOptions(**(knobs or {"lr": 1e-3})), 1))


def _kernel(state) -> np.ndarray:
    return state.model.dense.kernel.detach().numpy()


def _crash_mid_write(ckpt, monkeypatch):
    def crashing_write(path, state):
        # die after the temporary directory exists, before the rename
        os.makedirs(path + ".tmp", exist_ok=True)
        raise RuntimeError("injected crash")

    monkeypatch.setattr(ckpt, "_write_dir", crashing_write)


def test_crash_during_save_keeps_previous_resume_point(tmp_path, monkeypatch):
    """A crash mid-save (a partial temporary directory, info.json untouched)
    leaves --resume latest on the previous epoch; the epoch re-saves."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(_state(1.0), epoch=0, acc=0.5)
    _crash_mid_write(ckpt, monkeypatch)
    with pytest.raises(RuntimeError, match="injected crash"):
        ckpt.save(_state(2.0), epoch=1, acc=0.9)
    assert not os.path.exists(tmp_path / "epoch_0001")  # never renamed into place

    mgr = CheckpointManager(str(tmp_path))
    assert mgr.info()["latest"] == 0
    restored, epoch = mgr.restore(_state(0.0), "latest")
    assert epoch == 0
    np.testing.assert_array_equal(_kernel(restored), np.full((3, 4), 1.0))

    mgr.save(_state(2.0), epoch=1, acc=0.9)  # over the crash's leftovers
    restored, epoch = mgr.restore(_state(0.0), "latest")
    assert epoch == 1
    np.testing.assert_array_equal(_kernel(restored), np.full((3, 4), 2.0))
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_crash_between_ckpt_write_and_info_update(tmp_path, monkeypatch):
    """The directory is written but the process dies before info.json
    flips: info still names the prior epoch, whose directory is intact, and
    re-saving the newer epoch replaces the orphan."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(_state(1.0), epoch=0, acc=0.5)

    def crashing_write(info):
        raise RuntimeError("injected crash before info update")

    monkeypatch.setattr(ckpt, "_write_info", crashing_write)
    with pytest.raises(RuntimeError, match="injected crash"):
        ckpt.save(_state(2.0), epoch=1, acc=0.6)
    assert os.path.isdir(tmp_path / "epoch_0001")  # orphan

    mgr = CheckpointManager(str(tmp_path))
    restored, epoch = mgr.restore(_state(0.0), "latest")
    assert epoch == 0
    np.testing.assert_array_equal(_kernel(restored), np.full((3, 4), 1.0))
    assert mgr.save(_state(3.0), epoch=1, acc=0.7) is True
    restored, epoch = mgr.restore(_state(0.0), "best")
    assert epoch == 1
    np.testing.assert_array_equal(_kernel(restored), np.full((3, 4), 3.0))


def test_stale_info_tmp_is_ignored(tmp_path):
    """A crash mid info-write leaves info.json.tmp; the committed info.json
    stays authoritative."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(_state(1.0), epoch=0, acc=0.5)
    with open(tmp_path / "info.json.tmp", "w") as f:
        f.write('{"latest": 99, "corrupt')
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.info()["latest"] == 0
    _, epoch = mgr.restore(_state(0.0), "latest")
    assert epoch == 0


def test_resume_missing_epoch_fails_loudly(tmp_path):
    """An epoch whose directory was lost raises instead of reinitializing."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(_state(1.0), epoch=0, acc=0.5)
    shutil.rmtree(tmp_path / "epoch_0000")
    with pytest.raises(FileNotFoundError, match="epoch_0000"):
        ckpt.restore(_state(0.0), "latest")
    with pytest.raises(FileNotFoundError, match="epoch_0000"):
        ckpt.restore_params(_Tiny(), "latest")


def test_step_checkpoint_save_prunes_previous_and_survives_crash(tmp_path, monkeypatch):
    """Exactly one step checkpoint lives at a time, and a crash during the
    next step save leaves the previous one restorable."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_step(_state(1.0), epoch=0, next_step=2)
    assert ckpt.step_info() == (0, 2)
    ckpt.save_step(_state(2.0), epoch=0, next_step=4)
    assert ckpt.step_info() == (0, 4)
    assert not os.path.exists(tmp_path / "inepoch_0000_00000002")
    assert os.path.isdir(tmp_path / "inepoch_0000_00000004")

    _crash_mid_write(ckpt, monkeypatch)
    with pytest.raises(RuntimeError, match="injected crash"):
        ckpt.save_step(_state(3.0), epoch=0, next_step=6)

    mgr = CheckpointManager(str(tmp_path))
    assert mgr.step_info() == (0, 4)
    restored, epoch, next_step = mgr.restore_step(_state(0.0))
    assert (epoch, next_step) == (0, 4)
    np.testing.assert_array_equal(_kernel(restored), np.full((3, 4), 2.0))


def test_clear_step_removes_point_and_dir(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.clear_step()  # no-op without a live point
    ckpt.save_step(_state(1.0), epoch=1, next_step=8)
    ckpt.clear_step()
    assert ckpt.step_info() is None
    assert not [d for d in os.listdir(tmp_path) if d.startswith("inepoch_")]
    with pytest.raises(FileNotFoundError):
        ckpt.restore_step(_state(0.0))


def test_step_checkpoint_does_not_disturb_epoch_bookkeeping(tmp_path):
    """Epoch saves, best/latest and pruning ignore the step checkpoint."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(_state(1.0), epoch=0, acc=0.5)
    ckpt.save_step(_state(1.5), epoch=1, next_step=2)
    ckpt.save(_state(2.0), epoch=1, acc=0.9)
    ckpt.clear_step()
    info = ckpt.info()
    assert info["latest"] == 1 and info["best"] == 1
    assert info["epochs"] == [1]  # epoch 0 is neither latest nor best: pruned
    restored, epoch = ckpt.restore(_state(0.0), "best")
    assert epoch == 1
    np.testing.assert_array_equal(_kernel(restored), np.full((3, 4), 2.0))


def test_info_survives_json_roundtrip_with_resume_retrain(tmp_path):
    """Resume and retrain an epoch: the epochs list does not duplicate, and
    the re-saved epoch replaces the old directory."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(_state(1.0), epoch=0, acc=0.5)
    ckpt.save(_state(2.0), epoch=1, acc=0.6)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(2.5), epoch=1, acc=0.65)
    info = mgr.info()
    assert info["epochs"].count(1) == 1
    assert info["latest"] == 1 and info["best"] == 1
    restored, _ = mgr.restore(_state(0.0), "best")
    np.testing.assert_array_equal(_kernel(restored), np.full((3, 4), 2.5))
    with open(tmp_path / "info.json") as f:
        json.load(f)
    assert not [d for d in os.listdir(tmp_path) if d.endswith((".old", ".tmp"))]


def _calls(mgr, make_state):
    mgr.save(make_state(1.0), 0, 0.5)
    mgr.save_step(make_state(1.5), 1, 2)
    mgr.save_step(make_state(1.6), 1, 4)
    mgr.save(make_state(2.0), 1, 0.4)
    mgr.clear_step()
    mgr.save(make_state(3.0), 2, 0.7)
    mgr.save_step(make_state(3.5), 3, 6)
    mgr.save(make_state(4.0), 3, 0.7)
    mgr.save(make_state(5.0), 4, None)


@pytest.mark.parametrize("save_all_from", [None, 2])
def test_info_json_equals_the_jax_managers(tmp_path, save_all_from):
    """The same sequence of save / save_step / clear_step calls writes the
    same info.json and keeps the same directories in both packages."""
    import jax.numpy as jnp
    import optax
    from flax.training import train_state

    from vqa_tpu.engine.checkpoint import CheckpointManager as JaxManager

    def jax_state(value):
        params = {"dense": {"kernel": jnp.full((3, 4), value, jnp.float32)}}
        return train_state.TrainState.create(apply_fn=lambda *a, **k: None, params=params,
                                             tx=optax.adam(1e-3))

    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    _calls(CheckpointManager(port, save_all_from), _state)
    _calls(JaxManager(jax, save_all_from), jax_state)
    for d in (port, jax):
        assert os.listdir(d)
    with open(os.path.join(port, "info.json")) as f:
        got = json.load(f)
    with open(os.path.join(jax, "info.json")) as f:
        want = json.load(f)
    assert got == want
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax))


OPTIM_CASES = {
    "adam": dict(optimizer="adam", lr=1e-2),
    "sgd_momentum": dict(optimizer="sgd", lr=1e-2, momentum=0.9),
    "adam_clip_decay": dict(optimizer="adam", lr=1e-2, grad_clip=1.5, weight_decay=1e-2,
                            lr_decay=0.5),
    "sgd_accum3": dict(optimizer="sgd", lr=5e-2, momentum=0.8, grad_accum=3),
}


@pytest.mark.parametrize("case", sorted(OPTIM_CASES))
def test_optimizer_state_round_trips_bit_for_bit(tmp_path, case):
    """A state after 4 micro-steps (mid-accumulation under grad_accum=3)
    saved and restored into a fresh template: every array and count equal,
    and the next updates from both states equal bit for bit."""
    knobs = OPTIM_CASES[case]
    rng = np.random.default_rng(1)
    state = _state(0.3, knobs)
    grads = [[torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
              for p in state.params] for _ in range(5)]
    for g in grads[:4]:
        updates, state.opt_state = state.tx.update(g, state.opt_state,
                                                   [p.detach() for p in state.params])
        optim.apply_updates(state.params, updates)
        state.step += 1
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_step(state, 0, 4)
    restored, _, _ = ckpt.restore_step(_state(0.0, knobs))
    keys = ["dense/kernel", "dense/bias"]
    want, got = optim.state_arrays(state.opt_state, keys), optim.state_arrays(restored.opt_state,
                                                                              keys)
    assert sorted(got) == sorted(want) and restored.step == state.step == 4
    for name in want:
        assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]), name
    if knobs.get("grad_accum"):
        assert int(want["mini_step"]) == 1 and "grad_accum/dense/kernel" in want
    a, _ = state.tx.update(grads[4], state.opt_state, [p.detach() for p in state.params])
    b, _ = restored.tx.update(grads[4], restored.opt_state, [p.detach() for p in restored.params])
    for x, y in zip(a or [], b or []):
        assert torch.equal(x, y)


def test_restore_names_the_mismatched_leaf(tmp_path):
    """A template of other shapes fails naming the leaf; a core-bias
    mismatch carries the original's hint."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(_state(1.0), epoch=0, acc=0.5)
    other = _Tiny()
    other.dense = Dense(3, 5, dtype=torch.float32, device="cpu").requires_grad_(True)
    with pytest.raises(ValueError, match="dense/kernel"):
        ckpt.restore(create_state(other, optim.factory(OptimOptions(lr=1e-3))), "latest")
    extra = _Tiny()
    extra.b_core_q = nn.Parameter(torch.zeros(2))
    with pytest.raises(RuntimeError, match="core_bias=false"):
        ckpt.restore(create_state(extra, optim.factory(OptimOptions(lr=1e-3))), "latest")
