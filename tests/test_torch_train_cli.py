"""The port's train CLI (python -m vqa_tpu_torch.cli.train, no -e) against
the JAX package's, and its checkpoints, resume and SIGTERM preemption, on
the CPU over a fixture.

Parity: both CLIs train a narrow MutanAtt for 2 epochs with --platform cpu
from the same start weights (a flax init saved as an npz and given to both
as model.pretrained_params), every dropout rate 0, float32. Held: each
epoch's train loss and acc1 within 1e-4 relative, the same val acc1 each
epoch, the same best/latest, the port's epoch_0001/params.npz within 1e-4
of each leaf's norm of the JAX checkpoint, and the port's params loaded by
the JAX CLI with -e give the port's acc1. Two leaves have grads that are
sums cancelling over the 36 regions, which adam scales from rounding up to
+-lr a step: the glimpse bias (0 in exact arithmetic) is held within
lr x steps, and the attention fusion's b_core_v within 1e-3 of its norm
(on this fixture the port against itself, with 1 thread against 8, moves
it by 1.2e-4 of its norm; every other leaf by at most 1.4e-6).

Resume: 2 straight epochs against 1 epoch -> --resume latest; a mid-epoch
step checkpoint -> --resume latest; a real SIGTERM mid-epoch -> 75 ->
--resume latest. The final params and optimizer arrays are array_equal to
the straight run's (with the YAML's dropout on: it is seeded by the saved
step count).
"""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from vqa_tpu_torch.cli import train as port_cli
from vqa_tpu_torch.config import load_options
from vqa_tpu_torch.datasets import factory as port_factory
from vqa_tpu_torch.engine.checkpoint import CheckpointManager

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH_OPT = os.path.join(REPO, "options", "vqa2", "mutan_att.yaml")
TINY = ["vqa.nans=12", "optim.eval_batch_size=16",
        "model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=16",
        "model.attention.dim_hv=8", "model.attention.dim_hq=8", "model.attention.dim_mm=8",
        "model.attention.R=2", "model.fusion.dim_hv=8", "model.fusion.dim_hq=8",
        "model.fusion.dim_mm=8", "model.fusion.R=2"]
NO_DROPOUT = ["model.attention.dropout_v=0", "model.attention.dropout_q=0",
              "model.attention.dropout_mm=0", "model.fusion.dropout_v=0",
              "model.fusion.dropout_q=0", "model.classif.dropout=0"]
LR, BATCH = 1e-3, 8
REL = 1e-4
# the attention fusion's b_core_v: ~8x the port's own spread over thread
# counts on this fixture (module docstring)
CANCELLING_REL = 1e-3


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    """A fixture of 64 train and 64 val questions over 8 images each (7
    steps an epoch at batch 8: the train split keeps the questions whose
    answer is in the vocabulary), prepared by the JAX factory."""
    from vqa_tpu_torch.datasets.fixtures import generate

    d = str(tmp_path_factory.mktemp("train_cli"))
    generate(d, n_images=8, n_questions=64, seed=4, splits=("train", "val"))
    return d


def _argv(fix, logs, *extra, opts=(), path_opt=PATH_OPT, tiny=TINY):
    args = ["--path_opt", path_opt, "--platform", "cpu", "--dir_logs", logs,
            "--batch_size", str(BATCH), "--lr", str(LR), "--print_freq", "4"]
    for o in [f"vqa.dir={fix}/vqa2", f"coco.dir={fix}/coco"] + list(tiny) + list(opts):
        args += ["--opt", o]
    return args + list(extra)


def _records(run_dir, split):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r.get("split") == split]


def _info(run_dir):
    with open(os.path.join(run_dir, "ckpt", "info.json")) as f:
        return json.load(f)


def _arrays(run_dir, epoch):
    path = os.path.join(run_dir, "ckpt", f"epoch_{epoch:04d}")
    out = {}
    for name in ("params.npz", "opt_state.npz"):
        with np.load(os.path.join(path, name)) as npz:
            out.update({f"{name}:{k}": npz[k] for k in npz.files})
    with open(os.path.join(path, "state.json")) as f:
        out["step"] = json.load(f)["step"]
    return out


def _steps_per_epoch(fix):
    opt = load_options(PATH_OPT, [f"vqa.dir={fix}/vqa2", f"coco.dir={fix}/coco"] + TINY)
    return len(port_factory.factory("train", opt)) // BATCH


def _assert_identical(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert np.array_equal(a[key], b[key]) and np.asarray(a[key]).dtype == \
            np.asarray(b[key]).dtype, key


# ------------------------------------------------------------- parity


@pytest.fixture(scope="module")
def parity(fix, tmp_path_factory):
    """Both CLIs, 2 epochs each, from one flax init."""
    import jax
    import jax.numpy as jnp

    from vqa_tpu.cli.train import main as jax_main
    from vqa_tpu.config import load_options as jax_load_options
    from vqa_tpu.datasets import factory as jax_factory
    from vqa_tpu.importers import save_tree_npz
    from vqa_tpu.models import factory as jax_model_factory

    root = tmp_path_factory.mktemp("parity")
    opts = [f"vqa.dir={fix}/vqa2", f"coco.dir={fix}/coco"] + TINY + NO_DROPOUT
    jax_opt = jax_load_options(PATH_OPT, opts)
    val_set = jax_factory("val", jax_opt)
    model = jax_model_factory(jax_opt.model, val_set.num_words, val_set.num_answers)
    params = model.init(jax.random.key(3), jnp.zeros((2,) + val_set.feature_shape),
                        jnp.zeros((2, jax_opt.vqa.maxlength), jnp.int32),
                        jnp.ones((2,), jnp.int32))["params"]
    npz = str(root / "init.npz")
    save_tree_npz(npz, params)
    port_logs, jax_logs = str(root / "port"), str(root / "jax")
    extra = NO_DROPOUT + [f"model.pretrained_params={npz}"]
    assert port_cli.main(_argv(fix, port_logs, "--epochs", "2", opts=extra)) == 0
    assert jax_main(_argv(fix, jax_logs, "--epochs", "2", opts=extra)) == 0
    steps = 2 * _steps_per_epoch(fix)
    return {"port": port_logs, "jax": jax_logs, "steps": steps, "jax_main": jax_main,
            "opts": opts}


def test_train_cli_epochs_match_the_jax_cli(parity):
    """Per epoch: train loss and acc1 within 1e-4 relative, the same val
    acc1 and n; the same best, latest and epochs in info.json."""
    for split in ("train", "val"):
        got, want = _records(parity["port"], split), _records(parity["jax"], split)
        assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
        for g, w in zip(got, want):
            if split == "train":
                for key in ("loss", "acc1"):
                    assert abs(g[key] - w[key]) <= REL * max(abs(w[key]), 1e-6), (key, g, w)
            else:
                assert (g["acc1"], g["n"]) == (w["acc1"], w["n"])
    got, want = _info(parity["port"]), _info(parity["jax"])
    assert {k: got[k] for k in ("best", "latest", "epochs", "best_acc")} == \
        {k: want[k] for k in ("best", "latest", "epochs", "best_acc")}


def test_train_cli_params_match_the_jax_checkpoint(parity):
    """epoch_0001/params.npz against the JAX CLI's Orbax checkpoint of the
    same epoch: each leaf within 1e-4 of its norm; the glimpse bias within
    lr x steps, the attention fusion's b_core_v within 1e-3 of its norm
    (module docstring)."""
    import orbax.checkpoint as ocp

    from vqa_tpu.importers import flatten_tree

    tree = ocp.StandardCheckpointer().restore(os.path.join(parity["jax"], "ckpt", "epoch_0001"))
    want = {k: np.asarray(v) for k, v in flatten_tree(tree["params"]).items()}
    got = _arrays(parity["port"], 1)
    got = {k.split(":", 1)[1]: v for k, v in got.items() if k.startswith("params.npz:")}
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == np.float32, key
        if key.endswith("glimpse_logits/bias"):
            assert np.abs(got[key] - w).max() <= LR * parity["steps"], key
            continue
        rel = CANCELLING_REL if key == "attention/fusion/b_core_v" else REL
        assert np.linalg.norm(got[key] - w) <= rel * max(np.linalg.norm(w), 1e-6), key


def test_jax_cli_evaluates_the_port_checkpoint_to_the_same_acc1(parity, tmp_path):
    """The port's epoch_0001/params.npz as model.pretrained_params of the
    JAX CLI's -e: the acc1 the port logged for epoch 1."""
    npz = os.path.join(parity["port"], "ckpt", "epoch_0001", "params.npz")
    logs = str(tmp_path / "jax_eval")
    argv = ["--path_opt", PATH_OPT, "-e", "--platform", "cpu", "--dir_logs", logs]
    for o in parity["opts"] + [f"model.pretrained_params={npz}"]:
        argv += ["--opt", o]
    assert parity["jax_main"](argv) == 0
    assert _records(logs, "val")[-1]["acc1"] == _records(parity["port"], "val")[1]["acc1"]


def test_train_rows_pick_the_same_table_row_in_both_packages(fix):
    """A train row's image_index (a train2014 image) picks the same row of
    the one feature store the splits share, in both packages."""
    from vqa_tpu.config import load_options as jax_load_options
    from vqa_tpu.datasets import factory as jax_factory

    opts = [f"vqa.dir={fix}/vqa2", f"coco.dir={fix}/coco"] + TINY
    for split in ("train", "val"):
        got = port_factory.factory(split, load_options(PATH_OPT, opts), visual_mode="index")
        want = jax_factory(split, jax_load_options(PATH_OPT, opts), visual_mode="index")
        np.testing.assert_array_equal(got.image_index, want.image_index)
        assert got.features is port_factory.factory("val", load_options(PATH_OPT, opts)).features
    names = port_factory.factory("train", load_options(PATH_OPT, opts)).split.image_names
    assert all("train2014" in str(n) for n in names)


# the other archs and encoders: (YAML, tiny widths, every dropout rate 0,
# leaves held within CANCELLING_REL of their norm). CoR's pooling bias and
# its step gates' bias start at 0 and take grads that are sums cancelling
# over the objects and over the steps, which adam scales from rounding, as
# MutanAtt's b_core_v above (measured on this fixture: 1.2e-4 of the norm)
ARCHS = {
    "mfb_coatt": ("mfb_coatt", ["vqa.nans=12", "optim.eval_batch_size=16",
                                "model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=16",
                                "model.attention.dim_h=8", "model.fusion.dim_mm=8",
                                "model.fusion.pool_factor=3"],
                  ["model.seq2vec.dropout=0", "model.attention.dropout=0",
                   "model.fusion.dropout_pre=0", "model.classif.dropout=0"], ()),
    "cor": ("cor", ["vqa.nans=12", "optim.eval_batch_size=16", "model.seq2vec.emb_size=8",
                    "model.seq2vec.hidden_size=16", "model.fusion.dim_h=16",
                    "model.classif.dim_h=8"],
            ["model.seq2vec.dropout=0", "model.fusion.dropout=0", "model.classif.dropout=0"],
            ("chain/pool_hidden/bias", "step_gates/bias")),
    "mutan_att_skipthoughts": ("mutan_att", TINY + ["model.seq2vec.arch=skipthoughts"],
                               NO_DROPOUT, ("attention/fusion/b_core_v",)),
}
# leaves whose grad is 0 but for rounding (a softmax does not see them), held
# within lr x steps as the glimpse bias above
CANCELLING = ("glimpse_logits/bias", "q_attention/logits/bias", "chain/pool_logits/bias")
# MFB's training is chaotic in float32 from its first updates: the signed
# square root's derivative 0.5 / sqrt(|p|) is unbounded at the pooled values
# near 0, and adam scales the zero-initialised biases' grads up from there.
# On this fixture the port against itself (1 thread against 8) moves leaves by
# up to 1.7 of their norm in the epoch, so the MFB run is held before its
# first update: the first step's loss within 1e-5 relative and its gnorm
# within 1e-3 (tests/test_torch_train.py's MFB_REL holds the steps that
# follow); then the JAX CLI evaluates the port's checkpoint to its acc1
FIRST_LOSS_REL, MFB_GNORM_REL = 1e-5, 1e-3


def _steps(run_dir):
    with open(os.path.join(run_dir, "steps.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_train_cli_matches_the_jax_cli_for_each_arch(fix, tmp_path, name):
    """MFBCoAtt, CoR and MutanAtt with the skip-thoughts GRU: both CLIs train
    one epoch from one flax init, dropout off, to the same val n and the same
    param tree. CoR and skip-thoughts: the train loss and acc1 within 1e-4
    relative, the same val acc1, and the port's epoch_0000/params.npz within
    1e-4 of each leaf's norm of the JAX checkpoint (the softmax-blind biases
    within lr x steps, the cancelling ones of ``ARCHS`` within 1e-3).
    MFBCoAtt: the first step as ``FIRST_LOSS_REL`` says, and the JAX CLI's
    -e on the port's checkpoint gives the acc1 the port logged."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from vqa_tpu.cli.train import main as jax_main
    from vqa_tpu.config import load_options as jax_load_options
    from vqa_tpu.datasets import factory as jax_factory
    from vqa_tpu.importers import flatten_tree, save_tree_npz
    from vqa_tpu.models import factory as jax_model_factory

    yaml, tiny, no_dropout, near_cancelling = ARCHS[name]
    path_opt = os.path.join(REPO, "options", "vqa2", f"{yaml}.yaml")
    opts = [f"vqa.dir={fix}/vqa2", f"coco.dir={fix}/coco"] + tiny + no_dropout
    jax_opt = jax_load_options(path_opt, opts)
    val_set = jax_factory("val", jax_opt)
    model = jax_model_factory(jax_opt.model, val_set.num_words, val_set.num_answers)
    params = model.init(jax.random.key(3), jnp.zeros((2,) + val_set.feature_shape),
                        jnp.zeros((2, jax_opt.vqa.maxlength), jnp.int32),
                        jnp.ones((2,), jnp.int32))["params"]
    npz = str(tmp_path / "init.npz")
    save_tree_npz(npz, params)
    logs = {side: str(tmp_path / side) for side in ("port", "jax")}
    extra = no_dropout + [f"model.pretrained_params={npz}"]
    for side, main in (("port", port_cli.main), ("jax", jax_main)):
        assert main(_argv(fix, logs[side], "--epochs", "1", opts=extra, path_opt=path_opt,
                          tiny=tiny)) == 0, side
    (got_val,), (want_val,) = _records(logs["port"], "val"), _records(logs["jax"], "val")
    assert got_val["n"] == want_val["n"]
    tree = ocp.StandardCheckpointer().restore(os.path.join(logs["jax"], "ckpt", "epoch_0000"))
    want = {k: np.asarray(v) for k, v in flatten_tree(tree["params"]).items()}
    got = {k.split(":", 1)[1]: v for k, v in _arrays(logs["port"], 0).items()
           if k.startswith("params.npz:")}
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape and got[k].dtype == np.float32 for k in want)

    if name == "mfb_coatt":
        first, want_first = _steps(logs["port"])[0], _steps(logs["jax"])[0]
        assert first["step"] == want_first["step"] == 0
        assert abs(first["loss"] - want_first["loss"]) <= FIRST_LOSS_REL * want_first["loss"]
        assert abs(first["gnorm"] - want_first["gnorm"]) <= MFB_GNORM_REL * want_first["gnorm"]
        npz_port = os.path.join(logs["port"], "ckpt", "epoch_0000", "params.npz")
        argv = ["--path_opt", path_opt, "-e", "--platform", "cpu", "--dir_logs",
                str(tmp_path / "jax_eval")]
        for o in opts + [f"model.pretrained_params={npz_port}"]:
            argv += ["--opt", o]
        assert jax_main(argv) == 0
        assert _records(str(tmp_path / "jax_eval"), "val")[-1]["acc1"] == got_val["acc1"]
        return

    (got_train,), (want_train,) = _records(logs["port"], "train"), _records(logs["jax"], "train")
    for key in ("loss", "acc1"):
        assert abs(got_train[key] - want_train[key]) <= REL * max(abs(want_train[key]), 1e-6), \
            (key, got_train, want_train)
    assert got_val["acc1"] == want_val["acc1"]
    steps = len(port_factory.factory("train", load_options(path_opt, opts))) // BATCH
    for key, w in want.items():
        if key.endswith(CANCELLING):
            assert np.abs(got[key] - w).max() <= LR * steps, key
            continue
        rel = CANCELLING_REL if key in near_cancelling else REL
        assert np.linalg.norm(got[key] - w) <= rel * max(np.linalg.norm(w), 1e-6), key


# ------------------------------------------------------------- resume


@pytest.fixture(scope="module")
def straight(fix, tmp_path_factory):
    """2 epochs straight, with the YAML's dropout and step checkpoints."""
    logs = str(tmp_path_factory.mktemp("straight"))
    assert port_cli.main(_argv(fix, logs, "--epochs", "2", "--checkpoint_every_steps", "3")) == 0
    return logs


def test_resume_after_an_epoch_is_bit_identical(fix, straight, tmp_path):
    b = str(tmp_path / "resumed")
    assert port_cli.main(_argv(fix, b, "--epochs", "1")) == 0
    assert _info(b)["latest"] == 0
    assert port_cli.main(_argv(fix, b, "--epochs", "2", "--resume", "latest")) == 0
    _assert_identical(_arrays(straight, 1), _arrays(b, 1))
    assert _records(b, "val")[-1]["acc1"] == _records(straight, "val")[-1]["acc1"]


def test_midepoch_step_checkpoint_resume_is_bit_identical(fix, straight, tmp_path,
                                                          monkeypatch):
    """Die right after the step checkpoint (1, 6) lands; eval-only ignores
    it (epoch semantics); --resume latest continues from it."""
    b = str(tmp_path / "preempted")
    real_save_step = CheckpointManager.save_step

    def dying_save_step(self, state, epoch, next_step):
        real_save_step(self, state, epoch, next_step)
        if epoch == 1 and next_step >= 6:
            raise RuntimeError("injected preemption")

    monkeypatch.setattr(CheckpointManager, "save_step", dying_save_step)
    with pytest.raises(RuntimeError, match="injected preemption"):
        port_cli.main(_argv(fix, b, "--epochs", "2", "--checkpoint_every_steps", "3"))
    monkeypatch.setattr(CheckpointManager, "save_step", real_save_step)
    mgr = CheckpointManager(os.path.join(b, "ckpt"))
    assert mgr.step_info() == (1, 6) and mgr.info()["latest"] == 0
    assert port_cli.main(_argv(fix, b, "--epochs", "2", "--resume", "latest", "-e")) == 0
    assert mgr.step_info() == (1, 6)
    assert port_cli.main(_argv(fix, b, "--epochs", "2", "--checkpoint_every_steps", "3",
                               "--resume", "latest")) == 0
    assert mgr.step_info() is None
    assert not [d for d in os.listdir(os.path.join(b, "ckpt")) if d.startswith("inepoch_")]
    _assert_identical(_arrays(straight, 1), _arrays(b, 1))


def test_sigterm_checkpoints_returns_75_and_resumes_bit_identical(fix, straight, tmp_path,
                                                                   monkeypatch):
    """A real SIGTERM after the step checkpoint (1, 3): the loop saves at the
    next step, main returns 75 and puts the previous handler back; --resume
    latest finishes equal to the straight run."""
    b = str(tmp_path / "sigtermed")
    real_save_step = CheckpointManager.save_step

    def save_then_sigterm(self, state, epoch, next_step):
        real_save_step(self, state, epoch, next_step)
        if (epoch, next_step) == (1, 3):
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(CheckpointManager, "save_step", save_then_sigterm)
    rc = port_cli.main(_argv(fix, b, "--epochs", "2", "--checkpoint_every_steps", "3"))
    monkeypatch.setattr(CheckpointManager, "save_step", real_save_step)
    assert rc == 75
    assert signal.getsignal(signal.SIGTERM) is before
    mgr = CheckpointManager(os.path.join(b, "ckpt"))
    assert mgr.step_info() == (1, 4)
    with open(os.path.join(b, "ckpt", "inepoch_0001_00000004", "state.json")) as f:
        assert json.load(f)["step"] == _steps_per_epoch(fix) + 4
    assert port_cli.main(_argv(fix, b, "--epochs", "2", "--checkpoint_every_steps", "3",
                               "--resume", "latest")) == 0
    assert mgr.step_info() is None
    _assert_identical(_arrays(straight, 1), _arrays(b, 1))


def test_sigterm_run_still_writes_its_trace(fix, tmp_path, monkeypatch):
    """--profile_dir on a run preempted by SIGTERM: main returns 75 and the
    trace, stopped in main's finally, is written all the same."""
    b, trace = str(tmp_path / "sigtermed"), str(tmp_path / "trace")
    real_save_step = CheckpointManager.save_step

    def save_then_sigterm(self, state, epoch, next_step):
        real_save_step(self, state, epoch, next_step)
        if (epoch, next_step) == (0, 3):
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(CheckpointManager, "save_step", save_then_sigterm)
    rc = port_cli.main(_argv(fix, b, "--epochs", "1", "--checkpoint_every_steps", "3",
                             "--profile_dir", trace))
    assert rc == 75
    (name,) = os.listdir(trace)
    with open(os.path.join(trace, name)) as f:
        assert name.endswith(".pt.trace.json") and json.load(f)["traceEvents"]


# ------------------------------------------------------------- the rest


def test_train_cli_trains_over_an_int8_table(fix, tmp_path):
    """engine.device_features with features_dtype=int8: the train step
    gathers and dequantizes the rows (gather_rows_dequant's plain version on
    the CPU); the run trains, validates and checkpoints."""
    logs = str(tmp_path / "int8")
    assert port_cli.main(_argv(fix, logs, "--epochs", "1", opts=[
        "engine.device_features=true", "engine.features_dtype=int8"])) == 0
    rec = _records(logs, "train")[0]
    assert np.isfinite(rec["loss"]) and _info(logs)["latest"] == 0


def test_nan_check_raises_on_a_non_finite_loss(fix, tmp_path):
    """engine.nan_check stops the step before the update, naming the loss."""
    logs = str(tmp_path / "nan")
    init = os.path.join(tmp_path, "nan.npz")
    opt = load_options(PATH_OPT, [f"vqa.dir={fix}/vqa2", f"coco.dir={fix}/coco"] + TINY)
    ds = port_factory.factory("val", opt)
    from vqa_tpu_torch.models.factory import factory as model_factory
    from vqa_tpu_torch.weights import export_params, init_params

    model = model_factory(dataclasses.asdict(opt.model), ds.num_words, ds.num_answers,
                          dim_v=ds.feature_shape[-1])
    init_params(model, 0)
    flat = export_params(model)
    flat[next(k for k in flat if k.endswith("logits/bias") and "glimpse" not in k)][:] = np.nan
    np.savez(init, **flat)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        port_cli.main(_argv(fix, logs, "--epochs", "1", opts=[
            "engine.nan_check=true", f"model.pretrained_params={init}"]))
