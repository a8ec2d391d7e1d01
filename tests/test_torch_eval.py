"""The port's eval loop and eval CLI against the JAX package's, on a fixture.

A tiny MutanAtt's flax params (non-zero biases) are saved with
save_tree_npz. The port's validate()/test() over its loader, with the eval
step on the CPU in float32, must give vqa_tpu.engine.engine's results rows
and metrics (n, n_labeled, acc1, acc5 and their _labeled variants) over the
float32 table gathered on the host, the bf16 table and the int8 table
gathered in the step; ``python -m vqa_tpu_torch.cli.train -e --platform cpu``
must write what ``vqa_tpu.cli.train -e --platform cpu`` writes, with the
same ``--opt model.pretrained_params``.

Results are compared as rows keyed by question_id (the loader sorts by
length, so the order is the loader's). The answers must be equal, except
where the two best logits of the row lie within 1e-6 of each other: there
torch.argmax and jnp.argmax (and torch.topk and lax.top_k) may break the tie
differently, and float32 sums taken in another order may swap them.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vqa_tpu_torch.cli import train as port_cli
from vqa_tpu_torch.config import load_options
from vqa_tpu_torch.datasets import factory as port_factory
from vqa_tpu_torch.datasets.pipeline import BatchIterator
from vqa_tpu_torch.engine import engine as port_engine
from vqa_tpu_torch.engine.logger import Experiment
from vqa_tpu_torch.engine.steps import make_eval_step, quantize_features
from vqa_tpu_torch.models.factory import factory as model_factory
from vqa_tpu_torch.weights import load_params, pretrained_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH_OPT = os.path.join(REPO, "options", "vqa2", "mutan_att.yaml")
TINY = ["vqa.nans=12", "optim.eval_batch_size=16",
        "model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=16",
        "model.attention.dim_hv=8", "model.attention.dim_hq=8", "model.attention.dim_mm=8",
        "model.attention.R=2", "model.fusion.dim_hv=8", "model.fusion.dim_hq=8",
        "model.fusion.dim_mm=8", "model.fusion.R=2"]
BUCKETS = (7, 13, 26)
TIE = 1e-6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A fixture with 44 val and testdev questions (not a multiple of the
    eval batch, 16), prepared by the JAX factory, and a tiny MutanAtt's
    params as a '/'-keyed npz."""
    import jax
    import jax.numpy as jnp

    from vqa_tpu.config import load_options as jax_load_options
    from vqa_tpu.datasets import factory as jax_factory
    from vqa_tpu.importers import save_tree_npz
    from vqa_tpu.models import factory as jax_model_factory
    from vqa_tpu_torch.datasets.fixtures import generate

    d = str(tmp_path_factory.mktemp("torch_eval"))
    generate(d, n_images=8, n_questions=44, seed=4)
    overrides = [f"vqa.dir={d}/vqa2", f"coco.dir={d}/coco"] + TINY
    jax_opt = jax_load_options(PATH_OPT, overrides)
    val_set = jax_factory("val", jax_opt)
    model = jax_model_factory(jax_opt.model, val_set.num_words, val_set.num_answers)
    params = model.init(jax.random.key(3), jnp.zeros((2,) + val_set.feature_shape),
                        jnp.zeros((2, jax_opt.vqa.maxlength), jnp.int32),
                        jnp.ones((2,), jnp.int32))["params"]
    leaves, tree = jax.tree.flatten(params)  # non-zero biases throughout
    params = jax.tree.unflatten(tree, [p + 0.02 * (i % 5) for i, p in enumerate(leaves)])
    npz = os.path.join(d, "params.npz")
    save_tree_npz(npz, params)
    return {"dir": d, "overrides": overrides, "npz": npz, "jax_opt": jax_opt,
            "jax_model": model, "jax_params": params}


def _port_model(run, opt):
    ds = port_factory.factory("val", opt)
    model = model_factory(dataclasses.asdict(opt.model), ds.num_words, ds.num_answers,
                          dim_v=ds.feature_shape[-1])
    with np.load(run["npz"]) as flat:
        load_params(model, flat)
    return model.eval()


def _tables(table, kind):
    """(port features, JAX features) for a table kind, float32 compute."""
    import jax.numpy as jnp

    if kind == "bfloat16":
        return torch.from_numpy(table).to(torch.bfloat16), jnp.asarray(table, jnp.bfloat16)
    values, scales = quantize_features(table)
    return ((torch.from_numpy(values), torch.from_numpy(scales)),
            (jnp.asarray(values), jnp.asarray(scales)))


def _visual_of(dataset, rows, kind, features):
    """The visual rows the step saw for dataset rows ``rows``."""
    index = dataset.image_index[rows]
    if kind == "float32":
        return torch.from_numpy(dataset.features.get(index))
    if kind == "bfloat16":
        return features[index.astype(np.int64)].float()
    values, scales = features
    index = index.astype(np.int64)
    return values[index].float() * scales[index]


def _assert_same_answers(got_rows, want_rows, dataset, model, aid_to_ans, visual_of):
    got = {r["question_id"]: r["answer"] for r in got_rows}
    want = {r["question_id"]: r["answer"] for r in want_rows}
    assert len(got) == len(got_rows) == len(want_rows) == len(want) == len(dataset)
    assert set(got) == set(want) == set(dataset.split.question_ids.tolist())
    differ = [q for q in want if got[q] != want[q]]
    if differ:  # allowed only at a tie of the two best logits (module docstring)
        rows = np.flatnonzero(np.isin(dataset.split.question_ids, differ))
        with torch.inference_mode():
            logits = model(visual_of(rows), torch.from_numpy(dataset.split.questions[rows]))
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        assert bool(((top2[:, 0] - top2[:, 1]) <= TIE).all()), differ
    assert set(got.values()) <= set(aid_to_ans)


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if "event" not in line]
    assert len(recs) == 1
    rec = recs[0]
    assert rec["eval_time"] > 0 and rec["qa_per_sec"] > 0
    return {k: v for k, v in rec.items() if k not in ("ts", "eval_time", "qa_per_sec")}


def _metrics_all(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if "event" not in line]


def _results(run_dir, split, epoch=0):
    path = os.path.join(run_dir, "results", f"vqa_OpenEnded_{split}_epoch{epoch}_results.json")
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("split,kind", [("val", "float32"), ("val", "bfloat16"),
                                        ("val", "int8"), ("testdev", "int8")])
def test_eval_loop_matches_jax(run, tmp_path, split, kind):
    """validate() (val, labeled) or test() (testdev, no labels) over the
    length-sorted, bucketed, padded loader: the float32 table's rows
    gathered on the host, or the bf16 / int8 table gathered in the step."""
    import optax

    from vqa_tpu.datasets import factory as jax_factory
    from vqa_tpu.datasets.pipeline import BatchIterator as JaxBatchIterator
    from vqa_tpu.engine import engine as jax_engine
    from vqa_tpu.engine.logger import Experiment as JaxExperiment
    from vqa_tpu.engine.steps import create_state, make_eval_step as jax_make_eval_step

    opt = load_options(PATH_OPT, run["overrides"])
    mode = "gather" if kind == "float32" else "index"
    port_ds = port_factory.factory(split, opt, visual_mode=mode)
    jax_ds = jax_factory(split, run["jax_opt"], visual_mode=mode)
    port_features, jax_features = (None, None) if kind == "float32" else \
        _tables(port_ds.features.as_array(), kind)
    loader_kwargs = dict(shuffle=False, pad_last=True, sort_by_length=True,
                         length_buckets=BUCKETS)
    port_loader = BatchIterator(port_ds, 16, transform=port_engine.make_device_transform("cpu"),
                                **loader_kwargs)
    jax_loader = JaxBatchIterator(jax_ds, 16, transform=jax_engine.make_device_transform(),
                                  **loader_kwargs)
    assert port_loader.steps_per_epoch() == 3  # 44 questions, the last batch padded
    model = _port_model(run, opt)
    state = create_state(run["jax_model"], run["jax_params"], optax.sgd(0.1))
    port_exp, jax_exp = Experiment(str(tmp_path / "port")), JaxExperiment(str(tmp_path / "jax"))
    aid_to_ans = port_ds.vocabs.aid_to_ans
    assert aid_to_ans == jax_ds.vocabs.aid_to_ans
    port_fn, jax_fn = ((port_engine.validate, jax_engine.validate) if split == "val"
                       else (port_engine.test, jax_engine.test))
    got = port_fn(port_loader, model, make_eval_step(), aid_to_ans, port_exp, 0, split=split,
                  features=port_features)
    want = jax_fn(jax_loader, state, jax_make_eval_step(), aid_to_ans, jax_exp, 0, split=split,
                  features=jax_features)
    port_exp.close()
    jax_exp.close()
    if split == "val":
        assert got[0] == want[0]  # acc1
        got, want = got[1], want[1]
    _assert_same_answers(got, want, port_ds, model, aid_to_ans,
                         lambda rows: _visual_of(port_ds, rows, kind, port_features))
    assert _results(str(tmp_path / "port"), split) == got
    got_m, want_m = _metrics(str(tmp_path / "port")), _metrics(str(tmp_path / "jax"))
    assert got_m == want_m
    assert got_m["n"] == len(port_ds)
    if split == "val":
        assert 0 < got_m["n_labeled"] < got_m["n"]  # nans=12 leaves OOV consensus rows
    else:
        assert set(got_m) == {"epoch", "split", "n"}


def test_device_transform_keeps_host_keys_on_the_host():
    batch = {"question": np.ones((4, 7), np.int32), "length": np.full(4, 7, np.int32),
             "answer": np.arange(4, dtype=np.int32), "valid": np.array([1, 1, 1, 0], bool),
             "visual": np.ones((4, 2, 3), np.float32), "image_index": np.arange(4, dtype=np.int32),
             "question_id": np.arange(10, 14)}
    out = port_engine.make_device_transform("cpu", torch.bfloat16)(batch)
    assert set(out) == set(batch) | {"valid_host"}
    for key in port_engine.DEVICE_KEYS:
        assert isinstance(out[key], torch.Tensor)
    assert out["visual"].dtype == torch.bfloat16 and out["question"].dtype == torch.int32
    for key in ("image_index", "question_id", "valid_host"):
        assert isinstance(out[key], np.ndarray), key
    np.testing.assert_array_equal(out["valid_host"], batch["valid"])


def _argv(run, logs, *extra):
    opts = run["overrides"] + [f"model.pretrained_params={run['npz']}"] + list(extra)
    return ["--path_opt", PATH_OPT, "-e", "--platform", "cpu", "--dir_logs", logs] + \
        [a for o in opts for a in ("--opt", o)]


@pytest.mark.parametrize("split,extra", [
    ("val", ("engine.device_features=true", "engine.features_dtype=bfloat16")),
    ("testdev", ()),
])
def test_eval_cli_writes_what_the_jax_cli_writes(run, tmp_path, split, extra):
    from vqa_tpu.cli.train import main as jax_main

    port_logs, jax_logs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_cli.main(_argv(run, port_logs, *extra) + ["--split", split]) == 0
    assert jax_main(_argv(run, jax_logs, *extra) + ["--split", split]) == 0
    got_m, want_m = _metrics(port_logs), _metrics(jax_logs)
    assert got_m == want_m
    opt = load_options(PATH_OPT, run["overrides"])
    ds = port_factory.factory(split, opt)
    _assert_same_answers(_results(port_logs, split), _results(jax_logs, split), ds,
                         _port_model(run, opt), ds.vocabs.aid_to_ans,
                         lambda rows: torch.from_numpy(ds.features.get(ds.image_index[rows]))
                         .to(torch.bfloat16 if extra else torch.float32))
    assert os.path.exists(os.path.join(port_logs, "options.yaml"))


@pytest.mark.parametrize("argv,error,match", [
    (["--opt", "engine.model_parallel=2"], ValueError, "not divisible by model_parallel=2"),
])
def test_eval_cli_refuses_what_is_not_ported(tmp_path, argv, error, match):
    """Each refusal raises before any file is written. Every ROADMAP item of
    the CLI is ported; what is left is a mesh the world cannot lay out: one
    process with ``engine.model_parallel=2``, as the JAX CLI's ``make_mesh``
    refuses it."""
    logs = str(tmp_path / "logs")
    args = ["--path_opt", PATH_OPT, "-e", "--platform", "cpu", "--dir_logs", logs,
            "--opt", "model.pretrained_params=params.npz"] + argv
    with pytest.raises(error, match=match):
        port_cli.main(args)
    assert not os.path.exists(logs)


@pytest.mark.parametrize("case", ["distributed", "features_sharded"])
def test_eval_cli_runs_distributed_and_sharded(run, tmp_path, case):
    """What the CLI refused until item 12 was ported now runs: -e as a world
    of one over gloo (the eval loop's slice and gather over one rank), and
    over a row-sharded table (one process: the shard is the whole table).
    Both write the metrics and results of the plain run."""
    extra = (["--distributed", "--coordinator_address", f"file://{tmp_path}/store",
              "--num_processes", "1", "--process_id", "0"] if case == "distributed"
             else ["--opt", "engine.device_features=true", "--opt",
                   "engine.features_sharded=true"])
    plain, logs = str(tmp_path / "plain"), str(tmp_path / "logs")
    assert port_cli.main(_argv(run, plain)) == 0
    assert port_cli.main(_argv(run, logs) + extra) == 0
    assert _metrics(logs) == _metrics(plain)
    assert _results(logs, "val") == _results(plain, "val")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cli_profile_dir_writes_a_trace(run, tmp_path, train):
    """--profile_dir traces the run with torch.profiler (host activity on
    the CPU), -e runs too: one Chrome trace in TensorBoard's torch-profiler
    layout lands in the directory, holding the model's ops, and the run's
    results are written as without it."""
    logs, trace = str(tmp_path / "logs"), str(tmp_path / "trace")
    argv = (_train_argv(run, logs) if train else _argv(run, logs)) + ["--profile_dir", trace]
    assert port_cli.main(argv) == 0
    files = os.listdir(trace)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json"), files
    with open(os.path.join(trace, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"aten::mm", "aten::tanh"} & names, sorted(n for n in names if n)[:20]
    assert any("Backward" in n for n in names if n) == train
    assert os.path.exists(os.path.join(logs, "results", "vqa_OpenEnded_val_epoch0_results.json"))


def _eval_rows(run, model, opt):
    """The val results rows and acc1 of the eval loop over ``model``."""
    ds = port_factory.factory("val", opt)
    loader = BatchIterator(ds, 16, shuffle=False, pad_last=True, sort_by_length=True,
                           length_buckets=BUCKETS,
                           transform=port_engine.make_device_transform("cpu"))
    acc1, rows = port_engine.validate(loader, model, make_eval_step(), ds.vocabs.aid_to_ans,
                                      None, 0)
    return acc1, {r["question_id"]: r["answer"] for r in rows}


def _train_argv(run, logs, *extra):
    """The train CLI (no -e) for one epoch at batch 8 from the run's npz."""
    argv = _argv(run, logs, *extra)
    argv.remove("-e")
    return argv + ["--epochs", "1", "--batch_size", "8"]


def test_train_cli_without_e_trains_and_checkpoints(run, tmp_path):
    """Without -e the CLI trains from model.pretrained_params (grafted over
    the init), validates and saves epoch 0 under ckpt/: float32 params in
    the npz's flax names, adam's moments and the step count."""
    logs = str(tmp_path / "train")
    assert port_cli.main(_train_argv(run, logs)) == 0
    with open(os.path.join(logs, "ckpt", "info.json")) as f:
        info = json.load(f)
    assert (info["latest"], info["best"], info["epochs"]) == (0, 0, [0])
    ckpt = os.path.join(logs, "ckpt", "epoch_0000")
    with np.load(run["npz"]) as want, np.load(os.path.join(ckpt, "params.npz")) as got:
        assert sorted(got.files) == sorted(want.files)
        assert all(got[k].dtype == np.float32 and got[k].shape == want[k].shape
                   for k in want.files)
        assert any(not np.array_equal(got[k], want[k]) for k in want.files)
    with np.load(os.path.join(ckpt, "opt_state.npz")) as opt_state:
        assert {"0/count", "1/count"} <= set(opt_state.files)
        assert any(k.startswith("0/mu/encoder/") for k in opt_state.files)
    with open(os.path.join(ckpt, "state.json")) as f:
        steps = json.load(f)["step"]
    ds = port_factory.factory("train", load_options(PATH_OPT, run["overrides"]))
    assert steps == len(ds) // 8 > 0


def test_eval_cli_resume_best_evaluates_the_checkpoint(run, tmp_path):
    """-e --resume best reads the port's checkpoint: its acc1 is the one the
    training run logged for that epoch, its answers are the eval step's on
    the restored weights, and Predictor.from_run(resume="best") answers as
    the eval step does."""
    from vqa_tpu_torch.datasets.interim import RAW_FILES
    from vqa_tpu_torch.predictor import Predictor

    logs = str(tmp_path / "run")
    assert port_cli.main(_train_argv(run, logs)) == 0
    trained = [r for r in _metrics_all(logs) if r.get("split") == "val"]
    assert port_cli.main(["--path_opt", PATH_OPT, "-e", "--platform", "cpu", "--dir_logs", logs,
                          "--resume", "best"] +
                         [a for o in run["overrides"] for a in ("--opt", o)]) == 0
    evaluated = [r for r in _metrics_all(logs) if r.get("split") == "val"][-1]
    assert evaluated["epoch"] == 1  # the JAX CLI's label: the epoch after the restored one
    assert evaluated["acc1"] == trained[0]["acc1"]

    opt = load_options(PATH_OPT, run["overrides"])
    ds = port_factory.factory("val", opt)
    model = model_factory(dataclasses.asdict(opt.model), ds.num_words, ds.num_answers,
                          dim_v=ds.feature_shape[-1])
    with np.load(os.path.join(logs, "ckpt", "epoch_0000", "params.npz")) as flat:
        load_params(model, flat)
    acc1, want = _eval_rows(run, model.eval(), opt)
    assert acc1 == evaluated["acc1"]
    assert {r["question_id"]: r["answer"] for r in _results(logs, "val", epoch=1)} == want

    predictor = Predictor.from_run(logs, resume="best", device="cpu")
    with open(os.path.join(run["dir"], "vqa2", "raw", RAW_FILES["val"][0])) as f:
        text = {q["question_id"]: q["question"] for q in json.load(f)["questions"]}
    qids = ds.split.question_ids.tolist()
    answers = predictor.answer_batch([text[q] for q in qids],
                                     [str(n) for n in ds.split.image_names], topk=1)
    assert {q: a[0][0] for q, a in zip(qids, answers)} == want


def test_eval_cli_without_weights_evaluates_the_init(run, tmp_path):
    """-e with neither --resume nor an npz evaluates the init
    (weights.init_params seeded by engine.seed), as the JAX CLI does."""
    from vqa_tpu_torch.weights import init_params

    logs = str(tmp_path / "init")
    assert port_cli.main(["--path_opt", PATH_OPT, "-e", "--platform", "cpu", "--dir_logs", logs] +
                         [a for o in run["overrides"] for a in ("--opt", o)]) == 0
    opt = load_options(PATH_OPT, run["overrides"])
    ds = port_factory.factory("val", opt)
    model = model_factory(dataclasses.asdict(opt.model), ds.num_words, ds.num_answers,
                          dim_v=ds.feature_shape[-1])
    init_params(model, opt.engine.seed)
    acc1, want = _eval_rows(run, model.eval(), opt)
    assert {r["question_id"]: r["answer"] for r in _results(logs, "val")} == want
    assert _metrics(logs)["acc1"] == acc1


def test_eval_cli_without_a_card_fails_and_names_it(tmp_path):
    """No --platform cpu and no card: the CLI exits non-zero and says why;
    there is no fallback to the host."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "vqa_tpu_torch.cli.train", "--path_opt", PATH_OPT, "-e",
         "--dir_logs", str(tmp_path / "logs"), "--opt", "model.pretrained_params=params.npz"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr and "--platform cpu" in proc.stderr
    with pytest.raises(ValueError, match="--platform 'tpu'"):
        port_cli._device("tpu")


def test_pretrained_grafts_compose_as_the_jax_cli(run, tmp_path):
    """seq2vec.pretrained_emb and pretrained_encoder graft under
    model.pretrained_params in the JAX CLI's order: split three ways, the
    npz gives the same weights; a leaf none of them holds is refused (the
    port has no init to fill it)."""
    with np.load(run["npz"]) as npz:
        full = {k: npz[k] for k in npz.files}
    emb = {"embedding": full["encoder/embed/embedding"] + 1.0}  # overwritten by the params
    enc = {k[len("encoder/"):]: v for k, v in full.items() if k.startswith("encoder/")}
    rest = {k: v for k, v in full.items() if not k.startswith("encoder/")}
    paths = {}
    for name, arrays in (("emb", emb), ("enc", enc), ("rest", rest)):
        paths[name] = str(tmp_path / f"{name}.npz")
        np.savez(paths[name], **arrays)
    opt = load_options(PATH_OPT, run["overrides"] + [
        f"model.seq2vec.pretrained_emb={paths['emb']}",
        f"model.seq2vec.pretrained_encoder={paths['enc']}",
        f"model.pretrained_params={paths['rest']}"])
    grafted = pretrained_params(opt.model)
    assert sorted(grafted) == sorted(full)
    for key, value in full.items():
        np.testing.assert_array_equal(grafted[key], value, err_msg=key)
    partial = load_options(PATH_OPT, run["overrides"] + [f"model.pretrained_params={paths['rest']}"])
    ds = port_factory.factory("val", partial)
    model = model_factory(dataclasses.asdict(partial.model), ds.num_words, ds.num_answers)
    with pytest.raises(KeyError, match="missing"):
        load_params(model, pretrained_params(partial.model))


def test_from_run_serves_a_run_whose_encoder_comes_from_the_grafts(run, tmp_path):
    """A run whose params npz leaves the encoder to
    seq2vec.pretrained_encoder: the eval CLI evaluates it, and
    Predictor.from_run on the run dir (its options.yaml, the grafts in it)
    answers every val question as the CLI's results json does."""
    from vqa_tpu_torch.datasets.interim import RAW_FILES
    from vqa_tpu_torch.predictor import Predictor

    with np.load(run["npz"]) as npz:
        full = {k: npz[k] for k in npz.files}
    paths = {"enc": str(tmp_path / "enc.npz"), "rest": str(tmp_path / "rest.npz")}
    np.savez(paths["enc"], **{k[len("encoder/"):]: v for k, v in full.items()
                              if k.startswith("encoder/")})
    np.savez(paths["rest"], **{k: v for k, v in full.items() if not k.startswith("encoder/")})
    logs = str(tmp_path / "logs")
    opts = run["overrides"] + [f"model.seq2vec.pretrained_encoder={paths['enc']}",
                               f"model.pretrained_params={paths['rest']}"]
    argv = ["--path_opt", PATH_OPT, "-e", "--platform", "cpu", "--dir_logs", logs]
    assert port_cli.main(argv + [a for o in opts for a in ("--opt", o)]) == 0
    want = {r["question_id"]: r["answer"] for r in _results(logs, "val")}

    predictor = Predictor.from_run(logs, device="cpu")
    split = port_factory.factory("val", load_options(PATH_OPT, opts)).split
    with open(os.path.join(run["dir"], "vqa2", "raw", RAW_FILES["val"][0])) as f:
        text = {q["question_id"]: q["question"] for q in json.load(f)["questions"]}
    qids = split.question_ids.tolist()
    answers = predictor.answer_batch([text[q] for q in qids],
                                     [str(n) for n in split.image_names], topk=1)
    assert {q: a[0][0] for q, a in zip(qids, answers)} == want


NOATT_PATH_OPT = os.path.join(REPO, "options", "vqa2", "mutan_noatt.yaml")
NOATT_TINY = ["vqa.nans=12", "optim.eval_batch_size=16",
              "model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=16",
              "model.fusion.dim_hv=8", "model.fusion.dim_hq=8", "model.fusion.dim_mm=8",
              "model.fusion.R=2"]


@pytest.fixture(scope="module")
def noatt_run(run):
    """The same fixture read as mutan_noatt.yaml reads it (coco.mode:
    noatt, the pooled table [N, 2048]), and a tiny MutanNoAtt's params."""
    import jax
    import jax.numpy as jnp

    from vqa_tpu.config import load_options as jax_load_options
    from vqa_tpu.datasets import factory as jax_factory
    from vqa_tpu.importers import save_tree_npz
    from vqa_tpu.models import factory as jax_model_factory

    d = run["dir"]
    overrides = [f"vqa.dir={d}/vqa2", f"coco.dir={d}/coco"] + NOATT_TINY
    jax_opt = jax_load_options(NOATT_PATH_OPT, overrides)
    val_set = jax_factory("val", jax_opt)
    assert jax_opt.coco.mode == "noatt" and len(val_set.feature_shape) == 1
    model = jax_model_factory(jax_opt.model, val_set.num_words, val_set.num_answers)
    params = model.init(jax.random.key(5), jnp.zeros((2,) + val_set.feature_shape),
                        jnp.zeros((2, jax_opt.vqa.maxlength), jnp.int32),
                        jnp.ones((2,), jnp.int32))["params"]
    leaves, tree = jax.tree.flatten(params)  # non-zero biases throughout
    params = jax.tree.unflatten(tree, [p + 0.02 * (i % 5) for i, p in enumerate(leaves)])
    npz = os.path.join(d, "noatt_params.npz")
    save_tree_npz(npz, params)
    return {"dir": d, "overrides": overrides, "npz": npz}


@pytest.mark.parametrize("extra", [
    (),
    ("engine.device_features=true", "engine.features_dtype=bfloat16"),
    ("engine.device_features=true", "engine.features_dtype=int8"),
])
def test_noatt_eval_cli_writes_what_the_jax_cli_writes(noatt_run, tmp_path, extra):
    """mutan_noatt.yaml over the fixture's pooled table: its float32 rows
    gathered on the host, or the table on the device in bf16 or int8 (2-D
    rows, one scale a row) gathered in the step."""
    from vqa_tpu.cli.train import main as jax_main

    port_logs, jax_logs = str(tmp_path / "port"), str(tmp_path / "jax")
    opts = noatt_run["overrides"] + [f"model.pretrained_params={noatt_run['npz']}"] + list(extra)
    argv = ["--path_opt", NOATT_PATH_OPT, "-e", "--platform", "cpu"] + \
        [a for o in opts for a in ("--opt", o)]
    assert port_cli.main(argv + ["--dir_logs", port_logs]) == 0
    assert jax_main(argv + ["--dir_logs", jax_logs]) == 0
    assert _metrics(port_logs) == _metrics(jax_logs)
    opt = load_options(NOATT_PATH_OPT, noatt_run["overrides"])
    ds = port_factory.factory("val", opt)
    assert ds.feature_shape == (ds.features.as_array().shape[-1],)
    model = model_factory(dataclasses.asdict(opt.model), ds.num_words, ds.num_answers,
                          dim_v=ds.feature_shape[-1])
    with np.load(noatt_run["npz"]) as flat:
        load_params(model, flat)
    kind = extra[-1].split("=")[1] if extra else "float32"
    features = None if kind == "float32" else _tables(ds.features.as_array(), kind)[0]
    _assert_same_answers(_results(port_logs, "val"), _results(jax_logs, "val"), ds, model.eval(),
                         ds.vocabs.aid_to_ans, lambda rows: _visual_of(ds, rows, kind, features))
