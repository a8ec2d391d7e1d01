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
from vqa_tpu_torch.weights import load_params

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
    from vqa_tpu.datasets.fixtures import generate
    from vqa_tpu.importers import save_tree_npz
    from vqa_tpu.models import factory as jax_model_factory

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
    (["--no-e"], NotImplementedError, "queue 1, item 5"),
    (["--resume", "best"], NotImplementedError, "queue 1, item 13"),
    (["--no-params"], ValueError, "queue 1, item 13"),
    (["--distributed"], NotImplementedError, "queue 1, item 12"),
    (["--opt", "engine.model_parallel=2"], NotImplementedError, "queue 1, item 12"),
    (["--opt", "engine.features_sharded=true"], NotImplementedError, "queue 1, item 12"),
    (["--profile_dir", "trace"], NotImplementedError, "profile_eval"),
])
def test_eval_cli_refuses_what_is_not_ported(tmp_path, argv, error, match):
    """Each refusal raises before any file is written and names the ROADMAP
    item that ports it (or the port's own profiler)."""
    logs = str(tmp_path / "logs")
    args = ["--path_opt", PATH_OPT, "-e", "--platform", "cpu", "--dir_logs", logs,
            "--opt", "model.pretrained_params=params.npz"]
    if argv == ["--no-e"]:
        args.remove("-e")
    elif argv == ["--no-params"]:
        args = args[:-2]
    else:
        args += argv
    with pytest.raises(error, match=match):
        port_cli.main(args)
    assert not os.path.exists(logs)


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
    grafted = port_cli._pretrained(opt)
    assert sorted(grafted) == sorted(full)
    for key, value in full.items():
        np.testing.assert_array_equal(grafted[key], value, err_msg=key)
    partial = load_options(PATH_OPT, run["overrides"] + [f"model.pretrained_params={paths['rest']}"])
    ds = port_factory.factory("val", partial)
    model = model_factory(dataclasses.asdict(partial.model), ds.num_words, ds.num_answers)
    with pytest.raises(KeyError, match="missing"):
        load_params(model, port_cli._pretrained(partial))
