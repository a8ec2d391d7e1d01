"""The port's export (vqa_tpu_torch/export.py, cli/export.py, serve
--exported) against the JAX package's (vqa_tpu/export.py), on fixture runs.

The cases of tests/test_export.py, on the port: a tiny MutanAtt's flax
params (non-zero biases) reach the port through an npz, written into a run
dir's checkpoint (so the export CLI takes its default --resume best) or
exported straight from the npz (--params_npz). The frozen program must
reproduce the live Predictor, load without model code, pad and chunk
requests to the frozen batch, slot into the HTTP service, and keep the
model's forward kernels as the registered ops ``vqa_tpu_torch::*``. Held
against the JAX package on the same float32 params and inputs: the exported
logits of MutanAtt, MFBCoAtt, CoR and MutanNoAtt within 1e-4 of the JAX
exported program's, and ``quantize_int8`` bit for bit. The programs are
traced and run on the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.config import load_options
from vqa_tpu.datasets import factory as dataset_factory
from vqa_tpu.datasets.fixtures import generate
from vqa_tpu.export import load_export as jax_load_export
from vqa_tpu.export import quantize_int8 as jax_quantize_int8
from vqa_tpu.export import save_export as jax_save_export
from vqa_tpu.importers import save_tree_npz
from vqa_tpu.models import factory as jax_factory
from vqa_tpu.predictor import Predictor as JaxPredictor
from vqa_tpu_torch.cli import serve as port_serve
from vqa_tpu_torch.cli.export import main as export_main
from vqa_tpu_torch.cli.serve import AnswerService, DynamicBatcher
from vqa_tpu_torch.export import (_forward_at, dequantize_int8, load_export, model_params,
                                  quantize_int8, save_export)
from vqa_tpu_torch.predictor import Predictor

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
TOL = 1e-5      # the program against the live model: the same ops in float32
JAX_TOL = 1e-4  # the port's program against the JAX program, float32 on both sides
TINY = {
    "mutan_att": ["model.seq2vec.emb_size=12", "model.seq2vec.hidden_size=16",
                  "model.attention.dim_hv=8", "model.attention.dim_hq=8",
                  "model.attention.dim_mm=12", "model.attention.R=2",
                  "model.fusion.dim_hv=8", "model.fusion.dim_hq=8",
                  "model.fusion.dim_mm=12", "model.fusion.R=2"],
    "mfb_coatt": ["model.seq2vec.emb_size=12", "model.seq2vec.hidden_size=16",
                  "model.fusion.dim_mm=16", "model.fusion.pool_factor=2"],
    "cor": ["model.seq2vec.emb_size=12", "model.seq2vec.hidden_size=16",
            "model.fusion.dim_h=16"],
    "mutan_noatt": ["model.seq2vec.emb_size=12", "model.seq2vec.hidden_size=16",
                    "model.fusion.dim_hv=8", "model.fusion.dim_hq=8",
                    "model.fusion.dim_mm=12", "model.fusion.R=2"],
}
OPS = {  # the registered ops each arch's program calls, in graph order
    "mutan_att": ["lstm_seq", "glimpse_head"],
    "mfb_coatt": ["lstm_seq", "glimpse_attend", "mfb_pool", "glimpse_head", "mfb_pool"],
    "cor": ["lstm_seq"] + ["relation_attend"] * 3,
    "mutan_noatt": ["lstm_seq"],
}
QUESTIONS = ["what color is the object", "is there a person", "how many items are shown",
             "what is on the table"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torchexport"))
    generate(d, n_images=10, n_questions=48, seed=11)
    return d


def _setup(data_dir, name, checkpoint=False):
    """A flax init of the arch (non-zero biases) saved as an npz, and a port
    run dir holding the options (and, with ``checkpoint``, the npz's weights
    as its best checkpoint, epoch 0)."""
    from vqa_tpu_torch.config import dump_options, load_options as port_load_options
    from vqa_tpu_torch.engine import optim
    from vqa_tpu_torch.engine.checkpoint import CheckpointManager
    from vqa_tpu_torch.engine.steps import create_state
    from vqa_tpu_torch.models.factory import factory as port_model_factory
    from vqa_tpu_torch.weights import load_params

    path_opt = os.path.join(REPO, f"options/vqa2/{name}.yaml")
    overrides = [f"vqa.dir={data_dir}/vqa2", f"coco.dir={data_dir}/coco",
                 "vqa.nans=20"] + TINY[name]
    opt = load_options(path_opt, overrides)
    val_set = dataset_factory("val", opt)
    model = jax_factory(opt.model, val_set.num_words, val_set.num_answers)
    params = model.init(
        jax.random.key(7), jnp.zeros((2,) + val_set.feature_shape),
        jnp.zeros((2, opt.vqa.maxlength), jnp.int32), jnp.ones((2,), jnp.int32),
    )["params"]
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [p + 0.02 * (i % 5) for i, p in enumerate(leaves)])
    npz = os.path.join(data_dir, f"{name}_params.npz")
    save_tree_npz(npz, params)
    run_dir = os.path.join(data_dir, f"run_{name}")
    port_opt = port_load_options(path_opt, overrides)
    dump_options(port_opt, run_dir)
    if checkpoint:
        trainable = port_model_factory(dataclasses.asdict(port_opt.model), val_set.num_words,
                                       val_set.num_answers, dim_v=val_set.feature_shape[-1],
                                       train=True)
        with np.load(npz) as flat:
            load_params(trainable, flat)
        CheckpointManager(os.path.join(run_dir, "ckpt")).save(
            create_state(trainable, optim.factory(port_opt.optim)), 0, 0.5)
    return dict(path_opt=path_opt, overrides=overrides, npz=npz, run_dir=run_dir)


@pytest.fixture(scope="module")
def exported_run(data_dir):
    """MutanAtt: the run's checkpoint exported by the CLI (--resume best,
    batch 4, float32 weights on the CPU), and the live Predictor."""
    setup = _setup(data_dir, "mutan_att", checkpoint=True)
    out = os.path.join(data_dir, "exported")
    assert export_main(["--dir_logs", setup["run_dir"], "--out", out, "--batch", str(BATCH),
                        "--platform", "cpu"]) == 0
    predictor = Predictor.from_run(setup["run_dir"], resume="best", device="cpu")
    return setup, out, predictor


def _inputs(predictor, questions=QUESTIONS):
    names = [str(n) for n in predictor.dataset.split.image_names[:len(questions)]]
    q, lengths = predictor.encode_questions(questions)
    rows = predictor.dataset.index_of(names)
    return names, predictor.table[torch.as_tensor(rows)], q, lengths


def _live(predictor, visual, q, lengths, params=None):
    with torch.no_grad():
        if params is None:
            return predictor.model(visual, q, lengths).numpy()
        return _forward_at(predictor.model, params, visual, q, lengths).numpy()


def _export(setup, out, *flags):
    assert export_main(["--dir_logs", setup["run_dir"], "--out", out, "--batch", str(BATCH),
                        "--platform", "cpu", *flags]) == 0
    return load_export(out, device="cpu")


def _weight_bytes(export_dir):
    """The bytes of the weights inside program.pt2 (a zip archive): at these
    tiny widths the graph itself outweighs them, at full width they are
    nearly all of it."""
    import zipfile

    with zipfile.ZipFile(os.path.join(export_dir, "program.pt2")) as z:
        return sum(i.file_size for i in z.infolist() if "/data/weights/" in i.filename)


def _same(got, want, tol=TOL):
    assert [[a for a, _ in row] for row in got] == [[a for a, _ in row] for row in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w], atol=tol)


def test_meta_contents(exported_run):
    _, out, predictor = exported_run
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert meta["format"] == "vqa_tpu_torch.export/1"
    assert meta["batch"] == BATCH and meta["device"] == "cpu"
    assert meta["num_answers"] == predictor.dataset.num_answers
    assert meta["aid_to_ans"] == list(predictor.dataset.aid_to_ans)
    assert meta["word_to_wid"] == dict(predictor.dataset.word_to_wid)
    assert meta["feature_shape"] == [36, 2048] and meta["visual_dtype"] == "float32"
    assert meta["weights_dtype"] == "unchanged" and meta["params"] == "baked"
    assert meta["torch_version"] == torch.__version__
    assert meta["ops"] == [f"vqa_tpu_torch::{op}" for op in OPS["mutan_att"]]
    assert os.path.getsize(os.path.join(out, "program.pt2")) > 0
    assert not os.path.exists(os.path.join(out, "params.npz"))


def test_exported_logits_match_live_predictor(exported_run):
    _, out, predictor = exported_run
    ep = load_export(out, device="cpu")
    names, visual, q, lengths = _inputs(predictor)
    np.testing.assert_allclose(ep.logits(visual, q, lengths), _live(predictor, visual, q, lengths),
                               rtol=TOL, atol=TOL)
    # the Predictor-compatible surface agrees too (answers + probabilities)
    _same(ep.answer_batch(QUESTIONS, names, topk=3), predictor.answer_batch(QUESTIONS, names, 3))


def test_padding_and_chunking(exported_run):
    _, out, predictor = exported_run
    ep = load_export(out, device="cpu")
    names = predictor.dataset.split.image_names
    # n=3 pads to the frozen batch of 4; n=7 chunks into 4+3
    qs7 = [f"question number {i}" for i in range(7)]
    ims7 = [names[i % len(names)] for i in range(7)]
    whole = ep.answer_batch(qs7, ims7, topk=2)
    assert len(whole) == 7
    _same(whole, [ep.answer_batch([q], [im], topk=2)[0] for q, im in zip(qs7, ims7)])
    q, lengths = ep.encode_questions(qs7)
    with pytest.raises(ValueError, match="exported batch"):
        ep.logits(np.zeros((7, *ep.meta["feature_shape"]), np.float32), q, lengths)


def _serve(argv, monkeypatch):
    """The serve CLI's main in a thread, on port 0; returns (base url, the
    server, the thread)."""
    ready, box = threading.Event(), {}
    real = port_serve.build_server

    def build(service, host, port):
        box["server"] = server = real(service, host, port)
        box["service"] = service
        ready.set()
        return server

    monkeypatch.setattr(port_serve, "build_server", build)
    thread = threading.Thread(target=lambda: box.setdefault("rc", port_serve.main(argv)),
                              daemon=True)
    thread.start()
    assert ready.wait(120), "the serve CLI did not start its server"
    return f"http://127.0.0.1:{box['server'].server_address[1]}", box, thread


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("dynamic", [False, True])
def test_serve_exported_mode(exported_run, monkeypatch, dynamic):
    """``serve --exported``: the artifact's batch is the serving batch, and
    /answer and /batch answer as the live Predictor does."""
    _, out, predictor = exported_run
    argv = ["--exported", out, "--platform", "cpu", "--port", "0"]
    base, box, thread = _serve(argv + (["--dynamic_batching"] if dynamic else []), monkeypatch)
    try:
        service = box["service"]
        assert (service.service if dynamic else service).max_batch == BATCH
        image = str(predictor.dataset.split.image_names[0])
        got = _post(base + "/answer", {"question": "what is this", "image": image})
        _same([[tuple(a) for a in got["answers"]]],
              [predictor.answer("what is this", image, topk=5)])
        names = [str(n) for n in predictor.dataset.split.image_names[:3]]
        qs, ims = QUESTIONS + QUESTIONS[:2], [names[i % 3] for i in range(6)]
        got = _post(base + "/batch", {"questions": qs, "images": ims, "topk": 2})
        _same([[tuple(a) for a in row] for row in got["answers"]],
              predictor.answer_batch(qs, ims, topk=2))
    finally:
        box["server"].shutdown()
        thread.join(timeout=30)
    assert box["rc"] == 0


def test_bf16_weights_export(exported_run):
    """--weights_dtype bfloat16 halves the artifact's weights and stays
    close in logits (weights-only cast; inputs and outputs keep their dtypes)."""
    setup, out, predictor = exported_run
    out16 = os.path.join(os.path.dirname(out), "exported_bf16")
    ep16 = _export(setup, out16, "--weights_dtype", "bfloat16")
    assert ep16.meta["weights_dtype"] == "bfloat16"
    size32, size16 = _weight_bytes(out), _weight_bytes(out16)
    assert 0 < size16 < 0.75 * size32, (size16, size32)
    _, visual, q, lengths = _inputs(predictor, ["what is shown"] * BATCH)
    np.testing.assert_allclose(ep16.logits(visual, q, lengths),
                               load_export(out, device="cpu").logits(visual, q, lengths),
                               atol=0.05)


def test_external_params_export(exported_run):
    """--params external: a weight-free program and a sidecar npz reproduce
    the baked artifact exactly in float32, and through the bf16 round trip
    (npz stores float32); the npz is the JAX layout, which the port's
    ``serve --params`` reads."""
    setup, out, predictor = exported_run
    root = os.path.dirname(out)
    _, visual, q, lengths = _inputs(predictor, ["is it outdoors"] * BATCH)
    baked = load_export(out, device="cpu").logits(visual, q, lengths)
    out_ext = os.path.join(root, "exported_ext")
    ep = _export(setup, out_ext, "--params", "external")
    np.testing.assert_array_equal(ep.logits(visual, q, lengths), baked)
    with np.load(os.path.join(out_ext, "params.npz")) as flat:
        assert sorted(flat.files) == sorted(model_params(predictor.model))
        assert all(flat[k].dtype == np.float32 for k in flat.files)
    served = Predictor.from_run(setup["run_dir"], params=os.path.join(out_ext, "params.npz"),
                                device="cpu")
    _same(served.answer_batch(QUESTIONS, _inputs(predictor)[0]),
          predictor.answer_batch(QUESTIONS, _inputs(predictor)[0]), tol=0)

    ep16 = _export(setup, os.path.join(root, "exported_ext_bf16"), "--params", "external",
                   "--weights_dtype", "bfloat16")
    baked16 = os.path.join(root, "exported_bf16")
    if not os.path.exists(baked16):  # no ordering dependence on the bf16 test
        _export(setup, baked16, "--weights_dtype", "bfloat16")
    np.testing.assert_array_equal(ep16.logits(visual, q, lengths),
                                  load_export(baked16, device="cpu").logits(visual, q, lengths))
    # the external program itself carries no weights
    assert _weight_bytes(out_ext) < 0.5 * _weight_bytes(out)


def test_int8_weights_export(exported_run):
    """--weights_dtype int8: the artifact reproduces the live model run with
    eagerly dequantized weights (mechanics, no accuracy threshold), stays
    strongly correlated with the unquantized logits, and its weights take
    several times fewer bytes; external mode refuses it, at the CLI before any load and in
    the API."""
    setup, out, predictor = exported_run
    out8 = os.path.join(os.path.dirname(out), "exported_int8")
    ep8 = _export(setup, out8, "--weights_dtype", "int8")
    _, visual, q, lengths = _inputs(predictor, ["what animal is this"] * BATCH)
    got = ep8.logits(visual, q, lengths)
    deq = dequantize_int8(quantize_int8(model_params(predictor.model)))
    np.testing.assert_allclose(got, _live(predictor, visual, q, lengths, deq), rtol=TOL, atol=TOL)
    full = _live(predictor, visual, q, lengths)
    assert np.corrcoef(got.ravel(), full.ravel())[0, 1] > 0.99
    size32, size8 = _weight_bytes(out), _weight_bytes(out8)
    assert 0 < size8 < 0.4 * size32, (size8, size32)

    with pytest.raises(SystemExit):  # refused before any checkpoint load
        export_main(["--dir_logs", "no-such-run", "--out", out8 + "_x", "--weights_dtype",
                     "int8", "--params", "external"])
    with pytest.raises(ValueError, match="baked"):
        save_export(out8 + "_y", predictor, batch=BATCH, weights_dtype="int8",
                    params_mode="external")


def test_export_cli_flags_match_the_reference():
    """Every flag of the original's export CLI is the port's, with its
    default, type, action, choices and required; the port adds --params_npz
    (its npz source: --params picks baked or external, as in the
    original)."""
    import argparse

    from vqa_tpu.cli import export as jax_export_cli
    from vqa_tpu_torch.cli.export import build_argparser

    class Caught(Exception):
        pass

    def catch(self, *args, **kwargs):
        raise Caught(self)

    saved = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(Caught) as caught:
            jax_export_cli.main([])
    finally:
        argparse.ArgumentParser.parse_args = saved

    def flags(parser):
        return {a.option_strings[0]: a for a in parser._actions
                if a.option_strings and a.option_strings[0] != "-h"}

    want, got = flags(caught.value.args[0]), flags(build_argparser())
    assert set(got) - set(want) == {"--params_npz"} and not set(want) - set(got)
    for flag, action in want.items():
        mine = got[flag]
        assert (mine.default, mine.type, type(mine), mine.choices, mine.required) == \
            (action.default, action.type, type(action), action.choices, action.required), flag


@pytest.mark.parametrize("argv", [
    [],                                      # neither --dir_logs nor --exported
    ["--dir_logs", "x", "--exported", "y"],  # both
    ["--exported", "y", "--max_batch", "8"],
    ["--exported", "y", "--path_opt", "o.yaml"],
    ["--exported", "y", "--no_resume"],
    ["--exported", "y", "--resume", "latest"],
    ["--exported", "y", "--params", "p.npz"],
], ids=["neither", "both", "max_batch", "path_opt", "no_resume", "resume", "params"])
def test_serve_cli_arg_validation(argv, capsys):
    with pytest.raises(SystemExit):
        port_serve.main(argv)
    err = capsys.readouterr().err
    assert "exactly one of" in err or "cannot be used with --exported" in err


def test_dynamic_batcher_over_exported_predictor(exported_run):
    """The serving stack composes: DynamicBatcher(AnswerService(
    ExportedPredictor)), coalesced serving with no model code."""
    _, out, predictor = exported_run
    ep = load_export(out, device="cpu")
    dyn = DynamicBatcher(AnswerService(ep, max_batch=ep.batch), max_wait_ms=250)
    names = [str(n) for n in predictor.dataset.split.image_names[:4]]
    expected = predictor.answer_batch(["what is here"] * 4, names, topk=2)
    results = [None] * 4
    barrier = threading.Barrier(4)

    def hit(i):
        barrier.wait()
        results[i] = dyn.answer_batch(["what is here"], [names[i]], topk=2)[0]

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dyn.shutdown()
    _same(results, expected)


def test_export_validate_gate(exported_run, capsys):
    """--validate N: the deployment gate reruns stored val questions through
    both the live model and the artifact; exact agreement -> rc 0."""
    setup, out, _ = exported_run
    _export(setup, os.path.join(os.path.dirname(out), "exported_val"), "--validate", "12")
    assert "answer agreement 1.0000 over 12" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(TINY))
def test_exported_logits_match_the_jax_export(data_dir, name, capsys):
    """Each family (MutanAtt; CoR's relation chain, MFB's co-attention, the
    NoAtt family's pooled [N, 2048] features) exported by the CLI from the
    npz with --validate 8, then held against the JAX export of the same
    float32 params: logits within 1e-4, the same answers."""
    setup = _setup(data_dir, name)
    out = os.path.join(data_dir, f"exported_{name}")
    ep = _export(setup, out, "--params_npz", setup["npz"], "--validate", "8")
    assert "answer agreement 1.0000 over 8" in capsys.readouterr().out
    assert ep.meta["ops"] == [f"vqa_tpu_torch::{op}" for op in OPS[name]]
    assert ep.meta["feature_shape"] == ([2048] if name == "mutan_noatt" else [36, 2048])

    jax_pred = JaxPredictor.from_run(
        data_dir, setup["path_opt"], resume=None,
        overrides=setup["overrides"] + [f"model.pretrained_params={setup['npz']}"])
    jax_out = os.path.join(data_dir, f"jax_exported_{name}")
    jax_save_export(jax_out, jax_pred, batch=BATCH)
    jax_ep = jax_load_export(jax_out)
    names = [str(n) for n in ep.dataset.split.image_names[:3]]
    qs = QUESTIONS[:2] + [""]  # the empty question: an all-padding row
    q, lengths = ep.encode_questions(qs)
    visual = ep.dataset.features.get(ep.dataset.features.index_of(names))
    want = jax_ep.logits(visual, jnp.asarray(q.numpy()), jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(ep.logits(visual, q, lengths), want, rtol=JAX_TOL, atol=JAX_TOL)
    _same(ep.answer_batch(qs, names, topk=3), jax_ep.answer_batch(qs, names, topk=3),
          tol=JAX_TOL)


def test_quantize_int8_matches_jax_bit_for_bit(exported_run):
    """The same flat float32 tree through both packages' quantize_int8: the
    same leaves quantized (every floating leaf of ndim >= 2, the embedding
    table included), int8 values and float32 scales equal bit for bit, and
    dequantized weights equal."""
    _, _, predictor = exported_run
    flat = {k: v.numpy() for k, v in model_params(predictor.model).items()}
    assert flat["encoder/embed/embedding"].ndim == 2
    got = quantize_int8({k: torch.from_numpy(v) for k, v in flat.items()})
    want = jax_quantize_int8({k: jnp.asarray(v) for k, v in flat.items()})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            assert got[k]["dtype"] == w["dtype"] == "float32", k
            for part in ("q", "scale"):
                g = got[k][part].numpy()
                assert g.dtype == np.asarray(w[part]).dtype and g.shape == w[part].shape, k
                np.testing.assert_array_equal(g, np.asarray(w[part]), err_msg=f"{k}/{part}")
        else:
            assert flat[k].ndim < 2 and torch.equal(got[k], torch.from_numpy(flat[k])), k
    assert any(isinstance(w, dict) for w in want.values())


def test_load_path_never_imports_model_code(exported_run):
    """The deployment contract: loading and serving an artifact touches
    neither the model zoo (vqa_tpu_torch.models) nor jax, in a fresh
    interpreter."""
    _, out, predictor = exported_run
    image = str(predictor.dataset.split.image_names[0])
    code = f"""
import json, sys
from vqa_tpu_torch.export import load_export
p = load_export({out!r}, device="cpu")
ans = p.answer_batch(["what color is it"], [{image!r}], topk=2)
bad = [m for m in sys.modules if m.startswith("vqa_tpu_torch.models")
       or m.split(".")[0] in ("jax", "flax", "vqa_tpu")]
assert not bad, f"imported on the load path: {{bad}}"
print(json.dumps(ans[0][0][0]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    top1 = json.loads(proc.stdout.strip().splitlines()[-1])
    assert top1 == predictor.answer("what color is it", image, topk=2)[0][0]


def _jax_artifact(root, exported):
    """A directory shaped as the JAX package's export (program.jaxexport and
    its meta.json)."""
    jax_dir = os.path.join(root, "jax_artifact")
    os.makedirs(jax_dir, exist_ok=True)
    with open(os.path.join(exported, "meta.json")) as f:
        meta = json.load(f)
    meta["format"] = "vqa_tpu.export/1"
    with open(os.path.join(jax_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    open(os.path.join(jax_dir, "program.jaxexport"), "wb").close()
    return jax_dir


@pytest.mark.parametrize("case", ["jax_artifact", "other_device", "cuda_artifact_no_card",
                                  "float32_program_on_the_card"])
def test_load_refuses_what_it_cannot_run(exported_run, tmp_path, monkeypatch, case):
    """A JAX artifact (program.jaxexport); the card asked for on a machine
    without one, for a host-traced program and for a card-traced one; and a
    program that computes in float32 asked for on the card, whose kernels
    take bf16: each refused with a message naming what it found."""
    _, out, _ = exported_run
    if case == "jax_artifact":
        with pytest.raises(ValueError, match=r"program\.jaxexport.*program\.pt2"):
            load_export(_jax_artifact(str(tmp_path), out), device="cpu")
    elif case == "other_device":
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA card")
        with pytest.raises(ValueError, match="traced on cpu.*cannot run on cuda.*no CUDA card"):
            load_export(out, device="cuda")
    elif case == "float32_program_on_the_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(ValueError, match="computes in float32.*take bfloat16"):
            load_export(out, device="cuda")
    else:
        moved = str(tmp_path / "cuda_artifact")
        os.makedirs(moved)
        with open(os.path.join(out, "meta.json")) as f:
            meta = json.load(f)
        meta["device"] = "cuda"
        with open(os.path.join(moved, "meta.json"), "w") as f:
            json.dump(meta, f)
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA card")
        with pytest.raises(ValueError, match="traced on cuda.*no CUDA card"):
            load_export(moved)


def _devices(program) -> set:
    """Every device a program names: its weights' and constants', the
    device arguments of its graph's nodes and their recorded outputs'."""
    found = {v.device.type for v in (*program.state_dict.values(), *program.constants.values())
             if isinstance(v, torch.Tensor)}
    for node in program.graph.nodes:
        leaves = torch.utils._pytree.tree_leaves((node.args, node.kwargs, node.meta.get("val")))
        found |= {x.type for x in leaves if isinstance(x, torch.device)}
        found |= {x.device.type for x in leaves if isinstance(x, torch.Tensor)}
    return found


def test_program_traced_elsewhere_runs_on_the_host(exported_run):
    """A program traced on another device serves on the host. This CPU
    build cannot trace the model under fake CUDA tensors (its advanced
    indexing asks for a CUDA device guard, which the build lacks), so
    MutanAtt's weight-free forward is traced on the meta device, which names
    a device in the graph as the card does (chip_smoke.py's [export] loads a
    card-traced artifact on the host). Traced, it names meta throughout;
    written by ``write_program`` and loaded by ``load_export(device='cpu')``
    it names the host alone, calls the same registered ops, and gives the
    live model's logits (the same float32 ops), with its meta naming the
    meta device or the card."""
    from vqa_tpu_torch.export import _External, program_ops, write_program

    setup, out, predictor = exported_run
    out_ext = os.path.join(os.path.dirname(out), "exported_elsewhere")
    _export(setup, out_ext, "--params", "external")
    seq, shape = predictor.opt.vqa.maxlength, tuple(predictor.table.shape[1:])
    args = ({k: v.to("meta") for k, v in model_params(predictor.model).items()},
            torch.zeros((BATCH, *shape), device="meta"),
            torch.ones((BATCH, seq), dtype=torch.int32, device="meta"),
            torch.full((BATCH,), seq, dtype=torch.int32, device="meta"))
    with torch.no_grad():
        program = torch.export.export(_External(predictor.model), args, strict=False)
    program.example_inputs = None
    assert _devices(program) == {"meta"}
    ops = program_ops(program)
    write_program(program, out_ext)
    assert _devices(torch.export.load(os.path.join(out_ext, "program.pt2"))) == {"cpu"}
    with open(os.path.join(out_ext, "meta.json")) as f:
        meta = json.load(f)
    meta["device"] = "meta"
    with open(os.path.join(out_ext, "meta.json"), "w") as f:
        json.dump(meta, f)

    ep = load_export(out_ext, device="cpu")
    assert ep.device == torch.device("cpu") and _devices(ep.program) == {"cpu"}
    assert program_ops(ep.program) == ops == [f"vqa_tpu_torch::{op}" for op in OPS["mutan_att"]]
    _, visual, q, lengths = _inputs(predictor)
    want = _live(predictor, visual, q, lengths)
    np.testing.assert_allclose(ep.logits(visual, q, lengths), want, rtol=TOL, atol=TOL)
    # a card-traced artifact's meta no longer keeps it off the host
    meta["device"] = "cuda"
    with open(os.path.join(out_ext, "meta.json"), "w") as f:
        json.dump(meta, f)
    np.testing.assert_allclose(load_export(out_ext, device="cpu").logits(visual, q, lengths),
                               want, rtol=TOL, atol=TOL)
