"""The port's serving side against the JAX package's, on a fixture run.

A tiny MutanAtt's flax params are saved with save_tree_npz; the port's
Predictor.from_run(params=npz) must answer as the JAX Predictor.from_run
(resume=None, model.pretrained_params=npz) does: same answers, probabilities
within 1e-5 (float32 on both sides). The port's eval step must give the
JAX eval step's outputs on a batch that gathers from a feature table (float32,
or int8 with per-row scales). The port's copy of the HTTP layer must answer
every request as the original (vqa_tpu.cli.serve) does.
"""

import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqa_tpu.cli import serve as jax_serve
from vqa_tpu.config import load_options
from vqa_tpu.datasets import factory as dataset_factory
from vqa_tpu.datasets.fixtures import generate
from vqa_tpu.datasets.processed import encode_question_batch as jax_encode_batch
from vqa_tpu.datasets.tokenizer import get_tokenizer as jax_get_tokenizer
from vqa_tpu.engine.steps import create_state, make_eval_step as jax_make_eval_step
from vqa_tpu.importers import save_tree_npz
from vqa_tpu.models import factory as jax_factory
from vqa_tpu.predictor import Predictor as JaxPredictor
from vqa_tpu_torch.cli import serve as port_serve
from vqa_tpu_torch.cli.serve import AnswerService, DynamicBatcher, build_server
from vqa_tpu_torch.cli.serve import main as serve_main
from vqa_tpu_torch.datasets.processed import encode_question_batch
from vqa_tpu_torch.datasets.tokenizer import get_tokenizer
from vqa_tpu_torch.engine.steps import make_eval_step, quantize_features
from vqa_tpu_torch.predictor import Predictor

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH_OPT = os.path.join(REPO, "options/vqa2/mutan_att.yaml")
TINY = [
    "model.seq2vec.emb_size=16", "model.seq2vec.hidden_size=32",
    "model.attention.dim_hv=12", "model.attention.dim_hq=12",
    "model.attention.dim_mm=16", "model.attention.R=2",
    "model.fusion.dim_hv=12", "model.fusion.dim_hq=12",
    "model.fusion.dim_mm=16", "model.fusion.R=2",
]
QUESTIONS = [
    "What color is the cat?",
    "Is there a red-ish thing/object here?!",
    "how MANY zebras (or horses), exactly; do you see?",
    "unknownword anotherunknown",
    "",
    " ".join(["is it red"] * 12),  # longer than maxlength
]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torchserve"))
    generate(d, n_images=10, n_questions=48, seed=5)
    overrides = [f"vqa.dir={d}/vqa2", f"coco.dir={d}/coco", "vqa.nans=20"] + TINY
    opt = load_options(PATH_OPT, overrides)
    val_set = dataset_factory("val", opt)
    model = jax_factory(opt.model, val_set.num_words, val_set.num_answers)
    params = model.init(
        jax.random.key(7), jnp.zeros((2,) + val_set.feature_shape),
        jnp.zeros((2, opt.vqa.maxlength), jnp.int32), jnp.ones((2,), jnp.int32),
    )["params"]
    leaves, tree = jax.tree.flatten(params)  # non-zero biases throughout
    params = jax.tree.unflatten(tree, [p + 0.02 * (i % 5) for i, p in enumerate(leaves)])
    npz = os.path.join(d, "params.npz")
    save_tree_npz(npz, params)
    jax_pred = JaxPredictor.from_run(
        d, PATH_OPT, resume=None, overrides=overrides + [f"model.pretrained_params={npz}"]
    )
    port_pred = Predictor.from_run(d, PATH_OPT, params=npz, overrides=overrides, device="cpu")
    return jax_pred, port_pred, npz, d, overrides


def _same(got, want, tol=1e-5):
    assert [[a for a, _ in row] for row in got] == [[a for a, _ in row] for row in want]
    for g, w in zip(got, want):
        for (_, pg), (_, pw) in zip(g, w):
            assert abs(pg - pw) <= tol


def test_tokenizer_and_encoder_copies_match_the_originals():
    corpus = QUESTIONS + ["What's on the plate?", "left/right - which?", "A.B,C;D:E@F$G"]
    vocab = {w: i for i, w in enumerate(
        ["<pad>", "<unk>", "what", "color", "is", "the", "cat", "it", "red", "ish", "thing"])}
    for nlp in ("mcb", "naive"):
        for q in corpus:
            assert get_tokenizer(nlp)(q) == jax_get_tokenizer(nlp)(q)
        for pad in ("right", "left"):
            got = encode_question_batch(corpus, get_tokenizer(nlp), vocab, 8, pad)
            want = jax_encode_batch(corpus, jax_get_tokenizer(nlp), vocab, 8, pad)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype


def test_predictor_answers_match_jax(run):
    jax_pred, port_pred, _, _, _ = run
    names = [str(n) for n in jax_pred.dataset.split.image_names[: len(QUESTIONS)]]
    _same(port_pred.answer_batch(QUESTIONS, names, topk=4),
          jax_pred.answer_batch(QUESTIONS, names, topk=4))
    _same([port_pred.answer(QUESTIONS[0], names[1], topk=2)],
          [jax_pred.answer(QUESTIONS[0], names[1], topk=2)])


def test_predictor_left_padding_matches_jax(run):
    jax_pred, _, npz, d, overrides = run
    left = overrides + ["vqa.pad=left"]
    jax_left = JaxPredictor.from_run(d, PATH_OPT, resume=None,
                                     overrides=left + [f"model.pretrained_params={npz}"])
    port_left = Predictor.from_run(d, PATH_OPT, params=npz, overrides=left, device="cpu")
    names = [str(n) for n in jax_pred.dataset.split.image_names[: len(QUESTIONS)]]
    _same(port_left.answer_batch(QUESTIONS, names), jax_left.answer_batch(QUESTIONS, names))


def test_port_server_answers(run):
    _, port_pred, _, _, _ = run
    service = AnswerService(port_pred, max_batch=4)
    service.warmup()
    server = build_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())

    try:
        names = [str(n) for n in port_pred.dataset.split.image_names[:3]]
        status, body = post("/answer", {"question": QUESTIONS[0], "image": names[0], "topk": 3})
        assert status == 200
        assert [a for a, _ in body["answers"]] == \
            [a for a, _ in port_pred.answer(QUESTIONS[0], names[0], topk=3)]
        qs = [f"is object {i} red?" for i in range(9)]
        ims = [names[i % 3] for i in range(9)]
        status, body = post("/batch", {"questions": qs, "images": ims})
        assert status == 200 and len(body["answers"]) == 9  # 9 > max_batch 4: chunked
        _same([[tuple(x) for x in row] for row in body["answers"]],
              port_pred.answer_batch(qs, ims))
        req = urllib.request.Request(base + "/answer", json.dumps(
            {"question": "q", "image": "no-such-image"}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 404  # the catalog's KeyError, as with the JAX store
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def _eval_both(run, jax_features, port_features):
    """One batch that gathers from a feature table, through the JAX eval
    step and the port's; returns (port outputs, JAX outputs)."""
    jax_pred, port_pred, _, _, _ = run
    n_rows = port_pred.table.shape[0]
    rng = np.random.default_rng(9)
    B = 10
    question, length = port_pred.encode_questions(
        [QUESTIONS[i % len(QUESTIONS)] for i in range(B)])
    batch = {
        "question": question.numpy(),
        "length": length.numpy(),
        "image_index": rng.integers(0, n_rows, B).astype(np.int32),
        "answer": np.where(np.arange(B) % 4 == 0, -1,
                           rng.integers(0, port_pred.dataset.num_answers, B)).astype(np.int32),
        "valid": np.arange(B) < B - 2,
    }
    state = create_state(jax_pred.model, jax_pred.params, optax.sgd(0.1))
    want = jax_make_eval_step()(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                jax_features)
    port_batch = {k: (v if k == "image_index" else torch.from_numpy(v)) for k, v in batch.items()}
    got = make_eval_step()(port_pred.model, port_batch, port_features)
    assert set(got) == set(want) == {"pred", "n", "n_labeled", "correct1", "correct5"}
    return got, want


def test_eval_step_matches_jax(run):
    _, port_pred, _, _, _ = run
    got, want = _eval_both(run, jnp.asarray(port_pred.table.numpy()), port_pred.table)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float32"])
def test_eval_step_int8_table_matches_jax(run, scale_dtype):
    """An int8 (values, scales) table (engine.features_dtype=int8): rows
    gathered as int8 and dequantized in the scales' dtype, bf16 as
    vqa_tpu/cli/train.py places them under a bf16 compute dtype, or float32.
    The outputs equal the JAX eval step's exactly."""
    _, port_pred, _, _, _ = run
    values, scales = quantize_features(port_pred.table.numpy())
    jax_features = (jnp.asarray(values), jnp.asarray(scales, getattr(jnp, scale_dtype)))
    port_features = (torch.from_numpy(values),
                     torch.from_numpy(scales).to(getattr(torch, scale_dtype)))
    got, want = _eval_both(run, jax_features, port_features)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("flag", [["--exported"]])
def test_serve_cli_refuses_jax_only_artifacts(run, tmp_path, flag, capsys):
    """``--exported`` serves the port's artifacts; a JAX package's artifact
    (program.jaxexport, written here by vqa_tpu.export) is refused, naming
    both formats and the port's export CLI."""
    from vqa_tpu.export import save_export as jax_save_export

    jax_pred = run[0]
    jax_dir = str(tmp_path / "jax_exported")
    jax_save_export(jax_dir, jax_pred, batch=2)
    with pytest.raises(SystemExit):
        serve_main([*flag, jax_dir, "--platform", "cpu"])
    err = capsys.readouterr().err
    assert "program.jaxexport" in err and "program.pt2" in err
    assert "vqa_tpu_torch.cli.export" in err


class _StoppedServer:
    server_address = ("127.0.0.1", 0)

    def serve_forever(self):
        raise KeyboardInterrupt

    def server_close(self):
        pass


def _checkpointed_run(npz, overrides, run_dir):
    """A run dir whose ckpt/ holds the npz's weights as epoch 0 (through the
    port's CheckpointManager and a training build) and whose options.yaml
    carries the overrides."""
    import dataclasses

    from vqa_tpu_torch.config import dump_options, load_options as port_load_options
    from vqa_tpu_torch.datasets.factory import factory as port_dataset_factory
    from vqa_tpu_torch.engine import optim
    from vqa_tpu_torch.engine.checkpoint import CheckpointManager
    from vqa_tpu_torch.engine.steps import create_state
    from vqa_tpu_torch.models.factory import factory as port_model_factory
    from vqa_tpu_torch.weights import load_params

    opt = port_load_options(PATH_OPT, overrides)
    ds = port_dataset_factory("val", opt)
    model = port_model_factory(dataclasses.asdict(opt.model), ds.num_words, ds.num_answers,
                               dim_v=ds.feature_shape[-1], train=True)
    with np.load(npz) as flat:
        load_params(model, flat)
    CheckpointManager(os.path.join(run_dir, "ckpt")).save(
        create_state(model, optim.factory(opt.optim)), 0, 0.5)
    dump_options(opt, run_dir)


def test_serve_cli_serves_the_runs_checkpoint(run, tmp_path, monkeypatch):
    """With neither --params nor --no_resume the CLI serves the checkpoint
    --resume names (default best): the same answers as the npz it holds."""
    _, port_pred, npz, _, overrides = run
    run_dir = str(tmp_path / "run")
    _checkpointed_run(npz, overrides, run_dir)
    seen = {}

    def build(service, host, port):
        seen["service"] = service
        return _StoppedServer()

    monkeypatch.setattr(port_serve, "build_server", build)
    for flags in ([], ["--resume", "0"]):
        assert serve_main(["--dir_logs", run_dir, "--platform", "cpu", *flags]) == 0
        served = seen.pop("service").predictor
        names = [str(n) for n in port_pred.dataset.split.image_names[: len(QUESTIONS)]]
        _same(served.answer_batch(QUESTIONS, names, topk=3),
              port_pred.answer_batch(QUESTIONS, names, topk=3), tol=0)


def test_serve_cli_without_a_checkpoint_names_both_sources(tmp_path, capsys):
    """No checkpoint and neither --params nor --no_resume: the error names
    the missing checkpoint and both ways to serve an npz instead."""
    from vqa_tpu_torch.config import dump_options, load_options as port_load_options

    run_dir = str(tmp_path / "bare")
    dump_options(port_load_options(PATH_OPT, TINY), run_dir)
    with pytest.raises(SystemExit):
        serve_main(["--dir_logs", run_dir, "--platform", "cpu"])
    err = capsys.readouterr().err
    assert "no 'best' checkpoint" in err and "--params" in err and "--no_resume" in err


def _reference_parser():
    """The argparse parser ``vqa_tpu.cli.serve.main`` builds, caught at its
    parse_args (the original builds it inside main)."""
    import argparse

    class Caught(Exception):
        pass

    def catch(self, *args, **kwargs):
        raise Caught(self)

    saved = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        jax_serve.main([])
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = saved
    raise AssertionError("vqa_tpu.cli.serve.main parsed no arguments")


def _flags(parser):
    return {a.option_strings[0]: a for a in parser._actions
            if a.option_strings and a.option_strings[0] != "-h"}


def test_serve_cli_flags_match_the_reference():
    """Every flag of the original's serve CLI is the port's, with its
    default, type and action (--resume best, --exported and --coco_dir
    included; --dir_logs not required, as exactly one of it and --exported
    is); the port adds --params (its npz)."""
    want, got = _flags(_reference_parser()), _flags(port_serve.build_argparser())
    assert set(want) - set(got) == set()
    assert set(got) - set(want) == {"--params"}
    for flag, action in want.items():
        mine = got[flag]
        assert (mine.default, mine.type, type(mine), mine.required) == \
            (action.default, action.type, type(action), action.required), flag
    assert not got["--dir_logs"].required and got["--resume"].default == "best"


def test_serve_cli_refuses_a_request_timeout_without_dynamic_batching(capsys):
    with pytest.raises(SystemExit):
        serve_main(["--dir_logs", "x", "--request_timeout_s", "3"])
    assert "requires --dynamic_batching" in capsys.readouterr().err


def test_serve_cli_passes_its_flags_to_the_service(run, monkeypatch):
    """--platform cpu and --no_resume (no checkpoint: resume None) reach
    from_run, and the batching flags the DynamicBatcher; the server is
    stubbed to stop at once."""
    _, port_pred, _, _, _ = run
    seen = {}

    def from_run(dir_logs, path_opt=None, params=None, device="cuda", resume=None):
        seen["device"], seen["resume"] = device, resume
        return port_pred

    def build(service, host, port):
        seen["service"] = service
        return _StoppedServer()

    monkeypatch.setattr(Predictor, "from_run", staticmethod(from_run))
    monkeypatch.setattr(port_serve, "build_server", build)
    assert serve_main(["--dir_logs", "x", "--platform", "cpu", "--no_resume", "--max_batch", "4",
                       "--dynamic_batching", "--batch_wait_ms", "7", "--batch_window_ms", "30",
                       "--request_timeout_s", "2.5"]) == 0
    service = seen["service"]
    assert seen["device"] == "cpu" and seen["resume"] is None
    assert isinstance(service, DynamicBatcher)
    assert (service.max_wait, service.window, service.request_timeout) == (0.007, 0.03, 2.5)
    assert service.service.max_batch == 4


def _transcript(serve_mod, predictor, dynamic):
    """Every kind of request the HTTP layer answers, and what it answered."""
    service = serve_mod.AnswerService(predictor, max_batch=4)
    if dynamic:
        service = serve_mod.DynamicBatcher(service, max_wait_ms=1)
    server = serve_mod.build_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    names = [str(n) for n in predictor.dataset.split.image_names[:3]]
    too_many = predictor.dataset.num_answers + 1
    requests = [
        ("GET", "/healthz", None), ("GET", "/nope", None),
        ("POST", "/answer", {"question": QUESTIONS[1], "image": names[0], "topk": 3}),
        ("POST", "/batch", {"questions": QUESTIONS + QUESTIONS[:3],
                            "images": [names[i % 3] for i in range(9)]}),
        ("POST", "/answer", {"question": "q"}),
        ("POST", "/answer", {"question": "q", "image": names[0], "topk": 0}),
        ("POST", "/answer", {"question": "q", "image": names[0], "topk": too_many}),
        ("POST", "/nope", {"question": "q", "image": names[0]}),
        ("POST", "/answer", {"question": "q", "image": "no-such-image"}),
        ("POST", "/batch", {"questions": ["a", "b"], "images": [names[0]]}),
        ("POST", "/answer", b"{not json"),
        ("POST", "/answer", None),  # no Content-Length
        ("GET", "/metrics", None),
    ]
    out = []
    try:
        for method, path, body in requests:
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
            if isinstance(body, dict):
                body = json.dumps(body).encode()
            conn.putrequest(method, path)
            if body is not None:
                conn.putheader("Content-Length", str(len(body)))
            conn.endheaders(body)
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            conn.close()
            if path == "/metrics":  # wall-clock seconds differ run to run
                payload.pop("device_seconds")
            out.append((method, path, resp.status, payload))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        if dynamic:
            service.shutdown()
    return out


@pytest.mark.parametrize("dynamic", [False, True])
def test_http_layer_matches_the_original(run, dynamic):
    _, port_pred, _, _, _ = run
    got = _transcript(port_serve, port_pred, dynamic)
    assert got == _transcript(jax_serve, port_pred, dynamic)
    assert [status for _, _, status, _ in got] == [
        200, 404, 200, 200, 400, 400, 400, 404, 404, 400, 400, 411, 200]


def _wait_for(condition, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not condition():
        assert time.monotonic() < deadline, "timed out waiting"
        time.sleep(0.01)


class _EchoService:
    max_batch = 4
    num_answers = 5

    def __init__(self, gate=None):
        self.calls = []
        self.gate = gate

    def answer_batch(self, questions, images, topk=5):
        self.calls.append(list(questions))
        if self.gate is not None:
            self.gate.wait(60)
        return [[(q, 1.0)] * topk for q in questions]


def test_dynamic_batcher_coalesces_concurrent_requests():
    svc = _EchoService()
    dyn = DynamicBatcher(svc, max_wait_ms=200)
    results = [None] * 4
    barrier = threading.Barrier(4)

    def hit(i):
        barrier.wait()
        results[i] = dyn.answer_batch([f"q{i}"], ["img"], topk=1 + i % 2)[0]

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    dyn.shutdown()
    assert results == [[(f"q{i}", 1.0)] * (1 + i % 2) for i in range(4)]
    assert len(svc.calls) < 4, "no two concurrent requests shared a forward"


def test_dynamic_batcher_times_out_and_drops_the_abandoned_request():
    """A wedged forward answers its waiting clients with TimeoutError, and a
    request that timed out in the queue never reaches the device."""
    gate = threading.Event()
    svc = _EchoService(gate)
    dyn = DynamicBatcher(svc, max_wait_ms=1, request_timeout_s=0.3)
    first = threading.Thread(target=lambda: pytest.raises(
        TimeoutError, dyn.answer_batch, ["A"], ["img"], topk=1), daemon=True)
    first.start()
    _wait_for(lambda: svc.calls == [["A"]])  # A holds the worker
    with pytest.raises(TimeoutError, match="unresponsive"):
        dyn.answer_batch(["B"], ["img"], topk=1)
    gate.set()
    first.join(timeout=10)
    assert dyn.answer_batch(["C"], ["img"], topk=1) == [[("C", 1.0)]]
    assert ["B"] not in svc.calls
    assert dyn.stats()["batcher"]["timeouts"] == 2
    dyn.shutdown()


@pytest.mark.parametrize("serve_mod", [port_serve, jax_serve], ids=["port", "original"])
def test_dynamic_batcher_shutdown_as_the_original(serve_mod):
    """The copy keeps the original's shutdown: the worker stops, a second
    shutdown is a no-op, and a later request is never run, so only its
    client's bounded wait ends it."""
    svc = _EchoService()
    dyn = serve_mod.DynamicBatcher(svc, max_wait_ms=1, request_timeout_s=0.3)
    assert dyn.answer_batch(["A"], ["img"], topk=1) == [[("A", 1.0)]]
    dyn.shutdown()
    assert not dyn._worker.is_alive(), "worker survived shutdown()"
    dyn.shutdown()
    with pytest.raises(TimeoutError, match="unresponsive"):
        dyn.answer_batch(["B"], ["img"], topk=1)
    assert svc.calls == [["A"]]
