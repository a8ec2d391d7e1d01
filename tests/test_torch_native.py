"""The port's native question encoder (vqa_tpu_torch/native/) against the JAX
package's (vqa_tpu.native) and against the port's Python encoder, and the
port's prep through it.

Encoder: byte-equal ids and lengths on tests/test_native.py's corpus under
both pads, 200 seeded fuzz strings, empty and whitespace-only questions and
truncation. Prep: the port's run_prep over a fixture (mcb) writes the JAX
prep's artifacts and counts its splits as natively encoded; a split with one
non-ASCII question is encoded in Python and still matches. Build: the library
lands in vqa_tpu_torch/_build/, and a build with a missing compiler warns
once, keeps the message and leaves prep to the Python encoder.
"""

import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from vqa_tpu_torch import config as port_config
from vqa_tpu_torch import native
from vqa_tpu_torch.datasets import processed as port_processed
from vqa_tpu_torch.datasets.tokenizer import tokenize_mcb

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH_OPT = os.path.join(REPO, "options", "vqa2", "mutan_att.yaml")

VOCAB = ["<pad>", "<unk>", "what", "color", "is", "the", "cat", "how", "many",
         "dogs", "are", "there", "a", "in", "picture", "330", "pm", "mans",
         "shirt", "photo", "booth"]
W2W = {w: i for i, w in enumerate(VOCAB)}

# tests/test_native.py's corpus
CORPUS = [
    "What color is the cat?",
    "Is this a man's shirt?",
    "How many dogs are there?",
    "Is it 3:30 pm?",
    "left/right or UP-down?",
    '"Quoted" question, with (parens) and $signs!',
    "unknownword anotherunknown",
    "",
    "   ",
    "a " * 50,  # truncation
]


@pytest.fixture(scope="module")
def encoders():
    from vqa_tpu import native as jax_native

    assert native.available(), native.build_error()
    assert jax_native.available()
    return native.NativeEncoder(VOCAB), jax_native.NativeEncoder(VOCAB)


def _python(questions, maxlength, pad):
    rows = [port_processed.encode_question(tokenize_mcb(q), W2W, maxlength, pad)
            for q in questions]
    return (np.stack([r for r, _ in rows]).astype(np.int32),
            np.asarray([n for _, n in rows], np.int32))


def _assert_three_agree(encoders, questions, maxlength, pad):
    port, jax_enc = encoders
    got = port.encode_batch(questions, maxlength=maxlength, pad=pad)
    for want in (jax_enc.encode_batch(questions, maxlength=maxlength, pad=pad),
                 _python(questions, maxlength, pad)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
            assert g.tobytes() == w.tobytes(), (questions, pad)


@pytest.mark.parametrize("pad", ["right", "left"])
def test_corpus_matches_the_jax_encoder_and_python(encoders, pad):
    _assert_three_agree(encoders, CORPUS, 8, pad)


@pytest.mark.parametrize("pad", ["right", "left"])
def test_fuzz_matches_the_jax_encoder_and_python(encoders, pad):
    rng = np.random.default_rng(0)
    chars = list("abcdefgh XYZ?!'\"$:@(),.;-/0123456789\t")
    fuzz = ["".join(rng.choice(chars, size=rng.integers(0, 60))) for _ in range(200)]
    _assert_three_agree(encoders, fuzz, 12, pad)


@pytest.mark.parametrize("questions", [[""], ["   "], ["\t \f"], ["", "what", ""]],
                         ids=["empty", "spaces", "whitespace", "empty_around_a_word"])
def test_empty_and_whitespace_only_questions(encoders, questions):
    _assert_three_agree(encoders, questions, 5, "right")
    ids, lengths = encoders[0].encode_batch(questions, 5)
    assert (ids[lengths == 0] == port_processed.PAD_ID).all()


@pytest.mark.parametrize("maxlength", [1, 3, 26])
def test_truncation(encoders, maxlength):
    questions = ["what color is the cat in the picture " * 4, "how many dogs are there"]
    _assert_three_agree(encoders, questions, maxlength, "left")
    _, lengths = encoders[0].encode_batch(questions, maxlength)
    assert lengths[0] == maxlength


@pytest.mark.parametrize("sep", ["\x1c", "\x1d", "\x1e", "\x1f"])
def test_ascii_separators_split_only_in_python(encoders, sep):
    """ROADMAP queue 3, fault 11: Python's str.split() splits on the ASCII
    file/group/record/unit separators, the C++ core (the original's and the
    port's alike) does not. The port's native encoder keeps the original's
    bytes; a fix changes this test."""
    port, jax_enc = encoders
    question = f"what{sep}color"
    got = port.encode_batch([question], 4)
    want = jax_enc.encode_batch([question], 4)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    assert got[1][0] == 1 and _python([question], 4, "right")[1][0] == 2


def test_library_lands_in_the_build_dir():
    assert native.available()
    assert os.path.dirname(native._SO) == os.path.join(REPO, "vqa_tpu_torch", "_build")
    assert os.path.exists(native._SO)
    assert os.path.getmtime(native._SO) >= os.path.getmtime(native._SRC)


# ------------------------------------------------------------------- prep


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    from vqa_tpu_torch.datasets.fixtures import generate

    d = str(tmp_path_factory.mktemp("native_prep"))
    generate(d, n_images=6, n_questions=40, seed=31)
    return os.path.join(d, "vqa2", "raw")


def _options(overrides=()):
    from vqa_tpu.config import load_options as jax_load_options

    overrides = ["vqa.nans=12", *overrides]
    return jax_load_options(PATH_OPT, overrides), port_config.load_options(PATH_OPT, overrides)


def _prep_both(raw, tmp_path, overrides=(), edit=None):
    """Copies of ``raw`` (after ``edit``) prepared by each package; returns
    the two processed dirs and the splits the port's prep counted by
    encoder."""
    from vqa_tpu.datasets.processed import run_prep as jax_run_prep

    jax_opt, port_opt = _options(overrides)
    roots = {side: str(tmp_path / side) for side in ("port", "jax")}
    for root in roots.values():
        shutil.copytree(raw, os.path.join(root, "raw"))
        if edit is not None:
            edit(os.path.join(root, "raw"))
    before = dict(port_processed.ENCODERS)
    got = port_processed.run_prep(roots["port"], port_opt.vqa, ("train", "val"))
    counted = {k: v - before.get(k, 0) for k, v in port_processed.ENCODERS.items()
               if v != before.get(k, 0)}
    want = jax_run_prep(roots["jax"], jax_opt.vqa, ("train", "val"))
    return got, want, counted


def _assert_same_artifacts(got, want):
    """vocab.json byte for byte; every array of every split by its bytes,
    dtype and shape (the .npz files are zips with timestamps)."""
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    with open(os.path.join(got, "vocab.json"), "rb") as a, \
            open(os.path.join(want, "vocab.json"), "rb") as b:
        assert a.read() == b.read()
    for name in os.listdir(want):
        if name.endswith(".npz"):
            with np.load(os.path.join(got, name)) as g, np.load(os.path.join(want, name)) as w:
                assert sorted(g.files) == sorted(w.files)
                for key in w.files:
                    assert (g[key].dtype, g[key].shape) == (w[key].dtype, w[key].shape)
                    assert g[key].tobytes() == w[key].tobytes(), (name, key)


@pytest.mark.parametrize("overrides", [(), ("vqa.pad=left", "vqa.maxlength=5")],
                         ids=["yaml", "left_pad_maxlength5"])
def test_prep_is_native_and_writes_the_jax_artifacts(raw, tmp_path, overrides):
    got, want, counted = _prep_both(raw, tmp_path, overrides)
    assert counted == {"native": 2}
    _assert_same_artifacts(got, want)


def test_non_ascii_split_is_encoded_in_python(raw, tmp_path):
    """One val question with a non-ASCII letter: val goes through Python (the
    C++ core lowercases bytewise), train stays native, both match JAX."""
    qfile = "v2_OpenEnded_mscoco_val2014_questions.json"

    def edit(d):
        with open(os.path.join(d, qfile)) as f:
            data = json.load(f)
        data["questions"][3]["question"] = "Is the CAFÉ open, Ünder the sign?"
        with open(os.path.join(d, qfile), "w") as f:
            json.dump(data, f)

    got, want, counted = _prep_both(raw, tmp_path, edit=edit)
    assert counted == {"native": 1, "python": 1}
    _assert_same_artifacts(got, want)


def test_naive_tokenizer_is_encoded_in_python(raw, tmp_path):
    got, want, counted = _prep_both(raw, tmp_path, ("vqa.nlp=naive",))
    assert counted == {"python": 2}
    _assert_same_artifacts(got, want)


def test_failed_build_warns_once_and_prep_reports_python(raw, tmp_path, monkeypatch):
    """g++ pointed at a missing compiler: the first call warns with the
    compiler's message, later calls stay quiet, and the prep encodes in
    Python with the same bytes."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "_SO", str(tmp_path / "build" / "libvqa_tokenizer.so"))
    monkeypatch.setattr(native, "COMPILER", str(tmp_path / "no-such-g++"))
    with pytest.warns(RuntimeWarning, match="no-such-g\\+\\+"):
        assert not native.available()
    assert "no-such-g++" in native.build_error()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not native.available()
        got, want, counted = _prep_both(raw, tmp_path / "prep")
    assert counted == {"python": 2}
    _assert_same_artifacts(got, want)
    assert not os.path.exists(native._SO)
    with pytest.raises(RuntimeError, match="native tokenizer unavailable"):
        native.NativeEncoder(VOCAB)


def test_failed_compile_keeps_the_compilers_message(tmp_path, monkeypatch):
    """A compiler that runs and fails: its output is the kept message, and no
    library (nor temporary file) is left behind."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "build" / "libvqa_tokenizer.so"))
    with pytest.warns(RuntimeWarning, match="did not build"):
        assert not native.available()
    assert "g++ failed" in native.build_error() and "bad.cc" in native.build_error()
    assert os.listdir(tmp_path / "build") == ["libvqa_tokenizer.so.lock"]
