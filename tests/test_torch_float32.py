"""float32 on the card: the float32 entries of the models' five kernels
(lstm_seq, glimpse_head, glimpse_attend, mfb_pool, relation_attend), and
``engine.dtype`` honoured by the train / eval CLI, the Predictor and export.

On the CPU, with no card and no nvcc:

- ``config.compute_dtype`` gives float32 for the YAMLs as written and bf16
  under ``engine.dtype=bfloat16``, and the CLI and ``Predictor.from_run``
  build the model in it when the device is the card;
- each op's CUDA implementation, handed float32 operands and a stand-in
  kernel library, calls the float32 entry with the operands' own storage
  and float32 outputs and scratch (no cast), and bf16 operands still reach
  the bf16 entry;
- the plans give a schedule, not a refusal, for 4-byte elements at every
  ``options/vqa2`` YAML's shapes and at R = N = 196;
- a float32 MutanAtt train step of the port, with every kernel call going
  through the dispatch a CUDA tensor takes (the CUDA implementations, their
  argument checks, plans and launch arguments) and a library whose float32
  entries compute the plain versions in the memory the wrapper hands them,
  matches JAX ``make_train_step`` in float32: the step's loss, acc1, acc5
  and gnorm within 1e-4, then every parameter within 1e-5 of its leaf's
  scale (tests/test_torch_train.py's tolerances for the same step through
  the CPU dispatch).

The ``cuda`` tests hold each float32 kernel against its plain version in
float32 with TF32 off, on the card: 1e-5 of the plain output's max-abs for
glimpse_head, glimpse_attend and relation_attend (fp32 sums in another
order), 1e-4 for lstm_seq (the same, carried through up to 26 steps of the
recurrence), bit-exact for gather_rows on float32 rows; mfb_pool, whose
signed square root is ill-conditioned near 0, against its plain version
in float64: within 1e-5, or twice the plain float32 version's own error. They
skip here. This file imports JAX only inside the train-step test, so the
card's machine (no flax) runs the ``cuda`` tests.
"""

import ctypes
import os
import types

import numpy as np
import pytest
import torch

from vqa_tpu_torch import config, flagship
from vqa_tpu_torch.config import compute_dtype, load_options
from vqa_tpu_torch.ops import _build
from vqa_tpu_torch.ops import attention, lstm, mfb_pool, relation
from vqa_tpu_torch.ops.attention import (glimpse_attend, glimpse_attend_reference, glimpse_head,
                                         glimpse_head_reference, glimpse_plan)
from vqa_tpu_torch.ops.gather import gather_rows
from vqa_tpu_torch.ops.lstm import lstm_plan, lstm_seq, lstm_seq_reference
from vqa_tpu_torch.ops.relation import relation_attend, relation_attend_reference, relation_plan

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_REL = 1e-5       # the kernels' float32 entries, of the plain output's max-abs
F32_LSTM_REL = 1e-4  # lstm_seq's: 26 steps carry the sums' other order
STEP_ATOL = 1e-4     # a train step's metrics (as tests/test_torch_train.py)
PARAM_REL = 1e-5     # the parameters after it, of each leaf's scale


# ---------------------------------------------------------- compute dtype


@pytest.mark.parametrize("yaml", sorted(os.listdir(os.path.join(REPO, "options", "vqa2"))))
def test_compute_dtype_is_engine_dtype(yaml):
    """Every options/vqa2 YAML as written computes in float32
    (options/default.yaml's engine.dtype), and in bf16 under the override."""
    path = os.path.join(REPO, "options", "vqa2", yaml)
    assert compute_dtype(load_options(path)) == torch.float32
    assert compute_dtype(load_options(path, ["engine.dtype=bfloat16"])) == torch.bfloat16


def test_compute_dtype_refuses_other_names():
    opt = load_options(os.path.join(REPO, "options", "vqa2", "mutan_att.yaml"),
                       ["engine.dtype=float16"])
    with pytest.raises(ValueError, match="engine.dtype"):
        compute_dtype(opt)


class _Built(Exception):
    """Raised by the stand-in model factory once it has seen its arguments."""


def _stub_val_set():
    return types.SimpleNamespace(num_words=10, num_answers=4, feature_shape=(36, 2048))


@pytest.mark.parametrize("override,want", [([], torch.float32),
                                           (["engine.dtype=bfloat16"], torch.bfloat16)])
def test_cli_builds_the_model_in_engine_dtype_on_the_card(tmp_path, monkeypatch, override, want):
    """The train / eval CLI on the card (its device stubbed to cuda) builds
    the model in engine.dtype: float32 for mutan_att.yaml as written."""
    from vqa_tpu_torch.cli import train as train_cli

    seen = {}

    def model_factory(model_opt, num_words, num_answers, dtype, device, **kw):
        seen.update(dtype=dtype, device=device)
        raise _Built

    monkeypatch.setattr(train_cli, "_device", lambda platform: torch.device("cuda"))
    monkeypatch.setattr(train_cli, "dataset_factory", lambda *a, **kw: _stub_val_set())
    monkeypatch.setattr(train_cli, "model_factory", model_factory)
    argv = ["--path_opt", os.path.join(REPO, "options", "vqa2", "mutan_att.yaml"), "-e",
            "--dir_logs", str(tmp_path / "run")]
    for o in override:
        argv += ["--opt", o]
    with pytest.raises(_Built):
        train_cli.main(argv)
    assert seen == {"dtype": want, "device": torch.device("cuda")}


@pytest.mark.parametrize("override,want", [([], torch.float32),
                                           (["engine.dtype=bfloat16"], torch.bfloat16)])
def test_predictor_builds_the_model_in_engine_dtype_on_the_card(tmp_path, monkeypatch, override,
                                                                want):
    """Predictor.from_run(device="cuda"), as the serve and export CLIs call
    it, builds the model in the run's engine.dtype."""
    from vqa_tpu_torch import predictor as predictor_lib
    from vqa_tpu_torch.datasets import factory as data_factory

    seen = {}

    def model_factory(model_opt, num_words, num_answers, dtype, device, **kw):
        seen.update(dtype=dtype, device=device)
        raise _Built

    val_set = _stub_val_set()
    val_set.features = types.SimpleNamespace(feature_shape=(36, 2048))
    monkeypatch.setattr(data_factory, "factory", lambda *a, **kw: val_set)
    monkeypatch.setattr(predictor_lib, "model_factory", model_factory)
    with pytest.raises(_Built):
        predictor_lib.Predictor.from_run(
            str(tmp_path), os.path.join(REPO, "options", "vqa2", "mutan_att.yaml"),
            params="weights.npz", overrides=override, device="cuda")
    assert seen["dtype"] == config.compute_dtype(
        load_options(os.path.join(REPO, "options", "vqa2", "mutan_att.yaml"), override))
    assert seen == {"dtype": want, "device": torch.device("cuda")}


@pytest.mark.parametrize("model_dtype,engine_dtype", [(torch.float32, "bfloat16"),
                                                     (torch.bfloat16, "float32")])
def test_export_refuses_a_model_not_in_its_options_dtype(tmp_path, model_dtype, engine_dtype):
    """save_export records the options' compute dtype, so a model built in
    another dtype is refused before anything is traced or written."""
    from vqa_tpu_torch.export import save_export
    from vqa_tpu_torch.predictor import Catalog, Predictor

    model = flagship.build(num_words=10, num_answers=4, tiny=True, dtype=model_dtype,
                           device="cpu")
    predictor = Predictor(model, Catalog({"a": 1}, ["x"] * 4, {"img": 0}),
                          torch.zeros(1, 36, 2048))
    predictor.opt = load_options(os.path.join(REPO, "options", "vqa2", "mutan_att.yaml"),
                                 [f"engine.dtype={engine_dtype}"])
    with pytest.raises(ValueError, match=f"computes in {engine_dtype}"):
        save_export(str(tmp_path / "out"), predictor, batch=2)
    assert not (tmp_path / "out").exists()


# ------------------------------------------- the entries each dtype takes


class _Recorder:
    """Stands in for the kernel library: records each entry's name and
    arguments, launches nothing, returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("vqa_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


def _no_f32_scratch(B, H, index):
    """The float32 lstm_seq's launch geometry, off the card: no scratch
    (the stand-in libraries need none)."""
    return dict.fromkeys(lstm._F32_GEOMETRY, 0)


@pytest.fixture
def recorder(monkeypatch):
    """A stand-in library, the card's shared memory and stream, and every
    torch.empty of the call recorded (the outputs and scratch)."""
    lib = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "smem_optin", lambda index: attention.SMEM_LIMIT)
    monkeypatch.setattr(_build, "current_stream", lambda device: 0)
    monkeypatch.setattr(lstm, "launch_geometry", lambda B, H, wg, index: dict(
        ctas=1, tail_split=1, part_bytes=0, tiles=1, tail_tiles=0, smem_bytes=0))
    monkeypatch.setattr(lstm, "launch_geometry_f32", _no_f32_scratch)
    empties = []
    real_empty = torch.empty

    def empty(*size, dtype=None, **kw):
        t = real_empty(*size, dtype=dtype, **kw)
        empties.append(t.dtype)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    lib.empties = empties
    return lib


def _operands(op, dtype):
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    if op == "lstm_seq":
        mask = torch.ones(3, 5, 1, dtype=dtype)
        return (randn(3, 5, 32), mask, randn(8, 32)), {}
    if op == "glimpse_head":
        return (randn(2, 5, 6), randn(6, 2), randn(2), randn(2, 5, 8)), {}
    if op == "glimpse_attend":
        return (randn(2, 5, 2), randn(2, 5, 8)), {}
    if op == "mfb_pool":
        return (randn(4, 3, 40),), {"k": 5}
    return (randn(2, 5, 16), randn(2, 5, 16)), {}


_CUDA_IMPLS = {
    "lstm_seq": (lstm._lstm_seq_cuda, "vqa_lstm_seq_f32", "vqa_lstm_seq"),
    "glimpse_head": (attention._glimpse_head_cuda, "vqa_glimpse_head_f32", "vqa_glimpse_head"),
    "glimpse_attend": (attention._glimpse_attend_cuda, "vqa_glimpse_attend_f32",
                       "vqa_glimpse_attend"),
    "mfb_pool": (mfb_pool._mfb_pool_cuda, "vqa_mfb_pool_f32", "vqa_mfb_pool"),
    "relation_attend": (relation._relation_attend_cuda, "vqa_relation_attend_f32",
                        "vqa_relation_attend"),
}


@pytest.mark.parametrize("op", sorted(_CUDA_IMPLS))
def test_float32_operands_take_the_float32_entry(recorder, op):
    """float32 operands: the float32 entry, once, handed the operands' own
    storage (no cast copy), every output and scratch allocated in float32
    (the barrier counter int32); bf16 operands: the bf16 entry."""
    impl, f32_entry, bf16_entry = _CUDA_IMPLS[op]
    args, kw = _operands(op, torch.float32)
    outs = impl(*args, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    (name, call), = [c for c in recorder.calls if not c[0].endswith("geometry")]
    assert name == f32_entry
    assert {a.data_ptr() for a in args} <= set(call)
    assert {o.data_ptr() for o in outs} <= set(call)
    assert all(o.dtype == torch.float32 for o in outs)
    assert set(recorder.empties) <= {torch.float32, torch.int32}

    recorder.calls.clear()
    args, kw = _operands(op, torch.bfloat16)
    outs = impl(*args, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert [c[0] for c in recorder.calls if not c[0].endswith("geometry")] == [bf16_entry]
    assert all(o.dtype == torch.bfloat16 for o in outs)


@pytest.mark.parametrize("op", sorted(_CUDA_IMPLS))
def test_kernels_refuse_other_dtypes(recorder, op):
    """float16 (no entry) and mixed float32 / bf16 operands are refused
    before anything crosses into C."""
    impl = _CUDA_IMPLS[op][0]
    args, kw = _operands(op, torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or torch.float32|the kernel takes"):
        impl(*args, **kw)
    if len(args) > 1:
        mixed = (args[0].float(), *(a.bfloat16() for a in args[1:]))
        with pytest.raises(TypeError, match="the kernel takes"):
            impl(*mixed, **kw)
    assert recorder.calls == []


# --------------------------------------------------------------- plans

# the YAMLs' recurrences (H) at the eval batch, the train batch and the
# serving batch
_HIDDEN = sorted({cfg["seq2vec"]["hidden_size"] for cfg, _ in flagship.CONFIGS.values()})
_BATCHES = (1024, 128, 64, 1)


def _glimpse_shapes():
    """(M, G) of each attention arch's glimpse_head, from its YAML's model
    section: MutanAtt's dim_mm, ConcatAtt's, MLBAtt's and MFB's dim_h."""
    shapes = set()
    for cfg, _ in flagship.CONFIGS.values():
        att = cfg.get("attention") or {}
        if "nb_glimpses" in att:
            shapes.add((att.get("dim_mm", att.get("dim_h")), att["nb_glimpses"]))
    return sorted(shapes)


def test_the_yamls_shapes_are_the_expected_ones():
    assert _HIDDEN == [1024, 2400]
    assert _glimpse_shapes() == [(510, 2), (512, 2), (1024, 1), (1200, 2)]


@pytest.mark.parametrize("B", _BATCHES)
@pytest.mark.parametrize("H", _HIDDEN + [42])
def test_lstm_plan_takes_float32(B, H):
    """float32's plan: the bf16 plan's class; wg=2 its tiles (128 rows in
    CTA pairs), wg=1 64-row tiles; as many stages of K = 32 float32 (h's
    tile, wh^T's tf32 halves) as the shared memory a block may opt into
    holds; the products in 3xTF32."""
    plan, bf16 = lstm_plan(B, H, elem=4), lstm_plan(B, H)
    wg = bf16["wg"]
    assert (plan["wg"], plan["cluster"], plan["bm"]) == (wg, wg, 64 * wg)
    assert plan["tiles"] == -(-(-(-B // (64 * wg))) // wg) * wg * -(-H // 64)
    if wg == 2:
        for key in ("tiles", "ctas", "tail_tiles", "tail_split"):
            assert plan[key] == bf16[key]
    assert 1 <= plan["ctas"] <= min(plan["tiles"], lstm.SMS)
    assert plan["hp"] % 8 == 0 and plan["hp"] >= H and plan["hp"] == bf16["hp"]
    assert plan["stages"] == (2 if wg == 2 else 3)
    assert plan["smem_per_stage"] == (plan["bm"] + 2 * 256) * 32 * 4
    assert plan["smem_bytes"] == 1024 + plan["stages"] * plan["smem_per_stage"] + 128
    assert plan["smem_bytes"] <= lstm.SMEM_LIMIT
    assert plan["smem_bytes"] + plan["smem_per_stage"] > lstm.SMEM_LIMIT  # one more does not fit
    assert plan["fixed_scratch_bytes"] == 4 * (2 * B * plan["hp"] + 8 * plan["hp"] ** 2)
    assert "float32" in plan["design"] and "3xTF32" in plan["design"]


def test_lstm_plan_float32_classes():
    """The eval batch at H=2400 takes CTA pairs of 128-row tiles (2.3 waves)
    and a K-shared tail, its sum kept in the tensor cores; H=1024 and the
    train and serving batches 64-row tiles, a stage's sum added in fp32."""
    big = lstm_plan(1024, 2400, elem=4)
    assert (big["wg"], big["tail_split"]) == (2, 3) and "tensor cores" in big["design"]
    for B, H in ((1024, 1024), (128, 1024), (128, 2400), (64, 2400)):
        plan = lstm_plan(B, H, elem=4)
        assert plan["wg"] == 1 and "fp32 registers" in plan["design"]
    with pytest.raises(ValueError, match="4-byte"):
        lstm_plan(64, 2400, elem=8)
    with pytest.raises(ValueError, match="H must be even"):
        lstm_plan(64, 41, elem=4)


@pytest.mark.parametrize("B", _BATCHES)
@pytest.mark.parametrize("R", [36, 196])
@pytest.mark.parametrize("M,G", _glimpse_shapes() + [(0, 2), (510, 8)])
def test_glimpse_plan_takes_float32(B, R, M, G):
    """glimpse_head at each arch's (M, G) and glimpse_attend (M=0: MFB's
    question attention, and the 196-region grid) in float32: the float32
    design, w in shared memory beside alpha."""
    plan = glimpse_plan(B, R, M, G, 2048 if M else 1024, elem=4)
    assert plan["copy"] == "f32" and plan["ctas"] == B
    assert plan["staged"] == (M > 0)
    assert plan["smem_bytes"] == R * G * 4 + M * G * 4 <= attention.SMEM_LIMIT


def test_glimpse_plan_float32_refuses_only_past_shared_memory():
    """w past shared memory is read from L2; alpha [R, G] past it takes the
    split design (R=30,000 with G=2: the regions in chunks merged by their
    log-sum-exp, at least the two that fit and here the 33 that fill 264
    blocks at B=8); only a limit below one region of one glimpse group, or
    another element size, refuses."""
    assert not glimpse_plan(8, 196, 80_000, 2, 2048, elem=4)["staged"]  # w read from L2
    split = glimpse_plan(8, 30_000, 0, 2, 1024, elem=4)
    assert (split["copy"], split["groups"], split["chunks"], split["chunk"]) == \
        ("split", 2, 33, 910)
    assert split["smem_bytes"] == 910 * 2 * 4 <= attention.SMEM_LIMIT
    assert split["scratch_bytes"] == 8 * 2 * 33 * (1024 + 2) * 4
    assert glimpse_plan(1024, 30_000, 0, 2, 1024, elem=4)["chunks"] == 2
    with pytest.raises(ValueError, match="shared memory"):
        glimpse_plan(8, 30_000, 0, 2, 1024, elem=4, smem_limit=4)
    with pytest.raises(ValueError, match="4-byte"):
        glimpse_plan(8, 36, 510, 2, 2048, elem=8)


@pytest.mark.parametrize("B", _BATCHES)
@pytest.mark.parametrize("N", [36, 48, 64, 196])
def test_relation_plan_takes_float32(B, N):
    """CoR's relation core (D=1024) in float32: the tiled design (3xTF32 on
    the tensor cores), one CTA an element and 64 rows, the most stages of
    128-byte rows that fit beside the region (two buffers of the lo half of
    a stage's pg box and s in fp32 with rows of 4 Np + 16 bytes; then
    alpha's halves, 8 KB a 32-column block each)."""
    plan = relation_plan(B, N, 1024, elem=4)
    assert plan["design"] == "tiled" and plan["split"] == 1
    r_rows = -(-N // 8) * 8  # one box: N <= 256
    stage = 64 * 128 + r_rows * 128
    lo = 2 * 64 * 128
    s = 64 * (4 * -(-N // 16) * 16 + 16)
    region = max(lo + s, 2 * -(-(-(-N // 16) * 16) // 32) * 8192)
    stages = max(st for st in range(1, 5)
                 if 1024 + st * stage + region + 16 * st <= relation.SMEM_LIMIT)
    assert plan["stages"] == stages == (3 if N == 196 else 4)
    assert plan["smem_bytes"] == 1024 + stages * stage + region + 16 * stages
    assert plan["ctas"] == B * -(-N // 64) and plan["threads"] == 544
    with pytest.raises(ValueError, match="no 'element' design"):
        relation_plan(B, N, 1024, elem=4, design="element")
    wide = relation_plan(B, N, 1024, elem=4, design="wide")  # forced, as a probe
    assert (wide["design"], wide["stages"], wide["threads"]) == ("wide", 1, 256)
    assert wide["smem_bytes"] == 16 * 1024 * 4 + N * 16 * 4


@pytest.mark.parametrize("N,stages,design", [(200, 3, "tiled"), (256, 2, "tiled"),
                                             (257, 1, "wide"), (300, 1, "wide"),
                                             (784, 1, "wide")])
def test_relation_plan_float32_takes_the_wide_design_past_n_256(N, stages, design):
    """The tiled design keeps the most stages that fit, up to N = 256 (its
    softmax keeps a row in registers); past it float32 takes the tc design
    by default (tests/test_torch_relation_tc.py) and the wide design where
    forced, FP32 FMA, whose 16 rows of pg and 16 x N scores fit, and the
    split design where those scores do not (here a limit with room for
    half of them: r's rows in two or three chunks); a forced tiled design
    there, or a limit below the split design's 16 rows of pg and one row's
    scores, is refused."""
    plan = relation_plan(8, N, 1024, elem=4, design="wide" if design == "wide" else None)
    assert (plan["design"], plan["stages"]) == (design, stages)
    assert plan["smem_bytes"] <= relation.SMEM_LIMIT
    if design == "wide":
        assert plan["smem_bytes"] == 16 * 1024 * 4 + N * 16 * 4 and plan["threads"] == 256
        with pytest.raises(ValueError, match="takes N <= 256"):
            relation_plan(8, N, 1024, elem=4, design="tiled")
        limit = 16 * 1024 * 4 + (N // 2) * 16 * 4
        split = relation_plan(8, N, 1024, elem=4, smem_limit=limit)
        assert (split["design"], split["chunks"]) == ("split", -(-N // (N // 2)))
        assert split["smem_bytes"] <= limit
    with pytest.raises(ValueError, match="shared memory"):
        relation_plan(8, N, 1024, elem=4, smem_limit=60_000)


# ------------------------------------------ the float32 path through the
# CUDA dispatch, with the plain versions standing in for the kernels


def _view(ptr: int, shape) -> torch.Tensor:
    """The float32 CPU memory at ``ptr`` as a tensor of ``shape``."""
    n = int(np.prod(shape))
    return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))
                            ).view(*shape)


class _PlainLibrary:
    """The float32 entries, each computing its plain version into the
    memory the wrapper hands it, at the shapes and strides it passes."""

    def __init__(self):
        self.calls = []

    def vqa_lstm_seq_f32(self, xg, mask, wh, h_last, seq, hbuf, c, count, T, B, H, gs, stream):
        self.calls.append("lstm_seq")
        w = _view(wh, (H, 4, gs))[..., :H].reshape(H, 4 * H)
        h, s = lstm_seq_reference(_view(xg, (T, B, 4 * H)), _view(mask, (T, B, 1)), w)
        _view(h_last, (B, H)).copy_(h)
        _view(seq, (T, B, H)).copy_(s)
        return 0

    def vqa_glimpse_head_f32(self, joint, w, bias, v, out, logits, B, R, M, G, D, staged,
                             stream):
        self.calls.append("glimpse_head")
        att, lg = glimpse_head_reference(_view(joint, (B, R, M)), _view(w, (M, G)),
                                         _view(bias, (G,)), _view(v, (B, R, D)))
        _view(out, (B, G, D)).copy_(att)
        _view(logits, (B, R, G)).copy_(lg)
        return 0

    def vqa_glimpse_attend_f32(self, logits, v, out, B, R, G, D, stream):
        self.calls.append("glimpse_attend")
        _view(out, (B, G, D)).copy_(glimpse_attend_reference(_view(logits, (B, R, G)),
                                                             _view(v, (B, R, D))))
        return 0

    def vqa_mfb_pool_f32(self, z, out, n, k, m, stream):
        self.calls.append("mfb_pool")
        _view(out, (n, m)).copy_(mfb_pool.mfb_pool_reference(_view(z, (n, k * m)), k))
        return 0

    def vqa_relation_attend_f32(self, pg, r, out, B, N, D, design, stages, stream):
        self.calls.append("relation_attend")
        _view(out, (B, N, D)).copy_(relation_attend_reference(_view(pg, (B, N, D)),
                                                              _view(r, (B, N, D))))
        return 0


@pytest.fixture
def card_dispatch(monkeypatch):
    """Every registered op's call routed to its CUDA implementation (as a
    CUDA tensor is dispatched), over the plain library."""
    lib = _PlainLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "smem_optin", lambda index: attention.SMEM_LIMIT)
    monkeypatch.setattr(_build, "current_stream", lambda device: 0)
    monkeypatch.setattr(lstm, "launch_geometry_f32", _no_f32_scratch)
    for module, handle, impl in ((lstm, "_LSTM_SEQ_OP", lstm._lstm_seq_cuda),
                                 (attention, "_GLIMPSE_HEAD_OP", attention._glimpse_head_cuda),
                                 (attention, "_GLIMPSE_ATTEND_OP",
                                  attention._glimpse_attend_cuda),
                                 (mfb_pool, "_MFB_POOL_OP", mfb_pool._mfb_pool_cuda),
                                 (relation, "_RELATION_ATTEND_OP",
                                  relation._relation_attend_cuda)):
        monkeypatch.setattr(module, handle, impl)
    return lib


@pytest.mark.parametrize("op", sorted(_CUDA_IMPLS))
def test_card_dispatch_with_plain_entries_matches_the_plain_versions(card_dispatch, op):
    """The stand-in library is right: through it each public wrapper gives
    its plain version's values (odd H through pad_odd_hidden and gate
    strips padded to 8)."""
    if op == "lstm_seq":
        xg, wh = torch.randn(4, 6, 4 * 41), torch.randn(41, 4 * 41) / 41 ** 0.5
        mask = (torch.rand(4, 6, 1) > 0.3).float()
        for got, want in zip(lstm_seq(xg, mask, wh), lstm_seq_reference(xg, mask, wh)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        args, kw = _operands(op, torch.float32)
        fn = {"glimpse_head": (glimpse_head, glimpse_head_reference),
              "glimpse_attend": (glimpse_attend, glimpse_attend_reference),
              "mfb_pool": (mfb_pool.mfb_pool, mfb_pool.mfb_pool_reference),
              "relation_attend": (relation_attend, relation_attend_reference)}[op]
        got, want = fn[0](*args, *kw.values()), fn[1](*args, *kw.values())
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert card_dispatch.calls == [op]


def test_float32_mutan_att_train_step_through_the_card_dispatch_matches_jax(card_dispatch):
    """One adam step of the tiny MutanAtt in float32 (dropout off), every
    kernel call through its CUDA implementation: metrics and parameters
    against JAX make_train_step as tests/test_torch_train.py holds the CPU
    dispatch, with lstm_seq and glimpse_head reached through their float32
    entries (the backwards are plain, on the CPU)."""
    import test_torch_train

    test_torch_train._run_both("mutan_att", dict(optimizer="adam", lr=1e-3), 1)
    assert set(card_dispatch.calls) == {"lstm_seq", "glimpse_head"}


# ------------------------------------------------------- on the card only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(5, 37, 40), (4, 37, 42), (5, 37, 41), (7, 130, 96),
                                   (7, 64, 1024), (26, 64, 1024), (26, 1024, 2400)])
def test_lstm_seq_float32_kernel_matches_plain(cuda_device, T, B, H):
    """float32 kernel vs the plain version in float32 (TF32 off): within
    1e-4 of the max-abs, one launch, two calls bit-equal."""
    g = torch.Generator(device=cuda_device).manual_seed(T * B + H)
    xg = torch.randn(T, B, 4 * H, device=cuda_device, generator=g)
    wh = torch.randn(H, 4 * H, device=cuda_device, generator=g) / H ** 0.5
    mask = (torch.rand(T, B, 1, device=cuda_device, generator=g) > 0.2).float()
    before = lstm_seq.launches
    h, seq = lstm_seq(xg, mask, wh)
    again = lstm_seq(xg, mask, wh)
    ref_h, ref_seq = lstm_seq_reference(xg, mask, wh)
    torch.cuda.synchronize()
    assert lstm_seq.launches == before + 2
    assert h.dtype == seq.dtype == torch.float32
    assert _rel(h, ref_h) <= F32_LSTM_REL and _rel(seq, ref_seq) <= F32_LSTM_REL
    assert torch.equal(h, again[0]) and torch.equal(seq, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,M,G,D", [(1024, 36, 510, 2, 2048), (64, 36, 1200, 2, 2048),
                                       (8, 196, 510, 2, 2048), (16, 36, 510, 8, 2048),
                                       (5, 7, 33, 3, 75)])
def test_glimpse_head_float32_kernel_matches_plain(cuda_device, B, R, M, G, D):
    joint = torch.tanh(torch.randn(B, R, M, device=cuda_device))
    w = torch.randn(M, G, device=cuda_device) / M ** 0.5
    b = torch.randn(G, device=cuda_device)
    v = torch.randn(B, R, D, device=cuda_device)
    before = glimpse_head.launches
    att, logits = glimpse_head(joint, w, b, v)
    ref_att, ref_logits = glimpse_head_reference(joint, w, b, v)
    torch.cuda.synchronize()
    assert glimpse_head.launches == before + 1
    assert _rel(att, ref_att) <= F32_REL and _rel(logits, ref_logits) <= F32_REL


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,G,D", [(1024, 26, 2, 1024), (8, 196, 2, 1024), (5, 9, 3, 75)])
def test_glimpse_attend_float32_kernel_matches_plain(cuda_device, B, R, G, D):
    """Masked at finfo(float32).min past each row's length, row 0 whole."""
    logits = torch.randn(B, R, G, device=cuda_device)
    keep = torch.rand(B, R, 1, device=cuda_device) > 0.3
    keep[0] = False
    logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    v = torch.randn(B, R, D, device=cuda_device)
    got = glimpse_attend(logits, v)
    torch.cuda.synchronize()
    assert _rel(got, glimpse_attend_reference(logits, v)) <= F32_REL
    torch.testing.assert_close(got[0], v[0].mean(0).expand(G, D), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(36864, 5, 1000), (131, 3, 33), (37, 5, 1001)])
def test_mfb_pool_float32_kernel_matches_plain(cuda_device, n, k, m):
    """The signed square root is ill-conditioned near 0: a pooled value of
    ~1e-7 from terms of ~1 moves by its whole self when the k terms are
    summed in another order, and its root by ~3e-4. So the kernel is held
    against the plain version in float64: within 1e-5 of the max-abs, or
    no further than twice the plain float32 version's own error, where that
    is larger (MFB_F32 in chip_smoke.py)."""
    z = torch.randn(n, k * m, device=cuda_device)
    got = mfb_pool.mfb_pool(z, k)
    exact = mfb_pool.mfb_pool_reference(z.double(), k)
    plain = mfb_pool.mfb_pool_reference(z, k)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _rel(got.double(), exact) <= max(F32_REL, 2 * _rel(plain.double(), exact))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D", [(1024, 36, 1024), (64, 64, 1024), (64, 196, 1024), (5, 7, 33),
                                   (3, 65, 40), (2, 256, 64), (2, 600, 64)])
def test_relation_attend_float32_kernel_matches_plain(cuda_device, B, N, D):
    """Within 1e-5 of the plain output's max-abs, two calls bit-equal (N=256:
    the tiled design's largest; N=600: the tc one)."""
    pg = torch.tanh(torch.randn(B, N, D, device=cuda_device))
    r = torch.tanh(torch.randn(B, N, D, device=cuda_device))
    got = relation_attend(pg, r)
    again = relation_attend(pg, r)
    torch.cuda.synchronize()
    assert _rel(got, relation_attend_reference(pg, r)) <= F32_REL
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_gather_rows_float32_rows_are_bit_exact(cuda_device):
    table = torch.randn(64, 36, 2048, device=cuda_device)
    rows = [5, 0, 63, 5, 17]
    assert torch.equal(gather_rows(table, rows), table[torch.tensor(rows, device=cuda_device)])


@pytest.mark.cuda
def test_lstm_plan_float32_matches_the_card(cuda_device):
    """lstm_plan(..., elem=4) reckons the schedule in Python; the kernel
    reckons it in C++ from the card's occupancy. On a card with 132 SMs
    they agree on the CTAs, the tiles, the tail and the shared memory."""
    if torch.cuda.get_device_properties(cuda_device).multi_processor_count != lstm.SMS:
        pytest.skip(f"lstm_plan reckons with the {lstm.SMS} SMs of an H100 SXM")
    for B, H in ((1024, 2400), (1024, 1024), (64, 2400), (37, 42)):
        geometry = lstm.launch_geometry_f32(B, H, cuda_device.index or 0)
        plan = lstm_plan(B, H, elem=4)
        keys = ("ctas", "tiles", "smem_bytes", "cluster", "stages", "tail_split", "tail_tiles")
        assert {k: geometry[k] for k in keys} == {k: plan[k] for k in keys}
        assert geometry["scratch_bytes"] >= plan["fixed_scratch_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,vec,design", [(1024, 36, 1024, True, None),
                                              (1024, 196, 1024, True, None),
                                              (1024, 196, 1024, True, "wide"),
                                              (5, 7, 33, False, None), (8, 300, 64, True, None),
                                              (8, 784, 1024, True, None)])
def test_relation_plan_float32_matches_the_card(cuda_device, B, N, D, vec, design):
    """relation_plan(..., elem=4) reckons the launch in Python; the float32
    entry reckons it in C++: they agree on the CTAs, the cluster, the
    threads and the shared memory."""
    plan = relation_plan(B, N, D, vec=vec, smem_limit=_build.smem_optin(cuda_device.index or 0),
                         design=design, elem=4)
    geometry = relation.launch_geometry(B, N, D, plan, vec, cuda_device.index or 0, elem=4)
    want = {k: plan[k] for k in ("ctas", "cluster", "threads", "smem_bytes")}
    if plan["design"] == "tc":  # and its second launch, the weighted sum
        want["weighted"] = plan["weighted"]
    assert geometry == want
