"""Frozen serving artifacts via ``torch.export``, the port of
``vqa_tpu/export.py``.

A trained run is frozen into a self-contained directory

    <out>/
      program.pt2   ``torch.export`` program of the model's eval forward
                    (visual, question, lengths) at a fixed serving shape,
                    with the weights inside it (baked) or as its first input
                    (external)
      params.npz    external mode only: the weights, '/'-keyed float32 (the
                    JAX package's layout; ``serve --params`` reads it too)
      meta.json     question vocab, answer vocab, shapes, tokenizer flavor,
                    feature-table coordinates, the device it was traced on,
                    provenance

The program keeps the model's five forward kernels as the registered ops
``torch.ops.vqa_tpu_torch.*`` (``vqa_tpu_torch/ops``), so on the card a
loaded program launches the hand-written kernels (and counts the launches)
and on the host runs their plain versions. It is saved with its tensors
and device arguments on the host (``torch.export.passes.
move_to_device_pass``) and moved at load time to the device asked for, so
a program traced on the card serves on a CPU host and one traced on the
host serves on the card, as the JAX program lowers for CPU and TPU alike;
``meta.json``'s ``device`` records where it was traced. The program
computes in the run's ``engine.dtype`` (``config.compute_dtype``, recorded
as ``compute_dtype``): float32 or bf16, on either device, since every
kernel has an entry for each.

Loading imports no model code: ``load_export`` and ``ExportedPredictor``
import ``torch``, the op registrations (needed before ``torch.export.load``
can resolve the graph's ops), the tokenizer, the question encoder, the
answer decoder and the feature store, never ``vqa_tpu_torch.models``.
Features still come from a FeatureStore (weights travel with the program,
image features do not).
"""

from __future__ import annotations

import json
import os
import types
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vqa_tpu_torch import config

PROGRAM_FILE = "program.pt2"
META_FILE = "meta.json"
PARAMS_FILE = "params.npz"
FORMAT = "vqa_tpu_torch.export/1"
JAX_PROGRAM_FILE = "program.jaxexport"  # the JAX package's artifact
VISUAL_DTYPE = "float32"  # the program's visual input; the model casts it once inside


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# The port's weights are one flat '/'-keyed mapping (the flax names; see
# weights.py), which the program and the npz take as they are: the JAX
# package's _flatten_params / _unflatten_params of nested trees have no
# counterpart here.


def _cast_floating(params: Mapping[str, torch.Tensor], dtype: torch.dtype):
    return {k: p.to(dtype) if p.is_floating_point() else p for k, p in params.items()}


def _is_quantized(v) -> bool:
    return isinstance(v, Mapping) and set(v) == {"q", "scale", "dtype"}


def quantize_int8(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Weight-only int8 quantization, per-last-dim (output-channel) scales,
    as ``vqa_tpu/export.py::quantize_int8``, over flat weights.

    Floating tensors with ndim >= 2 become ``{"q": int8 values, "scale":
    float32 scales, "dtype": the original dtype's name}``; biases and
    scalars stay as they are. Symmetric: w ~ q * scale, scale = max|w| / 127
    over every axis but the last (Dense kernels are [in, out], the embedding
    table [vocab, E]: one scale a column), a zero scale set to 1, rounded
    half to even, clipped at +-127, computed in the weight's own dtype."""

    def q(p):
        if not p.is_floating_point() or p.ndim < 2:
            return p
        axis = tuple(range(p.ndim - 1))
        scale = p.abs().amax(dim=axis, keepdim=True) / 127.0
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        qv = torch.round(p / scale).clamp(-127, 127).to(torch.int8)
        return {"q": qv, "scale": scale.to(torch.float32), "dtype": _dtype_name(p.dtype)}

    return {k: q(p) for k, p in params.items()}


def _dequantize(v) -> torch.Tensor:
    return (v["q"].to(torch.float32) * v["scale"]).to(getattr(torch, v["dtype"]))


def dequantize_int8(qparams: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_int8`: int8 values times their float32
    scales, cast back to the original dtype (runs inside the exported
    program)."""
    return {k: _dequantize(v) if _is_quantized(v) else v for k, v in qparams.items()}


def _forward_at(model: nn.Module, flat: Mapping[str, torch.Tensor], visual, question, lengths):
    """The model's eval forward with its parameters replaced by ``flat``
    ('/'-keyed, the flax names)."""
    params = {k.replace("/", "."): v for k, v in flat.items()}
    return torch.func.functional_call(model, params, (visual, question, lengths))


class _Baked(nn.Module):
    """The forward with the weights as the program's own buffers (int8
    values and scales where quantized, dequantized inside the forward). The
    model is held outside the module tree, so that its own parameters do
    not travel too."""

    def __init__(self, model: nn.Module, flat: Mapping[str, Any]):
        super().__init__()
        self.__dict__["_model"] = model
        self._plain, self._quant = {}, {}
        for i, (key, v) in enumerate(flat.items()):
            if _is_quantized(v):
                self.register_buffer(f"q{i}", v["q"])
                self.register_buffer(f"scale{i}", v["scale"])
                self._quant[key] = (f"q{i}", f"scale{i}", v["dtype"])
            else:
                self.register_buffer(f"w{i}", v)
                self._plain[key] = f"w{i}"

    def forward(self, visual, question, lengths):
        flat = {k: getattr(self, name) for k, name in self._plain.items()}
        for k, (q, scale, dtype) in self._quant.items():
            flat[k] = _dequantize({"q": getattr(self, q), "scale": getattr(self, scale),
                                   "dtype": dtype})
        return _forward_at(self._model, flat, visual, question, lengths)


class _External(nn.Module):
    """The weight-free forward: the weights are its first input."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.__dict__["_model"] = model

    def forward(self, params, visual, question, lengths):
        return _forward_at(self._model, params, visual, question, lengths)


def model_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters, '/'-keyed (the flax names), as they are."""
    return {name.replace(".", "/"): p.detach() for name, p in model.named_parameters()}


def export_forward(
    model: nn.Module,
    params: Mapping[str, Any],
    *,
    batch: int,
    seq: int,
    feature_shape: Sequence[int],
    device,
    params_mode: str = "baked",
):
    """``torch.export`` of the model's eval forward at a fixed serving shape
    on ``device``, traced with fake tensors under ``torch.no_grad()`` (so
    the kernel wrappers call their registered ops, not the train path's
    autograd Functions).

    ``params`` is the flat '/'-keyed weights (or ``quantize_int8``'s
    output: baked only). ``params_mode='baked'`` puts them inside the
    program; ``'external'`` exports ``fn(params, visual, question,
    lengths)`` instead, weight-free, for a sidecar npz."""
    device = torch.device(device)
    args = (
        torch.zeros((batch, *tuple(feature_shape)), dtype=getattr(torch, VISUAL_DTYPE),
                    device=device),
        torch.ones((batch, seq), dtype=torch.int32, device=device),
        torch.full((batch,), seq, dtype=torch.int32, device=device),
    )
    model = model.eval()
    if params_mode != "baked" and any(_is_quantized(v) for v in params.values()):
        raise ValueError("int8 quantization requires params_mode='baked'")
    if params_mode == "baked":
        module = _Baked(model, params)
    elif params_mode == "external":
        module, args = _External(model), (params, *args)
    else:
        raise ValueError(f"params_mode must be 'baked' or 'external', got {params_mode!r}")
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
    # the tracing inputs would be saved with the program (external mode: the
    # weights again); the program needs only their shapes, which it keeps
    program.example_inputs = None
    return program


def program_ops(program) -> List[str]:
    """The registered ops of this package that a program's graph calls, in
    graph order (``vqa_tpu_torch::lstm_seq``, ...)."""
    from vqa_tpu_torch.ops import NAMESPACE

    return [node.target.name() for node in program.graph.nodes
            if node.op == "call_function" and getattr(node.target, "namespace", None) == NAMESPACE]


def write_program(program, out_dir: str) -> None:
    """Save ``program`` as ``<out_dir>/program.pt2`` with its weights,
    constants and device arguments moved to the host, so that a machine
    without the device it was traced on can load it (``torch.export.load``
    places each tensor on its recorded device); ``ExportedPredictor`` moves
    it to the device it serves on. Moves ``program`` itself."""
    from torch.export.passes import move_to_device_pass

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(move_to_device_pass(program, "cpu"), os.path.join(out_dir, PROGRAM_FILE))


def save_export(
    out_dir: str,
    predictor,
    batch: int = 64,
    weights_dtype: Optional[str] = None,
    params_mode: str = "baked",
) -> Dict[str, Any]:
    """Freeze a :class:`~vqa_tpu_torch.predictor.Predictor` (from
    ``Predictor.from_run``: it carries the run's options) into ``out_dir``,
    traced on the predictor's device.

    ``weights_dtype='bfloat16'`` or ``'float32'`` casts the weights (the
    model still computes in its own dtype, the config's ``engine.dtype`` on
    either device); ``None`` keeps them as they are.
    ``'int8'`` (baked only) applies :func:`quantize_int8`, dequantized
    inside the program. ``params_mode='external'`` keeps the program
    weight-free and writes the weights to ``params.npz`` (float32: npz has
    no portable bf16, and the f32 round trip of a bf16 value is exact; the
    loader casts them back).

    Returns the meta dict (also written to ``meta.json``)."""
    quantized = weights_dtype == "int8"
    if quantized and params_mode != "baked":
        # fail before quantizing a (possibly large) tree
        raise ValueError("int8 quantization requires params_mode='baked'")
    opt = predictor.opt
    if opt is None:
        raise ValueError("save_export needs a Predictor from Predictor.from_run (its options)")
    feature_shape = list(predictor.table.shape[1:])
    params = model_params(predictor.model)
    compute_dtype = _dtype_name(config.compute_dtype(opt))
    held = _dtype_name(next(iter(params.values())).dtype)
    if held != compute_dtype:
        raise ValueError(f"the predictor's model holds {held} weights, and its options' "
                         f"engine.dtype computes in {compute_dtype}: build it with "
                         f"Predictor.from_run")
    if quantized:
        params = quantize_int8(params)
    elif weights_dtype is not None:
        params = _cast_floating(params, getattr(torch, weights_dtype))
    program = export_forward(
        predictor.model, params, batch=batch, seq=opt.vqa.maxlength,
        feature_shape=feature_shape, device=predictor.device, params_mode=params_mode,
    )
    meta = {
        "format": FORMAT,
        "batch": batch,
        "maxlength": opt.vqa.maxlength,
        "pad": opt.vqa.pad,
        "nlp": opt.vqa.nlp,
        "feature_shape": feature_shape,
        "visual_dtype": VISUAL_DTYPE,
        "num_answers": predictor.dataset.num_answers,
        "aid_to_ans": list(predictor.dataset.aid_to_ans),
        "word_to_wid": dict(predictor.dataset.word_to_wid),
        "model_arch": opt.model.arch,
        "engine_dtype": opt.engine.dtype,
        "compute_dtype": compute_dtype,
        "weights_dtype": weights_dtype or "unchanged",
        "params": params_mode,
        "coco": {"dir": opt.coco.dir, "arch": opt.coco.arch, "mode": opt.coco.mode},
        "device": predictor.device.type,
        "ops": program_ops(program),
        "torch_version": torch.__version__,
    }
    if params_mode == "external":
        meta["params_dtype"] = _dtype_name(
            next(v for v in params.values() if v.is_floating_point()).dtype)
    write_program(program, out_dir)
    if params_mode == "external":
        np.savez(os.path.join(out_dir, PARAMS_FILE),
                 **{k: v.detach().to("cpu", torch.float32 if v.is_floating_point() else v.dtype)
                    .numpy() for k, v in params.items()})
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f)
    return meta


class _ServingDataset:
    """Duck-typed stand-in for the dataset attributes the serving layer uses
    (AnswerService and cli.serve touch ``.num_answers``, ``.vocabs``,
    ``.features`` and ``.split.image_names`` only)."""

    def __init__(self, features, aid_to_ans, word_to_wid):
        self.features = features
        self.num_answers = len(aid_to_ans)
        self.vocabs = types.SimpleNamespace(
            aid_to_ans=list(aid_to_ans), word_to_wid=dict(word_to_wid)
        )
        self.split = types.SimpleNamespace(image_names=features.names)


def _check_loadable(export_dir: str, meta: dict, device) -> torch.device:
    """The device the artifact will run on: ``device``, else the one it was
    traced on. Refuses a JAX artifact and the card on a machine without one;
    a program in float32 or bf16 runs on either device."""
    if meta.get("format") != FORMAT:
        jax = os.path.exists(os.path.join(export_dir, JAX_PROGRAM_FILE))
        raise ValueError(
            f"{export_dir} holds format {meta.get('format')!r}"
            + (f" ({JAX_PROGRAM_FILE}, the JAX package's artifact)" if jax else "")
            + f"; vqa_tpu_torch loads {FORMAT} ({PROGRAM_FILE}): export the run with "
            "python -m vqa_tpu_torch.cli.export")
    traced = torch.device(meta["device"])
    want = traced if device is None else torch.device(device)
    if want.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"{export_dir} (traced on {traced.type}) cannot run on cuda: this "
                         "machine has no CUDA card; load it with device='cpu'")
    return want


class ExportedPredictor:
    """Predictor-compatible inference over a saved export (no model code).

    Mirrors the Predictor's serving surface (``answer_batch`` / ``answer`` /
    ``encode_questions`` / ``.dataset``), so ``cli.serve.AnswerService``
    works unchanged on top. The forward runs the loaded fixed-shape program
    on ``device`` (default: the one it was traced on); arbitrary request
    sizes are padded and chunked to the exported batch.
    """

    def __init__(self, export_dir: str, features=None, meta: Optional[dict] = None,
                 device=None):
        import vqa_tpu_torch.ops.attention  # noqa: F401  the ops the program calls
        import vqa_tpu_torch.ops.lstm  # noqa: F401
        import vqa_tpu_torch.ops.mfb_pool  # noqa: F401
        import vqa_tpu_torch.ops.relation  # noqa: F401

        self.meta = _read_meta(export_dir) if meta is None else meta
        self.device = _check_loadable(export_dir, self.meta, device)
        from torch.export.passes import move_to_device_pass

        self.program = move_to_device_pass(
            torch.export.load(os.path.join(export_dir, PROGRAM_FILE)), self.device)
        self._call = self.program.module()
        self._params = None
        if self.meta.get("params", "baked") == "external":
            dtype = getattr(torch, self.meta["params_dtype"])
            with np.load(os.path.join(export_dir, PARAMS_FILE)) as flat:
                params = {k: torch.from_numpy(flat[k]) for k in flat.files}
            # float32 on disk; the f32 round trip of a bf16 value is exact
            self._params = {k: v.to(self.device, dtype if v.is_floating_point() else v.dtype)
                            for k, v in params.items()}
        self.batch = int(self.meta["batch"])
        self.dataset = (
            _ServingDataset(features, self.meta["aid_to_ans"], self.meta["word_to_wid"])
            if features is not None else None
        )
        self._tok = None

    # -- question encoding (vocab travels in meta.json) ----------------------
    def encode_questions(self, questions: Sequence[str]):
        from vqa_tpu_torch.datasets.processed import encode_question_batch
        from vqa_tpu_torch.datasets.tokenizer import get_tokenizer

        if self._tok is None:
            self._tok = get_tokenizer(self.meta["nlp"])
        rows, lengths = encode_question_batch(
            questions, self._tok, self.meta["word_to_wid"],
            self.meta["maxlength"], self.meta["pad"],
        )
        return torch.from_numpy(rows), torch.from_numpy(lengths)

    # -- fixed-shape forward --------------------------------------------------
    def logits(self, visual, question, lengths) -> np.ndarray:
        """Forward n <= exported-batch rows (pads to the frozen shape)."""
        n = question.shape[0]
        if n == 0:
            raise ValueError("no rows to run (empty batch)")
        if n > self.batch:
            raise ValueError(f"{n} rows > exported batch {self.batch}; chunk first")
        visual, question, lengths = (torch.as_tensor(x) for x in (visual, question, lengths))
        pad = self.batch - n
        if pad:
            visual = torch.cat([visual, visual[-1:].expand(pad, *visual.shape[1:])])
            question = torch.cat([question, question[-1:].expand(pad, -1)])
            lengths = torch.cat([lengths, lengths[-1:].expand(pad)])
        args = (visual.to(self.device, getattr(torch, VISUAL_DTYPE)),
                question.to(self.device, torch.int32), lengths.to(self.device, torch.int32))
        with torch.inference_mode():
            out = self._call(self._params, *args) if self._params is not None \
                else self._call(*args)
        return out[:n].float().cpu().numpy()

    # -- Predictor-compatible serving surface ---------------------------------
    def answer_batch(
        self, questions: Sequence[str], image_names: Sequence[str], topk: int = 5
    ) -> List[List[Tuple[str, float]]]:
        from vqa_tpu_torch.utils.decode import topk_answers

        if self.dataset is None:
            raise ValueError("ExportedPredictor was loaded without a feature store")
        out: List[List[Tuple[str, float]]] = []
        for start in range(0, len(questions), self.batch):
            qs = list(questions[start : start + self.batch])
            ims = list(image_names[start : start + self.batch])
            visual = self.dataset.features.get(self.dataset.features.index_of(ims))
            q, lengths = self.encode_questions(qs)
            logits = self.logits(visual, q, lengths)
            out.extend(topk_answers(torch.from_numpy(logits),
                                    self.dataset.vocabs.aid_to_ans, topk))
        return out

    def answer(self, question: str, image_name: str, topk: int = 5):
        return self.answer_batch([question], [image_name], topk)[0]


def _read_meta(export_dir: str) -> dict:
    path = os.path.join(export_dir, META_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found: not an export directory")
    with open(path) as f:
        return json.load(f)


def load_export(
    export_dir: str,
    features=None,
    coco_dir: Optional[str] = None,
    device=None,
) -> ExportedPredictor:
    """Load an export onto ``device`` (default: the device it was traced
    on; a card-traced program loads on the host, and a host-traced one on
    the card, in float32 or bf16). ``features`` may be a ready FeatureStore
    (``FeatureStore.in_memory`` where there is no h5py); otherwise the
    meta's feature-table coordinates are used (``coco_dir`` overrides the
    recorded directory: the table rarely lives at the training-time path on
    a serving host)."""
    meta = _read_meta(export_dir)
    _check_loadable(export_dir, meta, device)
    if features is None:
        from vqa_tpu_torch.datasets.features import FeatureStore

        coco = meta["coco"]
        features = FeatureStore(coco_dir or coco["dir"], coco["arch"], coco["mode"])
    return ExportedPredictor(export_dir, features=features, meta=meta, device=device)
