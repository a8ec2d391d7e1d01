"""Eval step, the port of ``vqa_tpu/engine/steps.py`` (make_eval_step and
_resolve_visual). The train step is not ported yet (ROADMAP.md queue 1,
item 5).

With a feature table resident on the device, a batch carries ``image_index``
instead of ``visual`` and the step gathers the region tensors itself
(``ops.gather.gather_rows``, the hand-written kernel on the card), so the
host ships token ids and indices, not 36x2048 features. ``image_index``
stays on the host: the gather checks its range there before the launch.

The table may be an int8 ``(values, scales)`` pair from
``quantize_features`` (the JAX package's ``engine.features_dtype=int8``,
which halves the table's bytes and the gather's reads); its rows are
gathered and dequantized by one kernel (``ops.gather.gather_rows_dequant``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vqa_tpu_torch.ops.gather import gather_rows, gather_rows_dequant


def _topk_acc(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    topk = torch.topk(logits, k, dim=-1).indices              # [B, k]
    return (topk == labels[:, None]).any(dim=-1)


def quantize_features(table):
    """Per-row symmetric int8 quantization of a feature table [N, ..., D]:
    returns (values int8, scales float32 [N, ..., 1]). A copy of
    ``vqa_tpu/engine/steps.py::quantize_features`` (the port imports nothing
    of ``vqa_tpu``), held byte-equal to it in the tests. Place the scales on
    the card in the compute dtype (bf16), as ``vqa_tpu/cli/train.py`` does."""
    absmax = np.abs(table).max(axis=-1, keepdims=True)
    scales = (absmax / 127.0 + 1e-12).astype(np.float32)
    values = np.clip(np.round(table / scales), -127, 127).astype(np.int8)
    return values, scales


def _resolve_visual(batch: Dict[str, torch.Tensor], features) -> torch.Tensor:
    if "visual" in batch:
        return batch["visual"]
    if features is None:
        raise ValueError("batch has image_index but no feature table was passed")
    if isinstance(features, (tuple, list)):
        # int8 rows dequantized after the gather, in the scales' dtype
        values, scales = features
        return gather_rows_dequant(values, scales, batch["image_index"])
    return gather_rows(features, batch["image_index"])


def make_eval_step():
    """Returns (model, batch, features=None) -> per-batch eval outputs.

    Output dict: ``pred`` [B] int32 answer ids, plus sums under ``valid``
    (``n``, and with ``answer`` in the batch ``n_labeled``, ``correct1``,
    ``correct5``), so partial batches aggregate exactly.
    """

    @torch.inference_mode()
    def eval_step(model, batch: Dict[str, torch.Tensor], features=None):
        logits = model(_resolve_visual(batch, features), batch["question"], batch.get("length"))
        pred = logits.argmax(dim=-1).to(torch.int32)
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(pred.shape[0], dtype=torch.bool, device=pred.device)
        out = {"pred": pred, "n": valid.sum()}
        if "answer" in batch:
            answer = batch["answer"]
            labeled = valid & (answer >= 0)
            out["n_labeled"] = labeled.sum()
            out["correct1"] = (_topk_acc(logits, answer, 1) & labeled).sum()
            out["correct5"] = (_topk_acc(logits, answer, 5) & labeled).sum()
        return out

    return eval_step
