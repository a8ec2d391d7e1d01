"""Eval step, the port of ``vqa_tpu/engine/steps.py`` (make_eval_step and
_resolve_visual). The train step is not ported yet (ROADMAP.md queue 1,
item 5).

With a feature table resident on the device, a batch carries ``image_index``
instead of ``visual`` and the step gathers the region tensors itself
(``ops.gather.gather_rows``, the hand-written kernel on the card), so the
host ships token ids and indices, not 36x2048 features. ``image_index``
stays on the host: the gather checks its range there before the upload.
"""

from __future__ import annotations

from typing import Dict

import torch

from vqa_tpu_torch.ops.gather import gather_rows


def _topk_acc(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    topk = torch.topk(logits, k, dim=-1).indices              # [B, k]
    return (topk == labels[:, None]).any(dim=-1)


def _resolve_visual(batch: Dict[str, torch.Tensor], features) -> torch.Tensor:
    if "visual" in batch:
        return batch["visual"]
    if features is None:
        raise ValueError("batch has image_index but no feature table was passed")
    if isinstance(features, (tuple, list)):
        raise NotImplementedError(
            "int8 (values, scales) feature tables are not ported yet: the int8 "
            "gather fused with dequant is in ROADMAP.md queue 2"
        )
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
