"""Eval loops, the port of ``vqa_tpu/engine/engine.py``'s ``validate`` and
``test`` (with the device transform and the loop under them). ``train`` is
not ported yet (ROADMAP.md queue 1, item 5).

validate(): eval loop -> top-1/top-5 accuracy + OpenEnded results list
test():     eval loop without labels -> OpenEnded results list

Host<->device traffic: the loader's background thread copies each batch's
compute keys to the card (``make_device_transform``) on the default stream,
so the step that reads them is ordered after the copy; image indices,
question ids and a host copy of ``valid`` stay on the host. The loop
dispatches the whole epoch, then stacks the outputs on the card and copies
them back once.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vqa_tpu_torch.engine.logger import Experiment

# the batch keys the step reads on the card. ``image_index`` is not among
# them: the gather range-checks it on the host and carries it in the
# launch's parameters (ops/gather.py)
DEVICE_KEYS = ("visual", "question", "length", "answer", "valid")


def make_device_transform(device, dtype: Optional[torch.dtype] = None):
    """Pipeline transform: copy the compute keys to ``device``, float32
    ``visual`` cast to ``dtype`` first (as the JAX transform casts on the
    host); keep ``image_index``, ``question_id`` and ``valid_host`` (the
    results filter's copy of ``valid``) on the host."""
    device = torch.device(device)

    def transform(batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key in DEVICE_KEYS:
            if key in batch:
                t = torch.from_numpy(batch[key])
                if dtype is not None and t.dtype == torch.float32:
                    t = t.to(dtype)
                out[key] = t.to(device)
        if "image_index" in batch:
            out["image_index"] = batch["image_index"]
        out["question_id"] = batch["question_id"]
        if "valid" in batch:
            out["valid_host"] = batch["valid"]
        return out

    return transform


def _readback_stacked(outs: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """The per-batch eval outputs as host arrays [n_batches, ...]: packed into
    one int64 tensor on their device, then copied to the host in one
    transfer (the epoch's only sync). Batches must share their shapes, as
    they do with ``pad_last``."""
    keys = list(outs[0])
    sizes = [outs[0][k].numel() for k in keys]
    packed = torch.stack([torch.cat([o[k].reshape(-1).to(torch.int64) for k in keys])
                          for o in outs])
    host = packed.cpu().numpy()
    bounds = np.cumsum([0] + sizes)
    return {k: host[:, a:b].reshape((len(outs),) + tuple(outs[0][k].shape))
            for k, a, b in zip(keys, bounds[:-1], bounds[1:])}


def _split_batch(batch):
    device_batch = {k: v for k, v in batch.items() if k not in ("question_id", "valid_host")}
    return device_batch, batch["question_id"], batch.get("valid_host")


def _eval_loop(
    loader, model, eval_step, aid_to_ans: List[str], epoch: int, features=None
) -> Tuple[Dict[str, float], List[Dict[str, Any]]]:
    """Dispatch the whole epoch, then ONE device->host readback: a sync per
    batch would leave the card idle while the host reads each result."""
    total = {"n": 0, "n_labeled": 0, "correct1": 0, "correct5": 0}
    results: List[Dict[str, Any]] = []
    outs: List[Dict[str, torch.Tensor]] = []
    metas: List[Tuple[np.ndarray, Any]] = []
    t0 = time.perf_counter()
    for batch in loader.epoch(epoch):
        device_batch, question_ids, valid_host = _split_batch(batch)
        outs.append(eval_step(model, device_batch, features))
        metas.append((question_ids, valid_host))
    if not outs:
        return {"n": 0, "eval_time": 0.0, "qa_per_sec": 0.0}, []
    stacked = _readback_stacked(outs)
    n_seen = 0
    for i, (question_ids, valid_host) in enumerate(metas):
        pred = stacked["pred"][i]
        if valid_host is not None:
            pred = pred[valid_host]
            question_ids = question_ids[valid_host]
        for qid, aid in zip(question_ids.tolist(), pred.tolist()):
            results.append({"question_id": qid, "answer": aid_to_ans[aid]})
        total["n"] += int(stacked["n"][i])
        if "correct1" in stacked:
            total["n_labeled"] += int(stacked["n_labeled"][i])
            total["correct1"] += int(stacked["correct1"][i])
            total["correct5"] += int(stacked["correct5"][i])
        n_seen += len(pred)
    wall = time.perf_counter() - t0
    metrics = {
        "n": total["n"],
        "eval_time": wall,
        "qa_per_sec": n_seen / wall if wall > 0 else 0.0,
    }
    if total["n_labeled"]:
        # acc1/acc5 are reference-comparable: every evaluated example is in
        # the denominator, so rows whose consensus answer is OOV (answer=-1)
        # count as incorrect. The *_labeled variants use only in-vocab rows;
        # both denominators are recorded in metrics.jsonl (n vs n_labeled).
        metrics["n_labeled"] = total["n_labeled"]
        metrics["acc1"] = total["correct1"] / total["n"]
        metrics["acc5"] = total["correct5"] / total["n"]
        metrics["acc1_labeled"] = total["correct1"] / total["n_labeled"]
        metrics["acc5_labeled"] = total["correct5"] / total["n_labeled"]
    return metrics, results


def validate(
    loader, model, eval_step, aid_to_ans: List[str],
    exp: Optional[Experiment], epoch: int, split: str = "val", features=None,
) -> Tuple[float, List[Dict[str, Any]]]:
    metrics, results = _eval_loop(loader, model, eval_step, aid_to_ans, epoch, features)
    if exp is not None:
        exp.log_epoch(epoch, split, metrics)
        exp.write_results(results, epoch, split)
    acc1 = metrics.get("acc1", 0.0)
    print(
        f"Eval [{epoch}] {split}: acc1 {acc1*100:.2f} "
        f"acc5 {metrics.get('acc5', 0.0)*100:.2f} "
        f"({metrics['qa_per_sec']:.0f} QA/s)",
        flush=True,
    )
    return acc1, results


def test(
    loader, model, eval_step, aid_to_ans: List[str],
    exp: Optional[Experiment], epoch: int, split: str = "test", features=None,
) -> List[Dict[str, Any]]:
    metrics, results = _eval_loop(loader, model, eval_step, aid_to_ans, epoch, features)
    if exp is not None:
        exp.log_epoch(epoch, split, metrics)
        exp.write_results(results, epoch, split)
    return results
