"""Epoch loops, the port of ``vqa_tpu/engine/engine.py`` (``train``,
``validate`` and ``test``, with the device transform and the loop under
them, and the train loop's mid-epoch checkpoints and SIGTERM preemption).

train():    step loop over the loader, the train step, meters + logging,
            step checkpoints and the preemption point
validate(): eval loop -> top-1/top-5 accuracy + OpenEnded results list
test():     eval loop without labels -> OpenEnded results list

Host<->device traffic: the loader's background thread copies each batch's
compute keys to the card (``make_device_transform``) on the default stream,
so the step that reads them is ordered after the copy; image indices,
question ids and a host copy of ``valid`` stay on the host. The loop
dispatches the whole epoch, then stacks the outputs on the card and copies
them back once.

Across processes (``parallel/``) evaluation is replica-fed: every rank
iterates the whole split, its transform keeps its data index's slice of
each global batch (``make_device_transform(..., mesh=...)``; the ranks of
one row run the same slice), and after the epoch's dispatch the loop
gathers every rank's packed outputs once over the host group and keeps one
rank a data index, so every rank holds the whole epoch's metrics and
results. No
collective runs in the loader's producer thread: one there would race the
main thread's, the gloo crash that ``vqa_tpu/engine/engine.py:75-81``
records.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vqa_tpu_torch.engine.logger import Experiment
from vqa_tpu_torch.engine.meters import MeterBank
from vqa_tpu_torch.parallel.mesh import local_rows
from vqa_tpu_torch.utils.spans import span

# the batch keys the step reads on the card. ``image_index`` is not among
# them: the gather range-checks it on the host and carries it in the
# launch's parameters (ops/gather.py)
DEVICE_KEYS = ("visual", "question", "length", "answer", "valid")

# -- preemption (SIGTERM -> checkpoint at the next step boundary) -------------
# A preemptible machine gets SIGTERM with a grace period before eviction; the
# handler only sets a flag (async-signal-safe), and the train loop saves a
# mid-epoch checkpoint at the next step boundary and raises Preempted, so the
# CLI exits cleanly and the run resumes with --resume latest losing no step.

_PREEMPT = threading.Event()


class Preempted(Exception):
    """Raised by train() after the preemption checkpoint landed."""

    def __init__(self, epoch: int, next_step: int):
        super().__init__(f"preempted at epoch {epoch}, step {next_step}")
        self.epoch = epoch
        self.next_step = next_step


def request_preemption() -> None:
    """Flag the train loop to checkpoint-and-stop at the next boundary."""
    _PREEMPT.set()


def install_preemption_handler() -> bool:
    """SIGTERM -> request_preemption(). Returns False when not installable
    (signal handlers only work on the main thread). Clears any stale flag."""
    if threading.current_thread() is not threading.main_thread():
        return False
    _PREEMPT.clear()
    signal.signal(signal.SIGTERM, lambda *_: request_preemption())
    return True


def make_device_transform(device, dtype: Optional[torch.dtype] = None, mesh=None):
    """Pipeline transform: copy the compute keys to ``device``, float32
    ``visual`` cast to ``dtype`` first (as the JAX transform casts on the
    host); keep ``image_index``, ``question_id`` and ``valid_host`` (the
    results filter's copy of ``valid``) on the host. Over a distributed
    ``mesh`` (replica-fed evaluation) the compute keys and ``image_index``
    are this rank's data slice of the batch; ``question_id`` and ``valid_host``
    stay whole, for the results of the gathered outputs."""
    device = torch.device(device)
    sliced = mesh is not None and mesh.distributed

    def rows(array: np.ndarray) -> np.ndarray:
        if not sliced:
            return array
        start, stop = local_rows(array.shape[0], mesh)
        return array[start:stop]

    def transform(batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key in DEVICE_KEYS:
            if key in batch:
                t = torch.from_numpy(rows(batch[key]))
                if dtype is not None and t.dtype == torch.float32:
                    t = t.to(dtype)
                out[key] = t.to(device)
        if "image_index" in batch:
            out["image_index"] = rows(batch["image_index"])
        out["question_id"] = batch["question_id"]
        if "valid" in batch:
            out["valid_host"] = batch["valid"]
        return out

    return transform


def _readback_stacked(outs: List[Dict[str, torch.Tensor]], mesh=None) -> Dict[str, np.ndarray]:
    """The per-batch eval outputs as host arrays [n_batches, ...]: packed into
    one int64 tensor on their device, then copied to the host in one
    transfer (the epoch's only sync). Batches must share their shapes, as
    they do with ``pad_last``. Over a distributed ``mesh`` the ranks' packed
    outputs are gathered once and the first rank of each row kept (the
    others ran the same slices): the per-row outputs (``pred``) concatenated
    in data-index order, the global batch's order, the sums added."""
    keys = list(outs[0])
    sizes = [outs[0][k].numel() for k in keys]
    packed = torch.stack([torch.cat([o[k].reshape(-1).to(torch.int64) for k in keys])
                          for o in outs])
    host = packed.cpu().numpy()
    bounds = np.cumsum([0] + sizes)
    n = len(outs)
    if mesh is None or not mesh.distributed:
        return {k: host[:, a:b].reshape((n,) + tuple(outs[0][k].shape))
                for k, a, b in zip(keys, bounds[:-1], bounds[1:])}
    every = mesh.all_gather_host(host)[::mesh.model]          # [data, n, packed]
    out = {}
    for k, a, b in zip(keys, bounds[:-1], bounds[1:]):
        part, shape = every[:, :, a:b], tuple(outs[0][k].shape)
        if shape:
            out[k] = part.transpose(1, 0, 2).reshape((n, mesh.data * shape[0]) + shape[1:])
        else:
            out[k] = part.sum(axis=0).reshape(n)
    return out


def _split_batch(batch):
    device_batch = {k: v for k, v in batch.items() if k not in ("question_id", "valid_host")}
    return device_batch, batch["question_id"], batch.get("valid_host")


def train(
    loader,
    state,
    train_step,
    exp: Optional[Experiment],
    epoch: int,
    print_freq: int = 10,
    features=None,
    start_step: int = 0,
    checkpoint_every: int = 0,
    step_checkpoint=None,
) -> Tuple[Any, Dict[str, float]]:
    """One training epoch. The epoch's batches are a pure function of (seed,
    epoch), so ``start_step`` skips the first batches of a resumed epoch,
    and dropout is seeded by ``state.step``: a resumed run replays the
    interrupted epoch exactly. ``step_checkpoint(state, epoch, next_step)``
    is called after every ``checkpoint_every`` executed steps (never on the
    epoch's last step: the epoch save supersedes it), and at once when
    SIGTERM has set the preemption flag, which then raises ``Preempted``.
    The logged epoch averages cover only the steps executed. Host metrics
    are read only on print steps; the others are stacked on the card and
    read back once at the epoch's end."""
    meters = MeterBank()
    steps_total = loader.steps_per_epoch()
    step_metrics: list = []
    t_data = time.perf_counter()
    for i, batch in enumerate(loader.epoch(epoch)):
        if i < start_step:
            t_data = time.perf_counter()
            continue
        device_batch, _, _ = _split_batch(batch)
        data_time = time.perf_counter() - t_data
        state, metrics = train_step(state, device_batch, features)
        step_metrics.append(metrics)
        if step_checkpoint is not None and _PREEMPT.is_set():
            # SIGTERM landed: save now, not at the periodic boundary (the
            # grace period is short), and hand control back
            step_checkpoint(state, epoch, i + 1)
            raise Preempted(epoch, i + 1)
        if (checkpoint_every and step_checkpoint is not None
                and (i + 1) % checkpoint_every == 0 and i + 1 < steps_total):
            step_checkpoint(state, epoch, i + 1)
        if print_freq and (i % print_freq == 0 or i + 1 == steps_total):
            # the metrics' readback syncs: only on print steps
            host = {k: float(v) for k, v in metrics.items()}
            batch_time = time.perf_counter() - t_data - data_time
            print(
                f"Epoch [{epoch}][{i}/{steps_total}] "
                f"loss {host['loss']:.4f} acc1 {host['acc1']*100:.2f} "
                f"acc5 {host['acc5']*100:.2f} data {data_time:.3f}s",
                flush=True,
            )
            if exp is not None:
                exp.log_step(epoch, "train", i,
                             {**host, "data_time": data_time, "batch_time": batch_time})
        t_data = time.perf_counter()

    if step_metrics:
        keys = list(step_metrics[0])
        stacked = torch.stack([torch.stack([m[k].float() for k in keys])
                               for m in step_metrics]).cpu().numpy()   # one readback
        for k, v in zip(keys, stacked.T):
            meters.update({k: float(np.mean(v))}, n=len(step_metrics))
    avgs = meters.averages()
    if exp is not None:
        exp.log_epoch(epoch, "train", avgs)
    return state, avgs


def _eval_loop(
    loader, model, eval_step, aid_to_ans: List[str], epoch: int, features=None, mesh=None
) -> Tuple[Dict[str, float], List[Dict[str, Any]]]:
    """Dispatch the whole epoch, then ONE device->host readback: a sync per
    batch would leave the card idle while the host reads each result. Over a
    distributed ``mesh`` the loader's transform hands this rank its slice of
    each batch and the readback gathers every rank's; ``qa_per_sec`` counts
    the global batch's questions. Under a profiler each batch's dispatch is
    the span ``vqa_tpu_torch.eval.step``, the readback
    ``vqa_tpu_torch.eval.readback`` and the results rows
    ``vqa_tpu_torch.eval.results`` (``utils/spans.py``)."""
    total = {"n": 0, "n_labeled": 0, "correct1": 0, "correct5": 0}
    results: List[Dict[str, Any]] = []
    outs: List[Dict[str, torch.Tensor]] = []
    metas: List[Tuple[np.ndarray, Any]] = []
    t0 = time.perf_counter()
    for batch in loader.epoch(epoch):
        device_batch, question_ids, valid_host = _split_batch(batch)
        with span("vqa_tpu_torch.eval.step"):
            outs.append(eval_step(model, device_batch, features))
        metas.append((question_ids, valid_host))
    if not outs:
        return {"n": 0, "eval_time": 0.0, "qa_per_sec": 0.0}, []
    with span("vqa_tpu_torch.eval.readback"):
        stacked = _readback_stacked(outs, mesh)
    n_seen = 0
    with span("vqa_tpu_torch.eval.results"):
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
    exp: Optional[Experiment], epoch: int, split: str = "val", features=None, mesh=None,
) -> Tuple[float, List[Dict[str, Any]]]:
    metrics, results = _eval_loop(loader, model, eval_step, aid_to_ans, epoch, features, mesh)
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
    exp: Optional[Experiment], epoch: int, split: str = "test", features=None, mesh=None,
) -> List[Dict[str, Any]]:
    metrics, results = _eval_loop(loader, model, eval_step, aid_to_ans, epoch, features, mesh)
    if exp is not None:
        exp.log_epoch(epoch, split, metrics)
        exp.write_results(results, epoch, split)
    return results
