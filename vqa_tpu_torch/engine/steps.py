"""Train and eval steps, the port of ``vqa_tpu/engine/steps.py``.

The train step (the six LSTM archs; a model built with ``train=True``):
the table gather outside autograd, the forward with ``train=True`` and
dropout masks from a generator seeded by (seed, step), the mean CE, the
backward, then the optimizer's update of the parameters in place. Its
metrics stay on the card: no host sync in the step.

With a feature table resident on the device, a batch carries ``image_index``
instead of ``visual`` and the step gathers the region tensors itself
(``ops.gather.gather_rows``, the hand-written kernel on the card), so the
host ships token ids and indices, not 36x2048 features. ``image_index``
stays on the host: the gather checks its range there before the launch.

The table may be an int8 ``(values, scales)`` pair from
``quantize_features`` (the JAX package's ``engine.features_dtype=int8``,
which halves the table's bytes and the gather's reads); its rows are
gathered and dequantized by one kernel (``ops.gather.gather_rows_dequant``).
It may also be row-sharded over the data ranks
(``parallel.mesh.ShardedTable``, ``engine.features_sharded``), whose gather
exchanges the ranks' indices and rows.

Data parallelism (``make_train_step(..., mesh=...)`` over a mesh of several
processes): each rank runs its shard of the global batch, then ONE
``all_reduce`` over its column (the data axis) averages the grads and the
metric scalars before the optimizer, as the JAX step's psum over the 'data'
axis does. Tensor parallelism (a state laid out by
``parallel.partition.shard_state_tp``): the ranks of one row run the same
batch shard with the whole parameters; after the reduction the optimizer
runs over each rank's slices of the sharded leaves and one all-gather over
the row makes them whole (``Layout.apply``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from vqa_tpu_torch.engine import optim
from vqa_tpu_torch.ops.gather import gather_rows, gather_rows_dequant
from vqa_tpu_torch.parallel.mesh import Mesh, ShardedTable


@dataclasses.dataclass
class TrainState:
    """The counterpart of flax's TrainState: the model (its parameters are
    the ones trained), the optimizer and its state, and the count of train
    steps taken (micro-steps under ``grad_accum``), which seeds dropout;
    ``layout`` is a ``parallel.partition.Layout`` where the optimizer state
    is sharded over the mesh's model axis, else None."""

    model: nn.Module
    tx: optim.Transform
    opt_state: object
    step: int = 0
    layout: Optional[Any] = None

    @property
    def params(self) -> List[nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]


def create_state(model: nn.Module, tx: optim.Transform) -> TrainState:
    state = TrainState(model, tx, None)
    if not state.params:
        raise ValueError("the model has no trainable parameters: build it with train=True")
    state.opt_state = tx.init([p.detach() for p in state.params])
    return state


def dropout_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The dropout stream of one step, a pure function of (seed, step), as
    ``jax.random.fold_in(rng, state.step)`` is in the JAX step (the streams
    themselves differ from flax's). A data rank past the first draws its own
    stream (``rank``, the data index, folded in), so the data shards get
    independent masks while the ranks of one row draw the same; data index 0
    draws the single process's."""
    entropy = [seed, step] + ([rank] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2 ** 63 - 1))


def _topk_acc(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    topk = torch.topk(logits, k, dim=-1).indices              # [B, k]
    return (topk == labels[:, None]).any(dim=-1)


def quantize_features(table):
    """Per-row symmetric int8 quantization of a feature table [N, ..., D]:
    returns (values int8, scales float32 [N, ..., 1]). A copy of
    ``vqa_tpu/engine/steps.py::quantize_features`` (the port imports nothing
    of ``vqa_tpu``), held byte-equal to it in the tests. Place the scales on
    the card in the compute dtype where it is bf16 (else float32), as
    ``vqa_tpu/cli/train.py`` does."""
    absmax = np.abs(table).max(axis=-1, keepdims=True)
    scales = (absmax / 127.0 + 1e-12).astype(np.float32)
    values = np.clip(np.round(table / scales), -127, 127).astype(np.int8)
    return values, scales


def _resolve_visual(batch: Dict[str, torch.Tensor], features) -> torch.Tensor:
    if "visual" in batch:
        return batch["visual"]
    if features is None:
        raise ValueError("batch has image_index but no feature table was passed")
    if isinstance(features, ShardedTable):
        return features.gather(batch["image_index"])
    if isinstance(features, (tuple, list)):
        # int8 rows dequantized after the gather, in the scales' dtype
        values, scales = features
        return gather_rows_dequant(values, scales, batch["image_index"])
    return gather_rows(features, batch["image_index"])


def loss_and_grads(model: nn.Module, params: List[torch.Tensor], batch: Dict[str, torch.Tensor],
                   visual: torch.Tensor, criterion: Callable, rng=None):
    """(loss, logits, grads of ``params``) of one batch, the model run with
    ``train=True``; dropout is on where ``rng`` is given."""
    logits = model(visual, batch["question"], batch.get("length"), train=True, rng=rng)
    loss = criterion(logits, batch["answer"]).mean()
    return loss, logits, torch.autograd.grad(loss, params)


def _check_finite(model: nn.Module, loss: torch.Tensor, grads) -> None:
    """``engine.nan_check``: raise on a non-finite loss or grad, naming it
    (one sync with the card a step)."""
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"non-finite loss {float(loss.detach())} (engine.nan_check)")
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).cpu()
    if not bool(finite.all()):
        bad = [n for n, ok in zip(names, finite.tolist()) if not ok]
        raise FloatingPointError(f"non-finite grads of {bad} (engine.nan_check)")


def _all_reduce_mean(mesh: Mesh, grads, metrics: Dict[str, torch.Tensor]):
    """The grads and the metric scalars averaged over the data axis by ONE
    ``all_reduce`` of a flat float32 buffer (the step is host-bound: one
    collective a step, not one a tensor). The ranks' shards are equal, so
    the mean of their means is the global batch's mean."""
    keys = list(metrics)
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [metrics[k].float().reshape(1) for k in keys])
    mesh.all_reduce_mean(flat)
    out, start = [], 0
    for g in grads:
        out.append(flat[start:start + g.numel()].view(g.shape).to(g.dtype))
        start += g.numel()
    return out, {k: flat[start + i] for i, k in enumerate(keys)}


def make_train_step(criterion: Callable, seed: int, nan_check: bool = False,
                    mesh: Optional[Mesh] = None):
    """Returns (state, batch, features=None) -> (state, metrics): ``loss``,
    ``acc1``, ``acc5`` and ``gnorm`` (the global norm of the raw grads,
    before any clip) as tensors on the step's device. ``nan_check`` raises
    before the update on a non-finite loss or grad. Over a ``mesh`` of
    several processes the grads and the metrics are those of the global
    batch: averaged over the data axis before the check, the norm and the
    update (DDP's reducer does not fire under ``torch.autograd.grad``, so
    the reduction is written out). A state laid out over the mesh's model
    axis is updated by its layout; ``gnorm`` is the whole grads' norm."""
    distributed = mesh is not None and mesh.distributed
    # a column of one rank has no group (a 1 x M mesh); a world of one
    # reduces over its own group, so the step's collective runs there too
    reduce = distributed and mesh.data_group is not None
    rank = mesh.data_index if distributed else 0

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], features=None):
        with torch.no_grad():
            visual = _resolve_visual(batch, features)
        rng = dropout_generator(seed, state.step, visual.device, rank)
        params = state.params
        loss, logits, grads = loss_and_grads(state.model, params, batch, visual, criterion, rng)
        logits = logits.detach()
        metrics = {
            "loss": loss.detach(),
            "acc1": _topk_acc(logits, batch["answer"], 1).float().mean(),
            "acc5": _topk_acc(logits, batch["answer"], 5).float().mean(),
        }
        if reduce:
            grads, metrics = _all_reduce_mean(mesh, grads, metrics)
        if nan_check:
            _check_finite(state.model, metrics["loss"], grads)
        metrics["gnorm"] = optim.global_norm(grads)
        if state.layout is not None:
            state.layout.apply(state, grads)
        else:
            updates, state.opt_state = state.tx.update(list(grads), state.opt_state,
                                                       [p.detach() for p in params])
            optim.apply_updates(params, updates)
        state.step += 1
        return state, metrics

    return train_step


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
