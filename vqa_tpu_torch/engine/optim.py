"""Optimizer and criterion, the port of ``vqa_tpu/engine/optim.py``.

The optax chain the JAX package builds from the YAML's ``optim`` section,
with optax's semantics exactly: ``clip_by_global_norm`` ->
``add_decayed_weights`` -> adam or sgd with momentum, the staircase
exponential lr decay counted in APPLIED updates, and ``grad_accum`` as
``optax.MultiSteps`` (the mean of k micro-batch grads, one applied update,
the inner counts advancing only then).

A transformation here is optax's pair of pure functions over lists of
tensors: ``init(params) -> state`` and ``update(grads, state, params,
sum_of_squares) -> (updates, state)``; ``apply_updates`` adds the updates to
the parameters in place. Step counts are host integers, so an update needs no sync with the
card. The clip is written out rather than taken from
``torch.nn.utils.clip_grad_norm_``, which divides by ``norm + 1e-6`` where
optax divides by the norm.

Under tensor parallelism (``parallel/partition.py``) the update runs over
each rank's slices of the sharded leaves; its ``sum_of_squares`` argument
then totals the squares of the whole grads across the ranks for the clip
(None: the grads are whole, their own sum).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vqa_tpu_torch.config import OptimOptions

Tensors = List[torch.Tensor]
# the whole leaves' sum of squares from a per-parameter list that may hold
# one rank's slices of them
SumOfSquares = Callable[[Sequence[torch.Tensor]], torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Optional[Tensors], Optional[SumOfSquares]],
                     Tuple[Tensors, Any]]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the l2 norm of all leaves together, on their device."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(grads, state, params=None, sum_of_squares=None):
        norm = (global_norm(grads) if sum_of_squares is None
                else torch.sqrt(sum_of_squares(grads)))
        keep = norm < max_norm
        return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm) for g in grads], state

    return Transform(lambda params: (), update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(grads, state, params=None, sum_of_squares=None):
        return [g + weight_decay * p for g, p in zip(grads, params)], state

    return Transform(lambda params: (), update)


class AdamState(NamedTuple):
    count: int
    mu: Tensors
    nu: Tensors


class ScheduleState(NamedTuple):
    count: int


class MultiStepsState(NamedTuple):
    mini_step: int
    inner_state: Any
    grad_accum: Tensors


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    """optax.scale_by_adam (eps_root 0): state (count, mu, nu)."""

    def init(params):
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(grads, state, params=None, sum_of_squares=None):
        count, mu, nu = state
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, mu)]
        nu = [(1 - b2) * (g * g) + b2 * n for g, n in zip(grads, nu)]
        count += 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        updates = [(m / c1) / (torch.sqrt(n / c2) + eps) for m, n in zip(mu, nu)]
        return updates, AdamState(count, mu, nu)

    return Transform(init, update)


def trace(decay: float) -> Transform:
    """optax.trace (sgd's momentum, not Nesterov): t = g + decay * t."""

    def update(grads, state, params=None, sum_of_squares=None):
        state = [g + decay * t for g, t in zip(grads, state)]
        return state, state

    return Transform(lambda params: [torch.zeros_like(p) for p in params], update)


def scale_by_schedule(step_size: Callable[[int], float]) -> Transform:
    """Multiply by ``step_size(count)``, count of earlier updates."""

    def update(grads, state, params=None, sum_of_squares=None):
        scale = step_size(state.count)
        return [g * scale for g in grads], ScheduleState(state.count + 1)

    return Transform(lambda params: ScheduleState(0), update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None, sum_of_squares=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params, sum_of_squares)
            new_state.append(s)
        return grads, tuple(new_state)

    return Transform(init, update)


def multi_steps(inner: Transform, every_k: int) -> Transform:
    """optax.MultiSteps(inner, every_k_schedule=k) with the grad mean:
    state (mini_step, inner state, accumulated grads). A mini-step that does
    not complete the k returns no updates (None: nothing to apply) and
    leaves the inner state as it was."""

    def init(params):
        return MultiStepsState(0, inner.init(params), [torch.zeros_like(p) for p in params])

    def update(grads, state, params=None, sum_of_squares=None):
        mini_step, inner_state, acc = state
        acc = [a + (g - a) / (mini_step + 1) for g, a in zip(grads, acc)]
        if mini_step + 1 < every_k:
            return None, MultiStepsState(mini_step + 1, inner_state, acc)
        updates, inner_state = inner.update(acc, inner_state, params, sum_of_squares)
        return updates, MultiStepsState(0, inner_state, [torch.zeros_like(a) for a in acc])

    return Transform(init, update)


def _map_leaves(node: Any, keys: Sequence[str], fn: Callable[[str, Any, Optional[int]], Any],
                prefix: str = "", index: Optional[int] = None) -> Any:
    """``node`` with each tensor or count replaced by ``fn(name, leaf,
    index)``; a NamedTuple's fields are named by field, a plain tuple's (the
    chain's) by index, a list of per-parameter tensors by the parameters'
    ``keys``, and ``index`` is a per-parameter tensor's parameter position
    (None for a count)."""
    if isinstance(node, (torch.Tensor, int)):
        return fn(prefix, node, index)
    if isinstance(node, list):
        if len(node) != len(keys):
            raise ValueError(f"{prefix}: {len(node)} tensors for {len(keys)} parameters")
        return [_map_leaves(t, keys, fn, f"{prefix}/{k}", i)
                for i, (k, t) in enumerate(zip(keys, node))]
    if isinstance(node, tuple):
        named = hasattr(node, "_fields")
        children = [_map_leaves(c, keys, fn, f"{prefix}/{n}" if prefix else str(n))
                    for n, c in zip(node._fields if named else range(len(node)), node)]
        return type(node)(*children) if named else tuple(children)
    raise TypeError(f"{prefix}: cannot store a {type(node).__name__}")


def map_param_tensors(node: Any, fn: Callable[[int, torch.Tensor], torch.Tensor]) -> Any:
    """The state ``node`` with the tensor of parameter ``i`` in each
    per-parameter list (adam's moments, the trace, ``grad_accum``) replaced
    by ``fn(i, tensor)``, in the order ``state_arrays`` names them; the
    counts and the structure kept."""
    if isinstance(node, list):
        return [fn(i, t) for i, t in enumerate(node)]
    if isinstance(node, tuple):
        children = [map_param_tensors(c, fn) for c in node]
        return type(node)(*children) if hasattr(node, "_fields") else tuple(children)
    return node


def state_arrays(state: Any, keys: Sequence[str]) -> Dict[str, np.ndarray]:
    """The optimizer state as '/'-named numpy arrays (host copies), a count
    as a 0-d int64: e.g. ``0/mu/encoder/lstm_0/wh``, ``1/count``, and under
    ``grad_accum`` ``mini_step``, ``inner_state/...`` and
    ``grad_accum/<key>``."""
    out: Dict[str, np.ndarray] = {}

    def store(name, leaf, index):
        out[name] = (leaf.detach().to("cpu", copy=True).numpy()
                     if isinstance(leaf, torch.Tensor) else np.asarray(leaf, np.int64))

    _map_leaves(state, keys, store)
    return out


def state_from_arrays(template: Any, arrays: Dict[str, np.ndarray],
                      keys: Sequence[str],
                      view: Optional[Callable[[int, np.ndarray], np.ndarray]] = None) -> Any:
    """The state of ``template``'s structure with the values of ``arrays``
    (``state_arrays``'s names), each tensor on its template's device and in
    its dtype. ``view(i, array)``, where given, is what this rank keeps of
    parameter ``i``'s whole array (a tensor-parallel template holds slices).
    A missing, extra or wrongly shaped array raises, naming it."""
    shapes: Dict[str, tuple] = {}
    indices: Dict[str, Optional[int]] = {}

    def record(name, leaf, index):
        shapes[name] = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        indices[name] = index

    _map_leaves(template, keys, record)
    missing, extra = sorted(set(shapes) - set(arrays)), sorted(set(arrays) - set(shapes))
    if missing or extra:
        raise KeyError(f"optimizer state differs from the template's: missing {missing}, "
                       f"extra {extra}")
    if view is not None:
        arrays = {name: (array if indices[name] is None else view(indices[name], array))
                  for name, array in arrays.items()}
    for name, shape in shapes.items():
        if tuple(np.shape(arrays[name])) != shape:
            raise ValueError(f"optimizer state {name}: shape {tuple(np.shape(arrays[name]))}, "
                             f"the template's {shape}")

    def load(name, leaf, index):
        if isinstance(leaf, torch.Tensor):
            return torch.as_tensor(np.asarray(arrays[name])).to(leaf.device, leaf.dtype)
        return int(arrays[name])

    return _map_leaves(template, keys, load)


def apply_updates(params: Sequence[torch.Tensor], updates: Optional[Tensors]) -> None:
    """optax.apply_updates, in place."""
    if updates is None:
        return
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u.to(p.dtype))


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Callable[[int], float]:
    """optax.exponential_decay with ``staircase=True``."""
    return lambda count: init_value * decay_rate ** math.floor(count / transition_steps)


def make_schedule(opt: OptimOptions, steps_per_epoch: int):
    if opt.lr_decay is None:
        return lambda count: opt.lr
    # the inner optimizer's count advances once per APPLIED update: under
    # grad_accum=k that is steps_per_epoch/k per data epoch
    applied_per_epoch = max(steps_per_epoch // max(opt.grad_accum, 1), 1)
    return exponential_decay(opt.lr, applied_per_epoch, opt.lr_decay)


def factory(opt: OptimOptions, steps_per_epoch: int = 1) -> Transform:
    schedule = make_schedule(opt, steps_per_epoch)
    if opt.optimizer == "adam":
        core = [scale_by_adam()]
    elif opt.optimizer == "sgd":
        core = [trace(opt.momentum)] if opt.momentum is not None else []
    else:
        raise KeyError(f"unknown optimizer {opt.optimizer!r}; known: adam, sgd")
    steps = []
    if opt.grad_clip:
        steps.append(clip_by_global_norm(opt.grad_clip))
    if opt.weight_decay:
        steps.append(add_decayed_weights(opt.weight_decay))
    tx = chain(*steps, *core, scale_by_schedule(lambda count: -schedule(count)))
    if opt.grad_accum > 1:
        tx = multi_steps(tx, opt.grad_accum)
    return tx


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor,
                                              labels: torch.Tensor) -> torch.Tensor:
    """optax's, in the logits' dtype: the log-sum-exp of the logits minus the
    label's logit, per row."""
    label_logits = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


def criterion_factory(name: str = "cross_entropy"):
    """CE over a single sampled/most-frequent ground-truth answer id."""
    if name == "cross_entropy":
        return softmax_cross_entropy_with_integer_labels
    raise KeyError(f"unknown criterion {name!r}")
