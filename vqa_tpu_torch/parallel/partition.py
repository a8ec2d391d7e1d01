"""Tensor parallelism over the mesh's model axis, the port of
``vqa_tpu/parallel/partition.py``.

The leaf rule is the JAX package's, copied: a 2-D parameter of at least
``min_size`` elements shards on its largest dimension (the first on a tie)
over the model axis when the axis' size divides that dimension; every other
leaf is replicated. The port keeps flax's names and shapes ('/'-keyed,
``[in, out]`` kernels), so the picks equal the JAX picks key for key.

What is sharded is the optimizer's state alone (ZeRO stage 1), as in the
JAX package where adam's moments and MultiSteps' accumulators inherit their
parameter's layout: on each rank of a row (the ranks of one data index,
``parallel/mesh.py``) a sharded leaf keeps only its ``1 / model`` slice of
every per-parameter state tensor (adam's ``mu`` and ``nu``, sgd's trace,
``grad_accum``), contiguous along the picked dimension, in model-index
order. The parameters, the grads and the activations stay whole on every
rank, and each rank of a row runs the same forward and backward: the model
axis saves optimizer-state memory and costs an all-gather a step, so over
the same cards data parallelism alone is faster wherever the state fits.

A step (``Layout.apply``, called by ``engine/steps.py``'s train step after
the data axis' ``all_reduce``): the optimizer runs over this rank's slices
of the grads and parameters, the clip's global norm totalled over the row
(``Layout.sum_of_squares``, handed to the transform's update), each rank
adds its slices' updates to its slice of the parameter, then ONE
``all_gather`` over the row makes the parameters whole again before the
next forward, where XLA's gather does it in the JAX package. The same
gather carries the replicated leaves, each rank sending a ``1 / model``
chunk of its updated copy: every parameter of the row is then defined by
the gather, so the ranks agree bit for bit even where their replicated
updates differ in the last bits (different column groups' reductions). The
numbers do not depend on the layout beyond the clip's summation order.

Checkpoints hold whole arrays (``gather_state`` before a save, a collective
of the row; ``Layout.view`` on restore), so a run saved under any layout
resumes under any other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from vqa_tpu_torch.engine import optim
from vqa_tpu_torch.parallel.mesh import Mesh

MIN_SIZE = 1 << 16


def leaf_dim(shape: Sequence[int], model: int, min_size: int = MIN_SIZE) -> Optional[int]:
    """The dimension a leaf of ``shape`` shards on over a model axis of
    ``model`` ranks, or None (replicated): ``vqa_tpu/parallel/partition.py``'s
    ``_leaf_sharding``."""
    shape = tuple(int(d) for d in shape)
    if model > 1 and len(shape) == 2 and int(np.prod(shape)) >= min_size:
        axis = int(np.argmax(shape))
        if shape[axis] % model == 0:
            return axis
    return None


def tp_shardings(tree: Mapping[str, Any], mesh: Mesh,
                 min_size: int = MIN_SIZE) -> Dict[str, Optional[int]]:
    """The rule over a '/'-keyed mapping of tensors, arrays or shapes: each
    key's sharded dimension, or None."""
    return {key: leaf_dim(getattr(leaf, "shape", leaf), mesh.model, min_size)
            for key, leaf in tree.items()}


@dataclasses.dataclass(frozen=True)
class Layout:
    """A train state's layout over ``mesh``: per trained parameter (in
    ``TrainState.params``' order) the dimension its optimizer state is
    sharded on, or None, and its whole shape."""

    mesh: Mesh
    dims: Tuple[Optional[int], ...]
    shapes: Tuple[Tuple[int, ...], ...]

    @property
    def sharded(self) -> List[int]:
        return [i for i, d in enumerate(self.dims) if d is not None]

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of parameter ``i``'s whole tensor ``t`` (a view),
        or ``t`` itself where the leaf is replicated."""
        dim = self.dims[i]
        return t if dim is None else t.chunk(self.mesh.model, dim)[self.mesh.model_index]

    def view(self, i: int, array: np.ndarray) -> np.ndarray:
        """``local`` over a host array: what this rank restores of a whole
        checkpointed array."""
        dim = self.dims[i]
        return (array if dim is None
                else np.split(array, self.mesh.model, axis=dim)[self.mesh.model_index])

    def gather(self, pieces: Sequence[Tuple[int, torch.Tensor]],
               outs: Optional[Sequence[torch.Tensor]] = None,
               shared: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
        """The whole tensors of ``pieces`` (this rank's slices of sharded
        parameters ``i``), by ONE all-gather over the row; written into
        ``outs`` where given (the parameters), else new tensors. ``shared``
        (tensors every rank of the row holds whole) are overwritten in the
        same gather by the row's one copy: model index ``m`` sends the
        ``m``-th chunk of their flat values. Every rank of the row calls it
        at once, with the same ``i`` and shapes."""
        mesh = self.mesh
        shared = list(shared or ())
        if not pieces and not shared:
            return []
        own: List[torch.Tensor] = []
        if shared:
            flat_shared = torch.cat([t.reshape(-1) for t in shared])
            chunk = -(-flat_shared.numel() // mesh.model)
            padded = torch.nn.functional.pad(flat_shared,
                                             (0, chunk * mesh.model - flat_shared.numel()))
            own = [padded[mesh.model_index * chunk:(mesh.model_index + 1) * chunk]]
        flat = torch.cat([t.reshape(-1) for _, t in pieces] + own)
        every = mesh.all_gather_model(flat).view(mesh.model, flat.numel())
        if shared:
            row_copy = every[:, flat.numel() - chunk:].reshape(-1)
            start = 0
            for t in shared:
                t.copy_(row_copy[start:start + t.numel()].view(t.shape))
                start += t.numel()
        whole, start = [], 0
        for k, (i, t) in enumerate(pieces):
            dim, shape = self.dims[i], self.shapes[i]
            part = every[:, start:start + t.numel()]
            start += t.numel()
            out = outs[k] if outs is not None else torch.empty(shape, dtype=t.dtype,
                                                                 device=t.device)
            # piece m is the m-th block along ``dim``, stored contiguous
            per = shape[dim] // mesh.model
            if dim == 0:
                out.view(mesh.model, -1).copy_(part)
            else:
                out.view(shape[0], mesh.model, per).copy_(
                    part.view(mesh.model, shape[0], per).transpose(0, 1))
            whole.append(out)
        return whole

    def sum_of_squares(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole leaves' sum of squares from this rank's per-parameter
        list (slices of the sharded leaves, the replicated ones whole): the
        slices' squares summed over the row, the replicated leaves' added
        once. The same on every rank of the row."""
        def squares(ts):
            return sum(((t.float() * t.float()).sum() for t in ts),
                       torch.zeros((), device=tensors[0].device))

        sharded = set(self.sharded)
        part = squares(t for i, t in enumerate(tensors) if i in sharded)
        total = self.mesh.all_reduce_model_sum(part.reshape(1)).reshape(())
        return total + squares(t for i, t in enumerate(tensors) if i not in sharded)

    def apply(self, state, grads: Sequence[torch.Tensor]) -> None:
        """One optimizer update of ``state`` (its ``opt_state`` sharded by
        this layout) from the whole, data-reduced ``grads``: the transform
        over this rank's slices, the updates added to this rank's slices of
        the parameters, then every parameter made the row's by one gather
        (the sharded leaves' slices, the replicated leaves' chunks)."""
        params = state.params
        local_grads = [self.local(i, g) for i, g in enumerate(grads)]
        local_params = [self.local(i, p.detach()) for i, p in enumerate(params)]
        updates, state.opt_state = state.tx.update(local_grads, state.opt_state, local_params,
                                                   self.sum_of_squares)
        if updates is None:  # a grad_accum mini-step: nothing applied
            return
        with torch.no_grad():
            optim.apply_updates(local_params, updates)
            sharded = self.sharded
            self.gather([(i, local_params[i]) for i in sharded],
                        outs=[params[i].detach() for i in sharded],
                        shared=[params[i].detach() for i, d in enumerate(self.dims)
                                if d is None])


def state_layout(state, mesh: Mesh, min_size: int = MIN_SIZE) -> Layout:
    """The rule's layout of ``state``'s trained parameters over ``mesh``."""
    shapes = tuple(tuple(p.shape) for p in state.params)
    return Layout(mesh, tuple(leaf_dim(s, mesh.model, min_size) for s in shapes), shapes)


def shard_state_tp(state, mesh: Mesh, min_size: int = MIN_SIZE):
    """Lay out a ``steps.TrainState`` over ``mesh``: every per-parameter
    optimizer-state tensor of a sharded leaf cut to this rank's slice (a
    copy, so the whole tensor is freed), the rest kept whole; the train step
    then runs ``Layout.apply``. A model axis of 1 leaves the state as it
    is."""
    if state.layout is not None:
        raise ValueError("the train state is laid out already")
    if mesh.model == 1:
        return state
    layout = state_layout(state, mesh, min_size)
    state.opt_state = optim.map_param_tensors(
        state.opt_state,
        lambda i, t: t if layout.dims[i] is None else layout.local(i, t).contiguous().clone())
    state.layout = layout
    return state


def gather_state(state):
    """``state`` with its optimizer state whole (a new ``TrainState`` over
    the same model; ``state`` itself unchanged), for a checkpoint: a
    collective of the row, which every rank calls. A state that is not laid
    out comes back as it is."""
    layout = state.layout
    if layout is None:
        return state
    pieces = _param_tensors(state.opt_state)
    whole = iter(layout.gather([(i, t) for i, t in pieces if layout.dims[i] is not None]))
    opt_state = optim.map_param_tensors(
        state.opt_state, lambda i, t: t if layout.dims[i] is None else next(whole))
    return dataclasses.replace(state, opt_state=opt_state, layout=None)


def _param_tensors(opt_state) -> List[Tuple[int, torch.Tensor]]:
    """Every per-parameter tensor of an optimizer state with its parameter's
    position, in ``map_param_tensors``' order."""
    out: List[Tuple[int, torch.Tensor]] = []
    optim.map_param_tensors(opt_state, lambda i, t: out.append((i, t)) or t)
    return out


def state_bytes(opt_state) -> int:
    """The bytes of an optimizer state's per-parameter tensors on this rank."""
    return sum(t.numel() * t.element_size() for _, t in _param_tensors(opt_state))
