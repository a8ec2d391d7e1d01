"""Checkpoint / resume, the port of ``vqa_tpu/engine/checkpoint.py`` without
Orbax.

The same layout and bookkeeping as the original: under the run's ``ckpt/``,
``info.json`` (``latest``, ``best``, ``best_acc``, ``epochs`` and
``step_latest``), one ``epoch_%04d/`` directory per kept epoch and at most
one mid-epoch ``inepoch_%04d_%08d/``. ``--resume {best,latest,<epoch>}``,
``--save_all_from`` and the step checkpoints keep the original's semantics.

A checkpoint directory holds
  params.npz     the float32 master parameters, '/'-keyed in flax names
                 (``weights.export_params``): it loads as
                 ``model.pretrained_params`` in either package;
  opt_state.npz  the optimizer state as named arrays
                 (``optim.state_arrays``: adam's moments by parameter key,
                 the counts, ``grad_accum``'s accumulators);
  state.json     ``{"step": n}``, the train steps taken, which seed dropout.
Each directory is written under a temporary name and renamed into place once
complete, so a half-written one is never read; ``info.json`` is replaced
atomically (tmp + ``os.replace``) after the directory it names is in place,
and a superseded directory is deleted only after that.

The arrays are whole whatever the layout the run trained under: a state
whose optimizer state is sharded over the mesh's model axis is gathered
first (``parallel.partition.gather_state``, a collective every rank of the
row calls before rank 0 saves), and a restore into a sharded state keeps
each rank's slice (``Layout.view``). A run saved by one process, under data
or tensor parallelism, resumes under any of them.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from vqa_tpu_torch.engine import optim
from vqa_tpu_torch.weights import export_params, load_params

PARAMS, OPT_STATE, STATE = "params.npz", "opt_state.npz", "state.json"


def param_keys(model) -> list:
    """The '/'-keys of the trained parameters, in ``TrainState.params``'s order."""
    return [n.replace(".", "/") for n, p in model.named_parameters() if p.requires_grad]


def _core_bias_hint(e: Exception) -> Exception:
    # a param-tree mismatch is most often a config drift between the run dir
    # and the restoring process; the known one is core_bias (b_core_q/b_core_v
    # in the MUTAN fusions, default true): older run dirs need core_bias=false
    if "b_core" in str(e) or "core_bias" in str(e):
        return RuntimeError(
            "checkpoint restore failed with a core-bias param-tree mismatch; this run dir "
            "predates fusion.core_bias=true (the default): resume with --opt "
            "model.fusion.core_bias=false (and --opt model.attention.core_bias=false for att "
            f"models) ({e})")
    return e


class CheckpointManager:
    def __init__(self, directory: str, save_all_from: Optional[int] = None):
        # created by the first write, so a reader (resolve, restore) leaves
        # no empty ckpt/ behind
        self.directory = os.path.abspath(directory)
        self.save_all_from = save_all_from

    # -- info record ---------------------------------------------------------

    @property
    def _info_path(self) -> str:
        return os.path.join(self.directory, "info.json")

    def info(self) -> Dict[str, Any]:
        if not os.path.exists(self._info_path):
            return {"latest": None, "best": None, "best_acc": None, "epochs": []}
        with open(self._info_path) as f:
            return json.load(f)

    def _write_info(self, info: Dict[str, Any]) -> None:
        tmp = self._info_path + ".tmp"
        os.makedirs(self.directory, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(info, f)
        os.replace(tmp, self._info_path)

    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:04d}")

    def _step_dir(self, epoch: int, step: int) -> str:
        return os.path.join(self.directory, f"inepoch_{epoch:04d}_{step:08d}")

    # -- one directory -------------------------------------------------------

    def _write_dir(self, path: str, state) -> None:
        """Write ``state`` (a ``steps.TrainState`` whose optimizer state is
        whole) to ``path`` through a temporary directory renamed into place
        once complete."""
        if state.layout is not None:
            raise ValueError("a sharded optimizer state: gather it on every rank first "
                             "(parallel.partition.gather_state)")
        tmp = path + ".tmp"
        if os.path.exists(tmp):  # left by a crash mid-write
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, PARAMS), **export_params(state.model))
        np.savez(os.path.join(tmp, OPT_STATE),
                 **optim.state_arrays(state.opt_state, param_keys(state.model)))
        with open(os.path.join(tmp, STATE), "w") as f:
            json.dump({"step": int(state.step)}, f)
        if os.path.exists(path):  # re-saving an epoch: the old copy goes last
            old = path + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old)
        else:
            os.rename(tmp, path)

    def _read_dir(self, path: str, state) -> None:
        """Fill ``state`` in place from ``path``: every parameter and
        optimizer array must be there with the template's shape (a sharded
        state's: this rank's slice of the whole array)."""
        if not os.path.isdir(path):
            raise FileNotFoundError(f"checkpoint directory {path} is missing")
        with np.load(os.path.join(path, PARAMS)) as npz:
            flat = {k: npz[k] for k in npz.files}
        with np.load(os.path.join(path, OPT_STATE)) as npz:
            arrays = {k: npz[k] for k in npz.files}
        with open(os.path.join(path, STATE)) as f:
            step = json.load(f)["step"]
        try:
            load_params(state.model, flat)
            opt_state = optim.state_from_arrays(
                state.opt_state, arrays, param_keys(state.model),
                view=state.layout.view if state.layout is not None else None)
        except (KeyError, ValueError) as e:
            raise _core_bias_hint(e) from e
        state.opt_state, state.step = opt_state, int(step)

    # -- save / restore ------------------------------------------------------

    def save(self, state, epoch: int, acc: Optional[float] = None) -> bool:
        """Save ``state`` for ``epoch``; returns True if this is the new best."""
        self._write_dir(self._epoch_dir(epoch), state)
        info = self.info()
        info["latest"] = epoch
        epochs = info.setdefault("epochs", [])
        if epoch not in epochs:  # re-saving an epoch (resume+retrain) is not a dup
            epochs.append(epoch)
        is_best = acc is not None and (info["best_acc"] is None or acc > info["best_acc"])
        if is_best:
            info["best"] = epoch
            info["best_acc"] = acc
        self._write_info(info)
        self._prune(info)
        return is_best

    def _prune(self, info: Dict[str, Any]) -> None:
        keep = {info.get("latest"), info.get("best")}
        for epoch in list(info.get("epochs", [])):
            if epoch in keep:
                continue
            if self.save_all_from is not None and epoch >= self.save_all_from:
                continue
            path = self._epoch_dir(epoch)
            if os.path.exists(path):
                shutil.rmtree(path)
            info["epochs"].remove(epoch)
        self._write_info(info)

    # -- mid-epoch preemption points (engine.checkpoint_steps) ----------------

    def save_step(self, state, epoch: int, next_step: int) -> None:
        """Save a mid-epoch preemption point: ``next_step`` batches of
        ``epoch`` are done, resume starts at batch index ``next_step``.
        Exactly one step checkpoint exists at a time: the new directory is
        in place, then the info record flips, then the superseded directory
        goes."""
        prev = self.info().get("step_latest")
        self._write_dir(self._step_dir(epoch, next_step), state)
        info = self.info()
        info["step_latest"] = [epoch, next_step]
        self._write_info(info)
        if prev is not None and list(prev) != [epoch, next_step]:
            old = self._step_dir(*prev)
            if os.path.exists(old):
                shutil.rmtree(old)

    def clear_step(self) -> None:
        """Drop the step checkpoint once its epoch's full save supersedes it
        (info first, then the directory)."""
        info = self.info()
        prev = info.get("step_latest")
        if prev is None:
            return
        info["step_latest"] = None
        self._write_info(info)
        old = self._step_dir(*prev)
        if os.path.exists(old):
            shutil.rmtree(old)

    def step_info(self) -> Optional[Tuple[int, int]]:
        """(epoch, next_step) of the live mid-epoch checkpoint, if any."""
        v = self.info().get("step_latest")
        return (int(v[0]), int(v[1])) if v else None

    def restore_step(self, state) -> Tuple[Any, int, int]:
        """Restore the mid-epoch checkpoint into ``state``; returns (state,
        epoch, next_step)."""
        latest = self.step_info()
        if latest is None:
            raise FileNotFoundError(f"no mid-epoch checkpoint recorded under {self.directory}")
        epoch, next_step = latest
        self._read_dir(self._step_dir(epoch, next_step), state)
        return state, epoch, next_step

    def resolve(self, which: Union[str, int]) -> int:
        info = self.info()
        if which in ("best", "latest"):
            epoch = info.get(which)
            if epoch is None:
                raise FileNotFoundError(f"no {which!r} checkpoint recorded under {self.directory}")
            return epoch
        return int(which)

    def restore(self, state, which: Union[str, int] = "latest") -> Tuple[Any, int]:
        """Restore epoch ``which`` into ``state`` (a TrainState built from the
        same options); returns (state, epoch)."""
        epoch = self.resolve(which)
        self._read_dir(self._epoch_dir(epoch), state)
        return state, epoch

    def restore_params(self, model, which: Union[str, int] = "best") -> int:
        """Load epoch ``which``'s parameters into ``model`` (an eval build
        too: they land in its dtype and on its device); returns the epoch."""
        epoch = self.resolve(which)
        path = os.path.join(self._epoch_dir(epoch), PARAMS)
        if not os.path.exists(path):
            raise FileNotFoundError(f"checkpoint directory {self._epoch_dir(epoch)} is missing")
        with np.load(path) as npz:
            flat = {k: npz[k] for k in npz.files}
        try:
            load_params(model, flat)
        except (KeyError, ValueError) as e:
            raise _core_bias_hint(e) from e
        return epoch

    @property
    def best_acc(self) -> Optional[float]:
        return self.info().get("best_acc")

