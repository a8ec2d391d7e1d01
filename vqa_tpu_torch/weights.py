"""Weight bridge between flax param trees and the port's modules.

A port parameter is named by its flax path with '/' replaced by '.', and
keeps flax's layout ([in, out] Dense kernels; LSTM ``wx [E, 4H]``,
``wh [H, 4H]``, ``b [4H]`` in i, f, g, o order; GRU ``wx [E, 3H]``,
``wh [H, 3H]``, ``bx``, ``bh [3H]`` in r, z, n order; MUTAN
``w_core_q [D, R*M]``),
so the bridge is a rename with no transposes. The flat '/'-keyed mapping is
what ``vqa_tpu.importers.flatten_tree`` returns and what
``importers.save_tree_npz`` and ``python -m vqa_tpu.cli.export --params
external`` write (``params.npz``). A training build (float32 parameters,
``models.factory(..., train=True)``) loads a flax tree and exports its
trained parameters the same way.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


def _key(name: str) -> str:
    return name.replace(".", "/")


def load_params(model: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Fill every parameter of ``model`` from ``flat``, in the model's dtype
    and on its device. A missing, extra or wrongly shaped key raises."""
    params = {_key(name): p for name, p in model.named_parameters()}
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"param keys differ from the model's: missing {missing}, extra {extra}")
    for key, p in params.items():
        value = np.asarray(flat[key])
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)}, model expects {tuple(p.shape)}")
        if value.dtype.name == "bfloat16":  # ml_dtypes bf16 from a bf16 flax tree
            value = value.astype(np.float32)
        with torch.no_grad():
            p.copy_(torch.tensor(value))


def export_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters as a '/'-keyed mapping of numpy arrays, copies
    that later training steps leave as they are (bf16 parameters come back as
    float32, which numpy can hold)."""
    out = {}
    for name, p in model.named_parameters():
        dtype = torch.float32 if p.dtype == torch.bfloat16 else p.dtype
        out[_key(name)] = p.detach().to("cpu", dtype, copy=True).numpy()
    return out


def random_params(model: nn.Module, seed: int) -> None:
    """Seeded random weights: embedding tables N(0, 1) (as torch's
    nn.Embedding), other matrices N(0, 1/fan_in) with fan_in their first axis
    (flax's lecun_normal for [in, out] kernels), vectors zero. Drawn on the
    CPU from one ``torch.Generator``, so the values do not depend on the
    device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("embedding"):
                value = torch.randn(p.shape, generator=gen)
            elif p.ndim >= 2:
                value = torch.randn(p.shape, generator=gen) / p.shape[0] ** 0.5
            else:
                value = torch.zeros(p.shape)
            p.copy_(value)


def pretrained_params(model_opt: Any, params: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The '/'-keyed weights a run's ``model`` options name, in the order
    ``vqa_tpu/cli/train.py::init_params`` grafts them:
    ``seq2vec.pretrained_emb`` under encoder/embed/,
    ``seq2vec.pretrained_encoder`` under encoder/, then ``params`` (default
    ``model.pretrained_params``) over both. Unlike there, no init fills the
    leaves they leave out: ``load_params`` refuses a missing one."""
    flat: Dict[str, np.ndarray] = {}
    seq2vec = model_opt.seq2vec or {}
    grafts = ((seq2vec.get("pretrained_emb"), "encoder/embed/"),
              (seq2vec.get("pretrained_encoder"), "encoder/"),
              (params or model_opt.pretrained_params, ""))
    for path, prefix in grafts:
        if path:
            with np.load(path) as npz:
                flat.update({prefix + k: npz[k] for k in npz.files})
    return flat
