"""Weight bridge between flax param trees and the port's modules.

A port parameter is named by its flax path with '/' replaced by '.', and
keeps flax's layout ([in, out] Dense kernels; LSTM ``wx [E, 4H]``,
``wh [H, 4H]``, ``b [4H]`` in i, f, g, o order; MUTAN ``w_core_q [D, R*M]``),
so the bridge is a rename with no transposes. The flat '/'-keyed mapping is
what ``vqa_tpu.importers.flatten_tree`` returns and what
``importers.save_tree_npz`` and ``python -m vqa_tpu.cli.export --params
external`` write (``params.npz``).
"""

from __future__ import annotations

from typing import Dict, Mapping

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
    """The model's parameters as a '/'-keyed mapping of numpy arrays (bf16
    parameters come back as float32, which numpy can hold)."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[_key(name)] = t.numpy()
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
