"""Weight bridge between flax param trees and the port's modules.

A port parameter is named by its flax path with '/' replaced by '.', and
keeps flax's layout ([in, out] Dense kernels; LSTM ``wx [E, 4H]``,
``wh [H, 4H]``, ``b [4H]`` in i, f, g, o order; GRU ``wx [E, 3H]``,
``wh [H, 3H]``, ``bx``, ``bh [3H]`` in r, z, n order; MUTAN
``w_core_q [D, R*M]``),
so the bridge is a rename with no transposes. The flat '/'-keyed mapping is
what ``vqa_tpu.importers.flatten_tree`` returns and what
``importers.save_tree_npz`` writes, and the ``params.npz`` that ``python -m
vqa_tpu_torch.cli.export --params external`` writes (as the JAX package's
export CLI does). A training build (float32 parameters,
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
    """Seeded random weights for tests and smoke runs (not flax's init: see
    ``init_params``): embedding tables N(0, 1) (as torch's nn.Embedding),
    other matrices an untruncated N(0, 1/fan_in) with fan_in their first
    axis, vectors zero. Drawn on the CPU from one ``torch.Generator``, so
    the values do not depend on the device."""
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


# the stddev of a standard normal truncated to (-2, 2): flax's lecun_normal
# divides by it so the truncated draw keeps variance 1/fan_in
_TRUNCATED_STD = 0.87962566103423978


def _lecun_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: a normal truncated to +-2 of its scale, with
    variance 1/fan_in (fan_in the second-to-last axis times the axes before
    it, as ``variance_scaling`` reckons a kernel [..., in, out])."""
    fan_in = int(np.prod(shape[:-1]))
    value = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0, generator=gen)
    return value * (fan_in ** -0.5 / _TRUNCATED_STD)


# LAPACK's blocked QR sums in an order set by its thread count, so the QR
# runs on this many threads whatever the process's own count (torchrun, for
# one, starts its workers with OMP_NUM_THREADS=1): a seed then gives every
# process of a run the same ``wh``
QR_THREADS = 4


def _orthogonal(shape, gen: torch.Generator) -> torch.Tensor:
    """flax ``orthogonal`` (column axis -1): QR of a normal
    [max(n, m), min(n, m)] draw, the columns' signs set by R's diagonal,
    transposed when the rows are fewer: orthonormal rows for ``wh [H, kH]``."""
    n_cols = shape[-1]
    n_rows = int(np.prod(shape)) // n_cols
    z = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)), generator=gen)
    threads = torch.get_num_threads()
    torch.set_num_threads(QR_THREADS)
    try:
        q, r = torch.linalg.qr(z)
    finally:
        torch.set_num_threads(threads)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape)


def init_params(model: nn.Module, seed: int) -> None:
    """Fill ``model`` with flax's initial distributions, the counterpart of
    ``vqa_tpu/cli/train.py::init_params``: ``lecun_normal`` (truncated) for
    every kernel (Dense ``kernel``, ``wx``, ``w_core_*``, the glimpse
    ``kernel``), ``orthogonal`` for the recurrent ``wh``, zeros for every
    vector (biases), and ``nn.Embed``'s default for ``embedding``: an
    untruncated normal of std 1/sqrt(features). The draws come from one
    CPU ``torch.Generator`` seeded with ``seed``, in parameter order, so a
    seed gives the same weights on every device; they are not flax's values
    (another generator), only its distributions."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            if p.ndim < 2:
                value = torch.zeros(shape)
            elif name.endswith("embedding"):
                value = torch.randn(shape, generator=gen) * shape[-1] ** -0.5
            elif name.endswith("wh"):
                value = _orthogonal(shape, gen)
            else:
                value = _lecun_normal(shape, gen)
            p.copy_(value)


def graft_params(model: nn.Module, flat: Mapping[str, np.ndarray], label: str) -> None:
    """Overwrite the leaves of ``model`` that ``flat`` names, keeping the
    rest (``vqa_tpu/cli/train.py::_graft_npz``): every key must name a
    parameter of the same shape."""
    params = {_key(name): p for name, p in model.named_parameters()}
    for key, value in flat.items():
        if key not in params:
            raise KeyError(f"{label} leaf {key!r} not in the param tree "
                           "(wrong --cell/arch/config?)")
        value = np.asarray(value)
        if tuple(value.shape) != tuple(params[key].shape):
            raise ValueError(
                f"{label} {key}: shape {value.shape} != {tuple(params[key].shape)} (embedding "
                "rows must be re-aligned to this run's vocab)")
        if value.dtype.name == "bfloat16":
            value = value.astype(np.float32)
        with torch.no_grad():
            params[key].copy_(torch.tensor(value))


def pretrained_params(model_opt: Any, params: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The '/'-keyed weights a run's ``model`` options name, in the order
    ``vqa_tpu/cli/train.py::init_params`` grafts them:
    ``seq2vec.pretrained_emb`` under encoder/embed/,
    ``seq2vec.pretrained_encoder`` under encoder/, then ``params`` (default
    ``model.pretrained_params``) over both. The train CLI grafts them over
    the init (``graft_params``); eval-only loads them alone, where
    ``load_params`` refuses a leaf they leave out."""
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
