"""CNN feature extractor for the offline grid path, the port of
``vqa_tpu/models/convnets.py``.

ResNet-{50,101,152} producing the grid features the reference lineage
extracts with torchvision: a [14x14, 2048] grid at 448x448 ('att' mode,
stored region-major, h then w, as the attention kernels consume it) or a
pooled [2048] vector ('noatt').

The modules keep flax's names (``stem``, ``bn_stem``, ``s{stage}_b{block}``
with ``conv1..3``, ``bn1..3``, ``proj``, ``bn_proj``). The input is NHWC
images, as the JAX package takes them; inside, the convs run on its NCHW
view in ``channels_last`` memory through ``F.conv2d`` (cuDNN on the card):
the JAX convs are XLA, outside any Pallas kernel, so no kernel is ported
here. Parameters stay float32; with ``dtype=torch.bfloat16`` the convs
compute in bf16 and each BatchNorm normalizes in float32 and rounds its
output to bf16, as flax's ``dtype=`` does.

Weights come from the flax variables tree ``{'params', 'batch_stats'}``
flattened with '/' (the npz ``cli/extract.py --params`` reads and
``python -m vqa_tpu_torch.tools.import_torch --kind resnet152`` writes):
``load_variables`` transposes each conv kernel [kh, kw, I, O] to torch's
[O, I, kh, kw] once, and fills BatchNorm's weight, bias and running
statistics; ``init_variables`` draws flax's initial distributions.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_DEPTHS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: ``weight [O, I, kh, kw]``, computed in
    the input's dtype with symmetric zero padding. (flax's SAME on the 1x1
    stride-2 ``proj`` pads nothing at any size: padding 0.)"""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)``, epsilon 1e-5: the
    statistics and the affine in float32, the output in the input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, 1e-5)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = Conv(c_in, features, 1)
        self.bn1 = BatchNorm(features)
        # explicit pad 1 (not SAME) on the strided 3x3, as the torchvision
        # lineage pads (vqa_tpu/models/convnets.py)
        self.conv2 = Conv(features, features, 3, strides, 1)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv(features, features * 4, 1)
        self.bn3 = BatchNorm(features * 4)
        self.has_proj = strides != 1 or c_in != features * 4  # flax: the shapes differ
        if self.has_proj:
            self.proj = Conv(c_in, features * 4, 1, strides)
            self.bn_proj = BatchNorm(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = F.relu(self.bn2(self.conv2(y)), inplace=True)
        y = self.bn3(self.conv3(y))
        residual = self.bn_proj(self.proj(x)) if self.has_proj else x
        return F.relu(y.add_(residual), inplace=True)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv(3, 64, 7, 2, 3)
        self.bn_stem = BatchNorm(64)
        self.blocks = []
        c_in = 64
        for stage, n_blocks in enumerate(stage_sizes):
            for block in range(n_blocks):
                name = f"s{stage}_b{block}"
                setattr(self, name, Bottleneck(c_in, 64 * 2**stage,
                                               2 if stage > 0 and block == 0 else 1))
                self.blocks.append(name)
                c_in = 64 * 2**stage * 4

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 448, 448, 3] -> conv5 grid [B, 14, 14, 2048] in
        ``dtype``."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        x = F.relu(self.bn_stem(self.stem(x)), inplace=True)
        x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf, as flax's max_pool
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1)


def factory(arch: str, dtype: torch.dtype = torch.float32) -> ResNet:
    if arch not in _DEPTHS:
        raise KeyError(f"unknown convnet {arch!r}; known: {sorted(_DEPTHS)}")
    return ResNet(_DEPTHS[arch], dtype)


def grid_features(grid: torch.Tensor, mode: str) -> torch.Tensor:
    """conv5 [B, 14, 14, 2048] -> 'att' [B, 196, 2048] | 'noatt' [B, 2048]."""
    b, h, w, d = grid.shape
    if mode == "att":
        return grid.reshape(b, h * w, d)
    if mode == "noatt":
        return grid.mean(dim=(1, 2))
    raise KeyError(f"mode must be att|noatt, got {mode!r}")


# ------------------------------------------------------- the variables bridge

_BN_LEAVES = (("params", "scale", "weight"), ("params", "bias", "bias"),
              ("batch_stats", "mean", "running_mean"), ("batch_stats", "var", "running_var"))


def _targets(model: ResNet) -> Dict[str, tuple]:
    """flax variable key -> (tensor, is a conv kernel), in module order."""
    out = {}
    for name, module in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(module, Conv):
            out[f"params/{path}/kernel"] = (module.weight, True)
        elif isinstance(module, BatchNorm):
            for collection, leaf, attr in _BN_LEAVES:
                out[f"{collection}/{path}/{leaf}"] = (getattr(module, attr), False)
    return out


def _flax_shape(tensor: torch.Tensor, kernel: bool) -> tuple:
    shape = tuple(tensor.shape)
    return (shape[2], shape[3], shape[1], shape[0]) if kernel else shape


def load_variables(model: ResNet, flat: Mapping[str, np.ndarray]) -> None:
    """Fill ``model`` from the '/'-keyed flax variables (``params/...`` and
    ``batch_stats/...``), conv kernels transposed from [kh, kw, I, O] to
    [O, I, kh, kw]. A missing, extra or wrongly shaped key raises."""
    targets = _targets(model)
    missing = sorted(set(targets) - set(flat))
    extra = sorted(set(flat) - set(targets))
    if missing or extra:
        raise KeyError(f"variable keys differ from the ResNet's: missing {missing}, "
                       f"extra {extra}")
    for key, (tensor, kernel) in targets.items():
        value = np.array(flat[key], np.float32)  # a copy: npz and jax arrays are read-only
        if value.shape != _flax_shape(tensor, kernel):
            raise ValueError(f"{key}: shape {value.shape}, model expects "
                             f"{_flax_shape(tensor, kernel)}")
        value = torch.from_numpy(value.transpose(3, 2, 0, 1) if kernel else value)
        with torch.no_grad():
            tensor.copy_(value)


def export_variables(model: ResNet) -> Dict[str, np.ndarray]:
    """The model's variables as ``load_variables`` reads them (float32,
    flax's layout)."""
    out = {}
    for key, (tensor, kernel) in _targets(model).items():
        value = tensor.detach().to("cpu", torch.float32).numpy()
        out[key] = np.ascontiguousarray(value.transpose(2, 3, 1, 0) if kernel else value)
    return out


def init_variables(model: ResNet, seed: int) -> None:
    """flax's initial distributions: ``lecun_normal`` (truncated) conv
    kernels, drawn in flax's layout [kh, kw, I, O] from one CPU
    ``torch.Generator`` seeded with ``seed`` in module order; BatchNorm
    scale 1, bias 0, mean 0, var 1. Not flax's values (another
    generator), only its distributions."""
    from vqa_tpu_torch.weights import _lecun_normal

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key, (tensor, kernel) in _targets(model).items():
            if kernel:
                tensor.copy_(_lecun_normal(_flax_shape(tensor, True), gen).permute(3, 2, 0, 1))
            else:
                tensor.fill_(1.0 if key.endswith(("/scale", "/var")) else 0.0)
