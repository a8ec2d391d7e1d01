"""MUTAN fusion, the port of ``vqa_tpu/models/fusion.py`` (MutanFusion).

z = tanh(sum_r act_hq(q~ W_q + b_q)_r * act_hv(v~ W_v + b_v)_r), with
q~ = act_q(q_proj(q)) and v~ = act_v(v_proj(v)). The ``[*, R*M]`` core
columns reshape to ``(R, M)`` rank-major, as in flax. Leading dimensions of
q and v broadcast (the attention applies the fusion per region). Dropout is
a training-time knob and this slice is inference only, so it is accepted by
the factory and not applied.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from vqa_tpu_torch.models.layers import Dense, param

_ACT = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "none": lambda x: x,
    None: lambda x: x,
}


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=dim, keepdim=True) + eps)


class MutanFusion(nn.Module):
    """Rank-R Tucker-core fusion of q [..., dim_q] and v [..., dim_v]."""

    def __init__(
        self,
        dim_q: int,
        dim_v: int,
        dim_hq: int = 310,
        dim_hv: int = 310,
        dim_mm: int = 510,
        R: int = 5,
        activation_q: str = "tanh",
        activation_v: str = "tanh",
        activation_hq: str = "none",
        activation_hv: str = "none",
        project_inputs: bool = True,
        core_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        device="cpu",
    ):
        super().__init__()
        self.R, self.dim_mm = R, dim_mm
        self.act_q, self.act_v = _ACT[activation_q], _ACT[activation_v]
        self.act_hq, self.act_hv = _ACT[activation_hq], _ACT[activation_hv]
        self.project_inputs = project_inputs
        self.core_bias = core_bias
        if project_inputs:
            self.q_proj = Dense(dim_q, dim_hq, dtype, device)
            self.v_proj = Dense(dim_v, dim_hv, dtype, device)
            dim_q, dim_v = dim_hq, dim_hv
        self.w_core_q = param(dim_q, R * dim_mm, dtype=dtype, device=device)
        self.w_core_v = param(dim_v, R * dim_mm, dtype=dtype, device=device)
        if core_bias:
            self.b_core_q = param(R * dim_mm, dtype=dtype, device=device)
            self.b_core_v = param(R * dim_mm, dtype=dtype, device=device)

    def forward(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if self.project_inputs:
            q = self.act_q(self.q_proj(q))
            v = self.act_v(self.v_proj(v))
        qr = q @ self.w_core_q
        vr = v @ self.w_core_v
        if self.core_bias:
            qr = qr + self.b_core_q
            vr = vr + self.b_core_v
        qr = self.act_hq(qr).unflatten(-1, (self.R, self.dim_mm))
        vr = self.act_hv(vr).unflatten(-1, (self.R, self.dim_mm))
        return torch.tanh((qr * vr).sum(dim=-2))


# the knobs flax's MutanFusion takes (vqa_tpu/models/fusion.py:87-105)
MUTAN_KEYS = {
    "dim_hq", "dim_hv", "dim_mm", "R", "dropout_q", "dropout_v", "dropout_hq",
    "dropout_hv", "activation_q", "activation_v", "activation_hq", "activation_hv",
    "project_inputs", "core_bias",
}
_DROPOUT_KEYS = {"dropout_q", "dropout_v", "dropout_hq", "dropout_hv"}
_NOT_PORTED = {"concat": "queue 1 item 6", "mlb": "queue 1 item 6", "mfb": "queue 1 item 7",
               "mfh": "queue 1 item 7"}


def factory(opt: Dict[str, Any], dim_q: int, dim_v: int, dtype=torch.float32,
            device="cpu") -> MutanFusion:
    """Build the final fusion from the model.fusion config dict."""
    arch = opt.get("arch", "mutan")
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"fusion arch {arch!r} is not ported yet: ROADMAP.md {_NOT_PORTED[arch]}"
        )
    if arch != "mutan":
        raise KeyError(f"unknown fusion arch {arch!r}")
    kwargs = {k: v for k, v in opt.items() if k != "arch"}
    unknown = set(kwargs) - MUTAN_KEYS
    if unknown:
        raise KeyError(
            f"fusion arch 'mutan' got unknown option(s) {sorted(unknown)}; "
            f"valid: {sorted(MUTAN_KEYS)}"
        )
    kwargs = {k: v for k, v in kwargs.items() if k not in _DROPOUT_KEYS}
    return MutanFusion(dim_q, dim_v, dtype=dtype, device=device, **kwargs)
