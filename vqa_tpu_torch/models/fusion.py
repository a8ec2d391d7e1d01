"""Fusions, the port of ``vqa_tpu/models/fusion.py`` (ConcatFusion,
MLBFusion, MutanFusion, MFBFusion, MFHFusion).

Concat: z = [q; v], q and v broadcast to one leading shape first.

MLB: z = act_q(q_proj(q)) * act_v(v_proj(v)) (a Hadamard product).

MUTAN: z = tanh(sum_r act_hq(q~ W_q + b_q)_r * act_hv(v~ W_v + b_v)_r),
with q~ = act_q(q_proj(q)) and v~ = act_v(v_proj(v)). The ``[*, R*M]``
core columns reshape to ``(R, M)`` rank-major, as in flax.

MFB: z = q_proj(q) * v_proj(v) (times the previous block's z in MFH), then
``ops.mfb_pool.mfb_pool`` (strided k-sum-pool, signed sqrt, L2). MFH
cascades ``mfh_order`` MFB blocks and concatenates their pooled outputs.

Leading dimensions of q and v broadcast (the attention applies the fusion
per region). Each fusion's ``out_dim`` is the width of what it returns.
Dropout sits where the flax fusions apply it, with their default rates, and
is on only when ``forward`` gets the train step's ``rng``: MFB/MFH's
``dropout_pre`` drops the product z after the previous block's z has
multiplied it and before the pool, so MFH cascades the dropped z.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from vqa_tpu_torch.models.layers import Dense, dropout, param
from vqa_tpu_torch.ops.mfb_pool import mfb_pool

_ACT = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "none": lambda x: x,
    None: lambda x: x,
}


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=dim, keepdim=True) + eps)


class ConcatFusion(nn.Module):
    """z = [q; v] over the broadcast leading dims: ``[..., dim_q + dim_v]``."""

    def __init__(self, dim_q: int, dim_v: int, dropout_q: float = 0.0, dropout_v: float = 0.0,
                 dtype: torch.dtype = torch.float32, device="cpu"):
        super().__init__()
        self.out_dim = dim_q + dim_v
        self.dropout_q, self.dropout_v = dropout_q, dropout_v

    def forward(self, q: torch.Tensor, v: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        q = dropout(q, self.dropout_q, rng)
        v = dropout(v, self.dropout_v, rng)
        lead = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
        return torch.cat([q.expand(lead + q.shape[-1:]), v.expand(lead + v.shape[-1:])], dim=-1)


class MLBFusion(nn.Module):
    """Low-rank bilinear fusion: ``act_q(q_proj(q)) * act_v(v_proj(v))``,
    ``[..., dim_h]``."""

    def __init__(self, dim_q: int, dim_v: int, dim_h: int = 1200, dropout_q: float = 0.5,
                 dropout_v: float = 0.5, activation_q: str = "tanh", activation_v: str = "tanh",
                 dtype: torch.dtype = torch.float32, device="cpu"):
        super().__init__()
        self.out_dim = dim_h
        self.dropout_q, self.dropout_v = dropout_q, dropout_v
        self.act_q, self.act_v = _ACT[activation_q], _ACT[activation_v]
        self.q_proj = Dense(dim_q, dim_h, dtype, device)
        self.v_proj = Dense(dim_v, dim_h, dtype, device)

    def forward(self, q: torch.Tensor, v: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        q = dropout(q, self.dropout_q, rng)
        v = dropout(v, self.dropout_v, rng)
        return self.act_q(self.q_proj(q)) * self.act_v(self.v_proj(v))


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
        dropout_q: float = 0.5,
        dropout_v: float = 0.5,
        dropout_hq: float = 0.0,
        dropout_hv: float = 0.0,
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
        self.out_dim = dim_mm
        self.dtype = dtype
        self.dropout_q, self.dropout_v = dropout_q, dropout_v
        self.dropout_hq, self.dropout_hv = dropout_hq, dropout_hv
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

    def forward(self, q: torch.Tensor, v: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.project_inputs:
            q = dropout(q, self.dropout_q, rng)
            v = dropout(v, self.dropout_v, rng)
            q = self.act_q(self.q_proj(q))
            v = self.act_v(self.v_proj(v))
        q = dropout(q, self.dropout_hq, rng)
        v = dropout(v, self.dropout_hv, rng)
        qr = q @ self.w_core_q.to(self.dtype)
        vr = v @ self.w_core_v.to(self.dtype)
        if self.core_bias:
            qr = qr + self.b_core_q.to(self.dtype)
            vr = vr + self.b_core_v.to(self.dtype)
        qr = self.act_hq(qr).unflatten(-1, (self.R, self.dim_mm))
        vr = self.act_hv(vr).unflatten(-1, (self.R, self.dim_mm))
        return torch.tanh((qr * vr).sum(dim=-2))


class MFBFusion(nn.Module):
    """Multi-modal factorized bilinear pooling: returns ``(pooled [..., dim_mm],
    z [..., pool_factor*dim_mm])``, z being the (dropped) pre-pool product
    MFH cascades."""

    def __init__(self, dim_q: int, dim_v: int, pool_factor: int = 5, dim_mm: int = 1000,
                 dropout_pre: float = 0.1, dtype: torch.dtype = torch.float32, device="cpu"):
        super().__init__()
        self.pool_factor, self.dim_mm = pool_factor, dim_mm
        self.dropout_pre = dropout_pre
        self.out_dim = dim_mm
        self.q_proj = Dense(dim_q, pool_factor * dim_mm, dtype, device)
        self.v_proj = Dense(dim_v, pool_factor * dim_mm, dtype, device)

    def pre_pool(self, q: torch.Tensor, v: torch.Tensor, prev: Optional[torch.Tensor] = None,
                 rng: Optional[torch.Generator] = None) -> torch.Tensor:
        z = self.q_proj(q) * self.v_proj(v)
        if prev is not None:
            z = z * prev
        return dropout(z, self.dropout_pre, rng)

    def pool(self, z: torch.Tensor) -> torch.Tensor:
        return mfb_pool(z.contiguous(), self.pool_factor)

    def forward(self, q: torch.Tensor, v: torch.Tensor, prev: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None):
        z = self.pre_pool(q, v, prev, rng)
        return self.pool(z), z


class MFHFusion(nn.Module):
    """``mfh_order`` cascaded MFB blocks ``mfb_0..``; block i multiplies its
    product by block i-1's pre-pool z (not its pooled output); the pooled
    outputs are concatenated: ``[..., mfh_order*dim_mm]``."""

    def __init__(self, dim_q: int, dim_v: int, pool_factor: int = 5, dim_mm: int = 1000,
                 mfh_order: int = 2, dropout_pre: float = 0.1,
                 dtype: torch.dtype = torch.float32, device="cpu"):
        super().__init__()
        self.mfh_order, self.dim_mm = mfh_order, dim_mm
        self.out_dim = mfh_order * dim_mm
        for i in range(mfh_order):
            setattr(self, f"mfb_{i}", MFBFusion(dim_q, dim_v, pool_factor, dim_mm, dropout_pre,
                                                dtype, device))

    def forward(self, q: torch.Tensor, v: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        outs, prev = [], None
        for i in range(self.mfh_order):
            out, prev = getattr(self, f"mfb_{i}")(q, v, prev=prev, rng=rng)
            outs.append(out)
        return torch.cat(outs, dim=-1)


# the knobs each flax fusion takes (its dataclass fields but dtype,
# vqa_tpu/models/fusion.py:44-186), checked exactly per arch as
# vqa_tpu/models/fusion.py:198-217 does
_FUSIONS = {
    "concat": (ConcatFusion, {"dropout_q", "dropout_v"}),
    "mlb": (MLBFusion, {"dim_h", "dropout_q", "dropout_v", "activation_q", "activation_v"}),
    "mutan": (MutanFusion, {
        "dim_hq", "dim_hv", "dim_mm", "R", "dropout_q", "dropout_v", "dropout_hq",
        "dropout_hv", "activation_q", "activation_v", "activation_hq", "activation_hv",
        "project_inputs", "core_bias",
    }),
    "mfb": (MFBFusion, {"pool_factor", "dim_mm", "dropout_pre"}),
    "mfh": (MFHFusion, {"pool_factor", "dim_mm", "mfh_order", "dropout_pre"}),
}


def factory(opt: Dict[str, Any], dim_q: int, dim_v: int, dtype=torch.float32,
            device="cpu") -> nn.Module:
    """Build a fusion from the model.fusion config dict."""
    arch = opt.get("arch", "mutan")
    if arch not in _FUSIONS:
        raise KeyError(f"unknown fusion arch {arch!r}; known: {sorted(_FUSIONS)}")
    cls, valid = _FUSIONS[arch]
    kwargs = {k: v for k, v in opt.items() if k != "arch"}
    unknown = set(kwargs) - valid
    if unknown:
        raise KeyError(
            f"fusion arch {arch!r} got unknown option(s) {sorted(unknown)}; "
            f"valid: {sorted(valid)}"
        )
    return cls(dim_q, dim_v, dtype=dtype, device=device, **kwargs)
