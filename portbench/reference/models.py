"""The forward pass in plain float32 PyTorch, and its building blocks.

``forward(cfg, P, tokens, visual, ...)`` gives the answer logits of a block
of questions: ``tokens`` int [B, T] with 0 as padding after each question's
last word, ``visual`` [B, R, Dv] region features, ``P`` the parameters of
``params.param_spec``. The question encoder is the file
``encoders/<seq2vec.arch>.py`` and the rest of the model the file
``archs/<arch>.py`` (``plugins.load``); a new architecture or encoder is a
new file there, built from the blocks below (``dense``, ``tanh``,
``mutan``). An encoder runs each question over its own words only, so a
block may mix lengths.

Dropout, where ``drop`` is given, follows the program's documented stream:
one generator a train step, seeded by (seed, step) (``dropout_generator``),
a uniform draw of the input's shape at each dropout site in the order of
the published layer description, kept where the draw is below 1 - rate.

With ``fp8`` the model is computed in float8, the precision below the
bfloat16 the configurations state, as the program is in bfloat16: every
matrix product takes operands rounded to float8 e4m3 and sums in float32,
and every tensor that the bfloat16 program stores between its ops (each
layer's output, an activation, a product, a softmax, the LSTM's h and c
after each step) is stored in e4m3, each under one per-tensor scale;
the train step's gradients pass in e5m2. Without it everything is float32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from portbench import plugins

Params = Dict[str, torch.Tensor]


def dropout_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The program's dropout stream of one train step on the data rank
    ``rank``: a pure function of (seed, step), the rank folded in past the
    first."""
    entropy = [seed, step] + ([rank] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2 ** 63 - 1))


class Dropout:
    """Inverted dropout drawing from one generator; without one, identity."""

    def __init__(self, gen: Optional[torch.Generator]):
        self.gen = gen

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.gen is None or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.gen, device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _q8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under one scale that maps its
    largest magnitude to the format's largest, back in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


class _MatMulFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a, torch.float8_e4m3fn), _q8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = (a.shape, b.shape)
        return qa @ qb

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        g = _q8(grad, torch.float8_e5m2)
        da = (g @ qb.transpose(-1, -2)).sum_to_size(ctx.shapes[0])
        db = (qa.transpose(-1, -2) @ g).sum_to_size(ctx.shapes[1])
        return da, db


class _StoreFP8(torch.autograd.Function):
    """A tensor stored in e4m3; its gradient passed in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _q8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _q8(grad, torch.float8_e5m2)


class Precision:
    """``mm``, the matrix product, and ``st``, the storage of a tensor
    between ops: float32 throughout, or float8."""

    def __init__(self, fp8: bool):
        self.mm: Callable = _MatMulFP8.apply if fp8 else torch.matmul
        self.st: Callable = _StoreFP8.apply if fp8 else (lambda x: x)


def dense(P: Params, name: str, x: torch.Tensor, p: Precision) -> torch.Tensor:
    """The Dense layer ``name`` (``kernel [in, out]``, ``bias``)."""
    return p.st(p.mm(x, P[f"{name}/kernel"]) + P[f"{name}/bias"])


def tanh(x: torch.Tensor, p: Precision) -> torch.Tensor:
    return p.st(torch.tanh(x))


def mutan(P: Params, name: str, opt: dict, q, v, drop: Dropout, p: Precision) -> torch.Tensor:
    """MUTAN's Tucker fusion: tanh of the rank-R sum of the core products
    of the projected q and v (leading dimensions broadcast)."""
    q = tanh(dense(P, f"{name}/q_proj", drop(q, opt["dropout_q"]), p), p)
    v = tanh(dense(P, f"{name}/v_proj", drop(v, opt["dropout_v"]), p), p)
    q, v = drop(q, opt.get("dropout_hq", 0.0)), drop(v, opt.get("dropout_hv", 0.0))
    qr = p.st(p.mm(q, P[f"{name}/w_core_q"]) + P[f"{name}/b_core_q"])
    vr = p.st(p.mm(v, P[f"{name}/w_core_v"]) + P[f"{name}/b_core_v"])
    R, M = opt["R"], opt["dim_mm"]
    return tanh(p.st((p.st(qr * vr)).unflatten(-1, (R, M)).sum(dim=-2)), p)


def encoder(cfg: dict):
    """The question encoder's file, by ``model.seq2vec.arch``."""
    return plugins.load("reference/encoders", cfg["model"]["seq2vec"]["arch"])


def arch(cfg: dict):
    """The architecture's file, by ``model.arch``."""
    return plugins.load("reference/archs", cfg["model"]["arch"])


def forward(cfg: dict, P: Params, tokens: torch.Tensor, visual: torch.Tensor,
            gen: Optional[torch.Generator] = None, fp8: bool = False) -> torch.Tensor:
    """Answer logits [B, num_answers] in float32; dropout on where ``gen``
    (the step's generator) is given. The encoder runs first, then the
    architecture, each drawing its dropout in its layer order."""
    p, drop = Precision(fp8), Dropout(gen)
    q = encoder(cfg).encode(cfg, P, tokens, drop, p)
    return arch(cfg).forward(cfg, P, q, p.st(visual.float()), drop, p)
