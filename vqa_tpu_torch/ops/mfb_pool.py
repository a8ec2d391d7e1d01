"""MFB pooling, the port of ``vqa_tpu/ops/mfb_pool.py``.

mfb_pool(z [..., k*m], k) -> [..., m]

Sum-pool over k strided groups, signed square root, row L2 normalisation.
The groups are STRIDED: ``pooled[d] = sum_j z[..., j*m + d]``, i.e.
``z.unflatten(-1, (k, m)).sum(-2)``. A contiguous ``(m, k)`` grouping would
be a silent parity break: the layout is the checkpoint contract of the
projection that feeds it (``vqa_tpu/ops/mfb_pool.py:24-29``).

The forward is the registered op ``torch.ops.vqa_tpu_torch.mfb_pool``: on
CUDA tensors it launches the hand-written kernel in ``csrc/mfb_pool.cu``
(one block per row, any row count; bf16 or float32, each dtype its own
entry of the same kernel, the output in z's dtype; any m, by the design
``mfb_plan`` gives); on CPU tensors it takes the plain version.

Where ``z`` asks for grads, the call is a ``torch.autograd.Function``: the
same forward, and a backward by autograd through ``mfb_pool_reference`` on
the saved ``z`` (a recompute), as ``vqa_tpu/ops/mfb_pool.py::_bwd`` takes
the vjp of its jnp reference, in z's dtype. The kernel pools in fp32, the
bf16 recompute rounds the pooled values and the signed square root's
derivative to bf16: on the card that leaves the grad 0.0041 (relative)
from float32 autograd, against 0.0017 for a float32 recompute, both within
the train path's 5e-2 (PERF.md, Findings).
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops import KERNEL_DTYPES, SMEM_LIMIT, _build, recompute_grads, register


def mfb_pool_reference(z: torch.Tensor, k: int) -> torch.Tensor:
    pooled = z.unflatten(-1, (k, z.shape[-1] // k)).sum(-2)
    ss = torch.sign(pooled) * torch.sqrt(pooled.abs() + 1e-12)
    return ss * torch.rsqrt((ss * ss).sum(-1, keepdim=True) + 1e-12)


class _MFBPool(torch.autograd.Function):
    """``_mfb_pool_forward`` (the kernel on the card), and the grads of
    ``mfb_pool_reference`` recomputed from the saved ``z``."""

    @staticmethod
    def forward(ctx, z, k):
        ctx.k = k
        ctx.save_for_backward(z)
        return _mfb_pool_forward(z, k)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(ctx, lambda z: mfb_pool_reference(z, ctx.k), (g,))


def mfb_pool(z: torch.Tensor, k: int) -> torch.Tensor:
    if torch.is_grad_enabled() and z.requires_grad:
        return _MFBPool.apply(z, k)
    return _mfb_pool_forward(z, k)


def _mfb_pool_forward(z: torch.Tensor, k: int) -> torch.Tensor:
    if z.ndim < 1 or k < 1 or z.shape[-1] % k:
        raise ValueError(f"the last axis of z {tuple(z.shape)} is not k={k} groups")
    return _MFB_POOL_OP(z, k)


def mfb_plan(m: int, smem_limit: int = SMEM_LIMIT) -> dict:
    """The design ``csrc/mfb_pool.cu`` runs for rows of m outputs: "shared"
    (the m fp32 signed roots in shared memory, opted in past the default 48
    KB) where they fit within ``smem_limit``, else "global" (the roots in
    the output row, scaled by the row's norm in a second sweep over it)."""
    if m < 1:
        raise ValueError(f"mfb_pool needs m >= 1, got {m}")
    if m * 4 <= smem_limit:
        return {"design": "shared", "smem_bytes": m * 4}
    return {"design": "global", "smem_bytes": 0}


def _mfb_pool_cuda(z: torch.Tensor, k: int) -> torch.Tensor:
    """The op's CUDA implementation: check the operands, plan, launch, count."""
    m = z.shape[-1] // k
    lead = tuple(z.shape[:-1])
    _build.require("z", z, z.device, KERNEL_DTYPES, lead + (k * m,))
    out = torch.empty(lead + (m,), dtype=z.dtype, device=z.device)
    if out.numel() == 0:
        return out
    plan = mfb_plan(m, _build.smem_optin(z.device.index or 0))
    lib, stream = _build.library(), _build.current_stream(z.device)
    if plan["design"] == "global":
        err = lib.vqa_mfb_pool_global(z.data_ptr(), out.data_ptr(), out.numel() // m, k, m,
                                      z.dtype.itemsize, stream)
    else:
        entry = lib.vqa_mfb_pool_f32 if z.dtype == torch.float32 else lib.vqa_mfb_pool
        err = entry(z.data_ptr(), out.data_ptr(), out.numel() // m, k, m, stream)
    _build.check(err, "mfb_pool")
    mfb_pool.launches += 1
    mfb_pool.design_launches[plan["design"]] += 1
    return out


def _mfb_pool_fake(z: torch.Tensor, k: int) -> torch.Tensor:
    return z.new_empty(tuple(z.shape[:-1]) + (z.shape[-1] // k,))


mfb_pool.launches = 0
mfb_pool.design_launches = {"shared": 0, "global": 0}  # the launches by design
_MFB_POOL_OP = register("mfb_pool(Tensor z, int k) -> Tensor", mfb_pool_reference, _mfb_pool_cuda,
                        _mfb_pool_fake)
