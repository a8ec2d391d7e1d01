"""Fused glimpse head, the port of ``vqa_tpu/ops/attention.py::glimpse_head``.

glimpse_head(joint [B, R, M], w [M, G], b [G], v [B, R, D])
    -> (attended [B, G, D], logits [B, R, G])

logits = joint·w + b, softmax over the R regions, attended = alphaᵀ·v. On
CUDA tensors this launches the hand-written kernel in
``csrc/glimpse_head.cu`` (bf16, one block per batch row); on CPU tensors it
takes the plain version. The logits-given variant
(``vqa_tpu/ops/attention.py::glimpse_attend``) is not ported yet.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops import _build

MAX_GLIMPSES = 4          # accumulators the kernel keeps per thread
_SMEM_LIMIT = 48 * 1024   # default dynamic shared memory per block


def glimpse_head_reference(joint: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           v: torch.Tensor):
    logits = joint @ w + b
    alpha = torch.softmax(logits, dim=1)
    return torch.einsum("brg,brd->bgd", alpha, v), logits


def glimpse_head(joint: torch.Tensor, w: torch.Tensor, b: torch.Tensor, v: torch.Tensor):
    if joint.device.type == "cpu":
        return glimpse_head_reference(joint, w, b, v)
    if joint.ndim != 3 or w.ndim != 2 or v.ndim != 3:
        raise ValueError(f"expected joint [B, R, M], w [M, G], v [B, R, D], got "
                         f"{tuple(joint.shape)}, {tuple(w.shape)}, {tuple(v.shape)}")
    B, R, M = joint.shape
    G = w.shape[1]
    D = v.shape[2]
    if not 1 <= G <= MAX_GLIMPSES:
        raise ValueError(f"the kernel takes 1..{MAX_GLIMPSES} glimpses, got {G}")
    if (M + R) * G * 4 > _SMEM_LIMIT:
        raise ValueError(f"M={M}, R={R}, G={G} exceed the kernel's shared memory")
    dev, dt = joint.device, torch.bfloat16
    _build.require("joint", joint, dev, dt, (B, R, M))
    _build.require("w", w, dev, dt, (M, G))
    _build.require("b", b, dev, dt, (G,))
    _build.require("v", v, dev, dt, (B, R, D))
    attended = torch.empty(B, G, D, dtype=dt, device=dev)
    logits = torch.empty(B, R, G, dtype=dt, device=dev)
    if B == 0:
        return attended, logits
    err = _build.library().vqa_glimpse_head(
        joint.data_ptr(), w.data_ptr(), b.data_ptr(), v.data_ptr(), attended.data_ptr(),
        logits.data_ptr(), B, R, M, G, D, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "glimpse_head")
    glimpse_head.launches += 1
    return attended, logits


glimpse_head.launches = 0
