"""Fused glimpse attention, the port of ``vqa_tpu/ops/attention.py``
(``glimpse_head`` and ``glimpse_attend``).

glimpse_head(joint [B, R, M], w [M, G], b [G], v [B, R, D])
    -> (attended [B, G, D], logits [B, R, G])
glimpse_attend(logits [B, R, G], v [B, R, D]) -> attended [B, G, D]

logits = joint·w + b (or given), softmax over axis 1, attended = alphaᵀ·v.
Both forwards are registered ops (``torch.ops.vqa_tpu_torch.glimpse_head``
and ``.glimpse_attend``): on CUDA tensors they launch the hand-written
kernel in ``csrc/glimpse_head.cu`` (bf16; glimpse_attend is its
logits-given entry) with the schedule ``glimpse_plan`` gives; on CPU tensors
they take the plain version. Each wrapper counts its own launches.

Where an input asks for grads, each call is a ``torch.autograd.Function``:
the same forward, and a backward by autograd through the plain version on
the saved inputs (a recompute), as ``vqa_tpu/ops/attention.py``'s ``_bwd``
and ``_head_bwd`` take the vjp of their jnp references. Both outputs of
glimpse_head are differentiable. Logits masked at ``finfo.min`` (MFB's
question self-attention) take a zero grad, and a row masked whole takes
uniform weights and finite grads.
"""

from __future__ import annotations

import functools

import torch

from vqa_tpu_torch.ops import _build, recompute_grads, register

SMS = 132               # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448    # shared memory a Hopper block may opt into
# csrc/glimpse_head.cu's constants, and the plan's targets
_GROUP = 4              # glimpses a thread accumulates at once
_MAX_SPLIT = 8          # the portable cluster size
_MIN_COLS = 512         # columns a split CTA keeps (128 items a glimpse group)
_CTA_BYTES = 80 * 1024  # split a row's D while its v is more than this
_STAGE_BYTES = 16 * 1024      # a ring stage
_RESIDENT_BYTES = 96 * 1024   # the most v a CTA holds at once; past it, a ring of
_RING = 4                     # this many stages
_JOINT_BYTES = 32 * 1024      # w and a CTA's joint slice staged in shared memory up to this
_TX_LIMIT = (1 << 20) - 1     # bytes one mbarrier phase can await
_COPY = {"plain": 0, "bulk": 1, "parent": 2}  # csrc/glimpse_head.cu's kMode*
_PARENT_MAX_G = 4             # accumulators a thread of the parent kernel keeps


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _align16(x: int) -> int:
    return _ceil(x, 16) * 16


def _smem_bytes(R: int, M: int, G: int, dc: int, split: int, chunk: int, stages: int,
                staged: bool) -> int:
    """csrc/glimpse_head.cu's layout().total: the barriers, alpha [R, G
    rounded up to 4] in fp32, the bias, where ``staged`` w and the CTA's
    joint slice (its ceil(R / split) regions), the ring (exactly R regions
    when it holds every chunk)."""
    gp = _ceil(G, _GROUP) * _GROUP
    regions = R if stages >= _ceil(R, chunk) else stages * chunk
    w = _align16(M * G * 2 + 16) if staged else 0
    seg = _align16(_ceil(R, split) * M * 2 + 16) if staged else 0
    return (_align16((stages + 1) * 8) + _align16(R * gp * 4) + _align16(gp * 4) + w + seg
            + _align16(regions * dc * 2))


@functools.lru_cache(maxsize=1024)
def glimpse_plan(B: int, R: int, M: int, G: int, D: int, vec: bool = True,
                 smem_limit: int = SMEM_LIMIT, sms: int = SMS, copy: str | None = None,
                 split: int | None = None) -> dict:
    """The schedule ``csrc/glimpse_head.cu`` runs for B batch rows of R
    regions, M joint features (0 for glimpse_attend), G glimpses and D
    columns of v. ``copy`` names the design:

    - "parent": the one-block-a-row kernel the file held before the ring,
      where it measured fastest on the card (PERF.md, Findings):
      glimpse_head at >= 4 x ``sms`` rows and G <= 4;
    - "bulk": the ring. ``split``: a row's D columns over a cluster of CTAs
      (the logits computed once, each CTA taking its share of the regions,
      and shared through DSMEM), while a row's v is over 80 KB (D=2048: 2),
      and again while B x split CTAs leave SMs idle (the serving batch);
      each CTA keeps >= 512 columns on a multiple of 8. ``staged``:
      glimpse_head's w and joint slice copied into shared memory ahead of v
      (up to 32 KB), else read from device memory. ``chunk`` regions a
      stage (~16 KB), ``stages`` stages: all of a CTA's v at once
      (``resident``) up to 96 KB, else 4 stages refilled as they drain;
    - "plain" (``vec=False``: D % 8 != 0, or a pointer off 16 bytes): the
      ring's generic path, one CTA a row, one stage of plain copies.

    ``copy`` and ``split`` may be forced, to probe other schedules. Raises
    ValueError, naming the limit, where even one region a stage exceeds
    ``smem_limit`` (the shared memory a block may opt into on the card).
    Cached: the wrappers ask for it at every call; the dict is shared, not
    to be changed."""
    if min(B, R, G, D) < 1 or M < 0:
        raise ValueError(f"glimpse kernels need B, R, G, D >= 1 and M >= 0, got B={B}, R={R}, "
                         f"M={M}, G={G}, D={D}")
    row_bytes = R * D * 2
    parent_smem = (M + R) * G * 4
    if copy is None:
        copy = ("parent" if M > 0 and G <= _PARENT_MAX_G and B >= 4 * sms
                and parent_smem <= smem_limit else "bulk" if vec else "plain")
    if copy == "parent":
        if G > _PARENT_MAX_G or parent_smem > smem_limit:
            raise ValueError(f"glimpse kernels: the parent kernel takes G <= {_PARENT_MAX_G} and "
                             f"{parent_smem} bytes of shared memory within {smem_limit}")
        return {"copy": copy, "split": 1, "chunk": R, "stages": 1, "staged": False,
                "resident": False, "smem_bytes": parent_smem, "ctas": B,
                "design": "one block a row, v streamed from device memory (the parent kernel)"}

    def can_split(s: int) -> bool:
        return vec and s <= _MAX_SPLIT and D % (8 * s) == 0 and D // s >= _MIN_COLS

    if split is None:
        split = 1
        while row_bytes > _CTA_BYTES * split and can_split(2 * split):
            split *= 2
        while B * split < sms and can_split(2 * split):
            split *= 2
    dc = D // split
    joint_bytes = _align16(M * G * 2 + 16) + _align16(_ceil(R, split) * M * 2 + 16)
    staged = vec and M > 0 and joint_bytes <= _JOINT_BYTES
    chunk = max(1, min(R, _STAGE_BYTES // (2 * dc)))
    chunk = _ceil(R, _ceil(R, chunk))  # the same stages, evened out
    n_chunks = _ceil(R, chunk)
    stages = 1 if not vec else n_chunks if R * dc * 2 <= _RESIDENT_BYTES else min(_RING, n_chunks)
    while _smem_bytes(R, M, G, dc, split, chunk, stages, staged) > smem_limit:
        if staged:
            staged = False
        elif stages > 1:
            stages -= 1
        elif chunk > 1:
            chunk = _ceil(chunk, 2)
        else:
            raise ValueError(
                f"glimpse kernels: R={R}, G={G}, D={D} need "
                f"{_smem_bytes(R, M, G, dc, split, 1, 1, False)} bytes of shared memory "
                f"(alpha [R, G] in fp32 and one region of {dc} columns), over the {smem_limit} "
                f"a block may opt into")
    if chunk * dc * 2 > _TX_LIMIT:
        raise ValueError(f"glimpse kernels: a stage of {chunk * dc * 2} bytes exceeds the "
                         f"{_TX_LIMIT} bytes an mbarrier phase can await")
    return {"copy": "bulk" if vec else "plain", "split": split, "chunk": chunk,
            "stages": stages, "staged": staged, "resident": stages >= _ceil(R, chunk),
            "smem_bytes": _smem_bytes(R, M, G, dc, split, chunk, stages, staged),
            "ctas": B * split,
            "design": "v, w and joint's slice by bulk copies first, a cluster split over D, "
                      "DSMEM logits"}


def _vec(D: int, *tensors) -> bool:
    return D % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def glimpse_attend_reference(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("brg,brd->bgd", torch.softmax(logits, dim=1), v)


def launch_glimpse_attend(logits: torch.Tensor, v: torch.Tensor, attended: torch.Tensor,
                          plan: dict) -> None:
    """One launch of the logits-given entry with ``plan``'s schedule."""
    B, R, G = logits.shape
    err = _build.library().vqa_glimpse_attend(
        logits.data_ptr(), v.data_ptr(), attended.data_ptr(), B, R, G, v.shape[2],
        plan["split"], plan["chunk"], plan["stages"], _COPY[plan["copy"]],
        _build.current_stream(v.device),
    )
    _build.check(err, "glimpse_attend")


class _GlimpseAttend(torch.autograd.Function):
    """The registered op ``glimpse_attend`` (the kernel on the card), and the
    grads of ``glimpse_attend_reference`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, logits, v):
        ctx.save_for_backward(logits, v)
        return _GLIMPSE_ATTEND_OP(logits, v)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(ctx, glimpse_attend_reference, (g,))


def glimpse_attend(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and (logits.requires_grad or v.requires_grad):
        return _GlimpseAttend.apply(logits, v)
    return _GLIMPSE_ATTEND_OP(logits, v)


def _glimpse_attend_cuda(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: check the operands, plan, launch, count."""
    if logits.ndim != 3 or v.ndim != 3:
        raise ValueError(f"expected logits [B, R, G] and v [B, R, D], got "
                         f"{tuple(logits.shape)}, {tuple(v.shape)}")
    B, R, G = logits.shape
    D = v.shape[2]
    dev, dt = logits.device, torch.bfloat16
    _build.require("logits", logits, dev, dt, (B, R, G))
    _build.require("v", v, dev, dt, (B, R, D))
    attended = torch.empty(B, G, D, dtype=dt, device=dev)
    if attended.numel() == 0:
        return attended
    plan = glimpse_plan(B, R, 0, G, D, vec=_vec(D, v, attended),
                        smem_limit=_build.smem_optin(dev.index or 0))
    launch_glimpse_attend(logits, v, attended, plan)
    glimpse_attend.launches += 1
    return attended


def _glimpse_attend_fake(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v.new_empty(logits.shape[0], logits.shape[2], v.shape[2])


glimpse_attend.launches = 0
_GLIMPSE_ATTEND_OP = register("glimpse_attend(Tensor logits, Tensor v) -> Tensor",
                              glimpse_attend_reference, _glimpse_attend_cuda,
                              _glimpse_attend_fake)


def glimpse_head_reference(joint: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           v: torch.Tensor):
    logits = joint @ w + b
    return glimpse_attend_reference(logits, v), logits


def launch_glimpse_head(joint, w, b, v, attended, logits, plan: dict) -> None:
    """One launch of glimpse_head with ``plan``'s schedule."""
    B, R, M = joint.shape
    err = _build.library().vqa_glimpse_head(
        joint.data_ptr(), w.data_ptr(), b.data_ptr(), v.data_ptr(), attended.data_ptr(),
        logits.data_ptr(), B, R, M, w.shape[1], v.shape[2], plan["split"],
        plan["chunk"], plan["stages"], int(plan["staged"]), _COPY[plan["copy"]],
        _build.current_stream(v.device),
    )
    _build.check(err, "glimpse_head")


class _GlimpseHead(torch.autograd.Function):
    """The registered op ``glimpse_head`` (the kernel on the card), and the
    grads of ``glimpse_head_reference`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, joint, w, b, v):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(joint, w, b, v)
        return _GLIMPSE_HEAD_OP(joint, w, b, v)

    @staticmethod
    def backward(ctx, g_att, g_logits):
        return recompute_grads(ctx, glimpse_head_reference, (g_att, g_logits))


def glimpse_head(joint: torch.Tensor, w: torch.Tensor, b: torch.Tensor, v: torch.Tensor):
    if torch.is_grad_enabled() and any(x.requires_grad for x in (joint, w, b, v)):
        return _GlimpseHead.apply(joint, w, b, v)
    return _GLIMPSE_HEAD_OP(joint, w, b, v)


def _glimpse_head_cuda(joint: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       v: torch.Tensor):
    """The op's CUDA implementation: check the operands, plan, launch, count."""
    if joint.ndim != 3 or w.ndim != 2 or v.ndim != 3:
        raise ValueError(f"expected joint [B, R, M], w [M, G], v [B, R, D], got "
                         f"{tuple(joint.shape)}, {tuple(w.shape)}, {tuple(v.shape)}")
    B, R, M = joint.shape
    G = w.shape[1]
    D = v.shape[2]
    dev, dt = joint.device, torch.bfloat16
    _build.require("joint", joint, dev, dt, (B, R, M))
    _build.require("w", w, dev, dt, (M, G))
    _build.require("b", b, dev, dt, (G,))
    _build.require("v", v, dev, dt, (B, R, D))
    attended = torch.empty(B, G, D, dtype=dt, device=dev)
    logits = torch.empty(B, R, G, dtype=dt, device=dev)
    if B == 0:
        return attended, logits
    plan = glimpse_plan(B, R, M, G, D, vec=_vec(D, v, attended),
                        smem_limit=_build.smem_optin(dev.index or 0))
    launch_glimpse_head(joint, w, b, v, attended, logits, plan)
    glimpse_head.launches += 1
    return attended, logits


def _glimpse_head_fake(joint: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       v: torch.Tensor):
    B, R, _ = joint.shape
    G = w.shape[1]
    return joint.new_empty(B, G, v.shape[2]), joint.new_empty(B, R, G)


glimpse_head.launches = 0
_GLIMPSE_HEAD_OP = register("glimpse_head(Tensor joint, Tensor w, Tensor b, Tensor v) -> "
                            "(Tensor, Tensor)",
                            glimpse_head_reference, _glimpse_head_cuda, _glimpse_head_fake)
