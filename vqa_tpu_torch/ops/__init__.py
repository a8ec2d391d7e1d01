"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper takes its kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor, and counts its kernel launches in
``<wrapper>.launches`` (``lstm_seq`` runs all T steps in one launch):

  gather.gather_rows          csrc/gather.cu        <- vqa_tpu/ops/gather.py
  gather.gather_rows_dequant  csrc/gather.cu        <- the same on int8 rows, with the
                                                       dequant of vqa_tpu/engine/steps.py
  lstm.lstm_seq               csrc/lstm.cu          <- vqa_tpu/ops/lstm.py
  attention.glimpse_head      csrc/glimpse_head.cu  <- vqa_tpu/ops/attention.py
  attention.glimpse_attend    csrc/glimpse_head.cu  <- vqa_tpu/ops/attention.py
  mfb_pool.mfb_pool           csrc/mfb_pool.cu      <- vqa_tpu/ops/mfb_pool.py
  relation.relation_attend    csrc/relation.cu      <- vqa_tpu/ops/relation.py
                              csrc/relation_tc.cu   (past the tiled design's shared memory)

``gru.gru_seq`` (<- vqa_tpu/ops/gru.py) is plain PyTorch on every device:
the JAX package computes the GRU recurrence outside any Pallas kernel.

The five forward kernels of the models (``lstm_seq``, ``glimpse_head``,
``glimpse_attend``, ``mfb_pool``, ``relation_attend``) are registered torch
ops in the ``vqa_tpu_torch`` namespace (``torch.ops.vqa_tpu_torch.<name>``,
defined on ``LIB``), so that ``torch.export`` keeps them in a frozen program
(``vqa_tpu_torch/export.py``): each op's CPU implementation is the plain
version, its CUDA implementation checks the operands, launches the kernel
and counts the launch (also inside a loaded program), and its fake
implementation gives the output shapes and dtypes alone. The gathers run
before the forward and stay plain Python wrappers.

Every shape the JAX package computes has a design on the card: past the
shared memory of the others, ``relation_attend`` runs two wgmma kernels
over fp32 scratch (its "tc" design; the "split" one where TMA cannot load
the operands), the glimpse kernels split the softmax axis into chunks
merged by their log-sum-exp (``csrc/lse_merge.cuh``; ``lse_merge`` below
is its plain version) and ``mfb_pool`` keeps its roots in the output row.

Under autograd each kernel but the gathers is a ``torch.autograd.Function``:
its kernel's forward, and a plain backward, as the JAX package's vjps are
jnp. Most take the grads of their plain version on the saved inputs
(``recompute_grads``).
"""

import torch

# the dtypes every kernel of the models takes on the card, each through its
# own entry (bf16, and float32 computed in fp32 with no rounding between
# steps); a wrapper refuses any other
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# the shared memory a Hopper block may opt into: the plans' default limit (a
# wrapper passes the card's own, _build.smem_optin, at its call)
SMEM_LIMIT = 232_448
# csrc/lse_merge.cuh's kMaxMergeChunks: the chunks one merge takes (its
# weights in default shared memory)
MAX_MERGE_CHUNKS = 48 * 1024 // 4

NAMESPACE = "vqa_tpu_torch"
# the namespace of the registered ops; each op module defines its op on it
LIB = torch.library.Library(NAMESPACE, "DEF")


def register(schema: str, cpu, cuda, fake):
    """Define the op ``schema`` names on ``LIB``, with ``cpu`` (the plain
    version), ``cuda`` (the kernel's launch) and ``fake`` (output shapes and
    dtypes, for tracing and meta tensors); returns its overload."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def recompute_grads(ctx, reference, cotangents):
    """The backward of a Function whose inputs were saved whole: the grads of
    ``reference`` on the saved tensors that ``ctx`` asks grads for, from the
    cotangents of its outputs (None where a caller ignores an output); None
    for the inputs past the saved tensors (non-tensor arguments)."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        outs = reference(*inputs)
        outs = (outs,) if isinstance(outs, torch.Tensor) else outs
        pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                         allow_unused=True))
    out = [next(grads) if x.requires_grad else None for x in inputs]
    return tuple(out + [None] * (len(ctx.needs_input_grad) - len(out)))


def lse_merge(part: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The merge of softmax-weighted sums taken over C chunks of the softmax
    axis (csrc/lse_merge.cuh, in plain PyTorch): ``part`` [..., C, D] each
    chunk's ``sum_j exp(s_j - m_c) x_j``, ``m`` [..., C] its max of s and
    ``l`` [..., C] its ``sum_j exp(s_j - m_c)``; gives [..., D] =
    ``sum_c e^(m_c - m) part_c / sum_c e^(m_c - m) l_c``, m the max of m_c."""
    w = torch.exp(m - m.amax(-1, keepdim=True))
    return (w.unsqueeze(-1) * part).sum(-2) / (w * l).sum(-1, keepdim=True)
