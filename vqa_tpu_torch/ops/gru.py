"""Masked GRU recurrence, the port of ``vqa_tpu/ops/gru.py``.

gru_seq(gx [T, B, 3H], mask [T, B, 1], wh [H, 3H], bh [3H]) -> (h_last [B, H],
seq [T, B, H])

``gx`` is the input-side projection for all T steps (``x @ wx + bx``),
computed beforehand by one GEMM (models/seq2vec.py). Gates are in r, z, n
order, and ``bh`` enters inside the reset gate's product:
n = tanh(gx_n + r * (h @ wh_n + bh_n)). Where the mask is 0, h stays frozen
and ``seq`` is 0, so ``h_last`` is each row's last real step whichever side
the padding is on.

The JAX package runs this recurrence as an XLA ``lax.scan``, not as a Pallas
kernel, so the port's version is plain PyTorch on every device: a loop of T
steps, each one matmul and the gate math. As there, the recurrent product is
taken in the compute dtype (``gx``'s) and ``bh`` is cast to it; ``bh`` may
arrive as the raw float32 parameter (models/seq2vec.py::GRULayer).

Where grads are asked for:

- ``train=True`` with ``rnn_bwd="bigmatmul"`` (``engine.rnn_bwd``'s
  default): ``_GRUSeq``, the port of ``_gru_seq_bigmatmul``. Its forward
  (``_bm_fwd``) saves the carries and the gate activations r, z, n and the
  recurrent product's n part; its backward (``_bm_bwd``) is a reverse loop
  that keeps only the dh propagation and stores the pre-activation grads,
  then ``dwh`` is one GEMM over [T*B] accumulated in fp32, ``dbh`` a float32
  sum in bh's own dtype, ``dgx`` the stored grads and ``dmask`` 0;
- ``rnn_bwd="native"``, or ``train=False``: autograd through
  ``gru_seq_reference``.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops.lstm import RNN_BWD


def gru_seq_reference(gx: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                      bh: torch.Tensor):
    T, B, _ = gx.shape
    H = wh.shape[0]
    h = gx.new_zeros(B, H)
    bh = bh.to(gx.dtype)
    seq = []
    for t in range(T):
        gh = h @ wh + bh  # rounded after the product, then after the add, as in JAX
        rx, zx, nx = gx[t].chunk(3, dim=-1)
        rh, zh, nh = gh.chunk(3, dim=-1)
        r = torch.sigmoid(rx + rh)
        z = torch.sigmoid(zx + zh)
        n = torch.tanh(nx + r * nh)
        new_h = (1.0 - z) * n + z * h
        m = mask[t]
        h = torch.where(m != 0, new_h, h)
        seq.append(new_h * m)
    return h, torch.stack(seq)


def _bm_fwd(gx: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor):
    """``gru_seq_reference``'s scan, with the same arithmetic, that also
    returns what ``_bm_bwd`` reads (``vqa_tpu/ops/gru.py::_bm_fwd``): the
    carry h after each step and r, z, n and the n part of h @ wh + bh, each
    [T, B, H]."""
    T, B, _ = gx.shape
    H = wh.shape[0]
    h = gx.new_zeros(B, H)
    bh = bh.to(gx.dtype)
    seq, h_carry, rs, zs, ns, nhs = [], [], [], [], [], []
    for t in range(T):
        gh = h @ wh + bh
        rx, zx, nx = gx[t].chunk(3, dim=-1)
        rh, zh, nh = gh.chunk(3, dim=-1)
        r = torch.sigmoid(rx + rh)
        z = torch.sigmoid(zx + zh)
        n = torch.tanh(nx + r * nh)
        new_h = (1.0 - z) * n + z * h
        m = mask[t]
        h = torch.where(m != 0, new_h, h)
        seq.append(new_h * m)
        for store, x in ((h_carry, h), (rs, r), (zs, z), (ns, n), (nhs, nh)):
            store.append(x)
    residuals = tuple(torch.stack(x) for x in (h_carry, rs, zs, ns, nhs))
    return (h, torch.stack(seq)), residuals


def _bm_bwd(mask, wh, bh, residuals, dh_last, dseq):
    """(dgx, dwh, dbh) of ``vqa_tpu/ops/gru.py::_bm_bwd``: the reverse loop
    in the compute dtype keeps only the dh propagation and stores the
    pre-activation grads of the input side (``dgx``) and of the recurrent
    side (``dgh``, whose n part is the grad of h @ wh_n + bh_n); ``dwh`` is
    then one GEMM over [T*B] (on the card cuBLAS accumulates a bf16 GEMM in
    fp32) in wh's dtype, and ``dbh`` the float32 sum of ``dgh`` in bh's own
    dtype (bh arrives as the raw parameter)."""
    h_carry, r, z, n, nh = residuals
    T, B, H = h_carry.shape
    # step t consumed the carry h_{t-1}
    h_prev = torch.cat([h_carry.new_zeros(1, B, H), h_carry[:-1]])
    wh_t = wh.t()
    dh = dh_last.to(h_carry.dtype)
    dgx = h_carry.new_empty(T, B, 3 * H)
    dgh = h_carry.new_empty(T, B, 3 * H)
    for t in reversed(range(T)):
        m = mask[t]
        r_t, z_t, n_t = r[t], z[t], n[t]
        dnew_h = m * (dh + dseq[t])  # seq_t = new_h * m; h = m ? new_h : h
        dz = dnew_h * (h_prev[t] - n_t)
        dn = dnew_h * (1.0 - z_t)
        dpre_n = dn * (1.0 - n_t * n_t)
        dr = dpre_n * nh[t]
        dnh = dpre_n * r_t
        dpre_r = dr * r_t * (1.0 - r_t)
        dpre_z = dz * z_t * (1.0 - z_t)
        torch.cat([dpre_r, dpre_z, dnh], dim=-1, out=dgh[t])
        torch.cat([dpre_r, dpre_z, dpre_n], dim=-1, out=dgx[t])
        dh = (1.0 - m) * dh + dnew_h * z_t + dgh[t] @ wh_t
    dwh = h_prev.reshape(T * B, H).t() @ dgh.reshape(T * B, 3 * H)
    dbh = dgh.float().sum(dim=(0, 1))
    return dgx, dwh.to(wh.dtype), dbh.to(bh.dtype)


class _GRUSeq(torch.autograd.Function):
    """The plain forward that saves its residuals, and the big-matmul
    backward, both in plain PyTorch (the GRU has no kernel)."""

    @staticmethod
    def forward(ctx, gx, mask, wh, bh):
        outs, residuals = _bm_fwd(gx, mask, wh, bh)
        ctx.save_for_backward(mask, wh, bh, *residuals)
        return outs

    @staticmethod
    def backward(ctx, dh_last, dseq):
        mask, wh, bh, *residuals = ctx.saved_tensors
        with torch.no_grad():
            dgx, dwh, dbh = _bm_bwd(mask, wh, bh, residuals, dh_last, dseq)
        dmask = torch.zeros_like(mask) if ctx.needs_input_grad[1] else None
        return dgx, dmask, dwh, dbh


def gru_seq(gx: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
            train: bool = False, rnn_bwd: str = "bigmatmul"):
    """The plain forward, or, where an input asks for grads under ``train``
    with ``rnn_bwd="bigmatmul"``, ``_GRUSeq`` (``vqa_tpu/ops/gru.py::gru_seq``'s
    dispatch; otherwise autograd goes through the plain forward)."""
    if rnn_bwd not in RNN_BWD:
        raise ValueError(f"rnn_bwd must be one of {RNN_BWD}, got {rnn_bwd!r}")
    if (train and rnn_bwd == "bigmatmul" and torch.is_grad_enabled()
            and any(x.requires_grad for x in (gx, wh, bh))):
        return _GRUSeq.apply(gx, mask, wh, bh)
    return gru_seq_reference(gx, mask, wh, bh)
