"""Masked LSTM recurrence, the port of ``vqa_tpu/ops/lstm.py``.

lstm_seq(xg [T, B, 4H], mask [T, B, 1], wh [H, 4H]) -> (h_last [B, H],
seq [T, B, H])

``xg`` is the input-side projection for all T steps, computed beforehand by
one GEMM (models/seq2vec.py). Gates are in i, f, g, o order. Where the mask
is 0, h and c stay frozen and ``seq`` is 0, so ``h_last`` is each row's last
real step whichever side the padding is on.

The forward is the registered op ``torch.ops.vqa_tpu_torch.lstm_seq``: on
CUDA tensors it launches a hand-written kernel, one persistent launch for
all T steps: ``csrc/lstm.cu`` for bf16 (wgmma, tiles chosen by
``lstm_plan``; h and c rounded to bf16 between steps) or ``csrc/lstm_f32.cu``
for float32 (the same persistent design with its products in 3xTF32 on the
tensor cores, h and c float32 between steps, as the Pallas kernel's scratch
takes xg's dtype); on CPU tensors it takes the plain version. Where grads
are asked for, the call is a ``torch.autograd.Function`` whose backward is
plain PyTorch, as the JAX package's vjps are jnp:

- ``train=True`` with ``rnn_bwd="bigmatmul"`` (``engine.rnn_bwd``'s
  default): ``_lstm_seq_bigmatmul``'s backward (``_bm_bwd``), a reverse scan
  that keeps only the dh/dc propagation, then ``dwh`` as one GEMM over
  [T*B] accumulated in fp32 and rounded to wh's dtype, ``dxg = dgates``,
  ``dmask = 0``;
- ``rnn_bwd="native"``, or ``train=False``: autograd through
  ``lstm_seq_reference``.

The kernel saves no gate activations, so the backward first recomputes the
forward's residuals by a plain scan (``_bm_fwd``), as the JAX package's
Pallas vjp recomputes. The recompute keeps the plain version's arithmetic
(gate math in the compute dtype), where the kernel does its gate math in
fp32: in bf16 the residuals differ from the kernel's by bf16 rounding.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vqa_tpu_torch.ops import KERNEL_DTYPES, SMEM_LIMIT, _build, recompute_grads, register

RNN_BWD = ("bigmatmul", "native")  # engine.rnn_bwd


SMS = 132  # streaming multiprocessors of an H100 SXM
# csrc/lstm.cu's constants, for lstm_plan's reckoning; the cuda test
# test_lstm_plan_matches_the_card holds the plan to what the kernel launches
_STAGES = {2: 4, 1: 5}  # by warpgroups, as csrc/lstm.cu instantiates them
_BK = 64     # K tile
_UNITS = 64  # hidden units a tile (x 4 gates = 256 columns)
_MAX_SPLIT = 3  # clusters sharing a tail tile
# csrc/lstm_f32.cu's constants: K a stage (one 128-byte row of float32), and
# the ring's stages by class
_F32_BK = 32
_F32_STAGES = {2: 2, 1: 3}


def _f32_plan(B: int, H: int) -> dict:
    """csrc/lstm_f32.cu's reckoning, the class chosen as bf16's: wg=2
    (B=1024, H=2400) the bf16 tiles (128 rows x 64 units of all four gates,
    CTA pairs multicasting wh^T), two stages; wg=1 64-row tiles (each of
    its two warpgroups 32 units), three stages, each stage's products added
    into fp32 registers. The tensor cores' own fp32 accumulation truncates,
    and wg=2 has no registers for a fresh sum: its sum stays in them over
    all of K, so its numerics are weaker (about 20x wg=1's error at K =
    2400). wg=2 runs where bf16's class does: H=2400 at B >= 769, H=1024 at
    B >= 1793, in eval and in training alike. A stage is K = 32: h's tile
    (split in registers) and wh^T's hi and lo strips. Also the scratch ahead
    of the tail's partial products: h's ping-pong and wh^T's halves."""
    plan = _bf16_plan(B, H)
    wg, hp = plan["wg"], plan["hp"]
    n_u = math.ceil(H / _UNITS)
    bm = 64 * wg
    tiles = math.ceil(math.ceil(B / bm) / wg) * wg * n_u
    clusters = min(tiles, SMS) // wg
    rounds, rem = divmod(tiles // wg, clusters)
    split = min(clusters // rem, _MAX_SPLIT, math.ceil(H / _F32_BK)) if rounds and rem else 1
    stages = _F32_STAGES[wg]
    stage_bytes = bm * _F32_BK * 4 + 2 * 4 * _UNITS * _F32_BK * 4
    return {
        "wg": wg, "cluster": wg, "bm": bm, "n": 4 * _UNITS, "stages": stages, "tiles": tiles,
        "full_rounds": rounds, "tail_tiles": rem, "tail_split": split,
        "ctas": clusters * wg, "waves": tiles / SMS,
        # h once (float32), wh^T's two halves
        "l2_bytes_per_step": 4 * H * B * 4 * H * (1 / (bm * wg) + 2 / (4 * _UNITS)),
        "smem_per_stage": stage_bytes, "smem_bytes": 1024 + stages * stage_bytes + 128,
        "hp": hp, "fixed_scratch_bytes": 4 * (2 * B * hp + 8 * hp * hp),
        "design": f"float32: persistent, 3xTF32 wgmma (A = h split in registers; lo.hi + "
                  f"hi.lo + hi.hi), wg={wg}, K {_F32_BK} a stage x {stages}, "
                  + ("a stage's sum added in fp32 registers" if wg == 1 else
                     "the sum kept in the tensor cores over all of K (weaker numerics: their "
                     "fp32 accumulation truncates)") + ", grid barrier between steps",
    }


def lstm_plan(B: int, H: int, elem: int = 2) -> dict:
    """The plan at batch B and hidden size H for elements of ``elem``
    bytes: the class the kernel runs, chosen by shape alone, with the
    numbers it was chosen by: the CTAs and waves on 132 SMs (one CTA an SM:
    its shared memory is over half of it), the operand bytes a step pulls
    through L2 (h re-read once per column tile, wh once per row tile) and
    the shared memory a stage. Every tile is 64 units x 4 gates (N = 256,
    one 128-byte swizzle row a gate strip);

    - wg=2: 128-row tiles, when they make at least 1.8 waves (B=1024,
      H=2400: 304 tiles, 2.3 waves), in clusters of two CTAs on
      neighbouring row tiles that share each wh stage (TMA multicast);
    - wg=1: 64-row tiles otherwise (B=1024, H=1024: 256 tiles; the serving
      batch B=64: one row of 38 tiles at H=2400, 16 at H=1024).

    Each step runs full rounds of tiles over the clusters (CTA pairs for
    wg=2), then the tiles left over: each of those is shared by
    ``tail_split`` clusters over K (B=1024, H=2400: 152 pair-tiles on 66
    pairs, two rounds, then 20 tiles x 3), the partial products summed in a
    fixed order. 2 (bf16): ``csrc/lstm.cu``, K = 64 a stage, 4 or 5 stages.
    4 (float32): ``csrc/lstm_f32.cu``, the same class, its products in
    3xTF32 (``_f32_plan``: wg=1 takes 64-row tiles of two half-width
    warpgroups). The wrapper takes only ``wg`` and ``hp`` from here
    (float32: only ``hp``; its kernel reckons its class itself): the grid,
    the split and the scratch it launches with come from the kernel's own
    reckoning on the card (``launch_geometry``, ``launch_geometry_f32``);
    the figures here assume 132 SMs.

    Raises ValueError for a shape the kernel cannot describe."""
    if B < 1 or H < 2:
        raise ValueError(f"lstm_seq needs B >= 1 and H >= 2, got B={B}, H={H}")
    if H % 2:
        raise ValueError(f"lstm_seq reads xg and writes h, c and seq two units at a time, so "
                         f"xg's gate strips must start on two elements: H must be even, "
                         f"got H={H}")
    if elem == 4:
        return _f32_plan(B, H)
    if elem != 2:
        raise ValueError(f"lstm_seq takes 2-byte (bf16) or 4-byte (float32) elements, got {elem}")
    return _bf16_plan(B, H)


def _bf16_plan(B: int, H: int) -> dict:
    n_u = math.ceil(H / _UNITS)
    wg = 2 if math.ceil(B / 128) * n_u >= 1.8 * SMS else 1
    bm, n = 64 * wg, 4 * _UNITS
    stages = _STAGES[wg]
    stage_bytes = bm * _BK * 2 + _BK * n * 2
    cluster = wg  # wg=2 pairs its row tiles; an odd last one with an empty one
    tiles = math.ceil(math.ceil(B / bm) / cluster) * cluster * n_u
    clusters = min(tiles, SMS) // cluster
    rounds, rem = divmod(tiles // cluster, clusters)
    split = min(clusters // rem, _MAX_SPLIT, n_u) if rounds and rem else 1
    return {
        "wg": wg, "cluster": cluster, "bm": bm, "n": n, "stages": stages, "tiles": tiles,
        "full_rounds": rounds, "tail_tiles": rem, "tail_split": split,
        "ctas": min(tiles, SMS), "waves": tiles / SMS,
        "l2_bytes_per_step": 2 * H * B * 4 * H * (1 / (bm * cluster) + 1 / n),
        "smem_per_stage": stage_bytes,
        # + the stages' barriers, and 4 KB of epilogue staging a consumer warp
        "smem_bytes": 1024 + stages * stage_bytes + 128 + 4 * wg * 4096,
        "hp": math.ceil(H / 8) * 8, "design": "persistent, grid barrier between steps",
    }


_GEOMETRY = ("ctas", "tail_split", "part_bytes", "tiles", "tail_tiles", "smem_bytes")
_F32_GEOMETRY = ("ctas", "tiles", "smem_bytes", "cluster", "tail_split", "tail_tiles",
                 "scratch_bytes", "stages")


@functools.lru_cache(maxsize=None)
def launch_geometry(B: int, H: int, wg: int, device_index: int) -> dict:
    """What csrc/lstm.cu launches at this shape and class on this card, from
    its occupancy: the CTAs, the clusters sharing each tail tile, the bytes
    of partial-product scratch, the CTA tiles a step, the tail tiles and the
    shared memory of a CTA (the last five keys as ``lstm_plan`` names them)."""
    geometry = (ctypes.c_longlong * len(_GEOMETRY))()
    with torch.cuda.device(device_index):
        _build.check(_build.library().vqa_lstm_seq_geometry(B, H, wg, geometry),
                     "lstm_seq geometry")
    return dict(zip(_GEOMETRY, geometry))


@functools.lru_cache(maxsize=None)
def launch_geometry_f32(B: int, H: int, device_index: int) -> dict:
    """What csrc/lstm_f32.cu launches at this shape on this card, from its
    occupancy: the CTAs, the CTA tiles a step, the shared memory of a CTA,
    the CTAs a cluster, the clusters sharing each tail tile, the tail
    tiles, the bytes of scratch and the ring's stages (as
    ``lstm_plan(..., elem=4)`` names them)."""
    geometry = (ctypes.c_longlong * len(_F32_GEOMETRY))()
    with torch.cuda.device(device_index):
        _build.check(_build.library().vqa_lstm_seq_f32_geometry(B, H, geometry),
                     "lstm_seq geometry (float32)")
    return dict(zip(_F32_GEOMETRY, geometry))


def gate_strips(wh: torch.Tensor):
    """(wh, gs): the kernel reads gate g's strip at column g*gs + j of each
    wh row, and a TMA box must start on 16 bytes, so gs must be a multiple
    of 8. H % 8 == 0 (the archs' 1024 and 2400) takes wh as it is; otherwise
    a copy with each gate strip zero-padded to a multiple of 8 (same order,
    no permutation)."""
    H = wh.shape[0]
    if H % 8 == 0:
        return wh, H
    gs = math.ceil(H / 8) * 8
    padded = wh.new_zeros(H, 4, gs)
    padded[:, :, :H] = wh.view(H, 4, H)
    return padded, gs


def pad_odd_hidden(xg: torch.Tensor, wh: torch.Tensor):
    """(xg, wh) for an odd H, padded to Hp = H + 1 hidden units: each of
    xg's four gate strips zero-padded to Hp ([T, B, 4 Hp]), and wh with a
    zero row and a zero column at the end of each gate strip ([Hp, 4 Hp]).

    The kernel moves two units at a time, so it takes an even H; on these
    inputs it computes exactly the unpadded recurrence in units [0, H). The
    padded unit's gates are 0 + 0 at every step (its xg columns and wh
    columns are zero), so c' = sigmoid(0) c + sigmoid(0) tanh(0) = 0 from
    c = 0, and h' = sigmoid(0) tanh(0) = 0; and its zero row of wh adds
    nothing to the real units' gates."""
    T, B, _ = xg.shape
    H = wh.shape[0]
    hp = H + 1
    xp = xg.new_zeros(T, B, 4, hp)
    xp[..., :H] = xg.view(T, B, 4, H)
    wp = wh.new_zeros(hp, 4, hp)
    wp[:H, :, :H] = wh.view(H, 4, H)
    return xp.view(T, B, 4 * hp), wp.view(hp, 4 * hp)


def lstm_seq_reference(xg: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor):
    T, B, _ = xg.shape
    H = wh.shape[0]
    h = xg.new_zeros(B, H)
    c = xg.new_zeros(B, H)
    seq = []
    for t in range(T):
        gates = xg[t] + h @ wh
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        m = mask[t]
        keep = m != 0
        h = torch.where(keep, new_h, h)
        c = torch.where(keep, new_c, c)
        seq.append(new_h * m)
    return h, torch.stack(seq)


def _bm_fwd(xg: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor):
    """The plain forward scan that also returns what ``_bm_bwd`` reads
    (``vqa_tpu/ops/lstm.py::_bm_fwd``): the carries h and c after each step,
    the gate activations i, f, g, o ([T, B, 4H]) and tanh(c) ([T, B, H])."""
    T, B, _ = xg.shape
    H = wh.shape[0]
    h = xg.new_zeros(B, H)
    c = xg.new_zeros(B, H)
    seq, h_carry, c_carry, acts, tcs = [], [], [], [], []
    for t in range(T):
        gates = xg[t] + h @ wh
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        new_c = f * c + i * g
        tc = torch.tanh(new_c)
        new_h = o * tc
        keep = mask[t] != 0
        h = torch.where(keep, new_h, h)
        c = torch.where(keep, new_c, c)
        seq.append(new_h * mask[t])
        h_carry.append(h)
        c_carry.append(c)
        acts.append(torch.cat([i, f, g, o], dim=-1))
        tcs.append(tc)
    residuals = tuple(torch.stack(x) for x in (h_carry, c_carry, acts, tcs))
    return (h, torch.stack(seq)), residuals


def _bm_bwd(mask, wh, residuals, dh_last, dseq):
    """(dxg, dwh) of ``vqa_tpu/ops/lstm.py::_bm_bwd``: the reverse scan keeps
    only the dh/dc propagation and stores the gate grads; ``dwh`` is then one
    GEMM over [T*B] (on the card cuBLAS accumulates a bf16 GEMM in fp32) in
    wh's dtype, and ``dxg`` is the gate grads."""
    h_carry, c_carry, acts, tcs = residuals
    T, B, H = h_carry.shape
    zero = h_carry.new_zeros(1, B, H)
    # step t consumed the carries (h_{t-1}, c_{t-1})
    h_prev = torch.cat([zero, h_carry[:-1]])
    c_prev = torch.cat([zero, c_carry[:-1]])
    wh_t = wh.t()
    dh = dh_last.to(h_carry.dtype)
    dc = h_carry.new_zeros(B, H)
    dgates = h_carry.new_empty(T, B, 4 * H)
    for t in reversed(range(T)):
        m = mask[t]
        i, f, g, o = acts[t].chunk(4, dim=-1)
        tc = tcs[t]
        dnew_h = m * (dh + dseq[t])  # seq_t = new_h * m; h = m ? new_h : h
        dnew_c = m * dc + dnew_h * o * (1.0 - tc * tc)
        torch.cat([(dnew_c * g) * i * (1.0 - i), (dnew_c * c_prev[t]) * f * (1.0 - f),
                   (dnew_c * i) * (1.0 - g * g), (dnew_h * tc) * o * (1.0 - o)],
                  dim=-1, out=dgates[t])
        dh = (1.0 - m) * dh + dgates[t] @ wh_t
        dc = (1.0 - m) * dc + dnew_c * f
    dwh = h_prev.reshape(T * B, H).t() @ dgates.reshape(T * B, 4 * H)
    return dgates, dwh.to(wh.dtype)


class _LSTMSeq(torch.autograd.Function):
    """The forward of the registered op ``lstm_seq`` (the kernel on the
    card), the backward of ``rnn_bwd`` in plain PyTorch after a plain
    recompute."""

    @staticmethod
    def forward(ctx, xg, mask, wh, rnn_bwd):
        ctx.rnn_bwd = rnn_bwd
        ctx.save_for_backward(xg, mask, wh)
        return _LSTM_SEQ_OP(xg, mask, wh)

    @staticmethod
    def backward(ctx, dh_last, dseq):
        if ctx.rnn_bwd == "native":
            return recompute_grads(ctx, lstm_seq_reference, (dh_last, dseq))
        xg, mask, wh = ctx.saved_tensors
        with torch.no_grad():
            _, residuals = _bm_fwd(xg, mask, wh)
            dxg, dwh = _bm_bwd(mask, wh, residuals, dh_last, dseq)
        dmask = torch.zeros_like(mask) if ctx.needs_input_grad[1] else None
        return dxg, dmask, dwh, None


def lstm_seq(xg: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor, train: bool = False,
             rnn_bwd: str = "bigmatmul"):
    """The forward, or, where an input asks for grads, ``_LSTMSeq`` with the
    backward ``rnn_bwd`` names (``train=False``: "native", as the JAX
    package's eval path differentiates its reference)."""
    if rnn_bwd not in RNN_BWD:
        raise ValueError(f"rnn_bwd must be one of {RNN_BWD}, got {rnn_bwd!r}")
    if torch.is_grad_enabled() and (xg.requires_grad or wh.requires_grad):
        return _LSTMSeq.apply(xg, mask, wh, rnn_bwd if train else "native")
    return _LSTM_SEQ_OP(xg, mask, wh)


def _lstm_seq_cuda(xg: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor):
    """The op's CUDA implementation: check the operands, launch, count."""
    if xg.ndim != 3 or wh.ndim != 2:
        raise ValueError(f"expected xg [T, B, 4H] and wh [H, 4H], got {tuple(xg.shape)}, "
                         f"{tuple(wh.shape)}")
    T, B, G4 = xg.shape
    H = wh.shape[0]
    if T < 1 or G4 != 4 * H:
        raise ValueError(f"xg {tuple(xg.shape)} does not match wh {tuple(wh.shape)}")
    dev, dt = xg.device, xg.dtype
    _build.require("xg", xg, dev, KERNEL_DTYPES, (T, B, 4 * H))
    _build.require("mask", mask, dev, dt, (T, B, 1))
    _build.require("wh", wh, dev, dt, (H, 4 * H))
    if H % 2:  # the kernel takes an even H: one zero unit more, sliced off after
        xp, wp = pad_odd_hidden(xg, wh)
        h_last, seq = _lstm_seq_cuda(xp, mask, wp)
        return h_last[:, :H].contiguous(), seq[..., :H].contiguous()
    if xg.data_ptr() % 16:  # the kernel reads xg in 16-byte chunks: an aligned copy
        xg = torch.empty_like(xg, memory_format=torch.contiguous_format).copy_(xg)
    if dt == torch.float32:
        return _lstm_seq_f32(xg, mask, wh)
    plan = lstm_plan(B, H)
    wh, gs = gate_strips(wh)
    h_last = torch.empty(B, H, dtype=dt, device=dev)
    seq = torch.empty(T, B, H, dtype=dt, device=dev)
    # scratch: the ping-pong h of steps 0..T-2 and c, with rows padded to 16
    # bytes (TMA's global strides), the grid barrier's and the tail tiles'
    # counters, and the tail tiles' partial products
    geometry = launch_geometry(B, H, plan["wg"], dev.index or 0)
    hbuf = torch.empty(2, B, plan["hp"], dtype=dt, device=dev)
    c = torch.empty(B, plan["hp"], dtype=dt, device=dev)
    count = torch.empty(1 + geometry["tail_tiles"], dtype=torch.int32, device=dev)
    part = torch.empty(max(geometry["part_bytes"], 16), dtype=torch.uint8, device=dev)
    err = _build.library().vqa_lstm_seq(
        xg.data_ptr(), mask.data_ptr(), wh.data_ptr(), h_last.data_ptr(), seq.data_ptr(),
        hbuf.data_ptr(), c.data_ptr(), count.data_ptr(), part.data_ptr(), part.numel(), T, B, H,
        gs, plan["wg"], _build.current_stream(dev),
    )
    _build.check(err, "lstm_seq")
    lstm_seq.launches += 1  # one persistent launch runs all T steps
    return h_last, seq


def _lstm_seq_f32(xg: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor):
    """The float32 entry (checked operands, even H): one persistent launch
    of csrc/lstm_f32.cu, h and c kept in float32 scratch between steps."""
    T, B, _ = xg.shape
    H = wh.shape[0]
    dev, dt = xg.device, torch.float32
    plan = lstm_plan(B, H, elem=4)
    wh, gs = gate_strips(wh)
    h_last = torch.empty(B, H, dtype=dt, device=dev)
    seq = torch.empty(T, B, H, dtype=dt, device=dev)
    # scratch as the kernel reckons it: h's ping-pong and its tf32 halves,
    # wh^T's halves and the tail tiles' partial products (one float32
    # buffer); c, rows padded to 8 units; the grid barrier's and the tail
    # tiles' counters
    geometry = launch_geometry_f32(B, H, dev.index or 0)
    scratch = torch.empty(max(geometry["scratch_bytes"] // 4, 4), dtype=dt, device=dev)
    c = torch.empty(B, plan["hp"], dtype=dt, device=dev)
    count = torch.empty(1 + geometry["tail_tiles"], dtype=torch.int32, device=dev)
    err = _build.library().vqa_lstm_seq_f32(
        xg.data_ptr(), mask.data_ptr(), wh.data_ptr(), h_last.data_ptr(), seq.data_ptr(),
        scratch.data_ptr(), c.data_ptr(), count.data_ptr(), T, B, H, gs,
        _build.current_stream(dev),
    )
    _build.check(err, "lstm_seq")
    lstm_seq.launches += 1  # one persistent launch runs all T steps
    return h_last, seq


def _lstm_seq_fake(xg: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor):
    T, B, _ = xg.shape
    H = wh.shape[0]
    return xg.new_empty(B, H), xg.new_empty(T, B, H)


lstm_seq.launches = 0
_LSTM_SEQ_OP = register("lstm_seq(Tensor xg, Tensor mask, Tensor wh) -> (Tensor, Tensor)",
                        lstm_seq_reference, _lstm_seq_cuda, _lstm_seq_fake)
