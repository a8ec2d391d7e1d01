#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vqa_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line of what it found:
  1. device: refuse to run without a card; print the card's name and power
     limit; build the kernels from csrc/ (nvcc, sm_90a, one process per
     source) and time the build;
  2. kernels: all seven (gather_rows, gather_rows_dequant, lstm_seq,
     glimpse_head, glimpse_attend, mfb_pool, relation_attend) against their
     plain PyTorch versions on the card, at the eval shapes of the archs that
     run them (batch 1024), at their serving shapes (batch 64, questions of
     26 tokens) and at the shapes an options/ knob or the extract CLI's
     196-region grid can give (8 glimpses, R = N = 196, an odd LSTM H=41),
     with each tolerance stated, and timed
     (median of CUDA-event timings) beside the plain version, the bound
     (the larger of the bytes over HBM's rate and the operations over the
     peak rate for their type) and, where one PyTorch call computes the
     same function, that call; the two gathers also by device time alone
     (back-to-back launches, indices already where each version reads them)
     beside their call time; lstm_seq, both glimpse kernels and
     relation_attend also bit-equal across two calls, each with its
     schedule (relation_attend also by device time, its plan's design
     named); lstm_seq with a
     cuBLAS yardstick of its products alone;
  3. eval: each arch at the full width of its options/vqa2 YAML (MutanAtt,
     MFBCoAtt, MFHCoAtt, CoR), bf16, random seeded weights, through the
     port's eval step over a feature table resident on the card (bench.py's
     synthetic data, batch 1024, the {7, 13, 26} ladder), once over the bf16
     table and once over its int8 quantization (quantize_features, bf16
     scales); kernel path held against the plain path; exactly the kernels
     of that arch's path launched (gather_rows_dequant in place of
     gather_rows over the int8 table);
  4. serve: each arch's Predictor behind the port's AnswerService,
     DynamicBatcher and HTTP server (vqa_tpu_torch.cli.serve); /healthz,
     /answer and an oversized /batch, answers held equal to direct
     Predictor calls and to the plain path's on the same inputs;
  5. grid: MutanAtt and CoR, one forward at the serving batch over a table
     of 196-region rows, held against the plain path;
  6. eval_cli: the port's eval CLI (python -m vqa_tpu_torch.cli.train -e)
     at the full width of options/vqa2/mutan_att.yaml over a synthetic raw
     VQA v2 set (train and val questions and annotations in the official
     schema; 1024 images; 32,500 val questions, so the last batch of 1024 is
     padded, and 16,250 train questions for the vocabularies; bench.py's
     question lengths; 10 annotators a question): the
     port's prep writes the processed split, the loader feeds the eval step
     over a table on the card, the results json is scored by the port's
     scorer CLI. Three runs: the bf16 table through the kernels, the same
     through the plain path, the int8 table; exactly gather_rows (int8:
     gather_rows_dequant), lstm_seq and glimpse_head launched; one results
     row per val question; acc1 recomputed on the host from the results and
     the split's answers; answers agreeing with the plain run's. The card's
     machine has no h5py, so an in-memory FeatureStore of the table stands
     in the dataset factory's store cache where the HDF5 file would be read.

Any failed check raises, and the script exits non-zero. On success the
second-to-last line is the per-kernel JSON record and the last line is
{"ok": true, "device": {...}}. Imports nothing of jax and nothing of the
JAX package (vqa_tpu).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

# tolerances against the plain version computed in float32 from the same
# bf16 inputs (float32 matmuls; TF32 off):
# - lstm_seq keeps h and c in bf16 between steps (as the TPU kernel did), so
#   each step rounds at 2^-9 relative, carried through up to 26 steps. The
#   worst error measured over this script's lstm shapes (T up to 26, H=2400,
#   1024, 40, 42; NVIDIA H100 80GB HBM3, 700 W) was 0.0046, one bf16 step of
#   a value in [1, 2): twice that, 0.0092, is the tolerance. It sits below
#   the 0.0049-0.0059 that the SFU gate math (tanh.approx.f32) moves the
#   outputs by, so a precision change in the kernel's math shows here;
# - glimpse_head rounds alpha to bf16 before the weighted sum (as the TPU
#   kernel did) and its outputs to bf16: |attended| <= max|v| ~ 5 and
#   |logits| ~ 3 give up to ~0.01 of rounding each.
# - glimpse_attend (glimpse_head's logits-given entry) rounds alpha and its
#   output the same way: the same bound;
# - mfb_pool computes in fp32 and rounds its output once; the rows are unit
#   vectors, so that rounding is at most 2^-9 * 1 ~ 0.002;
# - relation_attend computes scores and softmax in fp32, keeps alpha as two
#   bf16 halves (~2^-16 relative) and rounds its output once; the output is
#   a convex combination of rows of r, and with r = tanh(.) as on the CoR
#   path |out| <= 1, so rounding is <= 2^-9 ~ 0.002; 0.01 leaves room for
#   the fp32 sums taken in another order over D=1024.
LSTM_ATOL = 0.0092
GLIMPSE_ATOL = 0.05
MFB_POOL_ATOL = 2e-3
RELATION_ATOL = 0.01
# eval logits, kernel path vs plain bf16 path: the plain path rounds every
# intermediate to bf16 at other places than the kernels (bf16 matmul output,
# bf16 gate math), through the LSTM, both MUTAN fusions and the classifier;
# the same bf16 bound as the kernels (measured ~0.004 on the H100)
LOGITS_ATOL = 0.05
# served probabilities vs the plain path's: logits within +-LOGITS_ATOL of
# each other move a softmax probability by at most a factor exp(+-2 atol)
PROB_RTOL = math.expm1(2 * LOGITS_ATOL)
# argmax can differ only where the top-2 margin is within the logits error;
# with random weights and 2000 answers a small share of rows is that close
PRED_AGREE_FLOOR = 0.9

# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
PEAK_BF16 = 989e12   # FLOP/s on the tensor cores
PEAK_FP32 = 67e12    # FLOP/s outside them
HBM = 3.35e12        # bytes/s

BUCKETS = (7, 13, 26)
BATCH = 1024
SERVE_BATCH = 64  # the serving CLI's default --max_batch
N_BATCHES = 8
N_IMAGES = 1024
SEQ, REGIONS, DIM = 26, 36, 2048
GRID = 196  # regions of the extract CLI's 14 x 14 ResNet grid

# each arch: its options/vqa2 config (vqa_tpu_torch.flagship.CONFIGS) and
# the kernels its path runs
ARCHS = {
    "MutanAtt": ("mutan_att", ("gather_rows", "lstm_seq", "glimpse_head")),
    "MFBCoAtt": ("mfb_coatt", ("gather_rows", "lstm_seq", "glimpse_attend", "mfb_pool",
                               "glimpse_head")),
    "MFHCoAtt": ("mfh_coatt", ("gather_rows", "lstm_seq", "glimpse_attend", "mfb_pool",
                               "glimpse_head")),
    "CoR": ("cor", ("gather_rows", "lstm_seq", "relation_attend")),
}
GRID_ARCHS = ("MutanAtt", "CoR")  # also run once over the 196-region grid
# the eval CLI's data: val questions (not a multiple of BATCH: the last batch
# is padded), half as many train questions (the vocabularies come from them:
# ~100k tokens leave almost none of the NUM_WORDS - 2 words unseen), and
# distinct answers drawn with a long tail, of which the YAML's nans=2000 make
# the answer vocabulary (the rest are out-of-vocabulary consensus answers)
CLI_QUESTIONS = 32_500
CLI_TRAIN_QUESTIONS = CLI_QUESTIONS // 2
CLI_ANSWERS = 3_000
CLI_KERNELS = ("gather_rows", "lstm_seq", "glimpse_head")
SOURCES = {  # kernel -> (its CUDA source, the TPU kernel it replaces)
    "gather_rows": ("vqa_tpu_torch/csrc/gather.cu", "vqa_tpu/ops/gather.py:58"),
    # the same TPU kernel on the int8 rows, with the dequant after it
    # (vqa_tpu/engine/steps.py:69-73) fused in
    "gather_rows_dequant": ("vqa_tpu_torch/csrc/gather.cu", "vqa_tpu/ops/gather.py:58"),
    "lstm_seq": ("vqa_tpu_torch/csrc/lstm.cu", "vqa_tpu/ops/lstm.py:93"),
    "glimpse_head": ("vqa_tpu_torch/csrc/glimpse_head.cu", "vqa_tpu/ops/attention.py:132"),
    "glimpse_attend": ("vqa_tpu_torch/csrc/glimpse_head.cu", "vqa_tpu/ops/attention.py:43"),
    "mfb_pool": ("vqa_tpu_torch/csrc/mfb_pool.cu", "vqa_tpu/ops/mfb_pool.py:47"),
    "relation_attend": ("vqa_tpu_torch/csrc/relation.cu", "vqa_tpu/ops/relation.py:55"),
}


def _phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def _median_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(torch, fn, reps: int = 20, trials: int = 9, warmup: int = 3) -> float:
    """Device time of one call: the median over trials of the mean of
    ``reps`` back-to-back calls between two CUDA events. Where a launch runs
    longer than the host takes to enqueue the next (the batch-1024 gathers),
    host work between launches hides; a launch of a few microseconds (the
    serving shapes) reads the host's launch rate instead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _in_turns(torch, timer, kernel, plain):
    """(kernel, plain) medians of timer over the order plain, kernel,
    kernel, plain, so a drift in the card's state favours neither."""
    ks, ps = [], []
    for fn, out in ((plain, ps), (kernel, ks), (kernel, ks), (plain, ps)):
        out.append(timer(torch, fn))
    return statistics.median(ks), statistics.median(ps)


def _bound(nbytes: float, flops: float = 0.0, peak: float = PEAK_BF16):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``nbytes`` (each input read once, each output written once) over
    HBM's rate and ``flops`` over ``peak``."""
    t_bytes, t_ops = nbytes / HBM * 1e3, flops / peak * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# --------------------------------------------------------------- kernels


def _check_gather(torch, dev, rng):
    from vqa_tpu_torch.ops.gather import (ROWS_PER_LAUNCH, _host_indices, gather_rows,
                                          gather_rows_reference, launch_gather_rows)

    for n, tail, b in ((37, (36, 72), 53), (11, (3, 5), 29), (50, (6,), 5000),
                       (48, (REGIONS, DIM), SERVE_BATCH), (N_IMAGES, (REGIONS, DIM), BATCH)):
        table = torch.randn((n,) + tail, device=dev).to(torch.bfloat16)
        idx = rng.integers(0, n, b)
        idx[: b // 4] = idx[0]  # repeated rows
        before = gather_rows.launches
        out = gather_rows(table, idx)
        ref = gather_rows_reference(table, torch.from_numpy(idx).to(dev))
        torch.cuda.synchronize()
        _require(torch.equal(out, ref), f"gather_rows {tuple(table.shape)} x {b} is bit-exact")
        _require(gather_rows.launches - before == math.ceil(b / ROWS_PER_LAUNCH),
                 f"one launch per {ROWS_PER_LAUNCH} rows")
    # timed at the eval's index distribution (uniform over the table, so
    # rows repeat: 63% distinct at B=1024) and at distinct rows
    timing = {}
    row_bytes = REGIONS * DIM * 2
    for label, n, b in (("", N_IMAGES, BATCH), ("distinct_", N_IMAGES, BATCH),
                        ("serve_", 48, SERVE_BATCH)):
        table = torch.randn((n, REGIONS, DIM), device=dev).to(torch.bfloat16)
        idx = rng.permutation(n)[:b] if label == "distinct_" else rng.integers(0, n, b)
        if not label:  # the rows these indices read, once each; the output; the indices
            bound = _bound(len(np.unique(idx)) * row_bytes + b * row_bytes + 4 * b)
        idx_dev, idx32 = torch.from_numpy(idx).to(dev), _host_indices(idx, n)
        out = torch.empty((b, REGIONS, DIM), dtype=torch.bfloat16, device=dev)
        timing[label + "ms"], timing[label + "plain_ms"] = _in_turns(
            torch, _device_ms, lambda: launch_gather_rows(table, idx32, out),
            lambda: torch.index_select(table, 0, idx_dev, out=out))
        if not label:
            timing["call_ms"], timing["plain_call_ms"] = _in_turns(
                torch, _median_ms, lambda: gather_rows(table, idx),
                lambda: gather_rows_reference(table, torch.from_numpy(idx).to(dev)))
    _phase("gather_rows",
           shapes="1024x36x2048[1024],48x36x2048[64],37x36x72[53],11x3x5[29],50x6[5000]",
           max_abs_err=0.0, tol="exact", **{k: round(v, 4) for k, v in timing.items()})
    return {"max_abs_err": 0.0, **timing, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": timing["plain_ms"],
            "shape": "table 1024x36x2048 bf16, B=1024; ms/plain_ms: device time (index_select "
                     "on indices already on the card); call_ms/plain_call_ms: the whole call "
                     "from host indices; library_ms: index_select, the plain version itself"}


def _check_gather_dequant(torch, dev, rng, flagship):
    """int8 rows gathered and dequantized, bit-exact against the plain chain
    (index_select, cast, multiply) at bf16 and f32 scales; ``flagship`` is
    the eval's quantized table (values, scales)."""
    from vqa_tpu_torch.engine.steps import quantize_features
    from vqa_tpu_torch.ops.gather import (_host_indices, gather_rows_dequant,
                                          gather_rows_dequant_reference,
                                          launch_gather_rows_dequant)

    tables = [quantize_features(3 * rng.standard_normal(shape, dtype=np.float32))
              for shape in ((11, 3, 40), (37, 36, 7), (7, 3, 16), (48, REGIONS, DIM))]
    timing = {}
    for (values, scales), b in zip(tables + [flagship], (29, 53, 2100, SERVE_BATCH, BATCH)):
        n = values.shape[0]
        values = torch.from_numpy(values).to(dev)
        idx = rng.integers(0, n, b)
        idx[: b // 4] = idx[0]  # repeated rows
        idx_dev = torch.from_numpy(idx).to(dev)
        for sdt in (torch.bfloat16, torch.float32):
            sc = torch.from_numpy(scales).to(dev, sdt)
            out = gather_rows_dequant(values, sc, idx)
            ref = gather_rows_dequant_reference(values, sc, idx_dev)
            torch.cuda.synchronize()
            _require(out.dtype == sdt and torch.equal(out, ref),
                     f"gather_rows_dequant {tuple(values.shape)} x {b}, {sdt} scales, bit-exact")
            if b in (BATCH, SERVE_BATCH) and (b == BATCH or sdt == torch.bfloat16):
                tidx = rng.integers(0, n, b)  # the eval's index distribution
                tidx_dev, tidx32 = torch.from_numpy(tidx).to(dev), _host_indices(tidx, n)
                buf = torch.empty_like(ref)
                key = ("" if b == BATCH else "serve_") + ("" if sdt == torch.bfloat16 else "f32_")
                if not key:  # distinct int8 rows and their scales, once; the bf16 output
                    rows = len(np.unique(tidx))
                    bound = _bound(rows * (REGIONS * DIM + REGIONS * 2)
                                   + b * REGIONS * DIM * 2 + 4 * b)
                timing[key + "ms"], timing[key + "plain_ms"] = _in_turns(
                    torch, _device_ms,
                    lambda: launch_gather_rows_dequant(values, sc, tidx32, buf),
                    lambda: gather_rows_dequant_reference(values, sc, tidx_dev))
                if not key:
                    timing["call_ms"], timing["plain_call_ms"] = _in_turns(
                        torch, _median_ms, lambda: gather_rows_dequant(values, sc, tidx),
                        lambda: gather_rows_dequant_reference(
                            values, sc, torch.from_numpy(tidx).to(dev)))
        del values, idx_dev, out, ref
    _phase("gather_rows_dequant",
           shapes="1024x36x2048[1024],48x36x2048[64],11x3x40[29],37x36x7[53],7x3x16[2100]",
           scales="bf16,f32", max_abs_err=0.0, tol="exact",
           **{k: round(v, 4) for k, v in timing.items()})
    return {"max_abs_err": 0.0, **timing, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None,
            "shape": "int8 table 1024x36x2048 + bf16 scales, B=1024; ms/plain_ms: device time; "
                     "f32_: float32 scales; call_ms/plain_call_ms: the whole call; no one PyTorch "
                     "call gathers and dequantizes"}


def _lstm_inputs(torch, dev, rng, T, B, H):
    xg = torch.randn(T, B, 4 * H, device=dev).to(torch.bfloat16)
    wh = (torch.randn(H, 4 * H, device=dev) / H ** 0.5).to(torch.bfloat16)
    lengths = rng.integers(1, T + 1, B)
    lengths[:3] = (1, T, T // 2 + 1)
    left = rng.random(B) < 0.25  # a quarter of the rows left-padded
    t = np.arange(T)[:, None]
    valid = np.where(left[None, :], t >= T - lengths[None, :], t < lengths[None, :])
    mask = torch.from_numpy(valid[..., None].astype(np.float32)).to(dev, torch.bfloat16)
    return xg, mask, wh


def _lstm_bound(T, B, H):
    """xg, mask and wh read once, h_last and seq written once; the T-1
    products h[B,H] x wh[H,4H] (step 0 has none)."""
    return _bound(2 * (T * B * 4 * H + T * B + 4 * H * H + B * H + T * B * H),
                  2.0 * (T - 1) * B * H * 4 * H)


def _check_lstm(torch, dev, rng):
    from vqa_tpu_torch.ops.lstm import launch_geometry, lstm_plan, lstm_seq, lstm_seq_reference

    worst, timing = 0.0, {}
    # H=2400: MutanAtt; H=1024: MFB/MFH and CoR; H=41 runs as 42 units
    for T, B, H in ((7, BATCH, 2400), (13, BATCH, 2400), (26, BATCH, 2400),
                    (26, SERVE_BATCH, 2400), (7, BATCH, 1024), (26, SERVE_BATCH, 1024),
                    (5, 37, 40), (4, 37, 42), (5, 37, 41)):
        xg, mask, wh = _lstm_inputs(torch, dev, rng, T, B, H)
        h_last, seq = lstm_seq(xg, mask, wh)
        again = lstm_seq(xg, mask, wh)
        ref_h, ref_seq = lstm_seq_reference(xg.float(), mask.float(), wh.float())
        torch.cuda.synchronize()
        err = max((h_last.float() - ref_h).abs().max().item(),
                  (seq.float() - ref_seq).abs().max().item())
        bf16_h, bf16_seq = lstm_seq_reference(xg, mask, wh)
        plain_err = max((bf16_h.float() - ref_h).abs().max().item(),
                        (bf16_seq.float() - ref_seq).abs().max().item())
        _require(bool(torch.isfinite(seq).all()), f"lstm_seq T={T} B={B} H={H} finite")
        _require(err <= LSTM_ATOL, f"lstm_seq T={T} B={B} H={H}: err {err} <= {LSTM_ATOL}")
        _require(torch.equal(h_last, again[0]) and torch.equal(seq, again[1]),
                 f"lstm_seq T={T} B={B} H={H}: two calls bit-equal")
        worst = max(worst, err)
        plan = lstm_plan(B, H + H % 2)  # an odd H runs as H + 1 units
        geo = launch_geometry(B, H + H % 2, plan["wg"], dev.index or 0)
        line = dict(T=T, B=B, H=H, max_abs_err=round(err, 5), plain_bf16_err=round(plain_err, 5),
                    tol=LSTM_ATOL, bit_equal=True,
                    plan=f"wg{plan['wg']}_cluster{plan['cluster']}_ctas{geo['ctas']}"
                         f"_tail{geo['tail_split']}",
                    waves=round(geo["tiles"] / geo["ctas"], 3))
        if H in (2400, 1024):
            ms, plain = _in_turns(torch, _median_ms, lambda: lstm_seq(xg, mask, wh),
                                  lambda: lstm_seq_reference(xg, mask, wh))
            bound, by = _lstm_bound(T, B, H)
            h = torch.randn(B, H, device=dev).to(torch.bfloat16)
            product = _median_ms(torch, lambda: torch.addmm(xg[0], h, wh))
            shape = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                         pct_of_bound=100 * bound / ms, cublas_ms=(T - 1) * product)
            timing[f"T{T}_B{B}" + ("" if H == 2400 else f"_H{H}")] = shape
            line.update({k: (round(v, 4) if isinstance(v, float) else v) for k, v in shape.items()})
        _phase("lstm_seq", **line)
        del xg, mask, wh, h_last, seq, again, ref_h, ref_seq, bf16_h, bf16_seq
    flagship = timing[f"T7_B{BATCH}"]
    return {"max_abs_err": worst, "ms": flagship["ms"], "plain_ms": flagship["plain_ms"],
            "bound_ms": flagship["bound_ms"], "bound_by": flagship["bound_by"], "library_ms": None,
            "shape": "T=7 B=1024 H=2400 bf16; no one PyTorch call computes it (cuDNN's LSTM "
                     "has no mask freezing and no xg input); cublas_ms: (T-1) x torch.addmm(xg_t, "
                     "h, wh) at the shape, the products alone and not the same function, never "
                     "called by the port",
            "design": lstm_plan(BATCH, 2400)["design"],
            "by_shape": {k: {n: (round(v, 4) if isinstance(v, float) else v)
                             for n, v in s.items()} for k, s in timing.items()}}


def _glimpse_head_bound(B, R, M, G, D):
    """joint, w, b, v read once; attended and logits written once."""
    return _bound(2 * (B * R * M + M * G + G + B * R * D + B * G * D + B * R * G),
                  2.0 * B * R * G * (M + D))


def _check_glimpse(torch, dev, rng):
    from vqa_tpu_torch.ops.attention import glimpse_head, glimpse_head_reference, glimpse_plan

    worst, timing = 0.0, {}
    # M=510: MutanAtt; M=512: MFB/MFH (the 512-wide hidden layer); the
    # serving batch; then 8 glimpses, the 196-region grid and odd shapes
    for B, R, M, G, D in ((BATCH, REGIONS, 510, 2, DIM), (SERVE_BATCH, REGIONS, 510, 2, DIM),
                          (BATCH, REGIONS, 512, 2, DIM), (SERVE_BATCH, REGIONS, 510, 8, DIM),
                          (SERVE_BATCH, GRID, 510, 2, DIM), (37, 36, 45, 2, 72), (5, 7, 33, 3, 75)):
        joint = torch.tanh(torch.randn(B, R, M, device=dev)).to(torch.bfloat16)
        w = (torch.randn(M, G, device=dev) / M ** 0.5).to(torch.bfloat16)
        b = (0.1 * torch.randn(G, device=dev)).to(torch.bfloat16)
        v = torch.randn(B, R, D, device=dev).to(torch.bfloat16)
        att, logits = glimpse_head(joint, w, b, v)
        again = glimpse_head(joint, w, b, v)
        ref_att, ref_logits = glimpse_head_reference(joint.float(), w.float(), b.float(), v.float())
        torch.cuda.synchronize()
        err = max((att.float() - ref_att).abs().max().item(),
                  (logits.float() - ref_logits).abs().max().item())
        _require(err <= GLIMPSE_ATOL,
                 f"glimpse_head {(B, R, M, G, D)}: err {err} <= {GLIMPSE_ATOL}")
        _require(torch.equal(att, again[0]) and torch.equal(logits, again[1]),
                 f"glimpse_head {(B, R, M, G, D)}: two calls bit-equal")
        worst = max(worst, err)
        plan = glimpse_plan(B, R, M, G, D, vec=D % 8 == 0)
        line = dict(B=B, R=R, M=M, G=G, D=D, max_abs_err=round(err, 5), tol=GLIMPSE_ATOL,
                    bit_equal=True, plan=f"{plan['copy']}_split{plan['split']}"
                                         f"_chunk{plan['chunk']}x{plan['stages']}")
        if D == DIM and G == 2 and R == REGIONS:
            ms, plain = _in_turns(torch, _median_ms, lambda: glimpse_head(joint, w, b, v),
                                  lambda: glimpse_head_reference(joint, w, b, v))
            device = _device_ms(torch, lambda: glimpse_head(joint, w, b, v))
            bound, by = _glimpse_head_bound(B, R, M, G, D)
            timing[f"B{B}_M{M}"] = dict(ms=ms, plain_ms=plain, device_ms=device, bound_ms=bound,
                                        bound_by=by, pct_of_bound=100 * bound / ms,
                                        device_pct_of_bound=100 * bound / device)
            line.update({k: (round(x, 4) if isinstance(x, float) else x)
                         for k, x in timing[f"B{B}_M{M}"].items()})
        _phase("glimpse_head", **line)
        del joint, w, b, v, att, logits, again, ref_att, ref_logits
    flagship = timing[f"B{BATCH}_M510"]
    return {"max_abs_err": worst, **{k: flagship[k] for k in ("ms", "plain_ms", "bound_ms",
                                                              "bound_by")},
            "library_ms": None,
            "shape": "B=1024 R=36 M=510 G=2 D=2048 bf16; no one PyTorch call computes the "
                     "logits, their softmax over regions and the weighted sum",
            "design": glimpse_plan(BATCH, REGIONS, 510, 2, DIM)["design"],
            "by_shape": {k: {n: (round(x, 4) if isinstance(x, float) else x)
                             for n, x in t.items()} for k, t in timing.items()}}


def _masked_logits(torch, dev, rng, B, T, G):
    """Self-attention logits as MFBCoAtt masks them: finfo(bf16).min past
    each row's length (mixed lengths, a quarter of the rows left-padded),
    and row 0 fully masked (the empty question)."""
    logits = torch.randn(B, T, G, device=dev).to(torch.bfloat16)
    lengths = rng.integers(1, T + 1, B)
    left = rng.random(B) < 0.25
    t = np.arange(T)[None, :]
    valid = np.where(left[:, None], t >= T - lengths[:, None], t < lengths[:, None])
    valid[0] = False
    mask = torch.from_numpy(valid[..., None]).to(dev)
    return logits.masked_fill(~mask, torch.finfo(torch.bfloat16).min)


def _check_glimpse_attend(torch, dev, rng):
    from vqa_tpu_torch.ops.attention import glimpse_attend, glimpse_attend_reference, glimpse_plan

    worst, timing = 0.0, {}
    # MFB's question self-attention: B=1024 at each bucket, the serving B=64
    # at 26 tokens, H=1024, 2 glimpses; then 8 glimpses, the 196-region grid
    # and an odd shape
    for B, T, G, D in ((BATCH, 7, 2, 1024), (BATCH, 13, 2, 1024), (BATCH, 26, 2, 1024),
                       (SERVE_BATCH, 26, 2, 1024), (SERVE_BATCH, REGIONS, 8, 1024),
                       (SERVE_BATCH, GRID, 2, 1024), (5, 9, 3, 75)):
        logits = _masked_logits(torch, dev, rng, B, T, G)
        v = torch.randn(B, T, D, device=dev).to(torch.bfloat16)
        out = glimpse_attend(logits, v)
        again = glimpse_attend(logits, v)
        ref = glimpse_attend_reference(logits.float(), v.float())
        torch.cuda.synchronize()
        _require(bool(torch.isfinite(out).all()), f"glimpse_attend {(B, T, G, D)} finite")
        _require(bool(torch.allclose(out[0].float(), v[0].float().mean(0).expand(G, D),
                                     atol=GLIMPSE_ATOL)),
                 "a fully masked row gives uniform weights")
        _require(torch.equal(out, again), f"glimpse_attend {(B, T, G, D)}: two calls bit-equal")
        err = (out.float() - ref).abs().max().item()
        _require(err <= GLIMPSE_ATOL, f"glimpse_attend {(B, T, G, D)}: err {err} <= {GLIMPSE_ATOL}")
        worst = max(worst, err)
        plan = glimpse_plan(B, T, 0, G, D, vec=D % 8 == 0)
        line = dict(B=B, T=T, G=G, D=D, max_abs_err=round(err, 5), tol=GLIMPSE_ATOL,
                    bit_equal=True, plan=f"{plan['copy']}_split{plan['split']}"
                                         f"_chunk{plan['chunk']}x{plan['stages']}")
        if D == 1024 and G == 2 and T <= SEQ:
            ms, plain = _in_turns(torch, _median_ms, lambda: glimpse_attend(logits, v),
                                  lambda: glimpse_attend_reference(logits, v))
            device = _device_ms(torch, lambda: glimpse_attend(logits, v))
            # logits, v in; attended out
            bound, by = _bound(2 * (B * T * G + B * T * D + B * G * D), 2.0 * B * T * G * D)
            timing[f"T{T}_B{B}"] = dict(ms=ms, plain_ms=plain, device_ms=device, bound_ms=bound,
                                        bound_by=by, pct_of_bound=100 * bound / ms,
                                        device_pct_of_bound=100 * bound / device)
            line.update({k: (round(x, 4) if isinstance(x, float) else x)
                         for k, x in timing[f"T{T}_B{B}"].items()})
        _phase("glimpse_attend", **line)
        del logits, v, out, again, ref
    flagship = timing[f"T7_B{BATCH}"]
    return {"max_abs_err": worst, **{k: flagship[k] for k in ("ms", "plain_ms", "bound_ms",
                                                              "bound_by")},
            "library_ms": None,
            "shape": "B=1024 T=7 G=2 D=1024 bf16, masked rows; no one PyTorch call takes the "
                     "softmax over T of given logits and the weighted sum",
            "by_shape": {k: {n: (round(x, 4) if isinstance(x, float) else x)
                             for n, x in t.items()} for k, t in timing.items()}}


def _check_mfb_pool(torch, dev, rng):
    from vqa_tpu_torch.ops.mfb_pool import mfb_pool, mfb_pool_reference

    worst, timing = 0.0, {}
    # rows: the eval attention call (1024 x 36 regions), serving (64 x 36),
    # the final fusion (1024); then k=3, m % 8 != 0 and ragged row counts
    for n, k, m in ((BATCH * REGIONS, 5, 1000), (SERVE_BATCH * REGIONS, 5, 1000),
                    (BATCH, 5, 1000), (131, 3, 33), (37, 5, 1001), (9, 3, 8)):
        z = torch.randn(n, k * m, device=dev).to(torch.bfloat16)
        out = mfb_pool(z, k)
        ref = mfb_pool_reference(z.float(), k)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        _require(err <= MFB_POOL_ATOL, f"mfb_pool {(n, k, m)}: err {err} <= {MFB_POOL_ATOL}")
        worst = max(worst, err)
        line = dict(n=n, k=k, m=m, max_abs_err=round(err, 6), tol=MFB_POOL_ATOL)
        if m == 1000:
            ms = _median_ms(torch, lambda: mfb_pool(z, k))
            plain = _median_ms(torch, lambda: mfb_pool_reference(z, k))
            timing[f"n{n}"] = (ms, plain)
            line.update(ms=round(ms, 4), plain_ms=round(plain, 4))
        _phase("mfb_pool", **line)
        del z, out, ref
    ms, plain = timing[f"n{BATCH * REGIONS}"]
    n, k, m = BATCH * REGIONS, 5, 1000  # z in, the pooled unit rows out
    bound = _bound(2 * (n * k * m + n * m), n * (k * m + 4 * m), PEAK_FP32)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None,
            "shape": "z 36864x5000 -> 36864x1000 bf16, k=5; no one PyTorch call pools, takes the "
                     "signed square root and normalizes",
            "ms_by_shape": {k: round(v[0], 4) for k, v in timing.items()},
            "plain_ms_by_shape": {k: round(v[1], 4) for k, v in timing.items()}}


def _check_relation(torch, dev, rng):
    import torch.nn.functional as F

    from vqa_tpu_torch.ops import _build
    from vqa_tpu_torch.ops.relation import (_vec, relation_attend, relation_attend_reference,
                                            relation_plan)

    worst, timing = 0.0, {}
    # CoR at the eval and the serving batch, over 36 regions and over the
    # 196-region grid (the tiled design), N=48 (the element design's
    # largest) and 64 (the tiled design's smallest); then odd shapes: D % 8
    # != 0 and rows off 16 bytes (plain copies), D=40 (a zero-padded
    # k-step), N just past 64
    for B, N, D, offset in ((BATCH, REGIONS, 1024, 0), (SERVE_BATCH, REGIONS, 1024, 0),
                            (SERVE_BATCH, GRID, 1024, 0), (BATCH, GRID, 1024, 0),
                            (BATCH, 48, 1024, 0), (BATCH, 64, 1024, 0), (5, 7, 33, 0),
                            (3, 36, 40, 0), (3, 65, 1024, 0), (2, 100, 33, 0),
                            (3, 36, 1024, 1)):
        n = B * N * D
        pg = torch.tanh(torch.randn(B, N, D, device=dev)).to(torch.bfloat16)
        r = torch.empty(n + offset, dtype=torch.bfloat16, device=dev)[offset:].view(B, N, D)
        r.copy_(torch.tanh(torch.randn(B, N, D, device=dev)))
        out = relation_attend(pg, r)
        ref = relation_attend_reference(pg.float(), r.float())
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        _require(err <= RELATION_ATOL, f"relation_attend {(B, N, D)}: err {err} <= {RELATION_ATOL}")
        worst = max(worst, err)
        vec = _vec(D, pg, r, out)
        plan = relation_plan(B, N, D, vec=vec, smem_limit=_build.smem_optin(0))
        line = dict(B=B, N=N, D=D, design=plan["design"], split=plan["split"], vec=vec,
                    max_abs_err=round(err, 6), tol=RELATION_ATOL)
        if D == 1024 and N in (REGIONS, GRID, 48, 64) and not offset:
            again = relation_attend(pg, r)
            torch.cuda.synchronize()
            _require(torch.equal(out, again), f"relation_attend {(B, N, D)} is bit-equal "
                                              f"across two calls")
            iters = 5 if B * N > BATCH * REGIONS else 20  # the big grid: fewer, longer calls
            ms, plain = _in_turns(torch, lambda t, fn: _median_ms(t, fn, iters=iters),
                                  lambda: relation_attend(pg, r),
                                  lambda: relation_attend_reference(pg, r))
            device = _device_ms(torch, lambda: relation_attend(pg, r), reps=iters)
            # the same function in one PyTorch call (scale 1/sqrt(D), the
            # default); timed here only, never called by the port
            library = _median_ms(torch, lambda: F.scaled_dot_product_attention(pg, r, r),
                                 iters=iters)
            bound, by = _bound(2 * 3 * B * N * D, 2.0 * 2 * B * N * N * D)  # pg, r in; out
            timing[f"B{B}_N{N}"] = dict(ms=ms, device_ms=device, plain_ms=plain,
                                        library_ms=library, bound_ms=bound, bound_by=by,
                                        pct_of_bound=100 * bound / device,
                                        design=plan["design"], bit_equal=True)
            line.update({k: (round(x, 4) if isinstance(x, float) else x)
                         for k, x in timing[f"B{B}_N{N}"].items()})
        _phase("relation_attend", **line)
        del pg, r, out, ref
    flagship = timing[f"B{BATCH}_N{REGIONS}"]
    return {"max_abs_err": worst, **{k: flagship[k] for k in ("ms", "device_ms", "plain_ms",
                                                              "bound_ms", "bound_by",
                                                              "library_ms")},
            "shape": "B=1024 N=36 D=1024 bf16 (element design, split 2); library_ms: "
                     "F.scaled_dot_product_attention(pg, r, r); N=196: the tiled design",
            "by_shape": {k: {n: (round(x, 4) if isinstance(x, float) else x)
                             for n, x in t.items()} for k, t in timing.items()}}


# --------------------------------------------------------------- main path


def _counters():
    from vqa_tpu_torch.ops.attention import glimpse_attend, glimpse_head
    from vqa_tpu_torch.ops.gather import gather_rows, gather_rows_dequant
    from vqa_tpu_torch.ops.lstm import lstm_seq
    from vqa_tpu_torch.ops.mfb_pool import mfb_pool
    from vqa_tpu_torch.ops.relation import relation_attend

    return {"gather_rows": gather_rows, "gather_rows_dequant": gather_rows_dequant,
            "lstm_seq": lstm_seq, "glimpse_head": glimpse_head,
            "glimpse_attend": glimpse_attend, "mfb_pool": mfb_pool,
            "relation_attend": relation_attend}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


@contextlib.contextmanager
def _plain_ops(torch):
    """Route the model through the plain versions on the card, for the
    comparison run only (the port itself always takes the kernel there)."""
    from vqa_tpu_torch import predictor
    from vqa_tpu_torch.engine import steps
    from vqa_tpu_torch.models import att, cor, fusion, mfb, seq2vec
    from vqa_tpu_torch.ops.attention import glimpse_attend_reference, glimpse_head_reference
    from vqa_tpu_torch.ops.gather import gather_rows_dequant_reference, gather_rows_reference
    from vqa_tpu_torch.ops.lstm import lstm_seq_reference
    from vqa_tpu_torch.ops.mfb_pool import mfb_pool_reference
    from vqa_tpu_torch.ops.relation import relation_attend_reference

    def on_card(idx, device):
        return torch.as_tensor(np.asarray(idx), dtype=torch.long).to(device)

    def plain_gather(table, idx):
        return gather_rows_reference(table, on_card(idx, table.device))

    def plain_gather_dequant(values, scales, idx):
        return gather_rows_dequant_reference(values, scales, on_card(idx, values.device))

    plain = [  # (module, name of the kernel wrapper it calls, plain version)
        (seq2vec, "lstm_seq", lambda xg, mask, wh, train=False: lstm_seq_reference(xg, mask, wh)),
        (att, "glimpse_head", glimpse_head_reference),
        (steps, "gather_rows", plain_gather),
        (steps, "gather_rows_dequant", plain_gather_dequant),
        (predictor, "gather_rows", plain_gather),
        (fusion, "mfb_pool", mfb_pool_reference),
        (mfb, "glimpse_attend", glimpse_attend_reference),
        (cor, "relation_attend", relation_attend_reference),
    ]
    saved = [getattr(module, name) for module, name, _ in plain]
    for module, name, fn in plain:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for (module, name, _), fn in zip(plain, saved):
            setattr(module, name, fn)


def _synthetic_eval_arrays(rng: np.random.Generator, n_questions: int):
    """bench.py:39-58: VQA v2 question lengths (mean ~6.2, sd ~2.2, clipped
    to [3, 26]), 12,000 words, a [N_IMAGES, 36, 2048] table."""
    from vqa_tpu_torch.flagship import NUM_WORDS

    questions = rng.integers(1, NUM_WORDS, (n_questions, SEQ), dtype=np.int32)
    lengths = np.clip(np.round(rng.normal(6.2, 2.2, n_questions)), 3, SEQ).astype(np.int32)
    questions *= (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    image_index = rng.integers(0, N_IMAGES, n_questions).astype(np.int32)
    table = rng.standard_normal((N_IMAGES, REGIONS, DIM), dtype=np.float32)
    return questions, lengths, image_index, table


def _eval_phase(torch, dev, arch, model, num_answers, kernels, features, questions, lengths,
                image_index, table="bf16", bf16_preds=None):
    """One arch's eval over ``features`` (a bf16 table, or an int8
    (values, scales) pair); returns (launch counts, preds). With
    ``bf16_preds`` the pred agreement with the bf16 table's run is printed,
    not held: quantization moves the logits by design."""
    from vqa_tpu_torch.engine import steps

    n = BATCH * N_BATCHES
    answers = np.random.default_rng(2).integers(0, num_answers, n).astype(np.int64)
    answers[::10] = -1  # unlabeled rows
    order = np.argsort(lengths, kind="stable")
    questions, lengths, image_index, answers = (
        questions[order], lengths[order], image_index[order], answers[order])
    valid = np.ones(n, bool)
    valid[-100:] = False  # a padded tail, as the last eval batch has

    batches = []
    for i in range(N_BATCHES):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        t_b = next(b for b in BUCKETS if b >= lengths[sl].max())
        batches.append({
            "question": torch.from_numpy(questions[sl, :t_b]).to(dev),
            "length": torch.from_numpy(lengths[sl]).to(dev),
            "image_index": image_index[sl],   # host: range-checked before upload
            "answer": torch.from_numpy(answers[sl]).to(dev),
            "valid": torch.from_numpy(valid[sl]).to(dev),
        })
    eval_step = steps.make_eval_step()

    def run_pass():
        outs = [eval_step(model, b, features) for b in batches]
        torch.cuda.synchronize()
        return outs

    _reset_counts()
    t0 = time.perf_counter()
    outs = run_pass()
    first_s = time.perf_counter() - t0
    counts = _read_counts()
    _require({k for k, c in counts.items() if c} == set(kernels),
             f"{arch} eval launched exactly its path's kernels {kernels}: {counts}")

    preds = torch.cat([o["pred"] for o in outs]).cpu().numpy()
    _require(preds.shape == (n,) and ((preds >= 0) & (preds < num_answers)).all(),
             "pred shape and range")
    tot = {k: sum(int(o[k]) for o in outs) for k in ("n", "n_labeled", "correct1", "correct5")}
    _require(tot["n"] == int(valid.sum()), f"n {tot['n']} == valid rows {int(valid.sum())}")
    _require(tot["n_labeled"] == int((valid & (answers >= 0)).sum()), "n_labeled")
    _require(0 <= tot["correct1"] <= tot["correct5"] <= tot["n_labeled"], "correct1/5 bounds")

    t0 = time.perf_counter()
    run_pass()
    kernel_s = time.perf_counter() - t0
    with _plain_ops(torch):
        run_pass()
        t0 = time.perf_counter()
        plain_outs = run_pass()
        plain_s = time.perf_counter() - t0
    plain_preds = torch.cat([o["pred"] for o in plain_outs]).cpu().numpy()

    # logits of both paths, batch by batch
    worst, scale, sure_rows, sure_agree = 0.0, 0.0, 0, 0

    def logits_of(b):
        return model(steps._resolve_visual(b, features), b["question"]).float()

    with torch.inference_mode():
        for b, pk, pp in zip(batches, np.split(preds, N_BATCHES), np.split(plain_preds, N_BATCHES)):
            lk = logits_of(b)
            with _plain_ops(torch):
                lp = logits_of(b)
            _require(bool(torch.isfinite(lk).all()) and lk.shape == (BATCH, num_answers),
                     f"finite logits of shape ({BATCH}, {num_answers})")
            worst = max(worst, (lk - lp).abs().max().item())
            scale = max(scale, lp.std().item())
            top2 = torch.topk(lp, 2, dim=-1).values
            sure = ((top2[:, 0] - top2[:, 1]) > 2 * LOGITS_ATOL).cpu().numpy()
            sure_rows += int(sure.sum())
            sure_agree += int((pk[sure] == pp[sure]).sum())
    agree = float((preds == plain_preds).mean())
    _require(worst <= LOGITS_ATOL, f"eval logits err {worst} <= {LOGITS_ATOL}")
    _require(sure_agree == sure_rows, f"pred equal wherever the top-2 margin exceeds "
             f"2*{LOGITS_ATOL}: {sure_agree}/{sure_rows}")
    _require(agree >= PRED_AGREE_FLOOR, f"pred agreement {agree} >= {PRED_AGREE_FLOOR}")
    extra = {}
    if bf16_preds is not None:
        extra["pred_agree_with_bf16_table"] = round(float((preds == bf16_preds).mean()), 5)
    _phase("eval", arch=arch, table=table, batches=N_BATCHES, batch=BATCH,
           buckets=[b["question"].shape[1] for b in batches],
           launches=counts, n=tot["n"], n_labeled=tot["n_labeled"], correct1=tot["correct1"],
           correct5=tot["correct5"], logits_max_abs_err=round(worst, 5), tol=LOGITS_ATOL,
           logits_std=round(scale, 5),
           pred_agree=round(agree, 5), floor=PRED_AGREE_FLOOR, **extra,
           first_pass_s=round(first_s, 4), kernel_pass_s=round(kernel_s, 4),
           plain_pass_s=round(plain_s, 4),
           kernel_qa_per_s=round(n / kernel_s, 1), plain_qa_per_s=round(n / plain_s, 1))
    return counts, preds


def _post(url: str, payload: dict):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _direct(predictor, questions, images, max_batch, topk):
    """What AnswerService computes: chunks of max_batch, each padded with its
    last row, so the direct call runs the very same forwards."""
    out = []
    for s in range(0, len(questions), max_batch):
        q, im = list(questions[s:s + max_batch]), list(images[s:s + max_batch])
        n = len(q)
        out += predictor.answer_batch(q + [q[-1]] * (max_batch - n),
                                      im + [im[-1]] * (max_batch - n), topk)[:n]
    return out


def _same_answers(got, want) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(w) and all(ga == wa and abs(gp - wp) <= 1e-6
                                 for (ga, gp), (wa, wp) in zip(g, w))
        for g, w in zip(got, want))


def _serve_phase(torch, arch, model, num_answers, kernels, features):
    from vqa_tpu_torch.cli.serve import AnswerService, DynamicBatcher, build_server
    from vqa_tpu_torch.flagship import NUM_WORDS
    from vqa_tpu_torch.predictor import Catalog, Predictor

    max_batch, n_images = SERVE_BATCH, 48
    words = ["<pad>", "<unk>"] + [f"w{i}" for i in range(2, NUM_WORDS)]
    names = [f"COCO_val2014_{i:012d}" for i in range(n_images)]
    catalog = Catalog({w: i for i, w in enumerate(words)},
                      [f"answer{i}" for i in range(num_answers)],
                      {name: i for i, name in enumerate(names)})
    predictor = Predictor(model, catalog, features[:n_images])
    service = DynamicBatcher(AnswerService(predictor, max_batch=max_batch), max_wait_ms=5)
    server = build_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(1)

    def question(i):
        ws = " ".join(f"w{x}" for x in rng.integers(2, NUM_WORDS, 3 + i % 9))
        return f"What is {ws}-like / unknownword{i}?"

    try:
        _reset_counts()
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            _require(resp.status == 200 and json.loads(resp.read()) == {"ok": True}, "/healthz")
        singles = []
        for i in range(3):
            q, im = question(i), names[(7 * i) % n_images]
            status, body = _post(base + "/answer", {"question": q, "image": im, "topk": 5})
            _require(status == 200, f"/answer status {status}")
            _require(len(body["answers"]) == 5 and all(
                isinstance(a, str) and isinstance(p, float) for a, p in body["answers"]),
                "/answer gives 5 [answer, prob] pairs")
            singles.append((q, im, [tuple(x) for x in body["answers"]]))
        qs = [question(i) for i in range(100)]
        ims = [names[i % n_images] for i in range(100)]
        status, body = _post(base + "/batch", {"questions": qs, "images": ims, "topk": 3})
        _require(status == 200 and len(body["answers"]) == 100, "/batch of 100 > max_batch")
        counts = _read_counts()  # before the direct calls below add their own
        for q, im, got in singles:
            _require(_same_answers([got], _direct(predictor, [q], [im], max_batch, 5)),
                     "/answer equals a direct Predictor call")
        got = [[tuple(x) for x in row] for row in body["answers"]]
        _require(_same_answers(got, _direct(predictor, qs, ims, max_batch, 3)),
                 "/batch equals direct Predictor calls")
        # the same requests through the plain path, every answer ranked
        with _plain_ops(torch):
            plain = _direct(predictor, [q for q, _, _ in singles] + qs,
                            [im for _, im, _ in singles] + ims, max_batch, num_answers)
    finally:
        server.shutdown()
        server.server_close()
        service.shutdown()
        thread.join(timeout=30)
    _require(not thread.is_alive(), "server thread stopped")
    _require({k for k, c in counts.items() if c} == set(kernels),
             f"{arch} serving launched exactly its path's kernels {kernels}: {counts}")
    served = [answers for _, _, answers in singles] + got
    worst, sure_rows, sure_agree = 0.0, 0, 0
    for row, ranked in zip(served, plain):
        p_plain = dict(ranked)
        worst = max(worst, max(abs(p - p_plain[a]) / p_plain[a] for a, p in row))
        # the top answer can differ only where the plain top-2 are that close
        if ranked[0][1] > ranked[1][1] * math.exp(2 * LOGITS_ATOL):
            sure_rows += 1
            sure_agree += row[0][0] == ranked[0][0]
    _require(worst <= PROB_RTOL, f"served probs within {PROB_RTOL:.4f} (relative) of the "
             f"plain path's: {worst}")
    _require(sure_agree == sure_rows, f"served top answer equals the plain path's wherever "
             f"its top-2 logits differ by more than 2*{LOGITS_ATOL}: {sure_agree}/{sure_rows}")
    _phase("serve", arch=arch, requests=5, rows=103, max_batch=max_batch, launches=counts,
           answers_equal_direct=True, prob_max_rel_err_vs_plain=round(worst, 6),
           tol=round(PROB_RTOL, 6), top1_equal_plain=f"{sure_agree}/{sure_rows}")
    return counts


def _grid_phase(torch, dev, arch, model, num_answers, kernels) -> dict:
    """One forward at the serving batch over a table of 196-region rows (the
    extract CLI's 14 x 14 ResNet grid), where the card kernels once refused
    the shape: logits held against the plain path, exactly the arch's
    kernels launched; returns the launch counts."""
    from vqa_tpu_torch.engine import steps
    from vqa_tpu_torch.flagship import NUM_WORDS

    rng = np.random.default_rng(3)
    table = torch.randn(48, GRID, DIM, device=dev).to(torch.bfloat16)
    lengths = rng.integers(3, 14, SERVE_BATCH)
    questions = rng.integers(1, NUM_WORDS, (SERVE_BATCH, 13)) * (np.arange(13) < lengths[:, None])
    batch = {"question": torch.from_numpy(questions).to(dev),
             "image_index": rng.integers(0, 48, SERVE_BATCH)}
    with torch.inference_mode():
        _reset_counts()
        logits = model(steps._resolve_visual(batch, table), batch["question"]).float()
        torch.cuda.synchronize()
        counts = _read_counts()
        with _plain_ops(torch):
            plain = model(steps._resolve_visual(batch, table), batch["question"]).float()
    _require({k for k, c in counts.items() if c} == set(kernels),
             f"{arch} over {GRID} regions launched exactly its path's kernels {kernels}: {counts}")
    _require(bool(torch.isfinite(logits).all()) and logits.shape == (SERVE_BATCH, num_answers),
             f"finite logits of shape ({SERVE_BATCH}, {num_answers}) over {GRID} regions")
    err = (logits - plain).abs().max().item()
    _require(err <= LOGITS_ATOL, f"{arch} over {GRID} regions: logits err {err} <= {LOGITS_ATOL}")
    _phase("grid", arch=arch, regions=GRID, batch=SERVE_BATCH, launches=counts,
           logits_max_abs_err=round(err, 5), tol=LOGITS_ATOL,
           logits_std=round(plain.std().item(), 5))
    return counts


def _arch_phases(torch, dev, arch, features, int8_features, eval_data) -> dict:
    """Build one arch at full width (bf16, random seeded weights), run its
    eval over the bf16 table and over the int8 one, and its serve phase;
    return the launch counts of all three (MutanAtt and CoR: also one forward
    over the 196-region grid)."""
    from vqa_tpu_torch.flagship import CONFIGS, build_config
    from vqa_tpu_torch.weights import random_params

    name, kernels = ARCHS[arch]
    num_answers = CONFIGS[name][1]
    model = build_config(name, dtype=torch.bfloat16, device=dev)
    random_params(model, seed=0)
    counts, preds = _eval_phase(torch, dev, arch, model, num_answers, kernels, features,
                                *eval_data)
    int8_kernels = tuple("gather_rows_dequant" if k == "gather_rows" else k for k in kernels)
    int8_counts, _ = _eval_phase(torch, dev, arch, model, num_answers, int8_kernels,
                                 int8_features, *eval_data, table="int8+bf16_scales",
                                 bf16_preds=preds)
    serve = _serve_phase(torch, arch, model, num_answers, kernels, features)
    grid = (_grid_phase(torch, dev, arch, model, num_answers, kernels) if arch in GRID_ARCHS
            else dict.fromkeys(counts, 0))
    del model
    torch.cuda.empty_cache()
    return {k: counts[k] + int8_counts[k] + serve[k] + grid[k] for k in counts}


def _write_raw_vqa2(dir_raw: str, rng: np.random.Generator) -> None:
    """A synthetic raw VQA v2 set in the official schema
    (vqa_tpu_torch/datasets/interim.py): CLI_TRAIN_QUESTIONS train and
    CLI_QUESTIONS val questions over
    N_IMAGES images, bench.py:39-58's question lengths over NUM_WORDS - 2
    words, 10 annotators a question who give the consensus answer 7 times in
    10, answers drawn from CLI_ANSWERS with weights 1 / (rank + 10)."""
    from vqa_tpu_torch.datasets.interim import RAW_FILES
    from vqa_tpu_torch.flagship import NUM_WORDS

    words = [f"w{i}" for i in range(NUM_WORDS - 2)]
    answers = [f"a{i}" for i in range(CLI_ANSWERS)]
    weights = 1.0 / (np.arange(CLI_ANSWERS) + 10.0)
    weights /= weights.sum()
    kinds = (("what color", "other"), ("how many", "number"), ("is the", "yes/no"),
             ("what is", "other"))
    os.makedirs(dir_raw, exist_ok=True)
    for split, n, first_qid in (("train", CLI_TRAIN_QUESTIONS, 1),
                                ("val", CLI_QUESTIONS, 10_000_000)):
        lengths = np.clip(np.round(rng.normal(6.2, 2.2, n)), 3, SEQ).astype(int).tolist()
        tokens = rng.integers(0, len(words), (n, SEQ)).tolist()
        image_ids = rng.integers(0, N_IMAGES, n).tolist()
        consensus = rng.choice(CLI_ANSWERS, n, p=weights)
        pool = np.where(rng.random((n, 10)) < 0.7, consensus[:, None],
                        rng.choice(CLI_ANSWERS, (n, 10), p=weights)).tolist()
        kind = rng.integers(0, len(kinds), n).tolist()
        questions, annotations = [], []
        for i in range(n):
            qid = first_qid + i
            text = " ".join(words[t] for t in tokens[i][:lengths[i]]) + "?"
            questions.append({"image_id": image_ids[i], "question": text, "question_id": qid})
            annotations.append({
                "image_id": image_ids[i], "question_id": qid,
                "question_type": kinds[kind[i]][0], "answer_type": kinds[kind[i]][1],
                "multiple_choice_answer": answers[consensus[i]],
                "answers": [{"answer": answers[a], "answer_confidence": "yes", "answer_id": j + 1}
                            for j, a in enumerate(pool[i])],
            })
        qfile, afile = RAW_FILES[split]
        with open(os.path.join(dir_raw, qfile), "w") as f:
            json.dump({"questions": questions}, f)
        with open(os.path.join(dir_raw, afile), "w") as f:
            json.dump({"annotations": annotations}, f)


def _eval_cli_phase(torch, dev, table: np.ndarray) -> dict:
    """The port's eval CLI at the full width of options/vqa2/mutan_att.yaml
    over a synthetic raw VQA v2 set (docstring, phase 6); returns the launch
    counts of its kernel runs (bf16 and int8 tables)."""
    import dataclasses
    import io
    import tempfile

    from vqa_tpu_torch.cli import score as score_cli
    from vqa_tpu_torch.cli import train as train_cli
    from vqa_tpu_torch.config import load_options
    from vqa_tpu_torch.datasets import factory as data_factory
    from vqa_tpu_torch.datasets.features import FeatureStore
    from vqa_tpu_torch.datasets.interim import RAW_FILES, image_name
    from vqa_tpu_torch.flagship import NUM_WORDS
    from vqa_tpu_torch.models.factory import factory as model_factory
    from vqa_tpu_torch.weights import export_params, random_params

    path_opt = os.path.join(_REPO, "options", "vqa2", "mutan_att.yaml")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_cli_") as tmp:
        t0 = time.perf_counter()
        _write_raw_vqa2(os.path.join(tmp, "vqa2", "raw"), np.random.default_rng(0))
        raw_s = time.perf_counter() - t0
        data = [f"vqa.dir={tmp}/vqa2", f"coco.dir={tmp}/coco"]
        opt = load_options(path_opt, data)
        # no h5py on the card's machine: the table stands in the store cache
        names = [image_name("val2014", i) for i in range(N_IMAGES)]
        data_factory._STORE_CACHE[(opt.coco.dir, opt.coco.arch, opt.coco.mode, "ram")] = \
            FeatureStore.in_memory(names, table)
        t0 = time.perf_counter()
        val_set = data_factory.factory("val", opt)  # the port's prep, on first use
        prep_s = time.perf_counter() - t0
        split = val_set.split
        _require(val_set.num_answers == opt.vqa.nans, f"answer vocabulary {val_set.num_answers} "
                 f"== nans {opt.vqa.nans}")
        _require(val_set.num_words >= 0.99 * NUM_WORDS, f"word vocabulary {val_set.num_words} "
                 f"~ {NUM_WORDS}")
        _require(len(split) == CLI_QUESTIONS and len(split) % BATCH, "a padded last batch")

        model = model_factory(dataclasses.asdict(opt.model), val_set.num_words,
                              val_set.num_answers, dtype=torch.bfloat16, device=dev,
                              dim_v=val_set.feature_shape[-1])
        random_params(model, seed=0)
        npz = os.path.join(tmp, "params.npz")
        np.savez(npz, **export_params(model))
        del model
        argv = ["--path_opt", path_opt, "-e", "--split", "val"]
        for o in data + [f"model.pretrained_params={npz}", "engine.device_features=true",
                         "optim.eval_batch_size=1024"]:
            argv += ["--opt", o]

        runs = {}
        for label, features_dtype, plain in (("bf16", "bfloat16", False),
                                             ("plain", "bfloat16", True),
                                             ("int8", "int8", False)):
            logs = os.path.join(tmp, "logs", label)
            _reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    (_plain_ops(torch) if plain else contextlib.nullcontext()):
                rc = train_cli.main(argv + ["--dir_logs", logs,
                                            "--opt", f"engine.features_dtype={features_dtype}"])
            wall = time.perf_counter() - t0
            counts = _read_counts()
            _require(rc == 0, f"eval CLI ({label}) returned {rc}")
            with open(os.path.join(logs, "metrics.jsonl")) as f:
                metrics = [json.loads(line) for line in f][-1]
            path = os.path.join(logs, "results", "vqa_OpenEnded_val_epoch0_results.json")
            with open(path) as f:
                results = {r["question_id"]: r["answer"] for r in json.load(f)}
            runs[label] = dict(counts=counts, metrics=metrics, results=results, path=path,
                               wall=wall)

        want = {"bf16": set(CLI_KERNELS), "plain": set(),
                "int8": {"gather_rows_dequant", "lstm_seq", "glimpse_head"}}
        answer_of = dict(zip(split.question_ids.tolist(), split.answers.tolist()))
        ans_to_aid = val_set.vocabs.ans_to_aid
        for label, run in runs.items():
            counts, m, results = run["counts"], run["metrics"], run["results"]
            _require({k for k, c in counts.items() if c} == want[label],
                     f"eval CLI ({label}) launched exactly {sorted(want[label])}: {counts}")
            _require(len(results) == len(split) and set(results) == set(answer_of),
                     f"eval CLI ({label}): one results row per val question, padded rows dropped")
            correct1 = sum(ans_to_aid[a] == answer_of[q] for q, a in results.items())
            _require(m["n"] == len(split) and m["n_labeled"] == int((split.answers >= 0).sum()),
                     f"eval CLI ({label}): n and n_labeled")
            _require(m["acc1"] == correct1 / m["n"],
                     f"eval CLI ({label}): acc1 {m['acc1']} == {correct1}/{m['n']} from the results")
            correct5 = round(m["acc5"] * m["n"])
            _require(abs(correct5 / m["n"] - m["acc5"]) < 1e-12
                     and correct1 <= correct5 <= m["n_labeled"],
                     f"eval CLI ({label}): acc5 {m['acc5']} a count over n, >= acc1")
        agree = float(np.mean([runs["bf16"]["results"][q] == a
                               for q, a in runs["plain"]["results"].items()]))
        _require(agree >= PRED_AGREE_FLOOR, f"eval CLI answers agree with the plain run's "
                 f"on {agree} >= {PRED_AGREE_FLOOR}")
        int8_agree = float(np.mean([runs["bf16"]["results"][q] == a
                                    for q, a in runs["int8"]["results"].items()]))

        report_path = os.path.join(tmp, "report.json")
        annotations = os.path.join(tmp, "vqa2", "raw", RAW_FILES["val"][1])
        with contextlib.redirect_stdout(io.StringIO()):
            rc = score_cli.main(["--results", runs["bf16"]["path"], "--annotations", annotations,
                                 "--out", report_path])
        with open(report_path) as f:
            report = json.load(f)
        _require(rc == 0 and report["n"] == len(split)
                 and {"overall", "per_answer_type", "per_question_type"} <= set(report)
                 and set(report["per_answer_type"]) == {"other", "number", "yes/no"},
                 "the scorer's report has overall and per-type accuracies for every row")
        del data_factory._STORE_CACHE[(opt.coco.dir, opt.coco.arch, opt.coco.mode, "ram")]

    _phase("eval_cli", arch="MutanAtt", questions=len(split), images=N_IMAGES, batch=BATCH,
           batches=-(-len(split) // BATCH), padded_rows=-len(split) % BATCH,
           n_labeled=runs["bf16"]["metrics"]["n_labeled"], words=val_set.num_words,
           answers=val_set.num_answers, raw_s=round(raw_s, 3), prep_s=round(prep_s, 3),
           **{f"{label}_{key}": value for label, run in runs.items()
              for key, value in (("qa_per_sec", round(run["metrics"]["qa_per_sec"], 1)),
                                 ("eval_time", round(run["metrics"]["eval_time"], 4)),
                                 ("cli_s", round(run["wall"], 3)),
                                 ("acc1", run["metrics"]["acc1"]))},
           score_overall=report["overall"], pred_agree_plain=round(agree, 5),
           floor=PRED_AGREE_FLOOR, pred_agree_int8=round(int8_agree, 5),
           launches={k: c for k, c in runs["bf16"]["counts"].items() if c},
           int8_launches={k: c for k, c in runs["int8"]["counts"].items() if c})
    return {k: runs["bf16"]["counts"][k] + runs["int8"]["counts"][k] for k in runs["bf16"]["counts"]}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a CUDA "
              "card and has no CPU path", file=sys.stderr)
        return 1
    from vqa_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.manual_seed(0)

    # 1. device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    log = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())
    _phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
           torch=torch.__version__, cuda=torch.version.cuda, build_s=round(build_s, 2))

    # the eval's table, and its int8 quantization with the scales placed in
    # bf16 on the card, as the JAX package's features_dtype=int8 places them
    from vqa_tpu_torch.engine.steps import quantize_features

    eval_data = _synthetic_eval_arrays(np.random.default_rng(0), BATCH * N_BATCHES)
    host_table = eval_data[-1]
    int8_table = quantize_features(host_table)
    features = torch.from_numpy(host_table).to(dev, torch.bfloat16)
    int8_features = (torch.from_numpy(int8_table[0]).to(dev),
                     torch.from_numpy(int8_table[1]).to(dev, torch.bfloat16))
    eval_data = eval_data[:-1]

    # 2. kernels against their plain versions
    rng = np.random.default_rng(0)
    kernels = {
        "gather_rows": _check_gather(torch, dev, rng),
        "gather_rows_dequant": _check_gather_dequant(torch, dev, rng, int8_table),
        "lstm_seq": _check_lstm(torch, dev, rng),
        "glimpse_head": _check_glimpse(torch, dev, rng),
        "glimpse_attend": _check_glimpse_attend(torch, dev, rng),
        "mfb_pool": _check_mfb_pool(torch, dev, rng),
        "relation_attend": _check_relation(torch, dev, rng),
    }

    # 3. eval step (bf16 and int8 tables), 4. serve and 5. grid, each arch at
    # full width, one after another
    launches = dict.fromkeys(kernels, 0)
    for arch in ARCHS:
        for name, c in _arch_phases(torch, dev, arch, features, int8_features,
                                    eval_data).items():
            launches[name] += c
    _require(all(c > 0 for c in launches.values()), f"every kernel launched: {launches}")

    # 6. the eval CLI over a processed split
    for name, c in _eval_cli_phase(torch, dev, host_table).items():
        launches[name] += c

    record = []
    for name, k in kernels.items():
        source, replaces = SOURCES[name]
        record.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                       "launches": launches[name],
                       **{key: k.pop(key) for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms")}, **k})
    _phase("total", wall_s=round(time.perf_counter() - t_start, 2))
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
