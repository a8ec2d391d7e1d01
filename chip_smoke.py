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
     run them (batch 1024; glimpse_head at MutanAtt's M=510, MFB's 512,
     ConcatAtt's 1024 with one glimpse and MLBAtt's 1200; the gathers over
     36x2048 region rows and the NoAtt archs' pooled 2048-wide rows), at
     their serving shapes (batch 64, questions of 26 tokens) and at the
     shapes an options/ knob or the extract CLI's 196-region grid can give
     (8 glimpses, R = N = 196 and gather_rows's 196-region rows at the
     serving and the eval batch, an odd
     LSTM H=41),
     with each tolerance stated, and timed
     (median of CUDA-event timings) beside the plain version, the bound
     (the larger of the bytes over HBM's rate and the operations over the
     peak rate for their type) and, where one PyTorch call computes the
     same function, that call; the two gathers also by device time alone
     (back-to-back launches, indices already where each version reads them)
     beside their call time; the gathers, lstm_seq, both glimpse kernels
     and relation_attend also bit-equal across two calls, each with its
     schedule (relation_attend also by device time, its plan's design
     named); lstm_seq with a
     cuBLAS yardstick of its products alone;
  3. eval: each arch at the full width of its options/vqa2 YAML (MutanAtt,
     MFBCoAtt, MFHCoAtt, CoR, ConcatAtt, MLBAtt, MutanNoAtt, MLBNoAtt) or
     flagship.VARIANTS entry (ConcatNoAtt; MutanAtt with the skip-thoughts
     GRU, 620 -> 2400), bf16, random seeded weights, through the port's eval
     step over a feature table resident on the card (bench.py's synthetic
     data, batch 1024, the {7, 13, 26} ladder; the NoAtt archs over the
     pooled table, the mean of its regions, [1024, 2048]), once over the
     bf16 table and once over its int8 quantization (quantize_features, bf16
     scales); kernel path held against the plain path; exactly the kernels
     of that arch's path launched (gather_rows_dequant in place of
     gather_rows over the int8 table; no lstm_seq for the GRU, which is
     plain PyTorch, and no glimpse kernel for the NoAtt archs);
  4. serve: each arch's Predictor behind the port's AnswerService,
     DynamicBatcher and HTTP server (vqa_tpu_torch.cli.serve); /healthz,
     /answer and an oversized /batch, answers held equal to direct
     Predictor calls and to the plain path's on the same inputs;
  5. grid: MutanAtt and CoR, one forward at the serving batch over a table
     of 196-region rows, held against the plain path;
  6. eval_cli: the port's eval CLI (python -m vqa_tpu_torch.cli.train -e)
     at the full width of options/vqa2/mutan_att.yaml (and of
     mutan_noatt.yaml over the pooled table) over a synthetic raw
     VQA v2 set (train and val questions and annotations in the official
     schema; 1024 images; 32,500 val questions, so the last batch of 1024 is
     padded, and 16,250 train questions for the vocabularies; bench.py's
     question lengths; 10 annotators a question): the
     port's prep writes the processed split, the loader feeds the eval step
     over a table on the card, the results json is scored by the port's
     scorer CLI. Five runs: MutanAtt over the bf16 table through the
     kernels, the same through the plain path, the int8 table; MutanNoAtt
     over the pooled bf16 table through the kernels and through the plain
     path; exactly gather_rows (int8: gather_rows_dequant), lstm_seq and
     (MutanAtt) glimpse_head launched; one results row per val question;
     acc1 recomputed on the host from the results and the split's answers;
     answers agreeing with the plain run's. The card's machine has no h5py,
     so in-memory FeatureStores of the tables (bottomup36 att and noatt)
     stand in the dataset factory's store cache where the HDF5 files would
     be read;
  7. train_ops: the train path's autograd Functions at batch 128, each the
     kernel's forward and a plain-PyTorch backward: lstm_seq(train=True)
     (the big-matmul backward after a plain recompute) at H=2400 (T=7, 26)
     and H=1024 (T=7), rows left- and right-padded and one fully padded;
     glimpse_head (the grads of its plain version recomputed) at R=36,
     (M, G) = (510, 2), (1024, 1), (1200, 2); glimpse_attend at MFB's
     question self-attention, T = 7, 13, 26, G=2, D=1024, logits masked at
     finfo(bf16).min past each row's length and one row masked whole;
     mfb_pool (its grads recomputed) on 4608x5000 and 128x5000,
     k=5; relation_attend at CoR's N=36, D=1024: forward outputs and every
     input grad against float32 autograd through the plain versions on the
     same bf16 inputs (each grad's relative error beside its tolerance;
     lstm_seq's dmask exactly 0; glimpse_attend's masked logits of partly
     masked rows a zero grad), the plain bf16 path's own errors beside, and
     the median time of forward + backward on both paths (lstm_seq also its
     recompute and its backward scan alone);
  8. train: MutanAtt and MFBCoAtt, each at the full width of its
     options/vqa2 YAML (bf16 compute over float32 parameters, adam at the
     YAML's lr, 1e-4 and 7e-4, batch 128, the YAML's dropout) over a
     synthetic train split from default_rng(0): 16384 questions with
     bench.py's lengths over the 1024-image bf16 table on the card, answers
     of the 2000 with a long tail; engine.train for one epoch (128 steps)
     over BatchIterator(shuffle, bucket_window 8, the {7, 13, 26} ladder,
     drop_last). Held: one step's loss, grads and gnorm, dropout off,
     through the kernels against the plain path on the card; one step
     launches each kernel of the arch's path as often as the path runs it
     (MFBCoAtt: mfb_pool twice) and nothing in the backward, and the epoch
     that a step; finite losses, gnorms and parameters, and the float32
     loss of 4 fixed batches (dropout off) lower after the epoch than
     before. Printed: the first step's loss and the mean of the last 5,
     step time (median, host clock after sync) and QA pairs/s on the kernel
     path and the plain path, the LSTM recompute's share of a step,
     torch.cuda.max_memory_allocated. Then MLBAtt, ConcatAtt, MutanNoAtt,
     MLBNoAtt, ConcatNoAtt (the NoAtt archs over the pooled table),
     MFHCoAtt, CoR and MutanAtt with the skip-thoughts GRU at their widths:
     the same kernel-against-plain hold and three steps each, each kernel
     launched as often a step as the path runs it (MFHCoAtt's mfb_pool 3,
     CoR's relation_attend 3);
  9. train_cli: the port's train CLI (python -m vqa_tpu_torch.cli.train,
     called in-process) at the full width of options/vqa2/mutan_att.yaml,
     from the port's init (weights.init_params, engine.seed), over phase
     6's synthetic raw VQA v2 set (train questions over 1024 train2014
     images, val over 1024 val2014 images: one in-memory store of 2048 rows,
     bf16 on the card), engine.train_bucketing=8, the YAML's batch 128 and
     dropout, --epochs 2 --checkpoint_every_steps 40. Run A straight; run B
     sent SIGTERM once epoch 1's step checkpoint at 40 has landed (main
     returns 75, info.json names the step where the flag was seen), then
     --resume latest. Held: B's final params, optimizer arrays and step
     equal A's bit for bit, and its epoch-1 val acc1; -e --resume best on A
     reports the acc1 A logged for its best epoch; Predictor.from_run(A,
     resume="best") answers 64 val questions as the eval step does on the
     same batch; finite losses; no step lost or repeated; only gather_rows,
     lstm_seq and glimpse_head launched. Printed: each run's train QA/s
     and mean step time (host clock, the step checkpoints' time taken out)
     and val QA/s (metrics.jsonl), each save's seconds and bytes, the
     restore's seconds and the resume's lost steps. Then mfb_coatt.yaml at
     full width, one straight epoch and -e --resume best: the acc1 equal to
     the run's best, a finite loss, exactly MFBCoAtt's kernels launched;
 10. export: over phase 9's runs (MutanAtt run A, the MFBCoAtt run) and a
     CoR run at cor.yaml's full width (weights.init_params, seed 0, written
     as its best checkpoint), vqa_tpu_torch.export at the serving batch 64
     on the card: MutanAtt baked (bf16, as the model holds them), external
     (params.npz) and baked int8, MFBCoAtt and CoR baked. Each artifact is
     loaded and run in a fresh interpreter (all five at once) with an
     in-memory feature store: held there, no vqa_tpu_torch.models module and
     nothing of jax imported, the graph calling exactly the arch's
     registered ops (vqa_tpu_torch::lstm_seq, ...) and the loaded program
     launching exactly those kernels; held here, its logits on 64 served
     val questions within 0.05 of the live model's with the same answers
     (int8: of an eager run of the same dequantized weights; the agreement
     with the unquantized model is printed). Then the export CLI's
     --validate 1024 gate (agreement 1.0), the serve CLI's --exported on
     port 0 in-process (with and without --dynamic_batching: three /answer
     and a /batch of 70, equal to ExportedPredictor.answer_batch's), and the
     visu CLI for MutanAtt and CoR (its top-5 equal to Predictor.answer's;
     the attention of the kernel path within 0.05 of the plain path's on a
     CPU copy). Across devices: the card-traced MutanAtt artifact loaded on
     the host by a fresh interpreter that sees no card
     (CUDA_VISIBLE_DEVICES=""), no kernel launched, its logits within 0.005
     of the live model's plain path on the card and the same answers
     wherever that path's top-2 logits differ by more than 0.01; and MutanAtt
     traced on the host (bf16, engine.dtype=bfloat16) loaded on the card,
     launching exactly its kernels, held as the card's own artifacts are.
     Printed: each artifact's bytes, export and load seconds; the
     forward at B=64 of the live model and of the loaded program (median,
     host clock after sync, in turns); the host time of one registered op
     call against a direct call of its CUDA implementation (20 calls);
 11. extract: a seeded torchvision-named ResNet-152 state_dict (He-normal
     convs, each block's bn3 weight in [0.1, 0.2], running statistics near
     (0, 1), an fc head) saved as a DataParallel checkpoint and converted by
     the port's import tool (python -m vqa_tpu_torch.tools.import_torch
     --kind resnet152, in-process): its npz holds exactly the port ResNet's
     variables, fc dropped. The extract CLI's function (cli/extract.py)
     runs it over 1024 seeded 448x448 uint8 images, normalized with the
     CLI's mean and std, at the CLI's batch 32: att in bf16 over all, the
     first 64 in float32 with TF32 off (and noatt in bf16), 2 of them on
     the host in float32, and those 2 once more on the card in float32
     with TF32 on. Held: bf16 within 0.05 of float32 and the card's
     float32 within 1e-4 of the host's (each relative to the max-abs), the
     TF32 grid past that 1e-4, noatt the mean of att within 2^-7, every
     value finite. Printed: the
     forward's time at batch 32 in bf16 and float32 (CUDA events) and its
     share of the bf16 bound (the multiply-adds this run's convs did, over
     the peak), the function's images/s, peak memory, the features' std.
     Then the eval CLI at the full width of mutan_att.yaml and cor.yaml
     with coco.arch=resnet152 over an in-memory store of the extracted
     [1024, 196, 2048] table (phase 6's synthetic raw VQA v2 set, made
     again: its val images are the 1024 names), through the kernels and
     through the plain path: exactly gather_rows, lstm_seq and glimpse_head
     (CoR: relation_attend) launched, one results row per val question,
     answers agreeing with the plain run's on at least 0.9. Printed: each
     run's QA/s and peak memory, glimpse_head's and relation_attend's
     device time at B=1024 over 196 regions (from phase 2).

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
import tempfile
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

# each arch: its options/vqa2 config (vqa_tpu_torch.flagship.CONFIGS, or a
# flagship.VARIANTS entry) and the kernels its path runs
_ATT_KERNELS = ("gather_rows", "lstm_seq", "glimpse_head")
_NOATT_KERNELS = ("gather_rows", "lstm_seq")
ARCHS = {
    "MutanAtt": ("mutan_att", _ATT_KERNELS),
    "MFBCoAtt": ("mfb_coatt", ("gather_rows", "lstm_seq", "glimpse_attend", "mfb_pool",
                               "glimpse_head")),
    "MFHCoAtt": ("mfh_coatt", ("gather_rows", "lstm_seq", "glimpse_attend", "mfb_pool",
                               "glimpse_head")),
    "CoR": ("cor", ("gather_rows", "lstm_seq", "relation_attend")),
    "ConcatAtt": ("concat_att", _ATT_KERNELS),
    "MLBAtt": ("mlb_att", _ATT_KERNELS),
    "MutanNoAtt": ("mutan_noatt", _NOATT_KERNELS),
    "MLBNoAtt": ("mlb_noatt", _NOATT_KERNELS),
    "ConcatNoAtt": ("concat_noatt", _NOATT_KERNELS),
    # the skip-thoughts GRU (620 -> 2400) is plain PyTorch: no lstm_seq
    "MutanAtt+skipthoughts": ("mutan_att_skipthoughts", ("gather_rows", "glimpse_head")),
}
# these read the pooled table [N, 2048] (coco.mode: noatt), the mean of the
# eval table's regions, as vqa_tpu/datasets/fixtures.py writes it
NOATT_ARCHS = ("MutanNoAtt", "MLBNoAtt", "ConcatNoAtt")
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
CLI_NOATT_KERNELS = ("gather_rows", "lstm_seq")
# the train phases (7, 8): mutan_att.yaml's batch, a synthetic train split of
# 16384 questions (128 steps of 128 with drop_last), bucketed shuffling over
# windows of 8 batches into the {7, 13, 26} ladder. From random weights at
# the YAML's lr 1e-4 the loss moves by hundredths of a nat in a few hundred
# steps (on an H100, 32 steps took the bf16 step loss from 7.625 to a last-5
# mean of 7.644; bf16's step at 7.6 is 0.031), so learning is held on the
# float32 loss of fixed batches, dropout off, before and after the epoch,
# not on the bf16 step losses
TRAIN_BATCH = 128
TRAIN_QUESTIONS = 16384
TRAIN_HELD_BATCHES = 4
TRAIN_BUCKET_WINDOW = 8
TRAIN_TIMED_STEPS = 10
TRAIN_ARCH_STEPS = 3
# (T, H) of the 2400- and 1024-unit archs; (M, G) of MutanAtt, ConcatAtt, MLBAtt
TRAIN_LSTM_SHAPES = ((7, 2400), (26, 2400), (7, 1024))
TRAIN_GLIMPSE_SHAPES = ((510, 2), (1024, 1), (1200, 2))
TRAIN_ATTEND_T = BUCKETS  # MFB's question self-attention over each bucket's tokens
# the archs trained for an epoch at full width, and those held and run for a
# few steps
TRAIN_FULL = {"MutanAtt": "mutan_att", "MFBCoAtt": "mfb_coatt"}
TRAIN_ARCHS = {"MLBAtt": "mlb_att", "ConcatAtt": "concat_att", "MutanNoAtt": "mutan_noatt",
               "MLBNoAtt": "mlb_noatt", "ConcatNoAtt": "concat_noatt", "MFHCoAtt": "mfh_coatt",
               "CoR": "cor", "MutanAtt+skipthoughts": "mutan_att_skipthoughts"}
# a train step launches each kernel of its arch's path once (lstm_seq: one
# persistent launch), but for MFB's pools (the region attention's and the
# final fusion's: 2; MFH's final fusion has 2 blocks: 3) and CoR's relation
# core (one a chain step: 3); the backwards launch none
TRAIN_STEP_LAUNCHES = {"MFBCoAtt": {"mfb_pool": 2}, "MFHCoAtt": {"mfb_pool": 3},
                       "CoR": {"relation_attend": 3}}
# train tolerances, stated from bf16 rounding before the first run on the
# card: the kernel path and the plain path (each bf16, ~2^-9 relative a
# rounding) differ where they round at other places (fp32 gate math in the
# lstm_seq kernel, against the plain recompute's bf16; the products' order),
# and a grad carries those differences through up to 26 reverse steps and
# the model's GEMMs: each grad within 5e-2 relative (Frobenius) of the
# float32 oracle or of the plain path, measured against 1e-3 of the global
# norm where a leaf's own is below that. The biases a softmax does not see
# are not compared (the glimpse logits' over the regions, MFB's question
# attention logits' over the tokens, CoR's pooling logit's over the objects):
# their grad is 0 in exact arithmetic and what each path computes is its
# own rounding; each is held to be below 1e-3 of the global norm on both
# paths.
# The loss is a log-sum-exp minus a logit: logits within LOGITS_ATOL of each
# other move it by at most twice that
TRAIN_GRAD_RTOL = 5e-2
TRAIN_GRAD_FLOOR = 1e-3
SOFTMAX_BLIND = ("glimpse_logits.bias", "q_attention.logits.bias", "chain.pool_logits.bias")
# MFB's signed square root has the derivative 0.5 / sqrt(|p| + 1e-12), so a
# grad upstream of an MFB pool is dominated by its few pooled values nearest
# 0, where bf16 rounding of the forward moves p by much of itself: measured
# on the card (NVIDIA H100 80GB HBM3, 700 W), the plain bf16 path sits 0.6-
# 0.9 (relative) from float32 autograd on those leaves, and the kernel path
# as far. There a leaf's grad is not reproducible in bf16 and cannot rank
# the kernels against the plain path: it is reported, and held only to be
# one that the plain path misses float32 by more than the tolerance; every
# other leaf keeps the hold. No other arch is exempt
SIGNED_SQRT_ARCHS = ("MFBCoAtt", "MFHCoAtt")
TRAIN_LOSS_ATOL = 2 * LOGITS_ATOL
# the train CLI phase (9): mutan_att.yaml at full width from the port's init,
# over the eval CLI's synthetic raw VQA v2 set (its train questions cite
# train2014 images, so the one in-memory store holds both 1024-image sets),
# 2 epochs with a step checkpoint every 40 steps; run B is sent SIGTERM once
# epoch 1's step checkpoint at 40 has landed, then resumed. 64 questions go
# to the Predictor from the run's best checkpoint
TRAIN_CLI_EPOCHS = 2
TRAIN_CLI_CKPT_EVERY = 40
TRAIN_CLI_SIGTERM_AT = (1, TRAIN_CLI_CKPT_EVERY)
TRAIN_CLI_SERVED = 64
TRAIN_CLI_KERNELS = ("gather_rows", "lstm_seq", "glimpse_head")
# phase 10: the serving batch the artifacts are frozen at, the val questions
# of the export CLI's --validate gate, each exported arch's registered ops
# (its kernels inside the program), and the ops whose dispatch cost is timed
EXPORT_BATCH = SERVE_BATCH
EXPORT_VALIDATE = 1024
EXPORT_OPS = {"MutanAtt": ("lstm_seq", "glimpse_head"),
              "MFBCoAtt": ("lstm_seq", "glimpse_attend", "mfb_pool", "glimpse_head"),
              "CoR": ("lstm_seq", "relation_attend")}
EXPORT_VISU = ("MutanAtt", "CoR")
# the card-traced MutanAtt program run on the host against the live model's
# plain path on the card: both plain bf16, differing in the order of the
# float32 sums inside each bf16 product (the host's BLAS against cuBLAS's)
# and in the roundings that follow; measured 0.000244 at B=64 (NVIDIA H100
# 80GB HBM3, 700 W), ~20 times that. Answers are held equal wherever the
# plain path's top-2 logits differ by more than twice it
EXPORT_HOST_ATOL = 0.005
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
                       (48, (REGIONS, DIM), SERVE_BATCH), (N_IMAGES, (REGIONS, DIM), BATCH),
                       (48, (GRID, DIM), SERVE_BATCH), (N_IMAGES, (GRID, DIM), BATCH),
                       (48, (DIM,), SERVE_BATCH), (N_IMAGES, (DIM,), BATCH)):
        table = torch.randn((n,) + tail, device=dev).to(torch.bfloat16)
        idx = rng.integers(0, n, b)
        idx[: b // 4] = idx[0]  # repeated rows
        before = gather_rows.launches
        out = gather_rows(table, idx)
        again = gather_rows(table, idx)
        ref = gather_rows_reference(table, torch.from_numpy(idx).to(dev))
        torch.cuda.synchronize()
        _require(torch.equal(out, ref) and torch.equal(out, again),
                 f"gather_rows {tuple(table.shape)} x {b} is bit-exact, twice")
        _require(gather_rows.launches - before == 2 * math.ceil(b / ROWS_PER_LAUNCH),
                 f"one launch per {ROWS_PER_LAUNCH} rows")
    # timed at the eval's index distribution (uniform over the table, so
    # rows repeat: 63% distinct at B=1024), at distinct rows, at the serving
    # batch, over the extracted 196-region table and over the NoAtt archs'
    # pooled table (rows of 2048)
    timing = {}
    for label, n, tail, b in (("", N_IMAGES, (REGIONS, DIM), BATCH),
                              ("distinct_", N_IMAGES, (REGIONS, DIM), BATCH),
                              ("serve_", 48, (REGIONS, DIM), SERVE_BATCH),
                              ("grid_", N_IMAGES, (GRID, DIM), BATCH),
                              ("pooled_", N_IMAGES, (DIM,), BATCH)):
        table = torch.randn((n,) + tail, device=dev).to(torch.bfloat16)
        idx = rng.permutation(n)[:b] if label == "distinct_" else rng.integers(0, n, b)
        row_bytes = math.prod(tail) * 2
        if label in ("", "grid_", "pooled_"):
            # the rows these indices read, once each; the output; the indices
            timing[label + "bound_ms"] = _bound(
                len(np.unique(idx)) * row_bytes + b * row_bytes + 4 * b)[0]
        idx_dev, idx32 = torch.from_numpy(idx).to(dev), _host_indices(idx, n)
        out = torch.empty((b,) + tail, dtype=torch.bfloat16, device=dev)
        timing[label + "ms"], timing[label + "plain_ms"] = _in_turns(
            torch, _device_ms, lambda: launch_gather_rows(table, idx32, out),
            lambda: torch.index_select(table, 0, idx_dev, out=out))
        if not label:
            timing["call_ms"], timing["plain_call_ms"] = _in_turns(
                torch, _median_ms, lambda: gather_rows(table, idx),
                lambda: gather_rows_reference(table, torch.from_numpy(idx).to(dev)))
    _phase("gather_rows",
           shapes="1024x36x2048[1024],48x36x2048[64],1024x196x2048[1024],48x196x2048[64],"
                  "1024x2048[1024],48x2048[64],37x36x72[53],11x3x5[29],50x6[5000]",
           max_abs_err=0.0, tol="exact", bit_equal=True,
           **{k: round(v, 4) for k, v in timing.items()})
    bound_ms = timing.pop("bound_ms")
    return {"max_abs_err": 0.0, **timing, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": timing["plain_ms"],
            "shape": "table 1024x36x2048 bf16, B=1024; ms/plain_ms: device time (index_select "
                     "on indices already on the card); call_ms/plain_call_ms: the whole call "
                     "from host indices; grid_: the extracted table 1024x196x2048; pooled_: the "
                     "NoAtt archs' table 1024x2048; library_ms: "
                     "index_select, the plain version itself"}


def _check_gather_dequant(torch, dev, rng, flagship, pooled):
    """int8 rows gathered and dequantized, bit-exact against the plain chain
    (index_select, cast, multiply) at bf16 and f32 scales and across two
    calls; ``flagship`` is the eval's quantized table (values, scales),
    ``pooled`` that of the NoAtt archs' pooled table [N, 2048]."""
    from vqa_tpu_torch.engine.steps import quantize_features
    from vqa_tpu_torch.ops.gather import (_host_indices, gather_rows_dequant,
                                          gather_rows_dequant_reference,
                                          launch_gather_rows_dequant)

    small = [quantize_features(3 * rng.standard_normal(shape, dtype=np.float32))
             for shape in ((11, 3, 40), (37, 36, 7), (7, 3, 16), (48, REGIONS, DIM), (48, DIM))]
    # (table, batch, timing label: "" the eval's, "serve_", "pooled_"; None: untimed)
    cases = [(small[0], 29, None), (small[1], 53, None), (small[2], 2100, None),
             (small[3], SERVE_BATCH, "serve_"), (small[4], SERVE_BATCH, None),
             (flagship, BATCH, ""), (pooled, BATCH, "pooled_")]
    timing = {}
    for (values, scales), b, label in cases:
        n = values.shape[0]
        values = torch.from_numpy(values).to(dev)
        idx = rng.integers(0, n, b)
        idx[: b // 4] = idx[0]  # repeated rows
        idx_dev = torch.from_numpy(idx).to(dev)
        for sdt in (torch.bfloat16, torch.float32):
            sc = torch.from_numpy(scales).to(dev, sdt)
            out = gather_rows_dequant(values, sc, idx)
            again = gather_rows_dequant(values, sc, idx)
            ref = gather_rows_dequant_reference(values, sc, idx_dev)
            torch.cuda.synchronize()
            _require(out.dtype == sdt and torch.equal(out, ref) and torch.equal(out, again),
                     f"gather_rows_dequant {tuple(values.shape)} x {b}, {sdt} scales, bit-exact, "
                     f"twice")
            if label is not None and (not label or sdt == torch.bfloat16):
                tidx = rng.integers(0, n, b)  # the eval's index distribution
                tidx_dev, tidx32 = torch.from_numpy(tidx).to(dev), _host_indices(tidx, n)
                buf = torch.empty_like(ref)
                key = label + ("" if sdt == torch.bfloat16 else "f32_")
                if key in ("", "pooled_"):
                    # distinct int8 rows and their scales, once; the bf16 output
                    rows, row, segs = len(np.unique(tidx)), values[0].numel(), scales[0].size
                    timing[key + "bound_ms"] = _bound(
                        rows * (row + segs * 2) + b * row * 2 + 4 * b)[0]
                timing[key + "ms"], timing[key + "plain_ms"] = _in_turns(
                    torch, _device_ms,
                    lambda: launch_gather_rows_dequant(values, sc, tidx32, buf),
                    lambda: gather_rows_dequant_reference(values, sc, tidx_dev))
                if not key:
                    timing["call_ms"], timing["plain_call_ms"] = _in_turns(
                        torch, _median_ms, lambda: gather_rows_dequant(values, sc, tidx),
                        lambda: gather_rows_dequant_reference(
                            values, sc, torch.from_numpy(tidx).to(dev)))
        del values, idx_dev, out, again, ref
    _phase("gather_rows_dequant",
           shapes="1024x36x2048[1024],1024x2048[1024],48x36x2048[64],48x2048[64],11x3x40[29],"
                  "37x36x7[53],7x3x16[2100]",
           scales="bf16,f32", max_abs_err=0.0, tol="exact", bit_equal=True,
           **{k: round(v, 4) for k, v in timing.items()})
    bound_ms = timing.pop("bound_ms")
    return {"max_abs_err": 0.0, **timing, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None,
            "shape": "int8 table 1024x36x2048 + bf16 scales, B=1024; ms/plain_ms: device time; "
                     "f32_: float32 scales; pooled_: the NoAtt archs' table 1024x2048 (scales "
                     "1024x1); call_ms/plain_call_ms: the whole call; no one PyTorch call "
                     "gathers and dequantizes"}


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
    # M=510: MutanAtt; M=512: MFB/MFH (the 512-wide hidden layer); M=1024,
    # G=1: ConcatAtt (its 1024-wide hidden layer); M=1200: MLBAtt (the MLB
    # fusion); each at the eval and the serving batch; then 8 glimpses, the
    # 196-region grid (MutanAtt over the extracted table: the eval batch too)
    # and odd shapes
    for B, R, M, G, D in ((BATCH, REGIONS, 510, 2, DIM), (SERVE_BATCH, REGIONS, 510, 2, DIM),
                          (BATCH, REGIONS, 512, 2, DIM), (BATCH, REGIONS, 1024, 1, DIM),
                          (SERVE_BATCH, REGIONS, 1024, 1, DIM), (BATCH, REGIONS, 1200, 2, DIM),
                          (SERVE_BATCH, REGIONS, 1200, 2, DIM), (SERVE_BATCH, REGIONS, 510, 8, DIM),
                          (SERVE_BATCH, GRID, 510, 2, DIM), (BATCH, GRID, 510, 2, DIM),
                          (37, 36, 45, 2, 72), (5, 7, 33, 3, 75)):
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
        if D == DIM and G <= 2 and (R == REGIONS or B == BATCH):
            ms, plain = _in_turns(torch, _median_ms, lambda: glimpse_head(joint, w, b, v),
                                  lambda: glimpse_head_reference(joint, w, b, v))
            device = _device_ms(torch, lambda: glimpse_head(joint, w, b, v))
            bound, by = _glimpse_head_bound(B, R, M, G, D)
            key = (f"B{B}_M{M}" + ("" if G == 2 else f"_G{G}")
                   + ("" if R == REGIONS else f"_R{R}"))
            timing[key] = dict(ms=ms, plain_ms=plain, device_ms=device, bound_ms=bound,
                               bound_by=by, pct_of_bound=100 * bound / ms,
                               device_pct_of_bound=100 * bound / device, plan=plan["copy"])
            line.update({k: (round(x, 4) if isinstance(x, float) else x)
                         for k, x in timing[key].items() if k != "plan"})
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
        (seq2vec, "lstm_seq", lambda xg, mask, wh, **_: lstm_seq_reference(xg, mask, wh)),
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


def _synthetic_eval_arrays(rng: np.random.Generator, n_questions: int,
                           with_table: bool = True):
    """bench.py:39-58: VQA v2 question lengths (mean ~6.2, sd ~2.2, clipped
    to [3, 26]), 12,000 words, a [N_IMAGES, 36, 2048] table (or None)."""
    from vqa_tpu_torch.flagship import NUM_WORDS

    questions = rng.integers(1, NUM_WORDS, (n_questions, SEQ), dtype=np.int32)
    lengths = np.clip(np.round(rng.normal(6.2, 2.2, n_questions)), 3, SEQ).astype(np.int32)
    questions *= (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    image_index = rng.integers(0, N_IMAGES, n_questions).astype(np.int32)
    table = (rng.standard_normal((N_IMAGES, REGIONS, DIM), dtype=np.float32) if with_table
             else None)
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
    eval over the bf16 table and over the int8 one (the NoAtt archs: the
    pooled tables), and its serve phase; return the launch counts of all
    three (MutanAtt and CoR: also one forward over the 196-region grid)."""
    from vqa_tpu_torch.flagship import answer_count, build_config
    from vqa_tpu_torch.weights import random_params

    name, kernels = ARCHS[arch]
    num_answers = answer_count(name)
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


def _eval_cli_phase(torch, dev, table: np.ndarray, pooled: np.ndarray) -> dict:
    """The port's eval CLI at the full width of options/vqa2/mutan_att.yaml
    and of mutan_noatt.yaml (over ``pooled``, the bottomup36 noatt store)
    over a synthetic raw VQA v2 set (docstring, phase 6); returns the launch
    counts of its kernel runs (bf16 and int8 tables, and the noatt run)."""
    import dataclasses
    import io

    from vqa_tpu_torch.cli import score as score_cli
    from vqa_tpu_torch.cli import train as train_cli
    from vqa_tpu_torch.config import load_options
    from vqa_tpu_torch.datasets import factory as data_factory
    from vqa_tpu_torch.datasets.features import FeatureStore
    from vqa_tpu_torch.datasets.interim import RAW_FILES, image_name
    from vqa_tpu_torch.flagship import NUM_WORDS
    from vqa_tpu_torch.models.factory import factory as model_factory
    from vqa_tpu_torch.weights import export_params, random_params

    yamls = {"att": os.path.join(_REPO, "options", "vqa2", "mutan_att.yaml"),
             "noatt": os.path.join(_REPO, "options", "vqa2", "mutan_noatt.yaml")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_cli_") as tmp:
        t0 = time.perf_counter()
        _write_raw_vqa2(os.path.join(tmp, "vqa2", "raw"), np.random.default_rng(0))
        raw_s = time.perf_counter() - t0
        data = [f"vqa.dir={tmp}/vqa2", f"coco.dir={tmp}/coco"]
        # no h5py on the card's machine: each table stands in the store cache
        # where its HDF5 file (bottomup36_att, bottomup36_noatt) would be read
        names = [image_name("val2014", i) for i in range(N_IMAGES)]
        argvs, store_keys = {}, []
        for mode, features in (("att", table), ("noatt", pooled)):
            opt = load_options(yamls[mode], data)
            _require(opt.coco.mode == mode, f"{yamls[mode]} reads the {mode} table")
            key = (opt.coco.dir, opt.coco.arch, opt.coco.mode, "ram")
            data_factory._STORE_CACHE[key] = FeatureStore.in_memory(names, features)
            store_keys.append(key)
            t0 = time.perf_counter()
            val_set = data_factory.factory("val", opt)  # the port's prep, on first use
            if mode == "att":
                prep_s = time.perf_counter() - t0
            _require(val_set.feature_shape == features.shape[1:],
                     f"the {mode} store's rows {val_set.feature_shape}")
            model = model_factory(dataclasses.asdict(opt.model), val_set.num_words,
                                  val_set.num_answers, dtype=torch.bfloat16, device=dev,
                                  dim_v=val_set.feature_shape[-1])
            random_params(model, seed=0)
            npz = os.path.join(tmp, f"params_{mode}.npz")
            np.savez(npz, **export_params(model))
            del model
            argvs[mode] = ["--path_opt", yamls[mode], "-e", "--split", "val"]
            for o in data + [f"model.pretrained_params={npz}", "engine.device_features=true",
                             "optim.eval_batch_size=1024"]:
                argvs[mode] += ["--opt", o]
        split = val_set.split
        _require(val_set.num_answers == opt.vqa.nans, f"answer vocabulary {val_set.num_answers} "
                 f"== nans {opt.vqa.nans}")
        _require(val_set.num_words >= 0.99 * NUM_WORDS, f"word vocabulary {val_set.num_words} "
                 f"~ {NUM_WORDS}")
        _require(len(split) == CLI_QUESTIONS and len(split) % BATCH, "a padded last batch")

        runs = {}
        for label, mode, features_dtype, plain in (("bf16", "att", "bfloat16", False),
                                                   ("plain", "att", "bfloat16", True),
                                                   ("int8", "att", "int8", False),
                                                   ("noatt", "noatt", "bfloat16", False),
                                                   ("noatt_plain", "noatt", "bfloat16", True)):
            logs = os.path.join(tmp, "logs", label)
            _reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    (_plain_ops(torch) if plain else contextlib.nullcontext()):
                rc = train_cli.main(argvs[mode] + ["--dir_logs", logs, "--opt",
                                                   f"engine.features_dtype={features_dtype}"])
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
                "int8": {"gather_rows_dequant", "lstm_seq", "glimpse_head"},
                "noatt": set(CLI_NOATT_KERNELS), "noatt_plain": set()}
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

        def agreement(a, b):
            return float(np.mean([runs[a]["results"][q] == ans
                                  for q, ans in runs[b]["results"].items()]))

        agree, noatt_agree = agreement("bf16", "plain"), agreement("noatt", "noatt_plain")
        _require(agree >= PRED_AGREE_FLOOR and noatt_agree >= PRED_AGREE_FLOOR,
                 f"eval CLI answers agree with the plain run's on {agree} (noatt: {noatt_agree}) "
                 f">= {PRED_AGREE_FLOOR}")
        int8_agree = agreement("bf16", "int8")

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
        for key in store_keys:
            del data_factory._STORE_CACHE[key]

    _phase("eval_cli", archs="MutanAtt,MutanNoAtt", questions=len(split), images=N_IMAGES,
           batch=BATCH, batches=-(-len(split) // BATCH), padded_rows=-len(split) % BATCH,
           n_labeled=runs["bf16"]["metrics"]["n_labeled"], words=val_set.num_words,
           answers=val_set.num_answers, raw_s=round(raw_s, 3), prep_s=round(prep_s, 3),
           **{f"{label}_{key}": value for label, run in runs.items()
              for key, value in (("qa_per_sec", round(run["metrics"]["qa_per_sec"], 1)),
                                 ("eval_time", round(run["metrics"]["eval_time"], 4)),
                                 ("cli_s", round(run["wall"], 3)),
                                 ("acc1", run["metrics"]["acc1"]))},
           score_overall=report["overall"], pred_agree_plain=round(agree, 5),
           noatt_pred_agree_plain=round(noatt_agree, 5),
           floor=PRED_AGREE_FLOOR, pred_agree_int8=round(int8_agree, 5),
           **{f"{label}_launches": {k: c for k, c in runs[label]["counts"].items() if c}
              for label in ("bf16", "int8", "noatt")})
    return {k: sum(runs[label]["counts"][k] for label in ("bf16", "int8", "noatt"))
            for k in runs["bf16"]["counts"]}


# ----------------------------------------------------------------- train


def _relative(got, want) -> float:
    """The relative Frobenius error of ``got`` against ``want``."""
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def _fwd_bwd_ms(torch, fn, args, cots):
    """Median time of ``fn``'s forward and the backward to ``args``."""
    return _median_ms(torch, lambda: torch.autograd.grad(fn(*args), args, cots), iters=10)


def _hold_train_op(torch, op, fn, reference, bf, cots, names, fwd_tol, card, shape,
                   check=None) -> dict:
    """One autograd Function on the card (phase 7): its forward and every
    input grad against float32 autograd through ``reference`` on the same
    bf16 inputs ``bf``, the plain bf16 path's own errors beside; ``check``
    (the grads) -> a further hold's failure text or None. Returns the
    median fwd+bwd times of the Function and of the plain path."""
    args = [x.clone().requires_grad_() for x in bf]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    got = torch.autograd.grad(outs, args, cots)
    ref = [x.float().requires_grad_() for x in bf]
    ref_outs = reference(*ref)
    ref_outs = ref_outs if isinstance(ref_outs, tuple) else (ref_outs,)
    want = torch.autograd.grad(ref_outs, ref, [c.float() for c in cots])
    plain = [x.clone().requires_grad_() for x in bf]
    plain_grads = torch.autograd.grad(reference(*plain), plain, cots)
    fwd_err = max((o.float() - r).abs().max().item() for o, r in zip(outs, ref_outs))
    errs = {n: _relative(g, x) for n, g, x in zip(names, got, want)}
    where = f"{op} train {shape}"
    _require(fwd_err <= fwd_tol, f"{where}: forward err {fwd_err} <= {fwd_tol}")
    _require(all(bool(torch.isfinite(g).all()) for g in got), f"{where}: finite grads")
    for name, err in errs.items():
        _require(err <= TRAIN_GRAD_RTOL, f"{where}: {name} relative error {err} <= "
                 f"{TRAIN_GRAD_RTOL}")
    failed = check(got) if check else None
    _require(failed is None, f"{where}: {failed}")
    ms, plain_ms = _in_turns(torch, lambda _t, timer: timer(),
                             lambda: _fwd_bwd_ms(torch, fn, args, cots),
                             lambda: _fwd_bwd_ms(torch, reference, plain, cots))
    _phase("train_ops", op=op, **shape, card=card, fwd_max_abs_err=round(fwd_err, 5),
           fwd_tol=fwd_tol, **{f"{k}_rel_err": round(x, 5) for k, x in errs.items()},
           **{f"plain_bf16_{n}_rel_err": round(_relative(g, x), 5)
              for n, g, x in zip(names, plain_grads, want)},
           grad_rtol=TRAIN_GRAD_RTOL, fwd_bwd_ms=round(ms, 4), plain_fwd_bwd_ms=round(plain_ms, 4))
    return dict(fwd_bwd_ms=ms, plain_fwd_bwd_ms=plain_ms)


def _masked_grads_zero(torch, dlogits, logits):
    """None where every masked logit of a partly masked row takes a zero
    grad (alpha is 0 there), else what failed."""
    masked = logits == torch.finfo(logits.dtype).min
    partly = masked & (~masked).any(dim=1, keepdim=True)
    if not bool(partly.any()) or not bool((dlogits[partly] == 0).all()):
        return "the masked logits of partly masked rows take a zero grad"
    return None


def _check_train_ops(torch, dev, rng, card) -> dict:
    """The train path's autograd Functions (lstm_seq(train=True),
    glimpse_head, glimpse_attend, mfb_pool, relation_attend), forward and
    every input grad, on the card against float32 autograd through their
    plain versions on the same bf16 inputs (phase 7); returns their fwd+bwd
    times by shape."""
    from vqa_tpu_torch.ops.attention import (glimpse_attend, glimpse_attend_reference,
                                             glimpse_head, glimpse_head_reference)
    from vqa_tpu_torch.ops.lstm import _bm_bwd, _bm_fwd, lstm_seq, lstm_seq_reference
    from vqa_tpu_torch.ops.mfb_pool import mfb_pool, mfb_pool_reference
    from vqa_tpu_torch.ops.relation import relation_attend, relation_attend_reference

    out = {"lstm_seq": {}, "glimpse_head": {}, "glimpse_attend": {}, "mfb_pool": {},
           "relation_attend": {}}
    for T, H in TRAIN_LSTM_SHAPES:
        xg, mask, wh = _lstm_inputs(torch, dev, rng, T, TRAIN_BATCH, H)
        mask[:, 3] = 0  # one fully padded row
        cots = [torch.randn(TRAIN_BATCH, H, device=dev).to(torch.bfloat16),
                torch.randn(T, TRAIN_BATCH, H, device=dev).to(torch.bfloat16)]
        args = [x.clone().requires_grad_() for x in (xg, mask, wh)]
        outs = lstm_seq(*args, train=True)
        got = torch.autograd.grad(outs, args, cots)
        ref = [x.float().requires_grad_() for x in (xg, mask, wh)]
        ref_outs = lstm_seq_reference(*ref)
        want = torch.autograd.grad(ref_outs, ref, [c.float() for c in cots])
        plain = [x.clone().requires_grad_() for x in (xg, wh)]
        plain_grads = torch.autograd.grad(lstm_seq_reference(plain[0], mask, plain[1]), plain,
                                          cots)
        fwd_err = max((o.float() - r).abs().max().item() for o, r in zip(outs, ref_outs))
        errs = {"dxg": _relative(got[0], want[0]), "dwh": _relative(got[2], want[2])}
        plain_errs = {"dxg": _relative(plain_grads[0], want[0]),
                      "dwh": _relative(plain_grads[1], want[2])}
        _require(fwd_err <= LSTM_ATOL, f"lstm_seq train T={T} H={H}: forward err {fwd_err}")
        for name, err in errs.items():
            _require(err <= TRAIN_GRAD_RTOL, f"lstm_seq train T={T} H={H}: {name} relative "
                     f"error {err} <= {TRAIN_GRAD_RTOL}")
        _require(bool((got[1] == 0).all()), f"lstm_seq train T={T} H={H}: dmask exactly 0")
        # times: the kernel's forward + the plain backward, against autograd
        # through the plain version; the recompute and the backward scan alone
        ms, plain_ms = _in_turns(
            torch, lambda _t, fn: fn(),
            lambda: _fwd_bwd_ms(torch, lambda x, w: lstm_seq(x, mask, w, train=True),
                                [args[0], args[2]], cots),
            lambda: _fwd_bwd_ms(torch, lambda x, w: lstm_seq_reference(x, mask, w), plain, cots))
        with torch.no_grad():
            recompute_ms = _median_ms(torch, lambda: _bm_fwd(xg, mask, wh), iters=10)
            residuals = _bm_fwd(xg, mask, wh)[1]
            scan_ms = _median_ms(torch, lambda: _bm_bwd(mask, wh, residuals, *cots), iters=10)
        key = f"T{T}_B{TRAIN_BATCH}" + ("" if H == 2400 else f"_H{H}")
        out["lstm_seq"][key] = dict(fwd_bwd_ms=ms, plain_fwd_bwd_ms=plain_ms,
                                    recompute_ms=recompute_ms, backward_scan_ms=scan_ms)
        _phase("train_ops", op="lstm_seq", T=T, B=TRAIN_BATCH, H=H, card=card,
               fwd_max_abs_err=round(fwd_err, 5), fwd_tol=LSTM_ATOL,
               **{f"{k}_rel_err": round(v, 5) for k, v in errs.items()},
               **{f"plain_bf16_{k}_rel_err": round(v, 5) for k, v in plain_errs.items()},
               grad_rtol=TRAIN_GRAD_RTOL, dmask_zero=True,
               **{k: round(v, 4) for k, v in out["lstm_seq"][key].items()},
               recompute_share=round(recompute_ms / ms, 4))
        del xg, mask, wh, args, outs, got, ref, ref_outs, want, plain, plain_grads, residuals
    for M, G in TRAIN_GLIMPSE_SHAPES:
        joint = torch.tanh(torch.randn(TRAIN_BATCH, REGIONS, M, device=dev)).to(torch.bfloat16)
        w = (torch.randn(M, G, device=dev) / M ** 0.5).to(torch.bfloat16)
        b = (0.1 * torch.randn(G, device=dev)).to(torch.bfloat16)
        v = torch.randn(TRAIN_BATCH, REGIONS, DIM, device=dev).to(torch.bfloat16)
        cots = [torch.randn(TRAIN_BATCH, G, DIM, device=dev).to(torch.bfloat16),
                torch.randn(TRAIN_BATCH, REGIONS, G, device=dev).to(torch.bfloat16)]
        key = f"B{TRAIN_BATCH}_M{M}" + ("" if G == 2 else f"_G{G}")
        out["glimpse_head"][key] = _hold_train_op(
            torch, "glimpse_head", glimpse_head, glimpse_head_reference, [joint, w, b, v], cots,
            ("djoint", "dw", "db", "dv"), GLIMPSE_ATOL, card,
            dict(B=TRAIN_BATCH, R=REGIONS, M=M, G=G, D=DIM))
        del joint, w, b, v, cots
    # MFB's question self-attention: masked logits (row 0 masked whole)
    for T in TRAIN_ATTEND_T:
        logits = _masked_logits(torch, dev, rng, TRAIN_BATCH, T, 2)
        v = torch.randn(TRAIN_BATCH, T, 1024, device=dev).to(torch.bfloat16)
        cots = [torch.randn(TRAIN_BATCH, 2, 1024, device=dev).to(torch.bfloat16)]
        out["glimpse_attend"][f"T{T}_B{TRAIN_BATCH}"] = _hold_train_op(
            torch, "glimpse_attend", glimpse_attend, glimpse_attend_reference, [logits, v], cots,
            ("dlogits", "dv"), GLIMPSE_ATOL, card, dict(B=TRAIN_BATCH, T=T, G=2, D=1024),
            check=lambda grads, lg=logits: _masked_grads_zero(torch, grads[0], lg))
        del logits, v, cots
    # MFB's pools: the region attention's B*36 rows and the final fusion's B
    for n in (TRAIN_BATCH * REGIONS, TRAIN_BATCH):
        z = torch.randn(n, 5 * 1000, device=dev).to(torch.bfloat16)
        cots = [torch.randn(n, 1000, device=dev).to(torch.bfloat16)]
        out["mfb_pool"][f"n{n}"] = _hold_train_op(
            torch, "mfb_pool", lambda x: mfb_pool(x, 5), lambda x: mfb_pool_reference(x, 5),
            [z], cots, ("dz",), MFB_POOL_ATOL, card, dict(n=n, k=5, m=1000))
        del z, cots
    # CoR's chain step: pg = p * g and r, each a tanh
    pg, r = (torch.tanh(torch.randn(TRAIN_BATCH, REGIONS, 1024, device=dev)).to(torch.bfloat16)
             for _ in range(2))
    cots = [torch.randn(TRAIN_BATCH, REGIONS, 1024, device=dev).to(torch.bfloat16)]
    out["relation_attend"][f"B{TRAIN_BATCH}_N{REGIONS}"] = _hold_train_op(
        torch, "relation_attend", relation_attend, relation_attend_reference, [pg, r], cots,
        ("dpg", "dr"), RELATION_ATOL, card, dict(B=TRAIN_BATCH, N=REGIONS, D=1024))
    del pg, r, cots
    torch.cuda.empty_cache()
    return out


def _train_split(rng: np.random.Generator, n: int, table: np.ndarray):
    """A synthetic VQA v2 train split over the table's N_IMAGES images:
    bench.py's question lengths over NUM_WORDS words, answers drawn from the
    2000 with weights 1 / (rank + 10) (a long tail, as VQA's), as a
    VQA2Dataset the loader batches (image indices, not rows)."""
    from vqa_tpu_torch.config import VQAOptions
    from vqa_tpu_torch.datasets.features import FeatureStore
    from vqa_tpu_torch.datasets.processed import ProcessedSplit, Vocabs
    from vqa_tpu_torch.datasets.vqa2 import VQA2Dataset
    from vqa_tpu_torch.flagship import NUM_ANSWERS, NUM_WORDS

    questions, lengths, image_index, _ = _synthetic_eval_arrays(rng, n, with_table=False)
    weights = 1.0 / (np.arange(NUM_ANSWERS) + 10.0)
    answers = rng.choice(NUM_ANSWERS, n, p=weights / weights.sum()).astype(np.int32)
    names = [f"img{i}" for i in range(N_IMAGES)]
    split = ProcessedSplit(question_ids=np.arange(n, dtype=np.int64), questions=questions,
                           lengths=lengths, image_names=np.array(names)[image_index],
                           answers=answers, answer_pool=None)
    vocabs = Vocabs(["<pad>", "<unk>"] + [f"w{i}" for i in range(NUM_WORDS - 2)],
                    [f"a{i}" for i in range(NUM_ANSWERS)])
    return VQA2Dataset(split, vocabs, FeatureStore.in_memory(names, table), VQAOptions(),
                       "train", visual_mode="index")


def _loss_grads(torch, model, batch, features, plain=False, float32=False):
    """(float loss, grads, global norm) of one step's loss, dropout off,
    through the kernels or the plain versions, in the compute dtype or, with
    ``float32``, in float32 compute (the plain versions only)."""
    from vqa_tpu_torch.engine import optim, steps

    dtypes = {m: m.dtype for m in model.modules() if float32 and hasattr(m, "dtype")}
    for m in dtypes:
        m.dtype = torch.float32
    params = [p for p in model.parameters() if p.requires_grad]
    try:
        with (_plain_ops(torch) if plain else contextlib.nullcontext()):
            with torch.no_grad():
                visual = steps._resolve_visual(batch, features)
            loss, _, grads = steps.loss_and_grads(model, params, batch, visual,
                                                  optim.criterion_factory())
    finally:
        for m, dt in dtypes.items():
            m.dtype = dt
    return loss.float().item(), grads, optim.global_norm(grads).item()


def _grads_agree(torch, model, batch, features, arch) -> dict:
    """Hold 1 of phase 8: one step's loss and grads from the same weights and
    batch, dropout off, through the kernels and through the plain versions
    on the card. Where the MFB family's grads differ by more than the
    tolerance, the plain path is held to float32 autograd too: such a grad
    must be one that bf16 cannot reproduce (the plain path's own error
    against float32 past the tolerance), else the hold fails."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    (loss, grads, gnorm), (plain_loss, plain_grads, plain_gnorm) = (
        _loss_grads(torch, model, batch, features, plain=plain) for plain in (False, True))

    def rel(g, want, floor):
        return float((g.float() - want.float()).norm()) / max(float(want.float().norm()), floor)

    floor = TRAIN_GRAD_FLOOR * plain_gnorm
    errs, zero_grads = {}, {}
    for n, g, p in zip(names, grads, plain_grads):
        if n.endswith(SOFTMAX_BLIND):
            zero_grads[n] = max(float(g.float().norm()), float(p.float().norm())) / plain_gnorm
        else:
            errs[n] = rel(g, p, floor)
    gnorm_err = abs(gnorm - plain_gnorm) / plain_gnorm
    over = {n: e for n, e in errs.items() if e > TRAIN_GRAD_RTOL}
    unstable = {}
    if over or gnorm_err > TRAIN_GRAD_RTOL:
        _require(arch in SIGNED_SQRT_ARCHS,
                 f"{arch} train step: grads {over} or gnorm {gnorm} vs plain {plain_gnorm} beyond "
                 f"{TRAIN_GRAD_RTOL} of the plain path")
        _, f32_grads, f32_gnorm = _loss_grads(torch, model, batch, features, plain=True,
                                              float32=True)
        f32_floor = TRAIN_GRAD_FLOOR * f32_gnorm
        for n, g, p, f in zip(names, grads, plain_grads, f32_grads):
            if n in over:
                unstable[n] = (over[n], rel(p, f, f32_floor), rel(g, f, f32_floor))
        plain_f32_gnorm_err = abs(plain_gnorm - f32_gnorm) / f32_gnorm
        _require(all(e_pf > TRAIN_GRAD_RTOL for _, e_pf, _ in unstable.values()),
                 f"{arch} train step: a grad beyond {TRAIN_GRAD_RTOL} of the plain path where "
                 f"the plain path is within it of float32 autograd (kernel-plain, plain-float32, "
                 f"kernel-float32): {unstable}")
        _require(gnorm_err <= TRAIN_GRAD_RTOL or plain_f32_gnorm_err > TRAIN_GRAD_RTOL,
                 f"{arch} train step: gnorm {gnorm} vs plain {plain_gnorm}, where the plain "
                 f"gnorm is within {TRAIN_GRAD_RTOL} of float32's {f32_gnorm}")
    held = {n: e for n, e in errs.items() if n not in unstable}
    worst = max(held, key=held.get)
    _require(all(z <= TRAIN_GRAD_FLOOR for z in zero_grads.values()),
             f"{arch} train step: the softmax-blind biases' grads are 0 but for rounding on "
             f"both paths: {zero_grads} <= {TRAIN_GRAD_FLOOR} of the global norm")
    _require(math.isfinite(loss) and abs(loss - plain_loss) <= TRAIN_LOSS_ATOL,
             f"{arch} train step: loss {loss} vs plain {plain_loss} within {TRAIN_LOSS_ATOL}")
    _require(held[worst] <= TRAIN_GRAD_RTOL,
             f"{arch} train step: grad {worst} relative error {held[worst]} <= {TRAIN_GRAD_RTOL}")
    _require(all(bool(torch.isfinite(g).all()) for g in grads), f"{arch} train step: finite grads")
    out = {"loss": round(loss, 5), "plain_loss": round(plain_loss, 5),
           "loss_tol": TRAIN_LOSS_ATOL, "grad_worst_leaf": worst,
           "grad_worst_rel_err": round(held[worst], 5), "grad_rtol": TRAIN_GRAD_RTOL,
           "grads_held": len(held),
           "blind_bias_grad_over_gnorm": {n: f"{z:.2e}" for n, z in zero_grads.items()},
           "gnorm": round(gnorm, 5), "plain_gnorm": round(plain_gnorm, 5),
           "gnorm_rel_err": round(gnorm_err, 6)}
    if unstable:
        out.update(bf16_unstable_grads=len(unstable), float32_gnorm=round(f32_gnorm, 5),
                   bf16_unstable={n: "/".join(f"{x:.3f}" for x in e)
                                  for n, e in sorted(unstable.items())})
    return out


def _train_model(torch, dev, name):
    """The training build of a config at full width, bf16 compute over
    float32 parameters, random seeded weights."""
    from vqa_tpu_torch.flagship import NUM_WORDS, answer_count, model_options
    from vqa_tpu_torch.models.factory import factory
    from vqa_tpu_torch.weights import random_params

    model = factory(model_options(name=name), NUM_WORDS, answer_count(name),
                    dtype=torch.bfloat16, device=dev, train=True)
    random_params(model, seed=0)
    return model


def _held_loss(torch, model, batches, features, criterion) -> float:
    """The mean float32 CE of the model's logits over ``batches``, dropout
    off."""
    from vqa_tpu_torch.engine import steps

    with torch.no_grad():
        return float(np.mean([
            criterion(model(steps._resolve_visual(b, features), b["question"]).float(),
                      b["answer"]).mean().item() for b in batches]))


def _finite_params(torch, model) -> bool:
    return all(bool(torch.isfinite(p).all()) for p in model.parameters())


def _step_launches(arch: str) -> dict:
    """The kernels one train step of ``arch`` launches, and how often."""
    return {k: TRAIN_STEP_LAUNCHES.get(arch, {}).get(k, 1) for k in ARCHS[arch][1]}


def _full_train(torch, dev, arch, name, loader, batches, table, card) -> dict:
    """Phase 8 for one arch at full width (the docstring): hold 1, one step's
    launches, the epoch through engine.train, learning on the float32 loss
    of fixed batches, timed steps on both paths, the LSTM recompute's share
    and the peak memory; returns the launch counts."""
    from vqa_tpu_torch.config import load_options
    from vqa_tpu_torch.engine import engine as engine_lib
    from vqa_tpu_torch.engine import optim, steps
    from vqa_tpu_torch.ops.lstm import _bm_fwd

    opt = load_options(os.path.join(_REPO, "options", "vqa2", f"{name}.yaml"))
    _require(opt.optim.batch_size == TRAIN_BATCH and opt.optim.optimizer == "adam",
             f"{name}.yaml trains adam at batch {TRAIN_BATCH}")
    torch.cuda.reset_peak_memory_stats()
    criterion = optim.criterion_factory()
    per_step = _step_launches(arch)
    model = _train_model(torch, dev, name)
    agree = _grads_agree(torch, model, batches[0], table, arch)

    state = steps.create_state(model, optim.factory(opt.optim, loader.steps_per_epoch()))
    train_step = steps.make_train_step(criterion, opt.engine.seed)
    _reset_counts()
    train_step(state, batches[0], table)
    torch.cuda.synchronize()
    one_step = _read_counts()
    _require({k: c for k, c in one_step.items() if c} == per_step,
             f"{arch}: one train step launches {per_step}, nothing in the backward: {one_step}")

    # the epoch, with the YAML's dropout, from fresh weights
    model = _train_model(torch, dev, name)
    state = steps.create_state(model, optim.factory(opt.optim, loader.steps_per_epoch()))
    held = batches[-TRAIN_HELD_BATCHES:]
    held_before = _held_loss(torch, model, held, table, criterion)
    seen = []

    def recording_step(s, batch, features=None):
        s, metrics = train_step(s, batch, features)
        seen.append(metrics)
        return s, metrics

    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # engine.train's print lines
        state, avgs = engine_lib.train(loader, state, recording_step, None, 0,
                                       print_freq=opt.engine.print_freq, features=table)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = _read_counts()
    n_steps = len(seen)
    losses = [float(m["loss"]) for m in seen]
    gnorms = [float(m["gnorm"]) for m in seen]
    _require(n_steps == loader.steps_per_epoch() and state.step == n_steps,
             f"{arch}: the epoch ran its {loader.steps_per_epoch()} steps")
    _require({k: c for k, c in counts.items() if c} == {k: n * n_steps
                                                         for k, n in per_step.items()},
             f"{arch}: the epoch launched {per_step} a step: {counts}")
    _require(all(math.isfinite(x) for x in losses + gnorms) and _finite_params(torch, model),
             f"{arch}: finite losses, gnorms and parameters")
    last5 = float(np.mean(losses[-5:]))
    held_after = _held_loss(torch, model, held, table, criterion)
    _require(held_after < held_before, f"{arch}: the loss falls: the float32 loss of "
             f"{len(held)} fixed batches, dropout off, {held_after} after the epoch < "
             f"{held_before} before")
    _require(abs(avgs["loss"] - float(np.mean(losses))) < 1e-4, f"{arch}: the epoch's mean loss")

    # step time on both paths (host clock after sync), the recompute alone
    timed = batches[1:1 + TRAIN_TIMED_STEPS]

    def step_times():
        out = []
        for b in timed:
            torch.cuda.synchronize()
            t = time.perf_counter()
            train_step(state, b, table)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return out

    def plain_step_times():
        with _plain_ops(torch):
            return step_times()

    kernel_s, plain_s = [], []
    for fn, out in ((plain_step_times, plain_s), (step_times, kernel_s),
                    (step_times, kernel_s), (plain_step_times, plain_s)):
        out.extend(fn())
    lstm = model.encoder.lstm_0
    rec_ms = {}
    with torch.no_grad():
        for b in timed:
            T = b["question"].shape[1]
            if T not in rec_ms:
                x = model.encoder.embed(b["question"]).transpose(0, 1)
                xg = x @ lstm.wx.to(torch.bfloat16) + lstm.b.to(torch.bfloat16)
                mask = (b["question"] != 0).to(torch.bfloat16).T.unsqueeze(-1).contiguous()
                wh = lstm.wh.to(torch.bfloat16)
                rec_ms[T] = _median_ms(torch, lambda: _bm_fwd(xg, mask, wh), iters=10)
    step_ms, plain_step_ms = (statistics.median(kernel_s) * 1e3,
                              statistics.median(plain_s) * 1e3)
    # the recompute's share of a step: its mean time over the timed batches'
    # lengths against their mean step time
    recompute_share = (float(np.mean([rec_ms[b["question"].shape[1]] for b in timed]))
                       / (float(np.mean(kernel_s)) * 1e3))
    peak = torch.cuda.max_memory_allocated()
    _phase("train", arch=arch, card=card, questions=TRAIN_QUESTIONS, batch=TRAIN_BATCH,
           steps=n_steps, buckets=[b["question"].shape[1] for b in batches],
           bucket_window=TRAIN_BUCKET_WINDOW, optimizer=opt.optim.optimizer, lr=opt.optim.lr,
           **agree, one_step_launches={k: c for k, c in one_step.items() if c},
           epoch_launches={k: c for k, c in counts.items() if c},
           held_loss_before=round(held_before, 6), held_loss_after=round(held_after, 6),
           first_loss=round(losses[0], 5), last5_mean_loss=round(last5, 5),
           epoch_mean_loss=round(avgs["loss"], 5), epoch_mean_gnorm=round(avgs["gnorm"], 5),
           epoch_s=round(epoch_s, 4), epoch_qa_per_s=round(n_steps * TRAIN_BATCH / epoch_s, 1),
           timed_steps=len(timed), timed_buckets=[b["question"].shape[1] for b in timed],
           step_ms=round(step_ms, 4), plain_step_ms=round(plain_step_ms, 4),
           qa_per_s=round(TRAIN_BATCH / step_ms * 1e3, 1),
           plain_qa_per_s=round(TRAIN_BATCH / plain_step_ms * 1e3, 1),
           recompute_ms_by_T={t: round(m, 4) for t, m in sorted(rec_ms.items())},
           recompute_share=round(recompute_share, 4),
           max_memory_allocated_bytes=peak)
    del model, state, seen
    torch.cuda.empty_cache()
    return {k: counts[k] + one_step[k] for k in counts}


def _train_phase(torch, dev, host_table, table, pooled, card) -> dict:
    """Phase 8: MutanAtt's and MFBCoAtt's training at full width over a
    synthetic train split (the docstring), then the other archs' few steps;
    returns the launch counts of the train runs."""
    from vqa_tpu_torch.config import load_options
    from vqa_tpu_torch.datasets.pipeline import BatchIterator
    from vqa_tpu_torch.engine import engine as engine_lib
    from vqa_tpu_torch.engine import optim, steps

    opt = load_options(os.path.join(_REPO, "options", "vqa2", "mutan_att.yaml"))
    dataset = _train_split(np.random.default_rng(0), TRAIN_QUESTIONS, host_table)
    loader = BatchIterator(dataset, TRAIN_BATCH, shuffle=True, seed=opt.engine.seed,
                           drop_last=True, bucket_window=TRAIN_BUCKET_WINDOW,
                           length_buckets=BUCKETS,
                           transform=engine_lib.make_device_transform(dev))
    _require(loader.steps_per_epoch() >= 30, "an epoch of at least 30 steps")
    batches = list(loader.epoch(1))  # batches for the holds and the timings
    launches = dict.fromkeys(_counters(), 0)
    for arch, name in TRAIN_FULL.items():
        for k, c in _full_train(torch, dev, arch, name, loader, batches, table, card).items():
            launches[k] += c

    # the other archs: hold 1, then a few steps with dropout (mutan_att.yaml's
    # optimizer)
    train_step = steps.make_train_step(optim.criterion_factory(), opt.engine.seed)
    for arch, name in TRAIN_ARCHS.items():
        features = pooled if arch in NOATT_ARCHS else table
        model = _train_model(torch, dev, name)
        agree = _grads_agree(torch, model, batches[0], features, arch)
        state = steps.create_state(model, optim.factory(opt.optim, loader.steps_per_epoch()))
        _reset_counts()
        metrics = [train_step(state, b, features)[1] for b in batches[:TRAIN_ARCH_STEPS]]
        torch.cuda.synchronize()
        counts = _read_counts()
        kernels = {k: n * TRAIN_ARCH_STEPS for k, n in _step_launches(arch).items()}
        _require({k: c for k, c in counts.items() if c} == kernels,
                 f"{arch}: {TRAIN_ARCH_STEPS} steps launched {kernels}: {counts}")
        losses = [float(m["loss"]) for m in metrics]
        _require(all(math.isfinite(x) for x in losses) and _finite_params(torch, model),
                 f"{arch}: finite losses and parameters")
        _phase("train", arch=arch, card=card, steps=TRAIN_ARCH_STEPS, **agree,
               launches={k: c for k, c in counts.items() if c},
               losses=[round(x, 5) for x in losses])
        for k in launches:
            launches[k] += counts[k]
        del model, state
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- train CLI


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _train_cli_phase(torch, dev, host_table: np.ndarray, card: str, tmp: str):
    """Phase 9 (the docstring): the port's train CLI, straight and preempted
    then resumed, its eval-only resume and the Predictor from its
    checkpoint, in ``tmp``; returns the launch counts of the phase and what
    phase 10 reuses: run A's and the MFBCoAtt run's dirs, the data options,
    the key of the store left in the dataset factory's cache, and the 64
    served val questions with their images."""
    import io
    import signal

    from vqa_tpu_torch.cli import train as train_cli
    from vqa_tpu_torch.config import load_options
    from vqa_tpu_torch.datasets import factory as data_factory
    from vqa_tpu_torch.datasets.features import FeatureStore
    from vqa_tpu_torch.datasets.interim import RAW_FILES, image_name
    from vqa_tpu_torch.engine import engine as engine_lib
    from vqa_tpu_torch.engine.checkpoint import CheckpointManager
    from vqa_tpu_torch.engine.steps import make_eval_step
    from vqa_tpu_torch.predictor import Predictor

    yaml = os.path.join(_REPO, "options", "vqa2", "mutan_att.yaml")
    saves, restores, trains = [], [], []
    sigterm = {"at": None, "seen": None}
    real = {"save": CheckpointManager.save, "save_step": CheckpointManager.save_step,
            "restore": CheckpointManager.restore,
            "restore_step": CheckpointManager.restore_step,
            "train": engine_lib.train, "make_train_step": train_cli.make_train_step}
    executed = [0]

    def timed_save(self, state, epoch, acc=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real["save"](self, state, epoch, acc)
        saves.append(("epoch", time.perf_counter() - t, _dir_bytes(self._epoch_dir(epoch))))
        return out

    def timed_save_step(self, state, epoch, next_step):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real["save_step"](self, state, epoch, next_step)
        saves.append(("step", time.perf_counter() - t,
                      _dir_bytes(self._step_dir(epoch, next_step))))
        if sigterm["at"] is not None and sigterm["seen"] is None and \
                (epoch, next_step) > sigterm["at"]:
            sigterm["seen"] = (epoch, next_step)  # the preemption save
        if (epoch, next_step) == sigterm["at"]:
            os.kill(os.getpid(), signal.SIGTERM)

    def timed(name, store):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            out = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            store.append(time.perf_counter() - t)
            return out
        return wrapper

    def timed_train(loader, state, train_step, exp, epoch, *args, **kwargs):
        n0, s0, t = executed[0], len(saves), time.perf_counter()
        try:
            return real["train"](loader, state, train_step, exp, epoch, *args, **kwargs)
        finally:
            wall = time.perf_counter() - t
            ckpt_s = sum(sec for _, sec, _ in saves[s0:])
            trains.append(dict(epoch=epoch, steps=executed[0] - n0, wall=wall, ckpt_s=ckpt_s,
                               rows=(executed[0] - n0) * loader.batch_size))

    def counting_make_train_step(*args, **kwargs):
        step = real["make_train_step"](*args, **kwargs)

        def counted(state, batch, features=None):
            executed[0] += 1
            return step(state, batch, features)
        return counted

    patches = [(CheckpointManager, "save", timed_save),
               (CheckpointManager, "save_step", timed_save_step),
               (CheckpointManager, "restore", timed("restore", restores)),
               (CheckpointManager, "restore_step", timed("restore_step", restores)),
               (engine_lib, "train", timed_train),
               (train_cli, "make_train_step", counting_make_train_step)]

    t0 = time.perf_counter()
    _write_raw_vqa2(os.path.join(tmp, "vqa2", "raw"), np.random.default_rng(0))
    data = [f"vqa.dir={tmp}/vqa2", f"coco.dir={tmp}/coco"]
    opt = load_options(yaml, data)
    # one store for every split, as the factory keeps it: the val images'
    # rows (phase 6's table) and the train images' rows after them
    names = ([image_name("val2014", i) for i in range(N_IMAGES)]
             + [image_name("train2014", i) for i in range(N_IMAGES)])
    train_rows = np.random.default_rng(1).standard_normal(host_table.shape, np.float32)
    key = (opt.coco.dir, opt.coco.arch, opt.coco.mode, "ram")
    data_factory._STORE_CACHE[key] = FeatureStore.in_memory(
        names, np.concatenate([host_table, train_rows]))
    del train_rows
    train_set = data_factory.factory("train", opt, visual_mode="index")
    val_set = data_factory.factory("val", opt, visual_mode="index")
    setup_s = time.perf_counter() - t0
    steps_per_epoch = len(train_set) // opt.optim.batch_size
    _require(opt.optim.batch_size == TRAIN_BATCH and steps_per_epoch > 2 * TRAIN_CLI_CKPT_EVERY,
             f"{steps_per_epoch} steps of {opt.optim.batch_size} an epoch")
    _require(train_set.image_index.min() >= N_IMAGES and val_set.image_index.max() < N_IMAGES,
             "train rows index the train2014 half of the one table, val rows the val half")
    base = ["--path_opt", yaml, "--epochs", str(TRAIN_CLI_EPOCHS),
            "--checkpoint_every_steps", str(TRAIN_CLI_CKPT_EVERY)]
    for o in data + ["engine.device_features=true", "engine.features_dtype=bfloat16",
                     f"engine.train_bucketing={TRAIN_BUCKET_WINDOW}",
                     "optim.eval_batch_size=1024"]:
        base += ["--opt", o]
    logs = {r: os.path.join(tmp, "logs", r) for r in ("A", "B")}
    runs = {}

    def run(label, argv):
        executed[0], first_train = 0, len(trains)
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = train_cli.main(argv)
        torch.cuda.synchronize()
        runs[label] = dict(rc=rc, wall=time.perf_counter() - t, steps=executed[0],
                           trains=trains[first_train:])
        torch.cuda.empty_cache()
        return rc

    for obj, name, fn in patches:
        setattr(obj, name, fn)
    _reset_counts()
    try:
        _require(run("A", base + ["--dir_logs", logs["A"]]) == 0, "run A returns 0")
        sigterm["at"] = TRAIN_CLI_SIGTERM_AT
        rc = run("B1", base + ["--dir_logs", logs["B"]])
        sigterm["at"] = None
        _require(rc == 75, f"run B, sent SIGTERM after step checkpoint "
                 f"{TRAIN_CLI_SIGTERM_AT}, returns 75: {rc}")
        with open(os.path.join(logs["B"], "ckpt", "info.json")) as f:
            info_b = json.load(f)
        _require(sigterm["seen"] is not None
                 and info_b["step_latest"] == list(sigterm["seen"])
                 and sigterm["seen"][0] == TRAIN_CLI_SIGTERM_AT[0],
                 f"info.json names the preemption save {sigterm['seen']}: {info_b}")
        with open(os.path.join(logs["B"], "ckpt", "inepoch_%04d_%08d" % sigterm["seen"],
                               "state.json")) as f:
            saved_step = json.load(f)["step"]
        _require(run("B2", base + ["--dir_logs", logs["B"], "--resume", "latest"]) == 0,
                 "run B resumed returns 0")
        ev = ["--path_opt", yaml, "-e", "--resume", "best", "--dir_logs", logs["A"]]
        for o in data + ["engine.device_features=true", "engine.features_dtype=bfloat16",
                         "optim.eval_batch_size=1024"]:
            ev += ["--opt", o]
        _require(run("eval", ev) == 0, "-e --resume best returns 0")

        # the Predictor from A's best checkpoint against the eval step on
        # the same 64-row batch
        t = time.perf_counter()
        predictor = Predictor.from_run(logs["A"], resume="best", device=dev)
        load_s = time.perf_counter() - t
        rows = np.arange(TRAIN_CLI_SERVED) * (len(val_set) // TRAIN_CLI_SERVED)
        with open(os.path.join(tmp, "vqa2", "raw", RAW_FILES["val"][0])) as f:
            text = {q["question_id"]: q["question"] for q in json.load(f)["questions"]}
        questions = [text[q] for q in val_set.split.question_ids[rows].tolist()]
        images = [str(n) for n in val_set.split.image_names[rows]]
        served = [a[0][0] for a in predictor.answer_batch(questions, images, topk=1)]
        q, lengths = predictor.encode_questions(questions)
        table = predictor.table.to(dev, torch.bfloat16)
        out = make_eval_step()(predictor.model,
                               {"question": q, "length": lengths,
                                "image_index": val_set.image_index[rows]}, table)
        stepped = [val_set.vocabs.aid_to_ans[a] for a in out["pred"].cpu().tolist()]
        del predictor, table
        counts = _read_counts()
    finally:
        for (obj, name, _), fn in zip(patches, [real[n] for _, n, _ in patches]):
            setattr(obj, name, fn)
        sigterm["at"] = None
    mfb = _train_cli_mfb(torch, train_cli, data, os.path.join(tmp, "logs", "mfb"),
                         steps_per_epoch, card)
    torch.cuda.empty_cache()

    def metrics(label, split):
        with open(os.path.join(logs[label], "metrics.jsonl")) as f:
            return [r for r in map(json.loads, f) if r.get("split") == split]

    def arrays(label):
        path = os.path.join(logs[label], "ckpt", f"epoch_{TRAIN_CLI_EPOCHS - 1:04d}")
        out = {}
        for name in ("params.npz", "opt_state.npz"):
            with np.load(os.path.join(path, name)) as npz:
                out.update({f"{name}:{k}": npz[k] for k in npz.files})
        with open(os.path.join(path, "state.json")) as f:
            out["step"] = np.asarray(json.load(f)["step"])
        return out

    a, b = arrays("A"), arrays("B")
    differ = sorted(k for k in a if k not in b or a[k].dtype != b[k].dtype
                    or not np.array_equal(a[k], b[k]))
    _require(sorted(a) == sorted(b) and not differ,
             f"B's final params and optimizer arrays equal A's bit for bit: {differ[:8]}")
    # A's val records: one an epoch, then the -e run's; B's: one an epoch
    val_a, val_b = metrics("A", "val"), metrics("B", "val")
    _require(len(val_b) == TRAIN_CLI_EPOCHS
             and val_b[-1]["acc1"] == val_a[TRAIN_CLI_EPOCHS - 1]["acc1"],
             f"B's epoch-{TRAIN_CLI_EPOCHS - 1} val acc1 equals A's")
    with open(os.path.join(logs["A"], "ckpt", "info.json")) as f:
        info_a = json.load(f)
    best_acc = [r["acc1"] for r in val_a if r["epoch"] == info_a["best"]][0]
    evaluated = val_a[-1]
    _require(len(val_a) == TRAIN_CLI_EPOCHS + 1 and evaluated["acc1"] == best_acc,
             f"-e --resume best reports A's best acc1 {best_acc}: {evaluated['acc1']}")
    _require(served == stepped, f"the Predictor from A's best checkpoint answers "
             f"{TRAIN_CLI_SERVED} questions as the eval step does: "
             f"{sum(x != y for x, y in zip(served, stepped))} differ")
    losses = [r["loss"] for label in ("A", "B") for r in metrics(label, "train")]
    _require(all(math.isfinite(x) for x in losses), f"finite train losses: {losses}")
    # steps B ran before the preemption that its checkpoint does not hold
    lost = runs["B1"]["steps"] - saved_step
    _require(runs["A"]["steps"] == TRAIN_CLI_EPOCHS * steps_per_epoch and lost == 0
             and runs["B1"]["steps"] + runs["B2"]["steps"] == runs["A"]["steps"],
             f"no step lost or repeated: A {runs['A']['steps']}, B {runs['B1']['steps']} + "
             f"{runs['B2']['steps']}, the preemption checkpoint at step {saved_step}")
    _require({k for k, c in counts.items() if c} == set(TRAIN_CLI_KERNELS),
             f"the train CLI launched exactly {TRAIN_CLI_KERNELS}: {counts}")

    def per_run(label):
        r = runs[label]
        steps = sum(t["steps"] for t in r["trains"])
        busy = sum(t["wall"] - t["ckpt_s"] for t in r["trains"])
        return dict(steps=steps, train_qa_per_s=round(sum(t["rows"] for t in r["trains"])
                                                     / busy, 1) if steps else None,
                    step_ms=round(busy / steps * 1e3, 4) if steps else None,
                    wall_s=round(r["wall"], 3))

    step_saves = [x for x in saves if x[0] == "step"]
    epoch_saves = [x for x in saves if x[0] == "epoch"]
    _phase("train_cli", arch="MutanAtt", card=card, train_questions=len(train_set),
           val_questions=len(val_set), table_rows=2 * N_IMAGES, batch=TRAIN_BATCH,
           steps_per_epoch=steps_per_epoch, epochs=TRAIN_CLI_EPOCHS,
           checkpoint_every=TRAIN_CLI_CKPT_EVERY, setup_s=round(setup_s, 3),
           **{f"{label}_{k}": v for label in ("A", "B1", "B2") for k, v in per_run(label).items()},
           **{f"{label}_val_qa_per_s": [round(r["qa_per_sec"], 1) for r in metrics(label, "val")]
              for label in ("A", "B")},
           val_acc1=[r["acc1"] for r in val_a[:TRAIN_CLI_EPOCHS]], best=info_a["best"],
           eval_resume_acc1=evaluated["acc1"], eval_resume_wall_s=round(runs["eval"]["wall"], 3),
           train_loss=[round(r["loss"], 5) for r in metrics("A", "train")],
           sigterm_after=list(TRAIN_CLI_SIGTERM_AT), preempted_at=list(sigterm["seen"]),
           rc_B1=runs["B1"]["rc"], lost_steps=lost, bit_equal=True,
           step_save_s=[round(x[1], 3) for x in step_saves],
           epoch_save_s=[round(x[1], 3) for x in epoch_saves],
           save_bytes=sorted({x[2] for x in saves}),
           restore_s=[round(x, 3) for x in restores], predictor_load_s=round(load_s, 3),
           served=TRAIN_CLI_SERVED, served_equal_eval_step=True,
           launches={k: c for k, c in counts.items() if c})
    context = dict(logs=logs["A"], mfb=os.path.join(tmp, "logs", "mfb"), data=data,
                   store_key=key, questions=questions, images=images)
    return {k: c + mfb[k] for k, c in counts.items()}, context


def _train_cli_mfb(torch, train_cli, data, logs, steps_per_epoch, card) -> dict:
    """Phase 9's MFBCoAtt run: mfb_coatt.yaml at full width, one straight
    epoch, then -e --resume best, whose acc1 must be the run's best; returns
    the launch counts of both runs."""
    import io

    yaml = os.path.join(_REPO, "options", "vqa2", "mfb_coatt.yaml")
    common = []
    for o in data + ["engine.device_features=true", "engine.features_dtype=bfloat16",
                     f"engine.train_bucketing={TRAIN_BUCKET_WINDOW}",
                     "optim.eval_batch_size=1024"]:
        common += ["--opt", o]
    walls, counts = [], dict.fromkeys(_counters(), 0)
    for argv in (["--epochs", "1"], ["-e", "--resume", "best"]):
        _reset_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = train_cli.main(["--path_opt", yaml, "--dir_logs", logs] + argv + common)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        _require(rc == 0, f"the MFBCoAtt train CLI {argv} returns 0: {rc}")
        for k, c in _read_counts().items():
            counts[k] += c
    torch.cuda.empty_cache()
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    (train,) = [r for r in records if r.get("split") == "train"]
    trained, evaluated = [r for r in records if r.get("split") == "val"]
    with open(os.path.join(logs, "ckpt", "info.json")) as f:
        info = json.load(f)
    _require(info["best"] == 0 and evaluated["acc1"] == trained["acc1"] == info["best_acc"],
             f"MFBCoAtt: -e --resume best reports the run's best acc1 {trained['acc1']}: "
             f"{evaluated['acc1']}")
    _require(math.isfinite(train["loss"]), f"MFBCoAtt: a finite train loss {train['loss']}")
    _require({k for k, c in counts.items() if c} == set(ARCHS["MFBCoAtt"][1]),
             f"the MFBCoAtt train CLI launched exactly {ARCHS['MFBCoAtt'][1]}: {counts}")
    _phase("train_cli", arch="MFBCoAtt", card=card, epochs=1, train_loss=round(train["loss"], 5),
           steps=steps_per_epoch, train_epoch_s=round(train["epoch_time"], 3),
           train_qa_per_s=round(steps_per_epoch * TRAIN_BATCH / train["epoch_time"], 1),
           val_acc1=trained["acc1"],
           val_qa_per_s=round(trained["qa_per_sec"], 1), eval_resume_acc1=evaluated["acc1"],
           wall_s=[round(w, 3) for w in walls], launches={k: c for k, c in counts.items() if c})
    return counts


# ---------------------------------------------------------------- export

# run in a fresh interpreter per artifact: load it with no model code on the
# device named (empty: the one it was traced on), run one forward at the
# frozen batch, report what the program launched
_LOAD_CHECK = r"""
import json, sys, time
import numpy as np
import torch
from vqa_tpu_torch.datasets.features import FeatureStore
from vqa_tpu_torch.export import load_export, program_ops
from vqa_tpu_torch.ops.attention import glimpse_attend, glimpse_head
from vqa_tpu_torch.ops.lstm import lstm_seq
from vqa_tpu_torch.ops.mfb_pool import mfb_pool
from vqa_tpu_torch.ops.relation import relation_attend

export_dir, inputs, out, device = sys.argv[1:5]
wrappers = {"lstm_seq": lstm_seq, "glimpse_head": glimpse_head,
            "glimpse_attend": glimpse_attend, "mfb_pool": mfb_pool,
            "relation_attend": relation_attend}
with np.load(inputs) as f:
    data = {k: f[k] for k in f.files}
store = FeatureStore.in_memory([str(n) for n in data["names"]], data["visual"])
t = time.perf_counter()
ep = load_export(export_dir, features=store, device=device or None)
sync = torch.cuda.synchronize if ep.device.type == "cuda" else (lambda: None)
sync()
load_s = time.perf_counter() - t
for w in wrappers.values():
    w.launches = 0
t = time.perf_counter()
logits = ep.logits(data["visual"], torch.from_numpy(data["question"]),
                   torch.from_numpy(data["lengths"]))
sync()
forward_s = time.perf_counter() - t
np.save(out, logits)
leaked = sorted(m for m in sys.modules if m.startswith("vqa_tpu_torch.models")
                or m.split(".")[0] in ("jax", "flax", "vqa_tpu"))
print(json.dumps({"load_s": load_s, "forward_s": forward_s, "ops": program_ops(ep.program),
                  "device": str(ep.device), "cuda_available": torch.cuda.is_available(),
                  "launches": {k: w.launches for k, w in wrappers.items()},
                  "leaked": leaked}))
"""


def _host_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median host-clock time of ``fn`` with a sync after each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _cor_run(torch, tmp: str, data: list) -> str:
    """A CoR run dir at cor.yaml's full width over phase 9's data: its
    options and, as its best checkpoint (epoch 0), weights from
    weights.init_params (seed 0)."""
    import dataclasses

    from vqa_tpu_torch.config import dump_options, load_options
    from vqa_tpu_torch.datasets import factory as data_factory
    from vqa_tpu_torch.engine import optim
    from vqa_tpu_torch.engine.checkpoint import CheckpointManager
    from vqa_tpu_torch.engine.steps import create_state
    from vqa_tpu_torch.models.factory import factory as model_factory
    from vqa_tpu_torch.weights import init_params

    opt = load_options(os.path.join(_REPO, "options", "vqa2", "cor.yaml"), data)
    run = os.path.join(tmp, "logs", "cor")
    dump_options(opt, run)
    val_set = data_factory.factory("val", opt)  # the port's prep, for cor.yaml's 3000 answers
    model = model_factory(dataclasses.asdict(opt.model), val_set.num_words, val_set.num_answers,
                          dim_v=val_set.feature_shape[-1], train=True)
    init_params(model, seed=0)
    CheckpointManager(os.path.join(run, "ckpt")).save(
        create_state(model, optim.factory(opt.optim)), 0, 0.0)
    return run


def _dispatch_us(torch, dev) -> dict:
    """Host time of one call (us, the median of 5 trials of 20 calls, then a
    sync) of each registered op against a direct call of its CUDA
    implementation, at MutanAtt's and MFB's serving shapes: the cost the op
    registration adds to every launch."""
    from vqa_tpu_torch.ops import attention, lstm, mfb_pool, relation

    B, T, R, D = EXPORT_BATCH, SEQ, REGIONS, DIM

    def bf(*shape):
        return torch.randn(shape, device=dev).bfloat16()

    cases = {
        "lstm_seq": (lstm._lstm_seq_cuda, (bf(T, B, 4 * 2400) * 0.1,
                                           torch.ones(T, B, 1, device=dev).bfloat16(),
                                           bf(2400, 4 * 2400) * 0.02)),
        "glimpse_head": (attention._glimpse_head_cuda, (bf(B, R, 510), bf(510, 2), bf(2),
                                                        bf(B, R, D))),
        "glimpse_attend": (attention._glimpse_attend_cuda, (bf(B, T, 2), bf(B, T, 1024))),
        "mfb_pool": (mfb_pool._mfb_pool_cuda, (bf(B * R, 5000), 5)),
        "relation_attend": (relation._relation_attend_cuda, (bf(B, R, 1024), bf(B, R, 1024))),
    }
    out = {}
    for name, (direct, args) in cases.items():
        op = getattr(torch.ops.vqa_tpu_torch, name).default
        per = {}
        for label, fn in (("op", op), ("direct", direct), ("direct", direct), ("op", op)):
            trials = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(20):
                    fn(*args)
                trials.append((time.perf_counter() - t) / 20 * 1e6)
                torch.cuda.synchronize()
            per.setdefault(label, []).append(statistics.median(trials))
        out[name] = {k: round(statistics.median(v), 2) for k, v in per.items()}
    return out


def _export_phase(torch, dev, card: str, tmp: str, context: dict) -> dict:
    """Phase 10 (the docstring): export, load in fresh interpreters, serve
    --exported and visu, over phase 9's runs; returns the launch counts of
    the loaded programs, the served artifact and visu."""
    import io

    from vqa_tpu_torch import export as export_lib
    from vqa_tpu_torch.cli import export as export_cli
    from vqa_tpu_torch.cli import serve as serve_cli
    from vqa_tpu_torch.cli import visu as visu_cli
    from vqa_tpu_torch.datasets import factory as data_factory
    from vqa_tpu_torch.export import (_forward_at, dequantize_int8, load_export, model_params,
                                      quantize_int8, save_export)
    from vqa_tpu_torch.predictor import Predictor

    store = data_factory._STORE_CACHE[context["store_key"]]
    questions, images = context["questions"], context["images"]
    counts = dict.fromkeys(_counters(), 0)

    def add(c):
        for k, v in c.items():
            counts[k] += v

    t0 = time.perf_counter()
    runs = {"MutanAtt": context["logs"], "MFBCoAtt": context["mfb"],
            "CoR": _cor_run(torch, tmp, context["data"])}
    preds = {arch: Predictor.from_run(run, resume="best", device=dev)
             for arch, run in runs.items()}
    setup_s = time.perf_counter() - t0

    # the 64 served val questions at the frozen batch, each arch's encoding
    inputs, live = {}, {}
    for arch, pred in preds.items():
        q, lengths = pred.encode_questions(questions)
        visual = pred.table[torch.as_tensor(pred.dataset.index_of(images))]
        path = os.path.join(tmp, f"inputs_{arch}.npz")
        np.savez(path, names=np.asarray(images), visual=visual.numpy(),
                 question=q.cpu().numpy(), lengths=lengths.cpu().numpy())
        inputs[arch] = (path, visual.to(dev), q, lengths)
        with torch.inference_mode():
            live[arch] = pred.model(visual.to(dev), q, lengths).float().cpu().numpy()

    # export: MutanAtt three ways, MFBCoAtt and CoR baked
    artifacts = {}  # label -> (arch, dir, weights_dtype, export_s, bytes)
    plan = [("MutanAtt", "baked", None), ("MutanAtt", "external", None),
            ("MutanAtt", "baked", "int8"), ("MFBCoAtt", "baked", None), ("CoR", "baked", None)]
    for arch, mode, dtype in plan:
        label = f"{arch}:{mode}" + (f":{dtype}" if dtype else "")
        out = os.path.join(tmp, "exported", label.replace(":", "_"))
        torch.cuda.synchronize()
        t = time.perf_counter()
        meta = save_export(out, preds[arch], batch=EXPORT_BATCH, weights_dtype=dtype,
                           params_mode=mode)
        export_s = time.perf_counter() - t
        _require(meta["device"] == "cuda" and meta["compute_dtype"] == "bfloat16",
                 f"{label}: traced on the card in bf16: {meta['device']}, "
                 f"{meta['compute_dtype']}")
        artifacts[label] = (arch, out, dtype, export_s, _dir_bytes(out))

    # the cross-device loads: MutanAtt traced on the host (computing in bf16,
    # engine.dtype=bfloat16, as the card's kernels take it) to be loaded on
    # the card, and the card-traced baked artifact loaded on the host by an
    # interpreter that sees no card
    t = time.perf_counter()
    host_pred = Predictor.from_run(runs["MutanAtt"], resume="best", device="cpu",
                                   overrides=["engine.dtype=bfloat16"])
    out = os.path.join(tmp, "exported", "MutanAtt_host_traced")
    meta = save_export(out, host_pred, batch=EXPORT_BATCH)
    export_s = time.perf_counter() - t
    del host_pred
    _require(meta["device"] == "cpu" and meta["compute_dtype"] == "bfloat16",
             f"MutanAtt:host_traced: traced on the host in bf16: {meta['device']}, "
             f"{meta['compute_dtype']}")
    artifacts["MutanAtt:host_traced"] = ("MutanAtt", out, None, export_s, _dir_bytes(out))
    loads = {label: (label, "") for label in artifacts}  # label -> (artifact, load device)
    loads["MutanAtt:host_traced"] = ("MutanAtt:host_traced", "cuda")
    loads["MutanAtt:baked@host"] = ("MutanAtt:baked", "cpu")

    # each artifact loaded and run in a fresh interpreter, all at once
    procs = {}
    for label, (artifact, device) in loads.items():
        arch, out = artifacts[artifact][:2]
        logits_path = os.path.join(tmp, f"logits_{label.replace(':', '_')}.npy")
        env = dict(os.environ, **({"CUDA_VISIBLE_DEVICES": ""} if device == "cpu" else {}))
        procs[label] = (subprocess.Popen(
            [sys.executable, "-c", _LOAD_CHECK, out, inputs[arch][0], logits_path, device],
            cwd=_REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            logits_path)
    loaded = {}
    for label, (proc, logits_path) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        _require(proc.returncode == 0, f"{label}: the fresh interpreter loads and runs the "
                 f"artifact: rc {proc.returncode}\n{stderr[-3000:]}")
        loaded[label] = (json.loads(stdout.strip().splitlines()[-1]), np.load(logits_path))

    # held: no model code loaded, the kernels in the graph and launched, the
    # logits against the live model (int8: against the same dequant, eagerly)
    records = {}
    for label, (report, got) in loaded.items():
        artifact, device = loads[label]
        arch, out, dtype, export_s, nbytes = artifacts[artifact]
        expected = EXPORT_OPS[arch]
        on_host = device == "cpu"
        _require(not report["leaked"], f"{label}: loaded with no model code and no jax: "
                 f"{report['leaked']}")
        _require({op.split("::")[-1] for op in report["ops"]} == set(expected)
                 and all(op.startswith("vqa_tpu_torch::") for op in report["ops"]),
                 f"{label}: the graph calls exactly the registered ops {expected}: "
                 f"{report['ops']}")
        _require(report["device"] == ("cpu" if on_host else "cuda")
                 and report["cuda_available"] != on_host,
                 f"{label}: runs on {'the host, with no card in sight' if on_host else 'cuda'}: "
                 f"{report['device']}, cuda available {report['cuda_available']}")
        launched = {k for k, c in report["launches"].items() if c}
        _require(launched == (set() if on_host else set(expected)),
                 f"{label}: the loaded program launched exactly "
                 f"{'no kernel' if on_host else expected}: {report['launches']}")
        add(report["launches"])
        want = live[arch]
        if on_host:
            # the host runs the plain versions: held against the live model's
            # plain path on the card (EXPORT_HOST_ATOL), the answers wherever
            # its top-2 logits are further apart than the tolerance reaches
            pred = preds[arch]
            _, visual, q, lengths = inputs[arch]
            with torch.inference_mode(), _plain_ops(torch):
                want = pred.model(visual, q, lengths).float().cpu().numpy()
            top2 = np.sort(want, axis=-1)[:, -2:]
            sure = (top2[:, 1] - top2[:, 0]) > 2 * EXPORT_HOST_ATOL
            err = float(np.abs(got - want).max())
            agree = float((got.argmax(-1) == want.argmax(-1)).mean())
            _require(got.shape == want.shape and np.isfinite(got).all()
                     and err <= EXPORT_HOST_ATOL
                     and (got.argmax(-1) == want.argmax(-1))[sure].all(),
                     f"{label}: finite logits within {EXPORT_HOST_ATOL} of the live plain "
                     f"path's ({err}), the same answers wherever its top-2 differ by more "
                     f"than 2*{EXPORT_HOST_ATOL} ({agree} of all)")
            records[label] = dict(loaded_on="cpu", load_s=round(report["load_s"], 3),
                                  forward_s=round(report["forward_s"], 3),
                                  max_abs_err_vs_plain=round(err, 6), agree=agree,
                                  top1_held=f"{int(sure.sum())}/{len(sure)}")
            continue
        if dtype == "int8":
            pred = preds[arch]
            _, visual, q, lengths = inputs[arch]
            deq = dequantize_int8(quantize_int8(model_params(pred.model)))
            with torch.inference_mode():
                want = _forward_at(pred.model, deq, visual, q, lengths).float().cpu().numpy()
        err = float(np.abs(got - want).max())
        agree = float((got.argmax(-1) == want.argmax(-1)).mean())
        _require(got.shape == want.shape and np.isfinite(got).all(),
                 f"{label}: finite logits of shape {want.shape}")
        _require(err <= LOGITS_ATOL and agree == 1.0,
                 f"{label}: logits within {LOGITS_ATOL} of the "
                 f"{'eager dequantized' if dtype else 'live'} model ({err}) and the same "
                 f"answers ({agree})")
        records[label] = dict(loaded_on=report["device"], bytes=nbytes,
                              export_s=round(export_s, 3), load_s=round(report["load_s"], 3),
                              forward_s=round(report["forward_s"], 3), max_abs_err=round(err, 6),
                              agree=agree, launches={k: c for k, c in report["launches"].items()
                                                     if c})
        if dtype == "int8":  # reported, not held: quantization moves the logits
            records[label]["agree_unquantized"] = round(
                float((got.argmax(-1) == live[arch].argmax(-1)).mean()), 5)
            records[label]["max_abs_err_unquantized"] = round(
                float(np.abs(got - live[arch]).max()), 5)

    # the forward at B=64: the live model against the loaded program, in turns
    baked = load_export(artifacts["MutanAtt:baked"][1], features=store)
    pred = preds["MutanAtt"]
    _, visual, q, lengths = inputs["MutanAtt"]
    args = (visual.float(), q.int(), lengths.int())
    with torch.inference_mode():
        program_ms, live_ms = _in_turns(torch, _host_ms, lambda: baked._call(*args),
                                        lambda: pred.model(visual, q, lengths))

    # the export CLI's deployment gate over the synthetic val split
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = export_cli.main(["--dir_logs", runs["MutanAtt"],
                              "--out", os.path.join(tmp, "exported", "validated"),
                              "--validate", str(EXPORT_VALIDATE)])
    validate_s = time.perf_counter() - t
    gate = f"answer agreement 1.0000 over {EXPORT_VALIDATE} val questions"
    _require(rc == 0 and gate in buf.getvalue(),
             f"export --validate {EXPORT_VALIDATE} returns 0 with {gate!r}: rc {rc}, "
             f"{buf.getvalue()[-500:]}")

    # serve --exported in-process on port 0, with and without dynamic batching;
    # the card's machine has no h5py, so load_export gets the in-memory store
    real_load, real_build = export_lib.load_export, serve_cli.build_server
    box = {}

    def load_with_store(export_dir, features=None, **kwargs):
        return real_load(export_dir, features=store, **kwargs)

    def build(service, host, port):
        box["server"] = real_build(service, host, port)
        box["ready"].set()
        return box["server"]

    qs = [questions[i % len(questions)] for i in range(EXPORT_BATCH + 6)]
    ims = [images[i % len(images)] for i in range(EXPORT_BATCH + 6)]
    served = {}
    export_lib.load_export, serve_cli.build_server = load_with_store, build
    try:
        for dynamic in (False, True):
            box["ready"] = threading.Event()
            argv = ["--exported", artifacts["MutanAtt:baked"][1], "--port", "0"]
            argv += ["--dynamic_batching"] if dynamic else []
            _reset_counts()
            thread = threading.Thread(target=serve_cli.main, args=(argv,), daemon=True)
            thread.start()
            _require(box["ready"].wait(300), "serve --exported started its server")
            base = f"http://127.0.0.1:{box['server'].server_address[1]}"
            try:
                singles = []
                for i in range(3):
                    status, body = _post(base + "/answer", {"question": questions[i],
                                                            "image": images[i], "topk": 5})
                    _require(status == 200, f"/answer status {status}")
                    singles.append([tuple(x) for x in body["answers"]])
                status, body = _post(base + "/batch", {"questions": qs, "images": ims,
                                                       "topk": 3})
                _require(status == 200 and len(body["answers"]) == len(qs),
                         f"/batch of {len(qs)} > the artifact's batch")
            finally:
                box["server"].shutdown()
                thread.join(timeout=60)
            _require(not thread.is_alive(), "serve --exported returned after shutdown")
            add(_read_counts())
            served[dynamic] = (singles, [[tuple(x) for x in row] for row in body["answers"]])
    finally:
        export_lib.load_export, serve_cli.build_server = real_load, real_build
    for dynamic, (singles, rows) in served.items():
        direct = [_direct(baked, [questions[i]], [images[i]], EXPORT_BATCH, 5)[0]
                  for i in range(3)]
        _require(_same_answers(singles, direct) and
                 _same_answers(rows, _direct(baked, qs, ims, EXPORT_BATCH, 3)),
                 f"served --exported answers (dynamic batching {dynamic}) equal "
                 "ExportedPredictor.answer_batch's")

    # visu: its top-k against Predictor.answer, the attention of the kernel
    # path against the plain path (a CPU copy)
    visu = {}
    for arch in EXPORT_VISU:
        question, image = questions[0], images[0]
        buf = io.StringIO()
        _reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = visu_cli.main(["--dir_logs", runs[arch], "--image", image,
                                "--question", question])
        add(_read_counts())
        printed = [line.strip().rsplit(maxsplit=1)[0] for line in buf.getvalue().splitlines()
                   if line.startswith("  ")]
        want = [a for a, _ in preds[arch].answer(question, image, topk=5)]
        _require(rc == 0 and printed == want, f"{arch} visu prints Predictor.answer's top-5 "
                 f"{want}: {printed}")
        alpha = visu_cli.attention_map(preds[arch], question, image)
        plain = visu_cli.attention_map(
            Predictor.from_run(runs[arch], resume="best", device="cpu"), question, image)
        err = float(np.abs(alpha - plain).max())
        _require(alpha.shape == plain.shape == (REGIONS, 3 if arch == "CoR" else 2)
                 and err <= LOGITS_ATOL,
                 f"{arch} visu attention {alpha.shape} within {LOGITS_ATOL} of the plain "
                 f"path's: {err}")
        visu[arch] = dict(shape=list(alpha.shape), max_abs_err=round(err, 6))

    dispatch = _dispatch_us(torch, dev)
    del preds, baked, pred
    torch.cuda.empty_cache()
    _require(all(counts[k] > 0 for ops in EXPORT_OPS.values() for k in ops),
             f"phase 10 launched every forward kernel inside loaded programs: {counts}")
    for label, r in records.items():
        _phase("export", artifact=label, card=card, batch=EXPORT_BATCH, **r)
    _phase("export", card=card, setup_s=round(setup_s, 3), forward_b64_live_ms=round(live_ms, 4),
           forward_b64_program_ms=round(program_ms, 4), validate=EXPORT_VALIDATE,
           validate_agree=1.0, validate_s=round(validate_s, 3), served_equal_direct=True,
           served_requests=8, visu=visu, dispatch_us=dispatch,
           launches={k: c for k, c in counts.items() if c})
    return counts


# --------------------------------------------------------------- extract

# phase 11: a seeded torchvision-named ResNet-152 checkpoint through the
# import tool, the extract CLI's function over EXTRACT_IMAGES 448x448 images
# at the CLI's batch (bf16; the first EXTRACT_F32 also in float32, TF32 off,
# and EXTRACT_HOST of those on the host), then the eval CLI over the
# [1024, 196, 2048] table it gave, for each arch of EXTRACT_EVAL
EXTRACT_ARCH = "resnet152"
EXTRACT_SIZE = 448
EXTRACT_BATCH = 32  # the extract CLI's default --batch
EXTRACT_IMAGES = N_IMAGES
EXTRACT_F32 = 64
EXTRACT_HOST = 2
EXTRACT_EVAL = {"MutanAtt": ("mutan_att", ("gather_rows", "lstm_seq", "glimpse_head")),
                "CoR": ("cor", ("gather_rows", "lstm_seq", "relation_attend"))}
# tolerances, each relative to the max-abs of the grid it is held against:
# - bf16 against float32 on the card: bf16 rounds each conv's inputs and
#   output and each BatchNorm's output (up to 2^-8 relative: bf16 keeps 8
#   significant bits). ResNet-50
#   at 64x64 on the CPU moved its grid by 0.0077-0.0119 over 16 blocks
#   (tests/test_torch_extract.py); ResNet-152's 50 blocks, sqrt(50 / 16)
#   ~ 1.8 times that, ~0.02; 0.05 leaves room;
# - float32 on the card (TF32 off) against float32 on the host: the same
#   products summed in another order (cuDNN's algorithms, the host's), each
#   conv's output moved by ~2^-24 sqrt(K) relative for K up to 4608, ~1e-6,
#   carried through 50 blocks: ~1e-5; 1e-4 leaves room, and stays below
#   the same forward with TF32 products (10-bit mantissas, ~2^-11 relative
#   a product), which the phase runs once and holds past it;
# - noatt, the grid's mean in bf16, against the mean of the att rows taken
#   in float64: one bf16 rounding of the mean, up to 2^-8 of it; 2^-7
EXTRACT_BF16_TOL = 0.05
EXTRACT_HOST_TOL = 1e-4
EXTRACT_NOATT_TOL = 2.0 ** -7


def _resnet_state_dict(torch, arch: str, seed: int) -> dict:
    """A torchvision-named ResNet state_dict (conv1, bn1,
    layer{1..4}.{b}.conv{1..3} / bn{1..3} / downsample.{0,1}, fc) drawn from
    one seeded generator so that the grid stays O(1) through the blocks:
    He-normal convs (variance 2 / fan_in, what keeps a ReLU net's scale), a
    unit-variance projection, BatchNorm weights in [0.8, 1.2] and each
    block's bn3 in [0.1, 0.2] (as torchvision's zero_init_residual, but not
    0), running statistics near (0, 1)."""
    from vqa_tpu_torch.models.convnets import _DEPTHS

    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, c_out, c_in, k, gain):
        sd[f"{name}.weight"] = torch.randn(c_out, c_in, k, k, generator=gen) * (
            gain / (c_in * k * k)) ** 0.5

    def bn(name, c, scale=(0.8, 1.2)):
        for leaf, (lo, hi) in (("weight", scale), ("bias", (-0.1, 0.1)),
                               ("running_mean", (-0.1, 0.1)), ("running_var", (0.8, 1.2))):
            sd[f"{name}.{leaf}"] = torch.empty(c).uniform_(lo, hi, generator=gen)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7, 2.0)
    bn("bn1", 64)
    c_in = 64
    for stage, n_blocks in enumerate(_DEPTHS[arch]):
        planes = 64 * 2**stage
        for block in range(n_blocks):
            t = f"layer{stage + 1}.{block}"
            conv(f"{t}.conv1", planes, c_in, 1, 2.0)
            bn(f"{t}.bn1", planes)
            conv(f"{t}.conv2", planes, planes, 3, 2.0)
            bn(f"{t}.bn2", planes)
            conv(f"{t}.conv3", planes * 4, planes, 1, 2.0)
            bn(f"{t}.bn3", planes * 4, scale=(0.1, 0.2))
            if block == 0:
                conv(f"{t}.downsample.0", planes * 4, c_in, 1, 1.0)
                bn(f"{t}.downsample.1", planes * 4)
            c_in = planes * 4
    sd["fc.weight"] = torch.randn(1000, 2048, generator=gen) * 2048 ** -0.5
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def _normalized(pixels: np.ndarray):
    """Seeded uint8 images [N, S, S, 3], each normalized with the extract
    CLI's ImageNet mean and std as it is drawn: the decoded images its
    extract function takes."""
    from vqa_tpu_torch.cli.extract import normalize

    return (normalize(p) for p in pixels)


def _conv_macs(torch, model, images) -> float:
    """Multiply-adds a image of one forward over ``images``: each conv's
    output elements times its input channels and window, from this run's
    shapes."""
    from vqa_tpu_torch.models.convnets import Conv

    macs = []
    hooks = [m.register_forward_hook(lambda m, _, out: macs.append(out.numel()
                                                                   * m.weight[0].numel()))
             for m in model.modules() if isinstance(m, Conv)]
    try:
        with torch.inference_mode():
            model(images)
    finally:
        for h in hooks:
            h.remove()
    return sum(macs) / images.shape[0]


def _extract_import(torch, tmp: str) -> tuple:
    """The seeded checkpoint through ``python -m
    vqa_tpu_torch.tools.import_torch --kind resnet152`` (in-process): its
    npz holds exactly the port ResNet's variables at their shapes, fc
    dropped. Returns (npz path, seconds)."""
    import io

    from vqa_tpu_torch.models import convnets
    from vqa_tpu_torch.tools import import_torch

    ckpt, npz = os.path.join(tmp, f"{EXTRACT_ARCH}.pth"), os.path.join(tmp, f"{EXTRACT_ARCH}.npz")
    sd = _resnet_state_dict(torch, EXTRACT_ARCH, seed=0)
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, ckpt)
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = import_torch.main([ckpt, "--kind", EXTRACT_ARCH, "--out", npz])
    import_s = time.perf_counter() - t
    want = {k: v.shape for k, v in convnets.export_variables(
        convnets.factory(EXTRACT_ARCH)).items()}
    with np.load(npz) as flat:
        got = {k: flat[k].shape for k in flat.files}
    _require(rc == 0 and got == want and not any("fc" in k for k in got),
             f"the imported {EXTRACT_ARCH} npz holds the port ResNet's {len(want)} variables at "
             f"their shapes, fc dropped: rc {rc}, {len(got)} keys")
    return npz, import_s


def _extract_phase(torch, dev, card: str, kernels: dict) -> dict:
    """Phase 11 (the docstring): import, extract, and the eval CLI over the
    extracted table; returns the launch counts of the eval CLI's kernel
    runs."""
    import dataclasses
    import io

    from vqa_tpu_torch.cli import train as train_cli
    from vqa_tpu_torch.cli.extract import extract, normalize
    from vqa_tpu_torch.config import load_options
    from vqa_tpu_torch.datasets import factory as data_factory
    from vqa_tpu_torch.datasets.features import FeatureStore
    from vqa_tpu_torch.datasets.interim import image_name
    from vqa_tpu_torch.models import convnets
    from vqa_tpu_torch.models.factory import factory as model_factory
    from vqa_tpu_torch.weights import export_params, random_params

    _require(not torch.backends.cudnn.allow_tf32, "float32 convs without TF32 (main sets it)")
    names = [image_name("val2014", i) for i in range(EXTRACT_IMAGES)]
    pixels = np.random.default_rng(4).integers(
        0, 256, (EXTRACT_IMAGES, EXTRACT_SIZE, EXTRACT_SIZE, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_extract_") as tmp:
        npz, import_s = _extract_import(torch, tmp)
        models = {}
        with np.load(npz) as flat:
            for label, dtype, device in (("bfloat16", torch.bfloat16, dev),
                                         ("float32", torch.float32, dev),
                                         ("host", torch.float32, "cpu")):
                models[label] = convnets.factory(EXTRACT_ARCH, dtype)
                convnets.load_variables(models[label], flat)
                models[label].to(device)

        # the forward alone at the CLI's batch, on the card, both dtypes
        batch = torch.from_numpy(np.stack([normalize(p) for p in pixels[:EXTRACT_BATCH]])).to(dev)
        macs = _conv_macs(torch, models["bfloat16"], batch)
        forward_ms = {}
        with torch.inference_mode():
            for dtype, iters in (("bfloat16", 10), ("float32", 3)):
                forward_ms[dtype] = _median_ms(torch, lambda m=models[dtype]: m(batch),
                                               iters=iters, warmup=2)
        del batch
        bound_ms = 2.0 * macs * EXTRACT_BATCH / PEAK_BF16 * 1e3

        # the CLI's extract function: every image in bf16, the first ones in
        # float32 on the card and on the host
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        got_names, feats = extract(models["bfloat16"], names, _normalized(pixels), "att",
                                   EXTRACT_BATCH, dev)
        bf16_s = time.perf_counter() - t
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        t = time.perf_counter()
        _, feats32 = extract(models["float32"], names[:EXTRACT_F32],
                             _normalized(pixels[:EXTRACT_F32]), "att", EXTRACT_BATCH, dev)
        f32_s = time.perf_counter() - t
        t = time.perf_counter()
        _, host = extract(models["host"], names[:EXTRACT_HOST], _normalized(
            pixels[:EXTRACT_HOST]), "att", EXTRACT_HOST, "cpu")
        host_s = time.perf_counter() - t
        # the same float32 forward with cuDNN's TF32 products, once: what
        # the hold against the host must tell from float32
        torch.backends.cudnn.allow_tf32 = True
        try:
            _, tf32 = extract(models["float32"], names[:EXTRACT_HOST], _normalized(
                pixels[:EXTRACT_HOST]), "att", EXTRACT_HOST, dev)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        _, noatt = extract(models["bfloat16"], names[:EXTRACT_F32],
                           _normalized(pixels[:EXTRACT_F32]), "noatt", EXTRACT_BATCH, dev)
        del models
        torch.cuda.empty_cache()

        _require(got_names == names and feats.shape == (EXTRACT_IMAGES, GRID, DIM)
                 and feats.dtype == np.float32, f"the extract function gives {EXTRACT_IMAGES} "
                 f"named float32 rows [{GRID}, {DIM}]: {feats.shape} {feats.dtype}")
        _require(all(np.isfinite(x).all() for x in (feats, feats32, host, noatt)),
                 "every extracted value finite")
        scale32 = float(np.abs(feats32).max())
        bf16_err = float(np.abs(feats[:EXTRACT_F32] - feats32).max()) / scale32
        host_scale = float(np.abs(host).max())
        host_err = float(np.abs(feats32[:EXTRACT_HOST] - host).max()) / host_scale
        tf32_err = float(np.abs(tf32 - host).max()) / host_scale
        mean = feats[:EXTRACT_F32].astype(np.float64).mean(axis=1)
        noatt_err = float(np.abs(noatt - mean).max()) / float(np.abs(mean).max())
        _require(bf16_err <= EXTRACT_BF16_TOL, f"bf16 grid within {EXTRACT_BF16_TOL} of the "
                 f"float32 one (TF32 off), relative to its max-abs: {bf16_err}")
        _require(host_err <= EXTRACT_HOST_TOL, f"the card's float32 grid within "
                 f"{EXTRACT_HOST_TOL} of the host's, relative to its max-abs: {host_err}")
        _require(tf32_err > EXTRACT_HOST_TOL, f"the hold tells TF32 from float32: the TF32 "
                 f"grid past {EXTRACT_HOST_TOL} of the host's: {tf32_err}")
        _require(noatt_err <= EXTRACT_NOATT_TOL, f"noatt within {EXTRACT_NOATT_TOL} of the "
                 f"mean of att, relative to its max-abs: {noatt_err}")
        _phase("extract", card=card, arch=EXTRACT_ARCH, images=EXTRACT_IMAGES,
               size=EXTRACT_SIZE, batch=EXTRACT_BATCH, import_s=round(import_s, 3),
               gmacs_per_image=round(macs / 1e9, 4),
               forward_bf16_ms=round(forward_ms["bfloat16"], 4),
               forward_bf16_images_per_s=round(EXTRACT_BATCH / forward_ms["bfloat16"] * 1e3, 1),
               forward_f32_ms=round(forward_ms["float32"], 4),
               forward_f32_images_per_s=round(EXTRACT_BATCH / forward_ms["float32"] * 1e3, 1),
               bound_ms=round(bound_ms, 4), bound_by="operations",
               pct_of_bound=round(100 * bound_ms / forward_ms["bfloat16"], 2),
               extract_bf16_s=round(bf16_s, 3),
               extract_bf16_images_per_s=round(EXTRACT_IMAGES / bf16_s, 1),
               extract_f32_images=EXTRACT_F32, extract_f32_s=round(f32_s, 3),
               extract_f32_images_per_s=round(EXTRACT_F32 / f32_s, 1),
               host_images=EXTRACT_HOST, host_s=round(host_s, 3),
               bf16_vs_f32=round(bf16_err, 6), tol=EXTRACT_BF16_TOL,
               f32_card_vs_host=round(host_err, 8), host_tol=EXTRACT_HOST_TOL,
               tf32_card_vs_host=round(tf32_err, 8),
               noatt_vs_mean=round(noatt_err, 6), noatt_tol=round(EXTRACT_NOATT_TOL, 6),
               features_std=round(float(feats.std()), 5),
               features_mean=round(float(feats.mean()), 5), peak_mem_gb=round(peak_gb, 3))
        del feats32, host, tf32, noatt, pixels

        # the eval CLI over the extracted table, kernels and plain path
        _write_raw_vqa2(os.path.join(tmp, "vqa2", "raw"), np.random.default_rng(0))
        data = [f"vqa.dir={tmp}/vqa2", f"coco.dir={tmp}/coco", f"coco.arch={EXTRACT_ARCH}"]
        launches, lines = dict.fromkeys(_counters(), 0), {}
        for arch, (name, arch_kernels) in EXTRACT_EVAL.items():
            yaml = os.path.join(_REPO, "options", "vqa2", f"{name}.yaml")
            opt = load_options(yaml, data)
            _require(opt.coco.mode == "att", f"{name}.yaml reads the att table")
            key = (opt.coco.dir, opt.coco.arch, opt.coco.mode, "ram")
            data_factory._STORE_CACHE[key] = FeatureStore.in_memory(names, feats)
            t = time.perf_counter()
            val_set = data_factory.factory("val", opt)  # the port's prep, on first use
            prep_s = time.perf_counter() - t
            _require(val_set.feature_shape == (GRID, DIM),
                     f"{arch} reads the {GRID}-region table: {val_set.feature_shape}")
            model = model_factory(dataclasses.asdict(opt.model), val_set.num_words,
                                  val_set.num_answers, dtype=torch.bfloat16, device=dev,
                                  dim_v=DIM)
            random_params(model, seed=0)
            weights = os.path.join(tmp, f"params_{name}.npz")
            np.savez(weights, **export_params(model))
            del model
            argv = ["--path_opt", yaml, "-e", "--split", "val"]
            for o in data + [f"model.pretrained_params={weights}", "engine.device_features=true",
                             "optim.eval_batch_size=1024", "engine.features_dtype=bfloat16"]:
                argv += ["--opt", o]
            runs = {}
            for label, plain in (("kernels", False), ("plain", True)):
                logs = os.path.join(tmp, "logs", f"{name}_{label}")
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                t = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()), \
                        (_plain_ops(torch) if plain else contextlib.nullcontext()):
                    rc = train_cli.main(argv + ["--dir_logs", logs])
                wall = time.perf_counter() - t
                counts = _read_counts()
                _require(rc == 0, f"eval CLI over the extracted table ({arch}, {label}) "
                         f"returned {rc}")
                with open(os.path.join(logs, "metrics.jsonl")) as f:
                    metrics = [json.loads(line) for line in f][-1]
                with open(os.path.join(logs, "results",
                                       "vqa_OpenEnded_val_epoch0_results.json")) as f:
                    results = {r["question_id"]: r["answer"] for r in json.load(f)}
                runs[label] = dict(counts=counts, metrics=metrics, results=results, wall=wall,
                                   peak_gb=torch.cuda.max_memory_allocated() / 2**30)
            split = val_set.split
            for label, run in runs.items():
                want = set() if label == "plain" else set(arch_kernels)
                _require({k for k, c in run["counts"].items() if c} == want,
                         f"eval CLI over the extracted table ({arch}, {label}) launched exactly "
                         f"{sorted(want)}: {run['counts']}")
                _require(len(run["results"]) == len(split)
                         and set(run["results"]) == set(split.question_ids.tolist()),
                         f"eval CLI over the extracted table ({arch}, {label}): one results row "
                         "per val question")
            agree = float(np.mean([runs["kernels"]["results"][q] == a
                                   for q, a in runs["plain"]["results"].items()]))
            _require(agree >= PRED_AGREE_FLOOR, f"eval CLI over the extracted table ({arch}): "
                     f"answers agree with the plain run's on {agree} >= {PRED_AGREE_FLOOR}")
            for k, c in runs["kernels"]["counts"].items():
                launches[k] += c
            lines[arch] = dict(
                prep_s=round(prep_s, 3), pred_agree_plain=round(agree, 5),
                **{f"{label}_{key}": value for label, run in runs.items()
                   for key, value in (("qa_per_sec", round(run["metrics"]["qa_per_sec"], 1)),
                                      ("eval_time", round(run["metrics"]["eval_time"], 4)),
                                      ("cli_s", round(run["wall"], 3)),
                                      ("peak_mem_gb", round(run["peak_gb"], 3)),
                                      ("acc1", run["metrics"]["acc1"]))},
                launches={k: c for k, c in runs["kernels"]["counts"].items() if c})
        for key in {k for k in data_factory._STORE_CACHE if k[0] == f"{tmp}/coco"}:
            del data_factory._STORE_CACHE[key]
    glimpse = kernels["glimpse_head"]["by_shape"][f"B{BATCH}_M510_R{GRID}"]
    relation = kernels["relation_attend"]["by_shape"][f"B{BATCH}_N{GRID}"]
    for arch, line in lines.items():
        _phase("extract_eval", card=card, arch=arch, table=f"{EXTRACT_ARCH}_att",
               regions=GRID, questions=len(split), batch=BATCH, floor=PRED_AGREE_FLOOR, **line)
    _phase("extract_eval", card=card, glimpse_head_b1024_r196_device_ms=glimpse["device_ms"],
           glimpse_head_b1024_r196_pct_of_bound=glimpse["device_pct_of_bound"],
           relation_attend_b1024_n196_device_ms=relation["device_ms"],
           relation_attend_b1024_n196_pct_of_bound=relation["pct_of_bound"],
           launches={k: c for k, c in launches.items() if c})
    return launches


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
    pooled_table = host_table.mean(axis=1)  # the NoAtt archs' [N, 2048] table
    tables = {}  # (bf16 table, int8 (values, bf16 scales)) on the card, by layout
    for layout, host in (("regions", host_table), ("pooled", pooled_table)):
        values, scales = quantize_features(host)
        tables[layout] = (torch.from_numpy(host).to(dev, torch.bfloat16),
                          (torch.from_numpy(values).to(dev),
                           torch.from_numpy(scales).to(dev, torch.bfloat16)))
    eval_data = eval_data[:-1]

    # 2. kernels against their plain versions
    rng = np.random.default_rng(0)
    kernels = {
        "gather_rows": _check_gather(torch, dev, rng),
        "gather_rows_dequant": _check_gather_dequant(torch, dev, rng,
                                                     quantize_features(host_table),
                                                     quantize_features(pooled_table)),
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
        features, int8_features = tables["pooled" if arch in NOATT_ARCHS else "regions"]
        for name, c in _arch_phases(torch, dev, arch, features, int8_features,
                                    eval_data).items():
            launches[name] += c
    _require(all(c > 0 for c in launches.values()), f"every kernel launched: {launches}")

    # 6. the eval CLI over a processed split
    for name, c in _eval_cli_phase(torch, dev, host_table, pooled_table).items():
        launches[name] += c

    # 7. the train path's two autograd Functions, 8. training
    card = smi.strip().splitlines()[0]
    train_ops = _check_train_ops(torch, dev, rng, card)
    for name, c in _train_phase(torch, dev, host_table, tables["regions"][0],
                                tables["pooled"][0], card).items():
        launches[name] += c
    # 9. the train CLI: checkpoints, SIGTERM, resume, eval and serve from
    # them; 10. export, serve --exported and visu over its runs
    from vqa_tpu_torch.datasets import factory as data_factory

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_cli_") as tmp:
        counts, context = _train_cli_phase(torch, dev, host_table, card, tmp)
        try:
            counts = [counts, _export_phase(torch, dev, card, tmp, context)]
        finally:
            del data_factory._STORE_CACHE[context["store_key"]]
    for phase_counts in counts:
        for name, c in phase_counts.items():
            launches[name] += c
    # 11. a ResNet-152 checkpoint through the import tool, the extract CLI's
    # function over 1024 images, and the eval CLI over the table it gave
    for name, c in _extract_phase(torch, dev, card, kernels).items():
        launches[name] += c
    for name, by_shape in train_ops.items():
        kernels[name]["train_fwd_bwd_ms"] = {k: round(t["fwd_bwd_ms"], 4)
                                             for k, t in by_shape.items()}
        kernels[name]["train_plain_fwd_bwd_ms"] = {k: round(t["plain_fwd_bwd_ms"], 4)
                                                   for k, t in by_shape.items()}

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
