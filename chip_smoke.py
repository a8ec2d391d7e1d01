#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vqa_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only multicard   # phase 16 alone, on four cards

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
 2b. f32_kernels: each kernel's float32 entry (the YAMLs' engine.dtype)
     against its plain version in float32 with TF32 off, at the archs'
     shapes, R = N = 196 and an odd H: within 1e-5 of the plain output's
     max-abs (glimpse_head, glimpse_attend, relation_attend), 1e-4
     (lstm_seq, whose plain recurrence with TF32 products is run beside it
     and must miss that), mfb_pool against its plain version in float64
     (its signed square root is ill-conditioned near 0), gather_rows on
     float32 rows bit-exact; lstm_seq and relation_attend also bit-equal
     across two calls, each with its plan's design named (relation_attend
     also at N=64, and at N=450, past its tiled design, the wide one;
     lstm_seq also at T=26, B=64, H=1024); each timed beside the plain
     version and its bound in float32 bytes (lstm_seq and relation_attend:
     bound_ms with the products once at the TF32 peak, the least any
     tensor-core route needs; bound_3xtf32_ms with the three passes their
     3xTF32 design runs, pct_of_3xtf32 the design's share of its own cost;
     bound_fp32_ms at the FP32-FMA peak), relation_attend beside SDPA in
     float32; glimpse_head and glimpse_attend also by device time (20
     back-to-back calls, device_ms, and its share of the bound). The
     readings go into each kernel's record under "f32_";
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

 12. f32_path: mutan_att.yaml as written, in float32 (the CLI phases 6, 9,
     10 and 11 pass engine.dtype=bfloat16, so their readings stay the bf16
     path's): the eval step at full width over the float32 table (4
     batches of 1024) and one CoR eval step over a 196-region table, each
     against the plain float32 path (logits within 1e-4 of the max-abs,
     answers agreeing on 0.999); the eval CLI over phase 6's set in
     float32 through the kernels and through the plain path (answers
     agreeing on 0.999; its log's model line naming cuda torch.float32);
     one float32 train step of MutanAtt and of MFBCoAtt at batch 128,
     dropout off (loss within 1e-5 relative, each grad within 1e-3 of the
     plain float32 path, a grad past that held against float64 instead:
     no further than twice the plain path's own error); a float32 program
     of phase 9's run A from save_export, loaded in a fresh interpreter on
     the card (within 1e-5 of the live model, launching its kernels). Each
     part counts its launches from 0, and every float32 entry must launch.
 13. fixture_matrix: the port's fixture matrix (vqa_tpu_torch.tools.
     fixture_matrix.run_config: the train CLI, then the port's scorer on
     the best epoch's results json) over the port's fixture generator's
     data (24 images and 200 questions a split, seed 5), its features in
     in-memory stores, the table on the card: (a) all eight graded configs
     at the JAX tool's dims, 6 epochs, float32 as the YAMLs are written;
     (b) the same in bf16; (c) the feature table in bfloat16 against int8
     (gather_rows_dequant); (d) MutanAtt, MFBCoAtt and CoR with every
     dropout 0 for 2 epochs on the card and on the host (--platform cpu),
     each epoch's train loss within 1e-3 relative and the last epoch's
     answers agreeing on 0.97 (MFBCoAtt: MATRIX_HOST_WIDE, with a host
     float64 run beside it); (e) mutan_att.yaml at full width (float32, lr
     1e-4, its dropout) at batch 512 for 3 epochs over a bench-scale
     fixture (1024 images, 16,384 questions in train and val), best val
     acc1 at least 0.60; (f) MutanAtt on the VQA v1, COCO-QA and TDIUC
     fixtures, 3 epochs; (g) MutanAtt and MFBCoAtt with --profile_dir for
     an epoch, every launched kernel in the trace's CUDA kernel events under
     its __global__ name. Held: each CLI returns 0, every best val acc1
     above the val split's majority-answer rate (but the MFB family's in
     bf16, reported beside its float32 rows), each run launching exactly
     its arch's kernels. Printed: each run's per-epoch train loss and val
     acc1, scorer overall, seconds and launches, beside the port's CPU run
     of the tool and ACCURACY.md's JAX row.
 14. parallel: data parallelism across processes (vqa_tpu_torch/parallel/)
     at mutan_att.yaml's full width, after phase 10 over phase 9's
     synthetic set. (a) The train CLI for one epoch at batch 128 (bf16, the
     table on the card) without --distributed, then as a world of one over
     NCCL (--distributed --num_processes 1 --process_id 0) with the table
     replicated and row-sharded (the train step's all_reduce over the
     world of one's NCCL group every step, and the sharded gather's
     reduce_scatter over NCCL, counted and required), then without
     again: each later run's
     metrics.jsonl and steps.jsonl (wall-clock fields aside), results json
     and checkpointed params.npz equal the first run's bit for bit; printed:
     each run's epoch time, its first print step's time and the median of
     the later ones (host clock, each ending in a readback). (b) Two ranks sharing the
     card over gloo, each a spawned process (parallel.initialize(backend=
     "gloo")), float32 as the YAML writes it, dropout off, sgd at lr 0.1: 3
     steps at a global batch of 128 (64 a rank) against one process at 128
     from the same seeded weights; the losses within 1e-5 relative and
     every parameter within rtol 2e-4, atol 1e-5 (the JAX package's bound
     for its 8-device step); printed: each rank's step time and the
     all_reduce's share of it (5 more steps, host clock after a sync).
     (c) The 1024-image table row-sharded over the same two ranks (512 rows
     each and a sink row), bf16 and the int8 pair: 2 eval batches of 1024
     (512 a rank) through the eval step, the gathered rows bit-equal to
     the replicated table's, pred and correct1 equal, gather_rows (int8:
     gather_rows_dequant) launched over each rank's shard; printed: each
     rank's resident table bytes and peak memory, replicated and sharded.
     Tensor parallelism (vqa_tpu_torch/parallel/partition.py: the optimizer
     state of the large 2-D leaves sharded over the mesh's model axis, the
     updated slices all-gathered): (d) two gloo ranks on the card as a
     1 x 2 mesh (model_parallel=2), float32, dropout off, 3 steps at a
     global batch of 128 against one process from the same weights, with
     (b)'s sgd (the same bounds) and with the YAML's adam (lr 1e-4: the
     ranks' parameters bit-equal to each other, each leaf within 1e-5 of
     its scale of one process's, the softmax-blind glimpse bias within lr
     x steps); printed: each rank's optimizer-state bytes beside one
     process's, peak memory, step time and the all-gather's and the
     all-reduce's shares of it (5 more steps); (e) the same as a 2 x 2 mesh
     (four ranks), sgd, the same bounds, adam's moments laid out at (d)'s
     split; (f) the train CLI with --distributed as a 1 x 2 world over gloo
     (engine.model_parallel=2, a step save every 2 steps, stopped after 4
     with the preemption save), resumed in one process without
     --distributed: its checkpoint holds adam's moments whole, and the
     resumed run's parameters are within rtol 2e-4, atol 1e-5 of (a)'s
     uninterrupted one; (g) the table row-sharded over (d)'s world, as
     (c).

 15. data (after phase 6): (a) phase 6's synthetic raw VQA v2 set prepared
     twice by the port's run_prep, through the native C++ encoder
     (vqa_tpu_torch/native/, built with g++) and with it forced to Python
     (native.available patched): each prep's splits counted under its
     encoder, every array of both splits and vocab.json byte-equal, each
     prep's seconds and its encode_split's questions/s printed, and the two
     encoders alone over all 48,750 questions, in turns; (b) MutanAtt's eval
     step at mutan_att.yaml's full width, bf16, the table on the card
     (visual_mode "index"), fed 8 batches of 1024 by item_loader (the
     per-item loader of datasets/vqa2.py, shuffled, seed 0) with 0 and with
     2 worker processes: each batch equal to dataset.batch's at the
     sampler's indices, logits and preds bit-equal to the eval of those
     batches (two forwards a batch: the logits, then the eval step, whose
     preds are their argmax), exactly gather_rows, lstm_seq and
     glimpse_head launched, the 2-worker stream equal to the in-process one
     batch for batch; (c) the per-item IO path (visual_mode "gather"): 2
     batches of 256 through 2 workers, every visual row byte-equal to
     FeatureStore.get at the same rows and each batch equal to
     BatchIterator's over the same rows, the loader's rows/s printed beside
     BatchIterator's. The loader's workers are spawned (a fresh interpreter
     each, the dataset pickled to it), so each stream's worker start is
     printed apart from its rate. At the end of the run, every prep of every phase but
     (a)'s forced one must have encoded natively
     (datasets/processed.py's ENCODERS; the ranks of phase 14 read phase
     9's processed files and prepare nothing).

 17. large_shapes (after 11): the designs for the shapes past the other
     designs' shared memory, each against its plain version on the card in
     bf16 and float32 at B=2, timed in turns with it (CUDA events) beside
     its bound: relation_attend's tc design (csrc/relation_tc.cu, the
     default past the tiled design) and its split design (forced: r's rows
     in chunks merged by their log-sum-exp) at N=3136 and 4096 and at the
     path's [B, 3136, 1024], D=1024, each bit-equal across two calls, timed
     in turns with each other, the plain version and SDPA (at N=2048 the
     tc, the wide and the split design timed against each other);
     glimpse_head's and glimpse_attend's designs at R=196, G=512 (glimpse
     groups), R=16,384, G=4 (region chunks) and the path's B=64, R=3136,
     G=24, M=510, D=2048, the attend logits masked past a row's middle and
     one row whole: in bf16 the tc design (csrc/glimpse_tc.cu, the
     default) and the split one (forced), each bit-equal across two calls,
     timed in turns with each other, the plain version and SDPA (held
     against plain first), the tc design's two launches timed apart, the
     host's time to enqueue a call and its launches, and its entry's
     geometry held against the plan's; the tc design also at two odd bf16
     shapes (M=77 and 509: the logits kernel's 2-byte joint loads; D=200
     and 136), held and not timed; in float32 the split design beside plain
     and SDPA; mfb_pool at m=20,000 (opted-in shared memory) and 70,000 (the
     roots in the output row), k=5; lstm_seq over an xg off 16 bytes
     bit-equal to the aligned call. Then the path: phase 11's ResNet-152
     checkpoint through the import tool, the extract CLI's function over
     64 seeded 1792x1792 images ([64, 3136, 2048], bf16), the eval CLI at
     the full width of cor.yaml and mutan_att.yaml (bf16, eval batch 64)
     over a synthetic raw VQA v2 set of 301 val questions on those images,
     through the kernels and the plain path: exactly each arch's kernels
     launched, every CoR relation_attend call the tc design, one
     results row per question, answers agreeing on 0.9; one forward of
     each at batch 64 with logits within 0.05 of the plain path's; CoR in
     float32 (16 questions over 8 rows) within 1e-4 of the plain float32
     path's max-abs; MutanAtt with 24 glimpses (alpha [3136, 24] past
     shared memory: every glimpse_head call the tc design) within 0.05. Each design's
     record goes into its kernel's in the kernels line, under "designs";
 16. multicard, with --only multicard alone, on a host of four cards (fewer:
     exit 1 before any phase; a run with no argument prints that it did not
     run it): [parallel]'s paths over NCCL, one rank a card, as the comment
     above MULTICARD_WORLD sets out: three meshes against one process, each
     rank's placement, the table sharded over the four, train QA/s on four
     cards against one, the train and eval CLIs under torchrun, and
     flagship.dryrun_multigpu(4).

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
# float32 (engine.dtype as options/default.yaml sets it): each kernel's
# float32 entry against its plain version in float32 (TF32 off), relative to
# the plain output's max-abs ([f32_kernels]):
# - glimpse_head, glimpse_attend, relation_attend: fp32 arithmetic, sums
#   taken in another order: 1e-5;
# - lstm_seq: the same carried through up to 26 steps: 1e-4. The plain
#   recurrence with its products in TF32 (one pass, ~3 decimal digits) is
#   run beside it and must miss that tolerance;
# - mfb_pool: the signed square root is ill-conditioned near 0 (a pooled
#   value of ~1e-7 from terms of ~1 moves by its whole self when the terms
#   are summed in another order, and its root by ~3e-4), so the kernel is
#   held against the plain version in float64: within 1e-5 of the max-abs,
#   or no further than twice the plain float32 version's own error;
# - gather_rows: bit-exact.
F32_REL = 1e-5
F32_LSTM_REL = 1e-4
# the float32 path ([f32_path]), against the plain float32 path: eval
# logits within 1e-4 of the max-abs (the LSTM's 1e-4 carried through the
# fusions), answers agreeing on 0.999 (argmax flips only where the top-2
# logits are that close); a train step's loss within 1e-5 relative and each
# grad within 1e-3 (relative, Frobenius); an exported program's logits
# within 1e-5 of the live model's (the same kernels, the same inputs)
F32_LOGITS_REL = 1e-4
F32_AGREE_FLOOR = 0.999
F32_LOSS_REL = 1e-5
F32_GRAD_REL = 1e-3
F32_EXPORT_REL = 1e-5
F32_EVAL_BATCHES = 4
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
PEAK_TF32 = 495e12   # FLOP/s on the tensor cores in TF32: the float32 kernels' products run
                     # there as 3xTF32, three passes each
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
# the data path ([data]): the item loader (datasets/vqa2.py::item_loader)
# feeding MutanAtt's eval step, N_BATCHES batches of BATCH with each worker
# count; the per-item IO part gathers float32 rows in DATA_IO_WORKERS
# workers, DATA_IO_BATCHES batches of DATA_IO_BATCH
DATA_WORKERS = (0, 2)
DATA_IO_WORKERS = 2
DATA_IO_BATCH = 256
DATA_IO_BATCHES = 2
DATA_KERNELS = ("gather_rows", "lstm_seq", "glimpse_head")
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
# [f32_path]'s train steps (arch, YAML, batch): the YAMLs' train batch, and
# MutanAtt at the eval batch (as --opt optim.batch_size=1024 sets it), where
# its lstm_seq takes the wg=2 class, whose sum stays in the tensor cores
F32_TRAIN_CASES = (("MutanAtt", "mutan_att", TRAIN_BATCH), ("MFBCoAtt", "mfb_coatt", TRAIN_BATCH),
                   ("MutanAtt", "mutan_att", BATCH))
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
                if key in ("", "pooled_", "f32_"):
                    # distinct int8 rows and their scales, once; the output
                    # in the scales' dtype
                    rows, row, segs = len(np.unique(tidx)), values[0].numel(), scales[0].size
                    elem = sc.element_size()
                    timing[key + "bound_ms"] = _bound(
                        rows * (row + segs * elem) + b * row * elem + 4 * b)[0]
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
    timing["f32_pct_of_bound"] = 100 * timing["f32_bound_ms"] / timing["f32_ms"]
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


def _lstm_inputs(torch, dev, rng, T, B, H, dtype=None):
    dtype = dtype or torch.bfloat16
    xg = torch.randn(T, B, 4 * H, device=dev).to(dtype)
    wh = (torch.randn(H, 4 * H, device=dev) / H ** 0.5).to(dtype)
    lengths = rng.integers(1, T + 1, B)
    lengths[:3] = (1, T, T // 2 + 1)
    left = rng.random(B) < 0.25  # a quarter of the rows left-padded
    t = np.arange(T)[:, None]
    valid = np.where(left[None, :], t >= T - lengths[None, :], t < lengths[None, :])
    mask = torch.from_numpy(valid[..., None].astype(np.float32)).to(dev, dtype)
    return xg, mask, wh


def _lstm_bound(T, B, H, elem=2, peak=None, passes=1):
    """xg, mask and wh read once, h_last and seq written once, in
    ``elem``-byte elements; the T-1 products h[B,H] x wh[H,4H] (step 0 has
    none), ``passes`` times, at the bf16 tensor-core peak or (float32)
    ``peak``: the FP32 peak, or the TF32 peak (3xTF32: three passes)."""
    flops = passes * 2.0 * (T - 1) * B * H * 4 * H
    return _bound(elem * (T * B * 4 * H + T * B + 4 * H * H + B * H + T * B * H),
                  flops, PEAK_BF16 if elem == 2 else (peak or PEAK_FP32))


def _relation_f32_bounds(B, N, D):
    """float32 relation_attend: ((bound_ms, bound_by), bound_3xtf32_ms,
    bound_fp32_ms): its two products once at the TF32 peak (the least any
    tensor-core route needs), three times there (the cost of its 3xTF32
    design), and at the FP32-FMA peak of the CUDA cores; pg and r read
    once, out written once."""
    nbytes, flops = 4 * 3 * B * N * D, 2.0 * 2 * B * N * N * D
    return (_bound(nbytes, flops, PEAK_TF32), _bound(nbytes, 3 * flops, PEAK_TF32)[0],
            _bound(nbytes, flops, PEAK_FP32)[0])


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


def _glimpse_head_bound(B, R, M, G, D, elem=2):
    """joint, w, b, v read once; attended and logits written once
    (``elem``-byte elements)."""
    return _bound(elem * (B * R * M + M * G + G + B * R * D + B * G * D + B * R * G),
                  2.0 * B * R * G * (M + D), PEAK_BF16 if elem == 2 else PEAK_FP32)


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


def _masked_logits(torch, dev, rng, B, T, G, dtype=None):
    """Self-attention logits as MFBCoAtt masks them: finfo(dtype).min past
    each row's length (mixed lengths, a quarter of the rows left-padded),
    and row 0 fully masked (the empty question); bf16 by default."""
    dtype = dtype or torch.bfloat16
    logits = torch.randn(B, T, G, device=dev).to(dtype)
    lengths = rng.integers(1, T + 1, B)
    left = rng.random(B) < 0.25
    t = np.arange(T)[None, :]
    valid = np.where(left[:, None], t >= T - lengths[:, None], t < lengths[:, None])
    valid[0] = False
    mask = torch.from_numpy(valid[..., None]).to(dev)
    return logits.masked_fill(~mask, torch.finfo(dtype).min)


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


# ------------------------------------------------------ float32 kernels


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def _f32_record(kernels, name, worst, timing, flagship, **extra):
    """Put a kernel's float32 readings into its record under ``f32_``."""
    rec = kernels[name]
    rec.update({"f32_rel_err": worst, **{f"f32_{k}": v for k, v in timing[flagship].items()},
                "f32_shape": flagship, **{f"f32_{k}": v for k, v in extra.items()},
                "f32_by_shape": {k: {n: (round(x, 6) if isinstance(x, float) else x)
                                     for n, x in t.items()} for k, t in timing.items()}})


def _check_f32_kernels(torch, dev, rng, kernels) -> None:
    """[f32_kernels]: each kernel's float32 entry against its plain version
    in float32 (TF32 off) at the archs' shapes, R = N = 196 and an odd H,
    with its time, the plain time and the bound in float32 bytes (lstm_seq
    and relation_attend: FLOPs once at the TF32 peak, beside them three
    times there, the 3xTF32 design's cost, and once at the FP32 peak);
    relation_attend with SDPA in float32 beside it; lstm_seq
    with the plain recurrence under TF32, which misses the tolerance. The
    readings go into each kernel's record under ``f32_``."""
    import torch.nn.functional as F

    from vqa_tpu_torch.ops.attention import (glimpse_attend, glimpse_attend_reference,
                                             glimpse_head, glimpse_head_reference,
                                             glimpse_plan)
    from vqa_tpu_torch.ops.gather import gather_rows, gather_rows_reference
    from vqa_tpu_torch.ops.lstm import launch_geometry_f32, lstm_seq, lstm_seq_reference
    from vqa_tpu_torch.ops.mfb_pool import mfb_pool, mfb_pool_reference
    from vqa_tpu_torch.ops import _build
    from vqa_tpu_torch.ops.relation import (_vec, launch_geometry, relation_attend,
                                            relation_attend_reference, relation_plan)

    f32 = torch.float32

    def timed(kernel, plain, iters=20):
        return _in_turns(torch, lambda t, fn: _median_ms(t, fn, iters=iters), kernel, plain)

    # gather_rows on float32 rows: bit-exact
    table = torch.randn(N_IMAGES, REGIONS, DIM, device=dev)
    idx = rng.integers(0, N_IMAGES, BATCH)
    idx_dev = torch.from_numpy(idx).to(dev)
    out = gather_rows(table, idx)
    _require(torch.equal(out, gather_rows_reference(table, idx_dev)),
             "gather_rows on float32 rows is bit-exact")
    ms, plain = timed(lambda: gather_rows(table, idx), lambda: gather_rows_reference(table, idx_dev))
    row = REGIONS * DIM * 4
    bound, by = _bound(len(np.unique(idx)) * row + BATCH * row + 4 * BATCH)
    timing = {"B1024": dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                            library_ms=plain, pct_of_bound=100 * bound / ms)}
    _phase("f32_kernels", kernel="gather_rows", shape="1024x36x2048[1024] float32",
           bit_exact=True, **{k: (round(v, 4) if isinstance(v, float) else v)
                              for k, v in timing["B1024"].items()})
    _f32_record(kernels, "gather_rows", 0.0, timing, "B1024", tol="exact")
    del table, out

    # lstm_seq: one persistent launch, h and c float32 between steps, the
    # products in 3xTF32 on the tensor cores; both classes of its plan (wg=2
    # at the eval batch and H=2400, wg=1 elsewhere)
    worst, timing, tf32_err = 0.0, {}, None
    for T, B, H in ((26, BATCH, 2400), (7, BATCH, 2400), (7, BATCH, 1024),
                    (26, SERVE_BATCH, 2400), (26, SERVE_BATCH, 1024), (5, 37, 41)):
        xg, mask, wh = _lstm_inputs(torch, dev, rng, T, B, H, f32)
        h, seq = lstm_seq(xg, mask, wh)
        again = lstm_seq(xg, mask, wh)
        ref_h, ref_seq = lstm_seq_reference(xg, mask, wh)
        torch.cuda.synchronize()
        err = max(_rel_err(h, ref_h), _rel_err(seq, ref_seq))
        _require(h.dtype == seq.dtype == f32 and bool(torch.isfinite(seq).all()),
                 f"lstm_seq float32 {(T, B, H)}: float32 and finite")
        _require(err <= F32_LSTM_REL, f"lstm_seq float32 {(T, B, H)}: {err} <= {F32_LSTM_REL}")
        _require(torch.equal(h, again[0]) and torch.equal(seq, again[1]),
                 f"lstm_seq float32 {(T, B, H)}: two calls bit-equal")
        worst = max(worst, err)
        geo = launch_geometry_f32(B, H + H % 2, dev.index or 0)
        design = (f"3xTF32_wgmma_wg{geo['cluster']}_stages{geo['stages']}_ctas{geo['ctas']}"
                  f"_tail{geo['tail_split']}")
        line = dict(T=T, B=B, H=H, rel_err=f"{err:.3e}", tol=F32_LSTM_REL, bit_equal=True,
                    ctas=geo["ctas"], tiles=geo["tiles"], design=design)
        if (T, B, H) == (26, BATCH, 2400):
            # the same plain recurrence with its products in TF32 (one pass,
            # ~3 decimal digits): the tolerance above must catch it
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                t_h, t_seq = lstm_seq_reference(xg, mask, wh)
                torch.cuda.synchronize()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            tf32_err = max(_rel_err(t_h, ref_h), _rel_err(t_seq, ref_seq))
            _require(tf32_err > F32_LSTM_REL, f"the plain recurrence in TF32 misses the float32 "
                     f"tolerance: {tf32_err} > {F32_LSTM_REL}")
            line["tf32_plain_rel_err"] = f"{tf32_err:.3e}"
            del t_h, t_seq
        if B == BATCH:
            ms, plain = timed(lambda: lstm_seq(xg, mask, wh),
                              lambda: lstm_seq_reference(xg, mask, wh), iters=5)
            bound, by = _lstm_bound(T, B, H, elem=4, peak=PEAK_TF32)
            bound_3x = _lstm_bound(T, B, H, elem=4, peak=PEAK_TF32, passes=3)[0]
            bound_fp32 = _lstm_bound(T, B, H, elem=4)[0]
            key = f"T{T}_B{B}" + ("" if H == 2400 else f"_H{H}")
            timing[key] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                               bound_3xtf32_ms=bound_3x, bound_fp32_ms=bound_fp32,
                               library_ms=None, pct_of_bound=100 * bound / ms,
                               pct_of_3xtf32=100 * bound_3x / ms, design=design,
                               tflops=2.0 * (T - 1) * B * H * 4 * H / ms / 1e9)
            line.update({k: (round(v, 4) if isinstance(v, float) else v)
                         for k, v in timing[key].items()})
        _phase("f32_kernels", kernel="lstm_seq", **line)
        del xg, mask, wh, h, seq, again, ref_h, ref_seq
    _f32_record(kernels, "lstm_seq", worst, timing, f"T26_B{BATCH}", tol=F32_LSTM_REL,
                tf32_plain_rel_err=tf32_err,
                bound_note="bound_ms: the products once at the 495 TFLOP/s TF32 peak; "
                           "bound_3xtf32_ms: three passes there, the 3xTF32 design's cost; "
                           "bound_fp32_ms: the products at the 67 TFLOP/s FP32-FMA peak")

    # glimpse_head
    worst, timing = 0.0, {}
    for B, R, M, G, D in ((BATCH, REGIONS, 510, 2, DIM), (SERVE_BATCH, REGIONS, 510, 2, DIM),
                          (BATCH, REGIONS, 512, 2, DIM), (BATCH, REGIONS, 1024, 1, DIM),
                          (BATCH, REGIONS, 1200, 2, DIM), (SERVE_BATCH, REGIONS, 510, 8, DIM),
                          (BATCH, GRID, 510, 2, DIM), (37, 36, 45, 2, 72), (5, 7, 33, 3, 75)):
        joint = torch.tanh(torch.randn(B, R, M, device=dev))
        w = torch.randn(M, G, device=dev) / M ** 0.5
        b = 0.1 * torch.randn(G, device=dev)
        v = torch.randn(B, R, D, device=dev)
        att, logits = glimpse_head(joint, w, b, v)
        ref_att, ref_logits = glimpse_head_reference(joint, w, b, v)
        torch.cuda.synchronize()
        err = max(_rel_err(att, ref_att), _rel_err(logits, ref_logits))
        _require(err <= F32_REL, f"glimpse_head float32 {(B, R, M, G, D)}: {err} <= {F32_REL}")
        worst = max(worst, err)
        plan = glimpse_plan(B, R, M, G, D, elem=4)
        line = dict(B=B, R=R, M=M, G=G, D=D, rel_err=f"{err:.3e}", tol=F32_REL,
                    plan=f"{plan['copy']}_staged{int(plan['staged'])}")
        if B == BATCH and D == DIM and M in (510, 1200):
            ms, plain = timed(lambda: glimpse_head(joint, w, b, v),
                              lambda: glimpse_head_reference(joint, w, b, v))
            device = _device_ms(torch, lambda: glimpse_head(joint, w, b, v))
            bound, by = _glimpse_head_bound(B, R, M, G, D, elem=4)
            key = f"B{B}_M{M}" + ("" if R == REGIONS else f"_R{R}")
            timing[key] = dict(ms=ms, plain_ms=plain, device_ms=device, bound_ms=bound,
                               bound_by=by, library_ms=None, pct_of_bound=100 * bound / ms,
                               device_pct_of_bound=100 * bound / device)
            line.update({k: (round(x, 4) if isinstance(x, float) else x)
                         for k, x in timing[key].items()})
        _phase("f32_kernels", kernel="glimpse_head", **line)
        del joint, w, b, v, att, logits, ref_att, ref_logits
    _f32_record(kernels, "glimpse_head", worst, timing, f"B{BATCH}_M510", tol=F32_REL)

    # glimpse_attend, masked at finfo(float32).min
    worst, timing = 0.0, {}
    for B, T, G, D in ((BATCH, 7, 2, 1024), (BATCH, 13, 2, 1024), (BATCH, 26, 2, 1024),
                       (SERVE_BATCH, REGIONS, 8, 1024), (SERVE_BATCH, GRID, 2, 1024),
                       (5, 9, 3, 75)):
        logits = _masked_logits(torch, dev, rng, B, T, G, f32)
        v = torch.randn(B, T, D, device=dev)
        out = glimpse_attend(logits, v)
        ref = glimpse_attend_reference(logits, v)
        torch.cuda.synchronize()
        err = _rel_err(out, ref)
        _require(err <= F32_REL, f"glimpse_attend float32 {(B, T, G, D)}: {err} <= {F32_REL}")
        _require(bool(torch.allclose(out[0], v[0].mean(0).expand(G, D), atol=F32_REL)),
                 "glimpse_attend float32: a fully masked row gives uniform weights")
        worst = max(worst, err)
        line = dict(B=B, T=T, G=G, D=D, rel_err=f"{err:.3e}", tol=F32_REL)
        if B == BATCH:
            ms, plain = timed(lambda: glimpse_attend(logits, v),
                              lambda: glimpse_attend_reference(logits, v))
            device = _device_ms(torch, lambda: glimpse_attend(logits, v))
            bound, by = _bound(4 * (B * T * G + B * T * D + B * G * D), 2.0 * B * T * G * D,
                               PEAK_FP32)
            timing[f"T{T}_B{B}"] = dict(ms=ms, plain_ms=plain, device_ms=device, bound_ms=bound,
                                        bound_by=by, library_ms=None,
                                        pct_of_bound=100 * bound / ms,
                                        device_pct_of_bound=100 * bound / device)
            line.update({k: (round(x, 4) if isinstance(x, float) else x)
                         for k, x in timing[f"T{T}_B{B}"].items()})
        _phase("f32_kernels", kernel="glimpse_attend", **line)
        del logits, v, out, ref
    _f32_record(kernels, "glimpse_attend", worst, timing, f"T7_B{BATCH}", tol=F32_REL)

    # mfb_pool: held against the plain version in float64 (MFB_F32_HOLD)
    worst, timing = 0.0, {}
    for n, k, m in ((BATCH * REGIONS, 5, 1000), (BATCH, 5, 1000), (131, 3, 33), (37, 5, 1001)):
        z = torch.randn(n, k * m, device=dev)
        out = mfb_pool(z, k)
        plain_out = mfb_pool_reference(z, k)
        exact = mfb_pool_reference(z.double(), k)
        torch.cuda.synchronize()
        err, plain_err = _rel_err(out, exact), _rel_err(plain_out, exact)
        vs_plain = _rel_err(out, plain_out)
        tol = max(F32_REL, 2 * plain_err)
        _require(out.dtype == f32 and err <= tol,
                 f"mfb_pool float32 {(n, k, m)}: {err} from float64 <= max({F32_REL}, twice "
                 f"the plain float32's {plain_err})")
        worst = max(worst, vs_plain)
        line = dict(n=n, k=k, m=m, rel_err_vs_f64=f"{err:.3e}",
                    plain_rel_err_vs_f64=f"{plain_err:.3e}", tol=f"{tol:.3e}",
                    rel_err_vs_plain=f"{vs_plain:.3e}")
        if m == 1000:
            ms, plain = timed(lambda: mfb_pool(z, k), lambda: mfb_pool_reference(z, k))
            bound, by = _bound(4 * (n * k * m + n * m), n * (k * m + 4 * m), PEAK_FP32)
            timing[f"n{n}"] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                                   library_ms=None, pct_of_bound=100 * bound / ms,
                                   rel_err_vs_f64=err, plain_rel_err_vs_f64=plain_err)
            line.update({k: (round(x, 4) if isinstance(x, float) else x)
                         for k, x in timing[f"n{n}"].items() if k.endswith(("ms", "by"))})
        _phase("f32_kernels", kernel="mfb_pool", **line)
        del z, out, plain_out, exact
    _f32_record(kernels, "mfb_pool", worst, timing, f"n{BATCH * REGIONS}",
                tol="float64 hold: max(1e-5, twice the plain float32's own error)")

    # relation_attend: the tiled design, both products in 3xTF32 on wgmma,
    # at N <= 256; the tc one (two wgmma kernels) past it (N=450); two calls
    # bit-equal; SDPA beside it
    worst, timing = 0.0, {}
    for B, N, D, offset in ((BATCH, REGIONS, 1024, 0), (SERVE_BATCH, GRID, 1024, 0),
                            (BATCH, GRID, 1024, 0), (BATCH, 64, 1024, 0), (5, 7, 33, 0),
                            (3, 65, 40, 0), (8, 450, 1024, 0), (3, 36, 1024, 1)):
        pg = torch.tanh(torch.randn(B, N, D, device=dev))
        r = torch.empty(B * N * D + offset, device=dev)[offset:].view(B, N, D)
        r.copy_(torch.tanh(torch.randn(B, N, D, device=dev)))
        out = relation_attend(pg, r)
        again = relation_attend(pg, r)
        ref = relation_attend_reference(pg, r)
        torch.cuda.synchronize()
        err = _rel_err(out, ref)
        _require(err <= F32_REL, f"relation_attend float32 {(B, N, D)}: {err} <= {F32_REL}")
        _require(torch.equal(out, again),
                 f"relation_attend float32 {(B, N, D)}: two calls bit-equal")
        worst = max(worst, err)
        vec = _vec(D, pg, r, out)
        plan = relation_plan(B, N, D, vec=vec, smem_limit=_build.smem_optin(dev.index or 0),
                             elem=4)
        card = launch_geometry(B, N, D, plan, vec, dev.index or 0, elem=4)
        _require(card == {k: plan[k] for k in card},
                 f"relation_attend float32 {(B, N, D)}: the entry launches the plan's geometry "
                 f"({card} vs {plan})")
        design = f"{plan['design']}_stages{plan['stages']}"
        line = dict(B=B, N=N, D=D, offset=offset, rel_err=f"{err:.3e}", tol=F32_REL,
                    bit_equal=True, design=design)
        if B == BATCH:
            iters = 5 if N == GRID else 20
            ms, plain = timed(lambda: relation_attend(pg, r),
                              lambda: relation_attend_reference(pg, r), iters=iters)
            # the same function in one PyTorch call, timed here only
            library = _median_ms(torch, lambda: F.scaled_dot_product_attention(pg, r, r),
                                 iters=iters)
            (bound, by), bound_3x, bound_fp32 = _relation_f32_bounds(B, N, D)
            timing[f"B{B}_N{N}"] = dict(ms=ms, plain_ms=plain, library_ms=library,
                                        bound_ms=bound, bound_by=by, bound_3xtf32_ms=bound_3x,
                                        bound_fp32_ms=bound_fp32, pct_of_bound=100 * bound / ms,
                                        pct_of_3xtf32=100 * bound_3x / ms, design=design)
            line.update({k: (round(x, 4) if isinstance(x, float) else x)
                         for k, x in timing[f"B{B}_N{N}"].items()})
        _phase("f32_kernels", kernel="relation_attend", **line)
        del pg, r, out, again, ref
    _f32_record(kernels, "relation_attend", worst, timing, f"B{BATCH}_N{REGIONS}", tol=F32_REL,
                library="F.scaled_dot_product_attention(pg, r, r) in float32",
                bound_note="bound_ms: the products once at the 495 TFLOP/s TF32 peak, or the "
                           "bytes; bound_3xtf32_ms: three passes there, the 3xTF32 design's "
                           "cost; bound_fp32_ms: the products at the 67 TFLOP/s FP32 peak")


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
        for design in getattr(fn, "design_launches", {}):
            fn.design_launches[design] = 0


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
    from vqa_tpu_torch.parallel import mesh

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
        (mesh, "gather_rows", plain_gather),
        (mesh, "gather_rows_dequant", plain_gather_dequant),
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


def _write_raw_vqa2(dir_raw: str, rng: np.random.Generator, n_images: int = N_IMAGES,
                    n_train: int = CLI_TRAIN_QUESTIONS, n_val: int = CLI_QUESTIONS) -> None:
    """A synthetic raw VQA v2 set in the official schema
    (vqa_tpu_torch/datasets/interim.py): ``n_train`` train and ``n_val``
    val questions (CLI_TRAIN_QUESTIONS and CLI_QUESTIONS) over ``n_images``
    images (N_IMAGES), bench.py:39-58's question lengths over NUM_WORDS - 2
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
    for split, n, first_qid in (("train", n_train, 1), ("val", n_val, 10_000_000)):
        lengths = np.clip(np.round(rng.normal(6.2, 2.2, n)), 3, SEQ).astype(int).tolist()
        tokens = rng.integers(0, len(words), (n, SEQ)).tolist()
        image_ids = rng.integers(0, n_images, n).tolist()
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
        argvs = {}
        for mode, features in (("att", table), ("noatt", pooled)):
            opt = load_options(yamls[mode], data)
            _require(opt.coco.mode == mode, f"{yamls[mode]} reads the {mode} table")
            data_factory.place_store(opt.coco.dir, opt.coco.arch, opt.coco.mode,
                                     FeatureStore.in_memory(names, features))
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
                             "optim.eval_batch_size=1024", "engine.dtype=bfloat16"]:
                argvs[mode] += ["--opt", o]
        split = val_set.split
        _require(val_set.num_answers == opt.vqa.nans, f"answer vocabulary {val_set.num_answers} "
                 f"== nans {opt.vqa.nans}")
        _require(val_set.num_words >= 0.99 * NUM_WORDS, f"word vocabulary {val_set.num_words} "
                 f"~ {NUM_WORDS}")
        _require(len(split) == CLI_QUESTIONS and len(split) % BATCH, "a padded last batch")

        runs = {}
        # the bf16 runs pass engine.dtype=bfloat16 (argvs); the float32 runs
        # set it back to the YAML's float32 ([f32_path])
        for label, mode, features_dtype, plain in (("bf16", "att", "bfloat16", False),
                                                   ("plain", "att", "bfloat16", True),
                                                   ("int8", "att", "int8", False),
                                                   ("noatt", "noatt", "bfloat16", False),
                                                   ("noatt_plain", "noatt", "bfloat16", True),
                                                   ("f32", "att", "float32", False),
                                                   ("f32_plain", "att", "float32", True)):
            logs = os.path.join(tmp, "logs", label)
            dtype = ["--opt", "engine.dtype=float32"] if label.startswith("f32") else []
            out = io.StringIO()
            _reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    (_plain_ops(torch) if plain else contextlib.nullcontext()):
                rc = train_cli.main(argvs[mode] + ["--dir_logs", logs, "--opt",
                                                   f"engine.features_dtype={features_dtype}"]
                                    + dtype)
            wall = time.perf_counter() - t0
            counts = _read_counts()
            model_line = next((line for line in out.getvalue().splitlines()
                               if line.startswith("model ")), "")
            want_dtype = "float32" if label.startswith("f32") else "bfloat16"
            _require(model_line.endswith(f"cuda torch.{want_dtype}"),
                     f"eval CLI ({label}): the log's model line names cuda torch.{want_dtype}: "
                     f"{model_line!r}")
            _require(rc == 0, f"eval CLI ({label}) returned {rc}")
            with open(os.path.join(logs, "metrics.jsonl")) as f:
                metrics = [json.loads(line) for line in f][-1]
            path = os.path.join(logs, "results", "vqa_OpenEnded_val_epoch0_results.json")
            with open(path) as f:
                results = {r["question_id"]: r["answer"] for r in json.load(f)}
            runs[label] = dict(counts=counts, metrics=metrics, results=results, path=path,
                               wall=wall, model_line=model_line)

        want = {"bf16": set(CLI_KERNELS), "plain": set(),
                "int8": {"gather_rows_dequant", "lstm_seq", "glimpse_head"},
                "noatt": set(CLI_NOATT_KERNELS), "noatt_plain": set(),
                "f32": set(CLI_KERNELS), "f32_plain": set()}
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
        f32_agree = agreement("f32", "f32_plain")
        _require(f32_agree >= F32_AGREE_FLOOR, f"[f32_path] the float32 eval CLI's answers agree "
                 f"with its plain float32 run's on {f32_agree} >= {F32_AGREE_FLOOR}")

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
        data_factory.drop_stores(f"{tmp}/coco")

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
    f32 = runs["f32"]
    _phase("f32_path", part="eval_cli", arch="MutanAtt", dtype="float32",
           questions=len(split), batch=BATCH, log_line=repr(f32["model_line"]),
           qa_per_sec=round(f32["metrics"]["qa_per_sec"], 1),
           plain_qa_per_sec=round(runs["f32_plain"]["metrics"]["qa_per_sec"], 1),
           eval_time=round(f32["metrics"]["eval_time"], 4), cli_s=round(f32["wall"], 3),
           acc1=f32["metrics"]["acc1"], pred_agree_plain=round(f32_agree, 5),
           floor=F32_AGREE_FLOOR, pred_agree_bf16=round(agreement("f32", "bf16"), 5),
           launches={k: c for k, c in f32["counts"].items() if c})
    return ({k: sum(runs[label]["counts"][k] for label in ("bf16", "int8", "noatt", "f32"))
             for k in runs["bf16"]["counts"]}, f32["counts"])


# ------------------------------------------------------------------ data


def _timed_encode_split(processed, log: list):
    """A stand-in for ``processed.encode_split`` that appends (questions,
    seconds) of each call to ``log``."""
    real = processed.encode_split

    def timed(examples, *args, **kwargs):
        t0 = time.perf_counter()
        out = real(examples, *args, **kwargs)
        log.append((len(out), time.perf_counter() - t0))
        return out

    return timed


def _native_prep(tmp: str) -> dict:
    """(a): phase 6's synthetic raw VQA v2 set through the port's run_prep
    twice, as shipped (the native encoder) and with the encoder forced to
    Python (``native.available`` patched); every array of every split and
    vocab.json byte-equal. Returns the options of the native prep's set and
    what was measured."""
    import shutil

    from vqa_tpu_torch import native
    from vqa_tpu_torch.config import load_options
    from vqa_tpu_torch.datasets import processed
    from vqa_tpu_torch.datasets.tokenizer import tokenize_mcb

    raw = os.path.join(tmp, "native", "raw")
    t0 = time.perf_counter()
    _write_raw_vqa2(raw, np.random.default_rng(0))
    raw_s = time.perf_counter() - t0
    shutil.copytree(raw, os.path.join(tmp, "python", "raw"))
    yaml = os.path.join(_REPO, "options", "vqa2", "mutan_att.yaml")
    _require(native.available(), f"the native encoder builds here: {native.build_error()}")
    runs, opt = {}, None
    for encoder in ("native", "python"):
        options = load_options(yaml, [f"vqa.dir={tmp}/{encoder}", f"coco.dir={tmp}/coco"])
        _require(options.vqa.nlp == "mcb", f"{yaml} tokenizes with mcb")
        before = dict(processed.ENCODERS)
        log, saved = [], (processed.encode_split, native.available)
        processed.encode_split = _timed_encode_split(processed, log)
        if encoder == "python":
            native.available = lambda: False
        try:
            t0 = time.perf_counter()
            out_dir = processed.run_prep(options.vqa.dir, options.vqa, ("train", "val"))
            prep_s = time.perf_counter() - t0
        finally:
            processed.encode_split, native.available = saved
        counted = {k: v - before.get(k, 0) for k, v in processed.ENCODERS.items()
                   if v != before.get(k, 0)}
        _require(counted == {encoder: 2}, f"the {encoder} prep encoded its 2 splits with the "
                 f"{encoder} encoder: {counted}")
        questions, encode_s = sum(n for n, _ in log), sum(t for _, t in log)
        runs[encoder] = dict(dir=out_dir, prep_s=prep_s, encode_s=encode_s, questions=questions)
        if encoder == "native":
            opt = options
    for name in ("train", "val"):
        got, want = (processed.load_split(runs[e]["dir"], name) for e in ("native", "python"))
        for field in ("question_ids", "questions", "lengths", "image_names", "answers",
                      "answer_pool"):
            a, b = getattr(got, field), getattr(want, field)
            _require(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(),
                     f"{name}.{field} byte-equal from the native and the Python encoder")
    with open(os.path.join(runs["native"]["dir"], "vocab.json"), "rb") as a, \
            open(os.path.join(runs["python"]["dir"], "vocab.json"), "rb") as b:
        _require(a.read() == b.read(), "vocab.json byte-equal from both preps")

    # the encoders alone over every question of the set, native in turns
    vocabs = processed.load_vocabs(runs["native"]["dir"])
    texts = []
    for name in ("train", "val"):
        with open(os.path.join(tmp, "native", "interim", f"{name}_interim.json")) as f:
            texts += [ex["question"] for ex in json.load(f)]
    enc = native.NativeEncoder(vocabs.wid_to_word)

    def native_encode():
        return enc.encode_batch(texts, opt.vqa.maxlength, opt.vqa.pad)

    def python_encode():
        return processed.encode_question_batch(texts, tokenize_mcb, vocabs.word_to_wid,
                                               opt.vqa.maxlength, opt.vqa.pad)

    times, outs = {"native": [], "python": []}, {}
    for encoder in ("native", "python", "python", "native"):
        fn = native_encode if encoder == "native" else python_encode
        t0 = time.perf_counter()
        outs[encoder] = fn()
        times[encoder].append(time.perf_counter() - t0)
    _require(all(a.tobytes() == b.tobytes() for a, b in zip(outs["native"], outs["python"])),
             "the encoders' ids and lengths byte-equal over every question")
    encoder_s = {e: statistics.median(times[e]) for e in times}
    return dict(opt=opt, raw_s=raw_s, runs=runs, encoder_s=encoder_s, texts=len(texts))


def _host_equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes()
        for k in a)


def _item_loader_eval(torch, dev, val_set, table, opt) -> dict:
    """(b): MutanAtt's eval step at full width (bf16, the table on the card)
    fed N_BATCHES batches of BATCH from item_loader with each of
    DATA_WORKERS, against the same batches built by ``dataset.batch`` at
    the loader's indices: logits and preds bit-equal, the streams equal
    batch for batch."""
    import dataclasses
    import itertools

    from vqa_tpu_torch.datasets.index_shuffle import epoch_permutation
    from vqa_tpu_torch.datasets.vqa2 import item_loader
    from vqa_tpu_torch.engine import steps
    from vqa_tpu_torch.engine.engine import make_device_transform
    from vqa_tpu_torch.models.factory import factory as model_factory
    from vqa_tpu_torch.weights import random_params

    model = model_factory(dataclasses.asdict(opt.model), val_set.num_words, val_set.num_answers,
                          dtype=torch.bfloat16, device=dev, dim_v=DIM)
    random_params(model, seed=0)
    transform = make_device_transform(dev, torch.bfloat16)
    eval_step = steps.make_eval_step()

    @torch.inference_mode()
    def forward(batch):
        # the logits (the eval step's forward, called as it calls it), then
        # the eval step itself: two forwards a batch
        b = transform(batch)
        logits = model(steps._resolve_visual(b, table), b["question"], b["length"])
        pred = eval_step(model, b, table)["pred"]
        _require(torch.equal(pred, logits.argmax(dim=-1).to(torch.int32)),
                 "[data] the eval step's preds are its logits' argmax")
        return logits, pred

    seed = 0
    sampler_seed = int(np.random.SeedSequence([seed, 0]).generate_state(1)[0] & 0x7FFFFFFF)
    order = epoch_permutation(len(val_set), sampler_seed, 0)
    want_batches = [val_set.batch(order[i * BATCH:(i + 1) * BATCH]) for i in range(N_BATCHES)]
    want = [forward(b) for b in want_batches]
    streams, counts, load_s, start_s = {}, {}, {}, {}
    for workers in DATA_WORKERS:
        loader = item_loader(val_set, BATCH, shuffle=True, seed=seed, worker_count=workers)
        _reset_counts()
        t0 = time.perf_counter()
        batch_iter = iter(loader)  # starts the workers (spawned: a fresh interpreter each)
        start_s[workers] = time.perf_counter() - t0
        batches, outs = [], []
        for batch in itertools.islice(batch_iter, N_BATCHES):
            batches.append(batch)
            outs.append(forward(batch))
        torch.cuda.synchronize()
        load_s[workers] = time.perf_counter() - t0
        del batch_iter  # stops the workers
        counts[workers] = _read_counts()
        _require({k for k, c in counts[workers].items() if c} == set(DATA_KERNELS),
                 f"[data] the eval step fed by item_loader (workers={workers}) launched exactly "
                 f"{DATA_KERNELS}: {counts[workers]}")
        _require(len(batches) == N_BATCHES, f"{N_BATCHES} batches from the loader")
        for i, (batch, (logits, pred), (want_logits, want_pred)) in enumerate(
                zip(batches, outs, want)):
            _require(np.array_equal(batch["question_id"],
                                    val_set.split.question_ids[order[i * BATCH:(i + 1) * BATCH]]),
                     f"[data] batch {i} (workers={workers}) reads the sampler's records")
            _require(_host_equal(batch, want_batches[i]),
                     f"[data] batch {i} (workers={workers}) equals dataset.batch's")
            _require(bool(torch.isfinite(logits).all())
                     and tuple(logits.shape) == (BATCH, val_set.num_answers),
                     f"[data] finite logits of shape ({BATCH}, {val_set.num_answers})")
            _require(torch.equal(logits, want_logits) and torch.equal(pred, want_pred),
                     f"[data] batch {i} (workers={workers}): logits and preds bit-equal to "
                     "dataset.batch's")
        streams[workers] = batches
    base = streams[DATA_WORKERS[0]]
    for workers in DATA_WORKERS[1:]:
        _require(all(_host_equal(a, b) for a, b in zip(streams[workers], base)),
                 f"[data] the {workers}-worker stream equals the in-process one batch for batch")
    return dict(counts=counts, load_s=load_s, start_s=start_s, answers=val_set.num_answers)


def _item_loader_io(val_set, store) -> dict:
    """(c): the per-item IO path, visual_mode="gather": DATA_IO_BATCHES
    batches of DATA_IO_BATCH through DATA_IO_WORKERS workers, every
    ``visual`` byte-equal to FeatureStore.get at the same rows; the
    loader's rows/s beside BatchIterator's over the same batches (in order:
    the first DATA_IO_BATCHES * DATA_IO_BATCH rows)."""
    import itertools

    from vqa_tpu_torch.datasets.pipeline import BatchIterator
    from vqa_tpu_torch.datasets.vqa2 import item_loader

    rows = DATA_IO_BATCH * DATA_IO_BATCHES
    t0 = time.perf_counter()
    batch_iter = iter(item_loader(val_set, DATA_IO_BATCH, worker_count=DATA_IO_WORKERS))
    start_s = time.perf_counter() - t0
    got = list(itertools.islice(batch_iter, DATA_IO_BATCHES))
    loader_s = time.perf_counter() - t0
    del batch_iter
    t0 = time.perf_counter()
    want = list(itertools.islice(BatchIterator(val_set, DATA_IO_BATCH).epoch(0), DATA_IO_BATCHES))
    iterator_s = time.perf_counter() - t0
    for i, (g, w) in enumerate(zip(got, want)):
        idx = np.arange(i * DATA_IO_BATCH, (i + 1) * DATA_IO_BATCH)
        rows_want = store.get(val_set.image_index[idx])
        _require(g["visual"].dtype == rows_want.dtype and g["visual"].shape == rows_want.shape
                 and g["visual"].tobytes() == rows_want.tobytes(),
                 f"[data] io batch {i}: visual byte-equal to FeatureStore.get")
        _require(_host_equal(g, w), f"[data] io batch {i} equals BatchIterator's")
    return dict(rows=rows, loader_s=loader_s, start_s=start_s, iterator_s=iterator_s,
                visual_bytes=int(sum(b["visual"].nbytes for b in got)))


def _data_phase(torch, dev, host_table: np.ndarray, table, card: str) -> dict:
    """[data]: (a) the native prep against the Python one, (b) item_loader
    feeding MutanAtt's eval step, (c) the per-item IO path; returns the
    launch counts of (b) and the splits (a) forced to Python."""
    from vqa_tpu_torch.datasets import factory as data_factory
    from vqa_tpu_torch.datasets.features import FeatureStore
    from vqa_tpu_torch.datasets.interim import image_name

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        prep = _native_prep(tmp)
        opt, runs, encoder_s = prep["opt"], prep["runs"], prep["encoder_s"]
        for encoder, run in runs.items():
            _phase("data", part="prep", encoder=encoder, questions=run["questions"],
                   prep_s=round(run["prep_s"], 4), encode_s=round(run["encode_s"], 4),
                   encode_qps=round(run["questions"] / run["encode_s"], 1),
                   raw_s=round(prep["raw_s"], 3), card=repr(card))
        _phase("data", part="encoder", questions=prep["texts"],
               native_s=round(encoder_s["native"], 4), python_s=round(encoder_s["python"], 4),
               native_qps=round(prep["texts"] / encoder_s["native"], 1),
               python_qps=round(prep["texts"] / encoder_s["python"], 1),
               speedup=round(encoder_s["python"] / encoder_s["native"], 2), bytes_equal=True)

        names = [image_name("val2014", i) for i in range(N_IMAGES)]
        store = FeatureStore.in_memory(names, host_table)
        data_factory.place_store(opt.coco.dir, opt.coco.arch, opt.coco.mode, store)
        try:
            val_index = data_factory.factory("val", opt, visual_mode="index")
            val_gather = data_factory.factory("val", opt, visual_mode="gather")
            loader = _item_loader_eval(torch, dev, val_index, table, opt)
            io = _item_loader_io(val_gather, store)
        finally:
            data_factory.drop_stores(f"{tmp}/coco")
    n = BATCH * N_BATCHES
    _phase("data", part="item_loader", arch="MutanAtt", batch=BATCH, batches=N_BATCHES,
           answers=loader["answers"], logits_bit_equal=True, preds_bit_equal=True,
           **{f"workers{w}_s": round(s, 4) for w, s in loader["load_s"].items()},
           **{f"workers{w}_start_s": round(s, 4) for w, s in loader["start_s"].items()},
           **{f"workers{w}_qa_per_s": round(n / s, 1) for w, s in loader["load_s"].items()},
           **{f"workers{w}_qa_per_s_after_start": round(n / (s - loader["start_s"][w]), 1)
              for w, s in loader["load_s"].items()},
           launches={k: c for k, c in loader["counts"][DATA_WORKERS[0]].items() if c})
    _phase("data", part="io", workers=DATA_IO_WORKERS, batch=DATA_IO_BATCH,
           batches=DATA_IO_BATCHES, visual_bytes=io["visual_bytes"],
           loader_s=round(io["loader_s"], 4), loader_start_s=round(io["start_s"], 4),
           loader_rows_per_s=round(io["rows"] / io["loader_s"], 1),
           loader_rows_per_s_after_start=round(io["rows"] / (io["loader_s"] - io["start_s"]), 1),
           batch_iterator_s=round(io["iterator_s"], 4),
           batch_iterator_rows_per_s=round(io["rows"] / io["iterator_s"], 1), card=repr(card))
    _phase("data", part="total", wall_s=round(time.perf_counter() - t_phase, 2))
    counts = {k: sum(c[k] for c in loader["counts"].values()) for k in loader["counts"][0]}
    return counts, 2


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


def _cli_store(host_table: np.ndarray):
    """Phase 9's one store for every split, as the factory keeps it: the val
    images' rows (phase 6's table) and the train images' rows after them."""
    from vqa_tpu_torch.datasets.features import FeatureStore
    from vqa_tpu_torch.datasets.interim import image_name

    names = ([image_name("val2014", i) for i in range(N_IMAGES)]
             + [image_name("train2014", i) for i in range(N_IMAGES)])
    train_rows = np.random.default_rng(1).standard_normal(host_table.shape, np.float32)
    return FeatureStore.in_memory(names, np.concatenate([host_table, train_rows]))


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
    from vqa_tpu_torch.datasets.interim import RAW_FILES
    from vqa_tpu_torch.engine import engine as engine_lib
    from vqa_tpu_torch.engine.checkpoint import CheckpointManager
    from vqa_tpu_torch.engine.steps import make_eval_step
    from vqa_tpu_torch.ops.gather import gather_rows
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
    key = data_factory.place_store(opt.coco.dir, opt.coco.arch, opt.coco.mode,
                                   _cli_store(host_table))
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
                     "optim.eval_batch_size=1024", "engine.dtype=bfloat16"]:
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
                         "optim.eval_batch_size=1024", "engine.dtype=bfloat16"]:
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
        # the answers at each row's top logit: where bf16 logits tie, the
        # step's argmax takes the first and the Predictor's argsort of the
        # probabilities (utils/decode.py, as vqa_tpu's) any of them
        with torch.inference_mode():
            logits = predictor.model(gather_rows(table, val_set.image_index[rows]), q,
                                     lengths).float().cpu()
        tops = [{val_set.vocabs.aid_to_ans[a] for a in torch.nonzero(row == row.max()).flatten()
                 .tolist()} for row in logits]
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
    ties = sum(len(top) > 1 for top in tops)
    _require(all(x in top and y in top for x, y, top in zip(served, stepped, tops)),
             f"the Predictor from A's best checkpoint answers {TRAIN_CLI_SERVED} questions as "
             f"the eval step does (an answer of the row's top logit, {ties} rows tied): "
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
           served=TRAIN_CLI_SERVED, served_equal_eval_step=True, served_tied_rows=ties,
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
                     "optim.eval_batch_size=1024", "engine.dtype=bfloat16"]:
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


# -------------------------------------------------------- fixture matrix

# [fixture_matrix]: every graded config trained, evaluated and scored through
# the port's train CLI on the synthetic fixture (vqa_tpu_torch.tools.
# fixture_matrix: its CONFIGS at the JAX tool's dims, 24 images and 200
# questions a split, seed 5, batch 16, lr 0.003), the table on the card
# (engine.device_features=true, so the gather is the card's; it changes no
# number the run computes), features in memory (no h5py on the card's
# machine). A config learns when its best val acc1 beats always answering the
# val split's most frequent answer.
MATRIX_EPOCHS = 6
MATRIX_TABLE = "engine.device_features=true"
# the MFB family's bf16 rows are reported beside their float32 rows, not held
# (their signed square root magnifies bf16 rounding in the grads, SIGNED_SQRT_ARCHS)
MATRIX_BF16_UNHELD = ("mfb_coatt", "mfh_coatt")
# the port's own CPU run of the tool, float32, 6 epochs (python -m
# vqa_tpu_torch.tools.fixture_matrix --platform cpu, on an 8-core x86 host):
# config -> (best val acc1 %, scorer overall)
MATRIX_CPU = {"concat_att": (30.0, 30.4), "mlb_att": (22.0, 22.8), "mutan_att": (31.5, 32.4),
              "mfb_coatt": (24.0, 24.8), "mfh_coatt": (24.5, 25.7), "cor": (22.0, 23.1),
              "mlb_noatt": (22.5, 23.2), "mutan_noatt": (21.0, 21.8)}
# (d) card against host, every dropout 0, float32, 2 epochs: each epoch's train
# loss within MATRIX_HOST_LOSS_REL relative of the host's, the last epoch's
# val answers agreeing on MATRIX_HOST_AGREE. Both runs take the same init
# (weights.init_params draws on the host), shuffle and batches; they differ
# in the order of float32 sums (cuBLAS against the host's BLAS, the kernels'
# 3xTF32 products) carried through 24 adam steps
MATRIX_HOST_CONFIGS = ("mutan_att", "mfb_coatt", "cor")
MATRIX_HOST_EPOCHS = 2
MATRIX_HOST_LOSS_REL = 1e-3
MATRIX_HOST_AGREE = 0.97
# MFBCoAtt's training does not reproduce across summation orders: its signed
# square root (derivative 0.5 / sqrt(|p|)) magnifies the rounding of pooled
# values near 0 in every grad upstream of a pool, and 24 adam steps at lr
# 0.003 carry that into the weights. Set from the first card reading (NVIDIA
# H100 80GB HBM3, 700 W): the card's epoch losses 4.1e-3 and 9.3e-3 from the
# host's, answers agreeing on 0.69, where the host's own float32 run sat
# 4.8e-3 and 1.1e-2 from the same run in float64, answers agreeing on 0.84
# (this phase's float64 run on the card's host; the card's float32 run sat
# 6.6e-4 and 1.9e-3 from it). Held at about twice the card's reading; the
# float64 run is repeated and printed beside it each time
MATRIX_HOST_WIDE = {"mfb_coatt": (2e-2, 0.5)}  # config -> (loss rel, answer agreement)
# (e) full width: a bench-scale fixture (1024 images and 16,384 questions in
# each of train and val), mutan_att.yaml as written but for batch 512
MATRIX_FULL = {"n_images": 1024, "n_questions": 16384, "seed": 0, "splits": ("train", "val")}
MATRIX_FULL_BATCH = 512
MATRIX_FULL_EPOCHS = 3
MATRIX_FULL_FLOOR = 0.60
# (f) MutanAtt on the other layouts' fixtures
MATRIX_LAYOUTS = ("VQA", "COCOQA", "TDIUC")
MATRIX_LAYOUT_EPOCHS = 3
# (g) --profile_dir: each launched kernel's __global__ function(s) in csrc/,
# looked for among the trace's CUDA kernel events
MATRIX_TRACED = ("mutan_att", "mfb_coatt")
TRACE_KERNELS = {
    "gather_rows": ("gather_rows_kernel",),
    "gather_rows_dequant": ("gather_dequant_kernel", "gather_dequant_any"),
    "lstm_seq": ("lstm_seq_kernel", "lstm_f32_kernel"),
    "glimpse_head": ("glimpse_kernel", "glimpse_parent_kernel", "glimpse_f32_kernel",
                     "glimpse_split_kernel", "merge_kernel", "glimpse_tc_logits_kernel",
                     "glimpse_tc_sum_kernel", "glimpse_tc_merge_kernel"),
    "glimpse_attend": ("glimpse_kernel", "glimpse_parent_kernel", "glimpse_f32_kernel",
                       "glimpse_split_kernel", "merge_kernel", "glimpse_tc_logits_kernel",
                       "glimpse_tc_sum_kernel", "glimpse_tc_merge_kernel"),
    "mfb_pool": ("mfb_pool_kernel",),
    "relation_attend": ("relation_element_kernel", "relation_tiled_kernel",
                        "relation_wide_kernel", "tc_scores_kernel", "tc_sum_kernel"),
}


def _matrix_kernels(name: str, int8: bool = False) -> set:
    """The kernels the arch of options/vqa2/<name>.yaml launches."""
    (kernels,) = [k for n, k in ARCHS.values() if n == name]
    return {"gather_rows_dequant" if int8 and k == "gather_rows" else k for k in kernels}


def _accuracy_md_rows() -> dict:
    """ACCURACY.md's first table (the JAX tool's CPU run): config -> (acc1, scorer)."""
    rows = {}
    with open(os.path.join(_REPO, "ACCURACY.md")) as f:
        for line in f:
            if line.startswith("## "):
                break
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) == 3 and cells[0] in MATRIX_CPU:
                rows[cells[0]] = (float(cells[1]), float(cells[2]))
    return rows


def _no_dropout(name: str) -> list:
    """--opt overrides setting every dropout of options/vqa2/<name>.yaml to 0."""
    import dataclasses

    from vqa_tpu_torch.config import load_options

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                yield from walk(value, path + [key])
            elif "dropout" in key and isinstance(value, (int, float)) and value:
                yield ".".join(path + [key]) + "=0.0"

    opt = load_options(os.path.join(_REPO, "options", "vqa2", f"{name}.yaml"), [])
    return list(walk(dataclasses.asdict(opt.model), ["model"]))


def _matrix_run(torch, name, logs, work, epochs, platform=None, opts=(), dataset="VQA2") -> dict:
    """One run_config of the port's matrix tool, its CLI output kept back
    (shown on failure), with its seconds and the kernels it launched."""
    import io

    from vqa_tpu_torch.tools import fixture_matrix

    _reset_counts()
    out = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            run = fixture_matrix.run_config(name, fixture_matrix.CONFIGS[name], logs, work,
                                            epochs, platform, opts, dataset)
        if platform != "cpu":
            torch.cuda.synchronize()
    except BaseException:
        sys.stderr.write(out.getvalue()[-6000:])
        raise
    run["s"] = time.perf_counter() - t
    run["launches"] = {k: c for k, c in _read_counts().items() if c}
    if run["rc"] != 0:
        sys.stderr.write(out.getvalue()[-6000:])
    return run


def _matrix_line(part: str, name: str, run: dict, **fields) -> None:
    _phase("fixture_matrix", part=part, config=name, **fields, rc=run["rc"],
           train_loss=",".join(f"{x:.5f}" for x in run.get("train_loss", [])),
           val_acc1=",".join(f"{100 * a:.1f}" for a in run.get("val_acc1", [])),
           best_acc1=round(100 * run.get("acc1", float("nan")), 2),
           scorer=None if run.get("overall") is None else round(run["overall"], 2),
           s=round(run["s"], 2), launches=run["launches"])


def _learned(run: dict, floor: float, what: str) -> None:
    _require(run["rc"] == 0, f"{what}: the train CLI returns 0: {run['rc']}")
    _require(all(math.isfinite(x) for x in run["train_loss"]), f"{what}: finite train losses")
    _require(run["acc1"] > floor, f"{what}: best val acc1 {run['acc1']} above the majority "
                                  f"answer's rate {floor}")


def _trace_kernel_names(trace_dir: str) -> set:
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    _require(len(files) == 1, f"--profile_dir holds one trace: {os.listdir(trace_dir)}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def _csrc_globals() -> set:
    """The names of the __global__ functions in vqa_tpu_torch/csrc/."""
    import re

    names = set()
    csrc = os.path.join(_REPO, "vqa_tpu_torch", "csrc")
    for src in os.listdir(csrc):
        with open(os.path.join(csrc, src)) as f:
            text = f.read()
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                                r"(\w+)\s*\(", text))
    return names


def _matrix_full_width(torch, tmp: str, logs: str) -> dict:
    """(e): the port's train CLI at mutan_att.yaml's full width (float32, lr
    1e-4, its dropout), batch MATRIX_FULL_BATCH, over the bench-scale
    fixture in memory; each epoch's loss and acc1, the scorer's overall."""
    import io

    from vqa_tpu_torch.cli import train as train_cli
    from vqa_tpu_torch.datasets.factory import drop_stores
    from vqa_tpu_torch.scorer import evaluate_files
    from vqa_tpu_torch.tools import fixture_matrix

    work = os.path.join(tmp, "matrix_full")
    t = time.perf_counter()
    fixture_matrix.make_fixture(work, "memory", **MATRIX_FULL)
    fixture_s = time.perf_counter() - t
    rate = fixture_matrix.majority_rate(work)
    argv = ["--path_opt", os.path.join(_REPO, "options", "vqa2", "mutan_att.yaml"),
            "--dir_logs", logs, "--epochs", str(MATRIX_FULL_EPOCHS), "--print_freq", "0"]
    for o in (f"vqa.dir={work}/vqa2", f"coco.dir={work}/coco", MATRIX_TABLE,
              f"optim.batch_size={MATRIX_FULL_BATCH}"):
        argv += ["--opt", o]
    _reset_counts()
    out = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = train_cli.main(argv)
        torch.cuda.synchronize()
    except BaseException:
        sys.stderr.write(out.getvalue()[-6000:])
        raise
    finally:
        drop_stores(os.path.join(work, "coco"))
    run = {"rc": rc, "s": time.perf_counter() - t,
           "launches": {k: c for k, c in _read_counts().items() if c}}
    if rc == 0:
        with open(os.path.join(logs, "ckpt", "info.json")) as f:
            info = json.load(f)
        results = os.path.join(logs, "results",
                               f"vqa_OpenEnded_val_epoch{info['best']}_results.json")
        ann = os.path.join(work, "vqa2", "raw", "v2_mscoco_val2014_annotations.json")
        run.update(acc1=info["best_acc"], overall=evaluate_files(results, ann)["overall"],
                   **fixture_matrix.history(logs))
    else:
        sys.stderr.write(out.getvalue()[-6000:])
    _matrix_line("e", "mutan_att", run, width="full", batch=MATRIX_FULL_BATCH,
                 fixture_s=round(fixture_s, 2), majority_rate=rate, floor=MATRIX_FULL_FLOOR)
    torch.cuda.empty_cache()
    return run


@contextlib.contextmanager
def _float64_allowed():
    """engine.dtype=float64 accepted for a host reference run."""
    from vqa_tpu_torch import config

    saved = config.COMPUTE_DTYPES
    config.COMPUTE_DTYPES = saved + ("float64",)
    try:
        yield
    finally:
        config.COMPUTE_DTYPES = saved


def _card_against_host(torch, name: str, work: str, logs: str, count) -> None:
    """(d): ``name`` trained on the card and on the host, float32, dropout
    off, the same seed; each epoch's train loss and the last epoch's val
    answers held to the host's (MATRIX_HOST_LOSS_REL, MATRIX_HOST_AGREE, or
    MATRIX_HOST_WIDE's bound with a host float64 run beside it)."""
    loss_tol, agree_floor = MATRIX_HOST_WIDE.get(name, (MATRIX_HOST_LOSS_REL, MATRIX_HOST_AGREE))
    runs = {}
    for where, platform, dtype in (("card", None, "float32"), ("host", "cpu", "float32"),
                                   ("host_f64", "cpu", "float64")):
        if where == "host_f64" and name not in MATRIX_HOST_WIDE:
            continue
        with _float64_allowed():
            runs[where] = _matrix_run(torch, name, os.path.join(logs, f"{name}_{where}"), work,
                                      MATRIX_HOST_EPOCHS, platform,
                                      (MATRIX_TABLE, f"engine.dtype={dtype}", *_no_dropout(name)))
        _require(runs[where]["rc"] == 0, f"(d) {name} on the {where}: rc 0")
    count(runs["card"])
    answers = {}
    for where, run in runs.items():
        last = os.path.join(os.path.dirname(run["results"]),
                            f"vqa_OpenEnded_val_epoch{MATRIX_HOST_EPOCHS - 1}_results.json")
        with open(last) as f:
            answers[where] = {r["question_id"]: r["answer"] for r in json.load(f)}

    def apart(a, b):
        rel = [abs(x - y) / abs(y) for x, y in zip(runs[a]["train_loss"], runs[b]["train_loss"])]
        agree = float(np.mean([answers[a][q] == v for q, v in answers[b].items()]))
        return rel, agree

    rel, agree = apart("card", "host")
    extra = {}
    if "host_f64" in runs:
        f64_rel, f64_agree = apart("host", "host_f64")
        extra = dict(host_vs_f64_loss_rel=",".join(f"{x:.3e}" for x in f64_rel),
                     host_vs_f64_agree=round(f64_agree, 4),
                     f64_loss=",".join(f"{x:.7f}" for x in runs["host_f64"]["train_loss"]))
    _phase("fixture_matrix", part="d", config=name, dropout=0.0,
           card_loss=",".join(f"{x:.7f}" for x in runs["card"]["train_loss"]),
           host_loss=",".join(f"{x:.7f}" for x in runs["host"]["train_loss"]),
           loss_rel=",".join(f"{x:.3e}" for x in rel), loss_tol=loss_tol,
           card_acc1=",".join(f"{100 * a:.1f}" for a in runs["card"]["val_acc1"]),
           host_acc1=",".join(f"{100 * a:.1f}" for a in runs["host"]["val_acc1"]),
           answers_agree=round(agree, 4), agree_floor=agree_floor, **extra,
           card_scorer=round(runs["card"]["overall"], 2),
           host_scorer=round(runs["host"]["overall"], 2),
           card_s=round(runs["card"]["s"], 2), host_s=round(runs["host"]["s"], 2),
           launches=runs["card"]["launches"])
    _require(len(rel) == MATRIX_HOST_EPOCHS and max(rel) <= loss_tol,
             f"(d) {name}: each epoch's train loss within {loss_tol} of the host's: {rel}")
    _require(agree >= agree_floor, f"(d) {name}: val answers agree with the host's on {agree}")


def _fixture_matrix_phase(torch, card: str, tmp: str) -> dict:
    """[fixture_matrix] (a)-(g): see the constants above; returns the launch
    counts of the card's runs."""
    import re

    from vqa_tpu_torch.datasets.factory import drop_stores
    from vqa_tpu_torch.tools import fixture_matrix

    t_phase = time.perf_counter()
    counts = dict.fromkeys(_counters(), 0)

    def count(run):
        for k, c in run["launches"].items():
            counts[k] += c

    work = os.path.join(tmp, "matrix")
    t = time.perf_counter()
    fixture_matrix.make_fixture(work, "memory")
    floor = fixture_matrix.majority_rate(work)
    jax_rows = _accuracy_md_rows()
    _require(set(jax_rows) == set(fixture_matrix.CONFIGS), f"ACCURACY.md's rows: {jax_rows}")
    _phase("fixture_matrix", part="fixture", **fixture_matrix.FIXTURE, features="memory",
           majority_rate=floor, s=round(time.perf_counter() - t, 2))
    logs = os.path.join(tmp, "matrix_logs")
    try:
        # (a) float32 as the YAMLs are written, (b) bf16
        for dtype, opts in (("float32", ()), ("bfloat16", ("engine.dtype=bfloat16",))):
            for name in fixture_matrix.CONFIGS:
                run = _matrix_run(torch, name, os.path.join(logs, f"{name}_{dtype}"), work,
                                  MATRIX_EPOCHS, opts=(MATRIX_TABLE,) + opts)
                count(run)
                part = "a" if dtype == "float32" else "b"
                held = dtype == "float32" or name not in MATRIX_BF16_UNHELD
                _matrix_line(part, name, run, dtype=dtype, held=held,
                             cpu_float32=MATRIX_CPU[name], jax_accuracy_md=jax_rows[name])
                if held:
                    _learned(run, floor, f"({part}) {name} {dtype}")
                else:
                    _require(run["rc"] == 0, f"({part}) {name} {dtype}: rc 0: {run['rc']}")
                _require(set(run["launches"]) == _matrix_kernels(name),
                         f"({part}) {name} {dtype} launched its arch's kernels "
                         f"{_matrix_kernels(name)}: {run['launches']}")
        # (c) the feature table in bfloat16 against int8 (gather_rows_dequant)
        for name in fixture_matrix.CONFIGS:
            overall = {}
            for fdt in fixture_matrix.INT8_DTYPES:
                run = _matrix_run(torch, name, os.path.join(logs, f"{name}_table_{fdt}"), work,
                                  MATRIX_EPOCHS, opts=(MATRIX_TABLE,
                                                       f"engine.features_dtype={fdt}"))
                count(run)
                overall[fdt] = run.get("overall")
                _matrix_line("c", name, run, features_dtype=fdt)
                _learned(run, floor, f"(c) {name} features_dtype={fdt}")
                _require(set(run["launches"]) == _matrix_kernels(name, fdt == "int8"),
                         f"(c) {name} {fdt} launched {_matrix_kernels(name, fdt == 'int8')}: "
                         f"{run['launches']}")
            _phase("fixture_matrix", part="c", config=name,
                   scorer_bf16=round(overall["bfloat16"], 2),
                   scorer_int8=round(overall["int8"], 2),
                   delta=round(overall["int8"] - overall["bfloat16"], 2))
        # (d) the card against the host, every dropout 0
        for name in MATRIX_HOST_CONFIGS:
            _card_against_host(torch, name, work, logs, count)
        # (f) MutanAtt on the VQA v1, COCO-QA and TDIUC layouts
        for dataset in MATRIX_LAYOUTS:
            wd = os.path.join(tmp, f"matrix_{dataset.lower()}")
            fixture_matrix.make_fixture(wd, "memory", dataset=dataset)
            rate = fixture_matrix.majority_rate(wd, dataset)
            try:
                run = _matrix_run(torch, "mutan_att", os.path.join(logs, f"layout_{dataset}"),
                                  wd, MATRIX_LAYOUT_EPOCHS, opts=(MATRIX_TABLE,), dataset=dataset)
            finally:
                drop_stores(os.path.join(wd, "coco"))
            count(run)
            _matrix_line("f", "mutan_att", run, dataset=dataset, majority_rate=rate)
            _learned(run, rate, f"(f) MutanAtt on {dataset}")
        # (g) --profile_dir: the trace names every kernel the run launched
        globals_ = _csrc_globals()
        _require(all(set(names) <= globals_ for names in TRACE_KERNELS.values()),
                 f"TRACE_KERNELS names __global__ functions of csrc/: {sorted(globals_)}")
        for name in MATRIX_TRACED:
            trace_dir = os.path.join(tmp, f"trace_{name}")
            run = _matrix_run(torch, name, os.path.join(logs, f"{name}_traced"), work, 1,
                              opts=(MATRIX_TABLE, f"engine.profile_dir={trace_dir}"))
            count(run)
            _require(run["rc"] == 0, f"(g) {name} with --profile_dir: rc 0")
            traced = _trace_kernel_names(trace_dir)
            found = {k: sorted({n for n in TRACE_KERNELS[k] for e in traced
                                if re.search(rf"\b{n}\b", e)}) for k in run["launches"]}
            _matrix_line("g", name, run, trace_kernel_events=len(traced), found=found)
            _require(all(found.values()), f"(g) {name}: every launched kernel in the trace under "
                                          f"its __global__ name: {found}")
    finally:
        drop_stores(os.path.join(work, "coco"))

    # (e) full width: mutan_att.yaml over a bench-scale fixture
    run = _matrix_full_width(torch, tmp, os.path.join(logs, "full"))
    count(run)
    _require(run["rc"] == 0, f"(e) full-width MutanAtt: rc 0: {run['rc']}")
    _require(run["acc1"] >= MATRIX_FULL_FLOOR,
             f"(e) full-width MutanAtt: best val acc1 {run['acc1']} >= {MATRIX_FULL_FLOOR}")
    _require(set(run["launches"]) == _matrix_kernels("mutan_att"),
             f"(e) launched MutanAtt's kernels: {run['launches']}")
    torch.cuda.empty_cache()
    _phase("fixture_matrix", part="total", card=card, s=round(time.perf_counter() - t_phase, 2),
           launches={k: c for k, c in counts.items() if c})
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

    opt = load_options(os.path.join(_REPO, "options", "vqa2", "cor.yaml"),
                       data + ["engine.dtype=bfloat16"])
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
            Predictor.from_run(runs[arch], resume="best", device="cpu",
                               overrides=["engine.dtype=float32"]), question, image)
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


# ------------------------------------------------------- the float32 path


def _f32_batches(torch, dev, questions, lengths, image_index, n_batches, batch, num_answers):
    """``n_batches`` eval batches of ``batch`` questions, sorted by length
    and cut at the bucket each needs (as the eval loader buckets them)."""
    order = np.argsort(lengths[:n_batches * batch], kind="stable")
    answers = np.random.default_rng(2).integers(0, num_answers, len(order)).astype(np.int64)
    out = []
    for i in range(n_batches):
        sl = order[i * batch:(i + 1) * batch]
        t_b = next(b for b in BUCKETS if b >= lengths[sl].max())
        out.append({"question": torch.from_numpy(questions[sl, :t_b]).to(dev),
                    "length": torch.from_numpy(lengths[sl]).to(dev),
                    "image_index": image_index[sl],
                    "answer": torch.from_numpy(answers[sl]).to(dev)})
    return out


def _f32_logits_hold(torch, arch, model, batches, features, kernels) -> dict:
    """One eval pass of ``model`` (float32) through the kernels, its launch
    counts, and its logits and answers against the plain float32 path on
    the same batches: within F32_LOGITS_REL of the max-abs, answers agreeing
    on F32_AGREE_FLOOR; both passes timed."""
    from vqa_tpu_torch.engine import steps

    eval_step = steps.make_eval_step()

    def logits_pass():
        with torch.inference_mode():
            out = [model(steps._resolve_visual(b, features), b["question"], b["length"])
                   for b in batches]
        torch.cuda.synchronize()
        return out

    def step_pass():
        out = [eval_step(model, b, features) for b in batches]
        torch.cuda.synchronize()
        return out

    _reset_counts()
    step_pass()
    counts = _read_counts()
    _require({k for k, c in counts.items() if c} == set(kernels),
             f"[f32_path] {arch}: the float32 eval step launched exactly {kernels}: {counts}")
    got = logits_pass()
    t0 = time.perf_counter()
    step_pass()
    kernel_s = time.perf_counter() - t0
    with _plain_ops(torch):
        want = logits_pass()
        step_pass()
        t0 = time.perf_counter()
        step_pass()
        plain_s = time.perf_counter() - t0
    got, want = torch.cat(got), torch.cat(want)
    _require(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
             f"[f32_path] {arch}: finite float32 logits")
    err = _rel_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    _require(err <= F32_LOGITS_REL and agree >= F32_AGREE_FLOOR,
             f"[f32_path] {arch}: logits within {F32_LOGITS_REL} of the plain float32 path's "
             f"max-abs ({err}), answers agreeing on {agree} >= {F32_AGREE_FLOOR}")
    n = sum(len(b["length"]) for b in batches)
    return dict(launches={k: c for k, c in counts.items() if c}, logits_rel_err=f"{err:.3e}",
                tol=F32_LOGITS_REL, pred_agree=round(agree, 5), floor=F32_AGREE_FLOOR,
                kernel_pass_s=round(kernel_s, 4), plain_pass_s=round(plain_s, 4),
                kernel_qa_per_s=round(n / kernel_s, 1), plain_qa_per_s=round(n / plain_s, 1),
                counts=counts)


def _f32_eval_phase(torch, dev, eval_data, host_table) -> dict:
    """[f32_path], eval: MutanAtt as mutan_att.yaml is written (float32) at
    full width through the eval step over the float32 table on the card,
    and one CoR eval step in float32 over a 196-region table; returns the
    launch counts."""
    from vqa_tpu_torch.flagship import answer_count, build_config
    from vqa_tpu_torch.weights import random_params

    questions, lengths, image_index = eval_data
    counts = dict.fromkeys(_counters(), 0)
    table = torch.from_numpy(host_table).to(dev)  # float32, as features_dtype float32 places it
    model = build_config("mutan_att", dtype=torch.float32, device=dev)
    random_params(model, seed=0)
    batches = _f32_batches(torch, dev, questions, lengths, image_index, F32_EVAL_BATCHES, BATCH,
                           answer_count("mutan_att"))
    held = _f32_logits_hold(torch, "MutanAtt", model, batches, table, CLI_KERNELS)
    for k, c in held.pop("counts").items():
        counts[k] += c
    _phase("f32_path", part="eval_step", arch="MutanAtt", dtype="float32", batch=BATCH,
           batches=F32_EVAL_BATCHES, buckets=[b["question"].shape[1] for b in batches], **held)
    del model, table
    torch.cuda.empty_cache()

    # CoR over the 196-region grid, at the serving batch
    grid = torch.randn(SERVE_BATCH, GRID, DIM, device=dev)
    model = build_config("cor", dtype=torch.float32, device=dev)
    random_params(model, seed=0)
    image_index = np.arange(SERVE_BATCH, dtype=np.int32)
    batches = _f32_batches(torch, dev, questions, lengths, image_index, 1, SERVE_BATCH,
                           answer_count("cor"))
    held = _f32_logits_hold(torch, "CoR", model, batches, grid,
                            ("gather_rows", "lstm_seq", "relation_attend"))
    for k, c in held.pop("counts").items():
        counts[k] += c
    _phase("f32_path", part="eval_step", arch="CoR", dtype="float32", batch=SERVE_BATCH,
           regions=GRID, **held)
    del model, grid
    torch.cuda.empty_cache()
    return counts


def _f32_train_phase(torch, dev, host_table) -> dict:
    """[f32_path], train: one float32 train step of MutanAtt and of MFBCoAtt
    (their YAMLs as written) at full width and batch 128, and of MutanAtt
    at batch 1024 (the shortest questions of 4096: bucket 7), dropout off,
    through the kernels against the plain float32 path on the same weights
    and batch: the loss within F32_LOSS_REL relative, each grad within
    F32_GRAD_REL (relative, Frobenius; a leaf's norm under 1e-3 of the
    global norm measured against that floor). A grad past it is held
    against the plain path in float64 instead, as mfb_pool's entry is: the
    kernel path's error no more than twice the plain float32 path's (the
    signed square root's derivative magnifies the rounding of pooled values
    near 0). Returns the launch counts."""
    from vqa_tpu_torch.config import compute_dtype, load_options
    from vqa_tpu_torch.flagship import NUM_WORDS, answer_count, model_options
    from vqa_tpu_torch.models.factory import factory
    from vqa_tpu_torch.ops.lstm import lstm_plan
    from vqa_tpu_torch.weights import random_params

    counts = dict.fromkeys(_counters(), 0)
    table = torch.from_numpy(host_table).to(dev)
    rng = np.random.default_rng(3)
    for arch, name, batch_size in F32_TRAIN_CASES:
        opt = load_options(os.path.join(_REPO, "options", "vqa2", f"{name}.yaml"))
        _require(compute_dtype(opt) == torch.float32 and opt.optim.batch_size == TRAIN_BATCH,
                 f"{name}.yaml as written trains in float32 at batch {TRAIN_BATCH}")
        model_opt = model_options(name=name)
        model = factory(model_opt, NUM_WORDS, answer_count(name), dtype=torch.float32,
                        device=dev, train=True)
        random_params(model, seed=0)
        lstm_wg = lstm_plan(batch_size, model_opt["seq2vec"]["hidden_size"], elem=4)["wg"]
        _require(lstm_wg == (2 if batch_size == BATCH else 1),
                 f"[f32_path] {arch} at batch {batch_size}: lstm_seq's class wg={lstm_wg}")
        pool = batch_size if batch_size == TRAIN_BATCH else 4 * batch_size
        questions, lengths, image_index, _ = _synthetic_eval_arrays(rng, pool, with_table=False)
        batch = _f32_batches(torch, dev, questions, lengths, image_index, pool // batch_size,
                             batch_size, answer_count(name))[0]  # the shortest questions
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        _reset_counts()
        loss, grads, gnorm = _loss_grads(torch, model, batch, table)
        torch.cuda.synchronize()
        step_counts = _read_counts()
        want = _step_launches(arch)
        _require({k: c for k, c in step_counts.items() if c} == want,
                 f"[f32_path] {arch}: a float32 train step launches {want}: {step_counts}")
        for k, c in step_counts.items():
            counts[k] += c
        plain_loss, plain_grads, plain_gnorm = _loss_grads(torch, model, batch, table, plain=True)

        def rel(g, w, floor):
            return float((g.double() - w.double()).norm()) / max(float(w.double().norm()), floor)

        floor = TRAIN_GRAD_FLOOR * plain_gnorm
        errs = {n: rel(g, p, floor) for n, g, p in zip(names, grads, plain_grads)
                if not n.endswith(SOFTMAX_BLIND)}
        blind = {n: max(float(g.norm()), float(p.norm())) / plain_gnorm
                 for n, g, p in zip(names, grads, plain_grads) if n.endswith(SOFTMAX_BLIND)}
        over = {n: e for n, e in errs.items() if e > F32_GRAD_REL}
        exact_held = {}
        if over:
            dtypes = {m: m.dtype for m in model.modules() if hasattr(m, "dtype")}
            for m in dtypes:
                m.dtype = torch.float64
            try:
                _, f64_grads, f64_gnorm = _loss_grads(torch, model, batch, table, plain=True)
            finally:
                for m, dt in dtypes.items():
                    m.dtype = dt
            f64_floor = TRAIN_GRAD_FLOOR * f64_gnorm
            for n, g, p, e in zip(names, grads, plain_grads, f64_grads):
                if n in over:
                    exact_held[n] = (over[n], rel(g, e, f64_floor), rel(p, e, f64_floor))
            _require(all(ke <= max(F32_GRAD_REL, 2 * pe) for _, ke, pe in exact_held.values()),
                     f"[f32_path] {arch}: grads past {F32_GRAD_REL} of the plain float32 path "
                     f"are no further from float64 than twice the plain path's own error "
                     f"(kernel-plain, kernel-f64, plain-f64): {exact_held}")
        held = {n: e for n, e in errs.items() if n not in exact_held} or {"none": 0.0}
        worst = max(held, key=held.get)
        loss_err = abs(loss - plain_loss) / abs(plain_loss)
        _require(math.isfinite(loss) and loss_err <= F32_LOSS_REL,
                 f"[f32_path] {arch}: loss {loss} within {F32_LOSS_REL} of the plain "
                 f"float32 path's {plain_loss}")
        _require(held[worst] <= F32_GRAD_REL and all(z <= TRAIN_GRAD_FLOOR
                                                     for z in blind.values()),
                 f"[f32_path] {arch}: grad {worst} {held[worst]} <= {F32_GRAD_REL}, the "
                 f"softmax-blind biases' grads under {TRAIN_GRAD_FLOOR} of the norm: {blind}")
        _require(all(bool(torch.isfinite(g).all()) for g in grads),
                 f"[f32_path] {arch}: finite grads")
        args = (model, batch, table)
        ms, plain_ms = _in_turns(torch, lambda t, fn: _median_ms(t, fn, iters=5),
                                 lambda: _loss_grads(torch, *args),
                                 lambda: _loss_grads(torch, *args, plain=True))
        line = dict(loss=round(loss, 6), plain_loss=round(plain_loss, 6),
                    loss_rel_err=f"{loss_err:.2e}", loss_tol=F32_LOSS_REL,
                    grad_worst_leaf=worst, grad_worst_rel_err=f"{held[worst]:.2e}",
                    grad_tol=F32_GRAD_REL, grads_held=len(held),
                    gnorm=round(gnorm, 5), plain_gnorm=round(plain_gnorm, 5),
                    fwd_bwd_ms=round(ms, 3), plain_fwd_bwd_ms=round(plain_ms, 3),
                    qa_per_s=round(batch_size / ms * 1e3, 1),
                    plain_qa_per_s=round(batch_size / plain_ms * 1e3, 1), lstm_wg=lstm_wg,
                    launches={k: c for k, c in step_counts.items() if c})
        if exact_held:
            line["held_against_f64"] = {n: "/".join(f"{x:.2e}" for x in e)
                                        for n, e in sorted(exact_held.items())}
        _phase("f32_path", part="train_step", arch=arch, dtype="float32", batch=batch_size,
               T=batch["question"].shape[1], **line)
        del model, grads, plain_grads
        torch.cuda.empty_cache()
    del table
    return counts


def _f32_export(torch, dev, tmp: str, context: dict) -> dict:
    """[f32_path], export: MutanAtt from phase 9's run A at its options'
    engine.dtype set back to float32 (mutan_att.yaml as written), exported
    on the card by save_export and loaded in a fresh interpreter on the
    card: the graph's registered ops, the kernels it launched, its logits
    within F32_EXPORT_REL of the live float32 model's. Returns the launch
    counts of the loaded program."""
    from vqa_tpu_torch.export import save_export
    from vqa_tpu_torch.predictor import Predictor

    pred = Predictor.from_run(context["logs"], resume="best", device=dev,
                              overrides=["engine.dtype=float32"])
    q, lengths = pred.encode_questions(context["questions"])
    visual = pred.table[torch.as_tensor(pred.dataset.index_of(context["images"]))]
    inputs = os.path.join(tmp, "inputs_f32.npz")
    np.savez(inputs, names=np.asarray(context["images"]), visual=visual.numpy(),
             question=q.cpu().numpy(), lengths=lengths.cpu().numpy())
    with torch.inference_mode():
        live = pred.model(visual.to(dev), q, lengths)
    _require(live.dtype == torch.float32, f"the live model computes in float32: {live.dtype}")
    live = live.cpu().numpy()
    out = os.path.join(tmp, "exported", "MutanAtt_f32")
    t = time.perf_counter()
    meta = save_export(out, pred, batch=EXPORT_BATCH)
    export_s = time.perf_counter() - t
    _require(meta["device"] == "cuda" and meta["compute_dtype"] == "float32",
             f"traced on the card in float32: {meta['device']}, {meta['compute_dtype']}")
    logits_path = os.path.join(tmp, "logits_f32.npy")
    proc = subprocess.run([sys.executable, "-c", _LOAD_CHECK, out, inputs, logits_path, "cuda"],
                          cwd=_REPO, capture_output=True, text=True, timeout=600)
    _require(proc.returncode == 0, f"the float32 artifact loads and runs in a fresh interpreter: "
             f"rc {proc.returncode}\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    got = np.load(logits_path)
    expected = EXPORT_OPS["MutanAtt"]
    launched = {k for k, c in report["launches"].items() if c}
    _require(not report["leaked"] and report["device"].startswith("cuda")
             and {op.split("::")[-1] for op in report["ops"]} == set(expected)
             and launched == set(expected),
             f"the float32 program runs on the card with no model code, calls and launches "
             f"exactly {expected}: {report}")
    err = float(np.abs(got - live).max() / max(np.abs(live).max(), 1e-30))
    _require(got.dtype == np.float32 and err <= F32_EXPORT_REL,
             f"the loaded float32 program's logits within {F32_EXPORT_REL} of the live model's "
             f"max-abs: {err}")
    _phase("f32_path", part="export", arch="MutanAtt", dtype="float32", batch=EXPORT_BATCH,
           export_s=round(export_s, 3), load_s=round(report["load_s"], 3),
           forward_s=round(report["forward_s"], 3), bytes=_dir_bytes(out),
           logits_rel_err=f"{err:.3e}", tol=F32_EXPORT_REL,
           launches={k: c for k, c in report["launches"].items() if c})
    del pred
    torch.cuda.empty_cache()
    return report["launches"]


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
            data_factory.place_store(opt.coco.dir, opt.coco.arch, opt.coco.mode,
                                     FeatureStore.in_memory(names, feats))
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
                             "optim.eval_batch_size=1024", "engine.features_dtype=bfloat16",
                             "engine.dtype=bfloat16"]:
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
        data_factory.drop_stores(f"{tmp}/coco")
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


# ---------------------------------------------------------- large shapes

# [large_shapes]: the designs for the shapes past the others' shared memory
# (every shape the JAX package computes), each against its plain version on
# the card in both dtypes, timed; then the path that needs one: the extract
# CLI's function at --size 1792 (a 56 x 56 grid, N = R = 3136) and the eval
# CLI over that table, CoR (each relation core call the tc design) and
# MutanAtt, at a batch that fits; and one forward each, held on its logits
# against the plain path, of CoR in bf16 and float32 and of MutanAtt with
# 24 glimpses (model.attention.nb_glimpses, past alpha [3136, 18] in
# shared memory: glimpse_head's tc design)
LARGE_SIZE = 1792
LARGE_GRID = (LARGE_SIZE // 32) ** 2  # 3136 regions
LARGE_IMAGES = 64
LARGE_BATCH = 64                      # [64, 3136, 1024] pg and r: 411 MB each in bf16
LARGE_VAL_QUESTIONS = 5 * LARGE_BATCH - 19  # the last batch padded
LARGE_TRAIN_QUESTIONS = 4 * LARGE_VAL_QUESTIONS
LARGE_KERNEL_B = 2
LARGE_F32_BATCH = 16                     # the CoR float32 forward's batch
# bf16 holds at these shapes: an output here is a softmax mean over
# thousands of rows (|out| ~ 0.01 at R=16,384), so besides each kernel's
# absolute bound (above) the error stays within 1% of the plain output's
# max-abs: a kernel rounds its output once (<= 2^-8 of it, 0.4%; mfb_pool's
# global design twice, its roots waiting in the bf16 output row: 0.8%),
# and its fp32 sums in another order add far less
BF16_LARGE_REL = 0.01
LARGE_RELATION_N = (LARGE_GRID, 4096)    # D=1024: the tc design, and the split one forced
LARGE_RELATION_WIDE_N = 2048             # the tc, the wide and the split design timed together
# each design's source, where it is not its kernel's SOURCES entry
DESIGN_SOURCES = {("relation_attend", "tc"): "vqa_tpu_torch/csrc/relation_tc.cu",
                  ("glimpse_head", "tc"): "vqa_tpu_torch/csrc/glimpse_tc.cu",
                  ("glimpse_attend", "tc"): "vqa_tpu_torch/csrc/glimpse_tc.cu"}
LARGE_GLIMPSE = ((196, 512), (16_384, 4))  # (R, G) at M=510, D=2048: glimpse groups; chunks
# (B, R, M, G, D), bf16, held and not timed: the tc design's logits kernel
# with 2-byte joint loads (M odd), D past its last 128-column block
LARGE_GLIMPSE_ODD = ((2, LARGE_GRID, 77, 24, 200), (2, 16_384, 509, 4, 136))
LARGE_MFB = ((64, 5, 20_000), (64, 5, 70_000))  # (n, k, m): opted-in shared memory; global
LARGE_GLIMPSES = 24
LARGE_EVAL = {"CoR": ("cor", ("gather_rows", "lstm_seq", "relation_attend")),
              "MutanAtt": ("mutan_att", ("gather_rows", "lstm_seq", "glimpse_head"))}


def _design_counters():
    from vqa_tpu_torch.ops.attention import glimpse_attend, glimpse_head
    from vqa_tpu_torch.ops.mfb_pool import mfb_pool
    from vqa_tpu_torch.ops.relation import relation_attend

    return {"relation_attend": relation_attend, "glimpse_head": glimpse_head,
            "glimpse_attend": glimpse_attend, "mfb_pool": mfb_pool}


def _read_design_counts() -> dict:
    return {name: dict(fn.design_launches) for name, fn in _design_counters().items()}


def _large_record(name, design, err, tol, ms, plain_ms, bound, library_ms, shape, **extra):
    return dict(name=f"{name}/{design}", max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], pct_of_bound=100 * bound[0] / ms,
                library_ms=library_ms, shape=shape, **extra)


def _large_err(torch, got, want, dtype, tol_bf16, tol_f32=F32_REL):
    """(err, tol): bf16 the max-abs error, within ``tol_bf16`` and within
    BF16_LARGE_REL of the plain output's max-abs; float32 relative to the
    plain output's max-abs."""
    if dtype == torch.bfloat16:
        want = want.float()
        return ((got.float() - want).abs().max().item(),
                min(tol_bf16, BF16_LARGE_REL * want.abs().max().item()))
    return _rel_err(got, want), tol_f32


def _enqueue_ms(torch, fn, iters: int = 20) -> float:
    """Median host-clock time to enqueue ``fn`` (the queue drained before
    each call, no sync inside the span): what the host spends on the call,
    its launches included, whatever the card does meanwhile."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _turns(torch, fns, iters: int) -> list:
    """The median CUDA-event time of each of ``fns``, timed in the order
    given and then reversed, each the median of its two turns."""
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for k in order + order[::-1]:
        times[k].append(_median_ms(torch, fns[k], iters=iters, warmup=1))
    return [statistics.median(t) for t in times]


def _glimpse_tc_geometry(torch, attention, dev, B, R, M, G, D, head_plan, attend_plan):
    """The tc plans' copy of csrc/glimpse_tc.cu's layout held against the
    entry's own reckoning: both launches' CTAs, threads and shared memory."""
    keys = ("ctas", "threads", "smem_bytes")
    for m, plan in ((M, head_plan), (0, attend_plan)):
        geo = attention.tc_launch_geometry(B, R, m, G, D, plan, dev.index or 0)
        planned = ({k: plan["logits"][k] for k in keys}, {k: plan[k] for k in keys})
        _require(({k: geo[k] for k in keys}, geo["weighted"]) == planned,
                 f"[large_shapes] glimpse tc {(B, R, m, G, D)}: the entry's geometry "
                 f"{geo} is the plan's {planned}")


def _glimpse_tc_odd(torch, attention, dev, card: str, B, R, M, G, D) -> None:
    """[large_shapes]: the tc design at a bf16 shape of LARGE_GLIMPSE_ODD
    through the wrappers, held against plain (a row masked past its middle
    and one whole), finite, bit-equal across two calls; not timed."""
    from vqa_tpu_torch.ops.attention import (glimpse_attend, glimpse_attend_reference,
                                             glimpse_head, glimpse_head_reference, glimpse_plan)

    dtype = torch.bfloat16
    joint = torch.tanh(torch.randn(B, R, M, device=dev)).to(dtype)
    w = (torch.randn(M, G, device=dev) / M ** 0.5).to(dtype)
    b = (0.1 * torch.randn(G, device=dev)).to(dtype)
    v = torch.randn(B, R, D, device=dev).to(dtype)
    plans = (glimpse_plan(B, R, M, G, D), glimpse_plan(B, R, 0, G, D))
    _require(plans[0]["copy"] == plans[1]["copy"] == "tc",
             f"[large_shapes] glimpse {(B, R, M, G, D)} bf16: the tc design, got "
             f"{[p['copy'] for p in plans]}")
    _glimpse_tc_geometry(torch, attention, dev, B, R, M, G, D, *plans)
    before = (glimpse_head.design_launches["tc"], glimpse_attend.design_launches["tc"])
    (att, logits), (att2, logits2) = glimpse_head(joint, w, b, v), glimpse_head(joint, w, b, v)
    masked = logits.clone()
    masked[0, R // 2:] = torch.finfo(dtype).min
    masked[1] = torch.finfo(dtype).min
    got, again = glimpse_attend(masked, v), glimpse_attend(masked, v)
    ref_att, ref_logits = glimpse_head_reference(joint.float(), w.float(), b.float(), v.float())
    want = glimpse_attend_reference(masked.float(), v.float())
    torch.cuda.synchronize()
    errs = {"head": _large_err(torch, att, ref_att, dtype, GLIMPSE_ATOL),
            "logits": _large_err(torch, logits, ref_logits, dtype, GLIMPSE_ATOL),
            "attend": _large_err(torch, got, want, dtype, GLIMPSE_ATOL)}
    launched = (glimpse_head.design_launches["tc"] - before[0],
                glimpse_attend.design_launches["tc"] - before[1])
    _require(all(e <= t for e, t in errs.values()) and launched == (2, 2)
             and bool(torch.isfinite(got).all()) and torch.equal(got, again)
             and torch.equal(att, att2) and torch.equal(logits, logits2),
             f"[large_shapes] glimpse tc {(B, R, M, G, D)} bf16: (err, tol) {errs}, tc launches "
             f"{launched} == (2, 2), finite, bit-equal across two calls")
    _phase("large_shapes", kernel="glimpse_head", card=card, part="tc_odd_shape",
           shape=f"B={B} R={R} M={M} G={G} D={D} bf16", chunks=plans[0]["chunks"],
           **{f"{k}_err": round(e, 8) for k, (e, _) in errs.items()},
           **{f"{k}_tol": round(t, 8) for k, (_, t) in errs.items()}, bit_equal=True)


def _large_kernels(torch, dev, card: str) -> list:
    """[large_shapes], kernels: each new design against its plain version on
    the card, in bf16 and float32, timed in turns with it (CUDA events),
    beside its bound; returns their records."""
    import torch.nn.functional as F

    from vqa_tpu_torch.ops import lstm, relation
    from vqa_tpu_torch.ops import attention
    from vqa_tpu_torch.ops.attention import (glimpse_attend, glimpse_attend_reference,
                                             glimpse_head, glimpse_head_reference, glimpse_plan,
                                             launch_glimpse_attend, launch_glimpse_head)
    from vqa_tpu_torch.ops.mfb_pool import mfb_plan, mfb_pool, mfb_pool_reference
    from vqa_tpu_torch.ops.relation import (launch_geometry, launch_relation_attend,
                                            relation_attend, relation_attend_reference,
                                            relation_plan)

    def timed(kernel, plain, iters=5):
        return _in_turns(torch, lambda t, fn: _median_ms(t, fn, iters=iters, warmup=1),
                         kernel, plain)

    records = []
    D = 1024
    for dtype in (torch.bfloat16, torch.float32):
        elem, tag = dtype.itemsize, "bf16" if dtype == torch.bfloat16 else "float32"
        path_b = LARGE_BATCH if elem == 2 else LARGE_F32_BATCH  # the path's batch this type
        # relation_attend: the tc design (the default) and the split one
        # (forced) at N = 3136 and 4096, and at the path's [B, 3136, 1024]
        relation_shapes = [(LARGE_KERNEL_B, N) for N in LARGE_RELATION_N] + [(path_b, LARGE_GRID)]
        relation_records = []
        for B, N in relation_shapes:
            pg = torch.tanh(torch.randn(B, N, D, device=dev)).to(dtype)
            r = torch.tanh(torch.randn(B, N, D, device=dev)).to(dtype)
            plans = {"tc": relation_plan(B, N, D, elem=elem),
                     "split": relation_plan(B, N, D, elem=elem, design="split")}
            want = relation_attend_reference(pg.float(), r.float())
            # two calls of each: the wrapper's (tc), the forced plan's (split)
            outs = {"tc": (relation_attend(pg, r), relation_attend(pg, r)),
                    "split": (torch.empty_like(pg), torch.empty_like(pg))}
            for o in outs["split"]:
                launch_relation_attend(pg, r, o, plans["split"])
            torch.cuda.synchronize()
            # the entry's own reckoning of its two launches against the plan's
            geometry = launch_geometry(B, N, D, plans["tc"], True, dev.index or 0, elem=elem)
            _require(geometry == {k: plans["tc"][k] for k in geometry},
                     f"[large_shapes] relation_attend {(B, N, D)} {tag}: the tc entry launches "
                     f"the plan's geometry ({geometry} vs {plans['tc']})")
            held = {}
            for design, plan in plans.items():
                err, tol = _large_err(torch, outs[design][0], want, dtype, RELATION_ATOL)
                held[design] = err
                _require(plan["design"] == design and err <= tol
                         and torch.equal(outs[design][0], outs[design][1]),
                         f"[large_shapes] relation_attend {(B, N, D)} {tag}: the {design} design "
                         f"({plan['design']}), err {err} <= {tol}, bit-equal across two calls")
            tc_ms, split_ms, plain, library = _turns(
                torch, [lambda: relation_attend(pg, r),
                        lambda: launch_relation_attend(pg, r, outs["split"][0], plans["split"]),
                        lambda: relation_attend_reference(pg, r),
                        lambda: F.scaled_dot_product_attention(pg, r, r)], iters=5)
            bound = (_bound(2 * 3 * B * N * D, 2.0 * 2 * B * N * N * D) if elem == 2
                     else _relation_f32_bounds(B, N, D)[0])
            fp32_fma = _bound(elem * 3 * B * N * D, 2.0 * 2 * B * N * N * D, PEAK_FP32)[0]
            shape = f"B={B} N={N} D={D} {tag}"
            # the tc design's two launches apart, over one scratch (the
            # scores' launch, timed first, leaves it for the weighted sum's)
            scratch, tc_out = relation.tc_scratch(pg, plans["tc"]), torch.empty_like(pg)
            scores_ms, sum_ms = _turns(
                torch, [lambda w=w: relation._launch_tc(pg, r, tc_out, plans["tc"], (w,), scratch)
                        for w in (0, 1)], iters=5)
            for design, ms, other in (("tc", tc_ms, dict(split_ms=split_ms)),
                                      ("split", split_ms, dict(tc_ms=tc_ms))):
                plan = plans[design]
                extra = (dict(chunks=plan["chunks"]) if design == "split" else
                         dict(slices=plan["slices"], scratch_bytes=plan["scratch_bytes"],
                              scores_ms=scores_ms, sum_ms=sum_ms))
                rec = _large_record("relation_attend", design, held[design], tol, ms, plain, bound,
                                    library, shape, bound_fp32_fma_ms=fp32_fma, bit_equal=True,
                                    vs_sdpa=ms / library, **other, **extra)
                records.append(rec)
                relation_records.append(rec)
                _phase("large_shapes", kernel="relation_attend", card=card,
                       **{k: (round(x, 6) if isinstance(x, float) else x) for k, x in rec.items()})
            del pg, r, outs, want, scratch, tc_out
        # the tc design against the wide one (and the split one) where the
        # wide one fits (N = 2048)
        B, N = LARGE_KERNEL_B, LARGE_RELATION_WIDE_N
        pg = torch.tanh(torch.randn(B, N, D, device=dev)).to(dtype)
        r = torch.tanh(torch.randn(B, N, D, device=dev)).to(dtype)
        want = relation_attend_reference(pg.float(), r.float())
        outs, plans = {}, {"tc": relation_plan(B, N, D, elem=elem),
                           "wide": relation_plan(B, N, D, elem=elem, design="wide"),
                           "split": relation_plan(B, N, D, elem=elem, design="split", split=2)}
        for design, plan in plans.items():
            outs[design] = torch.empty_like(pg)
            launch_relation_attend(pg, r, outs[design], plan)
        torch.cuda.synchronize()
        errs = {d: _large_err(torch, o, want, dtype, RELATION_ATOL)[0] for d, o in outs.items()}
        tol = _large_err(torch, want, want, dtype, RELATION_ATOL)[1]
        _require({d: p["design"] for d, p in plans.items()} == {d: d for d in plans}
                 and max(errs.values()) <= tol,
                 f"[large_shapes] relation_attend N={N} {tag}: the tc, the wide and the split "
                 f"design within {tol}: {errs}")
        tc_ms, wide_ms, split_ms = _turns(
            torch, [lambda d=d: launch_relation_attend(pg, r, outs[d], plans[d])
                    for d in ("tc", "wide", "split")], iters=5)
        bound = (_bound(2 * 3 * B * N * D, 2.0 * 2 * B * N * N * D) if elem == 2
                 else _relation_f32_bounds(B, N, D)[0])
        _phase("large_shapes", kernel="relation_attend", card=card, part="tc_vs_wide_vs_split",
               shape=f"B={B} N={N} D={D} {tag}", tc_ms=round(tc_ms, 4), wide_ms=round(wide_ms, 4),
               split_ms=round(split_ms, 4), split_chunks=2, tc_err=round(errs["tc"], 8),
               wide_err=round(errs["wide"], 8), split_err=round(errs["split"], 8), tol=tol,
               bound_ms=round(bound[0], 6), bound_by=bound[1],
               tc_pct_of_bound=round(100 * bound[0] / tc_ms, 3))
        for rec in relation_records:  # this type's relation records
            rec[f"tc_vs_wide_n{N}"] = dict(tc_ms=tc_ms, wide_ms=wide_ms, split_ms=split_ms,
                                           bound_ms=bound[0])
        del pg, r, outs, want

        # glimpse_head and glimpse_attend: glimpse groups (R=196, G=512),
        # region chunks (R=16,384, G=4), and the path's MutanAtt with
        # LARGE_GLIMPSES glimpses over the grid; bf16 the tc design (the
        # default) and the split one forced beside it, float32 the split
        # design; each timed in turns with plain and SDPA
        M, Dv = 510, DIM
        glimpse_shapes = ([(LARGE_KERNEL_B, R, G) for R, G in LARGE_GLIMPSE]
                          + [(path_b, LARGE_GRID, LARGE_GLIMPSES)])
        for B, R, G in glimpse_shapes:
            joint = torch.tanh(torch.randn(B, R, M, device=dev)).to(dtype)
            w = (torch.randn(M, G, device=dev) / M ** 0.5).to(dtype)
            b = (0.1 * torch.randn(G, device=dev)).to(dtype)
            v = torch.randn(B, R, Dv, device=dev).to(dtype)
            default = "tc" if elem == 2 else "split"
            plan = glimpse_plan(B, R, M, G, Dv, elem=elem)
            att, logits = glimpse_head(joint, w, b, v)
            masked = logits.clone()
            masked[0, R // 2:] = torch.finfo(dtype).min  # MFB's padding, and a row masked whole
            masked[1] = torch.finfo(dtype).min
            outs = {default: (att, logits, glimpse_attend(masked, v), glimpse_attend(masked, v))}
            plans = {default: (plan, glimpse_plan(B, R, 0, G, Dv, elem=elem))}
            if elem == 2:  # the split design forced beside tc, on the same logits
                plans["split"] = (glimpse_plan(B, R, M, G, Dv, copy="split"),
                                  glimpse_plan(B, R, 0, G, Dv, copy="split"))
                split_out = [torch.empty_like(att), torch.empty_like(logits),
                             torch.empty_like(att), torch.empty_like(att)]
                launch_glimpse_head(joint, w, b, v, split_out[0], split_out[1], plans["split"][0])
                for o in split_out[2:]:
                    launch_glimpse_attend(masked, v, o, plans["split"][1])
                outs["split"] = tuple(split_out)
            ref_att, ref_logits = glimpse_head_reference(joint.float(), w.float(), b.float(),
                                                         v.float())
            want = glimpse_attend_reference(masked.float(), v.float())
            # the SDPA yardstick, held against plain before its time: the
            # attended output alone (the bias is constant along R, so it
            # drops out of the softmax); glimpse_attend with zero q and k and
            # the logits as the mask
            q = w.t().unsqueeze(0).expand(B, G, M)
            zq = torch.zeros(B, G, 8, device=dev, dtype=dtype)
            zk = torch.zeros(B, R, 8, device=dev, dtype=dtype)
            mask = masked.transpose(1, 2)

            def sdpa_head():
                return F.scaled_dot_product_attention(q, joint, v, scale=1.0)

            def sdpa_attend():
                return F.scaled_dot_product_attention(zq, zk, v, attn_mask=mask)

            sdpa_errs = (_large_err(torch, sdpa_head(), ref_att, dtype, GLIMPSE_ATOL),
                         _large_err(torch, sdpa_attend(), want, dtype, GLIMPSE_ATOL))
            torch.cuda.synchronize()
            _require(all(e <= t for e, t in sdpa_errs),
                     f"[large_shapes] SDPA at the glimpse shape {(B, R, M, G, Dv)} {tag} within "
                     f"the plain version's bound (head, attend): {sdpa_errs}")
            held = {}
            for design, (d_att, d_logits, got, again) in outs.items():
                head_err, head_tol = _large_err(torch, d_att, ref_att, dtype, GLIMPSE_ATOL)
                logits_err, logits_tol = _large_err(torch, d_logits, ref_logits, dtype,
                                                    GLIMPSE_ATOL)
                att_err, tol = _large_err(torch, got, want, dtype, GLIMPSE_ATOL)
                held[design] = (head_err, head_tol, logits_err, logits_tol, att_err, tol)
                _require(plans[design][0]["copy"] == plans[design][1]["copy"] == design
                         and head_err <= head_tol and logits_err <= logits_tol and att_err <= tol
                         and bool(torch.isfinite(got).all()) and torch.equal(got, again),
                         f"[large_shapes] glimpse kernels {(B, R, M, G, Dv)} {tag}: the {design} "
                         f"design ({plans[design][0]['copy']}), head attended err {head_err} <= "
                         f"{head_tol}, logits err {logits_err} <= {logits_tol}, attend err "
                         f"{att_err} <= {tol}, bit-equal across two calls")
            if elem == 2:  # the tc head bit-equal across two calls too
                again_att, again_logits = glimpse_head(joint, w, b, v)
                _require(torch.equal(att, again_att) and torch.equal(logits, again_logits),
                         f"[large_shapes] glimpse_head {(B, R, M, G, Dv)} tc: two calls bit-equal")
            designs = list(outs)
            head_fns = {"tc": lambda: glimpse_head(joint, w, b, v),
                        "split": (lambda: glimpse_head(joint, w, b, v)) if elem == 4 else
                        (lambda: launch_glimpse_head(joint, w, b, v, split_out[0], split_out[1],
                                                     plans["split"][0]))}
            attend_fns = {"tc": lambda: glimpse_attend(masked, v),
                          "split": (lambda: glimpse_attend(masked, v)) if elem == 4 else
                          (lambda: launch_glimpse_attend(masked, v, split_out[2],
                                                         plans["split"][1]))}
            *head_ms, head_plain, head_sdpa = _turns(
                torch, [head_fns[d] for d in designs]
                + [lambda: glimpse_head_reference(joint, w, b, v), sdpa_head], iters=5)
            *attend_ms, attend_plain, attend_sdpa = _turns(
                torch, [attend_fns[d] for d in designs]
                + [lambda: glimpse_attend_reference(masked, v), sdpa_attend], iters=5)
            head_bound = _glimpse_head_bound(B, R, M, G, Dv, elem)
            attend_bound = _bound(elem * (B * R * G + B * R * Dv + B * G * Dv),
                                  2.0 * B * R * G * Dv, PEAK_BF16 if elem == 2 else PEAK_FP32)
            launches, attend_launches = {}, {}
            if elem == 2:  # the tc design's two launches apart, over one scratch, and the
                # host's time to enqueue a call and its two launches
                tc_plan, tc_attend = plans["tc"]
                _glimpse_tc_geometry(torch, attention, dev, B, R, M, G, Dv, tc_plan, tc_attend)
                scratch = attention.tc_scratch(B, R, G, Dv, dev, tc_plan)
                launches = dict(zip(("logits_ms", "sum_ms"), _turns(
                    torch, [lambda w_=w_: attention._launch_tc(joint, w, b, None, v, att, logits,
                                                              tc_plan, (w_,), scratch)
                            for w_ in (0, 1)], iters=5)))
                attend_out = torch.empty_like(att)
                attend_scratch = attention.tc_scratch(B, R, G, Dv, dev, tc_attend)
                attend_launches = dict(zip(("logits_ms", "sum_ms"), _turns(
                    torch, [lambda w_=w_: attention._launch_tc(None, None, None, masked, v,
                                                              attend_out, None, tc_attend,
                                                              (w_,), attend_scratch)
                            for w_ in (0, 1)], iters=5)))
                launches.update(
                    call_host_ms=_enqueue_ms(torch, head_fns["tc"]),
                    launch_host_ms=_enqueue_ms(torch, lambda: attention._launch_tc(
                        joint, w, b, None, v, att, logits, tc_plan, (0, 1), scratch)))
                attend_launches.update(call_host_ms=_enqueue_ms(torch, attend_fns["tc"]))
                del scratch, attend_scratch, attend_out
            for k, design in enumerate(designs):
                p_head = plans[design][0]
                head_err, head_tol, logits_err, logits_tol, att_err, tol = held[design]
                if design == "tc":
                    groups, chunks = p_head["groups"], p_head["chunks"]
                    shape = (f"B={B} R={R} M={M} G={G} D={Dv} {tag}: {-(-G // groups)} glimpse "
                             f"group(s) of {groups} (wgmma N), {chunks} region chunk(s)")
                    extra = dict(rows=p_head["rows"], scratch_bytes=p_head["scratch_bytes"],
                                 **launches)
                else:
                    groups, chunks = p_head["groups"], p_head["chunks"]
                    shape = (f"B={B} R={R} M={M} G={G} D={Dv} {tag}: {-(-G // groups)} glimpse "
                             f"group(s) of {groups}, {chunks} region chunk(s)")
                    extra = dict(forced=elem == 2)
                others = {f"{d}_ms": head_ms[j] for j, d in enumerate(designs) if d != design}
                rec = _large_record("glimpse_head", design, head_err, head_tol, head_ms[k],
                                    head_plain, head_bound, head_sdpa, shape,
                                    logits_err=logits_err, logits_tol=logits_tol, groups=groups,
                                    chunks=chunks, bit_equal=True,
                                    vs_sdpa=head_ms[k] / head_sdpa,
                                    library="SDPA(q=w^T, k=joint, v, scale=1): attended only",
                                    **others, **extra)
                records.append(rec)
                _phase("large_shapes", kernel="glimpse_head", card=card,
                       **{k_: (round(x, 6) if isinstance(x, float) else x)
                          for k_, x in rec.items()})
                others = {f"{d}_ms": attend_ms[j] for j, d in enumerate(designs) if d != design}
                rec = _large_record("glimpse_attend", design, att_err, tol, attend_ms[k],
                                    attend_plain, attend_bound, attend_sdpa,
                                    shape + ", a row masked past its middle and one whole",
                                    groups=groups, chunks=chunks, bit_equal=True,
                                    vs_sdpa=attend_ms[k] / attend_sdpa,
                                    library="SDPA(q=0, k=0, v, attn_mask=logits^T)", **others,
                                    **(attend_launches if design == "tc" else {}))
                records.append(rec)
                _phase("large_shapes", kernel="glimpse_attend", card=card,
                       **{k_: (round(x, 6) if isinstance(x, float) else x)
                          for k_, x in rec.items()})
            del joint, w, b, v, att, logits, masked, outs, ref_att, ref_logits, want, q, zq, zk
            if elem == 2:
                del split_out
        if elem == 2:
            for shape in LARGE_GLIMPSE_ODD:
                _glimpse_tc_odd(torch, attention, dev, card, *shape)

        # mfb_pool: the roots in opted-in shared memory (m = 20,000), and in
        # the output row past it (m = 70,000)
        for n, k, m in LARGE_MFB:
            z = torch.randn(n, k * m, device=dev).to(dtype)
            design = mfb_plan(m)["design"]
            out = mfb_pool(z, k)
            torch.cuda.synchronize()
            if elem == 2:
                err, tol = _large_err(torch, out, mfb_pool_reference(z.float(), k), dtype,
                                      MFB_POOL_ATOL)
            else:  # against float64: the signed square root is ill-conditioned near 0
                exact = mfb_pool_reference(z.double(), k)
                err, tol = _rel_err(out, exact), max(F32_REL, 2 * _rel_err(
                    mfb_pool_reference(z, k), exact))
                del exact
            _require(err <= tol, f"[large_shapes] mfb_pool {(n, k, m)} {tag} ({design}): err "
                                 f"{err} <= {tol}")
            ms, plain = timed(lambda: mfb_pool(z, k), lambda: mfb_pool_reference(z, k), iters=10)
            bound = _bound(elem * (n * k * m + n * m), n * (k * m + 4 * m), PEAK_FP32)
            rec = _large_record("mfb_pool", design, err, tol, ms, plain, bound, None,
                                f"z {n}x{k * m} -> {n}x{m} {tag}, k={k}")
            records.append(rec)
            _phase("large_shapes", kernel="mfb_pool", card=card,
                   **{k_: (round(x, 8) if isinstance(x, float) else x) for k_, x in rec.items()})
            del z, out

    # lstm_seq over an xg view off 16 bytes (an aligned copy), against the
    # same values aligned: bit-equal
    T, Bq, H = 7, SERVE_BATCH, 1024
    base = torch.randn(T * Bq * 4 * H + 1, device=dev).to(torch.bfloat16)
    xg = base[1:].view(T, Bq, 4 * H)
    mask = torch.ones(T, Bq, 1, device=dev, dtype=torch.bfloat16)
    wh = (torch.randn(H, 4 * H, device=dev) / H ** 0.5).to(torch.bfloat16)
    got, want = lstm.lstm_seq(xg, mask, wh), lstm.lstm_seq(xg.clone(), mask, wh)
    torch.cuda.synchronize()
    _require(xg.data_ptr() % 16 != 0 and torch.equal(got[0], want[0])
             and torch.equal(got[1], want[1]),
             "[large_shapes] lstm_seq over an xg off 16 bytes equals the aligned call")
    _phase("large_shapes", kernel="lstm_seq", card=card, part="xg_off_16_bytes",
           shape=f"T={T} B={Bq} H={H} bf16", xg_offset_bytes=xg.data_ptr() % 16, bit_equal=True)
    return records


def _grid_logits(torch, dev, model, table, num_words: int, batch: int, seed: int):
    """One forward of ``model`` over ``batch`` random questions on the rows
    of ``table`` through the kernels, then the plain path: (logits, plain
    logits, launch counts, design counts)."""
    from vqa_tpu_torch.engine import steps

    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, 14, batch)
    questions = rng.integers(1, num_words, (batch, 13)) * (np.arange(13) < lengths[:, None])
    b = {"question": torch.from_numpy(questions).to(dev),
         "image_index": rng.integers(0, table.shape[0], batch)}
    with torch.inference_mode():
        _reset_counts()
        logits = model(steps._resolve_visual(b, table), b["question"]).float()
        torch.cuda.synchronize()
        counts, designs = _read_counts(), _read_design_counts()
        with _plain_ops(torch):
            plain = model(steps._resolve_visual(b, table), b["question"]).float()
        torch.cuda.synchronize()
    return logits, plain, counts, designs


def _large_path(torch, dev, card: str) -> tuple:
    """[large_shapes], the path: import, extract at --size 1792, the eval
    CLI over the table (CoR and MutanAtt, kernels and plain), the forward
    holds; returns (launch counts, design counts) of the kernel runs."""
    import dataclasses
    import io

    from vqa_tpu_torch.cli import train as train_cli
    from vqa_tpu_torch.cli.extract import extract
    from vqa_tpu_torch.config import load_options
    from vqa_tpu_torch.datasets import factory as data_factory
    from vqa_tpu_torch.datasets.features import FeatureStore
    from vqa_tpu_torch.datasets.interim import image_name
    from vqa_tpu_torch.models import convnets
    from vqa_tpu_torch.models.factory import factory as model_factory
    from vqa_tpu_torch.weights import export_params, random_params

    launches, designs = dict.fromkeys(_counters(), 0), {}

    def add(counts, by_design):
        for k, c in counts.items():
            launches[k] += c
        for k, d in by_design.items():
            for name, c in d.items():
                designs.setdefault(k, dict.fromkeys(d, 0))[name] += c

    names = [image_name("val2014", i) for i in range(LARGE_IMAGES)]
    pixels = np.random.default_rng(5).integers(
        0, 256, (LARGE_IMAGES, LARGE_SIZE, LARGE_SIZE, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_large_") as tmp:
        npz, _ = _extract_import(torch, tmp)
        resnet = convnets.factory(EXTRACT_ARCH, torch.bfloat16)
        with np.load(npz) as flat:
            convnets.load_variables(resnet, flat)
        resnet.to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        got_names, feats = extract(resnet, names, _normalized(pixels), "att", EXTRACT_BATCH, dev)
        extract_s = time.perf_counter() - t
        extract_peak = torch.cuda.max_memory_allocated() / 2**30
        del resnet, pixels
        torch.cuda.empty_cache()
        _require(got_names == names and feats.shape == (LARGE_IMAGES, LARGE_GRID, DIM)
                 and bool(np.isfinite(feats).all()),
                 f"[large_shapes] the extract function at --size {LARGE_SIZE} gives "
                 f"{LARGE_IMAGES} finite rows [{LARGE_GRID}, {DIM}]: {feats.shape}")
        _phase("large_shapes", part="extract", card=card, arch=EXTRACT_ARCH, size=LARGE_SIZE,
               images=LARGE_IMAGES, batch=EXTRACT_BATCH, regions=LARGE_GRID,
               extract_s=round(extract_s, 3),
               images_per_s=round(LARGE_IMAGES / extract_s, 2),
               table_gb_bf16=round(feats.size * 2 / 2**30, 3), peak_mem_gb=round(extract_peak, 3),
               features_std=round(float(feats.std()), 5))

        _write_raw_vqa2(os.path.join(tmp, "vqa2", "raw"), np.random.default_rng(0),
                        n_images=LARGE_IMAGES, n_train=LARGE_TRAIN_QUESTIONS,
                        n_val=LARGE_VAL_QUESTIONS)
        data = [f"vqa.dir={tmp}/vqa2", f"coco.dir={tmp}/coco", f"coco.arch={EXTRACT_ARCH}"]
        table = torch.from_numpy(feats).to(dev, torch.bfloat16)
        lines = {}
        for arch, (name, arch_kernels) in LARGE_EVAL.items():
            yaml = os.path.join(_REPO, "options", "vqa2", f"{name}.yaml")
            opt = load_options(yaml, data)
            data_factory.place_store(opt.coco.dir, opt.coco.arch, opt.coco.mode,
                                     FeatureStore.in_memory(names, feats))
            val_set = data_factory.factory("val", opt)
            _require(val_set.feature_shape == (LARGE_GRID, DIM),
                     f"[large_shapes] {arch} reads the {LARGE_GRID}-region table: "
                     f"{val_set.feature_shape}")
            model = model_factory(dataclasses.asdict(opt.model), val_set.num_words,
                                  val_set.num_answers, dtype=torch.bfloat16, device=dev,
                                  dim_v=DIM)
            random_params(model, seed=0)
            weights = os.path.join(tmp, f"params_{name}.npz")
            np.savez(weights, **export_params(model))
            # one forward over the grid, held on its logits against the plain path
            logits, plain, counts, by_design = _grid_logits(torch, dev, model, table,
                                                            val_set.num_words, LARGE_BATCH, 3)
            err = (logits - plain).abs().max().item()
            _require({k for k, c in counts.items() if c} == set(arch_kernels)
                     and bool(torch.isfinite(logits).all()) and err <= LOGITS_ATOL,
                     f"[large_shapes] {arch} over {LARGE_GRID} regions: exactly {arch_kernels} "
                     f"launched ({counts}), finite logits within {LOGITS_ATOL} of the plain "
                     f"path's: {err}")
            if arch == "CoR":
                _require(by_design["relation_attend"]["tc"] == counts["relation_attend"] > 0,
                         f"[large_shapes] every relation_attend call over {LARGE_GRID} regions "
                         f"ran the tc design: {by_design['relation_attend']}")
            add(counts, by_design)
            forward = dict(logits_max_abs_err=round(err, 5), tol=LOGITS_ATOL,
                           logits_std=round(plain.std().item(), 5))
            del model, logits, plain
            torch.cuda.empty_cache()
            argv = ["--path_opt", yaml, "-e", "--split", "val"]
            for o in data + [f"model.pretrained_params={weights}", "engine.device_features=true",
                             f"optim.eval_batch_size={LARGE_BATCH}",
                             "engine.features_dtype=bfloat16", "engine.dtype=bfloat16"]:
                argv += ["--opt", o]
            runs = {}
            for label, plain_path in (("kernels", False), ("plain", True)):
                logs = os.path.join(tmp, "logs", f"{name}_{label}")
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                t = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()), \
                        (_plain_ops(torch) if plain_path else contextlib.nullcontext()):
                    rc = train_cli.main(argv + ["--dir_logs", logs])
                wall = time.perf_counter() - t
                counts, by_design = _read_counts(), _read_design_counts()
                _require(rc == 0, f"[large_shapes] eval CLI over the {LARGE_GRID}-region table "
                                  f"({arch}, {label}) returned {rc}")
                with open(os.path.join(logs, "metrics.jsonl")) as f:
                    metrics = [json.loads(line) for line in f][-1]
                with open(os.path.join(logs, "results",
                                       "vqa_OpenEnded_val_epoch0_results.json")) as f:
                    results = {r["question_id"]: r["answer"] for r in json.load(f)}
                runs[label] = dict(counts=counts, designs=by_design, metrics=metrics,
                                   results=results, wall=wall,
                                   peak_gb=torch.cuda.max_memory_allocated() / 2**30)
            split = val_set.split
            for label, run in runs.items():
                want = set() if label == "plain" else set(arch_kernels)
                _require({k for k, c in run["counts"].items() if c} == want,
                         f"[large_shapes] eval CLI ({arch}, {label}) launched exactly "
                         f"{sorted(want)}: {run['counts']}")
                _require(len(run["results"]) == len(split)
                         and set(run["results"]) == set(split.question_ids.tolist()),
                         f"[large_shapes] eval CLI ({arch}, {label}): one results row per val "
                         f"question")
            kern = runs["kernels"]
            if arch == "CoR":
                _require(kern["designs"]["relation_attend"]["tc"]
                         == kern["counts"]["relation_attend"] > 0,
                         f"[large_shapes] the eval CLI's relation_attend calls ran the tc "
                         f"design: {kern['designs']['relation_attend']}")
            agree = float(np.mean([kern["results"][q] == a
                                   for q, a in runs["plain"]["results"].items()]))
            _require(agree >= PRED_AGREE_FLOOR, f"[large_shapes] eval CLI ({arch}): answers agree "
                     f"with the plain run's on {agree} >= {PRED_AGREE_FLOOR}")
            add(kern["counts"], kern["designs"])
            lines[arch] = dict(
                **forward, pred_agree_plain=round(agree, 5), floor=PRED_AGREE_FLOOR,
                **{f"{label}_{key}": value for label, run in runs.items()
                   for key, value in (("qa_per_sec", round(run["metrics"]["qa_per_sec"], 2)),
                                      ("eval_time", round(run["metrics"]["eval_time"], 4)),
                                      ("cli_s", round(run["wall"], 3)),
                                      ("peak_mem_gb", round(run["peak_gb"], 3)))},
                launches={k: c for k, c in kern["counts"].items() if c},
                designs={k: {d: c for d, c in v.items() if c}
                         for k, v in kern["designs"].items() if any(v.values())})
            _phase("large_shapes", part="eval_cli", card=card, arch=arch, yaml=f"{name}.yaml",
                   regions=LARGE_GRID, questions=len(split), batch=LARGE_BATCH, dtype="bfloat16",
                   **lines[arch])
            data_factory.drop_stores(f"{tmp}/coco")

        # CoR in float32 (cor.yaml as written) over 8 rows of the table, and
        # MutanAtt with 24 glimpses (glimpse_head's tc design) in bf16,
        # one forward each held against the plain path
        opt = load_options(os.path.join(_REPO, "options", "vqa2", "cor.yaml"), data)
        cor32 = model_factory(dataclasses.asdict(opt.model), 1000, 2000, dtype=torch.float32,
                              device=dev, dim_v=DIM)
        random_params(cor32, seed=0)
        table32 = table[:8].float()
        logits, plain, counts, by_design = _grid_logits(torch, dev, cor32, table32, 1000,
                                                        LARGE_F32_BATCH, 4)
        err = _rel_err(logits, plain)
        _require(by_design["relation_attend"]["tc"] == counts["relation_attend"] > 0
                 and err <= F32_LOGITS_REL,
                 f"[large_shapes] CoR float32 over {LARGE_GRID} regions: the tc design "
                 f"({by_design['relation_attend']}), logits within {F32_LOGITS_REL} of the plain "
                 f"float32 path's max-abs: {err}")
        add(counts, by_design)
        _phase("large_shapes", part="forward", card=card, arch="CoR", dtype="float32",
               regions=LARGE_GRID, batch=LARGE_F32_BATCH, logits_rel_err=f"{err:.3e}",
               tol=F32_LOGITS_REL,
               launches={k: c for k, c in counts.items() if c})
        del cor32, table32, logits, plain
        opt = load_options(os.path.join(_REPO, "options", "vqa2", "mutan_att.yaml"),
                           data + [f"model.attention.nb_glimpses={LARGE_GLIMPSES}"])
        many = model_factory(dataclasses.asdict(opt.model), 1000, 2000, dtype=torch.bfloat16,
                             device=dev, dim_v=DIM)
        random_params(many, seed=0)
        logits, plain, counts, by_design = _grid_logits(torch, dev, many, table, 1000,
                                                        LARGE_BATCH, 5)
        err = (logits - plain).abs().max().item()
        _require(by_design["glimpse_head"]["tc"] == counts["glimpse_head"] > 0
                 and err <= LOGITS_ATOL,
                 f"[large_shapes] MutanAtt with {LARGE_GLIMPSES} glimpses over {LARGE_GRID} "
                 f"regions: every glimpse_head call the tc design ({by_design['glimpse_head']}), "
                 f"logits within {LOGITS_ATOL} of the plain path's: {err}")
        add(counts, by_design)
        _phase("large_shapes", part="forward", card=card, arch="MutanAtt",
               glimpses=LARGE_GLIMPSES, dtype="bfloat16", regions=LARGE_GRID, batch=LARGE_BATCH,
               logits_max_abs_err=round(err, 5), tol=LOGITS_ATOL,
               launches={k: c for k, c in counts.items() if c})
        del many, table, feats
        torch.cuda.empty_cache()
    return launches, designs


def _large_shapes_phase(torch, dev, card: str, kernels: dict) -> dict:
    """[large_shapes] (the docstring's phase 17): the new designs against
    their plain versions, then the path over the 1792-pixel grid; each
    design's record goes into its kernel's, under "designs", with the
    launches the path counted (0 for a design no model path reaches:
    glimpse_attend's tc and split designs, glimpse_head's split one, forced
    in bf16, and mfb_pool's designs past 48 KB). Returns the path's launch
    counts."""
    t0 = time.perf_counter()
    records = _large_kernels(torch, dev, card)
    launches, designs = _large_path(torch, dev, card)
    for rec in records:
        name, design = rec.pop("name").split("/")
        by_shape = kernels[name].setdefault("designs", {}).setdefault(design, {
            "route": "cuda", "source": DESIGN_SOURCES.get((name, design), SOURCES[name][0]),
            "replaces": SOURCES[name][1],
            "launches": designs.get(name, {}).get(design, 0), "by_shape": {}})
        by_shape["by_shape"][rec["shape"]] = {
            k: (round(x, 6) if isinstance(x, float) else x) for k, x in rec.items()
            if k != "shape"}
    for name, by_design in kernels.items():
        for design, rec in by_design.get("designs", {}).items():
            first = next(iter(rec["by_shape"].values()))  # the flagship shape: the first held
            rec.update({k: first[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")})
    _phase("large_shapes", part="total", card=card, wall_s=round(time.perf_counter() - t0, 2),
           launches={k: c for k, c in launches.items() if c},
           designs={k: {d: c for d, c in v.items() if c} for k, v in designs.items()})
    return launches


# -------------------------------------------------------------- parallel

# [parallel]: data parallelism across processes (vqa_tpu_torch/parallel/),
# at the full width of options/vqa2/mutan_att.yaml. (a) the train CLI as a
# world of one over NCCL, replicated and row-sharded table, each bit-equal
# to the run without --distributed (the grads' all_reduce and the table's
# reduce_scatter run over NCCL there); (b) two ranks sharing the card over
# gloo, each a spawned process, float32, dropout off, sgd (lr 0.1, momentum
# 0: the JAX package's tests/test_multidevice_training.py setup), 3 steps at
# a global batch of 128 against one process at 128 from the same weights;
# (c) the 1024-image table row-sharded over the same two ranks (512 rows
# each and the sink), bf16 and the int8 pair, against the replicated table.
PARALLEL_WORLD = 2
PARALLEL_STEPS = 3
PARALLEL_TIMED = 5
PARALLEL_LR = 0.1
PARALLEL_SGD = dict(optimizer="sgd", lr=PARALLEL_LR, momentum=0.0)
PARALLEL_T = 13
PARALLEL_LOSS_RTOL = 1e-5
PARALLEL_PARAM_RTOL, PARALLEL_PARAM_ATOL = 2e-4, 1e-5  # tests/test_multidevice_training.py:79-84
PARALLEL_EVAL_BATCHES = 2
PARALLEL_TIMEOUT = 300
# (d)-(g): tensor parallelism (vqa_tpu_torch/parallel/partition.py), the
# optimizer state of the large 2-D leaves sharded over the mesh's model
# axis, at the same width: (d) two gloo ranks on the card as a 1 x 2 mesh,
# float32, dropout off, 3 steps at a global batch of 128, with (b)'s sgd
# and with the YAML's adam, against one process; (e) four ranks as a 2 x 2
# mesh, sgd; (f) the train CLI --distributed as a 1 x 2 world (gloo),
# stopped after a step save, resumed in one process, against (a)'s single
# run; (g) the table row-sharded over (d)'s world.
TP_MODEL_PARALLEL = 2
TP_ADAM = dict(optimizer="adam", lr=1e-4)  # options/vqa2/mutan_att.yaml's optim
TP_PARAM_REL = 1e-5  # tests/test_torch_train.py's adam hold: of each leaf's scale
TP_CLI_CKPT_EVERY = 2
TP_CLI_PREEMPT_AT = 4
# the wall-clock fields of the logs; every other field is compared bit for bit
TIMING_KEYS = ("ts", "data_time", "batch_time", "epoch_time", "eval_time", "qa_per_sec")


def _parallel_data():
    """(b)'s and (c)'s inputs, the same in every process: the float32 table
    [N_IMAGES, 36, 2048], one train batch of TRAIN_BATCH questions cut to
    PARALLEL_T tokens (bench.py's lengths) and PARALLEL_EVAL_BATCHES eval
    batches of BATCH."""
    from vqa_tpu_torch.flagship import NUM_ANSWERS

    rng = np.random.default_rng(7)
    questions, lengths, image_index, table = _synthetic_eval_arrays(
        rng, TRAIN_BATCH + PARALLEL_EVAL_BATCHES * BATCH)
    lengths = np.minimum(lengths, PARALLEL_T)
    questions = questions[:, :PARALLEL_T] * (np.arange(PARALLEL_T) < lengths[:, None])
    answers = rng.integers(0, NUM_ANSWERS, len(questions)).astype(np.int32)
    rows = [slice(0, TRAIN_BATCH)] + [slice(TRAIN_BATCH + i * BATCH, TRAIN_BATCH + (i + 1) * BATCH)
                                      for i in range(PARALLEL_EVAL_BATCHES)]
    batches = [dict(question=questions[r], length=lengths[r], answer=answers[r],
                    image_index=image_index[r]) for r in rows]
    return table, batches[0], batches[1:]


def _parallel_model(torch, dev, train: bool):
    """MutanAtt at full width, seeded init (the same weights in every
    process): the float32 training build with every dropout off, or the
    bf16 eval build."""
    from vqa_tpu_torch.flagship import NUM_ANSWERS, NUM_WORDS, model_options
    from vqa_tpu_torch.models.factory import factory
    from vqa_tpu_torch.weights import init_params

    opt = model_options(name="mutan_att")
    if train:
        for section in opt.values():
            if isinstance(section, dict):
                section.update({k: 0.0 for k in section if k.startswith("dropout")})
    model = factory(opt, NUM_WORDS, NUM_ANSWERS, dtype=torch.float32 if train else torch.bfloat16,
                    device=dev, train=train)
    init_params(model, 0)
    return model


def _local_batch(torch, dev, batch, mesh):
    from vqa_tpu_torch.parallel.mesh import local_rows

    lo, hi = local_rows(len(batch["answer"]), mesh)
    out = {k: torch.from_numpy(np.ascontiguousarray(batch[k][lo:hi])).to(dev)
           for k in ("question", "length", "answer")}
    out["image_index"] = batch["image_index"][lo:hi]
    return out


def _parallel_train(torch, dev, mesh, table, batch, knobs=None) -> dict:
    """(b), (d) and (e) in this process: PARALLEL_STEPS held steps of this
    rank's slice of ``batch`` (all of it in one process) with the optimizer
    of ``knobs`` (default ``PARALLEL_SGD``), the state laid out over the
    mesh's model axis (``shard_state_tp``; nothing to do at 1), then
    PARALLEL_TIMED timed ones; returns the held steps' losses, the
    parameters after them, the optimizer state's bytes here, the peak memory
    of the steps above what the process held before the run, the timings
    (each step on the host clock after a sync; the data axis' all-reduce and
    the model axis' all-gather alone between two syncs) and the devices of
    the parameters, the optimizer state and the table."""
    from vqa_tpu_torch.config import OptimOptions
    from vqa_tpu_torch.engine import optim, steps
    from vqa_tpu_torch.parallel import Mesh, shard_state_tp, state_bytes
    from vqa_tpu_torch.weights import export_params

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    model = _parallel_model(torch, dev, train=True)
    state = shard_state_tp(steps.create_state(model, optim.factory(
        OptimOptions(**(knobs or PARALLEL_SGD)), 1)), mesh)
    step = steps.make_train_step(optim.criterion_factory(), seed=0, mesh=mesh)
    local = _local_batch(torch, dev, batch, mesh)
    features = torch.from_numpy(table).to(dev)
    devices = {str(p.device) for p in model.parameters()} | {str(features.device)}
    optim.map_param_tensors(state.opt_state, lambda i, t: devices.add(str(t.device)) or t)
    timed = {"all_reduce_mean": [], "all_gather_model": []}
    real = {name: getattr(Mesh, name) for name in timed}

    def timer(name):
        def collective(self, flat):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real[name](self, flat)
            torch.cuda.synchronize()
            timed[name].append((time.perf_counter() - t) * 1e3)
            return out
        return collective

    for name in timed:
        setattr(Mesh, name, timer(name))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses = []
        for _ in range(PARALLEL_STEPS):
            state, metrics = step(state, local, features)
            losses.append(float(metrics["loss"]))
        params = export_params(model)
        step_ms = []
        for ms in timed.values():
            del ms[:]
        for _ in range(PARALLEL_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, local, features)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) - base
    finally:
        for name, fn in real.items():
            setattr(Mesh, name, fn)
    opt_bytes = state_bytes(state.opt_state)
    del state, model, features
    torch.cuda.empty_cache()
    return dict(losses=losses, params=params, step_ms=statistics.median(step_ms),
                reduce_ms=statistics.median(timed["all_reduce_mean"] or [0.0]),
                gather_ms=statistics.median(timed["all_gather_model"] or [0.0]),
                state_bytes=opt_bytes, peak=peak, devices=sorted(devices))


def _parallel_sharded(torch, dev, mesh, table, batches, timed: bool = False) -> dict:
    """(c) in this rank: the eval step over this rank's slice of each eval
    batch, over the replicated table and over the row-sharded one, bf16 and
    the int8 pair (bf16 scales); rows, pred and correct1 compared, the
    sharded runs' launches counted, each run's peak memory, the -0.0 values
    among the rows, the devices of the tables; ``timed``: the sharded
    gather's parts on the first batch (``_sharded_gather_ms``)."""
    from vqa_tpu_torch.engine.steps import make_eval_step, quantize_features
    from vqa_tpu_torch.ops.gather import gather_rows, gather_rows_dequant
    from vqa_tpu_torch.parallel.mesh import shard_feature_table

    net, eval_step = _parallel_model(torch, dev, train=False), make_eval_step()
    local = [_local_batch(torch, dev, b, mesh) for b in batches]
    values, scales = quantize_features(table)
    hosts = {"bf16": torch.from_numpy(table).to(torch.bfloat16),
             "int8": (torch.from_numpy(values), torch.from_numpy(scales).to(torch.bfloat16))}
    out = {}
    for kind, host in hosts.items():
        runs = {}
        for layout in ("replicated", "sharded"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            features = (shard_feature_table(host, mesh, dev) if layout == "sharded"
                        else tuple(t.to(dev) for t in host) if kind == "int8" else host.to(dev))
            parts = (features.local if layout == "sharded" else features)
            parts = parts if isinstance(parts, tuple) else (parts,)
            resident = sum(t.nbytes for t in parts)
            _reset_counts()
            res = [eval_step(net, b, features) for b in local]
            torch.cuda.synchronize()
            counts = _read_counts()
            peak = torch.cuda.max_memory_allocated(dev)
            rows = [(features.gather(b["image_index"]) if layout == "sharded"
                     else gather_rows_dequant(*features, b["image_index"]) if kind == "int8"
                     else gather_rows(features, b["image_index"])).view(torch.int16).cpu()
                    for b in local]
            runs[layout] = dict(pred=[r["pred"].cpu() for r in res],
                                correct1=[int(r["correct1"]) for r in res], rows=rows,
                                counts=counts, peak=peak, resident=resident,
                                devices=sorted({str(t.device) for t in parts}))
            if timed and layout == "sharded":
                runs[layout]["ms"] = _sharded_gather_ms(torch, features, local[0]["image_index"])
            del features, res
        rep, shd = runs["replicated"], runs["sharded"]
        out[kind] = dict(
            rows_equal=all(torch.equal(a, b) for a, b in zip(rep["rows"], shd["rows"])),
            pred_equal=all(torch.equal(a, b) for a, b in zip(rep["pred"], shd["pred"])),
            correct1=[rep["correct1"], shd["correct1"]],
            # bf16's -0.0 is the int16 -32768 (the sign bit alone)
            negative_zeros=[sum(int((r == -32768).sum()) for r in run["rows"])
                            for run in (rep, shd)],
            sharded_launches={k: c for k, c in shd["counts"].items() if c},
            replicated_launches={k: c for k, c in rep["counts"].items() if c},
            peak=[rep["peak"], shd["peak"]], resident=[rep["resident"], shd["resident"]],
            devices=sorted(set(rep["devices"]) | set(shd["devices"])), ms=shd.get("ms"))
    return out


def _sharded_gather_ms(torch, features, idx) -> dict:
    """The host-clock medians, over MULTICARD_TIMED calls of the sharded
    gather of ``idx`` (every rank makes them all), of the whole gather and of
    its two parts on the card, the local ``gather_rows`` (or
    ``gather_rows_dequant``) over this rank's shard and the
    ``reduce_scatter``, each between two syncs."""
    from vqa_tpu_torch.parallel import mesh as mesh_lib

    times = {"gather": [], "local_gather": [], "reduce_scatter": []}
    real = {"gather_rows": mesh_lib.gather_rows,
            "gather_rows_dequant": mesh_lib.gather_rows_dequant,
            "reduce_scatter_sum": mesh_lib.Mesh.reduce_scatter_sum}

    def timer(fn, name):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    mesh_lib.gather_rows = timer(real["gather_rows"], "local_gather")
    mesh_lib.gather_rows_dequant = timer(real["gather_rows_dequant"], "local_gather")
    mesh_lib.Mesh.reduce_scatter_sum = timer(real["reduce_scatter_sum"], "reduce_scatter")
    try:
        gather = timer(features.gather, "gather")
        for _ in range(3):
            gather(idx)
        for values in times.values():
            del values[:]
        for _ in range(MULTICARD_TIMED):
            gather(idx)
    finally:
        mesh_lib.gather_rows = real["gather_rows"]
        mesh_lib.gather_rows_dequant = real["gather_rows_dequant"]
        mesh_lib.Mesh.reduce_scatter_sum = real["reduce_scatter_sum"]
    return {name: round(statistics.median(v), 4) for name, v in times.items()}


def _train_record(torch, dev, mesh, table, batch, knobs, rank: int, npz: str) -> dict:
    """``_parallel_train`` in a rank, with its launches and a digest of its
    parameters (rank 0 also writes them to ``npz``)."""
    import hashlib

    _reset_counts()
    train = _parallel_train(torch, dev, mesh, table, batch, knobs)
    train["train_counts"] = _read_counts()
    params = train.pop("params")
    digest = hashlib.sha256()
    for key in sorted(params):
        digest.update(params[key].tobytes())
    if rank == 0:
        np.savez(npz, **params)
    train["params_sha"] = digest.hexdigest()
    return train


def _rank_setup(rank: int, world: int, store: str, backend: str = "gloo"):
    """A rank's process joining the world, TF32 off as in the main process:
    (torch, parallel, its device). Over gloo every rank runs on cuda:0 (the
    ranks of [parallel] share one card); over NCCL ([multicard])
    ``parallel.initialize`` gives rank r its own card, cuda:r."""
    import torch

    from vqa_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = "cuda:0" if backend == "gloo" else "cuda"
    return torch, parallel, parallel.initialize(store, world, rank, backend=backend, device=card)


def _parallel_rank(rank: int, world: int, store: str, work: str) -> None:
    """One of (b) and (c)'s ranks, a process of its own on cuda:0 over gloo:
    writes ``rank<r>.json`` (and rank 0 its parameters after (b)'s held
    steps, ``params.npz``) under ``work``."""
    torch, parallel, dev = _rank_setup(rank, world, store)
    try:
        mesh = parallel.make_mesh()
        table, train_batch, eval_batches = _parallel_data()
        train = _train_record(torch, dev, mesh, table, train_batch, None, rank,
                              os.path.join(work, "params.npz"))
        sharded = _parallel_sharded(torch, dev, mesh, table, eval_batches)
        record = dict(rank=rank, device=str(dev), backend=mesh.backend, sharded=sharded, **train)
    finally:
        parallel.shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def _tp_rank(rank: int, world: int, store: str, work: str) -> None:
    """One rank of (d) and (g) (a world of 2: the 1 x 2 mesh) or of (e) (a
    world of 4: 2 x 2), on cuda:0 over gloo: PARALLEL_SGD's steps, and in
    (d) TP_ADAM's too, with the optimizer state sharded over the model
    axis; then (d) the table row-sharded over the world, (e) the bytes of
    adam's moments laid out on its mesh. Writes ``rank<r>.json`` (rank 0
    the parameters of each run, ``<optimizer>.npz``) under ``work``."""
    from vqa_tpu_torch.config import OptimOptions
    from vqa_tpu_torch.engine import optim, steps

    torch, parallel, dev = _rank_setup(rank, world, store)
    try:
        mesh = parallel.make_mesh(TP_MODEL_PARALLEL)
        table, train_batch, eval_batches = _parallel_data()
        record = dict(rank=rank, device=str(dev), backend=mesh.backend,
                      mesh=[mesh.data, mesh.model, mesh.data_index, mesh.model_index])
        runs = {"sgd": PARALLEL_SGD, "adam": TP_ADAM} if world == 2 else {"sgd": PARALLEL_SGD}
        for name, knobs in runs.items():
            record[name] = _train_record(torch, dev, mesh, table, train_batch, knobs, rank,
                                         os.path.join(work, f"{name}.npz"))
        if world == 2:  # (g)
            record["sharded"] = _parallel_sharded(torch, dev, mesh, table, eval_batches)
        else:
            state = parallel.shard_state_tp(steps.create_state(
                _parallel_model(torch, dev, train=True),
                optim.factory(OptimOptions(**TP_ADAM), 1)), mesh)
            record["adam_state_bytes"] = parallel.state_bytes(state.opt_state)
            del state
    finally:
        parallel.shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def _tp_cli_rank(rank: int, world: int, store: str, work: str) -> None:
    """One rank of [parallel] (f) and [multicard] (d)'s preempted runs: the
    train CLI with ``--distributed`` over phase 9's set (its store rebuilt
    here from the same seeds), asked to stop after TP_CLI_PREEMPT_AT steps
    as SIGTERM asks a single process (the flag set in every rank after the
    same step, so the ranks save the preemption checkpoint together). Reads
    ``cli.json`` beside ``work`` (its ``backend``: gloo, the default, puts
    every rank on cuda:0, ``initialize``'s backend forced as NCCL refuses
    two ranks on one card; nccl gives each rank its own card); writes
    ``rank<r>.json``: the CLI's return code, the launches and the rank's
    card."""
    from vqa_tpu_torch.cli import train as train_cli
    from vqa_tpu_torch.engine import engine as engine_lib
    from vqa_tpu_torch.parallel import distributed

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(os.path.dirname(work), "cli.json")) as f:
        spec = json.load(f)
    _place_cli_store(spec["data"])
    initialize, make_train_step = distributed.initialize, train_cli.make_train_step

    def preempting_make_train_step(*args, **kwargs):
        step, done = make_train_step(*args, **kwargs), [0]

        def counted(state, batch, features=None):
            out = step(state, batch, features)
            done[0] += 1
            if done[0] == TP_CLI_PREEMPT_AT:
                engine_lib.request_preemption()
            return out
        return counted

    if spec.get("backend", "gloo") == "gloo":
        distributed.initialize = lambda *a, **k: initialize(
            *a, **dict(k, backend="gloo", device="cuda:0"))
    train_cli.make_train_step = preempting_make_train_step
    _reset_counts()
    rc = train_cli.main(spec["argv"] + ["--coordinator_address", store, "--num_processes",
                                        str(world), "--process_id", str(rank)])
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, rc=rc, counts=_read_counts(),
                       current_device=torch.cuda.current_device(), contexts=_contexts(torch)), f)


def _rank_command(call: str) -> list:
    """The command of a process that runs ``chip_smoke.<call>``."""
    return [sys.executable, "-c", "import chip_smoke; chip_smoke." + call]


def _spawn_ranks(work: str, world: int, what: str, call: str, tag: str = "parallel",
                 env=None) -> list:
    """Run ``world`` processes, each ``chip_smoke.<call>`` with ``r``,
    ``world``, ``store`` (a ``file://`` store under ``work``) and ``work``
    filled in, all at once (``env``: variables added to their environment);
    require each to return 0 (printing a failed rank's log) and return each
    rank's ``rank<r>.json``."""
    os.makedirs(work)
    store = f"file://{work}/store"
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen(
        _rank_command(call.format(r=r, world=world, store=store, work=work)),
        cwd=_REPO, stdout=logs[r], stderr=subprocess.STDOUT,
        env=dict(os.environ, **(env or {}))) for r in range(world)]
    try:
        deadline = time.monotonic() + PARALLEL_TIMEOUT
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, rc in enumerate(rcs):
        if rc != 0:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                print(f.read()[-4000:], file=sys.stderr)
        _require(rc == 0, f"[{tag}] rank {r} of {what} returns 0: {rc}")
    ranks = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _log_records(logs: str, name: str) -> list:
    """A run's JSONL records without their wall-clock fields."""
    with open(os.path.join(logs, name)) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in TIMING_KEYS}
                for line in f]


def _parallel_cli(torch, card: str, tmp: str, context: dict) -> dict:
    """(a): the train CLI over [train_cli]'s synthetic set (its store still
    in the factory's cache) for one epoch, without --distributed, then as a
    world of one over NCCL with the table replicated and row-sharded, then
    without again; each later run's logs (wall-clock fields aside), results
    and checkpointed parameters equal the first run's bit for bit. The
    world of one runs the train step's all_reduce over its NCCL group
    every step, and the sharded run the table's reduce_scatter over NCCL:
    each counted, with its backend, and required. Returns the launch
    counts of the four runs."""
    import io

    from vqa_tpu_torch.cli import train as train_cli
    from vqa_tpu_torch.parallel import Mesh

    collectives = ("all_reduce_mean", "reduce_scatter_sum")
    real = {name: getattr(Mesh, name) for name in collectives}
    calls: dict = {}

    def counted(name):
        def collective(self, *args):
            calls.setdefault((name, self.backend), []).append(1)
            return real[name](self, *args)
        return collective

    base = ["--path_opt", os.path.join(_REPO, "options", "vqa2", "mutan_att.yaml"),
            "--epochs", "1"]
    for o in context["data"] + ["engine.device_features=true", "engine.features_dtype=bfloat16",
                                f"engine.train_bucketing={TRAIN_BUCKET_WINDOW}",
                                "optim.eval_batch_size=1024", "engine.dtype=bfloat16"]:
        base += ["--opt", o]
    runs, counts = {}, dict.fromkeys(_counters(), 0)
    # in turns (single, NCCL, NCCL sharded, single), so a drift of the
    # card's or host's state favours neither side of the timings
    for label, sharded in (("single", None), ("nccl", False), ("nccl_sharded", True),
                           ("single_again", None)):
        logs = os.path.join(tmp, "logs", f"parallel_{label}")
        argv = base + ["--dir_logs", logs]
        if sharded is not None:
            argv += ["--distributed", "--coordinator_address", f"localhost:{_free_port()}",
                     "--num_processes", "1", "--process_id", "0"]
        if sharded:
            argv += ["--opt", "engine.features_sharded=true"]
        _reset_counts()
        calls.clear()
        for name in collectives:
            setattr(Mesh, name, counted(name))
        out, t = io.StringIO(), time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = train_cli.main(argv)
        finally:
            for name, fn in real.items():
                setattr(Mesh, name, fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        torch.cuda.empty_cache()
        _require(rc == 0, f"[parallel] (a) the {label} run returns 0: {rc}\n"
                 f"{out.getvalue()[-3000:]}")
        run_counts = _read_counts()
        for k, c in run_counts.items():
            counts[k] += c
        with open(os.path.join(logs, "metrics.jsonl")) as f:
            (epoch_s,) = [r["epoch_time"] for r in map(json.loads, f) if r.get("split") == "train"]
        # the print steps' times (host clock, each ending in the metrics'
        # readback): the first apart, as it sets up the collectives
        with open(os.path.join(logs, "steps.jsonl")) as f:
            step_s = {r["step"]: r["batch_time"] for r in map(json.loads, f)}
        runs[label] = dict(logs=logs, wall=wall, out=out.getvalue(), counts=run_counts,
                           calls={f"{n}:{b}": len(c) for (n, b), c in calls.items()},
                           epoch_s=epoch_s, first_step_ms=step_s[0] * 1e3,
                           step_ms=statistics.median(v for k, v in step_s.items() if k) * 1e3)
    single = runs["single"]
    for label in ("single", "nccl", "nccl_sharded", "single_again"):
        run, want = runs[label], set()
        if label.startswith("nccl"):
            want = {"all_reduce_mean:nccl"} | ({"reduce_scatter_sum:nccl"} if label.endswith(
                "sharded") else set())
        _require(set(run["calls"]) == want and all(run["calls"].values()),
                 f"[parallel] (a) the {label} run's collectives are {sorted(want)}: "
                 f"{run['calls']}")
    for label in ("nccl", "nccl_sharded", "single_again"):
        run = runs[label]
        _require(("rank 0 of 1 over nccl" in run["out"]) == label.startswith("nccl"),
                 f"[parallel] (a) the {label} run's model line names its rank, world and backend")
        for name in ("metrics.jsonl", "steps.jsonl"):
            _require(_log_records(run["logs"], name) == _log_records(single["logs"], name),
                     f"[parallel] (a) the {label} run's {name} equals the single run's bit for bit")
        for rel in (os.path.join("results", "vqa_OpenEnded_val_epoch0_results.json"),
                    os.path.join("ckpt", "epoch_0000", "params.npz")):
            with open(os.path.join(run["logs"], rel), "rb") as f, \
                    open(os.path.join(single["logs"], rel), "rb") as g:
                _require(f.read() == g.read(),
                         f"[parallel] (a) the {label} run's {rel} equals the single run's")
        _require(all(run["counts"][k] for k in TRAIN_CLI_KERNELS)
                 and run["counts"]["gather_rows"] == single["counts"]["gather_rows"],
                 f"[parallel] (a) the {label} run launched {TRAIN_CLI_KERNELS}, the gather as "
                 f"often as the single run: {run['counts']} {single['counts']}")
    train, val = _log_records(single["logs"], "metrics.jsonl")
    _phase("parallel", part="a", card=card, config="mutan_att.yaml", dtype="bfloat16",
           batch=TRAIN_BATCH, epochs=1, train_loss=round(train["loss"], 5), val_acc1=val["acc1"],
           **{f"{label}_epoch_s": round(run["epoch_s"], 3) for label, run in runs.items()},
           **{f"{label}_{k}": round(run[k], 3) for label, run in runs.items()
              for k in ("first_step_ms", "step_ms")},
           **{f"{label}_wall_s": round(run["wall"], 3) for label, run in runs.items()},
           **{f"{label}_collectives": runs[label]["calls"] for label in ("nccl", "nccl_sharded")},
           bit_equal=True, launches={k: c for k, c in counts.items() if c})
    return counts


def _hold_train(part: str, ranks: list, run, params: dict, ref: dict,
                adam_lr: float = 0.0, tag: str = "parallel", data_axis: int = 1) -> dict:
    """Hold ``part``'s ranks (``run(rank record)``: one train run's record)
    against one process's run ``ref``: the ranks' losses and parameters
    equal to each other's; the losses within PARALLEL_LOSS_RTOL relative;
    ``params`` (rank 0's) within rtol PARALLEL_PARAM_RTOL, atol
    PARALLEL_PARAM_ATOL (sgd), or, under adam (``adam_lr``), each leaf
    within TP_PARAM_REL of its scale and a leaf the softmax does not see
    (its grad 0 but for rounding, which adam scales up to +-lr a step)
    moved by at most lr x steps from the start on both sides, as
    tests/test_torch_train.py holds adam. Over a data axis of more than one
    rank the grads are summed in another order than one process's, and adam
    turns that rounding, in every element whose grad is 0 but for rounding,
    into steps of up to lr: there adam's leaves are held to sgd's bound (the
    JAX package's for its data-parallel step), the softmax-blind ones still
    by lr x steps, and the of-scale excess is a reading. Returns the
    readings."""
    _require(all(run(x)["losses"] == run(ranks[0])["losses"]
                 and run(x)["params_sha"] == run(ranks[0])["params_sha"] for x in ranks),
             f"[{tag}] ({part}) the ranks agree on the losses and parameters bit for bit")
    losses = run(ranks[0])["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    _require(loss_rel <= PARALLEL_LOSS_RTOL,
             f"[{tag}] ({part}) losses within {PARALLEL_LOSS_RTOL} relative of one "
             f"process's: {losses} {ref['losses']}")
    _require(sorted(params) == sorted(ref["params"]),
             f"[{tag}] ({part}) the same parameter names")
    blind = tuple(name.replace(".", "/") for name in SOFTMAX_BLIND)
    start = _start_params() if adam_lr else {}
    worst_abs, worst_excess, of_scale, bit_equal = 0.0, -math.inf, -math.inf, True
    for key, want in ref["params"].items():
        bit_equal &= np.array_equal(params[key], want)
        diff = np.abs(params[key].astype(np.float64) - want)
        worst_abs = max(worst_abs, float(diff.max()))
        tolerance = PARALLEL_PARAM_ATOL + PARALLEL_PARAM_RTOL * np.abs(want)
        if adam_lr and key.endswith(blind):
            moved = max(float(np.abs(x - start[key]).max()) for x in (params[key], want))
            excess = np.asarray(moved - adam_lr * PARALLEL_STEPS * 1.001)
        elif adam_lr:
            scaled = diff - TP_PARAM_REL * max(float(np.abs(want).max()), 1e-3)
            of_scale = max(of_scale, float(scaled.max()))
            excess = scaled if data_axis == 1 else diff - tolerance
        else:
            excess = diff - tolerance
        worst_excess = max(worst_excess, float(excess.max()))
    bound = (f"rtol {PARALLEL_PARAM_RTOL}, atol {PARALLEL_PARAM_ATOL}"
             if not adam_lr or data_axis > 1 else f"{TP_PARAM_REL} of each leaf's scale")
    if adam_lr:
        bound += " (the softmax-blind biases: lr x steps)"
    _require(worst_excess <= 0, f"[{tag}] ({part}) every parameter within {bound} of one "
             f"process's: worst excess {worst_excess}")
    readings = dict(loss_rel_err=loss_rel, param_max_abs_err=worst_abs,
                    param_worst_excess=worst_excess, params_bit_equal_one_process=bit_equal)
    if adam_lr:
        readings["param_worst_excess_of_scale"] = of_scale
    return readings


def _epoch_params_excess(logs: str, ref_logs: str, what: str, adam_lr: float = 0.0):
    """(worst |difference|, worst excess over rtol PARALLEL_PARAM_RTOL, atol
    PARALLEL_PARAM_ATOL) of the epoch-0 checkpointed parameters of the run in
    ``logs`` against those of the run in ``ref_logs``, leaf by leaf. With
    ``adam_lr``, a leaf the softmax does not see (its grad 0 but for
    rounding, which adam scales up to +-lr a step) is held as
    ``_hold_train`` holds it: each run moves it by at most lr a step, so the
    two differ by at most twice lr x steps."""
    rel = os.path.join("ckpt", "epoch_0000")
    blind = tuple(name.replace(".", "/") for name in SOFTMAX_BLIND)
    with open(os.path.join(ref_logs, rel, "state.json")) as f:
        steps = json.load(f)["step"]
    with np.load(os.path.join(logs, rel, "params.npz")) as got, \
            np.load(os.path.join(ref_logs, rel, "params.npz")) as want:
        _require(sorted(got.files) == sorted(want.files), f"{what} the same leaves")
        worst_abs, worst_excess = 0.0, -math.inf
        for key in want.files:
            diff = np.abs(got[key].astype(np.float64) - want[key])
            worst_abs = max(worst_abs, float(diff.max()))
            bound = (2 * adam_lr * steps * 1.001 if adam_lr and key.endswith(blind)
                     else PARALLEL_PARAM_ATOL + PARALLEL_PARAM_RTOL * np.abs(want[key]))
            worst_excess = max(worst_excess, float((diff - bound).max()))
    return worst_abs, worst_excess


def _start_params() -> dict:
    """The seeded weights every (b)-(e) run starts from, on the host."""
    import torch

    from vqa_tpu_torch.weights import export_params

    return export_params(_parallel_model(torch, "cpu", train=True))


def _hold_sharded(part: str, ranks: list, card: str, add, tag: str = "parallel") -> None:
    """(c) and (g): each rank's eval over the row-sharded table against the
    replicated one (``_parallel_sharded``'s records)."""
    for x in ranks:
        for kind, c in x["sharded"].items():
            gather = "gather_rows_dequant" if kind == "int8" else "gather_rows"
            _require(c["rows_equal"] and c["pred_equal"] and c["correct1"][0] == c["correct1"][1],
                     f"[{tag}] ({part}) rank {x['rank']} {kind}: rows, pred and correct1 of "
                     f"the sharded table equal the replicated one's: {c}")
            _require(c["sharded_launches"].get(gather, 0) > 0,
                     f"[{tag}] ({part}) rank {x['rank']} {kind}: {gather} launched over the "
                     f"shard: {c['sharded_launches']}")
            add(c["sharded_launches"])
            add(c["replicated_launches"])
            _phase(tag, part=part, card=card, rank=x["rank"], table=kind,
                   rows=N_IMAGES, rows_here=-(-N_IMAGES // len(ranks)),
                   eval_batches=PARALLEL_EVAL_BATCHES, global_batch=BATCH,
                   rows_bit_equal=True, pred_equal=True, correct1=c["correct1"][1],
                   resident_bytes_replicated=c["resident"][0],
                   resident_bytes_sharded=c["resident"][1],
                   peak_bytes_replicated=c["peak"][0], peak_bytes_sharded=c["peak"][1],
                   negative_zeros=c["negative_zeros"][1],
                   **({"gather_ms": c["ms"]} if c["ms"] else {}),
                   launches=c["sharded_launches"])


def _tensor_parallel_parts(torch, dev, card: str, tmp: str, context: dict, ref: dict,
                           ref_adam: dict, add) -> None:
    """(d)-(g) of the [parallel] phase (see the comment above TP_MODEL_PARALLEL)."""
    # (d) and (g): the 1 x 2 mesh, two ranks sharing the card
    work, t = os.path.join(tmp, "tp_ranks"), time.perf_counter()
    ranks = _spawn_ranks(work, 2, "(d) and (g)", "_tp_rank({r}, {world}, {store!r}, {work!r})")
    wall = time.perf_counter() - t
    for name, one, lr in (("sgd", ref, 0.0), ("adam", ref_adam, TP_ADAM["lr"])):
        with np.load(os.path.join(work, f"{name}.npz")) as npz:
            params = {k: npz[k] for k in npz.files}
        held = _hold_train("d", ranks, lambda x: x[name], params, one, lr)
        for x in ranks:
            run = x[name]
            add(run["train_counts"])
            _require(x["mesh"] == [1, TP_MODEL_PARALLEL, 0, x["rank"]],
                     f"[parallel] (d) rank {x['rank']} sits on the 1 x 2 mesh: {x['mesh']}")
            _phase("parallel", part="d", card=card, rank=x["rank"], optimizer=name,
                   mesh="1x2", backend=x["backend"], dtype="float32", global_batch=TRAIN_BATCH,
                   local_batch=TRAIN_BATCH, steps=PARALLEL_STEPS,
                   losses=[round(v, 6) for v in run["losses"]],
                   one_process_losses=[round(v, 6) for v in one["losses"]], **held,
                   state_bytes=run["state_bytes"], one_process_state_bytes=one["state_bytes"],
                   peak_bytes=run["peak"], one_process_peak_bytes=one["peak"],
                   step_ms=round(run["step_ms"], 3), gather_ms=round(run["gather_ms"], 3),
                   gather_share=round(run["gather_ms"] / run["step_ms"], 4),
                   reduce_ms=round(run["reduce_ms"], 3),
                   reduce_share=round(run["reduce_ms"] / run["step_ms"], 4),
                   one_process_step_ms=round(one["step_ms"], 3), ranks_wall_s=round(wall, 3),
                   launches={k: c for k, c in run["train_counts"].items() if c})
    adam_bytes = ranks[0]["adam"]["state_bytes"]
    _require(all(x["adam"]["state_bytes"] == adam_bytes for x in ranks)
             and adam_bytes < 0.51 * ref_adam["state_bytes"],
             f"[parallel] (d) each rank holds about half of adam's moments: {adam_bytes} of "
             f"{ref_adam['state_bytes']}")
    _hold_sharded("g", ranks, card, add)

    # (e): the 2 x 2 mesh, four ranks sharing the card, sgd
    work, t = os.path.join(tmp, "tp_ranks_2x2"), time.perf_counter()
    ranks = _spawn_ranks(work, 4, "(e)", "_tp_rank({r}, {world}, {store!r}, {work!r})")
    wall = time.perf_counter() - t
    with np.load(os.path.join(work, "sgd.npz")) as npz:
        params = {k: npz[k] for k in npz.files}
    held = _hold_train("e", ranks, lambda x: x["sgd"], params, ref)
    _require([x["mesh"] for x in ranks] == [[2, 2, r // 2, r % 2] for r in range(4)],
             f"[parallel] (e) the ranks sit on the 2 x 2 grid: {[x['mesh'] for x in ranks]}")
    _require(all(x["adam_state_bytes"] == adam_bytes for x in ranks),
             f"[parallel] (e) adam's moments laid out at the model_parallel=2 split, as in (d): "
             f"{[x['adam_state_bytes'] for x in ranks]} {adam_bytes}")
    for x in ranks:
        run = x["sgd"]
        add(run["train_counts"])
        _phase("parallel", part="e", card=card, rank=x["rank"], optimizer="sgd", mesh="2x2",
               backend=x["backend"], dtype="float32", global_batch=TRAIN_BATCH,
               local_batch=TRAIN_BATCH // 2, steps=PARALLEL_STEPS,
               losses=[round(v, 6) for v in run["losses"]], **held,
               adam_state_bytes=x["adam_state_bytes"], peak_bytes=run["peak"],
               step_ms=round(run["step_ms"], 3), gather_ms=round(run["gather_ms"], 3),
               gather_share=round(run["gather_ms"] / run["step_ms"], 4),
               reduce_ms=round(run["reduce_ms"], 3),
               reduce_share=round(run["reduce_ms"] / run["step_ms"], 4),
               ranks_wall_s=round(wall, 3),
               launches={k: c for k, c in run["train_counts"].items() if c})

    # (f): the train CLI as a 1 x 2 world, preempted after a step save, then
    # resumed in one process, against (a)'s single run
    import io

    from vqa_tpu_torch.cli import train as train_cli

    logs = os.path.join(tmp, "logs", "tp_cli")
    argv = ["--path_opt", os.path.join(_REPO, "options", "vqa2", "mutan_att.yaml"),
            "--epochs", "1", "--dir_logs", logs]
    for o in context["data"] + ["engine.device_features=true", "engine.features_dtype=bfloat16",
                                f"engine.train_bucketing={TRAIN_BUCKET_WINDOW}",
                                "optim.eval_batch_size=1024", "engine.dtype=bfloat16"]:
        argv += ["--opt", o]
    work = os.path.join(tmp, "tp_cli_ranks")
    os.makedirs(work)
    with open(os.path.join(work, "cli.json"), "w") as f:
        json.dump(dict(data=context["data"], argv=argv + [
            "--checkpoint_every_steps", str(TP_CLI_CKPT_EVERY), "--distributed",
            "--opt", f"engine.model_parallel={TP_MODEL_PARALLEL}"]), f)
    t = time.perf_counter()
    ranks = _spawn_ranks(os.path.join(work, "ranks"), 2, "(f)",
                         "_tp_cli_rank({r}, {world}, {store!r}, {work!r})")
    tp_wall = time.perf_counter() - t
    _require([x["rc"] for x in ranks] == [75, 75],
             f"[parallel] (f) both ranks of the 1 x 2 run return 75, preempted: {ranks}")
    for x in ranks:
        add(x["counts"])
    with open(os.path.join(logs, "ckpt", "info.json")) as f:
        info = json.load(f)
    _require(info.get("step_latest") == [0, TP_CLI_PREEMPT_AT] and info.get("latest") is None,
             f"[parallel] (f) the 1 x 2 run left its preemption checkpoint: {info}")
    step_dir = os.path.join(logs, "ckpt", f"inepoch_0000_{TP_CLI_PREEMPT_AT:08d}")
    with np.load(os.path.join(step_dir, "params.npz")) as npz:
        shapes = {k: npz[k].shape for k in npz.files}
    with np.load(os.path.join(step_dir, "opt_state.npz")) as npz:
        moments = {k: npz[k].shape for k in npz.files if k.startswith(("0/mu/", "0/nu/"))}
    _require(moments == {f"0/{m}/{k}": s for m in ("mu", "nu") for k, s in shapes.items()},
             "[parallel] (f) the step checkpoint holds adam's moments whole")
    _reset_counts()
    out, t = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(argv + ["--resume", "latest"])
    torch.cuda.synchronize()
    resume_wall = time.perf_counter() - t
    counts = _read_counts()
    add(counts)
    _require(rc == 0 and f"resumed mid-epoch 0 at step {TP_CLI_PREEMPT_AT}" in out.getvalue(),
             f"[parallel] (f) the one-process resume returns 0 from the 1 x 2 run's step "
             f"checkpoint: {rc}\n{out.getvalue()[-3000:]}")
    worst_abs, worst_excess = _epoch_params_excess(
        logs, os.path.join(tmp, "logs", "parallel_single"), "[parallel] (f)")
    _require(worst_excess <= 0,
             f"[parallel] (f) resumed in one process, every parameter within rtol "
             f"{PARALLEL_PARAM_RTOL}, atol {PARALLEL_PARAM_ATOL} of (a)'s uninterrupted run: "
             f"worst excess {worst_excess}")
    _require(all(counts[k] for k in TRAIN_CLI_KERNELS)
             and all(x["counts"][k] for x in ranks for k in TRAIN_CLI_KERNELS),
             f"[parallel] (f) each run launched {TRAIN_CLI_KERNELS}: "
             f"{[x['counts'] for x in ranks]} {counts}")
    _phase("parallel", part="f", card=card, config="mutan_att.yaml", dtype="bfloat16",
           mesh="1x2", backend="gloo", batch=TRAIN_BATCH, preempted_at=TP_CLI_PREEMPT_AT,
           step_saves_every=TP_CLI_CKPT_EVERY, rcs=[x["rc"] for x in ranks],
           tp_wall_s=round(tp_wall, 3), resume_wall_s=round(resume_wall, 3),
           param_max_abs_err=worst_abs, param_worst_excess=worst_excess,
           launches={k: c for k, c in counts.items() if c})


def _parallel_phase(torch, dev, card: str, tmp: str, context: dict) -> dict:
    """The [parallel] phase (see the comment above PARALLEL_WORLD); returns
    its launch counts, every rank's included."""
    from vqa_tpu_torch.parallel.mesh import Mesh

    t_phase = time.perf_counter()
    counts = _parallel_cli(torch, card, tmp, context)

    def add(more):
        for k, c in more.items():
            counts[k] += c

    # (b)'s one-process run first, alone on the card
    table, train_batch, _ = _parallel_data()
    _reset_counts()
    ref = _parallel_train(torch, dev, Mesh(), table, train_batch)
    ref_adam = _parallel_train(torch, dev, Mesh(), table, train_batch, TP_ADAM)
    add(_read_counts())
    del table
    work = os.path.join(tmp, "parallel_ranks")
    ranks = _spawn_ranks(work, PARALLEL_WORLD, "(b) and (c)", "_parallel_rank({r}, {world}, "
                         "{store!r}, {work!r})")
    with np.load(os.path.join(work, "params.npz")) as npz:
        dp = {k: npz[k] for k in npz.files}

    # (b): the ranks hold the global batch's losses and one set of params
    held = _hold_train("b", ranks, lambda x: x, dp, ref)
    for x in ranks:
        add(x["train_counts"])
        _phase("parallel", part="b", card=card, rank=x["rank"], world=PARALLEL_WORLD,
               device=x["device"], backend=x["backend"], dtype="float32",
               global_batch=TRAIN_BATCH, local_batch=TRAIN_BATCH // PARALLEL_WORLD,
               steps=PARALLEL_STEPS, losses=[round(v, 6) for v in x["losses"]],
               one_process_losses=[round(v, 6) for v in ref["losses"]], **held,
               step_ms=round(x["step_ms"], 3), reduce_ms=round(x["reduce_ms"], 3),
               reduce_share=round(x["reduce_ms"] / x["step_ms"], 4),
               one_process_step_ms=round(ref["step_ms"], 3),
               launches={k: c for k, c in x["train_counts"].items() if c})
    # (c): the sharded table against the replicated one, in every rank
    _hold_sharded("c", ranks, card, add)
    # (d)-(g): tensor parallelism
    _tensor_parallel_parts(torch, dev, card, tmp, context, ref, ref_adam, add)
    _phase("parallel", part="total", card=card, s=round(time.perf_counter() - t_phase, 2),
           launches={k: c for k, c in counts.items() if c})
    return counts


# ------------------------------------------------------------- multicard

# [multicard] (``python3 chip_smoke.py --only multicard``, on a host of four
# cards): [parallel]'s paths over NCCL, one rank a card, at mutan_att.yaml's
# full width. (a) One world of four ranks lays out the 4 x 1, 2 x 2 and
# 1 x 4 meshes in turn and runs [parallel] (b)'s float32 steps on each, with
# PARALLEL_SGD and with TP_ADAM, against one process on cuda:0 ([parallel]'s
# bounds; 1 x 4, whose data axis has no reduce, bit-equal to one process);
# (b) each rank's device, tensors, current card and CUDA contexts on its own
# card alone, and the cards' process list read while the ranks live; (c)
# the 1024-image table row-sharded over the four (256 rows each and the
# sink), -0.0 planted in it, bf16 and the int8 pair, bit-equal to the
# replicated table, with NCCL's transports and algorithms from the rank
# logs; (f) train QA/s of MutanAtt as [train] trains it over the four as a
# 4 x 1 mesh at 4 x 128 rows (weak scaling) and at 128 (strong), against one
# card at 128; (d) the train CLI under torchrun as 1 x 4 (the YAML's
# dropout) and as 4 x 1 (no dropout, no answer sampling, no train
# bucketing: a global batch of 128 then holds the same rows as one
# process's), each against one process, each preempted over the four and
# resumed in one process, and the eval CLI over the four against one card;
# (e) flagship.dryrun_multigpu(4) over NCCL.
MULTICARD_WORLD = 4
MULTICARD_MESHES = (1, 2, 4)  # engine.model_parallel of the 4 x 1, 2 x 2 and 1 x 4 meshes
MULTICARD_WARMUP = 3
MULTICARD_TIMED = 20
# NCCL's account of each communicator's transports and each collective's
# algorithm, in the rank logs of (a)-(c)
MULTICARD_NCCL_ENV = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,ENV,TUNING"}


def _contexts(torch) -> list:
    """Whether this process holds a CUDA context on each card: the
    driver's primary context, which PyTorch, NCCL and the kernel library
    share. Reading it makes none."""
    return [bool(torch._C._cuda_hasPrimaryContext(i)) for i in range(torch.cuda.device_count())]


def _placement(torch, dev, devices) -> dict:
    """(b) in a rank: its pid, device and current card, its tensors'
    devices, its contexts, and the bytes its allocator ever handed out on
    each card."""
    contexts = _contexts(torch)
    return dict(pid=os.getpid(), device=str(dev), current_device=torch.cuda.current_device(),
                tensor_devices=sorted(devices), contexts=contexts,
                allocated=[torch.cuda.memory_stats(i).get("allocated_bytes.all.allocated", 0)
                           for i in range(len(contexts))])


def _compute_apps() -> list:
    """The cards' process list from nvidia-smi: a [pid, card index] entry
    for each context."""
    def query(what):
        out = subprocess.run(["nvidia-smi", f"--query-{what}", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        return [[c.strip() for c in line.split(",")] for line in out.splitlines() if line.strip()]

    index = {uuid: int(i) for i, uuid in query("gpu=index,uuid")}
    return [[int(pid), index[uuid]] for pid, uuid in query("compute-apps=pid,gpu_uuid")
            if pid.isdigit() and uuid in index]


def _signed_zeros(table: np.ndarray) -> np.ndarray:
    """``table`` with every 7th value of each row set to -0.0 and every 11th
    to +0.0 (the sharded gather must keep both signs)."""
    out = table.copy()
    flat = out.reshape(len(out), -1)
    flat[:, ::7] = -0.0
    flat[:, 5::11] = 0.0
    return out


def _throughput(torch, dev, mesh, table, global_batch: int) -> dict:
    """(f) in this process: MutanAtt as [train] trains it (bf16 compute over
    float32 parameters, the YAML's adam and dropout) on this rank's slice of
    a global batch of ``global_batch`` rows of PARALLEL_T tokens over
    ``table`` in bf16 on the card: MULTICARD_WARMUP steps, MULTICARD_TIMED
    each between two syncs (the median), then MULTICARD_TIMED back to back
    ending in one sync (the QA/s: global rows over that wall time)."""
    from vqa_tpu_torch.config import OptimOptions
    from vqa_tpu_torch.engine import optim, steps
    from vqa_tpu_torch.flagship import NUM_ANSWERS

    rng = np.random.default_rng(11)
    questions, lengths, image_index, _ = _synthetic_eval_arrays(rng, global_batch,
                                                                 with_table=False)
    lengths = np.minimum(lengths, PARALLEL_T)
    questions = questions[:, :PARALLEL_T] * (np.arange(PARALLEL_T) < lengths[:, None])
    batch = dict(question=questions, length=lengths, image_index=image_index,
                 answer=rng.integers(0, NUM_ANSWERS, global_batch).astype(np.int32))
    local = _local_batch(torch, dev, batch, mesh)
    features = torch.from_numpy(table).to(dev, torch.bfloat16)
    state = steps.create_state(_train_model(torch, dev, "mutan_att"),
                               optim.factory(OptimOptions(**TP_ADAM), 1))
    step = steps.make_train_step(optim.criterion_factory(), seed=0, mesh=mesh)
    for _ in range(MULTICARD_WARMUP):
        state, _ = step(state, local, features)
    step_ms = []
    for _ in range(MULTICARD_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = step(state, local, features)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    for _ in range(MULTICARD_TIMED):
        state, metrics = step(state, local, features)
    loss = float(metrics["loss"])
    wall = time.perf_counter() - t
    del state, features
    torch.cuda.empty_cache()
    return dict(global_batch=global_batch, local_batch=len(local["answer"]),
                step_ms=round(statistics.median(step_ms), 3),
                qa_per_s=round(global_batch * MULTICARD_TIMED / wall, 1), loss=loss)


def _multicard_rank(rank: int, world: int, store: str, work: str) -> None:
    """One rank of (a)-(c) and (f), a process of its own on cuda:<rank> over
    NCCL: writes ``rank<r>.json`` (rank 0 also each run's parameters,
    ``<mesh>_<optimizer>.npz``) under ``work``."""
    torch, parallel, dev = _rank_setup(rank, world, store, backend="nccl")
    try:
        table, train_batch, eval_batches = _parallel_data()
        record, devices, meshes = dict(rank=rank), set(), {}
        for model_parallel in MULTICARD_MESHES:
            mesh = meshes[model_parallel] = parallel.make_mesh(model_parallel)
            name = f"{mesh.data}x{mesh.model}"
            record[name] = dict(mesh=[mesh.data, mesh.model, mesh.data_index, mesh.model_index],
                                backend=mesh.backend)
            for opt_name, knobs in (("sgd", PARALLEL_SGD), ("adam", TP_ADAM)):
                run = _train_record(torch, dev, mesh, table, train_batch, knobs, rank,
                                    os.path.join(work, f"{name}_{opt_name}.npz"))
                devices.update(run["devices"])
                record[name][opt_name] = run
        # (c): the whole world shards the table, whatever the mesh
        record["sharded"] = _parallel_sharded(torch, dev, meshes[1], _signed_zeros(table),
                                              eval_batches, timed=True)
        for c in record["sharded"].values():
            devices.update(c["devices"])
        # (f): one card alone (rank 0, the others waiting), then the four
        record["throughput"] = {}
        if rank == 0:
            record["throughput"]["one"] = _throughput(torch, dev, parallel.Mesh(), table,
                                                      TRAIN_BATCH)
        parallel.barrier()
        for kind, n in (("weak", MULTICARD_WORLD * TRAIN_BATCH), ("strong", TRAIN_BATCH)):
            record["throughput"][kind] = _throughput(torch, dev, meshes[1], table, n)
        record["placement"] = _placement(torch, dev, devices)
        parallel.barrier()
        if rank == 0:
            record["compute_apps"] = _compute_apps()
        parallel.barrier()  # every rank lives while rank 0 reads the process list
    finally:
        parallel.shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def _hold_meshes(ranks: list, ref: dict, card: str, work: str, add, wall: float) -> None:
    """(a): each mesh's ranks against the one-process runs ``ref``."""
    for model_parallel in MULTICARD_MESHES:
        data = MULTICARD_WORLD // model_parallel
        name = f"{data}x{model_parallel}"
        _require([x[name]["mesh"] for x in ranks]
                 == [[data, model_parallel, r // model_parallel, r % model_parallel]
                     for r in range(MULTICARD_WORLD)] and
                 all(x[name]["backend"] == "nccl" for x in ranks),
                 f"[multicard] (a) the ranks sit on the {name} grid over nccl: "
                 f"{[(x[name]['mesh'], x[name]['backend']) for x in ranks]}")
        for opt_name, lr in (("sgd", 0.0), ("adam", TP_ADAM["lr"])):
            one = ref[opt_name]
            with np.load(os.path.join(work, f"{name}_{opt_name}.npz")) as npz:
                params = {k: npz[k] for k in npz.files}
            held = _hold_train("a", ranks, lambda x: x[name][opt_name], params, one, lr,
                               tag="multicard", data_axis=data)
            runs = [x[name][opt_name] for x in ranks]
            if model_parallel == MULTICARD_WORLD:
                _require(held["params_bit_equal_one_process"]
                         and runs[0]["losses"] == one["losses"],
                         f"[multicard] (a) {name} {opt_name}: bit-equal to one process (its data "
                         f"axis has no reduce): {held}")
            # the collectives each axis runs, over NCCL: the data axis' all-reduce
            # wherever it has more than one rank, the model axis' all-gather likewise
            _require(all((run["reduce_ms"] > 0) == (data > 1)
                         and (run["gather_ms"] > 0) == (model_parallel > 1) for run in runs),
                     f"[multicard] (a) {name} {opt_name}: the all-reduce ran over the data axis "
                     f"and the all-gather over the model axis: "
                     f"{[(run['reduce_ms'], run['gather_ms']) for run in runs]}")
            state = [run["state_bytes"] for run in runs]
            if opt_name == "adam":
                rule = _adam_bytes(one["params"], model_parallel)
                _require(state == [rule] * MULTICARD_WORLD
                         and _adam_bytes(one["params"], 1) == one["state_bytes"],
                         f"[multicard] (a) {name}: each rank holds the leaf rule's share of "
                         f"adam's moments, {rule} bytes: {state} of {one['state_bytes']}")
            for run in runs:
                add(run["train_counts"])
            r0 = runs[0]
            _phase("multicard", part="a", card=card, mesh=name, optimizer=opt_name,
                   backend="nccl", dtype="float32", global_batch=TRAIN_BATCH,
                   local_batch=TRAIN_BATCH // data, steps=PARALLEL_STEPS,
                   losses=[round(v, 6) for v in r0["losses"]],
                   one_process_losses=[round(v, 6) for v in one["losses"]], **held,
                   step_ms=[round(run["step_ms"], 3) for run in runs],
                   reduce_ms=[round(run["reduce_ms"], 3) for run in runs],
                   reduce_share=round(r0["reduce_ms"] / r0["step_ms"], 4),
                   gather_ms=[round(run["gather_ms"], 3) for run in runs],
                   gather_share=round(r0["gather_ms"] / r0["step_ms"], 4),
                   one_process_step_ms=round(one["step_ms"], 3), state_bytes=state[0],
                   one_process_state_bytes=one["state_bytes"],
                   peak_bytes=[run["peak"] for run in runs], one_process_peak_bytes=one["peak"],
                   ranks_wall_s=round(wall, 3),
                   launches={k: c for k, c in r0["train_counts"].items() if c})


def _adam_bytes(params: dict, model_parallel: int) -> int:
    """The bytes of adam's two float32 moments on a rank of a row of
    ``model_parallel``, by the leaf rule (``partition.leaf_dim``): a sharded
    leaf's ``1 / model_parallel`` slice, a replicated leaf whole."""
    from vqa_tpu_torch.parallel.partition import leaf_dim

    return sum(8 * (a.size // model_parallel if leaf_dim(a.shape, model_parallel) is not None
                    else a.size) for a in params.values())


def _hold_placement(torch, ranks: list, card: str) -> None:
    """(b): every rank on its own card alone; the main process (the
    one-process runs) on card 0 alone."""
    n = torch.cuda.device_count()
    main_contexts = _contexts(torch)
    _require(main_contexts == [i == 0 for i in range(n)],
             f"[multicard] (b) the main process holds a context on card 0 alone: {main_contexts}")
    for x in ranks:
        p, r = x["placement"], x["rank"]
        own = f"cuda:{r}"
        _require(p["device"] == own and p["current_device"] == r
                 and p["tensor_devices"] == [own],
                 f"[multicard] (b) rank {r} runs on {own} and every tensor it made is there: {p}")
        _require(p["contexts"] == [i == r for i in range(n)],
                 f"[multicard] (b) rank {r} holds a CUDA context on card {r} alone: "
                 f"{p['contexts']}")
        _require([b > 0 for b in p["allocated"]] == [i == r for i in range(n)],
                 f"[multicard] (b) rank {r} allocated on card {r} alone: {p['allocated']}")
    # the process list, read by rank 0 while every rank lived: the count of
    # processes a card (the main process and rank 0 on card 0, a rank on each
    # other); where it shows this run's pids (a container may show others),
    # each on its own card alone
    apps = ranks[0]["compute_apps"]
    pids = {x["placement"]["pid"]: x["rank"] for x in ranks}
    pids[os.getpid()] = 0
    per_card = [sum(card == i for _, card in apps) for i in range(n)]
    if apps:
        _require(per_card == [2] + [1] * (n - 1),
                 f"[multicard] (b) the process list shows two processes on card 0 (the main "
                 f"process and rank 0) and one on each other card: {apps}")
    visible = sorted({pid for pid, _ in apps} & set(pids))
    for pid in visible:
        _require({card for p, card in apps if p == pid} == {pids[pid]},
                 f"[multicard] (b) process {pid} is listed on card {pids[pid]} alone: {apps}")
    _phase("multicard", part="b", card=card, ranks=len(ranks),
           devices=[x["placement"]["device"] for x in ranks],
           current_devices=[x["placement"]["current_device"] for x in ranks],
           contexts=[[i for i, c in enumerate(x["placement"]["contexts"]) if c] for x in ranks],
           main_contexts=[i for i, c in enumerate(main_contexts) if c],
           allocated_bytes=[x["placement"]["allocated"][x["rank"]] for x in ranks],
           process_list=apps, processes_a_card=per_card,
           pids_listed=f"{len(visible)} of {len(pids)}")


def _nccl_summary(log: str) -> dict:
    """What NCCL_DEBUG=INFO printed in a rank's log: its version, the
    transports its channels connected over, its NVLS (NVLink SHARP) lines
    and each collective's algorithm and protocol, each kind deduplicated
    with the numbers masked."""
    import re

    version, transports, nvls, algos, connected = None, set(), {}, {}, set()
    with open(log, errors="replace") as f:
        for line in f:
            if "NCCL INFO" not in line:
                continue
            text = line.split("NCCL INFO", 1)[1].strip()
            masked = re.sub(r"0x[0-9a-f]+|\d+", "#", text)
            found = re.search(r"NCCL version (\S+)", text)
            version = found.group(1) if found else version
            found = re.search(r" via (\S+)", text)
            if found:
                transports.add(found.group(1))
            if text.startswith("NVLS") or "nvls channels" in text:
                nvls.setdefault(masked, text)
            if " -> Algo " in text:
                algos.setdefault(masked, text)
            if text.startswith("Connected"):
                connected.add(masked)
    return dict(version=version, transports=sorted(transports), nvls=list(nvls.values())[:6],
                algorithms=list(algos.values())[:8], connected=sorted(connected))


def _hold_sharded_multicard(ranks: list, card: str, work: str, add) -> None:
    """(c): [parallel]'s hold of the sharded table, the planted -0.0 kept,
    each rank's share of the table, the gather's parts timed, and NCCL's
    transports and algorithms."""
    _hold_sharded("c", ranks, card, add, tag="multicard")
    for x in ranks:
        c = x["sharded"]["bf16"]
        _require(c["negative_zeros"][1] > 0,
                 f"[multicard] (c) rank {x['rank']}: the planted -0.0 values reach the rows "
                 f"through the sharded gather: {c['negative_zeros']}")
        for kind, c in x["sharded"].items():
            _require(c["resident"][1] < 0.26 * c["resident"][0],
                     f"[multicard] (c) rank {x['rank']} {kind}: a quarter of the table and its "
                     f"sink row here: {c['resident']}")
    _phase("multicard", part="c_nccl", card=card,
           **_nccl_summary(os.path.join(work, "rank0.log")))


def _hold_throughput(ranks: list, card: str) -> None:
    """(f): reported, not held, beyond finite losses."""
    one_card = ranks[0]["throughput"]["one"]
    _require(all(math.isfinite(run["loss"]) for x in ranks for run in x["throughput"].values()),
             "[multicard] (f) finite losses")
    for kind in ("weak", "strong"):
        runs = [x["throughput"][kind] for x in ranks]
        qa = min(run["qa_per_s"] for run in runs)
        _phase("multicard", part="f", card=card, scaling=kind, arch="MutanAtt", dtype="bfloat16",
               optimizer="adam", dropout="yaml", cards=MULTICARD_WORLD,
               global_batch=runs[0]["global_batch"], local_batch=runs[0]["local_batch"],
               step_ms=[run["step_ms"] for run in runs], qa_per_s=qa,
               qa_per_s_by_rank=[run["qa_per_s"] for run in runs],
               one_card_step_ms=one_card["step_ms"], one_card_qa_per_s=one_card["qa_per_s"],
               one_card_batch=one_card["global_batch"],
               speedup=round(qa / one_card["qa_per_s"], 3))


@contextlib.contextmanager
def _track_writes(root: str):
    """Record every file under ``root`` that this process opens for writing
    or renames into place, as paths relative to ``root``."""
    import builtins
    import io

    root = os.path.realpath(root)
    seen: list = []
    real = {"open": builtins.open, "replace": os.replace, "rename": os.rename}

    def note(path):
        if isinstance(path, (str, bytes, os.PathLike)):
            path = os.path.realpath(os.fsdecode(path))
            if path.startswith(root + os.sep):
                seen.append(os.path.relpath(path, root))

    def tracked_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            note(file)
        return real["open"](file, mode, *args, **kwargs)

    def tracked_move(name):
        def move(src, dst, *args, **kwargs):
            note(dst)
            return real[name](src, dst, *args, **kwargs)
        return move

    builtins.open = io.open = tracked_open
    os.replace, os.rename = tracked_move("replace"), tracked_move("rename")
    try:
        yield seen
    finally:
        builtins.open = io.open = real["open"]
        os.replace, os.rename = real["replace"], real["rename"]


def _place_cli_store(data: list):
    """Phase 9's store in the dataset factory's cache (rebuilt from its
    seeds), for the options ``data``."""
    from vqa_tpu_torch.config import load_options
    from vqa_tpu_torch.datasets import factory as data_factory

    opt = load_options(os.path.join(_REPO, "options", "vqa2", "mutan_att.yaml"), data)
    host_table = _synthetic_eval_arrays(np.random.default_rng(0), BATCH * N_BATCHES)[-1]
    data_factory.place_store(opt.coco.dir, opt.coco.arch, opt.coco.mode, _cli_store(host_table))


def _torchrun_rank(spec_path: str) -> None:
    """A torchrun worker of (d): phase 9's store placed, then the train CLI's
    main with the spec's ``argv`` (``--distributed`` with no address: the
    cluster from torchrun's environment), the files it writes under the
    run's logs recorded; writes ``rank<RANK>.json`` beside the spec and
    exits with the CLI's code."""
    import torch

    from vqa_tpu_torch.cli import train as train_cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    _place_cli_store(spec["data"])
    _reset_counts()
    with _track_writes(spec["logs"]) as writes:
        rc = train_cli.main(spec["argv"])
    rank = int(os.environ["RANK"])
    with open(os.path.join(os.path.dirname(spec_path), f"rank{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, local_rank=int(os.environ["LOCAL_RANK"]), rc=rc,
                       counts=_read_counts(), writes=sorted(set(writes)),
                       current_device=torch.cuda.current_device(), contexts=_contexts(torch)), f)
    sys.exit(rc)


def _torchrun(work: str, data: list, argv: list, logs: str) -> tuple:
    """The train CLI under ``python -m torch.distributed.run --standalone
    --nproc_per_node MULTICARD_WORLD``, each worker ``_torchrun_rank``;
    requires torchrun to return 0 within PARALLEL_TIMEOUT (printing its log
    otherwise); returns (its output, each rank's record)."""
    import signal

    os.makedirs(work)
    spec = os.path.join(work, "spec.json")
    with open(spec, "w") as f:
        json.dump(dict(data=data, argv=argv, logs=logs), f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(MULTICARD_WORLD), "--no-python", *_rank_command(f"_torchrun_rank({spec!r})")]
    log = os.path.join(work, "torchrun.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=_REPO, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=PARALLEL_TIMEOUT)
        except subprocess.TimeoutExpired:
            rc = "timeout"
        finally:
            if proc.poll() is None:  # torchrun stops its workers on SIGTERM
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
    with open(log, errors="replace") as f:
        out = f.read()
    if rc != 0:
        print(out[-6000:], file=sys.stderr)
    _require(rc == 0, f"[multicard] (d) torchrun returns 0: {rc}")
    ranks = []
    for r in range(MULTICARD_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return out, ranks


def _cli_main(torch, argv: list) -> tuple:
    """The train CLI's main in this process: (return code, output, seconds,
    launch counts)."""
    import io

    from vqa_tpu_torch.cli import train as train_cli

    _reset_counts()
    out, t = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), time.perf_counter() - t, _read_counts()


def _val_record(logs: str) -> dict:
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r.get("split") == "val"][-1]


def _answers(logs: str) -> dict:
    """The run's one results json: question_id -> answer."""
    (name,) = os.listdir(os.path.join(logs, "results"))
    with open(os.path.join(logs, "results", name)) as f:
        return {r["question_id"]: r["answer"] for r in json.load(f)}


def _hold_world_ranks(what: str, ranks: list, out: str, data: int, model: int) -> None:
    """(d): each torchrun rank on its own card (LOCAL_RANK), named in the
    CLI's model line, with exactly the path's kernels launched; rank 0 alone
    wrote the run's files."""
    for x in ranks:
        r = x["rank"]
        _require(x["rc"] == 0 and x["local_rank"] == r and x["current_device"] == r
                 and x["contexts"] == [i == r for i in range(MULTICARD_WORLD)],
                 f"[multicard] (d) {what}: rank {r} returned 0 on cuda:{r} (LOCAL_RANK) alone: "
                 f"{x['rc']} {x['local_rank']} {x['current_device']} {x['contexts']}")
        _require(f"rank {r} of {MULTICARD_WORLD} over nccl, mesh {data} x {model}" in out,
                 f"[multicard] (d) {what}: rank {r}'s model line names its place")
        _require({k for k, c in x["counts"].items() if c} == set(TRAIN_CLI_KERNELS),
                 f"[multicard] (d) {what}: rank {r} launched {TRAIN_CLI_KERNELS}: {x['counts']}")
        _require(bool(x["writes"]) == (r == 0),
                 f"[multicard] (d) {what}: rank 0 alone wrote the run's files; rank {r} wrote "
                 f"{x['writes'][:8]}")


def _multicard_cli(torch, card: str, tmp: str, add) -> None:
    """(d) (see the comment above MULTICARD_WORLD)."""
    from vqa_tpu_torch.datasets import factory as data_factory

    yaml = os.path.join(_REPO, "options", "vqa2", "mutan_att.yaml")
    _write_raw_vqa2(os.path.join(tmp, "vqa2", "raw"), np.random.default_rng(0))
    data = [f"vqa.dir={tmp}/vqa2", f"coco.dir={tmp}/coco"]
    common = data + ["engine.device_features=true", "optim.eval_batch_size=1024"]
    bf16 = ["engine.features_dtype=bfloat16", "engine.dtype=bfloat16"]

    def flags(opts):
        return [a for o in opts for a in ("--opt", o)]

    def logs(label):
        return os.path.join(tmp, "logs", label)

    _place_cli_store(data)
    try:
        # (name, options of the world and of its one-process run, data axis,
        # model axis, adam's lr where the softmax-blind leaves are held as
        # _hold_train holds them). 4 x 1 runs float32, the YAML's dtype: in
        # bf16 a rank's 32 rows take other GEMM plans than one process's
        # 128, whose rounding adam carries past the bound within steps
        worlds = (("1x4", bf16 + [f"engine.train_bucketing={TRAIN_BUCKET_WINDOW}"], 1,
                   MULTICARD_WORLD, 0.0),
                  ("4x1", ["engine.dtype=float32", "engine.features_dtype=float32",
                           "engine.train_bucketing=0", "vqa.samplingans=false"]
                   + _no_dropout("mutan_att"), MULTICARD_WORLD, 1, TP_ADAM["lr"]))
        for name, opts, data_axis, model_axis, adam_lr in worlds:
            argv = ["--path_opt", yaml, "--epochs", "1"] + flags(common + opts)
            distributed = ["--distributed", "--opt", f"engine.model_parallel={model_axis}"]
            # one process on cuda:0, the reference
            rc, out, single_s, counts = _cli_main(torch, argv + ["--dir_logs", logs(f"{name}_one")])
            add(counts)
            _require(rc == 0, f"[multicard] (d) {name}: the one-process run returns 0: {rc}\n"
                     f"{out[-3000:]}")
            # the same under torchrun over the four cards, with step saves
            t = time.perf_counter()
            out, ranks = _torchrun(os.path.join(tmp, f"torchrun_{name}"), data, argv + [
                "--dir_logs", logs(f"{name}_torchrun"), "--checkpoint_every_steps",
                str(TRAIN_CLI_CKPT_EVERY)] + distributed, logs(f"{name}_torchrun"))
            world_s = time.perf_counter() - t
            _hold_world_ranks(f"{name} train", ranks, out, data_axis, model_axis)
            for x in ranks:
                add(x["counts"])
            writes = ranks[0]["writes"]
            _require(all(any(w.startswith(p) for w in writes)
                         for p in ("metrics.jsonl", "steps.jsonl", "results/", "ckpt/epoch_0000",
                                   "ckpt/info.json")),
                     f"[multicard] (d) {name}: rank 0 wrote the logs, results and checkpoints: "
                     f"{writes}")
            world_abs, world_excess = _epoch_params_excess(
                logs(f"{name}_torchrun"), logs(f"{name}_one"), f"[multicard] (d) {name}", adam_lr)
            _require(world_excess <= 0,
                     f"[multicard] (d) {name} under torchrun: every parameter within rtol "
                     f"{PARALLEL_PARAM_RTOL}, atol {PARALLEL_PARAM_ATOL} of one process's: worst "
                     f"excess {world_excess} (worst difference {world_abs})")
            # preempted over the four after TP_CLI_PREEMPT_AT steps, resumed in one process
            work = os.path.join(tmp, f"preempt_{name}")
            os.makedirs(work)
            with open(os.path.join(work, "cli.json"), "w") as f:
                json.dump(dict(data=data, backend="nccl", argv=argv + [
                    "--dir_logs", logs(f"{name}_preempted"), "--checkpoint_every_steps",
                    str(TP_CLI_CKPT_EVERY)] + distributed), f)
            t = time.perf_counter()
            pre = _spawn_ranks(os.path.join(work, "ranks"), MULTICARD_WORLD, f"(d) {name}",
                               "_tp_cli_rank({r}, {world}, {store!r}, {work!r})", tag="multicard")
            preempt_s = time.perf_counter() - t
            _require([x["rc"] for x in pre] == [75] * MULTICARD_WORLD
                     and [x["current_device"] for x in pre] == list(range(MULTICARD_WORLD)),
                     f"[multicard] (d) {name}: every rank, each on its own card, returns 75: "
                     f"{[(x['rc'], x['current_device']) for x in pre]}")
            for x in pre:
                add(x["counts"])
            with open(os.path.join(logs(f"{name}_preempted"), "ckpt", "info.json")) as f:
                info = json.load(f)
            _require(info.get("step_latest") == [0, TP_CLI_PREEMPT_AT],
                     f"[multicard] (d) {name}: the preemption checkpoint is there: {info}")
            rc, out, resume_s, counts = _cli_main(
                torch, argv + ["--dir_logs", logs(f"{name}_preempted"), "--resume", "latest"])
            add(counts)
            _require(rc == 0 and f"resumed mid-epoch 0 at step {TP_CLI_PREEMPT_AT}" in out,
                     f"[multicard] (d) {name}: the one-process resume returns 0 from the step "
                     f"checkpoint: {rc}\n{out[-3000:]}")
            resume_abs, resume_excess = _epoch_params_excess(
                logs(f"{name}_preempted"), logs(f"{name}_one"), f"[multicard] (d) {name}",
                adam_lr)
            _require(resume_excess <= 0,
                     f"[multicard] (d) {name} preempted and resumed in one process: every "
                     f"parameter within rtol {PARALLEL_PARAM_RTOL}, atol {PARALLEL_PARAM_ATOL} of "
                     f"the uninterrupted one-process run: worst excess {resume_excess}")
            _phase("multicard", part="d", card=card, config="mutan_att.yaml", world=name,
                   dtype="bfloat16" if adam_lr == 0 else "float32", batch=TRAIN_BATCH,
                   dropout="yaml" if adam_lr == 0 else "off",
                   one_process_s=round(single_s, 3), torchrun_s=round(world_s, 3),
                   param_max_abs_err=world_abs, param_worst_excess=world_excess,
                   rank0_writes=len(writes), preempted_at=TP_CLI_PREEMPT_AT,
                   preempted_rcs=[x["rc"] for x in pre], preempt_s=round(preempt_s, 3),
                   resume_s=round(resume_s, 3), resumed_param_max_abs_err=resume_abs,
                   resumed_param_worst_excess=resume_excess,
                   val_acc1=[_val_record(logs(f"{name}{s}"))["acc1"]
                             for s in ("_one", "_torchrun", "_preempted")])
        # the eval CLI over the four cards (replica-fed, 256 rows a rank of
        # each batch of 1024) against one card, on the 1 x 4 reference's weights
        params = os.path.join(logs("1x4_one"), "ckpt", "epoch_0000", "params.npz")
        argv = ["--path_opt", yaml, "-e"] + flags(common + bf16
                                                  + [f"model.pretrained_params={params}"])
        rc, out, one_s, counts = _cli_main(torch, argv + ["--dir_logs", logs("eval_one")])
        add(counts)
        _require(rc == 0, f"[multicard] (d) the one-card eval returns 0: {rc}\n{out[-3000:]}")
        out, ranks = _torchrun(os.path.join(tmp, "torchrun_eval"), data,
                               argv + ["--dir_logs", logs("eval_four"), "--distributed"],
                               logs("eval_four"))
        _hold_world_ranks("eval", ranks, out, MULTICARD_WORLD, 1)
        for x in ranks:
            add(x["counts"])
        one, four = _answers(logs("eval_one")), _answers(logs("eval_four"))
        _require(sorted(one) == sorted(four) and len(one) == CLI_QUESTIONS,
                 f"[multicard] (d) the four-card eval answers every val question once: "
                 f"{len(four)} of {len(one)}")
        agree = sum(one[q] == four[q] for q in one) / len(one)
        _require(agree >= PRED_AGREE_FLOOR,
                 f"[multicard] (d) the four-card eval's answers agree with one card's on at "
                 f"least {PRED_AGREE_FLOOR}: {agree}")
        val = {k: _val_record(logs(k)) for k in ("eval_one", "eval_four")}
        _phase("multicard", part="d_eval", card=card, config="mutan_att.yaml", dtype="bfloat16",
               questions=len(one), batch=BATCH, rows_a_rank=BATCH // MULTICARD_WORLD,
               agreement=round(agree, 6), floor=PRED_AGREE_FLOOR,
               acc1_one_card=val["eval_one"]["acc1"], acc1_four_cards=val["eval_four"]["acc1"],
               qa_per_sec_one_card=val["eval_one"]["qa_per_sec"],
               qa_per_sec_four_cards=val["eval_four"]["qa_per_sec"], one_card_s=round(one_s, 3))
    finally:
        data_factory.drop_stores(f"{tmp}/coco")


def _multicard_phase(torch, dev, card: str, tmp: str) -> dict:
    """The [multicard] phase (see the comment above MULTICARD_WORLD);
    returns its launch counts, every rank's included."""
    import io

    from vqa_tpu_torch import flagship
    from vqa_tpu_torch.parallel import Mesh

    t_phase = time.perf_counter()
    counts = dict.fromkeys(_counters(), 0)

    def add(more):
        for k, c in more.items():
            counts[k] += c

    # the one-process runs on cuda:0, alone on the cards
    table, train_batch, _ = _parallel_data()
    _reset_counts()
    ref = {"sgd": _parallel_train(torch, dev, Mesh(), table, train_batch),
           "adam": _parallel_train(torch, dev, Mesh(), table, train_batch, TP_ADAM)}
    add(_read_counts())
    del table
    # (a)-(c) and (f): one world of four NCCL ranks, one a card
    work, t = os.path.join(tmp, "ranks"), time.perf_counter()
    ranks = _spawn_ranks(work, MULTICARD_WORLD, "(a)-(c) and (f)",
                         "_multicard_rank({r}, {world}, {store!r}, {work!r})", tag="multicard",
                         env=MULTICARD_NCCL_ENV)
    wall = time.perf_counter() - t
    _hold_meshes(ranks, ref, card, work, add, wall)
    _hold_placement(torch, ranks, card)
    _hold_sharded_multicard(ranks, card, work, add)
    _hold_throughput(ranks, card)
    del ref
    # (d): the CLIs under torchrun
    _multicard_cli(torch, card, tmp, add)
    # (e): the port's counterpart of __graft_entry__.dryrun_multichip
    out, t = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(out):
        first = flagship.dryrun_multigpu(MULTICARD_WORLD, platform="cuda",
                                         timeout=PARALLEL_TIMEOUT)
    mesh = first["mesh"]
    _require((mesh["data"], mesh["model"], mesh["backend"]) == (2, 2, "nccl"),
             f"[multicard] (e) dryrun_multigpu(4) ran the 2 x 2 mesh over nccl: {mesh}")
    _phase("multicard", part="e", card=card, mesh="2x2", backend=mesh["backend"],
           losses=[round(v, 5) for v in first["losses"]], sharded_leaves=first["sharded_leaves"],
           s=round(time.perf_counter() - t, 2), said=out.getvalue().strip().splitlines()[-1])
    _phase("multicard", part="total", card=card, s=round(time.perf_counter() - t_phase, 2),
           launches={k: c for k, c in counts.items() if c})
    return counts


def _multicard_main(torch, t_start: float) -> int:
    """``--only multicard``: the device lines of every card and their
    topology, the kernels built once here, then the [multicard] phase."""
    from vqa_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    lines = smi.strip().splitlines()
    for line in lines:
        print(line, flush=True)
    # the links between the cards (a container may refuse the topology query;
    # NCCL's transports in [multicard] (c) name them too)
    for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "--status", "-i", "0"]):
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        print(f"$ {' '.join(cmd)}: exit {proc.returncode}\n"
              + (proc.stdout + proc.stderr).rstrip()[:3000], flush=True)
    t0 = time.perf_counter()
    log = _build.build()  # here, before any rank loads the library
    _build.library()
    _phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
           torch=torch.__version__, cuda=torch.version.cuda,
           build_s=round(time.perf_counter() - t0, 2), built=bool(log))
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multicard_") as tmp:
        _multicard_phase(torch, dev, lines[0], tmp)
    _phase("total", wall_s=round(time.perf_counter() - t_start, 2))
    print(lines[0], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# the phases of a run with no argument, in the order they run (one card);
# --only multicard runs the device phase and [multicard] alone
PHASES = ("device", "kernels", "f32_kernels", "eval", "serve", "grid", "f32_path", "eval_cli",
          "data", "train_ops", "train", "train_cli", "export", "parallel", "fixture_matrix",
          "extract", "large_shapes")
ONLY = {"multicard": ("device", "multicard")}


def _phases(argv) -> tuple:
    """The phases the command line asks for: PHASES, or with ``--only
    NAME`` those of ONLY[NAME]; argparse refuses any other name."""
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of vqa_tpu_torch on CUDA cards.")
    parser.add_argument("--only", choices=sorted(ONLY),
                        help="run this phase alone (multicard: four cards of one host)")
    args = parser.parse_args(argv)
    return ONLY[args.only] if args.only else PHASES


def main(argv=None) -> int:
    import torch

    phases = _phases(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a CUDA "
              "card and has no CPU path", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "multicard" in phases:
        count = torch.cuda.device_count()
        if count < MULTICARD_WORLD:
            print(f"chip_smoke: --only multicard runs {MULTICARD_WORLD} ranks, one a card, and "
                  f"this host has {count} card(s); it does not run fewer", file=sys.stderr)
            return 1
        return _multicard_main(torch, t_start)
    from vqa_tpu_torch.ops import _build

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
    # 2b. each kernel's float32 entry against its plain version in float32
    _check_f32_kernels(torch, dev, rng, kernels)

    # 3. eval step (bf16 and int8 tables), 4. serve and 5. grid, each arch at
    # full width, one after another
    launches = dict.fromkeys(kernels, 0)
    for arch in ARCHS:
        features, int8_features = tables["pooled" if arch in NOATT_ARCHS else "regions"]
        for name, c in _arch_phases(torch, dev, arch, features, int8_features,
                                    eval_data).items():
            launches[name] += c
    _require(all(c > 0 for c in launches.values()), f"every kernel launched: {launches}")
    # 12. the float32 path (mutan_att.yaml as written), its parts where their
    # data lives: the eval step here, the eval CLI in 6, the train step after
    # 8, export after 10
    f32_launches = dict.fromkeys(kernels, 0)

    def add_f32(counts):
        for name, c in counts.items():
            launches[name] += c
            f32_launches[name] += c

    add_f32(_f32_eval_phase(torch, dev, eval_data, host_table))

    # 6. the eval CLI over a processed split
    cli_counts, f32_cli_counts = _eval_cli_phase(torch, dev, host_table, pooled_table)
    for name, c in cli_counts.items():
        launches[name] += c
    for name, c in f32_cli_counts.items():
        f32_launches[name] += c
    # 15. the data path: the native prep against the Python one, item_loader
    # feeding the eval step, the per-item IO path
    card = smi.strip().splitlines()[0]
    data_counts, forced_python = _data_phase(torch, dev, host_table, tables["regions"][0], card)
    for name, c in data_counts.items():
        launches[name] += c

    # 7. the train path's two autograd Functions, 8. training
    train_ops = _check_train_ops(torch, dev, rng, card)
    for name, c in _train_phase(torch, dev, host_table, tables["regions"][0],
                                tables["pooled"][0], card).items():
        launches[name] += c
    add_f32(_f32_train_phase(torch, dev, host_table))
    # 9. the train CLI: checkpoints, SIGTERM, resume, eval and serve from
    # them; 10. export, serve --exported and visu over its runs
    from vqa_tpu_torch.datasets import factory as data_factory

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_cli_") as tmp:
        counts, context = _train_cli_phase(torch, dev, host_table, card, tmp)
        try:
            counts = [counts, _export_phase(torch, dev, card, tmp, context)]
            add_f32(_f32_export(torch, dev, tmp, context))
            # 14. data parallelism across processes, over 9's synthetic set
            counts.append(_parallel_phase(torch, dev, card, tmp, context))
        finally:
            data_factory.drop_stores(f"{tmp}/coco")
    for phase_counts in counts:
        for name, c in phase_counts.items():
            launches[name] += c
    # 13. the fixture matrix: every graded config trained, evaluated and
    # scored through the train CLI, in both dtypes, over both tables, against
    # the host, at full width, on the other layouts and traced
    with tempfile.TemporaryDirectory(prefix="chip_smoke_matrix_") as tmp:
        for name, c in _fixture_matrix_phase(torch, card, tmp).items():
            launches[name] += c
    # 11. a ResNet-152 checkpoint through the import tool, the extract CLI's
    # function over 1024 images, and the eval CLI over the table it gave
    for name, c in _extract_phase(torch, dev, card, kernels).items():
        launches[name] += c
    # 17. the designs for every shape the JAX package computes, and the eval
    # CLI over the 3136-region grid of a 1792-pixel extract
    for name, c in _large_shapes_phase(torch, dev, card, kernels).items():
        launches[name] += c
    for name, by_shape in train_ops.items():
        kernels[name]["train_fwd_bwd_ms"] = {k: round(t["fwd_bwd_ms"], 4)
                                             for k, t in by_shape.items()}
        kernels[name]["train_plain_fwd_bwd_ms"] = {k: round(t["plain_fwd_bwd_ms"], 4)
                                                   for k, t in by_shape.items()}

    # every prep of the run but [data]'s forced one went through the native
    # encoder (the ranks of [parallel] read [train_cli]'s processed files)
    from vqa_tpu_torch.datasets.processed import ENCODERS

    _require(ENCODERS["python"] == forced_python and ENCODERS["native"] > 0,
             f"[data] every prep but the forced one encoded natively: {dict(ENCODERS)}")
    _phase("data", part="encoders", native_splits=ENCODERS["native"],
           python_splits=ENCODERS["python"], forced_python=forced_python)
    f32_kernels = ("gather_rows", "lstm_seq", "glimpse_head", "glimpse_attend", "mfb_pool",
                   "relation_attend")
    _require(all(f32_launches[k] > 0 for k in f32_kernels),
             f"[f32_path] every float32 entry launched on the float32 path: {f32_launches}")
    _phase("f32_path", part="total", launches={k: c for k, c in f32_launches.items() if c})
    record = []
    for name, k in kernels.items():
        source, replaces = SOURCES[name]
        if name in f32_kernels:
            k["f32_launches"] = f32_launches[name]
            if name == "lstm_seq":
                k["f32_source"] = "vqa_tpu_torch/csrc/lstm_f32.cu"
        record.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                       "launches": launches[name],
                       **{key: k.pop(key) for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms")}, **k})
    _phase("multicard", run=False, why="needs four cards of one host",
           command="python3 chip_smoke.py --only multicard")
    _phase("total", wall_s=round(time.perf_counter() - t_start, 2))
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
