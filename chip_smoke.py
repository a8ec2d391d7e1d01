#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vqa_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line of what it found:
  1. device: refuse to run without a card; print the card's name and power
     limit; build the kernels from csrc/ (nvcc, sm_90a) and time the build;
  2. kernels: gather_rows, lstm_seq and glimpse_head against their plain
     PyTorch versions on the card, at the flagship's eval shapes (batch
     1024), at its serving shapes (batch 64, questions of 26 tokens) and
     at odd shapes, with each tolerance stated, and timed (median of
     CUDA-event timings) beside the plain version;
  3. eval: the flagship MutanAtt at full width, bf16, random seeded weights,
     through the port's eval step over a feature table resident on the card
     (bench.py's synthetic data, batch 1024, the {7, 13, 26} ladder);
     kernel path held against the plain path; all three kernels launched;
  4. serve: the port's Predictor behind the port's AnswerService,
     DynamicBatcher and HTTP server (vqa_tpu_torch.cli.serve); /healthz,
     /answer and an oversized /batch, answers held equal to direct
     Predictor calls and to the plain path's on the same inputs.

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
#   each step rounds at 2^-9 relative, carried through up to 26 steps;
# - glimpse_head rounds alpha to bf16 before the weighted sum (as the TPU
#   kernel did) and its outputs to bf16: |attended| <= max|v| ~ 5 and
#   |logits| ~ 3 give up to ~0.01 of rounding each.
LSTM_ATOL = 0.05
GLIMPSE_ATOL = 0.05
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

BUCKETS = (7, 13, 26)
BATCH = 1024
SERVE_BATCH = 64  # the serving CLI's default --max_batch
N_BATCHES = 8
N_IMAGES = 1024
SEQ, REGIONS, DIM = 26, 36, 2048


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


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# --------------------------------------------------------------- kernels


def _check_gather(torch, dev, rng):
    from vqa_tpu_torch.ops.gather import gather_rows, gather_rows_reference

    # the flagship shape last, so its table and indices are the ones timed
    for n, tail, b in ((37, (36, 72), 53), (11, (3, 5), 29), (48, (REGIONS, DIM), SERVE_BATCH),
                       (N_IMAGES, (REGIONS, DIM), BATCH)):
        table = torch.randn((n,) + tail, device=dev).to(torch.bfloat16)
        idx = rng.integers(0, n, b)
        idx[: b // 4] = idx[0]  # repeated rows
        out = gather_rows(table, idx)
        ref = gather_rows_reference(table, torch.from_numpy(idx).to(dev))
        torch.cuda.synchronize()
        _require(torch.equal(out, ref), f"gather_rows {tuple(table.shape)} x {b} is bit-exact")
    ms = _median_ms(torch, lambda: gather_rows(table, idx))
    plain = _median_ms(
        torch, lambda: gather_rows_reference(table, torch.from_numpy(idx).to(dev))
    )
    _phase("gather_rows", shapes="1024x36x2048[1024],48x36x2048[64],37x36x72[53],11x3x5[29]",
           max_abs_err=0.0, tol="exact", ms=round(ms, 4), plain_ms=round(plain, 4))
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "shape": "table 1024x36x2048 bf16, B=1024"}


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


def _check_lstm(torch, dev, rng):
    from vqa_tpu_torch.ops.lstm import lstm_seq, lstm_seq_reference

    worst, timing = 0.0, {}
    for T, B, H in ((7, BATCH, 2400), (13, BATCH, 2400), (26, BATCH, 2400),
                    (26, SERVE_BATCH, 2400), (5, 37, 40), (4, 37, 42)):
        xg, mask, wh = _lstm_inputs(torch, dev, rng, T, B, H)
        h_last, seq = lstm_seq(xg, mask, wh)
        ref_h, ref_seq = lstm_seq_reference(xg.float(), mask.float(), wh.float())
        torch.cuda.synchronize()
        err = max((h_last.float() - ref_h).abs().max().item(),
                  (seq.float() - ref_seq).abs().max().item())
        bf16_h, bf16_seq = lstm_seq_reference(xg, mask, wh)
        plain_err = max((bf16_h.float() - ref_h).abs().max().item(),
                        (bf16_seq.float() - ref_seq).abs().max().item())
        _require(bool(torch.isfinite(seq).all()), f"lstm_seq T={T} B={B} H={H} finite")
        _require(err <= LSTM_ATOL, f"lstm_seq T={T} B={B} H={H}: err {err} <= {LSTM_ATOL}")
        worst = max(worst, err)
        line = dict(T=T, B=B, H=H, max_abs_err=round(err, 5), plain_bf16_err=round(plain_err, 5),
                    tol=LSTM_ATOL)
        if H == 2400:
            ms = _median_ms(torch, lambda: lstm_seq(xg, mask, wh), iters=10)
            plain = _median_ms(torch, lambda: lstm_seq_reference(xg, mask, wh), iters=10)
            timing[f"T{T}_B{B}"] = (ms, plain)
            line.update(ms=round(ms, 4), plain_ms=round(plain, 4))
        _phase("lstm_seq", **line)
        del xg, mask, wh, h_last, seq, ref_h, ref_seq, bf16_h, bf16_seq
    ms, plain = timing[f"T7_B{BATCH}"]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "shape": "T=7 B=1024 H=2400 bf16",
            "ms_by_shape": {k: round(v[0], 4) for k, v in timing.items()},
            "plain_ms_by_shape": {k: round(v[1], 4) for k, v in timing.items()}}


def _check_glimpse(torch, dev, rng):
    from vqa_tpu_torch.ops.attention import glimpse_head, glimpse_head_reference

    worst, timing = 0.0, None
    for B, R, M, G, D in ((BATCH, REGIONS, 510, 2, DIM), (SERVE_BATCH, REGIONS, 510, 2, DIM),
                          (37, 36, 45, 2, 72), (5, 7, 33, 3, 75)):
        joint = torch.tanh(torch.randn(B, R, M, device=dev)).to(torch.bfloat16)
        w = (torch.randn(M, G, device=dev) / M ** 0.5).to(torch.bfloat16)
        b = (0.1 * torch.randn(G, device=dev)).to(torch.bfloat16)
        v = torch.randn(B, R, D, device=dev).to(torch.bfloat16)
        att, logits = glimpse_head(joint, w, b, v)
        ref_att, ref_logits = glimpse_head_reference(joint.float(), w.float(), b.float(), v.float())
        torch.cuda.synchronize()
        err = max((att.float() - ref_att).abs().max().item(),
                  (logits.float() - ref_logits).abs().max().item())
        _require(err <= GLIMPSE_ATOL, f"glimpse_head {(B, R, M, G, D)}: err {err} <= {GLIMPSE_ATOL}")
        worst = max(worst, err)
        line = dict(B=B, R=R, M=M, G=G, D=D, max_abs_err=round(err, 5), tol=GLIMPSE_ATOL)
        if B == BATCH:
            ms = _median_ms(torch, lambda: glimpse_head(joint, w, b, v))
            plain = _median_ms(torch, lambda: glimpse_head_reference(joint, w, b, v))
            timing = (ms, plain)
            line.update(ms=round(ms, 4), plain_ms=round(plain, 4))
        _phase("glimpse_head", **line)
    return {"max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
            "shape": "B=1024 R=36 M=510 G=2 D=2048 bf16"}


# --------------------------------------------------------------- main path


def _counters():
    from vqa_tpu_torch.ops.attention import glimpse_head
    from vqa_tpu_torch.ops.gather import gather_rows
    from vqa_tpu_torch.ops.lstm import lstm_seq

    return {"gather_rows": gather_rows, "lstm_seq": lstm_seq, "glimpse_head": glimpse_head}


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
    from vqa_tpu_torch.models import att, seq2vec
    from vqa_tpu_torch.ops.attention import glimpse_head_reference
    from vqa_tpu_torch.ops.gather import gather_rows_reference
    from vqa_tpu_torch.ops.lstm import lstm_seq_reference

    def plain_gather(table, idx):
        return gather_rows_reference(
            table, torch.as_tensor(np.asarray(idx), dtype=torch.long).to(table.device))

    saved = (seq2vec.lstm_seq, att.glimpse_head, steps.gather_rows, predictor.gather_rows)
    seq2vec.lstm_seq = lambda xg, mask, wh, train=False: lstm_seq_reference(xg, mask, wh)
    att.glimpse_head = glimpse_head_reference
    steps.gather_rows = predictor.gather_rows = plain_gather
    try:
        yield
    finally:
        seq2vec.lstm_seq, att.glimpse_head, steps.gather_rows, predictor.gather_rows = saved


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


def _eval_phase(torch, dev, model, features, questions, lengths, image_index):
    from vqa_tpu_torch.engine import steps
    from vqa_tpu_torch.flagship import NUM_ANSWERS

    n = BATCH * N_BATCHES
    answers = np.random.default_rng(2).integers(0, NUM_ANSWERS, n).astype(np.int64)
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
    _require(all(c > 0 for c in counts.values()), f"every kernel launched in the eval run: {counts}")

    preds = torch.cat([o["pred"] for o in outs]).cpu().numpy()
    _require(preds.shape == (n,) and ((preds >= 0) & (preds < NUM_ANSWERS)).all(),
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
    worst, sure_rows, sure_agree = 0.0, 0, 0

    def logits_of(b):
        return model(steps._resolve_visual(b, features), b["question"]).float()

    with torch.inference_mode():
        for b, pk, pp in zip(batches, np.split(preds, N_BATCHES), np.split(plain_preds, N_BATCHES)):
            lk = logits_of(b)
            with _plain_ops(torch):
                lp = logits_of(b)
            _require(bool(torch.isfinite(lk).all()), "finite logits")
            worst = max(worst, (lk - lp).abs().max().item())
            top2 = torch.topk(lp, 2, dim=-1).values
            sure = ((top2[:, 0] - top2[:, 1]) > 2 * LOGITS_ATOL).cpu().numpy()
            sure_rows += int(sure.sum())
            sure_agree += int((pk[sure] == pp[sure]).sum())
    agree = float((preds == plain_preds).mean())
    _require(worst <= LOGITS_ATOL, f"eval logits err {worst} <= {LOGITS_ATOL}")
    _require(sure_agree == sure_rows, f"pred equal wherever the top-2 margin exceeds "
             f"2*{LOGITS_ATOL}: {sure_agree}/{sure_rows}")
    _require(agree >= PRED_AGREE_FLOOR, f"pred agreement {agree} >= {PRED_AGREE_FLOOR}")
    _phase("eval", batches=N_BATCHES, batch=BATCH, buckets=[b["question"].shape[1] for b in batches],
           launches=counts, n=tot["n"], n_labeled=tot["n_labeled"], correct1=tot["correct1"],
           correct5=tot["correct5"], logits_max_abs_err=round(worst, 5), tol=LOGITS_ATOL,
           pred_agree=round(agree, 5), floor=PRED_AGREE_FLOOR,
           first_pass_s=round(first_s, 4), kernel_pass_s=round(kernel_s, 4),
           plain_pass_s=round(plain_s, 4),
           kernel_qa_per_s=round(n / kernel_s, 1), plain_qa_per_s=round(n / plain_s, 1))
    return counts


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


def _serve_phase(torch, model, features):
    from vqa_tpu_torch.cli.serve import AnswerService, DynamicBatcher, build_server
    from vqa_tpu_torch.flagship import NUM_ANSWERS, NUM_WORDS
    from vqa_tpu_torch.predictor import Catalog, Predictor

    max_batch, n_images = SERVE_BATCH, 48
    words = ["<pad>", "<unk>"] + [f"w{i}" for i in range(2, NUM_WORDS)]
    names = [f"COCO_val2014_{i:012d}" for i in range(n_images)]
    catalog = Catalog({w: i for i, w in enumerate(words)},
                      [f"answer{i}" for i in range(NUM_ANSWERS)],
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
                            [im for _, im, _ in singles] + ims, max_batch, NUM_ANSWERS)
    finally:
        server.shutdown()
        server.server_close()
        service.shutdown()
        thread.join(timeout=30)
    _require(not thread.is_alive(), "server thread stopped")
    _require(counts["lstm_seq"] > 0 and counts["glimpse_head"] > 0,
             f"lstm_seq and glimpse_head launched while serving: {counts}")
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
    _phase("serve", requests=5, rows=103, max_batch=max_batch, launches=counts,
           answers_equal_direct=True, prob_max_rel_err_vs_plain=round(worst, 6),
           tol=round(PROB_RTOL, 6), top1_equal_plain=f"{sure_agree}/{sure_rows}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a CUDA "
              "card and has no CPU path", file=sys.stderr)
        return 1
    from vqa_tpu_torch import flagship
    from vqa_tpu_torch.ops import _build
    from vqa_tpu_torch.weights import random_params

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

    # 2. kernels against their plain versions
    rng = np.random.default_rng(0)
    kernels = {
        "gather_rows": _check_gather(torch, dev, rng),
        "lstm_seq": _check_lstm(torch, dev, rng),
        "glimpse_head": _check_glimpse(torch, dev, rng),
    }

    # 3. eval step and 4. serve, flagship at full width
    model = flagship.build(dtype=torch.bfloat16, device=dev)
    random_params(model, seed=0)
    questions, lengths, image_index, table = _synthetic_eval_arrays(
        np.random.default_rng(0), BATCH * N_BATCHES)
    features = torch.from_numpy(table).to(dev, torch.bfloat16)
    del table
    eval_counts = _eval_phase(torch, dev, model, features, questions, lengths, image_index)
    serve_counts = _serve_phase(torch, model, features)

    sources = {"gather_rows": ("vqa_tpu_torch/csrc/gather.cu", "vqa_tpu/ops/gather.py:58"),
               "lstm_seq": ("vqa_tpu_torch/csrc/lstm.cu", "vqa_tpu/ops/lstm.py:93"),
               "glimpse_head": ("vqa_tpu_torch/csrc/glimpse_head.cu",
                                "vqa_tpu/ops/attention.py:132")}
    record = []
    for name, k in kernels.items():
        source, replaces = sources[name]
        record.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                       "launches": eval_counts[name] + serve_counts[name],
                       "max_abs_err": k.pop("max_abs_err"), "ms": k.pop("ms"),
                       "plain_ms": k.pop("plain_ms"), **k})
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
