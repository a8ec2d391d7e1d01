"""Where one eval pass's (or train pass's) device time goes, by
``torch.profiler`` (CUPTI).

    python -m vqa_tpu_torch.tools.profile_eval [ARCH[:int8] ...]
    python -m vqa_tpu_torch.tools.profile_eval --train [ARCH ...]

For each arch (default: MutanAtt MFBCoAtt CoR; any of ``ARCHS``) at the
full width of its ``options/vqa2`` config (or ``flagship.VARIANTS`` entry),
bf16, random weights (seed 0): 8 eval batches of 1024 over a 1024-image
table resident on the card (the NoAtt archs: its regions' mean, the pooled
[1024, 2048] table), with VQA v2 question lengths (mean ~6.2, sd ~2.2,
clipped to [3, 26]) sorted into the {7, 13, 26} buckets, as
``chip_smoke.py`` runs them; ``:int8`` runs the same over the table's int8
quantization (bf16 scales). Two warm-up passes, one pass timed on the host
clock, then one profiled pass. Prints one JSON line per arch: the device
span (first kernel's start to last kernel's end), busy time (union of kernel
intervals), idle share, kernel count, device time by class (each
hand-written kernel by name, GEMMs, elementwise, reductions, other), largest
first, and the kernels that take the most time by name. The profiler's own
overhead is inside the span.

``--train`` (default arch: MutanAtt; any of ``ARCHS``) profiles the train
step instead: the training build (float32 parameters, bf16 compute,
the YAML's dropout, adam at lr 1e-4), 8 steps of batch 128 over the same
kind of batches (the {7, 13, 26} buckets of sorted VQA v2 lengths, random
answers of the 2000), the same warm-up and timing; the record adds the
time a step takes on the host clock.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ARCHS = {"MutanAtt": "mutan_att", "MFBCoAtt": "mfb_coatt", "MFHCoAtt": "mfh_coatt", "CoR": "cor",
         "ConcatAtt": "concat_att", "MLBAtt": "mlb_att", "MutanNoAtt": "mutan_noatt",
         "MLBNoAtt": "mlb_noatt", "ConcatNoAtt": "concat_noatt",
         "MutanAtt+skipthoughts": "mutan_att_skipthoughts"}
NOATT = ("MutanNoAtt", "MLBNoAtt", "ConcatNoAtt")  # these read the pooled table
TRAIN_BATCH = 128  # the YAMLs' optim.batch_size
TOP = 8  # kernels listed by name
BUCKETS = (7, 13, 26)
BATCH, N_BATCHES, N_IMAGES, SEQ, REGIONS, DIM = 1024, 8, 1024, 26, 36, 2048
# kernel name -> class; the first pattern that matches wins
CLASSES = (
    ("lstm_seq", r"lstm_seq_kernel|lstm_step_kernel"),
    ("gather_rows_dequant", r"gather_rows_dequant"),
    ("gather_rows", r"gather_rows"),
    # both glimpse entries (csrc/glimpse_head.cu's ring and parent kernels)
    ("glimpse", r"glimpse"),
    ("mfb_pool", r"mfb_pool"),
    ("relation_attend", r"relation"),
    ("gemm", r"gemm|nvjet|cutlass|sm80_|sm90_|cublas|xmma"),
    ("reduction", r"reduce|Reduce|softmax|norm"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"),
)


def _classify(name: str) -> str:
    for cls, pattern in CLASSES:
        if re.search(pattern, name):
            return cls
    return "other"


def _batches(dev, rng, batch=BATCH, train=False):
    """N_BATCHES batches of ``batch`` sorted VQA v2 lengths in their buckets;
    for ``train`` with random answers of the 2000."""
    from vqa_tpu_torch.flagship import NUM_ANSWERS, NUM_WORDS

    n = batch * N_BATCHES
    questions = rng.integers(1, NUM_WORDS, (n, SEQ), dtype=np.int32)
    lengths = np.clip(np.round(rng.normal(6.2, 2.2, n)), 3, SEQ).astype(np.int32)
    questions *= (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    image_index = rng.integers(0, N_IMAGES, n).astype(np.int32)
    order = np.argsort(lengths, kind="stable")
    questions, lengths, image_index = questions[order], lengths[order], image_index[order]
    answers = rng.integers(0, NUM_ANSWERS, n) if train else np.zeros(n, np.int64)
    out = []
    for i in range(N_BATCHES):
        sl = slice(i * batch, (i + 1) * batch)
        t_b = next(b for b in BUCKETS if b >= lengths[sl].max())
        out.append({"question": torch.from_numpy(questions[sl, :t_b]).to(dev),
                    "length": torch.from_numpy(lengths[sl]).to(dev),
                    "image_index": image_index[sl],
                    "answer": torch.from_numpy(answers[sl]).to(dev),
                    "valid": torch.ones(batch, dtype=torch.bool, device=dev)})
    return out


def _kernel_events(trace_path: str):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e]


def profile(arch: str, int8: bool, dev, train: bool = False) -> dict:
    from vqa_tpu_torch.config import OptimOptions
    from vqa_tpu_torch.engine import optim
    from vqa_tpu_torch.engine.steps import (create_state, make_eval_step, make_train_step,
                                            quantize_features)
    from vqa_tpu_torch.flagship import NUM_WORDS, answer_count, build_config, model_options
    from vqa_tpu_torch.models.factory import factory
    from vqa_tpu_torch.weights import random_params

    rng = np.random.default_rng(0)
    table = rng.standard_normal((N_IMAGES, REGIONS, DIM), dtype=np.float32)
    if arch in NOATT:
        table = table.mean(axis=1)
    if int8:
        values, scales = quantize_features(table)
        features = (torch.from_numpy(values).to(dev), torch.from_numpy(scales).to(dev,
                                                                                torch.bfloat16))
    else:
        features = torch.from_numpy(table).to(dev, torch.bfloat16)
    if train:
        batches = _batches(dev, rng, TRAIN_BATCH, train=True)
        model = factory(model_options(name=ARCHS[arch]), NUM_WORDS, answer_count(ARCHS[arch]),
                        dtype=torch.bfloat16, device=dev, train=True)
        random_params(model, seed=0)
        state = create_state(model, optim.factory(OptimOptions(lr=1e-4)))
        train_step = make_train_step(optim.criterion_factory(), seed=0)

        def run_pass():
            for b in batches:
                train_step(state, b, features)
            torch.cuda.synchronize()
    else:
        batches = _batches(dev, rng)
        model = build_config(ARCHS[arch], dtype=torch.bfloat16, device=dev)
        random_params(model, seed=0)
        eval_step = make_eval_step()

        def run_pass():
            for b in batches:
                eval_step(model, b, features)
            torch.cuda.synchronize()

    run_pass()
    run_pass()
    t0 = time.perf_counter()
    run_pass()
    host_s = time.perf_counter() - t0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_pass()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kernels = _kernel_events(path)
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel on the card")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for s, e in spans:  # union of the intervals, in us
        if e > end:
            busy += e - max(s, end)
            end = e
    span = spans[-1][1] - spans[0][0]
    by_class, by_name = {}, {}
    for e in kernels:
        for key, totals in ((_classify(e["name"]), by_class), (e["name"], by_name)):
            t, n = totals.get(key, (0.0, 0))
            totals[key] = (t + float(e["dur"]), n + 1)
    del model, features
    torch.cuda.empty_cache()
    return {
        "arch": arch, "table": "int8+bf16_scales" if int8 else "bf16",
        "pass": (f"train, {N_BATCHES} steps of {TRAIN_BATCH}" if train
                 else f"eval, {N_BATCHES} batches of {BATCH}"),
        "buckets": [b["question"].shape[1] for b in batches],
        "span_ms": span / 1e3, "busy_ms": busy / 1e3, "idle_share": 1 - busy / span,
        "kernels": len(kernels), "host_pass_s": host_s, "host_step_s": host_s / N_BATCHES,
        "by_class": {cls: {"ms": t / 1e3, "share_of_busy": t / busy, "launches": n}
                     for cls, (t, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0])},
        "top_kernels": [{"name": name[:120], "class": _classify(name), "ms": t / 1e3,
                         "launches": n}
                        for name, (t, n) in sorted(by_name.items(),
                                                   key=lambda kv: -kv[1][0])[:TOP]],
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profile_eval needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    train = "--train" in argv
    argv = [a for a in argv if a != "--train"]
    for spec in argv or (["MutanAtt"] if train else ["MutanAtt", "MFBCoAtt", "CoR"]):
        arch, _, table = spec.partition(":")
        if arch not in ARCHS or table not in ("", "int8"):
            raise SystemExit(f"unknown arch {spec!r}: one of "
                             f"{sorted(ARCHS)}, optionally :int8")
        rec = profile(arch, table == "int8", dev, train=train)
        rec["device"] = smi
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
