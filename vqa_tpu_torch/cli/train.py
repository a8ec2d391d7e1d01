"""Evaluation CLI, the port of ``vqa_tpu/cli/train.py``'s eval-only path.

  python -m vqa_tpu_torch.cli.train --path_opt options/vqa2/mutan_att.yaml -e \\
      --opt model.pretrained_params=exported/params.npz [--split val|test|testdev]
  python -m vqa_tpu_torch.cli.train ... --platform cpu   # on the host, no card

The argument parser is the JAX CLI's, flag for flag, so one command line
runs against either package. The raw VQA files under ``vqa.dir`` are
prepared on first use (``datasets.factory``); the split runs through the
loader (sorted by length, questions cut to the ``{7, maxlength/2,
maxlength}`` ladder or ``engine.eval_buckets``, the last batch padded) and
the eval step, and ``metrics.jsonl`` and
``results/vqa_OpenEnded_<split>_epoch<e>_results.json`` land under
``logs.dir_logs`` as the JAX CLI writes them. With
``engine.device_features`` the feature table lives on the card
(``engine.features_dtype``: float32, bfloat16, or int8 values with per-row
scales) and the step gathers its rows there.

It runs on the card, where the model computes in bf16 (the kernels take
bf16), unless ``--platform cpu`` asks for the host (then in
``engine.dtype``); without a card it fails and says so. The weights come
from ``model.pretrained_params``, a '/'-keyed npz (``python -m
vqa_tpu.cli.export --params external`` writes one), with
``model.seq2vec.pretrained_emb`` and ``pretrained_encoder`` grafted under it
as the JAX CLI grafts them. What is not ported refuses and names its
ROADMAP.md item: training (the train step and epoch loop are ported, the
CLI around them with its checkpoints is not), ``--resume``, multi-process
and model-parallel runs, and a sharded table.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

import torch

from vqa_tpu_torch.config import Options, dump_options, load_options
from vqa_tpu_torch.datasets.factory import factory as dataset_factory
from vqa_tpu_torch.datasets.pipeline import BatchIterator, normalize_buckets
from vqa_tpu_torch.engine import engine as engine_lib
from vqa_tpu_torch.engine.logger import Experiment
from vqa_tpu_torch.engine.steps import make_eval_step, quantize_features
from vqa_tpu_torch.models.factory import factory as model_factory
from vqa_tpu_torch.weights import load_params, pretrained_params


def build_argparser() -> argparse.ArgumentParser:
    """``vqa_tpu/cli/train.py``'s parser, flag for flag."""
    p = argparse.ArgumentParser(description="vqa_tpu_torch trainer (eval-only)")
    p.add_argument("--path_opt", required=True, help="model YAML under options/")
    p.add_argument("--dir_logs", default=None, help="override logs.dir_logs")
    p.add_argument("-e", "--evaluate", action="store_true", help="eval-only on --split")
    p.add_argument("--split", default="val", choices=["val", "test", "testdev"],
                   help="eval-only split; test/testdev emit results json "
                        "(EvalAI submission schema) without scoring")
    p.add_argument("--resume", default=None, help="best | latest | <epoch>")
    p.add_argument("--save_model", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--save_all_from", type=int, default=None)
    p.add_argument("--checkpoint_every_steps", type=int, default=None,
                   help="mid-epoch preemption points every N train steps "
                        "(engine.checkpoint_steps)")
    p.add_argument("-lr", "--lr", "--learning_rate", dest="lr",
                   type=float, default=None)
    p.add_argument("-b", "--batch_size", dest="batch_size",
                   type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--vqa_trainsplit", default=None,
                   help="train | trainval (maps to vqa.trainsplit)")
    p.add_argument("--start_epoch", type=int, default=None)
    p.add_argument("--print_freq", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--workers", type=int, default=None, help="accepted for CLI compat")
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--platform", default=None, metavar="cuda|cpu",
                   help="where to run: the card (default) or, with cpu, the host")
    p.add_argument(
        "--opt", action="append", default=[], metavar="KEY=VAL",
        help="override any config leaf, e.g. --opt model.fusion.R=10",
    )
    p.add_argument("--distributed", action="store_true",
                   help="multi-process run (not ported)")
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def options_from_args(args) -> Options:
    # named flags carry already-typed values; pass them as tuples so they skip
    # the YAML re-parse (--lr 1e-5 reprs as '1e-05', not valid YAML 1.1)
    overrides: list = []
    named = {
        "logs.dir_logs": args.dir_logs,
        "optim.lr": args.lr,
        "optim.batch_size": args.batch_size,
        "optim.epochs": args.epochs,
        "engine.print_freq": args.print_freq,
        "engine.checkpoint_steps": args.checkpoint_every_steps,
        "engine.seed": args.seed,
        "engine.profile_dir": args.profile_dir,
        "vqa.trainsplit": args.vqa_trainsplit,
    }
    for key, val in named.items():
        if val is not None:
            overrides.append((key, val))
    overrides.extend(args.opt)
    return load_options(args.path_opt, overrides)


def _refuse_unported(args, opt: Options) -> None:
    if not args.evaluate:
        raise NotImplementedError(
            "the train CLI is not ported yet: its loop with checkpoints is ROADMAP.md queue 1, "
            "item 5b, with item 13's checkpoints (the train step itself runs: "
            "vqa_tpu_torch.engine.steps.make_train_step); run eval-only with -e")
    if args.resume is not None:
        raise NotImplementedError(
            "--resume reads an Orbax checkpoint, which needs jax; the port's own "
            "checkpoints are ROADMAP.md queue 1, item 13. Pass the weights as "
            "--opt model.pretrained_params=<npz>")
    for refused, what in ((args.distributed, "--distributed"),
                          (opt.engine.model_parallel > 1, "engine.model_parallel > 1"),
                          (opt.engine.features_sharded, "engine.features_sharded")):
        if refused:
            raise NotImplementedError(
                f"{what}: multi-GPU runs are not ported yet (ROADMAP.md queue 1, item 12)")
    if opt.engine.profile_dir:
        raise NotImplementedError(
            "engine.profile_dir traces with jax.profiler; the port's eval profile is "
            "python -m vqa_tpu_torch.tools.profile_eval")
    if not opt.model.pretrained_params:
        raise ValueError(
            "-e needs --opt model.pretrained_params=<npz> (python -m vqa_tpu.cli.export "
            "--params external writes one): the port cannot reproduce flax's init "
            "stream, and its own checkpoints are ROADMAP.md queue 1, item 13")


def _device(platform: Optional[str]) -> torch.device:
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(f"--platform {platform!r}: the port runs on the card (cuda) "
                         "or, with --platform cpu, on the host")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: torch.cuda.is_available() is false, and the port's CLI has no "
            "fallback; pass --platform cpu to run on the host")
    return torch.device("cuda")


def _device_table(store, opt: Options, device: torch.device,
                  input_dtype: Optional[torch.dtype]):
    """The feature table on ``device`` in ``engine.features_dtype``, as
    ``vqa_tpu/cli/train.py`` places it: int8 values with per-row scales
    (bf16 under a bf16 compute dtype, else float32), bfloat16, or as stored."""
    table = store.as_array()
    if opt.engine.features_dtype == "int8":
        values, scales = quantize_features(table)
        features = (torch.from_numpy(values).to(device),
                    torch.from_numpy(scales).to(input_dtype or torch.float32).to(device))
        print(f"device feature table: {values.shape} int8+scales "
              f"({(values.nbytes + scales.nbytes)/1e9:.2f} GB)", flush=True)
        return features
    host = torch.from_numpy(table)
    if opt.engine.features_dtype == "bfloat16":
        host = host.to(torch.bfloat16)
    features = host.to(device)
    print(f"device feature table: {tuple(features.shape)} {features.dtype} "
          f"({features.nbytes/1e9:.2f} GB)", flush=True)
    return features


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    opt = options_from_args(args)
    _refuse_unported(args, opt)
    device = _device(args.platform)
    dtype = torch.bfloat16 if device.type == "cuda" else getattr(torch, opt.engine.dtype)
    input_dtype = None if dtype == torch.float32 else dtype
    run_dir = opt.logs.dir_logs
    dump_options(opt, run_dir)
    exp = Experiment(run_dir)
    try:
        visual_mode = "index" if opt.engine.device_features else "gather"
        val_set = dataset_factory("val", opt, visual_mode=visual_mode)
        model = model_factory(dataclasses.asdict(opt.model), val_set.num_words,
                              val_set.num_answers, dtype=dtype, device=device,
                              dim_v=val_set.feature_shape[-1])
        load_params(model, pretrained_params(opt.model))
        n_params = sum(p.numel() for p in model.parameters())
        print(f"model {opt.model.arch}: {n_params/1e6:.2f}M params, {device} {dtype}",
              flush=True)

        transform = engine_lib.make_device_transform(device, input_dtype)
        eval_bs = opt.optim.eval_batch_size or opt.optim.batch_size
        # eval-time length bucketing (right-pad only); the default ladder
        # {7, maxlength/2, maxlength} is the JAX CLI's
        eval_buckets = normalize_buckets(
            opt.engine.eval_buckets
            or sorted({min(7, opt.vqa.maxlength), (opt.vqa.maxlength + 1) // 2}),
            opt.vqa.maxlength,
        )
        bucketing = (
            dict(sort_by_length=True, length_buckets=eval_buckets)
            if opt.vqa.pad == "right"
            else {}
        )
        features = (_device_table(val_set.features, opt, device, input_dtype)
                    if opt.engine.device_features else None)
        eval_step = make_eval_step()
        epoch = args.start_epoch if args.start_epoch is not None else 0
        if args.split in ("test", "testdev"):
            test_set = dataset_factory(args.split, opt, visual_mode=visual_mode)
            test_loader = BatchIterator(test_set, eval_bs, shuffle=False, pad_last=True,
                                        transform=transform, **bucketing)
            results = engine_lib.test(test_loader, model, eval_step,
                                      test_set.vocabs.aid_to_ans, exp, epoch,
                                      split=args.split, features=features)
            print(f"{args.split}: {len(results)} answers emitted", flush=True)
            return 0
        val_loader = BatchIterator(val_set, eval_bs, shuffle=False, pad_last=True,
                                   transform=transform, **bucketing)
        acc1, _ = engine_lib.validate(val_loader, model, eval_step, val_set.vocabs.aid_to_ans,
                                      exp, epoch, features=features)
        print(f"val acc1: {acc1*100:.2f}", flush=True)
        return 0
    finally:
        exp.close()


if __name__ == "__main__":
    sys.exit(main())
