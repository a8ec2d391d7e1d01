"""Training / evaluation CLI, the port of ``vqa_tpu/cli/train.py``.

  python -m vqa_tpu_torch.cli.train --path_opt options/vqa2/mutan_att.yaml     # train
  python -m vqa_tpu_torch.cli.train --path_opt ... --resume latest             # continue
  python -m vqa_tpu_torch.cli.train --path_opt ... -e --resume best            # eval-only
  python -m vqa_tpu_torch.cli.train ... --platform cpu   # on the host, no card

The argument parser is the JAX CLI's, flag for flag, so one command line
runs against either package. The raw VQA files under ``vqa.dir`` are
prepared on first use (``datasets.factory``), and the log then names the
question encoder of each split it prepared (``prep: splits by question
encoder {'native': 2}``). Training runs the epoch loop
of the JAX CLI: the train split through the loader (shuffled from
``engine.seed``, ``drop_last``, with ``engine.train_bucketing`` bucketed
shuffling into the ``{7, maxlength/2, maxlength}`` ladder), the train step,
then the val split through the eval loop, a checkpoint of the epoch under
``<dir_logs>/ckpt`` (``engine/checkpoint.py``: ``best``/``latest``, and with
``--checkpoint_every_steps`` one mid-epoch step checkpoint) and the "new
best" line. ``--resume latest`` continues a run bit for bit, from the step
checkpoint when it is newer than the last epoch; on SIGTERM (under
``--save_model``) the loop saves a step checkpoint at the next step and the
CLI returns 75. With ``engine.device_features`` one feature table, the
store the splits share, lives on the card (``engine.features_dtype``:
float32, bfloat16, or int8 values with per-row scales) and the steps gather
its rows there. ``metrics.jsonl``, ``steps.jsonl`` and the results json
land under ``logs.dir_logs`` as the JAX CLI writes them.

It runs on the card unless ``--platform cpu`` asks for the host; without a
card it fails and says so. On either device the model computes in
``engine.dtype`` (``config.compute_dtype``: float32 as ``options/default.yaml``
sets it, or ``--opt engine.dtype=bfloat16``; the card's kernels take both,
and training keeps float32 master parameters), and the log's model line
names the device and the dtype. Weights start from flax's initial distributions
(``weights.init_params``, seeded by ``engine.seed``) with
``model.seq2vec.pretrained_emb``, ``pretrained_encoder`` and
``model.pretrained_params`` grafted over them, or come from the run's
checkpoint with ``--resume``. Eval-only (``-e``) without ``--resume``
evaluates ``model.pretrained_params`` (with the seq2vec grafts under it; it
must hold every leaf) or, with no npz at all, the init. Every arch of
``options/`` trains, with the ``lstm``, ``gru`` or ``skipthoughts`` encoder.

``--distributed`` runs across processes, one a card
(``vqa_tpu_torch/parallel/``): ``torchrun --nproc_per_node N -m
vqa_tpu_torch.cli.train --distributed ...``, or the JAX CLI's flags
(``--coordinator_address host:port --num_processes N --process_id i``, one
command a process; ``file:///path`` also names a shared-file store). NCCL
carries the card's collectives, gloo the host's (``--platform cpu``). The N
processes form the mesh ``N / M × M`` of ``engine.model_parallel`` = M
(``parallel.mesh.make_mesh``; a world that M does not divide raises
``ValueError`` before any file is written). Each data index trains on its
shard of every global batch (``batch_size / (N / M)`` rows; train bucketing
off over more than one data index) and the step averages the grads and
metrics over the data axis; with
M > 1 the optimizer state of the large 2-D leaves is sharded over the ranks
of each row (``parallel.partition.shard_state_tp``). Evaluation is
replica-fed (every process reads the whole split and runs its data index's
slice of each batch), so every rank prints the same metrics. Only rank 0
writes ``options.yaml``, the logs, the results and the checkpoints (every
rank gathers the sharded state first; a barrier after each save);
checkpoints hold whole arrays, so a run saved under one layout resumes under
any other, one process included. SIGTERM → exit 75 stays single-process.
``engine.features_sharded`` (with ``engine.device_features``) row-shards the
table over every rank (``parallel.mesh.ShardedTable``).

``--profile_dir`` (``engine.profile_dir``) traces the run with
``torch.profiler`` where the JAX CLI calls ``jax.profiler.start_trace`` and
``stop_trace``: from the table's placement to the end of training or of the
``-e`` evaluation, a preempted run (exit 75) included. Host activity is
recorded, and on the card CUDA activity too (each kernel under its
``__global__`` name); the trace lands in that directory in TensorBoard's
torch-profiler layout (``tensorboard_trace_handler``:
``<host>_<pid>.<ms>.pt.trace.json``, a Chrome trace).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import signal
import sys
from typing import List, Optional

import torch

from vqa_tpu_torch.config import Options, compute_dtype, dump_options, load_options
from vqa_tpu_torch.datasets.factory import factory as dataset_factory
from vqa_tpu_torch.datasets.pipeline import BatchIterator, normalize_buckets
from vqa_tpu_torch.datasets.processed import ENCODERS
from vqa_tpu_torch.engine import engine as engine_lib
from vqa_tpu_torch.engine import optim as optim_lib
from vqa_tpu_torch.engine.checkpoint import CheckpointManager
from vqa_tpu_torch.engine.logger import Experiment
from vqa_tpu_torch.engine.steps import (create_state, make_eval_step, make_train_step,
                                        quantize_features)
from vqa_tpu_torch.models.factory import factory as model_factory
from vqa_tpu_torch.parallel import distributed
from vqa_tpu_torch.parallel.mesh import Mesh, check_batch_divisible, make_mesh, shard_feature_table
from vqa_tpu_torch.parallel.partition import gather_state, shard_state_tp
from vqa_tpu_torch.weights import graft_params, init_params, load_params, pretrained_params


def build_argparser() -> argparse.ArgumentParser:
    """``vqa_tpu/cli/train.py``'s parser, flag for flag."""
    p = argparse.ArgumentParser(description="vqa_tpu_torch trainer")
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
                        "(engine.checkpoint_steps); --resume latest restores "
                        "them bit-identically")
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
                   help="across processes, one a card, on the mesh of "
                        "engine.model_parallel (torchrun's environment, or the three "
                        "flags below)")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of rank 0's store (or file:///path)")
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


def _start_profile(profile_dir: str, device: torch.device):
    """A running ``torch.profiler`` whose ``stop()`` writes the trace into
    ``profile_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    return prof


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
                  input_dtype: Optional[torch.dtype], mesh: Mesh):
    """The feature table on ``device`` in ``engine.features_dtype``, as
    ``vqa_tpu/cli/train.py`` places it: int8 values with per-row scales
    (bf16 under a bf16 compute dtype, else float32), bfloat16, or as stored;
    replicated, or with ``engine.features_sharded`` this rank's rows of it
    (``parallel.mesh.shard_feature_table``)."""
    table = store.as_array()
    if opt.engine.features_dtype == "int8":
        values, scales = quantize_features(table)
        host = (torch.from_numpy(values),
                torch.from_numpy(scales).to(input_dtype or torch.float32))
        what = f"{values.shape} int8+scales ({(values.nbytes + scales.nbytes)/1e9:.2f} GB)"
    else:
        host = torch.from_numpy(table)
        if opt.engine.features_dtype == "bfloat16":
            host = host.to(torch.bfloat16)
        what = f"{tuple(host.shape)} {host.dtype} ({host.nbytes/1e9:.2f} GB)"
    if opt.engine.features_sharded:
        features = shard_feature_table(host, mesh, device)
        print(f"device feature table: {what}, row-sharded over {mesh.size} rank(s): "
              f"{features.nbytes/1e9:.2f} GB on this one", flush=True)
        return features
    print(f"device feature table: {what}", flush=True)
    return tuple(t.to(device) for t in host) if isinstance(host, tuple) else host.to(device)


def _weights(model, opt: Options, evaluate: bool) -> None:
    """A fresh run's weights, as the JAX CLI's ``init_params`` composes them:
    the init with the npz grafts over it (``seq2vec.pretrained_emb`` under
    encoder/embed/, ``seq2vec.pretrained_encoder`` under encoder/, then
    ``model.pretrained_params``, each leaf's shape checked); for eval-only
    with any npz named, the grafts alone, which must then hold every leaf."""
    flat = pretrained_params(opt.model)
    if evaluate and flat:
        load_params(model, flat)
        return
    init_params(model, opt.engine.seed)
    graft_params(model, flat, "model.pretrained_params / seq2vec.pretrained_*")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    opt = options_from_args(args)
    device = _device(args.platform)
    if args.distributed:
        device = distributed.initialize(args.coordinator_address, args.num_processes,
                                        args.process_id, device=device)
    try:
        return _run(args, opt, device)
    finally:
        if args.distributed:
            distributed.shutdown()


def _run(args, opt: Options, device: torch.device) -> int:
    mesh = make_mesh(opt.engine.model_parallel)
    # non-primary processes compute but never write run artifacts (logs,
    # options dump, results, checkpoints); see parallel/distributed.py
    primary = mesh.rank == 0
    dtype = compute_dtype(opt)
    # the visual input's cast, as vqa_tpu/cli/train.py:270 places it
    input_dtype = None if dtype == torch.float32 else dtype
    run_dir = opt.logs.dir_logs
    if primary:
        dump_options(opt, run_dir)
    exp = Experiment(run_dir, resume=args.resume is not None) if primary else None
    prev_sigterm = signal.getsignal(signal.SIGTERM)
    profiler = None
    try:
        # --- data -----------------------------------------------------------
        visual_mode = "index" if opt.engine.device_features else "gather"
        # rank 0 prepares the processed splits on first use; the others
        # wait, then read what it wrote
        if mesh.distributed and not primary:
            distributed.barrier()
        encoded = collections.Counter(ENCODERS)
        train_set = (None if args.evaluate
                     else dataset_factory(opt.vqa.trainsplit, opt, visual_mode=visual_mode))
        val_set = dataset_factory("val", opt, visual_mode=visual_mode)
        if ENCODERS != encoded:  # this run prepared the processed splits
            print(f"prep: splits by question encoder {dict(ENCODERS - encoded)}", flush=True)
        if mesh.distributed and primary:
            distributed.barrier()

        # --- model, weights, optimizer, resume ------------------------------
        model = model_factory(dataclasses.asdict(opt.model), val_set.num_words,
                              val_set.num_answers, dtype=dtype, device=device,
                              dim_v=val_set.feature_shape[-1], train=not args.evaluate,
                              rnn_bwd=opt.engine.rnn_bwd)
        if args.resume is None:  # a restore overwrites every leaf
            _weights(model, opt, args.evaluate)
        n_params = sum(p.numel() for p in model.parameters())
        where = (f", rank {mesh.rank} of {mesh.size} over {mesh.backend}, mesh "
                 f"{mesh.data} x {mesh.model} (data x model)" if mesh.distributed else "")
        print(f"model {opt.model.arch}: {n_params/1e6:.2f}M params, {device} {dtype}{where}",
              flush=True)
        ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"), args.save_all_from)
        state = None
        start_epoch, resume_step = 0, 0
        if args.evaluate:
            if args.resume is not None:
                resumed_epoch = ckpt.restore_params(model, args.resume)
                start_epoch = resumed_epoch + 1
                print(f"resumed from epoch {resumed_epoch} (best acc {ckpt.best_acc})",
                      flush=True)
        else:
            check_batch_divisible(opt.optim.batch_size, mesh)
            steps_per_epoch = len(train_set) // opt.optim.batch_size
            state = shard_state_tp(create_state(model, optim_lib.factory(opt.optim,
                                                                          steps_per_epoch)),
                                   mesh)
            if args.resume is not None:
                # a live mid-epoch checkpoint outranks the per-epoch saves for
                # a training '--resume latest': it is strictly newer (clear_step
                # drops it the moment its epoch completes)
                step_latest = ckpt.step_info() if args.resume == "latest" else None
                latest = ckpt.info().get("latest")
                if step_latest is not None and (latest is None or step_latest[0] > latest):
                    state, start_epoch, resume_step = ckpt.restore_step(state)
                    print(f"resumed mid-epoch {start_epoch} at step {resume_step} "
                          f"(best acc {ckpt.best_acc})", flush=True)
                else:
                    state, resumed_epoch = ckpt.restore(state, args.resume)
                    start_epoch = resumed_epoch + 1
                    print(f"resumed from epoch {resumed_epoch} (best acc {ckpt.best_acc})",
                          flush=True)
        if args.start_epoch is not None:
            start_epoch = args.start_epoch
            resume_step = 0

        # --- pipelines --------------------------------------------------------
        # evaluation is replica-fed: every process reads the whole split and
        # its transform keeps its slice of each batch; training reads this
        # process's shard of the split, whole
        transform = engine_lib.make_device_transform(device, input_dtype, mesh)
        eval_bs = opt.optim.eval_batch_size or opt.optim.batch_size
        check_batch_divisible(eval_bs, mesh)
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
        val_loader = BatchIterator(val_set, eval_bs, shuffle=False, pad_last=True,
                                   transform=transform, **bucketing)
        # one table on the card: the feature store the splits share
        features = (_device_table(val_set.features, opt, device, input_dtype, mesh)
                    if opt.engine.device_features else None)
        eval_step = make_eval_step()
        if opt.engine.profile_dir:
            profiler = _start_profile(opt.engine.profile_dir, device)

        if args.evaluate:
            if args.split in ("test", "testdev"):
                test_set = dataset_factory(args.split, opt, visual_mode=visual_mode)
                test_loader = BatchIterator(test_set, eval_bs, shuffle=False, pad_last=True,
                                            transform=transform, **bucketing)
                results = engine_lib.test(test_loader, model, eval_step,
                                          test_set.vocabs.aid_to_ans, exp, start_epoch,
                                          split=args.split, features=features, mesh=mesh)
                print(f"{args.split}: {len(results)} answers emitted", flush=True)
                return 0
            acc1, _ = engine_lib.validate(val_loader, model, eval_step,
                                          val_set.vocabs.aid_to_ans, exp, start_epoch,
                                          features=features, mesh=mesh)
            print(f"val acc1: {acc1*100:.2f}", flush=True)
            return 0

        train_ladder = normalize_buckets(
            opt.engine.train_buckets
            or sorted({min(7, opt.vqa.maxlength), (opt.vqa.maxlength + 1) // 2}),
            opt.vqa.maxlength,
        )
        train_bucketing = (
            dict(bucket_window=opt.engine.train_bucketing, length_buckets=train_ladder)
            if opt.engine.train_bucketing and opt.vqa.pad == "right"
            else {}
        )
        n_proc = mesh.data
        if n_proc > 1 and train_bucketing:
            # per-shard bucket truncation would give the data ranks different
            # question shapes for the same global step (the ranks of one row
            # read the same shard); the JAX CLI runs its multi-process
            # training unbucketed too
            print("distributed: train length-bucketing disabled", flush=True)
            train_bucketing = {}
        train_loader = BatchIterator(train_set, opt.optim.batch_size // n_proc, shuffle=True,
                                     seed=opt.engine.seed, drop_last=True,
                                     transform=engine_lib.make_device_transform(device,
                                                                                input_dtype),
                                     shard_index=mesh.data_index, shard_count=n_proc,
                                     shard_even=n_proc > 1, **train_bucketing)
        train_step = make_train_step(optim_lib.criterion_factory(), opt.engine.seed,
                                     nan_check=opt.engine.nan_check, mesh=mesh)

        def step_checkpoint(s, epoch, next_step):
            whole = gather_state(s)  # a collective of every rank's row
            if primary:
                ckpt.save_step(whole, epoch, next_step)
            distributed.barrier()

        # SIGTERM -> a step checkpoint at the next step boundary and exit 75;
        # single-process only, as in the JAX CLI: a signal to one process
        # would stop it alone, mid-collective
        if args.save_model and mesh.size == 1:
            engine_lib.install_preemption_handler()
        try:
            for epoch in range(start_epoch, opt.optim.epochs):
                state, _ = engine_lib.train(
                    train_loader, state, train_step, exp, epoch,
                    opt.engine.print_freq if primary else 0,
                    features=features,
                    start_step=resume_step if epoch == start_epoch else 0,
                    checkpoint_every=opt.engine.checkpoint_steps if args.save_model else 0,
                    step_checkpoint=step_checkpoint if args.save_model else None,
                )
                acc1, _ = engine_lib.validate(val_loader, state.model, eval_step,
                                              val_set.vocabs.aid_to_ans, exp, epoch,
                                              features=features, mesh=mesh)
                if args.save_model:
                    whole = gather_state(state)
                    if primary:
                        is_best = ckpt.save(whole, epoch, acc1)
                        ckpt.clear_step()  # the full-epoch save supersedes it
                        if is_best:
                            print(f"new best acc1 {acc1*100:.2f} @ epoch {epoch}",
                                  flush=True)
                    distributed.barrier()
        except engine_lib.Preempted as p:
            print(f"preempted: checkpoint saved at epoch {p.epoch} step {p.next_step}; "
                  "continue with --resume latest", flush=True)
            return 75  # EX_TEMPFAIL: rerun to continue
        return 0
    finally:
        if profiler is not None:
            profiler.stop()
        if signal.getsignal(signal.SIGTERM) is not prev_sigterm:
            signal.signal(signal.SIGTERM, prev_sigterm)
        if exp is not None:
            exp.close()


if __name__ == "__main__":
    sys.exit(main())
