"""The port's train CLI as two processes on the host, the counterpart of
tests/test_distributed.py: ``python -m vqa_tpu_torch.cli.train --platform cpu
--distributed`` twice, joined through a ``file://`` store, each training on
its shard of every global batch (gloo) and evaluating its slice of every val
batch. Held: both ranks print the same val acc1 every epoch (the grads are
reduced, the eval outputs gathered), only rank 0 logs steps and writes the
run's files (one metrics record an epoch and split, one step record a step),
and the run's checkpoint resumes in one process: ``-e --resume best`` gives
the best epoch's acc1, and ``--resume latest`` trains on; two processes then
resume that one-process epoch.
"""

import json
import os
import subprocess
import sys

import torch

from vqa_tpu_torch.cli import train as port_cli
from vqa_tpu_torch.config import load_options
from vqa_tpu_torch.datasets import factory as port_factory
from vqa_tpu_torch.datasets.fixtures import generate

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH_OPT = os.path.join(REPO, "options", "vqa2", "concat_att.yaml")
# tests/test_distributed.py's tiny dims
TINY = ["vqa.nans=20", "model.seq2vec.emb_size=12", "model.seq2vec.hidden_size=16",
        "model.attention.dim_h=12", "model.classif.dim_h=12"]
EPOCHS, BATCH = 2, 16
RANK_TIMEOUT = 180


def _acc(line: str) -> str:
    return line.split("acc1")[1].split()[0]


def _two_ranks(store, argv):
    """Run the CLI with ``argv`` as two gloo ranks joined through ``store``;
    returns their outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-m", "vqa_tpu_torch.cli.train"] + argv
                              + ["--distributed", "--coordinator_address", f"file://{store}",
                                 "--num_processes", "2", "--process_id", str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def test_two_process_cli_trains_evaluates_and_resumes_in_one(tmp_path):
    d = str(tmp_path / "fix")
    generate(d, n_images=10, n_questions=64, seed=7)
    logs = str(tmp_path / "logs")
    data = [f"vqa.dir={d}/vqa2", f"coco.dir={d}/coco"]
    common = ["--path_opt", PATH_OPT, "--dir_logs", logs, "--platform", "cpu",
              "--batch_size", str(BATCH), "--print_freq", "1"] + \
        [a for o in data + TINY for a in ("--opt", o)]
    outs = _two_ranks(tmp_path / "store", common + ["--epochs", str(EPOCHS)])

    # each rank names its place; both saw the same val acc1 every epoch
    assert "rank 0 of 2 over gloo" in outs[0] and "rank 1 of 2 over gloo" in outs[1]
    evals = [[line for line in out.splitlines() if line.startswith("Eval [")] for out in outs]
    assert len(evals[0]) == len(evals[1]) == EPOCHS
    assert [_acc(x) for x in evals[0]] == [_acc(x) for x in evals[1]]

    # each rank ran half of every global batch: len // 2 rows a shard, in
    # local batches of BATCH // 2; step logging and every file are rank 0's
    train_set = port_factory.factory("train", load_options(PATH_OPT, data + TINY))
    steps = (len(train_set) // 2) // (BATCH // 2)
    assert steps >= 2 and f"[0/{steps}]" in outs[0] and "Epoch [" not in outs[1]
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [(r["epoch"], r["split"]) for r in records] == \
        [(e, s) for e in range(EPOCHS) for s in ("train", "val")]
    with open(os.path.join(logs, "steps.jsonl")) as f:
        assert sum(1 for _ in f) == EPOCHS * steps
    assert os.path.exists(os.path.join(logs, "options.yaml"))
    assert sorted(os.listdir(os.path.join(logs, "results"))) == \
        [f"vqa_OpenEnded_val_epoch{e}_results.json" for e in range(EPOCHS)]
    with open(os.path.join(logs, "ckpt", "info.json")) as f:
        info = json.load(f)
    assert info["latest"] == EPOCHS - 1
    val = [r for r in records if r["split"] == "val"]
    assert [f"{r['acc1'] * 100:.2f}" for r in val] == [_acc(x) for x in evals[0]]

    # the checkpoint does not depend on the layout: one process resumes it
    assert port_cli.main(common + ["-e", "--resume", "best"]) == 0
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        evaluated = [json.loads(line) for line in f if "event" not in line][-1]
    assert evaluated["acc1"] == info["best_acc"]
    assert port_cli.main(common + ["--resume", "latest", "--epochs", str(EPOCHS + 1)]) == 0
    with open(os.path.join(logs, "ckpt", "info.json")) as f:
        assert json.load(f)["latest"] == EPOCHS
    # and the reverse: two processes resume the one-process epoch
    outs = _two_ranks(tmp_path / "store2", common + ["--resume", "latest",
                                                     "--epochs", str(EPOCHS + 2)])
    assert all(f"resumed from epoch {EPOCHS}" in out for out in outs)
    with open(os.path.join(logs, "ckpt", "info.json")) as f:
        assert json.load(f)["latest"] == EPOCHS + 1
