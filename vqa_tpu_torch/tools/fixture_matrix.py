"""Every graded config end to end on the synthetic fixture: the port's train
CLI (``vqa_tpu_torch.cli.train``) trains and validates it, and the port's
scorer (``vqa_tpu_torch.scorer``) scores the best epoch's results json. The
port of the repo-root ``tools/fixture_matrix.py``, with its configs, flags,
fixture and dims.

  python -m vqa_tpu_torch.tools.fixture_matrix --platform cpu [--epochs 6]
  python -m vqa_tpu_torch.tools.fixture_matrix --features memory   # on the card
  python -m vqa_tpu_torch.tools.fixture_matrix --platform cpu --int8_delta

It runs on the card unless ``--platform cpu`` asks for the host; with no
card it refuses, as the train CLI does. ``--features hdf5`` (the default)
writes the fixture's feature table to HDF5 as the original does;
``--features memory`` keeps it in in-memory stores in the dataset factory's
cache, for a machine without h5py (the runs are in-process). Accuracy here
measures that the pipeline learns the fixture's signal, not VQA accuracy.
It prints one row a config (best val acc1, scorer overall; with
``--int8_delta`` the scorer over the bfloat16 and the int8 table and their
delta) and writes the table only to the ``--out`` path given.

``--int8_delta`` trains every config twice with the feature table on the
device (``engine.device_features=true``) in ``engine.features_dtype``
bfloat16 and int8: ``features_dtype`` only applies to that table, so
without ``device_features`` the two runs would be the same run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from collections import Counter
from typing import Dict, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = {
    "concat_att": [],
    "mlb_att": ["--opt", "model.fusion.dim_h=24"],
    "mutan_att": [
        "--opt", "model.attention.dim_hq=12", "--opt", "model.attention.dim_hv=12",
        "--opt", "model.attention.dim_mm=16", "--opt", "model.attention.R=2",
        "--opt", "model.fusion.dim_hq=12", "--opt", "model.fusion.dim_hv=12",
        "--opt", "model.fusion.dim_mm=16", "--opt", "model.fusion.R=2",
    ],
    "mfb_coatt": ["--opt", "model.fusion.dim_mm=16", "--opt", "model.fusion.pool_factor=2"],
    "mfh_coatt": ["--opt", "model.fusion.dim_mm=16", "--opt", "model.fusion.pool_factor=2"],
    "cor": ["--opt", "vqa.trainsplit=train", "--opt", "model.fusion.dim_h=24"],
    "mlb_noatt": ["--opt", "model.fusion.dim_h=24"],
    "mutan_noatt": [
        "--opt", "model.fusion.dim_hq=12", "--opt", "model.fusion.dim_hv=12",
        "--opt", "model.fusion.dim_mm=16", "--opt", "model.fusion.R=2",
    ],
}

COMMON = [
    "--opt", "vqa.nans=25",
    "--opt", "model.seq2vec.emb_size=16",
    "--opt", "model.seq2vec.hidden_size=32",
    "--opt", "model.attention.dim_h=24",
    "--opt", "model.classif.dim_h=24",
]

FIXTURE = {"n_images": 24, "n_questions": 200, "seed": 5}
BATCH = 16
LR = 0.003
EPOCHS = 6
INT8_DTYPES = ("bfloat16", "int8")


def make_fixture(work: str, features: str = "hdf5", dataset: str = "VQA2", **sizes) -> None:
    """The matrix's fixture (``FIXTURE``, or ``sizes``) under ``work``."""
    from vqa_tpu_torch.datasets.fixtures import generate

    generate(work, **{**FIXTURE, **sizes}, dataset=dataset, features=features)


def majority_rate(work: str, dataset: str = "VQA2") -> float:
    """acc1 of always answering the most frequent consensus answer of the
    fixture's val questions."""
    from vqa_tpu_torch.datasets.fixtures import SUBDIR
    from vqa_tpu_torch.datasets.interim import build_interim

    answers = [r["answer"] for r in
               build_interim(os.path.join(work, SUBDIR[dataset], "raw"), "val", dataset)]
    return Counter(answers).most_common(1)[0][1] / len(answers)


def history(logs: str) -> Dict[str, list]:
    """Each epoch's train loss and val acc1 from ``metrics.jsonl``."""
    out: Dict[str, list] = {"train_loss": [], "val_acc1": []}
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("split") == "train":
                out["train_loss"].append(rec["loss"])
            elif rec.get("split") == "val":
                out["val_acc1"].append(rec["acc1"])
    return out


def run_config(name: str, extra: Sequence[str], logs: str, work: str, epochs: int = EPOCHS,
               platform: Optional[str] = None, opts: Sequence[str] = (),
               dataset: str = "VQA2") -> dict:
    """Train ``options/vqa2/<name>.yaml`` through the port's train CLI on the
    fixture under ``work`` (``COMMON`` and ``extra`` flags, then each of
    ``opts`` as ``--opt``) and score its best epoch. Returns ``rc``, and when
    it is 0: ``acc1`` (the best val acc1), ``best`` (its epoch),
    ``overall`` (the scorer's, None for COCO-QA, which has no annotations
    json), ``results`` (that epoch's results json), ``train_loss`` and
    ``val_acc1`` (one per epoch)."""
    from vqa_tpu_torch.cli.train import main as train_main
    from vqa_tpu_torch.datasets.fixtures import SUBDIR
    from vqa_tpu_torch.datasets.interim import RAW_FILES_BY_DATASET
    from vqa_tpu_torch.scorer import evaluate_files

    argv = [
        "--path_opt", os.path.join(REPO, "options", "vqa2", f"{name}.yaml"),
        "--dir_logs", logs, "--epochs", str(epochs),
        "--batch_size", str(BATCH), "--lr", str(LR), "--print_freq", "0",
        "--opt", f"vqa.dir={work}/{SUBDIR[dataset]}", "--opt", f"coco.dir={work}/coco",
        "--opt", f"vqa.dataset={dataset}", *COMMON, *extra,
    ]
    if platform is not None:
        argv += ["--platform", platform]
    for o in opts:
        argv += ["--opt", o]
    rc = train_main(argv)
    if rc != 0:
        return {"rc": rc}
    with open(os.path.join(logs, "ckpt", "info.json")) as f:
        info = json.load(f)
    results = os.path.join(logs, "results",
                           f"vqa_OpenEnded_val_epoch{info['best']}_results.json")
    overall = None
    if dataset != "COCOQA":
        ann = os.path.join(work, SUBDIR[dataset], "raw", RAW_FILES_BY_DATASET[dataset]["val"][1])
        overall = evaluate_files(results, ann)["overall"]
    return {"rc": rc, "acc1": info["best_acc"], "best": info["best"], "overall": overall,
            "results": results, **history(logs)}


def _table(rows, int8: bool, epochs: int) -> str:
    if int8:
        head = ("| config | scorer bf16 | scorer int8 | delta |\n|---|---|---|---|\n")
        body = "".join(f"| {n} | {b:.1f} | {i:.1f} | {d:+.1f} |\n" for n, b, i, d in rows)
    else:
        head = ("| config | best val acc1 (engine) | scorer overall |\n|---|---|---|\n")
        body = "".join(f"| {n} | {a * 100:.1f} | {o:.1f} |\n" for n, a, o in rows)
    return (f"Graded configs on the synthetic fixture ({FIXTURE}), {epochs} epochs, "
            f"batch {BATCH}, lr {LR}, through vqa_tpu_torch.\n\n" + head + body)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--dir", default=None, help="work dir (default: a new temp dir)")
    p.add_argument("--int8_delta", action="store_true",
                   help="train every config twice, the device feature table in bfloat16 "
                        "and in int8, and report the scorer's delta")
    p.add_argument("--platform", default=None, metavar="cuda|cpu",
                   help="where to run: the card (default) or, with cpu, the host")
    p.add_argument("--features", default="hdf5", choices=["hdf5", "memory"],
                   help="the fixture's feature table: HDF5 files, or in-memory stores "
                        "(no h5py needed)")
    p.add_argument("--out", default=None, help="also write the table (markdown) here")
    args = p.parse_args(argv)

    from vqa_tpu_torch.cli.train import _device

    _device(args.platform)  # no card and no --platform cpu: refuse before any work
    work = args.dir or tempfile.mkdtemp(prefix="vqa_matrix_")
    make_fixture(work, args.features)

    rows = []
    for name, extra in CONFIGS.items():
        if args.int8_delta:
            per = {}
            for dtype in INT8_DTYPES:
                run = run_config(name, extra, os.path.join(work, "logs", f"{name}_{dtype}"),
                                 work, args.epochs, args.platform,
                                 ("engine.device_features=true",
                                  f"engine.features_dtype={dtype}"))
                if run["rc"] != 0:
                    raise SystemExit(f"{name} ({dtype}): the train CLI returned {run['rc']}")
                per[dtype] = run["overall"]
            delta = per["int8"] - per["bfloat16"]
            rows.append((name, per["bfloat16"], per["int8"], delta))
            print(f"{name}: scorer bf16 {per['bfloat16']:.1f} int8 {per['int8']:.1f} "
                  f"(delta {delta:+.1f})", flush=True)
        else:
            run = run_config(name, extra, os.path.join(work, "logs", name), work, args.epochs,
                             args.platform)
            if run["rc"] != 0:
                raise SystemExit(f"{name}: the train CLI returned {run['rc']}")
            rows.append((name, run["acc1"], run["overall"]))
            print(f"{name}: best acc1 {run['acc1'] * 100:.1f}, scorer {run['overall']:.1f}",
                  flush=True)
    table = _table(rows, args.int8_delta, args.epochs)
    print(table, end="")
    if args.out:
        with open(args.out, "w") as f:
            f.write(table)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
