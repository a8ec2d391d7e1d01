"""CoR's collapse without dropout: the model's, or the port's?

The fixture matrix's CoR run (vqa_tpu_torch/tools/fixture_matrix.py:
cor.yaml at the JAX tool's dims, on the port generator's fixture of 24
images and 200 questions a split, seed 5, batch 16, lr 0.003, adam) with
every dropout rate 0, float32 on the CPU, trained by both train CLIs
(vqa_tpu.cli.train and vqa_tpu_torch.cli.train) from one flax init saved
as an npz and given to both as model.pretrained_params, each step's loss
logged (--print_freq 1). Held here: the first epoch's step losses within
1e-4 relative (tests/test_torch_train_cli.py's bound for a CLI's train
loss), each package against the other.

The init is ``tests/data/cor_init_torch211.npz`` (sha256 ``INIT_SHA256``):
the port CLI's own init (weights.init_params at engine.seed, where the
matrix's runs started) as torch 2.11 draws it, on the H100 machine's host,
where the matrix saw the collapse (val acc1 18.0 -> 2.0 in the second
epoch). Held here through that second epoch: both packages' step losses
within 1e-4, their val acc1 within one question of each other, and the
same dip in both (the second epoch's val acc1 under half the first's).
Another torch draws another init from the same seed (QR and RNG streams
differ), and that one need not dip: the dip belongs to the init, the
24-image fixture and no dropout, not to either package.

Run as a script for the loss paths through the third epoch:

    python tests/test_torch_cor_collapse.py [--epochs 3] [--out paths.json]

trains both CLIs from that npz, then from the port CLI's init as this
torch draws it, then from a flax init (or from each ``--init``: port,
flax, or an npz of start weights), and prints each epoch's step losses and
val acc1 of both packages and the largest relative gap between their step
losses; it exits 1 unless both packages dip alike from the npz.
"""

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH_OPT = os.path.join(REPO, "options", "vqa2", "cor.yaml")
NO_DROPOUT = ["model.seq2vec.dropout=0", "model.attention.dropout=0", "model.fusion.dropout=0",
              "model.classif.dropout=0"]
REL = 1e-4
INIT_NPZ = os.path.join(REPO, "tests", "data", "cor_init_torch211.npz")
INIT_SHA256 = "40842303b8cfa8bc046c8a492fafb54e1142295767296d631f241887996d9c98"


def _fixture(work: str) -> None:
    from vqa_tpu_torch.tools.fixture_matrix import make_fixture

    make_fixture(work)


def _flags(work: str) -> list:
    """The matrix's flags for CoR (its COMMON and CONFIGS["cor"]), every
    dropout 0, as --opt overrides and CLI flags."""
    from vqa_tpu_torch.tools.fixture_matrix import BATCH, COMMON, CONFIGS, LR

    return ["--platform", "cpu", "--batch_size", str(BATCH), "--lr", str(LR),
            "--print_freq", "1", "--opt", f"vqa.dir={work}/vqa2", "--opt", f"coco.dir={work}/coco",
            *COMMON, *CONFIGS["cor"], *(x for o in NO_DROPOUT for x in ("--opt", o))]


def _init_npz(work: str, flags: list, init: str = "flax") -> str:
    """The matrix's CoR initialised, saved as an npz: "flax", flax's init
    (key 3); "port", the port CLI's own (weights.init_params at the
    engine.seed, the weights the matrix's runs started from)."""
    opts = [flags[i + 1] for i, f in enumerate(flags) if f == "--opt"]
    if init.endswith(".npz"):  # given: e.g. the port's init drawn on another machine
        return init
    npz = os.path.join(work, f"cor_{init}_init.npz")
    if init == "port":
        import dataclasses

        from vqa_tpu_torch.config import load_options as port_load_options
        from vqa_tpu_torch.datasets import factory as port_data
        from vqa_tpu_torch.models import factory as port_model_factory
        from vqa_tpu_torch.weights import export_params, init_params

        opt = port_load_options(PATH_OPT, opts)
        val_set = port_data.factory("val", opt)
        model = port_model_factory(dataclasses.asdict(opt.model), val_set.num_words,
                                   val_set.num_answers, dim_v=val_set.feature_shape[-1])
        init_params(model, opt.engine.seed)
        np.savez(npz, **export_params(model))
        return npz
    import jax
    import jax.numpy as jnp

    from vqa_tpu.config import load_options
    from vqa_tpu.datasets import factory as jax_factory
    from vqa_tpu.importers import save_tree_npz
    from vqa_tpu.models import factory as jax_model_factory

    opt = load_options(PATH_OPT, opts)
    val_set = jax_factory("val", opt)
    model = jax_model_factory(opt.model, val_set.num_words, val_set.num_answers)
    params = model.init(jax.random.key(3), jnp.zeros((2,) + val_set.feature_shape),
                        jnp.zeros((2, opt.vqa.maxlength), jnp.int32),
                        jnp.ones((2,), jnp.int32))["params"]
    save_tree_npz(npz, params)
    return npz


def _records(logs: str, name: str) -> list:
    with open(os.path.join(logs, name)) as f:
        return [json.loads(line) for line in f]


def train_both(work: str, epochs: int, init: str = "flax") -> dict:
    """Both CLIs over the fixture under ``work`` for ``epochs`` epochs from
    one init (``_init_npz``); each side's step losses by epoch and val acc1
    a epoch."""
    from vqa_tpu.cli.train import main as jax_main
    from vqa_tpu_torch.cli.train import main as port_main

    if not os.path.exists(os.path.join(work, "vqa2")):
        _fixture(work)
    flags = _flags(work)
    npz = _init_npz(work, flags, init)
    out = {}
    for side, main in (("port", port_main), ("jax", jax_main)):
        logs = os.path.join(work, f"{side}_{os.path.basename(init)}")
        argv = ["--path_opt", PATH_OPT, "--dir_logs", logs, "--epochs", str(epochs), *flags,
                "--opt", f"model.pretrained_params={npz}"]
        assert main(argv) == 0, side
        steps = _records(logs, "steps.jsonl")
        out[side] = {
            "step_loss": [[s["loss"] for s in steps if s["epoch"] == e] for e in range(epochs)],
            "val_acc1": [r["acc1"] for r in _records(logs, "metrics.jsonl")
                         if r.get("split") == "val"]}
    return out


def _gap(got: list, want: list) -> float:
    return max(abs(g - w) / max(abs(w), 1e-6) for g, w in zip(got, want))


def collapses_alike(paths: dict) -> bool:
    """Both packages' val acc1 within one question (of the fixture's 200)
    of each other in every epoch, and each dipping in the second epoch
    below half its first."""
    port, jax_ = paths["port"]["val_acc1"], paths["jax"]["val_acc1"]
    return (len(port) == len(jax_) >= 2 and all(abs(a - b) <= 0.005 for a, b in zip(port, jax_))
            and all(acc[1] < acc[0] / 2 for acc in (port, jax_)))


@pytest.fixture(scope="module")
def collapse_run(tmp_path_factory):
    """Both CLIs for two epochs from the committed init."""
    with open(INIT_NPZ, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == INIT_SHA256
    torch.set_num_threads(1)
    return train_both(str(tmp_path_factory.mktemp("cor_collapse")), 2, INIT_NPZ)


def test_cor_step_losses_match_the_jax_cli(collapse_run):
    """Each epoch's step losses of both CLIs within 1e-4 relative, through
    the collapse: the same model, data, order and optimizer, float32 sums
    in another order."""
    for e in range(2):
        got, want = collapse_run["port"]["step_loss"][e], collapse_run["jax"]["step_loss"][e]
        assert len(got) == len(want) > 5
        assert all(np.isfinite(got)) and all(np.isfinite(want))
        assert _gap(got, want) <= REL, (e, got, want)


def test_cor_collapses_alike_in_both_packages(collapse_run):
    """The matrix's collapse from the committed init, in both packages:
    val acc1 dips in the second epoch, the same in each."""
    assert collapses_alike(collapse_run), (collapse_run["port"]["val_acc1"],
                                           collapse_run["jax"]["val_acc1"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--out", default=None, help="write the loss paths here as json")
    p.add_argument("--init", nargs="+", default=[INIT_NPZ, "port", "flax"],
                   help="the inits to train from: port, flax, or an npz of start weights")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="cor_collapse_") as work:
        for init in args.init:
            runs[init] = paths = train_both(work, args.epochs, init)
            for e in range(args.epochs):
                for side in ("port", "jax"):
                    losses = paths[side]["step_loss"][e]
                    print(f"init {init} epoch {e} {side}: "
                          f"val_acc1={100 * paths[side]['val_acc1'][e]:.1f} "
                          f"mean_loss={np.mean(losses):.6f} step_loss="
                          + ",".join(f"{x:.6f}" for x in losses))
                print(f"init {init} epoch {e} max relative gap of the step losses: "
                      f"{_gap(paths['port']['step_loss'][e], paths['jax']['step_loss'][e]):.3e}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f)
    if INIT_NPZ in runs:
        alike = collapses_alike(runs[INIT_NPZ])
        print(f"from {os.path.basename(INIT_NPZ)}: both packages collapse alike: {alike}")
        return 0 if alike else 1
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
