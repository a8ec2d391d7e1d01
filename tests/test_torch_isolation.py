"""The port stands alone: every vqa_tpu_torch module loads in a fresh
interpreter (subprocess, so sys.modules starts clean) with nothing of jax,
flax or optax, and nothing of the JAX package vqa_tpu, in sys.modules;
Predictor.from_run answers from a fixture run, and the eval CLI prepares and
evaluates one, in such an interpreter.
chip_smoke.py refuses to run without a CUDA card."""

import importlib
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import vqa_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(vqa_tpu_torch.__path__, "vqa_tpu_torch.")
    )


def _run(code: str, *args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *(["-c", code] if code else []), *args],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)


def test_every_port_module_is_listed():
    mods = _port_modules()
    for expected in ("vqa_tpu_torch.ops.lstm", "vqa_tpu_torch.predictor",
                     "vqa_tpu_torch.cli.serve", "vqa_tpu_torch.engine.steps",
                     "vqa_tpu_torch.datasets.interim", "vqa_tpu_torch.datasets.processed",
                     "vqa_tpu_torch.datasets.features", "vqa_tpu_torch.datasets.vqa2",
                     "vqa_tpu_torch.datasets.pipeline", "vqa_tpu_torch.datasets.factory",
                     "vqa_tpu_torch.engine.logger", "vqa_tpu_torch.engine.engine",
                     "vqa_tpu_torch.scorer", "vqa_tpu_torch.cli.score",
                     "vqa_tpu_torch.cli.train", "vqa_tpu_torch.ops.gru",
                     "vqa_tpu_torch.models.noatt", "vqa_tpu_torch.engine.checkpoint",
                     "vqa_tpu_torch.weights", "vqa_tpu_torch.engine.optim",
                     "vqa_tpu_torch.export", "vqa_tpu_torch.cli.export",
                     "vqa_tpu_torch.cli.visu", "vqa_tpu_torch.importers",
                     "vqa_tpu_torch.models.convnets", "vqa_tpu_torch.cli.extract",
                     "vqa_tpu_torch.tools.import_torch"):
        assert expected in mods


def test_port_imports_no_jax():
    """The port and chip_smoke.py import nothing of jax or of vqa_tpu; the
    original HTTP layer, vqa_tpu.cli.serve, imports no jax either."""
    mods = ["vqa_tpu_torch"] + _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
        "'vqa_tpu'))\n"
        "assert not bad, bad\n"
        "heavy = sorted(m for m in ('yaml', 'h5py') if m in sys.modules)\n"
        "assert not heavy, f'imported at module level: {heavy}'\n"
        "importlib.import_module('vqa_tpu.cli.serve')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.fixture(scope="module")
def fixture_run(tmp_path_factory):
    """A fixture VQA run prepared by the JAX package and a tiny MutanAtt's
    weights as a '/'-keyed npz. The JAX
    package is imported here, not at module level: the card's machine runs
    this file's collection without h5py or flax."""
    import jax
    import jax.numpy as jnp

    from vqa_tpu.config import load_options
    from vqa_tpu.datasets import factory as dataset_factory
    from vqa_tpu.datasets.fixtures import generate
    from vqa_tpu.importers import save_tree_npz
    from vqa_tpu.models import factory as jax_factory

    d = str(tmp_path_factory.mktemp("isolated_run"))
    generate(d, n_images=6, n_questions=24, seed=3)
    overrides = [f"vqa.dir={d}/vqa2", f"coco.dir={d}/coco", "vqa.nans=10",
                 "model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=16",
                 "model.attention.dim_hv=8", "model.attention.dim_hq=8",
                 "model.attention.dim_mm=8", "model.attention.R=2", "model.fusion.dim_hv=8",
                 "model.fusion.dim_hq=8", "model.fusion.dim_mm=8", "model.fusion.R=2"]
    path_opt = os.path.join(REPO, "options", "vqa2", "mutan_att.yaml")
    opt = load_options(path_opt, overrides)
    val_set = dataset_factory("val", opt)  # writes the processed split
    model = jax_factory(opt.model, val_set.num_words, val_set.num_answers)
    params = model.init(jax.random.key(0), jnp.zeros((1,) + val_set.feature_shape),
                        jnp.zeros((1, opt.vqa.maxlength), jnp.int32),
                        jnp.ones((1,), jnp.int32))["params"]
    npz = os.path.join(d, "params.npz")
    save_tree_npz(npz, params)
    return d, path_opt, npz, overrides


def test_from_run_imports_nothing_of_jax(fixture_run):
    """Predictor.from_run reads the options YAML, the processed val
    vocabulary and the feature table with the port's own readers: after it
    has answered, nothing of vqa_tpu, jax or flax is in sys.modules."""
    d, path_opt, npz, overrides = fixture_run
    code = (
        "import sys\n"
        "from vqa_tpu_torch.predictor import Predictor\n"
        f"p = Predictor.from_run({d!r}, {path_opt!r}, params={npz!r}, overrides={overrides!r}, "
        "device='cpu')\n"
        "name = p.dataset.split.image_names[0]\n"
        "rows = p.answer_batch(['what color is the cat?', ''], [name, name], 3)\n"
        "assert len(rows) == 2 and all(len(r) == 3 for r in rows), rows\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
        "'vqa_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_from_run_names_the_missing_prep(fixture_run, tmp_path):
    """Without a processed split, from_run runs the port's own prep, which
    raises FileNotFoundError naming the raw VQA files it did not find."""
    from vqa_tpu_torch.predictor import Predictor

    _, path_opt, npz, overrides = fixture_run
    moved = [o for o in overrides if not o.startswith("vqa.dir=")] + [f"vqa.dir={tmp_path}"]
    with pytest.raises(FileNotFoundError, match=r"raw VQA files for split\(s\) \['train'\]"):
        Predictor.from_run(str(tmp_path), path_opt, params=npz, overrides=moved, device="cpu")


def test_eval_cli_imports_nothing_of_jax(fixture_run, tmp_path):
    """The port's eval CLI (python -m vqa_tpu_torch.cli.train -e) prepares a
    copy of the fixture's raw files with the port's own prep, evaluates and
    writes its results: after it, nothing of vqa_tpu, jax, flax or optax is
    in sys.modules."""
    import shutil

    d, path_opt, npz, overrides = fixture_run
    shutil.copytree(os.path.join(d, "vqa2", "raw"), str(tmp_path / "vqa2" / "raw"))
    moved = [o for o in overrides if not o.startswith("vqa.dir=")] + [
        f"vqa.dir={tmp_path}/vqa2", f"model.pretrained_params={npz}", "optim.eval_batch_size=16"]
    argv = ["--path_opt", path_opt, "-e", "--platform", "cpu", "--dir_logs",
            str(tmp_path / "logs")] + [a for o in moved for a in ("--opt", o)]
    code = (
        "import json, sys\n"
        "from vqa_tpu_torch.cli.train import main\n"
        f"assert main({argv!r}) == 0\n"
        f"rows = json.load(open({str(tmp_path / 'logs' / 'results')!r} + "
        "'/vqa_OpenEnded_val_epoch0_results.json'))\n"
        "assert len(rows) == 24 and len({r['question_id'] for r in rows}) == 24, rows\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
        "'vqa_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    assert os.path.exists(tmp_path / "vqa2" / "processed")


def test_import_tool_model_kind_imports_nothing_of_jax(tmp_path):
    """python -m vqa_tpu_torch.tools.import_torch --kind model takes its
    template from a port model, not from flax's model.init: it converts a
    lineage-named MLBNoAtt checkpoint through options/import_specs/
    mlb_noatt.json with nothing of jax, flax or vqa_tpu in sys.modules."""
    from test_torch_importers import CASES

    spec, make, yaml, V, nans, _, dv, _ = CASES["MLBNoAtt"]
    torch.save(make().state_dict(), tmp_path / "mlb.pth")
    (tmp_path / "mlb.yaml").write_text(yaml)
    out = tmp_path / "params.npz"
    argv = [str(tmp_path / "mlb.pth"), "--kind", "model", "--path_opt", str(tmp_path / "mlb.yaml"),
            "--num_words", str(V), "--num_answers", str(nans), "--feature_dim", str(dv),
            "--out", str(out)]
    code = (
        "import sys\n"
        "from vqa_tpu_torch.tools.import_torch import main\n"
        f"assert main({argv!r}) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
        "'vqa_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    with np.load(out) as flat:
        assert "classifier/logits/kernel" in flat.files and flat["fusion/v_proj/kernel"].shape == (
            dv, 7)


def test_chip_smoke_refuses_to_run_without_a_card():
    proc = _run("", "chip_smoke.py")
    assert proc.returncode != 0
    assert proc.stdout == ""  # no result line, no partial output
    assert "torch.cuda.is_available() is false" in proc.stderr


def test_chip_smoke_plain_path_swaps_every_kernel_call_site():
    """chip_smoke.py compares the kernel path with a plain path built by
    swapping, module by module, each kernel wrapper a model or step calls:
    none may be left out, or the 'plain' path would launch kernels."""
    wrappers = list(chip_smoke._counters().values())
    mods = [importlib.import_module(m) for m in _port_modules()
            if not m.startswith("vqa_tpu_torch.ops.")]

    def call_sites():
        return {(m.__name__, name) for m in mods for name, v in vars(m).items()
                if any(v is w for w in wrappers)}

    before = call_sites()
    assert {m for m, _ in before} >= {"vqa_tpu_torch.models.mfb", "vqa_tpu_torch.models.cor",
                                      "vqa_tpu_torch.models.fusion"}
    with chip_smoke._plain_ops(torch):
        assert call_sites() == set()
    assert call_sites() == before
