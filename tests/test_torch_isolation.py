"""The port stands alone: every vqa_tpu_torch module loads in a fresh
interpreter (subprocess, so sys.modules starts clean) with nothing of jax,
flax or optax, and nothing of the JAX package vqa_tpu, in sys.modules;
Predictor.from_run answers from a fixture run, the eval CLI prepares and
evaluates one, the prep encodes natively and item_loader runs a worker, and
the fixture matrix generates its fixture in memory and trains and scores a
config, in such an interpreter (nor grain, whose import loads jax).
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
                     "vqa_tpu_torch.tools.import_torch", "vqa_tpu_torch.datasets.fixtures",
                     "vqa_tpu_torch.tools.fixture_matrix",
                     "vqa_tpu_torch.tools.convert_butd_tsv", "vqa_tpu_torch.native",
                     "vqa_tpu_torch.datasets.index_shuffle"):
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
        "'grain', 'vqa_tpu'))\n"
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
    from vqa_tpu.importers import save_tree_npz
    from vqa_tpu.models import factory as jax_factory
    from vqa_tpu_torch.datasets.fixtures import generate

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


def test_native_prep_and_item_loader_import_nothing_of_jax_or_grain(tmp_path):
    """The port's prep through its native encoder, then item_loader with a
    worker process consumed to its end: nothing of jax, flax, optax, grain or
    vqa_tpu in sys.modules afterwards."""
    from vqa_tpu_torch.datasets.fixtures import generate

    generate(str(tmp_path), n_images=4, n_questions=20, seed=4)
    overrides = [f"vqa.dir={tmp_path}/vqa2", f"coco.dir={tmp_path}/coco", "vqa.nans=10"]
    path_opt = os.path.join(REPO, "options", "vqa2", "mutan_att.yaml")
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from vqa_tpu_torch import native\n"
        "from vqa_tpu_torch.config import load_options\n"
        "from vqa_tpu_torch.datasets import factory, processed\n"
        "from vqa_tpu_torch.datasets.index_shuffle import epoch_permutation\n"
        "from vqa_tpu_torch.datasets.vqa2 import item_loader\n"
        f"opt = load_options({path_opt!r}, {overrides!r})\n"
        "val = factory.factory('val', opt)\n"
        "assert native.available() and set(processed.ENCODERS) == {'native'}, "
        "processed.ENCODERS\n"
        "batches = list(item_loader(val, 8, shuffle=True, seed=1, worker_count=1))\n"
        "qids = [q for b in batches for q in b['question_id'].tolist()]\n"
        "assert sorted(qids) == sorted(val.split.question_ids.tolist()), qids\n"
        "assert len(epoch_permutation(20, 3, 0)) == 20\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
        "'grain', 'vqa_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


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


def test_fixture_matrix_runs_without_jax_or_h5py(tmp_path):
    """On a machine without h5py (h5py's import refused), the port's
    generator with in-memory features and one matrix run through the train
    CLI and the scorer work with nothing of jax, flax, optax, vqa_tpu or
    h5py in sys.modules; the HDF5 path names h5py when it is refused."""
    work, logs = str(tmp_path / "work"), str(tmp_path / "logs")
    code = (
        "import sys\n"
        "class NoH5py:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'h5py':\n"
        "            raise ImportError('no h5py here')\n"
        "sys.meta_path.insert(0, NoH5py())\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from vqa_tpu_torch.tools import fixture_matrix as m\n"
        f"m.make_fixture({work!r}, 'memory', n_images=6, n_questions=40)\n"
        f"run = m.run_config('mutan_att', m.CONFIGS['mutan_att'], {logs!r}, {work!r}, epochs=1, "
        "platform='cpu')\n"
        "assert run['rc'] == 0 and 0 <= run['overall'] <= 100, run\n"
        "try:\n"
        f"    m.make_fixture({work!r} + '_h5', 'hdf5', n_images=2, n_questions=4)\n"
        "    raise SystemExit('the HDF5 fixture was written without h5py')\n"
        "except ImportError as e:\n"
        "    assert 'h5py' in str(e), e\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
        "'vqa_tpu', 'h5py'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


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
