"""The port's fixture generator (vqa_tpu_torch.datasets.fixtures) against
the JAX package's, and the port's fixture matrix on the CPU.

For every dataset layout (VQA v2, VQA v1, COCO-QA, TDIUC) and two seeds the
two generators write the same raw files byte for byte and the same att and
noatt feature tables and names; the in-memory stores hold what the HDF5
files hold and stand where the dataset factory looks for them. The matrix's
run_config trains one config for an epoch through the port's train CLI,
and its scorer's overall equals vqa_tpu's scorer on the same results json.
"""

import json
import os

import numpy as np
import pytest
import torch

from vqa_tpu_torch import config as port_config
from vqa_tpu_torch.datasets import factory as port_factory
from vqa_tpu_torch.datasets.features import FeatureStore
from vqa_tpu_torch.datasets.fixtures import SUBDIR, generate
from vqa_tpu_torch.tools import fixture_matrix

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"n_images": 5, "n_questions": 30}


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def _read_table(coco_dir, mode):
    import h5py

    from vqa_tpu_torch.datasets.features import feature_paths

    h5_path, names_path = feature_paths(coco_dir, "bottomup36", mode)
    with h5py.File(h5_path, "r") as f:
        table = f["features"][:]
    with open(names_path) as f:
        return json.load(f), table


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dataset", list(SUBDIR))
def test_generate_equals_the_jax_generator(tmp_path, dataset, seed):
    """The same raw files byte for byte and the same feature tables and
    names, read back from both packages' HDF5 files."""
    from vqa_tpu.datasets.fixtures import generate as jax_generate

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    generate(port_dir, **SIZES, seed=seed, dataset=dataset)
    jax_generate(jax_dir, **SIZES, seed=seed, dataset=dataset)
    files = _files(jax_dir)
    assert _files(port_dir) == files
    raw = [f for f in files if f.startswith(SUBDIR[dataset] + os.sep)]
    assert raw and len(raw) + 4 == len(files)
    for rel in raw:
        with open(os.path.join(port_dir, rel), "rb") as a, open(os.path.join(jax_dir, rel),
                                                                "rb") as b:
            assert a.read() == b.read(), rel
    for mode, shape in (("att", (36, 2048)), ("noatt", (2048,))):
        names, table = _read_table(os.path.join(port_dir, "coco"), mode)
        want_names, want = _read_table(os.path.join(jax_dir, "coco"), mode)
        assert names == want_names
        assert table.dtype == want.dtype == np.float32 and table.shape[1:] == shape
        np.testing.assert_array_equal(table, want)


@pytest.mark.parametrize("dataset", list(SUBDIR))
def test_in_memory_stores_equal_the_written_ones(tmp_path, dataset):
    """features="memory" places in the factory's cache, where it would open
    each HDF5 file, stores of the same names and rows as the files hold, and
    writes the same raw files and no feature file."""
    disk, mem = str(tmp_path / "disk"), str(tmp_path / "mem")
    generate(disk, **SIZES, seed=3, dataset=dataset)
    generate(mem, **SIZES, seed=3, dataset=dataset, features="memory")
    try:
        assert _files(mem) == [f for f in _files(disk) if not f.startswith("coco" + os.sep)]
        for mode in ("att", "noatt"):
            opt = port_config.load_options(
                os.path.join(REPO, "options", "vqa2", "mutan_att.yaml"),
                [f"coco.dir={mem}/coco", f"coco.mode={mode}"])
            placed = port_factory._feature_store(opt)
            written = FeatureStore(os.path.join(disk, "coco"), "bottomup36", mode)
            assert placed.h5_path == "<in memory>"
            assert placed.names == written.names
            np.testing.assert_array_equal(placed.as_array(), written.as_array())
    finally:
        port_factory.drop_stores(os.path.join(mem, "coco"))
    assert not any(k[0] == os.path.join(mem, "coco") for k in port_factory._STORE_CACHE)


def test_generate_refuses_an_unknown_feature_option(tmp_path):
    with pytest.raises(ValueError, match="features='zarr'"):
        generate(str(tmp_path), **SIZES, features="zarr")


def test_fixture_cli_writes_the_fixture(tmp_path):
    from vqa_tpu_torch.datasets import fixtures

    fixtures.main(["--dir", str(tmp_path), "--n_images", "3", "--n_questions", "8",
                   "--dataset", "TDIUC"])
    assert "tdiuc/raw/mscoco_val2014_annotations.json" in _files(str(tmp_path))
    names, table = _read_table(str(tmp_path / "coco"), "att")
    assert len(names) == 6 and table.shape == (6, 36, 2048)


def test_matrix_configs_are_the_jax_tools():
    """The port's matrix runs the JAX tool's configs, flags and fixture."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_fixture_matrix", os.path.join(REPO, "tools", "fixture_matrix.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    assert fixture_matrix.CONFIGS == jax_tool.CONFIGS
    assert fixture_matrix.COMMON == jax_tool.COMMON
    with open(os.path.join(REPO, "tools", "fixture_matrix.py")) as f:
        src = f.read()
    assert "generate(work, n_images=24, n_questions=200, seed=5)" in src
    assert fixture_matrix.FIXTURE == {"n_images": 24, "n_questions": 200, "seed": 5}
    assert '"--batch_size", "16", "--lr", "0.003"' in src
    assert (fixture_matrix.BATCH, fixture_matrix.LR) == (16, 0.003)


def test_matrix_run_config_scores_as_the_jax_scorer(tmp_path):
    """One config, one epoch on the CPU through the port's train CLI: rc 0,
    one train loss and one val acc1 an epoch, the best acc1 the CLI logged,
    and the scorer's overall on the emitted results json equal to
    vqa_tpu's scorer on the same file."""
    from vqa_tpu.scorer import evaluate_files as jax_evaluate_files

    work = str(tmp_path / "work")
    fixture_matrix.make_fixture(work)
    logs = str(tmp_path / "logs")
    run = fixture_matrix.run_config("mutan_noatt", fixture_matrix.CONFIGS["mutan_noatt"], logs,
                                    work, epochs=1, platform="cpu")
    assert run["rc"] == 0
    assert run["best"] == 0 and len(run["train_loss"]) == len(run["val_acc1"]) == 1
    assert run["acc1"] == run["val_acc1"][0] and np.isfinite(run["train_loss"][0])
    ann = os.path.join(work, "vqa2", "raw", "v2_mscoco_val2014_annotations.json")
    want = jax_evaluate_files(run["results"], ann)
    assert run["overall"] == want["overall"]
    with open(run["results"]) as f:
        assert len(json.load(f)) == 200
    assert 0 < fixture_matrix.majority_rate(work) < 1


def test_matrix_refuses_to_run_without_a_card(tmp_path):
    """With no --platform and no card the tool refuses before any work, as
    the train CLI does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fixture_matrix.main(["--dir", str(tmp_path / "w")])
    assert not os.path.exists(tmp_path / "w")
