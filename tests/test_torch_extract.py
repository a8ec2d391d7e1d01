"""The port's grid-feature extraction (vqa_tpu_torch/models/convnets.py,
``python -m vqa_tpu_torch.cli.extract``) against the JAX package's
(vqa_tpu/models/convnets.py, vqa_tpu/cli/extract.py), on the CPU.

The same flax variables (BatchNorm scales, biases and running statistics
drawn away from the identity) reach the port through the '/'-keyed npz
bridge: the port ResNet's grid must match flax ``ResNet.apply``'s at one
block a stage and at resnet50 depth, 64x64 and an odd 63x63, to 1e-4 of
the grid's max-abs in float32; bf16 compute against the float32 JAX grid
within BF16_TOL. The extract CLI must write the JAX CLI's HDF5 table
(within 1e-4) and names on the same PNGs and ``--params``, with a padded
last batch; without ``--params`` its seeded init has flax's variables and
shapes. The port's eval CLI over a table the port extracted (``coco.arch``
set to it) must write what the JAX ``train.py -e`` writes over that table.
"""

import dataclasses
import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from test_torch_eval import TINY, _assert_same_answers, _metrics, _results
from vqa_tpu.cli.extract import main as jax_extract_main
from vqa_tpu.models import convnets as jax_convnets
from vqa_tpu_torch.cli.extract import extract
from vqa_tpu_torch.cli.extract import main as port_extract_main
from vqa_tpu_torch.models import convnets

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4  # float32 on both sides, relative to the grid's max-abs
# bf16 convs round each conv's output and input to 8 significant bits (up
# to 2^-8 relative) and each BatchNorm's output again: over 16 blocks with
# residual sums the grid moves by a few 2^-8 of its scale (0.0077-0.0119
# over five draws of weights and inputs on the CPU); twice the worst leaves
# room for another draw
BF16_TOL = 0.025
STAGES = (1, 1, 1, 1)


def _variables(stages, size, seed):
    """flax ResNet variables, '/'-flattened, with the BatchNorms away from the
    identity; each block's last scale small, as torchvision's
    zero_init_residual keeps a deep ResNet's grid O(1)."""
    model = jax_convnets.ResNet(stage_sizes=stages)
    variables = model.init(jax.random.key(seed), jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    flat = {}
    for key, value in flatten_dict(variables, sep="/").items():
        shape = np.shape(value)
        if key.endswith("/scale"):
            value = rng.uniform(*((0.1, 0.2) if "/bn3/" in key else (0.5, 1.5)), shape)
        elif key.endswith("/bias"):
            value = rng.uniform(-0.2, 0.2, shape)
        elif key.endswith("/mean"):
            value = rng.uniform(-0.3, 0.3, shape)
        elif key.endswith("/var"):
            value = rng.uniform(0.5, 2.0, shape)
        flat[key] = np.asarray(value, np.float32)
    return flat


def _jax_grid(stages, flat, x):
    model = jax_convnets.ResNet(stage_sizes=stages)
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return np.asarray(model.apply(variables, jnp.asarray(x)))


def _port_grid(stages, flat, x, dtype=torch.float32):
    model = convnets.ResNet(stages, dtype)
    convnets.load_variables(model, flat)
    with torch.inference_mode():
        return model(torch.from_numpy(x)).float().numpy()


@pytest.mark.parametrize("stages,size", [(STAGES, 64), (convnets._DEPTHS["resnet50"], 64),
                                         (STAGES, 63)],
                         ids=["one_block_a_stage", "resnet50", "odd_size"])
def test_resnet_matches_flax(stages, size):
    """float32 to 1e-4 of the grid's max-abs; at 63x63 the strided convs'
    explicit (1, 1) padding and flax's SAME on the 1x1 proj (no padding at
    any size) give the same 2x2 grid."""
    flat = _variables(stages, size, 0)
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    want = _jax_grid(stages, flat, x)
    got = _port_grid(stages, flat, x)
    assert got.shape == want.shape == (2, 2, 2, 2048)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


def test_resnet_bf16_against_flax_float32():
    stages = convnets._DEPTHS["resnet50"]
    flat = _variables(stages, 64, 2)
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = _jax_grid(stages, flat, x)
    model = convnets.ResNet(stages, torch.bfloat16)
    convnets.load_variables(model, flat)
    with torch.inference_mode():
        grid = model(torch.from_numpy(x))
    assert grid.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    err = np.abs(grid.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BF16_TOL, err


def test_grid_features_match_flax():
    grid = np.random.default_rng(4).standard_normal((3, 14, 14, 16)).astype(np.float32)
    for mode in ("att", "noatt"):
        got = convnets.grid_features(torch.from_numpy(grid), mode).numpy()
        want = np.asarray(jax_convnets.grid_features(jnp.asarray(grid), mode))
        assert got.shape == want.shape == ((3, 196, 16) if mode == "att" else (3, 16))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(convnets.grid_features(torch.from_numpy(grid), "att")[:, 15],
                                  grid[:, 1, 1])  # region 15 = (h 1, w 1): h-major
    with pytest.raises(KeyError, match="att|noatt"):
        convnets.grid_features(torch.from_numpy(grid), "grid")


def test_variables_bridge_refuses_a_wrong_tree():
    flat = convnets.export_variables(convnets.factory("resnet50"))
    model = convnets.factory("resnet50")
    missing = dict(flat)
    del missing["batch_stats/s1_b0/bn_proj/var"]
    with pytest.raises(KeyError, match="missing.*bn_proj/var"):
        convnets.load_variables(model, missing)
    with pytest.raises(KeyError, match="extra.*fc"):
        convnets.load_variables(model, dict(flat, **{"params/fc/kernel": np.zeros((2048, 10))}))
    with pytest.raises(ValueError, match="s0_b0/conv1/kernel: shape"):
        convnets.load_variables(model, dict(
            flat, **{"params/s0_b0/conv1/kernel": np.zeros((1, 1, 64, 63), np.float32)}))


def _images(d, names, rng, side=40):
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    for name in names:
        Image.fromarray(rng.integers(0, 255, (side, side, 3), dtype=np.uint8)).save(
            os.path.join(d, f"{name}.png"))


def _table(coco, arch, mode):
    with h5py.File(os.path.join(coco, "extract", f"{arch}_{mode}.h5"), "r") as f:
        feats = f["features"][:]
    with open(os.path.join(coco, "extract", f"{arch}_{mode}_names.json")) as f:
        return json.load(f), feats


@pytest.mark.parametrize("mode", ["att", "noatt"])
def test_extract_cli_writes_the_jax_cli_table(tmp_path, mode):
    """3 PNGs at --batch 2 (a padded last batch), resnet50 at 64x64, the same
    --params npz: the same names and the JAX CLI's float32 features."""
    names = [f"COCO_val2014_{i:012d}" for i in (7, 3, 11)]
    _images(str(tmp_path / "images"), names, np.random.default_rng(5))
    params = tmp_path / "r50.npz"
    np.savez(params, **_variables(convnets._DEPTHS["resnet50"], 64, 6))
    tables = []
    for label, cli, extra in (("port", port_extract_main, ["--platform", "cpu"]),
                              ("jax", jax_extract_main, [])):
        out = str(tmp_path / label)
        assert cli(["--dir_images", str(tmp_path / "images"), "--dir_out", out,
                    "--arch", "resnet50", "--mode", mode, "--batch", "2", "--size", "64",
                    "--params", str(params)] + extra) == 0
        tables.append(_table(out, "resnet50", mode))
    (got_names, got), (want_names, want) = tables
    assert got_names == want_names == sorted(names)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ((3, 4, 2048) if mode == "att" else (3, 2048))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


def test_extract_cli_seeded_init(tmp_path):
    """No --params: a seeded init with flax's variables and shapes (BatchNorm
    the identity), finite and distinct features; with the same --params npz
    two seeds give the same features."""
    flax_init = jax_convnets.factory("resnet50").init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    want = {k: np.shape(v) for k, v in flatten_dict(flax_init, sep="/").items()}
    model = convnets.factory("resnet50")
    convnets.init_variables(model, 3)
    flat = convnets.export_variables(model)
    assert {k: v.shape for k, v in flat.items()} == want
    assert all((flat[k] == (1.0 if k.endswith(("/scale", "/var")) else 0.0)).all()
               for k in flat if not k.endswith("/kernel"))
    kernel = flat["params/s2_b1/conv2/kernel"]  # [3, 3, 256, 256]: lecun_normal's std
    assert abs(kernel.std() * np.sqrt(3 * 3 * 256) - 1.0) < 0.01 and np.abs(kernel).max() <= \
        2 / np.sqrt(3 * 3 * 256) / 0.87962566103423978 + 1e-6

    names = ["COCO_val2014_000000000001", "COCO_val2014_000000000002"]
    _images(str(tmp_path / "images"), names, np.random.default_rng(7))
    args = ["--dir_images", str(tmp_path / "images"), "--arch", "resnet50", "--mode", "noatt",
            "--batch", "1", "--size", "64", "--platform", "cpu"]
    assert port_extract_main(args + ["--dir_out", str(tmp_path / "init"), "--seed", "3"]) == 0
    _, feats = _table(str(tmp_path / "init"), "resnet50", "noatt")
    assert feats.shape == (2, 2048) and np.isfinite(feats).all()
    assert not np.allclose(feats[0], feats[1])

    np.savez(tmp_path / "r50.npz", **flat)
    loaded = []
    for seed in ("1", "9"):
        out = str(tmp_path / f"seed{seed}")
        assert port_extract_main(args + ["--dir_out", out, "--seed", seed,
                                         "--params", str(tmp_path / "r50.npz")]) == 0
        loaded.append(_table(out, "resnet50", "noatt")[1])
    np.testing.assert_array_equal(loaded[0], loaded[1])
    np.testing.assert_array_equal(loaded[0], feats)  # the npz of seed 3's init


def test_extract_function_pads_the_last_batch():
    """``extract`` on decoded images: 5 images at batch 2 give the rows of
    one call over all 5 (the zero pad rows dropped), in the names' order,
    from a list or a generator; a count that differs from the names' is
    refused."""
    model = convnets.ResNet(STAGES)
    convnets.init_variables(model, 0)
    images = list(np.random.default_rng(8).standard_normal((5, 32, 32, 3)).astype(np.float32))
    names, feats = extract(model, list("abcde"), images, "att", 2, "cpu")
    _, whole = extract(model, list("abcde"), images, "att", 5, "cpu")
    assert names == list("abcde") and feats.shape == (5, 1, 2048) and feats.dtype == np.float32
    np.testing.assert_allclose(feats, whole, rtol=1e-5, atol=1e-5)
    _, drawn = extract(model, list("abcde"), (x for x in images), "att", 2, "cpu")
    np.testing.assert_array_equal(drawn, feats)  # any iterable, drawn a batch at a time
    with pytest.raises(ValueError, match="4 names for 5 images"):
        extract(model, list("abcd"), images, "att", 2, "cpu")
    with pytest.raises(ValueError, match="6 names for 5 images"):
        extract(model, list("abcdef"), iter(images), "att", 2, "cpu")


def test_eval_cli_over_the_extracted_table(tmp_path):
    """A fixture's images (PNGs) through the port's extract CLI (resnet50,
    64x64: a 2x2 grid of 4 regions), then ``python -m vqa_tpu_torch.cli.train
    -e --platform cpu --opt coco.arch=resnet50`` over that table: the same
    metrics and answers as ``vqa_tpu.cli.train -e`` over it, with the same
    tiny MutanAtt's weights."""
    from vqa_tpu.cli.train import main as jax_main
    from vqa_tpu.config import load_options as jax_load_options
    from vqa_tpu.datasets import factory as jax_factory
    from vqa_tpu.importers import save_tree_npz
    from vqa_tpu.models import factory as jax_model_factory
    from vqa_tpu_torch.cli import train as port_cli
    from vqa_tpu_torch.config import load_options
    from vqa_tpu_torch.datasets import factory as port_factory
    from vqa_tpu_torch.datasets.fixtures import generate
    from vqa_tpu_torch.models.factory import factory as model_factory
    from vqa_tpu_torch.weights import load_params

    d = str(tmp_path)
    generate(d, n_images=6, n_questions=24, seed=5)
    with open(os.path.join(d, "coco", "extract", "bottomup36_att_names.json")) as f:
        names = json.load(f)
    _images(os.path.join(d, "images"), names, np.random.default_rng(9))
    assert port_extract_main(["--dir_images", os.path.join(d, "images"), "--dir_out",
                              os.path.join(d, "coco"), "--arch", "resnet50", "--mode", "att",
                              "--batch", "4", "--size", "64", "--platform", "cpu"]) == 0

    path_opt = os.path.join(REPO, "options", "vqa2", "mutan_att.yaml")
    overrides = [f"vqa.dir={d}/vqa2", f"coco.dir={d}/coco", "coco.arch=resnet50"] + TINY
    jax_opt = jax_load_options(path_opt, overrides)
    val_set = jax_factory("val", jax_opt)
    assert val_set.feature_shape == (4, 2048)
    model = jax_model_factory(jax_opt.model, val_set.num_words, val_set.num_answers)
    params = model.init(jax.random.key(2), jnp.zeros((2,) + val_set.feature_shape),
                        jnp.zeros((2, jax_opt.vqa.maxlength), jnp.int32),
                        jnp.ones((2,), jnp.int32))["params"]
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [p + 0.02 * (i % 5) for i, p in enumerate(leaves)])
    npz = os.path.join(d, "params.npz")
    save_tree_npz(npz, params)

    opts = overrides + [f"model.pretrained_params={npz}"]
    logs = {}
    for label, main in (("port", port_cli.main), ("jax", jax_main)):
        logs[label] = str(tmp_path / label)
        assert main(["--path_opt", path_opt, "-e", "--platform", "cpu", "--dir_logs",
                     logs[label]] + [a for o in opts for a in ("--opt", o)]) == 0
    assert _metrics(logs["port"]) == _metrics(logs["jax"])
    opt = load_options(path_opt, overrides)
    ds = port_factory.factory("val", opt)
    port_model = model_factory(dataclasses.asdict(opt.model), ds.num_words, ds.num_answers,
                               dim_v=ds.feature_shape[-1])
    with np.load(npz) as flat:
        load_params(port_model, flat)
    _assert_same_answers(_results(logs["port"], "val"), _results(logs["jax"], "val"), ds,
                         port_model.eval(), ds.vocabs.aid_to_ans,
                         lambda rows: torch.from_numpy(ds.features.get(ds.image_index[rows])))
