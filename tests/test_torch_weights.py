"""The weight bridge (vqa_tpu_torch/weights.py) and the flagship config copy."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.config import load_options
from vqa_tpu.importers import flatten_tree, save_tree_npz
from vqa_tpu.models import factory as jax_factory
from vqa_tpu_torch import flagship
from vqa_tpu_torch.weights import export_params, load_params, random_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tiny_params():
    """The tiny flagship's flax params (__graft_entry__ tiny dims), with
    every leaf perturbed so no two leaves share values by accident."""
    opt = load_options(os.path.join(REPO, "options/vqa2/mutan_att.yaml"),
                       [f"model.{k}" for k in (
                           "seq2vec.emb_size=16", "seq2vec.hidden_size=32",
                           "attention.dim_hv=12", "attention.dim_hq=12",
                           "attention.dim_mm=16", "attention.R=2", "fusion.dim_hv=12",
                           "fusion.dim_hq=12", "fusion.dim_mm=16", "fusion.R=2")])
    model = jax_factory(opt.model, 40, 11)
    params = model.init(jax.random.key(3), jnp.zeros((2, 5, 24)), jnp.ones((2, 4), jnp.int32),
                        jnp.ones((2,), jnp.int32))["params"]
    leaves, tree = jax.tree.flatten(params)
    return jax.tree.unflatten(tree, [p + 0.01 * i for i, p in enumerate(leaves)])


def _port():
    return flagship.build(40, 11, tiny=True, dim_v=24)


def test_npz_roundtrip_is_byte_identical(jax_tiny_params, tmp_path):
    src = tmp_path / "params.npz"
    save_tree_npz(str(src), jax_tiny_params)
    model = _port()
    with np.load(src) as flat:
        load_params(model, flat)
    dst = tmp_path / "back.npz"
    np.savez(dst, **export_params(model))
    with np.load(src) as a, np.load(dst) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key


def test_key_set_equals_the_flax_tree(jax_tiny_params):
    assert set(export_params(_port())) == set(flatten_tree(jax_tiny_params))


def test_full_flagship_matches_the_published_size():
    model = flagship.build()
    assert len(list(model.parameters())) == 24
    assert sum(p.numel() for p in model.parameters()) == 46_091_272
    assert tuple(model.encoder.lstm_0.wh.shape) == (2400, 9600)


def test_missing_extra_and_misshaped_keys_raise(jax_tiny_params):
    flat = flatten_tree(jax_tiny_params)
    model = _port()
    missing = {k: v for k, v in flat.items() if k != "encoder/lstm_0/wh"}
    with pytest.raises(KeyError, match="encoder/lstm_0/wh"):
        load_params(model, missing)
    with pytest.raises(KeyError, match="encoder/lstm_0/extra"):
        load_params(model, {**flat, "encoder/lstm_0/extra": np.zeros(3)})
    bad = dict(flat)
    bad["classifier/logits/kernel"] = bad["classifier/logits/kernel"].T
    with pytest.raises(ValueError, match="classifier/logits/kernel"):
        load_params(model, bad)


def test_values_land_in_the_model_dtype(jax_tiny_params):
    model = flagship.build(40, 11, tiny=True, dtype=torch.bfloat16, dim_v=24)
    load_params(model, flatten_tree(jax_tiny_params))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    wh = flatten_tree(jax_tiny_params)["encoder/lstm_0/wh"]
    np.testing.assert_array_equal(model.encoder.lstm_0.wh.float().numpy(),
                                  torch.tensor(wh).bfloat16().float().numpy())


def test_random_params_are_seeded():
    a, b = _port(), _port()
    random_params(a, 5)
    random_params(b, 5)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert a.encoder.lstm_0.wh.abs().sum() > 0 and a.classifier.logits.bias.abs().sum() == 0


def test_flagship_dict_equals_the_yaml():
    opt = load_options(os.path.join(REPO, "options/vqa2/mutan_att.yaml"))
    assert flagship.model_options() == dataclasses.asdict(opt.model)


def test_tiny_flagship_dict_equals_the_yaml_with_tiny_overrides():
    overrides = [f"model.{section}.{k}={v}" for section, values in flagship._TINY.items()
                 for k, v in values.items()]
    opt = load_options(os.path.join(REPO, "options/vqa2/mutan_att.yaml"), overrides)
    assert flagship.model_options(tiny=True) == dataclasses.asdict(opt.model)
