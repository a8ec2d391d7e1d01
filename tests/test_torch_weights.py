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
from vqa_tpu_torch.models import factory as port_factory
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
    return flagship.build(40, 11, tiny=True, dim_v=24, device="cpu")


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
    model = flagship.build(device="cpu")
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
    model = flagship.build(40, 11, tiny=True, dtype=torch.bfloat16, dim_v=24, device="cpu")
    load_params(model, flatten_tree(jax_tiny_params))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    wh = flatten_tree(jax_tiny_params)["encoder/lstm_0/wh"]
    np.testing.assert_array_equal(model.encoder.lstm_0.wh.float().numpy(),
                                  torch.tensor(wh).bfloat16().float().numpy())


def test_train_build_holds_float32_masters_of_the_same_values(jax_tiny_params):
    """The same flax tree in an eval build (bf16, no grads, as before) and in
    a training build (float32 parameters that take grads, cast to bf16 in
    each layer): the train build's forward without grads equals the eval
    build's bit for bit."""
    flat = flatten_tree(jax_tiny_params)
    evals = flagship.build(40, 11, tiny=True, dtype=torch.bfloat16, dim_v=24, device="cpu")
    load_params(evals, flat)
    train = port_factory(flagship.model_options(tiny=True), 40, 11, dtype=torch.bfloat16,
                         dim_v=24, device="cpu", train=True)
    load_params(train, flat)
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in evals.parameters())
    assert all(p.dtype == torch.float32 and p.requires_grad for p in train.parameters())
    batch = flagship.example_batch(batch=3, seq=6, regions=5, dim=24, num_words=40, seed=2)
    inputs = [torch.from_numpy(batch[k]) for k in ("visual", "question", "length")]
    with torch.inference_mode():
        assert torch.equal(evals(*inputs), train(*inputs))


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


# flagship.VARIANTS as the --opt overrides of their base YAML
VARIANT_OVERRIDES = {
    "concat_noatt": ["model.arch=ConcatNoAtt",
                     "model.fusion={arch: concat, dropout_v: 0.5, dropout_q: 0.5}"],
    "mutan_att_skipthoughts": ["model.seq2vec.arch=skipthoughts"],
}


def _yaml_options(name):
    """load_options of options/vqa2/<name>.yaml, or of a variant's base YAML
    with the variant's overrides."""
    if name in flagship.VARIANTS:
        base = flagship.VARIANTS[name][0]
        return load_options(os.path.join(REPO, f"options/vqa2/{base}.yaml"),
                            VARIANT_OVERRIDES[name])
    return load_options(os.path.join(REPO, f"options/vqa2/{name}.yaml"))


@pytest.mark.parametrize("name", ["mfb_coatt", "mfh_coatt", "cor", "concat_att", "mlb_att",
                                  "mutan_noatt", "mlb_noatt"])
def test_config_dict_equals_the_yaml(name):
    """The model sections the GPU path builds from, and each family's answer
    count (vqa.nans: 3000 for CoR)."""
    opt = load_options(os.path.join(REPO, f"options/vqa2/{name}.yaml"))
    model, num_answers = flagship.CONFIGS[name]
    assert flagship.model_options(name=name) == model == dataclasses.asdict(opt.model)
    assert num_answers == opt.vqa.nans


@pytest.mark.parametrize("name", sorted(VARIANT_OVERRIDES))
def test_variant_dict_equals_the_yaml_with_its_overrides(name):
    """ConcatNoAtt (no YAML of its own) and MutanAtt with the skip-thoughts
    encoder, as their base YAML with the overrides give them."""
    assert set(VARIANT_OVERRIDES) == set(flagship.VARIANTS)
    opt = _yaml_options(name)
    assert flagship.model_options(name=name) == dataclasses.asdict(opt.model)
    assert flagship.answer_count(name) == opt.vqa.nans
    assert flagship.model_options(name=name) is not flagship.model_options(name=name)


@pytest.mark.parametrize("name", ["mutan_att", "mfb_coatt", "mfh_coatt", "cor", "concat_att",
                                  "mlb_att", "mutan_noatt", "mlb_noatt", "concat_noatt",
                                  "mutan_att_skipthoughts"])
def test_full_width_tree_equals_flax(name):
    """At the YAML's full widths (12,000 words, 36x2048 regions), the port's
    parameters are flax's tree leaf for leaf (shapes from jax.eval_shape;
    the port built on the meta device, so nothing is allocated)."""
    opt = _yaml_options(name)
    jax_model = jax_factory(opt.model, flagship.NUM_WORDS, opt.vqa.nans)
    shapes = jax.eval_shape(jax_model.init, jax.random.key(0), jnp.zeros((1, 36, 2048)),
                            jnp.ones((1, 26), jnp.int32))["params"]
    want = {"/".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    port = flagship.build_config(name, device="meta")
    got = {n.replace(".", "/"): tuple(p.shape) for n, p in port.named_parameters()}
    assert got == want


def test_tiny_flagship_dict_equals_the_yaml_with_tiny_overrides():
    overrides = [f"model.{section}.{k}={v}" for section, values in flagship._TINY.items()
                 for k, v in values.items()]
    opt = load_options(os.path.join(REPO, "options/vqa2/mutan_att.yaml"), overrides)
    assert flagship.model_options(tiny=True) == dataclasses.asdict(opt.model)
