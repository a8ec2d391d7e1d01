"""The port's modules (vqa_tpu_torch/models) against the flax originals.

Each flax module is initialised, its param tree flattened
(vqa_tpu.importers.flatten_tree) and loaded into the port's counterpart
(weights.load_params); both then run float32 on the CPU on the same numpy
inputs, and the outputs agree within 1e-4 (float32, sums taken in another
order through several matmuls).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.config import load_options
from vqa_tpu.importers import flatten_tree
from vqa_tpu.models import factory as jax_factory
from vqa_tpu.models import fusion as jax_fusion
from vqa_tpu.models import seq2vec as jax_seq2vec
from vqa_tpu.models.att import GlimpseAttention as JaxGlimpseAttention
from vqa_tpu.models.classifier import Classifier as JaxClassifier
from vqa_tpu_torch import flagship
from vqa_tpu_torch.models import factory as port_factory
from vqa_tpu_torch.models.att import GlimpseAttention
from vqa_tpu_torch.models.classifier import Classifier
from vqa_tpu_torch.models.fusion import MutanFusion
from vqa_tpu_torch.models.seq2vec import SeqEncoder
from vqa_tpu_torch.weights import load_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
TINY = [  # __graft_entry__._flagship_model(tiny=True) dims
    "model.seq2vec.emb_size=16", "model.seq2vec.hidden_size=32",
    "model.attention.dim_hv=12", "model.attention.dim_hq=12",
    "model.attention.dim_mm=16", "model.attention.R=2",
    "model.fusion.dim_hv=12", "model.fusion.dim_hq=12",
    "model.fusion.dim_mm=16", "model.fusion.R=2",
]


def _init(module, *inputs, seed=0):
    return module.init(jax.random.key(seed), *(jnp.asarray(x) for x in inputs))["params"]


def _load(port_module, jax_params):
    load_params(port_module, flatten_tree(jax_params))
    return port_module.eval()


def _tokens(rng, B, T, num_words):
    """Mixed lengths; odd rows left-padded, one row of length 1."""
    tokens = np.zeros((B, T), np.int32)
    lengths = rng.integers(1, T + 1, B)
    lengths[0] = 1
    for i, n in enumerate(lengths):
        ids = rng.integers(1, num_words, n)
        if i % 2:
            tokens[i, T - n:] = ids
        else:
            tokens[i, :n] = ids
    return tokens


@pytest.mark.parametrize("core_bias", [True, False])
@pytest.mark.parametrize("per_region", [False, True])
def test_mutan_fusion_matches_flax(core_bias, per_region):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 1, 10) if per_region else (3, 10)).astype(np.float32)
    v = rng.standard_normal((3, 5, 14) if per_region else (3, 14)).astype(np.float32)
    jax_mod = jax_fusion.MutanFusion(dim_hq=6, dim_hv=7, dim_mm=9, R=3, core_bias=core_bias)
    params = _init(jax_mod, q, v)
    if core_bias:  # flax inits the core biases at zero; make them count
        params = jax.tree.map(lambda p: p + 0.1, params)
    port = _load(MutanFusion(10, 14, dim_hq=6, dim_hv=7, dim_mm=9, R=3, core_bias=core_bias),
                 params)
    want = jax_mod.apply({"params": params}, jnp.asarray(q), jnp.asarray(v))
    got = port(torch.from_numpy(q), torch.from_numpy(v))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("num_layers,return_sequence", [(1, False), (2, False), (1, True)])
def test_seq_encoder_matches_flax(num_layers, return_sequence):
    rng = np.random.default_rng(2)
    tokens = _tokens(rng, 7, 9, 30)
    kw = dict(vocab_size=30, emb_size=8, hidden_size=12, num_layers=num_layers,
              return_sequence=return_sequence)
    jax_mod = jax_seq2vec.SeqEncoder(**kw)
    params = _init(jax_mod, tokens)
    port = _load(SeqEncoder(**kw), params)
    want = jax_mod.apply({"params": params}, jnp.asarray(tokens))
    got = port(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dim_h", [None, 6])
def test_classifier_matches_flax(dim_h):
    z = np.random.default_rng(3).standard_normal((4, 10)).astype(np.float32)
    jax_mod = JaxClassifier(num_answers=5, dim_h=dim_h)
    params = _init(jax_mod, z)
    port = _load(Classifier(10, 5, dim_h=dim_h), params)
    want = jax_mod.apply({"params": params}, jnp.asarray(z))
    np.testing.assert_allclose(port(torch.from_numpy(z)).detach().numpy(), np.asarray(want), **TOL)


def test_glimpse_attention_matches_flax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 10)).astype(np.float32)
    v = rng.standard_normal((3, 6, 14)).astype(np.float32)
    jax_mod = JaxGlimpseAttention(
        fusion=jax_fusion.MutanFusion(dim_hq=6, dim_hv=7, dim_mm=9, R=3), nb_glimpses=2
    )
    params = _init(jax_mod, q, v)
    port = _load(GlimpseAttention(MutanFusion(10, 14, dim_hq=6, dim_hv=7, dim_mm=9, R=3), 2,
                                  torch.float32, "cpu"), params)
    want_att, want_alpha = jax_mod.apply({"params": params}, jnp.asarray(q), jnp.asarray(v))
    got_att, got_alpha = port(torch.from_numpy(q), torch.from_numpy(v))
    np.testing.assert_allclose(got_att.detach().numpy(), np.asarray(want_att), **TOL)
    np.testing.assert_allclose(got_alpha.detach().numpy(), np.asarray(want_alpha), **TOL)


def _mutan_att(overrides, num_words=40, num_answers=11, dim_v=24, seed=0):
    opt = load_options(os.path.join(REPO, "options/vqa2/mutan_att.yaml"), TINY + overrides)
    jax_model = jax_factory(opt.model, num_words, num_answers)
    rng = np.random.default_rng(seed)
    visual = rng.standard_normal((6, 5, dim_v)).astype(np.float32)
    tokens = _tokens(rng, 6, 8, num_words)
    params = _init(jax_model, visual[:2], tokens[:2], seed=seed)
    params = jax.tree.map(lambda p: p + 0.05, params)  # non-zero biases throughout
    port = _load(port_factory(dataclasses.asdict(opt.model), num_words, num_answers,
                              dim_v=dim_v), params)
    return jax_model, params, port, visual, tokens


@pytest.mark.parametrize("overrides", [
    [],
    ["model.l2norm_visual=true"],
    ["model.attention.core_bias=false", "model.fusion.core_bias=false"],
])
def test_mutan_att_logits_match_flax(overrides):
    jax_model, params, port, visual, tokens = _mutan_att(overrides)
    want, want_alpha = jax_model.apply({"params": params}, jnp.asarray(visual),
                                       jnp.asarray(tokens), return_attention=True)
    with torch.inference_mode():
        got, got_alpha = port(torch.from_numpy(visual), torch.from_numpy(tokens),
                              return_attention=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_alpha.numpy(), np.asarray(want_alpha), **TOL)


def test_tiny_flagship_builds_the_flax_tree():
    """flagship.build(tiny=True) is __graft_entry__'s tiny model, leaf for leaf."""
    jax_model, params, _, _, _ = _mutan_att([])
    port = flagship.build(40, 11, tiny=True, dim_v=24)
    want = {k: v.shape for k, v in flatten_tree(params).items()}
    got = {name.replace(".", "/"): tuple(p.shape) for name, p in port.named_parameters()}
    assert got == want


@pytest.mark.parametrize("section,value,match", [
    ("arch", "MFBCoAtt", "queue 1 item 7"),
    ("arch", "CoR", "queue 1 item 8"),
    ("arch", "MLBAtt", "queue 1 item 6"),
    ("seq2vec", {"arch": "gru"}, "queue 1 item 6"),
    ("fusion", {"arch": "mfb"}, "queue 1 item 7"),
])
def test_unported_archs_name_their_roadmap_item(section, value, match):
    opt = flagship.model_options(tiny=True)
    opt[section] = value
    with pytest.raises(NotImplementedError, match=match):
        port_factory(opt, 40, 11)


def test_misspelled_option_fails_loudly():
    opt = flagship.model_options(tiny=True)
    opt["attention"]["dim_mmm"] = 3
    with pytest.raises(KeyError, match="dim_mmm"):
        port_factory(opt, 40, 11)


def test_example_batch_is_seeded_and_runs_the_tiny_flagship():
    a = flagship.example_batch(batch=3, seq=6, regions=5, dim=24, num_words=40, seed=1)
    b = flagship.example_batch(batch=3, seq=6, regions=5, dim=24, num_words=40, seed=1)
    for key in ("visual", "question", "length"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["question"].min() >= 1 and a["question"].max() < 40
    port = flagship.build(40, 11, tiny=True, dim_v=24)
    with torch.inference_mode():
        logits = port(*(torch.from_numpy(a[k]) for k in ("visual", "question", "length")))
    assert logits.shape == (3, 11) and bool(torch.isfinite(logits).all())


def test_train_is_not_ported():
    port = flagship.build(40, 11, tiny=True, dim_v=24)
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        port(torch.zeros(2, 5, 24), torch.ones(2, 3, dtype=torch.int32), train=True)
