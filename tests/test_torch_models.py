"""The port's modules (vqa_tpu_torch/models) against the flax originals.

Each flax module is initialised, its param tree flattened
(vqa_tpu.importers.flatten_tree) and loaded into the port's counterpart
(weights.load_params); both then run float32 on the CPU on the same numpy
inputs, and the outputs agree within 1e-4 (float32, sums taken in another
order through several matmuls; 1e-5 for a single module). The bf16 cases
run both sides in bf16, held to the watch list's bf16 tolerance (0.05).
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
from vqa_tpu.models.cor import CoRStep as JaxCoRStep
from vqa_tpu.models.mfb import QuestionSelfAttention as JaxQuestionSelfAttention
from vqa_tpu.models.noatt import NoAttModel as JaxNoAttModel
from vqa_tpu_torch import flagship
from vqa_tpu_torch.models import factory as port_factory
from vqa_tpu_torch.models.att import GlimpseAttention
from vqa_tpu_torch.models.classifier import Classifier
from vqa_tpu_torch.models.cor import CoRStep
from vqa_tpu_torch.models.fusion import (ConcatFusion, MFBFusion, MFHFusion, MLBFusion,
                                         MutanFusion)
from vqa_tpu_torch.models.mfb import QuestionSelfAttention
from vqa_tpu_torch.models.noatt import NoAttModel
from vqa_tpu_torch.models.seq2vec import GRULayer, SeqEncoder
from vqa_tpu_torch.models.seq2vec import factory as port_seq2vec_factory
from vqa_tpu_torch.weights import load_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)  # one module, float32 on both sides
# bf16 on both sides, roundings at other places (ROADMAP queue 3's watch list)
BF16_ATOL = 0.05
TINY_ARCHS = {  # tiny widths of the other graded configs the port runs
    "mfb_coatt": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                  "model.attention.dim_h=6", "model.fusion.dim_mm=4",
                  "model.fusion.pool_factor=3"],
    "mfh_coatt": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                  "model.attention.dim_h=6", "model.fusion.dim_mm=4",
                  "model.fusion.pool_factor=3", "model.fusion.mfh_order=3"],
    "cor": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
            "model.fusion.dim_h=10", "model.classif.dim_h=7"],
    "concat_att": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                   "model.attention.dim_h=9", "model.classif.dim_h=7"],
    "mlb_att": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                "model.attention.dim_h=10", "model.fusion.dim_h=9"],
    "mutan_noatt": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                    "model.fusion.dim_hv=7", "model.fusion.dim_hq=6", "model.fusion.dim_mm=9",
                    "model.fusion.R=3"],
    "mlb_noatt": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                  "model.fusion.dim_h=9"],
    # the variants no YAML holds (flagship.VARIANTS), from their base YAML
    "concat_noatt": ["model.seq2vec.emb_size=8", "model.seq2vec.hidden_size=12",
                     "model.arch=ConcatNoAtt",
                     "model.fusion={arch: concat, dropout_v: 0.5, dropout_q: 0.5}"],
    "mutan_att_skipthoughts": ["model.seq2vec.arch=skipthoughts", "model.seq2vec.emb_size=8",
                               "model.seq2vec.hidden_size=12", "model.attention.dim_hv=6",
                               "model.attention.dim_hq=5", "model.attention.dim_mm=7",
                               "model.attention.R=2", "model.fusion.dim_hv=6",
                               "model.fusion.dim_hq=5", "model.fusion.dim_mm=7",
                               "model.fusion.R=2"],
}
NEW_ARCHS = ("concat_att", "mlb_att", "mutan_noatt", "mlb_noatt", "concat_noatt",
             "mutan_att_skipthoughts")
NOATT = ("mutan_noatt", "mlb_noatt", "concat_noatt")
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


def _plus(params, delta=0.1):
    """flax inits biases at zero; make them count."""
    return jax.tree.map(lambda p: p + delta, params)


def _pair(rng, per_region, dq=10, dv=14):
    q = rng.standard_normal((3, 1, dq) if per_region else (3, dq)).astype(np.float32)
    v = rng.standard_normal((3, 5, dv) if per_region else (3, dv)).astype(np.float32)
    return q, v


@pytest.mark.parametrize("per_region", [False, True])
def test_mfb_fusion_matches_flax(per_region):
    """(pooled, pre-pool z), per region (q broadcast over 5 regions) and per row."""
    q, v = _pair(np.random.default_rng(11), per_region)
    jax_mod = jax_fusion.MFBFusion(pool_factor=3, dim_mm=4)
    params = _plus(_init(jax_mod, q, v))
    port = _load(MFBFusion(10, 14, pool_factor=3, dim_mm=4), params)
    want = jax_mod.apply({"params": params}, jnp.asarray(q), jnp.asarray(v))
    got = port(torch.from_numpy(q), torch.from_numpy(v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("per_region", [False, True])
def test_mfh_fusion_matches_flax(per_region):
    """Three cascaded blocks: block i multiplies by block i-1's pre-pool z."""
    q, v = _pair(np.random.default_rng(12), per_region)
    jax_mod = jax_fusion.MFHFusion(pool_factor=3, dim_mm=4, mfh_order=3)
    params = _plus(_init(jax_mod, q, v))
    port = _load(MFHFusion(10, 14, pool_factor=3, dim_mm=4, mfh_order=3), params)
    want = jax_mod.apply({"params": params}, jnp.asarray(q), jnp.asarray(v))
    got = port(torch.from_numpy(q), torch.from_numpy(v))
    assert got.shape[-1] == port.out_dim == 12
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_question_self_attention_matches_flax():
    """Mixed lengths, left-padded rows and an all-padding row (uniform
    weights over its zeroed steps, as jax.nn.softmax gives)."""
    rng = np.random.default_rng(13)
    tokens = _tokens(rng, 6, 7, 30)
    tokens[3] = 0                                   # all padding
    mask = tokens != 0
    seq = rng.standard_normal((6, 7, 12)).astype(np.float32) * mask[..., None]
    jax_mod = JaxQuestionSelfAttention(glimpses=2, dim_h=6)
    params = _plus(_init(jax_mod, seq, mask))
    port = _load(QuestionSelfAttention(12, glimpses=2, dim_h=6), params)
    want = jax_mod.apply({"params": params}, jnp.asarray(seq), jnp.asarray(mask))
    got = port(torch.from_numpy(seq), torch.from_numpy(mask))
    assert got.shape == (6, 24)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[3].numpy(), 0.0)


def test_glimpse_attention_with_hidden_and_mfb_fusion_matches_flax():
    """MFB co-attention's region attention: a tuple-returning fusion, then
    the 'hidden' Dense + relu before the glimpse logits."""
    rng = np.random.default_rng(14)
    q = rng.standard_normal((3, 10)).astype(np.float32)
    v = rng.standard_normal((3, 6, 14)).astype(np.float32)
    jax_mod = JaxGlimpseAttention(fusion=jax_fusion.MFBFusion(pool_factor=3, dim_mm=4),
                                  nb_glimpses=2, dim_h=6, activation="relu")
    params = _plus(_init(jax_mod, q, v))
    port = _load(GlimpseAttention(MFBFusion(10, 14, pool_factor=3, dim_mm=4), 2, torch.float32,
                                  "cpu", dim_h=6, activation="relu"), params)
    want_att, want_alpha = jax_mod.apply({"params": params}, jnp.asarray(q), jnp.asarray(v))
    got_att, got_alpha = port(torch.from_numpy(q), torch.from_numpy(v))
    np.testing.assert_allclose(got_att.detach().numpy(), np.asarray(want_att), **TOL)
    np.testing.assert_allclose(got_alpha.detach().numpy(), np.asarray(want_alpha), **TOL)


def test_cor_step_matches_flax():
    """One chain step: refreshed objects, the decision and beta; object
    width 7, working width 8, question width 10."""
    rng = np.random.default_rng(15)
    objects = np.tanh(rng.standard_normal((4, 6, 7))).astype(np.float32)
    q = rng.standard_normal((4, 10)).astype(np.float32)
    jax_mod = JaxCoRStep(dim_h=8)
    params = _plus(jax_mod.init(jax.random.key(0), (jnp.asarray(objects), jnp.asarray(q)),
                                None)["params"], 0.05)
    port = _load(CoRStep(10, 7, 8), params)
    (want_obj, _), (want_dec, want_beta) = jax_mod.apply(
        {"params": params}, (jnp.asarray(objects), jnp.asarray(q)), None)
    got_obj, got_dec, got_beta = port(torch.from_numpy(objects), torch.from_numpy(q))
    for got, want in ((got_obj, want_obj), (got_dec, want_dec), (got_beta, want_beta)):
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


def _arch(name, overrides, num_words=30, num_answers=11, dim_v=14, seed=0, pooled=False,
          dtype=torch.float32):
    """A tiny model of config ``name`` (a variant: of its base YAML) in flax
    and in the port, with the same non-zero params; ``pooled`` gives a 2-D
    visual, the pooled table's rows, as the NoAtt archs read them."""
    yaml = flagship.VARIANTS[name][0] if name in flagship.VARIANTS else name
    opt = load_options(os.path.join(REPO, f"options/vqa2/{yaml}.yaml"),
                       TINY_ARCHS[name] + overrides)
    jax_model = jax_factory(opt.model, num_words, num_answers,
                            dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    rng = np.random.default_rng(seed)
    visual = rng.standard_normal((6,) + ((dim_v,) if pooled else (5, dim_v))).astype(np.float32)
    tokens = _tokens(rng, 6, 8, num_words)
    tokens[4] = 0  # the empty question
    params = _init(jax_model, visual[:2], tokens[:2], seed=seed)
    params = jax.tree.map(lambda p: p + 0.05, params)  # non-zero biases throughout
    port = _load(port_factory(dataclasses.asdict(opt.model), num_words, num_answers,
                              dtype=dtype, dim_v=dim_v), params)
    return jax_model, params, port, visual, tokens


@pytest.mark.parametrize("name,overrides", [
    ("mfb_coatt", []),
    ("mfb_coatt", ["model.l2norm_visual=false"]),
    ("mfh_coatt", []),
    ("cor", []),
    ("cor", ["model.l2norm_visual=false"]),
])
def test_coatt_and_cor_logits_match_flax(name, overrides):
    """Logits, and the attention maps: MFB's region alpha [B, R, G], CoR's
    per-step betas [B, N, steps]."""
    jax_model, params, port, visual, tokens = _arch(name, overrides)
    want, want_att = jax_model.apply({"params": params}, jnp.asarray(visual),
                                     jnp.asarray(tokens), return_attention=True)
    with torch.inference_mode():
        got, got_att = port(torch.from_numpy(visual), torch.from_numpy(tokens),
                            return_attention=True)
    assert got_att.shape == (6, 5, 3 if name == "cor" else 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att), **TOL)


@pytest.mark.parametrize("name", sorted(TINY_ARCHS))
def test_port_params_are_the_flax_tree(name):
    """Leaf for leaf: CoR's shared chain step has no step index."""
    _, params, port, _, _ = _arch(name, [])
    want = {k: v.shape for k, v in flatten_tree(params).items()}
    got = {n.replace(".", "/"): tuple(p.shape) for n, p in port.named_parameters()}
    assert got == want


def test_tiny_flagship_builds_the_flax_tree():
    """flagship.build(tiny=True) is __graft_entry__'s tiny model, leaf for leaf."""
    jax_model, params, _, _, _ = _mutan_att([])
    port = flagship.build(40, 11, tiny=True, dim_v=24, device="cpu")
    want = {k: v.shape for k, v in flatten_tree(params).items()}
    got = {name.replace(".", "/"): tuple(p.shape) for name, p in port.named_parameters()}
    assert got == want


@pytest.mark.parametrize("fusion", [
    {"arch": "mfb", "mfh_order": 2},          # an MFH knob on MFB
    {"arch": "mutan", "pool_factor": 5},      # an MFB knob on MUTAN
])
def test_fusion_options_are_checked_per_arch(fusion):
    """The exact per-arch key check of vqa_tpu/models/fusion.py:198-217."""
    opt = flagship.model_options(tiny=True)
    opt["fusion"] = fusion
    with pytest.raises(KeyError, match="unknown option"):
        port_factory(opt, 40, 11)


@pytest.mark.parametrize("arch", ["mfb", "mfh"])
def test_mutan_att_with_an_mfb_final_fusion_matches_flax(arch):
    """The attention family's final fusion may be MFB (tuple output) or MFH."""
    jax_model, params, port, visual, tokens = _mutan_att(
        [f"model.fusion={{arch: {arch}, pool_factor: 3, dim_mm: 4}}"])
    want = jax_model.apply({"params": params}, jnp.asarray(visual), jnp.asarray(tokens))
    with torch.inference_mode():
        got = port(torch.from_numpy(visual), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    port = flagship.build(40, 11, tiny=True, dim_v=24, device="cpu")
    with torch.inference_mode():
        logits = port(*(torch.from_numpy(a[k]) for k in ("visual", "question", "length")))
    assert logits.shape == (3, 11) and bool(torch.isfinite(logits).all())


def test_gru_layer_matches_flax():
    """The GRU cell (gates r, z, n; bh inside r * (h wh_n + bh_n)) over mixed
    lengths, left- and right-padded rows and a fully padded one; biases
    non-zero, so bx and bh each count."""
    rng = np.random.default_rng(21)
    tokens = _tokens(rng, 7, 9, 30)
    tokens[5] = 0  # fully padded
    mask = (tokens != 0).astype(np.float32).T[..., None]              # [T, B, 1]
    x = rng.standard_normal((9, 7, 8)).astype(np.float32)
    jax_mod = jax_seq2vec.GRULayer(hidden_size=12)
    params = _plus(_init(jax_mod, x, mask))
    port = _load(GRULayer(8, 12, torch.float32, "cpu"), params)
    want_h, want_seq = jax_mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    got_h, got_seq = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **MODULE_TOL)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), **MODULE_TOL)
    np.testing.assert_array_equal(got_h[5].numpy(), 0.0)


@pytest.mark.parametrize("num_layers,return_sequence", [(1, False), (2, False), (1, True),
                                                        (2, True)])
def test_gru_seq_encoder_matches_flax(num_layers, return_sequence):
    """SeqEncoder with cell="gru": layers named gru_{i}, as in flax."""
    rng = np.random.default_rng(22)
    tokens = _tokens(rng, 7, 9, 30)
    kw = dict(vocab_size=30, emb_size=8, hidden_size=12, num_layers=num_layers,
              return_sequence=return_sequence, cell="gru")
    jax_mod = jax_seq2vec.SeqEncoder(**kw)
    params = _plus(_init(jax_mod, tokens))
    port = _load(SeqEncoder(**kw), params)
    assert {n.split(".")[0] for n, _ in port.named_parameters()} == \
        {"embed"} | {f"gru_{i}" for i in range(num_layers)}
    want = jax_mod.apply({"params": params}, jnp.asarray(tokens))
    got = port(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("opt,cell,layers,hidden", [
    ({"arch": "skipthoughts"}, "gru", 1, 2400),
    ({"arch": "skipthoughts", "num_layers": 3, "hidden_size": 20}, "gru", 1, 20),
    ({"arch": "gru", "num_layers": 2}, "gru", 2, 1024),
    ({"arch": "lstm"}, "lstm", 1, 1024),
])
def test_seq2vec_factory_builds_as_flax(opt, cell, layers, hidden):
    """skipthoughts: one GRU layer whatever num_layers says, 2400 units by
    default; gru keeps num_layers; both default emb 620."""
    jax_mod = jax_seq2vec.factory(40, opt)
    port = port_seq2vec_factory(40, opt, device="meta")
    assert (port.cell, port.num_layers, port.hidden_size) == \
        (jax_mod.cell, jax_mod.num_layers, jax_mod.hidden_size) == (cell, layers, hidden)
    assert tuple(port.embed.embedding.shape) == (40, jax_mod.emb_size) == (40, 620)


@pytest.mark.parametrize("per_region", [False, True])
def test_concat_fusion_matches_flax(per_region):
    """q [3, 1, 10] broadcast over 5 regions of v (or one row each)."""
    q, v = _pair(np.random.default_rng(23), per_region)
    jax_mod = jax_fusion.ConcatFusion()
    want = jax_mod.apply({}, jnp.asarray(q), jnp.asarray(v))
    port = ConcatFusion(10, 14)
    got = port(torch.from_numpy(q), torch.from_numpy(v))
    assert got.shape[-1] == port.out_dim == 24
    assert tuple(got.shape) == tuple(want.shape) == ((3, 5, 24) if per_region else (3, 24))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("per_region", [False, True])
@pytest.mark.parametrize("acts", [("tanh", "tanh"), ("relu", "none")])
def test_mlb_fusion_matches_flax(per_region, acts):
    q, v = _pair(np.random.default_rng(24), per_region)
    jax_mod = jax_fusion.MLBFusion(dim_h=9, activation_q=acts[0], activation_v=acts[1])
    params = _plus(_init(jax_mod, q, v))
    port = _load(MLBFusion(10, 14, dim_h=9, activation_q=acts[0], activation_v=acts[1]), params)
    want = jax_mod.apply({"params": params}, jnp.asarray(q), jnp.asarray(v))
    got = port(torch.from_numpy(q), torch.from_numpy(v))
    assert got.shape[-1] == port.out_dim == 9
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("regions", [None, 5])
@pytest.mark.parametrize("l2norm_visual", [False, True])
def test_noatt_model_matches_flax(regions, l2norm_visual):
    """The pooled visual [B, Dv], or regions [B, R, Dv] mean-pooled first;
    an MLB fusion, so the fusion's tuple-free output feeds the classifier."""
    rng = np.random.default_rng(25)
    visual = rng.standard_normal((4,) + ((regions,) if regions else ()) + (14,))
    visual = visual.astype(np.float32)
    tokens = _tokens(rng, 4, 6, 30)
    jax_mod = JaxNoAttModel(
        encoder=jax_seq2vec.SeqEncoder(vocab_size=30, emb_size=8, hidden_size=10),
        fusion=jax_fusion.MLBFusion(dim_h=9), classifier=JaxClassifier(num_answers=7),
        l2norm_visual=l2norm_visual)
    params = _plus(_init(jax_mod, visual, tokens))
    port = _load(NoAttModel(SeqEncoder(30, emb_size=8, hidden_size=10), MLBFusion(10, 14, dim_h=9),
                            Classifier(9, 7), l2norm_visual=l2norm_visual), params)
    want = jax_mod.apply({"params": params}, jnp.asarray(visual), jnp.asarray(tokens))
    with torch.inference_mode():
        got = port(torch.from_numpy(visual), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("name,pooled", [(n, False) for n in NEW_ARCHS] +
                         [(n, True) for n in NOATT])
def test_new_archs_logits_match_flax(name, pooled):
    """ConcatAtt, MLBAtt, the three NoAtt archs (over region features and
    over the pooled table's 2-D rows) and MutanAtt with the skip-thoughts
    GRU, float32 at tiny widths; the attention family's alpha too."""
    jax_model, params, port, visual, tokens = _arch(name, [], pooled=pooled)
    assert type(port).__name__ == type(jax_model).__name__
    kw = {} if name in NOATT else {"return_attention": True}
    want = jax_model.apply({"params": params}, jnp.asarray(visual), jnp.asarray(tokens), **kw)
    with torch.inference_mode():
        got = port(torch.from_numpy(visual), torch.from_numpy(tokens), **kw)
    for g, w in zip(*((got, want) if kw else ((got,), (want,)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_new_archs_bf16_logits_match_flax(name):
    """Both sides in bf16 (flax's dtype=bfloat16, the port's bf16 params):
    roundings at other places, held to the watch list's bf16 tolerance."""
    jax_model, params, port, visual, tokens = _arch(name, [], dtype=torch.bfloat16)
    want = jax_model.apply({"params": params}, jnp.asarray(visual), jnp.asarray(tokens))
    with torch.inference_mode():
        got = port(torch.from_numpy(visual), torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("name,attention", [
    ("concat_att", {"activation": "relu"}),
    ("mlb_att", {"activation": "relu"}),
    ("mlb_att", {"activation_q": "relu", "activation_v": "none"}),
    ("mlb_att", {"activation": "sigmoid", "activation_q": "relu"}),
])
def test_att_scoring_fusion_takes_the_flax_knobs(name, attention):
    """ConcatAtt's ``attention.activation`` on the glimpse head's hidden
    layer; MLBAtt's scoring fusion activations, ``activation`` overriding
    ``activation_q`` and ``activation_v`` where given."""
    overrides = [f"model.attention.{k}={v}" for k, v in attention.items()]
    if name == "mlb_att":  # the YAML sets activation: tanh; drop it unless the case sets it
        overrides.insert(0, "model.attention={nb_glimpses: 2, dim_h: 10}")
    jax_model, params, port, visual, tokens = _arch(name, overrides)
    want = jax_model.apply({"params": params}, jnp.asarray(visual), jnp.asarray(tokens))
    with torch.inference_mode():
        got = port(torch.from_numpy(visual), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
