"""The port's init (vqa_tpu_torch.weights.init_params) against flax's
initial distributions for narrow builds of MutanAtt, MFBCoAtt, MFHCoAtt,
CoR and MutanAtt with the skip-thoughts GRU (training builds).

flax draws ``lecun_normal`` (a normal truncated to +-2 of its scale, with
variance 1/fan_in) for the kernels, ``orthogonal`` for the recurrent
``wh``, zeros for the biases and ``nn.Embed``'s default (an untruncated
normal of std 1/sqrt(features)) for the embedding. The streams differ, so
the distributions are held: every leaf flax zeros is zero; each lecun_normal
leaf of at least 10^4 elements has its std within 5% of flax's and no value
beyond flax's truncation; ``wh`` (the LSTM's [H, 4H], the GRU's [H, 3H])
has orthonormal rows to 1e-5; the embedding's std is within 5% of flax's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from vqa_tpu_torch.config import load_options
from vqa_tpu_torch.models.factory import factory as model_factory
from vqa_tpu_torch.weights import export_params, init_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = ["model.seq2vec.emb_size=64", "model.seq2vec.hidden_size=64",
          "model.attention.dim_hv=96", "model.attention.dim_hq=64",
          "model.attention.dim_mm=80", "model.attention.R=2", "model.fusion.dim_hv=96",
          "model.fusion.dim_hq=64", "model.fusion.dim_mm=80", "model.fusion.R=2"]
# each arch: its YAML and narrow widths that leave at least 6 lecun_normal
# leaves of 10^4 elements or more
ARCHS = {
    "mutan_att": ("mutan_att", NARROW),
    "mfb_coatt": ("mfb_coatt", ["model.seq2vec.emb_size=64", "model.seq2vec.hidden_size=64",
                                "model.attention.dim_h=96", "model.fusion.dim_mm=80",
                                "model.fusion.pool_factor=3"]),
    "mfh_coatt": ("mfh_coatt", ["model.seq2vec.emb_size=64", "model.seq2vec.hidden_size=64",
                                "model.attention.dim_h=96", "model.fusion.dim_mm=80",
                                "model.fusion.pool_factor=3"]),
    "cor": ("cor", ["model.seq2vec.emb_size=64", "model.seq2vec.hidden_size=64",
                    "model.fusion.dim_h=128", "model.classif.dim_h=64"]),
    "mutan_att_skipthoughts": ("mutan_att", NARROW + ["model.seq2vec.arch=skipthoughts"]),
}
NUM_WORDS, NUM_ANSWERS, DIM_V, REGIONS = 5000, 300, 128, 6
STD_REL, MIN_ELEMENTS = 0.05, 10_000
TRUNCATED_STD = 0.87962566103423978


@pytest.fixture(scope="module", params=sorted(ARCHS))
def leaves(request):
    """(port init, flax init), '/'-keyed, of the same narrow build."""
    import jax
    import jax.numpy as jnp

    from vqa_tpu.config import load_options as jax_load_options
    from vqa_tpu.importers import flatten_tree
    from vqa_tpu.models import factory as jax_factory

    yaml, overrides = ARCHS[request.param]
    path = os.path.join(REPO, "options", "vqa2", f"{yaml}.yaml")
    model = model_factory(dataclasses.asdict(load_options(path, overrides).model), NUM_WORDS,
                          NUM_ANSWERS, dim_v=DIM_V, train=True)
    init_params(model, seed=1337)
    jax_model = jax_factory(jax_load_options(path, overrides).model, NUM_WORDS, NUM_ANSWERS)
    params = jax_model.init(jax.random.key(1337), jnp.zeros((2, REGIONS, DIM_V)),
                            jnp.zeros((2, 26), jnp.int32), jnp.ones((2,), jnp.int32))["params"]
    return export_params(model), {k: np.asarray(v) for k, v in flatten_tree(params).items()}


def _kind(key, value):
    if value.ndim < 2:
        return "zeros"
    if key.endswith("embedding"):
        return "embed"
    return "orthogonal" if key.endswith("wh") else "lecun_normal"


def test_the_tree_and_the_zeros_are_flaxs(leaves):
    port, flax = leaves
    assert sorted(port) == sorted(flax)
    for key, want in flax.items():
        assert port[key].shape == want.shape, key
        if _kind(key, want) == "zeros":
            assert not want.any() and not port[key].any(), key
        else:
            assert port[key].std() > 0, key


def test_lecun_normal_leaves_match_flax(leaves):
    port, flax = leaves
    checked = 0
    for key, want in flax.items():
        if _kind(key, want) != "lecun_normal":
            continue
        bound = 2.0 * want.shape[-2] ** -0.5 / TRUNCATED_STD  # flax's truncation
        assert np.abs(port[key]).max() <= bound * (1 + 1e-6), key
        assert np.abs(want).max() <= bound * (1 + 1e-6), key
        if want.size >= MIN_ELEMENTS:
            assert abs(port[key].std() / want.std() - 1) <= STD_REL, key
            checked += 1
    assert checked >= 6


def test_wh_has_orthonormal_rows(leaves):
    port, flax = leaves
    (key,) = [k for k in flax if k.endswith("_0/wh")]
    gates = 3 if "/gru_0/" in key else 4
    for w in (port[key], flax[key]):
        w = w.astype(np.float64)
        assert w.shape == (64, gates * 64)
        np.testing.assert_allclose(w @ w.T, np.eye(64), rtol=0, atol=1e-5)


def test_embedding_std_matches_flax(leaves):
    port, flax = leaves
    key = "encoder/embed/embedding"
    assert abs(port[key].std() / flax[key].std() - 1) <= STD_REL
    assert abs(port[key].std() - 64 ** -0.5) <= STD_REL * 64 ** -0.5
    # untruncated: a 320k-element normal reaches past 4 std
    assert np.abs(port[key]).max() > 4 * 64 ** -0.5


def test_init_is_seeded():
    path = os.path.join(REPO, "options", "vqa2", "mutan_att.yaml")
    opt = dataclasses.asdict(load_options(path, NARROW).model)
    a, b, c = (model_factory(opt, 50, 7, dim_v=DIM_V) for _ in range(3))
    init_params(a, 3)
    init_params(b, 3)
    init_params(c, 4)
    pa, pb, pc = export_params(a), export_params(b), export_params(c)
    assert all(np.array_equal(pa[k], pb[k]) for k in pa)
    assert any(not np.array_equal(pa[k], pc[k]) for k in pa if pa[k].any())
