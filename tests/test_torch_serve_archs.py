"""MFBCoAtt, MFHCoAtt, CoR, ConcatAtt, MLBAtt, MutanNoAtt and MLBNoAtt
through the port's serving side, against the JAX package's, on a fixture
run (the NoAtt archs over the fixture's pooled ``noatt`` table, [N, 2048]).

For each arch, a tiny model's flax params are saved with save_tree_npz; the
port's Predictor.from_run(params=npz) must answer as the JAX
Predictor.from_run (resume=None, model.pretrained_params=npz) does: same
answers, probabilities within 1e-5 (float32 on both sides). The port's eval
step must give the JAX eval step's outputs on a batch that gathers from the
feature table. The questions include the empty one, whose all-padding row
goes through MFB's masked self-attention.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqa_tpu.config import load_options
from vqa_tpu.datasets import factory as dataset_factory
from vqa_tpu.engine.steps import create_state, make_eval_step as jax_make_eval_step
from vqa_tpu.importers import save_tree_npz
from vqa_tpu.models import factory as jax_factory
from vqa_tpu.predictor import Predictor as JaxPredictor
from vqa_tpu_torch.datasets.fixtures import generate
from vqa_tpu_torch.engine.steps import make_eval_step
from vqa_tpu_torch.predictor import Predictor

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {
    "mfb_coatt": ["model.seq2vec.emb_size=16", "model.seq2vec.hidden_size=32",
                  "model.attention.dim_h=8", "model.fusion.dim_mm=6"],
    "mfh_coatt": ["model.seq2vec.emb_size=16", "model.seq2vec.hidden_size=32",
                  "model.attention.dim_h=8", "model.fusion.dim_mm=6"],
    "cor": ["model.seq2vec.emb_size=16", "model.seq2vec.hidden_size=32",
            "model.fusion.dim_h=12", "model.classif.dim_h=10"],
    "concat_att": ["model.seq2vec.emb_size=16", "model.seq2vec.hidden_size=32",
                   "model.attention.dim_h=12", "model.classif.dim_h=10"],
    "mlb_att": ["model.seq2vec.emb_size=16", "model.seq2vec.hidden_size=32",
                "model.attention.dim_h=12", "model.fusion.dim_h=10"],
    "mutan_noatt": ["model.seq2vec.emb_size=16", "model.seq2vec.hidden_size=32",
                    "model.fusion.dim_hv=12", "model.fusion.dim_hq=10", "model.fusion.dim_mm=8",
                    "model.fusion.R=2"],
    "mlb_noatt": ["model.seq2vec.emb_size=16", "model.seq2vec.hidden_size=32",
                  "model.fusion.dim_h=10"],
}
QUESTIONS = [
    "What color is the cat?",
    "how MANY zebras (or horses), exactly; do you see?",
    "unknownword anotherunknown",
    "",
    " ".join(["is it red"] * 12),  # longer than maxlength
    "Is there a red-ish thing/object here?!",
]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torchserve_archs"))
    generate(d, n_images=10, n_questions=48, seed=5)
    return d


@pytest.fixture(scope="module", params=sorted(TINY))
def run(request, data_dir):
    name = request.param
    path_opt = os.path.join(REPO, f"options/vqa2/{name}.yaml")
    overrides = [f"vqa.dir={data_dir}/vqa2", f"coco.dir={data_dir}/coco",
                 "vqa.nans=20"] + TINY[name]
    opt = load_options(path_opt, overrides)
    val_set = dataset_factory("val", opt)
    model = jax_factory(opt.model, val_set.num_words, val_set.num_answers)
    params = model.init(
        jax.random.key(7), jnp.zeros((2,) + val_set.feature_shape),
        jnp.zeros((2, opt.vqa.maxlength), jnp.int32), jnp.ones((2,), jnp.int32),
    )["params"]
    leaves, tree = jax.tree.flatten(params)  # non-zero biases throughout
    params = jax.tree.unflatten(tree, [p + 0.02 * (i % 5) for i, p in enumerate(leaves)])
    npz = os.path.join(data_dir, f"{name}_params.npz")
    save_tree_npz(npz, params)
    jax_pred = JaxPredictor.from_run(
        data_dir, path_opt, resume=None,
        overrides=overrides + [f"model.pretrained_params={npz}"],
    )
    port_pred = Predictor.from_run(data_dir, path_opt, params=npz, overrides=overrides,
                                   device="cpu")
    return jax_pred, port_pred


def _same(got, want, tol=1e-5):
    assert [[a for a, _ in row] for row in got] == [[a for a, _ in row] for row in want]
    for g, w in zip(got, want):
        for (_, pg), (_, pw) in zip(g, w):
            assert abs(pg - pw) <= tol


def test_predictor_answers_match_jax(run):
    jax_pred, port_pred = run
    assert type(port_pred.model).__name__ == type(jax_pred.model).__name__
    assert port_pred.table.ndim == (2 if "NoAtt" in type(port_pred.model).__name__ else 3)
    names = [str(n) for n in jax_pred.dataset.split.image_names[: len(QUESTIONS)]]
    _same(port_pred.answer_batch(QUESTIONS, names, topk=4),
          jax_pred.answer_batch(QUESTIONS, names, topk=4))
    _same([port_pred.answer(QUESTIONS[3], names[1], topk=2)],
          [jax_pred.answer(QUESTIONS[3], names[1], topk=2)])


def test_eval_step_matches_jax(run):
    jax_pred, port_pred = run
    table = port_pred.table.numpy()
    rng = np.random.default_rng(9)
    B = 10
    question, length = port_pred.encode_questions(
        [QUESTIONS[i % len(QUESTIONS)] for i in range(B)])
    batch = {
        "question": question.numpy(),
        "length": length.numpy(),
        "image_index": rng.integers(0, table.shape[0], B).astype(np.int32),
        "answer": np.where(np.arange(B) % 4 == 0, -1,
                           rng.integers(0, port_pred.dataset.num_answers, B)).astype(np.int32),
        "valid": np.arange(B) < B - 2,
    }
    state = create_state(jax_pred.model, jax_pred.params, optax.sgd(0.1))
    want = jax_make_eval_step()(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                jnp.asarray(table))
    port_batch = {k: (v if k == "image_index" else torch.from_numpy(v)) for k, v in batch.items()}
    got = make_eval_step()(port_pred.model, port_batch, port_pred.table)
    assert set(got) == set(want) == {"pred", "n", "n_labeled", "correct1", "correct5"}
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
