"""The port's visu CLI (vqa_tpu_torch/cli/visu.py) against the JAX
package's (vqa_tpu/cli/visu.py), on fixture runs.

For each of MutanAtt, MFBCoAtt, CoR and MutanNoAtt a tiny model's flax
params (non-zero biases) are written as the best checkpoint of two run dirs,
one each package's (the JAX manager's and the port's), and both CLIs run
with --out on the same image and question: the same top-k answers, and the
attention each draws (the glimpse maps; CoR's per-step betas) within 1e-4,
float32 on both sides; for the NoAtt family both print that the arch has no
attention map and draw nothing.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import matplotlib.axes
import numpy as np
import pytest
import torch

from vqa_tpu.cli.visu import main as jax_visu_main
from vqa_tpu.config import dump_options as jax_dump_options
from vqa_tpu.config import load_options
from vqa_tpu.datasets import factory as dataset_factory
from vqa_tpu.engine.checkpoint import CheckpointManager as JaxCheckpointManager
from vqa_tpu.engine.optim import factory as jax_optim_factory
from vqa_tpu.engine.steps import create_state as jax_create_state
from vqa_tpu.importers import save_tree_npz
from vqa_tpu.models import factory as jax_factory
from vqa_tpu.predictor import Predictor as JaxPredictor
from vqa_tpu_torch.cli.visu import attention_map, main as visu_main
from vqa_tpu_torch.datasets.fixtures import generate
from vqa_tpu_torch.predictor import Predictor

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
TINY = {
    "mutan_att": ["model.seq2vec.emb_size=12", "model.seq2vec.hidden_size=16",
                  "model.attention.dim_hv=8", "model.attention.dim_hq=8",
                  "model.attention.dim_mm=12", "model.attention.R=2",
                  "model.fusion.dim_hv=8", "model.fusion.dim_hq=8",
                  "model.fusion.dim_mm=12", "model.fusion.R=2"],
    "mfb_coatt": ["model.seq2vec.emb_size=12", "model.seq2vec.hidden_size=16",
                  "model.fusion.dim_mm=16", "model.fusion.pool_factor=2"],
    "cor": ["model.seq2vec.emb_size=12", "model.seq2vec.hidden_size=16",
            "model.fusion.dim_h=16"],
    "mutan_noatt": ["model.seq2vec.emb_size=12", "model.seq2vec.hidden_size=16",
                    "model.fusion.dim_hv=8", "model.fusion.dim_hq=8",
                    "model.fusion.dim_mm=12", "model.fusion.R=2"],
}
QUESTION = "what color is the object"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torchvisu"))
    generate(d, n_images=10, n_questions=48, seed=13)
    return d


def _runs(data_dir, name):
    """(JAX run dir, port run dir): each with the options and, as its best
    checkpoint (epoch 0), the same flax init."""
    from vqa_tpu_torch.config import dump_options, load_options as port_load_options
    from vqa_tpu_torch.engine import optim
    from vqa_tpu_torch.engine.checkpoint import CheckpointManager
    from vqa_tpu_torch.engine.steps import create_state
    from vqa_tpu_torch.models.factory import factory as port_model_factory
    from vqa_tpu_torch.weights import load_params

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
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [p + 0.02 * (i % 5) for i, p in enumerate(leaves)])
    jax_run, port_run = (os.path.join(data_dir, f"{side}_{name}") for side in ("jax", "port"))
    jax_dump_options(opt, jax_run)
    JaxCheckpointManager(os.path.join(jax_run, "ckpt")).save(
        jax_create_state(model, params, jax_optim_factory(opt.optim, 1)), 0, 0.5)

    npz = os.path.join(data_dir, f"{name}_params.npz")
    save_tree_npz(npz, params)
    port_opt = port_load_options(path_opt, overrides)
    dump_options(port_opt, port_run)
    trainable = port_model_factory(dataclasses.asdict(port_opt.model), val_set.num_words,
                                   val_set.num_answers, dim_v=val_set.feature_shape[-1],
                                   train=True)
    with np.load(npz) as flat:
        load_params(trainable, flat)
    CheckpointManager(os.path.join(port_run, "ckpt")).save(
        create_state(trainable, optim.factory(port_opt.optim)), 0, 0.5)
    return jax_run, port_run, str(val_set.split.image_names[0])


def _printed_answers(out):
    """The (answer, prob) lines a visu CLI printed after its "Q:" line."""
    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("Q: "))
    rows = []
    for line in lines[start + 1:]:
        if not line.startswith("  "):
            break
        answer, prob = line.strip().rsplit(maxsplit=1)
        rows.append((answer, float(prob)))
    return rows


@pytest.mark.parametrize("name", sorted(TINY))
def test_visu_matches_the_reference(data_dir, name, tmp_path, monkeypatch, capsys):
    jax_run, port_run, image = _runs(data_dir, name)
    drawn = []  # what each glimpse's panel draws: a heatmap of 36 = 6 x 6 regions
    real_imshow = matplotlib.axes.Axes.imshow

    def imshow(self, x, *args, **kwargs):
        drawn.append(np.asarray(x, np.float64).ravel())
        return real_imshow(self, x, *args, **kwargs)

    monkeypatch.setattr(matplotlib.axes.Axes, "imshow", imshow)
    outs = {}
    for side, main, run, extra in (("jax", jax_visu_main, jax_run, []),
                                   ("port", visu_main, port_run, ["--platform", "cpu"])):
        png = str(tmp_path / f"{side}.png")
        assert main(["--dir_logs", run, "--image", image, "--question", QUESTION,
                     "--topk", "3", "--out", png, *extra]) == 0
        outs[side] = (capsys.readouterr().out, list(drawn), os.path.exists(png))
        drawn.clear()

    (jax_out, jax_drawn, jax_png), (port_out, port_drawn, port_png) = outs["jax"], outs["port"]
    got, want = _printed_answers(port_out), _printed_answers(jax_out)
    assert [a for a, _ in got] == [a for a, _ in want] and len(got) == 3
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], atol=1e-3 + 1e-9)
    port_pred = Predictor.from_run(port_run, resume="best", device="cpu")
    jax_pred = JaxPredictor.from_run(jax_run, resume="best")
    port_top = port_pred.answer(QUESTION, image, topk=3)
    jax_top = jax_pred.answer(QUESTION, image, topk=3)
    assert [a for a, _ in port_top] == [a for a, _ in jax_top]
    np.testing.assert_allclose([p for _, p in port_top], [p for _, p in jax_top], atol=TOL)

    if name == "mutan_noatt":
        for out in (jax_out, port_out):
            assert "arch has no attention map; skipping --out" in out
        assert not (jax_drawn or port_drawn or jax_png or port_png)
        assert attention_map(port_pred, QUESTION, image) is None
        return
    alpha = attention_map(port_pred, QUESTION, image)  # [R, G]: glimpses, or CoR's steps
    assert alpha.shape == (36, {"cor": 3}.get(name, 2))
    assert port_png and jax_png and len(port_drawn) == len(jax_drawn) == alpha.shape[1]
    for g, (p, j) in enumerate(zip(port_drawn, jax_drawn)):
        np.testing.assert_allclose(p, j, atol=TOL, err_msg=f"glimpse {g}")
        np.testing.assert_array_equal(p, alpha[:, g])
    np.testing.assert_allclose(alpha.sum(axis=0), 1.0, atol=1e-5)  # softmax over the regions
