"""The plain reference against the program at tiny widths on the CPU, in
float32: the forward of both configurations, and three train steps of
MutanAtt with dropout on (the reference draws the program's masks from the
(seed, step) stream) and adam."""

import numpy as np
import pytest
import torch

from conftest import SEED, tiny_config
from portbench.harness import moving
from portbench.reference import models, train
from portbench.reference.params import make_params, param_spec


def _program(cfg, weights, train_build):
    from vqa_tpu_torch.models.factory import factory

    model = factory(cfg["model"], cfg["num_words"], cfg["num_answers"], dtype=torch.float32,
                    device="cpu", dim_v=16, train=train_build)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name.replace(".", "/")])
    return model


def _inputs(cfg, B=6, T=9, R=4, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, B)
    tokens = rng.integers(1, cfg["num_words"], (B, T))
    tokens *= np.arange(T)[None, :] < lengths[:, None]
    return (torch.from_numpy(tokens).int(), torch.randn(B, R, 16, generator=torch.Generator()
                                                         .manual_seed(seed)),
            torch.from_numpy(rng.integers(0, cfg["num_answers"], B)))


@pytest.mark.parametrize("config", ["mutan_att", "cor"])
def test_forward_matches_the_program(config):
    cfg = tiny_config(config)
    weights = make_params(param_spec(cfg, 16), SEED, "cpu")
    tokens, visual, _ = _inputs(cfg)
    want = _program(cfg, weights, False)(visual, tokens)
    got = models.forward(cfg, weights, tokens, visual)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), (got - want).abs().max()


def test_train_steps_match_the_program():
    from vqa_tpu_torch.config import OptimOptions
    from vqa_tpu_torch.engine import optim, steps

    cfg = tiny_config("mutan_att")
    weights = make_params(param_spec(cfg, 16), SEED, "cpu")
    model = _program(cfg, weights, True)
    state = steps.create_state(model, optim.factory(OptimOptions(**cfg["optim"])))
    step = steps.make_train_step(optim.criterion_factory(), SEED)
    batches, losses = [], []
    for s in range(3):
        tokens, visual, answer = _inputs(cfg, seed=s)
        state, metrics = step(state, {"visual": visual, "question": tokens,
                                      "answer": answer}, None)
        losses.append(float(metrics["loss"]))
        batches.append({"step": s, "tokens": tokens, "visual": visual, "answer": answer})
    ref = train.train_steps(cfg, weights, batches, SEED)
    assert np.allclose(losses, ref["loss"], rtol=1e-5)
    # leaves whose gradient is nought to rounding (the glimpse logits' bias
    # under the softmax) move under adam by round-off alone
    params = {n.replace(".", "/"): p for n, p in model.named_parameters()}
    for name in moving(ref["grad_norms"][0]):
        assert torch.allclose(params[name], ref["params"][name], rtol=1e-4, atol=1e-6), name
    # another dropout stream gives another loss: the masks are the program's
    other = train.train_steps(cfg, weights, batches, SEED + 1)
    assert not np.allclose(losses, other["loss"], rtol=1e-3)


def test_fp8_control_moves_the_logits():
    cfg = tiny_config("mutan_att")
    weights = make_params(param_spec(cfg, 16), SEED, "cpu")
    tokens, visual, _ = _inputs(cfg)
    exact = models.forward(cfg, weights, tokens, visual)
    low = models.forward(cfg, weights, tokens, visual, fp8=True)
    assert 1e-3 < float((low - exact).abs().max()) < 1.0
