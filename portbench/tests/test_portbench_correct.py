"""``correct`` comes out false where it must: for the float8 control in the
program's place, and for a run with the timed path broken underneath (an
answer altered where it is produced, half of the batch left out, a train
step that leaves its state unchanged). The runs skip the look for a card
and run the rest at tiny widths on the CPU."""

import pytest
import torch

from conftest import TINY_LIMITS, tiny_harness
from portbench import calibrate

SEEDS = (11, 12, 13)


def _correct(h, trace=False):
    from portbench.run import result

    h.setup()
    h.window(0.0)
    h.free_program()
    h.check()
    return result(h, trace)["correct"]


@pytest.mark.parametrize("workload", ["tiny_mutan_att.eval", "tiny_cor.eval",
                                      "tiny_mutan_att.train"])
def test_the_program_is_correct(tiny, workload):
    assert all(_correct(tiny_harness(tiny, workload, s)) for s in SEEDS)


@pytest.mark.parametrize("workload", ["tiny_mutan_att.eval", "tiny_cor.eval",
                                      "tiny_mutan_att.train"])
def test_the_fp8_control_fails(tiny, workload):
    limits = TINY_LIMITS.get(workload, TINY_LIMITS["train"])
    failed = 0
    for s in SEEDS:
        h = tiny_harness(tiny, workload, s)
        h.setup()
        h.window(0.0)
        h.free_program()
        readings = calibrate.control_readings(h)
        failed += any(v > limits[k] for k, v in readings.items() if k in limits)
    assert failed == len(SEEDS)


def _broken_eval_step(alter):
    from vqa_tpu_torch.engine import steps

    plain = steps.make_eval_step

    def make():
        step = plain()

        def broken(model, batch, features=None):
            out = step(model, batch, features)
            out["pred"] = alter(out["pred"])
            return out

        return broken

    return make


def _answer_altered(pred):
    pred = pred.clone()
    pred[0] = (pred[0] + 1) % 50
    return pred


def _half_left_out(pred):
    pred = pred.clone()
    pred[pred.shape[0] // 2:] = 0
    return pred


@pytest.mark.parametrize("alter", [_answer_altered, _half_left_out])
@pytest.mark.parametrize("workload", ["tiny_mutan_att.eval", "tiny_cor.eval"])
def test_a_broken_eval_is_not_correct(tiny, workload, alter, monkeypatch):
    from vqa_tpu_torch.engine import steps

    monkeypatch.setattr(steps, "make_eval_step", _broken_eval_step(alter))
    # the altered rows must be in the sample: compare every question
    h = tiny_harness(tiny, workload)
    h.traffic = dict(h.traffic, sample=300 - h.traffic["sample_longest"])
    assert not _correct(h)


def test_a_train_step_that_leaves_its_state_unchanged_is_not_correct(tiny, monkeypatch):
    from vqa_tpu_torch.engine import optim

    monkeypatch.setattr(optim, "apply_updates", lambda params, updates: None)
    assert not _correct(tiny_harness(tiny, "tiny_mutan_att.train"))


def test_half_of_the_train_batch_left_out_is_not_correct(tiny, monkeypatch):
    from vqa_tpu_torch.engine import optim

    plain = optim.criterion_factory
    monkeypatch.setattr(optim, "criterion_factory",
                        lambda *a: calibrate.half_batch_criterion(plain(*a)))
    assert not _correct(tiny_harness(tiny, "tiny_mutan_att.train"))


def test_on_the_card(card):
    """One short run of the first cell on the card: a result, correct."""
    import json
    import subprocess
    import sys

    from conftest import ROOT

    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "mutan_att.eval.butd36", "--seed", str(2 ** 32 + 3), "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]

