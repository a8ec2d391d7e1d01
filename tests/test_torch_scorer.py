"""The port's copy of the VQA-accuracy scorer and its CLI against the
originals.

Every case of tests/test_scorer.py runs again here against
vqa_tpu_torch.scorer: that file's source, with its imports of vqa_tpu.scorer
pointed at the port's module, is executed into this module, so each of its
tests (and each parametrised case) is collected a second time under this
file's name. The port's tables equal the original's, and the port's
``cli.score`` writes the report the original writes.
"""

import json
import os

from vqa_tpu import scorer as jax_scorer
from vqa_tpu.cli.score import main as jax_score_main
from vqa_tpu_torch import scorer as port_scorer
from vqa_tpu_torch.cli.score import main as port_score_main

_ORIGINAL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_scorer.py")
with open(_ORIGINAL) as _f:
    _SOURCE = _f.read()
_PORTED = _SOURCE.replace("vqa_tpu.scorer", "vqa_tpu_torch.scorer")
exec(compile(_PORTED, _ORIGINAL, "exec"), globals())


def test_the_original_cases_run_against_the_port():
    assert "vqa_tpu.scorer" in _SOURCE and "vqa_tpu.scorer" not in _PORTED
    assert evaluate is port_scorer.evaluate  # noqa: F821 (defined by the exec above)
    assert question_accuracy is port_scorer.question_accuracy  # noqa: F821


def test_tables_equal_the_original():
    assert port_scorer.CONTRACTIONS == jax_scorer.CONTRACTIONS
    assert port_scorer.MANUAL_MAP == jax_scorer.MANUAL_MAP
    assert port_scorer.ARTICLES == jax_scorer.ARTICLES
    assert port_scorer.PUNCT == jax_scorer.PUNCT


def test_score_cli_writes_the_original_report(tmp_path, capsys):
    types = ["yes/no", "number", "other"]
    truth = ["yes", "two", "red", "a dog", "3.5", "1,000"]
    # 10 annotators: 6 to 10 give the truth, the rest "no"
    annotations = [
        {"question_id": i, "answer_type": types[i % 3], "question_type": f"type {i % 4}",
         "answers": [{"answer": truth[i % 6]}] * (6 + i % 5) + [{"answer": "no"}] * (4 - i % 5)}
        for i in range(30)
    ]
    preds = ["yes", "2", "red.", "dog", "3.5", "1000", "no", "the red"]
    results = [{"question_id": i, "answer": preds[i % len(preds)]} for i in range(30)]
    (tmp_path / "ann.json").write_text(json.dumps({"annotations": annotations}))
    (tmp_path / "res.json").write_text(json.dumps(results))
    reports = []
    for main, name in ((port_score_main, "port"), (jax_score_main, "jax")):
        out = tmp_path / f"{name}.json"
        assert main(["--results", str(tmp_path / "res.json"),
                     "--annotations", str(tmp_path / "ann.json"), "--out", str(out)]) == 0
        reports.append((out.read_text(), capsys.readouterr().out))
    assert reports[0] == reports[1]
    report = json.loads(reports[0][0])
    assert report["n"] == 30 and set(report["per_answer_type"]) == set(types)
    assert 0 < report["overall"] < 100
