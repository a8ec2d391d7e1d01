"""Layer: eval loop (``engine/engine.py::_eval_loop``). The program's own
span ``vqa_tpu_torch.eval.results`` in the traced epoch: the results rows
and totals built on the host after the readback, in ms. A program without
the span reads nothing."""

import statistics


def read(run):
    spans = ([float(e["dur"]) for e in run.trace.host
              if e["name"] == "vqa_tpu_torch.eval.results"] if run.trace else [])
    return statistics.fmean(spans) / 1e3 if spans else None
