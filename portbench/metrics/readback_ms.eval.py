"""Layer: eval loop (``engine/engine.py::_eval_loop``). The program's
own span ``vqa_tpu_torch.eval.readback`` in the traced epoch: the outputs
packed, the epoch's one copy to the host and the host's wait for the card
to finish the epoch, in ms. A program without the span reads nothing."""

import statistics


def read(run):
    spans = ([float(e["dur"]) for e in run.trace.host
              if e["name"] == "vqa_tpu_torch.eval.readback"] if run.trace else [])
    return statistics.fmean(spans) / 1e3 if spans else None
