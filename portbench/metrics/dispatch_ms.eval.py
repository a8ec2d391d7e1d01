"""Layer: eval loop (``engine/engine.py::_eval_loop``). The program's own
span ``vqa_tpu_torch.eval.step`` in the traced epoch, the host's time to
queue one batch on the card (its gather, forward and outputs): the mean
over the epoch's batches, in ms. A program without the span reads
nothing."""

import statistics


def read(run):
    spans = ([float(e["dur"]) for e in run.trace.host if e["name"] == "vqa_tpu_torch.eval.step"]
             if run.trace else [])
    return statistics.fmean(spans) / 1e3 if spans else None
