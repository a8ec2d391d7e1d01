"""Layer: model step (``models/``, ``engine/steps.py::make_eval_step``). The
kernels launched inside each of the program's ``vqa_tpu_torch.eval.step``
spans in the traced epoch, found through the trace's correlation ids: the
median over the epoch's batches. Nothing where the program has no such
span or the trace no kernel."""

import statistics


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    counts = run.trace.kernels_per_span("vqa_tpu_torch.eval.step")
    return float(statistics.median(counts)) if counts else None
