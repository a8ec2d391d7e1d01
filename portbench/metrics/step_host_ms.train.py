"""Layer: train loop and step (``engine/engine.py::train``,
``engine/steps.py``, ``engine/optim.py``). The host time of each
``train_step`` call in the window (the step does not sync), the mean, in
ms."""

import statistics


def read(run):
    return statistics.fmean(run.step_host) * 1e3 if run.step_host else None
