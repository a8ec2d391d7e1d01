"""Layer: train loop and step. The kernels a train step launches, counted
in the profiler's trace of the traced steps: the median over them."""

import statistics


def read(run):
    counts = run.trace.kernels_per_span("portbench.train_step") if run.trace else []
    return float(statistics.median(counts)) if counts else None
