"""Layer: loader (``datasets/pipeline.py``). The host time of each ``next()``
of the eval loader in the window, the mean over its batches, in ms."""

import statistics


def read(run):
    return statistics.fmean(run.loader_waits) * 1e3 if run.loader_waits else None
