"""Layer: eval loop (``engine/engine.py``). The host time from the loader
handing out an epoch's last batch to ``validate``'s return (the last
dispatch, the epoch's one readback and its results rows), the mean over
the window's epochs, in ms."""

import statistics


def read(run):
    return statistics.fmean(run.epoch_tails) * 1e3 if run.epoch_tails else None
