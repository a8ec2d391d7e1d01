"""Layer: model step (``models/``). The model FLOPs of the window's
questions, each at its own length (``portbench/flops.py``), over the
window's wall time and the card's bf16 peak, in %."""

from portbench.flops import PEAK_BF16


def read(run):
    if not run.model_flops or not run.seconds:
        return None
    return 100.0 * run.model_flops / (run.seconds * PEAK_BF16)
