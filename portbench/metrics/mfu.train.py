"""Layer: model step (``models/``). The model FLOPs, forward and backward,
of the window's questions, each at its own length (``portbench/flops.py``;
adam's elementwise work not counted), over the window's wall time and the
bf16 peak of the cell's cards, in %."""

from portbench.flops import PEAK_BF16


def read(run):
    if not run.model_flops or not run.seconds:
        return None
    return 100.0 * run.model_flops / (run.seconds * PEAK_BF16 * run.cell.chips)
