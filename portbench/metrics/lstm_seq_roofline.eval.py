"""Layer: kernels (``ops/lstm.py``, ``csrc/lstm.cu``). The least time the
traced ``lstm_seq`` calls need by their shapes (``flops.lstm_seq_bound_s``)
over the device time of the kernels they launched, in %."""

from portbench.flops import lstm_seq_bound_s
from portbench.trace import input_dims, input_elem


def read(run):
    calls = run.trace.op_calls("vqa_tpu_torch::lstm_seq") if run.trace else []
    if not calls:
        return None
    bound = 0.0
    for event, _ in calls:
        (T, B, gates), _, (H, _) = input_dims(event)[:3]
        bound += lstm_seq_bound_s(T, B, H, input_elem(event))
    return 100.0 * bound / (sum(us for _, us in calls) / 1e6)
