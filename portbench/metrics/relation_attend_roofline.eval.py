"""Layer: kernels (``ops/relation.py``, ``csrc/relation*.cu``). The least
time the traced ``relation_attend`` calls need by their shapes
(``flops.relation_attend_bound_s``, the same whatever design serves a call)
over the device time of the kernels they launched, in %."""

from portbench.flops import relation_attend_bound_s
from portbench.trace import input_dims, input_elem


def read(run):
    calls = run.trace.op_calls("vqa_tpu_torch::relation_attend") if run.trace else []
    if not calls:
        return None
    bound = 0.0
    for event, _ in calls:
        B, N, D = input_dims(event)[0]
        bound += relation_attend_bound_s(B, N, D, input_elem(event))
    return 100.0 * bound / (sum(us for _, us in calls) / 1e6)
