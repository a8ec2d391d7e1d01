"""Layer: parallel (``parallel/``). The device time of the NCCL kernels on
rank 0 in the traced train steps (the step's all-reduce of the gradients
and the sharded table's reduce-scatter), per step, in ms. A collective's
kernel runs until the slowest rank joins it, so this time holds the wait
for that rank too."""


def read(run):
    trace = run.device_trace
    if trace is None or not run.traced_steps:
        return None
    nccl = sum(float(k["dur"]) for k in trace.kernels if "nccl" in k["name"].lower())
    return nccl / 1e3 / run.traced_steps if nccl else None
