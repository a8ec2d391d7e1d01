"""Layer: device. The card's idle time while the host still queues the
traced epoch: from the start of the program's first
``vqa_tpu_torch.eval.step`` span to the start of its
``vqa_tpu_torch.eval.readback`` span, less the union of the kernels'
intervals over that stretch, in ms. Nothing where the program has no such
spans or the trace no kernel."""

from portbench.trace import union_us


def read(run):
    trace = run.trace
    if trace is None or not trace.kernels:
        return None
    steps = [float(e["ts"]) for e in trace.host if e["name"] == "vqa_tpu_torch.eval.step"]
    readback = [float(e["ts"]) for e in trace.host
                if e["name"] == "vqa_tpu_torch.eval.readback"]
    if not steps or not readback:
        return None
    lo, hi = min(steps), min(readback)
    kernels = [(float(k["ts"]), float(k["ts"]) + float(k["dur"])) for k in trace.kernels]
    return (hi - lo - union_us(kernels, lo, hi)) / 1e3
