"""The readers of the program's own eval spans (``vqa_tpu_torch.loader.take``,
``.eval.step``, ``.eval.readback``, ``.eval.results``): on a tiny cell's
traced epoch on the CPU, on a trace made by hand whose numbers are known,
and on the card, where every step launches kernels and the device's idle
splits at the spans."""

import statistics
import time

import pytest

from conftest import tiny_harness
from portbench.harness import Run
from portbench.spec import load_reader
from portbench.trace import Trace, union_us

HOST = ("loader_take_ms.eval", "dispatch_ms.eval", "readback_ms.eval", "results_ms.eval")
DEVICE = ("launches_per_batch.eval", "dispatch_idle_ms.eval")
SPANS = ("vqa_tpu_torch.loader.take", "vqa_tpu_torch.eval.step",
         "vqa_tpu_torch.eval.readback", "vqa_tpu_torch.eval.results")


def _read(name, run):
    return load_reader(name)(run)


@pytest.mark.parametrize("workload", ["tiny_mutan_att.eval", "tiny_cor.eval"])
def test_a_traced_epoch_on_the_cpu(tiny, workload):
    h = tiny_harness(tiny, workload)
    h.setup()
    h.window(0.0)
    h.traced()
    values = {m.name: m.read(h.run) for m in h.cell.per_layer if m.name in HOST + DEVICE}
    assert all(values[name] > 0 for name in HOST), values
    assert [values[name] for name in DEVICE] == [None, None], values   # no kernel


def _event(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur,
            "args": args}


def test_the_readers_on_a_known_trace():
    """Two batches: takes of 40 and 30 us, steps of 50 us launching two
    kernels and one, the readback at 600 us for 200 us, the results for
    100; kernels busy 150-300 and 400-500 us of the dispatch stretch
    100-600."""
    take, step, readback, results = SPANS
    events = [_event("portbench.traced", 0, 1000), _event("portbench.validate", 10, 980),
              _event(take, 50, 40), _event(step, 100, 50), _event(take, 260, 30),
              _event(step, 300, 50), _event(readback, 600, 200), _event(results, 800, 100)]
    for corr, launch, start, dur in ((1, 110, 150, 100), (2, 120, 250, 50), (3, 310, 400, 100)):
        events.append(_event("cudaLaunchKernel", launch, 5, "cuda_runtime", correlation=corr))
        events.append({**_event(f"kernel{corr}", start, dur, "kernel", correlation=corr),
                       "tid": 7})
    run = Run(cell=None, trace=Trace(events))
    assert _read("loader_take_ms.eval", run) == pytest.approx(0.035)
    assert _read("dispatch_ms.eval", run) == pytest.approx(0.05)
    assert _read("readback_ms.eval", run) == pytest.approx(0.2)
    assert _read("results_ms.eval", run) == pytest.approx(0.1)
    assert _read("launches_per_batch.eval", run) == 1.5
    assert _read("dispatch_idle_ms.eval", run) == pytest.approx(0.25)
    # a program without the spans reads nothing
    bare = Run(cell=None, trace=Trace([e for e in events if not e["name"].startswith("vqa")]))
    assert {_read(name, bare) for name in HOST + DEVICE} == {None}


@pytest.mark.parametrize("workload", ["mutan_att.eval.butd36", "cor.eval.butd36"])
def test_on_the_card_every_step_launches_and_the_idle_splits(card, workload):
    """A traced epoch of each eval cell. Every batch's step launches a
    kernel, found through the trace's correlation ids. The device's idle
    before the first step, in the dispatch stretch and from the readback's
    start to the end of ``portbench.validate``, with the traced window's host
    time outside ``portbench.validate`` (no kernel runs there), sums to the
    trace's idle within 1%; ``dispatch_idle_ms.eval`` reads the dispatch
    stretch's. Prints the epoch split by span (each kind's count, host time
    and the device's idle inside it), the share of ``portbench.validate``
    the spans cover, and how far the card's clock, as the profiler maps it
    onto the host's, strays: the most a kernel starts before the call that
    launched it, and how long after the readback (which waits for the card)
    the epoch's last kernel ends."""
    from portbench.harness import Harness
    from portbench.spec import load_cell

    h = Harness(load_cell(workload), 2 ** 33 + 5, card, time.time())
    h.setup()
    h.window(0.0)
    h.traced()
    trace = h.run.trace
    counts = trace.kernels_per_span("vqa_tpu_torch.eval.step")
    (validate,) = [e for e in trace.host if e["name"] == "portbench.validate"]
    lo, hi = float(validate["ts"]), float(validate["ts"]) + float(validate["dur"])
    spans = {name: [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in trace.host
                    if e["name"] == name] for name in SPANS}
    first = min(a for a, _ in spans["vqa_tpu_torch.eval.step"])
    ((readback, readback_end),) = spans["vqa_tpu_torch.eval.readback"]
    kernels = [(float(k["ts"]), float(k["ts"]) + float(k["dur"])) for k in trace.kernels]
    early = [trace.launch_ts[k["args"]["correlation"]] - float(k["ts"]) for k in trace.kernels
             if (k.get("args") or {}).get("correlation") in trace.launch_ts]

    def idle(a, b):
        return (b - a) - union_us(kernels, a, b)

    parts = idle(lo, first) + idle(first, readback) + idle(readback, hi)
    outside = trace.window_us() - (hi - lo)
    want = trace.window_us() - trace.busy_us()
    share = union_us([s for ss in spans.values() for s in ss], lo, hi) / (hi - lo)
    split = {name[len("vqa_tpu_torch."):]: [len(ss), sum(b - a for a, b in ss) / 1e3,
                                             sum(idle(a, b) for a, b in ss) / 1e3]
             for name, ss in spans.items()}
    print(f"{workload}: validate {(hi - lo) / 1e3:.3f} ms, busy in it "
          f"{union_us(kernels, lo, hi) / 1e3:.3f} ms, spans cover {100 * share:.2f}%, "
          f"launches a batch {statistics.median(counts)}; idle (ms) before the first step "
          f"{idle(lo, first) / 1e3:.3f}, dispatching {idle(first, readback) / 1e3:.3f}, from the "
          f"readback {idle(readback, hi) / 1e3:.3f}, in the traced window {want / 1e3:.3f}; by "
          f"span [count, host ms, idle ms] {split}; the card's clock: a kernel starts at most "
          f"{max(early):.3f} us before its launch, the last ends "
          f"{(max(b for _, b in kernels) - readback_end) / 1e3:.3f} ms after the readback",
          flush=True)
    assert len(counts) == h.loader.steps_per_epoch() and min(counts) >= 1, counts
    assert len(early) == len(kernels)
    assert abs(parts + outside - want) <= 0.01 * want, (parts, outside, want)
    assert _read("dispatch_idle_ms.eval", h.run) == pytest.approx(idle(first, readback) / 1e3)
