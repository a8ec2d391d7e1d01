"""Layer: device. The share of the traced window (the traced train steps) in
which no kernel ran: one less the union of the kernel intervals over the
window's host-clock length, traced with the profiler's host side off so
that its cost lengthens no gap, in %."""


def read(run):
    trace = run.device_trace
    if trace is None or not trace.window_us():
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us())
