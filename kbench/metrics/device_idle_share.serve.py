"""device_idle_share.serve: the share of the traced window in which no
kernel, copy or set ran on the card (the profiler's trace; the union of
their intervals against the window), in serve cells. In %."""

KIND = "serve"


def read(run):
    trace = run.trace
    if trace is None or trace.window_s <= 0 or trace.kernels == 0 or run.cell.traffic["kind"] != KIND:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
