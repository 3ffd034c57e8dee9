"""batch_occupancy.serve: mean batch size over ``max_batch`` for every
batch of the window, from the metrics registry's occupancy histogram
(sum / count, read at the window's start and end; not the telemetry's
percentile deque, which keeps the last 2,048). In %."""


def read(run):
    value = run.serve.get("batch_occupancy")
    return None if value is None else 100.0 * value
