"""The driver of the ``serve`` traffic kind: an open loop of independent
users, each request one input, offered on a fixed seeded schedule to the
port's in-process ``PipelineServer``. The mix's ``arrivals`` name the
generator of the arrival times (``arrivals/<name>.py``, whose
``offsets(rate, count, seed, mix)`` gives them).

Set-up makes the data on the card from the seed, fits the model through
the configuration's pipeline, starts the server with the mix's
``ServingConfig``, warms every batch bucket and then offers the mix's
rate for ``warm_seconds`` (its answers are not measured). The window
offers ``rate_per_s × seconds`` requests; each request's latency runs
from the moment it was due to be sent, so a late generator or a stall
shows in every later request. A request that is shed or fails counts as
failed and as missing every limit (its latency is infinite). How late
the generator ran is printed on standard error, not in the result.

After the window every answer is awaited (a minute past the close at
most; one that never comes is failed), then a seeded sample of the
answered requests is compared with the plain reference.
"""

from __future__ import annotations

import gc
import math
import statistics
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from kbench.harness.checks import score_gap
from kbench.harness.devtrace import Profiler
from kbench.harness.env import process_age_s
from kbench.harness.layout import LayoutError

SETTLE_S = 60.0


def _percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in 0–100) of all values, infinities
    included."""
    if not values:
        return float("nan")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


class _Offer:
    """One pass of the schedule against the server."""

    def __init__(self, server, payloads: np.ndarray, picks: np.ndarray, offsets: List[float]):
        self.server = server
        self.payloads = payloads
        self.picks = picks
        self.offsets = offsets
        n = len(offsets)
        self.due = [0.0] * n
        self.done = [math.inf] * n
        self.lateness = [0.0] * n
        self.answers: List[Optional[np.ndarray]] = [None] * n
        self.failed = [False] * n
        self._settled = threading.Semaphore(0)
        self._accepted = 0

    def _callback(self, i: int):
        def on_done(future) -> None:
            now = time.perf_counter()
            try:
                self.answers[i] = np.asarray(future.result())
                self.done[i] = now
            except Exception:
                self.failed[i] = True
            self._settled.release()

        return on_done

    def run(self) -> None:
        """Offer every request on schedule."""
        from keystone_tpu_torch.serving.config import RequestShed, ServerClosed

        start = time.perf_counter()
        for i, offset in enumerate(self.offsets):
            due = start + offset
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.due[i] = due
            self.lateness[i] = time.perf_counter() - due
            try:
                future = self.server.submit(self.payloads[self.picks[i]])
            except (RequestShed, ServerClosed):
                self.failed[i] = True
                continue
            self._accepted += 1
            future.add_done_callback(self._callback(i))

    def settle(self, timeout_s: float) -> None:
        deadline = time.perf_counter() + timeout_s
        for _ in range(self._accepted):
            if not self._settled.acquire(timeout=max(deadline - time.perf_counter(), 0.01)):
                break

    def latencies_ms(self) -> List[float]:
        return [
            math.inf if (self.failed[i] or self.answers[i] is None) else (self.done[i] - self.due[i]) * 1e3
            for i in range(len(self.offsets))
        ]


def _occupancy() -> tuple:
    """(sum, count) of the registry's batch-occupancy histogram, which
    sees every batch (the telemetry's percentile deque keeps only the
    last 2,048)."""
    from keystone_tpu_torch.obs import names

    hist = names.metric(names.SERVING_BATCH_OCCUPANCY)
    return hist.sum(model="default"), hist.count(model="default")


def start_server(run, system, config, traffic, data):
    from keystone_tpu_torch.serving.config import ServingConfig
    from keystone_tpu_torch.serving.server import PipelineServer

    model = system.serve_model(config, data, run.device, run.seed)
    serving = ServingConfig(
        max_batch=int(traffic["max_batch"]),
        max_wait_ms=float(traffic["max_wait_ms"]),
        queue_depth=int(traffic["queue_depth"]),
    )
    server = PipelineServer(model, serving, device=run.device).start()
    payloads = system.request_payloads(data)
    server.warmup(payloads[0])
    return server, payloads


def arrivals(layout, traffic):
    """The mix's generator of arrival times, found by its ``arrivals``
    name."""
    name = traffic.get("arrivals")
    if not name:
        raise LayoutError(f"traffic {traffic.get('name')!r} names no arrivals")
    return layout.module("arrivals", name)


def schedule(layout, traffic, server, payloads: np.ndarray, rate: float, seconds: float, seed: int) -> _Offer:
    """The window's requests: ``rate × seconds`` arrivals from the mix's
    generator and the inputs they carry, both from ``seed``."""
    count = max(1, int(round(rate * seconds)))
    offsets = arrivals(layout, traffic).offsets(rate, count, seed, traffic)
    picks = np.random.default_rng(seed).integers(0, len(payloads), size=count)
    return _Offer(server, payloads, picks, offsets)


def run(run, rate: Optional[float] = None) -> None:
    """Fill ``run`` (a :class:`kbench.harness.runner.Run`) for a ``serve``
    cell; ``rate`` overrides the mix's (the sweep's use)."""
    config, traffic, layout = run.cell.config, run.cell.traffic, run.layout
    system = layout.module("systems", config["name"])
    device = run.device
    rate = float(rate if rate is not None else traffic["rate_per_s"])
    data = system.make_serve_data(config, traffic, run.seed, device)
    server, payloads = start_server(run, system, config, traffic, data)
    try:
        profiler = None
        if run.traced:
            # The profiler's first start initialises the device tracer;
            # it happens here, in set-up, not while requests arrive.
            Profiler().start_and_discard()
            profiler = Profiler()
        warm = schedule(layout, traffic, server, payloads, rate, float(traffic["warm_seconds"]), run.seed + 1)
        warm.run()
        warm.settle(SETTLE_S)
        gc.collect()
        run.setup_s = process_age_s()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        occ_sum0, occ_count0 = _occupancy()
        load = schedule(layout, traffic, server, payloads, rate, run.seconds, run.seed)
        if profiler is not None:
            # The whole schedule is offered; the profiler sees its last
            # ``trace_seconds`` and stops once the last request is in, so
            # stopping it (which holds the interpreter) delays answers
            # but never fills the queue. It is reduced after the last
            # answer.
            generator = threading.Thread(target=load.run, name="kbench-generator")
            generator.start()
            time.sleep(max(0.0, run.seconds - float(traffic["trace_seconds"])))
            profiler.start()
            generator.join()
            profiler.stop()
            load.settle(SETTLE_S + run.seconds)
            run.trace = profiler.summary()
        else:
            load.run()
            load.settle(SETTLE_S + run.seconds)
        answered_at = [d for d in load.done if d != math.inf]
        run.window_s = (max(answered_at) if answered_at else time.perf_counter()) - load.due[0]
        if device.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        occ_sum1, occ_count1 = _occupancy()
        if occ_count1 > occ_count0:
            run.serve["batch_occupancy"] = (occ_sum1 - occ_sum0) / (occ_count1 - occ_count0)
    finally:
        server.stop(drain=True)

    latencies = load.latencies_ms()
    run.attempted = len(latencies)
    run.failed = sum(1 for v in latencies if v == math.inf)
    run.end_to_end["serve_p95_ms"] = _percentile(latencies, 95.0)
    run.end_to_end["setup_s"] = run.setup_s
    late_ms = sorted(v * 1e3 for v in load.lateness)
    run.notes.append(
        f"generator lateness ms: p50 {statistics.median(late_ms)} p99 {_percentile(late_ms, 99.0)} "
        f"max {late_ms[-1]}; offered {run.attempted} at {rate} per s, failed {run.failed}, "
        f"completed per s {(run.attempted - run.failed) / run.window_s if run.window_s > 0 else 0.0}"
    )

    # The check: a seeded sample of the answered requests, longest batch
    # waits included, against the reference fitted on the same images.
    answered = [i for i in range(len(latencies)) if load.answers[i] is not None]
    missing = len(latencies) - len(answered)
    want_n = min(int(traffic["check_requests"]), len(answered))
    rng = np.random.default_rng(run.seed + 2)
    sample = sorted(rng.choice(answered, size=want_n, replace=False).tolist()) if want_n else []
    if answered:
        slowest = max(answered, key=lambda i: latencies[i])
        if slowest not in sample:
            sample.append(slowest)
    got = torch.from_numpy(np.stack([load.answers[i] for i in sample])) if sample else None
    inputs = torch.from_numpy(np.stack([payloads[load.picks[i]] for i in sample])) if sample else None
    del server
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = layout.module("reference", config["name"])
    if got is None:
        run.readings = {"served_score_gap": math.inf, "unanswered_requests": float(missing)}
        return
    want = reference.fit_and_score(
        config, system.fit_inputs(data), {"served": inputs.to(device)}, run.seed, "fp64", device
    )
    run.readings = {
        "served_score_gap": score_gap(got, want["served"]),
        "unanswered_requests": float(missing),
    }
