"""The driver of the ``fit`` traffic kind: whole fits of a configuration's pipeline run
back to back for the window.

Set-up makes the data on the card from the seed and runs one whole fit
at the timed shapes (nothing in the port compiles after it; the CUDA
libraries it builds are cached inside the checkout). The window then
starts fits until ``seconds`` have passed; every fit started in it runs
to its end, and the rate is the training examples of those fits over the
time from the window's start to the end of the last one.

Each fit is the system's whole user-facing fit: building the pipeline
(the random weights or the learned filters) and ``Pipeline.fit()``. The
model of the previous fit stays alive while the next one runs, as the
warm-up's does for the first, so every fit runs beside one model. After
the window the last model's scores on a seeded sample of training rows
and on held-out rows are compared with the plain reference, computed
once the program's state is freed.
"""

from __future__ import annotations

import gc
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from kbench.harness.checks import score_gap
from kbench.harness.devtrace import Probe, Profiler
from kbench.harness.env import process_age_s


@dataclass
class FitRecord:
    wall_s: float
    build_s: float
    #: Seconds of the pipeline's nodes outside the build (traced runs).
    node_s: Optional[float] = None


class BuildClock:
    """The system's build step (random weights, learned filters), timed
    on the host clock by the harness: the system wraps that step in
    ``with clock():``."""

    def __init__(self, device: torch.device, timings: Optional[List[Any]] = None):
        self.device = device
        self.seconds = 0.0
        #: Under ``trace()``: the trace's node timings, and which of them
        #: ran inside the build (their seconds are the build's, not the
        #: pipeline's).
        self.timings = timings
        self.inside: List[int] = []

    @contextmanager
    def __call__(self):
        first = len(self.timings) if self.timings is not None else 0
        start = time.perf_counter()
        try:
            with torch.profiler.record_function("kbench.build"):
                yield
        finally:
            _sync(self.device)
            self.seconds += time.perf_counter() - start
            if self.timings is not None:
                self.inside.extend(range(first, len(self.timings)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_env() -> None:
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    PipelineEnv.reset()


def _one_fit(system, config, data, run, traced: bool):
    start = time.perf_counter()
    if traced:
        from keystone_tpu_torch.workflow.tracing import trace

        with trace() as tr, torch.profiler.record_function("kbench.fit"):
            clock = BuildClock(run.device, tr.timings)
            fitted = system.fit(config, data, run.device, run.seed, clock)
            _sync(run.device)
        inside = set(clock.inside)
        node_s = sum(t.seconds for i, t in enumerate(tr.timings) if i not in inside)
    else:
        clock = BuildClock(run.device)
        fitted = system.fit(config, data, run.device, run.seed, clock)
        _sync(run.device)
        node_s = None
    wall = time.perf_counter() - start
    _reset_env()
    return fitted, FitRecord(wall, clock.seconds, node_s)


def run(run) -> None:
    """Fill ``run`` (a :class:`kbench.harness.runner.Run`) for a ``fit``
    cell."""
    config, layout = run.cell.config, run.layout
    system = layout.module("systems", config["name"])
    device = run.device
    data = system.make_data(config, run.seed, device)
    _sync(device)

    probe: Optional[Probe] = None
    if run.traced:
        probe = Probe(config.get("layer_calls"))
        probe.install()
    try:
        last, _ = _one_fit(system, config, data, run, run.traced)
        # Set-up's garbage is collected in set-up, not by the window's
        # first fit.
        gc.collect()
        run.setup_s = process_age_s()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        profiler = Profiler() if run.traced else None
        if probe is not None:
            probe.gemm_calls.clear()
        if profiler is not None:
            profiler.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < run.seconds:
            fitted, record = _one_fit(system, config, data, run, run.traced)
            last = fitted
            del fitted
            run.fits.append(record)
        run.window_s = time.perf_counter() - t0
        if device.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        if profiler is not None:
            profiler.stop()
            run.trace = profiler.summary()
            run.gemm_calls = list(probe.gemm_calls)
    finally:
        if probe is not None:
            probe.uninstall()

    rows = int(config["train_rows"])
    run.notes.append(
        f"{len(run.fits)} fits of {rows} rows in {run.window_s} s; walls "
        f"{[round(f.wall_s, 4) for f in run.fits]} s, builds {[round(f.build_s, 4) for f in run.fits]} s; "
        f"setup {run.setup_s} s; peak {run.memory_peak_bytes} bytes"
    )
    run.attempted = len(run.fits)
    run.end_to_end["fit_examples_per_s"] = len(run.fits) * rows / run.window_s
    run.end_to_end["fit_peak_gib"] = run.memory_peak_bytes / 2**30
    run.end_to_end["setup_s"] = run.setup_s

    # The check: the last model of the window against the reference.
    eval_sets = system.eval_sets(config, data, run.seed)
    got = {name: system.apply(last, x).detach().to("cpu", torch.float64) for name, x in eval_sets.items()}
    del last
    _reset_env()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = layout.module("reference", config["name"])
    want = reference.fit_and_score(config, system.fit_inputs(data), eval_sets, run.seed, "fp64", device)
    run.readings = {f"{name}_score_gap": score_gap(got[name], want[name]) for name in eval_sets}
