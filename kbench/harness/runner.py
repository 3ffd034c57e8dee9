"""One run of one cell: the driver of its traffic kind
(``drivers/<kind>.py``), the per-layer readers by metric name, and the
result line."""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, TextIO

import torch

from . import checks
from .devtrace import TraceSummary
from .env import forbidden_modules, power_limit_w
from .layout import Cell, Layout
from .peaks import card_peaks


@dataclass
class Run:
    """What one run measured; the per-layer readers read it."""

    layout: Layout
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, float] = field(default_factory=dict)
    readings: Dict[str, float] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)
    #: ``fit`` cells: one record per fit of the window.
    fits: List[Any] = field(default_factory=list)
    #: ``serve`` cells: counters of the window (occupancy, rates).
    serve: Dict[str, float] = field(default_factory=dict)
    #: Traced runs: the reduced device trace and the binding's calls.
    trace: Optional[TraceSummary] = None
    gemm_calls: List[Any] = field(default_factory=list)

    @property
    def config(self) -> Dict[str, Any]:
        return self.cell.config

    @property
    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    @property
    def peaks(self) -> Optional[Dict[str, float]]:
        return card_peaks(self.device_name) if self.device.type == "cuda" else None

    def counts(self):
        return self.layout.module("counts", self.config["name"])


def execute(layout: Layout, cell_name: str, seed: int, seconds: float, traced: bool,
            device: torch.device) -> Run:
    """Run one cell on ``device`` and read its metrics (no result line)."""
    cell = layout.cell(cell_name)
    run = Run(layout=layout, cell=cell, seed=int(seed), seconds=float(seconds), traced=traced, device=device)
    layout.module("drivers", cell.traffic["kind"]).run(run)
    return run


def metrics_of(run: Run) -> Dict[str, Dict[str, Any]]:
    """The cell's end-to-end metrics (untraced run) or its per-layer
    metrics (traced run; a reader that finds nothing is left out)."""
    out: Dict[str, Dict[str, Any]] = {}
    if not run.traced:
        for spec in run.cell.end_to_end:
            value = run.end_to_end.get(spec["name"])
            if value is None:
                raise KeyError(f"the {run.cell.traffic['kind']} driver measured no {spec['name']!r}")
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
        return out
    for spec in run.cell.per_layer:
        value = run.layout.module("metrics", spec["name"]).read(run)
        if value is not None and math.isfinite(value):
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def result_line(run: Run) -> Dict[str, Any]:
    checks_out = checks.judge(run.readings, run.config["limits"])
    device: Dict[str, Any] = {
        "platform": "gpu" if run.device.type == "cuda" else run.device.type,
        "kind": run.device_name,
        "count": 1,
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    if run.device.type == "cuda":
        device["power_limit_w"] = power_limit_w()
    result: Dict[str, Any] = {
        "correct": checks.passed(checks_out),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics_of(run),
        "device": device,
    }
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks_out
    return result


#: What a non-finite number is written as: JSON has no infinity, and a
#: reading that is infinite or undefined is the worst a number can be.
WORST = 1.7976931348623157e308


def _finite(obj: Any) -> Any:
    if isinstance(obj, float) and not math.isfinite(obj):
        return WORST
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def report(run: Run, out: TextIO = sys.stdout, err: TextIO = sys.stderr) -> int:
    """Print the result line (last on standard output) and the checks
    (last on standard error). Returns the exit code: 1 without a line
    where the process holds a module of JAX or the JAX package."""
    result = _finite(result_line(run))
    found = forbidden_modules()
    if found:
        print(f"kbench: the run loaded JAX or the JAX package: {', '.join(found[:20])}", file=err)
        return 1
    for note in run.notes:
        print(f"kbench: {note}", file=err)
    out.write(json.dumps(result, allow_nan=False) + "\n")
    out.flush()
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=err)
    err.flush()
    return 0
