"""Where the benchmark's parts live, found by the names in BENCHMARK.json.

A later change adds a configuration, a traffic mix or a per-layer metric
by adding files under these directories and entries in BENCHMARK.json;
no file here names one of them. A traffic mix's ``kind`` names its driver
(``drivers/<kind>.py``) and, for an open loop, its ``arrivals`` name the
generator of its arrival times (``arrivals/<name>.py``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

#: The benchmark's own directory (this package's parent).
KBENCH_DIR = Path(__file__).resolve().parent.parent


class LayoutError(Exception):
    """A name in BENCHMARK.json that has no file, or a file that does not
    hold what its name promises."""


@dataclass
class Cell:
    """One entry of ``workloads``, with what it names loaded."""

    name: str
    entry: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


class Layout:
    """The benchmark rooted at ``bench_dir`` (default: ``kbench/``), with
    the repo root above it holding ``BENCHMARK.json``."""

    def __init__(self, bench_dir: Optional[Path] = None, benchmark: Optional[Dict[str, Any]] = None,
                 repo_root: Optional[Path] = None):
        self.bench_dir = Path(bench_dir or KBENCH_DIR).resolve()
        self.repo_root = Path(repo_root or self.bench_dir.parent).resolve()
        self._benchmark = benchmark
        self._modules: Dict[Path, ModuleType] = {}

    # ------------------------------------------------------------ benchmark
    @property
    def benchmark(self) -> Dict[str, Any]:
        if self._benchmark is None:
            path = self.repo_root / "BENCHMARK.json"
            if not path.is_file():
                raise LayoutError(f"no BENCHMARK.json at {self.repo_root}")
            self._benchmark = json.loads(path.read_text())
        return self._benchmark

    def cell(self, name: str) -> Cell:
        bench = self.benchmark
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if not entries:
            known = ", ".join(w["name"] for w in bench["workloads"])
            raise LayoutError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
        entry = entries[0]
        configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
        if not configs:
            raise LayoutError(f"workload {name!r} names config {entry['config']!r}, which is not listed")
        config = self.load_json(self.repo_root / configs[0]["file"])
        if config.get("name") != entry["config"]:
            raise LayoutError(f"{configs[0]['file']} holds config {config.get('name')!r}, not {entry['config']!r}")
        traffic = self.traffic(entry["traffic"])
        return Cell(
            name=name,
            entry=entry,
            config=config,
            traffic=traffic,
            end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
            per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        )

    # ----------------------------------------------------------------- files
    @staticmethod
    def load_json(path: Path) -> Dict[str, Any]:
        if not path.is_file():
            raise LayoutError(f"missing file {path}")
        return json.loads(path.read_text())

    def traffic(self, name: str) -> Dict[str, Any]:
        mix = self.load_json(self.bench_dir / "traffic" / f"{name}.json")
        if mix.get("name") != name:
            raise LayoutError(f"traffic/{name}.json names itself {mix.get('name')!r}")
        return mix

    def module(self, kind: str, name: str) -> ModuleType:
        """``<bench_dir>/<kind>/<name>.py`` loaded by path (a name may hold
        dots, as metric names do), once per layout. A layout rooted in a
        directory of its own also finds the benchmark's own files, so a
        cell there may use the drivers and arrivals that ``kbench/`` has."""
        candidates = [self.bench_dir / kind / f"{name}.py", KBENCH_DIR / kind / f"{name}.py"]
        path = next((p for p in candidates if p.is_file()), None)
        if path is None:
            raise LayoutError(f"missing {kind} file {candidates[0]}")
        if path not in self._modules:
            mod_name = f"kbench_{kind}_{name}".replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = module
            spec.loader.exec_module(module)
            self._modules[path] = module
        return self._modules[path]


def _reports(metric: Dict[str, Any], cell_name: str) -> bool:
    """Whether ``cell_name`` reports ``metric``: every cell unless the
    metric lists its cells under ``workloads``."""
    cells = metric.get("workloads")
    return cells is None or cell_name in cells
