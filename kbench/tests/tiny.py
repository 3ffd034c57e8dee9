"""Tiny copies of the benchmark's cells for CPU tests: the same files,
found by the same names, with the configurations cut to seconds. Beside
the cells of BENCHMARK.json, the served CIFAR-10 cell that waits under
PERF.md's Open questions (``cifar.serve``), so the serve driver, its
arrivals and its readers stay tested until a cell uses them."""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import torch

from kbench.harness.layout import Layout
from kbench.harness.runner import execute

TINY_CONFIGS: Dict[str, Dict[str, Any]] = {
    "timit_cosine": dict(num_cosines=3, num_cosine_features=64, block_size=64, train_rows=768,
                         check={"train_rows": 96, "heldout_rows": 96}),
    "cifar_random_patch": dict(num_filters=40, train_rows=160, whitener_size=1500,
                               check={"train_rows": 32, "heldout_rows": 32}),
}

TINY_SERVE = dict(rate_per_s=60, fit_rows=160, request_pool=48, check_requests=24,
                  warm_seconds=0.3, trace_seconds=0.5)


#: The served cell and the metrics only it would report, as entries of
#: BENCHMARK.json would give them.
SERVE_ENTRIES: Dict[str, List[Dict[str, Any]]] = {
    "workloads": [{"name": "cifar.serve", "config": "cifar_random_patch", "traffic": "serve_poisson", "chips": 1,
                   "why": "one image a request, Poisson arrivals, batches of up to 16"}],
    "end_to_end": [{"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": ["cifar.serve"]}],
    "per_layer": [
        {"name": "device_idle_share.serve", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "serve_p95_ms", "workloads": ["cifar.serve"]},
        {"name": "batch_occupancy.serve", "unit": "%", "better": "higher", "source": "program_counter",
         "layer": "serving", "moves": "serve_p95_ms", "workloads": ["cifar.serve"]},
    ],
}


class TinyLayout(Layout):
    """The real layout and the served cell, with each configuration cut as
    above."""

    @property
    def benchmark(self):
        if self._benchmark is None:
            bench = copy.deepcopy(Layout().benchmark)
            for group, entries in SERVE_ENTRIES.items():
                bench[group] = bench[group] + copy.deepcopy(entries)
            self._benchmark = bench
        return self._benchmark

    def cell(self, name):
        cell = super().cell(name)
        cell.config = copy.deepcopy(cell.config)
        cell.config.update(copy.deepcopy(TINY_CONFIGS[cell.config["name"]]))
        if cell.traffic["kind"] == "serve":
            cell.traffic = dict(cell.traffic, **TINY_SERVE)
        return cell


def tiny_run(cell: str, seed: int = 2**31 + 3, seconds: float = 0.5, traced: bool = False, layout=None):
    return execute(layout or TinyLayout(), cell, seed, seconds, traced, torch.device("cpu"))
