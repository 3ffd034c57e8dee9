"""A configuration, a traffic mix, a per-layer metric, a generator of
arrival times and a traffic kind's driver added as new files in a
directory of their own, and entries in the benchmark's list: the harness
finds each by its name and runs the new cell, with no file of the
benchmark edited."""

import copy
import json
import textwrap

import pytest
import torch

from kbench.harness.layout import KBENCH_DIR, Layout, LayoutError
from kbench.harness.runner import execute, metrics_of, result_line
from kbench.tests.tiny import TinyLayout, tiny_run

SYSTEM = '''
"""A ridge fit through the port's block solver, one block."""
import torch


def make_data(config, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    n, d = config["train_rows"], config["dim"]
    x = torch.randn(n + 32, d, generator=g, device=device)
    labels = torch.randint(0, config["num_classes"], (n,), generator=g, device=device)
    return {"x": x[:n], "labels": labels, "x_heldout": x[n:]}


def fit(config, data, device, seed, build_clock):
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util.labels import ClassLabelIndicators

    with build_clock():
        est = BlockLeastSquaresEstimator(config["dim"], num_iter=1, reg=config["reg"], device=device)
    labels = ClassLabelIndicators(config["num_classes"])(ArrayDataset(data["labels"]))
    return est.with_data(ArrayDataset(data["x"]), labels).fit()


def apply(fitted, x):
    from keystone_tpu_torch.data.dataset import ArrayDataset

    return fitted.apply_batch(ArrayDataset(x)).data[: x.shape[0]]


def fit_inputs(data):
    return {"x": data["x"], "labels": data["labels"]}


def eval_sets(config, data, seed):
    return {"heldout": data["x_heldout"]}
'''

REFERENCE = '''
"""Ridge on centred data, solved directly in float64."""
import torch


def fit_and_score(config, inputs, eval_sets, seed, precision, device):
    x = inputs["x"].double()
    y = -torch.ones(x.shape[0], config["num_classes"], dtype=torch.float64)
    y[torch.arange(x.shape[0]), inputs["labels"].long()] = 1.0
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    w = torch.linalg.solve(xc.T @ xc + config["reg"] * torch.eye(x.shape[1], dtype=torch.float64), xc.T @ yc)
    return {k: (v.double() - mx) @ w + my for k, v in eval_sets.items()}
'''

COUNTS = '''
def fit_flops(config):
    return 2.0 * config["train_rows"] * config["dim"] ** 2
'''

METRIC = '''
"""fits_seen.fit: how many fits the traced window ran."""


def read(run):
    return float(len(run.fits)) if run.fits else None
'''


def test_new_cell_from_new_files_only(tmp_path):
    bench_dir = tmp_path / "kbench_extra"
    for sub in ("configs", "systems", "reference", "counts", "traffic", "metrics"):
        (bench_dir / sub).mkdir(parents=True)
    config = {"name": "toy_ridge", "source": "https://example.org/toy", "dim": 24, "num_classes": 4,
              "train_rows": 256, "reg": 0.5, "reduced": [], "product_kind": "ieee_fp32",
              "limits": {"heldout_score_gap": 1e-4}}
    (bench_dir / "configs" / "toy_ridge.json").write_text(json.dumps(config))
    (bench_dir / "systems" / "toy_ridge.py").write_text(textwrap.dedent(SYSTEM))
    (bench_dir / "reference" / "toy_ridge.py").write_text(textwrap.dedent(REFERENCE))
    (bench_dir / "counts" / "toy_ridge.py").write_text(textwrap.dedent(COUNTS))
    (bench_dir / "traffic" / "fit_twice.json").write_text(json.dumps({"name": "fit_twice", "kind": "fit"}))
    (bench_dir / "metrics" / "fits_seen.fit.py").write_text(textwrap.dedent(METRIC))
    bench = {
        "configs": [{"name": "toy_ridge", "source": "https://example.org/toy",
                     "file": "kbench_extra/configs/toy_ridge.json", "reduced": [], "why": "toy"}],
        "workloads": [{"name": "toy.fit", "config": "toy_ridge", "traffic": "fit_twice", "chips": 1, "why": "toy"}],
        "end_to_end": [
            {"name": "fit_examples_per_s", "unit": "examples/s", "better": "higher", "bound": 0.05, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"},
        ],
        "per_layer": [{"name": "fits_seen.fit", "unit": "fits", "better": "higher", "source": "program_counter",
                       "layer": "toy", "moves": "fit_examples_per_s"}],
    }
    layout = Layout(bench_dir=bench_dir, benchmark=bench, repo_root=tmp_path)
    cell = layout.cell("toy.fit")
    assert cell.config["name"] == "toy_ridge" and cell.traffic["kind"] == "fit"

    plain = execute(layout, "toy.fit", 2**31 + 1, 0.3, False, torch.device("cpu"))
    assert set(metrics_of(plain)) == {"fit_examples_per_s", "setup_s"}
    assert plain.readings["heldout_score_gap"] < 1e-4

    traced = execute(layout, "toy.fit", 2**31 + 1, 0.3, True, torch.device("cpu"))
    metrics = metrics_of(traced)
    assert metrics["fits_seen.fit"]["value"] == len(traced.fits) >= 1
    assert metrics["fits_seen.fit"]["unit"] == "fits"


EVENLY = '''
"""Evenly spaced arrivals: one every 1/rate seconds."""
CALLS = []


def offsets(rate_per_s, count, seed, mix):
    CALLS.append((rate_per_s, count, seed, mix["name"]))
    return [(i + 1) / rate_per_s for i in range(count)]
'''


def test_new_arrivals_from_a_new_file(tmp_path):
    """A served cell whose mix names arrivals that only a new file holds;
    the serve driver and the configuration are the benchmark's own."""
    bench_dir = tmp_path / "kbench_extra"
    (bench_dir / "arrivals").mkdir(parents=True)
    (bench_dir / "traffic").mkdir()
    (bench_dir / "arrivals" / "evenly.py").write_text(textwrap.dedent(EVENLY))
    mix = json.loads((KBENCH_DIR / "traffic" / "serve_poisson.json").read_text())
    mix.update(name="serve_even", arrivals="evenly")
    (bench_dir / "traffic" / "serve_even.json").write_text(json.dumps(mix))
    bench = copy.deepcopy(TinyLayout().benchmark)
    bench["workloads"].append({"name": "cifar.serve_even", "config": "cifar_random_patch",
                               "traffic": "serve_even", "chips": 1, "why": "toy"})
    serve_p95 = next(m for m in bench["end_to_end"] if m["name"] == "serve_p95_ms")
    serve_p95["workloads"].append("cifar.serve_even")
    layout = TinyLayout(bench_dir=bench_dir, benchmark=bench, repo_root=KBENCH_DIR.parent)

    run = tiny_run("cifar.serve_even", layout=layout)
    calls = layout.module("arrivals", "evenly").CALLS
    # The warm offer's arrivals, then the window's.
    assert [c[2:] for c in calls] == [(run.seed + 1, "serve_even"), (run.seed, "serve_even")]
    assert calls[-1][1] == run.attempted
    assert result_line(run)["correct"]


DRIVER = '''
"""A traffic kind that counts: no fit, three items, nothing to get wrong."""


def run(run):
    run.setup_s = 0.25
    run.window_s = run.seconds
    run.attempted = int(run.cell.traffic["items"])
    run.end_to_end.update(items_per_s=run.attempted / run.seconds, setup_s=run.setup_s)
    run.readings = {"item_gap": 0.0}
'''


def test_new_traffic_kind_from_a_new_file(tmp_path):
    bench_dir = tmp_path / "kbench_extra"
    for sub in ("configs", "drivers", "traffic"):
        (bench_dir / sub).mkdir(parents=True)
    (bench_dir / "configs" / "toy_count.json").write_text(json.dumps(
        {"name": "toy_count", "reduced": [], "limits": {"item_gap": 0}}))
    (bench_dir / "drivers" / "count.py").write_text(textwrap.dedent(DRIVER))
    (bench_dir / "traffic" / "three.json").write_text(json.dumps({"name": "three", "kind": "count", "items": 3}))
    bench = {
        "configs": [{"name": "toy_count", "source": "https://example.org/toy",
                     "file": "kbench_extra/configs/toy_count.json", "reduced": [], "why": "toy"}],
        "workloads": [{"name": "toy.count", "config": "toy_count", "traffic": "three", "chips": 1, "why": "toy"}],
        "end_to_end": [
            {"name": "items_per_s", "unit": "items/s", "better": "higher", "bound": 0.05, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"},
        ],
        "per_layer": [],
    }
    layout = Layout(bench_dir=bench_dir, benchmark=bench, repo_root=tmp_path)
    run = execute(layout, "toy.count", 2**31 + 1, 2.0, False, torch.device("cpu"))
    line = result_line(run)
    assert line["correct"] and line["attempted"] == 3
    assert line["metrics"] == {"items_per_s": {"value": 1.5, "unit": "items/s"}, "setup_s": {"value": 0.25, "unit": "s"}}


def test_a_name_with_no_file_raises(tmp_path):
    bench_dir = tmp_path / "kbench_extra"
    for sub in ("configs", "traffic"):
        (bench_dir / sub).mkdir(parents=True)
    (bench_dir / "configs" / "toy_count.json").write_text(json.dumps({"name": "toy_count", "limits": {}}))
    (bench_dir / "traffic" / "odd.json").write_text(json.dumps({"name": "odd", "kind": "nonesuch"}))
    (bench_dir / "traffic" / "open.json").write_text(json.dumps({"name": "open", "kind": "serve", "arrivals": "nonesuch"}))
    (bench_dir / "traffic" / "bare.json").write_text(json.dumps({"name": "bare", "kind": "serve"}))
    bench = {"configs": [{"name": "toy_count", "file": "kbench_extra/configs/toy_count.json"}],
             "workloads": [{"name": "toy.odd", "config": "toy_count", "traffic": "odd"}],
             "end_to_end": [], "per_layer": []}
    layout = Layout(bench_dir=bench_dir, benchmark=bench, repo_root=tmp_path)
    with pytest.raises(LayoutError, match="drivers"):
        execute(layout, "toy.odd", 1, 1.0, False, torch.device("cpu"))
    serve = layout.module("drivers", "serve")
    with pytest.raises(LayoutError, match="arrivals"):
        serve.arrivals(layout, layout.traffic("open"))
    with pytest.raises(LayoutError, match="names no arrivals"):
        serve.arrivals(layout, layout.traffic("bare"))
