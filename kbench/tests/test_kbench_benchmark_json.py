"""BENCHMARK.json against the benchmark contract's shapes: keys, names,
units, sizes, and that every name has the files the harness looks for."""

import json
import re

import pytest

from kbench.harness.layout import KBENCH_DIR, Layout

ROOT = KBENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for path in bench["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
        assert not path.endswith("_torch")
    for word in bench["command"][1:]:
        if "/" in word:
            assert any(word == p or word.startswith(p + "/") for p in bench["paths"])
            assert (ROOT / word).is_file()
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_names_units_and_metric_keys():
    bench = _bench()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in bench[group]}) == len(bench[group])
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(bench["end_to_end"]) <= 16
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"]) and m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_and_their_metrics():
    bench = _bench()
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    assert 1 <= len(cells) <= 24 and 1 <= len(configs) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    four = [w for w in cells.values() if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert w["config"] in configs and NAME.match(w["traffic"]) and _line(w["why"])
    assert {w["config"] for w in cells.values()} == set(configs)
    for name in cells:
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
        moved = {m["moves"] for m in layer}
        assert moved <= {m["name"] for m in e2e}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= set(cells)


def test_every_name_has_its_files():
    bench = _bench()
    layout = Layout()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("kbench/") and PATH.match(c["file"])
        config = layout.load_json(ROOT / c["file"])
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key in config
        for kind in ("systems", "reference", "counts"):
            assert (KBENCH_DIR / kind / f"{c['name']}.py").is_file()
    for name in {w["traffic"] for w in bench["workloads"]}:
        mix = layout.traffic(name)
        assert callable(layout.module("drivers", mix["kind"]).run)
        if "arrivals" in mix:
            assert callable(layout.module("arrivals", mix["arrivals"]).offsets)
    for m in bench["per_layer"]:
        assert callable(layout.module("metrics", m["name"]).read)


#: What the drivers of this benchmark compare, by traffic kind.
READINGS = {"fit": {"train_score_gap", "heldout_score_gap"}, "serve": {"served_score_gap", "unanswered_requests"}}


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_limits_cover_every_reading(cell):
    layout = Layout()
    found = layout.cell(cell)
    limits = found.config["limits"]
    assert READINGS.get(found.traffic["kind"], set()) <= set(limits) and limits
    assert all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())
