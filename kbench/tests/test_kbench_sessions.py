"""The readers of the port's own spans and counters (``bcd_grams.fit``,
``plan_s.fit``), on hand-made session summaries and on tiny traced runs
of the fit cells on the CPU."""

import math
from types import SimpleNamespace

import pytest

from kbench.harness.layout import Layout
from kbench.tests.tiny import TinyLayout, tiny_run

GRAMS = "keystone_bcd_steps_total{step=gram}"


def _summary(grams, plan_s, name="pipeline"):
    return SimpleNamespace(name=name, counters={GRAMS: grams} if grams is not None else {},
                           span_seconds={"plan": plan_s} if plan_s is not None else {})


def _read(metric, run):
    return Layout().module("metrics", metric).read(run)


@pytest.fixture
def recent(monkeypatch):
    """Stand-in summaries for the port's ``recent_sessions()``."""
    from keystone_tpu_torch.obs import spans

    kept = []
    monkeypatch.setattr(spans, "recent_sessions", lambda: list(kept))
    return kept


def test_readers_take_the_last_session_of_each_fit(recent):
    # The warm-up fit's session, another session, then the window's two fits.
    recent += [_summary(99, 9.0), _summary(None, None, name="explain"), _summary(250, 0.02), _summary(250, 0.04)]
    run = SimpleNamespace(traced=True, fits=[object(), object()])
    assert _read("bcd_grams.fit", run) == 250
    assert math.isclose(_read("plan_s.fit", run), 0.03)


def test_readers_find_nothing_to_read(recent):
    run = SimpleNamespace(traced=True, fits=[object(), object()])
    recent += [_summary(250, 0.02)]
    # Fewer of the port's sessions than fits: not the window's.
    assert _read("bcd_grams.fit", run) is None and _read("plan_s.fit", run) is None
    recent += [_summary(None, None)]
    assert _read("bcd_grams.fit", run) is not None
    recent[:] = [_summary(None, None), _summary(None, None)]
    assert _read("bcd_grams.fit", run) is None and _read("plan_s.fit", run) is None
    assert _read("bcd_grams.fit", SimpleNamespace(traced=False, fits=[object()])) is None


def test_a_port_without_summaries_gives_no_reading(monkeypatch):
    """The parent commit's port keeps no session summaries: the readers
    return nothing and do not raise."""
    from keystone_tpu_torch.obs import spans

    monkeypatch.delattr(spans, "recent_sessions")
    run = SimpleNamespace(traced=True, fits=[object()])
    assert _read("bcd_grams.fit", run) is None and _read("plan_s.fit", run) is None


class ThreeBlockCifar(TinyLayout):
    """The tiny CIFAR cell with filters for three 512-filter blocks."""

    def cell(self, name):
        cell = super().cell(name)
        if cell.config["name"] == "cifar_random_patch":
            cell.config["num_filters"] = 1030
        return cell


def _grams_a_fit(config):
    if config["name"] == "timit_cosine":
        blocks = config["num_cosines"] * config["num_cosine_features"] // config["block_size"]
    else:
        blocks = math.ceil(config["num_filters"] / config["block_filters"])
    return config["num_epochs"] * blocks


@pytest.mark.parametrize("cell", ["timit.fit", "cifar.fit"])
def test_tiny_traced_run_counts_its_grams_exactly(cell):
    layout = ThreeBlockCifar()
    run = tiny_run(cell, traced=True, layout=layout)
    from kbench.harness.runner import metrics_of

    metrics = metrics_of(run)
    assert metrics["bcd_grams.fit"]["value"] == _grams_a_fit(layout.cell(cell).config) > 1
    assert 0 < metrics["plan_s.fit"]["value"] < min(f.wall_s for f in run.fits)
