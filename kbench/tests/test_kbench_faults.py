"""The check with the timed path broken underneath: a run that skips the
look for a card and drives everything else (the window, the answers,
the reference) must come out not correct for each fault its cell can
have. One card runs each cell, so no exchange between cards exists to
leave out."""

import pytest
import torch

from kbench.harness import checks
from kbench.harness.runner import result_line
from kbench.tests.tiny import tiny_run


def _correct(run):
    return result_line(run)["correct"]


@pytest.mark.parametrize("cell", ["timit.fit", "cifar.fit"])
def test_sound_runs_are_correct(cell):
    assert _correct(tiny_run(cell))


@pytest.mark.parametrize("cell", ["timit.fit", "cifar.fit", "cifar.serve"])
def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch):
    from keystone_tpu_torch.parallel import linalg

    monkeypatch.setattr(linalg, "_bcd_block_update", lambda a_bs, ys, ps, w_b, *args, **kw: (w_b, ps))
    assert not _correct(tiny_run(cell))


@pytest.mark.parametrize("cell", ["timit.fit", "cifar.fit", "cifar.serve"])
def test_half_the_rows_left_out(cell, monkeypatch):
    """The solver sees the first half of the rows only: its Grams and
    right-hand sides are the mean over the rest."""
    from keystone_tpu_torch.parallel import linalg

    original = linalg._bcd_block_update

    def half(a_bs, ys, ps, w_b, *args, **kw):
        h = a_bs[0].shape[0] // 2
        w_new, ps_half = original([a[:h] for a in a_bs], [y[:h] for y in ys], [p[:h] for p in ps], w_b, *args, **kw)
        return w_new, [torch.cat([ph, p[h:]]) for ph, p in zip(ps_half, ps)]

    monkeypatch.setattr(linalg, "_bcd_block_update", half)
    assert not _correct(tiny_run(cell))


@pytest.mark.parametrize("cell", ["timit.fit", "cifar.fit", "cifar.serve"])
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    """The fitted linear map moves one score of the first row of every
    batch it answers."""
    from keystone_tpu_torch.ops.learning.block import BlockLinearMapper

    original = BlockLinearMapper.apply_arrays

    def altered(self, x):
        out = original(self, x).clone()
        out[0, 0] += 0.05 * (out.abs().mean() + 1.0)
        return out

    monkeypatch.setattr(BlockLinearMapper, "apply_arrays", altered)
    assert not _correct(tiny_run(cell))


def test_half_of_a_served_batch_left_out(monkeypatch):
    """The server answers only the first half of each batch: the rest never
    get an answer."""
    from keystone_tpu_torch.serving.server import PipelineServer

    original = PipelineServer._apply_padded

    def half(self, entry, payloads, deadline=None):
        rows = original(self, entry, payloads, deadline=deadline)
        return rows[: max(1, len(rows) // 2)] if len(rows) > 1 else rows

    from kbench.tests import tiny

    monkeypatch.setattr(PipelineServer, "_apply_padded", half)
    # Arrivals fast enough that batches hold more than one request.
    monkeypatch.setitem(tiny.TINY_SERVE, "rate_per_s", 1500)
    run = tiny_run("cifar.serve")
    assert run.readings["unanswered_requests"] > 0
    assert not checks.passed(checks.judge(run.readings, run.config["limits"]))
