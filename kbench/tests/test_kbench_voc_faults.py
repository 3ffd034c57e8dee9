"""The check of the ``voc.fit`` cell with the timed path broken underneath,
at a tiny size on the CPU: a sound run is correct, and each fault its
pipeline can have makes ``correct`` false — one Gaussian's Fisher
statistics dropped, one SIFT scale left out, half of the images left out
of the solver. One card runs the cell, so there is no exchange between
cards to leave out.

The layout is the benchmark's own with the configuration cut to 24
images of 64×64, 8 PCA dimensions, 4 Gaussians, 2,000 samples and
64-wide blocks (the cell's limits unchanged)."""

import copy

import torch

from kbench.harness.layout import Layout
from kbench.harness.runner import result_line
from kbench.tests.tiny import tiny_run

TINY = dict(train_rows=24, image_shape=[64, 64, 3], desc_dim=8, vocab_size=4, num_pca_samples=2000,
            num_gmm_samples=2000, block_size=64, check={"train_rows": 8, "heldout_rows": 8})
CELL = "voc.fit"


class VocTinyLayout(Layout):
    """The benchmark's layout with ``voc_sift_fisher`` cut as above."""

    def cell(self, name):
        cell = super().cell(name)
        if cell.config["name"] == "voc_sift_fisher":
            cell.config = copy.deepcopy(cell.config)
            cell.config.update(copy.deepcopy(TINY))
        return cell


def _run():
    return tiny_run(CELL, layout=VocTinyLayout())


def _correct(run):
    return result_line(run)["correct"]


def test_a_sound_run_is_correct():
    run = _run()
    assert run.attempted >= 1 and run.failed == 0
    assert _correct(run), run.readings


def test_one_gaussians_fisher_statistics_dropped(monkeypatch):
    from keystone_tpu_torch.ops.images.fisher import FisherVector

    original = FisherVector.apply_arrays

    def dropped(self, x):
        out = original(self, x).clone()
        out[:, :, 0] = 0.0
        out[:, :, self.gmm.k] = 0.0
        return out

    monkeypatch.setattr(FisherVector, "apply_arrays", dropped)
    assert not _correct(_run())


def test_one_sift_scale_left_out(monkeypatch):
    from keystone_tpu_torch.ops.images.sift import SIFTExtractor

    original = SIFTExtractor.grid_counts
    monkeypatch.setattr(SIFTExtractor, "grid_counts", lambda self, x, y: original(self, x, y)[:-1] + [0])
    assert not _correct(_run())


def test_half_the_images_left_out_of_the_solver(monkeypatch):
    """The solver sees the first half of the images only: its Grams and
    right-hand sides are the mean over the rest."""
    from keystone_tpu_torch.parallel import linalg

    original = linalg._bcd_block_update

    def half(a_bs, ys, ps, w_b, *args, **kw):
        h = a_bs[0].shape[0] // 2
        w_new, ps_half = original([a[:h] for a in a_bs], [y[:h] for y in ys], [p[:h] for p in ps], w_b, *args, **kw)
        return w_new, [torch.cat([ph, p[h:]]) for ph, p in zip(ps_half, ps)]

    monkeypatch.setattr(linalg, "_bcd_block_update", half)
    assert not _correct(_run())
