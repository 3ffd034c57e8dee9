"""``kbench/counts/voc_sift_fisher.py`` against the operations of one VOC
fit worked by hand at the configuration's published widths."""

import math

from kbench.harness.layout import Layout


def _config():
    layout = Layout()
    return layout.module("counts", "voc_sift_fisher"), layout.load_json(
        layout.bench_dir / "configs" / "voc_sift_fisher.json")


def test_descriptors_and_features_at_published_widths():
    counts, config = _config()
    # 79² + 78² + 77² + 76² grid positions at 256×256, step 3, offsets 9,
    # 6, 3, 0 and bins 4, 6, 8, 10.
    assert counts.descriptors_per_image(config) == 6241 + 6084 + 5929 + 5776 == 24030
    assert 2 * config["desc_dim"] * config["vocab_size"] == config["num_features"] == 40960


def test_voc_fit_flops_by_hand():
    counts, config = _config()
    assert counts.EM_ITERATIONS == 30 and config["gmm"]["lloyd_iterations"] == 1
    # SIFT a 256×256 image: Gaussian taps 7, 9, 13, 15 (σ = b/6, ±⌈4σ⌉)
    # twice over 65,536 pixels, triangle taps 7, 11, 15, 19 twice over 8
    # planes of 65,536 pixels; 2 FLOP a multiply-add; 2,048 images.
    smoothing = 2 * 2 * 65536 * (7 + 9 + 13 + 15)
    binning = 2 * 2 * 8 * 65536 * (7 + 11 + 15 + 19)
    assert smoothing + binning == 120_586_240
    sift = 2048 * 120_586_240
    # PCA: 488 samples of each of 2,048 images (999,424), the Gram's half
    # 999,424·128·129, the projection 2·2,048·24,030·128·80.
    pca = 999_424 * 128 * 129 + 2 * 2048 * 24030 * 128 * 80
    # k-means++: 256 passes of 2·999,424·80; Lloyd 4·G·d·k once; moments
    # 6·G·d·k; EM 30 E-steps and 29 M-steps of 4·G·d·k each.
    gdk = 999_424 * 80 * 256
    mixture = 256 * 2 * 999_424 * 80 + 4 * gdk + 6 * gdk + (30 + 29) * 4 * gdk
    # Fisher: 8·c·d·k an image.
    fisher = 8 * 2048 * 24030 * 80 * 256
    # Ten 4,096-wide blocks, one pass, 20 classes.
    block = 2048 * 4096 * 4097 + 4096**3 / 3 + 4 * 2048 * 4096 * 20 + 2 * 4096 * 4096 * 20
    by_hand = sift + pca + mixture + fisher + 10 * block
    assert math.isclose(counts.fit_flops(config), by_hand, rel_tol=1e-12)
    assert math.isclose(by_hand, 14_996_766_807_381.334, rel_tol=1e-12)
