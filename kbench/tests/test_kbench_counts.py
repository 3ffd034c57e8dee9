"""``kbench/counts/`` against counts worked by hand at the published
shapes of both configurations."""

import math

from kbench.harness.layout import Layout
from kbench.harness.peaks import card_peaks, gemm_counts, least_seconds


def _config(name):
    layout = Layout()
    return layout.module("counts", name), layout.load_json(layout.bench_dir / "configs" / f"{name}.json")


def test_timit_fit_flops_by_hand():
    counts, config = _config("timit_cosine")
    assert config["train_rows"] == 16384
    # features 2·16,384·440·204,800; Grams, their symmetric half,
    # 50·16,384·4,096·4,097; passes 5·50·(4·16,384·4,096·147 +
    # 2·4,096²·147); factors 50·4,096³/3.
    by_hand = 2_952_790_016_000 + 13_747_250_790_400 + 11_098_128_384_000 + 1_145_324_612_266.667
    assert math.isclose(counts.fit_flops(config), by_hand, rel_tol=1e-12)


def test_cifar_fit_flops_by_hand():
    counts, config = _config("cifar_random_patch")
    # whitener's Gram 100,000·108·109 + filters 4·10,000·108²;
    # convolution 2·50,000·729·108·10,000; 19 blocks of 4,096 features
    # and one of 272 filters · 8 = 2,176, each N·b·(b+1) (the Gram's
    # symmetric half) + b³/3 + 4·N·b·10 + 2·b²·10.
    learning = 1_177_200_000 + 466_560_000
    conv = 78_732_000_000_000
    block = lambda b: 50_000 * b * (b + 1) + b**3 / 3 + 4 * 50_000 * b * 10 + 2 * b * b * 10  # noqa: E731
    by_hand = learning + conv + 19 * block(4096) + block(2176)
    assert math.isclose(counts.fit_flops(config), by_hand, rel_tol=1e-12)
    assert math.isclose(by_hand, 95_517_875_590_186.66, rel_tol=1e-12)


def test_gemm_counts_and_least_time():
    flops, nbytes = gemm_counts(8192, 8192, 8192, 4)
    assert flops == 2 * 8192**3
    assert nbytes == 3 * 8192 * 8192 * 4
    peaks = card_peaks("NVIDIA H100 80GB HBM3")
    assert math.isclose(least_seconds(flops, nbytes, "ieee_fp32", peaks), flops / 67e12)
    # A product that reads far more than it computes is bound by bytes.
    flops, nbytes = gemm_counts(1_000_000, 1, 1000, 4)
    assert math.isclose(least_seconds(flops, nbytes, "ieee_fp32", peaks), nbytes / 3.35e12)
    assert gemm_counts(4, 5, 6, 4, batch=3, accumulate=True) == (2.0 * 4 * 5 * 6 * 3, float((24 + 30 + 40) * 4 * 3))
    assert card_peaks("NVIDIA A100-SXM4-80GB") is None


def test_a_gram_counts_its_symmetric_half():
    flops, nbytes = gemm_counts(4096, 4096, 16384, 4, gram=True)
    assert flops == 4096 * 4097 * 16384
    assert nbytes == (16384 * 4096 + 4096 * 4096) * 4
    assert gemm_counts(6, 6, 10, 4, batch=2, accumulate=True, gram=True) == (6 * 7 * 10 * 2.0, float((60 + 72) * 4 * 2))


def test_the_probe_marks_a_gram_by_its_operands():
    import torch

    from kbench.harness.devtrace import _same_matrix

    a = torch.zeros(8, 3)
    assert _same_matrix(a, a)
    assert _same_matrix(a.T.T, a)
    assert not _same_matrix(a, a.clone())
    assert not _same_matrix(a[:, :2], a[:, 1:])
    assert not _same_matrix(a.T, a)
