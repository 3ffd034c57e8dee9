"""CIFAR-10 workloads: LinearPixels, RandomCifar, RandomPatchCifar, the
kernel variant, the rematerializing ("fused") variant and the augmented
variants.

Port of ``keystone_tpu/pipelines/cifar.py`` (reference:
pipelines/images/cifar/{LinearPixels,RandomCifar,RandomPatchCifar,
RandomPatchCifarKernel,RandomPatchCifarAugmented}.scala). Pipeline
shapes, hyperparameters, seeds and the host numpy math of the filter
learning are the JAX package's, so both packages sample the same
patches and learn the same filters and whitener.

Every entry point takes ``device=`` (default ``None``: the CUDA device);
it is threaded to the loaders, the featurizer's filters and the
estimators.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..data.dataset import ArrayDataset
from ..data.loaders.cifar import load_cifar
from ..device import DeviceLike
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..obs import spans as _spans
from ..ops.images import (
    Convolver,
    FusedConvFeaturizer,
    GrayScaler,
    ImageVectorizer,
    Pooler,
    SymmetricRectifier,
    Windower,
)
from ..ops.learning.block import BlockLeastSquaresEstimator
from ..ops.learning.kernel import GaussianKernelGenerator, KernelRidgeRegression
from ..ops.learning.linear import LinearMapEstimator
from ..ops.learning.zca import ZCAWhitener, ZCAWhitenerEstimator
from ..ops.stats.core import Sampler, StandardScaler
from ..ops.util.labels import ClassLabelIndicators, MaxClassifier
from ..workflow.pipeline import Pipeline

logger = logging.getLogger(__name__)

NUM_CLASSES = 10
IMAGE_SIZE = 32
NUM_CHANNELS = 3


@dataclass
class RandomCifarConfig:
    """reference: RandomPatchCifar.scala:89-101 RandomCifarConfig."""

    train_location: str = ""
    test_location: str = ""
    num_filters: int = 100
    whitening_epsilon: float = 0.1
    patch_size: int = 6
    patch_steps: int = 1
    pool_size: int = 14
    pool_stride: int = 13
    alpha: float = 0.25
    reg: Optional[float] = None
    sample_frac: Optional[float] = None
    # kernel variant (reference: RandomPatchCifarKernel.scala):
    gamma: float = 2e-4
    kernel_block_size: int = 2048
    num_epochs: int = 1
    # augmented variants (reference: RandomPatchCifarAugmented.scala):
    num_random_images_augment: int = 10
    augment_img_size: int = 24
    flip_chance: float = 0.5
    seed: int = 12334
    # memory bound for the featurizer: filters per fused conv block.
    filter_block: int = 512


def _load(location: str, sample_frac: Optional[float], seed: int, device: DeviceLike) -> ArrayDataset:
    if not location:
        raise ValueError(
            "CIFAR workloads need --train-location pointing at a CIFAR-10 "
            "binary file (see examples/images/cifar_random_patch.sh)"
        )
    data = load_cifar(location, device=device)
    if sample_frac is not None:
        rng = np.random.default_rng(seed)
        keep = torch.from_numpy(rng.random(len(data)) < sample_frac).to(data.device)
        data = ArrayDataset({"image": data.data["image"][keep], "label": data.data["label"][keep]})
    return data


def normalize_rows(mat: np.ndarray, alpha: float = 1.0) -> np.ndarray:
    """Row mean/variance normalization (reference: utils/Stats.scala:112-124)."""
    means = np.nan_to_num(mat.mean(axis=1, keepdims=True))
    var = ((mat - means) ** 2).sum(axis=1, keepdims=True) / (mat.shape[1] - 1)
    sds = np.sqrt(var + alpha)
    sds[np.isnan(sds)] = np.sqrt(alpha)
    return (mat - means) / sds


def learn_random_patch_filters(
    train_images: ArrayDataset,
    config: RandomCifarConfig,
    whitener_size: int = 100000,
    device: DeviceLike = None,
) -> tuple[np.ndarray, ZCAWhitener]:
    """Sampled-patch filter bank + ZCA whitener
    (reference: RandomPatchCifar.scala:45-57): windows → vectorize →
    sample → row-normalize → fit ZCA → sample numFilters rows → whiten,
    L2-row-normalize, multiply by Wᵀ. Images are subsampled before
    windowing (all windows of all CIFAR images are ~36M patches, of which
    the sampler keeps 100,000), with the JAX package's seed. One
    ``build:featurizer`` span holds it all."""
    with _spans.span("build:featurizer", filters=config.num_filters):
        x_dim, y_dim = train_images.data.shape[1:3]
        per_image = (max(0, (x_dim - config.patch_size) // config.patch_steps) + 1) * (
            max(0, (y_dim - config.patch_size) // config.patch_steps) + 1
        )
        want_images = max(1, min(len(train_images), (2 * whitener_size) // per_image + 1))
        if want_images < len(train_images):
            idx = np.random.default_rng(config.seed).choice(
                len(train_images), size=want_images, replace=False
            )
            train_images = ArrayDataset(train_images.data[torch.from_numpy(idx).to(train_images.device)])

        patch_pipe = (
            Windower(config.patch_steps, config.patch_size)
            .to_pipeline()
            .then(ImageVectorizer())
            .then(Sampler(whitener_size, seed=config.seed))
        )
        base_filters = patch_pipe(train_images).get()
        base = base_filters.data[: base_filters.num_examples].cpu().numpy()
        base_mat = normalize_rows(base.astype(np.float64), 10.0)
        whitener = ZCAWhitenerEstimator(eps=config.whitening_epsilon, device=device).fit_single(
            base_mat.astype(np.float32)
        )
        rng = np.random.default_rng(config.seed)
        idx = rng.choice(base_mat.shape[0], size=min(config.num_filters, base_mat.shape[0]), replace=False)
        sample_filters = base_mat[idx]
        w = whitener.whitener.cpu().numpy().astype(np.float64)
        mu = whitener.means.cpu().numpy().astype(np.float64)
        unnorm = (sample_filters - mu) @ w
        two_norms = np.sqrt((unnorm**2).sum(axis=1, keepdims=True))
        filters = (unnorm / (two_norms + 1e-10)) @ w.T
        return filters.astype(np.float32), whitener


def _split(train: ArrayDataset):
    """(images, ±1 label indicators) of a labeled CIFAR dataset."""
    images = ArrayDataset(train.data["image"], train.num_examples)
    labels = ClassLabelIndicators(NUM_CLASSES)(ArrayDataset(train.data["label"], train.num_examples))
    return images, labels


def build_linear_pixels(train: ArrayDataset, device: DeviceLike = None) -> Pipeline:
    """reference: LinearPixels.scala:20-56."""
    images, labels = _split(train)
    return (
        GrayScaler().to_pipeline() >> ImageVectorizer()
    ).then_label_estimator(LinearMapEstimator(device=device), images, labels) >> MaxClassifier()


def build_random_patch(
    train: ArrayDataset,
    config: RandomCifarConfig,
    filters: Optional[np.ndarray] = None,
    whitener: Optional[ZCAWhitener] = None,
    solver: str = "block",
    with_classifier: bool = True,
    device: DeviceLike = None,
) -> Pipeline:
    """The conv → rectify → pool → solve pipeline shared by RandomCifar
    (random filters), RandomPatchCifar (learned filters, block solver),
    its rematerializing variant (``conv_block``) and RandomPatchCifarKernel
    (learned filters, kernel solver)."""
    images, labels = _split(train)
    if filters is None:  # RandomCifar: gaussian random filter matrix
        rng = np.random.default_rng(config.seed)
        filters = rng.normal(
            size=(config.num_filters, config.patch_size**2 * NUM_CHANNELS)
        ).astype(np.float32)

    fused = FusedConvFeaturizer(
        Convolver(filters, NUM_CHANNELS, whitener=whitener, normalize_patches=True, device=device),
        SymmetricRectifier(alpha=config.alpha),
        Pooler(config.pool_stride, config.pool_size, None, "sum"),
        filter_block=config.filter_block,
    )
    if solver == "conv_block":
        # featurize → standardize → BCD as one machine; the
        # (n, 8·numFilters) feature matrix never exists.
        from ..ops.learning.conv_block import ConvBlockLeastSquaresEstimator
        from ..workflow.pipeline import Identity

        fitted = Identity().to_pipeline().then_label_estimator(
            ConvBlockLeastSquaresEstimator(
                fused, block_size=None, num_iter=1, reg=config.reg or 0.0, device=device
            ),
            images,
            labels,
        )
        return fitted >> MaxClassifier() if with_classifier else fitted

    scaled = fused.to_pipeline().then_estimator(StandardScaler(), images)
    if solver == "block":
        est = BlockLeastSquaresEstimator(4096, num_iter=1, reg=config.reg or 0.0, device=device)
    elif solver == "kernel":
        est = KernelRidgeRegression(
            GaussianKernelGenerator(config.gamma, device=device),
            config.reg or 0.0,
            config.kernel_block_size,
            config.num_epochs,
            block_permuter=config.seed,
        )
    elif solver == "linear":
        est = LinearMapEstimator(config.reg, device=device)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    fitted = scaled.then_label_estimator(est, images, labels)
    return fitted >> MaxClassifier() if with_classifier else fitted


def run_augmented(config: RandomCifarConfig, solver: str = "block", device: DeviceLike = None) -> dict:
    """Augmented random-patch workload (reference:
    RandomPatchCifarAugmented.scala:33-105,
    RandomPatchCifarAugmentedKernel.scala): train on random
    ``augment_img_size`` crops with coin-flip horizontal flips and
    replicated labels; test on 10 deterministic views per image (center
    + four corners, each flipped) scored by the augmented-examples
    evaluator grouped per source image."""
    from ..evaluation.augmented import AugmentedExamplesEvaluator
    from ..ops.images import CenterCornerPatcher, RandomImageTransformer, RandomPatcher
    from ..utils.image import flip_horizontal

    start = time.time()
    train = _load(config.train_location, config.sample_frac, config.seed, device)
    train_images = ArrayDataset(train.data["image"], train.num_examples)
    filters, whitener = learn_random_patch_filters(train_images, config, device=device)

    size = config.augment_img_size
    mult = config.num_random_images_augment
    augmented_images = RandomImageTransformer(
        config.flip_chance, flip_horizontal, seed=config.seed
    ).apply_batch(RandomPatcher(mult, size, size, seed=config.seed).apply_batch(train_images))
    labels = train.data["label"][: train.num_examples].repeat_interleave(mult)
    augmented_train = ArrayDataset(
        {"image": augmented_images.data, "label": labels}, len(augmented_images)
    )
    pipeline = build_random_patch(
        augmented_train, config, filters, whitener, solver=solver,
        with_classifier=False,  # the augmented evaluator needs raw scores
        device=device,
    )

    results = {"pipeline": pipeline, "num_augmented_train": len(augmented_images)}
    if config.test_location:
        test = load_cifar(config.test_location, device=device)
        test_images = ArrayDataset(test.data["image"], test.num_examples)
        test_views = CenterCornerPatcher(size, size, horizontal_flips=True).apply_batch(test_images)
        num_views = 10  # center + 4 corners, each with a flip
        n_test = test.num_examples
        ids = np.repeat(np.arange(n_test), num_views)
        view_labels = test.data["label"][:n_test].repeat_interleave(num_views)
        scores = pipeline(test_views).get()
        test_eval = AugmentedExamplesEvaluator(ids, NUM_CLASSES).evaluate(scores, view_labels)
        logger.info("Test error is: %s", test_eval.total_error)
        results["test_error"] = test_eval.total_error
    results["seconds"] = time.time() - start
    return results


_PATCH_SOLVERS = {
    "random_patch": "block",
    "random_patch_fused": "conv_block",
    "random_patch_kernel": "kernel",
}


def run(config: RandomCifarConfig, variant: str = "random_patch", device: DeviceLike = None) -> dict:
    """Run a CIFAR workload end to end; returns train/test error."""
    if variant in ("random_patch_augmented", "random_patch_kernel_augmented"):
        return run_augmented(
            config, solver="kernel" if "kernel" in variant else "block", device=device
        )

    start = time.time()
    train = _load(config.train_location, config.sample_frac, config.seed, device)
    train_images = ArrayDataset(train.data["image"], train.num_examples)

    if variant == "linear_pixels":
        pipeline = build_linear_pixels(train, device=device)
    elif variant == "random":
        pipeline = build_random_patch(train, config, solver="linear", device=device)
    elif variant in _PATCH_SOLVERS:
        filters, whitener = learn_random_patch_filters(train_images, config, device=device)
        pipeline = build_random_patch(
            train, config, filters, whitener, solver=_PATCH_SOLVERS[variant], device=device
        )
    else:
        raise ValueError(f"unknown variant {variant!r}")

    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_eval = evaluator.evaluate(pipeline(train_images), train.data["label"])
    logger.info("Training error is: %s", train_eval.total_error)
    results = {"train_error": train_eval.total_error, "pipeline": pipeline}

    if config.test_location:
        test = load_cifar(config.test_location, device=device)
        test_images = ArrayDataset(test.data["image"], test.num_examples)
        test_eval = evaluator.evaluate(pipeline(test_images), test.data["label"])
        logger.info("Test error is: %s", test_eval.total_error)
        results["test_error"] = test_eval.total_error
    results["seconds"] = time.time() - start
    return results
