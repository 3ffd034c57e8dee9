"""Image featurization operators (port of ``keystone_tpu.ops.images``;
reference: nodes/images/).

Left out for now: ``LCSExtractor`` (ROADMAP item 10d).
"""

from .core import (
    CenterCornerPatcher,
    Convolver,
    Cropper,
    FusedConvFeaturizer,
    GrayScaler,
    ImageExtractor,
    ImageVectorizer,
    LabelExtractor,
    MultiLabelExtractor,
    MultiLabeledImageExtractor,
    PixelScaler,
    Pooler,
    RandomImageTransformer,
    RandomPatcher,
    SymmetricRectifier,
    Windower,
    pack_filters,
)
from .daisy import DaisyExtractor
from .fisher import FisherVector, GMMFisherVectorEstimator
from .hog import HogExtractor
from .sift import SIFTExtractor

__all__ = [
    "DaisyExtractor",
    "FisherVector",
    "GMMFisherVectorEstimator",
    "HogExtractor",
    "SIFTExtractor",
    "CenterCornerPatcher",
    "Convolver",
    "Cropper",
    "FusedConvFeaturizer",
    "GrayScaler",
    "ImageExtractor",
    "ImageVectorizer",
    "LabelExtractor",
    "MultiLabelExtractor",
    "MultiLabeledImageExtractor",
    "PixelScaler",
    "Pooler",
    "RandomImageTransformer",
    "RandomPatcher",
    "SymmetricRectifier",
    "Windower",
    "pack_filters",
]
