"""Image featurization operators (port of ``keystone_tpu.ops.images``;
reference: nodes/images/)."""

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
from .lcs import LCSExtractor
from .native import ConcatBuckets, MaskedExtractor
from .sift import SIFTExtractor

__all__ = [
    "ConcatBuckets",
    "DaisyExtractor",
    "FisherVector",
    "GMMFisherVectorEstimator",
    "HogExtractor",
    "LCSExtractor",
    "MaskedExtractor",
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
