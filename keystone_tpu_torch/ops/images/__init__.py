"""Image featurization operators (port of ``keystone_tpu.ops.images``;
reference: nodes/images/).

Left out for now: ``DaisyExtractor``, ``FisherVector``,
``GMMFisherVectorEstimator``, ``HogExtractor``, ``LCSExtractor`` and
``SIFTExtractor`` (the ImageNet/VOC slice).
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

__all__ = [
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
