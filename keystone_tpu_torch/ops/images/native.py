"""Native-resolution (masked) extraction as pipeline operators.

Port of ``keystone_tpu/ops/images/native.py``. The reference featurizes
every image at its own size (reference: src/main/cpp/VLFeat.cxx:170-186
takes per-call (w, h); nodes/images/external/SIFTExtractor.scala:27-33
maps it per image). Here images are grouped into padded static-shape
buckets (``data/buckets.py``) and the masked extractors run once per
bucket; this module wraps that as a ``Transformer`` so the whole
native-resolution flow runs inside the Pipeline API — visible to the
optimizer and prefix reuse — instead of a host loop beside it.

Dataflow: input buckets carry ``{"image": (N, Xb, Yb, C), "dims": (N, 2)}``;
extractor output carries ``{"desc": (N, n_pad, d), "valid": (N, n_pad)}``.
``FisherVector`` consumes the mask and returns dense rows, after which
buckets concatenate into one (N, fv_dim) dataset for the solver.

The JAX package compiles one computation per bucket shape and keeps the
compiled function out of pickling; here a bucket runs eagerly on the
data's device, so the operator holds nothing but its extractor and its
``pre`` / ``post`` maps, and a ``FittedPipeline`` that holds one saves
and loads with ``torch.save`` (the maps must be picklable: functions or
bound methods of operators, not lambdas).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...data.dataset import ArrayDataset, BucketedDataset, Dataset
from ...workflow.pipeline import Transformer


class MaskedExtractor(Transformer):
    """Run an extractor's ``apply_arrays_masked`` over size buckets.

    ``pre`` optionally maps the padded image batch before extraction
    (e.g. PixelScaler→GrayScaler for SIFT); ``post`` maps the descriptor
    array after (e.g. SignedHellinger), preserving validity.
    """

    def __init__(
        self,
        extractor,
        pre: Optional[Callable] = None,
        post: Optional[Callable] = None,
    ):
        self.extractor = extractor
        self.pre = pre
        self.post = post

    def apply(self, datum):
        images = torch.as_tensor(datum["image"])[None]
        dims = torch.as_tensor(datum["dims"], device=images.device)[None]
        out = self._apply_bucket_arrays(images, dims)
        return {"desc": out["desc"][0], "valid": out["valid"][0]}

    def _apply_bucket_arrays(self, images: torch.Tensor, dims: torch.Tensor) -> dict:
        x = images.to(torch.float32)
        if self.pre is not None:
            x = self.pre(x)
        desc, valid = self.extractor.apply_arrays_masked(x, dims)
        if self.post is not None:
            desc = self.post(desc)
        return {"desc": desc, "valid": valid}

    def apply_batch(self, dataset: Dataset) -> Dataset:
        if isinstance(dataset, BucketedDataset):
            return dataset.map_datasets(self.apply_batch)
        if not (isinstance(dataset, ArrayDataset) and isinstance(dataset.data, dict)):
            raise TypeError(
                "MaskedExtractor needs {'image', 'dims'} bucket data "
                "(see data.buckets.to_bucketed_dataset)"
            )
        n = dataset.num_examples
        out = self._apply_bucket_arrays(dataset.data["image"][:n], dataset.data["dims"][:n])
        return ArrayDataset(out, n)


class ConcatBuckets(Transformer):
    """Collapse a BucketedDataset into one dense ArrayDataset (bucket-major
    row order) — the boundary op before solvers and evaluators once the
    buckets' trailing shapes agree (after FisherVector)."""

    def apply(self, datum):
        return datum

    def apply_batch(self, dataset: Dataset) -> Dataset:
        if isinstance(dataset, BucketedDataset):
            return dataset.concat()
        return dataset
