"""Pre-featurized TIMIT speech data loading
(reference: loaders/TimitFeaturesDataLoader.scala:326-390).

Port of ``keystone_tpu/data/loaders/timit.py``. Features are CSVs of
440-dim rows; labels are sparse "row# label" text files with 1-indexed
rows and 1-indexed labels (147 phone classes). The loader aligns labels
to feature rows by row number and returns (labels, features) pairs for
train and test on ``device`` (default CUDA).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from ...device import DeviceLike
from ..dataset import ArrayDataset
from .csv import LabeledData, load_csv

TIMIT_DIMENSION = 440
NUM_CLASSES = 147


@dataclass
class TimitFeaturesData:
    train: LabeledData
    test: LabeledData


def _parse_sparse_labels(path: str) -> Dict[int, int]:
    """'row label' lines, 1-indexed rows (reference:
    TimitFeaturesDataLoader.parseSparseLabels)."""
    out: Dict[int, int] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row, label = line.split(" ")[:2]
            out[int(row) - 1] = int(label)
    return out


def _labels_for(
    features: ArrayDataset, labels_map: Dict[int, int], device: DeviceLike = None
) -> ArrayDataset:
    n = len(features)
    labels = np.empty(n, dtype=np.int32)
    for i in range(n):
        labels[i] = labels_map[i] - 1  # 1-indexed labels → 0-indexed
    return ArrayDataset(labels, device=device)


def load_timit(
    train_data_location: str,
    train_labels_location: str,
    test_data_location: str,
    test_labels_location: str,
    device: DeviceLike = None,
) -> TimitFeaturesData:
    train_data = load_csv(train_data_location, device=device)
    train_labels = _labels_for(train_data, _parse_sparse_labels(train_labels_location), device)
    test_data = load_csv(test_data_location, device=device)
    test_labels = _labels_for(test_data, _parse_sparse_labels(test_labels_location), device)
    return TimitFeaturesData(
        train=LabeledData(train_labels, train_data),
        test=LabeledData(test_labels, test_data),
    )
