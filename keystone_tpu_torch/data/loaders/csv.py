"""CSV loading (reference: loaders/CsvDataLoader.scala:90-120,
loaders/LabeledData.scala:256-266).

Port of ``keystone_tpu/data/loaders/csv.py``: rows of comma-separated
numbers become one (n, d) tensor on ``device`` (default CUDA).
"""

from __future__ import annotations

import glob
import os
from collections import Counter
from dataclasses import dataclass
import numpy as np

from ...device import DeviceLike
from ...reliability.recovery import QuarantineCounts
from ..dataset import ArrayDataset


def load_csv(path: str, dtype=np.float32, device: DeviceLike = None) -> ArrayDataset:
    """Load one CSV file, a directory of them, or a glob pattern.

    Malformed rows (unparsable fields, wrong column count) are
    skipped-and-quarantined instead of aborting the load: the fast
    ``np.loadtxt`` path runs first, and only a file that trips it is
    re-parsed line-by-line. The returned dataset carries a ``.quarantine``
    dict with counts, and totals land in the process recovery log. A file
    with NO parsable rows still raises — an entirely-garbage input is a
    wrong-path error, not a degraded read.
    """
    files = _expand(path)
    quarantine = QuarantineCounts()
    parts = [_load_one(f, dtype, quarantine) for f in files]
    quarantine.publish("load_csv", source=path)
    out = ArrayDataset(np.concatenate(parts, axis=0), device=device)
    out.quarantine = quarantine.as_dict()
    return out


def _load_one(path: str, dtype, quarantine: QuarantineCounts) -> np.ndarray:
    try:
        return np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=2)
    except ValueError:
        return _tolerant_parse(path, dtype, quarantine)


def _tolerant_parse(path: str, dtype, quarantine: QuarantineCounts) -> np.ndarray:
    """Line-by-line fallback parse. The row width is the MAJORITY width of
    the parsable rows (a truncated first row must not redefine the file's
    shape and quarantine everything after it); rows that disagree — and
    rows with unparsable fields — are quarantined."""
    parsed = []  # (lineno, row)
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            # Skip what np.loadtxt skips (blank lines, '#' comments —
            # including inline ones): the fallback must not quarantine
            # lines the fast path accepts.
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            try:
                parsed.append((lineno, [dtype(v) for v in line.split(",")]))
            except ValueError:
                quarantine.add("unparsable_row", f"{path}:{lineno}")
    if not parsed:
        raise ValueError(f"{path}: no parsable CSV rows ({quarantine.total} malformed)")
    width = Counter(len(row) for _, row in parsed).most_common(1)[0][0]
    rows = []
    for lineno, row in parsed:
        if len(row) == width:
            rows.append(row)
        else:
            quarantine.add("wrong_width", f"{path}:{lineno}")
    return np.asarray(rows, dtype=dtype)


def _expand(path: str):
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*")))
    else:
        matches = sorted(glob.glob(path))
        files = matches if matches else [path]
    if not files:
        raise FileNotFoundError(path)
    return files


@dataclass
class LabeledData:
    """(labels, features) pair of aligned datasets
    (reference: loaders/LabeledData.scala)."""

    labels: ArrayDataset
    data: ArrayDataset


def load_labeled_csv(
    path: str, label_col: int = 0, label_offset: int = 0, device: DeviceLike = None
) -> LabeledData:
    """CSV where one column is an integer label (reference MNIST format is
    1-indexed label first; pass label_offset=-1 to 0-index)."""
    raw = load_csv(path, device="cpu")
    arr = raw.data.numpy()
    labels = arr[:, label_col].astype(np.int32) + label_offset
    features = np.delete(arr, label_col, axis=1)
    return LabeledData(ArrayDataset(labels, device=device), ArrayDataset(features, device=device))
