"""Text dataset loaders: Amazon reviews (JSON) and 20 Newsgroups.

A copy of ``keystone_tpu/data/loaders/text.py``: host-side loaders into
``ObjectDataset`` s of strings and int labels. Reference: loaders/AmazonReviewsDataLoader.scala:7-28 (Spark-SQL JSON with
``reviewText``/``overall`` fields, label = overall ≥ threshold) and
loaders/NewsgroupsDataLoader.scala:268-318 (one directory per class label,
one plaintext file per document).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

from ..dataset import ObjectDataset


@dataclass
class TextLabeledData:
    """Host-side labeled text collection (analog of loaders/LabeledData.scala)."""

    labels: ObjectDataset
    data: ObjectDataset


def load_amazon_reviews(path: str, threshold: float = 3.5) -> TextLabeledData:
    """JSON-lines reviews → (label ∈ {0,1}, review text)."""
    texts: List[str] = []
    labels: List[int] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            texts.append(rec.get("reviewText", ""))
            labels.append(1 if float(rec.get("overall", 0.0)) >= threshold else 0)
    return TextLabeledData(ObjectDataset(labels), ObjectDataset(texts))


NEWSGROUPS_CLASSES = [
    "comp.graphics",
    "comp.os.ms-windows.misc",
    "comp.sys.ibm.pc.hardware",
    "comp.sys.mac.hardware",
    "comp.windows.x",
    "rec.autos",
    "rec.motorcycles",
    "rec.sport.baseball",
    "rec.sport.hockey",
    "sci.crypt",
    "sci.electronics",
    "sci.med",
    "sci.space",
    "misc.forsale",
    "talk.politics.misc",
    "talk.politics.guns",
    "talk.politics.mideast",
    "talk.religion.misc",
    "alt.atheism",
    "soc.religion.christian",
]


def load_newsgroups(data_dir: str) -> TextLabeledData:
    """``data_dir/<class_name>/<doc files>`` → labeled documents; class ids
    follow NEWSGROUPS_CLASSES order (reference: NewsgroupsDataLoader.scala)."""
    texts: List[str] = []
    labels: List[int] = []
    for label, cls in enumerate(NEWSGROUPS_CLASSES):
        cls_dir = os.path.join(data_dir, cls)
        if not os.path.isdir(cls_dir):
            continue
        for name in sorted(os.listdir(cls_dir)):
            fp = os.path.join(cls_dir, name)
            if os.path.isfile(fp):
                with open(fp, errors="replace") as f:
                    texts.append(f.read())
                labels.append(label)
    return TextLabeledData(ObjectDataset(labels), ObjectDataset(texts))


__all__ = ["NEWSGROUPS_CLASSES", "TextLabeledData", "load_amazon_reviews", "load_newsgroups"]
