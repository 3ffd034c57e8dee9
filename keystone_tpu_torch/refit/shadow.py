"""Shadow evaluation: score a refit candidate against the incumbent
before anything publishes.

Port of ``keystone_tpu/refit/shadow.py``: models apply on their own
device (the device of their tensors), and scoring runs on the host.

Two signals, both computed WITHOUT touching the serve path:

- **Held-out score** — candidate and incumbent each applied to the
  freshest labeled rows the tap drained (rows the candidate did NOT
  train on this round), scored with the ``evaluation/`` suite:
  :class:`~keystone_tpu.evaluation.MulticlassClassifierEvaluator`
  accuracy when labels are classes (1-D ints or one-hot rows), negative
  mean-squared-error otherwise. Higher is always better.
- **Live mirror divergence** — candidate vs incumbent predictions on
  payloads sampled off real served traffic (the tap's mirror buffer):
  no labels needed, and a candidate that disagrees wildly with the
  incumbent on live inputs is flagged even when the held-out slice
  looks fine (distribution shift between the labeled feed and live
  traffic is exactly when that happens).

The gate: a candidate passes when its held-out score is at least the
incumbent's minus ``margin`` (drift means "no worse" is already a win —
the incumbent decays) AND the mirror divergence stays under
``max_mirror_divergence`` when a mirror set exists.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..obs import names as _names


def _predict(model: Any, x: np.ndarray) -> np.ndarray:
    """Host predictions of a fitted model on a host matrix, via whatever
    apply door the model has (the ModelEntry.batch_apply normalization,
    minus the registry), on the model's own device."""
    from ..data.dataset import ArrayDataset
    from ..workflow.verify import _model_device

    device = _model_device(model)
    if device is None:
        raise ValueError(f"cannot tell which device {type(model).__name__} applies on")
    dataset = ArrayDataset(np.asarray(x, np.float32), device=device)
    apply_batch = getattr(model, "apply_batch", None)
    if apply_batch is not None:
        out = apply_batch(dataset)
    else:
        out = model.batch_transform([dataset])
    data = getattr(out, "data", out)
    # Scoring is host-side by definition (the evaluator is numpy).
    if isinstance(data, torch.Tensor):
        data = data.cpu().numpy()
    return np.asarray(data)[: x.shape[0]]


def _as_classes(y: np.ndarray) -> Optional[np.ndarray]:
    """Labels as int classes when they are classes: 1-D integer-valued,
    or one-hot rows. None for genuine regression targets."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    if y.ndim == 1:
        if y.size and np.allclose(y, np.round(y)) and y.min() >= 0:
            return y.astype(np.int64)
        return None
    if y.ndim == 2 and y.shape[1] > 1:
        rows = y.sum(axis=1)
        if np.allclose(rows, 1.0) and np.allclose(y.max(axis=1), 1.0):
            return y.argmax(axis=1).astype(np.int64)
    return None


@dataclass
class ShadowReport:
    """One shadow comparison — what the ledger and metrics record."""

    candidate_score: float
    incumbent_score: float
    margin: float
    passed: bool
    metric: str = "accuracy"
    mirror_divergence: Optional[float] = None
    eval_rows: int = 0
    details: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        out = {
            "candidate_score": round(self.candidate_score, 6),
            "incumbent_score": round(self.incumbent_score, 6),
            "margin": self.margin,
            "passed": self.passed,
            "metric": self.metric,
            "eval_rows": self.eval_rows,
        }
        if self.mirror_divergence is not None:
            out["mirror_divergence"] = round(self.mirror_divergence, 6)
        return out


class ShadowEvaluator:
    """Score candidate vs incumbent on held-out labels + live mirror."""

    def __init__(
        self,
        margin: float = 0.0,
        max_mirror_divergence: Optional[float] = None,
        score_fn: Optional[Any] = None,
    ):
        #: candidate passes when score >= incumbent score - margin.
        self.margin = float(margin)
        #: mean relative prediction divergence on mirrored live traffic
        #: above this fails the candidate (None = mirror is advisory).
        self.max_mirror_divergence = max_mirror_divergence
        #: optional override: ``score_fn(predictions, labels) -> float``
        #: (higher better) replaces the built-in evaluation-suite scoring.
        self.score_fn = score_fn
        self._m_score = _names.metric(_names.REFIT_SCORE)

    # ----------------------------------------------------------------- scoring
    def score(self, model: Any, x: np.ndarray, y: np.ndarray) -> float:
        """One model's score on labeled rows — higher is better."""
        return self.score_predictions(_predict(model, x), y)

    def score_predictions(self, pred: np.ndarray, y: np.ndarray) -> float:
        """Score already-computed predictions (the watch window scores
        the LIVE serve path's outputs, not a model object)."""
        if self.score_fn is not None:
            return float(self.score_fn(pred, y))
        classes = _as_classes(y)
        if classes is not None:
            from ..evaluation import MulticlassClassifierEvaluator

            k = int(max(int(classes.max()) + 1, pred.shape[-1] if pred.ndim > 1 else 1))
            pred_classes = (
                pred.argmax(axis=1) if pred.ndim > 1 and pred.shape[1] > 1
                else np.round(pred).astype(np.int64).ravel().clip(0, k - 1)
            )
            return MulticlassClassifierEvaluator(k).evaluate(
                pred_classes, classes
            ).total_accuracy
        err = np.asarray(pred, np.float64) - np.asarray(y, np.float64)
        return -float(np.mean(err * err))  # negative MSE: higher is better

    def score_rows(
        self, pred: np.ndarray, y: np.ndarray
    ) -> Optional[np.ndarray]:
        """Per-row scores of already-computed predictions, higher better:
        0/1 correctness when labels are classes, negative squared error
        otherwise. The sequential watch gate and the quality plane's
        label-join stream consume these (a sample mean over them equals
        :meth:`score_predictions` for both metrics). ``None`` when a
        custom aggregate ``score_fn`` owns scoring — callers fall back
        to the aggregate margin rule then."""
        if self.score_fn is not None:
            return None
        pred = np.asarray(pred)
        classes = _as_classes(y)
        if classes is not None:
            k = int(max(
                int(classes.max()) + 1,
                pred.shape[-1] if pred.ndim > 1 else 1,
            ))
            pred_classes = (
                pred.argmax(axis=1) if pred.ndim > 1 and pred.shape[1] > 1
                else np.round(pred).astype(np.int64).ravel().clip(0, k - 1)
            )
            return (pred_classes == classes).astype(np.float64)
        err = np.asarray(pred, np.float64) - np.asarray(y, np.float64)
        if err.ndim > 1:
            return -np.mean(err * err, axis=tuple(range(1, err.ndim)))
        return -(err * err)

    def mirror_divergence(
        self, candidate: Any, incumbent: Any, mirror_x: np.ndarray
    ) -> float:
        """Mean relative L2 disagreement between candidate and incumbent
        predictions on live mirrored payloads."""
        a = np.asarray(_predict(candidate, mirror_x), np.float64)
        b = np.asarray(_predict(incumbent, mirror_x), np.float64)
        denom = max(float(np.linalg.norm(b)), 1e-12)
        return float(np.linalg.norm(a - b)) / denom

    # ----------------------------------------------------------------- verdict
    def compare(
        self,
        candidate: Any,
        incumbent: Any,
        eval_x: np.ndarray,
        eval_y: np.ndarray,
        mirror_x: Optional[np.ndarray] = None,
    ) -> ShadowReport:
        cand = self.score(candidate, eval_x, eval_y)
        inc = self.score(incumbent, eval_x, eval_y)
        metric = (
            "custom" if self.score_fn is not None
            else ("accuracy" if _as_classes(eval_y) is not None else "neg_mse")
        )
        divergence = None
        if mirror_x is not None and len(mirror_x):
            try:
                divergence = self.mirror_divergence(
                    candidate, incumbent, mirror_x
                )
            except Exception:
                divergence = None  # mirror is advisory; labels decide
        passed = cand >= inc - self.margin
        if (
            passed
            and divergence is not None
            and self.max_mirror_divergence is not None
            and divergence > self.max_mirror_divergence
        ):
            passed = False
        self._m_score.set(cand, role="candidate")
        self._m_score.set(inc, role="incumbent")
        return ShadowReport(
            candidate_score=cand,
            incumbent_score=inc,
            margin=self.margin,
            passed=passed,
            metric=metric,
            mirror_divergence=divergence,
            eval_rows=int(len(eval_x)),
        )
