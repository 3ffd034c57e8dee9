"""The live model-quality plane.

A copy of ``keystone_tpu/obs/quality.py`` (stdlib only). In the port
the refit daemon feeds it: the watch window's label join, the drift
detector behind adaptive decay, and the sequential watch gate; the
serving supervisor merges its workers' sketch deltas fleet-wide.

The rest of obs/ measures *performance* — spans, fleet traces, the cost
observatory. This module measures *model quality on live traffic* and
turns it into decisions with controlled error rates:

- :class:`ScoreStream` — bounded-memory online accumulators over
  prediction scores: count/mean/M2 (Welford) plus P² quantile markers.
  O(1) state per stream, serializable, so the daemon's label-joined
  accuracy stream rides the refit journal and survives restarts.
- :class:`ChannelSketch` / :class:`PayloadSketch` — MERGEABLE moment +
  quantile sketches over serving payload features and scores. Workers
  accumulate a delta sketch between heartbeats and ship it exactly like
  metric fragments; the supervisor merges deltas fleet-wide.
  Moment merges are exact (Chan's parallel update); quantile merges are
  bounded-error (Ben-Haim/Tom-Tov streaming histogram).
- :class:`SequentialGate` — an anytime-valid sequential test comparing
  two score streams (candidate vs production, or current vs baseline
  window) built on empirical-Bernstein confidence sequences. It emits
  ``promote`` / ``rollback`` / ``continue`` with a configured
  false-positive bound ``alpha``: the radii hold simultaneously over all
  sample sizes (union bound over n), so peeking every sample is sound —
  this is the statistical gate the canary item needs, and it upgrades
  the refit daemon's fixed watch window.
- :class:`DriftDetector` — standardized-shift detector over the stream
  and sketch moments that drives ``refit.state_decay`` adaptively: a
  quiet tenant keeps full history, a drifting tenant forgets faster.
- :class:`QualityPlane` — the per-model registry tying it together,
  publishing the ``keystone_quality_*`` metric family and feeding the
  flight recorder's ``quality`` ring.

Everything here is stdlib-only and cheap on the request path: one
Welford update plus a handful of histogram inserts per sampled payload.
The serving-overhead budget (≤5%, asserted by scripts/quality_smoke.sh)
is the contract.

Environment knobs (read at call time via envknobs):

- ``KEYSTONE_QUALITY`` — tri-state; ``off``/``0``/``disabled``
  disables all observation (the overhead-budget A/B switch).
- ``KEYSTONE_QUALITY_ALPHA`` — sequential-gate false-positive bound
  (default 0.05).
- ``KEYSTONE_QUALITY_MIN_SAMPLES`` / ``KEYSTONE_QUALITY_MAX_SAMPLES``
  — gate decision window (defaults 24 / 512).
- ``KEYSTONE_QUALITY_MAX_FEATURES`` — payload coordinates sketched per
  model (default 8).
- ``KEYSTONE_QUALITY_SKETCH_BINS`` — histogram bins per channel
  (default 64).
- ``KEYSTONE_QUALITY_SAMPLE`` — 1-in-N payload sampling (default 1).
- ``KEYSTONE_QUALITY_DRIFT_THRESHOLD`` — standardized-shift threshold
  (default 0.5 baseline standard deviations).
- ``KEYSTONE_QUALITY_DRIFT_MIN_COUNT`` — samples before the detector
  may fire (default 64).
- ``KEYSTONE_QUALITY_DECAY_FLOOR`` — lowest adaptive ``state_decay``
  the detector will suggest (default 0.5).
"""

from __future__ import annotations

import bisect
import json
import math
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..envknobs import env_disabled, env_float, env_int

QUALITY_ENV = "KEYSTONE_QUALITY"


def quality_enabled() -> bool:
    """True unless ``KEYSTONE_QUALITY`` spells off (default-on plane)."""
    return not env_disabled(QUALITY_ENV)


def quality_alpha() -> float:
    return env_float("KEYSTONE_QUALITY_ALPHA", 0.05)


def quality_min_samples() -> int:
    return env_int("KEYSTONE_QUALITY_MIN_SAMPLES", 24)


def quality_max_samples() -> int:
    return env_int("KEYSTONE_QUALITY_MAX_SAMPLES", 512)


def quality_max_features() -> int:
    return env_int("KEYSTONE_QUALITY_MAX_FEATURES", 8)


def quality_sketch_bins() -> int:
    return env_int("KEYSTONE_QUALITY_SKETCH_BINS", 64)


def quality_sample_every() -> int:
    return max(env_int("KEYSTONE_QUALITY_SAMPLE", 1), 1)


def drift_threshold() -> float:
    return env_float("KEYSTONE_QUALITY_DRIFT_THRESHOLD", 0.5)


def drift_min_count() -> int:
    return env_int("KEYSTONE_QUALITY_DRIFT_MIN_COUNT", 64)


def decay_floor() -> float:
    return env_float("KEYSTONE_QUALITY_DECAY_FLOOR", 0.5)


# ------------------------------------------------------------------ moments


class Moments:
    """Welford count/mean/M2 plus min/max. ``merge`` is Chan's parallel
    update — EXACT (up to float rounding) for any split of the input, the
    property the sketch-mergeability test pins."""

    __slots__ = ("count", "mean", "m2", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float) -> None:
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self.m2 += delta * (x - self.mean)
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    def merge(self, other: "Moments") -> None:
        if other.count == 0:
            return
        if self.count == 0:
            self.count, self.mean, self.m2 = other.count, other.mean, other.m2
            self.min, self.max = other.min, other.max
            return
        n = self.count + other.count
        delta = other.mean - self.mean
        self.mean += delta * other.count / n
        self.m2 += other.m2 + delta * delta * self.count * other.count / n
        self.count = n
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    @property
    def variance(self) -> float:
        return self.m2 / (self.count - 1) if self.count > 1 else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(max(self.variance, 0.0))

    def to_wire(self) -> list:
        return [
            self.count,
            self.mean,
            self.m2,
            self.min if self.count else None,
            self.max if self.count else None,
        ]

    @classmethod
    def from_wire(cls, wire: Sequence) -> "Moments":
        m = cls()
        m.count = int(wire[0])
        m.mean = float(wire[1])
        m.m2 = float(wire[2])
        m.min = float(wire[3]) if wire[3] is not None else math.inf
        m.max = float(wire[4]) if wire[4] is not None else -math.inf
        return m


# ------------------------------------------------------------- P² quantile


class P2Quantile:
    """The classic P² single-quantile estimator (Jain & Chlamtac): five
    markers, O(1) memory and update. Not mergeable — per-process score
    streams use it; the fleet view rides :class:`QuantileSketch`."""

    __slots__ = ("q", "_buf", "_h", "_pos", "_des", "_inc")

    def __init__(self, q: float) -> None:
        self.q = q
        self._buf: Optional[List[float]] = []
        self._h: List[float] = []
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._des = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
        self._inc = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        if self._buf is not None:
            self._buf.append(x)
            if len(self._buf) == 5:
                self._h = sorted(self._buf)
                self._buf = None
            return
        h, pos = self._h, self._pos
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and not (h[k] <= x < h[k + 1]):
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._des[i] += self._inc[i]
        for i in (1, 2, 3):
            d = self._des[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
                d <= -1.0 and pos[i - 1] - pos[i] < -1.0
            ):
                s = 1.0 if d > 0 else -1.0
                cand = h[i] + s / (pos[i + 1] - pos[i - 1]) * (
                    (pos[i] - pos[i - 1] + s)
                    * (h[i + 1] - h[i])
                    / (pos[i + 1] - pos[i])
                    + (pos[i + 1] - pos[i] - s)
                    * (h[i] - h[i - 1])
                    / (pos[i] - pos[i - 1])
                )
                if h[i - 1] < cand < h[i + 1]:
                    h[i] = cand
                else:  # parabolic left the bracket: fall back to linear
                    j = i + int(s)
                    h[i] += s * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += s

    def value(self) -> Optional[float]:
        if self._buf is not None:
            if not self._buf:
                return None
            srt = sorted(self._buf)
            idx = self.q * (len(srt) - 1)
            lo = int(math.floor(idx))
            hi = min(lo + 1, len(srt) - 1)
            return srt[lo] + (idx - lo) * (srt[hi] - srt[lo])
        return self._h[2]

    def to_wire(self) -> dict:
        if self._buf is not None:
            return {"q": self.q, "buf": list(self._buf)}
        return {"q": self.q, "h": list(self._h), "pos": list(self._pos),
                "des": list(self._des)}

    @classmethod
    def from_wire(cls, wire: dict) -> "P2Quantile":
        est = cls(float(wire["q"]))
        if "buf" in wire:
            est._buf = [float(v) for v in wire["buf"]]
        else:
            est._buf = None
            est._h = [float(v) for v in wire["h"]]
            est._pos = [float(v) for v in wire["pos"]]
            est._des = [float(v) for v in wire["des"]]
        return est


# -------------------------------------------------------- mergeable sketch


class QuantileSketch:
    """Bounded-error mergeable quantile sketch: a Ben-Haim/Tom-Tov
    streaming histogram of at most ``bins`` weighted centroids. Inserts
    are O(bins); merging concatenates centroid lists and re-compacts, so
    any heartbeat-sharded observation order converges to (nearly) the
    same histogram — the bounded half of the mergeability test."""

    __slots__ = ("bins", "_centroids")

    def __init__(self, bins: int = 64) -> None:
        self.bins = max(int(bins), 8)
        self._centroids: List[List[float]] = []  # sorted [value, weight]

    def add(self, x: float, weight: float = 1.0) -> None:
        c = self._centroids
        i = bisect.bisect_left(c, [x, -math.inf])
        if i < len(c) and c[i][0] == x:
            c[i][1] += weight
        else:
            c.insert(i, [x, weight])
            if len(c) > self.bins:
                self._compact()

    def _compact(self) -> None:
        c = self._centroids
        while len(c) > self.bins:
            gap_i = min(
                range(len(c) - 1), key=lambda i: (c[i + 1][0] - c[i][0], i)
            )
            v1, w1 = c[gap_i]
            v2, w2 = c[gap_i + 1]
            w = w1 + w2
            c[gap_i] = [(v1 * w1 + v2 * w2) / w, w]
            del c[gap_i + 1]

    def merge(self, other: "QuantileSketch") -> None:
        for value, weight in other._centroids:
            self.add(value, weight)

    def quantile(self, q: float) -> Optional[float]:
        c = self._centroids
        if not c:
            return None
        total = sum(w for _, w in c)
        if total <= 0:
            return None
        target = q * total
        cum = 0.0
        for i, (value, weight) in enumerate(c):
            if cum + weight / 2.0 >= target:
                if i == 0:
                    return value
                pv, pw = c[i - 1]
                prev_mid = cum - pw / 2.0
                mid = cum + weight / 2.0
                frac = (target - prev_mid) / max(mid - prev_mid, 1e-12)
                return pv + frac * (value - pv)
            cum += weight
        return c[-1][0]

    def to_wire(self) -> list:
        return [[round(v, 9), w] for v, w in self._centroids]

    @classmethod
    def from_wire(cls, wire: Sequence, bins: int = 64) -> "QuantileSketch":
        sk = cls(bins)
        sk._centroids = sorted([float(v), float(w)] for v, w in wire)
        sk._compact()
        return sk


class ChannelSketch:
    """One observed channel (a payload feature, or the score itself):
    exact-mergeable moments plus a bounded-error quantile histogram."""

    __slots__ = ("moments", "quantiles")

    def __init__(self, bins: int = 64) -> None:
        self.moments = Moments()
        self.quantiles = QuantileSketch(bins)

    def observe(self, x: float) -> None:
        self.moments.observe(x)
        self.quantiles.add(x)

    def merge(self, other: "ChannelSketch") -> None:
        self.moments.merge(other.moments)
        self.quantiles.merge(other.quantiles)

    def to_wire(self) -> dict:
        return {"m": self.moments.to_wire(), "q": self.quantiles.to_wire()}

    @classmethod
    def from_wire(cls, wire: dict, bins: int = 64) -> "ChannelSketch":
        sk = cls(bins)
        sk.moments = Moments.from_wire(wire["m"])
        sk.quantiles = QuantileSketch.from_wire(wire["q"], bins)
        return sk

    def summary(self) -> dict:
        m = self.moments
        return {
            "count": m.count,
            "mean": round(m.mean, 6) if m.count else None,
            "std": round(m.std, 6) if m.count else None,
            "min": m.min if m.count else None,
            "max": m.max if m.count else None,
            "p50": self.quantiles.quantile(0.5),
            "p90": self.quantiles.quantile(0.9),
        }


class PayloadSketch:
    """Per-model input-distribution sketch: one :class:`ChannelSketch`
    per tracked payload coordinate (``f0``..``f<max_features-1>``) plus
    the ``score`` channel. Workers accumulate one of these as a DELTA
    between heartbeats (drained and reset each beat); the supervisor
    merges deltas into its cumulative fleet sketch. Because deltas are
    increments — not level snapshots — worker restarts need no
    incarnation folding: a dead worker simply stops contributing."""

    SCORE = "score"

    def __init__(self, max_features: Optional[int] = None,
                 bins: Optional[int] = None) -> None:
        self.max_features = (
            quality_max_features() if max_features is None else max_features
        )
        self.bins = quality_sketch_bins() if bins is None else bins
        self.rows = 0
        self.channels: Dict[str, ChannelSketch] = {}

    def _channel(self, key: str) -> ChannelSketch:
        ch = self.channels.get(key)
        if ch is None:
            ch = self.channels[key] = ChannelSketch(self.bins)
        return ch

    def observe_row(self, row: Sequence[float]) -> None:
        self.rows += 1
        for i, value in enumerate(row):
            if i >= self.max_features:
                break
            try:
                self._channel("f%d" % i).observe(float(value))
            except (TypeError, ValueError):
                continue

    def observe_score(self, score: float) -> None:
        self._channel(self.SCORE).observe(float(score))

    def merge(self, other: "PayloadSketch") -> None:
        self.rows += other.rows
        for key, ch in other.channels.items():
            self._channel(key).merge(ch)

    def to_wire(self) -> dict:
        return {
            "rows": self.rows,
            "ch": {k: ch.to_wire() for k, ch in self.channels.items()},
        }

    @classmethod
    def from_wire(cls, wire: dict, max_features: Optional[int] = None,
                  bins: Optional[int] = None) -> "PayloadSketch":
        sk = cls(max_features, bins)
        sk.rows = int(wire.get("rows", 0))
        for key, ch_wire in wire.get("ch", {}).items():
            sk.channels[key] = ChannelSketch.from_wire(ch_wire, sk.bins)
        return sk

    def wire_bytes(self) -> int:
        return len(json.dumps(self.to_wire(), separators=(",", ":")))

    def summary(self) -> dict:
        return {
            "rows": self.rows,
            "bytes": self.wire_bytes(),
            "channels": {k: self.channels[k].summary()
                         for k in sorted(self.channels)},
        }


# ------------------------------------------------------------ score stream


class ScoreStream:
    """Bounded-memory accumulator over one score stream: Welford moments
    plus P² markers at p10/p50/p90. O(1) state, JSON-serializable — the
    label-joined stream persists its state through the refit store so a
    daemon restart resumes exactly where the journal says it left off."""

    QUANTILES = (0.1, 0.5, 0.9)

    def __init__(self) -> None:
        self.moments = Moments()
        self._p2 = {q: P2Quantile(q) for q in self.QUANTILES}

    def observe(self, score: float) -> None:
        score = float(score)
        self.moments.observe(score)
        for est in self._p2.values():
            est.observe(score)

    def observe_many(self, scores: Sequence[float]) -> None:
        for s in scores:
            self.observe(s)

    @property
    def count(self) -> int:
        return self.moments.count

    @property
    def mean(self) -> float:
        return self.moments.mean

    def quantile(self, q: float) -> Optional[float]:
        est = self._p2.get(q)
        return est.value() if est is not None else None

    def summary(self) -> dict:
        m = self.moments
        out = {
            "count": m.count,
            "mean": round(m.mean, 6) if m.count else None,
            "std": round(m.std, 6) if m.count else None,
            "min": m.min if m.count else None,
            "max": m.max if m.count else None,
        }
        for q in self.QUANTILES:
            v = self.quantile(q)
            out["p%d" % int(q * 100)] = round(v, 6) if v is not None else None
        return out

    def to_state(self) -> dict:
        return {
            "m": self.moments.to_wire(),
            "p2": {str(q): est.to_wire() for q, est in self._p2.items()},
        }

    @classmethod
    def from_state(cls, state: dict) -> "ScoreStream":
        stream = cls()
        stream.moments = Moments.from_wire(state["m"])
        for key, wire in state.get("p2", {}).items():
            stream._p2[float(key)] = P2Quantile.from_wire(wire)
        return stream


# --------------------------------------------------------- sequential gate


def _eb_radius(n: int, variance: float, value_range: float,
               alpha: float) -> float:
    """Anytime-valid empirical-Bernstein confidence radius for a sample
    mean after ``n`` observations bounded in a range of width
    ``value_range``. The ``log(3 n (n+1) / alpha)`` term is the union
    bound over all n simultaneously (time-uniform stitching), which is
    what makes peeking at every sample sound."""
    if n < 2:
        return math.inf
    t = math.log(3.0 * n * (n + 1) / alpha)
    return math.sqrt(2.0 * max(variance, 0.0) * t / n) + 3.0 * value_range * t / n


class SequentialGate:
    """Anytime-valid two-stream comparison: candidate vs baseline score
    streams, decided with empirical-Bernstein confidence sequences.

    ``observe()`` feeds one score into either side; ``evaluate()`` may
    be called after EVERY observation (that is the point) and returns:

    - ``"rollback"`` — the candidate mean is significantly below the
      baseline mean (confidence intervals separated), at family error
      ≤ ``alpha`` over the whole run;
    - ``"promote"`` — significantly above, same guarantee — or the
      sample budget is exhausted with no detected regression (no
      evidence of harm inside the configured window);
    - ``"continue"`` — keep sampling.

    A decision is sticky: once non-``continue``, the gate is closed.
    """

    def __init__(self, model: str, kind: str = "candidate_vs_incumbent",
                 alpha: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 max_samples: Optional[int] = None,
                 method: str = "msprt") -> None:
        self.model = model
        self.kind = kind
        self.method = method
        self.alpha = quality_alpha() if alpha is None else alpha
        self.min_samples = (
            quality_min_samples() if min_samples is None else min_samples
        )
        self.max_samples = (
            quality_max_samples() if max_samples is None else max_samples
        )
        self.candidate = Moments()
        self.baseline = Moments()
        self.decision: Optional[str] = None
        self.budget_exhausted = False

    def observe(self, candidate: Optional[float] = None,
                baseline: Optional[float] = None) -> str:
        if candidate is not None:
            self.candidate.observe(float(candidate))
        if baseline is not None:
            self.baseline.observe(float(baseline))
        return self.evaluate()

    @property
    def samples(self) -> int:
        return self.candidate.count + self.baseline.count

    def _range(self) -> float:
        lo = min(self.candidate.min, self.baseline.min)
        hi = max(self.candidate.max, self.baseline.max)
        if not math.isfinite(lo) or not math.isfinite(hi):
            return 1.0
        return max(hi - lo, 1e-6)

    def _mixture_lr(self) -> float:
        """The mSPRT mixture likelihood ratio for the mean difference:
        H0 says the two streams share a mean; the alternative mixes a
        Gaussian prior of scale tau over the difference. With the Welch
        plug-in variance ``v_n`` of the difference estimator,

            LR_n = sqrt(v_n / (v_n + tau^2))
                   * exp(delta^2 * tau^2 / (2 v_n (v_n + tau^2)))

        is a (approximate, plug-in) nonnegative supermartingale under
        H0, so rejecting when LR_n >= 1/alpha is anytime-valid: the
        gate may be evaluated after every sample. tau^2 defaults to the
        pooled per-observation variance (effect sizes of about one
        observation sigma get the most mixture mass)."""
        v_n = (
            self.candidate.variance / self.candidate.count
            + self.baseline.variance / self.baseline.count
        )
        v_n = max(v_n, 1e-18)
        tau2 = max(
            (self.candidate.variance + self.baseline.variance) / 2.0, 1e-12
        )
        delta = self.candidate.mean - self.baseline.mean
        exponent = delta * delta * tau2 / (2.0 * v_n * (v_n + tau2))
        # Cap before exp() so an enormous separation cannot overflow.
        return math.sqrt(v_n / (v_n + tau2)) * math.exp(min(exponent, 700.0))

    def evaluate(self) -> str:
        if self.decision is not None:
            return self.decision
        nc, nb = self.candidate.count, self.baseline.count
        if min(nc, nb) < 2 or self.samples < self.min_samples:
            return "continue"
        separated = 0  # -1 candidate worse, +1 candidate better
        if self.method == "eb":
            rng = self._range()
            # alpha/2 per side so the pair of sequences holds jointly.
            rc = _eb_radius(nc, self.candidate.variance, rng, self.alpha / 2.0)
            rb = _eb_radius(nb, self.baseline.variance, rng, self.alpha / 2.0)
            if self.candidate.mean - rc > self.baseline.mean + rb:
                separated = 1
            elif self.candidate.mean + rc < self.baseline.mean - rb:
                separated = -1
        else:
            if self._mixture_lr() >= 1.0 / self.alpha:
                separated = (
                    1 if self.candidate.mean > self.baseline.mean else -1
                )
        if separated > 0:
            self.decision = "promote"
        elif separated < 0:
            self.decision = "rollback"
        elif self.samples >= self.max_samples:
            # Budget exhausted with no separation: no evidence of harm.
            self.decision = "promote"
            self.budget_exhausted = True
        else:
            return "continue"
        return self.decision

    def evidence(self) -> dict:
        rng = self._range()
        nc, nb = self.candidate.count, self.baseline.count
        return {
            "model": self.model,
            "kind": self.kind,
            "method": self.method,
            "alpha": self.alpha,
            "lr": (round(min(self._mixture_lr(), 1e12), 4)
                   if min(nc, nb) >= 2 else None),
            "decision": self.decision or "continue",
            "budget_exhausted": self.budget_exhausted,
            "samples": self.samples,
            "max_samples": self.max_samples,
            "candidate": {
                "n": nc,
                "mean": round(self.candidate.mean, 6) if nc else None,
                "radius": (
                    round(_eb_radius(nc, self.candidate.variance, rng,
                                     self.alpha / 2.0), 6)
                    if nc >= 2 else None
                ),
            },
            "baseline": {
                "n": nb,
                "mean": round(self.baseline.mean, 6) if nb else None,
                "radius": (
                    round(_eb_radius(nb, self.baseline.variance, rng,
                                     self.alpha / 2.0), 6)
                    if nb >= 2 else None
                ),
            },
        }


# ----------------------------------------------------------- drift detector


class DriftDetector:
    """Standardized-shift drift detector over a model's live score
    stream. ``freeze_baseline()`` pins the reference window; after that,
    ``drift_score`` is the current-window mean shift measured in
    baseline standard deviations (a population-shift scale, deliberately
    NOT a standard error — huge n must not turn noise into "drift").
    Crossing the threshold fires ONE drift event (edge-triggered; the
    detector re-arms only when the score falls back under threshold) and
    lowers the suggested ``state_decay`` toward the floor so the refit
    fold forgets stale history faster."""

    def __init__(self, threshold: Optional[float] = None,
                 min_count: Optional[int] = None,
                 floor: Optional[float] = None) -> None:
        self.threshold = drift_threshold() if threshold is None else threshold
        self.min_count = drift_min_count() if min_count is None else min_count
        self.floor = decay_floor() if floor is None else floor
        self.baseline: Optional[Moments] = None
        self.current = Moments()
        self.last_score = 0.0
        self.events = 0
        self._armed = True

    def observe(self, score: float) -> None:
        self.current.observe(float(score))

    def freeze_baseline(self) -> None:
        """Adopt the current window as the reference and start a fresh
        current window (e.g. at publish time, or on first quiet fill)."""
        if self.current.count:
            self.baseline = self.current
            self.current = Moments()

    def drift_score(self) -> float:
        if self.baseline is None or self.baseline.count < 2:
            return 0.0
        if self.current.count < self.min_count:
            return 0.0
        scale = max(self.baseline.std, 1e-9)
        return abs(self.current.mean - self.baseline.mean) / scale

    def check(self) -> Optional[dict]:
        """Recompute the drift score; return an event dict exactly once
        per threshold crossing, else None."""
        self.last_score = self.drift_score()
        if self.last_score > self.threshold:
            if self._armed:
                self._armed = False
                self.events += 1
                return {
                    "kind": "drift",
                    "score": round(self.last_score, 6),
                    "threshold": self.threshold,
                    "baseline_mean": round(self.baseline.mean, 6),
                    "current_mean": round(self.current.mean, 6),
                    "baseline_n": self.baseline.count,
                    "current_n": self.current.count,
                }
        else:
            self._armed = True
        return None

    def suggested_decay(self, base: float) -> float:
        """Map the drift score onto ``state_decay``: quiet → ``base``,
        at threshold → start shrinking, at 2× threshold → the floor."""
        score = self.last_score
        if score <= self.threshold:
            return base
        over = min((score - self.threshold) / max(self.threshold, 1e-9), 1.0)
        return max(self.floor, base - (base - self.floor) * over)


# ------------------------------------------------------------ the plane


class QualityPlane:
    """Per-model quality registry for one process.

    Workers observe scores/payloads into their process-local plane and
    drain heartbeat deltas; the supervisor merges those deltas into its
    own plane for the fleet view; the refit daemon joins delayed labels
    and runs gates/drift against its plane. All methods are no-ops when
    ``KEYSTONE_QUALITY`` spells off, so the request-path cost can be
    A/B-measured honestly.
    """

    MAX_DECISIONS = 64

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._streams: Dict[Tuple[str, str], ScoreStream] = {}
        self._sketches: Dict[str, PayloadSketch] = {}
        self._pending: Dict[str, PayloadSketch] = {}
        self._drift: Dict[str, DriftDetector] = {}
        self._gates: Dict[str, SequentialGate] = {}
        self._sample_counter = 0
        self._label_joins: Dict[str, int] = {}
        self._merges = 0
        self.decisions: deque = deque(maxlen=self.MAX_DECISIONS)

    # -- streams -----------------------------------------------------

    def stream(self, model: str, role: str = "live") -> ScoreStream:
        with self._lock:
            key = (model, role)
            stream = self._streams.get(key)
            if stream is None:
                stream = self._streams[key] = ScoreStream()
            return stream

    def observe_score(self, model: str, score: float,
                      role: str = "live") -> None:
        if not quality_enabled():
            return
        with self._lock:
            self.stream(model, role).observe(score)
            if role == "live":
                self.drift(model).observe(score)
        from . import names
        names.metric(names.QUALITY_SCORES).inc(model=model, role=role)

    def observe_served(self, model: str, row: Sequence[float],
                       score: Optional[float] = None) -> None:
        """One served request: sketch the payload (sampled) and feed the
        prediction score into the live stream + drift window. This is
        the request-path entry point — backends call exactly this."""
        if not quality_enabled():
            return
        self.observe_payload(model, row, score)
        if score is not None:
            self.observe_score(model, score, role="live")

    def join_labels(self, model: str, scores: Sequence[float]) -> int:
        """Fold a batch of label-joined per-row scores (accuracy/loss
        from delayed labels) into the ``labeled`` stream. Returns rows
        joined. The caller (the refit daemon) provides exactly-once
        semantics by persisting :meth:`state` with its journal."""
        if not quality_enabled() or not len(scores):
            return 0
        with self._lock:
            self.stream(model, "labeled").observe_many(scores)
            self._label_joins[model] = (
                self._label_joins.get(model, 0) + len(scores)
            )
        from . import names
        names.metric(names.QUALITY_LABEL_JOINS).inc(len(scores), model=model)
        return len(scores)

    # -- payload sketches --------------------------------------------

    def observe_payload(self, model: str, row: Sequence[float],
                        score: Optional[float] = None) -> None:
        """Worker-side: sketch one served payload row (1-in-N sampled)
        and its prediction score into the pending heartbeat delta."""
        if not quality_enabled():
            return
        with self._lock:
            self._sample_counter += 1
            if self._sample_counter % quality_sample_every():
                return
            pending = self._pending.get(model)
            if pending is None:
                pending = self._pending[model] = PayloadSketch()
            pending.observe_row(row)
            if score is not None:
                pending.observe_score(score)

    def drain_delta(self) -> Optional[dict]:
        """Ship-and-reset the pending sketches: the heartbeat payload.
        Returns ``{model: wire}`` or None when nothing was observed."""
        with self._lock:
            if not self._pending:
                return None
            wire = {m: sk.to_wire() for m, sk in self._pending.items()}
            self._pending.clear()
            return wire

    def merge_delta(self, wire: dict, role: str = "worker") -> None:
        """Supervisor-side: fold one worker heartbeat delta into the
        cumulative fleet sketches (and the live score streams/drift,
        via the delta's score-channel moments)."""
        if not wire:
            return
        with self._lock:
            for model, sk_wire in wire.items():
                sketch = self._sketches.get(model)
                if sketch is None:
                    sketch = self._sketches[model] = PayloadSketch()
                sketch.merge(PayloadSketch.from_wire(sk_wire))
            self._merges += 1
        from . import names
        names.metric(names.QUALITY_SKETCH_MERGES).inc(role=role)

    def sketch(self, model: str) -> Optional[PayloadSketch]:
        with self._lock:
            return self._sketches.get(model)

    # -- drift --------------------------------------------------------

    def drift(self, model: str) -> DriftDetector:
        with self._lock:
            det = self._drift.get(model)
            if det is None:
                det = self._drift[model] = DriftDetector()
            return det

    def check_drift(self, model: str) -> Optional[dict]:
        """Edge-triggered drift check; on a firing, bumps the metric and
        feeds the flight recorder's quality ring (which dumps)."""
        if not quality_enabled():
            return None
        event = self.drift(model).check()
        from . import names
        names.metric(names.QUALITY_DRIFT_SCORE).set(
            self.drift(model).last_score, model=model
        )
        if event is None:
            return None
        event["model"] = model
        names.metric(names.QUALITY_DRIFT_EVENTS).inc(model=model)
        from .flight import get_flight_recorder
        recorder = get_flight_recorder()
        if recorder is not None:
            recorder.observe_quality(dict(event))
        return event

    def suggested_decay(self, model: str, base: float) -> float:
        if not quality_enabled():
            return base
        decay = self.drift(model).suggested_decay(base)
        from . import names
        names.metric(names.QUALITY_STATE_DECAY).set(decay, model=model)
        return decay

    # -- gates --------------------------------------------------------

    def open_gate(self, model: str, kind: str = "candidate_vs_incumbent",
                  alpha: Optional[float] = None,
                  min_samples: Optional[int] = None,
                  max_samples: Optional[int] = None) -> SequentialGate:
        gate = SequentialGate(model, kind, alpha, min_samples, max_samples)
        with self._lock:
            self._gates["%s:%s" % (model, kind)] = gate
        return gate

    def record_decision(self, gate: SequentialGate) -> dict:
        """Close a gate: archive its evidence, bump the decision metric,
        feed the flight recorder's quality ring (a ``rollback`` dumps)."""
        evidence = gate.evidence()
        with self._lock:
            self.decisions.append(evidence)
            self._gates.pop("%s:%s" % (gate.model, gate.kind), None)
        from . import names
        names.metric(names.QUALITY_GATE_DECISIONS).inc(
            model=gate.model, decision=evidence["decision"]
        )
        from .flight import get_flight_recorder
        recorder = get_flight_recorder()
        if recorder is not None:
            # The gate's own "kind" (which streams it compared) must not
            # clobber the ring entry's event kind — the recorder dumps on
            # kind == "gate_decision" + decision == "rollback".
            event = dict(evidence)
            event["gate"] = event.pop("kind")
            event["kind"] = "gate_decision"
            recorder.observe_quality(event)
        return evidence

    def open_gates(self) -> List[dict]:
        with self._lock:
            return [g.evidence() for g in self._gates.values()]

    # -- surfacing ----------------------------------------------------

    def publish_metrics(self, registry=None) -> None:
        """Set the level-style ``keystone_quality_*`` gauges from current
        state (counters were bumped at event time)."""
        from . import names
        with self._lock:
            for (model, role), stream in self._streams.items():
                if not stream.count:
                    continue
                names.metric(names.QUALITY_SCORE_MEAN, registry).set(
                    stream.mean, model=model, role=role
                )
                for q in ScoreStream.QUANTILES:
                    v = stream.quantile(q)
                    if v is not None:
                        names.metric(names.QUALITY_SCORE_QUANTILE,
                                     registry).set(
                            v, model=model, role=role,
                            q="p%d" % int(q * 100)
                        )
            for model, sketch in self._sketches.items():
                names.metric(names.QUALITY_SKETCH_ROWS, registry).set(
                    sketch.rows, model=model
                )
                names.metric(names.QUALITY_SKETCH_BYTES, registry).set(
                    sketch.wire_bytes(), model=model
                )
            names.metric(names.QUALITY_GATE_OPEN, registry).set(
                len(self._gates)
            )
            for key, gate in self._gates.items():
                names.metric(names.QUALITY_GATE_SAMPLES, registry).set(
                    gate.samples, model=gate.model
                )

    def report(self) -> dict:
        """The CLI/bench-facing view: per-model score summaries, drift
        state, open gates, and archived decisions with evidence."""
        with self._lock:
            models = sorted(
                {m for m, _ in self._streams}
                | set(self._sketches)
                | set(self._drift)
            )
            out: dict = {"models": {}, "decisions": list(self.decisions),
                         "open_gates": [g.evidence()
                                        for g in self._gates.values()]}
            for model in models:
                streams = {
                    role: stream.summary()
                    for (m, role), stream in self._streams.items()
                    if m == model and stream.count
                }
                det = self._drift.get(model)
                sketch = self._sketches.get(model)
                out["models"][model] = {
                    "streams": streams,
                    "label_joins": self._label_joins.get(model, 0),
                    "drift": {
                        "score": round(det.last_score, 6) if det else 0.0,
                        "threshold": det.threshold if det else None,
                        "events": det.events if det else 0,
                        "drifting": bool(
                            det and det.last_score > det.threshold
                        ),
                    },
                    "sketch": sketch.summary() if sketch else None,
                }
            out["sketch_merges"] = self._merges
            return out

    # -- persistence (label-joined streams ride the refit journal) ----

    def state(self, model: str) -> dict:
        """Serializable restart-state for one model's label-joined
        plane: the labeled stream plus the drift windows. The refit
        daemon persists this next to its stream state so a crash between
        journal phases replays the join exactly once."""
        with self._lock:
            labeled = self._streams.get((model, "labeled"))
            det = self._drift.get(model)
            return {
                "labeled": labeled.to_state() if labeled else None,
                "joins": self._label_joins.get(model, 0),
                "drift": {
                    "baseline": (det.baseline.to_wire()
                                 if det and det.baseline else None),
                    "current": det.current.to_wire() if det else None,
                    "events": det.events if det else 0,
                    "armed": det._armed if det else True,
                } if det else None,
            }

    def restore(self, model: str, state: Optional[dict]) -> None:
        if not state:
            return
        with self._lock:
            if state.get("labeled"):
                self._streams[(model, "labeled")] = ScoreStream.from_state(
                    state["labeled"]
                )
            self._label_joins[model] = int(state.get("joins", 0))
            drift_state = state.get("drift")
            if drift_state:
                det = self.drift(model)
                if drift_state.get("baseline"):
                    det.baseline = Moments.from_wire(drift_state["baseline"])
                if drift_state.get("current"):
                    det.current = Moments.from_wire(drift_state["current"])
                det.events = int(drift_state.get("events", 0))
                det._armed = bool(drift_state.get("armed", True))


# ------------------------------------------------------- process singleton

_PLANE: Optional[QualityPlane] = None
_PLANE_LOCK = threading.Lock()


def get_quality_plane() -> QualityPlane:
    """The process-wide plane (workers and in-process serving observe
    here; the supervisor keeps its own instance for the fleet view)."""
    global _PLANE
    with _PLANE_LOCK:
        if _PLANE is None:
            _PLANE = QualityPlane()
        return _PLANE


def reset_quality_plane() -> None:
    global _PLANE
    with _PLANE_LOCK:
        _PLANE = None
