"""Cost observatory: measured-vs-modeled accounting for every node the
plan executes.

Port of ``keystone_tpu/obs/cost.py``. Four cost models drive decisions —
the solver ladder's ``CostModel`` rungs, ``AutoCacheRule``'s per-node
linear fits, ``MeasuredKnobRule``'s recorded winners and the tuner's
ridge model — and this module checks their predictions against what the
card ran:

- **Harvest.** The port has no compiled program to ask for flop and
  byte counts, so it counts at its own launch sites. The cuBLAS binding
  (``ops/cuda/gemm.py``) notes every product with its kind, and the ELL
  kernel's wrapper (``ops/cuda/blocksparse.py``) every launch with its
  stored-block count. :func:`harvest_cost_facts` is the ONE place a
  launch's shape becomes flop and byte facts (as KV506 keeps one
  ``cost_analysis()`` call site in the JAX package):

  - a product ``(m, k) @ (k, n)`` at kind K: ``2·m·n·k`` FLOP, and
    ``(m·k + k·n + m·n)·itemsize`` bytes (each operand read once, the
    output written once), priced at K's peak;
  - an ELL launch: ``2 × stored blocks × bm × bn × N`` FLOP, and the
    stored indices, the counts, the stored blocks, B and the output,
    each once: the counts of the kernel table's bound in PERF.md.

  Work no launch site notes (cuFFT, elementwise passes, host code) has
  no facts: ``None``, never a guess.
- **Roofline.** One probe per product kind the binding offers
  (``ieee_fp32``, ``tf32``, ``bf16``, ``fp64``), timed with CUDA events
  on the card, and one device copy for the bandwidth roof; min of 3
  after a warm call. Cached in the ProfileStore under
  ``roofline:cuda:<card name>`` (``roofline:cpu`` on the host), so later
  processes skip the probe. A node's products are priced at the peak of
  the kind each ran at, so a TF32 Gram never reads over 100% of an fp32
  roof. A node is compute-bound when its products' time at peak is at
  least its bytes' time at the copy rate.
- **Perf ledger.** ``workflow/tracing.timed_execute`` opens a harvest
  frame around each node's forcing; the launch sites note into it; the
  frame is finalized into one :class:`PerfLedgerEntry` joining the
  predicted cost (whichever model drove the decision), the measured
  wall, achieved rates, intensity and roofline placement. Entries ride
  flight-recorder dumps and export as a Chrome counter track.
- **Drift sentinel.** Predicted-vs-measured per ``(key, shape class)``
  with a noise-tolerant ratio test (symmetric band, consecutive-miss
  sustain), copied from the JAX package: sustained drift publishes
  ``keystone_cost_drift_*``, lands a ``cost_drift`` recovery-ledger event
  and marks the ProfileStore entry ``stale:``.

Everything is off unless the observatory is enabled
(``KEYSTONE_COST_OBS=1`` or :func:`set_cost_observatory`); the no-op path
at a launch site is one thread-local read. ``explain``, ``profile`` and
``tune`` turn it on for their runs. Imports no torch at import time.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..envknobs import env_flag, env_float, env_int
from . import names as _names
from . import spans as _spans

logger = logging.getLogger(__name__)

#: Perf-ledger ring bound (overridable per-instance).
_LEDGER_MAX_DEFAULT = 256

#: The binding's product kinds the roofline probes, and the kind each
#: launch-site kind is priced at (``bf16_inputs`` is a bf16 product; the
#: ELL kernel runs fp32 FMAs outside the tensor cores).
PROBE_KINDS = ("ieee_fp32", "tf32", "bf16", "fp64")
_PRICED_AS = {"bf16_inputs": "bf16", "ell_fp32": "ieee_fp32"}


# ------------------------------------------------------------------ enablement

_enabled_override: Optional[bool] = None
_enabled_lock = threading.Lock()


def cost_observatory_enabled() -> bool:
    """Master switch: ``set_cost_observatory()`` override, else the
    ``KEYSTONE_COST_OBS`` env flag (default OFF: the observatory is an
    analysis plane, not a steady-state tax)."""
    if _enabled_override is not None:
        return _enabled_override
    return env_flag("KEYSTONE_COST_OBS", False)


def set_cost_observatory(value: Optional[bool]) -> None:
    """Force the observatory on/off process-wide; ``None`` restores the
    env default."""
    global _enabled_override
    with _enabled_lock:
        _enabled_override = value


def drift_ratio_tolerance() -> float:
    """Symmetric ratio band half-width: a prediction is in-band while
    ``max(ratio, 1/ratio) <= tol`` (``KEYSTONE_COST_DRIFT_RATIO``,
    default 4.0, the JAX package's)."""
    return max(1.0, env_float("KEYSTONE_COST_DRIFT_RATIO", 4.0))


def drift_sustain() -> int:
    """Consecutive out-of-band observations of one (key, shape) before
    the sentinel fires (``KEYSTONE_COST_DRIFT_SUSTAIN``, default 2)."""
    return max(1, env_int("KEYSTONE_COST_DRIFT_SUSTAIN", 2))


def drift_enabled() -> bool:
    return env_flag("KEYSTONE_COST_DRIFT", True)


# ----------------------------------------------------------------- predictions


@dataclass(frozen=True)
class Prediction:
    """One model's cost claim for a node, carried to the ledger join.

    ``calibrated`` marks predictions measured under the exact
    (key, shape class) they will be compared at — only those are
    drift-scored. ``seconds`` and ``rows_per_s`` are alternative units;
    whichever is set is what the sentinel compares."""

    model: str  # solver_ladder | autocache | measured_knob | tune | roofline
    key: str = ""  # the ProfileStore key that backed it ("" = none)
    shape: str = ""  # the shape class it was recorded under
    seconds: Optional[float] = None
    rows_per_s: Optional[float] = None
    calibrated: bool = False
    source: str = "observed"  # store provenance (observed | tune)
    #: Every candidate an argmin choice considered, as (name,
    #: seconds-or-None, reason) tuples — "chosen" for the winner,
    #: the rejection reason otherwise.
    candidates: Tuple = ()


# Plan-scoped prediction book: node label → Prediction, filled by the
# optimizer passes that predict per-NODE costs (AutoCacheRule's linear
# fits) and read back by finalize_node when the executed operator has no
# pinned prediction of its own.
_plan_predictions: Dict[str, Prediction] = {}
_plan_lock = threading.Lock()


def note_plan_prediction(label: str, prediction: Prediction) -> None:
    if not cost_observatory_enabled():
        return
    with _plan_lock:
        _plan_predictions[str(label)] = prediction


def reset_plan_predictions() -> None:
    with _plan_lock:
        _plan_predictions.clear()


def plan_prediction(label: str) -> Optional[Prediction]:
    with _plan_lock:
        return _plan_predictions.get(str(label))


# -------------------------------------------------------------------- harvest


@dataclass(frozen=True)
class CostFacts:
    """What one launch did: flop count, bytes it must move, and the
    product kind its flops are priced at (None for no flops)."""

    flops: Optional[float]
    bytes_accessed: Optional[float]
    kind: Optional[str] = None


def harvest_cost_facts(site: str, kind: Optional[str], shape: Dict[str, Any]) -> Optional[CostFacts]:
    """Flop/byte facts for one noted launch — THE place a launch's shape
    becomes facts. ``site`` is ``"gemm"`` (``m``, ``n``, ``k``,
    ``itemsize``, ``batch``) or ``"ell_matmul"`` (``nbr``, ``slots``,
    ``bm``, ``bn``, ``d_pad``, ``n`` and ``counts``, a tensor or None).
    An unknown site or a failure returns None; a fit never breaks on
    its accounting."""
    try:
        if site == "gemm":
            m, n, k = int(shape["m"]), int(shape["n"]), int(shape["k"])
            batch = int(shape.get("batch", 1))
            itemsize = int(shape["itemsize"])
            flops = 2.0 * m * n * k * batch
            moved = float(m * k + k * n + m * n) * itemsize * batch
            return CostFacts(flops, moved, kind)
        if site == "ell_matmul":
            nbr, slots = int(shape["nbr"]), int(shape["slots"])
            bm, bn, n = int(shape["bm"]), int(shape["bn"]), int(shape["n"])
            counts = shape.get("counts")
            if counts is None:
                stored, count_bytes = nbr * slots, 0
            else:
                stored, count_bytes = int(counts.sum()), 4 * int(counts.numel())
            flops = 2.0 * stored * bm * bn * n
            moved = float(
                stored * 4 + count_bytes + stored * bm * bn * 4
                + int(shape["d_pad"]) * n * 4 + nbr * bm * n * 4
            )
            return CostFacts(flops, moved, kind)
    except Exception as e:  # accounting never fails a fit
        logger.debug("cost harvest failed for %s (%s)", site, e)
    return None


# ------------------------------------------------------------------- roofline


@dataclass(frozen=True)
class Roofline:
    """Per-card achievable peaks, probe-measured: the ridge point
    ``peak_flops/peak_bytes`` separates compute-bound from memory-bound
    intensities. ``peak_flops_per_s`` is the IEEE fp32 roof (the JAX
    package's one roof); ``peak_flops_by_kind`` holds every probed
    product kind's."""

    peak_flops_per_s: float
    peak_bytes_per_s: float
    backend: str = "unknown"
    source: str = "probe"  # probe | store
    peak_flops_by_kind: Dict[str, float] = field(default_factory=dict)

    @property
    def ridge_intensity(self) -> float:
        if self.peak_bytes_per_s <= 0:
            return float("inf")
        return self.peak_flops_per_s / self.peak_bytes_per_s

    def classify(self, intensity: Optional[float]) -> Optional[str]:
        if intensity is None:
            return None
        return (
            "compute-bound" if intensity >= self.ridge_intensity
            else "memory-bound"
        )

    def predicted_seconds(
        self, flops: Optional[float], bytes_accessed: Optional[float]
    ) -> Optional[float]:
        """First-principles roofline time: max of the compute and the
        memory floor — the fallback prediction for nodes no model
        claimed."""
        terms = []
        if flops and self.peak_flops_per_s > 0:
            terms.append(flops / self.peak_flops_per_s)
        if bytes_accessed and self.peak_bytes_per_s > 0:
            terms.append(bytes_accessed / self.peak_bytes_per_s)
        return max(terms) if terms else None

    def peak_for(self, kind: Optional[str]) -> float:
        """The peak FLOP/s a product of ``kind`` is priced at (the fp32
        roof for an unknown or missing kind)."""
        kind = _PRICED_AS.get(kind or "", kind)
        return float(self.peak_flops_by_kind.get(kind or "", self.peak_flops_per_s))

    def compute_seconds(self, flops_by_kind: Dict[str, float]) -> Optional[float]:
        """Time at peak of every kind's flops, summed."""
        terms = [
            f / self.peak_for(k) for k, f in flops_by_kind.items()
            if f and self.peak_for(k) > 0
        ]
        return sum(terms) if terms else None

    def memory_seconds(self, bytes_accessed: Optional[float]) -> Optional[float]:
        if not bytes_accessed or self.peak_bytes_per_s <= 0:
            return None
        return bytes_accessed / self.peak_bytes_per_s

    def place(
        self, flops_by_kind: Dict[str, float], bytes_accessed: Optional[float]
    ) -> Tuple[Optional[str], Optional[float]]:
        """(placement, floor seconds) of mixed-kind work: compute-bound
        when the flops' time at their kinds' peaks is at least the bytes'
        time, and the floor is the larger of the two. With one kind at
        the fp32 roof this is :meth:`classify` and
        :meth:`predicted_seconds`."""
        compute = self.compute_seconds(flops_by_kind)
        memory = self.memory_seconds(bytes_accessed)
        if compute is None and memory is None:
            return None, None
        if compute is None or memory is None:
            # One axis only: intensity is undefined (the JAX package's
            # classify(None) is None), but the floor still stands.
            return None, compute if memory is None else memory
        placement = "compute-bound" if compute >= memory else "memory-bound"
        return placement, max(compute, memory)

    def to_json(self) -> Dict[str, Any]:
        return {
            "peak_flops_per_s": self.peak_flops_per_s,
            "peak_bytes_per_s": self.peak_bytes_per_s,
            "ridge_intensity": self.ridge_intensity,
            "backend": self.backend,
            "source": self.source,
            "peak_flops_by_kind": dict(self.peak_flops_by_kind),
        }


ROOFLINE_SHAPE = "probe:v1"

_roofline: Optional[Roofline] = None
_roofline_lock = threading.Lock()


def _roofline_store_key(backend: str) -> str:
    return f"roofline:{backend}"


def roofline_backend(device: Any = None) -> str:
    """``cuda:<card name>`` for a CUDA device, ``cpu`` for the host. With
    ``device=None`` it names this process's platform, as the profile
    store's fingerprint does (a card when one is present)."""
    import torch

    if device is None:
        dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return "cpu"


def _probe_sizes(on_card: bool) -> Tuple[int, int]:
    """(product side, copy elements): large enough on the card that the
    launch overhead is noise (8,192² products, a 1 GiB copy); tiny on
    the host, as the JAX package's CPU probe."""
    return (8192, 256 * 1024 * 1024) if on_card else (384, 4 * 1024 * 1024)


def probe_roofline(device: Any) -> Roofline:
    """Measure achievable peaks on ``device``: one square product per
    kind through the binding (``ops/cuda/gemm.py``) and one device copy.
    Warm once, then min of 3 (ambient load inflates walls, never deflates
    them), by CUDA events on the card and the host clock otherwise. The
    flop and byte counts come from :func:`harvest_cost_facts`, the same
    counts every node is placed with."""
    import torch

    from ..ops.cuda import gemm as _gemm

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    n, copy_n = _probe_sizes(on_card)

    def timed(fn) -> float:
        fn()
        if on_card:
            torch.cuda.synchronize(dev)
        walls = []
        for _ in range(3):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                walls.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn()
                walls.append(time.perf_counter() - t0)
        return max(min(walls), 1e-9)

    gen = torch.Generator(device=dev).manual_seed(0)
    peaks: Dict[str, float] = {}
    for kind in PROBE_KINDS:
        dtype = torch.float64 if kind == "fp64" else torch.float32
        a = torch.randn(n, n, generator=gen, device=dev, dtype=dtype)
        out = torch.empty(n, n, device=dev, dtype=dtype)
        wall = timed(lambda: _gemm.gemm(a, a, kind, out=out))
        facts = harvest_cost_facts("gemm", kind, {"m": n, "n": n, "k": n, "itemsize": a.element_size()})
        peaks[kind] = facts.flops / wall
        del a, out
    src = torch.ones(copy_n, device=dev, dtype=torch.float32)
    dst = torch.empty_like(src)
    copy_wall = timed(lambda: dst.copy_(src))
    traffic = 2.0 * copy_n * 4
    del src, dst
    return Roofline(
        peak_flops_per_s=peaks["ieee_fp32"],
        peak_bytes_per_s=traffic / copy_wall,
        backend=roofline_backend(dev),
        source="probe",
        peak_flops_by_kind=peaks,
    )


def get_roofline(refresh: bool = False, device: Any = None) -> Optional[Roofline]:
    """The process roofline: cached in-process, warm-started from the
    ProfileStore's ``roofline:<backend>`` entry (fingerprinted like any
    other measurement), probe-measured and recorded back on a cold store.
    ``device`` picks the card to probe (None: this process's platform).
    None when the probe fails."""
    global _roofline
    if _roofline is not None and not refresh:
        return _roofline
    with _roofline_lock:
        if _roofline is not None and not refresh:
            return _roofline
        from . import store as _store

        backend = roofline_backend(device)
        store = _store.get_store()
        if store is not None and not refresh:
            m = store.lookup(_roofline_store_key(backend), ROOFLINE_SHAPE)
            if m and m.get("peak_flops_per_s") and m.get("peak_bytes_per_s"):
                _roofline = Roofline(
                    float(m["peak_flops_per_s"]),
                    float(m["peak_bytes_per_s"]),
                    backend=backend,
                    source="store",
                    peak_flops_by_kind={
                        k: float(m[f"peak_{k}_flops_per_s"]) for k in PROBE_KINDS
                        if m.get(f"peak_{k}_flops_per_s")
                    },
                )
                _publish_roofline(_roofline)
                return _roofline
        try:
            import torch

            dev = torch.device(device) if device is not None else (
                torch.device("cuda") if backend.startswith("cuda:") else torch.device("cpu")
            )
            probed = probe_roofline(dev)
        except Exception as e:
            logger.warning("roofline probe failed (%s)", e)
            return None
        if store is not None:
            store.record(
                _roofline_store_key(backend),
                ROOFLINE_SHAPE,
                peak_flops_per_s=probed.peak_flops_per_s,
                peak_bytes_per_s=probed.peak_bytes_per_s,
                **{f"peak_{k}_flops_per_s": v for k, v in probed.peak_flops_by_kind.items()},
            )
        _roofline = probed
        _publish_roofline(probed)
        return probed


def _publish_roofline(roofline: Roofline) -> None:
    gauge = _names.metric(_names.COST_ROOFLINE_PEAK)
    gauge.set(roofline.peak_flops_per_s, resource="flops_per_s")
    gauge.set(roofline.peak_bytes_per_s, resource="bytes_per_s")


def set_roofline(roofline: Optional[Roofline]) -> None:
    """Pin a roofline (tests); None drops the cache so the next
    :func:`get_roofline` re-resolves."""
    global _roofline
    with _roofline_lock:
        _roofline = roofline


# ------------------------------------------------------------------ the ledger


@dataclass
class PerfLedgerEntry:
    """One node execution, measured and attributed — the perf ledger's
    record (the JAX package's schema; ``lowering_digest`` stays empty:
    the port has no lowered program, and ``flops_by_kind`` / ``sites``
    split the facts by product kind and by launch site)."""

    node: str
    seconds: float
    synced: bool
    t_s: float  # perf_counter at finalize (session-relative export anchor)
    t_unix: float
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    intensity: Optional[float] = None
    flops_per_s: Optional[float] = None
    bytes_per_s: Optional[float] = None
    roofline: Optional[str] = None  # compute-bound | memory-bound | None
    bound_frac: Optional[float] = None  # floor seconds / measured seconds
    lowering_digest: str = ""
    kinds: Tuple[str, ...] = ()
    predicted_s: Optional[float] = None
    predicted_model: Optional[str] = None
    predicted_key: str = ""
    predicted_shape: str = ""
    predicted_calibrated: bool = False
    predicted_candidates: Tuple = ()
    ratio: Optional[float] = None  # measured-vs-predicted, >1 = slower
    drift: bool = False
    cold: bool = False  # kernel builds or cuFFT plans during the forcing
    rows_per_s: Optional[float] = None  # streaming folds only
    flops_by_kind: Dict[str, float] = field(default_factory=dict)
    #: per launch site ("gemm:<kind>", "ell_matmul"): launches, flops, bytes.
    sites: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"node": self.node}
        for key in (
            "seconds", "synced", "t_unix", "flops", "bytes_accessed",
            "intensity", "flops_per_s", "bytes_per_s", "roofline",
            "bound_frac", "lowering_digest", "predicted_s",
            "predicted_model", "predicted_key", "predicted_shape",
            "predicted_calibrated", "ratio", "drift", "cold", "rows_per_s",
        ):
            value = getattr(self, key)
            if value is not None and value != "":
                out[key] = value
        if self.kinds:
            out["kinds"] = list(self.kinds)
        if self.predicted_candidates:
            out["predicted_candidates"] = [
                list(c) for c in self.predicted_candidates
            ]
        if self.flops_by_kind:
            out["flops_by_kind"] = dict(self.flops_by_kind)
        if self.sites:
            out["sites"] = {k: dict(v) for k, v in self.sites.items()}
        return out


class PerfLedger:
    """Bounded ring of :class:`PerfLedgerEntry` with a monotonic cursor
    so consumers (flight dumps, explain) read their own windows."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity or env_int(
            "KEYSTONE_COST_LEDGER_MAX", _LEDGER_MAX_DEFAULT
        )
        self._lock = threading.Lock()
        self._ring: "deque[PerfLedgerEntry]" = deque(maxlen=self.capacity)
        self._seq = 0

    def record(self, entry: PerfLedgerEntry) -> None:
        with self._lock:
            self._ring.append(entry)
            self._seq += 1
        _names.metric(_names.COST_LEDGER_ENTRIES).inc(
            roofline=entry.roofline or "unknown"
        )

    def cursor(self) -> int:
        with self._lock:
            return self._seq

    def entries(self, since: int = 0) -> List[PerfLedgerEntry]:
        """Entries recorded after cursor ``since`` (ring-bounded: at most
        the last ``capacity`` survive)."""
        with self._lock:
            fresh = max(0, self._seq - since)
            return list(self._ring)[-fresh:] if fresh else []

    def tail(self, n: int) -> List[PerfLedgerEntry]:
        with self._lock:
            return list(self._ring)[-n:]


_ledger = PerfLedger()


def get_ledger() -> PerfLedger:
    return _ledger


# ------------------------------------------------------------- harvest frames


class _Note:
    __slots__ = ("site", "kind", "shape")

    def __init__(self, site: str, kind: Optional[str], shape: Dict[str, Any]):
        self.site = site
        self.kind = kind
        self.shape = shape


@dataclass
class HarvestFrame:
    label: str
    notes: List[_Note] = field(default_factory=list)
    rows_per_s: Optional[float] = None
    num_examples: Optional[int] = None
    #: kernel builds and cuFFT plans created while the node forced — a
    #: cold wall is recorded but never anchors or scores drift.
    compiles: int = 0


_frames = threading.local()


def _frame_stack() -> List[HarvestFrame]:
    stack = getattr(_frames, "stack", None)
    if stack is None:
        stack = []
        _frames.stack = stack
    return stack


def push_frame(label: str) -> HarvestFrame:
    frame = HarvestFrame(label)
    _frame_stack().append(frame)
    return frame


def pop_frame(frame: HarvestFrame) -> HarvestFrame:
    stack = _frame_stack()
    if stack and stack[-1] is frame:
        stack.pop()
    elif frame in stack:  # defensive: unwind past it
        while stack and stack.pop() is not frame:
            pass
    return frame


def current_frame() -> Optional[HarvestFrame]:
    stack = getattr(_frames, "stack", None)
    return stack[-1] if stack else None


def note_launch(site: str, kind: Optional[str], **shape: Any) -> None:
    """Launch sites call this as they launch so the enclosing node's
    harvest frame can attribute flop/byte facts to it (resolved at
    finalize by :func:`harvest_cost_facts`, after the node's wall is
    measured: an ELL launch's stored-block count is read back from the
    card only then). A single thread-local read when no frame is active
    (serving hot paths never pay more)."""
    frame = current_frame()
    if frame is None:
        return
    frame.notes.append(_Note(site, kind, shape))


def note_stream_result(
    rows_per_s: Optional[float], num_examples: Optional[int] = None
) -> None:
    """The streaming fold reports its achieved throughput so a
    rows/s-denominated prediction (MeasuredKnobRule's chunk winner) can
    be drift-scored in its own unit."""
    frame = current_frame()
    if frame is None:
        return
    frame.rows_per_s = rows_per_s
    frame.num_examples = num_examples


def note_lease_result(
    name: str,
    kind: str,
    predicted_s: Optional[float],
    measured_s: Optional[float],
    source: str,
) -> None:
    """The mesh scheduler joins a retired lease's predicted wall (by
    pricing provenance — tune/store/roofline/default) to the wall it
    measured, inside whatever harvest frame is open."""
    frame = current_frame()
    if frame is None:
        return
    leases = getattr(frame, "leases", None)
    if leases is None:
        leases = frame.leases = []  # type: ignore[attr-defined]
    leases.append(
        {
            "name": name,
            "kind": kind,
            "predicted_s": predicted_s,
            "measured_s": measured_s,
            "source": source,
        }
    )


# --------------------------------------------------------------- the sentinel


class DriftSentinel:
    """Noise-tolerant measured-vs-expected watchdog per (key, shape),
    copied from the JAX package.

    - ``rows_per_s`` predictions (MeasuredKnobRule's stream winners) are
      scored directly: ``predicted_rate / achieved_rate``.
    - ``seconds`` predictions (autocache's linear fits) baseline on
      reality: the first warm execution in this process writes
      ``measured_wall_s`` onto the backing ProfileStore entry, and later
      fits are scored ``measured / baseline``.

    Compound-key predictions (a fused chain summing member claims) are
    never scored. One out-of-band observation is noise; ``sustain``
    consecutive ones are drift. Firing publishes
    ``keystone_cost_drift_events_total``, records a ``cost_drift``
    recovery-ledger event, marks the backing entry ``stale:`` and resets
    the streak."""

    BASELINE_FIELD = "measured_wall_s"

    def __init__(self):
        self._lock = threading.Lock()
        self._streak: Dict[Tuple[str, str], int] = {}
        #: (key, shape) already observed by THIS process: the first sight
        #: re-bases the stored baseline instead of scoring it.
        self._seen: set = set()
        self.events: List[Dict[str, Any]] = []

    def observe(
        self,
        node: str,
        prediction: Prediction,
        measured_s: Optional[float] = None,
        measured_rate: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        if (
            not drift_enabled()
            or not prediction.calibrated
            or not prediction.key
            or "," in prediction.key  # compound: unattributable
        ):
            return None
        from . import store as _store

        store = _store.get_store()
        if store is None:
            return None  # the sentinel rides the store (its marks live there)
        m = store.lookup(prediction.key, prediction.shape, include_stale=True)
        if m is None or _store.is_stale(m):
            return None  # evicted, or already flagged and awaiting re-measure

        base: Optional[float] = None
        ident = (prediction.key, prediction.shape)
        if prediction.rows_per_s and measured_rate:
            ratio = prediction.rows_per_s / max(measured_rate, 1e-12)
        elif prediction.seconds is not None and measured_s:
            base = m.get(self.BASELINE_FIELD)
            with self._lock:
                first_sight = ident not in self._seen
                self._seen.add(ident)
            if (
                first_sight
                or not isinstance(base, (int, float))
                or base <= 0
            ):
                baselined = dict(m)
                baselined[self.BASELINE_FIELD] = round(measured_s, 6)
                store.record(prediction.key, prediction.shape, **baselined)
                _names.metric(_names.COST_DRIFT_RATIO).set(
                    1.0, model=prediction.model
                )
                return None
            base = float(base)
            ratio = measured_s / base
        else:
            return None

        tol = drift_ratio_tolerance()
        _names.metric(_names.COST_DRIFT_RATIO).set(
            ratio, model=prediction.model
        )
        out_of_band = max(ratio, 1.0 / max(ratio, 1e-12)) > tol
        with self._lock:
            if not out_of_band:
                self._streak.pop(ident, None)
                # In-band observations smooth the baseline toward current
                # reality (EMA): the sentinel hunts regime changes, not creep.
                if (
                    base is not None
                    and measured_s
                    and abs(measured_s - float(base)) > 0.05 * float(base)
                ):
                    smoothed = dict(m)
                    smoothed[self.BASELINE_FIELD] = round(
                        0.7 * float(base) + 0.3 * measured_s, 6
                    )
                    store.record(
                        prediction.key, prediction.shape, **smoothed
                    )
                return None
            streak = self._streak.get(ident, 0) + 1
            if streak < drift_sustain():
                self._streak[ident] = streak
                return None
            self._streak.pop(ident, None)
        return self._fire(node, prediction, ratio)

    def _fire(
        self, node: str, prediction: Prediction, ratio: float
    ) -> Dict[str, Any]:
        event = {
            "node": node,
            "model": prediction.model,
            "key": prediction.key,
            "shape": prediction.shape,
            "ratio": round(ratio, 4),
            "stale_marked": False,
        }
        _names.metric(_names.COST_DRIFT_EVENTS).inc(model=prediction.model)
        if prediction.key:
            try:
                from . import store as _store

                store = _store.get_store()
                if store is not None:
                    marked = [
                        store.mark_stale(
                            key, prediction.shape, reason="cost_drift"
                        )
                        for key in prediction.key.split(",")
                    ]
                    event["stale_marked"] = any(marked)
            except Exception:
                pass
        try:
            # The recovery ledger is the event bus the flight recorder
            # rings — a drift lands in every post-mortem dump.
            from ..reliability.recovery import get_recovery_log

            get_recovery_log().record(
                "cost_drift", node,
                model=prediction.model, key=prediction.key,
                shape=prediction.shape, ratio=event["ratio"],
                stale_marked=event["stale_marked"],
            )
        except Exception:
            pass
        _spans.add_span_event("cost_drift", **event)
        with self._lock:
            self.events.append(event)
            del self.events[:-64]
        logger.warning(
            "cost-model drift: %s predicted %s under %s ratio=%.2f "
            "(entry %smarked stale)", prediction.model, node,
            prediction.key or "<unkeyed>", ratio,
            "" if event["stale_marked"] else "NOT ",
        )
        return event

    def seen_count(self) -> int:
        """Keys this process has observed (and therefore re-based)."""
        with self._lock:
            return len(self._seen)


_sentinel = DriftSentinel()


def get_drift_sentinel() -> DriftSentinel:
    return _sentinel


# ------------------------------------------------------------------- finalize


def _label_of(op: Any) -> str:
    return str(getattr(op, "label", type(op).__name__))


def _sum_predictions(labels: Sequence[str]) -> Optional[Prediction]:
    resolved = [plan_prediction(m) for m in labels]
    parts = [p for p in resolved if p is not None and p.seconds is not None]
    if not parts:
        return None
    # Calibrated only with FULL member coverage (the JAX package's rule).
    complete = len(parts) == len(labels)
    return Prediction(
        model=parts[0].model,
        key=",".join(p.key for p in parts if p.key),
        shape=parts[0].shape,
        seconds=sum(p.seconds for p in parts),
        calibrated=complete and all(p.calibrated for p in parts),
        source=parts[0].source,
    )


def _resolve_prediction(op: Any, label: str) -> Optional[Prediction]:
    pinned = getattr(op, "predicted_cost", None)
    if isinstance(pinned, Prediction):
        return pinned
    # Fused chains: the autocache profiler predicted the MEMBERS; their
    # per-node claims sum to the chain's (same work, one dispatch).
    members = getattr(op, "member_labels", None)
    if members:
        return _sum_predictions(list(members))
    # A streaming absorb replaced estimator + featurize members with one
    # node: their plan-book claims sum the same way.
    estimator = getattr(op, "estimator", None)
    absorbed = getattr(op, "members", None)
    if estimator is not None and absorbed is not None:
        pinned = getattr(estimator, "predicted_cost", None)
        if isinstance(pinned, Prediction):
            return pinned
        return _sum_predictions(
            [_label_of(estimator)] + [_label_of(m) for m in absorbed]
        )
    return plan_prediction(label)


def finalize_node(
    label: str,
    seconds: float,
    synced: bool,
    op: Any = None,
    span: Any = None,
    frame: Optional[HarvestFrame] = None,
) -> Optional[PerfLedgerEntry]:
    """Close one node's harvest: resolve noted launches to flop/byte
    facts, place them against the roofline, join the prediction that
    drove the plan, drift-score it, and land the ledger entry (plus span
    attributes for the trace view). Called by ``timed_execute`` AFTER the
    wall measurement. Never raises."""
    try:
        return _finalize_node(label, seconds, synced, op, span, frame)
    except Exception as e:
        logger.debug("cost finalize failed for %s (%s)", label, e)
        return None


def _harvest_frame(frame: Optional[HarvestFrame]):
    """(flops by kind, bytes, per-site totals) of a frame's notes."""
    flops_by_kind: Dict[str, float] = {}
    bytes_total: Optional[float] = None
    sites: Dict[str, Dict[str, float]] = {}
    for note in frame.notes if frame is not None else ():
        facts = harvest_cost_facts(note.site, note.kind, note.shape)
        note.shape = {}  # drop tensor refs promptly
        if facts is None:
            continue
        name = note.site if note.site != "gemm" else f"gemm:{note.kind}"
        site = sites.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        site["launches"] += 1
        if facts.flops is not None:
            kind = _PRICED_AS.get(facts.kind or "", facts.kind) or "ieee_fp32"
            flops_by_kind[kind] = flops_by_kind.get(kind, 0.0) + facts.flops
            site["flops"] += facts.flops
        if facts.bytes_accessed is not None:
            bytes_total = (bytes_total or 0.0) + facts.bytes_accessed
            site["bytes"] += facts.bytes_accessed
    return flops_by_kind, bytes_total, sites


def _finalize_node(label, seconds, synced, op, span, frame):
    prediction = _resolve_prediction(op, label) if op is not None else (
        plan_prediction(label)
    )
    if not (frame is not None and frame.notes) and prediction is None and not _record_all:
        return None

    flops_by_kind, bytes_total, sites = _harvest_frame(frame)
    flops_total = sum(flops_by_kind.values()) if flops_by_kind else None
    intensity = (
        flops_total / bytes_total if flops_total and bytes_total else None
    )
    roofline = get_roofline() if (flops_total or bytes_total) else _roofline
    classification = floor_s = None
    if roofline is not None:
        classification, floor_s = roofline.place(flops_by_kind, bytes_total)

    flops_per_s = bytes_per_s = bound_frac = None
    if synced and seconds > 0:
        if flops_total:
            flops_per_s = flops_total / seconds
        if bytes_total:
            bytes_per_s = bytes_total / seconds
        if classification is not None and floor_s:
            # The share of its roofline the node reached: its floor at
            # the peaks of the kinds it ran at, over what it took.
            bound_frac = floor_s / seconds

    predicted_s = predicted_model = None
    predicted_key = predicted_shape = ""
    calibrated = False
    predicted_candidates: Tuple = ()
    ratio = None
    drift = False
    cold = frame is not None and frame.compiles > 0
    if prediction is not None:
        predicted_model = prediction.model
        predicted_key = prediction.key
        predicted_shape = prediction.shape
        calibrated = prediction.calibrated
        predicted_candidates = tuple(getattr(prediction, "candidates", ()))
        if prediction.seconds is not None:
            predicted_s = prediction.seconds
        elif (
            prediction.rows_per_s
            and frame is not None
            and frame.num_examples
        ):
            predicted_s = frame.num_examples / prediction.rows_per_s
        if prediction.rows_per_s and frame is not None and frame.rows_per_s:
            ratio = prediction.rows_per_s / max(frame.rows_per_s, 1e-12)
        elif prediction.seconds and synced and seconds > 0:
            ratio = seconds / prediction.seconds
        if not cold:
            drift = (
                _sentinel.observe(
                    label,
                    prediction,
                    measured_s=seconds if synced and seconds > 0 else None,
                    measured_rate=(
                        frame.rows_per_s if frame is not None else None
                    ),
                ) is not None
            )
    elif floor_s is not None:
        # No model claimed this node: the roofline's first-principles
        # floor is the displayed prediction (never drift-scored).
        predicted_s = floor_s
        predicted_model = "roofline"

    entry = PerfLedgerEntry(
        node=label,
        seconds=round(seconds, 6),
        synced=synced,
        cold=cold,
        t_s=time.perf_counter(),
        t_unix=round(time.time(), 6),
        flops=flops_total,
        bytes_accessed=bytes_total,
        intensity=intensity,
        flops_per_s=flops_per_s,
        bytes_per_s=bytes_per_s,
        roofline=classification,
        bound_frac=bound_frac,
        kinds=tuple(sorted(sites)),
        predicted_s=predicted_s,
        predicted_model=predicted_model,
        predicted_key=predicted_key,
        predicted_shape=predicted_shape,
        predicted_calibrated=calibrated,
        predicted_candidates=predicted_candidates,
        ratio=ratio,
        drift=drift,
        rows_per_s=frame.rows_per_s if frame is not None else None,
        flops_by_kind=flops_by_kind,
        sites=sites,
    )
    _ledger.record(entry)

    if span is not None:
        if flops_total is not None:
            span.set_attribute("flops", flops_total)
        if bytes_total is not None:
            span.set_attribute("bytes_accessed", bytes_total)
        if classification is not None:
            span.set_attribute("roofline", classification)
        if predicted_s is not None:
            span.set_attribute("predicted_s", round(predicted_s, 6))
            span.set_attribute("predicted_model", predicted_model)
    return entry


# Record-all mode: explain wants a ledger entry for EVERY executed plan
# node (host-side ops included), not just harvested/predicted ones.
_record_all = False


def record_all_nodes(value: bool) -> None:
    global _record_all
    _record_all = bool(value)


# ---------------------------------------------------------------------- reset


def reset_cost_observatory() -> None:
    """Testing hook: drop ledger entries, sentinel state, plan
    predictions and the cached roofline."""
    global _ledger, _sentinel, _record_all
    reset_plan_predictions()
    set_roofline(None)
    _ledger = PerfLedger()
    _sentinel = DriftSentinel()
    _record_all = False
