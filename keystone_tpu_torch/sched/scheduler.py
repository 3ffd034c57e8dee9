"""Cost-governed admission onto the serving card: train where you serve.

Port of ``keystone_tpu/sched/scheduler.py`` for one card: the "mesh" is
the one CUDA device the server and the background work share (the JAX
package's scheduler has no mesh-dependent code either: "mesh" there is
the shared device set).

Background work — refit daemon fold rounds, ``tune``
probes, sketched/Gram finish reductions — historically ran in separate
processes while serving devices idled between batches. The
:class:`MeshScheduler` co-locates them on one mesh under one cost model:

- every unit of background work arrives as a :class:`LeaseRequest` and
  is **priced before admission** (sched/pricing.py: tuned/measured
  ProfileStore rate, else the calibrated roofline, else a flat default);
- admission happens only into **predicted serving idle gaps**: the SLO
  controller's p99 headroom plus the supervisor's pending/backlog signal
  must both read idle, otherwise the lease is *deferred* (the rows stay
  in the tap; nothing is lost);
- an admitted fold carries its :class:`Lease` into the streaming engine,
  which consults :meth:`Lease.should_yield` at every chunk boundary —
  **sustained** SLO pressure (``sustain_checks`` consecutive pressured
  boundaries, so one slow batch never kills a fold) preempts the fold
  *at the boundary*: the durable cursor commits and the fold returns
  partial; the next admission resumes from the cursor, not from scratch
  (the durable fold, ``reliability/durable.py``, is the preemption
  mechanism);
- every lease lands in the schedule log — predicted vs measured wall,
  price provenance, who displaced it — which ``explain --schedule`` prints and the ``keystone_sched_*`` metric family
  aggregates.

Imports no torch at import time (the serving-package discipline):
pricing imports it lazily, and only when the cost observatory is
reachable.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..envknobs import env_disabled, env_float, env_int
from ..obs import names as _names
from ..obs import spans as _spans
from ..reliability.recovery import get_recovery_log
from .pricing import LeasePrice, choose_chunk_rows, price_stream_fold


@dataclass
class LeaseRequest:
    """One unit of background work asking for mesh time. ``rows`` x
    ``width`` x ``classes`` is the fold geometry pricing consumes;
    ``chain`` is the featurization chain class keying the ProfileStore."""

    name: str
    kind: str = "refit_fold"  # refit_fold | tune_probe | finish
    rows: int = 0
    width: int = 0
    classes: int = 0
    chain: str = "()"
    #: lease id this request resumes (a previously preempted fold).
    resume_of: Optional[str] = None


class Lease:
    """A priced admission onto the mesh. Handed to the streaming engine
    (``ChunkStream.lease``), which calls :meth:`should_yield` at chunk
    boundaries; everything else is scheduler-internal bookkeeping."""

    def __init__(
        self, scheduler: "MeshScheduler", request: LeaseRequest,
        price: LeasePrice, lease_id: str,
    ):
        self.scheduler = scheduler
        self.request = request
        self.price = price
        self.id = lease_id
        self.admitted = False
        self.state = "pending"  # pending|deferred|running|preempted|completed
        self.deferrals = 0
        self.displaced_by: Optional[str] = None
        self.preempted_at_chunk: Optional[int] = None
        self.admitted_t: Optional[float] = None
        self.measured_s: Optional[float] = None
        self.boundary_checks = 0
        self._pressure_streak = 0
        self._span_stack: Optional[contextlib.ExitStack] = None

    # ------------------------------------------------------- fold-side API
    def should_yield(self) -> bool:
        """Chunk-boundary check: yield only under *sustained* pressure —
        ``sustain_checks`` consecutive pressured boundaries."""
        self.boundary_checks += 1
        reason = self.scheduler.pressure_reason()
        if reason is None:
            self._pressure_streak = 0
            return False
        self._pressure_streak += 1
        if self._pressure_streak >= self.scheduler.sustain_checks:
            self.displaced_by = reason
            return True
        return False

    def mark_preempted(self, chunk_index: int) -> None:
        """The fold yielded at ``chunk_index`` (cursor committed by the
        stream before this call)."""
        self.preempted_at_chunk = int(chunk_index)
        self.state = "preempted"

    def predicted_vs_measured_ratio(self) -> Optional[float]:
        if self.measured_s is None or not self.price.seconds:
            return None
        return self.measured_s / self.price.seconds


class MeshScheduler:
    """Admission + preemption authority for one mesh's background work.

    ``slo`` is an :class:`~keystone_tpu_torch.serving.slo.SLOController`
    (or anything with ``headroom()``/``stats()``); ``backlog_fn`` returns
    the serving backlog (supervisor ``backlog()`` or a server queue
    depth). Either may be None — an absent signal reads as idle, so the
    scheduler degrades to "always admit" instead of wedging work.
    ``device`` is the card the work runs on: pricing's roofline and the
    chunk policy's residency budget read it (None: this process's
    platform).
    """

    def __init__(
        self,
        slo: Any = None,
        backlog_fn: Optional[Callable[[], int]] = None,
        store: Any = None,
        clock: Callable[[], float] = time.monotonic,
        name: str = "mesh",
        sustain_checks: Optional[int] = None,
        headroom_floor: Optional[float] = None,
        backlog_limit: Optional[int] = None,
        device: Any = None,
    ):
        self.slo = slo
        self.device = device
        self.backlog_fn = backlog_fn
        self.store = store
        self.clock = clock
        self.name = name
        self.sustain_checks = (
            sustain_checks
            if sustain_checks is not None
            else env_int("KEYSTONE_SCHED_SUSTAIN_CHECKS", 2)
        )
        self.headroom_floor = (
            headroom_floor
            if headroom_floor is not None
            else env_float("KEYSTONE_SCHED_HEADROOM_FLOOR", 0.25)
        )
        self.backlog_limit = (
            backlog_limit
            if backlog_limit is not None
            else env_int("KEYSTONE_SCHED_BACKLOG_LIMIT", 8)
        )
        self._forced_pressure: Optional[bool] = None
        self._seed_countdown: Optional[int] = None
        self._lock = threading.Lock()
        self._seq = 0
        self._log: List[Dict[str, Any]] = []
        self._idle_harvest_s = 0.0
        self._m_leases = _names.metric(_names.SCHED_LEASES)
        self._m_harvest = _names.metric(_names.SCHED_IDLE_HARVEST_SECONDS)
        self._m_ratio = _names.metric(_names.SCHED_LEASE_WALL_RATIO)

    # ----------------------------------------------------------- pressure
    def force_pressure(self, value: Optional[bool]) -> None:
        """Deterministic override for tests/demos (None restores the
        live signals) — the faultinject-style seeding door the smoke
        script drives a preemption through."""
        self._forced_pressure = value

    def seed_pressure_after(self, checks: Optional[int]) -> None:
        """Deterministic mid-fold preemption door (demos/tests): the
        next ``checks`` pressure consultations read idle — enough for
        admission and the first chunk boundaries — then every later one
        reads pressured, until cleared with None. Makes "SLO pressure
        arrives while the fold is running" reproducible without racing
        real traffic against chunk timing."""
        self._seed_countdown = checks

    def pressure_reason(self) -> Optional[str]:
        """None when the mesh reads idle, else a human string naming the
        displacer — recorded on deferred/preempted leases so the
        schedule answers "what displaced this?"."""
        if self._seed_countdown is not None:
            self._seed_countdown -= 1
            if self._seed_countdown < 0:
                return "seeded pressure (mid-fold)"
            return None
        if self._forced_pressure is not None:
            return "forced pressure (seeded)" if self._forced_pressure else None
        if self.slo is not None:
            try:
                rung = int(getattr(self.slo.admission, "rung_index", 0))
            except Exception:
                rung = 0
            if rung > 0:
                return f"serving-slo rung_index={rung}"
            headroom = getattr(self.slo, "headroom", None)
            if callable(headroom):
                h = headroom()
                if h is not None and h < self.headroom_floor:
                    return (
                        f"serving-slo headroom {h:.2f} < "
                        f"{self.headroom_floor:.2f}"
                    )
        if self.backlog_fn is not None:
            try:
                backlog = int(self.backlog_fn())
            except Exception:
                backlog = 0
            if backlog > self.backlog_limit:
                return f"serving backlog {backlog} > {self.backlog_limit}"
        return None

    def pressure(self) -> bool:
        return self.pressure_reason() is not None

    # ---------------------------------------------------------- admission
    def submit(
        self,
        request: LeaseRequest,
        wait_s: float = 0.0,
        poll_s: Optional[float] = None,
    ) -> Lease:
        """Price ``request`` and admit it into the current idle gap.
        Under pressure the lease is *deferred*: with ``wait_s`` budget it
        polls for a gap, otherwise it returns un-admitted (caller keeps
        its rows and retries on its own cadence)."""
        price = price_stream_fold(
            request.rows, request.width, request.classes,
            chain=request.chain, store=self.store, device=self.device,
        )
        with self._lock:
            self._seq += 1
            lease = Lease(self, request, price, f"{self.name}-{self._seq}")
        poll = (
            poll_s if poll_s is not None
            else env_float("KEYSTONE_SCHED_DEFER_POLL_S", 0.05)
        )
        deadline = self.clock() + max(wait_s, 0.0)
        while True:
            reason = self.pressure_reason()
            if reason is None:
                return self._admit(lease)
            if lease.deferrals == 0:
                # Count the deferral once per submit, not per poll.
                lease.state = "deferred"
                lease.displaced_by = reason
                self._m_leases.inc(kind=request.kind, outcome="deferred")
                get_recovery_log().record(
                    "sched_defer", request.name,
                    lease=lease.id, work=request.kind,
                    displaced_by=reason,
                    predicted_s=price.seconds, price_source=price.source,
                )
            lease.deferrals += 1
            if self.clock() >= deadline:
                self._append_log(lease)
                return lease
            time.sleep(poll)  # lock-free admission backoff

    def _admit(self, lease: Lease) -> Lease:
        request, price = lease.request, lease.price
        lease.admitted = True
        lease.state = "running"
        lease.admitted_t = self.clock()
        self._m_leases.inc(kind=request.kind, outcome="admitted")
        event = "sched_resume" if request.resume_of else "sched_admit"
        get_recovery_log().record(
            event, request.name,
            lease=lease.id, work=request.kind,
            predicted_s=price.seconds, price_source=price.source,
            roofline=price.roofline, rows=request.rows,
            deferrals=lease.deferrals,
            **(
                {"resume_of": request.resume_of}
                if request.resume_of else {}
            ),
        )
        if request.resume_of:
            self._m_leases.inc(kind=request.kind, outcome="resumed")
        # The lease span carries the cost provenance: the trace shows
        # WHY this work was allowed to run where it ran.
        lease._span_stack = contextlib.ExitStack()
        lease._span_stack.enter_context(
            _spans.span(
                "sched:lease",
                lease=lease.id, work=request.name, kind=request.kind,
                predicted_s=price.seconds or 0.0,
                price_source=price.source,
                roofline=price.roofline or "unknown",
                rows=request.rows, deferrals=lease.deferrals,
            )
        )
        return lease

    def release(self, lease: Lease) -> None:
        """The leased work returned (complete or preempted): join the
        measured wall to the prediction and retire the lease."""
        if lease.admitted and lease.admitted_t is not None:
            lease.measured_s = self.clock() - lease.admitted_t
        if lease._span_stack is not None:
            lease._span_stack.close()
            lease._span_stack = None
        kind = lease.request.kind
        if lease.preempted_at_chunk is not None:
            self._m_leases.inc(kind=kind, outcome="preempted")
            get_recovery_log().record(
                "sched_preempt", lease.request.name,
                lease=lease.id, work=kind,
                chunk_index=lease.preempted_at_chunk,
                displaced_by=lease.displaced_by,
                measured_s=lease.measured_s,
            )
        elif lease.admitted:
            lease.state = "completed"
            self._m_leases.inc(kind=kind, outcome="completed")
        if lease.admitted and lease.measured_s is not None:
            with self._lock:
                self._idle_harvest_s += lease.measured_s
            self._m_harvest.inc(lease.measured_s)
            if lease.price.seconds:
                self._m_ratio.observe(
                    lease.measured_s / lease.price.seconds,
                    source=lease.price.source,
                )
            try:
                from ..obs.cost import note_lease_result

                note_lease_result(
                    lease.request.name, kind, lease.price.seconds,
                    lease.measured_s, lease.price.source,
                )
            except Exception:
                pass  # the observatory is evidence, never a failure path
        self._append_log(lease)

    @contextlib.contextmanager
    def lease(self, request: LeaseRequest, wait_s: float = 0.0):
        """``with scheduler.lease(req) as lease:`` — admit (or defer),
        run, release. Yields None when the lease stayed deferred."""
        handle = self.submit(request, wait_s=wait_s)
        if not handle.admitted:
            yield None
            return
        try:
            yield handle
        finally:
            self.release(handle)

    # ------------------------------------------------------- chunk policy
    def chunk_rows_for(
        self, rows: int, width: int, classes: int,
        chain: str = "()", default: Optional[int] = None,
    ) -> Tuple[int, int, str]:
        """Chunk geometry for a scheduled fold (pricing ladder: tuned
        entry wins, else roofline placement)."""
        return choose_chunk_rows(
            rows, width, classes, chain=chain, store=self.store,
            default=default, device=self.device,
        )

    # ------------------------------------------------------------- report
    def _append_log(self, lease: Lease) -> None:
        entry = {
            "lease": lease.id,
            "name": lease.request.name,
            "kind": lease.request.kind,
            "rows": lease.request.rows,
            "outcome": lease.state,
            "deferrals": lease.deferrals,
            "price": lease.price.to_json(),
            "predicted_s": lease.price.seconds,
            "measured_s": lease.measured_s,
        }
        if lease.displaced_by:
            entry["displaced_by"] = lease.displaced_by
        if lease.preempted_at_chunk is not None:
            entry["preempted_at_chunk"] = lease.preempted_at_chunk
        if lease.request.resume_of:
            entry["resume_of"] = lease.request.resume_of
        if lease.predicted_vs_measured_ratio() is not None:
            entry["ratio"] = round(lease.predicted_vs_measured_ratio(), 4)
        with self._lock:
            self._log.append(entry)

    def schedule(self) -> List[Dict[str, Any]]:
        """The lease log, oldest first — what ``explain --schedule``
        renders: who ran on the mesh, what was displaced or deferred,
        predicted vs measured wall per lease."""
        with self._lock:
            return [dict(e) for e in self._log]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            log = list(self._log)
            harvest = self._idle_harvest_s
        outcomes: Dict[str, int] = {}
        for e in log:
            outcomes[e["outcome"]] = outcomes.get(e["outcome"], 0) + 1
        return {
            "name": self.name,
            "leases": len(log),
            "outcomes": outcomes,
            "idle_harvest_s": round(harvest, 6),
            "pressure": self.pressure(),
        }


# ------------------------------------------------------- pressure cadence


def pressure_aware_interval(
    base_s: float,
    tap_fill_frac: float,
    pressure: bool,
    min_s: Optional[float] = None,
    max_s: Optional[float] = None,
) -> float:
    """The refit daemon's sleep, driven by the two live signals instead
    of a fixed knob: a tap filling toward its drop-oldest bound shrinks
    the interval (drain sooner — dropped rows are unrecoverable), SLO
    pressure doubles it (serving owns the mesh right now). Pure in its
    inputs — the deterministic-clock unit test pins the shape."""
    lo = min_s if min_s is not None else base_s / 8.0
    hi = max_s if max_s is not None else base_s * 4.0
    frac = min(max(float(tap_fill_frac), 0.0), 1.0)
    interval = base_s * (1.0 - frac)
    if pressure:
        interval = max(interval, base_s) * 2.0
    return min(max(interval, lo), hi)


# ------------------------------------------------------------ module global

_scheduler: Optional[MeshScheduler] = None
_scheduler_lock = threading.Lock()


def set_scheduler(scheduler: Optional[MeshScheduler]) -> None:
    global _scheduler
    with _scheduler_lock:
        _scheduler = scheduler


def get_scheduler() -> Optional[MeshScheduler]:
    """The process's mesh scheduler, or None (unscheduled paths are
    byte-for-byte the old behavior). ``KEYSTONE_SCHED=off`` disables
    even an installed scheduler."""
    if env_disabled("KEYSTONE_SCHED"):
        return None
    with _scheduler_lock:
        return _scheduler


@contextlib.contextmanager
def maybe_lease(
    name: str, kind: str, rows: int = 0, width: int = 0, classes: int = 0,
    chain: str = "()", wait_s: float = 0.0,
):
    """Lease mesh time when a scheduler is installed; a no-op (yields
    None) otherwise — how tune probes and finish reductions opt in
    without taking a hard dependency on the scheduler."""
    scheduler = get_scheduler()
    if scheduler is None:
        yield None
        return
    with scheduler.lease(
        LeaseRequest(
            name=name, kind=kind, rows=rows, width=width,
            classes=classes, chain=chain,
        ),
        wait_s=wait_s,
    ) as lease:
        yield lease
