"""The refit daemon: tap → fold → shadow-eval → publish → watch, forever.

Port of ``keystone_tpu/refit/daemon.py`` on one device. One round
(:meth:`RefitDaemon.run_once` — the deterministic, testable unit the
supervised loop repeats):

    tap.drain ──► split train/eval ──► fit_stream(state=…)  [refit.fold]
                        │                    │
                        │              export + persist state
                        ▼                    ▼
                  shadow.compare ◄──── candidate
                        │ fail → refit_skip (ledger) → done
                        │ pass
                        ▼
                  [refit.candidate] ──► publisher.publish  [refit.publish]
                        ▼
                  watch window: live score on held-back rows +
                  serving stats (failures, p99)
                        │ regression → publisher.rollback (ledger)
                        ▼
                  publisher.settle() — plan baseline restamped

The fold EXTENDS the persisted sufficient statistics (refit/state.py)
through the chunked ``fit_stream`` plan — the incremental cost is O(new
rows), never O(all rows ever seen). Rows absorbed into the state stay
absorbed even when a candidate is skipped or rolled back: the DATA was
real; it was the published MODEL that regressed.

The fold runs on the daemon's thread while the server applies on its
batch thread, both on the estimator's device; ``fold_s`` is read after a
``torch.cuda.synchronize()`` on the daemon's thread, so it holds the
device work of the fold and the finish solve.

Supervision: ``start()`` runs rounds on ``interval_s`` in a watched
daemon thread; a crashing round lands in the recovery ledger
(``refit_round_error``) and the loop keeps going until
``max_consecutive_failures`` rounds fail back to back
(``refit_daemon_failed``).

Durability: with a store attached, each round journals its drained rows
+ pre-fold state before folding and advances the phase as it commits,
so a kill anywhere mid-round replays from the journal — exactly once —
instead of losing rows the tap no longer holds; a batch whose replay
fails ``max_journal_replays`` times is discarded. The quality plane's
label-join state is persisted with the round.

Chaos surface: ``refit.fold`` faults the incremental fold,
``refit.candidate`` intercepts the candidate AFTER shadow eval and
before publish (a ``corrupt`` spec here is the seeded bad candidate the
watch window rolls back), ``refit.publish`` faults the swap itself.

Under a ``scheduler=`` (``sched/scheduler.py``, one card) each round is
a cost-priced lease: admitted only into serving idle gaps (else the round
is ``deferred`` and the rows stay in the tap), preempted at a chunk
boundary under sustained pressure — the durable cursor commits, the batch
is parked in the journal as a planned resume (its replay budget
untouched), and the next admitted round resumes the fold from the cursor
— and the loop's cadence follows the tap's fill and the pressure.

``partition=`` takes a partitioner decision (``Partitioner().decide_stream``)
and hands it to every round's fold: an eligible one runs the sharded
chunk plan, durable and elastic as any sharded fold.

The module also carries the synthetic drifting-workload closed loop
behind ``python -m keystone_tpu_torch refit`` (:func:`run_refit_demo`).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..envknobs import env_flag, env_float, env_int, env_str
from ..obs import names as _names
from ..obs import spans as _spans
from ..obs.flight import install_flight_recorder
from ..obs.quality import get_quality_plane
from ..reliability import faultinject
from ..reliability.checkpoint import _MISS
from ..reliability.faultinject import probe
from ..reliability.recovery import get_recovery_log
from .shadow import ShadowEvaluator, _predict
from .state import StreamState, load_stream_state, save_stream_state
from .tap import TrafficTap


@dataclass
class RefitConfig:
    """Knobs for one :class:`RefitDaemon` (env defaults via envknobs)."""

    name: str = "default"
    #: seconds between supervised rounds (KEYSTONE_REFIT_INTERVAL_S).
    interval_s: float = field(default_factory=lambda: env_float("KEYSTONE_REFIT_INTERVAL_S", 30.0))
    #: don't fold until this many labeled rows accumulated
    #: (KEYSTONE_REFIT_MIN_ROWS) — tiny folds are all overhead.
    min_rows: int = field(default_factory=lambda: env_int("KEYSTONE_REFIT_MIN_ROWS", 256))
    #: cap per-round drain (bounds fold wall under a backlog).
    max_rows_per_round: int = 65536
    #: chunk rows for the incremental fold (KEYSTONE_REFIT_CHUNK_ROWS).
    chunk_rows: int = field(default_factory=lambda: env_int("KEYSTONE_REFIT_CHUNK_ROWS", 1024))
    #: freshest fraction of each drain held OUT of training for shadow
    #: eval + the post-publish watch window.
    eval_fraction: float = 0.25
    #: shadow gate: candidate passes at incumbent score - margin
    #: (KEYSTONE_REFIT_MARGIN).
    margin: float = field(default_factory=lambda: env_float("KEYSTONE_REFIT_MARGIN", 0.02))
    #: watch gate: live score under incumbent - watch_margin rolls back
    #: (KEYSTONE_REFIT_WATCH_MARGIN).
    watch_margin: float = field(default_factory=lambda: env_float("KEYSTONE_REFIT_WATCH_MARGIN", 0.05))
    #: watch rule (KEYSTONE_REFIT_WATCH_GATE): ``margin`` is the fixed
    #: floor above; ``sequential`` feeds per-row live-vs-incumbent scores
    #: into an anytime-valid test (obs/quality.py SequentialGate) and
    #: rolls back only on a significant regression at ``gate_alpha``.
    watch_gate: str = field(default_factory=lambda: env_str("KEYSTONE_REFIT_WATCH_GATE", "margin"))
    #: sequential-watch false-positive bound (KEYSTONE_REFIT_GATE_ALPHA).
    gate_alpha: float = field(default_factory=lambda: env_float("KEYSTONE_REFIT_GATE_ALPHA", 0.05))
    #: sequential-watch sample budget (KEYSTONE_REFIT_GATE_MAX_SAMPLES).
    gate_max_samples: int = field(default_factory=lambda: env_int("KEYSTONE_REFIT_GATE_MAX_SAMPLES", 512))
    #: let the quality plane's drift detector shrink ``state_decay``
    #: under detected score drift (KEYSTONE_REFIT_ADAPTIVE_DECAY).
    adaptive_decay: bool = field(default_factory=lambda: env_flag("KEYSTONE_REFIT_ADAPTIVE_DECAY", False))
    #: watch gate: post-publish serving p99 above this rolls back
    #: (None = score-only watch).
    watch_max_p99_ms: Optional[float] = None
    #: exponential forgetting applied to the stored statistics before
    #: each fold (KEYSTONE_REFIT_STATE_DECAY; 1.0 = remember everything).
    state_decay: float = field(default_factory=lambda: env_float("KEYSTONE_REFIT_STATE_DECAY", 1.0))
    #: mirror rows handed to shadow eval per round.
    mirror_rows: int = 256
    #: supervised-loop restart budget.
    max_consecutive_failures: int = 5
    #: round-journal replay budget: a journaled batch that fails this
    #: many replays is DISCARDED (refit_journal_discard).
    max_journal_replays: int = 3
    #: scheduled-path chunk policy: under a MeshScheduler, let the
    #: roofline placement (or a tuned ProfileStore entry) choose
    #: chunk_rows instead of the static default (KEYSTONE_SCHED_AUTO_CHUNKS).
    auto_chunk_rows: bool = field(default_factory=lambda: env_flag("KEYSTONE_SCHED_AUTO_CHUNKS", False))
    #: cursor cadence for SCHEDULED folds (chunks between commits): the
    #: preemption contract needs a committable cursor even on small folds.
    sched_ckpt_every: int = field(default_factory=lambda: env_int("KEYSTONE_SCHED_CKPT_EVERY", 1))
    #: persisted-state key in the checkpoint store.
    state_key: str = "refit-state"


class RefitDaemon:
    """Supervised incremental-retrain loop over a traffic tap."""

    def __init__(
        self,
        estimator: Any,
        tap: TrafficTap,
        publisher: Any,
        store: Any = None,
        shadow: Optional[ShadowEvaluator] = None,
        config: Optional[RefitConfig] = None,
        partition: Any = None,
        state: Optional[StreamState] = None,
        scheduler: Any = None,
    ):
        self.estimator = estimator
        #: PartitionDecision for each round's fold (None: one device).
        self.partition = partition
        #: optional sched.MeshScheduler: rounds become cost-priced leases
        #: (module docstring).
        self.scheduler = scheduler
        self._last_preempted_chunk: Optional[int] = None
        self.tap = tap
        self.publisher = publisher
        #: reliability CheckpointStore for the stream state (None = the
        #: state lives only in this process).
        self.store = store
        self.shadow = shadow or ShadowEvaluator()
        self.config = config or RefitConfig()
        if self.shadow.margin == 0.0:
            self.shadow.margin = self.config.margin
        self._state: Optional[StreamState] = state
        if self._state is None and store is not None:
            self._state = load_stream_state(store, self.config.state_key)
        self._rounds = 0
        #: decay the last fold actually applied (== config.state_decay
        #: unless adaptive_decay let the drift detector shrink it).
        self.applied_decay: float = self.config.state_decay
        #: the candidate the last fold produced (None before any fold).
        self.last_candidate: Any = None
        #: join token of the last watch window whose label join was
        #: persisted — a journal replay with a matching token skips the
        #: re-join (exactly-once across kills).
        self._joined_token: Optional[str] = None
        if store is not None:
            saved = store.lookup(None, digest=self._quality_state_key())
            if saved is not _MISS and isinstance(saved, dict):
                get_quality_plane().restore(self.config.name, saved.get("state"))
                self._joined_token = saved.get("token")
        # Always-on flight recorder (idempotent): a watch-window
        # rollback's ledger event dumps this process's post-mortem.
        install_flight_recorder("refit")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.outcomes: List[Dict[str, Any]] = []
        self._m_rounds = _names.metric(_names.REFIT_ROUNDS)
        self._m_state_rows = _names.metric(_names.REFIT_STATE_ROWS)
        self._m_fold_s = _names.metric(_names.REFIT_FOLD_SECONDS)
        self._m_score = _names.metric(_names.REFIT_SCORE)

    # ------------------------------------------------------------------ state
    @property
    def state(self) -> Optional[StreamState]:
        return self._state

    def state_rows(self) -> int:
        return int(self._state.num_examples) if self._state else 0

    # ------------------------------------------------------------------ round
    def run_once(self) -> str:
        """One refit round; returns the outcome (``published`` |
        ``skipped_nodata`` | ``skipped_eval`` | ``rolled_back``).
        Exceptions propagate — the supervised loop owns the error ledger.
        Under an active trace session the whole round is one
        ``refit:round`` span tree."""
        with self._lock:  # one fold at a time; state is read-modify-write
            with _spans.span("refit:round", round=self._rounds + 1, daemon=self.config.name) as round_span:
                outcome = self._run_once_locked()
                round_span.set_attribute("outcome", outcome)
                return outcome

    def _run_once_locked(self) -> str:
        self._rounds += 1
        round_index = self._rounds
        journal = self._load_journal()
        if journal is not None and journal.get("deferred"):
            # A scheduler preemption parked this batch mid-fold: a PLANNED
            # resume, not a crash replay — the attempts budget is
            # untouched. Re-admission goes back through the scheduler; a
            # still-pressured card keeps the batch parked.
            lease = self._acquire_lease(
                round_index, rows=int(journal["x"].shape[0]), resume_of=journal.get("lease"),
            )
            if lease is not None and not lease.admitted:
                return self._outcome(
                    "deferred", round_index, keep_journal=True,
                    rows=int(journal["x"].shape[0]), displaced_by=lease.displaced_by,
                )
            journal.pop("deferred", None)
            return self._resume_from_journal(journal, round_index, lease=lease)
        if journal is not None:
            # A previous round died mid-flight: its rows survive in the
            # journal, not the tap. The replay budget is persisted BEFORE
            # the attempt (a crash mid-replay counts), so a batch whose
            # replay fails deterministically is dropped after
            # max_journal_replays instead of wedging every future round.
            attempts = int(journal.get("attempts", 0)) + 1
            if attempts > self.config.max_journal_replays:
                self._clear_journal()
                get_recovery_log().record(
                    "refit_journal_discard",
                    self.config.name,
                    attempts=attempts - 1,
                    rows=int(journal["x"].shape[0]),
                    round=round_index,
                )
            else:
                journal["attempts"] = attempts
                self._save_journal(journal)
                return self._resume_from_journal(journal, round_index)
        depth = self.tap.depth()
        if depth < self.config.min_rows:
            get_recovery_log().record(
                "refit_skip",
                self.config.name,
                reason="insufficient_rows",
                rows=depth,
                min_rows=self.config.min_rows,
                round=round_index,
            )
            return self._outcome("skipped_nodata", round_index, rows=depth)
        # Admission BEFORE drain: a deferred fresh round costs nothing —
        # the rows stay in the tap and the cadence retries sooner as it
        # fills.
        lease = self._acquire_lease(round_index, rows=min(depth, self.config.max_rows_per_round))
        if lease is not None and not lease.admitted:
            return self._outcome("deferred", round_index, rows=depth, displaced_by=lease.displaced_by)
        drained = self.tap.drain(self.config.max_rows_per_round)
        if drained is None:  # raced another drainer
            if lease is not None:
                self.scheduler.release(lease)
            return self._outcome("skipped_nodata", round_index, rows=0)
        x, y = drained
        return self._round_body(x, y, round_index, lease=lease)

    def _acquire_lease(self, round_index: int, rows: int, resume_of: Optional[str] = None):
        """Price this round's fold and ask the scheduler for card time
        (None when unscheduled)."""
        if self.scheduler is None:
            return None
        from ..sched.scheduler import LeaseRequest

        width = classes = 0
        if self._state is not None:
            meta = getattr(self._state, "meta", {}) or {}
            width = int(meta.get("d", 0) or 0)
            classes = int(meta.get("k", 0) or 0)
            carry = getattr(self._state, "carry", ())
            if not width and len(carry) > 1 and getattr(carry[1], "ndim", 0) == 2:
                # No estimator records d and k in the state's meta (the JAX
                # package's daemon then prices every fold one feature
                # wide); a Gram carry's AᵀY is (d, k).
                width, classes = (int(v) for v in carry[1].shape)
        return self.scheduler.submit(
            LeaseRequest(
                name=f"{self.config.name}:round-{round_index}",
                kind="refit_fold",
                rows=int(rows),
                width=width,
                classes=classes,
                resume_of=resume_of,
            )
        )

    # -------------------------------------------------------- round journal
    #
    # The drained rows plus the PRE-fold state are journaled in the store
    # before the fold runs, and the phase advances to "folded" only after
    # the folded state is persisted — a kill anywhere inside a round
    # replays it exactly once, and a kill between the state save and the
    # phase advance rewinds to the pre-fold snapshot (re-folding the same
    # rows into extended statistics would double-count them).

    def _journal_key(self) -> str:
        return hashlib.sha1(f"keystone-refit-journal:{self.config.name}".encode()).hexdigest()

    def _quality_state_key(self) -> str:
        return hashlib.sha1(f"keystone-refit-quality:{self.config.name}".encode()).hexdigest()

    def _save_journal(self, payload: Dict[str, Any]) -> None:
        if self.store is not None:
            self.store.save(None, payload, digest=self._journal_key())

    def _load_journal(self) -> Optional[Dict[str, Any]]:
        if self.store is None:
            return None
        value = self.store.lookup(None, digest=self._journal_key())
        if value is _MISS or not isinstance(value, dict):
            return None
        return value if value.get("phase") in ("drained", "folded") else None

    def _clear_journal(self) -> None:
        if self.store is not None:
            self.store.delete(self._journal_key())

    def _resume_from_journal(self, journal: Dict[str, Any], round_index: int, lease: Any = None) -> str:
        phase = str(journal.get("phase"))
        get_recovery_log().record(
            "refit_journal_resume",
            self.config.name,
            phase=phase,
            journaled_round=int(journal.get("round", 0)),
            round=round_index,
            rows=int(journal["x"].shape[0]),
        )
        _names.metric(_names.DURABLE_RESUMES).inc(kind="refit_journal")
        if phase == "drained":
            # The fold may have half-applied: rewind to the journaled
            # pre-fold snapshot so the re-fold is exactly once. After a
            # scheduler deferral the re-fold is still cheap: the durable
            # cursor (armed in _fold) holds the committed prefix.
            self._state = journal.get("state_before")
        return self._round_body(
            journal["x"], journal["y"], round_index,
            skip_fold=(phase == "folded"),
            attempts=int(journal.get("attempts", 0)),
            token=journal.get("token"),
            lease=lease,
        )

    def _sync(self) -> None:
        """Wait for this thread's device work on the estimator's card."""
        device = getattr(self.estimator, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(torch.device(device))

    def _round_body(
        self, x: np.ndarray, y: np.ndarray, round_index: int,
        skip_fold: bool = False, attempts: int = 0, token: Optional[str] = None,
        lease: Any = None,
    ) -> str:
        n = x.shape[0]
        eval_n = max(min(int(n * self.config.eval_fraction), n - 1), 1)
        train_x, train_y = x[: n - eval_n], y[: n - eval_n]
        eval_x, eval_y = x[n - eval_n :], y[n - eval_n :]

        # The journal commits BEFORE anything in the round can die. A
        # replay (attempts > 0) already has its payload in the store.
        if not skip_fold and self.store is not None and attempts == 0:
            # The token identifies THIS drained batch across replays: the
            # quality-plane label join commits it with its state.
            token = os.urandom(8).hex()
            self._save_journal(
                {
                    "phase": "drained",
                    "round": round_index,
                    "x": x,
                    "y": y,
                    "state_before": self._state,
                    "attempts": attempts,
                    "token": token,
                }
            )

        # ---------------------------------------------------- incremental fold
        save_s = save_bytes = None
        preempted_at: Optional[int] = None
        with _spans.span("refit:fold", rows=int(train_x.shape[0])):
            probe("refit.fold")
            t_fold = time.perf_counter()
            if skip_fold:
                # Journal says the fold already committed: rebuild the
                # candidate from the persisted statistics alone.
                candidate = self.estimator.finish_from_state(self._state)
            else:
                candidate = self._fold(train_x, train_y, lease=lease)
                preempted_at = self._last_preempted_chunk
            self._sync()
            fold_s = time.perf_counter() - t_fold
            if not skip_fold and preempted_at is None:
                self._state = self.estimator.export_stream_state()
                if self.store is not None and self._state is not None:
                    t_save = time.perf_counter()
                    if save_stream_state(self.store, self.config.state_key, self._state):
                        save_s = time.perf_counter() - t_save
                        save_bytes = self.store.last_write_bytes
                    self._save_journal(
                        {
                            "phase": "folded",
                            "round": round_index,
                            "x": x,
                            "y": y,
                            "attempts": attempts,
                            "token": token,
                        }
                    )
        if lease is not None:
            self.scheduler.release(lease)
        if preempted_at is not None:
            # Preempted at a chunk boundary under sustained pressure: the
            # durable cursor holds the committed prefix. Park the batch
            # back in the journal as a PLANNED resume (attempts untouched)
            # and leave self._state at the pre-fold snapshot so nothing
            # partial publishes.
            self._save_journal(
                {
                    "phase": "drained",
                    "round": round_index,
                    "x": x,
                    "y": y,
                    "state_before": self._state,
                    "attempts": attempts,
                    "token": token,
                    "deferred": True,
                    "lease": getattr(lease, "id", None),
                }
            )
            return self._outcome(
                "deferred", round_index, keep_journal=True, preempted_at_chunk=preempted_at,
                fold_s=fold_s, displaced_by=getattr(lease, "displaced_by", None),
            )
        self.last_candidate = candidate
        self._m_fold_s.observe(fold_s)
        self._m_state_rows.set(self.state_rows())
        timings = {"fold_s": fold_s, "state_save_s": save_s, "state_bytes": save_bytes}

        # -------------------------------------------------------- shadow eval
        incumbent = self.publisher.current_model()
        with _spans.span("refit:shadow", eval_rows=int(eval_n)):
            report = self.shadow.compare(
                candidate,
                incumbent,
                eval_x,
                eval_y,
                mirror_x=self.tap.mirror(self.config.mirror_rows),
            )
        if not report.passed:
            get_recovery_log().record(
                "refit_skip",
                self.config.name,
                reason="shadow_eval",
                round=round_index,
                **report.to_json(),
            )
            if hasattr(self.publisher, "settle"):
                self.publisher.settle()
            return self._outcome("skipped_eval", round_index, shadow=report.to_json(), **timings)

        # --------------------------------------------------- publish + watch
        injector = faultinject.current()
        if injector is not None:
            # The seeded-bad-candidate door: a `corrupt` spec at
            # refit.candidate lands AFTER shadow eval and the watch
            # window below must catch it.
            candidate = injector.wrap("refit.candidate", lambda: candidate)()
        # The sequential watch needs the INCUMBENT's per-row scores on the
        # watch slice, and the incumbent stops being reachable the moment
        # the publish swaps it out — score it here.
        incumbent_rows = None
        if self.config.watch_gate == "sequential":
            try:
                incumbent_rows = self.shadow.score_rows(_predict(incumbent, eval_x), eval_y)
            except Exception:
                incumbent_rows = None  # falls back to the margin rule
        with _spans.span("refit:publish", round=round_index):
            ticket = self.publisher.publish(candidate, round_index=round_index)
        outcome = self._watch(
            ticket, report, eval_x, eval_y, round_index, incumbent_rows=incumbent_rows, token=token
        )
        if hasattr(self.publisher, "settle"):
            self.publisher.settle()
        return self._outcome(
            outcome, round_index, shadow=report.to_json(), version=ticket.version,
            state_decay=round(self.applied_decay, 4), **timings,
        )

    def _fold(self, train_x: np.ndarray, train_y: np.ndarray, lease: Any = None):
        """Fold new rows into the stored statistics through the chunked
        fit_stream plan on the estimator's device (the rows stream from
        host memory, as a planned streamed fit's would).

        Under a scheduler lease the fold is preemptible: a durable cursor
        is armed in the daemon's store so every chunk boundary can commit
        the fold prefix, and the lease is consulted between chunks —
        sustained pressure stops the fold at a boundary with the cursor
        intact (``self._last_preempted_chunk``)."""
        from ..data.dataset import ArrayDataset
        from ..workflow.streaming import ChunkStream, last_stream_report

        self._last_preempted_chunk = None
        chunk_rows = self.config.chunk_rows
        if self.scheduler is not None and self.config.auto_chunk_rows:
            chunk_rows, _prefetch, _src = self.scheduler.chunk_rows_for(
                rows=len(train_x),
                width=int(train_x.shape[1]),
                classes=int(train_y.shape[1]) if train_y.ndim > 1 else 1,
                default=self.config.chunk_rows,
            )
        stream = ChunkStream(
            ArrayDataset(train_x, device="cpu"),
            ArrayDataset(train_y, device="cpu"),
            (),
            chunk_rows=min(chunk_rows, max(len(train_x), 1)),
            device=getattr(self.estimator, "device", None),
            partition=self.partition,
        )
        state = self._state
        decay = self.config.state_decay
        if self.config.adaptive_decay:
            # Detected drift shrinks the decay toward the detector's floor
            # so the fold weights the CURRENT distribution.
            decay = get_quality_plane().suggested_decay(self.config.name, base=decay)
        self.applied_decay = decay
        durable = None
        if self.scheduler is not None and self.store is not None:
            # Preemption substrate: chunk-boundary checkpoints in the
            # store the journal lives in. A valid cursor (resume after a
            # deferral) already holds the decayed base plus the committed
            # prefix: seeding from it and skipping the decay below keeps
            # resume equal to an uninterrupted fold.
            from ..reliability.durable import arm_durable_fold

            durable, resume_state = arm_durable_fold(
                stream, self.estimator, self.store, ckpt_every=self.config.sched_ckpt_every,
            )
            if resume_state is not None:
                state = resume_state
                decay = 1.0
        if state is not None and decay < 1.0:
            state = state.scaled(decay)
        if durable is not None:
            # seed_rows AFTER decay: StreamState.scaled multiplies
            # num_examples too, and the cursor's rows are post-decay.
            if durable.resume_rows == 0:
                durable.seed_rows = int(state.num_examples) if state is not None else 0
            stream.durable = durable
            stream.lease = lease
        result = self.estimator.fit_stream(stream, state=state)
        report = last_stream_report()
        if lease is not None and report is not None and report.preempted_at_chunk is not None:
            self._last_preempted_chunk = int(report.preempted_at_chunk)
        return result

    def _watch(
        self, ticket, shadow_report, watch_x, watch_y, round_index: int,
        incumbent_rows: Optional[np.ndarray] = None, token: Optional[str] = None,
    ) -> str:
        """Post-publish watch window, on its OWN thread (the round joins
        it before returning). The thread inherits the round's trace
        context, so ``refit:watch`` nests under ``refit:round``."""
        context = _spans.current_context()
        box: Dict[str, Any] = {}

        def watch_body() -> None:
            try:
                with _spans.attach(context), _spans.span(
                    "refit:watch", round=round_index, version=str(ticket.version)
                ) as watch_span:
                    box["outcome"] = self._watch_inner(
                        ticket, shadow_report, watch_x, watch_y,
                        incumbent_rows=incumbent_rows, token=token,
                    )
                    watch_span.set_attribute("outcome", box["outcome"])
            except BaseException as exc:  # re-raised on the round thread
                box["error"] = exc

        thread = threading.Thread(target=watch_body, name="keystone-refit-watch")
        thread.start()
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["outcome"]

    def _watch_inner(
        self, ticket, shadow_report, watch_x, watch_y,
        incumbent_rows: Optional[np.ndarray] = None, token: Optional[str] = None,
    ) -> str:
        reason = None
        live_score = None
        live_rows = None
        try:
            live_pred = self.publisher.apply_live(watch_x)
            live_score = self.shadow.score_predictions(live_pred, watch_y)
            live_rows = self.shadow.score_rows(live_pred, watch_y)
            self._m_score.set(live_score, role="live")
        except Exception as exc:
            # The published version cannot even answer — that IS the
            # regression, not an excuse to skip the watch.
            reason = f"live apply failed: {type(exc).__name__}: {exc}"
        if live_rows is not None:
            self._observe_quality(live_rows, token)
        if (
            reason is None
            and self.config.watch_gate == "sequential"
            and live_rows is not None
            and incumbent_rows is not None
            and len(live_rows) >= 2
        ):
            reason = self._sequential_watch(live_rows, incumbent_rows)
        elif reason is None and live_score is not None:
            floor = shadow_report.incumbent_score - self.config.watch_margin
            if live_score < floor:
                reason = (
                    f"live score {live_score:.4f} < incumbent "
                    f"{shadow_report.incumbent_score:.4f} - {self.config.watch_margin}"
                )
        if reason is None and self.config.watch_max_p99_ms is not None:
            try:
                p99 = self.publisher.serving_stats().get("p99_ms")
            except Exception:
                p99 = None
            if isinstance(p99, (int, float)) and p99 > self.config.watch_max_p99_ms:
                reason = f"p99 {p99:.1f}ms > {self.config.watch_max_p99_ms}ms"
        if reason is None:
            return "published"
        self.publisher.rollback(ticket, reason=reason)
        return "rolled_back"

    # ------------------------------------------------------- quality plane
    #
    # The watch window's per-row live scores ARE the delayed-label join:
    # the rows carry labels (the tap's held-back slice). The join commits
    # with the round — _persist_quality runs before the journal clears,
    # and a replayed batch whose token already persisted is skipped.

    def _observe_quality(self, live_rows: np.ndarray, token: Optional[str]) -> None:
        if token is not None and token == self._joined_token:
            return  # replayed batch: this join already committed
        plane = get_quality_plane()
        model = self.config.name
        scores = [float(s) for s in live_rows]
        detector = plane.drift(model)
        for score in scores:
            plane.observe_score(model, score, role="live")
        if detector.baseline is None:
            detector.freeze_baseline()  # first watch window: the reference
        else:
            plane.check_drift(model)
        plane.join_labels(model, scores)
        self._joined_token = token

    def _sequential_watch(self, live_rows: np.ndarray, incumbent_rows: np.ndarray) -> Optional[str]:
        """Anytime-valid watch verdict: per-row live-vs-incumbent scores
        feed a SequentialGate pairwise. Returns the rollback reason, or
        None (promoted — by evidence or by exhausted budget)."""
        from ..obs.quality import quality_min_samples

        plane = get_quality_plane()
        budget = min(2 * min(len(live_rows), len(incumbent_rows)), self.config.gate_max_samples)
        gate = plane.open_gate(
            self.config.name,
            kind="refit_watch",
            alpha=self.config.gate_alpha,
            min_samples=min(quality_min_samples(), budget),
            max_samples=budget,
        )
        verdict = "continue"
        for cand, base in zip(live_rows, incumbent_rows):
            verdict = gate.observe(candidate=float(cand), baseline=float(base))
            if verdict != "continue":
                break
        if verdict == "continue":
            # Window exhausted undecided: force the budget ruling.
            gate.max_samples = min(gate.max_samples, gate.samples)
            verdict = gate.evaluate()
        evidence = plane.record_decision(gate)
        if verdict == "rollback":
            return (
                "sequential gate: live scores significantly below "
                f"incumbent (lr={evidence['lr']}, alpha={gate.alpha}, samples={evidence['samples']})"
            )
        return None

    def _persist_quality(self) -> None:
        """Commit the quality plane's label-joined state (plus the join
        token) next to the stream state, with round completion."""
        if self.store is None:
            return
        try:
            state = get_quality_plane().state(self.config.name)
            self.store.save(None, {"token": self._joined_token, "state": state}, digest=self._quality_state_key())
        except Exception:
            pass  # quality is evidence, not correctness: never fail a round

    def _outcome(self, outcome: str, round_index: int, keep_journal: bool = False, **detail) -> str:
        # The round reached a decision: persist the quality join state,
        # then retire its journal (a no-op when none was written). A
        # scheduler deferral KEEPS the journal: it is the parked batch.
        self._persist_quality()
        if not keep_journal:
            self._clear_journal()
        # Join lag: labeled rows already in the tap this round did not reach.
        _names.metric(_names.QUALITY_JOIN_LAG_ROWS).set(self.tap.depth(), model=self.config.name)
        self._m_rounds.inc(outcome=outcome)
        self.outcomes.append({"round": round_index, "outcome": outcome, **detail})
        return outcome

    # ------------------------------------------------------------ supervision
    def start(self) -> "RefitDaemon":
        """Run rounds every ``interval_s`` in a supervised daemon thread."""
        if self._thread is not None:
            raise RuntimeError("refit daemon already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="keystone-refit-daemon", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None

    def __enter__(self) -> "RefitDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _next_interval(self) -> float:
        """Pressure-aware cadence: an unscheduled daemon keeps the fixed
        ``interval_s``; a scheduled one drains sooner as the tap fills
        toward its drop-oldest bound and backs off under pressure."""
        base = self.config.interval_s
        if self.scheduler is None:
            return base
        from ..sched.scheduler import pressure_aware_interval

        stats = self.tap.stats()
        fill = min(
            float(stats.get("labeled_depth", 0)) / max(float(stats.get("capacity_rows", 1)), 1.0),
            1.0,
        )
        interval = pressure_aware_interval(base, fill, self.scheduler.pressure())
        _names.metric(_names.SCHED_REFIT_INTERVAL_SECONDS).set(interval)
        return interval

    def _loop(self) -> None:
        failures = 0
        while not self._stop.wait(self._next_interval()):
            try:
                self.run_once()
                failures = 0
            except Exception as exc:
                failures += 1
                self._m_rounds.inc(outcome="error")
                get_recovery_log().record(
                    "refit_round_error",
                    self.config.name,
                    error=f"{type(exc).__name__}: {exc}",
                    consecutive=failures,
                )
                if failures >= self.config.max_consecutive_failures:
                    get_recovery_log().record(
                        "refit_daemon_failed", self.config.name, consecutive_failures=failures
                    )
                    return


# ----------------------------------------------------------------- the demo
#
# A self-contained closed loop over a drifting synthetic classification
# workload. Everything deterministic in the seed.


@dataclass
class RefitDemoConfig:
    d: int = 16
    classes: int = 4
    rounds: int = 6
    rows_per_round: int = 1024
    serve_requests: int = 192       # served per round (the live traffic)
    chunk_rows: int = 256
    drift: float = 0.2              # per-round weight perturbation scale
    state_decay: float = 0.5        # recency weight on the stored stats
    quiet_round: int = 2            # feeds too few rows → a ledgered skip
    bad_round: int = 4              # candidate corrupted → auto-rollback
    settle_round: int = 2           # steady-state plan assertions start
    seed: int = 0
    reg: float = 1e-2
    store_dir: Optional[str] = None
    watch_gate: str = "margin"      # or "sequential": anytime-valid watch
    adaptive_decay: bool = False    # drift detector steers state_decay


def _corrupt_mapper(model: Any) -> Any:
    """The seeded bad candidate: weights negated — invisible to shadow
    eval by construction (it is injected AFTER eval) and catastrophically
    wrong on live traffic, which is the watch window's job to catch."""
    from ..ops.learning.linear import LinearMapper

    return LinearMapper(-model.weights, intercept=model.intercept, feature_mean=model.feature_mean)


def run_refit_demo(
    config: RefitDemoConfig,
    device: Any = None,
    on_round: Optional[Callable[[int, "RefitDaemon"], None]] = None,
) -> Dict[str, Any]:
    """Drifting workload × continuous refit, end to end, in-process, on
    ``device`` (default CUDA).

    Returns the evidence dict: round outcomes, dropped-request and
    steady-state plan counts, accuracy trajectory (live vs a stale
    never-refit incumbent), and the incremental-vs-scratch fold walls.
    Per round it also records ``fold_s``, the state save's seconds and
    bytes, ``round_wall_s`` and the serving p50/p99 of that round's
    traffic. ``on_round(r, daemon)`` runs after each round's decision.
    """
    import contextlib
    import tempfile

    from ..data.dataset import ArrayDataset
    from ..device import resolve_device
    from ..obs.quality import reset_quality_plane
    from ..ops.learning.linear import LinearMapEstimator
    from ..reliability.checkpoint import CheckpointStore
    from ..serving.config import ServingConfig
    from ..serving.server import PipelineServer
    from ..workflow.streaming import ChunkStream
    from .publish import InProcessPublisher

    cfg = config
    device = resolve_device(device)
    # The demo is an entry point: its quality evidence reflects THIS run.
    reset_quality_plane()
    rng = np.random.default_rng(cfg.seed)
    drift_rng = np.random.default_rng(cfg.seed + 1)

    w_true = rng.standard_normal((cfg.d, cfg.classes)).astype(np.float32)

    def drift_weights():
        nonlocal w_true
        step = drift_rng.standard_normal(w_true.shape).astype(np.float32)
        w = w_true + cfg.drift * step
        w_true = (w / np.linalg.norm(w, axis=0, keepdims=True)).astype(np.float32)

    def make_rows(n: int):
        x = rng.standard_normal((n, cfg.d)).astype(np.float32)
        labels = np.argmax(x @ w_true, axis=1)
        y = np.eye(cfg.classes, dtype=np.float32)[labels]
        return x, y, labels

    def stream_over(x, y):
        return ChunkStream(
            ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu"), (),
            chunk_rows=min(cfg.chunk_rows, len(x)), device=device,
        )

    store_dir = cfg.store_dir or tempfile.mkdtemp(prefix="keystone-refit-")
    store = CheckpointStore(store_dir, device=device)

    # Incumbent v1: one streamed fit on pre-drift data, state captured.
    estimator = LinearMapEstimator(reg=cfg.reg, device=device)
    x0, y0, _ = make_rows(cfg.rows_per_round)
    v1_model = estimator.fit_stream(stream_over(x0, y0))
    save_stream_state(store, "refit-state", estimator.export_stream_state())

    tap = TrafficTap(capacity_rows=cfg.rows_per_round * 4, mirror_rows=512)
    server = PipelineServer(
        config=ServingConfig(max_batch=8, queue_depth=cfg.serve_requests + 64),
        name="demo",
        tap=tap,
        device=device,
    )
    server.registry.publish("demo", v1_model, source="fit")
    server.start()
    example = np.zeros((cfg.d,), np.float32)
    server.warmup(example)

    publisher = InProcessPublisher(server, name="demo", example=example)
    daemon = RefitDaemon(
        estimator,
        tap,
        publisher,
        store=store,
        # Margin well above one eval-row accuracy quantum (1/eval_rows):
        # under drift the incumbent and a one-round-fresher candidate can
        # score within a row or two of each other.
        shadow=ShadowEvaluator(margin=0.06),
        config=RefitConfig(
            name="demo",
            min_rows=max(cfg.rows_per_round // 2, 64),
            chunk_rows=cfg.chunk_rows,
            watch_margin=0.05,
            state_decay=cfg.state_decay,
            watch_gate=cfg.watch_gate,
            adaptive_decay=cfg.adaptive_decay,
        ),
        state=estimator.export_stream_state(),
    )

    rounds: List[Dict[str, Any]] = []
    dropped = 0
    steady_plans = 0
    fold_walls: List[float] = []
    all_x, all_y = [x0], [y0]

    specs = []
    if cfg.bad_round:
        # The corrupt call number counts refit.candidate REACHES (rounds
        # that got past shadow eval); the quiet round never reaches it.
        reaches = cfg.bad_round - (1 if cfg.quiet_round and cfg.quiet_round < cfg.bad_round else 0)
        specs.append(
            faultinject.FaultSpec(
                match="refit.candidate", kind="corrupt", calls=(reaches,), corrupt=_corrupt_mapper
            )
        )

    chaos = faultinject.injected(*specs) if specs else contextlib.nullcontext()
    try:
        with chaos:
            for r in range(1, cfg.rounds + 1):
                drift_weights()
                quiet = r == cfg.quiet_round
                n = 96 if quiet else cfg.rows_per_round
                x, y, labels = make_rows(n)

                # ---- live traffic through the serve path (zero drops).
                futures = server.submit_many([row for row in x[: cfg.serve_requests]], deadline_s=120.0)
                dropped += sum(1 for f in futures if f.exception(timeout=180) is not None)
                stats = server.stats()
                if r > cfg.settle_round:
                    # Post-settle: serving between refit rounds meets no
                    # new shape (the publish re-warm + settle restamp own
                    # every legitimate one).
                    steady_plans = max(steady_plans, int(stats.get("cufft_plans_since_warmup") or 0))

                # ---- labeled side-channel + one daemon round.
                tap.feed(x, y)
                all_x.append(x)
                all_y.append(y)
                t0 = time.perf_counter()
                outcome = daemon.run_once()
                round_wall = time.perf_counter() - t0
                last = daemon.outcomes[-1]
                fold_s = last.get("fold_s")
                if fold_s is not None:
                    fold_walls.append(fold_s)

                live_acc = _demo_accuracy(publisher, x, labels)
                # The accuracy probe is demo instrumentation, not serving
                # traffic — restamp so next round's window still reads 0.
                server.restamp_compile_baseline()
                rounds.append(
                    {
                        "round": r,
                        "outcome": outcome,
                        "rows": n,
                        "live_accuracy": round(live_acc, 4),
                        "fold_s": fold_s,
                        "state_save_s": last.get("state_save_s"),
                        "state_bytes": last.get("state_bytes"),
                        "round_wall_s": round_wall,
                        "serve_p50_ms": stats.get("p50_ms"),
                        "serve_p99_ms": stats.get("p99_ms"),
                        "shadow": last.get("shadow"),
                    }
                )
                if on_round is not None:
                    on_round(r, daemon)
    finally:
        server.stop(drain=True)

    # Evidence: stale v1 (never refit) vs the live, continuously-refit
    # line on the FINAL drifted distribution.
    final_x, _, final_labels = make_rows(2048)
    stale_acc = _model_accuracy(v1_model, final_x, final_labels)
    live_acc = _demo_accuracy(publisher, final_x, final_labels)

    # From-scratch comparison: one fit over every row the state absorbed.
    scratch_est = LinearMapEstimator(reg=cfg.reg, device=device)
    xs, ys = np.concatenate(all_x), np.concatenate(all_y)
    t0 = time.perf_counter()
    scratch_est.fit_stream(stream_over(xs, ys))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    scratch_wall = time.perf_counter() - t0
    incremental_wall = float(np.median(fold_walls)) if fold_walls else None

    outcomes = [r["outcome"] for r in rounds]
    ledger = get_recovery_log()
    quality_report = get_quality_plane().report()
    demo_view = quality_report["models"].get("demo", {})
    quality_block = {
        "label_joins": demo_view.get("label_joins", 0),
        "drift_score": demo_view.get("drift", {}).get("score", 0.0),
        "drift_events": demo_view.get("drift", {}).get("events", 0),
        "decisions": [d["decision"] for d in quality_report["decisions"]],
        "quality_decisions": len(quality_report["decisions"]),
        "join_lag_rows": tap.depth(),
        "state_decay_applied": round(daemon.applied_decay, 4),
        "labeled_mean": demo_view.get("streams", {}).get("labeled", {}).get("mean"),
    }
    return {
        "d": cfg.d,
        "classes": cfg.classes,
        "device": str(device),
        "rounds": rounds,
        "publishes": outcomes.count("published"),
        "rollbacks": outcomes.count("rolled_back"),
        "skips": outcomes.count("skipped_nodata") + outcomes.count("skipped_eval"),
        "dropped": int(dropped),
        "cufft_plans_since_warmup_post_settle": int(steady_plans),
        "state_rows": daemon.state_rows(),
        "tap": tap.stats(),
        "live_accuracy_final": round(live_acc, 4),
        "stale_v1_accuracy_final": round(stale_acc, 4),
        "incremental_refit_wall_s": incremental_wall,
        "scratch_fit_wall_s": scratch_wall,
        "refit_speedup": (scratch_wall / incremental_wall) if incremental_wall else None,
        "speedup_ok": bool(incremental_wall is not None and scratch_wall > incremental_wall),
        "ledger_kinds": sorted({e.kind for e in ledger.events() if e.kind.startswith("refit_")}),
        "models": server.registry.describe(),
        "quality": quality_block,
    }


def _model_accuracy(model: Any, x: np.ndarray, labels: np.ndarray) -> float:
    from ..evaluation import MulticlassClassifierEvaluator

    scores = _predict(model, x)
    return MulticlassClassifierEvaluator(scores.shape[1]).evaluate(scores.argmax(axis=1), labels).total_accuracy


def _demo_accuracy(publisher: Any, x: np.ndarray, labels: np.ndarray) -> float:
    from ..evaluation import MulticlassClassifierEvaluator

    scores = publisher.apply_live(x)
    return MulticlassClassifierEvaluator(scores.shape[1]).evaluate(scores.argmax(axis=1), labels).total_accuracy


# --------------------------------------------------------------------- CLI


def add_refit_arguments(parser) -> None:
    """Flags for the ``refit`` subcommand: the JAX package's, plus
    ``--device``."""
    parser.add_argument("--rounds", type=int, default=6, help="drifting-workload rounds to run")
    parser.add_argument("--dim", type=int, default=16, help="synthetic feature width")
    parser.add_argument("--classes", type=int, default=4, help="synthetic class count")
    parser.add_argument("--rows-per-round", type=int, default=1024, help="labeled rows fed to the tap per round")
    parser.add_argument(
        "--serve-requests", type=int, default=192, help="live requests served through the pipeline per round"
    )
    parser.add_argument("--chunk-rows", type=int, default=256, help="chunk rows for the incremental fold")
    parser.add_argument("--drift", type=float, default=0.2, help="per-round drift of the true weights")
    parser.add_argument(
        "--quiet-round", type=int, default=2,
        help="round that feeds too few rows (a ledgered skip); 0 disables",
    )
    parser.add_argument(
        "--bad-round", type=int, default=4,
        help="round whose candidate is corrupted post-eval (exercises auto-rollback); 0 disables",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--store-dir", default=None,
        help="checkpoint-store directory for the stream state (default: a fresh temp dir)",
    )
    parser.add_argument(
        "--watch-gate", choices=("margin", "sequential"), default="margin", dest="watch_gate",
        help="post-publish watch rule: fixed margin floor, or the anytime-valid sequential gate",
    )
    parser.add_argument(
        "--adaptive-decay", action="store_true", dest="adaptive_decay",
        help="let the quality plane's drift detector shrink state_decay under detected score drift",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA device; 'cpu' to run on the CPU)",
    )


def refit_from_args(args) -> int:
    """``refit``: run the drifting-workload closed loop and print one
    ``REFIT_STATS:`` JSON line, with this process's ``device_counts``."""
    import json

    from ..device import resolve_device
    from ..ops.cuda import device_counts

    device = resolve_device(args.device)

    config = RefitDemoConfig(
        d=args.dim,
        classes=args.classes,
        rounds=args.rounds,
        rows_per_round=args.rows_per_round,
        serve_requests=args.serve_requests,
        chunk_rows=args.chunk_rows,
        drift=args.drift,
        quiet_round=args.quiet_round,
        bad_round=args.bad_round,
        seed=args.seed,
        store_dir=args.store_dir,
        watch_gate=args.watch_gate,
        adaptive_decay=bool(args.adaptive_decay),
    )
    results = run_refit_demo(config, device=device)
    results["recovery"] = get_recovery_log().summary()
    results["device_counts"] = device_counts(device)
    print("REFIT_STATS:" + json.dumps(results), flush=True)
    return 0


__all__ = [
    "RefitConfig",
    "RefitDaemon",
    "RefitDemoConfig",
    "add_refit_arguments",
    "refit_from_args",
    "run_refit_demo",
]
