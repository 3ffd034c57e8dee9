"""The stable metric-name registry.

A copy of the series of ``keystone_tpu/obs/names.py`` that the port's
modules publish: the executor and optimizer (``keystone_executor_*``,
``keystone_optimizer_*``), fusion, streaming, the profile store, the
block-sparse dispatch, the solvers, the sketch tier, the recovery
ledger, the checkpoint store and durable fits, the resume and publish
verifiers, continuous refit, the flight recorder, the quality plane,
the partitioner (``keystone_partition_*``), serving and the
multi-worker fleet (supervisor, SLO control, autoscaling, boot images,
fleet tracing).
Names, kinds, help texts and labels are the JAX package's, so dashboards
read both packages alike; the other families arrive with the modules
that publish them. One help text says what its series counts in the
port, which traces nothing: a fused chain's "compile" is its first
application at a new input shape and dtype.

The serving telemetry registers its series under these names; every
other module takes its series from :func:`metric`. :func:`register_all`
pre-registers the whole schema so an export is complete (a zero-valued
series is an answer: "no retries happened").
"""

from __future__ import annotations

from typing import Dict, Tuple

from .metrics import DEFAULT_BUCKETS, RATIO_BUCKETS, MetricsRegistry, get_registry

# ----------------------------------------------------------- executor/workflow
NODES_EXECUTED = "keystone_executor_nodes_executed_total"
MEMO_HITS = "keystone_executor_memo_hits_total"
NODE_SECONDS = "keystone_executor_node_seconds"
OPTIMIZE_SECONDS = "keystone_optimizer_seconds"
RULE_RUNS = "keystone_optimizer_rule_runs_total"
RULE_REWRITES = "keystone_optimizer_rule_rewrites_total"

# ---------------------------------------------------------------------- fusion
FUSION_CHAINS = "keystone_fusion_chains_total"
FUSION_FUSED_NODES = "keystone_fusion_fused_nodes_total"
FUSION_DISPATCHES_SAVED = "keystone_fusion_dispatches_saved_total"
FUSION_COMPILES = "keystone_fusion_compiles_total"
FUSION_BATCH_DISPATCHES = "keystone_fusion_batch_dispatches_total"

# ------------------------------------------------------------------- streaming
STREAM_PLANS = "keystone_stream_plans_total"
STREAM_CHUNKS = "keystone_stream_chunks_total"
STREAM_BYTES = "keystone_stream_bytes_transferred_total"
STREAM_STALL_SECONDS = "keystone_stream_stall_seconds_total"
STREAM_PREFETCH_DEPTH = "keystone_stream_prefetch_depth"
STREAM_HOST_BUFFER_PEAK = "keystone_stream_host_buffer_peak_bytes"

# ---------------------------------------------------------------- partitioning
PARTITION_DECISIONS = "keystone_partition_decisions_total"
PARTITION_SHARDS = "keystone_partition_shards"
PARTITION_FALLBACKS = "keystone_partition_fallbacks_total"
PARTITION_COLLECTIVE_BYTES = "keystone_partition_collective_bytes_total"
PARTITION_IMBALANCE = "keystone_partition_imbalance"

# --------------------------------------------------------------- profile store
PROFILE_STORE_HITS = "keystone_profile_store_hits_total"
PROFILE_STORE_MISSES = "keystone_profile_store_misses_total"
PROFILE_STORE_WRITES = "keystone_profile_store_writes_total"
PROFILE_STORE_EVICTIONS = "keystone_profile_store_evictions_total"
PROFILE_STORE_INVALIDATIONS = "keystone_profile_store_invalidations_total"
PROFILE_STORE_ENTRIES = "keystone_profile_store_entries"
PROFILE_STORE_KNOB_OVERRIDES = "keystone_profile_store_knob_overrides_total"

# ---------------------------------------------------------------- block-sparse
BLOCKSPARSE_FITS = "keystone_blocksparse_fits_total"
BLOCKSPARSE_BLOCKS_SKIPPED = "keystone_blocksparse_blocks_skipped_total"

# --------------------------------------------------------------------- solvers
SOLVER_FIT_SECONDS = "keystone_solver_fit_seconds"
SOLVER_RUNG_ATTEMPTS = "keystone_solver_rung_attempts_total"
SOLVER_ITERATIONS = "keystone_solver_iterations_total"

# ---------------------------------------------------------------- sketch tier
SKETCH_FITS = "keystone_sketch_fits_total"
SKETCH_SIZE = "keystone_sketch_size"
SKETCH_STATE_BYTES = "keystone_sketch_state_bytes"
SKETCH_FINISH_SECONDS = "keystone_sketch_finish_seconds"

# ----------------------------------------------------------------- reliability
RELIABILITY_EVENTS = "keystone_reliability_events_total"
CHECKPOINT_HITS = "keystone_checkpoint_hits_total"
CHECKPOINT_MISSES = "keystone_checkpoint_misses_total"
CHECKPOINT_WRITES = "keystone_checkpoint_writes_total"

# ---------------------------------------------------------------- durable fits
DURABLE_CHECKPOINTS = "keystone_durable_fit_checkpoints_total"
DURABLE_RESUMES = "keystone_durable_fit_resumes_total"
DURABLE_RESUME_REFUSED = "keystone_durable_fit_resume_refused_total"
DURABLE_REINGESTED_CHUNKS = "keystone_durable_fit_reingested_chunks_total"
DURABLE_SHARD_LOSSES = "keystone_durable_fit_shard_losses_total"

# ---------------------------------------------------------------- verification
VERIFY_RUNS = "keystone_verify_runs_total"
VERIFY_DIAGNOSTICS = "keystone_verify_diagnostics_total"
VERIFY_NODES = "keystone_verify_nodes_annotated_total"
VERIFY_SECONDS = "keystone_verify_seconds"
VERIFY_LINT_FINDINGS = "keystone_verify_lint_findings_total"

# ------------------------------------------------------------ continuous refit
REFIT_ROUNDS = "keystone_refit_rounds_total"
REFIT_PUBLISHES = "keystone_refit_publishes_total"
REFIT_ROLLBACKS = "keystone_refit_rollbacks_total"
REFIT_TAP_ROWS = "keystone_refit_tap_rows_total"
REFIT_STATE_ROWS = "keystone_refit_state_rows"
REFIT_FOLD_SECONDS = "keystone_refit_fold_seconds"
REFIT_SCORE = "keystone_refit_score"

# ------------------------------------------------------------- flight recorder
FLIGHT_RECORDS = "keystone_flight_records_total"
FLIGHT_DUMPS = "keystone_flight_dumps_total"
FLIGHT_DUMP_BYTES = "keystone_flight_dump_bytes"

# --------------------------------------------------------------- quality plane
QUALITY_SCORES = "keystone_quality_scores_total"
QUALITY_SCORE_MEAN = "keystone_quality_score_mean"
QUALITY_SCORE_QUANTILE = "keystone_quality_score_quantile"
QUALITY_LABEL_JOINS = "keystone_quality_label_joins_total"
QUALITY_JOIN_LAG_ROWS = "keystone_quality_join_lag_rows"
QUALITY_SKETCH_ROWS = "keystone_quality_sketch_rows"
QUALITY_SKETCH_BYTES = "keystone_quality_sketch_bytes"
QUALITY_SKETCH_MERGES = "keystone_quality_sketch_merges_total"
QUALITY_DRIFT_EVENTS = "keystone_quality_drift_events_total"
QUALITY_DRIFT_SCORE = "keystone_quality_drift_score"
QUALITY_STATE_DECAY = "keystone_quality_state_decay"
QUALITY_GATE_DECISIONS = "keystone_quality_gate_decisions_total"
QUALITY_GATE_OPEN = "keystone_quality_gate_open"
QUALITY_GATE_SAMPLES = "keystone_quality_gate_samples"

# --------------------------------------------------------------------- serving
SERVING_REQUESTS = "keystone_serving_requests_total"
SERVING_BATCHES = "keystone_serving_batches_total"
SERVING_SHEDS = "keystone_serving_sheds_total"
SERVING_TIMEOUTS = "keystone_serving_timeouts_total"
SERVING_RETRIES = "keystone_serving_retries_total"
SERVING_FAILURES = "keystone_serving_failures_total"
SERVING_BUCKET_HITS = "keystone_serving_bucket_hits_total"
SERVING_BUCKET_COMPILES = "keystone_serving_bucket_compiles_total"
SERVING_LATENCY_SECONDS = "keystone_serving_latency_seconds"
SERVING_QUEUE_WAIT_SECONDS = "keystone_serving_queue_wait_seconds"
SERVING_BATCH_OCCUPANCY = "keystone_serving_batch_occupancy"

# ------------------------------------------------- multi-worker serving / SLO
SERVING_WORKER_RESTARTS = "keystone_serving_worker_restarts_total"
SERVING_WORKER_REQUEUED = "keystone_serving_requeued_requests_total"
SERVING_WORKERS_ALIVE = "keystone_serving_workers_alive"
SERVING_WORKER_HEARTBEATS = "keystone_serving_worker_heartbeats_total"
SERVING_SLO_P99_MS = "keystone_serving_slo_p99_ms"
SERVING_SLO_TARGET_MS = "keystone_serving_slo_target_ms"
SERVING_SLO_RUNG = "keystone_serving_slo_rung"
SERVING_SLO_TRANSITIONS = "keystone_serving_slo_transitions_total"

# --------------------------------------------------- elastic fleet / autoscale
SERVING_SCALE_EVENTS = "keystone_serving_scale_events_total"
SERVING_SCALE_TARGET_WORKERS = "keystone_serving_scale_target_workers"
SERVING_SCALE_WORKERS_DRAINING = "keystone_serving_scale_workers_draining"
SERVING_SCALE_DRAIN_SECONDS = "keystone_serving_scale_drain_seconds"

# ------------------------------------------------------------------ boot image
BOOTIMAGE_BUILDS = "keystone_bootimage_builds_total"
BOOTIMAGE_LOADS = "keystone_bootimage_loads_total"
BOOTIMAGE_BUILD_SECONDS = "keystone_bootimage_build_seconds"
BOOTIMAGE_LOAD_SECONDS = "keystone_bootimage_load_seconds"

# --------------------------------------------------------------- fleet tracing
FLEET_SPAN_FRAGMENTS = "keystone_fleet_span_fragments_total"
FLEET_TRACE_BYTES = "keystone_fleet_trace_bytes_total"
FLEET_CLOCK_SKEW = "keystone_fleet_clock_skew_seconds"
FLEET_REQUESTS = "keystone_fleet_requests_total"
FLEET_FAILURES = "keystone_fleet_failures_total"
FLEET_WORKER_SERIES = "keystone_fleet_worker_series"

# Image ingest (data/ingest.py::measure_ingest).
INGEST_IMAGES = "keystone_ingest_images_total"
INGEST_CORRUPT = "keystone_ingest_corrupt_total"
INGEST_BYTES = "keystone_ingest_bytes_total"
INGEST_DECODE_SECONDS = "keystone_ingest_decode_seconds_total"


# ------------------------------------------------------------------- autocache
AUTOCACHE_CACHED_NODES = "keystone_autocache_cached_nodes_total"
AUTOCACHE_HITS = "keystone_autocache_hits_total"
AUTOCACHE_MISSES = "keystone_autocache_misses_total"
AUTOCACHE_PROFILE_SECONDS = "keystone_autocache_profile_seconds"

# ------------------------------------------------------------------- autotuner
TUNE_CANDIDATES = "keystone_tune_candidates_total"
TUNE_WINNERS = "keystone_tune_winners_total"
TUNE_SECONDS = "keystone_tune_seconds"
KNOB_REJECTED = "keystone_knob_rejected_total"

# ------------------------------------------------------------------- scheduler
SCHED_LEASES = "keystone_sched_leases_total"
SCHED_IDLE_HARVEST_SECONDS = "keystone_sched_idle_harvest_seconds_total"
SCHED_LEASE_WALL_RATIO = "keystone_sched_lease_wall_ratio"
SCHED_REFIT_INTERVAL_SECONDS = "keystone_sched_refit_interval_seconds"

# ------------------------------------------------------------ cost observatory
COST_LEDGER_ENTRIES = "keystone_cost_ledger_entries_total"
COST_DRIFT_EVENTS = "keystone_cost_drift_events_total"
COST_DRIFT_RATIO = "keystone_cost_drift_ratio"
COST_HARVEST_COMPILES = "keystone_cost_harvest_compiles_total"
COST_ROOFLINE_PEAK = "keystone_cost_roofline_peak"

# ---------------------------------------------------------------------- memory
MEMORY_IN_USE_BYTES = "keystone_memory_in_use_bytes"
PEAK_MEMORY_BYTES = "keystone_peak_memory_bytes"

# name → (kind, help, label names). Histograms may carry a 4th element
# naming a bucket preset ("ratio" → RATIO_BUCKETS).
SCHEMA: Dict[str, Tuple] = {
    NODES_EXECUTED: ("counter", "Graph nodes executed (memo misses)", ()),
    MEMO_HITS: ("counter", "Graph-node memo table hits", ()),
    NODE_SECONDS: ("histogram", "Per-node forced execution wall time (traced runs)", ("op",)),
    OPTIMIZE_SECONDS: ("histogram", "Whole optimizer-stack runs", ()),
    RULE_RUNS: ("counter", "Optimizer rule applications", ("rule",)),
    RULE_REWRITES: ("counter", "Optimizer rule applications that changed the graph", ("rule",)),
    FUSION_CHAINS: ("counter", "Fused operator chains created by NodeFusionRule", ()),
    FUSION_FUSED_NODES: ("counter", "Member transformer nodes absorbed into fused operators", ()),
    FUSION_DISPATCHES_SAVED: ("counter", "Per-execution dispatches avoided by fusion (members-1 per chain)", ()),
    FUSION_COMPILES: ("counter", "Fused-chain first applications (one per new shape/dtype)", ()),
    FUSION_BATCH_DISPATCHES: ("counter", "Transformer batch-apply dispatches, split fused vs unfused", ("fused",)),
    STREAM_PLANS: ("counter", "Estimator fits rewritten onto the streaming engine by StreamingPlanRule", ()),
    STREAM_CHUNKS: ("counter", "Chunks dispatched by the streaming execution engine", ()),
    STREAM_BYTES: ("counter", "Host-to-device bytes uploaded by the streaming engine (post narrow-dtype)", ()),
    STREAM_STALL_SECONDS: ("counter", "Seconds the streaming dispatch loop spent waiting on the host prefetch pipeline", ()),
    STREAM_PREFETCH_DEPTH: ("gauge", "Chunks currently buffered in the host prefetch queue", ()),
    STREAM_HOST_BUFFER_PEAK: ("gauge", "Peak bytes of host chunk buffers concurrently live in the last streaming fit", ()),
    PARTITION_DECISIONS: ("counter", "Partitioner decisions recorded into plans, split by kind and eligibility", ("kind", "eligible")),
    PARTITION_SHARDS: ("gauge", "Shards chosen by the last eligible partition decision, per kind and mesh axis (data = rows, model = feature blocks)", ("kind", "axis")),
    PARTITION_FALLBACKS: ("counter", "Partition decisions that fell back (whole decision or just the model axis), by reason key", ("reason",)),
    PARTITION_COLLECTIVE_BYTES: ("counter", "Payload bytes entering partitioner-managed cross-device reductions, per mesh axis (per-device payload × (axis shards−1))", ("axis",)),
    PARTITION_IMBALANCE: ("gauge", "Fraction of sharded rows that are padding in the last partitioned dispatch, per kind", ("kind",)),
    PROFILE_STORE_HITS: ("counter", "Profile-store lookups served from a valid persisted entry", ()),
    PROFILE_STORE_MISSES: ("counter", "Profile-store lookups with no usable entry", ()),
    PROFILE_STORE_WRITES: ("counter", "Observations appended to the profile store", ()),
    PROFILE_STORE_EVICTIONS: ("counter", "Entries evicted (LRU-by-write) at profile-store compaction", ()),
    PROFILE_STORE_INVALIDATIONS: ("counter", "Entries rejected for a stale environment fingerprint", ()),
    PROFILE_STORE_ENTRIES: ("gauge", "Live entries in the profile store", ()),
    PROFILE_STORE_KNOB_OVERRIDES: ("counter", "Plan knobs overridden from measured observations by MeasuredKnobRule", ("knob",)),
    BLOCKSPARSE_FITS: ("counter", "Estimator fits dispatched onto the block-sparse Gram path, by kernel impl", ("impl",)),
    BLOCKSPARSE_BLOCKS_SKIPPED: ("counter", "Zero feature tiles skipped by block-sparse kernels (MACs never dispatched)", ()),
    SOLVER_FIT_SECONDS: ("histogram", "Solver fit wall time", ("solver",)),
    SOLVER_RUNG_ATTEMPTS: ("counter", "Degradation-ladder rung attempts inside solvers", ("solver",)),
    SOLVER_ITERATIONS: ("counter", "Host-level solver iterations (e.g. L-BFGS steps)", ("solver",)),
    SKETCH_FITS: ("counter", "Sketched least-squares fits completed, by sketch variant (countsketch/srht)", ("variant",)),
    SKETCH_SIZE: ("gauge", "Sketch rows s chosen for the last sketched fit (knob/tuned/width default)", ()),
    SKETCH_STATE_BYTES: ("gauge", "Bytes of the last sketched fit's O(s·d) carry — the number KV308 compares to the device budget", ()),
    SKETCH_FINISH_SECONDS: ("histogram", "Sketch finish solves (s×s dual ridge or lstsq fallback)", ()),
    RELIABILITY_EVENTS: ("counter", "Recovery-ledger events", ("kind",)),
    CHECKPOINT_HITS: ("counter", "CheckpointStore lookups that restored a fit", ()),
    CHECKPOINT_MISSES: ("counter", "CheckpointStore lookups that missed", ()),
    CHECKPOINT_WRITES: ("counter", "CheckpointStore entries written", ()),
    DURABLE_CHECKPOINTS: ("counter", "Mid-stream fit checkpoints committed (StreamState + ingest cursor)", ()),
    DURABLE_RESUMES: ("counter", "Streamed fits resumed from a persisted cursor, by recovery kind (crash/shard/refit_journal)", ("kind",)),
    DURABLE_RESUME_REFUSED: ("counter", "Resume entries refused or discarded before seeding a fold, by reason (KV306 fingerprint mismatch / geometry drift)", ("reason",)),
    DURABLE_REINGESTED_CHUNKS: ("counter", "Chunks re-ingested by resumed or shard-loss-recovered folds", ()),
    DURABLE_SHARD_LOSSES: ("counter", "Simulated/observed device losses absorbed mid-stream by the elastic fold", ()),
    VERIFY_RUNS: ("counter", "Plan-time verification runs", ("context",)),
    VERIFY_DIAGNOSTICS: ("counter", "Plan-time verification diagnostics emitted", ("code", "severity")),
    VERIFY_NODES: ("counter", "Graph nodes annotated with propagated specs by the verifier", ()),
    VERIFY_SECONDS: ("histogram", "Whole-graph verification passes", ()),
    VERIFY_LINT_FINDINGS: ("counter", "keystone-lint findings", ("rule",)),
    REFIT_ROUNDS: ("counter", "Refit daemon rounds, by outcome (published/skipped_nodata/skipped_eval/rolled_back/error)", ("outcome",)),
    REFIT_PUBLISHES: ("counter", "Candidate models published by the refit controller", ()),
    REFIT_ROLLBACKS: ("counter", "Automatic rollbacks triggered by the post-publish watch window", ()),
    REFIT_TAP_ROWS: ("counter", "Traffic-tap rows, by status (labeled/mirrored/dropped)", ("status",)),
    REFIT_STATE_ROWS: ("gauge", "Examples absorbed into the persisted refit sufficient statistics", ()),
    REFIT_FOLD_SECONDS: ("histogram", "Incremental refit folds (drain + fold + finish wall time)", ()),
    REFIT_SCORE: ("gauge", "Latest shadow-evaluation score, per role (candidate/incumbent/live)", ("role",)),
    FLIGHT_RECORDS: ("counter", "Entries appended to the flight-recorder ring buffers, by kind (ledger/metrics/mark/quality)", ("kind",)),
    FLIGHT_DUMPS: ("counter", "Flight-recorder dump artifacts written, by trigger", ("trigger",)),
    FLIGHT_DUMP_BYTES: ("gauge", "Size of the last flight-recorder dump artifact written by this process", ()),
    QUALITY_SCORES: ("counter", "Prediction scores observed by the quality plane, per model and stream role (live/labeled/candidate/incumbent)", ("model", "role")),
    QUALITY_SCORE_MEAN: ("gauge", "Running mean of a model's score stream, per role", ("model", "role")),
    QUALITY_SCORE_QUANTILE: ("gauge", "P² quantile markers of a model's score stream (p10/p50/p90), per role", ("model", "role", "q")),
    QUALITY_LABEL_JOINS: ("counter", "Delayed labels joined against served predictions into the labeled score stream (exactly-once via the refit journal)", ("model",)),
    QUALITY_JOIN_LAG_ROWS: ("gauge", "Labeled rows buffered in the tap awaiting the next refit round's label join", ("model",)),
    QUALITY_SKETCH_ROWS: ("gauge", "Payload rows folded into the fleet-merged input-distribution sketch", ("model",)),
    QUALITY_SKETCH_BYTES: ("gauge", "Serialized size of the fleet-merged quality sketch (the bounded-memory contract)", ("model",)),
    QUALITY_SKETCH_MERGES: ("counter", "Worker heartbeat sketch deltas merged fleet-wide, per shipping role", ("role",)),
    QUALITY_DRIFT_EVENTS: ("counter", "Drift events fired by the quality drift detector (edge-triggered threshold crossings)", ("model",)),
    QUALITY_DRIFT_SCORE: ("gauge", "Latest standardized score-shift vs the frozen baseline window, in baseline standard deviations", ("model",)),
    QUALITY_STATE_DECAY: ("gauge", "Effective refit state_decay chosen adaptively from the drift score", ("model",)),
    QUALITY_GATE_DECISIONS: ("counter", "Sequential-gate decisions emitted, by model and decision (promote/rollback)", ("model", "decision")),
    QUALITY_GATE_OPEN: ("gauge", "Sequential tests currently open (still sampling)", ()),
    QUALITY_GATE_SAMPLES: ("gauge", "Samples consumed so far by a model's open sequential gate", ("model",)),
    SERVING_REQUESTS: ("counter", "Requests served to completion", ("model",)),
    SERVING_BATCHES: ("counter", "Micro-batches dispatched", ("model",)),
    SERVING_SHEDS: ("counter", "Requests shed by admission control", ("model",)),
    SERVING_TIMEOUTS: ("counter", "Requests expired before batch assembly", ("model",)),
    SERVING_RETRIES: ("counter", "Apply-path retry attempts", ("model",)),
    SERVING_FAILURES: ("counter", "Requests failed by apply errors", ("model",)),
    SERVING_BUCKET_HITS: ("counter", "Batches padded onto an already-warm bucket", ("model",)),
    SERVING_BUCKET_COMPILES: ("counter", "First batches at a cold bucket", ("model",)),
    SERVING_LATENCY_SECONDS: ("histogram", "End-to-end request latency", ("model",)),
    SERVING_QUEUE_WAIT_SECONDS: ("histogram", "Submit-to-apply queue wait", ("model",)),
    SERVING_BATCH_OCCUPANCY: ("histogram", "Batch size / max_batch", ("model",), "ratio"),
    SERVING_WORKER_RESTARTS: ("counter", "Worker processes restarted by the supervisor", ("reason",)),
    SERVING_WORKER_REQUEUED: ("counter", "In-flight requests requeued off a dead worker", ()),
    SERVING_WORKERS_ALIVE: ("gauge", "Worker processes currently serving", ()),
    SERVING_WORKER_HEARTBEATS: ("counter", "Worker heartbeats received by the supervisor", ("status",)),
    SERVING_SLO_P99_MS: ("gauge", "Observed serving p99 latency, per worker and aggregate", ("worker",)),
    SERVING_SLO_TARGET_MS: ("gauge", "SLO controller p99 target", ()),
    SERVING_SLO_RUNG: ("gauge", "Admission ladder rung index pinned by the SLO controller", ()),
    SERVING_SLO_TRANSITIONS: ("counter", "SLO-driven admission ladder transitions", ("direction",)),
    SERVING_SCALE_EVENTS: ("counter", "Autoscaler fleet scale events, by direction (up/down)", ("direction",)),
    SERVING_SCALE_TARGET_WORKERS: ("gauge", "Worker count the autoscaler is currently steering toward", ()),
    SERVING_SCALE_WORKERS_DRAINING: ("gauge", "Workers currently draining ahead of scale-down removal", ()),
    SERVING_SCALE_DRAIN_SECONDS: ("histogram", "Drain duration from scale-down decision to worker retirement", ()),
    BOOTIMAGE_BUILDS: ("counter", "Boot images built (fitted weights, kernel libraries, parity digests)", ()),
    BOOTIMAGE_LOADS: ("counter", "Boot-image load attempts, by status (loaded/refused)", ("status",)),
    BOOTIMAGE_BUILD_SECONDS: ("histogram", "Whole boot-image builds (parity runs + library bundling)", ()),
    BOOTIMAGE_LOAD_SECONDS: ("histogram", "Boot-image loads (verify, library hydration, weights, parity warm-up)", ()),
    FLEET_SPAN_FRAGMENTS: ("counter", "Span fragments folded into the fleet trace collector, per shipping process role", ("role",)),
    FLEET_TRACE_BYTES: ("counter", "Serialized span-fragment bytes shipped over the heartbeat channel", ()),
    FLEET_CLOCK_SKEW: ("gauge", "Estimated per-process wall-clock offset vs the collector at heartbeat receipt", ("role",)),
    FLEET_REQUESTS: ("counter", "Fleet-aggregated requests served per worker id, monotonic across worker incarnations", ("worker",)),
    FLEET_FAILURES: ("counter", "Fleet-aggregated failed requests per worker id, monotonic across worker incarnations", ("worker",)),
    FLEET_WORKER_SERIES: ("gauge", "Fleet-summed worker-process registry series (heartbeat metric deltas, folded across incarnations), keyed by flat series name", ("series",)),
    INGEST_IMAGES: ("counter", "Records successfully decoded by ingest", ()),
    INGEST_CORRUPT: ("counter", "Records quarantined by ingest", ()),
    INGEST_BYTES: ("counter", "Raw bytes read by ingest", ()),
    INGEST_DECODE_SECONDS: ("counter", "Cumulative decode wall time", ()),
    AUTOCACHE_CACHED_NODES: ("counter", "Cacher nodes inserted by the auto-cache planner", ()),
    AUTOCACHE_HITS: ("counter", "Re-reads of a cached (Cacher) node's memoized result", ()),
    AUTOCACHE_MISSES: ("counter", "First executions of a Cacher node", ()),
    AUTOCACHE_PROFILE_SECONDS: ("histogram", "Auto-cache sample-profiling passes", ()),
    TUNE_CANDIDATES: ("counter", "Candidate configurations measured by the offline autotuner", ("task",)),
    TUNE_WINNERS: ("counter", "Winning configurations persisted to the profile store by the autotuner", ("task",)),
    TUNE_SECONDS: ("histogram", "Whole autotuner task runs (all budgeted measurements)", ("task",)),
    KNOB_REJECTED: ("counter", "Measured knob overrides rejected before applying, by knob and reason", ("knob", "reason")),
    SCHED_LEASES: ("counter", "Mesh-scheduler leases, by work kind and outcome (admitted/deferred/preempted/resumed/completed)", ("kind", "outcome")),
    SCHED_IDLE_HARVEST_SECONDS: ("counter", "Serving idle-gap seconds harvested by admitted background leases", ()),
    SCHED_LEASE_WALL_RATIO: ("histogram", "Measured / predicted lease wall, by price provenance (tune/store/roofline/default); >1 = lease ran slower than priced", ("source",), "ratio"),
    SCHED_REFIT_INTERVAL_SECONDS: ("gauge", "Last pressure-aware refit cadence chosen by the scheduler-governed daemon loop", ()),
    COST_LEDGER_ENTRIES: ("counter", "Perf-ledger entries recorded by the cost observatory, by roofline classification", ("roofline",)),
    COST_DRIFT_EVENTS: ("counter", "Sustained cost-model drift events fired by the drift sentinel, by model", ("model",)),
    COST_DRIFT_RATIO: ("gauge", "Latest measured-vs-predicted cost ratio observed per model (>1 = slower than predicted)", ("model",)),
    COST_HARVEST_COMPILES: ("counter", "Kernel builds triggered by cost harvesting; must stay 0 (facts are counted at launch sites, nothing is built for them)", ()),
    COST_ROOFLINE_PEAK: ("gauge", "Probe-calibrated roofline peaks for this process's card, by resource (flops_per_s/bytes_per_s)", ("resource",)),
    MEMORY_IN_USE_BYTES: ("gauge", "Current memory in use", ("source", "device")),
    PEAK_MEMORY_BYTES: ("gauge", "Peak memory observed, attributed per stage", ("stage", "device")),
}


def metric(name: str, registry: MetricsRegistry = None):
    """Get-or-create a schema metric by name — kind, help text, label
    names, and bucket preset all come from :data:`SCHEMA`, so call sites
    can never drift from the documented registry."""
    registry = registry or get_registry()
    spec = SCHEMA[name]
    kind, help_text, labels = spec[0], spec[1], spec[2]
    if kind == "counter":
        return registry.counter(name, help_text, labels)
    if kind == "gauge":
        return registry.gauge(name, help_text, labels)
    buckets = RATIO_BUCKETS if len(spec) > 3 and spec[3] == "ratio" else DEFAULT_BUCKETS
    return registry.histogram(name, help_text, labels, buckets=buckets)


def register_all(registry: MetricsRegistry = None) -> MetricsRegistry:
    """Pre-register every schema metric (idempotent) so exports include
    zero-valued series. Returns the registry."""
    registry = registry or get_registry()
    for name in SCHEMA:
        metric(name, registry)
    return registry
