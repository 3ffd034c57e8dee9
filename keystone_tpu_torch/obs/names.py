"""The stable metric-name registry.

A copy of the series of ``keystone_tpu/obs/names.py`` that the port's
modules publish: the executor and optimizer (``keystone_executor_*``,
``keystone_optimizer_*``), fusion, streaming, the profile store, the
block-sparse dispatch, the solvers, the sketch tier, the recovery
ledger and serving.
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

# Image ingest (data/ingest.py::measure_ingest).
INGEST_IMAGES = "keystone_ingest_images_total"
INGEST_CORRUPT = "keystone_ingest_corrupt_total"
INGEST_BYTES = "keystone_ingest_bytes_total"
INGEST_DECODE_SECONDS = "keystone_ingest_decode_seconds_total"


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
    INGEST_IMAGES: ("counter", "Records successfully decoded by ingest", ()),
    INGEST_CORRUPT: ("counter", "Records quarantined by ingest", ()),
    INGEST_BYTES: ("counter", "Raw bytes read by ingest", ()),
    INGEST_DECODE_SECONDS: ("counter", "Cumulative decode wall time", ()),
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
