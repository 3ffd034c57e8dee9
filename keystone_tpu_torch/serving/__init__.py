"""Online serving, in process: micro-batched inference for fitted
pipelines on the card.

Port of the single-process part of ``keystone_tpu/serving/``:

- :mod:`registry`   — versioned models, atomic hot-swap, loading
                      ``FittedPipeline.save`` artifacts onto a device.
- :mod:`batcher`    — bounded queue + deadline-aware micro-batch assembly
                      (max-batch / max-wait).
- :mod:`admission`  — queue-depth backpressure; a DegradationLadder-driven
                      shed policy degrades service level under sustained
                      overload and then refuses loudly.
- :mod:`telemetry`  — p50/p95/p99 latency, queue depth, batch occupancy,
                      bucket-warmth hit rate, shed/timeout counters.
- :mod:`server`     — the threaded front-end: ``submit``/``submit_many``,
                      shape-bucket padding, and the ``serve`` stdin/JSON
                      CLI.
- :mod:`synthetic`  — a synthetic fitted pipeline for smoke tests.

Left out for now (ROADMAP Queue A items 12–14): the multi-worker runtime
(``worker``, ``supervisor``, ``frontend``, ``slo``, ``autoscaler``,
``loadgen``, ``bootimage``), checkpoint loading, the refit tap and the
serving partition.
"""

from .admission import DEFAULT_RUNGS, AdmissionController, AdmissionRung
from .batcher import MicroBatcher
from .config import (
    Request,
    RequestShed,
    RequestTimeout,
    ServerClosed,
    ServingConfig,
    ServingError,
    UnknownModel,
    bucket_for,
    default_bucket_sizes,
)
from .registry import ModelEntry, ModelRegistry
from .server import PipelineServer
from .synthetic import (
    SyntheticDense,
    synthetic_chain_pipeline,
    synthetic_fitted_pipeline,
    synthetic_requests,
)
from .telemetry import ServingTelemetry, percentile

__all__ = [
    "AdmissionController",
    "AdmissionRung",
    "DEFAULT_RUNGS",
    "MicroBatcher",
    "ModelEntry",
    "ModelRegistry",
    "PipelineServer",
    "Request",
    "RequestShed",
    "RequestTimeout",
    "ServerClosed",
    "ServingConfig",
    "ServingError",
    "ServingTelemetry",
    "SyntheticDense",
    "UnknownModel",
    "bucket_for",
    "default_bucket_sizes",
    "percentile",
    "synthetic_chain_pipeline",
    "synthetic_fitted_pipeline",
    "synthetic_requests",
]
