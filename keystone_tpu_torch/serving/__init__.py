"""Online serving: micro-batched inference for fitted pipelines on the
card, in one process or across a supervised fleet of worker processes.

Port of ``keystone_tpu/serving/``:

- :mod:`registry`   — versioned models, atomic hot-swap, loading
                      ``FittedPipeline.save`` artifacts and checkpoint
                      store entries onto a device.
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
- :mod:`worker`     — one server behind a JSON-lines control pipe: the
                      worker-process side of the multi-worker runtime.
- :mod:`supervisor` — N worker processes with heartbeat monitoring,
                      backoff restarts, and in-flight requeue (a SIGKILL
                      mid-batch drops zero requests).
- :mod:`slo`        — drives the admission ladder from observed p99 vs
                      target instead of queue depth.
- :mod:`frontend`   — stdlib HTTP JSON front door over the supervisor;
                      the stdin CLI is just another client.
- :mod:`autoscaler` — sustained p99/backlog pressure adds workers,
                      sustained idle drains them (zero dropped in-flight).
- :mod:`loadgen`    — seeded diurnal/bursty/heavy-tail arrival processes
                      and a replay harness.
- :mod:`bootimage`  — versioned boot artifacts: fitted weights, the
                      kernel libraries the apply loads, parity digests
                      per bucket, refused by KV307 when stale.
- :mod:`synthetic`  — a synthetic fitted pipeline for smoke tests.

The modules that hold models (``registry``, ``server``, ``synthetic``,
``bootimage``) import torch and resolve lazily (PEP 562); the fleet's
control plane imports none of it, so a stub worker and ``serve --help``
start without it.

Under a mesh with several row shards the server's warmup attaches the
serving partition (``parallel.partitioner.attach_serving_partition``):
each divisible batch is applied shard by shard.
"""

from .admission import DEFAULT_RUNGS, AdmissionController, AdmissionRung
from .autoscaler import Autoscaler, AutoscalerConfig
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
from .frontend import ServingFrontend
from .loadgen import LoadReport, bursty_offsets, diurnal_offsets, heavy_tail_offsets, run_load
from .slo import SLO_RUNGS, SLOController
from .supervisor import HashRing, SupervisorConfig, WorkerSupervisor
from .telemetry import ServingTelemetry, percentile

_LAZY = {
    "ModelEntry": "keystone_tpu_torch.serving.registry",
    "ModelRegistry": "keystone_tpu_torch.serving.registry",
    "PipelineServer": "keystone_tpu_torch.serving.server",
    "SyntheticDense": "keystone_tpu_torch.serving.synthetic",
    "synthetic_chain_pipeline": "keystone_tpu_torch.serving.synthetic",
    "synthetic_fitted_pipeline": "keystone_tpu_torch.serving.synthetic",
    "synthetic_requests": "keystone_tpu_torch.serving.synthetic",
    "BootImageError": "keystone_tpu_torch.serving.bootimage",
    "BootImageModel": "keystone_tpu_torch.serving.bootimage",
    "BootImageRefused": "keystone_tpu_torch.serving.bootimage",
    "build_boot_image": "keystone_tpu_torch.serving.bootimage",
    "load_boot_image": "keystone_tpu_torch.serving.bootimage",
}

__all__ = sorted(
    [
        "AdmissionController", "AdmissionRung", "Autoscaler", "AutoscalerConfig", "DEFAULT_RUNGS",
        "HashRing", "LoadReport", "MicroBatcher", "Request", "RequestShed", "RequestTimeout",
        "SLOController", "SLO_RUNGS", "ServerClosed", "ServingConfig", "ServingError",
        "ServingFrontend", "ServingTelemetry", "SupervisorConfig", "UnknownModel",
        "WorkerSupervisor", "bucket_for", "bursty_offsets", "default_bucket_sizes",
        "diurnal_offsets", "heavy_tail_offsets", "percentile", "run_load",
    ]
    + list(_LAZY)
)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
