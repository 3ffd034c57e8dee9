"""Fault handling, copied from ``keystone_tpu/reliability/``.

- :mod:`errors`      — the failure taxonomy (`classify_error`).
- :mod:`retry`       — `RetryPolicy` (classified retries, deterministic
                       backoff), `Deadline` / `run_with_deadline` /
                       `wait_until` watchdogs.
- :mod:`degrade`     — `DegradationLadder`: shrink a configuration on
                       OOM and say what was given up.
- :mod:`faultinject` — deterministic fault injection for tests, and the
                       ``kill`` kind carried to child processes through
                       ``KEYSTONE_FAULT_SPECS``.
- :mod:`recovery`    — the process-wide ledger of how a run survived,
                       and the loaders' `QuarantineCounts`.
- :mod:`checkpoint`  — `CheckpointStore`: fitted prefixes persisted under
                       stable digests (`enable_checkpointing`).
- :mod:`durable`     — mid-stream resume: cursors, resume entries, the
                       `DurableFold` the streaming engine commits, and
                       `ShardLossError` / `shard_loss_index`, the elastic
                       fold's shard-loss signal.

The serving layer uses them (its retry policy, admission ladder and
``serving.apply`` probe), the streaming engine its ``streaming.chunk``
probe, the executor its per-node retry, deadline and fault injection
(``PipelineEnv.retry_policy``), the block solver its OOM ladder and
``BlockLeastSquaresEstimator.solve`` probe, and ``load_csv`` its
quarantine publishing, and the executor its checkpoint hook
(``PipelineEnv.checkpoint``).

The checkpoint store imports torch and resolves lazily (PEP 562): a stub
serving worker and ``serve --help`` import this package without torch.
"""

from .degrade import DegradationLadder, LadderExhausted, halving_rungs
from .errors import (
    CLASSIFICATION_TABLE,
    CorruptRecordError,
    DeadlineExceeded,
    ErrorClass,
    classify_error,
    is_oom,
)
from .faultinject import (
    KNOWN_PROBE_SITES,
    FaultInjector,
    FaultSpec,
    InjectedOOM,
    InjectedTransient,
    injected,
    install_from_env,
    probe,
    specs_from_env,
    specs_to_env,
)
from .recovery import RecoveryLog, get_recovery_log, reset_recovery_log
from .retry import Deadline, RetryPolicy, run_with_deadline, wait_until

_LAZY = {
    "CheckpointStore": "keystone_tpu_torch.reliability.checkpoint",
    "enable_checkpointing": "keystone_tpu_torch.reliability.checkpoint",
    "prefix_digest": "keystone_tpu_torch.reliability.checkpoint",
    "ShardLossError": "keystone_tpu_torch.reliability.durable",
    "shard_loss_index": "keystone_tpu_torch.reliability.durable",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "CLASSIFICATION_TABLE",
    "CheckpointStore",
    "CorruptRecordError",
    "Deadline",
    "DeadlineExceeded",
    "DegradationLadder",
    "ErrorClass",
    "FaultInjector",
    "FaultSpec",
    "InjectedOOM",
    "InjectedTransient",
    "KNOWN_PROBE_SITES",
    "LadderExhausted",
    "RecoveryLog",
    "RetryPolicy",
    "ShardLossError",
    "classify_error",
    "enable_checkpointing",
    "get_recovery_log",
    "halving_rungs",
    "injected",
    "install_from_env",
    "is_oom",
    "prefix_digest",
    "probe",
    "reset_recovery_log",
    "run_with_deadline",
    "shard_loss_index",
    "specs_from_env",
    "specs_to_env",
    "wait_until",
]
