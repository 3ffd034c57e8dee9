"""Fault handling, copied from ``keystone_tpu/reliability/``.

- :mod:`errors`      — the failure taxonomy (`classify_error`).
- :mod:`retry`       — `RetryPolicy` (classified retries, deterministic
                       backoff), `Deadline` / `run_with_deadline` /
                       `wait_until` watchdogs.
- :mod:`degrade`     — `DegradationLadder`: shrink a configuration on
                       OOM and say what was given up.
- :mod:`faultinject` — deterministic fault injection for tests.
- :mod:`recovery`    — the process-wide ledger of how a run survived,
                       and the loaders' `QuarantineCounts`.

The serving layer uses them (its retry policy, admission ladder and
``serving.apply`` probe), the streaming engine its ``streaming.chunk``
probe, the executor its per-node retry, deadline and fault injection
(``PipelineEnv.retry_policy``), the block solver its OOM ladder and
``BlockLeastSquaresEstimator.solve`` probe, and ``load_csv`` its
quarantine publishing. The executor's checkpoint hook,
``checkpoint.py`` and ``durable.py`` are not ported yet.
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
    probe,
)
from .recovery import RecoveryLog, get_recovery_log, reset_recovery_log
from .retry import Deadline, RetryPolicy, run_with_deadline, wait_until

__all__ = [
    "CLASSIFICATION_TABLE",
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
    "classify_error",
    "get_recovery_log",
    "halving_rungs",
    "injected",
    "is_oom",
    "probe",
    "reset_recovery_log",
    "run_with_deadline",
    "wait_until",
]
