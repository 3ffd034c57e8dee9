"""Fault handling, copied from ``keystone_tpu/reliability/``.

- :mod:`errors`      — the failure taxonomy (`classify_error`).
- :mod:`retry`       — `RetryPolicy` (classified retries, deterministic
                       backoff), `Deadline` / `run_with_deadline` /
                       `wait_until` watchdogs.
- :mod:`degrade`     — `DegradationLadder`: shrink a configuration on
                       OOM and say what was given up.
- :mod:`faultinject` — deterministic fault injection for tests.
- :mod:`recovery`    — the process-wide ledger of how a run survived.

The serving layer uses them (its retry policy, admission ladder and
``serving.apply`` probe), and the streaming engine its
``streaming.chunk`` probe. The executor's per-node retry, deadline and
checkpoint hooks, the solvers' OOM ladders, ``checkpoint.py`` and
``durable.py`` are not ported yet.
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
