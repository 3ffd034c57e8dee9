"""Failure taxonomy: classify an exception into the recovery path it gets.

A copy of ``keystone_tpu/reliability/errors.py``. KeystoneML inherited
fault tolerance from Spark RDD lineage — a lost partition was recomputed
from its parents, and the framework never had to name its failure modes.
This package executes through a memoizing in-process interpreter, so
failures must be classified explicitly:

- ``TRANSIENT``   — relay/coordinator hiccups, preemptions, dropped
                    connections. Worth retrying with backoff (retry.py).
- ``OOM``         — RESOURCE_EXHAUSTED / allocator failures, including
                    ``torch.cuda.OutOfMemoryError`` ("CUDA out of
                    memory"), which the port's CUDA sources also raise,
                    with "out of memory" in the message, for their own
                    failed allocations (``ops/cuda/_build.raise_status``:
                    cuBLAS's ``CUBLAS_STATUS_ALLOC_FAILED`` reads "the
                    resource allocation failed", which no pattern
                    matches). Retrying the same shape re-OOMs; the
                    recovery is a
                    :class:`~keystone_tpu_torch.reliability.degrade.DegradationLadder`
                    rung at a smaller block/batch size.
- ``DEADLINE``    — a node ran past its execution deadline (a hung relay
                    looks like an infinite compile). Retryable: the retry
                    re-dispatches, usually onto a healthy channel.
- ``CORRUPT_DATA``— undecodable / malformed input records. Neither retry
                    nor shrinking helps; the recovery is skip-and-quarantine
                    at the ingest layer (data/ingest.py, data/loaders/*).
- ``PERMANENT``   — user/programming errors (bad shapes, bad config).
                    Never retried; they must propagate unchanged.

Classification is message-pattern first (an allocator failure can
surface as several exception types depending on the dispatch path), then
exception-type. The pattern table is data (`CLASSIFICATION_TABLE`) so tests
and docs state the taxonomy from the same source.
"""

from __future__ import annotations

import enum
from typing import Tuple


class ErrorClass(enum.Enum):
    TRANSIENT = "transient"
    OOM = "oom"
    DEADLINE = "deadline"
    CORRUPT_DATA = "corrupt_data"
    PERMANENT = "permanent"


class DeadlineExceeded(TimeoutError):
    """A unit of work ran past its execution deadline."""


class CorruptRecordError(ValueError):
    """An input record failed validation/decoding (quarantine, don't abort)."""


# (class, uppercase substrings of str(exc)) — first match wins, in order.
# OOM before TRANSIENT: an OOM raised through a relay RPC can carry both
# RESOURCE_EXHAUSTED and connection noise in one message, and shrinking is
# the recovery that actually converges.
CLASSIFICATION_TABLE: Tuple[Tuple[ErrorClass, Tuple[str, ...]], ...] = (
    (
        ErrorClass.OOM,
        (
            "RESOURCE_EXHAUSTED",
            "OUT OF MEMORY",
            "OUT-OF-MEMORY",
            "ALLOCATION FAILURE",
            "HBM OOM",
        ),
    ),
    (
        ErrorClass.DEADLINE,
        ("DEADLINE_EXCEEDED", "EXECUTION DEADLINE"),
    ),
    (
        ErrorClass.CORRUPT_DATA,
        ("DATA_LOSS", "CORRUPT RECORD", "CORRUPTED RECORD"),
    ),
    (
        ErrorClass.TRANSIENT,
        (
            "UNAVAILABLE",
            "CONNECTION RESET",
            "CONNECTION REFUSED",
            "BROKEN PIPE",
            "SOCKET CLOSED",
            "COORDINATOR",
            "PREEMPT",
            "HEARTBEAT",
            "BARRIER TIMED OUT",
            "TRANSIENT",
            "TEMPORARILY",
        ),
    ),
)


def classify_error(exc: BaseException) -> ErrorClass:
    """Map an exception to its :class:`ErrorClass`.

    Message patterns win over exception type — the same allocator failure
    surfaces as ``torch.cuda.OutOfMemoryError``, RuntimeError, or
    ValueError depending on where in the dispatch stack it is raised.
    """
    if isinstance(exc, DeadlineExceeded):
        return ErrorClass.DEADLINE
    if isinstance(exc, CorruptRecordError):
        return ErrorClass.CORRUPT_DATA
    if isinstance(exc, MemoryError):
        return ErrorClass.OOM

    message = str(exc).upper()
    for error_class, patterns in CLASSIFICATION_TABLE:
        if any(p in message for p in patterns):
            return error_class

    if isinstance(exc, (ConnectionError, TimeoutError)):
        return ErrorClass.TRANSIENT
    if isinstance(exc, OSError):
        # I/O flakiness on data paths (NFS hiccups, EINTR); user errors on
        # data paths raise FileNotFoundError before any device work starts.
        if isinstance(exc, (FileNotFoundError, PermissionError, IsADirectoryError)):
            return ErrorClass.PERMANENT
        return ErrorClass.TRANSIENT
    return ErrorClass.PERMANENT


def is_oom(exc: BaseException) -> bool:
    return classify_error(exc) is ErrorClass.OOM
