"""keystone-lint: house-invariant checks over the port's own code.

Port of ``keystone_tpu/lint/``. The repo half of the static tier (the
graph half is ``workflow/verify.py``): stdlib-``ast`` rules encoding the
invariants the runtime layers depend on — call-time env reads, sync-free
hot paths, declared metric names, registered probe sites, one home for
cost facts (KV5xx, :mod:`.rules`) — plus the concurrency tier (KV6xx,
:mod:`.concurrency` over the :mod:`.lockmodel` lock model): inferred
lock discipline, deadlock-order cycles, blocking-under-lock, and
thread/future hygiene, cross-checked at test time by the instrumented
lock witness (:mod:`.lockwitness`). ``python -m keystone_tpu_torch check
--lint --concurrency`` runs them; ``tests/test_torch_lint.py`` keeps the
tree clean. Stdlib only: importing this package imports no torch.
"""

from .concurrency import (
    ALLOW_BLOCK_UNDER_LOCK,
    ALLOW_LOCK_ORDER,
    ALLOW_SETTLE,
    ALLOW_UNGUARDED,
    ALLOW_UNJOINED,
    CONCURRENCY_CODES,
    analyze_model,
    analyze_paths,
    analyze_sources,
)
from .lockmodel import LockModel, build_model, build_model_from_sources
from .rules import (
    ALLOW_ENV,
    ALLOW_SYNC,
    LINT_CODES,
    Finding,
    LintContext,
    build_context,
    lint_paths,
    lint_source,
)

__all__ = [
    "ALLOW_BLOCK_UNDER_LOCK",
    "ALLOW_ENV",
    "ALLOW_LOCK_ORDER",
    "ALLOW_SETTLE",
    "ALLOW_SYNC",
    "ALLOW_UNGUARDED",
    "ALLOW_UNJOINED",
    "CONCURRENCY_CODES",
    "LINT_CODES",
    "LockModel",
    "Finding",
    "LintContext",
    "analyze_model",
    "analyze_paths",
    "analyze_sources",
    "build_context",
    "build_model",
    "build_model_from_sources",
    "lint_paths",
    "lint_source",
]
