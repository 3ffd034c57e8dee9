"""Concurrency rules: the KV6xx family over the static lock model.

Copied from ``keystone_tpu/lint/concurrency.py``. The rules half of the
concurrency tier — :mod:`.lockmodel` extracts the facts (locks, guard
statistics, the acquired-while-holding graph, thread spawns, blocking
calls, future settles); this module turns them into stable, documented
findings the same way :mod:`.rules` does for KV5xx. ``python -m
keystone_tpu_torch check --concurrency`` is the CLI;
``tests/test_torch_lint.py`` keeps the port's tree clean and pins, on
seeded sources, that every rule still fires. The dynamic cross-check
lives in :mod:`.lockwitness`:
instrumented locks record the acquisition orders tests actually take,
and an observed edge absent from this model's graph fails the run — the
model and the runtime cannot silently drift.

========  ============================================================
code      invariant
========  ============================================================
KV601     an attribute a class guards with a lock in the (strict)
          majority of its accesses must not be MUTATED without that
          lock — the unlocked read-modify-write drops updates the
          moment a second thread exists. Reviewed exceptions annotate
          ``# keystone: allow-unguarded(reason)``.
KV602     the inter-class acquired-while-holding graph must be acyclic
          — a cycle is a potential deadlock; the finding carries the
          exact closed path (mirroring KV401's cycle reporting). A
          non-reentrant lock re-acquired while already held is the
          one-lock cycle. A deliberate edge (e.g. instance-disjoint by
          construction) annotates
          ``# keystone: allow-lock-order(reason)`` at the acquisition
          site, which drops it from cycle detection but NOT from the
          witness graph.
KV603     no blocking wait while holding a lock — ``Future.result``,
          ``queue.get``, thread/process ``join``/``wait``, ``sleep``,
          socket/subprocess waits stall every thread parked on the
          lock. ``Condition.wait`` on the held lock's own condition is
          the idiom, not a finding. Reviewed sites annotate
          ``# keystone: allow-block-under-lock(reason)``.
KV604     a non-daemon thread must be joined (or annotated
          ``# keystone: allow-unjoined(reason)``) — an untracked
          non-daemon thread outlives shutdown and hangs interpreter
          exit.
KV605     futures are settled only through the shared settle-once
          helpers in ``serving/config.py`` (``settle_result`` /
          ``settle_exception``) — a raw ``set_result``/``set_exception``
          races shutdown/requeue paths into InvalidStateError crashes.
          Annotate ``# keystone: allow-settle(reason)`` where a future
          is provably single-owner.
========  ============================================================
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from .lockmodel import LockModel, build_model, build_model_from_sources
from .rules import Finding, _has_pragma  # shared pragma reach

ALLOW_UNGUARDED = "keystone: allow-unguarded"
ALLOW_LOCK_ORDER = "keystone: allow-lock-order"
ALLOW_BLOCK_UNDER_LOCK = "keystone: allow-block-under-lock"
ALLOW_UNJOINED = "keystone: allow-unjoined"
ALLOW_SETTLE = "keystone: allow-settle"

#: Future-settling outside this module is KV605 (the helpers live here).
SETTLE_MODULE = os.path.join("serving", "config.py")

CONCURRENCY_CODES: Dict[str, str] = {
    "KV601": "majority-guarded attribute mutated without its lock",
    "KV602": "lock-order cycle (potential deadlock)",
    "KV603": "blocking call while holding a lock",
    "KV604": "non-daemon thread never joined",
    "KV605": "future settled outside the shared settle-once helpers",
}


class _Pragmas:
    """Pragma lookup against the model's per-file source lines."""

    def __init__(self, model: LockModel):
        self._lines = model.lines

    def has(self, path: str, line: int, pragma: str) -> bool:
        lines = self._lines.get(path)
        if lines is None:
            return False

        class _Anchor:
            lineno = line
            end_lineno = line

        return _has_pragma(lines, _Anchor, pragma)


# ----------------------------------------------------------------- KV601


def _check_guarded_writes(model: LockModel, pragmas: _Pragmas) -> List[Finding]:
    findings: List[Finding] = []
    by_attr: Dict[Tuple[str, str], list] = {}
    for access in model.accesses:
        if access.func.rsplit(".", 1)[-1] in ("__init__", "__new__", "__post_init__"):
            continue
        by_attr.setdefault((access.cls, access.attr), []).append(access)
    for (cls, attr), accesses in sorted(by_attr.items()):
        lock_counts: Counter = Counter()
        for access in accesses:
            for lock in access.held:
                lock_counts[lock] += 1
        if not lock_counts:
            continue
        guard, guarded_n = lock_counts.most_common(1)[0]
        total = len(accesses)
        if guarded_n < 2 or guarded_n * 2 <= total:
            continue  # no strict-majority guard inferred
        for access in accesses:
            if not access.write or guard in access.held:
                continue
            if pragmas.has(access.path, access.line, ALLOW_UNGUARDED):
                continue
            thread_note = (
                " on a thread-entry-reachable path"
                if access.thread_reachable else ""
            )
            findings.append(
                Finding(
                    "KV601",
                    access.path,
                    access.line,
                    f"`self.{attr}` is guarded by `{guard}` in "
                    f"{guarded_n}/{total} accesses but mutated here "
                    f"({access.func}){thread_note} without it — an unlocked "
                    "read-modify-write drops updates under concurrency; "
                    f"take the lock or annotate `# {ALLOW_UNGUARDED}(reason)`",
                    details={
                        "class": cls, "attr": attr, "guard": guard,
                        "guarded": guarded_n, "total": total,
                        "thread_reachable": access.thread_reachable,
                        "func": access.func,
                    },
                )
            )
    return findings


# ----------------------------------------------------------------- KV602


def _check_lock_order(model: LockModel, pragmas: _Pragmas) -> List[Finding]:
    # Drop an edge PAIR from cycle detection only when EVERY site that
    # produces it carries the pragma — one annotated site must not hide
    # an unreviewed site elsewhere taking the same order. The witness
    # still compares against the FULL graph, so the runtime stays
    # covered either way.
    pruned_edges = {}
    for pair, sites in model.edges.items():
        keep = [
            s for s in sites
            if not pragmas.has(s.path, s.line, ALLOW_LOCK_ORDER)
        ]
        if keep:
            pruned_edges[pair] = keep
    pruned = LockModel(locks=model.locks, edges=pruned_edges)
    findings: List[Finding] = []
    for cycle in pruned.find_cycles():
        path_text = " -> ".join(cycle)
        sites = []
        for a, b in zip(cycle, cycle[1:]):
            site = pruned.first_site((a, b))
            if site is not None:
                sites.append(
                    f"{os.path.basename(site.path)}:{site.line} "
                    f"({site.func}) holds `{a}` while acquiring `{b}`"
                    + (f" via {site.via}" if site.via and site.via != "self" else "")
                )
        anchor = pruned.first_site((cycle[0], cycle[1]))
        if len(cycle) == 2 and cycle[0] == cycle[1]:
            message = (
                f"non-reentrant lock `{cycle[0]}` may be acquired while "
                f"already held ({'; '.join(sites)}) — this self-deadlocks; "
                "use an RLock or restructure"
            )
        else:
            message = (
                f"lock-order cycle {path_text} — two threads taking these "
                f"locks in opposite orders deadlock ({'; '.join(sites)}); "
                "impose one global order or annotate a provably "
                f"instance-disjoint edge with `# {ALLOW_LOCK_ORDER}(reason)`"
            )
        findings.append(
            Finding(
                "KV602",
                anchor.path if anchor else "<model>",
                anchor.line if anchor else 0,
                message,
                details={"cycle": cycle, "sites": sites},
            )
        )
    return findings


# ----------------------------------------------------------------- KV603


def _check_blocking(model: LockModel, pragmas: _Pragmas) -> List[Finding]:
    findings: List[Finding] = []
    for site in model.blocking:
        if pragmas.has(site.path, site.line, ALLOW_BLOCK_UNDER_LOCK):
            continue
        held = ", ".join(sorted(site.held))
        findings.append(
            Finding(
                "KV603",
                site.path,
                site.line,
                f"`{site.call}` blocks ({site.kind}) while holding "
                f"`{held}` ({site.func}) — every thread parked on the lock "
                "stalls behind this wait; move it outside the critical "
                f"section or annotate `# {ALLOW_BLOCK_UNDER_LOCK}(reason)`",
                details={
                    "call": site.call, "kind": site.kind,
                    "held": sorted(site.held), "func": site.func,
                },
            )
        )
    return findings


# ----------------------------------------------------------------- KV604


def _join_segments(facts) -> set:
    """Joined-name segments visible in one function: direct receivers
    plus the sources of `for t in <src>: t.join()` loops."""
    out = set()
    for root in facts.join_roots:
        out.add(root.split(".")[-1])
        source = facts.loop_aliases.get(root.split(".")[0])
        if source:
            out.add(source.split(".")[-1])
    return out


def _check_thread_hygiene(model: LockModel, pragmas: _Pragmas) -> List[Finding]:
    global_segments = set()
    for facts in model.functions.values():
        global_segments |= _join_segments(facts)
    findings: List[Finding] = []
    for site in model.threads:
        if site.daemon is True:
            continue
        if pragmas.has(site.path, site.line, ALLOW_UNJOINED):
            continue
        bound_seg = site.bound_to.split(".")[-1] if site.bound_to else None
        if bound_seg:
            if "." in (site.bound_to or ""):
                # Attribute binding (self._monitor, worker.reader_thread):
                # any join in the package counts (shutdown paths join far
                # from the spawn site).
                joined = bound_seg in global_segments
            else:
                # Local binding: only a join in the SAME function counts —
                # another function's local `t.join()` says nothing about
                # this thread.
                owner = model.functions.get(site.func)
                joined = owner is not None and bound_seg in _join_segments(owner)
            if joined:
                continue
        what = (
            f"bound to `{site.bound_to}` but never joined"
            if site.bound_to else "anonymous (never joinable)"
        )
        findings.append(
            Finding(
                "KV604",
                site.path,
                site.line,
                f"non-daemon Thread {what} ({site.func}) — it outlives "
                "shutdown and hangs interpreter exit; pass daemon=True, "
                f"join it, or annotate `# {ALLOW_UNJOINED}(reason)`",
                details={
                    "bound_to": site.bound_to, "daemon": site.daemon,
                    "func": site.func,
                },
            )
        )
    return findings


# ----------------------------------------------------------------- KV605


def _check_settles(model: LockModel, pragmas: _Pragmas) -> List[Finding]:
    findings: List[Finding] = []
    for site in model.settles:
        if site.path.endswith(SETTLE_MODULE):
            continue
        if pragmas.has(site.path, site.line, ALLOW_SETTLE):
            continue
        findings.append(
            Finding(
                "KV605",
                site.path,
                site.line,
                f"raw `{site.method}` ({site.func}) — a future can be "
                "settled twice when shutdown/requeue races completion, and "
                "the second settle crashes with InvalidStateError; use "
                "serving/config.py settle_result/settle_exception, or "
                f"annotate `# {ALLOW_SETTLE}(reason)` for a provably "
                "single-owner future",
                details={"method": site.method, "func": site.func},
            )
        )
    return findings


# ------------------------------------------------------------------ entry points


_RULES = (
    _check_guarded_writes,
    _check_lock_order,
    _check_blocking,
    _check_thread_hygiene,
    _check_settles,
)


def analyze_model(model: LockModel) -> List[Finding]:
    pragmas = _Pragmas(model)
    findings: List[Finding] = []
    for rule in _RULES:
        findings.extend(rule(model, pragmas))
    findings.sort(key=lambda f: (f.path, f.line or 0, f.code))
    return findings


def analyze_paths(
    paths: Sequence[str], model: Optional[LockModel] = None
) -> Tuple[List[Finding], LockModel]:
    """Analyze files/trees; returns (findings, model) — the model rides
    along for the CLI's lock-graph JSON and the witness baseline."""
    if model is None:
        model = build_model(paths)
    return analyze_model(model), model


def analyze_sources(sources: Dict[str, str]) -> Tuple[List[Finding], LockModel]:
    """In-memory variant for rule unit tests."""
    model = build_model_from_sources(sources)
    return analyze_model(model), model
