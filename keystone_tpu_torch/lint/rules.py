"""keystone-lint rules: the house invariants, as ``ast`` checks.

Port of ``keystone_tpu/lint/rules.py``, over the port's own tree and its
own registries. The plan-time verifier (``workflow/verify.py``) covers
what flows through a graph; these rules cover what flows through a
*diff* — the recurring review comments that keep the runtime layers
honest, encoded so they fail in tests instead of in review:

========  ============================================================
code      invariant
========  ============================================================
KV501     environment knobs are read through ``envknobs`` only — a raw
          ``os.environ`` / ``os.getenv`` read anywhere else is either
          an import-time snapshot (tests can't monkeypatch it) or an
          undocumented knob. Structural pass-throughs (a supervisor
          cloning its env for a child) annotate ``# keystone: allow-env``.
KV502     no host sync on a span-timed hot path — ``.item()``,
          ``.cpu()``, ``.tolist()``, ``torch.cuda.synchronize()`` or an
          event's ``.synchronize()``, numpy's ``asarray`` (a tensor
          copied to the host) — unless it is under a ``sync``-gated
          branch (``workflow/tracing.py``'s ``sync_timings``
          discipline) or annotated ``# keystone: allow-sync`` with the
          reason.
KV503     every ``keystone_*`` metric-name literal must be declared in
          ``obs/names.py``'s schema — an undeclared name is a series
          dashboards never see.
KV504     every fault-injection ``probe("site")`` label must be
          registered in ``reliability/faultinject.py``'s
          ``KNOWN_PROBE_SITES`` — an unregistered site is chaos surface
          nobody can aim a spec at.
KV506     cost facts are made only in ``obs/cost.py``'s
          ``harvest_cost_facts`` — a ``CostFacts`` built, or
          ``harvest_cost_facts`` called, anywhere else is a second place
          a launch's shape becomes flop and byte counts, which the
          observatory's ledger and the kernel table would disagree with.
========  ============================================================

KV505 (buffer donation without an ownership annotation) has no
counterpart: the port donates no buffer (PyTorch has no
``donate_argnums``; an in-place update writes a buffer the caller
handed over knowingly), so the port's table leaves the code out.

Rules are pure ``ast`` + source-line checks (stdlib only, nothing is
imported from the linted tree, so linting broken code works). Cross-file
context — the metric-name schema, the probe-site registry — is parsed
out of the package's own source by :func:`build_context`. ``python -m
keystone_tpu_torch check --lint`` is the CLI; ``tests/test_torch_lint.py``
keeps the port's tree clean.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

from ..diagnostics import ERROR, Diagnostic

ALLOW_ENV = "keystone: allow-env"
ALLOW_SYNC = "keystone: allow-sync"

#: How far above an expression a pragma comment still applies (a short
#: justification comment block directly over the statement).
_PRAGMA_REACH = 3

#: Modules whose whole point is reading the environment (KV501 exempt).
ENV_MODULES = ("envknobs.py",)

#: Span-timed hot paths (KV502 scope): the per-node execute path, the
#: streamed per-chunk loop, and the serving request/batch loop. A sync
#: anywhere else is a fit-time/setup cost, not a steady-state stall.
HOT_SYNC_MODULES = (
    os.path.join("workflow", "tracing.py"),
    os.path.join("workflow", "executor.py"),
    os.path.join("workflow", "streaming.py"),
    os.path.join("serving", "server.py"),
    os.path.join("serving", "worker.py"),
)

#: Calls that wait for the card: a value read back (``item``, ``cpu``,
#: ``tolist``, numpy's ``asarray`` of a tensor) or a stream/event wait
#: (``torch.cuda.synchronize``, ``Event.synchronize``).
_SYNC_CALLS = ("item", "cpu", "tolist", "synchronize", "asarray")

#: Of those, the ones that are a sync only when called with no argument.
_NO_ARG_SYNC = ("item", "cpu", "tolist")

#: What a published metric name looks like: ``keystone_<family>_<what>``
#: — at least two segments after the prefix, never the package's own
#: ``keystone_tpu[.module]`` import strings.
_METRIC_SHAPE = re.compile(r"keystone_[a-z0-9]+(_[a-z0-9]+)+$")

LINT_CODES: Dict[str, str] = {
    "KV501": "raw environment read outside envknobs",
    "KV502": "unguarded host sync on a span-timed hot path",
    "KV503": "metric name not declared in obs/names.py",
    "KV504": "probe site not registered in KNOWN_PROBE_SITES",
    "KV506": "cost facts made outside obs/cost.py::harvest_cost_facts",
}

#: The one module, and the one function in it, that makes cost facts
#: (KV506).
COST_FACTS_HOME = os.path.join("obs", "cost.py")
COST_FACTS_FUNCTION = "harvest_cost_facts"


class Finding(Diagnostic):
    """One lint/concurrency finding — the source-located face of the
    shared :class:`keystone_tpu_torch.diagnostics.Diagnostic` (one
    reporting path for verify, lint, and concurrency). Keeps the
    ``Finding(rule, path, line, message)`` signature and the JSON shape of
    the JAX package's ``check`` command; ``rule`` aliases ``code``."""

    def __init__(
        self,
        rule: str,
        path: str,
        line: int,
        message: str,
        severity: str = ERROR,
        details: Optional[Dict[str, object]] = None,
    ):
        super().__init__(
            code=rule,
            severity=severity,
            message=message,
            path=path,
            line=line,
            details=dict(details or {}),
        )

    @property
    def rule(self) -> str:
        return self.code

    def to_json(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "rule": self.code,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }
        if self.details:
            out["details"] = self.details
        return out


@dataclass
class LintContext:
    """Cross-file facts the rules check against. ``None`` disables the
    rule that needs it (a fixture tree has no names.py to parse)."""

    metric_names: Optional[Set[str]] = None
    probe_sites: Optional[Set[str]] = None
    #: package-relative paths for KV501/KV502 scoping; findings still
    #: report the caller's path.
    extra_env_modules: Sequence[str] = field(default_factory=tuple)


def _collect_str_constants(tree: ast.Module) -> Dict[str, str]:
    """Module-level ``NAME = "literal"`` assignments."""
    out: Dict[str, str] = {}
    for stmt in tree.body:
        if (
            isinstance(stmt, ast.Assign)
            and isinstance(stmt.value, ast.Constant)
            and isinstance(stmt.value.value, str)
        ):
            for target in stmt.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = stmt.value.value
    return out


def build_context(package_root: str) -> LintContext:
    """Parse the linted package's own registries: metric names out of
    ``obs/names.py`` (every module-level ``keystone_*`` string constant),
    probe sites out of ``reliability/faultinject.py``'s
    ``KNOWN_PROBE_SITES`` frozenset literal."""
    metric_names: Optional[Set[str]] = None
    probe_sites: Optional[Set[str]] = None

    names_py = os.path.join(package_root, "obs", "names.py")
    if os.path.exists(names_py):
        with open(names_py, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=names_py)
        metric_names = {
            value
            for value in _collect_str_constants(tree).values()
            if value.startswith("keystone_")
        }

    fault_py = os.path.join(package_root, "reliability", "faultinject.py")
    if os.path.exists(fault_py):
        with open(fault_py, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=fault_py)
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and t.id == "KNOWN_PROBE_SITES"
                    for t in node.targets
                )
            ):
                probe_sites = {
                    c.value
                    for c in ast.walk(node.value)
                    if isinstance(c, ast.Constant) and isinstance(c.value, str)
                }
    return LintContext(metric_names=metric_names, probe_sites=probe_sites)


# --------------------------------------------------------------------- helpers


def _has_pragma(lines: Sequence[str], node: ast.AST, pragma: str) -> bool:
    """True when ``pragma`` appears on any line of ``node``'s span or in
    the ``_PRAGMA_REACH`` lines directly above it (a justification
    comment block)."""
    start = max(0, node.lineno - 1 - _PRAGMA_REACH)
    end = getattr(node, "end_lineno", node.lineno)
    return any(pragma in line for line in lines[start:end])


def _parents(tree: ast.Module) -> Dict[ast.AST, ast.AST]:
    out: Dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            out[child] = parent
    return out


def _docstring_nodes(tree: ast.Module) -> Set[int]:
    """ids of Constant nodes that are docstrings (skipped by KV503)."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(
            node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            body = node.body
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                out.add(id(body[0].value))
    return out


def _is_env_read(node: ast.AST) -> Optional[ast.AST]:
    """The offending node when ``node`` reads the process environment:
    ``os.environ.get/...``, ``os.environ[...]`` (Load), ``os.getenv``,
    ``x in os.environ``, ``dict(os.environ)``/iteration."""

    def is_os_environ(n: ast.AST) -> bool:
        return (
            isinstance(n, ast.Attribute)
            and n.attr == "environ"
            and isinstance(n.value, ast.Name)
            and n.value.id == "os"
        )

    if isinstance(node, ast.Call):
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "os"
            and func.attr == "getenv"
        ):
            return node
        # os.environ.get(...) / .items() / .keys() / .copy()
        if isinstance(func, ast.Attribute) and is_os_environ(func.value):
            if func.attr in ("__setitem__", "setdefault", "update", "pop"):
                return None  # writes/removals are structural, not knob reads
            return node
        # dict(os.environ), iter(os.environ), sorted(os.environ), ...
        if any(is_os_environ(arg) for arg in node.args):
            return node
    if (
        isinstance(node, ast.Subscript)
        and is_os_environ(node.value)
        and isinstance(node.ctx, ast.Load)
    ):
        return node
    if isinstance(node, ast.Compare) and any(
        is_os_environ(comp) for comp in node.comparators
    ):
        return node
    if isinstance(node, ast.comprehension) and is_os_environ(node.iter):
        return node
    return None


def _under_sync_gate(
    node: ast.AST, parents: Dict[ast.AST, ast.AST], src: str
) -> bool:
    """True when ``node`` sits inside an ``if`` whose test mentions a
    ``sync`` name — the tracing layer's ``if sync: _force(...)``
    discipline — or inside a function whose name spells sync."""
    cursor: Optional[ast.AST] = node
    while cursor is not None:
        if isinstance(cursor, ast.If):
            test_src = ast.get_source_segment(src, cursor.test) or ""
            if "sync" in test_src:
                return True
        if isinstance(cursor, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if "sync" in cursor.name:
                return True
        cursor = parents.get(cursor)
    return False


# ----------------------------------------------------------------------- rules


def _check_env_reads(
    tree: ast.Module, lines: Sequence[str], path: str, ctx: LintContext
) -> Iterable[Finding]:
    basename = os.path.basename(path)
    if basename in ENV_MODULES or path.endswith(tuple(ctx.extra_env_modules)):
        return
    for node in ast.walk(tree):
        hit = _is_env_read(node)
        if hit is None:
            continue
        if _has_pragma(lines, hit, ALLOW_ENV):
            continue
        yield Finding(
            "KV501",
            path,
            hit.lineno,
            "raw environment read — go through keystone_tpu_torch.envknobs "
            "(call-time, monkeypatchable, auditable) or annotate a "
            f"structural pass-through with `# {ALLOW_ENV}`",
        )


def _check_host_sync(
    tree: ast.Module, lines: Sequence[str], path: str, ctx: LintContext
) -> Iterable[Finding]:
    if not path.endswith(HOT_SYNC_MODULES):
        return
    src = "\n".join(lines)
    parents = _parents(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = None
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_CALLS:
            # `.item()` / `.cpu()` / `.tolist()` only as the zero-arg
            # read-back; `asarray` only when it is numpy's.
            if func.attr in _NO_ARG_SYNC and (node.args or node.keywords):
                continue
            if func.attr == "asarray" and not (
                isinstance(func.value, ast.Name)
                and func.value.id in ("np", "numpy")
            ):
                continue
            name = func.attr
        elif isinstance(func, ast.Name) and func.id in ("synchronize",):
            name = func.id
        if name is None:
            continue
        if _under_sync_gate(node, parents, src):
            continue
        if _has_pragma(lines, node, ALLOW_SYNC):
            continue
        yield Finding(
            "KV502",
            path,
            node.lineno,
            f"`{name}` forces a host sync on a span-timed hot path — "
            "gate it behind the session's sync_timings (workflow/"
            f"tracing.py) or annotate the reason with `# {ALLOW_SYNC}`",
        )


def _check_metric_names(
    tree: ast.Module, lines: Sequence[str], path: str, ctx: LintContext
) -> Iterable[Finding]:
    if ctx.metric_names is None or path.endswith(
        os.path.join("obs", "names.py")
    ):
        return
    docstrings = _docstring_nodes(tree)
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and _METRIC_SHAPE.fullmatch(node.value)
            and not node.value.startswith("keystone_tpu")
            and id(node) not in docstrings
            and node.value not in ctx.metric_names
        ):
            yield Finding(
                "KV503",
                path,
                node.lineno,
                f"metric name {node.value!r} is not declared in "
                "obs/names.py's schema — declare it there before "
                "publishing",
            )


def _check_probe_sites(
    tree: ast.Module, lines: Sequence[str], path: str, ctx: LintContext
) -> Iterable[Finding]:
    if ctx.probe_sites is None or path.endswith("faultinject.py"):
        return
    constants = _collect_str_constants(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        fname = (
            func.id
            if isinstance(func, ast.Name)
            else func.attr if isinstance(func, ast.Attribute) else None
        )
        if fname not in ("probe", "wrap") or not node.args:
            continue
        label_node = node.args[0]
        if isinstance(label_node, ast.Constant) and isinstance(
            label_node.value, str
        ):
            label = label_node.value
        elif isinstance(label_node, ast.Name):
            label = constants.get(label_node.id)
        else:
            continue
        if label is None or label in ctx.probe_sites:
            continue
        yield Finding(
            "KV504",
            path,
            node.lineno,
            f"probe site {label!r} is not registered in reliability/"
            "faultinject.py KNOWN_PROBE_SITES — register it so chaos "
            "specs and the failure suite can target it",
        )


def _enclosing_function(node: ast.AST, parents: Dict[ast.AST, ast.AST]) -> Optional[str]:
    cursor = parents.get(node)
    while cursor is not None:
        if isinstance(cursor, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cursor.name
        cursor = parents.get(cursor)
    return None


def _check_cost_facts(
    tree: ast.Module, lines: Sequence[str], path: str, ctx: LintContext
) -> Iterable[Finding]:
    home = path.endswith(COST_FACTS_HOME)
    parents = _parents(tree) if home else {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = (
            func.attr if isinstance(func, ast.Attribute)
            else func.id if isinstance(func, ast.Name) else None
        )
        if name not in ("CostFacts", COST_FACTS_FUNCTION):
            continue
        if home and (
            name == COST_FACTS_FUNCTION
            or _enclosing_function(node, parents) == COST_FACTS_FUNCTION
        ):
            continue
        yield Finding(
            "KV506",
            path,
            node.lineno,
            f"`{name}` outside obs/cost.py::{COST_FACTS_FUNCTION} — a "
            "launch's shape becomes flop and byte facts in exactly one "
            "place; note the launch with obs.cost.note_launch and let the "
            "observatory harvest it",
        )


RULES = (
    _check_env_reads,
    _check_host_sync,
    _check_metric_names,
    _check_probe_sites,
    _check_cost_facts,
)


# ---------------------------------------------------------------------- entry points


def lint_source(
    source: str,
    path: str = "<string>",
    context: Optional[LintContext] = None,
) -> List[Finding]:
    """Lint one module's source. ``path`` scopes the path-sensitive
    rules (KV501 exemptions, KV502 hot modules)."""
    ctx = context if context is not None else LintContext()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [
            Finding(
                "KV500",
                path,
                e.lineno or 1,
                f"syntax error: {e.msg} (unparseable files cannot be linted)",
            )
        ]
    lines = source.splitlines()
    findings: List[Finding] = []
    for rule in RULES:
        findings.extend(rule(tree, lines, path, ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def _find_package_root(paths: Sequence[str]) -> Optional[str]:
    """The package root containing/above ``paths`` (the directory holding
    ``obs/names.py``), for registry parsing."""
    for path in paths:
        probe = os.path.abspath(path)
        if os.path.isfile(probe):
            probe = os.path.dirname(probe)
        while probe and probe != os.path.dirname(probe):
            if os.path.exists(os.path.join(probe, "obs", "names.py")):
                return probe
            probe = os.path.dirname(probe)
    return None


def lint_paths(
    paths: Sequence[str], context: Optional[LintContext] = None
) -> List[Finding]:
    """Lint files/trees. Builds cross-file context from the enclosing
    package when not given; publishes per-rule finding counters."""
    if context is None:
        root = _find_package_root(paths)
        context = build_context(root) if root else LintContext()
    findings: List[Finding] = []
    for fpath in _iter_py_files(paths):
        with open(fpath, "r", encoding="utf-8") as fh:
            source = fh.read()
        findings.extend(lint_source(source, path=fpath, context=context))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    try:  # metrics are best-effort: linting must work without obs
        from ..obs import names as _names

        counter = _names.metric(_names.VERIFY_LINT_FINDINGS)
        for finding in findings:
            counter.inc(rule=finding.rule)
    except Exception:
        pass
    return findings
