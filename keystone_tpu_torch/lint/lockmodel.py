"""Static lock model: who holds what, while doing what.

Copied from ``keystone_tpu/lint/lockmodel.py``. The fact-extraction
half of the concurrency tier (the rules half is
:mod:`keystone_tpu_torch.lint.concurrency`). Pure stdlib-``ast`` over
source trees — nothing from the analyzed tree is imported, so analyzing
broken or torch-dependent code costs nothing and works everywhere the
lint tier works.

What is extracted, per package:

- **lock declarations** — ``self._x = threading.Lock()/RLock()/
  Condition()/Semaphore()`` in methods, class-body locks, and
  module-level locks. ``Condition(self._lock)`` aliases the wrapped
  lock (entering the condition IS entering the lock). Every lock gets a
  stable node name (``serving.batcher.MicroBatcher._lock``) and an
  allocation site — the witness (:mod:`.lockwitness`) names runtime
  locks by matching these sites.
- **a lite type environment** — parameter/return annotations,
  ``self.x = ClassName(...)`` constructor assignments, module-level
  singletons plus their accessor functions, ``Dict[...]``/``List[...]``
  element types for loop variables, and base-class joins for functions
  whose returns diverge (``names.metric`` → ``Metric``). Unresolvable
  expressions stay unresolved: the model under-approximates, it never
  guesses.
- **function summaries** — a lexical walk of every function tracking
  the currently-held lock set: lock acquisitions (and so
  acquired-while-holding edges), calls made per held-set, blocking
  calls under a lock, ``self._*`` attribute reads/writes with the held
  set at each site, thread spawns, and future-settling calls.
  Methods named ``*_locked`` are re-walked with the intersection of
  their callers' held sets seeded (the house convention: the caller
  holds the guard).
- **the lock-order graph** — a fixpoint over call summaries resolves
  transitive acquisitions, so ``A.f`` holding ``A._lock`` and calling
  ``B.g`` which takes ``B._lock`` yields the edge
  ``A._lock → B._lock`` even across modules. Cycles in this graph are
  the KV602 deadlock candidates.

The model deliberately ignores semaphores for ordering (counting, not
mutual exclusion) and records an explicit ``.acquire()`` as an edge
source but not a scope (its release is untrackable lexically).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

LOCK_FACTORIES = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "Semaphore": "semaphore",
    "BoundedSemaphore": "semaphore",
}

#: Mutating container-method names that count as writes to the attribute.
MUTATOR_METHODS = frozenset(
    {
        "append", "appendleft", "extend", "extendleft", "add", "update",
        "insert", "remove", "discard", "pop", "popleft", "popitem",
        "clear", "setdefault", "sort", "reverse",
    }
)

#: Receiver-name hints that a ``.join()`` is a thread/process join, not
#: a string join.
_JOIN_HINTS = ("thread", "proc", "worker", "monitor")

#: Distinguished graph node: a STORED CALLABLE invoked while a lock is
#: held (``self._thunk()`` in Expression.get, the batcher's
#: ``_on_expired`` callback). The model cannot see inside it, so the
#: holding lock is declared open-world: the edge ``holder → <callback>``
#: lands in the graph, cycle detection ignores the node (it has no
#: outgoing edges), and the lock witness accepts any runtime edge out of
#: such a holder instead of reporting model drift.
CALLBACK = "<callback>"

import builtins as _builtins

_BUILTIN_NAMES = frozenset(dir(_builtins))


# ----------------------------------------------------------------- datatypes


@dataclass(frozen=True)
class LockDecl:
    """One declared lock: its stable node name and allocation site."""

    name: str          # e.g. "serving.batcher.MicroBatcher._lock"
    cls: Optional[str]  # defining class simple name (None: module-level)
    attr: str          # attribute / module variable name
    path: str          # path as given to the analyzer
    relpath: str       # package-relative path ("serving/batcher.py")
    line: int          # allocation line (the witness keys on this)
    kind: str          # lock | rlock | condition | semaphore


@dataclass
class Access:
    """One ``self._attr`` access inside a method."""

    cls: str
    attr: str
    path: str
    line: int
    func: str                  # qualname "Class.method"
    write: bool
    held: FrozenSet[str]       # lock node names held at the access
    thread_reachable: bool = False


@dataclass
class EdgeSite:
    holder: str
    acquired: str
    path: str
    line: int
    func: str
    via: str = ""              # callee chain for indirect edges


@dataclass
class BlockSite:
    path: str
    line: int
    func: str
    call: str                  # rendered call, e.g. "time.sleep"
    held: FrozenSet[str]
    kind: str                  # sleep | result | join | wait | subprocess | socket | semaphore


@dataclass
class ThreadSite:
    path: str
    line: int
    func: str
    daemon: Optional[bool]     # True/False when a constant, None when absent/dynamic
    bound_to: Optional[str]    # dotted binding ("self._monitor"), None when anonymous
    target: Optional[str]      # resolved target qualname when known


@dataclass
class SettleSite:
    path: str
    line: int
    func: str
    method: str                # set_result | set_exception


@dataclass
class _ClassInfo:
    name: str
    module: "_ModuleInfo"
    node: ast.ClassDef
    bases: List[str] = field(default_factory=list)
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    lock_attrs: Dict[str, LockDecl] = field(default_factory=dict)
    lock_aliases: Dict[str, str] = field(default_factory=dict)  # attr -> attr
    attr_types: Dict[str, "_TypeRef"] = field(default_factory=dict)

    @property
    def qualname(self) -> str:
        return f"{self.module.dotted}.{self.name}"


@dataclass
class _ModuleInfo:
    path: str
    relpath: str
    dotted: str
    tree: ast.Module
    lines: List[str]
    classes: Dict[str, _ClassInfo] = field(default_factory=dict)
    functions: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    module_locks: Dict[str, LockDecl] = field(default_factory=dict)
    module_aliases: Dict[str, str] = field(default_factory=dict)   # name -> dotted tail
    name_imports: Dict[str, str] = field(default_factory=dict)     # name -> imported name
    singletons: Dict[str, "_TypeRef"] = field(default_factory=dict)


@dataclass(frozen=True)
class _TypeRef:
    """A lite type: a program class (by simple name) or a container of one."""

    cls: str
    container: Optional[str] = None  # "dict" | "list" | None


def _is_threading_call(node: ast.AST) -> Optional[str]:
    """The lock kind when ``node`` is ``threading.X(...)`` (or bare
    ``Lock()`` imported from threading is NOT assumed — only the
    attribute form, which is the house idiom)."""
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    if (
        isinstance(func, ast.Attribute)
        and isinstance(func.value, ast.Name)
        and func.value.id == "threading"
        and func.attr in LOCK_FACTORIES
    ):
        return LOCK_FACTORIES[func.attr]
    return None


def _dotted(expr: ast.AST) -> Optional[str]:
    """Render ``a.b.c`` / ``self.x`` as a dotted string, else None."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        base = _dotted(expr.value)
        return f"{base}.{expr.attr}" if base else None
    return None


def _ann_typeref(ann: Optional[ast.AST]) -> Optional[_TypeRef]:
    """Parse an annotation into a lite type ref: ``_Worker``,
    ``"_Worker"``, ``Optional[_Worker]``, ``Dict[str, _Worker]``,
    ``List[_Worker]``."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        text = ann.value.strip().strip("'\"")
        try:
            return _ann_typeref(ast.parse(text, mode="eval").body)
        except SyntaxError:
            return None
    if isinstance(ann, ast.Name):
        return _TypeRef(ann.id)
    if isinstance(ann, ast.Attribute):
        return _TypeRef(ann.attr)
    if isinstance(ann, ast.Subscript):
        head = ann.value
        head_name = head.attr if isinstance(head, ast.Attribute) else (
            head.id if isinstance(head, ast.Name) else None
        )
        args = ann.slice
        elems = list(args.elts) if isinstance(args, ast.Tuple) else [args]
        if head_name in ("Optional",) and elems:
            return _ann_typeref(elems[0])
        if head_name in ("Dict", "dict") and len(elems) == 2:
            inner = _ann_typeref(elems[1])
            return _TypeRef(inner.cls, "dict") if inner else None
        if head_name in ("List", "list", "Sequence", "Iterable", "Tuple", "tuple", "Set", "set", "Deque", "deque") and elems:
            inner = _ann_typeref(elems[0])
            return _TypeRef(inner.cls, "list") if inner else None
    return None


# ------------------------------------------------------------------- pass 1


def _scan_module(path: str, relpath: str, source: str) -> Optional[_ModuleInfo]:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None
    dotted = relpath[:-3].replace(os.sep, ".") if relpath.endswith(".py") else relpath
    mod = _ModuleInfo(
        path=path, relpath=relpath, dotted=dotted, tree=tree,
        lines=source.splitlines(),
    )
    for stmt in tree.body:
        if isinstance(stmt, (ast.Import,)):
            for alias in stmt.names:
                mod.module_aliases[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(stmt, ast.ImportFrom):
            for alias in stmt.names:
                mod.name_imports[alias.asname or alias.name] = alias.name
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and isinstance(
            stmt.targets[0], ast.Name
        ):
            name = stmt.targets[0].id
            kind = _is_threading_call(stmt.value)
            if kind is not None:
                mod.module_locks[name] = LockDecl(
                    name=f"{dotted}.{name}", cls=None, attr=name,
                    path=path, relpath=relpath, line=stmt.value.lineno, kind=kind,
                )
            elif isinstance(stmt.value, ast.Call) and isinstance(
                stmt.value.func, ast.Name
            ):
                mod.singletons[name] = _TypeRef(stmt.value.func.id)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions[stmt.name] = stmt
        elif isinstance(stmt, ast.ClassDef):
            info = _ClassInfo(name=stmt.name, module=mod, node=stmt)
            for base in stmt.bases:
                base_name = _dotted(base)
                if base_name:
                    info.bases.append(base_name.split(".")[-1])
            for item in stmt.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info.methods[item.name] = item
                elif isinstance(item, ast.Assign) and len(item.targets) == 1 and isinstance(
                    item.targets[0], ast.Name
                ):
                    kind = _is_threading_call(item.value)
                    if kind is not None:
                        attr = item.targets[0].id
                        info.lock_attrs[attr] = LockDecl(
                            name=f"{dotted}.{stmt.name}.{attr}", cls=stmt.name,
                            attr=attr, path=path, relpath=relpath,
                            line=item.value.lineno, kind=kind,
                        )
            _scan_self_assignments(info)
            mod.classes[stmt.name] = info
    return mod


def _scan_self_assignments(info: _ClassInfo) -> None:
    """Find ``self.x = threading.Lock()`` / ``self.x = ClassName(...)``
    and annotated ``self.x: T`` across every method."""
    dotted = info.module.dotted
    for method in info.methods.values():
        param_env = _param_env(method)
        for node in ast.walk(method):
            target = None
            value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                target, value = node.target, node.value
                ann = _ann_typeref(node.annotation)
                if (
                    ann is not None
                    and isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    info.attr_types.setdefault(target.attr, ann)
            if (
                target is None
                or not isinstance(target, ast.Attribute)
                or not isinstance(target.value, ast.Name)
                or target.value.id != "self"
            ):
                continue
            attr = target.attr
            kind = _is_threading_call(value)
            if kind is not None:
                # Condition(self._y) aliases the wrapped lock.
                call = value
                if (
                    kind == "condition"
                    and call.args
                    and isinstance(call.args[0], ast.Attribute)
                    and isinstance(call.args[0].value, ast.Name)
                    and call.args[0].value.id == "self"
                ):
                    info.lock_aliases[attr] = call.args[0].attr
                elif attr not in info.lock_attrs:
                    info.lock_attrs[attr] = LockDecl(
                        name=f"{dotted}.{info.name}.{attr}", cls=info.name,
                        attr=attr, path=info.module.path,
                        relpath=info.module.relpath, line=value.lineno, kind=kind,
                    )
            elif isinstance(value, ast.Call) and isinstance(value.func, ast.Name):
                info.attr_types.setdefault(attr, _TypeRef(value.func.id))
            elif isinstance(value, ast.Name) and value.id in param_env:
                # self._b = b  (parameter with a usable annotation)
                info.attr_types.setdefault(attr, param_env[value.id])


# ------------------------------------------------------------------ program


class Program:
    """Package-wide view plus the resolution toolkit."""

    def __init__(self, modules: List[_ModuleInfo]):
        self.modules = modules
        self.by_path: Dict[str, _ModuleInfo] = {m.path: m for m in modules}
        self.classes: Dict[str, List[_ClassInfo]] = {}
        self.functions: Dict[str, List[Tuple[_ModuleInfo, ast.FunctionDef]]] = {}
        for mod in modules:
            for cls in mod.classes.values():
                self.classes.setdefault(cls.name, []).append(cls)
            for name, fn in mod.functions.items():
                self.functions.setdefault(name, []).append((mod, fn))
        self.subclasses: Dict[str, List[_ClassInfo]] = {}
        for lst in self.classes.values():
            for cls in lst:
                for base in cls.bases:
                    self.subclasses.setdefault(base, []).append(cls)
        self._return_memo: Dict[Tuple[str, str], Optional[_TypeRef]] = {}

    # ------------------------------------------------------------- lookup
    def class_by_name(self, name: str) -> Optional[_ClassInfo]:
        lst = self.classes.get(name, [])
        return lst[0] if len(lst) == 1 else None

    def mro(self, cls: _ClassInfo) -> List[_ClassInfo]:
        out, seen, queue = [], set(), [cls]
        while queue:
            cur = queue.pop(0)
            if cur.name in seen:
                continue
            seen.add(cur.name)
            out.append(cur)
            for base in cur.bases:
                resolved = self.class_by_name(base)
                if resolved is not None:
                    queue.append(resolved)
        return out

    def lock_attr(self, cls: _ClassInfo, attr: str) -> Optional[LockDecl]:
        for cur in self.mro(cls):
            attr = cur.lock_aliases.get(attr, attr)
            if attr in cur.lock_attrs:
                return cur.lock_attrs[attr]
        return None

    def find_method(
        self, cls: _ClassInfo, name: str
    ) -> List[Tuple[_ClassInfo, ast.FunctionDef]]:
        """The method on ``cls``/its bases, else on its subclasses (the
        base-join case: a value typed ``Metric`` calling ``.inc`` hits
        ``Counter``/``Gauge``; all matches are returned and their effects
        unioned)."""
        for cur in self.mro(cls):
            if name in cur.methods:
                return [(cur, cur.methods[name])]
        out = []
        for sub in self.subclasses.get(cls.name, []):
            if name in sub.methods:
                out.append((sub, sub.methods[name]))
        return out

    def common_base(self, names: Sequence[str]) -> Optional[str]:
        sets = []
        for name in names:
            cls = self.class_by_name(name)
            if cls is None:
                return None
            sets.append([c.name for c in self.mro(cls)])
        first = sets[0]
        for candidate in first:
            if all(candidate in s for s in sets[1:]):
                return candidate
        return None

    def return_type(
        self, mod: _ModuleInfo, fn: ast.FunctionDef, owner: Optional[_ClassInfo]
    ) -> Optional[_TypeRef]:
        key = (mod.path, f"{owner.name + '.' if owner else ''}{fn.name}")
        if key in self._return_memo:
            return self._return_memo[key]
        self._return_memo[key] = None  # recursion guard
        ref = _ann_typeref(fn.returns)
        if ref is None:
            env = _param_env(fn)
            found: List[str] = []
            for node in ast.walk(fn):
                if isinstance(node, ast.Return) and node.value is not None:
                    r = self.resolve_type(node.value, mod, owner, env)
                    if r is not None and r.container is None:
                        found.append(r.cls)
            if found:
                joined = found[0] if len(set(found)) == 1 else self.common_base(found)
                if joined:
                    ref = _TypeRef(joined)
        if ref is not None and self.class_by_name(ref.cls) is None:
            ref = None
        self._return_memo[key] = ref
        return ref

    def resolve_type(
        self,
        expr: ast.AST,
        mod: _ModuleInfo,
        owner: Optional[_ClassInfo],
        env: Dict[str, _TypeRef],
    ) -> Optional[_TypeRef]:
        """Lite type of ``expr``: a program class, or None."""
        if isinstance(expr, ast.Name):
            if expr.id == "self" and owner is not None:
                return _TypeRef(owner.name)
            if expr.id in env:
                return env[expr.id]
            if expr.id in mod.singletons:
                ref = mod.singletons[expr.id]
                return ref if self.class_by_name(ref.cls) else None
            return None
        if isinstance(expr, ast.Attribute):
            base = self.resolve_type(expr.value, mod, owner, env)
            if base is not None and base.container is None:
                cls = self.class_by_name(base.cls)
                if cls is not None:
                    for cur in self.mro(cls):
                        if expr.attr in cur.attr_types:
                            ref = cur.attr_types[expr.attr]
                            return ref if self.class_by_name(ref.cls) else None
            return None
        if isinstance(expr, ast.Call):
            func = expr.func
            if isinstance(func, ast.Name):
                if self.class_by_name(func.id) is not None:
                    return _TypeRef(func.id)
                target = self._module_function(mod, func.id)
                if target is not None:
                    return self.return_type(target[0], target[1], None)
                return None
            if isinstance(func, ast.Attribute):
                for cls_info, method in self.resolve_method_call(
                    func, mod, owner, env
                ):
                    ref = self.return_type(cls_info.module, method, cls_info)
                    if ref is not None:
                        return ref
            return None
        if isinstance(expr, ast.BoolOp):  # `x = given or default()`
            for value in expr.values:
                ref = self.resolve_type(value, mod, owner, env)
                if ref is not None:
                    return ref
        return None

    def _module_function(
        self, mod: _ModuleInfo, name: str
    ) -> Optional[Tuple[_ModuleInfo, ast.FunctionDef]]:
        if name in mod.functions:
            return (mod, mod.functions[name])
        if name in mod.name_imports:
            imported = mod.name_imports[name]
            lst = self.functions.get(imported, [])
            if len(lst) == 1:
                return lst[0]
        return None

    def resolve_method_call(
        self,
        func: ast.Attribute,
        mod: _ModuleInfo,
        owner: Optional[_ClassInfo],
        env: Dict[str, _TypeRef],
    ) -> List[Tuple[_ClassInfo, ast.FunctionDef]]:
        """Callees of ``<expr>.m(...)`` — empty when unresolvable."""
        # module alias: _names.metric(...)
        if isinstance(func.value, ast.Name) and func.value.id in mod.module_aliases:
            pass  # fall through to module-attr resolution below
        value_type = self.resolve_type(func.value, mod, owner, env)
        if value_type is not None and value_type.container is None:
            cls = self.class_by_name(value_type.cls)
            if cls is not None:
                return self.find_method(cls, func.attr)
        # `<module alias>.fn(...)` — from ..obs import names as _names
        if isinstance(func.value, ast.Name):
            alias = func.value.id
            dotted_mod = None
            if alias in mod.module_aliases:
                dotted_mod = mod.module_aliases[alias]
            elif alias in mod.name_imports:
                dotted_mod = mod.name_imports[alias]
            if dotted_mod is not None:
                tail = dotted_mod.split(".")[-1]
                for other in self.modules:
                    if other.dotted == tail or other.dotted.endswith("." + tail):
                        if func.attr in other.functions:
                            fn = other.functions[func.attr]
                            return [(_module_owner(other), fn)]
        return []


def _module_owner(mod: _ModuleInfo) -> _ClassInfo:
    """A pseudo-class standing for a module, so module functions flow
    through the same (class, function) plumbing."""
    owner = getattr(mod, "_pseudo_owner", None)
    if owner is None:
        owner = _ClassInfo(name=f"<module {mod.dotted}>", module=mod, node=None)
        mod._pseudo_owner = owner  # type: ignore[attr-defined]
    return owner


def _nested_defs(fn: ast.FunctionDef) -> List[ast.FunctionDef]:
    """Directly-nested function definitions (closures), without entering
    them — each gets its own facts entry with a fresh held set."""
    out: List[ast.FunctionDef] = []
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(node)
            continue  # its own nested defs belong to IT
        if isinstance(node, ast.ClassDef):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


def _param_env(fn: ast.FunctionDef) -> Dict[str, _TypeRef]:
    env: Dict[str, _TypeRef] = {}
    args = list(fn.args.posonlyargs) + list(fn.args.args) + list(
        fn.args.kwonlyargs
    )
    for arg in args:
        ref = _ann_typeref(arg.annotation)
        if ref is not None:
            env[arg.arg] = ref
    return env


# ------------------------------------------------------------------- pass 2


@dataclass
class FunctionFacts:
    qualname: str
    mod: _ModuleInfo
    fn: ast.FunctionDef
    owner: Optional[_ClassInfo]
    acquisitions: List[Tuple[str, int]] = field(default_factory=list)
    edges: List[EdgeSite] = field(default_factory=list)
    calls: List[Tuple[FrozenSet[str], str, int]] = field(default_factory=list)
    blocking: List[BlockSite] = field(default_factory=list)
    accesses: List[Access] = field(default_factory=list)
    threads: List[ThreadSite] = field(default_factory=list)
    settles: List[SettleSite] = field(default_factory=list)
    entry_targets: List[str] = field(default_factory=list)  # spawned callees
    join_roots: Set[str] = field(default_factory=set)
    loop_aliases: Dict[str, str] = field(default_factory=dict)  # var -> iterated dotted


class _Walker:
    """Lexical walk of one function with a held-lock stack."""

    def __init__(
        self,
        program: Program,
        mod: _ModuleInfo,
        owner: Optional[_ClassInfo],
        fn: ast.FunctionDef,
        seed_held: Sequence[str] = (),
        qualname: Optional[str] = None,
    ):
        self.p = program
        self.mod = mod
        self.owner = owner
        self.fn = fn
        self.env = _param_env(fn)
        args = fn.args
        self.param_names = {
            a.arg
            for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        }
        if qualname is None:
            qual = f"{owner.name}.{fn.name}" if owner else fn.name
            qualname = f"{mod.dotted}.{qual}"
        self.facts = FunctionFacts(
            qualname=qualname, mod=mod, fn=fn, owner=owner
        )
        self.held: List[str] = list(seed_held)
        self.held_exprs: List[str] = []  # dotted source of held locks

    # ------------------------------------------------------------- helpers
    def resolve_lock(self, expr: ast.AST) -> Optional[LockDecl]:
        if isinstance(expr, ast.Name):
            return self.mod.module_locks.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self.p.resolve_type(expr.value, self.mod, self.owner, self.env)
            if base is not None and base.container is None:
                cls = self.p.class_by_name(base.cls)
                if cls is not None:
                    return self.p.lock_attr(cls, expr.attr)
        return None

    def _record_edges(self, acquired: str, line: int, via: str = "") -> None:
        for holder in self.held:
            if holder != acquired:
                self.facts.edges.append(
                    EdgeSite(
                        holder=holder, acquired=acquired, path=self.mod.path,
                        line=line, func=self.facts.qualname, via=via,
                    )
                )
            elif not via:
                # Lexical re-acquisition of a lock already held: a plain
                # Lock self-deadlocks here. Recorded as a self-edge; the
                # rule layer reports it for non-reentrant kinds only.
                self.facts.edges.append(
                    EdgeSite(
                        holder=holder, acquired=acquired, path=self.mod.path,
                        line=line, func=self.facts.qualname, via="self",
                    )
                )

    # ---------------------------------------------------------------- walk
    def walk(self) -> FunctionFacts:
        self._walk_body(self.fn.body)
        return self.facts

    def _walk_body(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self._walk_stmt(stmt)

    def _walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.With):
            self._walk_with(stmt)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested function: NOT walked inline — it runs whenever it is
            # invoked, not where it is defined, so it gets its own facts
            # entry (fresh held set) under `<parent>.<local name>`; see
            # _nested_defs / walk_all.
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._note_loop_alias(stmt)
            self._visit_expr(stmt.iter)
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
            return
        if isinstance(stmt, ast.While):
            self._visit_expr(stmt.test)
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
            return
        if isinstance(stmt, ast.If):
            self._visit_expr(stmt.test)
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(stmt.body)
            for handler in stmt.handlers:
                self._walk_body(handler.body)
            self._walk_body(stmt.orelse)
            self._walk_body(stmt.finalbody)
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self._walk_assign(stmt)
            return
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            self._visit_expr(stmt.value)
            return
        if isinstance(stmt, ast.Expr):
            self._visit_expr(stmt.value)
            return
        if isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                if isinstance(target, ast.Subscript):
                    self._note_access(target.value, write=True)
                    self._visit_expr(target.value)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._visit_expr(child)
            elif isinstance(child, ast.stmt):
                self._walk_stmt(child)

    def _note_loop_alias(self, stmt: ast.For) -> None:
        if isinstance(stmt.target, ast.Name):
            iter_expr = stmt.iter
            # for x in <expr>.values() / <expr>:
            src = None
            if (
                isinstance(iter_expr, ast.Call)
                and isinstance(iter_expr.func, ast.Attribute)
                and iter_expr.func.attr in ("values", "keys", "items")
            ):
                src = iter_expr.func.value
            else:
                src = iter_expr
            dotted = _dotted(src) if src is not None else None
            if dotted:
                self.facts.loop_aliases[stmt.target.id] = dotted
            ref = (
                self.p.resolve_type(src, self.mod, self.owner, self.env)
                if src is not None else None
            )
            if ref is not None and ref.container in ("dict", "list"):
                self.env.setdefault(stmt.target.id, _TypeRef(ref.cls))

    def _walk_with(self, stmt: ast.With) -> None:
        entered: List[Optional[str]] = []
        for item in stmt.items:
            self._visit_expr(item.context_expr, in_with=True)
            decl = self.resolve_lock(item.context_expr)
            if decl is not None and decl.kind in ("lock", "rlock", "condition"):
                self.facts.acquisitions.append((decl.name, stmt.lineno))
                if not (decl.kind == "rlock" and decl.name in self.held):
                    self._record_edges(decl.name, stmt.lineno)
                self.held.append(decl.name)
                self.held_exprs.append(_dotted(item.context_expr) or "")
                entered.append(decl.name)
            else:
                entered.append(None)
        self._walk_body(stmt.body)
        for name in reversed(entered):
            if name is not None:
                self.held.pop()
                self.held_exprs.pop()

    def _walk_assign(self, stmt: ast.stmt) -> None:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign):
            targets, value = [stmt.target], stmt.value
        elif isinstance(stmt, ast.AugAssign):
            # `self.x += 1` is one read-modify-WRITE of the target.
            self._visit_expr(stmt.value)
            if isinstance(stmt.target, ast.Attribute):
                self._note_access(stmt.target, write=True)
            elif isinstance(stmt.target, ast.Subscript):
                self._note_access(stmt.target.value, write=True)
                self._visit_expr(stmt.target.value)
            return
        if value is not None:
            self._visit_expr(value)
            # Local type propagation: x = ClassName(...) / x = f() / x = self.a
            if len(targets) == 1 and isinstance(targets[0], ast.Name) and isinstance(
                stmt, ast.Assign
            ):
                ref = self.p.resolve_type(value, self.mod, self.owner, self.env)
                if ref is not None:
                    self.env[targets[0].id] = ref
                self._note_thread_binding(value, _dotted(targets[0]))
        for target in targets:
            if isinstance(target, ast.Attribute):
                self._note_access(target, write=True)
            elif isinstance(target, ast.Subscript):
                self._note_access(target.value, write=True)
                self._visit_expr(target.value)
            elif isinstance(target, ast.Tuple):
                for elt in target.elts:
                    if isinstance(elt, ast.Attribute):
                        self._note_access(elt, write=True)
            if isinstance(target, ast.Attribute) and value is not None and isinstance(
                stmt, ast.Assign
            ):
                self._note_thread_binding(value, _dotted(target))

    def _note_thread_binding(self, value: ast.expr, bound_to: Optional[str]) -> None:
        """Attach the binding name to a ThreadSite created in ``value``."""
        for site in self.facts.threads:
            if site.bound_to is None and site.line >= value.lineno and site.line <= (
                getattr(value, "end_lineno", value.lineno)
            ):
                site.bound_to = bound_to

    # ----------------------------------------------------------- expression
    def _visit_expr(self, expr: ast.expr, in_with: bool = False) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
                self._note_access(node, write=False)
            elif isinstance(node, ast.Call):
                self._visit_call(node)

    def _note_access(self, node: ast.AST, write: bool) -> None:
        if not (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and self.owner is not None
        ):
            return
        attr = node.attr
        if attr.startswith("__"):
            return
        if self.p.lock_attr(self.owner, attr) is not None:
            return
        if attr in self.owner.lock_aliases:
            return
        self.facts.accesses.append(
            Access(
                cls=self.owner.qualname, attr=attr, path=self.mod.path,
                line=node.lineno, func=self.facts.qualname, write=write,
                held=frozenset(self.held),
            )
        )

    def _visit_call(self, call: ast.Call) -> None:
        func = call.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None
        )
        rendered = _dotted(func) or (name or "<call>")

        # Mutating container method on a self attr counts as a write.
        if (
            isinstance(func, ast.Attribute)
            and name in MUTATOR_METHODS
        ):
            self._note_access(func.value, write=True)

        # Thread creation.
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "threading"
            and func.attr == "Thread"
        ) or (isinstance(func, ast.Name) and func.id == "Thread"):
            self._note_thread_create(call)

        # Thread-entry registration: submit / add_done_callback.
        if name in ("submit", "add_done_callback") and call.args:
            target = self._resolve_callable_ref(call.args[0])
            if target:
                self.facts.entry_targets.append(target)

        # Future settles.
        if name in ("set_result", "set_exception") and isinstance(
            func, ast.Attribute
        ):
            self.facts.settles.append(
                SettleSite(
                    path=self.mod.path, line=call.lineno,
                    func=self.facts.qualname, method=name,
                )
            )

        # join bookkeeping (KV604).
        if name == "join" and isinstance(func, ast.Attribute):
            root = _dotted(func.value)
            if root:
                self.facts.join_roots.add(root)

        # Blocking calls under a lock (KV603).
        if self.held:
            self._note_blocking(call, func, name, rendered)

        # Explicit lock ops.
        if name in ("acquire", "release") and isinstance(func, ast.Attribute):
            decl = self.resolve_lock(func.value)
            if decl is not None:
                if name == "acquire" and decl.kind in ("lock", "rlock", "condition"):
                    self.facts.acquisitions.append((decl.name, call.lineno))
                    self._record_edges(decl.name, call.lineno)
                elif decl.kind == "semaphore":
                    # A semaphore's acquire AND release take its internal
                    # condition lock momentarily — the witness observes
                    # that as an ordering edge, so the static graph must
                    # carry it too (held → semaphore is always a leaf:
                    # user code never runs under the internal lock).
                    if self.held:
                        self._record_edges(decl.name, call.lineno)
                    if name == "acquire" and self.held:
                        blocking = not (
                            call.args
                            and isinstance(call.args[0], ast.Constant)
                            and call.args[0].value is False
                        )
                        if blocking:
                            self.facts.blocking.append(
                                BlockSite(
                                    path=self.mod.path, line=call.lineno,
                                    func=self.facts.qualname, call=rendered,
                                    held=frozenset(self.held), kind="semaphore",
                                )
                            )

        # Resolvable call → call-graph edge with the current held set.
        callees = self._callee_keys(func)
        for callee_key in callees:
            self.facts.calls.append(
                (frozenset(self.held), callee_key, call.lineno)
            )

        # Stored-callable invocation the model cannot see inside: the
        # holding lock goes open-world (edge → CALLBACK, transitive via
        # the acquisitions fixpoint so callers holding locks inherit it).
        if not callees and self._is_callback_call(func, name):
            self.facts.acquisitions.append((CALLBACK, call.lineno))
            if self.held:
                self._record_edges(CALLBACK, call.lineno)

    def _is_callback_call(self, func: ast.expr, name: Optional[str]) -> bool:
        if isinstance(func, ast.Attribute):
            if name in ("acquire", "release"):
                return False
            ref = self.p.resolve_type(func.value, self.mod, self.owner, self.env)
            if ref is None or ref.container is not None:
                return False
            cls = self.p.class_by_name(ref.cls)
            if cls is None:
                return False
            if self.p.lock_attr(cls, func.attr) is not None:
                return False
            # A known class whose attribute is NOT a method: a stored
            # callable (thunk, clock, on_expired hook).
            return not self.p.find_method(cls, func.attr)
        if isinstance(func, ast.Name):
            if func.id in _BUILTIN_NAMES:
                return False
            if self.p._module_function(self.mod, func.id) is not None:
                return False
            if self.p.class_by_name(func.id) is not None:
                return False
            # A bare parameter invoked as a function: a passed-in callback.
            return func.id in self.param_names
        return False

    def _resolve_callable_ref(self, expr: ast.expr) -> Optional[str]:
        """Qualname of a function/method reference (Thread target,
        executor submit, done callback)."""
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            if expr.value.id == "self" and self.owner is not None:
                for cur in self.p.mro(self.owner):
                    if expr.attr in cur.methods:
                        return f"{cur.module.dotted}.{cur.name}.{expr.attr}"
        if isinstance(expr, ast.Name):
            target = self.p._module_function(self.mod, expr.id)
            if target is not None:
                return f"{target[0].dotted}.{target[1].name}"
            # nested function defined in the enclosing function body
            for node in ast.walk(self.fn):
                if isinstance(node, ast.FunctionDef) and node.name == expr.id:
                    return f"{self.facts.qualname}.<local {expr.id}>"
        return None

    def _note_thread_create(self, call: ast.Call) -> None:
        daemon: Optional[bool] = None
        target: Optional[str] = None
        for kw in call.keywords:
            if kw.arg == "daemon":
                daemon = (
                    kw.value.value
                    if isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, bool)
                    else None
                )
            if kw.arg == "target":
                target = self._resolve_callable_ref(kw.value)
        self.facts.threads.append(
            ThreadSite(
                path=self.mod.path, line=call.lineno, func=self.facts.qualname,
                daemon=daemon, bound_to=None, target=target,
            )
        )
        if target:
            self.facts.entry_targets.append(target)

    _SUBPROCESS_FNS = ("run", "call", "check_call", "check_output")

    def _note_blocking(
        self, call: ast.Call, func: ast.expr, name: Optional[str], rendered: str
    ) -> None:
        kind: Optional[str] = None
        if rendered == "time.sleep" or (
            isinstance(func, ast.Name) and func.id == "sleep"
        ):
            kind = "sleep"
        elif name == "result" and isinstance(func, ast.Attribute):
            kind = "result"
        elif name == "communicate":
            kind = "subprocess"
        elif (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "subprocess"
            and name in self._SUBPROCESS_FNS
        ):
            kind = "subprocess"
        elif name in ("recv", "accept"):
            kind = "socket"
        elif name == "wait" and isinstance(func, ast.Attribute):
            receiver = _dotted(func.value)
            decl = self.resolve_lock(func.value)
            if decl is not None and decl.name in self.held:
                kind = None  # condition.wait on the held lock: the idiom
            elif receiver is not None and receiver in self.held_exprs:
                kind = None
            else:
                kind = "wait"
        elif name == "join" and isinstance(func, ast.Attribute):
            receiver = func.value
            if isinstance(receiver, ast.Constant):
                kind = None  # ''.join
            else:
                ref = self.p.resolve_type(receiver, self.mod, self.owner, self.env)
                dotted = (_dotted(receiver) or "").lower()
                if ref is not None and ref.cls in ("Thread", "Popen"):
                    kind = "join"
                elif any(h in dotted.split(".")[-1] for h in _JOIN_HINTS):
                    kind = "join"
        elif name == "get" and isinstance(func, ast.Attribute):
            dotted = (_dotted(func.value) or "").lower()
            if "queue" in dotted.split(".")[-1]:
                kind = "wait"
        if kind is not None:
            self.facts.blocking.append(
                BlockSite(
                    path=self.mod.path, line=call.lineno,
                    func=self.facts.qualname, call=rendered,
                    held=frozenset(self.held), kind=kind,
                )
            )

    def _callee_keys(self, func: ast.expr) -> List[str]:
        if isinstance(func, ast.Name):
            target = self.p._module_function(self.mod, func.id)
            if target is not None:
                return [f"{target[0].dotted}.{target[1].name}"]
            return []
        if isinstance(func, ast.Attribute):
            out = []
            for cls_info, method in self.p.resolve_method_call(
                func, self.mod, self.owner, self.env
            ):
                if cls_info.node is None:  # module pseudo-owner
                    out.append(f"{cls_info.module.dotted}.{method.name}")
                else:
                    out.append(
                        f"{cls_info.module.dotted}.{cls_info.name}.{method.name}"
                    )
            return out
        return []


# -------------------------------------------------------------------- model


@dataclass
class LockModel:
    """Everything the rule layer (and the witness) needs.

    ``edges`` keeps EVERY site producing a (holder, acquired) pair, not
    just the first — an ``allow-lock-order`` pragma must suppress a pair
    only when every contributing site carries it.
    """

    locks: Dict[str, LockDecl] = field(default_factory=dict)
    edges: Dict[Tuple[str, str], List[EdgeSite]] = field(default_factory=dict)
    accesses: List[Access] = field(default_factory=list)
    blocking: List[BlockSite] = field(default_factory=list)
    threads: List[ThreadSite] = field(default_factory=list)
    settles: List[SettleSite] = field(default_factory=list)
    functions: Dict[str, FunctionFacts] = field(default_factory=dict)
    entry_functions: Set[str] = field(default_factory=set)
    thread_reachable: Set[str] = field(default_factory=set)
    lines: Dict[str, List[str]] = field(default_factory=dict)  # path -> lines

    def alloc_sites(self) -> Dict[Tuple[str, int], str]:
        """(package-relative path, line) → lock node name — the witness's
        naming table."""
        return {(d.relpath, d.line): d.name for d in self.locks.values()}

    def edge_pairs(self) -> Set[Tuple[str, str]]:
        return set(self.edges)

    def first_site(self, pair: Tuple[str, str]) -> Optional[EdgeSite]:
        sites = self.edges.get(pair)
        return sites[0] if sites else None

    def find_cycles(self) -> List[List[str]]:
        """Elementary cycles in the lock-order graph, one per SCC (plus
        self-loops on non-reentrant locks). Paths are closed:
        ``[a, b, a]``."""
        graph: Dict[str, List[str]] = {}
        for a, b in self.edges:
            graph.setdefault(a, []).append(b)
            graph.setdefault(b, [])
        cycles: List[List[str]] = []
        for a, b in sorted(self.edges):
            if a == b:
                decl = self.locks.get(a)
                if decl is None or decl.kind == "lock":
                    cycles.append([a, a])
        for scc in _sccs(graph):
            if len(scc) < 2:
                continue
            cycles.append(_cycle_path(graph, scc))
        return cycles

    def to_json(self) -> Dict[str, Any]:
        return {
            "locks": {
                name: {
                    "path": d.relpath, "line": d.line, "kind": d.kind,
                    "class": d.cls, "attr": d.attr,
                }
                for name, d in sorted(self.locks.items())
            },
            "edges": [
                {
                    "holder": a, "acquired": b,
                    "path": sites[0].path, "line": sites[0].line,
                    "func": sites[0].func, "via": sites[0].via,
                    "sites": len(sites),
                }
                for (a, b), sites in sorted(self.edges.items())
            ],
        }


def _sccs(graph: Dict[str, List[str]]) -> List[List[str]]:
    """Tarjan, iterative."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]
    for root in sorted(graph):
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, i = work[-1]
            if i == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            advanced = False
            neighbors = graph.get(node, [])
            while i < len(neighbors):
                succ = neighbors[i]
                i += 1
                if succ not in index:
                    work[-1] = (node, i)
                    work.append((succ, 0))
                    advanced = True
                    break
                if succ in on_stack:
                    low[node] = min(low[node], index[succ])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    member = stack.pop()
                    on_stack.discard(member)
                    scc.append(member)
                    if member == node:
                        break
                out.append(scc)
    return out


def _cycle_path(graph: Dict[str, List[str]], scc: List[str]) -> List[str]:
    """One concrete closed path inside a multi-node SCC."""
    members = set(scc)
    start = sorted(scc)[0]
    # BFS back to start restricted to the SCC.
    from collections import deque

    queue = deque([[start]])
    seen = {start}
    while queue:
        path = queue.popleft()
        for succ in graph.get(path[-1], []):
            if succ == start and len(path) > 1:
                return path + [start]
            if succ in members and succ not in seen:
                seen.add(succ)
                queue.append(path + [succ])
    # Self-loop inside the SCC as a fallback.
    return [start, start]


# ------------------------------------------------------------------ model assembly


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


def _relpath(path: str, roots: Sequence[str]) -> str:
    apath = os.path.abspath(path)
    for root in roots:
        aroot = os.path.abspath(root)
        if apath.startswith(aroot + os.sep):
            return os.path.relpath(apath, aroot)
    return os.path.basename(path)


#: Modules excluded from the model: the witness instruments locks (it IS
#: the runtime half of this analysis), so modeling its wrapper acquire/
#: release plumbing would only produce noise about itself.
EXCLUDED_SUFFIXES = (os.path.join("lint", "lockwitness.py"),)


def build_model(paths: Sequence[str]) -> LockModel:
    """Parse ``paths`` (files or trees) and extract the full lock model."""
    modules: List[_ModuleInfo] = []
    roots = [p for p in paths if os.path.isdir(p)]
    for fpath in _iter_py_files(paths):
        if fpath.endswith(EXCLUDED_SUFFIXES):
            continue
        try:
            with open(fpath, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            continue
        mod = _scan_module(fpath, _relpath(fpath, roots), source)
        if mod is not None:
            modules.append(mod)
    return _assemble(modules)


def build_model_from_sources(sources: Dict[str, str]) -> LockModel:
    """Build the model from in-memory ``{relpath: source}`` (rule unit
    tests; unparseable modules are skipped exactly like on disk)."""
    modules = []
    for relpath, source in sources.items():
        mod = _scan_module(relpath, relpath, source)
        if mod is not None:
            modules.append(mod)
    return _assemble(modules)


def _assemble(modules: List[_ModuleInfo]) -> LockModel:
    program = Program(modules)
    model = LockModel()
    for mod in modules:
        model.lines[mod.path] = mod.lines
        for decl in mod.module_locks.values():
            model.locks[decl.name] = decl
        for cls in mod.classes.values():
            for decl in cls.lock_attrs.values():
                model.locks[decl.name] = decl

    # Walk every function; then re-walk *_locked methods with the
    # intersection of their callers' held sets (two passes propagate
    # locked→locked chains).
    def walk_all(seeds: Dict[str, FrozenSet[str]]) -> Dict[str, FunctionFacts]:
        out: Dict[str, FunctionFacts] = {}

        def walk_one(key, mod, owner, fn):
            out[key] = _Walker(
                program, mod, owner, fn, seeds.get(key, ()), qualname=key
            ).walk()
            # Closures run when invoked, not where defined: each nested
            # def gets its own facts entry (fresh held set) so a
            # Thread(target=<closure>) body is analyzed like any other
            # thread entry instead of being invisible.
            for nested in _nested_defs(fn):
                walk_one(f"{key}.<local {nested.name}>", mod, owner, nested)

        for mod in modules:
            for fname, fn in mod.functions.items():
                walk_one(f"{mod.dotted}.{fname}", mod, None, fn)
            for cls in mod.classes.values():
                for mname, method in cls.methods.items():
                    walk_one(f"{mod.dotted}.{cls.name}.{mname}", mod, cls, method)
        return out

    facts = walk_all({})
    for _ in range(2):
        seeds: Dict[str, FrozenSet[str]] = {}
        call_held: Dict[str, List[FrozenSet[str]]] = {}
        for f in facts.values():
            for held, callee, _line in f.calls:
                call_held.setdefault(callee, []).append(held)
        for key, f in facts.items():
            if not f.fn.name.endswith("_locked"):
                continue
            held_sets = call_held.get(key)
            if not held_sets:
                continue
            seeded = frozenset.intersection(*held_sets)
            if seeded:
                seeds[key] = seeded
        if not seeds:
            break
        facts = walk_all(seeds)

    model.functions = facts

    # Fixpoint: transitive may-acquire sets per function.
    may_acquire: Dict[str, Set[str]] = {
        key: {name for name, _ in f.acquisitions} for key, f in facts.items()
    }
    changed = True
    while changed:
        changed = False
        for key, f in facts.items():
            for _held, callee, _line in f.calls:
                callee_set = may_acquire.get(callee)
                if callee_set and not callee_set <= may_acquire[key]:
                    may_acquire[key] |= callee_set
                    changed = True

    # Edges: lexical (already in facts) + call-site held × callee acquires.
    # Every distinct site is kept: pragma suppression must be per-site.
    def add_edge(pair: Tuple[str, str], site: EdgeSite) -> None:
        sites = model.edges.setdefault(pair, [])
        if not any(
            s.path == site.path and s.line == site.line for s in sites
        ):
            sites.append(site)

    for f in facts.values():
        for site in f.edges:
            add_edge((site.holder, site.acquired), site)
        for held, callee, line in f.calls:
            if not held:
                continue
            for acquired in sorted(may_acquire.get(callee, ())):
                for holder in held:
                    if holder == acquired:
                        decl = model.locks.get(holder)
                        if decl is not None and decl.kind != "lock":
                            continue
                    add_edge(
                        (holder, acquired),
                        EdgeSite(
                            holder=holder, acquired=acquired, path=f.mod.path,
                            line=line, func=f.qualname, via=callee,
                        ),
                    )

    # Thread-entry reachability over the call graph.
    entries: Set[str] = set()
    for f in facts.values():
        entries.update(t for t in f.entry_targets if t)
        for site in f.threads:
            if site.target:
                entries.add(site.target)
    # HTTP handler entry points: do_* methods on BaseHTTPRequestHandler
    # subclasses (each request runs on its own server thread).
    for mod in modules:
        for cls in mod.classes.values():
            if any("HTTPRequestHandler" in b or b == "Handler" for b in cls.bases):
                for mname in cls.methods:
                    if mname.startswith("do_"):
                        entries.add(f"{mod.dotted}.{cls.name}.{mname}")
    model.entry_functions = set(entries)
    reachable: Set[str] = set()
    queue = [e for e in entries if e in facts]
    while queue:
        cur = queue.pop()
        if cur in reachable:
            continue
        reachable.add(cur)
        f = facts.get(cur)
        if f is None:
            continue
        for _held, callee, _line in f.calls:
            if callee not in reachable:
                queue.append(callee)
    model.thread_reachable = reachable

    # Flatten per-function facts, stamping reachability onto accesses.
    for key, f in facts.items():
        in_thread = key in reachable
        for access in f.accesses:
            access.thread_reachable = in_thread
            model.accesses.append(access)
        model.blocking.extend(f.blocking)
        model.threads.extend(f.threads)
        model.settles.extend(f.settles)

    return model
