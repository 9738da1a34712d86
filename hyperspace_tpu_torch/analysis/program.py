"""Whole-program index: modules, symbols, and per-function summaries.

The per-file linter (analysis/lint.py) sees one AST at a time; the rules
that actually guard the concurrent serving plane need to see the whole
package at once — a lock acquired in ``serve/scheduler.py`` while a call
chain reaches into ``hyperspace.py`` holding the session RLock is
invisible to any single-file walk. This module builds the shared
substrate every cross-module rule runs on:

- :class:`ModuleInfo` — one parsed module: dotted name, AST, imports
  (alias → dotted target), module-level string constants, module-level
  lock definitions, and variable → class type bindings.
- :class:`FunctionInfo` — one function/method summary extracted in a
  SINGLE visitor pass: calls made (with the stack of locks held AND the
  try/except guards enclosing each call site), locks acquired via
  ``with`` (with the locks already held), raise sites with their guard
  stacks (the raw material of the exception-flow layer,
  analysis/raises.py), config get/set keys, fault-point references, and
  the raw AST node for rules that need a closer look (resource safety,
  HSL011).
- :class:`Program` — the package-wide index: symbol tables, lock
  definitions (module-level and ``self.X = threading.Lock()`` class
  attributes), attribute/variable type bindings, and the name-resolution
  machinery the call graph builds on (analysis/callgraph.py).

Everything here is stdlib-``ast`` only and never imports the analyzed
code — the CI check job runs without the package's dependencies
installed, exactly like the per-file linter always has.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

# Lines as ast.get_source_segment splits them: on \r\n, \r or \n only,
# line ends kept.
_SEG_LINE_RE = re.compile(r"[^\r\n]*(?:\r\n|\r|\n)|[^\r\n]+$")

_LOCK_CTORS = {
    "Lock": "Lock",
    "RLock": "RLock",
    "Condition": "Condition",
}


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a Name/Attribute chain ('' otherwise)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _lock_kind(value: ast.expr) -> str | None:
    """'Lock' / 'RLock' / 'Condition' when `value` is a threading lock
    constructor call (``threading.Lock()`` or a bare imported ``Lock()``),
    else None."""
    if not isinstance(value, ast.Call):
        return None
    name = _dotted(value.func).split(".")[-1]
    return _LOCK_CTORS.get(name)


@dataclasses.dataclass(frozen=True)
class LockRef:
    """An unresolved lock reference as spelled at a ``with``/call site.

    kind: 'name' (bare module-level name), 'self' (``self.<attr>``), or
    'attr' (``<expr>.<attr>`` where the base is not self). Resolution to
    a program-wide lock id happens in :meth:`Program.resolve_lock`.
    """

    kind: str
    name: str  # the bare name or the attribute name
    line: int


@dataclasses.dataclass(frozen=True)
class Guard:
    """The handlers of ONE enclosing ``try`` statement, as seen from a
    site inside its body: for each ``except`` clause, the raw caught
    type texts (``()`` = bare ``except:``) and whether the handler
    re-raises what it caught (a bare ``raise`` / ``raise <bound name>``
    anywhere in its body). The raise-propagation layer
    (analysis/raises.py) subtracts escaping exception types against
    these, narrowed by the exception hierarchy."""

    handlers: tuple[tuple[tuple[str, ...], bool], ...]


@dataclasses.dataclass(frozen=True)
class RaiseSite:
    """One ``raise`` statement: the raw dotted text of the raised
    expression (``None`` for a bare re-raise), the stack of enclosing
    try guards (outermost first), and — when the site re-raises the
    exception an enclosing ``except`` clause bound — that clause's
    caught type texts."""

    raw: str | None
    line: int
    guards: tuple[Guard, ...]
    handler_types: tuple[str, ...] | None = None


@dataclasses.dataclass(frozen=True)
class CallSite:
    """One call expression: the raw dotted callee text plus the stack of
    lock references held (lexically, via enclosing ``with``) at the
    call, and the stack of try/except guards enclosing it (the raise
    analysis subtracts callee escapes against those)."""

    raw: str
    line: int
    held: tuple[LockRef, ...]
    guards: tuple[Guard, ...] = ()


@dataclasses.dataclass(frozen=True)
class Acquire:
    """One ``with <lock>`` entry and the locks already held around it."""

    ref: LockRef
    line: int
    held: tuple[LockRef, ...]


@dataclasses.dataclass(frozen=True)
class AttrAccess:
    """One shared-state access: a ``self.<attr>`` load/store or a
    module-global load/store, with the stack of lock references lexically
    held at the access site (the raw material of the effect summaries in
    analysis/effects.py and the HSL013 lockset race rule).

    kind: 'self' (instance attribute through ``self``) or 'global'
    (module-level name in this module's shared-global candidate set).
    write covers rebinds, augmented assigns, subscript stores, ``del``,
    and in-place mutator calls (``.append``/``.update``/...); ``keyed``
    marks subscript/keyed-mutator forms (``S[k] = v``, ``S.pop(k)``) —
    the memo-fill shape the atomicity rule treats differently from a
    whole-value rebind."""

    kind: str
    attr: str
    line: int
    write: bool
    held: tuple[LockRef, ...]
    keyed: bool = False
    in_init: bool = False


@dataclasses.dataclass
class ConfigAccess:
    """One conf ``get``/``set`` whose key resolves (constant or named
    constant) to a ``hyperspace.*`` string. `key` may still be None
    right after the per-module pass when the site spells the key through
    an imported constant (``conf.set(JOIN_VENUE, ...)``); Program._index
    resolves those against the merged constant table of every indexed
    module."""

    key: str | None
    line: int
    write: bool
    pending_name: str | None = None


@dataclasses.dataclass
class FunctionInfo:
    qname: str
    module: str
    cls: str | None
    name: str
    line: int
    node: ast.AST
    calls: list[CallSite] = dataclasses.field(default_factory=list)
    acquires: list[Acquire] = dataclasses.field(default_factory=list)
    config_accesses: list[ConfigAccess] = dataclasses.field(default_factory=list)
    fault_refs: list[tuple[str, int, str]] = dataclasses.field(default_factory=list)
    attr_accesses: list[AttrAccess] = dataclasses.field(default_factory=list)
    raises: list[RaiseSite] = dataclasses.field(default_factory=list)
    returns_type: str | None = None  # raw annotation text, when a simple name
    # Local name -> the raw expression that first bound it, when that is
    # a constructor call ("Executor") or a self-rooted attribute chain
    # ("self.session.manager") — the call graph types receiver locals
    # through these (`executor = Executor(...); executor.execute(...)`).
    local_types: dict[str, str] = dataclasses.field(default_factory=dict)
    # Function-LEVEL imports (alias -> dotted target): the deferred-import
    # idiom the heavy modules use; resolve_symbol consults these before
    # the module-level map so `_prefetch.prefetch_plan(...)` resolves.
    imports: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ClassInfo:
    qname: str
    module: str
    name: str
    line: int
    bases: list[str]
    is_protocol: bool = False  # typing.Protocol seam (structural dispatch)
    methods: dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    attr_locks: dict[str, str] = dataclasses.field(default_factory=dict)  # attr -> kind
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)  # attr -> raw ctor ref
    attr_names: set[str] = dataclasses.field(default_factory=set)  # every self.X assigned


@dataclasses.dataclass
class ModuleInfo:
    name: str
    path: str
    tree: ast.Module
    source: str
    imports: dict[str, str] = dataclasses.field(default_factory=dict)  # alias -> dotted target
    functions: dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    classes: dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    module_locks: dict[str, str] = dataclasses.field(default_factory=dict)  # name -> kind
    var_types: dict[str, str] = dataclasses.field(default_factory=dict)  # name -> raw ctor ref
    const_strings: dict[str, str] = dataclasses.field(default_factory=dict)
    # Module-level names whose loads/stores count as shared-state
    # accesses: mutable containers assigned at module level plus any
    # name some function rebinds through `global` (analysis/effects.py).
    shared_globals: set[str] = dataclasses.field(default_factory=set)

    @property
    def lines(self) -> list[str]:
        # Memoized: the durability sweep reads node segments against
        # this table for every call expression in the program, and
        # re-splitting the source each access made that quadratic.
        got = self.__dict__.get("_lines")
        if got is None:
            got = self.__dict__["_lines"] = self.source.splitlines()
        return got

    def segment(self, node: ast.AST) -> str | None:
        """``ast.get_source_segment(self.source, node)`` against a line
        table split once: the stdlib re-splits the whole source on every
        call, which made the shared-file sweep quadratic in a long
        module."""
        lines = self.__dict__.get("_seg_lines")
        if lines is None:
            lines = self.__dict__["_seg_lines"] = _SEG_LINE_RE.findall(self.source)
        try:
            if node.end_lineno is None or node.end_col_offset is None:
                return None
            l0, l1 = node.lineno - 1, node.end_lineno - 1
            c0, c1 = node.col_offset, node.end_col_offset
        except AttributeError:
            return None
        if l1 >= len(lines):
            return None
        if l0 == l1:
            return lines[l0].encode()[c0:c1].decode()
        first = lines[l0].encode()[c0:].decode()
        last = lines[l1].encode()[:c1].decode()
        return "".join([first, *lines[l0 + 1:l1], last])


class _FunctionPass(ast.NodeVisitor):
    """The single per-function visitor pass: collects calls, lock
    acquisitions (with the held stack), config accesses, and fault-point
    references in one walk."""

    _INIT_NAMES = ("__init__", "__new__", "__post_init__")

    def __init__(self, info: FunctionInfo, module: ModuleInfo):
        self.info = info
        self.module = module
        self._held: list[LockRef] = []
        self._in_init = info.cls is not None and info.name in self._INIT_NAMES
        self._global_decls: set[str] = set()
        # Exception-flow context (analysis/raises.py): the stack of
        # enclosing try guards, the stack of enclosing except-handler
        # (types, bound name) pairs, and whether we are inside a nested
        # def/lambda (whose raises execute later, in some other frame —
        # they never unwind THIS function's callers, so they are not
        # recorded as this function's raise sites).
        self._guards: list[Guard] = []
        self._handler_ctx: list[tuple[tuple[str, ...], str | None]] = []
        self._nested_fn_depth = 0
        # Attribute/Name nodes already accounted for by an enclosing
        # write form (mutator call, subscript store) — their Load visit
        # must not double-record a read.
        self._claimed: set[int] = set()
        # Lambdas that run under the current lock stack despite being
        # nested functions: predicates passed to Condition.wait_for are
        # evaluated while the condition's lock is held.
        self._inherit_held: set[int] = set()

    def _lock_ref(self, ctx: ast.expr, line: int) -> LockRef | None:
        """A LockRef when the with-item context expression *could* be a
        lock: a bare name or a terminal attribute access. Whether it IS
        one is decided at resolution time against the program-wide lock
        definitions — so ``with open(...)`` or ``with span(...)`` never
        produce a ref (calls are not lock expressions)."""
        if isinstance(ctx, ast.Name):
            return LockRef("name", ctx.id, line)
        if isinstance(ctx, ast.Attribute):
            base = ctx.value
            if isinstance(base, ast.Name) and base.id == "self":
                return LockRef("self", ctx.attr, line)
            return LockRef("attr", ctx.attr, line)
        return None

    def visit_With(self, node: ast.With) -> None:
        refs: list[LockRef] = []
        for item in node.items:
            ref = self._lock_ref(item.context_expr, node.lineno)
            if ref is not None:
                self.info.acquires.append(Acquire(ref, node.lineno, tuple(self._held)))
                refs.append(ref)
                self._held.append(ref)
            # Context expressions that are calls (span(...), open(...))
            # still contain visitable sub-calls.
            if isinstance(item.context_expr, ast.Call):
                self.visit(item.context_expr)
                # `with Ctor(...) as x:` types the bound local exactly
                # like `x = Ctor(...)` — the context-manager classes here
                # (TaskPool, the servers) return self from __enter__, and
                # this is how every pooled-build call site is spelled.
                if isinstance(item.optional_vars, ast.Name):
                    ctor = _dotted(item.context_expr.func)
                    if ctor and ctor != "super":
                        self.info.local_types.setdefault(
                            item.optional_vars.id, ctor + "()"
                        )
        for stmt in node.body:
            self.visit(stmt)
        for _ in refs:
            self._held.pop()

    visit_AsyncWith = visit_With

    def _visit_nested_fn(self, node) -> None:
        # Nested defs/lambdas run later, not at the enclosing call site —
        # but the serving plane's closures (QueryServer._body) DO run
        # with no lock held, so walk them with an empty held stack.
        # Exception: wait_for predicates (marked in _inherit_held) are
        # evaluated by Condition.wait_for WITH the lock held.
        # The try/except context resets the same way: an enclosing
        # handler does not guard the closure's later execution, and the
        # closure's own raises unwind some other frame (not recorded).
        saved = self._held
        saved_guards, saved_ctx = self._guards, self._handler_ctx
        if id(node) not in self._inherit_held:
            self._held = []
        self._guards, self._handler_ctx = [], []
        self._nested_fn_depth += 1
        try:
            for stmt in getattr(node, "body", []) if not isinstance(node, ast.Lambda) else [node.body]:
                self.visit(stmt)
        finally:
            self._nested_fn_depth -= 1
            self._held = saved
            self._guards, self._handler_ctx = saved_guards, saved_ctx

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.info.imports[alias.asname or alias.name.split(".")[0]] = alias.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module:
            if node.level == 0:
                base = node.module
            else:
                base = ".".join(self.module.name.split(".")[: -node.level] + [node.module])
            for alias in node.names:
                self.info.imports[alias.asname or alias.name] = f"{base}.{alias.name}"

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_nested_fn(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_nested_fn(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_nested_fn(node)

    # -- exception flow ----------------------------------------------------
    @staticmethod
    def _handler_types(handler: ast.ExceptHandler) -> tuple[str, ...]:
        """Raw dotted texts of the types one except clause catches;
        ``()`` = bare ``except:`` (catches everything)."""
        t = handler.type
        if t is None:
            return ()
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        return tuple(filter(None, (_dotted(e) for e in elts)))

    @staticmethod
    def _handler_reraises(handler: ast.ExceptHandler) -> bool:
        """True when the handler re-raises what it caught: a bare
        ``raise`` or ``raise <bound name>`` anywhere in its body (a
        conditional re-raise still means the caught types MAY escape)."""
        for sub in ast.walk(handler):
            if not isinstance(sub, ast.Raise):
                continue
            if sub.exc is None:
                return True
            if (
                handler.name is not None
                and isinstance(sub.exc, ast.Name)
                and sub.exc.id == handler.name
            ):
                return True
        return False

    def visit_Try(self, node: ast.Try) -> None:
        guard = Guard(tuple(
            (self._handler_types(h), self._handler_reraises(h))
            for h in node.handlers
        ))
        if node.handlers:
            self._guards.append(guard)
        for stmt in node.body:
            self.visit(stmt)
        if node.handlers:
            self._guards.pop()
        # Handler bodies are guarded only by OUTER tries; `else` and
        # `finally` bodies are never covered by this try's handlers.
        for h in node.handlers:
            self._handler_ctx.append((self._handler_types(h), h.name))
            for stmt in h.body:
                self.visit(stmt)
            self._handler_ctx.pop()
        for stmt in (*node.orelse, *node.finalbody):
            self.visit(stmt)

    visit_TryStar = visit_Try

    def visit_Raise(self, node: ast.Raise) -> None:
        if self._nested_fn_depth == 0:
            guards = tuple(self._guards)
            if node.exc is None:
                # Bare re-raise: legal only inside a handler; record the
                # caught types so the raise analysis knows what escapes.
                if self._handler_ctx:
                    types, _ = self._handler_ctx[-1]
                    self.info.raises.append(
                        RaiseSite(None, node.lineno, guards, handler_types=types)
                    )
            else:
                exc = node.exc
                raw = _dotted(exc.func) if isinstance(exc, ast.Call) else _dotted(exc)
                handler_types = None
                if isinstance(exc, ast.Name):
                    # `raise e` of a bound handler name is a re-raise of
                    # the caught types, not a raise of a type named `e`.
                    for types, bound in reversed(self._handler_ctx):
                        if bound == exc.id:
                            handler_types = types
                            break
                self.info.raises.append(RaiseSite(
                    raw or None, node.lineno, guards, handler_types=handler_types,
                ))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        raw = _dotted(node.func)
        if not raw and isinstance(node.func, ast.Attribute):
            base = node.func.value
            # `super().m(...)`: the base is a Call, so _dotted sees
            # nothing — record it as `super.m` and let the call graph
            # resolve it through the base classes.
            if (
                isinstance(base, ast.Call)
                and isinstance(base.func, ast.Name)
                and base.func.id == "super"
                and not base.args
            ):
                raw = f"super.{node.func.attr}"
            # `Ctor(...).m(...)` — the immediate-invoke shape every
            # manager method uses (`CreateAction(...).run()`): record as
            # `Ctor().m` so the call graph can type the receiver.
            elif isinstance(base, ast.Call):
                ctor = _dotted(base.func)
                if ctor:
                    raw = f"{ctor}().{node.func.attr}"
        if raw:
            self.info.calls.append(
                CallSite(raw, node.lineno, tuple(self._held), tuple(self._guards))
            )
            # retry_call(fn, ...) invokes its first argument synchronously
            # — record the function REFERENCE as a call at this site, so
            # retried IO primitives stay visible to the exception-flow
            # and lock analyses (utils/retry.py is the one sanctioned
            # higher-order invoker on the metadata plane).
            if raw.split(".")[-1] == "retry_call" and node.args:
                inner = _dotted(node.args[0])
                if inner:
                    self.info.calls.append(CallSite(
                        inner, node.lineno, tuple(self._held), tuple(self._guards)
                    ))
        self._check_config_access(node, raw)
        self._check_fault_ref(node, raw)
        # In-place mutator call on shared state: self.X.append(...) /
        # GLOBAL.update(...) is a WRITE to X / GLOBAL.
        if isinstance(node.func, ast.Attribute) and node.func.attr in _MUTATOR_METHODS:
            keyed = node.func.attr in _KEYED_MUTATORS and bool(node.args)
            self._record_target(node.func.value, node.lineno, write=True, keyed=keyed)
        # wait_for predicates run under the condition's lock — mark the
        # lambda so _visit_nested_fn keeps the held stack for it.
        if isinstance(node.func, ast.Attribute) and node.func.attr == "wait_for":
            for arg in node.args:
                if isinstance(arg, (ast.Lambda, ast.Name)):
                    self._inherit_held.add(id(arg))
        self.generic_visit(node)

    # -- shared-state accesses ---------------------------------------------
    def visit_Global(self, node: ast.Global) -> None:
        self._global_decls.update(node.names)

    def _record_target(self, base: ast.expr, line: int, write: bool, keyed: bool) -> None:
        """Record a write through an access base: ``self.X`` or a shared
        module-global name (claiming the base node so its Load visit
        doesn't double-record a read)."""
        if (
            isinstance(base, ast.Attribute)
            and isinstance(base.value, ast.Name)
            and base.value.id == "self"
        ):
            self._claimed.add(id(base))
            self.info.attr_accesses.append(AttrAccess(
                "self", base.attr, line, write, tuple(self._held),
                keyed=keyed, in_init=self._in_init,
            ))
        elif isinstance(base, ast.Name) and base.id in self.module.shared_globals:
            self._claimed.add(id(base))
            self.info.attr_accesses.append(AttrAccess(
                "global", base.id, line, write, tuple(self._held),
                keyed=keyed, in_init=self._in_init,
            ))

    def _record_store(self, tgt: ast.expr, line: int) -> None:
        if isinstance(tgt, ast.Attribute):
            self._record_target(tgt, line, write=True, keyed=False)
        elif isinstance(tgt, ast.Subscript):
            self._record_target(tgt.value, line, write=True, keyed=True)
        elif isinstance(tgt, ast.Name):
            if tgt.id in self._global_decls and tgt.id in self.module.shared_globals:
                self.info.attr_accesses.append(AttrAccess(
                    "global", tgt.id, line, write=True, held=tuple(self._held),
                    in_init=self._in_init,
                ))
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._record_store(el, line)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._record_store(tgt, node.lineno)
        # Local receiver types: `x = Ctor(...)` / `x = self.a.b` (first
        # binding wins; a rebound local stays conservative).
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if isinstance(node.value, ast.Call):
                ctor = _dotted(node.value.func)
                if ctor and ctor != "super":
                    self.info.local_types.setdefault(name, ctor + "()")
            elif isinstance(node.value, ast.Attribute):
                path = _dotted(node.value)
                if path.startswith("self."):
                    self.info.local_types.setdefault(name, path)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_store(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            self._record_store(tgt, node.lineno)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (
            isinstance(node.ctx, ast.Load)
            and id(node) not in self._claimed
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            self.info.attr_accesses.append(AttrAccess(
                "self", node.attr, node.lineno, write=False,
                held=tuple(self._held), in_init=self._in_init,
            ))
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if (
            isinstance(node.ctx, ast.Load)
            and id(node) not in self._claimed
            and node.id in self.module.shared_globals
        ):
            self.info.attr_accesses.append(AttrAccess(
                "global", node.id, node.lineno, write=False,
                held=tuple(self._held), in_init=self._in_init,
            ))

    # -- config get/set ----------------------------------------------------
    def _check_config_access(self, node: ast.Call, raw: str) -> None:
        attr = raw.split(".")[-1]
        if attr not in ("get", "set") or not node.args:
            return
        expr = node.args[0]
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            if expr.value.startswith("hyperspace."):
                self.info.config_accesses.append(
                    ConfigAccess(expr.value, node.lineno, write=(attr == "set"))
                )
            return
        name = None
        if isinstance(expr, ast.Name):
            name = expr.id
        elif isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            name = expr.attr
        if name is None:
            return
        val = self.module.const_strings.get(name)
        if val is not None:
            if val.startswith("hyperspace."):
                self.info.config_accesses.append(
                    ConfigAccess(val, node.lineno, write=(attr == "set"))
                )
            return
        # Imported constant: leave the name pending; Program._index
        # resolves it against every indexed module's constants.
        self.info.config_accesses.append(
            ConfigAccess(None, node.lineno, write=(attr == "set"), pending_name=name)
        )

    # -- fault points ------------------------------------------------------
    def _check_fault_ref(self, node: ast.Call, raw: str) -> None:
        tail = raw.split(".")[-1]
        if tail == "fault_point":
            kind = "point"
        elif tail in ("inject", "injected") and (
            raw.split(".")[0] in ("faults",) or tail == raw
        ):
            kind = "inject"
        else:
            return
        arg: ast.expr | None = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg == "point":
                arg = kw.value
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            self.info.fault_refs.append((arg.value, node.lineno, kind))


# Container constructors whose module-level instances count as shared
# state, and the in-place method names that mutate shared state (the
# keyed subset is the memo-fill shape: S[k]=v / S.pop(k) / S.setdefault).
_CONTAINER_CTORS = {"dict", "list", "set", "deque", "defaultdict", "OrderedDict", "Counter"}
_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "update", "setdefault", "pop", "popleft", "popitem", "clear",
    "remove", "discard",
}
_KEYED_MUTATORS = {"pop", "setdefault"}


def _shared_global_names(tree: ast.Module) -> set[str]:
    """Module-level names whose cross-thread accesses matter: mutable
    containers assigned at the top level, plus every name declared
    ``global`` inside some function (rebound module state)."""
    out: set[str] = set()
    for node in tree.body:
        targets: list[ast.expr] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None:
            continue
        is_container = isinstance(
            value, (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp, ast.SetComp)
        ) or (
            isinstance(value, ast.Call)
            and _dotted(value.func).split(".")[-1] in _CONTAINER_CTORS
        )
        if not is_container:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                out.add(tgt.id)
    for node in ast.walk(tree):
        if isinstance(node, ast.Global):
            out.update(node.names)
    return out


def _local_bound_names(fn_node: ast.AST) -> set[str]:
    """Names bound locally anywhere in a function (params, assignment /
    loop / with / except targets, comprehension vars) — a module-global
    load is only a shared read when the name is NOT shadowed locally."""
    bound: set[str] = set()
    global_names: set[str] = set()
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, (ast.Store, ast.Del)):
            bound.add(sub.id)
        elif isinstance(sub, ast.arg):
            bound.add(sub.arg)
        elif isinstance(sub, ast.ExceptHandler) and sub.name:
            bound.add(sub.name)
        elif isinstance(sub, ast.Global):
            global_names.update(sub.names)
    return bound - global_names


def _index_module(name: str, path: str, source: str, tree: ast.Module) -> ModuleInfo:
    mod = ModuleInfo(name=name, path=path, tree=tree, source=source)
    mod.shared_globals = _shared_global_names(tree)
    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                mod.imports[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                mod.imports[alias.asname or alias.name] = f"{node.module}.{alias.name}"
        elif isinstance(node, ast.ImportFrom) and node.module and node.level > 0:
            # Relative import: resolve against this module's package.
            pkg_parts = name.split(".")[: -node.level]
            base = ".".join(pkg_parts + [node.module])
            for alias in node.names:
                mod.imports[alias.asname or alias.name] = f"{base}.{alias.name}"
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                kind = _lock_kind(node.value)
                if kind is not None:
                    mod.module_locks[tgt.id] = kind
                elif isinstance(node.value, ast.Constant) and isinstance(node.value.value, str):
                    mod.const_strings[tgt.id] = node.value.value
                elif isinstance(node.value, ast.Call):
                    mod.var_types[tgt.id] = _dotted(node.value.func)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions[node.name] = _index_function(mod, None, node)
        elif isinstance(node, ast.ClassDef):
            mod.classes[node.name] = _index_class(mod, node)
    return mod


def _index_function(mod: ModuleInfo, cls: str | None, node) -> FunctionInfo:
    qname = f"{mod.name}.{cls}.{node.name}" if cls else f"{mod.name}.{node.name}"
    info = FunctionInfo(
        qname=qname, module=mod.name, cls=cls, name=node.name,
        line=node.lineno, node=node,
    )
    ret = getattr(node, "returns", None)
    if isinstance(ret, ast.Name):
        info.returns_type = ret.id
    elif isinstance(ret, ast.Constant) and isinstance(ret.value, str):
        info.returns_type = ret.value.strip("'\"")
    _FunctionPass(info, mod).generic_visit(node)
    # A module-global load shadowed by a local binding of the same name
    # is not a shared access after all.
    shadowed = _local_bound_names(node)
    if shadowed:
        info.attr_accesses = [
            a for a in info.attr_accesses
            if not (a.kind == "global" and not a.write and a.attr in shadowed)
        ]
    return info


def _index_class(mod: ModuleInfo, node: ast.ClassDef) -> ClassInfo:
    bases = [_dotted(b) for b in node.bases if _dotted(b)]
    cls = ClassInfo(
        qname=f"{mod.name}.{node.name}", module=mod.name, name=node.name,
        line=node.lineno, bases=bases,
        is_protocol=any(b.split(".")[-1] == "Protocol" for b in bases),
    )
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cls.methods[item.name] = _index_function(mod, node.name, item)
            # Attribute locks / attribute types: `self.X = threading.Lock()`
            # and `self.X = SomeClass(...)` anywhere in the class's methods
            # (constructors usually, but lazy init counts too). A plain
            # `self.X = param` where the parameter carries a simple type
            # annotation types the attribute too (`def __init__(self,
            # session: HyperspaceSession)` — the facade-wiring shape).
            param_anns: dict[str, str] = {}
            for a in (*item.args.posonlyargs, *item.args.args, *item.args.kwonlyargs):
                ann = a.annotation
                if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                    param_anns[a.arg] = ann.value.strip("'\"")
                else:
                    txt = _dotted(ann) if ann is not None else ""
                    if txt:
                        param_anns[a.arg] = txt
            for sub in ast.walk(item):
                if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1):
                    continue
                tgt = sub.targets[0]
                if not (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    continue
                cls.attr_names.add(tgt.attr)
                kind = _lock_kind(sub.value)
                if kind is not None:
                    cls.attr_locks[tgt.attr] = kind
                elif isinstance(sub.value, ast.Call):
                    cls.attr_types.setdefault(tgt.attr, _dotted(sub.value.func))
                elif isinstance(sub.value, ast.Name) and sub.value.id in param_anns:
                    cls.attr_types.setdefault(tgt.attr, param_anns[sub.value.id])
    return cls


@dataclasses.dataclass(frozen=True)
class LockDef:
    """One lock *class* in the program: a module-level lock object or a
    (class, attribute) pair. Static analysis treats every instance of a
    class as holding the same lock id — the standard lockset
    abstraction, and exactly right for the singleton caches/sessions
    this codebase locks."""

    lock_id: str
    kind: str  # Lock | RLock | Condition
    module: str
    attr: str  # bare name for module locks, attribute name for class locks
    cls: str | None


class Program:
    """The whole-program index: every module parsed once, plus the
    symbol tables name resolution needs."""

    def __init__(self, modules: dict[str, ModuleInfo]):
        self.modules = modules
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.locks: dict[str, LockDef] = {}
        self._locks_by_attr: dict[str, list[LockDef]] = {}
        self._classes_by_method: dict[str, list[str]] = {}
        self._classes_by_name: dict[str, list[str]] = {}
        self._index()

    # -- construction ------------------------------------------------------
    @classmethod
    def load(cls, paths: list[str | pathlib.Path], package_roots: dict[str, str] | None = None) -> "Program":
        """Parse every ``*.py`` under `paths` (files or directories).

        Module names are derived from the path relative to the nearest
        named package root (default: a directory holding an
        ``__init__.py`` chain), so ``hyperspace_tpu/serve/scheduler.py``
        indexes as ``hyperspace_tpu.serve.scheduler`` and stray files
        (``bench.py``) index under their stem.
        """
        modules: dict[str, ModuleInfo] = {}
        for p in paths:
            root = pathlib.Path(p)
            files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
            for f in files:
                try:
                    source = f.read_text()
                    tree = ast.parse(source, filename=str(f))
                except (OSError, SyntaxError):
                    continue  # the linter reports these; the index skips
                name = _module_name(f)
                modules[name] = _index_module(name, str(f), source, tree)
        return cls(modules)

    def _index(self) -> None:
        # hyperspace.* key constants importable across modules: the
        # merged constant table resolves `conf.set(JOIN_VENUE, ...)`
        # sites whose constant lives in config.py.
        key_constants: dict[str, str] = {}
        for mod in self.modules.values():
            for cname, val in mod.const_strings.items():
                if val.startswith("hyperspace."):
                    key_constants.setdefault(cname, val)
        for mod in self.modules.values():
            for fn in mod.functions.values():
                self.functions[fn.qname] = fn
            for name, lk in mod.module_locks.items():
                d = LockDef(f"{mod.name}.{name}", lk, mod.name, name, None)
                self.locks[d.lock_id] = d
            for cls in mod.classes.values():
                self.classes[cls.qname] = cls
                self._classes_by_name.setdefault(cls.name, []).append(cls.qname)
                for m, fn in cls.methods.items():
                    self.functions[fn.qname] = fn
                    self._classes_by_method.setdefault(m, []).append(cls.qname)
                for attr, lk in cls.attr_locks.items():
                    d = LockDef(f"{cls.qname}.{attr}", lk, mod.name, attr, cls.name)
                    self.locks[d.lock_id] = d
        for d in self.locks.values():
            self._locks_by_attr.setdefault(d.attr, []).append(d)
        for fn in self.functions.values():
            for acc in fn.config_accesses:
                if acc.key is None and acc.pending_name is not None:
                    acc.key = key_constants.get(acc.pending_name)
            # A pending name that resolves to nothing was not a config
            # key after all (dict.get(x), conf.get(other_var), ...).
            fn.config_accesses = [a for a in fn.config_accesses if a.key is not None]

    # -- lock resolution ---------------------------------------------------
    def resolve_lock(self, ref: LockRef, module: str, cls: str | None) -> LockDef | None:
        """The LockDef a with-site reference names, or None.

        - ``with _lock:`` → the module-level lock of the same module
          (or the one it was imported from).
        - ``with self._lock:`` → the enclosing class's attribute lock
          (walking base classes by name when the class itself doesn't
          define it).
        - ``with obj._state_lock:`` → resolved by attribute name when
          exactly ONE class in the program defines a lock attribute with
          that name; ambiguous attribute names stay unresolved
          (conservative: no false edges from `_lock`-vs-`_lock`).
        """
        mod = self.modules.get(module)
        if ref.kind == "name":
            if mod is not None and ref.name in mod.module_locks:
                return self.locks.get(f"{module}.{ref.name}")
            if mod is not None and ref.name in mod.imports:
                return self.locks.get(mod.imports[ref.name])
            return None
        if ref.kind == "self" and cls is not None:
            for cq in self._mro(f"{module}.{cls}"):
                c = self.classes.get(cq)
                if c is not None and ref.name in c.attr_locks:
                    return self.locks.get(f"{cq}.{ref.name}")
        candidates = [d for d in self._locks_by_attr.get(ref.name, []) if d.cls is not None]
        if len(candidates) == 1:
            return candidates[0]
        return None

    def _mro(self, cls_qname: str) -> list[str]:
        """The class plus program-local bases (by simple name), depth-first."""
        out, stack, seen = [], [cls_qname], set()
        while stack:
            q = stack.pop(0)
            if q in seen:
                continue
            seen.add(q)
            out.append(q)
            c = self.classes.get(q)
            if c is None:
                continue
            for b in c.bases:
                base_name = b.split(".")[-1]
                mod = self.modules.get(c.module)
                if mod is not None and b in mod.imports:
                    stack.append(mod.imports[b])
                elif mod is not None and base_name in mod.classes:
                    stack.append(f"{c.module}.{base_name}")
                elif len(self._classes_by_name.get(base_name, [])) == 1:
                    stack.append(self._classes_by_name[base_name][0])
        return out

    # -- type/symbol resolution (used by the call graph) -------------------
    def resolve_symbol(self, module: str, name: str, fn: "FunctionInfo | None" = None) -> str | None:
        """A dotted program qname for a bare name used in `module`:
        a local function/class, or an imported one. With `fn`, the
        function's OWN imports are consulted first — idiomatic deferred
        imports (`from hyperspace_tpu.execution import prefetch as
        _prefetch` inside a method) shadow module-level bindings for
        that function exactly like at runtime."""
        mod = self.modules.get(module)
        if mod is None:
            return None
        if fn is not None and name in fn.imports:
            got = self._import_target(fn.imports[name])
            if got is not None:
                return got
        if name in mod.functions:
            return mod.functions[name].qname
        if name in mod.classes:
            return mod.classes[name].qname
        if name in mod.imports:
            return self._import_target(mod.imports[name])
        return None

    def _import_target(self, target: str) -> str | None:
        """Resolve one import's dotted target to a known program symbol
        or module (shared by module- and function-level imports)."""
        if target in self.functions or target in self.classes or target in self.modules:
            return target
        # Package re-export: `from hyperspace_tpu.actions import
        # CreateAction` maps to hyperspace_tpu.actions.CreateAction,
        # which the package __init__ itself imports from the real
        # defining module — follow one aliasing hop.
        pkg, _, leaf = target.rpartition(".")
        if pkg in self.modules and leaf in self.modules[pkg].imports:
            t2 = self.modules[pkg].imports[leaf]
            if t2 in self.functions or t2 in self.classes or t2 in self.modules:
                return t2
        # `from hyperspace_tpu.obs import trace as obs_trace` maps the
        # alias to hyperspace_tpu.obs.trace: also try the module map by
        # suffix (modules index under their file-derived dotted name).
        for mname in self.modules:
            if mname == target or mname.endswith("." + target.split(".")[-1]) and target.endswith(mname.split(".")[-1]):
                if target == mname or target.endswith(mname) or mname.endswith(target):
                    return mname
        return None

    def class_of_ctor(self, module: str, ctor_raw: str, fn: "FunctionInfo | None" = None) -> str | None:
        """The class qname `ctor_raw` (a dotted ctor/factory expression)
        constructs: a direct class reference, or a function whose return
        annotation names a program class. With `fn`, the function's own
        deferred imports are consulted first (resolve_symbol) — `from
        ...procpool import TaskPool` inside a method types a
        `with TaskPool(...) as pool:` local exactly like at runtime."""
        parts = ctor_raw.split(".")
        target = self.resolve_symbol(module, parts[0], fn=fn)
        if target is None:
            return None
        for p in parts[1:]:
            if target in self.modules:
                mod = self.modules[target]
                if p in mod.classes:
                    target = mod.classes[p].qname
                elif p in mod.functions:
                    target = mod.functions[p].qname
                elif p in mod.var_types:
                    inner = self.class_of_ctor(target, mod.var_types[p])
                    target = inner if inner else None
                else:
                    return None
            else:
                return None
            if target is None:
                return None
        if target in self.classes:
            return target
        fn = self.functions.get(target)
        if fn is not None and fn.returns_type:
            mod = self.modules.get(fn.module)
            if mod is not None and fn.returns_type in mod.classes:
                return mod.classes[fn.returns_type].qname
        return None

    def classes_defining(self, method: str) -> list[str]:
        return self._classes_by_method.get(method, [])


def _module_name(path: pathlib.Path) -> str:
    """Dotted module name from the filesystem: walk up while
    ``__init__.py`` exists, so any package nesting maps correctly."""
    path = path.resolve()
    parts = [path.stem] if path.name != "__init__.py" else []
    d = path.parent
    while (d / "__init__.py").exists():
        parts.insert(0, d.name)
        d = d.parent
    if not parts:
        parts = [path.parent.name]
    return ".".join(parts)
