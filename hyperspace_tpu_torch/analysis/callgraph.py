"""Project-wide call graph over the :class:`~.program.Program` index.

Resolution is deliberately *under*-approximate: an edge exists only when
the callee can be named with confidence. The strategies, in order:

1. ``self.m()`` → the enclosing class (walking program-local bases),
   and ``super().m()`` → the nearest base defining ``m``.
2. ``self.attr.m()`` / ``obj.m()`` where the attribute/variable has a
   known type binding (``self.attr = SomeClass(...)``, ``self.attr =
   param`` with an annotated parameter, a module-level ``X =
   SomeClass(...)``, a local ``x = SomeClass(...)`` / ``x = self.a.b``
   first binding, a factory or property whose return annotation names a
   program class) → that class's method. ``Ctor(...).m(...)`` — the
   immediate-invoke shape (``CreateAction(...).run()``) — types the
   receiver through the constructor the same way.
3. A bare or dotted name that resolves through the module's imports to a
   program function, class (→ ``__init__``), or module attribute —
   following one package re-export hop (``from pkg import X`` where
   ``pkg/__init__.py`` itself imports ``X``).
4. **Unique-method fallback**: ``anything.m()`` where exactly one class
   in the whole program defines ``m`` → that method. This is what
   connects ``session.run_query(...)`` in the scheduler to
   ``HyperspaceSession.run_query`` without type inference; ambiguous
   names (``get``, ``set``, ``clear``) resolve to nothing rather than
   to everything.

Unresolved calls are recorded (``CallGraph.unresolved``) so the
lock-order analysis can report its own blind spots, but they produce no
edges — the lock-graph stays free of speculative cycles. The calls the
fallback refused because two or more classes define the name are
recorded again in ``CallGraph.ambiguous``; :meth:`CallGraph.shadowed`
picks those of them that a class outside the caller's package took from
a method unique inside it (a harness class named like a facade method
silently drops the package's edge, and every closure proof over it
shrinks).
"""

from __future__ import annotations

import collections
import dataclasses

from hyperspace_tpu_torch.analysis.program import CallSite, FunctionInfo, Program

# Method names too generic for the unique-method fallback even if only
# one program class currently defines them — a new `get` somewhere must
# not silently rewire the graph.
_FALLBACK_BLOCKLIST = {
    "get", "set", "put", "add", "update", "pop", "clear", "append", "close",
    "run", "items", "keys", "values", "copy", "join", "split", "read", "write",
    # concurrent.futures / threading API names: `_pool.submit(...)` on a
    # ThreadPoolExecutor must not resolve to QueryServer.submit.
    "submit", "result", "shutdown", "wait", "notify", "start",
    # pyarrow API names: `writer.write_table(...)` on a pq.ParquetWriter
    # must not resolve to DeviceIndexBuilder.write_table — that edge
    # would drag the whole device build plane into the spawn-worker
    # domain (HSL019) through a receiver that is not even a program
    # class.
    "write_table",
    # file-object API: `fh.flush()` on an open file must not resolve to
    # RoutingLedger.flush — that edge would pull the ledger's persist
    # path (and its fault point) into every buffered-write caller's
    # error contract (HSL016).
    "flush",
}


@dataclasses.dataclass(frozen=True)
class Edge:
    caller: str
    callee: str
    line: int


@dataclasses.dataclass(frozen=True)
class Ambiguous:
    caller: str
    raw: str
    line: int
    owners: tuple[str, ...]


class CallGraph:
    def __init__(self, program: Program):
        self.program = program
        self.edges: list[Edge] = []
        self.out: dict[str, list[Edge]] = collections.defaultdict(list)
        self.unresolved: list[tuple[str, str, int]] = []  # (caller, raw, line)
        self.ambiguous: list[Ambiguous] = []
        self._build()

    # -- resolution --------------------------------------------------------
    def resolve_call(self, fn: FunctionInfo, raw: str) -> str | None:
        """The program-function qname `raw` refers to inside `fn`."""
        prog = self.program
        # Ctor(...).m(...): type the receiver through the constructor.
        if "()." in raw:
            ctor_raw, _, rest = raw.partition("().")
            cls_q = prog.class_of_ctor(fn.module, ctor_raw, fn=fn)
            if cls_q is not None and rest:
                return self._method_chain(cls_q, rest.split("."))
            return None
        parts = raw.split(".")
        # super().m() — resolved through the enclosing class's bases.
        if parts[0] == "super" and len(parts) == 2 and fn.cls is not None:
            for q in prog._mro(f"{fn.module}.{fn.cls}")[1:]:
                c = prog.classes.get(q)
                if c is not None and parts[1] in c.methods:
                    return c.methods[parts[1]].qname
            return None
        # self.m() / self.attr.m()
        if parts[0] == "self" and fn.cls is not None:
            cls_q = f"{fn.module}.{fn.cls}"
            if len(parts) == 2:
                m = self._class_method(cls_q, parts[1])
                if m is not None:
                    return m
                # self.attr() where attr is a typed attribute holding a
                # callable class instance — not a pattern used here; fall
                # through to the unique-method fallback.
            elif len(parts) >= 3:
                attr_type = self._attr_type(cls_q, parts[1])
                if attr_type is not None:
                    return self._method_chain(attr_type, parts[2:])
            return self._unique_method(parts[-1])
        # bare name: local/imported function or class constructor
        # (function-level imports consulted first — deferred-import idiom)
        target = prog.resolve_symbol(fn.module, parts[0], fn=fn)
        if target is not None:
            if len(parts) == 1:
                return self._callable_of(target)
            # module alias chain: obs_trace.span, config.KNOWN_KEYS, ...
            node = target
            for i, p in enumerate(parts[1:], start=1):
                if node in prog.modules:
                    mod = prog.modules[node]
                    if p in mod.functions and i == len(parts) - 1:
                        return mod.functions[p].qname
                    if p in mod.classes and i == len(parts) - 1:
                        return self._callable_of(mod.classes[p].qname)
                    if p in mod.var_types:
                        cls_q = prog.class_of_ctor(node, mod.var_types[p])
                        if cls_q is not None and i < len(parts) - 1:
                            return self._method_chain(cls_q, parts[i + 1:])
                    node = f"{node}.{p}" if f"{node}.{p}" in prog.modules else None
                    if node is None:
                        break
                elif node in prog.classes and i == len(parts) - 1:
                    return self._class_method(node, p)
                else:
                    break
        # local variable typed by its first binding: `x = Ctor(...)` /
        # `x = self.a.b` (the receiver-local shape the facade and the
        # executor use)
        if parts[0] in fn.local_types and len(parts) >= 2:
            src = fn.local_types[parts[0]]
            cls_q = None
            if src.endswith("()"):
                cls_q = prog.class_of_ctor(fn.module, src[:-2], fn=fn)
            elif src.startswith("self.") and fn.cls is not None:
                cls_q = f"{fn.module}.{fn.cls}"
                for attr in src.split(".")[1:]:
                    cls_q = self._attr_type(cls_q, attr) if cls_q else None
            if cls_q is not None:
                return self._method_chain(cls_q, parts[1:])
        # variable with a known module-level type in this module
        mod = prog.modules.get(fn.module)
        if mod is not None and parts[0] in mod.var_types and len(parts) >= 2:
            cls_q = prog.class_of_ctor(fn.module, mod.var_types[parts[0]])
            if cls_q is not None:
                return self._method_chain(cls_q, parts[1:])
        if len(parts) >= 2:
            return self._unique_method(parts[-1])
        return None

    def _callable_of(self, qname: str) -> str | None:
        prog = self.program
        if qname in prog.functions:
            return qname
        if qname in prog.classes:
            init = self._class_method(qname, "__init__")
            return init if init is not None else qname  # class w/o __init__: node anyway
        return None

    def _class_method(self, cls_q: str, method: str) -> str | None:
        for q in self.program._mro(cls_q):
            c = self.program.classes.get(q)
            if c is not None and method in c.methods:
                return c.methods[method].qname
        return None

    def _attr_type(self, cls_q: str, attr: str) -> str | None:
        for q in self.program._mro(cls_q):
            c = self.program.classes.get(q)
            if c is None:
                continue
            if attr in c.attr_types:
                return self.program.class_of_ctor(c.module, c.attr_types[attr])
            # A property/accessor whose return annotation names a program
            # class types the attribute access too (`def manager(self) ->
            # CachingIndexCollectionManager` — the lazy-init shape).
            m = c.methods.get(attr)
            if m is not None and m.returns_type:
                mod = self.program.modules.get(c.module)
                if mod is not None:
                    if m.returns_type in mod.classes:
                        return mod.classes[m.returns_type].qname
                    if m.returns_type in mod.imports:
                        t = mod.imports[m.returns_type]
                        if t in self.program.classes:
                            return t
        return None

    def _method_chain(self, cls_q: str, rest: list[str]) -> str | None:
        """Resolve `a.b.c` against a class: intermediate parts through
        typed attributes, the last part as a method."""
        node = cls_q
        for i, p in enumerate(rest):
            if i == len(rest) - 1:
                return self._class_method(node, p) or self._unique_method(p)
            nxt = self._attr_type(node, p)
            if nxt is None:
                return self._unique_method(rest[-1])
            node = nxt
        return None

    def _unique_method(self, method: str) -> str | None:
        if method.startswith("__") or method in _FALLBACK_BLOCKLIST:
            return None
        owners = self.program.classes_defining(method)
        if len(owners) == 1:
            return self._class_method(owners[0], method)
        return None

    def _ambiguous_owners(self, raw: str) -> tuple[str, ...]:
        """The classes defining `raw`'s method when the unique-method
        fallback refused it for having more than one."""
        parts = raw.split(".")
        if len(parts) < 2 or "()." in raw or parts[0] == "super":
            return ()
        method = parts[-1]
        if method.startswith("__") or method in _FALLBACK_BLOCKLIST:
            return ()
        owners = self.program.classes_defining(method)
        return tuple(owners) if len(owners) > 1 else ()

    def shadowed(self) -> list[Ambiguous]:
        """Ambiguous calls made inside a package whose method only one
        class of that package defines: the others live outside it, and
        without them the call would resolve."""
        out = []
        for a in self.ambiguous:
            top = a.caller.split(".", 1)[0]
            pkg = self.program.modules.get(top)
            if pkg is None or not pkg.path.endswith("__init__.py"):
                continue
            if sum(1 for o in a.owners if o.split(".", 1)[0] == top) == 1:
                out.append(a)
        return out

    # -- graph -------------------------------------------------------------
    def _build(self) -> None:
        for fn in self.program.functions.values():
            for call in fn.calls:
                callee = self.resolve_call(fn, call.raw)
                if callee is None:
                    self.unresolved.append((fn.qname, call.raw, call.line))
                    owners = self._ambiguous_owners(call.raw)
                    if owners:
                        self.ambiguous.append(
                            Ambiguous(fn.qname, call.raw, call.line, owners))
                elif callee != fn.qname:
                    e = Edge(fn.qname, callee, call.line)
                    self.edges.append(e)
                    self.out[fn.qname].append(e)

    def callees(self, qname: str) -> list[str]:
        return [e.callee for e in self.out.get(qname, [])]

    def reachable(self, start: str) -> set[str]:
        """Every function reachable from `start` (excluding start unless
        it is on a cycle)."""
        seen: set[str] = set()
        stack = [e.callee for e in self.out.get(start, [])]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            stack.extend(e.callee for e in self.out.get(q, []))
        return seen

    def find_path(self, start: str, targets: set[str]) -> list[str] | None:
        """Shortest call chain from `start` into any of `targets`
        (BFS; includes both endpoints). Used for witness reports."""
        if start in targets:
            return [start]
        prev: dict[str, str] = {}
        seen = {start}
        queue = collections.deque([start])
        while queue:
            q = queue.popleft()
            for e in self.out.get(q, []):
                if e.callee in seen:
                    continue
                prev[e.callee] = q
                if e.callee in targets:
                    path = [e.callee]
                    while path[-1] != start:
                        path.append(prev[path[-1]])
                    return list(reversed(path))
                seen.add(e.callee)
                queue.append(e.callee)
        return None

    def resolve_site(self, fn: FunctionInfo, call: CallSite) -> str | None:
        return self.resolve_call(fn, call.raw)

    def to_json(self) -> dict:
        """Stable JSON form (golden-file tests, --format json)."""
        edges = sorted({(e.caller, e.callee) for e in self.edges})
        return {
            "functions": sorted(self.program.functions),
            "edges": [list(e) for e in edges],
            "unresolved": sorted({raw for _, raw, _ in self.unresolved}),
        }
