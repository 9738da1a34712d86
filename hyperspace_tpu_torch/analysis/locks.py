"""Lock-order and resource-safety analysis (rules HSL009 / HSL011).

**HSL009 lock-order inversion.** The serving plane puts ~10 locks across
the session, metadata cache, device cache, scheduler and module memo
caches; this module runs the ordering argument for them. It builds
the static lock-acquisition graph: an edge ``A → B`` means some function
acquires (or calls a chain that acquires) lock ``B`` while holding
``A`` — where "holding" is an enclosing ``with A:`` and the chain runs
through the resolved call graph (analysis/callgraph.py). A cycle in that
graph is a potential deadlock under concurrent clients: thread 1 takes
``A`` and waits on ``B`` while thread 2 holds ``B`` and waits on ``A``.
Findings carry an **inline witness**: the two conflicting acquisition
chains, one per direction, each spelled as the `with` site plus the call
chain from it to the inner acquisition.

Self-edges (``A → A``) are reported only for non-reentrant ``Lock``s —
re-acquiring an ``RLock`` on the same thread is legal and the session
RLock does exactly that.

**HSL011 resource/exception safety.** Resources acquired outside a
``with``/``try-finally`` leak on the first exception between acquire and
release:

- ``lock.acquire()`` — including the ``acquire(timeout=...)`` /
  ``acquire(blocking=...)`` signature form, recognized whatever the
  receiver is named — with no ``release()`` in a ``finally`` of an
  enclosing ``try`` (use ``with lock:``);
- ``f = open(...)`` / ``os.fdopen(...)`` /
  ``tempfile.NamedTemporaryFile(...)`` with no ``with`` and no
  ``close()`` in a ``finally``;
- a tracer span / fault-injection context (``span(...)``, ``trace(...)``,
  ``faults.injected(...)``) created but never entered with ``with`` —
  the span would never close and the fault rule never reset.

Both rules run on the single-pass function summaries in
analysis/program.py; nothing here re-walks source.
"""

from __future__ import annotations

import ast
import dataclasses

from hyperspace_tpu_torch.analysis.callgraph import CallGraph
from hyperspace_tpu_torch.analysis.lint import Finding
from hyperspace_tpu_torch.analysis.program import FunctionInfo, LockDef, Program

LOCK_ORDER = "HSL009"
RESOURCE_SAFETY = "HSL011"

# Functions returning context managers that MUST be entered: creating
# one and dropping it silently discards the instrumentation/arming.
_CM_FACTORIES = {"span", "trace", "injected", "recording"}


@dataclasses.dataclass(frozen=True)
class LockEdge:
    """held → acquired, with the witness chain that produces it.

    ``chain`` is the call path from the function holding `held` to the
    function that acquires `acquired` (both inclusive); a direct nested
    ``with`` has a single-element chain."""

    held: str
    acquired: str
    holder_fn: str
    with_line: int
    chain: tuple[str, ...]
    acquire_line: int


class LockGraph:
    """The static lock-acquisition graph over a resolved Program."""

    def __init__(self, program: Program, callgraph: CallGraph | None = None):
        self.program = program
        self.callgraph = callgraph or CallGraph(program)
        # qname -> [(LockDef, line)] locks a function acquires directly
        self.direct: dict[str, list[tuple[LockDef, int]]] = {}
        self.edges: list[LockEdge] = []
        self._build()

    def _build(self) -> None:
        prog = self.program
        for fn in prog.functions.values():
            acquired = []
            for acq in fn.acquires:
                d = prog.resolve_lock(acq.ref, fn.module, fn.cls)
                if d is not None:
                    acquired.append((d, acq.line))
            if acquired:
                self.direct[fn.qname] = acquired
        # lock-holders: functions that directly acquire anything, plus the
        # set of locks transitively acquirable through each function.
        may = self._may_acquire()
        for fn in prog.functions.values():
            # (a) nested with: B acquired while A lexically held
            for acq in fn.acquires:
                inner = prog.resolve_lock(acq.ref, fn.module, fn.cls)
                if inner is None:
                    continue
                for href in acq.held:
                    outer = prog.resolve_lock(href, fn.module, fn.cls)
                    if outer is None:
                        continue
                    self.edges.append(LockEdge(
                        outer.lock_id, inner.lock_id, fn.qname,
                        href.line, (fn.qname,), acq.line,
                    ))
            # (b) call chains: a call made under `with A:` reaching a
            # function that acquires B
            for call in fn.calls:
                if not call.held:
                    continue
                callee = self.callgraph.resolve_call(fn, call.raw)
                if callee is None:
                    continue
                targets = {callee} | self.callgraph.reachable(callee)
                inner_locks: dict[str, tuple[str, int]] = {}
                for t in targets:
                    for d, line in self.direct.get(t, []):
                        inner_locks.setdefault(d.lock_id, (t, line))
                if not inner_locks:
                    continue
                for href in call.held:
                    outer = prog.resolve_lock(href, fn.module, fn.cls)
                    if outer is None:
                        continue
                    for lock_id, (t, line) in inner_locks.items():
                        path = self.callgraph.find_path(
                            callee, {q for q in targets if any(
                                d.lock_id == lock_id for d, _ in self.direct.get(q, [])
                            )},
                        ) or [callee]
                        self.edges.append(LockEdge(
                            outer.lock_id, lock_id, fn.qname,
                            href.line, (fn.qname, *path), line,
                        ))
        _ = may  # reserved: per-function may-acquire sets feed to_json()

    def _may_acquire(self) -> dict[str, set[str]]:
        """Fixpoint: every lock a function may acquire, directly or via
        any reachable callee."""
        out: dict[str, set[str]] = {}
        for q in self.program.functions:
            locks = {d.lock_id for d, _ in self.direct.get(q, [])}
            for r in self.callgraph.reachable(q):
                locks |= {d.lock_id for d, _ in self.direct.get(r, [])}
            if locks:
                out[q] = locks
        self.may_acquire = out
        return out

    # -- cycle detection ---------------------------------------------------
    def order_edges(self) -> dict[tuple[str, str], LockEdge]:
        """One representative witness per (held, acquired) pair, shortest
        chain first."""
        best: dict[tuple[str, str], LockEdge] = {}
        for e in self.edges:
            key = (e.held, e.acquired)
            if key not in best or len(e.chain) < len(best[key].chain):
                best[key] = e
        return best

    def inversions(self) -> list[Finding]:
        """HSL009 findings: every cycle in the lock-order graph, reported
        as its conflicting edge pairs with a two-chain witness. Self-edges
        are findings only for non-reentrant Locks."""
        best = self.order_edges()
        findings: list[Finding] = []
        seen_pairs: set[frozenset] = set()
        for (a, b), e in sorted(best.items()):
            if a == b:
                kind = self.program.locks[a].kind if a in self.program.locks else "Lock"
                if kind == "RLock":
                    continue
                findings.append(self._finding(e, e, self_cycle=True))
                continue
            rev = best.get((b, a))
            if rev is None:
                continue
            pair = frozenset((a, b))
            if pair in seen_pairs:
                continue
            seen_pairs.add(pair)
            findings.append(self._finding(e, rev))
        # Longer cycles (A→B→C→A) without any 2-cycle: detect via SCC on
        # the order graph and report the component.
        findings.extend(self._multi_cycles(best, seen_pairs))
        return findings

    def _finding(self, e1: LockEdge, e2: LockEdge, self_cycle: bool = False) -> Finding:
        path = self._path_of(e1.holder_fn)
        if self_cycle:
            msg = (
                f"non-reentrant lock {e1.held} re-acquired while already held "
                f"(chain: {' -> '.join(e1.chain)} at line {e1.acquire_line}) — "
                f"this deadlocks the acquiring thread; use an RLock or split "
                f"the critical section"
            )
        else:
            msg = (
                f"lock-order inversion between {e1.held} and {e1.acquired}: "
                f"chain 1 holds {e1.held} (with at {e1.holder_fn}:{e1.with_line}) "
                f"then takes {e1.acquired} via {' -> '.join(e1.chain)}; "
                f"chain 2 holds {e2.held} (with at {e2.holder_fn}:{e2.with_line}) "
                f"then takes {e2.acquired} via {' -> '.join(e2.chain)} — two "
                f"threads interleaving these chains deadlock; impose one order "
                f"or drop the outer lock before the call"
            )
        # Witness files: every module on either chain — `--changed` must
        # keep the finding when the edit that created the cycle lives in
        # a callee, not at the reported with-site.
        witness = tuple(dict.fromkeys(
            self._path_of(q) for q in (*e1.chain, *e2.chain)
        ))
        return Finding(path, e1.with_line, 0, LOCK_ORDER, msg,
                       witness_paths=witness)

    def _multi_cycles(self, best, seen_pairs) -> list[Finding]:
        adj: dict[str, set[str]] = {}
        for (a, b) in best:
            if a != b:
                adj.setdefault(a, set()).add(b)
        sccs = _tarjan(adj)
        findings = []
        for comp in sccs:
            if len(comp) < 3:
                continue  # 2-cycles already reported with pair witnesses
            comp_set = set(comp)
            if any(frozenset(p) <= comp_set and len(frozenset(p)) == 2 for p in seen_pairs):
                continue
            ring = sorted(comp)
            edges = [
                best[(a, b)] for (a, b) in best
                if a in comp_set and b in comp_set and (a, b) in best
            ]
            e0 = edges[0]
            msg = (
                f"lock-order cycle through {len(ring)} locks: "
                f"{' -> '.join(ring)} -> {ring[0]}; first edge witness: "
                f"{' -> '.join(e0.chain)} (with at {e0.holder_fn}:{e0.with_line})"
            )
            findings.append(Finding(self._path_of(e0.holder_fn), e0.with_line, 0, LOCK_ORDER, msg))
        return findings

    def _path_of(self, fn_qname: str) -> str:
        fn = self.program.functions.get(fn_qname)
        if fn is None:
            return "<unknown>"
        mod = self.program.modules.get(fn.module)
        return mod.path if mod is not None else fn.module

    def to_json(self) -> dict:
        """Stable JSON: lock nodes and ordered edges (golden tests and
        the --format json report)."""
        return {
            "locks": {
                d.lock_id: d.kind for d in sorted(self.program.locks.values(), key=lambda x: x.lock_id)
            },
            "edges": sorted(
                {
                    (e.held, e.acquired, " -> ".join(e.chain))
                    for e in self.edges
                }
            ),
        }


def _tarjan(adj: dict[str, set[str]]) -> list[list[str]]:
    """Strongly connected components (iterative Tarjan)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    def strongconnect(v0: str) -> None:
        work = [(v0, iter(sorted(adj.get(v0, ()))))]
        index[v0] = low[v0] = counter[0]
        counter[0] += 1
        stack.append(v0)
        on_stack.add(v0)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    out.append(comp)

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)
    return out


# -- HSL011: resource / exception safety --------------------------------------

def resource_findings(program: Program) -> list[Finding]:
    findings: list[Finding] = []
    for fn in sorted(program.functions.values(), key=lambda f: (f.module, f.line)):
        mod = program.modules.get(fn.module)
        if mod is None:
            continue
        findings.extend(_scan_function(fn, mod))
    return findings


def _scan_function(fn: FunctionInfo, mod) -> list[Finding]:
    """One function's HSL011 scan: runs on the already-parsed AST node
    kept by the program index (no re-parse)."""
    findings: list[Finding] = []
    node = fn.node
    with_ctx_calls: set[int] = set()
    finally_sources: list[str] = []
    for sub in ast.walk(node):
        if isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                for inner in ast.walk(item.context_expr):
                    if isinstance(inner, ast.Call):
                        with_ctx_calls.add(id(inner))
        elif isinstance(sub, ast.Try) and sub.finalbody:
            for stmt in sub.finalbody:
                for inner in ast.walk(stmt):
                    if isinstance(inner, ast.Attribute):
                        finally_sources.append(inner.attr)

    def _report(line: int, msg: str) -> None:
        text = mod.lines[line - 1] if 0 < line <= len(mod.lines) else ""
        if "# noqa" in text:
            tail = text.split("# noqa", 1)[1]
            if not tail.strip().startswith(":") or RESOURCE_SAFETY in tail:
                return
        findings.append(Finding(mod.path, line, 0, RESOURCE_SAFETY, msg))

    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        callee = ""
        if isinstance(sub.func, ast.Attribute):
            callee = sub.func.attr
        elif isinstance(sub.func, ast.Name):
            callee = sub.func.id
        # bare lock.acquire() with no release() in a finally. Name-based
        # recognition ("lock"/"cv" in the receiver) plus the signature
        # form: `.acquire(timeout=...)` / `.acquire(blocking=...)` is the
        # threading.Lock API whatever the variable is called — and the
        # timeout form is WORSE un-finallied, because the success branch
        # must conditionally release.
        if callee == "acquire" and isinstance(sub.func, ast.Attribute):
            base = sub.func.value
            base_txt = base.id if isinstance(base, ast.Name) else getattr(base, "attr", "")
            timed = any(kw.arg in ("timeout", "blocking") for kw in sub.keywords)
            if "lock" in base_txt.lower() or "cv" in base_txt.lower() or timed:
                if "release" not in finally_sources:
                    how = ".acquire(timeout=...)" if timed else ".acquire()"
                    _report(
                        sub.lineno,
                        f"{base_txt}{how} with no release() in a finally — "
                        f"an exception between acquire and release leaves the "
                        f"lock held forever; use `with {base_txt}:` (or "
                        f"try/finally with a conditional release for the "
                        f"timeout form)",
                    )
        # f = open(...) / os.fdopen(...) / tempfile.NamedTemporaryFile(...)
        # with no with / finally close — every descriptor producer leaks
        # the same way.
        elif (callee == "open" and isinstance(sub.func, ast.Name)) or callee in (
            "fdopen", "NamedTemporaryFile", "TemporaryFile",
        ):
            if id(sub) in with_ctx_calls:
                continue
            if _is_bound_without_close(node, sub) and "close" not in finally_sources:
                _report(
                    sub.lineno,
                    f"{callee}() bound to a name outside a with/try-finally — "
                    f"the descriptor leaks on any exception before close(); "
                    f"use `with {callee}(...) as f:`",
                )
        # span/trace/injected created but never entered
        elif callee in _CM_FACTORIES:
            if id(sub) in with_ctx_calls:
                continue
            if _is_discarded(node, sub):
                _report(
                    sub.lineno,
                    f"{callee}(...) returns a context manager that is never "
                    f"entered — the span/fault scope silently does nothing; "
                    f"use `with {callee}(...):`",
                )
    return findings


def _is_bound_without_close(fn_node: ast.AST, call: ast.Call) -> bool:
    """True when `call` is the value of a simple assignment whose target
    never has `.close()` called on every path — approximated as: no
    `<target>.close()` call anywhere in the function at all (a close on
    SOME path is accepted; flow-sensitivity isn't worth the false
    positives)."""
    target: str | None = None
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Assign) and sub.value is call and len(sub.targets) == 1:
            if isinstance(sub.targets[0], ast.Name):
                target = sub.targets[0].id
    if target is None:
        return False  # used inline (open(...).read()): GC-closed; HSL006 covers writes
    for sub in ast.walk(fn_node):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "close"
            and isinstance(sub.func.value, ast.Name)
            and sub.func.value.id == target
        ):
            return False
    return True


def _is_discarded(fn_node: ast.AST, call: ast.Call) -> bool:
    """True when the CM-returning call is a bare expression statement —
    created, never entered, immediately dropped."""
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Expr) and sub.value is call:
            return True
    return False
