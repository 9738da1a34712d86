"""Exception-flow analysis: raise/propagate dataflow + rules HSL016-018.

locks.py proves the lock graph cycle-free and races.py the locksets
consistent; this layer proves the third leg of the serving-plane
contract: **where errors go**. The raw material is the ``RaiseSite`` /
``Guard`` records the single-pass function visitor already collects
(analysis/program.py): every ``raise`` with the raw type text and the
stack of enclosing try/except guards, and every call site with the
guards enclosing it. This module turns those into:

- **An exception hierarchy.** Program-local exception classes
  (``exceptions.py``, ``faults.py``) resolved through the class index
  and grafted onto the builtin exception MRO (``FaultError`` ⊆
  ``OSError`` ⊆ ``Exception``; ``CrashPoint`` ⊆ ``BaseException``
  only — the whole point of a simulated hard crash).
- **Per-function escape sets.** ``E(f)`` = the types f's own raise
  sites can throw past f's handlers, ∪ over call sites the callee's
  escapes minus the types the guards at the site absorb — handler
  subtraction is narrowed by the hierarchy (an ``except OSError``
  absorbs ``FaultError`` but never ``CrashPoint``), and a handler that
  re-raises absorbs nothing. Propagated over the resolved call graph to
  a fixpoint with shortest witness chains, mirroring how effects.py
  propagates locksets. Unresolvable raise expressions (``raise
  rule.error``) become the ``<dynamic>`` pseudo-type: recorded for
  visibility, excluded from contract drift (the engine never invents a
  finding from what it cannot name).
- **HSL016 error-contract drift.** ``exceptions.ERROR_CONTRACTS``
  declares the typed error surface of every public entry point; the
  registry is AST-extracted from any scanned module (so fixture
  packages declare their own). Any statically observed escape not
  covered by the declared contract (modulo hierarchy) is a finding;
  dead contract entries (naming no scanned function) and dead declared
  program-local types (covering no observed escape) are findings too.
  The generated ``docs/torch/errors.md`` table is verified by check.py
  exactly like HSL010 verifies the config-key table.
- **HSL017 swallowed crash/fault.** Except clauses that absorb what
  must never be absorbed: bare ``except:``, a
  ``BaseException``/``CrashPoint`` catch with no re-raise (a dying
  writer handled back to life), an explicit ``FaultError`` catch with
  no re-raise, an ``except Exception: pass`` (the silent-swallow
  shape), and the retry-classification bypass — catching ``OSError``
  inside a retry loop wider than ``is_retryable`` without re-raising
  the non-retryable remainder.
- **HSL018 unwind-safety proof.** Every fault point in
  ``faults.KNOWN_POINTS`` must sit in a function statically reachable
  from a *recovery construct* — ``Action.run``'s rollback handler, a
  ``recover()`` method, or a declared error-contract entry point — so
  an injected crash provably unwinds into code that repairs or
  surfaces it. Error paths must also stay balanced: a ``+= 1`` /
  ``-= 1`` pair on shared state (in-flight gauges, refcounts) whose
  decrement is not in a ``finally`` leaks the count on the first
  exception between the two (the raise-aware extension of HSL011).

Everything here is stdlib-only and never imports analyzed code, same
as the rest of the engine.
"""

from __future__ import annotations

import ast
import builtins
import dataclasses

from hyperspace_tpu_torch.analysis.callgraph import CallGraph
from hyperspace_tpu_torch.analysis.lint import Finding, _dotted
from hyperspace_tpu_torch.analysis.program import FunctionInfo, Guard, Program

CONTRACT_DRIFT = "HSL016"
SWALLOWED = "HSL017"
UNWIND_SAFETY = "HSL018"

#: Pseudo-type for raise expressions the resolver cannot name
#: (``raise rule.error``, ``raise self.error``). Recorded in summaries
#: and witness chains, excluded from contract-drift comparisons.
DYNAMIC = "<dynamic>"

# fn qname -> the one dynamic raise the analysis is allowed to treat as
# a KNOWN type set. Every entry must explain why the dynamic raise has a
# statically known type surface — anything else stays <dynamic>.
DYNAMIC_RAISES: dict[str, tuple[tuple[str, ...], str]] = {
    # _hit re-raises the rule's registered error object/type. inject()
    # defaults it to FaultError and every crash goes through the typed
    # `raise CrashPoint(...)` two lines above; the registered-object
    # form is test-supplied and always a FaultError in the sweep.
    "hyperspace_tpu_torch.faults._hit": (
        ("FaultError",),
        "rule.error defaults to FaultError (faults.inject); crashes use the typed CrashPoint raise",
    ),
    # result() re-raises the exact exception object the worker stored:
    # QueryServer._body catches BaseException around run_query, whose
    # declared surface this mirrors (HyperspaceError ∪ OSError ∪
    # CrashPoint; the programming-error tail surfaces as-is too).
    "hyperspace_tpu_torch.serve.scheduler.QueryHandle.result": (
        ("HyperspaceError", "OSError", "CrashPoint"),
        "re-raises the stored worker error; the worker wraps run_query, whose typed surface this is",
    ),
}


def _suppressed(mod, line: int, rule: str) -> bool:
    lines = mod.lines
    text = lines[line - 1] if 0 < line <= len(lines) else ""
    if "# noqa" not in text:
        return False
    tail = text.split("# noqa", 1)[1]
    return not tail.strip().startswith(":") or rule in tail


def _builtin_exception_mro() -> dict[str, tuple[str, ...]]:
    """Simple name -> exception-MRO simple names, for every builtin
    exception type of the running interpreter (the analyzer runs on the
    same Python the analyzed code does, so e.g. TimeoutError ⊆ OSError
    comes out right without a hand-maintained table)."""
    out: dict[str, tuple[str, ...]] = {}
    for name in dir(builtins):
        obj = getattr(builtins, name, None)
        if isinstance(obj, type) and issubclass(obj, BaseException):
            out[obj.__name__] = tuple(
                c.__name__ for c in obj.__mro__ if issubclass(c, BaseException)
            )
    return out


@dataclasses.dataclass(frozen=True)
class Escape:
    """One entry of a propagated escape set: `chain[0]` can leak
    `etype` raised at `chain[-1]`:`line` (shortest witness)."""

    etype: str
    line: int
    chain: tuple[str, ...]


class Raises:
    """Exception hierarchy + per-function escape sets over a Program."""

    def __init__(self, program: Program, callgraph: CallGraph | None = None):
        self.program = program
        self.callgraph = callgraph or CallGraph(program)
        self._builtin = _builtin_exception_mro()
        #: simple type name -> ancestor simple names (self first)
        self.ancestors: dict[str, tuple[str, ...]] = dict(self._builtin)
        #: simple names of exception classes DEFINED in the program
        self.local_types: set[str] = set()
        #: fn qname -> {etype: Escape} (the fixpoint result)
        self.escapes: dict[str, dict[str, Escape]] = {}
        #: fn qname -> {etype: line} (own raises surviving own handlers)
        self.direct: dict[str, dict[str, int]] = {}
        #: base-method qname -> subclass overrides. The call graph is
        #: deliberately under-approximate (a resolved edge names ONE
        #: callee); exception flow is a may-analysis, so a call resolved
        #: to `Action.op` may raise whatever ANY override raises —
        #: class-hierarchy dispatch, applied here (and in the HSL018
        #: reachability) without touching the lock/race graphs.
        self.overrides: dict[str, tuple[str, ...]] = {}
        self._build_hierarchy()
        self._build_overrides()
        self._build_escapes()

    # -- hierarchy ---------------------------------------------------------
    def _build_hierarchy(self) -> None:
        for qname, cls in self.program.classes.items():
            chain: list[str] = []
            tail: tuple[str, ...] = ()
            for cq in self.program._mro(qname):
                c = self.program.classes.get(cq)
                if c is None:
                    continue
                if c.name not in chain:
                    chain.append(c.name)
                for b in c.bases:
                    tb = b.split(".")[-1]
                    if tb in self._builtin and len(self._builtin[tb]) > len(tail):
                        tail = self._builtin[tb]
            if not tail:
                continue  # not an exception class
            anc = tuple(dict.fromkeys((*chain, *tail)))
            self.ancestors.setdefault(cls.name, anc)
            self.local_types.add(cls.name)

    def _build_overrides(self) -> None:
        out: dict[str, list[str]] = {}
        for d_q, d_cls in self.program.classes.items():
            for anc_q in self.program._mro(d_q)[1:]:
                a_cls = self.program.classes.get(anc_q)
                if a_cls is None:
                    continue
                for m, fn_d in d_cls.methods.items():
                    if m.startswith("__") or m not in a_cls.methods:
                        continue
                    base = a_cls.methods[m].qname
                    if fn_d.qname != base:
                        out.setdefault(base, []).append(fn_d.qname)
        # Structural dispatch through typing.Protocol seams: a call
        # resolved to a Protocol stub (IndexWriter.write) may run any
        # program class that implements EVERY method the protocol
        # declares (the all-methods bar keeps common names like `write`
        # from fanning out to unrelated classes).
        for p_q, p_cls in self.program.classes.items():
            if not p_cls.is_protocol:
                continue
            wanted = {m for m in p_cls.methods if not m.startswith("__")}
            if not wanted:
                continue
            for c_q, c_cls in self.program.classes.items():
                if c_cls.is_protocol or c_q == p_q:
                    continue
                if wanted <= set(c_cls.methods):
                    for m in wanted:
                        out.setdefault(p_cls.methods[m].qname, []).append(
                            c_cls.methods[m].qname
                        )
        self.overrides = {k: tuple(sorted(set(v))) for k, v in out.items()}

    def dispatch_targets(self, callee: str) -> tuple[str, ...]:
        """The resolved callee plus every override that may actually run."""
        return (callee, *self.overrides.get(callee, ()))

    def canonical(self, module: str, raw: str) -> str | None:
        """The simple exception-class name `raw` denotes inside
        `module`, or None when it resolves to nothing the hierarchy
        knows (a third-party type, a variable)."""
        parts = raw.split(".")
        prog = self.program
        target = prog.resolve_symbol(module, parts[0])
        if target is not None:
            node = target
            for p in parts[1:]:
                if node in prog.modules and p in prog.modules[node].classes:
                    node = prog.modules[node].classes[p].qname
                elif node in prog.modules and f"{node}.{p}" in prog.modules:
                    node = f"{node}.{p}"
                else:
                    node = ""
                    break
            if node in prog.classes:
                name = prog.classes[node].name
                return name if name in self.ancestors else None
            # An exception FACTORY: `raise _corruption(...)` where the
            # function's return annotation names an exception class.
            fn2 = prog.functions.get(node or "")
            if fn2 is not None and fn2.returns_type in self.ancestors:
                return fn2.returns_type
        tail = parts[-1]
        return tail if tail in self.ancestors else None

    def covers(self, declared: str, etype: str) -> bool:
        """True when an escape of `etype` is within a contract entry (or
        handler) declaring `declared` — i.e. etype ⊆ declared."""
        return declared in self.ancestors.get(etype, (etype,))

    # -- escape computation ------------------------------------------------
    def _survives(self, module: str, etype: str, guards: tuple[Guard, ...]) -> bool:
        """True when an exception of `etype` raised under `guards`
        escapes the enclosing try statements: no non-re-raising handler
        catches it (bare ``except:`` catches everything; a typed
        handler catches subclasses only)."""
        anc = set(self.ancestors.get(etype, ()))
        for g in guards:
            for types, reraises in g.handlers:
                if reraises:
                    continue
                if not types:
                    return False
                for h_raw in types:
                    h = self.canonical(module, h_raw)
                    if h == "BaseException":
                        return False  # absorbs everything, <dynamic> included
                    if h is not None and h in anc:
                        return False
        return True

    def _direct_escapes(self, fn: FunctionInfo) -> dict[str, int]:
        out: dict[str, int] = {}
        for rs in fn.raises:
            # Bare re-raises (and `raise e` of a handler-bound name) are
            # pass-throughs: modeled by guard NON-subtraction, never as
            # a fresh raise of the handler's (wider) caught type.
            if rs.raw is None or rs.handler_types is not None:
                continue
            etype = self.canonical(fn.module, rs.raw) or DYNAMIC
            if etype == DYNAMIC and fn.qname in DYNAMIC_RAISES:
                for t in DYNAMIC_RAISES[fn.qname][0]:
                    if self._survives(fn.module, t, rs.guards):
                        out.setdefault(t, rs.line)
                continue
            if self._survives(fn.module, etype, rs.guards):
                out.setdefault(etype, rs.line)
        return out

    def _build_escapes(self) -> None:
        prog, cg = self.program, self.callgraph
        esc: dict[str, dict[str, Escape]] = {}
        for q, fn in prog.functions.items():
            self.direct[q] = self._direct_escapes(fn)
            esc[q] = {
                t: Escape(t, line, (q,)) for t, line in self.direct[q].items()
            }
        changed = True
        while changed:
            changed = False
            for fn in prog.functions.values():
                mine = esc[fn.qname]
                for call in fn.calls:
                    callee = cg.resolve_call(fn, call.raw)
                    if callee is None or callee == fn.qname:
                        continue
                    for target in self.dispatch_targets(callee):
                        for e in list(esc.get(target, {}).values()):
                            if not self._survives(fn.module, e.etype, call.guards):
                                continue
                            chain = (fn.qname, *e.chain)
                            cur = mine.get(e.etype)
                            if cur is None or len(chain) < len(cur.chain):
                                mine[e.etype] = Escape(e.etype, e.line, chain)
                                changed = True
        self.escapes = esc

    # -- report ------------------------------------------------------------
    def to_json(self) -> dict:
        """Stable JSON form (raisedemo golden, --format json report):
        per function the direct raises and the propagated escape set
        with witness chains, plus the program-local exception hierarchy
        (builtins excluded — their MRO belongs to the interpreter, not
        the golden)."""
        per_fn: dict[str, dict] = {}
        for q in sorted(self.program.functions):
            direct = self.direct.get(q, {})
            esc = self.escapes.get(q, {})
            if not direct and not esc:
                continue
            per_fn[q] = {
                "raises": {t: direct[t] for t in sorted(direct)},
                "escapes": {
                    t: list(esc[t].chain) for t in sorted(esc)
                },
            }
        return {
            "functions": per_fn,
            "exceptions": {
                name: list(self.ancestors[name])
                for name in sorted(self.local_types)
            },
        }


# -- ERROR_CONTRACTS extraction ------------------------------------------------

def declared_contracts(program: Program) -> dict[str, tuple[tuple[str, ...], str, int]]:
    """qname -> (declared types, declaring path, line), AST-extracted
    from every scanned module's ``ERROR_CONTRACTS`` dict literal (the
    real registry lives in exceptions.py; fixture packages and corpus
    files declare their own the same way)."""
    out: dict[str, tuple[tuple[str, ...], str, int]] = {}
    for mod in program.modules.values():
        # Module-level tuple-of-string constants (the shared-surface
        # spelling: `_QUERY_SURFACE = (...)` referenced by name below).
        str_tuples: dict[str, tuple[str, ...]] = {}
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                vals = [
                    e.value for e in node.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                ]
                if len(vals) == len(node.value.elts):
                    str_tuples[node.targets[0].id] = tuple(vals)
        for node in mod.tree.body:
            target = None
            value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target, value = node.target, node.value
            if not (isinstance(target, ast.Name) and target.id == "ERROR_CONTRACTS"):
                continue
            if not isinstance(value, ast.Dict):
                continue
            for k, v in zip(value.keys, value.values):
                if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                    continue
                if isinstance(v, ast.Name) and v.id in str_tuples:
                    types = str_tuples[v.id]
                else:
                    types = tuple(
                        e.value
                        for e in (v.elts if isinstance(v, (ast.Tuple, ast.List, ast.Set)) else [])
                        if isinstance(e, ast.Constant) and isinstance(e.value, str)
                    )
                out[k.value] = (types, mod.path, k.lineno or node.lineno)
    return out


# -- HSL016: error-contract drift ---------------------------------------------

def error_contract_findings(
    program: Program,
    raises: Raises,
    contracts: dict | None = None,
) -> list[Finding]:
    contracts = declared_contracts(program) if contracts is None else contracts
    findings: list[Finding] = []
    for qname, (types, decl_path, decl_line) in sorted(contracts.items()):
        fn = program.functions.get(qname)
        decl_mod = next(
            (m for m in program.modules.values() if m.path == decl_path), None
        )
        suppressed = decl_mod is not None and _suppressed(decl_mod, decl_line, CONTRACT_DRIFT)
        if fn is None:
            in_scope = any(qname.startswith(m + ".") for m in program.modules)
            if in_scope and not suppressed:
                findings.append(Finding(
                    decl_path, decl_line, 0, CONTRACT_DRIFT,
                    f"dead contract entry: {qname!r} names no function in the "
                    f"analyzed program — the declared error surface covers "
                    f"nothing (fix the qname or delete the entry)",
                ))
            continue
        for d in types:
            if d not in raises.ancestors and not suppressed:
                findings.append(Finding(
                    decl_path, decl_line, 0, CONTRACT_DRIFT,
                    f"contract for {qname} declares unknown exception type "
                    f"{d!r} — neither a builtin exception nor a class the "
                    f"program defines (typo?)",
                ))
        mod = program.modules.get(fn.module)
        esc = raises.escapes.get(qname, {})
        for t in sorted(esc):
            if t == DYNAMIC:
                continue
            if any(raises.covers(d, t) for d in types):
                continue
            e = esc[t]
            if mod is not None and _suppressed(mod, fn.line, CONTRACT_DRIFT):
                continue
            if suppressed:
                continue
            witness = tuple(dict.fromkeys(
                program.modules[program.functions[q].module].path
                for q in e.chain
                if q in program.functions
                and program.functions[q].module in program.modules
            ))
            findings.append(Finding(
                mod.path if mod is not None else fn.module, fn.line, 0,
                CONTRACT_DRIFT,
                f"error-contract drift on {qname}: {t} escapes (witness: "
                f"{' -> '.join(e.chain)} raises it at line {e.line}) but the "
                f"declared contract only covers {list(types)} — declare {t} "
                f"(or a superclass) in exceptions.ERROR_CONTRACTS, or handle "
                f"it inside",
                witness_paths=witness,
            ))
        # Dead declared types: a program-local exception the analysis can
        # see every raise site of, declared but covering no observed
        # escape. Builtins are exempt — they arrive through stdlib calls
        # the under-approximate propagation cannot see.
        observed = [t for t in esc if t != DYNAMIC]
        for d in types:
            if d not in raises.local_types or suppressed:
                continue
            if not any(raises.covers(d, t) for t in observed):
                findings.append(Finding(
                    decl_path, decl_line, 0, CONTRACT_DRIFT,
                    f"contract for {qname} declares {d!r} but no statically "
                    f"observed escape is covered by it — the declared surface "
                    f"is wider than reality; drop it or add the raise path",
                ))
    return findings


# -- HSL017: swallowed crash/fault --------------------------------------------

_CRASH_TYPES = {"BaseException", "CrashPoint"}


def swallowed_findings(program: Program, raises: Raises) -> list[Finding]:
    findings: list[Finding] = []
    for fn in sorted(program.functions.values(), key=lambda f: (f.module, f.line)):
        mod = program.modules.get(fn.module)
        if mod is None:
            continue
        findings.extend(_scan_handlers(fn, mod, raises))
    return findings


def _scan_handlers(fn: FunctionInfo, mod, raises: Raises) -> list[Finding]:
    findings: list[Finding] = []
    # Retry loops only: `while ...` and `for ... in range(...)` iterate
    # ATTEMPTS of one operation; a `for f in files` loop iterates
    # different work items, and skipping a bad one is not a retry.
    loops = [
        (sub.lineno, getattr(sub, "end_lineno", sub.lineno) or sub.lineno)
        for sub in ast.walk(fn.node)
        if isinstance(sub, ast.While)
        or (
            isinstance(sub, ast.For)
            and isinstance(sub.iter, ast.Call)
            and _dotted(sub.iter.func).split(".")[-1] == "range"
        )
    ]

    def _report(line: int, msg: str, types: set[str] = frozenset()) -> None:
        if _suppressed(mod, line, SWALLOWED):
            return
        # Witness: the module defining each swallowed program-local
        # exception type — `--changed` mode keeps the finding when the
        # type's definition moves, not just when the handler does.
        prog = raises.program
        witness = tuple(dict.fromkeys(
            [mod.path] + [
                prog.modules[c.module].path
                for c in prog.classes.values()
                if c.name in types and c.module in prog.modules
            ]
        ))
        findings.append(
            Finding(mod.path, line, 0, SWALLOWED, msg, witness_paths=witness)
        )

    for sub in ast.walk(fn.node):
        if not isinstance(sub, ast.Try):
            continue
        for h in sub.handlers:
            line = h.lineno
            has_raise = any(isinstance(n, ast.Raise) for n in ast.walk(h))
            body_is_pass = all(isinstance(s, ast.Pass) for s in h.body)
            if h.type is None:
                if not has_raise:
                    _report(
                        line,
                        f"bare `except:` in {fn.qname} swallows EVERYTHING — "
                        f"including CrashPoint (a simulated dying writer) and "
                        f"KeyboardInterrupt; name the exception types, or "
                        f"re-raise",
                    )
                continue
            elts = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
            canon = {
                raises.canonical(fn.module, _dotted(e)) or _dotted(e).split(".")[-1]
                for e in elts
                if _dotted(e)
            }
            if canon & _CRASH_TYPES and not has_raise:
                which = sorted(canon & _CRASH_TYPES)[0]
                _report(
                    line,
                    f"except {which} in {fn.qname} with no re-raise — a "
                    f"CrashPoint is a BaseException PRECISELY so dying "
                    f"writers get no cleanup (faults.py); handling it here "
                    f"lets a 'dead' process keep running; re-raise it, or "
                    f"`# noqa: HSL017` with the isolation argument",
                    canon,
                )
            elif "FaultError" in canon and not has_raise:
                _report(
                    line,
                    f"except FaultError in {fn.qname} with no re-raise — an "
                    f"injected fault silently absorbed never reaches the "
                    f"retry layer or the crash sweep; let it propagate (or "
                    f"classify via is_retryable and re-raise the rest)",
                    canon,
                )
            elif body_is_pass and "Exception" in canon:
                _report(
                    line,
                    f"`except Exception: pass` in {fn.qname} silently "
                    f"swallows every software failure — record it (counter / "
                    f"trace event / log) or narrow the type; a best-effort "
                    f"path still owes the operator a signal",
                    canon,
                )
            elif (
                "OSError" in canon
                and not has_raise
                and any(a <= line <= b for (a, b) in loops)
                and not _mentions_retryable(h)
                # A handler that returns/breaks EXITS the retry loop and
                # reports the outcome in-band — not a silent re-attempt.
                and not any(
                    isinstance(n, (ast.Return, ast.Break)) for n in ast.walk(h)
                )
            ):
                _report(
                    line,
                    f"retry-classification bypass in {fn.qname}: `except "
                    f"OSError` inside a loop retries NON-retryable errors "
                    f"too (corruption, missing files) — classify with "
                    f"exceptions.is_retryable and re-raise the non-retryable "
                    f"remainder (utils/retry.py does this for you)",
                    canon,
                )
    return findings


def _mentions_retryable(handler: ast.ExceptHandler) -> bool:
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Name) and sub.id == "is_retryable":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "is_retryable":
            return True
    return False


# -- HSL018: unwind-safety proof ----------------------------------------------

def known_fault_points(program: Program) -> tuple[set[str], str | None]:
    """(declared fault points, declaring path) AST-extracted from any
    scanned module with a top-level ``KNOWN_POINTS`` tuple — the real
    ``faults.KNOWN_POINTS`` when the package is scanned, a fixture's or
    corpus file's own when not."""
    points: set[str] = set()
    path = None
    for mod in program.modules.values():
        for node in mod.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            tgt = node.targets[0]
            if not (isinstance(tgt, ast.Name) and tgt.id == "KNOWN_POINTS"):
                continue
            if isinstance(node.value, (ast.Tuple, ast.List)):
                for e in node.value.elts:
                    if isinstance(e, ast.Constant) and isinstance(e.value, str):
                        points.add(e.value)
                path = mod.path
    return points, path


def recovery_roots(program: Program, contracts: dict | None = None) -> dict[str, str]:
    """qname -> why it counts as a recovery construct: a declared
    error-contract entry point (the typed surface), a ``recover()``
    method, or a function whose except handler invokes a rollback."""
    contracts = declared_contracts(program) if contracts is None else contracts
    roots: dict[str, str] = {}
    for q in contracts:
        if q in program.functions:
            roots[q] = "declared error contract"
    for q, fn in program.functions.items():
        if fn.name == "recover":
            roots.setdefault(q, "recover()")
            continue
        for sub in ast.walk(fn.node):
            if not isinstance(sub, ast.Try):
                continue
            for h in sub.handlers:
                for inner in ast.walk(h):
                    if isinstance(inner, ast.Call) and "rollback" in _dotted(inner.func).lower():
                        roots.setdefault(q, "rollback handler")
    return roots


def unwind_findings(
    program: Program,
    callgraph: CallGraph,
    raises: Raises,
    contracts: dict | None = None,
) -> tuple[list[Finding], dict]:
    """(findings, proof). The proof maps every declared fault point to
    one witness chain from a recovery construct down to a function that
    threads it — the static guarantee that an injected FaultError or
    CrashPoint unwinds into rollback/recover()/a declared contract."""
    contracts = declared_contracts(program) if contracts is None else contracts
    points, faults_path = known_fault_points(program)
    findings: list[Finding] = []
    if points:
        roots = recovery_roots(program, contracts)
        # Reachability over the dispatch-augmented graph: a call resolved
        # to a base method (Action.run -> self.op) may run any override,
        # so the proof follows those edges too.
        adj: dict[str, set[str]] = {}
        for e in callgraph.edges:
            slot = adj.setdefault(e.caller, set())
            for t in raises.dispatch_targets(e.callee):
                slot.add(t)
        covered: dict[str, str] = {}  # fn qname -> root that reaches it
        for r in sorted(roots):
            if r in covered:
                continue
            stack = [r]
            covered[r] = r
            while stack:
                q = stack.pop()
                for nxt in adj.get(q, ()):
                    if nxt not in covered:
                        covered[nxt] = r
                        stack.append(nxt)
        sites: dict[str, list[tuple[str, int]]] = {}
        for fn in sorted(program.functions.values(), key=lambda f: (f.module, f.line)):
            mod = program.modules.get(fn.module)
            if mod is not None and mod.name.split(".")[-1] == "faults":
                continue  # the harness itself, not a threaded site
            for name, line, kind in fn.fault_refs:
                if kind == "point" and name in points:
                    sites.setdefault(name, []).append((fn.qname, line))
        proof: dict[str, dict] = {}
        for point in sorted(points):
            entry: dict = {"sites": [], "covered": True}
            for fq, line in sites.get(point, []):
                root = covered.get(fq)
                site: dict = {"fn": fq, "line": line}
                if root is None:
                    entry["covered"] = False
                    fn = program.functions[fq]
                    mod = program.modules.get(fn.module)
                    if mod is not None and not _suppressed(mod, line, UNWIND_SAFETY):
                        findings.append(Finding(
                            mod.path, line, 0, UNWIND_SAFETY,
                            f"fault point {point!r} in {fq} has no static "
                            f"propagation path to a recovery construct — no "
                            f"Action.run rollback, recover(), or declared "
                            f"error contract can reach it, so an injected "
                            f"crash here unwinds into nothing that repairs "
                            f"or surfaces it",
                            witness_paths=tuple(dict.fromkeys(
                                p for p in (mod.path, faults_path)
                                if p is not None
                            )),
                        ))
                else:
                    site["via"] = f"{root} ({roots.get(root, '?')})"
                    site["chain"] = _bfs_path(adj, root, fq) or [fq]
                entry["sites"].append(site)
            proof[point] = entry
    else:
        proof = {}
    findings.extend(_balance_findings(program))
    return findings, proof


def _bfs_path(adj: dict[str, set[str]], start: str, target: str) -> list[str] | None:
    """Shortest chain start -> target over the augmented adjacency
    (witness material for the per-point unwind proof)."""
    if start == target:
        return [start]
    prev: dict[str, str] = {}
    seen = {start}
    queue = [start]
    while queue:
        q = queue.pop(0)
        for nxt in sorted(adj.get(q, ())):
            if nxt in seen:
                continue
            prev[nxt] = q
            if nxt == target:
                path = [nxt]
                while path[-1] != start:
                    path.append(prev[path[-1]])
                return list(reversed(path))
            seen.add(nxt)
            queue.append(nxt)
    return None


def _balance_findings(program: Program) -> list[Finding]:
    """The raise-aware balance half of HSL018: ``X += 1`` on shared
    state (an in-flight gauge, a refcount) later ``X -= 1``'d outside
    any ``finally``, with a call between that can raise — the first
    exception skews the count forever."""
    findings: list[Finding] = []
    for fn in sorted(program.functions.values(), key=lambda f: (f.module, f.line)):
        mod = program.modules.get(fn.module)
        if mod is None:
            continue
        finally_ids: set[int] = set()
        for sub in ast.walk(fn.node):
            if isinstance(sub, ast.Try) and sub.finalbody:
                for stmt in sub.finalbody:
                    for inner in ast.walk(stmt):
                        finally_ids.add(id(inner))
        incs: dict[str, int] = {}
        decs: dict[str, tuple[int, bool]] = {}
        for sub in ast.walk(fn.node):
            if not (
                isinstance(sub, ast.AugAssign)
                and isinstance(sub.value, ast.Constant)
                and sub.value.value == 1
            ):
                continue
            key = _balance_key(sub.target, mod)
            if key is None:
                continue
            if isinstance(sub.op, ast.Add):
                incs.setdefault(key, sub.lineno)
            elif isinstance(sub.op, ast.Sub):
                cur = decs.get(key)
                if cur is None or sub.lineno < cur[0]:
                    decs[key] = (sub.lineno, id(sub) in finally_ids)
        for key, i in sorted(incs.items()):
            dec = decs.get(key)
            if dec is None or dec[1] or dec[0] <= i:
                continue
            j = dec[0]
            has_call_between = any(
                isinstance(c, ast.Call) and i < c.lineno < j
                for c in ast.walk(fn.node)
            )
            if not has_call_between or _suppressed(mod, i, UNWIND_SAFETY):
                continue
            findings.append(Finding(
                mod.path, i, 0, UNWIND_SAFETY,
                f"unbalanced unwind in {fn.qname}: {key} += 1 at line {i} is "
                f"decremented at line {j} outside any finally — an exception "
                f"in between skews the count forever (a stuck in-flight "
                f"gauge / leaked refcount); move the decrement into a "
                f"try/finally around the raising region",
                witness_paths=(mod.path,),
            ))
    return findings


def _balance_key(target: ast.expr, mod) -> str | None:
    if (
        isinstance(target, ast.Attribute)
        and isinstance(target.value, ast.Name)
        and target.value.id == "self"
    ):
        return f"self.{target.attr}"
    if isinstance(target, ast.Name) and target.id in mod.shared_globals:
        return target.id
    return None
