"""Race rules over the effect summaries (HSL013 / HSL014), and the
launch-plan memo hygiene rule (HSL015).

**HSL013 lockset data race.** For each shared state (class attribute or
module global) the rule infers the *expected guard*: the lock contained
in a strict majority of the state's effective locksets (RacerD-style
guarded-by inference). A state whose every access holds the guard is
consistent; a state with NO dominant lock has no locking discipline to
violate (cross-thread safety there is somebody else's argument — e.g.
``QueryHandle`` synchronizes through an ``Event``). The finding is the
in-between case: a discipline exists and an access breaks it, with at
least one write in play. Reported with a **two-path witness**: the
guarded access (naming the lock and, when the guarantee comes from a
caller, the providing call site) and the conflicting unguarded access.
``__init__``-time writes are exempt (the object is not shared yet);
``# noqa: HSL013`` with a reason covers deliberately unguarded state.

**HSL014 atomicity violation.** A value read under a lock, the lock
released, then the same state written under the SAME lock where the
write (or the branch guarding it) depends on the stale read — torn
check-then-act. Two shapes are deliberately exempt because they
revalidate or converge: the *memo-fill* idiom (keyed read → keyed
insert: worst case is duplicate idempotent work, the pattern every
cache in this codebase uses) and the *re-check* idiom (the second
region re-reads the state before writing — double-checked locking).
The call-chain form is covered through the propagated summaries: a
post-region call whose callee writes the state back under the lock.

**HSL015 memo-key hygiene.** The port compiles nothing at run time;
its one per-shape cache is the launch-plan memo, ``kernels.memo``
(bounded by ``MEMO_ENTRIES``, filled under its lock). A memo key built
from a per-call value — ``id()``, a tensor (or its ``data_ptr()``), a
clock read, an RNG draw — never hits: every call plans anew and evicts
the plans that would have hit. And a module-level plan table of an
``ops`` module filled outside ``kernels.memo`` is an unbounded,
unlocked cache under the server's worker threads. The loader module
that defines ``memo`` is the one place such tables are filled directly
(under its own locks).
"""

from __future__ import annotations

import ast
import dataclasses

from hyperspace_tpu_torch.analysis.callgraph import CallGraph
from hyperspace_tpu_torch.analysis.effects import Effects, ResolvedAccess
from hyperspace_tpu_torch.analysis.lint import Finding, _dotted, _tensor_value_reads, tensor_names
from hyperspace_tpu_torch.analysis.program import FunctionInfo, LockRef, Program

LOCKSET_RACE = "HSL013"
ATOMICITY = "HSL014"
MEMO_HYGIENE = "HSL015"

def _suppressed(mod, line: int, rule: str) -> bool:
    lines = mod.lines
    text = lines[line - 1] if 0 < line <= len(lines) else ""
    if "# noqa" not in text:
        return False
    tail = text.split("# noqa", 1)[1]
    return not tail.strip().startswith(":") or rule in tail


# -- HSL013: lockset data races -----------------------------------------------

def lockset_race_findings(program: Program, effects: Effects) -> list[Finding]:
    findings: list[Finding] = []
    for state in sorted(effects.by_state):
        accesses = [
            a for a in effects.by_state[state]
            if not a.in_init and not _access_suppressed(program, a, LOCKSET_RACE)
        ]
        if len(accesses) < 2 or not any(a.write for a in accesses):
            continue
        guard = _inferred_guard(accesses)
        if guard is None:
            continue
        unguarded = [a for a in accesses if guard not in a.locks]
        if not unguarded:
            continue
        guarded = [a for a in accesses if guard in a.locks]
        pair = _conflict_pair(unguarded, guarded)
        if pair is None:
            continue
        bare, locked = pair
        findings.append(Finding(
            _path_of(program, bare.fn), bare.line, 0, LOCKSET_RACE,
            witness_paths=(_path_of(program, locked.fn),),
            message=f"lockset race on {state}: inferred guard {guard} (held at "
            f"{len(guarded)}/{len(accesses)} accesses) — "
            f"path 1: {_describe(effects, locked)}; "
            f"path 2: {_describe(effects, bare)} — two threads interleaving "
            f"these paths tear the state; hold {guard} at every access (or "
            f"annotate `# noqa: HSL013` with the reason for init-only "
            f"publication)",
        ))
    return findings


def _inferred_guard(accesses: list[ResolvedAccess]) -> str | None:
    """The lock held at a strict majority of accesses (the guarded-by
    inference); None when every access holds it (consistent) or no lock
    dominates (no discipline to violate)."""
    counts: dict[str, int] = {}
    for a in accesses:
        for lock in a.locks:
            counts[lock] = counts.get(lock, 0) + 1
    if not counts:
        return None
    guard = max(sorted(counts), key=lambda k: counts[k])
    n = counts[guard]
    if n == len(accesses) or n * 2 <= len(accesses):
        return None
    return guard


def _conflict_pair(unguarded, guarded):
    """(unguarded, guarded) witness pair with at least one write —
    prefer the pair that shows a write on the unguarded side."""
    bare_w = [a for a in unguarded if a.write]
    lock_w = [a for a in guarded if a.write]
    if bare_w:
        return bare_w[0], (lock_w[0] if lock_w else guarded[0])
    if lock_w:
        return unguarded[0], lock_w[0]
    return None


def _describe(effects: Effects, a: ResolvedAccess) -> str:
    what = "write" if a.write else "read"
    if not a.locks:
        return f"{what} at {a.fn}:{a.line} holding no lock"
    vias = []
    for lock in sorted(a.locks):
        if lock in a.lexical:
            vias.append(lock)
        else:
            provider = effects.entry_provider.get(a.fn, {}).get(lock)
            vias.append(f"{lock} (guaranteed by caller {provider})" if provider else lock)
    return f"{what} at {a.fn}:{a.line} holding {', '.join(vias)}"


def _access_suppressed(program: Program, a: ResolvedAccess, rule: str) -> bool:
    fn = program.functions.get(a.fn)
    mod = program.modules.get(fn.module) if fn is not None else None
    return mod is not None and _suppressed(mod, a.line, rule)


def _path_of(program: Program, fn_qname: str) -> str:
    fn = program.functions.get(fn_qname)
    if fn is None:
        return "<unknown>"
    mod = program.modules.get(fn.module)
    return mod.path if mod is not None else fn.module


# -- HSL014: torn check-then-act ----------------------------------------------

@dataclasses.dataclass
class _Region:
    """One ``with <lock>`` region in a function: the states it reads and
    writes, and the local names it binds from reads of each state."""

    lock: str
    node: ast.With
    start: int
    end: int
    binds: dict[str, str] = dataclasses.field(default_factory=dict)  # name -> state
    keyed_binds: set[str] = dataclasses.field(default_factory=set)
    reads: dict[str, int] = dataclasses.field(default_factory=dict)  # state -> first line
    # (state, line, keyed, value_names)
    writes: list[tuple[str, int, bool, frozenset[str]]] = dataclasses.field(default_factory=list)


def atomicity_findings(program: Program, effects: Effects) -> list[Finding]:
    findings: list[Finding] = []
    for fn in sorted(program.functions.values(), key=lambda f: (f.module, f.line)):
        mod = program.modules.get(fn.module)
        if mod is None:
            continue
        findings.extend(_scan_atomicity(fn, mod, program, effects))
    return findings


def _scan_atomicity(fn: FunctionInfo, mod, program: Program, effects: Effects) -> list[Finding]:
    regions = _lock_regions(fn, program, effects)
    if not regions:
        return []
    findings: list[Finding] = []
    guards = _guard_tests(fn.node)
    assigns = _name_assign_lines(fn.node)
    for i, ri in enumerate(regions):
        for name, state in ri.binds.items():
            for rj in regions[i + 1:]:
                if rj.lock != ri.lock or rj.start <= ri.end:
                    continue
                f = _torn_pair(fn, mod, ri, rj, name, state, guards, assigns)
                if f is not None:
                    findings.append(f)
            f = _torn_call(fn, mod, ri, name, state, guards, assigns, effects)
            if f is not None:
                findings.append(f)
    return findings


def _torn_pair(fn, mod, ri: _Region, rj: _Region, name: str, state: str,
               guards, assigns) -> Finding | None:
    """A write to `state` in region `rj` that depends on the value bound
    to `name` from region `ri`'s read — unless revalidated."""
    if _killed(assigns, name, ri.end, rj.start):
        return None
    for w_state, w_line, w_keyed, w_names in rj.writes:
        if w_state != state:
            continue
        depends = name in w_names
        decided = any(
            start <= rj.start and end >= rj.end and name in names
            for (start, end, names) in guards
        )
        if not depends and not decided:
            continue
        # memo-fill: keyed read then keyed insert — duplicate idempotent
        # work at worst, the sanctioned cache idiom.
        if w_keyed and name in ri.keyed_binds and not depends:
            continue
        # re-check: region j re-reads the state before writing
        # (double-checked locking) — the decision is revalidated.
        if state in rj.reads and rj.reads[state] <= w_line:
            continue
        if _suppressed(mod, w_line, ATOMICITY):
            return None
        return Finding(
            mod.path, w_line, 0, ATOMICITY,
            f"torn check-then-act on {state}: {name!r} read under "
            f"{ri.lock} at {fn.qname}:{ri.start}, lock released, then "
            f"written back under the re-acquired lock at line {w_line} "
            f"{'using the stale value' if depends else 'behind a decision on the stale value'}"
            f" — another thread can update {state} between the two "
            f"critical sections; widen the lock to cover both, or "
            f"re-validate inside the second",
        )
    return None


def _torn_call(fn, mod, ri: _Region, name: str, state: str, guards, assigns,
               effects: Effects) -> Finding | None:
    """The call-chain form: after region `ri`, a call guarded by a
    decision on the stale read whose callee writes `state` back under
    the same lock."""
    for call in fn.calls:
        if call.line <= ri.end or _killed(assigns, name, ri.end, call.line):
            continue
        # A call made while still holding the lock is not torn — the
        # read and the callee's write share one critical section.
        if ri.lock in effects._resolve_held(fn, call.held):
            continue
        decided = any(
            start < call.line <= end and name in names
            for (start, end, names) in guards
        )
        if not decided:
            continue
        callee = effects.callgraph.resolve_call(fn, call.raw)
        if callee is None:
            continue
        for eff in effects.writes_reachable(callee):
            if eff.state == state and ri.lock in eff.locks:
                if _suppressed(mod, call.line, ATOMICITY):
                    return None
                chain = " -> ".join((fn.qname, *eff.chain))
                witness = tuple(dict.fromkeys(
                    _path_of(effects.program, q) for q in (fn.qname, *eff.chain)
                ))
                return Finding(
                    mod.path, call.line, 0, ATOMICITY,
                    witness_paths=witness,
                    message=f"torn check-then-act on {state} across a call chain: "
                    f"{name!r} read under {ri.lock} at {fn.qname}:{ri.start}, "
                    f"lock released, then {chain} re-acquires it and writes "
                    f"{state} behind a decision on the stale value — widen "
                    f"the critical section or re-validate in the callee",
                )
    return None


def _lock_regions(fn: FunctionInfo, program: Program, effects: Effects) -> list[_Region]:
    regions: list[_Region] = []
    for sub in ast.walk(fn.node):
        if not isinstance(sub, (ast.With, ast.AsyncWith)):
            continue
        for item in sub.items:
            ref = _as_lock_ref(item.context_expr, sub.lineno)
            if ref is None:
                continue
            d = program.resolve_lock(ref, fn.module, fn.cls)
            if d is None:
                continue
            region = _Region(
                lock=d.lock_id, node=sub, start=sub.lineno,
                end=getattr(sub, "end_lineno", sub.lineno) or sub.lineno,
            )
            _fill_region(region, sub, fn, effects)
            regions.append(region)
    regions.sort(key=lambda r: r.start)
    return regions


def _as_lock_ref(ctx: ast.expr, line: int) -> LockRef | None:
    if isinstance(ctx, ast.Name):
        return LockRef("name", ctx.id, line)
    if isinstance(ctx, ast.Attribute):
        base = ctx.value
        if isinstance(base, ast.Name) and base.id == "self":
            return LockRef("self", ctx.attr, line)
        return LockRef("attr", ctx.attr, line)
    return None


def _fill_region(region: _Region, with_node: ast.With, fn: FunctionInfo,
                 effects: Effects) -> None:
    # binds: x = self.attr / x = NAME / x = S.get(...) / x = S[k]
    for sub in ast.walk(with_node):
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                and isinstance(sub.targets[0], ast.Name):
            tgt = sub.targets[0].id
            src, keyed = _read_source(sub.value)
            if src is not None:
                state = effects.state_of(fn, *src)
                if state is not None:
                    region.binds[tgt] = state
                    if keyed:
                        region.keyed_binds.add(tgt)
    # reads / writes: the recorded accesses that fall inside the region
    start, end = region.start, region.end
    for acc in fn.attr_accesses:
        if not (start <= acc.line <= end):
            continue
        state = effects.state_of(fn, acc.kind, acc.attr)
        if state is None:
            continue
        if acc.write:
            names = _write_value_names(with_node, acc.line)
            region.writes.append((state, acc.line, acc.keyed, names))
        else:
            region.reads.setdefault(state, acc.line)


def _read_source(value: ast.expr) -> tuple[tuple[str, str] | None, bool]:
    """((kind, attr), keyed) when `value` reads shared state into a
    name: ``self.attr`` / ``NAME`` / ``<those>.get(...)`` /
    ``<those>[k]``; (None, False) otherwise."""
    keyed = False
    node = value
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get":
        node = node.func.value
        keyed = True
    elif isinstance(node, ast.Subscript):
        node = node.value
        keyed = True
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return ("self", node.attr), keyed
    if isinstance(node, ast.Name):
        return ("global", node.id), keyed
    return None, False


def _write_value_names(scope: ast.AST, line: int) -> frozenset[str]:
    """Names appearing in the RHS of assignment statements on `line`
    inside `scope` (the dependency test for stale-value write-back)."""
    names: set[str] = set()
    for sub in ast.walk(scope):
        if isinstance(sub, (ast.Assign, ast.AugAssign)) and sub.lineno == line:
            value = sub.value
            for inner in ast.walk(value):
                if isinstance(inner, ast.Name):
                    names.add(inner.id)
        elif isinstance(sub, ast.Call) and sub.lineno == line:
            for arg in sub.args:
                for inner in ast.walk(arg):
                    if isinstance(inner, ast.Name):
                        names.add(inner.id)
    return frozenset(names)


def _guard_tests(fn_node: ast.AST) -> list[tuple[int, int, frozenset[str]]]:
    """(start, end, names-in-test) for every if/while in the function —
    the 'decision based on the stale read' test."""
    out = []
    for sub in ast.walk(fn_node):
        if isinstance(sub, (ast.If, ast.While)):
            names = frozenset(
                n.id for n in ast.walk(sub.test) if isinstance(n, ast.Name)
            )
            if names:
                out.append((
                    sub.lineno,
                    getattr(sub, "end_lineno", sub.lineno) or sub.lineno,
                    names,
                ))
    return out


def _name_assign_lines(fn_node: ast.AST) -> dict[str, list[int]]:
    out: dict[str, list[int]] = {}
    for sub in ast.walk(fn_node):
        if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
            for tgt in targets:
                for inner in ast.walk(tgt):
                    if isinstance(inner, ast.Name):
                        out.setdefault(inner.id, []).append(sub.lineno)
        elif isinstance(sub, ast.For):
            for inner in ast.walk(sub.target):
                if isinstance(inner, ast.Name):
                    out.setdefault(inner.id, []).append(sub.lineno)
    return out


def _killed(assigns: dict[str, list[int]], name: str, after: int, before: int) -> bool:
    """True when `name` is re-bound strictly between the two lines —
    the stale value is gone, so no torn write-back."""
    return any(after < line < before for line in assigns.get(name, []))


# -- HSL015: memo-key hygiene -------------------------------------------------

#: Call tails that read a clock or draw a random value: a memo key built
#: from one is new on every call.
_PER_CALL_TAILS = {
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
    "perf_counter_ns", "now", "utcnow", "uuid4", "getpid", "data_ptr",
}
_RNG_ROOTS = ("random", "np.random", "numpy.random", "secrets")
_TABLE_MUTATORS = {
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popitem", "clear", "remove", "discard",
}


def memo_hygiene_findings(program: Program) -> list[Finding]:
    findings: list[Finding] = []
    for mod in sorted(program.modules.values(), key=lambda m: m.name):
        fns = list(mod.functions.values())
        for cls in mod.classes.values():
            fns.extend(cls.methods.values())
        tables = _plan_tables(mod)
        for fn in sorted(fns, key=lambda f: f.line):
            tensors = None
            for sub in ast.walk(fn.node):
                if not isinstance(sub, ast.Call):
                    continue
                if _dotted(sub.func).rsplit(".", 1)[-1] != "memo" or len(sub.args) < 2:
                    continue
                if tensors is None:
                    tensors = tensor_names(fn.node)
                why = _per_call_key(sub.args[1], tensors)
                if why and not _suppressed(mod, sub.lineno, MEMO_HYGIENE):
                    findings.append(Finding(
                        mod.path, sub.lineno, 0, MEMO_HYGIENE,
                        f"kernels.memo key in {fn.qname} is built from {why} — "
                        f"a per-call key never hits and evicts the plans that "
                        f"would: key the plan on shapes, dtypes and the device",
                    ))
            for line, name in _table_fills(fn.node, tables):
                if _suppressed(mod, line, MEMO_HYGIENE):
                    continue
                findings.append(Finding(
                    mod.path, line, 0, MEMO_HYGIENE,
                    f"module-level plan table {name!r} of {mod.name} filled "
                    f"in {fn.qname} outside kernels.memo — an unbounded, "
                    f"unlocked cache under the server's threads; fill it "
                    f"through kernels.memo(table, key, build)",
                ))
    return findings


def _per_call_key(key: ast.AST, tensors: set[str]) -> str | None:
    read = _tensor_value_reads(key, frozenset(tensors))
    if read:
        return f"tensor {sorted(read)[0]!r}"
    for sub in ast.walk(key):
        if not isinstance(sub, ast.Call):
            continue
        d = _dotted(sub.func)
        tail = d.rsplit(".", 1)[-1]
        if d == "id":
            return "id()"
        if tail in _PER_CALL_TAILS:
            return f"{d}()"
        if any(d.startswith(r + ".") for r in _RNG_ROOTS) or d.startswith("torch.rand"):
            return f"an RNG draw ({d}())"
    return None


def _plan_tables(mod) -> set[str]:
    """Module-level containers of an `ops` module: its plan tables. The
    module that defines `memo` (the loader) fills its own under locks."""
    if "ops" not in mod.name.split("."):
        return set()
    if any(
        isinstance(n, ast.FunctionDef) and n.name == "memo" for n in mod.tree.body
    ):
        return set()
    out: set[str] = set()
    for node in mod.tree.body:
        targets, value = [], None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None:
            continue
        if isinstance(value, (ast.Dict, ast.List, ast.Set)) or (
            isinstance(value, ast.Call)
            and _dotted(value.func).rsplit(".", 1)[-1]
            in ("dict", "list", "set", "OrderedDict", "defaultdict")
        ):
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


def _table_fills(fn_node: ast.AST, tables: set[str]) -> list[tuple[int, str]]:
    if not tables:
        return []
    out = []
    for sub in ast.walk(fn_node):
        if isinstance(sub, (ast.Assign, ast.AugAssign, ast.Delete)):
            tgts = sub.targets if isinstance(sub, (ast.Assign, ast.Delete)) else [sub.target]
            for t in tgts:
                if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                        and t.value.id in tables:
                    out.append((sub.lineno, t.value.id))
        elif isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _TABLE_MUTATORS \
                and isinstance(sub.func.value, ast.Name) and sub.func.value.id in tables:
            out.append((sub.lineno, sub.func.value.id))
    return out
