"""Per-function effect summaries: shared-state reads/writes with locksets.

HSL009 proved the lock graph cycle-free — nothing deadlocks. This layer
answers the dual question: is every piece of shared state actually
TOUCHED under its lock? The raw material is the ``AttrAccess`` records
the single-pass function visitor already collects (analysis/program.py):
every ``self.<attr>`` load/store and module-global access, with the
stack of lock references lexically held at the site. This module turns
those into resolved, program-wide **effect summaries**:

- **State identity.** An instance attribute is ``(class qname, attr)``
  — attributed to the MRO class that assigns it, so a subclass method
  touching a base attribute shares the base's state id (the standard
  lockset abstraction, same as lock identity in program.py). A module
  global is ``(module, name)``. Locks themselves, and attributes bound
  to thread-safe sync primitives (``Event``, ``Queue``, ...), are not
  shared *data* and are excluded.
- **Effective locksets.** The lockset at an access is the lexically
  held set UNION the locks **guaranteed held on entry** to the function:
  ``H(g) = ⋂ over resolved call sites (H(caller) ∪ held-at-site)`` —
  a private helper only ever called under the cache lock is credited
  with it. The fixpoint intersects, so ONE unguarded call site strips
  the guarantee (under-approximate, like the call graph: missing edges
  can only hide protection, never invent it).
- **Propagated summaries.** Each function's transitive effect set —
  every (state, read|write, lockset) it can perform directly or through
  any resolved callee, with a shortest witness chain — propagated
  through the cross-module call graph to a fixpoint. The race rules
  (analysis/races.py) consume these; the ``racedemo`` golden JSON pins
  their exact shape.

Everything here is stdlib-only and never imports analyzed code, same as
the rest of the engine.
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch.analysis.callgraph import CallGraph
from hyperspace_tpu_torch.analysis.program import FunctionInfo, Program

# Attribute constructor types that are synchronization primitives, not
# shared data: their cross-thread use is the point, not a race.
_SYNC_CTORS = {
    "Event", "Condition", "Semaphore", "BoundedSemaphore", "Barrier",
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue", "local",
}


@dataclasses.dataclass(frozen=True)
class ResolvedAccess:
    """One shared-state access with everything resolved: program-wide
    state id, the effective lockset (lexical ∪ entry-guaranteed), and
    where each guaranteed lock came from (witness material)."""

    state: str
    fn: str
    line: int
    write: bool
    keyed: bool
    in_init: bool
    lexical: frozenset[str]
    entry: frozenset[str]

    @property
    def locks(self) -> frozenset[str]:
        return self.lexical | self.entry


@dataclasses.dataclass(frozen=True)
class Effect:
    """One entry of a propagated summary: `fn` can perform this access
    (directly when ``chain == (fn,)``, else through the call chain)."""

    state: str
    write: bool
    locks: frozenset[str]
    line: int
    chain: tuple[str, ...]


class Effects:
    """Resolved shared-state accesses + entry-lock guarantees +
    propagated per-function effect summaries over a Program."""

    def __init__(self, program: Program, callgraph: CallGraph | None = None):
        self.program = program
        self.callgraph = callgraph or CallGraph(program)
        #: every resolved direct access, program-wide
        self.accesses: list[ResolvedAccess] = []
        #: state id -> its accesses (the HSL013 working set)
        self.by_state: dict[str, list[ResolvedAccess]] = {}
        #: fn qname -> locks guaranteed held on entry
        self.entry_locks: dict[str, frozenset[str]] = {}
        #: fn qname -> {lock id -> caller qname that guarantees it}
        self.entry_provider: dict[str, dict[str, str]] = {}
        self._summaries: dict[str, dict[tuple, Effect]] | None = None
        self._build()

    # -- state identity ----------------------------------------------------
    def state_of(self, fn: FunctionInfo, kind: str, attr: str) -> str | None:
        """The program-wide state id of an access, or None when the
        access is not shared data (locks, sync primitives, a ``self``
        access outside any class)."""
        prog = self.program
        if kind == "global":
            mod = prog.modules.get(fn.module)
            if mod is not None and attr in mod.module_locks:
                return None
            return f"{fn.module}.{attr}"
        if fn.cls is None:
            return None
        owner = f"{fn.module}.{fn.cls}"
        for cq in prog._mro(owner):
            c = prog.classes.get(cq)
            if c is None:
                continue
            if attr in c.attr_locks:
                return None  # the lock itself, not data
            if attr in c.attr_types and c.attr_types[attr].split(".")[-1] in _SYNC_CTORS:
                return None
            if attr in c.attr_names:
                return f"{cq}.{attr}"
        return f"{owner}.{attr}"

    # -- construction ------------------------------------------------------
    def _build(self) -> None:
        self._compute_entry_locks()
        for fn in self.program.functions.values():
            for acc in fn.attr_accesses:
                state = self.state_of(fn, acc.kind, acc.attr)
                if state is None:
                    continue
                lex = self._resolve_held(fn, acc.held)
                ra = ResolvedAccess(
                    state=state, fn=fn.qname, line=acc.line, write=acc.write,
                    keyed=acc.keyed, in_init=acc.in_init, lexical=lex,
                    entry=self.entry_locks.get(fn.qname, frozenset()),
                )
                self.accesses.append(ra)
                self.by_state.setdefault(state, []).append(ra)

    def _resolve_held(self, fn: FunctionInfo, held) -> frozenset[str]:
        out = set()
        for ref in held:
            d = self.program.resolve_lock(ref, fn.module, fn.cls)
            if d is not None:
                out.add(d.lock_id)
        return frozenset(out)

    def _compute_entry_locks(self) -> None:
        """Must-hold-on-entry fixpoint: a lock is guaranteed at entry to
        `g` iff EVERY resolved call site of `g` holds it (directly or by
        its own entry guarantee). Functions with no resolved callers are
        roots: nothing is guaranteed (a public API can always be called
        bare)."""
        prog, cg = self.program, self.callgraph
        in_edges: dict[str, list[tuple[str, frozenset[str]]]] = {}
        for fn in prog.functions.values():
            for call in fn.calls:
                callee = cg.resolve_call(fn, call.raw)
                # A callee can resolve to a class qname (no __init__);
                # only function nodes carry accesses.
                if callee is None or callee == fn.qname or callee not in prog.functions:
                    continue
                held = self._resolve_held(fn, call.held)
                in_edges.setdefault(callee, []).append((fn.qname, held))
        all_locks = frozenset(prog.locks)
        entry = {
            q: (all_locks if q in in_edges else frozenset())
            for q in prog.functions
        }
        changed = True
        while changed:
            changed = False
            for q, edges in in_edges.items():
                new = None
                for caller, held in edges:
                    ctx = entry.get(caller, frozenset()) | held
                    new = ctx if new is None else (new & ctx)
                if new is not None and new != entry[q]:
                    entry[q] = new
                    changed = True
        self.entry_locks = {q: s for q, s in entry.items() if s}
        # Witness material: for each guaranteed lock, one caller that
        # provides it (holds it lexically at the call site).
        for q, locks in self.entry_locks.items():
            prov: dict[str, str] = {}
            for caller, held in in_edges.get(q, []):
                for lock in locks:
                    if lock in held and lock not in prov:
                        prov[lock] = caller
            self.entry_provider[q] = prov

    # -- propagated summaries ----------------------------------------------
    def summaries(self) -> dict[str, dict[tuple, Effect]]:
        """fn qname -> {(state, write, locks): Effect} — the transitive
        effect set, propagated through the call graph to a fixpoint.
        A callee's effect lifted through a call site gains the locks
        held at that site; chains keep the shortest witness."""
        if self._summaries is not None:
            return self._summaries
        prog, cg = self.program, self.callgraph
        summ: dict[str, dict[tuple, Effect]] = {q: {} for q in prog.functions}
        for ra in self.accesses:
            key = (ra.state, ra.write, ra.locks)
            cur = summ[ra.fn].get(key)
            if cur is None:
                summ[ra.fn][key] = Effect(ra.state, ra.write, ra.locks, ra.line, (ra.fn,))
        changed = True
        while changed:
            changed = False
            for fn in prog.functions.values():
                mine = summ[fn.qname]
                for call in fn.calls:
                    callee = cg.resolve_call(fn, call.raw)
                    if callee is None or callee == fn.qname:
                        continue
                    held = self._resolve_held(fn, call.held)
                    for eff in list(summ.get(callee, {}).values()):
                        locks = eff.locks | held
                        key = (eff.state, eff.write, locks)
                        chain = (fn.qname, *eff.chain)
                        cur = mine.get(key)
                        if cur is None or len(chain) < len(cur.chain):
                            mine[key] = Effect(eff.state, eff.write, locks, eff.line, chain)
                            changed = True
        self._summaries = summ
        return summ

    def writes_reachable(self, fn_qname: str) -> list[Effect]:
        """Every write effect `fn` can perform, directly or transitively."""
        return [e for e in self.summaries().get(fn_qname, {}).values() if e.write]

    # -- report ------------------------------------------------------------
    def to_json(self) -> dict:
        """Stable JSON form (racedemo goldens, --format json report):
        per function, the direct reads/writes with their effective
        locksets, plus the entry-lock guarantees."""
        per_fn: dict[str, dict] = {}
        for ra in sorted(self.accesses, key=lambda a: (a.fn, a.line, a.state)):
            slot = per_fn.setdefault(ra.fn, {"reads": {}, "writes": {}})
            bucket = slot["writes" if ra.write else "reads"]
            locksets = bucket.setdefault(ra.state, [])
            locks = sorted(ra.locks)
            if locks not in locksets:
                locksets.append(locks)
        return {
            "functions": {q: per_fn[q] for q in sorted(per_fn)},
            "entry_locks": {
                q: sorted(s) for q, s in sorted(self.entry_locks.items())
            },
            "states": sorted(self.by_state),
        }
