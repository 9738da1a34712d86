"""Durability-domain analysis: crash-consistency as theorems (HSL027-030).

The whole thesis of this repo is index metadata as a log-backed catalog
with crash-safe two-phase commits, and the ingest/fleet/observability
layers multiplied the durable surfaces that thesis rests on — ingest
cursors and control files, CDC delta batches, heal markers, journal
segments, incident bundles, shared-cache entries, the advisor ledger.
Each carries a hand-maintained atomic-publish / write-ordering /
replay-idempotence protocol that, until this layer, only the dynamic
crash sweeps exercised. This module is the durability dual of
:mod:`procdomain`/:mod:`tracedomain`: instead of inferring which code
runs in which *process* or *trace*, it infers which code **writes which
durable root**, then turns each protocol into a checked rule.

- **The durability-domain inference.** :data:`DURABLE_ROOTS` declares
  every durable file plane by path marker (AST-extracted from any
  scanned module, exactly like ``SPAWN_ENTRY_POINTS`` — fixture
  packages declare their own). A *durable write site* is any raw write
  (``open(.., "w")``/``write_text``/``write_bytes``/``os.open`` with
  ``O_WRONLY``), atomic publish (``os.replace``/``os.rename``/
  ``os.link``), or delegation to a program function that transitively
  writes, whose call text — widened through local path bindings and
  ``self.<attr>`` accessor bodies, the HSL021 mechanics — names a
  declared root. The *durability domain* is every function whose
  call-graph closure contains such a site (the reverse closure of the
  writing functions, dispatch-augmented, with witness chains).

- **HSL027 atomic-publish completeness.** Every durable write must
  reach the sanctioned idiom: an ``os.replace``/``os.rename``/
  ``os.link`` publish with an ``fsync`` strictly BEFORE it in the same
  function (``file_utils._overwrite_json`` is the exemplar), or a
  delegation chain to a function that proves it. A publish with no
  fsync-before-replace can surface a zero-length file after a crash —
  the rename is durable before the data is. This generalizes HSL021
  from lease/fleet paths to every declared durable root; lease/fleet
  write sites this rule claims are deduplicated out of HSL021 so
  ``--changed`` runs report each site exactly once, under the newer
  rule. ``O_EXCL`` claims stay HSL021's (the TTL-reap proof lives
  there); ``os.rename`` inside a TTL-reaper is a lease clear, not a
  durable publish, and is exempt.

- **HSL028 torn-window ordering.** :data:`TORN_WINDOWS` declares every
  exactly-once protocol as (function, first-write pattern, second-write
  pattern, in-window fault point): batch-published-before-cursor-saved,
  commit-before-lag-stamp, segment-sealed-before-eviction-index,
  marker-after-heal. The rule proves, statically, that the two writes
  are ordered on every path (every textual occurrence of the first
  precedes every occurrence of the second) AND that a declared
  ``faults.KNOWN_POINTS`` entry is armed strictly inside the window —
  so the dynamic crash sweeps (tests/test_ingest.py, test_journal.py,
  test_controller.py parametrize over this registry by name) provably
  exercise each torn state and can never drift from the static list.

- **HSL029 replay-idempotence.** :data:`REPLAY_ROOTS` declares the
  recovery/re-poll/takeover entry points. Any durable write site in
  their call-graph closure must derive its file name from cursor /
  log-id / generation values — never wall clock, pid, or RNG — making
  the "a retry rewrites the SAME file at the SAME path" contract a
  theorem instead of a comment.

- **HSL030 snapshot-stamp discipline.** Code in a pinned-snapshot
  context — any function carrying a ``snapshot``/``snap`` parameter,
  plus the unguarded closure it calls into — must key caches on the
  snapshot's ``stamp`` and never read the live version vector
  (``get_latest_id``/``collection_log_versions``/``latest_log_id``).
  A conditional whose test names the snapshot parameter marks BOTH
  branches as the sanctioned pinned-vs-live dispatch
  (``plan_cache.versioned_plan_key`` is the exemplar).

Everything here is stdlib-``ast`` only and never imports analyzed code,
same as the rest of the engine (docs/torch/static_analysis.md).
"""

from __future__ import annotations

import ast
import dataclasses
import re

from hyperspace_tpu_torch.analysis.callgraph import CallGraph
from hyperspace_tpu_torch.analysis.lint import Finding, _dotted
from hyperspace_tpu_torch.analysis.procdomain import ProcessDomains, _suppressed
from hyperspace_tpu_torch.analysis.program import FunctionInfo, ModuleInfo, Program
from hyperspace_tpu_torch.analysis.raises import known_fault_points

ATOMIC_PUBLISH = "HSL027"
TORN_WINDOW = "HSL028"
REPLAY_IDEMPOTENCE = "HSL029"
SNAPSHOT_STAMP = "HSL030"

#: The real registry: every durable file plane of this package, by the
#: path-marker text that names it in write-call expressions (lowered
#: substring match over the call segment widened with local bindings
#: and ``self.<attr>`` accessor bodies). AST-extracted from this module
#: when the package is scanned — fixture packages and corpus files
#: declare their own ``DURABLE_ROOTS`` literal the same way. Keep it a
#: plain dict literal of string constants.
DURABLE_ROOTS = {
    "hyperspace_log": "the op log: version entries + transient markers",
    "latest_stable": "the latestStable pointer (2-phase commit anchor)",
    "_ingest": "ingest state dir: cursors + pause/resume control",
    "control_file": "ingest control file (pause/resume, atomic JSON)",
    "cursor": "per-index ingest cursors (offset/seq/seen-set)",
    "cdc-": "streaming CDC delta batches (seq-named parquet)",
    "advisor_dir": "the _advisor routing ledger",
    "lease": "fleet cross-process lease files",
    "heal": "fleet heal markers (generation-stamped)",
    "entry_path": "fleet shared plan-cache entries",
    "segment_prefix": "telemetry journal segments (sealed jsonl)",
    "bundle": "controller incident bundles",
    "incident": "controller incident state",
}

#: Declared exactly-once protocols: window name -> (function qname,
#: first-write pattern, second-write pattern, in-window fault point,
#: why). The dynamic crash sweeps parametrize over this registry BY
#: NAME (tests/test_ingest.py, test_journal.py, test_controller.py), so
#: the static window list and the sweep can never drift apart.
TORN_WINDOWS = {
    "ingest.cdc.batch_before_cursor": (
        "hyperspace_tpu_torch.ingest.tailer.CdcTailer.poll",
        "_write_batch", "cursor.save", "ingest.tail",
        "a CDC batch file lands before the cursor advances; the re-poll "
        "rewrites the same seq-named file"),
    "ingest.commit_before_lag_stamp": (
        "hyperspace_tpu_torch.ingest.daemon.IngestDaemon._tick_index",
        "commit_micro_batch", "_last_commit_id", "ingest.stamp",
        "a micro-batch commits before the daemon stamps lag/commit "
        "bookkeeping; recover() converges the log, the next tick restamps"),
    "journal.seal_before_index": (
        "hyperspace_tpu_torch.obs.journal._seal_locked",
        "os.replace", "_evict_locked", "journal.seal",
        "a sealed segment is published before the eviction index runs; "
        "sweep() re-lists and merges the orphan segment"),
    "controller.marker_after_heal": (
        "hyperspace_tpu_torch.serve.controller.OpsController._heal",
        "_heal_local", "_write_marker", "controller.heal.marker",
        "the shared bytes heal before the generation marker publishes; "
        "followers re-heal idempotently on the next tick"),
}

#: Recovery / re-poll / takeover entry points: every durable file name
#: reachable from these must derive from cursor/log-id/generation
#: values (HSL029) so a replay rewrites the same paths.
REPLAY_ROOTS = {
    "hyperspace_tpu_torch.ingest.tailer.CdcTailer.poll":
        "CDC re-poll after a crash rewrites the same seq-named batch",
    "hyperspace_tpu_torch.hyperspace.Hyperspace.recover":
        "log recovery: quarantine/roll-forward rewrites version-named state",
    "hyperspace_tpu_torch.serve.fleet.singleflight.SingleFlight.run":
        "single-flight takeover re-runs the build under the same key",
}

#: Publish tails: the call that makes a durable name visible.
_PUBLISH_TAILS = ("replace", "rename", "link")
#: A rename whose destination carries one of these is a quarantine /
#: tombstone move — it takes a file OUT of the durable namespace
#: (recover()'s `.corrupt` aside, a reaper's `.reap-` steal), so there
#: is no payload whose durability must precede the name.
_TOMBSTONE_MARKERS = ("corrupt", "quarantine", "tombstone", ".reap")
#: Durability barrier tails: must precede the publish in the same fn.
_FSYNC_TAILS = ("fsync", "_fsync_dir", "fsync_dir")
#: Snapshot-context parameter names (HSL030 carriers).
_SNAPSHOT_PARAMS = ("snapshot", "snap")
#: Live version-vector reads banned inside a pinned-snapshot context.
_LIVE_READ_TAILS = ("get_latest_id", "collection_log_versions")
_LIVE_READ_ATTR = "latest_log_id"
#: Nondeterministic name atoms (HSL029): a durable file name derived
#: from any of these cannot be rewritten identically on replay.
_NONDETERMINISTIC = (
    "time.time", "time_ns", "monotonic", "perf_counter", "datetime.now",
    "utcnow", "getpid", "uuid4", "uuid1", "token_hex", "urandom",
    "randint", "randrange", "random.random",
)

_SELF_REF_RE = re.compile(r"self\.([a-z_][a-z0-9_]*)")


def _seg(mod: ModuleInfo, node: ast.AST) -> str:
    """Source text of ``node`` against the module's precomputed line
    table — ``ast.get_source_segment`` re-splits the whole module source
    on every call, which made the site sweep quadratic in practice."""
    l0 = getattr(node, "lineno", None)
    l1 = getattr(node, "end_lineno", None)
    if l0 is None or l1 is None:
        return ""
    c0, c1 = node.col_offset, node.end_col_offset
    lines = mod.lines
    if l0 < 1 or l1 > len(lines):
        return ""
    if l0 == l1:
        return lines[l0 - 1][c0:c1]
    return "\n".join([lines[l0 - 1][c0:], *lines[l0:l1 - 1], lines[l1 - 1][:c1]])


def _dict_registry(program: Program, name: str) -> dict[str, tuple[str, ...]] | None:
    """The union of every scanned module's top-level ``<name>`` dict
    literal, values normalized to string tuples; None when no module
    declares one — the rules that read it disarm, so a corpus file
    scanned alone reports nothing it didn't declare."""
    out: dict[str, tuple[str, ...]] | None = None
    for mod in program.modules.values():
        for node in mod.tree.body:
            target = value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target, value = node.target, node.value
            if not (isinstance(target, ast.Name) and target.id == name):
                continue
            if not isinstance(value, ast.Dict):
                continue
            out = out or {}
            for k, v in zip(value.keys, value.values):
                if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                    continue
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    out[k.value] = (v.value,)
                elif isinstance(v, (ast.Tuple, ast.List)):
                    out[k.value] = tuple(
                        e.value for e in v.elts
                        if isinstance(e, ast.Constant) and isinstance(e.value, str)
                    )
    return out


@dataclasses.dataclass
class WriteSite:
    """One durable write: a raw write, an atomic publish, or a
    delegated call into a function that transitively writes."""

    fn: str                      # containing function qname
    line: int
    kind: str                    # "raw" | "publish" | "delegated"
    root: str                    # the DURABLE_ROOTS marker matched
    seg: str                     # widened, lowered call text (HSL029 input)
    ok: bool = True              # proves (or delegates to) the idiom
    target: str | None = None    # delegation target, when kind=="delegated"
    chain: tuple[str, ...] = ()  # delegation witness chain


@dataclasses.dataclass
class _FnWrites:
    """Per-function write profile (the HSL027 proof obligations)."""

    raw_lines: list[int] = dataclasses.field(default_factory=list)
    publish: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    fsync_lines: list[int] = dataclasses.field(default_factory=list)

    @property
    def writes(self) -> bool:
        return bool(self.raw_lines or self.publish)

    @property
    def proven(self) -> bool:
        """fsync-before-publish in the same function body."""
        return any(
            any(f < line for f in self.fsync_lines)
            for _, line in self.publish
        )


class DurabilityDomains:
    """Infer the durability domain and check HSL027-030 over it.

    Same engine contract as :class:`procdomain.ProcessDomains`: built
    from the program summaries and call graph, never importing analyzed
    code; ``findings()`` returns the rule violations and ``to_json()``
    the inferred graph (golden-tested for the durademo fixture and
    shipped in the check report's ``durable_domains`` section).
    ``claimed_sites`` is the HSL021-dedupe surface check.py consumes.
    """

    def __init__(self, program: Program, callgraph: CallGraph, raises=None):
        self.program = program
        self.callgraph = callgraph
        self.raises = raises

        roots = _dict_registry(program, "DURABLE_ROOTS")
        self.roots: dict[str, str] | None = (
            {k: v[0] if v else "" for k, v in roots.items()}
            if roots is not None else None
        )
        self.windows = _dict_registry(program, "TORN_WINDOWS")
        replay = _dict_registry(program, "REPLAY_ROOTS")
        self.replay_roots: dict[str, str] | None = (
            {k: v[0] if v else "" for k, v in replay.items()}
            if replay is not None else None
        )
        self.known_points, _ = known_fault_points(program)

        #: per-function write profiles (all functions, marker-blind)
        self._profiles: dict[str, _FnWrites] = {}
        #: durable write sites (direct + delegated), marker-matched
        self.sites: list[WriteSite] = []
        #: (path, line) of every HSL027-checked site — check.py drops
        #: HSL021 findings on these so each site reports once
        self.claimed_sites: set[tuple[str, int]] = set()
        #: durability domain: qname -> witness chain down to a writer
        self.domain_fns: dict[str, tuple[str, ...]] = {}
        #: replay closure: qname -> chain from its replay root
        self.replay_fns: dict[str, tuple[str, ...]] = {}
        self.dura_calls_total = 0
        self.dura_calls_unresolved = 0
        self._delegation_memo: dict[str, tuple[tuple[str, ...] | None,
                                               tuple[str, ...] | None]] = {}

        if self.roots is not None:
            self._build_profiles()
            self._find_sites()
            self._build_domain()
        self._window_proofs = self._build_window_proofs()
        if self.replay_roots is not None:
            self._build_replay_closure()
        self._findings: list[Finding] | None = None

    # -- write-site detection --------------------------------------------------

    def _build_profiles(self) -> None:
        for q, fn in self.program.functions.items():
            prof = _FnWrites()
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                dotted = _dotted(node.func)
                tail = dotted.split(".")[-1]
                if tail in _FSYNC_TAILS:
                    prof.fsync_lines.append(node.lineno)
                elif tail in _PUBLISH_TAILS:
                    prof.publish.append((tail, node.lineno))
                elif self._is_raw_write(node, dotted, tail):
                    prof.raw_lines.append(node.lineno)
            if prof.writes or prof.fsync_lines:
                self._profiles[q] = prof

    @staticmethod
    def _is_raw_write(node: ast.Call, dotted: str, tail: str) -> bool:
        if tail in ("write_text", "write_bytes"):
            return True
        if tail != "open":
            return False
        if dotted.startswith("os"):
            # os.open flags ride in the source text; O_EXCL claims are
            # HSL021's (lease protocol), not bare durable writes.
            return False
        mode = ProcessDomains._open_mode(node)
        return mode is not None and any(c in mode for c in "wax+")

    def _binds(self, mod: ModuleInfo, fn: FunctionInfo) -> dict[str, str]:
        """Local name -> lowered source text of its first binding
        (single-name and tuple-unpack assigns: ``fd, tmp = mkstemp(..)``
        binds BOTH names to the mkstemp call text)."""
        binds: dict[str, str] = {}
        for sub in ast.walk(fn.node):
            if not isinstance(sub, ast.Assign) or len(sub.targets) != 1:
                continue
            tgt = sub.targets[0]
            names: list[str] = []
            if isinstance(tgt, ast.Name):
                names = [tgt.id]
            elif isinstance(tgt, ast.Tuple):
                names = [e.id for e in tgt.elts if isinstance(e, ast.Name)]
            if not names:
                continue
            txt = _seg(mod, sub.value).lower()
            for n in names:
                binds.setdefault(n, txt)
        return binds

    def _self_attr_text(self, fn: FunctionInfo, attr: str, depth: int = 2) -> str:
        """Lowered source text of ``self.<attr>``: the return expression
        of an accessor method/property, or the ``__init__`` binding —
        how ``write_json(self.control_path, ...)`` learns it writes
        under ``_ingest`` (one level of further self.* references is
        chased so ``control_path -> _state_dir`` resolves too)."""
        if depth <= 0 or fn.cls is None:
            return ""
        cls = self.program.classes.get(f"{fn.module}.{fn.cls}")
        if cls is None:
            return ""
        mod = self.program.modules.get(fn.module)
        if mod is None:
            return ""
        out = ""
        m = cls.methods.get(attr)
        if m is not None:
            for sub in ast.walk(m.node):
                if isinstance(sub, ast.Return) and sub.value is not None:
                    out += " " + _seg(mod, sub.value).lower()
        init = cls.methods.get("__init__")
        if init is not None:
            for sub in ast.walk(init.node):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    tgt = sub.targets[0]
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and tgt.attr == attr
                    ):
                        out += " " + _seg(mod, sub.value).lower()
        for ref in set(_SELF_REF_RE.findall(out)):
            if ref != attr:
                out += self._self_attr_text(fn, ref, depth - 1)
        return out

    def _widen(self, mod: ModuleInfo, fn: FunctionInfo, node: ast.Call,
               binds: dict[str, str], args: int = 1) -> str:
        seg = _seg(mod, node).lower()
        candidates: list[ast.expr] = list(node.args[:args])
        if isinstance(node.func, ast.Attribute):
            candidates.append(node.func.value)
        for expr in candidates:
            for name in ast.walk(expr):
                if isinstance(name, ast.Name) and name.id in binds:
                    seg += " " + binds[name.id]
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
            ):
                seg += self._self_attr_text(fn, expr.attr)
        # One more hop: a bind like `p = self.log_dir / str(id)` names
        # the root only through the attribute's __init__ binding
        # (`self.log_dir = self.index_path / HYPERSPACE_LOG_DIR`).
        for ref in set(_SELF_REF_RE.findall(seg)):
            seg += self._self_attr_text(fn, ref, depth=1)
        return seg

    def _marker(self, seg: str) -> str | None:
        for marker in self.roots or ():
            if marker.lower() in seg:
                return marker
        return None

    def _find_sites(self) -> None:
        prog, cg = self.program, self.callgraph
        for q in sorted(prog.functions):
            fn = prog.functions[q]
            mod = prog.modules[fn.module]
            if mod.path.endswith("faults.py"):
                continue  # the injection harness corrupts files BY DESIGN
            binds = self._binds(mod, fn)
            is_reaper = ProcessDomains._is_reaper(fn)
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                dotted = _dotted(node.func)
                tail = dotted.split(".")[-1]
                if tail in _FSYNC_TAILS:
                    continue
                if tail in _PUBLISH_TAILS:
                    if is_reaper and tail in ("rename", "unlink"):
                        continue  # lease clear, not a durable publish
                    seg = self._widen(mod, fn, node, binds, args=2)
                    if any(t in seg for t in _TOMBSTONE_MARKERS):
                        continue  # quarantine/tombstone move, not a publish
                    marker = self._marker(seg)
                    if marker is None:
                        continue
                    prof = self._profiles.get(q, _FnWrites())
                    ok = any(f < node.lineno for f in prof.fsync_lines)
                    self.sites.append(WriteSite(
                        fn=q, line=node.lineno, kind="publish", root=marker,
                        seg=seg, ok=ok,
                    ))
                elif self._is_raw_write(node, dotted, tail):
                    seg = self._widen(mod, fn, node, binds)
                    marker = self._marker(seg)
                    if marker is None:
                        continue
                    prof = self._profiles.get(q, _FnWrites())
                    self.sites.append(WriteSite(
                        fn=q, line=node.lineno, kind="raw", root=marker,
                        seg=seg, ok=prof.proven,
                    ))
                else:
                    target = cg.resolve_call(fn, dotted) if dotted else None
                    if target is None or target not in prog.functions:
                        continue
                    seg = self._widen(mod, fn, node, binds)
                    marker = self._marker(seg)
                    if marker is None:
                        continue
                    writers, proven = self._delegation(target)
                    if writers is None:
                        continue  # the callee closure never writes
                    self.sites.append(WriteSite(
                        fn=q, line=node.lineno, kind="delegated", root=marker,
                        seg=seg, ok=proven is not None, target=target,
                        chain=proven if proven is not None else writers,
                    ))
        for s in self.sites:
            mod = prog.modules[prog.functions[s.fn].module]
            self.claimed_sites.add((mod.path, s.line))

    def _exempt_writer(self, q: str) -> bool:
        """Writers whose writes are not durable publishes BY DESIGN:
        the fault-injection harness (``_mangle_file`` corrupts files on
        purpose — that IS the torn write being simulated) and TTL
        reapers (their rename/unlink is a lease CLEAR, proven by
        HSL021's reap check, not a data publish)."""
        fn = self.program.functions.get(q)
        if fn is None:
            return True
        mod = self.program.modules.get(fn.module)
        if mod is not None and mod.path.endswith("faults.py"):
            return True
        return ProcessDomains._is_reaper(fn)

    def _delegation(self, start: str) -> tuple[tuple[str, ...] | None,
                                               tuple[str, ...] | None]:
        """Chase a delegated write through resolved calls AND
        function-valued call arguments (``retry.retry_call(
        _overwrite_json, path, data)`` passes the writer as data).
        Returns (chain-to-some-writer | None, chain-to-proven-writer |
        None) — (None, None) means the closure never writes."""
        if start in self._delegation_memo:
            return self._delegation_memo[start]
        prog, cg = self.program, self.callgraph
        writer_chain: tuple[str, ...] | None = None
        proven_chain: tuple[str, ...] | None = None
        visited: set[str] = set()
        stack: list[tuple[str, tuple[str, ...]]] = [(start, (start,))]
        while stack:
            q, chain = stack.pop()
            if q in visited:
                continue
            visited.add(q)
            fn = prog.functions.get(q)
            if fn is None:
                continue
            prof = self._profiles.get(q)
            if prof is not None and prof.writes and not self._exempt_writer(q):
                if writer_chain is None or len(chain) < len(writer_chain):
                    writer_chain = chain
                if prof.proven and (
                    proven_chain is None or len(chain) < len(proven_chain)
                ):
                    proven_chain = chain
            nexts: set[str] = set()
            for call in fn.calls:
                got = cg.resolve_call(fn, call.raw)
                if got is not None:
                    nexts.update(self._dispatch(got))
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                for arg in node.args:
                    if not isinstance(arg, (ast.Name, ast.Attribute)):
                        continue
                    raw = _dotted(arg)
                    got = cg.resolve_call(fn, raw) if raw else None
                    if got is not None and got in prog.functions:
                        nexts.add(got)
            for t in sorted(nexts):
                if t not in visited:
                    stack.append((t, (*chain, t)))
        self._delegation_memo[start] = (writer_chain, proven_chain)
        return writer_chain, proven_chain

    # -- the durability domain (reverse closure of the writers) ----------------

    def _dispatch(self, callee: str) -> tuple[str, ...]:
        if self.raises is not None:
            return self.raises.dispatch_targets(callee)
        return (callee,)

    def _build_domain(self) -> None:
        prog, cg = self.program, self.callgraph
        radj: dict[str, set[str]] = {}
        for e in cg.edges:
            for t in self._dispatch(e.callee):
                radj.setdefault(t, set()).add(e.caller)
        stack: list[str] = []
        for s in self.sites:
            if s.fn not in self.domain_fns:
                self.domain_fns[s.fn] = (s.fn,)
                stack.append(s.fn)
        while stack:
            q = stack.pop()
            for caller in sorted(radj.get(q, ())):
                if caller not in self.domain_fns:
                    self.domain_fns[caller] = (caller, *self.domain_fns[q])
                    stack.append(caller)
        # Blind-spot accounting over the domain (the tracedomain ratio
        # contract): unresolved calls made BY domain functions weaken
        # both the delegation proofs and the replay closure.
        unresolved_by: dict[str, int] = {}
        for caller, _raw, _line in cg.unresolved:
            unresolved_by[caller] = unresolved_by.get(caller, 0) + 1
        for q in self.domain_fns:
            fn = prog.functions.get(q)
            if fn is None:
                continue
            self.dura_calls_total += len(fn.calls)
            self.dura_calls_unresolved += unresolved_by.get(q, 0)

    def unresolved_ratio(self) -> float:
        if not self.dura_calls_total:
            return 0.0
        return round(self.dura_calls_unresolved / self.dura_calls_total, 4)

    # -- HSL027: atomic-publish completeness -----------------------------------

    def atomic_publish_findings(self) -> list[Finding]:
        out: list[Finding] = []
        prog = self.program
        direct_flagged: set[str] = set()
        for s in self.sites:
            if s.ok or s.kind == "delegated":
                continue
            fn = prog.functions[s.fn]
            mod = prog.modules[fn.module]
            if _suppressed(mod, s.line, ATOMIC_PUBLISH):
                continue
            direct_flagged.add(s.fn)
            if s.kind == "publish":
                msg = (
                    f"durable publish under the {s.root!r} root in {s.fn} has "
                    f"no fsync before the rename — the new name can be durable "
                    f"before its bytes are, so a crash surfaces a zero-length "
                    f"or torn file; fsync the payload (and the directory) "
                    f"first (file_utils._overwrite_json is the idiom)"
                )
            else:
                msg = (
                    f"bare durable write under the {s.root!r} root in {s.fn} — "
                    f"a crash mid-write leaves a torn file at the final path; "
                    f"reach the mkstemp + fsync + os.replace idiom or delegate "
                    f"to file_utils.write_json (atomic-publish completeness, "
                    f"docs/torch/static_analysis.md)"
                )
            out.append(Finding(
                mod.path, s.line, 0, ATOMIC_PUBLISH, msg,
                witness_paths=(mod.path,),
            ))
        for s in self.sites:
            if s.kind != "delegated" or s.ok:
                continue
            # The writer itself was already reported (or suppressed)
            # at its own site when it matched a root directly.
            if any(w in direct_flagged for w in s.chain):
                continue
            if any(
                d.fn in s.chain and d.kind != "delegated" and not d.ok
                for d in self.sites
            ):
                continue
            fn = prog.functions[s.fn]
            mod = prog.modules[fn.module]
            if _suppressed(mod, s.line, ATOMIC_PUBLISH):
                continue
            chain = " -> ".join((s.fn, *s.chain))
            witness = tuple(dict.fromkeys(
                prog.modules[prog.functions[q].module].path
                for q in (s.fn, *s.chain) if q in prog.functions
            ))
            out.append(Finding(
                mod.path, s.line, 0, ATOMIC_PUBLISH,
                f"durable write under the {s.root!r} root delegates through "
                f"{chain} but no function on the chain proves "
                f"fsync-before-publish — the delegation target writes the "
                f"final path bare; route it through the mkstemp + fsync + "
                f"os.replace idiom (file_utils.write_json)",
                witness_paths=witness,
            ))
        return out

    # -- HSL028: torn-window ordering ------------------------------------------

    def _build_window_proofs(self) -> dict[str, dict]:
        proofs: dict[str, dict] = {}
        prog = self.program
        for name in sorted(self.windows or ()):
            spec = self.windows[name]
            if len(spec) < 4:
                continue
            qname, first_pat, second_pat, point = spec[0], spec[1], spec[2], spec[3]
            fn = prog.functions.get(qname)
            proof = {
                "fn": qname, "live": fn is not None,
                "first": {"pattern": first_pat, "lines": []},
                "second": {"pattern": second_pat, "lines": []},
                "point": {"name": point, "line": None},
                "ordered": False, "proven": False,
            }
            proofs[name] = proof
            if fn is None:
                continue
            mod = prog.modules[fn.module]
            first_lines: list[int] = []
            second_lines: list[int] = []
            for sub in ast.walk(fn.node):
                if isinstance(sub, ast.Call):
                    seg = _seg(mod, sub).lower()
                    # Only the call head: a match inside an argument
                    # (e.g. the second write passed a value derived
                    # from the first) must not move the window edge.
                    head = seg.split("(", 1)[0]
                    if first_pat.lower() in head or (
                        "." in first_pat and first_pat.lower() in seg
                    ):
                        first_lines.append(sub.lineno)
                    if second_pat.lower() in head:
                        second_lines.append(sub.lineno)
                elif isinstance(sub, (ast.Assign, ast.AugAssign)):
                    targets = (
                        sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                    )
                    for tgt in targets:
                        seg = _seg(mod, tgt).lower()
                        if second_pat.lower() in seg:
                            second_lines.append(sub.lineno)
                        if first_pat.lower() in seg:
                            first_lines.append(sub.lineno)
            proof["first"]["lines"] = sorted(set(first_lines))
            proof["second"]["lines"] = sorted(set(second_lines))
            if not first_lines or not second_lines:
                continue
            lo, hi = max(first_lines), min(second_lines)
            proof["ordered"] = lo < hi
            for pname, pline, pkind in fn.fault_refs:
                if pkind == "point" and pname == point and lo < pline < hi:
                    proof["point"]["line"] = pline
                    break
            proof["proven"] = bool(
                proof["ordered"] and proof["point"]["line"] is not None
                and (self.known_points is None or not self.known_points
                     or point in self.known_points)
            )
        return proofs

    def torn_window_findings(self) -> list[Finding]:
        out: list[Finding] = []
        prog = self.program
        for name in sorted(self._window_proofs):
            proof = self._window_proofs[name]
            qname = proof["fn"]
            spec = self.windows[name]
            point = spec[3]
            if not proof["live"]:
                if not any(qname.startswith(m + ".") for m in prog.modules):
                    continue  # scanning a subset — out of scope
                out.append(Finding(
                    next(iter(prog.modules.values())).path, 0, 0, TORN_WINDOW,
                    f"stale TORN_WINDOWS entry: {name!r} names {qname} which "
                    f"is no function in the analyzed program — fix the qname "
                    f"or delete the window",
                ))
                continue
            fn = prog.functions[qname]
            mod = prog.modules[fn.module]
            if _suppressed(mod, fn.line, TORN_WINDOW):
                continue
            missing = []
            if not proof["first"]["lines"]:
                missing.append(
                    f"first write {proof['first']['pattern']!r} matches no "
                    f"call/assignment in {qname}")
            if not proof["second"]["lines"]:
                missing.append(
                    f"second write {proof['second']['pattern']!r} matches no "
                    f"call/assignment in {qname}")
            if proof["first"]["lines"] and proof["second"]["lines"] \
                    and not proof["ordered"]:
                missing.append(
                    f"the two writes are not statically ordered (a "
                    f"{proof['first']['pattern']!r} at line "
                    f"{max(proof['first']['lines'])} follows a "
                    f"{proof['second']['pattern']!r} at line "
                    f"{min(proof['second']['lines'])})")
            if proof["ordered"] and proof["point"]["line"] is None:
                missing.append(
                    f"no armed faults.fault_point({point!r}) strictly inside "
                    f"the window — the crash sweep cannot exercise the torn "
                    f"state")
            if self.known_points and point not in self.known_points:
                missing.append(
                    f"in-window point {point!r} is not declared in "
                    f"faults.KNOWN_POINTS")
            if missing:
                out.append(Finding(
                    mod.path, fn.line, 0, TORN_WINDOW,
                    f"torn window {name!r} ({spec[4] if len(spec) > 4 else ''})"
                    f" is unproven: " + "; ".join(missing) +
                    " (torn-window ordering, docs/torch/static_analysis.md)",
                    witness_paths=(mod.path,),
                ))
        return out

    # -- HSL029: replay idempotence --------------------------------------------

    def _build_replay_closure(self) -> None:
        prog, cg = self.program, self.callgraph
        stack: list[str] = []
        for q in sorted(self.replay_roots or ()):
            if q in prog.functions and q not in self.replay_fns:
                self.replay_fns[q] = (q,)
                stack.append(q)
        while stack:
            q = stack.pop()
            for e in cg.out.get(q, []):
                for t in self._dispatch(e.callee):
                    if t in prog.functions and t not in self.replay_fns:
                        self.replay_fns[t] = (*self.replay_fns[q], t)
                        stack.append(t)

    def replay_findings(self) -> list[Finding]:
        out: list[Finding] = []
        prog = self.program
        for q, why in sorted((self.replay_roots or {}).items()):
            if q in prog.functions:
                continue
            if not any(q.startswith(m + ".") for m in prog.modules):
                continue
            out.append(Finding(
                next(iter(prog.modules.values())).path, 0, 0, REPLAY_IDEMPOTENCE,
                f"stale REPLAY_ROOTS entry: {q!r} names no function in the "
                f"analyzed program — fix the qname or delete the entry",
            ))
        for s in self.sites:
            chain = self.replay_fns.get(s.fn)
            if chain is None:
                continue
            atom = next((a for a in _NONDETERMINISTIC if a in s.seg), None)
            if atom is None:
                continue
            fn = prog.functions[s.fn]
            mod = prog.modules[fn.module]
            if _suppressed(mod, s.line, REPLAY_IDEMPOTENCE):
                continue
            witness = tuple(dict.fromkeys(
                prog.modules[prog.functions[c].module].path
                for c in chain if c in prog.functions
            ))
            out.append(Finding(
                mod.path, s.line, 0, REPLAY_IDEMPOTENCE,
                f"durable write on the replay path "
                f"{' -> '.join(chain)} derives its file name from "
                f"{atom!r} — a recovery/re-poll/takeover replay would write a "
                f"DIFFERENT path and orphan the first; derive the name from "
                f"cursor/log-id/generation values so the retry rewrites the "
                f"same file (replay idempotence, docs/torch/static_analysis.md)",
                witness_paths=witness,
            ))
        return out

    # -- HSL030: snapshot-stamp discipline -------------------------------------

    def _snapshot_param(self, fn: FunctionInfo) -> str | None:
        args = fn.node.args
        for a in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        ):
            if a.arg in _SNAPSHOT_PARAMS:
                return a.arg
        return None

    @staticmethod
    def _default_fill_guarded(fn: FunctionInfo, mod: ModuleInfo) -> set[int]:
        """Node ids inside a conditional whose test is ``<own-param> is
        None`` — the default-fill override-point idiom (``stamp =
        live() if stamp is None else stamp``): the live read only fills
        an ABSENT argument, and a pinned caller passes the
        snapshot-derived value instead (run_query does exactly this),
        so the fallback is the sanctioned live context by construction."""
        args = fn.node.args
        params = {
            a.arg for a in (
                list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
            )
        }
        guarded: set[int] = set()
        for sub in ast.walk(fn.node):
            if not isinstance(sub, (ast.If, ast.IfExp)):
                continue
            test_seg = _seg(mod, sub.test)
            if any(
                re.search(rf"\b{re.escape(p)}\s+is\s+(not\s+)?None\b", test_seg)
                for p in params
            ):
                for b in ast.walk(sub):
                    guarded.add(id(b))
        return guarded

    def snapshot_findings(self) -> list[Finding]:
        out: list[Finding] = []
        prog, cg = self.program, self.callgraph
        carriers = {
            q: p for q in sorted(prog.functions)
            if (p := self._snapshot_param(prog.functions[q])) is not None
        }
        self._carriers = sorted(carriers)

        def banned_what(sub: ast.AST) -> str | None:
            if isinstance(sub, ast.Call):
                tail = _dotted(sub.func).split(".")[-1]
                if tail in _LIVE_READ_TAILS:
                    return f"{tail}() live version read"
            elif isinstance(sub, ast.Attribute) and sub.attr == _LIVE_READ_ATTR:
                return f".{_LIVE_READ_ATTR} live version read"
            return None

        # Per-function digest, carrier-independent — computed ONCE and
        # shared by every carrier's closure walk: (unguarded banned
        # reads, unguarded resolved outgoing calls).
        digest: dict[str, tuple[list[tuple[int, str]], tuple[str, ...]]] = {}

        def fn_digest(cq: str) -> tuple[list[tuple[int, str]], tuple[str, ...]]:
            got = digest.get(cq)
            if got is not None:
                return got
            cfn = prog.functions[cq]
            cmod = prog.modules[cfn.module]
            cguard = self._default_fill_guarded(cfn, cmod)
            banned: list[tuple[int, str]] = []
            nexts: list[str] = []
            for sub in ast.walk(cfn.node):
                if id(sub) in cguard:
                    continue
                what = banned_what(sub)
                if what is not None:
                    banned.append((sub.lineno, what))
                    continue
                if isinstance(sub, ast.Call):
                    raw = _dotted(sub.func)
                    target = cg.resolve_call(cfn, raw) if raw else None
                    if target is None:
                        continue
                    for t in self._dispatch(target):
                        if t in prog.functions:
                            nexts.append(t)
            got = (banned, tuple(dict.fromkeys(nexts)))
            digest[cq] = got
            return got

        for q, param in sorted(carriers.items()):
            fn = prog.functions[q]
            mod = prog.modules[fn.module]
            guarded: set[int] = self._default_fill_guarded(fn, mod)
            for sub in ast.walk(fn.node):
                if isinstance(sub, (ast.If, ast.IfExp)):
                    test_seg = _seg(mod, sub.test)
                    if param in test_seg:
                        # A conditional dispatching on the snapshot
                        # parameter IS the sanctioned pinned-vs-live
                        # split — both branches are deliberate.
                        for b in ast.walk(sub):
                            guarded.add(id(b))
            calls_to_follow: list[tuple[str, int]] = []
            for sub in ast.walk(fn.node):
                if id(sub) in guarded:
                    continue
                what = banned_what(sub)
                if what is not None:
                    if not _suppressed(mod, sub.lineno, SNAPSHOT_STAMP):
                        out.append(Finding(
                            mod.path, sub.lineno, 0, SNAPSHOT_STAMP,
                            f"{what} inside the pinned-snapshot context of "
                            f"{q} — code reachable under run(plan, snapshot=) "
                            f"must key on the snapshot stamp, never the live "
                            f"version vector, or a pinned reader silently "
                            f"reads past its pin (snapshot-stamp discipline, "
                            f"docs/torch/static_analysis.md)",
                            witness_paths=(mod.path,),
                        ))
                    continue
                if isinstance(sub, ast.Call):
                    raw = _dotted(sub.func)
                    got = cg.resolve_call(fn, raw) if raw else None
                    if (
                        got is not None
                        and got in prog.functions
                        and got not in carriers
                    ):
                        calls_to_follow.append((got, sub.lineno))
            # Unguarded closure: a live read two calls down is the same
            # bug — follow resolved non-carrier callees with a witness
            # chain (carriers prune: they are checked on their own).
            visited: set[str] = set(carriers)
            stack = [
                (callee, (q, callee)) for callee, _ in sorted(set(calls_to_follow))
            ]
            while stack:
                cq, chain = stack.pop()
                if cq in visited:
                    continue
                visited.add(cq)
                cfn = prog.functions.get(cq)
                if cfn is None:
                    continue
                cmod = prog.modules[cfn.module]
                banned, nexts = fn_digest(cq)
                for lineno, what in banned:
                    if _suppressed(cmod, lineno, SNAPSHOT_STAMP):
                        continue
                    witness = tuple(dict.fromkeys(
                        prog.modules[prog.functions[c].module].path
                        for c in chain if c in prog.functions
                    ))
                    out.append(Finding(
                        cmod.path, lineno, 0, SNAPSHOT_STAMP,
                        f"{what} reachable inside the pinned-snapshot "
                        f"context of {q} (via {' -> '.join(chain)}) — key "
                        f"on the snapshot stamp instead (snapshot-stamp "
                        f"discipline, docs/torch/static_analysis.md)",
                        witness_paths=witness,
                    ))
                for t in nexts:
                    if t not in visited:
                        stack.append((t, (*chain, t)))
        return out

    # -- findings --------------------------------------------------------------

    def findings(self) -> list[Finding]:
        if self._findings is None:
            out: list[Finding] = []
            if self.roots is not None:
                out += self.atomic_publish_findings()
            if self.windows is not None:
                out += self.torn_window_findings()
            if self.roots is not None and self.replay_roots is not None:
                out += self.replay_findings()
            out += self.snapshot_findings()
            self._findings = out
        return self._findings

    def to_json(self) -> dict:
        self.findings()  # materialize the carrier list
        roots_out: dict[str, dict] = {}
        for marker in sorted(self.roots or ()):
            roots_out[marker] = {
                "why": (self.roots or {}).get(marker, ""),
                "sites": [
                    {
                        "fn": s.fn, "line": s.line, "kind": s.kind,
                        "ok": s.ok,
                        **({"via": list(s.chain)} if s.chain else {}),
                    }
                    for s in sorted(
                        self.sites, key=lambda s: (s.fn, s.line)
                    ) if s.root == marker
                ],
            }
        return {
            "roots": roots_out,
            "domain_functions": {
                q: list(chain) for q, chain in sorted(self.domain_fns.items())
            },
            "windows": self._window_proofs,
            "replay": {
                q: {
                    "why": why,
                    "closure": sum(
                        1 for chain in self.replay_fns.values()
                        if chain[0] == q
                    ),
                    "sites": sorted(
                        {(s.fn, s.line) for s in self.sites
                         if self.replay_fns.get(s.fn, (None,))[0] == q},
                    ),
                }
                for q, why in sorted((self.replay_roots or {}).items())
            },
            "snapshot_carriers": list(getattr(self, "_carriers", [])),
            "unresolved": {
                "total": self.dura_calls_total,
                "unresolved": self.dura_calls_unresolved,
                "ratio": self.unresolved_ratio(),
            },
        }
