"""Process-domain analysis: which code runs in WHICH process (HSL019-022).

The system is a multi-process installation — a fleet supervisor
spawning serving workers (serve/fleet/supervisor.py),
a spawn-context task pool for the scale-out build
(parallel/procpool.py), a spill-file exchange between build workers
(execution/build_exchange.py), and cross-process file leases
(serve/fleet/lease.py), and the ingest daemon's process worker. The
invariants that make those paths correct are conventions: workers import
nothing heavy and touch no card at module load, only paths and
primitives cross the process boundary, shared files
publish atomically under leases, and fault rules / trace roots ship
across the boundary. This module turns the conventions into checked
facts, on top of one new piece of infrastructure:

- **The spawn-domain inference.** :data:`SPAWN_ENTRY_POINTS` declares
  every function that runs FIRST inside a spawned worker process (the
  registry is AST-extracted from any scanned module, exactly like
  ``exceptions.ERROR_CONTRACTS`` — fixture packages declare their own).
  Each entry carries a *kind*:

  ========== =========================================================
  ``task``         a carrier shim with a result channel (procpool's
                   ``_task_entry``): must install shipped fault state
                   and its module must merge observed points + adopt
                   trace roots back (HSL022)
  ``task_body``    a task payload dispatched through a carrier
                   (``p1_shard``/``p2_owner``): seeds the call-graph
                   closure — everything it can reach runs in a worker
  ``service``      a long-lived worker-main shim (the fleet
                   supervisor's ``_worker_entry``): must install
                   shipped fault state; telemetry flows through the
                   worker's own health plane, so no merge-back is
                   required and the call graph is NOT followed (the
                   service body boots the full engine on purpose)
  ``service_body`` a service worker main (``_fleet_worker``): checked
                   for module-load purity only — the engine it boots
                   lives behind deferred imports by design
  ========== =========================================================

  The *task domain* is the dispatch-augmented call-graph closure of the
  task/task_body entries; the *domain module set* is every module
  hosting a domain function (any kind) closed over the **module-level
  import graph** (imports inside function bodies — the deferred-import
  idiom — are runtime edges, not load-time edges, and stay out of it;
  ``if TYPE_CHECKING:`` blocks never execute and are skipped).

- **HSL019 spawn-import purity.** No module in the domain module set
  may import jax, jaxlib or the JAX package (``hyperspace_tpu``) at
  module level, or touch CUDA there (a ``torch.cuda.*()`` call, a tensor
  made on or moved to ``cuda``, ``kernels.load`` / ``kernels.build``).
  A spawned worker imports the entry point's module (to unpickle the
  target) before running any task, so "a worker starts without JAX and
  without a CUDA context" is exactly this closure being clean — a proof
  with an entry-point → import-chain witness.
  :meth:`ProcessDomains.entry_modules` gives the closure of one entry
  point, which chip_smoke.py holds against a real worker's imports.
  Per-function deferred imports stay legal (the per-function import
  collection keeps them visible to the call graph).

- **HSL020 exchange-surface typing.** Values crossing a process
  boundary — ``TaskPool.submit`` task args, ``ProcessHost.spawn`` /
  ``FleetSupervisor``/``mp.Process`` target args, queue ``put``\\ s
  inside task-domain code, and the return expressions of task bodies —
  must come from the picklable vocabulary (paths, primitives, plain
  dict/list/tuple displays, ``faults.export_state()`` dicts, span
  ``to_json()`` dicts). A ColumnTable, a live ``Span``, a threading
  lock, an open file handle, a torch tensor, a ``torch.cuda.Stream`` or
  ``Event`` (a card's memory and handles do not pickle into another
  process), or a jax value provably flowing in is a finding, typed through the same local/attribute bindings the call
  graph resolves receivers with (under-approximate: an expression the
  engine cannot type passes — no false positives from ignorance).

- **HSL021 shared-file protocol.** In domain or fleet modules, a
  write-mode ``open()``/``write_text``/``write_bytes``/``os.open`` on
  a path naming the shared planes (lease/exchange/fleet/spill/evict)
  must sit in a function using the atomic publish idiom (``mkstemp`` +
  ``os.replace``/``os.link``) or claim via ``O_CREAT|O_EXCL`` — the
  generalization of HSL006 beyond the metadata plane. And every
  ``O_EXCL`` lease acquire must reach, through the call graph, a
  TTL-reap/release construct (a function comparing against a
  ttl/stale bound and unlinking/renaming the lease) — witness chains
  like HSL009/HSL018, so a crashed holder provably cannot wedge the
  fleet.

- **HSL022 cross-boundary continuity.** The registry contract in both
  directions (every statically detected spawn target must be declared,
  mirroring HSL012), the carrier plumbing per kind (above), and the
  worker telemetry vocabulary: every span/trace name a task-domain
  function can emit must be declared in ``obs.trace
  KNOWN_WORKER_SPANS``, every counter in ``stats.KNOWN_COUNTERS``,
  every event in ``obs.events.KNOWN_EVENTS`` — a worker can never
  silently lose injected faults or ship telemetry the coordinator's
  registries don't know.

Everything here is stdlib-``ast`` only and never imports analyzed code,
same as the rest of the engine (docs/torch/static_analysis.md).
"""

from __future__ import annotations

import ast
import dataclasses

from hyperspace_tpu_torch.analysis.callgraph import CallGraph
from hyperspace_tpu_torch.analysis.lint import Finding, _dotted
from hyperspace_tpu_torch.analysis.program import FunctionInfo, ModuleInfo, Program

SPAWN_IMPORT = "HSL019"
EXCHANGE_TYPING = "HSL020"
SHARED_FILE = "HSL021"
CONTINUITY = "HSL022"

#: The real registry: every function that runs FIRST in a spawned
#: worker process of this package (and of the scanned benchmark
#: surfaces). AST-extracted from this module when the package is
#: scanned — fixture packages and corpus files declare their own
#: ``SPAWN_ENTRY_POINTS`` literal the same way (the ERROR_CONTRACTS
#: pattern). Keep it a plain dict literal of string constants.
SPAWN_ENTRY_POINTS = {
    # TaskPool's worker entry: installs the coordinator's shipped fault
    # rules, runs the task body, posts exactly one result envelope.
    "hyperspace_tpu_torch.parallel.procpool._task_entry": (
        "task", "TaskPool worker shim: fault state in, observed points + trace root back"),
    # The scale-out build's task bodies (the pooled build submits them):
    # everything they can reach runs in a worker process.
    "hyperspace_tpu_torch.execution.build_exchange.p1_shard": (
        "task_body", "p1 shard worker: decode, hash/partition, spill"),
    "hyperspace_tpu_torch.execution.build_exchange.p2_owner": (
        "task_body", "p2 owner worker: spill read, key sort, bucket write"),
    # The fleet supervisor's worker-main shim: long-lived serving
    # workers whose telemetry flows through their own health plane.
    "hyperspace_tpu_torch.serve.fleet.supervisor._worker_entry": (
        "service", "fleet worker shim: fault state in; /metrics + /healthz carry telemetry"),
    # The continuous-ingestion daemon's optional process mode
    # (hyperspace.ingest.processWorker): the whole poll loop runs in a
    # spawn-context worker whose pause/stop controls ride atomic files
    # under <system_path>/_ingest, so a SIGKILL leaves at most a
    # transient log the next recover() converges.
    "hyperspace_tpu_torch.ingest.daemon._service_entry": (
        "service", "ingest worker shim: fault/journal state in; commits via the two-phase Action"),
    # Workers spawned by chip_smoke.py, which the default scan covers
    # (the counterparts of the JAX package's benchmark-harness entries).
    "chip_smoke._worker_startup": (
        "task_body", "the pooled build's start-up probe: worker imports, CUDA untouched"),
    "chip_smoke._worker_census": (
        "task_body", "phase 3s's census: the port modules a worker imported before its task"),
    "chip_smoke.fleet_member": (
        "service_body", "fleet member: session + QueryServer behind deferred imports"),
}

# Module-level imports that may never be reachable at worker start:
# jax, jaxlib and the JAX package. The port never loads them at all; a
# worker that did would pay the import before any task runs.
_BANNED_IMPORT_ROOTS = ("jax", "jaxlib", "hyperspace_tpu")

# Crossing-value deny list (HSL020): program classes that must never be
# pickled across the process boundary, by simple name. ColumnTable
# ships as spill FILES, Span as its to_json() dict; pools/hosts own OS
# resources; executors own threads.
_BANNED_CROSSING_CLASSES = {
    "ColumnTable", "Span", "TaskPool", "ProcessHost", "FleetSupervisor",
    "ThreadPoolExecutor",
}
# torch.<x>(...) calls whose result is plain data, not a device value.
_TORCH_NON_VALUES = {"device", "Size", "dtype", "get_default_dtype", "typename"}
# Constructors whose result is an open OS handle.
_OPEN_HANDLE_CTORS = {"open", "fdopen", "NamedTemporaryFile", "TemporaryFile", "mkstemp"}
# Call tails that CONVERT a value into the picklable vocabulary.
_OK_CONVERTERS = {
    "export_state", "to_json", "str", "int", "float", "bool", "list",
    "dict", "tuple", "set", "sorted", "repr", "len", "observed_points",
    "format_exc", "enabled", "snapshot",
}

# Shared-plane path markers (HSL021): expression text naming the
# cross-process file planes. Deliberately narrower than HSL006's
# metadata markers — spill parquet written through ParquetWriter is
# single-writer scratch behind the p1/p2 barrier and is not an open()
# call anyway, and "fleet_dir" (not bare "fleet") keeps single-writer
# artifacts like BENCH_FLEET.json out of the rule.
_SHARED_PATH_MARKERS = ("lease", "exchange", "fleet_dir", "spill", "evict", "reap", "entry_path")


def _suppressed(mod: ModuleInfo, line: int, rule: str) -> bool:
    lines = mod.lines
    text = lines[line - 1] if 0 < line <= len(lines) else ""
    if "# noqa" not in text:
        return False
    tail = text.split("# noqa", 1)[1]
    return not tail.strip().startswith(":") or rule in tail


# -- registry extraction -------------------------------------------------------

def declared_entry_points(program: Program) -> dict[str, tuple[str, str]]:
    """qname -> (kind, why), AST-extracted from every scanned module's
    top-level ``SPAWN_ENTRY_POINTS`` dict literal (the real registry
    lives in analysis/procdomain.py, which the default scan covers;
    fixture packages declare their own)."""
    out: dict[str, tuple[str, str]] = {}
    for mod in program.modules.values():
        for node in mod.tree.body:
            target = value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target, value = node.target, node.value
            if not (isinstance(target, ast.Name) and target.id == "SPAWN_ENTRY_POINTS"):
                continue
            if not isinstance(value, ast.Dict):
                continue
            for k, v in zip(value.keys, value.values):
                if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                    continue
                kind, why = "task_body", ""
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    kind = v.value
                elif isinstance(v, (ast.Tuple, ast.List)) and v.elts:
                    parts = [e.value for e in v.elts
                             if isinstance(e, ast.Constant) and isinstance(e.value, str)]
                    if parts:
                        kind = parts[0]
                        why = parts[1] if len(parts) > 1 else ""
                out[k.value] = (kind, why)
    return out


def _string_tuple_registry(program: Program, name: str) -> set[str] | None:
    """The union of every scanned module's top-level ``<name>`` tuple of
    string constants, or None when no module declares one (the check
    that reads it disarms — a corpus file scanned alone must not report
    every name undeclared)."""
    out: set[str] | None = None
    for mod in program.modules.values():
        for node in mod.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            tgt = node.targets[0]
            if not (isinstance(tgt, ast.Name) and tgt.id == name):
                continue
            if isinstance(node.value, (ast.Tuple, ast.List)):
                out = out or set()
                out.update(
                    e.value for e in node.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                )
    return out


def _known_events(program: Program) -> set[str] | None:
    """Keys of any scanned module's top-level ``KNOWN_EVENTS`` dict."""
    out: set[str] | None = None
    for mod in program.modules.values():
        for node in mod.tree.body:
            target = value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target, value = node.target, node.value
            if not (isinstance(target, ast.Name) and target.id == "KNOWN_EVENTS"):
                continue
            if isinstance(value, ast.Dict):
                out = out or set()
                out.update(
                    k.value for k in value.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)
                )
    return out


# -- module-level import graph -------------------------------------------------

def _is_type_checking_if(node: ast.If) -> bool:
    return any(
        isinstance(sub, (ast.Name, ast.Attribute))
        and (getattr(sub, "id", None) == "TYPE_CHECKING"
             or getattr(sub, "attr", None) == "TYPE_CHECKING")
        for sub in ast.walk(node.test)
    )


def _load_time(body, with_tests: bool = False):
    """The statements of `body` that EXECUTE at module load: top-level
    statements plus module-level ``if``/``try`` bodies and class bodies,
    excluding function bodies (deferred: runtime edges) and ``if
    TYPE_CHECKING:`` blocks (never executed). With `with_tests`, also the
    ``if`` tests and function decorators, which execute too."""
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if with_tests:
                yield from node.decorator_list
            continue
        if isinstance(node, ast.If):
            if not _is_type_checking_if(node):
                if with_tests:
                    yield node.test
                yield from _load_time(node.body, with_tests)
            yield from _load_time(node.orelse, with_tests)
            continue
        if isinstance(node, ast.Try):
            yield from _load_time(node.body, with_tests)
            for h in node.handlers:
                yield from _load_time(h.body, with_tests)
            yield from _load_time(node.orelse, with_tests)
            yield from _load_time(node.finalbody, with_tests)
            continue
        if isinstance(node, ast.ClassDef):
            yield from _load_time(node.body, with_tests)
            continue
        yield node


def module_level_imports(mod: ModuleInfo) -> list[tuple[str, int]]:
    """(dotted module target, line) for every import that EXECUTES at
    module load (:func:`_load_time`): deferred imports inside functions
    are runtime edges, and ``if TYPE_CHECKING:`` blocks never run."""
    out: list[tuple[str, int]] = []
    for node in _load_time(mod.tree.body):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.append((alias.name, node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                base = ".".join(
                    mod.name.split(".")[: -node.level]
                    + ([node.module] if node.module else [])
                )
            if base:
                out.append((base, node.lineno))
                # `from pkg import submod` imports pkg.submod too.
                for alias in node.names:
                    out.append((f"{base}.{alias.name}", node.lineno))
    return out


def module_level_cuda_touches(mod: ModuleInfo) -> list[tuple[int, str]]:
    """(line, what) for every CUDA touch that EXECUTES at module load: a
    ``torch.cuda.*()`` call, a tensor made on or moved to ``cuda``, or a
    kernel build/load (``kernels.load`` / ``kernels.build``), in what
    :func:`_load_time` executes; function and lambda bodies are deferred
    and stay out."""
    out: list[tuple[int, str]] = []

    def is_cuda_text(e: ast.AST) -> bool:
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            return e.value.startswith("cuda")
        if isinstance(e, ast.Call) and _dotted(e.func) in ("torch.device", "device") and e.args:
            return is_cuda_text(e.args[0])
        return False

    def resolved(dotted: str) -> str:
        head, _, rest = dotted.partition(".")
        target = mod.imports.get(head)
        if target is None:
            return dotted
        return f"{target}.{rest}" if rest else target

    def scan(node: ast.AST) -> None:
        stack = [node]
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.extend(ast.iter_child_nodes(sub))
            if not isinstance(sub, ast.Call):
                continue
            d = _dotted(sub.func)
            full = resolved(d) if d else ""
            tail = d.rsplit(".", 1)[-1] if d else getattr(sub.func, "attr", "")
            if full.startswith("torch.cuda."):
                out.append((sub.lineno, f"{d}() call"))
            elif any(kw.arg == "device" and is_cuda_text(kw.value) for kw in sub.keywords):
                out.append((sub.lineno, f"a tensor made on cuda ({d or tail}(...))"))
            elif tail == "cuda" and isinstance(sub.func, ast.Attribute) and not sub.args:
                out.append((sub.lineno, "a tensor moved to cuda (.cuda())"))
            elif tail == "to" and sub.args and is_cuda_text(sub.args[0]):
                out.append((sub.lineno, "a tensor moved to cuda (.to('cuda'))"))
            elif full.endswith(("kernels.load", "kernels.build")):
                out.append((sub.lineno, f"a kernel build or load ({d}())"))

    for node in _load_time(mod.tree.body, with_tests=True):
        scan(node)
    return out


def _banned_root(target: str) -> str | None:
    root = target.split(".")[0]
    return root if root in _BANNED_IMPORT_ROOTS else None


# -- the domain ----------------------------------------------------------------

@dataclasses.dataclass
class BoundarySite:
    """One place a value crosses a process boundary."""

    fn: str
    line: int
    kind: str  # submit | spawn | fleet_target | mp_process | put | return
    target: str | None = None  # resolved spawn-target qname, when any
    #: the AST expressions whose values actually cross
    crossing: list = dataclasses.field(default_factory=list)


class ProcessDomains:
    """Spawn-domain inference + the HSL019-022 rules over a Program."""

    def __init__(self, program: Program, callgraph: CallGraph, raises=None):
        self.program = program
        self.callgraph = callgraph
        self.raises = raises  # for dispatch-augmented closure (may-analysis)
        self.entry_points = declared_entry_points(program)
        #: entries that name a scanned function
        self.live_entries: dict[str, tuple[str, str]] = {
            q: kw for q, kw in self.entry_points.items() if q in program.functions
        }
        #: task-domain functions (call-graph closure) -> witness chain
        #: from the seeding entry point
        self.task_fns: dict[str, tuple[str, ...]] = {}
        #: every domain function (task closure + service shims/bodies)
        self.domain_fns: set[str] = set()
        #: domain modules -> ("entry"|"hosts"|importer module, line)
        self.domain_modules: dict[str, tuple[str, int]] = {}
        #: boundary crossings (HSL020 working set + report material)
        self.boundary_sites: list[BoundarySite] = []
        #: O_EXCL acquire sites -> reap witness chain or None
        self.lease_acquires: list[dict] = []
        self._build_closure()
        self._build_module_set()
        self._find_boundaries()

    # -- closure -----------------------------------------------------------
    def _dispatch(self, callee: str) -> tuple[str, ...]:
        if self.raises is not None:
            return self.raises.dispatch_targets(callee)
        return (callee,)

    def _build_closure(self) -> None:
        prog, cg = self.program, self.callgraph
        roots = [
            q for q, (kind, _) in sorted(self.live_entries.items())
            if kind in ("task", "task_body")
        ]
        stack: list[str] = []
        for r in roots:
            self.task_fns[r] = (r,)
            stack.append(r)
        while stack:
            q = stack.pop()
            fn = prog.functions.get(q)
            if fn is None:
                continue
            for call in fn.calls:
                callee = cg.resolve_call(fn, call.raw)
                if callee is None:
                    continue
                for t in self._dispatch(callee):
                    if t in prog.functions and t not in self.task_fns:
                        self.task_fns[t] = (*self.task_fns[q], t)
                        stack.append(t)
        self.domain_fns = set(self.task_fns)
        self.domain_fns.update(
            q for q, (kind, _) in self.live_entries.items()
            if kind in ("service", "service_body")
        )

    def _build_module_set(self) -> None:
        prog = self.program
        seeds: dict[str, tuple[str, int]] = {}
        for q in sorted(self.domain_fns):
            fn = prog.functions[q]
            seeds.setdefault(fn.module, ("hosts " + q, fn.line))
        # Close over the module-level import graph (program-internal
        # edges; external targets are leaves checked by HSL019).
        # Importing `a.b.c` also EXECUTES a/__init__ and a.b/__init__ —
        # the runtime-mirror test caught exactly this hole (a package
        # __init__ eagerly re-exporting a jax module made every worker
        # pay the import the leaf modules carefully deferred), so every
        # ancestor package joins the closure with its child as witness.
        self.domain_modules = dict(seeds)
        stack = list(seeds)

        def add(target: str, via: str, line: int) -> None:
            if target in prog.modules and target not in self.domain_modules:
                self.domain_modules[target] = (via, line)
                stack.append(target)
            parts = target.split(".")
            for i in range(1, len(parts)):
                anc = ".".join(parts[:i])
                if anc in prog.modules and anc not in self.domain_modules:
                    # the ancestor's package __init__ runs because the
                    # CHILD was imported — the child is the witness
                    self.domain_modules[anc] = (target, 0)
                    stack.append(anc)

        for m in list(seeds):
            add(m, seeds[m][0], seeds[m][1])
        while stack:
            m = stack.pop()
            mod = prog.modules.get(m)
            if mod is None:
                continue
            for target, line in module_level_imports(mod):
                add(target, m, line)

    def entry_modules(self, qname: str) -> set[str]:
        """The program modules a worker spawned at entry point `qname`
        imports before its task runs: the modules hosting the entry and
        (task kinds) its task closure, closed over the module-level
        import graph and package ancestors, as in
        :meth:`_build_module_set`."""
        prog = self.program
        if qname not in self.live_entries:
            return set()
        fns = {qname}
        if self.live_entries[qname][0] in ("task", "task_body"):
            fns |= {q for q, chain in self.task_fns.items() if chain[0] == qname}
        out: set[str] = set()
        stack = sorted({prog.functions[q].module for q in fns if q in prog.functions})

        def add(target: str) -> None:
            parts = target.split(".")
            for i in range(1, len(parts) + 1):
                m = ".".join(parts[:i])
                if m in prog.modules and m not in out:
                    out.add(m)
                    stack.append(m)

        for m in list(stack):
            add(m)
        while stack:
            mod = prog.modules.get(stack.pop())
            if mod is None:
                continue
            for target, _ in module_level_imports(mod):
                add(target)
        return out

    def _module_chain(self, m: str) -> list[str]:
        """Witness: the module-level import chain from a hosting module
        down to `m` (each step recorded at closure time)."""
        chain = [m]
        seen = {m}
        while True:
            via, _ = self.domain_modules.get(chain[-1], ("", 0))
            if not via or via.startswith("hosts ") or via in seen:
                break
            chain.append(via)
            seen.add(via)
        return list(reversed(chain))

    def _entry_for_module(self, m: str) -> str:
        """One entry point whose worker imports module `m` at start."""
        chain = self._module_chain(m)
        host = chain[0]
        via, _ = self.domain_modules.get(host, ("", 0))
        if via.startswith("hosts "):
            q = via[len("hosts "):]
            if q in self.task_fns:
                return self.task_fns[q][0]
            return q
        return host

    # -- boundary sites ----------------------------------------------------
    def _find_boundaries(self) -> None:
        prog, cg = self.program, self.callgraph
        for fn in sorted(prog.functions.values(), key=lambda f: (f.module, f.line)):
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                raw = _dotted(node.func)
                if not raw and isinstance(node.func, ast.Attribute):
                    base = node.func.value
                    if isinstance(base, ast.Call):
                        ctor = _dotted(base.func)
                        if ctor:
                            raw = f"{ctor}().{node.func.attr}"
                if not raw:
                    continue
                resolved = cg.resolve_call(fn, raw)
                tail2 = tuple(resolved.split(".")[-2:]) if resolved else ()
                site = None
                if tail2 == ("TaskPool", "submit"):
                    target = self._fn_ref(fn, node.args[1]) if len(node.args) >= 2 else None
                    site = BoundarySite(fn.qname, node.lineno, "submit", target)
                    site.crossing = list(node.args[2:]) + [kw.value for kw in node.keywords]
                elif tail2 == ("ProcessHost", "spawn"):
                    target = self._fn_ref(fn, node.args[1]) if len(node.args) >= 2 else None
                    site = BoundarySite(fn.qname, node.lineno, "spawn", target)
                    crossing = [a for a in node.args[2:]]
                    for kw in node.keywords:
                        if kw.arg == "args":
                            crossing.append(kw.value)
                    site.crossing = self._splat_tuples(crossing)
                elif raw.split(".")[-1] == "FleetSupervisor":
                    # Detected by ctor NAME: the supervisor is re-exported
                    # through the fleet package, which the deliberately
                    # under-approximate resolver does not chase for ctor
                    # expressions — and a missed fleet spawn would silently
                    # skip the whole domain proof for that worker.
                    target = self._fn_ref(fn, node.args[0]) if node.args else None
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target = self._fn_ref(fn, kw.value)
                    site = BoundarySite(fn.qname, node.lineno, "fleet_target", target)
                    site.crossing = self._splat_tuples(
                        [kw.value for kw in node.keywords if kw.arg == "args"]
                    )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "Process"
                    and any(kw.arg == "target" for kw in node.keywords)
                ):
                    target = next(
                        (self._fn_ref(fn, kw.value) for kw in node.keywords
                         if kw.arg == "target"), None,
                    )
                    site = BoundarySite(fn.qname, node.lineno, "mp_process", target)
                    site.crossing = self._splat_tuples(
                        [kw.value for kw in node.keywords if kw.arg == "args"]
                    )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "put"
                    and fn.qname in self.task_fns
                ):
                    site = BoundarySite(fn.qname, node.lineno, "put")
                    site.crossing = list(node.args)
                if site is not None:
                    self.boundary_sites.append(site)
            # Task bodies: their return values cross back through the
            # result queue.
            if fn.qname in self.task_fns and self._entry_kind(fn.qname) == "task_body":
                for node in self._own_returns(fn):
                    if node.value is None:
                        continue
                    site = BoundarySite(fn.qname, node.lineno, "return")
                    site.crossing = [node.value]
                    self.boundary_sites.append(site)

    def _entry_kind(self, qname: str) -> str | None:
        got = self.live_entries.get(qname)
        return got[0] if got else None

    @staticmethod
    def _own_returns(fn: FunctionInfo):
        """Return statements of `fn` itself (nested defs excluded)."""
        nested: set[int] = set()
        for sub in ast.walk(fn.node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) and sub is not fn.node:
                for inner in ast.walk(sub):
                    nested.add(id(inner))
        return [
            n for n in ast.walk(fn.node)
            if isinstance(n, ast.Return) and id(n) not in nested
        ]

    @staticmethod
    def _splat_tuples(exprs: list) -> list:
        out = []
        for e in exprs:
            if isinstance(e, (ast.Tuple, ast.List)):
                out.extend(e.elts)
            else:
                out.append(e)
        return out

    def _fn_ref(self, fn: FunctionInfo, expr: ast.expr) -> str | None:
        """The program-function qname a bare/dotted reference names (a
        spawn target passed BY REFERENCE, not called)."""
        raw = _dotted(expr)
        if not raw:
            return None
        got = self.callgraph.resolve_call(fn, raw)
        return got if got in self.program.functions else None

    # -- HSL019: spawn-import purity --------------------------------------
    def spawn_import_findings(self) -> list[Finding]:
        prog = self.program
        findings: list[Finding] = []
        seen: set[tuple[str, int, str]] = set()
        for m in sorted(self.domain_modules):
            mod = prog.modules.get(m)
            if mod is None:
                continue
            for target, line in module_level_imports(mod):
                root = _banned_root(target)
                if root is None or _suppressed(mod, line, SPAWN_IMPORT):
                    continue
                if (m, line, root) in seen:
                    continue  # `from jax import x, y` is one finding
                seen.add((m, line, root))
                chain = self._module_chain(m)
                entry = self._entry_for_module(m)
                via = " imports ".join(chain) if len(chain) > 1 else m
                witness = tuple(
                    prog.modules[c].path for c in chain if c in prog.modules
                )
                findings.append(Finding(
                    mod.path, line, 0, SPAWN_IMPORT,
                    f"module-level import of {target!r} is reachable at worker "
                    f"start from spawn entry point {entry} ({via}) — a spawned "
                    f"worker pays the {root} import before any task runs; defer "
                    f"it into the function that needs it (spawn-import purity, "
                    f"docs/torch/static_analysis.md)",
                    witness_paths=witness,
                ))
            for line, what in module_level_cuda_touches(mod):
                if _suppressed(mod, line, SPAWN_IMPORT):
                    continue
                chain = self._module_chain(m)
                entry = self._entry_for_module(m)
                via = " imports ".join(chain) if len(chain) > 1 else m
                findings.append(Finding(
                    mod.path, line, 0, SPAWN_IMPORT,
                    f"module-level CUDA touch ({what}) is reachable at worker "
                    f"start from spawn entry point {entry} ({via}) — the "
                    f"worker would make a CUDA context before its task asks "
                    f"for one; defer it into the function that needs it "
                    f"(spawn-import purity, docs/torch/static_analysis.md)",
                    witness_paths=tuple(
                        prog.modules[c].path for c in chain if c in prog.modules
                    ),
                ))
        return findings

    # -- HSL020: exchange-surface typing -----------------------------------
    def exchange_typing_findings(self) -> list[Finding]:
        prog = self.program
        findings: list[Finding] = []
        for site in self.boundary_sites:
            fn = prog.functions.get(site.fn)
            mod = prog.modules.get(fn.module) if fn is not None else None
            if fn is None or mod is None:
                continue
            for expr in getattr(site, "crossing", []):
                bad = self._crossing_violation(fn, expr)
                if bad is None:
                    continue
                line = getattr(expr, "lineno", site.line)
                if _suppressed(mod, line, EXCHANGE_TYPING):
                    continue
                witness = ()
                if site.fn in self.task_fns:
                    witness = tuple(
                        prog.modules[prog.functions[q].module].path
                        for q in self.task_fns[site.fn]
                        if q in prog.functions
                    )
                findings.append(Finding(
                    mod.path, line, 0, EXCHANGE_TYPING,
                    f"{bad} crosses the process boundary at {site.fn} "
                    f"({site.kind} site) — only paths, primitives, plain "
                    f"dict/list displays, faults.export_state() dicts and span "
                    f"to_json() dicts may cross (exchange-surface typing, "
                    f"docs/torch/static_analysis.md); ship a path or a plain-data "
                    f"snapshot instead",
                    witness_paths=witness,
                ))
        return findings

    def _crossing_violation(self, fn: FunctionInfo, expr: ast.expr) -> str | None:
        """A description of the provably non-exchangeable value `expr`
        carries, or None when it is (or cannot be proven not to be) in
        the picklable vocabulary."""
        prog = self.program
        if isinstance(expr, (ast.Constant, ast.JoinedStr)):
            return None
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            for e in expr.elts:
                bad = self._crossing_violation(fn, e)
                if bad is not None:
                    return bad
            return None
        if isinstance(expr, ast.Dict):
            for e in (*expr.keys, *expr.values):
                if e is None:
                    continue
                bad = self._crossing_violation(fn, e)
                if bad is not None:
                    return bad
            return None
        if isinstance(expr, ast.Starred):
            return self._crossing_violation(fn, expr.value)
        if isinstance(expr, ast.Call):
            dotted = _dotted(expr.func)
            tail = dotted.split(".")[-1]
            if tail in _OK_CONVERTERS:
                return None
            return self._ctor_violation(fn, dotted)
        if isinstance(expr, ast.Name):
            bound = fn.local_types.get(expr.id)
            mod = prog.modules.get(fn.module)
            if mod is not None and expr.id in mod.module_locks:
                return f"module lock {expr.id!r} (threading primitives do not pickle)"
            if bound is None:
                return None
            if bound.endswith("()"):
                return self._ctor_violation(fn, bound[:-2])
            if bound.startswith("self.") and fn.cls is not None:
                return self._attr_violation(fn, bound.split(".")[1])
            return None
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name) and base.id == "self" and fn.cls is not None:
                return self._attr_violation(fn, expr.attr)
            return None
        return None

    def _ctor_violation(self, fn: FunctionInfo, ctor: str) -> str | None:
        tail = ctor.split(".")[-1]
        root = ctor.split(".")[0]
        if tail in _OPEN_HANDLE_CTORS:
            return f"open file handle ({ctor}(...))"
        if root in ("jnp", "jax"):
            return f"jax value ({ctor}(...))"
        if root == "torch":
            if tail in ("Stream", "Event"):
                return f"torch.cuda.{tail} ({ctor}(...))"
            if ctor.count(".") == 1 and tail not in _TORCH_NON_VALUES:
                return f"torch tensor ({ctor}(...))"
        cls_q = self.program.class_of_ctor(fn.module, ctor)
        if cls_q is not None:
            simple = cls_q.split(".")[-1]
            if simple in _BANNED_CROSSING_CLASSES:
                return f"{simple} instance"
        elif tail in _BANNED_CROSSING_CLASSES:
            return f"{tail} instance"
        return None

    def _attr_violation(self, fn: FunctionInfo, attr: str) -> str | None:
        prog = self.program
        for cq in prog._mro(f"{fn.module}.{fn.cls}"):
            c = prog.classes.get(cq)
            if c is None:
                continue
            if attr in c.attr_locks:
                return f"threading {c.attr_locks[attr]} (self.{attr})"
            if attr in c.attr_types:
                ctor = c.attr_types[attr]
                got = self._ctor_violation(fn, ctor)
                if got is not None:
                    return got
                return None
        return None

    # -- HSL021: shared-file protocol --------------------------------------
    def _gated_modules(self) -> list[ModuleInfo]:
        out = []
        for m, mod in sorted(self.program.modules.items()):
            if m in self.domain_modules or ".fleet" in m or m.endswith("fleet"):
                out.append(mod)
        return out

    @staticmethod
    def _fn_uses_atomic_idiom(fn_node: ast.AST) -> bool:
        for sub in ast.walk(fn_node):
            if isinstance(sub, ast.Call):
                tail = _dotted(sub.func).split(".")[-1]
                if tail in ("replace", "link", "mkstemp", "rename"):
                    return True
        return False

    @staticmethod
    def _open_mode(node: ast.Call) -> str | None:
        mode = None
        if (
            len(node.args) >= 2
            and isinstance(node.args[1], ast.Constant)
            and isinstance(node.args[1].value, str)
        ):
            mode = node.args[1].value
        for kw in node.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                mode = kw.value.value
        return mode

    def shared_file_findings(self) -> list[Finding]:
        prog = self.program
        findings: list[Finding] = []
        for mod in self._gated_modules():
            if mod.path.endswith("file_utils.py"):
                # The sanctioned atomic-primitive module (HSL006's rule);
                # its O_EXCL lease still takes the reap check below.
                sanctioned_writes = True
            else:
                sanctioned_writes = False
            fns = list(mod.functions.values()) + [
                m for c in mod.classes.values() for m in c.methods.values()
            ]
            for fn in sorted(fns, key=lambda f: f.line):
                atomic_fn = self._fn_uses_atomic_idiom(fn.node)
                # Local path bindings: `path = exchange_dir / "x"` makes
                # a later `open(path, "w")` a shared-plane write even
                # though the call segment itself carries no marker.
                binds: dict[str, str] = {}
                for sub in ast.walk(fn.node):
                    if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                            and isinstance(sub.targets[0], ast.Name):
                        txt = mod.segment(sub.value) or ""
                        binds.setdefault(sub.targets[0].id, txt.lower())
                for node in ast.walk(fn.node):
                    if not isinstance(node, ast.Call):
                        continue
                    dotted = _dotted(node.func)
                    tail = dotted.split(".")[-1]
                    seg = (mod.segment(node) or "").lower()
                    for arg in node.args[:1]:
                        if isinstance(arg, ast.Name) and arg.id in binds:
                            seg += " " + binds[arg.id]
                    if isinstance(node.func, ast.Attribute) \
                            and isinstance(node.func.value, ast.Name) \
                            and node.func.value.id in binds:
                        seg += " " + binds[node.func.value.id]
                    is_excl = tail == "open" and dotted.startswith("os") and "o_excl" in seg
                    if is_excl:
                        self._check_lease_acquire(findings, mod, fn, node)
                        continue
                    if sanctioned_writes or atomic_fn:
                        continue
                    is_write = False
                    if tail in ("write_text", "write_bytes"):
                        is_write = True
                    elif tail == "open" and not dotted.startswith("os"):
                        mode = self._open_mode(node)
                        is_write = mode is not None and any(c in mode for c in "wax+")
                    elif tail == "open" and dotted.startswith("os"):
                        is_write = "o_wronly" in seg or "o_rdwr" in seg
                    if not is_write:
                        continue
                    if not any(mk in seg for mk in _SHARED_PATH_MARKERS):
                        continue
                    if _suppressed(mod, node.lineno, SHARED_FILE):
                        continue
                    findings.append(Finding(
                        mod.path, node.lineno, 0, SHARED_FILE,
                        f"bare write on a shared exchange/fleet path in "
                        f"{fn.qname} — another process can observe a torn "
                        f"entry; publish atomically (tempfile.mkstemp + fsync "
                        f"+ os.replace, or file_utils.write_json) or claim "
                        f"with O_CREAT|O_EXCL (shared-file protocol, "
                        f"docs/torch/static_analysis.md)",
                        witness_paths=(mod.path,),
                    ))
        return findings

    def _check_lease_acquire(self, findings: list[Finding], mod: ModuleInfo,
                             fn: FunctionInfo, node: ast.Call) -> None:
        """An O_EXCL claim must reach (call graph, self included) a
        TTL-reap construct: a function comparing against a ttl/stale
        bound AND unlinking/renaming the lease — else a crashed holder
        wedges every later claimant forever."""
        prog, cg = self.program, self.callgraph
        candidates = {fn.qname} | cg.reachable(fn.qname)
        reap_via = None
        for q in sorted(candidates):
            f2 = prog.functions.get(q)
            if f2 is not None and self._is_reaper(f2):
                reap_via = cg.find_path(fn.qname, {q}) or [fn.qname, q]
                break
        self.lease_acquires.append({
            "fn": fn.qname, "line": node.lineno,
            "reap_via": list(reap_via) if reap_via else None,
        })
        if reap_via is None and not _suppressed(mod, node.lineno, SHARED_FILE):
            # The witness is the acquire's own reachable closure: the
            # reap this finding says is MISSING would live in one of
            # those files, so --changed keeps the finding when any
            # candidate module is edited.
            witness = tuple(dict.fromkeys(
                prog.modules[prog.functions[q].module].path
                for q in sorted(candidates) if q in prog.functions
            ))
            findings.append(Finding(
                mod.path, node.lineno, 0, SHARED_FILE,
                f"O_EXCL lease acquire in {fn.qname} has no reachable "
                f"TTL-reap/release path — a holder that dies here wedges "
                f"every later claimant forever; add a reap that judges the "
                f"creator-written epoch against a TTL and atomically clears "
                f"the lease (serve/fleet/lease.py is the pattern)",
                witness_paths=witness,
            ))

    @staticmethod
    def _is_reaper(fn: FunctionInfo) -> bool:
        has_ttl = False
        has_clear = False
        for sub in ast.walk(fn.node):
            if isinstance(sub, (ast.Name, ast.Attribute)):
                ident = (getattr(sub, "id", "") or getattr(sub, "attr", "")).lower()
                if "ttl" in ident or "stale" in ident:
                    has_ttl = True
            if isinstance(sub, ast.Call):
                tail = _dotted(sub.func).split(".")[-1]
                if tail in ("unlink", "rename"):
                    has_clear = True
        return has_ttl and has_clear

    # -- HSL022: cross-boundary continuity ---------------------------------
    def continuity_findings(self) -> list[Finding]:
        prog = self.program
        findings: list[Finding] = []
        # (a) registry contract, both directions (the HSL012 shape):
        # every detected spawn target declared; every declared entry live.
        for site in self.boundary_sites:
            if site.kind not in ("submit", "spawn", "fleet_target", "mp_process"):
                continue
            if site.target is None or site.target in self.entry_points:
                continue
            fn = prog.functions.get(site.fn)
            mod = prog.modules.get(fn.module) if fn else None
            if mod is None or _suppressed(mod, site.line, CONTINUITY):
                continue
            findings.append(Finding(
                mod.path, site.line, 0, CONTINUITY,
                f"spawn target {site.target} ({site.kind} site in {site.fn}) "
                f"is not declared in SPAWN_ENTRY_POINTS — undeclared workers "
                f"escape the process-domain proofs (HSL019-022); declare it "
                f"with its kind in analysis/procdomain.py",
            ))
        for q, (kind, _) in sorted(self.entry_points.items()):
            if q in prog.functions:
                continue
            if not any(q.startswith(m + ".") for m in prog.modules):
                continue  # scanning a subset — the module is out of scope
            findings.append(Finding(
                next(iter(prog.modules.values())).path, 0, 0, CONTINUITY,
                f"stale SPAWN_ENTRY_POINTS entry: {q!r} ({kind}) names no "
                f"function in the analyzed program — fix the qname or delete "
                f"the entry",
            ))
        # (b) carrier plumbing per kind.
        for q, (kind, _) in sorted(self.live_entries.items()):
            fn = prog.functions[q]
            mod = prog.modules.get(fn.module)
            if mod is None or kind not in ("task", "service"):
                continue
            calls = {c.raw.split(".")[-1] for c in fn.calls}
            missing = []
            if "install_state" not in calls:
                missing.append("faults.install_state(shipped state) in the entry body")
            if kind == "task":
                mod_calls = set()
                for f2 in list(mod.functions.values()) + [
                    m for c in mod.classes.values() for m in c.methods.values()
                ]:
                    mod_calls.update(c.raw.split(".")[-1] for c in f2.calls)
                if "merge_observed" not in mod_calls:
                    missing.append("faults.merge_observed(...) on the join path")
                if "adopt_root" not in mod_calls:
                    missing.append("obs trace adopt_root(...) on the join path")
            if missing and not _suppressed(mod, fn.line, CONTINUITY):
                findings.append(Finding(
                    mod.path, fn.line, 0, CONTINUITY,
                    f"spawn entry point {q} ({kind}) breaks cross-boundary "
                    f"continuity: missing {'; '.join(missing)} — a worker "
                    f"spawned here silently loses injected faults or "
                    f"telemetry (docs/fault_tolerance.md)",
                ))
        # (c) worker telemetry vocabulary over the task domain.
        known_spans = _string_tuple_registry(prog, "KNOWN_WORKER_SPANS")
        known_counters = _string_tuple_registry(prog, "KNOWN_COUNTERS")
        known_events = _known_events(prog)
        for q in sorted(self.task_fns):
            fn = prog.functions.get(q)
            mod = prog.modules.get(fn.module) if fn else None
            if fn is None or mod is None:
                continue
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                first = node.args[0]
                if not (isinstance(first, ast.Constant) and isinstance(first.value, str)):
                    continue
                tail = _dotted(node.func).split(".")[-1]
                name = first.value
                bad = None
                if tail in ("span", "trace") and known_spans is not None \
                        and name not in known_spans:
                    bad = (f"worker span {name!r} is not declared in "
                           f"obs.trace KNOWN_WORKER_SPANS")
                elif tail == "increment" and known_counters is not None \
                        and name not in known_counters:
                    bad = (f"worker counter {name!r} is not declared in "
                           f"stats.KNOWN_COUNTERS")
                elif tail == "declare" and known_events is not None \
                        and name not in known_events:
                    bad = (f"worker event {name!r} is not declared in "
                           f"obs.events.KNOWN_EVENTS")
                if bad is None or _suppressed(mod, node.lineno, CONTINUITY):
                    continue
                witness = tuple(
                    prog.modules[prog.functions[w].module].path
                    for w in self.task_fns[q] if w in prog.functions
                )
                findings.append(Finding(
                    mod.path, node.lineno, 0, CONTINUITY,
                    f"{bad} — a worker process would emit telemetry the "
                    f"coordinator's registries don't know (witness: "
                    f"{' -> '.join(self.task_fns[q])}); declare the name or "
                    f"fix the typo",
                    witness_paths=witness,
                ))
        return findings

    # -- findings ----------------------------------------------------------
    def findings(self) -> list[Finding]:
        out = self.spawn_import_findings()
        out += self.exchange_typing_findings()
        out += self.shared_file_findings()
        out += self.continuity_findings()
        return out

    # -- report ------------------------------------------------------------
    def to_json(self) -> dict:
        """Stable JSON form (procdemo golden, --format json report): the
        inferred domain graph — entries, task closure with witness
        chains, domain modules with their import provenance, boundary
        sites, and the lease-acquire reap proofs."""
        return {
            "entry_points": {
                q: {"kind": kind, "live": q in self.program.functions}
                for q, (kind, _) in sorted(self.entry_points.items())
            },
            "task_functions": {
                q: list(chain) for q, chain in sorted(self.task_fns.items())
            },
            "domain_modules": {
                m: (via if via.startswith("hosts ") else f"imported by {via}")
                for m, (via, _) in sorted(self.domain_modules.items())
            },
            "boundary_sites": [
                {"fn": s.fn, "line": s.line, "kind": s.kind, "target": s.target}
                for s in sorted(
                    self.boundary_sites, key=lambda s: (s.fn, s.line, s.kind)
                )
            ],
            "lease_acquires": sorted(
                self.lease_acquires, key=lambda d: (d["fn"], d["line"])
            ),
        }
