"""Per-file AST rules of the port's analyzer: the torch and CUDA bug
classes of this codebase, and the host-plane classes it shares with the
JAX package.

Run over paths (files or directories) with::

    python -m hyperspace_tpu_torch.analysis.lint hyperspace_tpu_torch

Exit status is non-zero iff any finding is reported. Rules:

- **HSL001 foreign-or-private-import** — any import of ``jax``,
  ``jaxlib`` or ``hyperspace_tpu`` (the JAX package) anywhere in the
  port, which must stand alone on a machine without JAX; and any
  ``torch._*`` private module or attribute (``torch._C``,
  ``torch.cuda._lazy_init``) outside the sanctioned
  ``hyperspace_tpu_torch/ops/kernels.py``. Private torch API moves
  between torch releases; the loader resolves it once, behind
  ``kernels.call_on_stream``, and everything else calls that.
- **HSL002 host-sync-in-launch** — a device→host synchronization inside
  a kernel wrapper's *launch body* (a function that calls
  ``count_launch``): ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``float()/int()/bool()`` of a tensor, or
  ``torch.cuda.synchronize()``. A launch is asynchronous on the stream;
  a sync there stalls the host on the card for every call.
- **HSL003 tensor-truth-in-launch** — ``if``/``while``/``assert`` whose
  test reads a tensor's VALUE in a launch body (an implicit sync).
  Shape, dtype and device reads (``x.shape``, ``x.is_cuda``,
  ``x.dim()``, ``x.numel()``, ...) are host metadata and exempt.
- **HSL004 unhashable-memo-key** — a list/dict/set display (or a tuple
  holding one) given as the key of ``kernels.memo``: the plan memo is a
  dict, so the key must hash; the tuple spelling is required.
- **HSL005 unseeded-randomness** — module-level RNG calls
  (``np.random.rand`` etc., stdlib ``random.*``) and
  ``np.random.default_rng()`` with no seed.
- **HSL006 metadata-write-bypass** — bare ``.write_text()`` /
  ``.write_bytes()`` / write-mode ``open()`` on metadata-plane paths
  (``_hyperspace_log`` entries, the ``latestStable`` pointer, the index
  manifest, ``v__=`` version dirs) anywhere except the sanctioned
  ``utils/file_utils.py``.
- **HSL007 wallclock-duration / undeclared-counter** — ``time.time()``
  in a subtraction (durations and TTL ages want ``time.monotonic()``;
  persisted cross-process stamps are the exception, marked
  ``# noqa: HSL007`` with the reason), and ``stats.increment`` with a
  constant counter name not declared in ``stats.KNOWN_COUNTERS``. The
  declared set is read by parsing ``hyperspace_tpu_torch/stats.py``'s
  AST, so the rule needs no import of the package.
- **HSL008 unlocked-global-mutation** — a module-level mutable container
  mutated from inside a function without a lock held (the serving
  plane runs queries on several threads; the kernel wrappers' caches
  are filled through ``kernels.memo``, which holds its lock).

Suppression: a finding on a line containing ``# noqa`` or
``# noqa: HSLxxx`` (matching rule id) is dropped.

This module is the per-file half of the engine. The whole-program rules
(HSL009-HSL030) need the cross-module index (program.py, callgraph.py,
locks.py, effects.py, races.py, raises.py, procdomain.py,
tracedomain.py, duradomain.py) and run from the unified check
``python -m hyperspace_tpu_torch.analysis.check``, which parses each file
once and feeds the same tree to this linter and to the program index.
Every rule is declared in :data:`RULES`, the one registry the JSON
report, the docs table and the baseline key on. docs/torch/
static_analysis.md says what each retargeted rule means in the port and
why the JAX package's version has no meaning here.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import pathlib
import sys

FOREIGN_IMPORT = "HSL001"
HOST_SYNC = "HSL002"
TENSOR_TRUTH = "HSL003"
UNHASHABLE_MEMO_KEY = "HSL004"
UNSEEDED_RNG = "HSL005"
METADATA_WRITE = "HSL006"
WALLCLOCK_OR_UNDECLARED = "HSL007"
UNLOCKED_GLOBAL = "HSL008"

# Exit codes (`main` and analysis/check.py): CI must be able to tell "the
# tree has findings" from "the analyzer crashed".
EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_INTERNAL_ERROR = 2


@dataclasses.dataclass(frozen=True)
class RuleInfo:
    """One registered rule: id, short slug, one-line summary, and where
    it runs ('file' = per-file AST walk here, 'program' = whole-program
    engine in check.py)."""

    rule: str
    slug: str
    summary: str
    scope: str = "file"


RULES: dict[str, RuleInfo] = {
    r.rule: r
    for r in (
        RuleInfo("HSL000", "unparseable", "file cannot be read or parsed"),
        RuleInfo("HSL001", "foreign-or-private-import",
                 "import of jax/jaxlib/hyperspace_tpu; torch._* private API outside ops/kernels.py"),
        RuleInfo("HSL002", "host-sync-in-launch",
                 "device->host sync (.item()/.cpu()/float()/torch.cuda.synchronize) in a launch body"),
        RuleInfo("HSL003", "tensor-truth-in-launch",
                 "Python if/while/assert on a tensor's value in a launch body (an implicit sync)"),
        RuleInfo("HSL004", "unhashable-memo-key",
                 "list/dict/set display as a kernels.memo key"),
        RuleInfo("HSL005", "unseeded-randomness",
                 "global/unseeded RNG use — irreproducible across runs and shards"),
        RuleInfo("HSL006", "metadata-write-bypass",
                 "bare write to a metadata-plane path outside file_utils.py"),
        RuleInfo("HSL007", "wallclock-or-undeclared-counter",
                 "time.time() in a duration subtraction; undeclared stats counter name"),
        RuleInfo("HSL008", "unlocked-global-mutation",
                 "module-level container mutated in a function without a lock held"),
        RuleInfo("HSL009", "lock-order-inversion",
                 "cycle in the whole-program lock-acquisition graph", scope="program"),
        RuleInfo("HSL010", "config-key-drift",
                 "hyperspace.* config key not declared in config.KNOWN_KEYS (or declared and dead)",
                 scope="program"),
        RuleInfo("HSL011", "resource-safety",
                 "lock/span/file acquired outside with/try-finally on a raising path",
                 scope="program"),
        RuleInfo("HSL012", "fault-point-coverage",
                 "faults.KNOWN_POINTS and fault_point()/inject() call sites out of sync",
                 scope="program"),
        RuleInfo("HSL013", "lockset-race",
                 "shared state accessed under inconsistent locksets with a write in play",
                 scope="program"),
        RuleInfo("HSL014", "atomicity-violation",
                 "torn check-then-act: read under a lock, released, stale write-back re-acquiring it",
                 scope="program"),
        RuleInfo("HSL015", "memo-key-hygiene",
                 "kernels.memo key built from a per-call value (id/tensor/clock/RNG); ops/ plan table filled outside kernels.memo",
                 scope="program"),
        RuleInfo("HSL016", "error-contract-drift",
                 "statically observed escape not covered by exceptions.ERROR_CONTRACTS (or dead contract entry)",
                 scope="program"),
        RuleInfo("HSL017", "swallowed-crash",
                 "except clause absorbing CrashPoint/FaultError/everything without re-raise or signal",
                 scope="program"),
        RuleInfo("HSL018", "unwind-safety",
                 "fault point with no static path to a recovery construct; +=/-= pair unbalanced on unwind",
                 scope="program"),
        RuleInfo("HSL019", "spawn-import-purity",
                 "module reachable at worker start imports jax/jaxlib/hyperspace_tpu or touches CUDA at module level",
                 scope="program"),
        RuleInfo("HSL020", "exchange-surface-typing",
                 "non-picklable/device value (ColumnTable, Span, lock, open handle, torch tensor/Stream/Event) crosses a process boundary",
                 scope="program"),
        RuleInfo("HSL021", "shared-file-protocol",
                 "bare write on an exchange/fleet/lease path outside the atomic publish protocol; O_EXCL acquire with no reachable TTL reap",
                 scope="program"),
        RuleInfo("HSL022", "cross-boundary-continuity",
                 "spawn entry point missing fault/trace continuity plumbing; undeclared spawn target or worker telemetry name",
                 scope="program"),
        RuleInfo("HSL023", "launch-effect-purity",
                 "host effect (config/stats/event/fault point/file/clock/lock) reachable in a kernel launch closure",
                 scope="program"),
        RuleInfo("HSL024", "launch-plan-boundedness",
                 "launch-plan memo outside kernels.memo, or a grid/tile width from a raw data shape",
                 scope="program"),
        RuleInfo("HSL025", "borrowed-buffer-mutation",
                 "in-place op on a tensor made over a buffer it does not own (from_numpy/frombuffer/as_tensor)",
                 scope="program"),
        RuleInfo("HSL026", "kernel-launch-contract",
                 "CUDA launch undeclared in ops.KNOWN_KERNELS/kernels.SOURCES, or missing its CPU-only plain branch, launch count, status raise, or with a fallback",
                 scope="program"),
        RuleInfo("HSL027", "durable-atomic-publish",
                 "durable write under a DURABLE_ROOTS plane does not reach the mkstemp + fsync + os.replace idiom — crash can surface a torn or zero-length file",
                 scope="program"),
        RuleInfo("HSL028", "torn-window-ordering",
                 "declared TORN_WINDOWS exactly-once protocol: two writes not statically ordered, or no KNOWN_POINTS fault point armed inside the window",
                 scope="program"),
        RuleInfo("HSL029", "replay-idempotence",
                 "durable file name on a REPLAY_ROOTS recovery/re-poll/takeover path derives from wall clock, pid, or RNG instead of cursor/log-id/generation values",
                 scope="program"),
        RuleInfo("HSL030", "snapshot-stamp-discipline",
                 "pinned-snapshot context reads the live version vector (get_latest_id/collection_log_versions/latest_log_id) instead of keying on the snapshot stamp",
                 scope="program"),
    )
}

# The one module allowed to touch torch's private API (it resolves the
# current device and raw stream for every launch).
SANCTIONED_PRIVATE = "ops/kernels.py"
# Import roots the port may never load: it stands alone without JAX.
FOREIGN_IMPORT_ROOTS = ("jax", "jaxlib", "hyperspace_tpu")
# The one module allowed to open metadata-plane paths for writing (it
# implements the atomic temp+fsync+rename primitives everything uses).
SANCTIONED_FILE_UTILS = "file_utils.py"

# Expression text that marks a write target as metadata-plane: the log
# dir and its pointer, version dirs, and the index manifest (both the
# literal names and the config/module constants they're spelled with).
_METADATA_PATH_MARKERS = (
    "_hyperspace_log",
    "lateststable",
    "hyperspace_log_dir",
    "latest_stable_log_name",
    "_index_manifest",
    "manifest_name",
    "data_version_prefix",
    "v__",
    "log_dir",
    "version_dir",
)

# HSL008 allowlist: (module basename, container name) pairs whose
# unlocked mutation is deliberate. The obs singletons' module state is
# written only through set_enabled/configure/reset — config-plane calls
# where last-writer-wins is the intended semantic, not a data race on
# the query path.
HSL008_ALLOWED = {
    ("trace.py", "NOOP"),
    ("trace.py", "_NOOP_TRACE"),
}

# Container constructors whose module-level result HSL008 tracks, and
# the method names that mutate such a container in place.
_HSL008_CTORS = {"dict", "list", "set", "deque", "defaultdict", "OrderedDict", "Counter"}
_HSL008_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "update", "setdefault", "pop", "popleft", "popitem", "clear",
    "remove", "discard",
}


def _declared_counters() -> "frozenset[str] | None":
    """Counter names declared in hyperspace_tpu/stats.py's
    KNOWN_COUNTERS tuple, extracted by AST parse (no import — the lint
    CI job runs without the package's dependencies installed). None when
    the file can't be located/parsed, which disables the check."""
    global _DECLARED_CACHE
    if _DECLARED_CACHE is not ...:
        return _DECLARED_CACHE
    _DECLARED_CACHE = None
    stats_path = pathlib.Path(__file__).resolve().parent.parent / "stats.py"
    try:
        tree = ast.parse(stats_path.read_text())
    except (OSError, SyntaxError):
        return None
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name) and tgt.id == "KNOWN_COUNTERS":
                if isinstance(node.value, (ast.Tuple, ast.List)):
                    names = [
                        e.value
                        for e in node.value.elts
                        if isinstance(e, ast.Constant) and isinstance(e.value, str)
                    ]
                    _DECLARED_CACHE = frozenset(names)
                    return _DECLARED_CACHE
    return None


_DECLARED_CACHE: "frozenset[str] | None | object" = ...


# HSL002: tensor methods that copy to the host and wait for the card.
_HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
_HOST_SYNC_CASTS = {"float", "int", "bool"}
# Tensor attributes and methods that read host metadata only (no sync).
_STATIC_TENSOR_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "layout", "is_sparse",
    "requires_grad",
}
_STATIC_TENSOR_METHODS = {
    "dim", "numel", "nelement", "size", "get_device", "is_contiguous",
    "data_ptr", "element_size", "stride", "storage_offset",
}
# torch.<name>(...) calls that do not make a tensor.
_NON_TENSOR_TORCH = {
    "device", "Size", "dtype", "get_default_dtype", "is_tensor", "typename",
    "Generator", "no_grad", "inference_mode",
}
_GLOBAL_RNG_FNS = {
    "rand", "randn", "randint", "random", "random_sample", "choice",
    "shuffle", "permutation", "normal", "uniform", "standard_normal", "seed",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str
    # Files (other than `path`) on the finding's witness chain — the
    # lock-order / escape / unwind / domain chains that PROVE the
    # finding. `--changed` mode keeps a finding when ANY witness file
    # changed, not just the primary location: editing a callee can
    # create a finding whose report line sits in an unchanged caller.
    # Not part of the baseline key (the message already pins the chain).
    witness_paths: tuple = ()

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


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


def _is_foreign(module: str) -> bool:
    return module.split(".")[0] in FOREIGN_IMPORT_ROOTS


def _private_torch(dotted: str) -> bool:
    """`torch._C`, `torch._C._cuda_getDevice`, `torch.cuda._lazy_init`:
    a torch chain with a private (single-underscore) part."""
    parts = dotted.split(".")
    return parts[0] == "torch" and any(
        p.startswith("_") and not p.startswith("__") for p in parts[1:]
    )


def _calls_count_launch(fn: ast.AST) -> bool:
    """True when `fn`'s own body (nested defs excluded) calls
    `count_launch`: the function is a kernel wrapper's launch body."""
    for sub in _own_nodes(fn):
        if isinstance(sub, ast.Call) and _dotted(sub.func).rsplit(".", 1)[-1] == "count_launch":
            return True
    return False


def _own_nodes(fn: ast.AST):
    """Every node of `fn`'s body, nested function and lambda bodies
    excluded."""
    stack = list(getattr(fn, "body", []))
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
                continue
            stack.append(child)


def tensor_names(fn: ast.AST) -> set[str]:
    """Names that hold a tensor in `fn`: parameters annotated with a
    Tensor type, and locals bound (in statement order) from a tensor
    expression — a `torch.<ctor>(...)` call, a tensor method that
    returns a tensor, a subscript or arithmetic of a tensor."""
    names: set[str] = set()
    args = fn.args
    for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
        if a.annotation is not None and "Tensor" in ast.unparse(a.annotation):
            names.add(a.arg)

    def is_tensor(e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in names
        if isinstance(e, ast.Subscript):
            return is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return is_tensor(e.left) or is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return is_tensor(e.operand)
        if isinstance(e, ast.Call):
            d = _dotted(e.func)
            parts = d.split(".") if d else []
            if len(parts) == 2 and parts[0] == "torch":
                return parts[1] not in _NON_TENSOR_TORCH
            if isinstance(e.func, ast.Attribute):
                m = e.func.attr
                if m in _STATIC_TENSOR_METHODS or m in _HOST_SYNC_ATTRS:
                    return False
                return is_tensor(e.func.value)
        return False

    nodes = sorted(
        (n for n in _own_nodes(fn) if isinstance(n, ast.Assign)),
        key=lambda n: (n.lineno, n.col_offset),
    )
    for node in nodes:
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                if is_tensor(node.value):
                    names.add(tgt.id)
            elif isinstance(tgt, ast.Tuple) and isinstance(node.value, ast.Tuple):
                for t, v in zip(tgt.elts, node.value.elts):
                    if isinstance(t, ast.Name) and is_tensor(v):
                        names.add(t.id)
    return names


def _unhashable(key: ast.AST) -> str | None:
    """The display kind that makes a memo key unhashable, if any."""
    if isinstance(key, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(key, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(key, (ast.Set, ast.SetComp)):
        return "set"
    if isinstance(key, ast.Tuple):
        for e in key.elts:
            got = _unhashable(e)
            if got:
                return got
    return None


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str, is_private_ok: bool, is_file_utils: bool = False):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.is_private_ok = is_private_ok
        self.is_file_utils = is_file_utils
        self.findings: list[Finding] = []
        # Stack of (is_launch_body, tensor names) per function scope.
        self._fn_stack: list[tuple[bool, frozenset]] = []
        # HSL008 state: module-level mutable container names, and how
        # many lock-holding `with` blocks enclose the current node.
        self.module_containers: set[str] = set()
        self._lock_depth = 0

    def collect_module_containers(self, tree: ast.Module) -> None:
        """Names assigned a mutable container display/constructor at
        module level (HSL008 candidates). Only simple top-level
        assignments count — a container built inside a function is local
        state, and attribute targets belong to lock-owning objects."""
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
                and _dotted(value.func).split(".")[-1] in _HSL008_CTORS
            )
            if not is_container:
                continue
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    basename = pathlib.PurePath(self.path).name
                    if (basename, tgt.id) not in HSL008_ALLOWED:
                        self.module_containers.add(tgt.id)

    # -- bookkeeping ---------------------------------------------------------

    def _report(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        text = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        if "# noqa" in text:
            tail = text.split("# noqa", 1)[1]
            if not tail.strip().startswith(":") or rule in tail:
                return
        self.findings.append(
            Finding(self.path, line, getattr(node, "col_offset", 0), rule, message)
        )

    def _in_launch(self) -> bool:
        return bool(self._fn_stack) and self._fn_stack[-1][0]

    def _tensors(self) -> frozenset:
        return self._fn_stack[-1][1] if self._fn_stack else frozenset()

    # -- HSL001: foreign and private imports ---------------------------------

    def _foreign(self, node: ast.AST, module: str) -> None:
        self._report(
            node, FOREIGN_IMPORT,
            f"import of {module!r}: the port stands alone on a machine "
            f"without JAX and never loads the JAX package — keep a copy of "
            f"what it needs in hyperspace_tpu_torch",
        )

    def _private(self, node: ast.AST, what: str) -> None:
        if self.is_private_ok:
            return
        self._report(
            node, FOREIGN_IMPORT,
            f"private torch API {what!r} outside ops/kernels.py — it moves "
            f"between torch releases; call the loader's helper "
            f"(kernels.call_on_stream) instead",
        )

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if _is_foreign(alias.name):
                self._foreign(node, alias.name)
            elif _private_torch(alias.name):
                self._private(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and node.level == 0:
            if _is_foreign(node.module):
                self._foreign(node, node.module)
            elif _private_torch(node.module):
                self._private(node, node.module)
            elif node.module == "torch":
                for a in node.names:
                    if a.name.startswith("_") and not a.name.startswith("__"):
                        self._private(node, f"torch.{a.name}")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        dotted = _dotted(node)
        if dotted:
            # A pure Name/Attribute chain: report the whole chain once
            # (its inner links would repeat the finding).
            if _private_torch(dotted):
                self._private(node, dotted)
            return
        self.generic_visit(node)

    # -- function scopes -----------------------------------------------------

    def _visit_fn(self, node) -> None:
        # Nested defs are scopes of their own: a closure defined in a
        # launch body (a memo's build function) is not the launch.
        launch = _calls_count_launch(node)
        self._fn_stack.append((launch, frozenset(tensor_names(node)) if launch else frozenset()))
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    # -- HSL002 / HSL004 / HSL005: calls -------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)

        # HSL004: a kernels.memo key must hash.
        if dotted.rsplit(".", 1)[-1] == "memo":
            key = node.args[1] if len(node.args) >= 2 else next(
                (kw.value for kw in node.keywords if kw.arg == "key"), None
            )
            kind = _unhashable(key) if key is not None else None
            if kind:
                self._report(
                    node, UNHASHABLE_MEMO_KEY,
                    f"kernels.memo key holds a {kind} display — the plan "
                    f"memo is a dict and its key must hash; use a tuple",
                )

        # HSL005: module-level RNG state.
        parts = dotted.split(".")
        if len(parts) >= 2 and parts[-2] == "random" and parts[0] in ("np", "numpy", "jax"):
            if parts[0] != "jax" and parts[-1] in _GLOBAL_RNG_FNS:
                self._report(
                    node, UNSEEDED_RNG,
                    f"{dotted}() uses numpy's global RNG — results are not "
                    f"reproducible across runs/shards; use "
                    f"np.random.default_rng(seed)",
                )
            elif parts[-1] == "default_rng" and not node.args and not node.keywords:
                self._report(
                    node, UNSEEDED_RNG,
                    "np.random.default_rng() without a seed is entropy-seeded "
                    "— pass an explicit seed for reproducible builds",
                )
        elif len(parts) == 2 and parts[0] == "random" and parts[1] in (
            _GLOBAL_RNG_FNS | {"gauss", "sample", "randrange"}
        ):
            self._report(
                node, UNSEEDED_RNG,
                f"stdlib {dotted}() draws from global, unseeded state — "
                f"use a seeded np.random.default_rng",
            )

        # HSL006: bare writes to metadata-plane paths.
        self._check_metadata_write(node)

        # HSL007(b): stats.increment with an undeclared constant name.
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "increment"
            and "stats" in _dotted(node.func.value).lower()
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            declared = _declared_counters()
            if declared is not None and node.args[0].value not in declared:
                self._report(
                    node, WALLCLOCK_OR_UNDECLARED,
                    f"counter {node.args[0].value!r} is not declared in "
                    f"stats.KNOWN_COUNTERS — undeclared names raise at "
                    f"runtime (the declared-registry contract); fix the "
                    f"typo or declare it",
                )

        # HSL008: in-place mutation of a module-level container from a
        # function without a lock held.
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _HSL008_MUTATORS
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in self.module_containers
        ):
            self._check_global_mutation(node, node.func.value.id, f".{node.func.attr}()")

        # HSL002: host sync in a launch body.
        if self._in_launch():
            tensors = self._tensors()
            if isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_SYNC_ATTRS:
                self._report(
                    node, HOST_SYNC,
                    f".{node.func.attr}() copies to the host and waits for "
                    f"the card inside a launch body — launches are "
                    f"asynchronous on the stream; read results after the "
                    f"wrapper returns",
                )
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in _HOST_SYNC_CASTS
                and node.args
                and _reads_tensor(node.args[0], tensors)
            ):
                self._report(
                    node, HOST_SYNC,
                    f"{node.func.id}() of a tensor syncs the host with the "
                    f"card inside a launch body — keep it a tensor or read "
                    f"it after the wrapper returns",
                )
            elif dotted.endswith("cuda.synchronize"):
                self._report(
                    node, HOST_SYNC,
                    "torch.cuda.synchronize() inside a launch body stalls "
                    "the host on every launch — the stream orders the work",
                )
        self.generic_visit(node)

    # -- HSL006: bare metadata-plane writes ------------------------------------

    def _check_metadata_write(self, node: ast.Call) -> None:
        """Flag `<expr>.write_text/.write_bytes(...)` and write-mode
        `open(...)` whose expression text names a metadata-plane path
        (operation-log entries, latestStable, the index manifest,
        version dirs) outside file_utils.py — such writes are torn on
        crash; the atomic primitives exist precisely so they can't be."""
        if self.is_file_utils:
            return
        is_write = (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in ("write_text", "write_bytes")
        )
        if not is_write and isinstance(node.func, ast.Name) and node.func.id == "open":
            mode = None
            if (
                len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
            ):
                mode = node.args[1].value
            for kw in node.keywords:
                if (
                    kw.arg == "mode"
                    and isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, str)
                ):
                    mode = kw.value.value
            is_write = mode is not None and any(c in mode for c in "wax+")
        if not is_write:
            return
        seg = (ast.get_source_segment(self.source, node) or "").lower()
        if any(m in seg for m in _METADATA_PATH_MARKERS):
            self._report(
                node, METADATA_WRITE,
                "bare write to a metadata-plane path (operation log / "
                "latestStable / manifest / version dir) — a crash mid-write "
                "tears it; route through file_utils.write_json/atomic_write "
                "(temp file + fsync + atomic rename + dir fsync)",
            )

    # -- HSL008: unlocked module-global container mutation ---------------------

    def _check_global_mutation(self, node: ast.AST, name: str, how: str) -> None:
        if not self._fn_stack:
            return  # module level runs once at import, single-threaded
        if self._lock_depth > 0:
            return
        self._report(
            node, UNLOCKED_GLOBAL,
            f"module-level container {name!r} mutated ({how}) outside a "
            f"lock — safe single-threaded, a lost-update/torn-eviction "
            f"race under the concurrent serving plane; "
            f"guard it with a module lock (`with _lock:`) or move it into "
            f"a lock-guarded class",
        )

    def _subscript_base(self, tgt: ast.expr) -> str | None:
        """The bare module-container name a Subscript target indexes, if
        any (`NAME[k] = v` / `del NAME[k]` / `NAME[k] += v`)."""
        if isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Name):
            if tgt.value.id in self.module_containers:
                return tgt.value.id
        return None

    def visit_With(self, node: ast.With) -> None:
        held = any(
            "lock" in (ast.get_source_segment(self.source, item.context_expr) or "").lower()
            for item in node.items
        )
        if held:
            self._lock_depth += 1
        try:
            self.generic_visit(node)
        finally:
            if held:
                self._lock_depth -= 1

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            base = self._subscript_base(tgt)
            if base is not None:
                self._check_global_mutation(node, base, "[...] = ")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        base = self._subscript_base(node.target)
        if base is not None:
            self._check_global_mutation(node, base, "[...] op= ")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            base = self._subscript_base(tgt)
            if base is not None:
                self._check_global_mutation(node, base, "del [...]")
        self.generic_visit(node)

    # -- HSL007(a): wall-clock duration measurement ----------------------------

    def visit_BinOp(self, node: ast.BinOp) -> None:
        """`time.time() - x` / `x - time.time()` measures a duration (or
        a TTL age) with a steppable clock: an NTP adjustment makes it
        negative or wildly large. Durations want time.monotonic() /
        time.perf_counter(); persisted cross-process stamps are the one
        legitimate wall-clock use — annotate those `# noqa: HSL007`."""
        if isinstance(node.op, ast.Sub):
            for side in (node.left, node.right):
                if isinstance(side, ast.Call) and _dotted(side.func) == "time.time":
                    self._report(
                        node, WALLCLOCK_OR_UNDECLARED,
                        "time.time() in a subtraction — wall clock steps "
                        "under NTP; measure durations/TTL ages with "
                        "time.monotonic() or time.perf_counter() (persisted "
                        "cross-process stamps may stay wall-clock with a "
                        "negative-age guard and `# noqa: HSL007`)",
                    )
                    break
        self.generic_visit(node)

    # -- HSL003: tensor truth value in a launch body --------------------------

    def _check_branch(self, node, kind: str) -> None:
        if self._in_launch():
            read = _tensor_value_reads(node.test, self._tensors())
            if read:
                self._report(
                    node, TENSOR_TRUTH,
                    f"Python {kind} on the value of tensor(s) {sorted(read)} "
                    f"inside a launch body — its truth value syncs the host "
                    f"with the card; branch on shapes, dtypes and devices "
                    f"only, or keep the decision on the card (torch.where)",
                )
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, "if")

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, "while")

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_branch(node, "assert")


def _reads_tensor(expr: ast.AST, tensors: frozenset) -> bool:
    """True when `expr` is a tensor value (not host metadata of one)."""
    if isinstance(expr, ast.Call):
        d = _dotted(expr.func)
        parts = d.split(".") if d else []
        if len(parts) == 2 and parts[0] == "torch":
            return parts[1] not in _NON_TENSOR_TORCH
    return bool(_tensor_value_reads(expr, tensors))


def _tensor_value_reads(test: ast.AST, tensors: frozenset) -> set[str]:
    """Tensor names whose runtime VALUE `test` reads. A name consumed
    only through host metadata (x.shape, x.is_cuda, x.dim(), len(x),
    isinstance(x, ...)) or compared by identity (`x is None`) does not
    count."""
    if not tensors:
        return set()
    static_ids: set[int] = set()
    for sub in ast.walk(test):
        if isinstance(sub, ast.Attribute) and (
            sub.attr in _STATIC_TENSOR_ATTRS or sub.attr in _STATIC_TENSOR_METHODS
        ):
            for inner in ast.walk(sub.value):
                if isinstance(inner, ast.Name):
                    static_ids.add(id(inner))
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id in ("len", "isinstance", "getattr", "hasattr", "id", "type")
        ):
            for inner in ast.walk(sub):
                if isinstance(inner, ast.Name):
                    static_ids.add(id(inner))
        if isinstance(sub, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in sub.ops
        ):
            for inner in ast.walk(sub):
                if isinstance(inner, ast.Name):
                    static_ids.add(id(inner))
    return {
        sub.id
        for sub in ast.walk(test)
        if isinstance(sub, ast.Name) and sub.id in tensors and id(sub) not in static_ids
    }


# -- entry points ------------------------------------------------------------

def lint_source(source: str, path: str = "<string>", tree: ast.Module | None = None) -> list[Finding]:
    """Lint one source text; `path` only labels findings (a path ending
    in ops/kernels.py marks the module sanctioned for torch's private
    API). Pass `tree` to reuse an
    existing parse — the unified check parses each file exactly
    once and feeds the same AST to this linter and the program index."""
    if tree is None:
        tree = ast.parse(source, filename=path)
    name = pathlib.PurePath(path).name
    linter = _Linter(
        path, source, pathlib.PurePath(path).as_posix().endswith(SANCTIONED_PRIVATE),
        is_file_utils=name == SANCTIONED_FILE_UTILS,
    )
    linter.collect_module_containers(tree)
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: (f.path, f.line, f.col))


def lint_paths(paths: list[str]) -> list[Finding]:
    findings: list[Finding] = []
    for p in paths:
        root = pathlib.Path(p)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            try:
                src = f.read_text()
            except OSError as e:
                findings.append(Finding(str(f), 0, 0, "HSL000", f"unreadable: {e}"))
                continue
            try:
                findings.extend(lint_source(src, str(f)))
            except SyntaxError as e:
                findings.append(
                    Finding(str(f), e.lineno or 0, e.offset or 0, "HSL000",
                            f"syntax error: {e.msg}")
                )
    return findings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hyperspace_tpu_torch.analysis.lint",
        description="Per-file linter of the port (rules HSL001-HSL008).",
    )
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument(
        "-q", "--quiet", action="store_true", help="suppress the summary line"
    )
    args = ap.parse_args(argv)
    # Unambiguous exit codes: 0 = clean, 1 = findings, 2 = the linter
    # itself crashed (an unreadable/unparseable TARGET is a finding —
    # HSL000 — not a crash).
    try:
        findings = lint_paths(args.paths)
        for f in findings:
            print(f)
        if not args.quiet:
            print(f"{len(findings)} finding(s)", file=sys.stderr)
    except Exception as e:  # pragma: no cover - exercised via unit test stub
        print(f"internal error: {type(e).__name__}: {e}", file=sys.stderr)
        return EXIT_INTERNAL_ERROR
    return EXIT_FINDINGS if findings else EXIT_CLEAN


if __name__ == "__main__":
    sys.exit(main())
