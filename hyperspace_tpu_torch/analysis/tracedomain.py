"""Launch-domain analysis: which code runs on a kernel's launch path
(HSL023-026).

The JAX package's module of this name infers a *trace* domain: the
closure of every function handed to ``jit``, ``shard_map`` or
``pallas_call``. The port traces nothing. Its device plane is three
hand-written CUDA kernels, each behind a Python wrapper that launches it
on a CUDA tensor and runs its plain PyTorch version on a CPU tensor
(``ops/segment_reduce.py``, ``ops/sortkeys.py::run_bounds``,
``ops/topk.py``). The module keeps its name so that a reader finds the
counterpart, and infers the port's *launch domain* instead:

- **The launch-domain inference.** A *launch body* is any function that
  calls ``count_launch(wrapper)``; the *wrapper* is the function named
  by that argument. A wrapper's *launch closure* is its CUDA side — its
  body less its CPU branch (an ``if`` whose test asks ``not x.is_cuda``
  or ``x.device.type == "cpu"``) — closed over the call graph, function
  references passed as arguments included (``call_on_stream(index,
  _run, ...)``). The closure does not descend into the sanctioned
  helpers of :data:`LAUNCH_SANCTIONED` (the loader's ``count_launch``,
  ``memo``, ``load`` and ``call_on_stream``, and the ``device.kernel``
  span around the launch, which is a no-op outside a trace and a child
  span — two clock reads, no lock, no IO — inside one): their locks and
  effects are the sanctioned ones. The registry is AST-extracted like ``SPAWN_ENTRY_POINTS``, so
  fixture packages declare their own.

- **HSL023 launch-effect purity.** Nothing in a launch closure may
  read configuration, bump a counter other than the launch count, emit
  an event, evaluate a fault point, touch a file, read a wall clock or
  take a lock of its own. A launch is a few microseconds of host work
  per kernel; the server's worker threads launch concurrently, and an
  effect there is both a cost on every launch and a way for the launch
  path to diverge from what was planned (a fault point there would be a
  path to a fallback).

- **HSL024 launch-plan boundedness.** Every launch-plan memo of a
  launch-hosting module goes through ``kernels.memo`` (bounded by
  ``MEMO_ENTRIES``, filled under its lock) — an ``lru_cache`` /
  ``functools.cache`` there is a finding — and every grid or tile width
  a closure binds (``grid``, ``threads``, ``blocks``, ``tiles``,
  ``chunk``, ``window``, ...) derives from a rounding helper (a function
  returning ``//``/``<<``/``%`` arithmetic), a memo, or module
  constants, never from a raw data shape.

- **HSL025 borrowed-buffer mutation.** A tensor made by
  ``torch.from_numpy`` / ``torch.frombuffer`` / ``torch.as_tensor``
  shares the buffer it was made over (an Arrow-owned, read-only column
  among them: the torch hazard H2). No in-place op — a ``*_()`` method
  (``copy_``, ``resize_``, ``add_``, ...), an ``out=`` argument, slice
  assignment, an augmented assignment — may touch such a tensor. The
  report lists every producer and the copying gateways (the functions
  that copy a read-only array before wrapping it:
  ``execution/table.py::to_tensor``).

- **HSL026 the launch contract.** ``ops.KNOWN_KERNELS`` declares every
  kernel wrapper by its package-relative name
  (``ops.topk.topk``); it must agree both ways with the wrappers the
  launch bodies count, with the ``load("<name>")`` engagements in their
  closures and with ``kernels.SOURCES``. Each wrapper's closure must
  prove four things: (a) its plain version (``<wrapper>_plain``) is
  reached only on the CPU branch; (b) it calls ``count_launch(wrapper)``;
  (c) it raises ``HyperspaceError`` on a non-zero CUDA status; (d) there
  is no fallback — no ``except`` in the closure and no path from the
  CUDA side to the plain version. The report carries one proof per
  kernel, which ``chip_smoke.py`` holds against the card's launches.

Everything here is stdlib-``ast`` only and never imports analyzed code,
same as the rest of the engine (docs/torch/static_analysis.md).
"""

from __future__ import annotations

import ast
import dataclasses

from hyperspace_tpu_torch.analysis.callgraph import CallGraph
from hyperspace_tpu_torch.analysis.lint import Finding, _dotted
from hyperspace_tpu_torch.analysis.procdomain import _string_tuple_registry, _suppressed
from hyperspace_tpu_torch.analysis.program import FunctionInfo, ModuleInfo, Program

LAUNCH_EFFECT = "HSL023"
PLAN_BOUND = "HSL024"
BORROWED_MUTATION = "HSL025"
LAUNCH_CONTRACT = "HSL026"

#: The sanctioned helpers of the launch path: the closure calls them but
#: does not descend into them, so their locks and effects are allowed.
#: AST-extracted from every scanned module (fixture packages declare
#: their own). Keep it a plain dict literal of string constants.
LAUNCH_SANCTIONED = {
    "hyperspace_tpu_torch.ops.kernels.count_launch":
        "the launch count: one add under its lock",
    "hyperspace_tpu_torch.ops.kernels.memo":
        "the bounded launch-plan memo: one lookup or build under its lock",
    "hyperspace_tpu_torch.ops.kernels.load":
        "the kernel's library: built and loaded once under the loader's lock",
    "hyperspace_tpu_torch.ops.kernels.call_on_stream":
        "the launch on the current device's raw stream (torch's private API, once)",
    "hyperspace_tpu_torch.obs.trace.span":
        "the device.kernel span: a no-op outside a trace, else a child span (two clock reads, no lock, no IO)",
}

#: Wall-clock reads (HSL023).
_WALLCLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "datetime.now",
    "datetime.utcnow", "datetime.datetime.now", "datetime.datetime.utcnow",
}
#: File-IO call tails (HSL023).
_FILE_IO_TAILS = {"write_text", "write_bytes", "read_text", "read_bytes"}
#: Names a closure binds a launch geometry to (HSL024).
_GEOMETRY = {
    "grid", "threads", "blocks", "tiles", "chunk", "window", "rows",
    "smem", "block", "tile", "grid_x", "grid_y",
}
#: Calls that make a tensor over a buffer it does not own (HSL025), and
#: the methods that keep the alias.
_PRODUCERS = {"from_numpy", "frombuffer", "as_tensor"}
_ALIAS_METHODS = {
    "to", "view", "reshape", "view_as", "squeeze", "unsqueeze", "flatten",
    "t", "transpose", "permute", "expand", "narrow",
}
_MEMO_DECORATORS = {"lru_cache", "cache", "cached_property"}


def _registry_site(program: Program, name: str) -> tuple[ModuleInfo, int] | None:
    """(module, line) of the first top-level assignment declaring `name`."""
    for _, mod in sorted(program.modules.items()):
        for node in mod.tree.body:
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
            elif isinstance(node, ast.AnnAssign):
                target = node.target
            if isinstance(target, ast.Name) and target.id == name:
                return mod, node.lineno
    return None


def _dict_registry(program: Program, name: str) -> dict[str, str] | None:
    """The union of every scanned module's top-level ``<name>`` dict
    literal of string keys (values: their string text, else their source
    text), or None when no module declares one."""
    out: dict[str, str] | None = None
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
            out = out if out is not None else {}
            for k, v in zip(value.keys, value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    text = v.value if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                        else ast.unparse(v)
                    out[k.value] = text
    return out


def kernel_id(qname: str) -> str:
    """A wrapper's package-relative name: ``hyperspace_tpu_torch.ops.
    topk.topk`` → ``ops.topk.topk`` (the form ``KNOWN_KERNELS`` uses)."""
    return qname.split(".", 1)[1] if "." in qname else qname


def _cpu_test(test: ast.AST) -> bool:
    """True when an ``if`` test selects the CPU branch: ``not x.is_cuda``
    or ``<x>.device.type == "cpu"`` / ``<x>.type == "cpu"``."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return isinstance(test.operand, ast.Attribute) and test.operand.attr == "is_cuda"
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and isinstance(test.ops[0], ast.Eq):
        left, right = test.left, test.comparators[0]
        return (
            isinstance(left, ast.Attribute) and left.attr == "type"
            and isinstance(right, ast.Constant) and right.value == "cpu"
        )
    return False


def cuda_side(fn_node: ast.AST) -> tuple[list[ast.AST], list[tuple[ast.If, list[ast.AST]]]]:
    """(the nodes of `fn_node`'s body outside its CPU branches, [(CPU
    branch if, its nodes)]). A CPU branch is the body of an ``if`` whose
    test selects the CPU (:func:`_cpu_test`); its ``else`` stays on the
    CUDA side."""
    cuda: list[ast.AST] = []
    cpu: list[tuple[ast.If, list[ast.AST]]] = []
    stack = list(getattr(fn_node, "body", []))
    while stack:
        node = stack.pop()
        if isinstance(node, ast.If) and _cpu_test(node.test):
            branch: list[ast.AST] = []
            for stmt in node.body:
                branch.extend(ast.walk(stmt))
            cpu.append((node, branch))
            cuda.append(node.test)
            cuda.extend(ast.walk(node.test))
            stack.extend(node.orelse)
            continue
        cuda.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return cuda, cpu


@dataclasses.dataclass
class LaunchSite:
    """One ``count_launch(wrapper)`` call."""

    body: str          # the launch body's qname
    line: int
    wrapper: str | None  # the counted wrapper's qname, when it resolves


class LaunchDomains:
    """Infer the launch domain and check HSL023-026 over it. Same engine
    contract as :class:`procdomain.ProcessDomains`: built from the
    program summaries and call graph, never importing analyzed code;
    ``findings()`` returns the rule violations and ``to_json()`` the
    inferred graph (golden-tested for the launchdemo fixture and shipped
    in the check report's ``launch_domains`` section)."""

    def __init__(self, program: Program, callgraph: CallGraph, raises=None):
        self.program = program
        self.callgraph = callgraph
        self.raises = raises
        self.sanctioned = _dict_registry(program, "LAUNCH_SANCTIONED") or {}
        self.known_kernels = _string_tuple_registry(program, "KNOWN_KERNELS")
        self.sources = _dict_registry(program, "SOURCES")
        self.sites: list[LaunchSite] = []
        #: wrapper qname -> {closure fn qname: witness chain from the wrapper}
        self.closures: dict[str, dict[str, tuple[str, ...]]] = {}
        self.calls_total = 0
        self.calls_unresolved = 0
        self._find_sites()
        for w in sorted({s.wrapper for s in self.sites if s.wrapper}):
            self.closures[w] = self._closure(w)
        self._proofs = [self._prove(w) for w in sorted(self.closures)]
        self._borrowed: dict | None = None
        self._findings: list[Finding] | None = None

    # -- inference -------------------------------------------------------------

    @property
    def launch_fns(self) -> set[str]:
        out: set[str] = set()
        for c in self.closures.values():
            out.update(c)
        return out

    def _is_sanctioned(self, qname: str | None) -> bool:
        return qname is not None and qname in self.sanctioned

    def _find_sites(self) -> None:
        prog, cg = self.program, self.callgraph
        for q in sorted(prog.functions):
            fn = prog.functions[q]
            for sub in ast.walk(fn.node):
                if not isinstance(sub, ast.Call):
                    continue
                if _dotted(sub.func).rsplit(".", 1)[-1] != "count_launch":
                    continue
                wrapper = None
                if sub.args:
                    raw = _dotted(sub.args[0])
                    got = cg.resolve_call(fn, raw) if raw else None
                    wrapper = got if got in prog.functions else None
                self.sites.append(LaunchSite(q, sub.lineno, wrapper))

    def _resolve(self, fn: FunctionInfo, raw: str) -> str | None:
        """resolve_call minus the unique-method-name fallback for
        ungrounded receivers: a launch path calls mostly tensor methods
        (``x.contiguous()``, ``x.data_ptr()``) whose names collide with
        program methods. Rejections count in the unresolved ratio."""
        got = self.callgraph.resolve_call(fn, raw)
        if got is None:
            return None
        parts = raw.split(".")
        if len(parts) == 1 or "()." in raw or parts[0] in ("self", "super"):
            return got
        prog = self.program
        target = prog.resolve_symbol(fn.module, parts[0], fn=fn)
        if target is not None and (
            target in prog.functions or target in prog.classes
            or any(m == target or m.startswith(target + ".") for m in prog.modules)
        ):
            return got
        src = fn.local_types.get(parts[0])
        if src is not None and (src.startswith("self.") or (
            src.endswith("()") and prog.class_of_ctor(fn.module, src[:-2], fn=fn)
        )):
            return got
        return None

    def _dispatch(self, callee: str) -> tuple[str, ...]:
        if self.raises is not None:
            return self.raises.dispatch_targets(callee)
        return (callee,)

    def side_nodes(self, q: str) -> list[ast.AST]:
        """The CUDA-side nodes of closure function `q`."""
        return cuda_side(self.program.functions[q].node)[0]

    def _callees(self, fn: FunctionInfo, nodes: list[ast.AST]) -> list[str]:
        prog = self.program
        out: list[str] = []
        for sub in nodes:
            if not isinstance(sub, ast.Call):
                continue
            raw = _dotted(sub.func)
            refs = [raw] if raw else []
            # Function references handed on (call_on_stream(i, _run, ...),
            # memo(table, key, build_fn)) run on the same path.
            refs += [_dotted(a) for a in sub.args if isinstance(a, (ast.Name, ast.Attribute))]
            for i, r in enumerate(refs):
                if not r:
                    continue
                got = self._resolve(fn, r)
                if i == 0:
                    self.calls_total += 1
                    if got is None:
                        self.calls_unresolved += 1
                if got is None or got not in prog.functions:
                    continue
                for t in self._dispatch(got):
                    if t in prog.functions:
                        out.append(t)
        return out

    def _closure(self, wrapper: str) -> dict[str, tuple[str, ...]]:
        prog = self.program
        closure: dict[str, tuple[str, ...]] = {wrapper: (wrapper,)}
        stack = [wrapper]
        while stack:
            q = stack.pop()
            fn = prog.functions[q]
            for t in self._callees(fn, self.side_nodes(q)):
                if t in closure or self._is_sanctioned(t):
                    continue
                closure[t] = (*closure[q], t)
                stack.append(t)
        return closure

    def unresolved_ratio(self) -> float:
        if not self.calls_total:
            return 0.0
        return round(self.calls_unresolved / self.calls_total, 4)

    # -- HSL026: the per-kernel proof ------------------------------------------

    def _prove(self, wrapper: str) -> dict:
        prog = self.program
        closure = self.closures[wrapper]
        wfn = prog.functions[wrapper]
        simple = wrapper.rsplit(".", 1)[-1]
        plain_q = f"{wfn.module}.{simple}_plain"
        plain = None
        _, cpu = cuda_side(wfn.node)
        for branch_if, nodes in cpu:
            for sub in nodes:
                if isinstance(sub, ast.Call) and self._resolve(wfn, _dotted(sub.func)) == plain_q:
                    plain = {"fn": plain_q, "cpu_branch_line": branch_if.lineno}
                    break
            if plain:
                break
        plain_on_cuda = closure.get(plain_q)

        counted = next(
            ({"fn": s.body, "line": s.line} for s in self.sites
             if s.wrapper == wrapper and s.body in closure), None,
        )
        loads: list[dict] = []
        status = None
        fallback = None
        for q in sorted(closure):
            fn = prog.functions[q]
            for sub in self.side_nodes(q):
                if isinstance(sub, ast.Call):
                    got = self._resolve(fn, _dotted(sub.func))
                    if (
                        got is not None and got.rsplit(".", 1)[-1] == "load"
                        and sub.args and isinstance(sub.args[0], ast.Constant)
                        and isinstance(sub.args[0].value, str)
                    ):
                        loads.append({"name": sub.args[0].value, "fn": q, "line": sub.lineno})
                if status is None and isinstance(sub, ast.If) and _status_test(sub.test) \
                        and _raises_hyperspace_error(sub.body):
                    status = {"fn": q, "line": sub.lineno}
                if fallback is None and isinstance(sub, ast.Try) and sub.handlers:
                    fallback = {"fn": q, "line": sub.lineno, "why": "except around the launch path"}
        if fallback is None and plain_on_cuda is not None:
            fallback = {
                "fn": plain_q, "line": prog.functions[plain_q].line,
                "why": "plain version reachable from the CUDA side: " + " -> ".join(plain_on_cuda),
            }
        load_names = sorted({d["name"] for d in loads})
        return {
            "kernel": kernel_id(wrapper),
            "wrapper": wrapper,
            "loads": loads,
            "load_names": load_names,
            "source": (self.sources or {}).get(load_names[0]) if len(load_names) == 1 else None,
            "plain": plain,
            "count_launch": counted,
            "status_raise": status,
            "fallback": fallback,
            "closure": sorted(closure),
            "proven": bool(
                plain and plain_on_cuda is None and counted and status
                and fallback is None and len(load_names) == 1
            ),
        }

    # -- HSL023: launch-effect purity ------------------------------------------

    def purity_findings(self) -> list[Finding]:
        out: list[Finding] = []
        prog = self.program
        seen: set[tuple[str, int]] = set()
        for w in sorted(self.closures):
            for q, chain in sorted(self.closures[w].items()):
                fn = prog.functions[q]
                mod = prog.modules[fn.module]
                witness = tuple(dict.fromkeys(
                    prog.modules[prog.functions[c].module].path for c in chain
                ))
                via = " -> ".join(chain)
                for sub in self.side_nodes(q):
                    what = _effect(sub)
                    if what is None or (mod.path, sub.lineno) in seen:
                        continue
                    if isinstance(sub, ast.Call):
                        got = self._resolve(fn, _dotted(sub.func))
                        if self._is_sanctioned(got):
                            continue
                    seen.add((mod.path, sub.lineno))
                    if _suppressed(mod, sub.lineno, LAUNCH_EFFECT):
                        continue
                    out.append(Finding(
                        path=mod.path, line=sub.lineno, col=sub.col_offset,
                        rule=LAUNCH_EFFECT,
                        message=(
                            f"{what} on the launch path of {kernel_id(w)} "
                            f"(via {via}) — a launch does only what was "
                            f"planned: move the effect before the wrapper is "
                            f"called, or into a sanctioned helper "
                            f"(LAUNCH_SANCTIONED)"
                        ),
                        witness_paths=witness,
                    ))
        return out

    # -- HSL024: launch-plan boundedness ---------------------------------------

    def _is_rounder(self, qname: str | None) -> bool:
        """A tile-rounding helper: a program function any of whose return
        expressions uses ``//``/``<<``/``%`` arithmetic."""
        fn = self.program.functions.get(qname or "")
        if fn is None:
            return False
        for sub in ast.walk(fn.node):
            if isinstance(sub, ast.Return) and sub.value is not None:
                for b in ast.walk(sub.value):
                    if isinstance(b, ast.BinOp) and isinstance(b.op, (ast.FloorDiv, ast.LShift, ast.Mod)):
                        return True
            if isinstance(sub, ast.AugAssign) and isinstance(sub.op, ast.LShift):
                return True
        return False

    def plan_findings(self) -> list[Finding]:
        out: list[Finding] = []
        prog = self.program
        hosts = {prog.functions[q].module for q in self.launch_fns}
        for m in sorted(hosts):
            mod = prog.modules[m]
            fns = list(mod.functions.values()) + [
                f for c in mod.classes.values() for f in c.methods.values()
            ]
            for fn in sorted(fns, key=lambda f: f.line):
                for dec in fn.node.decorator_list:
                    tail = _dotted(dec.func if isinstance(dec, ast.Call) else dec).rsplit(".", 1)[-1]
                    if tail in _MEMO_DECORATORS and not _suppressed(mod, dec.lineno, PLAN_BOUND):
                        out.append(Finding(
                            path=mod.path, line=dec.lineno, col=0, rule=PLAN_BOUND,
                            message=(
                                f"{tail} on {fn.qname} in a launch-hosting "
                                f"module — launch plans are memoized through "
                                f"kernels.memo (bounded by MEMO_ENTRIES, filled "
                                f"under its lock), not a decorator cache"
                            ),
                            witness_paths=(mod.path,),
                        ))
        for q in sorted(self.launch_fns):
            fn = prog.functions[q]
            mod = prog.modules[fn.module]
            out += self._geometry_findings(fn, mod)
        return out

    def _geometry_findings(self, fn: FunctionInfo, mod: ModuleInfo) -> list[Finding]:
        cg = self.callgraph
        shapeish: set[str] = set()
        out: list[Finding] = []
        assigns = sorted(
            (s for s in ast.walk(fn.node) if isinstance(s, ast.Assign)),
            key=lambda s: (s.lineno, s.col_offset),
        )
        for sub in assigns:
            names: list[str] = []
            for tgt in sub.targets:
                if isinstance(tgt, ast.Name):
                    names.append(tgt.id)
                elif isinstance(tgt, ast.Tuple):
                    names += [e.id for e in tgt.elts if isinstance(e, ast.Name)]
            if not names:
                continue
            val = sub.value
            rounded = any(
                (isinstance(b, ast.BinOp) and isinstance(b.op, (ast.FloorDiv, ast.LShift, ast.Mod)))
                or (isinstance(b, ast.Call) and (
                    _dotted(b.func).rsplit(".", 1)[-1] == "memo"
                    or self._is_rounder(cg.resolve_call(fn, _dotted(b.func)))
                ))
                for b in ast.walk(val)
            )
            raw = {
                b.id for b in ast.walk(val) if isinstance(b, ast.Name) and b.id in shapeish
            } | {
                "shape" for b in ast.walk(val)
                if (isinstance(b, ast.Attribute) and b.attr in ("shape",))
                or (isinstance(b, ast.Call) and (
                    _dotted(b.func) == "len"
                    or (isinstance(b.func, ast.Attribute) and b.func.attr in ("size", "numel"))
                ))
            }
            if raw and not rounded:
                shapeish.update(n for n in names if n not in _GEOMETRY)
            bad = [n for n in names if n in _GEOMETRY]
            if bad and raw and not rounded and not _suppressed(mod, sub.lineno, PLAN_BOUND):
                out.append(Finding(
                    path=mod.path, line=sub.lineno, col=0, rule=PLAN_BOUND,
                    message=(
                        f"launch geometry {', '.join(sorted(bad))} in {fn.qname} "
                        f"derives from a raw data shape ({', '.join(sorted(raw))}) "
                        f"with no rounding — derive it from a rounding helper, "
                        f"the plan memo or module constants"
                    ),
                    witness_paths=(mod.path,),
                ))
        return out

    # -- HSL025: borrowed-buffer mutation --------------------------------------

    def borrowed_findings(self) -> list[Finding]:
        out: list[Finding] = []
        prog = self.program
        producers: list[dict] = []
        gateways: list[dict] = []
        for q in sorted(prog.functions):
            fn = prog.functions[q]
            mod = prog.modules[fn.module]
            made_here = [
                s for s in ast.walk(fn.node)
                if isinstance(s, ast.Call) and _dotted(s.func).rsplit(".", 1)[-1] in _PRODUCERS
                and _dotted(s.func).split(".")[0] == "torch"
            ]
            if not made_here:
                continue
            for s in made_here:
                producers.append({
                    "fn": q, "line": s.lineno, "kind": _dotted(s.func).rsplit(".", 1)[-1],
                })
            if _is_gateway(fn.node):
                gateways.append({"fn": q, "line": fn.line})
            for line, name, how in _borrowed_mutations(fn.node):
                if _suppressed(mod, line, BORROWED_MUTATION):
                    continue
                out.append(Finding(
                    path=mod.path, line=line, col=0, rule=BORROWED_MUTATION,
                    message=(
                        f"in-place {how} on {name!r} in {q}, a tensor made over "
                        f"a buffer it does not own (torch.from_numpy / "
                        f"frombuffer / as_tensor) — a read-only Arrow column "
                        f"would be written through; copy first "
                        f"(execution/table.py::to_tensor) or work on a clone"
                    ),
                    witness_paths=(mod.path,),
                ))
        self._borrowed = {
            "producers": producers,
            "gateways": gateways,
            "proven": not out,
        }
        return out

    # -- HSL026: the launch contract -------------------------------------------

    def contract_findings(self) -> list[Finding]:
        out: list[Finding] = []
        prog = self.program
        declared = self.known_kernels
        for site in self.sites:
            fn = prog.functions[site.body]
            mod = prog.modules[fn.module]
            if site.wrapper is None and not _suppressed(mod, site.line, LAUNCH_CONTRACT):
                out.append(Finding(
                    path=mod.path, line=site.line, col=0, rule=LAUNCH_CONTRACT,
                    message=(
                        f"count_launch in {site.body} names no program function "
                        f"— the launch count must name its wrapper"
                    ),
                ))
        for proof in self._proofs:
            w = proof["wrapper"]
            wfn = prog.functions[w]
            mod = prog.modules[wfn.module]
            line = proof["count_launch"]["line"] if proof["count_launch"] else wfn.line
            cmod = prog.modules[prog.functions[proof["count_launch"]["fn"]].module] \
                if proof["count_launch"] else mod
            witness = tuple(dict.fromkeys(
                prog.modules[prog.functions[q].module].path for q in proof["closure"]
            ))

            def report(msg: str, at_mod=cmod, at_line=line) -> None:
                if not _suppressed(at_mod, at_line, LAUNCH_CONTRACT):
                    out.append(Finding(
                        path=at_mod.path, line=at_line, col=0, rule=LAUNCH_CONTRACT,
                        message=msg, witness_paths=witness,
                    ))

            if declared is not None and proof["kernel"] not in declared:
                report(
                    f"kernel wrapper {proof['kernel']!r} is not declared in "
                    f"ops.KNOWN_KERNELS — declare it so its launch contract is "
                    f"proven and its launches held on the card"
                )
            missing = []
            if proof["plain"] is None:
                missing.append(f"(a) a CPU branch calling its plain version "
                               f"{w.rsplit('.', 1)[-1]}_plain")
            if proof["count_launch"] is None:
                missing.append("(b) count_launch(wrapper) on the CUDA side")
            if proof["status_raise"] is None:
                missing.append("(c) `if err != 0: raise HyperspaceError(...)` on the CUDA status")
            if proof["fallback"] is not None:
                missing.append(f"(d) no fallback: {proof['fallback']['why']} "
                               f"({proof['fallback']['fn']}:{proof['fallback']['line']})")
            if len(proof["load_names"]) != 1:
                missing.append(f"one kernels.load(<name>) engagement (found "
                               f"{proof['load_names'] or 'none'})")
            elif self.sources is not None and proof["load_names"][0] not in self.sources:
                missing.append(f"kernels.SOURCES entry for load({proof['load_names'][0]!r})")
            elif proof["load_names"][0] != proof["kernel"].rsplit(".", 1)[-1]:
                missing.append(f"load name {proof['load_names'][0]!r} equal to the "
                               f"wrapper's name")
            if missing:
                report(
                    f"kernel {proof['kernel']!r} breaks its launch contract: "
                    + "; ".join(missing)
                )
        found = {p["kernel"] for p in self._proofs}
        loaded = {n for p in self._proofs for n in p["load_names"]}
        if declared is not None:
            site = _registry_site(prog, "KNOWN_KERNELS")
            if site is not None:
                mod, line = site
                for name in sorted(declared - found):
                    if not _suppressed(mod, line, LAUNCH_CONTRACT):
                        out.append(Finding(
                            path=mod.path, line=line, col=0, rule=LAUNCH_CONTRACT,
                            message=(
                                f"KNOWN_KERNELS entry {name!r} matches no counted "
                                f"kernel wrapper in the scanned program — remove "
                                f"the stale entry (the declared-registry contract)"
                            ),
                            witness_paths=(mod.path,),
                        ))
        if self.sources is not None and self._proofs:
            site = _registry_site(prog, "SOURCES")
            if site is not None:
                mod, line = site
                for name in sorted(set(self.sources) - loaded):
                    if not _suppressed(mod, line, LAUNCH_CONTRACT):
                        out.append(Finding(
                            path=mod.path, line=line, col=0, rule=LAUNCH_CONTRACT,
                            message=(
                                f"kernels.SOURCES entry {name!r} is loaded by no "
                                f"kernel wrapper — a source nothing launches, or "
                                f"a launch the contract cannot see"
                            ),
                            witness_paths=(mod.path,),
                        ))
        return out

    # -- findings --------------------------------------------------------------

    def findings(self) -> list[Finding]:
        if self._findings is None:
            out: list[Finding] = []
            out += self.purity_findings()
            out += self.plan_findings()
            out += self.borrowed_findings()
            out += self.contract_findings()
            self._findings = out
        return self._findings

    def kernel_proofs(self) -> list[dict]:
        return self._proofs

    def to_json(self) -> dict:
        self.findings()  # materialize the borrowed-buffer proof
        return {
            "launch_bodies": [
                {"fn": s.body, "line": s.line, "wrapper": s.wrapper}
                for s in sorted(self.sites, key=lambda s: (s.body, s.line))
            ],
            "closures": {
                w: {q: list(chain) for q, chain in sorted(c.items())}
                for w, c in sorted(self.closures.items())
            },
            "sanctioned": sorted(self.sanctioned),
            "known_kernels": sorted(self.known_kernels) if self.known_kernels is not None else None,
            "sources": sorted(self.sources) if self.sources is not None else None,
            "unresolved": {
                "total": self.calls_total,
                "unresolved": self.calls_unresolved,
                "ratio": self.unresolved_ratio(),
            },
            "borrowed_buffers": self._borrowed,
            "kernels": self._proofs,
        }


def _effect(sub: ast.AST) -> str | None:
    """The host effect `sub` performs, or None."""
    if isinstance(sub, (ast.With, ast.AsyncWith)):
        for item in sub.items:
            if isinstance(item.context_expr, (ast.Name, ast.Attribute)):
                return "lock acquire"
        return None
    if not isinstance(sub, ast.Call):
        return None
    dotted = _dotted(sub.func)
    parts = dotted.split(".") if dotted else []
    tail = parts[-1] if parts else ""
    if tail == "increment":
        return "stats counter increment"
    if tail == "emit":
        return "event emit"
    if tail in ("fault_point", "inject"):
        return "fault-point evaluation"
    if tail == "open" or tail in _FILE_IO_TAILS:
        return "file IO"
    if dotted in _WALLCLOCK:
        return f"wall-clock read {dotted}()"
    if len(parts) >= 2 and parts[-2] == "conf" and tail in ("get", "set"):
        return f"configuration {tail} via conf"
    if tail == "acquire":
        return "explicit lock acquire"
    return None


def _status_test(test: ast.AST) -> bool:
    """``err != 0`` / ``0 != err`` / ``err``: a non-zero status test."""
    if isinstance(test, ast.Name):
        return True
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and isinstance(test.ops[0], ast.NotEq):
        sides = (test.left, test.comparators[0])
        return any(isinstance(s, ast.Constant) and s.value == 0 for s in sides)
    return False


def _raises_hyperspace_error(body: list[ast.AST]) -> bool:
    for stmt in body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Raise) and sub.exc is not None:
                exc = sub.exc.func if isinstance(sub.exc, ast.Call) else sub.exc
                if _dotted(exc).rsplit(".", 1)[-1] == "HyperspaceError":
                    return True
    return False


def _producer_root(val: ast.AST) -> bool:
    """True when `val` is a producer call, possibly chained through
    alias-keeping methods (``torch.from_numpy(a).to(device)``)."""
    while isinstance(val, ast.Call) and isinstance(val.func, ast.Attribute) \
            and val.func.attr in _ALIAS_METHODS and not _dotted(val.func).startswith("torch."):
        val = val.func.value
    return (
        isinstance(val, ast.Call)
        and _dotted(val.func).rsplit(".", 1)[-1] in _PRODUCERS
        and _dotted(val.func).split(".")[0] == "torch"
    )


def _is_gateway(fn_node: ast.AST) -> bool:
    """A copying gateway: wraps a buffer only after copying a read-only
    one (``if not arr.flags.writeable: arr = arr.copy()``)."""
    has_writeable = any(
        isinstance(s, ast.Attribute) and s.attr == "writeable" for s in ast.walk(fn_node)
    )
    has_copy = any(
        isinstance(s, ast.Call) and isinstance(s.func, ast.Attribute) and s.func.attr == "copy"
        for s in ast.walk(fn_node)
    )
    return has_writeable and has_copy


def _borrowed_mutations(fn_node: ast.AST) -> list[tuple[int, str, str]]:
    """(line, name, how) for every in-place op on a name bound to a
    producer, before the name is bound again."""
    binds: dict[str, list[tuple[int, bool]]] = {}
    for s in ast.walk(fn_node):
        if isinstance(s, ast.Assign):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    binds.setdefault(t.id, []).append((s.lineno, _producer_root(s.value)))
    if not any(p for v in binds.values() for _, p in v):
        return []

    def borrowed_at(name: str, line: int) -> bool:
        before = [(ln, p) for ln, p in binds.get(name, []) if ln < line]
        return bool(before) and max(before)[1]

    out: list[tuple[int, str, str]] = []
    for s in ast.walk(fn_node):
        if isinstance(s, ast.Call):
            f = s.func
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                    and f.attr.endswith("_") and not f.attr.endswith("__") \
                    and borrowed_at(f.value.id, s.lineno):
                out.append((s.lineno, f.value.id, f".{f.attr}()"))
            for kw in s.keywords:
                if kw.arg == "out" and isinstance(kw.value, ast.Name) \
                        and borrowed_at(kw.value.id, s.lineno):
                    out.append((s.lineno, kw.value.id, "out= write"))
        elif isinstance(s, ast.Assign):
            for t in s.targets:
                if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                        and borrowed_at(t.value.id, s.lineno):
                    out.append((s.lineno, t.value.id, "slice assignment"))
        elif isinstance(s, ast.AugAssign):
            t = s.target
            root = t.value if isinstance(t, ast.Subscript) else t
            if isinstance(root, ast.Name) and borrowed_at(root.id, s.lineno):
                out.append((s.lineno, root.id, "augmented assignment"))
    return sorted(set(out))
