"""The port's unified static-analysis check: lint + whole-program
rules + baseline.

    python -m hyperspace_tpu_torch.analysis.check [paths...] [--format json|sarif]
        [--changed] [--write-baseline] [--write-config-docs] [--write-error-docs]

One command runs everything the analysis subsystem checks over the port
(``hyperspace_tpu_torch/`` and ``chip_smoke.py`` by default, every file,
no subset), parsing every file exactly ONCE and feeding the same AST to
the per-file linter (HSL001-HSL008, analysis/lint.py) and the
whole-program engine (analysis/program.py → callgraph.py → locks.py):

- **HSL009 lock-order inversion** — the static lock-acquisition graph
  must be cycle-free; findings carry a two-chain witness.
- **HSL010 config-key drift** — every ``hyperspace.*`` key that is
  get/set (or declared as a module constant) must be declared in
  ``config.KNOWN_KEYS``; declared keys never read anywhere are dead; the
  generated key table in docs/torch/configuration.md must match the
  registry (``--write-config-docs`` regenerates it). The registry is
  read from ``hyperspace_tpu_torch/config.py`` by AST.
- **HSL011 resource/exception safety** — locks/spans/files acquired
  outside ``with``/``try-finally`` on a path that can raise.
- **HSL012 fault-point coverage** — ``faults.KNOWN_POINTS`` (read by
  AST) and the ``fault_point()``/``inject()`` call sites must agree in
  both directions.
- **HSL013 lockset data race** and **HSL014 atomicity violation** over
  the effect summaries (analysis/effects.py → races.py).
- **HSL015 memo-key hygiene** — launch-plan memo keys from per-call
  values; ``ops`` plan tables filled outside ``kernels.memo``.
- **HSL016-018** — error-contract drift against
  ``exceptions.ERROR_CONTRACTS`` (generated docs/torch/errors.md,
  ``--write-error-docs``), swallowed crash/fault handlers, and the
  static unwind-safety proof over ``faults.KNOWN_POINTS``.
- **HSL019-022 process domains** (analysis/procdomain.py) — spawn-import
  purity (no jax, jaxlib or JAX package import and no CUDA touch at
  module level in what a worker imports at start), exchange-surface
  typing (no tensor, CUDA stream or event crosses), the shared-file
  protocol, cross-boundary continuity. The modules each spawn entry
  point's worker imports at start land in ``spawn_domain_by_entry``.
- **HSL023-026 launch domains** (analysis/tracedomain.py) — launch
  effect purity, launch-plan boundedness, borrowed-buffer mutation, and
  the launch contract over ``ops.KNOWN_KERNELS`` and
  ``kernels.SOURCES``: one proof per kernel in the report's
  ``launch_domains.kernels``, which chip_smoke.py joins with the card's
  launch counts.
- **HSL027-030 durability domains** (analysis/duradomain.py) — atomic
  publish, torn-window ordering, replay idempotence and snapshot-stamp
  discipline over ``DURABLE_ROOTS``, ``TORN_WINDOWS`` and
  ``REPLAY_ROOTS``.
- **Validator corpus** — known-good / known-bad logical plans through
  the port's plan validator (analysis/validator.py).

**Baseline.** The check fails only on findings not present in
``hyperspace_tpu_torch/analysis/baseline.json`` (``--write-baseline``
refreshes it); the committed baseline is empty, so every finding fails.

``--format sarif`` renders the findings as SARIF 2.1.0; ``--changed``
restricts reporting to files changed against git's ``origin/main``,
``main`` or ``HEAD`` while the engine still indexes the whole program.
Exit codes are format-independent: 0 = clean (no new findings), 1 = new
findings, 2 = the analyzer itself crashed. The JSON report also lists
the forbidden modules (``jax*``, ``hyperspace_tpu*``) the run loaded:
there must be none.
"""

from __future__ import annotations

import argparse
import ast
import json
import pathlib
import sys

from hyperspace_tpu_torch.analysis import lint as lint_mod
from hyperspace_tpu_torch.analysis.callgraph import CallGraph
from hyperspace_tpu_torch.analysis.effects import Effects
from hyperspace_tpu_torch.analysis.lint import (
    EXIT_CLEAN,
    EXIT_FINDINGS,
    EXIT_INTERNAL_ERROR,
    Finding,
    RULES,
)
from hyperspace_tpu_torch.analysis.duradomain import DurabilityDomains
from hyperspace_tpu_torch.analysis.locks import LockGraph, resource_findings
from hyperspace_tpu_torch.analysis.procdomain import ProcessDomains
from hyperspace_tpu_torch.analysis.tracedomain import LaunchDomains
from hyperspace_tpu_torch.analysis.program import Program, _index_module, _module_name
from hyperspace_tpu_torch.analysis.races import (
    atomicity_findings,
    lockset_race_findings,
    memo_hygiene_findings,
)
from hyperspace_tpu_torch.analysis.raises import (
    DYNAMIC,
    Raises,
    declared_contracts,
    error_contract_findings,
    swallowed_findings,
    unwind_findings,
)

CONFIG_DRIFT = "HSL010"
FAULT_COVERAGE = "HSL012"
CONTRACT_DRIFT = "HSL016"

PACKAGE = "hyperspace_tpu_torch"
BASELINE_NAME = "hyperspace_tpu_torch/analysis/baseline.json"
CONFIG_DOC = "docs/torch/configuration.md"
ERRORS_DOC = "docs/torch/errors.md"
DOCS_BEGIN = "<!-- KNOWN_KEYS:begin (generated from config.KNOWN_KEYS — edit hyperspace_tpu_torch/config.py, then run python -m hyperspace_tpu_torch.analysis.check --write-config-docs) -->"
DOCS_END = "<!-- KNOWN_KEYS:end -->"
ERRORS_BEGIN = "<!-- ERROR_CONTRACTS:begin (generated from exceptions.ERROR_CONTRACTS + the HSL016 escape analysis — edit hyperspace_tpu_torch/exceptions.py, then run python -m hyperspace_tpu_torch.analysis.check --write-error-docs) -->"
#: Module roots the analyzer must never load (it runs where JAX is absent).
FORBIDDEN_ROOTS = ("jax", "jaxlib", "hyperspace_tpu")
ERRORS_END = "<!-- ERROR_CONTRACTS:end -->"


def _repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent.parent.parent


def default_paths(root: pathlib.Path) -> list[pathlib.Path]:
    out = []
    for rel in (PACKAGE, "chip_smoke.py"):
        p = root / rel
        if p.exists():
            out.append(p)
    return out


# -- shared-parse loading -----------------------------------------------------

def load_sources(paths: list[pathlib.Path]) -> tuple[list, list[Finding]]:
    """Parse every .py under `paths` once. Returns ([(name, path, source,
    tree)], findings-for-unparseable-files)."""
    sources, findings = [], []
    for p in paths:
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            try:
                src = f.read_text()
            except OSError as e:
                findings.append(Finding(str(f), 0, 0, "HSL000", f"unreadable: {e}"))
                continue
            try:
                tree = ast.parse(src, filename=str(f))
            except SyntaxError as e:
                findings.append(Finding(str(f), e.lineno or 0, e.offset or 0,
                                        "HSL000", f"syntax error: {e.msg}"))
                continue
            sources.append((_module_name(f), str(f), src, tree))
    return sources, findings


def build_program(sources: list) -> Program:
    modules = {name: _index_module(name, path, src, tree)
               for name, path, src, tree in sources}
    return Program(modules)


# -- the package's registries, read by AST (never imported) -------------------

def _package_file(name: str) -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent.parent / name


def _module_constants(tree: ast.Module) -> dict[str, str]:
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
    return out


def config_registry() -> dict[str, tuple[str, str]]:
    """``config.KNOWN_KEYS`` in declaration order: key -> (rendered
    default, doc), read from hyperspace_tpu_torch/config.py's AST (keys
    spelled as module constants or literals, values ``ConfKey(default,
    doc)`` of string constants)."""
    tree = ast.parse(_package_file("config.py").read_text())
    consts = _module_constants(tree)
    for node in tree.body:
        target = value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        if not (isinstance(target, ast.Name) and target.id == "KNOWN_KEYS"):
            continue
        out: dict[str, tuple[str, str]] = {}
        for k, v in zip(value.keys, value.values):
            key = k.value if isinstance(k, ast.Constant) else consts[k.id]
            args = [a.value for a in v.args if isinstance(a, ast.Constant)]
            if len(args) != 2:
                raise ValueError(f"config.KNOWN_KEYS[{key!r}] is not ConfKey(default, doc)")
            out[key] = (args[0], args[1])
        return out
    raise ValueError("config.py declares no KNOWN_KEYS")


def docs_table() -> str:
    """The registry as ``config.docs_table()`` renders it: key, default,
    meaning."""
    lines = ["| Key | Default | Meaning |", "|---|---|---|"]
    for key, (default, doc) in config_registry().items():
        lines.append(f"| `{key}` | {default} | {doc} |")
    return "\n".join(lines)


def known_points() -> tuple[str, ...]:
    """``faults.KNOWN_POINTS``, read from hyperspace_tpu_torch/faults.py's
    AST."""
    tree = ast.parse(_package_file("faults.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "KNOWN_POINTS":
            return tuple(e.value for e in node.value.elts if isinstance(e, ast.Constant))
    raise ValueError("faults.py declares no KNOWN_POINTS")


# -- HSL010: config-key drift -------------------------------------------------

def config_key_findings(program: Program, usage_dirs: list[pathlib.Path]) -> list[Finding]:
    declared = set(config_registry())
    findings: list[Finding] = []
    config_module_names = {m.name for m in program.modules.values()
                           if m.path.endswith(f"{PACKAGE}/config.py")}

    used: set[str] = set()
    # get/set call sites
    for fn in sorted(program.functions.values(), key=lambda f: (f.module, f.line)):
        mod = program.modules[fn.module]
        for acc in fn.config_accesses:
            used.add(acc.key)
            if acc.key in declared:
                continue
            if _suppressed(mod, acc.line, CONFIG_DRIFT):
                continue
            import difflib

            close = difflib.get_close_matches(acc.key, declared, n=1, cutoff=0.6)
            hint = f" — did you mean {close[0]!r}?" if close else ""
            findings.append(Finding(
                mod.path, acc.line, 0, CONFIG_DRIFT,
                f"config {'set' if acc.write else 'get'} of undeclared key "
                f"{acc.key!r}{hint} (declare it in config.KNOWN_KEYS; the "
                f"runtime rejects it too)",
            ))
    # hyperspace.* constants declared outside config.py
    for mod in program.modules.values():
        if mod.name in config_module_names:
            continue
        for name, val in sorted(mod.const_strings.items()):
            if val.startswith("hyperspace.") and val not in declared:
                findings.append(Finding(
                    mod.path, 0, 0, CONFIG_DRIFT,
                    f"module constant {name} declares key {val!r} outside "
                    f"config.KNOWN_KEYS — every hyperspace.* key lives in the "
                    f"one registry (move the declaration to config.py)",
                ))
    # dead keys: declared in KNOWN_KEYS but consumed by NOTHING — not
    # wired into the conf get/set dispatch, never get/set by key, never
    # referenced by constant name in another module, and never spelled
    # literally in the usage scan (tests). The registry-only key is the
    # drift this catches: documented, settable, and ignored. Only
    # meaningful when config.py itself is in the scanned set (a corpus
    # file scanned alone must not report the whole registry dead).
    if not config_module_names:
        return findings
    const_of_key = {}
    wired: set[str] = set()
    for mname in config_module_names:
        mod = program.modules[mname]
        for cname, val in mod.const_strings.items():
            const_of_key[val] = cname
        wired |= {const for const in _dispatch_references(mod.tree)}
    other_sources = [m.source for m in program.modules.values()
                     if m.name not in config_module_names]
    for d in usage_dirs:
        for f in sorted(d.rglob("*.py")) if d.is_dir() else [d]:
            try:
                other_sources.append(f.read_text())
            except OSError:
                continue
    config_paths = [program.modules[m].path for m in config_module_names]
    for key in sorted(declared - used):
        cname = const_of_key.get(key)
        if cname is not None and cname in wired:
            continue
        if any(
            (cname is not None and cname in src) or key in src
            for src in other_sources
        ):
            continue
        findings.append(Finding(
            config_paths[0] if config_paths else f"{PACKAGE}/config.py", 0, 0,
            CONFIG_DRIFT,
            f"declared key {key!r} is dead: not wired into the conf get/set "
            f"dispatch and never referenced anywhere — wire it up or delete "
            f"it from KNOWN_KEYS",
        ))
    return findings


def _dispatch_references(config_tree: ast.Module) -> set[str]:
    """Constant names config.py references OUTSIDE their own definition
    and the KNOWN_KEYS literal — i.e. names the get/set dispatch (or any
    other real code) actually consumes."""
    skip_ids: set[int] = set()
    for node in ast.walk(config_tree):
        if isinstance(node, ast.Assign):
            is_const_def = any(
                isinstance(t, ast.Name) and t.id.isupper() for t in node.targets
            )
            is_registry = any(
                isinstance(t, ast.Name) and t.id == "KNOWN_KEYS" for t in node.targets
            )
            if is_registry:
                for sub in ast.walk(node.value):
                    skip_ids.add(id(sub))
            elif is_const_def and isinstance(node.value, ast.Constant):
                for t in node.targets:
                    skip_ids.add(id(t))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name) and node.target.id == "KNOWN_KEYS":
                for sub in ast.walk(node.value):
                    skip_ids.add(id(sub))
    return {
        node.id
        for node in ast.walk(config_tree)
        if isinstance(node, ast.Name)
        and isinstance(node.ctx, ast.Load)
        and node.id.isupper()
        and id(node) not in skip_ids
    }


_CONFIG_DOC_SKELETON = """# Configuration keys of the port

Every `hyperspace.*` key `hyperspace_tpu_torch` declares in
`config.KNOWN_KEYS` (the JAX package's keys, in its order, with its
rendered defaults). `HyperspaceConf.get/set` reject an undeclared key
with `UnknownConfigKeyError`; rule HSL010 keeps this table equal to the
registry (docs/torch/static_analysis.md). The table is generated: edit
`hyperspace_tpu_torch/config.py`, then run
`python -m hyperspace_tpu_torch.analysis.check --write-config-docs`.

{begin}
{table}
{end}
"""


def docs_findings(root: pathlib.Path) -> list[Finding]:
    """The generated key table in docs/torch/configuration.md must match
    config.KNOWN_KEYS exactly."""
    doc = root / CONFIG_DOC
    stale = [Finding(str(doc), 0, 0, CONFIG_DRIFT,
                     f"{CONFIG_DOC} is missing or its key table is stale "
                     f"relative to config.KNOWN_KEYS — run python -m "
                     f"{PACKAGE}.analysis.check --write-config-docs")]
    if not doc.exists():
        return stale
    text = doc.read_text()
    if DOCS_BEGIN not in text or DOCS_END not in text:
        return stale
    current = text.split(DOCS_BEGIN, 1)[1].split(DOCS_END, 1)[0].strip()
    return stale if current != docs_table().strip() else []


def write_config_docs(root: pathlib.Path) -> bool:
    doc = root / CONFIG_DOC
    table = docs_table()
    if not doc.exists() or DOCS_BEGIN not in doc.read_text():
        doc.parent.mkdir(parents=True, exist_ok=True)
        doc.write_text(_CONFIG_DOC_SKELETON.format(begin=DOCS_BEGIN, table=table, end=DOCS_END))
        return True
    text = doc.read_text()
    head, rest = text.split(DOCS_BEGIN, 1)
    _, tail = rest.split(DOCS_END, 1)
    doc.write_text(f"{head}{DOCS_BEGIN}\n{table}\n{DOCS_END}{tail}")
    return True


# -- HSL016: docs/torch/errors.md error-contract table ------------------------------

def errors_table(program, raises_obj: Raises, contracts: dict) -> str:
    """The generated contract table: one row per entry point, declared
    surface next to the statically observed escape set (``(dynamic)``
    marks re-raises of stored/registered exception objects the static
    analysis cannot type)."""
    lines = [
        "| entry point | declared contract | statically observed escapes |",
        "|---|---|---|",
    ]
    for qname in sorted(contracts):
        types, _, _ = contracts[qname]
        esc = raises_obj.escapes.get(qname, {})
        observed = sorted(t for t in esc if t != DYNAMIC)
        if DYNAMIC in esc:
            observed.append("(dynamic)")
        lines.append(
            f"| `{qname}` | {', '.join(f'`{t}`' for t in types) or '—'} "
            f"| {', '.join(f'`{t}`' for t in observed) or '—'} |"
        )
    return "\n".join(lines)


_ERRORS_DOC_SKELETON = """# Error contracts of the port

The typed error surface of every public entry point of
`hyperspace_tpu_torch`, declared in `exceptions.ERROR_CONTRACTS` and
statically verified by rule HSL016 (docs/torch/static_analysis.md): any
exception type that can escape an entry point without being covered by
its declared contract — modulo the exception hierarchy — fails the
check, and so does a declared program-local type that covers nothing.
The table below is generated; edit `hyperspace_tpu_torch/exceptions.py`,
then run `python -m hyperspace_tpu_torch.analysis.check --write-error-docs`.

{begin}
{table}
{end}

An entry covers its subclasses: `HyperspaceError` covers
`IndexCorruptionError`, `PlanValidationError`, `AdmissionRejected`,
`QueryTimeout`; `OSError` covers real disk failures and the injected
`FaultError`. `CrashPoint` (a `BaseException`) is the simulated hard
process death — it appears in the contracts because it must escape
these APIs untouched. `(dynamic)` marks a re-raise of a stored exception
object the static analysis cannot type.
"""


def errors_docs_findings(root: pathlib.Path, program, raises_obj: Raises,
                         contracts: dict) -> list[Finding]:
    """docs/torch/errors.md must exist and its generated table must match the
    registry + analysis exactly (the HSL010 config-docs pattern)."""
    if not any(q.startswith(PACKAGE + ".") for q in contracts):
        return []  # scanning a corpus subset, not the package
    doc = root / ERRORS_DOC
    stale = Finding(str(doc), 0, 0, CONTRACT_DRIFT,
                    f"{ERRORS_DOC} error-contract table is missing or stale "
                    f"relative to exceptions.ERROR_CONTRACTS — run python -m "
                    f"{PACKAGE}.analysis.check --write-error-docs")
    if not doc.exists():
        return [stale]
    text = doc.read_text()
    if ERRORS_BEGIN not in text or ERRORS_END not in text:
        return [stale]
    current = text.split(ERRORS_BEGIN, 1)[1].split(ERRORS_END, 1)[0].strip()
    if current != errors_table(program, raises_obj, contracts).strip():
        return [stale]
    return []


def write_error_docs(root: pathlib.Path, program, raises_obj: Raises,
                     contracts: dict) -> bool:
    doc = root / ERRORS_DOC
    table = errors_table(program, raises_obj, contracts)
    if not doc.exists() or ERRORS_BEGIN not in doc.read_text():
        doc.parent.mkdir(parents=True, exist_ok=True)
        doc.write_text(_ERRORS_DOC_SKELETON.format(
            begin=ERRORS_BEGIN, table=table, end=ERRORS_END,
        ))
        return True
    text = doc.read_text()
    head, rest = text.split(ERRORS_BEGIN, 1)
    _, tail = rest.split(ERRORS_END, 1)
    doc.write_text(f"{head}{ERRORS_BEGIN}\n{table}\n{ERRORS_END}{tail}")
    return True


# -- dead-symbol report (informational) ---------------------------------------

def dead_symbol_report(program, callgraph, raises_obj: Raises, contracts: dict) -> dict:
    """Functions unreachable from any public entry point through the
    dispatch-augmented call graph. Informational ONLY — the resolver is
    deliberately under-approximate (dynamic dispatch through untyped
    locals, higher-order uses), so a listing here is a lead for a human,
    never a finding."""
    roots = {
        q for q, fn in program.functions.items() if not fn.name.startswith("_")
    }
    roots |= {q for q in contracts if q in program.functions}
    adj: dict[str, set[str]] = {}
    for e in callgraph.edges:
        slot = adj.setdefault(e.caller, set())
        for t in raises_obj.dispatch_targets(e.callee):
            slot.add(t)
    reach = set(roots)
    stack = list(roots)
    while stack:
        q = stack.pop()
        for nxt in adj.get(q, ()):
            if nxt not in reach:
                reach.add(nxt)
                stack.append(nxt)
    dead = sorted(
        q for q, fn in program.functions.items()
        if q not in reach and not fn.name.startswith("__")
    )
    return {"count": len(dead), "functions": dead}


# -- HSL012: fault-point coverage ---------------------------------------------

def fault_point_findings(program: Program) -> list[Finding]:
    declared = set(known_points())
    findings: list[Finding] = []
    threaded: set[str] = set()
    faults_path = None
    for fn in sorted(program.functions.values(), key=lambda f: (f.module, f.line)):
        mod = program.modules[fn.module]
        if mod.path.endswith(f"{PACKAGE}/faults.py"):
            faults_path = mod.path
            continue  # the harness's own docstrings/validation, not call sites
        for name, line, kind in fn.fault_refs:
            if kind == "point" and fn.module.startswith(PACKAGE + "."):
                threaded.add(name)
            if name not in declared and not _suppressed(mod, line, FAULT_COVERAGE):
                findings.append(Finding(
                    mod.path, line, 0, FAULT_COVERAGE,
                    f"fault point {name!r} is not declared in "
                    f"faults.KNOWN_POINTS — an undeclared name can never fire "
                    f"a registered rule (fix the typo or declare it)",
                ))
    for mod in program.modules.values():
        if mod.path.endswith(f"{PACKAGE}/faults.py"):
            faults_path = mod.path
    if not any(m.startswith(PACKAGE + ".") for m in program.modules):
        # Coverage direction needs the package in the scanned set; a
        # corpus file scanned alone must not report every point missing.
        return findings
    for point in sorted(declared - threaded):
        findings.append(Finding(
            faults_path or f"{PACKAGE}/faults.py", 0, 0, FAULT_COVERAGE,
            f"declared fault point {point!r} is never threaded through a "
            f"fault_point() call site — the crash sweep cannot exercise it; "
            f"thread it or remove it from KNOWN_POINTS",
        ))
    return findings


def _suppressed(mod, line: int, rule: str) -> bool:
    lines = mod.lines
    text = lines[line - 1] if 0 < line <= len(lines) else ""
    if "# noqa" not in text:
        return False
    tail = text.split("# noqa", 1)[1]
    return not tail.strip().startswith(":") or rule in tail


# -- validator corpus ---------------------------------------------------------

def validator_corpus() -> dict:
    """Self-test the port's plan validator over a tiny known-good /
    known-bad corpus. Returns a JSON-able status dict; `failures`
    non-empty means the validator regressed. The validator is the port's
    own code: a failed import is an internal error, never a skip."""
    from hyperspace_tpu_torch.analysis.validator import validate_plan
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.plan.nodes import Filter, Join, Scan, Sort
    from hyperspace_tpu_torch.schema import Field, Schema
    schema = Schema.of(Field("k", "int32"), Field("v", "float64"),
                       Field("emb", "vector", dim=4))
    right = Scan("/corpus/u", "parquet", Schema.of(Field("k", "int32")))
    base = Scan("/corpus/t", "parquet", schema)
    corpus = [
        ("clean-filter", Filter(base, col("k") > 1), []),
        ("unresolved-column", Filter(base, col("zz") > 1), ["unresolved-column"]),
        ("dtype-predicate", Filter(base, col("emb") > 1), ["dtype-incompatible-predicate"]),
        ("unsortable-key", Sort(base, [("emb", True)]), ["unsortable-key"]),
        ("bucket-mismatch",
         Join(Scan("/corpus/t", "parquet", schema, bucket_spec=(8, ["k"])),
              Scan("/corpus/u", "parquet", Schema.of(Field("k", "int32")),
                   bucket_spec=(16, ["k"])),
              ["k"], ["k"]),
         ["join-bucket-mismatch"]),
        ("clean-join", Join(base, right, ["k"], ["k"]), []),
    ]
    failures = []
    for name, plan, expect in corpus:
        got = [d.rule for d in validate_plan(plan)]
        if got != expect:
            failures.append({"case": name, "expected": expect, "got": got})
    return {"status": "ok" if not failures else "failed",
            "cases": len(corpus), "failures": failures}


# -- SARIF --------------------------------------------------------------------

def to_sarif(findings: list[Finding], baseline: set[tuple], root: pathlib.Path) -> dict:
    """SARIF 2.1.0 form of the findings — the code-scanning artifact CI
    uploads next to the JSON report. Baseline-known findings carry
    ``baselineState: unchanged`` so scanners triage only what's new."""
    rules = [
        {
            "id": r.rule,
            "name": r.slug,
            "shortDescription": {"text": r.summary},
            "properties": {"scope": r.scope},
        }
        for r in sorted(RULES.values(), key=lambda r: r.rule)
    ]
    results = []
    for f in findings:
        path = _finding_key(f, root)[1]
        results.append({
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": path},
                    "region": {"startLine": max(1, f.line)},
                },
            }],
            "baselineState": (
                "unchanged" if tuple(_finding_key(f, root)) in baseline else "new"
            ),
        })
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "hyperspace-analysis",
                    "informationUri": "docs/torch/static_analysis.md",
                    "rules": rules,
                },
            },
            "results": results,
        }],
    }


# -- --changed: restrict findings to files changed vs origin/main -------------

def changed_files(root: pathlib.Path) -> tuple[str, set[str]] | None:
    """(base ref, changed .py paths relative to root) from git, trying
    ``origin/main`` then ``main`` then ``HEAD``; None when git (or the
    repo) is unavailable — the caller falls back to a full run."""
    import subprocess

    for base in ("origin/main", "main", "HEAD"):
        try:
            proc = subprocess.run(
                ["git", "diff", "--name-only", base, "--", "*.py"],
                cwd=root, capture_output=True, text=True, timeout=30,
            )
        except (OSError, subprocess.SubprocessError):
            return None
        if proc.returncode == 0:
            files = {line.strip() for line in proc.stdout.splitlines() if line.strip()}
            return base, files
    return None


def restrict_findings(findings: list[Finding], changed: set[str], root: pathlib.Path) -> list[Finding]:
    """Findings whose (root-relative) path — or ANY file on the witness
    chain — is in the changed set. The engine still indexed the WHOLE
    program; only the reporting surface narrows. Witness files count
    because a cross-module finding is often CAUSED by the edited callee
    while its report line sits in an unchanged caller: dropping those
    made --changed blind to exactly the regressions the whole-program
    rules exist for."""

    def _rel(path: str) -> str:
        try:
            return str(pathlib.Path(path).resolve().relative_to(root))
        except ValueError:
            return path

    return [
        f for f in findings
        if _finding_key(f, root)[1] in changed
        or any(_rel(w) in changed for w in f.witness_paths)
    ]


# -- baseline -----------------------------------------------------------------

def _finding_key(f: Finding, root: pathlib.Path) -> list:
    path = f.path
    try:
        path = str(pathlib.Path(f.path).resolve().relative_to(root))
    except ValueError:
        pass
    return [f.rule, path, f.message]


def load_baseline(path: pathlib.Path) -> set[tuple]:
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return set()
    return {tuple(entry) for entry in data.get("findings", [])}


# -- the check ----------------------------------------------------------------

def run_check(
    paths: list[pathlib.Path],
    root: pathlib.Path,
    usage_dirs: list[pathlib.Path],
) -> dict:
    """Everything except baseline comparison and rendering: returns the
    full report dict (findings as Finding objects under '_findings')."""
    sources, findings = load_sources(paths)
    for name, path, src, tree in sources:
        findings.extend(lint_mod.lint_source(src, path, tree=tree))
    program = build_program(sources)
    callgraph = CallGraph(program)
    lockgraph = LockGraph(program, callgraph)
    effects = Effects(program, callgraph)
    raises_obj = Raises(program, callgraph)
    contracts = declared_contracts(program)
    findings.extend(lockgraph.inversions())
    findings.extend(resource_findings(program))
    findings.extend(config_key_findings(program, usage_dirs))
    findings.extend(docs_findings(root))
    findings.extend(fault_point_findings(program))
    findings.extend(lockset_race_findings(program, effects))
    findings.extend(atomicity_findings(program, effects))
    findings.extend(memo_hygiene_findings(program))
    findings.extend(error_contract_findings(program, raises_obj, contracts))
    findings.extend(errors_docs_findings(root, program, raises_obj, contracts))
    findings.extend(swallowed_findings(program, raises_obj))
    unwind, unwind_proof = unwind_findings(program, callgraph, raises_obj, contracts)
    findings.extend(unwind)
    domains = ProcessDomains(program, callgraph, raises_obj)
    ldomains = LaunchDomains(program, callgraph, raises_obj)
    ddomains = DurabilityDomains(program, callgraph, raises_obj)
    # HSL021 vs HSL027 dedupe: a lease/fleet write site HSL027 now
    # checks reports ONCE, under the newer rule — otherwise every
    # --changed run would double-report the shared sites.
    findings.extend(
        f for f in domains.findings()
        if not (f.rule == "HSL021" and (f.path, f.line) in ddomains.claimed_sites)
    )
    findings.extend(ldomains.findings())
    findings.extend(ddomains.findings())
    kept = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    corpus = validator_corpus()
    if corpus.get("failures"):
        for fail in corpus["failures"]:
            kept.append(Finding(
                f"{PACKAGE}/analysis/validator.py", 0, 0, "HSL000",
                f"validator corpus case {fail['case']!r} regressed: expected "
                f"{fail['expected']}, got {fail['got']}",
            ))
    total_calls = len(callgraph.edges) + len(callgraph.unresolved)
    dead = dead_symbol_report(program, callgraph, raises_obj, contracts)
    contract_fns = _dispatch_closure(
        callgraph, raises_obj, [q for q in contracts if q in program.functions])
    ambiguous = {
        "shadowed": callgraph.shadowed(),
        "contract": [a for a in callgraph.ambiguous if a.caller in contract_fns],
        "launch": [a for a in callgraph.ambiguous if a.caller in ldomains.launch_fns],
    }
    return {
        "_findings": kept,
        "_engine": (program, callgraph, raises_obj, contracts),
        "summary": {
            "files": len(sources),
            "findings": len(kept),
            "functions": len(program.functions),
            "call_edges": len(callgraph.edges),
            # Resolution-quality accounting: the engine's blind spots.
            # A rising unresolved ratio silently weakens every
            # whole-program rule, so tests pin a regression bound on it.
            "calls_unresolved": len(callgraph.unresolved),
            "calls_unresolved_ratio": round(
                len(callgraph.unresolved) / total_calls, 4
            ) if total_calls else 0.0,
            # Calls the unique-method fallback refused because several
            # classes define the name: in all, inside the error-contract
            # and launch closures, and those a class outside the
            # caller's package shadowed (gated at 0: such a collision
            # silently shrinks every proof over the dropped edge).
            "calls_ambiguous": len(callgraph.ambiguous),
            "contract_ambiguous_calls": len(ambiguous["contract"]),
            "launch_ambiguous_calls": len(ambiguous["launch"]),
            "calls_shadowed": len(ambiguous["shadowed"]),
            "locks": len(program.locks),
            "lock_edges": len(lockgraph.order_edges()),
            "shared_states": len(effects.by_state),
            "entry_guaranteed_fns": len(effects.entry_locks),
            "contract_entry_points": len(contracts),
            "fault_points_proven": sum(
                1 for e in unwind_proof.values() if e["covered"]
            ),
            "dead_symbols": dead["count"],
            # Process-domain accounting (HSL019-022): CI asserts the
            # rules actually RAN — a zero entry-point count on the real
            # repo would mean the registry extraction silently broke.
            "spawn_entry_points": len(domains.entry_points),
            "spawn_domain_functions": len(domains.task_fns),
            "spawn_domain_modules": len(domains.domain_modules),
            "spawn_boundary_sites": len(domains.boundary_sites),
            "lease_acquire_sites": len(domains.lease_acquires),
            # Launch-domain accounting (HSL023-026): a zero launch-body
            # count on the real tree would mean count_launch detection
            # silently broke.
            "launch_entry_points": len({s.body for s in ldomains.sites}),
            "launch_domain_functions": len(ldomains.launch_fns),
            "launch_kernels_proven": sum(
                1 for p in ldomains.kernel_proofs() if p["proven"]
            ),
            # The launch closure's blind spots: a launch path calls
            # mostly tensor methods and ctypes, unresolvable by design.
            "launch_domain_unresolved_ratio": ldomains.unresolved_ratio(),
            # Durability-domain accounting (HSL027-030): same CI
            # contract — zero roots/sites/windows on the real repo
            # would mean the registry extraction or write-site
            # detection silently broke.
            "durable_roots": len(ddomains.roots or {}),
            "durable_write_sites": len(ddomains.sites),
            "durable_domain_functions": len(ddomains.domain_fns),
            "torn_windows": len(ddomains.windows or {}),
            "torn_windows_proven": sum(
                1 for p in ddomains._window_proofs.values() if p["proven"]
            ),
            "replay_roots": len(ddomains.replay_roots or {}),
            "replay_closure_functions": len(ddomains.replay_fns),
            "durable_domain_unresolved_ratio": ddomains.unresolved_ratio(),
        },
        "validator_corpus": corpus,
        "lock_graph": lockgraph.to_json(),
        # The HSL018 witness chains: per fault point, the recovery
        # construct that statically reaches each threading site.
        "unwind_proof": unwind_proof,
        # The HSL019-022 substrate: the inferred process-domain graph
        # (entries, task closure, domain modules, boundary sites, lease
        # reap proofs) — procdemo pins its exact shape in a golden.
        "process_domains": domains.to_json(),
        # The HSL023-026 substrate: the inferred launch-domain graph
        # (launch bodies, closures, the borrowed-buffer proof, one
        # launch-contract proof per kernel) — launchdemo pins its exact
        # shape in a golden; chip_smoke.py joins the kernel proofs with
        # the card's launch counts.
        "launch_domains": ldomains.to_json(),
        # The modules each spawn entry point's worker imports at start
        # (chip_smoke.py holds _task_entry's against a real worker).
        "spawn_domain_by_entry": {
            q: sorted(domains.entry_modules(q))
            for q in sorted(domains.live_entries)
        },
        # The HSL027-030 substrate: the inferred durability-domain
        # graph (durable roots + write sites, torn-window proofs with
        # their in-window fault-point witnesses, replay closures,
        # snapshot carriers) — durademo pins its exact shape in a
        # golden.
        "durable_domains": ddomains.to_json(),
        # Informational (never gated): private functions no public entry
        # point reaches through the resolved call graph.
        "dead_symbols": dead,
        "ambiguous_calls": {
            k: [{"caller": a.caller, "line": a.line, "call": a.raw,
                 "owners": list(a.owners)} for a in v]
            for k, v in ambiguous.items()
        },
    }


def _dispatch_closure(callgraph: CallGraph, raises_obj: Raises, roots: list[str]) -> set[str]:
    """Every function the roots reach over the call graph, following
    each resolved callee to its overrides as the escape analysis does."""
    seen = set(roots)
    stack = list(roots)
    while stack:
        for e in callgraph.out.get(stack.pop(), ()):
            for t in raises_obj.dispatch_targets(e.callee):
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
    return seen


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hyperspace_tpu_torch.analysis.check",
        description="Unified static analysis of the port: per-file lint "
                    "(HSL001-HSL008), whole-program rules (HSL009-HSL030), "
                    "validator corpus, findings baseline.",
    )
    ap.add_argument("paths", nargs="*", help="files/directories (default: "
                    "hyperspace_tpu_torch/ and chip_smoke.py)")
    ap.add_argument("--format", choices=("text", "json", "sarif"), default="text")
    ap.add_argument("--output", help="also write the report to this file")
    ap.add_argument("--changed", action="store_true",
                    help="report findings only for files changed vs origin/main "
                         "(the engine still indexes the whole program) — the "
                         "fast local pre-push mode")
    ap.add_argument("--baseline", help=f"baseline file (default: {BASELINE_NAME} "
                    "at the repo root when present)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings as the new baseline")
    ap.add_argument("--write-config-docs", action="store_true",
                    help=f"regenerate the {CONFIG_DOC} key table from "
                         "config.KNOWN_KEYS and exit")
    ap.add_argument("--write-error-docs", action="store_true",
                    help=f"regenerate the {ERRORS_DOC} contract table from "
                         "exceptions.ERROR_CONTRACTS + the escape analysis "
                         "and exit")
    ap.add_argument("--no-baseline", action="store_true",
                    help="fail on ALL findings, ignoring any baseline")
    args = ap.parse_args(argv)
    try:
        root = _repo_root()
        if args.write_config_docs:
            ok = write_config_docs(root)
            print(f"{CONFIG_DOC} key table "
                  + ("regenerated" if ok else "markers missing — not rewritten"))
            return EXIT_CLEAN if ok else EXIT_INTERNAL_ERROR
        paths = [pathlib.Path(p) for p in args.paths] or default_paths(root)
        usage_dirs = sorted((root / "tests").glob("test_torch_*.py"))
        report = run_check(paths, root, usage_dirs)
        findings: list[Finding] = report.pop("_findings")
        program, _cg, raises_obj, contracts = report.pop("_engine")
        if args.write_error_docs:
            write_error_docs(root, program, raises_obj, contracts)
            print(f"{ERRORS_DOC} error-contract table regenerated")
            return EXIT_CLEAN
        if args.changed:
            got = changed_files(root)
            if got is None:
                print("--changed: git unavailable — running on everything",
                      file=sys.stderr)
            else:
                base, files = got
                findings = restrict_findings(findings, files, root)
                report["changed"] = {"base": base, "files": sorted(files)}
        baseline_path = pathlib.Path(args.baseline) if args.baseline else root / BASELINE_NAME
        if args.write_baseline:
            baseline_path.write_text(json.dumps(
                {"findings": sorted(_finding_key(f, root) for f in findings)},
                indent=2, sort_keys=True,
            ) + "\n")
            print(f"baseline written: {baseline_path} ({len(findings)} finding(s))")
            return EXIT_CLEAN
        baseline = set() if args.no_baseline else (
            load_baseline(baseline_path) if baseline_path.exists() else set()
        )
        new = [f for f in findings if tuple(_finding_key(f, root)) not in baseline]
        stale = len(baseline) - (len(findings) - len(new))
        report["findings"] = [
            {"rule": f.rule, "slug": RULES[f.rule].slug if f.rule in RULES else f.rule,
             "path": f.path, "line": f.line, "message": f.message,
             "new": tuple(_finding_key(f, root)) not in baseline}
            for f in findings
        ]
        report["baseline"] = {
            "path": str(baseline_path) if baseline_path.exists() else None,
            "known": len(baseline), "stale": max(0, stale), "new": len(new),
        }
        report["summary"]["new_findings"] = len(new)
        report["forbidden_modules"] = sorted(
            m for m in sys.modules if m.split(".")[0] in FORBIDDEN_ROOTS
        )
        if args.format == "sarif":
            rendered = json.dumps(to_sarif(findings, baseline, root), indent=2)
        else:
            rendered = json.dumps(report, indent=2, sort_keys=True)
        if args.output:
            pathlib.Path(args.output).write_text(rendered + "\n")
        if args.format in ("json", "sarif"):
            print(rendered)
        else:
            for f in findings:
                marker = "" if tuple(_finding_key(f, root)) in baseline else " [new]"
                print(f"{f}{marker}")
            s = report["summary"]
            print(
                f"{s['files']} files, {s['functions']} functions, "
                f"{s['locks']} locks ({s['lock_edges']} order edges, cycle-free="
                f"{not any(f.rule == 'HSL009' for f in findings)}); "
                f"{s['findings']} finding(s), {len(new)} new, "
                f"{s['calls_shadowed']} shadowed call(s); validator corpus: "
                f"{report['validator_corpus']['status']}",
                file=sys.stderr,
            )
        return EXIT_FINDINGS if new else EXIT_CLEAN
    except SystemExit:
        raise
    except Exception as e:
        print(f"internal error: {type(e).__name__}: {e}", file=sys.stderr)
        return EXIT_INTERNAL_ERROR


if __name__ == "__main__":
    sys.exit(main())
