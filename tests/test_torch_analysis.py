"""The port's static analyzer (hyperspace_tpu_torch/analysis/) against the
JAX package's.

- The rules that keep their meaning (HSL000, HSL005-014, HSL016-018,
  HSL021, HSL022, HSL027-030): the port's engine over the JAX package's
  fixture packages (lockdemo, racedemo, raisedemo, procdemo, durademo)
  gives the JAX package's goldens and the JAX package's engine's findings
  line for line (file, line and rule; the port's messages point at its own
  docs); over its per-rule corpus files it gives exactly their
  `# expect:` lines for those rules, as the JAX package's engine does.
  (The corpus files are written in JAX idiom: the port's retargeted
  HSL001 flags their `from hyperspace_tpu import ...` lines, so the port's
  findings there are compared for the kept rules.)
- The retargeted rules (HSL001-004, HSL015, HSL019, HSL020, HSL023-026)
  over torch-idiom fixtures, `tests/torch_analysis_fixtures/`: each
  corpus file gives exactly its `# expect:` lines (a line may expect
  several rules), and launchdemo gives its golden and its five planted
  findings. Together the two corpora cover every rule.
- The check's command line: exit codes 0 / 1 / 2, a baseline that masks only old
  findings, SARIF, `python -m hyperspace_tpu_torch.analysis.lint`, and one
  run over the port's tree (every file of the package and chip_smoke.py)
  with no finding, inside 60 s.
- The registries, held to the JAX package's name for name.
"""

import ast
import importlib
import json
import pathlib
import subprocess
import sys
import time

import pytest

from hyperspace_tpu_torch.analysis import check as tcheck
from hyperspace_tpu_torch.analysis.callgraph import CallGraph
from hyperspace_tpu_torch.analysis.lint import EXIT_CLEAN, EXIT_FINDINGS, EXIT_INTERNAL_ERROR, RULES
from hyperspace_tpu_torch.analysis.program import Program
from hyperspace_tpu_torch.analysis.raises import Raises
from hyperspace_tpu_torch.analysis.tracedomain import LaunchDomains

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent
REF_FIXTURES = TESTS / "analysis_fixtures"
FIXTURES = TESTS / "torch_analysis_fixtures"

KEPT = {f"HSL{n:03d}" for n in (0, *range(5, 15), 16, 17, 18, 21, 22, 27, 28, 29, 30)}
RETARGETED = {f"HSL{n:03d}" for n in (1, 2, 3, 4, 15, 19, 20, 23, 24, 25, 26)}
MODULES = ("program", "callgraph", "locks", "effects", "races", "raises", "procdomain", "duradomain",
           "lint", "check")


def _engine(pkg: str) -> dict:
    out = {n: importlib.import_module(f"{pkg}.analysis.{n}") for n in MODULES}
    if pkg == "hyperspace_tpu_torch":
        out["tracedomain"] = importlib.import_module(f"{pkg}.analysis.tracedomain")
    return out


@pytest.fixture(scope="module")
def engines():
    return {"jax": _engine("hyperspace_tpu"), "torch": _engine("hyperspace_tpu_torch")}


def _kept_findings(e: dict, program, callgraph) -> list:
    """Every finding of the kept whole-program rules over one program,
    composed as each package's check.py composes them."""
    out = []
    out += e["locks"].LockGraph(program, callgraph).inversions()
    out += e["locks"].resource_findings(program)
    eff = e["effects"].Effects(program, callgraph)
    out += e["races"].lockset_race_findings(program, eff)
    out += e["races"].atomicity_findings(program, eff)
    raises = e["raises"].Raises(program, callgraph)
    contracts = e["raises"].declared_contracts(program)
    out += e["raises"].error_contract_findings(program, raises, contracts)
    out += e["raises"].swallowed_findings(program, raises)
    out += e["raises"].unwind_findings(program, callgraph, raises, contracts)[0]
    dd = e["duradomain"].DurabilityDomains(program, callgraph, raises)
    out += [f for f in e["procdomain"].ProcessDomains(program, callgraph, raises).findings()
            if not (f.rule == "HSL021" and (f.path, f.line) in dd.claimed_sites)]
    out += dd.findings()
    return out


def _file_findings(e: dict, path: pathlib.Path) -> list:
    """The rule set over one corpus file, as the check composes it: the
    kept rules for both engines, and the port's retargeted ones too."""
    src = path.read_text()
    tree = ast.parse(src)
    name = e["program"]._module_name(path)
    program = e["program"].Program({name: e["program"]._index_module(name, str(path), src, tree)})
    cg = e["callgraph"].CallGraph(program)
    out = list(e["lint"].lint_source(src, str(path), tree=tree))
    out += e["check"].config_key_findings(program, [])
    out += e["check"].fault_point_findings(program)
    out += _kept_findings(e, program, cg)
    if "tracedomain" in e:  # the port's retargeted whole-program rules
        out += e["races"].memo_hygiene_findings(program)
        out += e["tracedomain"].LaunchDomains(program, cg, Raises(program, cg)).findings()
    return out


def _expected(path: pathlib.Path) -> set:
    out = set()
    for i, line in enumerate(path.read_text().splitlines(), 1):
        if "# expect:" in line:
            out.update((i, rule) for rule in line.split("# expect:", 1)[1].split())
    return out


# -- the kept rules against the JAX package's engine -----------------------------

FIXTURE_PACKAGES = ("lockdemo", "racedemo", "raisedemo", "procdemo", "durademo")


@pytest.mark.parametrize("fixture", FIXTURE_PACKAGES)
def test_kept_rules_equal_the_jax_engine_line_for_line(engines, fixture):
    got = {}
    for label, e in engines.items():
        program = e["program"].Program.load([REF_FIXTURES / fixture])
        cg = e["callgraph"].CallGraph(program)
        got[label] = sorted((pathlib.Path(f.path).name, f.line, f.rule) for f in _kept_findings(e, program, cg))
    assert got["torch"] == got["jax"]
    assert got["torch"], "the fixture plants findings"


def _golden_of(fixture: str, what: str):
    e = _engine("hyperspace_tpu_torch")
    program = e["program"].Program.load([REF_FIXTURES / fixture])
    cg = e["callgraph"].CallGraph(program)
    if what == "callgraph":
        return cg.to_json()
    if what == "lockgraph":
        return e["locks"].LockGraph(program, cg).to_json()
    if what == "effects":
        return e["effects"].Effects(program, cg).to_json()
    raises = e["raises"].Raises(program, cg)
    if what == "raises":
        return raises.to_json()
    if what == "domains":
        return e["procdomain"].ProcessDomains(program, cg, raises).to_json()
    return e["duradomain"].DurabilityDomains(program, cg, raises).to_json()


@pytest.mark.parametrize("fixture,what,golden", [
    ("lockdemo", "callgraph", "lockdemo_callgraph.json"),
    ("lockdemo", "lockgraph", "lockdemo_lockgraph.json"),
    ("racedemo", "effects", "racedemo_effects.json"),
    ("raisedemo", "raises", "raisedemo_raises.json"),
    ("procdemo", "domains", "procdemo_domains.json"),
    ("durademo", "dura", "durademo_dura.json"),
])
def test_port_engine_gives_the_jax_goldens(fixture, what, golden):
    want = json.loads((REF_FIXTURES / "goldens" / golden).read_text())
    assert json.loads(json.dumps(_golden_of(fixture, what))) == want


REF_CORPUS = sorted(p for p in (REF_FIXTURES / "rules").glob("hsl0*.py") if p.stem.upper() in KEPT)


@pytest.mark.parametrize("path", REF_CORPUS, ids=[p.stem for p in REF_CORPUS])
def test_kept_rule_corpus_under_both_engines(engines, path):
    want = _expected(path)
    for label, e in engines.items():
        got = {(f.line, f.rule) for f in _file_findings(e, path) if f.rule in KEPT}
        assert got == want, label


# -- the retargeted rules over torch-idiom fixtures ------------------------------

TORCH_CORPUS = sorted((FIXTURES / "rules").glob("hsl0*.py"))


@pytest.mark.parametrize("path", TORCH_CORPUS, ids=[p.stem for p in TORCH_CORPUS])
def test_torch_rule_corpus(engines, path):
    """Each torch-idiom corpus file gives exactly its `# expect:` lines:
    flagged lines flag, clean lines stay clean, nothing extra fires."""
    got = {(f.line, f.rule) for f in _file_findings(engines["torch"], path)}
    assert got == _expected(path)


def test_corpora_cover_every_rule():
    torch_rules = {p.stem.upper() for p in TORCH_CORPUS}
    ref_rules = {p.stem.upper() for p in REF_CORPUS}
    assert torch_rules == RETARGETED
    assert torch_rules | ref_rules | {"HSL000"} == set(RULES)


@pytest.fixture(scope="module")
def launchdemo():
    program = Program.load([FIXTURES / "launchdemo"])
    cg = CallGraph(program)
    return program, LaunchDomains(program, cg, Raises(program, cg))


def test_launchdemo_golden(launchdemo):
    _, domains = launchdemo
    want = json.loads((FIXTURES / "goldens" / "launchdemo_launch.json").read_text())
    assert json.loads(json.dumps(domains.to_json())) == want


def test_launchdemo_five_planted_findings(launchdemo):
    from hyperspace_tpu_torch.analysis.races import memo_hygiene_findings

    program, domains = launchdemo
    got = sorted((pathlib.Path(f.path).name, f.line, f.rule)
                 for f in memo_hygiene_findings(program) + domains.findings())
    assert got == [
        ("fallback.py", 17, "HSL026"),
        ("leaky.py", 13, "HSL023"),
        ("leaky.py", 14, "HSL015"),
        ("leaky.py", 22, "HSL024"),
        ("staging.py", 17, "HSL025"),
    ]
    proofs = {p["kernel"]: p["proven"] for p in domains.kernel_proofs()}
    assert proofs == {"ops.good.good": True, "ops.leaky.leaky": True, "ops.fallback.fallback": False}


# -- the command line -------------------------------------------------------------


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return p


def test_cli_exit_codes(tmp_path, capsys):
    clean = _write(tmp_path, "clean.py", "def f(x):\n    return x + 1\n")
    dirty = _write(tmp_path, "dirty.py", "import jax\n")
    assert tcheck.main([str(clean), "--no-baseline"]) == EXIT_CLEAN
    assert tcheck.main([str(dirty), "--no-baseline"]) == EXIT_FINDINGS
    assert "HSL001" in capsys.readouterr().out


def test_cli_internal_error_is_exit_2(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("engine fault")

    monkeypatch.setattr(tcheck, "run_check", broken)
    assert tcheck.main([str(_write(tmp_path, "a.py", "x = 1\n"))]) == EXIT_INTERNAL_ERROR


def test_baseline_masks_only_old_findings(tmp_path, capsys):
    f = _write(tmp_path, "m.py", "import jax\n")
    base = tmp_path / "baseline.json"
    assert tcheck.main([str(f), "--baseline", str(base), "--write-baseline"]) == EXIT_CLEAN
    assert len(json.loads(base.read_text())["findings"]) == 1
    assert tcheck.main([str(f), "--baseline", str(base)]) == EXIT_CLEAN
    f.write_text("import jax\nimport jaxlib\n")
    capsys.readouterr()
    assert tcheck.main([str(f), "--baseline", str(base), "--format", "json"]) == EXIT_FINDINGS
    report = json.loads(capsys.readouterr().out)
    assert [x["new"] for x in report["findings"]] == [False, True]
    assert report["baseline"] == {"path": str(base), "known": 1, "stale": 0, "new": 1}


def test_sarif_output(tmp_path, capsys):
    f = _write(tmp_path, "s.py", "import hyperspace_tpu\n")
    assert tcheck.main([str(f), "--no-baseline", "--format", "sarif"]) == EXIT_FINDINGS
    sarif = json.loads(capsys.readouterr().out)
    assert sarif["version"] == "2.1.0"
    run = sarif["runs"][0]
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} == set(RULES)
    (res,) = run["results"]
    assert res["ruleId"] == "HSL001" and res["baselineState"] == "new"
    assert res["locations"][0]["physicalLocation"]["region"]["startLine"] == 1


@pytest.mark.parametrize("text,rc", [("import jax\n", 1), ("x = 1\n", 0)])
def test_lint_module_entry_point(tmp_path, text, rc):
    f = _write(tmp_path, "l.py", text)
    proc = subprocess.run([sys.executable, "-m", "hyperspace_tpu_torch.analysis.lint", str(f)],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == rc, proc.stderr


def test_committed_baseline_is_empty():
    base = REPO / "hyperspace_tpu_torch" / "analysis" / "baseline.json"
    assert json.loads(base.read_text()) == {"findings": []}


@pytest.fixture(scope="module")
def port_check():
    t0 = time.perf_counter()
    report = tcheck.run_check(tcheck.default_paths(REPO), REPO, sorted(TESTS.glob("test_torch_*.py")))
    return report, time.perf_counter() - t0


def test_the_port_tree_is_clean_and_whole(port_check):
    report, _ = port_check
    assert [str(f) for f in report["_findings"]] == []
    s = report["summary"]
    n_files = len(list((REPO / "hyperspace_tpu_torch").rglob("*.py"))) + 1
    assert s["files"] == n_files
    assert s["launch_entry_points"] == 3 and s["launch_kernels_proven"] == 3
    assert s["spawn_entry_points"] == 8 and s["torn_windows"] == s["torn_windows_proven"] == 4
    assert s["contract_entry_points"] == 26 and s["fault_points_proven"] == len(tcheck.known_points())
    assert report["validator_corpus"]["status"] == "ok"
    assert report["launch_domains"]["borrowed_buffers"]["proven"]


# Ambiguous calls inside the error-contract closures on the tree this
# bound was set on. A rise means a new class shares a method name that a
# contract path calls, and the edge is gone: report["ambiguous_calls"]
# ["contract"] names the sites.
CONTRACT_AMBIGUOUS_MAX = 113


def test_no_call_is_shadowed_and_closures_stay_resolved(port_check):
    report, _ = port_check
    s = report["summary"]
    assert s["calls_shadowed"] == 0, report["ambiguous_calls"]["shadowed"]
    assert s["launch_ambiguous_calls"] == 0, report["ambiguous_calls"]["launch"]
    assert s["contract_ambiguous_calls"] <= CONTRACT_AMBIGUOUS_MAX, report["ambiguous_calls"]["contract"]


@pytest.mark.parametrize("harness_method,shadowed", [("refresh_index", 1), ("refresh_clock", 0)])
def test_a_harness_method_shadowing_a_package_method_is_counted(tmp_path, harness_method, shadowed):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    _write(pkg, "__init__.py", "")
    _write(pkg, "facade.py", "class Facade:\n    def refresh_index(self, name):\n        raise ValueError(name)\n")
    _write(pkg, "writer.py", "def commit(hs, name):\n    return hs.refresh_index(name)\n")
    _write(tmp_path, "harness.py", f"class Timed:\n    def {harness_method}(self, name):\n        return name\n")
    sources, _ = tcheck.load_sources([pkg, tmp_path / "harness.py"])
    cg = CallGraph(tcheck.build_program(sources))
    assert [(a.caller, a.raw) for a in cg.shadowed()] == [("pkg.writer.commit", "hs.refresh_index")] * shadowed
    # Resolved, the writer keeps the facade's escape; shadowed, it is lost.
    esc = Raises(cg.program, cg).escapes["pkg.writer.commit"]
    assert ("ValueError" in esc) == (not shadowed)


def test_the_port_tree_check_wall_time_is_bounded(port_check):
    _, wall = port_check
    assert wall < 60.0, f"run_check over the port took {wall:.1f}s"


def test_launch_contract_names_the_same_three_kernels(port_check):
    from hyperspace_tpu_torch.ops import KNOWN_KERNELS, kernels

    launch = port_check[0]["launch_domains"]
    proofs = {p["kernel"]: p for p in launch["kernels"]}
    assert set(proofs) == set(KNOWN_KERNELS) == set(launch["known_kernels"])
    assert {k.rsplit(".", 1)[1] for k in KNOWN_KERNELS} == set(kernels.SOURCES) == {
        p["load_names"][0] for p in proofs.values()}
    for p in proofs.values():
        assert p["proven"] and p["fallback"] is None
        assert p["plain"]["fn"].endswith(p["kernel"].rsplit(".", 1)[1] + "_plain")


def test_generated_tables_match_the_registries():
    from hyperspace_tpu_torch import config, faults

    assert tcheck.docs_table() == config.docs_table()
    assert list(tcheck.config_registry()) == list(config.KNOWN_KEYS)
    assert tcheck.known_points() == faults.KNOWN_POINTS
    assert tcheck.docs_findings(REPO) == []


# -- the registries, name for name with the JAX package's --------------------------


def _port_name(qname: str) -> str:
    return "hyperspace_tpu_torch." + qname.split(".", 1)[1]


def test_registries_map_onto_the_jax_packages(port_check):
    from hyperspace_tpu import exceptions as jexc
    from hyperspace_tpu.analysis import duradomain as jdura
    from hyperspace_tpu.analysis import procdomain as jproc
    from hyperspace_tpu_torch import exceptions as texc
    from hyperspace_tpu_torch.analysis import duradomain as tdura
    from hyperspace_tpu_torch.analysis import procdomain as tproc

    assert tdura.DURABLE_ROOTS == jdura.DURABLE_ROOTS
    assert set(tdura.TORN_WINDOWS) == set(jdura.TORN_WINDOWS)
    for name, (fn, first, second, point, why) in jdura.TORN_WINDOWS.items():
        assert tdura.TORN_WINDOWS[name] == (_port_name(fn), first, second, point, why)
    assert tdura.REPLAY_ROOTS == {_port_name(q): why for q, why in jdura.REPLAY_ROOTS.items()}
    ref_spawn = {q: kw for q, kw in jproc.SPAWN_ENTRY_POINTS.items() if q.startswith("hyperspace_tpu.")}
    assert {q: kw for q, kw in tproc.SPAWN_ENTRY_POINTS.items() if q.startswith("hyperspace_tpu_torch.")} == {
        _port_name(q): kw for q, kw in ref_spawn.items()}
    assert all(q.startswith("chip_smoke.") for q in tproc.SPAWN_ENTRY_POINTS
               if not q.startswith("hyperspace_tpu_torch."))
    assert texc.ERROR_CONTRACTS == {_port_name(q): t for q, t in jexc.ERROR_CONTRACTS.items()}
    program = port_check[0]["_engine"][0]
    for q in [*tproc.SPAWN_ENTRY_POINTS, *tdura.REPLAY_ROOTS, *texc.ERROR_CONTRACTS,
              *(w[0] for w in tdura.TORN_WINDOWS.values())]:
        assert q in program.functions, q


def test_sanctioned_launch_helpers_resolve(port_check):
    from hyperspace_tpu_torch.analysis.tracedomain import LAUNCH_SANCTIONED

    program = port_check[0]["_engine"][0]
    assert set(LAUNCH_SANCTIONED) <= set(program.functions)
