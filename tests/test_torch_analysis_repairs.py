"""The port's repairs the static analysis found, held against the JAX
package where it has a counterpart.

- Crash recovery counts what it repairs: `recover.quarantined_entries`,
  `recover.rolled`, `recover.orphans_removed`, and a failed lazy
  recover-on-access counts `recover.on_access_failed` instead of passing
  silently. The same crash in an index of each package gives equal
  counter deltas.
- The kernel wrappers' caches (`_sms`, `_fn`, `_plans`) are filled
  through `kernels.memo`, under its lock: one build under eight racing
  threads, and no module-level table of `ops/` mutated anywhere else.
- torch's private API (`torch._C`) is reached only through
  `ops/kernels.py::call_on_stream`.
- A spawned TaskPool worker imports, before its task, only modules of
  the static spawn domain of `_task_entry`, and initializes no CUDA.
"""

import ast
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu import faults as jfaults
from hyperspace_tpu import stats as jstats
from hyperspace_tpu_torch import faults as tfaults
from hyperspace_tpu_torch import states
from hyperspace_tpu_torch import stats as tstats
from hyperspace_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parent.parent
PACKAGES = (("jax", hjax, jstats, jfaults, {}), ("torch", htorch, tstats, tfaults, {"device": "cpu"}))
RECOVER_COUNTERS = (
    "recover.quarantined_entries", "recover.rolled", "recover.orphans_removed", "recover.on_access_failed",
)


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def _managers(pkg, index_path):
    from importlib import import_module

    lm = import_module(f"{pkg.__name__}.metadata.log_manager").IndexLogManager(index_path)
    dm = import_module(f"{pkg.__name__}.metadata.data_manager").IndexDataManager(index_path)
    return lm, dm


def _twin(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(5)
    pq.write_table(pa.table({"key": rng.integers(0, 50, 400), "value": rng.standard_normal(400)}),
                   src / "part-0.parquet")
    out = {}
    for label, pkg, st, fl, kw in PACKAGES:
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"sys_{label}"), num_buckets=2, **kw)
        hs = pkg.Hyperspace(s)
        hs.create_index(s.parquet(src), pkg.IndexConfig("idx1", ["key"], ["value"]))
        out[label] = (pkg, st, fl, s, hs, tmp_path / f"sys_{label}" / "idx1")
    return out


def _torn_tail(pkg, hs, idx):
    (idx / "_hyperspace_log" / "2").write_text('{"version": "0.1", "id": 2, "sta')


def _transient_with_orphan(pkg, hs, idx):
    lm, _ = _managers(pkg, idx)
    assert lm.write_log(2, lm.get_latest_log().with_state(states.REFRESHING))
    orphan = idx / "v__=1"
    orphan.mkdir()
    (orphan / "bucket-00000.parquet").write_bytes(b"junk")


def _orphan_dir(pkg, hs, idx):
    (idx / "v__=7").mkdir()


CRASHES = {
    "torn-tail": (_torn_tail, {"recover.quarantined_entries": 1}),
    "transient-with-orphan": (_transient_with_orphan, {"recover.rolled": 1, "recover.orphans_removed": 1}),
    "orphan-dir": (_orphan_dir, {"recover.orphans_removed": 1}),
}


@pytest.mark.parametrize("crash", list(CRASHES))
def test_recover_counts_equal_in_both_packages(tmp_path, crash):
    fake, want = CRASHES[crash]
    deltas = {}
    for label, (pkg, st, _fl, _s, hs, idx) in _twin(tmp_path).items():
        fake(pkg, hs, idx)
        before = {c: st.get(c) for c in RECOVER_COUNTERS}
        hs.recover("idx1")
        deltas[label] = {c: st.get(c) - before[c] for c in RECOVER_COUNTERS}
    assert deltas["torch"] == deltas["jax"] == {c: want.get(c, 0) for c in RECOVER_COUNTERS}


def test_failed_recover_on_access_is_counted_in_both_packages(tmp_path):
    """A listing's lazy recover that fails is counted, not swallowed: a
    transient latest entry past the grace, whose roll-back cannot write
    its log entry."""
    deltas = {}
    for label, (pkg, st, fl, s, hs, idx) in _twin(tmp_path).items():
        _transient_with_orphan(pkg, hs, idx)
        lm, _ = _managers(pkg, idx)
        s.conf.set("hyperspace.recover.graceSeconds", "0")
        time.sleep(0.01)
        before = {c: st.get(c) for c in RECOVER_COUNTERS}
        with fl.injected("log.write", error=PermissionError("read-only log"), times=1000):
            hs.indexes()
        deltas[label] = {c: st.get(c) - before[c] for c in RECOVER_COUNTERS}
        assert lm.get_latest_log().state == states.REFRESHING  # still unrepaired
    assert deltas["torch"] == deltas["jax"]
    assert deltas["torch"]["recover.on_access_failed"] >= 1


def test_the_recover_counters_are_declared_like_the_jax_packages():
    port = [c for c in tstats.KNOWN_COUNTERS if c.startswith("recover.")]
    ref = [c for c in jstats.KNOWN_COUNTERS if c.startswith("recover.")]
    assert sorted(port) == sorted(ref) == sorted(RECOVER_COUNTERS)


# -- the kernel wrappers' caches and torch's private API ------------------------


def test_memo_builds_once_under_racing_threads():
    table, built, start = {}, [], threading.Barrier(8)

    def build():
        built.append(1)
        time.sleep(0.01)
        return object()

    got = []

    def worker():
        start.wait()
        got.append(kernels.memo(table, ("plan", 3), build))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and len(got) == 8 and len({id(v) for v in got}) == 1


@pytest.mark.parametrize("module", ["segment_reduce", "sortkeys", "topk"])
def test_wrapper_tables_are_filled_only_through_memo(module):
    """No module-level table of the wrapper's module is written outside
    kernels.memo: no subscript store, no mutating method on it."""
    path = REPO / "hyperspace_tpu_torch" / "ops" / f"{module}.py"
    tree = ast.parse(path.read_text())
    tables = {
        t.id for node in tree.body if isinstance(node, (ast.Assign, ast.AnnAssign))
        for t in (node.targets if isinstance(node, ast.Assign) else [node.target])
        if isinstance(t, ast.Name) and isinstance(node.value, (ast.Dict, ast.List))
    }
    assert {"_sms", "_fn"} <= tables
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                assert not (isinstance(t, ast.Subscript) and getattr(t.value, "id", None) in tables), node.lineno
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            base = getattr(node.func.value, "id", None)
            assert not (base in tables and node.func.attr in ("append", "update", "setdefault", "clear")), node.lineno
    memos = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "memo"]
    assert {n.args[0].id for n in memos} >= {"_sms", "_fn"}


def test_torch_private_api_only_in_the_loader():
    hits = sorted(
        str(p.relative_to(REPO)) for p in (REPO / "hyperspace_tpu_torch").rglob("*.py")
        if "torch._C" in p.read_text() and p.parent.name != "analysis"
    )
    assert hits == ["hyperspace_tpu_torch/ops/kernels.py"]


def test_call_on_stream_switches_to_the_card_only_where_needed(monkeypatch):
    """The launch helper keeps the wrappers' device test: the current device
    is used as it is, another card is made current for the call."""
    import torch

    switched = []
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i, raising=False)

    class _Dev:
        def __init__(self, i):
            switched.append(i)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", _Dev)
    assert kernels.call_on_stream(0, lambda a, stream: (a, stream), "x") == ("x", 1000)
    assert switched == []
    assert kernels.call_on_stream(2, lambda a, stream: (a, stream), "y") == ("y", 1002)
    assert switched == [2]


# -- a real worker against the static spawn domain ---------------------------------


def test_a_spawned_worker_imports_only_its_static_spawn_domain():
    from hyperspace_tpu_torch.analysis.callgraph import CallGraph
    from hyperspace_tpu_torch.analysis.procdomain import ProcessDomains
    from hyperspace_tpu_torch.analysis.program import Program
    from hyperspace_tpu_torch.analysis.raises import Raises
    from hyperspace_tpu_torch.parallel.procpool import TaskPool

    sys.path.insert(0, str(REPO))
    import chip_smoke

    program = Program.load([REPO / "hyperspace_tpu_torch"])
    cg = CallGraph(program)
    domain = ProcessDomains(program, cg, Raises(program, cg)).entry_modules(
        "hyperspace_tpu_torch.parallel.procpool._task_entry")
    with TaskPool("hs-census-test") as pool:
        pool.submit(0, chip_smoke._worker_census)
        census = pool.join(timeout=120)[0]
    assert census["modules"] and not census["cuda_initialized"]
    assert set(census["modules"]) <= domain, sorted(set(census["modules"]) - domain)
    assert json.dumps(census)  # plain data crossed back
