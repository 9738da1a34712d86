"""The port stands alone: importing it loads neither JAX nor the JAX package.

A fresh interpreter imports `hyperspace_tpu_torch` and every one of its
modules and reports which forbidden modules ended up in `sys.modules`; a
worker spawned by the pooled build's pool, after running a real p1 shard
of `execution/build_exchange.py`, reports the same, and so do a serving
fleet member the supervisor spawns and the ingest daemon's process worker.
Both packages' `serve` export the operations controller.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import hyperspace_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hyperspace_tpu_torch.__path__, "hyperspace_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib")) or k == "hyperspace_tpu" or k.startswith("hyperspace_tpu."))
print(json.dumps({"modules": names, "forbidden": bad}))
"""


def test_port_imports_without_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["forbidden"] == []
    for name in (
        "hyperspace_tpu_torch.hyperspace",
        "hyperspace_tpu_torch.ops.segment_reduce",
        "hyperspace_tpu_torch.execution.executor",
        "hyperspace_tpu_torch.datagen",
        "hyperspace_tpu_torch.ops.join",
        "hyperspace_tpu_torch.ops.join_agg",
        "hyperspace_tpu_torch.execution.exec_common",
        "hyperspace_tpu_torch.execution.exec_side",
        "hyperspace_tpu_torch.execution.exec_join",
        "hyperspace_tpu_torch.execution.exec_join_agg",
        "hyperspace_tpu_torch.rules.join_index_rule",
        "hyperspace_tpu_torch.ops.topk",
        "hyperspace_tpu_torch.ops.kmeans",
        "hyperspace_tpu_torch.vector",
        "hyperspace_tpu_torch.vector.index",
        "hyperspace_tpu_torch.vector.lifecycle",
        "hyperspace_tpu_torch.vector.search",
        "hyperspace_tpu_torch.execution.device_cache",
        "hyperspace_tpu_torch.execution.exec_scan",
        "hyperspace_tpu_torch.serve",
        "hyperspace_tpu_torch.serve.plan_cache",
        "hyperspace_tpu_torch.signature",
        "hyperspace_tpu_torch.plan.pushdown",
        "hyperspace_tpu_torch.ops.project",
        "hyperspace_tpu_torch.stats",
        "hyperspace_tpu_torch.obs",
        "hyperspace_tpu_torch.obs.metrics",
        "hyperspace_tpu_torch.obs.trace",
        "hyperspace_tpu_torch.obs.events",
        "hyperspace_tpu_torch.obs.profile",
        "hyperspace_tpu_torch.execution.physical",
        "hyperspace_tpu_torch.explain",
        "hyperspace_tpu_torch.explain.display_mode",
        "hyperspace_tpu_torch.explain.plan_analyzer",
        "hyperspace_tpu_torch.serve.result_cache",
        "hyperspace_tpu_torch.serve.scheduler",
        "hyperspace_tpu_torch.analysis",
        "hyperspace_tpu_torch.analysis.validator",
        "hyperspace_tpu_torch.faults",
        "hyperspace_tpu_torch.utils.retry",
        "hyperspace_tpu_torch.native",
        "hyperspace_tpu_torch.execution.build_exchange",
        "hyperspace_tpu_torch.execution.staging",
        "hyperspace_tpu_torch.execution.prefetch",
        "hyperspace_tpu_torch.parallel",
        "hyperspace_tpu_torch.parallel.procpool",
        "hyperspace_tpu_torch.parallel.mesh",
        "hyperspace_tpu_torch.parallel.bandwidth",
        "hyperspace_tpu_torch.ops.bucketize",
        "hyperspace_tpu_torch.obs.journal",
        "hyperspace_tpu_torch.obs.slo",
        "hyperspace_tpu_torch.obs.runtime",
        "hyperspace_tpu_torch.obs.export",
        "hyperspace_tpu_torch.obs.http",
        "hyperspace_tpu_torch.serve.fleet",
        "hyperspace_tpu_torch.serve.fleet.lease",
        "hyperspace_tpu_torch.serve.fleet.singleflight",
        "hyperspace_tpu_torch.serve.fleet.quota",
        "hyperspace_tpu_torch.serve.fleet.shared_cache",
        "hyperspace_tpu_torch.serve.fleet.supervisor",
        "hyperspace_tpu_torch.serve.controller",
        "hyperspace_tpu_torch.ingest",
        "hyperspace_tpu_torch.ingest.tailer",
        "hyperspace_tpu_torch.ingest.writer",
        "hyperspace_tpu_torch.ingest.snapshot",
        "hyperspace_tpu_torch.ingest.daemon",
    ):
        assert name in report["modules"]


def test_importing_ingest_alone_loads_neither():
    code = ("import json, sys; import hyperspace_tpu_torch.ingest as ing; "
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib')) "
            "or k == 'hyperspace_tpu' or k.startswith('hyperspace_tpu.')); "
            "print(json.dumps({'names': sorted(ing.__all__), 'forbidden': bad}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"names": ["CdcTailer", "FileArrivalWatcher", "IngestDaemon", "PinnedSnapshot"],
                      "forbidden": []}


def test_both_packages_export_the_ops_controller_from_serve():
    from hyperspace_tpu.serve import OpsController as JaxOpsController
    from hyperspace_tpu.serve import __all__ as jax_all
    from hyperspace_tpu_torch.serve import OpsController
    from hyperspace_tpu_torch.serve import __all__ as port_all
    from hyperspace_tpu_torch.serve.controller import OpsController as direct

    assert OpsController is direct and JaxOpsController.__name__ == OpsController.__name__
    assert sorted(port_all) == sorted(jax_all)


def _worker_census(task):
    """Runs in a spawned worker: a real p1 shard, then which forbidden
    modules the worker holds."""
    from hyperspace_tpu_torch.execution import build_exchange

    result = build_exchange.p1_shard(task)
    bad = sorted(k for k in sys.modules
                 if k == "jax" or k.startswith(("jax.", "jaxlib")) or k == "hyperspace_tpu"
                 or k.startswith("hyperspace_tpu."))
    return {"rows": result["rows"], "forbidden": bad}


def test_a_pooled_build_worker_imports_neither(tmp_path):
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.dataset import Dataset
    from hyperspace_tpu_torch.execution import build_exchange as bx
    from hyperspace_tpu_torch.parallel.procpool import TaskPool

    (tmp_path / "src").mkdir()
    pq.write_table(pa.table({"k": np.arange(500), "v": np.arange(500) * 0.5}), tmp_path / "src" / "p.parquet")
    task = bx.P1Task(
        worker=0, files=[str(tmp_path / "src" / "p.parquet")], fmt="parquet", columns=["k", "v"],
        schema=Dataset.parquet(tmp_path / "src").scan().scan_schema, indexed_columns=["k"], num_buckets=4,
        num_owners=2, chunk_bytes=1 << 20, memory_budget_bytes=1 << 20, exchange_dir=str(tmp_path / "ex"),
    )
    with TaskPool("hs-imports") as pool:
        pool.submit(0, _worker_census, task)
        census = pool.join()[0]
    assert census == {"rows": 500, "forbidden": []}


def test_a_spawned_fleet_member_imports_neither(tmp_path):
    """A member the fleet supervisor spawns imports every module of the
    port and serves through the fleet's caches, loading neither."""
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_fleet as members

    from hyperspace_tpu_torch.parallel.procpool import spawn_context
    from hyperspace_tpu_torch.serve.fleet import FleetSupervisor

    out_q = spawn_context().Queue()
    sup = FleetSupervisor(members.import_member, fleet_dir=str(tmp_path / "fleet"), n=1, args=(out_q,),
                          max_restarts=0)
    with sup:
        sup.start()
        census = out_q.get(timeout=180)
    assert census["forbidden"] == [] and census["pid"] != 0


def _ingest_worker_census(system_path, watches, env, stop_event, out_q):
    """Runs in a spawned process: the ingest worker's entry rebuilds its
    session on the parent's device and watches (the stop event is already
    set, so it returns without polling), then which forbidden modules the
    process holds."""
    from hyperspace_tpu_torch.ingest.daemon import _service_entry

    _service_entry(system_path, watches, env, stop_event)
    bad = sorted(k for k in sys.modules
                 if k == "jax" or k.startswith(("jax.", "jaxlib")) or k == "hyperspace_tpu"
                 or k.startswith("hyperspace_tpu."))
    out_q.put({"forbidden": bad, "torch": "torch" in sys.modules})


def test_a_spawned_ingest_worker_imports_neither(tmp_path):
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.parallel.procpool import ProcessHost

    (tmp_path / "src").mkdir()
    pq.write_table(pa.table({"k": np.arange(50), "v": np.arange(50) * 0.5}), tmp_path / "src" / "p.parquet")
    session = HyperspaceSession(system_path=str(tmp_path / "sys"), num_buckets=2, device="cpu")
    Hyperspace(session).create_index(session.parquet(tmp_path / "src"), IndexConfig("i", ["k"], ["v"]))
    host = ProcessHost("hs-imports")
    out_q = host.ctx.Queue()
    host.stop_event.set()
    host.spawn("ingest", _ingest_worker_census,
               (str(tmp_path / "sys"), [("i", None)], {"device": "cpu"}, host.stop_event, out_q))
    try:
        census = out_q.get(timeout=180)
    finally:
        host.stop(timeout=30)
    assert census == {"forbidden": [], "torch": True}


def test_port_sources_never_name_jax():
    """No source of the port imports JAX or the JAX package, even lazily."""
    offenders = []
    for path in (REPO / "hyperspace_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")) and (
                " jax" in stripped or "hyperspace_tpu." in stripped.replace("hyperspace_tpu_torch", "")
                or stripped.split()[1] == "hyperspace_tpu"
            ):
                offenders.append(f"{path.name}: {stripped}")
    assert offenders == []
