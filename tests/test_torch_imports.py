"""The port stands alone: importing it loads neither JAX nor the JAX package.

A fresh interpreter imports `hyperspace_tpu_torch` and every one of its
modules and reports which forbidden modules ended up in `sys.modules`;
and a worker spawned by the pooled build's pool, after running a real p1
shard of `execution/build_exchange.py`, reports the same.
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
    ):
        assert name in report["modules"]


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
