"""The port stands alone: importing it loads neither JAX nor the JAX package.

A fresh interpreter imports `hyperspace_tpu_torch` and every one of its
modules and reports which forbidden modules ended up in `sys.modules`.
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
    ):
        assert name in report["modules"]


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
