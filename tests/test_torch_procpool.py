"""The port's spawn-context worker pool (parallel/procpool.py).

tests/test_procpool.py's nine cases through the port: results collected,
a posted error re-raised typed (`WorkerFailed` with the worker's
traceback), a SIGKILLed or hard-exited worker a typed `WorkerCrashed`
within a bounded wait, a join timeout typed, the coordinator's fault
rules firing inside a worker with its observed points merged back, the
worker's imports, and `ProcessHost.stop` ending stragglers.

The import census runs in a worker that has imported the pooled build's
worker module (`execution/build_exchange.py`): neither `jax` nor the JAX
package is loaded there. This file imports neither either, since a
spawned worker imports it to find the task functions.
"""

import os
import signal
import time

import pytest

from hyperspace_tpu_torch import faults, stats
from hyperspace_tpu_torch.exceptions import WorkerCrashed, WorkerFailed
from hyperspace_tpu_torch.parallel.procpool import ProcessHost, TaskPool, spawn_context


# Worker bodies are module-level: spawn pickles them by qualified name and
# the child imports this module.

def _double(x):
    return x * 2


def _sleep_forever(_seconds):
    time.sleep(3600)


def _value_error(msg):
    raise ValueError(msg)


def _hard_exit(code):
    os._exit(code)


def _hit_point():
    faults.fault_point("build.exchange.write", "/nonexistent/probe")
    return "ok"


def _idle_until_stopped(stop_seconds):
    time.sleep(stop_seconds)


def _import_census():
    """Runs in a spawned worker: which modules the pooled build's worker
    module pulls in, and whether CUDA was initialized."""
    import sys

    import torch

    from hyperspace_tpu_torch.execution import build_exchange  # noqa: F401

    return {
        "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))),
        "jax_package": sorted(m for m in sys.modules if m == "hyperspace_tpu" or m.startswith("hyperspace_tpu.")),
        "port": sorted(m for m in sys.modules if m.startswith("hyperspace_tpu_torch")),
        "cuda_initialized": torch.cuda.is_initialized(),
    }


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def test_spawn_context_is_spawn():
    assert spawn_context().get_start_method() == "spawn"


def test_taskpool_collects_all_results():
    with TaskPool("hs-test") as pool:
        for i in range(3):
            pool.submit(i, _double, i)
        assert pool.join() == {0: 0, 1: 2, 2: 4}


def test_posted_error_reraises_typed():
    with TaskPool("hs-test") as pool:
        pool.submit("bad", _value_error, "boom-xyz")
        with pytest.raises(WorkerFailed) as ei:
            pool.join()
    assert ei.value.error_type == "ValueError"
    assert "boom-xyz" in str(ei.value) and "worker traceback" in str(ei.value)


def test_sigkilled_worker_raises_typed_abort_bounded():
    before = stats.get("build.worker.crashes")
    with TaskPool("hs-test", poll_s=0.1, crash_grace_s=0.5) as pool:
        pool.submit("victim", _sleep_forever, 0)
        p = pool.host.get("victim")
        deadline = time.monotonic() + 30
        while not p.is_alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        os.kill(p.pid, signal.SIGKILL)
        t0 = time.monotonic()
        with pytest.raises(WorkerCrashed) as ei:
            pool.join()
        assert time.monotonic() - t0 < 30, "join did not bound the wait"
    assert ei.value.task_id == "victim"
    assert ei.value.exitcode == -signal.SIGKILL
    assert stats.get("build.worker.crashes") == before + 1


def test_hard_exit_worker_raises_typed_abort():
    with TaskPool("hs-test", poll_s=0.1, crash_grace_s=0.5) as pool:
        pool.submit("exiter", _hard_exit, 7)
        with pytest.raises(WorkerCrashed) as ei:
            pool.join()
    assert ei.value.exitcode == 7


def test_join_timeout_is_typed():
    with TaskPool("hs-test", poll_s=0.05) as pool:
        pool.submit("slow", _sleep_forever, 0)
        with pytest.raises(WorkerCrashed, match="timed out"):
            pool.join(timeout=0.5)
    assert not pool.host.get("slow").is_alive()


def test_fault_rules_ship_into_workers_and_observed_merge_back():
    faults.inject("build.exchange.write", times=1)
    with TaskPool("hs-test") as pool:
        pool.submit("w", _hit_point)
        with pytest.raises(WorkerFailed) as ei:
            pool.join()
    assert ei.value.error_type == "FaultError"
    assert "build.exchange.write" in faults.observed_points()
    faults.reset()
    with faults.recording() as seen:
        with TaskPool("hs-test") as pool:
            pool.submit("w", _hit_point)
            assert pool.join() == {"w": "ok"}
    assert "build.exchange.write" in seen


def test_worker_never_imports_jax_or_the_jax_package():
    with TaskPool("hs-test") as pool:
        pool.submit("census", _import_census)
        census = pool.join()["census"]
    assert census["jax"] == [] and census["jax_package"] == []
    assert census["cuda_initialized"] is False
    # Not vacuous: the spawn plumbing and the worker module are there.
    for name in ("hyperspace_tpu_torch.parallel.procpool", "hyperspace_tpu_torch.faults",
                 "hyperspace_tpu_torch.execution.build_exchange"):
        assert name in census["port"]


def test_process_host_stop_terminates_stragglers():
    host = ProcessHost("hs-test-host")
    p = host.spawn("w", _idle_until_stopped, args=(3600,))
    assert host.alive_count() == 1
    t0 = time.monotonic()
    host.stop(timeout=0.5, grace=5.0)
    assert time.monotonic() - t0 < 30
    assert not p.is_alive()
    assert host.alive_count() == 0
