"""Spawn-context worker-process lifecycle, shared by the serving fleet
and the pooled index build.

A port of the JAX package's `parallel/procpool.py`. Two layers:

- :class:`ProcessHost` — one ``spawn`` multiprocessing context (never
  ``fork``: the coordinator holds a CUDA context, which does not survive
  a fork, so every worker starts from a fresh interpreter), a shared
  stop event for cooperative drain, a keyed registry of named processes,
  and a stop() that signals, joins and terminates stragglers.
  `serve/fleet/supervisor.py` layers its restart-budget monitor on top.

- :class:`TaskPool` — one process per submitted task with a shared
  result queue. :meth:`TaskPool.join` is a **bounded join with a
  liveness check**: it polls the result queue, and a worker found dead
  without having posted its result (a real ``kill -9``, an OOM kill, or
  an injected :class:`~hyperspace_tpu_torch.faults.CrashPoint` flying out
  of the worker) raises a typed
  :class:`~hyperspace_tpu_torch.exceptions.WorkerCrashed` instead of
  blocking forever. A worker whose body raised an ``Exception`` posts
  the error (type, message, traceback text) and join re-raises it as
  :class:`~hyperspace_tpu_torch.exceptions.WorkerFailed`.

Across the process boundary:

- **fault injection** — the coordinator's registered
  :mod:`~hyperspace_tpu_torch.faults` rules ship into each worker (fresh
  schedules, counted per process, `faults.export_state` /
  `install_state`) and the worker's observed points merge back on join,
  so the crash sweep sees through the boundary;
- **tracing** — each worker's finished root span ships back as its
  ``to_json()`` dict and is adopted into this process's recent-root ring
  and sink (:func:`~hyperspace_tpu_torch.obs.trace.adopt_root`);
- **journal** — the telemetry journal's state (`obs/journal.py`
  `export_state` / `install_state`) ships into each worker, which then
  journals under its own ``<root>/<pid>/``.

Build workers never touch the card; the serving fleet's members
(serve/fleet/supervisor.py) ride :class:`ProcessHost` and each opens a
CUDA context of its own.
"""

from __future__ import annotations

import threading
import time
import traceback

from hyperspace_tpu_torch import faults, stats
from hyperspace_tpu_torch.exceptions import WorkerCrashed, WorkerFailed
from hyperspace_tpu_torch.obs import trace as obs_trace

_DEFAULT_POLL_S = 0.2
# How long a dead-without-result worker is given for an already-posted
# result to drain out of the queue's feeder pipe before the crash is
# declared (the post-then-exit race).
_CRASH_GRACE_S = 2.0


def spawn_context():
    """The one multiprocessing context this package spawns workers with.
    Always ``spawn``: a forked child of a parent that holds a CUDA
    context cannot use it, and inherits the parent's threads' locks in
    whatever state they were; every worker starts from a fresh
    interpreter instead."""
    import multiprocessing as mp

    return mp.get_context("spawn")


class ProcessHost:
    """Owns a spawn context, a shared stop event, and a keyed registry
    of worker processes."""

    def __init__(self, name: str = "hs-procs"):
        self.name = name
        self._ctx = spawn_context()
        self.stop_event = self._ctx.Event()
        self._lock = threading.Lock()
        self._procs: dict = {}

    @property
    def ctx(self):
        return self._ctx

    def spawn(self, key, target, args: tuple = (), name: str | None = None):
        """Start (or replace) the worker registered under `key`."""
        p = self._ctx.Process(
            target=target, args=args, name=name or f"{self.name}-{key}"
        )
        p.start()
        with self._lock:
            self._procs[key] = p
        return p

    def get(self, key):
        with self._lock:
            return self._procs.get(key)

    def processes(self) -> dict:
        """Snapshot of the registry (key -> Process)."""
        with self._lock:
            return dict(self._procs)

    def alive_count(self) -> int:
        with self._lock:
            return sum(1 for p in self._procs.values() if p.is_alive())

    def stop(self, timeout: float = 30.0, grace: float = 5.0) -> None:
        """Cooperative drain: set the stop event, join with `timeout`,
        terminate stragglers (and join those with `grace`). Idempotent.

        A worker SIGKILLed inside ``stop_event.wait`` leaves the event's
        condition one waker short, and ``set()`` then blocks for ever in
        its notify: with no live worker the event is not set at all, and
        otherwise it is set from a helper thread joined for at most
        `timeout`, the stragglers terminated after."""
        procs = list(self.processes().values())
        if any(p.is_alive() for p in procs):
            setter = threading.Thread(target=self.stop_event.set, name=f"{self.name}-stop", daemon=True)
            setter.start()
            setter.join(timeout)
        for p in procs:
            p.join(timeout=timeout)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=grace)

    def terminate(self, key, grace: float = 5.0) -> bool:
        """Stop and deregister ONE worker: drop it from the registry first,
        then terminate if still alive and join with `grace`. Returns True
        when a process was registered under `key`."""
        with self._lock:
            p = self._procs.pop(key, None)
        if p is None:
            return False
        if p.is_alive():
            p.terminate()
        p.join(timeout=grace)
        return True


def _task_entry(result_q, task_id, fn, args, env) -> None:
    """Module-level worker entry (spawn needs a picklable top-level
    callable): install the coordinator's shipped fault rules, run the
    task body, and post exactly one (task_id, ok, envelope) record. A
    CrashPoint (BaseException) deliberately falls through — the process
    dies without posting, exactly like a real ``kill -9``, and the
    coordinator's liveness check converts that into a typed abort."""
    fstate = env.get("faults")
    if fstate is not None:
        faults.install_state(fstate)
    obs_trace.set_enabled(bool(env.get("obs_enabled", True)))
    jstate = env.get("journal")
    if jstate is not None:
        from hyperspace_tpu_torch.obs import journal as obs_journal

        obs_journal.install_state(jstate)
    try:
        result = fn(*args)
        root = obs_trace.last_trace()
        result_q.put((task_id, True, {
            "result": result,
            "observed": sorted(faults.observed_points()),
            "trace": root.to_json() if root is not None else None,
        }))
    except Exception as e:
        # Process-boundary error shipping: the exception (an injected
        # FaultError included) is not absorbed, it is posted with its full
        # traceback and re-raised in the coordinator as a typed
        # WorkerFailed (TaskPool.join).
        result_q.put((task_id, False, {
            "type": type(e).__name__,
            "message": str(e),
            "traceback": traceback.format_exc(),
            "observed": sorted(faults.observed_points()),
        }))


class TaskPool:
    """One spawn-context process per submitted task, joined with a
    liveness check. Use as a context manager: exit terminates any
    still-running workers (the error path's cleanup)."""

    def __init__(self, name: str = "hs-build", poll_s: float = _DEFAULT_POLL_S,
                 crash_grace_s: float = _CRASH_GRACE_S):
        self._host = ProcessHost(name)
        self._q = self._host.ctx.Queue()
        self._poll_s = float(poll_s)
        self._crash_grace_s = float(crash_grace_s)
        self._pending: dict = {}

    @property
    def host(self) -> ProcessHost:
        return self._host

    def submit(self, task_id, fn, *args) -> None:
        """Spawn one worker running ``fn(*args)``; its return value comes
        back from :meth:`join`. The coordinator's fault-injection state
        and tracer enablement ship along."""
        from hyperspace_tpu_torch.obs import journal as obs_journal

        env = {
            "faults": faults.export_state(),
            "obs_enabled": obs_trace.enabled(),
            "journal": obs_journal.export_state(),
        }
        p = self._host.spawn(task_id, _task_entry, (self._q, task_id, fn, args, env))
        self._pending[task_id] = p

    def join(self, timeout: float | None = None) -> dict:
        """Collect every submitted task's result (task_id -> result).

        Bounded: polls the result queue and, between polls, checks every
        outstanding worker's liveness — a worker dead without a posted
        result raises :class:`WorkerCrashed` (after a short grace for
        the post-then-exit race) instead of hanging the coordinator; a
        posted worker error re-raises as :class:`WorkerFailed` with the
        worker's traceback. `timeout` additionally bounds the whole
        join."""
        import queue as _qmod

        results: dict = {}
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        dead_since: dict = {}
        while self._pending:
            try:
                task_id, ok, envelope = self._q.get(timeout=self._poll_s)
            except _qmod.Empty:
                now = time.monotonic()
                for tid, p in list(self._pending.items()):
                    if p.is_alive():
                        dead_since.pop(tid, None)
                        continue
                    first = dead_since.setdefault(tid, now)
                    if now - first >= self._crash_grace_s:
                        stats.increment("build.worker.crashes")
                        raise WorkerCrashed(
                            f"worker {tid!r} died (exitcode {p.exitcode}) without "
                            f"posting a result — build aborted",
                            task_id=tid, exitcode=p.exitcode,
                        )
                if deadline is not None and now > deadline:
                    raise WorkerCrashed(
                        f"worker pool join timed out after {timeout}s with "
                        f"{len(self._pending)} task(s) outstanding: "
                        f"{sorted(self._pending)}"
                    )
                continue
            self._pending.pop(task_id, None)
            dead_since.pop(task_id, None)
            faults.merge_observed(envelope.get("observed") or ())
            root = envelope.get("trace")
            if ok and root:
                obs_trace.adopt_root(root)
            if not ok:
                raise WorkerFailed(
                    f"worker {task_id!r} failed with {envelope.get('type')}: "
                    f"{envelope.get('message')}\n--- worker traceback ---\n"
                    f"{envelope.get('traceback')}",
                    task_id=task_id, error_type=envelope.get("type"),
                )
            results[task_id] = envelope.get("result")
        for p in self._host.processes().values():
            p.join(timeout=5.0)
        return results

    def __enter__(self) -> "TaskPool":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # Error-path cleanup: workers still running after a crash abort
        # are torn down so the build's finally (exchange-dir sweep) never
        # races live writers.
        self._host.stop(timeout=0.5, grace=2.0)
        self._q.close()
        return False
