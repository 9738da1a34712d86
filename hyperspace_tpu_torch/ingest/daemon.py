"""The continuous-ingestion service loop.

A port of the JAX package's `ingest/daemon.py`. One :class:`IngestDaemon`
watches a set of indexes: each tick it tails their CDC changelogs, detects
arrived files, commits a micro-batch through the two-phase refresh action
when anything was appended, and triggers gated compaction when delta
pressure passes the lifecycle threshold. The loop has the controller's
shape (serve/controller.py `_run`): ordinary Exceptions are absorbed per
index (``ingest.commit_failures`` / ``ingest.compact_failures``; the
failed action's own rollback already ran), a CrashPoint propagates, so a
dying daemon does not keep committing.

Hosting: a thread by default, committing on its session's device;
``hyperspace.ingest.processWorker`` spawns :func:`_service_entry` through
``parallel/procpool.ProcessHost`` instead, shipping the fault, journal
and tracer state as the pooled build does and the parent session's
device: the worker rebuilds its session on that device and, on the card,
opens a CUDA context of its own, as a fleet member does. A worker asked
for the card where there is none raises; it never falls back to the CPU.
Control state (pause / resume) is an atomically written JSON file under
``<system_path>/_ingest/`` read every tick, so the controller's backoff
works across the process boundary and survives a SIGKILL.

The daemon registers with the shared ``/healthz`` endpoint
(obs/http.attach_ingest) and journals through its events; ``drain()``
blocks until the watched indexes' log ids stop advancing with nothing
observed pending: the streaming analog of a flush.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

from hyperspace_tpu_torch import faults, stats
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.ingest import writer as ingest_writer
from hyperspace_tpu_torch.ingest.tailer import CdcTailer, Cursor, FileArrivalWatcher
from hyperspace_tpu_torch.obs import events as obs_events
from hyperspace_tpu_torch.obs import slo as obs_slo
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.utils import file_utils

_EVT_STARTED = obs_events.declare("ingest.started")
_EVT_STOPPED = obs_events.declare("ingest.stopped")
_EVT_COMMIT_FAILED = obs_events.declare("ingest.commit_failed")
_EVT_PAUSED = obs_events.declare("ingest.paused")
_EVT_RESUMED = obs_events.declare("ingest.resumed")
_EVT_LAGGING = obs_events.declare("ingest.lagging")

# State dir under the system path; underscore-prefixed so
# PathResolver.list_index_paths never takes it for an index.
INGEST_DIR = "_ingest"
CONTROL_FILE = "control.json"

# Rate limit of the advisory ingest.lagging event (one a window an index,
# not one a tick while behind).
_LAG_EMIT_INTERVAL_S = 5.0


class IngestDaemon:
    """Poll-commit-compact service over a set of watched indexes."""

    def __init__(self, hyperspace, clock=time.monotonic):
        self.hyperspace = hyperspace
        self.session = hyperspace.session
        self._clock = clock
        self._lock = threading.RLock()
        self._watches: dict[str, dict] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._host = None  # ProcessHost in processWorker mode
        self._pending_since: dict[str, float] = {}
        self._last_commit_id: dict[str, int] = {}
        self._last_lag_s: float | None = None
        self._lag_last_emit: dict[str, float] = {}
        self._commits = 0

    # -- wiring ---------------------------------------------------------

    @property
    def _state_dir(self) -> Path:
        return Path(self.session.conf.system_path) / INGEST_DIR

    @property
    def control_path(self) -> Path:
        return self._state_dir / CONTROL_FILE

    def watch(self, name: str, changelog: str | Path | None = None) -> "IngestDaemon":
        """Register an index: its source roots get arrival watchers; an
        optional JSONL `changelog` gets a CDC tailer materializing into the
        index's first source root."""
        mgr = self.session.manager
        lm = mgr.log_manager_factory(mgr.path_resolver.get_index_path(name))
        entry = lm.get_latest_stable_log()
        if entry is None or entry.source is None:
            raise HyperspaceError(
                f"cannot watch {name!r}: no stable index log entry — create the index first"
            )
        from hyperspace_tpu_torch.ingest.snapshot import _scan_leaves

        leaves = _scan_leaves(entry.source.plan)
        if not leaves:
            raise HyperspaceError(f"cannot watch {name!r}: its source plan has no scan leaves")
        cursor = Cursor(self._state_dir / "cursors" / f"{name}.json")
        watchers = [FileArrivalWatcher(leaf["root"], leaf["format"], cursor) for leaf in leaves]
        tailer = CdcTailer(changelog, leaves[0]["root"], cursor) if changelog else None
        with self._lock:
            self._watches[name] = {"watchers": watchers, "tailer": tailer, "changelog": changelog}
        return self

    # -- control plane --------------------------------------------------

    def pause(self, reason: str = "") -> None:
        """Throttle the daemon: ticks become deferred no-ops until
        resume(). Written atomically, so a process-mode worker (or a
        daemon restarted after a SIGKILL) observes it too."""
        file_utils.write_json(self.control_path, {"paused": True, "reason": reason})
        _EVT_PAUSED.emit(reason=reason)

    def resume(self) -> None:
        file_utils.write_json(self.control_path, {"paused": False, "reason": ""})
        _EVT_RESUMED.emit()

    def paused(self) -> bool:
        try:
            doc = file_utils.read_json(self.control_path)
        except (OSError, ValueError):
            return False
        return bool(isinstance(doc, dict) and doc.get("paused"))

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "IngestDaemon":
        conf = self.session.conf
        with self._lock:
            if self._thread is not None or self._host is not None:
                return self
            self._stop.clear()
            if conf.ingest_process_worker:
                self._start_process(conf)
            else:
                self._thread = threading.Thread(target=self._run, name="hs-ingest", daemon=True)
                self._thread.start()
            watched = sorted(self._watches)
            mode = "process" if self._host is not None else "thread"
        from hyperspace_tpu_torch.obs import http as obs_http

        shared = obs_http.shared()
        if shared is not None:
            shared.attach_ingest(self)
        _EVT_STARTED.emit(watched=watched, mode=mode)
        return self

    def _start_process(self, conf) -> None:
        from hyperspace_tpu_torch.obs import journal as obs_journal
        from hyperspace_tpu_torch.parallel.procpool import ProcessHost

        host = ProcessHost("hs-ingest")
        env = {
            "faults": faults.export_state(),
            "obs_enabled": obs_trace.enabled(),
            "journal": obs_journal.export_state(),
            "overrides": dict(getattr(conf, "overrides", {}) or {}),
            # The worker commits on the parent session's device, never on
            # one it picks for itself.
            "device": str(self.session.device),
        }
        watches = [(n, str(w["changelog"]) if w["changelog"] else None)
                   for n, w in sorted(self._watches.items())]
        host.spawn("ingest", _service_entry, (str(conf.system_path), watches, env, host.stop_event),
                   name="hs-ingest-0")
        self._host = host

    def stop(self, timeout: float = 30.0) -> None:
        with self._lock:
            thread, host = self._thread, self._host
            self._thread = None
            self._host = None
        self._stop.set()
        if thread is not None:
            thread.join(timeout)
        if host is not None:
            host.stop(timeout=timeout)
        _EVT_STOPPED.emit()

    def worker_pid(self) -> int | None:
        """The spawned worker's pid (processWorker mode)."""
        with self._lock:
            if self._host is None:
                return None
            procs = self._host.processes()
            return next(iter(procs.values())).pid if procs else None

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the watched log ids stop advancing and nothing
        observed is pending commit. When the daemon is not running, the
        drain drives tick() itself."""
        deadline = time.monotonic() + timeout
        poll = max(float(self.session.conf.ingest_poll_seconds), 0.05)
        stable = 0
        last = None
        while time.monotonic() < deadline:
            with self._lock:
                in_process = self._host is not None
                running = self._thread is not None or in_process
                # Parent-side pending state means nothing in process mode
                # (the worker owns it); log ids are the progress signal
                # either way.
                pending = bool(self._pending_since) and not in_process
            if not running:
                self.tick()
                with self._lock:
                    pending = bool(self._pending_since)
            ids = tuple(sorted(self._log_ids().items()))
            if ids == last and not pending:
                stable += 1
                if stable >= 2:
                    return True
            else:
                stable = 0
                last = ids
            if running:
                time.sleep(poll)
        return False

    def _log_ids(self) -> dict[str, int | None]:
        mgr = self.session.manager
        with self._lock:
            names = sorted(self._watches)
        return {name: mgr.log_manager_factory(mgr.path_resolver.get_index_path(name)).get_latest_id()
                for name in names}

    def _run(self) -> None:
        """Service loop: absorbs ordinary Exceptions (tick records them
        per index; anything escaping tick is counted here), propagates
        CrashPoint."""
        conf = self.session.conf
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the service loop survives
                stats.increment("ingest.commit_failures")
                _EVT_COMMIT_FAILED.emit(error=f"{type(e).__name__}: {e}")
            self._stop.wait(float(conf.ingest_poll_seconds))

    # -- the tick -------------------------------------------------------

    def tick(self, now: float | None = None) -> dict:
        """One poll pass over every watched index; returns snapshot()."""
        conf = self.session.conf
        if now is None:
            now = self._clock()
        with self._lock:
            if not conf.ingest_enabled:
                # The kill switch (hyperspace.ingest.enabled, default off):
                # flipping it makes every tick a no-op without a restart.
                return self.snapshot()
            stats.increment("ingest.ticks")
            if self.paused():
                stats.increment("ingest.deferred")
                return self.snapshot()
            burning = self._slo_burning()
            for name, w in sorted(self._watches.items()):
                try:
                    self._tick_index(conf, name, w, now, burning)
                except Exception as e:  # noqa: BLE001 — one index's failure
                    # must not starve the others; its action already rolled
                    # back. A CrashPoint propagates.
                    stats.increment("ingest.commit_failures")
                    _EVT_COMMIT_FAILED.emit(index=name, error=f"{type(e).__name__}: {e}")
            return self.snapshot()

    def _tick_index(self, conf, name: str, w: dict, now: float, burning: bool) -> None:
        with obs_trace.trace("ingest.tick", index=name):
            observed = 0
            if w["tailer"] is not None:
                observed += w["tailer"].poll(int(conf.ingest_cdc_batch_rows))
            for watcher in w["watchers"]:
                observed += watcher.poll()
            if observed and name not in self._pending_since:
                self._pending_since[name] = now
            # Lag is checked before the commit: a failing commit (where lag
            # matters) must still warn.
            self._check_lag(conf, name, now)
            new_id = ingest_writer.commit_micro_batch(self.hyperspace, name)
            if new_id is not None:
                # Torn window: the micro-batch committed (its log entry is
                # durable) but the bookkeeping is not stamped yet. A crash
                # here is converged by recover(); the next committing tick
                # restamps from the log.
                faults.fault_point("ingest.stamp", name)
                self._commits += 1
                self._last_commit_id[name] = new_id
                since = self._pending_since.pop(name, now)
                self._last_lag_s = max(now - since, 0.0)
            else:
                # Empty poll: nothing appended at the source, so nothing is
                # pending either; data a crashed commit (converged by
                # recover()) already landed must not wedge drain().
                self._pending_since.pop(name, None)
            try:
                ingest_writer.maybe_compact(self.hyperspace, name, burning=burning)
            except Exception as e:  # noqa: BLE001 — compaction is optional work
                stats.increment("ingest.compact_failures")
                _EVT_COMMIT_FAILED.emit(index=name, phase="compact", error=f"{type(e).__name__}: {e}")

    def _check_lag(self, conf, name: str, now: float) -> None:
        since = self._pending_since.get(name)
        if since is None:
            return
        lag = now - since
        if lag <= float(conf.ingest_max_lag_seconds):
            return
        last = self._lag_last_emit.get(name)
        if last is not None and now - last < _LAG_EMIT_INTERVAL_S:
            return
        self._lag_last_emit[name] = now
        _EVT_LAGGING.emit(index=name, lag_s=round(lag, 3), max_lag_s=float(conf.ingest_max_lag_seconds))

    def _slo_burning(self) -> bool:
        """Is any serve objective paging? Compaction defers behind this, as
        the controller's backoff does."""
        try:
            from hyperspace_tpu_torch.serve.controller import SERVE_OBJECTIVES

            verdicts = obs_slo.evaluate()
            return any(verdicts.get(o, {}).get("verdict") == "page" for o in SERVE_OBJECTIVES)
        except Exception:  # noqa: BLE001 — an advisory signal never blocks ingest
            return False

    def snapshot(self) -> dict:
        """The /healthz section (obs/http.py): cheap and lock-consistent."""
        with self._lock:
            now = self._clock()
            return {
                "enabled": bool(self.session.conf.ingest_enabled),
                "running": self._thread is not None or self._host is not None,
                "mode": "process" if self._host is not None else "thread",
                "paused": self.paused(),
                "watched": sorted(self._watches),
                "commits": self._commits,
                "last_commit_ids": dict(self._last_commit_id),
                "pending_lag_seconds": {n: round(now - t, 3) for n, t in self._pending_since.items()},
                "last_commit_lag_seconds": self._last_lag_s,
            }


def _service_entry(system_path, watches, env, stop_event):
    """Worker-process service entry (processWorker mode). Installs the
    shipped fault, tracer and journal state, rebuilds a session over
    `system_path` on the device the parent named (``env["device"]``), and
    runs the same tick loop: commits go through the same two-phase action
    protocol, so a SIGKILL here converges through recover() like a crashed
    operator process."""
    fault_state = env.get("faults")
    if fault_state is not None:
        faults.install_state(fault_state)
    obs_trace.set_enabled(bool(env.get("obs_enabled", True)))
    journal_state = env.get("journal")
    if journal_state is not None:
        from hyperspace_tpu_torch.obs import journal as obs_journal

        obs_journal.install_state(journal_state)
    from hyperspace_tpu_torch.hyperspace import Hyperspace, HyperspaceSession

    # The device is required: a worker sent to the card that finds none
    # raises here (device.resolve_device) rather than run on the CPU.
    session = HyperspaceSession(system_path=system_path, device=env["device"])
    for key, value in (env.get("overrides") or {}).items():
        session.conf.set(key, value)
    daemon = IngestDaemon(Hyperspace(session))
    for name, changelog in watches:
        daemon.watch(name, changelog=changelog)
    poll = float(session.conf.ingest_poll_seconds)
    while not stop_event.is_set():
        try:
            daemon.tick()
        except Exception as e:  # noqa: BLE001 — the service loop survives
            stats.increment("ingest.commit_failures")
            _EVT_COMMIT_FAILED.emit(error=f"{type(e).__name__}: {e}")
        stop_event.wait(poll)
