"""Fleet supervisor: spawn, monitor, restart, and drain worker processes.

A port of the JAX package's `serve/fleet/supervisor.py`; its worker
registrations are the same JSON files. One :class:`FleetSupervisor` owns
N worker *processes*: each worker runs its own `HyperspaceSession` +
`QueryServer` over the SAME index store, with a CUDA context, device
cache and derived cache of its own, shares
the fleet's on-disk plan/result cache (fleet/shared_cache.py), and —
with ``hyperspace.obs.http.enabled`` — binds its own ephemeral health
port (obs/http.py `port=0`) and registers it in the fleet directory so
the supervisor (or a load balancer's service discovery) can find every
member's `/metrics` and `/healthz`.

The supervisor's contract:

- **spawn**: workers start via the shared spawn-context lifecycle in
  `parallel/procpool.py` (:class:`~hyperspace_tpu_torch.parallel.procpool.ProcessHost`
  — a forked child of a parent holding a CUDA context cannot use the
  card; the pooled build's TaskPool rides the same primitive); the target is called as
  ``target(ctx, *args)`` with a :class:`WorkerContext` carrying the
  worker id, the fleet directory, and the shared stop event.
- **monitor/restart**: a daemon thread watches liveness; a worker that
  dies with a non-zero exit (including a SIGKILL's negative exitcode)
  is respawned until its restart budget (``hyperspace.fleet.maxRestarts``)
  is spent — each respawn counted in `fleet.supervisor.restarts` and
  announced as a WARN ``fleet.worker.restarted`` event. Workers that
  exit 0 are considered done and stay down. The FIRST respawn of a
  member is immediate; repeat crashes of the SAME member back off
  exponentially (``hyperspace.fleet.restartBackoffSeconds`` base,
  deterministic per-member jitter, capped) so a crash-looping worker
  cannot burn its whole budget in milliseconds — the moment backoff
  engages, a WARN ``fleet.worker.crash_loop`` event names the member.
- **scale**: `set_target_workers(n)` grows or shrinks the member count
  live — the OpsController's fleet actuator (scale up on sustained
  fleet-health saturation, back down on recovery). New members spawn
  through the same env-shipping path as start(); drained members are
  terminated, deregistered, and never respawned. Every change counts
  (`fleet.worker.scaled`), emits an INFO ``fleet.worker.scaled`` event,
  and moves the ``fleet.target_workers`` gauge.
- **drain/stop**: `stop()` sets the shared stop event (workers exit
  their serve loops, QueryServers drain) and joins with a timeout;
  stragglers are terminated. The supervisor is a context manager.
- **fleet health**: `fleet_health()` scrapes every registered member's
  `/healthz` and aggregates scheduler saturation (summed workers /
  inflight / queue depth) plus the worst member status — the fleet-wide
  overload signal a balancer consumes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path

from hyperspace_tpu_torch import faults, stats
from hyperspace_tpu_torch.obs import events as obs_events
from hyperspace_tpu_torch.obs import metrics as obs_metrics
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.parallel.procpool import ProcessHost
from hyperspace_tpu_torch.utils import file_utils

_EVT_RESTARTED = obs_events.declare("fleet.worker.restarted")
_EVT_CRASH_LOOP = obs_events.declare("fleet.worker.crash_loop")
_EVT_SCALED = obs_events.declare("fleet.worker.scaled")

_TARGET_WORKERS = obs_metrics.gauge(
    "fleet.target_workers", "the supervisor's current target member count"
)

_MONITOR_POLL_S = 0.1
_HEALTH_TIMEOUT_S = 5.0
_BACKOFF_CAP_S = 30.0


def _restart_jitter(worker_id: int, attempt: int) -> float:
    """Deterministic jitter fraction in [0, 0.25): spreads simultaneous
    crash-loop respawns without RNG (the faults-harness determinism
    contract extends to the supervisor's timing decisions)."""
    return ((worker_id * 2654435761 + attempt * 40503) % 1000) / 4000.0

WORKERS_DIRNAME = "workers"


@dataclasses.dataclass
class WorkerContext:
    """What a worker target receives: its identity, the fleet's shared
    directory, and the supervisor's stop event (a multiprocessing.Event
    — poll `ctx.stop_event.is_set()` in the serve loop)."""

    worker_id: int
    fleet_dir: str
    stop_event: object


def register_worker(
    fleet_dir: str | os.PathLike, worker_id: int, port: int | None, host: str = "127.0.0.1"
) -> None:
    """Publish this worker's pid + bound health port into the fleet dir
    (atomic write_json) — how ephemeral `port=0` bindings become
    discoverable (obs/http.py)."""
    path = Path(fleet_dir) / WORKERS_DIRNAME / f"{int(worker_id)}.json"
    # Wall clock on purpose: the heartbeat must be comparable from OTHER
    # processes (the supervisor's last-heartbeat ages in /healthz).
    file_utils.write_json(
        path,
        {"pid": os.getpid(), "port": port, "host": host, "ts": time.time()},
    )


def read_workers(fleet_dir: str | os.PathLike) -> dict[int, dict]:
    """Every registered worker's {pid, port, host}, by worker id."""
    root = Path(fleet_dir) / WORKERS_DIRNAME
    out: dict[int, dict] = {}
    try:
        entries = sorted(root.glob("*.json"))
    except OSError:
        return out
    for p in entries:
        try:
            out[int(p.stem)] = file_utils.read_json(p)
        except (OSError, ValueError):
            continue  # torn registration: the worker re-publishes
    return out


def _worker_entry(target, worker_id: int, fleet_dir: str, stop_event, args: tuple,
                  env: dict | None = None) -> None:
    """Module-level shim (spawn needs a picklable top-level callable).

    Cross-boundary continuity (the TaskPool `_task_entry` contract): the coordinator's registered fault rules and tracer
    enablement ship in via `env` and are installed before the worker
    main runs, so a deterministic fault schedule reaches long-lived
    fleet members exactly like pooled build workers. Service workers
    have no result envelope to merge observations back through — their
    telemetry flows out via the per-worker health plane (/metrics,
    /healthz) instead.
    """
    env = env or {}
    fstate = env.get("faults")
    if fstate is not None:
        faults.install_state(fstate)
    obs_trace.set_enabled(bool(env.get("obs_enabled", True)))
    jstate = env.get("journal")
    if jstate is not None:
        from hyperspace_tpu_torch.obs import journal as obs_journal

        obs_journal.install_state(dict(jstate, worker_id=worker_id))
    target(WorkerContext(worker_id, fleet_dir, stop_event), *args)


def _scrape_json(host: str, port: int, path: str, timeout: float = _HEALTH_TIMEOUT_S) -> dict | None:
    """GET a JSON document from a member's health endpoint; None when
    unreachable. A 503 (SLO page) still carries the healthz body —
    read it from the HTTPError."""
    import urllib.error
    import urllib.request

    url = f"http://{host}:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read().decode())
        except (OSError, ValueError):
            return None
    except (OSError, ValueError):
        return None


def _scrape_text(host: str, port: int, path: str, timeout: float = _HEALTH_TIMEOUT_S) -> str | None:
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=timeout) as r:
            return r.read().decode()
    except (OSError, ValueError):
        return None


class FleetSupervisor:
    """Spawn and babysit N worker processes over one index store."""

    def __init__(
        self,
        target,
        fleet_dir: str | os.PathLike,
        n: int | None = None,
        args: tuple = (),
        max_restarts: int | None = None,
        restart_backoff: float | None = None,
        conf=None,
    ):
        n = int(n if n is not None else getattr(conf, "fleet_workers", 2))
        self._target = target
        self.fleet_dir = str(fleet_dir)
        self.n = n
        self._args = tuple(args)
        self.max_restarts = int(
            max_restarts if max_restarts is not None else getattr(conf, "fleet_max_restarts", 3)
        )
        self.restart_backoff = float(
            restart_backoff if restart_backoff is not None
            else getattr(conf, "fleet_restart_backoff_seconds", 0.5)
        )
        # The shared spawn-context worker lifecycle (parallel/procpool.py):
        # the host owns the spawn context, the stop event, and the keyed
        # process registry; the supervisor layers fleet policy (restart
        # budgets, health aggregation) on top.
        self._host = ProcessHost(name="hs-fleet")
        self._stop = self._host.stop_event
        self._lock = threading.Lock()
        self._restarts: dict[int, int] = {}
        # Per-member earliest-next-respawn deadlines (monotonic clock):
        # the crash-loop backoff state, entries live only while a
        # delayed respawn is pending.
        self._restart_at: dict[int, float] = {}
        self._monitor_thread: threading.Thread | None = None
        self._stopping = False
        # Last wall-clock instant each member proved life: a successful
        # /healthz scrape, or its registration heartbeat — whichever is
        # newer. Read (not scraped) by `fleet_summary` so /healthz can
        # show a silently dead member's age between poll ticks.
        self._last_seen: dict[int, float] = {}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        Path(self.fleet_dir, WORKERS_DIRNAME).mkdir(parents=True, exist_ok=True)
        with self._lock:
            for wid in range(self.n):
                self._spawn(wid)
            _TARGET_WORKERS.set(self.n)
            self._monitor_thread = threading.Thread(
                target=self._monitor, name="hs-fleet-monitor", daemon=True
            )
            self._monitor_thread.start()
        return self

    def set_target_workers(self, n: int, min_workers: int = 1) -> int:
        """Scale the fleet to `n` members (the OpsController's fleet
        actuator). Up: fresh ids spawn through the same env-shipping
        path as start(), so the coordinator's fault rules and tracer
        state reach the new members. Down: the highest ids are
        terminated, their registration JSON and restart state dropped,
        so `fleet_health` stops counting them. Clamped to at least
        `min_workers`; returns the applied target. Idempotent — a no-op
        change emits nothing."""
        n = max(int(min_workers), int(n))
        with self._lock:
            if self._stopping:
                return self.n
            old = self.n
            if n == old:
                return old
            to_drain = list(range(n, old))
            for wid in range(old, n):
                # A re-grown slot starts with a fresh restart budget —
                # its crash history belonged to the drained member.
                self._restarts.pop(wid, None)
                self._restart_at.pop(wid, None)
                self._spawn(wid)
            # Publish the new target BEFORE draining: the monitor skips
            # wid >= self.n, so a drained member that exits non-zero in
            # the termination window cannot be respawned.
            self.n = n
        for wid in to_drain:
            self._host.terminate(wid, grace=5.0)
            with self._lock:
                self._restarts.pop(wid, None)
                self._restart_at.pop(wid, None)
            try:
                (Path(self.fleet_dir) / WORKERS_DIRNAME / f"{wid}.json").unlink()
            except OSError:
                pass
        stats.increment("fleet.worker.scaled", abs(n - old))
        _EVT_SCALED.emit(from_workers=old, to_workers=n)
        _TARGET_WORKERS.set(n)
        return n

    def _spawn(self, worker_id: int):
        from hyperspace_tpu_torch.obs import journal as obs_journal

        env = {
            "faults": faults.export_state(),
            "obs_enabled": obs_trace.enabled(),
            "journal": obs_journal.export_state(),
        }
        return self._host.spawn(
            worker_id,
            _worker_entry,
            args=(self._target, worker_id, self.fleet_dir, self._stop, self._args, env),
            name=f"hs-fleet-{worker_id}",
        )

    def _monitor(self) -> None:
        """Respawn crashed members until their restart budget is spent.
        exit 0 = completed (left down); any other exit, including a
        SIGKILL's negative code, = crash. A member crashing AGAIN backs
        off exponentially before its next respawn (first respawn is
        immediate), so a crash-looping worker spends its budget over
        seconds — observable, WARN-announced — not milliseconds."""
        while True:
            with self._lock:
                if self._stopping:
                    return
                now = time.monotonic()
                dead = [
                    (wid, p) for wid, p in self._host.processes().items()
                    if not p.is_alive() and p.exitcode not in (0, None)
                ]
                for wid, p in dead:
                    if isinstance(wid, int) and wid >= self.n:
                        continue  # scaled-down slot: stays down by design
                    used = self._restarts.get(wid, 0)
                    if used >= self.max_restarts:
                        continue
                    if used > 0 and self.restart_backoff > 0:
                        deadline = self._restart_at.get(wid)
                        if deadline is None:
                            delay = min(
                                self.restart_backoff * (2 ** (used - 1)),
                                _BACKOFF_CAP_S,
                            ) * (1.0 + _restart_jitter(wid, used))
                            self._restart_at[wid] = now + delay
                            _EVT_CRASH_LOOP.emit(
                                worker_id=wid, exitcode=p.exitcode,
                                restarts_used=used, delay_s=round(delay, 3),
                            )
                            continue
                        if now < deadline:
                            continue
                    self._restart_at.pop(wid, None)
                    self._restarts[wid] = used + 1
                    self._spawn(wid)
                    stats.increment("fleet.supervisor.restarts")
                    _EVT_RESTARTED.emit(
                        worker_id=wid, exitcode=p.exitcode, restarts=used + 1
                    )
            time.sleep(_MONITOR_POLL_S)

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful drain: signal every worker's stop event, join, then
        terminate stragglers (ProcessHost.stop). Idempotent."""
        with self._lock:
            self._stopping = True
            t = self._monitor_thread
        self._host.stop(timeout=timeout, grace=5.0)
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self) -> "FleetSupervisor":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    # -- views ------------------------------------------------------------
    def alive_count(self) -> int:
        return self._host.alive_count()

    def pids(self) -> dict[int, int | None]:
        return {wid: p.pid for wid, p in self._host.processes().items()}

    def restarts(self) -> dict[int, int]:
        with self._lock:
            return dict(self._restarts)

    def fleet_health(self) -> dict:
        """Aggregate fleet view: every registered member's /healthz plus
        summed scheduler saturation and the worst member status — what a
        load balancer reads to decide where (and whether) to send
        traffic."""
        members: dict[int, dict] = {}
        agg = {"workers": 0, "inflight": 0, "queue_depth": 0, "max_queue_depth": 0}
        rank = {"ok": 0, "degraded": 1, "critical": 2, "unreachable": 2}
        worst = "ok"
        procs = list(self._host.processes().values())
        alive_pids = {p.pid for p in procs if p.is_alive()}
        now = time.time()  # cross-process heartbeat ages
        for wid, reg in read_workers(self.fleet_dir).items():
            port = reg.get("port")
            doc = None
            if port and reg.get("pid") in alive_pids:
                doc = _scrape_json(reg.get("host", "127.0.0.1"), port, "/healthz")
            status = doc["status"] if doc else "unreachable"
            with self._lock:
                seen = self._last_seen.get(wid)
                reg_ts = reg.get("ts")
                if isinstance(reg_ts, (int, float)):
                    seen = max(seen or 0.0, float(reg_ts))
                if doc is not None:
                    seen = max(seen or 0.0, now)
                if seen is not None:
                    self._last_seen[wid] = seen
            members[wid] = {"pid": reg.get("pid"), "port": port, "status": status,
                            "last_heartbeat_age_s":
                                round(now - seen, 3) if seen else None,
                            "healthz": doc}
            if rank.get(status, 2) > rank.get(worst, 0):
                worst = status
            for sched in (doc or {}).get("scheduler", []):
                for k in agg:
                    agg[k] += int(sched.get(k, 0))
        with self._lock:
            spawned = self.n
        return {"status": worst, "saturation": agg, "members": members,
                "alive": self.alive_count(), "spawned": spawned}

    def fleet_summary(self) -> dict:
        """Cheap fleet view for /healthz: member pids/ports and per-member
        last-heartbeat age WITHOUT scraping anyone (reads the fleet dir's
        registrations and the liveness the supervisor already tracks) —
        a silently dead member shows a growing age here between
        `fleet_health` poll ticks instead of disappearing."""
        now = time.time()  # cross-process heartbeat ages
        procs = dict(self._host.processes())
        members: dict[int, dict] = {}
        for wid, reg in read_workers(self.fleet_dir).items():
            with self._lock:
                seen = self._last_seen.get(wid)
            reg_ts = reg.get("ts")
            if isinstance(reg_ts, (int, float)):
                seen = max(seen or 0.0, float(reg_ts))
            p = procs.get(wid)
            members[wid] = {
                "pid": reg.get("pid"),
                "port": reg.get("port"),
                "alive": bool(p.is_alive()) if p is not None else None,
                "last_heartbeat_age_s": round(now - seen, 3) if seen else None,
            }
        with self._lock:
            spawned = self.n
        return {"members": members, "alive": self.alive_count(), "spawned": spawned}

    def aggregate_metrics(self) -> dict[int, str]:
        """Raw Prometheus text per registered live member (a scrape
        federation shim; each page is already namespaced per process by
        its scrape origin)."""
        out: dict[int, str] = {}
        procs = list(self._host.processes().values())
        alive_pids = {p.pid for p in procs if p.is_alive()}
        for wid, reg in read_workers(self.fleet_dir).items():
            port = reg.get("port")
            if not port or reg.get("pid") not in alive_pids:
                continue
            text = _scrape_text(reg.get("host", "127.0.0.1"), port, "/metrics")
            if text is not None:
                out[wid] = text
        return out
