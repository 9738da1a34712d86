"""Self-driving operations: the SLO reconciliation control loop.

A port of the JAX package's `serve/controller.py`. Every control signal
and actuator a self-managing installation needs exists in the port in
isolation — `obs/slo.py` computes multi-window burn verdicts,
`session.index_health` records quarantines, `obs/events.py` records
routing demotions, `faults.py` injects failures deterministically, and
the advisor and Action protocols make every mutation crash-safe. This
module composes them into one closed loop:

========================  ==========================================
signal                    actuation (existing crash-safe protocol)
========================  ==========================================
`serve.availability` or   **shed load + tighten quotas**:
`serve.latency_p99`       `QueryServer.set_shed_depth` drops the
pages (multi-window       graceful-saturation threshold to
burn verdict)             `controller.shedRatio` x maxQueueDepth and
                          `TenantQuotas.set_throttle` scales every
                          tenant's refill rate by
                          `controller.quotaFactor`; both restored
                          when the burn recovers.
index quarantined         **heal**: `Hyperspace.recover(name)` (log
(`session.index_health`)  repair + quarantine lift) then — gated by
                          `controller.heal.rebuild` — a full
                          `refresh_index` rebuild through the normal
                          two-phase Action, so the corrupt bytes are
                          actually replaced.
`advisor.routing.demoted` **advisor sweep**:
events cluster            `LifecyclePolicy.sweep()` — still gated by
(`demotionClusterSize`    the `hyperspace.advisor.lifecycle.*`
within `demotion`         opt-ins; the controller only decides WHEN.
`WindowSeconds`)
sustained fleet/serve     **scale the fleet**:
saturation                `FleetSupervisor.set_target_workers` grows
(`fleet_health` queue     the member count by `controller.scale.step`
ratio over               (up to `controller.scale.maxWorkers`) after
`controller.scale.`       `hysteresisTicks` saturated ticks, and
`saturation`)             restores the pre-episode count after
                          `recoveryTicks` calm ticks (the scale-down,
                          like every release, is budget-free).
`jit.recompile_storm`     **storm response**: pin the storming key's
event in the window       signature to the raw-scan route
                          (`RoutingLedger.pin`). Gated by
                          `controller.stormResponse`. The JAX
                          package also drops its jit caches once; the
                          port has none, and emits no storm of its
                          own: only an event that reaches the ring
                          draws the pin.
serve SLOs burning        **back off background work**: heals and
                          sweeps are deferred with a
                          `controller.backoff` event until the burn
                          clears; an attached ingest daemon
                          (`ingest=`, ingest/daemon.py) is paused
                          through its control file after
                          `hysteresisTicks` page ticks (a budgeted
                          actuation) and resumed after
                          `recoveryTicks` calm ticks or by the kill
                          switch (budget-free).
========================  ==========================================

Fleet coordination: N controllers over ONE store must not race their
heals — a quarantined index would be rebuilt N times. Heal actuations
therefore route through the fleet's O_EXCL single-flight lease
(serve/fleet/singleflight.py) keyed per index, with a
generation-stamped marker file as the published artifact: exactly one
member (the lease leader) runs recover+rebuild and bumps the marker
generation; every other member observes the fresh marker, lifts its
LOCAL quarantine via the idempotent `recover()`, and spends neither
budget nor a `controller.heals` count (audited as outcome="observed").
A SIGKILLed healer's lease goes stale after the TTL and the next
member reaps it and takes over (`fleet.singleflight.takeovers`). Every
audit event carries this controller's `member` id. Coordination is
gated by `hyperspace.controller.heal.coordinate` and engages only when
a fleet directory is discoverable (explicit `hyperspace.fleet.cache.dir`,
or an existing store to derive `<system.path>/_fleet` under); otherwise
heals stay process-local. Markers and leases are the JAX package's
files.

Control discipline — the loop must never become its own incident:

- **Kill switch.** `hyperspace.controller.enabled` defaults OFF. A
  running controller that sees it flip releases whatever overrides it
  holds and stands down mid-loop.
- **Hysteresis.** The overload response needs `hysteresisTicks`
  consecutive page verdicts to engage and `recoveryTicks` consecutive
  non-page verdicts to release.
- **Cooldown.** Each actuation (per healed index, per engage) is
  rate-limited by `cooldownSeconds` on the controller's own injectable
  clock.
- **Actuation budget.** `actuationBudget` bounds total mutations per
  controller lifetime. Exhaustion degrades to observe-only — decisions
  are still computed and audited, nothing mutates — announced once by
  an ERROR `controller.observe_only` event. Releases stay free, so the
  system is always left as found.
- **Audit.** Every decision is a structured `controller.*` event
  carrying action/trigger/outcome; `/healthz` surfaces the live
  controller snapshot next to the SLO verdicts.
- **Crash safety.** The `controller.actuate` fault point fires
  immediately BEFORE each mutation: an injected CrashPoint there leaves
  no partial actuation behind, and every mutation goes through APIs
  that are individually crash-safe. An actuation that fails with an
  ordinary Exception is recorded (`controller.actuation_failed`) and
  reconciliation continues, while CrashPoint propagates like the
  process death it simulates.

Incident flight recorder: the controller snapshots a bundle under
`<fleet>/incidents/<ts>-<trigger>/` the moment an episode opens (SLO
page engage, a fresh quarantine, observe-only degradation) and
finalizes it when the episode resolves: event-ring dump, config
snapshot, the process gauges (`proc.json`, where the JAX package writes
its jit report), the routing ledger, the actuation audit trail, and the last N durable
journal segments (obs/journal.py) from every reachable fleet member. At
most ONE bundle is open at a time — later triggers annotate it — under
the same cooldown discipline as every actuator, with retention capped
at `controller.incident.maxBundles`. Advisory: any IO failure is
counted (`controller.incident_errors`), never raised. Bundles are
served read-only at `/debug/incidents` (obs/http.py).
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path

from hyperspace_tpu_torch import faults, stats
from hyperspace_tpu_torch.utils import file_utils
from hyperspace_tpu_torch.obs import events as obs_events
from hyperspace_tpu_torch.obs import metrics as obs_metrics
from hyperspace_tpu_torch.obs import slo as obs_slo
from hyperspace_tpu_torch.obs import trace as obs_trace

# Declared at import (obs/events.py): emit never raises, so audit
# records cannot widen the controller's narrow typed surface.
_EVT_ACTUATION = obs_events.declare("controller.actuation")
_EVT_FAILED = obs_events.declare("controller.actuation_failed")
_EVT_BACKOFF = obs_events.declare("controller.backoff")
_EVT_OBSERVE_ONLY = obs_events.declare("controller.observe_only")
_EVT_INCIDENT = obs_events.declare("controller.incident")
_EVT_STORM = obs_events.declare("controller.storm_response")

_ENGAGED = obs_metrics.gauge(
    "controller.engaged", "1 while the controller's overload response holds overrides"
)
_BUDGET_REMAINING = obs_metrics.gauge(
    "controller.budget_remaining", "actuations left before observe-only degradation"
)

# The serve objectives whose page verdicts drive the overload response.
SERVE_OBJECTIVES = ("serve.availability", "serve.latency_p99")


class OpsController:
    """The reconciliation loop over one session (+ optional QueryServer).

    Construct via ``Hyperspace.controller(server=...)``; `step()` is one
    reconciliation pass (the unit tests drive it with an injectable
    clock), `start()`/`stop()` run it as a daemon loop at
    `hyperspace.controller.intervalSeconds`.
    """

    def __init__(self, hyperspace, server=None, clock=time.monotonic,
                 member_id: str | None = None, supervisor=None, ingest=None):
        # `hyperspace` is the user-facing API facade: the controller has
        # exactly the powers an operator has — recover/refresh and the
        # advisor's lifecycle — no private side doors into the log.
        self.hyperspace = hyperspace
        self.session = hyperspace.session
        self.server = server
        # Fleet identity on every audit event (defaults to the pid —
        # unique per fleet member since members are processes) and the
        # optional supervisor handle the scale actuator drives.
        self.member_id = str(member_id) if member_id else f"pid-{os.getpid()}"
        self.supervisor = supervisor
        # The continuous-ingestion daemon (ingest/daemon.py): paused while
        # serve SLOs burn, resumed on recovery — background commit and
        # compaction IO is the load class the backoff exists for.
        self.ingest = ingest
        self._ingest_paused = False
        self._clock = clock
        self._lock = threading.RLock()
        self._budget = int(self.session.conf.controller_actuation_budget)
        self._observe_only_announced = False
        self._page_ticks = 0
        self._ok_ticks = 0
        self._engaged = False
        self._saved: dict = {}
        self._cooldowns: dict[str, float] = {}
        # The event ring's cursor and the trailing window of routing
        # demotions: (controller time, count) per tick that saw some.
        self._last_seq = 0
        self._demotions: collections.deque = collections.deque()
        self._last_verdicts: dict[str, str] = {}
        self._recent_actions: collections.deque = collections.deque(maxlen=16)
        # Fleet-heal bookkeeping: marker generation last observed per
        # index (fresh generation = another member healed since we
        # looked), and the single-flight lease an in-flight heal holds
        # (its own small lock: stop() must reach it while step() is
        # blocked inside an actuation holding the main lock).
        self._seen_heal_gen: dict[str, int] = {}
        self._lease_lock = threading.Lock()
        self._held_lease: tuple | None = None
        # Incident flight recorder: at most ONE open bundle at a time
        # (later triggers annotate it rather than opening a second);
        # `_seen_quarantine` makes "fresh quarantine" detectable across
        # ticks so re-quarantine after a heal opens a NEW incident.
        self._incident_dir: Path | None = None
        self._incident_trigger: str | None = None
        self._incident_opened_at: float | None = None
        self._incident_notes: list[dict] = []
        self._seen_quarantine: set[str] = set()
        # Scale hysteresis state (mirrors page/ok ticks for saturation).
        self._sat_ticks = 0
        self._calm_ticks = 0
        self._scale_baseline: int | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        _BUDGET_REMAINING.set(self._budget)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "OpsController":
        """Run the loop as a daemon thread; idempotent. Also registers
        this controller with the process-shared health endpoint (if one
        is live) so /healthz carries the controller verdict."""
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="hs-ops-controller", daemon=True
                )
                self._thread.start()
        from hyperspace_tpu_torch.obs import http as obs_http

        shared = obs_http.shared()
        if shared is not None:
            shared.attach_controller(self)
            if self.supervisor is not None:
                # /healthz "fleet" section: member pids/ports and
                # per-member heartbeat ages without a member scrape.
                shared.attach_supervisor(self.supervisor)
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stand the loop down. A heal actuation in flight may hold the
        fleet single-flight lease — release it BEFORE joining, so a
        controller stopped mid-heal (disarm, shutdown) never leaves a
        live lease blocking the fleet for TTL seconds. FileLease.release
        is token-checked and idempotent, so the actuation's own
        `finally` re-release is harmless."""
        self._stop.set()
        with self._lease_lock:
            held = self._held_lease
            self._held_lease = None
        if held is not None:
            lease, token = held
            try:
                lease.release(token)
            except OSError:
                pass  # reaped/expired already — nothing left to free
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        with self._lock:
            self._thread = None

    def __enter__(self) -> "OpsController":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception as e:
                # One failed reconciliation pass must not kill the loop:
                # record it and keep reconciling. CrashPoint is a
                # BaseException and propagates — a dying process does
                # not keep actuating.
                stats.increment("controller.actuation_failures")
                _EVT_FAILED.emit(action="step", error=f"{type(e).__name__}: {e}")
            self._stop.wait(self.session.conf.controller_interval_seconds)

    # -- one reconciliation pass ------------------------------------------
    def step(self, now: float | None = None) -> dict:
        """One reconciliation pass: sample SLOs, drain new events, read
        the quarantines, decide, actuate. Returns the post-step snapshot (the /healthz
        document's `controller` section). `now` overrides the injected
        clock for deterministic tests."""
        conf = self.session.conf
        if now is None:
            now = self._clock()
        now = float(now)
        with self._lock:
            if not conf.controller_enabled:
                # Kill switch mid-loop: release anything we hold, then
                # stand down without observing or deciding anything.
                if self._engaged:
                    self._release_overload(now, trigger="kill_switch")
                if self._ingest_paused:
                    self._resume_ingest(now, trigger="kill_switch")
                self._close_incident(now, resolution="kill_switch")
                return self.snapshot()
            stats.increment("controller.ticks")
            obs_slo.sample(now)
            verdicts = obs_slo.evaluate(now)
            self._last_verdicts = {k: v["verdict"] for k, v in verdicts.items()}
            burning = any(
                self._last_verdicts.get(o) == "page" for o in SERVE_OBJECTIVES
            )
            if burning:
                self._page_ticks += 1
                self._ok_ticks = 0
            else:
                self._ok_ticks += 1
                self._page_ticks = 0
            demotion_cluster, storm_keys = self._drain_events(conf, now)

            # 1. Overload response: shed + tighten quotas while pages
            # persist (hysteresis), restore once the burn clears.
            if (
                burning
                and not self._engaged
                and self._page_ticks >= int(conf.controller_hysteresis_ticks)
            ):
                if self._actuate(
                    "shed.engage", trigger="slo.page", now=now,
                    fn=lambda: self._engage_overload(conf),
                    verdicts=dict(self._last_verdicts),
                ):
                    # The overload response engaging IS the incident
                    # opening: snapshot the system state at the moment
                    # the controller started mutating it.
                    self._open_incident(
                        "slo.page", now, verdicts=dict(self._last_verdicts)
                    )
            elif (
                not burning
                and self._engaged
                and self._ok_ticks >= int(conf.controller_recovery_ticks)
            ):
                self._release_overload(now, trigger="slo.recovered")

            # 1b. Fleet scaling: sustained saturation grows the member
            # count (same hysteresis discipline as the overload
            # response); sustained calm restores the pre-episode count
            # (budget-free, like every release).
            if self.supervisor is not None:
                self._reconcile_scale(conf, now)

            # 1c. Ingest backoff: pause the daemon (durably, through the
            # control file its every tick reads, so it works across
            # process boundaries) while pages persist, resume once the
            # burn clears. Pausing is a budgeted actuation; resuming is
            # budget-free like every release.
            if self.ingest is not None:
                if (
                    burning
                    and not self._ingest_paused
                    and self._page_ticks >= int(conf.controller_hysteresis_ticks)
                ):
                    if self._actuate(
                        "ingest.pause", trigger="slo.page", now=now,
                        fn=lambda: self.ingest.pause(reason="controller.slo_burn"),
                        verdicts=dict(self._last_verdicts),
                    ):
                        self._ingest_paused = True
                elif (
                    not burning
                    and self._ingest_paused
                    and self._ok_ticks >= int(conf.controller_recovery_ticks)
                ):
                    self._resume_ingest(now, trigger="slo.recovered")

            # 2. Heal quarantined indexes — rebuild-class work, deferred
            # while serve SLOs burn (backing off background work is
            # itself the actuation that protects the serve plane).
            with self.session._state_lock:
                quarantined = sorted(self.session.index_health)
            # A FRESH quarantine (not seen last tick) opens an incident
            # bundle — re-quarantine after a successful heal is a new
            # episode and records as one.
            current_q = {Path(r).name for r in quarantined}
            for q_name in sorted(current_q - self._seen_quarantine):
                self._open_incident(f"quarantine.{q_name}", now, index=q_name)
            self._seen_quarantine = current_q
            for root in quarantined:
                name = Path(root).name
                if burning:
                    self._defer_background(
                        conf, "heal", now, index=name, reason="slo.burning"
                    )
                    continue
                self._actuate(
                    f"heal.{name}", trigger="index.quarantined", now=now,
                    fn=lambda n=name: self._heal(conf, n), index=name,
                )

            # 3. Routing demotions clustering means the index layout no
            # longer fits the workload: hand the evidence to the advisor.
            if demotion_cluster:
                if burning:
                    self._defer_background(
                        conf, "advisor.sweep", now, reason="slo.burning"
                    )
                elif self._actuate(
                    "advisor.sweep", trigger="routing.demotion_cluster", now=now,
                    fn=self._sweep, demotions=demotion_cluster,
                ):
                    self._demotions.clear()  # evidence consumed; re-arm

            # 4. Recompile-storm response: pin the storming signature to
            # the raw-scan route. NOT deferred while burning — a storm is
            # itself a serve-plane pressure source, and the response is
            # cheap.
            if conf.controller_storm_response:
                for key in storm_keys:
                    self._actuate(
                        f"storm.response.{key}", trigger="jit.recompile_storm",
                        now=now, fn=lambda k=key: self._storm_response(k),
                        key=key,
                    )

            # 5. Incident close: the episode is over once nothing is
            # burning, no override is engaged, and no index remains
            # quarantined — finalize the open bundle (journal segments
            # from every member, manifest with the audit trail). The
            # quarantine state is re-read: a heal that just executed
            # above empties it THIS tick, and recovery should close the
            # bundle in the same reconciliation pass it happened in.
            if self._incident_dir is not None and not burning and not self._engaged:
                with self.session._state_lock:
                    still_quarantined = bool(self.session.index_health)
                if not still_quarantined:
                    self._close_incident(
                        now, resolution=self._incident_resolution()
                    )
            return self.snapshot()

    # -- signal plumbing --------------------------------------------------
    def _drain_events(self, conf, now: float) -> tuple[int, list[str]]:
        """Fold new ring events into the controller's trailing state;
        returns (demotion count when it constitutes a cluster, the keys
        of fresh `jit.recompile_storm` events, deduplicated in order)."""
        fresh = [e for e in obs_events.recent() if e["seq"] > self._last_seq]
        if fresh:
            self._last_seq = max(e["seq"] for e in fresh)
        storms: list[str] = []
        for e in fresh:
            if e["name"] == "jit.recompile_storm":
                key = str(e.get("fields", {}).get("key", ""))
                if key and key not in storms:
                    storms.append(key)
        n = sum(1 for e in fresh if e["name"] == "advisor.routing.demoted")
        if n:
            self._demotions.append((now, n))
        cutoff = now - float(conf.controller_demotion_window_seconds)
        while self._demotions and self._demotions[0][0] < cutoff:
            self._demotions.popleft()
        total = sum(c for _, c in self._demotions)
        cluster = total if total >= int(conf.controller_demotion_cluster_size) else 0
        return cluster, storms

    # -- actuators --------------------------------------------------------
    def _actuate(self, action: str, trigger: str, now: float, fn, **details) -> bool:
        """Run one mutation under the full control discipline: cooldown,
        budget, fault point, audit. Returns True when it executed."""
        conf = self.session.conf
        if self._cooldowns.get(action, float("-inf")) > now:
            stats.increment("controller.deferred")
            return False
        if self._budget <= 0:
            # Observe-only: the decision is still computed and audited,
            # nothing mutates.
            self._announce_observe_only(now)
            stats.increment("controller.deferred")
            _EVT_ACTUATION.emit(
                action=action, trigger=trigger, outcome="observe_only",
                member=self.member_id, **details,
            )
            return False
        # The fault point fires BEFORE any mutation: a CrashPoint here
        # unwinds out of step() with zero partial state (tested), and a
        # transient FaultError surfaces through the declared contract.
        faults.fault_point("controller.actuate")
        try:
            with obs_trace.span("controller.actuate", action=action, trigger=trigger):
                result = fn()
        except Exception as e:
            # The failed subsystem's own Action already rolled back;
            # record, cool down, keep reconciling. CrashPoint propagates.
            stats.increment("controller.actuation_failures")
            _EVT_FAILED.emit(
                action=action, trigger=trigger, member=self.member_id,
                error=f"{type(e).__name__}: {e}",
            )
            self._cooldowns[action] = now + float(conf.controller_cooldown_seconds)
            return False
        if result == "observed":
            # Fleet-coordinated decision resolved by ANOTHER member (a
            # heal follower): nothing mutated here, so no budget spent
            # and no actuation counted — "exactly one fleet-wide" stays
            # exact — but the decision is audited and cooled down like
            # any other.
            self._cooldowns[action] = now + float(conf.controller_cooldown_seconds)
            record = _EVT_ACTUATION.emit(
                action=action, trigger=trigger, outcome="observed",
                member=self.member_id, budget_remaining=self._budget, **details,
            )
            self._recent_actions.append(
                {"action": action, "trigger": trigger, "at": now,
                 "seq": record["seq"]}
            )
            return True
        self._budget -= 1
        _BUDGET_REMAINING.set(self._budget)
        stats.increment("controller.actuations")
        self._cooldowns[action] = now + float(conf.controller_cooldown_seconds)
        record = _EVT_ACTUATION.emit(
            action=action, trigger=trigger, outcome="executed",
            member=self.member_id, budget_remaining=self._budget, **details,
        )
        self._recent_actions.append(
            {"action": action, "trigger": trigger, "at": now, "seq": record["seq"]}
        )
        return True

    def _engage_overload(self, conf) -> None:
        # Re-entered under the step() RLock; restated here because this
        # runs through the _actuate(fn=...) indirection, which hides the
        # entry-lock guarantee from direct call-site analysis.
        with self._lock:
            saved: dict = {}
            if self.server is not None:
                saved["shed_depth"] = self.server.get_shed_depth()
                self.server.set_shed_depth(
                    int(self.server.max_queue_depth * float(conf.controller_shed_ratio))
                )
                quotas = getattr(self.server, "quotas", None)
                if quotas is not None:
                    saved["throttle"] = quotas.throttle()
                    quotas.set_throttle(float(conf.controller_quota_factor))
            self._saved = saved
            self._engaged = True
            _ENGAGED.set(1)

    def _release_overload(self, now: float, trigger: str) -> None:
        """Restore the pre-engage shed depth and quota throttle. Free of
        budget by design — the controller must always be able to leave
        the system as it found it (kill switch, budget exhaustion)."""
        faults.fault_point("controller.actuate")
        try:
            if self.server is not None:
                if "shed_depth" in self._saved:
                    self.server.set_shed_depth(self._saved["shed_depth"])
                quotas = getattr(self.server, "quotas", None)
                if quotas is not None and "throttle" in self._saved:
                    quotas.set_throttle(self._saved["throttle"])
        except Exception as e:
            stats.increment("controller.actuation_failures")
            _EVT_FAILED.emit(
                action="shed.release", trigger=trigger,
                error=f"{type(e).__name__}: {e}",
            )
            return
        self._engaged = False
        self._saved = {}
        _ENGAGED.set(0)
        record = _EVT_ACTUATION.emit(
            action="shed.release", trigger=trigger, outcome="executed",
            member=self.member_id, budget_remaining=self._budget,
        )
        self._recent_actions.append(
            {"action": "shed.release", "trigger": trigger, "at": now,
             "seq": record["seq"]}
        )

    def _resume_ingest(self, now: float, trigger: str) -> None:
        """Un-pause the ingest daemon we paused. Budget-free, like
        `_release_overload`: the controller can always hand back what it
        took, and a resume that fails stays paused-by-us so the next tick
        retries."""
        faults.fault_point("controller.actuate")
        try:
            self.ingest.resume()
        except Exception as e:
            stats.increment("controller.actuation_failures")
            _EVT_FAILED.emit(
                action="ingest.resume", trigger=trigger,
                error=f"{type(e).__name__}: {e}",
            )
            return
        self._ingest_paused = False
        record = _EVT_ACTUATION.emit(
            action="ingest.resume", trigger=trigger, outcome="executed",
            member=self.member_id, budget_remaining=self._budget,
        )
        self._recent_actions.append(
            {"action": "ingest.resume", "trigger": trigger, "at": now,
             "seq": record["seq"]}
        )

    def _heal(self, conf, name: str):
        """Heal one quarantined index — fleet-coordinated when a fleet
        directory is discoverable, process-local otherwise.

        Coordinated path: the heal routes through the single-flight
        lease keyed per index. The lease LEADER runs the local heal
        (recover + gated rebuild) and publishes a generation-stamped
        marker; every FOLLOWER observes the fresh marker, lifts its own
        quarantine with the idempotent `recover()` (the leader already
        repaired the shared bytes), and returns ``"observed"`` so
        `_actuate` spends no budget and counts no heal — exactly one
        `controller.heals` fleet-wide. Generations (not wall-clock
        timestamps) mark freshness: a member that restarts observes one
        stale marker at most, then heals normally next tick."""
        root = self._fleet_root(conf)
        if root is None:
            self._heal_local(conf, name)
            return None
        from hyperspace_tpu_torch.serve.fleet.singleflight import SingleFlight

        heal_dir = root / "heal"
        heal_dir.mkdir(parents=True, exist_ok=True)
        marker = heal_dir / f"{name}.json"
        sf = SingleFlight(
            heal_dir,
            lease_ttl_s=float(conf.fleet_lease_seconds),
            wait_s=float(conf.fleet_singleflight_wait_seconds),
        )

        def check():
            doc = self._read_marker(marker)
            if doc is None:
                return None
            gen = int(doc.get("generation", 0))
            if gen <= self._seen_heal_gen.get(name, 0):
                return None  # our own past observation, not a fresh heal
            return doc

        def build():
            self._heal_local(conf, name)
            # Torn window: shared bytes healed, marker not yet
            # published. A crash here leaves followers quarantined for
            # one tick; the next leader re-heals idempotently.
            faults.fault_point("controller.heal.marker", marker)
            prior = self._read_marker(marker) or {}
            gen = int(prior.get("generation", 0)) + 1
            self._write_marker(marker, {
                "index": name, "member": self.member_id, "generation": gen,
            })
            self._seen_heal_gen[name] = gen
            return {"led": True, "generation": gen}

        doc = sf.run(f"heal.{name}", build, check=check,
                     on_lease=self._note_lease)
        if isinstance(doc, dict) and not doc.get("led"):
            # Follower: another member rebuilt the shared bytes; lift
            # the LOCAL quarantine (recover is idempotent) and record
            # the generation we acted on.
            self._seen_heal_gen[name] = int(doc.get("generation", 0))
            self.hyperspace.recover(name)
            return "observed"
        return None

    def _heal_local(self, conf, name: str) -> None:
        """recover() repairs the log and lifts the quarantine; the gated
        full refresh rebuilds the data files through the crash-safe
        Action protocol so the corruption is actually gone (not merely
        re-served until the next quarantine)."""
        self.hyperspace.recover(name)
        if conf.controller_heal_rebuild:
            self.hyperspace.refresh_index(name, "full")
        stats.increment("controller.heals")

    def _fleet_root(self, conf) -> Path | None:
        """The shared fleet directory heals coordinate under, or None
        when coordination is off / no fleet root is discoverable (then
        heals stay process-local — the pre-fleet behavior)."""
        if not getattr(conf, "controller_heal_coordinate", True):
            return None
        if getattr(conf, "fleet_cache_dir", ""):
            return Path(conf.fleet_cache_dir)
        sp = Path(conf.system_path)
        if sp.is_dir():
            return sp / "_fleet"
        return None

    def _note_lease(self, lease, token) -> None:
        """SingleFlight's on_lease hook: remember the lease an in-flight
        heal holds so stop() can release it before joining."""
        with self._lease_lock:
            self._held_lease = (lease, token) if lease is not None else None

    @staticmethod
    def _read_marker(path: Path) -> dict | None:
        try:
            return json.loads(path.read_text())
        except (OSError, ValueError):
            return None  # absent or torn: treated as no published heal

    @staticmethod
    def _write_marker(path: Path, doc: dict) -> None:
        # mkstemp + fsync + rename so a follower's read never sees a
        # torn document AND a crash never publishes an empty marker (the
        # rename is durable before the data without the fsync barrier);
        # writer races are excluded by the single-flight lease.
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".heal-",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(doc))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            file_utils.fsync_dir(path.parent)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _reconcile_scale(self, conf, now: float) -> None:
        """Fleet-scale hysteresis: count saturated vs calm ticks from
        the worst of the fleet-aggregate and local queue ratios, grow
        the member count after `hysteresisTicks` saturated ticks, and
        restore the pre-episode baseline after `recoveryTicks` calm
        ticks (budget-free — the controller always leaves the fleet as
        found)."""
        sat = self._saturation_ratio()
        if sat >= float(getattr(conf, "controller_scale_saturation", 0.75)):
            self._sat_ticks += 1
            self._calm_ticks = 0
        else:
            self._calm_ticks += 1
            self._sat_ticks = 0
        current = int(self.supervisor.n)
        max_workers = int(getattr(conf, "controller_scale_max_workers", 8))
        if (
            self._sat_ticks >= int(conf.controller_hysteresis_ticks)
            and current < max_workers
        ):
            step = max(1, int(getattr(conf, "controller_scale_step", 1)))
            target = min(current + step, max_workers)
            baseline = self._scale_baseline if self._scale_baseline is not None else current
            if self._actuate(
                "fleet.scale.up", trigger="fleet.saturation", now=now,
                fn=lambda t=target: self._scale_to(t, conf),
                workers=target, saturation=round(sat, 3),
            ):
                self._scale_baseline = baseline
                self._sat_ticks = 0
        elif (
            self._calm_ticks >= int(conf.controller_recovery_ticks)
            and self._scale_baseline is not None
            and current > self._scale_baseline
        ):
            self._scale_release(conf, now)

    def _saturation_ratio(self) -> float:
        """Worst queue-fullness ratio across the fleet aggregate and the
        local server (either one saturating is a real capacity signal)."""
        ratios = [0.0]
        try:
            agg = self.supervisor.fleet_health().get("saturation", {})
            ratios.append(
                float(agg.get("queue_depth", 0)) / max(1.0, float(agg.get("max_queue_depth", 0)))
            )
        except Exception:
            # Unreachable members count as zero load for this tick, but
            # the failed probe itself is still a signal.
            stats.increment("controller.health_probe_errors")
        if self.server is not None:
            try:
                local = self.server.saturation()
                ratios.append(
                    float(local.get("queue_depth", 0))
                    / max(1.0, float(local.get("max_queue_depth", 0)))
                )
            except Exception:
                stats.increment("controller.health_probe_errors")
        return max(ratios)

    def _scale_to(self, target: int, conf) -> None:
        min_workers = max(1, int(getattr(conf, "fleet_min_workers", 1)))
        self.supervisor.set_target_workers(target, min_workers=min_workers)
        stats.increment("controller.scale")

    def _scale_release(self, conf, now: float) -> None:
        """Restore the pre-episode member count. Budget-free like
        `_release_overload`: the scale-down is the controller leaving
        the fleet as it found it."""
        baseline = self._scale_baseline
        if baseline is None:
            return
        faults.fault_point("controller.actuate")
        try:
            min_workers = max(1, int(getattr(conf, "fleet_min_workers", 1)))
            self.supervisor.set_target_workers(baseline, min_workers=min_workers)
        except Exception as e:
            stats.increment("controller.actuation_failures")
            _EVT_FAILED.emit(
                action="fleet.scale.down", trigger="fleet.recovered",
                member=self.member_id, error=f"{type(e).__name__}: {e}",
            )
            return
        self._scale_baseline = None
        self._calm_ticks = 0
        stats.increment("controller.scale")
        record = _EVT_ACTUATION.emit(
            action="fleet.scale.down", trigger="fleet.recovered",
            outcome="executed", member=self.member_id,
            budget_remaining=self._budget, workers=baseline,
        )
        self._recent_actions.append(
            {"action": "fleet.scale.down", "trigger": "fleet.recovered",
             "at": now, "seq": record["seq"]}
        )

    def _storm_response(self, key: str) -> None:
        """One recompile storm, one response: pin the storming key's
        signature to the raw-scan route (versioned like every routing
        entry: any index mutation re-promotes it)."""
        self.session.routing_ledger().pin(key, "raw")
        _EVT_STORM.emit(key=key, route="raw", member=self.member_id)

    def _sweep(self) -> None:
        # The lifecycle policy's own gates (autoCreate/autoVacuum/
        # autoOptimize, confidence and benefit floors) still decide WHAT
        # may mutate; the controller only decided WHEN to look.
        self.hyperspace.lifecycle().sweep()

    def _defer_background(self, conf, action: str, now: float, **details) -> None:
        stats.increment("controller.deferred")
        key = f"backoff.{action}"
        if self._cooldowns.get(key, float("-inf")) <= now:
            # Rate-limit the audit record, not the deferral itself.
            self._cooldowns[key] = now + float(conf.controller_cooldown_seconds)
            _EVT_BACKOFF.emit(action=action, **details)

    def _announce_observe_only(self, now: float) -> None:
        if not self._observe_only_announced:
            self._observe_only_announced = True
            _EVT_OBSERVE_ONLY.emit(budget_remaining=0)
            # Budget exhaustion is itself an incident: snapshot the
            # moment the controller degraded (open + close in one
            # motion — there is no "recovery" to wait for). An already-
            # open episode is annotated instead, not closed early.
            if self._incident_dir is None:
                self._open_incident("observe_only", now, budget_remaining=0)
                self._close_incident(now, resolution="observe_only")
            else:
                self._incident_notes.append(
                    {"trigger": "observe_only", "at": now, "budget_remaining": 0}
                )

    # -- incident flight recorder -----------------------------------------
    def _incident_root(self, conf) -> Path | None:
        """Where bundles land, or None when the recorder is disabled /
        no root is derivable. NOT gated by `heal.coordinate` — a
        single-process controller still records its incidents."""
        if not getattr(conf, "controller_incident_enabled", True):
            return None
        explicit = getattr(conf, "controller_incident_dir", "")
        if explicit:
            return Path(explicit)
        if getattr(conf, "fleet_cache_dir", ""):
            return Path(conf.fleet_cache_dir) / "incidents"
        sp = Path(conf.system_path)
        if sp.is_dir():
            return sp / "_fleet" / "incidents"
        return None

    def _open_incident(self, trigger: str, now: float, **annotations) -> None:
        """Open ONE incident bundle: `<root>/<ts>-<trigger>/` with the
        state an operator needs at page time — event-ring dump, config
        snapshot, process gauges. Rate-limited per trigger
        by the controller cooldown; retention pruned to
        `controller.incident.maxBundles`. Advisory end to end: IO
        failures are counted, never raised."""
        if self._incident_dir is not None:
            # One open bundle at a time: later triggers annotate it.
            self._incident_notes.append(
                {"trigger": trigger, "at": now, **annotations}
            )
            return
        conf = self.session.conf
        root = self._incident_root(conf)
        if root is None:
            return
        key = f"incident.{trigger}"
        if self._cooldowns.get(key, float("-inf")) > now:
            stats.increment("controller.deferred")
            return
        self._cooldowns[key] = now + float(conf.controller_cooldown_seconds)
        try:
            wall = time.time()  # bundle names + manifest
            # timestamps are operator-facing artifacts, not control flow.
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(wall))
            base = f"{stamp}-{trigger}"
            bundle = root / base
            n = 2
            while bundle.exists():
                bundle = root / f"{base}-{n}"
                n += 1
            bundle.mkdir(parents=True)
            self._write_bundle_state(bundle, trigger, now, wall, annotations)
            self._incident_dir = bundle
            self._incident_trigger = trigger
            self._incident_opened_at = now
            self._incident_notes = []
            stats.increment("controller.incidents")
            _EVT_INCIDENT.emit(
                phase="open", trigger=trigger, bundle=bundle.name,
                member=self.member_id,
            )
            self._prune_incidents(root, int(conf.controller_incident_max_bundles))
        except (OSError, ValueError):
            # Advisory: the flight recorder must never become the
            # incident — the failed write is the count, reconciliation
            # continues untouched.
            stats.increment("controller.incident_errors")

    def _write_bundle_state(
        self, bundle: Path, trigger: str, now: float, wall: float, annotations: dict
    ) -> None:
        from hyperspace_tpu_torch import config as _config
        from hyperspace_tpu_torch.obs import runtime as obs_runtime

        conf = self.session.conf
        file_utils.write_json(bundle / "open.json", {
            "trigger": trigger, "member": self.member_id,
            "at": wall, "clock": now,
            "verdicts": dict(self._last_verdicts),
            "annotations": dict(annotations),
        })
        file_utils.write_json(
            bundle / "events.json", {"events": obs_events.recent(limit=1024)}
        )
        file_utils.write_json(
            bundle / "config.json",
            {k: conf.get(k) for k in sorted(_config.KNOWN_KEYS)},
        )
        file_utils.write_json(bundle / "proc.json", obs_runtime.refresh_process_gauges())
        routing: dict = {}
        ledger = getattr(self.session, "routing_ledger", None)
        if callable(ledger):
            routing = ledger().snapshot()
        file_utils.write_json(bundle / "routing.json", routing)

    def _close_incident(self, now: float, resolution: str) -> None:
        """Finalize the open bundle: seal the local journal, copy the
        last N sealed segments from every reachable member's journal
        dir, refresh the event-ring dump (it now holds the whole
        episode), and write the manifest — resolution plus the
        actuation audit trail. No-op when nothing is open; advisory
        like `_open_incident`."""
        bundle = self._incident_dir
        if bundle is None:
            return
        trigger = self._incident_trigger
        opened_at = self._incident_opened_at
        notes = list(self._incident_notes)
        self._incident_dir = None
        self._incident_trigger = None
        self._incident_opened_at = None
        self._incident_notes = []
        conf = self.session.conf
        try:
            copied = self._copy_journal_segments(
                bundle, int(conf.controller_incident_segments)
            )
            file_utils.write_json(
                bundle / "events.json", {"events": obs_events.recent(limit=1024)}
            )
            wall = time.time()  # manifest timestamps are
            # operator-facing artifacts, not control flow.
            file_utils.write_json(bundle / "manifest.json", {
                "trigger": trigger, "resolution": resolution,
                "member": self.member_id,
                "opened_clock": opened_at, "closed_clock": now,
                "closed_at": wall,
                "verdicts": dict(self._last_verdicts),
                "annotations": notes,
                "actions": list(self._recent_actions),
                "journal_segments": copied,
            })
            _EVT_INCIDENT.emit(
                phase="closed", trigger=trigger, resolution=resolution,
                bundle=bundle.name, member=self.member_id,
            )
        except (OSError, ValueError):
            # Advisory: a bundle without a manifest reads as still-open
            # in /debug/incidents, which is the truthful rendering of a
            # close that could not complete.
            stats.increment("controller.incident_errors")

    def _copy_journal_segments(self, bundle: Path, keep: int) -> int:
        """Copy the last `keep` SEALED journal segments from every
        member's `<_obs>/<pid>/` dir into `bundle/journal/<pid>/`;
        returns the copy count. Sealing the local journal first makes
        this member's in-flight tail durable before the snapshot."""
        from hyperspace_tpu_torch.obs import journal as obs_journal

        obs_journal.seal()
        jroot = obs_journal.root()
        if jroot is None:
            return 0
        jroot = Path(jroot)
        if not jroot.is_dir():
            return 0
        copied = 0
        for proc_dir in sorted(jroot.iterdir()):
            if not (proc_dir.is_dir() and proc_dir.name.isdigit()):
                continue
            segs = obs_journal.segment_paths(proc_dir)[-max(1, keep):]
            if not segs:
                continue
            dest = bundle / "journal" / proc_dir.name
            dest.mkdir(parents=True, exist_ok=True)
            for seg in segs:
                try:
                    shutil.copy2(seg, dest / Path(seg).name)
                    copied += 1
                except OSError:
                    # A live member may evict the segment between the
                    # listing and the copy — count it, keep copying.
                    stats.increment("controller.incident_errors")
        return copied

    def _incident_resolution(self) -> str:
        t = self._incident_trigger or ""
        if t.startswith("slo"):
            return "slo.recovered"
        if t.startswith("quarantine"):
            return "healed"
        return "recovered"

    @staticmethod
    def _prune_incidents(root: Path, keep: int) -> None:
        """Drop the oldest bundle dirs beyond `keep` (names are
        timestamp-prefixed, so lexical order is chronological)."""
        keep = max(1, keep)
        dirs = sorted(d for d in root.iterdir() if d.is_dir())
        for d in dirs[:-keep]:
            shutil.rmtree(d, ignore_errors=True)

    def list_incidents(self) -> list[dict]:
        """Read-only bundle index (the /debug/incidents list): name,
        trigger, open/closed, resolution — newest last."""
        root = self._incident_root(self.session.conf)
        if root is None or not root.is_dir():
            return []
        out = []
        for d in sorted(root.iterdir()):
            if not d.is_dir():
                continue
            doc: dict = {"name": d.name}
            opened = self._read_marker(d / "open.json")
            if opened:
                doc["trigger"] = opened.get("trigger")
                doc["member"] = opened.get("member")
                doc["at"] = opened.get("at")
            manifest = self._read_marker(d / "manifest.json")
            doc["open"] = manifest is None
            if manifest:
                doc["resolution"] = manifest.get("resolution")
            out.append(doc)
        return out

    def read_incident(self, name: str) -> dict | None:
        """One bundle's manifest + open record + file inventory, or
        None for unknown names (the /debug/incidents?name= detail)."""
        if not name or "/" in name or "\\" in name or ".." in name:
            return None  # bundle names never contain path separators
        root = self._incident_root(self.session.conf)
        if root is None:
            return None
        d = root / name
        if not d.is_dir():
            return None
        files = sorted(
            str(p.relative_to(d)) for p in d.rglob("*") if p.is_file()
        )
        doc: dict = {"name": name, "files": files}
        opened = self._read_marker(d / "open.json")
        if opened:
            doc["open"] = opened
        manifest = self._read_marker(d / "manifest.json")
        if manifest:
            doc["manifest"] = manifest
        return doc

    # -- views ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time controller state — the /healthz `controller`
        section."""
        with self._lock:
            enabled = bool(self.session.conf.controller_enabled)
            if not enabled:
                mode = "disabled"
            elif self._budget <= 0:
                mode = "observe_only"
            else:
                mode = "actuate"
            return {
                "enabled": enabled,
                "mode": mode,
                "member": self.member_id,
                "engaged": self._engaged,
                "ingest_paused": self._ingest_paused,
                "budget_remaining": self._budget,
                "verdicts": dict(self._last_verdicts),
                "page_ticks": self._page_ticks,
                "ok_ticks": self._ok_ticks,
                "sat_ticks": self._sat_ticks,
                "scale_baseline": self._scale_baseline,
                "pending_demotions": sum(c for _, c in self._demotions),
                "open_incident": (
                    self._incident_dir.name if self._incident_dir else None
                ),
                "recent_actions": list(self._recent_actions),
            }
