"""The port's operations controller (serve/controller.py) on the CPU.

tests/test_controller.py's cases through the port, on fake sessions and
injected clocks: the SLO page engaging shed and quota throttle and its
release, the heal (recover, then the gated rebuild) deferred while serve
SLOs burn, hysteresis, cooldown, the actuation budget's observe-only mode,
the kill switch, the `controller.actuate` fault point, the loop, the fleet
heal through the single-flight lease and its generation marker, fleet
scaling, and the incident bundles with journal segments of two members.
Held against the JAX package: one seeded script of signals (serve
traffic and failure bursts, quarantines, fleet saturation, a failing
heal, the kill switch) goes through both packages' controllers step by
step, and both give the same audit events in order, the same shed depth
and quota factor, and the same target worker count; a heal the JAX
package's controller leads is observed by the port's, and the reverse.
The script again with clusters of routing demotions and recompile storms
put on the rings: the same advisor sweeps (deferred while serve SLOs
burn), the same raw pins and the same audit events in order. The sweep
and the storm pin on a real session: demotions run_query emitted trigger
one audited sweep that mutates nothing with the lifecycle gates off, and
a storm's pin routes the signature raw. Left out with what it drives: the
ingest pause.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from hyperspace_tpu.config import HyperspaceConf as JaxConf
from hyperspace_tpu.obs import events as jax_events
from hyperspace_tpu.obs import metrics as jax_metrics
from hyperspace_tpu.serve.controller import OpsController as JaxOpsController
from hyperspace_tpu.serve.fleet.quota import TenantQuotas as JaxTenantQuotas
from hyperspace_tpu.serve.scheduler import QueryServer as JaxQueryServer

from hyperspace_tpu_torch import faults, stats
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.faults import CrashPoint
from hyperspace_tpu_torch.obs import events, journal, metrics, slo, trace
from hyperspace_tpu_torch.obs import http as obs_http
from hyperspace_tpu_torch.serve.controller import OpsController
from hyperspace_tpu_torch.serve.fleet.quota import TenantQuotas
from hyperspace_tpu_torch.serve.fleet.singleflight import key_name
from hyperspace_tpu_torch.serve.scheduler import QueryServer


@pytest.fixture(autouse=True)
def _port_obs_reset():
    """The port's process-global state, zeroed around each test
    (tests/conftest.py resets the JAX package's)."""
    stats.reset()
    metrics.REGISTRY.reset()
    trace.reset()
    trace.set_enabled(True)
    events.reset()
    slo.reset()
    journal.reset()
    faults.reset()
    yield
    faults.reset()
    journal.reset()
    slo.reset()
    events.reset()
    while obs_http.shared() is not None:
        obs_http.release()


class FakeSession:
    """The session surface the controller reads: conf + the lock-guarded
    index_health map."""

    def __init__(self, conf_cls=HyperspaceConf, **conf_overrides):
        self.conf = conf_cls()
        self.conf.set("hyperspace.controller.enabled", "true")
        for k, v in conf_overrides.items():
            self.conf.set(k, v)
        self._state_lock = threading.RLock()
        self.index_health = {}
        self.ledger = FakeLedger()

    def routing_ledger(self):
        return self.ledger


class FakeLedger:
    """The routing ledger surface the storm response pins through."""

    def __init__(self):
        self.pins = []

    def pin(self, signature, mode="raw"):
        self.pins.append((signature, mode))

    def snapshot(self):
        return {"pins": list(self.pins)}


class FakeLifecycle:
    def __init__(self, hs):
        self._hs = hs

    def sweep(self):
        self._hs._maybe_fail()
        self._hs.calls.append(("sweep",))
        return {"applied": [], "skipped": [], "failed": []}


class FakeHyperspace:
    """The facade surface the controller actuates through; records every
    call."""

    def __init__(self, session):
        self.session = session
        self.calls = []
        self.fail_next = None

    def _maybe_fail(self):
        if self.fail_next is not None:
            exc, self.fail_next = self.fail_next, None
            raise exc("injected facade failure")

    def recover(self, name=None):
        self._maybe_fail()
        self.calls.append(("recover", name))
        with self.session._state_lock:
            for root in [r for r in self.session.index_health if name is None or r.endswith(name)]:
                self.session.index_health.pop(root)
        return {}

    def refresh_index(self, name, mode="full"):
        self._maybe_fail()
        self.calls.append(("refresh", name, mode))

    def lifecycle(self):
        return FakeLifecycle(self)


class FakeSupervisor:
    """The FleetSupervisor surface the scale actuator drives."""

    def __init__(self, n=2):
        self.n = n
        self.calls = []
        self.saturation = {"queue_depth": 0, "max_queue_depth": 64}

    def set_target_workers(self, n, min_workers=1):
        self.calls.append(("scale", n, min_workers))
        self.n = max(min_workers, n)
        return self.n

    def fleet_health(self):
        return {"saturation": dict(self.saturation)}


def _serve_counters(mod=metrics):
    return (mod.counter("serve.completed"), mod.counter("serve.failed"), mod.counter("serve.timeouts"),
            mod.counter("serve.cancelled"), mod.histogram("serve.latency.seconds"))


def _controller(server=None, **conf_overrides):
    session = FakeSession(**conf_overrides)
    hs = FakeHyperspace(session)
    return hs, OpsController(hs, server=server, clock=lambda: 0.0)


def _drive_page(completed, failed, ctrl, t0=0.0):
    """Baseline traffic, then a hard failure burst: a sustained availability
    page. Returns the time of the second consecutive page step."""
    completed.inc(10_000)
    ctrl.step(now=t0)
    ctrl.step(now=t0 + 4000.0)
    failed.inc(3_000)
    ctrl.step(now=t0 + 4030.0)
    ctrl.step(now=t0 + 4031.0)
    return t0 + 4031.0


def _actuation_events(action=None):
    out = [e for e in events.recent() if e["name"] == "controller.actuation"]
    return out if action is None else [e for e in out if e["fields"]["action"] == action]


@pytest.fixture
def shed_server():
    """A real QueryServer (DI run_fn) with real TenantQuotas: the overload
    actuation surface."""
    server = QueryServer(FakeSession(), workers=1, max_queue_depth=32, run_fn=lambda p: p,
                         quotas=TenantQuotas(rate=10.0, burst=10.0))
    try:
        yield server
    finally:
        server.shutdown()


# -- held against the JAX package -------------------------------------------


_AUDITED = ("controller.actuation", "controller.actuation_failed", "controller.backoff",
            "controller.observe_only", "controller.incident", "slo.burn", "fleet.singleflight.takeover",
            "controller.storm_response")


def _audit(ring, since: int) -> list:
    out = []
    for e in ring.recent():
        if e["seq"] <= since or e["name"] not in _AUDITED:
            continue
        f = e["fields"]
        out.append((e["name"], f.get("action"), f.get("trigger"), f.get("outcome"), f.get("phase"),
                    f.get("resolution"), f.get("workers"), f.get("budget_remaining"), f.get("demotions"),
                    f.get("key"), f.get("route")))
    return out


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_scripted_signals_give_the_jax_packages_decisions(tmp_path, seed):
    """One seeded script through both packages' controllers, step by step:
    the same audit events in order (actuations with their trigger and
    outcome, deferrals, failures, observe-only, incident open and close,
    burn pages), the same shed depth, quota factor and target worker
    count after every step."""
    seen = _scripted(tmp_path, seed)
    assert {"shed.engage", "shed.release", "fleet.scale.up"} <= set(seen)
    assert any(a.startswith("heal.") for a in seen if a)


@pytest.mark.parametrize("seed", [7, 9])
def test_scripted_demotions_and_storms_give_the_jax_packages_decisions(tmp_path, seed):
    """The seeded script with clusters of `advisor.routing.demoted` events
    and `jit.recompile_storm` events put on each package's ring: the same
    advisor sweeps (deferred while serve SLOs burn), the same raw pins and
    the same audit events in order, step by step."""
    seen = _scripted(tmp_path, seed, advisor=True)
    assert "advisor.sweep" in seen and any(a.startswith("storm.response.") for a in seen if a)
    assert "controller.storm_response" in seen


def _scripted(tmp_path, seed, advisor=False) -> list:
    """Runs the seeded script through both packages' controllers and
    returns the audit's actions (or event names) in order. With
    `advisor`, each step may also put 1-3 routing demotions and a
    recompile storm of one of two keys on both rings."""
    rng = np.random.default_rng(seed)
    conf = {"hyperspace.controller.actuationBudget": 7, "hyperspace.controller.cooldownSeconds": 20.0,
            "hyperspace.controller.scale.maxWorkers": 4}
    sides = []
    for pkg, conf_cls, mod, qs_cls, tq_cls, ctrl_cls, ring in (
            ("port", HyperspaceConf, metrics, QueryServer, TenantQuotas, OpsController, events),
            ("jax", JaxConf, jax_metrics, JaxQueryServer, JaxTenantQuotas, JaxOpsController, jax_events)):
        session = FakeSession(conf_cls, **conf, **{
            "hyperspace.system.path": str(tmp_path / pkg / "absent"),
            "hyperspace.controller.incident.dir": str(tmp_path / pkg / "incidents")})
        hs = FakeHyperspace(session)
        server = qs_cls(session, workers=1, max_queue_depth=32, run_fn=lambda p: p,
                        quotas=tq_cls(rate=10.0, burst=10.0))
        sup = FakeSupervisor(n=2)
        ctrl = ctrl_cls(hs, server=server, clock=lambda: 0.0, member_id="m", supervisor=sup)
        sides.append({"hs": hs, "server": server, "sup": sup, "ctrl": ctrl, "ring": ring,
                      "counters": _serve_counters(mod), "seq": 0})
    try:
        for side in sides:
            side["counters"][0].inc(10_000)
        t, seen = 0.0, []
        for step in range(70):
            t += float(rng.choice([1.0, 2.0, 5.0, 30.0, 70.0, 4000.0], p=[.3, .2, .15, .15, .15, .05]))
            roll = rng.random()
            ok, bad = int(rng.integers(1_000, 20_000)), 0
            if roll < 0.15:
                bad = int(rng.integers(2_000, 9_000))
            quarantine = f"/idx/i{int(rng.integers(0, 3))}" if rng.random() < 0.12 else None
            sat = int(rng.choice([0, 10, 60, 64])) if rng.random() < 0.3 else None
            fail_heal = rng.random() < 0.08
            flip = rng.random() < 0.04
            demoted = storm = 0
            if advisor:
                demoted = int(rng.integers(1, 4)) if rng.random() < 0.25 else 0
                storm = f"sig-{int(rng.integers(0, 2))}" if rng.random() < 0.08 else None
            for side in sides:
                side["counters"][0].inc(ok)
                side["counters"][1].inc(bad)
                if quarantine:
                    with side["hs"].session._state_lock:
                        side["hs"].session.index_health[quarantine] = {"reason": "torn"}
                if sat is not None:
                    side["sup"].saturation["queue_depth"] = sat
                if fail_heal:
                    side["hs"].fail_next = RuntimeError
                if flip:
                    enabled = side["hs"].session.conf.controller_enabled
                    side["hs"].session.conf.set("hyperspace.controller.enabled", "false" if enabled else "true")
                for i in range(demoted):
                    side["ring"].declare("advisor.routing.demoted").emit(signature=f"s{step}.{i}")
                if storm:
                    side["ring"].declare("jit.recompile_storm").emit(key=storm, recompiles=9)
                side["ctrl"].step(now=t)
            got = []
            for side in sides:
                audit = _audit(side["ring"], side["seq"])
                side["seq"] = max([side["seq"]] + [e["seq"] for e in side["ring"].recent()])
                snap = side["ctrl"].snapshot()
                got.append((audit, side["server"].get_shed_depth(), side["server"].quotas.throttle(), side["sup"].n,
                            snap["engaged"], snap["mode"], snap["budget_remaining"], side["hs"].calls[:],
                            sorted(side["hs"].session.index_health), snap["pending_demotions"],
                            side["hs"].session.ledger.pins[:]))
            assert got[0] == got[1], f"step {step} at t={t}"
            seen += [a[1] or a[0] for a in got[0][0]]
        return seen
    finally:
        for side in sides:
            side["server"].shutdown()


@pytest.mark.parametrize("leader", ["jax", "port"])
def test_a_heal_led_by_one_package_is_observed_by_the_other(tmp_path, leader):
    """Two controllers of the two packages over one store: the leader's
    heal publishes the generation marker, the other observes it (recover
    only, no budget, outcome "observed")."""
    made = {}
    for pkg, conf_cls, ctrl_cls in (("port", HyperspaceConf, OpsController), ("jax", JaxConf, JaxOpsController)):
        session = FakeSession(conf_cls, **{"hyperspace.system.path": str(tmp_path)})
        with session._state_lock:
            session.index_health["/idx/shared"] = {"reason": "torn"}
        hs = FakeHyperspace(session)
        made[pkg] = (hs, ctrl_cls(hs, clock=lambda: 0.0, member_id=f"member-{pkg}"))
    follower = "port" if leader == "jax" else "jax"
    made[leader][1].step(now=0.0)
    made[follower][1].step(now=0.0)
    assert made[leader][0].calls == [("recover", "shared"), ("refresh", "shared", "full")]
    assert made[follower][0].calls == [("recover", "shared")]
    marker = json.loads((tmp_path / "_fleet" / "heal" / "shared.json").read_text())
    assert marker == {"index": "shared", "member": f"member-{leader}", "generation": 1}
    assert made[follower][1].snapshot()["budget_remaining"] == 32
    ring = events if follower == "port" else jax_events
    (obs,) = [e for e in ring.recent() if e["name"] == "controller.actuation"
              and e["fields"]["action"] == "heal.shared" and e["fields"]["outcome"] == "observed"]
    assert obs["fields"]["member"] == f"member-{follower}"


# -- trigger -> action -----------------------------------------------------------


def test_slo_page_engages_shed_and_quota_tighten(shed_server):
    completed, failed, *_ = _serve_counters()
    hs, ctrl = _controller(server=shed_server)
    assert shed_server.get_shed_depth() == 32
    _drive_page(completed, failed, ctrl)
    assert shed_server.get_shed_depth() == 16
    assert shed_server.quotas.throttle() == pytest.approx(0.5)
    snap = ctrl.snapshot()
    assert snap["engaged"] is True and snap["verdicts"]["serve.availability"] == "page"
    assert stats.get("controller.actuations") == 1
    (evt,) = _actuation_events("shed.engage")
    assert (evt["fields"]["trigger"], evt["fields"]["outcome"]) == ("slo.page", "executed")
    assert metrics.REGISTRY.get("controller.engaged").value == 1


def test_recovery_releases_overrides_after_recovery_ticks(shed_server):
    completed, failed, *_ = _serve_counters()
    hs, ctrl = _controller(server=shed_server)
    t = _drive_page(completed, failed, ctrl)
    completed.inc(80_000)
    ctrl.step(now=t + 70.0)
    assert ctrl.snapshot()["engaged"] is True
    ctrl.step(now=t + 71.0)
    assert ctrl.snapshot()["engaged"] is False
    assert shed_server.get_shed_depth() == 32 and shed_server.quotas.throttle() == pytest.approx(1.0)
    (evt,) = _actuation_events("shed.release")
    assert evt["fields"]["trigger"] == "slo.recovered"
    assert metrics.REGISTRY.get("controller.engaged").value == 0


def test_quarantine_triggers_recover_then_gated_rebuild():
    _serve_counters()
    hs, ctrl = _controller()
    with hs.session._state_lock:
        hs.session.index_health["/idx/myidx"] = {"reason": "torn bucket"}
    ctrl.step(now=0.0)
    ctrl.step(now=1.0)
    assert hs.calls == [("recover", "myidx"), ("refresh", "myidx", "full")]
    assert hs.session.index_health == {} and stats.get("controller.heals") == 1
    (evt,) = _actuation_events("heal.myidx")
    assert evt["fields"]["trigger"] == "index.quarantined"
    hs2, ctrl2 = _controller(**{"hyperspace.controller.heal.rebuild": "false"})
    with hs2.session._state_lock:
        hs2.session.index_health["/idx/a"] = {"reason": "x"}
    ctrl2.step(now=0.0)
    assert hs2.calls == [("recover", "a")]


def test_heal_defers_while_burning(shed_server):
    completed, failed, *_ = _serve_counters()
    hs, ctrl = _controller(server=shed_server)
    t = _drive_page(completed, failed, ctrl)
    with hs.session._state_lock:
        hs.session.index_health["/idx/hot"] = {"reason": "x"}
    ctrl.step(now=t + 1.0)
    assert not any(c[0] in ("recover", "refresh") for c in hs.calls)
    backoffs = [e for e in events.recent() if e["name"] == "controller.backoff"]
    assert {e["fields"]["action"] for e in backoffs} == {"heal"}
    completed.inc(80_000)
    for dt in (70.0, 71.0, 72.0):
        ctrl.step(now=t + dt)
    assert ("recover", "hot") in hs.calls


# -- the advisor sweep and the storm response ----------------------------------


def _demote(n, prefix="s"):
    demoted = events.declare("advisor.routing.demoted")
    for i in range(n):
        demoted.emit(signature=f"{prefix}{i}")


def test_demotion_cluster_triggers_advisor_sweep():
    _serve_counters()
    hs, ctrl = _controller()
    _demote(3)
    ctrl.step(now=0.0)
    ctrl.step(now=1.0)
    assert hs.calls == [("sweep",)]
    (evt,) = _actuation_events("advisor.sweep")
    assert (evt["fields"]["trigger"], evt["fields"]["demotions"]) == ("routing.demotion_cluster", 3)
    # The evidence is consumed: no second sweep without fresh demotions.
    ctrl.step(now=100.0)
    assert hs.calls.count(("sweep",)) == 1 and ctrl.snapshot()["pending_demotions"] == 0


def test_demotions_below_cluster_size_or_outside_window_never_sweep():
    _serve_counters()
    hs, ctrl = _controller()
    _demote(2)
    ctrl.step(now=0.0)  # 2 < clusterSize 3
    assert ctrl.snapshot()["pending_demotions"] == 2
    _demote(1, prefix="late")
    ctrl.step(now=1000.0)  # the window is 300 s: the first two aged out
    assert ("sweep",) not in hs.calls and ctrl.snapshot()["pending_demotions"] == 1


def test_sweep_defers_while_burning_then_runs(shed_server):
    completed, failed, *_ = _serve_counters()
    hs, ctrl = _controller(server=shed_server)
    t = _drive_page(completed, failed, ctrl)
    _demote(3)
    ctrl.step(now=t + 1.0)
    assert ("sweep",) not in hs.calls
    backoffs = [e for e in events.recent() if e["name"] == "controller.backoff"]
    assert {e["fields"]["action"] for e in backoffs} == {"advisor.sweep"}
    completed.inc(80_000)
    for dt in (70.0, 71.0, 72.0):
        ctrl.step(now=t + dt)
    assert hs.calls.count(("sweep",)) == 1


def test_recompile_storm_pins_raw_once_per_cooldown():
    _serve_counters()
    hs, ctrl = _controller()
    storm = events.declare("jit.recompile_storm")
    storm.emit(key="sig-hot", recompiles=9)
    ctrl.step(now=0.0)
    assert hs.session.ledger.pins == [("sig-hot", "raw")]
    (act,) = _actuation_events("storm.response.sig-hot")
    assert (act["fields"]["trigger"], act["fields"]["outcome"]) == ("jit.recompile_storm", "executed")
    (resp,) = [e for e in events.recent() if e["name"] == "controller.storm_response"]
    assert (resp["fields"]["key"], resp["fields"]["route"]) == ("sig-hot", "raw")
    storm.emit(key="sig-hot", recompiles=9)  # again, inside the cooldown: one pin
    ctrl.step(now=1.0)
    assert hs.session.ledger.pins == [("sig-hot", "raw")]


def test_storm_response_gate_off_never_pins():
    _serve_counters()
    hs, ctrl = _controller(**{"hyperspace.controller.stormResponse": "false"})
    events.declare("jit.recompile_storm").emit(key="sig-x", recompiles=9)
    ctrl.step(now=0.0)
    assert hs.session.ledger.pins == [] and _actuation_events("storm.response.sig-x") == []


def test_sweep_and_storm_pin_on_a_real_session(tmp_path):
    """Demotions run_query emitted over a real session and store trigger
    one audited sweep, which with the lifecycle gates off mutates nothing;
    a storm's key pinned raw routes that signature to its source."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col
    from hyperspace_tpu_torch.serve.plan_cache import collection_log_versions
    from hyperspace_tpu_torch.signature import plan_signature

    _serve_counters()
    rng = np.random.default_rng(9)
    (tmp_path / "src").mkdir()
    pq.write_table(pa.table({"k": rng.integers(0, 50, 2000), "v": rng.standard_normal(2000)}),
                   tmp_path / "src" / "p0.parquet")
    session = HyperspaceSession(system_path=str(tmp_path / "idx"), num_buckets=4, device="cpu")
    hs = Hyperspace(session)
    df = session.parquet(tmp_path / "src")
    hs.create_index(df, IndexConfig("kidx", ["k"], ["v"]))
    session.enable_hyperspace()
    session.conf.set("hyperspace.advisor.routing.enabled", True)
    slow, other = df.filter(col("k") == 7).select("k", "v"), df.filter(col("k") == 8).select("k", "v")
    led = session.routing_ledger()
    led.record(plan_signature(slow), "raw", 1e-4)
    led.record(plan_signature(slow), "indexed", 10.0)
    for _ in range(3):
        session.run(slow)
        assert session.last_query_stats["advisor_routing"] == {"decision": "raw", "demoted": True}
    before = collection_log_versions(session)
    session.conf.set("hyperspace.controller.enabled", True)
    ctrl = hs.controller(clock=lambda: 0.0)
    ctrl.step(now=0.0)
    (evt,) = _actuation_events("advisor.sweep")
    assert (evt["fields"]["trigger"], evt["fields"]["demotions"], evt["fields"]["outcome"]) == \
        ("routing.demotion_cluster", 3, "executed")
    assert collection_log_versions(session) == before
    assert [e.name for e in session.manager.get_indexes()] == ["kidx"]
    events.declare("jit.recompile_storm").emit(key=plan_signature(other), recompiles=9)
    ctrl.step(now=1.0)
    assert plan_signature(other) in led.demoted_signatures()
    session.run(other)
    assert session.last_query_stats["advisor_routing"] == {"decision": "raw", "demoted": True}


def test_single_verdict_flicker_never_actuates(shed_server):
    completed, failed, *_ = _serve_counters()
    hs, ctrl = _controller(server=shed_server)
    completed.inc(10_000)
    ctrl.step(now=0.0)
    ctrl.step(now=4000.0)
    failed.inc(3_000)
    ctrl.step(now=4030.0)
    assert ctrl.snapshot()["engaged"] is False
    completed.inc(80_000)
    ctrl.step(now=4100.0)
    assert ctrl.snapshot()["page_ticks"] == 0 and _actuation_events() == []


def test_heal_failure_cools_down_before_retry():
    _serve_counters()
    hs, ctrl = _controller()
    with hs.session._state_lock:
        hs.session.index_health["/idx/bad"] = {"reason": "x"}
    hs.fail_next = RuntimeError
    ctrl.step(now=0.0)
    assert stats.get("controller.actuation_failures") == 1
    failed_events = [e for e in events.recent() if e["name"] == "controller.actuation_failed"]
    assert failed_events[0]["fields"]["action"] == "heal.bad"
    ctrl.step(now=5.0)
    assert hs.calls == [] and stats.get("controller.deferred") >= 1
    ctrl.step(now=31.0)
    assert ("recover", "bad") in hs.calls


def test_budget_exhaustion_degrades_to_observe_only(shed_server):
    completed, failed, *_ = _serve_counters()
    hs, ctrl = _controller(server=shed_server, **{"hyperspace.controller.actuationBudget": 1})
    t = _drive_page(completed, failed, ctrl)
    assert ctrl.snapshot()["budget_remaining"] == 0
    completed.inc(80_000)
    ctrl.step(now=t + 70.0)
    ctrl.step(now=t + 71.0)
    assert shed_server.get_shed_depth() == 32  # the release stays free
    with hs.session._state_lock:
        hs.session.index_health["/idx/q"] = {"reason": "x"}
    ctrl.step(now=t + 72.0)
    assert not any(c[0] == "recover" for c in hs.calls)
    assert ctrl.snapshot()["mode"] == "observe_only"
    observe = [e for e in events.recent() if e["name"] == "controller.observe_only"]
    assert len(observe) == 1 and observe[0]["severity"] == "error"
    assert _actuation_events("heal.q")[0]["fields"]["outcome"] == "observe_only"
    ctrl.step(now=t + 103.0)
    assert len([e for e in events.recent() if e["name"] == "controller.observe_only"]) == 1


def test_kill_switch_disarms_mid_loop_and_releases(shed_server):
    completed, failed, *_ = _serve_counters()
    hs, ctrl = _controller(server=shed_server)
    _drive_page(completed, failed, ctrl)
    assert shed_server.get_shed_depth() == 16
    ticks = stats.get("controller.ticks")
    hs.session.conf.set("hyperspace.controller.enabled", "false")
    with hs.session._state_lock:
        hs.session.index_health["/idx/x"] = {"reason": "x"}
    snap = ctrl.step(now=5000.0)
    assert shed_server.get_shed_depth() == 32 and shed_server.quotas.throttle() == pytest.approx(1.0)
    assert snap["mode"] == "disabled" and snap["engaged"] is False
    assert stats.get("controller.ticks") == ticks and not any(c[0] == "recover" for c in hs.calls)
    (evt,) = _actuation_events("shed.release")
    assert evt["fields"]["trigger"] == "kill_switch"


def test_disabled_by_default_controller_never_acts():
    session = FakeSession()
    session.conf.set("hyperspace.controller.enabled", "false")
    assert HyperspaceConf().controller_enabled is False
    hs = FakeHyperspace(session)
    ctrl = OpsController(hs, clock=lambda: 0.0)
    with session._state_lock:
        session.index_health["/idx/x"] = {"reason": "x"}
    assert ctrl.step(now=0.0)["mode"] == "disabled"
    assert hs.calls == [] and stats.get("controller.ticks") == 0


def test_crashpoint_at_actuate_unwinds_with_zero_partial_state(shed_server):
    completed, failed, *_ = _serve_counters()
    hs, ctrl = _controller(server=shed_server)
    completed.inc(10_000)
    ctrl.step(now=0.0)
    ctrl.step(now=4000.0)
    failed.inc(3_000)
    ctrl.step(now=4030.0)
    with faults.injected("controller.actuate", crash=True):
        with pytest.raises(CrashPoint):
            ctrl.step(now=4031.0)
    assert shed_server.get_shed_depth() == 32 and shed_server.quotas.throttle() == pytest.approx(1.0)
    assert ctrl.snapshot()["engaged"] is False and stats.get("controller.actuations") == 0
    ctrl.step(now=4032.0)
    assert shed_server.get_shed_depth() == 16


def test_transient_fault_at_actuate_surfaces_typed():
    _serve_counters()
    hs, ctrl = _controller()
    with hs.session._state_lock:
        hs.session.index_health["/idx/t"] = {"reason": "x"}
    with faults.injected("controller.actuate", times=1):
        with pytest.raises(OSError):
            ctrl.step(now=0.0)
    assert hs.calls == []
    ctrl.step(now=1.0)
    assert ("recover", "t") in hs.calls


def test_what_the_controller_does_not_port_raises(tmp_path):
    """The ingest pause is not ported: an `ingest=` and the ingest keys
    raise. The storm response's and the advisor sweep's keys are ported
    and read the JAX package's defaults."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession

    session = HyperspaceSession(system_path=str(tmp_path), device="cpu")
    ctrl = Hyperspace(session).controller()
    assert isinstance(ctrl, OpsController) and ctrl.snapshot()["mode"] == "disabled"
    with pytest.raises(HyperspaceError, match="not ported"):
        Hyperspace(session).controller(ingest=object())
    for key in ("hyperspace.ingest.enabled", "hyperspace.ingest.autoCompact"):
        with pytest.raises(HyperspaceError, match="not ported"):
            session.conf.get(key)
    ref = JaxConf()
    for key in ("hyperspace.controller.stormResponse", "hyperspace.controller.demotionClusterSize",
                "hyperspace.controller.demotionWindowSeconds"):
        assert session.conf.get(key) == ref.get(key)


# -- the loop and its health surface ------------------------------------------


def test_start_stop_loop_ticks_survives_a_failing_step_and_registers():
    _serve_counters()
    hs, ctrl = _controller(**{"hyperspace.controller.intervalSeconds": 0.01})
    ctrl._clock = time.monotonic
    boom = {"n": 0}
    real_step = ctrl.step

    def flaky_step(now=None):
        boom["n"] += 1
        if boom["n"] == 1:
            raise RuntimeError("transient controller bug")
        return real_step(now)

    ctrl.step = flaky_step
    endpoint = obs_http.acquire()
    try:
        with ctrl.start():
            deadline = time.monotonic() + 5.0
            while stats.get("controller.ticks") < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
            with urllib.request.urlopen(endpoint.url("/healthz"), timeout=10) as r:
                (view,) = json.loads(r.read().decode())["controller"]
            assert view["enabled"] is True and view["mode"] == "actuate" and view["budget_remaining"] == 32
    finally:
        obs_http.release()
    assert stats.get("controller.ticks") >= 3
    ticks = stats.get("controller.ticks")
    time.sleep(0.05)
    assert stats.get("controller.ticks") == ticks
    assert any(e["fields"]["action"] == "step" for e in events.recent() if e["name"] == "controller.actuation_failed")


# -- the fleet heal ---------------------------------------------------------------


def _fleet_controller(tmp_path, member_id, **conf_overrides):
    session = FakeSession(**conf_overrides)
    session.conf.set("hyperspace.system.path", str(tmp_path))
    hs = FakeHyperspace(session)
    return hs, OpsController(hs, clock=lambda: 0.0, member_id=member_id)


def _heal_lease_path(tmp_path, name="shared"):
    return tmp_path / "_fleet" / "heal" / f"{key_name(f'heal.{name}')}.lease"


def _quarantine(hs, name="shared"):
    with hs.session._state_lock:
        hs.session.index_health[f"/idx/{name}"] = {"reason": "torn"}


def test_two_controllers_one_store_exactly_one_heal(tmp_path):
    _serve_counters()
    hs_a, ctrl_a = _fleet_controller(tmp_path, "member-a")
    hs_b, ctrl_b = _fleet_controller(tmp_path, "member-b")
    _quarantine(hs_a)
    _quarantine(hs_b)
    ctrl_a.step(now=0.0)
    ctrl_b.step(now=0.0)
    assert hs_a.calls == [("recover", "shared"), ("refresh", "shared", "full")]
    assert hs_b.calls == [("recover", "shared")]
    assert stats.get("controller.heals") == 1
    (led,) = [e for e in _actuation_events("heal.shared") if e["fields"]["outcome"] == "executed"]
    (obs,) = [e for e in _actuation_events("heal.shared") if e["fields"]["outcome"] == "observed"]
    assert (led["fields"]["member"], obs["fields"]["member"]) == ("member-a", "member-b")
    assert ctrl_b.snapshot()["budget_remaining"] == 32 and ctrl_a.snapshot()["budget_remaining"] == 31
    marker = json.loads((tmp_path / "_fleet" / "heal" / "shared.json").read_text())
    assert marker == {"index": "shared", "member": "member-a", "generation": 1}


def test_sigkilled_healer_lease_is_reaped_and_taken_over(tmp_path):
    _serve_counters()
    hs, ctrl = _fleet_controller(tmp_path, "survivor", **{"hyperspace.fleet.lease.seconds": 5.0})
    _quarantine(hs)
    lease = _heal_lease_path(tmp_path)
    lease.parent.mkdir(parents=True, exist_ok=True)
    lease.write_text(f"{time.time() - 120.0:.6f}:999999:dead")
    ctrl.step(now=0.0)
    assert ("recover", "shared") in hs.calls
    assert stats.get("fleet.singleflight.takeovers") == 1 and stats.get("controller.heals") == 1
    assert not lease.exists()
    takeover = [e for e in events.recent() if e["name"] == "fleet.singleflight.takeover"]
    assert takeover[0]["fields"]["key"] == "heal.shared"


def test_write_marker_publishes_atomically_or_not_at_all(tmp_path, monkeypatch):
    heal_dir = tmp_path / "heal"
    heal_dir.mkdir()
    marker = heal_dir / "shared.json"

    def boom(fd):
        raise OSError("disk on fire")

    with monkeypatch.context() as mp:
        mp.setattr(os, "fsync", boom)
        with pytest.raises(OSError):
            OpsController._write_marker(marker, {"index": "shared", "generation": 1})
    assert not marker.exists() and list(heal_dir.iterdir()) == []
    OpsController._write_marker(marker, {"index": "shared", "generation": 1})
    assert json.loads(marker.read_text())["generation"] == 1


def test_kill_between_heal_and_marker_converges(tmp_path):
    """`controller.heal.marker` fires after the leader healed the shared
    bytes and before the marker publishes: a crash there leaves no marker,
    and the next quarantined member leads an idempotent re-heal."""
    _serve_counters()
    hs_a, ctrl_a = _fleet_controller(tmp_path, "member-a")
    _quarantine(hs_a)
    with faults.injected("controller.heal.marker", crash=True, at_call=1):
        with pytest.raises(CrashPoint):
            ctrl_a.step(now=0.0)
    assert hs_a.calls == [("recover", "shared"), ("refresh", "shared", "full")]
    marker = tmp_path / "_fleet" / "heal" / "shared.json"
    assert not marker.exists()
    hs_b, ctrl_b = _fleet_controller(tmp_path, "member-b")
    _quarantine(hs_b)
    ctrl_b.step(now=0.0)
    assert hs_b.calls == [("recover", "shared"), ("refresh", "shared", "full")]
    assert json.loads(marker.read_text()) == {"index": "shared", "member": "member-b", "generation": 1}


def test_restarted_member_observes_stale_marker_once_then_heals(tmp_path):
    _serve_counters()
    hs, ctrl = _fleet_controller(tmp_path, "restarted")
    marker = tmp_path / "_fleet" / "heal" / "shared.json"
    marker.parent.mkdir(parents=True, exist_ok=True)
    marker.write_text(json.dumps({"index": "shared", "member": "old-member", "generation": 3}))
    _quarantine(hs)
    ctrl.step(now=0.0)
    assert hs.calls == [("recover", "shared")]
    _quarantine(hs)
    ctrl.step(now=10.0)
    assert hs.calls == [("recover", "shared")]
    ctrl.step(now=31.0)
    assert hs.calls == [("recover", "shared"), ("recover", "shared"), ("refresh", "shared", "full")]
    assert json.loads(marker.read_text()) == {"index": "shared", "member": "restarted", "generation": 4}


def test_stop_mid_heal_releases_the_held_lease(tmp_path):
    """stop() while a heal holds the single-flight lease releases it
    before anything else: the lease is gone while the heal still runs."""
    _serve_counters()
    hs, ctrl = _fleet_controller(tmp_path, "stopping")
    entered, unblock = threading.Event(), threading.Event()

    def slow_refresh(name, mode="full"):
        hs.calls.append(("refresh", name, mode))
        entered.set()
        assert unblock.wait(timeout=30.0)

    hs.refresh_index = slow_refresh
    _quarantine(hs)
    t = threading.Thread(target=lambda: ctrl.step(now=0.0))
    t.start()
    stopper = threading.Thread(target=lambda: ctrl.stop(timeout=0.5))
    try:
        assert entered.wait(timeout=30.0)
        assert _heal_lease_path(tmp_path).exists()
        stopper.start()
        deadline = time.monotonic() + 10.0
        while _heal_lease_path(tmp_path).exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not _heal_lease_path(tmp_path).exists()
        assert t.is_alive()  # released while the heal is still in flight
    finally:
        unblock.set()
        t.join(timeout=30.0)
        if stopper.is_alive() or stopper.ident is not None:
            stopper.join(timeout=30.0)
    assert not t.is_alive() and not stopper.is_alive()


def test_heal_coordination_gate_off_keeps_heals_local(tmp_path):
    _serve_counters()
    hs, ctrl = _fleet_controller(tmp_path, "solo", **{"hyperspace.controller.heal.coordinate": "false"})
    _quarantine(hs)
    ctrl.step(now=0.0)
    assert hs.calls == [("recover", "shared"), ("refresh", "shared", "full")]
    assert not (tmp_path / "_fleet" / "heal").exists()


# -- fleet scaling ------------------------------------------------------------------


def _scale_controller(sup, **conf_overrides):
    hs = FakeHyperspace(FakeSession(**conf_overrides))
    return hs, OpsController(hs, clock=lambda: 0.0, member_id="scaler", supervisor=sup)


def test_sustained_saturation_scales_up_and_recovery_scales_back():
    _serve_counters()
    sup = FakeSupervisor(n=2)
    hs, ctrl = _scale_controller(sup)
    sup.saturation["queue_depth"] = 60
    ctrl.step(now=0.0)
    assert sup.calls == []
    ctrl.step(now=1.0)
    assert sup.calls == [("scale", 3, 1)] and stats.get("controller.scale") == 1
    (up,) = _actuation_events("fleet.scale.up")
    assert (up["fields"]["trigger"], up["fields"]["workers"]) == ("fleet.saturation", 3)
    budget = ctrl.snapshot()["budget_remaining"]
    sup.saturation["queue_depth"] = 0
    ctrl.step(now=2.0)
    assert sup.n == 3
    ctrl.step(now=3.0)
    assert sup.calls[-1] == ("scale", 2, 1) and sup.n == 2
    (down,) = _actuation_events("fleet.scale.down")
    assert down["fields"]["trigger"] == "fleet.recovered"
    assert ctrl.snapshot()["budget_remaining"] == budget and ctrl.snapshot()["scale_baseline"] is None


def test_scale_up_respects_max_workers_cap():
    _serve_counters()
    sup = FakeSupervisor(n=2)
    hs, ctrl = _scale_controller(sup, **{"hyperspace.controller.scale.maxWorkers": 3,
                                         "hyperspace.controller.cooldownSeconds": 1.0})
    sup.saturation["queue_depth"] = 64
    for i in range(8):
        ctrl.step(now=float(i * 5))
    assert sup.n == 3 and len(_actuation_events("fleet.scale.up")) == 1


def test_local_server_saturation_alone_drives_scale_up():
    _serve_counters()
    sup = FakeSupervisor(n=1)
    session = FakeSession()
    hs = FakeHyperspace(session)
    gate = threading.Event()
    server = QueryServer(session, workers=1, max_queue_depth=32, run_fn=lambda p: gate.wait(timeout=30.0))
    try:
        ctrl = OpsController(hs, server=server, clock=lambda: 0.0, supervisor=sup)
        for _ in range(30):
            server.submit(object())
        ctrl.step(now=0.0)
        ctrl.step(now=1.0)
        assert sup.calls and sup.calls[0][1] == 2
    finally:
        gate.set()
        server.shutdown()


# -- the incident flight recorder ---------------------------------------------------


def _incident_controller(tmp_path, server=None, **conf_overrides):
    conf_overrides.setdefault("hyperspace.controller.incident.dir", str(tmp_path / "incidents"))
    return _controller(server=server, **conf_overrides)


def test_page_episode_yields_one_bundle_with_two_members_segments(tmp_path, shed_server):
    journal.configure(enabled=True, root=str(tmp_path / "_obs"))
    other = tmp_path / "_obs" / "424242"  # a second member's sealed journal
    other.mkdir(parents=True)
    (other / "segment-00000000.jsonl").write_text(json.dumps({"ts": 1.0, "pid": 424242, "kind": "event"}) + "\n")
    completed, failed, *_ = _serve_counters()
    hs, ctrl = _incident_controller(tmp_path, server=shed_server)
    t = _drive_page(completed, failed, ctrl)
    (inc,) = ctrl.list_incidents()
    assert inc["open"] is True and inc["trigger"] == "slo.page"
    assert ctrl.snapshot()["open_incident"] == inc["name"]
    completed.inc(80_000)
    ctrl.step(now=t + 70.0)
    ctrl.step(now=t + 71.0)
    (inc,) = ctrl.list_incidents()
    assert inc["open"] is False and inc["resolution"] == "slo.recovered"
    doc = ctrl.read_incident(inc["name"])
    for f in ("open.json", "events.json", "config.json", "proc.json", "manifest.json"):
        assert f in doc["files"]
    assert "jit.json" not in doc["files"]
    members = {f.split("/")[1] for f in doc["files"] if f.startswith("journal/")}
    assert members == {str(os.getpid()), "424242"}
    assert doc["open"]["verdicts"]["serve.availability"] == "page"
    actions = [a["action"] for a in doc["manifest"]["actions"]]
    assert "shed.engage" in actions and "shed.release" in actions
    assert stats.get("controller.incidents") == 1 and ctrl.snapshot()["open_incident"] is None
    config = json.loads((tmp_path / "incidents" / inc["name"] / "config.json").read_text())
    assert config["hyperspace.controller.enabled"] == "true"


def test_fresh_quarantine_opens_bundle_closed_as_healed(tmp_path):
    _serve_counters()
    hs, ctrl = _incident_controller(tmp_path)
    with hs.session._state_lock:
        hs.session.index_health["/idx/a"] = {"reason": "torn"}
    ctrl.step(now=0.0)
    (inc,) = ctrl.list_incidents()
    assert (inc["trigger"], inc["open"], inc["resolution"]) == ("quarantine.a", False, "healed")
    assert "heal.a" in [a["action"] for a in ctrl.read_incident(inc["name"])["manifest"]["actions"]]


def test_budget_exhaustion_snapshots_an_observe_only_bundle(tmp_path):
    """Degrading to observe-only is an incident of its own, opened and
    closed at once; inside an open episode it annotates that bundle."""
    _serve_counters()
    sup = FakeSupervisor(n=2)
    sup.saturation["queue_depth"] = 64
    session = FakeSession(**{"hyperspace.controller.actuationBudget": "0",
                             "hyperspace.controller.incident.dir": str(tmp_path / "incidents")})
    ctrl = OpsController(FakeHyperspace(session), clock=lambda: 0.0, supervisor=sup)
    ctrl.step(now=0.0)
    ctrl.step(now=1.0)  # the scale-up decision meets the empty budget
    (inc,) = ctrl.list_incidents()
    assert (inc["trigger"], inc["open"], inc["resolution"]) == ("observe_only", False, "observe_only")
    assert sup.calls == [] and _actuation_events("fleet.scale.up")[0]["fields"]["outcome"] == "observe_only"
    hs2, ctrl2 = _incident_controller(tmp_path / "two", **{"hyperspace.controller.actuationBudget": "0"})
    with hs2.session._state_lock:
        hs2.session.index_health["/idx/a"] = {"reason": "torn"}
    ctrl2.step(now=0.0)
    (inc2,) = ctrl2.list_incidents()
    assert (inc2["trigger"], inc2["open"]) == ("quarantine.a", True)
    assert [n["trigger"] for n in ctrl2._incident_notes] == ["observe_only"]
    assert hs2.calls == []


def test_incident_cooldown_and_retention(tmp_path):
    _serve_counters()
    hs, ctrl = _incident_controller(tmp_path, **{"hyperspace.controller.cooldownSeconds": "10"})
    for i, (t_open, t_close) in enumerate([(0.0, 1.0), (20.0, 21.0), (40.0, 41.0)]):
        with hs.session._state_lock:
            hs.session.index_health[f"/idx/i{i}"] = {"reason": "torn"}
        ctrl.step(now=t_open)
        ctrl.step(now=t_close)
    assert len(ctrl.list_incidents()) == 3 and stats.get("controller.incidents") == 3
    with hs.session._state_lock:
        hs.session.index_health["/idx/i2"] = {"reason": "torn again"}
    ctrl.step(now=41.5)
    assert len(ctrl.list_incidents()) == 3
    hs2, ctrl2 = _incident_controller(tmp_path / "two", **{"hyperspace.controller.incident.maxBundles": "2",
                                                           "hyperspace.controller.cooldownSeconds": "1"})
    for i in range(3):
        with hs2.session._state_lock:
            hs2.session.index_health[f"/idx/i{i}"] = {"reason": "torn"}
        ctrl2.step(now=i * 10.0)
        ctrl2.step(now=i * 10.0 + 1.0)
    assert {i["trigger"] for i in ctrl2.list_incidents()} == {"quarantine.i1", "quarantine.i2"}


def test_incident_recorder_disabled_writes_nothing(tmp_path):
    _serve_counters()
    hs, ctrl = _incident_controller(tmp_path, **{"hyperspace.controller.incident.enabled": "false"})
    with hs.session._state_lock:
        hs.session.index_health["/idx/a"] = {"reason": "torn"}
    ctrl.step(now=0.0)
    ctrl.step(now=1.0)
    assert ctrl.list_incidents() == [] and not (tmp_path / "incidents").exists()


def test_debug_incidents_endpoint_serves_bundles(tmp_path):
    _serve_counters()
    hs, ctrl = _incident_controller(tmp_path)
    with hs.session._state_lock:
        hs.session.index_health["/idx/a"] = {"reason": "torn"}
    ctrl.step(now=0.0)
    ctrl.step(now=1.0)
    endpoint = obs_http.HealthServer().start()
    try:
        endpoint.attach_controller(ctrl)
        with urllib.request.urlopen(endpoint.url("/debug/incidents"), timeout=10) as r:
            (inc,) = json.loads(r.read())["incidents"]
        assert inc["resolution"] == "healed"
        with urllib.request.urlopen(endpoint.url(f"/debug/incidents?name={inc['name']}"), timeout=10) as r:
            detail = json.loads(r.read())
        assert detail["manifest"]["trigger"] == "quarantine.a" and "open.json" in detail["files"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(endpoint.url("/debug/incidents?name=nope"), timeout=10)
        assert ei.value.code == 404
    finally:
        endpoint.stop()
