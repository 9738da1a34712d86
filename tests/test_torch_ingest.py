"""The port's continuous ingestion (hyperspace_tpu_torch/ingest/) against
the JAX package's.

tests/test_ingest.py's cases, each run through both packages (`P` is
"jax" or "torch") at their own small sizes with the same assertions:
snapshot isolation (a pinned reader repeats across a live commit, a
released handle fails loudly, the stamp versions the plan-cache key,
unindexed sources pin on first touch), the tailer (arrivals seen once,
complete lines only, the batch fsynced before its rename, a crash between
batch and cursor idempotent), the crash sweeps (every fault point a
committing tick passes, inside a compaction, the deferral while SLOs
burn), the torn-window sweep driven by the names in the port's own
`analysis.duradomain.TORN_WINDOWS` (each package reading its own
registry's fault point), the daemon's lifecycle, a real SIGKILL of the
process worker, the controller's backoff and the registries, the
`ERROR_CONTRACTS` coverage of the five ingest entry points included.

Then the parity cases:

- the same batches and changelog ingested by each package give
  byte-identical CDC batch files and delta bucket files, equal manifests
  and equal log entries (up to timestamps and root);
- both packages take equal snapshot stamps and plan keys over one store;
- an index one package ingests into is queried by the other; a cursor
  and a batch file one package writes are continued by the other; a crash
  one package leaves inside a commit or a compaction is recovered by the
  other;
- the pinned reader keys the routing ledger on its snapshot's stamp
  (tests/test_advisor.py::test_pinned_reader_keys_ledger_on_snapshot_stamp),
  and both packages' `snapshot_stamp` agree.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu import faults as jfaults
from hyperspace_tpu import stats as jstats
from hyperspace_tpu.advisor import routing as jrouting
from hyperspace_tpu.analysis.duradomain import TORN_WINDOWS as JTORN_WINDOWS
from hyperspace_tpu.config import HyperspaceConf as JConf
from hyperspace_tpu.exceptions import HyperspaceError as JHyperspaceError
from hyperspace_tpu.faults import CrashPoint as JCrashPoint
from hyperspace_tpu.ingest import writer as jwriter
from hyperspace_tpu.ingest.daemon import IngestDaemon as JIngestDaemon
from hyperspace_tpu.ingest.tailer import CdcTailer as JCdcTailer
from hyperspace_tpu.ingest.tailer import Cursor as JCursor
from hyperspace_tpu.ingest.tailer import FileArrivalWatcher as JFileArrivalWatcher
from hyperspace_tpu.obs import events as jevents
from hyperspace_tpu.obs import metrics as jmetrics
from hyperspace_tpu.serve.controller import OpsController as JOpsController
from hyperspace_tpu.serve.plan_cache import versioned_plan_key as jversioned_plan_key
from hyperspace_tpu.signature import plan_signature as jplan_signature
from hyperspace_tpu.utils import retry as jretry
from hyperspace_tpu_torch import faults as tfaults
from hyperspace_tpu_torch import stats as tstats
from hyperspace_tpu_torch.advisor import routing as trouting
from hyperspace_tpu_torch.analysis.duradomain import TORN_WINDOWS
from hyperspace_tpu_torch.config import HyperspaceConf as TConf
from hyperspace_tpu_torch.exceptions import HyperspaceError as THyperspaceError
from hyperspace_tpu_torch.execution import device_cache as tdc
from hyperspace_tpu_torch.faults import CrashPoint as TCrashPoint
from hyperspace_tpu_torch.ingest import writer as twriter
from hyperspace_tpu_torch.ingest.daemon import IngestDaemon as TIngestDaemon
from hyperspace_tpu_torch.ingest.tailer import CdcTailer as TCdcTailer
from hyperspace_tpu_torch.ingest.tailer import Cursor as TCursor
from hyperspace_tpu_torch.ingest.tailer import FileArrivalWatcher as TFileArrivalWatcher
from hyperspace_tpu_torch.obs import events as tevents
from hyperspace_tpu_torch.obs import http as thttp
from hyperspace_tpu_torch.obs import journal as tjournal
from hyperspace_tpu_torch.obs import metrics as tmetrics
from hyperspace_tpu_torch.obs import slo as tslo
from hyperspace_tpu_torch.obs import trace as ttrace
from hyperspace_tpu_torch.serve.controller import OpsController as TOpsController
from hyperspace_tpu_torch.serve.plan_cache import versioned_plan_key as tversioned_plan_key
from hyperspace_tpu_torch.signature import plan_signature as tplan_signature
from hyperspace_tpu_torch.utils import retry as tretry


class _Pkg:
    """One package's ingestion surface under the names the cases use."""

    def __init__(self, name):
        jax = name == "jax"
        self.name = name
        self.pkg = hjax if jax else htorch
        self.faults = jfaults if jax else tfaults
        self.stats = jstats if jax else tstats
        self.retry = jretry if jax else tretry
        self.Conf = JConf if jax else TConf
        self.HyperspaceError = JHyperspaceError if jax else THyperspaceError
        self.CrashPoint = JCrashPoint if jax else TCrashPoint
        self.writer = jwriter if jax else twriter
        self.IngestDaemon = JIngestDaemon if jax else TIngestDaemon
        self.CdcTailer = JCdcTailer if jax else TCdcTailer
        self.Cursor = JCursor if jax else TCursor
        self.FileArrivalWatcher = JFileArrivalWatcher if jax else TFileArrivalWatcher
        self.events = jevents if jax else tevents
        self.metrics = jmetrics if jax else tmetrics
        self.OpsController = JOpsController if jax else TOpsController
        self.versioned_plan_key = jversioned_plan_key if jax else tversioned_plan_key
        self.routing = jrouting if jax else trouting
        self.plan_signature = jplan_signature if jax else tplan_signature
        self.kw = {} if jax else {"device": "cpu"}
        self.torn_windows = JTORN_WINDOWS if jax else TORN_WINDOWS

    def session(self, system_path, **kw):
        return self.pkg.HyperspaceSession(system_path=str(system_path), **kw, **self.kw)


PKGS = {n: _Pkg(n) for n in ("jax", "torch")}
JAX, TORCH = PKGS["jax"], PKGS["torch"]


@pytest.fixture(params=tuple(PKGS))
def P(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _clean():
    """Both harnesses disarmed, a no-sleep retry schedule, and the port's
    process-global observability zeroed (tests/conftest.py resets the JAX
    package's)."""
    tstats.reset()
    tmetrics.REGISTRY.reset()
    ttrace.reset()
    ttrace.set_enabled(True)
    tevents.reset()
    tslo.reset()
    tjournal.reset()
    tdc.clear_all()
    for p in PKGS.values():
        p.faults.reset()
        p.retry.configure(max_attempts=3, backoff_base=0.0, sleeper=lambda s: None)
    yield
    for p in PKGS.values():
        p.faults.reset()
        p.retry.configure(max_attempts=3, backoff_base=0.005, sleeper=time.sleep)
    tevents.reset()
    tslo.reset()
    while thttp.shared() is not None:
        thttp.release()


def _write_source(root: Path, n: int = 40) -> str:
    rng = np.random.default_rng(11)
    table = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "key": pa.array(np.arange(n, dtype=np.int64) % 4),
        "value": pa.array(rng.standard_normal(n)),
    })
    root.mkdir(parents=True, exist_ok=True)
    pq.write_table(table, root / "part-0.parquet")
    return str(root)


def _append_changelog(path: Path, start: int, n: int) -> None:
    with open(path, "a", encoding="utf-8") as f:
        for i in range(start, start + n):
            f.write(json.dumps({"id": i, "key": i % 4, "value": float(i)}) + "\n")


def _setup(P, tmp_path, n: int = 40, cdc: int = 24, **conf):
    """Source, active index, changelog and a watching daemon, the harness
    disarmed during the build."""
    source = _write_source(tmp_path / "src", n=n)
    session = P.session(tmp_path / "sys", num_buckets=2)
    session.conf.set("hyperspace.ingest.enabled", "true")
    for k, v in conf.items():
        session.conf.set(k, v)
    hs = P.pkg.Hyperspace(session)
    hs.create_index(session.parquet(source), P.pkg.IndexConfig("idx1", ["key"], ["id", "value"]))
    session.enable_hyperspace()
    changelog = tmp_path / "changes.jsonl"
    _append_changelog(changelog, n, cdc)
    daemon = hs.ingest().watch("idx1", changelog=changelog)
    return source, session, hs, daemon, changelog


def _plan(P, session, source):
    return session.parquet(source).filter(P.pkg.col("key") == 1).select("id", "value")


def _ids(P, session, source, snapshot=None):
    out = session.run(_plan(P, session, source), snapshot=snapshot).decode()
    return sorted(int(i) for i in out["id"])


def _query_matches(P, session, source: str) -> None:
    """The indexed filter answers row-identically to pandas over the raw
    source (whatever files exist right now)."""
    import pyarrow.dataset as pads

    got = session.to_pandas(_plan(P, session, source))
    raw = pads.dataset(source, format="parquet").to_table().to_pandas()
    exp = raw[raw["key"] == 1][["id", "value"]]
    cols = ["id", "value"]
    pd.testing.assert_frame_equal(
        got[cols].sort_values(cols).reset_index(drop=True),
        exp[cols].sort_values(cols).reset_index(drop=True),
        check_dtype=False,
    )


# -- snapshot isolation --------------------------------------------------------


class TestSnapshotIsolation:
    def test_pinned_reader_repeatable_across_live_commit(self, P, tmp_path):
        source, session, hs, daemon, _ = _setup(P, tmp_path)
        snap = session.pin_snapshot()
        before = _ids(P, session, source, snapshot=snap)
        assert before
        out = daemon.tick()
        assert out["commits"] == 1
        live = _ids(P, session, source)
        assert set(live) > set(before)
        assert _ids(P, session, source, snapshot=snap) == before
        assert _ids(P, session, source, snapshot=snap) == before
        assert P.stats.get("ingest.pinned_reads") >= 3
        snap.release()
        assert _ids(P, session, source) == live

    def test_released_snapshot_fails_loudly(self, P, tmp_path):
        source, session, hs, daemon, _ = _setup(P, tmp_path)
        with session.pin_snapshot() as snap:
            _ids(P, session, source, snapshot=snap)
        with pytest.raises(P.HyperspaceError, match="snapshot released"):
            session.run(_plan(P, session, source), snapshot=snap)

    def test_stamp_versions_the_plan_cache_key(self, P, tmp_path):
        source, session, hs, daemon, _ = _setup(P, tmp_path)
        snap = session.pin_snapshot()
        plan = _plan(P, session, source)
        k_pinned = P.versioned_plan_key(session, snap.pin_plan(plan), snapshot=snap)
        assert k_pinned == P.versioned_plan_key(session, snap.pin_plan(plan), snapshot=snap)
        daemon.tick()
        assert P.versioned_plan_key(session, plan) != k_pinned
        assert P.versioned_plan_key(session, snap.pin_plan(plan), snapshot=snap) == k_pinned
        snap.release()

    def test_snapshot_pins_unindexed_sources_on_first_touch(self, P, tmp_path):
        extra = tmp_path / "plain"
        _write_source(extra, n=20)
        source, session, hs, daemon, _ = _setup(P, tmp_path)
        snap = session.pin_snapshot()
        q = session.parquet(str(extra)).select("id")
        n0 = len(session.run(q, snapshot=snap).decode()["id"])
        pq.write_table(pa.table({"id": [900], "key": [0], "value": [0.0]}), extra / "late.parquet")
        assert len(session.run(q, snapshot=snap).decode()["id"]) == n0
        assert len(session.run(q).decode()["id"]) == n0 + 1
        snap.release()


# -- the tailer and the arrival watcher ----------------------------------------


class TestTailer:
    def test_arrival_watcher_sees_each_file_once(self, P, tmp_path):
        root = _write_source(tmp_path / "src", n=10)
        w = P.FileArrivalWatcher(root, "parquet", P.Cursor(tmp_path / "cur.json"))
        assert w.poll() == 1
        assert w.poll() == 0
        pq.write_table(pa.table({"id": [99], "key": [0], "value": [0.0]}), Path(root) / "part-9.parquet")
        assert w.poll() == 1
        assert w.poll() == 0

    def test_tailer_waits_for_complete_lines(self, P, tmp_path):
        dest = tmp_path / "dest"
        dest.mkdir()
        log = tmp_path / "c.jsonl"
        log.write_text(json.dumps({"id": 1, "v": 1}) + "\n" + '{"id": 2, "v"')
        t = P.CdcTailer(log, dest, P.Cursor(tmp_path / "cur.json"))
        assert t.poll(100) == 1
        with open(log, "a", encoding="utf-8") as f:
            f.write(": 2}\n")
        assert t.poll(100) == 1
        assert t.poll(100) == 0

    def test_batch_publish_fsyncs_data_before_the_rename(self, P, tmp_path, monkeypatch):
        calls = []
        real_fsync, real_replace = os.fsync, os.replace

        def spy_fsync(fd):
            calls.append("fsync")
            return real_fsync(fd)

        def spy_replace(src, dst):
            calls.append(("replace", os.path.basename(str(dst))))
            return real_replace(src, dst)

        monkeypatch.setattr(os, "fsync", spy_fsync)
        monkeypatch.setattr(os, "replace", spy_replace)
        dest = tmp_path / "dest"
        dest.mkdir()
        log = tmp_path / "c.jsonl"
        _append_changelog(log, 0, 6)
        t = P.CdcTailer(log, dest, P.Cursor(tmp_path / "cur.json"))
        assert t.poll(100) == 6
        publish = next(i for i, c in enumerate(calls) if isinstance(c, tuple) and c[1].startswith("cdc-"))
        assert "fsync" in calls[:publish], calls

    def test_crash_between_batch_and_cursor_is_idempotent(self, P, tmp_path):
        dest = tmp_path / "dest"
        dest.mkdir()
        log = tmp_path / "c.jsonl"
        _append_changelog(log, 0, 6)
        t = P.CdcTailer(log, dest, P.Cursor(tmp_path / "cur.json"))
        P.faults.inject("ingest.tail", crash=True, at_call=1)
        with pytest.raises(P.CrashPoint):
            t.poll(100)
        P.faults.reset()
        assert len(sorted(dest.glob("cdc-*.parquet"))) == 1
        assert t.poll(100) == 6
        batches = sorted(dest.glob("cdc-*.parquet"))
        assert len(batches) == 1
        assert sorted(pq.read_table(batches[0]).column("id").to_pylist()) == list(range(6))
        assert t.poll(100) == 0


# -- crash sweeps: kill mid-append, kill mid-compact ---------------------------


def _assert_converges(P, session, hs, daemon, source, point, total_ids):
    """After a crash: the stable log resolves, recover() converges and is
    idempotent, the query is right on whatever landed, and a disarmed
    drain delivers every CDC row exactly once."""
    ctx = f"{P.name} point={point}"
    mgr = session.manager
    mgr.log_manager_factory(mgr.path_resolver.get_index_path("idx1")).get_latest_stable_log()
    hs.recover("idx1")
    again = hs.recover("idx1")
    assert not again["rolled"] and again["orphans_removed"] == 0, ctx
    _query_matches(P, session, source)
    assert daemon.drain(timeout=60), ctx
    assert _ids(P, session, source) == sorted(i for i in total_ids if i % 4 == 1), ctx


class TestCrashSweep:
    def test_kill_mid_append_every_tick_fault_point(self, P, tmp_path_factory):
        source, session, hs, daemon, _ = _setup(P, tmp_path_factory.mktemp("disc"))
        with P.faults.recording() as seen:
            daemon.tick()
        points = sorted(seen)
        assert "ingest.tail" in points and "ingest.commit" in points
        crashed_at = []
        for point in points:
            tmp = tmp_path_factory.mktemp("sweep")
            source, session, hs, daemon, _ = _setup(P, tmp)
            P.faults.inject(point, crash=True, at_call=1)
            try:
                daemon.tick()
            except P.CrashPoint:
                crashed_at.append(point)
            finally:
                P.faults.reset()
            _assert_converges(P, session, hs, daemon, source, point, range(40 + 24))
        assert crashed_at, f"no crash fired across {points}"

    def test_kill_mid_compact(self, P, tmp_path_factory):
        for point in ("ingest.compact", "log.stable.write"):
            tmp = tmp_path_factory.mktemp("compact")
            source, session, hs, daemon, changelog = _setup(P, tmp, **{
                "hyperspace.advisor.lifecycle.autoOptimize": "true",
                "hyperspace.advisor.lifecycle.maxDeltas": "1",
            })
            daemon.tick()
            _append_changelog(changelog, 64, 8)
            P.faults.inject(point, crash=True, at_call=2 if point == "log.stable.write" else 1)
            with pytest.raises(P.CrashPoint):
                daemon.tick()
            P.faults.reset()
            _assert_converges(P, session, hs, daemon, source, point, range(40 + 24 + 8))

    def test_compaction_runs_and_is_deferred_while_burning(self, P, tmp_path):
        source, session, hs, daemon, changelog = _setup(
            P, tmp_path, **{"hyperspace.advisor.lifecycle.maxDeltas": "1"})
        daemon.tick()
        _append_changelog(changelog, 64, 8)
        daemon.tick()
        assert P.writer.delta_count(session, "idx1") > 1
        session.conf.set("hyperspace.advisor.lifecycle.autoOptimize", "true")
        base = P.stats.get("ingest.deferred")
        assert P.writer.maybe_compact(hs, "idx1", burning=True) is False
        assert P.stats.get("ingest.deferred") == base + 1
        assert P.writer.delta_count(session, "idx1") > 1
        assert P.writer.maybe_compact(hs, "idx1", burning=False) is True
        assert P.stats.get("ingest.compactions") >= 1
        assert P.writer.delta_count(session, "idx1") <= 1
        _query_matches(P, session, source)


# -- torn-window sweep, driven by the names in the JAX package's registry ------


def _drive_batch_before_cursor(P, tmp_path_factory, point):
    tmp = tmp_path_factory.mktemp("torn_tail")
    dest = tmp / "dest"
    dest.mkdir()
    log = tmp / "c.jsonl"
    _append_changelog(log, 0, 6)
    t = P.CdcTailer(log, dest, P.Cursor(tmp / "cur.json"))
    P.faults.inject(point, crash=True, at_call=1)
    with pytest.raises(P.CrashPoint):
        t.poll(100)
    P.faults.reset()
    (batch,) = sorted(dest.glob("cdc-*.parquet"))
    assert not (tmp / "cur.json").exists()
    assert t.poll(100) == 6
    assert sorted(dest.glob("cdc-*.parquet")) == [batch]
    assert sorted(pq.read_table(batch).column("id").to_pylist()) == list(range(6))
    assert t.poll(100) == 0


def _drive_commit_before_lag_stamp(P, tmp_path_factory, point):
    tmp = tmp_path_factory.mktemp("torn_stamp")
    source, session, hs, daemon, changelog = _setup(P, tmp)
    P.faults.inject(point, crash=True, at_call=1)
    with pytest.raises(P.CrashPoint):
        daemon.tick()
    P.faults.reset()
    assert daemon.snapshot()["last_commit_ids"] == {}
    _assert_converges(P, session, hs, daemon, source, point, range(40 + 24))
    _append_changelog(changelog, 64, 4)
    daemon.tick()
    assert daemon.snapshot()["last_commit_ids"].get("idx1", 0) >= 1


_TORN_WINDOW_DRIVERS = {
    "ingest.cdc.batch_before_cursor": _drive_batch_before_cursor,
    "ingest.commit_before_lag_stamp": _drive_commit_before_lag_stamp,
}


class TestTornWindowSweep:
    """Over the names in the port's own `TORN_WINDOWS`, each package
    reading its window from its own registry: an ingest window added there
    without a driver here fails with a KeyError, and one the JAX package
    lacks fails on its lookup."""

    @pytest.mark.parametrize("window", sorted(k for k in TORN_WINDOWS if k.startswith("ingest.")))
    def test_kill_inside_window_converges(self, P, window, tmp_path_factory):
        _fn, _first, _second, point, why = P.torn_windows[window]
        assert point in P.faults.KNOWN_POINTS, why
        _TORN_WINDOW_DRIVERS[window](P, tmp_path_factory, point)


# -- the daemon's lifecycle, drain and /healthz --------------------------------


class TestDaemonLifecycle:
    def test_disabled_kill_switch_makes_ticks_noops(self, P, tmp_path):
        source, session, hs, daemon, _ = _setup(P, tmp_path)
        session.conf.set("hyperspace.ingest.enabled", "false")
        base = P.stats.get("ingest.ticks")
        out = daemon.tick()
        assert P.stats.get("ingest.ticks") == base and out["commits"] == 0

    def test_pause_defers_resume_commits(self, P, tmp_path):
        source, session, hs, daemon, _ = _setup(P, tmp_path)
        daemon.pause(reason="test")
        assert daemon.paused()
        out = daemon.tick()
        assert out["commits"] == 0 and P.stats.get("ingest.deferred") >= 1
        daemon.resume()
        assert daemon.tick()["commits"] == 1
        names = [e["name"] for e in P.events.recent()]
        assert "ingest.paused" in names and "ingest.resumed" in names

    def test_watch_requires_existing_index(self, P, tmp_path):
        daemon = P.pkg.Hyperspace(P.session(tmp_path / "sys")).ingest()
        with pytest.raises(P.HyperspaceError, match="create the index first"):
            daemon.watch("nope")

    def test_thread_mode_start_commits_then_drains(self, P, tmp_path):
        source, session, hs, daemon, changelog = _setup(P, tmp_path, **{"hyperspace.ingest.pollSeconds": "0.05"})
        daemon.start()
        try:
            assert daemon.drain(timeout=60)
            assert set(_ids(P, session, source)) >= {i for i in range(64) if i % 4 == 1}
            _append_changelog(changelog, 64, 8)
            assert daemon.drain(timeout=60)
            assert _ids(P, session, source) == [i for i in range(72) if i % 4 == 1]
        finally:
            daemon.stop()
        snap = daemon.snapshot()
        assert not snap["running"] and snap["commits"] >= 2

    def test_snapshot_shape_for_healthz(self, P, tmp_path):
        source, session, hs, daemon, _ = _setup(P, tmp_path)
        daemon.tick()
        snap = daemon.snapshot()
        assert snap["watched"] == ["idx1"]
        assert snap["enabled"] and not snap["running"]
        assert snap["last_commit_ids"]["idx1"] >= 1
        assert snap["last_commit_lag_seconds"] is not None

    def test_lagging_event_when_commit_cannot_keep_up(self, P, tmp_path):
        source, session, hs, daemon, _ = _setup(P, tmp_path, **{"hyperspace.ingest.maxLagSeconds": "0.5"})
        t = [0.0]
        daemon._clock = lambda: t[0]
        with P.faults.injected("log.write", times=100):
            daemon.tick(now=0.0)
            t[0] = 10.0
            daemon.tick(now=10.0)
        assert any(e["name"] == "ingest.lagging" for e in P.events.recent())
        assert P.stats.get("ingest.commit_failures") >= 1


# -- SIGKILL: the process worker leaves no torn snapshot -----------------------


class TestSigkill:
    def test_sigkilled_daemon_leaves_no_torn_snapshot(self, P, tmp_path):
        source, session, hs, daemon, changelog = _setup(P, tmp_path, cdc=48, **{
            "hyperspace.ingest.processWorker": "true",
            "hyperspace.ingest.pollSeconds": "0.05",
            "hyperspace.ingest.cdcBatchRows": "8",
        })
        mgr = session.manager
        lm = mgr.log_manager_factory(mgr.path_resolver.get_index_path("idx1"))
        base_id = lm.get_latest_id()
        daemon.start()
        try:
            pid = daemon.worker_pid()
            assert pid is not None
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and (lm.get_latest_id() or 0) <= (base_id or 0):
                time.sleep(0.05)
            assert (lm.get_latest_id() or 0) > (base_id or 0), "worker never committed"
            os.kill(pid, signal.SIGKILL)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and daemon._host.alive_count() > 0:
                time.sleep(0.05)
            assert daemon._host.alive_count() == 0
        finally:
            daemon.stop()
        assert lm.get_latest_stable_log() is not None
        hs.recover("idx1")
        _query_matches(P, session, source)
        session.conf.set("hyperspace.ingest.processWorker", "false")
        d2 = hs.ingest().watch("idx1", changelog=changelog)
        assert d2.drain(timeout=120)
        assert _ids(P, session, source) == [i for i in range(40 + 48) if i % 4 == 1]


# -- the controller's backoff: pause while burning, resume on recovery ---------


class _CtrlSession:
    """The session surface the controller and the daemon read."""

    def __init__(self, P, tmp_path, **conf_overrides):
        self.conf = P.Conf()
        self.conf.set("hyperspace.system.path", str(tmp_path / "sys"))
        self.conf.set("hyperspace.controller.enabled", "true")
        self.conf.set("hyperspace.ingest.enabled", "true")
        for k, v in conf_overrides.items():
            self.conf.set(k, v)
        self._state_lock = threading.RLock()
        self.index_health = {}


class _CtrlHyperspace:
    def __init__(self, session):
        self.session = session

    def recover(self, name=None):
        return {}

    def lifecycle(self):
        class _L:
            def sweep(self):
                return {"applied": [], "skipped": [], "failed": []}

        return _L()


def _drive_page(completed, failed, ctrl, t0=0.0):
    """Baseline traffic then a failure burst: two page ticks (hysteresis
    2), so the controller actuates."""
    completed.inc(10_000)
    ctrl.step(now=t0)
    ctrl.step(now=t0 + 4000.0)
    failed.inc(3_000)
    ctrl.step(now=t0 + 4030.0)
    ctrl.step(now=t0 + 4031.0)
    return t0 + 4031.0


def _actuations(P, action):
    return [e for e in P.events.recent()
            if e["name"] == "controller.actuation" and e["fields"]["action"] == action]


class TestControllerBackoff:
    def _wire(self, P, tmp_path, **conf):
        session = _CtrlSession(P, tmp_path, **conf)
        hs = _CtrlHyperspace(session)
        daemon = P.IngestDaemon(hs)
        ctrl = P.OpsController(hs, clock=lambda: 0.0, ingest=daemon)
        return session, daemon, ctrl, P.metrics.counter("serve.completed"), P.metrics.counter("serve.failed")

    def test_burn_pauses_ingest_recovery_resumes(self, P, tmp_path):
        session, daemon, ctrl, completed, failed = self._wire(P, tmp_path)
        t = _drive_page(completed, failed, ctrl)
        assert daemon.paused() and ctrl.snapshot()["ingest_paused"]
        evts = _actuations(P, "ingest.pause")
        assert evts and evts[-1]["fields"]["trigger"] == "slo.page"
        assert evts[-1]["fields"]["outcome"] == "executed"
        base = P.stats.get("ingest.deferred")
        daemon.tick()
        assert P.stats.get("ingest.deferred") == base + 1
        completed.inc(1_000_000)
        ctrl.step(now=t + 70.0)
        assert daemon.paused()
        ctrl.step(now=t + 71.0)
        assert not daemon.paused() and not ctrl.snapshot()["ingest_paused"]
        resumes = _actuations(P, "ingest.resume")
        assert resumes and resumes[-1]["fields"]["trigger"] == "slo.recovered"

    def test_pause_respects_hysteresis(self, P, tmp_path):
        session, daemon, ctrl, completed, failed = self._wire(P, tmp_path)
        completed.inc(10_000)
        ctrl.step(now=0.0)
        ctrl.step(now=4000.0)
        failed.inc(3_000)
        ctrl.step(now=4030.0)
        assert not daemon.paused()

    def test_kill_switch_releases_held_pause(self, P, tmp_path):
        session, daemon, ctrl, completed, failed = self._wire(P, tmp_path)
        _drive_page(completed, failed, ctrl)
        assert daemon.paused()
        session.conf.set("hyperspace.controller.enabled", "false")
        ctrl.step(now=9000.0)
        assert not daemon.paused() and not ctrl.snapshot()["ingest_paused"]

    def test_pause_spends_actuation_budget(self, P, tmp_path):
        session, daemon, ctrl, completed, failed = self._wire(
            P, tmp_path, **{"hyperspace.controller.actuationBudget": "0"})
        _drive_page(completed, failed, ctrl)
        assert not daemon.paused()
        evts = _actuations(P, "ingest.pause")
        assert evts and all(e["fields"]["outcome"] == "observe_only" for e in evts)


# -- the registries ------------------------------------------------------------


class TestRegistries:
    def test_fault_points_known(self, P):
        for point in ("ingest.tail", "ingest.commit", "ingest.compact"):
            assert point in P.faults.KNOWN_POINTS

    def test_counters_declared(self, P):
        for c in ("ingest.ticks", "ingest.commits", "ingest.commit_failures", "ingest.rows", "ingest.bytes",
                  "ingest.compactions", "ingest.compact_failures", "ingest.deferred", "ingest.snapshots",
                  "ingest.pinned_reads"):
            assert c in P.stats.KNOWN_COUNTERS, c

    def test_error_contracts_cover_daemon_entry_points(self, P):
        from importlib import import_module

        contracts = import_module(f"{P.pkg.__name__}.exceptions").ERROR_CONTRACTS
        for qname in (
            "ingest.daemon.IngestDaemon.tick",
            "ingest.daemon._service_entry",
            "ingest.tailer.CdcTailer.poll",
            "ingest.writer.commit_micro_batch",
            "ingest.writer.maybe_compact",
        ):
            assert f"{P.pkg.__name__}.{qname}" in contracts, qname


def test_the_port_declares_the_jax_packages_ingest_names():
    assert [p for p in tfaults.KNOWN_POINTS if p.startswith("ingest.")] == [
        p for p in jfaults.KNOWN_POINTS if p.startswith("ingest.")]
    assert [c for c in tstats.KNOWN_COUNTERS if c.startswith("ingest.")] == [
        c for c in jstats.KNOWN_COUNTERS if c.startswith("ingest.")]
    assert {k: v for k, v in tevents.KNOWN_EVENTS.items() if k.startswith("ingest.")} == {
        k: v for k, v in jevents.KNOWN_EVENTS.items() if k.startswith("ingest.")}


def test_the_ingest_keys_read_the_jax_packages_defaults():
    keys = [k for k in htorch.config.PORTED_KEYS if k.startswith("hyperspace.ingest.")]
    assert len(keys) == 6
    port, ref = TConf(), JConf()
    for key in keys:
        assert port.get(key) == ref.get(key), key
    for key, value in (("hyperspace.ingest.pollSeconds", "0.25"), ("hyperspace.ingest.cdcBatchRows", "7"),
                       ("hyperspace.ingest.autoCompact", "false"), ("hyperspace.ingest.processWorker", "true"),
                       ("hyperspace.ingest.maxLagSeconds", "2.5"), ("hyperspace.ingest.enabled", "true")):
        port.set(key, value)
        ref.set(key, value)
    for attr in ("ingest_enabled", "ingest_poll_seconds", "ingest_cdc_batch_rows", "ingest_auto_compact",
                 "ingest_process_worker", "ingest_max_lag_seconds"):
        assert getattr(port, attr) == getattr(ref, attr), attr


# -- parity across the packages ------------------------------------------------


def _files(root: Path, pattern: str) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob(pattern))}


def _entry_docs(base: Path) -> list[tuple[str, dict]]:
    """The index's log entries and the latestStable pointer, less what
    differs by run and place: the timestamp, the files' mtimes and the
    fingerprint folded from them, and the paths' common prefix."""
    out = []
    log = base / "sys" / "idx1" / "_hyperspace_log"
    for p in sorted(log.iterdir(), key=lambda p: (not p.name.isdigit(), int(p.name) if p.name.isdigit() else 0)):
        doc = json.loads(p.read_text().replace(str(base), "<base>"))
        doc.pop("timestamp")
        doc["source"]["fingerprint"].pop("value")
        for f in doc["source"]["files"]:
            f.pop("mtimeNs")
        out.append((p.name, doc))
    return out


def test_same_ingest_gives_byte_identical_batches_and_deltas(tmp_path):
    """Each package ingests the same seed, changelog and arriving file: the
    CDC batch files and every version's bucket files are byte-identical,
    the manifests and log entries equal, and the cursors agree."""
    out = {}
    for P in (JAX, TORCH):
        base = tmp_path / P.name
        source, session, hs, daemon, changelog = _setup(P, base, cdc=30, **{
            "hyperspace.ingest.cdcBatchRows": "16",
            "hyperspace.advisor.lifecycle.autoOptimize": "true",
            "hyperspace.advisor.lifecycle.maxDeltas": "2",
        })
        daemon.tick()
        pq.write_table(pa.table({"id": np.arange(100, 120), "key": np.arange(20) % 4,
                                 "value": np.linspace(0, 1, 20)}), Path(source) / "part-1.parquet")
        daemon.tick()
        _append_changelog(changelog, 200, 10)
        daemon.tick()  # a third delta: past maxDeltas, so the tick compacts
        assert P.stats.get("ingest.compactions") == 1
        out[P.name] = {
            "batches": _files(Path(source), "cdc-*.parquet"),
            "buckets": _files(base / "sys" / "idx1", "*.parquet"),
            "manifests": {k: json.loads(v) for k, v in _files(base / "sys" / "idx1", "_index_manifest.json").items()},
            "entries": _entry_docs(base),
            "cursor": json.loads((base / "sys" / "_ingest" / "cursors" / "idx1.json").read_text())["cdc"],
            "ids": _ids(P, session, source),
        }
    j, t = out["jax"], out["torch"]
    assert len(j["batches"]) == 3 and j["batches"] == t["batches"]
    assert len(j["buckets"]) > 2 and j["buckets"].keys() == t["buckets"].keys()
    for name in j["buckets"]:
        assert j["buckets"][name] == t["buckets"][name], name
    assert j["manifests"] == t["manifests"]
    assert j["entries"] == t["entries"]
    assert j["cursor"] == t["cursor"] == {"offset": j["cursor"]["offset"], "seq": 3}
    assert j["ids"] == t["ids"]


def test_equal_snapshot_stamps_and_plan_keys(tmp_path):
    """One store, both packages: equal stamps, equal pinned plans and equal
    plan keys, live and pinned, before and after a commit."""
    source, jsession, jhs, jdaemon, _ = _setup(JAX, tmp_path)
    tsession = TORCH.session(tmp_path / "sys", num_buckets=2).enable_hyperspace()
    jsnap, tsnap = jsession.pin_snapshot(), tsession.pin_snapshot()
    assert jsnap.stamp == tsnap.stamp
    assert jrouting.snapshot_stamp(jsnap) == trouting.snapshot_stamp(tsnap)
    jplan, tplan = _plan(JAX, jsession, source), _plan(TORCH, tsession, source)
    assert jplan_signature(jsnap.pin_plan(jplan)) == tplan_signature(tsnap.pin_plan(tplan))
    assert jversioned_plan_key(jsession, jplan) == tversioned_plan_key(tsession, tplan)
    k = jversioned_plan_key(jsession, jsnap.pin_plan(jplan), snapshot=jsnap)
    assert k == tversioned_plan_key(tsession, tsnap.pin_plan(tplan), snapshot=tsnap)
    jdaemon.tick()
    assert jversioned_plan_key(jsession, jplan) == tversioned_plan_key(tsession, tplan)
    assert tversioned_plan_key(tsession, tsnap.pin_plan(tplan), snapshot=tsnap) == k
    tsnap2 = tsession.pin_snapshot()
    assert tsnap2.stamp == jsession.pin_snapshot().stamp != tsnap.stamp
    assert _ids(TORCH, tsession, source, snapshot=tsnap) == _ids(JAX, jsession, source, snapshot=jsnap)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_an_index_one_package_ingests_is_queried_by_the_other(tmp_path, writer):
    W, R = PKGS[writer], PKGS["torch" if writer == "jax" else "jax"]
    source, session, hs, daemon, changelog = _setup(W, tmp_path)
    daemon.start()
    try:
        assert daemon.drain(timeout=60)
    finally:
        daemon.stop()
    reader = R.session(tmp_path / "sys", num_buckets=2).enable_hyperspace()
    assert _ids(R, reader, source) == [i for i in range(64) if i % 4 == 1]
    _query_matches(R, reader, source)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_a_cursor_and_batch_one_package_writes_the_other_continues(tmp_path, first):
    """The first package tails and crashes between its batch and its
    cursor, then tails one whole batch; the other package's daemon over
    the same store rewrites the torn batch in place, continues from the
    cursor and drains every row exactly once."""
    A, B = PKGS[first], PKGS["torch" if first == "jax" else "jax"]
    source, session, hs, daemon, changelog = _setup(A, tmp_path, **{"hyperspace.ingest.cdcBatchRows": "10"})
    A.faults.inject("ingest.tail", crash=True, at_call=1)
    with pytest.raises(A.CrashPoint):
        daemon.tick()
    A.faults.reset()
    torn = sorted(Path(source).glob("cdc-*.parquet"))
    assert [p.name for p in torn] == ["cdc-000000.parquet"]
    torn_bytes = torn[0].read_bytes()
    assert not (tmp_path / "sys" / "_ingest" / "cursors" / "idx1.json").exists()
    other = B.session(tmp_path / "sys", num_buckets=2)
    other.conf.set("hyperspace.ingest.enabled", "true")
    other.conf.set("hyperspace.ingest.cdcBatchRows", "10")
    other.enable_hyperspace()
    hs_b = B.pkg.Hyperspace(other)
    d_b = hs_b.ingest().watch("idx1", changelog=changelog)
    d_b.tick()
    names = sorted(p.name for p in Path(source).glob("cdc-*.parquet"))
    assert names == ["cdc-000000.parquet", "cdc-000001.parquet", "cdc-000002.parquet"]
    assert (Path(source) / "cdc-000000.parquet").read_bytes() == torn_bytes
    _append_changelog(changelog, 64, 6)
    # Back to the first package: it reads the other's cursor and goes on.
    daemon2 = hs.ingest().watch("idx1", changelog=changelog)
    assert daemon2.drain(timeout=60)
    cursor = json.loads((tmp_path / "sys" / "_ingest" / "cursors" / "idx1.json").read_text())["cdc"]
    assert cursor["seq"] == 4 and cursor["offset"] == changelog.stat().st_size
    want = [i for i in range(70) if i % 4 == 1]
    assert _ids(A, session, source) == want and _ids(B, other, source) == want


_CRASHES = [("commit", "bucket.written", 1), ("commit", "log.stable.write", 1),
            ("commit", "ingest.stamp", 1), ("compact", "ingest.compact", 1),
            ("compact", "log.stable.write", 2)]


@pytest.mark.parametrize("first", ["jax", "torch"])
@pytest.mark.parametrize("phase,point,at_call", _CRASHES, ids=[f"{p}-{q}" for p, q, _ in _CRASHES])
def test_a_crash_one_package_leaves_the_other_recovers(tmp_path, first, phase, point, at_call):
    """A crash inside an ingest commit or compaction left by one package:
    the other's recover() converges, its query is right, and its daemon
    drains every row exactly once."""
    A, B = PKGS[first], PKGS["torch" if first == "jax" else "jax"]
    conf = {}
    if phase == "compact":
        conf = {"hyperspace.advisor.lifecycle.autoOptimize": "true", "hyperspace.advisor.lifecycle.maxDeltas": "1"}
    source, session, hs, daemon, changelog = _setup(A, tmp_path, **conf)
    total = 64
    if phase == "compact":
        daemon.tick()
        _append_changelog(changelog, 64, 8)
        total = 72
    A.faults.inject(point, crash=True, at_call=at_call)
    with pytest.raises(A.CrashPoint):
        daemon.tick()
    A.faults.reset()
    other = B.session(tmp_path / "sys", num_buckets=2)
    other.conf.set("hyperspace.ingest.enabled", "true")
    for k, v in conf.items():
        other.conf.set(k, v)
    other.enable_hyperspace()
    hs_b = B.pkg.Hyperspace(other)
    hs_b.recover("idx1")
    again = hs_b.recover("idx1")
    assert not again["rolled"] and again["orphans_removed"] == 0
    _query_matches(B, other, source)
    d_b = hs_b.ingest().watch("idx1", changelog=changelog)
    assert d_b.drain(timeout=60)
    assert _ids(B, other, source) == [i for i in range(total) if i % 4 == 1]
    assert _ids(A, session, source) == [i for i in range(total) if i % 4 == 1]


def _hot_table(tmp_path, n=5000, seed=7):
    rng = np.random.default_rng(seed)
    root = tmp_path / "hot"
    root.mkdir()
    t = pa.table({"k": rng.integers(0, 500, n), "v": rng.standard_normal(n),
                  "tag": pa.array([f"t{i % 37}" for i in range(n)])})
    for i in range(2):
        pq.write_table(t.slice(i * (n // 2), n // 2), root / f"p{i}.parquet")
    return root


def test_pinned_reader_keys_ledger_on_snapshot_stamp(P, tmp_path):
    """A pinned query keys the routing ledger on its snapshot's own read
    point: a concurrent commit moves the live stamp, which empties the
    ledger for live readers, but not the evidence recorded under the pinned
    view."""
    session = P.session(tmp_path / "sys", num_buckets=8)
    hs = P.pkg.Hyperspace(session)
    df = session.parquet(_hot_table(tmp_path))
    hs.create_index(df, P.pkg.IndexConfig("kidx", ["k"], ["v"]))
    session.conf.set("hyperspace.advisor.routing.enabled", True)
    q = df.filter(P.pkg.col("k") == 3).select("k", "v")
    led = session.routing_ledger()
    session.enable_hyperspace()
    with session.pin_snapshot() as snap:
        pinned = P.routing.snapshot_stamp(snap)
        assert pinned == P.routing.collection_stamp(session)
        sig = P.plan_signature(snap.pin_plan(q))
        led.record(sig, "raw", 0.01, stamp=pinned)
        led.record(sig, "indexed", 10.0, stamp=pinned)
        assert led.decide(sig, stamp=pinned) == "raw"
        hs.refresh_index("kidx")
        assert P.routing.collection_stamp(session) != pinned
        assert P.routing.snapshot_stamp(snap) == pinned
        session.run(q, snapshot=snap)
        assert dict(session.last_query_stats)["advisor_routing"] == {"decision": "raw", "demoted": True}
        assert led.decide(sig, stamp=pinned) == "raw"
    session.run(q)
    assert dict(session.last_query_stats)["advisor_routing"]["decision"] == "indexed"


def test_healthz_carries_the_ingest_section(tmp_path):
    """A started daemon registers on the shared health plane: /healthz's
    `ingest` section is its snapshot."""
    import urllib.request

    source, session, hs, daemon, _ = _setup(TORCH, tmp_path, **{"hyperspace.ingest.pollSeconds": "0.05"})
    plane = thttp.acquire()
    daemon.start()
    try:
        assert daemon.drain(timeout=60)
        with urllib.request.urlopen(plane.url("/healthz"), timeout=10) as r:
            doc = json.loads(r.read())
    finally:
        daemon.stop()
    (section,) = doc["ingest"]
    assert section["watched"] == ["idx1"] and section["mode"] == "thread" and section["running"]
    assert section["commits"] >= 1 and section["last_commit_ids"]["idx1"] >= 1
    assert plane.healthz()["ingest"][0]["running"] is False


def test_committed_events_name_the_sort_device(tmp_path):
    """Each committed micro-batch's event names the device its bucket sort
    ran on: the session's."""
    source, session, hs, daemon, changelog = _setup(TORCH, tmp_path)
    daemon.tick()
    _append_changelog(changelog, 64, 4)
    daemon.tick()
    committed = [e["fields"] for e in tevents.recent() if e["name"] == "ingest.committed"]
    assert [c["sort_device"] for c in committed] == ["cpu", "cpu"]
    assert session.last_build_stats["sort_device"] == "cpu"


def test_a_worker_sent_to_the_card_without_one_raises(tmp_path, monkeypatch):
    """The process worker takes its device from the parent and never falls
    back to the CPU: sent to the card on a machine without one, it raises
    before it watches or commits anything."""
    import torch

    from hyperspace_tpu_torch.ingest.daemon import _service_entry

    source, session, hs, daemon, changelog = _setup(TORCH, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stop = threading.Event()
    with pytest.raises(THyperspaceError, match="no CUDA device"):
        _service_entry(str(tmp_path / "sys"), [("idx1", str(changelog))], {"device": "cuda"}, stop)
    assert not (tmp_path / "sys" / "_ingest" / "cursors" / "idx1.json").exists()
    with pytest.raises(KeyError):
        _service_entry(str(tmp_path / "sys"), [("idx1", str(changelog))], {}, stop)


def test_a_pinned_plan_keys_the_shared_plan_cache_across_packages(tmp_path):
    """The fleet's shared plan cache keys a pinned read on the snapshot's
    stamp: the entry one package publishes for a pinned plan is the entry
    the other reads for it, a commit leaves the pinned entry hitting, and
    the live plan then misses."""
    from hyperspace_tpu.serve.fleet.shared_cache import SharedPlanCache as JShared
    from hyperspace_tpu_torch.serve.fleet.shared_cache import SharedPlanCache as TShared

    source, jsession, jhs, jdaemon, _ = _setup(JAX, tmp_path)
    tsession = TORCH.session(tmp_path / "sys", num_buckets=2).enable_hyperspace()
    jsnap, tsnap = jsession.pin_snapshot(), tsession.pin_snapshot()
    jplan, tplan = jsnap.pin_plan(_plan(JAX, jsession, source)), tsnap.pin_plan(_plan(TORCH, tsession, source))
    shared = tmp_path / "shared"
    jcache, tcache = JShared(shared), TShared(shared)
    published = jcache.get_or_optimize(jsession, jplan, snapshot=jsnap)
    assert tcache.entry_path(tversioned_plan_key(tsession, tplan, snapshot=tsnap)) == jcache.entry_path(
        jversioned_plan_key(jsession, jplan, snapshot=jsnap))
    got = tcache.get_or_optimize(tsession, tplan, snapshot=tsnap)
    assert (tstats.get("fleet.shared_cache.hits"), tstats.get("fleet.shared_cache.misses")) == (1, 0)
    assert got.to_json() == published.to_json()
    jdaemon.tick()
    tcache.get_or_optimize(tsession, tplan, snapshot=tsnap)
    assert tstats.get("fleet.shared_cache.hits") == 2
    tcache.get_or_optimize(tsession, _plan(TORCH, tsession, source))
    assert tstats.get("fleet.shared_cache.misses") == 1
    assert _ids(TORCH, tsession, source, snapshot=tsnap) == _ids(JAX, jsession, source, snapshot=jsnap)
