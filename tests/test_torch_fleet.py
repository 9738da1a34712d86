"""The port's multi-process serving fleet on the CPU.

tests/test_fleet.py's cases through the port: the file lease (stale-holder
reaping), cross-process single-flight (leader, follower, local fallback,
takeover, the follower's wait span linked to the leader's trace), the
device cache's single-flight wait timeout, tenant token buckets and
queue-depth shedding in the scheduler, and the disk-backed shared plan and
result caches (strings and nulls, versioned invalidation, a corrupt entry a
miss, an oversized entry never admitted, eviction under the lease). Held
against the JAX package: the token-bucket arithmetic on one seeded
schedule, a lease held through either package blocking the other's claim,
and a shared result entry published by one package read by the other.

Four tests spawn members (tests/_torch_fleet.py, on the CPU): the
supervisor restarts a crashed member (the coordinator's fault rule fires
inside it), a crash loop backs off, a SIGKILLed single-flight holder is
taken over, and a member serving through the shared caches never answers
from before another process's refresh, its ephemeral health port
discovered through the fleet directory.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from hyperspace_tpu.serve.fleet.lease import FileLease as JaxFileLease
from hyperspace_tpu.serve.fleet.quota import TokenBucket as JaxTokenBucket
from hyperspace_tpu.serve.fleet.shared_cache import SharedResultCache as JaxSharedResultCache

from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col, faults, stats
from hyperspace_tpu_torch.exceptions import AdmissionRejected, QuotaExceeded
from hyperspace_tpu_torch.obs import events, journal, metrics, trace
from hyperspace_tpu_torch.serve import QueryServer, fleet
from hyperspace_tpu_torch.serve.fleet.lease import FileLease
from hyperspace_tpu_torch.serve.fleet.quota import TenantQuotas, TokenBucket
from hyperspace_tpu_torch.serve.fleet.shared_cache import SharedResultCache
from hyperspace_tpu_torch.serve.fleet.singleflight import SingleFlight, key_name

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_fleet as members  # noqa: E402


@pytest.fixture(autouse=True)
def _port_obs_reset():
    """The port's process-global state, zeroed around each test
    (tests/conftest.py resets the JAX package's)."""
    stats.reset()
    metrics.REGISTRY.reset()
    trace.reset()
    trace.set_enabled(True)
    events.reset()
    journal.reset()
    faults.reset()
    yield
    faults.reset()
    journal.reset()
    trace.reset()


def _session(system_path) -> HyperspaceSession:
    return HyperspaceSession(system_path=str(system_path), device="cpu")


def _assert_same(a, b, label=""):
    da, db = a.decode(), b.decode()
    assert set(da) == set(db), (label, set(da), set(db))
    for c in da:
        av, bv = np.asarray(da[c]), np.asarray(db[c])
        assert len(av) == len(bv), (label, c)
        assert (av.astype(object) == bv.astype(object)).all() or (
            av.dtype.kind == "f" and np.array_equal(av, bv, equal_nan=True)), (label, c)


# -- file lease ---------------------------------------------------------------


class TestFileLease:
    def test_acquire_release_roundtrip(self, tmp_path):
        lease = FileLease(tmp_path / "a.lease", ttl_s=30)
        token, reaped = lease.try_acquire()
        assert not reaped
        assert lease.try_acquire() is None
        lease.release(token)
        assert lease.try_acquire() is not None

    def test_stale_holder_is_reaped(self, tmp_path):
        path = tmp_path / "b.lease"
        path.write_text(f"{time.time() - 120:.6f}:99999:dead")
        claim = FileLease(path, ttl_s=1.0).try_acquire()
        assert claim is not None and claim[1] is True

    def test_release_of_stolen_lease_is_noop(self, tmp_path):
        path = tmp_path / "c.lease"
        lease = FileLease(path, ttl_s=30)
        token, _ = lease.try_acquire()
        path.write_text("other-holder-token")
        lease.release(token)
        assert path.read_text() == "other-holder-token"

    def test_holder_note_rides_the_token(self, tmp_path):
        lease = FileLease(tmp_path / "d.lease", ttl_s=30)
        lease.try_acquire(note="123-4:x\n")
        assert lease.holder_note() == "123-4x"
        assert JaxFileLease(tmp_path / "d.lease", ttl_s=30).holder_note() == "123-4x"

    @pytest.mark.parametrize("holder", ["jax", "port"])
    def test_a_lease_held_by_one_package_blocks_the_other(self, tmp_path, holder):
        path = tmp_path / "x.lease"
        first, second = (JaxFileLease, FileLease) if holder == "jax" else (FileLease, JaxFileLease)
        token, _ = first(path, ttl_s=30).try_acquire()
        assert second(path, ttl_s=30).try_acquire() is None
        first(path, ttl_s=30).release(token)
        claim = second(path, ttl_s=30).try_acquire()
        assert claim is not None and claim[1] is False
        # A stale lease of either package is reaped by the other.
        path.unlink()
        first(path, ttl_s=0.01).try_acquire()
        time.sleep(0.05)
        assert second(path, ttl_s=0.01).try_acquire()[1] is True


# -- cross-process single-flight, driven in-process --------------------------


def _walk(span):
    yield span
    for c in span.get("children", ()):
        yield from _walk(c)


class TestSingleFlight:
    def test_leader_builds_follower_observes(self, tmp_path):
        sf = SingleFlight(tmp_path, lease_ttl_s=30, wait_s=10)
        artifact = tmp_path / "artifact.json"
        built, results = [], []
        release = threading.Event()

        def leader_build():
            release.wait(30)
            artifact.write_text(json.dumps({"v": 42}))
            built.append("leader")
            return 42

        def check():
            return json.loads(artifact.read_text())["v"] if artifact.exists() else None

        t1 = threading.Thread(target=lambda: results.append(sf.run("k", leader_build, check)))
        t1.start()
        time.sleep(0.2)
        t2 = threading.Thread(target=lambda: results.append(sf.run("k", lambda: built.append("f") or -1, check)))
        t2.start()
        time.sleep(0.2)
        release.set()
        t1.join(30)
        t2.join(30)
        assert sorted(results) == [42, 42] and built == ["leader"]
        assert stats.get("fleet.singleflight.leader") == 1
        assert stats.get("fleet.singleflight.follower_hits") == 1

    def test_follower_wait_span_links_leader_trace_id(self, tmp_path):
        sf = SingleFlight(tmp_path, lease_ttl_s=30, wait_s=10)
        artifact = tmp_path / "artifact.json"
        release = threading.Event()
        leader_trace, follower_roots = [], []

        def check():
            return 1 if artifact.exists() else None

        def leader():
            with trace.trace("leader.query"):
                leader_trace.append(trace.current_trace_id())
                sf.run("k", build=lambda: (release.wait(30), artifact.write_text("1"))[0], check=check)

        def follower():
            with trace.trace("follower.query"):
                sf.run("k", build=lambda: -1, check=check)
            follower_roots.append(trace.last_trace().to_json())

        t1 = threading.Thread(target=leader)
        t1.start()
        time.sleep(0.3)
        t2 = threading.Thread(target=follower)
        t2.start()
        time.sleep(0.3)
        release.set()
        t1.join(30)
        t2.join(30)
        (root,) = follower_roots
        (wait,) = [s for s in _walk(root) if s["name"] == "fleet.singleflight.wait"]
        assert wait["attrs"]["outcome"] == "follower_hit"
        assert wait["attrs"]["leader_trace_id"] == leader_trace[0]

    def test_wait_expiry_falls_back_to_local_build(self, tmp_path):
        sf = SingleFlight(tmp_path, lease_ttl_s=30, wait_s=0.1)
        FileLease(tmp_path / f"{key_name('k2')}.lease", ttl_s=30).try_acquire()
        assert sf.run("k2", build=lambda: "local", check=lambda: None) == "local"
        assert stats.get("fleet.singleflight.local_fallbacks") == 1

    def test_stale_lease_takeover(self, tmp_path):
        sf = SingleFlight(tmp_path, lease_ttl_s=0.5, wait_s=10)
        (tmp_path / f"{key_name('k3')}.lease").write_text(f"{time.time() - 60:.6f}:99999:dead")
        assert sf.run("k3", build=lambda: "rebuilt", check=lambda: None) == "rebuilt"
        assert stats.get("fleet.singleflight.takeovers") == 1
        assert "fleet.singleflight.takeover" in [e["name"] for e in events.recent()]

    def test_build_error_releases_lease(self, tmp_path):
        sf = SingleFlight(tmp_path, lease_ttl_s=30, wait_s=0.1)
        with pytest.raises(ValueError):
            sf.run("k4", build=lambda: (_ for _ in ()).throw(ValueError("boom")))
        assert sf.run("k4", build=lambda: "ok") == "ok"

    def test_key_names_equal_the_jax_packages(self):
        from hyperspace_tpu.serve.fleet.singleflight import key_name as jax_key_name

        for key in ("heal.orders", ("plan", 1, (("idx", 3),), True, ()), "result-abc"):
            assert key_name(key) == jax_key_name(key)


# -- the device cache's single-flight wait timeout -----------------------------


class TestRefCacheWaitTimeout:
    def test_abandoned_build_event_no_longer_blocks(self):
        from hyperspace_tpu_torch.execution.device_cache import RefCache

        rc = RefCache(budget_bytes=1 << 20)
        key = ("k", 1)
        with rc._lock:
            rc._building[key] = threading.Event()  # a builder that never finishes
        t0 = time.monotonic()
        assert rc.get_or_build(key, (), lambda: ("value", 8), wait_timeout=0.05) == "value"
        assert time.monotonic() - t0 < 5.0
        with rc._lock:
            assert key in rc._building  # the slot still belongs to the stuck builder

    def test_timeout_path_still_caches(self):
        from hyperspace_tpu_torch.execution.device_cache import RefCache

        rc = RefCache(budget_bytes=1 << 20)
        key = ("k", 2)
        with rc._lock:
            rc._building[key] = threading.Event()
        rc.get_or_build(key, (), lambda: ("v1", 8), wait_timeout=0.01)
        with rc._lock:
            del rc._building[key]
        calls = []
        assert rc.get_or_build(key, (), lambda: calls.append(1) or ("v2", 8)) == "v1" and not calls


# -- tenant quotas -------------------------------------------------------------


class TestQuota:
    def test_token_bucket_math(self):
        b = TokenBucket(rate=2.0, burst=2.0, now=0.0)
        assert b.try_take(0.0) == 0.0 and b.try_take(0.0) == 0.0
        assert b.try_take(0.0) == pytest.approx(0.5)
        assert b.try_take(0.6) == 0.0

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_token_bucket_arithmetic_equals_the_jax_packages(self, seed):
        rng = np.random.default_rng(seed)
        rate, burst = float(rng.uniform(0.5, 50.0)), float(rng.integers(1, 40))
        ours, theirs = TokenBucket(rate, burst, now=0.0), JaxTokenBucket(rate, burst, now=0.0)
        now = 0.0
        for _ in range(2000):
            now += float(rng.exponential(1.0 / rate))
            scale = float(rng.choice([1.0, 0.5, 0.25, 0.0]))
            assert ours.try_take(now, scale=scale) == theirs.try_take(now, scale=scale)
            assert ours.tokens == theirs.tokens

    def test_tenants_are_isolated(self):
        clk = [0.0]
        tq = TenantQuotas(rate=1.0, burst=1, clock=lambda: clk[0])
        tq.admit("a")
        with pytest.raises(QuotaExceeded) as ei:
            tq.admit("a")
        assert ei.value.tenant == "a" and ei.value.retry_after_s > 0
        assert isinstance(ei.value, AdmissionRejected)
        tq.admit("b")
        assert metrics.REGISTRY.get("serve.quota.rejected").value == 1
        assert [e["fields"]["tenant"] for e in events.recent() if e["name"] == "serve.quota_rejected"] == ["a"]

    def test_per_tenant_limit_override_throttle_and_lru(self):
        clk = [0.0]
        tq = TenantQuotas(rate=100.0, burst=100, clock=lambda: clk[0], max_tenants=2)
        tq.set_limit("starved", rate=1.0, burst=1)
        tq.admit("starved")
        with pytest.raises(QuotaExceeded):
            tq.admit("starved")
        tq.set_throttle(0.5)
        assert tq.throttle() == 0.5
        clk[0] = 1.0  # half the rated refill: half a token
        with pytest.raises(QuotaExceeded) as ei:
            tq.admit("starved")
        assert ei.value.retry_after_s == pytest.approx(1.0)
        tq.admit("x")
        tq.admit("y")
        assert set(tq.snapshot()) == {"x", "y"}  # the LRU bound evicted "starved"

    def test_scheduler_integration(self, tmp_system_path):
        clk = [0.0]
        quotas = TenantQuotas(rate=1.0, burst=2, clock=lambda: clk[0])
        server = QueryServer(_session(tmp_system_path), workers=1, max_queue_depth=16, plan_cache=False,
                             run_fn=lambda p: p, quotas=quotas)
        try:
            assert server.submit("q1", tenant="t1").result(timeout=30) == "q1"
            assert server.run("q2", tenant="t1") == "q2"
            with pytest.raises(QuotaExceeded):
                server.submit("q3", tenant="t1")
            with pytest.raises(AdmissionRejected):
                server.submit("q4", tenant="t1")
            assert server.submit("q5").result(timeout=30) == "q5"
            assert server.submit("q6", tenant="t2").result(timeout=30) == "q6"
        finally:
            server.shutdown()

    def test_config_builds_the_quotas(self, tmp_system_path):
        session = _session(tmp_system_path)
        session.conf.set("hyperspace.serve.tenant.quota.enabled", True)
        session.conf.set("hyperspace.serve.tenant.quota.ratePerSecond", 3.0)
        session.conf.set("hyperspace.serve.tenant.quota.burst", 5)
        with QueryServer(session, workers=1, run_fn=lambda p: p) as server:
            assert isinstance(server.quotas, TenantQuotas)
            assert (server.quotas.default_rate, server.quotas.default_burst) == (3.0, 5.0)
        with QueryServer(_session(tmp_system_path), workers=1, run_fn=lambda p: p) as server:
            assert server.quotas is None


# -- queue-depth shedding --------------------------------------------------------


class TestShedding:
    def test_non_priority_sheds_at_threshold_priority_continues(self, tmp_system_path):
        started, release = threading.Event(), threading.Event()

        def blocking_run(plan):
            started.set()
            assert release.wait(30)
            return plan

        server = QueryServer(_session(tmp_system_path), workers=1, max_queue_depth=8, plan_cache=False,
                             run_fn=blocking_run, shed_depth_ratio=0.5)
        try:
            assert server.shed_depth == 4
            server.submit("head")
            assert started.wait(10)
            for i in range(4):
                server.submit(f"q{i}")
            with pytest.raises(AdmissionRejected, match="load shed"):
                server.submit("ordinary")
            h = server.submit("urgent", priority=True)
            sat = server.saturation()
            assert sat["queue_depth"] == 5 and sat["shed_depth"] == 4
            release.set()
            assert h.result(timeout=30) == "urgent"
        finally:
            release.set()
            server.shutdown()

    def test_set_shed_depth_clamps_and_applies(self, tmp_system_path):
        server = QueryServer(_session(tmp_system_path), workers=1, max_queue_depth=8, run_fn=lambda p: p)
        try:
            assert server.get_shed_depth() == 8
            assert server.set_shed_depth(0) == 1 and server.set_shed_depth(99) == 8
            assert server.set_shed_depth(3) == 3 and server.saturation()["shed_depth"] == 3
        finally:
            server.shutdown()


# -- shared caches, in one process -----------------------------------------------


def _nulls_source(tmp_path):
    root = tmp_path / "nulls"
    root.mkdir()
    pq.write_table(pa.table({
        "id": pa.array([1, 2, 3, 4], type=pa.int64()),
        "key": pa.array([7, 7, 7, 8], type=pa.int64()),
        "name": pa.array(["a", None, "c", "d"]),
        "value": pa.array([1.5, None, 3.5, 4.5], type=pa.float64()),
    }), root / "p0.parquet")
    return root


class TestSharedCaches:
    def test_result_roundtrip_with_strings_and_nulls(self, tmp_path, tmp_system_path):
        session = _session(tmp_system_path)
        q = session.parquet(_nulls_source(tmp_path)).filter(col("key") == 7).select("id", "key", "name", "value")
        serial = session.run(q)
        rc = SharedResultCache(tmp_path / "cache", max_bytes=1 << 20, device="cpu")
        key = rc.key(session, q)
        assert rc.get(key) is None
        assert rc.put(key, serial)
        assert rc.put(key, serial) is False  # already published
        out = rc.get(key)
        assert out is not None and out.device == serial.device
        _assert_same(serial, out, "roundtrip")
        assert (stats.get("fleet.shared_cache.hits"), stats.get("fleet.shared_cache.misses")) == (1, 1)

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_a_result_entry_crosses_packages(self, tmp_path, tmp_system_path, writer):
        import hyperspace_tpu as hjax

        src = _nulls_source(tmp_path)
        port = _session(tmp_system_path)
        ref = hjax.HyperspaceSession(system_path=tmp_system_path)
        q_port = port.parquet(src).filter(col("key") == 7).select("id", "key", "name", "value")
        q_jax = ref.parquet(src).filter(hjax.col("key") == 7).select("id", "key", "name", "value")
        ours = SharedResultCache(tmp_path / "cache", max_bytes=1 << 20, device="cpu")
        theirs = JaxSharedResultCache(tmp_path / "cache", max_bytes=1 << 20)
        key = ("shared", "entry", 1)
        if writer == "port":
            assert ours.put(key, port.run(q_port))
            got = theirs.get(key)
        else:
            assert theirs.put(key, ref.run(q_jax))
            got = ours.get(key)
        assert got is not None
        assert ours.entry_path(key) == theirs.entry_path(key)
        da, db = port.run(q_port).decode(), got.decode()
        for c in ("id", "key", "name"):
            assert list(np.asarray(da[c], dtype=object)) == list(np.asarray(db[c], dtype=object))
        np.testing.assert_array_equal(np.asarray(da["value"], dtype=float), np.asarray(db["value"], dtype=float))

    def test_refresh_changes_key_old_entry_unreachable(self, sample_parquet, tmp_system_path, tmp_path):
        session = _session(tmp_system_path)
        hs = Hyperspace(session)
        df = session.parquet(sample_parquet)
        hs.create_index(df, IndexConfig("fl_idx", ["key"], ["value", "id"]))
        session.enable_hyperspace()
        q = df.filter(col("key") == 77).select("id", "key", "value")
        rc = SharedResultCache(tmp_path / "cache", max_bytes=1 << 20, device="cpu")
        k1 = rc.key(session, q)
        rc.put(k1, session.run(q))
        assert rc.get(k1) is not None
        pq.write_table(pa.table({
            "id": np.arange(20_000, 20_004, dtype=np.int64), "key": np.full(4, 77, dtype=np.int64),
            "value": np.linspace(0.0, 1.0, 4), "name": [f"l{i}" for i in range(4)],
        }), f"{sample_parquet}/part-9.parquet")
        hs.refresh_index("fl_idx")
        k2 = rc.key(session, q)
        assert k2 != k1 and rc.get(k2) is None

    def test_corrupt_entry_is_advisory_miss(self, sample_parquet, tmp_system_path, tmp_path):
        session = _session(tmp_system_path)
        q = session.parquet(sample_parquet).filter(col("key") == 5).select("id", "key")
        rc = SharedResultCache(tmp_path / "cache", max_bytes=1 << 20, device="cpu")
        key = rc.key(session, q)
        rc.put(key, session.run(q))
        rc.entry_path(key).write_bytes(b"garbage not arrow")
        assert rc.get(key) is None
        assert stats.get("fleet.shared_cache.errors") == 1
        with faults.injected("fleet.cache.read"):
            assert rc.get(("other",)) is None
        assert stats.get("fleet.shared_cache.errors") == 2

    def test_oversized_result_never_admitted(self, sample_parquet, tmp_system_path, tmp_path):
        session = _session(tmp_system_path)
        q = session.parquet(sample_parquet).select("id", "key", "value", "name")
        rc = SharedResultCache(tmp_path / "cache", max_bytes=64, device="cpu")
        assert rc.put(rc.key(session, q), session.run(q)) is False
        assert rc.stats()["entries"] == 0

    def test_eviction_under_lease_respects_budget(self, tmp_path, tmp_system_path):
        session = _session(tmp_system_path)
        root = tmp_path / "d"
        root.mkdir()
        pq.write_table(pa.table({"id": pa.array(np.arange(64, dtype=np.int64)),
                                 "key": pa.array(np.arange(64, dtype=np.int64) % 8)}), root / "p0.parquet")
        serial = session.run(session.parquet(root).filter(col("key") == 1).select("id", "key"))
        rc = SharedResultCache(tmp_path / "cache", max_bytes=1 << 30, device="cpu")
        rc.put(("probe",), serial)
        entry_bytes = rc.stats()["bytes"]
        rc.clear()
        rc = SharedResultCache(tmp_path / "cache", max_bytes=int(entry_bytes * 3.5), device="cpu")
        for i in range(6):
            assert rc.put(("k", i), serial)
            time.sleep(0.02)
        st = rc.stats()
        assert st["bytes"] <= rc.max_bytes and st["entries"] < 6
        assert stats.get("fleet.shared_cache.evictions") > 0
        assert rc.get(("k", 5)) is not None
        # A live eviction lease held elsewhere defers the eviction.
        token, _ = FileLease(rc.root / "evict.lease", ttl_s=30).try_acquire()
        for i in range(6, 9):
            rc.put(("k", i), serial)
        assert rc.stats()["entries"] > 3
        FileLease(rc.root / "evict.lease", ttl_s=30).release(token)

    def test_plan_cache_shared_across_servers(self, sample_parquet, tmp_system_path):
        import hyperspace_tpu.plan.nodes as jax_nodes

        session = _session(tmp_system_path)
        hs = Hyperspace(session)
        df = session.parquet(sample_parquet)
        hs.create_index(df, IndexConfig("fl_idx2", ["key"], ["value"]))
        session.enable_hyperspace()
        q = df.filter(col("key") == 3).select("key", "value")
        plans, results = fleet.shared_caches(session)
        assert plans.root == Path(tmp_system_path) / "_fleet" / "cache" / "plans"
        assert results.device == session.device and results.single_flight is plans.single_flight
        with session.serve(workers=1, plan_cache=plans, result_cache=False) as server:
            first = server.submit(q).result(timeout=300)
        h0 = stats.get("fleet.shared_cache.hits")
        with session.serve(workers=1, plan_cache=plans, result_cache=False) as server:
            _assert_same(first, server.submit(q).result(timeout=300))
        assert stats.get("fleet.shared_cache.hits") > h0
        (entry,) = plans.root.glob("*.json")
        doc = json.loads(entry.read_text())
        assert jax_nodes.plan_from_json(doc).to_json() == doc  # the JAX package reads the entry

    def test_shared_result_cache_serves_without_executing(self, sample_parquet, tmp_system_path):
        session = _session(tmp_system_path)
        q = session.parquet(sample_parquet).filter(col("key") == 9).select("id", "key")
        plans, results = fleet.shared_caches(session)
        with session.serve(workers=1, plan_cache=plans, result_cache=results) as server:
            first = server.submit(q)
            first.result(timeout=300)
            assert not first.cache_hit
            again = server.submit(q)
            _assert_same(first.result(), again.result(timeout=300))
            assert again.cache_hit and again.profile is None
        assert stats.get("fleet.singleflight.leader") == 1


# -- the health plane's ephemeral port --------------------------------------------


class TestEphemeralHealthPort:
    def test_healthz_reports_bound_port_and_two_planes_two_ports(self):
        from hyperspace_tpu_torch.obs.http import HealthServer

        a = HealthServer(port=0).start()
        b = HealthServer(port=0).start()
        try:
            assert a.port and b.port and a.port != b.port
            assert a.healthz()["endpoint"] == {"host": "127.0.0.1", "port": a.port}
        finally:
            a.stop()
            b.stop()

    def test_worker_registrations_equal_the_jax_packages(self, tmp_path):
        from hyperspace_tpu.serve.fleet.supervisor import read_workers as jax_read_workers

        fleet.register_worker(tmp_path, 3, 4567)
        (tmp_path / "workers" / "9.json").write_text("{torn")
        assert fleet.read_workers(tmp_path) == jax_read_workers(tmp_path)
        assert fleet.read_workers(tmp_path)[3]["port"] == 4567 and 9 not in fleet.read_workers(tmp_path)


# -- real processes ----------------------------------------------------------------


def _wait(cond, timeout=180.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return False


class TestMultiProcessFleet:
    def test_supervisor_restarts_crashed_worker(self, tmp_path):
        """A member dying non-zero is respawned once (budget 1) and counted;
        the coordinator's fault rule and journal state ship into it."""
        marker = tmp_path / "attempts"
        marker.mkdir()
        journal.configure(enabled=True, root=str(tmp_path / "_obs"))
        faults.inject("fleet.lease.acquire")
        sup = fleet.FleetSupervisor(members.crasher, fleet_dir=str(tmp_path / "fleet"), n=1,
                                    args=(str(marker),), max_restarts=1)
        sup.start()
        try:
            assert _wait(lambda: sup.restarts().get(0, 0) >= 1 and sup.alive_count() == 0
                         and len(list(marker.iterdir())) == 2)
            assert sup.restarts() == {0: 1}
        finally:
            sup.stop(timeout=30)
        assert stats.get("fleet.supervisor.restarts") == 1
        assert {p.read_text() for p in marker.iterdir()} == {"fault-fired"}
        restarted = [e for e in events.recent() if e["name"] == "fleet.worker.restarted"]
        assert [e["fields"]["worker_id"] for e in restarted] == [0]
        procs = [r for r in journal.merge_dir(tmp_path / "_obs") if r["kind"] == "process"]
        assert {r["pid"] for r in procs} == {int(p.name[4:]) for p in marker.iterdir()}

    def test_crash_loop_backs_off_instead_of_burning_budget(self, tmp_path):
        marker = tmp_path / "attempts"
        marker.mkdir()
        sup = fleet.FleetSupervisor(members.crasher, fleet_dir=str(tmp_path / "fleet"), n=1,
                                    args=(str(marker),), max_restarts=3, restart_backoff=0.4)
        sup.start()
        try:
            assert _wait(lambda: sup.restarts().get(0, 0) >= 3 and sup.alive_count() == 0)
        finally:
            sup.stop(timeout=30)
        loops = [e for e in events.recent() if e["name"] == "fleet.worker.crash_loop"]
        restarted = [e for e in events.recent() if e["name"] == "fleet.worker.restarted"]
        assert len(loops) == 2 and len(restarted) == 3
        delays = [e["fields"]["delay_s"] for e in loops]
        assert 0.4 <= delays[0] <= 0.5 and 0.8 <= delays[1] <= 1.0
        for loop in loops:
            after = min((e for e in restarted if e["seq"] > loop["seq"]), key=lambda e: e["seq"])
            assert after["ts"] - loop["ts"] >= loop["fields"]["delay_s"] - 0.05

    def test_sigkilled_singleflight_holder_is_taken_over(self, tmp_path):
        from hyperspace_tpu_torch.parallel.procpool import spawn_context

        ctx = spawn_context()
        ready = ctx.Queue()
        p = ctx.Process(target=members.lease_holder, args=(str(tmp_path / "sf"), "hot-key", ready))
        p.start()
        try:
            assert ready.get(timeout=120) == "held"
            assert SingleFlight(tmp_path / "sf", lease_ttl_s=300, wait_s=0.2).run(
                "hot-key", build=lambda: "local", check=lambda: None) == "local"  # live holder: no takeover
            os.kill(p.pid, signal.SIGKILL)
            p.join(timeout=30)
            time.sleep(0.7)
            sf = SingleFlight(tmp_path / "sf", lease_ttl_s=0.5, wait_s=10)
            assert sf.run("hot-key", build=lambda: "recovered", check=lambda: None) == "recovered"
            assert stats.get("fleet.singleflight.takeovers") == 1
        finally:
            if p.is_alive():
                p.terminate()

    def test_cross_process_invalidation_and_port_discovery(self, tmp_path):
        """This process refreshes; a member serving through the shared
        caches must never answer from before the refresh once it returned.
        The member binds port 0 and registers the port it got; it loads
        neither JAX nor the JAX package and opens no CUDA context."""
        data = tmp_path / "data"
        data.mkdir()
        rng = np.random.default_rng(3)
        pq.write_table(pa.table({
            "id": pa.array(np.arange(400, dtype=np.int64)),
            "key": pa.array(rng.integers(0, 16, 400, dtype=np.int64)),
            "value": pa.array(rng.standard_normal(400)),
        }), data / "p0.parquet")
        system_path = str(tmp_path / "indexes")
        session = _session(system_path)
        hs = Hyperspace(session)
        df = session.parquet(data)
        hs.create_index(df, IndexConfig("mp_idx", ["key"], ["value", "id"]))
        session.enable_hyperspace()
        q = df.filter(col("key") == 7).select("id", "key", "value")
        plans, results = fleet.shared_caches(session)
        with session.serve(workers=1, plan_cache=plans, result_cache=results) as server:
            pre_ids = sorted(np.asarray(server.submit(q).result(timeout=300).decode()["id"]).tolist())
        from hyperspace_tpu_torch.parallel.procpool import spawn_context

        ctx = spawn_context()
        cmd_q, out_q = ctx.Queue(), ctx.Queue()
        sup = fleet.FleetSupervisor(members.cache_member, fleet_dir=str(tmp_path / "fleet"), n=1,
                                    args=(str(data), system_path, cmd_q, out_q), max_restarts=0)
        sup.start()
        try:
            cmd_q.put("query")
            first = out_q.get(timeout=180)
            assert first["ids"] == pre_ids and first["shared_hits"] >= 1
            assert first["port"] > 0 and first["forbidden"] == [] and not first["cuda_initialized"]
            assert first["device"] == "cpu"
            health = sup.fleet_health()
            assert health["members"][0]["port"] == first["port"]
            assert health["members"][0]["status"] in ("ok", "degraded")
            assert health["saturation"]["workers"] >= 1
            assert sup.fleet_summary()["members"][0]["alive"] is True
            assert "hyperspace_serve_completed" in sup.aggregate_metrics()[0]
            pq.write_table(pa.table({
                "id": np.arange(10_000, 10_006, dtype=np.int64), "key": np.full(6, 7, dtype=np.int64),
                "value": np.linspace(0.0, 1.0, 6),
            }), data / "p1.parquet")
            hs.refresh_index("mp_idx")
            post_ids = sorted(np.asarray(session.run(q).decode()["id"]).tolist())
            assert set(post_ids) >= set(pre_ids) | {10_000, 10_005}
            cmd_q.put("query")
            assert out_q.get(timeout=180)["ids"] == post_ids
            cmd_q.put("stop")
        finally:
            sup.stop(timeout=60)
