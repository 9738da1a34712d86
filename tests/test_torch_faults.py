"""The port's fault tolerance against the JAX package's.

tests/test_fault_injection.py's cases, each run through both packages
(`pkg` is "jax" or "torch") on the same seeded source (60 rows, two
files, two buckets) with the same assertions: the fault-injection
harness (schedules, brownout delays, the kill switch, recording), the
retry layer, typed corruption and manifest atomicity, the corruption
fallback, the in-process rollback of a failed op() and recover, explicit
and lazy. Query answers are exact: each equals pandas on the raw source,
and the port's equals the JAX package's.

Then the port's own cases:

- the crash sweep over `create`, `refresh`, `optimize` and `vacuum`
  (each point an action fires, a CrashPoint at its first call, then the
  JAX package's invariants), at later calls of the busy points, with the
  points discovered equal to the JAX package's (`footer.read` included
  since the port has the footer cache);
- interchange: a crash at `log.written` or `bucket.written` in one
  package is recovered by the other, with recover reports equal to the
  crashing package's own recover on a copy, and equal query answers;
- the fallback over a join (the healthy side keeps its index), a second
  failure and one without provenance, the plan cache's key moving with
  the quarantine, the result cache skipping a re-planned result, and a
  transient `bucket.read` fault retried inside a multi-file read;
- the CAS retry of `Action.run` (tests/test_action_protocol.py's case)
  and the harness's export / install round trip.
"""

import shutil
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
from hyperspace_tpu import config as jconfig
from hyperspace_tpu import exceptions as jexc
from hyperspace_tpu import faults as jfaults
from hyperspace_tpu import states as jstates
from hyperspace_tpu import stats as jstats
from hyperspace_tpu.actions.create import CreateAction as JCreateAction
from hyperspace_tpu.dataset import Dataset as JDataset
from hyperspace_tpu.execution import io as jio
from hyperspace_tpu.metadata.data_manager import IndexDataManager as JDataManager
from hyperspace_tpu.metadata.log_manager import IndexLogManager as JLogManager
from hyperspace_tpu.serve.scheduler import QueryServer as JQueryServer
from hyperspace_tpu.utils import retry as jretry
from hyperspace_tpu_torch import config as tconfig
from hyperspace_tpu_torch import exceptions as texc
from hyperspace_tpu_torch import faults as tfaults
from hyperspace_tpu_torch import states as tstates
from hyperspace_tpu_torch import stats as tstats
from hyperspace_tpu_torch.actions.create import CreateAction as TCreateAction
from hyperspace_tpu_torch.dataset import Dataset as TDataset
from hyperspace_tpu_torch.execution import device_cache as tdc
from hyperspace_tpu_torch.execution import io as tio
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager as TDataManager
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager as TLogManager
from hyperspace_tpu_torch.obs import events as tevents
from hyperspace_tpu_torch.serve.scheduler import QueryServer as TQueryServer
from hyperspace_tpu_torch.utils import retry as tretry


class _Pkg:
    """One package's fault-tolerance surface under the names the cases use."""

    def __init__(self, name):
        jax = name == "jax"
        self.name = name
        self.pkg = hjax if jax else htorch
        self.faults = jfaults if jax else tfaults
        self.retry = jretry if jax else tretry
        self.stats = jstats if jax else tstats
        self.exc = jexc if jax else texc
        self.states = jstates if jax else tstates
        self.config = jconfig if jax else tconfig
        self.io = jio if jax else tio
        self.LogManager = JLogManager if jax else TLogManager
        self.DataManager = JDataManager if jax else TDataManager
        self.CreateAction = JCreateAction if jax else TCreateAction
        self.Dataset = JDataset if jax else TDataset
        self.QueryServer = JQueryServer if jax else TQueryServer
        self.clear = jio.clear_table_cache if jax else tdc.clear_all
        self.kw = {} if jax else {"device": "cpu"}

    def session(self, system_path, **kw):
        return self.pkg.HyperspaceSession(system_path=str(system_path), num_buckets=2, **self.kw, **kw)


PKG_NAMES = ("jax", "torch")
PKGS = {n: _Pkg(n) for n in PKG_NAMES}


@pytest.fixture(params=PKG_NAMES)
def P(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _clean_faults():
    """Every test starts and ends with both harnesses disarmed and a fast
    retry schedule (no real sleeping)."""
    for p in PKGS.values():
        p.faults.reset()
        p.retry.configure(max_attempts=3, backoff_base=0.0, sleeper=lambda s: None)
    yield
    for p in PKGS.values():
        p.faults.reset()
        p.faults.set_enabled(True)
        p.retry.configure(max_attempts=3, backoff_base=0.005, sleeper=time.sleep)


def _write_source(root: Path, n: int = 60) -> str:
    rng = np.random.default_rng(7)
    table = pa.table(
        {
            "id": pa.array(np.arange(n, dtype=np.int64)),
            "key": pa.array((np.arange(n, dtype=np.int64) * 13) % 10),
            "value": pa.array(rng.standard_normal(n)),
        }
    )
    root.mkdir(parents=True, exist_ok=True)
    pq.write_table(table.slice(0, n // 2), root / "part-0.parquet")
    pq.write_table(table.slice(n // 2), root / "part-1.parquet")
    return str(root)


def _expected(source: str) -> pd.DataFrame:
    import pyarrow.dataset as pads

    df = pads.dataset(source, format="parquet").to_table().to_pandas()
    return df[df["key"] == 7][["key", "value"]]


def _canon(df: pd.DataFrame) -> pd.DataFrame:
    cols = ["key", "value"]
    return df[cols].sort_values(cols).reset_index(drop=True)


def _query(session, source: str, P) -> pd.DataFrame:
    q = session.parquet(source).filter(P.pkg.col("key") == 7).select("key", "value")
    return _canon(session.to_pandas(q))


def _query_matches(session, source: str, P) -> pd.DataFrame:
    """The canonical correctness probe: a filter on the indexed column,
    row-identical to pandas over the raw source."""
    got = _query(session, source, P)
    pd.testing.assert_frame_equal(got, _canon(_expected(source)), check_dtype=False)
    return got


# ---------------------------------------------------------------------------
# The harness (tests/test_fault_injection.py TestFaultHarness)
# ---------------------------------------------------------------------------


def test_disabled_harness_is_inert(P):
    P.faults.fault_point("log.write", "/nope")


def test_unknown_point_rejected(P):
    with pytest.raises(ValueError, match="unknown fault point"):
        P.faults.inject("not.a.point")


def test_points_the_port_does_not_fire_are_not_known():
    """The port lists only the points it fires; each other point joins
    with the module that fires it."""
    assert set(tfaults.KNOWN_POINTS) < set(jfaults.KNOWN_POINTS)
    for point in set(jfaults.KNOWN_POINTS) - set(tfaults.KNOWN_POINTS):
        with pytest.raises(ValueError, match="unknown fault point"):
            tfaults.inject(point)


def test_default_rule_raises_transient_fault_error(P):
    with P.faults.injected("log.write"):
        with pytest.raises(P.faults.FaultError) as ei:
            P.faults.fault_point("log.write")
        assert P.exc.is_retryable(ei.value)


def test_fail_at_call_k(P):
    with P.faults.injected("bucket.read", at_call=3):
        P.faults.fault_point("bucket.read")
        P.faults.fault_point("bucket.read")
        with pytest.raises(P.faults.FaultError):
            P.faults.fault_point("bucket.read")
        P.faults.fault_point("bucket.read")


def test_fail_n_then_succeed(P):
    with P.faults.injected("bucket.read", times=2):
        for _ in range(2):
            with pytest.raises(P.faults.FaultError):
                P.faults.fault_point("bucket.read")
        P.faults.fault_point("bucket.read")


def test_truncate_schedule_mangles_file(P, tmp_path):
    p = tmp_path / "f"
    p.write_bytes(b"x" * 100)
    with P.faults.injected("bucket.written", truncate=10):
        P.faults.fault_point("bucket.written", p)
    assert p.stat().st_size == 10


def test_corrupt_schedule_overwrites_the_head(P, tmp_path):
    p = tmp_path / "f"
    p.write_bytes(b"x" * 20)
    with P.faults.injected("manifest.written", corrupt=b"GARBAGE"):
        P.faults.fault_point("manifest.written", p)
    assert p.read_bytes() == b"GARBAGE" + b"x" * 13


def test_kill_switch_disarms_registered_rules(P):
    P.faults.inject("log.write", crash=True)
    P.faults.set_enabled(False)
    try:
        P.faults.fault_point("log.write")
    finally:
        P.faults.set_enabled(True)
        P.faults.reset()


def test_kill_switch_through_the_config_key(P):
    conf = P.config.HyperspaceConf()
    P.faults.inject("log.write", crash=True)
    conf.set("hyperspace.faults.enabled", False)
    try:
        P.faults.fault_point("log.write")
    finally:
        conf.set("hyperspace.faults.enabled", True)
    with pytest.raises(P.faults.CrashPoint):
        P.faults.fault_point("log.write")


def test_crash_point_is_base_exception(P):
    assert not isinstance(P.faults.CrashPoint("p"), Exception)


def test_recording_observes_points(P):
    with P.faults.recording() as seen:
        P.faults.fault_point("log.write")
        P.faults.fault_point("manifest.read")
    assert {"log.write", "manifest.read"} <= seen


def test_export_install_round_trip_gives_fresh_schedules(P):
    P.faults.inject("bucket.read", at_call=1)
    with pytest.raises(P.faults.FaultError):
        P.faults.fault_point("bucket.read")
    state = P.faults.export_state()
    P.faults.reset()
    P.faults.install_state(state)
    with pytest.raises(P.faults.FaultError):  # call 1 again in the "worker"
        P.faults.fault_point("bucket.read")
    P.faults.fault_point("bucket.read")


# ---------------------------------------------------------------------------
# Brownout delays (TestBrownoutDelay)
# ---------------------------------------------------------------------------


def _virtual(P):
    slept = []
    P.faults.set_sleeper(slept.append)
    return slept


def test_pure_delay_slows_then_proceeds(P):
    slept = _virtual(P)
    delays0 = P.stats.get("faults.delays_injected")
    with P.faults.injected("bucket.read", delay_s=0.2):
        P.faults.fault_point("bucket.read")
    assert sum(slept) == pytest.approx(0.2)
    assert P.stats.get("faults.delays_injected") == delays0 + 1


def test_jitter_is_deterministic_per_call(P):
    def schedule():
        slept = _virtual(P)
        totals = []
        with P.faults.injected("bucket.read", delay_s=0.1, jitter_s=0.05):
            for _ in range(3):
                slept.clear()
                P.faults.fault_point("bucket.read")
                totals.append(round(sum(slept), 6))
        return totals

    first, second = schedule(), schedule()
    assert first == second
    assert len(set(first)) > 1
    for n, total in enumerate(first, start=1):
        assert total == pytest.approx(0.1 + 0.05 * ((n * 2654435761) % 1000) / 1000.0)


def test_delay_composes_before_error(P):
    slept = _virtual(P)
    with P.faults.injected("bucket.read", delay_s=0.3, error=P.faults.FaultError):
        with pytest.raises(P.faults.FaultError):
            P.faults.fault_point("bucket.read")
    assert sum(slept) == pytest.approx(0.3)


def test_kill_switch_disarms_a_delay_in_flight(P):
    slept = []

    def sleeper(s):
        slept.append(s)
        P.faults.set_enabled(False)

    P.faults.set_sleeper(sleeper)
    P.faults.inject("bucket.read", delay_s=10.0)
    try:
        P.faults.fault_point("bucket.read")
    finally:
        P.faults.set_enabled(True)
        P.faults.reset()
    assert sum(slept) <= 0.1


def test_delay_clamped_by_max_delay(P):
    slept = _virtual(P)
    P.config.HyperspaceConf().set("hyperspace.faults.maxDelaySeconds", 0.1)
    try:
        with P.faults.injected("bucket.read", delay_s=60.0, jitter_s=60.0):
            P.faults.fault_point("bucket.read")
    finally:
        P.faults.set_max_delay(30.0)
    assert sum(slept) == pytest.approx(0.1)


def test_deadline_carrying_path_times_out_typed_under_delay(P):
    """A brownout under a deadline-carrying path surfaces a typed
    QueryTimeout: delayed queries never hang their callers."""

    class _Session:
        conf = P.config.HyperspaceConf()
        _state_lock = threading.RLock()
        index_health = {}

    P.faults.inject("bucket.read", delay_s=0.5)
    server = P.QueryServer(_Session(), workers=1, max_queue_depth=8,
                           run_fn=lambda p: P.faults.fault_point("bucket.read"))
    try:
        slow = server.submit(object())
        queued = server.submit(object(), timeout=0.05)
        with pytest.raises(P.exc.QueryTimeout):
            queued.result(timeout=10.0)
        slow.result(timeout=10.0)
    finally:
        P.faults.reset()
        server.shutdown()


def test_a_crash_in_a_worker_does_not_wedge_drain(P):
    """A CrashPoint (a BaseException) raised inside a served query lands
    on its handle; the worker lives on and drain() returns."""

    class _Session:
        conf = P.config.HyperspaceConf()
        _state_lock = threading.RLock()
        index_health = {}

    P.faults.inject("bucket.read", crash=True, at_call=1)
    server = P.QueryServer(_Session(), workers=1, max_queue_depth=8,
                           run_fn=lambda p: P.faults.fault_point("bucket.read") or "ok")
    try:
        h = server.submit(object())
        with pytest.raises(P.faults.CrashPoint):
            h.result(timeout=10.0)
        assert server.submit(object()).result(timeout=10.0) == "ok"
        assert server.drain(timeout=10.0)
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# Retry / backoff (TestRetry)
# ---------------------------------------------------------------------------


def test_transient_errors_retry_then_succeed(P):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise P.faults.FaultError("transient")
        return "ok"

    assert P.retry.retry_call(flaky) == "ok"
    assert len(calls) == 3


def test_non_retryable_surfaces_immediately(P):
    calls = []

    def missing():
        calls.append(1)
        raise FileNotFoundError("gone")

    with pytest.raises(FileNotFoundError):
        P.retry.retry_call(missing)
    assert len(calls) == 1


def test_exhaustion_reraises_last_error(P):
    exhausted = P.stats.get("retry.exhausted")

    def always():
        raise P.faults.FaultError("still down")

    with pytest.raises(P.faults.FaultError):
        P.retry.retry_call(always, policy=P.retry.RetryPolicy(max_attempts=2))
    assert P.stats.get("retry.exhausted") == exhausted + 1


def test_a_crash_is_never_retried(P):
    calls = []

    def dies():
        calls.append(1)
        raise P.faults.CrashPoint("bucket.read")

    with pytest.raises(P.faults.CrashPoint):
        P.retry.retry_call(dies)
    assert len(calls) == 1


def test_backoff_schedule_is_deterministic(P):
    p = P.retry.RetryPolicy(backoff_base=0.01, backoff_multiplier=2.0, backoff_max=0.05)
    assert [p.delay(a) for a in range(4)] == [0.01, 0.02, 0.04, 0.05]


def test_sleeper_receives_backoff(P):
    slept = []
    P.retry.configure(sleeper=slept.append, backoff_base=0.01)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise P.faults.FaultError("x")

    P.retry.retry_call(flaky, policy=P.retry.RetryPolicy(backoff_base=0.01))
    assert slept == [0.01, 0.02]


def test_retry_keys_configure_the_policy(P):
    conf = P.config.HyperspaceConf()
    conf.set("hyperspace.retry.maxAttempts", 5)
    conf.set("hyperspace.retry.backoffBaseSeconds", 0.125)
    conf.set("hyperspace.retry.casAttempts", 4)
    try:
        assert P.retry.io_policy().max_attempts == 5
        assert P.retry.io_policy().backoff_base == 0.125
        assert P.retry.cas_attempts() == 4
    finally:
        P.retry.configure(max_attempts=3, backoff_base=0.0, cas_attempts=1)


def test_create_index_survives_transient_log_write_faults(P, tmp_path):
    """fail-2-then-succeed on the log entry CAS write: the retry layer
    absorbs it and the create commits normally."""
    source = _write_source(tmp_path / "src")
    session = P.session(tmp_path / "sys")
    hs = P.pkg.Hyperspace(session)
    before = P.stats.get("retry.attempts")
    P.faults.inject("file.atomic_write", times=2)
    hs.create_index(session.parquet(source), P.pkg.IndexConfig("ridx", ["key"], ["value"]))
    P.faults.reset()
    lm = P.LogManager(Path(tmp_path / "sys") / "ridx")
    assert lm.get_latest_log().state == P.states.ACTIVE
    assert P.stats.get("retry.attempts") - before >= 2


def test_transient_read_fault_is_retried_inside_a_multi_file_read(P, tmp_path):
    """A source of two files reads on a pool: a transient `bucket.read`
    fault is retried inside the worker, never a failed query."""
    source = _write_source(tmp_path / "src")
    session = P.session(tmp_path / "sys")
    before = P.stats.get("retry.attempts")
    P.clear()
    with P.faults.injected("bucket.read", times=2):
        got = _query(session, source, P)
    pd.testing.assert_frame_equal(got, _canon(_expected(source)), check_dtype=False)
    assert P.stats.get("retry.attempts") - before == 2


def test_transient_index_read_fault_is_retried_not_corruption(P, tmp_path):
    source, session, hs, _ = _make_index(tmp_path, P)
    session.enable_hyperspace()
    P.clear()
    before = P.stats.get("retry.attempts")
    fallbacks = P.stats.get("fallback.queries")
    with P.faults.injected("bucket.read", times=2):
        _query_matches(session, source, P)
    assert P.stats.get("retry.attempts") - before == 2
    assert P.stats.get("fallback.queries") == fallbacks and not session.index_health


# ---------------------------------------------------------------------------
# Typed corruption and manifest atomicity (TestCorruptionDetection)
# ---------------------------------------------------------------------------


def test_garbage_manifest_raises_typed_error(P, tmp_path):
    vdir = tmp_path / "idx" / "v__=0"
    vdir.mkdir(parents=True)
    (vdir / P.io.MANIFEST_NAME).write_text('{"numBuckets": 2, "bucketRo')
    before = P.stats.get("index.corruption")
    with pytest.raises(P.exc.IndexCorruptionError) as ei:
        P.io.read_manifest(vdir)
    assert ei.value.index_root == str(tmp_path / "idx")
    assert P.stats.get("index.corruption") == before + 1


def test_absent_manifest_is_none_not_error(P, tmp_path):
    vdir = tmp_path / "empty"
    vdir.mkdir()
    assert P.io.read_manifest(vdir) is None


def test_crash_during_manifest_write_never_tears_it(P, tmp_path):
    vdir = tmp_path / "v__=0"
    P.faults.inject("file.write_json", crash=True)
    with pytest.raises(P.faults.CrashPoint):
        P.io.write_manifest(vdir, 2, ["key"], [3, 4])
    P.faults.reset()
    assert P.io.read_manifest(vdir) is None
    assert not list(vdir.glob(".tmp-*")), "the temp file outlived the crash"


def test_torn_log_entry_still_resolves_stable(P, tmp_path):
    source = _write_source(tmp_path / "src")
    session = P.session(tmp_path / "sys")
    hs = P.pkg.Hyperspace(session)
    hs.create_index(session.parquet(source), P.pkg.IndexConfig("tidx", ["key"], ["value"]))
    index_path = Path(tmp_path / "sys") / "tidx"
    lm = P.LogManager(index_path)
    (index_path / P.config.HYPERSPACE_LOG_DIR / "2").write_text('{"id": 2, "state": "REFR')
    stable = lm.get_latest_stable_log()
    assert stable is not None and stable.state == P.states.ACTIVE
    report = hs.recover("tidx")
    assert report["quarantined_entries"] == 1
    assert lm.get_latest_id() == 1
    assert lm.get_latest_log().state == P.states.ACTIVE


# ---------------------------------------------------------------------------
# The corruption fallback (TestCorruptionFallback)
# ---------------------------------------------------------------------------


def _truncate_index(tmp_path, name: str, version: int = 0) -> None:
    vdir = Path(tmp_path / "sys") / name / f"v__={version}"
    for f in sorted(vdir.glob("bucket-*.parquet")):
        with open(f, "r+b") as fh:
            fh.truncate(7)


def test_truncated_bucket_degrades_to_source_scan(P, tmp_path):
    source = _write_source(tmp_path / "src")
    session = P.session(tmp_path / "sys")
    hs = P.pkg.Hyperspace(session)
    hs.create_index(session.parquet(source), P.pkg.IndexConfig("cidx", ["key"], ["value"]))
    session.enable_hyperspace()
    _query_matches(session, source, P)
    _truncate_index(tmp_path, "cidx")
    P.clear()
    before = P.stats.get("fallback.queries")
    _query_matches(session, source, P)
    assert P.stats.get("fallback.queries") > before
    root = str(Path(tmp_path / "sys") / "cidx")
    assert list(session.index_health) == [root]
    assert session.last_query_stats.get("degraded_indexes") == [root]
    _query_matches(session, source, P)  # sticky: planned past the broken index
    assert P.stats.get("fallback.queries") == before + 1


def test_fallback_disabled_surfaces_typed_error(P, tmp_path):
    source = _write_source(tmp_path / "src")
    session = P.session(tmp_path / "sys")
    hs = P.pkg.Hyperspace(session)
    hs.create_index(session.parquet(source), P.pkg.IndexConfig("cidx2", ["key"], ["value"]))
    session.enable_hyperspace()
    session.conf.set("hyperspace.fallback.enabled", False)
    _truncate_index(tmp_path, "cidx2")
    P.clear()
    q = session.parquet(source).filter(P.pkg.col("key") == 7).select("key", "value")
    with pytest.raises(P.exc.IndexCorruptionError):
        session.run(q)


def test_fallback_outcome_profile_events_and_lifting(tmp_path):
    """The port's outcome: replans 1 then 0, the profile's fallback dict,
    one `fallback.replan` and one `index.quarantined` event; a full
    refresh lifts the quarantine and the index serves again."""
    P = PKGS["torch"]
    source = _write_source(tmp_path / "src")
    session = P.session(tmp_path / "sys")
    hs = P.pkg.Hyperspace(session)
    hs.create_index(session.parquet(source), P.pkg.IndexConfig("cidx", ["key"], ["value"]))
    session.enable_hyperspace()
    q = session.parquet(source).filter(P.pkg.col("key") == 7).select("key", "value")
    _truncate_index(tmp_path, "cidx")
    P.clear()
    root = str(Path(tmp_path / "sys") / "cidx")
    seq0 = max([e["seq"] for e in tevents.recent()], default=0)

    def names():
        return [e["name"] for e in tevents.recent() if e["seq"] > seq0]

    first = session.run_query(q)
    assert first.replans == 1 and first.used_indexes is True
    assert first.profile.fallback == {"replans": 1, "degraded_indexes": [root], "used_indexes": True}
    assert names().count("fallback.replan") == 1 and names().count("index.quarantined") == 1
    second = session.run_query(q)
    assert second.replans == 0 and second.stats["degraded_indexes"] == [root]
    # Planned around the index: a scan of the source (its columns cached
    # by the first query's raw read), no index file read.
    ops = [n.op for n in second.physical_plan.walk()]
    assert "TableScan" in ops and "IndexPointLookup" not in ops
    assert names().count("index.quarantined") == 1 and names().count("fallback.replan") == 1
    hs.refresh_index("cidx")
    assert not session.index_health
    third = session.run_query(q)
    assert third.replans == 0 and "degraded_indexes" not in third.stats
    assert third.stats["scan"] == "IndexPointLookup"
    got = _canon(pd.DataFrame(third.result.decode()))
    pd.testing.assert_frame_equal(got, _canon(_expected(source)), check_dtype=False)


@pytest.mark.parametrize("lift", ["optimize", "recover", "recover_all"])
def test_optimize_and_recover_lift_the_quarantine(P, tmp_path, lift):
    source = _write_source(tmp_path / "src")
    session = P.session(tmp_path / "sys")
    hs = P.pkg.Hyperspace(session)
    hs.create_index(session.parquet(source), P.pkg.IndexConfig("cidx", ["key"], ["value"]))
    session.enable_hyperspace()
    _truncate_index(tmp_path, "cidx")
    P.clear()
    _query_matches(session, source, P)
    assert session.index_health
    if lift == "optimize":
        hs.refresh_index("cidx")  # rewrite readable data first, then compact it
        session.index_health[str(Path(tmp_path / "sys") / "cidx")] = {"reason": "test", "path": None}
        hs.optimize_index("cidx")
    elif lift == "recover":
        hs.recover("cidx")
    else:
        hs.recover()
    assert not session.index_health


# ---------------------------------------------------------------------------
# The fallback through a join, the plan and result caches (the port's)
# ---------------------------------------------------------------------------


def _join_tables(tmp_path):
    rng = np.random.default_rng(11)
    (tmp_path / "f").mkdir(parents=True)
    (tmp_path / "d").mkdir(parents=True)
    pq.write_table(pa.table({"k": rng.integers(0, 50, 400).astype(np.int64), "x": rng.random(400)}),
                   tmp_path / "f" / "a.parquet")
    pq.write_table(pa.table({"dk": np.arange(50, dtype=np.int64), "y": rng.random(50)}),
                   tmp_path / "d" / "a.parquet")


def _join_rows(result) -> list:
    d = result.decode()
    return sorted(zip(*(np.asarray(d[c]).tolist() for c in ("k", "x", "y"))))


def _join_setup(tmp_path, P):
    _join_tables(tmp_path)
    session = P.session(tmp_path / "sys")
    hs = P.pkg.Hyperspace(session)
    f, d = session.parquet(tmp_path / "f"), session.parquet(tmp_path / "d")
    hs.create_index(f, P.pkg.IndexConfig("f_k", ["k"], ["x"]))
    hs.create_index(d, P.pkg.IndexConfig("d_k", ["dk"], ["y"]))
    session.enable_hyperspace()
    q = f.join(d, ["k"], ["dk"]).select("k", "x", "y")
    return session, hs, q


def test_join_fallback_keeps_the_healthy_index(tmp_path):
    """One corrupt side of an indexed join: the port's first re-plan keeps
    the healthy index, and the answer equals the JAX package's on the
    healthy data. The JAX package reads an aligned join side without its
    corruption wrap (`exec_side.py::_side_data`), so there the truncated
    side fails the query with pyarrow's own error and never falls back: a
    fault of the reference (ROADMAP.md queue 3)."""
    import pyarrow.lib

    rows = {}
    for name in PKG_NAMES:
        P = PKGS[name]
        tmp = tmp_path / name
        session, hs, q = _join_setup(tmp, P)
        rows[name] = _join_rows(session.run(q))
        _truncate_index(tmp, "d_k")
        P.clear()
        if name == "jax":
            with pytest.raises(pyarrow.lib.ArrowInvalid):
                session.run_query(q)
            continue
        outcome = session.run_query(q)
        assert outcome.replans == 1 and outcome.used_indexes is True
        assert list(session.index_health) == [str(Path(tmp / "sys") / "d_k")]
        roots = {lf.root for lf in session.optimized_plan(q).leaves()}
        assert str(Path(tmp / "sys") / "f_k") in roots and str(tmp / "d") in roots
        assert _join_rows(outcome.result) == rows[name]
    assert rows["torch"] == rows["jax"]


def test_two_corrupt_sides_replan_twice_then_answer(tmp_path):
    P = PKGS["torch"]
    session, hs, q = _join_setup(tmp_path, P)
    want = _join_rows(session.run(q))
    _truncate_index(tmp_path, "d_k")
    _truncate_index(tmp_path, "f_k")
    P.clear()
    outcome = session.run_query(q)
    assert outcome.replans == 2 and outcome.used_indexes is True
    assert len(session.index_health) == 2
    assert _join_rows(outcome.result) == want


def test_a_failure_without_provenance_turns_indexes_off(tmp_path, monkeypatch):
    P = PKGS["torch"]
    source, session, hs, _ = _make_index(tmp_path, P)
    session.enable_hyperspace()
    from hyperspace_tpu_torch.execution.executor import Executor

    real = Executor.execute
    calls = []

    def failing(self, plan):
        calls.append(1)
        if len(calls) == 1:
            raise P.exc.IndexCorruptionError("unreadable, no provenance")
        return real(self, plan)

    monkeypatch.setattr(Executor, "execute", failing)
    q = session.parquet(source).filter(P.pkg.col("key") == 7).select("key", "value")
    outcome = session.run_query(q)
    assert outcome.replans == 1 and outcome.used_indexes is False and not session.index_health
    got = _canon(pd.DataFrame(outcome.result.decode()))
    pd.testing.assert_frame_equal(got, _canon(_expected(source)), check_dtype=False)


def test_plan_cache_key_moves_with_the_quarantine(tmp_path):
    P = PKGS["torch"]
    source, session, hs, _ = _make_index(tmp_path, P)
    session.enable_hyperspace()
    q = session.parquet(source).filter(P.pkg.col("key") == 7).select("key", "value")
    cache = P.pkg.PlanCache()
    from hyperspace_tpu_torch.serve.plan_cache import versioned_plan_key

    k0 = versioned_plan_key(session, q)
    assert session.run_query(q, plan_cache=cache).replans == 0
    _truncate_index(tmp_path, "idx1")
    P.clear()
    outcome = session.run_query(q, plan_cache=cache)  # the cached plan fails, the new key misses
    assert outcome.replans == 1
    k1 = versioned_plan_key(session, q)
    assert k1[:4] == k0[:4] and k1[4] == (str(Path(tmp_path / "sys") / "idx1"),) and k0[4] == ()
    stats = cache.stats()
    assert (stats["hits"], stats["misses"]) == (1, 2)
    assert session.run_query(q, plan_cache=cache).replans == 0
    assert cache.stats()["hits"] == 2


def test_result_cache_skips_a_replanned_result(tmp_path):
    P = PKGS["torch"]
    source, session, hs, _ = _make_index(tmp_path, P)
    session.enable_hyperspace()
    q = session.parquet(source).filter(P.pkg.col("key") == 7).select("key", "value")
    _truncate_index(tmp_path, "idx1")
    P.clear()
    with session.serve(result_cache=True, workers=1) as server:
        first = server.submit(q)
        pd.testing.assert_frame_equal(_canon(pd.DataFrame(first.result(timeout=60).decode())),
                                      _canon(_expected(source)), check_dtype=False)
        assert first.profile.fallback["replans"] == 1
        assert server.result_cache.stats()["entries"] == 0
        second = server.submit(q)
        second.result(timeout=60)
        assert not second.cache_hit and second.profile.fallback["replans"] == 0
        assert server.result_cache.stats()["entries"] == 1
        third = server.submit(q)
        third.result(timeout=60)
        assert third.cache_hit


# ---------------------------------------------------------------------------
# In-process rollback (TestOpFailureRollback) and the CAS retry
# ---------------------------------------------------------------------------


def test_failed_build_rolls_back_and_quarantines(P, tmp_path):
    source = _write_source(tmp_path / "src")
    conf = P.config.HyperspaceConf(system_path=str(tmp_path / "sys"), num_buckets=2)
    index_path = Path(tmp_path / "sys") / "bidx"
    lm, dm = P.LogManager(index_path), P.DataManager(index_path)

    class PartialWriter:
        def write(self, plan, columns, indexed_columns, num_buckets, dest_path):
            Path(dest_path).mkdir(parents=True, exist_ok=True)
            (Path(dest_path) / "bucket-00000.parquet").write_bytes(b"partial")
            raise ValueError("builder blew up mid-carve")

    plan = P.Dataset.parquet(source).scan()
    cfg = P.pkg.IndexConfig("bidx", ["key"], ["value"])
    rolled = P.stats.get("action.rolled_back")
    with pytest.raises(ValueError, match="mid-carve"):
        P.CreateAction(plan, cfg, lm, dm, index_path, conf, PartialWriter()).run()
    assert lm.get_latest_log().state == P.states.DOESNOTEXIST
    assert lm.get_latest_stable_log().state == P.states.DOESNOTEXIST
    assert dm.get_version_ids() == []
    assert list(index_path.glob(".quarantine-*")), "partial dir not quarantined"
    assert P.stats.get("action.rolled_back") == rolled + 1


def test_a_crash_mid_op_is_not_rolled_back(P, tmp_path):
    """A CrashPoint skips the in-process rollback: the transient entry
    stays for recover()."""
    source = _write_source(tmp_path / "src")
    session = P.session(tmp_path / "sys")
    hs = P.pkg.Hyperspace(session)
    P.faults.inject("bucket.write", crash=True, at_call=1)
    with pytest.raises(P.faults.CrashPoint):
        hs.create_index(session.parquet(source), P.pkg.IndexConfig("idx1", ["key"], ["value"]))
    P.faults.reset()
    lm = P.LogManager(Path(tmp_path / "sys") / "idx1")
    assert lm.get_latest_id() == 0 and lm.get_latest_log().state == P.states.CREATING


class _ContendedLogManager:
    """An in-memory log whose first CAS of id 0 loses to a concurrent
    writer, whose ACTIVE entry then stands at id 0."""

    def __init__(self, P):
        self.P = P
        self.logs = {}
        self.calls = []
        self.stable_id = None

    def get_latest_id(self):
        return max(self.logs) if self.logs else None

    def get_latest_log(self):
        return self.logs.get(self.get_latest_id())

    def get_latest_stable_log(self):
        return None if self.stable_id is None else self.logs[self.stable_id]

    def write_log(self, id, entry):
        self.calls.append(("write_log", id, entry.state))
        if id == 0 and 0 not in self.logs:
            self.logs[0] = entry.with_state(self.P.states.ACTIVE)
            self.stable_id = 0
            return False
        if id in self.logs:
            return False
        self.logs[id] = entry
        return True

    def create_latest_stable_log(self, id):
        self.stable_id = id
        return True


def test_cas_contention_retry_rereads_log_and_commits(P):
    from hyperspace_tpu.actions.base import Action as JAction
    from hyperspace_tpu.metadata.log_entry import Content as JContent
    from hyperspace_tpu.metadata.log_entry import IndexLogEntry as JEntry
    from hyperspace_tpu_torch.actions.base import Action as TAction
    from hyperspace_tpu_torch.metadata.log_entry import Content as TContent
    from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry as TEntry

    Action, Entry, Content = (JAction, JEntry, JContent) if P.name == "jax" else (TAction, TEntry, TContent)
    states = P.states

    class NoopAction(Action):
        transient_state = states.CREATING
        final_state = states.ACTIVE

        def build_log_entry(self):
            e = Entry(name="idx", derived_dataset=None, content=Content(root="/idx", directories=[]), source=None)
            e.state = states.ACTIVE
            return e

    lm = _ContendedLogManager(P)
    P.config.HyperspaceConf().set("hyperspace.retry.casAttempts", 2)
    try:
        NoopAction(lm).run()
    finally:
        P.retry.configure(cas_attempts=1)
    assert [c for c in lm.calls if c[0] == "write_log"] == [
        ("write_log", 0, states.CREATING),
        ("write_log", 1, states.CREATING),
        ("write_log", 2, states.ACTIVE),
    ]
    assert lm.stable_id == 2
    with pytest.raises(P.exc.HyperspaceError, match="Could not acquire proper state"):
        NoopAction(_ContendedLogManager(P)).run()  # casAttempts 1: the loser aborts


# ---------------------------------------------------------------------------
# recover(): explicit and lazy (TestRecover)
# ---------------------------------------------------------------------------


def _make_index(tmp_path, P, name="idx1"):
    source = _write_source(tmp_path / "src")
    session = P.session(tmp_path / "sys")
    hs = P.pkg.Hyperspace(session)
    hs.create_index(session.parquet(source), P.pkg.IndexConfig(name, ["key"], ["value"]))
    return source, session, hs, Path(tmp_path / "sys") / name


def test_recover_rolls_crashed_refresh_and_gcs_orphan(P, tmp_path):
    source, session, hs, index_path = _make_index(tmp_path, P)
    lm, dm = P.LogManager(index_path), P.DataManager(index_path)
    dead = lm.get_latest_log().with_state(P.states.REFRESHING)
    assert lm.write_log(2, dead)
    orphan = index_path / f"{P.config.DATA_VERSION_PREFIX}1"
    orphan.mkdir()
    (orphan / "bucket-00000.parquet").write_bytes(b"junk")
    report = hs.recover("idx1")
    assert report["rolled"] and report["orphans_removed"] == 1
    latest = lm.get_latest_log()
    assert latest.state == P.states.ACTIVE
    assert dm.get_version_ids() == [0]
    assert lm.get_latest_stable_log().id == latest.id
    again = hs.recover("idx1")
    assert not again["rolled"] and again["orphans_removed"] == 0
    session.enable_hyperspace()
    _query_matches(session, source, P)


def test_lazy_recover_on_first_access(P, tmp_path):
    source, session, hs, index_path = _make_index(tmp_path, P, "lazy1")
    lm = P.LogManager(index_path)
    assert lm.write_log(2, lm.get_latest_log().with_state(P.states.REFRESHING))
    s2 = P.session(tmp_path / "sys")
    s2.conf.set(P.config.RECOVER_GRACE_SECONDS, 0)
    assert [e.state for e in s2.manager.get_indexes()] == [P.states.ACTIVE]
    assert lm.get_latest_log().state == P.states.ACTIVE


def test_lazy_recover_respects_grace_for_live_writers(P, tmp_path):
    source, session, hs, index_path = _make_index(tmp_path, P, "lazy2")
    lm = P.LogManager(index_path)
    assert lm.write_log(2, lm.get_latest_log().with_state(P.states.REFRESHING))
    P.session(tmp_path / "sys").manager.get_indexes()
    assert lm.get_latest_log().state == P.states.REFRESHING


def test_cache_expiry_key_sets_the_listing_ttl(P, tmp_path):
    session = P.session(tmp_path / "sys")
    session.conf.set("hyperspace.index.cache.expiryDurationInSeconds", 12.5)
    assert session.conf.get("hyperspace.index.cache.expiryDurationInSeconds") == 12.5
    assert session.manager._cache.expiry_seconds == 12.5


# ---------------------------------------------------------------------------
# The crash sweep (tests/test_fault_injection.py:591-640) in the port
# ---------------------------------------------------------------------------

ACTIONS = ("create", "refresh", "optimize", "vacuum")


def _setup(tmp_path, action, P):
    source = _write_source(tmp_path / "src")
    session = P.session(tmp_path / "sys")
    hs = P.pkg.Hyperspace(session)
    if action != "create":
        hs.create_index(session.parquet(source), P.pkg.IndexConfig("idx1", ["key"], ["value"]))
    if action == "vacuum":
        hs.delete_index("idx1")
    return source, session, hs


def _drive(hs, session, source, action, P):
    if action == "create":
        hs.create_index(session.parquet(source), P.pkg.IndexConfig("idx1", ["key"], ["value"]))
    elif action == "refresh":
        hs.refresh_index("idx1")
    elif action == "optimize":
        hs.optimize_index("idx1")
    elif action == "vacuum":
        hs.vacuum_index("idx1")


def _assert_crash_consistent(tmp_path, source, action, point, P, want: pd.DataFrame) -> dict:
    """Post-crash invariants, recovery convergence, and the answer equal
    to `want` (the JAX package's). Returns the first recover's report."""
    ctx = f"{P.name} action={action} point={point}"
    index_path = Path(tmp_path / "sys") / "idx1"
    lm, dm = P.LogManager(index_path), P.DataManager(index_path)
    lm.get_latest_stable_log()
    s2 = P.session(tmp_path / "sys")
    hs2 = P.pkg.Hyperspace(s2)
    report = hs2.recover("idx1")
    latest = lm.get_latest_log()
    if latest is not None:
        assert latest.state in P.states.STABLE_STATES, ctx
        stable = lm.get_latest_stable_log()
        assert stable is not None and stable.id == latest.id, ctx
        referenced = (
            set(stable.content.directories)
            if stable.state != P.states.DOESNOTEXIST and stable.content is not None
            else set()
        )
        on_disk = {f"{P.config.DATA_VERSION_PREFIX}{v}" for v in dm.get_version_ids()}
        assert on_disk <= referenced, f"{ctx}: orphan version dirs {on_disk - referenced}"
    again = hs2.recover("idx1")
    assert not again["rolled"] and again["orphans_removed"] == 0, ctx
    s2.enable_hyperspace()
    got = _query_matches(s2, source, P)
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    return report


@pytest.fixture(scope="module")
def jax_answer(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_answer")
    source = _write_source(tmp / "src")
    return _query(PKGS["jax"].session(tmp / "sys"), source, PKGS["jax"])


@pytest.fixture(scope="module")
def jax_points(tmp_path_factory):
    """The points each action fires in the JAX package."""
    P = PKGS["jax"]
    out = {}
    for action in ACTIONS:
        tmp = tmp_path_factory.mktemp(f"jdisc-{action}")
        source, session, hs = _setup(tmp, action, P)
        with P.faults.recording() as seen:
            _drive(hs, session, source, action, P)
        out[action] = seen
    return out


@pytest.mark.parametrize("action", ACTIONS)
def test_crash_sweep_every_fault_point(tmp_path_factory, action, jax_answer, jax_points):
    P = PKGS["torch"]
    base = tmp_path_factory.mktemp(f"disc-{action}")
    source, session, hs = _setup(base, action, P)
    with P.faults.recording() as seen:
        _drive(hs, session, source, action, P)
    points = sorted(seen)
    assert set(points) == jax_points[action]
    crashed_at = []
    for point in points:
        tmp = tmp_path_factory.mktemp(f"sweep-{action}")
        source, session, hs = _setup(tmp, action, P)
        P.faults.inject(point, crash=True, at_call=1)
        try:
            _drive(hs, session, source, action, P)
        except P.faults.CrashPoint:
            crashed_at.append(point)
        finally:
            P.faults.reset()
        _assert_crash_consistent(tmp, source, action, point, P, jax_answer)
    assert crashed_at == points, f"no crash fired at {set(points) - set(crashed_at)}"


@pytest.mark.parametrize("point, k", [("log.write", 2), ("bucket.written", 2), ("file.write_json", 2)])
def test_crash_sweep_mid_schedule_calls(tmp_path, point, k, jax_answer):
    P = PKGS["torch"]
    source, session, hs = _setup(tmp_path, "create", P)
    P.faults.inject(point, crash=True, at_call=k)
    with pytest.raises(P.faults.CrashPoint):
        _drive(hs, session, source, "create", P)
    P.faults.reset()
    _assert_crash_consistent(tmp_path, source, "create", f"{point}@{k}", P, jax_answer)


# ---------------------------------------------------------------------------
# Interchange: a crash left by one package, recovered by the other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point", ["log.written", "bucket.written"])
@pytest.mark.parametrize("crasher", PKG_NAMES)
def test_a_crash_left_by_one_package_is_recovered_by_the_other(tmp_path, crasher, point, jax_answer):
    """The crashing package writes a crashed create (and, for the crash at
    `bucket.written`, a partial version dir); a copy of its system path
    is recovered by each package: equal reports, equal logs, equal
    answers through either package afterwards."""
    other = "torch" if crasher == "jax" else "jax"
    C = PKGS[crasher]
    source, session, hs = _setup(tmp_path / "run", "create", C)
    C.faults.inject(point, crash=True, at_call=1)
    with pytest.raises(C.faults.CrashPoint):
        _drive(hs, session, source, "create", C)
    C.faults.reset()
    sys_dir = tmp_path / "run" / "sys"
    reports, logs = {}, {}
    for name in PKG_NAMES:
        R = PKGS[name]
        copy = tmp_path / f"recovered_by_{name}"
        shutil.copytree(sys_dir, copy)
        reports[name] = R.pkg.Hyperspace(R.session(copy)).recover("idx1")
        lm = R.LogManager(copy / "idx1")
        logs[name] = [(e.id, e.state) for e in (lm.get_log(i) for i in range(lm.get_latest_id() + 1)) if e]
        assert R.pkg.Hyperspace(R.session(copy)).recover("idx1") == {"rolled": False, "quarantined_entries": 0,
                                                                      "orphans_removed": 0}
    assert reports[other] == reports[crasher] and reports[crasher]["rolled"]
    assert logs[other] == logs[crasher]
    for name in PKG_NAMES:
        for reader in PKG_NAMES:
            R = PKGS[reader]
            s = R.session(tmp_path / f"recovered_by_{name}")
            s.enable_hyperspace()
            pd.testing.assert_frame_equal(_query_matches(s, source, R), jax_answer, check_dtype=False)
        # A create after the recovery commits and serves, in the package
        # that did not recover this copy.
        R = PKGS[other if name == crasher else crasher]
        s = R.session(tmp_path / f"recovered_by_{name}")
        R.pkg.Hyperspace(s).create_index(s.parquet(source), R.pkg.IndexConfig("idx1", ["key"], ["value"]))
        s.enable_hyperspace()
        pd.testing.assert_frame_equal(_query_matches(s, source, R), jax_answer, check_dtype=False)
        assert "IndexPointLookup" in [n.op for n in s.last_physical_plan.walk()]
