"""The port's durable telemetry journal (obs/journal.py) on the CPU.

tests/test_journal.py's cases through the port: seal, rotation, the byte
budget's eviction, the advisory IO contract, the event / span / SLO taps,
the reader's tolerance and a real ``kill -9`` mid-rotation whose torn
tail `sweep()` removes. Held against the JAX package: segments the port
wrote read back through `hyperspace_tpu.obs.journal.merge_dir` with the
same records, and the reverse; and the journal's state ships into a
spawned `procpool` worker, which journals under its own pid.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from hyperspace_tpu.obs import journal as jax_journal

from hyperspace_tpu_torch import faults, stats
from hyperspace_tpu_torch.faults import CrashPoint
from hyperspace_tpu_torch.obs import events, journal, metrics, slo, trace


@pytest.fixture(autouse=True)
def _port_obs_reset():
    """The port's process-global observability state, zeroed around each
    test (tests/conftest.py resets the JAX package's)."""
    stats.reset()
    metrics.REGISTRY.reset()
    trace.reset()
    trace.set_enabled(True)
    events.reset()
    slo.reset()
    journal.reset()
    faults.reset()
    yield
    journal.reset()
    faults.reset()
    slo.reset()
    trace.reset()


def _enable(tmp_path, **kw):
    # Big enough that only an explicit seal() publishes (the first record
    # also carries a full-registry metrics snapshot).
    kw.setdefault("segment_bytes", 1 << 20)
    journal.configure(enabled=True, root=str(tmp_path / "_obs"), **kw)
    return tmp_path / "_obs"


def _my_dir(root):
    return root / str(os.getpid())


def _fill(n: int, name: str = "fill") -> None:
    for i in range(n):
        journal.record("event", event={"name": name, "seq": i, "pad": "p" * 64})


def test_record_seal_merge_roundtrip(tmp_path):
    root = _enable(tmp_path)
    journal.record("event", event={"name": "x", "seq": 1})
    journal.record("span", trace={"name": "query", "trace_id": "1-1"})
    assert journal.segment_paths(_my_dir(root)) == []  # nothing until sealed
    journal.seal()
    (seg,) = journal.segment_paths(_my_dir(root))
    kinds = [r["kind"] for r in journal.read_segment(seg)]
    assert "event" in kinds and "span" in kinds
    merged = journal.merge_dir(root)
    assert all(r["pid"] == os.getpid() for r in merged)
    assert [r.get("ts") for r in merged] == sorted(r.get("ts") for r in merged)
    assert stats.get("obs.journal.records") >= 2
    assert stats.get("obs.journal.segments_sealed") == 1


def test_segment_rotation_is_atomic_and_ordered(tmp_path):
    root = _enable(tmp_path, segment_bytes=1024)
    _fill(200)
    journal.seal()
    segs = journal.segment_paths(_my_dir(root))
    assert len(segs) >= 2
    numbers = [int(p.name[len("segment-"):-len(".jsonl")]) for p in segs]
    assert numbers == sorted(numbers)
    for seg in segs:
        with open(seg, encoding="utf-8") as f:
            for line in f:
                json.loads(line)
    seqs = [r["event"]["seq"] for r in journal.merge_dir(root) if r["kind"] == "event"]
    assert seqs == sorted(seqs)


def test_eviction_holds_byte_budget_keeping_newest(tmp_path):
    root = _enable(tmp_path, segment_bytes=1024, max_bytes=4096)
    _fill(400)
    journal.seal()
    segs = journal.segment_paths(_my_dir(root))
    assert stats.get("obs.journal.evictions") > 0
    assert sum(p.stat().st_size for p in segs) <= 4096 + 2048
    seqs = [r["event"]["seq"] for r in journal.merge_dir(root) if r["kind"] == "event"]
    assert 399 in seqs and 0 not in seqs


def test_metrics_snapshots_ride_the_write_path(tmp_path):
    root = _enable(tmp_path, snapshot_s=0.1)
    metrics.counter("serve.completed").inc(7)
    journal.record("event", event={"name": "tick", "seq": 1})
    journal.seal()
    snaps = [r for r in journal.merge_dir(root) if r["kind"] == "metrics"]
    assert snaps and snaps[0]["metrics"]["serve.completed"] == 7


def test_disabled_journal_is_a_noop(tmp_path):
    journal.configure(enabled=False, root=str(tmp_path / "_obs"))
    journal.record("event", event={"name": "x"})
    journal.seal()
    assert not (tmp_path / "_obs").exists()
    assert stats.get("obs.journal.records") == 0


def test_io_failures_are_advisory_counted_not_raised(tmp_path):
    blocker = tmp_path / "blocked"
    blocker.write_text("not a directory")
    journal.configure(enabled=True, root=str(blocker))
    journal.record("event", event={"name": "x"})
    assert stats.get("obs.journal.errors") >= 1
    assert stats.get("obs.journal.records") == 0


def test_seal_fault_point_fires_after_the_publish(tmp_path):
    """`journal.seal` fires between the publish and the eviction: a crash
    there leaves the sealed segment whole, and the next seal's eviction
    still holds the budget."""
    root = _enable(tmp_path, segment_bytes=1 << 20, max_bytes=4096)
    _fill(60)
    with faults.injected("journal.seal", crash=True):
        with pytest.raises(CrashPoint):
            journal.seal()
    (seg,) = journal.segment_paths(_my_dir(root))
    assert len(journal.read_segment(seg)) >= 60
    journal.reset()
    _enable(tmp_path, segment_bytes=1024, max_bytes=4096)
    _fill(100, name="after")
    journal.seal()
    assert sum(p.stat().st_size for p in journal.segment_paths(_my_dir(root))) <= 4096 + 2048


def test_config_keys_route_to_the_process_global_journal(tmp_path):
    from hyperspace_tpu_torch import HyperspaceSession

    session = HyperspaceSession(system_path=str(tmp_path / "indexes"), device="cpu")
    session.conf.set("hyperspace.obs.journal.enabled", True)
    assert journal.enabled() and journal.root() == str(tmp_path / "indexes" / "_obs")
    session.conf.set("hyperspace.obs.journal.segmentBytes", 2048)
    session.conf.set("hyperspace.obs.journal.maxBytes", 8192)
    session.conf.set("hyperspace.obs.journal.snapshotSeconds", 2.5)
    assert (session.conf.get("hyperspace.obs.journal.segmentBytes"),
            session.conf.get("hyperspace.obs.journal.maxBytes"),
            session.conf.get("hyperspace.obs.journal.snapshotSeconds")) == (2048, 8192, 2.5)


def test_event_span_and_slo_taps_feed_the_journal(tmp_path):
    root = _enable(tmp_path)
    events.declare("index.quarantined").emit(index="x")
    with trace.trace("q"):
        pass
    completed = metrics.counter("serve.completed")
    failed = metrics.counter("serve.failed")
    metrics.counter("serve.timeouts")
    metrics.counter("serve.cancelled")
    metrics.histogram("serve.latency.seconds")
    completed.inc(10_000)
    for t in (0.0, 4000.0):
        slo.sample(t)
        slo.evaluate(t)
    failed.inc(3_000)
    slo.sample(4030.0)
    slo.evaluate(4030.0)
    journal.seal()
    merged = journal.merge_dir(root)
    assert "index.quarantined" in [r["event"]["name"] for r in merged if r["kind"] == "event"]
    assert "q" in [r["trace"]["name"] for r in merged if r["kind"] == "span"]
    transitions = [(r["objective"], r["previous"], r["verdict"]) for r in merged if r["kind"] == "slo"]
    assert ("serve.availability", "ok", "page") in transitions


def test_adopted_worker_roots_are_journaled(tmp_path):
    root = _enable(tmp_path)
    trace.adopt_root({"name": "build.worker", "trace_id": "4242-1", "wall_s": 0.5, "children": []})
    journal.seal()
    assert [r["trace"]["trace_id"] for r in journal.merge_dir(root) if r["kind"] == "span"] == ["4242-1"]


def test_worker_state_shipping_roundtrip(tmp_path):
    _enable(tmp_path, segment_bytes=2048)
    state = journal.export_state()
    assert state["enabled"] and state["parent_pid"] == os.getpid()
    assert set(state) == set(jax_journal.export_state())
    journal.install_state(dict(state, worker_id=3))
    journal.seal()
    procs = [r for r in journal.merge_dir(journal.root()) if r["kind"] == "process"]
    assert procs and procs[-1]["worker_id"] == 3 and procs[-1]["parent_pid"] == os.getpid()


def test_merge_skips_torn_and_alien_lines(tmp_path):
    root = _enable(tmp_path)
    journal.record("event", event={"name": "good", "seq": 1})
    journal.seal()
    (seg,) = journal.segment_paths(_my_dir(root))
    with open(seg, "a", encoding="utf-8") as f:
        f.write('{"torn": tr')
    (root / "notes.txt").write_text("not a pid dir")
    docs = journal.read_segment(seg)
    assert [d["event"]["seq"] for d in docs if d.get("kind") == "event"] == [1]
    assert journal.merge_dir(root)


def test_sweep_removes_torn_tmp_but_not_the_live_tail(tmp_path):
    root = _enable(tmp_path)
    dead = root / "99999"
    dead.mkdir(parents=True)
    torn = dead / ".tmp-seg-abc"
    torn.write_text('{"ts": 1.0, "kind": "event"')
    journal.record("event", event={"name": "live", "seq": 1})
    live_tmp = [p for p in _my_dir(root).iterdir() if p.name.startswith(".tmp-seg-")]
    assert live_tmp
    removed = journal.sweep(root)
    assert str(torn) in removed and not torn.exists()
    assert all(p.exists() for p in live_tmp)


_CHILD = r"""
import sys
from hyperspace_tpu_torch.obs import journal
journal.configure(enabled=True, root=sys.argv[1], segment_bytes=1024)
i = 0
while True:  # journals until killed
    journal.record("event", event={"name": "child", "seq": i, "pad": "p" * 64})
    i += 1
"""


def test_sigkill_mid_rotation_leaves_mergeable_segments(tmp_path):
    """A journaling child killed mid-segment leaves sealed segments that
    merge in order with no gap (through both packages' readers) and a torn
    tail that only `sweep()` sees."""
    root = tmp_path / "_obs"
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, str(root)], stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        child_dir = root / str(proc.pid)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            sealed = journal.segment_paths(child_dir)
            tmps = [p for p in child_dir.iterdir() if p.name.startswith(".tmp-seg-")] if child_dir.is_dir() else []
            if len(sealed) >= 2 and tmps:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("child never sealed two segments")
    finally:
        proc.kill()
        proc.wait(timeout=30.0)
    assert proc.returncode == -signal.SIGKILL
    merged = journal.merge_dir(root)
    seqs = [r["event"]["seq"] for r in merged if r["kind"] == "event"]
    assert seqs == list(range(len(seqs))) and len(seqs) > 0
    assert jax_journal.merge_dir(root) == merged
    assert [p for p in (root / str(proc.pid)).iterdir() if p.name.startswith(".tmp-seg-")]
    journal.sweep(root)
    assert not [p for p in (root / str(proc.pid)).iterdir() if p.name.startswith(".tmp-seg-")]
    assert journal.merge_dir(root) == merged


# -- interchange with the JAX package ---------------------------------------


def _write_records(mod, root) -> None:
    mod.configure(enabled=True, root=str(root), segment_bytes=1024, snapshot_s=3600.0)
    mod.record("event", event={"name": "index.quarantined", "seq": 1, "severity": "warn"})
    mod.record_span({"name": "query", "trace_id": "7-1", "wall_s": 0.25, "children": []})
    mod.record_slo("serve.availability", "page", "ok", detail={"windows": {"60s": 20.0}})
    for i in range(40):
        mod.record("event", event={"name": "fill", "seq": i, "pad": "p" * 48})
    mod.record_process(worker_id=2, parent_pid=1)
    mod.seal()


def _strip_metrics(records):
    # The first record of each process carries a snapshot of its own
    # package's registry, whose counters differ; every other record is
    # compared whole.
    return [r for r in records if r["kind"] != "metrics"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segments_read_back_through_the_other_package(tmp_path, writer):
    root = tmp_path / "_obs"
    mod, other = (journal, jax_journal) if writer == "port" else (jax_journal, journal)
    _write_records(mod, root)
    mod.reset()
    segs = other.segment_paths(root / str(os.getpid()))
    assert len(segs) >= 2  # rotated at 1 KiB
    theirs = other.merge_dir(root)
    ours = mod.merge_dir(root)
    assert theirs == ours
    body = _strip_metrics(theirs)
    assert [r["kind"] for r in body][:3] == ["event", "span", "slo"]
    assert body[-1] == {**body[-1], "kind": "process", "worker_id": 2, "parent_pid": 1}
    assert [r["trace"] for r in body if r["kind"] == "span"] == [
        {"name": "query", "trace_id": "7-1", "wall_s": 0.25, "children": []}]
    assert other.spans_from_journal(root) == mod.spans_from_journal(root)


def test_both_packages_write_identical_segments(tmp_path):
    """The same records through both writers give segment files of the
    same names and the same lines, but for the wall-clock `ts` and the
    metrics snapshot of each package's own registry."""
    _write_records(journal, tmp_path / "port")
    _write_records(jax_journal, tmp_path / "jax")
    pid = str(os.getpid())
    port_segs = journal.segment_paths(tmp_path / "port" / pid)
    jax_segs = jax_journal.segment_paths(tmp_path / "jax" / pid)
    assert [p.name for p in port_segs] == [p.name for p in jax_segs]

    def body(root):
        return [{k: v for k, v in r.items() if k != "ts"} for r in _strip_metrics(journal.merge_dir(root))]

    assert body(tmp_path / "port") == body(tmp_path / "jax")


# -- shipped into a spawned worker -------------------------------------------


def _journal_in_worker(tag: str) -> int:
    from hyperspace_tpu_torch.obs import events as worker_events

    worker_events.declare("index.quarantined").emit(index=tag)
    from hyperspace_tpu_torch.obs import journal as worker_journal

    worker_journal.seal()
    return os.getpid()


def test_journal_state_ships_into_a_procpool_worker(tmp_path):
    from hyperspace_tpu_torch.parallel.procpool import TaskPool

    root = _enable(tmp_path)
    pool = TaskPool(name="hs-journal-test")
    pool.submit("w0", _journal_in_worker, "shipped")
    (worker_pid,) = pool.join(timeout=180).values()
    assert worker_pid != os.getpid()
    mine = [r for r in journal.merge_dir(root) if r.get("pid") == worker_pid]
    kinds = [r["kind"] for r in mine]
    assert "process" in kinds
    assert [r["event"]["fields"]["index"] for r in mine if r["kind"] == "event"] == ["shipped"]
    proc = next(r for r in mine if r["kind"] == "process")
    assert proc["parent_pid"] == os.getpid()
