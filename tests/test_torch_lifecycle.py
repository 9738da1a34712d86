"""The index lifecycle on the CPU, the port against the JAX package.

Both packages run every action on copies of one seeded source (each under
its own system path): the op-log entries they write must be equal up to
timestamps and the index root, their version dirs equal, and every bucket
file and manifest byte-identical — after create, incremental refresh,
optimize (compaction) and full refresh alike. The errors of
tests/test_incremental.py, the facade lifecycle of tests/test_e2e.py and
the two-phase sequences of tests/test_action_protocol.py hold in the
port; and an index refreshed by one package is optimized and queried by
the other, both ways.
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch import states
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.collection_manager import IndexCollectionManager
from hyperspace_tpu_torch.metadata.log_entry import Content, CoveringIndex, Fingerprint, IndexLogEntry, Source

NB = 4
PACKAGES = (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"}))


def _rows(n, seed, first_id):
    """tests/conftest.py's sample rows (ids from `first_id`), with nulls
    in `value` so that validity crosses the versions too."""
    rng = np.random.default_rng(seed)
    value = rng.standard_normal(n)
    return pa.table({
        "id": pa.array(np.arange(first_id, first_id + n, dtype=np.int64)),
        "key": pa.array(rng.integers(0, 100, size=n, dtype=np.int64)),
        "value": pa.array(value, mask=rng.random(n) < 0.05),
        "name": pa.array([f"name_{i % 37}" for i in range(n)]),
    })


def _append(src: Path, fname: str, seed: int, n: int = 300):
    pq.write_table(_rows(n, seed, 100_000 + 1_000 * seed), src / fname)


@pytest.fixture
def twin(tmp_path):
    """One source; a session of each package, each with its own system
    path and its own index `idx` on key (value, name included)."""
    src = tmp_path / "src"
    src.mkdir()
    t = _rows(1000, 42, 0)
    pq.write_table(t.slice(0, 500), src / "part-0.parquet")
    pq.write_table(t.slice(500), src / "part-1.parquet")
    out = {"src": src, "tmp": tmp_path}
    for label, pkg, kw in PACKAGES:
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"sys_{label}"), num_buckets=NB, **kw)
        hs = pkg.Hyperspace(s)
        hs.create_index(s.parquet(src), pkg.IndexConfig("idx", ["key"], ["value", "name"]))
        out[label] = (pkg, s, hs)
    return out


def _normalized_log(index_dir: Path) -> list:
    """Every op-log entry (and the latestStable pointer) as JSON, less
    the timestamp, with the index root replaced by a placeholder."""
    out = []
    log = index_dir / "_hyperspace_log"
    for p in sorted(log.iterdir(), key=lambda p: (not p.name.isdigit(), int(p.name) if p.name.isdigit() else p.name)):
        d = json.loads(p.read_text())
        d.pop("timestamp")
        if d.get("content"):
            d["content"]["root"] = "<root>"
        out.append((p.name, d))
    return out


def _assert_same_index(twin, name="idx"):
    a, b = twin["tmp"] / "sys_jax" / name, twin["tmp"] / "sys_torch" / name
    assert _normalized_log(b) == _normalized_log(a)
    dirs_a = sorted(d.name for d in a.glob("v__=*"))
    assert sorted(d.name for d in b.glob("v__=*")) == dirs_a
    for d in dirs_a:
        names = sorted(f.name for f in (a / d).iterdir())
        assert sorted(f.name for f in (b / d).iterdir()) == names
        for f in names:
            assert (b / d / f).read_bytes() == (a / d / f).read_bytes(), f"{d}/{f}"


def _each(twin, fn):
    for label, _, _ in PACKAGES:
        fn(*twin[label])


def _query_both(twin, make_query, hybrid=False):
    """Rows of one query in each package (hyperspace on), sorted, and the
    stats that say what ran."""
    got = {}
    for label, _, _ in PACKAGES:
        pkg, s, _ = twin[label]
        if hybrid:
            s.conf.set("hyperspace.index.hybridscan.enabled", True)
            s.conf.set("hyperspace.index.hybridscan.maxAppendedRatio", 10.0)
        s.enable_hyperspace()
        frame = s.to_pandas(make_query(pkg, s.parquet(twin["src"])))
        cols = sorted(frame.columns)
        got[label] = (frame[cols].sort_values(cols).reset_index(drop=True), dict(s.last_query_stats))
    return got


def _point(pkg, scan):
    return scan.filter(pkg.col("key") == 42).select("key", "value", "name")


def _assert_rows_equal(got):
    pd.testing.assert_frame_equal(got["torch"][0], got["jax"][0], check_dtype=False)


def test_create_writes_the_same_index(twin):
    _assert_same_index(twin)


def test_incremental_refresh_byte_identical(twin):
    _append(twin["src"], "a1.parquet", 11)
    _each(twin, lambda pkg, s, hs: hs.refresh_index("idx", mode="incremental"))
    _assert_same_index(twin)
    entry = twin["torch"][1].manager.get_indexes()[0]
    assert entry.content.directories == ["v__=0", "v__=1"]
    assert [f.path for f in entry.source.files] == sorted(str(p) for p in twin["src"].glob("*.parquet"))
    got = _query_both(twin, _point)
    _assert_rows_equal(got)
    assert got["torch"][1]["scan"] == "IndexPointLookup"
    # Bucket 42's files in both version dirs; no hybrid union left.
    assert got["torch"][1]["files_read"] == got["jax"][1]["files_read"] == 2


def test_optimize_byte_identical(twin):
    for i, seed in enumerate((11, 12)):
        _append(twin["src"], f"a{i}.parquet", seed)
        _each(twin, lambda pkg, s, hs: hs.refresh_index("idx", mode="incremental"))
    _each(twin, lambda pkg, s, hs: hs.optimize_index("idx"))
    _assert_same_index(twin)
    entry = twin["torch"][1].manager.get_indexes()[0]
    assert entry.content.directories == ["v__=3"]
    vdir = twin["tmp"] / "sys_torch" / "idx" / "v__=3"
    assert len(list(vdir.glob("bucket-*.parquet"))) == NB
    assert twin["torch"][1].last_build_stats["path"] == "compact"
    _assert_rows_equal(_query_both(twin, _point))


def test_optimize_right_after_create(twin):
    """tests/test_e2e.py's compaction of a fresh index: one new version,
    byte-identical, and the queries unchanged."""
    _each(twin, lambda pkg, s, hs: hs.optimize_index("idx"))
    _assert_same_index(twin)
    assert twin["torch"][1].manager.get_indexes()[0].content.directories == ["v__=1"]
    a, b = (twin["tmp"] / "sys_torch" / "idx" / d for d in ("v__=0", "v__=1"))
    for f in sorted(a.glob("bucket-*.parquet")):
        assert (b / f.name).read_bytes() == f.read_bytes()
    _assert_rows_equal(_query_both(twin, _point))


def test_full_refresh_byte_identical_and_keeps_bucket_count(twin):
    _append(twin["src"], "a1.parquet", 11)
    _each(twin, lambda pkg, s, hs: s.conf.set("hyperspace.index.num.buckets", 16))
    _each(twin, lambda pkg, s, hs: hs.refresh_index("idx"))
    _assert_same_index(twin)
    entry = twin["torch"][1].manager.get_indexes()[0]
    assert entry.content.directories == ["v__=1"] and entry.num_buckets == NB
    _assert_rows_equal(_query_both(twin, _point))


@pytest.mark.parametrize(
    "setup,action,match",
    [
        (None, lambda hs: hs.refresh_index("idx", mode="incremental"), "no appended"),
        ("unlink", lambda hs: hs.refresh_index("idx", mode="incremental"), "deleted or modified"),
        (None, lambda hs: hs.refresh_index("idx", mode="sideways"), "unknown refresh mode"),
        ("delete", lambda hs: hs.refresh_index("idx"), "only supported in ACTIVE"),
        ("delete", lambda hs: hs.optimize_index("idx"), "only supported in ACTIVE"),
        (None, lambda hs: hs.restore_index("idx"), "only supported in DELETED"),
        (None, lambda hs: hs.vacuum_index("idx"), "only supported in DELETED"),
        ("delete", lambda hs: hs.delete_index("idx"), "only supported in ACTIVE"),
        (None, lambda hs: hs.cancel("idx"), "not supported in stable state"),
        (None, lambda hs: hs.cancel("nope"), "does not exist"),
    ],
    ids=["no-new-files", "deleted-file", "unknown-mode", "refresh-deleted", "optimize-deleted",
         "restore-active", "vacuum-active", "delete-deleted", "cancel-stable", "cancel-missing"],
)
def test_errors_match_the_jax_package(twin, setup, action, match):
    if setup == "unlink":
        (twin["src"] / "part-1.parquet").unlink()
    errors = {}
    for label, _, _ in PACKAGES:
        pkg, s, hs = twin[label]
        if setup == "delete":
            hs.delete_index("idx")
        with pytest.raises(pkg.HyperspaceError, match=match) as e:
            action(hs)
        errors[label] = str(e.value)
    assert errors["torch"] == errors["jax"]
    _assert_same_index(twin)


def _index_used(plan) -> bool:
    return any(getattr(s, "bucket_spec", None) is not None for s in plan.leaves())


def test_lifecycle_via_facade(twin):
    """tests/test_e2e.py's facade lifecycle, in the port, with `indexes()`
    equal to the JAX package's at every state."""
    def states_of(label):
        frame = twin[label][2].indexes()
        return frame[["name", "kind", "indexedColumns", "includedColumns", "numBuckets", "schema", "state"]]

    def check(state):
        pd.testing.assert_frame_equal(states_of("torch"), states_of("jax"))
        assert states_of("torch").iloc[0]["state"] == state

    pkg, s, hs = twin["torch"]
    q = _point(pkg, s.parquet(twin["src"]))
    s.enable_hyperspace()
    check("ACTIVE")
    _each(twin, lambda pkg, s, hs: hs.delete_index("idx"))
    check("DELETED")
    assert not _index_used(s.optimized_plan(q)), "a DELETED index must not be used"
    _each(twin, lambda pkg, s, hs: hs.restore_index("idx"))
    check("ACTIVE")
    assert _index_used(s.optimized_plan(q))
    _each(twin, lambda pkg, s, hs: hs.delete_index("idx"))
    _each(twin, lambda pkg, s, hs: hs.vacuum_index("idx"))
    check("DOESNOTEXIST")
    assert not list((twin["tmp"] / "sys_torch" / "idx").glob("v__=*"))
    _assert_same_index(twin)


def test_stale_index_not_used_until_refresh(twin):
    """tests/test_e2e.py: an append stops the rule (signature mismatch)
    until a refresh; the refreshed index answers with the new rows."""
    pkg, s, hs = twin["torch"]
    scan = s.parquet(twin["src"])
    q = scan.filter(pkg.col("key") == 3).select("key", "value")
    s.enable_hyperspace()
    assert _index_used(s.optimized_plan(q))
    pq.write_table(pa.table({
        "id": np.arange(4, dtype=np.int64), "key": np.full(4, 3, dtype=np.int64),
        "value": np.ones(4), "name": pa.array(["x"] * 4),
    }), twin["src"] / "extra.parquet")
    s.manager.clear_cache()
    assert not _index_used(s.optimized_plan(q))
    hs.refresh_index("idx")
    assert _index_used(s.optimized_plan(q))
    got = s.to_pandas(q)
    s.disable_hyperspace()
    want = s.to_pandas(q)
    assert len(got) == len(want) and (got.key == 3).sum() >= 4
    def values(f):
        return np.sort(pd.to_numeric(f.value).fillna(-9.0).to_numpy(dtype=np.float64))

    np.testing.assert_array_equal(values(got), values(want))


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_interchange(twin, first):
    """One package refreshes incrementally and the other optimizes and
    queries; then the roles swap. The index they grow together is
    byte-identical to the one the other package grows alone."""
    second = "torch" if first == "jax" else "jax"
    shared = twin["tmp"] / f"sys_{first}"
    sess = {}
    for label, pkg, kw in PACKAGES:
        s = pkg.HyperspaceSession(system_path=str(shared), num_buckets=NB, **kw)
        sess[label] = (pkg, s, pkg.Hyperspace(s))
    alone = twin[second][2]  # the same actions by the other package alone
    _append(twin["src"], "a1.parquet", 11)
    sess[first][2].refresh_index("idx", mode="incremental")
    alone.refresh_index("idx", mode="incremental")
    sess[second][2].optimize_index("idx")
    alone.optimize_index("idx")
    _append(twin["src"], "a2.parquet", 12)
    sess[second][2].refresh_index("idx", mode="incremental")
    alone.refresh_index("idx", mode="incremental")
    sess[first][2].optimize_index("idx")
    alone.optimize_index("idx")
    frames = {}
    for label in (first, second):
        pkg, s, _ = sess[label]
        s.enable_hyperspace()
        q = _point(pkg, s.parquet(twin["src"]))
        assert _index_used(s.optimized_plan(q))
        f = s.to_pandas(q)
        frames[label] = f.sort_values(sorted(f.columns)).reset_index(drop=True)[sorted(f.columns)]
    pd.testing.assert_frame_equal(frames[first], frames[second], check_dtype=False)
    _assert_same_index(twin)


# -- the two-phase protocol (tests/test_action_protocol.py) ----------------


def _entry(state=states.ACTIVE, name="idx"):
    schema = [{"name": "k", "dtype": "int64", "nullable": False},
              {"name": "v", "dtype": "float64", "nullable": False}]
    e = IndexLogEntry(
        name=name,
        derived_dataset=CoveringIndex(indexed_columns=["k"], included_columns=["v"], schema=schema, num_buckets=4),
        content=Content(root="/idx", directories=["v__=0"]),
        source=Source(plan={"type": "scan", "root": "/src", "format": "parquet", "schema": schema},
                      fingerprint=Fingerprint(kind="fileBased", value="f0"), files=[]),
    )
    e.state = state
    return e


class FakeLogManager:
    """In-memory log manager recording every protocol call in order."""

    def __init__(self, path=None, latest=None):
        self.path = path
        self.calls: list[tuple] = []
        self.logs: dict[int, IndexLogEntry] = {}
        if latest is not None:
            self.logs[0] = latest
        self.stable_id = 0 if latest is not None else None
        self.fail_write_ids: set[int] = set()

    def get_latest_id(self):
        return max(self.logs) if self.logs else None

    def get_latest_log(self):
        lid = self.get_latest_id()
        return self.logs.get(lid) if lid is not None else None

    def get_latest_stable_log(self):
        return self.logs.get(self.stable_id) if self.stable_id is not None else None

    def write_log(self, id, entry):
        self.calls.append(("write_log", id, entry.state))
        if id in self.fail_write_ids or id in self.logs:
            return False
        self.logs[id] = entry
        return True

    def create_latest_stable_log(self, id):
        self.calls.append(("create_latest_stable", id))
        self.stable_id = id


class FakeDataManager:
    def __init__(self, path=None, versions=(0,)):
        self.path = path
        self.versions = list(versions)
        self.deleted: list[int] = []

    def get_latest_version_id(self):
        return self.versions[-1]

    def get_path(self, version):
        return f"/idx/v__={version}"

    def get_version_ids(self):
        return list(self.versions)

    def delete(self, version):
        self.deleted.append(version)


class NoopAction(Action):
    transient_state = states.CREATING
    final_state = states.ACTIVE

    def build_log_entry(self):
        return _entry()


class Crash(BaseException):
    """A hard crash: a BaseException, which the in-process rollback
    deliberately does not catch."""


def _exploding(transient, exc):
    class Exploding(NoopAction):
        transient_state = transient

        def op(self):
            raise exc("mid-flight failure")

        def cleanup_failed_op(self):
            self.cleaned = True

    return Exploding


@pytest.mark.parametrize(
    "case,latest,action,want_calls,want_latest",
    [
        ("run-empty-log", None, NoopAction,
         [("write_log", 0, states.CREATING), ("write_log", 1, states.ACTIVE), ("create_latest_stable", 1)],
         states.ACTIVE),
        ("run-existing-log", states.ACTIVE, NoopAction,
         [("write_log", 1, states.CREATING), ("write_log", 2, states.ACTIVE), ("create_latest_stable", 2)],
         states.ACTIVE),
        ("op-fails-empty-log", None, _exploding(states.CREATING, RuntimeError),
         [("write_log", 0, states.CREATING), ("write_log", 1, states.DOESNOTEXIST), ("create_latest_stable", 1)],
         states.DOESNOTEXIST),
        ("op-fails-restores-stable", states.ACTIVE, _exploding(states.REFRESHING, RuntimeError),
         [("write_log", 1, states.REFRESHING), ("write_log", 2, states.ACTIVE), ("create_latest_stable", 2)],
         states.ACTIVE),
        ("vacuum-fails-rolls-forward", states.DELETED, _exploding(states.VACUUMING, RuntimeError),
         [("write_log", 1, states.VACUUMING), ("write_log", 2, states.DOESNOTEXIST), ("create_latest_stable", 2)],
         states.DOESNOTEXIST),
        ("crash-leaves-transient", None, _exploding(states.CREATING, Crash),
         [("write_log", 0, states.CREATING)], states.CREATING),
    ],
)
def test_two_phase_sequences(case, latest, action, want_calls, want_latest):
    lm = FakeLogManager(latest=None if latest is None else _entry(latest))
    act = action(lm)
    if case.startswith(("op-fails", "vacuum-fails")):
        with pytest.raises(RuntimeError, match="mid-flight failure"):
            act.run()
        assert act.cleaned
    elif case.startswith("crash"):
        with pytest.raises(Crash):
            act.run()
        assert not hasattr(act, "cleaned")
    else:
        act.run()
    assert lm.calls == want_calls
    assert lm.get_latest_log().state == want_latest


def test_losing_cas_aborts_with_no_final_write():
    lm = FakeLogManager()
    lm.fail_write_ids = {0}
    with pytest.raises(HyperspaceError, match="Could not acquire proper state"):
        NoopAction(lm).run()
    assert lm.calls == [("write_log", 0, states.CREATING)]
    assert lm.stable_id is None


def _manager(tmp_path, latest, versions=(0,)):
    created: dict = {}

    def log_factory(path):
        if latest in states.STABLE_STATES:
            created["log"] = FakeLogManager(path, latest=_entry(latest))
        else:  # a transient tail over a stable entry
            created["log"] = FakeLogManager(path, latest=_entry(states.ACTIVE))
            created["log"].logs[1] = _entry(latest)
        return created["log"]

    def data_factory(path):
        created["data"] = FakeDataManager(path, versions)
        return created["data"]

    conf = HyperspaceConf(system_path=str(tmp_path / "sys"))
    mgr = IndexCollectionManager(conf, None, None, log_manager_factory=log_factory, data_manager_factory=data_factory)
    return mgr, created


@pytest.mark.parametrize(
    "method,latest,want",
    [
        ("delete", states.ACTIVE, [("write_log", 1, states.DELETING), ("write_log", 2, states.DELETED)]),
        ("restore", states.DELETED, [("write_log", 1, states.RESTORING), ("write_log", 2, states.ACTIVE)]),
        ("vacuum", states.DELETED, [("write_log", 1, states.VACUUMING), ("write_log", 2, states.DOESNOTEXIST)]),
        ("cancel", states.REFRESHING, [("write_log", 2, states.ACTIVE)]),
    ],
)
def test_collection_manager_factory_seam(tmp_path, method, latest, want):
    """Each action through the manager uses ONLY the injected fakes."""
    mgr, created = _manager(tmp_path, latest, versions=(0, 1, 2))
    getattr(mgr, method)("idx")
    assert [c for c in created["log"].calls if c[0] == "write_log"] == want
    assert created["log"].get_latest_log().state == want[-1][2]
    if method == "vacuum":
        assert sorted(created["data"].deleted) == [0, 1, 2]
