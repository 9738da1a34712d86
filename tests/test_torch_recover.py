"""Crash recovery on the CPU, the port against the JAX package.

tests/test_fault_injection.py's recover cases, each faked the same way in
an index of each package (its own system path): a refresh that died after
`begin()` with a partial `v__=1`, a torn trailing log entry, a vacuum
that died with its dirs half gone, an `end()` that died before the
pointer swap. `recover` must give the JAX package's report, leave the
same log behind (up to timestamps and the root) and keep the index
serving. Listing indexes repairs lazily: a torn entry at once, a
transient one only past `hyperspace.recover.graceSeconds` (tested with
the entry's timestamp, not a sleep).
"""

import json
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch import states

PACKAGES = (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"}))
GRACE = "hyperspace.recover.graceSeconds"
ON_ACCESS = "hyperspace.recover.onAccess"


@pytest.fixture
def twin(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(5)
    pq.write_table(pa.table({"key": rng.integers(0, 50, 400), "value": rng.standard_normal(400)}),
                   src / "part-0.parquet")
    out = {"src": src, "tmp": tmp_path}
    for label, pkg, kw in PACKAGES:
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"sys_{label}"), num_buckets=2, **kw)
        hs = pkg.Hyperspace(s)
        hs.create_index(s.parquet(src), pkg.IndexConfig("idx1", ["key"], ["value"]))
        hs.create_index(s.parquet(src), pkg.IndexConfig("idx2", ["value"], ["key"]))
        out[label] = (pkg, s, hs, tmp_path / f"sys_{label}")
    return out


def _managers(pkg, index_path):
    from importlib import import_module

    lm = import_module(f"{pkg.__name__}.metadata.log_manager").IndexLogManager(index_path)
    dm = import_module(f"{pkg.__name__}.metadata.data_manager").IndexDataManager(index_path)
    return lm, dm


def _crashed_refresh(pkg, hs, index_path):
    lm, _ = _managers(pkg, index_path)
    assert lm.write_log(2, lm.get_latest_log().with_state(states.REFRESHING))
    orphan = index_path / "v__=1"
    orphan.mkdir()
    (orphan / "bucket-00000.parquet").write_bytes(b"junk")


def _torn_tail(pkg, hs, index_path):
    (index_path / "_hyperspace_log" / "2").write_text('{"version": "0.1", "id": 2, "sta')


def _crashed_vacuum(pkg, hs, index_path):
    hs.delete_index(index_path.name)
    lm, _ = _managers(pkg, index_path)
    assert lm.write_log(4, lm.get_latest_log().with_state(states.VACUUMING))
    (index_path / "v__=1").mkdir()  # a second version, half vacuumed


def _pointer_not_swapped(pkg, hs, index_path):
    lm, _ = _managers(pkg, index_path)
    entry = lm.get_latest_log()
    assert lm.write_log(2, entry.with_state(states.DELETING))
    assert lm.write_log(3, entry.with_state(states.DELETED))  # died before the pointer swap


CRASHES = {
    "refresh": (_crashed_refresh, states.ACTIVE, ["v__=0"]),
    "torn-tail": (_torn_tail, states.ACTIVE, ["v__=0"]),
    "vacuum": (_crashed_vacuum, states.DOESNOTEXIST, []),
    "pointer": (_pointer_not_swapped, states.DELETED, ["v__=0"]),
}


def _log(index_path: Path):
    out = {}
    for p in sorted((index_path / "_hyperspace_log").iterdir()):
        try:
            d = json.loads(p.read_text())
        except ValueError:
            out[p.name] = "torn"
            continue
        d.pop("timestamp")
        if d.get("content"):
            d["content"]["root"] = "<root>"
        out[p.name] = d
    return out


@pytest.mark.parametrize("crash", list(CRASHES))
def test_recover_matches_the_jax_package(twin, crash):
    fake, want_state, want_dirs = CRASHES[crash]
    reports = {}
    for label, _, _ in PACKAGES:
        pkg, s, hs, sys_path = twin[label]
        idx = sys_path / "idx1"
        fake(pkg, hs, idx)
        reports[label] = hs.recover("idx1")
        lm, dm = _managers(pkg, idx)
        assert lm.get_latest_log().state == want_state
        assert lm.get_latest_stable_log().id == lm.get_latest_id()
        assert sorted(p.name for p in idx.glob("v__=*")) == want_dirs
        again = hs.recover("idx1")
        assert again == {"rolled": False, "quarantined_entries": 0, "orphans_removed": 0}
    assert reports["torch"] == reports["jax"]
    assert _log(twin["tmp"] / "sys_torch" / "idx1") == _log(twin["tmp"] / "sys_jax" / "idx1")
    if crash == "refresh":
        assert reports["torch"]["rolled"] and reports["torch"]["orphans_removed"] == 1
    if crash == "torn-tail":
        assert reports["torch"]["quarantined_entries"] == 1
    if want_state == states.ACTIVE:
        pkg, s, _, _ = twin["torch"]
        s.enable_hyperspace()
        q = s.parquet(twin["src"]).filter(pkg.col("key") == 7).select("key", "value")
        got = s.to_pandas(q).sort_values("value").reset_index(drop=True)
        assert s.last_query_stats["scan"] == "IndexPointLookup"
        s.disable_hyperspace()
        want = s.to_pandas(q).sort_values("value").reset_index(drop=True)
        assert got.equals(want)


def test_recover_every_index(twin):
    reports = {}
    for label, _, _ in PACKAGES:
        pkg, s, hs, sys_path = twin[label]
        _crashed_refresh(pkg, hs, sys_path / "idx2")
        reports[label] = hs.recover()
    assert reports["torch"] == reports["jax"]
    assert reports["torch"]["idx2"]["rolled"] and not reports["torch"]["idx1"]["rolled"]


def _fresh(label, twin, **conf):
    pkg, _, _, sys_path = twin[label]
    kw = {"device": "cpu"} if label == "torch" else {}
    s = pkg.HyperspaceSession(system_path=str(sys_path), num_buckets=2, **kw)
    for k, v in conf.items():
        s.conf.set(k, v)
    return s


@pytest.mark.parametrize(
    "age,grace,healed",
    [(0.0, 0, True), (0.0, None, False), (1_000.0, None, True), (100.0, 300, False)],
    ids=["grace-0", "live-writer", "long-dead-writer", "within-grace"],
)
def test_lazy_recover_on_access(twin, age, grace, healed):
    """A transient latest entry heals on the first listing once older than
    the grace (default 300 s); a younger one may be a live writer."""
    for label, _, _ in PACKAGES:
        pkg, _, _, sys_path = twin[label]
        lm, _ = _managers(pkg, sys_path / "idx1")
        dead = lm.get_latest_log().with_state(states.REFRESHING)
        dead.timestamp = time.time() - age
        assert lm.write_log(2, dead)
        s = _fresh(label, twin, **({} if grace is None else {GRACE: grace}))
        entries = {e.name: e.state for e in s.manager.get_indexes(tuple(states.ALL_STATES))}
        want = states.ACTIVE if healed else states.REFRESHING
        assert entries == {"idx1": want, "idx2": states.ACTIVE}
        assert lm.get_latest_log().state == want


def test_torn_entry_heals_on_access_unless_disabled(twin):
    for label, _, _ in PACKAGES:
        pkg, _, _, sys_path = twin[label]
        _torn_tail(pkg, None, sys_path / "idx1")
        with pytest.raises(ValueError):
            _fresh(label, twin, **{ON_ACCESS: "false"}).manager.get_indexes()
        s = _fresh(label, twin)
        assert [e.name for e in s.manager.get_indexes()] == ["idx1", "idx2"]
        assert (sys_path / "idx1" / "_hyperspace_log" / "2.corrupt").exists()


def test_cancel_rolls_a_transient_entry_like_the_jax_package(twin):
    for label, _, _ in PACKAGES:
        pkg, s, hs, sys_path = twin[label]
        _crashed_refresh(pkg, hs, sys_path / "idx1")
        hs.cancel("idx1")
        lm, dm = _managers(pkg, sys_path / "idx1")
        assert lm.get_latest_log().state == states.ACTIVE
        # cancel leaves the partial data behind; recover's GC takes it.
        assert dm.get_version_ids() == [0, 1]
        assert hs.recover("idx1") == {"rolled": False, "quarantined_entries": 0, "orphans_removed": 1}
    assert _log(twin["tmp"] / "sys_torch" / "idx1") == _log(twin["tmp"] / "sys_jax" / "idx1")
