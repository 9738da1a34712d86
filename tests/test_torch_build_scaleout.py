"""The port's pooled (multi-process) build against its serial streaming build
and the JAX package's.

tests/test_build_scaleout.py's twelve cases through the port: the pooled
build at 1, 2 and 4 workers byte-identical to the serial streaming build
(manifest and every bucket file), more workers than buckets or files, one
bucket, zero rows, the exchange layout (contiguous balanced slices, the
owner map, the spill path), the exchange round trip in this process, the
host sort against `lexsort_lanes`, `hyperspace.build.workers` and
`.exchange.dir` through a session, and the workers' traces adopted here.

Each pooled build is also held byte-identical to the JAX package's serial
streaming build of the same seeded source, budget and chunk size, and no
worker initializes CUDA (`last_build_stats["worker_cuda_initialized"]`).
A pooled build spawns its workers, so each costs a few seconds here.
"""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as htorch
from hyperspace_tpu.dataset import Dataset as JDataset
from hyperspace_tpu.execution.builder import DeviceIndexBuilder as JBuilder
from hyperspace_tpu_torch import stats
from hyperspace_tpu_torch.dataset import Dataset
from hyperspace_tpu_torch.execution import build_exchange as bx
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution.builder import DeviceIndexBuilder
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.obs import trace as obs_trace

CPU = torch.device("cpu")


def _gen_source(root, n=12_000, files=3, row_group_size=2_000, with_nulls=True):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    per = n // files
    for i in range(files):
        m = per if i < files - 1 else n - per * (files - 1)
        k = rng.integers(-(10**12), 10**12, m).astype(np.int64)
        nulls = (rng.random(m) < 0.08) if with_nulls else None
        pq.write_table(
            pa.table({
                "k": pa.array(k, mask=nulls),
                "s": pa.array([f"s{j % 41:02d}" for j in range(m)]),
                "v": pa.array(rng.standard_normal(m)),
            }),
            root / f"p{i}.parquet",
            row_group_size=row_group_size,
        )


def _assert_identical_index(d_ref, d_got, num_buckets):
    assert hio.read_manifest(d_ref) == hio.read_manifest(d_got)
    assert (d_ref / hio.MANIFEST_NAME).read_bytes() == (d_got / hio.MANIFEST_NAME).read_bytes()
    for b in range(num_buckets):
        rb = (d_ref / hio.bucket_file_name(b)).read_bytes()
        assert rb == (d_got / hio.bucket_file_name(b)).read_bytes(), f"bucket {b} differs from the reference"


def _references(tmp_path, cols, key, num_buckets, **kw):
    """(the port's serial streaming build, the JAX package's) of src."""
    d_ref = tmp_path / "ref" / "v__=0"
    serial = DeviceIndexBuilder(CPU, pipeline_enabled=False, **kw)
    serial.write(Dataset.parquet(tmp_path / "src").scan(), cols, key, num_buckets, d_ref)
    assert serial.last_build_stats["path"] == "streaming"
    d_jax = tmp_path / "jax" / "v__=0"
    JBuilder(pipeline_enabled=False, **kw).write(JDataset.parquet(tmp_path / "src").scan(), cols, key, num_buckets,
                                                 d_jax)
    return d_ref, d_jax


def _pooled(tmp_path, name, workers, cols, key, num_buckets, **kw):
    pooled = DeviceIndexBuilder(CPU, workers=workers, **kw)
    d = tmp_path / name / "v__=0"
    pooled.write(Dataset.parquet(tmp_path / "src").scan(), cols, key, num_buckets, d)
    st = pooled.last_build_stats
    assert st["path"] == "pooled" and st["worker_cuda_initialized"] is False
    assert not (d.parent / "v__=0.exchange").exists(), "exchange dir must be swept"
    return d, st


_KW = dict(memory_budget_bytes=50_000, chunk_bytes=80_000)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_pooled_build_matches_serial_byte_for_byte_across_worker_counts(tmp_path, workers):
    _gen_source(tmp_path / "src")
    d_ref, d_jax = _references(tmp_path, ["k", "s", "v"], ["k"], 16, **_KW)
    d, st = _pooled(tmp_path, f"pool{workers}", workers, ["k", "s", "v"], ["k"], 16, **_KW)
    assert st["workers"] == workers and st["p1_shards"] <= workers and st["p2_owners"] <= workers
    assert st["rows"] == 12_000 and st["exchange_bytes"] > 0
    _assert_identical_index(d_ref, d, 16)
    _assert_identical_index(d_jax, d, 16)


def test_worker_count_exceeds_bucket_count(tmp_path):
    """More workers than buckets: owners clamp to the bucket count."""
    _gen_source(tmp_path / "src", n=4_000, files=2, row_group_size=1_000)
    kw = dict(memory_budget_bytes=20_000, chunk_bytes=30_000)
    d_ref, d_jax = _references(tmp_path, ["k", "v"], ["k"], 2, **kw)
    d, st = _pooled(tmp_path, "pool", 4, ["k", "v"], ["k"], 2, **kw)
    assert st["p2_owners"] == 2 and st["p1_shards"] == 2  # clamped to buckets, to files
    _assert_identical_index(d_ref, d, 2)
    _assert_identical_index(d_jax, d, 2)


def test_single_bucket_index(tmp_path):
    _gen_source(tmp_path / "src", n=3_000, files=2, row_group_size=1_000)
    kw = dict(memory_budget_bytes=10_000, chunk_bytes=20_000)
    d_ref, d_jax = _references(tmp_path, ["k", "v"], ["k"], 1, **kw)
    d, _ = _pooled(tmp_path, "pool", 2, ["k", "v"], ["k"], 1, **kw)
    _assert_identical_index(d_ref, d, 1)
    _assert_identical_index(d_jax, d, 1)


def test_zero_row_input(tmp_path):
    root = tmp_path / "src"
    root.mkdir(parents=True)
    empty = pa.table({"k": pa.array([], type=pa.int64()), "v": pa.array([], type=pa.float64())})
    pq.write_table(empty, root / "p0.parquet")
    pq.write_table(empty, root / "p1.parquet")
    kw = dict(memory_budget_bytes=1, chunk_bytes=1_000)
    d_ref, d_jax = _references(tmp_path, ["k", "v"], ["k"], 4, **kw)
    d, st = _pooled(tmp_path, "pool", 2, ["k", "v"], ["k"], 4, **kw)
    assert st["rows"] == 0
    assert hio.read_manifest(d)["bucketRows"] == [0, 0, 0, 0]
    _assert_identical_index(d_ref, d, 4)
    _assert_identical_index(d_jax, d, 4)


# -- exchange-format unit tests ----------------------------------------------


def test_slice_files_contiguous_ordered_balanced():
    from hyperspace_tpu.execution import build_exchange as jbx

    files = [f"f{i}" for i in range(10)]
    for w in (1, 2, 3, 4, 10, 16):
        slices = bx.slice_files(files, [100] * 10, w)
        assert len(slices) == min(w, len(files))
        assert all(s for s in slices)
        assert [f for s in slices for f in s] == files
        assert slices == jbx.slice_files(files, [100] * 10, w)
    assert bx.slice_files(files, [10_000] + [100] * 9, 3)[0] == ["f0"]
    assert bx.slice_files([], [], 4) == []


def test_owner_map_is_bucket_mod_owners():
    assert [bx.owner_of(b, 3) for b in range(7)] == [0, 1, 2, 0, 1, 2, 0]


def test_spill_path_layout_groups_by_owner(tmp_path):
    p = bx.spill_path(tmp_path, owner=2, shard=1, bucket=7)
    assert p.parent == tmp_path / "owner-00002"
    assert p.name == "shard-00001.bucket-00007.parquet"


def test_exchange_roundtrip_in_process(tmp_path):
    """p1_shard → p2_owner in this process (no pool): the exchange format
    round-trips the rows, and the ledger is what p2 budgets from."""
    _gen_source(tmp_path / "src", n=2_000, files=2, row_group_size=500, with_nulls=False)
    schema = Dataset.parquet(tmp_path / "src").scan().scan_schema
    files = sorted(str(p) for p in (tmp_path / "src").glob("*.parquet"))
    ex = tmp_path / "ex"
    num_buckets, num_owners = 4, 2
    merged: dict = {}
    for w, f in enumerate(files):
        res = bx.p1_shard(bx.P1Task(
            worker=w, files=[f], fmt="parquet", columns=["k", "s", "v"], schema=schema, indexed_columns=["k"],
            num_buckets=num_buckets, num_owners=num_owners, chunk_bytes=20_000, memory_budget_bytes=10_000,
            exchange_dir=str(ex),
        ))
        assert res["rows"] == 1_000 and res["chunks"] >= 1 and res["cuda_initialized"] is False
        for b, path in res["spill_files"].items():
            assert bx.owner_of(b, num_owners) == int(path.split("owner-")[1][:5])
        for b, nb in res["spill_bytes"].items():
            merged[b] = merged.get(b, 0) + nb
    dest = tmp_path / "out"
    dest.mkdir()
    rows = {}
    for o in range(num_owners):
        res = bx.p2_owner(bx.P2Task(
            owner=o, num_owners=num_owners, n_shards=len(files), num_buckets=num_buckets, exchange_dir=str(ex),
            dest_dir=str(dest), columns=["k", "s", "v"], schema=schema, indexed_columns=["k"],
            spill_bytes={b: nb for b, nb in merged.items() if bx.owner_of(b, num_owners) == o},
            window_bytes=1,  # below any bucket: still one at a time
        ))
        rows.update(res["bucket_rows"])
    assert sum(rows.values()) == 2_000
    got = pd.concat([
        pd.DataFrame(hio.read_parquet([str(dest / hio.bucket_file_name(b))], device="cpu").decode())
        for b in range(num_buckets)
    ])
    exp = pd.concat([pd.read_parquet(f) for f in files])
    cols = ["k", "s", "v"]
    pd.testing.assert_frame_equal(
        got[cols].sort_values(cols).reset_index(drop=True), exp[cols].sort_values(cols).reset_index(drop=True),
        check_dtype=False,
    )


def test_host_sort_perm_matches_lexsort(monkeypatch):
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.ops.sortkeys import key_lanes, lexsort_lanes

    rng = np.random.default_rng(3)
    t = ColumnTable.from_arrow(pa.table({
        "k": rng.integers(-100, 100, 500).astype(np.int64), "v": rng.standard_normal(500),
    }), device="cpu")
    expected = lexsort_lanes(key_lanes(t, ["k"]))
    np.testing.assert_array_equal(bx.host_sort_perm(t, ["k"]), expected)
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    np.testing.assert_array_equal(bx.host_sort_perm(t, ["k"]), expected)


# -- end to end through the session ---------------------------------------------


def test_create_index_with_workers_conf_serves_queries(tmp_path):
    _gen_source(tmp_path / "src", n=6_000, files=2, with_nulls=False)
    session = htorch.HyperspaceSession(system_path=str(tmp_path / "idx"), num_buckets=4, device="cpu")
    session.conf.set("hyperspace.build.workers", 2)
    assert session.conf.get("hyperspace.build.workers") == 2
    hs = htorch.Hyperspace(session)
    df = session.parquet(tmp_path / "src")
    before = stats.get("build.exchange.bytes")
    hs.create_index(df, htorch.IndexConfig("sidx", ["k"], ["s", "v"]))
    assert session.last_build_stats["path"] == "pooled"
    assert stats.get("build.exchange.bytes") > before

    some_key = int(session.run(df.select("k")).columns["k"][7])
    q = df.filter(htorch.col("k") == some_key).select("k", "s", "v")
    session.disable_hyperspace()
    expected = session.to_pandas(q).sort_values(["s", "v"]).reset_index(drop=True)
    session.enable_hyperspace()
    got = session.to_pandas(q).sort_values(["s", "v"]).reset_index(drop=True)
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, expected[got.columns.tolist()])


def test_configured_exchange_dir_is_used_and_swept(tmp_path):
    _gen_source(tmp_path / "src", n=2_000, files=2, row_group_size=500, with_nulls=False)
    ex_root = tmp_path / "scratch"
    b = DeviceIndexBuilder(CPU, workers=2, exchange_dir=str(ex_root), memory_budget_bytes=10_000,
                           chunk_bytes=20_000)
    dest = tmp_path / "i" / "v__=0"
    assert b._exchange_root(dest) == ex_root / "i-v__=0.exchange"
    b.write(Dataset.parquet(tmp_path / "src").scan(), ["k", "v"], ["k"], 4, dest)
    assert b.last_build_stats["path"] == "pooled"
    assert not any(ex_root.glob("*")), "configured exchange dir not swept"
    assert sum(hio.read_manifest(dest)["bucketRows"]) == 2_000


def test_pooled_build_adopts_worker_traces(tmp_path):
    """Each worker's root span ships back and lands in this process's
    recent roots with the worker's pid-qualified trace id."""
    _gen_source(tmp_path / "src", n=3_000, files=2, row_group_size=1_000, with_nulls=False)
    obs_trace.reset()
    pooled = DeviceIndexBuilder(CPU, workers=2, memory_budget_bytes=20_000, chunk_bytes=30_000)
    with obs_trace.trace("test.build"):
        pooled.write(Dataset.parquet(tmp_path / "src").scan(), ["k", "v"], ["k"], 4, tmp_path / "i" / "v__=0")
    worker_roots = [r for r in obs_trace.recent_roots() if r.name in ("build.p1.worker", "build.p2.worker")]
    assert len(worker_roots) >= 3  # 2 p1 shards + at least 1 p2 owner
    pids = {str(r.trace_id).split("-", 1)[0] for r in worker_roots}
    assert str(os.getpid()) not in pids and len(pids) >= 2, pids


# -- the pooled build's fault points (tests/test_fault_injection.py) -----------
# The coordinator ships its rules into every spawned worker, so a crash
# rule at a worker-side point kills the worker process for real (no result
# posts) and the bounded join turns that into a typed WorkerCrashed; the
# exchange and spill scratch is swept, the action rolls back, and recover
# converges with the query still right.

import _torch_crash as crash  # noqa: E402
from hyperspace_tpu_torch import faults  # noqa: E402
from hyperspace_tpu_torch.exceptions import WorkerCrashed, WorkerFailed  # noqa: E402


@pytest.fixture
def pooled(tmp_path):
    faults.reset()
    source = crash.write_source(tmp_path / "src", n=600)
    yield source, crash.session(tmp_path / "sys", **{"hyperspace.build.workers": 2})
    faults.reset()


@pytest.mark.parametrize("point", ["build.exchange.write", "build.exchange.read"])
def test_worker_killed_mid_build_typed_abort(tmp_path, pooled, point):
    source, s = pooled
    before = stats.get("build.worker.crashes")
    faults.inject(point, crash=True, at_call=1)
    with pytest.raises(WorkerCrashed):
        crash.create(s, source)
    faults.reset()
    assert stats.get("build.worker.crashes") == before + 1
    crash.assert_crash_consistent(tmp_path / "sys", source, point)
    crash.create(s, source)  # a clean retry (the next "process")
    s.enable_hyperspace()
    crash.query_matches(s, source)


@pytest.mark.parametrize("point", ["build.worker.spawn", "build.manifest.merge"])
def test_coordinator_crash_mid_pooled_build(tmp_path, pooled, point):
    source, s = pooled
    faults.inject(point, crash=True, at_call=1)
    with pytest.raises(faults.CrashPoint):
        crash.create(s, source)
    faults.reset()
    crash.assert_crash_consistent(tmp_path / "sys", source, point)


def test_transient_worker_fault_aborts_typed_then_retries_clean(tmp_path, pooled):
    source, s = pooled
    with faults.injected("build.exchange.write"):
        with pytest.raises(WorkerFailed) as ei:
            crash.create(s, source)
    assert ei.value.error_type == "FaultError"
    crash.assert_no_build_scratch(tmp_path / "sys")
    crash.create(s, source)
    s.enable_hyperspace()
    crash.query_matches(s, source)


@pytest.mark.parametrize("point, error", [
    ("build.worker.spawn", faults.FaultError),
    ("build.manifest.merge", faults.FaultError),
    ("build.exchange.read", WorkerFailed),
])
def test_transient_pooled_fault_rolls_back(tmp_path, pooled, point, error):
    source, s = pooled
    with faults.injected(point):
        with pytest.raises(error):
            crash.create(s, source)
    crash.assert_crash_consistent(tmp_path / "sys", source, point)
