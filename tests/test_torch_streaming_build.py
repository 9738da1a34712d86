"""The port's streaming (out-of-core) build against its in-memory build and
the JAX package's streaming build.

tests/test_streaming_build.py's seven cases through the port: under a
budget far below the source the chunked spill and the batched device sort
give the in-memory build's index (row counts, keys sorted in every bucket,
the same row multiset), the pipelined build is byte-identical to the
serial one (also with a window below one bucket), an index built out of
core answers queries as the raw scan does, lane decomposition keeps every
dtype's order, the chunk plan covers every row group once, and CSV / ORC /
JSON sources stream too.

Then the cross-package cases: on the same seeded source, budget and chunk
size, the port's streaming build with the pipeline on and off writes a
manifest and bucket files byte-identical to the JAX package's streaming
build; `device_sort_perms` equals the host sort and `lexsort_lanes`; and an
index above the budget compacts through the streaming pipeline (optimize
past memory) into files byte-identical to the JAX package's.
"""

import json

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu.dataset import Dataset as JDataset
from hyperspace_tpu.execution.builder import DeviceIndexBuilder as JBuilder
from hyperspace_tpu_torch.dataset import Dataset
from hyperspace_tpu_torch.execution import build_exchange as bx
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution.builder import DeviceIndexBuilder
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops.sortkeys import device_sort_perms, key_lanes, lexsort_lanes, value_lanes

CPU = torch.device("cpu")


def _gen_source(root, n=20_000, files=3, row_group_size=2_000, with_nulls=True):
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


def _read(path):
    return hio.read_parquet([str(path)], device="cpu")


def _assert_identical_index(d_ref, d_got, num_buckets):
    assert hio.read_manifest(d_ref) == hio.read_manifest(d_got)
    assert (d_ref / hio.MANIFEST_NAME).read_bytes() == (d_got / hio.MANIFEST_NAME).read_bytes()
    for b in range(num_buckets):
        assert (d_ref / hio.bucket_file_name(b)).read_bytes() == (d_got / hio.bucket_file_name(b)).read_bytes(), b


@pytest.mark.parametrize("key", [["k"], ["k", "s"]])
def test_streaming_build_matches_in_memory(tmp_path, key):
    _gen_source(tmp_path / "src")
    ds = Dataset.parquet(tmp_path / "src")
    num_buckets = 16
    mem = DeviceIndexBuilder(CPU)
    d_mem = tmp_path / "idx_mem" / "v__=0"
    mem.write(ds.scan(), ["k", "s", "v"], key, num_buckets, d_mem)
    assert mem.last_build_stats["path"] == "in-memory"

    # A budget far below the source forces the chunked spill pipeline.
    stream = DeviceIndexBuilder(CPU, memory_budget_bytes=50_000, chunk_bytes=80_000)
    d_str = tmp_path / "idx_str" / "v__=0"
    stream.write(ds.scan(), ["k", "s", "v"], key, num_buckets, d_str)
    st = stream.last_build_stats
    assert st["path"] == "streaming" and st["chunks"] > 3 and st["rows"] == 20_000
    assert st["bytes_estimate"] > 50_000 and st["native"] and st["hash_path"] == "native"
    assert set(st["phases_s"]) == {"p1_decode_hash_spill", "p1_decode_wait", "p2_sort_encode_write"}
    assert not (d_str.parent / "v__=0.spill").exists(), "spill dir must be cleaned up"

    assert hio.read_manifest(d_mem)["bucketRows"] == hio.read_manifest(d_str)["bucketRows"]
    for b in range(num_buckets):
        t1, t2 = _read(d_mem / hio.bucket_file_name(b)), _read(d_str / hio.bucket_file_name(b))
        assert t1.num_rows == t2.num_rows
        if t1.num_rows == 0:
            continue
        for t in (t1, t2):  # both key-sorted, nulls first
            lanes = key_lanes(t, key, force_validity=True)
            perm = lexsort_lanes(lanes)
            assert all(np.array_equal(a[perm], a) for a in lanes), f"bucket {b} not key-sorted"
        cols = ["k", "s", "v"]
        df1 = pd.DataFrame(t1.decode()).sort_values(cols, na_position="first").reset_index(drop=True)
        df2 = pd.DataFrame(t2.decode()).sort_values(cols, na_position="first").reset_index(drop=True)
        pd.testing.assert_frame_equal(df1, df2)


def test_pipelined_build_matches_serial_byte_for_byte(tmp_path):
    _gen_source(tmp_path / "src", n=24_000, files=3, row_group_size=2_000)
    ds = Dataset.parquet(tmp_path / "src")
    kw = dict(memory_budget_bytes=50_000, chunk_bytes=80_000)
    serial = DeviceIndexBuilder(CPU, pipeline_enabled=False, **kw)
    d_serial = tmp_path / "idx_serial" / "v__=0"
    serial.write(ds.scan(), ["k", "s", "v"], ["k"], 16, d_serial)
    assert serial.last_build_stats["path"] == "streaming"
    assert "pipeline" not in serial.last_build_stats

    pipe = DeviceIndexBuilder(CPU, pipeline_enabled=True, **kw)
    d_pipe = tmp_path / "idx_pipe" / "v__=0"
    pipe.write(ds.scan(), ["k", "s", "v"], ["k"], 16, d_pipe)
    pinfo = pipe.last_build_stats["pipeline"]
    assert pinfo["window_bytes"] > 0 and 0.0 <= pinfo["occupancy"] <= 1.0
    assert set(pinfo["stage_busy_s"]) == {"read", "sort", "write"}
    assert not (d_pipe.parent / "v__=0.spill").exists()
    _assert_identical_index(d_serial, d_pipe, 16)


def test_pipeline_window_of_one_bucket_still_completes(tmp_path):
    """A window smaller than any bucket admits buckets one at a time
    (never a deadlock) and gives the same index."""
    _gen_source(tmp_path / "src", n=6_000, files=2, row_group_size=1_000)
    ds = Dataset.parquet(tmp_path / "src")
    kw = dict(memory_budget_bytes=20_000, chunk_bytes=30_000)
    d1, d2 = tmp_path / "i1" / "v__=0", tmp_path / "i2" / "v__=0"
    DeviceIndexBuilder(CPU, pipeline_enabled=False, **kw).write(ds.scan(), ["k", "v"], ["k"], 4, d1)
    DeviceIndexBuilder(CPU, pipeline_enabled=True, pipeline_max_inflight_bytes=1, **kw).write(
        ds.scan(), ["k", "v"], ["k"], 4, d2
    )
    _assert_identical_index(d1, d2, 4)


def test_streamed_index_serves_queries(tmp_path):
    """An index built out of core answers rewritten queries as the raw
    scan does."""
    _gen_source(tmp_path / "src", n=8_000, with_nulls=False)
    session = htorch.HyperspaceSession(system_path=str(tmp_path / "idx"), num_buckets=8, device="cpu")
    session.conf.set("hyperspace.index.build.memoryBudgetBytes", 30_000)
    session.conf.set("hyperspace.index.build.chunkBytes", 50_000)
    assert session.conf.get("hyperspace.index.build.memoryBudgetBytes") == 30_000
    hs = htorch.Hyperspace(session)
    df = session.parquet(tmp_path / "src")
    hs.create_index(df, htorch.IndexConfig("sidx", ["k"], ["s", "v"]))
    assert session.last_build_stats["path"] == "streaming"

    some_key = int(session.run(df.select("k")).columns["k"][7])
    q = df.filter(htorch.col("k") == some_key).select("k", "s", "v")
    session.disable_hyperspace()
    expected = session.to_pandas(q).sort_values(["s", "v"]).reset_index(drop=True)
    session.enable_hyperspace()
    got = session.to_pandas(q).sort_values(["s", "v"]).reset_index(drop=True)
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, expected[got.columns.tolist()])


def test_value_lanes_preserve_order():
    rng = np.random.default_rng(5)
    cases = [
        rng.integers(-(2**60), 2**60, 500).astype(np.int64),
        rng.integers(0, 2**63, 500).astype(np.uint64),
        rng.integers(-(2**30), 2**30, 500).astype(np.int32),
        (rng.standard_normal(500) * 1e6).astype(np.float64),
        (rng.standard_normal(500) * 1e3).astype(np.float32),
        rng.integers(0, 2, 500).astype(np.bool_),
        rng.integers(0, 2**31, 500).astype(np.uint32),
        rng.integers(-100, 100, 500).astype(np.int16),
    ]
    for arr in cases:
        got = lexsort_lanes(value_lanes(arr))
        assert np.array_equal(arr[got], arr[np.argsort(arr, kind="stable")]), arr.dtype


def test_chunk_planning_respects_budget(tmp_path):
    _gen_source(tmp_path / "src", n=10_000, files=2, row_group_size=1_000)
    files = sorted(str(p) for p in (tmp_path / "src").glob("*.parquet"))
    est = hio.estimate_uncompressed_bytes(files)
    assert est > 0
    chunks = hio.plan_row_group_chunks(files, chunk_bytes=est // 4)
    assert len(chunks) >= 4
    seen = [u for c in chunks for u in c]
    assert len(seen) == len(set(seen))
    assert len(seen) == sum(pq.ParquetFile(f).metadata.num_row_groups for f in files)


def _write_format(root, fmt, n=12_000, files=3):
    import pyarrow.csv as pcsv
    import pyarrow.orc as porc

    rng = np.random.default_rng(13)
    root.mkdir()
    per = n // files
    for i in range(files):
        t = pa.table({"k": rng.integers(0, 5_000, per).astype(np.int64), "v": np.round(rng.standard_normal(per), 6)})
        if fmt == "csv":
            pcsv.write_csv(t, root / f"p{i}.csv")
        elif fmt == "orc":
            porc.write_table(t, root / f"p{i}.orc", stripe_size=16 << 10)
        else:
            with open(root / f"p{i}.json", "w") as f:
                for r in range(per):
                    f.write(json.dumps({"k": int(t["k"][r].as_py()), "v": float(t["v"][r].as_py())}) + "\n")


@pytest.mark.parametrize("fmt", ["csv", "orc", "json"])
def test_streaming_build_non_parquet_sources(tmp_path, fmt):
    """CSV by record batches, ORC by stripes, JSON a file at a time: the
    in-memory build's index, and bytes equal to the JAX package's
    streaming build of the same source."""
    root = tmp_path / "src"
    _write_format(root, fmt)
    ds = getattr(Dataset, fmt)(root)
    mem = DeviceIndexBuilder(CPU)
    d_mem = tmp_path / "idx_mem" / "v__=0"
    mem.write(ds.scan(), ["k", "v"], ["k"], 8, d_mem)
    assert mem.last_build_stats["path"] == "in-memory"

    budget = 1_000_000 if fmt == "json" else 15_000
    stream = DeviceIndexBuilder(CPU, memory_budget_bytes=budget, chunk_bytes=15_000)
    d_str = tmp_path / "idx_str" / "v__=0"
    stream.write(ds.scan(), ["k", "v"], ["k"], 8, d_str)
    st = stream.last_build_stats
    assert st["path"] == "streaming" and st["format"] == fmt
    if fmt != "json":
        assert st["chunks"] > 3
    assert hio.read_manifest(d_mem)["bucketRows"] == hio.read_manifest(d_str)["bucketRows"]
    for b in range(8):
        df1 = pd.DataFrame(_read(d_mem / hio.bucket_file_name(b)).decode()).sort_values(["k", "v"])
        df2 = pd.DataFrame(_read(d_str / hio.bucket_file_name(b)).decode()).sort_values(["k", "v"])
        pd.testing.assert_frame_equal(df1.reset_index(drop=True), df2.reset_index(drop=True))
    d_jax = tmp_path / "idx_jax" / "v__=0"
    JBuilder(memory_budget_bytes=budget, chunk_bytes=15_000).write(
        getattr(JDataset, fmt)(root).scan(), ["k", "v"], ["k"], 8, d_jax
    )
    _assert_identical_index(d_jax, d_str, 8)


# -- cross-package ------------------------------------------------------------


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("key", [["k"], ["k", "s"]])
def test_streaming_build_is_byte_identical_to_the_jax_packages(tmp_path, pipeline, key):
    _gen_source(tmp_path / "src", n=12_000, files=3, row_group_size=1_500)
    kw = dict(memory_budget_bytes=50_000, chunk_bytes=80_000)
    d_jax = tmp_path / "jax" / "v__=0"
    JBuilder(pipeline_enabled=False, **kw).write(
        JDataset.parquet(tmp_path / "src").scan(), ["k", "s", "v"], key, 16, d_jax
    )
    port = DeviceIndexBuilder(CPU, pipeline_enabled=pipeline, **kw)
    d_port = tmp_path / "port" / "v__=0"
    port.write(Dataset.parquet(tmp_path / "src").scan(), ["k", "s", "v"], key, 16, d_port)
    assert port.last_build_stats["path"] == "streaming"
    _assert_identical_index(d_jax, d_port, 16)


def test_device_sort_perms_equal_the_host_sort(tmp_path):
    """The batched device sort (run here on the CPU) gives each table of a
    batch the host's stable permutation: pads sink, equal keys keep their
    order, empty and one-row tables included."""
    rng = np.random.default_rng(21)
    tables = []
    for n in (0, 1, 7, 3_000, 1_234):
        t = pa.table({
            "k": pa.array(rng.integers(-40, 40, n), mask=rng.random(n) < 0.1),
            "s": pa.array([f"x{i % 9}" for i in range(n)], type=pa.string()),
            "f": pa.array(rng.integers(-3, 3, n).astype(np.float64)),
        })
        tables.append(ColumnTable.from_arrow(t, device="cpu"))
    for cols in (["k"], ["s", "k"], ["f", "s"], ["k", "s", "f"]):
        perms = device_sort_perms(tables, cols, CPU)
        for t, p in zip(tables, perms):
            assert len(p) == t.num_rows
            np.testing.assert_array_equal(p, bx.host_sort_perm(t, cols))
            np.testing.assert_array_equal(p, lexsort_lanes(key_lanes(t, cols)))


def test_optimize_past_memory_takes_the_streaming_compactor(tmp_path):
    """An index above the budget compacts through the streaming pipeline:
    one file a bucket, the rows of every version, and files byte-identical
    to the JAX package's optimize of the same index."""
    _gen_source(tmp_path / "src", n=9_000, files=3, row_group_size=1_000, with_nulls=False)
    pkgs = (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"}))
    sessions = {}
    for name, pkg, kw in pkgs:
        session = pkg.HyperspaceSession(system_path=str(tmp_path / f"sys_{name}"), num_buckets=4, **kw)
        session.conf.set("hyperspace.index.build.chunkBytes", 40_000)
        pkg.Hyperspace(session).create_index(session.parquet(tmp_path / "src"), pkg.IndexConfig("grow", ["k"], ["v"]))
        sessions[name] = session
    rng = np.random.default_rng(5)
    m = 3_000
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(-(10**12), 10**12, m)), "s": pa.array(["a"] * m),
        "v": pa.array(rng.standard_normal(m)),
    }), tmp_path / "src" / "p9.parquet")
    results = {}
    for name, pkg, _ in pkgs:
        session = sessions[name]
        hs = pkg.Hyperspace(session)
        hs.refresh_index("grow", "incremental")
        session.conf.set("hyperspace.index.build.memoryBudgetBytes", 20_000)
        hs.optimize_index("grow")
        if name == "torch":
            st = session.last_build_stats
            assert st["path"] == "streaming" and st["rows"] == 12_000
        results[name] = max((tmp_path / f"sys_{name}" / "grow").glob("v__=*"), key=lambda p: int(p.name[4:]))
    for name, d in results.items():
        assert sorted(p.name for p in d.glob("*.parquet")) == [hio.bucket_file_name(b) for b in range(4)], name
    assert sum(hio.read_manifest(results["torch"])["bucketRows"]) == 12_000
    _assert_identical_index(results["jax"], results["torch"], 4)


# -- the streaming build's fault points (tests/test_fault_injection.py) ---------

import _torch_crash as crash  # noqa: E402
from hyperspace_tpu_torch import faults  # noqa: E402

_STREAMING = {"hyperspace.index.build.memoryBudgetBytes": 2_000, "hyperspace.index.build.chunkBytes": 4_000}


@pytest.fixture
def clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.mark.parametrize("point", ["spill.read", "pipeline.put", "pipeline.get"])
def test_crash_mid_pipeline_streaming_build(tmp_path, clean_faults, point):
    source = crash.write_source(tmp_path / "src", n=600)
    s = crash.session(tmp_path / "sys", **_STREAMING)
    faults.inject(point, crash=True, at_call=1)
    with pytest.raises(faults.CrashPoint):
        crash.create(s, source)
    faults.reset()
    # The stop flag unblocks every stage, so the spill dir's cleanup ran.
    crash.assert_no_build_scratch(tmp_path / "sys")
    crash.assert_crash_consistent(tmp_path / "sys", source, point)


@pytest.mark.parametrize("point", ["spill.read", "pipeline.put", "pipeline.get"])
def test_transient_pipeline_fault_rolls_back(tmp_path, clean_faults, point):
    """A persistent FaultError in the pipeline surfaces through the builder
    (the reader's re-raised on the sort stage), Action.run rolls back, and
    a clean retry succeeds."""
    source = crash.write_source(tmp_path / "src", n=600)
    s = crash.session(tmp_path / "sys", **_STREAMING)
    with faults.injected(point):
        with pytest.raises(OSError):
            crash.create(s, source)
    crash.assert_no_build_scratch(tmp_path / "sys")
    crash.create(s, source)
    assert s.last_build_stats["path"] == "streaming"
    s.enable_hyperspace()
    crash.query_matches(s, source)


def test_crash_sweep_of_a_streaming_create(tmp_path_factory, clean_faults):
    """Every point a streaming create fires (the footer cache's, the
    pipeline's and the metadata plane's), a CrashPoint at its first call,
    then recover converges and the query answers."""
    base = tmp_path_factory.mktemp("discover")
    source = crash.write_source(base / "src", n=600)
    with faults.recording() as seen:
        crash.create(crash.session(base / "sys", **_STREAMING), source)
    assert {"footer.read", "spill.read", "pipeline.put", "pipeline.get"} <= seen
    for point in sorted(seen):
        tmp = tmp_path_factory.mktemp("sweep")
        source = crash.write_source(tmp / "src", n=600)
        faults.inject(point, crash=True, at_call=1)
        with pytest.raises(faults.CrashPoint):
            crash.create(crash.session(tmp / "sys", **_STREAMING), source)
        faults.reset()
        crash.assert_crash_consistent(tmp / "sys", source, point)
