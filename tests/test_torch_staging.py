"""Zero-copy staging (execution/staging.py) and its fault point on the CPU.

tests/test_device_staging.py's staging cases (its lines 202-406) through
the port. The zero-copy path itself only runs for a column bound for the
card, so here the view it stages from (`staging.staged_view`) is held to
the JAX package's contract: fixed-width, null-free, single-chunk columns
(date32 and timestamp[us] included, offset slices too) become read-only
views over Arrow's buffer with the right values, and everything else
(nulls, bool, several chunks, staging off, a staging fault) takes the
copied path. A table read for the CPU always owns writable copies, and
its scalar bytes count as copied. The card's half (the column on the card
without a host copy, the counters, a transient `device.stage` fault
degrading to the copied path inside a query) is in tests/test_torch_cuda.py.

Then tests/test_fault_injection.py's staging cases on the staging
boundary: a transient fault degrades the column, a crash is a
`CrashPoint`, and `hyperspace.faults.enabled` off makes the point inert.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as htorch
from hyperspace_tpu.execution.table import ColumnTable as JTable
from hyperspace_tpu_torch import faults, stats
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution import staging
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.schema import Schema


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    staging.set_enabled(True)
    yield
    faults.reset()
    faults.set_enabled(True)
    staging.set_enabled(True)


def _views(table) -> dict:
    """name → staged view (or None) of each column of a pyarrow table."""
    schema = Schema.from_arrow(table.schema)
    return {f.name: staging.staged_view(table.column(f.name), f) for f in schema.fields}


def test_zero_copy_views_and_the_cpu_read_copies(tmp_path):
    t = pa.table({
        "a": np.arange(10_000, dtype=np.int64),
        "b": np.arange(10_000, dtype=np.float32),
        "c": pa.array([None if i % 9 == 0 else i for i in range(10_000)], type=pa.int32()),
    })
    pq.write_table(t, tmp_path / "p.parquet")
    arrow = pq.read_table(tmp_path / "p.parquet")
    views = _views(arrow)
    # a and b view Arrow's buffers; c (nullable) takes the copied path.
    assert views["c"] is None
    for name in ("a", "b"):
        assert not views[name].flags.writeable
        np.testing.assert_array_equal(views[name], np.arange(10_000))
    before_zc, before_cp = stats.get("device.stage.bytes_zero_copy"), stats.get("device.stage.bytes_copied")
    ct = hio.read_parquet([str(tmp_path / "p.parquet")], device="cpu")
    # Bound for the CPU, every scalar column is copied (its tensor owns
    # its memory): nothing zero-copy, all 10,000 x (8 + 4 + 4) bytes copied.
    assert stats.get("device.stage.bytes_zero_copy") == before_zc
    assert stats.get("device.stage.bytes_copied") - before_cp == 10_000 * (8 + 4 + 4)
    np.testing.assert_array_equal(ct.columns["a"].numpy(), np.arange(10_000))


def test_staging_disabled_copies_everything(tmp_path):
    t = pa.table({"a": np.arange(1000, dtype=np.int64)})
    session = htorch.HyperspaceSession(system_path=str(tmp_path), device="cpu")
    session.conf.set("hyperspace.device.staging.enabled", False)
    assert session.conf.get("hyperspace.device.staging.enabled") is False
    assert not staging.enabled()
    assert _views(t)["a"] is None
    session.conf.set("hyperspace.device.staging.enabled", True)
    assert staging.enabled() and _views(t)["a"] is not None


def test_offset_view_slices_stage_correctly():
    base = pa.table({"a": np.arange(1000, dtype=np.int64), "s": pa.array([f"v{i % 3}" for i in range(1000)])})
    sliced = base.slice(17, 400)  # a non-zero offset
    np.testing.assert_array_equal(_views(sliced)["a"], np.arange(17, 417))
    ct = ColumnTable.from_arrow(sliced, device="cpu")
    np.testing.assert_array_equal(ct.columns["a"].numpy(), np.arange(17, 417))
    got = ct.dictionaries["s"][ct.columns["s"].numpy()]
    np.testing.assert_array_equal(got.astype(str), np.array([f"v{i % 3}" for i in range(17, 417)]))


def test_a_cpu_read_owns_writable_copies(tmp_path):
    """The port's counterpart of the JAX package's un-cached downgrade: a
    table read for the CPU never holds Arrow's buffer, so a write through
    it leaves the Arrow data alone."""
    t = pa.table({"a": np.arange(50_000, dtype=np.int64)})
    ct = ColumnTable.from_arrow(t, device="cpu")
    ct.columns["a"][0] = -1
    assert ct.columns["a"][0].item() == -1 and t.column("a")[0].as_py() == 0


def test_bool_and_multichunk_columns_take_copy_path():
    t1 = pa.table({"b": pa.array([True, False] * 50)})
    assert _views(t1)["b"] is None
    ct1 = ColumnTable.from_arrow(t1, device="cpu")
    assert ct1.columns["b"].dtype == torch.bool
    np.testing.assert_array_equal(ct1.columns["b"].numpy(), np.array([True, False] * 50))
    chunked = pa.table({"a": pa.chunked_array([np.arange(5, dtype=np.int64), np.arange(5, 10, dtype=np.int64)])})
    assert _views(chunked)["a"] is None
    np.testing.assert_array_equal(ColumnTable.from_arrow(chunked, device="cpu").columns["a"].numpy(), np.arange(10))


def test_mutating_zero_copy_staged_view_raises():
    t = pa.table({"a": np.arange(1000, dtype=np.int64)})
    view = _views(t)["a"]
    assert not view.flags.writeable
    with pytest.raises(ValueError):
        view[0] = -1
    assert t.column("a")[0].as_py() == 0


def test_date32_and_timestamp_views_are_read_only():
    t = pa.table({
        "d": pa.array([0, 1, 20000], type=pa.date32()),
        "ts": pa.array([0, 1_000_000, 2_000_000], type=pa.timestamp("us")),
    })
    views = _views(t)
    assert views["d"].dtype == np.int32 and views["ts"].dtype == np.int64
    np.testing.assert_array_equal(views["d"], [0, 1, 20000])
    np.testing.assert_array_equal(views["ts"], [0, 1_000_000, 2_000_000])
    for name in ("d", "ts"):
        with pytest.raises(ValueError):
            views[name][0] = 7
    # The port's decode of the same table equals the JAX package's.
    ct, jt = ColumnTable.from_arrow(t, device="cpu"), JTable.from_arrow(t)
    for name in ("d", "ts"):
        np.testing.assert_array_equal(ct.columns[name].numpy(), jt.columns[name])


def test_every_eligible_column_is_viewed_read_only():
    t = pa.table({
        "i64": np.arange(500, dtype=np.int64),
        "f32": np.arange(500, dtype=np.float32),
        "i32": np.arange(500, dtype=np.int32),
        "d": pa.array(list(range(500)), type=pa.date32()),
        "ts": pa.array([i * 1000 for i in range(500)], type=pa.timestamp("us")),
        "nullable": pa.array([None if i % 5 == 0 else i for i in range(500)], type=pa.int64()),
    })
    views = _views(t)
    assert sum(v.nbytes for v in views.values() if v is not None) == 500 * (8 + 4 + 4 + 4 + 8)
    for name in ("i64", "f32", "i32", "d", "ts"):
        assert not views[name].flags.writeable, name
    assert views["nullable"] is None


def test_stage_column_leaves_a_cpu_bound_column_to_the_copied_path():
    t = pa.table({"a": np.arange(100, dtype=np.int64)})
    f = Schema.from_arrow(t.schema).field("a")
    assert staging.stage_column(t.column("a"), f, torch.device("cpu")) is None


def test_to_arrow_keeps_strings_dictionary_coded():
    ct = ColumnTable.from_arrow(pa.table({"s": pa.array(["b", "a", "b", None])}), device="cpu")
    back = ct.to_arrow()
    assert pa.types.is_dictionary(back.column("s").type)
    assert back.column("s").to_pylist() == ["b", "a", "b", None]
    again = ColumnTable.from_arrow(back, device="cpu")
    assert list(again.dictionaries["s"]) == list(ct.dictionaries["s"])
    np.testing.assert_array_equal(again.columns["s"].numpy(), ct.columns["s"].numpy())


# -- the device.stage fault point ----------------------------------------------


def test_transient_stage_fault_degrades_to_the_copied_path():
    t = pa.table({"a": np.arange(100, dtype=np.int64), "b": np.arange(100, dtype=np.float64)})
    f0 = stats.get("faults.injected")
    with faults.injected("device.stage"):
        assert _views(t) == {"a": None, "b": None}
    assert stats.get("faults.injected") - f0 == 2
    assert all(v is not None for v in _views(t).values())  # disarmed: views again


def test_stage_crash_is_a_hard_death():
    t = pa.table({"a": np.arange(100, dtype=np.int64)})
    with faults.injected("device.stage", crash=True):
        with pytest.raises(faults.CrashPoint):
            _views(t)
    assert _views(t)["a"] is not None


def test_stage_fault_off_switch_disarms(tmp_path):
    t = pa.table({"a": np.arange(100, dtype=np.int64)})
    session = htorch.HyperspaceSession(system_path=str(tmp_path), device="cpu")
    session.conf.set("hyperspace.faults.enabled", False)
    with faults.injected("device.stage"):
        assert _views(t)["a"] is not None
    session.conf.set("hyperspace.faults.enabled", True)
