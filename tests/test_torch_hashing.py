"""Row hashes and bucket ids of the port, bit for bit against the JAX package.

The same seeded numpy columns (with nulls) go through the JAX package's
`execution/build_exchange.py::compute_row_hashes` / `hash_scalar_key` and
the port's copies; the uint32 hashes and the bucket ids must be identical,
or an index built by one package would prune to the wrong bucket in the
other. The sort lanes and the device sort order are held to the JAX
package's the same way: they fix the row order inside each bucket file.
"""

import numpy as np
import pyarrow as pa
import pytest

from hyperspace_tpu.execution.build_exchange import compute_row_hashes as jax_row_hashes
from hyperspace_tpu.execution.build_exchange import hash_scalar_key as jax_scalar_key
from hyperspace_tpu.execution.table import ColumnTable as JaxTable
from hyperspace_tpu.ops.hashing import bucket_ids as jax_bucket_ids
from hyperspace_tpu.schema import Schema as JaxSchema
from hyperspace_tpu_torch.interop import table_from_numpy
from hyperspace_tpu_torch.ops.hashing import bucket_ids, compute_row_hashes, hash_scalar_key
from hyperspace_tpu_torch.schema import Field, Schema

N = 2_000


def _columns(rng):
    nulls = rng.random(N) < 0.1
    words = np.array(["", "a", "bb", "ccc", "ünï", "zz top"], dtype=object)
    return {
        "i32": np.ma.masked_array(rng.integers(-(2**31), 2**31 - 1, N).astype(np.int32), nulls),
        "i64": np.ma.masked_array(rng.integers(-(2**62), 2**62, N).astype(np.int64), np.roll(nulls, 1)),
        "f32": np.ma.masked_array(rng.normal(size=N).astype(np.float32), np.roll(nulls, 2)),
        "f64": np.ma.masked_array(rng.normal(size=N) * 1e9, np.roll(nulls, 3)),
        "b": np.ma.masked_array(rng.random(N) < 0.5, np.roll(nulls, 4)),
        "dt": np.ma.masked_array(rng.integers(0, 20_000, N).astype(np.int32), np.roll(nulls, 5)),
        "s": np.where(np.roll(nulls, 6), None, words[rng.integers(0, len(words), N)]),
    }


SCHEMA = Schema.of(
    Field("i32", "int32", True),
    Field("i64", "int64", True),
    Field("f32", "float32", True),
    Field("f64", "float64", True),
    Field("b", "bool", True),
    Field("dt", "date", True),
    Field("s", "string", True),
)


def _tables():
    cols = _columns(np.random.default_rng(7))
    port = table_from_numpy(cols, SCHEMA, device="cpu")
    ref = JaxTable.from_arrow(port.to_arrow(), JaxSchema.from_json(SCHEMA.to_json()))
    return port, ref


@pytest.mark.parametrize(
    "keys",
    [["i32"], ["i64"], ["f32"], ["f64"], ["b"], ["dt"], ["s"], ["i64", "s"], ["s", "f32", "dt", "b"]],
    ids=lambda k: "+".join(k),
)
def test_row_hashes_and_buckets_are_bit_identical(keys):
    port, ref = _tables()
    got = compute_row_hashes(port, keys)
    want = jax_row_hashes(ref, keys)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    for nb in (1, 8, 200):
        np.testing.assert_array_equal(bucket_ids(got, nb), jax_bucket_ids(want, nb, np))


@pytest.mark.parametrize(
    "values,dtypes",
    [
        ([0], ["int64"]),
        ([-(2**63)], ["int64"]),
        ([123456789], ["int32"]),
        ([1.5], ["float64"]),
        ([-0.25], ["float32"]),
        ([True], ["bool"]),
        ([19000], ["date"]),
        (["bb"], ["string"]),
        ([77, "ünï"], ["int64", "string"]),
    ],
)
def test_scalar_key_hash_is_bit_identical(values, dtypes):
    fields = [Field(f"c{i}", d) for i, d in enumerate(dtypes)]
    jfields = [JaxSchema.from_json([f.to_json()]).fields[0] for f in fields]
    np.testing.assert_array_equal(hash_scalar_key(values, fields), jax_scalar_key(values, jfields))


def test_scalar_key_hash_finds_the_row_hash_bucket():
    port, _ = _tables()
    row = 17
    keys = ["i64", "s"]
    decoded = port.decode()
    values = [decoded[k][row] for k in keys]
    assert all(v is not None for v in values)
    fields = [port.schema.field(k) for k in keys]
    assert hash_scalar_key(values, fields)[0] == compute_row_hashes(port, keys)[row]


def test_table_from_numpy_keeps_nulls_and_values():
    cols = _columns(np.random.default_rng(3))
    t = table_from_numpy(cols, SCHEMA, device="cpu")
    dec = t.decode()
    for name, arr in cols.items():
        if isinstance(arr, np.ma.MaskedArray):
            mask = np.ma.getmaskarray(arr)
            assert [v is None for v in dec[name]] == list(mask)
            np.testing.assert_array_equal(
                np.asarray(dec[name][~mask], dtype=arr.dtype), np.ma.getdata(arr)[~mask]
            )
        else:
            assert list(dec[name]) == list(arr)
    assert pa.types.is_dictionary(t.to_arrow().column("s").type)


def test_table_from_numpy_defaults_to_the_card(monkeypatch):
    import torch

    from hyperspace_tpu_torch.exceptions import HyperspaceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HyperspaceError, match="CUDA"):
        table_from_numpy(_columns(np.random.default_rng(3)), SCHEMA)


@pytest.mark.parametrize(
    "keys", [["i64"], ["f32", "s"], ["s", "dt", "b"], ["f64", "i32"]], ids=lambda k: "+".join(k)
)
def test_device_sort_matches_the_jax_lane_order(keys):
    """The port's LSD stable torch.sort over int64 lanes reproduces the JAX
    package's `lexsort_lanes` order (ties keep row order), and its lane
    decomposition is the JAX package's, lane for lane."""
    import torch

    from hyperspace_tpu.ops.sortkeys import key_lanes as jax_key_lanes
    from hyperspace_tpu.ops.sortkeys import lanes_as_unsigned as jax_unsigned
    from hyperspace_tpu.ops.sortkeys import lexsort_lanes
    from hyperspace_tpu_torch.ops.sortkeys import device_sort_perm, key_lanes, lanes_as_unsigned

    port, ref = _tables()
    lanes, want_lanes = key_lanes(port, keys), jax_key_lanes(ref, keys)
    assert len(lanes) == len(want_lanes)
    for got, want in zip(lanes, want_lanes):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lanes_as_unsigned(lanes), jax_unsigned(want_lanes))
    perm = device_sort_perm(port, keys, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(perm, lexsort_lanes(want_lanes))
