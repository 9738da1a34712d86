"""The port's native host hash against its numpy path and the JAX package's.

tests/test_native.py's six cases through the port (`hyperspace_tpu_torch/
native`, the same `hashing.cpp`): every dtype the hash takes, bit-identical
to the numpy reference. Then the cross-package cases: the port's hashes,
native and numpy, equal the JAX package's on the same seeded arrays and
tables; the library is turned off only by the environment variable, and
a failed build raises with the compiler's message instead of falling back
to numpy.
"""

import hashlib

import numpy as np
import pyarrow as pa
import pytest

from hyperspace_tpu.execution.build_exchange import compute_row_hashes as j_compute_row_hashes
from hyperspace_tpu.execution.table import ColumnTable as JTable
from hyperspace_tpu.ops import hashing as jhashing
from hyperspace_tpu_torch import native
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.build_exchange import compute_row_hashes
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops.hashing import _mix32, combine_hashes, hash_int_column, string_dict_hashes


def _reference_mix_i64(arr):
    lo = (arr & 0xFFFFFFFF).astype(np.uint32)
    hi = ((arr >> 32) & 0xFFFFFFFF).astype(np.uint32)
    return _mix32(lo ^ (_mix32(hi) * np.uint32(0x9E3779B1)))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def test_native_builds():
    assert native.available()
    assert native.path_taken() == "native"
    assert native.library_path().exists()
    assert native.library_path().parent.name == "native"


def test_hash_i64_parity(rng):
    arr = rng.integers(-(2**62), 2**62, 100_000).astype(np.int64)
    arr[:4] = [0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    assert np.array_equal(hash_int_column(arr), _reference_mix_i64(arr))


def test_hash_i32_and_float_parity(rng):
    i32 = rng.integers(-(2**31), 2**31 - 1, 50_000).astype(np.int32)
    assert np.array_equal(hash_int_column(i32), _mix32(i32.astype(np.uint32)))
    f32 = rng.standard_normal(50_000).astype(np.float32)
    assert np.array_equal(hash_int_column(f32), _mix32(f32.view(np.int32).astype(np.uint32)))
    f64 = rng.standard_normal(50_000)
    assert np.array_equal(hash_int_column(f64), _reference_mix_i64(f64.view(np.int64)))


def test_md5_prefix_parity():
    strs = np.array(["", "a", "hello world", "x" * 55, "y" * 56, "z" * 64, "w" * 120, "ü–😀"], dtype=object)
    expected = np.array(
        [int.from_bytes(hashlib.md5(str(s).encode("utf-8")).digest()[:4], "little") for s in strs],
        dtype=np.uint32,
    )
    assert np.array_equal(string_dict_hashes(strs), expected)


def test_combine_parity(rng):
    a = rng.integers(0, 2**32, 10_000).astype(np.uint32)
    b = rng.integers(0, 2**32, 10_000).astype(np.uint32)
    c = rng.integers(0, 2**32, 10_000).astype(np.uint32)
    expected = _mix32(_mix32(a * np.uint32(31) + b) * np.uint32(31) + c)
    assert np.array_equal(combine_hashes([a, b, c]), expected)


def test_take_rows_parity(rng):
    for arr in (
        rng.standard_normal((5_000, 3)),
        rng.integers(0, 100, 5_000).astype(np.int64),
        rng.standard_normal(5_000).astype(np.float32),
    ):
        idx = rng.permutation(len(arr))[:2_000]
        assert np.array_equal(native.take_rows(arr, idx), arr[idx])


# -- cross-package ------------------------------------------------------------

_DTYPES = ("int64", "int32", "float64", "float32", "bool", "int16")


def _column(rng, dtype, n=20_000):
    if dtype == "bool":
        return rng.integers(0, 2, n).astype(np.bool_)
    if dtype.startswith("float"):
        out = (rng.standard_normal(n) * 1e6).astype(dtype)
        out[:3] = [0.0, -0.0, np.nan]
        return out
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_native_numpy_and_jax_hashes_are_bit_identical(rng, monkeypatch, dtype):
    arr = _column(rng, dtype)
    got_native = hash_int_column(arr)
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    assert not native.available() and native.path_taken() == "numpy"
    got_numpy = hash_int_column(arr)
    monkeypatch.delenv(native.DISABLE_ENV)
    np.testing.assert_array_equal(got_native, got_numpy)
    if dtype != "int16":  # the JAX package's 32-bit lane views its input
        np.testing.assert_array_equal(got_native, jhashing.hash_int_column(arr, np))


def test_string_and_combine_hashes_equal_numpy_path_and_jax(rng, monkeypatch):
    words = np.array([f"w{i}-{'é' * (i % 5)}" for i in range(3_000)], dtype=object)
    a = rng.integers(0, 2**32, 3_000).astype(np.uint32)
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    numpy_strings, numpy_combined = string_dict_hashes(words), combine_hashes([a, a[::-1].copy()])
    np.testing.assert_array_equal(numpy_strings, jhashing.string_dict_hashes(words))
    np.testing.assert_array_equal(numpy_combined, jhashing.combine_hashes([a, a[::-1].copy()], np))
    monkeypatch.delenv(native.DISABLE_ENV)
    np.testing.assert_array_equal(string_dict_hashes(words), numpy_strings)
    np.testing.assert_array_equal(combine_hashes([a, a[::-1].copy()]), numpy_combined)


@pytest.mark.parametrize("keys", [["k"], ["s"], ["k", "s", "v"]])
def test_row_hashes_of_a_table_equal_the_jax_packages(rng, monkeypatch, keys):
    n = 5_000
    t = pa.table({
        "k": pa.array(rng.integers(-(10**12), 10**12, n), mask=rng.random(n) < 0.1),
        "s": pa.array([None if i % 17 == 0 else f"s{i % 97}" for i in range(n)]),
        "v": pa.array(rng.standard_normal(n)),
    })
    want = j_compute_row_hashes(JTable.from_arrow(t), keys)
    port = ColumnTable.from_arrow(t, device="cpu")
    np.testing.assert_array_equal(compute_row_hashes(port, keys), want)
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    np.testing.assert_array_equal(compute_row_hashes(port, keys), want)


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "hashing.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(HyperspaceError, match="native library build failed") as ei:
        native.available()
    assert "error" in str(ei.value)
    with pytest.raises(HyperspaceError):
        hash_int_column(np.arange(10, dtype=np.int64))
    assert not list((tmp_path / "build").glob("*.so"))
    # Turned off explicitly, the numpy path runs and nothing is built.
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    np.testing.assert_array_equal(
        hash_int_column(np.arange(10, dtype=np.int64)), _reference_mix_i64(np.arange(10, dtype=np.int64))
    )


def test_sort_range_is_the_stable_lexsort(rng):
    from hyperspace_tpu_torch.ops.sortkeys import lanes_as_unsigned, lexsort_lanes, value_lanes

    for arr in (rng.integers(-50, 50, 4_000), rng.standard_normal(4_000), rng.integers(0, 3, 4_000).astype(np.int32)):
        lanes = value_lanes(arr)
        perm = np.arange(len(arr), dtype=np.int64)
        assert native.sort_range(perm, lanes_as_unsigned(lanes))
        np.testing.assert_array_equal(perm, lexsort_lanes(lanes))
