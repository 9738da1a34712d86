"""Deterministic vectorized hashing for bucket assignment.

The analog of Spark's HashPartitioning under `repartition(numBuckets, cols)`
(reference hot path actions/CreateActionBase.scala:108-112): every row is
assigned `bucket = hash(key columns) % num_buckets`. The hash must be

- identical at build time and at query time, so bucket pruning by a
  literal's hash finds the bucket the build wrote the row to;
- dictionary-independent for strings: the hash is a function of the string
  BYTES (per-dictionary hashes gathered through codes), never of the codes;
- 32-bit: int64 inputs are split into hi/lo words and mixed (murmur3
  finalizer).

A copy of the numpy path of the JAX package's `ops/hashing.py` (without
its C++ dispatch, which the JAX package proves bit-identical to this
path). The build hashes on the host, as the JAX package's builder does.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _mix32(x):
    """murmur3 fmix32 — avalanche a uint32 lane."""
    x = np.asarray(x).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def hash_int_column(arr: np.ndarray) -> np.ndarray:
    """Hash an integer/bool/float column to uint32.

    int64/float64 are viewed as two 32-bit words and both words mixed;
    32-bit types mix directly."""
    if arr.dtype == np.float32:
        arr = arr.view(np.int32)
    if arr.dtype == np.float64:
        arr = arr.view(np.int64)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.int32)
    if arr.dtype in (np.dtype(np.int64), np.dtype(np.uint64)):
        lo = (arr & 0xFFFFFFFF).astype(np.uint32)
        hi = ((arr >> 32) & 0xFFFFFFFF).astype(np.uint32)
        return _mix32(lo ^ (_mix32(hi) * np.uint32(0x9E3779B1)))
    return _mix32(arr.astype(np.uint32))


def string_dict_hashes(dictionary: np.ndarray) -> np.ndarray:
    """uint32 hash per dictionary entry, a pure function of the bytes
    (md5 prefix) — stable across processes and dictionaries."""
    out = np.empty(len(dictionary), dtype=np.uint32)
    for i, s in enumerate(dictionary):
        h = hashlib.md5(str(s).encode("utf-8")).digest()
        out[i] = int.from_bytes(h[:4], "little")
    return out


def combine_hashes(hashes: list) -> np.ndarray:
    """Order-dependent combine of per-column uint32 hashes."""
    acc = hashes[0]
    for h in hashes[1:]:
        acc = _mix32(acc * np.uint32(31) + h)
    return acc


def bucket_ids(hashes: np.ndarray, num_buckets: int) -> np.ndarray:
    """Map uint32 hashes to bucket ids [0, num_buckets) as int32."""
    return (hashes % np.uint32(num_buckets)).astype(np.int32)


# The fixed hash contribution of a NULL key slot: nulls bucket
# deterministically (they can never match an equality literal, so bucket
# pruning by literal hash stays correct regardless).
NULL_HASH = np.uint32(0x9E3779B9)


def compute_row_hashes(table, key_columns: list[str]) -> np.ndarray:
    """Host uint32 row hash over the key columns of a ColumnTable (the JAX
    package's `execution/build_exchange.py::compute_row_hashes`)."""
    hashes = []
    for name in key_columns:
        f = table.schema.field(name)
        arr = table.host_column(name)
        if f.is_string:
            h = string_dict_hashes(table.dictionaries[f.name])[arr]
        else:
            h = hash_int_column(arr)
        valid = table.host_valid_mask(name)
        if valid is not None:
            h = np.where(valid, h, NULL_HASH)
        hashes.append(h)
    return combine_hashes(hashes)


def hash_scalar_key(values: list, fields) -> np.ndarray:
    """Hash one key tuple (for bucket pruning at query time)."""
    hs = []
    for v, f in zip(values, fields):
        if f.is_string:
            hs.append(string_dict_hashes(np.array([v], dtype=object)))
        else:
            hs.append(hash_int_column(np.array([v], dtype=f.device_dtype)))
    return combine_hashes(hs)
