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

A copy of the JAX package's `ops/hashing.py` on the host: each function
dispatches to the native library (`hyperspace_tpu_torch/native`,
bit-identical to the numpy path by test) and runs its numpy path only
where the caller turned the library off. The build hashes on the host, as
the JAX package's builder does. The row hash of a table,
`compute_row_hashes`, and of one key tuple, `hash_scalar_key`, live in
`execution/build_exchange.py` (as in the JAX package) and are re-exported
here.
"""

from __future__ import annotations

import hashlib

import numpy as np

from hyperspace_tpu_torch import native


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
        out = native.hash_i64(arr.view(np.int64))
        if out is not None:
            return out
        lo = (arr & 0xFFFFFFFF).astype(np.uint32)
        hi = ((arr >> 32) & 0xFFFFFFFF).astype(np.uint32)
        return _mix32(lo ^ (_mix32(hi) * np.uint32(0x9E3779B1)))
    # A 32-bit lane: narrower integers widen as `astype(np.uint32)` does.
    out = native.hash_i32(arr.view(np.int32) if arr.dtype.itemsize == 4 else arr.astype(np.int32))
    if out is not None:
        return out
    return _mix32(arr.astype(np.uint32))


def string_dict_hashes(dictionary: np.ndarray) -> np.ndarray:
    """uint32 hash per dictionary entry, a pure function of the bytes
    (md5 prefix) — stable across processes and dictionaries."""
    out = native.md5_prefix(dictionary)
    if out is not None:
        return out
    out = np.empty(len(dictionary), dtype=np.uint32)
    for i, s in enumerate(dictionary):
        h = hashlib.md5(str(s).encode("utf-8")).digest()
        out[i] = int.from_bytes(h[:4], "little")
    return out


def combine_hashes(hashes: list) -> np.ndarray:
    """Order-dependent combine of per-column uint32 hashes."""
    acc = hashes[0]
    for h in hashes[1:]:
        nat = native.combine(acc, h)
        acc = _mix32(acc * np.uint32(31) + h) if nat is None else nat
    return acc


def bucket_ids(hashes: np.ndarray, num_buckets: int) -> np.ndarray:
    """Map uint32 hashes to bucket ids [0, num_buckets) as int32."""
    return (hashes % np.uint32(num_buckets)).astype(np.int32)


_REEXPORTS = ("NULL_HASH", "compute_row_hashes", "hash_scalar_key")


def __getattr__(name: str):
    """The row-hash names re-exported from execution/build_exchange.py,
    resolved at first use (build_exchange imports this module)."""
    if name in _REEXPORTS:
        from hyperspace_tpu_torch.execution import build_exchange

        return getattr(build_exchange, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
