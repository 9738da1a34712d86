"""Loader for the native host kernels (`hashing.cpp`).

A port of the JAX package's `native/__init__.py`: the same C++ source and
entry points, bound with `ctypes` (no pybind11). The build differs:

- the library is compiled with g++ at first use into `build/native/` at
  the root of the checkout (`.gitignore` lists `build/`), as
  `ops/kernels.py` builds the CUDA kernels into `build/kernels/`;
- it is compiled WITHOUT `-march=native`, so one library serves every
  x86-64 host that shares the checkout (a library tuned for one CPU can
  die with SIGILL on another); its file name holds a hash of the source,
  the flags, `platform.machine()` and the C library's version (a library
  linked against a newer glibc does not load on an older one);
- a failed build or load raises `HyperspaceError` with the compiler's
  message. There is no silent retreat to numpy: the numpy path runs only
  where the caller turned the library off with the environment variable
  `HYPERSPACE_TORCH_DISABLE_NATIVE` (the port's counterpart of the JAX
  package's `HYPERSPACE_TPU_DISABLE_NATIVE`), and then every wrapper
  returns None, its callers' sign to take their numpy path.

`available()` says which path is active. The host venues run on
`bucket_perm` (the build's and the exchange's counting sort by bucket),
`sort_range` (a bucket's key sort), `merge_join_sorted` (the join merge)
and `merge_join_accumulate` (the fused Aggregate(Join)'s channel pass).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

from hyperspace_tpu_torch.exceptions import HyperspaceError

_SRC = Path(__file__).with_name("hashing.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
DISABLE_ENV = "HYPERSPACE_TORCH_DISABLE_NATIVE"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def disabled() -> bool:
    """True where the caller turned the library off."""
    return bool(os.environ.get(DISABLE_ENV))


def library_path() -> Path:
    host = f"{platform.machine()} {' '.join(platform.libc_ver())}"
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode() + host.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libhs_native-{platform.machine()}-{digest}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # A name of this process's own: concurrent builders (the pooled build's
    # workers) never interleave writes into one file, and os.replace
    # publishes a whole library.
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise HyperspaceError(f"native library build failed ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise HyperspaceError(
            f"native library build failed ({' '.join(cmd)}), exit {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.hs_hash_i64.argtypes = [i64p, u32p, ctypes.c_int64]
    lib.hs_hash_i32.argtypes = [i32p, u32p, ctypes.c_int64]
    lib.hs_md5_prefix.argtypes = [u8p, i64p, u32p, ctypes.c_int64]
    lib.hs_take_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64p, ctypes.c_int64, ctypes.c_int64]
    lib.hs_combine.argtypes = [u32p, u32p, ctypes.c_int64]
    lib.hs_sort_range.argtypes = [i64p, ctypes.c_int64, u32p, ctypes.c_int64, ctypes.c_int64]
    lib.hs_bucket_perm.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i64p, i64p]
    lib.hs_mj_count.argtypes = [i32p, i64p, i32p, i64p, ctypes.c_int64, i64p]
    lib.hs_mj_fill.argtypes = [i32p, i64p, i32p, i64p, i64p, ctypes.c_int64, i64p, i64p]
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.hs_mj_accum.argtypes = [
        i32p, i64p, i32p, i64p, ctypes.c_int64, f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f64p, f64p,
    ]
    return lib


def _load() -> ctypes.CDLL | None:
    """The bound library, built at first use; None where it is turned off.
    Raises HyperspaceError where it cannot be built or loaded."""
    global _lib
    if disabled():
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = _build()
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except OSError as e:
                raise HyperspaceError(f"native library {path} failed to load: {e}") from e
    return _lib


def available() -> bool:
    """True when the native path is active (built and loaded); False where
    the caller turned it off. Raises where it cannot be built."""
    return _load() is not None


def path_taken() -> str:
    """"native" or "numpy": the host hash and sort path in use."""
    return "native" if available() else "numpy"


# ---- typed wrappers (None: the caller turned the library off) --------------

def hash_i64(arr: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, dtype=np.int64)
    out = np.empty(len(arr), dtype=np.uint32)
    lib.hs_hash_i64(arr, out, len(arr))
    return out


def hash_i32(arr: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    out = np.empty(len(arr), dtype=np.uint32)
    lib.hs_hash_i32(arr, out, len(arr))
    return out


def md5_prefix(strings: np.ndarray) -> np.ndarray | None:
    """uint32 md5-prefix per entry of an object array of strings."""
    lib = _load()
    if lib is None:
        return None
    encoded = [str(s).encode("utf-8") for s in strings]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    blob = np.frombuffer(b"".join(encoded), dtype=np.uint8) if encoded else np.zeros(0, np.uint8)
    blob = np.ascontiguousarray(blob)
    out = np.empty(len(encoded), dtype=np.uint32)
    lib.hs_md5_prefix(blob if len(blob) else np.zeros(1, np.uint8), offsets, out, len(encoded))
    return out


def take_rows(arr: np.ndarray, idx: np.ndarray) -> np.ndarray | None:
    """arr[idx] for 1-D/2-D contiguous arrays, threaded."""
    lib = _load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    row_bytes = arr.dtype.itemsize * (arr.shape[1] if arr.ndim == 2 else 1)
    out = np.empty((len(idx),) + arr.shape[1:], dtype=arr.dtype)
    lib.hs_take_rows(
        arr.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p), idx, len(idx), row_bytes,
    )
    return out


def bucket_perm(bucket: np.ndarray, num_buckets: int) -> tuple[np.ndarray, np.ndarray] | None:
    """Stable counting sort of row ids by bucket: (perm int64, per-bucket
    counts int64)."""
    lib = _load()
    if lib is None:
        return None
    bucket = np.ascontiguousarray(bucket, dtype=np.int32)
    perm = np.empty(len(bucket), dtype=np.int64)
    counts = np.zeros(num_buckets, dtype=np.int64)
    lib.hs_bucket_perm(bucket, len(bucket), num_buckets, perm, counts)
    return perm, counts


def sort_range(perm_slice: np.ndarray, lanes_u32: np.ndarray) -> bool:
    """In-place stable key sort of a contiguous int64 permutation by the
    [L, n] unsigned lanes (the GIL is released). False where the library
    is turned off."""
    lib = _load()
    if lib is None:
        return False
    if not (perm_slice.flags.c_contiguous and perm_slice.dtype == np.int64):
        raise HyperspaceError("sort_range needs a contiguous int64 permutation")
    lanes_u32 = np.ascontiguousarray(lanes_u32, dtype=np.uint32)
    num_lanes = lanes_u32.shape[0] if lanes_u32.ndim == 2 else 0
    lib.hs_sort_range(
        perm_slice, len(perm_slice),
        lanes_u32 if num_lanes else np.zeros((1, 1), np.uint32),
        lanes_u32.shape[1] if num_lanes else 0, num_lanes,
    )
    return True


def merge_join_accumulate(
    lk: np.ndarray, lofs: np.ndarray, rk: np.ndarray, rofs: np.ndarray, rvals: np.ndarray,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Fused merge + accumulate over within-bucket-sorted int32 codes: per
    SORTED primary row, the channel sums of its matching secondary rows and
    its match count, without materializing the pairs. `rvals` is [A, n_r]
    float64; returns (out [A, n_l], counts [n_l])."""
    lib = _load()
    if lib is None:
        return None
    lk = np.ascontiguousarray(lk, dtype=np.int32)
    rk = np.ascontiguousarray(rk, dtype=np.int32)
    lofs = np.ascontiguousarray(lofs, dtype=np.int64)
    rofs = np.ascontiguousarray(rofs, dtype=np.int64)
    rvals = np.ascontiguousarray(rvals, dtype=np.float64)
    a_r = rvals.shape[0]
    n_r, n_l = len(rk), len(lk)
    out = np.zeros((a_r, n_l), dtype=np.float64)
    counts = np.zeros(n_l, dtype=np.float64)
    lib.hs_mj_accum(lk, lofs, rk, rofs, len(lofs) - 1, rvals if a_r else np.zeros((1, 1)), a_r, n_r, n_l, out, counts)
    return out, counts


def merge_join_sorted(
    lk: np.ndarray, lofs: np.ndarray, rk: np.ndarray, rofs: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Exact bucket-parallel merge join over within-bucket-sorted int32
    codes: (li, ri, totals), GLOBAL row indices (int64) in bucket-major
    match order and the per-bucket match counts."""
    lib = _load()
    if lib is None:
        return None
    lk = np.ascontiguousarray(lk, dtype=np.int32)
    rk = np.ascontiguousarray(rk, dtype=np.int32)
    lofs = np.ascontiguousarray(lofs, dtype=np.int64)
    rofs = np.ascontiguousarray(rofs, dtype=np.int64)
    nb = len(lofs) - 1
    counts = np.zeros(nb, dtype=np.int64)
    lib.hs_mj_count(lk, lofs, rk, rofs, nb, counts)
    oofs = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=oofs[1:])
    total = int(oofs[-1])
    li = np.empty(total, dtype=np.int64)
    ri = np.empty(total, dtype=np.int64)
    lib.hs_mj_fill(lk, lofs, rk, rofs, oofs, nb, li, ri)
    return li, ri, counts


def combine(acc: np.ndarray, h: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    acc = np.ascontiguousarray(acc, dtype=np.uint32).copy()
    lib.hs_combine(acc, np.ascontiguousarray(h, dtype=np.uint32), len(acc))
    return acc
