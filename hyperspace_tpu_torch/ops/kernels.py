"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under `hyperspace_tpu_torch/csrc/` with
a plain C interface. At first use it is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library under `build/kernels/` at the root of the
checkout, named by a hash of the source, and loaded with `ctypes`. Nothing
is built or loaded when a module is imported: the CPU path never needs
`nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from hyperspace_tpu_torch.exceptions import HyperspaceError

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "segment_reduce": _PKG / "csrc" / "segment_reduce.cu",
    "run_bounds": _PKG / "csrc" / "run_bounds.cu",
    "topk": _PKG / "csrc" / "topk.cu",
}
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (the toolkit's usual prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    under_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if under_home.exists():
        return str(under_home)
    raise HyperspaceError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str) -> Path:
    src = SOURCES[name].read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every named kernel (default: all) that is not built yet,
    one `nvcc` per source, all started together. Returns name → library
    path. Raises with the compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = {}
    for n, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failures = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{n}: nvcc exit {proc.returncode}\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out[n])  # atomic: concurrent builders agree
    if failures:
        raise HyperspaceError("kernel build failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
