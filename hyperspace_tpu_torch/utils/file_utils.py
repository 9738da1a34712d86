"""Filesystem helpers for the metadata plane.

Reference parity: util/FileUtils.scala:28-117 (create/read/delete/byte IO).
The load-bearing primitive here is `atomic_write`: the operation log's
optimistic concurrency is "write temp file, atomically link to final name;
loser of the race gets False" (reference: index/IndexLogManager.scala:138-154,
which uses Hadoop's atomic rename). On POSIX we get compare-and-swap via
`os.link` (fails with EEXIST if the target already exists) which, unlike
`os.rename`, does not clobber.

A trimmed copy of the JAX package's module: the lock-file fallback for
filesystems without hard links is not ported, so `atomic_write` raises
there instead of degrading.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any


def ensure_dir(path: str | os.PathLike) -> None:
    Path(path).mkdir(parents=True, exist_ok=True)


def fsync_dir(path: str | os.PathLike) -> None:
    """fsync a directory: POSIX makes a rename/link durable only once the
    parent directory's entry is flushed separately."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return  # platform/filesystem without dir fds — best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str | os.PathLike, data: bytes) -> bool:
    """Atomically create `path` with `data`.

    Returns True on success, False when the CAS is lost (`path` already
    exists: a concurrent writer won). Never overwrites an existing file.
    """
    path = Path(path)
    ensure_dir(path.parent)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-", suffix=path.name)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)  # CAS: fails iff path exists
        except FileExistsError:
            return False
        fsync_dir(path.parent)
        return True
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def write_json(path: str | os.PathLike, obj: Any, *, overwrite: bool = True) -> bool:
    data = json.dumps(obj, indent=2, sort_keys=False).encode()
    if overwrite:
        path = Path(path)
        ensure_dir(path.parent)
        _overwrite_json(path, data)
        return True
    return atomic_write(path, data)


def _overwrite_json(path: Path, data: bytes) -> None:
    """Torn-write-proof overwrite: fsync the payload BEFORE the rename and
    fsync the parent dir after, so the commit itself is durable."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(path.parent)


def read_json(path: str | os.PathLike) -> Any:
    with open(path, "rb") as f:
        return json.loads(f.read())


def delete_recursively(path: str | os.PathLike) -> None:
    p = Path(path)
    if p.is_dir():
        shutil.rmtree(p, ignore_errors=True)
    elif p.exists():
        p.unlink(missing_ok=True)
