"""Filesystem helpers for the metadata plane.

Reference parity: util/FileUtils.scala:28-117 (create/read/delete/byte IO).
The load-bearing primitive here is `atomic_write`: the operation log's
optimistic concurrency is "write temp file, atomically link to final name;
loser of the race gets False" (reference: index/IndexLogManager.scala:138-154,
which uses Hadoop's atomic rename). On POSIX we get compare-and-swap via
`os.link` (fails with EEXIST if the target already exists) which, unlike
`os.rename`, does not clobber.

A copy of the JAX package's module, with its fault points
(`file.atomic_write`, `file.write_json`), the transient-IO retry of
`write_json` and the lock-file fallback of `atomic_write` for
filesystems without hard links.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any

from hyperspace_tpu_torch.faults import fault_point
from hyperspace_tpu_torch.utils import retry


def ensure_dir(path: str | os.PathLike) -> None:
    Path(path).mkdir(parents=True, exist_ok=True)


def fsync_dir(path: str | os.PathLike) -> None:
    """fsync a directory: POSIX makes a rename/link durable only once the
    parent directory's entry is flushed separately — without this, the
    `latestStable` pointer (and any os.replace commit) can vanish on
    power loss even though the data file's bytes were fsynced."""
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

    Returns True on success, False when the CAS is lost: `path` already
    exists (a concurrent writer won), or — on the degraded no-hardlink
    fallback only — a concurrent writer holds the lock lease (including a
    writer that crashed less than _LOCK_STALE_S ago; callers treat any
    False as contention and may retry). Never overwrites an existing file.
    """
    path = Path(path)
    ensure_dir(path.parent)
    fault_point("file.atomic_write", path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-", suffix=path.name)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)  # CAS: fails iff path exists
            fsync_dir(path.parent)
            return True
        except FileExistsError:
            return False
        except OSError:
            # Filesystem without hard links (FUSE/SMB/some overlays). The
            # tmp file already holds the full fsynced payload; serialize
            # the visibility rename behind an O_EXCL lock file so two
            # writers can never both pass the existence check (content is
            # never torn either way — rename is atomic).
            return _locked_rename(tmp, path)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


# Lease duration for the no-hardlink lock-file fallback. A crashed
# writer's lock older than this is presumed dead and reaped. Staleness is
# judged from an epoch the CREATOR wrote into the lock file (never from
# filesystem mtime — network filesystems stamp mtime with the SERVER's
# clock), so single-winner correctness assumes inter-writer clock skew
# below this bound — the standard lease-lock assumption.
_LOCK_STALE_S = 30.0


def _read_lock_text(p: Path) -> str | None:
    try:
        with open(p, "r") as f:
            return f.read()
    except OSError:
        return None


def _lock_epoch(text: str | None) -> float | None:
    """Creator epoch out of a lock token ('<epoch>:<uuid>'); None means
    unreadable/torn — treated as stale, which is safe because a mis-stolen
    live lock is detected by token mismatch and by the holder's pre-commit
    re-verification."""
    if not text or ":" not in text:
        return None
    try:
        return float(text.split(":", 1)[0])
    except ValueError:
        return None


def _try_reap(lock: Path, nonce: str) -> bool:
    """Clear `lock` if stale. True ⇒ cleared (caller may retry the
    acquire); False ⇒ a live contender holds it (CAS lost). The claim is
    atomic — rename to a unique name, exactly one reaper wins — and
    verified: stealing a lock instance OTHER than the one judged stale is
    detected by content mismatch and the stolen token is reinstalled."""
    import time

    text = _read_lock_text(lock)
    if text is None:
        return True  # vanished underneath us — retry the acquire
    ep = _lock_epoch(text)
    if ep is None:
        # Token missing/torn: the holder may be BETWEEN its O_EXCL create
        # and its token write — judge by file age instead (the only case
        # where mtime, with its server-clock caveat, is consulted), so a
        # live-but-not-yet-written lease is not reaped.
        try:
            # Wall clock on purpose (cross-process lease vs file mtime).
            if time.time() - os.stat(lock).st_mtime <= _LOCK_STALE_S:  # noqa: HSL007
                return False
        except OSError:
            return True  # vanished — retry the acquire
    elif time.time() - ep <= _LOCK_STALE_S:  # noqa: HSL007 — persisted epoch token
        return False
    reaped = lock.with_name(f"{lock.name}.reap-{nonce}")
    try:
        os.rename(lock, reaped)
    except OSError:
        return False  # another reaper won
    stolen = _read_lock_text(reaped)
    try:
        os.unlink(reaped)
    except OSError:
        pass
    if stolen != text:
        # Between our read and the rename the stale lock was replaced by a
        # NEW (live) instance — reinstall its token so later writers still
        # see a held lease; its holder aborts via pre-commit verification
        # only if this reinstall loses a further race.
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            try:
                os.write(fd, (stolen or "").encode())
            finally:
                os.close(fd)
        except OSError:
            pass
        return False
    return True


def _locked_rename(tmp: str, path: Path) -> bool:
    """Compare-and-swap via an O_EXCL lock file (the no-hardlink fallback
    for atomic_write): only the lock holder may check-and-rename. The
    holder re-reads its own token immediately before committing, so a
    writer whose lease was (wrongly) reaped aborts instead of producing a
    second winner. Residual lease-lock hazard (inherent to leases): a
    holder paused for longer than _LOCK_STALE_S between that check and
    its rename can still commit over a successor's write — bounded-pause
    is assumed alongside bounded clock skew."""
    import time
    import uuid

    lock = path.with_name(path.name + ".lock")
    token = f"{time.time():.6f}:{uuid.uuid4().hex}"
    for attempt in range(3):
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # uuid nonce: concurrent reapers (even same-pid threads) must
            # never collide on the claim name.
            if not _try_reap(lock, f"{os.getpid()}-{uuid.uuid4().hex[:8]}-{attempt}"):
                return False
            continue
        except OSError:
            return False
        try:
            with os.fdopen(fd, "w") as f:
                f.write(token)
                f.flush()
                os.fsync(f.fileno())
        except OSError:  # noqa: HSL017 — not a retry: an unwritten token
            # simply fails the lease check below and the claim returns
            # False in-band.
            pass
        try:
            if path.exists():
                return False
            if _read_lock_text(lock) != token:
                return False  # our lease was stolen — do not double-commit
            try:
                os.rename(tmp, path)
                fsync_dir(path.parent)
                return True
            except OSError:
                return False
        finally:
            if _read_lock_text(lock) == token:
                try:
                    os.unlink(lock)
                except OSError:  # noqa: HSL017 — lease-file cleanup only;
                    # a leftover lock is reaped by the next claimant.
                    pass
    return False


def write_json(path: str | os.PathLike, obj: Any, *, overwrite: bool = True) -> bool:
    data = json.dumps(obj, indent=2, sort_keys=False).encode()
    if overwrite:
        path = Path(path)
        ensure_dir(path.parent)
        retry.retry_call(_overwrite_json, path, data)
        return True
    return retry.retry_call(atomic_write, path, data)


def _overwrite_json(path: Path, data: bytes) -> None:
    """Torn-write-proof overwrite: fsync the payload BEFORE the rename
    (an unfsynced os.replace can surface as an empty/partial file after
    power loss — the exact torn `latestStable` the backward scan exists
    to survive) and fsync the parent dir after, so the commit itself is
    durable."""
    fault_point("file.write_json", path)
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
