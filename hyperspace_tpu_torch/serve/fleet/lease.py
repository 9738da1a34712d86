"""Cross-process file leases: the fleet's only coordination primitive.

A port of the JAX package's `serve/fleet/lease.py`, token for token: a
lease either package holds blocks the other's claim.

A lease is one file whose content is ``<epoch>:<pid>:<uuid>`` — created
with ``O_CREAT|O_EXCL`` (exactly one winner per claim, POSIX-atomic on
every filesystem the metadata plane already trusts) and judged stale by
the CREATOR-written epoch, never by filesystem mtime (network
filesystems stamp mtime with the server's clock). This generalizes the
lock-file fallback `utils/file_utils.py` grew for no-hardlink
filesystems into a reusable primitive for the fleet's single-flight and
eviction protocols (serve/fleet/).

The load-bearing property is **crash safety**: a holder that is
SIGKILLed mid-build leaves its lease file behind, and the next claimant
reaps it once the epoch is older than the TTL — so a dead process can
never wedge the fleet; at worst it delays one build by the TTL. The
reap itself is atomic (rename to a unique claim name, exactly one
reaper wins) and verified: if the content under the rename turns out to
belong to a NEWER (live) lease, its token is reinstalled and the reap
reports failure. Single-winner correctness therefore assumes the
standard lease-lock bounds: inter-process clock skew and holder pauses
below the TTL.
"""

from __future__ import annotations

import os
import time
import uuid
from pathlib import Path

from hyperspace_tpu_torch.faults import fault_point


def _read_text(p: Path) -> str | None:
    try:
        with open(p, "r") as f:
            return f.read()
    except OSError:
        return None


def _token_epoch(text: str | None) -> float | None:
    if not text or ":" not in text:
        return None
    try:
        return float(text.split(":", 1)[0])
    except ValueError:
        return None


class FileLease:
    """One named lease file with a TTL. `try_acquire` returns the token
    on success (pass it back to `release`), None when a live contender
    holds the lease. Stateless between calls — any process (including a
    freshly restarted one) can operate on the same path."""

    def __init__(self, path: str | os.PathLike, ttl_s: float):
        self.path = Path(path)
        self.ttl_s = float(ttl_s)

    def holder(self) -> str | None:
        """The current lease token, or None when unheld/unreadable."""
        return _read_text(self.path)

    def holder_note(self) -> str | None:
        """The holder's optional annotation (fourth token field) — the
        single-flight leader stamps its root trace id here so followers
        can link their wait span to the leader's trace. None on legacy
        three-field tokens or when unheld."""
        text = _read_text(self.path)
        if not text:
            return None
        parts = text.split(":", 3)
        return parts[3] or None if len(parts) == 4 else None

    def try_acquire(self, note: str | None = None) -> tuple[str, bool] | None:
        """Claim the lease. Returns ``(token, reaped)`` on success —
        `reaped` is True when the claim displaced a stale (crashed)
        holder — or None while a live contender holds it. `note` is an
        optional annotation carried as a fourth token field (readable
        via `holder_note`); epoch parsing ignores it, so three- and
        four-field tokens coexist on one lease path."""
        fault_point("fleet.lease.acquire", self.path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # Wall clock on purpose: the epoch must be comparable across
        # processes and survive the writer (monotonic clocks are
        # per-boot, not per-file).
        token = f"{time.time():.6f}:{os.getpid()}:{uuid.uuid4().hex}"
        if note:
            # One line, colon-delimited: strip both from the annotation.
            token += ":" + "".join(c for c in str(note) if c not in ":\n\r")[:128]
        reaped = False
        for attempt in range(3):
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if not self._reap(f"{os.getpid()}-{uuid.uuid4().hex[:8]}-{attempt}"):
                    return None
                reaped = True
                continue
            except OSError:
                return None
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(token)
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:  # not a retry: an unwritten
                # token fails the verification below and the claim is
                # reported lost in-band
                pass
            if _read_text(self.path) != token:
                return None  # torn write / concurrent steal — claim lost
            return token, reaped
        return None

    def release(self, token: str) -> None:
        """Drop the lease if (and only if) this token still holds it — a
        lease that was reaped from us while we were paused belongs to
        its new holder and must not be unlinked."""
        if _read_text(self.path) == token:
            try:
                os.unlink(self.path)
            except OSError:
                pass  # leftover lease is reaped by the next claimant

    def _reap(self, nonce: str) -> bool:
        """Clear the lease if its epoch is stale. True ⇒ cleared (retry
        the acquire); False ⇒ a live holder keeps it."""
        text = _read_text(self.path)
        if text is None:
            return True  # vanished underneath us — retry the acquire
        ep = _token_epoch(text)
        if ep is None:
            # Token missing/torn: the holder may sit BETWEEN its O_EXCL
            # create and its token write — judge by file age (the one
            # case where mtime is consulted) so a live-but-unwritten
            # lease is not reaped.
            try:
                if time.time() - os.stat(self.path).st_mtime <= self.ttl_s:
                    return False
            except OSError:
                return True
        elif time.time() - ep <= self.ttl_s:  # persisted epoch token
            return False
        claimed = self.path.with_name(f"{self.path.name}.reap-{nonce}")
        try:
            os.rename(self.path, claimed)
        except OSError:
            return False  # another reaper won
        stolen = _read_text(claimed)
        try:
            os.unlink(claimed)
        except OSError:
            pass
        if stolen != text:
            # Between our read and the rename the stale lease was
            # replaced by a NEW (live) instance — reinstall its token so
            # later claimants still see a held lease.
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                try:
                    os.write(fd, (stolen or "").encode())
                finally:
                    os.close(fd)
            except OSError:
                pass
            return False
        return True
