"""Durable telemetry journal — the flight recorder under the obs plane.

A port of the JAX package's `obs/journal.py`, record for record and file
for file: segments either package writes read back through the other's
:func:`merge_dir`. The event ring (`obs/events.py`), trace ring (`obs/trace.py`) and the
metrics registry are in-memory and per-process: the moment a process
dies (or an `OpsController` actuation fires), the evidence that
justified it is already evaporating. This module gives runtime
telemetry the same durability story the paper gives index metadata — an
append-only, replayable journal on disk — without giving up the
advisory contract the obs plane promises (observability never fails a
query).

Shape
-----
One journal per process, under ``<root>/<pid>/`` (``root`` defaults to
``<system_path>/_obs``). Records are JSONL, one dict per line, each
with ``ts`` (wall clock — the only clock that correlates across
processes), ``pid`` and a ``kind``:

- ``event``    every structured event emitted through `obs.events`
- ``span``     every completed *root* span (workers' roots included)
- ``metrics``  periodic counter/gauge snapshots (at most one per
  ``snapshotSeconds``, taken opportunistically on the write path — no
  background thread)
- ``slo``      SLO verdict *transitions* (ok→page, page→ok, …)
- ``process``  a process-start marker written when a pooled/fleet
  worker installs shipped journal state

Records accumulate in an *active* segment: a ``.tmp-seg-*`` file
created with ``tempfile.mkstemp`` in the journal directory. When the
active segment reaches ``segmentBytes`` it is *sealed*: flush + fsync +
``os.replace`` to ``segment-<n>.jsonl`` + directory fsync — the same
atomic-publish idiom as ``file_utils._overwrite_json``, so readers
(the merge API, incident bundles) only ever see whole segments and a
crashed process leaves at most one torn ``.tmp-seg-*`` tail, which
merge skips and :func:`sweep` removes (the `recover()` analogue).

Retention is byte-budgeted per process: sealed segments beyond
``maxBytes`` are evicted oldest-first.

Contract
--------
Advisory, always: IO failures increment ``obs.journal.errors`` and are
swallowed; nothing here ever raises into a query or an actuation.
Disabled (the default) the tap is one boolean read — no IO, no locks
taken by callers.

Workers journal too: :func:`export_state` / :func:`install_state`
follow the `faults` cross-process pattern and ride the same ``env``
dict through `TaskPool.submit` and `FleetSupervisor._spawn`, so build
workers and serve fleet members write their own per-pid journals under
the shared root, ready for the fleet merge
(``python -m hyperspace_tpu_torch.obs.export --format chrome --fleet <dir>``).

Config: ``hyperspace.obs.journal.*``. Stdlib-only: no torch.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from pathlib import Path

from hyperspace_tpu_torch import faults
from hyperspace_tpu_torch.obs import metrics as _metrics

# Import-time counter handles (the scheduler idiom): `.inc()` never
# raises, so the taps stay safe inside narrow error contracts
# (Event.emit rides QueryServer.submit's `AdmissionRejected`-only
# surface).
_RECORDS = _metrics.counter("obs.journal.records", "journal records appended")
_ERRORS = _metrics.counter("obs.journal.errors", "journal IO failures (advisory)")
_SEALED = _metrics.counter("obs.journal.segments_sealed", "segments published")
_EVICTIONS = _metrics.counter("obs.journal.evictions", "segments evicted for the byte budget")

DEFAULT_SEGMENT_BYTES = 64 * 1024
DEFAULT_MAX_BYTES = 4 * 1024 * 1024
DEFAULT_SNAPSHOT_SECONDS = 5.0

SEGMENT_PREFIX = "segment-"
SEGMENT_SUFFIX = ".jsonl"
TMP_PREFIX = ".tmp-seg-"

_lock = threading.Lock()
_enabled = False
_root: str | None = None
_segment_bytes = DEFAULT_SEGMENT_BYTES
_max_bytes = DEFAULT_MAX_BYTES
_snapshot_s = DEFAULT_SNAPSHOT_SECONDS

_fh = None  # open file object for the active (tmp) segment
_fh_path: Path | None = None
_fh_bytes = 0
_fh_pid: int | None = None  # fork/spawn guard: never write an inherited handle
_next_seg: int | None = None
_last_snapshot = 0.0


# -- configuration --------------------------------------------------------
def configure(
    enabled: bool | None = None,
    root: str | None = None,
    segment_bytes: int | None = None,
    max_bytes: int | None = None,
    snapshot_s: float | None = None,
) -> None:
    """Reconfigure the process-global journal (config.py routes the
    ``hyperspace.obs.journal.*`` keys here). Any open active segment is
    sealed first so no records are stranded across a reconfigure."""
    global _enabled, _root, _segment_bytes, _max_bytes, _snapshot_s
    with _lock:
        _seal_locked()
        if enabled is not None:
            _enabled = bool(enabled)
        if root is not None:
            _root = str(root) if root else None
        if segment_bytes is not None:
            _segment_bytes = max(1024, int(segment_bytes))
        if max_bytes is not None:
            _max_bytes = max(4096, int(max_bytes))
        if snapshot_s is not None:
            _snapshot_s = max(0.1, float(snapshot_s))


def ensure_root(path: str | os.PathLike) -> None:
    """Fill in the journal root if none was configured explicitly —
    session/server wiring derives ``<system_path>/_obs`` through here
    without clobbering a user-set ``hyperspace.obs.journal.dir``."""
    global _root
    with _lock:
        if _root is None:
            _root = str(path)


def enabled() -> bool:
    # The disabled-tap fast path: one racy boolean read, no lock. Both
    # names are init-only publication (config writes, then taps read);
    # the worst interleaving skips or double-gates one record around a
    # reconfigure, which the advisory contract already tolerates.
    return _enabled and _root is not None  # noqa: HSL013


def configured_enabled() -> bool:
    """The enabled flag alone (config `get` surface; `enabled()` also
    requires a root)."""
    with _lock:
        return _enabled


def root() -> str | None:
    with _lock:
        return _root


def segment_bytes() -> int:
    with _lock:
        return _segment_bytes


def max_bytes() -> int:
    with _lock:
        return _max_bytes


def snapshot_seconds() -> float:
    with _lock:
        return _snapshot_s


# -- cross-process shipping (the `faults.export_state` pattern) ----------
def export_state() -> dict:
    """Picklable journal config for worker env dicts. The worker derives
    its own ``<root>/<pid>/`` directory — nothing per-process ships."""
    with _lock:
        return {
            "enabled": _enabled,
            "root": _root,
            "segment_bytes": _segment_bytes,
            "max_bytes": _max_bytes,
            "snapshot_s": _snapshot_s,
            "parent_pid": os.getpid(),
        }


def install_state(state: dict) -> None:
    """Install shipped journal config in a worker process and stamp a
    ``process`` record so merged timelines show when each member
    (re)started — supervisor-respawned members keep continuity."""
    if not isinstance(state, dict):
        return
    configure(
        enabled=state.get("enabled"),
        root=state.get("root"),
        segment_bytes=state.get("segment_bytes"),
        max_bytes=state.get("max_bytes"),
        snapshot_s=state.get("snapshot_s"),
    )
    if enabled():
        record_process(
            parent_pid=state.get("parent_pid"), worker_id=state.get("worker_id")
        )


# -- record taps ---------------------------------------------------------
def record(kind: str, **payload) -> None:
    """Append one record. Advisory: errors are counted, never raised."""
    if not enabled():
        return
    doc = {"ts": time.time(), "pid": os.getpid(), "kind": kind}
    doc.update(payload)
    with _lock:
        _append_locked(doc)


def record_event(event_record: dict) -> None:
    """Tap for `obs.events.Event.emit` — the full ring record."""
    if not enabled():
        return
    record("event", event=event_record)


def record_span(root_json: dict) -> None:
    """Tap for completed root spans (`obs.trace` close/adopt)."""
    if not enabled():
        return
    record("span", trace=root_json)


def record_slo(objective: str, verdict: str, previous: str, detail: dict | None = None) -> None:
    """Tap for SLO verdict transitions (`obs.slo.SLOTracker.evaluate`)."""
    if not enabled():
        return
    record("slo", objective=objective, verdict=verdict, previous=previous,
           detail=detail or {})


def record_process(**fields) -> None:
    """Process-start marker (worker install, controller open)."""
    if not enabled():
        return
    record("process", **fields)


def seal() -> None:
    """Seal the active segment now (incident-bundle capture, tests).
    No-op when there is nothing buffered."""
    with _lock:
        _seal_locked()


# -- write path (all advisory) -------------------------------------------
def _proc_dir() -> Path:
    return Path(_root) / str(os.getpid())


def _append_locked(doc: dict) -> None:
    global _fh_bytes, _last_snapshot
    try:
        if _fh is None or _fh_pid != os.getpid():
            _open_active_locked()
        line = json.dumps(doc, default=str, separators=(",", ":")) + "\n"
        _fh.write(line)
        _fh.flush()
        _fh_bytes += len(line)
        _RECORDS.inc()
        now = doc.get("ts") or time.time()
        if doc.get("kind") != "metrics" and now - _last_snapshot >= _snapshot_s:
            # Opportunistic counter/gauge snapshot on the write path —
            # no background thread, at most one per snapshotSeconds.
            _last_snapshot = now
            snap = {
                "ts": now,
                "pid": os.getpid(),
                "kind": "metrics",
                "metrics": _metrics.REGISTRY.snapshot(),
            }
            sline = json.dumps(snap, default=str, separators=(",", ":")) + "\n"
            _fh.write(sline)
            _fh.flush()
            _fh_bytes += len(sline)
            _RECORDS.inc()
        if _fh_bytes >= _segment_bytes:
            _seal_locked()
    except (OSError, ValueError):
        # Advisory: a full disk or unwritable root must never fail the
        # query/actuation being observed — count and move on.
        _ERRORS.inc()


def _open_active_locked() -> None:
    global _fh, _fh_path, _fh_bytes, _fh_pid, _next_seg
    if _fh is not None and _fh_pid != os.getpid():
        # Inherited across fork/spawn: the handle (and the tmp file it
        # points at) belongs to the parent — drop it without touching.
        try:
            _fh.close()
        except OSError:
            pass
        _fh = None
        _fh_path = None
        _next_seg = None
    d = _proc_dir()
    d.mkdir(parents=True, exist_ok=True)
    if _next_seg is None:
        _next_seg = _scan_next_segment(d)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=TMP_PREFIX)
    _fh = os.fdopen(fd, "w", encoding="utf-8")
    _fh_path = Path(tmp)
    _fh_bytes = 0
    _fh_pid = os.getpid()


def _scan_next_segment(d: Path) -> int:
    top = 0
    try:
        for p in d.iterdir():
            n = _segment_number(p.name)
            if n is not None:
                top = max(top, n + 1)
    except OSError:
        pass
    return top


def _segment_number(name: str) -> int | None:
    if not (name.startswith(SEGMENT_PREFIX) and name.endswith(SEGMENT_SUFFIX)):
        return None
    try:
        return int(name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)])
    except ValueError:
        return None


def _seal_locked() -> None:
    """Atomically publish the active segment: flush + fsync +
    os.replace + directory fsync (file_utils._overwrite_json idiom), so
    a sealed ``segment-<n>.jsonl`` appears whole or not at all."""
    global _fh, _fh_path, _fh_bytes, _next_seg
    if _fh is None:
        return
    if _fh_pid != os.getpid():  # inherited handle — not ours to seal
        _fh = None
        _fh_path = None
        _fh_bytes = 0
        return
    try:
        if _fh_bytes == 0:
            _fh.close()
            _fh_path.unlink(missing_ok=True)
            return
        _fh.flush()
        os.fsync(_fh.fileno())
        _fh.close()
        d = _fh_path.parent
        final = d / f"{SEGMENT_PREFIX}{_next_seg:08d}{SEGMENT_SUFFIX}"
        os.replace(_fh_path, final)
        _fsync_dir(d)
        # Torn window: segment sealed, eviction index not yet run. A
        # crash here leaves an extra sealed segment on disk; the next
        # seal's sweep re-lists and evicts it (CrashPoint is a
        # BaseException, so the except OSError below never eats it).
        faults.fault_point("journal.seal", final)
        _next_seg += 1
        _SEALED.inc()
        _evict_locked(d)
    except OSError:
        _ERRORS.inc()
    finally:
        _fh = None
        _fh_path = None
        _fh_bytes = 0


def _evict_locked(d: Path) -> None:
    """Drop oldest sealed segments until the per-process byte budget
    holds (always keeps the newest one)."""
    try:
        sealed = sorted(
            (p for p in d.iterdir() if _segment_number(p.name) is not None),
            key=lambda p: _segment_number(p.name),
        )
        total = sum(p.stat().st_size for p in sealed)
        while sealed[:-1] and total > _max_bytes:
            victim = sealed.pop(0)
            total -= victim.stat().st_size
            victim.unlink(missing_ok=True)
            _EVICTIONS.inc()
    except OSError:
        _ERRORS.inc()


def _fsync_dir(d: Path) -> None:
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# -- merge / sweep (the reader side) -------------------------------------
def segment_paths(proc_dir: str | os.PathLike) -> list[Path]:
    """Sealed segments of one process dir, oldest first. The active
    ``.tmp-seg-*`` tail is deliberately invisible here — it may be torn."""
    d = Path(proc_dir)
    try:
        sealed = [p for p in d.iterdir() if _segment_number(p.name) is not None]
    except OSError:
        return []
    return sorted(sealed, key=lambda p: _segment_number(p.name))


def read_segment(path: str | os.PathLike) -> list[dict]:
    """Records of one sealed segment; torn or alien lines are skipped
    (a crashed writer can leave at most one, at the very end)."""
    out = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                if isinstance(doc, dict):
                    out.append(doc)
    except OSError:
        pass
    return out


def merge_dir(root_dir: str | os.PathLike) -> list[dict]:
    """Merge every member's sealed segments under ``root_dir`` (the
    ``_obs`` root: one ``<pid>/`` dir per process) into one record list,
    ordered by wall-clock ``ts``. Tolerates dead members, torn tails and
    alien files — this is the post-incident reader and must never
    require the fleet to be alive."""
    records: list[dict] = []
    rd = Path(root_dir)
    try:
        pid_dirs = [p for p in rd.iterdir() if p.is_dir() and p.name.isdigit()]
    except OSError:
        return []
    for d in sorted(pid_dirs, key=lambda p: int(p.name)):
        for seg in segment_paths(d):
            for doc in read_segment(seg):
                doc.setdefault("pid", int(d.name))
                records.append(doc)
    records.sort(key=lambda r: (r.get("ts") or 0.0, r.get("pid") or 0))
    return records


def spans_from_journal(root_dir: str | os.PathLike) -> list[dict]:
    """Root-span JSON docs from a merged journal — feed for
    `obs.export.chrome_trace` (``--fleet`` mode)."""
    return [r["trace"] for r in merge_dir(root_dir)
            if r.get("kind") == "span" and isinstance(r.get("trace"), dict)]


def sweep(root_dir: str | os.PathLike) -> list[str]:
    """Remove torn ``.tmp-seg-*`` tails left by crashed writers — the
    `recover()` analogue for the journal. The calling process's own live
    active segment is left alone. Returns the removed paths."""
    removed: list[str] = []
    rd = Path(root_dir)
    with _lock:
        live = str(_fh_path) if _fh is not None and _fh_pid == os.getpid() else None
    try:
        pid_dirs = [p for p in rd.iterdir() if p.is_dir() and p.name.isdigit()]
    except OSError:
        return removed
    for d in pid_dirs:
        try:
            for p in d.iterdir():
                if p.name.startswith(TMP_PREFIX) and str(p) != live:
                    p.unlink(missing_ok=True)
                    removed.append(str(p))
        except OSError:
            _ERRORS.inc()
    return removed


def reset() -> None:
    """Back to defaults, discarding any buffered records (tests)."""
    global _enabled, _root, _segment_bytes, _max_bytes, _snapshot_s
    global _fh, _fh_path, _fh_bytes, _fh_pid, _next_seg, _last_snapshot
    with _lock:
        if _fh is not None and _fh_pid == os.getpid():
            try:
                _fh.close()
                if _fh_path is not None:
                    _fh_path.unlink(missing_ok=True)
            except OSError:
                pass
        _fh = None
        _fh_path = None
        _fh_bytes = 0
        _fh_pid = None
        _next_seg = None
        _last_snapshot = 0.0
        _enabled = False
        _root = None
        _segment_bytes = DEFAULT_SEGMENT_BYTES
        _max_bytes = DEFAULT_MAX_BYTES
        _snapshot_s = DEFAULT_SNAPSHOT_SECONDS
