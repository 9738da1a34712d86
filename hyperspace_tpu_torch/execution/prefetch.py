"""Asynchronous index bucket-file prefetch for the query tail.

A port of the JAX package's `execution/prefetch.py`. Scan-bound queries
pay serial cold reads of bucket files after the optimizer already knows
which files survive pruning. `run_query` issues the prefetch as soon as
the optimized plan exists: the files the pruner keeps get their parquet
footers parsed into io's footer cache and their first row-group chunk
decoded on a background pool, so by the time the executor reaches the
scan the footers are cache hits and the read starts against a warm page
cache. It finds the files with the executor's own `exec_scan.scan_files`
and `point_prune_names`.

Advisory: a prefetch failure is counted (`io.prefetch.errors`), never
raised; a query can at worst miss the warm-up. The fault point
``prefetch.issue`` fires in the submitting thread. Gated by
``hyperspace.scan.prefetch.enabled``.
"""

from __future__ import annotations

import threading
from pathlib import Path

import pyarrow as pa

from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution.exec_scan import point_prune_names, scan_files
from hyperspace_tpu_torch.faults import fault_point
from hyperspace_tpu_torch.obs import metrics as obs_metrics
from hyperspace_tpu_torch.plan.nodes import Filter, Scan, Union

_MET_ISSUED = obs_metrics.counter("io.prefetch.issued", "prefetch jobs submitted")
_MET_ERRORS = obs_metrics.counter("io.prefetch.errors", "prefetch jobs that failed (advisory)")

# Per-query caps: a miss costs one cold read (what happens today), an
# over-eager prefetch evicts useful page cache — bound the blast radius.
_MAX_DATA_FILES = 16
_MAX_FOOTER_FILES = 256
# Decode at most this much of each file's first chunk.
_FIRST_CHUNK_BYTES = 8 << 20

# All module state below is guarded by _lock.
_lock = threading.Lock()
_pool = None
_pending: list = []
_issued: dict[str, int] = {}  # path -> mtime_ns of the last issued job
_ISSUED_MAX = 4096


def _get_pool():
    global _pool
    with _lock:
        if _pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="hs-prefetch")
        return _pool


def _job(path: str, columns: tuple[str, ...] | None, data: bool) -> None:
    """One prefetch unit: footer into the cache, optionally the first
    planned chunk (decode result discarded — the win is the warm footer
    cache + page cache). Failures are advisory by contract: the very
    same read will re-run (with retry and typed corruption handling) on
    the query path moments later, so swallowing the typed IO error here
    loses nothing."""
    try:
        footers = hio.read_footers([path])
        if data and footers:
            units = hio.plan_row_group_chunks(
                [path], _FIRST_CHUNK_BYTES, list(columns) if columns else None,
                footers=footers,
            )
            if units:
                hio.read_chunk(units[0], list(columns) if columns else None)
    except (OSError, pa.ArrowException):
        _MET_ERRORS.inc()


def _index_scans(plan) -> list[tuple[Scan, object]]:
    """(scan, predicate-or-None) pairs for every bucketed parquet scan in
    the plan, with the nearest enclosing Filter's predicate attached
    (that is what the executor's pruner will see)."""
    out: list[tuple[Scan, object]] = []

    def walk(node, pred):
        if isinstance(node, Scan):
            if node.bucket_spec is not None and node.format == "parquet":
                out.append((node, pred))
            return
        if isinstance(node, Filter):
            walk(node.child, node.predicate)
            return
        if isinstance(node, Union):
            for inp in node.inputs:
                walk(inp, pred)
            return
        for child in node.children():
            walk(child, None)

    walk(plan, None)
    return out


def prefetch_plan(plan) -> int:
    """Issue async footer + first-chunk prefetch for the index files the
    pruner will keep. Returns the number of jobs submitted (0 when the
    plan has no bucketed scans, or everything was recently issued)."""
    jobs: list[tuple[str, tuple[str, ...] | None, bool]] = []
    for scan, pred in _index_scans(plan):
        try:
            files = scan_files(scan)
        except OSError:
            continue
        names = point_prune_names(scan, pred) if pred is not None else None
        if names is not None:
            files = [f for f in files if Path(f).name in names]
        cols = tuple(scan.scan_schema.names) if scan.scan_schema is not None else None
        # Footers for everything the scan may touch (cheap, cached);
        # first-chunk decode only for a bounded set of survivors.
        for i, f in enumerate(files[:_MAX_FOOTER_FILES]):
            jobs.append((f, cols, i < _MAX_DATA_FILES))
    if not jobs:
        return 0
    import os

    submitted = 0
    pool = _get_pool()
    with _lock:
        for path, cols, data in jobs:
            try:
                # The fault point fires in the SUBMITTING thread (so it
                # is deterministic and statically reachable from the
                # run_query contract); an injected transient fault skips
                # this file's job — the advisory contract: the query
                # path re-reads with full retry/typed handling anyway.
                fault_point("prefetch.issue", path)
                mt = os.stat(path).st_mtime_ns
            except OSError:
                _MET_ERRORS.inc()
                continue
            if _issued.get(path) == mt:
                continue  # unchanged since the last issue: already warm
            _issued[path] = mt
            while len(_issued) > _ISSUED_MAX:
                _issued.pop(next(iter(_issued)))
            _pending.append(pool.submit(_job, path, cols, data))
            submitted += 1
        # Reap finished futures so _pending stays bounded.
        _pending[:] = [f for f in _pending if not f.done()]
    if submitted:
        _MET_ISSUED.inc(submitted)
    return submitted


def drain() -> None:
    """Block until every outstanding prefetch job finished (test hook —
    jobs swallow their own errors, so this never raises)."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
    for f in pending:
        f.result()


def reset() -> None:
    """Forget issue history (test isolation; the pool survives)."""
    drain()
    with _lock:
        _issued.clear()
