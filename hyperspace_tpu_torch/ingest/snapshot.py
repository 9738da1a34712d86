"""Snapshot isolation over the index log's version vector.

A port of the JAX package's `ingest/snapshot.py`. The serve plan cache
already keys every cached plan on the collection's per-index latest log
id (serve/plan_cache.py); that vector is a version stamp. A
:class:`PinnedSnapshot` captures, at admission, the latest stable log
entry of every active index, and from then on a query that carries the
snapshot reads only that world:

- `pin_plan` rewrites every raw source-leaf ``Scan`` to the exact file
  list the pinned entry indexed (``Scan.files``, the mechanism hybrid scan
  uses). Arrivals are append-only, so the pinned leaf's fingerprint equals
  the pinned entry's stored signature: the rewrite rules match the pinned
  entry, not a newer version a concurrent micro-batch committed, and the
  executor reads only its version directories.
- `optimized_plan` / `run_query` take the candidate entries from
  :meth:`entries` instead of the live log, so an index that goes active
  (or grows a version) after admission is invisible.
- Sources no index covers are pinned on first touch: one live listing,
  memoized, so repeated reads repeat there too.

Repeatability holds while the pinned version directories exist:
``optimize`` keeps superseded directories on disk, so compaction under a
live snapshot is safe; a ``vacuum`` or a ``recover`` orphan sweep that
deletes them ends the snapshot's useful life. In-place rewrites of source
files are outside the contract (CDC is append-only by construction).
"""

from __future__ import annotations

import dataclasses
import threading
from pathlib import Path

from hyperspace_tpu_torch import states, stats
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan


def _scan_leaves(plan_json: dict) -> list[dict]:
    """Every ``{"type": "scan", ...}`` dict in a serialized plan."""
    out: list[dict] = []

    def walk(node):
        if isinstance(node, dict):
            if node.get("type") == "scan":
                out.append(node)
            else:
                for v in node.values():
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(plan_json)
    return out


class PinnedSnapshot:
    """A repeatable-read view of the collection, pinned at construction.

    Use as a context manager (``with session.pin_snapshot() as snap:``) or
    call :meth:`release`; a released snapshot refuses further pinning, so
    a stale handle fails loudly instead of reading the live world.
    """

    def __init__(self, session):
        self._lock = threading.Lock()
        self._released = False
        # name -> pinned IndexLogEntry (latest stable, active only)
        self._pinned: dict[str, object] = {}
        # source root -> pinned entry (the freshest wins where two indexes
        # cover one root)
        self._by_root: dict[str, object] = {}
        # (root, format) -> file list of a source no index covers,
        # memoized on first touch
        self._unindexed: dict[tuple[str, str], list[str]] = {}
        mgr = session.manager
        stamp = []
        for d in mgr.path_resolver.list_index_paths():
            entry = mgr.log_manager_factory(d).get_latest_stable_log()
            if entry is None:
                stamp.append((d.name, None))
                continue
            stamp.append((d.name, entry.id))
            if entry.state != states.ACTIVE:
                continue
            self._pinned[d.name] = entry
            for leaf in _scan_leaves(entry.source.plan):
                root = str(Path(leaf["root"]))
                held = self._by_root.get(root)
                if held is None or entry.id > held.id:
                    self._by_root[root] = entry
        self.stamp: tuple = tuple(stamp)
        stats.increment("ingest.snapshots")

    @property
    def released(self) -> bool:
        return self._released

    def entries(self) -> list:
        """The pinned index entries: the candidate set the rewrite rules
        match against instead of the live listing."""
        return list(self._pinned.values())

    def pin_plan(self, plan: LogicalPlan) -> LogicalPlan:
        """Rewrite every unpinned source leaf to the snapshot's file list,
        so both the fingerprint match and any raw-scan fallback read
        exactly the admitted world."""
        if self._released:
            raise HyperspaceError(
                "snapshot released: pin_snapshot() handles are single-use views; "
                "take a new snapshot for a new read point"
            )

        def rewrite(node: LogicalPlan) -> LogicalPlan:
            if isinstance(node, Scan):
                if node.files is not None or node.bucket_spec is not None:
                    return node  # already pinned (hybrid / exchange leaves)
                root = str(Path(node.root))
                entry = self._by_root.get(root)
                if entry is not None:
                    files = [f.path for f in entry.source.files]
                else:
                    files = self._pin_unindexed(root, node.format)
                return dataclasses.replace(node, files=files)
            changes = {}
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                if isinstance(v, LogicalPlan):
                    nv = rewrite(v)
                    if nv is not v:
                        changes[f.name] = nv
                elif isinstance(v, list) and v and isinstance(v[0], LogicalPlan):
                    nv = [rewrite(c) for c in v]
                    if any(a is not b for a, b in zip(nv, v)):
                        changes[f.name] = nv
            return dataclasses.replace(node, **changes) if changes else node

        return rewrite(plan)

    def _pin_unindexed(self, root: str, fmt: str) -> list[str]:
        key = (root, fmt)
        with self._lock:
            files = self._unindexed.get(key)
            if files is None:
                from hyperspace_tpu_torch.dataset import format_suffix, list_data_files

                files = [f.path for f in list_data_files(root, suffix=format_suffix(fmt))]
                self._unindexed[key] = files
            return files

    def release(self) -> None:
        self._released = True

    def __enter__(self) -> "PinnedSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()
