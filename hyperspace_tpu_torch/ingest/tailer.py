"""Poll-based source watchers with atomically persisted cursors.

A port of the JAX package's `ingest/tailer.py`. Two change-data-capture
shapes, both cheap enough to run every poll tick:

- :class:`FileArrivalWatcher` — new-file arrival: list the source root
  (the same ``dataset.list_data_files`` walk the signature provider uses)
  and diff against the cursor's known set. Arrived bytes are metered into
  ``ingest.bytes``.
- :class:`CdcTailer` — appended-row CDC: tail a JSONL changelog from a
  persisted byte offset and materialize complete new lines into
  ``cdc-<seq>.parquet`` batch files inside the indexed source root, where
  the next incremental refresh picks them up as appended data.

Crash discipline: the cursor is one JSON document written through
``file_utils.write_json`` (temp file, fsync, rename) and loaded leniently
(unreadable: start empty). The ``ingest.tail`` fault point fires after a
batch file lands but before the cursor persists, so a crash there leaves
an orphan batch; batch names derive from the cursor's sequence, so the
retry writes the same bytes to the same name from the same offset. A
batch is only ever rewritten before the commit that would freeze its
mtime into an index signature. Batch files are published by temp file,
fsync and ``os.replace``, so a concurrent query never lists a torn file.
The cursor's document and the batch files' bytes are the JAX package's.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

from hyperspace_tpu_torch import faults, stats
from hyperspace_tpu_torch.utils import file_utils


class Cursor:
    """One index's poll position, persisted atomically as a single JSON
    document (``<system_path>/_ingest/cursors/<name>.json``)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._doc: dict | None = None

    def load(self) -> dict:
        if self._doc is None:
            try:
                self._doc = file_utils.read_json(self.path)
            except (OSError, ValueError):
                self._doc = {}
            if not isinstance(self._doc, dict):
                self._doc = {}
        return self._doc

    def save(self) -> None:
        file_utils.write_json(self.path, self.load())


class FileArrivalWatcher:
    """Detect files arriving (or growing) under one source root."""

    def __init__(self, root: str | Path, fmt: str, cursor: Cursor):
        self.root = str(root)
        self.format = fmt
        self.cursor = cursor

    def poll(self) -> int:
        """Number of new-or-grown files observed this tick; arrived bytes
        are metered into ``ingest.bytes``."""
        from hyperspace_tpu_torch.dataset import format_suffix, list_data_files

        files = list_data_files(self.root, suffix=format_suffix(self.format))
        doc = self.cursor.load()
        known = doc.setdefault("known", {})
        fresh = 0
        new_bytes = 0
        for fi in files:
            seen = known.get(fi.path)
            if seen == fi.size:
                continue
            fresh += 1
            new_bytes += int(fi.size) - int(seen or 0)
            known[fi.path] = fi.size
        if fresh:
            stats.increment("ingest.bytes", max(new_bytes, 0))
            self.cursor.save()
        return fresh


class CdcTailer:
    """Tail a JSONL changelog into deterministic parquet batch files."""

    def __init__(self, changelog: str | Path, dest_root: str | Path, cursor: Cursor):
        self.changelog = str(changelog)
        self.dest_root = Path(dest_root)
        self.cursor = cursor

    def poll(self, batch_rows: int) -> int:
        """Materialize complete appended changelog lines into batches of
        at most ``batch_rows`` rows; returns the rows materialized (also
        metered into ``ingest.rows``)."""
        doc = self.cursor.load()
        st = doc.setdefault("cdc", {"offset": 0, "seq": 0})
        offset = int(st.get("offset", 0))
        try:
            size = os.path.getsize(self.changelog)
        except OSError:
            return 0  # the changelog is not created yet
        if size <= offset:
            return 0
        with open(self.changelog, "rb") as f:
            f.seek(offset)
            data = f.read()
        end = data.rfind(b"\n")
        if end < 0:
            return 0  # a partial trailing line: wait for the writer
        chunk = data[: end + 1]
        rows = [json.loads(line) for line in chunk.splitlines() if line.strip()]
        seq = int(st.get("seq", 0))
        step = max(int(batch_rows), 1)
        total = 0
        for i in range(0, len(rows), step):
            batch = rows[i : i + step]
            path = self.dest_root / f"cdc-{seq:06d}.parquet"
            self._write_batch(path, batch)
            # A crash here leaves the cursor below unadvanced; the retry
            # rewrites the same file from the same offset.
            faults.fault_point("ingest.tail", path)
            seq += 1
            total += len(batch)
        if total:
            stats.increment("ingest.rows", total)
        st["offset"] = offset + len(chunk)
        st["seq"] = seq
        self.cursor.save()
        return total

    @staticmethod
    def _write_batch(path: Path, rows: list[dict]) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        cols = sorted({k for r in rows for k in r})
        table = pa.table({c: [r.get(c) for r in rows] for c in cols})
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".cdc-", suffix=".tmp")
        os.close(fd)
        try:
            pq.write_table(table, tmp)
            # fsync before the rename: os.replace makes the name durable
            # independently of the data, so without the barrier a crash
            # could surface a zero-length batch file the planner lists.
            rfd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(rfd)
            finally:
                os.close(rfd)
            os.replace(tmp, path)
            file_utils.fsync_dir(path.parent)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
