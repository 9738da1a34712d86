"""Parquet IO: host staging between disk and the device plane.

The analog of Spark's FileSourceScanExec + vectorized Parquet read. Reads go
through pyarrow into a ColumnTable (strings dictionary-encoded) on the
requested device; writes emit one sorted parquet file per bucket plus a
`_index_manifest.json` with per-bucket row counts and key/column stats.

A port of the JAX package's `execution/io.py`: the bucket-file names, the
parquet encode and the manifest are the same, so an index written by either
package is read by the other; `file_key_stats` and `file_column_stats`
read the manifests' per-bucket min/max for range pruning. The
decoded-table and footer caches, the chunked row-group read and the
fault-injection hooks are not ported; the executor keeps decoded columns
on the device instead (execution/device_cache.py).
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError, IndexCorruptionError
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.schema import Schema
from hyperspace_tpu_torch.utils.file_utils import write_json

MANIFEST_NAME = "_index_manifest.json"


def _read_one_file(path: str, columns: list[str] | None):
    """One parquet file → pyarrow Table. ParquetFile (never the dataset
    API): index files live under hive-looking `v__=N` version dirs, and
    inferring a `v__` partition column would bake it into the table."""
    pf = pq.ParquetFile(path)
    if columns is not None:
        names = set(pf.schema_arrow.names)
        missing = [c for c in columns if c not in names]
        if missing:
            raise pa.lib.ArrowInvalid(f"no match for column(s) {missing} in {path}")
    return pf.read(columns=columns, use_threads=True)


def read_parquet(
    files: list[str],
    columns: list[str] | None = None,
    schema: Schema | None = None,
    *,
    device: torch.device | str,
    file_rows: bool = False,
) -> ColumnTable | tuple[ColumnTable, np.ndarray]:
    """Multi-file parquet read into a ColumnTable on `device` (decode
    overlapped across files; row order is the file order). With
    `file_rows`, returns (table, int64 row count of each file)."""
    if not files:
        raise HyperspaceError("no files to read")
    if len(files) == 1:
        tables = [_read_one_file(files[0], columns)]
    else:
        with ThreadPoolExecutor(max_workers=min(8, len(files))) as ex:
            tables = list(ex.map(lambda f: _read_one_file(f, columns), files))
    table = pa.concat_tables(tables, promote_options="default") if len(tables) > 1 else tables[0]
    if schema is not None and columns is not None:
        schema = schema.select(columns)
    out = ColumnTable.from_arrow(table, schema, device=device)
    if file_rows:
        return out, np.array([t.num_rows for t in tables], dtype=np.int64)
    return out


def bucket_file_name(bucket: int) -> str:
    return f"bucket-{bucket:05d}.parquet"


def bucket_of_file_name(name: str) -> int | None:
    """Inverse of bucket_file_name (None for non-bucket files)."""
    if name.startswith("bucket-") and name.endswith(".parquet"):
        try:
            return int(name[len("bucket-") : -len(".parquet")])
        except ValueError:
            return None
    return None


def _json_scalar(v):
    """numpy scalar → plain JSON-serializable Python value."""
    return v.item() if hasattr(v, "item") else v


def bucket_key_stats(table: ColumnTable, key: str):
    """JSON-serializable [min, max] of `table[key]`, ignoring nulls; None
    for empty/all-null/vector — persisted in the index manifest so range
    predicates can skip whole bucket files (the JAX package's stats,
    computed on the host copy of the bucket)."""
    try:
        f = table.schema.field(key)
    except KeyError:
        return None
    if f.is_vector:
        return None
    vals = table.host_column(f.name)
    valid = table.host_valid_mask(f.name)
    if valid is not None:
        vals = vals[valid]
    if len(vals) == 0:
        return None
    if f.name in table.dictionaries:
        used = np.asarray(table.dictionaries[f.name])[np.unique(vals)].tolist()
        return [min(used), max(used)]
    return [_json_scalar(vals.min()), _json_scalar(vals.max())]


# Parquet codec for INDEX bucket files (the JAX package's choice: lz4).
INDEX_WRITE_COMPRESSION = "lz4"


def write_bucket(dest_dir: Path, bucket: int, table: ColumnTable) -> None:
    dest_dir.mkdir(parents=True, exist_ok=True)
    # Dictionary-encode ONLY string columns; pruning reads the manifest,
    # never parquet footer statistics.
    dict_cols = [f.name for f in table.schema.fields if f.is_string]
    pq.write_table(
        table.to_arrow(),
        dest_dir / bucket_file_name(bucket),
        use_dictionary=dict_cols,
        compression=INDEX_WRITE_COMPRESSION,
        write_statistics=False,
    )


def write_manifest(
    dest_dir: Path,
    num_buckets: int,
    indexed_columns: list[str],
    bucket_rows: list[int],
    key_stats: list | None = None,
    column_stats: list | None = None,
) -> None:
    dest_dir.mkdir(parents=True, exist_ok=True)
    manifest = {
        "numBuckets": num_buckets,
        "indexedColumns": indexed_columns,
        "bucketRows": bucket_rows,
    }
    if key_stats is not None:
        manifest["keyStats"] = key_stats
    if column_stats is not None:
        manifest["columnStats"] = column_stats
    # Atomic temp-file + os.replace (+ fsync) via write_json.
    write_json(dest_dir / MANIFEST_NAME, manifest)


def read_manifest(version_dir: Path) -> dict | None:
    """Version dir's manifest, or None when absent. Garbage raises a typed
    IndexCorruptionError."""
    p = Path(version_dir) / MANIFEST_NAME
    if not p.exists():
        return None
    try:
        return json.loads(p.read_text())
    except (OSError, ValueError) as e:
        raise IndexCorruptionError(
            f"corrupt index manifest {p}: {e}",
            index_root=str(Path(version_dir).parent),
            path=str(p),
        ) from e


_manifest_cache: dict[str, tuple[int, dict | None]] = {}
_manifest_lock = threading.Lock()


def read_manifest_cached(version_dir: Path) -> dict | None:
    """read_manifest through an mtime-validated cache (manifests are
    immutable per version, but a refresh can rewrite a dir's manifest)."""
    mp = Path(version_dir) / MANIFEST_NAME
    try:
        mt = os.stat(mp).st_mtime_ns
    except OSError:
        return None
    with _manifest_lock:
        cached = _manifest_cache.get(str(mp))
    if cached is not None and cached[0] == mt:
        return cached[1]
    m = read_manifest(version_dir)
    with _manifest_lock:
        _manifest_cache[str(mp)] = (mt, m)
    return m


def _files_by_dir(files: list[str]) -> dict[Path, list[str]]:
    by_dir: dict[Path, list[str]] = {}
    for f in files:
        by_dir.setdefault(Path(f).parent, []).append(f)
    return by_dir


def file_key_stats(files: list[str]) -> dict[str, list | None]:
    """Per-file [min, max] of the leading indexed column, looked up in each
    file's version-dir manifest (cached, mtime-validated). Files whose dir
    has no manifest or whose manifest has no keyStats are absent from the
    result; a present-but-None value means the bucket is empty/all-null."""
    out: dict[str, list | None] = {}
    for d, fs in _files_by_dir(files).items():
        m = read_manifest_cached(d)
        if not m or "keyStats" not in m:
            continue
        ks = m["keyStats"]
        for f in fs:
            b = bucket_of_file_name(Path(f).name)
            if b is not None and b < len(ks):
                out[f] = ks[b]
    return out


def file_column_stats(files: list[str], column: str) -> dict[str, list | None]:
    """Per-file [min, max] of a NON-leading column from the manifests'
    columnStats (case-insensitive name match). Same present/None contract
    as file_key_stats."""
    out: dict[str, list | None] = {}
    low = column.lower()
    for d, fs in _files_by_dir(files).items():
        cs = (read_manifest_cached(d) or {}).get("columnStats")
        if not cs:
            continue
        for f in fs:
            b = bucket_of_file_name(Path(f).name)
            if b is None or b >= len(cs) or cs[b] is None:
                continue
            for name, st in cs[b].items():
                if name.lower() == low:
                    out[f] = st
                    break
    return out


def carve_and_write(
    dest: Path,
    table: ColumnTable,
    bucket_rows: np.ndarray,
    indexed_columns: list[str],
    order: np.ndarray,
) -> list[int]:
    """Carve a host (CPU) `table` into one parquet file per bucket +
    manifest. `order` lists the table's rows in (bucket, key) order and
    `bucket_rows[b]` counts bucket b's rows, so bucket b's rows are
    `order[starts[b]:starts[b+1]]`. Buckets encode concurrently (the
    parquet encode releases the GIL). Returns per-bucket row counts."""
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    num_buckets = len(bucket_rows)
    starts = np.concatenate([[0], np.cumsum(bucket_rows)]).astype(np.int64)
    rows = [int(r) for r in bucket_rows]
    key_stats: list = [None] * num_buckets
    col_stats: list = [None] * num_buckets
    lead = table.schema.field(indexed_columns[0]).name if indexed_columns else None
    other_cols = [f.name for f in table.schema.fields if f.name != lead and not f.is_vector]
    order_t = torch.from_numpy(np.ascontiguousarray(order, dtype=np.int64))

    def write_one(b: int) -> None:
        sub = table.take(order_t[starts[b] : starts[b + 1]])
        if lead is not None:
            key_stats[b] = bucket_key_stats(sub, lead)
        if other_cols:
            col_stats[b] = {c: bucket_key_stats(sub, c) for c in other_cols}
        write_bucket(dest, b, sub)

    with ThreadPoolExecutor(max_workers=min(16, max(1, num_buckets))) as ex:
        list(ex.map(write_one, range(num_buckets)))
    write_manifest(
        dest, num_buckets, indexed_columns, rows,
        key_stats if any(s is not None for s in key_stats) else None,
        col_stats if any(s is not None for s in col_stats) else None,
    )
    return rows


def host_table(table: ColumnTable) -> ColumnTable:
    """The table on the CPU (a no-op for a CPU table)."""
    return table if table.device.type == "cpu" else table.to("cpu")

