"""Parquet IO: host staging between disk and the device plane.

The analog of Spark's FileSourceScanExec + vectorized Parquet read. Reads go
through pyarrow into a ColumnTable (strings dictionary-encoded) on the
requested device; writes emit one sorted parquet file per bucket plus a
`_index_manifest.json` with per-bucket row counts and key/column stats.

A port of the JAX package's `execution/io.py`: the bucket-file names, the
parquet encode and the manifest are the same, so an index written by either
package is read by the other; `file_key_stats` and `file_column_stats`
read the manifests' per-bucket min/max for range pruning. Sources are
parquet, ORC, CSV or line-delimited JSON (`read_table_files`; CSV and JSON
decode pinned to the registered schema's types). Every data file read
runs under the transient-IO retry (utils/retry.py) with the `bucket.read`
fault point inside the retried call; writes fire `bucket.write` /
`bucket.written` and `manifest.write` / `manifest.written`, and a manifest
read `manifest.read` (faults.py). The decoded-table and footer caches and
the chunked row-group read are not ported; the executor keeps decoded
columns on the device instead (execution/device_cache.py).
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

from hyperspace_tpu_torch import stats
from hyperspace_tpu_torch.exceptions import HyperspaceError, IndexCorruptionError
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.faults import fault_point
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.schema import Schema
from hyperspace_tpu_torch.utils import retry
from hyperspace_tpu_torch.utils.file_utils import write_json

MANIFEST_NAME = "_index_manifest.json"


_ARROW_TYPES = {
    "int32": pa.int32(),
    "int64": pa.int64(),
    "float32": pa.float32(),
    "float64": pa.float64(),
    "bool": pa.bool_(),
    "string": pa.string(),
    "date": pa.date32(),
    "timestamp": pa.timestamp("us"),
}


def _arrow_types_for(schema: Schema | None) -> dict | None:
    """name → arrow type for the registered schema's scalar fields: pins
    CSV/JSON decode to the planned types instead of re-inferring per file
    (per-file inference can diverge across files and from the
    registration-time schema)."""
    if schema is None:
        return None
    out = {}
    for f in schema.fields:
        t = _ARROW_TYPES.get(f.dtype)
        if t is not None:
            out[f.name] = t
    return out or None


def _read_one_file(path: str, fmt: str, columns: list[str] | None, schema: Schema | None):
    """One file of any supported source format → pyarrow Table, with
    transient-IO retry (pyarrow's IO errors subclass OSError; only
    retryable errnos re-attempt — a missing or truncated file surfaces
    immediately). The reference gates sources to the same four formats
    (index/serde/LogicalPlanSerDeUtils.scala:225-245)."""
    return retry.retry_call(_read_one_file_once, path, fmt, columns, schema)


def _read_one_file_once(path: str, fmt: str, columns: list[str] | None, schema: Schema | None):
    fault_point("bucket.read", path)
    if fmt == "parquet":
        # ParquetFile (never the dataset API): index files live under
        # hive-looking `v__=N` version dirs, and inferring a `v__`
        # partition column would bake it into the table.
        pf = pq.ParquetFile(path)
        if columns is not None:
            names = set(pf.schema_arrow.names)
            missing = [c for c in columns if c not in names]
            if missing:
                raise pa.lib.ArrowInvalid(f"no match for column(s) {missing} in {path}")
        return pf.read(columns=columns, use_threads=True)
    if fmt == "orc":
        from pyarrow import orc

        return orc.ORCFile(path).read(columns=columns)
    if fmt == "csv":
        from pyarrow import csv as pcsv

        opts = pcsv.ConvertOptions(
            include_columns=columns if columns is not None else None,
            column_types=_arrow_types_for(schema),
        )
        return pcsv.read_csv(path, convert_options=opts)
    if fmt == "json":
        from pyarrow import json as pjson

        types = _arrow_types_for(schema)
        parse = None
        if types is not None and schema is not None and len(types) == len(schema.fields):
            parse = pjson.ParseOptions(
                explicit_schema=pa.schema([(f.name, types[f.name]) for f in schema.fields])
            )
        t = pjson.read_json(path, parse_options=parse)
        return t.select(columns) if columns is not None else t
    raise HyperspaceError(f"unsupported source format {fmt!r} (parquet|orc|csv|json)")


# Cold reads at or above this many on-disk bytes decode as parallel
# row-group chunks instead of one serial decode a file (only where the
# file count alone cannot fill the pool).
_CHUNKED_READ_MIN_BYTES = 32 << 20


def _read_parquet_chunked(files: list[str], columns: list[str] | None):
    """Row-group-parallel decode of a small file set: (table, rows of each
    file), or None when the footers give no parallelism (one row group, a
    tiny estimate, unreadable footers: the per-file read then runs)."""
    try:
        footers = read_footers(files)
    except (OSError, pa.ArrowException):
        return None
    est = estimate_uncompressed_bytes(files, columns, footers=footers)
    if est <= 0:
        return None
    units = plan_row_group_chunks(files, max(4 << 20, est // 16), columns, footers=footers)
    if len(units) < 2:
        return None
    read = obs_trace.wrap(lambda c: read_chunk(c, columns))
    with ThreadPoolExecutor(max_workers=min(8, len(units))) as ex:
        parts = list(ex.map(read, units))
    # Units are planned in file order with row groups in order, so the
    # ordered concat reproduces the serial read's row order exactly.
    rows = np.array([footers[f].num_rows for f in files], dtype=np.int64)
    return pa.concat_tables(parts, promote_options="default"), rows


def read_table_files(
    files: list[str],
    fmt: str,
    columns: list[str] | None = None,
    schema: Schema | None = None,
    *,
    device: torch.device | str,
    file_rows: bool = False,
) -> ColumnTable | tuple[ColumnTable, np.ndarray]:
    """Multi-file read of one source format into a ColumnTable on
    `device` (decode overlapped across files, or across the row groups of
    a few large parquet files; row order is the file order). With
    `file_rows`, returns (table, int64 row count of each file)."""
    if not files:
        raise HyperspaceError("no files to read")
    try:
        nbytes = sum(os.path.getsize(f) for f in files)
    except OSError:
        nbytes = 0
    with obs_trace.span("io.read", files=len(files), fmt=fmt, bytes=nbytes):
        chunked = None
        if fmt == "parquet" and len(files) <= 4 and nbytes >= _CHUNKED_READ_MIN_BYTES:
            chunked = _read_parquet_chunked(files, columns)
        if chunked is not None:
            table, rows = chunked
        else:
            if len(files) == 1:
                tables = [_read_one_file(files[0], fmt, columns, schema)]
            else:
                # Each worker retries its own file: a transient fault is
                # absorbed inside the pool, never turned into a failed read.
                read = obs_trace.wrap(lambda f: _read_one_file(f, fmt, columns, schema))
                with ThreadPoolExecutor(max_workers=min(8, len(files))) as ex:
                    tables = list(ex.map(read, files))
            table = pa.concat_tables(tables, promote_options="default") if len(tables) > 1 else tables[0]
            rows = np.array([t.num_rows for t in tables], dtype=np.int64)
    if schema is not None and columns is not None:
        schema = schema.select(columns)
    with obs_trace.span("device.stage", files=len(files)):
        out = ColumnTable.from_arrow(table, schema, device=device)
    if file_rows:
        return out, rows
    return out


def _read_footer(path: str) -> "pq.FileMetaData":
    fault_point("footer.read", path)
    return pq.ParquetFile(path).metadata


# -- footer cache -------------------------------------------------------------
# The size estimate, the chunk plan and the query-tail prefetch read the
# same footers; one mtime-validated map parses each once.
_FOOTER_CACHE_MAX = 4096
_footer_cache: "dict[str, tuple[int, pq.FileMetaData]]" = {}
_footer_lock = threading.Lock()


def clear_footer_cache() -> None:
    with _footer_lock:
        _footer_cache.clear()


def read_footers(files: list[str]) -> dict[str, "pq.FileMetaData"]:
    """One footer parse per file (transient-IO retried, `footer.read`
    inside the retried call), reused until the file's mtime changes;
    `io.footer_cache.hits` / `.misses` count the reuse."""
    if not files:
        return {}
    out: dict[str, "pq.FileMetaData"] = {}
    todo: list[tuple[str, int | None]] = []
    for f in files:
        try:
            mt = os.stat(f).st_mtime_ns
        except OSError:
            mt = None
        hit = None
        if mt is not None:
            with _footer_lock:
                cached = _footer_cache.get(f)
            if cached is not None and cached[0] == mt:
                hit = cached[1]
        if hit is not None:
            out[f] = hit
        else:
            todo.append((f, mt))
    if out:
        stats.increment("io.footer_cache.hits", len(out))
    if not todo:
        return {f: out[f] for f in files}
    stats.increment("io.footer_cache.misses", len(todo))
    if len(todo) == 1:
        mds = [retry.retry_call(_read_footer, todo[0][0])]
    else:
        with obs_trace.span("io.footers", files=len(todo)):
            read = obs_trace.wrap(lambda f: retry.retry_call(_read_footer, f))
            with ThreadPoolExecutor(max_workers=min(8, len(todo))) as ex:
                mds = list(ex.map(read, (f for f, _ in todo)))
    with _footer_lock:
        for (f, mt), md in zip(todo, mds):
            out[f] = md
            if mt is not None:
                _footer_cache[f] = (mt, md)
        while len(_footer_cache) > _FOOTER_CACHE_MAX:
            _footer_cache.pop(next(iter(_footer_cache)))
    return {f: out[f] for f in files}


def _row_group_bytes(md, rg: int, want: set | None) -> int:
    g = md.row_group(rg)
    total = 0
    for ci in range(g.num_columns):
        col = g.column(ci)
        name = col.path_in_schema.split(".")[0]
        if want is None or name.lower() in want:
            total += col.total_uncompressed_size
    return total


def estimate_uncompressed_bytes(files: list[str], columns: list[str] | None = None, footers=None) -> int:
    """Uncompressed size estimate from the parquet footers (no data read):
    the in-memory or streaming build decision."""
    footers = footers if footers is not None else read_footers(files)
    want = {c.lower() for c in columns} if columns is not None else None
    return sum(
        _row_group_bytes(md, rg, want) for md in footers.values() for rg in range(md.num_row_groups)
    )


def plan_row_group_chunks(
    files: list[str], chunk_bytes: int, columns: list[str] | None = None, footers=None
) -> list[list[tuple[str, int]]]:
    """Split the (file, row group) units into chunks of at most
    `chunk_bytes` uncompressed (each chunk holds at least one row group):
    the streaming build's unit of host memory."""
    footers = footers if footers is not None else read_footers(files)
    want = {c.lower() for c in columns} if columns is not None else None
    chunks: list[list[tuple[str, int]]] = []
    cur: list[tuple[str, int]] = []
    cur_bytes = 0
    for f in files:
        md = footers[f]
        for rg in range(md.num_row_groups):
            sz = _row_group_bytes(md, rg, want)
            if cur and cur_bytes + sz > chunk_bytes:
                chunks.append(cur)
                cur, cur_bytes = [], 0
            cur.append((f, rg))
            cur_bytes += sz
    if cur:
        chunks.append(cur)
    return chunks


def _read_chunk_file(f: str, rgs: list[int], columns: list[str] | None):
    fault_point("bucket.read", f)
    pf = pq.ParquetFile(f)
    if columns is not None:
        # A column absent from THIS file is skipped here and null-filled
        # by the caller's promoting concat (the prefetch may probe any
        # file).
        names = set(pf.schema_arrow.names)
        columns = [c for c in columns if c in names]
    return pf.read_row_groups(rgs, columns=columns)


def read_chunk(chunk: list[tuple[str, int]], columns: list[str] | None = None):
    """Decode one planned chunk to a pyarrow Table (transient-IO retried
    a file; a column missing from a file is null-filled)."""
    by_file: dict[str, list[int]] = {}
    for f, rg in chunk:
        by_file.setdefault(f, []).append(rg)
    parts = [retry.retry_call(_read_chunk_file, f, rgs, columns) for f, rgs in by_file.items()]
    return pa.concat_tables(parts, promote_options="default") if len(parts) > 1 else parts[0]


def read_parquet(
    files: list[str],
    columns: list[str] | None = None,
    schema: Schema | None = None,
    *,
    device: torch.device | str,
    file_rows: bool = False,
) -> ColumnTable | tuple[ColumnTable, np.ndarray]:
    """`read_table_files` of parquet files."""
    return read_table_files(files, "parquet", columns, schema, device=device, file_rows=file_rows)


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


def bucket_column_stats(table: ColumnTable, columns: list[str]) -> dict:
    """Per-column [min, max] of every named scalar column (the manifest's
    `columnStats`, so predicates on included columns prune files too)."""
    return {c: bucket_key_stats(table, c) for c in columns}


# Parquet codec for INDEX bucket files (the JAX package's choice: lz4).
INDEX_WRITE_COMPRESSION = "lz4"


def write_bucket(dest_dir: Path, bucket: int, table: ColumnTable) -> None:
    dest_dir.mkdir(parents=True, exist_ok=True)
    dest = dest_dir / bucket_file_name(bucket)
    fault_point("bucket.write", dest)
    # Dictionary-encode ONLY string columns; pruning reads the manifest,
    # never parquet footer statistics.
    dict_cols = [f.name for f in table.schema.fields if f.is_string]
    pq.write_table(
        table.to_arrow(),
        dest,
        use_dictionary=dict_cols,
        compression=INDEX_WRITE_COMPRESSION,
        write_statistics=False,
    )
    fault_point("bucket.written", dest)


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
    mp = dest_dir / MANIFEST_NAME
    fault_point("manifest.write", mp)
    # Atomic temp-file + os.replace (+ fsync) via write_json: a crash
    # mid-write leaves either the previous manifest or none.
    write_json(mp, manifest)
    fault_point("manifest.written", mp)


def read_manifest(version_dir: Path) -> dict | None:
    """Version dir's manifest, or None when absent. Garbage raises a typed
    IndexCorruptionError."""
    p = Path(version_dir) / MANIFEST_NAME
    if not p.exists():
        return None
    fault_point("manifest.read", p)
    try:
        return json.loads(p.read_text())
    except (OSError, ValueError) as e:
        stats.increment("index.corruption")
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
            col_stats[b] = bucket_column_stats(sub, other_cols)
        write_bucket(dest, b, sub)

    with obs_trace.span("io.carve", partitions=num_buckets):
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

