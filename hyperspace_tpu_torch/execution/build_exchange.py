"""The scale-out build's cross-process exchange: the host hash and sort
helpers, the chunked source decode, the spill-file exchange format, and
the worker-process bodies.

A port of the JAX package's `execution/build_exchange.py`, the pooled
build's analogue of Spark's hash shuffle: N **p1 shard** workers each
decode a disjoint, *contiguous* slice of the input files, hash and
partition the rows by the canonical bucket hash, and append per-bucket
spill parquet into the directory of the bucket's **owner**
(``owner = bucket % num_owners``); N **p2 owner** workers then read back
their buckets' spill (the shard files concatenated in shard order, which
reproduces the global source row order), key-sort on the host and write
the final bucket files and per-bucket manifest stats. Workers exchange
only paths and the decoded-byte ledger; no table is pickled across the
process boundary.

Byte-identity with the serial streaming build (pipeline off) follows
from three invariants, each held by tests/test_torch_build_scaleout.py:

- the file slices are contiguous and in order, and each shard streams its
  files in order, so shard-ordered spill concatenation equals the serial
  path's chunk order (chunk boundaries differ across worker counts, but
  never reorder rows);
- the key sort is the stable host permutation (`native.sort_range`, or
  `lexsort_lanes` with the native library turned off), the order the
  coordinator's batched device sort (`ops/sortkeys.device_sort_perms`)
  gives too;
- the final encode is the same deterministic `io.write_bucket`.

The workers are host-only: they never touch the card (no `torch.cuda`
call, no CUDA context). A spawned worker imports this module and with it
`torch` (through `io.py` and `table.py`); its start-up cost is on every
pooled build's critical path.

`compute_row_hashes` and `hash_scalar_key` live here, as in the JAX
package; `ops/hashing.py` re-exports them.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from hyperspace_tpu_torch import native
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.faults import fault_point
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.ops.hashing import bucket_ids, combine_hashes, hash_int_column, string_dict_hashes

# The fixed hash contribution of a NULL key slot: nulls bucket
# deterministically (they can never match an equality literal, so bucket
# pruning by literal hash stays correct regardless).
NULL_HASH = np.uint32(0x9E3779B9)


def compute_row_hashes(table: ColumnTable, key_columns: list[str]) -> np.ndarray:
    """Host uint32 row hash over the key columns of a ColumnTable:
    deterministic and dictionary-independent, so the query plane prunes
    buckets by hashing a literal the same way."""
    hashes = []
    for name in key_columns:
        f = table.schema.field(name)
        arr = table.host_column(name)
        if f.is_string:
            h = string_dict_hashes(table.dictionaries[f.name])[arr]
        else:
            h = hash_int_column(arr)
        valid = table.host_valid_mask(name)
        if valid is not None:
            h = np.where(valid, h, NULL_HASH)
        hashes.append(h)
    return combine_hashes(hashes)


def hash_scalar_key(values: list, fields) -> np.ndarray:
    """Hash one key tuple (for bucket pruning at query time)."""
    hs = []
    for v, f in zip(values, fields):
        if f.is_string:
            hs.append(string_dict_hashes(np.array([v], dtype=object)))
        else:
            hs.append(hash_int_column(np.array([v], dtype=f.device_dtype)))
    return combine_hashes(hs)


def host_sort_perm(table: ColumnTable, key_columns: list[str]) -> np.ndarray:
    """Stable key-sort permutation on the host: the native kernel, or
    `lexsort_lanes` where the native library is turned off. Both give the
    order `device_sort_perms` gives, so where the sort runs never changes
    bytes."""
    from hyperspace_tpu_torch.ops.sortkeys import key_lanes, lanes_as_unsigned, lexsort_lanes

    lanes = key_lanes(table, key_columns)
    perm = np.arange(table.num_rows, dtype=np.int64)
    if native.sort_range(perm, lanes_as_unsigned(lanes)):
        return perm
    return lexsort_lanes(lanes)


def partition_by_bucket(ct: ColumnTable, indexed_columns: list[str], num_buckets: int):
    """(the chunk's rows as Arrow in bucket order, the bucket starts
    [num_buckets + 1]): the stable partition of one decoded chunk that
    both the streaming build and a p1 shard spill from."""
    bucket = bucket_ids(compute_row_hashes(ct, indexed_columns), num_buckets)
    order = np.argsort(bucket, kind="stable")
    starts = np.searchsorted(bucket[order], np.arange(num_buckets + 1))
    return ct.take(torch.from_numpy(order)).to_arrow(), starts


# -- chunked source decode ----------------------------------------------------


def decoded_chunks(
    files: list[str],
    fmt: str,
    columns,
    schema,
    chunk_bytes: int,
    memory_budget_bytes: int,
    footers=None,
):
    """Yield pyarrow Tables of at most about `chunk_bytes` decoded source
    data, by format: parquet by the footers' row-group plan, CSV by
    streamed record batches, ORC by stripes, JSON a file at a time
    (pyarrow has no incremental JSON reader, so the bound holds per file
    there). The streaming build drives it from the coordinator and the
    pooled build's p1 shards each over their own file slice."""
    import pyarrow as pa

    if fmt == "parquet":
        for c in hio.plan_row_group_chunks(files, chunk_bytes, columns, footers=footers):
            yield hio.read_chunk(c, columns)
        return
    if fmt == "csv":
        from pyarrow import csv as pcsv

        types = hio._arrow_types_for(schema)
        for f in files:
            opts = pcsv.ConvertOptions(
                include_columns=list(columns) if columns is not None else None, column_types=types,
            )
            ropts = pcsv.ReadOptions(block_size=int(max(16 << 10, min(chunk_bytes // 4, (1 << 31) - 1))))
            with pcsv.open_csv(f, read_options=ropts, convert_options=opts) as reader:
                buf, size = [], 0
                for batch in reader:
                    buf.append(batch)
                    size += batch.nbytes
                    if size >= chunk_bytes:
                        yield pa.Table.from_batches(buf)
                        buf, size = [], 0
                if buf:
                    yield pa.Table.from_batches(buf)
        return
    if fmt == "orc":
        from pyarrow import orc

        for f in files:
            o = orc.ORCFile(f)
            buf, size = [], 0
            for s in range(o.nstripes):
                rb = o.read_stripe(s, columns=list(columns) if columns is not None else None)
                buf.append(rb)
                size += rb.nbytes
                if size >= chunk_bytes:
                    yield pa.Table.from_batches(buf)
                    buf, size = [], 0
            if buf:
                yield pa.Table.from_batches(buf)
        return
    if fmt == "json":
        for f in files:
            # A single file above the budget would break the bound: fail
            # with what to do instead.
            if os.stat(f).st_size * 4 > memory_budget_bytes:
                raise HyperspaceError(
                    f"json file {f} (~{os.stat(f).st_size * 4 >> 20} MiB decoded "
                    "estimate) exceeds the build memory budget and JSON has no "
                    "incremental reader; raise "
                    "hyperspace.index.build.memoryBudgetBytes, split the file, "
                    "or convert the source to parquet"
                )
            yield hio._read_one_file(f, "json", list(columns) if columns is not None else None, schema)
        return
    raise HyperspaceError(f"unsupported streaming source format {fmt!r}")


# -- exchange layout ----------------------------------------------------------


def slice_files(files: list[str], sizes: list[int], workers: int) -> list[list[str]]:
    """Partition the file list into at most `workers` *contiguous* slices,
    greedily balanced by byte size. Contiguity is a correctness invariant:
    shard-ordered spill concatenation must reproduce the global file
    order. Never returns an empty slice (fewer files than workers: fewer
    slices)."""
    n = min(max(1, workers), len(files))
    if n <= 1:
        return [list(files)] if files else []
    total = sum(max(1, s) for s in sizes)
    target = total / n
    slices: list[list[str]] = []
    cur: list[str] = []
    cur_bytes = 0
    remaining = len(files)
    for f, s in zip(files, sizes):
        # Leave at least one file for each unstarted slice.
        must_break = len(slices) + 1 < n and remaining <= n - len(slices) - 1 + (0 if cur else 1)
        if cur and (cur_bytes >= target or must_break) and len(slices) + 1 < n:
            slices.append(cur)
            cur, cur_bytes = [], 0
        cur.append(f)
        cur_bytes += max(1, s)
        remaining -= 1
    if cur:
        slices.append(cur)
    return slices


def owner_of(bucket: int, num_owners: int) -> int:
    """bucket id → owner: the shard key of the exchange."""
    return bucket % num_owners


def spill_path(exchange_dir: str | Path, owner: int, shard: int, bucket: int) -> Path:
    """Where shard `shard` spills bucket `bucket` for its owner: one
    parquet file per (shard, bucket), grouped in a directory per owner."""
    return Path(exchange_dir) / f"owner-{owner:05d}" / f"shard-{shard:05d}.bucket-{bucket:05d}.parquet"


def ordered_names(schema, columns: list[str], indexed_columns: list[str]):
    """(sub_schema, ordered column names): the indexed columns first, then
    the payload, the column order of every spill and bucket file."""
    sub_schema = schema.select(columns)
    key_names = [sub_schema.field(c).name for c in indexed_columns]
    payload_names = [f.name for f in sub_schema.fields if f.name not in key_names]
    return sub_schema, key_names + payload_names


def spill_writer(path, arrow_schema, sub_schema, ordered: list[str]):
    """A spill file's ParquetWriter: the index files' cheap codec, no
    statistics (a spill footer is read for sizes only) and dictionary
    encoding for strings only, as `io.write_bucket` writes."""
    import pyarrow.parquet as pq

    return pq.ParquetWriter(
        path, arrow_schema,
        compression=hio.INDEX_WRITE_COMPRESSION,
        write_statistics=False,
        use_dictionary=[f.name for f in sub_schema.select(ordered).fields if f.is_string],
    )


# -- worker bodies ------------------------------------------------------------


@dataclasses.dataclass
class P1Task:
    """One p1 shard worker's assignment (pickled into the spawned
    process): decode `files`, partition by bucket hash, spill for each
    destination owner under `exchange_dir`."""

    worker: int
    files: list[str]
    fmt: str
    columns: list[str]
    schema: object  # Schema (a picklable dataclass)
    indexed_columns: list[str]
    num_buckets: int
    num_owners: int
    chunk_bytes: int
    memory_budget_bytes: int
    exchange_dir: str


@dataclasses.dataclass
class P2Task:
    """One p2 owner worker's assignment: read its buckets' spill files
    (shard order), key-sort, write the final bucket files and stats. It
    carries p1's decoded-byte ledger for its buckets, so the one-ahead
    spill read stays under `window_bytes` without opening a spill
    footer."""

    owner: int
    num_owners: int
    n_shards: int
    num_buckets: int
    exchange_dir: str
    dest_dir: str
    columns: list[str]
    schema: object
    indexed_columns: list[str]
    spill_bytes: dict
    window_bytes: int


def p1_shard(task: P1Task) -> dict:
    """Phase-1 worker body: stream this shard's file slice through the
    chunked decode, partition each chunk by bucket, and append per-bucket
    spill parquet into the owners' exchange directories. Returns {rows,
    chunks, spill_bytes}: the byte ledger p2 budgets from."""
    sub_schema, ordered = ordered_names(task.schema, task.columns, task.indexed_columns)
    writers: dict = {}
    paths: dict[int, Path] = {}
    spill_bytes: dict[int, int] = {}
    total_rows = 0
    n_chunks = 0
    with obs_trace.trace("build.p1.worker", worker=task.worker, files=len(task.files)):
        gen = decoded_chunks(
            task.files, task.fmt, task.columns, task.schema, task.chunk_bytes, task.memory_budget_bytes,
        )
        while True:
            with obs_trace.span("build.p1.decode"):
                at = next(gen, None)
            if at is None:
                break
            n_chunks += 1
            ct = ColumnTable.from_arrow(at, sub_schema, device="cpu").select(ordered)
            total_rows += ct.num_rows
            arrow_sorted, starts = partition_by_bucket(ct, task.indexed_columns, task.num_buckets)
            with obs_trace.span("build.p1.spill"):
                for b in range(task.num_buckets):
                    lo, hi = int(starts[b]), int(starts[b + 1])
                    if hi <= lo:
                        continue
                    w = writers.get(b)
                    if w is None:
                        path = spill_path(task.exchange_dir, owner_of(b, task.num_owners), task.worker, b)
                        path.parent.mkdir(parents=True, exist_ok=True)
                        w = writers[b] = spill_writer(path, arrow_sorted.schema, sub_schema, ordered)
                        paths[b] = path
                    part = arrow_sorted.slice(lo, hi - lo)
                    spill_bytes[b] = spill_bytes.get(b, 0) + part.nbytes
                    w.write_table(part)
        for b in sorted(writers):
            fault_point("build.exchange.write", paths[b])
            writers[b].close()
    return {
        "worker": task.worker,
        "rows": total_rows,
        "chunks": n_chunks,
        "spill_bytes": spill_bytes,
        "spill_files": {b: str(p) for b, p in paths.items()},
        # The evidence that the worker stayed on the host (this call does
        # not itself initialize CUDA).
        "cuda_initialized": torch.cuda.is_initialized(),
    }


def p2_owner(task: P2Task) -> dict:
    """Phase-2 worker body: for every owned bucket (ascending), read its
    spill files in shard order, apply the stable host key sort, and write
    the final bucket file and manifest stats. A one-ahead spill read
    overlaps the sort and encode of the current bucket where both
    buckets' ledger bytes fit the window. Returns {bucket_rows, key_stats,
    col_stats} for the coordinator's manifest merge."""
    from concurrent.futures import ThreadPoolExecutor

    sub_schema, ordered = ordered_names(task.schema, task.columns, task.indexed_columns)
    sel = sub_schema.select(ordered)
    first_key = sub_schema.field(task.indexed_columns[0]).name
    stat_cols = [f.name for f in sel.fields if not f.is_vector and f.name != first_key]
    dest = Path(task.dest_dir)
    owned = [b for b in range(task.num_buckets) if owner_of(b, task.num_owners) == task.owner]
    out_rows: dict[int, int] = {}
    out_key: dict[int, object] = {}
    out_col: dict[int, dict] = {}

    def read_bucket(b: int):
        paths = [spill_path(task.exchange_dir, task.owner, w, b) for w in range(task.n_shards)]
        paths = [p for p in paths if p.exists()]
        if not paths:
            return None
        fault_point("build.exchange.read", paths[0])
        with obs_trace.span("build.p2.read", bucket=b, files=len(paths)):
            return hio.read_parquet([str(p) for p in paths], device="cpu")

    with obs_trace.trace("build.p2.worker", owner=task.owner, buckets=len(owned)):
        empty = ColumnTable.empty(sel, device="cpu")
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut, fut_b = None, None
            for i, b in enumerate(owned):
                if fut is not None and fut_b == b:
                    t = fut.result()
                    fut = None
                else:
                    t = read_bucket(b)
                # One-ahead spill read, admitted only while both buckets'
                # ledger bytes fit the window.
                if i + 1 < len(owned):
                    nb = owned[i + 1]
                    if task.spill_bytes.get(nb, 0) + task.spill_bytes.get(b, 0) <= task.window_bytes:
                        fut, fut_b = ex.submit(obs_trace.wrap(read_bucket), nb), nb
                if t is None:
                    hio.write_bucket(dest, b, empty)
                    out_rows[b] = 0
                    continue
                with obs_trace.span("build.p2.sort", bucket=b, rows=t.num_rows):
                    perm = host_sort_perm(t, task.indexed_columns)
                # Manifest stats before the gather: min / max do not depend
                # on the order, so they equal the serial path's.
                out_rows[b] = t.num_rows
                out_key[b] = hio.bucket_key_stats(t, first_key)
                if stat_cols:
                    out_col[b] = hio.bucket_column_stats(t, stat_cols)
                with obs_trace.span("build.p2.write", bucket=b):
                    hio.write_bucket(dest, b, t.take(torch.from_numpy(perm)))
    return {
        "owner": task.owner, "bucket_rows": out_rows, "key_stats": out_key, "col_stats": out_col,
        "cuda_initialized": torch.cuda.is_initialized(),
    }
