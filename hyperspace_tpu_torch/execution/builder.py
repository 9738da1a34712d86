"""The index build pipeline: scan → hash-bucketize → sort → persist.

This is the framework's write hot path — the re-design of the reference's
`df.repartition(numBuckets, indexedCols)` + bucketed sorted Parquet write
(actions/CreateActionBase.scala:99-120 and
index/DataFrameWriterExtensions.scala:49-78):

  host:   parquet → ColumnTable (strings dict-encoded) → row hashes (the
          same uint32 function the query plane uses for bucket pruning)
          and the order-preserving key lanes
  device: ONE stable sort by (bucket, key lanes) (ops/bucketize.py)
  host:   carve the bucket-grouped, key-sorted rows into one parquet file
          per bucket + a manifest of per-bucket row counts and stats

A port of the JAX package's `DeviceIndexBuilder` on one device, with its
three build paths:

- **in-memory**, where the parquet footers' uncompressed estimate fits
  `memory_budget_bytes`: one host decode, one stable sort on the card
  returning the row permutation, one threaded carve;
- **streaming** (out of core), where it does not: phase 1 decodes the
  source in chunks of at most `chunk_bytes` (the next chunk decoding on a
  thread while this one is hashed), partitions each chunk by bucket and
  appends it to a spill file per bucket; phase 2 reads the spill files
  back in batches of at most `chunk_bytes`, sorts each batch's keys on the
  card in one batched pass (`ops/sortkeys.device_sort_perms`) and writes
  the final files. With the pipeline on (`pipeline_enabled`), phase 1's
  spill encodes run on a thread and phase 2 is three stages behind a
  byte-budgeted window (`_p2_pipelined`); off, the serial two phases, the
  byte-for-byte reference the pipeline is held to;
- **pooled** (`workers` > 0): the streaming build split across spawned
  worker processes that exchange rows through spill files
  (execution/build_exchange.py), byte-identical to the serial streaming
  build at every worker count. Its workers sort on the host and never
  touch the card.

Host memory is bounded by the chunk and the window, never the source
size. `compact` (OptimizeAction's seam) merges every live version dir
into one sorted file a bucket, in memory or, above the budget, through
the streaming pipeline. The JAX package's host sort venue
(`hyperspace.build.venue`) is not ported: in this process the sort always
runs on the card. `last_build_stats` holds the path, rows, chunks, the
footers' estimate, the phase walls (`phases_s`) and whether the native
host hash was used.
"""

from __future__ import annotations

import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from hyperspace_tpu_torch import native
from hyperspace_tpu_torch.config import DEFAULT_BUILD_MEMORY_BUDGET
from hyperspace_tpu_torch.dataset import format_suffix, list_data_files
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import build_exchange as bx
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.faults import fault_point
from hyperspace_tpu_torch.obs import metrics as obs_metrics
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.ops.bucketize import bucketize_perm
from hyperspace_tpu_torch.ops.hashing import bucket_ids
from hyperspace_tpu_torch.ops.sortkeys import device_sort_perms, key_lanes
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan

# Pipeline telemetry: occupancy is the mean busy fraction of the three
# phase-2 stages over the pipeline's wall (1.0: every stage saturated);
# queue depth is observed at each reader put.
_MET_OCCUPANCY = obs_metrics.gauge(
    "build.pipeline.occupancy",
    "mean busy fraction of the p2 read/sort/write stages over the pipeline wall",
)
_MET_QDEPTH = obs_metrics.histogram(
    "build.pipeline.queue_depth",
    "bucket-completion queue depth at each reader put",
    buckets=obs_metrics.COUNT_BUCKETS,
)
_MET_POOL_WORKERS = obs_metrics.gauge(
    "build.workers.active",
    "worker processes the pooled build currently has spawned (0 between builds)",
)


def _prefetched(it):
    """One-ahead prefetch over an iterator: the next item decodes on a
    thread while the caller processes the current one, each step under a
    `build.p1.decode` span planted from the caller."""
    sentinel = object()
    it = iter(it)

    def step():
        with obs_trace.span("build.p1.decode"):
            return next(it, sentinel)

    step = obs_trace.wrap(step)
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(step)
        while True:
            cur = fut.result()
            if cur is sentinel:
                return
            fut = ex.submit(step)
            yield cur


class DeviceIndexBuilder:
    """IndexWriter and IndexCompactor whose sorts run on `device`."""

    def __init__(
        self,
        device: torch.device,
        memory_budget_bytes: int | None = None,
        chunk_bytes: int | None = None,
        pipeline_enabled: bool = True,
        pipeline_max_inflight_bytes: int = 0,
        workers: int = 0,
        exchange_dir: str | None = None,
    ):
        self.device = torch.device(device)
        if memory_budget_bytes is None:
            memory_budget_bytes = DEFAULT_BUILD_MEMORY_BUDGET
        self.memory_budget_bytes = memory_budget_bytes
        self.chunk_bytes = chunk_bytes or max(16 << 20, memory_budget_bytes // 8)
        self.pipeline_enabled = pipeline_enabled
        self.pipeline_max_inflight_bytes = pipeline_max_inflight_bytes
        self.workers = int(workers)
        self.exchange_dir = str(exchange_dir) if exchange_dir else None
        self.last_build_stats: dict = {}

    def _stats(self, **stats) -> None:
        self.last_build_stats = {**stats, "native": native.available(), "hash_path": native.path_taken()}

    # -- IndexWriter -----------------------------------------------------
    def write(
        self,
        plan: LogicalPlan,
        columns: list[str],
        indexed_columns: list[str],
        num_buckets: int,
        dest_path: Path,
    ) -> None:
        if not isinstance(plan, Scan):
            raise HyperspaceError("index builds materialize scan-only plans")
        if plan.files is not None:
            files = list(plan.files)
        else:
            files = [fi.path for fi in list_data_files(plan.root, suffix=format_suffix(plan.format))]
        if self.workers > 0 and files:
            # The pooled build IS a streaming build (it exchanges through
            # spill files), so it runs whatever the estimate.
            self._write_pooled(files, plan.scan_schema, columns, indexed_columns, num_buckets, dest_path,
                               fmt=plan.format)
            return
        footers = None
        if plan.format == "parquet":
            footers = hio.read_footers(files)
            est = hio.estimate_uncompressed_bytes(files, columns, footers=footers)
        else:
            # Other formats: a rough inflate of the size on disk picks the
            # path; above the budget they stream too (CSV by record
            # batches, ORC by stripes, JSON a file at a time).
            est = sum(os.stat(f).st_size for f in files) * 4
        if est > self.memory_budget_bytes:
            self._write_streaming(files, plan.scan_schema, columns, indexed_columns, num_buckets, dest_path,
                                  est, footers=footers, fmt=plan.format)
            return
        t0 = time.perf_counter()
        table = hio.read_table_files(files, plan.format, columns=columns, schema=plan.schema, device="cpu")
        t_decode = time.perf_counter() - t0
        phases = self.write_table(table, indexed_columns, num_buckets, dest_path)
        self._stats(path="in-memory", bytes_estimate=est, rows=table.num_rows,
                    phases_s={"decode": t_decode, **phases})

    # -- OptimizeAction's compactor seam ---------------------------------
    def compact(self, entry, src_paths: list[Path] | Path, dest_path: Path) -> None:
        """Merge all files of each bucket across every live version dir
        (base + incremental-refresh deltas) into one sorted file per bucket
        in the new version dir: every row is read, in the dirs' order and
        the listing's order within a dir, and rebuilt by a stable sort,
        which keeps equal keys in that order. An index above the memory
        budget compacts through the streaming pipeline that built it."""
        from hyperspace_tpu_torch.schema import Schema

        num_buckets = entry.derived_dataset.num_buckets
        indexed = entry.derived_dataset.indexed_columns
        if isinstance(src_paths, (str, Path)):
            src_paths = [src_paths]
        files = [fi.path for src in src_paths for fi in list_data_files(src)]
        footers = hio.read_footers(files)
        est = hio.estimate_uncompressed_bytes(files, footers=footers)
        if est > self.memory_budget_bytes:
            import pyarrow.parquet as pq

            schema = Schema.from_arrow(pq.ParquetFile(files[0]).schema_arrow)
            self._write_streaming(files, schema, list(schema.names), indexed, num_buckets, dest_path, est,
                                  footers=footers)
            return
        t0 = time.perf_counter()
        table = hio.read_parquet(files, device="cpu")
        t_decode = time.perf_counter() - t0
        phases = self.write_table(table, indexed, num_buckets, dest_path)
        self._stats(path="compact", bytes_estimate=est, rows=table.num_rows,
                    phases_s={"decode": t_decode, **phases})

    def write_table(
        self,
        table: ColumnTable,
        indexed_columns: list[str],
        num_buckets: int,
        dest_path: Path,
    ) -> dict:
        """Build one index version from a table in memory; returns the
        phase wall times (hash_lanes, partition_sort, carve_encode_write)."""
        table = hio.host_table(table)
        n = table.num_rows
        t0 = time.perf_counter()

        # Host: bucket assignment from the canonical row hash, and the
        # key columns decomposed into order-preserving lanes.
        bucket = bucket_ids(bx.compute_row_hashes(table, indexed_columns), num_buckets)
        key_names = [table.schema.field(c).name for c in indexed_columns]
        lanes = key_lanes(table, indexed_columns)
        t_hash = time.perf_counter()

        # Device: one stable sort by (bucket, key lanes); the permutation
        # and the per-bucket counts come back.
        order, bucket_rows = bucketize_perm(lanes, bucket, num_buckets, self.device)
        if len(order) != n:
            raise HyperspaceError(f"row count changed through the sort: {n} → {len(order)}")
        t_sort = time.perf_counter()

        # Host: carve into per-bucket files (keys first, then payload —
        # the JAX package's column order).
        payload_names = [f.name for f in table.schema.fields if f.name not in key_names]
        hio.carve_and_write(
            Path(dest_path), table.select(key_names + payload_names),
            bucket_rows, indexed_columns, order,
        )
        t_done = time.perf_counter()
        return {
            "hash_lanes": t_hash - t0,
            "partition_sort": t_sort - t_hash,
            "carve_encode_write": t_done - t_sort,
        }

    # -- streaming out-of-core build -------------------------------------
    def _write_streaming(
        self,
        files: list[str],
        schema,
        columns: list[str],
        indexed_columns: list[str],
        num_buckets: int,
        dest_path: Path,
        est_bytes: int,
        footers=None,
        fmt: str = "parquet",
    ) -> None:
        dest = Path(dest_path)
        spill = dest.parent / (dest.name + ".spill")
        if spill.exists():
            shutil.rmtree(spill)
        spill.mkdir(parents=True, exist_ok=True)
        sub_schema, ordered = bx.ordered_names(schema, columns, indexed_columns)
        pipelined = self.pipeline_enabled
        writers: dict = {}
        spill_bytes: dict[int, int] = {}
        total_rows = 0
        n_chunks = 0
        pipe_info: dict | None = None
        try:
            # Phase 1: the decode of chunk i+1 overlaps the hash, partition
            # and spill of chunk i. Pipelined, the spill encodes of chunk i
            # also run on a thread (after chunk i-1's, so each spill file
            # gets its chunks in order and the bytes equal the serial
            # path's; host memory stays within two chunks).
            t_p1 = time.perf_counter()
            decode_wait = 0.0
            gen = _prefetched(
                bx.decoded_chunks(files, fmt, columns, schema, self.chunk_bytes, self.memory_budget_bytes,
                                  footers=footers)
            )
            done = object()

            def encode_chunk(parts: list) -> None:
                with obs_trace.span("build.p1.spill", parts=len(parts)):
                    for w, part in parts:
                        w.write_table(part)

            encode_chunk_w = obs_trace.wrap(encode_chunk)
            with ThreadPoolExecutor(max_workers=2) as p1_pool:
                spill_fut = None
                while True:
                    tw = time.perf_counter()
                    at = next(gen, done)
                    decode_wait += time.perf_counter() - tw
                    if at is done:
                        break
                    n_chunks += 1
                    ct = ColumnTable.from_arrow(at, sub_schema, device="cpu").select(ordered)
                    total_rows += ct.num_rows
                    arrow_sorted, starts = bx.partition_by_bucket(ct, indexed_columns, num_buckets)
                    parts: list = []
                    for b in range(num_buckets):
                        lo, hi = int(starts[b]), int(starts[b + 1])
                        if hi <= lo:
                            continue
                        w = writers.get(b)
                        if w is None:
                            w = writers[b] = bx.spill_writer(
                                spill / hio.bucket_file_name(b), arrow_sorted.schema, sub_schema, ordered,
                            )
                        part = arrow_sorted.slice(lo, hi - lo)
                        # The decoded-size ledger phase 2's window admits
                        # buckets by (no spill footer is read for it).
                        spill_bytes[b] = spill_bytes.get(b, 0) + part.nbytes
                        parts.append((w, part))
                    if pipelined:
                        if spill_fut is not None:
                            spill_fut.result()
                        spill_fut = p1_pool.submit(encode_chunk_w, parts)
                    else:
                        for w, part in parts:
                            w.write_table(part)
                if spill_fut is not None:
                    spill_fut.result()
            if not pipelined:
                for w in writers.values():
                    w.close()
            t_p2 = time.perf_counter()

            # Phase 2. Pipelined: the writers' closes feed a bucket queue;
            # the spill read of bucket b+1 overlaps the key sort of b and
            # the final write of b-1. Serial: batches of at most
            # chunk_bytes, each read, sorted in one device pass, written.
            dest.mkdir(parents=True, exist_ok=True)
            bucket_rows = [0] * num_buckets
            key_stats: list = [None] * num_buckets
            col_stats: list = [None] * num_buckets
            stat_cols = [
                f.name for f in sub_schema.select(ordered).fields
                if not f.is_vector and f.name != sub_schema.field(indexed_columns[0]).name
            ]
            if pipelined:
                pipe_info = self._p2_pipelined(
                    writers, spill, spill_bytes, dest, sub_schema, ordered, indexed_columns, num_buckets,
                    stat_cols, bucket_rows, key_stats, col_stats,
                )
            else:
                self._p2_serial(spill, dest, sub_schema, ordered, indexed_columns, num_buckets, stat_cols,
                                bucket_rows, key_stats, col_stats)
            hio.write_manifest(
                dest, num_buckets, indexed_columns, bucket_rows,
                key_stats if any(s is not None for s in key_stats) else None,
                col_stats if any(s is not None for s in col_stats) else None,
            )
        finally:
            shutil.rmtree(spill, ignore_errors=True)
        t_end = time.perf_counter()
        self._stats(
            path="streaming", format=fmt, bytes_estimate=est_bytes, chunks=n_chunks, rows=total_rows,
            # p1 = decode → hash → partition → spill (decode_wait: the part
            # of the decode the prefetch did not hide); p2 = spill read →
            # key sort → final write (pipelined: the overlapped wall).
            phases_s={
                "p1_decode_hash_spill": t_p2 - t_p1,
                "p1_decode_wait": decode_wait,
                "p2_sort_encode_write": t_end - t_p2,
            },
        )
        if pipe_info is not None:
            self.last_build_stats["pipeline"] = pipe_info

    def _p2_serial(self, spill: Path, dest: Path, sub_schema, ordered, indexed_columns, num_buckets, stat_cols,
                   bucket_rows, key_stats, col_stats) -> None:
        """The serial phase 2: batches planned from the spill footers (at
        most chunk_bytes of bucket data resident at once), each batch read
        on threads, its keys sorted in one device pass, and its buckets
        written on threads."""
        spill_files = {
            b: str(spill / hio.bucket_file_name(b))
            for b in range(num_buckets) if (spill / hio.bucket_file_name(b)).exists()
        }
        spill_footers = hio.read_footers(list(spill_files.values()))
        bucket_bytes = {
            b: hio.estimate_uncompressed_bytes([p], footers={p: spill_footers[p]}) for b, p in spill_files.items()
        }
        batches: list[list[int]] = []
        cur: list[int] = []
        cur_bytes = 0
        for b in sorted(spill_files):
            if cur and cur_bytes + bucket_bytes[b] > self.chunk_bytes:
                batches.append(cur)
                cur, cur_bytes = [], 0
            cur.append(b)
            cur_bytes += bucket_bytes[b]
        if cur:
            batches.append(cur)
        with ThreadPoolExecutor(max_workers=8) as pool:
            empty = ColumnTable.empty(sub_schema.select(ordered), device="cpu")
            for b in range(num_buckets):
                if b not in spill_files:
                    hio.write_bucket(dest, b, empty)
            for ids in batches:
                tables = list(pool.map(lambda b: hio.read_parquet([spill_files[b]], device="cpu"), ids))
                with obs_trace.span("build.p2.sort", buckets=len(ids), rows=sum(t.num_rows for t in tables)):
                    perms = device_sort_perms(tables, indexed_columns, self.device)
                futs = [
                    pool.submit(hio.write_bucket, dest, b, t.take(torch.from_numpy(p)))
                    for b, t, p in zip(ids, tables, perms)
                ]
                for b, t in zip(ids, tables):
                    bucket_rows[b] = t.num_rows
                    key_stats[b] = hio.bucket_key_stats(t, indexed_columns[0])
                    if stat_cols:
                        col_stats[b] = hio.bucket_column_stats(t, stat_cols)
                for f in futs:
                    f.result()

    def _p2_pipelined(
        self,
        writers,
        spill: Path,
        spill_bytes: dict[int, int],
        dest: Path,
        sub_schema,
        ordered: list[str],
        indexed_columns: list[str],
        num_buckets: int,
        stat_cols: list[str],
        bucket_rows: list,
        key_stats: list,
        col_stats: list,
    ) -> dict:
        """The three-stage phase 2 behind a bounded bucket queue: the spill
        writers' closes run on the pool and feed the queue as they land;
        the reader admits buckets under a byte-budgeted in-flight window
        and decodes them (`spill.read`); the sort stage (this thread)
        computes each micro-batch's key permutations on the card (its
        uploads and readback on the card's default stream, from this
        thread only); write tasks gather and encode the final files. So the
        spill read of bucket b+1 overlaps the key sort of b and the write of
        b-1. Crash-safe: a reader's failure re-raises on this thread through
        the error sentinel, writers release their window bytes in
        `finally`, and the stop flag unblocks a parked reader, so the spill
        dir's cleanup (the caller's `finally`) always runs.

        Fills bucket_rows / key_stats / col_stats in place (one slot a
        bucket) and returns the pipeline telemetry."""
        import queue as _queue
        import threading

        # The window covers buckets across all three stages (a bucket's
        # bytes release when its final write lands), so it needs headroom
        # beyond one sort batch or the reader starves.
        window = self.pipeline_max_inflight_bytes or max(1, 4 * self.chunk_bytes)
        cv = threading.Condition()
        inflight = {"bytes": 0}
        stop = [False]
        ready: "_queue.Queue" = _queue.Queue()  # buckets whose spill writer closed
        sortq: "_queue.Queue" = _queue.Queue()  # (bucket, table, nbytes) | _DONE | _ERR
        _DONE, _ERR = object(), object()
        busy = {"read": 0.0, "sort": 0.0, "write": 0.0}
        busy_lock = threading.Lock()
        max_depth = [0]
        spill_ids = sorted(writers)
        n_spilled = len(spill_ids)

        def close_one(b: int) -> None:
            try:
                writers[b].close()
            finally:
                # Queued even after a failed close: the reader's decode of
                # the torn spill file surfaces the error (never a hang).
                ready.put(b)

        def read_loop() -> None:
            try:
                for _ in range(n_spilled):
                    b = ready.get()
                    if stop[0]:
                        return
                    nb = max(1, spill_bytes.get(b, 1))
                    with cv:
                        while not stop[0] and inflight["bytes"] > 0 and inflight["bytes"] + nb > window:
                            cv.wait()
                        if stop[0]:
                            return
                        inflight["bytes"] += nb
                    path = str(spill / hio.bucket_file_name(b))
                    fault_point("spill.read", path)
                    t0 = time.perf_counter()
                    with obs_trace.span("build.p2.read", bucket=b, bytes=nb):
                        t = hio.read_parquet([path], device="cpu")
                    with busy_lock:
                        busy["read"] += time.perf_counter() - t0
                    fault_point("pipeline.put", path)
                    sortq.put((b, t, nb))
                    d = sortq.qsize()
                    _MET_QDEPTH.observe(d)
                    max_depth[0] = max(max_depth[0], d)
            except BaseException:
                sortq.put(_ERR)
                raise
            sortq.put(_DONE)

        def write_one(b: int, t: ColumnTable, perm: np.ndarray, nb: int) -> None:
            try:
                t0 = time.perf_counter()
                with obs_trace.span("build.p2.write", bucket=b):
                    # Manifest stats ride the write stage (min / max do not
                    # depend on the order, so they equal the serial path's).
                    bucket_rows[b] = t.num_rows
                    key_stats[b] = hio.bucket_key_stats(t, indexed_columns[0])
                    if stat_cols:
                        col_stats[b] = hio.bucket_column_stats(t, stat_cols)
                    hio.write_bucket(dest, b, t.take(torch.from_numpy(perm)))
                with busy_lock:
                    busy["write"] += time.perf_counter() - t0
            finally:
                with cv:
                    inflight["bytes"] -= nb
                    cv.notify_all()

        t_start = time.perf_counter()
        wfuts: list = []
        with ThreadPoolExecutor(max_workers=8) as pool:
            empty = ColumnTable.empty(sub_schema.select(ordered), device="cpu")
            for b in range(num_buckets):
                if b not in writers:
                    wfuts.append(pool.submit(obs_trace.wrap(hio.write_bucket), dest, b, empty))
            for b in spill_ids:
                pool.submit(obs_trace.wrap(close_one), b)
            rfut = pool.submit(obs_trace.wrap(read_loop))
            try:
                sentinel = None
                item = None
                while sentinel is None:
                    fault_point("pipeline.get")
                    item = sortq.get()
                    if item is _DONE or item is _ERR:
                        break
                    # Micro-batch: whatever the reader has staged (at most 8
                    # buckets) sorts in ONE device pass. Each table pads and
                    # sorts independently inside the batch, so a bucket's
                    # permutation does not depend on its batch.
                    batch = [item]
                    while len(batch) < 8:
                        try:
                            nxt = sortq.get_nowait()
                        except _queue.Empty:
                            break
                        if nxt is _DONE or nxt is _ERR:
                            sentinel = nxt
                            break
                        batch.append(nxt)
                    ts = [t for _, t, _ in batch]
                    t0 = time.perf_counter()
                    with obs_trace.span("build.p2.sort", buckets=len(batch), rows=sum(t.num_rows for t in ts)):
                        perms = device_sort_perms(ts, indexed_columns, self.device)
                    busy["sort"] += time.perf_counter() - t0
                    for (b, t, nb), perm in zip(batch, perms):
                        wfuts.append(pool.submit(obs_trace.wrap(write_one), b, t, perm, nb))
                item = sentinel if sentinel is not None else item
                if item is _ERR:
                    rfut.result()  # re-raises the reader's failure here
            finally:
                with cv:
                    stop[0] = True
                    cv.notify_all()
            for f in wfuts:
                f.result()
        wall = time.perf_counter() - t_start
        occ = sum(min(v, wall) for v in busy.values()) / (3 * wall) if wall > 0 else 0.0
        _MET_OCCUPANCY.set(round(occ, 4))
        return {
            "occupancy": round(occ, 4),
            "max_queue_depth": max_depth[0],
            "window_bytes": window,
            "stage_busy_s": dict(busy),
        }

    # -- scale-out pooled build ------------------------------------------
    def _exchange_root(self, dest: Path) -> Path:
        """Where this build's cross-process spill exchange lives:
        `hyperspace.build.exchange.dir` (suffixed with the dest's name so
        concurrent builds never collide), or `<dest>.exchange` next to the
        version dir."""
        if self.exchange_dir:
            return Path(self.exchange_dir) / f"{dest.parent.name}-{dest.name}.exchange"
        return dest.parent / (dest.name + ".exchange")

    def _write_pooled(
        self,
        files: list[str],
        schema,
        columns: list[str],
        indexed_columns: list[str],
        num_buckets: int,
        dest_path: Path,
        fmt: str = "parquet",
    ) -> None:
        """The scale-out build: bucket id → owner is the shard key, spill
        files are the exchange format, and only paths and the decoded-byte
        ledger cross the process boundary.

        - **p1** — at most `workers` shard processes, each decoding a
          disjoint contiguous slice of the input files, partitioning rows
          by bucket and appending per-bucket spill parquet into the owners'
          exchange dirs (build_exchange.p1_shard);
        - **p2** — at most min(workers, num_buckets) owner processes, each
          reading its buckets' spill in shard order (the global row order),
          key-sorting on the host and writing the final bucket files and
          stats (build_exchange.p2_owner);
        - **coordinator** — slices the files, joins the pools (a dead
          worker is a typed WorkerCrashed, never a hang), merges the
          per-owner stats and writes the manifest. The Action's two-phase
          protocol around it is unchanged.

        The exchange dir is swept in `finally`, success or abort."""
        from hyperspace_tpu_torch import stats
        from hyperspace_tpu_torch.parallel.procpool import TaskPool

        dest = Path(dest_path)
        exchange = self._exchange_root(dest)
        if exchange.exists():
            shutil.rmtree(exchange)
        exchange.mkdir(parents=True, exist_ok=True)
        try:
            sizes = [os.stat(f).st_size for f in files]
        except OSError:
            sizes = [1] * len(files)
        slices = bx.slice_files(files, sizes, self.workers)
        n_shards = len(slices)
        num_owners = max(1, min(self.workers, num_buckets))
        # An owner's one-ahead read window: the pipeline's budget.
        window = self.pipeline_max_inflight_bytes or max(1, 4 * self.chunk_bytes)
        total_rows = 0
        n_chunks = 0
        spill_bytes: dict[int, int] = {}
        try:
            t0 = time.perf_counter()
            with obs_trace.span("build.pool.p1", shards=n_shards):
                with TaskPool("hs-build-p1") as pool:
                    for w, slc in enumerate(slices):
                        fault_point("build.worker.spawn", str(exchange))
                        pool.submit(w, bx.p1_shard, bx.P1Task(
                            worker=w, files=slc, fmt=fmt, columns=list(columns), schema=schema,
                            indexed_columns=list(indexed_columns), num_buckets=num_buckets,
                            num_owners=num_owners, chunk_bytes=self.chunk_bytes,
                            memory_budget_bytes=self.memory_budget_bytes, exchange_dir=str(exchange),
                        ))
                        _MET_POOL_WORKERS.set(w + 1)
                    p1 = pool.join()
            _MET_POOL_WORKERS.set(0)
            for _, res in sorted(p1.items()):
                total_rows += res["rows"]
                n_chunks += res["chunks"]
                for b, nb in res["spill_bytes"].items():
                    spill_bytes[b] = spill_bytes.get(b, 0) + nb
            exchange_bytes = sum(spill_bytes.values())
            stats.increment("build.exchange.bytes", exchange_bytes)
            t_p2 = time.perf_counter()

            dest.mkdir(parents=True, exist_ok=True)
            with obs_trace.span("build.pool.p2", owners=num_owners):
                with TaskPool("hs-build-p2") as pool:
                    for o in range(num_owners):
                        fault_point("build.worker.spawn", str(exchange))
                        pool.submit(o, bx.p2_owner, bx.P2Task(
                            owner=o, num_owners=num_owners, n_shards=n_shards, num_buckets=num_buckets,
                            exchange_dir=str(exchange), dest_dir=str(dest), columns=list(columns),
                            schema=schema, indexed_columns=list(indexed_columns),
                            spill_bytes={b: nb for b, nb in spill_bytes.items() if bx.owner_of(b, num_owners) == o},
                            window_bytes=window,
                        ))
                        _MET_POOL_WORKERS.set(o + 1)
                    p2 = pool.join()
            _MET_POOL_WORKERS.set(0)

            fault_point("build.manifest.merge", str(dest))
            bucket_rows = [0] * num_buckets
            key_stats: list = [None] * num_buckets
            col_stats: list = [None] * num_buckets
            for _, res in sorted(p2.items()):
                for b, r in res["bucket_rows"].items():
                    bucket_rows[b] = r
                for b, s in res["key_stats"].items():
                    key_stats[b] = s
                for b, s in res["col_stats"].items():
                    col_stats[b] = s
            hio.write_manifest(
                dest, num_buckets, indexed_columns, bucket_rows,
                key_stats if any(s is not None for s in key_stats) else None,
                col_stats if any(s is not None for s in col_stats) else None,
            )
            t_end = time.perf_counter()
        finally:
            _MET_POOL_WORKERS.set(0)
            shutil.rmtree(exchange, ignore_errors=True)
        self._stats(
            path="pooled", format=fmt, workers=self.workers, p1_shards=n_shards, p2_owners=num_owners,
            rows=total_rows, chunks=n_chunks, exchange_bytes=exchange_bytes,
            worker_cuda_initialized=any(r["cuda_initialized"] for r in (*p1.values(), *p2.values())),
            phases_s={"p1_decode_hash_spill": t_p2 - t0, "p2_sort_encode_write": t_end - t_p2},
        )
