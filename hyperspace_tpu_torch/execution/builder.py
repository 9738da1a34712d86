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

A port of the in-memory path of the JAX package's
`DeviceIndexBuilder.write_table` and `compact`, on one device. Its
streaming (out-of-core) and pooled (multi-process) builds, and with them
compaction of an index larger than memory, are not ported yet.
`DeviceIndexBuilder` implements the `IndexWriter` seam consumed by
CreateAction and the refresh actions, and the `IndexCompactor` seam
consumed by OptimizeAction.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from hyperspace_tpu_torch.dataset import format_suffix, list_data_files
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops.bucketize import bucketize_perm
from hyperspace_tpu_torch.ops.hashing import bucket_ids, compute_row_hashes
from hyperspace_tpu_torch.ops.sortkeys import key_lanes
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan


class DeviceIndexBuilder:
    """IndexWriter whose sort runs on `device`."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.last_build_stats: dict = {}

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
        t0 = time.perf_counter()
        table = hio.read_table_files(files, plan.format, columns=columns, schema=plan.schema, device="cpu")
        t_decode = time.perf_counter() - t0
        phases = self.write_table(table, indexed_columns, num_buckets, dest_path)
        self.last_build_stats = {
            "path": "in-memory",
            "rows": table.num_rows,
            "phases_s": {"decode": t_decode, **phases},
        }

    def compact(self, entry, src_paths: list[Path], dest_path: Path) -> None:
        """Merge all files of each bucket across every live version dir
        (base + incremental-refresh deltas) into one sorted file per bucket
        in the new version dir: every row is read, in the dirs' order and
        the listing's order within a dir, and rebuilt through
        `write_table`, whose stable sort keeps equal keys in that order."""
        files = [fi.path for src in src_paths for fi in list_data_files(src)]
        t0 = time.perf_counter()
        table = hio.read_parquet(files, device="cpu")
        t_decode = time.perf_counter() - t0
        phases = self.write_table(
            table, entry.derived_dataset.indexed_columns, entry.derived_dataset.num_buckets, dest_path
        )
        self.last_build_stats = {
            "path": "compact",
            "rows": table.num_rows,
            "phases_s": {"decode": t_decode, **phases},
        }

    def write_table(
        self,
        table: ColumnTable,
        indexed_columns: list[str],
        num_buckets: int,
        dest_path: Path,
    ) -> dict:
        """Build one index version from a table; returns the phase wall
        times (hash_lanes, partition_sort, carve_encode_write)."""
        table = hio.host_table(table)
        n = table.num_rows
        t0 = time.perf_counter()

        # Host: bucket assignment from the canonical row hash, and the
        # key columns decomposed into order-preserving lanes.
        bucket = bucket_ids(compute_row_hashes(table, indexed_columns), num_buckets)
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
