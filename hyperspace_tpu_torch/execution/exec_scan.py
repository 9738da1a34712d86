"""Scan + filter execution: device-resident decode and bucket pruning
(Executor mixin).

A port of the JAX package's `execution/exec_scan.py`: `_scan`, `_filter`
and the point (equality / IN) bucket pruning of index scans. Range
(min/max) pruning and hybrid scans are not ported yet; a non-point
predicate over an index scan reads every bucket and masks.
"""

from __future__ import annotations

import itertools
import math
from pathlib import Path

import pyarrow as pa

from hyperspace_tpu_torch.dataset import format_suffix, list_data_files
from hyperspace_tpu_torch.exceptions import IndexCorruptionError
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops.filter import apply_filter
from hyperspace_tpu_torch.ops.hashing import bucket_ids, hash_scalar_key
from hyperspace_tpu_torch.plan.expr import BinOp, Col, Expr, InList, Lit, split_conjuncts
from hyperspace_tpu_torch.plan.nodes import Filter, Scan

# Bucket pruning reads at most this many point combinations; above it
# the (still-correct) mask takes over.
MAX_POINT_COMBOS = 64


def scan_files(scan: Scan) -> list[str]:
    if scan.files is not None:
        return list(scan.files)
    return [fi.path for fi in list_data_files(scan.root, suffix=format_suffix(scan.format))]


def point_prune_names(scan: Scan, predicate: Expr) -> set[str] | None:
    """Bucket file NAMES owned by the predicate's equality/IN literals on
    every bucket column, or None when the predicate does not pin them (or
    the combination count exceeds `MAX_POINT_COMBOS`). IN on the bucket column
    divides IO by numBuckets/|IN|."""
    num_buckets, bucket_cols = scan.bucket_spec
    cand: dict[str, list] = {}
    for conj in split_conjuncts(predicate):
        got: tuple[str, list] | None = None
        if isinstance(conj, BinOp) and conj.op == "eq":
            if isinstance(conj.left, Col) and isinstance(conj.right, Lit):
                got = (conj.left.name.lower(), [conj.right.value])
            elif isinstance(conj.right, Col) and isinstance(conj.left, Lit):
                got = (conj.right.name.lower(), [conj.left.value])
        elif isinstance(conj, InList) and isinstance(conj.child, Col):
            got = (conj.child.name.lower(), list(conj.values))
        if got is not None:
            name, vals = got
            # Conjunctive constraints: keep the smallest candidate list.
            if name not in cand or len(vals) < len(cand[name]):
                cand[name] = vals
    try:
        lists = [cand[c.lower()] for c in bucket_cols]
    except KeyError:
        return None
    if math.prod(len(l) for l in lists) > MAX_POINT_COMBOS:
        return None
    fields = [scan.scan_schema.field(c) for c in bucket_cols]
    names: set[str] = set()
    for combo in itertools.product(*lists):
        h = hash_scalar_key(list(combo), fields)
        names.add(hio.bucket_file_name(int(bucket_ids(h, num_buckets)[0])))
    return names


class ScanFilterMixin:
    def _read(
        self, files: list[str], columns: list[str], schema, index_root: str | None, *, file_rows: bool = False
    ):
        """Read through the session's device cache; files_read counts only
        physical (miss) reads. An unreadable index file surfaces as a
        typed IndexCorruptionError naming the index. With `file_rows`,
        returns (table, per-file row counts), cached together."""

        def read():
            return hio.read_parquet(files, columns=columns, schema=schema, device=self.device, file_rows=file_rows)

        try:
            value, hit = self.cache.get_or_read(files, columns, read, kind="table+rows" if file_rows else "table")
        except (OSError, pa.ArrowException) as e:
            if index_root is None:
                raise
            raise IndexCorruptionError(
                f"unreadable index data under {index_root}: {e}",
                index_root=index_root,
                path=files[0] if files else None,
            ) from e
        if not hit:
            self.stats["files_read"] += len(files)
        return value

    def _scan(self, scan: Scan) -> ColumnTable:
        files = scan_files(scan)
        cols = scan.scan_schema.names
        if not files:
            return ColumnTable.empty(scan.scan_schema, device=self.device)
        root = scan.root if scan.bucket_spec is not None else None
        return self._read(files, cols, scan.scan_schema, root)

    def _filter(self, plan: Filter) -> ColumnTable:
        child = plan.child
        if isinstance(child, Scan) and child.bucket_spec is not None:
            pruned = self._prune_bucket_files(child, plan.predicate)
            if pruned is not None:
                self.stats["scan"] = "IndexPointLookup"
                table = self._read(pruned, child.scan_schema.names, child.scan_schema, child.root)
                return apply_filter(table, plan.predicate)
        return apply_filter(self._execute(child), plan.predicate)

    def _prune_bucket_files(self, scan: Scan, predicate: Expr) -> list[str] | None:
        """If the predicate pins every bucket column with equality
        literals — single (eq) or multi-point (IN) — return only the
        owning buckets' files."""
        names = point_prune_names(scan, predicate)
        if names is None:
            return None
        files = scan_files(scan)
        matches = [f for f in files if Path(f).name in names]
        if matches:
            self.stats["files_pruned"] += len(files) - len(matches)
            return matches
        return None
