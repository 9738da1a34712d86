"""ANN query path: probe the vector index (or brute-force the source).

A port of the JAX package's `vector/search.py`. Query flow for
`ann_search`:

1. find an ACTIVE VectorIndex over the scanned dataset whose stored
   signature matches the live data (a stale index falls back to brute
   force, as the covering-index rules fall back to the raw scan);
2. score the queries against the centroids and pick each query's
   `nprobe` nearest partitions (matrix product + top-k, K3);
3. score the union of the probed partitions in one matrix product, mask
   each query's candidates from partitions it did not probe, and select
   the top k (K3), all on the session's device: the [q, m] score matrix
   never leaves it, only [q, k] comes back;
4. gather the payload rows of the winners from the partitions that own
   them.

With nprobe == num_partitions the result is exactly brute force. The
partition embeddings stay on the device between queries, and the payload
tables on the host, each cache under a byte budget.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from pathlib import Path

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.ops.topk import topk
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.schema import Field, Schema


@dataclasses.dataclass
class AnnResult:
    """Top-k matches for one query batch. Row-major: query i's matches are
    `scores[i]`; `rows` holds the matched payload rows as a ColumnTable
    (on the session's device) with a leading `__query__` column."""

    scores: np.ndarray  # [q, k] (higher is better; l2 scores are negated distances)
    rows: ColumnTable


def _device_scores(metric: str, queries: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[q, m] float32 score matrix, higher = better, on the tensors'
    device."""
    q = queries.to(torch.float32)
    x = cand.to(torch.float32)
    if metric == "cos":
        q = q / torch.clamp(torch.linalg.norm(q, dim=1, keepdim=True), min=1e-12)
        x = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)
    dots = q @ x.T
    if metric == "l2":
        qsq = torch.sum(q * q, dim=1, keepdim=True)
        xsq = torch.sum(x * x, dim=1)[None, :]
        return -(qsq - 2.0 * dots + xsq)  # negated squared distance
    return dots


def brute_force_search(
    table: ColumnTable, embedding_column: str, queries, k: int, metric: str = "l2"
) -> AnnResult:
    """Exact search over a materialized table (the no-index fallback)."""
    emb_name = table.schema.field(embedding_column).name
    q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(table.device)
    vals, idx = topk(_device_scores(metric, q, table.columns[emb_name]), k)
    return _gather_result(table, vals, idx)


def _result_with_query_ids(rows: ColumnTable, scores: np.ndarray) -> AnnResult:
    """Attach the leading __query__ column; `rows` is query-major [q*k]
    and `scores` the [q, k] host copy of the top-k values. Slots whose
    score is -inf (the query matched fewer than k candidates) are dropped
    from `rows`; `scores` keeps the -inf markers."""
    q, k = scores.shape
    qcol = torch.arange(q, dtype=torch.int64, device=rows.device).repeat_interleave(k)
    schema = Schema((Field("__query__", "int64"),) + rows.schema.fields)
    out = ColumnTable(
        schema, {"__query__": qcol, **rows.columns}, dict(rows.dictionaries), dict(rows.validity), rows.device
    )
    valid = np.isfinite(scores.reshape(-1))
    if not valid.all():
        out = out.filter_mask(torch.from_numpy(valid).to(rows.device))
    return AnnResult(scores=scores, rows=out)


def _gather_result(table: ColumnTable, vals: torch.Tensor, idx: torch.Tensor) -> AnnResult:
    return _result_with_query_ids(table.take(idx.reshape(-1).long()), vals.cpu().numpy())


def find_vector_index(session, plan: Scan, embedding_column: str | None = None) -> IndexLogEntry | None:
    """ACTIVE VectorIndex over this scan whose signature matches the live
    source exactly."""
    from hyperspace_tpu_torch.rules.base import SignatureMatcher

    matcher = SignatureMatcher()
    for entry in session.manager.get_indexes():
        if entry.derived_dataset.kind != "VectorIndex":
            continue
        if (
            embedding_column is not None
            and entry.derived_dataset.embedding_column.lower() != embedding_column.lower()
        ):
            continue
        if matcher.match(entry, plan):
            return entry
    return None


def ann_search(
    session,
    plan: LogicalPlan,
    queries,
    k: int,
    nprobe: int | None = None,
    embedding_column: str | None = None,
    metric: str | None = None,
) -> AnnResult:
    """Approximate nearest neighbours of `queries` [q, d] over the scanned
    dataset. Uses a matching vector index when hyperspace is enabled and
    one exists (scoring with the INDEX's metric; an explicitly different
    `metric` raises instead of being silently ignored); otherwise
    brute-forces the source exactly, scoring with `metric` (default l2)."""
    queries = np.asarray(queries, dtype=np.float32)
    if queries.ndim == 1:
        queries = queries[None, :]
    if not isinstance(plan, Scan):
        raise HyperspaceError("ann_search operates on a scanned dataset (Scan plan)")
    device = session.device

    entry = find_vector_index(session, plan, embedding_column) if session.is_hyperspace_enabled() else None
    if entry is None:
        # Exact fallback over the raw source.
        if embedding_column is None:
            vec_fields = [f for f in plan.schema.fields if f.is_vector]
            if len(vec_fields) != 1:
                raise HyperspaceError(
                    "embedding_column is required when the schema does not have "
                    "exactly one vector column"
                )
            embedding_column = vec_fields[0].name
        from hyperspace_tpu_torch.execution.executor import Executor

        table = Executor(device).execute(plan)
        return brute_force_search(table, embedding_column, queries, k, metric or "l2")

    dd = entry.derived_dataset
    if metric is not None and metric != dd.metric:
        raise HyperspaceError(
            f"metric {metric!r} conflicts with index {entry.name!r} built with "
            f"metric {dd.metric!r}; omit metric or disable hyperspace for an "
            "exact search with the requested metric"
        )
    # Several live version dirs: partition p is the union of p's files
    # across them. Centroids come from the newest dir carrying a copy.
    from hyperspace_tpu_torch.vector.lifecycle import _live_dirs, load_centroids

    dirs = _live_dirs(entry)
    centroids = load_centroids(entry)
    num_partitions = dd.num_partitions
    nprobe = num_partitions if nprobe is None else min(nprobe, num_partitions)

    qv = queries
    if dd.metric == "cos":
        qv = qv / np.maximum(np.linalg.norm(qv, axis=1, keepdims=True), 1e-12)
    q_dev = torch.from_numpy(np.ascontiguousarray(qv)).to(device)

    # Stage 1: route queries to their nprobe nearest partitions.
    cscores = _device_scores(dd.metric, q_dev, torch.from_numpy(centroids).to(device))
    _, probe = topk(cscores, nprobe)  # [q, nprobe] on the device

    # Stage 2: candidate geometry from the manifests; no payload IO yet.
    needed = sorted(set(probe.cpu().numpy().reshape(-1).tolist()))
    schema = Schema.from_json(dd.schema)
    rows_map = {(d, p): _partition_rows(d, p) for p in needed for d in dirs}
    sizes = np.array([sum(rows_map[(d, p)] for d in dirs) for p in needed], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])

    # Stage 3: one scoring matrix product and the top-k over the probed
    # candidates, all on the device. Each partition's embeddings stay on
    # the device between batches, so a batch uploads only the queries.
    emb_name = schema.field(dd.embedding_column).name
    emb_parts = [
        _partition_device_emb(d, p, schema, emb_name, device) for p in needed for d in dirs if rows_map[(d, p)] > 0
    ]
    emb_dev = torch.cat(emb_parts) if emb_parts else torch.zeros((0, dd.dim), dtype=torch.float32, device=device)
    scores = _device_scores(dd.metric, q_dev, emb_dev)  # [q, m]
    probed = torch.zeros((len(qv), num_partitions), dtype=torch.bool, device=device)
    probed.scatter_(1, probe.long(), True)
    cand_part = torch.repeat_interleave(
        torch.tensor(needed, dtype=torch.int64, device=device), torch.from_numpy(sizes).to(device)
    )
    scores = scores.masked_fill(~probed[:, cand_part], float("-inf"))
    m = int(offsets[-1])
    vals, idx = topk(scores, min(k, m))

    # Stage 4: payload gather. Read only the partitions owning winning
    # rows, one take per owner, reassembled into slot order.
    # One host copy each of the [q, k] values and indices.
    host_vals = vals.cpu().numpy()
    flat = idx.cpu().numpy().reshape(-1).astype(np.int64)
    # A slot whose score is -inf may point at any candidate; point it at
    # row 0. _result_with_query_ids drops it by its score.
    flat = np.where(np.isfinite(host_vals.reshape(-1)), flat, 0)
    owner = np.searchsorted(offsets, flat, side="right") - 1
    local = flat - offsets[owner]
    group_order = np.argsort(owner, kind="stable")
    grouped: list[ColumnTable] = []
    for o in np.unique(owner):
        part_table = _read_partition_multi(dirs, needed[int(o)], schema, rows_map)
        grouped.append(part_table.take(torch.from_numpy(local[owner == o])))
    regrouped = ColumnTable.concat(grouped)
    inverse = np.empty(len(flat), dtype=np.int64)
    inverse[group_order] = np.arange(len(flat))
    rows = regrouped.take(torch.from_numpy(inverse)).to(device)
    return _result_with_query_ids(rows, host_vals)


def _partition_rows(version_dir: Path, p: int) -> int:
    """Row count of partition p in one version dir (0 when the dir has no
    file for it), from the dir's manifest or the parquet footer."""
    path = version_dir / hio.bucket_file_name(p)
    if not path.exists():
        return 0
    manifest = hio.read_manifest_cached(version_dir)
    if manifest is not None and p < len(manifest.get("bucketRows", [])):
        return int(manifest["bucketRows"][p])
    import pyarrow.parquet as pq

    return int(pq.read_metadata(path).num_rows)


def _read_partition_multi(dirs: list[Path], p: int, schema: Schema, rows_map: dict) -> ColumnTable:
    """Partition p's payload rows concatenated across version dirs, in the
    same dir order the embedding concat uses (offsets stay aligned)."""
    parts = [_read_partition(d, p, schema) for d in dirs if rows_map[(d, p)] > 0]
    if not parts:
        return ColumnTable.empty(schema, device="cpu")
    return ColumnTable.concat(parts)


# Per-process caches, each FIFO-evicted past its byte budget: the payload
# tables of partition files on the host, and their embedding matrices on
# the device. One lock covers both: the eviction is a read-modify-write
# that concurrent callers must not interleave.
_VEC_CACHE_LOCK = threading.Lock()
_PARTITION_CACHE: dict = {}
_PARTITION_CACHE_BYTES = 2 * 1024**3
_DEVICE_EMB_CACHE: dict = {}
_DEVICE_EMB_CACHE_BYTES = 4 * 1024**3


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _table_bytes(t: ColumnTable) -> int:
    return sum(_nbytes(v) for v in t.columns.values())


def _cache_put(cache: dict, key, value, size, budget: int) -> None:
    with _VEC_CACHE_LOCK:
        cache[key] = value
        total = sum(size(v) for v in cache.values())
        while total > budget and len(cache) > 1:
            total -= size(cache.pop(next(iter(cache))))


def _partition_device_emb(version_dir: Path, p: int, schema: Schema, emb_name: str, device: torch.device):
    path = str(version_dir / hio.bucket_file_name(p))
    key = (path, os.stat(path).st_mtime_ns, emb_name, str(device))
    with _VEC_CACHE_LOCK:
        hit = _DEVICE_EMB_CACHE.get(key)
    if hit is not None:
        return hit
    # Only the embedding column: payload columns are read by
    # _read_partition when a winning row lands in this partition.
    arr = hio.read_parquet([path], columns=[emb_name], schema=schema, device=device).columns[emb_name]
    _cache_put(_DEVICE_EMB_CACHE, key, arr, _nbytes, _DEVICE_EMB_CACHE_BYTES)
    return arr


def _read_partition(version_dir: Path, p: int, schema: Schema) -> ColumnTable:
    path = str(version_dir / hio.bucket_file_name(p))
    key = (path, os.stat(path).st_mtime_ns)
    with _VEC_CACHE_LOCK:
        hit = _PARTITION_CACHE.get(key)
    if hit is not None:
        return hit
    t = hio.read_parquet([path], columns=schema.names, schema=schema, device="cpu")
    _cache_put(_PARTITION_CACHE, key, t, _table_bytes, _PARTITION_CACHE_BYTES)
    return t
