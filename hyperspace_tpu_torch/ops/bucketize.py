"""Hash-bucketize: the build's exchange and (bucket, key) sort over a mesh.

The port of the JAX package's `ops/bucketize.py`, the equivalent of
Spark's ShuffleExchangeExec in the build (`repartition(numBuckets,
indexedCols)`, actions/CreateActionBase.scala:110-112):

- shard d of a mesh of D owns the contiguous bucket range
  [d·B/D, (d+1)·B/D) of B buckets; each shard takes a contiguous range of
  the input rows;
- each shard stable-sorts its rows by destination shard and sends each
  destination its slice (`parallel/mesh.py::all_to_all`, the JAX
  package's one `lax.all_to_all`);
- each destination stable-sorts what it received by (bucket, key lanes)
  (`sortkeys.device_lanes_perm`). It receives in source order, which is
  global row order, so equal keys keep their global row order: the result
  is the one-device sort's, element for element.

The JAX package sizes each (source, destination) slot by a capacity
factor and retries on overflow, because XLA needs static shapes. Here
each source counts its rows a destination first and sends exact slices,
so there is no overflow and no retry; `capacity_factor` stays in the
signatures so that callers match, and is not read. On one shard the
permutation is one stable sort on that device (`_one_device_perm`).

Invariants: num_buckets is a multiple of the mesh size (checked here);
bucket ids are a pure function of the key values, so the shards' bucket
ranges partition the key space; rows past `n` are pads and are sent
nowhere.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperspace_tpu_torch.ops.sortkeys import device_lanes_perm, lane_tensor
from hyperspace_tpu_torch.parallel.mesh import Mesh, all_to_all, mesh_size, row_ranges

SENTINEL_BUCKET = 2**30  # the bucket of the pads at each shard's tail


def _one_device_perm(lanes: list, bucket: np.ndarray, num_buckets: int, device: torch.device):
    b = torch.from_numpy(np.ascontiguousarray(bucket, dtype=np.int64)).to(device)
    perm = device_lanes_perm([b] + [lane_tensor(l, device) for l in lanes])
    bucket_rows = torch.bincount(b, minlength=num_buckets)
    return perm.cpu().numpy(), bucket_rows.cpu().numpy()


def _exchange(mesh: Mesh, columns: list, bucket: np.ndarray, keep: np.ndarray, num_buckets: int,
              num_key_cols: int) -> tuple[list, list]:
    """The exchange and the per-destination sort. `columns` are host
    arrays (the first `num_key_cols` sort keys, as int64 lanes), `bucket`
    the rows' bucket ids, `keep` the rows that travel. Returns (for each
    destination shard, its received columns sorted by (bucket, keys);
    its sorted bucket ids)."""
    d = mesh_size(mesh)
    if num_buckets % d != 0:
        raise ValueError(f"num_buckets {num_buckets} must be a multiple of mesh size {d}")
    if len(bucket) % d != 0:
        raise ValueError(f"{len(bucket)} rows are not padded to a multiple of mesh size {d}")
    per_shard_buckets = num_buckets // d
    per = len(bucket) // d
    sends: list[list] = []  # [src] -> [bucket, *columns] each split by destination
    for src, (lo, hi) in enumerate(row_ranges(len(bucket), per, d)):
        dev = mesh.devices[src]
        rows = np.flatnonzero(keep[lo:hi]) + lo
        b = torch.from_numpy(bucket[rows].astype(np.int64)).to(dev)
        dest = b // per_shard_buckets
        order = torch.sort(dest, stable=True).indices
        split = torch.bincount(dest, minlength=d).tolist()
        cols = [b] + [lane_tensor(c[rows], dev) for c in columns]
        sends.append([torch.split(c[order], split) for c in cols])
    # One all_to_all a column: recv[j][dst] is column j at dst.
    recv = [all_to_all([sends[src][j] for src in range(d)], mesh) for j in range(1 + len(columns))]
    out_cols, out_bucket = [], []
    for dst in range(d):
        b = recv[0][dst]
        perm = device_lanes_perm([b] + [recv[1 + j][dst] for j in range(num_key_cols)])
        out_bucket.append(b[perm])
        out_cols.append([recv[1 + j][dst][perm] for j in range(len(columns))])
    return out_cols, out_bucket


def bucketize_perm(
    mesh: Mesh,
    lanes: list,
    bucket: np.ndarray,
    n: int,
    num_buckets: int,
    capacity_factor: float = 2.0,
) -> tuple[np.ndarray, np.ndarray]:
    """The permutation-only exchange. `lanes` / `bucket` are host arrays
    padded to a multiple of the mesh size; rows past `n` are pads. Each
    shard carries its rows' global ids as the last lane. Returns (order
    [n] int64 global row ids in (bucket, key) order, bucket_rows
    [num_buckets]). `capacity_factor` is not read (module docstring)."""
    d = mesh_size(mesh)
    if num_buckets % d != 0:
        raise ValueError(f"num_buckets {num_buckets} must be a multiple of mesh size {d}")
    if d == 1:
        return _one_device_perm([l[:n] for l in lanes], bucket[:n], num_buckets, mesh.devices[0])
    gid = np.arange(len(bucket), dtype=np.int64)
    keep = gid < n
    cols, buckets = _exchange(mesh, list(lanes) + [gid], bucket, keep, num_buckets, len(lanes))
    order = np.concatenate([c[-1].cpu().numpy() for c in cols])
    bucket_rows = sum(torch.bincount(b, minlength=num_buckets).cpu().numpy() for b in buckets)
    return order, bucket_rows


def bucketize(
    mesh: Mesh,
    cols: list,
    bucket: np.ndarray,
    valid: np.ndarray,
    num_buckets: int,
    capacity_factor: float = 2.0,
    num_key_cols: int | None = None,
) -> tuple[list, list, list]:
    """The full-row exchange. Inputs are host arrays whose length is a
    multiple of the mesh size; `valid` marks real rows. The first
    `num_key_cols` of `cols` (default: all but the last) are sort keys
    after the exchange. Returns (cols, bucket, valid), each a list of one
    tensor a shard on that shard's device: the rows it owns, sorted by
    (bucket, keys), then pads to the longest shard's length under the
    sentinel bucket with valid 0 and zero columns. Columns travel as
    int64 (`sortkeys.lane_tensor`). `capacity_factor` is not read."""
    if num_key_cols is None:
        num_key_cols = max(0, len(cols) - 1)
    rcols, rbucket = _exchange(mesh, list(cols), np.asarray(bucket), np.asarray(valid).astype(bool), num_buckets,
                               num_key_cols)
    width = max(1, max(len(b) for b in rbucket))

    def pad(t: torch.Tensor, fill: int) -> torch.Tensor:
        return torch.cat([t, torch.full((width - len(t),), fill, dtype=t.dtype, device=t.device)])

    out_cols = [[pad(shard[j], 0) for shard in rcols] for j in range(len(cols))]
    out_valid = [pad(torch.ones(len(b), dtype=torch.int32, device=b.device), 0) for b in rbucket]
    return out_cols, [pad(b, SENTINEL_BUCKET) for b in rbucket], out_valid
