"""Bucket-aligned sort-merge equi-join on one device.

The port of the JAX package's `ops/join.py::merge_join`: both sides
arrive as [B, L] bucket-major padded int32 key codes from one shared,
order-preserving factorization, sorted within each bucket, with pads at
the int32 max (`sentinel_for`). Per bucket, the join is the classic
sorted expansion:

- count: the run [st, en) of every left code in the sorted right codes —
  K2, the port's one batched searchsorted (ops/sortkeys.py::run_bounds;
  the JAX package runs `jnp.searchsorted` here, the same function). The
  left codes being sorted too is what makes K2 fast, not what makes it
  right: a tile of them spans a narrow window of right codes, staged once
  and walked;
- expand: `repeat_interleave` of the left rows by their run lengths and a
  `cumsum` give every (left row, right row) pair, bucket-major, then by
  left row, then by right row — the JAX package's `join_expand` order.

Because bucket(key) is a pure function of the key, the per-bucket joins
concatenated are exactly the global join. The JAX package's TPU-only pair
packing, capacity cache and compaction have no counterpart: the pairs are
dense tensors on the device from the start.

`merge_join_sharded` is the distributed join (the JAX package's function
of that name): the bucket dimension shards over a mesh, shard d owning
the contiguous bucket range the build gave it, and each shard runs
`merge_join` (one K2 launch) on its buckets with no collective; the
shards' pairs, concatenated in shard order, are `merge_join`'s.
"""

from __future__ import annotations

import torch

from hyperspace_tpu_torch.ops.sortkeys import run_bounds
from hyperspace_tpu_torch.parallel.mesh import concat_shards, mesh_size


def sentinel_for(dtype: torch.dtype) -> int:
    """Pad value that sorts after every real key code of `dtype`."""
    return torch.iinfo(dtype).max


def merge_join(lkeys: torch.Tensor, rkeys: torch.Tensor):
    """lkeys/rkeys: [B, L]/[B, R] int32 codes, sorted within each bucket
    row, padded with `sentinel_for(int32)`. Returns (li, ri, totals) on
    the keys' device: int64 local (within-bucket) row indices of every
    match, bucket-major, and the per-bucket match counts [B]."""
    b, lp = lkeys.shape
    st, en = run_bounds(lkeys, rkeys)
    real = lkeys < sentinel_for(lkeys.dtype)
    cnt = torch.where(real, en - st, torch.zeros_like(en)).long()
    totals = cnt.sum(dim=1)
    flat_cnt = cnt.reshape(-1)
    rows = torch.repeat_interleave(torch.arange(b * lp, device=lkeys.device), flat_cnt)
    # Position of each pair inside its left row's run.
    run_start = torch.cumsum(flat_cnt, 0) - flat_cnt
    within = torch.arange(len(rows), device=lkeys.device) - run_start[rows]
    li = rows % lp
    ri = st.reshape(-1).long()[rows] + within
    return li, ri, totals


def merge_join_sharded(lkeys: torch.Tensor, rkeys: torch.Tensor, mesh):
    """`merge_join` with the bucket dimension sharded over `mesh`: shard i
    joins buckets [i·B/D, (i+1)·B/D) on its device; the pairs and counts
    come back to the keys' device in shard order. One device, or a bucket
    count the mesh does not divide, takes `merge_join`."""
    from hyperspace_tpu_torch.execution.device_cache import shard_cached

    d = mesh_size(mesh)
    num_b = lkeys.shape[0]
    if d == 1 or num_b % d != 0:
        return merge_join(lkeys, rkeys)
    per = num_b // d
    parts = [
        merge_join(shard_cached(lkeys, mesh, i, i * per, (i + 1) * per),
                   shard_cached(rkeys, mesh, i, i * per, (i + 1) * per))
        for i in range(d)
    ]
    return tuple(concat_shards([p[j] for p in parts], lkeys.device) for j in range(3))
