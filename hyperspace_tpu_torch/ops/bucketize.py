"""Bucketize: the build's (bucket, key) permutation on one device.

The single-device port of the JAX package's `ops/bucketize.py::
bucketize_perm`: there, an `all_to_all` exchange over the mesh is fused
with a per-shard sort by (bucket, key lanes). On one card there is no
exchange, so the permutation is one stable sort by (bucket, key lanes)
over the whole table — the same order the JAX package's device and host
venues produce. The multi-GPU exchange (NCCL `all_to_all`) is a later
slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperspace_tpu_torch.ops.sortkeys import device_lanes_perm, lane_tensor


def bucketize_perm(
    lanes: list[np.ndarray], bucket: np.ndarray, num_buckets: int, device: torch.device
) -> tuple[np.ndarray, np.ndarray]:
    """(order [n] int64 row ids in (bucket, key) order, bucket_rows
    [num_buckets]) from host key lanes and bucket ids, sorted on
    `device`."""
    b = torch.from_numpy(np.ascontiguousarray(bucket, dtype=np.int64)).to(device)
    perm = device_lanes_perm([b] + [lane_tensor(l, device) for l in lanes])
    bucket_rows = torch.bincount(b, minlength=num_buckets)
    return perm.cpu().numpy(), bucket_rows.cpu().numpy()
