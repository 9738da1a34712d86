"""k-means on the device: the coarse quantizer of the vector index.

A port of the JAX package's `ops/kmeans.py`. Rows are partitioned by
nearest centroid so a query probes only its closest partitions. Each
Lloyd iteration is two matrix products: the distance matrix
[n, d] @ [d, C] and the centroid update, the one-hot assignment
[C, n] @ [n, d]; both run as `torch.matmul` in full float32 (TF32 stays
off). The training sample and the initial centroids are drawn with the
same numpy `default_rng(seed)` calls as the JAX package, so both start
Lloyd from the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

_TRAIN_SAMPLE = 131_072
_ASSIGN_CHUNK = 262_144


def _lloyd(x: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """x [n, d] float32, init [C, d] float32 → trained centroids [C, d]."""
    xsq = torch.sum(x * x, dim=1, keepdim=True)  # [n, 1]
    c = init
    for _ in range(iters):
        d2 = xsq - 2.0 * (x @ c.T) + torch.sum(c * c, dim=1)[None, :]  # [n, C]
        assign = torch.argmin(d2, dim=1)  # first index on ties
        onehot = torch.nn.functional.one_hot(assign, c.shape[0]).to(x.dtype)  # [n, C]
        sums = onehot.T @ x  # [C, d]
        counts = torch.sum(onehot, dim=0)[:, None]  # [C, 1]
        c = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), c)
    return c


def train_centroids(x: torch.Tensor, num_partitions: int, iters: int = 8, seed: int = 0) -> torch.Tensor:
    """Train `num_partitions` centroids on (a sample of) x [n, d], on x's
    device; returns them float32 [num_partitions, d] on that device."""
    n = len(x)
    rng = np.random.default_rng(seed)
    if n > _TRAIN_SAMPLE:
        pick = rng.choice(n, _TRAIN_SAMPLE, replace=False)
        sample = x[torch.from_numpy(pick).to(x.device)]
    else:
        sample = x
    sample = sample.to(torch.float32)
    init_idx = rng.choice(len(sample), min(num_partitions, len(sample)), replace=False)
    init = sample[torch.from_numpy(init_idx).to(x.device)]
    if len(init) < num_partitions:  # degenerate tiny input: repeat rows
        reps = -(-num_partitions // len(init))
        init = init.repeat(reps, 1)[:num_partitions]
    return _lloyd(sample, init, iters)


def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    d2 = torch.sum(x * x, dim=1, keepdim=True) - 2.0 * (x @ c.T) + torch.sum(c * c, dim=1)[None, :]
    return torch.argmin(d2, dim=1).to(torch.int32)


def assign_partitions(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid partition id (int32 [n], on x's device) per row,
    in chunks of `_ASSIGN_CHUNK` rows to bound the distance matrix."""
    c = centroids.to(device=x.device, dtype=torch.float32)
    out = [_assign(x[lo : lo + _ASSIGN_CHUNK].to(torch.float32), c) for lo in range(0, len(x), _ASSIGN_CHUNK)]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32, device=x.device)
