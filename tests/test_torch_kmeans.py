"""The port's k-means (ops/kmeans.py) against the JAX package's.

Both packages draw the training sample and the initial centroids with the
same numpy calls and run the same Lloyd iteration, in float32, through
different matrix-product libraries. Their distances therefore differ in
the last bits, and a row whose two nearest centroids lie within that
rounding of each other (a near tie: here, closer than 1e-4 relative in
float64) may go to either. One such row moves two centroids, and Lloyd
carries the difference on. So:

- every single Lloyd step from the same centroids agrees, on every
  centroid that no near-tie row touches, and near ties are few;
- whole trainings agree on inputs whose Lloyd trajectory passes no row
  that close to a tie (the inputs below; on tests/test_vector.py's own
  fixture, seed 0 with 16 partitions, one row goes to the other centroid
  in the second step and the two trainings part there: the per-step
  test covers it);
- `assign_partitions` over the same centroids agrees on every row that is
  not a near tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.ops import kmeans as ref
from hyperspace_tpu_torch.ops import kmeans as port

NEAR_TIE = 1e-4


def _embeddings(seed: int, n: int = 4000, d: int = 32, clusters: int = 16) -> np.ndarray:
    """tests/test_vector.py's clustered fixture, from `seed`."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32) * 5
    return centers[rng.integers(0, clusters, n)] + rng.standard_normal((n, d)).astype(np.float32)


def _two_nearest(x: np.ndarray, c: np.ndarray):
    """Per row: the two nearest centroids and the float64 relative gap
    between their squared distances."""
    d2 = ((x.astype(np.float64)[:, None, :] - c.astype(np.float64)[None]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1)[:, :2]
    first, second = np.take_along_axis(d2, order, axis=1).T
    return order, (second - first) / np.maximum(second, 1e-30)


def _ref_step(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    return np.asarray(ref._lloyd(jnp.asarray(x), jnp.asarray(c), iters=1))


@pytest.mark.parametrize("data_seed,partitions", [(0, 16), (1, 16), (2, 8)])
def test_each_lloyd_step_matches_reference_up_to_near_ties(data_seed, partitions):
    x = _embeddings(data_seed)
    c = ref.train_centroids(x, partitions, iters=0, seed=0)
    np.testing.assert_array_equal(port.train_centroids(torch.from_numpy(x), partitions, iters=0).numpy(), c)
    near_total = 0
    for _ in range(8):
        want = _ref_step(x, c)
        got = port._lloyd(torch.from_numpy(x), torch.from_numpy(c.copy()), 1).numpy()
        pair, gap = _two_nearest(x, c)
        near = gap <= NEAR_TIE
        near_total += int(near.sum())
        clean = np.setdiff1d(np.arange(partitions), pair[near].reshape(-1))
        np.testing.assert_allclose(got[clean], want[clean], rtol=1e-4, atol=1e-4)
        c = want
    assert near_total <= len(x) * 8 // 1000, f"{near_total} near-tie rows in 8 steps"


@pytest.mark.parametrize(
    "data_seed,partitions,sample", [(1, 16, None), (2, 8, None), (3, 16, 1000)]
)
def test_train_centroids_matches_reference(monkeypatch, data_seed, partitions, sample):
    x = _embeddings(data_seed)
    if sample is not None:  # both packages draw the same training sample
        monkeypatch.setattr(ref, "_TRAIN_SAMPLE", sample)
        monkeypatch.setattr(port, "_TRAIN_SAMPLE", sample)
    want = ref.train_centroids(x, partitions, iters=8, seed=0)
    got = port.train_centroids(torch.from_numpy(x), partitions, iters=8, seed=0).numpy()
    assert got.shape == want.shape == (partitions, x.shape[1]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_train_centroids_repeats_rows_for_a_tiny_input():
    x = _embeddings(4, n=5)
    want = ref.train_centroids(x, 8, iters=2, seed=0)
    got = port.train_centroids(torch.from_numpy(x), 8, iters=2, seed=0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_assign_partitions_matches_reference_off_near_ties():
    x = _embeddings(0)
    c = ref.train_centroids(x, 16, iters=8, seed=0)
    want = ref.assign_partitions(x, c)
    got = port.assign_partitions(torch.from_numpy(x), torch.from_numpy(c.copy())).numpy()
    assert got.dtype == np.int32
    near = _two_nearest(x, c)[1] <= NEAR_TIE
    assert near.sum() <= len(x) // 1000
    np.testing.assert_array_equal(got[~near], want[~near])


def test_assign_partitions_chunks_give_the_unchunked_answer(monkeypatch):
    x = torch.from_numpy(_embeddings(5))
    c = port.train_centroids(x, 16, iters=4, seed=0)
    whole = port.assign_partitions(x, c)
    monkeypatch.setattr(port, "_ASSIGN_CHUNK", 999)
    chunked = port.assign_partitions(x, c)
    assert torch.equal(chunked, whole)
    assert len(port.assign_partitions(x[:0], c)) == 0
