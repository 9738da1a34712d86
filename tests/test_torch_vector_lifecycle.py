"""Vector-index refresh (full + incremental) and optimize on the CPU, the
port against the JAX package.

The six cases of tests/test_vector_lifecycle.py run in both packages,
each on its own index of one seeded source (3,000 rows, then 800
appended): after an incremental refresh, and after a full refresh or an
optimize, a full-probe search equals brute force over the grown rows,
and recall at a partial probe holds. The two packages' k-means and
assignments run through different matrix-product libraries, so a row
whose two nearest centroids lie within float32 rounding of each other (a
near tie, tests/test_torch_kmeans.py) may land in either partition: the
partition files are held equal to the JAX package's up to such rows.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch

NP = 8  # partitions
NEAR_TIE = 1e-4
PACKAGES = (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"}))


def _write_emb(root, emb, ids, name):
    d = emb.shape[1]
    table = pa.table({
        "id": pa.array(ids.astype(np.int64)),
        "emb": pa.FixedSizeListArray.from_arrays(pa.array(emb.reshape(-1), type=pa.float32()), d),
    })
    pq.write_table(table, root / name)


@pytest.fixture
def grown(tmp_path):
    """tests/test_vector_lifecycle.py's fixture in both packages: an index
    built on 3,000 rows by each, then 800 rows appended, not yet indexed.
    Returns ({package: (pkg, session, hs, scan, index dir)}, all rows)."""
    rng = np.random.default_rng(7)
    d, c = 16, 8
    centers = rng.standard_normal((c, d)).astype(np.float32) * 4
    e1 = (centers[rng.integers(0, c, 3000)] + rng.standard_normal((3000, d))).astype(np.float32)
    root = tmp_path / "vsrc"
    root.mkdir()
    _write_emb(root, e1, np.arange(3000), "a.parquet")
    out = {}
    for label, pkg, kw in PACKAGES:
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{label}"), num_buckets=NP, **kw)
        hs = pkg.Hyperspace(s)
        scan = s.parquet(root)
        hs.create_vector_index(scan, pkg.VectorIndexConfig("vl", "emb", ["id"], num_partitions=NP))
        out[label] = (pkg, s, hs, scan, tmp_path / f"idx_{label}" / "vl")
    e2 = (centers[rng.integers(0, c, 800)] + rng.standard_normal((800, d))).astype(np.float32)
    _write_emb(root, e2, np.arange(3000, 3800), "b.parquet")
    return out, np.concatenate([e1, e2])


def _ids(result, q):
    return np.asarray(result.rows.decode()["id"]).reshape(q, -1)


def _full_probe_equality(session, hs, scan, emb_all, q=5, k=10):
    rng = np.random.default_rng(3)
    queries = emb_all[rng.choice(len(emb_all), q, replace=False)] + 0.01
    session.disable_hyperspace()
    exact = hs.ann_search(scan, queries, k=k)
    session.enable_hyperspace()
    approx = hs.ann_search(scan, queries, k=k, nprobe=NP)
    np.testing.assert_allclose(np.sort(exact.scores, axis=1), np.sort(approx.scores, axis=1), rtol=1e-4)
    eids, aids = _ids(exact, q), _ids(approx, q)
    for i in range(q):
        assert set(eids[i]) == set(aids[i])


def _near_ties(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Rows whose two nearest centroids are within NEAR_TIE (relative, in
    float64) of each other."""
    d2 = ((x.astype(np.float64)[:, None, :] - c.astype(np.float64)[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) / np.maximum(two[:, 1], 1e-30) <= NEAR_TIE


def _assert_partitions_match(grown, version, emb_all):
    """The version dir's partition files of the two packages: centroids
    within float32 rounding, every row in the same partition but near
    ties, and the manifest's columns equal."""
    pkgs, _ = grown
    dirs = {label: pkgs[label][4] / f"v__={version}" for label, _, _ in PACKAGES}
    cj, ct = (np.load(dirs[label] / "_centroids.npy") for label in ("jax", "torch"))
    np.testing.assert_allclose(ct, cj, rtol=1e-4, atol=1e-4)
    tie = _near_ties(emb_all, cj)
    moved = 0
    for p in range(NP):
        name = f"bucket-{p:05d}.parquet"
        ids = {label: set(pq.read_table(dirs[label] / name)["id"].to_pylist()) for label in ("jax", "torch")}
        diff = ids["jax"] ^ ids["torch"]
        assert all(tie[i] for i in diff), f"partition {p}: rows {sorted(diff)[:5]} moved off a near tie"
        moved += len(diff)
    assert moved <= len(emb_all) // 100


def test_incremental_refresh_restores_equality(grown):
    pkgs, emb_all = grown
    for label, _, _ in PACKAGES:
        pkg, s, hs, scan, idx = pkgs[label]
        s.enable_hyperspace()
        hs.refresh_index("vl", mode="incremental")
        assert s.manager.get_indexes()[0].content.directories == ["v__=0", "v__=1"]
        # The delta dir carries the base version's centroids, unchanged.
        np.testing.assert_array_equal(np.load(idx / "v__=1" / "_centroids.npy"), np.load(idx / "v__=0" / "_centroids.npy"))
        _full_probe_equality(s, hs, scan, emb_all)
        # Appended rows are found: a query AT an appended point.
        res = hs.ann_search(scan, emb_all[3500][None, :], k=1, nprobe=NP)
        assert _ids(res, 1)[0, 0] == 3500
    _assert_partitions_match(grown, 1, emb_all)


def test_incremental_refresh_partial_probe_recall(grown):
    pkgs, emb_all = grown
    rng = np.random.default_rng(4)
    queries = emb_all[rng.choice(len(emb_all), 20, replace=False)] + 0.01
    got = {}
    for label, _, _ in PACKAGES:
        pkg, s, hs, scan, _ = pkgs[label]
        hs.refresh_index("vl", mode="incremental")
        s.disable_hyperspace()
        exact = _ids(hs.ann_search(scan, queries, k=10), 20)
        s.enable_hyperspace()
        approx = _ids(hs.ann_search(scan, queries, k=10, nprobe=3), 20)
        recall = np.mean([len(set(exact[i]) & set(approx[i])) / 10 for i in range(20)])
        assert recall >= 0.9, f"{label}: recall {recall:.2f} after incremental refresh"
        got[label] = recall
    assert got["torch"] == got["jax"]


def test_full_refresh_retrains_single_dir(grown):
    pkgs, emb_all = grown
    for label, _, _ in PACKAGES:
        pkg, s, hs, scan, _ = pkgs[label]
        hs.refresh_index("vl", mode="full")
        assert s.manager.get_indexes()[0].content.directories == ["v__=1"]
        _full_probe_equality(s, hs, scan, emb_all)
    _assert_partitions_match(grown, 1, emb_all)


def test_optimize_compacts_and_retrains(grown):
    pkgs, emb_all = grown
    for label, _, _ in PACKAGES:
        pkg, s, hs, scan, idx = pkgs[label]
        hs.refresh_index("vl", mode="incremental")
        hs.optimize_index("vl")
        assert s.manager.get_indexes()[0].content.directories == ["v__=2"]
        vdir = idx / "v__=2"
        total = sum(pq.read_metadata(vdir / f"bucket-{p:05d}.parquet").num_rows for p in range(NP))
        assert total == len(emb_all)
        assert (vdir / "_centroids.npy").exists()
        _full_probe_equality(s, hs, scan, emb_all)
    _assert_partitions_match(grown, 2, emb_all)


def test_incremental_refresh_requires_appends(grown):
    pkgs, _ = grown
    msgs = {}
    for label, _, _ in PACKAGES:
        pkg, s, hs, _, _ = pkgs[label]
        hs.refresh_index("vl", mode="incremental")
        with pytest.raises(pkg.HyperspaceError, match="no appended") as e:
            hs.refresh_index("vl", mode="incremental")
        msgs[label] = str(e.value)
    assert msgs["torch"] == msgs["jax"]


def test_optimize_vector_requires_active(grown):
    pkgs, _ = grown
    msgs = {}
    for label, _, _ in PACKAGES:
        pkg, s, hs, _, _ = pkgs[label]
        hs.delete_index("vl")
        with pytest.raises(pkg.HyperspaceError, match="ACTIVE") as e:
            hs.optimize_index("vl")
        msgs[label] = str(e.value)
    assert msgs["torch"] == msgs["jax"]
