"""The vector (ANN) index slice end to end on the CPU, the port against the
JAX package: the same index on disk from both, an index built by either
searched by the other, and the reference's own contract (full probe is
brute force, recall at partial probe, metrics, short results, stale
fallback, errors) held by the port.
"""

import json
import pathlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as ref
from hyperspace_tpu_torch import Hyperspace, HyperspaceError, HyperspaceSession, VectorIndexConfig

N, D, C = 4000, 32, 16


def _write_embeddings(root: pathlib.Path, seed: int) -> np.ndarray:
    """tests/test_vector.py's clustered fixture (seed 0 is its own)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((C, D)).astype(np.float32) * 5
    emb = centers[rng.integers(0, C, N)] + rng.standard_normal((N, D)).astype(np.float32)
    table = pa.table({
        "id": pa.array(np.arange(N, dtype=np.int64)),
        "emb": pa.FixedSizeListArray.from_arrays(pa.array(emb.reshape(-1), type=pa.float32()), D),
        "label": pa.array([f"l{i % 5}" for i in range(N)]),
    })
    root.mkdir(parents=True)
    pq.write_table(table, root / "part-0.parquet")
    return emb


@pytest.fixture
def emb_parquet(tmp_path):
    root = tmp_path / "embdata"
    return root, _write_embeddings(root, 0)


def _port(system_path, data):
    s = HyperspaceSession(system_path=str(system_path), num_buckets=8, device="cpu")
    return s, Hyperspace(s), s.parquet(data)


def _ref(system_path, data):
    s = ref.HyperspaceSession(system_path=str(system_path), num_buckets=8)
    return s, ref.Hyperspace(s), s.parquet(data)


def _ids(result, q: int, column: str = "id"):
    """[q, k] payload column of an AnnResult of either package."""
    return np.asarray(result.rows.decode()[column]).reshape(q, -1)


def _score_tolerance(queries, emb, ids, metric):
    """How far two float32 computations of the same scores may differ, for
    the slots `ids` [q, k]: 16 units of float32 rounding (u = 2^-24) of
    the terms' scale. An l2 score is -(|q|² - 2q·x + |x|²), whose terms
    reach (|q| + |x|)² even where the distance is near 0, so a relative
    tolerance cannot hold there; ip's scale is |q||x|, cos's is 1."""
    qn = np.linalg.norm(queries, axis=1)[:, None]
    xn = np.linalg.norm(emb, axis=1)[ids]
    scale = {"l2": (qn + xn) ** 2, "ip": qn * xn, "cos": np.ones_like(xn)}[metric]
    return 16 * 2.0**-24 * scale


def _assert_same_matches(got, want, want_next, queries, emb, metric="l2"):
    """Scores within _score_tolerance of the reference's, and ids and
    labels equal at every slot whose score stands apart (beyond twice that
    tolerance) from both neighbours, the (k+1)-th included."""
    q = len(queries)
    ids = _ids(want, q)
    tol = _score_tolerance(queries, emb, ids, metric)
    assert np.all(np.abs(got.scores - want.scores) <= tol)
    s = np.concatenate([want.scores, want_next.scores[:, -1:]], axis=1)
    gap = s[:, :-1] - s[:, 1:]  # slot j to slot j + 1
    apart = gap > 2 * tol
    apart[:, 1:] &= gap[:, :-1] > 2 * tol[:, 1:]
    assert apart.mean() > 0.8
    for col in [c for c in ("id", "label") if c in want.rows.schema.names]:
        np.testing.assert_array_equal(_ids(got, q, col)[apart], _ids(want, q, col)[apart])


def test_both_packages_build_the_same_index(tmp_path):
    # Data seed 1: on the reference fixture (seed 0) one training row lies
    # within float32 rounding of a tie and the two k-means runs part there
    # (tests/test_torch_kmeans.py).
    data = tmp_path / "embdata"
    _write_embeddings(data, 1)
    ps, ph, pdf = _port(tmp_path / "port", data)
    rs, rh, rdf = _ref(tmp_path / "ref", data)
    ph.create_vector_index(pdf, VectorIndexConfig("v", "emb", ["id", "label"], num_partitions=16))
    rh.create_vector_index(rdf, ref.VectorIndexConfig("v", "emb", ["id", "label"], num_partitions=16))
    port_dir, ref_dir = tmp_path / "port" / "v" / "v__=0", tmp_path / "ref" / "v" / "v__=0"
    assert (port_dir / "_index_manifest.json").read_bytes() == (ref_dir / "_index_manifest.json").read_bytes()
    total = 0
    for p in range(16):
        name = f"bucket-{p:05d}.parquet"
        got, want = pq.read_table(port_dir / name), pq.read_table(ref_dir / name)
        assert got.schema.names == want.schema.names == ["emb", "id", "label"]
        assert got.num_rows == want.num_rows
        total += got.num_rows
        np.testing.assert_array_equal(got["id"].to_numpy(), want["id"].to_numpy())
        assert got["label"].to_pylist() == want["label"].to_pylist()
        assert got["emb"].equals(want["emb"])
    assert total == N
    np.testing.assert_allclose(
        np.load(port_dir / "_centroids.npy"), np.load(ref_dir / "_centroids.npy"), rtol=1e-4, atol=1e-4
    )
    got_entry = ps.manager.get_indexes()[0]
    want_entry = rs.manager.get_indexes()[0]
    assert json.dumps(got_entry.derived_dataset.to_json(), sort_keys=True) == json.dumps(
        want_entry.derived_dataset.to_json(), sort_keys=True
    )
    assert got_entry.source.fingerprint.value == want_entry.source.fingerprint.value
    assert ps.last_build_stats["rows"] == N
    assert set(ps.last_build_stats["phases_s"]) == {"read", "kmeans", "assign", "carve"}


def test_where_the_two_kmeans_runs_part_the_indexes_stay_close(tmp_path, emb_parquet):
    # On the reference fixture one training row lies within float32
    # rounding of a tie, and the two packages' k-means runs part there
    # (tests/test_torch_kmeans.py). What a user gets must still agree: the
    # tie moves two centroids and trades rows between their partitions
    # only, and searches of the two indexes agree off near ties.
    data, emb = emb_parquet
    ps, ph, pdf = _port(tmp_path / "port", data)
    rs, rh, rdf = _ref(tmp_path / "ref", data)
    ph.create_vector_index(pdf, VectorIndexConfig("v", "emb", ["id", "label"], num_partitions=16))
    rh.create_vector_index(rdf, ref.VectorIndexConfig("v", "emb", ["id", "label"], num_partitions=16))
    port_dir, ref_dir = tmp_path / "port" / "v" / "v__=0", tmp_path / "ref" / "v" / "v__=0"
    got_c, want_c = np.load(port_dir / "_centroids.npy"), np.load(ref_dir / "_centroids.npy")
    close = np.all(np.isclose(got_c, want_c, rtol=1e-4, atol=1e-4), axis=1)
    moved = np.flatnonzero(~close)
    assert len(moved) <= 2
    got_m = json.loads((port_dir / "_index_manifest.json").read_text())
    want_m = json.loads((ref_dir / "_index_manifest.json").read_text())
    assert {k: v for k, v in got_m.items() if k != "bucketRows"} == {
        k: v for k, v in want_m.items() if k != "bucketRows"
    }
    assert sum(got_m["bucketRows"]) == sum(want_m["bucketRows"]) == N
    moved_ids: dict = {"port": set(), "ref": set()}
    for p in range(16):
        name = f"bucket-{p:05d}.parquet"
        got, want = pq.read_table(port_dir / name), pq.read_table(ref_dir / name)
        assert [got.num_rows, want.num_rows] == [got_m["bucketRows"][p], want_m["bucketRows"][p]]
        if p in moved:
            moved_ids["port"] |= set(got["id"].to_numpy().tolist())
            moved_ids["ref"] |= set(want["id"].to_numpy().tolist())
        else:
            np.testing.assert_array_equal(got["id"].to_numpy(), want["id"].to_numpy())
            assert got["emb"].equals(want["emb"])
    assert moved_ids["port"] == moved_ids["ref"]
    queries = emb[np.random.default_rng(2).choice(N, 6, replace=False)] + 0.01
    ps.enable_hyperspace()
    rs.enable_hyperspace()
    for nprobe in (4, 16):
        got = ph.ann_search(pdf, queries, k=10, nprobe=nprobe)
        want = rh.ann_search(rdf, queries, k=10, nprobe=nprobe)
        _assert_same_matches(got, want, rh.ann_search(rdf, queries, k=11, nprobe=nprobe), queries, emb)


@pytest.mark.parametrize("builder", ["ref", "port"])
@pytest.mark.parametrize("nprobe", [4, 16])
def test_an_index_built_by_one_package_is_searched_alike_by_the_other(tmp_path, emb_parquet, builder, nprobe):
    data, emb = emb_parquet
    system = tmp_path / "indexes"
    ps, ph, pdf = _port(system, data)
    rs, rh, rdf = _ref(system, data)
    if builder == "ref":
        rh.create_vector_index(rdf, ref.VectorIndexConfig("v", "emb", ["id", "label"], num_partitions=16))
    else:
        ph.create_vector_index(pdf, VectorIndexConfig("v", "emb", ["id", "label"], num_partitions=16))
    queries = emb[np.random.default_rng(2).choice(N, 6, replace=False)] + 0.01
    ps.enable_hyperspace()
    rs.enable_hyperspace()
    got = ph.ann_search(pdf, queries, k=10, nprobe=nprobe)
    want = rh.ann_search(rdf, queries, k=10, nprobe=nprobe)
    want_next = rh.ann_search(rdf, queries, k=11, nprobe=nprobe)
    assert got.rows.schema.names == ["__query__", "emb", "id", "label"]
    np.testing.assert_array_equal(got.rows.decode()["__query__"], np.repeat(np.arange(6), 10))
    _assert_same_matches(got, want, want_next, queries, emb)


def test_brute_force_matches_the_reference(tmp_path, emb_parquet):
    data, emb = emb_parquet
    ps, ph, pdf = _port(tmp_path / "indexes", data)
    rs, rh, rdf = _ref(tmp_path / "indexes", data)
    queries = emb[np.random.default_rng(6).choice(N, 5, replace=False)] + 0.01
    got = ph.ann_search(pdf, queries, k=10)
    _assert_same_matches(got, rh.ann_search(rdf, queries, k=10), rh.ann_search(rdf, queries, k=11), queries, emb)


def test_full_probe_equals_brute_force(tmp_path, emb_parquet):
    data, emb = emb_parquet
    s, hs, df = _port(tmp_path / "indexes", data)
    hs.create_vector_index(df, VectorIndexConfig("vidx", "emb", ["id", "label"], num_partitions=16))
    queries = emb[np.random.default_rng(2).choice(N, 6, replace=False)] + 0.01
    s.disable_hyperspace()
    exact = hs.ann_search(df, queries, k=10)
    s.enable_hyperspace()
    approx = hs.ann_search(df, queries, k=10, nprobe=16)
    np.testing.assert_allclose(np.sort(exact.scores, axis=1), np.sort(approx.scores, axis=1), rtol=1e-4)
    for e, a in zip(_ids(exact, 6), _ids(approx, 6)):
        assert set(e) == set(a)


def test_partial_probe_recall(tmp_path, emb_parquet):
    data, emb = emb_parquet
    s, hs, df = _port(tmp_path / "indexes", data)
    hs.create_vector_index(df, VectorIndexConfig("vidx2", "emb", ["id"], num_partitions=16))
    queries = emb[np.random.default_rng(3).choice(N, 8, replace=False)]
    s.disable_hyperspace()
    exact = _ids(hs.ann_search(df, queries, k=10), 8)
    s.enable_hyperspace()
    approx = _ids(hs.ann_search(df, queries, k=10, nprobe=4), 8)
    recall = np.mean([len(set(exact[i]) & set(approx[i])) / 10 for i in range(8)])
    assert recall >= 0.8, f"recall@10 too low: {recall}"


@pytest.mark.parametrize("metric", ["ip", "cos"])
def test_metrics_match_brute_force_and_the_reference(tmp_path, emb_parquet, metric):
    data, emb = emb_parquet
    s, hs, df = _port(tmp_path / "indexes", data)
    hs.create_vector_index(df, VectorIndexConfig("vm", "emb", ["id"], num_partitions=8, metric=metric))
    q = emb[:3]
    s.enable_hyperspace()
    res = hs.ann_search(df, q, k=5, nprobe=8)
    s.disable_hyperspace()
    exact = hs.ann_search(df, q, k=5, embedding_column="emb", metric=metric)
    np.testing.assert_allclose(np.sort(res.scores, axis=1), np.sort(exact.scores, axis=1), rtol=1e-4)
    rs, rh, rdf = _ref(tmp_path / "indexes", data)
    rs.enable_hyperspace()  # the reference searches the port's index
    want = rh.ann_search(rdf, q, k=5, nprobe=8)
    _assert_same_matches(res, want, rh.ann_search(rdf, q, k=6, nprobe=8), q, emb, metric)


def test_fewer_candidates_than_k_drops_unprobed_rows(tmp_path, emb_parquet):
    data, emb = emb_parquet
    s, hs, df = _port(tmp_path / "indexes", data)
    hs.create_vector_index(df, VectorIndexConfig("vsmall", "emb", ["id"], num_partitions=64))
    s.enable_hyperspace()
    res = hs.ann_search(df, emb[:2], k=500, nprobe=1)  # one partition of about 62 rows
    n_rows = res.rows.num_rows
    assert n_rows < 2 * 500, "short results must be trimmed"
    assert np.isinf(res.scores).sum() == res.scores.size - n_rows
    assert np.all(np.isfinite(res.scores[:, 0]))
    q = res.rows.decode()["__query__"]
    assert list(q) == sorted(q) and set(q) == {0, 1}


def test_stale_vector_index_falls_back_to_brute_force(tmp_path, emb_parquet):
    data, emb = emb_parquet
    s, hs, df = _port(tmp_path / "indexes", data)
    hs.create_vector_index(df, VectorIndexConfig("vstale", "emb", ["id"]))
    extra = np.random.default_rng(5).standard_normal((50, D)).astype(np.float32)
    pq.write_table(pa.table({
        "id": pa.array(np.arange(10_000, 10_050, dtype=np.int64)),
        "emb": pa.FixedSizeListArray.from_arrays(pa.array(extra.reshape(-1), type=pa.float32()), D),
        "label": pa.array(["x"] * 50),
    }), data / "part-new.parquet")
    s.enable_hyperspace()
    from hyperspace_tpu_torch.vector.search import find_vector_index

    assert find_vector_index(s, df) is None
    rs, _, rdf = _ref(tmp_path / "indexes", data)
    rs.enable_hyperspace()
    from hyperspace_tpu.vector.search import find_vector_index as ref_find

    assert ref_find(rs, rdf) is None
    ids = _ids(hs.ann_search(df, extra[:2], k=3), 2)
    assert 10_000 in ids[0] and 10_001 in ids[1]


def test_vector_index_requires_vector_column(tmp_path, emb_parquet):
    data, _ = emb_parquet
    _, hs, df = _port(tmp_path / "indexes", data)
    with pytest.raises(HyperspaceError, match="vector dtype"):
        hs.create_vector_index(df, VectorIndexConfig("bad", "id"))


def test_conflicting_metric_raises(tmp_path, emb_parquet):
    data, emb = emb_parquet
    s, hs, df = _port(tmp_path / "indexes", data)
    hs.create_vector_index(df, VectorIndexConfig("vl2", "emb", ["id"], num_partitions=8))
    s.enable_hyperspace()
    with pytest.raises(HyperspaceError, match="conflicts"):
        hs.ann_search(df, emb[:1], k=3, metric="ip")


def test_session_without_a_device_asks_for_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HyperspaceError, match="no CUDA device"):
        HyperspaceSession(system_path=str(tmp_path / "indexes"))
