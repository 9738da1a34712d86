"""The port's index build against the JAX package's, and cross-package reads.

Same dataset as the JAX package's build-venue identity test: 20k rows,
keys [k (int64), s (string with nulls)], included [v (float32), d
(float64)], 8 buckets. The port must write the same bucket files and
manifest, and each package must serve the other's index.
"""

import json

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch

NUM_BUCKETS = 8


@pytest.fixture
def source(tmp_path):
    rng = np.random.default_rng(0)
    n = 20_000
    df = pd.DataFrame(
        {
            "k": rng.integers(0, 5_000, n).astype(np.int64),
            "s": rng.choice(["aa", "bb", None, "cc"], n),
            "v": rng.normal(size=n).astype(np.float32),
            "d": rng.normal(size=n),
        }
    )
    (tmp_path / "src").mkdir()
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), tmp_path / "src" / "p.parquet")
    return tmp_path, df


def _build(pkg, system_path, src, **session_kw):
    session = pkg.HyperspaceSession(system_path=str(system_path), num_buckets=NUM_BUCKETS, **session_kw)
    hs = pkg.Hyperspace(session)
    scan = session.parquet(src)
    hs.create_index(scan, pkg.IndexConfig("ix", ["k", "s"], ["v", "d"]))
    return session, scan


def _sorted(df: pd.DataFrame) -> pd.DataFrame:
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def test_bucket_files_and_manifest_match_the_jax_build(source):
    tmp, _ = source
    _build(hjax, tmp / "idx_jax", tmp / "src")
    _build(htorch, tmp / "idx_torch", tmp / "src", device="cpu")
    d_jax = tmp / "idx_jax" / "ix" / "v__=0"
    d_torch = tmp / "idx_torch" / "ix" / "v__=0"
    for b in range(NUM_BUCKETS):
        f = f"bucket-{b:05d}.parquet"
        pd.testing.assert_frame_equal(
            pq.read_table(d_torch / f).to_pandas(), pq.read_table(d_jax / f).to_pandas()
        )
    m_jax = json.loads((d_jax / "_index_manifest.json").read_text())
    m_torch = json.loads((d_torch / "_index_manifest.json").read_text())
    assert m_torch == m_jax


def test_op_log_entries_match_the_jax_build(source):
    tmp, _ = source
    _build(hjax, tmp / "idx_jax", tmp / "src")
    _build(htorch, tmp / "idx_torch", tmp / "src", device="cpu")

    def entry(root, name):
        d = json.loads((root / "ix" / "_hyperspace_log" / name).read_text())
        d.pop("timestamp")
        d["content"]["root"] = d["content"]["root"].rsplit("/", 1)[-1]
        return d

    for name in ("0", "1", "latestStable"):
        assert entry(tmp / "idx_torch", name) == entry(tmp / "idx_jax", name)


def _queries(pkg):
    # Every projection keeps both bucket columns: the JAX package's plan
    # validator rejects an index scan narrowed below its bucket columns.
    col = pkg.col
    return [
        lambda s: s.filter(col("k") == 1234).select("k", "s", "v", "d"),
        lambda s: s.filter((col("k") == 77) & (col("s") == "bb")).select("k", "s", "d"),
        lambda s: s.filter(col("k").isin([5, 17, 4096])).select("k", "s", "v"),
        lambda s: s.filter((col("k") < 40) & col("s").is_null()).select("k", "s", "d"),
    ]


@pytest.mark.parametrize("builder", ["jax", "torch"])
def test_each_package_serves_the_others_index(source, builder):
    tmp, _ = source
    idx = tmp / "idx"
    if builder == "jax":
        _build(hjax, idx, tmp / "src")
    else:
        _build(htorch, idx, tmp / "src", device="cpu")
    s_jax = hjax.HyperspaceSession(system_path=str(idx), num_buckets=NUM_BUCKETS).enable_hyperspace()
    s_torch = htorch.HyperspaceSession(
        system_path=str(idx), num_buckets=NUM_BUCKETS, device="cpu"
    ).enable_hyperspace()
    scan_jax, scan_torch = s_jax.parquet(tmp / "src"), s_torch.parquet(tmp / "src")
    pruned = 0
    for q_jax, q_torch in zip(_queries(hjax), _queries(htorch)):
        got = s_torch.to_pandas(q_torch(scan_torch))
        want = s_jax.to_pandas(q_jax(scan_jax))
        assert len(got) > 0
        pd.testing.assert_frame_equal(_sorted(got), _sorted(want))
        assert s_torch.last_optimized_plan.leaves()[0].bucket_spec is not None
        pruned += s_torch.last_query_stats["files_pruned"]
    assert pruned > 0
