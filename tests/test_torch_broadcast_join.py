"""The broadcast probe on the CPU, against the JAX package and the merge.

The cases of tests/test_broadcast_join.py on the port: a heavily
asymmetric single-partition join probes a dense table of the small
side's codes (`broadcast-hash`, kernel `device-broadcast-hash`) and
equals the merge path (`hyperspace.join.broadcast.maxRows` 0) and pandas
for every outer type; a small LEFT side swaps the roles; equal sizes keep
the merge; duplicate build keys, negative key values and all-null keys;
and a code space too sparse for a table falls back to the merge. Each
broadcast result also equals the JAX package's, rows and path.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch

MAX_ROWS = "hyperspace.join.broadcast.maxRows"


def _write(root, name, df):
    (root / name).mkdir()
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), root / name / "p.parquet")


def _sessions(root, buckets=2):
    out = {}
    for name, pkg, kw in (("torch", htorch, {"device": "cpu"}), ("jax", hjax, {})):
        s = pkg.HyperspaceSession(system_path=str(root / f"idx_{name}"), num_buckets=buckets, **kw)
        s.conf.set(MAX_ROWS, 1_000_000)
        out[name] = s
    return out


def _rows(df: pd.DataFrame) -> pd.DataFrame:
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def _both(sessions, root, plan_fn):
    """(port frame, port stats, JAX frame, JAX stats)."""
    out = []
    for name in ("torch", "jax"):
        s = sessions[name]
        out += [s.to_pandas(plan_fn(s)), dict(s.last_query_stats)]
    return out


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bcast")
    rng = np.random.default_rng(17)
    n_f, n_d = 20_000, 500
    fact = pd.DataFrame({"k": rng.integers(0, 700, n_f).astype(np.int64), "x": rng.normal(size=n_f)})
    dim = pd.DataFrame({"dk": np.arange(n_d, dtype=np.int64), "name": [f"d{int(i)}" for i in range(n_d)]})
    _write(tmp, "f", fact)
    _write(tmp, "d", dim)
    return tmp, _sessions(tmp, buckets=4), fact, dim


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
def test_broadcast_matches_merge_the_jax_package_and_pandas(tables, how):
    root, sessions, fact, dim = tables

    def plan(s):
        return s.parquet(root / "f").join(s.parquet(root / "d"), ["k"], ["dk"], how=how)

    got, st, want, want_st = _both(sessions, root, plan)
    assert st["join_path"] == want_st["join_path"] == "broadcast-hash"
    assert st["join_kernel"] == "device-broadcast-hash"
    pd.testing.assert_frame_equal(_rows(got), _rows(want))

    port = sessions["torch"]
    port.conf.set(MAX_ROWS, 0)
    try:
        merged = port.to_pandas(plan(port))
        assert port.last_query_stats["join_path"] == "single-partition"
        assert port.last_query_stats["join_kernel"] == "device-searchsorted"
    finally:
        port.conf.set(MAX_ROWS, 1_000_000)
    pd.testing.assert_frame_equal(_rows(got), _rows(merged))
    if how == "full":
        assert len(got) == len(fact) + int((~dim.dk.isin(fact.k)).sum())
    elif how == "right":
        assert len(got) == len(fact.merge(dim, left_on="k", right_on="dk", how="right"))
    else:
        assert len(got) == len(fact.merge(dim, left_on="k", right_on="dk", how=how))


def test_broadcast_swaps_when_left_is_small(tables):
    """A small LEFT side: the probe swaps roles, the pairs keep their
    orientation."""
    root, sessions, fact, dim = tables

    def plan(s):
        return s.parquet(root / "d").join(s.parquet(root / "f"), ["dk"], ["k"])

    got, st, want, _ = _both(sessions, root, plan)
    assert st["join_path"] == "broadcast-hash"
    exp = dim.merge(fact, left_on="dk", right_on="k")
    assert len(got) == len(exp)
    np.testing.assert_array_equal(np.sort(got["x"].to_numpy()), np.sort(exp["x"].to_numpy()))
    pd.testing.assert_frame_equal(_rows(got), _rows(want))


def test_symmetric_sizes_keep_merge_path(tables):
    root, sessions, fact, _ = tables

    def plan(s):
        f = s.parquet(root / "f")
        return f.select("k").join(f, ["k"], ["k"]).aggregate([], [("count", None, "n")])

    got, st, want, want_st = _both(sessions, root, plan)
    assert st["join_path"] == want_st["join_path"] == "single-partition"
    assert int(got.loc[0, "n"]) == int(want.loc[0, "n"]) == int((fact.k.value_counts() ** 2).sum())


def test_broadcast_with_duplicate_build_keys(tmp_path):
    """The build side repeats keys: the run expansion emits every pair."""
    rng = np.random.default_rng(23)
    big = pd.DataFrame({"k": rng.integers(0, 50, 8_000).astype(np.int64), "x": rng.normal(size=8_000)})
    small = pd.DataFrame({"dk": np.repeat(np.arange(50, dtype=np.int64), 3), "w": np.arange(150, dtype=np.int64)})
    _write(tmp_path, "big", big)
    _write(tmp_path, "small", small)
    sessions = _sessions(tmp_path)
    got, st, want, _ = _both(sessions, tmp_path, lambda s: s.parquet(tmp_path / "big").join(
        s.parquet(tmp_path / "small"), ["k"], ["dk"]))
    assert st["join_path"] == "broadcast-hash"
    exp = big.merge(small, left_on="k", right_on="dk")
    assert len(got) == len(exp)
    assert int(got.w.sum()) == int(exp.w.sum())
    pd.testing.assert_frame_equal(_rows(got), _rows(want))


def test_broadcast_negative_keys_match(tmp_path):
    """Raw negative key VALUES join: only null-coded rows are negative
    after the factorization shifts the codes non-negative."""
    big = pd.DataFrame({"k": np.tile(np.arange(-3, 2, dtype=np.int64), 8), "x": np.arange(40, dtype=np.int64)})
    small = pd.DataFrame({"dk": np.arange(-3, 2, dtype=np.int64), "w": np.arange(5, dtype=np.int64)})
    _write(tmp_path, "nbig", big)
    _write(tmp_path, "nsmall", small)
    sessions = _sessions(tmp_path)
    got, st, want, _ = _both(sessions, tmp_path, lambda s: s.parquet(tmp_path / "nbig").join(
        s.parquet(tmp_path / "nsmall"), ["k"], ["dk"]))
    assert st["join_path"] == "broadcast-hash"
    assert len(got) == 40
    pd.testing.assert_frame_equal(_rows(got), _rows(want))


@pytest.mark.parametrize("how", ["inner", "left"])
def test_broadcast_all_null_keys_no_crash(tmp_path, how):
    big = pd.DataFrame({"k": pd.array([None] * 40, dtype="Int64"), "x": np.arange(40, dtype=np.int64)})
    small = pd.DataFrame({"dk": pd.array([None] * 5, dtype="Int64"), "w": np.arange(5, dtype=np.int64)})
    _write(tmp_path, "zbig", big)
    _write(tmp_path, "zsmall", small)
    sessions = _sessions(tmp_path)
    got, st, want, want_st = _both(sessions, tmp_path, lambda s: s.parquet(tmp_path / "zbig").join(
        s.parquet(tmp_path / "zsmall"), ["k"], ["dk"], how=how))
    assert len(got) == len(want) == (0 if how == "inner" else 40)
    assert st["join_path"] == want_st["join_path"]


def test_sparse_code_space_falls_back_to_the_merge(tmp_path):
    """Keys a million apart: a dense table over the code span would dwarf
    the small side, so the probe declines and the merge runs, as in the
    JAX package."""
    rng = np.random.default_rng(5)
    big = pd.DataFrame({"k": rng.integers(0, 600, 6_000).astype(np.int64) * 1_000_000, "x": np.arange(6_000)})
    small = pd.DataFrame({"dk": np.arange(500, dtype=np.int64) * 1_000_000, "w": np.arange(500, dtype=np.int64)})
    _write(tmp_path, "sbig", big)
    _write(tmp_path, "ssmall", small)
    sessions = _sessions(tmp_path)
    got, st, want, want_st = _both(sessions, tmp_path, lambda s: s.parquet(tmp_path / "sbig").join(
        s.parquet(tmp_path / "ssmall"), ["k"], ["dk"]))
    assert st["join_path"] == want_st["join_path"] == "single-partition"
    assert st["join_kernel"] == "device-searchsorted"
    assert len(got) == len(big.merge(small, left_on="k", right_on="dk"))
    pd.testing.assert_frame_equal(_rows(got), _rows(want))


def test_conf_reads_the_join_keys_and_refuses_the_rest(tmp_path):
    """`session.conf` takes the join keys the port reads, with the JAX
    package's defaults; a key the JAX package declares but the port does
    not read raises as not ported; a misspelt key raises with a
    suggestion, as the JAX package's `check_known_key` does."""
    from hyperspace_tpu.config import KNOWN_KEYS

    from hyperspace_tpu_torch.config import PORTED_KEYS, UNPORTED_KEYS
    from hyperspace_tpu_torch.exceptions import UnknownConfigKeyError

    assert set(PORTED_KEYS) | UNPORTED_KEYS == set(KNOWN_KEYS)
    port = htorch.HyperspaceSession(system_path=str(tmp_path), device="cpu")
    ref = hjax.HyperspaceSession(system_path=str(tmp_path))
    for key in PORTED_KEYS:
        assert port.conf.get(key) == ref.conf.get(key)
    port.conf.set(MAX_ROWS, "12")
    port.conf.set("hyperspace.join.rebucketize", "off")
    assert (port.conf.join_broadcast_max_rows, port.conf.join_rebucketize) == (12, "off")
    with pytest.raises(htorch.HyperspaceError, match="not ported yet"):
        port.conf.set("hyperspace.join.venue", "host")
    with pytest.raises(UnknownConfigKeyError, match="did you mean 'hyperspace.join.rebucketize'"):
        port.conf.get("hyperspace.join.rebucketise")
    port.conf.set("app.scratch", 1)  # outside the namespace: an override
    assert port.conf.get("app.scratch") == 1
