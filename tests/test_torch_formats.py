"""Source formats and nulls through the port, against the JAX package.

tests/test_formats.py's cases (parquet, ORC, CSV and line-delimited JSON
sources: register, build a covering index, rewrite a lookup through it;
staleness of an appended file per format; the unsupported format; CSV
decode pinned to the registered schema) and tests/test_nulls.py's
(validity masks through parquet, Kleene 3-valued predicates, the 64-bit
comparison with nulls, index builds and rewritten queries with nullable
keys and payloads, null join keys, nullable booleans), each run through
both packages on the same seeded data. Rows are compared exactly
(floats bit for bit), the port's against the JAX package's and pandas'.
"""

import json

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu.dataset import Dataset as JDataset
from hyperspace_tpu.dataset import list_data_files as jlist
from hyperspace_tpu.exceptions import HyperspaceError as JHyperspaceError
from hyperspace_tpu.execution import io as jio
from hyperspace_tpu.execution.table import ColumnTable as JTable
from hyperspace_tpu.ops.filter import eval_predicate_mask as jmask
from hyperspace_tpu_torch.dataset import Dataset as TDataset
from hyperspace_tpu_torch.dataset import list_data_files as tlist
from hyperspace_tpu_torch.exceptions import HyperspaceError as THyperspaceError
from hyperspace_tpu_torch.execution import io as tio
from hyperspace_tpu_torch.execution.table import ColumnTable as TTable
from hyperspace_tpu_torch.ops.filter import eval_predicate_mask as tmask

PKGS = (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"}))


def _canon_rows(df: pd.DataFrame, cols) -> list:
    out = []
    for row in df[cols].itertuples(index=False):
        out.append(tuple(None if (v is None or v is pd.NA or (isinstance(v, float) and np.isnan(v)))
                         else (repr(float(v)) if isinstance(v, (float, np.floating)) else
                               int(v) if isinstance(v, (int, np.integer)) and not isinstance(v, bool) else str(v))
                         for v in row))
    return sorted(out, key=repr)


# -- formats -----------------------------------------------------------------


def _frame(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame(
        {
            "k": rng.integers(0, 500, n).astype(np.int64),
            "v": np.round(rng.normal(size=n), 6),
            "tag": rng.choice(["x", "y", "z"], n),
        }
    )


def _write(df, root, fmt):
    root.mkdir()
    t = pa.Table.from_pandas(df, preserve_index=False)
    if fmt == "parquet":
        pq.write_table(t, root / "p.parquet")
    elif fmt == "orc":
        from pyarrow import orc

        orc.write_table(t, root / "p.orc")
    elif fmt == "csv":
        df.to_csv(root / "p.csv", index=False)
    elif fmt == "json":
        (root / "p.json").write_text("\n".join(json.dumps(r) for r in df.to_dict(orient="records")))


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv", "json"])
def test_index_over_any_source_format(tmp_path, fmt):
    df = _frame()
    root = tmp_path / "src"
    _write(df, root, fmt)
    exp = _canon_rows(df[df.k == 123], ["k", "v", "tag"])
    got = {}
    for name, pkg, kw in PKGS:
        session = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=4, **kw)
        hs = pkg.Hyperspace(session)
        scan = getattr(session, fmt)(root)
        assert scan.format == fmt
        assert set(n.lower() for n in scan.schema.names) == {"k", "v", "tag"}
        hs.create_index(scan, pkg.IndexConfig("f_k", ["k"], ["v", "tag"]))
        q = scan.filter(pkg.col("k") == pkg.lit(123)).select("k", "v", "tag")
        session.disable_hyperspace()
        raw = _canon_rows(session.to_pandas(q), ["k", "v", "tag"])
        session.enable_hyperspace()
        idx = _canon_rows(session.to_pandas(q), ["k", "v", "tag"])
        assert raw == exp and idx == exp, name
        assert session.last_query_stats["files_pruned"] > 0
        got[name] = idx
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("fmt", ["orc", "csv"])
def test_signature_staleness_per_format(tmp_path, fmt):
    """Appending a file of the same format invalidates the index (the
    query falls back to the raw scan): the listing respects the suffix."""
    df = _frame()
    root = tmp_path / "src"
    _write(df, root, fmt)
    sessions = []
    for name, pkg, kw in PKGS:
        session = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=4, **kw)
        scan = getattr(session, fmt)(root)
        pkg.Hyperspace(session).create_index(scan, pkg.IndexConfig("s_k", ["k"], ["v", "tag"]))
        session.enable_hyperspace()
        sessions.append((name, pkg, session, scan))
    extra = _frame(100, seed=9)
    if fmt == "orc":
        from pyarrow import orc

        orc.write_table(pa.Table.from_pandas(extra, preserve_index=False), root / "q.orc")
    else:
        extra.to_csv(root / "q.csv", index=False)
    both = pd.concat([df, extra], ignore_index=True)
    got = {}
    for name, pkg, session, scan in sessions:
        q = scan.filter(pkg.col("k") == pkg.lit(7)).select("k", "v")
        got[name] = _canon_rows(session.to_pandas(q), ["k", "v"])
        assert len(got[name]) == int((both.k == 7).sum())
    assert got["torch"] == got["jax"]


def test_unsupported_format_raises(tmp_path):
    for Dataset, Error in ((JDataset, JHyperspaceError), (TDataset, THyperspaceError)):
        with pytest.raises(Error, match="unsupported source format"):
            Dataset.of_format(tmp_path, "avro")


def test_csv_source_builds_in_memory_where_the_budget_is_not_ported(tmp_path):
    """tests/test_formats.py's over-budget CSV build streams out of core
    in both packages (the port reads the memory-budget key now, so the
    name's "in memory" is history): the port's
    build takes the streaming path by record batches and serves the JAX
    package's rows."""
    df = _frame(2000)
    root = tmp_path / "src"
    _write(df, root, "csv")
    some_k = int(df.k.iloc[0])
    got = {}
    for name, pkg, kw in PKGS:
        session = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=2, **kw)
        session.conf.set("hyperspace.index.build.memoryBudgetBytes", 1024)
        scan = session.csv(root)
        pkg.Hyperspace(session).create_index(scan, pkg.IndexConfig("c_k", ["k"], ["v", "tag"]))
        assert session.last_build_stats["path"] == "streaming"
        session.enable_hyperspace()
        got[name] = _canon_rows(session.to_pandas(scan.filter(pkg.col("k") == some_k)), ["k", "v", "tag"])
        assert len(got[name]) == int((df.k == some_k).sum())
    assert got["torch"] == got["jax"]


def test_csv_decode_pinned_to_registered_schema(tmp_path):
    root = tmp_path / "src"
    root.mkdir()
    pd.DataFrame({"k": [1, 2, 3], "code": ["00x", "00y", "00z"]}).to_csv(root / "a.csv", index=False)
    root2 = tmp_path / "src2"
    root2.mkdir()
    pd.DataFrame({"k": [1], "code": ["001"]}).to_csv(root2 / "a.csv", index=False)
    sessions = []
    for name, pkg, kw in PKGS:
        session = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=2, **kw)
        sessions.append((session, session.csv(root), session.csv(root2)))  # registered before b.csv lands
    pd.DataFrame({"k": [4, 5], "code": ["001", "002"]}).to_csv(root / "b.csv", index=False)
    pd.DataFrame({"k": [2], "code": ["0zz"]}).to_csv(root2 / "b.csv", index=False)
    got = []
    for session, scan, scan2 in sessions:
        out = session.to_pandas(scan)
        assert len(out) == 5 and {"00x", "001"} <= set(out["code"].astype(str))
        got.append(_canon_rows(out, ["k", "code"]))
        with pytest.raises(Exception, match="conversion error"):
            session.run(scan2)
    assert got[0] == got[1]


# -- nulls -------------------------------------------------------------------


def _nullable_parquet(tmp_path, n=800, seed=11):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 60, n).astype(np.int64)
    val = rng.standard_normal(n)
    name = np.array([f"n{i % 23}" for i in range(n)], dtype=object)
    knull, vnull, snull = (rng.random(n) < 0.15 for _ in range(3))
    table = pa.table(
        {
            "key": pa.array([None if m else int(k) for k, m in zip(key, knull)], type=pa.int64()),
            "value": pa.array([None if m else float(v) for v, m in zip(val, vnull)], type=pa.float64()),
            "name": pa.array([None if m else s for s, m in zip(name, snull)], type=pa.string()),
        }
    )
    root = tmp_path / "nullable"
    root.mkdir()
    pq.write_table(table.slice(0, n // 2), root / "a.parquet")
    pq.write_table(table.slice(n // 2), root / "b.parquet")
    return str(root), table.to_pandas()


def test_arrow_round_trip_preserves_nulls(tmp_path):
    root, pdf = _nullable_parquet(tmp_path)
    files = [fi.path for fi in tlist(root)]
    assert files == [fi.path for fi in jlist(root)]
    t = tio.read_parquet(files, device="cpu")
    j = jio.read_parquet(files)
    assert set(t.validity) == set(j.validity) == {"key", "value", "name"}
    for c in ("key", "value", "name"):
        assert np.array_equal(t.validity[c].numpy(), np.asarray(j.validity[c]))
    back = t.to_arrow().to_pandas()
    cols = ["key", "value", "name"]
    assert _canon_rows(back, cols) == _canon_rows(pdf, cols) == _canon_rows(j.to_arrow().to_pandas(), cols)


def _masked_tables(n=400, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.integers(-50, 50, n).astype(np.int64)
    b = rng.standard_normal(n)
    va = rng.random(n) > 0.2
    vb = rng.random(n) > 0.2
    js = hjax.Schema.of(hjax.Field("a", "int64", nullable=True), hjax.Field("b", "float64", nullable=True))
    ts = htorch.Schema.of(htorch.Field("a", "int64", nullable=True), htorch.Field("b", "float64", nullable=True))
    jt = JTable(js, {"a": a, "b": b}, {}, {"a": va, "b": vb})
    tt = TTable(ts, {"a": torch.from_numpy(a.copy()), "b": torch.from_numpy(b.copy())}, {},
                {"a": torch.from_numpy(va.copy()), "b": torch.from_numpy(vb.copy())}, torch.device("cpu"))
    return jt, tt, a, b, va, vb


def _both_masks(jt, tt, build):
    got_j = np.asarray(jmask(jt, build(hjax)))
    got_t = tmask(tt, build(htorch)).numpy()
    np.testing.assert_array_equal(got_t, got_j)
    return got_t


def test_filter_comparison_null_is_not_true():
    jt, tt, a, b, va, vb = _masked_tables()
    got = _both_masks(jt, tt, lambda p: p.col("a") > p.lit(0))
    np.testing.assert_array_equal(got, (a > 0) & va)
    got = _both_masks(jt, tt, lambda p: p.col("a") != p.lit(3))
    np.testing.assert_array_equal(got, (a != 3) & va)


def test_filter_kleene_and_or_not():
    jt, tt, a, b, va, vb = _masked_tables()
    got = _both_masks(jt, tt, lambda p: (p.col("a") > p.lit(0)) | (p.col("b") > p.lit(0)))
    np.testing.assert_array_equal(got, ((a > 0) & va) | ((b > 0) & vb))
    got = _both_masks(jt, tt, lambda p: (p.col("a") > p.lit(0)) & (p.col("b") > p.lit(0)))
    np.testing.assert_array_equal(got, (a > 0) & va & (b > 0) & vb)
    got = _both_masks(jt, tt, lambda p: ~(p.col("a") > p.lit(0)))
    np.testing.assert_array_equal(got, ~(a > 0) & va)


def test_filter_arithmetic_kleene():
    jt, tt, a, b, va, vb = _masked_tables()
    got = _both_masks(jt, tt, lambda p: (p.col("a") + p.lit(1)) > p.lit(0))
    np.testing.assert_array_equal(got, ((a + 1) > 0) & va)


def test_filter_64bit_comparison_with_nulls():
    rng = np.random.default_rng(9)
    n = 300
    a = rng.integers(-(2**60), 2**60, n).astype(np.int64)
    va = rng.random(n) > 0.3
    jt = JTable(hjax.Schema.of(hjax.Field("a", "int64", nullable=True)), {"a": a}, {}, {"a": va})
    tt = TTable(htorch.Schema.of(htorch.Field("a", "int64", nullable=True)), {"a": torch.from_numpy(a.copy())}, {},
                {"a": torch.from_numpy(va.copy())}, torch.device("cpu"))
    got = _both_masks(jt, tt, lambda p: p.col("a") >= p.lit(2**40))
    np.testing.assert_array_equal(got, (a >= 2**40) & va)


def _sessions(tmp_path):
    out = []
    for name, pkg, kw in PKGS:
        session = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=8, **kw)
        out.append((name, pkg, session, pkg.Hyperspace(session)))
    return out


def test_create_index_and_filter_equality_with_nulls(tmp_path):
    root, _ = _nullable_parquet(tmp_path)
    got = {}
    for name, pkg, session, hs in _sessions(tmp_path):
        col = pkg.col
        df = session.parquet(root)
        hs.create_index(df, pkg.IndexConfig("nullidx", ["key"], ["value", "name"]))
        queries = [
            (df.filter(col("key") == 17).select("key", "value"), ["key", "value"]),
            (df.filter((col("key") > 30) & (col("value") < 0.5)).select("key", "value", "name"),
             ["key", "value", "name"]),
            (df.filter((col("name") == "n7") | (col("key") <= 5)).select("name", "key"), ["name", "key"]),
        ]
        for i, (q, cols) in enumerate(queries):
            session.enable_hyperspace()
            assert any(s.bucket_spec is not None for s in session.optimized_plan(q).leaves()), "rewrite missed"
            idx = _canon_rows(session.to_pandas(q), cols)
            session.disable_hyperspace()
            assert idx == _canon_rows(session.to_pandas(q), cols)
            got[name, i] = idx
    for i in range(3):
        assert got["torch", i] == got["jax", i]


def test_string_index_key_with_nulls(tmp_path):
    root, _ = _nullable_parquet(tmp_path)
    got = {}
    for name, pkg, session, hs in _sessions(tmp_path):
        df = session.parquet(root)
        hs.create_index(df, pkg.IndexConfig("sidx", ["name"], ["key"]))
        q = df.filter(pkg.col("name") == "n3").select("name", "key")
        session.enable_hyperspace()
        assert any(s.bucket_spec is not None for s in session.optimized_plan(q).leaves())
        got[name] = _canon_rows(session.to_pandas(q), ["name", "key"])
        session.disable_hyperspace()
        assert got[name] == _canon_rows(session.to_pandas(q), ["name", "key"])
    assert got["torch"] == got["jax"]


def test_join_null_keys_never_match(tmp_path):
    rng = np.random.default_rng(21)
    n, m = 600, 200
    lkey = [None if rng.random() < 0.2 else int(k) for k in rng.integers(0, 40, n)]
    left = pa.table({"k": pa.array(lkey, type=pa.int64()), "lv": pa.array(rng.standard_normal(n))})
    rkey = [None if rng.random() < 0.2 else int(k) for k in rng.integers(0, 40, m)]
    right = pa.table({"k": pa.array(rkey, type=pa.int64()), "rp": pa.array([f"p{i}" for i in range(m)])})
    (tmp_path / "jl").mkdir()
    (tmp_path / "jr").mkdir()
    pq.write_table(left, tmp_path / "jl" / "l.parquet")
    pq.write_table(right, tmp_path / "jr" / "r.parquet")
    want = left.to_pandas().dropna(subset=["k"]).merge(right.to_pandas().dropna(subset=["k"]), on="k")
    want["k"] = want["k"].astype(np.int64)
    cols = ["k", "lv", "rp"]
    got = {}
    for name, pkg, session, hs in _sessions(tmp_path):
        ldf, rdf = session.parquet(tmp_path / "jl"), session.parquet(tmp_path / "jr")
        hs.create_index(ldf, pkg.IndexConfig("jln", ["k"], ["lv"]))
        hs.create_index(rdf, pkg.IndexConfig("jrn", ["k"], ["rp"]))
        q = ldf.select("k", "lv").join(rdf.select("k", "rp"), ["k"])
        session.enable_hyperspace()
        assert all(s.bucket_spec is not None for s in session.optimized_plan(q).leaves()), "join rewrite missed"
        got[name] = _canon_rows(session.to_pandas(q), cols)
        session.disable_hyperspace()
        assert got[name] == _canon_rows(session.to_pandas(q), cols)
        assert got[name] == _canon_rows(want, cols)
    assert got["torch"] == got["jax"]


def test_join_payload_nulls_survive(tmp_path):
    left = pa.table({"k": pa.array([1, 2, 3], type=pa.int64()), "lv": pa.array([None, 1.5, None], type=pa.float64())})
    right = pa.table({"k": pa.array([1, 2, 3], type=pa.int64()), "rp": pa.array(["x", None, "z"])})
    (tmp_path / "pl").mkdir()
    (tmp_path / "pr").mkdir()
    pq.write_table(left, tmp_path / "pl" / "l.parquet")
    pq.write_table(right, tmp_path / "pr" / "r.parquet")
    got = {}
    for name, pkg, session, hs in _sessions(tmp_path):
        out = session.to_pandas(session.parquet(tmp_path / "pl").join(session.parquet(tmp_path / "pr"), ["k"]))
        out = out.sort_values("k").reset_index(drop=True)
        assert out["lv"].isna().tolist() == [True, False, True]
        assert out["rp"].isna().tolist() == [False, True, False]
        got[name] = _canon_rows(out, ["k", "lv", "rp"])
    assert got["torch"] == got["jax"]


def test_nullable_bool_column_round_trip():
    t = pa.table({"b": pa.array([True, None, False]), "k": pa.array([1, 2, 3], type=pa.int64())})
    ct = TTable.from_arrow(t, device="cpu")
    assert ct.validity["b"].tolist() == [True, False, True]
    assert ct.validity["b"].tolist() == np.asarray(JTable.from_arrow(t).validity["b"]).tolist()
    back = ct.to_arrow().to_pandas()
    assert back["b"].tolist()[0] is True and pd.isna(back["b"].tolist()[1])
