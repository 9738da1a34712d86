"""Every join type of the port on the CPU, against the JAX package and SQL.

Two datasets go through both packages with the same seeded inputs:

(a) a fact/dim pair with an int32 key `k` (every dim key present, some
    fact keys absent from dim), a nullable int64 key per side (`fnk`,
    `dnk`: nulls on both sides, keys on one side only, duplicates on
    both), nullable dictionary-coded strings drawn from overlapping
    parts of one vocabulary (`s`, `t`; their dictionaries differ) and a
    nullable int (`n`); covering indexes on both keys of both sides, 8
    buckets;
(b) TPC-H lineitem and orders from the port's generators at sf = 0.001,
    each with its covering index on the order key.

Each join type (inner, left, right, full, semi, anti) runs with and
without an ON residual, index on and off: rows must equal the JAX
package's exactly (every value here is a copy, an integer or a count),
and so must `join_path`. Then the JAX package's own semantics cases
(tests/test_join_types.py: SQL semantics against pandas, side filters,
the right-unmatched key, set operations) run on the port alone.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch.datagen import gen_tpch_lineitem, gen_tpch_orders

BUCKETS = 8
HOWS = ["inner", "left", "right", "full", "semi", "anti"]
PACKAGES = (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"}))
WORDS = np.array(["ash", "birch", "cedar", "elm", "fir", "oak", "pine"], dtype=object)


def _session(pkg, kw, path, buckets=BUCKETS):
    return pkg.HyperspaceSession(system_path=str(path), num_buckets=buckets, **kw)


def _write(root, name, table):
    (root / name).mkdir()
    pq.write_table(table, root / name / "p.parquet")


@pytest.fixture(scope="module")
def factdim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jt_factdim")
    rng = np.random.default_rng(11)
    n, m = 2_000, 180
    _write(tmp, "fact", pa.table({
        "k": rng.integers(0, 220, n).astype(np.int32),
        "q": rng.integers(0, 60, n).astype(np.int64),
        "n": pa.array([None if i % 7 == 0 else int(i % 97) for i in range(n)], type=pa.int64()),
        "s": pa.array([None if i % 11 == 0 else WORDS[(3 * i + i // 7) % 6] for i in range(n)]),
        "fnk": pa.array([None if i % 5 == 0 else int(i % 150) for i in range(n)], type=pa.int64()),
    }))
    _write(tmp, "dim", pa.table({
        "k": np.arange(m, dtype=np.int32),
        "w": rng.integers(0, 60, m).astype(np.int64),
        "t": pa.array([None if i % 13 == 0 else WORDS[2 + i % 5] for i in range(m)]),
        "dnk": pa.array([None if i % 6 == 0 else int(i % 170) for i in range(m)], type=pa.int64()),
    }))
    out = {}
    for name, pkg, kw in PACKAGES:
        session = _session(pkg, kw, tmp / f"idx_{name}")
        fs, ds = session.parquet(tmp / "fact"), session.parquet(tmp / "dim")
        hs = pkg.Hyperspace(session)
        hs.create_index(fs, pkg.IndexConfig("f_k", ["k"], ["q", "n", "s", "fnk"]))
        hs.create_index(ds, pkg.IndexConfig("d_k", ["k"], ["w", "t", "dnk"]))
        hs.create_index(fs, pkg.IndexConfig("f_nk", ["fnk"], ["k", "q", "s"]))
        hs.create_index(ds, pkg.IndexConfig("d_nk", ["dnk"], ["k", "w", "t"]))
        out[name] = (pkg, session, fs, ds)
    return out


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jt_tpch")
    gen_tpch_lineitem(tmp / "lineitem", sf=0.001, seed=42)
    gen_tpch_orders(tmp / "orders", sf=0.001, seed=43)
    out = {}
    for name, pkg, kw in PACKAGES:
        session = _session(pkg, kw, tmp / f"idx_{name}")
        li, orders = session.parquet(tmp / "lineitem"), session.parquet(tmp / "orders")
        hs = pkg.Hyperspace(session)
        hs.create_index(li, pkg.IndexConfig("li_ok", ["l_orderkey"], ["l_extendedprice", "l_discount"]))
        hs.create_index(orders, pkg.IndexConfig("o_ok", ["o_orderkey"], ["o_totalprice", "o_orderpriority"]))
        out[name] = (pkg, session, li, orders)
    return out


def _rows(df: pd.DataFrame) -> list[str]:
    """Order-independent, null-normalized row multiset, exact values."""
    def norm(v):
        if v is None or v is pd.NA or (isinstance(v, float) and np.isnan(v)):
            return None
        return v.item() if isinstance(v, np.generic) else v

    return sorted(repr(tuple(norm(v) for v in t)) for t in df.itertuples(index=False, name=None))


def _run_both(data, plan_fn, indexed):
    """(port rows, port stats, JAX rows, JAX stats) of one plan."""
    res = {}
    for name in ("torch", "jax"):
        pkg, session, a, b = data[name]
        session.enable_hyperspace() if indexed else session.disable_hyperspace()
        df = session.to_pandas(plan_fn(pkg, a, b))
        res[name] = (df, dict(session.last_query_stats))
    return res["torch"] + res["jax"]


def _assert_same(data, plan_fn, indexed):
    got, stats, want, want_stats = _run_both(data, plan_fn, indexed)
    assert list(got.columns) == list(want.columns)
    assert _rows(got) == _rows(want)
    assert stats["join_path"] == want_stats["join_path"], (stats["join_path"], want_stats["join_path"])
    return got, stats


# -- every join type against the JAX package ---------------------------------------


@pytest.mark.parametrize("residual", [False, True], ids=["equi", "residual"])
@pytest.mark.parametrize("how", HOWS)
def test_fact_dim_join_types_match_the_jax_package(factdim, how, residual):
    """On the non-null key `k` and the nullable keys `fnk` = `dnk`, index
    on (zero-exchange aligned) and off (the broadcast probe: dim is far
    under a quarter of fact)."""
    for keys in (("k", "k"), ("fnk", "dnk")):
        def plan(pkg, fs, ds, keys=keys):
            cond = (pkg.col("q") > pkg.col("w")) if residual else None
            lcols = ["k", "q", "s"] + (["fnk"] if keys[0] == "fnk" else [])
            rcols = ([keys[1]] if keys[1] != "k" else []) + ["k", "w", "t"]
            right = ds.select(*dict.fromkeys(rcols))
            if keys[0] == "fnk":  # k would collide: keep dim's key only
                right = ds.select("dnk", "w", "t")
            return fs.select(*lcols).join(right, [keys[0]], [keys[1]], how=how, condition=cond)

        for indexed in (True, False):
            got, stats = _assert_same(factdim, plan, indexed)
            if indexed:
                assert stats["join_path"] == "zero-exchange-aligned"
            else:
                assert stats["join_path"] in ("broadcast-hash", "single-partition")
            if how in ("semi", "anti") and not residual:
                assert stats["join_kernel"] == "device-membership-probe"


@pytest.mark.parametrize("residual", [False, True], ids=["equi", "residual"])
@pytest.mark.parametrize("how", HOWS)
def test_tpch_join_types_match_the_jax_package(tpch, how, residual):
    """lineitem ⋈ orders on the order key with a side filter on each, with
    and without Q21's residual `l_extendedprice > o_totalprice * 0.1`,
    index on and off; semi and anti also under Q4's count by priority."""
    def plan(pkg, li, orders):
        cond = (pkg.col("l_extendedprice") > pkg.col("o_totalprice") * pkg.lit(0.1)) if residual else None
        left = li.filter(pkg.col("l_discount") >= pkg.lit(0.05)).select("l_orderkey", "l_extendedprice")
        right = orders.filter(pkg.col("o_orderpriority") != pkg.lit("5-LOW")).select(
            "o_orderkey", "o_totalprice", "o_orderpriority")
        if how in ("semi", "anti"):
            left, right = right, left  # Q4 / Q21: orders EXISTS lineitem
            return left.join(right, ["o_orderkey"], ["l_orderkey"], how=how, condition=cond)
        return left.join(right, ["l_orderkey"], ["o_orderkey"], how=how, condition=cond)

    def counted(pkg, li, orders):
        j = plan(pkg, li, orders)
        group = "o_orderpriority"
        return j.aggregate([group], [("count", None, "cnt")])

    for indexed in (True, False):
        _, stats = _assert_same(tpch, plan, indexed)
        assert stats["join_path"] == ("zero-exchange-aligned" if indexed else "single-partition")
        if how in ("semi", "anti"):
            _assert_same(tpch, counted, indexed)


def test_string_column_residual_compares_values_not_codes(factdim):
    """An ON residual comparing two dictionary-coded string columns of
    different sides (`s` and `t` hold different dictionaries) compares the
    strings, in every join type."""
    for how in HOWS:
        def plan(pkg, fs, ds, how=how):
            return fs.select("k", "s", "q").join(
                ds.select("k", "t"), ["k"], how=how, condition=pkg.col("s") < pkg.col("t"))

        for indexed in (True, False):
            got, _ = _assert_same(factdim, plan, indexed)
        if how == "inner":
            assert len(got) > 0 and (got["s"] < got["t"]).all()


@pytest.mark.parametrize("op", ["intersect", "except_"])
def test_set_operations_match_the_jax_package_with_null_rows(factdim, op):
    """INTERSECT / EXCEPT over NULL-bearing rows (nullable ints and
    strings on both sides): a NULL row matches its NULL twin."""
    def plan(pkg, fs, ds):
        return getattr(fs.select("fnk", "s"), op)(ds.select("dnk", "t"))

    for indexed in (True, False):
        got, stats = _assert_same(factdim, plan, indexed)
        assert stats["join_kernel"] == "device-membership-probe"
    fact = factdim["torch"][1].to_pandas(factdim["torch"][2].select("fnk", "s"))
    dim = factdim["torch"][1].to_pandas(factdim["torch"][3].select("dnk", "t"))
    right = set(_rows(dim))
    want = sorted({r for r in _rows(fact) if (r in right) == (op == "intersect")})
    assert _rows(got) == want
    assert any("None" in r for r in want)
    if op == "intersect":
        assert "(None, None)" in want


# -- the JAX package's semantics cases, on the port --------------------------------


def _frames():
    rng = np.random.default_rng(7)
    n_l, n_r = 3_000, 800
    lk = rng.integers(0, 400, n_l).astype(np.float64)
    lk[rng.random(n_l) < 0.05] = np.nan  # null keys
    rk = rng.integers(300, 600, n_r).astype(np.float64)  # partial overlap
    rk[rng.random(n_r) < 0.05] = np.nan
    left = pd.DataFrame({
        "k": pd.array(np.where(np.isnan(lk), None, lk), dtype="Int64"),
        "lv": rng.integers(0, 100, n_l).astype(np.int64),
        "ls": [f"L{int(i) % 11}" for i in rng.integers(0, 11, n_l)],
    })
    right = pd.DataFrame({
        "k2": pd.array(np.where(np.isnan(rk), None, rk), dtype="Int64"),
        "rv": rng.normal(size=n_r),
        "rs": [f"R{int(i) % 5}" for i in rng.integers(0, 5, n_r)],
    })
    return left, right


def sql_join(left: pd.DataFrame, right: pd.DataFrame, how: str) -> pd.DataFrame:
    """SQL-semantics expected output: NULL keys never match, outer variants
    null-extend, the key column coalesces (right-unmatched rows carry the
    right key)."""
    ld, rd = left[left.k.notna()], right[right.k2.notna()]
    if how == "semi":
        return left[left.k.isin(set(rd.k2))]
    if how == "anti":
        return left[~left.k.isin(set(rd.k2))]
    parts = [ld.merge(rd, left_on="k", right_on="k2", how="inner").drop(columns=["k2"])]
    if how in ("left", "full"):
        un = left[~left.k.isin(set(rd.k2))].copy()
        un["rv"], un["rs"] = np.nan, None
        parts.append(un)
    if how in ("right", "full"):
        un = right[~right.k2.isin(set(ld.k))].copy().rename(columns={"k2": "k"})
        un["lv"], un["ls"] = None, None
        parts.append(un)
    return pd.concat(parts, ignore_index=True)[["k", "lv", "ls", "rv", "rs"]]


def norm_rows(df: pd.DataFrame, cols: list[str]) -> list[str]:
    rows = []
    for t in df[cols].itertuples(index=False, name=None):
        row = []
        for v in t:
            if v is None or v is pd.NA or (isinstance(v, float) and np.isnan(v)):
                row.append(None)
            elif isinstance(v, (int, np.integer, float, np.floating)):
                row.append(round(float(v), 9))
            else:
                row.append(str(v))
        rows.append(repr(tuple(row)))
    return sorted(rows)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jt_frames")
    left, right = _frames()
    _write(tmp, "l", pa.Table.from_pandas(left, preserve_index=False))
    _write(tmp, "r", pa.Table.from_pandas(right, preserve_index=False))
    session = _session(htorch, {"device": "cpu"}, tmp / "idx", buckets=4)
    hs = htorch.Hyperspace(session)
    ls, rs = session.parquet(tmp / "l"), session.parquet(tmp / "r")
    hs.create_index(ls, htorch.IndexConfig("jt_l", ["k"], ["lv", "ls"]))
    hs.create_index(rs, htorch.IndexConfig("jt_r", ["k2"], ["rv", "rs"]))
    return session, ls, rs, left, right


@pytest.mark.parametrize("indexed", [False, True], ids=["no-index", "index"])
@pytest.mark.parametrize("how", HOWS)
def test_join_types_match_sql_semantics(frames, how, indexed):
    session, ls, rs, left, right = frames
    session.enable_hyperspace() if indexed else session.disable_hyperspace()
    got = session.to_pandas(ls.join(rs, ["k"], ["k2"], how=how))
    out_cols = ["k", "lv", "ls"] if how in ("semi", "anti") else ["k", "lv", "ls", "rv", "rs"]
    assert list(got.columns) == out_cols
    assert norm_rows(got, out_cols) == norm_rows(sql_join(left, right, how), out_cols)
    if indexed:
        assert session.last_query_stats["join_path"] == "zero-exchange-aligned"
        assert session.last_query_stats["num_buckets"] == 4


@pytest.mark.parametrize("how", ["left", "semi", "anti", "full"])
def test_join_types_with_side_filter_and_pushdown(frames, how):
    """A filter above the join on LEFT columns: pushed below for left /
    semi / anti, kept above for full — the same rows either way."""
    session, ls, rs, left, right = frames
    session.enable_hyperspace()
    got = session.to_pandas(ls.join(rs, ["k"], ["k2"], how=how).filter(htorch.col("lv") < 50))
    exp = sql_join(left, right, how)
    exp = exp[exp.lv.notna() & (exp.lv < 50)]
    out_cols = ["k", "lv", "ls"] if how in ("semi", "anti") else ["k", "lv", "ls", "rv", "rs"]
    assert norm_rows(got, out_cols) == norm_rows(exp, out_cols)


def test_right_unmatched_coalesces_key_from_right(frames):
    session, ls, rs, left, right = frames
    session.disable_hyperspace()
    got = session.to_pandas(ls.join(rs, ["k"], ["k2"], how="full"))
    rd_only = set(right[right.k2.notna()].k2) - set(left[left.k.notna()].k)
    assert rd_only and rd_only <= set(got[got.lv.isna()].k.dropna())


def test_unknown_join_type_rejected_and_semi_schema_is_left_only(frames):
    from hyperspace_tpu_torch.plan.nodes import Join

    _, ls, rs, _, _ = frames
    with pytest.raises(ValueError, match="unknown join type"):
        Join(ls, rs, ["k"], ["k2"], "cross")
    assert ls.join(rs, ["k"], ["k2"], how="semi").schema.names == ["k", "lv", "ls"]
    assert ls.join(rs, ["k"], ["k2"], how="full").schema.names == ["k", "lv", "ls", "rv", "rs"]
    with pytest.raises(ValueError, match="match schema"):
        ls.join(rs, ["k"], ["k2"], condition=htorch.col("nope") < htorch.col("rv"))


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi", "anti"])
def test_on_residual_alters_matching(tmp_path, how):
    """An ON residual: a pair failing it is NOT a match — outer rows
    null-extend, semi / anti flip existence. Oracle: pandas inner merge +
    residual, then recompose; index on and off."""
    rng = np.random.default_rng(91)
    left = pd.DataFrame({"k": rng.integers(0, 250, 3_000).astype(np.int64),
                         "lo": rng.integers(0, 50, 3_000).astype(np.int64)})
    right = pd.DataFrame({"k2": rng.integers(100, 350, 900).astype(np.int64),
                          "hi": rng.integers(10, 60, 900).astype(np.int64)})
    _write(tmp_path, "l", pa.Table.from_pandas(left, preserve_index=False))
    _write(tmp_path, "r", pa.Table.from_pandas(right, preserve_index=False))
    session = _session(htorch, {"device": "cpu"}, tmp_path / "idx", buckets=4)
    hs = htorch.Hyperspace(session)
    lt, rt = session.parquet(tmp_path / "l"), session.parquet(tmp_path / "r")
    hs.create_index(lt, htorch.IndexConfig("or_l", ["k"], ["lo"]))
    hs.create_index(rt, htorch.IndexConfig("or_r", ["k2"], ["hi"]))
    q = lt.join(rt, ["k"], ["k2"], how=how, condition=htorch.col("lo") < htorch.col("hi"))
    surv = left.reset_index().merge(right.reset_index(), left_on="k", right_on="k2",
                                    suffixes=("_l", "_r")).query("lo < hi")
    if how in ("semi", "anti"):
        keep = left.index.isin(set(surv.index_l))
        cols, exp = ["k", "lo"], left[keep if how == "semi" else ~keep]
    else:
        parts = [surv[["k", "lo", "hi"]]]
        if how in ("left", "full"):
            lum = left[~left.index.isin(set(surv.index_l))].copy()
            lum["hi"] = np.nan
            parts.append(lum[["k", "lo", "hi"]])
        if how in ("right", "full"):
            rum = right[~right.index.isin(set(surv.index_r))].copy()
            rum["k"], rum["lo"] = rum["k2"], np.nan
            parts.append(rum[["k", "lo", "hi"]])
        cols, exp = ["k", "lo", "hi"], pd.concat(parts, ignore_index=True)
    for enabled in (False, True):
        session.enable_hyperspace() if enabled else session.disable_hyperspace()
        assert norm_rows(session.to_pandas(q), cols) == norm_rows(exp, cols), (how, enabled)


def test_intersect_except_set_semantics(tmp_path):
    a = pd.DataFrame({"x": [1, 1, 2, 3, 5], "y": ["a", "a", "b", "c", "e"]})
    b = pd.DataFrame({"u": [1, 3, 3, 4], "v": ["a", "c", "c", "d"]})
    _write(tmp_path, "a", pa.Table.from_pandas(a, preserve_index=False))
    _write(tmp_path, "b", pa.Table.from_pandas(b, preserve_index=False))
    session = _session(htorch, {"device": "cpu"}, tmp_path / "idx", buckets=2)
    da, db = session.parquet(tmp_path / "a"), session.parquet(tmp_path / "b")
    inter = session.to_pandas(da.intersect(db)).sort_values("x")
    assert list(map(tuple, inter.to_numpy())) == [(1, "a"), (3, "c")]
    exc = session.to_pandas(da.except_(db)).sort_values("x")
    assert list(map(tuple, exc.to_numpy())) == [(2, "b"), (5, "e")]
    with pytest.raises(ValueError, match="equal width"):
        da.intersect(db.select("u"))
    with pytest.raises(ValueError, match="incompatible"):
        da.intersect(db.select("v", "u"))
    assert da.intersect(db).to_json() == hjax.HyperspaceSession(
        system_path=str(tmp_path / "jidx")).parquet(tmp_path / "a").intersect(
        hjax.HyperspaceSession(system_path=str(tmp_path / "jidx")).parquet(tmp_path / "b")).to_json()


def test_null_safe_codes_are_not_shared_with_the_plain_join(factdim):
    """A set operation and a join over the same stable columns: the
    factorization cache keys on null-safety, so each codes its nulls its
    own way (a shared entry would let NULL match in the join or not in
    the set operation). The right side rides the d_nk index, so the
    intersect re-bucketizes the left; a NULL fnk row must survive it."""
    _, session, fs, ds = factdim["torch"]
    session.enable_hyperspace()
    fact = session.to_pandas(fs.select("fnk"))
    dim = session.to_pandas(ds.select("dnk"))
    keys = set(dim["dnk"].dropna())
    for _ in range(2):
        join = session.to_pandas(fs.select("fnk", "q").join(ds.select("dnk", "w"), ["fnk"], ["dnk"], how="semi"))
        assert len(join) == int(fact["fnk"].isin(keys).sum())
        inter = session.to_pandas(fs.select("fnk").intersect(ds.select("dnk")))
        assert session.last_query_stats["join_path"] == "rebucketized-aligned"
        assert set(inter["fnk"].dropna()) == set(fact["fnk"].dropna()) & keys
        assert inter["fnk"].isna().sum() == 1
        exc = session.to_pandas(fs.select("fnk").except_(ds.select("dnk")))
        assert set(exc["fnk"].dropna()) == set(fact["fnk"].dropna()) - keys
        assert exc["fnk"].isna().sum() == 0
