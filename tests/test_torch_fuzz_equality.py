"""tests/test_fuzz_equality.py's seeded generator through both packages.

Random predicate trees over random tables (nulls, strings, floats) and
random join types over nullable keys, each run by the JAX package and by
the port on the same parquet with validation on (the default), index
off and on: the rows must be equal between the packages (exact), and
their count equal to the generator's own pandas 3-valued-logic
evaluator.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu_torch.plan import expr as texpr
from tests.test_fuzz_equality import make_frame, pandas_tri, rand_pred

PKGS = (("jax", hjax, jexpr, {}), ("torch", htorch, texpr, {"device": "cpu"}))


def to_expr(p, pkg, E):
    """The generator's predicate tuple as one package's expression."""
    col, lit = pkg.col, pkg.lit
    t = p[0]
    if t == "and":
        return to_expr(p[1], pkg, E) & to_expr(p[2], pkg, E)
    if t == "or":
        return to_expr(p[1], pkg, E) | to_expr(p[2], pkg, E)
    if t == "not":
        return ~to_expr(p[1], pkg, E)
    if t == "cmp":
        _, op, c, v = p
        return E.BinOp(op, col(c), lit(v))
    if t == "in":
        return col(p[1]).isin(p[2])
    if t == "like":
        return col(p[1]).like(p[2])
    if t == "isnull":
        return col(p[1]).is_null()
    _, op, c1, c2 = p
    return E.BinOp(op, col(c1), col(c2))


def _rows(table, cols) -> list:
    """A result's rows as sorted tuples, NULL as None and floats by repr."""
    d = table.decode()
    out = []
    n = table.num_rows
    for i in range(n):
        row = []
        for c in cols:
            v = d[c][i]
            if v is None or (isinstance(v, float) and np.isnan(v)) or v is pd.NA:
                row.append(None)
            elif isinstance(v, (np.floating, float)):
                row.append(repr(float(v)))
            elif isinstance(v, (np.integer, int)):
                row.append(int(v))
            else:
                row.append(str(v))
        out.append(tuple(row))
    return sorted(out, key=repr)


@pytest.mark.parametrize("seed", range(20))
def test_random_filters_equal_in_both_packages(tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    df = make_frame(rng, int(rng.integers(500, 3_000)))
    root = tmp_path / "t"
    root.mkdir()
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), root / "p.parquet")
    preds = [rand_pred(rng) for _ in range(6)]
    sessions = {}
    for name, pkg, E, kw in PKGS:
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=4, **kw)
        ds = s.parquet(root)
        pkg.Hyperspace(s).create_index(ds, pkg.IndexConfig("fz_k", ["k"], ["a", "f", "s"]))
        sessions[name] = (s, ds, pkg, E)
    cols = ["k", "a", "f", "s"]
    for case, p in enumerate(preds):
        exp_n = int(pandas_tri(df, p)[0].sum())
        for indexed in (False, True):
            got = {}
            for name, (s, ds, pkg, E) in sessions.items():
                s.enable_hyperspace() if indexed else s.disable_hyperspace()
                got[name] = _rows(s.run(ds.filter(to_expr(p, pkg, E))), cols)
                assert len(got[name]) == exp_n, (name, seed, case, p, indexed)
            assert got["torch"] == got["jax"], (seed, case, p, indexed)


@pytest.mark.parametrize("seed", range(8))
def test_random_join_types_equal_in_both_packages(tmp_path, seed):
    rng = np.random.default_rng(2000 + seed)
    n_l, n_r = int(rng.integers(400, 2_000)), int(rng.integers(50, 600))
    lk = rng.integers(0, 120, n_l).astype(np.float64)
    lk[rng.random(n_l) < 0.06] = np.nan
    rk = rng.integers(60, 200, n_r).astype(np.float64)
    rk[rng.random(n_r) < 0.06] = np.nan
    l = pd.DataFrame({"k": pd.array(np.where(np.isnan(lk), None, lk), dtype="Int64"),
                      "lv": rng.integers(0, 9, n_l).astype(np.int64)})
    r = pd.DataFrame({"k2": pd.array(np.where(np.isnan(rk), None, rk), dtype="Int64"),
                      "rv": np.round(rng.normal(size=n_r), 4)})
    for nm, fr in (("l", l), ("r", r)):
        (tmp_path / nm).mkdir()
        pq.write_table(pa.Table.from_pandas(fr, preserve_index=False), tmp_path / nm / "p.parquet")
    how = ["inner", "left", "right", "full", "semi", "anti"][seed % 6]
    cols = ["k", "lv"] if how in ("semi", "anti") else ["k", "lv", "rv"]
    got = {}
    for name, pkg, E, kw in PKGS:
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=2, **kw)
        ls, rs = s.parquet(tmp_path / "l"), s.parquet(tmp_path / "r")
        hs = pkg.Hyperspace(s)
        hs.create_index(ls, pkg.IndexConfig("l_k", ["k"], ["lv"]))
        hs.create_index(rs, pkg.IndexConfig("r_k", ["k2"], ["rv"]))
        for indexed in (False, True):
            s.enable_hyperspace() if indexed else s.disable_hyperspace()
            got[name, indexed] = _rows(s.run(ls.join(rs, ["k"], ["k2"], how=how)), cols)
    ld, rd = l[l.k.notna()], r[r.k2.notna()]
    inner = int(ld.merge(rd, left_on="k", right_on="k2").shape[0])
    n_exp = {
        "inner": inner,
        "left": inner + int((~l.k.isin(set(rd.k2))).sum()),
        "right": inner + int((~r.k2.isin(set(ld.k))).sum()),
        "full": inner + int((~l.k.isin(set(rd.k2))).sum()) + int((~r.k2.isin(set(ld.k))).sum()),
        "semi": int(l.k.isin(set(rd.k2)).sum()),
        "anti": int((~l.k.isin(set(rd.k2))).sum()),
    }[how]
    for indexed in (False, True):
        assert len(got["torch", indexed]) == n_exp, (seed, how, indexed)
        assert got["torch", indexed] == got["jax", indexed], (seed, how, indexed)
    assert got["torch", True] == got["torch", False]
