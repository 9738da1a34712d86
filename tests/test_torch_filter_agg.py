"""The port's predicate mask and grouped aggregate against the JAX package's,
on one seeded table with nulls in every column (CPU, small).

Masks must be identical (SQL three-valued logic: a comparison with a NULL
input is neither true nor false). Aggregates must match exactly on keys,
counts, integral sums and extrema, and within 1e-12 of Σ|v| per group on
non-integral sums and means (float64 sums taken in another order).
"""

import numpy as np
import pandas as pd
import pytest

from hyperspace_tpu.execution.table import ColumnTable as JaxTable
from hyperspace_tpu.ops.aggregate import aggregate_table as jax_aggregate_table
from hyperspace_tpu.ops.filter import eval_predicate_mask as jax_mask
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu.plan.nodes import AggSpec as JaxAggSpec
from hyperspace_tpu.plan.nodes import Aggregate as JaxAggregate
from hyperspace_tpu.plan.nodes import Scan as JaxScan
from hyperspace_tpu.schema import Schema as JaxSchema
from hyperspace_tpu_torch.interop import table_from_numpy
from hyperspace_tpu_torch.ops.aggregate import aggregate_table
from hyperspace_tpu_torch.ops.filter import eval_predicate_mask
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.plan.nodes import AggSpec, Aggregate, Scan
from hyperspace_tpu_torch.schema import Field, Schema

N = 3_000
SCHEMA = Schema.of(
    Field("k", "int64", True),
    Field("g", "string", True),
    Field("q", "float64", True),
    Field("p", "float64", True),
    Field("f", "float32", True),
    Field("i", "int32", True),
    Field("dt", "date", True),
)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(5)

    def nulls():
        return rng.random(N) < 0.08

    cols = {
        "k": np.ma.masked_array(rng.integers(0, 50, N).astype(np.int64), nulls()),
        "g": np.where(nulls(), None, np.array(["x", "y", "zz", "w"], dtype=object)[rng.integers(0, 4, N)]),
        "q": np.ma.masked_array(rng.integers(1, 51, N).astype(np.float64), nulls()),
        "p": np.ma.masked_array(rng.normal(size=N) * 1e4, nulls()),
        "f": np.ma.masked_array(rng.normal(size=N).astype(np.float32), nulls()),
        "i": np.ma.masked_array(rng.integers(-100, 100, N).astype(np.int32), nulls()),
        "dt": np.ma.masked_array(rng.integers(9000, 9100, N).astype(np.int32), nulls()),
    }
    port = table_from_numpy(cols, SCHEMA, device="cpu")
    ref = JaxTable.from_arrow(port.to_arrow(), JaxSchema.from_json(SCHEMA.to_json()))
    return port, ref


def _preds(x):
    c = x.col
    return [
        c("k") == 7,
        c("k") != 7,
        c("k") < 20.5,
        c("k") >= 3.0,
        c("g") == "zz",
        c("g") > "x",
        c("g") == "absent",
        c("g") <= "xa",
        c("q") > 25,
        (c("p") < 0.0) | (c("i") >= 50),
        ~((c("k") == 1) & (c("g") == "y")),
        c("k").isin([1, 2, 3, 49]),
        c("g").isin(["w", "zz", "nope"]),
        c("f").is_null(),
        c("f").is_not_null() & (c("f") > 0.5),
        c("i") < c("k"),
        (c("dt") >= 9050) & (c("dt") < 9060),
        (c("q") + c("p")) > 100.0,
    ]


@pytest.mark.parametrize("i", range(len(_preds(texpr))))
def test_mask_matches_the_jax_package(tables, i):
    port, ref = tables
    got = eval_predicate_mask(port, _preds(texpr)[i]).numpy()
    want = jax_mask(ref, _preds(jexpr)[i], venue="host")
    np.testing.assert_array_equal(got, want)
    assert got.any() or i in (6,)


AGGS = [
    ("sum", "q", "sq"),
    ("sum", "p", "sp"),
    ("mean", "p", "mp"),
    ("min", "f", "mnf"),
    ("max", "i", "mxi"),
    ("min", "g", "mng"),
    ("count", "p", "cp"),
    ("count", None, "c"),
]
EXACT = ["sq", "mnf", "mxi", "mng", "cp", "c"]


@pytest.mark.parametrize("group_by", [["g"], ["k"], ["g", "k"], ["dt"], []], ids=lambda g: "+".join(g) or "none")
def test_aggregate_matches_the_jax_package(tables, group_by):
    port, ref = tables
    specs = [AggSpec.of(*a) for a in AGGS]
    jspecs = [JaxAggSpec.of(*a) for a in AGGS]
    out_schema = Aggregate(Scan("x", "parquet", SCHEMA), group_by, specs).schema
    jout_schema = JaxAggregate(JaxScan("x", "parquet", ref.schema), group_by, jspecs).schema
    got = pd.DataFrame(aggregate_table(port, group_by, specs, out_schema).decode())
    want = pd.DataFrame(jax_aggregate_table(ref, group_by, jspecs, jout_schema, venue="host").decode())
    order = group_by or ["c"]
    got = got.sort_values(order, key=lambda s: s.map(str)).reset_index(drop=True)
    want = want.sort_values(order, key=lambda s: s.map(str)).reset_index(drop=True)
    pd.testing.assert_frame_equal(got[group_by + EXACT], want[group_by + EXACT])
    dec = pd.DataFrame(port.decode())
    keyed = dec.assign(_a=dec["p"].astype(float).abs(), _n=dec["p"].notna())
    if group_by:
        grp = keyed.groupby([dec[c].map(str) for c in group_by], sort=True)
        abs_sum, nonnull = grp["_a"].sum().to_numpy(), grp["_n"].sum().to_numpy()
    else:
        abs_sum, nonnull = np.array([keyed["_a"].sum()]), np.array([keyed["_n"].sum()])
    for alias, tol in (("sp", 1e-12 * abs_sum), ("mp", 1e-12 * abs_sum / np.maximum(nonnull, 1))):
        a = got[alias].astype(float).to_numpy()
        b = want[alias].astype(float).to_numpy()
        assert np.all((np.abs(a - b) <= tol) | (np.isnan(a) & np.isnan(b))), alias


# More than 32 aggregates: 80 channels, more than one launch of the kernel
# on the card (64 channels per launch). Every aggregate here is exact.
WIDE_AGGS = [
    (fn, c, f"a{i}")
    for i, (fn, c) in enumerate(
        [("sum", "q"), ("min", "p"), ("max", "p"), ("min", "f"), ("max", "i"), ("sum", "i"), ("count", "p"), ("count", None)]
        * 5
    )
]


def test_wide_aggregate_matches_the_jax_package(tables):
    port, ref = tables
    specs = [AggSpec.of(*a) for a in WIDE_AGGS]
    jspecs = [JaxAggSpec.of(*a) for a in WIDE_AGGS]
    out_schema = Aggregate(Scan("x", "parquet", SCHEMA), ["k"], specs).schema
    jout_schema = JaxAggregate(JaxScan("x", "parquet", ref.schema), ["k"], jspecs).schema
    got = pd.DataFrame(aggregate_table(port, ["k"], specs, out_schema).decode())
    want = pd.DataFrame(jax_aggregate_table(ref, ["k"], jspecs, jout_schema, venue="host").decode())
    got = got.sort_values("k").reset_index(drop=True)
    want = want.sort_values("k").reset_index(drop=True)
    assert len(WIDE_AGGS) == 40 and len(got) > 1
    pd.testing.assert_frame_equal(got, want)
