"""ORDER BY, LIMIT, top-N and UNION in the port, against the JAX package.

Sort: several keys, DESC, NULLs (first ascending, last descending),
strings, floats with NaN and signed zeros — row for row in the JAX
package's order, ties in input order. Top-N (ORDER BY ... LIMIT): the
full sort below max(2n, 1,024) rows and the partition select past it,
with ties at the threshold and keys that tie on the first 64 bits of the
selection key (a nullable int64: validity and high word) — the same rows
and the same `top_n` details (kernel, candidates) as the JAX package's
`TopN` node. LIMIT over a multi-file scan stops early, reading as many
files as the JAX package (`files_read`, `limit_early_out`). UNION
concatenates its inputs in order.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch

N = 6_000


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sortlim")
    rng = np.random.default_rng(13)
    f = np.round(rng.normal(size=N) * 3, 1)
    f[rng.random(N) < 0.02] = np.nan
    f[rng.random(N) < 0.02] = -0.0
    big = (rng.integers(0, 3, N) << 40) + rng.integers(0, 1 << 20, N)  # the high word repeats
    t = pa.table({
        "i": np.arange(N, dtype=np.int64),
        "a": rng.integers(0, 40, N).astype(np.int32),
        "s": pa.array([None if rng.random() < 0.05 else w for w in
                       np.array(["pear", "apple", "fig", "kiwi", "lime"], dtype=object)[rng.integers(0, 5, N)]]),
        "f": pa.array([None if rng.random() < 0.05 else float(x) for x in f], type=pa.float64()),
        "big": pa.array([None if rng.random() < 0.03 else int(x) for x in big], type=pa.int64()),
        "d": pa.array(rng.integers(9000, 9400, N).astype(np.int32), type=pa.int32()).cast(pa.date32()),
    })
    (tmp / "t").mkdir()
    for j in range(6):
        pq.write_table(t.slice(j * N // 6, N // 6), tmp / "t" / f"part-{j}.parquet")
    out = {}
    for name, pkg, kw in (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"})):
        s = pkg.HyperspaceSession(system_path=str(tmp / f"idx_{name}"), num_buckets=4, **kw)
        scan = s.parquet(tmp / "t")
        pkg.Hyperspace(s).create_index(scan, pkg.IndexConfig("by_a", ["a"], ["i", "f"]))
        s.enable_hyperspace()
        out[name] = (pkg, s, scan)
    return out


def _top_n(name, session):
    if name == "torch":
        return session.last_query_stats["top_n"]
    for n in session.last_physical_plan.walk():
        if n.op == "TopN":
            return {k: n.detail[k] for k in ("kernel", "candidates") if k in n.detail}
    return None


def _early(name, session):
    if name == "torch":
        return session.last_query_stats["limit_early_out"]
    for n in session.last_physical_plan.walk():
        if n.op == "LimitEarlyOut":
            return {k: n.detail[k] for k in ("files_scanned", "files_total")}
    return None


def _run(both, build):
    out = {}
    for name in ("jax", "torch"):
        pkg, s, t = both[name]
        frame = s.to_pandas(build(pkg, t))
        out[name] = (frame, _top_n(name, s), _early(name, s), s.last_query_stats["files_read"])
    return out["jax"], out["torch"]


def _rows(frame) -> list:
    return [tuple("NaN" if isinstance(v, float) and np.isnan(v) else v for v in r)
            for r in frame.astype(object).where(frame.notna(), None).itertuples(index=False)]


@pytest.mark.parametrize("by", [
    [("a", True), ("i", False)],
    [("s", True), ("a", False)],
    [("s", False), ("f", True)],
    [("f", False)],
    [("f", True), ("s", True)],
    [("big", False), ("d", True)],
    [("d", False), ("s", False), ("a", True)],
])
def test_sort_orders_rows_as_the_jax_package(both, by):
    (want, *_), (got, *_) = _run(both, lambda pkg, t: t.sort(by).select("i", "a", "s", "f", "big", "d"))
    assert _rows(got) == _rows(want)
    # Every key with ties: equal keys keep input order (the `i` column).


@pytest.mark.parametrize("n,by", [
    (10, [("a", False), ("i", True)]),          # past max(2n, 1,024): partition select
    (5, [("f", True), ("i", True)]),            # NaN and -0.0 / +0.0 in the key
    (7, [("big", False), ("i", True)]),         # 64-bit prefix ties, NULLs last
    (7, [("big", True), ("i", True)]),          # NULLs first
    (25, [("s", True), ("a", True), ("i", False)]),  # string key: massive ties at the threshold
    (3_500, [("a", True), ("i", True)]),        # 2n past the rows: the full sort
    (0, [("a", True)]),
])
def test_top_n_rows_and_selection_equal_the_jax_package(both, n, by):
    (want, wtop, *_), (got, gtop, *_) = _run(both, lambda pkg, t: t.sort(by).limit(n))
    assert _rows(got) == _rows(want)
    assert gtop == wtop
    if n:
        assert gtop["kernel"] == ("full-sort" if N <= max(2 * n, 1024) else "partition-select + sort")


def test_top_n_over_an_aggregate_and_a_filter(both):
    def build(pkg, t):
        return t.filter(pkg.col("a") > 3).aggregate(["a", "s"], [("sum", "f", "sf"), ("count", None, "n")]).sort(
            [("n", False), ("a", True), ("s", True)]).limit(12)

    (want, wtop, *_), (got, gtop, *_) = _run(both, build)
    assert _rows(got) == _rows(want) and gtop == wtop


@pytest.mark.parametrize("n", [10, 500, 5_990, 7_000])
def test_limit_early_out_reads_the_jax_packages_files(both, n):
    def build(pkg, t):
        return t.filter(pkg.col("f") > 0.0).select("i", "f").limit(n)

    (want, _, wearly, wread), (got, _, gearly, gread) = _run(both, build)
    assert len(got) == len(want) == min(n, len(want))
    assert gearly == wearly and gread == wread
    assert (got.f > 0).all()


def test_limit_over_an_index_prunes_first(both):
    # A point lookup on the index key stays one bucket file.
    (want, _, wearly, wread), (got, _, gearly, gread) = _run(
        both, lambda pkg, t: t.filter(pkg.col("a") == 7).select("a", "i").limit(3))
    assert len(got) == len(want) == 3 and (got.a == 7).all()
    assert (gearly, gread) == (wearly, wread)


def test_limit_without_an_early_out(both):
    (want, _, wearly, _), (got, _, gearly, _) = _run(
        both, lambda pkg, t: t.aggregate(["a"], [("count", None, "n")]).limit(5))
    assert len(got) == len(want) == 5 and gearly is None and wearly is None


def test_union_concatenates_in_order(both):
    def build(pkg, t):
        from importlib import import_module

        union = import_module(f"{pkg.__name__}.plan.nodes").Union
        low = t.filter(pkg.col("a") < 3).select("i", "s", "f")
        high = t.filter(pkg.col("a") > 37).select("i", "s", "f")
        return union([low, high, low])

    (want, *_), (got, *_) = _run(both, build)
    assert _rows(got) == _rows(want)
    (want, *_), (got, *_) = _run(both, lambda pkg, t: build(pkg, t).sort([("i", True)]).limit(20))
    assert _rows(got) == _rows(want)


def test_sort_and_limit_json_round_trip(both):
    from hyperspace_tpu_torch.plan.nodes import plan_from_json

    plans = []
    for name in ("jax", "torch"):
        pkg, _, t = both[name]
        plans.append(t.sort([("a", False), "s"]).limit(9))
    assert plans[0].to_json() == plans[1].to_json()
    assert plan_from_json(plans[1].to_json()).to_json() == plans[1].to_json()
