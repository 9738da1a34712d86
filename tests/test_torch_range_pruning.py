"""Range (min/max) pruning over sorted index buckets, the port against the
JAX package.

The non-hybrid cases of tests/test_range_pruning.py run through both
packages on ONE index (built by the JAX package, read by both): each
query's rows must be equal, and so must `files_pruned`, `rows_pruned`
and the exactness of the slice (the JAX package's IndexRangeScan node
says "mask skipped"; the port's `range_exact` stat is True). Rows are
compared exactly after sorting: pruning and slicing select rows and do
no arithmetic. The port's batched slice (one torch.searchsorted over the
bucket-major keys) must find, file by file, what np.searchsorted finds.
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu.execution import io as jio
from hyperspace_tpu_torch.execution import io as tio

NB = 8
PACKAGES = (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"}))


def _indexed(tmp, table: pa.Table, name: str, indexed: list, included: list, buckets: int = NB):
    """One parquet source and one covering index built by the JAX
    package; a session of each package over them, hyperspace enabled.
    Returns {package: (pkg, session, scan)}."""
    root = tmp / f"{name}_src"
    root.mkdir()
    pq.write_table(table, root / "p.parquet")
    out = {}
    for label, pkg, kw in PACKAGES:
        session = pkg.HyperspaceSession(system_path=str(tmp / "idx"), num_buckets=buckets, **kw)
        scan = session.parquet(root)
        if label == "jax":
            pkg.Hyperspace(session).create_index(scan, pkg.IndexConfig(name, indexed, included))
        session.enable_hyperspace()
        out[label] = (pkg, session, scan)
    return out


def _exactness(label, session):
    """True: the slice was the predicate (mask skipped); False: a range
    scan that masked; None: no range scan ran."""
    if label == "torch":
        return session.last_query_stats["range_exact"]
    nodes = [n for n in session.last_physical_plan.walk() if n.op == "IndexRangeScan"]
    if not nodes:
        return None
    return "mask skipped" in nodes[0].detail["kernel"]


def _run_both(both, make_query, sort_by):
    """Rows and pruning evidence of one query in each package."""
    got = {}
    for label, (pkg, session, scan) in both.items():
        frame = session.to_pandas(make_query(pkg, scan))
        frame = frame.sort_values(sort_by).reset_index(drop=True) if len(frame) else frame
        st = session.last_query_stats
        got[label] = (frame, st["files_pruned"], st["rows_pruned"], _exactness(label, session), st["files_read"])
    return got


def _assert_parity(got):
    (jf, jfp, jrp, jex, _), (tf, tfp, trp, tex, _) = got["jax"], got["torch"]
    assert list(tf.columns) == list(jf.columns)
    assert len(tf) == len(jf)
    for c in jf.columns:
        np.testing.assert_array_equal(tf[c].to_numpy(), jf[c].to_numpy(), err_msg=c)
    assert (tfp, trp, tex) == (jfp, jrp, jex)


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    """tests/test_range_pruning.py's source: an int64 key over 100k values,
    a float and a string column, 50,000 rows, 8 buckets."""
    rng = np.random.default_rng(11)
    n = 50_000
    df = pd.DataFrame({
        "k": rng.integers(0, 100_000, n).astype(np.int64),
        "v": rng.normal(size=n),
        "tag": rng.choice(["x", "y", "z"], n),
    })
    both = _indexed(tmp_path_factory.mktemp("range"), pa.Table.from_pandas(df, preserve_index=False),
                    "r_k", ["k"], ["v", "tag"])
    return both, df


def test_port_reads_the_manifest_key_stats_the_jax_package_reads(indexed):
    both, _ = indexed
    _, session, _ = both["torch"]
    files = sorted(str(p) for p in Path(session.conf.system_path).rglob("bucket-*.parquet"))
    assert len(files) == NB
    assert tio.file_key_stats(files) == jio.file_key_stats(files)
    for c in ("v", "tag"):
        assert tio.file_column_stats(files, c) == jio.file_column_stats(files, c)


# (name, query over (pkg, scan)): between, half-open (the exact slice),
# open past every key, strict below, a float bound on the int key, an IN
# list (point-pruned in both), the slice with a residual conjunct, bounds
# written literal-first, a bound on an included column only, and a NaN
# bound.


def _q(name):
    return {
        "between": lambda p, s: s.filter((p.col("k") >= p.lit(40_000)) & (p.col("k") <= p.lit(40_500))),
        "half-open": lambda p, s: s.filter((p.col("k") >= p.lit(30_000)) & (p.col("k") < p.lit(31_000))),
        "open past every key": lambda p, s: s.filter(p.col("k") > p.lit(100_000)),
        "strict below": lambda p, s: s.filter(p.col("k") < p.lit(1_500)),
        "float bound on the int key": lambda p, s: s.filter(
            (p.col("k") > p.lit(20_000.5)) & (p.col("k") <= p.lit(20_900.0))
        ),
        "in envelope": lambda p, s: s.filter(p.col("k").isin([5_000, 5_100, 5_700])),
        "with a residual conjunct": lambda p, s: s.filter(
            (p.col("k") >= p.lit(30_000)) & (p.col("k") < p.lit(31_000)) & (p.col("v") > p.lit(0.0))
        ),
        "lit op col": lambda p, s: s.filter((p.lit(60_000) <= p.col("k")) & (p.lit(60_300) > p.col("k"))),
        "included column only": lambda p, s: s.filter(p.col("v") > p.lit(4.2)),
        "nan bound": lambda p, s: s.filter(p.col("k") <= p.lit(float("nan"))),
    }[name]


@pytest.mark.parametrize(
    "name",
    ["between", "half-open", "open past every key", "strict below", "float bound on the int key",
     "in envelope", "with a residual conjunct", "lit op col", "included column only", "nan bound"],
)
def test_range_queries_prune_and_slice_as_the_jax_package(indexed, name):
    both, df = indexed
    got = _run_both(both, _q(name), ["k", "v"])
    _assert_parity(got)
    if name in ("between", "half-open", "with a residual conjunct"):
        assert got["torch"][2] > 0  # the slice kicked in
    if name == "half-open":
        assert got["torch"][3] is True  # the slice is the predicate: no mask
    if name == "with a residual conjunct":
        assert got["torch"][3] is False
    if name == "open past every key":
        assert len(got["torch"][0]) == 0 and got["torch"][1] == NB and got["torch"][4] == 0


def test_strict_vs_inclusive_bounds_at_the_maximum(indexed):
    both, df = indexed
    kmax = int(df.k.max())
    inc = _run_both(both, lambda p, s: s.filter(p.col("k") >= p.lit(kmax)), ["k", "v"])
    strict = _run_both(both, lambda p, s: s.filter(p.col("k") > p.lit(kmax)), ["k", "v"])
    _assert_parity(inc)
    _assert_parity(strict)
    assert len(inc["torch"][0]) == int((df.k == kmax).sum()) and len(strict["torch"][0]) == 0


def test_null_keys_are_not_sliced(tmp_path):
    t = pa.table({"k": pa.array([1, 5, None, 9, None, 3, 12, None], type=pa.int64()),
                  "v": np.arange(8, dtype=np.float64)})
    both = _indexed(tmp_path, t, "n_k", ["k"], ["v"], buckets=2)
    for q in (lambda p, s: s.filter(p.col("k") >= p.lit(4)),
              lambda p, s: s.filter((p.col("k") > p.lit(2)) & (p.col("k") < p.lit(10)))):
        got = _run_both(both, q, ["k", "v"])
        _assert_parity(got)
    assert sorted(got["torch"][0]["k"]) == [3, 5, 9]


def test_string_key_prunes_files_and_is_never_exact(tmp_path):
    df = pd.DataFrame({"s": [f"key{i:04d}" for i in range(2_000)], "v": np.arange(2_000, dtype=np.float64)})
    both = _indexed(tmp_path, pa.Table.from_pandas(df, preserve_index=False), "s_k", ["s"], ["v"], buckets=4)
    got = _run_both(both, lambda p, s: s.filter(p.col("s") < p.lit("key0010")), ["s"])
    _assert_parity(got)
    assert sorted(got["torch"][0]["s"]) == sorted(df.s[df.s < "key0010"])
    assert got["torch"][3] is False
    empty = _run_both(both, lambda p, s: s.filter(p.col("s") > p.lit("zzz")), ["s"])
    _assert_parity(empty)
    assert len(empty["torch"][0]) == 0 and empty["torch"][4] == 0


def test_float32_key_weak_literal_not_overpruned(tmp_path):
    """A Python float literal against a float32 key compares in float32
    (the literal rounds), in the mask and in the pruning alike."""
    df = pd.DataFrame({"k": np.full(300, np.float32(0.1), dtype=np.float32), "p": np.arange(300, dtype=np.float64)})
    both = _indexed(tmp_path, pa.Table.from_pandas(df, preserve_index=False), "f_k", ["k"], ["p"], buckets=2)
    for q in (lambda p, s: s.filter(p.col("k") <= p.lit(0.1)), lambda p, s: s.filter(p.col("k") >= p.lit(0.1)),
              lambda p, s: s.filter(p.col("k") > p.lit(0.1))):
        got = _run_both(both, q, ["p"])
        _assert_parity(got)
    assert len(_run_both(both, lambda p, s: s.filter(p.col("k") <= p.lit(0.1)), ["p"])["torch"][0]) == 300


def test_float_key_with_nan_values_is_masked(tmp_path):
    """NaN values sort last; a lower-bound slice keeps them, so a float
    key is never exact and the mask drops them."""
    df = pd.DataFrame({"k": np.array([1.0, 2.0, 3.0, np.nan, np.nan, 2.5, -1.0]), "v": np.arange(7, dtype=np.float64)})
    both = _indexed(tmp_path, pa.Table.from_pandas(df, preserve_index=False), "nk", ["k"], ["v"], buckets=1)
    got = _run_both(both, lambda p, s: s.filter(p.col("k") >= p.lit(2.0)), ["k"])
    _assert_parity(got)
    assert sorted(got["torch"][0]["k"]) == [2.0, 2.5, 3.0]
    assert got["torch"][3] is False


def test_int32_key_bounds_past_its_range(tmp_path):
    """Bounds beyond an int32 key's range (2^40, ±inf): an empty slice
    above, no bound below, equal to the JAX package's promoted
    comparison; float bounds round inward."""
    rng = np.random.default_rng(5)
    df = pd.DataFrame({"k": rng.integers(-1_000, 1_000, 5_000).astype(np.int32), "v": rng.normal(size=5_000)})
    both = _indexed(tmp_path, pa.Table.from_pandas(df, preserve_index=False), "i32", ["k"], ["v"], buckets=4)
    for q in (lambda p, s: s.filter(p.col("k") > p.lit(2**40)),
              lambda p, s: s.filter((p.col("k") > p.lit(-(2**40))) & (p.col("k") < p.lit(-990))),
              lambda p, s: s.filter((p.col("k") >= p.lit(-3.5)) & (p.col("k") < p.lit(7.25))),
              lambda p, s: s.filter((p.col("k") > p.lit(float("-inf"))) & (p.col("k") <= p.lit(-900.0))),
              lambda p, s: s.filter(p.col("k") < p.lit(float("inf")))):
        _assert_parity(_run_both(both, q, ["k", "v"]))
