"""The execution venues of the port against the JAX package's.

`pick_venue` decides as the JAX package's does over the whole grid of
its inputs (the requested venue, HYPERSPACE_VENUE, a mesh's preference,
whether the host path needs the native library, whether it is there, the
JAX package's link probe above or below its floor), with the same error
text, but for one deliberate difference: the port's `auto` is always the
device, where the JAX package's takes the host below the link floor (the
port's columns already lie on the card). The three native bindings the
host venues add equal the JAX package's on the same inputs. Then
tests/test_join_venue.py's cases and tests/test_device_staging.py's
queries through both packages: every venue `host`, the port's answers
byte-identical to the JAX package's host venue, and equal to the port's
own device venue; the host build's bucket files byte-identical across
both packages and to the device build's; the stats and physical-plan
names of each host operator equal to the JAX package's. The masks of
projections, CASE inputs and window inputs follow the session's filter
venue; the ops alone default to the device.
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
from hyperspace_tpu import native as jnative
from hyperspace_tpu.parallel import bandwidth as jbw
from hyperspace_tpu_torch import native as tnative
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.parallel import bandwidth as tbw

CPU = torch.device("cpu")
VENUE_KEYS = ("hyperspace.filter.venue", "hyperspace.join.venue", "hyperspace.agg.venue", "hyperspace.sort.venue")
needs_native = pytest.mark.skipif(not jnative.available(), reason="the JAX package's native library did not build")


# -- pick_venue ----------------------------------------------------------------


def _decide(pick, *args, **kw):
    try:
        return pick(*args, **kw)
    except Exception as e:  # noqa: BLE001 — the message is the decision
        return f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("env", [None, "device", "host", "hOst"])
@pytest.mark.parametrize("requested", ["auto", "device", "host", "bogus"])
def test_pick_venue_decides_as_the_jax_package(monkeypatch, requested, env):
    """Every combination of a mesh's preference, the host path's need for
    the library, the library's presence and the JAX package's probe
    against its floor: the same venue, or the same error text; where the
    JAX package's unforced `auto` takes the host, the port's takes the
    device."""
    if env is None:
        monkeypatch.delenv("HYPERSPACE_VENUE", raising=False)
    else:
        monkeypatch.setenv("HYPERSPACE_VENUE", env)
    differs = 0
    for lib in (True, False):
        monkeypatch.setattr(jnative, "available", lambda lib=lib: lib)
        monkeypatch.setattr(tnative, "available", lambda lib=lib: lib)
        for mbps in (50.0, 5000.0):
            monkeypatch.setattr(jbw, "d2h_mb_per_s", lambda mbps=mbps: mbps)
            for prefer in (False, True):
                for needs in (False, True):
                    want = _decide(jbw.pick_venue, requested, 200.0, prefer, "hyperspace.join.venue",
                                   needs_native=needs)
                    if want == "host" and requested == "auto" and env is None:
                        want, differs = "device", differs + 1
                    got = _decide(tbw.pick_venue, requested, "hyperspace.join.venue", needs_native=needs)
                    assert got == want, (lib, mbps, prefer, needs)
    # The difference shows exactly where the JAX package's link decides.
    assert differs == (3 if requested == "auto" and env is None else 0)


@pytest.mark.parametrize("key", [*VENUE_KEYS, "hyperspace.build.venue"])
def test_auto_is_the_device_where_the_jax_package_takes_the_host(staged, monkeypatch, key):
    """On a link the JAX package finds slow, its `auto` takes the host
    venue for each operator; the port's keeps the device, reading no
    link, and takes the host only where the key forces it."""
    monkeypatch.delenv("HYPERSPACE_VENUE", raising=False)
    monkeypatch.setattr(jbw, "d2h_mb_per_s", lambda: 50.0)
    j_session, t_session = staged[hjax][0], staged[htorch][0]
    what = key.split(".")[1]
    assert jbw.pick_venue(j_session.conf.get(key), 200.0, False, key, needs_native=False) == "host"
    attr = f"{what}_venue"
    assert getattr(t_session.conf, attr) == "auto"
    assert tbw.pick_venue(getattr(t_session.conf, attr), key, needs_native=False) == "device"
    t_session.conf.set(key, "host")
    try:
        assert tbw.pick_venue(getattr(t_session.conf, attr), key, needs_native=False) == "host"
    finally:
        t_session.conf.set(key, "auto")


def test_the_ops_default_to_the_device_venue(staged, monkeypatch):
    """`eval_predicate_mask` and `apply_filter` called without a venue
    evaluate on the device, whatever HYPERSPACE_VENUE says: the venue is
    the executor's choice, made from the session's conf."""
    from hyperspace_tpu_torch.ops import filter as tfilter

    session, fs, *_ = staged[htorch]
    table = session.run(fs)
    monkeypatch.setenv("HYPERSPACE_VENUE", "host")
    monkeypatch.setattr(tfilter, "_host_mask", lambda *a: pytest.fail("an op chose the host venue itself"))
    pred = htorch.col("q") > 500.0
    mask = tfilter.eval_predicate_mask(table, pred)
    assert tfilter.apply_filter(table, pred).num_rows == int(mask.sum()) > 0


# -- the native bindings -----------------------------------------------------------


def _runs(rng, nb, top, lens):
    parts = [np.sort(rng.integers(0, top, n)).astype(np.int32) for n in lens]
    codes = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    return codes, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


NATIVE_CASES = {
    "random": (6, 12, (7, 0, 30, 12, 1, 25), (9, 14, 0, 22, 3, 40)),
    "empty_buckets": (4, 5, (0, 0, 10, 0), (3, 0, 0, 8)),
    "one_bucket": (1, 50, (400,), (300,)),
    "no_matches": (3, 10, (5, 5, 5), (6, 6, 6)),
    "empty": (2, 5, (0, 0), (0, 0)),
}


@needs_native
@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_native_bindings_equal_the_jax_package(case):
    nb, top, llens, rlens = NATIVE_CASES[case]
    rng = np.random.default_rng(len(case))
    lk, lofs = _runs(rng, nb, top, llens)
    rk, rofs = _runs(rng, nb, top, rlens)
    if case == "no_matches":
        rk = rk + top  # disjoint key ranges
    rvals = rng.normal(size=(3, len(rk)))
    for a, b in zip(tnative.merge_join_sorted(lk, lofs, rk, rofs), jnative.merge_join_sorted(lk, lofs, rk, rofs)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tnative.merge_join_accumulate(lk, lofs, rk, rofs, rvals),
                    jnative.merge_join_accumulate(lk, lofs, rk, rofs, rvals)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.int64), b.view(np.int64))
    bucket = rng.integers(0, nb, len(lk) + 50).astype(np.int32)
    for a, b in zip(tnative.bucket_perm(bucket, nb), jnative.bucket_perm(bucket, nb)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if case == "no_matches":
        assert len(tnative.merge_join_sorted(lk, lofs, rk, rofs)[0]) == 0


def test_native_bindings_return_none_when_turned_off(monkeypatch):
    monkeypatch.setenv(tnative.DISABLE_ENV, "1")
    z = np.zeros(0, np.int32)
    o = np.zeros(1, np.int64)
    assert tnative.bucket_perm(z, 1) is None
    assert tnative.merge_join_sorted(z, o, z, o) is None
    assert tnative.merge_join_accumulate(z, o, z, o, np.zeros((0, 0))) is None


# -- tests/test_join_venue.py through both packages ----------------------------------


def _write(tmp_path, name, table):
    (tmp_path / name).mkdir()
    pq.write_table(table, tmp_path / name / "p.parquet")
    return tmp_path / name


def _session(pkg, path, buckets, **kw):
    if pkg is htorch:
        kw.setdefault("device", "cpu")
    return pkg.HyperspaceSession(system_path=str(path), num_buckets=buckets, **kw)


@pytest.fixture
def joined(tmp_path):
    """tests/test_join_venue.py's fact / dim pair, indexed by each package."""
    rng = np.random.default_rng(0)
    f = pd.DataFrame({"k": rng.integers(0, 500, 20_000).astype(np.int64), "a": rng.normal(size=20_000)})
    d = pd.DataFrame({"k": np.arange(400, dtype=np.int64), "b": rng.normal(size=400)})
    _write(tmp_path, "f", pa.Table.from_pandas(f, preserve_index=False))
    _write(tmp_path, "d", pa.Table.from_pandas(d, preserve_index=False))
    out = {}
    for pkg in (hjax, htorch):
        session = _session(pkg, tmp_path / f"idx_{pkg.__name__}", 8)
        hs = pkg.Hyperspace(session)
        fs, ds = session.parquet(tmp_path / "f"), session.parquet(tmp_path / "d")
        hs.create_index(fs, pkg.IndexConfig("fk", ["k"], ["a"]))
        hs.create_index(ds, pkg.IndexConfig("dk", ["k"], ["b"]))
        session.enable_hyperspace()
        out[pkg] = (session, fs, ds)
    return out, f, d


def _frame(session, plan, by):
    return session.to_pandas(plan).sort_values(by).reset_index(drop=True)


@needs_native
def test_host_venue_matches_device_venue(joined):
    sessions, f, d = joined
    got = {}
    for pkg, (session, fs, ds) in sessions.items():
        for venue in ("device", "host"):
            session.conf.set("hyperspace.join.venue", venue)
            got[pkg, venue] = _frame(session, fs.join(ds, ["k"]), ["k", "a"])
            stats = session.last_query_stats
            assert stats["join_path"] == "zero-exchange-aligned"
            if venue == "host":
                assert stats["join_kernel"] == "host-native-merge"
    assert session.last_query_stats["join_kernel"] == "host-native-merge"
    pd.testing.assert_frame_equal(got[htorch, "host"], got[hjax, "host"])
    pd.testing.assert_frame_equal(got[htorch, "host"], got[htorch, "device"])
    exp = f.merge(d, on="k").sort_values(["k", "a"]).reset_index(drop=True)
    np.testing.assert_array_equal(got[htorch, "host"]["b"], exp["b"])


@needs_native
@pytest.mark.parametrize("case", ["null_keys", "multi_key_strings"])
def test_host_venue_join_shapes(tmp_path, case):
    """Null keys never join; a two-column key with a string joins as
    pandas does; the port's host venue gives the JAX package's rows."""
    if case == "null_keys":
        left = pa.table({"k": pa.array([1, None, 2, None, 3], type=pa.int64()), "a": np.arange(5, dtype=np.float64)})
        right = pa.table({"k": pa.array([1, 2, None], type=pa.int64()), "b": np.arange(3, dtype=np.float64)})
        keys, buckets = ["k"], 2
    else:
        rng = np.random.default_rng(2)
        n = 3000
        left = pa.table({"g": rng.choice(["x", "y", "z"], n), "k": rng.integers(0, 50, n).astype(np.int64),
                         "a": rng.normal(size=n)})
        right = pa.table({"g": np.repeat(["x", "y", "z"], 50), "k": np.tile(np.arange(50, dtype=np.int64), 3),
                          "b": rng.normal(size=150)})
        keys, buckets = ["g", "k"], 4
    _write(tmp_path, "l", left)
    _write(tmp_path, "r", right)
    got = {}
    for pkg in (hjax, htorch):
        session = _session(pkg, tmp_path / f"idx_{pkg.__name__}", buckets)
        session.conf.set("hyperspace.join.venue", "host")
        ls, rs = session.parquet(tmp_path / "l"), session.parquet(tmp_path / "r")
        got[pkg] = _frame(session, ls.join(rs, keys), [*keys, "a"])
    pd.testing.assert_frame_equal(got[htorch], got[hjax])
    # SQL: NULL = NULL is not true (pandas would match NaN keys).
    exp = left.to_pandas().dropna(subset=keys).merge(right.to_pandas().dropna(subset=keys), on=keys)
    assert len(got[htorch]) == len(exp)
    if case == "null_keys":
        assert sorted(got[htorch]["k"]) == [1, 2]  # SQL: NULL = NULL is not true


def test_unknown_venue_raises_as_in_the_jax_package(joined):
    sessions, _, _ = joined
    msgs = []
    for pkg, (session, fs, ds) in sessions.items():
        session.conf.set("hyperspace.join.venue", "hsot")
        with pytest.raises(Exception, match="join.venue") as e:
            session.run(fs.join(ds, ["k"]))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "unknown hyperspace.join.venue='hsot' (auto|device|host)"


@needs_native
def test_forced_host_venue_wins_over_the_mesh(tmp_path, joined):
    """A forced host join venue beats the port's CPU mesh (auto would keep
    the sharded device merge), as it beats the JAX package's mesh."""
    from hyperspace_tpu_torch.parallel.mesh import make_mesh

    sessions, f, d = joined
    _, fs, ds = sessions[htorch]
    session = htorch.HyperspaceSession(system_path=str(tmp_path / "idx_hyperspace_tpu_torch"), num_buckets=8,
                                       mesh=make_mesh([CPU] * 4))
    session.enable_hyperspace()
    fs, ds = session.parquet(tmp_path / "f"), session.parquet(tmp_path / "d")
    session.run(fs.join(ds, ["k"]))
    assert session.last_query_stats["join_kernel"] == "device-searchsorted"
    assert session.last_query_stats["join_devices"] == 4
    session.conf.set("hyperspace.join.venue", "host")
    got = session.to_pandas(fs.join(ds, ["k"]))
    assert session.last_query_stats["join_kernel"] == "host-native-merge"
    assert len(got) == len(f.merge(d, on="k"))


@needs_native
@pytest.mark.parametrize("venue", ["device", "host"])
def test_filtered_sides_keep_zero_exchange_join(joined, venue):
    sessions, f, d = joined
    got = {}
    for pkg, (session, fs, ds) in sessions.items():
        for key in VENUE_KEYS:
            session.conf.set(key, venue)
        col, lit = pkg.col, pkg.lit
        q = fs.filter(col("a") > lit(0.0)).join(ds.filter(col("b") < lit(0.5)), ["k"])
        got[pkg] = _frame(session, q, ["k", "a"])
        assert session.last_query_stats["join_path"] == "zero-exchange-aligned"
    pd.testing.assert_frame_equal(got[htorch], got[hjax])
    exp = f[f.a > 0.0].merge(d[d.b < 0.5], on="k")
    assert len(got[htorch]) == len(exp)


def test_env_venue_override_precedence(joined, monkeypatch):
    """HYPERSPACE_VENUE overrides auto decisions; an explicit setting still
    wins; a bad value raises; end to end, a forced device on an auto
    session."""
    monkeypatch.setenv("HYPERSPACE_VENUE", "device")
    assert tbw.pick_venue("auto", "x", needs_native=False) == "device"
    assert tbw.pick_venue("host", "x", needs_native=False) == "host"
    monkeypatch.setenv("HYPERSPACE_VENUE", "hOst")
    with pytest.raises(HyperspaceError, match="HYPERSPACE_VENUE"):
        tbw.pick_venue("auto", "x", needs_native=False)
    sessions, _, _ = joined
    session, fs, ds = sessions[htorch]
    monkeypatch.setenv("HYPERSPACE_VENUE", "device")
    session.to_pandas(fs.join(ds, ["k"]))
    assert session.last_query_stats["join_kernel"] == "device-searchsorted"
    if jnative.available():
        monkeypatch.setenv("HYPERSPACE_VENUE", "host")
        session.to_pandas(fs.join(ds, ["k"]))
        assert session.last_query_stats["join_kernel"] == "host-native-merge"
        session.conf.set("hyperspace.join.venue", "device")  # the explicit setting wins
        session.to_pandas(fs.join(ds, ["k"]))
        assert session.last_query_stats["join_kernel"] == "device-searchsorted"


def test_forced_host_without_the_library_raises(joined, monkeypatch):
    """No silent retreat: a forced host join or build venue with the
    library turned off raises, as the JAX package's pick_venue does."""
    sessions, _, _ = joined
    session, fs, ds = sessions[htorch]
    monkeypatch.setenv(tnative.DISABLE_ENV, "1")
    session.conf.set("hyperspace.join.venue", "host")
    with pytest.raises(HyperspaceError, match="hyperspace.join.venue=host requires the native library"):
        session.run(fs.join(ds, ["k"]))
    monkeypatch.setenv("HYPERSPACE_VENUE", "host")
    session.conf.set("hyperspace.join.venue", "auto")
    with pytest.raises(HyperspaceError, match="HYPERSPACE_VENUE=host requires the native library"):
        session.run(fs.join(ds, ["k"]))


@needs_native
@pytest.mark.parametrize("streaming", [False, True])
def test_build_venue_host_produces_identical_index(tmp_path, streaming):
    """tests/test_join_venue.py's build case across both packages: the
    host venue's bucket files and manifest equal the device venue's and
    the JAX package's host build's, byte for byte (null / string /
    float32 / int64 keys); streaming, too (the phase-2 host sort)."""
    rng = np.random.default_rng(0)
    n = 20_000
    df = pd.DataFrame({
        "k": rng.integers(0, 5_000, n).astype(np.int64),
        "s": rng.choice(["aa", "bb", None, "cc"], n),
        "v": rng.normal(size=n).astype(np.float32),
        "d": rng.normal(size=n),
    })
    _write(tmp_path, "src", pa.Table.from_pandas(df, preserve_index=False))
    dirs = {}
    for pkg, venue in ((hjax, "host"), (htorch, "host"), (htorch, "device")):
        label = f"{pkg.__name__}_{venue}"
        session = _session(pkg, tmp_path / f"idx_{label}", 8)
        session.conf.set("hyperspace.build.venue", venue)
        if streaming:
            session.conf.set("hyperspace.index.build.memoryBudgetBytes", 1 << 16)
            session.conf.set("hyperspace.index.build.chunkBytes", 1 << 18)
        pkg.Hyperspace(session).create_index(session.parquet(tmp_path / "src"), pkg.IndexConfig("ix", ["k", "s"],
                                                                                                 ["v", "d"]))
        if pkg is htorch:
            stats = session.last_build_stats
            assert stats["path"] == ("streaming" if streaming else "in-memory")
            assert stats["sort_venue"] == venue and (venue == "device" or stats["sort_device"] == "cpu")
        dirs[label] = tmp_path / f"idx_{label}" / "ix" / "v__=0"
    ref = dirs["hyperspace_tpu_host"]
    for label in ("hyperspace_tpu_torch_host", "hyperspace_tpu_torch_device"):
        for b in range(8):
            name = f"bucket-{b:05d}.parquet"
            assert (dirs[label] / name).read_bytes() == (ref / name).read_bytes(), (label, name)
        assert json.loads((dirs[label] / "_index_manifest.json").read_text()) == json.loads(
            (ref / "_index_manifest.json").read_text())


# -- tests/test_device_staging.py's queries through both packages ----------------------


@pytest.fixture
def staged(tmp_path):
    """tests/test_device_staging.py's dataset: null-free ints, a nullable
    int column, dictionary strings, integral floats; indexed by each
    package."""
    n = 4_000
    rng = np.random.default_rng(7)
    fact = pa.table({
        "k": rng.integers(0, 200, n).astype(np.int32),
        "q": rng.integers(0, 1000, n).astype(np.float64),
        "n": pa.array([None if i % 7 == 0 else int(i % 97) for i in range(n)], type=pa.int64()),
        "s": pa.array([f"cat_{i % 13:02d}" for i in range(n)]),
    })
    dim = pa.table({
        "k": np.arange(180, dtype=np.int32),
        "w": rng.integers(0, 50, 180).astype(np.float64),
        "t": pa.array([f"tag_{i % 5}" for i in range(180)]),
    })
    _write(tmp_path, "fact", fact)
    _write(tmp_path, "dim", dim)
    _write(tmp_path, "unindexed", pa.table({"k": np.arange(0, 200, 2, dtype=np.int32),
                                           "u": np.arange(100, dtype=np.int64) % 7}))
    out = {}
    for pkg in (hjax, htorch):
        session = _session(pkg, tmp_path / f"idx_{pkg.__name__}", 8)
        hs = pkg.Hyperspace(session)
        fs, ds = session.parquet(tmp_path / "fact"), session.parquet(tmp_path / "dim")
        hs.create_index(fs, pkg.IndexConfig("pf_k", ["k"], ["q", "n", "s"]))
        hs.create_index(ds, pkg.IndexConfig("pd_k", ["k"], ["w", "t"]))
        session.enable_hyperspace()
        out[pkg] = (session, fs, ds, session.parquet(tmp_path / "unindexed"))
    return out


def _queries(pkg, fs, ds, us):
    """tests/test_device_staging.py's `_queries`, plus extrema and a mean
    over the join, a count-distinct, a rollup, ORDER BY and a forced
    exchange of the unindexed `us`."""
    col, lit, agg = pkg.col, pkg.lit, pkg.AggSpec.of
    return {
        "filter": fs.filter(((col("k") % 3) == 0) & (col("q") > 500.0)),
        "filter_null": fs.filter(col("n") > lit(40)),
        "group_agg": fs.aggregate(["s"], [agg("sum", "q", "sq"), agg("count", None, "cnt"), agg("min", "q", "mn"),
                                          agg("max", "n", "mx")]),
        "join": fs.join(ds, ["k"]),
        "join_agg": fs.join(ds, ["k"]).aggregate(["s"], [agg("sum", "w", "sw"), agg("count", None, "cnt")]),
        "join_agg_extrema": fs.join(ds, ["k"]).aggregate(["s"], [agg("min", "w", "mw"), agg("max", "q", "mq"),
                                                                 agg("mean", "w", "aw")]),
        "zero_row": fs.filter(col("q") > 1e9),
        "zero_row_agg": fs.filter(col("q") > 1e9).aggregate(["s"], [agg("sum", "q", "sq")]),
        "count_distinct": fs.aggregate(["s"], [agg("count_distinct", "k", "dk"), agg("mean", "q", "aq")]),
        "rollup": fs.rollup(["s", "k"], [agg("sum", "q", "sq"), agg("max", "n", "mx")]),
        "order_by": fs.filter(col("k") < 40).sort([("q", False), ("k", True)]),
        "exchange": fs.select("k", "q").join(us, ["k"]).aggregate(
            ["u"], [agg("sum", "q", "sq"), agg("count", None, "cnt"), agg("max", "q", "mq")]),
    }


ORDERED = ("order_by",)


def _canon(table, ordered: bool):
    dec = {k: np.asarray(v) for k, v in table.decode().items()}
    if ordered or not dec or table.num_rows == 0:
        return dec
    names = sorted(dec)
    keys = [dec[n].astype("U32") if dec[n].dtype == object else dec[n] for n in reversed(names)]
    order = np.lexsort(tuple(np.nan_to_num(k.astype(np.float64), nan=-1e300) if k.dtype.kind == "f" else k
                             for k in keys))
    return {k: v[order] for k, v in dec.items()}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(f"i{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def _run(session, plan, venue, rebucketize="auto"):
    for key in VENUE_KEYS:
        session.conf.set(key, venue)
    session.conf.set("hyperspace.join.rebucketize", rebucketize)
    try:
        return session.run(plan), dict(session.last_query_stats), session.last_physical_plan
    finally:
        session.conf.set("hyperspace.join.rebucketize", "auto")


def _ops(node) -> list:
    """Pre-order (op, kernel, venue) of a physical plan."""
    out = [(node.op, node.detail.get("kernel"), node.detail.get("venue"))]
    for c in node.children:
        out.extend(_ops(c))
    return out


@needs_native
@pytest.mark.parametrize("qname", [
    "filter", "filter_null", "group_agg", "join", "join_agg", "join_agg_extrema", "zero_row", "zero_row_agg",
    "count_distinct", "rollup", "order_by", "exchange",
])
def test_host_venue_byte_identical_to_the_jax_package(staged, qname):
    """Every venue host: the port's answer equals the JAX package's host
    venue bit for bit, and the port's device venue exactly (every sum
    here is integral); the stats and the host operators' physical names
    are the JAX package's."""
    rebucketize = "force" if qname == "exchange" else "auto"
    j_session, *j_tables = staged[hjax]
    t_session, *t_tables = staged[htorch]
    want, jstats, jphys = _run(j_session, _queries(hjax, *j_tables)[qname], "host", rebucketize)
    got, tstats, tphys = _run(t_session, _queries(htorch, *t_tables)[qname], "host", rebucketize)
    dev, dstats, _ = _run(t_session, _queries(htorch, *t_tables)[qname], "device", rebucketize)
    ordered = qname in ORDERED
    w, g, d = _canon(want, ordered), _canon(got, ordered), _canon(dev, ordered)
    assert sorted(g) == sorted(w) and sorted(d) == sorted(w)
    for name in w:
        assert g[name].dtype == w[name].dtype and np.array_equal(_bits(g[name]), _bits(w[name])), name
        assert np.array_equal(_bits(d[name]), _bits(g[name])), name
    for key in ("join_kernel", "exchange_kernel", "join_path"):
        assert tstats[key] == jstats.get(key), key
    if str(tstats["agg_path"]).startswith("segment-reduce"):
        # The port names a multi-stage aggregate by its branch; a plain one
        # by the JAX package's name.
        assert tstats["agg_path"] == jstats["agg_path"] == "segment-reduce-host"
        assert dstats["agg_path"] == "segment-reduce-cpu"
    # The host operators (the JAX package's broadcast probe is always on
    # the host, the port's on the device: not a venue).
    host_ops = [t for t in _ops(jphys)
                if ("host" in str(t[1]) + str(t[2]) or t[0] == "HostSort") and t[1] != "host-broadcast-hash"]
    assert host_ops and [t for t in _ops(tphys) if t in host_ops] == host_ops


def test_auto_resolves_to_the_device_on_the_cpu(staged, monkeypatch):
    """On a CPU session, auto runs the device venue: the torch ops and the
    kernels' plain versions."""
    monkeypatch.delenv("HYPERSPACE_VENUE", raising=False)
    session, *tables = staged[htorch]
    for qname, plan in _queries(htorch, *tables).items():
        _, stats, phys = _run(session, plan, "auto")
        names = [stats[k] for k in ("agg_path", "join_kernel", "exchange_kernel", "mask_kernel", "sort_op")]
        assert not any("host" in str(n).lower() for n in names), (qname, names)
        assert not any("host" in str(t).lower() or t[0] == "HostSort" for t in _ops(phys)), qname


def test_fused_kernels_off_raises_a_typed_error(staged):
    """The port's device venue is its kernels: `off` has no path to select
    and raises at `set`, leaving `auto` in place. The JAX package accepts
    it (its lax path)."""
    session, fs, *_ = staged[htorch]
    with pytest.raises(HyperspaceError, match="no un-fused path"):
        session.conf.set("hyperspace.device.fusedKernels", "off")
    assert session.conf.get("hyperspace.device.fusedKernels") == "auto"
    with pytest.raises(HyperspaceError, match="unknown hyperspace.device.fusedKernels"):
        session.conf.set("hyperspace.device.fusedKernels", "bogus")
    session.conf.set("hyperspace.device.fusedKernels", "auto")
    assert session.conf.get("hyperspace.device.fusedKernels") == "auto"
    assert session.run(fs.aggregate(["s"], [htorch.AggSpec.of("sum", "q", "sq")])).num_rows == 13
    j_session = staged[hjax][0]
    j_session.conf.set("hyperspace.device.fusedKernels", "off")
    assert j_session.conf.get("hyperspace.device.fusedKernels") == "off"


def test_every_key_is_ported_with_the_jax_package_defaults():
    from hyperspace_tpu.config import KNOWN_KEYS, HyperspaceConf as JConf
    from hyperspace_tpu_torch.config import KNOWN_KEYS as TKEYS, PORTED_KEYS, HyperspaceConf as TConf

    assert list(TKEYS) == list(KNOWN_KEYS) and set(PORTED_KEYS) == set(KNOWN_KEYS)
    port, ref = TConf(), JConf()
    for key in KNOWN_KEYS:
        assert TKEYS[key].default == KNOWN_KEYS[key].default, key
        assert port.get(key) == ref.get(key), key


def _mask_queries(pkg, fs, ds):
    """One query a place where a predicate mask is evaluated outside a
    filter: a boolean projection, a numeric and a string CASE projection,
    a CASE aggregate input (plain and through a join) and a CASE window
    input."""
    col, when, agg = pkg.col, pkg.when, pkg.AggSpec.of
    case_q = when(col("q") > 500.0, col("q")).otherwise(0.0)
    return {
        "bool_projection": fs.select("k", ("big", col("n") > 40)),
        "case_projection": fs.select("k", ("c", case_q)),
        "string_case_projection": fs.select("k", ("t", when(col("q") > 500.0, col("s")).otherwise("low"))),
        "case_aggregate": fs.aggregate(["s"], [agg("sum", case_q, "hi")]),
        "case_join_aggregate": fs.join(ds, ["k"]).aggregate(["s"], [agg("sum", case_q, "hi")]),
        "case_window": fs.window(["s"], order_by=[("k", True), ("q", True)], funcs=[("sum", case_q, "rs")]),
    }


@pytest.mark.parametrize("qname", ["bool_projection", "case_projection", "string_case_projection",
                                   "case_aggregate", "case_join_aggregate", "case_window"])
def test_masks_outside_a_filter_follow_the_filter_venue(staged, monkeypatch, qname):
    """The masks of projections, CASE aggregate inputs and window inputs
    run on the session's `hyperspace.filter.venue`: none on the host under
    `device` (or `auto`), every one under `host`, with equal answers, and
    equal to the JAX package's."""
    from hyperspace_tpu_torch.ops import filter as tfilter

    monkeypatch.delenv("HYPERSPACE_VENUE", raising=False)
    calls = []
    host_mask = tfilter._host_mask
    monkeypatch.setattr(tfilter, "_host_mask", lambda *a: calls.append(1) or host_mask(*a))
    session, fs, ds, _ = staged[htorch]
    plan = _mask_queries(htorch, fs, ds)[qname]
    got = {}
    for venue in ("host", "auto", "device"):  # host first: a memoized CASE input serves repeats
        session.conf.set("hyperspace.filter.venue", venue)
        try:
            del calls[:]
            got[venue] = _canon(session.run(plan), False)
        finally:
            session.conf.set("hyperspace.filter.venue", "auto")
        assert bool(calls) == (venue == "host"), venue
    j_session, j_fs, j_ds, _ = staged[hjax]
    want = _canon(j_session.run(_mask_queries(hjax, j_fs, j_ds)[qname]), False)
    for venue, g in got.items():
        assert sorted(g) == sorted(want), venue
        for name in want:
            assert np.array_equal(_bits(g[name]), _bits(want[name])), (venue, name)


@pytest.mark.parametrize("off", ["bucket_perm", "sort_range"])
def test_the_host_build_raises_where_the_library_refuses(tmp_path, monkeypatch, off):
    """No silent retreat inside the host build: a counting sort that
    returns None or a key sort that returns False (the library turned off
    after the venue was picked) raises, and writes no unsorted index."""
    rng = np.random.default_rng(3)
    _write(tmp_path, "src", pa.table({"k": rng.integers(0, 50, 500).astype(np.int64),
                                      "v": rng.normal(size=500)}))
    session = _session(htorch, tmp_path / "idx", 4)
    session.conf.set("hyperspace.build.venue", "host")
    monkeypatch.setattr(tnative, "available", lambda: True)
    monkeypatch.setattr(tnative, off, lambda *a: None if off == "bucket_perm" else False)
    with pytest.raises(HyperspaceError, match="host build venue's .* needs the native library"):
        htorch.Hyperspace(session).create_index(session.parquet(tmp_path / "src"),
                                                htorch.IndexConfig("ik", ["k"], ["v"]))
    assert not list((tmp_path / "idx").rglob("*.parquet"))
