"""The port's device mesh on the CPU, against the JAX package's 8-device mesh.

The JAX package's tests run on eight virtual CPU devices
(tests/conftest.py); the port's counterpart is a mesh of eight virtual
shards on the CPU, `make_mesh([torch.device("cpu")] * 8)`, and the (2, 4)
multi-slice mesh over the same eight. The same seeded numpy inputs go
through both packages:

- the mesh shapes `mesh_for_parallelism` and `make_multislice_mesh` give,
  and their errors;
- the build's exchange (`bucketize_perm`, `bucketize`): equal element for
  element, with an int64 and a string key lane, pads past `n`, a source
  shard holding only pads and a destination shard that receives nothing;
- the index build over both meshes: bucket files byte-identical to the
  JAX package's mesh build and to the port's one-device build, each
  package querying the other's index;
- `merge_join_sharded`: pairs equal to the JAX package's and to
  `merge_join`, element for element, also where B % D != 0;
- the sharded aggregate (tests/test_aggregate.py:552-578): integral sums,
  counts and extrema exact; float sums and means within 2·n·u·Σ|v| of
  the JAX package's, each package's partials added in another order;
- `distributed_top_n_candidates`: equal indices and equal `None` cases,
  and the top-N query naming `mesh-sharded-select` with the JAX
  package's rows (tests/test_device_ops.py:293-332);
- the join on the mesh end to end (tests/test_device_ops.py:240-290);
- the sharded predicate mask, equal to the JAX package's bit for bit,
  sharded where n_pad % D == 0 and whole where not;
- the errors: a CUDA mesh with no card, a mixed-type mesh, a session
  whose device is not its mesh's.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu.parallel import mesh as jmesh
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.parallel import mesh as pmesh

CPU = torch.device("cpu")
BUCKETS = 16
U = 2.0**-53


def _meshes(kind: str):
    """(the JAX package's mesh, the port's) over eight devices."""
    if kind == "1d":
        return jmesh.make_mesh(), pmesh.make_mesh([CPU] * 8)
    return jmesh.make_multislice_mesh(2), pmesh.make_multislice_mesh(2, [CPU] * 8)


# -- mesh shapes ----------------------------------------------------------------


@pytest.mark.parametrize("case", [("units", 200), ("units", 12), ("units", 7), ("units", 1),
                                  ("slices", 2), ("slices", 3)])
def test_mesh_shapes_match_the_jax_package(case):
    kind, value = case
    if kind == "units":
        for jm, pm in (_meshes("1d"), _meshes("2x4")):
            got, want = pmesh.mesh_for_parallelism(pm, value), jmesh.mesh_for_parallelism(jm, value)
            assert got.shape == dict(want.shape)
            assert pmesh.mesh_axes(got) == jmesh.mesh_axes(want)
            assert pmesh.mesh_size(got) == jmesh.mesh_size(want)
            assert got.devices == pm.devices[: pmesh.mesh_size(got)]
        return
    if value == 3:
        with pytest.raises(ValueError) as jerr:
            jmesh.make_multislice_mesh(3)
        with pytest.raises(ValueError) as perr:
            pmesh.make_multislice_mesh(3, [CPU] * 8)
        assert str(perr.value) == str(jerr.value)
        return
    jm, pm = _meshes("2x4")
    assert pm.shape == dict(jm.shape) == {"dcn": 2, "x": 4}
    assert pmesh.mesh_axes(pm) == jmesh.mesh_axes(jm)


# -- the build's exchange ---------------------------------------------------------


def _exchange_inputs(key: str):
    """(lanes, bucket) padded to 1,144 rows (143 a shard: the last source
    shard holds only pads) of n = 1,000 real rows, in 16 buckets of which
    14 and 15 stay empty (the last destination receives nothing); keys
    repeat, so ties must keep their row order."""
    from hyperspace_tpu_torch.ops.sortkeys import value_lanes

    rng = np.random.default_rng(5)
    n, n_pad = 1000, 1144
    if key == "int64":
        pool = rng.integers(-(2**40), 2**40, 60)
        lanes = value_lanes(pool[rng.integers(0, 60, n)].astype(np.int64))
    else:
        words = np.array(sorted(f"w{i:03d}" for i in range(40)), dtype=object)
        lanes = [np.searchsorted(words, words[rng.integers(0, 40, n)]).astype(np.int32)]
    bucket = rng.integers(0, 14, n).astype(np.int32)
    pad = lambda a: np.concatenate([a, np.zeros(n_pad - n, a.dtype)])  # noqa: E731
    return [pad(l) for l in lanes], pad(bucket), n


@pytest.mark.parametrize("mesh", ["1d", "2x4"])
@pytest.mark.parametrize("key", ["int64", "string"])
def test_bucketize_perm_matches_the_jax_package(mesh, key):
    from hyperspace_tpu.ops.bucketize import bucketize_perm as jax_perm
    from hyperspace_tpu_torch.ops.bucketize import _one_device_perm, bucketize_perm

    lanes, bucket, n = _exchange_inputs(key)
    jm, pm = _meshes(mesh)
    j_order, j_rows = jax_perm(jm, lanes, bucket, n, BUCKETS)
    order, rows = bucketize_perm(pm, lanes, bucket, n, BUCKETS)
    assert np.array_equal(order, np.asarray(j_order, dtype=np.int64))
    assert np.array_equal(rows, np.asarray(j_rows))
    one_order, one_rows = _one_device_perm([l[:n] for l in lanes], bucket[:n], BUCKETS, CPU)
    assert np.array_equal(order, one_order) and np.array_equal(rows, one_rows)


@pytest.mark.parametrize("mesh", ["1d", "2x4"])
def test_bucketize_matches_the_jax_package(mesh):
    """Each shard's owned rows, sorted by (bucket, key), equal the valid
    rows of the JAX package's shard; the port pads every shard to the
    longest under the sentinel bucket."""
    import jax.numpy as jnp

    from hyperspace_tpu.ops.bucketize import bucketize as jax_bucketize
    from hyperspace_tpu_torch.ops.bucketize import SENTINEL_BUCKET, bucketize

    lanes, bucket, n = _exchange_inputs("string")
    payload = np.arange(len(bucket), dtype=np.int32) * 3
    valid = (np.arange(len(bucket)) < n).astype(np.int32)
    cols = [lanes[0], payload]
    jm, pm = _meshes(mesh)
    j_cols, j_bucket, j_valid = jax_bucketize(
        jm, [jnp.asarray(c) for c in cols], jnp.asarray(bucket), jnp.asarray(valid), BUCKETS, num_key_cols=1
    )
    j_cols = [np.asarray(c) for c in j_cols]
    j_bucket, j_valid = np.asarray(j_bucket), np.asarray(j_valid)
    p_cols, p_bucket, p_valid = bucketize(pm, cols, bucket, valid, BUCKETS, num_key_cols=1)
    seg = len(j_bucket) // 8
    received = 0
    for i in range(8):
        jv = j_valid[i * seg : (i + 1) * seg] > 0
        pv = p_valid[i].numpy() > 0
        assert pv.sum() == jv.sum()
        assert np.array_equal(p_bucket[i].numpy()[pv], j_bucket[i * seg : (i + 1) * seg][jv])
        assert (p_bucket[i].numpy()[~pv] == SENTINEL_BUCKET).all()
        for pc, jc in zip(p_cols, j_cols):
            assert np.array_equal(pc[i].numpy()[pv], jc[i * seg : (i + 1) * seg][jv])
        received += int(pv.sum())
    assert received == n and p_valid[7].sum() == 0


# -- the index build over the mesh -------------------------------------------------


@pytest.fixture(scope="module")
def mesh_indexes(tmp_path_factory):
    """One source (3,000 rows: repeated int64 keys, a nullable string, a
    float) indexed by the JAX package over each mesh and by the port over
    each mesh and on one device, 16 buckets."""
    tmp = tmp_path_factory.mktemp("mesh_build")
    rng = np.random.default_rng(11)
    n = 3000
    src = tmp / "src"
    src.mkdir()
    t = pa.table({
        "k": rng.integers(-500, 500, n).astype(np.int64),
        "s": pa.array([f"s{i % 13}" for i in rng.integers(0, 13, n)], mask=rng.random(n) < 0.1),
        "v": rng.standard_normal(n),
    })
    pq.write_table(t.slice(0, 1700), src / "part-0.parquet")
    pq.write_table(t.slice(1700), src / "part-1.parquet")
    out = {"src": src, "tmp": tmp}
    for kind in ("1d", "2x4"):
        jm, pm = _meshes(kind)
        for label, pkg, kw in (("jax", hjax, {"mesh": jm}), ("torch", htorch, {"mesh": pm, "device": "cpu"})):
            s = pkg.HyperspaceSession(system_path=str(tmp / f"{label}_{kind}"), num_buckets=BUCKETS, **kw)
            pkg.Hyperspace(s).create_index(s.parquet(src), pkg.IndexConfig("idx", ["k"], ["s", "v"]))
            out[label, kind] = s
    one = htorch.HyperspaceSession(system_path=str(tmp / "torch_one"), num_buckets=BUCKETS, device="cpu")
    htorch.Hyperspace(one).create_index(one.parquet(src), htorch.IndexConfig("idx", ["k"], ["s", "v"]))
    out["torch", "one"] = one
    return out


@pytest.mark.parametrize("kind", ["1d", "2x4"])
def test_mesh_index_build_matches_the_jax_package(mesh_indexes, kind):
    tmp = mesh_indexes["tmp"]
    assert mesh_indexes["torch", kind].last_build_stats["mesh_devices"] == 8
    assert mesh_indexes["torch", "one"].last_build_stats["mesh_devices"] == 1
    ref = tmp / f"jax_{kind}" / "idx" / "v__=0"
    names = sorted(p.name for p in ref.iterdir())
    assert sum(n.startswith("bucket-") for n in names) == BUCKETS
    for other in (f"torch_{kind}", "torch_one"):
        got = tmp / other / "idx" / "v__=0"
        assert sorted(p.name for p in got.iterdir()) == names
        for name in names:
            assert (got / name).read_bytes() == (ref / name).read_bytes(), f"{other}/{name}"
    # Each package queries the other's index: a lookup and an aggregate.
    for reader, maker in (("jax", "torch"), ("torch", "jax")):
        pkg = hjax if reader == "jax" else htorch
        kw = {"mesh": _meshes(kind)[0]} if reader == "jax" else {"mesh": _meshes(kind)[1], "device": "cpu"}
        s = pkg.HyperspaceSession(system_path=str(tmp / f"{maker}_{kind}"), num_buckets=BUCKETS, **kw)
        s.enable_hyperspace()
        df = s.parquet(mesh_indexes["src"])
        got = s.to_pandas(df.filter(pkg.col("k") == 7).select("k", "s", "v")).sort_values("v")
        assert s.last_query_stats["files_pruned"] == BUCKETS - 1
        own = mesh_indexes[maker, kind]
        own.enable_hyperspace()
        want = own.to_pandas(own.parquet(mesh_indexes["src"]).filter(
            (hjax if maker == "jax" else htorch).col("k") == 7).select("k", "s", "v")).sort_values("v")
        pd.testing.assert_frame_equal(got.reset_index(drop=True), want.reset_index(drop=True))


# -- merge_join_sharded -----------------------------------------------------------


@pytest.mark.parametrize("case", [("1d", 16), ("2x4", 16), ("1d", 12)])
def test_merge_join_sharded_matches_the_jax_package(case):
    """Pairs element for element; B = 12 over 8 shards falls back to
    merge_join in both packages."""
    from hyperspace_tpu.ops import join as jjoin
    from hyperspace_tpu_torch.ops import join as pjoin

    kind, b = case
    jm, pm = _meshes(kind)
    rng = np.random.default_rng(7)
    s = np.iinfo(np.int32).max
    lk = np.full((b, 64), s, np.int32)
    rk = np.full((b, 96), s, np.int32)
    for i in range(b):
        nl, nr = rng.integers(1, 64), rng.integers(0, 64)
        lk[i, :nl] = np.sort(rng.integers(0, 40, nl))
        rk[i, :nr] = np.sort(rng.integers(0, 40, nr))
    jli, jri, jt = jjoin.merge_join_sharded(lk, rk, jm)
    li, ri, totals = pjoin.merge_join_sharded(torch.from_numpy(lk), torch.from_numpy(rk), pm)
    assert np.array_equal(totals.numpy(), np.asarray(jt))
    assert np.array_equal(li.numpy(), np.asarray(jli)) and np.array_equal(ri.numpy(), np.asarray(jri))
    oli, ori, ot = pjoin.merge_join(torch.from_numpy(lk), torch.from_numpy(rk))
    assert torch.equal(li, oli) and torch.equal(ri, ori) and torch.equal(totals, ot)


# -- the sharded aggregate ----------------------------------------------------------


@pytest.fixture(scope="module")
def sales(tmp_path_factory):
    """tests/test_aggregate.py's `sales` table (seed 21, 5,000 rows)."""
    rng = np.random.default_rng(21)
    n = 5_000
    nulls = rng.random(n) < 0.1
    root = tmp_path_factory.mktemp("mesh_sales") / "sales"
    root.mkdir()
    pq.write_table(pa.table({
        "store": pa.array([f"s{int(i) % 7}" for i in rng.integers(0, 7, n)]),
        "item": rng.integers(0, 50, n).astype(np.int64),
        "qty": pa.array(rng.integers(1, 20, n).astype(np.int64), mask=nulls),
        "price": rng.random(n) * 100,
    }), root / "part-0.parquet")
    return root


def test_sharded_aggregation_matches_the_jax_package(tmp_path, sales):
    """Item groups over 8 shards: qty sums (integral), counts, extrema
    exact; the mean of price within its sum's 2·n·u·Σ|price| over the
    count (each package adds its shards' partials in its own order)."""
    from hyperspace_tpu.config import AGG_VENUE

    outs = {}
    for label, pkg, kw in (("jax", hjax, {"mesh": jmesh.make_mesh()}),
                           ("torch", htorch, {"mesh": pmesh.make_mesh([CPU] * 8), "device": "cpu"}),
                           ("one", htorch, {"device": "cpu"})):
        s = pkg.HyperspaceSession(system_path=str(tmp_path / label), num_buckets=8, **kw)
        if label == "jax":
            s.conf.set(AGG_VENUE, "device")
        q = s.parquet(sales).aggregate(["item"], [
            pkg.AggSpec.of("sum", "qty", "s"), pkg.AggSpec.of("count", None, "n"),
            pkg.AggSpec.of("mean", "price", "m"), pkg.AggSpec.of("min", "price", "mn"),
            pkg.AggSpec.of("max", "qty", "mx"),
        ])
        outs[label] = s.to_pandas(q).sort_values("item").reset_index(drop=True)
        if label != "one":
            assert s.last_query_stats["agg_devices"] == 8
    src = pq.read_table(sales).to_pandas()
    tol = 2 * len(src) * U * src.groupby("item")["price"].apply(lambda v: v.abs().sum()).to_numpy()
    for other in ("jax", "one"):
        a, b = outs["torch"], outs[other]
        pd.testing.assert_frame_equal(a.drop(columns="m"), b.drop(columns="m"))
        assert (np.abs(a["m"] - b["m"]) <= tol / a["n"]).all()


# -- the mesh top-N ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["ties", "one-lane", "2x4", "one-shard", "n=0", "too-few-rows"])
def test_distributed_top_n_candidates_matches_the_jax_package(case):
    from hyperspace_tpu.ops.sortkeys import distributed_top_n_candidates as jax_cand
    from hyperspace_tpu_torch.ops.sortkeys import distributed_top_n_candidates

    rng = np.random.default_rng(41)
    rows, n = 3000, 25
    lanes = np.stack([rng.integers(0, 4, rows), rng.integers(0, 50, rows)]).astype(np.uint32)  # heavy ties
    jm, pm = _meshes("2x4" if case == "2x4" else "1d")
    if case == "one-lane":
        lanes = lanes[1:] * np.uint32(70_000_000)
    elif case == "one-shard":
        jm, pm = jmesh.make_mesh(n=1), pmesh.make_mesh([CPU])
    elif case == "n=0":
        n = 0
    elif case == "too-few-rows":
        lanes = lanes[:, : 2 * n * 8 - 1]
    want = jax_cand(lanes, n, jm)
    got = distributed_top_n_candidates(lanes, n, pm)
    if case in ("one-shard", "n=0", "too-few-rows"):
        assert want is None and got is None
        return
    assert got is not None and np.array_equal(got, np.asarray(want))
    assert len(got) >= n


def test_mesh_top_n_query_matches_the_jax_package(tmp_path):
    """ORDER BY v DESC, tag LIMIT 25 over heavy ties: the plan names
    mesh-sharded-select in both packages and the rows equal the
    one-device session's and pandas'."""
    from hyperspace_tpu.config import SORT_VENUE

    rng = np.random.default_rng(41)
    n = 20_000
    df = pd.DataFrame({"v": np.round(rng.normal(size=n), 2), "tag": rng.integers(0, 1000, n).astype(np.int64)})
    root = tmp_path / "topn"
    root.mkdir()
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), root / "p.parquet")
    outs = {}
    for label, pkg, kw in (("jax", hjax, {"mesh": jmesh.make_mesh()}),
                           ("torch", htorch, {"mesh": pmesh.make_mesh([CPU] * 8), "device": "cpu"}),
                           ("one", htorch, {"device": "cpu"})):
        s = pkg.HyperspaceSession(system_path=str(tmp_path / label), num_buckets=4, **kw)
        if label == "jax":
            s.conf.set(SORT_VENUE, "device")
        outs[label] = s.to_pandas(s.parquet(root).sort([("v", False), ("tag", True)]).limit(25))
        plan = repr(s.last_physical_plan)
        assert ("mesh-sharded-select" in plan) == (label != "one"), plan
        if label == "torch":
            assert s.last_query_stats["top_n"]["devices"] == 8
    want = df.sort_values(["v", "tag"], ascending=[False, True]).head(25).reset_index(drop=True)
    for label, got in outs.items():
        pd.testing.assert_frame_equal(got.reset_index(drop=True), want, check_dtype=False, obj=label)


# -- the join on the mesh -----------------------------------------------------------


def test_e2e_join_on_the_mesh_matches_the_jax_package(tmp_path):
    """The indexed join shards its 16 buckets over 8 shards
    (join_devices 8) and equals the un-indexed join and the JAX
    package's; the session reports its mesh."""
    from hyperspace_tpu.config import JOIN_VENUE
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    rng = np.random.default_rng(3)
    n = 4000
    (tmp_path / "fact").mkdir()
    (tmp_path / "dim").mkdir()
    pq.write_table(pa.table({"k": rng.integers(0, 200, n).astype(np.int64), "v": rng.standard_normal(n)}),
                   tmp_path / "fact" / "f.parquet")
    pq.write_table(pa.table({"k": np.arange(200, dtype=np.int64),
                             "label": pa.array([f"l{i % 5}" for i in range(200)])}), tmp_path / "dim" / "d.parquet")
    outs = {}
    for label, pkg, kw in (("jax", hjax, {"mesh": jmesh.make_mesh()}),
                           ("torch", htorch, {"mesh": pmesh.make_mesh([CPU] * 8), "device": "cpu"})):
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{label}"), num_buckets=16, **kw)
        if label == "jax":
            s.conf.set(JOIN_VENUE, "device")
        hs = pkg.Hyperspace(s)
        fact, dim = s.parquet(tmp_path / "fact"), s.parquet(tmp_path / "dim")
        hs.create_index(fact, pkg.IndexConfig("f_k", ["k"], ["v"]))
        hs.create_index(dim, pkg.IndexConfig("d_k", ["k"], ["label"]))
        q = fact.select("k", "v").join(dim.select("k", "label"), ["k"])
        s.disable_hyperspace()
        expected = s.to_pandas(q).sort_values(["k", "v"]).reset_index(drop=True)
        s.enable_hyperspace()
        k2 = run_bounds.launches
        got = s.to_pandas(q).sort_values(["k", "v"]).reset_index(drop=True)
        assert s.last_query_stats["join_path"] == "zero-exchange-aligned"
        assert s.last_query_stats["join_devices"] == 8
        if label == "torch":
            assert run_bounds.launches == k2  # the CPU runs K2's plain version
            assert s._venue_info()["mesh"] is True and s._venue_info()["device_count"] == 8
        pd.testing.assert_frame_equal(got, expected[got.columns.tolist()])
        outs[label] = got
    pd.testing.assert_frame_equal(outs["torch"], outs["jax"])


# -- the sharded mask -------------------------------------------------------------


@pytest.mark.parametrize("case", [("1d", 1000), ("2x4", 1000), ("1d", 5), ("3 shards", 1000)])
def test_sharded_filter_mask_matches_the_jax_package(case, monkeypatch):
    """A predicate over an int, a nullable float and a string column.
    n = 1,000 pads to 1,024, which 8 shards divide (7 masks of 128 rows and
    one of 104; 5 rows pad to 8, so 5 one-row shards mask); 3 shards do not divide 1,024 and the
    table is masked whole. Masks equal the JAX package's and the
    one-device mask."""
    from hyperspace_tpu.execution.table import ColumnTable as JTable
    from hyperspace_tpu.ops.filter import eval_predicate_mask as jax_mask
    from hyperspace_tpu_torch.execution.table import ColumnTable as PTable
    from hyperspace_tpu_torch.ops import filter as pfilter

    kind, n = case
    rng = np.random.default_rng(17)
    t = pa.table({
        "a": rng.integers(0, 100, n).astype(np.int64),
        "f": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.2),
        "s": pa.array([f"x{i}" for i in rng.integers(0, 9, n)]),
    })
    if kind == "3 shards":
        jm, pm = jmesh.make_mesh(n=3), pmesh.make_mesh([CPU] * 3)
    else:
        jm, pm = _meshes(kind)

    def pred(pkg):
        col, lit = pkg.col, pkg.lit
        return ((col("a") > lit(20)) & (col("f") < lit(0.5))) | (col("s") == lit("x3"))

    want = jax_mask(JTable.from_arrow(t), pred(hjax), mesh=jm, venue="device")
    calls = []
    real_mask = pfilter._mask
    monkeypatch.setattr(pfilter, "_mask", lambda table, p: calls.append(table.num_rows) or real_mask(table, p))
    table = PTable.from_arrow(t, device=CPU)
    got = pfilter.eval_predicate_mask(table, pred(htorch), mesh=pm)
    assert np.array_equal(got.numpy(), want)
    assert calls == ([128] * 7 + [104] if n == 1000 and kind != "3 shards" else [1] * 5 if n == 5 else [n])
    assert torch.equal(got, pfilter.eval_predicate_mask(table, pred(htorch)))


# -- errors -------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["cuda-no-card", "default-no-card", "mixed", "session-device"])
def test_mesh_errors(case, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if case == "cuda-no-card":
        with pytest.raises(HyperspaceError, match="no CUDA device"):
            pmesh.make_mesh([torch.device("cuda:0")] * 4)
    elif case == "default-no-card":
        with pytest.raises(HyperspaceError, match="no CUDA device"):
            pmesh.make_mesh()
    elif case == "mixed":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(HyperspaceError, match="mixes device types"):
            pmesh.make_mesh([CPU, torch.device("cuda:0")])
    else:
        with pytest.raises(HyperspaceError, match="no CUDA device"):
            htorch.HyperspaceSession(system_path=str(tmp_path), mesh=pmesh.make_mesh([CPU] * 4), device="cuda")
        s = htorch.HyperspaceSession(system_path=str(tmp_path), mesh=pmesh.make_mesh([CPU] * 4), device="cpu")
        assert s.device == CPU and s._venue_info() == {
            "mesh": True, "platform": "cpu", "device_kind": None, "device_count": 4}
