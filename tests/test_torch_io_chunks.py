"""Chunked IO, the footer cache and the query-tail prefetch, in both packages.

tests/test_io_chunks.py's ten cases (the row-group chunk planner and
reader, the footer cache's hits and mtime invalidation, the chunked cold
read against the per-file read, the prefetch issued once per file version
and turned off by its key), each run through the JAX package and the port
(`pkg` is "jax" or "torch") on the same seeded files, with the port's
results equal to the JAX package's.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu import stats as jstats
from hyperspace_tpu.execution import io as jio
from hyperspace_tpu.execution import prefetch as jprefetch
from hyperspace_tpu.obs import metrics as jmetrics
from hyperspace_tpu_torch import stats as tstats
from hyperspace_tpu_torch.execution import io as tio
from hyperspace_tpu_torch.execution import prefetch as tprefetch
from hyperspace_tpu_torch.obs import metrics as tmetrics


class _Pkg:
    def __init__(self, name):
        jax = name == "jax"
        self.name = name
        self.pkg = hjax if jax else htorch
        self.io = jio if jax else tio
        self.stats = jstats if jax else tstats
        self.prefetch = jprefetch if jax else tprefetch
        self.metrics = jmetrics if jax else tmetrics
        self.kw = {} if jax else {"device": "cpu"}

    def read_parquet(self, files):
        """name → numpy column of a multi-file read."""
        t = self.io.read_parquet(files, **self.kw)
        return {k: np.asarray(v) for k, v in t.columns.items()}

    def session(self, system_path, **kw):
        return self.pkg.HyperspaceSession(system_path=str(system_path), **self.kw, **kw)


PKGS = {n: _Pkg(n) for n in ("jax", "torch")}


@pytest.fixture(params=tuple(PKGS))
def P(request):
    return PKGS[request.param]


def _write(path, n, cols=("a", "b"), row_group_size=None):
    data = {}
    rng = np.random.default_rng(n + 1)
    for c in cols:
        data[c] = rng.integers(0, 1000, n).astype(np.int64)
    pq.write_table(pa.table(data), path, row_group_size=row_group_size or max(n, 1))
    return str(path)


class TestChunkPlanning:
    def test_empty_file_list(self, P):
        assert P.io.read_footers([]) == {}
        assert P.io.plan_row_group_chunks([], chunk_bytes=1024) == []
        assert P.io.estimate_uncompressed_bytes([]) == 0

    def test_single_row_group_larger_than_budget(self, P, tmp_path):
        """A row group above chunk_bytes still gets a chunk of its own."""
        f = _write(tmp_path / "big.parquet", 10_000)
        chunks = P.io.plan_row_group_chunks([f], chunk_bytes=16)
        assert chunks == [[(f, 0)]]
        assert P.io.read_chunk(chunks[0]).num_rows == 10_000

    def test_every_row_group_exactly_once(self, P, tmp_path):
        f1 = _write(tmp_path / "a.parquet", 8_000, row_group_size=1_000)
        f2 = _write(tmp_path / "b.parquet", 4_000, row_group_size=1_000)
        est = P.io.estimate_uncompressed_bytes([f1, f2])
        assert est == jio.estimate_uncompressed_bytes([f1, f2])
        chunks = P.io.plan_row_group_chunks([f1, f2], chunk_bytes=est // 6)
        assert chunks == jio.plan_row_group_chunks([f1, f2], chunk_bytes=est // 6)
        units = [u for c in chunks for u in c]
        assert len(units) == len(set(units)) == 12
        assert sum(P.io.read_chunk(c).num_rows for c in chunks) == 12_000

    def test_zero_row_file_contributes_nothing(self, P, tmp_path):
        fz = str(tmp_path / "zero.parquet")
        pq.write_table(pa.table({"a": pa.array([], type=pa.int64()), "b": pa.array([], type=pa.int64())}), fz)
        f = _write(tmp_path / "real.parquet", 500)
        chunks = P.io.plan_row_group_chunks([fz, f], chunk_bytes=1 << 20)
        assert sum(P.io.read_chunk(c).num_rows for c in chunks) == 500

    def test_column_missing_from_one_file_null_fills(self, P, tmp_path):
        f1 = _write(tmp_path / "full.parquet", 100, cols=("a", "b"))
        f2 = _write(tmp_path / "narrow.parquet", 50, cols=("a",))
        chunks = P.io.plan_row_group_chunks([f1, f2], chunk_bytes=1 << 30, columns=["a", "b"])
        assert len(chunks) == 1
        t = P.io.read_chunk(chunks[0], columns=["a", "b"])
        assert t.num_rows == 150
        assert t.column("b").null_count == 50
        assert t.equals(jio.read_chunk(chunks[0], columns=["a", "b"]))


class TestFooterCache:
    def test_hits_and_mtime_invalidation(self, P, tmp_path):
        f = _write(tmp_path / "x.parquet", 200)
        P.io.clear_footer_cache()
        h0, m0 = P.stats.get("io.footer_cache.hits"), P.stats.get("io.footer_cache.misses")
        P.io.read_footers([f])
        assert P.stats.get("io.footer_cache.misses") == m0 + 1
        md = P.io.read_footers([f])[f]
        assert P.stats.get("io.footer_cache.hits") == h0 + 1
        assert md.num_rows == 200
        # Rewritten: the stale entry must not serve.
        _write(tmp_path / "x.parquet", 300)
        os.utime(f, ns=(1, 1))  # a distinct mtime even on coarse clocks
        assert P.io.read_footers([f])[f].num_rows == 300
        assert P.stats.get("io.footer_cache.misses") == m0 + 2

    def test_consumers_share_one_parse(self, P, tmp_path):
        f = _write(tmp_path / "y.parquet", 400, row_group_size=100)
        P.io.clear_footer_cache()
        m0 = P.stats.get("io.footer_cache.misses")
        est = P.io.estimate_uncompressed_bytes([f])
        P.io.plan_row_group_chunks([f], chunk_bytes=est)
        P.io.read_footers([f])
        assert P.stats.get("io.footer_cache.misses") == m0 + 1


class TestChunkedColdRead:
    def test_matches_per_file_read(self, P, tmp_path, monkeypatch):
        """The row-group-parallel cold read returns what the per-file read
        returns (same rows, same order), and the JAX package's."""
        f1 = _write(tmp_path / "p1.parquet", 6_000, row_group_size=500)
        f2 = _write(tmp_path / "p2.parquet", 3_000, row_group_size=500)
        expected = P.read_parquet([f1, f2])  # below the threshold: per file
        monkeypatch.setattr(P.io, "_CHUNKED_READ_MIN_BYTES", 1)
        got = P.read_parquet([f1, f2])
        for name, want in expected.items():
            np.testing.assert_array_equal(got[name], want)
            np.testing.assert_array_equal(got[name], np.asarray(jio.read_parquet([f1, f2]).columns[name]))

    def test_file_rows_from_the_footers(self, tmp_path, monkeypatch):
        """The port's chunked read also answers `file_rows` (the hybrid
        scan's per-file row counts), from the footers."""
        f1 = _write(tmp_path / "p1.parquet", 6_000, row_group_size=500)
        f2 = _write(tmp_path / "p2.parquet", 3_000, row_group_size=500)
        monkeypatch.setattr(tio, "_CHUNKED_READ_MIN_BYTES", 1)
        table, rows = tio.read_parquet([f1, f2], device="cpu", file_rows=True)
        assert rows.tolist() == [6_000, 3_000] and table.num_rows == 9_000


class TestPrefetch:
    def _index(self, P, tmp_path, n, buckets, **conf):
        root = tmp_path / "src"
        root.mkdir()
        _write(root / "p0.parquet", n, cols=("k", "v"))
        session = P.session(tmp_path / "sys", num_buckets=buckets)
        for key, value in conf.items():
            session.conf.set(key, value)
        hs = P.pkg.Hyperspace(session)
        df = session.parquet(root)
        hs.create_index(df, P.pkg.IndexConfig("i1", ["k"], ["v"]))
        P.prefetch.reset()
        session.enable_hyperspace()
        return session, df

    def test_issues_once_per_file_version(self, P, tmp_path):
        session, df = self._index(P, tmp_path, 4_000, 4)
        issued = P.metrics.REGISTRY.get("io.prefetch.issued")
        base = issued.value
        q = df.filter(P.pkg.col("k") == 7).select("k", "v")
        session.run(q)
        P.prefetch.drain()
        first = issued.value - base
        assert first >= 1  # the pruned bucket file was prefetched
        session.run(q)
        P.prefetch.drain()
        assert issued.value - base == first  # unchanged files issue nothing

    def test_disabled_by_config(self, P, tmp_path):
        session, df = self._index(P, tmp_path, 2_000, 2, **{"hyperspace.scan.prefetch.enabled": False})
        issued = P.metrics.REGISTRY.get("io.prefetch.issued")
        base = issued.value
        session.run(df.filter(P.pkg.col("k") == 3).select("k", "v"))
        P.prefetch.drain()
        assert issued.value == base
        assert session.conf.get("hyperspace.scan.prefetch.enabled") is False

    def test_the_port_warms_the_footers_of_the_pruned_file(self, tmp_path):
        """After the prefetch the executor's footer read is a hit: the
        file the lookup keeps is in the footer cache."""
        P = PKGS["torch"]
        session, df = self._index(P, tmp_path, 4_000, 4)
        tio.clear_footer_cache()
        session.run(df.filter(P.pkg.col("k") == 7).select("k", "v"))
        P.prefetch.drain()
        files = [str(p) for p in (tmp_path / "sys" / "i1").rglob("bucket-*.parquet")]
        h0 = tstats.get("io.footer_cache.hits")
        tio.read_footers(files)
        assert tstats.get("io.footer_cache.hits") - h0 == 1  # one of four buckets kept


# -- the prefetch's and the footer cache's fault points --------------------------

import _torch_crash as crash  # noqa: E402
from hyperspace_tpu_torch import faults  # noqa: E402


@pytest.fixture
def indexed(tmp_path):
    faults.reset()
    source = crash.write_source(tmp_path / "src")
    s = crash.session(tmp_path / "sys")
    crash.create(s, source)
    tprefetch.reset()  # forget the issue history of earlier tests
    s.enable_hyperspace()
    yield source, s
    faults.reset()


def test_prefetch_fault_is_advisory(indexed):
    """A transient fault at prefetch.issue never fails a query: the
    prefetch counts the error and the executor's own read serves."""
    source, s = indexed
    errors = tmetrics.REGISTRY.get("io.prefetch.errors")
    before = errors.value
    with faults.injected("prefetch.issue"):
        crash.query_matches(s, source)
        tprefetch.drain()
    assert errors.value > before


def test_prefetch_crash_is_a_hard_death_then_clean_retry(tmp_path, indexed):
    source, s = indexed
    with faults.injected("prefetch.issue", crash=True):
        with pytest.raises(faults.CrashPoint):
            crash.query_matches(s, source)
    # The query holds no on-disk state: recover converges and the next
    # "process" answers.
    crash.assert_crash_consistent(tmp_path / "sys", source, "prefetch.issue")


def test_transient_footer_fault_is_retried(tmp_path):
    """footer.read fires inside the retried call: one transient fault is
    absorbed by the retry and the build goes on."""
    from hyperspace_tpu_torch.utils import retry

    faults.reset()
    retry.configure(max_attempts=3, backoff_base=0.0, sleeper=lambda s: None)
    try:
        source = crash.write_source(tmp_path / "src")
        s = crash.session(tmp_path / "sys")
        a0 = tstats.get("retry.attempts")
        with faults.injected("footer.read", times=1):
            crash.create(s, source)
        assert tstats.get("retry.attempts") == a0 + 1
        s.enable_hyperspace()
        crash.query_matches(s, source)
    finally:
        faults.reset()
        retry.configure(max_attempts=3, backoff_base=0.005, sleeper=__import__("time").sleep)
