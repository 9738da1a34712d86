"""The port's runtime health plane on the CPU: SLOs, process gauges,
Prometheus and Chrome export, and the HTTP endpoints.

tests/test_health_plane.py's cases through the port (its jit-compile cases
have no counterpart: the port compiles nothing at run time). Held against
the JAX package on the same inputs: the SLO tracker's burn rates and
verdicts over one seeded sequence of counter samples, histogram quantiles,
and the Prometheus text of the same counters, gauges and histograms, byte
for byte. The re-arm contract (a page that recovers and fires again emits a
second ``slo.burn``) runs on an injected clock with the registry reset per
test, and the /healthz read uses no wall clock for its verdict.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from hyperspace_tpu.obs import export as jax_export
from hyperspace_tpu.obs import metrics as jax_metrics
from hyperspace_tpu.obs import slo as jax_slo

from hyperspace_tpu_torch import stats
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.obs import events, journal, metrics, runtime, slo, trace
from hyperspace_tpu_torch.obs import export
from hyperspace_tpu_torch.obs import http as obs_http


@pytest.fixture(autouse=True)
def _port_obs_reset():
    """The port's process-global observability state, zeroed around each
    test (tests/conftest.py resets the JAX package's)."""
    stats.reset()
    metrics.REGISTRY.reset()
    trace.reset()
    trace.set_enabled(True)
    events.reset()
    slo.reset()
    journal.reset()
    yield
    slo.reset()
    trace.configure(sink=None)
    trace.reset()
    events.reset()
    while obs_http.shared() is not None:
        obs_http.release()


class FakeSession:
    """The session surface the health plane reads: conf + the lock-guarded
    index_health map."""

    def __init__(self, **conf_overrides):
        self.conf = HyperspaceConf()
        for k, v in conf_overrides.items():
            self.conf.set(k, v)
        self._state_lock = threading.RLock()
        self.index_health = {}


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def _serve_counters(mod=metrics):
    return (
        mod.counter("serve.completed"),
        mod.counter("serve.failed"),
        mod.counter("serve.timeouts"),
        mod.counter("serve.cancelled"),
        mod.histogram("serve.latency.seconds"),
    )


# -- events and process gauges ----------------------------------------------


def test_event_ring_counts_by_severity_and_utilization():
    events.configure(max_events=4)
    try:
        events.declare("controller.actuation").emit(action="a")
        events.declare("index.quarantined").emit(index="x")
        events.declare("slo.burn").emit(objective="serve.availability")
        assert events.counts_by_severity() == {"debug": 0, "info": 1, "warn": 1, "error": 1}
        assert events.refresh_gauges() == pytest.approx(0.75)
        assert metrics.REGISTRY.get("obs.events.ring_utilization").value == pytest.approx(0.75)
    finally:
        events.configure(max_events=events.DEFAULT_MAX_EVENTS)


@pytest.mark.parametrize("name", ["serve.quota_rejected", "fleet.singleflight.takeover", "fleet.worker.restarted",
                                  "fleet.worker.crash_loop", "fleet.worker.scaled", "controller.actuation",
                                  "controller.actuation_failed", "controller.backoff", "controller.observe_only",
                                  "controller.incident", "slo.burn"])
def test_the_slice_declares_the_jax_packages_events_and_severities(name):
    from hyperspace_tpu.obs import events as jax_events

    assert events.KNOWN_EVENTS[name] == jax_events.KNOWN_EVENTS[name]


def test_process_gauges_refresh():
    out = runtime.refresh_process_gauges()
    assert set(out) == {"map_count", "rss_watermark_bytes"}
    assert out["map_count"] > 0 and out["rss_watermark_bytes"] > 0
    assert metrics.REGISTRY.get("proc.map_count").value == out["map_count"]
    assert metrics.REGISTRY.get("proc.rss_watermark.bytes").value == out["rss_watermark_bytes"]


# -- SLO burn rates: held against the JAX package ---------------------------


def test_burn_rate_math_is_exact():
    completed, failed, *_ = _serve_counters()
    slo.sample(now=100.0)
    completed.inc(980)
    failed.inc(20)  # bad fraction 0.02; budget 0.001 -> burn 20
    slo.sample(now=160.0)
    assert slo.objective("serve.availability").window_burn(60.0, now=160.0) == pytest.approx(20.0)


def test_burn_windows_clamp_to_observed_span():
    completed, failed, *_ = _serve_counters()
    slo.sample(now=0.0)
    completed.inc(9)
    failed.inc(1)
    slo.sample(now=10.0)
    assert slo.objective("serve.availability").window_burn(3600.0, now=10.0) == pytest.approx(0.1 / 0.001)


def test_insufficient_data_is_none_not_zero():
    _serve_counters()
    assert slo.objective("serve.availability").window_burn(60.0) is None
    slo.sample(now=0.0)
    assert slo.objective("serve.availability").window_burn(60.0, now=0.0) is None


def test_undeclared_objective_raises():
    with pytest.raises(KeyError, match="undeclared SLO objective"):
        slo.objective("serve.availabilty")


def test_latency_objective_counts_goods_from_buckets():
    *_, latency = _serve_counters()
    slo.configure(latency_threshold_s=0.1)
    slo.sample(now=0.0)
    for _ in range(99):
        latency.observe(0.01)
    latency.observe(50.0)
    slo.sample(now=60.0)
    assert slo.objective("serve.latency_p99").window_burn(60.0, now=60.0) == pytest.approx(1.0)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_burn_rates_and_verdicts_equal_the_jax_packages(seed):
    """One seeded sequence of serve traffic (completions, failures,
    timeouts, cancellations, latencies; calm stretches and failure
    bursts) into both packages' registries, sampled and evaluated at the
    same instants: every window's burn rate and every verdict equal."""
    rng = np.random.default_rng(seed)
    ours, theirs = _serve_counters(metrics), _serve_counters(jax_metrics)
    slo.configure(latency_threshold_s=0.25)
    jax_slo.configure(latency_threshold_s=0.25)
    t = 0.0
    verdicts = []
    for step in range(120):
        t += float(rng.uniform(5.0, 90.0))
        burst = rng.random() < 0.15
        n_ok = int(rng.integers(50, 500))
        n_bad = int(rng.integers(50, 400)) if burst else int(rng.integers(0, 2))
        split = rng.integers(0, 3, n_bad)
        lat = rng.lognormal(-3.0, 1.5 if burst else 0.6, n_ok)
        for counters in (ours, theirs):
            counters[0].inc(n_ok)
            counters[1].inc(int((split == 0).sum()))
            counters[2].inc(int((split == 1).sum()))
            counters[3].inc(int((split == 2).sum()))
            for v in lat:
                counters[4].observe(float(v))
        slo.sample(now=t)
        jax_slo.sample(now=t)
        a, b = slo.evaluate(now=t), jax_slo.evaluate(now=t)
        assert a == b, f"step {step}"
        for name in slo.KNOWN_OBJECTIVES:
            for w in (60.0, 300.0, 600.0, 3600.0):
                assert slo.objective(name).window_burn(w, now=t) == jax_slo.objective(name).window_burn(w, now=t)
        verdicts.append(a["serve.availability"]["verdict"])
    assert "page" in verdicts and "ok" in verdicts  # the sequence exercises both
    burns = [e for e in events.recent() if e["name"] == "slo.burn"]
    from hyperspace_tpu.obs import events as jax_events

    jax_burns = [e for e in jax_events.recent() if e["name"] == "slo.burn"]
    assert [e["fields"] for e in burns] == [e["fields"] for e in jax_burns]


def test_page_recover_repage_rearms_on_an_injected_clock():
    """The re-arm contract of tests/test_health_plane.py:490-541, with
    every sample and evaluation on the test's own clock: a page emits one
    ``slo.burn``, staying paged emits none, a recovery re-arms it and the
    next page emits a second; /healthz then carries the controller's
    verdict beside the SLO section."""
    from hyperspace_tpu_torch.serve.controller import OpsController

    completed, failed, *_ = _serve_counters()
    session = FakeSession(**{"hyperspace.controller.enabled": "true"})

    class _Facade:
        def __init__(self, s):
            self.session = s

    ctrl = OpsController(_Facade(session), clock=lambda: 0.0)

    def burns():
        return [e for e in events.recent() if e["name"] == "slo.burn"]

    completed.inc(10_000)
    slo.sample(now=0.0)
    slo.sample(now=4000.0)
    assert slo.evaluate(now=4000.0)["serve.availability"]["verdict"] == "ok"
    failed.inc(3_000)
    slo.sample(now=4030.0)
    assert slo.evaluate(now=4030.0)["serve.availability"]["verdict"] == "page"
    assert len(burns()) == 1
    slo.evaluate(now=4030.0)
    assert len(burns()) == 1
    completed.inc(80_000)
    slo.sample(now=4100.0)
    assert slo.evaluate(now=4100.0)["serve.availability"]["verdict"] != "page"
    failed.inc(9_000)
    slo.sample(now=4130.0)
    assert slo.evaluate(now=4130.0)["serve.availability"]["verdict"] == "page"
    assert len(burns()) == 2
    assert [e["fields"]["objective"] for e in burns()] == ["serve.availability"] * 2
    ctrl.step(now=4131.0)
    snap = ctrl.snapshot()
    assert snap["mode"] == "actuate" and snap["verdicts"]["serve.availability"] == "page"
    hs = obs_http.HealthServer().start()
    try:
        hs.attach_controller(ctrl)
        doc = hs.healthz()
        assert doc["controller"][0]["verdicts"]["serve.availability"] == "page"
        assert "slo" in doc and "jit" not in doc and "map_count" in doc["proc"]
    finally:
        hs.stop()


# -- histogram quantiles: held against the JAX package ----------------------


@pytest.mark.parametrize("buckets", [(1.0, 2.0), (1.0, 10.0), (0.001, 0.01, 0.1, 1.0, 10.0), None])
def test_histogram_quantiles_equal_the_jax_packages(buckets):
    rng = np.random.default_rng(5)
    for size in (0, 1, 3, 257):
        kw = {} if buckets is None else {"buckets": buckets}
        ours = metrics.Histogram(f"t.q{size}", **kw)
        theirs = jax_metrics.Histogram(f"t.q{size}", **kw)
        for v in rng.lognormal(0.0, 2.0, size):
            ours.observe(float(v))
            theirs.observe(float(v))
        for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
            assert ours.quantile(q) == theirs.quantile(q)
        assert ours.percentiles() == theirs.percentiles()
        assert ours.bucket_counts() == theirs.bucket_counts()


def test_histogram_edge_shapes():
    h = metrics.Histogram("t.tight", buckets=(1.0, 10.0))
    for v in (2.0, 3.0, 4.0):
        h.observe(v)
    assert 2.0 <= h.quantile(0.5) <= 4.0
    assert h.quantile(0.0) == pytest.approx(2.0) and h.quantile(1.0) == pytest.approx(4.0)
    over = metrics.Histogram("t.over", buckets=(1.0, 2.0))
    for v in (5.0, 7.0, 9.0):
        over.observe(v)
    assert over.bucket_counts() == [(1.0, 0), (2.0, 0), (float("inf"), 3)]
    assert over.quantile(1.0) == pytest.approx(9.0)


# -- Prometheus text: held against the JAX package ----------------------------


def _populate(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serve.completed", "queries completed").inc(41)
    reg.counter("hostile", 'line1\nline2 "q" \\slash').inc(3)
    reg.gauge("serve.queue_depth", "queue depth").set(2.5)
    reg.gauge("proc.map_count").set(1234)
    h = reg.histogram("serve.latency.seconds", "submit to result", buckets=mod.SECONDS_BUCKETS)
    b = reg.histogram("query.bytes_scanned", "multi\nline", buckets=mod.BYTES_BUCKETS)
    rng = np.random.default_rng(9)
    for v in rng.lognormal(-4.0, 2.0, 300):
        h.observe(float(v))
    for v in rng.lognormal(12.0, 3.0, 100):
        b.observe(float(v))
    return reg


def test_prometheus_text_equals_the_jax_packages_byte_for_byte():
    ours = export.render_prometheus(_populate(metrics))
    theirs = jax_export.render_prometheus(_populate(jax_metrics))
    assert ours == theirs
    for line in ours.splitlines():
        assert line.startswith("#") or len(line.split(" ")) == 2, line
    assert "# HELP hyperspace_hostile line1\\nline2" in ours


def test_prometheus_escapes_and_round_trip():
    assert export.escape_help("a\\b\nc") == "a\\\\b\\nc"
    assert export.escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'
    reg = metrics.MetricsRegistry()
    reg.counter("rt.count", "with\nnewline").inc(41)
    reg.gauge("rt.gauge").set(2.5)
    parsed = {}
    for line in export.render_prometheus(reg).splitlines():
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            parsed[name] = float(value)
    assert parsed == {"hyperspace_rt_count": 41.0, "hyperspace_rt_gauge": 2.5}


# -- chrome traces and the export CLI ---------------------------------------


def test_chrome_trace_equals_the_jax_packages_and_lanes_threads(tmp_path):
    sink = tmp_path / "events.jsonl"
    trace.configure(sink=str(sink))
    with trace.trace("root"):
        def work():
            with trace.span("stage"):
                time.sleep(0.03)

        threads = [threading.Thread(target=trace.wrap(work)) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    roots = export.roots_from_sink(str(sink))
    assert roots == jax_export.roots_from_sink(str(sink))
    doc = export.chrome_trace(roots)
    assert doc == jax_export.chrome_trace(roots)
    stages = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["name"] == "stage"]
    assert len({e["tid"] for e in stages}) == 2
    a, b = [(e["ts"], e["ts"] + e["dur"]) for e in stages]
    assert a[0] < b[1] and b[0] < a[1]
    legacy = {"name": "root", "wall_s": 0.5, "children": [{"name": "child", "wall_s": 0.2}]}
    assert export.chrome_trace([legacy]) == jax_export.chrome_trace([legacy])


def test_export_cli_chrome_prom_and_fleet(tmp_path, capsys):
    sink = tmp_path / "s.jsonl"
    trace.configure(sink=str(sink))
    with trace.trace("query"):
        with trace.span("execute.Scan"):
            pass
    out = tmp_path / "trace.json"
    assert export.main(["--format", "chrome", "--sink", str(sink), "--output", str(out)]) == 0
    assert any(e["name"] == "execute.Scan" for e in json.loads(out.read_text())["traceEvents"])
    assert export.main(["--sink", str(sink)]) == 0
    assert "hyperspace_query_count 1" in capsys.readouterr().out
    assert export.main([]) == 0
    live = capsys.readouterr().out
    assert "hyperspace_proc_map_count" in live and "hyperspace_slo_serve_availability_burn_rate" in live
    journal.configure(enabled=True, root=str(tmp_path / "_obs"))
    with trace.trace("journaled"):
        pass
    journal.seal()
    fleet_out = tmp_path / "fleet.json"
    assert export.main(["--format", "chrome", "--fleet", str(tmp_path / "_obs"), "--output", str(fleet_out)]) == 0
    doc = json.loads(fleet_out.read_text())
    assert doc == jax_export.chrome_trace(jax_export.roots_from_fleet(str(tmp_path / "_obs")))
    assert any(e.get("name") == "journaled" for e in doc["traceEvents"])


# -- the HTTP endpoints -----------------------------------------------------


@pytest.fixture
def http_server():
    """A QueryServer with the health plane on an ephemeral port (DI run_fn:
    the scheduler's semantics without a dataset)."""
    from hyperspace_tpu_torch.serve.scheduler import QueryServer

    session = FakeSession(**{"hyperspace.obs.http.enabled": "true"})
    server = QueryServer(session, workers=4, max_queue_depth=512, run_fn=lambda p: p * 2)
    try:
        yield session, server, server.health_endpoint
    finally:
        server.shutdown()


def test_endpoints_under_8_concurrent_scrapers(http_server):
    """Eight scraper threads read /metrics and /healthz while eight
    clients submit: every scrape answers, and the scrapes feed the SLO
    sampler."""
    session, server, ep = http_server
    stop = threading.Event()
    errors, scrapes = [], []

    def client(cid):
        try:
            while not stop.is_set():
                assert server.submit(cid).result(timeout=30) == cid * 2
        except Exception as e:  # surfaced below
            errors.append(e)

    def scraper(path):
        try:
            while not stop.is_set():
                code, body = _get(ep.url(path))
                assert code == 200
                if path == "/metrics":
                    assert "hyperspace_serve_completed" in body
                    assert "hyperspace_slo_serve_availability_burn_rate" in body
                else:
                    doc = json.loads(body)
                    assert doc["status"] in ("ok", "degraded")
                    assert doc["scheduler"][0]["workers"] == 4
                    assert doc["endpoint"]["port"] == ep.port
                scrapes.append(path)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    threads += [threading.Thread(target=scraper, args=(p,)) for p in ("/metrics", "/healthz") * 4]
    for t in threads:
        t.start()
    time.sleep(2.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors[0]
    assert scrapes.count("/metrics") >= 8 and scrapes.count("/healthz") >= 8
    assert slo.objective("serve.availability").window_burn(60.0) is not None


def test_disabled_http_means_no_thread_no_socket():
    from hyperspace_tpu_torch.serve.scheduler import QueryServer

    server = QueryServer(FakeSession(), workers=1, run_fn=lambda p: p)
    try:
        assert server.health_endpoint is None
        assert obs_http.shared() is None
        assert not any(t.name == "hs-obs-http" for t in threading.enumerate())
    finally:
        server.shutdown()


def test_http_lifecycle_refcounts_across_servers():
    from hyperspace_tpu_torch.serve.scheduler import QueryServer

    session = FakeSession(**{"hyperspace.obs.http.enabled": "true"})
    s1 = QueryServer(session, workers=1, run_fn=lambda p: p)
    s2 = QueryServer(session, workers=1, run_fn=lambda p: p)
    try:
        assert s1.health_endpoint is s2.health_endpoint
        port = s1.health_endpoint.port
        s1.shutdown()
        s1.shutdown()  # the release is claimed once
        assert _get(f"http://127.0.0.1:{port}/metrics")[0] == 200
    finally:
        s2.shutdown()
    assert obs_http.shared() is None
    assert not any(t.name == "hs-obs-http" for t in threading.enumerate())


def test_healthz_reports_quarantine_and_process_gauges(http_server):
    session, server, ep = http_server
    with session._state_lock:
        session.index_health["/idx/broken"] = {"reason": "torn bucket", "path": "b0"}
    doc = json.loads(_get(ep.url("/healthz"))[1])
    assert doc["status"] == "degraded"
    assert doc["indexes"]["/idx/broken"]["reason"] == "torn bucket"
    assert "jit" not in doc and doc["proc"]["map_count"] > 0
    assert doc["events"] == events.counts_by_severity()


def test_debug_events_and_trace_endpoints(http_server):
    session, server, ep = http_server
    events.declare("index.quarantined").emit(index="x")
    events.declare("controller.actuation").emit(action="a")
    with trace.trace("query"):
        with trace.span("execute.Filter"):
            pass
    code, body = _get(ep.url("/debug/events?level=warn"))
    assert code == 200 and [e["name"] for e in json.loads(body)["events"]] == ["index.quarantined"]
    doc = json.loads(_get(ep.url("/debug/trace?limit=4"))[1])
    assert [t["name"] for t in doc["traces"]] == ["query"]
    assert doc["traces"][0]["children"][0]["name"] == "execute.Filter"
    assert json.loads(_get(ep.url("/debug/incidents"))[1]) == {"incidents": []}


def test_http_unknown_path_404_and_bad_query_400(http_server):
    _, _, ep = http_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(ep.url("/nope"))
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(ep.url("/debug/events?limit=banana"))
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(ep.url("/debug/incidents?name=nothing"))
    assert e.value.code == 404


def test_healthz_standalone_server_without_session():
    hs = obs_http.HealthServer().start()
    try:
        doc = json.loads(_get(hs.url("/healthz"))[1])
        assert doc["status"] == "ok"
        assert doc["indexes"] == {} and doc["scheduler"] == [] and doc["controller"] == []
        assert doc["fleet"] == [] and doc["ingest"] == []
    finally:
        hs.stop()
    assert hs.port is None and not hs.running


def test_new_config_keys_round_trip():
    conf = HyperspaceConf()
    assert conf.get("hyperspace.obs.http.enabled") is False
    conf.set("hyperspace.obs.http.enabled", "true")
    conf.set("hyperspace.obs.http.port", 19464)
    conf.set("hyperspace.obs.http.host", "0.0.0.0")
    assert conf.obs_http_enabled is True
    assert conf.get("hyperspace.obs.http.port") == 19464 and conf.get("hyperspace.obs.http.host") == "0.0.0.0"
    conf.set("hyperspace.obs.slo.availabilityTarget", 0.99)
    conf.set("hyperspace.obs.slo.latencyP99Seconds", 0.25)
    assert slo.TRACKER.availability_target == pytest.approx(0.99)
    assert conf.get("hyperspace.obs.slo.latencyP99Seconds") == pytest.approx(0.25)
