"""Concurrent query server: bounded workers + admission control.

A port of the JAX package's `serve/scheduler.py`: N clients submit
logical plans; a fixed pool of worker threads executes them against ONE
session; an admission queue bounds how much work can pile up in front of
the executors.

- **Admission control at the door.** `submit` rejects with a typed
  :class:`AdmissionRejected` the moment the queue is at
  `hyperspace.serve.maxQueueDepth` (or, for non-priority submits, at the
  shed depth), carrying the observed depth so clients can back off.
- **Deterministic FIFO + one priority lane.** Two deques under one
  condition variable: priority tickets always dequeue first, each lane
  strictly in submit order.
- **Per-query timeout.** A ticket whose deadline passes while still
  queued is discarded un-executed (its handle raises
  :class:`QueryTimeout`); `QueryHandle.result()` bounds its wait the
  same way. Running queries are never killed: a result()-side timeout
  means "gave up waiting", not "cancelled".
- **Per-query handles.** Each submit returns a :class:`QueryHandle`
  owning that query's result, error, profile and stats.
- **Graceful drain/shutdown.** `drain()` pauses admission until the
  queue and in-flight work hit zero; `shutdown(wait=False)` cancels
  queued tickets; the server is a context manager.
- **Observability.** Queue-depth and in-flight gauges, admission
  counters, queue-wait and end-to-end latency histograms (`serve.*`).
  The submitter's active span is re-planted into the worker thread via
  `trace.wrap`, so a `serve.run` span nests under whatever trace
  submitted the query; a bare submit gets its own root trace.

**One card, many threads.** Every worker runs on the session's device
and on the calling thread's current CUDA stream, which is the device's
default stream for every thread: work from all workers is ordered on the
card, so a tensor one worker cached is safe for another to read. The
kernel wrappers count their launches under a lock (ops/kernels.py).

Tenant quotas (`quotas=`, serve/fleet/quota.py) run before admission;
the controller moves the shed depth at run time (`set_shed_depth`); with
`hyperspace.obs.http.enabled` the server holds the process's health
plane (obs/http.py, `health_endpoint`); a result cache with a
`single_flight` (the fleet's shared cache) executes a fleet-wide cold
miss once.
"""

from __future__ import annotations

import collections
import threading
import time

from hyperspace_tpu_torch.exceptions import AdmissionRejected, QueryTimeout
from hyperspace_tpu_torch.obs import events as obs_events
from hyperspace_tpu_torch.obs import metrics as obs_metrics
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.serve.plan_cache import PlanCache
from hyperspace_tpu_torch.serve.result_cache import ResultCache

# Declared at import so submit's narrow error contract (AdmissionRejected
# only) stays narrow: Event.emit never raises (obs/events.py).
_EVT_REJECTED = obs_events.declare("serve.admission_rejected")
_EVT_SHED = obs_events.declare("serve.shed")

_ADMITTED = obs_metrics.counter("serve.admitted", "queries accepted into the queue")
_REJECTED = obs_metrics.counter("serve.rejected", "submits refused by admission control")
_SHED = obs_metrics.counter(
    "serve.shed.rejected", "non-priority submits shed at the saturation threshold"
)
_TIMEOUTS = obs_metrics.counter("serve.timeouts", "queries expired before/while executing")
_COMPLETED = obs_metrics.counter("serve.completed", "queries finished successfully")
_FAILED = obs_metrics.counter("serve.failed", "queries finished with an error")
_CANCELLED = obs_metrics.counter("serve.cancelled", "queued queries dropped by shutdown")
_QUEUE_DEPTH = obs_metrics.gauge("serve.queue.depth", "tickets waiting for a worker")
_INFLIGHT = obs_metrics.gauge("serve.inflight", "queries currently executing")
_QUEUE_WAIT = obs_metrics.histogram(
    "serve.queue.seconds", "submit -> dequeue wait", buckets=obs_metrics.SECONDS_BUCKETS
)
_LATENCY = obs_metrics.histogram(
    "serve.latency.seconds", "submit -> completion end-to-end", buckets=obs_metrics.SECONDS_BUCKETS
)


class QueryHandle:
    """One submitted query's state: wait on it, then read the result (or
    the typed error), the per-query profile, and the executor stats —
    no shared session globals involved."""

    __slots__ = (
        "_done", "_result", "error", "profile", "stats",
        "timeout_s", "submitted_s", "timed_out", "cancelled", "cache_hit",
    )

    def __init__(self, timeout_s: float):
        self._done = threading.Event()
        self._result = None
        self.error: BaseException | None = None
        self.profile = None
        self.stats: dict | None = None
        self.timeout_s = float(timeout_s)
        self.submitted_s = time.perf_counter()
        self.timed_out = False
        self.cancelled = False
        self.cache_hit = False

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None):
        """Block for the result. `timeout` (seconds) overrides the
        query's own timeout; with neither, waits forever. Raises
        :class:`QueryTimeout` when the wait expires (the query may still
        complete later — inspect `done()`), or the query's stored error."""
        budget = timeout if timeout is not None else (self.timeout_s or None)
        if not self._done.wait(budget):
            elapsed = time.perf_counter() - self.submitted_s
            raise QueryTimeout(
                f"query still running after {elapsed:.3f}s (wait budget {budget:.3f}s)",
                elapsed_s=elapsed,
            )
        if self.error is not None:
            raise self.error
        return self._result


class _Ticket:
    __slots__ = ("plan", "handle", "run", "priority", "enqueued_s", "deadline_s")

    def __init__(self, plan, handle: QueryHandle, priority: bool):
        self.plan = plan
        self.handle = handle
        self.run = None  # set at submit: trace.wrap'd execution body
        self.priority = bool(priority)
        self.enqueued_s = time.perf_counter()
        self.deadline_s = (
            self.enqueued_s + handle.timeout_s if handle.timeout_s > 0 else None
        )


class QueryServer:
    """Bounded concurrent query execution over one HyperspaceSession."""

    def __init__(
        self,
        session,
        workers: int | None = None,
        max_queue_depth: int | None = None,
        timeout_seconds: float | None = None,
        plan_cache: "PlanCache | bool | None" = None,
        result_cache: "ResultCache | bool | None" = None,
        run_fn=None,
        quotas=None,
        shed_depth_ratio: float | None = None,
    ):
        conf = session.conf
        self.session = session
        self.workers = int(workers if workers is not None else conf.serve_workers)
        self.max_queue_depth = int(
            max_queue_depth if max_queue_depth is not None else conf.serve_max_queue_depth
        )
        self.timeout_seconds = float(
            timeout_seconds if timeout_seconds is not None else conf.serve_query_timeout_seconds
        )
        # Graceful saturation: shed
        # NON-priority submits once the queue reaches ratio x maxDepth,
        # so the priority lane keeps a bounded p99 while the server
        # saturates instead of queueing toward collapse. ratio >= 1
        # leaves only the hard depth limit.
        ratio = float(
            shed_depth_ratio if shed_depth_ratio is not None else conf.serve_shed_depth_ratio
        )
        self.shed_depth = (
            self.max_queue_depth if ratio >= 1.0
            else max(1, int(self.max_queue_depth * ratio))
        )
        # Per-tenant token-bucket admission (serve/fleet/quota.py). An
        # explicit TenantQuotas instance is shareable across servers;
        # True/None follow `hyperspace.serve.tenant.quota.enabled`.
        if quotas is None:
            quotas = conf.serve_tenant_quota_enabled
        if quotas is True:
            from hyperspace_tpu_torch.serve.fleet.quota import TenantQuotas

            quotas = TenantQuotas(
                rate=conf.serve_tenant_quota_rate, burst=conf.serve_tenant_quota_burst
            )
        self.quotas = quotas or None
        # True/False force the caches on/off; None follows config; an
        # instance is used as-is (shareable across servers).
        if plan_cache is None:
            plan_cache = conf.serve_plan_cache_enabled
        if plan_cache is True:
            plan_cache = PlanCache(conf.serve_plan_cache_max_entries)
        self._plan_cache: PlanCache | None = plan_cache or None
        if result_cache is None:
            result_cache = conf.serve_result_cache_enabled
        if result_cache is True:
            result_cache = ResultCache(conf.serve_result_cache_max_bytes)
        self._result_cache: ResultCache | None = result_cache or None
        # DI seam for scheduler tests: replaces the whole execute step
        # (plan -> result), keeping admission/timeout logic identical.
        self._run_fn = run_fn
        self._cv = threading.Condition()
        self._prio: collections.deque[_Ticket] = collections.deque()
        self._fifo: collections.deque[_Ticket] = collections.deque()
        self._inflight = 0
        self._accepting = True
        self._stopping = False
        self._threads = [
            threading.Thread(target=self._worker, name=f"hs-serve-{i}", daemon=True)
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()
        # The runtime health plane: opt-in /metrics + /healthz endpoints
        # sharing this server's lifecycle. Off: one conf read, no import,
        # no thread, no socket.
        self._http = None
        if conf.obs_http_enabled:
            from hyperspace_tpu_torch.obs import http as obs_http

            self._http = obs_http.acquire(host=conf.obs_http_host, port=conf.obs_http_port)
            self._http.attach_session(session)
            self._http.attach_server(self)

    # -- client API -------------------------------------------------------
    def submit(
        self,
        plan,
        priority: bool = False,
        timeout: float | None = None,
        tenant: str | None = None,
    ) -> QueryHandle:
        """Enqueue a plan; returns its :class:`QueryHandle` immediately.
        Raises :class:`AdmissionRejected` when the queue is full, the
        saturation threshold sheds a non-priority submit, or the server
        is draining/shut down — and its :class:`QuotaExceeded` subclass
        when `tenant`'s token bucket is dry (tenant-less submits are
        unmetered)."""
        if self.quotas is not None and tenant is not None:
            # Quota admission runs FIRST: a throttled tenant never costs
            # a queue slot, a lock acquisition, or a trace span.
            self.quotas.admit(tenant)
        timeout_s = self.timeout_seconds if timeout is None else float(timeout)
        handle = QueryHandle(timeout_s)
        with obs_trace.span("serve.enqueue", priority=bool(priority)):
            ticket = _Ticket(plan, handle, priority)
            # Built while the submitter's span is active: trace.wrap
            # re-plants it in whichever worker thread runs the body.
            ticket.run = obs_trace.wrap(self._body(ticket))
            with self._cv:
                if not self._accepting:
                    _REJECTED.inc()
                    _EVT_REJECTED.emit(reason="not_accepting")
                    raise AdmissionRejected("server is not accepting queries (draining or shut down)")
                depth = len(self._prio) + len(self._fifo)
                if depth >= self.max_queue_depth:
                    _REJECTED.inc()
                    _EVT_REJECTED.emit(
                        reason="queue_full", depth=depth, max_depth=self.max_queue_depth
                    )
                    raise AdmissionRejected(
                        f"admission queue full ({depth} >= max depth {self.max_queue_depth})",
                        depth=depth, max_depth=self.max_queue_depth,
                    )
                if depth >= self.shed_depth and not priority:
                    # Graceful saturation: the queue is past its shed
                    # threshold — refuse ordinary traffic (typed, with
                    # the observed depth for backoff) while the priority
                    # lane keeps admitting. p99 stays bounded; the
                    # server never queues toward collapse.
                    _REJECTED.inc()
                    _SHED.inc()
                    _EVT_SHED.emit(depth=depth, shed_depth=self.shed_depth)
                    raise AdmissionRejected(
                        f"load shed: queue depth {depth} >= shed threshold "
                        f"{self.shed_depth} (max {self.max_queue_depth})",
                        depth=depth, max_depth=self.max_queue_depth,
                    )
                (self._prio if priority else self._fifo).append(ticket)
                _ADMITTED.inc()
                _QUEUE_DEPTH.set(depth + 1)
                self._cv.notify()
        return handle

    def run(self, plan, priority: bool = False, timeout: float | None = None,
            tenant: str | None = None):
        """Submit and block for the result — the one-call client path."""
        return self.submit(
            plan, priority=priority, timeout=timeout, tenant=tenant
        ).result(timeout=timeout)

    @property
    def plan_cache(self) -> PlanCache | None:
        return self._plan_cache

    @property
    def result_cache(self) -> ResultCache | None:
        return self._result_cache

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._prio) + len(self._fifo)

    def set_shed_depth(self, depth: int) -> int:
        """Move the graceful-saturation shed threshold at run time — the
        ops controller's load-shedding actuator (serve/controller.py):
        while serve SLOs page, non-priority traffic is refused earlier so
        the queue drains instead of feeding the burn. Clamped to
        [1, maxQueueDepth]; returns the applied value."""
        with self._cv:
            self.shed_depth = max(1, min(int(depth), self.max_queue_depth))
            return self.shed_depth

    def get_shed_depth(self) -> int:
        with self._cv:
            return self.shed_depth

    def saturation(self) -> dict:
        """Point-in-time scheduler load: how full the admission queue is
        and how many workers are busy tells a balancer to back off BEFORE
        submits start bouncing off AdmissionRejected."""
        with self._cv:
            return {
                "workers": self.workers,
                "inflight": self._inflight,
                "queue_depth": len(self._prio) + len(self._fifo),
                "max_queue_depth": self.max_queue_depth,
                "shed_depth": self.shed_depth,
                "accepting": self._accepting,
            }

    @property
    def health_endpoint(self):
        """The attached HealthServer (None unless
        `hyperspace.obs.http.enabled` was true at construction)."""
        with self._cv:
            return self._http

    # -- lifecycle --------------------------------------------------------
    def drain(self, timeout: float | None = None) -> bool:
        """Pause admission and wait until the queue and in-flight work
        are empty; admission resumes afterwards (unless shut down).
        Returns False if `timeout` expired first."""
        with self._cv:
            self._accepting = False
            ok = self._cv.wait_for(
                lambda: not self._prio and not self._fifo and self._inflight == 0,
                timeout,
            )
            if not self._stopping:
                self._accepting = True
        return ok

    def shutdown(self, wait: bool = True, timeout: float | None = None) -> None:
        """Stop the server. With `wait`, queued and in-flight queries
        finish first (graceful); without, queued tickets are cancelled
        (their handles raise AdmissionRejected) and only in-flight
        queries complete. Idempotent."""
        with self._cv:
            self._accepting = False
            self._stopping = True
            if not wait:
                for t in (*self._prio, *self._fifo):
                    t.handle.cancelled = True
                    t.handle.error = AdmissionRejected("server shut down before execution")
                    _CANCELLED.inc()
                    t.handle._done.set()
                self._prio.clear()
                self._fifo.clear()
                _QUEUE_DEPTH.set(0)
            self._cv.notify_all()
        if wait:
            with self._cv:
                self._cv.wait_for(
                    lambda: not self._prio and not self._fifo and self._inflight == 0,
                    timeout,
                )
                self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        # The health plane rides the server's lifecycle: drop this server
        # from /healthz and release the shared endpoint (the last server
        # out closes the socket). Claimed once across repeated shutdowns.
        with self._cv:
            http, self._http = self._http, None
        if http is not None:
            from hyperspace_tpu_torch.obs import http as obs_http

            http.detach_server(self)
            obs_http.release()

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.shutdown(wait=exc_type is None)
        return False

    # -- worker plane -----------------------------------------------------
    def _worker(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._prio:
                        ticket = self._prio.popleft()
                        break
                    if self._fifo:
                        ticket = self._fifo.popleft()
                        break
                    if self._stopping:
                        return
                    self._cv.wait()
                _QUEUE_DEPTH.set(len(self._prio) + len(self._fifo))
                self._inflight += 1
                _INFLIGHT.set(self._inflight)
            try:
                waited = time.perf_counter() - ticket.enqueued_s
                _QUEUE_WAIT.observe(waited)
                if ticket.deadline_s is not None and time.perf_counter() > ticket.deadline_s:
                    # Expired while queued: the client has (or will have)
                    # timed out — executing it would burn worker time on
                    # an answer nobody is waiting for.
                    ticket.handle.timed_out = True
                    ticket.handle.error = QueryTimeout(
                        f"query expired in queue after {waited:.3f}s "
                        f"(timeout {ticket.handle.timeout_s:.3f}s)",
                        elapsed_s=waited,
                    )
                    _TIMEOUTS.inc()
                    ticket.handle._done.set()
                else:
                    ticket.run()
            finally:
                with self._cv:
                    self._inflight -= 1
                    _INFLIGHT.set(self._inflight)
                    self._cv.notify_all()

    def _body(self, ticket: _Ticket):
        """The execution closure for one ticket, run on a worker thread
        under the submitter's re-planted span (see submit)."""

        def body() -> None:
            handle = ticket.handle
            try:
                with obs_trace.trace("serve.run", priority=ticket.priority):
                    handle._result = self._execute(ticket.plan, handle)
                _COMPLETED.inc()
            except BaseException as e:  # noqa: HSL017 — worker isolation:
                # a failing query must not take the worker thread down;
                # the exception object (traceback included) is stored on
                # the handle and re-raised, original frames intact, by
                # QueryHandle.result() — preserved, not swallowed.
                handle.error = e
                _FAILED.inc()
            finally:
                _LATENCY.observe(time.perf_counter() - handle.submitted_s)
                handle._done.set()

        return body

    def _execute(self, plan, handle: QueryHandle):
        if self._run_fn is not None:
            return self._run_fn(plan)
        rc = self._result_cache
        if rc is None:
            return self._run_and_cache(plan, handle, None, None)
        key = rc.key(self.session, plan)

        def observe(hit):
            if hit is not None:
                handle.cache_hit = True
                handle.stats = {"result_cache": "hit"}
            return hit

        first = observe(rc.get(key))
        if first is not None:
            return first
        sf = getattr(rc, "single_flight", None)
        if sf is not None:
            # Fleet-wide cold miss: one process across the fleet executes
            # and publishes the shared entry; the rest observe it via the
            # poll, or run locally when the wait budget expires.
            from hyperspace_tpu_torch.serve.fleet.singleflight import key_name

            peek = getattr(rc, "peek", rc.get)
            return sf.run(
                f"result-{key_name(key)}",
                build=lambda: self._run_and_cache(plan, handle, rc, key),
                check=lambda: observe(peek(key)),
            )
        return self._run_and_cache(plan, handle, rc, key)

    def _run_and_cache(self, plan, handle: QueryHandle, rc, key):
        session = self.session
        outcome = session.run_query(plan, plan_cache=self._plan_cache)
        handle.profile = outcome.profile
        handle.stats = outcome.stats
        # Keep the session view current so last_profile()/explain keep
        # working for interactive pokes at a serving session.
        session._publish(outcome)
        if rc is not None and outcome.replans == 0:
            # A re-planned (corruption-fallback) result is correct, but its
            # key predates the quarantine it triggered: do not cache it.
            rc.put(key, outcome.result)
        return outcome.result

    def metrics_snapshot(self) -> dict:
        """Point-in-time serve.* metrics (tests / ops)."""
        reg = obs_metrics.REGISTRY
        return {
            name: m.snapshot()
            for name in reg.names()
            if name.startswith("serve.")
            for m in [reg.get(name)]
        }
