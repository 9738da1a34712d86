"""Metrics export: Prometheus text exposition + Chrome trace timelines.

A port of the JAX package's `obs/export.py`: the same text for the same
registry, byte for byte, and the same Chrome trace documents.

Modes::

    python -m hyperspace_tpu_torch.obs.export                      # live registry
    python -m hyperspace_tpu_torch.obs.export --sink q.jsonl       # aggregate a sink
    python -m hyperspace_tpu_torch.obs.export --format chrome \
        --sink q.jsonl --output trace.json                   # span timelines
    python -m hyperspace_tpu_torch.obs.export --format chrome \
        --fleet /path/_obs --output fleet.json   # merged fleet journals

Prometheus: renders whatever the registry holds (the /metrics endpoint
in obs/http.py serves exactly this), or replays a JSON-lines trace sink
(`hyperspace.obs.sink`) into a fresh registry so offline trajectories
export the same way live processes do. Metric names are sanitized to
the Prometheus grammar (`hyperspace_` prefix, dots → underscores);
HELP text and label values are escaped per the text exposition format
(`\\` → `\\\\`, newline → `\\n`, and `"` → `\\"` inside label values) —
a hostile metric description can no longer tear the exposition apart.

Chrome: converts span trees (from a sink file, or the in-process
recent-root ring) to the Chrome Trace Event format — open the output in
`chrome://tracing` or https://ui.perfetto.dev. Spans carry their start
offset and OS thread id (obs/trace.py), so genuinely concurrent work —
the overlapped build-pipeline stages, pool-fanned IO — renders as
overlapping slices on separate thread lanes instead of a flattened
tree.
"""

from __future__ import annotations

import argparse
import json
import sys

from hyperspace_tpu_torch.obs import metrics as m


def _prom_name(name: str) -> str:
    return "hyperspace_" + "".join(
        c if c.isalnum() or c == "_" else "_" for c in name
    )


def escape_help(text: str) -> str:
    """HELP/TYPE comment escaping per the Prometheus text exposition
    format: backslash and newline only."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(value: str) -> str:
    """Label-value escaping: backslash, double-quote, newline."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return repr(float(v)) if isinstance(v, float) and not float(v).is_integer() else str(int(v))


def render_prometheus(registry: "m.MetricsRegistry | None" = None) -> str:
    """The registry as Prometheus text exposition format."""
    reg = registry if registry is not None else m.REGISTRY
    out: list[str] = []
    for metric in reg.collect():
        name = _prom_name(metric.name)
        if metric.help:
            out.append(f"# HELP {name} {escape_help(metric.help)}")
        out.append(f"# TYPE {name} {metric.kind}")
        if metric.kind in ("counter", "gauge"):
            out.append(f"{name} {_fmt(metric.value)}")
        else:  # histogram
            for le, cum in metric.bucket_counts():
                le_s = "+Inf" if le == float("inf") else repr(float(le))
                out.append(f'{name}_bucket{{le="{escape_label_value(le_s)}"}} {cum}')
            out.append(f"{name}_sum {float(metric.sum)!r}")
            out.append(f"{name}_count {metric.count}")
    return "\n".join(out) + "\n"


def _walk_span(span: dict):
    yield span
    for c in span.get("children", ()):
        yield from _walk_span(c)


def registry_from_sink(path: str) -> "m.MetricsRegistry":
    """Replay a JSON-lines trace sink into a fresh registry. Unparseable
    lines are skipped (a crash mid-append can tear the final line)."""
    reg = m.MetricsRegistry()
    queries = reg.counter("query.count", "root traces in sink")
    q_s = reg.histogram("query.seconds", "root trace wall time", buckets=m.SECONDS_BUCKETS)
    op_s = reg.histogram("query.operator.seconds", "span wall time", buckets=m.SECONDS_BUCKETS)
    io_b = reg.histogram("query.bytes_scanned", "bytes per io span", buckets=m.BYTES_BUCKETS)
    errors = reg.counter("trace.errors", "spans closed with error=")
    with open(path) as f:
        for line in f:
            try:
                event = json.loads(line)
            except ValueError:
                continue
            root = event.get("trace") or {}
            queries.inc()
            if root.get("wall_s") is not None:
                q_s.observe(root["wall_s"])
            for span in _walk_span(root):
                if span.get("error"):
                    errors.inc()
                if span.get("wall_s") is None:
                    continue
                name = span.get("name", "")
                if name.startswith("execute."):
                    op_s.observe(span["wall_s"])
                attrs = span.get("attrs") or {}
                if name.startswith("io.") and "bytes" in attrs:
                    io_b.observe(float(attrs["bytes"]))
    return reg


# -- Chrome trace export ------------------------------------------------------

def roots_from_sink(path: str) -> list[dict]:
    """Every root-span dict in a JSON-lines sink file (torn lines
    skipped, same contract as registry_from_sink)."""
    roots: list[dict] = []
    with open(path) as f:
        for line in f:
            try:
                event = json.loads(line)
            except ValueError:
                continue
            root = event.get("trace")
            if root:
                roots.append(root)
    return roots


def live_roots() -> list[dict]:
    """The in-process recent-root ring as span dicts (the no-sink
    source: /debug/trace and programmatic export share it)."""
    from hyperspace_tpu_torch.obs import trace as _trace

    return [r.to_json() for r in _trace.recent_roots()]


def roots_from_fleet(journal_root: str) -> list[dict]:
    """Root spans merged from every fleet member's durable journal under
    `journal_root` (the `_obs` dir: one `<pid>/` per member —
    obs/journal.py). Each root is stamped with its member's pid so
    `chrome_trace` lanes one track group per member even for spans whose
    trace ids predate adoption. Dead members' sealed segments read fine;
    torn tails are skipped by the journal reader."""
    from hyperspace_tpu_torch.obs import journal as _journal

    roots = []
    for rec in _journal.merge_dir(journal_root):
        if rec.get("kind") != "span" or not isinstance(rec.get("trace"), dict):
            continue
        root = rec["trace"]
        if isinstance(rec.get("pid"), int):
            root = dict(root, pid=rec["pid"])
        roots.append(root)
    return roots


def chrome_trace(roots: "list[dict]") -> dict:
    """Span trees as a Chrome Trace Event document (Perfetto/
    chrome://tracing). Each span becomes one complete ("X") event laned
    by the OS thread it ran on; timestamps are normalized so the
    earliest span starts at 0. Spans from old sinks without timeline
    fields inherit their parent's start (rendering nested, zero-offset).
    """
    events: list[dict] = []
    starts = [
        s["t0_s"] for r in roots for s in _walk_span(r) if s.get("t0_s") is not None
    ]
    base = min(starts) if starts else 0.0
    # Lanes are qualified by (pid, os-thread): two fleet members whose
    # OS thread ids collide (they usually do — every member's main
    # thread) must not interleave on one track. Alias numbering restarts
    # per pid so each member's track group reads thread-1..N.
    tid_alias: dict = {}
    lanes_per_pid: dict = {}

    def lane(pid: int, raw_tid) -> int:
        key = (pid, raw_tid)
        if key not in tid_alias:
            lanes_per_pid[pid] = lanes_per_pid.get(pid, 0) + 1
            tid_alias[key] = lanes_per_pid[pid]
        return tid_alias[key]

    def emit(span: dict, pid: int, trace_id: "str | None", parent_ts: float) -> None:
        ts = (
            (span["t0_s"] - base) * 1e6 if span.get("t0_s") is not None else parent_ts
        )
        args = dict(span.get("attrs") or {})
        if span.get("error") is not None:
            args["error"] = span["error"]
        if trace_id is not None:
            args["trace_id"] = trace_id
        events.append(
            {
                "ph": "X",
                "name": span.get("name", "?"),
                "cat": "span",
                "ts": round(ts, 3),
                "dur": round((span.get("wall_s") or 0.0) * 1e6, 3),
                "pid": pid,
                "tid": lane(pid, span.get("tid", 0)),
                "args": args,
            }
        )
        for child in span.get("children", ()):
            emit(child, pid, trace_id, ts)

    for root in roots:
        trace_id = root.get("trace_id")
        # Root ids are "<pid>-<seq>" (obs/trace.py): keep sink lines from
        # several processes on separate pid tracks. Journal-merged roots
        # may also carry an explicit "pid" (obs/journal.py), preferred
        # over parsing.
        pid = 1
        if isinstance(root.get("pid"), int):
            pid = root["pid"]
        elif trace_id and "-" in str(trace_id):
            head = str(trace_id).split("-", 1)[0]
            if head.isdigit():
                pid = int(head)
        emit(root, pid, trace_id, 0.0)
    alias_of = {(pid, alias): raw for (pid, raw), alias in tid_alias.items()}
    meta = [
        {
            "ph": "M",
            "name": "thread_name",
            "pid": pid,
            "tid": alias,
            "args": {"name": f"thread-{alias} (os:{alias_of[(pid, alias)]})"},
        }
        for pid, alias in sorted({(e["pid"], e["tid"]) for e in events})
    ]
    meta += [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "args": {"name": f"member pid {pid}"},
        }
        for pid in sorted({e["pid"] for e in events})
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hyperspace_tpu_torch.obs.export",
        description="Export hyperspace telemetry: Prometheus text or Chrome trace.",
    )
    ap.add_argument(
        "--sink", help="read a JSON-lines trace sink file instead of live process state"
    )
    ap.add_argument(
        "--fleet",
        help="merge every fleet member's durable journal under this _obs "
        "root (obs/journal.py) — one chrome track group per member pid; "
        "reads sealed segments only, so it works on a dead fleet",
    )
    ap.add_argument(
        "--format",
        choices=("prom", "chrome"),
        default="prom",
        help="prom = Prometheus text exposition; chrome = Chrome Trace Events "
        "(open in chrome://tracing or Perfetto)",
    )
    ap.add_argument("--output", help="write here instead of stdout")
    args = ap.parse_args(argv)
    if args.format == "chrome":
        if args.fleet:
            roots = roots_from_fleet(args.fleet)
            if args.sink:
                roots += roots_from_sink(args.sink)
        else:
            roots = roots_from_sink(args.sink) if args.sink else live_roots()
        text = json.dumps(chrome_trace(roots))
    elif args.sink:
        text = render_prometheus(registry_from_sink(args.sink))
    else:
        # Declare the core metric families so a fresh process exposes
        # the full schema (zeros) instead of an empty page.
        import hyperspace_tpu_torch.obs.profile  # noqa: F401 — declares query.* metrics
        import hyperspace_tpu_torch.obs.runtime  # noqa: F401 — declares proc. gauges
        import hyperspace_tpu_torch.obs.slo  # noqa: F401 — declares slo.* burn gauges
        import hyperspace_tpu_torch.stats  # noqa: F401 — declares fault-plane counters

        text = render_prometheus()
    if args.output:
        with open(args.output, "w") as f:
            f.write(text if text.endswith("\n") else text + "\n")
    else:
        sys.stdout.write(text if text.endswith("\n") else text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
