"""Summarize a Chrome trace produced by ``--trace-dir``.

Port of ``tools/trace_report.py``: ``load_events``, ``self_times``,
``sweep_attribution``, ``request_tree``, ``format_request``,
``format_report``, ``json_report`` and ``main`` with the same flags,
output and exit codes, over the traces the port writes (``obs/trace.py``,
``obs/run.py``). The standard library only: it imports no torch, so it
reads a run on any host.

Reads a ``trace.json`` (or ``trace.<process_index>.json``, or a
:mod:`photon_ml_tpu_torch.tools.trace_merge` merged multi-process
document) and prints:

1. the top-N span names by SELF time (total minus time spent in child
   spans on the same thread — timestamp containment defines nesting, so
   the report works on any Chrome trace with complete "X" events), and
2. per-coordinate sweep attribution: how much wall-clock each coordinate's
   ``cd.update`` spans cost per sweep — the "which coordinate ate the
   sweep" question the observability layer exists to answer.

``--process N`` restricts a merged multi-process document to one track;
``--json`` emits the same stats machine-readably (the format
:mod:`photon_ml_tpu_torch.tools.trace_diff` composes with).

``--device`` is the one view in torch form. The JAX view joins
``xla.compile`` / ``xla.retrace`` spans and their cost-analysis flops and
bytes with the runtime spans; the port has no jit and writes a
``build.compile`` span for each build it makes at run time
(``obs/compile.py``: sites ``kernels.nvcc:<stem>``,
``host.gxx:photon_host`` and ``data.column_sum_plan``, each with a
``cause`` label). Per build site the view gives the builds, their
milliseconds and a count by cause, joined with the self-time of the
runtime span that runs the built code. Its rows keep the JAX rows' keys:
``flops``, ``bytes_accessed`` and the two rates stay null, since a build
span carries no cost analysis, and ``retraces`` is 0, since nothing is
re-traced.

``--request <trace_id>`` switches to the serve plane's request view:
every span carrying that propagated ``trace_id`` label — across every
process track of a ``trace_merge``'d fleet document — is stitched into
one waterfall via its ``span_id``/``parent`` labels (NOT containment:
the parent link crosses processes, client→router→member), with
per-stage self-times so "where did this request's latency go" reads
straight off the tree. Works on sampled spans and on the exemplar
trees ``trace_merge --fleet`` folds in, so the slowest requests
resolve regardless of the sample rate.

Exit codes: 0 = report printed, 2 = unreadable/empty/invalid trace
(or an unknown ``--request`` trace id).

Usage::

    python -m photon_ml_tpu_torch.tools.trace_report out/trace/trace.json \\
        [--top 15] [--process 0] [--json] [--device]
    python -m photon_ml_tpu_torch.tools.trace_report \\
        out/fleet/merged_trace.json --request 1f00ab34c55d9e21
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict


def load_events(path: str) -> list[dict]:
    """Complete ("ph": "X") events from a Chrome trace file (object with
    ``traceEvents`` or a bare event array)."""
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError("not a Chrome trace: traceEvents is not a list")
    out = []
    for e in events:
        if (isinstance(e, dict) and e.get("ph") == "X"
                and "ts" in e and "name" in e):
            out.append(e)
    return out


def self_times(events: list[dict]) -> dict[str, dict]:
    """Per-name {count, total_us, self_us} via a containment sweep per
    (pid, tid): an event's self time is its duration minus its DIRECT
    children's durations."""
    stats: dict[str, dict] = defaultdict(
        lambda: {"count": 0, "total_us": 0.0, "self_us": 0.0})
    by_track: dict[tuple, list[dict]] = defaultdict(list)
    for e in events:
        by_track[(e.get("pid", 0), e.get("tid", 0))].append(e)
    for track in by_track.values():
        # sort by start asc, then duration desc so parents precede their
        # children that start at the identical timestamp
        track.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: list[tuple[float, float, list]] = []  # (end, dur, child_durs)
        for e in track:
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            while stack and ts >= stack[-1][0] - 1e-9:
                stack.pop()
            if stack:
                stack[-1][2].append(dur)
            child_durs: list = []
            stack.append((ts + dur, dur, child_durs))
            s = stats[e["name"]]
            s["count"] += 1
            s["total_us"] += dur
            # children are appended as later events arrive; record the
            # slot so self time resolves after the full sweep
            s.setdefault("_pending", []).append((dur, child_durs))
    for s in stats.values():
        for dur, child_durs in s.pop("_pending", []):
            s["self_us"] += max(0.0, dur - sum(child_durs))
    return dict(stats)


def sweep_attribution(events: list[dict]) -> dict[tuple, float]:
    """(sweep, coordinate) -> total cd.update microseconds."""
    out: dict[tuple, float] = defaultdict(float)
    for e in events:
        if e["name"] != "cd.update":
            continue
        args = e.get("args") or {}
        out[(args.get("sweep", "?"), args.get("coordinate", "?"))] += \
            float(e.get("dur", 0.0))
    return dict(out)


def _runtime_span(site: str) -> str | None:
    """The runtime span whose self-time the code built at ``site`` spends
    (the --device join key): the kernels and the ELL column sums run
    inside the solvers' evaluations. The host library
    (``host.gxx:photon_host``) decodes Avro and encodes scores, which no
    span of their own holds, so it stays unmapped: it reports its build
    cost without a runtime column, as the JAX map leaves its unmapped
    sites."""
    if site.startswith("kernels.nvcc:") or site == "data.column_sum_plan":
        return "optimizer.solve"
    return None


def device_report(events: list[dict]) -> list[dict]:
    """The --device view: per build site, the ``build.compile`` span
    labels (builds, build milliseconds, a count by ``cause``) joined
    with the mapped runtime span's count and self-time. The JAX rows'
    keys stay: ``flops``, ``bytes_accessed``, ``gflops_per_sec`` and
    ``gbytes_per_sec`` are None (a build span carries no cost analysis,
    and no rate is made up without one), ``retraces`` is 0 and
    ``last_retrace`` None (nothing is re-traced)."""
    sites: dict[str, dict] = {}
    for e in events:
        args = e.get("args") or {}
        site = args.get("site")
        if site is None or e["name"] != "build.compile":
            continue
        row = sites.setdefault(site, {
            "site": site, "compiles": 0, "compile_ms": 0.0,
            "flops": None, "bytes_accessed": None, "retraces": 0,
            "last_retrace": None, "causes": {}})
        row["compiles"] += 1
        row["compile_ms"] += float(args.get("secs", 0.0)) * 1e3
        cause = str(args.get("cause", "?"))
        row["causes"][cause] = row["causes"].get(cause, 0) + 1
    if not sites:
        return []
    stats = self_times(events)
    for site, row in sites.items():
        span = _runtime_span(site)
        s = stats.get(span) if span else None
        row["runtime_span"] = span
        row["span_count"] = s["count"] if s else None
        row["span_self_ms"] = round(s["self_us"] / 1e3, 3) if s else None
        row["gflops_per_sec"] = row["gbytes_per_sec"] = None
        row["compile_ms"] = round(row["compile_ms"], 3)
        row["causes"] = dict(sorted(row["causes"].items()))
    return sorted(sites.values(), key=lambda r: r["site"])


def format_device_report(events: list[dict]) -> str:
    rows = device_report(events)
    if not rows:
        return ("no device-plane spans in this trace — run with "
                "--device-telemetry to record build.compile (a build "
                "found in the cache records none)")
    w = max(20, *(len(r["site"]) for r in rows))
    lines = ["device plane (build.compile ⋈ runtime span self-time):",
             f"{'site':<{w}} {'compiles':>8} {'compile_ms':>11} "
             f"{'retraces':>8} {'runtime_span':<18} {'self_ms':>9} "
             f"{'GF/s':>8} {'GB/s':>8}"]
    lines.append("-" * (w + 77))
    for r in rows:
        lines.append(
            f"{r['site']:<{w}} {r['compiles']:>8} "
            f"{r['compile_ms']:>11.2f} {r['retraces']:>8} "
            f"{str(r['runtime_span'] or '—'):<18} "
            f"{r['span_self_ms'] if r['span_self_ms'] is not None else '—':>9} "
            f"{'—':>8} {'—':>8}")
    lines.append("")
    lines.append("build causes per site:")
    for r in rows:
        lines.append(f"  {r['site']}: " + ", ".join(
            f"{cause} x{n}" for cause, n in r["causes"].items()))
    return "\n".join(lines)


def request_tree(events: list[dict], trace_id: str) -> list[dict]:
    """The one request's spans as nested nodes (roots first, children
    under ``"children"``, siblings by start time), stitched by the
    propagated ``span_id``/``parent`` labels rather than containment —
    the links cross process tracks in a merged fleet document.

    Each node: ``{name, pid, ts, dur_us, self_us, labels, children}``.
    Spans appearing twice (a sampled span AND its exemplar-tree copy)
    dedup by ``span_id``. Self time is duration minus DIRECT children's
    durations; a remote child (the member's ``serve.request`` under the
    router's ``route.dispatch``) subtracts like a local one, so the
    router's dispatch self-time reads as pure wire+routing overhead."""
    by_id: dict[str, dict] = {}
    for e in events:
        args = e.get("args") or {}
        if args.get("trace_id") != trace_id:
            continue
        sid = args.get("span_id")
        if not sid or sid in by_id:
            continue
        by_id[sid] = {"name": e.get("name", ""),
                      "pid": e.get("pid", 0),
                      "ts": float(e.get("ts", 0.0)),
                      "dur_us": float(e.get("dur", 0.0)),
                      "self_us": float(e.get("dur", 0.0)),
                      "labels": {k: v for k, v in args.items()
                                 if k not in ("trace_id", "span_id",
                                              "parent")},
                      "parent": args.get("parent"),
                      "children": []}
    roots: list[dict] = []
    for node in by_id.values():
        parent = by_id.get(node["parent"] or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
            parent["self_us"] = max(0.0,
                                    parent["self_us"] - node["dur_us"])
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda n: n["ts"])
        del node["parent"]
    roots.sort(key=lambda n: n["ts"])
    return roots


def format_request(events: list[dict], trace_id: str) -> str | None:
    """The --request waterfall (None when the trace id is unknown)."""
    roots = request_tree(events, trace_id)
    if not roots:
        return None
    t0 = min(n["ts"] for n in roots)
    lines = [f"request {trace_id}:",
             f"{'span':<40} {'pid':>4} {'start_ms':>9} {'dur_ms':>9} "
             f"{'self_ms':>9}  detail",
             "-" * 92]

    def walk(node: dict, depth: int) -> None:
        label = "  " * depth + node["name"]
        detail = " ".join(
            f"{k}={node['labels'][k]}"
            for k in ("outcome", "rows", "shard", "member", "hops")
            if k in node["labels"])
        lines.append(
            f"{label:<40} {node['pid']:>4} "
            f"{(node['ts'] - t0) / 1e3:>9.3f} "
            f"{node['dur_us'] / 1e3:>9.3f} "
            f"{node['self_us'] / 1e3:>9.3f}  {detail}".rstrip())
        for child in node["children"]:
            walk(child, depth + 1)

    for root in roots:
        walk(root, 0)
    return "\n".join(lines)


def format_report(events: list[dict], top: int) -> str:
    lines = []
    stats = self_times(events)
    ranked = sorted(stats.items(), key=lambda kv: -kv[1]["self_us"])[:top]
    lines.append(f"{'span':<24} {'count':>7} {'total_ms':>10} "
                 f"{'self_ms':>10} {'avg_ms':>9}")
    lines.append("-" * 64)
    for name, s in ranked:
        lines.append(
            f"{name:<24} {s['count']:>7} {s['total_us'] / 1e3:>10.2f} "
            f"{s['self_us'] / 1e3:>10.2f} "
            f"{s['total_us'] / s['count'] / 1e3:>9.3f}")
    attr = sweep_attribution(events)
    if attr:
        lines.append("")
        lines.append("per-coordinate sweep attribution (cd.update):")
        lines.append(f"{'sweep':>6} {'coordinate':<20} {'ms':>10} {'%':>6}")
        lines.append("-" * 46)
        by_sweep: dict = defaultdict(float)
        for (sweep, _), us in attr.items():
            by_sweep[sweep] += us

        def sweep_key(sweep):
            # numeric sweeps sort numerically (2 before 10); non-numeric
            # labels (the "?" fallback) sort after, lexicographically
            try:
                return (0, float(sweep), "")
            except (TypeError, ValueError):
                return (1, 0.0, str(sweep))

        for (sweep, coord), us in sorted(
                attr.items(),
                key=lambda kv: (sweep_key(kv[0][0]), -kv[1])):
            pct = 100.0 * us / by_sweep[sweep] if by_sweep[sweep] else 0.0
            lines.append(f"{str(sweep):>6} {str(coord):<20} "
                         f"{us / 1e3:>10.2f} {pct:>5.1f}%")
    return "\n".join(lines)


def json_report(events: list[dict], top: int) -> dict:
    """The machine-readable twin of :func:`format_report` — per-name
    self-time stats plus sweep attribution, the document
    :mod:`photon_ml_tpu_torch.tools.trace_diff` and scripted perf checks
    consume."""
    stats = self_times(events)
    ranked = sorted(stats.items(), key=lambda kv: -kv[1]["self_us"])
    return {
        "kind": "trace_report",
        "processes": sorted({e.get("pid", 0) for e in events}),
        "span_count": len(events),
        "spans": {name: {"count": s["count"],
                         "total_us": s["total_us"],
                         "self_us": s["self_us"]}
                  for name, s in ranked[:top]},
        "sweep_attribution": [
            {"sweep": sweep, "coordinate": coord, "us": us}
            for (sweep, coord), us in sorted(
                sweep_attribution(events).items(),
                key=lambda kv: (str(kv[0][0]), str(kv[0][1])))],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="top spans by self-time + per-coordinate sweep "
                    "attribution from a --trace-dir trace.json")
    p.add_argument("trace", help="path to trace.json")
    p.add_argument("--top", type=int, default=15,
                   help="span names to show (by self time)")
    p.add_argument("--process", type=int, default=None,
                   help="restrict a merged multi-process document to "
                        "this process's track (pid)")
    p.add_argument("--json", action="store_true",
                   help="emit the stats as JSON instead of the table")
    p.add_argument("--device", action="store_true",
                   help="device-plane view: per build site, the "
                        "build.compile spans (builds, milliseconds, "
                        "causes) joined with the runtime span's "
                        "self-time (needs a trace recorded with "
                        "--device-telemetry)")
    p.add_argument("--request", default=None, metavar="TRACE_ID",
                   help="serve-plane request view: the cross-process "
                        "waterfall of one propagated trace id (stitched "
                        "by span_id/parent labels across a merged fleet "
                        "document) with per-stage self-times")
    ns = p.parse_args(argv)
    try:
        events = load_events(ns.trace)
    except (OSError, ValueError) as e:
        print(f"trace_report: cannot read {ns.trace}: {e}",
              file=sys.stderr)
        return 2
    if ns.process is not None:
        events = [e for e in events
                  if int(e.get("pid", 0)) == ns.process]
    if not events:
        where = (f" for process {ns.process}"
                 if ns.process is not None else "")
        print(f"trace_report: {ns.trace} holds no complete span "
              f"events{where}", file=sys.stderr)
        return 2
    if ns.request is not None:
        roots = request_tree(events, ns.request)
        if not roots:
            print(f"trace_report: no spans labeled trace_id="
                  f"{ns.request} in {ns.trace}", file=sys.stderr)
            return 2
        if ns.json:
            print(json.dumps({"kind": "trace_report_request",
                              "trace_id": ns.request,
                              "spans": roots}, indent=1))
        else:
            print(format_request(events, ns.request))
        return 0
    if ns.json:
        doc = json_report(events, ns.top)
        if ns.device:
            # additive key: the base schema (pinned by the stability
            # test) is unchanged unless --device is asked for
            doc["device"] = device_report(events)
        print(json.dumps(doc, indent=1))
    elif ns.device:
        print(format_device_report(events))
    else:
        print(format_report(events, ns.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
