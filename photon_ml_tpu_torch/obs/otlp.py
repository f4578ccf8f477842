"""NDJSON telemetry → OTLP/HTTP JSON conversion (the standard-protocol
exit of the telemetry plane).

Port of ``photon_ml_tpu/obs/otlp.py``: the same mapping and ids; the
resource carries the port's manifest fields (torch and CUDA versions, the
device's name) where the JAX one carries its jax version and backend.

The run's native stream is the versioned NDJSON line protocol
(``telemetry_proto``, ``obs/export.py``); this module re-expresses it in
OpenTelemetry's OTLP/HTTP JSON encoding so Grafana/Jaeger/Tempo-class
collectors consume a photon run with zero custom tooling:

- spans (``spans.jsonl`` lines or ``kind: span`` stream records) become
  ``resourceSpans`` — one resource per process, parenting reconstructed
  per thread from span containment (start/end nesting — the same sweep
  :mod:`photon_ml_tpu_torch.tools.trace_report` uses for self-time),
  deterministic hash-derived trace/span ids so identical inputs convert
  identically (golden-fixture testable). Spans carrying propagated
  request-trace labels (``trace_id``/``span_id``/``parent`` — the serve
  plane's wire context) keep THOSE ids instead: the parent link then
  crosses processes, so Jaeger stitches a client→router→member request
  into one trace without any heuristic;
- ``metric_totals`` (run_end preferred, else the latest heartbeat)
  plus the exit snapshot's counter/gauge/histogram records become
  ``resourceMetrics`` (sums / gauges / histograms, cumulative
  temporality).

The conversion is versioned: :data:`OTLP_CONVERSION_VERSION` against
the input's ``telemetry_proto`` (refusing protos this code has never
seen beats silently mis-mapping them), both stamped on the emitted
scope. :func:`post_otlp` ships the documents to a collector with the
same containment contract as ``obs.export``: a dead/slow collector can
only ever cause batches to be **dropped** — counted on
``telemetry_dropped{kind=otlp}`` — never an exception out of the
bridge (the ``obs.otlp`` chaos cell proves it).

Everything here is stdlib-only (no torch import): the bridge must run on
a bare observer host.
"""

from __future__ import annotations

import calendar
import hashlib
import json
import time
import urllib.error
import urllib.request
from typing import Iterable, Optional

from photon_ml_tpu_torch.obs.export import TELEMETRY_PROTO
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.utils.faults import fault_point

#: Version of THIS mapping (bumped when the emitted OTLP shape changes).
OTLP_CONVERSION_VERSION = 1

#: ``telemetry_proto`` values this converter understands.
SUPPORTED_TELEMETRY_PROTOS = (1,)

_SCOPE = {"name": "photon_ml_tpu_torch.obs",
          "version": f"{TELEMETRY_PROTO}.{OTLP_CONVERSION_VERSION}"}


class UnsupportedProtoError(ValueError):
    """The stream declares a ``telemetry_proto`` this converter has
    never seen — refuse rather than mis-map."""


def _attr(key: str, value) -> dict:
    if isinstance(value, bool):
        v = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


def _attrs(d: dict) -> list:
    return [_attr(k, v) for k, v in sorted(d.items())]


def _hex_id(parts: Iterable, nhex: int) -> str:
    h = hashlib.sha256("|".join(str(p) for p in parts).encode())
    return h.hexdigest()[:nhex]


def _manifest_epoch(manifest: Optional[dict]) -> int:
    """The run's base wall-clock, seconds. The manifest's ``time`` is a
    local-format stamp; parsed as UTC so the SAME fixture converts to
    the SAME nanos on every machine (determinism beats absolute
    wall-clock truth for ids and goldens)."""
    if manifest:
        stamp = manifest.get("time")
        if stamp:
            try:
                return calendar.timegm(
                    time.strptime(stamp, "%Y-%m-%dT%H:%M:%S"))
            except ValueError:
                pass
    return 0


def _check_proto(manifest: Optional[dict]) -> None:
    if not manifest:
        return
    proto = manifest.get("telemetry_proto")
    if proto is not None and proto not in SUPPORTED_TELEMETRY_PROTOS:
        raise UnsupportedProtoError(
            f"telemetry_proto {proto!r} is not supported by OTLP "
            f"conversion version {OTLP_CONVERSION_VERSION} "
            f"(supported: {SUPPORTED_TELEMETRY_PROTOS})")


def _resource(manifest: Optional[dict], process_index: int) -> dict:
    attrs = {"service.name": "photon_ml_tpu_torch",
             "photon.process_index": process_index}
    if manifest:
        for src, dst in (("torch_version", "photon.torch_version"),
                         ("cuda_version", "photon.cuda_version"),
                         ("device_name", "photon.device_name"),
                         ("git_describe", "photon.git_describe"),
                         ("telemetry_proto", "photon.telemetry_proto")):
            if manifest.get(src) is not None:
                attrs[dst] = manifest[src]
    return {"attributes": _attrs(attrs)}


def _parent_ids(spans: list) -> list:
    """Per-(process, tid) containment sweep assigning each span its
    parent's id. ``spans`` is a list of (record, span_id, start_ns,
    end_ns); returns parent ids aligned with it."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][2], -(spans[i][3])))
    parents = [""] * len(spans)
    stack: list[int] = []  # indices of open enclosing spans
    for i in order:
        _, _, start, end = spans[i]
        while stack and spans[stack[-1]][3] < end:
            stack.pop()
        if stack:
            parents[i] = spans[stack[-1]][1]
        stack.append(i)
    return parents


def records_to_otlp(records: Iterable[dict]) -> dict:
    """Convert one run's records (any mix of manifest / span /
    heartbeat / run_end / metric-snapshot lines, any process count)
    into ``{"traces": <OTLP traces doc>, "metrics": <OTLP metrics
    doc>}``. Deterministic: identical input records yield identical
    documents (hash-derived ids, manifest-derived timestamps)."""
    manifests: dict[int, dict] = {}
    spans_by_proc: dict[int, list] = {}
    totals_by_proc: dict[int, dict] = {}
    totals_rank: dict[int, int] = {}  # heartbeat=1 < run_end=2
    metric_records: dict[int, list] = {}

    for rec in records:
        if not isinstance(rec, dict):
            continue
        kind = rec.get("kind")
        proc = int(rec.get("process_index", 0) or 0)
        if kind == "run_manifest":
            _check_proto(rec)
            manifests.setdefault(proc, rec)
        elif kind == "span" or (kind is None and "ts_us" in rec
                                and "name" in rec):
            spans_by_proc.setdefault(proc, []).append(rec)
        elif kind == "heartbeat":
            if rec.get("metric_totals") and totals_rank.get(proc, 0) <= 1:
                totals_by_proc[proc] = rec["metric_totals"]
                totals_rank[proc] = 1
        elif kind == "run_end":
            totals = dict(rec.get("metric_totals") or {})
            if rec.get("peak_hbm_bytes") is not None:
                totals["peak_hbm_bytes"] = rec["peak_hbm_bytes"]
            if totals:
                totals_by_proc[proc] = totals
                totals_rank[proc] = 2
        elif kind in ("counter", "gauge", "histogram"):
            metric_records.setdefault(proc, []).append(rec)

    procs = sorted(set(manifests) | set(spans_by_proc)
                   | set(totals_by_proc) | set(metric_records))
    base_manifest = manifests.get(procs[0]) if procs else None
    trace_id = _hex_id(("photon-run",
                        (base_manifest or {}).get("time", ""),
                        (base_manifest or {}).get("git_describe", "")), 32)

    resource_spans = []
    resource_metrics = []
    for proc in procs:
        manifest = manifests.get(proc, base_manifest)
        base_ns = _manifest_epoch(manifest) * 1_000_000_000
        resource = _resource(manifest, proc)

        # -- traces ---------------------------------------------------
        by_tid: dict = {}
        for i, rec in enumerate(spans_by_proc.get(proc, [])):
            start = base_ns + int(rec.get("ts_us", 0) * 1000)
            end = start + int(rec.get("dur_us", 0) * 1000)
            span_id = _hex_id(("span", proc, rec.get("tid"),
                               rec.get("ts_us"), rec.get("dur_us"),
                               rec.get("name"), i), 16)
            by_tid.setdefault(rec.get("tid", 0), []).append(
                (rec, span_id, start, end))
        otlp_spans = []
        for tid in sorted(by_tid, key=str):
            group = by_tid[tid]
            parents = _parent_ids(group)
            for (rec, span_id, start, end), parent in zip(group, parents):
                labels = dict(rec.get("labels") or {})
                labels["thread.id"] = tid
                # propagated request-trace context wins over the
                # containment sweep: its ids are shared across processes
                # (router stamps them on the wire), so keeping them lets
                # a collector join the cross-process request tree
                wire_span = labels.get("span_id")
                wire_trace = labels.get("trace_id")
                wire_parent = labels.get("parent")
                if wire_span:
                    span_id = str(wire_span)
                    parent = str(wire_parent) if wire_parent else ""
                otlp_spans.append({
                    "traceId": (str(wire_trace).zfill(32)[:32]
                                if wire_trace else trace_id),
                    "spanId": span_id,
                    "parentSpanId": parent,
                    "name": str(rec.get("name", "")),
                    "kind": 1,  # SPAN_KIND_INTERNAL
                    "startTimeUnixNano": str(start),
                    "endTimeUnixNano": str(end),
                    "attributes": _attrs(labels),
                })
        if otlp_spans:
            resource_spans.append({
                "resource": resource,
                "scopeSpans": [{"scope": _SCOPE, "spans": otlp_spans}]})

        # -- metrics --------------------------------------------------
        end_ns = str(base_ns)
        metrics: list = []
        for name, value in sorted(
                (totals_by_proc.get(proc) or {}).items()):
            if isinstance(value, dict):  # histogram {count, sum}
                metrics.append({
                    "name": name,
                    "histogram": {
                        "aggregationTemporality": 2,
                        "dataPoints": [{
                            "timeUnixNano": end_ns,
                            "count": str(int(value.get("count", 0))),
                            "sum": float(value.get("sum", 0.0))}]}})
            else:
                metrics.append({
                    "name": name,
                    "sum": {"aggregationTemporality": 2,
                            "isMonotonic": True,
                            "dataPoints": [{"timeUnixNano": end_ns,
                                            "asDouble": float(value)}]}})
        for rec in metric_records.get(proc, []):
            point_attrs = _attrs(dict(rec.get("labels") or {}))
            if rec["kind"] == "histogram":
                metrics.append({
                    "name": rec["name"],
                    "histogram": {
                        "aggregationTemporality": 2,
                        "dataPoints": [{
                            "timeUnixNano": end_ns,
                            "attributes": point_attrs,
                            "count": str(int(rec.get("count", 0))),
                            "sum": float(rec.get("sum", 0.0)),
                            "min": rec.get("min"),
                            "max": rec.get("max")}]}})
            else:
                body = {"dataPoints": [{"timeUnixNano": end_ns,
                                        "attributes": point_attrs,
                                        "asDouble": float(
                                            rec.get("value", 0.0))}]}
                if rec["kind"] == "counter":
                    body["aggregationTemporality"] = 2
                    body["isMonotonic"] = True
                    metrics.append({"name": rec["name"], "sum": body})
                else:
                    metrics.append({"name": rec["name"], "gauge": body})
        if metrics:
            resource_metrics.append({
                "resource": resource,
                "scopeMetrics": [{"scope": _SCOPE, "metrics": metrics}]})

    return {"traces": {"resourceSpans": resource_spans},
            "metrics": {"resourceMetrics": resource_metrics}}


def load_run_dir(run_dir: str) -> list:
    """Read a ``--trace-dir`` run directory back into the record list
    :func:`records_to_otlp` takes: every ``run_manifest[.i].json``,
    ``spans[.i].jsonl`` (tagged with its process index) and
    ``metrics[.i].jsonl``/``telemetry[.i].jsonl`` line that parses —
    torn tail lines from a killed run are skipped, like every other
    consumer of the spill."""
    import os
    import re

    patterns = (
        (re.compile(r"^run_manifest(?:\.(\d+))?\.json$"), "manifest"),
        (re.compile(r"^spans(?:\.(\d+))?\.jsonl$"), "spans"),
        (re.compile(r"^metrics(?:\.(\d+))?\.jsonl$"), "lines"),
        (re.compile(r"^telemetry(?:\.(\d+))?\.jsonl$"), "lines"),
    )
    records: list = []
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return records
    for fname in names:
        for rx, how in patterns:
            m = rx.match(fname)
            if not m:
                continue
            proc = int(m.group(1) or 0)
            path = os.path.join(run_dir, fname)
            try:
                with open(path) as fh:
                    if how == "manifest":
                        rec = json.load(fh)
                        rec.setdefault("process_index", proc)
                        records.append(rec)
                        continue
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue  # torn tail line
                        if not isinstance(rec, dict):
                            continue
                        if how == "spans":
                            rec.setdefault("kind", "span")
                        rec.setdefault("process_index", proc)
                        records.append(rec)
            except OSError:
                continue
            break
    return records


def post_otlp(docs: dict, collector: str, timeout: float = 5.0,
              registry=None) -> dict:
    """POST converted documents to an OTLP/HTTP collector
    (``<collector>/v1/traces`` + ``/v1/metrics``). CONTAINED: every
    failure (dead collector, timeout, injected ``obs.otlp`` fault)
    drops that batch and counts it on ``telemetry_dropped{kind=otlp}``
    — never an exception. Returns ``{"posted": n, "dropped": n}``."""
    reg = registry or REGISTRY
    posted = dropped = 0
    base = collector.rstrip("/")
    for path, key in (("/v1/traces", "traces"),
                      ("/v1/metrics", "metrics")):
        doc = docs.get(key)
        if not doc:
            continue
        try:
            # the obs.otlp drill site: a dead/flaky/slow collector can
            # only ever drop batches, mirroring obs.export's contract
            fault_point("obs.otlp")
            req = urllib.request.Request(
                base + path, data=json.dumps(doc).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout):
                pass
            posted += 1
        except (OSError, urllib.error.URLError, ValueError):
            dropped += 1
            reg.counter("telemetry_dropped").inc(kind="otlp")
    return {"posted": posted, "dropped": dropped}
