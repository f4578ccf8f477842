"""Merge a multi-host run dir's per-process traces into one timeline.

Port of ``tools/trace_merge.py``: ``discover_processes``,
``discover_fleet``, ``merge`` and ``main`` with the same flags, merged
document, alignment ladder and exit codes, over the port's run dirs. The
port's gang opens its ``gang.form`` span around the gloo group's
formation (``parallel/multihost.py``), each process's ``trace.json``
carries ``otherData.start_unix_time`` (``obs/trace.py``) and each
service writes ``exemplars.jsonl`` beside its spans
(``serve/service.py``). The standard library only.

Every process of a multi-host GAME run writes its own
``trace.<process_index>.json`` / ``spans.<process_index>.jsonl`` into
the shared ``--trace-dir`` — and nothing ever lines them up: each
process's timestamps are relative to ITS tracer's monotonic epoch, so
loading two files side by side shows two unrelated clocks. This tool
merges them into one Perfetto-loadable Chrome-trace document with one
track (``pid``) per process, clock-aligned on each process's
``gang.form`` span — the gang's formation returns on every member when
the last one has joined, so the span's END is the closest thing the run
has to a shared wall-clock instant on every host.

Alignment ladder (recorded in ``otherData.alignment``):

1. ``gang.form`` — every process has the anchor span: its end is mapped
   to the same merged timestamp (the max across processes, so no span
   moves left of zero relative to its own stream);
2. ``start_unix`` — no anchor anywhere (e.g. single-host parts), but the
   per-process ``trace.json`` carries ``otherData.start_unix_time``:
   streams are offset by their wall-clock starts (~ms accuracy);
3. ``none`` — raw concatenation with a warning (still loadable; the
   tracks just don't share a clock).

A serve FLEET dir (``photon_supervise --fleet``: ``router/``
plus ``member<k>/`` run-dir subdirectories) merges the same way — one
track per fleet process, detected automatically (or forced with
``--fleet``). Serve processes never ``gang.form``, so fleet merges
align on the ``start_unix`` rung. Each member's ``exemplars.jsonl``
(the always-keep-slowest reservoir) contributes the span trees of its
UNSAMPLED exemplar requests, so the slowest requests are on the merged
timeline even when head sampling skipped them; sampled exemplars are
already in the span stream and are not duplicated.

Usage::

    python -m photon_ml_tpu_torch.tools.trace_merge out/trace \\
        [--out merged_trace.json] [--anchor gang.form] [--from-spans]
    python -m photon_ml_tpu_torch.tools.trace_merge out/fleet [--fleet]

Exit codes: 0 = merged document written, 2 = no per-process traces
found / unreadable input.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

_TRACE_RE = re.compile(r"^trace(?:\.(\d+))?\.json$")
_SPANS_RE = re.compile(r"^spans(?:\.(\d+))?\.jsonl$")
_FLEET_SUB_RE = re.compile(r"^(?:router|member(\d+))$")

DEFAULT_ANCHOR = "gang.form"


def _load_trace_json(path: str) -> tuple[list[dict], dict]:
    """(complete "X" events, otherData) from one per-process trace."""
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError(f"{path}: not a Chrome trace document")
    events = [e for e in doc["traceEvents"]
              if isinstance(e, dict) and e.get("ph") == "X"
              and "ts" in e and "name" in e]
    return events, doc.get("otherData") or {}


def _load_spans_jsonl(path: str, process_index: int) -> list[dict]:
    """spans.jsonl records → Chrome "X" events (the live-run path: the
    run may still be training, trace.json not rebuilt yet)."""
    events = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except ValueError:
                continue  # torn tail line from a live/killed run
            if not isinstance(e, dict) or "name" not in e \
                    or "ts_us" not in e:
                continue
            events.append({"name": e["name"], "cat": "photon", "ph": "X",
                           "ts": e["ts_us"], "dur": e.get("dur_us", 0.0),
                           "pid": process_index, "tid": e.get("tid", 0),
                           "args": e.get("labels") or {}})
    return events


def discover_processes(run_dir: str, from_spans: bool = False
                       ) -> dict[int, dict]:
    """``{process_index: {"events": [...], "other": {...}, "source":
    path}}`` for every per-process stream in the run dir. Prefers the
    rebuilt ``trace[.i].json`` (it carries ``start_unix_time`` for the
    fallback alignment); ``--from-spans`` (or a missing trace.json — a
    run still in flight) reads the live ``spans[.i].jsonl`` spill."""
    procs: dict[int, dict] = {}
    names = sorted(os.listdir(run_dir))
    for name in names:
        if name.endswith(".prev"):
            continue  # a relaunched worker's rotated prior incarnation
        m = _TRACE_RE.match(name)
        if m and not from_spans:
            idx = int(m.group(1) or 0)
            events, other = _load_trace_json(os.path.join(run_dir, name))
            procs[idx] = {"events": events, "other": other,
                          "source": name}
    for name in names:
        if name.endswith(".prev"):
            continue
        m = _SPANS_RE.match(name)
        if not m:
            continue
        idx = int(m.group(1) or 0)
        if idx in procs and procs[idx]["events"]:
            continue  # trace.json already covered this process
        events = _load_spans_jsonl(os.path.join(run_dir, name), idx)
        if events:
            procs[idx] = {"events": events, "other": {}, "source": name}
    return procs


def _load_exemplar_events(path: str) -> list[dict]:
    """UNSAMPLED exemplar records' span events → Chrome "X" events.
    Sampled exemplars already live in the span stream (head sampling
    let them through), so only the unsampled slowest-N trees — the
    requests the sampler skipped — are added to the track."""
    events: list[dict] = []
    try:
        fh = open(path)
    except OSError:
        return events
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail line from an in-flight rewrite
            if not isinstance(rec, dict) or rec.get("sampled"):
                continue
            for e in rec.get("events") or []:
                if not isinstance(e, dict) or "name" not in e \
                        or "ts_us" not in e:
                    continue
                events.append({"name": e["name"], "cat": "photon",
                               "ph": "X", "ts": e["ts_us"],
                               "dur": e.get("dur_us", 0.0),
                               "tid": e.get("tid", 0),
                               "args": e.get("labels") or {}})
    return events


def discover_fleet(fleet_dir: str, from_spans: bool = False
                   ) -> dict[int, dict]:
    """:func:`discover_processes` over a supervisor fleet layout
    (``router/`` + ``member<k>/`` run-dir subdirectories), flattened
    onto sequential merged pids: router first, then members by index.
    Each member's unsampled exemplar span trees join its track."""
    subs: list[tuple[int, str]] = []
    for name in sorted(os.listdir(fleet_dir)):
        m = _FLEET_SUB_RE.match(name)
        if m and os.path.isdir(os.path.join(fleet_dir, name)):
            order = -1 if m.group(1) is None else int(m.group(1))
            subs.append((order, name))
    subs.sort()
    procs: dict[int, dict] = {}
    pid = 0
    for _, sub in subs:
        sub_dir = os.path.join(fleet_dir, sub)
        try:
            sub_procs = discover_processes(sub_dir, from_spans=from_spans)
        except (OSError, ValueError):
            continue  # a half-written member dir must not sink the rest
        exemplars = _load_exemplar_events(
            os.path.join(sub_dir, "exemplars.jsonl"))
        for idx in sorted(sub_procs):
            p = sub_procs[idx]
            if exemplars:
                # exemplar events share the serve process's tracer
                # epoch, so they land on its (single-process) track
                p["events"] = p["events"] + exemplars
                exemplars = []
            p["source"] = f"{sub}/{p['source']}"
            p["role"] = sub if len(sub_procs) == 1 else f"{sub}.{idx}"
            procs[pid] = p
            pid += 1
    return procs


def _anchor_us(events: list[dict], anchor: str) -> float | None:
    """END of the process's FIRST anchor span (the gang-formation
    barrier: every process leaves the gloo group's formation at the
    same instant, so span end — not start — is the shared point)."""
    best = None
    for e in events:
        if e["name"] == anchor:
            if best is None or e["ts"] < best["ts"]:
                best = e
    if best is None:
        return None
    return float(best["ts"]) + float(best.get("dur", 0.0))


def merge(procs: dict[int, dict], anchor: str = DEFAULT_ANCHOR,
          warn=None) -> dict:
    """One Chrome-trace document: per-process events on their own
    ``pid`` track, timestamps shifted onto a shared clock."""
    anchors = {i: _anchor_us(p["events"], anchor)
               for i, p in procs.items()}
    if all(a is not None for a in anchors.values()) and anchors:
        # align every anchor end to the LATEST one: the barrier releases
        # all processes together, and shifting right keeps every
        # process's own stream non-negative
        target = max(anchors.values())
        shifts = {i: target - a for i, a in anchors.items()}
        alignment = anchor
    elif all("start_unix_time" in p["other"] for p in procs.values()):
        t0 = min(p["other"]["start_unix_time"] for p in procs.values())
        shifts = {i: (p["other"]["start_unix_time"] - t0) * 1e6
                  for i, p in procs.items()}
        alignment = "start_unix"
    else:
        missing = sorted(i for i, a in anchors.items() if a is None)
        if warn is not None:
            warn(f"no {anchor!r} span in process(es) {missing} and no "
                 f"start_unix_time fallback — tracks are NOT aligned")
        shifts = {i: 0.0 for i in procs}
        alignment = "none"

    out: list[dict] = []
    for i in sorted(procs):
        # one named, ordered track per process in the Perfetto UI
        role = procs[i].get("role") or f"process {i}"
        out.append({"ph": "M", "name": "process_name", "pid": i,
                    "args": {"name": f"{role} "
                                     f"({procs[i]['source']})"}})
        out.append({"ph": "M", "name": "process_sort_index", "pid": i,
                    "args": {"sort_index": i}})
        for e in procs[i]["events"]:
            out.append({**e, "pid": i,
                        "ts": float(e["ts"]) + shifts[i]})
    xs = [e for e in out if e["ph"] == "X"]
    xs.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": [e for e in out if e["ph"] == "M"] + xs,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged_processes": sorted(procs),
            "alignment": alignment,
            "anchor_span": anchor,
            "shifts_us": {str(i): shifts[i] for i in sorted(shifts)},
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="merge per-process traces from a multi-host "
                    "--trace-dir into one Perfetto-loadable timeline "
                    "(one track per process, clock-aligned on gang.form)")
    p.add_argument("run_dir", help="the run's --trace-dir")
    p.add_argument("--out", default=None,
                   help="output path (default: "
                        "<run_dir>/merged_trace.json)")
    p.add_argument("--anchor", default=DEFAULT_ANCHOR,
                   help="span name whose END is the shared clock anchor "
                        f"(default: {DEFAULT_ANCHOR})")
    p.add_argument("--from-spans", action="store_true",
                   help="read the live spans[.i].jsonl spill instead of "
                        "the rebuilt trace[.i].json (a run still in "
                        "flight)")
    p.add_argument("--fleet", action="store_true",
                   help="treat run_dir as a serve fleet dir (router/ + "
                        "member<k>/ subdirectories); auto-detected when "
                        "the dir itself holds no trace streams")
    ns = p.parse_args(argv)
    try:
        if ns.fleet:
            procs = discover_fleet(ns.run_dir, from_spans=ns.from_spans)
        else:
            procs = discover_processes(ns.run_dir,
                                       from_spans=ns.from_spans)
            if not any(p_["events"] for p_ in procs.values()):
                fleet = discover_fleet(ns.run_dir,
                                       from_spans=ns.from_spans)
                if fleet:
                    procs = fleet
    except (OSError, ValueError) as e:
        print(f"trace_merge: cannot read {ns.run_dir}: {e}",
              file=sys.stderr)
        return 2
    procs = {i: p_ for i, p_ in procs.items() if p_["events"]}
    if not procs:
        print(f"trace_merge: no per-process trace/spans streams with "
              f"events under {ns.run_dir}", file=sys.stderr)
        return 2
    doc = merge(procs, anchor=ns.anchor,
                warn=lambda m: print(f"trace_merge: {m}",
                                     file=sys.stderr))
    out_path = ns.out or os.path.join(ns.run_dir, "merged_trace.json")
    with open(out_path, "w") as fh:
        json.dump(doc, fh)
    n_events = sum(len(p_["events"]) for p_ in procs.values())
    print(f"trace_merge: {len(procs)} process track(s), {n_events} "
          f"span(s), alignment={doc['otherData']['alignment']} -> "
          f"{out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
