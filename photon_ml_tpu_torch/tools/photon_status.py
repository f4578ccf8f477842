"""photon-top: live run status from the port's telemetry plane.

Port of ``tools/photon_status.py``: ``RunDirTailer`` (``:67``),
``read_run_dir`` (``:152``), ``ListenCollector`` (``:158``),
``_bucket_percentile`` / ``_stage_latency`` / ``_serving_status``
(``:250-360``), ``compute_status`` (``:361``), ``format_gang``
(``:531``), ``format_status`` (``:584``), ``compute_fleet`` (``:636``),
``format_fleet`` (``:749``) and ``main`` (``:803``), with the same
flags, documents and exit codes. It reads the names the port's drivers,
service and router emit, which are the JAX package's. The standard
library only: it imports no torch, so it attaches to a run without
touching the card.

Attaches to a (possibly still-training) GAME run two ways:

- ``--run-dir DIR`` — tail the run's ``--trace-dir``: heartbeat records
  stream into ``metrics[.i].jsonl`` and spans spill into
  ``spans[.i].jsonl`` while the run trains, so the status needs no
  socket at all;
- ``--listen HOST:PORT`` (or ``unix:/path.sock``) — BE the
  ``--telemetry-endpoint`` consumer: bind, let the run's processes
  connect, and read their NDJSON record streams directly.

Reports, per process and in aggregate: sweep / last-coordinate
progress, coordinate updates done, ``host_syncs_per_update`` (the
hot-loop discipline number), in-flight pipeline depth, retry /
quarantine / telemetry-drop counters, and heartbeat stall state.

``--json`` prints one machine-readable status document; ``--watch``
re-renders the human view until the run ends. Exit codes (scripting
contract):

- ``0`` — healthy: running or finished clean
- ``2`` — stalled: a process's latest heartbeat is flagged ``stalled``
- ``3`` — aborted: a ``run_end`` record with status abort/error
- ``4`` — no telemetry found (wrong dir, nothing connected in time)
- ``5`` — preempted: a ``run_end`` record with status ``preempted``
  (graceful stop at a commit barrier; a relaunch resumes — this is
  the "requeue me" state ``photon_ml_tpu_torch/tools/photon_supervise.py``
  reacts to)

``--gang`` adds the gang-level aggregate over a merged multi-process
run dir: min/max per-process sweep position and ``sweep_skew`` (max−min
— 0 for a healthy gang-synchronous run; a growing skew means a process
is reading stale telemetry or a member died mid-sweep). ``--fleet``
folds a ``photon_supervise --fleet`` directory.

One difference from the JAX tool's tailer: it also notices a file
REPLACED under it (a new inode, as when a relaunched incarnation
rotates ``spans.jsonl`` to ``.prev``) and reads the new file from its
start, where the JAX tailer notices only a file that shrank; and
``RunDirTailer(run_dir, from_end=True)`` starts past what the files
hold already, so a supervisor's view of a new incarnation holds only
what was written after its launch. Neither changes a status computed
from the same records.

Usage::

    python -m photon_ml_tpu_torch.tools.photon_status --run-dir out/trace --json
    python -m photon_ml_tpu_torch.tools.photon_status \
        --listen 127.0.0.1:9200 --for-seconds 30
        # then start the run with --telemetry-endpoint 127.0.0.1:9200
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import threading
import time

_METRICS_RE = re.compile(r"^metrics(?:\.(\d+))?\.jsonl$")
_TELEMETRY_RE = re.compile(r"^telemetry(?:\.(\d+))?\.jsonl$")
_SPANS_RE = re.compile(r"^spans(?:\.(\d+))?\.jsonl$")

EXIT_HEALTHY, EXIT_STALLED, EXIT_ABORTED, EXIT_NO_DATA = 0, 2, 3, 4
EXIT_PREEMPTED = 5


# ---------------------------------------------------------------------------
# Record collection
# ---------------------------------------------------------------------------


class RunDirTailer:
    """Incremental run-dir reader: heartbeat / counter / run_end lines
    from ``metrics[.i].jsonl`` (and the ``telemetry[.i].jsonl`` fallback
    stream), span records from the live ``spans[.i].jsonl`` spill.

    Each :meth:`poll` reads only the bytes appended since the previous
    one (per-file offsets, advanced past COMPLETE lines only — a torn
    live tail is re-read whole once finished), so ``--watch`` over a
    long run costs O(new data) per tick, not a full re-parse of every
    stream."""

    def __init__(self, run_dir: str, from_end: bool = False):
        self.run_dir = run_dir
        self._offsets: dict[str, int] = {}
        self._inodes: dict[str, int] = {}
        self._records: list[dict] = []
        if from_end:
            # a supervisor's view of a NEW incarnation: what the files
            # hold now belongs to an earlier one (its stalled heartbeats
            # and run_end must not pass for the new process's)
            for _, path in self._streams():
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                self._offsets[path] = st.st_size
                self._inodes[path] = st.st_ino

    def _streams(self) -> list[tuple[str, str]]:
        try:
            names = sorted(os.listdir(self.run_dir))
        except OSError:
            return []
        return [(name, os.path.join(self.run_dir, name)) for name in names
                if not name.endswith(".prev")
                and (_METRICS_RE.match(name) or _TELEMETRY_RE.match(name)
                     or _SPANS_RE.match(name))]

    def _tail_file(self, path: str, default_kind: str | None,
                   process_index: int, skip_kinds: tuple = ()) -> None:
        offset = self._offsets.get(path, 0)
        try:
            with open(path, "rb") as fh:
                inode = os.fstat(fh.fileno()).st_ino
                fh.seek(0, os.SEEK_END)
                if fh.tell() < offset or inode != self._inodes.get(
                        path, inode):
                    # the file SHRANK or was REPLACED under us: a
                    # relaunched incarnation truncated/rotated it — start
                    # over at 0 rather than silently never reading (or
                    # reading from the middle of) the new stream
                    offset = 0
                fh.seek(offset)
                chunk = fh.read()
        except OSError:
            return
        self._inodes[path] = inode
        self._offsets[path] = offset
        if not chunk:
            return
        complete, sep, _tail = chunk.rpartition(b"\n")
        if not sep:
            return  # no finished line yet; keep the offset
        self._offsets[path] = offset + len(complete) + 1
        for line in complete.split(b"\n"):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a torn line from a killed incarnation
            if not isinstance(rec, dict):
                continue
            if "kind" not in rec:
                if default_kind is None:
                    continue
                rec["kind"] = default_kind
            if rec["kind"] in skip_kinds:
                continue
            rec.setdefault("process_index", process_index)
            self._records.append(rec)

    def poll(self) -> list[dict]:
        """All records seen so far (previous polls' plus any new)."""
        for name, path in self._streams():
            m = _METRICS_RE.match(name)
            if m:
                self._tail_file(path, None, int(m.group(1) or 0))
                continue
            m = _TELEMETRY_RE.match(name)
            if m:
                # the fallback stream duplicates what the run ALSO
                # writes to spans.jsonl (every span is spilled to the
                # file regardless of the sink) — skip its span records
                # so updates/sweep counts stay exactly-once
                self._tail_file(path, None, int(m.group(1) or 0),
                                skip_kinds=("span",))
                continue
            m = _SPANS_RE.match(name)
            if m:
                self._tail_file(path, "span", int(m.group(1) or 0))
        return list(self._records)


def read_run_dir(run_dir: str) -> list[dict]:
    """One-shot view of a run dir's records (the --run-dir snapshot
    path; --watch holds a RunDirTailer and polls it instead)."""
    return RunDirTailer(run_dir).poll()


class ListenCollector:
    """The ``--telemetry-endpoint`` consumer side: accept connections,
    parse NDJSON lines, accumulate records (thread-safe)."""

    def __init__(self, listen: str):
        self._lock = threading.Lock()
        self._records: list[dict] = []
        self.ended = threading.Event()
        if listen.startswith("unix:"):
            path = listen[len("unix:"):]
            if os.path.exists(path):
                os.unlink(path)
            self._server = socket.socket(socket.AF_UNIX,
                                         socket.SOCK_STREAM)
            self._server.bind(path)
        else:
            host, _, port = listen.rpartition(":")
            self._server = socket.socket(socket.AF_INET,
                                         socket.SOCK_STREAM)
            self._server.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_REUSEADDR, 1)
            self._server.bind((host or "127.0.0.1", int(port)))
        self._server.listen(8)
        self._server.settimeout(0.2)
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._read_conn, args=(conn,),
                             daemon=True).start()

    def _read_conn(self, conn: socket.socket) -> None:
        buf = b""
        conn.settimeout(0.5)
        while not self._stop.is_set():
            try:
                chunk = conn.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            *lines, buf = buf.split(b"\n")
            for line in lines:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    with self._lock:
                        self._records.append(rec)
                    if rec.get("kind") == "run_end":
                        self.ended.set()
        conn.close()

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def close(self) -> None:
        self._stop.set()
        try:
            self._server.close()
        except OSError:
            pass
        # the accept loop wakes within its 0.2 s accept timeout
        self._accept_thread.join(timeout=1.0)


# ---------------------------------------------------------------------------
# Status computation
# ---------------------------------------------------------------------------


def _as_int_label(value) -> int | None:
    try:
        return int(value)
    except (TypeError, ValueError):
        return None


def _bucket_percentile(series: dict, q: float):
    """Upper-bound percentile estimate from one cumulative ``le``
    bucket record (``{"count", "max", "buckets": {"le_X": cum}}``):
    the smallest bucket bound covering ``q`` of the observations, or
    the observed max when the quantile lands in the overflow bucket."""
    count = int(series.get("count", 0) or 0)
    buckets = series.get("buckets") or {}
    if not count or not buckets:
        return None
    target = q * count
    bounds = []
    for key, cum in buckets.items():
        if key == "le_inf":
            continue
        try:
            bounds.append((float(key[len("le_"):]), cum))
        except ValueError:
            continue
    for bound, cum in sorted(bounds):
        if cum >= target:
            return bound
    return series.get("max")


#: Request-pipeline order for the serve_stage_ms breakdown (member
#: stages in wall-clock order, then the router's routing stages).
_STAGE_ORDER = ("queue_wait", "batch_form", "tier_gather",
                "device_score", "reply", "route.dispatch",
                "route.member_wait")


def _stage_key(stage: str):
    try:
        return (_STAGE_ORDER.index(stage), stage)
    except ValueError:
        return (len(_STAGE_ORDER), stage)


def _stage_latency(totals: dict):
    """Per-stage latency estimates from the ``serve_stage_ms{stage}``
    histogram series riding the heartbeat ``metric_totals`` — the
    ``photon_status --fleet`` per-stage breakdown needs no span
    stream, just the compact per-heartbeat snapshot. The raw
    cumulative buckets ride along so the fleet view can merge members
    before estimating fleet-wide percentiles."""
    entry = totals.get("serve_stage_ms")
    if not isinstance(entry, dict):
        return None
    out = {}
    for s in entry.get("series") or []:
        stage = (s.get("labels") or {}).get("stage")
        if stage is None:
            continue
        count = int(s.get("count", 0) or 0)
        out[stage] = {
            "count": count,
            "sum": s.get("sum", 0.0),
            "mean_ms": (round(s.get("sum", 0.0) / count, 3)
                        if count else None),
            "p50_ms": _bucket_percentile(s, 0.50),
            "p99_ms": _bucket_percentile(s, 0.99),
            "max_ms": s.get("max"),
            "buckets": s.get("buckets") or {},
        }
    return out or None


def _serving_status(p: dict, totals: dict):
    """The scoring-service sub-dict (photon_ml_tpu_torch/serve): SLO gauges
    and shed/tier counters ride the heartbeat metric_totals; the model
    generation, model id, and last hot-swap outcome ride the
    ``serve.generation`` / ``serve.swap`` spans (strings can't live in
    the label-summed totals). None for processes that aren't serving."""
    gen_span = p.pop("_serve_gen", None)
    swap_span = p.pop("_serve_swap", None)
    queue_wait = p.pop("_serve_queue_wait", None)
    if (totals.get("serve_rows_scored") is None
            and totals.get("serve_qps") is None
            and totals.get("serve_generation") is None
            and totals.get("serve_stage_ms") is None
            and gen_span is None):
        return None
    generation = totals.get("serve_generation")
    if generation is None and swap_span is not None:
        generation = _as_int_label(swap_span.get("generation"))
    if generation is None and gen_span is not None:
        generation = _as_int_label(gen_span.get("generation"))
    model_id = (swap_span or gen_span or {}).get("model_id")
    return {
        "qps": totals.get("serve_qps"),
        "p50_ms": totals.get("serve_p50_ms"),
        "p99_ms": totals.get("serve_p99_ms"),
        "queue_depth": totals.get("serve_queue_depth"),
        "rows_scored": totals.get("serve_rows_scored"),
        "shed": totals.get("serve_shed", 0),
        "tier_hits": totals.get("serve_tier_hits"),
        "generation": int(generation) if generation is not None else None,
        "model_id": model_id,
        "last_swap": ({"outcome": swap_span.get("outcome"),
                       "reason": swap_span.get("reason") or ""}
                      if swap_span else None),
        # per-stage request-pipeline latency (serve_stage_ms heartbeat
        # series) plus the live sampled queue-wait spans — the
        # "where inside the member did the time go" columns
        "stages": _stage_latency(totals),
        "queue_wait_spans": queue_wait["count"] if queue_wait else 0,
        "queue_wait_max_ms": (round(queue_wait["max_us"] / 1e3, 3)
                              if queue_wait else None),
    }


def compute_status(records: list[dict]) -> dict:
    """Fold a record stream into the run-status document. Pure function
    of the records — the run-dir and socket paths share it."""
    procs: dict[int, dict] = {}

    def proc(i) -> dict:
        return procs.setdefault(int(i or 0), {
            "updates": 0, "sweep": None, "last_coordinate": None,
            "heartbeat": None, "run_end": None, "manifest": False,
            "totals": {}, "spans_seen": 0,
        })

    for rec in records:
        kind = rec.get("kind")
        p = proc(rec.get("process_index", 0))
        if kind == "run_manifest":
            p["manifest"] = True
        elif kind == "run_restart":
            # a supervisor relaunch appended to the same metrics stream:
            # everything that follows belongs to a NEW incarnation, so
            # the previous run_end / stalled-heartbeat verdicts no
            # longer describe the live process
            p["run_end"] = None
            p["heartbeat"] = None
        elif kind == "span":
            p["spans_seen"] += 1
            labels = rec.get("labels") or {}
            if rec.get("name") == "cd.update":
                p["updates"] += 1
                if labels.get("coordinate") is not None:
                    p["last_coordinate"] = labels["coordinate"]
            if rec.get("name") in ("cd.update", "cd.sweep", "cd.block"):
                sweep = _as_int_label(labels.get("sweep"))
                if sweep is not None and (p["sweep"] is None
                                          or sweep > p["sweep"]):
                    p["sweep"] = sweep
            # scoring-service markers: the boot generation span and
            # every hot-swap resolution span carry the strings (model
            # id, outcome, reason) the numeric heartbeat totals can't
            if rec.get("name") == "serve.generation":
                p["_serve_gen"] = labels
            elif rec.get("name") == "serve.swap":
                p["_serve_swap"] = labels
            elif rec.get("name") == "serve.queue_wait":
                # sampled queue-wait stage spans: a live (if sampled)
                # view of how long requests sit before batch pickup —
                # the first stage to balloon when a member saturates
                qw = p.setdefault("_serve_queue_wait",
                                  {"count": 0, "max_us": 0.0})
                qw["count"] += 1
                qw["max_us"] = max(qw["max_us"],
                                   float(rec.get("dur_us", 0.0) or 0.0))
        elif kind == "heartbeat":
            p["heartbeat"] = rec
            p["totals"].update(rec.get("metric_totals") or {})
        elif kind in ("counter", "gauge"):
            # the exit snapshot: one line per label set — sum by name
            # (it lands after the last heartbeat, so it wins)
            name = rec.get("name")
            if name:
                snap = p.setdefault("_snap", {})
                snap[name] = snap.get(name, 0.0) \
                    + (rec.get("value", 0.0) or 0.0)
                if name == "re_shard_hbm_live_bytes":
                    # keep the per-device breakdown (labelled by shard)
                    # alongside the summed total — the --gang view
                    # renders it so one device ballooning inside a
                    # mesh-sharded RE solve is visible per member
                    shard = (rec.get("labels") or {}).get("shard")
                    if shard is not None:
                        p.setdefault("_shard_hbm", {})[str(shard)] = \
                            rec.get("value", 0.0) or 0.0
        elif kind == "run_end":
            p["run_end"] = rec
            p["totals"].update(rec.get("metric_totals") or {})

    out_procs = {}
    agg = {"updates": 0, "max_sweep": None, "min_sweep": None}
    worst = "no_data"
    # preempted ranks between running and stalled: it means "requeue
    # me" (the run is healthy but needs a relaunch), not a failure —
    # but any stalled/aborted member still dominates the verdict
    rank = {"no_data": 0, "finished": 1, "running": 2, "preempted": 3,
            "stalled": 4, "aborted": 5}
    for i, p in sorted(procs.items()):
        totals = dict(p["totals"])
        totals.update(p.pop("_snap", {}))
        hb = p["heartbeat"]
        end = p["run_end"]
        if end is not None:
            state = {"ok": "finished",
                     "preempted": "preempted"}.get(end.get("status"),
                                                   "aborted")
        elif hb is not None and hb.get("stalled"):
            state = "stalled"
        elif hb is not None or p["spans_seen"] or p["manifest"]:
            state = "running"
        else:
            state = "no_data"
        updates = p["updates"]
        fetches = totals.get("host_fetches")
        out_procs[i] = {
            "state": state,
            "sweep": p["sweep"],
            "last_coordinate": p["last_coordinate"],
            "updates": updates,
            "host_syncs_per_update": (
                round(fetches / updates, 3)
                if fetches is not None and updates else None),
            "inflight_pipeline_depth": totals.get("cd_inflight_updates"),
            "retries": totals.get("retries", 0),
            "quarantined_coordinates": totals.get("quarantines", 0),
            "quarantined_shards": totals.get("quarantined_shards", 0),
            "telemetry_dropped": totals.get("telemetry_dropped", 0),
            "hbm_live_bytes": totals.get("hbm_live_bytes"),
            "peak_hbm_bytes": (end or {}).get("peak_hbm_bytes"),
            "re_entity_shards": (
                int(totals["re_entity_shards"])
                if totals.get("re_entity_shards") is not None else None),
            "re_shard_hbm_live_bytes": p.pop("_shard_hbm", None),
            "stalls": totals.get("stalls", 0),
            "data_coverage": totals.get("data_coverage"),
            # scoring-service SLOs (photon_ml_tpu_torch/serve): the service's
            # qps/latency gauges and shed/tier counters ride the same
            # heartbeat metric_totals as training metrics, so a serve
            # process monitors through this tool unchanged
            "serving": _serving_status(p, totals),
            "stalled": bool(hb and hb.get("stalled")),
            "last_heartbeat_uptime_s": (hb or {}).get("uptime_s"),
            "spans_seen": p["spans_seen"],
            "run_end": ({"status": end.get("status"),
                         "reason": end.get("reason", "")}
                        if end else None),
        }
        agg["updates"] += updates
        if p["sweep"] is not None:
            if (agg["max_sweep"] is None
                    or p["sweep"] > agg["max_sweep"]):
                agg["max_sweep"] = p["sweep"]
            if (agg["min_sweep"] is None
                    or p["sweep"] < agg["min_sweep"]):
                agg["min_sweep"] = p["sweep"]
        if rank[state] > rank[worst]:
            worst = state
    exit_code = {
        "no_data": EXIT_NO_DATA, "finished": EXIT_HEALTHY,
        "running": EXIT_HEALTHY, "preempted": EXIT_PREEMPTED,
        "stalled": EXIT_STALLED, "aborted": EXIT_ABORTED,
    }[worst]
    return {
        "kind": "run_status",
        "status": worst,
        "exit_code": exit_code,
        "sweep": agg["max_sweep"],
        "updates": agg["updates"],
        # gang-level aggregate (--gang view; trivially degenerate for a
        # single-process run): per-process sweep spread. sweep_skew is
        # max−min — 0 when the gang is marching in lockstep
        "gang": {
            "processes": len(out_procs),
            "min_sweep": agg["min_sweep"],
            "max_sweep": agg["max_sweep"],
            "sweep_skew": (agg["max_sweep"] - agg["min_sweep"]
                           if agg["max_sweep"] is not None
                           and agg["min_sweep"] is not None else None),
        },
        "processes": out_procs,
    }


def format_gang(status: dict, source: str) -> str:
    """The --gang view: one aggregate line over the merged multi-host
    run dir — where the slowest and fastest members are and how far
    apart (sweep_skew; a gang-synchronous run holds it at 0)."""
    g = status["gang"]
    lines = [f"photon-top --gang — {source}: "
             f"{status['status'].upper()}",
             f"  processes : {g['processes']}",
             f"  min sweep : "
             f"{g['min_sweep'] if g['min_sweep'] is not None else '—'}",
             f"  max sweep : "
             f"{g['max_sweep'] if g['max_sweep'] is not None else '—'}",
             f"  sweep_skew: "
             f"{g['sweep_skew'] if g['sweep_skew'] is not None else '—'}"]
    per = {i: (p["sweep"], p["state"])
           for i, p in sorted(status["processes"].items())}
    lines.append("  per-proc  : " + ", ".join(
        f"p{i}={s if s is not None else '—'}({st})"
        for i, (s, st) in per.items()))
    # per-process device-memory + drop columns: a member leaking HBM
    # (or silently shedding telemetry) shows up here before it shows
    # up as skew or a stall
    header = (f"  {'proc':>6} {'hbm_live_bytes':>15} "
              f"{'re_shards':>9} {'telemetry_dropped':>18}")
    lines.append(header)
    for i, p in sorted(status["processes"].items()):
        hbm = p.get("hbm_live_bytes")
        shards = p.get("re_entity_shards")
        lines.append(
            f"  {'p%d' % i:>6} "
            f"{_fmt_bytes(hbm) if hbm is not None else '—':>15} "
            f"{shards if shards is not None else '—':>9} "
            f"{p.get('telemetry_dropped', 0):>18.0f}")
        # per-device HBM under a mesh-sharded RE solve: a skewed row
        # here means one shard's entity blocks (or its padding) are
        # out-sized relative to its peers
        per_shard = p.get("re_shard_hbm_live_bytes") or {}
        for dev, b in sorted(per_shard.items(),
                             key=lambda kv: _as_int_label(kv[0]) or 0):
            lines.append(f"  {'':>6}   shard[{dev}] "
                         f"{_fmt_bytes(b)}")
    return "\n".join(lines)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return (f"{n:.0f}{unit}" if unit == "B"
                    else f"{n:.1f}{unit}")
        n /= 1024.0
    return f"{n:.1f}TiB"


def format_status(status: dict, source: str) -> str:
    lines = [f"photon-top — {source}: {status['status'].upper()} "
             f"(sweep {status['sweep']}, "
             f"{status['updates']} update(s))"]
    header = (f"{'proc':>4} {'state':<9} {'sweep':>5} "
              f"{'coordinate':<14} {'updates':>7} {'syncs/upd':>9} "
              f"{'inflight':>8} {'retries':>7} {'quar':>5} "
              f"{'dropped':>7} {'stalled':>7}")
    lines.append(header)
    lines.append("-" * len(header))
    for i, p in sorted(status["processes"].items()):
        quar = (p["quarantined_coordinates"] or 0) \
            + (p["quarantined_shards"] or 0)
        lines.append(
            f"{i:>4} {p['state']:<9} "
            f"{p['sweep'] if p['sweep'] is not None else '—':>5} "
            f"{str(p['last_coordinate'] or '—'):<14} "
            f"{p['updates']:>7} "
            f"{p['host_syncs_per_update'] if p['host_syncs_per_update'] is not None else '—':>9} "
            f"{p['inflight_pipeline_depth'] if p['inflight_pipeline_depth'] is not None else '—':>8} "
            f"{p['retries']:>7.0f} {quar:>5.0f} "
            f"{p['telemetry_dropped']:>7.0f} "
            f"{'YES' if p['stalled'] else 'no':>7}")
        if p.get("serving"):
            s = p["serving"]
            swap = s.get("last_swap")
            swap_col = (f" swap={swap['outcome']}"
                        f"{'(' + swap['reason'][:40] + ')' if swap.get('reason') else ''}"
                        if swap else "")
            gen_col = (f" gen={s['generation']}"
                       f"[{s['model_id']}]" if s.get("generation")
                       is not None else "")
            lines.append(
                f"     └ serving:{gen_col} qps={s['qps'] or 0:.1f} "
                f"p50={s['p50_ms'] or 0:.1f}ms "
                f"p99={s['p99_ms'] or 0:.1f}ms "
                f"queue={s['queue_depth'] or 0:.0f} "
                f"rows={s['rows_scored'] or 0:.0f} "
                f"shed={s['shed'] or 0:.0f}{swap_col}")
        if p["run_end"] and p["run_end"]["status"] != "ok":
            lines.append(f"     └ run_end: {p['run_end']['status']} "
                         f"{p['run_end']['reason']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Fleet aggregation
# ---------------------------------------------------------------------------

_MEMBER_DIR_RE = re.compile(r"^member(\d+)$")


def compute_fleet(fleet_dir: str) -> dict:
    """Fold a ``photon_supervise --fleet`` directory (``member<k>/``
    telemetry dirs plus an optional ``router/``) into one fleet-status
    document: per-member serving rows, the aggregate line, and the
    scripting verdict — a single stalled member makes the whole fleet
    exit :data:`EXIT_STALLED`, because a stalled member is exactly the
    black-hole risk the router's health machine exists to contain."""
    members = []
    router = None
    try:
        names = sorted(os.listdir(fleet_dir))
    except OSError:
        names = []
    for name in names:
        path = os.path.join(fleet_dir, name)
        if not os.path.isdir(path):
            continue
        m = _MEMBER_DIR_RE.match(name)
        if m:
            members.append((int(m.group(1)), path))
        elif name == "router":
            router = path

    def summarize(role, path) -> dict:
        status = compute_status(read_run_dir(path))
        # a member/router is one process; fold the (rare) multi-proc
        # case by taking the worst state and summing the serving rows
        states = [p["state"] for p in status["processes"].values()] \
            or ["no_data"]
        rank = {"no_data": 0, "finished": 1, "running": 2,
                "preempted": 3, "stalled": 4, "aborted": 5}
        serving = next(
            (p["serving"] for _, p in sorted(status["processes"].items())
             if p.get("serving")), None) or {}
        return {
            "member": role,
            "state": max(states, key=lambda s: rank[s]),
            "stalled": any(p["stalled"]
                           for p in status["processes"].values()),
            "qps": serving.get("qps"),
            "p99_ms": serving.get("p99_ms"),
            "rows_scored": serving.get("rows_scored"),
            "tier_hits": serving.get("tier_hits"),
            "shed": serving.get("shed"),
            "generation": serving.get("generation"),
            "model_id": serving.get("model_id"),
            "stages": serving.get("stages"),
        }

    fleet = [summarize(k, path) for k, path in sorted(members)]
    router_row = summarize("router", router) if router else None
    rows = fleet + ([router_row] if router_row else [])
    # fleet-wide per-stage latency: merge every process's cumulative
    # serve_stage_ms buckets (identical bounds by construction — one
    # registration site), THEN estimate percentiles; averaging
    # per-member percentiles would be wrong under skewed load
    stage_agg: dict[str, dict] = {}
    for r in rows:
        for stage, s in (r.get("stages") or {}).items():
            a = stage_agg.setdefault(stage, {"count": 0, "sum": 0.0,
                                             "max": None, "buckets": {}})
            a["count"] += s.get("count", 0) or 0
            a["sum"] += s.get("sum", 0.0) or 0.0
            if s.get("max_ms") is not None:
                a["max"] = (s["max_ms"] if a["max"] is None
                            else max(a["max"], s["max_ms"]))
            for key, cum in (s.get("buckets") or {}).items():
                a["buckets"][key] = a["buckets"].get(key, 0) + cum
    for a in stage_agg.values():
        a["mean_ms"] = (round(a["sum"] / a["count"], 3)
                        if a["count"] else None)
        a["p50_ms"] = _bucket_percentile(a, 0.50)
        a["p99_ms"] = _bucket_percentile(a, 0.99)
        a.pop("buckets")
    generations = sorted({r["generation"] for r in fleet
                          if r["generation"] is not None})
    agg = {
        "members": len(fleet),
        "live": sum(1 for r in fleet
                    if r["state"] in ("running", "finished")),
        "qps": sum(r["qps"] or 0.0 for r in fleet),
        "rows_scored": sum(r["rows_scored"] or 0 for r in fleet),
        "tier_hits": sum(r["tier_hits"] or 0 for r in fleet),
        "shed": sum(r["shed"] or 0 for r in fleet),
        "p99_ms": max((r["p99_ms"] for r in fleet
                       if r["p99_ms"] is not None), default=None),
        # >1 live generation = a split fleet — exactly what the
        # router's generation-checked re-admission prevents
        "generations": generations,
        "stages": stage_agg or None,
    }
    if not rows:
        status, exit_code = "no_data", EXIT_NO_DATA
    elif any(r["stalled"] for r in rows):
        status, exit_code = "stalled", EXIT_STALLED
    elif any(r["state"] == "aborted" for r in rows):
        status, exit_code = "aborted", EXIT_ABORTED
    elif all(r["state"] == "no_data" for r in rows):
        status, exit_code = "no_data", EXIT_NO_DATA
    else:
        status, exit_code = "running", EXIT_HEALTHY
        if all(r["state"] in ("finished", "no_data") for r in rows):
            status = "finished"
    return {
        "kind": "fleet_status",
        "status": status,
        "exit_code": exit_code,
        "aggregate": agg,
        "router": router_row,
        "fleet": fleet,
    }


def format_fleet(status: dict, source: str) -> str:
    agg = status["aggregate"]
    lines = [f"photon-top --fleet — {source}: "
             f"{status['status'].upper()} "
             f"({agg['live']}/{agg['members']} member(s) live)"]
    header = (f"{'member':>7} {'state':<9} {'gen':>4} "
              f"{'model':<12} {'qps':>8} {'p99_ms':>7} "
              f"{'rows':>9} {'tier_hits':>9} {'shed':>5} "
              f"{'stalled':>7}")
    lines.append(header)
    lines.append("-" * len(header))
    rows = list(status["fleet"])
    if status.get("router"):
        rows.append(status["router"])
    for r in rows:
        lines.append(
            f"{str(r['member']):>7} {r['state']:<9} "
            f"{r['generation'] if r['generation'] is not None else '—':>4} "
            f"{str(r['model_id'] or '—')[:12]:<12} "
            f"{r['qps'] if r['qps'] is not None else 0:>8.1f} "
            f"{r['p99_ms'] if r['p99_ms'] is not None else 0:>7.1f} "
            f"{r['rows_scored'] or 0:>9.0f} "
            f"{r['tier_hits'] or 0:>9.0f} "
            f"{r['shed'] or 0:>5.0f} "
            f"{'YES' if r['stalled'] else 'no':>7}")
    gens = agg["generations"]
    lines.append(
        f"  aggregate: qps={agg['qps']:.1f} "
        f"p99={agg['p99_ms'] if agg['p99_ms'] is not None else 0:.1f}ms "
        f"rows={agg['rows_scored']:.0f} "
        f"tier_hits={agg['tier_hits']:.0f} shed={agg['shed']:.0f} "
        f"generations={','.join(str(g) for g in gens) or '—'}"
        f"{' SPLIT-FLEET' if len(gens) > 1 else ''}")
    stages = agg.get("stages")
    if stages:
        lines.append("  stage latency (serve_stage_ms, fleet-wide):")
        lines.append(f"  {'stage':<18} {'count':>8} {'mean_ms':>8} "
                     f"{'p50_ms':>8} {'p99_ms':>8} {'max_ms':>8}")
        for stage in sorted(stages, key=_stage_key):
            s = stages[stage]
            lines.append(
                f"  {stage:<18} {s['count']:>8} "
                f"{s['mean_ms'] if s['mean_ms'] is not None else 0:>8.3f} "
                f"{s['p50_ms'] if s['p50_ms'] is not None else 0:>8.3f} "
                f"{s['p99_ms'] if s['p99_ms'] is not None else 0:>8.3f} "
                f"{s['max'] if s['max'] is not None else 0:>8.3f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="live run status from the telemetry plane "
                    "(exit 0 healthy / 2 stalled / 3 aborted / "
                    "4 no telemetry / 5 preempted)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--run-dir",
                     help="the run's --trace-dir: tail its metrics/"
                          "spans/telemetry streams")
    src.add_argument("--listen",
                     help="bind HOST:PORT (or unix:/path.sock) and "
                          "consume the run's --telemetry-endpoint "
                          "stream directly")
    p.add_argument("--for-seconds", type=float, default=10.0,
                   help="listen mode: collect records this long (or "
                        "until a run_end arrives) before reporting")
    p.add_argument("--watch", action="store_true",
                   help="re-render every 2 s until the run ends")
    p.add_argument("--json", action="store_true",
                   help="print the status document as JSON")
    p.add_argument("--gang", action="store_true",
                   help="gang-level aggregate view: min/max per-process "
                        "sweep and sweep_skew over a merged multi-host "
                        "run dir")
    p.add_argument("--fleet", action="store_true",
                   help="fleet aggregate view over a photon_supervise "
                        "--fleet directory (--run-dir points at the "
                        "--fleet-dir): per-member qps/p99/generation/"
                        "tier-hit rows + the aggregate line; exit 2 if "
                        "ANY member is stalled")
    ns = p.parse_args(argv)

    if ns.fleet:
        if not ns.run_dir:
            p.error("--fleet requires --run-dir (the --fleet-dir)")
        source = f"fleet-dir {ns.run_dir}"
        while True:
            status = compute_fleet(ns.run_dir)
            if ns.watch and not ns.json:
                print("\x1b[2J\x1b[H", end="")  # clear, home
            print(json.dumps(status, indent=1) if ns.json
                  else format_fleet(status, source))
            if not ns.watch or status["status"] in ("finished",
                                                    "aborted"):
                return status["exit_code"]
            time.sleep(2.0)

    if ns.run_dir:
        source = f"run-dir {ns.run_dir}"
        tailer = RunDirTailer(ns.run_dir)

        def snapshot() -> dict:
            return compute_status(tailer.poll())

        ended = None
    else:
        source = f"listening on {ns.listen}"
        collector = ListenCollector(ns.listen)

        def snapshot() -> dict:
            return compute_status(collector.records())

        ended = collector.ended
        if not ns.watch:
            deadline = time.monotonic() + ns.for_seconds
            while time.monotonic() < deadline \
                    and not collector.ended.is_set():
                time.sleep(0.1)

    try:
        while True:
            status = snapshot()
            if ns.watch and not ns.json:
                print("\x1b[2J\x1b[H", end="")  # clear, home
            print(json.dumps(status, indent=1) if ns.json
                  else (format_gang(status, source) if ns.gang
                        else format_status(status, source)))
            if not ns.watch:
                break
            if status["status"] in ("finished", "aborted",
                                    "preempted") or (
                    ended is not None and ended.is_set()):
                break
            time.sleep(2.0)
    finally:
        if ns.listen:
            collector.close()
    return status["exit_code"]


if __name__ == "__main__":
    raise SystemExit(main())
