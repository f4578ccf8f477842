"""OTLP bridge: re-emit a photon run's telemetry as OTLP/HTTP JSON.

Port of ``tools/otlp_bridge.py`` over the port's
:mod:`photon_ml_tpu_torch.obs.otlp`, with the same flags, exit codes and
stderr summary line. It attaches to a run the two ways the port's
``photon_status`` does:

- ``--run-dir DIR`` — read (or, with ``--follow``, tail) the run's
  ``--trace-dir``: spans from ``spans[.i].jsonl``, heartbeat/run-end
  records from ``metrics[.i].jsonl``, manifests for resource
  attributes;
- ``--listen HOST:PORT`` (or ``unix:/path.sock``) — BE the run's
  ``--telemetry-endpoint`` consumer and convert the NDJSON stream as
  it arrives.

Converted documents go to ``--collector URL`` (POST to
``<URL>/v1/traces`` and ``<URL>/v1/metrics`` — any OTLP/HTTP collector:
Grafana Alloy, Jaeger, Tempo, the otel-collector) and/or ``--out
FILE`` (the combined JSON document, golden-fixture friendly).

The collector contract mirrors ``--telemetry-endpoint``'s: a dead,
slow, or flaky collector can only ever cause batches to be DROPPED
(counted, reported on stderr at exit as ``posted=N dropped=M``) — the
bridge always exits 0 once it has read its input, and the run it
watches is never affected (the ``obs.otlp`` cells of
:mod:`photon_ml_tpu_torch.tools.chaos_drill` prove both). Conversion
refuses a ``telemetry_proto`` it has never seen (exit 2) instead of
mis-mapping it.

It imports the stdlib and ``obs/otlp.py`` only (no torch), so it runs on
a bare observer host::

    python -m photon_ml_tpu_torch.tools.otlp_bridge --run-dir out/trace \\
        --collector http://127.0.0.1:4318
    python -m photon_ml_tpu_torch.tools.otlp_bridge --run-dir out/trace \\
        --out run_otlp.json
    python -m photon_ml_tpu_torch.tools.otlp_bridge \\
        --listen 127.0.0.1:9201 --collector http://127.0.0.1:4318 \\
        --for-seconds 30
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

from photon_ml_tpu_torch.obs.otlp import (
    UnsupportedProtoError,
    load_run_dir,
    post_otlp,
    records_to_otlp,
)

EXIT_OK, EXIT_USAGE = 0, 2


def _listen_records(endpoint: str, for_seconds: float) -> list:
    """Bind the endpoint, accept every producer that connects within
    the window, and collect their NDJSON records (one connection at a
    time is enough: drivers connect once and stream)."""
    if endpoint.startswith("unix:"):
        server = socket.socket(socket.AF_UNIX)
        path = endpoint[len("unix:"):]
        if os.path.exists(path):
            os.unlink(path)
        server.bind(path)
    else:
        host, _, port = endpoint.rpartition(":")
        server = socket.socket()
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind((host or "127.0.0.1", int(port)))
    server.listen(4)
    server.settimeout(0.5)
    deadline = time.monotonic() + for_seconds
    records: list = []
    try:
        while time.monotonic() < deadline:
            try:
                conn, _ = server.accept()
            except socket.timeout:
                continue
            with conn:
                conn.settimeout(1.0)
                buf = b""
                while time.monotonic() < deadline:
                    try:
                        chunk = conn.recv(65536)
                    except socket.timeout:
                        continue
                    except OSError:
                        break
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if isinstance(rec, dict):
                            records.append(rec)
    finally:
        server.close()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="convert photon telemetry to OTLP/HTTP JSON")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--run-dir", help="a run's --trace-dir to convert")
    src.add_argument("--listen",
                     help="be the --telemetry-endpoint consumer "
                          "(HOST:PORT or unix:/path.sock)")
    ap.add_argument("--collector",
                    help="OTLP/HTTP collector base URL (POSTs to "
                         "<URL>/v1/traces and <URL>/v1/metrics)")
    ap.add_argument("--out", help="write the combined OTLP JSON document "
                                  "({traces, metrics}) to this file")
    ap.add_argument("--follow", action="store_true",
                    help="with --run-dir: keep re-reading and re-posting "
                         "until a run_end record appears (or "
                         "--for-seconds elapses)")
    ap.add_argument("--for-seconds", type=float, default=10.0,
                    help="--listen window / --follow deadline "
                         "(default 10)")
    ap.add_argument("--poll-seconds", type=float, default=1.0,
                    help="--follow re-read cadence (default 1)")
    ns = ap.parse_args(argv)
    if not ns.collector and not ns.out:
        ap.error("nothing to do: pass --collector and/or --out")

    stats = {"posted": 0, "dropped": 0}

    def convert_and_ship(records) -> dict:
        docs = records_to_otlp(records)
        if ns.collector:
            r = post_otlp(docs, ns.collector)
            stats["posted"] += r["posted"]
            stats["dropped"] += r["dropped"]
        return docs

    try:
        if ns.listen:
            records = _listen_records(ns.listen, ns.for_seconds)
            docs = convert_and_ship(records)
        elif ns.follow:
            deadline = time.monotonic() + ns.for_seconds
            docs = {}
            while True:
                records = load_run_dir(ns.run_dir)
                docs = convert_and_ship(records)
                ended = any(r.get("kind") == "run_end" for r in records)
                if ended or time.monotonic() >= deadline:
                    break
                time.sleep(ns.poll_seconds)
        else:
            docs = convert_and_ship(load_run_dir(ns.run_dir))
    except UnsupportedProtoError as e:
        print(f"otlp_bridge: {e}", file=sys.stderr)
        return EXIT_USAGE

    if ns.out:
        with open(ns.out, "w") as fh:
            json.dump(docs, fh, indent=1, sort_keys=True)
    spans = sum(len(ss["spans"])
                for rs in docs.get("traces", {}).get("resourceSpans", [])
                for ss in rs["scopeSpans"])
    metrics = sum(len(sm["metrics"])
                  for rm in docs.get("metrics", {}).get(
                      "resourceMetrics", [])
                  for sm in rm["scopeMetrics"])
    print(f"otlp_bridge: {spans} span(s), {metrics} metric(s), "
          f"posted={stats['posted']} dropped={stats['dropped']}",
          file=sys.stderr)
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
