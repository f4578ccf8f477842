"""Streaming telemetry export: live span/metric/heartbeat records.

Port of ``photon_ml_tpu/obs/export.py`` (``TelemetrySink`` ``:117``,
``TELEMETRY_PROTO``, ``parse_endpoint``): the same line protocol, so a
consumer of either package's stream reads the other's.

The on-line half of the observability layer (``obs/run.py`` is the
flush-at-exit half): a :class:`TelemetrySink` ships records as
line-delimited JSON over a local TCP or Unix socket to whatever consumer
is listening (``tools/photon_status.py`` is the first), with a file-tail
fallback when no consumer ever connects — so a long multi-host run is
watchable WHILE it trains instead of opaque until it exits.

The contract that makes this safe to wire into the CD hot loop:

- :meth:`TelemetrySink.emit` is a **bounded non-blocking enqueue**
  (``put_nowait`` on a bounded queue). A slow, dead, or never-connected
  consumer can only ever cause records to be DROPPED — counted on the
  ``telemetry_dropped{kind=...}`` counter — never block or kill the run.
- All I/O happens on one daemon writer thread: connects and writes go
  through ``utils/retry`` (site ``obs.export``, the registered drillable
  fault point), sends carry a short socket timeout so a consumer that
  stops reading looks like a failed write (dropped, counted), and a
  failed batch marks the connection dead so the next batch reconnects
  under deterministic backoff instead of burning the retry schedule on
  every record.
- Like the rest of ``obs/``: stdlib-only, no torch import, zero device
  work.

Endpoints (``--telemetry-endpoint`` on both GAME drivers):

- ``host:port`` or ``tcp://host:port`` — TCP consumer
- ``unix:/path/to.sock`` (or ``unix:///path``) — Unix-domain consumer
- ``file:/path/out.jsonl`` (or a bare path) — append NDJSON to a file
  (``tail -f``-able; also the fallback target when a socket consumer
  never shows up)

Line protocol (version :data:`TELEMETRY_PROTO`, carried in the run
manifest): one JSON object per ``\\n``-terminated line, every record
tagged ``kind`` ∈ {``run_manifest``, ``span``, ``heartbeat``,
``run_end``} plus ``process_index``; span records carry the
``spans.jsonl`` schema (``name``/``ts_us``/``dur_us``/``tid``/``depth``/
``labels``), heartbeat records the ``metrics.jsonl`` heartbeat schema
(including the ``metric_totals`` snapshot), and the first record on a
stream is the run manifest. A killed producer can tear at most the LAST
line — every complete line always parses.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import threading
import time
from typing import Callable, Optional

from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.utils.faults import fault_point
from photon_ml_tpu_torch.utils.retry import (
    RetryExhaustedError,
    RetryPolicy,
    call_with_retry,
)

#: Telemetry line-protocol version, stamped into every run manifest
#: (file and stream): consumers dispatch on it instead of sniffing
#: record shapes when the schema evolves.
TELEMETRY_PROTO = 1

#: Export retry: short and bounded — telemetry I/O must never stall the
#: run it is observing (same stance as obs/run's flush retry).
_EXPORT_RETRY = RetryPolicy(max_attempts=3, base_delay_seconds=0.01,
                            max_delay_seconds=0.1)

#: Seconds a failed connect blacklists the socket endpoint before the
#: writer tries again (between attempts batches flow to the fallback
#: file, or are dropped+counted when there is none).
_RECONNECT_SECONDS = 2.0

#: Socket send timeout: a consumer that stopped reading (TCP buffers
#: full) looks like a failed write within this bound, so backpressure
#: turns into counted drops instead of a wedged writer thread.
_SEND_TIMEOUT_SECONDS = 0.5

DEFAULT_MAX_QUEUED_RECORDS = 4096


def parse_endpoint(endpoint: str) -> tuple[str, object]:
    """``(scheme, address)`` from an endpoint string: ``("tcp", (host,
    port))``, ``("unix", path)``, or ``("file", path)``.

    Raises ``ValueError`` on an EXPLICIT ``tcp://`` endpoint without a
    valid ``host:port`` — silently treating a typo'd socket address as
    a file path would ship the stream into a file named after the host
    while the intended consumer hears nothing."""
    ep = endpoint.strip()
    if ep.startswith("tcp://"):
        ep = ep[len("tcp://"):]
        host, sep, port = ep.rpartition(":")
        if not (sep and host and port.isdigit()):
            raise ValueError(
                f"telemetry endpoint {endpoint!r}: tcp:// needs "
                f"host:port with a numeric port")
        return "tcp", (host, int(port))
    if ep.startswith("unix://"):
        return "unix", ep[len("unix://"):] or "/"
    elif ep.startswith("unix:"):
        return "unix", ep[len("unix:"):]
    elif ep.startswith("file://"):
        return "file", ep[len("file://"):] or "/"
    elif ep.startswith("file:"):
        return "file", ep[len("file:"):]
    host, sep, port = ep.rpartition(":")
    if sep and host and port.isdigit():
        return "tcp", (host, int(port))
    return "file", ep  # a bare path: file-tail mode


class TelemetrySink:
    """Non-blocking NDJSON record shipper with a daemon writer thread.

    ``emit()`` never blocks and never raises: a full queue (or a closed
    sink) drops the record and counts it on ``telemetry_dropped{kind}``.
    The writer drains the queue in batches and ships them to the
    endpoint; when a socket endpoint cannot be connected (or a batch
    write exhausts its retries) the batch falls back to
    ``fallback_path`` when one is set, else it is dropped (counted).
    """

    def __init__(self, endpoint: str,
                 fallback_path: Optional[str] = None,
                 max_queued_records: int = DEFAULT_MAX_QUEUED_RECORDS,
                 registry: Optional[MetricsRegistry] = None,
                 warn: Optional[Callable[[str], None]] = None):
        self.scheme, self.address = parse_endpoint(endpoint)
        self.endpoint = endpoint
        self.fallback_path = fallback_path
        self._registry = registry or REGISTRY
        self._warn = warn
        # separate warn-once flags: "no consumer, falling back" is
        # expected degradation, "fallback unwritable, dropping" is the
        # serious one — the first must not silence the second
        self._warned_no_consumer = False
        self._warned_drop = False
        self._queue: "queue.Queue[dict]" = queue.Queue(
            maxsize=max_queued_records)
        self._sock: Optional[socket.socket] = None
        self._connect_blocked_until = 0.0
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._writer_loop, name="photon-telemetry", daemon=True)
        self._thread.start()

    # -- producer side (hot-loop safe) ------------------------------------

    def emit(self, record: dict) -> bool:
        """Enqueue one record; NEVER blocks. Returns False (and counts
        the drop) when the queue is full or the sink is closed."""
        if self._closed:
            self._drop(record)
            return False
        try:
            self._queue.put_nowait(record)
            return True
        except queue.Full:
            self._drop(record)
            return False

    def _drop(self, record: dict) -> None:
        self._registry.counter("telemetry_dropped").inc(
            kind=str(record.get("kind", "?")))

    def dropped_total(self) -> float:
        return self._registry.counter("telemetry_dropped").total()

    # -- writer thread -----------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                break
            if batch:
                try:
                    self._ship(batch)
                except Exception as e:  # the writer must outlive any batch
                    for record in batch:
                        self._drop(record)
                    if self._warn is not None:
                        self._warn(f"telemetry: unexpected export "
                                   f"failure, batch dropped: {e!r}")
        self._disconnect()

    def _next_batch(self, max_records: int = 256) -> Optional[list]:
        """Up to ``max_records`` queued records; [] on an idle tick,
        None when stopped AND drained (writer exit)."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return None if self._stop.is_set() else []
        batch = [first]
        while len(batch) < max_records:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def _encode(self, batch: list) -> bytes:
        return b"".join(
            json.dumps(record, default=str).encode("utf-8") + b"\n"
            for record in batch)

    def _ship(self, batch: list) -> None:
        payload = self._encode(batch)
        if self.scheme != "file" and self._ensure_connected():
            try:
                call_with_retry(lambda: self._send(payload),
                                site="obs.export", policy=_EXPORT_RETRY)
                return
            # OSError too: FileNotFoundError (a unix socket path that
            # never existed) is permanent to the retry layer and
            # propagates unwrapped
            except (RetryExhaustedError, OSError):
                # consumer died / stopped reading mid-run: blacklist the
                # endpoint briefly; this batch (and the next ones, until
                # the blackout lapses) flow to the fallback file
                self._disconnect()
                self._connect_blocked_until = (
                    time.monotonic() + _RECONNECT_SECONDS)
        if self.scheme == "file":
            target: Optional[str] = str(self.address)
        else:
            target = self.fallback_path
        if target is None:
            for record in batch:
                self._drop(record)
            return
        try:
            call_with_retry(lambda: self._append(target, payload),
                            site="obs.export", policy=_EXPORT_RETRY)
        except (RetryExhaustedError, OSError) as e:
            for record in batch:
                self._drop(record)
            if not self._warned_drop and self._warn is not None:
                self._warned_drop = True
                self._warn(f"telemetry: cannot write {target}: {e!r} — "
                           f"records are being dropped (counted on "
                           f"telemetry_dropped)")

    def _send(self, payload: bytes) -> None:
        """One send attempt. A failed attempt (timeout from a consumer
        that stopped reading, EPIPE from one that died, an injected
        fault) tears the connection down so the retry re-ships the WHOLE
        payload on a FRESH connection — a consumer may see a batch
        twice across reconnects, never half a line spliced into the
        next record (each connection's stream stays line-clean)."""
        if self._sock is None:
            self._sock = self._connect()
        try:
            fault_point("obs.export")
            self._sock.sendall(payload)
        except BaseException:
            self._disconnect()
            raise

    def _append(self, path: str, payload: bytes) -> None:
        fault_point("obs.export", path=path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "ab") as fh:
            fh.write(payload)

    def _ensure_connected(self) -> bool:
        if self._sock is not None:
            return True
        now = time.monotonic()
        if now < self._connect_blocked_until:
            return False
        try:
            self._sock = call_with_retry(
                self._connect, site="obs.export", policy=_EXPORT_RETRY)
            self._connect_blocked_until = 0.0
            return True
        except (RetryExhaustedError, OSError) as e:
            self._connect_blocked_until = now + _RECONNECT_SECONDS
            if not self._warned_no_consumer and self._warn is not None:
                self._warned_no_consumer = True
                where = (f"falling back to {self.fallback_path}"
                         if self.fallback_path else
                         "records are being dropped (counted on "
                         "telemetry_dropped)")
                self._warn(f"telemetry: no consumer at {self.endpoint} "
                           f"({getattr(e, 'last', e)!r}) — {where}")
            return False

    def _connect(self) -> socket.socket:
        fault_point("obs.export")
        if self.scheme == "unix":
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                sock.settimeout(_SEND_TIMEOUT_SECONDS)
                sock.connect(str(self.address))
            except BaseException:
                sock.close()
                raise
            return sock
        sock = socket.create_connection(
            self.address, timeout=_SEND_TIMEOUT_SECONDS)
        return sock

    def _disconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- lifecycle ---------------------------------------------------------

    def close(self, timeout: float = 2.0) -> None:
        """Stop accepting records, give the writer ``timeout`` seconds to
        drain what is queued, then drop (and count) the rest. Idempotent;
        never raises — exporter teardown must not change a run's exit."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._thread.join(timeout=timeout)
        while True:  # whatever the writer didn't drain in time
            try:
                self._drop(self._queue.get_nowait())
            except queue.Empty:
                break
