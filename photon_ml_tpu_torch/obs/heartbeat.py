"""Stall-detecting heartbeat: periodic progress records for long runs.

Port of ``photon_ml_tpu/obs/heartbeat.py`` (``Heartbeat`` ``:35``),
unchanged but for its imports: the records are the JAX package's.

The observable complement to the multi-host worker supervision (PR 1):
the supervisor notices a DEAD worker, the heartbeat notices a LIVE one
that has stopped making progress — a wedged collective, a hung input
read, an XLA compile gone pathological. A daemon thread wakes every
``interval_seconds``, asks the tracer how long ago the last span closed,
and appends one JSON line to the run's ``metrics.jsonl``::

    {"kind": "heartbeat", "uptime_s": ..., "spans_closed": ...,
     "spans_dropped": ..., "last_span_close_age_s": ...,
     "open_spans": [...], "stalled": false}

When no span has closed within ``stall_seconds`` the record is flagged
``stalled``, the warning is logged once per stall episode (via
``utils/logging``-style ``warn`` callables), and the ``stalls`` counter
increments — so a stalled multi-host gang is visible in every process's
metrics stream even when stdout is silent.

:meth:`Heartbeat.check` is the single evaluation step and is callable
directly (tests drive it without sleeping through real intervals).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Optional

from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.obs.trace import Tracer


class Heartbeat:
    """Periodic progress/stall records off a :class:`Tracer`."""

    def __init__(self, tracer: Tracer,
                 out_path: Optional[str] = None,
                 interval_seconds: float = 10.0,
                 stall_seconds: float = 120.0,
                 warn: Optional[Callable[[str], None]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 on_beat: Optional[Callable[[], None]] = None,
                 on_record: Optional[Callable[[dict], None]] = None):
        self.tracer = tracer
        self.out_path = out_path
        self.interval_seconds = float(interval_seconds)
        self.stall_seconds = float(stall_seconds)
        self._warn = warn
        self._registry = registry or REGISTRY
        self._on_beat = on_beat
        self._on_record = on_record
        self.stalled = False
        self.beats = 0
        self._write_failed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._write_lock = threading.Lock()

    def check(self) -> dict:
        """One heartbeat evaluation: build the record, append it to
        ``out_path`` (when set), flag/log stall transitions, and run the
        ``on_beat`` hook (the ObservedRun's span spill)."""
        if self._on_beat is not None:
            try:
                self._on_beat()
            except Exception as e:  # a full disk must not kill the beat
                if self._warn is not None:
                    self._warn(f"heartbeat: on_beat hook raised: {e!r}")
        age = self.tracer.seconds_since_last_close()
        stalled = age > self.stall_seconds
        record = {
            "kind": "heartbeat",
            "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "uptime_s": round(self.tracer.uptime_seconds(), 3),
            "spans_closed": self.tracer.spans_closed,
            "spans_dropped": self.tracer.spans_dropped,
            "last_span_close_age_s": round(age, 3),
            "open_spans": self.tracer.open_spans()[:8],
            "stalled": stalled,
            # compact live counters: the telemetry stream / run-dir tail
            # answers "how hard is the run working" WITHOUT waiting for
            # the exit snapshot (photon_ml_tpu_torch/tools/
            # photon_status.py reads these)
            "metric_totals": self._registry.totals(),
        }
        if stalled and not self.stalled:
            self._registry.counter("stalls").inc()
            if self._warn is not None:
                # dump the FULL open-span stack with per-span ages into
                # the driver log — a hung chaos run must be diagnosable
                # from the log alone (which span is wedged, how long)
                report = self.tracer.open_span_report()
                stack_dump = ("\n  ".join(report) if report
                              else "(no open spans)")
                self._warn(
                    f"heartbeat: STALL — no span closed in {age:.1f}s "
                    f"(window {self.stall_seconds:.1f}s); open-span "
                    f"stack:\n  {stack_dump}")
        self.stalled = stalled
        self.beats += 1
        if self._on_record is not None:
            try:  # the live-export hook must not kill the beat either
                self._on_record(record)
            except Exception as e:
                if self._warn is not None:
                    self._warn(f"heartbeat: on_record hook raised: {e!r}")
        if self.out_path is not None:
            try:
                with self._write_lock:
                    with open(self.out_path, "a") as fh:
                        fh.write(json.dumps(record) + "\n")
                self._write_failed = False
            except OSError as e:
                # a full disk / vanished trace dir must not kill the
                # daemon: stall DETECTION (the warn above) still works
                # even when the record can't be persisted
                if not self._write_failed and self._warn is not None:
                    self._warn(f"heartbeat: cannot append to "
                               f"{self.out_path}: {e!r}")
                self._write_failed = True
        return record

    # -- thread lifecycle --------------------------------------------------

    def start(self) -> "Heartbeat":
        if self.interval_seconds <= 0:  # <= 0 disables the daemon
            return self
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()  # a start() after stop() must actually beat
        self._thread = threading.Thread(
            target=self._loop, name="photon-heartbeat", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_seconds):
            try:
                self.check()
            except Exception as e:  # the beat must outlive any one check
                if self._warn is not None:
                    self._warn(f"heartbeat: check failed: {e!r}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if not self._thread.is_alive():  # a wedged thread (NFS append
                # stuck past the join timeout) stays tracked so a restart
                # can't spawn a second writer against the same file
                self._thread = None
