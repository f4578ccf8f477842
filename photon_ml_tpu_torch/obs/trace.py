"""Span tracer: nestable, thread-safe, monotonic-clock context managers.

Port of ``photon_ml_tpu/obs/trace.py``. The spans half of the
observability layer (``obs/metrics.py`` is the metrics half). Call sites
write::

    from photon_ml_tpu_torch.obs import trace
    with trace.span("cd.update", coordinate=cid, sweep=it):
        ...

and pay essentially nothing when tracing is disabled (the module-level
``span()`` returns a shared no-op singleton) and two
``time.perf_counter_ns`` reads plus one locked list append when enabled —
no torch import, no device work, so instrumented hot loops keep their
sync discipline. Tracing is off unless a caller enables a tracer, as
``--trace-dir`` does through ``obs/run.py``.

Export formats:

- **Chrome trace-event JSON** (:meth:`Tracer.chrome_trace` /
  :meth:`Tracer.write_chrome_trace`): complete ``"ph": "X"`` events with
  microsecond ``ts``/``dur`` — loadable in Perfetto / ``chrome://tracing``
  as-is; nesting is implied by timestamp containment per ``tid``.
- **Structured JSONL** (:meth:`Tracer.write_spans_jsonl`): one span per
  line with ``name``/``ts_us``/``dur_us``/``tid``/``depth``/labels, for
  ad-hoc ``jq``/pandas analysis and ``tools/trace_report.py``.

Per-thread nesting depth comes from a ``threading.local`` span stack; the
stack snapshots also feed the heartbeat's stall report (which spans are
currently open when nothing has closed for too long).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class _NullSpan:
    """Shared no-op span for the tracing-disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_labels", "_start_ns", "_depth")

    def __init__(self, tracer: "Tracer", name: str, labels: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._labels = labels or None

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        self._start_ns = time.perf_counter_ns()
        # (name, start_ns): the open-span report needs per-span ages to
        # make a stalled run diagnosable from the log alone
        stack.append((self._name, self._start_ns))
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        self._tracer._stack().pop()
        self._tracer._record(self._name, self._start_ns, end_ns,
                             self._depth, self._labels)
        return False


#: Buffer backstop for a tracer nobody drains (bench, tests, ad-hoc
#: ``trace.enable()``): past this many buffered spans new ones are
#: dropped (and counted on ``spans_dropped``) instead of growing host
#: RAM without bound. An ObservedRun never gets near it — its heartbeat
#: drains the buffer into ``spans.jsonl`` every few seconds.
DEFAULT_MAX_BUFFERED_SPANS = 1_000_000


class Tracer:
    """Collects closed spans as (name, tid, depth, start_ns, dur_ns,
    labels) tuples relative to the tracer's monotonic epoch."""

    def __init__(self, process_index: int = 0,
                 max_buffered_spans: int = DEFAULT_MAX_BUFFERED_SPANS):
        self.process_index = process_index
        self.max_buffered_spans = max_buffered_spans
        self._t0_ns = time.perf_counter_ns()
        self.start_unix = time.time()
        self._lock = threading.Lock()
        self._events: list[tuple] = []
        self._local = threading.local()
        # thread id -> that thread's live span stack (mutated only by its
        # owner; read racily by the heartbeat for stall reporting)
        self._stacks: dict[int, list[str]] = {}
        self.spans_closed = 0
        self.spans_dropped = 0
        self._last_close_ns = self._t0_ns

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            with self._lock:
                self._stacks[threading.get_ident()] = stack
        return stack

    def span(self, name: str, **labels) -> _Span:
        return _Span(self, name, labels)

    def record_span(self, name: str, start_ns: int, end_ns: int,
                    depth: int = 0, labels: Optional[dict] = None) -> None:
        """Record an already-timed span from explicit
        ``time.perf_counter_ns`` timestamps (same clock as the context
        manager, so recorded and live spans share one timeline).

        The serve plane's request spans are timed by hand — the start
        (admission, enqueue) and the end (reply) happen on different
        threads, so a context manager can't bracket them. Cross-process
        request linkage rides on ``labels``: ``trace_id``/``span_id``/
        ``parent`` labels stitch the trees back together in
        ``tools/trace_merge.py`` / ``obs/otlp.py``."""
        self._record(name, start_ns, end_ns, depth, labels or None)

    def _record(self, name, start_ns, end_ns, depth, labels) -> None:
        event = (name, threading.get_ident(), depth,
                 start_ns - self._t0_ns, end_ns - start_ns, labels)
        with self._lock:
            if len(self._events) < self.max_buffered_spans:
                self._events.append(event)
            else:
                self.spans_dropped += 1
            # closed (even if the record was dropped): the stall signal
            # must not flip just because the buffer is full
            self.spans_closed += 1
            self._last_close_ns = end_ns

    # -- heartbeat hooks ---------------------------------------------------

    def seconds_since_last_close(self) -> float:
        """Monotonic seconds since the last span closed (since the tracer
        started if none has) — the heartbeat's stall signal."""
        return (time.perf_counter_ns() - self._last_close_ns) / 1e9

    def open_spans(self) -> list[str]:
        """Currently open span names across all threads, outermost
        first (best-effort snapshot for stall reporting)."""
        with self._lock:
            stacks = list(self._stacks.values())
        out: list[str] = []
        for stack in stacks:
            out.extend(name for name, _ in list(stack))
        return out

    def open_span_report(self) -> list[str]:
        """Per-thread open-span stacks WITH per-span ages, outermost
        first — the postmortem the heartbeat dumps into the driver log
        on a stall episode, so a hung run is diagnosable from the log
        alone (which span is wedged, and for how long)."""
        now = time.perf_counter_ns()
        with self._lock:
            stacks = list(self._stacks.items())
        lines: list[str] = []
        for tid, stack in stacks:
            snap = list(stack)
            if not snap:
                continue
            chain = " > ".join(f"{name} (open {(now - start) / 1e9:.1f}s)"
                               for name, start in snap)
            lines.append(f"thread {tid}: {chain}")
        return lines

    def uptime_seconds(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1e9

    def rel_ts_us(self, ns: int) -> float:
        """Tracer-epoch-relative microseconds for a ``perf_counter_ns``
        stamp — the ``ts_us`` convention of :meth:`events`, so records
        built outside the tracer (the serve exemplar reservoir) land on
        the same timeline as drained spans."""
        return (ns - self._t0_ns) / 1e3

    # -- export ------------------------------------------------------------

    @staticmethod
    def _as_dicts(snapshot: list[tuple]) -> list[dict]:
        return [{"name": name, "tid": tid, "depth": depth,
                 "ts_us": start_ns / 1e3, "dur_us": dur_ns / 1e3,
                 "labels": labels or {}}
                for name, tid, depth, start_ns, dur_ns, labels in snapshot]

    def events(self) -> list[dict]:
        """Closed spans as dicts (ts/dur in microseconds)."""
        with self._lock:
            snapshot = list(self._events)
        return self._as_dicts(snapshot)

    def drain(self) -> list[dict]:
        """Remove and return the buffered spans (same dicts as
        :meth:`events`). The ObservedRun's heartbeat spills these into
        ``spans.jsonl`` so a long run's buffer stays bounded and a
        killed run keeps every span spilled so far."""
        with self._lock:
            snapshot = self._events
            self._events = []
        return self._as_dicts(snapshot)

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (Perfetto / chrome://tracing)."""
        return chrome_document(self.events(), self.process_index,
                               self.start_unix)

    def write_chrome_trace(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)

    def write_spans_jsonl(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            for e in self.events():
                fh.write(json.dumps(e) + "\n")


def chrome_document(events: list[dict], process_index: int,
                    start_unix: float) -> dict:
    """Chrome trace-event JSON document from :meth:`Tracer.events`-shaped
    dicts — shared by the in-memory export above and the ObservedRun,
    which rebuilds ``trace.json`` from the spilled ``spans.jsonl``."""
    out = [{"name": e["name"], "cat": "photon", "ph": "X",
            "ts": e["ts_us"], "dur": e["dur_us"],
            "pid": process_index, "tid": e["tid"],
            "args": e.get("labels") or {}}
           for e in events]
    out.sort(key=lambda ev: ev["ts"])
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "process_index": process_index,
            "start_unix_time": start_unix,
        },
    }


#: Process-global tracer; None = tracing disabled (the default).
_tracer: Optional[Tracer] = None


def enable(process_index: int = 0) -> Tracer:
    """Install (and return) a fresh process-global tracer."""
    global _tracer
    _tracer = Tracer(process_index=process_index)
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def span(name: str, **labels):
    """A span on the global tracer — or the shared no-op when tracing is
    off, so call sites never branch."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, labels)


def record_span(name: str, start_ns: int, end_ns: int,
                depth: int = 0, **labels) -> None:
    """An explicit-timestamp span on the global tracer (no-op when
    tracing is off) — see :meth:`Tracer.record_span`."""
    t = _tracer
    if t is None:
        return
    t.record_span(name, start_ns, end_ns, depth, labels or None)
