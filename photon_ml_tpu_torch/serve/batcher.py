"""Bounded request queue + adaptive micro-batcher.

Port of ``photon_ml_tpu/serve/batcher.py`` (``bucket_rows``,
``ScoreWork``, ``MicroBatcher``), unchanged but for its imports.
The device loop must never block on a slow client and a slow device
must never build an unbounded backlog: ``submit`` is the only producer
API and it either enqueues or SHEDS (counted on ``serve_shed{reason}``,
an error response to the client) — it never waits. The consumer side
(``next_batch``) drains whatever is queued *right now* up to the batch
cap, so batch size adapts to load: near-empty queues score singles at
minimum latency, backlogs amortize fixed per-batch cost over hundreds
of rows.

Batches are padded to power-of-two row buckets (:func:`bucket_rows` —
the lane-compaction pad convention from ``game/random_effect.py``) so
the device loop presents the card a handful of stable shapes, the same
ones the JAX package compiles once each.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.serve.reqtrace import child_span_id, observe_stage

#: Smallest pad bucket: micro-batches of 1..8 rows share one shape.
MIN_BUCKET = 8


def bucket_rows(n: int, min_bucket: int = MIN_BUCKET,
                max_bucket: Optional[int] = None) -> int:
    """Power-of-two pad bucket for an ``n``-row batch (≥ ``min_bucket``,
    clamped to ``max_bucket`` when given — callers chunk above it)."""
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    if max_bucket is not None:
        b = min(b, int(max_bucket))
    return b


@dataclass
class ScoreWork:
    """One queued scoring request.

    ``generation`` is the model generation the request was admitted
    under (``GenerationStore.pin``); 0 means untagged — score against
    whatever is current. A batch never spans two generations (see
    :meth:`MicroBatcher.next_batch`), so no response ever mixes scores
    from two models.

    The trace fields are the request's distributed-tracing context
    (``serve/reqtrace.py``): ``trace_id`` names the end-to-end trace
    (None = untraced), ``span_id`` is this process's ``serve.request``
    span, ``parent_span`` the upstream caller's span (the router's
    ``route.dispatch``), and ``sampled`` gates tracer-span EMISSION —
    stage timing itself (``serve_stage_ms``) is always on.
    ``enqueued_ns``/``picked_ns`` are ``perf_counter_ns`` stamps (the
    span clock) bracketing the queue wait; ``enqueued_at`` stays on
    ``time.monotonic`` for the existing latency gauges.
    """

    rows: list  # decoded records, Avro record shape
    request_id: object
    reply: Callable[[object], None]  # called with the response dict
    enqueued_at: float = field(default_factory=time.monotonic)
    generation: int = 0
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_span: Optional[str] = None
    sampled: bool = False
    read_ns: int = 0
    enqueued_ns: int = field(default_factory=time.perf_counter_ns)
    picked_ns: int = 0


class MicroBatcher:
    """Bounded FIFO of :class:`ScoreWork` with non-blocking admission.

    ``max_queue_rows`` bounds total queued ROWS (the unit of device
    work), not request count — a thousand single-row pings and one
    thousand-row bulk request cost the queue the same.
    """

    def __init__(self, max_queue_rows: int, max_batch_rows: int,
                 registry: MetricsRegistry = REGISTRY):
        if max_batch_rows <= 0 or max_queue_rows <= 0:
            raise ValueError("queue and batch caps must be positive")
        self.max_queue_rows = int(max_queue_rows)
        self.max_batch_rows = int(max_batch_rows)
        self._registry = registry
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._items: list[ScoreWork] = []
        self._queued_rows = 0
        self._closed = False

    # -- producer side (connection reader threads) ---------------------

    def submit(self, work: ScoreWork) -> Optional[str]:
        """Enqueue, or return a shed reason (``queue_full``/``closed``)
        without blocking. Sheds are counted on ``serve_shed{reason}``."""
        with self._lock:
            if self._closed:
                reason = "closed"
            elif self._queued_rows + len(work.rows) > self.max_queue_rows:
                reason = "queue_full"
            else:
                self._items.append(work)
                self._queued_rows += len(work.rows)
                self._registry.gauge("serve_queue_depth").set(
                    self._queued_rows)
                self._nonempty.notify()
                return None
        self._registry.counter("serve_shed").inc(reason=reason)
        return reason

    # -- consumer side (the device loop) -------------------------------

    def next_batch(self, timeout: float = 0.1) -> list[ScoreWork]:
        """Up to ``max_batch_rows`` rows of queued work, in arrival
        order ([] on timeout). Always yields at least one request when
        any is queued, even one wider than the batch cap — the scorer
        chunks internally. A batch stops at a generation boundary:
        work pinned to different model generations never shares a
        batch (the atomic-flip invariant — every response is scored
        entirely by the generation it was admitted under)."""
        with self._lock:
            if not self._items:
                self._nonempty.wait(timeout)
            batch: list[ScoreWork] = []
            rows = 0
            while self._items:
                head = self._items[0]
                if batch and (rows + len(head.rows) > self.max_batch_rows
                              or head.generation != batch[0].generation):
                    break
                batch.append(self._items.pop(0))
                rows += len(head.rows)
            self._queued_rows -= rows
            self._registry.gauge("serve_queue_depth").set(
                self._queued_rows)
        now_ns = time.perf_counter_ns()
        for w in batch:
            w.picked_ns = now_ns
            observe_stage("queue_wait", (now_ns - w.enqueued_ns) / 1e6,
                          self._registry)
            if w.sampled and w.trace_id is not None:
                trace.record_span(
                    "serve.queue_wait", w.enqueued_ns, now_ns,
                    trace_id=w.trace_id,
                    span_id=child_span_id(w.trace_id, "serve.queue_wait",
                                          w.span_id or 0),
                    parent=w.span_id)
        return batch

    def queue_depth(self) -> int:
        with self._lock:
            return self._queued_rows

    def close(self) -> None:
        """Stop admitting; queued work stays for the drain loop."""
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()
