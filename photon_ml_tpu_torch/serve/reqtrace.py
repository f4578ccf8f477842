"""Request-scoped trace identity for the serve plane.

Port of ``photon_ml_tpu/serve/reqtrace.py``, unchanged but for its
imports: the same ids for the same seeds, so traces of either package's
service read alike.
The plumbing behind wire-propagated distributed tracing
(``serve/protocol.py`` carries the fields, ``router.py`` mints,
``service.py``/``batcher.py``/``scoring.py`` stamp stage spans):

- :class:`TraceIdMinter` — trace ids from blake2b over a per-process
  counter (the ``entity_shard`` hashing idiom from ``serve/fleet.py``);
  no ``random``, so a seeded minter is fully deterministic under test.
- :func:`child_span_id` — span ids derived from the parent trace id, a
  span name, and a sequence number, so every process can mint ids for
  its own spans without coordination and without collisions.
- :class:`HeadSampler` — deterministic pacing head-sampler for
  ``--trace-sample-rate``: an accumulator gains ``rate`` per request
  and fires on overflow, so a 0.05 rate samples exactly every 20th
  request (no RNG, bit-stable across runs).
- :class:`ExemplarReservoir` — keep-the-slowest-N by end-to-end
  latency, so the p99 offenders are always fully traced even when head
  sampling keeps 1-in-20. Bounded; offer/evict is O(N) on a tiny N.
- :data:`STAGE_MS_BUCKETS` / :func:`observe_stage` — the
  ``serve_stage_ms{stage}`` histogram every request feeds regardless of
  sampling (stage *timing* is always on and ledger-consistent; only
  span *emission* is sampled).

Everything here is stdlib-only and lock-cheap: nothing on this path may
add request latency beyond a couple of dict ops (the <2% armed-overhead
contract bench.py asserts).
"""

from __future__ import annotations

import os
import threading
from hashlib import blake2b
from typing import Optional

from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry


def _hex(payload: str) -> str:
    # digest_size=8 -> 16 hex chars; the entity_shard digest idiom.
    return blake2b(payload.encode("utf-8"), digest_size=8).hexdigest()


class TraceIdMinter:
    """Deterministic per-process trace-id mint.

    ``blake2b(f"{seed}/{counter}")`` — the seed defaults to the process
    pid (two fleet members can never mint the same id) and is
    injectable so tests get a reproducible id sequence.
    """

    def __init__(self, seed: Optional[str] = None):
        self.seed = str(seed) if seed is not None else f"pid{os.getpid()}"
        self._lock = threading.Lock()
        self._count = 0

    def mint(self) -> str:
        with self._lock:
            n = self._count
            self._count += 1
        return _hex(f"{self.seed}/{n}")


def child_span_id(trace_id: str, name: str, seq: int = 0) -> str:
    """A span id any process can derive locally: hash of the trace id,
    the span name, and a caller-chosen sequence number (shard index,
    retry hop, ...). Distinct (name, seq) pairs never collide within a
    trace; the same pair is stable, which is what re-assembly wants."""
    return _hex(f"{trace_id}/{name}/{seq}")


class HeadSampler:
    """Pacing head-sampler: deterministic 1-in-(1/rate) admission.

    The accumulator gains ``rate`` per :meth:`should_sample` call and
    fires when it crosses 1 — evenly spaced samples with no RNG, so the
    sampled-request set is a pure function of arrival order (tests pin
    it; ``rate=1`` traces everything, ``rate=0`` nothing).
    """

    def __init__(self, rate: float):
        self.rate = min(max(float(rate), 0.0), 1.0)
        self._lock = threading.Lock()
        self._acc = 0.0

    def should_sample(self) -> bool:
        if self.rate <= 0.0:
            return False
        if self.rate >= 1.0:
            return True
        with self._lock:
            self._acc += self.rate
            if self._acc >= 1.0:
                self._acc -= 1.0
                return True
            return False


class ExemplarReservoir:
    """Keep the slowest-``n`` fully-traced requests seen so far.

    Entries are ``(latency_ms, record)`` with ``record`` an arbitrary
    JSON-able dict (the service stores the request's complete span-event
    list). The reservoir is sorted fastest-first so eviction is
    ``items[0]``; :meth:`offer` answers in O(n) for the bounded n (8 by
    default) and never blocks.
    """

    def __init__(self, n: int = 8):
        if n <= 0:
            raise ValueError("reservoir size must be positive")
        self.n = int(n)
        self._lock = threading.Lock()
        self._items: list[tuple[float, dict]] = []  # fastest first
        self._generation = 0

    def offer(self, latency_ms: float, record: dict) -> bool:
        """Keep ``record`` if it is among the slowest-n; True if kept."""
        with self._lock:
            if len(self._items) >= self.n \
                    and latency_ms <= self._items[0][0]:
                return False
            lo, hi = 0, len(self._items)
            while lo < hi:
                mid = (lo + hi) // 2
                if self._items[mid][0] < latency_ms:
                    lo = mid + 1
                else:
                    hi = mid
            self._items.insert(lo, (latency_ms, record))
            if len(self._items) > self.n:
                self._items.pop(0)
            self._generation += 1
            return True

    def snapshot(self) -> list[dict]:
        """Kept records, slowest first."""
        with self._lock:
            return [rec for _, rec in reversed(self._items)]

    def generation(self) -> int:
        """Bumps on every kept offer — the spill loop's dirty check."""
        with self._lock:
            return self._generation

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


#: ``serve_stage_ms`` buckets: sub-millisecond queue waits up to
#: multi-second tail requests (the default pow2 buckets start at 1 and
#: would fold every sub-ms stage into one bin).
STAGE_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50,
                    100, 250, 500, 1000, 2500, 5000)


def observe_stage(stage: str, ms: float,
                  registry: MetricsRegistry = REGISTRY) -> None:
    """One stage observation on the ``serve_stage_ms{stage}`` histogram.

    Called for EVERY request (sampling gates span emission, never stage
    timing), so histogram counts stay consistent with the request
    ledger — the invariant the e2e acceptance test checks."""
    registry.histogram("serve_stage_ms",
                       buckets=STAGE_MS_BUCKETS).observe(ms, stage=stage)
