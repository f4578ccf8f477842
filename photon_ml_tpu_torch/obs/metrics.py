"""Labeled metrics registry: counters, gauges, histograms.

Port of ``photon_ml_tpu/obs/metrics.py``, the same classes and names, so
a metric's value means the same in either package. The process-wide
metrics half of the observability layer (``obs/trace.py``
is the spans half). Prometheus-shaped without the dependency: a metric is
a name plus a map from a label set (sorted ``(key, value)`` tuples) to a
value, so ``counter("host_fetches").inc(site="cd.epilogue")`` gives
per-site attribution for free while ``total()`` stays the label-sum the
legacy ``utils/sync_telemetry.host_fetch_count()`` contract needs.

Everything here is stdlib-only and never touches torch — incrementing a
counter can never introduce a device sync.

Export is JSONL (:meth:`MetricsRegistry.snapshot` → one dict per
metric/label-set), written by the ``--trace-dir`` integration
(``obs/run.py``) next to the Chrome trace; the scoring service also reads
its counters and histograms for ``stats``.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

_LabelKey = tuple  # sorted ((key, value), ...) pairs


def _label_key(labels: dict) -> _LabelKey:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonically increasing value per label set."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._values: dict[_LabelKey, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def total(self) -> float:
        """Sum over every label set (the unlabeled legacy view)."""
        with self._lock:
            return sum(self._values.values())

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def by_label(self, label: str) -> dict[str, float]:
        """Aggregate totals keyed by one label's values (label sets
        without that label land under ``""``)."""
        out: dict[str, float] = {}
        with self._lock:
            for key, v in self._values.items():
                name = dict(key).get(label, "")
                out[name] = out.get(name, 0) + v
        return out

    def items(self) -> dict[_LabelKey, float]:
        with self._lock:
            return dict(self._values)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def records(self) -> list[dict]:
        with self._lock:
            return [{"kind": self.kind, "name": self.name,
                     "labels": dict(key), "value": v}
                    for key, v in sorted(self._values.items())]


class Gauge(Counter):
    """Last-written value per label set (same storage as Counter)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = value


#: Default histogram buckets: powers of two — wide enough for iteration
#: counts, lane counts, and millisecond durations alike.
DEFAULT_BUCKETS = tuple(2 ** i for i in range(0, 15))


class Histogram:
    """Bucketed distribution per label set (count/sum/min/max + cumulative
    ``le`` bucket counts, Prometheus-style)."""

    kind = "histogram"

    def __init__(self, name: str,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._lock = threading.Lock()
        # key -> [count, sum, min, max, per-bucket counts]
        self._values: dict[_LabelKey, list] = {}

    def observe(self, x: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            slot = self._values.get(key)
            if slot is None:
                slot = [0, 0.0, x, x, [0] * (len(self.buckets) + 1)]
                self._values[key] = slot
            slot[0] += 1
            slot[1] += x
            slot[2] = min(slot[2], x)
            slot[3] = max(slot[3], x)
            for i, le in enumerate(self.buckets):
                if x <= le:
                    slot[4][i] += 1
                    break
            else:
                slot[4][-1] += 1  # overflow bucket

    def snapshot(self, **labels) -> Optional[dict]:
        key = _label_key(labels)
        with self._lock:
            slot = self._values.get(key)
            if slot is None:
                return None
            return self._record(dict(key), slot)

    def _record(self, labels: dict, slot: list) -> dict:
        # storage is per-interval; export is CUMULATIVE (Prometheus
        # ``le`` semantics: le_X counts observations <= X, le_inf = count)
        buckets = {}
        running = 0
        for g, c in zip(self.buckets, slot[4]):
            running += c
            buckets[f"le_{g}"] = running
        buckets["le_inf"] = running + slot[4][-1]
        return {"kind": self.kind, "name": self.name, "labels": labels,
                "count": slot[0], "sum": slot[1],
                "min": slot[2], "max": slot[3], "buckets": buckets}

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def records(self) -> list[dict]:
        with self._lock:
            return [self._record(dict(key), slot)
                    for key, slot in sorted(self._values.items())]


class MetricsRegistry:
    """Name-indexed metric store; ``counter``/``gauge``/``histogram`` are
    get-or-create, so call sites never coordinate registration order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kwargs)
                self._metrics[name] = m
            elif type(m) is not cls:  # exact: Gauge must not pass as Counter
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._get(name, Histogram, buckets=buckets)
        if buckets is not None and tuple(sorted(buckets)) != h.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h.buckets}, not {tuple(sorted(buckets))}")
        return h

    def snapshot(self) -> list[dict]:
        """Every metric/label-set as a JSONL-able record."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: list[dict] = []
        for m in sorted(metrics, key=lambda m: m.name):
            out.extend(m.records())
        return out

    def totals(self) -> dict:
        """``{name: label-summed total}`` for counters and gauges plus
        ``{name: {"count", "sum"}}`` for histograms — the compact
        per-heartbeat snapshot the live telemetry stream (and
        ``photon_ml_tpu_torch/tools/photon_status.py``) rides on. The
        histogram entry keeps a distribution like
        ``re_chunk_active_lanes`` visible live
        (count and running sum; full bucket records still only ship in
        the exit snapshot). Scalar consumers key on scalar names, so
        the dict-valued entries never collide with them.

        A LABELED histogram's entry additionally carries ``series``:
        the per-label-set records (count/sum/min/max + cumulative
        ``le`` buckets), so a consumer like
        ``photon_ml_tpu_torch/tools/photon_status.py --fleet``
        can estimate per-label percentiles (the
        ``serve_stage_ms{stage}`` breakdown) from heartbeat totals
        alone. Additive: scalar-shaped consumers never see it, and
        unlabeled histograms stay in the compact two-key form."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {}
        for m in sorted(metrics, key=lambda m: m.name):
            if isinstance(m, Counter):
                out[m.name] = m.total()
            elif isinstance(m, Histogram):
                records = m.records()
                entry = {
                    "count": sum(r["count"] for r in records),
                    "sum": sum(r["sum"] for r in records)}
                if any(r["labels"] for r in records):
                    entry["series"] = [
                        {"labels": r["labels"], "count": r["count"],
                         "sum": r["sum"], "min": r["min"],
                         "max": r["max"], "buckets": r["buckets"]}
                        for r in records]
                out[m.name] = entry
        return out

    def reset(self) -> None:
        """Zero every metric (bench/test isolation; registrations stay)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()


#: The process-wide registry every instrumented site writes to.
REGISTRY = MetricsRegistry()
