"""Event-bus → metrics bridge: fault/recovery telemetry as counters.

Port of ``photon_ml_tpu/obs/bridge.py`` (``MetricsEventListener`` ``:36``),
registered by ``cli/__init__.py`` ``build_event_bus``.

The typed event bus (``utils/events.py``) already announces every fault,
recovery action, and quarantine; this listener folds those streams into
the metrics registry so a run's ``metrics.jsonl`` answers "how many
faults, of what kind, recovered how" without replaying driver logs::

    emitter.register_listener(MetricsEventListener())

Counters written (all on the process registry unless one is injected):

- ``faults{point, coordinate}`` — one per :class:`FaultEvent`
- ``recoveries{action}`` — retried / recovered / skipped / aborted
- ``quarantines{coordinate}`` — per-coordinate freeze events
- ``faults{point="io.shard"}`` — data shards lost to degraded ingest
  (the per-stage ``quarantined_shards`` counter is written directly by
  the :class:`~photon_ml_tpu_torch.data.ingest.IngestPolicy`)
- ``optimization_logs`` — per-model optimization records (legacy driver)

The other fault-tolerance counts are written where they happen, not
here: ``retries{site}`` by ``utils/retry.py``, ``quarantined_shards
{stage}`` and the ``data_coverage`` gauge by ``data/ingest.py``.
"""

from __future__ import annotations

from typing import Optional

from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.utils.events import (
    CoordinateQuarantinedEvent,
    Event,
    FaultEvent,
    PhotonOptimizationLogEvent,
    RecoveryEvent,
    ShardQuarantinedEvent,
)


class MetricsEventListener:
    """EventEmitter listener that mirrors fault-tolerance events into
    labeled counters (idempotent per event — register it once)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry or REGISTRY

    def __call__(self, event: Event) -> None:
        r = self._registry
        if isinstance(event, FaultEvent):
            r.counter("faults").inc(
                point=event.point, coordinate=event.coordinate_id or "")
        elif isinstance(event, CoordinateQuarantinedEvent):
            # before RecoveryEvent: both are terminal records, but a
            # quarantine is NOT a recovery action
            r.counter("quarantines").inc(coordinate=event.coordinate_id)
        elif isinstance(event, ShardQuarantinedEvent):
            # the IngestPolicy already counts quarantined_shards{stage}
            # directly (it must work without an event bus); here the
            # event only contributes to the faults stream for symmetry
            r.counter("faults").inc(point="io.shard", coordinate="")
        elif isinstance(event, RecoveryEvent):
            r.counter("recoveries").inc(action=event.action)
        elif isinstance(event, PhotonOptimizationLogEvent):
            r.counter("optimization_logs").inc()
