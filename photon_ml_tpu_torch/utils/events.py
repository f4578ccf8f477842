"""Training event bus: emitter + listeners with typed event classes.

Port of ``photon_ml_tpu/utils/events.py`` (reference: photon-ml event/
EventEmitter.scala, Event.scala:27-66): ``EventEmitter`` with
``register_listener_by_name`` (the legacy driver's ``--event-listeners``),
the legacy driver's setup, start, finish and optimization-log events
(``:25-54``) and the events of the fault-tolerance layer. A listener that
raises is contained: the failure is logged and counted on the
``listener_errors{listener}`` counter of ``obs.metrics.REGISTRY``, as in
the JAX package, and the other listeners still run.
The drivers' bus writes every event to the warn log and bridges it into
the metrics registry (``obs/bridge.py``).
"""

from __future__ import annotations

import dataclasses
import importlib
import threading
from typing import Any, Callable, Optional

@dataclasses.dataclass(frozen=True)
class Event:
    """event/Event.scala base."""


@dataclasses.dataclass(frozen=True)
class PhotonSetupEvent(Event):
    log_dir: str
    input_path: str
    params_summary: str


@dataclasses.dataclass(frozen=True)
class TrainingStartEvent(Event):
    timestamp: float


@dataclasses.dataclass(frozen=True)
class TrainingFinishEvent(Event):
    timestamp: float


@dataclasses.dataclass(frozen=True)
class PhotonOptimizationLogEvent(Event):
    """One model's optimization record (Event.scala:60-66): the weight,
    the optimizer's result, its validation metrics and, with
    ``--validate-per-iteration``, the metrics of every iterate."""

    regularization_weight: float
    states: Any  # OptimizationResult
    metrics: Optional[dict[str, float]] = None
    per_iteration_metrics: Optional[list[dict[str, float]]] = None


@dataclasses.dataclass(frozen=True)
class FaultEvent(Event):
    """A detected (or injected) fault: a non-finite objective or state,
    an exception out of a coordinate update, a failed checkpoint write."""

    point: str  # fault-point name, e.g. "cd.update"
    coordinate_id: Optional[str] = None
    iteration: Optional[int] = None
    message: str = ""


@dataclasses.dataclass(frozen=True)
class RecoveryEvent(Event):
    """The recovery action taken for a fault: ``retried``, ``recovered``,
    ``skipped`` or ``aborted``."""

    action: str
    coordinate_id: Optional[str] = None
    iteration: Optional[int] = None
    attempts: int = 0
    message: str = ""


@dataclasses.dataclass(frozen=True)
class CoordinateQuarantinedEvent(Event):
    """A coordinate exhausted its per-coordinate failure budget
    (``RecoveryPolicy.quarantine_after``) and is frozen at its last-good
    state for the rest of the run."""

    coordinate_id: str
    iteration: int
    failures: int
    message: str = ""


@dataclasses.dataclass(frozen=True)
class ShardQuarantinedEvent(Event):
    """A data shard was skipped by the degraded-ingest layer
    (``data/ingest.py``): corrupt, truncated or unreadable after
    retries."""

    path: str
    stage: str  # "open" | "decode" | "index"
    reason: str = ""


EventListener = Callable[[Event], None]

_ERROR_LOGGER = None


def _error_logger():
    """Fallback stderr logger for contained listener failures."""
    global _ERROR_LOGGER
    if _ERROR_LOGGER is None:
        from photon_ml_tpu_torch.utils.logging import PhotonLogger

        _ERROR_LOGGER = PhotonLogger(log_path=None, echo=True)
    return _ERROR_LOGGER


class EventEmitter:
    """event/EventEmitter.scala analog: registration + locked dispatch."""

    def __init__(self):
        self._listeners: list[EventListener] = []
        self._lock = threading.Lock()

    def register_listener(self, listener: EventListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def register_listener_by_name(self, qualified_name: str) -> None:
        """A listener from ``module.Class`` (instantiated) or
        ``module.function`` (Driver.scala:110-118)."""
        module_name, _, attr = qualified_name.rpartition(".")
        if not module_name:
            raise ValueError(
                f"listener name {qualified_name!r} must be module-qualified")
        obj = getattr(importlib.import_module(module_name), attr)
        self.register_listener(obj() if isinstance(obj, type) else obj)

    def send_event(self, event: Event) -> None:
        """Dispatch ``event`` to every listener; a listener's exception is
        logged and counted, never propagated into the training loop."""
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener(event)
            except Exception as e:  # noqa: BLE001 — containment is the point
                from photon_ml_tpu_torch.obs.metrics import REGISTRY

                name = getattr(listener, "__qualname__",
                               type(listener).__name__)
                REGISTRY.counter("listener_errors").inc(listener=name)
                _error_logger().warn(
                    f"event listener {name!r} raised on "
                    f"{type(event).__name__}: {e!r} (contained)")
