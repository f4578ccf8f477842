"""Degraded-mode ingest: shard-level quarantine with a bounded loss budget.

Port of ``photon_ml_tpu/data/ingest.py`` — ``IngestPolicy``,
``QuarantinedShard`` and ``ShardLossExceededError``. Every shard read
goes through ``utils/retry`` first; a shard that stays unreadable, or
decodes corrupt, is quarantined (skipped, with a
:class:`~photon_ml_tpu_torch.utils.events.ShardQuarantinedEvent` and a
warning) while ingestion goes on; once the lost fraction of the shards
exceeds ``max_shard_loss_frac`` the load aborts cleanly with
:class:`ShardLossExceededError` (exit 3 in the drivers). The default
budget of 0 is strict: the first lost shard aborts. The JAX version also
counts losses and the coverage on its metrics registry; the port has no
telemetry yet, and :meth:`IngestPolicy.summary` is the record.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from photon_ml_tpu_torch.utils.events import (
    EventEmitter,
    ShardQuarantinedEvent,
)


class ShardLossExceededError(RuntimeError):
    """The quarantined-shard fraction exceeded ``max_shard_loss_frac``."""


@dataclasses.dataclass
class QuarantinedShard:
    path: str
    stage: str  # "open" | "decode" | "index"
    reason: str


class IngestPolicy:
    """Per-load quarantine bookkeeping + loss budget (one instance per
    dataset load). The io layer calls :meth:`record_ok` or
    :meth:`quarantine` per shard."""

    def __init__(self, max_shard_loss_frac: float = 0.0,
                 events: Optional[EventEmitter] = None,
                 warn: Optional[Callable[[str], None]] = None):
        if not 0.0 <= max_shard_loss_frac <= 1.0:
            raise ValueError(
                f"max_shard_loss_frac must be in [0, 1], "
                f"got {max_shard_loss_frac}")
        self.max_shard_loss_frac = max_shard_loss_frac
        self._events = events
        self._warn = warn
        self.shards_ok = 0
        self.quarantined: list[QuarantinedShard] = []
        self.expected_total: Optional[int] = None
        # paths already announced: a rescan that loses the same shard
        # again warns and emits once
        self._announced: set[str] = set()

    def begin(self, expected_total: int) -> None:
        """Announce the shard universe (and reset the per-load counts)."""
        self.expected_total = expected_total
        self.shards_ok = 0
        self.quarantined = []

    def record_ok(self, path: str) -> None:
        self.shards_ok += 1

    def quarantine(self, path: str, stage: str, error: BaseException) -> None:
        """Record one lost shard; raises :class:`ShardLossExceededError`
        as soon as the budget cannot hold (against the announced universe
        when :meth:`begin` gave one)."""
        self.quarantined.append(
            QuarantinedShard(path=path, stage=stage, reason=repr(error)))
        if path not in self._announced:
            self._announced.add(path)
            if self._warn is not None:
                self._warn(f"shard quarantined ({stage}): {path}: {error!r}")
            if self._events is not None:
                self._events.send_event(ShardQuarantinedEvent(
                    path=path, stage=stage, reason=repr(error)))
        lost = len(self.quarantined)
        total = (self.expected_total if self.expected_total
                 else self.shards_ok + lost)
        if total and lost / total > self.max_shard_loss_frac:
            raise ShardLossExceededError(
                f"{lost} of {total} shard(s) quarantined "
                f"({lost / total:.0%} > --max-shard-loss-frac "
                f"{self.max_shard_loss_frac:.0%}); refusing to train on "
                f"{1 - lost / total:.0%} of the data — last loss: "
                f"{path} ({stage}: {error!r})") from error

    @property
    def shards_lost(self) -> int:
        return len(self.quarantined)

    @property
    def coverage_fraction(self) -> float:
        """Surviving fraction of the shards read (1.0 before any)."""
        total = self.shards_ok + self.shards_lost
        return 1.0 if total == 0 else self.shards_ok / total

    def summary(self) -> dict:
        """JSON-able record for metrics.json."""
        return {
            "data_coverage": self.coverage_fraction,
            "shards_ok": self.shards_ok,
            "shards_quarantined": [
                {"path": q.path, "stage": q.stage, "reason": q.reason}
                for q in self.quarantined],
        }

    def finish(self, log: Optional[Callable[[str], None]] = None) -> None:
        """Log the degraded-mode summary when a shard was lost."""
        if self.quarantined and log is not None:
            log(f"DEGRADED ingest: {self.shards_lost} of "
                f"{self.shards_ok + self.shards_lost} shard(s) "
                f"quarantined, data coverage "
                f"{self.coverage_fraction:.1%}: "
                f"{[q.path for q in self.quarantined]}")
