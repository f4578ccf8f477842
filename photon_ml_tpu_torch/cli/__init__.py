"""CLI drivers and their shared exit discipline.

Port of ``photon_ml_tpu/cli/__init__.py`` — ``clean_abort``,
``clean_abort_types``, ``preempted_exit``, ``build_event_bus``,
``build_ingest_policy`` and the exit codes. A driver ends one of four
ways:

- ``0`` — success, possibly degraded (quarantined shards or coordinates
  are in the log and ``metrics.json``);
- ``3`` (:data:`CLEAN_ABORT_EXIT`) — a recognized terminal condition:
  shard loss over ``--max-shard-loss-frac``, an all-corrupt checkpoint
  directory, an I/O that stayed down through its retries, an unrecovered
  injected fault, an operator's KeyboardInterrupt, or a flag the port
  does not run yet (``NotImplementedError`` naming it); one
  ``PHOTON_ABORT kind=<Type>: <message>`` line on stderr, no traceback;
- ``75`` (:data:`PREEMPTED_EXIT`, sysexits ``EX_TEMPFAIL``) — a stop
  source fired and the run stopped at a commit barrier with a final
  snapshot; one ``PHOTON_PREEMPTED step=<sweep>.<coord>`` line on stderr.
  The same command resumes bit-exact;
- an injected ``kill``'s exit code.

The JAX drivers' event bus also feeds the metrics stream through
``obs/bridge.py``; the port has no telemetry yet, so its bus writes to the
warn log only.
"""

from __future__ import annotations

import sys

CLEAN_ABORT_EXIT = 3
PREEMPTED_EXIT = 75


def clean_abort_types() -> tuple:
    """The exception classes that mean "documented terminal condition —
    abort cleanly"."""
    from photon_ml_tpu_torch.data.ingest import ShardLossExceededError
    from photon_ml_tpu_torch.utils.checkpoint import (
        CheckpointCorruptionError,
    )
    from photon_ml_tpu_torch.utils.faults import InjectedFault
    from photon_ml_tpu_torch.utils.retry import RetryExhaustedError

    return (ShardLossExceededError, CheckpointCorruptionError,
            RetryExhaustedError, InjectedFault, NotImplementedError)


def build_event_bus(warn):
    """The drivers' event bus: every event lands in the warn log."""
    from photon_ml_tpu_torch.utils.events import EventEmitter

    events = EventEmitter()
    events.register_listener(lambda e: warn(f"event: {e}"))
    return events


def build_ingest_policy(max_shard_loss_frac: float, events, warn):
    """A fresh degraded-ingest policy on the driver's event bus (one per
    load: the coverage fraction is per dataset)."""
    from photon_ml_tpu_torch.data.ingest import IngestPolicy

    return IngestPolicy(max_shard_loss_frac=max_shard_loss_frac,
                        events=events, warn=warn)


def clean_abort(e: BaseException, log=None) -> SystemExit:
    """The clean-abort exit for a recognized terminal condition: one
    ``PHOTON_ABORT`` line on stderr, exit code :data:`CLEAN_ABORT_EXIT`,
    no traceback. Usage::

        except clean_abort_types() as e:
            raise clean_abort(e, log=driver.logger.error) from None
    """
    if log is not None:
        log(f"clean abort ({type(e).__name__}): {e}")
    print(f"PHOTON_ABORT kind={type(e).__name__}: {e}",
          file=sys.stderr, flush=True)
    return SystemExit(CLEAN_ABORT_EXIT)


def preempted_exit(e, log=None) -> SystemExit:
    """The preempted exit for a graceful stop: one
    ``PHOTON_PREEMPTED step=<sweep>.<coord> reason=<why>`` line on stderr,
    exit code :data:`PREEMPTED_EXIT`, no traceback. ``e`` is the
    :class:`~photon_ml_tpu_torch.utils.preempt.PreemptionRequested` the
    training loop raised."""
    if log is not None:
        log(f"preempted ({e.reason}) at step {e.step}")
    print(f"PHOTON_PREEMPTED step={e.step} reason={e.reason}",
          file=sys.stderr, flush=True)
    return SystemExit(PREEMPTED_EXIT)
