"""CLI drivers and their shared exit discipline.

Port of ``photon_ml_tpu/cli/__init__.py`` — ``clean_abort``,
``clean_abort_types`` and the exit codes. A driver ends with ``0`` on
success or ``3`` (``CLEAN_ABORT_EXIT``) on a recognized terminal
condition, with one ``PHOTON_ABORT kind=<Type>: <message>`` line on stderr
and no traceback. In the port the recognized condition is a flag it does
not run yet (``NotImplementedError`` naming the flag); shard loss,
checkpoint corruption, exhausted retries and preemption (the JAX
package's exit ``75``) come with the slices that port them. The event bus and ingest policy come
later too.
"""

from __future__ import annotations

import sys

CLEAN_ABORT_EXIT = 3


def clean_abort_types() -> tuple:
    """The exception classes that mean "documented terminal condition —
    abort cleanly"."""
    return (NotImplementedError,)


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
