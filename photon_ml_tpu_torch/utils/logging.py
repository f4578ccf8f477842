"""Run-scoped leveled logger + phase timers.

Port of ``photon_ml_tpu/utils/logging.py`` — ``PhotonLogger`` (a leveled
logger writing one file per run), ``Timer`` and ``timed_phase``, which
opens a ``driver.phase`` span as the JAX one does (``:117``).
"""

from __future__ import annotations

import contextlib
import enum
import os
import sys
import time
from typing import Optional, TextIO


class LogLevel(enum.IntEnum):
    DEBUG = 10
    INFO = 20
    WARN = 30
    ERROR = 40


class PhotonLogger:
    """Leveled logger writing to a file and (optionally) stderr."""

    def __init__(self, log_path: Optional[str] = None,
                 level: LogLevel = LogLevel.DEBUG,
                 echo: bool = True):
        self.level = level
        self._echo = echo
        self._fh: Optional[TextIO] = None
        if log_path:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
            self._fh = open(log_path, "a")

    def _log(self, level: LogLevel, msg: str) -> None:
        if level < self.level:
            return
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"{stamp} [{level.name}] {msg}"
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def debug(self, msg: str) -> None:
        self._log(LogLevel.DEBUG, msg)

    def info(self, msg: str) -> None:
        self._log(LogLevel.INFO, msg)

    def warn(self, msg: str) -> None:
        self._log(LogLevel.WARN, msg)

    def error(self, msg: str) -> None:
        self._log(LogLevel.ERROR, msg)

    # Callable so it can be passed anywhere a plain `logger(msg)` is taken
    # (coordinate descent, validators).
    def __call__(self, msg: str) -> None:
        self.info(msg)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class Timer:
    """util/Timer.scala analog: start/stop/duration."""

    def __init__(self):
        self._start: Optional[float] = None
        self._stop: Optional[float] = None

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        self._stop = None
        return self

    def stop(self) -> "Timer":
        if self._start is None:
            raise RuntimeError("Timer.stop() before start()")
        self._stop = time.perf_counter()
        return self

    @property
    def duration_seconds(self) -> float:
        if self._start is None:
            raise RuntimeError("Timer not started")
        end = self._stop if self._stop is not None else time.perf_counter()
        return end - self._start


@contextlib.contextmanager
def timed_phase(name: str, logger: Optional[PhotonLogger] = None,
                record: Optional[dict] = None, span: bool = True):
    """Driver-phase timing idiom (cli/game/training/Driver.scala:648-711):
    the phase's wall time is logged as ``<name> took <s>s`` and, with
    ``record``, stored there under ``name`` in seconds. The phase runs in
    a ``driver.phase`` span (a no-op while no tracer is enabled) unless
    ``span`` is false: a phase the JAX driver times without a span (the
    model and score writes) keeps the two packages' traces alike."""
    from photon_ml_tpu_torch.obs import trace

    t = Timer().start()
    try:
        if span:
            with trace.span("driver.phase", phase=name):
                yield t
        else:
            yield t
    finally:
        t.stop()
        if logger:
            logger.info(f"{name} took {t.duration_seconds:.3f}s")
        if record is not None:
            record[name] = t.duration_seconds
