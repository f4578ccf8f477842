"""Cooperative preemption: the stop flag and every source that sets it.

Port of ``photon_ml_tpu/utils/preempt.py`` — ``StopController`` and
``PreemptionRequested``. One sticky stop flag is fed by SIGTERM/SIGINT
(a second delivery of the same signal restores the previous disposition
and re-raises it), a wall-clock deadline measured from construction
(``max_train_seconds``: ingest included, like a scheduler's quota) and a
stop file, stat'ed at most every :data:`STOP_FILE_POLL_SECS`. The first
reason wins. ``run_coordinate_descent`` polls :meth:`should_stop` only
at commit barriers (between coordinate updates), writes a final
snapshot and raises :class:`PreemptionRequested`; the drivers turn that
into exit 75 and one ``PHOTON_PREEMPTED`` line.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional

#: Minimum seconds between two stat() calls of the stop file.
STOP_FILE_POLL_SECS = 0.25


class PreemptionRequested(Exception):
    """A stop source fired and coordinate descent reached a commit
    barrier; the final snapshot (when checkpointing is on) is written.
    ``sweep``/``coordinate_index`` name the next unit of work, the
    resume point."""

    def __init__(self, reason: str, sweep: int, coordinate_index: int):
        self.reason = reason
        self.sweep = int(sweep)
        self.coordinate_index = int(coordinate_index)
        super().__init__(
            f"preemption requested ({reason}) at step {self.step}")

    @property
    def step(self) -> str:
        """``<sweep>.<coord>``, the format of fault tags and the
        ``PHOTON_PREEMPTED`` line."""
        return f"{self.sweep}.{self.coordinate_index}"


class StopController:
    """One sticky stop flag fed by signals, a deadline and a stop file,
    polled by the training loop through :meth:`should_stop`."""

    def __init__(self, max_train_seconds: Optional[float] = None,
                 stop_file: Optional[str] = None,
                 clock=time.monotonic):
        self._clock = clock
        self._event = threading.Event()
        self._reason: Optional[str] = None
        self._lock = threading.Lock()
        self._deadline = (clock() + float(max_train_seconds)
                          if max_train_seconds and max_train_seconds > 0
                          else None)
        self._stop_file = stop_file or None
        self._next_file_poll = clock()  # the first poll is free
        self._prev_handlers: dict[int, object] = {}

    def request_stop(self, reason: str) -> None:
        """Latch the flag; the first reason wins. Safe from signal
        handlers and other threads."""
        with self._lock:
            if self._reason is None:
                self._reason = reason
        self._event.set()

    def should_stop(self) -> Optional[str]:
        """The stop reason, or None to keep training: the latched flag
        first, then the deadline, then the (throttled) stop file."""
        if self._event.is_set():
            return self._reason
        now = self._clock()
        if self._deadline is not None and now >= self._deadline:
            self.request_stop("deadline:max_train_seconds")
            return self._reason
        if self._stop_file is not None and now >= self._next_file_poll:
            self._next_file_poll = now + STOP_FILE_POLL_SECS
            if os.path.exists(self._stop_file):
                self.request_stop(f"stop_file:{self._stop_file}")
                return self._reason
        return None

    def install_signal_handlers(
            self, signums=(signal.SIGTERM, signal.SIGINT)) -> None:
        """Route SIGTERM/SIGINT into the stop flag."""
        for signum in signums:
            self._prev_handlers[signum] = signal.getsignal(signum)
            signal.signal(signum, self._on_signal)

    def _on_signal(self, signum, frame) -> None:
        if self._event.is_set():
            prev = self._prev_handlers.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            os.kill(os.getpid(), signum)
            return
        self.request_stop(f"signal:{signal.Signals(signum).name}")

    def uninstall_signal_handlers(self) -> None:
        """Restore the dispositions :meth:`install_signal_handlers`
        saved."""
        while self._prev_handlers:
            signum, prev = self._prev_handlers.popitem()
            signal.signal(signum, prev)
