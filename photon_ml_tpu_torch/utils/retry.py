"""Deadline/backoff retry combinator with deterministic jitter.

Port of ``photon_ml_tpu/utils/retry.py`` — ``RetryPolicy``,
``backoff_delays`` (the same keyed-hash jitter, ``:86``),
``call_with_retry`` and ``RetryExhaustedError``. Transient failures
(``OSError`` and :class:`~photon_ml_tpu_torch.utils.faults.InjectedFault`)
are retried with exponential backoff; permanent ones (``ValueError`` from
a corrupt decode, ``FileNotFoundError``) propagate on the first attempt.
Each retry is counted on the metrics registry (``retries{site}``; the
mapping :data:`RETRIES` reads it by site) and runs inside a
``retry.attempt`` span, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections.abc import Mapping
from typing import Callable, Optional, TypeVar

from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.utils.faults import InjectedFault

T = TypeVar("T")


class _RetriesBySite(Mapping):
    """Read-only ``site -> retries`` view of the ``retries`` counter."""

    def _counts(self) -> dict:
        return {k: int(v) for k, v in
                REGISTRY.counter("retries").by_label("site").items()}

    def __getitem__(self, site: str) -> int:
        return self._counts()[site]

    def __iter__(self):
        return iter(self._counts())

    def __len__(self) -> int:
        return len(self._counts())


#: site -> retries taken in this process (first attempts are not counted)
RETRIES: Mapping = _RetriesBySite()


class RetryExhaustedError(RuntimeError):
    """A retried operation failed every attempt (or hit its deadline).
    Carries the last exception as ``__cause__`` and ``last``, and the
    ``site``/``attempts`` it burned."""

    def __init__(self, site: str, attempts: int, last: BaseException,
                 deadline_hit: bool = False):
        why = "deadline exceeded" if deadline_hit else "attempts exhausted"
        super().__init__(
            f"{site}: {why} after {attempts} attempt(s); "
            f"last error: {last!r}")
        self.site = site
        self.attempts = attempts
        self.last = last
        self.deadline_hit = deadline_hit


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` tries, exponential backoff from
    ``base_delay_seconds`` capped at ``max_delay_seconds``, an optional
    wall-clock ``deadline_seconds`` over the whole call, and the exception
    classes worth retrying (minus ``permanent_on``)."""

    max_attempts: int = 4
    base_delay_seconds: float = 0.02
    max_delay_seconds: float = 1.0
    deadline_seconds: Optional[float] = None
    retry_on: tuple = (OSError, InjectedFault)
    permanent_on: tuple = (FileNotFoundError,)
    seed: int = 0


#: 4 attempts, ~20/40/80 ms jittered backoff.
DEFAULT_POLICY = RetryPolicy()


def _jitter_factor(seed: int, site: str, attempt: int) -> float:
    """Deterministic jitter in [0.5, 1.0) from (seed, site, attempt)."""
    key = f"{seed}:{site}:{attempt}".encode("utf-8")
    h = int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "big")
    return 0.5 + (h / 2.0 ** 64) * 0.5


def backoff_delays(site: str, policy: RetryPolicy = DEFAULT_POLICY
                   ) -> list[float]:
    """The sleep schedule :func:`call_with_retry` walks for ``site``:
    ``min(base * 2^n, max) * jitter(seed, site, n)`` per retry slot."""
    out = []
    for attempt in range(max(policy.max_attempts - 1, 0)):
        raw = min(policy.base_delay_seconds * (2.0 ** attempt),
                  policy.max_delay_seconds)
        out.append(raw * _jitter_factor(policy.seed, site, attempt))
    return out


def call_with_retry(fn: Callable[[], T], site: str,
                    policy: RetryPolicy = DEFAULT_POLICY,
                    warn: Optional[Callable[[str], None]] = None) -> T:
    """Run ``fn`` with the retry protocol for ``site``; each retry runs in
    a ``retry.attempt`` span and counts on ``retries{site}``; the last
    error of an exhausted schedule is wrapped in
    :class:`RetryExhaustedError`."""
    t0 = time.monotonic()
    delays = backoff_delays(site, policy)
    attempt = 0
    while True:
        try:
            if attempt == 0:
                return fn()
            with trace.span("retry.attempt", site=site, attempt=attempt):
                return fn()
        except policy.retry_on as e:
            if isinstance(e, policy.permanent_on):
                raise
            attempt += 1
            if attempt >= policy.max_attempts:
                raise RetryExhaustedError(site, attempt, e) from e
            delay = delays[attempt - 1]
            if (policy.deadline_seconds is not None
                    and time.monotonic() - t0 + delay
                    > policy.deadline_seconds):
                raise RetryExhaustedError(site, attempt, e,
                                          deadline_hit=True) from e
            REGISTRY.counter("retries").inc(site=site)
            if warn is not None:
                warn(f"{site}: attempt {attempt} failed ({e!r}); "
                     f"retrying in {delay * 1e3:.0f} ms")
            time.sleep(delay)
