"""Deterministic fault injection: named fault points with scripted failures.

Port of ``photon_ml_tpu/utils/faults.py`` — ``FaultSpec``,
``FaultRegistry``, ``parse_fault_specs`` (``:413``), ``fault_point``
(``:521``), ``arm``/``disarm_all``/``hits``, ``poison_arrays`` (``:441``)
and the path mutators. The environment variables (``PHOTON_FAULTS``,
``PHOTON_FAULTS_STATE_DIR``, ``PHOTON_FAULTS_SEED``), the modes and the
``flaky`` decision hash are the JAX package's, so one ``PHOTON_FAULTS``
string drills either package the same way.

Production code calls :func:`fault_point` at named sites; tests (or an
operator drilling a run) arm failures against those names. Modes:

- ``raise``    — raise :class:`InjectedFault`
- ``nan``      — NaN-fill the floating tensors/arrays passed to the point
                 (integer ones are left as they are)
- ``delay``    — sleep ``arg`` seconds (default 1.0)
- ``slow``     — sleep like ``delay`` with a small default (0.05 s)
- ``corrupt``  — flip bytes in the middle of the file/dir passed
- ``partial``  — truncate the file/dir passed to half its size
- ``kill``     — ``os._exit(arg)`` (default 17)
- ``signal``   — ``os.kill(os.getpid(), SIGTERM)``: the preemption drill
                 (the driver's stop handler latches and training runs on to
                 its next commit barrier)
- ``io_error`` — raise ``OSError(EIO)``
- ``enospc``   — raise ``OSError(ENOSPC)``
- ``flaky``    — ``OSError(EIO)`` on a visit with probability ``arg``
                 (default 0.5), decided by a keyed hash of
                 (``PHOTON_FAULTS_SEED``, point, tag, visit index)

Arming: ``arm("cd.update", "raise", times=2)`` or
``PHOTON_FAULTS="cd.update@1.1=kill:1:19;ckpt.save=raise:1"`` —
``point[@tag]=mode[:times[:arg]]``, ``;``-separated. With
``PHOTON_FAULTS_STATE_DIR`` set, each firing claims a marker file there
(``O_CREAT|O_EXCL``), so a ``times=1`` kill fires in exactly one process
even when the run is relaunched with the same environment.
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import os
import threading
import time
from typing import Any, Optional

ENV_SPECS = "PHOTON_FAULTS"
ENV_STATE_DIR = "PHOTON_FAULTS_STATE_DIR"
ENV_SEED = "PHOTON_FAULTS_SEED"

MODES = ("raise", "nan", "delay", "slow", "corrupt", "partial", "kill",
         "signal", "io_error", "enospc", "flaky")


@dataclasses.dataclass(frozen=True)
class FaultPointInfo:
    """One instrumented fault site and the modes that make sense there."""

    description: str
    modes: tuple[str, ...]
    has_path: bool = False  # the site passes a file/dir (corrupt/partial)


#: The fault points the port instruments (a subset of the JAX package's
#: registry, with the same names, tags and modes).
FAULT_POINTS: dict[str, FaultPointInfo] = {
    "cd.update": FaultPointInfo(
        "after each coordinate update, on the candidate state "
        "(game/coordinate_descent.py); tag <sweep>.<coordinate_index>",
        modes=("raise", "nan", "delay", "kill", "signal")),
    "cd.sweep": FaultPointInfo(
        "at the top of each coordinate-descent sweep; tag = sweep index",
        modes=("delay", "kill", "signal")),
    "optimizer.gradient": FaultPointInfo(
        "on the solver output of a GLM solve (optimize/problem.py)",
        modes=("raise", "nan")),
    "ckpt.save": FaultPointInfo(
        "after a snapshot's tmp dir is written, before the atomic rename "
        "(utils/checkpoint.py)",
        modes=("raise", "kill", "corrupt"), has_path=True),
    "ckpt.restore": FaultPointInfo(
        "on the snapshot about to be read, before it is read "
        "(utils/checkpoint.py)",
        modes=("raise", "corrupt"), has_path=True),
    "ckpt.write_bytes": FaultPointInfo(
        "after the snapshot's array payload is written, before it is "
        "checksummed (utils/checkpoint.py)",
        modes=("io_error", "enospc", "flaky", "partial", "kill", "signal"),
        has_path=True),
    "io.shard_open": FaultPointInfo(
        "before an Avro shard's bytes are opened (io/avro.py "
        "read_container and check_container_framing, io/native_avro.py "
        "_read_blocks); tag = shard basename",
        modes=("raise", "io_error", "flaky", "slow", "delay")),
    "io.avro_read": FaultPointInfo(
        "per shard at decode time (io/avro.py read_shard, io/data_format.py "
        "_columnar_part_or_quarantine); tag = shard basename; "
        "corrupt/partial mutate the shard on disk",
        modes=("raise", "io_error", "corrupt", "partial", "flaky"),
        has_path=True),
    "io.index_map": FaultPointInfo(
        "on a feature name-and-term set load (io/data_format.py "
        "NameAndTermFeatureSets.load); tag = directory basename",
        modes=("raise", "io_error", "flaky", "slow")),
}


class InjectedFault(RuntimeError):
    """Raised by a ``raise``-mode fault point (and by mis-armed specs)."""

    def __init__(self, point: str, message: str = ""):
        super().__init__(message or f"injected fault at {point!r}")
        self.point = point


@dataclasses.dataclass
class FaultSpec:
    """One armed failure: fires at ``point`` up to ``times`` times.
    ``probability`` only matters for ``flaky``."""

    point: str
    mode: str
    times: int = 1
    tag: Optional[str] = None  # only fire for matching fault_point(tag=...)
    # None = the mode's default (1.0 s for delay, 0.05 s for slow)
    delay_seconds: Optional[float] = None
    exit_code: int = 17
    probability: float = 0.5
    fired: int = 0
    visits: int = 0  # flaky-mode visit counter (the decision index)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; "
                             f"expected one of {MODES}")
        if self.delay_seconds is None:
            self.delay_seconds = 0.05 if self.mode == "slow" else 1.0
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(
                f"flaky probability must be in [0, 1], "
                f"got {self.probability}")


def flaky_decision(seed: int, point: str, tag: Optional[str],
                   visit: int, probability: float) -> bool:
    """Deterministic per-visit firing decision for ``flaky`` mode: a
    blake2b hash of (seed, point, tag, visit) mapped to [0, 1) and
    compared against ``probability``."""
    if probability <= 0.0:
        return False
    if probability >= 1.0:
        return True
    key = f"{seed}:{point}:{tag or ''}:{visit}".encode("utf-8")
    h = int.from_bytes(
        hashlib.blake2b(key, digest_size=8).digest(), "big")
    return (h / 2.0 ** 64) < probability


class FaultRegistry:
    """Thread-safe registry of armed specs + per-point hit counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: list[FaultSpec] = []
        self._hits: dict[str, int] = {}
        self._env_loaded = False

    def arm(self, point: str, mode: str, times: int = 1,
            tag: Optional[str] = None,
            delay_seconds: Optional[float] = None,
            exit_code: int = 17, probability: float = 0.5) -> FaultSpec:
        spec = FaultSpec(point=point, mode=mode, times=times, tag=tag,
                         delay_seconds=delay_seconds, exit_code=exit_code,
                         probability=probability)
        with self._lock:
            self._specs.append(spec)
        return spec

    def disarm_all(self) -> None:
        with self._lock:
            self._specs.clear()
            self._hits.clear()
            # a later PHOTON_FAULTS change is read again after a reset
            self._env_loaded = False

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def _ensure_env_loaded(self) -> None:
        with self._lock:
            if self._env_loaded:
                return
            self._env_loaded = True
            raw = os.environ.get(ENV_SPECS, "")
        for spec in parse_fault_specs(raw):
            with self._lock:
                self._specs.append(spec)

    def _claim(self, spec: FaultSpec) -> bool:
        """Reserve one firing of ``spec``; False when its budget is spent.
        With a state dir the budget is shared across processes through
        exclusive-create marker files named as the JAX package names
        them."""
        state_dir = os.environ.get(ENV_STATE_DIR)
        if not state_dir:
            with self._lock:
                if spec.fired >= spec.times:
                    return False
                spec.fired += 1
                return True
        os.makedirs(state_dir, exist_ok=True)
        key = "_".join(str(p) for p in (
            spec.point, spec.tag or "", spec.mode, spec.times,
            spec.delay_seconds, spec.exit_code,
            spec.probability)).replace(os.sep, "_")
        for n in range(spec.times):
            marker = os.path.join(state_dir, f"{key}.{n}")
            try:
                fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                with self._lock:
                    spec.fired += 1
                return True
            except FileExistsError:
                continue
        return False

    def fire(self, point: str, tag: Optional[str] = None,
             arrays: Any = None, path: Optional[str] = None) -> Any:
        """Run the fault protocol for ``point``; returns ``arrays``
        (possibly poisoned). See :func:`fault_point`."""
        self._ensure_env_loaded()
        with self._lock:
            specs = [s for s in self._specs
                     if s.point == point and (s.tag is None or s.tag == tag)]
        if not specs:
            return arrays
        for spec in specs:
            if spec.mode == "flaky":
                with self._lock:
                    visit = spec.visits
                    spec.visits += 1
                seed = int(os.environ.get(ENV_SEED, "0") or 0)
                if not flaky_decision(seed, point, tag, visit,
                                      spec.probability):
                    continue
            if not self._claim(spec):
                continue
            with self._lock:
                self._hits[point] = self._hits.get(point, 0) + 1
            if spec.mode == "raise":
                raise InjectedFault(point)
            if spec.mode in ("io_error", "flaky"):
                raise OSError(errno.EIO, f"injected I/O error at {point!r}")
            if spec.mode == "enospc":
                raise OSError(errno.ENOSPC, f"injected ENOSPC at {point!r}")
            if spec.mode in ("delay", "slow"):
                time.sleep(spec.delay_seconds)
            elif spec.mode == "kill":
                os._exit(spec.exit_code)
            elif spec.mode == "signal":
                import signal as _signal

                os.kill(os.getpid(), _signal.SIGTERM)
            elif spec.mode == "nan":
                arrays = poison_arrays(arrays)
            elif spec.mode in ("corrupt", "partial"):
                if path is None:
                    raise InjectedFault(
                        point, f"{spec.mode}-mode fault at {point!r} "
                               f"needs a path at the call site")
                (corrupt_path if spec.mode == "corrupt"
                 else truncate_path)(path)
        return arrays


def parse_fault_specs(raw: str) -> list[FaultSpec]:
    """Parse the ``PHOTON_FAULTS`` syntax (see the module docstring)."""
    specs = []
    for item in raw.split(";"):
        item = item.strip()
        if not item:
            continue
        name, _, rhs = item.partition("=")
        if not rhs:
            raise ValueError(f"bad fault spec {item!r}: expected "
                             f"point[@tag]=mode[:times[:arg]]")
        point, _, tag = name.partition("@")
        parts = rhs.split(":")
        mode = parts[0]
        times = int(parts[1]) if len(parts) > 1 and parts[1] else 1
        kwargs: dict[str, Any] = {}
        if len(parts) > 2 and parts[2]:
            if mode in ("delay", "slow"):
                kwargs["delay_seconds"] = float(parts[2])
            elif mode == "kill":
                kwargs["exit_code"] = int(parts[2])
            elif mode == "flaky":
                kwargs["probability"] = float(parts[2])
        specs.append(FaultSpec(point=point.strip(), mode=mode, times=times,
                               tag=tag or None, **kwargs))
    return specs


def poison_arrays(arrays: Any) -> Any:
    """NaN-fill every floating tensor or array of a (possibly nested)
    structure; integer and bool leaves, scalars and ``None`` pass through
    (a NaN-filled integer would be a finite sentinel that no finiteness
    guard catches)."""
    import numpy as np
    import torch

    if arrays is None:
        return None
    if isinstance(arrays, dict):
        return {k: poison_arrays(v) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(poison_arrays(v) for v in arrays)
    if isinstance(arrays, torch.Tensor):
        if not arrays.is_floating_point():
            return arrays
        return torch.full_like(arrays, float("nan"))
    if isinstance(arrays, np.ndarray):
        if not np.issubdtype(arrays.dtype, np.inexact):
            return arrays
        return np.full_like(arrays, np.nan)
    return arrays


def truncate_path(path: str) -> None:
    """Truncate ``path`` (a file) to half its size, or every regular file
    under it (a directory): a torn write."""
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            sub = os.path.join(path, name)
            if os.path.isfile(sub):
                truncate_path(sub)
        return
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size // 2)


def corrupt_path(path: str) -> None:
    """Flip up to 64 bytes in the middle of ``path`` (a file), or of every
    regular file under it (a directory)."""
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            sub = os.path.join(path, name)
            if os.path.isfile(sub):
                corrupt_path(sub)
        return
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.seek(size // 2)
        chunk = fh.read(min(64, max(1, size - size // 2)))
        fh.seek(size // 2)
        fh.write(bytes(b ^ 0xFF for b in chunk))


_REGISTRY = FaultRegistry()


def arm(point: str, mode: str, times: int = 1, tag: Optional[str] = None,
        **kwargs) -> FaultSpec:
    """Arm a fault programmatically; see :meth:`FaultRegistry.arm`."""
    return _REGISTRY.arm(point, mode, times=times, tag=tag, **kwargs)


def disarm_all() -> None:
    _REGISTRY.disarm_all()


def hits(point: str) -> int:
    """How many times faults fired at ``point`` in this process."""
    return _REGISTRY.hits(point)


def fault_point(point: str, tag: Optional[str] = None, arrays: Any = None,
                path: Optional[str] = None) -> Any:
    """Declare a named fault site. A no-op (returns ``arrays`` unchanged)
    unless a matching spec is armed through :func:`arm` or
    ``PHOTON_FAULTS``. ``arrays`` is what a ``nan`` fault poisons, ``path``
    what ``corrupt``/``partial`` mutate, ``tag`` lets a spec target one
    call site among many."""
    return _REGISTRY.fire(point, tag=tag, arrays=arrays, path=path)
