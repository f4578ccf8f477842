"""Mid-training checkpoint/resume for coordinate descent.

Port of ``photon_ml_tpu/utils/checkpoint.py`` — ``CheckpointManager``,
``dumps_state``/``loads_state``, ``CheckpointCorruptionError`` and
``CheckpointWriteError`` — with the same on-disk format, so either
package restores the other's steps: one ``step_<n>/`` directory per step
holding ``manifest.json`` (the structure skeleton of ``_flatten``, the
scalars, and the crc32 of the payload) and ``arrays.npz`` (the array
leaves, keyed by their path in the structure).

Durability, as in the JAX package: the payload is written into
``step_<n>.tmp``, checksummed and fsync'd, and published by an atomic
rename; :meth:`CheckpointManager.latest_valid_step` falls back past torn
or corrupt steps; retention never prunes the last restorable step; a
``.tmp`` left by a killed save is ignored and swept. The fault points
``ckpt.write_bytes``, ``ckpt.save`` and ``ckpt.restore`` sit where the
JAX package has them. The JAX version also opens ``obs.trace`` spans;
the port has no tracing yet and keeps times and sizes in
:data:`CHECKPOINT_STATS` instead.

:meth:`CheckpointManager.save` takes numpy leaves only: a tensor on the
card would be fetched leaf by leaf, so the caller moves the whole payload
to the host in one batch first (``run_coordinate_descent`` does).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import time
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.utils.faults import fault_point, hits as fault_hits
from photon_ml_tpu_torch.utils.retry import (
    RetryExhaustedError,
    RetryPolicy,
    call_with_retry,
)

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_STEP_PREFIX = "step_"
_TMP_SUFFIX = ".tmp"

#: Retry schedule of the payload write (the ``ckpt.write_bytes`` site).
_WRITE_RETRY = RetryPolicy(max_attempts=4, base_delay_seconds=0.02,
                           max_delay_seconds=0.5)

#: Saves and restores in this process: counts, wall seconds (last and
#: total) and the last published step's ``arrays.npz`` size in bytes.
CHECKPOINT_STATS = {"saves": 0, "save_seconds": 0.0,
                    "last_save_seconds": 0.0, "bytes": 0,
                    "restores": 0, "restore_seconds": 0.0,
                    "last_restore_seconds": 0.0, "save_failures": 0}


def reset_checkpoint_stats() -> None:
    CHECKPOINT_STATS.update({"saves": 0, "save_seconds": 0.0,
                             "last_save_seconds": 0.0, "bytes": 0,
                             "restores": 0, "restore_seconds": 0.0,
                             "last_restore_seconds": 0.0,
                             "save_failures": 0})


class CheckpointCorruptionError(RuntimeError):
    """An explicitly requested step failed integrity verification, or no
    step in a non-empty directory did."""


#: What a torn-but-checksummed step raises on read.
_UNREADABLE_STEP_ERRORS = (OSError, ValueError, KeyError,
                           zipfile.BadZipFile)


class CheckpointWriteError(RuntimeError):
    """A snapshot could not be written durably (retries exhausted, e.g. a
    persistently full disk)."""


def _flatten(obj: Any, path: str, arrays: dict[str, np.ndarray]):
    """Structure with array leaves -> JSON-able skeleton + array table
    (the JAX package's skeleton, key for key)."""
    if isinstance(obj, dict):
        return {"__kind__": "dict",
                "items": {k: _flatten(v, f"{path}.{k}", arrays)
                          for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"__kind__": "list" if isinstance(obj, list) else "tuple",
                "items": [_flatten(v, f"{path}[{i}]", arrays)
                          for i, v in enumerate(obj)]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"__kind__": "scalar", "value": obj}
    if isinstance(obj, torch.Tensor):
        raise TypeError(
            f"checkpoint leaf {path} is a torch tensor: move the payload to "
            f"the host in one batch and pass numpy arrays")
    arr = np.asarray(obj)
    arrays[path] = arr
    return {"__kind__": "array", "key": path, "dtype": str(arr.dtype)}


def _unflatten(spec: Any, arrays: dict[str, np.ndarray]) -> Any:
    kind = spec["__kind__"]
    if kind == "dict":
        return {k: _unflatten(v, arrays) for k, v in spec["items"].items()}
    if kind in ("list", "tuple"):
        items = [_unflatten(v, arrays) for v in spec["items"]]
        return items if kind == "list" else tuple(items)
    if kind == "scalar":
        return spec["value"]
    return arrays[spec["key"]]


def dumps_state(state: Any) -> bytes:
    """A checkpoint-shaped structure as one self-describing byte string:
    the skeleton + npz format of a step, zipped in memory."""
    arrays: dict[str, np.ndarray] = {}
    skeleton = _flatten(state, "root", arrays)
    arrays["__skeleton__"] = np.frombuffer(
        json.dumps(skeleton).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def loads_state(data: bytes) -> Any:
    """Inverse of :func:`dumps_state`."""
    with np.load(io.BytesIO(data)) as npz:
        arrays = {k: npz[k] for k in npz.files}
    skeleton = json.loads(arrays.pop("__skeleton__").tobytes().decode())
    return _unflatten(skeleton, arrays)


def _file_crc32(path: str) -> str:
    crc = 0
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without directory fds
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointManager:
    """Step-indexed checkpoint directory with retention + integrity."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{step:08d}")

    def all_steps(self) -> list[int]:
        """Published steps (a manifest present, no ``.tmp`` suffix)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(_STEP_PREFIX) \
                    and not name.endswith(_TMP_SUFFIX):
                manifest = os.path.join(self.directory, name, _MANIFEST)
                if os.path.exists(manifest):
                    steps.append(int(name[len(_STEP_PREFIX):]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- integrity ---------------------------------------------------------

    def verify_step(self, step: int) -> bool:
        """True when ``step``'s manifest parses and every checksummed file
        is present with a matching crc32 (v1 manifests without checksums
        pass on the payload's presence)."""
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, _MANIFEST)) as fh:
                manifest = json.load(fh)
        except (OSError, ValueError):
            return False
        if manifest.get("step") != step or "skeleton" not in manifest:
            return False
        checksums = manifest.get("checksums")
        if checksums is None:
            return os.path.exists(os.path.join(d, _ARRAYS))
        for name, crc in checksums.items():
            try:
                if _file_crc32(os.path.join(d, name)) != crc:
                    return False
            except OSError:
                return False
        return True

    def latest_valid_step(self) -> Optional[int]:
        """Newest step that passes verification, scanning back past
        truncated, corrupt or partial steps."""
        for step in reversed(self.all_steps()):
            if self.verify_step(step):
                return step
        return None

    def clean_stale_tmp(self) -> int:
        """Remove ``step_*.tmp`` dirs left by a save killed before its
        rename; returns how many were removed."""
        removed = 0
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        for name in names:
            if name.startswith(_STEP_PREFIX) and name.endswith(_TMP_SUFFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
                removed += 1
        return removed

    # -- save/restore ------------------------------------------------------

    def save(self, step: int, state: Any) -> None:
        """Durable and atomic: write, checksum and fsync into a tmp dir,
        then rename, in a ``ckpt.save`` span. A transient write failure
        (``ckpt.write_bytes``) rewrites the tmp dir; a persistent one
        raises :class:`CheckpointWriteError` with the tmp dir removed."""
        with trace.span("ckpt.save", step=step):
            self._save(step, state)

    def _save(self, step: int, state: Any) -> None:
        t0 = time.perf_counter()
        self.clean_stale_tmp()
        final = self._step_dir(step)
        tmp = final + _TMP_SUFFIX
        arrays: dict[str, np.ndarray] = {}
        skeleton = _flatten(state, "root", arrays)
        arrays_path = os.path.join(tmp, _ARRAYS)

        def write_tmp():
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(arrays_path, **arrays)
            # between the payload write and its checksum: a `partial` drill
            # here is a torn write whose crc records the torn bytes
            fault_point("ckpt.write_bytes", path=arrays_path)
            _fsync_file(arrays_path)
            # the manifest last: its presence marks the step complete
            with open(os.path.join(tmp, _MANIFEST), "w") as fh:
                json.dump(
                    {"step": step, "format_version": 2,
                     "checksums": {_ARRAYS: _file_crc32(arrays_path)},
                     "skeleton": skeleton}, fh)
                fh.flush()
                os.fsync(fh.fileno())

        try:
            call_with_retry(write_tmp, site="ckpt.write_bytes",
                            policy=_WRITE_RETRY)
        except RetryExhaustedError as e:
            shutil.rmtree(tmp, ignore_errors=True)
            raise CheckpointWriteError(
                f"checkpoint step {step} under {self.directory} "
                f"could not be written: {e}") from e
        nbytes = os.path.getsize(arrays_path)
        fired_before = fault_hits("ckpt.save")
        fault_point("ckpt.save", path=tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        # the bytes just checksummed are known good unless a ckpt.save
        # drill touched them after the checksum
        self._retain(trusted_step=(
            None if fault_hits("ckpt.save") != fired_before else step))
        dt = time.perf_counter() - t0
        CHECKPOINT_STATS["saves"] += 1
        CHECKPOINT_STATS["save_seconds"] += dt
        CHECKPOINT_STATS["last_save_seconds"] = dt
        CHECKPOINT_STATS["bytes"] = nbytes

    def raise_if_all_corrupt(self) -> None:
        """Raise :class:`CheckpointCorruptionError` when the directory has
        steps but none passes verification (a caller must not silently
        retrain from scratch over recoverable data loss)."""
        if self.all_steps() and self.latest_valid_step() is None:
            raise CheckpointCorruptionError(
                f"checkpoint dir {self.directory} holds "
                f"{len(self.all_steps())} step(s) but none passes "
                f"integrity verification — refusing to silently start "
                f"over; clear the directory to retrain from scratch")

    def _latest_valid_or_raise(self) -> int:
        step = self.latest_valid_step()
        if step is not None:
            return step
        self.raise_if_all_corrupt()
        raise FileNotFoundError(
            f"no valid checkpoints under {self.directory}")

    def _read_step(self, step: int) -> Any:
        d = self._step_dir(step)
        with open(os.path.join(d, _MANIFEST)) as fh:
            manifest = json.load(fh)
        with np.load(os.path.join(d, _ARRAYS)) as npz:
            arrays = {k: npz[k] for k in npz.files}
        return _unflatten(manifest["skeleton"], arrays)

    def restore(self, step: Optional[int] = None) -> Any:
        """Restore ``step``, or by default the newest step that verifies
        and loads. An explicit corrupt step, or a directory with steps but
        none intact, raises :class:`CheckpointCorruptionError`; a
        directory without steps raises ``FileNotFoundError`` (a fresh
        run). ``ckpt.restore`` fires on the chosen step before it is
        read. Runs in a ``ckpt.restore`` span."""
        t0 = time.perf_counter()
        with trace.span("ckpt.restore",
                        step=(-1 if step is None else step)):
            out = self._restore(step)
        dt = time.perf_counter() - t0
        CHECKPOINT_STATS["restores"] += 1
        CHECKPOINT_STATS["restore_seconds"] += dt
        CHECKPOINT_STATS["last_restore_seconds"] = dt
        return out

    def _restore(self, step: Optional[int]) -> Any:
        self.clean_stale_tmp()
        explicit = step is not None
        if not explicit:
            step = self._latest_valid_or_raise()
        fired_before = fault_hits("ckpt.restore")
        fault_point("ckpt.restore", path=self._step_dir(step))
        if explicit:
            if not self.verify_step(step):
                raise CheckpointCorruptionError(
                    f"checkpoint step {step} under {self.directory} "
                    f"failed integrity verification")
        elif fault_hits("ckpt.restore") != fired_before:
            # a drill just touched the chosen step: resolve again
            step = self._latest_valid_or_raise()
        try:
            return self._read_step(step)
        except _UNREADABLE_STEP_ERRORS as e:
            if explicit:
                raise CheckpointCorruptionError(
                    f"checkpoint step {step} under {self.directory} "
                    f"verified but could not be loaded: {e!r}") from e
            unreadable = {step}
        for cand in reversed(self.all_steps()):
            if cand in unreadable or not self.verify_step(cand):
                continue
            try:
                return self._read_step(cand)
            except _UNREADABLE_STEP_ERRORS:
                unreadable.add(cand)
        raise CheckpointCorruptionError(
            f"checkpoint dir {self.directory} has no step that both "
            f"verifies and loads ({len(unreadable)} verified step(s) "
            f"failed to read — torn writes?); clear the directory to "
            f"retrain from scratch")

    def _step_loadable(self, step: int) -> bool:
        """Opening the npz's zip directory detects a torn write that still
        checksums; byte flips are the crc scan's job."""
        try:
            with zipfile.ZipFile(
                    os.path.join(self._step_dir(step), _ARRAYS)):
                return True
        except (OSError, zipfile.BadZipFile):
            return False

    def _retain(self, trusted_step: Optional[int] = None) -> None:
        """Prune to the newest ``max_to_keep`` steps, but keep the newest
        restorable step outside the window when none inside it is
        restorable (``photon_ml_tpu/utils/checkpoint.py:416``)."""
        if self.max_to_keep is None:
            return
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        keep = set(steps[-self.max_to_keep:])

        def restorable(s: int) -> bool:
            return ((s == trusted_step or self.verify_step(s))
                    and self._step_loadable(s))

        if not any(restorable(s) for s in sorted(keep, reverse=True)):
            for s in reversed(steps):
                if s not in keep and restorable(s):
                    keep.add(s)
                    break
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)
