"""Device-memory accounting: HBM gauges, peaks, per-coordinate watermarks.

Port of ``photon_ml_tpu/obs/devicemem.py`` (``arm``, ``sample``,
``peak_bytes``, ``note_coordinate``, ``drain_coordinate_watermarks``), the
device-plane half of ``--device-telemetry``. Armed, it:

- samples the caching allocator of every visible CUDA device
  (``torch.cuda.memory_stats(device)``) at heartbeat cadence (the
  ObservedRun's span-spill hook) into the ``hbm_bytes{device, kind}``
  gauge family: ``bytes_in_use`` is ``allocated_bytes.all.current``,
  ``peak_bytes_in_use`` ``allocated_bytes.all.peak`` (what
  ``torch.cuda.max_memory_allocated`` reads), ``bytes_reserved``
  ``reserved_bytes.all.current`` and ``largest_alloc_size``
  ``allocated_bytes.large_pool.peak``; ``bytes_limit`` is the card's
  total memory. Reading the allocator's counters is host work: it never
  synchronises the device;
- on the CPU (no CUDA device, or a run on ``--device cpu``) the family
  still exists, as the JAX package's ``live_bytes`` fallback gives it
  there: ``hbm_bytes{device="host", kind="live_bytes"}`` is the sum of
  ``untyped_storage().nbytes()`` over the distinct storages of the torch
  tensors the garbage collector tracks (:func:`live_bytes`; metadata
  only, never a tensor's values);
- tracks the run-wide peak (:func:`peak_bytes`) over every sample: the
  largest ``peak_bytes_in_use`` seen (on the CPU the largest
  ``live_bytes``), which the ObservedRun stamps into the ``run_end``
  record as ``peak_hbm_bytes``;
- attributes watermarks per coordinate: the coordinate-descent commit
  calls :func:`note_coordinate` after installing a block, and the
  sweep-boundary drain calls :func:`drain_coordinate_watermarks`,
  emitting ``hbm_watermark_bytes{coordinate}`` plus one
  ``cd.hbm_watermark`` span per coordinate touched that sweep.

Everything is gated on :func:`armed`, so the un-flagged hot path pays one
module-global check.
"""

from __future__ import annotations

import gc
import threading
from typing import Optional

from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

_ARMED = False
_REGISTRY: MetricsRegistry = REGISTRY
_LOCK = threading.Lock()
_PEAK_BYTES = 0
#: coordinate id -> max bytes in use observed at any of its commits since
#: the last sweep-boundary drain.
_COORD_WATERMARKS: dict[str, int] = {}

#: ``hbm_bytes`` kind -> the ``torch.cuda.memory_stats`` key it reads.
_STAT_KINDS = (("bytes_in_use", "allocated_bytes.all.current"),
               ("peak_bytes_in_use", "allocated_bytes.all.peak"),
               ("bytes_reserved", "reserved_bytes.all.current"),
               ("largest_alloc_size", "allocated_bytes.large_pool.peak"))


def arm(registry: Optional[MetricsRegistry] = None) -> None:
    global _ARMED, _REGISTRY, _PEAK_BYTES
    _REGISTRY = registry or REGISTRY
    with _LOCK:
        _PEAK_BYTES = 0
        _COORD_WATERMARKS.clear()
    _ARMED = True


def disarm() -> None:
    global _ARMED
    _ARMED = False


def armed() -> bool:
    return _ARMED


def peak_bytes() -> int:
    """Run-wide device-memory peak over every :func:`sample` (bytes)."""
    with _LOCK:
        return _PEAK_BYTES


def live_bytes() -> int:
    """Σ storage bytes over the distinct storages of the torch tensors
    the garbage collector tracks (every device) — metadata only."""
    import torch

    seen: set = set()
    total = 0
    for obj in gc.get_objects():
        try:
            # the object's real type: a module-level proxy's ``__class__``
            # may warn or raise
            if not issubclass(type(obj), torch.Tensor):
                continue
            storage = obj.untyped_storage()
            key = (storage.device.type, storage.device.index,
                   storage.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            total += int(storage.nbytes())
        except (RuntimeError, ReferenceError):
            continue  # a tensor without storage (meta, sparse)
    return total


def bytes_in_use(device=None) -> int:
    """Bytes the process holds on ``device`` now: the CUDA allocator's
    ``memory_allocated`` on a CUDA device, else :func:`live_bytes`."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.memory_allocated(device))
    return live_bytes()


def _note_peak(n: int) -> None:
    global _PEAK_BYTES
    with _LOCK:
        if n > _PEAK_BYTES:
            _PEAK_BYTES = n


def sample(registry: Optional[MetricsRegistry] = None) -> int:
    """One heartbeat-cadence sample of every CUDA device's allocator into
    ``hbm_bytes{device, kind}`` (``live_bytes`` on the host without
    CUDA). Returns the total bytes in use across devices."""
    if not _ARMED:
        return 0
    import torch

    reg = registry or _REGISTRY
    gauge = reg.gauge("hbm_bytes")
    total_in_use = peak = 0
    devices = (range(torch.cuda.device_count())
               if torch.cuda.is_available() else ())
    for index in devices:
        stats = torch.cuda.memory_stats(index)
        dev = f"cuda:{index}"
        for kind, key in _STAT_KINDS:
            if key in stats:
                gauge.set(int(stats[key]), device=dev, kind=kind)
        gauge.set(int(torch.cuda.get_device_properties(index).total_memory),
                  device=dev, kind="bytes_limit")
        total_in_use += int(stats.get("allocated_bytes.all.current", 0))
        peak = max(peak, int(stats.get("allocated_bytes.all.peak", 0)))
    if not devices:
        total_in_use = peak = live_bytes()
        gauge.set(total_in_use, device="host", kind="live_bytes")
    _note_peak(peak)
    return total_in_use


def note_coordinate(coordinate_id: str, device=None) -> None:
    """Record the bytes in use on ``device`` against a coordinate, right
    after its block installs (the update's most buffer-heavy point the
    host can see)."""
    if not _ARMED:
        return
    n = bytes_in_use(device)
    with _LOCK:
        prev = _COORD_WATERMARKS.get(coordinate_id, 0)
        if n > prev:
            _COORD_WATERMARKS[coordinate_id] = n


def drain_coordinate_watermarks(
        sweep: int, registry: Optional[MetricsRegistry] = None) -> dict:
    """Flush the sweep's per-coordinate watermarks into
    ``hbm_watermark_bytes{coordinate}`` gauges + ``cd.hbm_watermark``
    spans (rides the sweep-boundary drain). Returns the drained map."""
    if not _ARMED:
        return {}
    with _LOCK:
        drained = dict(_COORD_WATERMARKS)
        _COORD_WATERMARKS.clear()
    if not drained:
        return drained
    reg = registry or _REGISTRY
    gauge = reg.gauge("hbm_watermark_bytes")
    for cid, n in sorted(drained.items()):
        gauge.set(n, coordinate=cid)
        with trace.span("cd.hbm_watermark", sweep=sweep, coordinate=cid,
                        watermark_bytes=n):
            pass
    return drained
