"""Device mesh and sharding policy.

Port of ``photon_ml_tpu/parallel/mesh.py:47-185``. A :class:`Mesh` is an
explicit grid of ``torch.device``s shaped data x entity
(``make_mesh``, ``:91-109``):

- ``data`` shards example rows (the fixed-effect reductions);
- ``entity`` shards per-entity blocks (the random effect).

The process-wide default mesh (``set_default_mesh``/``get_default_mesh``)
is the drivers' distribution context: with a data axis > 1,
``GLMOptimizationProblem.run`` routes fixed-effect solves through the
shard runner (``parallel/distributed.py``), and a random effect with
``entity_shards`` > 1 splits its lanes over the entity axis.

:func:`setup_default_mesh` builds the mesh over every visible device of
one type: all ``torch.cuda.device_count()`` cards for ``cuda``, the one
CPU for ``cpu``; one device gives no mesh. Asking for CUDA without it
raises, as every entry point of the port does. :func:`make_mesh` takes
an explicit device list in which a device may repeat: that is how the
CPU tests run 2, 4 or 8 shards in one process and the one card runs 4.

A mesh may span the processes of a gang (``make_mesh(..., span=,
span_axis=)``; ``parallel/multihost.py`` forms the gang): its device grid
is this process's, and one axis, ``span_axis``, continues over every
process, process-major. ``shape`` is then the global shape (that axis
times the process count), as a JAX mesh over every host's devices has;
``axis_devices`` and ``local_shape`` are this process's, and the shard
runner's collectives over that axis gather every process's shards
(``collectives.ProcessSpan``).

A placement (:func:`data_sharding`) says how a tensor is laid over the
mesh (a replicated input is the shard runner's ``None`` spec,
``collectives.shard_map``); :func:`shard_batch` splits a batch's rows over the
data-axis devices (rows must divide: ``data/batch.pad_batch`` pads).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import DenseBatch, EllBatch
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.parallel.collectives import ProcessSpan

DATA_AXIS = "data"
ENTITY_AXIS = "entity"

_default_mesh: Optional["Mesh"] = None


class Mesh:
    """A data x entity grid of devices (``jax.sharding.Mesh`` with the
    axes ``(DATA_AXIS, ENTITY_AXIS)``)."""

    def __init__(self, devices: np.ndarray,
                 span: Optional[ProcessSpan] = None,
                 span_axis: Optional[str] = None):
        if devices.ndim != 2:
            raise ValueError(f"mesh devices must be 2-D, got {devices.shape}")
        if (span is None) != (span_axis is None) or span_axis not in (
                None, DATA_AXIS, ENTITY_AXIS):
            raise ValueError(f"a process span needs one of the axes "
                             f"{(DATA_AXIS, ENTITY_AXIS)}, got {span_axis!r}")
        self.devices = devices
        self.span = span
        self.span_axis = span_axis

    @property
    def local_shape(self) -> dict:
        """This process's grid."""
        return {DATA_AXIS: int(self.devices.shape[0]),
                ENTITY_AXIS: int(self.devices.shape[1])}

    @property
    def shape(self) -> dict:
        """The global grid: the spanning axis counts every process's
        shards."""
        shape = self.local_shape
        if self.span is not None:
            shape[self.span_axis] *= self.span.size
        return shape

    def span_of(self, axis: str) -> Optional[ProcessSpan]:
        """The process span of ``axis``; None when it is this process's
        alone."""
        return self.span if axis == self.span_axis else None

    def axis_devices(self, axis: str) -> list:
        """This process's devices along ``axis`` at index 0 of the other
        axis: the shards of a body that splits over ``axis`` alone (the
        replicas along the other axis would compute the same bits)."""
        if axis == DATA_AXIS:
            return list(self.devices[:, 0])
        if axis == ENTITY_AXIS:
            return list(self.devices[0, :])
        raise ValueError(f"unknown mesh axis {axis!r}")

    def distinct_devices(self) -> list:
        """Each device of the mesh once, in mesh order."""
        out = []
        for d in self.devices.reshape(-1):
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        spans = ("" if self.span is None else
                 f", {self.span_axis} over {self.span.size} processes")
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"entity={self.shape[ENTITY_AXIS]}, "
                f"devices={[str(d) for d in self.devices.reshape(-1)]}"
                f"{spans})")


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh() -> Optional[Mesh]:
    return _default_mesh


def largest_entity_divisor(num_devices: int, requested: int) -> int:
    """Largest divisor of ``num_devices`` that is <= ``requested``
    (always >= 1): the entity axis when the request does not divide the
    device count."""
    k = max(1, min(int(requested), int(num_devices)))
    while num_devices % k != 0:
        k -= 1
    return k


def visible_devices(device="cuda") -> list:
    """Every device of ``device``'s type this process sees: each CUDA card
    (``RuntimeError`` without CUDA), or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def setup_default_mesh(num_entity: int = 1, device="cuda"
                       ) -> Optional[Mesh]:
    """Driver bootstrap: a mesh over all visible devices of ``device``'s
    type made the process default; one device gives no mesh. An entity
    axis that does not divide the device count falls back to
    :func:`largest_entity_divisor` with a logged warning."""
    devs = visible_devices(device)
    first = resolve_device(device)
    if first in devs:  # the caller's device leads: shard 0 lives there
        devs.remove(first)
        devs.insert(0, first)
    n = len(devs)
    if n <= 1:
        set_default_mesh(None)
        return None
    granted = largest_entity_divisor(n, num_entity)
    if granted != num_entity:
        logging.getLogger(__name__).warning(
            "entity axis %d does not divide %d devices; falling back to "
            "%d entity shards", num_entity, n, granted)
    mesh = make_mesh(num_entity=granted, devices=devs)
    set_default_mesh(mesh)
    return mesh


def make_mesh(num_data: Optional[int] = None, num_entity: int = 1,
              devices: Optional[Sequence] = None, device="cuda",
              span: Optional[ProcessSpan] = None,
              span_axis: Optional[str] = None) -> Mesh:
    """A (data x entity) mesh over ``devices`` (default: every visible
    device of ``device``'s type); all of them on the data axis unless
    ``num_entity`` splits it. A device may appear more than once. With
    ``span`` the axis ``span_axis`` continues over the gang's processes
    (``devices`` are this process's)."""
    devs = list(devices) if devices is not None else visible_devices(device)
    devs = [torch.device(d) for d in devs]
    n = len(devs)
    if num_data is None:
        num_data = n // num_entity
    if num_data * num_entity != n:
        raise ValueError(
            f"mesh {num_data}x{num_entity} != {n} available devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(num_data, num_entity), span=span,
                span_axis=span_axis)


class Placement(NamedTuple):
    """How a tensor lies over a mesh: its leading axis split over the
    devices of ``axis``."""

    mesh: Mesh
    axis: str

    def put(self, t: torch.Tensor) -> list:
        """One equal row slice per device of the axis, each on its
        device."""
        devs = self.mesh.axis_devices(self.axis)
        k = len(devs)
        rows = int(t.shape[0])
        if rows % k != 0:
            raise ValueError(f"{rows} rows do not divide {k} shards")
        step = rows // k
        return [t[i * step:(i + 1) * step].to(d)
                for i, d in enumerate(devs)]


def data_sharding(mesh: Mesh) -> Placement:
    """Rows split over the data axis."""
    return Placement(mesh, DATA_AXIS)


def shard_batch(batch, mesh: Mesh) -> list:
    """The batch's rows split over this process's data-axis devices: one
    batch per device, each on its device (a view where the device is the
    batch's own). Rows must divide the axis: pad with zero-weight rows
    first (``data/batch.pad_batch``)."""
    n_shards = mesh.local_shape[DATA_AXIS]
    rows = int(batch.labels.shape[0])
    if rows % n_shards != 0:
        raise ValueError(
            f"batch rows {rows} not divisible by data axis {n_shards}; "
            "pad with zero-weight rows first")
    put = data_sharding(mesh).put
    meta = [dict(labels=lab, offsets=off, weights=w) for lab, off, w in
            zip(put(batch.labels), put(batch.offsets), put(batch.weights))]
    if isinstance(batch, DenseBatch):
        return [DenseBatch(X=x, **m) for x, m in zip(put(batch.X), meta)]
    if isinstance(batch, EllBatch):
        return [EllBatch(indices=i, values=v, dim=batch.dim, **m)
                for i, v, m in zip(put(batch.indices), put(batch.values),
                                   meta)]
    raise TypeError(f"unknown batch type {type(batch)}")


def pad_rows_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def ensure_addressable(x):
    """One tensor from ``x``: a tensor as it is, per-shard pieces
    concatenated on the first piece's device (no host copy)."""
    if isinstance(x, torch.Tensor):
        return x
    pieces = list(x)
    dev = pieces[0].device
    return torch.cat([p.to(dev) for p in pieces])


def host_array(x) -> np.ndarray:
    """``x`` on the host: one device-to-host copy of a tensor, or one per
    shard of per-shard pieces, concatenated there."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.concatenate([p.detach().cpu().numpy() for p in x])
