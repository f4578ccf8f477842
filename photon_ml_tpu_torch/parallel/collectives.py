"""The shard runner and its collectives: ``shard_map`` with ``lax.psum``,
``lax.all_gather`` and ``lax.axis_index``, in threads.

Port of the collective half of ``photon_ml_tpu/parallel/distributed.py``
(``_shard_map``, ``:46-58``) and of the ``lax`` collectives its bodies
call. A body is written SPMD-style, as under ``shard_map``:
:func:`run_shards` runs it once per shard, each in a thread of its own
bound to the shard's device (the pattern of
``torch.nn.parallel.parallel_apply``), and inside it

- :func:`psum` sums a tensor over an axis. The shards' partials are
  reduced **in shard order** on the first shard's device, and every shard
  gets its own copy of that one result on its own device: replicas stay
  bit-identical, as ``lax.psum`` keeps them, and a run repeats bit for
  bit. No collective uses atomics.
- :func:`all_gather` stacks (or, ``tiled``, concatenates) the shards'
  pieces in shard order, delivered to every shard the same way.
- :func:`axis_index` is the shard's position on the axis.

Outside a shard runner an axis name is unbound and every collective
raises ``NameError``, as ``lax.psum`` does outside ``shard_map``; a None
axis is the identity (the unsharded callers' convention).

An axis may span processes (``span``, a :class:`ProcessSpan`: a gang of
processes joined by a ``torch.distributed`` process group). Each process
then runs its own shards of the axis in threads as above, and the
combining shard of each process gathers **every** shard's deposit from
every process through the process group (no per-process pre-sum) before
it combines them, in global shard order: process-major, then the
process's own shard order. So P processes x k shards give the bits of
one process x P*k shards over the same rows, and every replica gets the
same result. :func:`axis_index` is then the global shard index. The
exchange is staged through host memory (pinned on CUDA): the deposits are
copied to the host, gathered over gloo and copied back, because one card
can host several processes of a gang and NCCL refuses two ranks on one
device.

A collective is a rendezvous of all the axis's threads at a barrier.
When a shard raises, the barrier is aborted, so the others leave their
wait instead of hanging, and :func:`run_shards` raises the first error.
A barrier wait longer than ``SHARD_BARRIER_SECONDS`` (1800) is an
error as well: it means the shards' collective sequences diverged.

Streams: on a CUDA device each shard's thread makes its device current
(``torch.cuda.set_device``) and queues its work on a stream of its own,
which first waits for the caller's stream; the caller's stream waits for
every shard's stream when they end. A blocking read in one shard (the
solvers' loop-exit tests) then waits for that shard's work only, not for
the other shards' queued kernels, and the shards' work can overlap. A
collective orders the streams with events: the combining shard waits for
every deposit, every shard waits for the result before its copy, and
each tensor read from another shard's stream is marked used there
(``record_stream``), so the allocator does not hand its memory out while
that read is queued.

The GIL: every torch call releases and re-takes it, so shard threads
that issue many small ops hand it back and forth on every op; on one
device, where threads buy no overlap, that made the entity-sharded
per-user solve 17x slower than the same shards run in turn on an NVIDIA
H100 (PERF.md §6). A body without collectives (``collectives=False``) whose shards
all share one device therefore runs in the caller's thread, shard after
shard; a collective there raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

import torch

_CTX = threading.local()

SHARD_BARRIER_SECONDS = 1800.0

#: Traffic of this process through its process group: the collectives it
#: joined, the bytes it sent (each gather sends its own payload once) and
#: the wall seconds it spent in them (waiting for its peers included).
PROCESS_GROUP_STATS = {"collectives": 0, "bytes_sent": 0, "seconds": 0.0}


def reset_process_group_stats() -> None:
    PROCESS_GROUP_STATS.update(collectives=0, bytes_sent=0, seconds=0.0)


class ProcessSpan:
    """This process's place in a gang: ``rank`` of ``size`` processes of
    the default ``torch.distributed`` process group (gloo). Every gather
    goes through host memory; a gang member that dies makes the
    survivors' next gather raise within the group's timeout."""

    def __init__(self, rank: int, size: int):
        self.rank = int(rank)
        self.size = int(size)

    def all_gather_bytes(self, payload: torch.Tensor) -> list:
        """Every process's ``payload`` (a 1-D uint8 host tensor of the
        same length on every process) in process order."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        outs = [torch.empty_like(payload) for _ in range(self.size)]
        dist.all_gather(outs, payload)
        PROCESS_GROUP_STATS["seconds"] += time.perf_counter() - t0
        PROCESS_GROUP_STATS["collectives"] += 1
        PROCESS_GROUP_STATS["bytes_sent"] += int(payload.numel())
        return outs

    def all_gather(self, t: torch.Tensor) -> list:
        """Every process's ``t`` (same shape and dtype everywhere) in
        process order, each on ``t``'s device: staged through host memory,
        pinned when ``t`` is on CUDA."""
        flat = t.detach().contiguous().reshape(-1)
        raw = flat.view(torch.uint8) if flat.numel() else flat.new_empty(
            0, dtype=torch.uint8)
        host = torch.empty(raw.numel(), dtype=torch.uint8,
                           pin_memory=t.device.type == "cuda")
        host.copy_(raw)
        outs = self.all_gather_bytes(host)
        return [o.to(t.device).view(t.dtype).reshape(t.shape) for o in outs]


def _current_stream(dev: torch.device):
    """The calling thread's current stream on a CUDA ``dev``; None on the
    CPU."""
    return torch.cuda.current_stream(dev) if dev.type == "cuda" else None


def _await(t: torch.Tensor, event, dest: torch.device) -> None:
    """Order the calling thread's current streams on ``t``'s device and
    on ``dest`` (a copy between cards runs on the source's) after
    ``event``, and mark ``t`` used on them."""
    if event is None:
        return
    for dev in {t.device, dest}:
        stream = _current_stream(dev)
        if stream is not None:
            stream.wait_event(event)
            t.record_stream(stream)


def _record(t: torch.Tensor):
    """An event after the work queued so far on ``t``'s device's current
    stream (None for a CPU tensor)."""
    stream = _current_stream(t.device)
    return stream.record_event() if stream is not None else None


class _Group:
    """One axis's shards: their devices, a barrier and the slots of the
    collective in flight."""

    def __init__(self, devices: Sequence[torch.device],
                 span: Optional[ProcessSpan] = None):
        self.devices = list(devices)
        self.span = span
        self.barrier = threading.Barrier(len(self.devices),
                                         timeout=SHARD_BARRIER_SECONDS)
        self.slots: list = [None] * len(self.devices)
        self.events: list = [None] * len(self.devices)
        self.result = None
        self.result_event = None

    def global_index(self, index: int) -> int:
        """A local shard's position on the whole (process-spanning) axis."""
        rank = self.span.rank if self.span is not None else 0
        return rank * len(self.devices) + index

    def _global_slots(self, dev: torch.device) -> list:
        """Every shard's deposit of every process, in global shard order,
        on ``dev``."""
        if self.span is None:
            return self.slots
        local = torch.stack([s.to(dev) for s in self.slots])
        return [s for part in self.span.all_gather(local) for s in part]

    def exchange(self, index: int, value: torch.Tensor,
                 combine: Callable[[list, torch.device], torch.Tensor]
                 ) -> torch.Tensor:
        """Deposit ``value``, let shard 0 ``combine`` every slot (of every
        process, when the axis spans processes) on its device, and return
        a copy of the result on this shard's device. Shard 0 writes the
        next result only after every shard has passed the next deposit,
        so no shard reads a result that is being replaced."""
        self.slots[index] = value
        self.events[index] = _record(value)
        self.barrier.wait()
        dev0, mine = self.devices[0], self.devices[index]
        if index == 0:
            for slot, event in zip(self.slots, self.events):
                _await(slot, event, dev0)
            self.result = combine(self._global_slots(dev0), dev0)
            self.result_event = _record(self.result)
        self.barrier.wait()
        result = self.result
        _await(result, self.result_event, mine)
        return result.to(self.devices[index], copy=True)


def _bound(axis_name: str) -> tuple[_Group, int]:
    axes = getattr(_CTX, "axes", None) or {}
    if axis_name not in axes:
        raise NameError(f"unbound axis name: {axis_name!r} (collectives "
                        "run inside run_shards only)")
    return axes[axis_name]


def bound_index(axis_name: str) -> Optional[int]:
    """This shard's position on ``axis_name``; None where the axis is not
    bound (outside a shard body of that axis)."""
    axes = getattr(_CTX, "axes", None) or {}
    if axis_name not in axes:
        return None
    group, index = axes[axis_name]
    return group.global_index(index)


def axis_index(axis_name: str) -> int:
    """This shard's position on ``axis_name`` (on the whole axis, when it
    spans processes)."""
    group, index = _bound(axis_name)
    return group.global_index(index)


def _sum_in_order(slots: list, dev: torch.device) -> torch.Tensor:
    acc = slots[0].to(dev)
    for s in slots[1:]:
        acc = acc + s.to(dev)
    return acc


def psum(x, axis_name: Optional[str]):
    """Sum of ``x`` over the shards of ``axis_name``, in shard order; every
    shard gets the same bits on its own device. None: ``x`` itself."""
    if axis_name is None:
        return x
    group, index = _bound(axis_name)
    return group.exchange(index, torch.as_tensor(x), _sum_in_order)


def all_gather(x: torch.Tensor, axis_name: Optional[str],
               tiled: bool = False) -> torch.Tensor:
    """Every shard's ``x`` in shard order: stacked on a new leading axis,
    or concatenated along the first with ``tiled``. None: ``x`` itself."""
    if axis_name is None:
        return x
    group, index = _bound(axis_name)

    def gather(slots, dev):
        moved = [s.to(dev) for s in slots]
        return torch.cat(moved) if tiled else torch.stack(moved)

    return group.exchange(index, x, gather)


def tree_to(obj, device: torch.device):
    """``obj`` with every tensor it holds on ``device`` (tuples, named
    tuples, lists, dicts and dataclasses are walked; other leaves are
    kept)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_to(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_to(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: tree_to(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _shard_stream(dev: torch.device, caller):
    """A shard's device made current in its thread and its own stream,
    which first waits for ``caller`` (the caller's stream on ``dev``):
    ``(context, stream)``; on the CPU a null context and None."""
    if dev.type != "cuda":
        return contextlib.nullcontext(), None
    torch.cuda.set_device(dev)
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(caller)
    return torch.cuda.stream(stream), stream


def run_shards(body: Callable, devices: Sequence[torch.device],
               axis_name: str, args_per_shard: Sequence[tuple],
               collectives: bool = True,
               span: Optional[ProcessSpan] = None) -> list:
    """Run ``body(*args_per_shard[i])`` for every shard ``i`` of
    ``axis_name``, each in its own thread with ``devices[i]`` current (and,
    on CUDA, a stream of its own), and return the outputs in shard order;
    the caller's streams wait for the shards' work. Axes bound by an
    enclosing runner stay bound. When a shard raises, the others are
    released from their barrier and the first error is raised here.
    A body that makes no collective (``collectives=False``) on shards of
    one device runs in this thread, shard after shard. With ``span`` the
    axis spans the gang's processes: ``devices`` are this process's
    shards, and every process of the gang must run the same body."""
    n = len(devices)
    if len(args_per_shard) != n:
        raise ValueError(f"{len(args_per_shard)} argument sets for "
                         f"{n} shards")
    if not collectives and len(set(devices)) == 1:
        return _run_in_turn(body, devices, axis_name, args_per_shard, span)
    group = _Group(devices, span)
    outs: list = [None] * n
    errors: list = [None] * n
    done: list = [None] * n  # each shard stream's last event
    parent = dict(getattr(_CTX, "axes", None) or {})
    grad = torch.is_grad_enabled()
    callers = {d: torch.cuda.current_stream(d) for d in set(devices)
               if d.type == "cuda"}

    def work(i: int) -> None:
        _CTX.axes = {**parent, axis_name: (group, i)}
        try:
            scope, stream = _shard_stream(devices[i], callers.get(devices[i]))
            with scope, torch.set_grad_enabled(grad):
                outs[i] = body(*args_per_shard[i])
            if stream is not None:
                done[i] = stream.record_event()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e
            group.barrier.abort()
        finally:
            _CTX.axes = parent

    threads = [threading.Thread(target=work, args=(i,),
                                name=f"shard-{axis_name}-{i}", daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for dev, event in zip(devices, done):
        if event is not None:
            callers[dev].wait_event(event)
    if any(e is not None for e in errors):
        first = next((e for e in errors if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)),
                     None)
        raise first or next(e for e in errors if e is not None)
    return outs


class _InTurn(_Group):
    """The group of shards run in turn: it has no rendezvous."""

    def __init__(self, devices: Sequence[torch.device],
                 span: Optional[ProcessSpan] = None):
        self.devices = list(devices)
        self.span = span

    def exchange(self, index, value, combine):
        raise RuntimeError("a collective in a body run with "
                           "collectives=False")


def _run_in_turn(body: Callable, devices: Sequence[torch.device],
                 axis_name: str, args_per_shard: Sequence[tuple],
                 span: Optional[ProcessSpan] = None) -> list:
    group = _InTurn(devices, span)
    parent = dict(getattr(_CTX, "axes", None) or {})
    scope = (torch.cuda.device(devices[0]) if devices[0].type == "cuda"
             else contextlib.nullcontext())
    outs = []
    with scope:
        for i, args in enumerate(args_per_shard):
            _CTX.axes = {**parent, axis_name: (group, i)}
            try:
                outs.append(body(*args))
            finally:
                _CTX.axes = parent
    return outs


def shard_map(body: Callable, devices: Sequence[torch.device],
              axis_name: str, in_specs: Sequence[Optional[str]],
              out_specs: Sequence[Optional[str]],
              span: Optional[ProcessSpan] = None) -> Callable:
    """``shard_map`` over one axis: the returned function takes, for an
    input whose spec is ``axis_name``, a sequence of per-shard pieces (one
    per device) and, for a None spec, one value copied to every shard's
    device. Outputs whose spec is ``axis_name`` come back as per-shard
    lists; a None spec (replicated) returns shard 0's. ``span``: the
    axis spans the gang's processes (:func:`run_shards`)."""

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} "
                             "specs")
        per_shard = []
        for i, dev in enumerate(devices):
            shard_args = []
            for a, spec in zip(args, in_specs):
                if spec is None:
                    shard_args.append(tree_to(a, dev))
                else:
                    shard_args.append(a[i])
            per_shard.append(tuple(shard_args))
        outs = run_shards(body, devices, axis_name, per_shard, span=span)
        result = []
        for j, spec in enumerate(out_specs):
            if spec is None:
                result.append(outs[0][j])
            else:
                result.append([o[j] for o in outs])
        return tuple(result)

    return run
