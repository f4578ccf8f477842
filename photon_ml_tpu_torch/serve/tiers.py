"""Tiered per-entity coefficient store for the scoring service.

Port of ``photon_ml_tpu/serve/tiers.py``. The entity coefficient blocks
are by far the largest serving state and request traffic over entities
is skewed, so only the hot head earns device residency. Three tiers,
checked in order per request row:

- **device** — a fixed ``[H, D]`` block on the card, f32 by default or
  bf16 with ``device_dtype="bf16"``. ``H`` comes from the budget
  (``budget // row_bytes``), so eviction pressure IS the budget, and the
  bf16 tier's halved ``row_bytes`` holds about twice the entities under
  the same budget. Hits are gathered on the device over a slot list
  padded to a power-of-two bucket (``bucket_rows(u, min_bucket=1)``, the
  JAX package's shapes); the bf16 gather converts the gathered rows to
  f32 on the device. The rows stay there: the scorer's row dot runs on
  the device over them.
- **host** — an LRU of entities recently evicted from the device block
  (indices into the model block, so the tier costs O(1) per entry).
- **model** — the full coefficient block of the model on the host;
  always correct, never evicted. Unknown entities miss every tier and
  score zero from this coordinate.

A promotion writes its rows into distinct free or evicted slots with
``index_copy_``: a scatter with no accumulation (the JAX package pads the
slot list by repeating its first pair, which a scatter that sets values
absorbs; the port writes the real rows only). The counters are the JAX
package's (``serve_tier_hits{coordinate,tier}``, ``serve_tier_promote``,
``serve_tier_evict``), and the same request sequence gives the same
counts in both.

Bit-parity invariant: with the f32 device tier every tier holds the
SAME f32 rows the model block holds (a copy to the card is exact), so
the row dot downstream sees identical inputs whichever tier served a
row. ``device_dtype="bf16"`` trades that for capacity:
device-tier hits return bf16-rounded rows (relative rounding error at
most 2^-8 per element) while host and model tier hits stay exact.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.models import RandomEffectModel, _host, _match
from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.serve.batcher import bucket_rows

#: Device-tier storage dtypes: row_bytes drives both the capacity
#: calculation and the ``serve_tier_device_bytes`` accounting.
TIER_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

#: ``serve_tier_device_bytes`` is the SUM of live device blocks per
#: (registry, coordinate): during a hot-swap two generations' stores
#: share a coordinate label. Each store adds its share on warm and
#: subtracts it on release. Only the device loop warms and releases
#: stores, so the running sums need no lock.
_DEVICE_BYTES_LIVE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _account_device_bytes(registry, coordinate: str, delta: int) -> None:
    per_coord = _DEVICE_BYTES_LIVE.setdefault(registry, {})
    total = per_coord.get(coordinate, 0) + delta
    per_coord[coordinate] = total
    registry.gauge("serve_tier_device_bytes").set(
        total, coordinate=coordinate)


class TieredCoefficientStore:
    """Per-coordinate tiered store over one :class:`RandomEffectModel`
    with raw ``entity_ids`` (every model loaded from disk has them), its
    device block on ``device``. Single-consumer: only the device loop
    calls :meth:`lookup`."""

    def __init__(self, coordinate_id: str, model: RandomEffectModel,
                 hbm_budget_bytes: int, host_capacity: int = 65536,
                 device_dtype: str = "f32",
                 registry: MetricsRegistry = REGISTRY, device="cuda"):
        if model.entity_ids is None:
            raise ValueError(
                f"coordinate {coordinate_id!r}: tiered store needs raw "
                f"entity_ids (models loaded from disk carry them)")
        if device_dtype not in TIER_DTYPES:
            raise ValueError(
                f"coordinate {coordinate_id!r}: unknown device_dtype "
                f"{device_dtype!r}; expected one of "
                f"{tuple(TIER_DTYPES)}")
        self.device = resolve_device(device)
        self.coordinate_id = coordinate_id
        self._registry = registry
        self._block_np = np.ascontiguousarray(_host(model.coefficients),
                                              dtype=np.float32)
        e, d = self._block_np.shape
        self.dim = d
        self.device_dtype = device_dtype
        self._dev_dtype = TIER_DTYPES[device_dtype]
        self.row_bytes = d * self._dev_dtype.itemsize
        # raw ids compared as python strings, as the untiered scoring
        # resolves them (game/models.py _codes_via_ids)
        self._ids = np.asarray(
            [str(x) for x in np.asarray(model.entity_ids).ravel()],
            dtype=object)
        # model row of each raw id (the first, as _match resolves a
        # duplicate), for demotions
        self._row_of: dict[str, int] = {}
        for i, x in enumerate(self._ids):
            self._row_of.setdefault(x, i)
        self.capacity = int(max(1, min(
            max(e, 1), hbm_budget_bytes // max(self.row_bytes, 1))))
        self.host_capacity = int(max(0, host_capacity))
        self._device_block: Optional[torch.Tensor] = self._new_block()
        self._slot_of: "OrderedDict[str, int]" = OrderedDict()  # LRU
        self._free = list(range(self.capacity))
        self._host: "OrderedDict[str, int]" = OrderedDict()  # id → row
        self.released = False
        _account_device_bytes(registry, coordinate_id,
                              self.capacity * self.row_bytes)

    def _new_block(self) -> torch.Tensor:
        return torch.zeros((self.capacity, self.dim), dtype=self._dev_dtype,
                           device=self.device)

    # -- generation retirement ------------------------------------------

    def release(self) -> None:
        """Drop the device block and both LRU tiers (generation
        retirement: called only after the last batch pinned to this
        store's generation has drained). The store stays scoreable: the
        next :meth:`lookup` re-warms from the model block like a cold
        start. This store's share leaves the ``serve_tier_device_bytes``
        gauge."""
        if not self.released:
            _account_device_bytes(self._registry, self.coordinate_id,
                                  -(self.capacity * self.row_bytes))
        self._device_block = None
        self._slot_of.clear()
        self._host.clear()
        self._free = list(range(self.capacity))
        self.released = True

    # -- internals ------------------------------------------------------

    def _demote_to_host(self, ent: str, model_row: int) -> None:
        self._registry.counter("serve_tier_evict").inc(
            coordinate=self.coordinate_id, tier="device")
        if not self.host_capacity:
            return
        self._host[ent] = model_row
        self._host.move_to_end(ent)
        while len(self._host) > self.host_capacity:
            self._host.popitem(last=False)
            self._registry.counter("serve_tier_evict").inc(
                coordinate=self.coordinate_id, tier="host")

    def _take_slot(self, pinned: set) -> int:
        """A free device slot, evicting the LRU non-pinned resident if
        the block is full; -1 when every resident is pinned."""
        if self._free:
            return self._free.pop()
        for ent in self._slot_of:  # OrderedDict iterates LRU-first
            if ent not in pinned:
                slot = self._slot_of.pop(ent)
                self._demote_to_host(ent, self._row_of[ent])
                return slot
        return -1

    def _write_device(self, slots: list, model_rows: list) -> None:
        """Promoted model rows into their (distinct) device slots."""
        if self._device_block is None:  # re-warm after release()
            self._device_block = self._new_block()
            self.released = False
            _account_device_bytes(self._registry, self.coordinate_id,
                                  self.capacity * self.row_bytes)
        rows = torch.from_numpy(self._block_np[np.asarray(model_rows)])
        self._device_block.index_copy_(
            0, torch.as_tensor(slots, dtype=torch.int64, device=self.device),
            rows.to(device=self.device, dtype=self._dev_dtype))

    def _gather(self, slots: np.ndarray) -> torch.Tensor:
        """The device rows at ``slots`` (a padded bucket), f32 on the
        device; the bf16 tier converts them here."""
        idx = torch.from_numpy(slots).to(self.device)
        return self._device_block[idx].to(torch.float32)

    # -- the lookup -----------------------------------------------------

    def lookup(self, raw_ids: np.ndarray, stages: Optional[dict] = None
               ) -> tuple[torch.Tensor, np.ndarray]:
        """The f32 coefficient rows of a batch, on the device, served
        device-first with promotion on host/model hits. ``raw_ids`` is an
        object array of python strings.

        Returns ``(table, rows)``: request row ``i``'s coefficients are
        ``table[rows[i]]``. ``table`` holds the gathered device-tier rows
        (a padded bucket), then the rows served straight from the model
        block when the batch's own entities overflow the device tier,
        then one zero row, which unknown entities get (a cold entity
        scores 0).

        ``stages`` is the request-tracing stage accumulator
        (``serve/reqtrace.py``): the store adds its own wall time (tier
        resolution, promotion writes, the device gather) to
        ``stages["tier_gather"]`` in ``perf_counter_ns``."""
        t0 = time.perf_counter_ns()
        b = len(raw_ids)
        zero_row = torch.zeros((1, self.dim), dtype=torch.float32,
                               device=self.device)
        if b == 0 or len(self._ids) == 0:
            self._add_stage(stages, t0)
            return zero_row, np.zeros(b, np.int64)
        unique_ids, inverse = np.unique(
            np.asarray([str(x) for x in raw_ids], dtype=object),
            return_inverse=True)
        unique_ids = [str(e) for e in unique_ids]
        model_rows = _match(self._ids, np.asarray(unique_ids, dtype=object))
        pinned = set(unique_ids)
        tier_of: list = []
        from_model: dict[str, int] = {}
        promote_slots: list = []
        promote_rows: list = []
        for ent, mrow in zip(unique_ids, model_rows):
            mrow = int(mrow)
            if ent in self._slot_of:
                tier_of.append("device")
                self._slot_of.move_to_end(ent)
                continue
            if mrow >= len(self._ids):
                tier_of.append("miss")
                continue
            tier = "host" if ent in self._host else "model"
            tier_of.append(tier)
            slot = self._take_slot(pinned)
            if slot < 0:
                # device tier saturated by this batch's own entities:
                # serve the overflow straight from the model block
                from_model[ent] = mrow
                continue
            self._host.pop(ent, None)
            self._slot_of[ent] = slot
            self._slot_of.move_to_end(ent)
            promote_slots.append(slot)
            promote_rows.append(mrow)
            self._registry.counter("serve_tier_promote").inc(
                coordinate=self.coordinate_id, tier=tier)
        if promote_slots:
            self._write_device(promote_slots, promote_rows)

        # one device gather over a padded bucket for every resident id
        parts, table_row = [], {}
        resident = [e for e in unique_ids if e in self._slot_of]
        if resident:
            u = len(resident)
            bucket = bucket_rows(u, min_bucket=1)
            slots = np.asarray(
                [self._slot_of[e] for e in resident], np.int64)
            if bucket > u:
                slots = np.concatenate(
                    [slots, np.repeat(slots[:1], bucket - u)])
            parts.append(self._gather(slots))
            table_row.update(zip(resident, range(u)))
        if from_model:
            base = sum(len(p) for p in parts)
            table_row.update(zip(from_model, range(base,
                                                   base + len(from_model))))
            parts.append(torch.from_numpy(
                self._block_np[list(from_model.values())]).to(self.device))
        zero = sum(len(p) for p in parts)
        table = torch.cat([*parts, zero_row]) if parts else zero_row
        rows = np.asarray([table_row.get(e, zero) for e in unique_ids],
                          np.int64)[inverse]

        hits = self._registry.counter("serve_tier_hits")
        tiers, counts = np.unique(np.asarray(tier_of, dtype=object)[inverse],
                                  return_counts=True)
        for tier, count in zip(tiers, counts):
            hits.inc(int(count), coordinate=self.coordinate_id,
                     tier=str(tier))
        self._add_stage(stages, t0)
        return table, rows

    @staticmethod
    def _add_stage(stages: Optional[dict], t0: int) -> None:
        if stages is not None:
            stages["tier_gather"] = stages.get("tier_gather", 0) \
                + (time.perf_counter_ns() - t0)

    # -- introspection ---------------------------------------------------

    def stats(self) -> dict:
        return {
            "coordinate": self.coordinate_id,
            "device_entities": len(self._slot_of),
            "device_capacity": self.capacity,
            "device_dtype": self.device_dtype,
            "host_entities": len(self._host),
            "host_capacity": self.host_capacity,
            "device_bytes": (0 if self.released
                             else self.capacity * self.row_bytes),
            "released": self.released,
        }
