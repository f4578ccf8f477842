"""Device-resident batches of labeled GLM data: dense and ELL.

Port of ``photon_ml_tpu/data/batch.py`` — ``DenseBatch`` (``:37-79``),
``EllBatch`` (``:82-146``), ``dense_batch`` (``:149``),
``canonicalized_csr`` (``:173``), ``ell_from_csr`` (``:184-235``),
``ell_from_rows`` (``:238-273``) and ``pad_batch`` (``:276-298``). The JAX
package vmaps its solvers over entities, so each lane sees a 2-D batch;
the port writes the entity axis out instead, and ``DenseBatch``'s methods
take the 3-D ``[E, N, D]`` form too (``labels``/``offsets``/``weights``
``[E, N]``, coefficients ``[E, D]``).

A 2-D dense batch goes through ``einsum`` (a matrix-vector product). A 3-D
batch, and a 2-D one whose ``X`` is bf16, is an elementwise product and
a ``sum`` over the row's features (margins) or over the rows (the
gradient's sum); a bf16 ``X`` is promoted to f32 inside the product, so
the products and the sums are f32 and no f32 copy of ``X`` is made ahead
of them. A batched GEMM
would let cuBLAS pick its algorithm by the lane count, and on the H100 a
lane's margins then differ in the last bits between a dispatch of all
lanes and a compacted dispatch of a few, while the reduction's order per
output does not depend on the number of outputs. That keeps lane
compaction bit-exact (``game/random_effect.py``).

``EllBatch`` holds a wide sparse shard as ``indices``/``values [N, K]``
(``K`` the longest row, padded; pad slots have value 0). Its margins are a
gather and a row sum. Its column sums (Xᵀr and the Hessian diagonal's
Σ rᵢxᵢ²), which the JAX package computes with ``jax.ops.segment_sum``, go
through a :class:`ColumnSumPlan`, built on the batch's first column sum:
the non-zero entries sorted by column (a stable sort), cut into chunks of
up to ``COLUMN_SUM_WIDTH`` within each non-empty column, and summed chunk
by chunk, level after level, with gathers and dense ``sum(-1)``
reductions of fixed shape. No atomic add is involved, so two evaluations
on the card are equal bit for bit and the bit-exact contracts (resume,
pipelined and block sweeps) hold on an ELL shard; ``index_add_``/
``scatter_add_`` would add in no fixed order on CUDA. The plan costs at
most four slots per non-zero (a value and an int32 row each) and an
index per column: 81.5 M slots and about 650 MB at 10M rows x 8
non-zeros over 100,000 columns, f32.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.obs import compile as obs_compile

Tensor = torch.Tensor


def acc_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype over data of ``dtype``: at least f32, never a
    downcast of f64 (``batch.py:49-55``)."""
    return torch.promote_types(dtype, torch.float32)


class DenseBatch(NamedTuple):
    """Columnar dense design matrix plus per-row metadata."""

    X: Tensor  # [N, D] or [E, N, D]
    labels: Tensor  # [N] or [E, N]
    offsets: Tensor
    weights: Tensor  # 0 for padded rows => they drop out of every sum

    @property
    def num_features(self) -> int:
        return self.X.shape[-1]

    @property
    def acc_dtype(self) -> torch.dtype:
        return acc_dtype_for(self.X.dtype)

    @property
    def device(self) -> torch.device:
        return self.X.device

    def _elementwise(self) -> bool:
        """The ops are an elementwise product and a ``sum`` for a 3-D
        batch and for an ``X`` narrower than its accumulator (a bf16 ``X``
        promotes to f32 inside the product, so no f32 copy of ``X`` is
        made ahead of it); a 2-D ``X`` already in its accumulator dtype
        goes through ``einsum``."""
        return self.X.dim() == 3 or self.X.dtype != self.acc_dtype

    def margins(self, w_eff: Tensor, margin_shift: Tensor) -> Tensor:
        """x_i . w_eff + margin_shift + offset_i."""
        w = w_eff.to(self.acc_dtype)
        if self._elementwise():
            z = (self.X * w.unsqueeze(-2)).sum(-1)
        else:
            z = torch.einsum("nd,d->n", self.X, w)
        return z + margin_shift.unsqueeze(-1) + self.offsets

    def weighted_feature_sum(self, row_scalars: Tensor) -> Tensor:
        """sum_i row_scalars_i * x_i — the gradient's vector sum (X^T r)."""
        r = row_scalars.to(self.acc_dtype)
        if self._elementwise():
            return (self.X * r.unsqueeze(-1)).sum(-2)
        return torch.einsum("nd,n->d", self.X, r)

    def hadamard_square_sum(self, row_scalars: Tensor) -> Tensor:
        """sum_i row_scalars_i * x_i**2 — Hessian-diagonal inner sum."""
        r = row_scalars.to(self.acc_dtype)
        if self._elementwise():
            # r first, so that a bf16 X promotes before it is squared
            return (self.X * r.unsqueeze(-1) * self.X).sum(-2)
        return torch.einsum("nd,n->d", self.X * self.X, r)


def dense_batch(X: np.ndarray, labels: np.ndarray,
                offsets: Optional[np.ndarray] = None,
                weights: Optional[np.ndarray] = None,
                dtype: torch.dtype = torch.float32,
                device=DEFAULT_DEVICE) -> DenseBatch:
    """Batch from host arrays on ``device`` (the card unless the caller
    asks for the CPU; raises without CUDA); metadata is at least f32
    (``batch.py:149``)."""
    device = resolve_device(device)
    n = X.shape[0]
    meta = acc_dtype_for(dtype)
    return DenseBatch(
        X=torch.as_tensor(np.asarray(X), device=device).to(dtype),
        labels=torch.as_tensor(np.asarray(labels), device=device).to(meta),
        offsets=(torch.zeros(n, dtype=meta, device=device) if offsets is None
                 else torch.as_tensor(np.asarray(offsets),
                                      device=device).to(meta)),
        weights=(torch.ones(n, dtype=meta, device=device) if weights is None
                 else torch.as_tensor(np.asarray(weights),
                                      device=device).to(meta)),
    )


# ---------------------------------------------------------------------------
# ELL layout
# ---------------------------------------------------------------------------

#: most entries summed by one ``sum(-1)`` at each level of a column sum
COLUMN_SUM_WIDTH = 32
#: fewest: a narrower chunk would add levels for little memory
COLUMN_SUM_MIN_WIDTH = 4


def _index_dtype(n: int) -> torch.dtype:
    return torch.int32 if n < 2 ** 31 - 1 else torch.int64


def _plan_width(nnz: int, columns: int) -> int:
    """Chunk width of a column sum: the mean entries of a non-empty column
    rounded up to a power of two, within ``[COLUMN_SUM_MIN_WIDTH,
    COLUMN_SUM_WIDTH]``. Each non-empty column pads at most ``width - 1``
    slots, so level 0 holds at most ``4 * nnz`` slots."""
    mean = -(-nnz // max(columns, 1))
    return min(max(1 << max(mean - 1, 0).bit_length(),
                   COLUMN_SUM_MIN_WIDTH), COLUMN_SUM_WIDTH)


def _chunk_index(lens: Tensor, starts: Tensor, width: int, pad: int
                 ) -> tuple[Tensor, Tensor]:
    """``[C, width]`` positions into a vector whose segment ``s`` holds
    ``lens[s] >= 1`` items from ``starts[s]`` on: each segment is cut into
    ``ceil(len / width)`` chunks, slots past its end point at ``pad``.
    Returns the positions and the chunks of each segment."""
    dev = lens.device
    chunks = (lens + width - 1) // width
    chunk_starts = torch.cumsum(chunks, 0) - chunks
    seg = torch.repeat_interleave(
        torch.arange(len(lens), device=dev), chunks)
    within = torch.arange(len(seg), device=dev) - chunk_starts[seg]
    off = within[:, None] * width + torch.arange(width, device=dev)[None, :]
    pos = torch.where(off < lens[seg][:, None], starts[seg][:, None] + off,
                      torch.full_like(off, pad))
    return pos, chunks


class ColumnSumPlan:
    """Fixed-order column sums Σᵢ sᵢ·x_ij over an ELL batch's non-zeros,
    built on the first :meth:`column_sum` (a batch that never takes one,
    as a validation or scoring batch, never pays for it).

    ``values``/``rows [C, width]``: the non-zero entries in column order,
    cut into chunks of ``width`` (:func:`_plan_width`) per non-empty
    column; pad slots hold value 0 and row ``N``, a zero appended to the
    row scalars. Level 0 sums each chunk. Every later level (``levels``,
    positions into the previous level's partials plus one appended zero)
    sums the chunks of the columns that still have more than one partial.
    ``out [dim]`` picks each column's last partial from all levels'
    partials, an empty column the appended zero. Every step is a gather
    and a ``sum(-1)`` over a dense shape fixed when the plan is built, so
    the result does not depend on timing. The plan holds at most
    ``4 * nnz`` level-0 slots (a value and an int32 row each), fewer at
    the later levels, and ``out``."""

    def __init__(self, indices: Tensor, values: Tensor, dim: int):
        self._source: Optional[tuple[Tensor, Tensor]] = (indices, values)
        self.dim = dim

    def build(self) -> "ColumnSumPlan":
        """Sort the non-zeros by column (a stable sort, on the batch's
        device) and lay out every level; idempotent."""
        if self._source is None:
            return self
        t0 = time.perf_counter_ns()
        indices, values = self._source
        n, k = indices.shape
        dev = indices.device
        flat_vals = values.reshape(-1)
        pos = torch.nonzero(flat_vals != 0).reshape(-1)
        cols = indices.reshape(-1).long()[pos]
        order = torch.sort(cols, stable=True).indices
        pos, cols = pos[order], cols[order]
        lens = torch.bincount(cols, minlength=self.dim)
        present = torch.nonzero(lens).reshape(-1)
        lens = lens[present]
        self.width = width = _plan_width(len(pos), len(present))
        idx, chunks = _chunk_index(lens, torch.cumsum(lens, 0) - lens,
                                   width, len(pos))
        self.values = torch.cat([flat_vals[pos], flat_vals.new_zeros(1)])[idx]
        rows = torch.cat([pos // max(k, 1), torch.tensor([n], device=dev)])
        self.rows = rows[idx].to(_index_dtype(n + 1))
        # final[c]: position of column present[c]'s last partial among all
        # levels' partials; live: the columns with more than one partial
        final = torch.zeros(len(present), dtype=torch.long, device=dev)
        live = torch.arange(len(present), device=dev)
        offset = 0
        self.levels: list[Tensor] = []
        while True:
            total = int(chunks.sum())
            starts = torch.cumsum(chunks, 0) - chunks
            done = chunks == 1
            final[live[done]] = offset + starts[done]
            if bool(done.all()):
                break
            live, starts, chunks = live[~done], starts[~done], chunks[~done]
            idx, chunks = _chunk_index(chunks, starts, width, total)
            self.levels.append(idx.to(_index_dtype(total + 1)))
            offset += total
        offset += total
        out = torch.full((self.dim,), offset, dtype=torch.long, device=dev)
        out[present] = final
        self.out = out.to(_index_dtype(offset + 1))
        self._source = None
        obs_compile.record_build("data.column_sum_plan",
                                 obs_compile.NO_CACHE_ENTRY, t0,
                                 nnz=int(len(pos)), columns=self.dim)
        return self

    def column_sum(self, row_scalars: Tensor, square: bool = False
                   ) -> Tensor:
        """Σᵢ sᵢ·x_ij (``square``: Σᵢ sᵢ·x_ij²) per column ``j``, in the
        dtype of ``row_scalars``."""
        self.build()
        zero = row_scalars.new_zeros(1)
        r = torch.cat([row_scalars, zero])
        g = r.index_select(0, self.rows.reshape(-1)).reshape(
            self.rows.shape)
        v = self.values.to(row_scalars.dtype)
        # photonlint: allow-W801(row_scalars come in the batch's accumulator dtype, at least f32: EllBatch passes row_scalars.to(self.acc_dtype))
        parts = [((v * v) * g if square else v * g).sum(-1)]
        for idx in self.levels:
            ext = torch.cat([parts[-1], zero])
            # photonlint: allow-W801(the partials are in row_scalars' dtype, the batch's accumulator dtype)
            parts.append(ext.index_select(0, idx.reshape(-1)).reshape(
                idx.shape).sum(-1))
        return torch.cat([*parts, zero]).index_select(0, self.out)


class EllBatch:
    """Padded row-sparse (ELL) design matrix plus per-row metadata
    (``batch.py:82-146``): ``indices``/``values [N, K]`` (pad slots: value
    0, index 0), ``labels``/``offsets``/``weights [N]`` and the column
    count ``dim``. Two-dimensional only: the random-effect blocks are
    dense."""

    def __init__(self, indices: Tensor, values: Tensor, labels: Tensor,
                 offsets: Tensor, weights: Tensor, dim: int,
                 plan: Optional[ColumnSumPlan] = None):
        self.indices = indices  # [N, K] int32
        self.values = values  # [N, K]
        self.labels = labels  # [N]
        self.offsets = offsets  # [N]
        self.weights = weights  # [N]
        self.dim = int(dim)
        # built on the first column sum and shared by ``_replace`` copies
        self.plan = (plan if plan is not None
                     else ColumnSumPlan(indices, values, self.dim))

    def _replace(self, **kw) -> "EllBatch":
        """A copy with the given fields replaced; the column-sum plan is
        kept unless ``indices`` or ``values`` change."""
        fields = dict(indices=self.indices, values=self.values,
                      labels=self.labels, offsets=self.offsets,
                      weights=self.weights, dim=self.dim)
        keep_plan = not ({"indices", "values", "dim"} & set(kw))
        fields.update(kw)
        return EllBatch(**fields, plan=self.plan if keep_plan else None)

    @property
    def num_features(self) -> int:
        return self.dim

    @property
    def acc_dtype(self) -> torch.dtype:
        return acc_dtype_for(self.values.dtype)

    @property
    def device(self) -> torch.device:
        return self.values.device

    def margins(self, w_eff: Tensor, margin_shift: Tensor) -> Tensor:
        """Σ_k w_eff[indices_ik]·values_ik + margin_shift + offset_i."""
        acc = self.acc_dtype
        gathered = w_eff.to(acc).index_select(
            0, self.indices.reshape(-1)).reshape(self.indices.shape)
        return ((gathered * self.values.to(acc)).sum(-1) + margin_shift
                + self.offsets)

    def weighted_feature_sum(self, row_scalars: Tensor) -> Tensor:
        """Σᵢ row_scalarsᵢ·xᵢ (Xᵀr), in a fixed order."""
        return self.plan.column_sum(row_scalars.to(self.acc_dtype))

    def hadamard_square_sum(self, row_scalars: Tensor) -> Tensor:
        """Σᵢ row_scalarsᵢ·xᵢ², in a fixed order."""
        return self.plan.column_sum(row_scalars.to(self.acc_dtype),
                                    square=True)


Batch = Union[DenseBatch, EllBatch]


def canonicalized_csr(mat):
    """CSR with duplicate (row, col) entries summed (``batch.py:173-181``):
    no copy when already canonical."""
    if not mat.has_canonical_format:
        mat = mat.copy()
        mat.sum_duplicates()
    return mat


def _ell_k(lens: np.ndarray, pad_to_multiple: int) -> int:
    k = int(lens.max()) if len(lens) else 1
    return max(1, -(-max(k, 1) // pad_to_multiple) * pad_to_multiple)


def ell_planes_numpy(mat, k: int, stage=np.float32
                     ) -> tuple[np.ndarray, np.ndarray]:
    """``(indices, values) [n, k]`` of a CSR matrix by two numpy scatters
    (the JAX package's pack, ``batch.py:216-220``): the plain version of
    the native packer, and the f64 staging path."""
    n = mat.shape[0]
    indptr = np.asarray(mat.indptr)
    lens = np.diff(indptr)
    indices = np.zeros((n, k), dtype=np.int32)
    values = np.zeros((n, k), dtype=stage)
    if mat.nnz:
        row_of = np.repeat(np.arange(n), lens)
        slot_of = np.arange(mat.nnz) - np.repeat(indptr[:-1], lens)
        indices[row_of, slot_of] = mat.indices
        values[row_of, slot_of] = mat.data
    return indices, values


def _ell_batch(indices: np.ndarray, values: np.ndarray, dim: int, labels,
               offsets, weights, dtype: torch.dtype, device) -> EllBatch:
    n = indices.shape[0]
    meta = acc_dtype_for(dtype)

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dt)

    return EllBatch(
        indices=put(indices, torch.int32),
        values=put(values, dtype),
        labels=put(np.asarray(labels), meta),
        offsets=(torch.zeros(n, dtype=meta, device=device) if offsets is None
                 else put(np.asarray(offsets), meta)),
        weights=(torch.ones(n, dtype=meta, device=device) if weights is None
                 else put(np.asarray(weights), meta)),
        dim=dim)


def ell_from_csr(mat, labels: np.ndarray,
                 offsets: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None,
                 pad_to_multiple: int = 8, dtype: torch.dtype = torch.float32,
                 device=DEFAULT_DEVICE) -> EllBatch:
    """ELL batch on ``device`` from a scipy CSR matrix (``batch.py:184-235``).
    f32 staging packs through the host library's ``photon_pack_ell``
    (``csrc/host/block_packer.cpp``); f64 staging through the numpy
    scatter, as in the JAX package. The caller passes a canonical CSR
    (duplicates summed)."""
    from photon_ml_tpu_torch.io.native_loader import pack_ell_native

    device = resolve_device(device)
    n, dim = mat.shape
    k = _ell_k(np.diff(np.asarray(mat.indptr)), pad_to_multiple)
    stage = np.float64 if acc_dtype_for(dtype) == torch.float64 \
        else np.float32
    if stage == np.float32 and mat.nnz:
        indices = np.zeros((n, k), dtype=np.int32)
        values = np.zeros((n, k), dtype=np.float32)
        pack_ell_native(mat.indptr, mat.indices, mat.data, k, indices,
                        values)
    else:
        indices, values = ell_planes_numpy(mat, k, stage)
    return _ell_batch(indices, values, dim, labels, offsets, weights, dtype,
                      device)


def ell_from_rows(rows: list, dim: int, labels: np.ndarray,
                  offsets: Optional[np.ndarray] = None,
                  weights: Optional[np.ndarray] = None,
                  pad_to_multiple: int = 8, dtype: torch.dtype = torch.float32,
                  device=DEFAULT_DEVICE) -> EllBatch:
    """ELL batch from per-row ``(indices, values)`` pairs
    (``batch.py:238-273``)."""
    device = resolve_device(device)
    n = len(rows)
    k = _ell_k(np.asarray([len(ix) for ix, _ in rows], np.int64),
               pad_to_multiple)
    stage = np.float64 if acc_dtype_for(dtype) == torch.float64 \
        else np.float32
    indices = np.zeros((n, k), dtype=np.int32)
    values = np.zeros((n, k), dtype=stage)
    for i, (ix, v) in enumerate(rows):
        indices[i, : len(ix)] = ix
        values[i, : len(v)] = v
    return _ell_batch(indices, values, dim, labels, offsets, weights, dtype,
                      device)


def pad_batch(batch: Batch, target_rows: int) -> Batch:
    """Zero-pad a 2-D batch to ``target_rows`` rows (weights 0: inert in
    every sum; ``batch.py:276-298``)."""
    n = int(batch.labels.shape[0])
    if n == target_rows:
        return batch
    if n > target_rows:
        raise ValueError(f"batch has {n} rows > target {target_rows}")
    pad = target_rows - n

    def rows(t):
        return torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])

    meta = dict(labels=rows(batch.labels), offsets=rows(batch.offsets),
                weights=rows(batch.weights))
    if isinstance(batch, DenseBatch):
        return DenseBatch(X=rows(batch.X), **meta)
    # padded rows point at column 0 with value 0
    return EllBatch(indices=rows(batch.indices), values=rows(batch.values),
                    dim=batch.dim, **meta)
