"""Data-sharded GLM fit: every shard runs the solver on its rows, and every
objective evaluation ends in a sum over the mesh's data axis.

Port of ``photon_ml_tpu/parallel/distributed.py:73-200``
(``run_glm_shard_map`` and ``_sharded_update_local_fit``); the shard
runner standing in for its ``_shard_map`` (``:46-58``) is
``parallel/collectives.py``.

- Each shard runs the SAME L-BFGS / OWL-QN / TRON loop on its row shard,
  in its own thread on its own device. The value, gradient and Hessian
  sums are reduced over the data axis in shard order, so every shard sees
  the same bits and the replicated iterates stay identical across shards
  (the invariant that replaces the reference's coefficient broadcast).
  The loop-exit reads of every shard therefore agree.
- The fused kernel runs on every shard at that shard's shape
  (``ops/aggregators.py``).
- ``shard_weight_update`` (arXiv 2004.13336) also splits the optimizer
  state and the coefficient update over the data axis: the vector is
  zero-padded to a multiple of the shard count, each shard gathers the
  full iterate for the objective, keeps its slice of the gradient, and
  the converged slices are gathered once at the end. Padded coordinates
  stay 0 (their gradient is 0, and OWL-QN's pseudo-gradient at x = 0,
  g = 0 is 0).

Over a mesh whose data axis spans a gang's processes
(``parallel/multihost.py``) each process passes its own rows: they are
padded and split over this process's shards, and the sums and the
sharded update's gathers run over every process's shards in global shard
order, so P processes x k shards give the bits of one process x P*k
shards over the same row layout.

Parity with the local solve: the sums are reassociated (a sum of
per-shard partials), so in f64 both reach the same optimum to machine
epsilon, and in f32 they agree to the f32 noise floor.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch

from photon_ml_tpu_torch.data.batch import pad_batch
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.optimize.common import OptimizationResult, solver_x0
from photon_ml_tpu_torch.optimize.problem import (
    VARIANCE_EPSILON,
    GLMOptimizationProblem,
)
from photon_ml_tpu_torch.parallel.collectives import axis_index, shard_map
from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    pad_rows_to_multiple,
    shard_batch,
)
from photon_ml_tpu_torch.parallel.quantized_collectives import (
    qall_gather,
    record_collective_bytes,
)

Tensor = torch.Tensor


def run_glm_shard_map(
        problem: GLMOptimizationProblem, batch, mesh,
        initial: Optional[Tensor] = None,
) -> tuple[GeneralizedLinearModel, OptimizationResult]:
    """Fit ``problem`` with rows split over the mesh's data axis.

    ``batch`` is a row-major batch (``DenseBatch`` or ``EllBatch``),
    padded here with zero-weight rows to a multiple of the data axis, or
    the per-shard list :func:`parallel.mesh.shard_batch` returns; on a
    mesh whose data axis spans processes, this process's rows. The
    variances, when the problem computes them, are the shards' Hessian
    diagonals summed over the axis."""
    devices = mesh.axis_devices(DATA_AXIS)
    n_shards = len(devices)
    span = mesh.span_of(DATA_AXIS)
    if isinstance(batch, list):  # DenseBatch is a tuple: test for list
        shards = batch
    else:
        rows = int(batch.labels.shape[0])
        padded = pad_rows_to_multiple(rows, n_shards)
        if padded != rows:
            batch = pad_batch(batch, padded)
        shards = shard_batch(batch, mesh)
    if len(shards) != n_shards:
        raise ValueError(f"{len(shards)} batch shards for a data axis of "
                         f"{n_shards}")
    dim = shards[0].num_features
    acc = shards[0].acc_dtype
    x0 = solver_x0(acc, dim, initial, devices[0])
    obj = dataclasses.replace(problem.objective(), axis_name=DATA_AXIS)

    shard_update = problem.shard_weight_update
    if shard_update and (problem.box is not None or problem.track_iterates):
        logging.getLogger(__name__).warning(
            "shard_weight_update is incompatible with box constraints / "
            "track_iterates; falling back to the replicated update")
        shard_update = False

    if shard_update:
        local_fit = _sharded_update_local_fit(problem, dim,
                                              mesh.shape[DATA_AXIS])
    else:
        def local_fit(shard, x0_rep, obj_rep):
            x, history, progressed = problem.solve(obj_rep, shard, x0_rep)
            return (x, history, progressed,
                    _variances(problem, obj_rep, x, shard))

    # the objective (its normalization tensors) is replicated onto every
    # shard's device with the start point
    fit = shard_map(local_fit, devices, DATA_AXIS,
                    in_specs=(DATA_AXIS, None, None),
                    out_specs=(None, None, None, None), span=span)
    x, history, progressed, variances = fit(shards, x0, obj)

    # host-side collective ledger: one d-vector gradient sum per
    # iteration, plus the sharded update's gather of one slice per
    # evaluation; line-search evaluations are not counted (a lower bound,
    # the same in both wire modes)
    iters = int(history.num_iterations[0])
    itemsize = torch.empty((), dtype=acc).element_size()
    record_collective_bytes("fe.grad_psum", problem.collective_quant, dim,
                            itemsize=itemsize, rounds=iters)
    if shard_update:
        n_global = mesh.shape[DATA_AXIS]
        d_pad = pad_rows_to_multiple(dim, n_global)
        record_collective_bytes("fe.iterate_gather",
                                problem.collective_quant,
                                d_pad // n_global, itemsize=itemsize,
                                rounds=iters)
    return problem.publish(x, history, progressed, variances=variances)


def _variances(problem: GLMOptimizationProblem, obj, x: Tensor, shard
               ) -> Optional[Tensor]:
    """var_j = 1 / (H_jj + eps) with H's diagonal summed over the axis;
    None when the problem computes no variances."""
    if not problem.compute_variances:
        return None
    return 1.0 / (obj.hessian_diagonal(x, shard) + VARIANCE_EPSILON)


def _sharded_update_local_fit(problem: GLMOptimizationProblem,
                              dim: int, n_shards: int):
    """The per-shard body of a weight-update-sharded fit: the coefficient
    vector zero-padded to a multiple of ``n_shards`` (the whole axis's)
    and split evenly; the solver runs on this shard's slice with
    ``update_axis_name`` set."""
    d_pad = pad_rows_to_multiple(dim, n_shards)
    shard_d = d_pad // n_shards
    quant = problem.collective_quant

    def gather_full(x_shard: Tensor) -> Tensor:
        # the per-evaluation gather: the sharded update's compressible
        # traffic (every shard dequantizes the same bytes)
        return qall_gather(x_shard, DATA_AXIS, mode=quant)[:dim]

    def slice_own(full_vec: Tensor) -> Tensor:
        start = axis_index(DATA_AXIS) * shard_d
        padded = torch.nn.functional.pad(full_vec, (0, d_pad - dim))
        return padded[start:start + shard_d]

    def vg(x_shard: Tensor, payload):
        obj_p, data = payload
        f, g = obj_p.calculate(gather_full(x_shard[0]), data)
        return f.unsqueeze(0), slice_own(g).unsqueeze(0)

    def hvp(x_shard: Tensor, v_shard: Tensor, payload):
        obj_p, data = payload
        hv = obj_p.hessian_vector(gather_full(x_shard[0]),
                                  gather_full(v_shard[0]), data)
        return slice_own(hv).unsqueeze(0)

    def local_fit(shard, x0_rep, obj):
        mask = problem.l1_mask
        l1_mask = (None if mask is None else slice_own(
            torch.as_tensor(mask).to(device=x0_rep.device,
                                     dtype=x0_rep.dtype)))
        x_shard, history, progressed = problem.solve(
            obj, shard, slice_own(x0_rep), update_axis_name=DATA_AXIS,
            vg_fn=vg, hvp_fn=hvp, l1_mask=l1_mask)
        # the paper's step: the full vector is gathered once per solve
        x = gather_full(x_shard)
        return x, history, progressed, _variances(problem, obj, x, shard)

    return local_fit
