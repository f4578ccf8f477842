"""Random-effect solver: one lane-batched solve over entity blocks.

Port of ``photon_ml_tpu/game/random_effect.py`` — the ``CONV_*`` codes
(``:67-78``), ``SOLVE_STATS`` (``:99-109``), ``AUTO_COMPACTION_CHUNK`` and
``ChunkAutoTuner`` (``:115-190``), ``_fit_blocks_impl`` (``:193-296``, the
JAX package ``vmap``s a single-lane solver over entities; here the
``[E, N, D]`` block is one lane-batched L-BFGS, OWL-QN or TRON solve with
the per-lane convergence classification of ``:258-287``, the same for
every solver), ``_fit_blocks_compacted`` (``:361-453``),
``RandomEffectOptimizationProblem`` with ``_fit``/``run``/
``_run_bucketed`` (``:739-975``) and the score exchange ``score_active``/
``score_passive``/``score_random_effect`` (``:978-1058``).

Lane compaction (``lane_compaction_chunk`` > 0, or
``AUTO_COMPACTION_CHUNK`` for the tuner's choice): the solve runs in
chunks of that many iterations; after each chunk one host read of the
unconverged mask picks the lanes still going, and only those are
gathered (data by global lane id, solver carry by position in the chunk)
and resumed from their carries with the ORIGINAL anchors, so the
coefficients, iteration counts and codes equal the single dispatch's bit
for bit. A chunk of very few lanes is padded with copies of its first
lane (``optimize.common.padded_lane_count``): below 128 lanes x features
a lane's gradient sum would round differently on the H100.

Scatter determinism: each real sample appears at most once per coordinate
and every padded slot carries an exact zero into the discard slot
``num_samples``, so a non-accumulating ``scatter_`` gives the same result
as ``segment_sum`` in any order.

Host blocks: a dataset built by the streamed builder with a
``blocks_dir`` keeps its feature blocks (``bucket.X``, ``passive_X``) as
``np.memmap`` files on the host, where the JAX package hands the memmap
to a jitted call that copies it to the device on each call. Here the copy
is explicit: ``_run_bucketed`` and ``score_random_effect`` copy one
bucket at a time to the dataset's device (:func:`device_block`) in the
dataset's ``storage_dtype`` and drop it after use, and ``score_passive``
pages passive rows in pages of ``PASSIVE_PAGE_ROWS``. The device sees the
same values in the same shapes, so a run on host blocks equals the
in-RAM run bit for bit, in f32 and in bf16.

bf16 blocks (``--precision bf16``): X is the only bf16 operand. The
lane-batched ops promote it to f32 inside each elementwise product
(``data/batch.py``), coefficients, offsets and every sum stay f32, and
no bucket is copied to f32 ahead of the solve.

Entity sharding waits for the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import DenseBatch, acc_dtype_for
from photon_ml_tpu_torch.game.dataset import RandomEffectDataset
from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.ops.aggregators import GLMObjective
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.optimize.common import (
    LaneCompactionState,
    padded_lane_count,
    solver_x0,
)
from photon_ml_tpu_torch.optimize.config import (
    GLMOptimizationConfiguration,
    TASK_LOSS_NAME,
    TaskType,
)
from photon_ml_tpu_torch.optimize.problem import (
    minimize,
    regularization_penalty,
    select_solver,
)

Tensor = torch.Tensor

CONV_MAX_ITERATIONS = 0
CONV_FUNCTION_VALUES = 1
CONV_GRADIENT = 2
CONV_NOT_PROGRESSED = 3
CONVERGENCE_CODE_NAMES = {
    CONV_MAX_ITERATIONS: "MaxIterations",
    CONV_FUNCTION_VALUES: "FunctionValuesConverged",
    CONV_GRADIENT: "GradientConverged",
    CONV_NOT_PROGRESSED: "ObjectiveNotImproving",
}


#: Per-solve telemetry: dispatches (a single solve or one chunk), chunks,
#: host seconds in chunk solves (their reads included) and in the
#: gathers between chunks, and a rolling window of the active-lane counts
#: entering each re-dispatched chunk.
SOLVE_STATS = {"dispatches": 0, "chunks": 0, "solve_secs": 0.0,
               "compact_secs": 0.0, "lane_counts": []}


def reset_solve_stats() -> None:
    SOLVE_STATS.update({"dispatches": 0, "chunks": 0, "solve_secs": 0.0,
                        "compact_secs": 0.0, "lane_counts": []})


#: ``lane_compaction_chunk`` value (driver flag ``auto``): the problem's
#: :class:`ChunkAutoTuner` picks the chunk and re-tunes it between solves.
AUTO_COMPACTION_CHUNK = -1


def _pow2_at_most(x: int) -> int:
    return 1 << max(int(x).bit_length() - 1, 0)


class ChunkAutoTuner:
    """The compaction chunk's feedback rule (``random_effect.py:128-190``):
    from the share of lanes still active after a solve's first chunk,
    double the chunk above 0.75 (too few lanes shed to pay for the
    chunk's read and gathers), halve it below 0.25 (most lanes idled
    through the chunk's tail), else keep it. One tuner per problem, keyed
    by (solver, max_iterations); the first chunk is the power of two at
    most max_iterations / 4, and every chunk stays a power of two in
    [4, max_iterations)."""

    MIN_CHUNK = 4

    def __init__(self):
        self._chunks: dict = {}

    def chunk_for(self, solver: str, max_iterations: int) -> int:
        if max_iterations <= self.MIN_CHUNK:
            return 0  # nothing to chunk: single dispatch
        key = (solver, max_iterations)
        c = self._chunks.get(key)
        if c is None:
            c = max(self.MIN_CHUNK, _pow2_at_most(max_iterations // 4))
            self._chunks[key] = c
        return c

    def update(self, solver: str, max_iterations: int,
               lane_counts: list) -> None:
        """Feed one solve's per-chunk active-lane sequence back."""
        if max_iterations <= self.MIN_CHUNK or not lane_counts:
            return
        key = (solver, max_iterations)
        c = self._chunks.get(key)
        if c is None or lane_counts[0] <= 0:
            return
        # one chunk: everything converged inside it
        survival = (0.0 if len(lane_counts) == 1
                    else lane_counts[1] / lane_counts[0])
        if survival > 0.75:
            c *= 2
        elif survival < 0.25:
            c //= 2
        self._chunks[key] = min(max(c, self.MIN_CHUNK),
                                _pow2_at_most(max_iterations - 1))


#: passive rows scored per page (one page below this count)
PASSIVE_PAGE_ROWS = 1 << 22


def device_block(block, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> Tensor:
    """A feature block on ``device``: a device tensor as it is, a host
    (memmap) array copied there in ``dtype``."""
    if isinstance(block, torch.Tensor):
        return block
    return torch.from_numpy(np.asarray(block)).to(device=device, dtype=dtype)


def _vg(w: Tensor, payload) -> tuple[Tensor, Tensor]:
    obj, batch = payload
    return obj.calculate(w, batch)


def _hvp(w: Tensor, v: Tensor, payload) -> Tensor:
    obj, batch = payload
    return obj.hessian_vector(w, v, batch)


def _fit_blocks_impl(X: Tensor, labels: Tensor, offsets: Tensor,
                     weights: Tensor, initial: Tensor, obj: GLMObjective,
                     l1: Tensor, solver: str, max_iter: int,
                     tolerance: float, boundary_convergence: bool = False,
                     resume=None, return_carry: bool = False):
    """Solve every entity lane of ``X [E, N, D]`` with ``solver``
    ("lbfgs" / "owlqn" / "tron"; ``l1 [D]`` is OWL-QN's weight); returns
    (coefs [E, D], iterations [E], final values [E], convergence codes
    [E] int8), and the solver's per-lane carry after them with
    ``return_carry``.

    ``resume`` continues each lane from a previous chunk's carry; the
    classification then anchors to the carry's original ``f0``/``g0n``
    and compares a lane that stops at once with its pre-boundary value
    (``:258-287``). ``boundary_convergence`` marks a chunk that is not
    the solve's last: a lane that meets a criterion on the chunk's last
    budgeted iteration reports that criterion instead of MaxIterations,
    so it leaves the active set with its real reason."""
    batch = DenseBatch(X=X, labels=labels, offsets=offsets, weights=weights)
    out = minimize(solver, _vg, _hvp, initial, (obj, batch), l1, max_iter,
                   tolerance, resume=resume, return_carry=return_carry)
    x, hist, progressed = out[:3]
    k = hist.num_iterations
    rows = torch.arange(k.shape[0], device=k.device)
    final_value = hist.values[rows, k]
    prev_value = hist.values[rows, torch.clamp(k - 1, min=0)]
    if resume is None:
        f0, g0n, fv_gate = hist.values[:, 0], hist.grad_norms[:, 0], k >= 1
    else:
        f0, g0n = resume.f0, resume.g0n
        prev_value = torch.where(k >= 1, prev_value, resume.prev_f)
        fv_gate = torch.ones_like(progressed)
    # classification in the host order of Optimizer.getConvergenceReason:
    # max-iterations, not-progressed, function values, gradient
    fv = fv_gate & ((final_value - prev_value).abs()
                    <= tolerance * f0.abs())
    gv = hist.grad_norms[rows, k] <= tolerance * g0n

    def code(c):
        return torch.full_like(k, c)

    def classify(fallback):
        return torch.where(
            ~progressed, code(CONV_NOT_PROGRESSED),
            torch.where(fv, code(CONV_FUNCTION_VALUES),
                        torch.where(gv, code(CONV_GRADIENT),
                                    code(fallback))))

    exhausted = (classify(CONV_MAX_ITERATIONS) if boundary_convergence
                 else code(CONV_MAX_ITERATIONS))
    codes = torch.where(k >= max_iter, exhausted,
                        classify(CONV_FUNCTION_VALUES)).to(torch.int8)
    if return_carry:
        return x, k, final_value, codes, out[3]
    return x, k, final_value, codes


def _dispatch_fit(*args, **kwargs):
    """One solve of a block (or of one chunk), counted."""
    SOLVE_STATS["dispatches"] += 1
    return _fit_blocks_impl(*args, **kwargs)


def _fit_blocks_compacted(X: Tensor, labels: Tensor, offsets: Tensor,
                          weights: Tensor, x0: Tensor, obj: GLMObjective,
                          l1: Tensor, solver: str, max_iter: int,
                          tolerance: float, chunk: int,
                          lane_seq: Optional[list] = None):
    """The solve in chunks of ``chunk`` iterations, re-dispatching only the
    lanes that spent a chunk's budget without converging
    (``random_effect.py:361-453``); returns what ``_fit_blocks_impl``
    returns for the whole block, equal to it bit for bit. ``lane_seq``
    collects the active-lane count entering each chunk (the tuner's
    signal)."""
    state = LaneCompactionState.initial(x0, x0.dtype)
    idx: Optional[np.ndarray] = None
    carry = None
    cur = (X, labels, offsets, weights, x0)
    spent = chunk_index = 0
    while True:
        budget = min(chunk, max_iter - spent)
        final_chunk = spent + budget >= max_iter
        active_lanes = int(X.shape[0]) if idx is None else len(idx)
        if lane_seq is not None:
            lane_seq.append(active_lanes)
        t0 = time.perf_counter()
        # one span per chunk, labelled with the real lanes entering it
        with trace.span("re.compact_chunk", chunk=chunk_index,
                        active_lanes=active_lanes, budget=budget):
            out = _dispatch_fit(*cur, obj, l1, solver, budget, tolerance,
                                boundary_convergence=not final_chunk,
                                resume=carry, return_carry=not final_chunk)
            still, still_local = state.absorb(idx, *out[:4],
                                              CONV_MAX_ITERATIONS)
        chunk_index += 1
        SOLVE_STATS["solve_secs"] += time.perf_counter() - t0
        SOLVE_STATS["chunks"] += 1
        spent += budget
        if final_chunk or len(still) == 0:
            break
        t0 = time.perf_counter()
        idx = still
        # data gather by global lane id, the carry by position in the
        # chunk that produced it; pad lanes repeat the first lane
        pad = padded_lane_count(len(still), int(X.shape[0]),
                                int(X.shape[2])) - len(still)
        rows = torch.as_tensor(np.concatenate([still, still[:1].repeat(pad)]),
                               device=X.device)
        local = torch.as_tensor(
            np.concatenate([still_local, still_local[:1].repeat(pad)]),
            device=X.device)
        carry = type(out[4])(*(t[local] for t in out[4]))
        cur = (X[rows], labels[rows], offsets[rows], weights[rows], carry.x)
        SOLVE_STATS["compact_secs"] += time.perf_counter() - t0
        SOLVE_STATS["lane_counts"] = (SOLVE_STATS["lane_counts"][-63:]
                                      + [len(still)])
    return state.results()


@dataclasses.dataclass(frozen=True)
class RandomEffectOptimizationProblem:
    """Per-entity GLM problems for one random-effect coordinate: one config
    for all entities; the per-entity state is the coefficient block."""

    config: GLMOptimizationConfiguration
    task: TaskType
    #: > 0: solve in chunks of this many iterations with lane compaction;
    #: ``AUTO_COMPACTION_CHUNK``: the chunk of ``chunk_tuner``; 0: one
    #: dispatch of every lane
    lane_compaction_chunk: int = 0
    #: the problem's own tuner, alive across sweeps
    chunk_tuner: ChunkAutoTuner = dataclasses.field(
        default_factory=ChunkAutoTuner, compare=False, repr=False)

    def objective(self) -> GLMObjective:
        cfg = self.config
        return GLMObjective(
            loss=get_loss(TASK_LOSS_NAME[self.task]),
            l2_lambda=cfg.regularization_context.l2_weight(
                cfg.regularization_weight),
            has_hessian=self.task != TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)

    def run(self, dataset: RandomEffectDataset, offsets,
            initial: Optional[Tensor] = None
            ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        """Fit all entities; returns (coefficients [E, D_red], iterations,
        final losses, convergence codes). ``offsets`` is the entity-major
        block (a list per bucket when bucketed)."""
        cfg = self.config
        solver = select_solver(cfg, self.task)
        l1 = cfg.regularization_context.l1_weight(cfg.regularization_weight)
        if dataset.buckets is not None:
            with trace.span("re.solve", solver=solver, bucketed=True,
                            entities=int(dataset.num_entities)):
                return self._run_bucketed(dataset, offsets, initial,
                                          solver, l1)
        e, _, d = dataset.X.shape
        acc = acc_dtype_for(dataset.X.dtype)
        x0 = solver_x0(acc, (e, d), initial, dataset.X.device)
        with trace.span("re.solve", solver=solver, bucketed=False,
                        entities=int(e)):
            return self._fit(dataset.X, dataset.labels, offsets.to(acc),
                             dataset.weights, x0, self.objective(),
                             torch.full((d,), l1, dtype=acc,
                                        device=x0.device), solver)

    def _fit(self, X, labels, offsets, weights, x0, obj, l1: Tensor,
             solver: str):
        """One entity block: compacted in chunks when
        ``lane_compaction_chunk`` engages, else one dispatch
        (``random_effect.py:788-840``)."""
        cfg = self.config
        chunk = self.lane_compaction_chunk
        auto = chunk == AUTO_COMPACTION_CHUNK
        if auto:
            chunk = self.chunk_tuner.chunk_for(solver, cfg.max_iterations)
        if 0 < chunk < cfg.max_iterations and int(X.shape[0]) > 1:
            lane_seq = [] if auto else None
            out = _fit_blocks_compacted(
                X, labels, offsets, weights, x0, obj, l1, solver,
                cfg.max_iterations, float(cfg.tolerance), chunk,
                lane_seq=lane_seq)
            if auto:
                self.chunk_tuner.update(solver, cfg.max_iterations,
                                        lane_seq)
            return out
        return _dispatch_fit(X, labels, offsets, weights, x0, obj, l1,
                             solver, cfg.max_iterations,
                             float(cfg.tolerance))

    def _run_bucketed(self, dataset: RandomEffectDataset, offsets,
                      initial: Optional[Tensor], solver: str, l1: float):
        """Per-bucket solves assembled into one compact global block in
        bucket-major entity order (``random_effect.py:895-954``)."""
        d_red = dataset.reduced_dim
        dev = dataset.device
        obj = self.objective()
        outs = []
        for bucket, off_b in zip(dataset.buckets, offsets):
            # a host block is copied here and dropped after its solve
            X = device_block(bucket.X, dev, dataset.storage_dtype)
            acc = acc_dtype_for(X.dtype)
            e_b, _, d_b = X.shape
            nr, start = bucket.num_real, bucket.entity_start
            if initial is None:
                x0_b = torch.zeros((e_b, d_b), dtype=acc, device=dev)
            else:
                x0_b = torch.nn.functional.pad(
                    initial.to(acc)[start:start + nr, :d_b],
                    (0, 0, 0, e_b - nr))
            outs.append(self._fit(
                X, bucket.labels, off_b.to(acc), bucket.weights, x0_b,
                obj, torch.full((d_b,), l1, dtype=acc, device=dev), solver))
            del X
        acc = outs[0][0].dtype  # the solver state's
        pairs = list(zip(dataset.buckets, outs))
        coefs = torch.cat([
            torch.nn.functional.pad(c[:b.num_real],
                                    (0, d_red - int(c.shape[1]))).to(acc)
            for b, (c, _, _, _) in pairs])
        iters = torch.cat([it[:b.num_real] for b, (_, it, _, _) in pairs])
        values = torch.cat([v[:b.num_real].to(acc)
                            for b, (_, _, v, _) in pairs])
        codes = torch.cat([k[:b.num_real] for b, (_, _, _, k) in pairs])
        return coefs, iters, values, codes

    def regularization_value_device(self, coefs: Tensor):
        """Sum over entities of the L1 + L2 penalty as a device scalar;
        Python ``0.0`` when the config has none."""
        return regularization_penalty(self.config, coefs)

    def regularization_value(self, coefs: Tensor) -> float:
        val = self.regularization_value_device(coefs)
        return val if isinstance(val, float) else float(val)


def score_active(X: Tensor, coefs: Tensor, row_ids: Tensor, weights: Tensor,
                 num_samples: int) -> Tensor:
    """Scatter per-entity active-row margins back to the sample axis;
    padded rows (weight 0) land in the discard slot ``num_samples``."""
    margins = torch.einsum("end,ed->en", X.to(torch.float32),
                           coefs.to(torch.float32))
    margins = torch.where(weights > 0, margins, torch.zeros_like(margins))
    flat = margins.new_zeros(num_samples + 1)
    flat.scatter_(0, row_ids.reshape(-1), margins.reshape(-1))
    return flat[:num_samples]


def score_passive(passive_X, passive_entity: Tensor, coefs: Tensor,
                  passive_row_ids: Tensor, num_samples: int,
                  dtype: torch.dtype = torch.float32) -> Tensor:
    """Score passive rows with their entity's model (gather + row dot), in
    pages of ``PASSIVE_PAGE_ROWS`` rows (``passive_X`` may be a host
    memmap, paged in ``dtype``; a row's dot does not depend on the
    page)."""
    flat = None
    for lo in range(0, int(passive_X.shape[0]), PASSIVE_PAGE_ROWS):
        hi = lo + PASSIVE_PAGE_ROWS
        X = device_block(passive_X[lo:hi], coefs.device, dtype)
        margins = (X * coefs[passive_entity[lo:hi]]).sum(-1)
        if flat is None:
            flat = margins.new_zeros(num_samples + 1)
        flat.scatter_(0, passive_row_ids[lo:hi], margins)
    return flat[:num_samples]


def score_random_effect(dataset: RandomEffectDataset,
                        coefs: Tensor) -> Tensor:
    """Full sample-axis score vector (active + passive) for a coordinate;
    ``coefs`` is the compact global block ``[num_entities, reduced_dim]``."""
    n = dataset.num_samples
    if dataset.buckets is not None:
        s = coefs.new_zeros(n, dtype=torch.float32)
        for b in dataset.buckets:
            X = device_block(b.X, coefs.device, dataset.storage_dtype)
            e_b, _, d_b = X.shape
            c_b = coefs.new_zeros((e_b, d_b))
            c_b[:b.num_real] = coefs[b.entity_start:b.entity_start
                                     + b.num_real, :d_b]
            s = s + score_active(X, c_b, b.row_ids, b.weights, n)
            del X
    else:
        s = score_active(dataset.X, coefs, dataset.row_ids, dataset.weights,
                         n)
    if dataset.num_passive:
        s = s + score_passive(dataset.passive_X, dataset.passive_entity,
                              coefs, dataset.passive_row_ids, n,
                              dataset.storage_dtype)
    return s
