"""Random-effect solver: one lane-batched solve over entity blocks.

Port of ``photon_ml_tpu/game/random_effect.py`` — the ``CONV_*`` codes
(``:67-78``), ``SOLVE_STATS`` (``:99-109``), ``AUTO_COMPACTION_CHUNK`` and
``ChunkAutoTuner`` (``:115-190``), ``_fit_blocks_impl`` (``:193-296``, the
JAX package ``vmap``s a single-lane solver over entities; here the
``[E, N, D]`` block is one lane-batched L-BFGS, OWL-QN or TRON solve with
the per-lane convergence classification of ``:258-287``, the same for
every solver), ``_fit_blocks_compacted`` (``:361-453``),
``RandomEffectOptimizationProblem`` with ``_fit``/``run``/
``_run_bucketed`` (``:739-975``), the score exchange ``score_active``/
``score_passive``/``score_random_effect`` (``:978-1058``) and the
mesh-sharded dispatch (``:457-740``).

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

Entity sharding (``entity_shards`` > 1 with a default mesh whose entity
axis is > 1, the driver's ``--re-entity-shards``): a block's lanes are
split over the entity axis and every shard solves its own lanes on its
own device (``parallel/collectives.run_shards``; in a thread of its own,
or in turn when every shard is on one device), with no collective inside
the solve; lanes are independent, and the 3-D batch
ops reduce each lane alone, so the sharded fit equals the unsharded one
bit for bit. Lane compaction runs per shard: after each chunk the host
splits the still-active lanes by their home shard, pads every shard's
list to one width (with copies of one of its lanes, at least
``padded_lane_count``'s floor) and each shard gathers its lanes from its
own slice of the block and of its carry. This is a loop of its own
beside ``_fit_blocks_compacted`` rather than that loop called once per
shard, because it keeps the reference's sync contract: a chunk is one
dispatch over the whole axis and costs the one blocking read of the
unconverged mask that an unsharded chunk costs. Per-shard loops would
read K masks per chunk, and each read stalls the host until that shard's
queued work ends (on one card, where the shards run in turn, K stalls
where there was one). The score exchange scores each
shard's lanes into a sample-axis partial and sums the partials over the
entity axis in shard order (``qpsum``: int8 on the wire with
``collective_quant="int8"``); without quantization that sum adds exact
zeros and equals the unsharded score. A block whose lanes do not divide
the axis, or a run without such a mesh, runs unsharded with one logged
warning per cause. ``re.shard_dispatch`` is the fault point on a sharded
block's coefficients.

Across a gang's processes (``parallel/multihost.py``): the default mesh's
entity axis spans the processes, and each process holds only its slice of
every block (``RandomEffectDataset.entity_shard``, from the streamed
builder's ``entity_shard``). A process solves its slice's lanes over its
own shards of the axis, and the slices' outputs are gathered over the
process group in process order into the compact global block, which every
process keeps whole. The score exchange sums every shard's sample-axis
partial of every process in global shard order, and passive rows, which
every process holds whole, are scored with the global block.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import DenseBatch, acc_dtype_for
from photon_ml_tpu_torch.game.dataset import RandomEffectDataset
from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.obs.metrics import REGISTRY
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
from photon_ml_tpu_torch.parallel.collectives import (
    ProcessSpan,
    run_shards,
    tree_to,
)
from photon_ml_tpu_torch.parallel.mesh import (
    ENTITY_AXIS,
    ensure_addressable,
    get_default_mesh,
)
from photon_ml_tpu_torch.parallel.quantized_collectives import (
    qpsum,
    record_collective_bytes,
)
from photon_ml_tpu_torch.utils.faults import fault_point

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

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
#: entering each re-dispatched chunk. The ``shard_*`` keys count the
#: entity-sharded path: real and padded lanes of its dispatches and a
#: rolling window of the per-shard active-lane counts.
SOLVE_STATS = {"dispatches": 0, "chunks": 0, "solve_secs": 0.0,
               "compact_secs": 0.0, "lane_counts": [],
               "shard_real_lanes": 0, "shard_padded_lanes": 0,
               "shard_lane_counts": []}


def reset_solve_stats() -> None:
    SOLVE_STATS.update({"dispatches": 0, "chunks": 0, "solve_secs": 0.0,
                        "compact_secs": 0.0, "lane_counts": [],
                        "shard_real_lanes": 0, "shard_padded_lanes": 0,
                        "shard_lane_counts": []})


#: ``lane_compaction_chunk`` value (driver flag ``auto``): the problem's
#: :class:`ChunkAutoTuner` picks the chunk and re-tunes it between solves.
AUTO_COMPACTION_CHUNK = -1

#: ``--re-entity-shards`` value ``auto``: every visible device on the
#: mesh's entity axis (the driver resolves it before building the mesh).
AUTO_ENTITY_SHARDS = -1


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
        REGISTRY.histogram("re_chunk_active_lanes").observe(active_lanes)
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


# ---------------------------------------------------------------------------
# Mesh-sharded dispatch (``random_effect.py:457-740``): a block's lanes split
# over the entity axis, one thread per shard, no collective inside a solve.
# ---------------------------------------------------------------------------


def _lane_pieces(t: Tensor, devices: list) -> list:
    """``t``'s lanes split evenly over ``devices``, each piece on its
    device (a view where it is ``t``'s own)."""
    step = int(t.shape[0]) // len(devices)
    return [t[i * step:(i + 1) * step].to(d) for i, d in enumerate(devices)]


def _gather_lanes(outs: list, device: torch.device) -> list:
    """The shards' lane outputs (coefficients, iterations, values, codes)
    concatenated in shard order on ``device``."""
    return [ensure_addressable([o[j] for o in outs]).to(device)
            for j in range(4)]


def _dispatch_fit_sharded(devices: list, pieces: list, x0: Tensor, obj,
                          l1: Tensor, solver: str, max_iter: int,
                          tolerance: float,
                          boundary_convergence: bool = False,
                          return_carry: bool = False):
    """Every shard solves its own lanes (``pieces``: X, labels, offsets,
    weights split by :func:`_lane_pieces`) from its slice of ``x0``.
    Returns the lane outputs on ``x0``'s device and, with
    ``return_carry``, the per-shard carries (each on its shard's
    device)."""
    x0_pieces = _lane_pieces(x0, devices)
    e = int(x0.shape[0])
    SOLVE_STATS["dispatches"] += 1
    SOLVE_STATS["shard_real_lanes"] += e  # a full dispatch has no pad
    SOLVE_STATS["shard_padded_lanes"] += e

    def body(X, labels, offsets, weights, initial):
        dev = initial.device
        return _fit_blocks_impl(X, labels, offsets, weights, initial,
                                tree_to(obj, dev), l1.to(dev), solver,
                                max_iter, tolerance,
                                boundary_convergence=boundary_convergence,
                                return_carry=return_carry)

    outs = run_shards(body, devices, ENTITY_AXIS,
                      [(*p, x) for p, x in zip(zip(*pieces), x0_pieces)],
                      collectives=False)
    lanes = _gather_lanes(outs, x0.device)
    return lanes, ([o[4] for o in outs] if return_carry else None)


def _dispatch_fit_sharded_resume(devices: list, pieces: list,
                                 rows_data: np.ndarray,
                                 rows_carry: np.ndarray, carries: list,
                                 obj, l1: Tensor, solver: str,
                                 max_iter: int, tolerance: float,
                                 boundary_convergence: bool,
                                 return_carry: bool, device: torch.device):
    """A resumed compacted chunk: shard ``s`` gathers the lanes of row
    ``s`` of ``rows_data`` (ids local to its slice of the block) and of
    ``rows_carry`` (positions in its previous carry) and resumes them."""

    def body(X, labels, offsets, weights, idx_d, idx_c, carry):
        dev = X.device
        d = torch.as_tensor(idx_d, device=dev)
        res = type(carry)(*(t[torch.as_tensor(idx_c, device=t.device)]
                            for t in carry))
        return _fit_blocks_impl(X[d], labels[d], offsets[d], weights[d],
                                res.x, tree_to(obj, dev), l1.to(dev),
                                solver, max_iter, tolerance,
                                boundary_convergence=boundary_convergence,
                                resume=res, return_carry=return_carry)

    SOLVE_STATS["dispatches"] += 1
    args = [(*p, rows_data[s], rows_carry[s], carries[s])
            for s, p in enumerate(zip(*pieces))]
    outs = run_shards(body, devices, ENTITY_AXIS, args, collectives=False)
    lanes = _gather_lanes(outs, device)
    return lanes, ([o[4] for o in outs] if return_carry else None)


def _fit_blocks_compacted_sharded(devices: list, X: Tensor, labels: Tensor,
                                  offsets: Tensor, weights: Tensor,
                                  x0: Tensor, obj, l1: Tensor, solver: str,
                                  max_iter: int, tolerance: float,
                                  chunk: int,
                                  lane_seq: Optional[list] = None):
    """:func:`_fit_blocks_compacted` with per-shard compaction
    (``random_effect.py:552-671``). A lane's home shard never changes
    (global id // lanes per shard). After each chunk the host splits the
    still-active lanes by owner and pads every shard's list to one width
    ``L`` with copies of one of the shard's lanes (a shard with no active
    lane re-runs one of its converged lanes, a no-op: its carry fails the
    loop test at once). Each chunk costs one read (the unconverged mask),
    as the unsharded loop's does: the reason this is not
    :func:`_fit_blocks_compacted` run once per shard (module docstring)."""
    K = len(devices)
    e = int(X.shape[0])
    e_shard = e // K
    d = int(X.shape[2])
    pieces = [_lane_pieces(t, devices) for t in (X, labels, offsets,
                                                 weights)]
    state = LaneCompactionState.initial(x0, x0.dtype)
    idx: Optional[np.ndarray] = None  # flat [K * L] global ids
    mask: Optional[np.ndarray] = None  # flat [K * L] real-slot flags
    carries = None
    cur_rows = None
    prev_width = e_shard
    prev_global = np.arange(e, dtype=np.int64).reshape(K, e_shard)
    spent = chunk_index = 0
    while True:
        budget = min(chunk, max_iter - spent)
        final_chunk = spent + budget >= max_iter
        active_lanes = e if idx is None else int(mask.sum())
        if lane_seq is not None:
            lane_seq.append(active_lanes)
        t0 = time.perf_counter()
        with trace.span("re.shard_chunk", chunk=chunk_index,
                        active_lanes=active_lanes, budget=budget,
                        shards=K):
            common = dict(boundary_convergence=not final_chunk,
                          return_carry=not final_chunk)
            if idx is None:
                lanes, new_carries = _dispatch_fit_sharded(
                    devices, pieces, x0, obj, l1, solver, budget,
                    tolerance, **common)
                still, still_local = state.absorb(None, *lanes,
                                                  CONV_MAX_ITERATIONS)
            else:
                lanes, new_carries = _dispatch_fit_sharded_resume(
                    devices, pieces, cur_rows[0], cur_rows[1], carries,
                    obj, l1, solver, budget, tolerance, device=x0.device,
                    **common)
                still, still_local = state.absorb_padded(
                    idx, mask, *lanes, CONV_MAX_ITERATIONS)
        REGISTRY.histogram("re_chunk_active_lanes").observe(active_lanes)
        chunk_index += 1
        SOLVE_STATS["solve_secs"] += time.perf_counter() - t0
        SOLVE_STATS["chunks"] += 1
        spent += budget
        if final_chunk or len(still) == 0:
            break
        t0 = time.perf_counter()
        carries = new_carries
        owner = still_local // prev_width
        counts = np.bincount(owner, minlength=K)
        L = padded_lane_count(int(counts.max()), e_shard, d)
        rows_global = np.empty((K, L), np.int64)
        rows_carry = np.zeros((K, L), np.int64)
        rows_mask = np.zeros((K, L), bool)
        for s in range(K):
            sel = owner == s
            g_ids = still[sel]
            l_pos = still_local[sel] % prev_width
            n = len(g_ids)
            fill_g, fill_c = ((g_ids[0], l_pos[0]) if n
                              else (prev_global[s, 0], 0))
            rows_global[s] = fill_g
            rows_carry[s] = fill_c
            rows_global[s, :n] = g_ids
            rows_carry[s, :n] = l_pos
            rows_mask[s, :n] = True
        idx = rows_global.reshape(-1)
        mask = rows_mask.reshape(-1)
        cur_rows = (rows_global
                    - np.arange(K, dtype=np.int64)[:, None] * e_shard,
                    rows_carry)
        prev_global = rows_global
        prev_width = L
        SOLVE_STATS["compact_secs"] += time.perf_counter() - t0
        SOLVE_STATS["shard_real_lanes"] += int(counts.sum())
        SOLVE_STATS["shard_padded_lanes"] += K * L
        SOLVE_STATS["shard_lane_counts"] = (
            SOLVE_STATS["shard_lane_counts"][-15:] + [counts.tolist()])
        SOLVE_STATS["lane_counts"] = (SOLVE_STATS["lane_counts"][-63:]
                                      + [len(still)])
    return state.results()


#: fallback causes already logged (one warning per cause, not per sweep)
_SHARD_FALLBACK_WARNED: set = set()


def _resolve_entity_shards(entity_shards: int, num_lanes: int):
    """(this process's devices of the entity axis, K) when the sharded path
    engages for a block of ``num_lanes`` lanes (this process's slice of
    them on a process-spanning axis), else (None, 1) with one logged
    warning per cause (``random_effect.py:678-707``). K counts the whole
    axis."""
    if entity_shards <= 1:
        return None, 1
    mesh = get_default_mesh()
    K = int(mesh.shape[ENTITY_AXIS]) if mesh is not None else 1
    if K <= 1:
        reason = ("no-mesh", entity_shards)
        if reason not in _SHARD_FALLBACK_WARNED:
            _SHARD_FALLBACK_WARNED.add(reason)
            logger.warning(
                "re-entity-shards=%d requested but no default mesh with an "
                "entity axis > 1 is installed; running unsharded",
                entity_shards)
        return None, 1
    devices = mesh.axis_devices(ENTITY_AXIS)
    if num_lanes % len(devices) != 0:
        if mesh.span is not None:  # a gang must not fall back per process
            raise ValueError(
                f"entity slice of {num_lanes} lanes does not divide this "
                f"process's {len(devices)} entity shards")
        reason = ("ragged", num_lanes, K)
        if reason not in _SHARD_FALLBACK_WARNED:
            _SHARD_FALLBACK_WARNED.add(reason)
            logger.warning(
                "entity block of %d lanes does not divide %d entity "
                "shards; running this block unsharded (build the dataset "
                "with entity_axis_size=%d to pad it)", num_lanes, K, K)
        return None, 1
    return devices, K


def _entity_axis_span() -> Optional[ProcessSpan]:
    """The process span of the default mesh's entity axis, if any."""
    mesh = get_default_mesh()
    return None if mesh is None else mesh.span_of(ENTITY_AXIS)


def _process_span(dataset: RandomEffectDataset) -> Optional[ProcessSpan]:
    """The process span a gang member's sliced ``dataset`` is gathered
    over (the default mesh's entity axis); None for a whole dataset."""
    k = int(dataset.entity_shard[1])
    if k <= 1:
        return None
    span = _entity_axis_span()
    if span is None or span.size != k:
        raise RuntimeError(
            f"a dataset sliced over {k} processes needs a default mesh "
            f"whose entity axis spans {k} processes, got "
            f"{get_default_mesh()!r}")
    return span


def _local_lanes(coefs: Tensor, offset: int, lanes: int) -> Tensor:
    """Rows ``[offset, offset + lanes)`` of a block's padded coefficients
    ``coefs`` (rows past its end are zero: padding lanes)."""
    out = coefs.new_zeros((lanes,) + tuple(coefs.shape[1:]))
    real = max(0, min(int(coefs.shape[0]) - offset, lanes))
    out[:real] = coefs[offset:offset + real]
    return out


def _gather_slices(out: tuple, span: Optional[ProcessSpan]) -> tuple:
    """A solve's lane outputs (coefficients, iterations, values, codes)
    of every process's slice, concatenated in process order."""
    if span is None:
        return out
    return tuple(torch.cat(span.all_gather(t)) for t in out)


def _sharded_score(devices: list, X: Tensor, coefs: Tensor,
                   row_ids: Tensor, weights: Tensor, num_samples: int,
                   collective_quant: str = "none",
                   span: Optional[ProcessSpan] = None) -> Tensor:
    """The active-score exchange over the entity axis
    (``random_effect.py:710-740``): every shard scores its lanes into a
    sample-axis partial, and the partials are summed over the axis in
    shard order (int8 on the wire with ``collective_quant``; over every
    process's shards with ``span``); returns the sum on ``coefs``'
    device."""
    pieces = [_lane_pieces(t, devices) for t in (X, coefs, row_ids,
                                                 weights)]

    def body(X_s, c_s, r_s, w_s):
        return qpsum(score_active(X_s, c_s, r_s, w_s, num_samples),
                     ENTITY_AXIS, mode=collective_quant)

    outs = run_shards(body, devices, ENTITY_AXIS, list(zip(*pieces)),
                      span=span)
    return outs[0].to(coefs.device)


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
    #: > 1: split each block's lanes over the default mesh's entity axis
    #: (``--re-entity-shards``); engages with a mesh whose entity axis is
    #: > 1 and a block whose lanes divide it, else runs unsharded
    entity_shards: int = 1
    #: wire format of the sharded score exchange ("none" | "int8"); the
    #: per-entity solves have no collective
    collective_quant: str = "none"

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
        span = _process_span(dataset)
        if span is not None and initial is not None:
            initial = _local_lanes(initial, dataset.local_entity_offset, e)
        x0 = solver_x0(acc, (e, d), initial, dataset.X.device)
        with trace.span("re.solve", solver=solver, bucketed=False,
                        entities=int(e)):
            return _gather_slices(self._fit(
                dataset.X, dataset.labels, offsets.to(acc), dataset.weights,
                x0, self.objective(),
                torch.full((d,), l1, dtype=acc, device=x0.device), solver,
                fault_tag="0"), span)

    def _fit(self, X, labels, offsets, weights, x0, obj, l1: Tensor,
             solver: str, fault_tag: Optional[str] = None):
        """One entity block: compacted in chunks when
        ``lane_compaction_chunk`` engages, else one dispatch; over the
        mesh's entity axis when ``entity_shards`` engages
        (``random_effect.py:788-840``)."""
        cfg = self.config
        chunk = self.lane_compaction_chunk
        auto = chunk == AUTO_COMPACTION_CHUNK
        if auto:
            chunk = self.chunk_tuner.chunk_for(solver, cfg.max_iterations)
        e = int(X.shape[0])
        devices, shards = _resolve_entity_shards(self.entity_shards, e)
        if shards > 1:
            with trace.span("re.shard_solve", solver=solver, shards=shards,
                            lanes=e):
                if 0 < chunk < cfg.max_iterations and e // len(devices) > 1:
                    lane_seq = [] if auto else None
                    out = _fit_blocks_compacted_sharded(
                        devices, X, labels, offsets, weights, x0, obj, l1,
                        solver, cfg.max_iterations, float(cfg.tolerance),
                        chunk, lane_seq=lane_seq)
                    if auto:
                        self.chunk_tuner.update(solver, cfg.max_iterations,
                                                lane_seq)
                else:
                    pieces = [_lane_pieces(t, devices)
                              for t in (X, labels, offsets, weights)]
                    out, _ = _dispatch_fit_sharded(
                        devices, pieces, x0, obj, l1, solver,
                        cfg.max_iterations, float(cfg.tolerance))
            # a fault inside a sharded solve rides the CD recovery ladder
            poisoned = fault_point("re.shard_dispatch", tag=fault_tag,
                                   arrays=out[0])
            return (poisoned, *out[1:])
        if 0 < chunk < cfg.max_iterations and e > 1:
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
        span = _process_span(dataset)
        outs = []
        for bi, (bucket, off_b) in enumerate(zip(dataset.buckets, offsets)):
            # a host block is copied here and dropped after its solve
            X = device_block(bucket.X, dev, dataset.storage_dtype)
            acc = acc_dtype_for(X.dtype)
            e_b, _, d_b = X.shape  # this process's slice on a gang
            nr, start = bucket.num_real, bucket.entity_start
            if initial is None:
                x0_b = torch.zeros((e_b, d_b), dtype=acc, device=dev)
            else:
                x0_b = _local_lanes(initial.to(acc)[start:start + nr, :d_b],
                                    bucket.local_entity_offset, e_b)
            outs.append(_gather_slices(self._fit(
                X, bucket.labels, off_b.to(acc), bucket.weights, x0_b,
                obj, torch.full((d_b,), l1, dtype=acc, device=dev), solver,
                fault_tag=str(bi)), span))
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
        # photonlint: allow-W101(this IS the host-scalar accessor: one guarded scalar sync per sweep-end objective, annotated -> float)
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


def score_random_effect(dataset: RandomEffectDataset, coefs: Tensor,
                        entity_shards: int = 1,
                        collective_quant: str = "none") -> Tensor:
    """Full sample-axis score vector (active + passive) for a coordinate;
    ``coefs`` is the compact global block ``[num_entities, reduced_dim]``.
    With ``entity_shards`` > 1 (engaging as the sharded solve does) each
    block's active scores come from the entity-sharded exchange, whose
    wire bytes count on ``collective_bytes{site="re.score_psum"}``. A
    gang member's sliced dataset scores its slice's active rows, and the
    exchange over the process-spanning entity axis adds every process's
    partial."""
    n = dataset.num_samples
    span = _process_span(dataset)

    def score_block(X, c_b, row_ids, weights, offset=0):
        if span is not None:
            c_b = _local_lanes(c_b, offset, int(X.shape[0]))
        devices, shards = _resolve_entity_shards(entity_shards,
                                                 int(X.shape[0]))
        axis_span = _entity_axis_span() if shards > 1 else None
        if span is not None and axis_span is None:
            raise RuntimeError("a sliced dataset scores over the "
                               "process-spanning entity axis only (set "
                               "entity_shards to the whole axis)")
        if shards > 1:
            with trace.span("re.shard_score", shards=shards,
                            lanes=int(X.shape[0])):
                out = _sharded_score(devices, X, c_b, row_ids, weights, n,
                                     collective_quant, axis_span)
                record_collective_bytes("re.score_psum", collective_quant,
                                        n)
                return out
        return score_active(X, c_b, row_ids, weights, n)

    if dataset.buckets is not None:
        s = coefs.new_zeros(n, dtype=torch.float32)
        for b in dataset.buckets:
            X = device_block(b.X, coefs.device, dataset.storage_dtype)
            e_b, _, d_b = X.shape
            c_b = coefs[b.entity_start:b.entity_start + b.num_real, :d_b]
            if span is None:
                c_b = _local_lanes(c_b, 0, e_b)
            s = s + score_block(X, c_b, b.row_ids, b.weights,
                                b.local_entity_offset)
            del X
    else:
        s = score_block(dataset.X, coefs, dataset.row_ids, dataset.weights,
                        dataset.local_entity_offset)
    if dataset.num_passive:
        s = s + score_passive(dataset.passive_X, dataset.passive_entity,
                              coefs, dataset.passive_row_ids, n,
                              dataset.storage_dtype)
    return s
