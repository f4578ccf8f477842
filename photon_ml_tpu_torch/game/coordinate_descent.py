"""Coordinate descent: the GAME outer loop, with pipelined and block
sweeps, checkpoints, resume, divergence recovery and graceful stop.

Port of ``photon_ml_tpu/game/coordinate_descent.py`` — ``HOT_LOOP_STATS``
(``:103-106``), ``_InFlight`` (``:158-187``), ``_canonical_sum``
(``:189-196``), ``make_update_epilogue`` (``:208-261``),
``RecoveryPolicy`` (``:265-320``), ``CoordinateDivergenceError``
(``:86``), ``_damp_toward`` (``:337``), ``_checkpoint_save_contained``
(``:391``), ``CoordinateDescentState``/``Result`` (``:361-389``),
``_state_leaves``/``_damp_toward``/``_to_jnp_states`` (``:321-388``: a
state is one tensor or, for a factored random effect, a tuple of them,
handled leaf by leaf everywhere),
``run_coordinate_descent`` (``:412-1256``: resume, per-update validation
and the best model, ``save_snapshot`` and its cadence, dispatch / fetch /
commit / rollback / resolve of a block, the sequential retry / skip /
abort / quarantine ladder ``run_member``, ``replay_block_members``,
``run_block``, the pipelined sweep and the stop poll at the commit
barrier, the ``cd.update`` and ``cd.sweep`` fault points) — and
``publish_game_model`` (``:1258-1261``).

Per (sweep, block of coordinates in ids order): each member solves with
the other coordinates' scores as offsets, taken from the block-start
total, then re-scores, and ONE fused epilogue computes the canonical score
total (summed from zero in ids order with every member's new score), the
training loss, the summed regularization, the objective and the
finiteness flags. Its four scalars are copied to the host without
blocking (a pinned buffer and an event on the card) and read once per
block (``HOT_LOOP_STATS``). With ``block_size`` 1 a block is one
coordinate, the sequential sweep.

``pipeline_depth=1`` (the default, as in the JAX package) dispatches the
next block against the previous epilogue's outputs before that epilogue's
read: the order of work and the late read of the JAX package. The port's
solvers block on their own loop-exit reads (``optimize.common.
SOLVER_SYNCS``), so little work overlaps; the committed floats are those
of ``pipeline_depth=0``. A divergence found by the late read rolls the
speculative dispatch back (the down-sampling update counts included) and
replays it from the last-good state. Pipelining turns itself off while
validation runs after every update and pauses at checkpoint-cadence
points; only block boundaries are commit, snapshot and stop barriers, and
a stop settles the in-flight block before it snapshots.

A snapshot holds everything a bit-exact resume needs, under the JAX
package's keys: ``sweep``, ``coordinate_index``, ``iteration``, per
coordinate ``states`` AND ``scores``, ``best_metric``, ``best_states``,
``update_counts``, ``consecutive_failures``, ``coordinate_failures`` and
``quarantined``. Its step is the global update count ``sweep·K + next``.
The payload leaves the card in one copy (counted as
``HOT_LOOP_STATS["snapshot_fetches"]``). On resume the scores come back
verbatim and the total is summed again in ids order by the same function
the epilogue uses, so the resumed run sees the floats the uninterrupted
one saw.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.coordinate import Coordinate, Tracker
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.optimize.config import TASK_LOSS_NAME, TaskType
from photon_ml_tpu_torch.utils.checkpoint import (
    CHECKPOINT_STATS,
    CheckpointWriteError,
)
from photon_ml_tpu_torch.utils.events import (
    CoordinateQuarantinedEvent,
    EventEmitter,
    FaultEvent,
    RecoveryEvent,
)
from photon_ml_tpu_torch.utils.faults import InjectedFault, fault_point
from photon_ml_tpu_torch.utils.preempt import PreemptionRequested

Tensor = torch.Tensor

#: Hot-loop telemetry: updates committed or refused by their read,
#: epilogue reads (one per block), snapshot payload fetches (one per
#: snapshot written); host seconds dispatching blocks and waiting in their
#: reads; the most updates dispatched and not yet read at once
#: (``max_inflight``), reads taken after a later block was dispatched
#: (``pipelined_resolves``) and the host seconds between such a block's
#: dispatch and its read (``overlap_secs``).
HOT_LOOP_STATS = {"updates": 0, "epilogue_fetches": 0,
                  "snapshot_fetches": 0, "update_dispatch_secs": 0.0,
                  "epilogue_wait_secs": 0.0, "max_inflight": 0,
                  "pipelined_resolves": 0, "overlap_secs": 0.0}


def reset_hot_loop_stats() -> None:
    HOT_LOOP_STATS.update({"updates": 0, "epilogue_fetches": 0,
                           "snapshot_fetches": 0,
                           "update_dispatch_secs": 0.0,
                           "epilogue_wait_secs": 0.0, "max_inflight": 0,
                           "pipelined_resolves": 0, "overlap_secs": 0.0})


class CoordinateDivergenceError(RuntimeError):
    """A coordinate update produced a non-finite state or objective."""


def _canonical_sum(score_list, num_samples: int, device) -> Tensor:
    """Sum of scores in updating-sequence order from zero — the one
    summation order used at start, on resume and inside the epilogue."""
    t = torch.zeros(num_samples, dtype=torch.float32, device=device)
    for s in score_list:
        t = t + s
    return t


def make_update_epilogue(task: TaskType, num_samples: int):
    """The fused update epilogue: (total, objective, train_loss, reg_total,
    finite, state_finite) from the substituted score and reg lists."""
    loss = get_loss(TASK_LOSS_NAME[task])

    def epilogue(score_list, reg_list, state_leaves, labels, weights,
                 offsets):
        total = _canonical_sum(score_list, num_samples, labels.device)
        l, _ = loss.loss_and_d1(total + offsets, labels)
        train_loss = (weights * l).sum()
        reg_total = 0.0
        for r in reg_list:  # ids order
            reg_total = reg_total + r
        objective = train_loss + reg_total
        state_finite = torch.ones((), dtype=torch.bool, device=labels.device)
        for leaf in state_leaves:
            state_finite = state_finite & torch.isfinite(leaf).all()
        finite = state_finite & torch.isfinite(objective)
        return total, objective, train_loss, reg_total, finite, state_finite

    return epilogue


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """What to do when a coordinate update diverges (non-finite state or
    objective) or raises an injected fault: retry up to ``max_retries``
    times from the last-good state with the step damped by
    ``damping**attempt``; then ``skip`` the coordinate for the sweep or
    ``abort``; abort anyway after ``max_consecutive_failures`` skipped
    updates in a row. ``quarantine_after`` > 0 gives each coordinate its
    own budget instead: its exhausted updates are skipped until it has
    ``quarantine_after`` of them, then it is frozen at its last-good
    state for the rest of the run while the others go on."""

    max_retries: int = 2
    on_exhausted: str = "abort"  # "skip" | "abort"
    damping: float = 0.5
    max_consecutive_failures: int = 3
    quarantine_after: int = 0  # 0 = per-coordinate budget disabled

    def __post_init__(self):
        if self.on_exhausted not in ("skip", "abort"):
            raise ValueError(
                f"on_exhausted must be 'skip' or 'abort', "
                f"got {self.on_exhausted!r}")
        if self.quarantine_after < 0:
            raise ValueError(
                f"quarantine_after must be >= 0, "
                f"got {self.quarantine_after}")


def _state_leaves(state) -> tuple:
    """A state's tensors: the tuple's members, or the one tensor."""
    return state if isinstance(state, tuple) else (state,)


def map_state(fn, state):
    """``fn`` applied to each tensor of a state (one tensor, or a tuple of
    them), keeping the state's form."""
    if isinstance(state, tuple):
        return tuple(fn(leaf) for leaf in state)
    return fn(state)


def _damp_toward(good, candidate, factor: float):
    """last_good + factor * (candidate - last_good), leaf by leaf."""
    if isinstance(candidate, tuple):
        return tuple(g + factor * (c - g) for g, c in zip(good, candidate))
    return good + factor * (candidate - good)


@dataclasses.dataclass
class CoordinateDescentState:
    """Per-update record."""

    iteration: int
    coordinate_id: str
    objective: float
    seconds: float
    tracker: Tracker
    validation_metrics: Optional[dict] = None


@dataclasses.dataclass
class CoordinateDescentResult:
    model: GameModel
    states: list
    best_model: Optional[GameModel] = None
    best_metric: Optional[float] = None
    #: coordinates frozen at their last-good state by the per-coordinate
    #: failure budget (``RecoveryPolicy.quarantine_after``)
    quarantined: list = dataclasses.field(default_factory=list)


def publish_game_model(coordinates: dict, states: dict) -> GameModel:
    return GameModel({cid: coordinates[cid].publish(states[cid])
                      for cid in coordinates})


def fetch_to_host(groups: dict) -> dict:
    """``{name: {cid: state} | None}`` -> the same with numpy arrays (a
    tuple state stays a tuple), in ONE device-to-host copy: the f32 leaves
    are flattened into one tensor on their device, copied once, and cut
    back into their shapes."""
    leaves = [(name, cid, t) for name, group in groups.items()
              if group is not None for cid, state in group.items()
              for t in _state_leaves(state)]
    for name, cid, t in leaves:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}[{cid}] is {t.dtype}, not float32")
    out = {name: (None if group is None else {})
           for name, group in groups.items()}
    if not leaves:
        return out
    host = torch.cat([t.detach().reshape(-1)
                      for _, _, t in leaves]).cpu().numpy()
    pieces = iter(np.split(host, np.cumsum([t.numel()
                                            for _, _, t in leaves])[:-1]))
    for name, group in groups.items():
        for cid, state in (group or {}).items():
            out[name][cid] = map_state(
                lambda t: next(pieces).reshape(tuple(t.shape)), state)
    return out


def _checkpoint_save_contained(manager, step: int, snapshot: dict,
                               log, emit) -> bool:
    """Save a snapshot; a persistently unwritable disk
    (``CheckpointWriteError``) is logged, counted and announced, and the
    next cadence point tries again — training goes on."""
    try:
        manager.save(step, snapshot)
        return True
    except CheckpointWriteError as e:
        CHECKPOINT_STATS["save_failures"] += 1
        emit(FaultEvent(point="ckpt.write_bytes", message=str(e)))
        log(lambda: f"checkpoint step {step} NOT saved (degraded, "
            f"training continues): {e}")
        return False




@dataclasses.dataclass
class _InFlight:
    """One dispatched block whose epilogue has not been read yet: its
    candidates and device outputs, the host copy of its four scalars under
    way, and what committing or discarding it needs
    (``update_counts_before`` restores the update counts — a down-sampling
    coordinate's key positions — that the dispatch advanced)."""

    it: int
    block: list  # [(ci, cid), ...] in dispatch order
    attempt: int
    cands: dict
    trackers: dict
    new_scores: dict
    new_regs: dict
    new_total: Tensor  # the epilogue's canonical score total
    host: Tensor  # [objective, train_loss, finite, state_finite]
    ready: Optional[object]  # CUDA event recorded after the copy
    update_counts_before: dict
    snapshot_due: bool
    # resume point of the enclosing RAW block ("about to run this
    # coordinate"): quarantined members still count toward the boundary
    snapshot_next_ci: int
    t_wall: float
    t_dispatched: float
    pipelined: bool = False  # a later block was dispatched before the read


def _start_host_copy(values: Tensor) -> tuple[Tensor, Optional[object]]:
    """Copy ``values`` to the host without blocking: into a pinned buffer
    with an event behind it on the card; a CPU tensor is already there."""
    if values.device.type != "cuda":
        return values, None
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def run_coordinate_descent(
    coordinates: dict,
    num_iterations: int,
    task: TaskType,
    labels,
    weights,
    offsets,
    initial_states: Optional[dict] = None,
    logger: Optional[Callable[[str], None]] = None,
    validation_data=None,
    validation_evaluator: Optional[Callable[[Tensor], dict]] = None,
    validation_metric: Optional[str] = None,
    higher_is_better: bool = True,
    checkpoint_manager=None,
    checkpoint_every_coordinates: int = 0,
    resume_snapshot: Optional[dict] = None,
    recovery: Optional[RecoveryPolicy] = None,
    events: Optional[EventEmitter] = None,
    stop=None,
    block_size: int = 1,
    pipeline_depth: int = 1,
    device="cuda",
) -> CoordinateDescentResult:
    """Run GAME coordinate descent over ``coordinates`` in dict order (the
    updating sequence) for ``num_iterations`` sweeps.

    ``labels/weights/offsets`` describe the training samples (sample-major,
    numpy or tensors; held as f32 on ``device``). ``initial_states`` warm
    starts coordinates (``convert.states_from_numpy`` carries states from
    the JAX package); a warm-started coordinate contributes its score from
    the first update on.

    ``block_size=B`` cuts each sweep into blocks of B coordinates solved
    against the block-start score total and corrected by one epilogue with
    all B new scores; ``pipeline_depth=1`` dispatches each block before
    the previous block's read (``0``: the read first). Both raise
    ``ValueError`` outside ``B >= 1`` and ``depth`` in {0, 1}.

    With ``validation_data`` (a ``GameDataset``) and ``validation_evaluator``
    (device scores -> ``{metric: value}``) every block scores the
    published model on the validation data and records the metrics; the
    model that is best by ``validation_metric`` is kept as ``best_model``.

    With a ``checkpoint_manager`` a snapshot lands after every sweep and,
    with ``checkpoint_every_coordinates`` = N > 0, at the end of every
    block that crosses an Nth update; ``resume_snapshot`` (a restored
    snapshot, of either package) continues from it. With a ``recovery``
    policy a non-finite update or an injected fault walks the retry /
    skip / abort / quarantine ladder, announced on ``events`` (a block
    that fails replays its members one at a time); without one it
    propagates. ``stop`` (anything with ``should_stop() -> str | None``)
    is polled before every block; when it returns a reason a final
    snapshot is written and
    :class:`~photon_ml_tpu_torch.utils.preempt.PreemptionRequested`
    carries the resume point.
    """
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if pipeline_depth not in (0, 1):
        raise ValueError(
            f"pipeline_depth must be 0 (sequential) or 1 (double-"
            f"buffered), got {pipeline_depth}: a deeper pipeline would "
            f"let an epilogue read age more than one dispatch")
    device = resolve_device(device)

    def log(fn: Callable[[], str]):
        if logger is not None:
            logger(fn())

    emit = events.send_event if events is not None else (lambda e: None)

    def on_device(a) -> Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    def state_on_device(state):
        return map_state(on_device, state)

    labels, weights, offsets = on_device(labels), on_device(weights), \
        on_device(offsets)
    ids = list(coordinates)
    num_samples = coordinates[ids[0]].num_samples
    assert all(coordinates[c].num_samples == num_samples for c in ids), \
        "all coordinates must cover the same sample axis"
    epilogue = make_update_epilogue(task, num_samples)

    consecutive_failures = 0
    coordinate_failures: dict[str, int] = {}
    quarantined: set[str] = set()
    start_iteration = start_coordinate = 0
    restored_scores = None
    initial_best = None
    if resume_snapshot is not None:
        snap = resume_snapshot
        initial_states = snap["states"]
        start_iteration = int(snap.get("sweep", snap.get("iteration", 0)))
        start_coordinate = int(snap.get("coordinate_index", 0))
        if snap.get("best_states") is not None:
            initial_best = (snap.get("best_metric"),
                            {cid: state_on_device(v)
                             for cid, v in snap["best_states"].items()})
        if snap.get("scores") is not None:
            restored_scores = {cid: on_device(v)
                               for cid, v in snap["scores"].items()}
        for cid, cnt in (snap.get("update_counts") or {}).items():
            if cid in coordinates and hasattr(coordinates[cid],
                                              "_update_count"):
                coordinates[cid]._update_count = int(cnt)
        consecutive_failures = int(snap.get("consecutive_failures", 0))
        coordinate_failures = {k: int(v) for k, v in
                               (snap.get("coordinate_failures")
                                or {}).items()}
        quarantined = set(snap.get("quarantined") or [])

    given = {cid: state_on_device(v)
             for cid, v in (initial_states or {}).items()}
    states = {cid: (given[cid] if cid in given
                    else coordinates[cid].initial_state()) for cid in ids}
    if restored_scores is not None:
        # mid-sweep resume: the scores come back verbatim (recomputing them
        # would be wrong for a coordinate never updated under a shift)
        scored = restored_scores
    else:
        scored = {cid: coordinates[cid].score(states[cid]) for cid in ids
                  if cid in given}
    scores = {cid: (scored[cid] if cid in scored else torch.zeros(
        num_samples, dtype=torch.float32, device=device)) for cid in ids}
    total = _canonical_sum([scores[c] for c in ids], num_samples, device)
    reg_cache = {cid: coordinates[cid].regularization_value_device(
        states[cid]) for cid in ids}

    history: list[CoordinateDescentState] = []
    best_model = best_metric = best_states = None
    if initial_best is not None:
        best_metric, best_states = initial_best
        best_model = publish_game_model(coordinates, best_states)
    # validation needs the committed model after every block, so it runs
    # the blocks in order (nothing to overlap)
    validate = (validation_data is not None
                and validation_evaluator is not None)
    use_pipeline = pipeline_depth > 0 and not validate
    last_saved_step = None

    def save_snapshot(sweep: int, next_ci: int) -> None:
        """Persist the resume state as of "about to run coordinate
        ``next_ci`` of ``sweep``" (a finished sweep is the next sweep's
        coordinate 0) at step ``sweep * K + next_ci``."""
        nonlocal last_saved_step
        if next_ci >= len(ids):
            sweep, next_ci = sweep + 1, 0
        step = sweep * len(ids) + next_ci
        if step == last_saved_step:
            return
        payload = fetch_to_host({"states": states,
                                 "scores": {c: scores[c] for c in ids},
                                 "best_states": best_states})
        HOT_LOOP_STATS["snapshot_fetches"] += 1
        saved = _checkpoint_save_contained(checkpoint_manager, step, {
            "sweep": sweep,
            "coordinate_index": next_ci,
            "iteration": sweep,  # completed sweeps (the legacy field)
            "states": payload["states"],
            "scores": payload["scores"],
            "best_metric": (None if best_metric is None
                            else float(best_metric)),
            "best_states": payload["best_states"],
            "update_counts": {
                cid: int(coordinates[cid]._update_count) for cid in ids
                if hasattr(coordinates[cid], "_update_count")},
            "consecutive_failures": int(consecutive_failures),
            "coordinate_failures": dict(coordinate_failures),
            "quarantined": sorted(quarantined),
        }, log=log, emit=emit)
        if saved:  # a failed save is tried again at the next cadence point
            last_saved_step = step

    def snapshot_cadence_due(block, it: int) -> bool:
        """Does this RAW block cross a ``checkpoint_every_coordinates``
        point? One definition for the success path and every replay."""
        return (checkpoint_manager is not None
                and checkpoint_every_coordinates > 0
                and any((it * len(ids) + ci + 1)
                        % checkpoint_every_coordinates == 0
                        for ci, _ in block))

    def update_counts(block) -> dict:
        return {cid: getattr(coordinates[cid], "_update_count", None)
                for _, cid in block}

    def set_update_counts(block, counts: dict) -> None:
        for _, cid in block:
            if counts.get(cid) is not None:
                coordinates[cid]._update_count = counts[cid]

    def dispatch_update(block, it: int, attempt: int, base_total: Tensor,
                        overlay: dict, snapshot_due: bool = False,
                        snapshot_next_ci: int = 0) -> _InFlight:
        """Solve and score every member of ``block`` against
        ``base_total`` (``overlay`` holds the new score and penalty of a
        block not yet committed, which the speculative dispatch sees as
        committed), run the epilogue and start the host copy of its
        scalars; the read is :func:`fetch_update`. A fault in the middle
        of a multi-member block restores every member's update count
        before it propagates: the members replay as fresh attempts."""
        t_wall, t0 = time.time(), time.perf_counter()
        counts_before = update_counts(block)
        cands, trackers, new_scores, new_regs = {}, {}, {}, {}
        try:
            for ci, cid in block:
                coord = coordinates[cid]
                # the other coordinates' sum, from the block-start total
                partial = base_total - (overlay[cid][0] if cid in overlay
                                        else scores[cid])
                cand, tracker = coord.update(states[cid], partial)
                cand = fault_point("cd.update", tag=f"{it}.{ci}",
                                   arrays=cand)
                if attempt > 0:
                    cand = _damp_toward(states[cid], cand,
                                        recovery.damping ** attempt)
                cands[cid], trackers[cid] = cand, tracker
                new_scores[cid] = coord.score(cand)
                new_regs[cid] = coord.regularization_value_device(cand)

            def current(c, new, i, cache):
                if c in new:
                    return new[c]
                return overlay[c][i] if c in overlay else cache[c]

            (new_total, objective_d, train_loss_d, _reg_d, finite_d,
             state_finite_d) = epilogue(
                tuple(current(c, new_scores, 0, scores) for c in ids),
                tuple(current(c, new_regs, 1, reg_cache) for c in ids),
                tuple(leaf for _, cid in block
                      for leaf in _state_leaves(cands[cid])), labels,
                weights, offsets)
        except Exception:
            if len(block) > 1:
                set_update_counts(block, counts_before)
            raise
        host, ready = _start_host_copy(torch.stack([
            objective_d, train_loss_d, finite_d.to(objective_d.dtype),
            state_finite_d.to(objective_d.dtype)]))
        HOT_LOOP_STATS["update_dispatch_secs"] += time.perf_counter() - t0
        return _InFlight(
            it=it, block=list(block), attempt=attempt, cands=cands,
            trackers=trackers, new_scores=new_scores, new_regs=new_regs,
            new_total=new_total, host=host, ready=ready,
            update_counts_before=counts_before, snapshot_due=snapshot_due,
            snapshot_next_ci=snapshot_next_ci, t_wall=t_wall,
            t_dispatched=time.perf_counter())

    def fetch_update(p: _InFlight) -> tuple[float, float]:
        """THE read of a block: its four scalars. Raises
        :class:`CoordinateDivergenceError` (with a recovery policy) when a
        candidate or the objective is not finite."""
        t0 = time.perf_counter()
        if p.pipelined:
            HOT_LOOP_STATS["pipelined_resolves"] += 1
            HOT_LOOP_STATS["overlap_secs"] += max(0.0, t0 - p.t_dispatched)
        if p.ready is not None:
            p.ready.synchronize()
        objective, train_loss, finite, state_finite = p.host.tolist()
        HOT_LOOP_STATS["epilogue_wait_secs"] += time.perf_counter() - t0
        HOT_LOOP_STATS["epilogue_fetches"] += 1
        HOT_LOOP_STATS["updates"] += len(p.block)
        if recovery is not None and not finite:
            what = "state" if not state_finite else "objective"
            if len(p.block) == 1:
                raise CoordinateDivergenceError(
                    f"iter {p.it} coordinate {p.block[0][1]}: non-finite "
                    f"{what} (attempt {p.attempt})")
            raise CoordinateDivergenceError(
                f"iter {p.it} block {[cid for _, cid in p.block]}: "
                f"non-finite {what}")
        return objective, train_loss

    def commit_update(p: _InFlight, objective: float,
                      seconds: Optional[float] = None,
                      recovered_attempts: int = 0,
                      allow_snapshot: bool = True) -> None:
        """Install an accepted block, validate, record, snapshot on
        cadence (``allow_snapshot=False``: a member replayed inside a
        block leaves the snapshot to the block's boundary)."""
        nonlocal total, consecutive_failures
        nonlocal best_metric, best_model, best_states
        if recovered_attempts > 0:
            cid0 = p.block[0][1]
            emit(RecoveryEvent(action="recovered", coordinate_id=cid0,
                               iteration=p.it, attempts=recovered_attempts))
            log(lambda: f"iter {p.it} coordinate {cid0}: recovered after "
                f"{recovered_attempts} retry(ies)")
        consecutive_failures = 0
        for _, cid in p.block:
            states[cid] = p.cands[cid]
            scores[cid] = p.new_scores[cid]
            reg_cache[cid] = p.new_regs[cid]
        total = p.new_total
        dt = seconds if seconds is not None else time.time() - p.t_wall
        per = dt / len(p.block)
        for _, cid in p.block:
            log(lambda cid=cid: f"iter {p.it} coordinate {cid}: objective="
                f"{objective:.6f} ({per:.2f}s) — "
                f"{p.trackers[cid].summary()}")
        metrics = None
        if validate:
            model = publish_game_model(coordinates, states)
            metrics = validation_evaluator(
                model.score(validation_data, device=device))
            what = (f"coordinate {p.block[0][1]}" if len(p.block) == 1
                    else f"block {[cid for _, cid in p.block]}")
            log(lambda: f"iter {p.it} {what}: validation {metrics}")
            if validation_metric is not None:
                m = metrics[validation_metric]
                if best_metric is None or (
                        m > best_metric if higher_is_better
                        else m < best_metric):
                    best_metric, best_model = m, model
                    best_states = dict(states)
        for _, cid in p.block:
            history.append(CoordinateDescentState(
                iteration=p.it, coordinate_id=cid, objective=objective,
                seconds=per, tracker=p.trackers[cid],
                validation_metrics=metrics))
        if p.snapshot_due and allow_snapshot:
            save_snapshot(p.it, p.snapshot_next_ci)

    def run_member(ci: int, cid: str, it: int, first_error=None,
                   allow_snapshots: bool = True, snapshot_due=None,
                   snapshot_next_ci=None) -> None:
        """One guarded coordinate update, dispatched and read in turn: the
        retry / skip / abort / quarantine ladder. ``first_error`` is an
        attempt-0 failure the pipelined path already caught;
        ``allow_snapshots=False`` marks a member replayed inside a block
        (its snapshots wait for the block's boundary);
        ``snapshot_due``/``snapshot_next_ci`` are the RAW block's."""
        nonlocal consecutive_failures
        if snapshot_due is None:
            snapshot_due = snapshot_cadence_due([(ci, cid)], it)
        if snapshot_next_ci is None:
            snapshot_next_ci = ci + 1
        t0 = time.time()
        attempt = 0
        skipped = budgeted_skip = quarantine_now = False
        outcome = None
        error = first_error
        while True:
            if error is None:
                try:
                    p = dispatch_update([(ci, cid)], it, attempt, total, {},
                                        snapshot_due=snapshot_due,
                                        snapshot_next_ci=snapshot_next_ci)
                    outcome = (p, fetch_update(p)[0])
                    break
                except (InjectedFault, CoordinateDivergenceError,
                        FloatingPointError) as e:
                    if recovery is None:
                        raise
                    error = e
                    continue
            e, error = error, None
            emit(FaultEvent(point=getattr(e, "point", "cd.update"),
                            coordinate_id=cid, iteration=it,
                            message=str(e)))
            log(lambda: f"iter {it} coordinate {cid}: FAULT "
                f"(attempt {attempt}): {e}")
            attempt += 1
            if attempt <= recovery.max_retries:
                emit(RecoveryEvent(action="retried", coordinate_id=cid,
                                   iteration=it, attempts=attempt))
                continue
            if recovery.quarantine_after > 0:
                # the coordinate's own budget: skipped until it runs out,
                # then frozen; such skips do not count toward the global
                # consecutive-failure abort
                coordinate_failures[cid] = coordinate_failures.get(cid,
                                                                   0) + 1
                if coordinate_failures[cid] >= recovery.quarantine_after:
                    quarantine_now = True
                else:
                    skipped = budgeted_skip = True
                break
            if recovery.on_exhausted == "skip":
                skipped = True
                break
            raise RuntimeError(
                f"coordinate descent aborted: coordinate {cid} failed "
                f"{attempt} attempt(s) at iteration {it} (RecoveryPolicy "
                f"on_exhausted='abort')") from e
        dt = time.time() - t0
        if quarantine_now:
            quarantined.add(cid)
            emit(CoordinateQuarantinedEvent(
                coordinate_id=cid, iteration=it,
                failures=coordinate_failures[cid],
                message=(f"{coordinate_failures[cid]} exhausted update(s); "
                         f"frozen at last-good state")))
            log(lambda: f"iter {it} coordinate {cid}: QUARANTINED after "
                f"{coordinate_failures[cid]} exhausted update(s) — frozen "
                f"at last-good state, descent continues ({dt:.2f}s)")
            if checkpoint_manager is not None and allow_snapshots:
                save_snapshot(it, snapshot_next_ci)
            return
        if skipped:
            if not budgeted_skip:
                consecutive_failures += 1
            emit(RecoveryEvent(action="skipped", coordinate_id=cid,
                               iteration=it, attempts=attempt))
            log(lambda: f"iter {it} coordinate {cid}: SKIPPED after "
                f"{attempt} failed attempt(s) — keeping last-good state "
                f"({dt:.2f}s)")
            if (not budgeted_skip and consecutive_failures
                    >= recovery.max_consecutive_failures):
                emit(RecoveryEvent(action="aborted", coordinate_id=cid,
                                   iteration=it, attempts=attempt))
                raise RuntimeError(
                    f"coordinate descent aborted: {consecutive_failures} "
                    f"consecutive coordinate updates failed (RecoveryPolicy "
                    f"max_consecutive_failures="
                    f"{recovery.max_consecutive_failures})")
            return
        p, objective = outcome
        commit_update(p, objective, seconds=dt, recovered_attempts=attempt,
                      allow_snapshot=allow_snapshots)

    def replay_block_members(block, it: int, due_snapshot: bool,
                             next_ci: int) -> None:
        """Each member through its own ladder, snapshots deferred; then
        one snapshot at the RAW block boundary if the block crossed a
        cadence point or the replay quarantined a member."""
        q_before = len(quarantined)
        for ci, cid in block:
            if cid not in quarantined:
                run_member(ci, cid, it, allow_snapshots=False)
        if (checkpoint_manager is not None
                and (due_snapshot or len(quarantined) > q_before)):
            save_snapshot(it, next_ci)

    def resolve_update(p: _InFlight, speculative=None) -> bool:
        """Read and commit one in-flight block, or on a divergence drop
        into the ladder from the last-good state. True iff it committed as
        dispatched (a speculative successor is then still valid).
        ``speculative`` is that successor: on failure it is rolled back
        FIRST, so no snapshot of the ladder holds its update counts."""
        try:
            objective, _ = fetch_update(p)
            commit_update(p, objective)
            return True
        except (CoordinateDivergenceError, FloatingPointError) as e:
            if recovery is None:
                raise
            if speculative is not None:
                set_update_counts(speculative.block,
                                  speculative.update_counts_before)
            if len(p.block) == 1:
                # the failed read WAS this coordinate's attempt 0
                ci, cid = p.block[0]
                run_member(ci, cid, p.it, first_error=e,
                           snapshot_due=p.snapshot_due,
                           snapshot_next_ci=p.snapshot_next_ci)
            else:
                # the flag covers the whole block: discard it and replay
                # its members one at a time from the committed state
                emit(FaultEvent(point="cd.block", iteration=p.it,
                                message=str(e)))
                log(lambda: f"iter {p.it}: block "
                    f"{[cid for _, cid in p.block]} FAULT — replaying "
                    f"members sequentially: {e}")
                set_update_counts(p.block, p.update_counts_before)
                replay_block_members(p.block, p.it, p.snapshot_due,
                                     p.snapshot_next_ci)
            return False

    def run_block(raw_block, it: int, first_error=None) -> None:
        """One RAW block dispatched and read in turn: the unpipelined
        path, and where a pipelined failure lands. Quarantined members
        are left out, but the snapshot boundary and cadence stay the RAW
        block's, so a resume cuts the sweep into the same blocks."""
        block = [(ci, cid) for ci, cid in raw_block
                 if cid not in quarantined]
        if not block:
            return
        due = snapshot_cadence_due(raw_block, it)
        next_ci = raw_block[-1][0] + 1
        if first_error is None:
            try:
                p = dispatch_update(block, it, 0, total, {},
                                    snapshot_due=due,
                                    snapshot_next_ci=next_ci)
            except (InjectedFault, FloatingPointError) as e:
                if recovery is None:
                    raise
                first_error = e
            else:
                resolve_update(p)
                return
        if len(block) > 1:
            emit(FaultEvent(point="cd.block", iteration=it,
                            message=str(first_error)))
            log(lambda: f"iter {it}: block {[cid for _, cid in block]} "
                f"FAULT at dispatch — replaying members sequentially: "
                f"{first_error}")
            replay_block_members(block, it, due, next_ci)
        else:
            run_member(block[0][0], block[0][1], it,
                       first_error=first_error, snapshot_due=due,
                       snapshot_next_ci=next_ci)

    for it in range(start_iteration, num_iterations):
        fault_point("cd.sweep", tag=str(it))
        sweep_start = len(history)
        eligible = [(ci, cid) for ci, cid in enumerate(ids)
                    if not (it == start_iteration and ci < start_coordinate)]
        blocks = [eligible[i:i + block_size]
                  for i in range(0, len(eligible), block_size)]
        pending: Optional[_InFlight] = None
        for raw_block in blocks:
            if stop is not None:
                reason = stop.should_stop()
                if reason is not None:
                    # the commit barrier: settle the in-flight block, then
                    # snapshot "about to run this block" and hand the
                    # resume point to the caller
                    if pending is not None:
                        resolve_update(pending)
                        pending = None
                    if checkpoint_manager is not None:
                        save_snapshot(it, raw_block[0][0])
                    raise PreemptionRequested(reason, it, raw_block[0][0])
            block = [(ci, cid) for ci, cid in raw_block
                     if cid not in quarantined]
            if not block:
                continue
            if not use_pipeline:
                run_block(raw_block, it)
                continue
            if pending is not None and pending.snapshot_due:
                # a snapshot never races a speculative successor
                resolve_update(pending)
                pending = None
            if pending is not None:
                base_total = pending.new_total
                overlay = {cid: (pending.new_scores[cid],
                                 pending.new_regs[cid])
                           for _, cid in pending.block}
            else:
                base_total, overlay = total, {}
            counts0 = update_counts(block)
            try:
                cur = dispatch_update(
                    block, it, 0, base_total, overlay,
                    snapshot_due=snapshot_cadence_due(raw_block, it),
                    snapshot_next_ci=raw_block[-1][0] + 1)
            except (InjectedFault, CoordinateDivergenceError,
                    FloatingPointError) as e:
                # the dispatch failed: settle the pending block first, as
                # the sequential order would, with this block's update
                # counts as they were before it (a snapshot of pending's
                # ladder is "about to run this block"), then walk this
                # block through the ladder, which owns the failed
                # dispatch's advance as its attempt 0
                if pending is not None:
                    pending.pipelined = True
                    counts_adv = update_counts(block)
                    set_update_counts(block, counts0)
                    resolve_update(pending)
                    pending = None
                    set_update_counts(block, counts_adv)
                if recovery is None:
                    raise
                run_block(raw_block, it, first_error=e)
                continue
            inflight = len(cur.block) + (len(pending.block)
                                         if pending is not None else 0)
            HOT_LOOP_STATS["max_inflight"] = max(
                HOT_LOOP_STATS["max_inflight"], inflight)
            if pending is not None:
                pending.pipelined = True
                ok = resolve_update(pending, speculative=cur)
                pending = None
                if not ok:
                    # the commit differs from what ``cur`` speculated on
                    # (already rolled back): run it again from there
                    run_block(raw_block, it)
                    continue
            pending = cur
        if pending is not None:
            # sweep drain: the last block commits before the sweep ends
            resolve_update(pending)
        # sweep boundary: drain this sweep's lazy trackers
        for h in history[sweep_start:]:
            h.tracker.materialize()
        if checkpoint_manager is not None:
            save_snapshot(it, len(ids))

    return CoordinateDescentResult(
        model=publish_game_model(coordinates, states), states=history,
        best_model=best_model, best_metric=best_metric,
        quarantined=sorted(quarantined))
