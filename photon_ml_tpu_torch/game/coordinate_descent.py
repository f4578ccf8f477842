"""Coordinate descent: the GAME outer loop, sequential, with checkpoints,
resume, divergence recovery and graceful stop.

Port of ``photon_ml_tpu/game/coordinate_descent.py`` — ``_canonical_sum``
(``:189-196``), ``make_update_epilogue`` (``:208-261``),
``RecoveryPolicy`` (``:265-320``), ``CoordinateDivergenceError``
(``:86``), ``_damp_toward`` (``:337``), ``_checkpoint_save_contained``
(``:391``), ``CoordinateDescentState``/``Result`` (``:361-389``),
``run_coordinate_descent`` (``:412-1256``) with ``pipeline_depth=0`` and
``block_size=1`` — resume (``:534-595``), per-update validation and the
best model (``:863-883``), ``save_snapshot`` (``:622-662``) and its
cadence (``:664``), the sequential retry / skip / abort / quarantine
ladder (``run_member``, ``:891-1018``), the stop poll at the commit
barrier (``:1141-1156``), the ``cd.update`` and ``cd.sweep`` fault points —
and ``publish_game_model`` (``:1258-1261``).

Per (sweep, coordinate in ids order): the other coordinates' scores are
injected as offsets, the coordinate re-solves, re-scores, and ONE fused
epilogue computes the canonical score total (summed from zero in ids
order), the training loss, the summed regularization, the objective and
the finiteness flags; its small outputs come back in ONE host fetch per
update (``HOT_LOOP_STATS``), from which recovery also reads the flags.
The solvers' own loop-exit reads are counted in
``optimize.common.SOLVER_SYNCS``.

A snapshot holds everything a bit-exact resume needs, under the JAX
package's keys: ``sweep``, ``coordinate_index``, ``iteration``, per
coordinate ``states`` AND ``scores``, ``best_metric``, ``best_states``,
``update_counts``, ``consecutive_failures``, ``coordinate_failures`` and
``quarantined``. Its step is the global update count ``sweep·K + next``.
The payload leaves the card in one copy (counted as
``HOT_LOOP_STATS["snapshot_fetches"]``). On resume the scores come back
verbatim and the total is summed again in ids order by the same function
the epilogue uses, so the resumed run sees the floats the uninterrupted
one saw. Pipelined and block sweeps wait for a later slice; asking for
them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

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

#: Hot-loop telemetry: updates run, blocking epilogue fetches taken, and
#: snapshot payload fetches (one per snapshot written).
HOT_LOOP_STATS = {"updates": 0, "epilogue_fetches": 0,
                  "snapshot_fetches": 0}


def reset_hot_loop_stats() -> None:
    HOT_LOOP_STATS.update({"updates": 0, "epilogue_fetches": 0,
                           "snapshot_fetches": 0})


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


def _damp_toward(good: Tensor, candidate: Tensor, factor: float) -> Tensor:
    """last_good + factor * (candidate - last_good)."""
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
    """``{name: {cid: f32 tensor} | None}`` -> the same with numpy arrays,
    in ONE device-to-host copy: the leaves are flattened into one tensor on
    their device, copied once, and cut back into their shapes."""
    leaves = [(name, cid, t) for name, group in groups.items()
              if group is not None for cid, t in group.items()]
    for name, cid, t in leaves:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}[{cid}] is {t.dtype}, not float32")
    out = {name: (None if group is None else {})
           for name, group in groups.items()}
    if not leaves:
        return out
    flat = torch.cat([t.detach().reshape(-1) for _, _, t in leaves])
    host = flat.cpu().numpy()
    offset = 0
    for name, cid, t in leaves:
        n = t.numel()
        out[name][cid] = host[offset:offset + n].reshape(tuple(t.shape))
        offset += n
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
class _Update:
    """One accepted candidate update, fetched and ready to commit."""

    cand: Tensor
    tracker: Tracker
    new_score: Tensor
    new_reg: object
    new_total: Tensor
    objective: float


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
    pipeline_depth: int = 0,
    device="cuda",
) -> CoordinateDescentResult:
    """Run GAME coordinate descent over ``coordinates`` in dict order (the
    updating sequence) for ``num_iterations`` sweeps.

    ``labels/weights/offsets`` describe the training samples (sample-major,
    numpy or tensors; held as f32 on ``device``). ``initial_states`` warm
    starts coordinates (``convert.states_from_numpy`` carries states from
    the JAX package); a warm-started coordinate contributes its score from
    the first update on.

    With ``validation_data`` (a ``GameDataset``) and ``validation_evaluator``
    (device scores -> ``{metric: value}``) every update scores the
    published model on the validation data and records the metrics; the
    model that is best by ``validation_metric`` is kept as ``best_model``.

    With a ``checkpoint_manager`` a snapshot lands after every sweep and,
    with ``checkpoint_every_coordinates`` = N > 0, after every Nth update;
    ``resume_snapshot`` (a restored snapshot, of either package) continues
    from it. With a ``recovery`` policy a non-finite update or an injected
    fault walks the retry / skip / abort / quarantine ladder, announced on
    ``events``; without one it propagates. ``stop`` (anything with
    ``should_stop() -> str | None``) is polled before every update; when
    it returns a reason a final snapshot is written and
    :class:`~photon_ml_tpu_torch.utils.preempt.PreemptionRequested`
    carries the resume point.
    """
    device = resolve_device(device)
    if block_size != 1 or pipeline_depth != 0:
        raise NotImplementedError(
            "only the sequential sweep (block_size=1, pipeline_depth=0) is "
            "ported yet")

    def log(fn: Callable[[], str]):
        if logger is not None:
            logger(fn())

    emit = events.send_event if events is not None else (lambda e: None)

    def on_device(a) -> Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=device)

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
                            {cid: on_device(v)
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

    given = {cid: on_device(v) for cid, v in (initial_states or {}).items()}
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
    validate = (validation_data is not None
                and validation_evaluator is not None)
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

    def snapshot_cadence_due(ci: int, it: int) -> bool:
        return (checkpoint_manager is not None
                and checkpoint_every_coordinates > 0
                and (it * len(ids) + ci + 1)
                % checkpoint_every_coordinates == 0)

    def attempt_update(ci: int, cid: str, it: int, attempt: int) -> _Update:
        """Solve, score and run the epilogue for one candidate, then THE
        blocking read of the update: four scalars in one fetch. Raises
        :class:`CoordinateDivergenceError` (with a recovery policy) when
        the candidate or the objective is not finite."""
        coord = coordinates[cid]
        partial = total - scores[cid]  # sum of the other coordinates
        cand, tracker = coord.update(states[cid], partial)
        cand = fault_point("cd.update", tag=f"{it}.{ci}", arrays=cand)
        if attempt > 0:
            cand = _damp_toward(states[cid], cand,
                                recovery.damping ** attempt)
        new_score = coord.score(cand)
        new_reg = coord.regularization_value_device(cand)
        (new_total, objective_d, train_loss_d, _reg_d, finite_d,
         state_finite_d) = epilogue(
            tuple(new_score if c == cid else scores[c] for c in ids),
            tuple(new_reg if c == cid else reg_cache[c] for c in ids),
            (cand,), labels, weights, offsets)
        objective, _train_loss, finite, state_finite = torch.stack([
            objective_d, train_loss_d, finite_d.to(objective_d.dtype),
            state_finite_d.to(objective_d.dtype)]).tolist()
        HOT_LOOP_STATS["epilogue_fetches"] += 1
        HOT_LOOP_STATS["updates"] += 1
        if recovery is not None and not finite:
            what = "state" if not state_finite else "objective"
            raise CoordinateDivergenceError(
                f"iter {it} coordinate {cid}: non-finite {what} "
                f"(attempt {attempt})")
        return _Update(cand, tracker, new_score, new_reg, new_total,
                       objective)

    def commit_update(ci: int, cid: str, it: int, upd: _Update, dt: float,
                      recovered_attempts: int) -> None:
        """Install an accepted update, validate, record, snapshot on
        cadence."""
        nonlocal total, consecutive_failures
        nonlocal best_metric, best_model, best_states
        if recovered_attempts > 0:
            emit(RecoveryEvent(action="recovered", coordinate_id=cid,
                               iteration=it, attempts=recovered_attempts))
            log(lambda: f"iter {it} coordinate {cid}: recovered after "
                f"{recovered_attempts} retry(ies)")
        consecutive_failures = 0
        states[cid], scores[cid], reg_cache[cid] = upd.cand, \
            upd.new_score, upd.new_reg
        total = upd.new_total
        log(lambda: f"iter {it} coordinate {cid}: objective="
            f"{upd.objective:.6f} ({dt:.2f}s) — {upd.tracker.summary()}")
        metrics = None
        if validate:
            model = publish_game_model(coordinates, states)
            metrics = validation_evaluator(
                model.score(validation_data, device=device))
            log(lambda: f"iter {it} coordinate {cid}: validation {metrics}")
            if validation_metric is not None:
                m = metrics[validation_metric]
                if best_metric is None or (
                        m > best_metric if higher_is_better
                        else m < best_metric):
                    best_metric, best_model = m, model
                    best_states = dict(states)
        history.append(CoordinateDescentState(
            iteration=it, coordinate_id=cid, objective=upd.objective,
            seconds=dt, tracker=upd.tracker, validation_metrics=metrics))
        if snapshot_cadence_due(ci, it):
            save_snapshot(it, ci + 1)

    def run_member(ci: int, cid: str, it: int) -> None:
        """One guarded coordinate update: the retry / skip / abort /
        quarantine ladder."""
        nonlocal consecutive_failures
        t0 = time.time()
        attempt = 0
        skipped = budgeted_skip = quarantine_now = False
        while True:
            try:
                upd = attempt_update(ci, cid, it, attempt)
                break
            except (InjectedFault, CoordinateDivergenceError,
                    FloatingPointError) as e:
                if recovery is None:
                    raise
                error = e
            emit(FaultEvent(point=getattr(error, "point", "cd.update"),
                            coordinate_id=cid, iteration=it,
                            message=str(error)))
            log(lambda: f"iter {it} coordinate {cid}: FAULT "
                f"(attempt {attempt}): {error}")
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
                f"on_exhausted='abort')") from error
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
            if checkpoint_manager is not None:
                save_snapshot(it, ci + 1)
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
        commit_update(ci, cid, it, upd, dt, recovered_attempts=attempt)

    for it in range(start_iteration, num_iterations):
        fault_point("cd.sweep", tag=str(it))
        sweep_start = len(history)
        for ci, cid in enumerate(ids):
            if it == start_iteration and ci < start_coordinate:
                continue
            if stop is not None:
                reason = stop.should_stop()
                if reason is not None:
                    # the commit barrier: nothing of the previous update is
                    # in flight; snapshot "about to run (it, ci)" and hand
                    # the resume point to the caller
                    if checkpoint_manager is not None:
                        save_snapshot(it, ci)
                    raise PreemptionRequested(reason, it, ci)
            if cid in quarantined:
                continue
            run_member(ci, cid, it)
        # sweep boundary: drain this sweep's lazy trackers
        for h in history[sweep_start:]:
            h.tracker.materialize()
        if checkpoint_manager is not None:
            save_snapshot(it, len(ids))

    return CoordinateDescentResult(
        model=publish_game_model(coordinates, states), states=history,
        best_model=best_model, best_metric=best_metric,
        quarantined=sorted(quarantined))
