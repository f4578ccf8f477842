"""Coordinate descent: the GAME outer loop, sequential.

Port of ``photon_ml_tpu/game/coordinate_descent.py`` — ``_canonical_sum``
(``:189-196``), ``make_update_epilogue`` (``:208-261``),
``CoordinateDescentState``/``Result`` (``:361-382``),
``run_coordinate_descent`` (``:412-``) with ``pipeline_depth=0`` and
``block_size=1`` and its per-update validation (``:606-617``, ``:863-883``:
score the published model on the validation data, evaluate, keep the best
model by the first metric), and ``publish_game_model`` (``:1258-1261``).

Per (sweep, coordinate in ids order): the other coordinates' scores are
injected as offsets, the coordinate re-solves, re-scores, and ONE fused
epilogue computes the canonical score total (summed from zero in ids order
— the order later slices' bit-exact resume depends on), the training loss,
the summed regularization, the objective and a finiteness flag; its small
outputs come back in ONE host fetch per update (``HOT_LOOP_STATS``). The
solvers' own loop-exit reads are counted in
``optimize.common.SOLVER_SYNCS``.

Checkpointing, ``RecoveryPolicy``, stop/preemption and pipelined and
block sweeps wait for later slices; passing them raises
``NotImplementedError``.
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

Tensor = torch.Tensor

#: Hot-loop telemetry: updates run and blocking epilogue fetches taken.
HOT_LOOP_STATS = {"updates": 0, "epilogue_fetches": 0}


def reset_hot_loop_stats() -> None:
    HOT_LOOP_STATS.update({"updates": 0, "epilogue_fetches": 0})


def _canonical_sum(score_list, num_samples: int, device) -> Tensor:
    """Sum of scores in updating-sequence order from zero."""
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


def publish_game_model(coordinates: dict, states: dict) -> GameModel:
    return GameModel({cid: coordinates[cid].publish(states[cid])
                      for cid in coordinates})


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
    recovery=None,
    resume_snapshot=None,
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
    """
    device = resolve_device(device)
    for name, value in (("checkpoint_manager", checkpoint_manager),
                        ("recovery", recovery),
                        ("resume_snapshot", resume_snapshot),
                        ("stop", stop)):
        if value is not None:
            raise NotImplementedError(f"{name} is not ported yet")
    if block_size != 1 or pipeline_depth != 0:
        raise NotImplementedError(
            "only the sequential sweep (block_size=1, pipeline_depth=0) is "
            "ported yet")

    def log(fn: Callable[[], str]):
        if logger is not None:
            logger(fn())

    def on_device(a) -> Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    labels, weights, offsets = on_device(labels), on_device(weights), \
        on_device(offsets)
    ids = list(coordinates)
    num_samples = coordinates[ids[0]].num_samples
    assert all(coordinates[c].num_samples == num_samples for c in ids), \
        "all coordinates must cover the same sample axis"
    epilogue = make_update_epilogue(task, num_samples)

    states = dict(initial_states or {})
    resumed = set(states)
    for cid in ids:
        if cid not in states:
            states[cid] = coordinates[cid].initial_state()
    scores = {cid: (coordinates[cid].score(states[cid]) if cid in resumed
                    else torch.zeros(num_samples, dtype=torch.float32,
                                     device=device))
              for cid in ids}
    total = _canonical_sum([scores[c] for c in ids], num_samples, device)
    reg_cache = {cid: coordinates[cid].regularization_value_device(
        states[cid]) for cid in ids}

    history: list[CoordinateDescentState] = []
    best_model = best_metric = None
    validate = (validation_data is not None
                and validation_evaluator is not None)
    for it in range(num_iterations):
        sweep_start = len(history)
        for cid in ids:
            t0 = time.time()
            coord = coordinates[cid]
            partial = total - scores[cid]  # sum of the other coordinates
            cand, tracker = coord.update(states[cid], partial)
            new_score = coord.score(cand)
            new_reg = coord.regularization_value_device(cand)
            (new_total, objective_d, train_loss_d, _reg_d, finite_d,
             state_finite_d) = epilogue(
                tuple(new_score if c == cid else scores[c] for c in ids),
                tuple(new_reg if c == cid else reg_cache[c] for c in ids),
                (cand,), labels, weights, offsets)
            # THE blocking read of this update: four scalars in one fetch
            objective, _train_loss, _finite, _state_finite = torch.stack([
                objective_d, train_loss_d, finite_d.to(objective_d.dtype),
                state_finite_d.to(objective_d.dtype)]).tolist()
            HOT_LOOP_STATS["epilogue_fetches"] += 1
            HOT_LOOP_STATS["updates"] += 1
            states[cid], scores[cid], reg_cache[cid] = cand, new_score, \
                new_reg
            total = new_total
            dt = time.time() - t0
            log(lambda: f"iter {it} coordinate {cid}: objective="
                f"{objective:.6f} ({dt:.2f}s) — {tracker.summary()}")
            metrics = None
            if validate:
                model = publish_game_model(coordinates, states)
                metrics = validation_evaluator(
                    model.score(validation_data, device=device))
                log(lambda: f"iter {it} coordinate {cid}: validation "
                    f"{metrics}")
                if validation_metric is not None:
                    m = metrics[validation_metric]
                    if best_metric is None or (
                            m > best_metric if higher_is_better
                            else m < best_metric):
                        best_metric, best_model = m, model
            history.append(CoordinateDescentState(
                iteration=it, coordinate_id=cid, objective=objective,
                seconds=dt, tracker=tracker, validation_metrics=metrics))
        # sweep boundary: drain this sweep's lazy trackers
        for h in history[sweep_start:]:
            h.tracker.materialize()

    return CoordinateDescentResult(
        model=publish_game_model(coordinates, states), states=history,
        best_model=best_model, best_metric=best_metric)
