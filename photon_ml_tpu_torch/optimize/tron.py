"""TRON: trust-region Newton with truncated conjugate gradient, lane-batched.

Port of ``photon_ml_tpu/optimize/tron.py:61-318`` (``_truncated_cg``,
``TRONResume`` and ``minimize_tron``), written for ``L`` lanes as the
port's L-BFGS is (``optimize/lbfgs.py``): ``x [L, D]``, per-lane trust
regions and failure counts, masked carry updates. Under ``jax.vmap`` the
JAX loops keep a finished lane's carry and compute both branches of every
``lax.cond``; here each update is masked by the lane's outer and inner
activity and both branches are selected with ``torch.where``, so every
lane's numbers are those of an independent run.

- eta = (1e-4, 0.25, 0.75), sigma = (0.25, 0.5, 4.0); the region starts at
  ||g0|| and is tightened to min(delta, ||step||) while no step has been
  accepted (``it == 0``).
- CG: at most 20 iterations, tolerance 0.1 ||g||, backed up to the region's
  boundary when a step leaves it.
- A non-finite trial value counts as +inf in the region arithmetic and as
  an improvement failure; at most 5 failures in a row.

The outer loop reads "any lane active?" once an iteration, the CG loop
once a step: a lane whose residual met the tolerance leaves before the
step's Hessian-vector product, as a converged CG exits in the JAX code, so
a step with no lane left costs no product. (20 masked steps with no read
give the same numbers and were measured slower on the H100; PERF.md.)
``return_carry``/``resume`` carry the loop state with its trust region
and failure count (:class:`TRONResume`), so a chunked solve equals the
single one bit for bit; a resumed chunk never re-tightens the region.
``box`` projects an accepted step and evaluates the objective again where
that moved it (``tron.py:268-276``), decided by one more counted read an
iteration as in the port's L-BFGS; ``track_iterates`` keeps the iterates
(row ``it`` the accepted point). The sharded weight update is left for a
later slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from photon_ml_tpu_torch.optimize.common import (
    BoxConstraints,
    RunHistory,
    finite_step,
    host_flags,
    should_continue,
)
from photon_ml_tpu_torch.optimize.lbfgs import (
    _dot,
    _norm,
    new_iterates,
    project_and_refresh,
    record_iterate,
)

Tensor = torch.Tensor

DEFAULT_MAX_ITER = 15
DEFAULT_TOLERANCE = 1e-5
DEFAULT_MAX_FAILURES = 5
MAX_CG_ITERATIONS = 20

_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0

#: Solver work since the last reset, counted on the host: outer iterations
#: (loop turns, one trial step for every active lane) and CG iterations
#: (steps of the lane-batched CG loop, each one Hessian-vector product
#: call that serves every lane still in CG).
TRON_STATS = {"outer_iterations": 0, "cg_iterations": 0}


class TRONResume(NamedTuple):
    """Per-lane loop state a chunk restart continues from
    (``tron.py:141-168``): the iterate, its value and gradient, the
    previous value, the trust region and the failure count, and the
    ORIGINAL dispatch's ``f0``/``g0n`` anchors; lane axis first."""

    x: Tensor  # [L, D]
    f: Tensor  # [L]
    g: Tensor  # [L, D]
    prev_f: Tensor  # [L]
    delta: Tensor  # [L]
    failures: Tensor  # [L] int64
    f0: Tensor  # [L]
    g0n: Tensor  # [L]


def reset_tron_stats() -> None:
    for k in TRON_STATS:
        TRON_STATS[k] = 0


def _truncated_cg(hvp: Callable[[Tensor], Tensor], gradient: Tensor,
                  delta: Tensor, active: Tensor
                  ) -> tuple[Tensor, Tensor]:
    """Approximately solve H s = -g within ||s|| <= delta, per lane
    (``tron.py:61-124``). ``hvp(v [L, D])`` computes H v for every lane;
    lanes with ``active`` false start finished. Returns (step [L, D],
    residual [L, D])."""
    tol = 0.1 * _norm(gradient)
    r = -gradient
    direction = r
    step = torch.zeros_like(gradient)
    r_tr = _dot(r, r)
    done = ~active
    for _ in range(MAX_CG_ITERATIONS):
        done = done | (_norm(r) <= tol)
        running = ~done
        if not host_flags(running.any())[0]:
            break
        hd = hvp(direction)
        TRON_STATS["cg_iterations"] += 1
        alpha = r_tr / _dot(direction, hd)
        step_in = step + alpha[:, None] * direction
        outside = _norm(step_in) > delta
        # back up to the boundary: ||step + t d|| = delta
        std = _dot(step, direction)
        sts = _dot(step, step)
        dtd = _dot(direction, direction)
        dsq = delta * delta
        rad = torch.sqrt(std * std + dtd * (dsq - sts))
        t = torch.where(std >= 0.0, (dsq - sts) / (std + rad),
                        (rad - std) / dtd)
        step_b = step + t[:, None] * direction
        r_b = r - t[:, None] * hd
        # interior: the CG update
        r_in = r - alpha[:, None] * hd
        r_tr_in = _dot(r_in, r_in)
        dir_in = r_in + (r_tr_in / r_tr)[:, None] * direction

        boundary = running & outside
        interior = running & ~outside
        b2, i2 = boundary[:, None], interior[:, None]
        step = torch.where(b2, step_b, torch.where(i2, step_in, step))
        r = torch.where(b2, r_b, torch.where(i2, r_in, r))
        direction = torch.where(i2, dir_in, direction)
        r_tr = torch.where(interior, r_tr_in, r_tr)
        done = done | boundary
    return step, r


def minimize_tron(
    value_and_grad_fn: Callable[[Tensor, object], tuple[Tensor, Tensor]],
    hvp_fn: Callable[[Tensor, Tensor, object], Tensor],
    x0: Tensor,
    data=None,
    max_iter: int = DEFAULT_MAX_ITER,
    tolerance: float = DEFAULT_TOLERANCE,
    max_failures: int = DEFAULT_MAX_FAILURES,
    resume: Optional[TRONResume] = None,
    return_carry: bool = False,
    box: Optional[BoxConstraints] = None,
    track_iterates: bool = False,
):
    """Trust-region Newton independently in every lane of ``x0 [L, D]``.

    ``value_and_grad_fn(x [L, D], data)`` returns ``(f [L], g [L, D])``;
    ``hvp_fn(x, v, data)`` the (Gauss-Newton) Hessian-vector products
    ``[L, D]``. Returns ``(x [L, D], RunHistory, made_progress [L])``; the
    history's iteration count counts accepted steps only. With
    ``return_carry`` the :class:`TRONResume` follows; ``resume`` continues
    from one (``x0`` is ignored). ``box`` and ``track_iterates`` are
    ``minimize_lbfgs``'s.
    """
    L, _ = x0.shape
    dev = x0.device
    if resume is None:
        f, g = value_and_grad_fn(x0, data)
        x = x0
        f0, g0n = f, _norm(g)
        prev_f = f + torch.full_like(f, float("inf"))
        delta = g0n
        failures = torch.zeros(L, dtype=torch.int64, device=dev)
    else:
        x, f, g, prev_f, delta, failures, f0, g0n = resume
    it = torch.zeros(L, dtype=torch.int64, device=dev)
    made_progress = torch.ones(L, dtype=torch.bool, device=dev)
    values = torch.full((L, max_iter + 1), float("nan"), dtype=f.dtype,
                        device=dev)
    grad_norms = torch.full_like(values, float("nan"))
    values[:, 0] = f
    grad_norms[:, 0] = _norm(g)
    iterates = new_iterates(x, max_iter, track_iterates)
    inf = torch.full_like(f, float("inf"))

    while True:
        active = should_continue(it, f, prev_f, _norm(g), f0, g0n,
                                 max_iter, tolerance, made_progress,
                                 resumed=resume is not None) \
            & (failures < max_failures)
        (any_active,) = host_flags(active.any())
        if not any_active:
            break
        TRON_STATS["outer_iterations"] += 1

        step, residual = _truncated_cg(
            lambda v, x=x: hvp_fn(x, v, data), g, delta, active)
        x_try = x + step
        gs = _dot(g, step)
        predicted = -0.5 * (gs - _dot(step, residual))
        f_try, g_try = value_and_grad_fn(x_try, data)
        # a non-finite trial value is infinitely bad for the region
        f_arith = torch.where(torch.isfinite(f_try), f_try, inf)
        actual = f - f_arith
        step_norm = _norm(step)
        # the first iteration tightens the region to the step's scale; a
        # resumed chunk carries its live region
        new_delta = (torch.where(it == 0, torch.minimum(delta, step_norm),
                                 delta) if resume is None else delta)
        # step-scale prediction alpha, then the region update
        denom = f_arith - f - gs
        alpha = torch.where(denom <= 0.0, torch.full_like(denom, _SIGMA3),
                            torch.clamp(-0.5 * (gs / denom), min=_SIGMA1))
        a_step = alpha * step_norm
        new_delta = torch.where(
            actual < _ETA0 * predicted,
            torch.minimum(torch.clamp(alpha, min=_SIGMA1) * step_norm,
                          _SIGMA2 * new_delta),
            torch.where(
                actual < _ETA1 * predicted,
                torch.maximum(_SIGMA1 * new_delta,
                              torch.minimum(a_step, _SIGMA2 * new_delta)),
                torch.where(
                    actual < _ETA2 * predicted,
                    torch.maximum(_SIGMA1 * new_delta,
                                  torch.minimum(a_step,
                                                _SIGMA3 * new_delta)),
                    torch.maximum(new_delta,
                                  torch.minimum(a_step,
                                                _SIGMA3 * new_delta)))))

        improved = active & finite_step(actual > _ETA0 * predicted, f_try,
                                        g_try)
        x_try, f_try, g_try = project_and_refresh(
            value_and_grad_fn, data, x_try, f_try, g_try, box, improved)
        i2 = improved[:, None]
        slot = torch.clamp(it + 1, max=max_iter)[:, None]
        values = torch.where(i2, values.scatter(1, slot, f_try[:, None]),
                             values)
        grad_norms = torch.where(
            i2, grad_norms.scatter(1, slot, _norm(g_try)[:, None]),
            grad_norms)
        x = torch.where(i2, x_try, x)
        iterates = record_iterate(iterates, slot[:, 0], x, improved)
        prev_f = torch.where(improved, f, prev_f)
        f = torch.where(improved, f_try, f)
        g = torch.where(i2, g_try, g)
        delta = torch.where(active, new_delta, delta)
        made_progress = torch.where(
            active, improved | (failures + 1 < max_failures), made_progress)
        failures = torch.where(
            active, torch.where(improved, torch.zeros_like(failures),
                                failures + 1), failures)
        it = torch.where(improved, it + 1, it)

    out = (x, RunHistory(values, grad_norms, it, iterates), made_progress)
    if return_carry:
        return out + (TRONResume(x, f, g, prev_f, delta, failures, f0, g0n),)
    return out
