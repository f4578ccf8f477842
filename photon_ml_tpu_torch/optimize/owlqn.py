"""OWL-QN (orthant-wise L-BFGS) for L1 objectives, lane-batched.

Port of ``photon_ml_tpu/optimize/owlqn.py:54-290`` (``pseudo_gradient`` and
``minimize_owlqn`` with ``resume``/``return_carry``), written for ``L``
lanes as the port's L-BFGS is (``optimize/lbfgs.py``): ``x [L, D]``, a
per-lane active mask, masked carry updates, so every lane's numbers are
those of an independent run.

- The direction is the L-BFGS two-loop direction of the pseudo-gradient
  over curvature pairs of the SMOOTH gradient, projected onto the orthant
  of -pg.
- The step's orthant is sign(x), or sign(-pg) where x is 0; trial points
  are projected onto it.
- The line search backtracks (halving, at most ``_LS_MAX_STEPS``) until
  ``F(x_a) <= F(x) + c1 pg . (x_a - x)``, each lane accepting on its own;
  the search ends when no lane is still searching, one counted host read
  per step (``optimize.common.SOLVER_SYNCS``), like the outer loop's.

- ``return_carry``/``resume`` take the L-BFGS carry
  (``optimize.lbfgs.LBFGSResume``: F, the smooth gradient and its
  curvature ring, and the first pseudo-gradient's norm as ``g0n``), so a
  chunked solve equals the single one bit for bit.

- ``box`` projects every trial point after the orthant projection
  (``owlqn.py:181-182``), so the search evaluates the projected points
  and no second evaluation is needed; ``track_iterates`` keeps the
  accepted iterates as the port's L-BFGS does.

- ``update_axis_name`` is the sharded weight update (``owlqn.py:92-116``):
  ``x``, ``g`` and ``l1`` are this shard's slices, the L1 penalty and
  every d-vector reduction are summed over the axis; the pseudo-gradient
  and the orthant projections stay elementwise. A box or
  ``track_iterates`` is refused with it, as in the JAX solver.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.optimize.common import (
    BoxConstraints,
    RunHistory,
    finite_step,
    host_flags,
    project_box,
    should_continue,
)
from photon_ml_tpu_torch.optimize.lbfgs import (
    LBFGSResume,
    axis_dot,
    axis_norm,
    new_iterates,
    record_iterate,
    refuse_sharded_extras,
    store_pair,
    two_loop_direction,
)
from photon_ml_tpu_torch.parallel.quantized_collectives import qpsum

Tensor = torch.Tensor

DEFAULT_MAX_ITER = 100
DEFAULT_M = 10
DEFAULT_TOLERANCE = 1e-7
_LS_MAX_STEPS = 30
_LS_C1 = 1e-4


def pseudo_gradient(x: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """Subgradient selection for F = f + l1 ||x||_1 (Andrew & Gao eq. 4,
    ``owlqn.py:54-59``)."""
    right = g + l1  # derivative approaching from x_j > 0
    left = g - l1  # from x_j < 0
    zero = torch.zeros_like(g)
    at_zero = torch.where(right < 0.0, right,
                          torch.where(left > 0.0, left, zero))
    return torch.where(x > 0.0, right, torch.where(x < 0.0, left, at_zero))


def minimize_owlqn(
    value_and_grad_fn: Callable[[Tensor, object], tuple[Tensor, Tensor]],
    x0: Tensor,
    data=None,
    l1=0.0,
    max_iter: int = DEFAULT_MAX_ITER,
    m: int = DEFAULT_M,
    tolerance: float = DEFAULT_TOLERANCE,
    resume: Optional[LBFGSResume] = None,
    return_carry: bool = False,
    box: Optional[BoxConstraints] = None,
    track_iterates: bool = False,
    update_axis_name: Optional[str] = None,
    collective_quant: str = "none",
):
    """Minimize ``f(x, data) + l1 ||x||_1`` independently in every lane of
    ``x0 [L, D]``.

    ``value_and_grad_fn(x [L, D], data)`` returns the SMOOTH part's
    ``(f [L], g [L, D])``; the L1 term is added here. ``l1`` is a scalar,
    ``[D]`` or ``[L, D]``. The history's values are F and its gradient
    norms those of the pseudo-gradient. Returns ``(x [L, D], RunHistory,
    made_progress [L])``, and the carry after them with ``return_carry``;
    ``resume`` continues from a carry as ``minimize_lbfgs`` does;
    ``box``, ``track_iterates`` and ``update_axis_name`` are
    ``minimize_lbfgs``'s.
    """
    refuse_sharded_extras(update_axis_name, box, track_iterates)
    _dot = axis_dot(update_axis_name, collective_quant)
    _norm = axis_norm(update_axis_name, collective_quant)
    L, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    l1 = torch.as_tensor(l1, dtype=dtype, device=dev).expand(L, d)
    # the L1 penalty sums d small terms: at least f32 (``owlqn.py:108-117``)
    pen_dtype = torch.promote_types(dtype, torch.float32)

    def full_objective(x):
        f, g = value_and_grad_fn(x, data)
        penalty = qpsum((l1 * x.abs()).sum(-1, dtype=pen_dtype),
                        update_axis_name, mode=collective_quant)
        return f + penalty, g

    if resume is None:
        f, g = full_objective(x0)
        x = x0
        pg = pseudo_gradient(x, g, l1)
        f0, g0n = f, _norm(pg)
        prev_f = f + torch.full_like(f, float("inf"))
        S = torch.zeros((L, m, d), dtype=dtype, device=dev)
        Y = torch.zeros_like(S)
        rho = torch.zeros((L, m), dtype=dtype, device=dev)
        valid = torch.zeros((L, m), dtype=torch.bool, device=dev)
        head = torch.zeros(L, dtype=torch.int64, device=dev)
    else:
        x, f, g, prev_f, S, Y, rho, valid, head, f0, g0n = resume
        pg = pseudo_gradient(x, g, l1)
    it = torch.zeros(L, dtype=torch.int64, device=dev)
    made_progress = torch.ones(L, dtype=torch.bool, device=dev)
    values = torch.full((L, max_iter + 1), float("nan"), dtype=f.dtype,
                        device=dev)
    grad_norms = torch.full_like(values, float("nan"))
    values[:, 0] = f
    grad_norms[:, 0] = _norm(pg)
    iterates = new_iterates(x, max_iter, track_iterates)

    while True:
        active = should_continue(it, f, prev_f, _norm(pg), f0, g0n,
                                 max_iter, tolerance, made_progress,
                                 resumed=resume is not None)
        (any_active,) = host_flags(active.any())
        if not any_active:
            break

        direction = two_loop_direction(pg, S, Y, rho, valid, head,
                                       update_axis_name, collective_quant)
        # keep only the components that descend along -pg
        direction = torch.where(direction * pg < 0.0, direction,
                                torch.zeros_like(direction))
        # the step's orthant: sign(x), or sign(-pg) where x is 0
        xi = torch.where(x != 0.0, torch.sign(x), torch.sign(-pg))
        # a resumed chunk is past its solve's first iteration
        first = it == 0 if resume is None else torch.zeros_like(active)
        a = torch.where(first,
                        1.0 / torch.clamp(_norm(direction), min=1.0),
                        torch.ones_like(f))

        # backtracking on orthant-projected points, per lane
        f_new, g_new, x_new = f, g, x
        accepted = torch.zeros_like(active)
        k = 0
        while True:
            searching = active & ~accepted
            if k >= _LS_MAX_STEPS or not host_flags(searching.any())[0]:
                break
            x_a = x + a[:, None] * direction
            x_a = project_box(
                torch.where(x_a * xi > 0.0, x_a, torch.zeros_like(x_a)), box)
            f_a, g_a = full_objective(x_a)
            ok = f_a <= f + _LS_C1 * _dot(pg, x_a - x)
            s2 = searching[:, None]
            f_new = torch.where(searching, f_a, f_new)
            g_new = torch.where(s2, g_a, g_new)
            x_new = torch.where(s2, x_a, x_new)
            accepted = torch.where(searching, ok, accepted)
            a = torch.where(searching & ~ok, a * 0.5, a)
            k += 1
        # non-finite trial values never enter the carry
        accepted = finite_step(accepted, f_new, g_new, update_axis_name)

        # curvature pairs from the smooth gradients
        s, y = x_new - x, g_new - g
        sy = _dot(s, y)
        S, Y, rho, valid, head = store_pair(
            S, Y, rho, valid, head, s, y, sy,
            active & accepted & (sy > 1e-10))

        it_new = it + 1
        pg_new = pseudo_gradient(x_new, g_new, l1)
        a1, a2 = active[:, None], (active & accepted)[:, None]
        slot = torch.clamp(it_new, max=max_iter)[:, None]
        f_acc = torch.where(accepted, f_new, f)
        values = torch.where(a1, values.scatter(1, slot, f_acc[:, None]),
                             values)
        pg_acc = torch.where(accepted[:, None], pg_new, pg)
        grad_norms = torch.where(
            a1, grad_norms.scatter(1, slot, _norm(pg_acc)[:, None]),
            grad_norms)
        x = torch.where(a2, x_new, x)
        iterates = record_iterate(iterates, slot[:, 0], x, active)
        g = torch.where(a2, g_new, g)
        pg = torch.where(a1, pg_acc, pg)
        prev_f = torch.where(active, f, prev_f)
        f = torch.where(active, f_acc, f)
        made_progress = torch.where(active, accepted, made_progress)
        it = torch.where(active, it_new, it)

    out = (x, RunHistory(values, grad_norms, it, iterates), made_progress)
    if return_carry:
        return out + (LBFGSResume(x, f, g, prev_f, S, Y, rho, valid, head,
                                  f0, g0n),)
    return out
