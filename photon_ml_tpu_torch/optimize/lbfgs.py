"""L-BFGS, lane-batched.

Port of ``photon_ml_tpu/optimize/lbfgs.py:108-354`` (``two_loop_direction``
and ``minimize_lbfgs``). The JAX solver is a single-lane ``lax.while_loop``
that the random effect ``vmap``s over entities; ``torch.func.vmap`` cannot
batch a data-dependent loop, so the port is written for ``L`` lanes:
``x [L, D]``, curvature pairs ``S/Y [L, m, D]``, a per-lane active mask, and
a ``RunHistory`` of ``[L, max_iter + 1]``. A lane whose convergence test
fails is frozen (its state is kept by masked updates), exactly as the
batched ``while_loop`` keeps a finished lane's carry, so every lane's
numbers are those of an independent run. The loop ends when no lane is
active; that test is one host read per iteration (counted in
``optimize.common.SOLVER_SYNCS``). The fixed effect is the one-lane case.

Left for later slices: ``resume``/``return_carry``, box constraints,
iterate tracking and the sharded weight update.
"""

from __future__ import annotations

from typing import Callable

import torch

from photon_ml_tpu_torch.optimize.common import (
    RunHistory,
    finite_step,
    host_flags,
    should_continue,
)
from photon_ml_tpu_torch.optimize.linesearch import strong_wolfe

Tensor = torch.Tensor

DEFAULT_MAX_ITER = 100
DEFAULT_M = 10
DEFAULT_TOLERANCE = 1e-7


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _norm(a: Tensor) -> Tensor:
    return torch.sqrt((a * a).sum(-1))


def two_loop_direction(g: Tensor, S: Tensor, Y: Tensor, rho: Tensor,
                       valid: Tensor, head: Tensor) -> Tensor:
    """Two-loop recursion over each lane's masked circular history
    (``lbfgs.py:108-147``). ``g [L, D]``, ``S/Y [L, m, D]``,
    ``rho/valid [L, m]``, ``head [L]``."""
    L, m, _ = S.shape
    lanes = torch.arange(L, device=g.device)
    slots = torch.arange(m, device=g.device)
    idx = (head[:, None] - 1 - slots[None, :]) % m  # newest -> oldest

    q = g
    alphas = []
    for k in range(m):
        i = idx[:, k]
        a_i = torch.where(valid[lanes, i],
                          rho[lanes, i] * _dot(S[lanes, i], q),
                          torch.zeros_like(q[:, 0]))
        q = q - a_i[:, None] * Y[lanes, i]
        alphas.append(a_i)

    newest = (head - 1) % m
    s_n, y_n = S[lanes, newest], Y[lanes, newest]
    sy, yy = _dot(s_n, y_n), _dot(y_n, y_n)
    gamma = torch.where(valid[lanes, newest] & (yy > 0),
                        sy / torch.clamp(yy, min=1e-300),
                        torch.ones_like(sy))
    r = gamma[:, None] * q

    for k in reversed(range(m)):
        i = idx[:, k]
        beta = torch.where(valid[lanes, i],
                           rho[lanes, i] * _dot(Y[lanes, i], r),
                           torch.zeros_like(r[:, 0]))
        r = r + S[lanes, i] * (alphas[k] - beta)[:, None]
    return -r


def store_pair(S: Tensor, Y: Tensor, rho: Tensor, valid: Tensor,
               head: Tensor, s: Tensor, y: Tensor, sy: Tensor,
               store: Tensor):
    """Write the pair ``(s, y)`` into each ``store`` lane's history slot
    ``head`` and advance its head; other lanes keep theirs."""
    lanes = torch.arange(S.shape[0], device=S.device)
    S_new, Y_new = S.clone(), Y.clone()
    S_new[lanes, head] = s
    Y_new[lanes, head] = y
    S = torch.where(store[:, None, None], S_new, S)
    Y = torch.where(store[:, None, None], Y_new, Y)
    rho_new = rho.clone()
    rho_new[lanes, head] = 1.0 / torch.clamp(sy, min=1e-300)
    rho = torch.where(store[:, None], rho_new, rho)
    valid_new = valid.clone()
    valid_new[lanes, head] = True
    valid = torch.where(store[:, None], valid_new, valid)
    head = torch.where(store, (head + 1) % S.shape[1], head)
    return S, Y, rho, valid, head


def minimize_lbfgs(
    value_and_grad_fn: Callable[[Tensor, object], tuple[Tensor, Tensor]],
    x0: Tensor,
    data=None,
    max_iter: int = DEFAULT_MAX_ITER,
    m: int = DEFAULT_M,
    tolerance: float = DEFAULT_TOLERANCE,
) -> tuple[Tensor, RunHistory, Tensor]:
    """Minimize ``f(x, data)`` independently in every lane of ``x0 [L, D]``.

    ``value_and_grad_fn(x [L, D], data)`` returns ``(f [L], g [L, D])``.
    Returns ``(x [L, D], RunHistory, made_progress [L])``.
    """
    L, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    f, g = value_and_grad_fn(x0, data)
    f0, g0n = f, _norm(g)
    x = x0
    prev_f = f + torch.full_like(f, float("inf"))
    S = torch.zeros((L, m, d), dtype=dtype, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((L, m), dtype=dtype, device=dev)
    valid = torch.zeros((L, m), dtype=torch.bool, device=dev)
    head = torch.zeros(L, dtype=torch.int64, device=dev)
    it = torch.zeros(L, dtype=torch.int64, device=dev)
    made_progress = torch.ones(L, dtype=torch.bool, device=dev)
    values = torch.full((L, max_iter + 1), float("nan"), dtype=f.dtype,
                        device=dev)
    grad_norms = torch.full_like(values, float("nan"))
    values[:, 0] = f
    grad_norms[:, 0] = g0n

    while True:
        active = should_continue(it, f, prev_f, _norm(g), f0, g0n,
                                 max_iter, tolerance, made_progress)
        (any_active,) = host_flags(active.any())
        if not any_active:
            break

        direction = two_loop_direction(g, S, Y, rho, valid, head)
        dphi0 = _dot(g, direction)
        # not a descent direction -> steepest descent
        bad = dphi0 >= 0.0
        direction = torch.where(bad[:, None], -g, direction)
        dphi0 = torch.where(bad, -_dot(g, g), dphi0)

        def phi(a, x=x, direction=direction):
            f_a, g_a = value_and_grad_fn(x + a[:, None] * direction, data)
            return f_a, _dot(g_a, direction), g_a

        # Breeze convention: the first iteration starts at 1/||d||, then 1.
        init_alpha = torch.where(
            it == 0, 1.0 / torch.clamp(_norm(direction), min=1.0),
            torch.ones_like(dphi0))
        ls = strong_wolfe(phi, f, dphi0, g, init_alpha, active)

        x_new = x + ls.alpha[:, None] * direction
        f_new, g_new = ls.value, ls.grad
        ok = finite_step(ls.ok, f_new, g_new)

        s = x_new - x
        y = g_new - g
        sy = _dot(s, y)
        S, Y, rho, valid, head = store_pair(S, Y, rho, valid, head, s, y,
                                            sy, active & ok & (sy > 1e-10))

        it_new = it + 1
        f_acc = torch.where(ok, f_new, f)
        g_acc = torch.where(ok[:, None], g_new, g)
        slot = torch.clamp(it_new, max=max_iter)[:, None]
        values = torch.where(active[:, None],
                             values.scatter(1, slot, f_acc[:, None]), values)
        grad_norms = torch.where(
            active[:, None],
            grad_norms.scatter(1, slot, _norm(g_acc)[:, None]), grad_norms)

        a2 = active[:, None]
        x = torch.where(a2, torch.where(ok[:, None], x_new, x), x)
        prev_f = torch.where(active, f, prev_f)
        f = torch.where(active, f_acc, f)
        g = torch.where(a2, g_acc, g)
        made_progress = torch.where(active, ok, made_progress)
        it = torch.where(active, it_new, it)

    return x, RunHistory(values, grad_norms, it), made_progress
