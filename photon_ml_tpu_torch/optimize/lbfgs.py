"""L-BFGS, lane-batched.

Port of ``photon_ml_tpu/optimize/lbfgs.py:60-354`` (``LBFGSResume``,
``two_loop_direction`` and ``minimize_lbfgs``). The JAX solver is a
single-lane ``lax.while_loop`` that the random effect ``vmap``s over
entities; ``torch.func.vmap`` cannot batch a data-dependent loop, so the
port is written for ``L`` lanes: ``x [L, D]``, curvature pairs
``S/Y [L, m, D]``, a per-lane active mask, and a ``RunHistory`` of
``[L, max_iter + 1]``. A lane whose convergence test fails is frozen (its
state is kept by masked updates), exactly as the batched ``while_loop``
keeps a finished lane's carry, so every lane's numbers are those of an
independent run. The loop ends when no lane is active; that test is one
host read per iteration (counted in ``optimize.common.SOLVER_SYNCS``).
The fixed effect is the one-lane case.

``return_carry=True`` also returns an :class:`LBFGSResume`, the loop's
state per lane; passed back as ``resume=`` it continues the solve as if
it had never stopped (the lane-compaction driver's chunk restarts), so
``a`` iterations then ``b`` resumed ones equal one solve of ``a + b`` bit
for bit.

``box`` projects each accepted step onto the hypercube
(``lbfgs.py:259-265``): where the projection moved a lane's point, the
objective is evaluated again there. JAX decides that per lane with a
``jnp.any`` inside its loop; here "did the projection move any lane?" is
one more counted host read per iteration (only with a box), and an
iteration where it moved none costs no evaluation. Evaluating every time
and selecting per lane would give the same bits (an unmoved point
evaluates the same) at the price of one more kernel launch per
iteration. ``track_iterates`` keeps ``[L, max_iter + 1, D]`` iterates in
the history, row ``it`` the accepted iterate (``lbfgs.py:211``,
``:289``).

``update_axis_name`` is the sharded weight update (arXiv 2004.13336,
``lbfgs.py:85-105``): ``x``, ``g`` and the curvature pairs are this
shard's slice of the coefficient vector, and every d-vector reduction
(:func:`axis_dot`, :func:`axis_norm`, the finite-step verdict) is summed
over the axis's shards, so the sharded recursion is the full-dimension
one up to reduction order. It refuses a box and ``track_iterates``, as
the JAX solver does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from photon_ml_tpu_torch.optimize.common import (
    BoxConstraints,
    RunHistory,
    finite_step,
    host_flags,
    project_box,
    should_continue,
)
from photon_ml_tpu_torch.optimize.linesearch import strong_wolfe
from photon_ml_tpu_torch.parallel.quantized_collectives import qpsum

Tensor = torch.Tensor

DEFAULT_MAX_ITER = 100
DEFAULT_M = 10
DEFAULT_TOLERANCE = 1e-7


class LBFGSResume(NamedTuple):
    """Per-lane loop state a chunk restart continues from
    (``lbfgs.py:60-83``): the iterate, its value and gradient, the
    previous value, the curvature ring, and the ORIGINAL dispatch's
    ``f0``/``g0n`` anchors, so the relative tolerances never re-anchor.
    OWL-QN's carry has the same fields (``f`` is then F, ``g`` the smooth
    gradient, ``g0n`` the first pseudo-gradient's norm). Every field has
    the lane axis first, so a compacted restart gathers its lanes."""

    x: Tensor  # [L, D]
    f: Tensor  # [L]
    g: Tensor  # [L, D]
    prev_f: Tensor  # [L]
    S: Tensor  # [L, m, D]
    Y: Tensor  # [L, m, D]
    rho: Tensor  # [L, m]
    valid: Tensor  # [L, m] bool
    head: Tensor  # [L] int64
    f0: Tensor  # [L]
    g0n: Tensor  # [L]


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _norm(a: Tensor) -> Tensor:
    return torch.sqrt((a * a).sum(-1))


def axis_dot(axis_name: Optional[str], collective_quant: str = "none"):
    """The lanes' dot product, summed over ``axis_name``'s shards when the
    vectors are slices of a sharded weight update (``lbfgs.py:85-98``);
    the payload is one value per lane, which ``qpsum`` ships plain."""
    if axis_name is None:
        return _dot
    return lambda a, b: qpsum(_dot(a, b), axis_name, mode=collective_quant)


def axis_norm(axis_name: Optional[str], collective_quant: str = "none"):
    """The lanes' 2-norm, summed over ``axis_name`` (see :func:`axis_dot`)."""
    if axis_name is None:
        return _norm
    return lambda a: torch.sqrt(qpsum((a * a).sum(-1), axis_name,
                                      mode=collective_quant))


def refuse_sharded_extras(update_axis_name: Optional[str], box,
                          track_iterates: bool) -> None:
    """The sharded weight update takes neither a box nor
    ``track_iterates`` (``lbfgs.py:170-174``)."""
    if update_axis_name is not None and (box is not None or track_iterates):
        raise ValueError(
            "sharded weight update supports neither box constraints nor "
            "track_iterates")


def two_loop_direction(g: Tensor, S: Tensor, Y: Tensor, rho: Tensor,
                       valid: Tensor, head: Tensor,
                       axis_name: Optional[str] = None,
                       collective_quant: str = "none") -> Tensor:
    """Two-loop recursion over each lane's masked circular history
    (``lbfgs.py:108-147``). ``g [L, D]``, ``S/Y [L, m, D]``,
    ``rho/valid [L, m]``, ``head [L]``; with ``axis_name`` the vectors are
    shards and every inner product is summed over the axis."""
    _dot = axis_dot(axis_name, collective_quant)
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


def new_iterates(x: Tensor, max_iter: int, track: bool
                 ) -> Optional[Tensor]:
    """``[L, max_iter + 1, D]`` iterate rows, row 0 the start ``x``; None
    when not tracking."""
    if not track:
        return None
    its = x.new_zeros((x.shape[0], max_iter + 1, x.shape[1]))
    its[:, 0] = x
    return its


def record_iterate(iterates: Optional[Tensor], slot: Tensor, x: Tensor,
                   write: Tensor) -> Optional[Tensor]:
    """Row ``slot [L]`` of each ``write`` lane's iterates set to ``x``."""
    if iterates is None:
        return None
    lanes = torch.arange(x.shape[0], device=x.device)
    out = iterates.clone()
    out[lanes, slot] = x
    return torch.where(write[:, None, None], out, iterates)


def project_and_refresh(value_and_grad_fn, data, x_new: Tensor,
                        f_new: Tensor, g_new: Tensor,
                        box: Optional[BoxConstraints], lanes: Tensor):
    """``x_new`` projected onto ``box``, with the objective evaluated again
    at the lanes of ``lanes`` the projection moved (``lbfgs.py:259-265``,
    ``tron.py:274-276``); one counted host read decides whether any did."""
    if box is None:
        return x_new, f_new, g_new
    x_proj = project_box(x_new, box)
    moved = lanes & (x_proj != x_new).any(-1)
    if host_flags(moved.any())[0]:
        f_p, g_p = value_and_grad_fn(x_proj, data)
        f_new = torch.where(moved, f_p, f_new)
        g_new = torch.where(moved[:, None], g_p, g_new)
    return x_proj, f_new, g_new


def minimize_lbfgs(
    value_and_grad_fn: Callable[[Tensor, object], tuple[Tensor, Tensor]],
    x0: Tensor,
    data=None,
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
    """Minimize ``f(x, data)`` independently in every lane of ``x0 [L, D]``.

    ``value_and_grad_fn(x [L, D], data)`` returns ``(f [L], g [L, D])``.
    Returns ``(x [L, D], RunHistory, made_progress [L])``, and the
    :class:`LBFGSResume` carry after them with ``return_carry``. With
    ``resume`` the solve continues from that carry (``x0`` is ignored):
    the history and the iteration count restart at 0, every convergence
    check keeps the carried anchors, and the first step is not the
    1/||d|| start of a fresh solve. ``box`` (bounds ``[D]``) projects
    every accepted step; ``track_iterates`` adds the iterates to the
    history. ``update_axis_name`` makes ``x0`` this shard's slice of a
    sharded weight update (``value_and_grad_fn`` then takes and returns
    slices) and sums every d-vector reduction over the axis with the
    ``collective_quant`` wire format.
    """
    refuse_sharded_extras(update_axis_name, box, track_iterates)
    _dot = axis_dot(update_axis_name, collective_quant)
    _norm = axis_norm(update_axis_name, collective_quant)
    L, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    if resume is None:
        f, g = value_and_grad_fn(x0, data)
        f0, g0n = f, _norm(g)
        x = x0
        prev_f = f + torch.full_like(f, float("inf"))
        S = torch.zeros((L, m, d), dtype=dtype, device=dev)
        Y = torch.zeros_like(S)
        rho = torch.zeros((L, m), dtype=dtype, device=dev)
        valid = torch.zeros((L, m), dtype=torch.bool, device=dev)
        head = torch.zeros(L, dtype=torch.int64, device=dev)
    else:
        x, f, g, prev_f, S, Y, rho, valid, head, f0, g0n = resume
    it = torch.zeros(L, dtype=torch.int64, device=dev)
    made_progress = torch.ones(L, dtype=torch.bool, device=dev)
    values = torch.full((L, max_iter + 1), float("nan"), dtype=f.dtype,
                        device=dev)
    grad_norms = torch.full_like(values, float("nan"))
    values[:, 0] = f
    grad_norms[:, 0] = _norm(g)
    iterates = new_iterates(x, max_iter, track_iterates)

    while True:
        active = should_continue(it, f, prev_f, _norm(g), f0, g0n,
                                 max_iter, tolerance, made_progress,
                                 resumed=resume is not None)
        (any_active,) = host_flags(active.any())
        if not any_active:
            break

        direction = two_loop_direction(g, S, Y, rho, valid, head,
                                       update_axis_name, collective_quant)
        dphi0 = _dot(g, direction)
        # not a descent direction -> steepest descent
        bad = dphi0 >= 0.0
        direction = torch.where(bad[:, None], -g, direction)
        dphi0 = torch.where(bad, -_dot(g, g), dphi0)

        def phi(a, x=x, direction=direction):
            f_a, g_a = value_and_grad_fn(x + a[:, None] * direction, data)
            return f_a, _dot(g_a, direction), g_a

        # Breeze convention: the first iteration starts at 1/||d||, then 1;
        # a resumed chunk is past its solve's first iteration
        first = it == 0 if resume is None else torch.zeros_like(active)
        init_alpha = torch.where(
            first, 1.0 / torch.clamp(_norm(direction), min=1.0),
            torch.ones_like(dphi0))
        ls = strong_wolfe(phi, f, dphi0, g, init_alpha, active)

        x_new = x + ls.alpha[:, None] * direction
        x_new, f_new, g_new = project_and_refresh(
            value_and_grad_fn, data, x_new, ls.value, ls.grad, box, active)
        ok = finite_step(ls.ok, f_new, g_new, update_axis_name)

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
        iterates = record_iterate(iterates, slot[:, 0], x, active)
        prev_f = torch.where(active, f, prev_f)
        f = torch.where(active, f_acc, f)
        g = torch.where(a2, g_acc, g)
        made_progress = torch.where(active, ok, made_progress)
        it = torch.where(active, it_new, it)

    out = (x, RunHistory(values, grad_norms, it, iterates), made_progress)
    if return_carry:
        return out + (LBFGSResume(x, f, g, prev_f, S, Y, rho, valid, head,
                                  f0, g0n),)
    return out
