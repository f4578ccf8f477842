"""Strong-Wolfe line search, lane-batched.

Port of ``photon_ml_tpu/optimize/linesearch.py:32-216``. The JAX search is
one ``lax.while_loop`` with a stage flag (BRACKET -> ZOOM) and
``lax.switch``/``lax.cond`` branches, ``vmap``ped over entity lanes, so
every lane follows its own independent run. Here each lane carries its own
stage, its own trial step (``2a`` on expand, ``_cubic_min`` on zoom) and
masked updates; one batched objective evaluation per loop step serves all
lanes at their own step lengths, and the loop ends when no lane is still
searching. Wolfe constants c1=1e-4, c2=0.9 as in Breeze/Nocedal.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from photon_ml_tpu_torch.optimize.common import host_flags

Tensor = torch.Tensor

C1 = 1e-4
C2 = 0.9
MAX_LS_ITER = 20
_BRACKET, _ZOOM, _DONE, _FAIL = 0, 1, 2, 3


class LineSearchResult(NamedTuple):
    alpha: Tensor  # [L] accepted step length (0 on failure)
    value: Tensor  # [L] f(x + alpha d)
    grad: Tensor  # [L, D] grad f(x + alpha d)
    ok: Tensor  # [L] bool: Wolfe conditions (or sufficient decrease) hold
    num_evals: Tensor  # [L]


def _cubic_min(a, fa, dfa, b, fb, dfb):
    """Minimizer of the cubic through (a,fa,dfa),(b,fb,dfb); bisection when
    degenerate (N&W eq. 3.59, ``linesearch.py:58-79``)."""
    d1 = dfa + dfb - 3.0 * (fa - fb) / (a - b)
    disc = d1 * d1 - dfa * dfb
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    d2 = torch.sign(b - a) * sqrt_disc
    denom = dfb - dfa + 2.0 * d2
    cand = b - (b - a) * (dfb + d2 - d1) / denom
    mid = 0.5 * (a + b)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    width = hi - lo
    good = ((disc >= 0.0) & torch.isfinite(cand)
            & (cand > lo + 0.1 * width) & (cand < hi - 0.1 * width))
    return torch.where(good, cand, mid)


def _pick(*pairs_and_default):
    """where-chain: ``_pick((m1, v1), (m2, v2), ..., default)``; the masks
    are disjoint per lane. Masks broadcast over trailing axes."""
    *pairs, out = pairs_and_default
    for mask, val in reversed(pairs):
        if mask.dim() < val.dim():
            mask = mask.reshape(mask.shape + (1,) * (val.dim() - mask.dim()))
        out = torch.where(mask, val, out)
    return out


def strong_wolfe(
    value_and_grad_1d: Callable[[Tensor], tuple[Tensor, Tensor, Tensor]],
    phi0: Tensor,
    dphi0: Tensor,
    g0: Tensor,
    init_alpha: Tensor,
    active: Tensor,
    max_alpha: float = 1e10,
) -> LineSearchResult:
    """Per-lane step satisfying the strong Wolfe conditions.

    ``value_and_grad_1d(a)`` takes per-lane steps ``[L]`` and returns
    ``(phi(a) [L], dphi(a) [L], grad(x + a d) [L, D])``. Lanes with
    ``active`` false start finished; their results are meaningless and the
    caller discards them.
    """
    a = init_alpha
    phi_a, dphi_a, g_a = value_and_grad_1d(a)
    stage = torch.where(active, _BRACKET, _DONE)
    it = torch.ones_like(stage)
    a_lo = torch.zeros_like(phi0)
    phi_lo, dphi_lo, g_lo = phi0, dphi0, g0
    a_hi = torch.zeros_like(phi0)
    phi_hi, dphi_hi = phi0, dphi0
    max_a = torch.full_like(a, max_alpha)

    while True:
        in_br = stage == _BRACKET
        in_zm = stage == _ZOOM
        armijo_fail = ((phi_a > phi0 + C1 * a * dphi0)
                       | ((it > 0) & (phi_a >= phi_lo)))
        curv_ok = dphi_a.abs() <= -C2 * dphi0
        pos_slope = dphi_a >= 0.0
        br0 = in_br & armijo_fail  # -> ZOOM (lo=prev, hi=cur)
        br1 = in_br & ~armijo_fail & curv_ok  # accept
        br2 = in_br & ~armijo_fail & ~curv_ok & pos_slope  # ZOOM (cur, prev)
        br3 = in_br & ~armijo_fail & ~curv_ok & ~pos_slope  # expand
        evaluating = br3 | in_zm
        searching, any_eval = host_flags((stage < _DONE).any(),
                                         evaluating.any())
        if not searching:
            break

        a_j = _cubic_min(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi)
        new_a = torch.minimum(2.0 * a, max_a)
        a_e = torch.where(br3, new_a, torch.where(in_zm, a_j, a))
        if any_eval:
            phi_e, dphi_e, g_e = value_and_grad_1d(a_e)
        else:
            phi_e, dphi_e, g_e = phi_a, dphi_a, g_a

        z_fail = (phi_e > phi0 + C1 * a_j * dphi0) | (phi_e >= phi_lo)
        z_curv = dphi_e.abs() <= -C2 * dphi0
        z_shrink = in_zm & z_fail
        z_accept = in_zm & ~z_fail & z_curv
        z_move = in_zm & ~z_fail & ~z_curv
        flip = z_move & (dphi_e * (a_hi - a_lo) >= 0.0)
        lo_from_cur = br2 | br3

        new_a_hi = _pick((br0, a), (br2, a_lo), (z_shrink, a_j),
                         (flip, a_lo), a_hi)
        new_phi_hi = _pick((br0, phi_a), (br2, phi_lo), (z_shrink, phi_e),
                           (flip, phi_lo), phi_hi)
        new_dphi_hi = _pick((br0, dphi_a), (br2, dphi_lo),
                            (z_shrink, dphi_e), (flip, dphi_lo), dphi_hi)
        a_lo = _pick((lo_from_cur, a), (z_move, a_j), a_lo)
        phi_lo = _pick((lo_from_cur, phi_a), (z_move, phi_e), phi_lo)
        dphi_lo = _pick((lo_from_cur, dphi_a), (z_move, dphi_e), dphi_lo)
        g_lo = _pick((lo_from_cur, g_a), (z_move, g_e), g_lo)
        a_hi, phi_hi, dphi_hi = new_a_hi, new_phi_hi, new_dphi_hi
        a = _pick((evaluating, a_e), a)
        phi_a = _pick((evaluating, phi_e), phi_a)
        dphi_a = _pick((evaluating, dphi_e), dphi_a)
        g_a = _pick((evaluating, g_e), g_a)
        it = it + evaluating.to(it.dtype)
        stage = _pick((br0 | br2, torch.full_like(stage, _ZOOM)),
                      (br1 | z_accept, torch.full_like(stage, _DONE)), stage)

        # Give up when the eval budget is spent or the zoom interval
        # collapsed (``linesearch.py:171-185``).
        exhausted = (it >= MAX_LS_ITER) & (stage < _DONE)
        interval_dead = (stage == _ZOOM) & (
            (a_hi - a_lo).abs()
            <= 1e-14 * torch.clamp(a_hi.abs(), min=1.0))
        stage = torch.where(exhausted | interval_dead,
                            torch.full_like(stage, _FAIL), stage)

    accepted = stage == _DONE
    fallback_ok = phi_lo < phi0
    zero = torch.zeros_like(a)
    alpha = torch.where(accepted, a, torch.where(fallback_ok, a_lo, zero))
    value = torch.where(accepted, phi_a,
                        torch.where(fallback_ok, phi_lo, phi0))
    grad = torch.where(accepted[:, None], g_a,
                       torch.where(fallback_ok[:, None], g_lo, g0))
    return LineSearchResult(alpha=alpha, value=value, grad=grad,
                            ok=accepted | fallback_ok, num_evals=it)
