"""Coordinate states and factor tables across the JAX package and the port.

A coordinate's state is what coordinate descent carries per coordinate and
what a snapshot holds under ``"states"``
(``photon_ml_tpu/game/coordinate_descent.py:536``, ``:638``): the fixed
effect's coefficient vector ``[D]`` in normalized space, a random
effect's compact block ``[E, D_red]``, or a factored random effect's
tuple ``(coefs [E, K], B [K, D])`` (``game/coordinate.py:334-345``). With
these functions the port scores a model the JAX package trained and
resumes coordinate descent from JAX states
(``run_coordinate_descent(initial_states=...)``); a tuple stays a tuple
both ways. :func:`matrix_factorization_from_numpy` carries a JAX
``MatrixFactorizationModel``'s factor tables and raw ids across.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.coordinate_descent import map_state


def states_from_numpy(states: Mapping, device="cuda") -> dict:
    """JAX-package states (numpy arrays, or tuples of them) -> the port's
    f32 tensors of the same form."""
    device = resolve_device(device)
    return {cid: map_state(lambda v: torch.tensor(
        np.asarray(v, dtype=np.float32), device=device), state)
        for cid, state in states.items()}


def states_to_numpy(states: Mapping) -> dict:
    """The port's states -> numpy arrays (a tuple state stays a tuple) the
    JAX package takes."""
    return {cid: map_state(lambda t: t.detach().cpu().numpy(), state)
            for cid, state in states.items()}


def matrix_factorization_from_numpy(row_effect_type: str,
                                    col_effect_type: str, row_factors,
                                    col_factors,
                                    row_ids: Optional[np.ndarray] = None,
                                    col_ids: Optional[np.ndarray] = None,
                                    device="cuda"):
    """A JAX ``MatrixFactorizationModel``'s fields (``np.asarray`` of its
    factor tables, its ``row_ids``/``col_ids``) -> the port's model with
    f32 tables on ``device``."""
    from photon_ml_tpu_torch.game.models import MatrixFactorizationModel

    device = resolve_device(device)

    def table(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return MatrixFactorizationModel(
        row_effect_type=row_effect_type, col_effect_type=col_effect_type,
        row_factors=table(row_factors), col_factors=table(col_factors),
        row_ids=None if row_ids is None else np.asarray(row_ids),
        col_ids=None if col_ids is None else np.asarray(col_ids))
