"""Coordinate states across the JAX package and the port.

A coordinate's state is what coordinate descent carries per coordinate and
what a snapshot holds under ``"states"``
(``photon_ml_tpu/game/coordinate_descent.py:536``, ``:638``): the fixed
effect's coefficient vector ``[D]`` in normalized space, or a random
effect's compact block ``[E, D_red]``. With these two functions the port
scores a model the JAX package trained and resumes coordinate descent from
JAX states (``run_coordinate_descent(initial_states=...)``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device


def states_from_numpy(states: Mapping[str, np.ndarray],
                      device="cuda") -> dict[str, torch.Tensor]:
    """JAX-package states (numpy arrays) -> the port's f32 tensors."""
    device = resolve_device(device)
    return {cid: torch.tensor(np.asarray(v, dtype=np.float32),
                              device=device)
            for cid, v in states.items()}


def states_to_numpy(states: Mapping[str, torch.Tensor]
                    ) -> dict[str, np.ndarray]:
    """The port's states -> numpy arrays the JAX package takes."""
    return {cid: t.detach().cpu().numpy() for cid, t in states.items()}
