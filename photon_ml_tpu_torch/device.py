"""Explicit device selection for the port's entry points.

There is no silent CPU fallback: asking for CUDA on a host without it is
an error, so a run that was meant for the card can never quietly measure
the CPU instead.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a concrete ``torch.device`` (CUDA gets an index).

    Raises ``RuntimeError`` for CUDA when ``torch.cuda.is_available()`` is
    false, and ``ValueError`` for device types the port does not run on.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; the port does not "
                "fall back to the CPU — pass device='cpu' to run the plain "
                "PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def check_on_device(t: torch.Tensor, device: torch.device, name: str) -> None:
    """Raise unless tensor ``t`` lies on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
