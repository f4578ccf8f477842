"""PyTorch / CUDA port of photon_ml_tpu for NVIDIA Hopper (H100).

The JAX package ``photon_ml_tpu`` is the reference: every module here
mirrors the path and names of its counterpart there, and its docstring
names the JAX function it stands in for. The port imports ``torch``,
``numpy`` and ``scipy`` only — nothing of ``jax`` or ``photon_ml_tpu``.

Devices are explicit: every entry point takes ``device`` (default
``"cuda"``) and raises ``RuntimeError`` when CUDA is missing, instead of
running on the CPU behind the caller's back. Pass ``device="cpu"`` to run
the plain PyTorch versions (the tests do).

The one hand-written kernel is the fused GLM value+gradient pass
(``ops/pallas_kernels.py`` + ``csrc/fused_value_gradient.cu``), which
replaces the JAX package's Pallas ``fused_value_gradient_sums``.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # resolved on first use, so that the host-only modules (the fleet
    # router, the telemetry readers) run without importing torch
    if name == "resolve_device":
        from photon_ml_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(name)
