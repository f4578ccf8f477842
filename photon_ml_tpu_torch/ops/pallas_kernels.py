"""Fused GLM value+gradient: the Hopper kernel, its gate and its plain form.

Port of ``photon_ml_tpu/ops/pallas_kernels.py:58-231``. The TPU kernel
(``fused_value_gradient_sums``, ``pl.pallas_call`` at ``:183``) becomes the
hand-written CUDA kernel ``csrc/fused_value_gradient.cu``, which reads the
design matrix X once for both ``X.w`` and ``X^T r``:

    value     = sum_i wt_i l(z_i, y_i)
    vector    = sum_i wt_i l'(z_i, y_i) x_i
    prefactor = sum_i wt_i l'(z_i, y_i),   z = X w_eff + offsets + shift

- :func:`fused_value_gradient_sums` launches the kernel for CUDA tensors and
  runs :func:`fused_value_gradient_sums_reference` (the two-pass form of
  ``_xla_sums``, ``:132-140``) only for CPU tensors. There is no fallback
  from a failed build or launch: both raise.
- :class:`_FusedSums` is the ``torch.autograd.Function`` around the launch;
  its backward re-runs the plain two-pass form, as the JAX custom VJP does
  (``:219-231``).
- :func:`pallas_supported` is the gate (``:63-84``) with the same
  thresholds; a CUDA device stands in for the TPU backend test.
- :func:`kernel_path` picks the kernel's pass-1 path: ``"stream"`` (rows
  held in registers, for rows of at most 1 KB that are whole 16-byte
  vectors in an aligned X — the GLMix fixed effect's 64 f32 columns) or
  ``"staged"`` (row tiles through shared memory, every other shape);
  :func:`stream_geometry` is the stream path's split of a row over lanes.
  Launches are counted per path in
  ``fused_value_gradient_sums.launches_by_path``, per loss in
  ``fused_value_gradient_sums.launches_by_loss`` and, from the bodies of
  a mesh's shard runner (``parallel/collectives.py``), per data-axis
  shard in ``fused_value_gradient_sums.launches_by_shard``.
- A launch runs with its tensors' device current
  (``torch.cuda.device``): a shard's thread may have another card
  current, and a launch onto a stream of another device fails.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from photon_ml_tpu_torch.device import check_on_device, resolve_device
from photon_ml_tpu_torch.ops import kernels_build
from photon_ml_tpu_torch.ops.losses import LOSSES, PointwiseLoss
from photon_ml_tpu_torch.parallel import collectives
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS

Tensor = torch.Tensor

MAX_PALLAS_DIM = 4096
# Below this many elements the two-pass form is cache-resident anyway; the
# kernel's gain is HBM traffic, so it engages only at real sizes.
MIN_PALLAS_ELEMENTS = 1 << 21
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"staged": 0, "stream": 1}
#: Widest row (bytes) the stream path holds in registers.
STREAM_MAX_ROW_BYTES = 1024
# Upper bound of resident pass-1 CTAs per SM (2048 threads / 256): sizes
# the partials scratch; the launcher picks the grid from the occupancy.
_CTAS_PER_SM = 8
_MAX_CTAS: dict[int, int] = {}  # device index -> partials scratch rows
_COUNT_LOCK = threading.Lock()


def pallas_supported(n: int, d: int, dtype: torch.dtype, device) -> bool:
    """Gate for the fused kernel: a CUDA device, f32 or bf16 X,
    ``d <= 4096`` and ``n * d >= 2**21``."""
    if torch.device(device).type != "cuda":
        return False
    if dtype not in _KERNEL_DTYPES:
        return False
    return d <= MAX_PALLAS_DIM and n * d >= MIN_PALLAS_ELEMENTS


def kernel_path(d: int, dtype: torch.dtype, x_aligned: bool) -> str:
    """The kernel's pass-1 path for rows of ``d`` values of ``dtype``:
    ``"stream"`` when a row is at most 1 KB of whole 16-byte vectors and X
    is 16-byte aligned, else ``"staged"``."""
    row_bytes = d * dtype.itemsize
    if (x_aligned and row_bytes <= STREAM_MAX_ROW_BYTES
            and row_bytes % 16 == 0):
        return "stream"
    return "staged"


class StreamGeometry(NamedTuple):
    """How the stream path splits a row over a warp's lanes: a segment of
    ``lanes_per_row`` lanes holds one row, lane ``p`` of it loads the
    row's 16-byte vectors ``p + v * lanes_per_row`` for
    ``v < vecs_per_lane`` (those past the row's end are not loaded), and a
    warp load covers ``rows_per_load`` consecutive rows."""

    lanes_per_row: int
    vecs_per_lane: int
    rows_per_load: int


def stream_geometry(d: int, dtype: torch.dtype) -> StreamGeometry:
    """The stream path's geometry for a row of ``d`` values of ``dtype``
    that it takes: the row's 16-byte vectors rounded up to a power of two
    of lanes (at most 32), and as many vectors per lane as that leaves."""
    vecs = d * dtype.itemsize // 16
    lanes = min(1 << (vecs - 1).bit_length(), 32)
    return StreamGeometry(lanes, -(-vecs // lanes), 32 // lanes)


def fused_value_gradient_sums_reference(
        loss: PointwiseLoss, X: Tensor, labels: Tensor, offsets: Tensor,
        weights: Tensor, w_eff: Tensor, margin_shift: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch two-pass form (``_xla_sums``): ``X @ w``, then
    ``r @ X``; a bf16 X is upcast to f32, like the kernel's loads."""
    Xa = X.to(torch.promote_types(X.dtype, torch.float32))
    z = Xa @ w_eff + offsets + margin_shift
    l, d1 = loss.loss_and_d1(z, labels)
    r = weights * d1
    return (weights * l).sum(), r @ Xa, r.sum()


def _launch(loss: PointwiseLoss, X: Tensor, labels: Tensor, offsets: Tensor,
            weights: Tensor, w_eff: Tensor, margin_shift: Tensor,
            path: str | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """Check the operands, launch both passes on the current stream and
    count the launch.

    ``path`` is :func:`kernel_path`'s choice when None; naming one runs
    that path or raises (the CUDA side refuses a stream request for a
    shape it cannot take). Only ``chip_smoke.py`` names one, to hold each
    path against the plain version and time one against the other.
    """
    if X.dim() != 2 or X.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes a 2-D f32/bf16 X, got "
                         f"{tuple(X.shape)} {X.dtype}")
    n, d = X.shape
    if not 1 <= d <= MAX_PALLAS_DIM or n < 1:
        raise ValueError(f"kernel takes 1 <= d <= {MAX_PALLAS_DIM} and "
                         f"n >= 1, got n={n} d={d}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous (row-major)")
    for name, t, size in (("labels", labels, n), ("offsets", offsets, n),
                          ("weights", weights, n), ("w_eff", w_eff, d)):
        if t.dtype != torch.float32 or t.shape != (size,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 [{size}] "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    if margin_shift.dtype != torch.float32 or margin_shift.numel() != 1:
        raise ValueError("margin_shift must be one f32 element")
    if path is None:
        path = kernel_path(d, X.dtype, X.data_ptr() % 16 == 0)
    if path not in _PATHS:
        raise ValueError(f"path must be one of {sorted(_PATHS)}, got "
                         f"{path!r}")
    geom = (stream_geometry(d, X.dtype) if path == "stream"
            else StreamGeometry(0, 0, 0))
    lib = kernels_build.load("fused_value_gradient")
    dev = X.device
    max_ctas = _MAX_CTAS.get(dev.index)
    if max_ctas is None:
        max_ctas = _MAX_CTAS[dev.index] = _CTAS_PER_SM * \
            torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = dict(dtype=torch.float32, device=dev)
    # the launch goes to ``dev``'s stream with ``dev`` current: the runtime
    # API launches on the current device, and a shard of a mesh calls this
    # from a thread whose current device may be another card
    with torch.cuda.device(dev):
        # pass 1's partials in one buffer: vectors [max_ctas, d], then the
        # values and prefactors [max_ctas] each; pass 2 reads them on the
        # same stream before the allocator can hand the buffer out again
        part = torch.empty(max_ctas * (d + 2), **f32)
        out_vec = torch.empty(d, **f32)
        out_val = torch.empty((), **f32)
        out_pre = torch.empty((), **f32)
        part_vec = part.data_ptr()
        part_val = part_vec + 4 * max_ctas * d
        rc = lib.photon_fused_value_gradient(
            X.data_ptr(), _KERNEL_DTYPES[X.dtype], labels.data_ptr(),
            offsets.data_ptr(), weights.data_ptr(), w_eff.data_ptr(),
            margin_shift.data_ptr(), n, d, loss.code, _PATHS[path],
            geom.lanes_per_row, geom.vecs_per_lane, max_ctas, part_vec,
            part_val, part_val + 4 * max_ctas, out_vec.data_ptr(),
            out_val.data_ptr(), out_pre.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.photon_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_value_gradient {path} launch failed: "
                           f"{msg} ({rc})")
    _count_launch(path, loss.name)
    return out_val, out_vec, out_pre


def _count_launch(path: str, loss_name: str) -> None:
    """One launch on the counts (the shards of a mesh launch from several
    threads at once, hence the lock); a launch from a shard body also
    counts under its data-axis position in ``launches_by_shard``."""
    shard = collectives.bound_index(DATA_AXIS)
    with _COUNT_LOCK:
        fused_value_gradient_sums.launches += 1
        fused_value_gradient_sums.launches_by_path[path] += 1
        fused_value_gradient_sums.launches_by_loss[loss_name] += 1
        if shard is not None:
            by_shard = fused_value_gradient_sums.launches_by_shard
            by_shard[shard] = by_shard.get(shard, 0) + 1


class _FusedSums(torch.autograd.Function):
    """Kernel forward; backward through the plain two-pass form."""

    @staticmethod
    def forward(ctx, loss, X, labels, offsets, weights, w_eff, margin_shift):
        ctx.loss = loss
        ctx.save_for_backward(X, labels, offsets, weights, w_eff,
                              margin_shift)
        return _launch(loss, X, labels, offsets, weights, w_eff,
                       margin_shift)

    @staticmethod
    def backward(ctx, g_val, g_vec, g_pre):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(bool(need))
                      for t, need in zip(saved, needs)]
            outs = fused_value_gradient_sums_reference(ctx.loss, *leaves)
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(
                outs, wrt, grad_outputs=(g_val, g_vec, g_pre),
                allow_unused=True))
        return (None, *[next(grads) if need else None for need in needs])


def fused_value_gradient_sums(
        loss: PointwiseLoss, X: Tensor, labels: Tensor, offsets: Tensor,
        weights: Tensor, w_eff: Tensor, margin_shift: Tensor,
        device="cuda") -> tuple[Tensor, Tensor, Tensor]:
    """One-pass (value, vector_sum, prefactor_sum) over a dense batch.

    Every tensor must lie on ``device``. CUDA launches the kernel (and
    counts the launch in ``fused_value_gradient_sums.launches``); only a
    CPU ``device`` runs the plain version.
    """
    dev = resolve_device(device)
    for name, t in (("X", X), ("labels", labels), ("offsets", offsets),
                    ("weights", weights), ("w_eff", w_eff),
                    ("margin_shift", margin_shift)):
        check_on_device(t, dev, name)
    if dev.type == "cpu":
        return fused_value_gradient_sums_reference(
            loss, X, labels, offsets, weights, w_eff, margin_shift)
    return _FusedSums.apply(loss, X, labels, offsets, weights, w_eff,
                            margin_shift)


def reset_launch_count() -> None:
    """Zero the kernel's launch counts (plain-version calls never count):
    ``fused_value_gradient_sums.launches`` in all, ``launches_by_path``
    by pass-1 path, ``launches_by_loss`` by loss and
    ``launches_by_shard`` by data-axis shard of a mesh."""
    with _COUNT_LOCK:
        fused_value_gradient_sums.launches = 0
        fused_value_gradient_sums.launches_by_path = dict.fromkeys(_PATHS,
                                                                   0)
        fused_value_gradient_sums.launches_by_loss = dict.fromkeys(LOSSES,
                                                                   0)
        fused_value_gradient_sums.launches_by_shard = {}


reset_launch_count()


def launch_count() -> int:
    return fused_value_gradient_sums.launches


__all__ = ["MAX_PALLAS_DIM", "MIN_PALLAS_ELEMENTS", "STREAM_MAX_ROW_BYTES",
           "pallas_supported", "kernel_path", "StreamGeometry",
           "stream_geometry", "fused_value_gradient_sums",
           "fused_value_gradient_sums_reference", "reset_launch_count",
           "launch_count"]
