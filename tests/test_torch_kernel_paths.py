"""The fused value+gradient kernel's two pass-1 paths: choice and geometry.

The kernel runs only on the card (``chip_smoke.py`` holds each path against
the plain version there). Here: which path ``kernel_path`` picks for each
width, dtype and alignment; that the stream path's geometry covers every
column of a row exactly once, with no lane past the row's end counted; and
that CPU tensors take the plain version without counting a launch on
either path.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops import pallas_kernels as tpk

torch.set_num_threads(1)

WIDTHS = [1, 4, 24, 63, 64, 65, 96, 128, 256, 257, 512, 2048, 4096]
DTYPES = [torch.float32, torch.bfloat16]


def _lane_columns(geom, d, dtype):
    """Columns each lane of a segment accumulates, as the CUDA kernel maps
    them: lane p owns the row's 16-byte vectors p + v * lanes_per_row."""
    per_vec = 16 // dtype.itemsize
    vecs = d // per_vec
    cols = []
    for p in range(geom.lanes_per_row):
        mine = []
        for v in range(geom.vecs_per_lane):
            k = p + v * geom.lanes_per_row
            if k < vecs:
                mine.extend(range(k * per_vec, (k + 1) * per_vec))
        cols.append(mine)
    return cols


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_kernel_path_and_stream_geometry(d, dtype, aligned):
    row_bytes = d * dtype.itemsize
    stream = aligned and row_bytes <= 1024 and row_bytes % 16 == 0
    assert tpk.kernel_path(d, dtype, aligned) == (
        "stream" if stream else "staged")
    if not stream:
        return
    geom = tpk.stream_geometry(d, dtype)
    vecs = row_bytes // 16
    lanes = geom.lanes_per_row
    # a power-of-two segment of lanes, as small as the row allows
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
    assert lanes == 32 or lanes // 2 < vecs <= lanes
    assert geom.vecs_per_lane == -(-vecs // lanes) <= 2
    assert geom.rows_per_load * lanes == 32
    cols = _lane_columns(geom, d, dtype)
    flat = [c for mine in cols for c in mine]
    # every column exactly once; none at or past the row's end
    assert sorted(flat) == list(range(d))
    # a lane holds one or two whole vectors or nothing
    per_vec = 16 // dtype.itemsize
    assert all(len(mine) % per_vec == 0
               and len(mine) <= geom.vecs_per_lane * per_vec
               for mine in cols)


def test_main_path_width_streams():
    """The GLMix fixed effect's 64 f32 columns take the stream path: 16
    lanes a row, one vector each, two rows per warp load."""
    assert tpk.kernel_path(64, torch.float32, True) == "stream"
    assert tpk.stream_geometry(64, torch.float32) == (16, 1, 2)
    assert tpk.stream_geometry(512, torch.bfloat16) == (32, 2, 1)


def test_driver_width_is_staged():
    """Through the GAME drivers the GLMix fixed effect gains the intercept
    column: 65 f32 values, 260-byte rows that are not whole 16-byte
    vectors, so every launch takes the staged path."""
    assert tpk.kernel_path(65, torch.float32, True) == "staged"
    assert tpk.kernel_path(65, torch.bfloat16, True) == "staged"


def _cuda_stream_geometry(d, itemsize):
    """``stream_geometry`` + ``launch_stream_geometry`` of
    ``csrc/fused_value_gradient.cu`` for an aligned X: the (lanes,
    vectors a lane) the CUDA side launches, or None where it refuses."""
    row_bytes = d * itemsize
    if row_bytes > 1024 or row_bytes % 16:
        return None
    vecs = row_bytes // 16
    p = 1
    while p < vecs and p < 32:
        p <<= 1
    vpl = -(-vecs // p)
    if vpl == 2:
        return (p, 2) if p == 32 else None
    return (p, 1) if vpl == 1 and p in (1, 2, 4, 8, 16, 32) else None


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_stream_choice_is_one_the_cuda_side_takes(dtype):
    """For every width the kernel takes, the stream path is picked exactly
    where the CUDA side launches it, with the geometry it derives."""
    for d in range(1, tpk.MAX_PALLAS_DIM + 1):
        want = _cuda_stream_geometry(d, dtype.itemsize)
        path = tpk.kernel_path(d, dtype, True)
        assert (path == "stream") == (want is not None), d
        if want is not None:
            geom = tpk.stream_geometry(d, dtype)
            assert (geom.lanes_per_row, geom.vecs_per_lane) == want, d


def _args(n, d, seed=0):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    return (t(rng.normal(size=(n, d)).astype(np.float32)),
            t((rng.uniform(size=n) < 0.5).astype(np.float32)),
            t((rng.normal(size=n) * 0.1).astype(np.float32)),
            t(rng.uniform(0.5, 2.0, size=n).astype(np.float32)),
            t((rng.normal(size=d) * 0.05).astype(np.float32)),
            torch.tensor(0.1))


@pytest.mark.parametrize("d", [64, 63, 2048])
def test_cpu_tensors_count_no_launch_on_either_path(d):
    tpk.reset_launch_count()
    loss = tl.get_loss("logistic")
    args = _args(50, d)
    got = tpk.fused_value_gradient_sums(loss, *args, device="cpu")
    want = tpk.fused_value_gradient_sums_reference(loss, *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tpk.launch_count() == 0
    assert tpk.fused_value_gradient_sums.launches_by_path == {
        "stream": 0, "staged": 0}


@pytest.mark.parametrize("loss", sorted(tl.LOSSES))
def test_launches_are_counted_by_loss_and_cpu_counts_none(loss):
    tpk.reset_launch_count()
    assert tpk.fused_value_gradient_sums.launches_by_loss == dict.fromkeys(
        tl.LOSSES, 0)
    tpk.fused_value_gradient_sums(tl.get_loss(loss), *_args(50, 64),
                                  device="cpu")
    assert tpk.fused_value_gradient_sums.launches_by_loss == dict.fromkeys(
        tl.LOSSES, 0)


def test_unknown_path_is_refused_before_any_build():
    from photon_ml_tpu_torch.ops import kernels_build

    with pytest.raises(ValueError, match="path must be one of"):
        tpk._launch(tl.get_loss("logistic"), *_args(8, 64), path="tiled")
    assert "fused_value_gradient" not in kernels_build._LIBS
