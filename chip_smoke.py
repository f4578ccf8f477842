#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU: build, check, drive.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. device — the card's name and power limit, TF32 off for matmuls and cuDNN.
2. build  — ``nvcc`` builds every kernel of the port from ``csrc/``.
3. kernel — each kernel's wrapper on the card against its plain PyTorch
   version on the same inputs (every loss, f32 and bf16 X, ragged and exact
   small shapes that reach every geometry of the stream path and the
   staged path's unvectorised load, the GLMix fixed-effect shape and the
   262,144 x 2,048 shape), on every pass-1 path that takes the shape
   (the public wrapper on the path it picks, ``_launch`` on the other),
   bit-identical repeat calls on each path, autograd through the
   ``autograd.Function`` on each path, and the refusal of a stream request
   for a shape the stream path cannot take.
4. timing — CUDA-event medians of the kernel's wrapper, its plain
   version and the one-call-per-pass PyTorch yardstick, beside the HBM
   bound, two ways: one call at a time (``kernel_ms``, ``plain_ms``,
   ``library_ms``: a caller's single call, the host's work before the
   launch included) and ten calls back to back (``device_ms``,
   ``plain_device_ms``, ``library_device_ms``: the device's time per
   call, as long as the host issues a call faster than the device runs
   it, which ``host_ms`` shows). At the GLMix shape and at the legacy
   driver's 32,561 x 124 both pass-1 paths are timed in turns (stream,
   staged, staged, stream); the 262,144 x 2,048 shape is staged only.
5. glmix  — the port's library path at full width: MovieLens-1M-shaped
   data (1,000,209 rows, 6,040 users, 3,706 movies, 64 global features),
   a fixed-effect plus per-user logistic GLM, L-BFGS + L2, two coordinate
   descent sweeps on the card, then the published GameModel scores the
   data. Kernel launch counts are zeroed just before the run and read
   just after; every launch must have taken the stream path. A small
   GLMix also runs on the card and on the CPU, and the two must agree.
6. driver — the same GLMix through the port's own drivers at full size:
   the recipe written as GAME Avro by the port's writer (1,000,209
   training and 200,000 validation rows, full width, as 16 + 4 part files
   written by a pool of processes), ``cli.game_training_driver.run`` (the
   work of its ``main``) on the card (feature maps, Avro load, two sweeps
   with validation after every update, metrics.json, the GAME Avro
   model), then ``cli.game_scoring_driver`` in a process of its own on
   ``best/`` over the validation Avro (its peak host RSS is reported).
   Every part file must be decoded by the native columnar path
   (``io/data_format.py`` ``INGEST_STATS``: no decline), and one training
   part is loaded by the records path too, timed against the native
   path and held equal to it array for array.
   The driver appends an intercept, so the fixed effect has 65 f32
   columns and its launches must all take the path ``kernel_path`` picks
   for them (staged); the scores must equal the library's score of the
   reloaded model, and the scoring driver's AUC the validation AUC that
   metrics.json records for the best state.
7. resume — (a) the glmix phase's data, coordinates built afresh, two
   sweeps with a checkpoint after every update and ``cd.update@1.1`` armed
   to raise; fresh coordinates resume from the restored snapshot at
   (sweep 1, coordinate 1), and their final states must equal phase 5's
   uninterrupted run bit for bit. (b) the crash/resume drill
   (``photon_ml_tpu_torch/tools/crash_resume_drill.py``) on the card: six
   driver processes on a 40,000 / 5,000-row Avro fixture at full width
   (reference, a real kill mid-sweep, resume, a SIGTERM, relaunch, an
   all-corrupt checkpoint directory), exit codes 0/19/75/0/0/3, the
   resumed and relaunched runs bit-exact to the reference in states,
   scores and objectives, every finishing process launching the kernel
   on the path ``kernel_path`` picks for 65 f32 columns and reading every
   part through the native path (its scan and load seconds reported).

8. second_order — TRON and OWL-QN (L1 / elastic net) on the card:
   (a) BASELINE config 2 at ``bench.py``'s shape (262,144 x 2,048 f32, the
   data of ``bench.py:169 _data()`` with a linear response): linear
   regression, TRON + L2 through ``GLMOptimizationProblem.run`` with
   variances (finite, positive), TRON's accepted values never rising, the
   solution equal to a solve with the kernel gated off within rel 1e-4;
   (b) BASELINE config 3 at ``bench.py:386-425``'s recipe (Poisson
   65,536 x 512, elastic net, OWL-QN): ``solve_ms``, ``iterations``,
   ``nnz_coefficients``, and a solve with the kernel gated off ending
   after as many iterations, with the same exact zeros, within rel 1e-4;
   (d) a small GLMix of each new solver on the card
   and on the CPU, objectives within rel 1e-4; a ``torch.profiler`` pass
   over one per-user update of L-BFGS, TRON and OWL-QN on phase 5's
   per-user coordinate (wall seconds, device busy time and idle share,
   solver reads); (c) the training driver twice on phase 6's
   fixture (linear TRON + L2 with ``--compute-variance``, Poisson L-BFGS +
   elastic net; two sweeps, 4 buckets, per-user cap 128): finite
   objectives, no fixed-effect update raising the objective (a per-user
   update may: it sees only each user's 128 active rows, in both
   packages, as ``tests/test_torch_game_second_order.py`` shows; the
   sweep-end objectives are reported), TRON's accepted
   fixed-effect values never rising, then the scoring driver on the
   Poisson run's ``best/``, its POISSON_LOSS equal to the best state's.
   These driver runs read the feature sets of phase 6's scan through
   ``--feature-name-and-term-set-path`` instead of scanning again.
   Every fixed-effect launch of (a)-(d) takes the path
   ``kernel_path`` picks (staged at 8 KB, 2 KB and 260-byte rows) and is
   counted by loss. The timing phase has two more rows: Poisson at
   65,536 x 512 and squared at 262,144 x 2,048, f32.
9. cd_extensions — the coordinate-descent extensions on phase 5's data
   (1,000,209 rows, 6,040 users): (a) two sweeps sequential
   (``pipeline_depth=0``) and two pipelined (1): objectives, final states
   and scores bit for bit equal, ``HOT_LOOP_STATS`` printed; (b) one
   per-user update of L-BFGS (phase 5's config), TRON and OWL-QN (phase
   8's per-user configs) as one dispatch, with lane compaction in chunks
   of 4 and with the auto-tuned chunk: coefficients, iterations and codes
   bit for bit equal, with wall and device busy time (``torch.profiler``),
   the solvers' reads and the lanes of every re-dispatched chunk, and a
   check at the buckets' shapes that a lane's margins and gradient sums,
   with the lanes padded as compaction pads them, do not depend on how
   many lanes share the dispatch; (c) two sweeps in blocks of two
   coordinates: finite objectives, one epilogue
   read per two updates, the sweep ends beside (a)'s sequential ones, and
   a small blocked GLMix on the card and the CPU within rel 1e-4; (d) the
   blocked pipelined run with a snapshot at every coordinate and
   ``cd.update@1.1`` raising inside sweep 1's block: snapshots only at
   block boundaries, and fresh coordinates resumed from the newest equal
   to (c)'s run bit for bit (states, scores, objectives); (e) the fixed
   effect down-sampled at rate 0.5 (the binary sampler): the weights the
   card samples equal the CPU's for the same keys, two sweeps finite, on
   the stream path; (f) the training driver with the pipelined sweep,
   blocks of two, auto lane compaction and the fixed effect down-sampled
   at 0.5 on the drill's 40,000 / 5,000-row fixture of phase 7 (b) (the
   full fixture would take the script past 750 s): exit 0, finite
   objectives, one read per block, every launch staged, then the scoring
   driver on its ``best/``, its AUC the best state's.

10. factored — factored random effects and BASELINE config 5: (a) phase
   5's data with the fixed effect and ``perUserFac``, a factored random
   effect over ``userId`` on the 64 global features (IDENTITY projection,
   one block, active cap 128; per-entity and latent L-BFGS + L2, lambda
   1, at most 20 iterations each; K = 8, two inner iterations; the movie
   shard's 3,706 one-hot columns would make Kronecker rows past the
   kernel's 4,096), two sweeps: finite objectives, no fixed-effect update
   raising the objective, every refit launch on the staged path (2 KB
   rows), the fixed effect's on the stream path; (b) the kernel on the
   refit's real Kronecker batch (6,040 x 128 rows x 512) against its plain
   version, and timed; (c) a small factored GLMix (40,000 rows) on the
   card and the CPU within rel 1e-3 (``factored_small_phase`` says why
   not 1e-4), depth 0 equal to depth 1 and a run
   killed at (1, 1) and resumed equal to the uninterrupted one, bit for
   bit; (d) the training driver with ``FACTORED_FLAGS`` on the drill's
   fixture (K·D = 8 x 65, every launch staged), then the scoring driver
   on its ``best/`` (a plain random-effect directory), its AUC the best
   state's; (e) BASELINE config 5 at ``bench.py:1226``'s parameters
   (400,000 rows, 32 global features, per-user and per-item caps of 64,
   3 buckets each, one sweep; every launch on the stream path), its
   fixed effect's kernel timed on the real batch, then the MF scoring
   pass over random K = 8 tables: rows per second, equal to a host numpy
   gather-dot, and equal after a LatentFactorAvro round trip.
11. single_glm — the single-GLM path, BASELINE config 1: (a)
   ``train_glm_grid`` at ``bench.py``'s config-1 shape (262,144 x 2,048
   f32, logistic, L-BFGS + L2, lambda 10, 1, 0.1 warm-started, at most
   80 iterations, tol 1e-6): per-lambda iterations and seconds, every
   launch staged (8 KB rows), the grid with the kernel gated off
   reaching the same objectives (rel 1e-4; coefficients rel 1e-3, f32
   stopping noise), ``evaluate_model_grid`` equal to one call a model
   (rel 1e-6), a box on the first 16 coordinates holding with one on a
   bound, the last tracked iterate the solution; (b) an a1a-shaped
   LibSVM fixture (123 one-hot features in 14 groups, a9a's 32,561 /
   16,281 rows) through ``cli/libsvm_to_avro`` and the legacy driver
   with validation, the grid, VALIDATE_FULL, every diagnostic, the
   per-iteration metrics and the summary: every part native, every
   main-grid launch on the stream path (124 f32 columns), the best
   model's AUC from ``best/`` equal to ``metrics.json``'s, the last
   iterate's metrics the final model's; (c) the same LibSVM files
   straight into the driver as a process (exit 0), its validation AUCs
   (b)'s within rel 1e-4 and its sorted coefficients' distance to (b)'s
   reported; (d) OWL-QN + L1, TRON + L2 with STANDARDIZATION (never
   rising), and the same with a box on three features (finite and
   boxed: the projection after an accepted step can raise TRON's
   values, in both packages); (e) (b) without the diagnostics on the card and the CPU
   (objectives rel 1e-4). The kernel is held against its plain version
   on (a)'s and (b)'s real batches (x 2,048 staged, x 124 stream).

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit) and
no result line is printed. Without CUDA, or outside the repository, it
exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# Device-memory rates for the HBM bound (NVIDIA data sheets) and the f32
# CUDA-core peak of the H100 SXM.
HBM_BYTES_PER_S = {"sxm": 3.35e12, "pcie": 2.0e12}
F32_FLOPS_PER_S = 67e12
# Clock cycles of the spin that holds the device while timed calls are
# queued: about 10 ms at the H100's 1.98 GHz, longer than the host takes
# to issue ten calls of the plain version (some 20 PyTorch ops each).
SPIN_CYCLES = 20_000_000
GLMIX_SHAPE = (1_000_209, 64)
# the GLMix fixed effect through the drivers: 64 features + the intercept
DRIVER_SHAPE = (1_000_209, 65)
BIG_SHAPE = (262_144, 2_048)
# BASELINE config 3 (bench.py:398, Poisson elastic net)
CONFIG3_SHAPE = (65_536, 512)
# rows of the driver phase's Avro fixture (training, validation): the
# configuration's 1,000,209 training rows and a fifth as many to validate,
# written as 16 + 4 part files; the widths are the configuration's
DRIVER_ROWS = (1_000_209, 200_000)
# rows of the resume phase's drill fixture: cut further, since six driver
# processes each decode the Avro again, but not below the kernel's gate:
# 40,000 x 65 = 2.6M elements passes ``pallas_supported``'s 2**21, where
# at 20,000 rows the fixed effect takes the plain two-pass form
DRILL_ROWS = (40_000, 5_000)
# the fixed effects of the small card-vs-CPU runs (phases 5, 8-10) and of
# the drill's drivers (phases 7, 9, 10)
SMALL_SHAPE = (40_000, 64)
DRILL_SHAPE = (DRILL_ROWS[0], 65)
DRIVER_SECTIONS = "global:globalFeatures|user:userFeatures"
# BASELINE config 1 is logistic regression on a1a; the fixture keeps
# a1a's encoding (123 binary features in 14 one-hot groups, one for each
# Adult attribute) at the rows of the family's largest set, a9a (32,561
# training and 16,281 test rows): with the intercept 32,561 x 124 passes
# the kernel's 2**21-element gate, where a1a's own 1,605 rows would not
A1A_GROUPS = (5, 8, 5, 16, 5, 7, 14, 6, 5, 2, 2, 2, 5, 41)
A1A_FEATURES = sum(A1A_GROUPS)  # 123
A1A_ROWS = (32_561, 16_281)
A1A_SHAPE = (A1A_ROWS[0], A1A_FEATURES + 1)
CONFIG1_LAMBDAS = (10.0, 1.0, 0.1)
# (shape, tolerance scaled to the sum of |terms|): the small shapes reach
# every stream geometry (1 to 32 lanes a row in f32 or bf16, one and two
# vectors a lane, segments that are not whole, a ragged last batch) and
# the staged path's unvectorised load (d = 63).
CHECK_SHAPES = [((700, 128), False), ((1024, 256), False),
                ((1000, 96), False), ((1001, 24), False),
                ((1001, 8), False), ((777, 256), False),
                ((777, 63), False), (GLMIX_SHAPE, True),
                (DRIVER_SHAPE, True), (CONFIG3_SHAPE, True),
                (BIG_SHAPE, True), (SMALL_SHAPE, True),
                (DRILL_SHAPE, True), (A1A_SHAPE, True)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def movielens_data(rng, n, n_users, n_movies, d_global,
                   with_item_effect=False):
    """MovieLens-shaped synthetic GameDataset: power-law users, uniform
    movies, dense global features, one-hot movie features for the per-user
    coordinate, and with ``with_item_effect`` a per-movie effect in the
    labels, one-hot user features for a per-item coordinate and the
    ``movieId`` column (the recipe of bench.py:581 ``_movielens_data``)."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.game.dataset import GameDataset

    users = (rng.zipf(1.3, size=n) % n_users).astype(np.int64)
    movies = rng.integers(0, n_movies, n)
    Xg = (rng.normal(size=(n, d_global)) / np.sqrt(d_global)).astype(
        np.float32)
    wg = rng.normal(size=d_global).astype(np.float32)
    logits = Xg @ wg + 0.5 * rng.normal(size=n_users)[users].astype(
        np.float32)
    if with_item_effect:
        logits = logits + 0.4 * rng.normal(size=n_movies)[movies].astype(
            np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    one = np.ones(n, np.float32)
    shards = {
        "global": sp.csr_matrix(Xg),
        "per_user": sp.csr_matrix((one, (np.arange(n), movies)),
                                  shape=(n, n_movies)),
    }
    if with_item_effect:
        shards["per_item"] = sp.csr_matrix((one, (np.arange(n), users)),
                                           shape=(n, n_users))
    data = GameDataset(responses=y, feature_shards=shards)
    data.encode_ids("userId", users)
    if with_item_effect:
        data.encode_ids("movieId", movies)
    return data


def glmix_coordinates(data, device, active_cap=128, feature_cap=128,
                      num_buckets=4, case="lbfgs"):
    """Fixed effect + per-user random effect with the configurations of
    ``GLMIX_CASES[case]`` (for "lbfgs": L-BFGS + L2, lambda 10 and 40
    iterations, then lambda 1 and 20 iterations, tolerance 1e-7)."""
    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate, RandomEffectCoordinate)
    from photon_ml_tpu_torch.game.dataset import (
        RandomEffectDataConfiguration, build_fixed_effect_dataset,
        build_random_effect_dataset)
    from photon_ml_tpu_torch.game.random_effect import (
        RandomEffectOptimizationProblem)
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.tools.glmix_cases import GLMIX_CASES

    glmix = GLMIX_CASES[case]
    task = TaskType[glmix.task]
    parse = GLMOptimizationConfiguration.parse
    re_cfg = RandomEffectDataConfiguration(
        random_effect_type="userId", feature_shard_id="per_user",
        num_active_data_points_upper_bound=active_cap,
        num_features_to_keep_upper_bound=feature_cap)
    return {
        "fixed": FixedEffectCoordinate(
            dataset=build_fixed_effect_dataset(data, "global",
                                               device=device),
            problem=GLMOptimizationProblem(config=parse(glmix.fixed),
                                           task=task)),
        "per-user": RandomEffectCoordinate(
            dataset=build_random_effect_dataset(
                data, re_cfg, num_buckets=num_buckets, device=device),
            problem=RandomEffectOptimizationProblem(
                config=parse(glmix.per_user), task=task)),
    }


def kernel_inputs(torch, n, d, seed, device):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d), dtype=np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    w = (rng.normal(size=d) * (0.5 / np.sqrt(d))).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(X), t(y), t(off), t(wt), t(w)


def paths_for(X) -> list:
    """Every pass-1 path that takes X's shape: staged always, stream
    where its rows fit."""
    from photon_ml_tpu_torch.ops.pallas_kernels import kernel_path

    aligned = X.data_ptr() % 16 == 0
    return (["stream", "staged"]
            if kernel_path(X.shape[1], X.dtype, aligned) == "stream"
            else ["staged"])


def check_sums(torch, loss, X, y, off, wt, w, shift, scaled: bool,
               path=None):
    """Kernel against the plain version on the same inputs: through the
    public wrapper when ``path`` is None (the path it picks for X), else
    on the named path. Returns the largest |delta| of the vector sum and
    the worst tolerance ratio."""
    from photon_ml_tpu_torch.ops.pallas_kernels import (
        _launch, fused_value_gradient_sums,
        fused_value_gradient_sums_reference)

    def kernel():
        if path is None:
            return fused_value_gradient_sums(loss, X, y, off, wt, w, shift,
                                             device=X.device)
        return _launch(loss, X, y, off, wt, w, shift, path=path)

    got = kernel()
    torch.cuda.synchronize()
    again = kernel()
    torch.cuda.synchronize()
    where = path or "wrapper's path"
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{loss.name} {where}: two calls are not "
                             f"bit-identical")
    ref = fused_value_gradient_sums_reference(loss, X, y, off, wt, w, shift)
    torch.cuda.synchronize()
    v, vec, pre = (t.double() for t in got)
    rv, rvec, rpre = (t.double() for t in ref)
    if scaled:
        # sums of 1e5-1e6 f32 terms in another order: |delta| is held
        # against 1e-5 * sum_i |term_i|, per entry
        Xa = X.float()
        z = Xa @ w + off + shift
        l, d1 = loss.loss_and_d1(z, y)
        r = (wt * d1).double()
        tol_vec = 1e-5 * (r.abs().float() @ Xa.abs()).double()
        tol_val = 1e-5 * (wt * l).abs().double().sum()
        tol_pre = 1e-5 * r.abs().sum()
        worst = max(float(((vec - rvec).abs() / tol_vec).max()),
                    float((v - rv).abs() / tol_val),
                    float((pre - rpre).abs() / tol_pre))
        del Xa
    else:
        # the small cases of tests/test_pallas.py: value rel 2e-5,
        # prefactor rel 2e-5 / abs 1e-4, vector rtol = atol = 2e-4
        worst = max(float((v - rv).abs() / (2e-5 * rv.abs())),
                    float((pre - rpre).abs()
                          / (1e-4 + 2e-5 * rpre.abs())),
                    float(((vec - rvec).abs()
                           / (2e-4 + 2e-4 * rvec.abs())).max()))
    max_abs = float((vec - rvec).abs().max())
    if not worst <= 1.0 or not np.isfinite(worst):
        raise AssertionError(f"{loss.name} {X.dtype} {tuple(X.shape)} "
                             f"{where}: kernel disagrees with its plain "
                             f"version (worst delta/tolerance {worst:.3g})")
    return max_abs, worst


def cuda_times(torch, fn, reps=25, inner=1, warmup=3) -> dict:
    """CUDA-event time per call of ``inner`` calls back to back (``ms``),
    median over ``reps`` turns, and the host's time to issue a call
    (``host_ms``).

    One call at a time (``inner`` 1) the event time holds the host's work
    before the launch, as a caller's single call does. Back to back a
    spin kernel (``spin_ms`` on the device) holds the device first, so
    that the calls are queued before the timed window opens and the event
    time is the device's alone. A turn whose calls took the host longer
    to issue than the spin lasted is left out of the median;
    ``queued_share`` is the share of turns kept.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    turns = []
    for _ in range(reps):
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        if inner > 1:
            s.record()
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        t = time.perf_counter()
        for _ in range(inner):
            fn()
        issue_ms = (time.perf_counter() - t) * 1e3
        b.record()
        b.synchronize()
        spin_ms = s.elapsed_time(a) if inner > 1 else float("inf")
        turns.append((a.elapsed_time(b) / inner, issue_ms / inner,
                      spin_ms, issue_ms < spin_ms))
    kept = [t for t in turns if t[3]] or turns
    return {"ms": float(np.median([t[0] for t in kept])),
            "host_ms": float(np.median([t[1] for t in turns])),
            "spin_ms": float(np.median([t[2] for t in turns])),
            "queued_share": sum(t[3] for t in turns) / len(turns)}


def time_kernel(torch, hbm, loss, Xc, y, off, wt, w, shift) -> dict:
    """The timing rows of the kernel on ``Xc``, one per pass-1 path that
    takes the shape: the paths in turns on the same inputs (A, B, B, A),
    each turn one call at a time (``kernel_ms``) and then ten back to back
    (``device_ms``), beside the plain version, the one-call-per-pass
    PyTorch yardstick (``library``) and the bound of the bytes the call
    must move (X once, four ``[n]`` vectors, ``w``) or of its f32
    operations, whichever is larger."""
    from photon_ml_tpu_torch.ops import pallas_kernels as pk

    n, d = (int(v) for v in Xc.shape)
    wl = w.to(Xc.dtype)

    def library():
        z = torch.matmul(Xc, wl).float() + off + shift
        r = wt * loss.d1(z, y)
        return ((wt * loss.loss(z, y)).sum(),
                torch.matmul(r.to(Xc.dtype), Xc), r.sum())

    paths = paths_for(Xc)
    single = {p: [] for p in paths}
    back = {p: [] for p in paths}
    for p in paths + paths[::-1]:
        def run(p=p):
            return pk._launch(loss, Xc, y, off, wt, w, shift, path=p)
        single[p].append(cuda_times(torch, run)["ms"])
        back[p].append(cuda_times(torch, run, reps=15, inner=10))

    def plain():
        return pk.fused_value_gradient_sums_reference(loss, Xc, y, off, wt,
                                                      w, shift)
    plain_ms = cuda_times(torch, plain)["ms"]
    plain_dev = cuda_times(torch, plain, reps=15, inner=10)
    library_ms = cuda_times(torch, library)["ms"]
    library_dev = cuda_times(torch, library, reps=15, inner=10)
    nbytes = n * d * Xc.element_size() + 12 * n + 4 * d
    bytes_ms = 1e3 * nbytes / hbm
    ops_ms = 1e3 * 4.0 * n * d / F32_FLOPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    dt = str(Xc.dtype).split(".")[-1]
    rows = {}
    for p in paths:
        kernel_ms = float(np.mean(single[p]))
        device_ms = float(np.mean([r["ms"] for r in back[p]]))
        rows[p] = {
            "n": n, "d": d, "dtype": dt, "path": p, "loss": loss.name,
            "kernel_ms": kernel_ms, "kernel_ms_runs": single[p],
            "device_ms": device_ms,
            "device_ms_runs": [r["ms"] for r in back[p]],
            "host_ms": float(np.mean([r["host_ms"] for r in back[p]])),
            "spin_ms": back[p][0]["spin_ms"],
            "queued_share": min(r["queued_share"] for r in back[p]),
            "plain_ms": plain_ms, "plain_device_ms": plain_dev["ms"],
            "plain_queued_share": plain_dev["queued_share"],
            "library_ms": library_ms,
            "library_device_ms": library_dev["ms"],
            "library_queued_share": library_dev["queued_share"],
            "bytes": nbytes, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": bound_ms / kernel_ms,
            "device_share_of_bound": bound_ms / device_ms,
            "achieved_gb_per_s": nbytes / kernel_ms / 1e6,
            # the staged path's time over this path's, same run
            "staged_over_this": float(np.mean(single["staged"]))
            / kernel_ms,
            "staged_over_this_device": float(np.mean(
                [r["ms"] for r in back["staged"]])) / device_ms}
    return rows


# the scoring driver as its own process. Its peak RSS so far is read after
# the device's first tensor and after each driver phase, as the larger of
# the kernel's high-water mark (VmHWM, where /proc gives it) and the most
# a thread sampling the resident size every 2 ms saw. ru_maxrss is
# reported beside it, but a child can inherit it from its parent's peak
# across exec, so it bounds the child's peak only from above.
SCORING_CHILD = """
import contextlib, json, os, resource, sys, threading, time
sys.path.insert(0, sys.argv[1])
import torch
from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
from photon_ml_tpu_torch.io.data_format import INGEST_STATS
argv = sys.argv[2:]
page = os.sysconf("SC_PAGE_SIZE")
seen = [0]
def resident():
    with open("/proc/self/statm") as f:
        return page * int(f.read().split()[1])
def sample():
    while True:
        seen[0] = max(seen[0], resident())
        time.sleep(0.002)
threading.Thread(target=sample, daemon=True).start()
def peak():
    seen[0] = max(seen[0], resident())
    with open("/proc/self/status") as f:
        hwm = [int(ln.split()[1]) * 1024 for ln in f
               if ln.startswith("VmHWM:")]
    return max([seen[0]] + hwm)
rss = {}
timed = tsd.timed_phase
@contextlib.contextmanager
def phase(name, logger=None, record=None):
    with timed(name, logger, record) as t:
        yield t
    rss[name] = peak()
tsd.timed_phase = phase
rss["imports"] = peak()
torch.zeros(1, device=argv[argv.index("--device") + 1])
rss["device_init"] = peak()
d = tsd.run(argv)
rss["end"] = peak()
print("SCORING_DRIVER " + json.dumps({
    "metrics": d.metrics, "phase_seconds": d.phase_seconds,
    "ingest_parts": INGEST_STATS, "max_rss_bytes_after": rss,
    "ru_maxrss_bytes":
        1024 * resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}))
"""


def run_scoring_driver(argv) -> dict:
    """The scoring driver in a process of its own (so that its peak host
    RSS is its own): returns its metrics, phase seconds, ingest part
    counts, the peak RSS after each step (``max_rss_bytes_after``) and
    this process's resident size when it started the child."""
    with open("/proc/self/statm") as f:
        parent_rss = os.sysconf("SC_PAGE_SIZE") * int(f.read().split()[1])
    out = subprocess.run([sys.executable, "-c", SCORING_CHILD, REPO, *argv],
                         capture_output=True, text=True, timeout=900)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("SCORING_DRIVER ")]
    if out.returncode != 0 or not lines:
        raise AssertionError(f"scoring driver exit {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    return {**json.loads(lines[-1].split(" ", 1)[1]),
            "parent_rss_bytes": parent_rss}


def datasets_equal(a, b) -> bool:
    """Two GameDatasets equal array for array: every CSR shard, the
    responses, offsets, weights, uids and id codes and vocabularies."""
    if set(a.feature_shards) != set(b.feature_shards) \
            or set(a.id_columns) != set(b.id_columns):
        return False
    for k, x in a.feature_shards.items():
        y = b.feature_shards[k]
        if x.shape != y.shape or x.dtype != y.dtype or not all(
                np.array_equal(getattr(x, f), getattr(y, f))
                for f in ("indptr", "indices", "data")):
            return False
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("responses", "offsets", "weights", "uids")) \
        and all(np.array_equal(a.id_columns[t], b.id_columns[t])
                and np.array_equal(a.id_vocabs[t], b.id_vocabs[t])
                for t in a.id_columns)


def random_effect_scoring(re_model, data) -> dict:
    """A random-effect model's scores on ``data`` two ways: the dense
    ``[N, D_raw]`` form the JAX package runs and the port's O(nnz) form,
    each timed with its peak of traced host allocations (numpy reports
    its buffers to ``tracemalloc``); raises unless they agree bit for
    bit."""
    import tracemalloc

    from photon_ml_tpu_torch.game import models as tm

    coefs = re_model.coefficients.cpu().numpy()
    local = re_model._lookup(data)
    mat = data.feature_shards[re_model.feature_shard_id]
    padded = np.vstack([coefs, np.zeros((1, coefs.shape[1]), coefs.dtype)])
    out, record = {}, {"rows": int(mat.shape[0]), "nnz": int(mat.nnz),
                       "d_raw": int(mat.shape[1])}
    for name, fn in (("dense", lambda: tm.rowwise_sparse_dot(
                          mat, padded[local])),
                     ("onnz", lambda: tm.rowwise_sparse_dot_gathered(
                          mat, padded, local))):
        tracemalloc.start()
        t0 = time.perf_counter()
        out[name] = fn()
        record[f"{name}_secs"] = time.perf_counter() - t0
        record[f"{name}_peak_bytes"] = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
    if not np.array_equal(out["dense"], out["onnz"]):
        raise AssertionError("O(nnz) random-effect scores differ from the "
                             "dense form's")
    record["bit_equal"] = True
    record["onnz_nonzero_rows"] = int(np.count_nonzero(out["onnz"]))
    return record


def driver_phase(torch, dev, smi, workdir, rows=DRIVER_ROWS, n_users=6040,
                 n_movies=3706, d_global=64):
    """The GLMix main path through the port's drivers (phase 6). Returns
    the phase record, the kernel launches of the training run, the
    kernel-vs-plain check on the driver's own fixed-effect batch and the
    fixture: its (training, validation) directories and the feature sets
    of the driver's scan, saved for ``--feature-name-and-term-set-path``,
    which stay in ``workdir``; raises on any failed check, the kernel's
    last."""
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.game.dataset import build_fixed_effect_dataset
    from photon_ml_tpu_torch.io import data_format as tdf
    from photon_ml_tpu_torch.io.model_io import load_scored_items
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.ops.losses import get_loss
    from photon_ml_tpu_torch.serve.scoring import load_scoring_model
    from photon_ml_tpu_torch.tools.crash_resume_drill import (
        FIXTURE_PARTS, driver_argv, write_movielens_avro)

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    train, val = (os.path.join(workdir, k) for k in ("train", "validate"))
    out, score_out = (os.path.join(workdir, k) for k in ("train_out",
                                                          "score_out"))
    t0 = time.perf_counter()
    write_movielens_avro(train, val, *rows, n_users, n_movies, d_global,
                         parts=FIXTURE_PARTS)
    avro_write_secs = time.perf_counter() - t0
    argv = driver_argv(train, val, out, str(dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tdf.reset_ingest_stats()
    pk.reset_launch_count()
    t0 = time.perf_counter()
    trainer = ttd.run(argv)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    driver_secs = time.perf_counter() - t0
    launches = pk.launch_count()
    by_path = dict(pk.fused_value_gradient_sums.launches_by_path)
    by_loss = launch_counts()["by_loss"]
    train_ingest = dict(tdf.INGEST_STATS)
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    # every part through the native path: the scan and the load of the
    # training parts, the load of the validation parts
    want_parts = 2 * FIXTURE_PARTS[0] + FIXTURE_PARTS[1]
    if train_ingest != {"native_parts": want_parts, "declined_parts": 0,
                        "records_parts": 0}:
        raise AssertionError(f"the training driver's ingest left the "
                             f"native path: {train_ingest}")

    record = json.load(open(os.path.join(out, "metrics.json")))
    (grid,) = record["grid"]
    states = grid["states"]
    if len(states) != 4 or any(
            set(s["validation_metrics"] or {}) != {"AUC", "LOGISTIC_LOSS",
                                                   "AUC:userId"}
            for s in states):
        raise AssertionError(f"metrics.json lacks per-state validation "
                             f"metrics: {states}")
    sweep_obj = [[s["objective"] for s in states if s["iteration"] == it][-1]
                 for it in range(2)]
    if not all(o is not None and np.isfinite(o) for o in sweep_obj):
        raise AssertionError(f"non-finite objective: {sweep_obj}")
    if not sweep_obj[1] <= sweep_obj[0] * (1 + 1e-6):
        raise AssertionError(f"objective rose between sweeps: {sweep_obj}")
    best_auc = record["best"]["metric"]
    best_states = [i for i, s in enumerate(states)
                   if s["validation_metrics"]["AUC"] == best_auc]
    if not best_states:
        raise AssertionError("no state holds the best validation AUC")

    t0 = time.perf_counter()
    scorer = run_scoring_driver([
        "--input-data-dirs", val,
        "--game-model-input-dir", os.path.join(out, "best"),
        "--output-dir", score_out,
        "--feature-shard-id-to-feature-section-keys-map", DRIVER_SECTIONS,
        "--random-effect-id-set", "userId", "--evaluator-type", "AUC",
        "--device", str(dev)])
    scoring_driver_secs = time.perf_counter() - t0
    if scorer["ingest_parts"] != {"native_parts": FIXTURE_PARTS[1],
                                  "declined_parts": 0, "records_parts": 0}:
        raise AssertionError(f"the scoring driver's ingest left the native "
                             f"path: {scorer['ingest_parts']}")
    scored = load_scored_items(os.path.join(score_out, "scores",
                                            "part-00000.avro"))
    scores = np.asarray([r["predictionScore"] for r in scored])
    if scores.shape != (rows[1],) or not np.isfinite(scores).all():
        raise AssertionError("scored rows are missing or not finite")
    # the library's score of the reloaded model on the same dataset
    model, maps = load_scoring_model(os.path.join(out, "best"), {})
    sections = {k: [v] for k, v in (x.split(":") for x in
                                    DRIVER_SECTIONS.split("|"))}
    vdata = tdf.load_game_dataset_avro(val, sections, maps,
                                       id_types=["userId"],
                                       response_required=False)
    lib = model.score(vdata, device=dev).cpu().numpy().astype(np.float64)
    del vdata
    score_gap = float(np.abs(lib - scores).max())
    if not score_gap <= 1e-5:
        raise AssertionError(f"scoring driver vs library score: "
                             f"{score_gap:.3g}")
    auc_gap = abs(scorer["metrics"]["AUC"] - best_auc)
    if not auc_gap <= 1e-6:
        raise AssertionError(f"scoring driver AUC {scorer['metrics']['AUC']}"
                             f" != best validation AUC {best_auc}")

    # the final model's per-user scores on the validation rows: the
    # O(nnz) form against the dense one (best/ may hold an earlier state)
    re_scoring = random_effect_scoring(
        trainer.best_result.model.models["perUser"].to_raw(),
        trainer.validate_data)
    if not re_scoring["nnz"] or not re_scoring["onnz_nonzero_rows"]:
        raise AssertionError(f"the per-user scoring check scored "
                             f"nothing: {re_scoring}")

    # one training part through both ingest paths: the same dataset
    part = os.path.join(train, "part-00000.avro")
    load_args = ([part], trainer.section_keys, trainer.index_maps)
    t0 = time.perf_counter()
    native = tdf.load_game_dataset_avro(*load_args, id_types=["userId"])
    native_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = tdf.load_game_dataset_records(*load_args, id_types=["userId"])
    records_secs = time.perf_counter() - t0
    if not datasets_equal(native, plain):
        raise AssertionError("native and records ingest of one part differ")
    one_part = {"rows": int(native.num_samples), "native_secs": native_secs,
                "records_secs": records_secs,
                "records_over_native": records_secs / native_secs,
                "datasets_equal": True}
    del native, plain

    # the kernel on the driver's own fixed-effect batch, against its plain
    # version (after the counts were read)
    fe = build_fixed_effect_dataset(trainer.train_data, "global",
                                    device=dev)
    X = fe.batch.X
    expected = pk.kernel_path(X.shape[1], X.dtype, X.data_ptr() % 16 == 0)
    w_fe = trainer.best_result.model.models["fixed"].model.coefficients \
        .means.to(dev).contiguous()
    check = None
    if dev.type == "cuda":
        err, worst = check_sums(
            torch, get_loss("logistic"), X, fe.batch.labels,
            fe.batch.offsets, fe.batch.weights, w_fe,
            torch.zeros((), device=dev), scaled=True)
        check = {"shape": list(X.shape), "path": expected,
                 "max_abs_err": err, "worst_delta_over_tolerance": worst}
    secs = trainer.phase_seconds
    phase = {
        "phase": "driver", "nvidia_smi": smi,
        "rows": {"train": rows[0], "validate": rows[1]},
        "reduced": {"sweeps": 2,
                    "why": "depth only: two coordinate-descent sweeps"},
        "fixture_parts": list(FIXTURE_PARTS),
        "users": n_users, "movies": n_movies, "d_global": d_global,
        "fixed_effect_columns": int(X.shape[1]),
        "avro_write_secs": avro_write_secs,
        "feature_map_secs": secs["prepareFeatureMaps"],
        "load_secs": secs["prepareGameDataSet"],
        "train_secs": secs["train grid[0]"],
        "train_secs_per_update": [s["seconds"] for s in states],
        "model_write_secs": secs["saveModels"],
        "training_driver_secs": driver_secs,
        "training_ingest_parts": train_ingest,
        "score_secs": scorer["phase_seconds"],
        "scoring_driver_secs": scoring_driver_secs,
        "scoring_ingest_parts": scorer["ingest_parts"],
        "scoring_driver_max_rss_bytes": scorer["max_rss_bytes_after"]["end"],
        "scoring_driver_max_rss_bytes_after": scorer["max_rss_bytes_after"],
        "scoring_driver_ru_maxrss_bytes": scorer["ru_maxrss_bytes"],
        "rss_bytes_when_scoring_driver_started": scorer["parent_rss_bytes"],
        "one_part_records_vs_native": one_part,
        "random_effect_scoring": re_scoring,
        "objectives": [s["objective"] for s in states],
        "validation_metrics": [s["validation_metrics"] for s in states],
        "best_metric": best_auc,
        "scoring_driver_auc": scorer["metrics"]["AUC"],
        "score_vs_library_max_abs": score_gap,
        "kernel_launches": launches, "launches_by_path": by_path,
        "launches_by_loss": by_loss, "expected_path": expected,
        "max_memory_allocated": peak,
        "kernel_check": check,
    }
    print("driver phase: " + json.dumps(phase), file=sys.stderr, flush=True)
    if dev.type == "cuda" and (launches <= 0
                               or by_path[expected] != launches):
        raise AssertionError(f"the driver's fixed effect did not launch "
                             f"the kernel on the {expected} path: {by_path}")
    # the fixture stays for phases 8 and 9, with the feature sets
    feature_sets = save_feature_sets(trainer.index_maps,
                                     os.path.join(workdir, "feature_sets"))
    for d in (out, score_out):
        shutil.rmtree(d, ignore_errors=True)
    return phase, launches, by_path, check, (train, val, feature_sets)


def save_feature_sets(index_maps, directory) -> str:
    """The (name, term) sets behind the driver's index maps, one section a
    shard as ``DRIVER_SECTIONS`` maps them, saved where
    ``--feature-name-and-term-set-path`` reads them; the maps they give
    must equal the driver's."""
    from photon_ml_tpu_torch.io.data_format import NameAndTermFeatureSets
    from photon_ml_tpu_torch.io.index_map import (INTERCEPT_KEY,
                                                  split_feature_key)

    shards = dict(x.split(":") for x in DRIVER_SECTIONS.split("|"))
    sets = NameAndTermFeatureSets({
        section: {split_feature_key(k) for k, _ in index_maps[shard].items()
                  if k != INTERCEPT_KEY}
        for shard, section in shards.items()})
    for shard, section in shards.items():
        if dict(sets.index_map([section], add_intercept=True).items()) != \
                dict(index_maps[shard].items()):
            raise AssertionError(f"saved feature sets of {shard} do not "
                                 f"give the driver's index map")
    sets.save(directory)
    return directory


def resume_phase(torch, dev, data, want, workdir):
    """Phase 7 (a): the glmix run killed mid-sweep by an injected fault
    and resumed in fresh coordinates from its newest snapshot. ``want`` is
    phase 5's final state per coordinate; the resumed run must end on it
    bit for bit. Returns the record and the launches of both segments."""
    from photon_ml_tpu_torch.game.coordinate_descent import (
        HOT_LOOP_STATS, reset_hot_loop_stats, run_coordinate_descent)
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.optimize.config import TaskType
    from photon_ml_tpu_torch.utils import checkpoint as ck
    from photon_ml_tpu_torch.utils import faults

    task = TaskType.LOGISTIC_REGRESSION
    shutil.rmtree(workdir, ignore_errors=True)
    mgr = ck.CheckpointManager(workdir)
    ck.reset_checkpoint_stats()
    reset_hot_loop_stats()
    faults.disarm_all()

    def run(**kw):
        """Two sweeps in fresh coordinates, launch counts zeroed just
        before."""
        coords = glmix_coordinates(data, dev)
        torch.cuda.synchronize()
        pk.reset_launch_count()
        t = time.perf_counter()
        res = run_coordinate_descent(
            coords, 2, task, data.responses, data.weights, data.offsets,
            device=dev, checkpoint_manager=mgr,
            checkpoint_every_coordinates=1, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    faults.arm("cd.update", "raise", tag="1.1")
    try:
        run()
    except faults.InjectedFault:
        pass
    else:
        raise AssertionError("the armed cd.update@1.1 fault did not fire")
    finally:
        faults.disarm_all()
    crash_by_path = dict(pk.fused_value_gradient_sums.launches_by_path)
    saves = dict(ck.CHECKPOINT_STATS)
    fetches = HOT_LOOP_STATS["snapshot_fetches"]
    torch.cuda.empty_cache()
    t = time.perf_counter()
    snap = mgr.restore()
    restore_secs = time.perf_counter() - t
    point = (snap["sweep"], snap["coordinate_index"])
    if point != (1, 1):
        raise AssertionError(f"resume point {point}, expected (1, 1)")
    res, resumed_secs = run(resume_snapshot=snap)
    resumed_by_path = dict(pk.fused_value_gradient_sums.launches_by_path)
    got = {"fixed": res.model.models["fixed"].model.coefficients.means,
           "per-user": res.model.models["per-user"].coefficients_projected}
    equal = {cid: bool(torch.equal(got[cid], want[cid])) for cid in want}
    if not all(equal.values()):
        raise AssertionError(f"resumed final states differ from phase 5's "
                             f"uninterrupted run: {equal}")
    if dev.type == "cuda" and (sum(crash_by_path.values()) <= 0
                               or crash_by_path["staged"] != 0
                               or resumed_by_path["staged"] != 0):
        raise AssertionError(f"resume phase left the stream path: "
                             f"{crash_by_path} / {resumed_by_path}")
    if fetches != saves["saves"]:
        raise AssertionError(f"{fetches} snapshot fetches for "
                             f"{saves['saves']} snapshots")
    shutil.rmtree(workdir, ignore_errors=True)
    return {
        "rows": int(data.num_samples), "resume_point": list(point),
        "snapshot_bytes": saves["bytes"],
        "snapshots_before_kill": saves["saves"],
        "save_secs_mean": saves["save_seconds"] / saves["saves"],
        "snapshot_fetches_before_kill": fetches,
        "restore_secs": restore_secs,
        "resumed_updates": [[s.iteration, s.coordinate_id]
                            for s in res.states],
        "resumed_objective": res.states[-1].objective,
        "resumed_train_secs": resumed_secs,
        "launches_by_path": {"before_kill": crash_by_path,
                             "resumed": resumed_by_path},
        "final_states_equal_phase5": equal,
    }, crash_by_path, resumed_by_path


def drill_phase(dev, workdir, rows=DRILL_ROWS, n_users=6040, n_movies=3706,
                d_global=64):
    """Phase 7 (b): the crash/resume drill through the drivers on the
    card, six processes on an Avro fixture at full width. Returns the
    record, the launches by role and the fixture's (training, validation)
    files, which stay in ``workdir``; raises on any failed check."""
    from photon_ml_tpu_torch.tools import crash_resume_drill as drill

    shutil.rmtree(workdir, ignore_errors=True)
    fixture = os.path.join(workdir, "fixture")
    t = time.perf_counter()
    drill.write_fixture(fixture, rows=rows, n_users=n_users,
                        n_movies=n_movies, d_global=d_global)
    write_secs = time.perf_counter() - t
    record = drill.run_drill(fixture, os.path.join(workdir, "roles"),
                             device=str(dev), timeout=600)
    roles, launches = {}, {}
    for r, v in record["roles"].items():
        w = v["worker"] or {}
        secs = w.get("phase_seconds") or {}
        roles[r] = {"exit": v["exit"], "wall_secs": v["wall_secs"],
                    **{k: w.get(k) for k in (
                        "launches_by_path", "snapshot_bytes", "snapshots",
                        "save_secs", "restore_secs", "phase_seconds",
                        "ingest_parts")},
                    "feature_map_secs": secs.get("prepareFeatureMaps"),
                    "load_secs": secs.get("prepareGameDataSet"),
                    "worker_secs": w.get("wall_secs")}
        if w:
            launches[r] = w["launches_by_path"]
        # a finishing worker read every part through the native path
        if secs and (w["ingest_parts"]["declined_parts"]
                     or w["ingest_parts"]["records_parts"]
                     or not w["ingest_parts"]["native_parts"]):
            raise AssertionError(f"drill {r}: ingest left the native path: "
                                 f"{w['ingest_parts']}")
    ref = record["roles"]["reference"]["worker"]
    shutil.rmtree(os.path.join(workdir, "roles"), ignore_errors=True)
    return {
        "reduced": {"rows": {"train": rows[0], "validate": rows[1],
                             "configuration": 1_000_209},
                    "why": "six driver processes each decode the Avro "
                           "again; the training rows keep the fixed effect "
                           "above the kernel's gate of 2**21 elements"},
        "sweeps": drill.SWEEPS, "fixture_write_secs": write_secs,
        "fixed_effect_columns": ref["fixed_effect_columns"],
        "expected_path": ref["expected_path"], "roles": roles,
        "snapshot_step": record["snapshot_step"],
        "states_compared_after_resume":
            record["states_compared_after_resume"],
        "corrupted_steps": record["corrupted_steps"],
        "drill_secs": record["seconds"],
    }, launches, tuple(os.path.join(fixture, f)
                       for f in ("train.avro", "validate.avro"))


def bench_x_w(n, d):
    """``bench.py:169-172 _data()``'s generator (seed 0), X and w_true."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = (rng.normal(size=d) / np.sqrt(d)).astype(np.float32)
    return rng, X, w_true


def config2_data(n=BIG_SHAPE[0], d=BIG_SHAPE[1]):
    """BASELINE config 2's data: ``bench.py:169-177 _data()`` (seed 0,
    X and w_true), then the linear response y = X w_true + 0.1 N(0, 1),
    its noise drawn next from the same generator."""
    rng, X, w_true = bench_x_w(n, d)
    y = (X @ w_true + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def config3_data(n=CONFIG3_SHAPE[0], d=CONFIG3_SHAPE[1]):
    """BASELINE config 3's data, ``bench.py:398-405`` letter for letter."""
    rng = np.random.default_rng(1)
    X = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    w_true = np.zeros(d, np.float32)
    w_true[: d // 8] = rng.normal(size=d // 8)  # sparse truth for L1
    lam = X @ w_true
    y = rng.poisson(np.exp(np.clip(lam, -6, 3))).astype(np.float32)
    return X, y


def launch_counts() -> dict:
    """The kernel's launches since the last reset, by path and by loss."""
    from photon_ml_tpu_torch.ops import pallas_kernels as pk

    f = pk.fused_value_gradient_sums
    return {"by_path": dict(f.launches_by_path),
            "by_loss": {k: v for k, v in f.launches_by_loss.items() if v}}


def check_launches(run, counts, path, loss, dev) -> None:
    """Every launch of ``run`` on ``path`` with ``loss``, and at least one
    (on the card; CPU tensors launch nothing)."""
    total = sum(counts["by_path"].values())
    if dev.type == "cuda" and (total <= 0 or counts["by_path"][path] != total
                               or counts["by_loss"] != {loss: total}):
        raise AssertionError(f"{run}: launches {counts}, expected all on "
                             f"the {path} path with the {loss} loss")


def solver_counts() -> dict:
    """TRON's work and the solvers' blocking reads since the last reset;
    a CG iteration of the lane-batched loop is one Hessian-vector product
    call for every lane still in CG."""
    from photon_ml_tpu_torch.optimize import common, tron

    t = tron.TRON_STATS
    return {"tron_outer_iterations": t["outer_iterations"],
            "tron_cg_iterations": t["cg_iterations"],
            "hessian_vector_calls": t["cg_iterations"],
            "solver_syncs": common.SOLVER_SYNCS["count"]}


def reset_counts(torch, dev) -> None:
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.optimize import common, tron

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    pk.reset_launch_count()
    tron.reset_tron_stats()
    common.reset_solver_syncs()


def peak_memory(torch, dev):
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def kernel_gated_off():
    """Every fixed-effect evaluation inside takes the plain two-pass form
    (the kernel's element gate raised past any shape)."""
    from photon_ml_tpu_torch.ops import pallas_kernels as pk

    saved = pk.MIN_PALLAS_ELEMENTS
    pk.MIN_PALLAS_ELEMENTS = 1 << 62
    try:
        yield
    finally:
        pk.MIN_PALLAS_ELEMENTS = saved


def config2_phase(torch, dev, shape=BIG_SHAPE):
    """Phase 8 (a): BASELINE config 2 at ``bench.py``'s shape: linear
    regression, TRON + L2 (lambda 1, 15 iterations, tol 1e-5) through
    ``GLMOptimizationProblem.run`` with variances; the solution against a
    solve with the kernel gated off."""
    from photon_ml_tpu_torch.data.batch import dense_batch
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem

    t0 = time.perf_counter()
    X, y = config2_data(*shape)
    batch = dense_batch(X, y, device=dev)
    del X
    sync(torch, dev)
    data_secs = time.perf_counter() - t0
    path = pk.kernel_path(shape[1], torch.float32,
                          batch.X.data_ptr() % 16 == 0)
    problem = GLMOptimizationProblem(
        config=GLMOptimizationConfiguration.parse("15,1e-5,1,1,TRON,L2"),
        task=TaskType.LINEAR_REGRESSION, compute_variances=True)

    def solve(plain):
        """One timed solve; ``plain`` gates the kernel off."""
        t0 = time.perf_counter()
        if plain:
            with kernel_gated_off():
                out = problem.run(batch)
        else:
            out = problem.run(batch)
        sync(torch, dev)
        return out, time.perf_counter() - t0

    # a solve each way first (the first calls' lazy set-up), then the
    # kernel's solve with the counts zeroed just before and read just
    # after, then both in turns (kernel, plain, plain, kernel)
    first_secs = {"kernel": solve(False)[1], "plain": solve(True)[1]}
    reset_counts(torch, dev)
    (model, result), _ = solve(False)
    counts, work = launch_counts(), solver_counts()
    peak = peak_memory(torch, dev)
    times = {False: [], True: []}
    for plain in (False, True, True, False):
        (m, r), secs = solve(plain)
        times[plain].append(secs)
        if plain:
            plain_model, plain_result = m, r
    check_launches("config 2", counts, path, "squared", dev)
    values = result.values
    if not np.all(np.isfinite(values)) or np.any(np.diff(values) > 0):
        raise AssertionError(f"config 2: TRON's accepted values rose or "
                             f"are not finite: {values.tolist()}")
    var = model.coefficients.variances
    if var is None or not bool(torch.isfinite(var).all()) \
            or not bool((var > 0).all()):
        raise AssertionError("config 2: variances missing, not finite or "
                             "not positive")
    w, w_plain = model.coefficients.means, plain_model.coefficients.means
    rel = float((w - w_plain).norm() / w_plain.norm())
    if not rel <= 1e-4:
        raise AssertionError(f"config 2: kernel and plain-path solutions "
                             f"differ (rel {rel:.3g})")
    del batch
    return {
        "shape": list(shape), "data": "bench.py:169-177 _data() (seed 0) "
        "X and w_true; y = X w_true + 0.1 N(0, 1)",
        "config": "LINEAR_REGRESSION, TRON + L2, lambda 1, 15 iterations, "
                  "tol 1e-5, compute_variances",
        "data_secs": data_secs, "first_solve_secs": first_secs,
        "solve_secs": float(np.mean(times[False])),
        "solve_secs_turns": times[False],
        "iterations": result.iterations,
        "convergence": result.convergence_reason.value,
        "values": values.tolist(), "launches": counts, "path": path,
        **work, "max_memory_allocated": peak,
        "variances_finite_positive": True,
        "variance_range": [float(var.min()), float(var.max())],
        "plain_path": {"solve_secs": float(np.mean(times[True])),
                       "solve_secs_turns": times[True],
                       "iterations": plain_result.iterations,
                       "value": plain_result.value,
                       "rel_l2_diff_to_kernel_solution": rel},
        "value": result.value,
    }


def config3_phase(torch, dev, shape=CONFIG3_SHAPE, reps=3):
    """Phase 8 (b): BASELINE config 3 at ``bench.py:386-425``'s recipe,
    letter for letter: Poisson, elastic net (alpha 0.5, lambda 1), L-BFGS
    so OWL-QN, 50 iterations, tol 1e-7; one warm solve, then ``reps``
    timed (``solve_ms``), ``iterations`` and ``nnz_coefficients`` as
    ``bench.py`` reports them; then one solve with the kernel gated off,
    which must stop after as many iterations with the same exact zeros
    and a solution within rel 1e-4."""
    from photon_ml_tpu_torch.data.batch import dense_batch
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, OptimizerType, RegularizationContext,
        RegularizationType, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem

    X, y = config3_data(*shape)
    batch = dense_batch(X, y, device=dev)
    path = pk.kernel_path(shape[1], torch.float32,
                          batch.X.data_ptr() % 16 == 0)
    cfg = GLMOptimizationConfiguration(
        max_iterations=50, tolerance=1e-7, regularization_weight=1.0,
        optimizer_type=OptimizerType.LBFGS,
        regularization_context=RegularizationContext(
            RegularizationType.ELASTIC_NET, alpha=0.5))
    problem = GLMOptimizationProblem(config=cfg,
                                     task=TaskType.POISSON_REGRESSION)
    problem.run(batch)  # warm
    reset_counts(torch, dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        model, result = problem.run(batch)
    sync(torch, dev)
    dt = (time.perf_counter() - t0) / reps
    counts, work = launch_counts(), solver_counts()
    t0 = time.perf_counter()
    with kernel_gated_off():
        plain_model, plain_result = problem.run(batch)
    sync(torch, dev)
    plain_secs = time.perf_counter() - t0
    check_launches("config 3", counts, path, "poisson", dev)
    means = model.coefficients.means
    if not bool(torch.isfinite(means).all()) \
            or not np.all(np.isfinite(result.values)):
        raise AssertionError("config 3: non-finite coefficients or values")
    plain = plain_model.coefficients.means
    rel = float((means - plain).norm() / plain.norm())
    same_zeros = bool(torch.equal(means == 0, plain == 0))
    if plain_result.iterations != result.iterations or not same_zeros \
            or not rel <= 1e-4:
        raise AssertionError(
            f"config 3: the plain path's solve differs: iterations "
            f"{plain_result.iterations} vs {result.iterations}, same zeros "
            f"{same_zeros}, rel {rel:.3g}")
    return {
        "shape": list(shape), "data": "bench.py:398-405 (seed 1)",
        "config": "POISSON_REGRESSION, LBFGS + ELASTIC_NET (OWL-QN), "
                  "alpha 0.5, lambda 1, 50 iterations, tol 1e-7",
        "solve_ms": dt * 1e3, "reps": reps,
        "iterations": result.iterations,
        "convergence": result.convergence_reason.value,
        "nnz_coefficients": int((means.abs() > 1e-8).sum()),
        "exact_zeros": int((means == 0).sum()), "value": result.value,
        "launches": counts, "path": path,
        "solver_syncs_per_solve": work["solver_syncs"] / reps,
        "plain_path": {"solve_secs": plain_secs,
                       "iterations": plain_result.iterations,
                       "value": plain_result.value,
                       "same_exact_zeros": same_zeros,
                       "rel_l2_diff_to_kernel_solution": rel},
    }


def second_order_driver_phase(torch, dev, train, val, feature_sets,
                              workdir):
    """Phase 8 (c): the drivers on phase 6's fixture and feature sets with
    the second-order argvs (two sweeps, 4 buckets, per-user cap 128), then
    the scoring driver on the Poisson run's ``best/``. Returns the record
    and the launches by run."""
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.tools.crash_resume_drill import driver_argv
    from photon_ml_tpu_torch.tools.glmix_cases import (
        GLMIX_CASES, SECOND_ORDER_CASES)

    runs, launches, problems = {}, {}, []
    loss_of = {"linear_tron": "squared", "poisson_enet": "poisson"}
    for case in SECOND_ORDER_CASES:
        extra = GLMIX_CASES[case].argv()
        out = os.path.join(workdir, case)
        argv = driver_argv(train, val, out, str(dev), extra=[
            *extra, "--feature-name-and-term-set-path", feature_sets])
        reset_counts(torch, dev)
        t0 = time.perf_counter()
        trainer = ttd.run(argv)
        sync(torch, dev)
        secs = time.perf_counter() - t0
        counts, work = launch_counts(), solver_counts()
        peak = peak_memory(torch, dev)
        # the fixed effect's columns: the global features + the intercept
        path = pk.kernel_path(len(trainer.index_maps["global"]),
                              torch.float32, True)
        launches[case] = counts
        record = json.load(open(os.path.join(out, "metrics.json")))
        (grid,) = record["grid"]
        states = grid["states"]
        sweep_obj = [[s["objective"] for s in states
                      if s["iteration"] == it][-1] for it in range(2)]
        fixed_values = [s.tracker.result.values.tolist()
                        for s in trainer.best_result.states
                        if s.coordinate_id == "fixed"]
        # every check is run, the failures raised after the record prints
        try:
            check_launches(f"driver {case}", counts, path, loss_of[case],
                           dev)
        except AssertionError as e:
            problems.append(str(e))
        objs = [s["objective"] for s in states]
        # A fixed-effect update sees every row, so it never raises the
        # objective. A per-user update sees only the entity's active rows
        # (the cap of 128) and can raise it through the passive rows, in
        # the JAX package's drivers as in the port's: the sweep-end
        # objectives are recorded, not required to fall.
        fixed_rose = [i for i, st in enumerate(states)
                      if i and st["coordinate"] == "fixed"
                      and not objs[i] <= objs[i - 1] * (1 + 1e-6)]
        if not all(o is not None and np.isfinite(o) for o in objs):
            problems.append(f"{case}: non-finite objective {objs}")
        elif fixed_rose:
            problems.append(f"{case}: a fixed-effect update raised the "
                            f"objective: {objs}")
        if case == "linear_tron" and any(
                np.any(np.diff(v) > 0) for v in fixed_values):
            problems.append(f"{case}: TRON's accepted values rose: "
                            f"{fixed_values}")
        updates = len(states)
        runs[case] = {
            "argv_extra": extra, "training_driver_secs": secs,
            "phase_seconds": trainer.phase_seconds,
            "secs_per_update": [s["seconds"] for s in states],
            "objectives": objs, "sweep_end_objectives": sweep_obj,
            "sweep_end_rose": bool(sweep_obj[1] > sweep_obj[0]),
            "validation_metrics": [s["validation_metrics"] for s in states],
            "convergence_counts": [s["convergence_counts"] for s in states],
            "fixed_effect_iterations": [len(v) - 1 for v in fixed_values],
            "best_metric": record["best"]["metric"],
            "launches": counts, "expected_path": path, **work,
            "solver_syncs_per_update": work["solver_syncs"] / updates,
            "max_memory_allocated": peak}
        del trainer

    best = os.path.join(workdir, "poisson_enet", "best")
    score_out = os.path.join(workdir, "poisson_score")
    t0 = time.perf_counter()
    scorer = run_scoring_driver([
        "--input-data-dirs", val, "--game-model-input-dir", best,
        "--output-dir", score_out,
        "--feature-shard-id-to-feature-section-keys-map", DRIVER_SECTIONS,
        "--random-effect-id-set", "userId",
        "--evaluator-type", "POISSON_LOSS", "--device", str(dev)])
    scoring_secs = time.perf_counter() - t0
    want = runs["poisson_enet"]["best_metric"]
    got = scorer["metrics"]["POISSON_LOSS"]
    if not abs(got - want) <= 1e-6 * abs(want):
        problems.append(f"scoring driver POISSON_LOSS {got} != best "
                        f"validation POISSON_LOSS {want}")
    shutil.rmtree(workdir, ignore_errors=True)
    record = {"runs": runs, "scoring_driver_secs": scoring_secs,
              "scoring_driver_poisson_loss": got,
              "scoring_phase_seconds": scorer["phase_seconds"]}
    print("second-order drivers: " + json.dumps(record), file=sys.stderr,
          flush=True)
    if problems:
        raise AssertionError("; ".join(problems))
    return record, launches


def second_order_small_vs_cpu(torch, n=40_000, users=500, movies=300,
                              card="cuda"):
    """Phase 8 (d): a small GLMix of each new solver on the ``card`` and on
    the CPU (as phase 5's ``glmix_small_vs_cpu``); objectives agree to
    rel 1e-4. Returns the record and the card's launches by case."""
    from photon_ml_tpu_torch.game.coordinate_descent import (
        run_coordinate_descent)
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.ops.losses import get_loss
    from photon_ml_tpu_torch.optimize.config import TASK_LOSS_NAME, TaskType
    from photon_ml_tpu_torch.tools.glmix_cases import (
        GLMIX_CASES, SECOND_ORDER_CASES)

    small = movielens_data(np.random.default_rng(3), n, users, movies, 64)
    out, launches = {}, {}
    for case in SECOND_ORDER_CASES:
        task = TaskType[GLMIX_CASES[case].task]
        objs = {}
        for where in ("cpu", card):
            dev = torch.device(where)
            coords = glmix_coordinates(small, dev, active_cap=32,
                                       feature_cap=32, case=case)
            reset_counts(torch, dev)
            res = run_coordinate_descent(
                coords, 2, task, small.responses, small.weights,
                small.offsets, device=dev)
            objs[where] = [s.objective for s in res.states]
            if where == card:
                launches[case] = launch_counts()
                X = coords["fixed"].dataset.batch.X
                check_launches(f"small GLMix {case}", launches[case],
                               pk.kernel_path(X.shape[1], X.dtype,
                                              X.data_ptr() % 16 == 0),
                               get_loss(TASK_LOSS_NAME[task]).name, dev)
        rel = max(abs(a - b) / abs(a) for a, b in zip(objs["cpu"],
                                                      objs[card]))
        if not rel <= 1e-4 or not np.all(np.isfinite(objs[card])):
            raise AssertionError(f"small GLMix {case}: card and CPU "
                                 f"objectives differ (rel {rel:.3g}): "
                                 f"{objs}")
        out[case] = {"objectives_cpu": objs["cpu"],
                       "objectives_card": objs[card],
                       "max_rel_diff": rel, "launches": launches[case]}
    return out, launches


def trace_device_busy_us(prof) -> float | None:
    """Device busy time of a ``torch.profiler`` trace: the union of its
    kernel, memcpy and memset intervals; None when it holds none."""
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name)).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo


def per_user_profile(torch, dev, dataset, extra_scores, reps=2):
    """Satellite of phase 8: one per-user update of each solver on phase
    5's per-user coordinate (1,000,209 rows, 4 buckets), under
    ``torch.profiler``: wall seconds, device busy time, the device's idle
    share and the solvers' blocking reads."""
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
    from photon_ml_tpu_torch.game.random_effect import (
        RandomEffectOptimizationProblem)
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.tools.glmix_cases import GLMIX_CASES

    out = {}
    for case, glmix in GLMIX_CASES.items():
        coord = RandomEffectCoordinate(
            dataset=dataset, problem=RandomEffectOptimizationProblem(
                config=GLMOptimizationConfiguration.parse(glmix.per_user),
                task=TaskType[glmix.task]))
        coord.update(None, extra_scores)  # warm: allocator, handles
        sync(torch, dev)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            coord.update(None, extra_scores)
            sync(torch, dev)
            walls.append(time.perf_counter() - t0)
        reset_counts(torch, dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, tracker = coord.update(None, extra_scores)
            sync(torch, dev)
            wall = time.perf_counter() - t0
        work = solver_counts()
        busy_us = trace_device_busy_us(prof)
        it = tracker.materialize().iterations
        out[case] = {
            "config": f"{glmix.task}, perUser:{glmix.per_user}",
            "wall_secs_unprofiled": walls, "wall_secs_profiled": wall,
            "device_busy_secs": None if busy_us is None else busy_us / 1e6,
            # idle share of the profiled window, and with the same busy
            # time over the unprofiled wall (the profiler slows the host)
            "device_idle_share": (None if busy_us is None
                                  else 1.0 - busy_us / 1e6 / wall),
            "device_idle_share_unprofiled_wall": (
                None if busy_us is None
                else 1.0 - busy_us / 1e6 / float(np.mean(walls))),
            **work, "entities": int(len(it)),
            "iterations_max": int(it.max()),
            "iterations_mean": float(it.mean()),
            "convergence": tracker.counts_by_convergence()}
    return out


def fresh_coordinates(coords, lane_chunk=0, down_sampling_rate=None):
    """New coordinate objects over ``coords``' datasets and configs (update
    counts and chunk tuners start anew): ``lane_chunk`` for every random
    effect, ``down_sampling_rate`` for the fixed effect."""
    import dataclasses

    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate, RandomEffectCoordinate)
    from photon_ml_tpu_torch.game.random_effect import ChunkAutoTuner

    out = {}
    for cid, c in coords.items():
        if isinstance(c, FixedEffectCoordinate):
            problem = c.problem
            if down_sampling_rate is not None:
                problem = dataclasses.replace(problem, config=(
                    dataclasses.replace(problem.config,
                                        down_sampling_rate=(
                                            down_sampling_rate))))
            out[cid] = FixedEffectCoordinate(dataset=c.dataset,
                                             problem=problem)
        else:
            out[cid] = RandomEffectCoordinate(
                dataset=c.dataset, problem=dataclasses.replace(
                    c.problem, lane_compaction_chunk=lane_chunk,
                    chunk_tuner=ChunkAutoTuner()))
    return out


def final_states(res) -> dict:
    return {cid: (m.model.coefficients.means if hasattr(m, "model")
                  else m.coefficients_projected)
            for cid, m in res.model.models.items()}


def runs_equal(torch, a, b, data, dev) -> dict:
    """Objectives, final states and training scores of two runs, each
    compared bit for bit."""
    sa, sb = final_states(a), final_states(b)
    return {
        "objectives": ([s.objective for s in a.states]
                       == [s.objective for s in b.states]),
        "states": {cid: bool(torch.equal(sa[cid], sb[cid])) for cid in sa},
        "scores": bool(torch.equal(a.model.score(data, device=dev),
                                   b.model.score(data, device=dev)))}


def all_equal(eq: dict) -> bool:
    return eq["objectives"] and all(eq["states"].values()) and eq["scores"]


def cd_run(torch, dev, data, coords, **kw):
    """Two sweeps of ``coords`` with the launch, hot-loop and solver counts
    zeroed just before; returns the result, its seconds and counts."""
    from photon_ml_tpu_torch.game.coordinate_descent import (
        HOT_LOOP_STATS, reset_hot_loop_stats, run_coordinate_descent)
    from photon_ml_tpu_torch.optimize.config import TaskType

    reset_counts(torch, dev)
    reset_hot_loop_stats()
    t0 = time.perf_counter()
    res = run_coordinate_descent(
        coords, 2, TaskType.LOGISTIC_REGRESSION, data.responses,
        data.weights, data.offsets, device=dev, **kw)
    sync(torch, dev)
    return res, {"secs": time.perf_counter() - t0,
                 "hot_loop": dict(HOT_LOOP_STATS),
                 "launches": launch_counts(), **solver_counts()}


def lane_count_dependence(torch, dataset, lane_counts=(1, 7, 16, 100)):
    """Phase 9 (b): does a lane's result depend on how many lanes share the
    dispatch? At each per-user bucket's shape and at 700 lanes of 128 rows
    of 2-128 features, on random dense blocks (the buckets' one-hot rows
    sum exactly in any order, so they could not show it): the margins and
    the gradient's row sum of gathered lanes against the same lanes of
    the full dispatch, through ``einsum`` (a batched GEMM), through
    ``DenseBatch`` (the port's elementwise product and ``sum``), and
    through ``DenseBatch`` with the lanes padded as lane compaction pads
    them (``padded_lane_count``). Returns, per shape and form, the lane
    counts whose lanes differ in any bit."""
    from photon_ml_tpu_torch.data.batch import DenseBatch
    from photon_ml_tpu_torch.optimize.common import padded_lane_count

    def forms(X, w, r, port_only=False):
        zero = torch.zeros_like(r)
        b = DenseBatch(X, zero, zero, zero)
        out = {"port_margins": b.margins(w, zero[:, 0]),
               "port_gradient_sum": b.weighted_feature_sum(r)}
        if not port_only:
            out.update(einsum_margins=torch.einsum("end,ed->en", X, w),
                       einsum_gradient_sum=torch.einsum("end,en->ed", X, r))
        return out

    out = {}
    gen = torch.Generator(device="cpu").manual_seed(0)
    dev = dataset.buckets[0].X.device
    # the buckets' shapes, then a grid of widths at 700 lanes of 128 rows
    shapes = [tuple(b.X.shape) for b in dataset.buckets] + [
        (700, 128, d) for d in (2, 4, 8, 16, 32, 64, 128)]
    for e, n, d in shapes:
        X = torch.randn(e, n, d, generator=gen).to(dev)
        w = torch.randn(e, d, generator=gen).to(dev)
        r = torch.randn(e, n, generator=gen).to(dev)
        full = forms(X, w, r)
        rng = np.random.default_rng(e)
        differ = {k: [] for k in (*full, "padded_margins",
                                  "padded_gradient_sum")}
        counts = (*lane_counts, e // 2) if e != 700 else (1, 2, 4, 8, 16,
                                                          32, 64)
        for k_lanes in sorted({min(c, e) for c in counts}):
            real = np.sort(rng.choice(e, k_lanes, replace=False))
            pad = padded_lane_count(k_lanes, e, d) - k_lanes
            rows = torch.as_tensor(real, device=dev)
            padded = torch.as_tensor(
                np.concatenate([real, real[:1].repeat(pad)]), device=dev)
            part = forms(X[rows], w[rows], r[rows])
            part.update({k.replace("port", "padded"): v[:k_lanes]
                         for k, v in forms(X[padded], w[padded], r[padded],
                                           port_only=True).items()})
            for k in differ:
                ref = full[k.replace("padded", "port")]
                if not torch.equal(part[k], ref[rows]):
                    differ[k].append(k_lanes)
        out[f"{e}x{n}x{d}"] = differ
        del X
    return out


def compaction_profile(torch, dev, dataset, extra_scores):
    """Phase 9 (b): one per-user update of each solver (phase 5's per-user
    coordinate; the per-user configs of phases 5 and 8) as one dispatch,
    with chunk 4 and with the auto-tuned chunk: coefficients, iterations
    and codes bit for bit equal; wall and device busy time (under
    ``torch.profiler``), the solvers' reads and the active lanes of every
    re-dispatched chunk."""
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_tpu_torch.game import random_effect as gre
    from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.tools.glmix_cases import GLMIX_CASES

    out, problems = {}, []
    for case, glmix in GLMIX_CASES.items():
        runs, want = {}, None
        for label, chunk in (("single", 0), ("chunk_4", 4),
                             ("auto", gre.AUTO_COMPACTION_CHUNK)):
            coord = RandomEffectCoordinate(
                dataset=dataset, problem=gre.RandomEffectOptimizationProblem(
                    config=GLMOptimizationConfiguration.parse(
                        glmix.per_user),
                    task=TaskType[glmix.task], lane_compaction_chunk=chunk))
            if want is None:
                coord.update(None, extra_scores)  # warm: allocator, handles
            sync(torch, dev)
            reset_counts(torch, dev)
            gre.reset_solve_stats()
            t0 = time.perf_counter()
            x, tracker = coord.update(None, extra_scores)
            sync(torch, dev)
            wall = time.perf_counter() - t0
            work, stats = solver_counts(), dict(gre.SOLVE_STATS)
            tracker.materialize()
            got = (x, tracker.iterations, tracker.convergence_codes)
            if want is None:
                want = got
            equal = (bool(torch.equal(got[0], want[0]))
                     and np.array_equal(got[1], want[1])
                     and np.array_equal(got[2], want[2]))
            if not equal:
                problems.append(f"{case} {label}: not equal to the single "
                                f"dispatch")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                coord.update(None, extra_scores)
                sync(torch, dev)
                profiled = time.perf_counter() - t0
            busy_us = trace_device_busy_us(prof)
            runs[label] = {
                "wall_secs": wall, "wall_secs_profiled": profiled,
                "device_busy_secs": (None if busy_us is None
                                     else busy_us / 1e6),
                "device_idle_share": (None if busy_us is None
                                      else 1.0 - busy_us / 1e6 / profiled),
                "solver_syncs": work["solver_syncs"],
                "dispatches": stats["dispatches"],
                "chunks": stats["chunks"],
                "redispatched_lanes": stats["lane_counts"],
                "compact_secs": stats["compact_secs"],
                "equal_to_single": equal}
        it = want[1]
        out[case] = {"config": f"{glmix.task}, perUser:{glmix.per_user}",
                     "entities": int(len(it)),
                     "iterations_max": int(it.max()),
                     "iterations_mean": float(it.mean()), "runs": runs}
    return out, problems


def blocked_small_vs_cpu(torch, card, n=40_000, users=500, movies=300):
    """Phase 9 (c): a small GLMix in blocks of two on the ``card`` and on
    the CPU; objectives agree to rel 1e-4."""
    small = movielens_data(np.random.default_rng(3), n, users, movies, 64)
    objs, launches = {}, None
    for where in ("cpu", card):
        d = torch.device(where)
        coords = glmix_coordinates(small, d, active_cap=32, feature_cap=32)
        res, counts = cd_run(torch, d, small, coords, block_size=2)
        objs[where] = [s.objective for s in res.states]
        if where == card:
            launches = counts["launches"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(objs["cpu"], objs[card]))
    if not rel <= 1e-4 or not np.all(np.isfinite(objs[card])):
        raise AssertionError(f"small blocked GLMix: card and CPU differ "
                             f"(rel {rel:.3g}): {objs}")
    return {"objectives_cpu": objs["cpu"], "objectives_card": objs[card],
            "max_rel_diff": rel, "launches": launches}, launches


def blocked_resume(torch, dev, data, coords, want, workdir):
    """Phase 9 (d): blocks of two, pipelined, a snapshot at every
    coordinate and ``cd.update@1.1`` raising inside sweep 1's block; fresh
    coordinates resume from the restored snapshot and must end
    ``array_equal`` to the uninterrupted blocked run ``want``."""
    from photon_ml_tpu_torch.utils import checkpoint as ck
    from photon_ml_tpu_torch.utils import faults

    shutil.rmtree(workdir, ignore_errors=True)
    mgr = ck.CheckpointManager(workdir)
    kw = dict(block_size=2, pipeline_depth=1, checkpoint_manager=mgr,
              checkpoint_every_coordinates=1)
    faults.disarm_all()
    faults.arm("cd.update", "raise", tag="1.1")
    try:
        cd_run(torch, dev, data, fresh_coordinates(coords), **kw)
    except faults.InjectedFault:
        pass
    else:
        raise AssertionError("the armed cd.update@1.1 fault did not fire")
    finally:
        faults.disarm_all()
    crash_launches = launch_counts()
    indices = sorted({mgr.restore(step=s)["coordinate_index"]
                      for s in mgr.all_steps()})
    snap = mgr.restore()
    point = (snap["sweep"], snap["coordinate_index"])
    if point != (1, 0) or indices != [0]:
        raise AssertionError(f"blocked snapshots at {indices}, resume "
                             f"point {point}: expected block boundaries "
                             f"only, resuming at (1, 0)")
    res, counts = cd_run(torch, dev, data, fresh_coordinates(coords),
                         resume_snapshot=snap, **kw)
    eq = runs_equal(torch, res, want, data, dev)
    eq["objectives"] = ([s.objective for s in res.states]
                        == [s.objective for s in want.states][2:])
    shutil.rmtree(workdir, ignore_errors=True)
    if not all_equal(eq):
        raise AssertionError(f"the resumed blocked run differs: {eq}")
    return {"resume_point": list(point), "snapshot_indices": indices,
            "equal_to_uninterrupted": eq, "resumed_secs": counts["secs"],
            "launches": {"before_raise": crash_launches,
                         "resumed": counts["launches"]}}, \
        {"before_raise": crash_launches, "resumed": counts["launches"]}


def down_sampling_check(torch, dev, data, coords):
    """Phase 9 (e): the fixed effect at rate 0.5 (logistic: the binary
    sampler). The weights sampled on the card equal the CPU's for the
    same keys; two sweeps run finite."""
    from photon_ml_tpu_torch.sampler.samplers import (
        binary_classification_down_sample)
    from photon_ml_tpu_torch.utils.prng import PRNGKey

    batch = coords["fixed"].dataset.batch
    host = batch._replace(X=batch.X[:1].cpu(), labels=batch.labels.cpu(),
                          offsets=batch.offsets.cpu(),
                          weights=batch.weights.cpu())
    keys = {}
    for seed in (0, 1):
        card = binary_classification_down_sample(batch, 0.5, PRNGKey(seed))
        cpu = binary_classification_down_sample(host, 0.5, PRNGKey(seed))
        w = card.weights.cpu()
        if not torch.equal(w, cpu.weights):
            raise AssertionError(f"down-sampled weights, key {seed}: card "
                                 f"and CPU differ")
        neg = host.labels <= 0.5
        keys[seed] = {"kept_negative_share": float(
            (w[neg] > 0).double().mean()), "weights_equal": True}
    sampled = fresh_coordinates(coords, down_sampling_rate=0.5)
    res, counts = cd_run(torch, dev, data, sampled)
    objs = [s.objective for s in res.states]
    if not np.all(np.isfinite(objs)) or sampled["fixed"]._update_count != 2:
        raise AssertionError(f"down-sampled sweeps: objectives {objs}, "
                             f"{sampled['fixed']._update_count} updates")
    check_launches("down-sampled GLMix", counts["launches"], "stream",
                   "logistic", dev)
    return {"rate": 0.5, "keys": keys, "objectives": objs,
            "secs": counts["secs"], "launches": counts["launches"]}, \
        counts["launches"]


def cd_driver_phase(torch, dev, train, val, workdir):
    """Phase 9 (f): the training driver on the drill's fixture (phase 7
    (b)) with ``CD_EXTENSION_FLAGS`` (pipelined, blocks of two, auto lane
    compaction, the fixed effect down-sampled at 0.5), then the scoring
    driver on its ``best/``."""
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.game import random_effect as gre
    from photon_ml_tpu_torch.game.coordinate_descent import (
        HOT_LOOP_STATS, reset_hot_loop_stats)
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.tools.crash_resume_drill import driver_argv
    from photon_ml_tpu_torch.tools.glmix_cases import CD_EXTENSION_FLAGS

    out = os.path.join(workdir, "train_out")
    argv = driver_argv(train, val, out, str(dev),
                       extra=list(CD_EXTENSION_FLAGS))
    reset_counts(torch, dev)
    reset_hot_loop_stats()
    gre.reset_solve_stats()
    t0 = time.perf_counter()
    trainer = ttd.run(argv)
    sync(torch, dev)
    secs = time.perf_counter() - t0
    counts, hot = launch_counts(), dict(HOT_LOOP_STATS)
    solve = dict(gre.SOLVE_STATS)
    path = pk.kernel_path(len(trainer.index_maps["global"]), torch.float32,
                          True)
    check_launches("driver with the CD extensions", counts, path,
                   "logistic", dev)
    record = json.load(open(os.path.join(out, "metrics.json")))
    (grid,) = record["grid"]
    objs = [s["objective"] for s in grid["states"]]
    if len(objs) != 4 or not all(o is not None and np.isfinite(o)
                                 for o in objs):
        raise AssertionError(f"driver with the CD extensions: objectives "
                             f"{objs}")
    if hot["epilogue_fetches"] * 2 != hot["updates"]:
        raise AssertionError(f"blocks of two: {hot}")
    scorer = run_scoring_driver([
        "--input-data-dirs", val,
        "--game-model-input-dir", os.path.join(out, "best"),
        "--output-dir", os.path.join(workdir, "score_out"),
        "--feature-shard-id-to-feature-section-keys-map", DRIVER_SECTIONS,
        "--random-effect-id-set", "userId", "--evaluator-type", "AUC",
        "--device", str(dev)])
    best = record["best"]["metric"]
    if not abs(scorer["metrics"]["AUC"] - best) <= 1e-6:
        raise AssertionError(f"scoring driver AUC {scorer['metrics']['AUC']}"
                             f" != best validation AUC {best}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {"argv_extra": list(CD_EXTENSION_FLAGS),
            "training_driver_secs": secs,
            "phase_seconds": trainer.phase_seconds,
            "secs_per_update": [s["seconds"] for s in grid["states"]],
            "objectives": objs,
            "validation_metrics": [s["validation_metrics"]
                                   for s in grid["states"]],
            "best_metric": best, "scoring_driver_auc":
                scorer["metrics"]["AUC"],
            "hot_loop": hot, "solve_stats": solve,
            "launches": counts, "expected_path": path}, counts


def cd_extensions_phase(torch, dev, smi, data, coords, fixture, workdir):
    """Phase 9: the coordinate-descent extensions on the card. Returns the
    phase record and the kernel's launches by run."""
    from photon_ml_tpu_torch.game.random_effect import AUTO_COMPACTION_CHUNK

    t_all = time.perf_counter()
    launches, secs, mark = {}, {}, [t_all]

    def lap(part):
        now = time.perf_counter()
        secs[part], mark[0] = now - mark[0], now

    # (a) pipelined against sequential
    seq, seq_counts = cd_run(torch, dev, data, fresh_coordinates(coords),
                             pipeline_depth=0)
    pipe, pipe_counts = cd_run(torch, dev, data, fresh_coordinates(coords),
                               pipeline_depth=1)
    eq = runs_equal(torch, seq, pipe, data, dev)
    if not all_equal(eq):
        raise AssertionError(f"pipelined != sequential: {eq}")
    launches.update(sequential=seq_counts["launches"],
                    pipelined=pipe_counts["launches"])
    pipelined = {"equal": eq,
                 "objectives": [s.objective for s in pipe.states],
                 "sequential": {k: seq_counts[k] for k in (
                     "secs", "hot_loop", "solver_syncs")},
                 "pipelined": {k: pipe_counts[k] for k in (
                     "secs", "hot_loop", "solver_syncs")}}
    print("phase 9 (a): " + json.dumps(pipelined), file=sys.stderr,
          flush=True)
    lap("a")
    # (b) lane compaction, one per-user update of each solver
    extra = coords["fixed"].score(final_states(seq)["fixed"])
    compaction, problems = compaction_profile(
        torch, dev, coords["per-user"].dataset, extra)
    compaction["lane_count_dependence"] = dependence = \
        lane_count_dependence(torch, coords["per-user"].dataset)
    print("phase 9 (b): " + json.dumps(compaction), file=sys.stderr,
          flush=True)
    if any(v["padded_margins"] or v["padded_gradient_sum"]
           for v in dependence.values()):
        problems.append(f"a padded lane's results depend on the lane "
                        f"count: {dependence}")
    if problems:
        raise AssertionError("; ".join(problems))
    lap("b")
    # (c) blocks of two beside the sequential sweep
    blk, blk_counts = cd_run(torch, dev, data, fresh_coordinates(coords),
                             block_size=2)
    objs = [s.objective for s in blk.states]
    hot = blk_counts["hot_loop"]
    if not np.all(np.isfinite(objs)) or \
            hot["epilogue_fetches"] * 2 != hot["updates"]:
        raise AssertionError(f"blocked sweep: objectives {objs}, {hot}")
    small, small_launches = blocked_small_vs_cpu(torch, dev.type)
    launches.update(blocked=blk_counts["launches"],
                    small_blocked_cuda=small_launches)
    blocked = {
        "objectives": objs, "hot_loop": hot, "secs": blk_counts["secs"],
        "sweep_end_objectives": {
            "sequential": [seq.states[1].objective, seq.states[3].objective],
            "blocked": [objs[1], objs[3]]},
        "small_vs_cpu": small}
    lap("c")
    # (d) resume under blocks
    resumed, resume_launches = blocked_resume(
        torch, dev, data, coords, blk, os.path.join(workdir, "ckpt"))
    launches.update({f"blocked_resume_{k}": v
                     for k, v in resume_launches.items()})
    lap("d")
    # (e) down-sampling
    down, down_launches = down_sampling_check(torch, dev, data, coords)
    launches["down_sampled"] = down_launches
    lap("e")
    # (f) the drivers, on the drill's fixture
    driver, driver_launches = cd_driver_phase(
        torch, dev, *fixture, os.path.join(workdir, "driver"))
    launches["driver"] = driver_launches
    lap("f")
    return {"phase": "cd_extensions", "nvidia_smi": smi,
            "rows": int(data.num_samples),
            "auto_compaction_chunk": AUTO_COMPACTION_CHUNK,
            "pipelined": pipelined, "compaction": compaction,
            "blocked": blocked, "blocked_resume": resumed,
            "down_sampling": down, "driver": driver, "part_seconds": secs,
            "seconds": time.perf_counter() - t_all}, launches


# BASELINE config 5 (bench.py:1226 bench_game_full): rows, users, movies,
# global features, the data seed, and the MF scoring pass's latent width
CONFIG5 = dict(n=400_000, users=6040, movies=3706, d_global=32, seed=11,
               latent_dim=8)


def factored_coordinates(data, device, active_cap=128, lane_chunk=0):
    """Phase 10's coordinates: ``fixed`` as in phase 5, and ``perUserFac``,
    a factored random effect over ``userId`` on the 64 global features
    (IDENTITY projection, one block, active cap ``active_cap``) with
    ``FACTORED_CONFIG``. The per-user movie shard cannot carry it: over
    its 3,706 one-hot columns the Kronecker rows would be K x 3,706 =
    29,648 wide, past the kernel's 4,096 and some 92 GB at full width."""
    from photon_ml_tpu_torch.cli.game_training_driver import (
        _parse_factored_grid)
    from photon_ml_tpu_torch.game.coordinate import (
        FactoredRandomEffectCoordinate, FixedEffectCoordinate)
    from photon_ml_tpu_torch.game.dataset import (
        RandomEffectDataConfiguration, build_fixed_effect_dataset,
        build_random_effect_dataset)
    from photon_ml_tpu_torch.game.random_effect import (
        RandomEffectOptimizationProblem)
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.projector.projectors import (
        ProjectorConfig, ProjectorType)
    from photon_ml_tpu_torch.tools.glmix_cases import (
        FACTORED_CONFIG, GLMIX_CASES)

    glmix = GLMIX_CASES["lbfgs"]
    task = TaskType[glmix.task]
    (re_cfg, latent_cfg, mf_cfg), = _parse_factored_grid(
        f"perUserFac:{FACTORED_CONFIG}")[0].values()
    data_cfg = RandomEffectDataConfiguration(
        "userId", "global", num_active_data_points_upper_bound=active_cap,
        projector=ProjectorConfig(ProjectorType.IDENTITY))
    return {
        "fixed": FixedEffectCoordinate(
            dataset=build_fixed_effect_dataset(data, "global",
                                               device=device),
            problem=GLMOptimizationProblem(
                config=GLMOptimizationConfiguration.parse(glmix.fixed),
                task=task)),
        "perUserFac": FactoredRandomEffectCoordinate(
            dataset=build_random_effect_dataset(data, data_cfg,
                                                device=device),
            problem=RandomEffectOptimizationProblem(
                config=re_cfg, task=task, lane_compaction_chunk=lane_chunk),
            latent_problem=GLMOptimizationProblem(config=latent_cfg,
                                                  task=task),
            latent_dim=mf_cfg.num_factors,
            num_inner_iterations=mf_cfg.max_number_iterations)}


def factored_final(res) -> dict:
    """The run's final states: the fixed effect's coefficients and the
    factored coordinate's (coefs, B)."""
    m = res.model.models
    return {"fixed": m["fixed"].model.coefficients.means,
            "perUserFac": (m["perUserFac"].coefficients_latent,
                           m["perUserFac"].projection)}


def factored_equal(torch, a, b, skip: int = 0) -> bool:
    """Two factored runs equal bit for bit: the objectives (of ``b``'s
    updates after its first ``skip``, for a run resumed after them) and
    the final states."""
    fa, fb = factored_final(a), factored_final(b)
    return ([s.objective for s in a.states]
            == [s.objective for s in b.states[skip:]]
            and torch.equal(fa["fixed"], fb["fixed"])
            and all(torch.equal(x, y) for x, y in zip(fa["perUserFac"],
                                                      fb["perUserFac"])))


def factored_run(torch, dev, data, coords, sweeps=2, **kw):
    """Coordinate descent of ``coords`` with the launches counted around
    it: (result, {"launches", "secs", "peak_memory"})."""
    from photon_ml_tpu_torch.game.coordinate_descent import (
        run_coordinate_descent)
    from photon_ml_tpu_torch.optimize.config import TaskType

    reset_counts(torch, dev)
    t0 = time.perf_counter()
    res = run_coordinate_descent(
        coords, sweeps, TaskType.LOGISTIC_REGRESSION, data.responses,
        data.weights, data.offsets, device=dev, **kw)
    sync(torch, dev)
    return res, {"launches": launch_counts(),
                 "secs": time.perf_counter() - t0,
                 "peak_memory": peak_memory(torch, dev)}


def refit_batch(torch, model, fac_dataset, data, dev):
    """The refit's Kronecker batch at a trained factored model (a
    ``GameModel`` with ``fixed`` and ``perUserFac``), the fixed effect's
    scores as the other coordinates', and B flattened."""
    from photon_ml_tpu_torch.game.coordinate import (
        FactoredRandomEffectCoordinate)

    fac = model.models["perUserFac"]
    coord = FactoredRandomEffectCoordinate(
        dataset=fac_dataset, problem=None, latent_problem=None,
        latent_dim=int(fac.coefficients_latent.shape[1]))
    extra = model.models["fixed"].score(data, device=dev)
    batch = coord.kronecker_batch(fac.coefficients_latent,
                                  fac_dataset.offsets_with(extra))
    return batch, fac.projection.reshape(-1).contiguous()


def check_refit(torch, model, fac_dataset, data, dev) -> dict:
    """The kernel against its plain version on the refit's batch at a
    trained factored model: the shape, the largest |delta| of the vector
    sum, the worst tolerance ratio."""
    from photon_ml_tpu_torch.ops.losses import get_loss

    batch, w = refit_batch(torch, model, fac_dataset, data, dev)
    err, worst = check_sums(torch, get_loss("logistic"), batch.X,
                            batch.labels, batch.offsets, batch.weights, w,
                            torch.zeros((), device=dev), scaled=True)
    return {"shape": list(batch.X.shape), "max_abs_err": err,
            "worst_delta_over_tolerance": worst}


def factored_library_phase(torch, dev, data, hbm):
    """Phase 10 (a) and (b): the factored GLMix at full width, then the
    kernel on the refit's real Kronecker batch against its plain version,
    and timed."""
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.ops.losses import get_loss

    t0 = time.perf_counter()
    coords = factored_coordinates(data, dev)
    fac = coords["perUserFac"]
    e, n, d = (int(v) for v in fac.dataset.X.shape)
    k = fac.latent_dim
    sync(torch, dev)
    build_secs = time.perf_counter() - t0
    res, counts = factored_run(
        torch, dev, data, coords,
        logger=lambda s: print(s, file=sys.stderr, flush=True))
    states = res.states
    objs = [s.objective for s in states]
    refit_path = pk.kernel_path(k * d, torch.float32, True)
    by_path = counts["launches"]["by_path"]
    problems = []
    if not all(np.isfinite(objs)):
        problems.append(f"objectives {objs}")
    # a fixed-effect update never raises the objective; a capped per-user
    # update may (its passive rows), as in both packages
    for i, s in enumerate(states):
        if s.coordinate_id == "fixed" and i and \
                not s.objective <= states[i - 1].objective * (1 + 1e-6):
            problems.append(f"fixed-effect update {i} raised the "
                            f"objective: {objs}")
    if dev.type == "cuda" and (
            refit_path != "staged" or by_path["staged"] <= 0
            or by_path["stream"] <= 0
            or counts["launches"]["by_loss"] != {
                "logistic": sum(by_path.values())}):
        # the refit's 2 KB rows take the staged path, the fixed effect's
        # 256-byte rows the stream path
        problems.append(f"launches {counts['launches']}, refit path "
                        f"{refit_path}")
    if problems:
        raise AssertionError("factored GLMix: " + "; ".join(problems))
    updates = [{"sweep": s.iteration, "coordinate": s.coordinate_id,
                "objective": s.objective, "seconds": s.seconds,
                **({"inner": [
                    {"latent_iterations_max": int(np.max(
                        re_t.materialize().iterations)),
                     "refit_iterations": fe_t.materialize()
                     .result.iterations,
                     "refit_value": fe_t.result.value}
                    for re_t, fe_t in s.tracker.inner]}
                   if s.coordinate_id == "perUserFac" else
                   {"iterations": s.tracker.result.iterations})}
               for s in states]
    # (b) the kernel on the refit's batch at the final state, against its
    # plain version, then timed (after the counts were read)
    batch, w = refit_batch(torch, res.model, fac.dataset, data, dev)
    kron_bytes = batch.X.numel() * batch.X.element_size()
    loss = get_loss("logistic")
    zero = torch.zeros((), device=dev)
    err, worst = check_sums(torch, loss, batch.X, batch.labels,
                            batch.offsets, batch.weights, w, zero,
                            scaled=True)
    rows = time_kernel(torch, hbm, loss, batch.X, batch.labels,
                       batch.offsets, batch.weights, w, zero)
    del batch
    torch.cuda.empty_cache()
    return {"rows": int(data.num_samples), "entities": e,
            "rows_per_entity": n, "features": d, "latent_dim": k,
            "passive_rows": fac.dataset.num_passive,
            "build_secs": build_secs, "train_secs": counts["secs"],
            "updates": updates, "objectives": objs,
            "kronecker_shape": [e * n, k * d], "kronecker_bytes": kron_bytes,
            "refit_path": refit_path, "launches": counts["launches"],
            "max_memory_allocated": counts["peak_memory"],
            "kernel_vs_plain": {"max_abs_err": err,
                                "worst_delta_over_tolerance": worst}}, \
        counts["launches"], rows


def factored_small_phase(torch, dev, workdir, n=40_000, users=500,
                         movies=300):
    """Phase 10 (c): a small factored GLMix (active cap 32) on the card and
    on the CPU, objectives within rel 1e-3; on the card depth 0 equal to
    depth 1 bit for bit, and a run killed at update (1, 1) and resumed
    equal to the uninterrupted one bit for bit.

    Not rel 1e-4: each alternation's per-entity solves stop on
    FunctionValuesConverged and its refit after all 20 iterations, so the
    card's and the CPU's reduction orders end them at f32 points apart
    that the next step carries on, while a factored update moves the
    objective up to fivefold. On an NVIDIA H100 80GB HBM3 at 700 W the
    card and the CPU differed by 1.19e-4 here, and the JAX package and
    the port, both on the CPU, differ by more than 1e-4 at this size
    too."""
    from photon_ml_tpu_torch.utils import faults
    from photon_ml_tpu_torch.utils.checkpoint import CheckpointManager

    small = movielens_data(np.random.default_rng(3), n, users, movies, 64)
    objs, launches = {}, {}
    for where in ("cpu", dev):
        coords = factored_coordinates(small, where, 32)
        res, counts = factored_run(torch, torch.device(where), small, coords)
        objs[str(where)] = [s.objective for s in res.states]
    refit_check = check_refit(torch, res.model,
                              coords["perUserFac"].dataset, small, dev)
    card = str(dev)
    rel = max(abs(a - b) / abs(a) for a, b in zip(objs["cpu"], objs[card]))
    depth1, launches["depth1"] = res, counts["launches"]
    depth0, counts = factored_run(torch, dev, small,
                                  factored_coordinates(small, dev, 32),
                                  pipeline_depth=0)
    launches["depth0"] = counts["launches"]
    shutil.rmtree(workdir, ignore_errors=True)
    mgr = CheckpointManager(workdir)
    faults.arm("cd.update", "raise", tag="1.1")
    try:
        factored_run(torch, dev, small, factored_coordinates(small, dev, 32),
                     checkpoint_manager=mgr, checkpoint_every_coordinates=1)
    except faults.InjectedFault:
        pass
    else:
        raise AssertionError("the armed fault did not stop the run")
    finally:
        faults.disarm_all()
    snap = mgr.restore()
    resumed, counts = factored_run(torch, dev, small,
                                   factored_coordinates(small, dev, 32),
                                   resume_snapshot=snap)
    launches["resumed"] = counts["launches"]
    resume_equal = factored_equal(torch, resumed, depth1, skip=3)
    record = {"rows": n, "objectives": objs, "max_rel_diff": rel,
              "depth0_equals_depth1": factored_equal(torch, depth0, depth1),
              "resume_step": [snap["sweep"], snap["coordinate_index"]],
              "resumed_equals_uninterrupted": resume_equal,
              "refit_kernel_vs_plain": refit_check}
    if not (rel <= 1e-3 and record["depth0_equals_depth1"]
            and resume_equal and record["resume_step"] == [1, 1]):
        raise AssertionError(f"small factored GLMix: {record}")
    shutil.rmtree(workdir, ignore_errors=True)
    return record, launches


def factored_driver_phase(torch, dev, train, val, workdir):
    """Phase 10 (d): the training driver with ``FACTORED_FLAGS`` on the
    drill's fixture (the fixed effect and the factored coordinate over the
    64 global features + intercept, so K·D = 520), then the scoring driver
    on its ``best/``: its AUC the best state's, the model a plain
    random-effect directory."""
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.tools.crash_resume_drill import driver_argv
    from photon_ml_tpu_torch.tools.glmix_cases import FACTORED_FLAGS

    out = os.path.join(workdir, "train_out")
    argv = driver_argv(train, val, out, str(dev), extra=list(FACTORED_FLAGS))
    reset_counts(torch, dev)
    t0 = time.perf_counter()
    trainer = ttd.run(argv)
    sync(torch, dev)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    check_launches("factored driver", counts, "staged", "logistic", dev)
    record = json.load(open(os.path.join(out, "metrics.json")))
    (grid,) = record["grid"]
    objs = [s["objective"] for s in grid["states"]]
    if len(objs) != 4 or not all(o is not None and np.isfinite(o)
                                 for o in objs):
        raise AssertionError(f"factored driver: objectives {objs}")
    # the refit's shape at the drivers' width (K·D = 8 x 65), against the
    # plain version, on the dataset the driver built (the same seed)
    from photon_ml_tpu_torch.game.dataset import build_random_effect_dataset

    refit_check = check_refit(
        torch, trainer.best_result.model, build_random_effect_dataset(
            trainer.train_data, trainer.random_data_configs["perUserFac"],
            device=dev), trainer.train_data, dev)
    best_dir = os.path.join(out, "best")
    saved = sorted(os.listdir(os.path.join(best_dir, "random-effect")))
    loaded, _ = load_game_model(best_dir)
    kinds = {c: type(m).__name__ for c, m in loaded.models.items()}
    if saved != ["perUserFac"] or kinds["perUserFac"] != "RandomEffectModel":
        raise AssertionError(f"factored driver saved {saved} as {kinds}")
    # both coordinates read the global shard only
    scorer = run_scoring_driver([
        "--input-data-dirs", val, "--game-model-input-dir", best_dir,
        "--output-dir", os.path.join(workdir, "score_out"),
        "--feature-shard-id-to-feature-section-keys-map",
        "global:globalFeatures",
        "--random-effect-id-set", "userId", "--evaluator-type", "AUC",
        "--device", str(dev)])
    best = record["best"]["metric"]
    if not abs(scorer["metrics"]["AUC"] - best) <= 1e-6:
        raise AssertionError(f"scoring driver AUC {scorer['metrics']['AUC']}"
                             f" != best validation AUC {best}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {"argv_extra": list(FACTORED_FLAGS), "training_driver_secs": secs,
            "phase_seconds": trainer.phase_seconds,
            "secs_per_update": [s["seconds"] for s in grid["states"]],
            "objectives": objs, "best_metric": best,
            "scoring_driver_auc": scorer["metrics"]["AUC"],
            "saved_random_effects": saved, "loaded_as": kinds,
            "refit_kernel_vs_plain": refit_check, "launches": counts}, \
        counts


def config5_phase(torch, dev, workdir, hbm, n=CONFIG5["n"],
                  users=CONFIG5["users"], movies=CONFIG5["movies"]):
    """Phase 10 (e): BASELINE config 5 at ``bench.py:1226``'s parameters
    (fixed + per-user + per-item, one sweep), its fixed effect's kernel
    timed on the real batch, then the MF scoring pass over random factor
    tables: rows per second, equal to a host numpy gather-dot, and equal
    again after a LatentFactorAvro round trip."""
    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate, RandomEffectCoordinate)
    from photon_ml_tpu_torch.game.dataset import (
        RandomEffectDataConfiguration, build_fixed_effect_dataset,
        build_random_effect_dataset)
    from photon_ml_tpu_torch.game.models import (
        MatrixFactorizationModel, score_factors)
    from photon_ml_tpu_torch.game.random_effect import (
        RandomEffectOptimizationProblem)
    from photon_ml_tpu_torch.io.model_io import (
        load_matrix_factorization_model, save_matrix_factorization_model)
    from photon_ml_tpu_torch.ops.losses import get_loss
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem

    t0 = time.perf_counter()
    rng = np.random.default_rng(CONFIG5["seed"])
    data = movielens_data(rng, n, users, movies, CONFIG5["d_global"],
                          with_item_effect=True)
    parse = GLMOptimizationConfiguration.parse
    task = TaskType.LOGISTIC_REGRESSION

    def per_entity(id_type, shard):
        return RandomEffectCoordinate(
            dataset=build_random_effect_dataset(
                data, RandomEffectDataConfiguration(
                    id_type, shard, num_active_data_points_upper_bound=64,
                    num_features_to_keep_upper_bound=64),
                num_buckets=3, device=dev),
            problem=RandomEffectOptimizationProblem(
                config=parse("15,1e-7,1,1,LBFGS,L2"), task=task))

    coords = {
        "fixed": FixedEffectCoordinate(
            dataset=build_fixed_effect_dataset(data, "global", device=dev),
            problem=GLMOptimizationProblem(
                config=parse("30,1e-7,10,1,LBFGS,L2"), task=task)),
        "per-user": per_entity("userId", "per_user"),
        "per-item": per_entity("movieId", "per_item")}
    sync(torch, dev)
    build_secs = time.perf_counter() - t0
    res, counts = factored_run(torch, dev, data, coords, sweeps=1)
    fixed_path = paths_for(coords["fixed"].dataset.batch.X)[0]
    check_launches("config 5", counts["launches"], fixed_path, "logistic",
                   dev)
    objs = [s.objective for s in res.states]
    if not all(np.isfinite(objs)):
        raise AssertionError(f"config 5: objectives {objs}")
    # the fixed effect's batch with the two random effects' scores as
    # offsets, kernel against plain, then timed
    m = res.model.models
    batch = coords["fixed"].dataset.with_offsets(
        coords["per-user"].score(m["per-user"].coefficients_projected)
        + coords["per-item"].score(m["per-item"].coefficients_projected))
    loss, zero = get_loss("logistic"), torch.zeros((), device=dev)
    w = m["fixed"].model.coefficients.means.contiguous()
    err, worst = check_sums(torch, loss, batch.X, batch.labels,
                            batch.offsets, batch.weights, w, zero,
                            scaled=True)
    rows = time_kernel(torch, hbm, loss, batch.X, batch.labels,
                       batch.offsets, batch.weights, w, zero)
    # the MF scoring pass (bench.py:1315-1333): tables drawn next from the
    # same generator, cut to the ids the data holds
    k = CONFIG5["latent_dim"]
    rf = rng.normal(size=(users, k)).astype(np.float32)
    cf = rng.normal(size=(movies, k)).astype(np.float32)
    vocabs = {t: data.id_vocabs[t] for t in ("userId", "movieId")}
    mf = MatrixFactorizationModel(
        "userId", "movieId",
        torch.from_numpy(rf[:len(vocabs["userId"])]).to(dev),
        torch.from_numpy(cf[:len(vocabs["movieId"])]).to(dev))
    scores = mf.score(data, device=dev)
    u, v = data.id_columns["userId"], data.id_columns["movieId"]
    host = np.sum(rf[u] * cf[v], axis=-1)
    mf_err = float(np.abs(scores.cpu().numpy() - host).max())
    r_t = torch.as_tensor(u, device=dev)
    c_t = torch.as_tensor(v, device=dev)
    mf_times = cuda_times(torch, lambda: score_factors(
        mf.row_factors, mf.col_factors, r_t, c_t))
    save_matrix_factorization_model(mf, workdir, entity_vocabs=vocabs)
    back = load_matrix_factorization_model(workdir, "userId", "movieId")
    round_trip_equal = bool(torch.equal(back.score(data, device=dev),
                                        scores))
    shutil.rmtree(workdir, ignore_errors=True)
    record = {
        "rows": n, "users": len(vocabs["userId"]),
        "movies": len(vocabs["movieId"]), "d_global": CONFIG5["d_global"],
        "buckets": {c: [list(b.X.shape) for b in coords[c].dataset.buckets]
                    for c in ("per-user", "per-item")},
        "build_secs": build_secs, "sweep_secs": counts["secs"],
        "objectives": objs,
        "secs_per_update": [s.seconds for s in res.states],
        "launches": counts["launches"], "fixed_path": fixed_path,
        "max_memory_allocated": counts["peak_memory"],
        "kernel_vs_plain": {"max_abs_err": err,
                            "worst_delta_over_tolerance": worst},
        "mf": {"latent_dim": k, "score_ms": mf_times["ms"],
               "rows_per_sec": n / (mf_times["ms"] / 1e3),
               "max_abs_err_vs_host": mf_err,
               "latent_factor_round_trip_equal": round_trip_equal}}
    if not (mf_err <= 1e-5 * max(1.0, float(np.abs(host).max()))
            and round_trip_equal):
        raise AssertionError(f"config 5 MF scoring: {record['mf']}")
    return record, counts["launches"], rows


def factored_phase(torch, dev, smi, data, fixture, workdir, hbm):
    """Phase 10: factored random effects, the drivers with them, and
    BASELINE config 5. Returns the phase record, the kernel's launches by
    run, the kernel-vs-plain errors and the new timing rows."""
    t_all = time.perf_counter()
    secs, mark = {}, [t_all]

    def lap(part):
        now = time.perf_counter()
        secs[part], mark[0] = now - mark[0], now

    library, lib_launches, refit_rows = factored_library_phase(
        torch, dev, data, hbm)
    print("phase 10 (a, b): " + json.dumps(library), file=sys.stderr,
          flush=True)
    lap("a_b")
    small, small_launches = factored_small_phase(
        torch, dev, os.path.join(workdir, "small_ckpt"))
    lap("c")
    driver, driver_launches = factored_driver_phase(
        torch, dev, *fixture, os.path.join(workdir, "driver"))
    lap("d")
    config5, c5_launches, c5_rows = config5_phase(
        torch, dev, os.path.join(workdir, "mf"), hbm)
    lap("e")
    launches = {"library": lib_launches, "driver": driver_launches,
                "config5": c5_launches,
                **{f"small_{k}": v for k, v in small_launches.items()}}
    errs = [library["kernel_vs_plain"]["max_abs_err"],
            small["refit_kernel_vs_plain"]["max_abs_err"],
            driver["refit_kernel_vs_plain"]["max_abs_err"],
            config5["kernel_vs_plain"]["max_abs_err"]]
    return {"phase": "factored", "nvidia_smi": smi, "library": library,
            "small": small, "driver": driver, "config5": config5,
            "timing": [*refit_rows.values(), *c5_rows.values()],
            "part_seconds": secs,
            "seconds": time.perf_counter() - t_all}, launches, errs, \
        [*refit_rows.values(), *c5_rows.values()]


# -- phase 11: the single-GLM path (BASELINE config 1) ----------------------



def config1_data(n=BIG_SHAPE[0], d=BIG_SHAPE[1]):
    """BASELINE config 1's library shape: ``bench.py:169-176 _data()``
    letter for letter (seed 0; X, w_true, then the logistic labels)."""
    rng, X, w_true = bench_x_w(n, d)
    p = 1.0 / (1.0 + np.exp(-(X @ w_true)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return X, y


def write_a1a_like(directory, rows=A1A_ROWS, seed=21) -> tuple:
    """The a1a-shaped LibSVM pair (train, test): each row takes one
    feature of each of the 14 groups (a group is skipped with probability
    0.02, as a1a's rows hold about 14 non-zeros), labels from one fixed
    logistic model over the 123 one-hot columns. Returns the two paths."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    starts = np.cumsum((0,) + A1A_GROUPS[:-1])
    w = rng.normal(size=A1A_FEATURES) * 0.8
    paths = []
    for name, n in zip(("a1a.train", "a1a.test"), rows):
        pick = np.stack([s + rng.integers(0, g, size=n)
                         for s, g in zip(starts, A1A_GROUPS)], axis=1)
        keep = rng.random(pick.shape) >= 0.02
        z = (w[pick] * keep).sum(1) - 1.0
        y = rng.random(n) < 1.0 / (1.0 + np.exp(-z))
        lines = []
        for i in range(n):
            feats = " ".join(f"{j + 1}:1" for j in pick[i][keep[i]])
            lines.append(f"{'+1' if y[i] else '-1'} {feats}")
        path = os.path.join(directory, name)
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        paths.append(path)
    return tuple(paths)


@contextlib.contextmanager
def timed_solves(torch, dev, record: list):
    """Each ``GLMOptimizationProblem.run`` of ``train_glm_grid`` inside
    appends ``(lambda, seconds)`` to ``record``, synchronised."""
    from photon_ml_tpu_torch import training

    cls = training.GLMOptimizationProblem
    saved = cls.run

    def run(self, batch, initial=None):
        t0 = time.perf_counter()
        out = saved(self, batch, initial)
        sync(torch, dev)
        record.append((self.config.regularization_weight,
                       time.perf_counter() - t0))
        return out

    cls.run = run
    try:
        yield
    finally:
        cls.run = saved


def rel_diff(torch, a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def config1_library_phase(torch, dev, shape=BIG_SHAPE):
    """Phase 11 (a): ``train_glm_grid`` at ``bench.py``'s config-1 shape
    (logistic, L-BFGS + L2, lambda 10, 1, 0.1 warm-started, at most 80
    iterations, tol 1e-6: the legacy defaults), against the grid with the
    kernel gated off; ``evaluate_model_grid`` against one call a model;
    a box on the first 16 coordinates with the iterates tracked."""
    from photon_ml_tpu_torch.data.batch import dense_batch
    from photon_ml_tpu_torch.evaluation.model_evaluation import (
        evaluate_model, evaluate_model_grid)
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.optimize.common import BoxConstraints
    from photon_ml_tpu_torch.optimize.config import TaskType
    from photon_ml_tpu_torch.training import train_glm_grid

    t0 = time.perf_counter()
    X, y = config1_data(*shape)
    batch = dense_batch(X, y, device=dev)
    del X
    sync(torch, dev)
    data_secs = time.perf_counter() - t0
    task = TaskType.LOGISTIC_REGRESSION
    path = pk.kernel_path(shape[1], torch.float32,
                          batch.X.data_ptr() % 16 == 0)

    def grid(**kw):
        return train_glm_grid(batch, task, CONFIG1_LAMBDAS,
                              max_iterations=80, tolerance=1e-6, **kw)

    reset_counts(torch, dev)
    per_lambda: list = []
    t1 = time.perf_counter()
    with timed_solves(torch, dev, per_lambda):
        models = grid()
    grid_secs = time.perf_counter() - t1
    counts, work = launch_counts(), solver_counts()
    peak = peak_memory(torch, dev)
    check_launches("config 1 grid", counts, path, "logistic", dev)
    t1 = time.perf_counter()
    with kernel_gated_off():
        plain = grid()
    sync(torch, dev)
    plain_secs = time.perf_counter() - t1
    # the two grids sum in other orders and each solve stops where its
    # f32 objective moves by <= 1e-6 of f0: the objectives are held to rel
    # 1e-4, the coefficients (loose by that stopping noise, some 1e-3 of
    # their norm here) to rel 1e-3
    value_rel = [abs(m.result.value - p.result.value) / abs(p.result.value)
                 for m, p in zip(models, plain)]
    coef_rel = [rel_diff(torch, m.model.coefficients.means,
                         p.model.coefficients.means)
                for m, p in zip(models, plain)]
    if not (max(value_rel) <= 1e-4 and max(coef_rel) <= 1e-3):
        raise AssertionError(f"config 1: kernel and plain grids differ: "
                             f"objectives rel {value_rel}, coefficients "
                             f"rel {coef_rel}")
    for m in models:
        if not np.all(np.isfinite(m.result.values)):
            raise AssertionError(f"config 1: non-finite objective at "
                                 f"lambda {m.regularization_weight}")

    # the metric grid against one call a model (cuBLAS picks its GEMM by
    # shape, so not bit for bit)
    glms = [m.model for m in models]
    evaluate_model_grid(glms, batch)
    t1 = time.perf_counter()
    grid_maps = evaluate_model_grid(glms, batch)
    eval_grid_secs = time.perf_counter() - t1
    t1 = time.perf_counter()
    single_maps = [evaluate_model(g, batch) for g in glms]
    eval_single_secs = time.perf_counter() - t1
    eval_rel = max(abs(s[k] - g[k]) / max(abs(g[k]), 1e-12)
                   for g, s in zip(grid_maps, single_maps) for k in g)
    if not eval_rel <= 1e-6:
        raise AssertionError(f"config 1: evaluate_model_grid differs from "
                             f"evaluate_model (rel {eval_rel:.3g}): "
                             f"{grid_maps} against {single_maps}")

    # a box on the first 16 coordinates, the iterates tracked
    box = BoxConstraints.from_map(
        shape[1], {i: (-0.01, 0.01) for i in range(16)}, device=dev)
    boxed = train_glm_grid(batch, task, (1.0,), max_iterations=80,
                           tolerance=1e-6, box=box, track_iterates=True)[0]
    x = boxed.result.coefficients[:16]
    if not bool(((x >= -0.01) & (x <= 0.01)).all()):
        raise AssertionError("config 1: a boxed coefficient left its box")
    on_bound = int(((x == -0.01) | (x == 0.01)).sum())
    if on_bound < 1:
        raise AssertionError("config 1: no coefficient on a bound")
    its = boxed.result.iterates
    if its.shape != (boxed.result.iterations + 1, shape[1]) or not \
            np.array_equal(its[-1], boxed.result.coefficients.cpu().numpy()):
        raise AssertionError("config 1: the last tracked iterate is not "
                             "the solution")
    out = {
        "shape": list(shape),
        "data": "bench.py:169-176 _data() (seed 0), logistic labels",
        "config": "LOGISTIC_REGRESSION, L-BFGS + L2, lambda 10, 1, 0.1 "
                  "warm-started, <= 80 iterations, tol 1e-6",
        "data_secs": data_secs, "grid_secs": grid_secs,
        "per_lambda": [{"lambda": m.regularization_weight,
                        "iterations": m.result.iterations,
                        "convergence": m.result.convergence_reason.value,
                        "value": m.result.value, "seconds": secs}
                       for m, (_, secs) in zip(models, per_lambda)],
        "launches": counts, "path": path, **work,
        "max_memory_allocated": peak,
        "plain_grid_secs": plain_secs,
        "plain_grid_iterations": [p.result.iterations for p in plain],
        "objective_rel_diff_to_plain_grid": value_rel,
        "rel_l2_diff_to_plain_grid": coef_rel,
        "evaluate_grid_secs": eval_grid_secs,
        "evaluate_single_secs": eval_single_secs,
        "evaluate_grid_vs_single_max_rel": eval_rel,
        "metrics": grid_maps,
        "box": {"iterations": boxed.result.iterations,
                "on_bound": on_bound, "value": boxed.result.value,
                "iterates_rows": int(its.shape[0])},
    }
    w_best = models[-1].result.coefficients.contiguous()
    return out, counts, batch, w_best


def legacy_argv(train, val, out, device, *extra) -> list:
    return ["--training-data-directory", train,
            "--validating-data-directory", val,
            "--output-directory", out, "--task", "LOGISTIC_REGRESSION",
            "--regularization-weights", "10,1,0.1",
            "--data-validation-type", "VALIDATE_FULL",
            "--device", device, *extra]


def run_legacy(argv) -> tuple:
    """The legacy driver in this process on ``argv``, with the kernel's
    launches of its main grid (between the training events) and its
    optimization-log events; returns (driver, launches, events)."""
    from photon_ml_tpu_torch.cli import legacy_driver
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.utils.events import (
        PhotonOptimizationLogEvent, TrainingFinishEvent, TrainingStartEvent)

    seen = {}
    events = []

    def listener(e):
        if isinstance(e, TrainingStartEvent):
            pk.reset_launch_count()
        elif isinstance(e, TrainingFinishEvent):
            seen.update(launch_counts())
        elif isinstance(e, PhotonOptimizationLogEvent):
            events.append(e)

    driver = legacy_driver.LegacyDriver(legacy_driver.parse_args(argv))
    driver.register_listener(listener)
    try:
        driver.run()
    finally:
        driver.logger.close()
    return driver, seen, events


def single_glm_driver_phase(torch, dev, workdir, rows=A1A_ROWS):
    """Phase 11 (b)-(e): the drivers on the a1a-shaped fixture."""
    from photon_ml_tpu_torch.cli import libsvm_to_avro
    from photon_ml_tpu_torch.evaluation.model_evaluation import (
        AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS as AUC, evaluate_model)
    from photon_ml_tpu_torch.io import data_format
    from photon_ml_tpu_torch.io.model_io import read_models_text
    from photon_ml_tpu_torch.optimize.config import TaskType

    shutil.rmtree(workdir, ignore_errors=True)
    device = str(dev)
    secs = {}
    t0 = time.perf_counter()
    train_txt, test_txt = write_a1a_like(os.path.join(workdir, "libsvm"),
                                         rows)
    secs["fixture_write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train, val = (os.path.join(workdir, f) for f in ("train.avro",
                                                     "test.avro"))
    for src, dst in ((train_txt, train), (test_txt, val)):
        libsvm_to_avro.main(["--input-path", src, "--output-path", dst,
                             "--feature-dimension", str(A1A_FEATURES),
                             "--device", device])
    secs["libsvm_to_avro"] = time.perf_counter() - t0

    # (b) the legacy driver on the Avro, everything on
    out_b = os.path.join(workdir, "b")
    summary_dir = os.path.join(workdir, "summary")
    data_format.reset_ingest_stats()
    t0 = time.perf_counter()
    drv, grid_launches, events = run_legacy(legacy_argv(
        train, val, out_b, device, "--diagnostic-mode", "ALL",
        "--validate-per-iteration", "true",
        "--summarization-output-dir", summary_dir))
    secs["driver_b"] = time.perf_counter() - t0
    ingest = dict(data_format.INGEST_STATS)
    for name in ("output", "best", "metrics.json", "diagnostic-report.html",
                 "diagnostic-report.txt"):
        if not os.path.exists(os.path.join(out_b, name)):
            raise AssertionError(f"(b): {name} was not written")
    if not os.path.exists(os.path.join(summary_dir, "part-00000.avro")):
        raise AssertionError("(b): the summary Avro was not written")
    if ingest != {"native_parts": 2, "declined_parts": 0,
                  "records_parts": 0}:
        raise AssertionError(f"(b): not every part read natively: {ingest}")
    if drv.train_data.dim != A1A_SHAPE[1] or \
            drv.train_data.num_samples != rows[0]:
        raise AssertionError(f"(b): training data "
                             f"{drv.train_data.features.shape}")
    check_launches("(b) main grid", grid_launches, "stream", "logistic",
                   dev)
    metrics = json.load(open(os.path.join(out_b, "metrics.json")))
    best = drv.best_lambda
    (best_lam, best_glm), = read_models_text(
        os.path.join(out_b, "best"), drv.train_data.index_map,
        TaskType.LOGISTIC_REGRESSION, device=dev)
    scored = evaluate_model(best_glm, drv._validation_batch())
    auc_json = metrics[str(best)][AUC]
    auc_rel = abs(scored[AUC] - auc_json) / auc_json
    if best_lam != best or not auc_rel <= 1e-6:
        raise AssertionError(f"(b): best model AUC {scored[AUC]} != "
                             f"metrics.json's {auc_json}")
    per_iter_rel = 0.0
    for e in events:
        last = e.per_iteration_metrics[-1]
        if len(e.per_iteration_metrics) != e.states.iterations + 1:
            raise AssertionError("(b): per-iteration metrics miss an "
                                 "iterate")
        per_iter_rel = max(per_iter_rel, *(
            abs(last[k] - v) / max(abs(v), 1e-12)
            for k, v in e.metrics.items()))
    if len(events) != 3 or not per_iter_rel <= 1e-6:
        raise AssertionError(f"(b): the last iterate's metrics differ "
                             f"from the final model's (rel "
                             f"{per_iter_rel:.3g})")
    objectives_b = {m.regularization_weight: m.result.value
                    for m in drv.models}
    w_b = drv.models[-1].result.coefficients.contiguous()
    batch_b = drv._batch(drv.train_data)
    rec_b = {
        "ingest_parts": ingest, "grid_launches": grid_launches,
        "phase_seconds": drv.phase_seconds, "best_lambda": best,
        "metrics": metrics, "best_auc_rescored": scored[AUC],
        "best_auc_rel_diff": auc_rel,
        "per_iteration_last_vs_final_max_rel": per_iter_rel,
        "per_lambda": [{"lambda": m.regularization_weight,
                        "iterations": m.result.iterations,
                        "convergence": m.result.convergence_reason.value,
                        "value": m.result.value} for m in drv.models],
    }

    # (c) the same LibSVM files straight into the driver, as a process
    out_c = os.path.join(workdir, "c")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.legacy_driver",
         *legacy_argv(train_txt, test_txt, out_c, device,
                      "--input-file-format", "LIBSVM",
                      "--feature-dimension", str(A1A_FEATURES))],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    secs["driver_c_process"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"(c): exit {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    # the one-hot groups each sum to the intercept column, so along those
    # directions the objective is flat but for the L2 term, and where an
    # f32 solve stops on |df| <= 1e-6 |f0| leaves them loose (another
    # column order, another stop): the runs are held to their objectives
    # and validation metrics, and the coefficients' difference is reported
    lib_models = dict(read_models_text(os.path.join(out_c, "output"),
                                       device=dev))
    avro_models = dict(read_models_text(os.path.join(out_b, "output"),
                                        device=dev))
    c_diff = {lam: float(np.abs(
        np.sort(lib_models[lam].coefficients.means.cpu().numpy())
        - np.sort(avro_models[lam].coefficients.means.cpu().numpy())).max())
        for lam in CONFIG1_LAMBDAS}
    metrics_c = json.load(open(os.path.join(out_c, "metrics.json")))
    c_rel = max(abs(metrics_c[k][AUC] - metrics[k][AUC]) / metrics[k][AUC]
                for k in metrics)
    if sorted(metrics_c) != sorted(metrics) or not c_rel <= 1e-4:
        raise AssertionError(f"(c): LibSVM direct and converted AUCs "
                             f"differ (rel {c_rel:.3g})")

    # (d) OWL-QN + L1, and TRON + L2 with a box on three features and
    # STANDARDIZATION
    box = [{"name": str(j), "term": "", "lowerBound": -0.05,
            "upperBound": 0.05} for j in (1, 6, 40)]
    runs_d = {}
    launches_d = {}
    # TRON's accepted values never rise without a box; with one, the
    # projection after an accepted step can raise them, in the JAX package
    # the same (tests/test_torch_legacy_driver.py shows both), so the boxed
    # run is held to its box and finite values
    std = ["--optimizer", "TRON", "--normalization-type", "STANDARDIZATION"]
    for name, extra in (
            ("owlqn_l1", ["--regularization-type", "L1"]),
            ("tron_std", std),
            ("tron_box_std", [*std, "--coefficient-box-constraints",
                              json.dumps(box)])):
        t0 = time.perf_counter()
        d, launches, _ = run_legacy(legacy_argv(
            train, val, os.path.join(workdir, name), device, *extra))
        secs[f"driver_d_{name}"] = time.perf_counter() - t0
        check_launches(f"(d) {name}", launches, "stream", "logistic", dev)
        launches_d[name] = launches
        for m in d.models:
            v = m.result.values
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"(d) {name}: non-finite objective")
            if name == "tron_std" and np.any(np.diff(v) > 0):
                raise AssertionError(f"(d) {name}: TRON's accepted values "
                                     f"rose: {v.tolist()}")
        if name == "tron_box_std":
            imap = d.train_data.index_map
            for m in d.models:
                x = m.result.coefficients.cpu().numpy()
                for b in box:
                    j = imap.index_of(b["name"] + "\x01")
                    if not -0.05 <= x[j] <= 0.05:
                        raise AssertionError(f"(d): feature {b['name']} "
                                             f"left its box: {x[j]}")
        runs_d[name] = {
            "per_lambda": [{"lambda": m.regularization_weight,
                            "iterations": m.result.iterations,
                            "convergence":
                                m.result.convergence_reason.value,
                            "value": m.result.value} for m in d.models],
            "nnz": [int((m.model.coefficients.means != 0).sum())
                    for m in d.models],
            "best_lambda": d.best_lambda, "phase_seconds": d.phase_seconds}

    # (e) (b)'s argv without the diagnostics, card and CPU
    objectives_e = {}
    for side, where in (("card", device), ("cpu", "cpu")):
        t0 = time.perf_counter()
        d, _, _ = run_legacy(legacy_argv(
            train, val, os.path.join(workdir, f"e_{side}"), where,
            "--validate-per-iteration", "true"))
        secs[f"driver_e_{side}"] = time.perf_counter() - t0
        objectives_e[side] = [m.result.value for m in d.models]
    e_rel = max(abs(a - b) / abs(b) for a, b in zip(
        objectives_e["card"], objectives_e["cpu"]))
    if not e_rel <= 1e-4:
        raise AssertionError(f"(e): card and CPU objectives differ "
                             f"(rel {e_rel:.3g}): {objectives_e}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {
        "rows": list(rows), "shape": list(A1A_SHAPE),
        "fixture": "a1a encoding (14 one-hot groups, 123 features), a9a "
                   "row counts, logistic labels, seed 21",
        "b": rec_b, "c": {"sorted_coefficients_max_abs_diff": c_diff,
                          "auc_max_rel_diff": c_rel,
                          "metrics": metrics_c},
        "d": runs_d, "e": {"objectives": objectives_e, "max_rel": e_rel},
        "objectives_b": objectives_b, "stage_seconds": secs,
    }, {"b_grid": grid_launches, **{f"d_{k}": v
                                    for k, v in launches_d.items()}}, \
        batch_b, w_b


def single_glm_phase(torch, dev, smi, workdir, bench_shape=BIG_SHAPE,
                     rows=A1A_ROWS):
    """Phase 11: the single-GLM path, BASELINE config 1. Returns the phase
    record, the kernel's launches by run and the worst |delta| of the
    kernel against its plain version on the two real batches."""
    from photon_ml_tpu_torch.ops.losses import get_loss

    t0 = time.perf_counter()
    library, lib_counts, big_batch, w_big = config1_library_phase(
        torch, dev, bench_shape)
    library["seconds"] = time.perf_counter() - t0
    print("phase 11 (a): " + json.dumps(library), file=sys.stderr,
          flush=True)
    logistic = get_loss("logistic")
    zero = torch.zeros((), device=dev)
    big_err, big_worst = check_sums(
        torch, logistic, big_batch.X, big_batch.labels, big_batch.offsets,
        big_batch.weights, w_big, zero, scaled=True)
    del big_batch
    t1 = time.perf_counter()
    drivers, driver_counts, a1a_batch, w_a1a = single_glm_driver_phase(
        torch, dev, workdir, rows)
    drivers["seconds"] = time.perf_counter() - t1
    a1a_err, a1a_worst = check_sums(
        torch, logistic, a1a_batch.X, a1a_batch.labels, a1a_batch.offsets,
        a1a_batch.weights, w_a1a, zero, scaled=True)
    record = {"phase": "single_glm", "nvidia_smi": smi,
              "library": library, "drivers": drivers,
              "kernel_vs_plain": {
                  "bench_shape": {"max_abs_err": big_err,
                                  "worst_delta_over_tolerance": big_worst},
                  "a1a_shape": {"path": paths_for(a1a_batch.X)[0],
                                "max_abs_err": a1a_err,
                                "worst_delta_over_tolerance": a1a_worst}},
              "seconds": time.perf_counter() - t0}
    return record, {"config1_grid": lib_counts, **{
        f"single_glm_{k}": v for k, v in driver_counts.items()}}, \
        max(big_err, a1a_err)


def main() -> int:
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the GPU")
    if not os.path.isdir(os.path.join(REPO, "photon_ml_tpu_torch", "csrc")):
        fail("run from a checkout of the repository (photon_ml_tpu_torch/ "
             "not found beside this script)")
    sys.path.insert(0, REPO)

    from photon_ml_tpu_torch.game.coordinate_descent import (
        HOT_LOOP_STATS, reset_hot_loop_stats, run_coordinate_descent)
    from photon_ml_tpu_torch.ops import kernels_build
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.ops.losses import LOSSES, get_loss
    from photon_ml_tpu_torch.optimize import common as opt_common
    from photon_ml_tpu_torch.optimize.config import TaskType

    dev = torch.device("cuda", 0)

    # -- 1. device ---------------------------------------------------------
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    hbm = HBM_BYTES_PER_S["pcie" if "pcie" in name.lower() else "sxm"]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "hbm_bytes_per_s": hbm,
          "seconds": time.perf_counter() - t0})

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    kernels_build.build_all()
    for kname, info in kernels_build.BUILD_INFO.items():
        print(f"[{kname}] {info['log']}", file=sys.stderr, flush=True)
    emit({"phase": "build",
          "kernels": {k: v["seconds"]
                      for k, v in kernels_build.BUILD_INFO.items()},
          "seconds": time.perf_counter() - t0})

    # -- 3. kernel against its plain version ---------------------------------
    t0 = time.perf_counter()
    worst_all = 0.0
    cases = {"stream": 0, "staged": 0}
    autograd_paths = set()
    for si, ((n, d), scaled) in enumerate(CHECK_SHAPES):
        X, y, off, wt, w = kernel_inputs(torch, n, d, seed=si, device=dev)
        shift = torch.tensor(0.31, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            Xc = X.to(dtype)
            paths = paths_for(Xc)
            for path in paths:
                # the wrapper on the path it picks, _launch on the other
                named = None if path == paths[0] else path
                for lname in sorted(LOSSES):
                    _, worst = check_sums(torch, get_loss(lname), Xc, y,
                                          off, wt, w, shift, scaled, named)
                    worst_all = max(worst_all, worst)
                    cases[path] += 1
            del Xc
        if not scaled:
            # autograd through the autograd.Function equals vector_sum, on
            # the path the wrapper picks for this shape
            wg = w.clone().requires_grad_(True)
            loss = get_loss("logistic")
            val, vec, _ = pk.fused_value_gradient_sums(loss, X, y, off, wt,
                                                       wg, shift, device=dev)
            (grad,) = torch.autograd.grad(val, wg)
            torch.cuda.synchronize()
            if not torch.allclose(grad, vec, rtol=2e-4, atol=2e-4):
                raise AssertionError("autograd gradient != vector_sum")
            autograd_paths.add(paths_for(X)[0])
        if d % 4:
            # the stream path refuses a row that is not whole vectors
            try:
                pk._launch(get_loss("logistic"), X, y, off, wt, w, shift,
                           path="stream")
            except RuntimeError:
                pass
            else:
                raise AssertionError(f"stream path took d={d}")
        del X, y, off, wt, w
        torch.cuda.empty_cache()
    if autograd_paths != set(cases):
        raise AssertionError(f"autograd checked on {autograd_paths} only")
    emit({"phase": "kernel", "name": "fused_value_gradient_sums",
          "cases": sum(cases.values()), "cases_by_path": cases,
          "worst_delta_over_tolerance": worst_all,
          "deterministic": True, "autograd_paths": sorted(autograd_paths),
          "stream_refuses_partial_vector_rows": True,
          "seconds": time.perf_counter() - t0})

    # -- 4. timing -------------------------------------------------------------
    t0 = time.perf_counter()
    timings = {}
    f32_bf16 = (torch.float32, torch.bfloat16)
    # (shape, loss, dtypes): the GLMix shape, the driver's (f32 only, as
    # the driver runs it), 262,144 x 2,048, and the second-order main
    # path's losses at their shapes (phase 8 (b) and (a))
    for (n, d), lname, dtypes in (
            (GLMIX_SHAPE, "logistic", f32_bf16),
            (DRIVER_SHAPE, "logistic", (torch.float32,)),
            (BIG_SHAPE, "logistic", f32_bf16),
            (CONFIG3_SHAPE, "poisson", (torch.float32,)),
            (BIG_SHAPE, "squared", (torch.float32,)),
            (A1A_SHAPE, "logistic", (torch.float32,))):
        loss = get_loss(lname)
        X, y, off, wt, w = kernel_inputs(torch, n, d, seed=11, device=dev)
        shift = torch.tensor(0.0, device=dev)
        for dtype in dtypes:
            Xc = X.to(dtype).contiguous()
            for row in time_kernel(torch, hbm, loss, Xc, y, off, wt, w,
                                   shift).values():
                timings[(n, d, row["dtype"], row["path"], lname)] = row
                emit({"phase": "timing", **row})
            del Xc
        del X, y, off, wt, w
        torch.cuda.empty_cache()
    emit({"phase": "timing_done", "seconds": time.perf_counter() - t0})

    # -- 5. GLMix end to end at full width -----------------------------------
    t0 = time.perf_counter()
    task = TaskType.LOGISTIC_REGRESSION
    # (a) small GLMix: the card's run agrees with the CPU's
    small = movielens_data(np.random.default_rng(3), 40_000, 500, 300, 64)
    objs = {}
    for where in ("cpu", "cuda"):
        coords = glmix_coordinates(small, where, active_cap=32,
                                   feature_cap=32)
        res = run_coordinate_descent(
            coords, 2, task, small.responses, small.weights, small.offsets,
            device=where)
        objs[where] = [s.objective for s in res.states]
    rel = max(abs(a - b) / abs(a) for a, b in zip(objs["cpu"],
                                                  objs["cuda"]))
    if not rel <= 1e-4:
        raise AssertionError(f"small GLMix: card and CPU objectives differ "
                             f"(rel {rel:.3g}): {objs}")
    emit({"phase": "glmix_small_vs_cpu", "objectives_cpu": objs["cpu"],
          "objectives_cuda": objs["cuda"], "max_rel_diff": rel,
          "seconds": time.perf_counter() - t0})

    # (b) full width
    t0 = time.perf_counter()
    n, n_users, n_movies = 1_000_209, 6040, 3706
    data = movielens_data(np.random.default_rng(7), n, n_users, n_movies, 64)
    coords = glmix_coordinates(data, dev)
    torch.cuda.synchronize()
    build_secs = time.perf_counter() - t0
    re_ds = coords["per-user"].dataset
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launch_count()
    reset_hot_loop_stats()
    opt_common.reset_solver_syncs()
    t1 = time.perf_counter()
    res = run_coordinate_descent(
        coords, 2, task, data.responses, data.weights, data.offsets,
        device=dev, logger=lambda s: print(s, file=sys.stderr, flush=True))
    torch.cuda.synchronize()
    train_secs = time.perf_counter() - t1
    launches = pk.launch_count()
    by_path = dict(pk.fused_value_gradient_sums.launches_by_path)
    glmix_by_loss = launch_counts()["by_loss"]
    solver_syncs = opt_common.SOLVER_SYNCS["count"]
    hot = dict(HOT_LOOP_STATS)
    peak = torch.cuda.max_memory_allocated()
    sweeps = []
    for it in range(2):
        upd = [s for s in res.states if s.iteration == it]
        sweeps.append({
            "sweep": it, "objective": upd[-1].objective,
            "seconds": sum(s.seconds for s in upd),
            "fixed_iterations": upd[0].tracker.result.iterations,
            "re_counts_by_convergence":
                upd[1].tracker.counts_by_convergence()})
    if launches <= 0:
        raise AssertionError("the GLMix run never launched the kernel")
    if by_path["staged"] != 0 or by_path["stream"] != launches:
        raise AssertionError(f"the GLMix fixed effect left the stream "
                             f"path: {by_path}")
    if not all(np.isfinite(s["objective"]) for s in sweeps):
        raise AssertionError(f"non-finite objective: {sweeps}")
    if not sweeps[1]["objective"] <= sweeps[0]["objective"] * (1 + 1e-6):
        raise AssertionError(f"objective rose between sweeps: {sweeps}")
    scores = res.model.score(data, device=dev)
    if scores.shape != (n,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError("published GameModel scores are not finite")
    # phase 7 resumes this run and must land on these states
    glmix_final = {
        "fixed": res.model.models["fixed"].model.coefficients.means,
        "per-user": res.model.models["per-user"].coefficients_projected}
    emit({"phase": "glmix", "n": n, "users": n_users, "movies": n_movies,
          "d_global": 64,
          "re_buckets": [list(b.X.shape) for b in re_ds.buckets],
          "build_secs": build_secs, "train_secs": train_secs,
          "sweeps": sweeps, "kernel_launches": launches,
          "launches_by_path": by_path,
          "updates": hot["updates"],
          "epilogue_fetches_per_update":
              hot["epilogue_fetches"] / hot["updates"],
          "solver_syncs": solver_syncs,
          "host_syncs_per_update":
              (hot["epilogue_fetches"] + solver_syncs) / hot["updates"],
          "max_memory_allocated": peak,
          "score_mean": float(scores.mean()),
          "seconds": time.perf_counter() - t0})

    # (c) the fixed-effect objective on the real GLMix batch, kernel
    # against plain version (after the counts were read)
    fe = coords["fixed"]
    batch = fe.dataset.with_offsets(coords["per-user"].score(
        res.model.models["per-user"].coefficients_projected))
    w_fe = res.model.models["fixed"].model.coefficients.means.contiguous()
    main_err, main_worst = check_sums(
        torch, get_loss("logistic"), batch.X, batch.labels, batch.offsets,
        batch.weights, w_fe, torch.zeros((), device=dev), scaled=True)
    emit({"phase": "glmix_batch_kernel_vs_plain",
          "path": paths_for(batch.X)[0], "max_abs_err": main_err,
          "worst_delta_over_tolerance": main_worst,
          "seconds": time.perf_counter() - t0})

    # -- 6. GLMix through the port's drivers ---------------------------------
    t0 = time.perf_counter()
    driver_dir = os.path.join(REPO, "photon_ml_tpu_torch", "_build",
                              "driver_phase")
    phase, driver_launches, driver_by_path, driver_check, fixture = \
        driver_phase(torch, dev, smi, driver_dir)
    phase["seconds"] = time.perf_counter() - t0
    emit(phase)

    # -- 7. resume: in process at full size, then real process deaths ------
    t0 = time.perf_counter()
    build = os.path.join(REPO, "photon_ml_tpu_torch", "_build")
    in_process, resume_crash, resume_resumed = resume_phase(
        torch, dev, data, glmix_final, os.path.join(build, "resume_phase"))
    in_process["seconds"] = time.perf_counter() - t0
    print("resume in process: " + json.dumps(in_process), file=sys.stderr,
          flush=True)
    t1 = time.perf_counter()
    drill_rec, drill_launches, drill_fixture = drill_phase(
        dev, os.path.join(build, "drill"))
    drill_rec["seconds"] = time.perf_counter() - t1
    emit({"phase": "resume", "nvidia_smi": smi, "in_process": in_process,
          "drill": drill_rec,
          "metric_determinism": (
              "training floats (states, scores, objectives) are compared "
              "bit for bit; validation metrics and best_metric to 1e-12 "
              "relative, since a metric's segment sums on the card are "
              "atomic f64 adds in no fixed order"),
          "seconds": time.perf_counter() - t0})

    # -- 8. second-order solvers: BASELINE configs 2 and 3 ----------------
    t0 = time.perf_counter()
    cfg2 = config2_phase(torch, dev)
    torch.cuda.empty_cache()
    print("config 2: " + json.dumps(cfg2), file=sys.stderr, flush=True)
    cfg3 = config3_phase(torch, dev)
    torch.cuda.empty_cache()
    print("config 3: " + json.dumps(cfg3), file=sys.stderr, flush=True)
    small2, small2_launches = second_order_small_vs_cpu(torch)
    print("small vs CPU: " + json.dumps(small2), file=sys.stderr,
          flush=True)
    profile = per_user_profile(
        torch, dev, coords["per-user"].dataset,
        coords["fixed"].score(glmix_final["fixed"]))
    print("per-user profile: " + json.dumps(profile), file=sys.stderr,
          flush=True)
    drivers2, drivers2_launches = second_order_driver_phase(
        torch, dev, *fixture, os.path.join(driver_dir, "second_order"))
    shutil.rmtree(driver_dir, ignore_errors=True)
    emit({"phase": "second_order", "nvidia_smi": smi, "config2": cfg2,
          "config3": cfg3, "drivers": drivers2, "small_vs_cpu": small2,
          "per_user_profile": profile,
          "peak_memory": {"config2": cfg2["max_memory_allocated"],
                          **{f"driver_{k}": v["max_memory_allocated"]
                             for k, v in drivers2["runs"].items()}},
          "seconds": time.perf_counter() - t0})

    # -- 9. coordinate-descent extensions ---------------------------------
    cd_ext, cd_launches = cd_extensions_phase(
        torch, dev, smi, data, coords, drill_fixture,
        os.path.join(build, "cd_extensions"))
    emit(cd_ext)
    del coords
    torch.cuda.empty_cache()

    # -- 10. factored random effects and BASELINE config 5 ----------------
    factored, fac_launches, fac_errs, fac_rows = factored_phase(
        torch, dev, smi, data, drill_fixture,
        os.path.join(build, "factored"), hbm)
    shutil.rmtree(os.path.join(build, "drill"), ignore_errors=True)
    emit(factored)
    for row in fac_rows:
        timings[(row["n"], row["d"], row["dtype"], row["path"],
                 row["loss"])] = row

    # -- 11. the single-GLM path: BASELINE config 1 -------------------------
    single, single_launches, single_err = single_glm_phase(
        torch, dev, smi, os.path.join(build, "single_glm"))
    emit(single)

    # -- kernels line, card line, result ---------------------------------------
    cd_runs = {f"cd_{k}": v for k, v in cd_launches.items()}
    fac_runs = {f"factored_{k}": v for k, v in fac_launches.items()}
    second_order_runs = {
        "config2": cfg2["launches"], "config3": cfg3["launches"],
        **{f"driver_{k}": v for k, v in drivers2_launches.items()},
        **{f"small_{k}_cuda": v for k, v in small2_launches.items()}}
    runs = {"glmix": by_path, "driver": driver_by_path,
            "resume_before_kill": resume_crash,
            "resume_resumed": resume_resumed,
            **{f"drill_{r}": v for r, v in drill_launches.items()},
            **{k: v["by_path"] for k, v in second_order_runs.items()},
            **{k: v["by_path"] for k, v in cd_runs.items()},
            **{k: v["by_path"] for k, v in fac_runs.items()},
            **{k: v["by_path"] for k, v in single_launches.items()}}
    by_loss = {"glmix": glmix_by_loss, "driver": phase["launches_by_loss"],
               **{k: v["by_loss"] for k, v in second_order_runs.items()},
               **{k: v["by_loss"] for k, v in cd_runs.items()},
               **{k: v["by_loss"] for k, v in fac_runs.items()},
               **{k: v["by_loss"] for k, v in single_launches.items()}}
    total_by_path = {p: sum(r[p] for r in runs.values())
                     for p in by_path}
    main = timings[(*GLMIX_SHAPE, "float32", "stream", "logistic")]
    driver = timings[(*DRIVER_SHAPE, "float32", driver_check["path"],
                      "logistic")]
    staged = timings[(*BIG_SHAPE, "float32", "staged", "logistic")]
    a1a = timings[(*A1A_SHAPE, "float32", "stream", "logistic")]
    emit({"kernels": [{
        "name": "fused_value_gradient_sums",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/csrc/fused_value_gradient.cu",
        "replaces": "photon_ml_tpu/ops/pallas_kernels.py:144",
        "launches": sum(total_by_path.values()),
        "launches_by_run": runs,
        "launches_by_loss": by_loss,
        "max_abs_err": max(main_err, driver_check["max_abs_err"],
                           *fac_errs, single_err),
        "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "device_ms": main["device_ms"],
        "paths": {p: {"ms": r["kernel_ms"], "device_ms": r["device_ms"],
                      "bound_ms": r["bound_ms"],
                      "shape": [r["n"], r["d"]], "dtype": r["dtype"],
                      "launches": total_by_path[p]}
                  for p, r in (("stream", main), ("staged", staged))},
        "rows": [{k: r[k] for k in (
            "n", "d", "dtype", "path", "loss", "kernel_ms", "device_ms",
            "plain_ms",
            "plain_device_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by", "share_of_bound",
            "device_share_of_bound")} for r in timings.values()],
        "driver_shape": {"shape": list(DRIVER_SHAPE), "path": driver["path"],
                         "ms": driver["kernel_ms"],
                         "device_ms": driver["device_ms"],
                         "bound_ms": driver["bound_ms"],
                         "share_of_bound": driver["share_of_bound"],
                         "device_share_of_bound":
                             driver["device_share_of_bound"]},
        "a1a_shape": {"shape": list(A1A_SHAPE), "path": a1a["path"],
                      "ms": a1a["kernel_ms"], "device_ms": a1a["device_ms"],
                      "bound_ms": a1a["bound_ms"],
                      "plain_ms": a1a["plain_ms"],
                      "library_ms": a1a["library_ms"],
                      "share_of_bound": a1a["share_of_bound"],
                      "device_share_of_bound":
                          a1a["device_share_of_bound"]},
        "checked": True,
    }], "seconds_total": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
