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
   it, which ``host_ms`` shows). At the GLMix shape both pass-1 paths
   are timed in turns (stream, staged, staged, stream); the 262,144 x
   2,048 shape is staged only.
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

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit) and
no result line is printed. Without CUDA, or outside the repository, it
exits non-zero at once.
"""

from __future__ import annotations

import json
import os
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
# rows of the driver phase's Avro fixture (training, validation): the
# configuration's 1,000,209 training rows and a fifth as many to validate,
# written as 16 + 4 part files; the widths are the configuration's
DRIVER_ROWS = (1_000_209, 200_000)
# rows of the resume phase's drill fixture: cut further, since six driver
# processes each decode the Avro again, but not below the kernel's gate:
# 40,000 x 65 = 2.6M elements passes ``pallas_supported``'s 2**21, where
# at 20,000 rows the fixed effect takes the plain two-pass form
DRILL_ROWS = (40_000, 5_000)
DRIVER_SECTIONS = "global:globalFeatures|user:userFeatures"
# (shape, tolerance scaled to the sum of |terms|): the small shapes reach
# every stream geometry (1 to 32 lanes a row in f32 or bf16, one and two
# vectors a lane, segments that are not whole, a ragged last batch) and
# the staged path's unvectorised load (d = 63).
CHECK_SHAPES = [((700, 128), False), ((1024, 256), False),
                ((1000, 96), False), ((1001, 24), False),
                ((1001, 8), False), ((777, 256), False),
                ((777, 63), False), (GLMIX_SHAPE, True),
                (DRIVER_SHAPE, True), (BIG_SHAPE, True)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def movielens_data(rng, n, n_users, n_movies, d_global):
    """MovieLens-shaped synthetic GameDataset: power-law users, uniform
    movies, dense global features, one-hot movie features for the per-user
    coordinate (the recipe of bench.py:581 ``_movielens_data``)."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.game.dataset import GameDataset

    users = (rng.zipf(1.3, size=n) % n_users).astype(np.int64)
    movies = rng.integers(0, n_movies, n)
    Xg = (rng.normal(size=(n, d_global)) / np.sqrt(d_global)).astype(
        np.float32)
    wg = rng.normal(size=d_global).astype(np.float32)
    logits = Xg @ wg + 0.5 * rng.normal(size=n_users)[users].astype(
        np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    one = np.ones(n, np.float32)
    data = GameDataset(responses=y, feature_shards={
        "global": sp.csr_matrix(Xg),
        "per_user": sp.csr_matrix((one, (np.arange(n), movies)),
                                  shape=(n, n_movies)),
    })
    data.encode_ids("userId", users)
    return data


def glmix_coordinates(data, device, active_cap=128, feature_cap=128,
                      num_buckets=4):
    """Fixed effect (L-BFGS + L2, lambda 10, 40 iterations) + per-user
    random effect (lambda 1, 20 iterations), tolerance 1e-7."""
    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate, RandomEffectCoordinate)
    from photon_ml_tpu_torch.game.dataset import (
        RandomEffectDataConfiguration, build_fixed_effect_dataset,
        build_random_effect_dataset)
    from photon_ml_tpu_torch.game.random_effect import (
        RandomEffectOptimizationProblem)
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, OptimizerType, RegularizationContext,
        RegularizationType, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem

    def l2(lam, iters):
        return GLMOptimizationConfiguration(
            max_iterations=iters, tolerance=1e-7, regularization_weight=lam,
            optimizer_type=OptimizerType.LBFGS,
            regularization_context=RegularizationContext(
                RegularizationType.L2))

    task = TaskType.LOGISTIC_REGRESSION
    re_cfg = RandomEffectDataConfiguration(
        random_effect_type="userId", feature_shard_id="per_user",
        num_active_data_points_upper_bound=active_cap,
        num_features_to_keep_upper_bound=feature_cap)
    return {
        "fixed": FixedEffectCoordinate(
            dataset=build_fixed_effect_dataset(data, "global",
                                               device=device),
            problem=GLMOptimizationProblem(config=l2(10.0, 40), task=task)),
        "per-user": RandomEffectCoordinate(
            dataset=build_random_effect_dataset(
                data, re_cfg, num_buckets=num_buckets, device=device),
            problem=RandomEffectOptimizationProblem(config=l2(1.0, 20),
                                                    task=task)),
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
    the phase record, the kernel launches of the training run and the
    kernel-vs-plain check on the driver's own fixed-effect batch; raises
    on any failed check, the kernel's last."""
    import shutil

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
        "expected_path": expected,
        "max_memory_allocated": peak,
        "kernel_check": check,
    }
    print("driver phase: " + json.dumps(phase), file=sys.stderr, flush=True)
    if launches <= 0 or by_path[expected] != launches:
        raise AssertionError(f"the driver's fixed effect did not launch "
                             f"the kernel on the {expected} path: {by_path}")
    shutil.rmtree(workdir, ignore_errors=True)
    return phase, launches, by_path, check


def resume_phase(torch, dev, data, want, workdir):
    """Phase 7 (a): the glmix run killed mid-sweep by an injected fault
    and resumed in fresh coordinates from its newest snapshot. ``want`` is
    phase 5's final state per coordinate; the resumed run must end on it
    bit for bit. Returns the record and the launches of both segments."""
    import shutil

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
    record and the launches by role; raises on any failed check."""
    import shutil

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
    shutil.rmtree(workdir, ignore_errors=True)
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
    }, launches


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
    loss = get_loss("logistic")
    for (n, d) in (GLMIX_SHAPE, DRIVER_SHAPE, BIG_SHAPE):
        X, y, off, wt, w = kernel_inputs(torch, n, d, seed=11, device=dev)
        shift = torch.tensor(0.0, device=dev)
        # the driver's shape runs in f32 only, as the driver does
        for dtype in ((torch.float32,) if (n, d) == DRIVER_SHAPE
                      else (torch.float32, torch.bfloat16)):
            Xc = X.to(dtype).contiguous()
            wl = w.to(dtype)

            def library(Xc=Xc, wl=wl):
                z = torch.matmul(Xc, wl).float() + off + shift
                r = wt * loss.d1(z, y)
                return ((wt * loss.loss(z, y)).sum(),
                        torch.matmul(r.to(Xc.dtype), Xc), r.sum())

            paths = paths_for(Xc)
            # both paths in turns on the same inputs: A, B, B, A; each
            # turn one call at a time, then ten back to back
            single = {p: [] for p in paths}
            back = {p: [] for p in paths}
            for p in paths + paths[::-1]:
                def run(p=p):
                    return pk._launch(loss, Xc, y, off, wt, w, shift, path=p)
                single[p].append(cuda_times(torch, run)["ms"])
                back[p].append(cuda_times(torch, run, reps=15, inner=10))

            def plain():
                return pk.fused_value_gradient_sums_reference(
                    loss, Xc, y, off, wt, w, shift)
            plain_ms = cuda_times(torch, plain)["ms"]
            plain_dev = cuda_times(torch, plain, reps=15, inner=10)
            library_ms = cuda_times(torch, library)["ms"]
            library_dev = cuda_times(torch, library, reps=15, inner=10)
            nbytes = n * d * Xc.element_size() + 12 * n + 4 * d
            bytes_ms = 1e3 * nbytes / hbm
            ops_ms = 1e3 * 4.0 * n * d / F32_FLOPS_PER_S
            bound_ms = max(bytes_ms, ops_ms)
            dt = str(dtype).split(".")[-1]
            for p in paths:
                kernel_ms = float(np.mean(single[p]))
                device_ms = float(np.mean([r["ms"] for r in back[p]]))
                timings[(n, d, dt, p)] = {
                    "n": n, "d": d, "dtype": dt, "path": p,
                    "kernel_ms": kernel_ms, "kernel_ms_runs": single[p],
                    "device_ms": device_ms,
                    "device_ms_runs": [r["ms"] for r in back[p]],
                    "host_ms": float(np.mean([r["host_ms"]
                                              for r in back[p]])),
                    "spin_ms": back[p][0]["spin_ms"],
                    "queued_share": min(r["queued_share"]
                                        for r in back[p]),
                    "plain_ms": plain_ms,
                    "plain_device_ms": plain_dev["ms"],
                    "plain_queued_share": plain_dev["queued_share"],
                    "library_ms": library_ms,
                    "library_device_ms": library_dev["ms"],
                    "library_queued_share": library_dev["queued_share"],
                    "bytes": nbytes, "bound_ms": bound_ms,
                    "bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations",
                    "share_of_bound": bound_ms / kernel_ms,
                    "device_share_of_bound": bound_ms / device_ms,
                    "achieved_gb_per_s": nbytes / kernel_ms / 1e6,
                    # the staged path's time over this path's, same run
                    "staged_over_this": float(np.mean(single["staged"]))
                    / kernel_ms,
                    "staged_over_this_device": float(np.mean(
                        [r["ms"] for r in back["staged"]])) / device_ms}
                emit({"phase": "timing", **timings[(n, d, dt, p)]})
            del Xc, wl
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
    phase, driver_launches, driver_by_path, driver_check = driver_phase(
        torch, dev, smi, os.path.join(REPO, "photon_ml_tpu_torch", "_build",
                                      "driver_phase"))
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
    drill_rec, drill_launches = drill_phase(dev,
                                            os.path.join(build, "drill"))
    drill_rec["seconds"] = time.perf_counter() - t1
    emit({"phase": "resume", "nvidia_smi": smi, "in_process": in_process,
          "drill": drill_rec,
          "metric_determinism": (
              "training floats (states, scores, objectives) are compared "
              "bit for bit; validation metrics and best_metric to 1e-12 "
              "relative, since a metric's segment sums on the card are "
              "atomic f64 adds in no fixed order"),
          "seconds": time.perf_counter() - t0})

    # -- 8. kernels line, card line, result ----------------------------------
    runs = {"glmix": by_path, "driver": driver_by_path,
            "resume_before_kill": resume_crash,
            "resume_resumed": resume_resumed,
            **{f"drill_{r}": v for r, v in drill_launches.items()}}
    total_by_path = {p: sum(r[p] for r in runs.values())
                     for p in by_path}
    main = timings[(*GLMIX_SHAPE, "float32", "stream")]
    driver = timings[(*DRIVER_SHAPE, "float32", driver_check["path"])]
    staged = timings[(*BIG_SHAPE, "float32", "staged")]
    emit({"kernels": [{
        "name": "fused_value_gradient_sums",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/csrc/fused_value_gradient.cu",
        "replaces": "photon_ml_tpu/ops/pallas_kernels.py:144",
        "launches": sum(total_by_path.values()),
        "launches_by_run": runs,
        "max_abs_err": max(main_err, driver_check["max_abs_err"]),
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
            "n", "d", "dtype", "path", "kernel_ms", "device_ms", "plain_ms",
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
        "checked": True,
    }], "seconds_total": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
