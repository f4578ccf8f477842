"""Crash -> resume -> verify drill for the port's GAME training driver.

Port of ``tools/crash_resume_drill.py``, on the driver: every role is a
separate process running ``cli.game_training_driver`` (through this
module's ``--worker`` role) on a fixture directory that holds
``train.avro`` and ``validate.avro``, with the GLMix argv of
:func:`driver_argv` for :data:`SWEEPS` sweeps plus ``--checkpoint-dir``
and ``--checkpoint-every-coordinates 1``. Three sweeps, not two: the
crash dies in the per-user update of sweep 1, so with two sweeps the
resumed process would have no fixed-effect update left to run the fused
kernel on.

=========  ==========================================  =================
role       how                                         expected
=========  ==========================================  =================
reference  uninterrupted                               exit 0
crash      ``PHOTON_FAULTS=cd.update@1.1=kill:1:19``   exit 19
resume     same argv and checkpoint dir as crash       exit 0, resumes
                                                       at sweep 1
                                                       coordinate 1
preempt    ``PHOTON_FAULTS=cd.update@0.1=signal``      exit 75, one
                                                       ``PHOTON_PREEMPTED``
                                                       line
relaunch   same argv and checkpoint dir as preempt     exit 0
corrupt    a copy of the crash's checkpoint dir with   exit 3,
           every step corrupted                        ``PHOTON_ABORT
                                                       kind=Checkpoint
                                                       CorruptionError``
=========  ==========================================  =================

reference, crash and preempt run side by side, then resume, relaunch and
corrupt. The resume and relaunch roles must end on a last snapshot whose
``states``, ``scores`` and ``best_states`` arrays are ``np.array_equal``
to the reference's, with the objectives in ``metrics.json`` after the
resume point equal bit for bit. Validation metrics and ``best_metric``
are held to 1e-12 relative: on the card a metric's segment sums are
atomic adds in no fixed order (the training floats have no such sum).
Every worker that finishes prints one JSON line (wall seconds, kernel
launches by path, snapshot bytes and save seconds, the part files each
ingest path read, and the driver's phase seconds: the feature-map scan
and the load among them); on the card each
finishing worker must have launched the fused kernel, every time on the
path ``kernel_path`` picks for the fixed effect's width.

Usage (``--device`` defaults to ``cuda`` and never falls back to the
CPU)::

    python -m photon_ml_tpu_torch.tools.crash_resume_drill \\
        --fixture-dir DIR [--workdir DIR] [--device cpu]

Without ``--fixture-dir`` a small fixture (2,000 / 500 rows of the GLMix
recipe) is written into the work directory first. Exit 0 and a last line
``DRILL_OK ...`` mean the drill passed; any mismatch raises.

``--worker-updates`` is the worker role that also prints one
``DRILL_UPDATE {json}`` line (the ``cd.update`` tag, the wall clock, the
kernel's launches by path so far) each time an update reaches its
``cd.update`` fault point, before any armed fault fires there: a process
that dies there (a ``kill``, a hang ended by SIGKILL) still shows what it
launched. A supervisor runs it as its module::

    python -m photon_ml_tpu_torch.tools.photon_supervise \
        --module photon_ml_tpu_torch.tools.crash_resume_drill -- \
        --worker-updates <driver argv>
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

from photon_ml_tpu_torch.tools.glmix_cases import GLMIX_CASES

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SECTIONS = "global:globalFeatures|user:userFeatures"
KILL_EXIT = 19
SWEEPS = 3
KILL_AT = (1, 1)  # (sweep, coordinate index) the crash role dies in
SIGNAL_AT = (0, 1)  # the update during which the preempt role is signalled
#: expected exit code by role
EXPECTED_EXIT = {"reference": 0, "crash": KILL_EXIT, "preempt": 75,
                 "resume": 0, "relaunch": 0, "corrupt": 3}
METRIC_RTOL = 1e-12


def driver_argv(train: str, validate: str, output_dir: str, device: str,
                num_iterations: int = 2, extra=()) -> list:
    """The GLMix argv of the training driver: fixed effect over the 64
    global features + intercept (L-BFGS + L2, lambda 10, <= 40
    iterations), per-user random effect (active cap 128, lambda 1, <= 20
    iterations, 4 entity buckets), validation by AUC, LOGISTIC_LOSS and
    per-user AUC after every update (the ``lbfgs`` case of
    :data:`GLMIX_CASES`); ``extra`` flags follow and win (e.g. another
    case's ``argv()``)."""
    return [
        "--train-input-dirs", train, "--validate-input-dirs", validate,
        "--output-dir", output_dir,
        "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
        "--updating-sequence", "fixed,perUser",
        "--num-iterations", str(num_iterations),
        "--fixed-effect-data-configurations", "fixed:global,1",
        "--random-effect-data-configurations", "perUser:userId,user,1,128",
        "--random-effect-block-buckets", "4",
        *GLMIX_CASES["lbfgs"].argv(), "--device", device, *extra]


# -- the worker role ---------------------------------------------------------


def run_worker(argv: list, report_updates: bool = False) -> None:
    """One training driver run in this process. On a normal end, or an
    exit the driver chose (3, 75), prints one ``DRILL_WORKER {json}``
    line and keeps the driver's exit code. With ``report_updates``, one
    ``DRILL_UPDATE {json}`` line at every ``cd.update`` fault point."""
    import torch

    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.game import coordinate_descent as tcd
    from photon_ml_tpu_torch.io.data_format import INGEST_STATS
    from photon_ml_tpu_torch.ops import kernels_build
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.utils.checkpoint import CHECKPOINT_STATS

    t0 = time.perf_counter()

    def report(code, driver=None):
        rec = {"exit": code, "wall_secs": time.perf_counter() - t0,
               "launches_by_path": dict(
                   pk.fused_value_gradient_sums.launches_by_path),
               "kernel_build_secs": {k: v["seconds"] for k, v in
                                     kernels_build.BUILD_INFO.items()},
               "snapshot_bytes": CHECKPOINT_STATS["bytes"],
               "snapshots": CHECKPOINT_STATS["saves"],
               "save_secs": CHECKPOINT_STATS["save_seconds"],
               "restore_secs": CHECKPOINT_STATS["restore_seconds"],
               "ingest_parts": dict(INGEST_STATS)}
        if driver is not None:
            d = len(driver.index_maps["global"])
            rec["fixed_effect_columns"] = d
            rec["expected_path"] = pk.kernel_path(d, torch.float32, True)
            rec["phase_seconds"] = driver.phase_seconds
        print("DRILL_WORKER " + json.dumps(rec), flush=True)

    if report_updates:
        fault_point = tcd.fault_point

        def reporting_fault_point(point, tag=None, **kw):
            if point == "cd.update":
                print("DRILL_UPDATE " + json.dumps({
                    "tag": tag, "t": time.time(),
                    "launches_by_path": dict(
                        pk.fused_value_gradient_sums.launches_by_path)}),
                    flush=True)
            return fault_point(point, tag=tag, **kw)

        tcd.fault_point = reporting_fault_point
    try:
        driver = ttd.run(argv)
    except SystemExit as e:
        report(e.code)
        raise
    report(0, driver)


# -- the drill ---------------------------------------------------------------


#: part files of :func:`write_movielens_avro` as directories: (training,
#: validation); fixed, so that the fixture does not depend on the host
FIXTURE_PARTS = (16, 4)


def _glmix_schema() -> dict:
    from photon_ml_tpu_torch.io import schemas

    return {
        "name": "GameRecord", "type": "record", "namespace": "glmix",
        "fields": [
            {"name": "uid", "type": ["null", "string"], "default": None},
            {"name": "response", "type": "double"},
            {"name": "offset", "type": ["null", "double"], "default": None},
            {"name": "weight", "type": ["null", "double"], "default": None},
            {"name": "metadataMap",
             "type": ["null", {"type": "map", "values": "string"}],
             "default": None},
            {"name": "globalFeatures",
             "type": {"type": "array", "items": schemas.FEATURE}},
            {"name": "userFeatures",
             "type": {"type": "array", "items": "FeatureAvro"}},
        ],
    }


def _write_rows(task: tuple) -> None:
    """Write rows ``lo..`` of the recipe (their features, labels, users and
    movies) as one Avro container; a process-pool task."""
    from photon_ml_tpu_torch.io.avro import write_container

    path, lo, Xg, labels, users, movies = task
    names = [f"g{j}" for j in range(Xg.shape[1])]
    rows, labels = Xg.astype(np.float64).tolist(), labels.tolist()
    users_s, movies_s = users.astype(str), movies.astype(str)

    def records():
        for i in range(len(rows)):
            yield {"uid": str(lo + i), "response": labels[i], "offset": None,
                   "weight": None, "metadataMap": {"userId": users_s[i]},
                   "globalFeatures": [{"name": nm, "term": "", "value": v}
                                      for nm, v in zip(names, rows[i])],
                   "userFeatures": [{"name": "movie", "term": movies_s[i],
                                     "value": 1.0}]}

    write_container(path, _glmix_schema(), records())


def write_movielens_avro(train_path: str, val_path: str, n_train: int,
                         n_val: int, n_users: int, n_movies: int,
                         d_global: int, seed: int = 7,
                         parts: Optional[tuple] = None) -> None:
    """The GLMix recipe (``bench.py:581``) for ``n_train + n_val`` rows as
    GAME Avro, written by the port's writer: ``d_global`` dense features
    ``g<j>`` in ``globalFeatures``, the movie one-hot (``movie``, term =
    movie id) in ``userFeatures``, ``userId`` in ``metadataMap``; the first
    ``n_train`` rows train, the rest validate.

    With ``parts`` = (training parts, validation parts), e.g.
    :data:`FIXTURE_PARTS`, each path is a directory of
    ``part-<k>.avro`` files holding consecutive row ranges in order, and
    a pool of processes (one per part, at most one per core) writes
    them; the pool starts its workers with ``spawn``, so a caller
    with a live CUDA context passes none of it on. Loaded, the directory
    is the one-file fixture's dataset array for array. Without
    ``parts`` each path is one file, written in this process."""
    rng = np.random.default_rng(seed)
    n = n_train + n_val
    users = (rng.zipf(1.3, size=n) % n_users).astype(np.int64)
    movies = rng.integers(0, n_movies, n)
    Xg = (rng.normal(size=(n, d_global)) / np.sqrt(d_global)).astype(
        np.float32)
    wg = rng.normal(size=d_global).astype(np.float32)
    logits = Xg @ wg + 0.5 * rng.normal(size=n_users)[users].astype(
        np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float64)

    def task(path, lo, hi):
        return path, lo, Xg[lo:hi], y[lo:hi], users[lo:hi], movies[lo:hi]

    if parts is None:
        _write_rows(task(train_path, 0, n_train))
        _write_rows(task(val_path, n_train, n))
        return
    tasks = []
    for path, lo, hi, k in ((train_path, 0, n_train, parts[0]),
                            (val_path, n_train, n, parts[1])):
        os.makedirs(path, exist_ok=True)
        bounds = np.linspace(lo, hi, k + 1).astype(np.int64)
        tasks += [task(os.path.join(path, f"part-{i:05d}.avro"),
                       int(bounds[i]), int(bounds[i + 1]))
                  for i in range(k)]
    import multiprocessing

    procs = min(len(tasks), os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        pool.map(_write_rows, tasks, chunksize=1)


def write_fixture(directory: str, rows: tuple = (2_000, 500),
                  n_users: int = 60, n_movies: int = 40,
                  d_global: int = 64) -> None:
    """A drill fixture: ``train.avro`` and ``validate.avro`` of
    :func:`write_movielens_avro` in ``directory``."""
    os.makedirs(directory, exist_ok=True)
    write_movielens_avro(os.path.join(directory, "train.avro"),
                         os.path.join(directory, "validate.avro"), *rows,
                         n_users, n_movies, d_global)


def _say(msg: str) -> None:
    print(f"drill: {msg}", file=sys.stderr, flush=True)


def _spawn(argv: list, faults: str = "") -> subprocess.Popen:
    env = dict(os.environ)
    env.pop("PHOTON_FAULTS", None)
    env.pop("PHOTON_FAULTS_STATE_DIR", None)
    if faults:
        env["PHOTON_FAULTS"] = faults
    return subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.tools.crash_resume_drill",
         "--worker", *argv], cwd=_REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _run_wave(roles: dict, timeout: float) -> dict:
    """Start every role of ``roles`` ({name: (argv, faults)}) at once and
    wait for all; returns name -> {exit, wall_secs, stdout, stderr,
    worker}."""
    t0 = time.perf_counter()
    procs = {name: _spawn(argv, faults)
             for name, (argv, faults) in roles.items()}
    out = {}
    try:
        for name, proc in procs.items():
            left = max(1.0, timeout - (time.perf_counter() - t0))
            stdout, stderr = proc.communicate(timeout=left)
            worker = [json.loads(line.split(" ", 1)[1])
                      for line in stdout.splitlines()
                      if line.startswith("DRILL_WORKER ")]
            out[name] = {"exit": proc.returncode,
                         "wall_secs": time.perf_counter() - t0,
                         "stdout": stdout, "stderr": stderr,
                         "worker": worker[-1] if worker else None}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _last_snapshot(ckpt_dir: str) -> dict:
    from photon_ml_tpu_torch.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_valid_step()
    if step is None:
        raise AssertionError(f"no intact snapshot in {ckpt_dir}")
    snap = mgr.restore(step)
    # photonlint: allow-W501(the drill stores the step it restored into the snapshot itself; no save site writes it)
    snap["step"] = step
    return snap


def _close(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return abs(a - b) <= METRIC_RTOL * max(abs(a), abs(b))


def _check_ends_like_reference(role: str, snap: dict, ref: dict) -> None:
    for key in ("step", "sweep", "coordinate_index"):
        if snap[key] != ref[key]:
            raise AssertionError(f"{role}: last snapshot {key} {snap[key]} "
                                 f"!= reference {ref[key]}")
    for group in ("states", "scores", "best_states"):
        if ref[group] is None or snap[group] is None:
            if ref[group] is not snap[group]:
                raise AssertionError(f"{role}: {group} present on one side")
            continue
        if set(snap[group]) != set(ref[group]):
            raise AssertionError(f"{role}: {group} keys differ")
        for cid, want in ref[group].items():
            got = snap[group][cid]
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError(
                    f"{role}: {group}[{cid}] is not bit-exact to the "
                    f"reference (max |d| "
                    f"{float(np.abs(got - want).max()):.3g})")
    if not _close(snap["best_metric"], ref["best_metric"]):
        raise AssertionError(f"{role}: best_metric {snap['best_metric']} "
                             f"!= reference {ref['best_metric']}")


def _check_metrics_after_resume(role: str, out_dir: str, ref_out: str,
                                resume_at: tuple) -> int:
    """The resumed run's metrics.json states from ``resume_at`` on equal
    the reference's: objectives bit for bit, validation metrics to
    1e-12 relative. Returns how many states were compared."""
    def states(d):
        (grid,) = json.load(open(os.path.join(d, "metrics.json")))["grid"]
        return {(s["iteration"], s["coordinate"]): s for s in grid["states"]}

    got, want = states(out_dir), states(ref_out)
    order = ["fixed", "perUser"]
    expect = [k for k in want
              if (k[0], order.index(k[1])) >= resume_at]
    if sorted(got) != sorted(expect):
        raise AssertionError(f"{role}: states {sorted(got)} after the resume "
                             f"point, expected {sorted(expect)}")
    for k in expect:
        if got[k]["objective"] != want[k]["objective"]:
            raise AssertionError(
                f"{role}: objective at {k} {got[k]['objective']!r} != "
                f"reference {want[k]['objective']!r}")
        for name, value in want[k]["validation_metrics"].items():
            if not _close(got[k]["validation_metrics"][name], value):
                raise AssertionError(
                    f"{role}: validation {name} at {k} differs from the "
                    f"reference beyond {METRIC_RTOL}")
    return len(expect)


def run_drill(fixture_dir: str, workdir: str, device: str = "cuda",
              timeout: float = 900.0, with_preempt: bool = True) -> dict:
    """Run the six roles and every check; returns the record (per role:
    exit code, wall seconds, the worker's line). Raises on any
    mismatch. ``with_preempt=False`` leaves out the preempt and relaunch
    roles (for a caller that drills the SIGTERM path another way)."""
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.utils.faults import corrupt_path

    dev = resolve_device(device)
    if dev.type == "cuda":
        # build (or find) the kernels once, before any worker starts
        from photon_ml_tpu_torch.ops import kernels_build

        kernels_build.build_all()
    t_all = time.perf_counter()
    train, val = (os.path.join(fixture_dir, f)
                  for f in ("train.avro", "validate.avro"))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    dirs = {r: (os.path.join(workdir, f"{r}_out"),
                os.path.join(workdir, f"{r}_ckpt"))
            for r in ("reference", "crash", "preempt", "corrupt")}
    dirs["resume"], dirs["relaunch"] = dirs["crash"], dirs["preempt"]

    def argv(role):
        out, ckpt = dirs[role]
        return driver_argv(train, val, out, str(device),
                           num_iterations=SWEEPS) + [
            "--checkpoint-dir", ckpt, "--checkpoint-every-coordinates", "1"]

    kill = f"cd.update@{KILL_AT[0]}.{KILL_AT[1]}=kill:1:{KILL_EXIT}"
    sig = f"cd.update@{SIGNAL_AT[0]}.{SIGNAL_AT[1]}=signal"
    wave = {"reference": (argv("reference"), ""),
            "crash": (argv("crash"), kill)}
    if with_preempt:
        wave["preempt"] = (argv("preempt"), sig)
    runs = _run_wave(wave, timeout)
    for role in wave:
        _expect_exit(role, runs[role])
    if os.path.exists(os.path.join(dirs["crash"][0], "metrics.json")):
        raise AssertionError("the crash role finished")
    if with_preempt and f"PHOTON_PREEMPTED step={SIGNAL_AT[0] + 1}.0 " \
            not in runs["preempt"]["stderr"]:
        raise AssertionError(f"preempt: no PHOTON_PREEMPTED line at "
                             f"step {SIGNAL_AT[0] + 1}.0:\n"
                             f"{runs['preempt']['stderr'][-2000:]}")
    _say(f"wave 1: {', '.join(wave)} "
         f"in {max(r['wall_secs'] for r in runs.values()):.1f}s")

    # a copy of the crash's snapshots with every step corrupted
    corrupt_ckpt = dirs["corrupt"][1]
    shutil.copytree(dirs["crash"][1], corrupt_ckpt)
    steps = [n for n in sorted(os.listdir(corrupt_ckpt))
             if n.startswith("step_") and not n.endswith(".tmp")]
    if not steps:
        raise AssertionError("the crash role left no snapshot")
    for name in steps:
        corrupt_path(os.path.join(corrupt_ckpt, name))

    wave = {"resume": (argv("resume"), ""), "corrupt": (argv("corrupt"), "")}
    if with_preempt:
        wave["relaunch"] = (argv("relaunch"), "")
    runs.update(_run_wave(wave, timeout))
    for role in wave:
        _expect_exit(role, runs[role])
    err = runs["corrupt"]["stderr"]
    if "PHOTON_ABORT kind=CheckpointCorruptionError" not in err \
            or "Traceback" in err:
        raise AssertionError(f"corrupt: not a clean abort:\n{err[-2000:]}")
    _say(f"wave 2: {', '.join(wave)} "
         f"in {max(runs[r]['wall_secs'] for r in wave):.1f}s")

    ref = _last_snapshot(dirs["reference"][1])
    compared = {}
    resumed = [("resume", KILL_AT)] + ([("relaunch", (SIGNAL_AT[0] + 1, 0))]
                                       if with_preempt else [])
    for role, resume_at in resumed:
        log = open(os.path.join(dirs[role][0], "game-training.log")).read()
        line = (f"resuming from checkpoint at sweep {resume_at[0]} "
                f"coordinate {resume_at[1]}")
        if line not in log:
            raise AssertionError(f"{role}: the log lacks {line!r}")
        _check_ends_like_reference(role, _last_snapshot(dirs[role][1]), ref)
        compared[role] = _check_metrics_after_resume(
            role, dirs[role][0], dirs["reference"][0], resume_at)
    for role in ["reference"] + [r for r, _ in resumed]:
        w = runs[role]["worker"]
        launches = sum(w["launches_by_path"].values())
        if dev.type == "cuda" and (
                launches <= 0
                or w["launches_by_path"][w["expected_path"]] != launches):
            raise AssertionError(f"{role}: kernel launches "
                                 f"{w['launches_by_path']}, expected all "
                                 f"on {w['expected_path']}")
        if dev.type == "cuda" and any(w["kernel_build_secs"].values()):
            raise AssertionError(f"{role}: rebuilt the kernels "
                                 f"{w['kernel_build_secs']}")
    return {
        "roles": {r: {"exit": v["exit"], "wall_secs": v["wall_secs"],
                      "worker": v["worker"]} for r, v in runs.items()},
        "snapshot_step": ref["step"], "states_compared_after_resume": compared,
        "corrupted_steps": len(steps),
        "seconds": time.perf_counter() - t_all}


def _expect_exit(role: str, run: dict) -> None:
    if run["exit"] != EXPECTED_EXIT[role]:
        raise AssertionError(
            f"{role}: exit {run['exit']}, expected {EXPECTED_EXIT[role]}\n"
            f"{run['stdout'][-2000:]}\n{run['stderr'][-4000:]}")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] in (["--worker"], ["--worker-updates"]):
        run_worker(argv[1:], report_updates=argv[0] == "--worker-updates")
        return
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fixture-dir", default=None,
                    help="directory with train.avro and validate.avro "
                         "(default: a small fixture written into the "
                         "work directory)")
    ap.add_argument("--workdir", default=None,
                    help="scratch directory (default: a fresh temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every role (default cuda; no "
                         "fallback to the CPU)")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="crash_resume_drill_")
    fixture = args.fixture_dir
    if fixture is None:
        fixture = os.path.join(workdir, "fixture")
        write_fixture(fixture)
    record = run_drill(fixture, os.path.join(workdir, "roles"),
                       device=args.device)
    print(json.dumps(record), flush=True)
    print(f"DRILL_OK device={args.device} "
          f"snapshot_step={record['snapshot_step']} "
          f"seconds={record['seconds']:.1f}", flush=True)


if __name__ == "__main__":
    main()
