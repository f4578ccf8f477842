"""The port's run supervision held against the JAX package's, on the CPU.

- A supervised relaunch keeps the evidence: the port's training driver
  and service, run twice in one trace dir with
  ``PHOTON_GAME_SUPERVISED=1``, leave ``trace.json.prev``,
  ``spans.jsonl.prev``, ``run_manifest.json.prev`` and one
  ``run_restart`` record after the first incarnation's records, as the
  JAX driver and service do.
- ``photon_ml_tpu_torch/tools/photon_supervise.py``'s ``supervise``
  against ``tools/photon_supervise.py``'s over one scripted stub child
  (a module written here that plays one incarnation a launch: exit 0,
  75, 19 or 3 at a (sweep, coordinate), or a stalled heartbeat that
  ignores SIGTERM): the ``supervisor.jsonl`` actions (``t`` and ``pid``
  dropped), the argv each child got and the exit codes are equal, the
  degradation ladder's cases with ``TRAIN_MODULE`` patched to the stub
  in both tools. The stall case does not race the heartbeat's own clock:
  the stub writes a stalled heartbeat itself, and the supervisors'
  startup grace only has to outlast a stub's start.
- The port's supervisor over the port's training driver (``--device
  cpu``) through two SIGTERMs and a kill: ``restarts=3`` and the final
  objective equal to an uninterrupted run bit for bit.
- ``supervise_fleet`` over two CPU services and the router: one member
  killed once, relaunched and re-admitted, the stop file drains the
  fleet to exit 0, and both tools' ``compute_fleet`` read the fleet dir
  alike.
- The device rule: a CUDA child on a host without CUDA is refused before
  anything is spawned (``tests/test_torch_boundary.py`` holds the rest).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import jax
import pytest
import torch

from photon_ml_tpu.cli import game_training_driver as jtd
from photon_ml_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
from photon_ml_tpu.serve import service as jservice
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.serve import service as tservice
from photon_ml_tpu_torch.tools import photon_status as tst
from photon_ml_tpu_torch.tools import photon_supervise as tsup
from test_torch_drivers import SECTIONS, TRAIN_FLAGS, make_game_avro

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPERVISED = "PHOTON_GAME_SUPERVISED"


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsup = _jax_tool("photon_supervise")
jst = jsup.photon_status


@pytest.fixture(scope="module")
def game_avro(tmp_path_factory):
    d = tmp_path_factory.mktemp("supervise")
    train, val = str(d / "train.avro"), str(d / "val.avro")
    make_game_avro(train, seed=0)
    make_game_avro(val, n=200, seed=1)
    return train, val


# ---------------------------------------------------------------------------
# Step 0: a supervised relaunch rotates and appends instead of truncating
# ---------------------------------------------------------------------------


def _marks(trace_dir) -> list:
    with open(os.path.join(trace_dir, "metrics.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f if line.strip()]
    return [k for k in kinds if k in ("run_restart", "run_end")]


def _run_twice(run, trace_dir) -> dict:
    for _ in range(2):
        run()
    files = set(os.listdir(trace_dir))
    with open(os.path.join(trace_dir, "metrics.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f if line.strip()]
    restart = kinds.index("run_restart")
    # a heartbeat lands in a short run or not, in either package
    return {"files": files - {"exemplars.jsonl", "photon-serve.log"},
            "marks": _marks(trace_dir),
            "kinds_before_restart": set(kinds[:restart]) - {"heartbeat"}}


def _train(pkg, train, val, out, trace):
    """One sweep of the fixed effect alone (the JAX driver's cold jit of
    the GLMix argv costs ~30 s here; the telemetry files are the same)."""
    argv = ["--train-input-dirs", train, "--task-type",
            "LOGISTIC_REGRESSION",
            "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
            "--updating-sequence", "fixed", "--num-iterations", "1",
            "--fixed-effect-data-configurations", "fixed:global,1",
            "--fixed-effect-optimization-configurations",
            "fixed:10,1e-7,10,1,LBFGS,L2", "--output-dir", out,
            "--trace-dir", trace, "--trace-heartbeat-seconds", "0.05",
            "--delete-output-dir-if-exists", "true"]
    if pkg == "torch":
        return lambda: ttd.run(argv + ["--device", "cpu"])
    one = jax.devices()[:1]

    def run():
        # one device, as the port runs
        with jax.enable_x64(False), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "devices", lambda *a, **k: one)
            jtd.main(argv)
    return run


def _serve(pkg, model_dir, trace, tmp_path):
    stop = tmp_path / f"{pkg}-stop"
    stop.write_text("")  # boot, then a scheduled stop: exit 0
    argv = ["--game-model-input-dir", model_dir,
            "--feature-shard-id-to-feature-section-keys-map",
            "global:globalFeatures|user:userFeatures",
            "--random-effect-id-set", "userId",
            "--listen", f"unix:{tmp_path / f'{pkg}.sock'}",
            "--trace-dir", trace, "--trace-heartbeat-seconds", "0.05",
            "--stop-file", str(stop)]
    if pkg == "torch":
        return lambda: tservice.main(argv + ["--device", "cpu"])
    return lambda: jservice.main(argv)


@pytest.mark.parametrize("entry", ["driver", "service"])
def test_supervised_relaunch_keeps_the_evidence_as_the_jax_package_does(
        entry, game_avro, tmp_path, monkeypatch):
    monkeypatch.setenv(SUPERVISED, "1")
    got = {}
    if entry == "service":
        from test_serve import _build_model_dir

        model_dir = _build_model_dir(str(tmp_path / "model"))
    for pkg in ("jax", "torch"):
        # both registries empty, as in a fresh process: the exit snapshot
        # holds what this run observed, not what an earlier test in this
        # worker left there
        JAX_REGISTRY.reset()
        REGISTRY.reset()
        trace = str(tmp_path / f"{pkg}-trace")
        run = (_train(pkg, *game_avro, str(tmp_path / f"{pkg}-out"), trace)
               if entry == "driver" else
               _serve(pkg, model_dir, trace, tmp_path))
        got[pkg] = _run_twice(run, trace)
    assert got["torch"] == got["jax"]
    port = got["torch"]
    assert {"trace.json.prev", "spans.jsonl.prev",
            "run_manifest.json.prev"} <= port["files"]
    # one run_restart, after the first incarnation's run_end
    assert port["marks"] == ["run_end", "run_restart", "run_end"]
    assert "run_end" in port["kinds_before_restart"]


def test_unsupervised_rerun_still_truncates(game_avro, tmp_path,
                                            monkeypatch):
    monkeypatch.delenv(SUPERVISED, raising=False)
    trace = str(tmp_path / "trace")
    run = _train("torch", *game_avro, str(tmp_path / "out"), trace)
    run()
    run()
    assert not any(f.endswith(".prev") for f in os.listdir(trace))
    assert _marks(trace) == ["run_end"]


# ---------------------------------------------------------------------------
# The scripted stub child
# ---------------------------------------------------------------------------

STUB_MODULE = "_photon_supervise_stub"
STUB = '''"""One incarnation of a scripted run for the supervisor tests."""
import argparse, json, os, signal, sys, time

p = argparse.ArgumentParser()
p.add_argument("--plan", required=True)
p.add_argument("--trace-dir", required=True)
ns, rest = p.parse_known_args()
count = ns.plan + ".launches"
attempt = int(open(count).read()) if os.path.exists(count) else 0
with open(count, "w") as f:
    f.write(str(attempt + 1))
with open(ns.plan + ".argv", "a") as f:
    f.write(json.dumps(rest) + "\\n")
with open(ns.plan + ".pid", "w") as f:
    f.write(str(os.getpid()))
plan = json.load(open(ns.plan))
step = plan[min(attempt, len(plan) - 1)]
os.makedirs(ns.trace_dir, exist_ok=True)
metrics = os.path.join(ns.trace_dir, "metrics.jsonl")
spans = os.path.join(ns.trace_dir, "spans.jsonl")


def append(path, rec):
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\\n")


# a supervised relaunch marks the metrics stream, as ObservedRun does
if os.environ.get("PHOTON_GAME_SUPERVISED") and os.path.exists(metrics):
    append(metrics, {"kind": "run_restart"})
else:
    open(metrics, "w").close()
append(metrics, {"kind": "run_manifest"})
for sweep, coordinate in step["updates"]:
    append(spans, {"name": "cd.update", "dur_us": 1.0,
                   "labels": {"sweep": sweep, "coordinate": coordinate}})
append(metrics, {"kind": "heartbeat", "uptime_s": 0.1,
                 "stalled": bool(step.get("stall")), "metric_totals": {}})
if step.get("stall"):
    # wedged: the graceful stop never lands, only SIGKILL ends it
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    time.sleep(120)
    sys.exit(99)
status = {0: "ok", 75: "preempted", 3: "abort"}.get(step["rc"])
if status:
    append(metrics, {"kind": "run_end", "status": status, "reason": ""})
sys.exit(step["rc"])
'''


@pytest.fixture
def stub(tmp_path, monkeypatch):
    (tmp_path / f"{STUB_MODULE}.py").write_text(STUB)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(tmp_path), os.environ.get("PYTHONPATH")) if p))
    return tmp_path


def _at(sweep, coordinate="perUser"):
    return [[sweep, "fixed"], [sweep, coordinate]][:1 + (
        coordinate == "perUser")]


#: (plan, supervise kwargs, the ladder engaged, expected exit code)
CASES = {
    "ok": ([{"rc": 0, "updates": _at(1)}], {}, False, 0),
    "preempted_then_ok": ([{"rc": 75, "updates": _at(0, "fixed")},
                           {"rc": 0, "updates": _at(1)}], {}, False, 0),
    "killed_then_ok": ([{"rc": 19, "updates": _at(0)},
                        {"rc": 0, "updates": _at(1)}], {}, False, 0),
    "clean_abort": ([{"rc": 3, "updates": _at(0)}], {}, False, 3),
    "stall": ([{"stall": True, "updates": _at(0, "fixed")},
               {"rc": 0, "updates": _at(1)}],
              {"startup_grace_seconds": 4.0, "grace_seconds": 0.5}, False,
              0),
    "ladder_exhausted": ([{"rc": 19, "updates": _at(1)}] * 6,
                         {"degrade_after": 2, "max_restarts": 8}, True, 3),
    # the default ladder and budget: only the first incarnation closes an
    # update, and each later one dies before it closes one, so the ladder
    # reads the first one's position every time and is exhausted before
    # the restart budget
    "ladder_exhausted_without_progress": (
        [{"rc": 19, "updates": _at(1)}] + [{"rc": 19, "updates": []}] * 6,
        {}, True, 3),
    "ladder_recovers": ([{"rc": 19, "updates": _at(1)}] * 2
                        + [{"rc": 0, "updates": _at(2)}],
                        {"degrade_after": 2}, True, 0),
    "budget_exhausted": ([{"rc": 19, "updates": _at(s)} for s in range(4)],
                         {"max_restarts": 2}, False, 1),
}


def _supervise(mod, root, plan, kwargs, ladder, monkeypatch):
    os.makedirs(root)
    plan_path = os.path.join(root, "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    if ladder:
        monkeypatch.setattr(mod, "TRAIN_MODULE", STUB_MODULE)
    args = ["--plan", plan_path, "--trace-dir",
            os.path.join(root, "trace"), "--device", "cpu"]
    kw = {"backoff_base": 0.01, "backoff_max": 0.05, "poll_seconds": 0.1,
          "startup_grace_seconds": 0.0, "grace_seconds": 5.0, **kwargs}
    rc = mod.supervise(args, module=STUB_MODULE, **kw)
    recs = [json.loads(line) for line in open(
        os.path.join(root, "trace", "supervisor.jsonl"))]
    actions = [{k: v for k, v in r.items() if k not in ("t", "pid")}
               for r in recs]
    argvs = [json.loads(line) for line in open(plan_path + ".argv")]
    return rc, actions, argvs


@pytest.mark.parametrize("case", sorted(CASES))
def test_supervise_equals_the_jax_supervisor(case, stub, tmp_path,
                                             monkeypatch):
    plan, kwargs, ladder, code = CASES[case]
    # both supervisors at once: the stall case waits out its grace once
    with contextlib.redirect_stdout(io.StringIO()), \
            concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {name: pool.submit(
            _supervise, mod, str(tmp_path / name), plan, kwargs, ladder,
            monkeypatch) for name, mod in (("jax", jsup), ("torch", tsup))}
        got = {name: f.result(timeout=120) for name, f in futures.items()}
    assert got["torch"] == got["jax"]
    rc, actions, argvs = got["torch"]
    assert rc == code
    names = [a["action"] for a in actions]
    assert names[0] == "launch"
    assert ("degrade" in names) == ladder
    if case == "stall":
        assert names[1:4] == ["stall_kill", "escalate_kill", "exit"]
        assert actions[3]["rc"] == -9 and actions[3]["stall_killed"]
    if case.startswith("ladder_exhausted"):
        assert [a["level"] for a in actions if a["action"] == "degrade"] \
            == [1, 2]
        assert actions[-1]["reason"] == "degradation ladder exhausted"
        assert actions[-1]["position"] == str((1, "perUser"))
        assert argvs[2][-2:] == ["--cd-pipeline-depth", "0"]
        assert argvs[4][-4:] == ["--cd-pipeline-depth", "0",
                                 "--cd-block-size", "1"]
    if case == "budget_exhausted":
        assert actions[-1]["reason"] == "restart budget exhausted"
    if code == 0:
        assert names[-1] == "done"


def test_a_stale_stall_verdict_never_kills_the_successor(stub, tmp_path):
    """The port's supervisor reads each incarnation from its launch on: a
    stalled heartbeat the killed incarnation left is not its
    successor's, even with no startup grace at all."""
    plan = [{"stall": True, "updates": _at(0, "fixed")},
            {"rc": 0, "updates": _at(1)}]
    root = str(tmp_path / "torch")
    with contextlib.redirect_stdout(io.StringIO()):
        rc, actions, _ = _supervise(tsup, root, plan,
                                    {"grace_seconds": 0.5}, False, None)
    assert rc == 0
    assert [a["action"] for a in actions].count("stall_kill") == 1


def test_a_sigtermed_supervisor_leaves_no_child(stub, tmp_path):
    """As a process, the supervisor unwinds a SIGTERM through its kill
    path: exit 143 and its wedged child gone with it."""
    plan = str(tmp_path / "plan.json")
    with open(plan, "w") as f:
        json.dump([{"stall": True, "updates": _at(0)}], f)
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.tools.photon_supervise",
         "--startup-grace-seconds", "600", "--module", STUB_MODULE, "--",
         "--plan", plan,
         "--trace-dir", str(tmp_path / "trace"), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(plan + ".pid") \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.2)  # the stub has written its pid; let it settle
        child = int(open(plan + ".pid").read())
        proc.terminate()
        assert proc.wait(timeout=30) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with pytest.raises(ProcessLookupError):
        os.kill(child, 0)


# ---------------------------------------------------------------------------
# End to end: the port's supervisor over the port's training driver
# ---------------------------------------------------------------------------


def _driver_argv(game_avro, root) -> list:
    train, val = game_avro
    return ["--train-input-dirs", train, "--validate-input-dirs", val,
            *TRAIN_FLAGS, "--output-dir", os.path.join(root, "out"),
            "--checkpoint-dir", os.path.join(root, "ckpt"),
            "--checkpoint-every-coordinates", "1",
            "--trace-dir", os.path.join(root, "trace"),
            "--trace-heartbeat-seconds", "0.2", "--device", "cpu"]


def _env(**faults) -> dict:
    env = dict(os.environ)
    for k in ("PHOTON_FAULTS", "PHOTON_FAULTS_STATE_DIR", SUPERVISED):
        env.pop(k, None)
    env.update(faults)
    return env


def _objective(root):
    with open(os.path.join(root, "out", "metrics.json")) as f:
        return json.load(f)["grid"][0]["states"][-1]["objective"]


def test_supervised_port_driver_ends_bit_exact(game_avro, tmp_path):
    """``tests/test_preempt.py:406``'s faults on the port: two SIGTERM
    preemptions and a kill in one supervised run, four incarnations, the
    final objective the uninterrupted run's bit for bit."""
    ref = str(tmp_path / "ref")
    done = subprocess.run(
        [sys.executable, "-m", tsup.TRAIN_MODULE,
         *_driver_argv(game_avro, ref)], env=_env(), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    run = str(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.tools.photon_supervise",
         "--max-restarts", "5", "--backoff-base", "0.05", "--backoff-max",
         "0.2", "--poll-seconds", "0.2", "--startup-grace-seconds", "60",
         "--", *_driver_argv(game_avro, run)],
        env=_env(PHOTON_FAULTS="cd.update@0.1=signal:1;"
                               "cd.update@1.0=signal:1;"
                               "cd.update@1.1=kill:1:19",
                 PHOTON_FAULTS_STATE_DIR=str(tmp_path / "fault_state")),
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr[-3000:]}"
    assert "PHOTON_SUPERVISE_OK restarts=3" in proc.stdout
    assert _objective(run) == _objective(ref)
    trace = os.path.join(run, "trace")
    recs = [json.loads(line) for line in open(
        os.path.join(trace, "supervisor.jsonl"))]
    exits = [(r["rc"], r["preempted"]) for r in recs
             if r["action"] == "exit"]
    assert exits == [(75, True), (75, True), (19, False)]
    assert _marks(trace) == ["run_end", "run_restart", "run_end",
                             "run_restart", "run_restart", "run_end"]
    status = tst.compute_status(tst.read_run_dir(trace))
    assert status == jst.compute_status(jst.read_run_dir(trace))
    assert status["status"] == "finished"


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------


def _router_members(endpoint):
    from photon_ml_tpu_torch.serve.protocol import ServeClient

    with ServeClient(endpoint, timeout=30.0) as c:
        return c.stats()["fleet"]["members"]


def _wait(what, test, proc, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, f"the supervisor exited waiting for " \
                                    f"{what}"
        try:
            if test():
                return
        except (OSError, ConnectionError, ValueError, KeyError):
            pass  # not up yet
        time.sleep(0.1)
    raise AssertionError(f"never {what}")


def test_supervise_fleet_relaunches_a_killed_member(tmp_path):
    from test_serve import _build_model_dir, _make_records

    from photon_ml_tpu_torch.serve.protocol import ServeClient

    model_dir = _build_model_dir(str(tmp_path / "model"))
    fleet_dir = str(tmp_path / "fleet")
    stop = str(tmp_path / "STOP")
    router = f"unix:{tmp_path / 'r.sock'}"
    log = open(tmp_path / "supervisor.out", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.tools.photon_supervise",
         "--fleet", "2", "--fleet-dir", fleet_dir, "--router-listen",
         router, "--stop-file", stop, "--backoff-base", "0.05",
         "--poll-seconds", "0.1", "--grace-seconds", "20", "--",
         "--game-model-input-dir", model_dir,
         "--feature-shard-id-to-feature-section-keys-map",
         "global:globalFeatures|user:userFeatures",
         "--random-effect-id-set", "userId", "--device", "cpu",
         "--trace-heartbeat-seconds", "0.2"],
        # the first batch any member scores kills it, once
        env=_env(PHOTON_FAULTS="serve.batch=kill:1:19",
                 PHOTON_FAULTS_STATE_DIR=str(tmp_path / "fault_state")),
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT, text=True)
    sup_path = os.path.join(fleet_dir, "supervisor.jsonl")

    def records():
        with open(sup_path) as f:
            return [json.loads(line) for line in f if line.strip()]

    try:
        _wait("two healthy members", lambda: all(
            m["state"] == "healthy" for m in _router_members(router)), proc)
        rows = _make_records()
        with ServeClient(router, timeout=60.0) as c:
            first = c.score(rows)
            _wait("a relaunch", lambda: any(
                r["action"] == "relaunch_member" for r in records()), proc)
            (killed,) = {r["member"] for r in records()
                         if r["action"] == "member_exit"}
            _wait("the re-admission", lambda: _router_members(router)[
                killed]["admissions"] >= 2 and all(
                m["state"] == "healthy" for m in _router_members(router)),
                proc)
            after = [c.score(rows) for _ in range(3)]
        open(stop, "w").close()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    out = (tmp_path / "supervisor.out").read_text()
    assert rc == 0, out[-4000:]
    assert "PHOTON_SUPERVISE_OK restarts=1" in out
    for resp in [first, *after]:
        assert resp["kind"] == "scores" and resp["uids"] == [
            r["uid"] for r in rows]
        assert resp["scores"] == first["scores"]
    mine = [r for r in records() if r.get("member") == killed]
    assert [r["action"] for r in mine][:5] == [
        "launch_member", "member_exit", "backoff", "relaunch_member",
        "launch_member"]
    assert mine[1]["rc"] == 19
    fleet = tst.compute_fleet(fleet_dir)
    assert fleet == jst.compute_fleet(fleet_dir)
    assert [r["member"] for r in fleet["fleet"]] == [0, 1]
    assert fleet["router"] is not None and fleet["exit_code"] == 0
    member = os.path.join(fleet_dir, f"member{killed}")
    assert "spans.jsonl.prev" in os.listdir(member)
    assert _marks(member).count("run_restart") == 1


# ---------------------------------------------------------------------------
# The device rule
# ---------------------------------------------------------------------------


def test_device_is_the_last_device_flag_and_defaults_to_the_card():
    assert tsup._flag_value(["--device", "cuda", "--device=cpu"],
                            "--device") == "cpu"
    assert tsup.DEFAULT_DEVICE == "cuda"
    # the router takes no device: never refused
    tsup.check_device([], tsup.ROUTER_MODULE)
    tsup.check_device(["--device", "cpu"], tsup.SERVE_MODULE)
