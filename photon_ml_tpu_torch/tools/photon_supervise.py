"""photon-supervise: a self-healing single-machine run supervisor.

Port of ``tools/photon_supervise.py``: ``Recorder`` (``:105``),
``StatusSource`` (``:129``, over the port's own
``photon_ml_tpu_torch/tools/photon_status.py``), ``_position``
(``:152``), ``_terminate_gracefully`` (``:165``), ``supervise``
(``:186``), ``supervise_fleet`` (``:314``) and ``main`` (``:457``), with
the same flags, ``supervisor.jsonl`` records and exit codes, over the
port's training driver, service and router. The backoff is the port's
:class:`~photon_ml_tpu_torch.parallel.multihost.WorkerSupervisor`
policy, whose delays equal the JAX one's.

Wraps one ``game_training_driver`` run and keeps it alive through the
failure modes the chaos campaign drills:

- **crash** (any nonzero exit: a scripted ``kill``, an OOM, a bug) —
  relaunch with resume (the driver restores its ``--checkpoint-dir``
  automatically) under the same bounded-exponential-backoff policy the
  multi-process :class:`WorkerSupervisor` uses;
- **preemption** (exit 75, the driver honored a SIGTERM/deadline/stop
  file at a commit barrier) — same relaunch path, no backoff penalty
  beyond the policy's;
- **stall** (the run's heartbeat flags ``stalled`` — a wedged I/O, a
  hung collective) — detected by tailing the run dir (or consuming the
  telemetry endpoint) through ``photon_status``'s exit-code contract,
  then SIGTERM (the graceful window) → ``--grace-seconds`` → SIGKILL →
  relaunch;
- **repeated failure at the same coordinate** — the degradation
  ladder: after ``--degrade-after`` failures pinned to one
  (sweep, coordinate) position, relaunch with CD pipelining disabled
  (``--cd-pipeline-depth 0``, bit-exact semantics, simpler execution);
  if it STILL fails there, force fully sequential semantics
  (``--cd-block-size 1``, the well-understood convergence baseline);
  if even sequential mode fails at that coordinate, abort clean — the
  failure is in the model/data, not the execution strategy.

Every action (launch, exit, stall_kill, degrade, abort, done) is
recorded as an NDJSON telemetry record in ``<run-dir>/supervisor.jsonl``
and echoed as a ``PHOTON_SUPERVISE`` line on stdout. Children run with
``PHOTON_GAME_SUPERVISED=1``, so a relaunched incarnation keeps the
previous one's telemetry (``run_restart`` in ``metrics.jsonl``, the
other files rotated to ``.prev``).

One difference from the JAX supervisor: each incarnation's stall and
``run_end`` verdicts are read from a view of the run dir that starts
past what the files held at its launch (``RunDirTailer(from_end=True)``),
so a stalled heartbeat or a ``run_end`` left by a killed incarnation is
never read as its successor's, however long the successor takes to
start. The JAX view reads the whole appended stream and relies on
``--startup-grace-seconds`` outlasting the successor's start. The
degradation ladder's position is read as the JAX supervisor reads it,
from a fresh tailer over the whole run dir, so the ladder climbs where
JAX's does.

**The device rule** (the port's, not a JAX behaviour): the supervisor
adds no ``--device`` and never turns a run toward the CPU. The child's
device is the last ``--device`` of its argv, the card by default as in
the drivers and the service (fleet members too). Where that is CUDA and
the host has none, it refuses before the first spawn with
:func:`~photon_ml_tpu_torch.device.resolve_device`'s ``RuntimeError``,
as the multi-process supervisor does, instead of spending its restart
budget on children that each die for want of a card. The router takes
no device and is exempt. torch is imported only for that check and for
``WorkerSupervisor``.

Exit codes: ``0`` — the run completed (possibly after restarts);
``3`` — clean abort (the driver hit a documented terminal condition,
or the degradation ladder exhausted); ``1`` — restart budget exhausted;
``143`` — the supervisor itself got SIGTERM: as a process it unwinds
through the kill paths that an interrupt takes in the JAX tool, so no
child outlives it.

Everything after ``--`` is passed to the driver verbatim (give it a
``--checkpoint-dir`` or relaunches restart from scratch, and a
``--trace-dir`` or stalls go undetected)::

    python -m photon_ml_tpu_torch.tools.photon_supervise --max-restarts 5 -- \
        --train-input-dirs data --output-dir out \
        --checkpoint-dir out/ckpt --trace-dir out/trace ...
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from photon_ml_tpu_torch.tools import photon_status

CLEAN_ABORT_EXIT = 3
PREEMPTED_EXIT = 75
#: The default supervised module. ``--module`` swaps in any entrypoint
#: that speaks the same exit-code contract (0/3/75/scripted-kill) — the
#: scoring service (``photon_ml_tpu_torch.serve.service``) is the other
#: in-tree citizen.
TRAIN_MODULE = "photon_ml_tpu_torch.cli.game_training_driver"
#: Fleet mode's members and front end (``--fleet N``).
SERVE_MODULE = "photon_ml_tpu_torch.serve.service"
ROUTER_MODULE = "photon_ml_tpu_torch.serve.router"
#: the drivers' and the service's ``--device`` default
DEFAULT_DEVICE = "cuda"
# the ladder: level 0 runs the operator's args untouched; each level
# appends flags (argparse last-occurrence-wins, so appending overrides).
# The flags are training-driver CD semantics — the ladder only engages
# when the supervised module IS the training driver.
DEGRADE_LADDER = (
    [],
    ["--cd-pipeline-depth", "0"],
    ["--cd-pipeline-depth", "0", "--cd-block-size", "1"],
)


def _flag_value(args: list[str], flag: str):
    """LAST occurrence of ``--flag value`` in the driver args (matching
    argparse's resolution), or None."""
    value = None
    for i, a in enumerate(args):
        if a == flag and i + 1 < len(args):
            value = args[i + 1]
        elif a.startswith(flag + "="):
            value = a.split("=", 1)[1]
    return value


def check_device(args: list[str], module: str) -> None:
    """The device rule (module docstring): refuse a child whose last
    ``--device`` (default :data:`DEFAULT_DEVICE`) is CUDA on a host
    without CUDA, by :func:`resolve_device`'s ``RuntimeError``. No CUDA
    context is made here; the router is exempt."""
    if module == ROUTER_MODULE:
        return
    import torch

    from photon_ml_tpu_torch.device import resolve_device

    device = _flag_value(args, "--device") or DEFAULT_DEVICE
    if torch.device(device).type == "cuda" \
            and not torch.cuda.is_available():
        resolve_device(device)


class Recorder:
    """NDJSON supervisor-action log + the stdout echo. The file lives in
    the run dir next to the driver's telemetry streams (its name matches
    none of photon_status's tail patterns, so it never double-counts
    into the run's own status)."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def __call__(self, action: str, **fields) -> None:
        rec = {"kind": "supervisor", "action": action,
               "t": round(time.time(), 3), **fields}
        if self.path:
            try:
                with open(self.path, "a") as fh:
                    fh.write(json.dumps(rec) + "\n")
            except OSError:
                pass  # a dead disk must not take the supervisor down
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"PHOTON_SUPERVISE {action} {detail}".rstrip(), flush=True)


class StatusSource:
    """One incarnation's view of the run's telemetry: a run-dir tailer
    that starts past what the files held at the launch (the driver
    appends to ``metrics.jsonl`` and rotates the other files to
    ``.prev`` on relaunch, so only the new incarnation's records follow)
    or a slice of the listen collector's accumulated records. The stall
    and ``run_end`` verdicts come from that view; the ladder's position
    comes from a second, fresh tailer over the whole run dir, the JAX
    supervisor's one view (see :meth:`position`)."""

    def __init__(self, run_dir: str | None, collector=None):
        self._collector = collector
        self._offset = 0
        self._tailer = self._history = None
        if collector is not None:
            self._offset = len(collector.records())
        elif run_dir:
            self._tailer = photon_status.RunDirTailer(run_dir, from_end=True)
            self._history = photon_status.RunDirTailer(run_dir)

    def status(self) -> dict | None:
        if self._collector is not None:
            return photon_status.compute_status(
                self._collector.records()[self._offset:])
        if self._tailer is not None:
            # the whole view reads at every poll, as the JAX one does: its
            # first poll finds the previous incarnation's spans before the
            # new one rotates them
            self._history.poll()
            return photon_status.compute_status(self._tailer.poll())
        return None

    def position(self):
        """The ladder's (sweep, coordinate), read as the JAX supervisor
        reads it: from everything the whole view has seen, so an
        incarnation that dies before it closes a ``cd.update`` span keeps
        the position of the records it found at its launch."""
        if self._history is not None:
            return _position(photon_status.compute_status(
                self._history.poll()))
        return _position(self.status())


def _position(status: dict | None):
    """The run's (sweep, last_coordinate) — the degradation ladder's
    failure-locality key."""
    if not status:
        return None
    p0 = (status.get("processes") or {}).get(0)
    if not p0:
        return None
    if p0.get("sweep") is None and p0.get("last_coordinate") is None:
        return None
    return (p0.get("sweep"), p0.get("last_coordinate"))


def _terminate_gracefully(proc: subprocess.Popen, grace: float,
                          record: Recorder) -> None:
    """SIGTERM (the driver's graceful-stop window: it will snapshot at
    its next commit barrier and exit 75) → grace → SIGKILL (a wedged
    run never reaches a barrier; PEP 475 means even a sleeping run
    resumes its sleep after the handler)."""
    try:
        proc.send_signal(signal.SIGTERM)
    except OSError:
        return
    try:
        proc.wait(timeout=grace)
    except subprocess.TimeoutExpired:
        record("escalate_kill", pid=proc.pid, grace_seconds=grace)
        try:
            proc.kill()
        except OSError:
            pass
        proc.wait()


def supervise(driver_args: list[str], *, max_restarts: int = 5,
              backoff_base: float = 0.5, backoff_max: float = 15.0,
              grace_seconds: float = 10.0, poll_seconds: float = 0.5,
              startup_grace_seconds: float = 5.0, degrade_after: int = 2,
              listen: str | None = None, run_dir: str | None = None,
              python: str | None = None,
              module: str = TRAIN_MODULE) -> int:
    """Run the driver to completion through crashes, preemptions, and
    stalls. Returns the supervisor's exit code (see module docstring).
    A CUDA child on a host without CUDA raises ``RuntimeError`` before
    anything is spawned or written."""
    check_device(driver_args, module)
    from photon_ml_tpu_torch.parallel.multihost import WorkerSupervisor

    run_dir = run_dir or _flag_value(driver_args, "--trace-dir")
    out_dir = _flag_value(driver_args, "--output-dir")
    log_dir = run_dir or out_dir
    record = Recorder(os.path.join(log_dir, "supervisor.jsonl")
                      if log_dir else None)
    # reuse the multi-host supervisor's backoff POLICY (exponential +
    # deterministic jitter) without its run loop — this loop also has
    # stall detection and the ladder to drive
    policy = WorkerSupervisor(
        spawn=lambda attempt: None, max_restarts=max_restarts,
        backoff_base_seconds=backoff_base,
        backoff_max_seconds=backoff_max, name="photon-supervise")

    collector = photon_status.ListenCollector(listen) if listen else None
    ladder_level = 0
    fail_position = None
    fails_at_position = 0
    restarts = 0
    attempt = 0
    try:
        while True:
            attempt += 1
            args = list(driver_args) + (DEGRADE_LADDER[ladder_level]
                                        if module == TRAIN_MODULE else [])
            env = dict(os.environ)
            env["PHOTON_GAME_SUPERVISED"] = "1"
            record("launch", attempt=attempt, ladder_level=ladder_level,
                   restarts=restarts)
            proc = subprocess.Popen(
                [python or sys.executable, "-m", module, *args],
                env=env)
            source = StatusSource(run_dir, collector)
            spawn_t = time.monotonic()
            stall_killed = False
            try:
                while proc.poll() is None:
                    time.sleep(poll_seconds)
                    status = source.status()
                    if (status is not None
                            and status["exit_code"]
                            == photon_status.EXIT_STALLED
                            and time.monotonic() - spawn_t
                            >= startup_grace_seconds):
                        record("stall_kill", pid=proc.pid,
                               sweep=status.get("sweep"),
                               position=str(source.position()))
                        stall_killed = True
                        _terminate_gracefully(proc, grace_seconds,
                                              record)
                        break
                rc = proc.wait()
            except BaseException:
                # an interrupted supervisor must not orphan the driver
                try:
                    proc.kill()
                except OSError:
                    pass
                proc.wait()
                raise
            if rc == 0:
                record("done", restarts=restarts, attempts=attempt)
                print(f"PHOTON_SUPERVISE_OK restarts={restarts}",
                      flush=True)
                return 0
            position = source.position()
            record("exit", rc=rc, attempt=attempt,
                   preempted=(rc == PREEMPTED_EXIT),
                   stall_killed=stall_killed, position=str(position))
            if rc == CLEAN_ABORT_EXIT:
                # a documented terminal condition (PHOTON_ABORT): the
                # driver told us retrying cannot help
                record("abort", reason="driver clean abort", rc=rc)
                return CLEAN_ABORT_EXIT
            # the degradation ladder tracks FAILURES pinned to one
            # coordinate; an honored preemption is progress, not
            # failure. Its rungs are training-only CD flags, so other
            # modules restart at level 0 forever instead of climbing.
            if rc != PREEMPTED_EXIT and module == TRAIN_MODULE:
                if position == fail_position:
                    fails_at_position += 1
                else:
                    fail_position, fails_at_position = position, 1
                if fails_at_position >= degrade_after:
                    if ladder_level + 1 < len(DEGRADE_LADDER):
                        ladder_level += 1
                        fails_at_position = 0
                        record("degrade", level=ladder_level,
                               flags=" ".join(
                                   DEGRADE_LADDER[ladder_level]),
                               position=str(fail_position))
                    else:
                        record("abort",
                               reason="degradation ladder exhausted",
                               position=str(fail_position))
                        print(f"PHOTON_ABORT "
                              f"kind=SupervisorDegradationExhausted: "
                              f"run keeps failing at {fail_position} "
                              f"even with sequential CD semantics",
                              file=sys.stderr, flush=True)
                        return CLEAN_ABORT_EXIT
            restarts += 1
            if restarts > max_restarts:
                record("abort", reason="restart budget exhausted",
                       restarts=restarts - 1, last_rc=rc)
                print(f"PHOTON_SUPERVISE_EXHAUSTED "
                      f"restarts={restarts - 1} last_rc={rc}",
                      file=sys.stderr, flush=True)
                return 1
            delay = policy.backoff_seconds(restarts)
            record("backoff", seconds=round(delay, 2), restart=restarts)
            time.sleep(delay)
    finally:
        if collector is not None:
            collector.close()


def supervise_fleet(member_args: list[str], *, fleet: int,
                    fleet_dir: str, router_listen: str | None = None,
                    max_restarts: int = 5, backoff_base: float = 0.5,
                    backoff_max: float = 15.0,
                    poll_seconds: float = 0.2,
                    grace_seconds: float = 10.0,
                    stop_file: str | None = None,
                    python: str | None = None,
                    module: str = SERVE_MODULE) -> int:
    """Fleet mode: keep N scorer members (and optionally the fleet
    router in front of them) alive. Member ``k`` listens on
    ``unix:<fleet-dir>/member<k>.sock`` with its telemetry under
    ``<fleet-dir>/member<k>/`` — the layout ``photon_status --fleet``
    aggregates. A dead member is relaunched with per-member bounded
    backoff; the router re-admits it only after a verified,
    generation-checked hello (``serve/fleet.py``) — the supervisor
    only supplies the process, never the trust. A ``--stop-file``
    reaches every child, so one touch drains the whole fleet to exit
    0. Exit codes match :func:`supervise`; a CUDA member on a host
    without CUDA raises ``RuntimeError`` before anything is spawned."""
    check_device(member_args, module)
    from photon_ml_tpu_torch.parallel.multihost import WorkerSupervisor

    os.makedirs(fleet_dir, exist_ok=True)
    record = Recorder(os.path.join(fleet_dir, "supervisor.jsonl"))
    policy = WorkerSupervisor(
        spawn=lambda attempt: None, max_restarts=max_restarts,
        backoff_base_seconds=backoff_base,
        backoff_max_seconds=backoff_max, name="photon-supervise-fleet")
    env = dict(os.environ)
    env["PHOTON_GAME_SUPERVISED"] = "1"
    sockets = [os.path.join(fleet_dir, f"member{k}.sock")
               for k in range(fleet)]
    endpoints = [f"unix:{s}" for s in sockets]

    def spawn_member(k: int) -> subprocess.Popen:
        args = (list(member_args)
                + ["--listen", endpoints[k],
                   "--trace-dir", os.path.join(fleet_dir, f"member{k}")]
                + (["--stop-file", stop_file] if stop_file else []))
        record("launch_member", member=k, endpoint=endpoints[k])
        return subprocess.Popen(
            [python or sys.executable, "-m", module, *args], env=env)

    def spawn_router() -> subprocess.Popen:
        args = (["--listen", router_listen,
                 "--members", ",".join(endpoints),
                 "--trace-dir", os.path.join(fleet_dir, "router")]
                + (["--stop-file", stop_file] if stop_file else []))
        record("launch_router", endpoint=router_listen)
        return subprocess.Popen(
            [python or sys.executable, "-m", ROUTER_MODULE, *args],
            env=env)

    members: list[subprocess.Popen | None] = [spawn_member(k)
                                              for k in range(fleet)]
    router = spawn_router() if router_listen else None
    restarts = [0] * fleet
    router_restarts = 0
    relaunch_at: dict[int, float] = {}  # member → earliest relaunch

    def shutdown_all(procs) -> None:
        for proc in procs:
            if proc is not None and proc.poll() is None:
                _terminate_gracefully(proc, grace_seconds, record)

    try:
        while True:
            time.sleep(poll_seconds)
            now = time.monotonic()
            for k in range(fleet):
                proc = members[k]
                if proc is not None and proc.poll() is not None:
                    rc = proc.returncode
                    record("member_exit", member=k, rc=rc,
                           preempted=(rc == PREEMPTED_EXIT))
                    members[k] = None
                    if rc == 0:
                        continue  # scheduled stop: done, not dead
                    restarts[k] += 1
                    if restarts[k] > max_restarts:
                        record("abort", member=k,
                               reason="member restart budget exhausted",
                               restarts=restarts[k] - 1, last_rc=rc)
                        print(f"PHOTON_SUPERVISE_EXHAUSTED member={k} "
                              f"restarts={restarts[k] - 1} last_rc={rc}",
                              file=sys.stderr, flush=True)
                        shutdown_all(members + [router])
                        return 1
                    delay = policy.backoff_seconds(restarts[k])
                    record("backoff", member=k, seconds=round(delay, 2),
                           restart=restarts[k])
                    relaunch_at[k] = now + delay
                elif (proc is None and k in relaunch_at
                        and now >= relaunch_at[k]):
                    del relaunch_at[k]
                    record("relaunch_member", member=k,
                           restart=restarts[k])
                    members[k] = spawn_member(k)
            if router is not None and router.poll() is not None:
                rc = router.returncode
                record("router_exit", rc=rc,
                       preempted=(rc == PREEMPTED_EXIT))
                if rc == 0:
                    shutdown_all(members)
                    total = sum(restarts) + router_restarts
                    record("done", restarts=total)
                    print(f"PHOTON_SUPERVISE_OK restarts={total}",
                          flush=True)
                    return 0
                if rc == CLEAN_ABORT_EXIT:
                    record("abort", reason="router clean abort", rc=rc)
                    shutdown_all(members)
                    return CLEAN_ABORT_EXIT
                router_restarts += 1
                if router_restarts > max_restarts:
                    record("abort",
                           reason="router restart budget exhausted",
                           restarts=router_restarts - 1, last_rc=rc)
                    shutdown_all(members)
                    return 1
                delay = policy.backoff_seconds(router_restarts)
                record("backoff", seconds=round(delay, 2),
                       restart=router_restarts, member="router")
                time.sleep(delay)
                record("relaunch_router", restart=router_restarts)
                router = spawn_router()
            if (router is None and not relaunch_at
                    and all(m is None for m in members)):
                record("done", restarts=sum(restarts))
                print(f"PHOTON_SUPERVISE_OK restarts={sum(restarts)}",
                      flush=True)
                return 0
    except BaseException:
        # an interrupted supervisor must not orphan the fleet
        for proc in members + [router]:
            if proc is not None and proc.poll() is None:
                try:
                    proc.kill()
                except OSError:
                    pass
                proc.wait()
        raise


def _exit_on_sigterm(signum, frame) -> None:
    # a SIGTERMed supervisor unwinds through its kill paths: no child
    # outlives it
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="self-healing supervisor for a game_training_driver "
                    "run: relaunch-with-resume on crash/preemption, "
                    "SIGTERM+relaunch on stall, degradation ladder on "
                    "repeated same-coordinate failures",
        epilog="driver arguments go after `--`")
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--backoff-base", type=float, default=0.5,
                   help="backoff base seconds (doubles per restart, "
                        "deterministic jitter)")
    p.add_argument("--backoff-max", type=float, default=15.0)
    p.add_argument("--grace-seconds", type=float, default=10.0,
                   help="SIGTERM→SIGKILL escalation window for a "
                        "stalled run")
    p.add_argument("--poll-seconds", type=float, default=0.5,
                   help="status poll cadence while the driver runs")
    p.add_argument("--startup-grace-seconds", type=float, default=5.0,
                   help="ignore stall verdicts this long after a "
                        "launch (the new incarnation has not rotated "
                        "the old telemetry yet)")
    p.add_argument("--degrade-after", type=int, default=2,
                   help="failures at the same (sweep, coordinate) "
                        "before climbing the degradation ladder")
    p.add_argument("--run-dir", default=None,
                   help="the run's --trace-dir (default: extracted "
                        "from the driver args) — tailed for stall "
                        "detection and failure positions")
    p.add_argument("--listen", default=None,
                   help="consume the run's --telemetry-endpoint stream "
                        "at HOST:PORT / unix:/path.sock instead of "
                        "tailing the run dir")
    p.add_argument("--module", default=TRAIN_MODULE,
                   help="the python -m entrypoint to supervise "
                        "(default: the GAME training driver; "
                        "photon_ml_tpu_torch.serve.service keeps the "
                        "scoring service alive through the same "
                        "contract)")
    p.add_argument("--fleet", type=int, default=0, metavar="N",
                   help="fleet mode: supervise N scorer members (the "
                        "driver args after `--` become EVERY member's "
                        "args — model flags, queue depths); implies "
                        "--module photon_ml_tpu_torch.serve.service "
                        "unless overridden")
    p.add_argument("--fleet-dir", default=None,
                   help="fleet mode: directory for member sockets "
                        "(member<k>.sock), per-member telemetry dirs "
                        "(member<k>/), the router dir, and "
                        "supervisor.jsonl")
    p.add_argument("--router-listen", default=None,
                   help="fleet mode: also run the fleet router in "
                        "front of the members at this endpoint "
                        "(HOST:PORT or unix:/path.sock); its exit 0 "
                        "drains the whole fleet")
    p.add_argument("--stop-file", default=None,
                   help="fleet mode: forwarded to every member and the "
                        "router — touching it drains the fleet to "
                        "exit 0")
    ns, driver_args = p.parse_known_args(argv)
    if driver_args and driver_args[0] == "--":
        driver_args = driver_args[1:]
    if ns.fleet:
        if not ns.fleet_dir:
            p.error("--fleet requires --fleet-dir")
        module = (ns.module if ns.module != TRAIN_MODULE
                  else SERVE_MODULE)
        return supervise_fleet(
            driver_args, fleet=ns.fleet, fleet_dir=ns.fleet_dir,
            router_listen=ns.router_listen,
            max_restarts=ns.max_restarts, backoff_base=ns.backoff_base,
            backoff_max=ns.backoff_max, poll_seconds=ns.poll_seconds,
            grace_seconds=ns.grace_seconds, stop_file=ns.stop_file,
            module=module)
    if not driver_args:
        p.error("no driver arguments given (pass them after `--`)")
    return supervise(
        driver_args, max_restarts=ns.max_restarts,
        backoff_base=ns.backoff_base, backoff_max=ns.backoff_max,
        grace_seconds=ns.grace_seconds, poll_seconds=ns.poll_seconds,
        startup_grace_seconds=ns.startup_grace_seconds,
        degrade_after=ns.degrade_after, listen=ns.listen,
        run_dir=ns.run_dir, module=ns.module)


if __name__ == "__main__":
    # as a process, a SIGTERM kills the children and exits 143
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    raise SystemExit(main())
