"""Run-scoped observability: ``--trace-dir`` integration for the drivers.

Port of ``photon_ml_tpu/obs/run.py`` (``ObservedRun`` ``:108``,
``start_observed_run_from_flags`` ``:384``), for the two GAME drivers, the
scoring service and the fleet router. The output files and their records
are the JAX package's; the manifest keeps the JAX manifest's keys, but
for ``jax_version`` and ``backend``, in whose place it records
``torch_version``, ``cuda_version`` (``torch.version.cuda``; null on a
CPU-only build) and ``device_name`` (the card's name when the run's
``--device`` is a CUDA device, else its type). The fleet router takes no
device and imports no torch: its manifest has the installed torch's
version and None for the CUDA fields. ``--device-telemetry`` arms
``obs/compile.py`` (build attribution) and ``obs/devicemem.py`` (the
``hbm_bytes`` gauges and ``peak_hbm_bytes`` on ``run_end``).

:func:`start_observed_run` turns one driver invocation into an observed
run: it installs the process-global tracer, writes the run manifest
immediately (a crashed run still leaves provenance behind), starts the
stall-detecting heartbeat appending live to ``metrics.jsonl`` and
spilling closed spans live to ``spans.jsonl`` (bounded span buffer;
a killed run keeps everything spilled so far), and — at
:meth:`ObservedRun.finish` — rebuilds the Chrome trace from the spill
and appends the final metrics snapshot::

    <trace-dir>/
      run_manifest.json   # torch/CUDA versions, device, flags, git
      trace.json          # Chrome trace events (Perfetto-loadable)
      spans.jsonl         # one span per line (jq/pandas-friendly, live)
      metrics.jsonl       # heartbeat lines (live) + final counter dump
      telemetry.jsonl     # --telemetry-endpoint fallback stream (only
                          # when a socket consumer never connects)

In multi-host runs every process passes its ``process_index`` with
``num_processes > 1`` and writes ``trace.<i>.json`` /
``metrics.<i>.jsonl`` / … so a shared trace dir holds the whole gang's
streams side by side.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.obs.export import TELEMETRY_PROTO, TelemetrySink
from photon_ml_tpu_torch.obs.heartbeat import Heartbeat
from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.utils.faults import fault_point
from photon_ml_tpu_torch.utils.retry import (
    RetryExhaustedError,
    RetryPolicy,
    call_with_retry,
)

#: Trace-export retry: short and bounded — observability I/O must never
#: stall (or kill) the run it is observing.
_FLUSH_RETRY = RetryPolicy(max_attempts=3, base_delay_seconds=0.01,
                           max_delay_seconds=0.1)


def _git_describe(cwd: str) -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty", "--tags"],
            cwd=cwd, capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def _device_fields(device) -> dict:
    """``torch_version``, ``cuda_version``, ``device_name`` and
    ``device_count`` for a run on ``device``. An entry point without a
    device (the fleet router) does not import torch for them: its
    version comes from the installed package's metadata, and the CUDA
    fields are None."""
    if device is None:
        from importlib import metadata

        try:
            version = metadata.version("torch")
        except metadata.PackageNotFoundError:
            version = None
        return {"torch_version": version, "cuda_version": None,
                "device_name": None, "device_count": None}
    import torch

    dev = torch.device(device)
    cuda = torch.cuda.is_available()
    return {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" and cuda else dev.type),
            "device_count": torch.cuda.device_count() if cuda else 0}


def run_manifest(flags: Optional[dict] = None,
                 process_index: int = 0,
                 num_processes: int = 1) -> dict:
    """Provenance record for one run: the torch and CUDA versions, the
    device's name and the CUDA device count (``_device_fields``), the
    resolved driver flags, and the repo's git-describe (when
    available)."""
    fields = _device_fields((flags or {}).get("device"))
    repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return {
        "kind": "run_manifest",
        "telemetry_proto": TELEMETRY_PROTO,
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "torch_version": fields["torch_version"],
        "cuda_version": fields["cuda_version"],
        "device_name": fields["device_name"],
        "device_count": fields["device_count"],
        "process_index": process_index,
        "num_processes": num_processes,
        "git_describe": _git_describe(repo_dir),
        "flags": {} if flags is None else {
            k: v for k, v in sorted(flags.items())
            if isinstance(v, (bool, int, float, str, type(None)))},
    }


class ObservedRun:
    """One driver invocation's tracer + heartbeat + output files.

    Spans spill incrementally: every heartbeat drains the tracer's
    buffer into ``spans.jsonl``, so a multi-day run's span buffer stays
    bounded by one heartbeat interval and a killed run keeps everything
    spilled so far; ``trace.json`` is rebuilt from the spill at
    :meth:`finish`.

    ``preserve_existing=True`` (a supervisor-relaunched worker) keeps
    the crashed incarnation's evidence instead of truncating it: the
    metrics stream is appended to (delimited by a ``run_restart``
    record — its stalled-heartbeat trail is the postmortem) and prior
    ``trace.json`` / ``spans.jsonl`` / ``run_manifest.json`` files are
    rotated to ``<name>.prev`` rather than overwritten.
    """

    def __init__(self, trace_dir: str,
                 process_index: int = 0,
                 num_processes: int = 1,
                 flags: Optional[dict] = None,
                 heartbeat_seconds: float = 10.0,
                 stall_seconds: float = 120.0,
                 warn: Optional[Callable[[str], None]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 preserve_existing: bool = False,
                 telemetry_endpoint: Optional[str] = None,
                 device_telemetry: bool = False):
        self.trace_dir = trace_dir
        self._registry = registry or REGISTRY
        # --device-telemetry: arm the device plane (build attribution +
        # device-memory accounting); an un-flagged run never pays for it
        self._device_telemetry = device_telemetry
        self._devicemem = None
        self._sample_on_beat = False
        if device_telemetry:
            from photon_ml_tpu_torch.obs import compile as obs_compile
            from photon_ml_tpu_torch.obs import devicemem

            obs_compile.arm(registry=self._registry)
            devicemem.arm(registry=self._registry)
            self._devicemem = devicemem
            self._sample_on_beat = True
        self._process_index = process_index
        self._exit_status = "ok"
        self._exit_reason = ""
        suffix = f".{process_index}" if num_processes > 1 else ""
        self.trace_path = os.path.join(trace_dir, f"trace{suffix}.json")
        self.spans_path = os.path.join(trace_dir, f"spans{suffix}.jsonl")
        self.telemetry_path = os.path.join(
            trace_dir, f"telemetry{suffix}.jsonl")
        self.metrics_path = os.path.join(
            trace_dir, f"metrics{suffix}.jsonl")
        self.manifest_path = os.path.join(
            trace_dir, f"run_manifest{suffix}.json")
        os.makedirs(trace_dir, exist_ok=True)
        if preserve_existing:
            for path in (self.trace_path, self.spans_path,
                         self.manifest_path):
                if os.path.exists(path):
                    os.replace(path, path + ".prev")

        manifest = run_manifest(flags=flags, process_index=process_index,
                                num_processes=num_processes)
        with open(self.manifest_path, "w") as fh:
            json.dump(manifest, fh, indent=1)

        # Live telemetry plane (--telemetry-endpoint): a bounded
        # non-blocking sink shipping NDJSON records to a local consumer,
        # falling back to telemetry.jsonl in the trace dir when none
        # connects. The manifest is the stream's first record — a
        # consumer knows who it is watching before any span arrives.
        self.sink: Optional[TelemetrySink] = None
        if telemetry_endpoint:
            self.sink = TelemetrySink(
                telemetry_endpoint, fallback_path=self.telemetry_path,
                registry=self._registry, warn=warn)
            self.sink.emit(manifest)
        if preserve_existing and os.path.exists(self.metrics_path):
            with open(self.metrics_path, "a") as fh:
                fh.write(json.dumps({
                    "kind": "run_restart",
                    "time": time.strftime("%Y-%m-%dT%H:%M:%S")}) + "\n")
        else:
            # truncate a prior run's stream: heartbeat + final dump append
            open(self.metrics_path, "w").close()
        open(self.spans_path, "w").close()  # this incarnation's spill

        self._warn = warn
        self._spill_lock = threading.Lock()
        self._pending: list = []  # drained but not yet durably written
        self.tracer = trace.enable(process_index=process_index)
        self.heartbeat = Heartbeat(
            self.tracer, out_path=self.metrics_path,
            interval_seconds=heartbeat_seconds,
            stall_seconds=stall_seconds, warn=warn,
            registry=self._registry, on_beat=self._spill,
            on_record=self._export_record).start()
        self._finished = False

    def _export_record(self, record: dict) -> None:
        """Ship one kind-tagged record (heartbeat, run_end) on the live
        sink; a no-op without ``--telemetry-endpoint``."""
        if self.sink is not None:
            self.sink.emit({**record,
                            "process_index": self._process_index})

    def _spill(self) -> None:
        """Drain the tracer's closed spans into ``spans.jsonl`` (runs on
        every heartbeat and once more at finish). Drained spans are only
        discarded once the write succeeds — a transient full disk keeps
        them pending (capped at the tracer's buffer bound) for the next
        beat instead of losing the interval."""
        if self._sample_on_beat:
            # heartbeat-cadence device-memory sample BEFORE the metric
            # totals are read, so every heartbeat carries fresh
            # hbm_bytes gauges (contained: sampling must never take the
            # heartbeat down with it)
            try:
                self._devicemem.sample()
            except Exception:
                pass
        with self._spill_lock:
            drained = self.tracer.drain()
            if self.sink is not None:
                # exported exactly once, at drain time: a failed FILE
                # spill keeps spans pending for the next beat without
                # duplicating them on the live stream
                for e in drained:
                    self.sink.emit({"kind": "span",
                                    "process_index": self._process_index,
                                    **e})
            self._pending.extend(drained)
            if not self._pending:
                return
            cap = self.tracer.max_buffered_spans
            if len(self._pending) > cap:
                self.tracer.spans_dropped += len(self._pending) - cap
                self._pending = self._pending[-cap:]

            def write():
                # the obs.flush drill site: a full disk / flaky trace
                # mount retries briefly and then keeps the interval
                # PENDING — observability I/O can degrade, never kill
                fault_point("obs.flush", path=self.spans_path)
                with open(self.spans_path, "a") as fh:
                    for e in self._pending:
                        fh.write(json.dumps(e) + "\n")

            call_with_retry(write, site="obs.flush", policy=_FLUSH_RETRY)
            self._pending = []

    def set_exit_status(self, status: str, reason: str = "") -> None:
        """Record how the run is ending ("ok" default, "abort" on a
        clean abort, "preempted" on a graceful stop honored at a commit
        barrier, "error" otherwise) — written as the ``run_end`` record
        at :meth:`finish` so
        ``photon_ml_tpu_torch/tools/photon_status.py`` can tell a
        finished run from an aborted or requeue-pending one."""
        self._exit_status = status
        self._exit_reason = reason

    def finish(self) -> None:
        """Stop the heartbeat and flush trace + metrics files
        (idempotent; call from the driver's ``finally``). Every export
        step is CONTAINED: a dead disk at exit loses trace output (with
        a warning), never the run's exit status."""
        if self._finished:
            return
        self._finished = True
        self.heartbeat.stop()
        for step, fn in (("spill", self._spill),
                         ("trace", self._finish_trace),
                         ("metrics", self._finish_metrics),
                         ("run_end", self._finish_run_end)):
            try:
                fn()
            except (OSError, ValueError, RetryExhaustedError) as e:
                if self._warn is not None:
                    self._warn(f"trace export ({step}) failed at finish: "
                               f"{e!r} — continuing")
        if self.sink is not None:
            self.sink.close()
        if self._device_telemetry:
            from photon_ml_tpu_torch.obs import compile as obs_compile

            obs_compile.disarm()
            if self._devicemem is not None:
                self._devicemem.disarm()
        if trace.get_tracer() is self.tracer:
            trace.disable()

    def _finish_trace(self) -> None:
        events = []
        with open(self.spans_path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    continue  # torn tail line from a killed incarnation
        doc = trace.chrome_document(events, self.tracer.process_index,
                                    self.tracer.start_unix)
        with open(self.trace_path, "w") as fh:
            json.dump(doc, fh)

    def _finish_metrics(self) -> None:
        def write():
            fault_point("obs.flush", path=self.metrics_path)
            with open(self.metrics_path, "a") as fh:
                for record in self._registry.snapshot():
                    fh.write(json.dumps(record) + "\n")

        call_with_retry(write, site="obs.flush", policy=_FLUSH_RETRY)

    def _finish_run_end(self) -> None:
        """Terminal record: the metrics stream (and the live telemetry
        stream) ends with how the run ended, so a status consumer can
        tell "finished clean" from "aborted" from "still running /
        killed" (no run_end line at all)."""
        record = {"kind": "run_end",
                  "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
                  "status": self._exit_status,
                  "reason": self._exit_reason,
                  "uptime_s": round(self.tracer.uptime_seconds(), 3),
                  # final counter totals ride the terminal record: a
                  # SOCKET consumer has no exit snapshot file to read,
                  # and a short run's last heartbeat can predate the
                  # tail of the work (photon-top reads these)
                  "metric_totals": self._registry.totals()}
        if self._devicemem is not None:
            # one last sample, then the run-wide peak on the terminal
            # record: the capacity-planning number a finished run is
            # asked for
            try:
                self._devicemem.sample()
            except Exception:
                pass
            record["peak_hbm_bytes"] = self._devicemem.peak_bytes()
        self._export_record(record)

        def write():
            fault_point("obs.flush", path=self.metrics_path)
            with open(self.metrics_path, "a") as fh:
                fh.write(json.dumps(record) + "\n")

        call_with_retry(write, site="obs.flush", policy=_FLUSH_RETRY)


def start_observed_run(trace_dir: str, **kwargs) -> ObservedRun:
    return ObservedRun(trace_dir, **kwargs)


def start_observed_run_from_flags(ns, process_index: int = 0,
                                  num_processes: int = 1,
                                  warn=None,
                                  preserve_existing: bool = False
                                  ) -> Optional[ObservedRun]:
    """Install the run-scoped tracer/heartbeat when the parsed driver
    flags carry ``--trace-dir`` (returns the ObservedRun to finish(), or
    None) — the one adapter both GAME drivers share."""
    endpoint = getattr(ns, "telemetry_endpoint", None)
    device_telemetry = bool(getattr(ns, "device_telemetry", False))
    if not getattr(ns, "trace_dir", None):
        if endpoint:
            # the sink rides the ObservedRun's tracer/heartbeat/spill
            # machinery; silently ignoring the endpoint would hand the
            # operator a consumer that never hears anything
            raise ValueError(
                "--telemetry-endpoint requires --trace-dir (the live "
                "stream is fed by the run's span spill + heartbeat)")
        if device_telemetry:
            # same contract: the device plane's spans/gauges ride the
            # trace dir's spill + heartbeat stream
            raise ValueError(
                "--device-telemetry requires --trace-dir (compile spans "
                "and hbm gauges ride the run's span spill + heartbeat)")
        return None
    return start_observed_run(
        ns.trace_dir, process_index=process_index,
        num_processes=num_processes, flags=vars(ns),
        heartbeat_seconds=ns.trace_heartbeat_seconds,
        stall_seconds=ns.trace_stall_seconds, warn=warn,
        preserve_existing=preserve_existing,
        telemetry_endpoint=endpoint,
        device_telemetry=device_telemetry)
