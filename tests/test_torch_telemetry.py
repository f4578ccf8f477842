"""The port's run telemetry plane held against the JAX package's, on the CPU.

- Both GAME drivers, in both packages, on one small GLMix argv with
  ``--trace-dir`` and a live ``--telemetry-endpoint unix:`` consumer: the
  same trace-dir files, the same multiset of span names and their
  nesting, the same ``host_fetches_by_site``, the same metric names in
  ``metrics.jsonl`` (but for the JAX package's ``retraces``, counted when
  jit re-traces: the port has no jit, and its build attribution is
  ``obs/compile.py``, the one intended difference), and manifest keys
  that match with ``torch_version`` / ``cuda_version`` / ``device_name``
  in place of ``jax_version`` / ``backend``; the live stream opens with
  the manifest and ends with ``run_end``.
- The JAX package's readers (``tools/trace_report.py``,
  ``tools/photon_status.py``'s run-dir reader, ``tools/otlp_bridge.py``)
  accept the port's trace directory.
- ``TelemetrySink``: records equal to the JAX sink's for the same inputs
  on a file and a unix endpoint, the never-connected fallback and the
  drop counts; the heartbeat's stall detection; the event-bus bridge.
- The flag errors (``--telemetry-endpoint`` / ``--device-telemetry``
  without ``--trace-dir``, a bad ``tcp://``) with the JAX package's
  messages and exit code 2, in the drivers, the service and the router.
- ``run_end`` on exit 75 and exit 3; ``--device-telemetry`` on the CPU
  (the ``hbm_bytes`` family, ``peak_hbm_bytes``, ``build.compile`` spans);
  the service's ``exemplars.jsonl`` and ``serve.*`` spans.
Nothing here asserts a wall-clock overhead.
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import io
import json
import os
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import game_scoring_driver as jsd
from photon_ml_tpu.cli import game_training_driver as jtd
from photon_ml_tpu.obs import export as jexport
from photon_ml_tpu.obs import heartbeat as jheartbeat
from photon_ml_tpu.obs import trace as jtrace
from photon_ml_tpu.obs.bridge import MetricsEventListener as JaxListener
from photon_ml_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
from photon_ml_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from photon_ml_tpu.serve import router as jrouter
from photon_ml_tpu.serve import service as jservice
from photon_ml_tpu.utils import events as jevents
from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.obs import compile as tcompile
from photon_ml_tpu_torch.obs import devicemem as tdevicemem
from photon_ml_tpu_torch.obs import export as texport
from photon_ml_tpu_torch.obs import heartbeat as theartbeat
from photon_ml_tpu_torch.obs import trace as ttrace
from photon_ml_tpu_torch.obs.bridge import MetricsEventListener
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.obs.metrics import MetricsRegistry
from photon_ml_tpu_torch.serve import router as trouter
from photon_ml_tpu_torch.serve import service as tservice
from photon_ml_tpu_torch.utils import events as tevents
from photon_ml_tpu_torch.utils import faults as tfaults
from photon_ml_tpu_torch.utils.retry import RetryPolicy, call_with_retry
from test_torch_drivers import SECTIONS, TRAIN_FLAGS, make_game_avro

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_FILES = {"metrics.jsonl", "run_manifest.json", "spans.jsonl",
               "trace.json"}
#: counted by the JAX package when jit re-traces a function; the port has
#: no jit (its build attribution is obs/compile.py)
JAX_ONLY_METRICS = {"retraces"}


class _Consumer:
    """A ``--telemetry-endpoint unix:`` consumer: accepts connections and
    keeps every line it reads."""

    def __init__(self, path: str):
        self.path = path
        self.lines: list[dict] = []
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(4)
        self._sock.settimeout(0.1)
        self._closed = False
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()

    def _accept(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._read, args=(conn,),
                             daemon=True).start()

    def _read(self, conn):
        with conn, conn.makefile("rb") as fh:
            for line in fh:
                self.lines.append(json.loads(line))

    def close(self):
        self._closed = True
        self._sock.close()
        self._thread.join(timeout=5)


def _read_dir(trace_dir: str) -> dict:
    spans = [json.loads(ln) for ln in open(os.path.join(trace_dir,
                                                        "spans.jsonl"))]
    metrics = [json.loads(ln) for ln in open(os.path.join(trace_dir,
                                                          "metrics.jsonl"))]
    return {
        "files": set(os.listdir(trace_dir)),
        "spans": spans,
        "span_names": collections.Counter(s["name"] for s in spans),
        "nesting": {(s["name"], s["depth"]) for s in spans},
        "metrics": metrics,
        "metric_names": {m.get("name", m.get("kind")) for m in metrics},
        "host_fetches": {m["labels"]["site"]: m["value"] for m in metrics
                         if m.get("name") == "host_fetches"},
        "manifest": json.load(open(os.path.join(trace_dir,
                                                "run_manifest.json"))),
    }


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Both packages' training and scoring drivers on one argv, each with
    ``--trace-dir``, a 0.05 s heartbeat and a live unix consumer, on one
    device."""
    d = tmp_path_factory.mktemp("telemetry")
    train, val = str(d / "train.avro"), str(d / "val.avro")
    make_game_avro(train, seed=0)
    make_game_avro(val, n=200, seed=1)
    out, streams = {}, {}
    for pkg in ("jax", "torch"):
        for role in ("train", "score"):
            trace_dir = str(d / f"{pkg}-{role}-trace")
            consumer = _Consumer(str(d / f"{pkg}-{role}.sock"))
            telemetry = ["--trace-dir", trace_dir,
                         "--trace-heartbeat-seconds", "0.05",
                         "--telemetry-endpoint", f"unix:{consumer.path}"]
            if role == "train":
                argv = ["--train-input-dirs", train,
                        "--validate-input-dirs", val, *TRAIN_FLAGS,
                        "--output-dir", str(d / f"{pkg}-out"), *telemetry]
            else:
                argv = ["--input-data-dirs", val, "--game-model-input-dir",
                        str(d / f"{pkg}-out" / "best"),
                        "--output-dir", str(d / f"{pkg}-score"),
                        "--feature-shard-id-to-feature-section-keys-map",
                        SECTIONS, "--random-effect-id-set", "userId",
                        "--evaluator-type", "AUC", *telemetry]
            REGISTRY.reset()
            JAX_REGISTRY.reset()
            if pkg == "jax":
                # one device, as the port runs: with the test session's
                # eight virtual CPU devices the JAX driver would shard its
                # fixed effect over a data mesh and solve it eagerly
                one = jax.devices()[:1]
                with jax.enable_x64(False), pytest.MonkeyPatch.context() \
                        as mp:
                    mp.setattr(jax, "devices", lambda *a, **k: one)
                    (jtd if role == "train" else jsd).main(argv)
            else:
                (ttd if role == "train" else tsd).run(argv + ["--device",
                                                              "cpu"])
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not any(
                    r.get("kind") == "run_end" for r in consumer.lines):
                time.sleep(0.02)
            consumer.close()
            out[(pkg, role)] = _read_dir(trace_dir)
            out[(pkg, role)]["dir"] = trace_dir
            streams[(pkg, role)] = list(consumer.lines)
    return {"dirs": out, "streams": streams}


ROLES = ["train", "score"]


@pytest.mark.parametrize("role", ROLES)
def test_trace_dirs_hold_the_same_files(traced, role):
    jax_, port = traced["dirs"][("jax", role)], traced["dirs"][("torch",
                                                                role)]
    assert jax_["files"] == port["files"] == TRACE_FILES


@pytest.mark.parametrize("role", ROLES)
def test_span_names_and_nesting_equal_the_jax_drivers(traced, role):
    jax_, port = traced["dirs"][("jax", role)], traced["dirs"][("torch",
                                                                role)]
    assert port["span_names"] == jax_["span_names"]
    assert port["nesting"] == jax_["nesting"]
    if role == "train":
        assert {"cd.sweep", "cd.update", "cd.dispatch", "cd.epilogue_fetch",
                "cd.validation", "cd.tracker_drain", "optimizer.solve",
                "re.solve", "driver.phase"} <= set(port["span_names"])


@pytest.mark.parametrize("role", ROLES)
def test_host_fetches_by_site_equal_the_jax_drivers(traced, role):
    jax_, port = traced["dirs"][("jax", role)], traced["dirs"][("torch",
                                                                role)]
    assert port["host_fetches"] == jax_["host_fetches"]
    if role == "train":
        assert port["host_fetches"]["cd.epilogue"] == 4


@pytest.mark.parametrize("role", ROLES)
def test_metric_names_equal_the_jax_drivers(traced, role):
    jax_, port = traced["dirs"][("jax", role)], traced["dirs"][("torch",
                                                                role)]
    # a heartbeat line needs a run longer than its interval: the training
    # runs are, a scoring run of 200 rows may not be
    beat = {"heartbeat"}
    if role == "train":
        assert beat <= port["metric_names"] and beat <= jax_["metric_names"]
    assert port["metric_names"] - beat == \
        jax_["metric_names"] - JAX_ONLY_METRICS - beat
    assert port["metrics"][-1]["kind"] == "run_end"
    assert port["metrics"][-1]["status"] == "ok"


@pytest.mark.parametrize("role", ROLES)
def test_manifest_keys_match_with_torch_in_place_of_jax(traced, role):
    jax_m = traced["dirs"][("jax", role)]["manifest"]
    port_m = traced["dirs"][("torch", role)]["manifest"]
    assert set(port_m) == (set(jax_m) - {"jax_version", "backend"}) | {
        "torch_version", "cuda_version", "device_name"}
    assert port_m["torch_version"] == torch.__version__
    assert port_m["device_name"] == "cpu"
    assert port_m["telemetry_proto"] == jax_m["telemetry_proto"]


@pytest.mark.parametrize("role", ROLES)
def test_live_stream_opens_with_the_manifest_and_ends_with_run_end(traced,
                                                                   role):
    kinds = [r["kind"] for r in traced["streams"][("torch", role)]]
    jax_kinds = {r["kind"] for r in traced["streams"][("jax", role)]}
    assert kinds[0] == "run_manifest" and kinds[-1] == "run_end"
    want = {"run_manifest", "span", "heartbeat", "run_end"}
    if role == "score":  # too short a run to be sure of a heartbeat
        want -= {"heartbeat"}
        kinds = [k for k in kinds if k != "heartbeat"]
        jax_kinds -= {"heartbeat"}
    assert set(kinds) == jax_kinds == want


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tool", ["trace_report", "photon_status",
                                  "otlp_bridge"])
def test_jax_readers_accept_the_ports_trace_dir(traced, tool, tmp_path):
    trace_dir = traced["dirs"][("torch", "train")]["dir"]
    mod = _tool(tool)
    buf = io.StringIO()
    if tool == "trace_report":
        with contextlib.redirect_stdout(buf):
            assert mod.main([os.path.join(trace_dir, "trace.json"),
                             "--json"]) == 0
        report = json.loads(buf.getvalue())
        assert "cd.update" in json.dumps(report)
    elif tool == "photon_status":
        status = mod.compute_status(mod.read_run_dir(trace_dir))
        assert status, status
        with contextlib.redirect_stdout(buf):
            assert mod.main(["--run-dir", trace_dir, "--json"]) == 0
        assert json.loads(buf.getvalue())
    else:
        out = tmp_path / "otlp.json"
        assert mod.main(["--run-dir", trace_dir, "--out", str(out)]) == 0
        doc = json.loads(out.read_text())
        spans = [s for rs in doc["traces"]["resourceSpans"]
                 for ss in rs["scopeSpans"] for s in ss["spans"]]
        assert {s["name"] for s in spans} >= {"cd.sweep", "cd.update"}
        attrs = {a["key"] for rs in doc["traces"]["resourceSpans"]
                 for a in rs["resource"]["attributes"]}
        assert "photon.telemetry_proto" in attrs


# ---------------------------------------------------------------------------
# the sink, the heartbeat, the bridge
# ---------------------------------------------------------------------------

RECORDS = [{"kind": "run_manifest", "telemetry_proto": 1, "flags": {}},
           {"kind": "span", "name": "cd.update", "ts_us": 1.5,
            "dur_us": 2.25, "tid": 7, "depth": 2,
            "labels": {"coordinate": "fixed", "sweep": 0}},
           {"kind": "heartbeat", "uptime_s": 0.1, "stalled": False,
            "metric_totals": {"host_fetches": 3}},
           {"kind": "run_end", "status": "ok", "reason": ""}]


def _sink_output(module, endpoint_for, tmp_path, tag) -> list[bytes]:
    if endpoint_for == "file":
        path = tmp_path / f"{tag}.jsonl"
        sink = module.TelemetrySink(f"file:{path}")
        for r in RECORDS:
            assert sink.emit(r)
        sink.close()
        return path.read_bytes().splitlines()
    consumer = _Consumer(str(tmp_path / f"{tag}.sock"))
    sink = module.TelemetrySink(f"unix:{consumer.path}")
    for r in RECORDS:
        assert sink.emit(r)
    sink.close()
    deadline = time.monotonic() + 5
    while len(consumer.lines) < len(RECORDS) and time.monotonic() < deadline:
        time.sleep(0.01)
    consumer.close()
    return [json.dumps(r).encode() for r in consumer.lines]


@pytest.mark.parametrize("endpoint", ["file", "unix"])
def test_sink_records_equal_the_jax_sinks(endpoint, tmp_path):
    assert texport.TELEMETRY_PROTO == jexport.TELEMETRY_PROTO
    assert _sink_output(texport, endpoint, tmp_path, "port") == \
        _sink_output(jexport, endpoint, tmp_path, "jax")


@pytest.mark.parametrize("fallback", [True, False])
def test_never_connected_sink_falls_back_or_counts_drops(fallback,
                                                         tmp_path):
    """No consumer ever listens: with a fallback file every record lands
    there, without one every record is dropped and counted — in both
    packages alike."""
    got = {}
    for name, module, reg in (("port", texport, MetricsRegistry()),
                              ("jax", jexport, JaxRegistry())):
        path = tmp_path / f"{name}-fallback.jsonl"
        sink = module.TelemetrySink(
            f"unix:{tmp_path}/nobody-{name}.sock",
            fallback_path=str(path) if fallback else None, registry=reg)
        for r in RECORDS:
            assert sink.emit(r)
        sink.close(timeout=5.0)
        got[name] = (path.read_bytes() if path.exists() else b"",
                     reg.counter("telemetry_dropped").by_label("kind"))
    assert got["port"] == got["jax"]
    if fallback:
        assert len(got["port"][0].splitlines()) == len(RECORDS)
        assert not got["port"][1]
    else:
        assert got["port"][1] == {"run_manifest": 1, "span": 1,
                                  "heartbeat": 1, "run_end": 1}


def test_full_queue_drops_and_counts_without_blocking(tmp_path):
    reg = MetricsRegistry()
    sink = texport.TelemetrySink(f"unix:{tmp_path}/none.sock",
                                 max_queued_records=2, registry=reg)
    t0 = time.monotonic()
    kept = [sink.emit({"kind": "span", "i": i}) for i in range(200)]
    assert time.monotonic() - t0 < 1.0
    sink.close(timeout=2.0)
    assert kept.count(True) < 200
    assert reg.counter("telemetry_dropped").total() >= kept.count(False)


def test_heartbeat_flags_a_stall_as_the_jax_heartbeat_does(tmp_path):
    recs = {}
    for name, tmod, hmod, reg in (
            ("port", ttrace, theartbeat, MetricsRegistry()),
            ("jax", jtrace, jheartbeat, JaxRegistry())):
        tracer = tmod.Tracer()
        warned = []
        hb = hmod.Heartbeat(tracer, out_path=str(tmp_path / f"{name}.jsonl"),
                            stall_seconds=0.05, warn=warned.append,
                            registry=reg)
        with tracer.span("cd.sweep", sweep=0):
            time.sleep(0.1)
            first = hb.check()
            second = hb.check()
        third = hb.check()  # a span closed just now: no longer stalled
        recs[name] = (first, second, third)
        assert first["stalled"] and second["stalled"]
        assert not third["stalled"]
        assert reg.counter("stalls").total() == 1  # once per episode
        assert len(warned) == 1 and "STALL" in warned[0]
        assert "cd.sweep" in warned[0]
    for a, b in zip(recs["port"], recs["jax"]):
        assert set(a) == set(b)
        assert a["open_spans"] == b["open_spans"]


def test_bridge_counts_the_events_as_the_jax_bridge_does():
    regs = {"port": MetricsRegistry(), "jax": JaxRegistry()}
    for name, listener, ev in (
            ("port", MetricsEventListener(regs["port"]), tevents),
            ("jax", JaxListener(regs["jax"]), jevents)):
        for e in (ev.FaultEvent(point="cd.update", coordinate_id="fixed",
                                iteration=0, message="x"),
                  ev.RecoveryEvent(action="retried", coordinate_id="fixed",
                                   iteration=0, attempts=1),
                  ev.CoordinateQuarantinedEvent(coordinate_id="perUser",
                                                iteration=1, failures=2,
                                                message="m"),
                  ev.ShardQuarantinedEvent(path="p", stage="open",
                                           reason="r")):
            listener(e)
    assert regs["port"].snapshot() == regs["jax"].snapshot()


def test_retries_are_counted_and_traced():
    REGISTRY.reset()
    tracer = ttrace.enable()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    try:
        assert call_with_retry(flaky, "site.t", policy=RetryPolicy(
            max_attempts=4, base_delay_seconds=0.001,
            max_delay_seconds=0.002)) == "done"
    finally:
        ttrace.disable()
    assert REGISTRY.counter("retries").by_label("site") == {"site.t": 2}
    assert [e["name"] for e in tracer.events()] == ["retry.attempt"] * 2


# ---------------------------------------------------------------------------
# flags and exits
# ---------------------------------------------------------------------------

_TRAIN = ["--train-input-dirs", "t", "--output-dir", "o", *TRAIN_FLAGS]
_SCORE = ["--input-data-dirs", "t", "--game-model-input-dir", "m",
          "--output-dir", "o",
          "--feature-shard-id-to-feature-section-keys-map", SECTIONS]
_SERVE = ["--game-model-input-dir", "m",
          "--feature-shard-id-to-feature-section-keys-map", SECTIONS]
_ROUTE = ["--members", "unix:/nonexistent.sock"]
ENTRY_POINTS = {"train": (ttd.parse_args, jtd.parse_args, _TRAIN),
                "score": (tsd.parse_args, jsd.parse_args, _SCORE),
                "serve": (tservice.parse_args, jservice.parse_args, _SERVE),
                "route": (trouter.parse_args, jrouter.parse_args, _ROUTE)}
MISUSE = {"endpoint_without_trace_dir": ["--telemetry-endpoint",
                                         "unix:/tmp/x.sock"],
          "device_telemetry_without_trace_dir": ["--device-telemetry"],
          "bad_tcp_endpoint": ["--trace-dir", "t", "--telemetry-endpoint",
                               "tcp://nohostport"]}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("misuse", sorted(MISUSE))
def test_flag_errors_match_the_jax_packages(entry, misuse, capsys):
    port_parse, jax_parse, base = ENTRY_POINTS[entry]
    errs = []
    for parse in (port_parse, jax_parse):
        with pytest.raises(SystemExit) as exc:
            parse(base + MISUSE[misuse])
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    port_err, jax_err = (e.split("error: ", 1)[1] for e in errs)
    assert port_err == jax_err


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_telemetry_flags_parse_with_a_trace_dir(entry):
    port_parse, _, base = ENTRY_POINTS[entry]
    ns = port_parse(base + ["--trace-dir", "t", "--trace-heartbeat-seconds",
                            "0.5", "--trace-stall-seconds", "30",
                            "--telemetry-endpoint", "unix:/tmp/x.sock",
                            "--device-telemetry"])
    assert (ns.trace_dir, ns.trace_heartbeat_seconds,
            ns.trace_stall_seconds, ns.telemetry_endpoint,
            ns.device_telemetry) == ("t", 0.5, 30.0, "unix:/tmp/x.sock", True)
    assert hasattr(ns, "device") == (entry != "route")


@pytest.fixture(scope="module")
def small_fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("exits")
    train, val = str(d / "train.avro"), str(d / "val.avro")
    make_game_avro(train, n=200, seed=0)
    make_game_avro(val, n=100, seed=1)
    return train, val


@pytest.mark.parametrize("how,code,status", [
    ("preempted", 75, "preempted"), ("abort", 3, "abort")])
def test_run_end_records_how_the_training_run_ended(small_fixture, tmp_path,
                                                    how, code, status):
    train, val = small_fixture
    argv = ["--train-input-dirs", train, "--validate-input-dirs", val,
            *TRAIN_FLAGS, "--output-dir", str(tmp_path / "out"),
            "--trace-dir", str(tmp_path / "trace"), "--device", "cpu"]
    if how == "preempted":
        stop = tmp_path / "stop"
        stop.write_text("now")
        argv += ["--stop-file", str(stop)]
    else:
        tfaults.arm("cd.update", "raise", times=1)
    try:
        with pytest.raises(SystemExit) as exc:
            ttd.main(argv)
    finally:
        tfaults.disarm_all()
    assert exc.value.code == code
    lines = (tmp_path / "trace" / "metrics.jsonl").read_text().splitlines()
    end = json.loads(lines[-1])
    assert end["kind"] == "run_end" and end["status"] == status
    assert (tmp_path / "trace" / "trace.json").exists()
    assert ttrace.get_tracer() is None  # the run's tracer is gone


def test_device_telemetry_on_the_cpu(small_fixture, tmp_path):
    """``--device-telemetry`` on the CPU: the ``hbm_bytes`` family as
    ``live_bytes`` of the host, ``peak_hbm_bytes`` on ``run_end``,
    per-coordinate watermarks; and, armed, a column-sum plan's build is
    attributed (``build.compile``)."""
    train, val = small_fixture
    REGISTRY.reset()
    ttd.run(["--train-input-dirs", train, "--validate-input-dirs", val,
             *TRAIN_FLAGS, "--output-dir", str(tmp_path / "out"),
             "--trace-dir", str(tmp_path / "trace"), "--device-telemetry",
             "--device", "cpu"])
    got = _read_dir(str(tmp_path / "trace"))
    hbm = [m for m in got["metrics"] if m.get("name") == "hbm_bytes"]
    assert hbm and all(m["labels"] == {"device": "host",
                                       "kind": "live_bytes"} for m in hbm)
    end = got["metrics"][-1]
    assert end["kind"] == "run_end" and end["peak_hbm_bytes"] > 0
    assert got["span_names"]["cd.hbm_watermark"] == 4  # 2 coords x 2 sweeps
    assert not tcompile.is_armed() and not tdevicemem.armed()

    from photon_ml_tpu_torch.data.batch import ell_from_csr
    import scipy.sparse as sp

    tracer = ttrace.enable()
    tcompile.arm()
    try:
        x = sp.random(50, 5000, density=0.01, format="csr",
                      random_state=np.random.default_rng(0),
                      dtype=np.float32)
        ell = ell_from_csr(x, np.zeros(50, np.float32), device="cpu")
        ell.plan.column_sum(torch.ones(50))
    finally:
        tcompile.disarm()
        ttrace.disable()
    (span,) = [e for e in tracer.events() if e["name"] == "build.compile"]
    assert span["labels"]["site"] == "data.column_sum_plan"
    assert span["labels"]["cause"] == tcompile.NO_CACHE_ENTRY
    assert REGISTRY.counter("compiles").by_label("site") == {
        "data.column_sum_plan": 1}


def test_library_cause_names_a_changed_hash(tmp_path):
    assert tcompile.library_cause(str(tmp_path / "libk_aaaa.so")) == \
        tcompile.NO_CACHE_ENTRY
    (tmp_path / "libk_bbbb.so").write_bytes(b"")
    assert tcompile.library_cause(str(tmp_path / "libk_aaaa.so")) == \
        tcompile.HASH_CHANGED


def test_service_spills_exemplars_and_traces_the_swap(tmp_path):
    """The port's service with a tracer and ``exemplar_path`` (what
    ``--trace-dir`` and ``--trace-exemplar-slots 4`` give it): after a
    swap under load, ``exemplars.jsonl`` holds the 4 slowest requests,
    each with its stage tree, and the trace has ``serve.generation`` and
    ``serve.swap``."""
    from test_serve import _make_records
    from test_torch_serve import _OPEN_GATE, _run_service, _swap_parts

    from photon_ml_tpu_torch.serve.protocol import ServeClient

    tracer = ttrace.enable()
    path = tmp_path / "exemplars.jsonl"
    try:
        parts = _swap_parts(str(tmp_path), exemplar_slots=4,
                            exemplar_path=str(path), **_OPEN_GATE)
        finish = _run_service(parts)
        records = _make_records()
        try:
            with ServeClient(parts["service"].endpoint) as c:
                for i in range(12):
                    assert c.score(records[:1 + i])["kind"] == "scores"
                assert c.swap(parts["candidate_dir"])["outcome"] == "ok"
                assert c.score(records)["kind"] == "scores"
        finally:
            finish()
    finally:
        ttrace.disable()
    exemplars = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(exemplars) == 4
    for ex in exemplars:
        names = [e["name"] for e in ex["events"]]
        assert names == ["serve.request", "serve.queue_wait",
                         "serve.batch_form", "serve.tier_gather",
                         "serve.device_score", "serve.reply"]
        assert ex["latency_ms"] > 0 and ex["trace_id"]
    lat = sorted(ex["latency_ms"] for ex in exemplars)
    assert lat == sorted(lat)
    span_names = {e["name"] for e in tracer.events()}
    assert {"serve.generation", "serve.swap"} <= span_names
