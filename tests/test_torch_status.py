"""The port's ``photon_status`` held against the JAX tool, on the CPU.

``photon_ml_tpu_torch/tools/photon_status.py`` against
``tools/photon_status.py`` (loaded from its file, as
``tests/test_torch_telemetry.py`` loads the JAX tools):

- parametrised record streams (a healthy run, a stalled heartbeat,
  ``run_end`` ok / abort / error / preempted, ``run_restart`` after a
  stall, a two-process gang with sweep skew, the counter snapshot with
  ``re_shard_hbm_live_bytes``, serve stage buckets, nothing) give equal
  ``compute_status`` documents, exit codes and ``format_status`` /
  ``format_gang`` text;
- a real trace dir of a tiny traced port driver run, read from the files
  and through each tool's ``ListenCollector`` fed by the driver's
  ``--telemetry-endpoint``;
- ``compute_fleet`` / ``format_fleet`` over fleet-dir layouts, and
  ``main``'s exit codes (0 / 2 / 3 / 4 / 5) and JSON on run dirs;
- the port tailer's two additions: a file replaced under it is read from
  its start, and ``from_end`` skips what the files held already.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import io
import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.serve.reqtrace import observe_stage
from photon_ml_tpu_torch.tools import photon_status as tst
from test_torch_drivers import TRAIN_FLAGS, make_game_avro

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jst = _jax_tool("photon_status")


# ---------------------------------------------------------------------------
# Record streams
# ---------------------------------------------------------------------------


def _span(name, p=0, **labels):
    return {"kind": "span", "name": name, "process_index": p,
            "labels": labels, "dur_us": 12.5}


def _beat(p=0, stalled=False, uptime=3.0, **totals):
    return {"kind": "heartbeat", "process_index": p, "stalled": stalled,
            "uptime_s": uptime, "metric_totals": totals}


def _updates(p=0, sweeps=2):
    return [_span("cd.update", p, sweep=s, coordinate=c)
            for s in range(sweeps) for c in ("fixed", "perUser")] + [
        _span("cd.sweep", p, sweep=s) for s in range(sweeps)]


TRAIN_TOTALS = {"host_fetches": 9.0, "cd_inflight_updates": 2.0,
                "retries": 1.0, "quarantines": 0.0,
                "telemetry_dropped": 3.0, "data_coverage": 0.75,
                "stalls": 1.0}


def _serve_totals() -> dict:
    reg = MetricsRegistry()
    for i, stage in enumerate(("queue_wait", "batch_form", "tier_gather",
                               "device_score", "reply")):
        for k in range(20):
            observe_stage(stage, 0.07 * (i + 1) * (k + 1), registry=reg)
    return {**reg.totals(), "serve_qps": 41.5, "serve_p50_ms": 3.25,
            "serve_p99_ms": 17.5, "serve_queue_depth": 2.0,
            "serve_rows_scored": 1234.0, "serve_shed": 1.0,
            "serve_tier_hits": 999.0, "serve_generation": 2.0}


def _streams() -> dict:
    manifest = {"kind": "run_manifest", "process_index": 0}
    healthy = [manifest, *_updates(), _beat(**TRAIN_TOTALS)]
    out = {
        "healthy": healthy,
        "stalled": [manifest, *_updates(sweeps=1),
                    _beat(stalled=True, **TRAIN_TOTALS)],
        "restart_after_stall": [
            manifest, *_updates(sweeps=1), _beat(stalled=True),
            {"kind": "run_restart"}, manifest, *_updates(), _beat()],
        "gang_skew": [*_updates(0, sweeps=3), _beat(0),
                      *_updates(1, sweeps=1), _beat(1)],
        "counter_snapshot": [
            *healthy,
            {"kind": "counter", "name": "host_fetches", "value": 7.0,
             "labels": {"site": "cd.epilogue"}},
            {"kind": "counter", "name": "host_fetches", "value": 5.0,
             "labels": {"site": "solver.loop_exit"}},
            {"kind": "gauge", "name": "hbm_live_bytes",
             "value": 3.5 * 2 ** 20},
            {"kind": "gauge", "name": "re_entity_shards", "value": 2.0},
            *({"kind": "gauge", "name": "re_shard_hbm_live_bytes",
               "value": v, "labels": {"shard": str(k)}}
              for k, v in enumerate((1.5 * 2 ** 20, 2 ** 21)))],
        "serve_stages": [
            manifest, _beat(**_serve_totals()),
            _span("serve.generation", generation="1",
                  model_id="game-model"),
            _span("serve.swap", generation="2", model_id="retrained-v2",
                  outcome="ok", reason=""),
            *(_span("serve.queue_wait") for _ in range(3))],
        "nothing": [],
    }
    for status in ("ok", "abort", "error", "preempted"):
        out[f"run_end_{status}"] = [
            *healthy, {"kind": "run_end", "status": status,
                       "reason": "why", "peak_hbm_bytes": 123.0,
                       "metric_totals": TRAIN_TOTALS}]
    return out


STREAMS = _streams()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_compute_status_equals_the_jax_tools(name):
    records = STREAMS[name]
    got = tst.compute_status(copy.deepcopy(records))
    want = jst.compute_status(copy.deepcopy(records))
    assert got == want
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert tst.format_status(got, "s") == jst.format_status(want, "s")
    assert tst.format_gang(got, "s") == jst.format_gang(want, "s")


@pytest.mark.parametrize("name,status,code", [
    ("healthy", "running", 0), ("stalled", "stalled", 2),
    ("restart_after_stall", "running", 0), ("run_end_ok", "finished", 0),
    ("run_end_abort", "aborted", 3), ("run_end_error", "aborted", 3),
    ("run_end_preempted", "preempted", 5), ("nothing", "no_data", 4)])
def test_verdicts_and_exit_codes(name, status, code):
    doc = tst.compute_status(copy.deepcopy(STREAMS[name]))
    assert (doc["status"], doc["exit_code"]) == (status, code)


def test_gang_skew_and_shard_breakdown():
    gang = tst.compute_status(copy.deepcopy(STREAMS["gang_skew"]))["gang"]
    assert gang == {"processes": 2, "min_sweep": 0, "max_sweep": 2,
                    "sweep_skew": 2}
    snap = tst.compute_status(copy.deepcopy(STREAMS["counter_snapshot"]))
    p0 = snap["processes"][0]
    assert p0["re_shard_hbm_live_bytes"] == {"0": 1.5 * 2 ** 20,
                                             "1": 2 ** 21}
    assert p0["host_syncs_per_update"] == 3.0  # (7 + 5) / 4 updates
    text = tst.format_gang(snap, "s")
    assert "shard[0] 1.5MiB" in text and "shard[1] 2.0MiB" in text
    serving = tst.compute_status(copy.deepcopy(
        STREAMS["serve_stages"]))["processes"][0]["serving"]
    assert serving["generation"] == 2
    assert serving["model_id"] == "retrained-v2"
    assert serving["queue_wait_spans"] == 3
    assert set(serving["stages"]) == {"queue_wait", "batch_form",
                                      "tier_gather", "device_score",
                                      "reply"}


# ---------------------------------------------------------------------------
# Run dirs, main's exit codes
# ---------------------------------------------------------------------------


def _write_run_dir(path, records) -> str:
    """``records`` as a trace dir: spans in ``spans.jsonl`` (without their
    kind, as the spill writes them), the rest in ``metrics.jsonl``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "metrics.jsonl"), "w") as m, \
            open(os.path.join(path, "spans.jsonl"), "w") as s:
        for rec in records:
            if rec.get("kind") == "span":
                s.write(json.dumps({k: v for k, v in rec.items()
                                    if k != "kind"}) + "\n")
            else:
                m.write(json.dumps(rec) + "\n")
    return str(path)


def _main(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = mod.main(argv)
    return code, buf.getvalue()


@pytest.mark.parametrize("name,code", [
    ("run_end_ok", 0), ("stalled", 2), ("run_end_abort", 3),
    ("nothing", 4), ("run_end_preempted", 5)])
@pytest.mark.parametrize("view", ["--json", "text", "--gang"])
def test_main_on_a_run_dir_equals_the_jax_tools(tmp_path, name, code, view):
    run_dir = _write_run_dir(tmp_path / name, STREAMS[name])
    argv = ["--run-dir", run_dir] + ([] if view == "text" else [view])
    got, want = _main(tst, argv), _main(jst, argv)
    assert got == want
    assert got[0] == code


def test_read_run_dir_skips_prev_files_and_torn_lines(tmp_path):
    run_dir = _write_run_dir(tmp_path / "r", STREAMS["healthy"])
    with open(os.path.join(run_dir, "metrics.jsonl.prev"), "w") as f:
        f.write(json.dumps(_beat(stalled=True)) + "\n")
    with open(os.path.join(run_dir, "metrics.jsonl"), "a") as f:
        f.write('{"kind": "heartbeat", "stalled": tr')  # a live torn tail
    got, want = tst.read_run_dir(run_dir), jst.read_run_dir(run_dir)
    assert got == want
    assert tst.compute_status(got)["status"] == "running"


def test_tailer_reads_a_replaced_file_from_its_start(tmp_path):
    """A relaunched incarnation rotates ``spans.jsonl`` away and starts a
    new one: the port's tailer reads the new file whole even when it is
    already longer than the old one was."""
    run_dir = _write_run_dir(tmp_path / "r", _updates(sweeps=1))
    tailer = tst.RunDirTailer(run_dir)
    assert tst.compute_status(tailer.poll())["updates"] == 2
    spans = os.path.join(run_dir, "spans.jsonl")
    os.replace(spans, spans + ".prev")
    with open(spans, "w") as f:
        for rec in _updates(sweeps=3):
            f.write(json.dumps({k: v for k, v in rec.items()
                                if k != "kind"}) + "\n")
    status = tst.compute_status(tailer.poll())
    assert status["updates"] == 2 + 6 and status["sweep"] == 2


def test_tailer_from_end_skips_what_the_files_held(tmp_path):
    """A supervisor's view of a new incarnation: the previous one's
    stalled heartbeat is not read as the new one's."""
    run_dir = _write_run_dir(tmp_path / "r", STREAMS["stalled"])
    assert tst.compute_status(tst.read_run_dir(run_dir))["status"] == \
        "stalled"
    tailer = tst.RunDirTailer(run_dir, from_end=True)
    assert tst.compute_status(tailer.poll())["status"] == "no_data"
    with open(os.path.join(run_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({"kind": "run_restart"}) + "\n")
        f.write(json.dumps(_beat()) + "\n")
    status = tst.compute_status(tailer.poll())
    assert status["status"] == "running" and status["updates"] == 0


# ---------------------------------------------------------------------------
# Fleet dirs
# ---------------------------------------------------------------------------


def _fleet_dir(root, states) -> str:
    """A ``photon_supervise --fleet`` layout: ``member<k>/`` per state in
    ``states`` plus ``router/``."""
    serve = _serve_totals()
    for k, state in enumerate(states):
        recs = [{"kind": "run_manifest"},
                _beat(stalled=state == "stalled", **{
                    **serve, "serve_qps": 10.0 + k,
                    "serve_generation": 1.0 + (state == "split")}),
                _span("serve.generation", generation="1",
                      model_id="game-model")]
        if state in ("finished", "aborted"):
            recs.append({"kind": "run_end",
                         "status": "ok" if state == "finished"
                         else "abort", "reason": ""})
        _write_run_dir(os.path.join(root, f"member{k}"), recs)
    reg = MetricsRegistry()
    for k in range(5):
        observe_stage("route.dispatch", 0.3 * (k + 1), registry=reg)
        observe_stage("route.member_wait", 0.9 * (k + 1), registry=reg)
    _write_run_dir(os.path.join(root, "router"),
                   [{"kind": "run_manifest"}, _beat(**reg.totals())])
    with open(os.path.join(root, "supervisor.jsonl"), "w") as f:
        f.write(json.dumps({"kind": "supervisor", "action": "done"}) + "\n")
    return str(root)


FLEETS = {"healthy": ["running", "running"],
          "one_stalled": ["running", "stalled"],
          "one_aborted": ["finished", "aborted"],
          "split": ["running", "split"], "finished": ["finished"]}


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_compute_fleet_equals_the_jax_tools(tmp_path, name):
    root = _fleet_dir(tmp_path / name, FLEETS[name])
    got, want = tst.compute_fleet(root), jst.compute_fleet(root)
    assert got == want
    assert tst.format_fleet(got, "f") == jst.format_fleet(want, "f")
    assert [r["member"] for r in got["fleet"]] == list(
        range(len(FLEETS[name])))
    assert got["router"]["member"] == "router"
    code = {"one_stalled": 2, "one_aborted": 3}.get(name, 0)
    assert got["exit_code"] == code
    argv = ["--fleet", "--run-dir", root, "--json"]
    assert _main(tst, argv) == _main(jst, argv)
    assert _main(tst, argv)[0] == code


def test_empty_fleet_dir_is_no_data(tmp_path):
    assert tst.compute_fleet(str(tmp_path)) == jst.compute_fleet(
        str(tmp_path))
    assert tst.compute_fleet(str(tmp_path))["exit_code"] == 4
    with pytest.raises(SystemExit):
        tst.main(["--fleet", "--listen", "unix:x.sock"])


# ---------------------------------------------------------------------------
# A real port run: its trace dir and its live stream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A tiny traced port training run (``--device cpu``) streaming to each
    tool's ``ListenCollector`` in turn: the JAX tool's while the first
    run trains, the port's while a second identical run does."""
    d = tmp_path_factory.mktemp("status")
    train, val = str(d / "train.avro"), str(d / "val.avro")
    make_game_avro(train, seed=0)
    make_game_avro(val, n=200, seed=1)
    out = {}
    for name, mod in (("jax", jst), ("torch", tst)):
        sock = str(d / f"{name}.sock")
        collector = mod.ListenCollector(f"unix:{sock}")
        REGISTRY.reset()
        try:
            ttd.run(["--train-input-dirs", train, "--validate-input-dirs",
                     val, *TRAIN_FLAGS, "--output-dir", str(d / f"out-{name}"),
                     "--trace-dir", str(d / f"trace-{name}"),
                     "--trace-heartbeat-seconds", "0.05",
                     "--telemetry-endpoint", f"unix:{sock}",
                     "--device", "cpu"])
            assert collector.ended.wait(10)
            out[name] = {"records": collector.records(),
                         "trace": str(d / f"trace-{name}")}
        finally:
            collector.close()
    return out


def test_a_port_trace_dir_reads_as_the_jax_tool_reads_it(port_run):
    trace = port_run["torch"]["trace"]
    got, want = tst.read_run_dir(trace), jst.read_run_dir(trace)
    assert got == want
    status = tst.compute_status(got)
    assert status == jst.compute_status(want)
    assert (status["status"], status["exit_code"]) == ("finished", 0)
    assert status["updates"] == 4 and status["sweep"] == 1
    # host_fetches, a name the port emits, gives the syncs per update
    assert status["processes"][0]["host_syncs_per_update"] is not None
    for view in (["--json"], [], ["--gang"]):
        argv = ["--run-dir", trace, *view]
        assert _main(tst, argv) == _main(jst, argv)


def test_listen_collectors_read_a_port_drivers_stream(port_run):
    for name in ("jax", "torch"):
        records = port_run[name]["records"]
        kinds = [r["kind"] for r in records]
        assert kinds[0] == "run_manifest" and kinds[-1] == "run_end"
        got = tst.compute_status(copy.deepcopy(records))
        assert got == jst.compute_status(copy.deepcopy(records))
        assert got["status"] == "finished" and got["updates"] == 4
    # the two runs are one argv: the same progress through either tool
    a, b = (tst.compute_status(port_run[n]["records"])
            for n in ("jax", "torch"))
    assert (a["updates"], a["sweep"]) == (b["updates"], b["sweep"])


def test_listen_main_times_out_to_no_data(tmp_path):
    sock = str(tmp_path / "l.sock")
    code, out = _main(tst, ["--listen", f"unix:{sock}", "--for-seconds",
                            "0.2", "--json"])
    assert code == 4 and json.loads(out)["status"] == "no_data"


def test_listen_collector_takes_tcp_lines():
    collector = tst.ListenCollector("127.0.0.1:0")
    try:
        port = collector._server.getsockname()[1]
        with socket.create_connection(("127.0.0.1", port)) as c:
            for rec in STREAMS["run_end_ok"]:
                c.sendall((json.dumps(rec) + "\n").encode())
        assert collector.ended.wait(10)
        deadline = time.monotonic() + 10
        while len(collector.records()) < len(STREAMS["run_end_ok"]) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert tst.compute_status(collector.records()) == \
            jst.compute_status(copy.deepcopy(STREAMS["run_end_ok"]))
    finally:
        collector.close()


def test_status_imports_no_torch():
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import photon_ml_tpu_torch.tools.photon_status\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
