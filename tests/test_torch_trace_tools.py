"""The port's trace tools held against the JAX package's, on the CPU.

``photon_ml_tpu_torch/tools/trace_report.py``, ``trace_merge.py`` and
``trace_diff.py`` and the JAX tools under ``tools/`` run in this process
(``main(argv)`` with stdout and stderr captured) on the same inputs:

- the port's own traced training and scoring run dirs (both drivers with
  ``--trace-dir`` on the CPU, as ``tests/test_torch_telemetry.py``'s
  ``traced`` fixture runs them);
- the JAX tests' synthetic inputs, mirrored here: per-process gang traces
  (``tests/test_telemetry.py:347-373``; with and without the
  ``gang.form`` anchor and ``start_unix_time``, a live ``spans.<i>.jsonl``
  dir, a relaunched member's ``.prev`` files), a fleet dir with sampled
  and unsampled exemplars (``tests/test_reqtrace.py:189-255``) and the
  flat diff profiles (``tests/test_telemetry.py:447-460``).

``trace_report`` (text, ``--json``, ``--process``, ``--request`` in text
and JSON) and ``trace_diff`` must print the same bytes with the same exit
code; ``trace_merge`` must print the same line and write a document equal
as JSON. The one difference is ``--device``: the port's view reads
``build.compile`` spans (its build sites and causes, null rates), pinned
here on a trace the port's own tracer and build recorder wrote, and the
JAX tool's view of the same trace still finds no device-plane span.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import sys
import time

import pytest
import torch

from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.obs import compile as tcompile
from photon_ml_tpu_torch.obs import trace as ttrace
from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.serve.reqtrace import child_span_id
from photon_ml_tpu_torch.tools import trace_diff as tdiff
from photon_ml_tpu_torch.tools import trace_merge as tmerge
from photon_ml_tpu_torch.tools import trace_report as treport
from test_torch_drivers import SECTIONS, TRAIN_FLAGS, make_game_avro

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name: str):
    """A JAX tool loaded from its file, as the JAX tests run it; the
    ``sys.path`` entry ``trace_diff`` adds for its sibling is taken out
    again."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


JAX = {name: _jax_tool(name)
       for name in ("trace_report", "trace_merge", "trace_diff")}
PORT = {"trace_report": treport, "trace_merge": tmerge,
        "trace_diff": tdiff}


def _run(mod, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _both(tool: str, argv) -> tuple[tuple, tuple]:
    return _run(JAX[tool], argv), _run(PORT[tool], argv)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _x(name, ts, dur, pid=0, tid=1, **labels):
    return {"name": name, "cat": "photon", "ph": "X", "ts": ts,
            "dur": dur, "pid": pid, "tid": tid, "args": labels}


def _write_trace(path, events, other=None) -> None:
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if other is not None:
        doc["otherData"] = other
    with open(path, "w") as fh:
        json.dump(doc, fh)


def _write_gang_dir(d, anchor=True, start_unix=True, prev=False) -> str:
    """Two processes whose tracer epochs are unrelated clocks
    (``tests/test_telemetry.py:_write_run_dir``); ``prev`` adds a
    relaunched member's rotated incarnation, which the merge skips."""
    os.makedirs(d)
    p0 = [_x("cd.sweep", 1600, 1000, 0, sweep=0),
          _x("cd.update", 1700, 300, 0, sweep=0, coordinate="fixed")]
    p1 = [_x("cd.sweep", 50_500, 900, 1, sweep=0),
          _x("cd.update", 50_600, 500, 1, sweep=0, coordinate="fixed")]
    if anchor:
        p0.insert(0, _x("gang.form", 1000, 500, 0))
        p1.insert(0, _x("gang.form", 50_000, 400, 1))
    for i, events in ((0, p0), (1, p1)):
        other = {"process_index": i}
        if start_unix:
            other["start_unix_time"] = 100.0 + i
        _write_trace(os.path.join(d, f"trace.{i}.json"), events, other)
    if prev:
        _write_trace(os.path.join(d, "trace.1.json.prev"),
                     [_x("gang.form", 9, 1, 1), _x("cd.sweep", 10, 5, 1)],
                     {"process_index": 1, "start_unix_time": 50.0})
        with open(os.path.join(d, "spans.1.jsonl.prev"), "w") as fh:
            fh.write(json.dumps({"name": "cd.sweep", "tid": 1, "depth": 0,
                                 "ts_us": 3.0, "dur_us": 1.0,
                                 "labels": {}}) + "\n")
    return d


def _write_live_dir(d) -> str:
    """A gang still in flight: ``spans.<i>.jsonl`` only, each with a torn
    last line (``tests/test_telemetry.py:test_from_spans_jsonl_live_dir``)."""
    os.makedirs(d)
    for i, t0 in ((0, 1000.0), (1, 90_000.0)):
        with open(os.path.join(d, f"spans.{i}.jsonl"), "w") as fh:
            for name, ts, dur in (("gang.form", t0, 400.0),
                                  ("cd.sweep", t0 + 500, 800.0)):
                fh.write(json.dumps({"name": name, "tid": 7, "depth": 0,
                                     "ts_us": ts, "dur_us": dur,
                                     "labels": {}}) + "\n")
            fh.write('{"torn tail')
    return d


CLIENT_PARENT = "f" * 16
TID = "ab" * 8          # the cross-process request
EX_TID = "cd" * 8       # an unsampled exemplar's trace
SAMPLED_EX_TID = "ee" * 8


def _write_fleet_dir(fleet) -> str:
    """``router/`` + ``member0/`` + ``member1/`` holding one request's
    cross-process span tree (ids derived as the serve plane derives them)
    and member0's exemplars, one unsampled and one sampled
    (``tests/test_reqtrace.py:_write_fleet_dir``)."""
    rs = child_span_id(TID, "serve.request", CLIENT_PARENT)
    ds = child_span_id(TID, "route.dispatch", 1)
    ws = child_span_id(TID, "route.member_wait", 1)
    ms = child_span_id(TID, "serve.request", ds)
    router = [
        _x("serve.request", 1000.0, 9000.0, trace_id=TID, span_id=rs,
           parent=CLIENT_PARENT, rows=24, outcome="ok"),
        _x("route.dispatch", 1500.0, 8000.0, trace_id=TID, span_id=ds,
           parent=rs, shard=1, member=0, hops=1, outcome="ok"),
        _x("route.member_wait", 2000.0, 7000.0, trace_id=TID, span_id=ws,
           parent=ds, member=0)]
    stage_at = {"serve.queue_wait": (2600.0, 400.0),
                "serve.batch_form": (3000.0, 200.0),
                "serve.tier_gather": (3200.0, 800.0),
                "serve.device_score": (4000.0, 3000.0),
                "serve.reply": (7000.0, 500.0)}
    member0 = [_x("serve.request", 2500.0, 5200.0, trace_id=TID,
                  span_id=ms, parent=ds, rows=14, outcome="ok")]
    for name, (ts, dur) in stage_at.items():
        member0.append(_x(name, ts, dur, trace_id=TID,
                          span_id=child_span_id(TID, name, ms), parent=ms))
    member1 = [_x("serve.request", 100.0, 50.0, trace_id="99" * 8,
                  span_id=child_span_id("99" * 8, "serve.request", 0),
                  parent="", rows=1, outcome="ok")]
    starts = {"router": 1000.0, "member0": 1000.5, "member1": 1001.0}
    for sub, events in (("router", router), ("member0", member0),
                        ("member1", member1)):
        os.makedirs(os.path.join(fleet, sub))
        _write_trace(os.path.join(fleet, sub, "trace.json"), events,
                     {"start_unix_time": starts[sub]})

    def exemplar(trace_id, sampled, ts):
        root = child_span_id(trace_id, "serve.request", 0)
        evs = [{"name": "serve.request", "tid": 9, "depth": 0,
                "ts_us": ts, "dur_us": 9000.0,
                "labels": {"trace_id": trace_id, "span_id": root,
                           "parent": "", "rows": 4, "outcome": "ok"}}]
        evs += [{"name": name, "tid": 9, "depth": 1, "ts_us": ts + 100.0,
                 "dur_us": 500.0,
                 "labels": {"trace_id": trace_id,
                            "span_id": child_span_id(trace_id, name, 0),
                            "parent": root}} for name in stage_at]
        return {"trace_id": trace_id, "request_id": "r1",
                "sampled": sampled, "latency_ms": 9.0, "events": evs}

    with open(os.path.join(fleet, "member0", "exemplars.jsonl"), "w") as fh:
        fh.write(json.dumps(exemplar(EX_TID, False, 50_000.0)) + "\n")
        fh.write(json.dumps(exemplar(SAMPLED_EX_TID, True, 60_000.0)) + "\n")
    return fleet


def _profile_trace(path, fetch_dur_us) -> str:
    """A flat timeline: later spans start after earlier ones end, so
    inflating one name moves everything after it
    (``tests/test_telemetry.py:_profile_trace``)."""
    events, t = [], 0.0
    for _ in range(20):
        events.append(_x("cd.update", t, 10_000))
        t += 11_000
        events.append(_x("cd.epilogue_fetch", t, fetch_dur_us))
        t += fetch_dur_us + 1_000
        events.append(_x("tiny", t, 50))
        t += 100
    _write_trace(path, events)
    return path


def _tied_trace(path) -> str:
    """Spans that open in the same microsecond, the child listed first, as
    the port's spans do when a coordinate's update opens its solve at
    once: the sort key ``(ts, -dur)`` makes the longer one the parent."""
    events = []
    for i in range(5):
        t = i * 10_000.0
        events += [_x("optimizer.solve", t, 2_000.0 + i),
                   _x("cd.update", t, 5_000.0, sweep=i % 2,
                      coordinate="fixed"),
                   _x("cd.epilogue_fetch", t + 5_000.0, 0.0),
                   _x("cd.validation", t + 5_000.0, 300.0)]
    _write_trace(path, events)
    return path


def _build_span_trace(path) -> str:
    """A trace the port's own tracer writes with ``build.compile`` spans
    recorded by ``obs/compile.py`` at each of its three sites and with
    both causes, nested under the spans they run in: the host library's
    build under ``driver.phase``, a kernel library's build and an ELL
    column-sum plan under ``optimizer.solve``."""
    tracer = ttrace.enable()
    tcompile.arm(MetricsRegistry())
    try:
        with ttrace.span("driver.phase", phase="load"):
            t0 = time.perf_counter_ns()
            time.sleep(0.002)
            tcompile.record_build("host.gxx:photon_host",
                                  tcompile.NO_CACHE_ENTRY, t0,
                                  compiler="g++")
        for i, cause in enumerate((tcompile.HASH_CHANGED,
                                   tcompile.NO_CACHE_ENTRY)):
            with ttrace.span("optimizer.solve", coordinate="fixed"):
                t0 = time.perf_counter_ns()
                time.sleep(0.002)
                tcompile.record_build("kernels.nvcc:fused_value_gradient",
                                      cause, t0, compiler="nvcc")
                t0 = time.perf_counter_ns()
                tcompile.record_build("data.column_sum_plan",
                                      tcompile.NO_CACHE_ENTRY, t0,
                                      nnz=10 + i, columns=5000)
                time.sleep(0.002)
        tracer.write_chrome_trace(path)
    finally:
        tcompile.disarm()
        ttrace.disable()
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The port's traced training and scoring runs (one small GLMix argv,
    as the ``traced`` fixture of ``tests/test_torch_telemetry.py``), the
    mirrored synthetic dirs, their merged documents, and the build-span
    trace."""
    d = tmp_path_factory.mktemp("trace_tools")
    train, val = str(d / "train.avro"), str(d / "val.avro")
    make_game_avro(train, seed=0)
    make_game_avro(val, n=200, seed=1)
    traces = {role: str(d / f"{role}-trace") for role in ("train", "score")}
    REGISTRY.reset()
    ttd.run(["--train-input-dirs", train, "--validate-input-dirs", val,
             *TRAIN_FLAGS, "--output-dir", str(d / "out"),
             "--trace-dir", traces["train"], "--trace-heartbeat-seconds",
             "0.05", "--device", "cpu"])
    REGISTRY.reset()
    tsd.run(["--input-data-dirs", val, "--game-model-input-dir",
             str(d / "out" / "best"), "--output-dir", str(d / "score"),
             "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
             "--random-effect-id-set", "userId", "--evaluator-type", "AUC",
             "--trace-dir", traces["score"], "--trace-heartbeat-seconds",
             "0.05", "--device", "cpu"])
    out = {role: os.path.join(t, "trace.json") for role, t in traces.items()}
    out["root"] = str(d)
    out["gang_dir"] = _write_gang_dir(str(d / "gang"))
    out["fleet_dir"] = _write_fleet_dir(str(d / "fleet"))
    for kind in ("gang", "fleet"):
        merged = str(d / f"{kind}_merged.json")
        assert _run(tmerge, [out[f"{kind}_dir"], "--out", merged])[0] == 0
        out[kind] = merged
    out["builds"] = _build_span_trace(str(d / "builds.json"))
    out["tied"] = _tied_trace(str(d / "tied.json"))
    _write_trace(str(d / "no_spans.json"), [{"ph": "M", "name": "x"}])
    out["no_spans"] = str(d / "no_spans.json")
    with open(d / "broken.json", "w") as fh:
        fh.write("{]")
    out["broken"] = str(d / "broken.json")
    out["missing"] = str(d / "missing.json")
    out["base"] = _profile_trace(str(d / "base.json"), 8_000)
    out["wiggle"] = _profile_trace(str(d / "wiggle.json"), 8_400)
    out["inflated"] = _profile_trace(str(d / "inflated.json"), 16_000)
    return out


# ---------------------------------------------------------------------------
# trace_report
# ---------------------------------------------------------------------------

REPORT_CASES = [
    ("train", []), ("train", ["--json"]), ("train", ["--top", "3"]),
    ("train", ["--json", "--top", "4"]), ("train", ["--process", "0"]),
    ("train", ["--process", "0", "--json"]), ("score", []),
    ("score", ["--json"]), ("gang", []), ("gang", ["--json"]),
    ("gang", ["--process", "1", "--json"]), ("gang", ["--process", "1"]),
    ("gang", ["--process", "7", "--json"]), ("fleet", ["--json"]),
    ("fleet", ["--request", TID]), ("fleet", ["--request", TID, "--json"]),
    ("fleet", ["--request", EX_TID, "--json"]),
    ("fleet", ["--request", EX_TID, "--process", "1"]),
    ("fleet", ["--request", "0" * 16]), ("builds", ["--json"]),
    ("tied", []), ("tied", ["--json"]),
    ("no_spans", []), ("broken", ["--json"]), ("missing", []),
]


@pytest.mark.parametrize("name,argv", REPORT_CASES,
                         ids=[f"{n}-{'_'.join(a) or 'text'}"
                              for n, a in REPORT_CASES])
def test_report_prints_the_jax_tools_bytes(inputs, name, argv):
    want, got = _both("trace_report", [inputs[name], *argv])
    assert got == want
    assert got[0] == (2 if name in ("no_spans", "broken", "missing")
                      or "7" in argv or "0" * 16 in argv else 0)


def test_report_reads_the_ports_sweeps_and_processes(inputs):
    rc, out, _ = _run(treport, [inputs["train"], "--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["processes"] == [0]
    assert {(r["sweep"], r["coordinate"]) for r in doc[
        "sweep_attribution"]} == {(s, c) for s in (0, 1)
                                  for c in ("fixed", "perUser")}
    rc, out, _ = _run(treport, [inputs["gang"], "--process", "1", "--json"])
    assert rc == 0 and json.loads(out)["processes"] == [1]


def test_request_tree_crosses_tracks(inputs):
    rc, out, _ = _run(treport, [inputs["fleet"], "--request", TID,
                                "--json"])
    [root] = json.loads(out)["spans"]
    assert rc == 0 and root["pid"] == 0
    [dispatch] = root["children"]
    member = {c["name"]: c for c in dispatch["children"]}["serve.request"]
    assert member["pid"] == 1
    assert [c["name"] for c in member["children"]] == [
        "serve.queue_wait", "serve.batch_form", "serve.tier_gather",
        "serve.device_score", "serve.reply"]


# -- --device, the torch form ------------------------------------------------


def test_device_view_joins_the_build_sites(inputs):
    rc, out, _ = _run(treport, [inputs["builds"], "--json", "--device"])
    assert rc == 0
    doc = json.loads(out)
    rows = {r["site"]: r for r in doc.pop("device")}
    _, plain, _ = _run(JAX["trace_report"], [inputs["builds"], "--json"])
    assert doc == json.loads(plain)  # the base document is the JAX one's
    assert sorted(rows) == ["data.column_sum_plan", "host.gxx:photon_host",
                            "kernels.nvcc:fused_value_gradient"]
    keys = {"site", "compiles", "compile_ms", "flops", "bytes_accessed",
            "retraces", "last_retrace", "runtime_span", "span_count",
            "span_self_ms", "gflops_per_sec", "gbytes_per_sec", "causes"}
    solve = treport.self_times(treport.load_events(inputs["builds"]))[
        "optimizer.solve"]
    for site, r in rows.items():
        assert set(r) == keys
        assert r["flops"] is r["bytes_accessed"] is None
        assert r["gflops_per_sec"] is r["gbytes_per_sec"] is None
        assert r["retraces"] == 0 and r["last_retrace"] is None
        assert r["compile_ms"] > 0 or site == "data.column_sum_plan"
    assert rows["host.gxx:photon_host"]["causes"] == {"no_cache_entry": 1}
    assert rows["host.gxx:photon_host"]["runtime_span"] is None
    assert rows["host.gxx:photon_host"]["span_count"] is None
    kernel = rows["kernels.nvcc:fused_value_gradient"]
    assert kernel["compiles"] == 2
    assert kernel["causes"] == {"no_cache_entry": 1,
                                "source_or_flags_hash_changed": 1}
    assert rows["data.column_sum_plan"]["causes"] == {"no_cache_entry": 2}
    for site in ("kernels.nvcc:fused_value_gradient",
                 "data.column_sum_plan"):
        assert rows[site]["runtime_span"] == "optimizer.solve"
        assert rows[site]["span_count"] == solve["count"] == 2
        assert rows[site]["span_self_ms"] == round(solve["self_us"] / 1e3,
                                                   3)

    rc, text, _ = _run(treport, [inputs["builds"], "--device"])
    lines = text.splitlines()
    assert rc == 0
    assert lines[0] == "device plane (build.compile ⋈ runtime span " \
                       "self-time):"
    table = {ln.split()[0]: ln.split() for ln in lines[3:6]}
    assert table["kernels.nvcc:fused_value_gradient"][1:2] == ["2"]
    assert table["kernels.nvcc:fused_value_gradient"][-2:] == ["—", "—"]
    assert table["host.gxx:photon_host"][4:] == ["—", "—", "—", "—"]
    assert "  kernels.nvcc:fused_value_gradient: no_cache_entry x1, " \
           "source_or_flags_hash_changed x1" in lines
    assert "  data.column_sum_plan: no_cache_entry x2" in lines


@pytest.mark.parametrize("name", ["train", "score"])
def test_device_view_without_build_spans_says_so(inputs, name):
    rc, out, _ = _run(treport, [inputs[name], "--device"])
    assert rc == 0
    assert out.strip() == (
        "no device-plane spans in this trace — run with --device-telemetry "
        "to record build.compile (a build found in the cache records none)")
    rc, out, _ = _run(treport, [inputs[name], "--device", "--json"])
    assert rc == 0 and json.loads(out)["device"] == []


def test_jax_device_view_finds_no_span_in_a_port_trace(inputs):
    """The difference pinned: the JAX view reads ``xla.*`` spans only."""
    rc, out, _ = _run(JAX["trace_report"], [inputs["builds"], "--device"])
    assert rc == 0
    assert out.strip() == ("no device-plane spans in this trace — run with "
                           "--device-telemetry to record "
                           "xla.compile/xla.retrace")
    rc, out, _ = _run(JAX["trace_report"], [inputs["builds"], "--device",
                                            "--json"])
    assert json.loads(out)["device"] == []


# ---------------------------------------------------------------------------
# trace_merge
# ---------------------------------------------------------------------------

#: case -> (writer of the run dir, extra argv, expected exit, alignment)
MERGE_CASES = {
    "gang": (lambda d: _write_gang_dir(d), [], 0, "gang.form"),
    "start_unix": (lambda d: _write_gang_dir(d, anchor=False), [], 0,
                   "start_unix"),
    "none": (lambda d: _write_gang_dir(d, anchor=False, start_unix=False),
             [], 0, "none"),
    "anchor_flag": (lambda d: _write_gang_dir(d), ["--anchor", "cd.sweep"],
                    0, "cd.sweep"),
    "prev_skipped": (lambda d: _write_gang_dir(d, prev=True), [], 0,
                     "gang.form"),
    "from_spans": (lambda d: _write_gang_dir(d), ["--from-spans"], 2, None),
    "live": (_write_live_dir, [], 0, "gang.form"),
    "live_from_spans": (_write_live_dir, ["--from-spans"], 0, "gang.form"),
    "fleet_detected": (_write_fleet_dir, [], 0, "start_unix"),
    "fleet_flag": (_write_fleet_dir, ["--fleet"], 0, "start_unix"),
    "empty": (lambda d: os.makedirs(d) or d, [], 2, None),
    "missing": (lambda d: d, [], 2, None),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_writes_the_jax_tools_document(tmp_path, case):
    write, extra, want_rc, alignment = MERGE_CASES[case]
    run_dir = write(str(tmp_path / "run"))
    out = str(tmp_path / "merged.json")
    docs = []
    for tool in (JAX["trace_merge"], tmerge):
        got = _run(tool, [run_dir, "--out", out, *extra])
        docs.append((got, json.load(open(out)) if got[0] == 0 else None))
        if os.path.exists(out):
            os.remove(out)
    (want, want_doc), (got, got_doc) = docs
    assert got == want
    assert got_doc == want_doc
    assert got[0] == want_rc
    if alignment is None:
        return
    assert got_doc["otherData"]["alignment"] == alignment
    xs = [e for e in got_doc["traceEvents"] if e["ph"] == "X"]
    pids = sorted({e["pid"] for e in xs})
    assert pids == ([0, 1, 2] if case.startswith("fleet") else [0, 1])
    if alignment == "gang.form":
        ends = {e["pid"]: e["ts"] + e["dur"] for e in xs
                if e["name"] == "gang.form"}
        assert ends[0] == ends[1]
    for pid in pids:
        ts = [e["ts"] for e in xs if e["pid"] == pid]
        assert ts == sorted(ts)
    sources = [e["args"]["name"] for e in got_doc["traceEvents"]
               if e["ph"] == "M" and e["name"] == "process_name"]
    assert not any(".prev" in s for s in sources)
    if case == "prev_skipped":
        assert len(xs) == 6  # the rotated incarnation's spans are out
    if case == "fleet_flag":
        ex = [e for e in xs if e["args"].get("trace_id") == EX_TID]
        assert len(ex) == 6 and {e["pid"] for e in ex} == {1}
        assert not [e for e in xs
                    if e["args"].get("trace_id") == SAMPLED_EX_TID]


# ---------------------------------------------------------------------------
# trace_diff
# ---------------------------------------------------------------------------

DIFF_CASES = [
    ("base", "wiggle", [], 0), ("base", "wiggle", ["--json"], 0),
    ("base", "inflated", [], 1), ("base", "inflated", ["--json"], 1),
    ("base", "inflated", ["--json", "--threshold-pct", "150"], 0),
    ("base", "inflated", ["--json", "--min-delta-ms", "500"], 0),
    ("base", "inflated", ["--json", "--min-self-ms", "1000"], 0),
    ("train", "train", ["--json"], 0), ("train", "score", [], 0),
    ("tied", "base", ["--json", "--min-self-ms", "0"], 1),
    ("gang", "gang", ["--process", "1", "--json"], 0),
    ("gang", "gang", ["--process", "5"], 2),
    ("broken", "broken", ["--json"], 2), ("base", "missing", [], 2),
    ("no_spans", "base", [], 2),
]


@pytest.mark.parametrize("base,new,argv,want_rc", DIFF_CASES,
                         ids=[f"{b}-{n}-{'_'.join(a) or 'text'}"
                              for b, n, a, _ in DIFF_CASES])
def test_diff_prints_the_jax_tools_bytes(inputs, base, new, argv, want_rc):
    want, got = _both("trace_diff", [inputs[base], inputs[new], *argv])
    assert got == want
    assert got[0] == want_rc
    if (base, new) == ("base", "inflated") and want_rc == 1 \
            and "--json" in argv:
        report = json.loads(got[1])
        assert report["regressions"] == ["cd.epilogue_fetch"]
        tiny = next(e for e in report["spans"] if e["span"] == "tiny")
        assert tiny["status"] == "sub-noise"
    if (base, new) == ("train", "train"):
        report = json.loads(got[1])
        assert report["verdict"] == "PASS"
        assert not [e for e in report["spans"]
                    if e["status"] in ("added", "removed")]
