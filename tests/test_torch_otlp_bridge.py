"""The port's OTLP bridge (``photon_ml_tpu_torch/tools/otlp_bridge.py``)
against the JAX bridge (``tools/otlp_bridge.py``), on the CPU:

- both bridges convert the same small run dir of the port's training
  driver (``--run-dir … --out``) to the same document, except where the
  port's manifest keys differ (:data:`PORT_ONLY_ATTRIBUTES`, from
  ``torch_version`` / ``cuda_version`` / ``device_name``) and the names
  that say which package emitted it (``service.name``, the scope name);
- ``--listen unix:`` is fed by a port training driver's
  ``--telemetry-endpoint`` and converts its stream;
- an unknown ``telemetry_proto`` exits 2;
- ``PHOTON_FAULTS=obs.otlp=io_error:99`` against the dead collector
  ``http://127.0.0.1:9`` exits 0 with ``dropped>0``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest
from _torch_chaos import deadline

from photon_ml_tpu_torch.tools import chaos_drill as tchaos
from photon_ml_tpu_torch.tools import otlp_bridge as tbridge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: resource attributes only the port's manifest carries
PORT_ONLY_ATTRIBUTES = {"photon.torch_version", "photon.cuda_version",
                        "photon.device_name"}
#: where the emitting package is named: (JAX value, port value)
PACKAGE_NAMES = {"service.name": ("photon_ml_tpu", "photon_ml_tpu_torch"),
                 "scope": ("photon_ml_tpu.obs", "photon_ml_tpu_torch.obs")}


def _driver(fixture, root, endpoint=None):
    """The chaos campaign's training argv on the CPU (4 x 40 rows)."""
    trace = os.path.join(root, "trace")
    args = tchaos.driver_args(fixture["data_dir"], fixture["fs_dir"],
                              os.path.join(root, "out"),
                              os.path.join(root, "ckpt"), trace, "cpu")
    if endpoint:
        args += ["--telemetry-endpoint", endpoint]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PHOTON_FAULTS")}
    proc = subprocess.run(
        [sys.executable, "-m", tchaos.TRAIN_MODULE, *args], cwd=REPO,
        env=env, text=True, capture_output=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return trace


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("otlp_bridge"))
    fixture = tchaos.build_fixture(root)
    return {"root": root, "fixture": fixture,
            "trace": _driver(fixture, os.path.join(root, "run"))}


def _jax_bridge():
    spec = importlib.util.spec_from_file_location(
        "_tool_otlp_bridge", os.path.join(REPO, "tools", "otlp_bridge.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _without_package_fields(docs: dict, package: int) -> tuple[dict, set]:
    """``docs`` with the port-only resource attributes taken out (their
    keys returned) and the package names checked and blanked."""
    dropped = set()
    for kind, res_key, scope_key in (("traces", "resourceSpans",
                                      "scopeSpans"),
                                     ("metrics", "resourceMetrics",
                                      "scopeMetrics")):
        for res in docs[kind][res_key]:
            attrs = []
            for a in res["resource"]["attributes"]:
                if a["key"] in PORT_ONLY_ATTRIBUTES:
                    dropped.add(a["key"])
                    continue
                if a["key"] == "service.name":
                    assert a["value"]["stringValue"] \
                        == PACKAGE_NAMES["service.name"][package]
                    a = {"key": a["key"], "value": None}
                attrs.append(a)
            res["resource"]["attributes"] = attrs
            for scope in res[scope_key]:
                assert scope["scope"]["name"] == PACKAGE_NAMES["scope"][
                    package]
                scope["scope"]["name"] = None
    return docs, dropped


def test_port_bridge_gives_the_jax_document(run, tmp_path, capsys):
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    assert tbridge.main(["--run-dir", run["trace"], "--out",
                         str(port_out)]) == 0
    port_line = capsys.readouterr().err.strip().splitlines()[-1]
    assert _jax_bridge().main(["--run-dir", run["trace"], "--out",
                               str(jax_out)]) == 0
    jax_line = capsys.readouterr().err.strip().splitlines()[-1]
    assert port_line == jax_line
    assert "posted=0 dropped=0" in port_line
    port, dropped = _without_package_fields(
        json.loads(port_out.read_text()), package=1)
    jax_doc, none = _without_package_fields(
        json.loads(jax_out.read_text()), package=0)
    assert none == set()
    # the CPU run's manifest has a torch version and a device, no CUDA
    assert dropped == {"photon.torch_version", "photon.device_name"}
    assert port == jax_doc
    spans = {s["name"] for rs in port["traces"]["resourceSpans"]
             for ss in rs["scopeSpans"] for s in ss["spans"]}
    assert {"cd.sweep", "cd.update"} <= spans


def test_listen_unix_is_fed_by_a_training_driver(run, tmp_path):
    sock = str(tmp_path / "bridge.sock")
    out = tmp_path / "listened.json"
    rc = {}

    def bridge():
        rc["rc"] = tbridge.main(["--listen", "unix:" + sock, "--out",
                                 str(out), "--for-seconds", "40"])

    with deadline(120):
        th = threading.Thread(target=bridge)
        th.start()
        t0 = time.monotonic()
        while not os.path.exists(sock):
            assert time.monotonic() - t0 < 30, "bridge never listened"
            time.sleep(0.05)
        trace = _driver(run["fixture"], str(tmp_path / "run"),
                        endpoint="unix:" + sock)
        th.join()
    assert rc["rc"] == 0
    docs = json.loads(out.read_text())
    spans = {s["name"] for rs in docs["traces"]["resourceSpans"]
             for ss in rs["scopeSpans"] for s in ss["spans"]}
    assert {"cd.sweep", "cd.update"} <= spans
    (res,) = docs["traces"]["resourceSpans"]
    attrs = {a["key"]: a["value"] for a in res["resource"]["attributes"]}
    assert attrs["photon.telemetry_proto"] == {"intValue": "1"}
    # the stream went to the bridge, not to the run dir's fallback file
    assert not os.path.exists(os.path.join(trace, "telemetry.jsonl"))


def test_unknown_telemetry_proto_exits_2(run, tmp_path, capsys):
    trace = str(tmp_path / "trace")
    shutil.copytree(run["trace"], trace)
    path = os.path.join(trace, "run_manifest.json")
    with open(path) as fh:
        manifest = json.load(fh)
    manifest["telemetry_proto"] = 99
    with open(path, "w") as fh:
        json.dump(manifest, fh)
    assert tbridge.main(["--run-dir", trace, "--out",
                         str(tmp_path / "x.json")]) == 2
    assert "telemetry_proto" in capsys.readouterr().err
    assert not (tmp_path / "x.json").exists()


def test_dead_collector_under_io_error_exits_0_with_drops(run):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PHOTON_FAULTS")}
    env.update({"PHOTON_FAULTS": "obs.otlp=io_error:99",
                "PHOTON_FAULTS_SEED": "42"})
    proc = subprocess.run(
        [sys.executable, "-m", tchaos.BRIDGE_MODULE, "--run-dir",
         run["trace"], "--collector", "http://127.0.0.1:9"],
        cwd=REPO, env=env, text=True, capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    words = dict(w.split("=", 1) for w in proc.stderr.split()
                 if w.startswith(("posted=", "dropped=")))
    assert int(words["dropped"]) > 0 and int(words["posted"]) == 0
    assert "Traceback" not in proc.stderr
