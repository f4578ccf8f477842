"""The JAX package's two supervised and traced gang cases
(``tests/test_zz_supervisor_multihost.py``) on the port's training CLI,
over ``torch.distributed`` (gloo) on the CPU.

- One unkilled port gang with a shared ``--trace-dir`` runs beside the
  JAX package's gang on the same two part files. Its fixed effect is
  within the JAX test's ``rtol=atol=5e-3`` of the JAX gang's, and its
  members leave ``trace.0.json`` / ``trace.1.json``, which the port's
  ``trace_merge`` folds into one document of two tracks aligned on
  ``gang.form`` (the anchors' ends equal, each track monotonic), equal as
  JSON to the JAX tool's document of the same dir; the port's
  ``trace_report --process 1 --json`` on it gives ``processes == [1]``.
- A supervised port gang under ``PHOTON_FAULTS=worker.start@0=kill:1:21``
  (member 0 dies right after joining, once across relaunches through the
  shared state dir): member 1's first collective fails within
  ``--heartbeat-timeout``, both supervisors relaunch and re-form the gang
  at the same ``--coordinator``, both end with rc 0,
  ``MULTIHOST_GAME_OK`` and ``SUPERVISOR_OK``, process 0 with at least
  one restart, and both members' npz equal the unkilled gang's bit for
  bit (tracing changes no result).

Two gangs of the port in all, in a file of its own (``--dist loadfile``
keeps it on one worker), each test under a SIGALRM deadline.
"""

import json
import os
import sys

import numpy as np
import pytest

from _torch_chaos import deadline
from test_torch_multihost import (
    _env,
    _free_port,
    _game_cli_args,
    _gang,
    _npz,
    _write_game_part,
)
from test_torch_trace_tools import _jax_tool, _run

from photon_ml_tpu_torch.tools import trace_merge as tmerge
from photon_ml_tpu_torch.tools import trace_report as treport


def _members(pkg, data, out, fs, extra=()):
    port = _free_port()
    return [[sys.executable, "-m", f"{pkg}.cli.game_training_driver",
             *_game_cli_args(data, out, fs, num_iterations=1), *extra,
             "--num-processes", "2", "--process-id", str(i),
             "--coordinator", f"127.0.0.1:{port}",
             "--coordinator-timeout", "60"] for i in range(2)]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The JAX test's two part files and feature sets; the unkilled port
    gang, traced, beside the JAX package's gang on them (four processes
    at once)."""
    from photon_ml_tpu.io.data_format import NameAndTermFeatureSets

    root = tmp_path_factory.mktemp("torch_sup_mh")
    data = root / "data"
    data.mkdir()
    _write_game_part(str(data / "part-00000.avro"), n=120, n_users=5,
                     d_g=4, d_u=2, seed=30)
    _write_game_part(str(data / "part-00001.avro"), n=100, n_users=5,
                     d_g=4, d_u=2, seed=31)
    fs = root / "fs"
    NameAndTermFeatureSets.from_paths(
        [str(data)], ["globalFeatures", "userFeatures"]).save(str(fs))
    trace_dir = root / "trace"
    argvs = (_members("photon_ml_tpu_torch", str(data), str(root / "torch"),
                      str(fs), ["--device", "cpu", "--trace-dir",
                                str(trace_dir), "--trace-heartbeat-seconds",
                                "0.5"])
             + _members("photon_ml_tpu", str(data), str(root / "jax"),
                        str(fs)))
    with deadline(300):
        outs = _gang(argvs, timeout=240)
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {i}: {err[-3000:]}"
        assert f"MULTIHOST_GAME_OK process={i % 2}" in out, out
    return dict(root=root, data=str(data), fs=str(fs),
                trace=str(trace_dir))


def test_unkilled_port_gang_agrees_with_the_jax_gang(gangs):
    got = [_npz(gangs["root"] / "torch", i) for i in range(2)]
    want = _npz(gangs["root"] / "jax", 0)
    for key in got[0]:
        np.testing.assert_array_equal(got[0][key], got[1][key])
    np.testing.assert_allclose(got[0]["fixed"], want["fixed"], rtol=5e-3,
                               atol=5e-3)


def test_worker_start_kill_relaunches_the_gang_bit_for_bit(gangs,
                                                           tmp_path):
    env = _env()
    env["PHOTON_FAULTS"] = "worker.start@0=kill:1:21"
    env["PHOTON_FAULTS_STATE_DIR"] = str(tmp_path / "fault_state")
    out = tmp_path / "sup"
    with deadline(240):
        outs = _gang(_members(
            "photon_ml_tpu_torch", gangs["data"], str(out), gangs["fs"],
            ["--device", "cpu", "--heartbeat-timeout", "10",
             "--max-worker-restarts", "3", "--worker-backoff-base", "0.5"]),
            env=env, timeout=200)
    for i, (rc, so, err) in enumerate(outs):
        assert rc == 0, f"supervisor {i} rc={rc}\n{so}\n{err[-3000:]}"
        assert f"MULTIHOST_GAME_OK process={i}" in so, so
        assert f"SUPERVISOR_OK worker=p{i} restarts=" in so, so
    restarts0 = int(outs[0][1].split("restarts=")[-1].split()[0])
    assert restarts0 >= 1, outs[0][1]
    assert os.listdir(tmp_path / "fault_state"), "the kill never fired"
    ref = _npz(gangs["root"] / "torch", 0)
    for i in range(2):
        got = _npz(out, i)
        assert sorted(got) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])


def test_traced_gang_merges_on_gang_form(gangs, tmp_path):
    trace_dir = gangs["trace"]
    for i in range(2):
        assert os.path.exists(os.path.join(trace_dir, f"trace.{i}.json")), \
            os.listdir(trace_dir)
    merged = os.path.join(trace_dir, "merged_trace.json")
    jax_out = str(tmp_path / "jax_merged.json")
    rc, line, err = _run(tmerge, [trace_dir])
    assert rc == 0, err
    assert "2 process track(s)" in line and "alignment=gang.form" in line
    with open(merged) as fh:
        doc = json.load(fh)
    assert _run(_jax_tool("trace_merge"), [trace_dir, "--out",
                                           jax_out])[0] == 0
    with open(jax_out) as fh:
        assert json.load(fh) == doc
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["pid"] for e in xs} == {0, 1}
    assert doc["otherData"]["alignment"] == "gang.form"
    ends = {}
    for e in xs:
        if e["name"] == "gang.form":
            ends.setdefault(e["pid"], e["ts"] + e["dur"])
    assert set(ends) == {0, 1}
    assert ends[0] == pytest.approx(ends[1])
    for pid in (0, 1):
        ts = [e["ts"] for e in xs if e["pid"] == pid]
        assert ts == sorted(ts)
    rc, report, err = _run(treport, [merged, "--process", "1", "--json"])
    assert rc == 0, err
    assert json.loads(report)["processes"] == [1]
