"""The port's chaos campaign (``photon_ml_tpu_torch/tools/chaos_drill.py``)
against the JAX campaign (``tools/chaos_drill.py``): the cell table, its
coverage of the port's fault registry, the CLI and the device rule.

- ``build_cells(False)`` is the JAX table plus exactly the
  ``re.shard_dispatch=nan`` cell (the JAX table has no cell for that
  registered point, so the JAX campaign's full run stops at its own
  coverage assertion); ``build_cells(True)`` is the JAX smoke subset
  field for field.
- Every point of the port's ``FAULT_POINTS`` has a cell or is the one
  skipped ``worker.start``, and the full campaign's coverage assertion
  holds.
- ``python -m photon_ml_tpu_torch.tools.chaos_drill --device cpu --points
  obs.flush`` prints ``CHAOS_OK``, exits 0 and writes a report of the JAX
  shape; without CUDA and without ``--device cpu`` it exits non-zero
  before it creates its workdir.
- On the CPU the training driver's mesh repeats the CPU once for each
  entity shard asked for, so the ``re.shard_dispatch`` cell's
  ``--re-entity-shards 2`` alone gives its driver two shards.

The JAX tool is loaded from its file (it is not a package module).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from photon_ml_tpu_torch.parallel import mesh as tmesh
from photon_ml_tpu_torch.tools import chaos_drill as tchaos
from photon_ml_tpu_torch.utils.faults import FAULT_POINTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_chaos():
    spec = importlib.util.spec_from_file_location(
        "_tool_chaos_drill", os.path.join(REPO, "tools", "chaos_drill.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_full_table_is_the_jax_table_plus_the_shard_dispatch_cell(
        jax_chaos):
    port, jax_cells = tchaos.build_cells(False), jax_chaos.build_cells(False)
    assert len(jax_cells) == 52 and len(port) == 53
    added = [c for c in port if c not in jax_cells]
    assert [c for c in port if c in jax_cells] == jax_cells
    assert len(added) == 1
    (cell,) = added
    assert (cell["point"], cell["mode"], cell["spec"], cell["expected"]) \
        == ("re.shard_dispatch", "nan", "re.shard_dispatch=nan:1", "ok")
    assert cell["bit_exact"] and not cell["smoke"]
    assert tchaos.entity_shards_asked(cell["extra_args"]) == 2
    assert "--recovery-damping" in cell["extra_args"]
    assert "re.shard_dispatch" in FAULT_POINTS
    assert "nan" in FAULT_POINTS["re.shard_dispatch"].modes


def test_smoke_subset_equals_the_jax_smoke_subset(jax_chaos):
    port, jax_cells = tchaos.build_cells(True), jax_chaos.build_cells(True)
    assert len(port) == 11
    assert port == jax_cells


def test_every_registered_point_has_a_cell_or_is_worker_start():
    points = {c["point"] for c in tchaos.build_cells(False)}
    assert set(FAULT_POINTS) - points == {"worker.start"}
    # serve.telemetry is a scenario cell of the JAX table, not a point:
    # the dead consumer is its whole chaos
    assert points - set(FAULT_POINTS) == {"serve.telemetry"}
    assert set(tchaos.SKIPPED_POINTS) == {"worker.start"}
    for c in tchaos.build_cells(False):
        if c["point"] in FAULT_POINTS:
            assert c["mode"] in FAULT_POINTS[c["point"]].modes, c
    # the full campaign's coverage assertion holds on the CPU
    cells, skipped = tchaos.plan_cells(False, None, device="cpu")
    assert len(cells) == 53
    assert [s["cell"] for s in skipped] == ["worker.start=*"]
    assert "phase 16 (c)" in skipped[0]["note"]


def test_shard_dispatch_cell_is_skipped_on_a_host_without_its_cards(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cells, skipped = tchaos.plan_cells(False, None, device="cuda")
    assert len(cells) == 52
    assert {s["cell"] for s in skipped} == {"worker.start=*",
                                           "re.shard_dispatch=nan"}


def test_cpu_mesh_repeats_the_cpu_for_each_entity_shard():
    from photon_ml_tpu_torch.cli import game_training_driver as ttd

    cpu = torch.device("cpu")
    assert tmesh.visible_devices("cpu") == [cpu]
    assert tmesh.mesh_devices(2, "cpu") == [cpu, cpu]
    try:
        assert tmesh.setup_default_mesh(device="cpu") is None
        mesh = tmesh.setup_default_mesh(num_entity=2, device="cpu")
        assert mesh.shape[tmesh.ENTITY_AXIS] == 2
        assert mesh.shape[tmesh.DATA_AXIS] == 1
    finally:
        tmesh.set_default_mesh(None)
    (cell,) = [c for c in tchaos.build_cells(False)
               if c["point"] == "re.shard_dispatch"]
    args = tchaos.driver_args("d", "f", "o", "c", "t", "cpu")
    ns = ttd.parse_args(args + cell["extra_args"])
    ttd.resolve_entity_shards(ns)
    assert ns.re_entity_shards == 2
    ns = ttd.parse_args(args + ["--re-entity-shards", "auto"])
    ttd.resolve_entity_shards(ns)
    assert ns.re_entity_shards == 1


def test_driver_argv_is_the_jax_argv_plus_device(jax_chaos):
    args = ("data", "fs", "out", "ckpt", "trace")
    assert tchaos.driver_args(*args, "cpu") \
        == jax_chaos.driver_args(*args) + ["--device", "cpu"]


def _child_env(**extra):
    env = dict(os.environ)
    for k in ("PHOTON_FAULTS", "PHOTON_FAULTS_STATE_DIR"):
        env.pop(k, None)
    env.update(extra)
    return env


def test_cli_points_obs_flush(tmp_path):
    report_path = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.tools.chaos_drill",
         "--device", "cpu", "--points", "obs.flush",
         "--workdir", str(tmp_path / "work"), "--report", str(report_path)],
        cwd=REPO, env=_child_env(), text=True, capture_output=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "CHAOS_OK" in proc.stdout
    report = json.loads(report_path.read_text())
    assert set(report) == {"kind", "smoke", "reference_objective",
                           "cells_run", "cells_failed", "invariants",
                           "cells"}
    assert report["kind"] == "chaos_report" and report["smoke"] is False
    assert report["cells_run"] == 3 and report["cells_failed"] == 0
    assert [c["cell"] for c in report["cells"]] == [
        "obs.flush=io_error", "obs.flush=enospc", "obs.flush=flaky"]
    assert all(c["outcome"] == "ok" for c in report["cells"])
    assert set(report["cells"][0]) == {
        "cell", "spec", "expected", "rc", "outcome", "note", "seconds",
        "failures", "passed"}


def test_cli_refuses_cuda_on_a_host_without_it(tmp_path):
    workdir = tmp_path / "never"
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.tools.chaos_drill",
         "--smoke", "--workdir", str(workdir)],
        cwd=REPO, env=_child_env(CUDA_VISIBLE_DEVICES=""), text=True,
        capture_output=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "CHAOS_OK" not in proc.stdout
    assert not workdir.exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tchaos.run_campaign(str(workdir), smoke=True)
    assert not workdir.exists()
