"""The port's chaos campaign, the smoke cells beyond the training driver on
the CPU, each through the port's own code against this module's own
fixture and fault-free reference:

- ``obs.otlp=io_error`` — fault-free training, then the port's OTLP bridge
  (``python -m photon_ml_tpu_torch.tools.otlp_bridge``) over the run dir
  against a dead collector with the fault armed: exit 0 with its batches
  dropped and counted, the training result bit-exact;
- ``serve.route=kill`` — the no-black-hole drill: the port's supervisor
  (``--fleet 4``) runs four port services and the port's router, member 1
  dies mid-request, every request is answered (scores bit-exact to the
  shared batch core on the CPU, or a typed error) and the member is
  relaunched and re-admitted;
- ``scenario.corrupt_shard`` — real bytes flipped in one Avro part: the
  run completes with the shard quarantined and coverage below 1.
"""

from __future__ import annotations

import pytest
from _torch_chaos import campaign_workdir, deadline, run_named

from photon_ml_tpu_torch.tools import chaos_drill as tchaos


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    return campaign_workdir(tmp_path_factory, "chaos_serve")


def test_bridge_cell(campaign):
    r = run_named(campaign, "obs.otlp=io_error", seconds=240)
    assert r["passed"], r["failures"]
    assert r["rc"] == 0
    assert r["outcome"].startswith("bridge_survived+dropped(")


def test_fleet_kill_cell(campaign):
    r = run_named(campaign, "serve.route=kill@fleet", seconds=420)
    assert r["passed"], r["failures"]
    assert r["rc"] == 0
    assert r["outcome"].startswith("killed+relaunched(answered=")


def test_corrupt_shard_scenario(campaign):
    with deadline(240):
        r = tchaos.run_corrupt_shard_scenario(
            campaign["fixture"], campaign["workdir"], device="cpu")
    assert r["passed"], r["failures"]
    assert r["rc"] == 0 and r["outcome"].startswith("degraded(coverage=")
