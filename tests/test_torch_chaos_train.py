"""The port's chaos campaign, its training smoke cells on the CPU: each
cell of the JAX smoke subset that drives the training driver runs
through the port's ``run_cell`` (a real ``photon_ml_tpu_torch`` driver
process under ``PHOTON_FAULTS``) against this module's own fixture and
fault-free reference, and lands the outcome the JAX gate asserts
(``tests/test_chaos_drill.py``). The added ``re.shard_dispatch=nan``
cell runs here too: two entity shards on the CPU, the fault fired, the
run bit-exact to its own reference. The bridge, fleet and corrupt-shard
cells are in ``test_torch_chaos_serve.py``."""

from __future__ import annotations

import json
import os

import pytest
from _torch_chaos import campaign_workdir, cell_named, run_named

#: cell -> (outcome, whether it is a prefix), as tests/test_chaos_drill.py
#: asserts them; the smoke cells it does not name must end "ok"
OUTCOMES = {
    "io.shard_open=io_error": ("ok", False),
    "io.avro_read=corrupt": ("degraded", True),
    "io.index_map=io_error": ("clean_abort", False),
    "ckpt.write_bytes=partial": ("ok", False),
    "cd.update=nan": ("ok", False),
    "cd.update=kill": ("killed+resumed", False),
    "cd.update=signal@per_update": ("preempted+resumed", False),
    "obs.flush=io_error": ("ok", False),
    "obs.export=io_error": ("ok+dropped(", True),
}


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    return campaign_workdir(tmp_path_factory, "chaos_train")


def test_training_cells_are_the_smoke_subsets_training_cells():
    from photon_ml_tpu_torch.tools.chaos_drill import build_cells

    training = [c for c in build_cells(True)
                if not c["serve"] and not c["bridge"]]
    names = {f"{c['point']}={c['mode']}"
             + (f"@{c['variant']}" if c["variant"] else "")
             for c in training}
    assert names == set(OUTCOMES)


@pytest.mark.parametrize("name", sorted(OUTCOMES))
def test_smoke_training_cell(campaign, name):
    r = run_named(campaign, name, seconds=240)
    assert r["passed"], r["failures"]
    want, prefix = OUTCOMES[name]
    if prefix:
        assert r["outcome"].startswith(want), r["outcome"]
    else:
        assert r["outcome"] == want
    assert r["cell"] == name and r["expected"] == cell_named(name)[
        "expected"]


def test_shard_dispatch_cell_fires_and_lands_bit_exact(campaign):
    r = run_named(campaign, "re.shard_dispatch=nan", seconds=240,
                  smoke=False)
    assert r["passed"], r["failures"]
    assert (r["rc"], r["outcome"]) == (0, "ok")
    cell_dir = os.path.join(campaign["workdir"], "cells",
                            "re_shard_dispatch_nan")
    assert [n for n in os.listdir(os.path.join(cell_dir, "fault_state"))
            if n.startswith("re.shard_dispatch_")]
    # the recovery ladder as both packages' tests define the fault:
    # retried, then recovered, on two entity shards
    actions, shards = set(), set()
    with open(os.path.join(cell_dir, "trace", "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("name") == "recoveries":
                actions.add(rec["labels"]["action"])
            elif rec.get("name") == "re_entity_shards":
                shards.add(rec["value"])
    assert {"retried", "recovered"} <= actions
    assert shards == {2}
