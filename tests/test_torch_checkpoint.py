"""PyTorch port vs the JAX package: the checkpoint format and its fallbacks.

The port's ``utils/checkpoint.py`` writes the JAX package's on-disk
format, so each package restores the other's steps: arrays equal in value
and dtype, scalars, ``None``, nested dicts, lists and tuples as written.
``dumps_state``/``loads_state`` cross the same way. The fallback cases —
torn, corrupt and manifest-less steps, a stale ``.tmp``, retention that
keeps the only restorable step, an all-corrupt directory, the
``ckpt.*`` fault points and a persistently failing write — run on the
port alone.
"""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.utils import checkpoint as jck
from photon_ml_tpu.utils import faults as jfaults
from photon_ml_tpu_torch.utils import checkpoint as tck
from photon_ml_tpu_torch.utils import faults as tfaults

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    monkeypatch.delenv("PHOTON_FAULTS_STATE_DIR", raising=False)
    tfaults.disarm_all()
    jfaults.disarm_all()
    yield
    tfaults.disarm_all()
    jfaults.disarm_all()


def _snapshot(seed=0):
    """A snapshot-shaped structure with every kind of leaf."""
    rng = np.random.default_rng(seed)
    return {
        "sweep": 1, "coordinate_index": 1, "iteration": 1,
        "states": {"fixed": rng.normal(size=65).astype(np.float32),
                   "perUser": rng.normal(size=(7, 5)).astype(np.float32)},
        "scores": {"fixed": rng.normal(size=40).astype(np.float32),
                   "perUser": rng.normal(size=40).astype(np.float32)},
        "best_metric": 0.745433712, "best_states": None,
        "update_counts": {"fixed": 3},
        "consecutive_failures": 0, "coordinate_failures": {"perUser": 2},
        "quarantined": ["perUser"],
        "extra": (np.arange(4, dtype=np.int64), [np.float64(2.5), "s", True],
                  np.zeros((0, 3), np.float32)),
    }


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray) or isinstance(want, np.generic):
        got = np.asarray(got)
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("writer,reader", [(tck, jck), (jck, tck)],
                         ids=["port-writes-jax-reads", "jax-writes-port-reads"])
def test_steps_cross_both_ways(tmp_path, writer, reader):
    snap = _snapshot()
    writer.CheckpointManager(str(tmp_path)).save(3, snap)
    mgr = reader.CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [3] and mgr.latest_valid_step() == 3
    _assert_same(mgr.restore(), snap)
    _assert_same(mgr.restore(3), snap)


def test_manifests_are_the_same(tmp_path):
    snap = _snapshot(1)
    tck.CheckpointManager(str(tmp_path / "t")).save(7, snap)
    jck.CheckpointManager(str(tmp_path / "j")).save(7, snap)
    man = {k: json.load(open(tmp_path / k / "step_00000007" /
                             "manifest.json")) for k in ("t", "j")}
    assert man["t"]["skeleton"] == man["j"]["skeleton"]
    assert {k: v for k, v in man["t"].items() if k != "checksums"} == \
        {k: v for k, v in man["j"].items() if k != "checksums"}
    assert sorted(os.listdir(tmp_path / "t" / "step_00000007")) == \
        sorted(os.listdir(tmp_path / "j" / "step_00000007"))


@pytest.mark.parametrize("dumps,loads", [(tck, jck), (jck, tck)],
                         ids=["port-dumps", "jax-dumps"])
def test_dumps_state_crosses_both_ways(dumps, loads):
    snap = _snapshot(2)
    _assert_same(loads.loads_state(dumps.dumps_state(snap)), snap)


def test_save_refuses_tensor_leaves(tmp_path):
    with pytest.raises(TypeError, match="one batch"):
        tck.CheckpointManager(str(tmp_path)).save(
            0, {"states": {"fixed": torch.zeros(3)}})


def _mgr_with_steps(tmp_path, steps=(1, 2, 3), keep=None):
    mgr = tck.CheckpointManager(str(tmp_path), max_to_keep=keep)
    for s in steps:
        mgr.save(s, {"sweep": s, "x": np.full(100, s, np.float32)})
    return mgr


def _restored_sweep(mgr):
    return mgr.restore()["sweep"]


@pytest.mark.parametrize("damage", ["corrupt", "truncate", "no_manifest"])
def test_restore_falls_back_past_a_damaged_newest_step(tmp_path, damage):
    mgr = _mgr_with_steps(tmp_path)
    newest = mgr._step_dir(3)
    if damage == "corrupt":
        tfaults.corrupt_path(os.path.join(newest, "arrays.npz"))
    elif damage == "truncate":
        tfaults.truncate_path(os.path.join(newest, "arrays.npz"))
    else:
        os.remove(os.path.join(newest, "manifest.json"))
    assert mgr.latest_valid_step() == 2
    assert _restored_sweep(mgr) == 2
    if damage != "no_manifest":
        with pytest.raises(tck.CheckpointCorruptionError):
            mgr.restore(3)


def test_stale_tmp_is_ignored_and_swept(tmp_path):
    mgr = _mgr_with_steps(tmp_path, steps=(1,))
    stale = os.path.join(str(tmp_path), "step_00000002.tmp")
    os.makedirs(stale)
    open(os.path.join(stale, "arrays.npz"), "wb").write(b"half a write")
    assert mgr.all_steps() == [1]
    assert _restored_sweep(mgr) == 1
    assert not os.path.exists(stale)


def test_retention_keeps_the_only_restorable_step(tmp_path):
    mgr = _mgr_with_steps(tmp_path, steps=(1, 2), keep=2)
    for s in (1, 2):
        assert mgr.verify_step(s)
    # the next two saves land torn: published, checksummed, unloadable
    tfaults.arm("ckpt.write_bytes", "partial", times=2)
    for s in (3, 4):
        mgr.save(s, {"sweep": s, "x": np.full(100, s, np.float32)})
    steps = mgr.all_steps()
    assert 3 in steps and 4 in steps and 2 in steps and 1 not in steps
    assert _restored_sweep(mgr) == 2


def test_retention_prunes_to_max_to_keep(tmp_path):
    mgr = _mgr_with_steps(tmp_path, steps=(1, 2, 3, 4, 5), keep=3)
    assert mgr.all_steps() == [3, 4, 5]


def test_all_corrupt_directory_raises(tmp_path):
    mgr = _mgr_with_steps(tmp_path, steps=(1, 2))
    for s in (1, 2):
        tfaults.corrupt_path(mgr._step_dir(s))
    with pytest.raises(tck.CheckpointCorruptionError):
        mgr.raise_if_all_corrupt()
    with pytest.raises(tck.CheckpointCorruptionError):
        mgr.restore()
    empty = tck.CheckpointManager(str(tmp_path / "empty"))
    empty.raise_if_all_corrupt()
    with pytest.raises(FileNotFoundError):
        empty.restore()


def test_restore_fault_point_corrupts_and_falls_back(tmp_path):
    mgr = _mgr_with_steps(tmp_path)
    tfaults.arm("ckpt.restore", "corrupt", times=1)
    assert _restored_sweep(mgr) == 2
    assert tfaults.hits("ckpt.restore") == 1


def test_save_fault_point_raise_leaves_no_step(tmp_path):
    mgr = _mgr_with_steps(tmp_path, steps=(1,))
    tfaults.arm("ckpt.save", "raise")
    with pytest.raises(tfaults.InjectedFault):
        mgr.save(2, {"sweep": 2})
    assert mgr.all_steps() == [1]
    assert _restored_sweep(mgr) == 1  # the stale tmp is swept
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_write_retries_transient_errors_and_reports_persistent(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    tfaults.arm("ckpt.write_bytes", "io_error", times=2)
    mgr.save(1, {"sweep": 1, "x": np.ones(3, np.float32)})
    assert mgr.all_steps() == [1] and mgr.verify_step(1)
    tfaults.arm("ckpt.write_bytes", "enospc", times=99)
    failures = tck.CHECKPOINT_STATS["saves"]
    with pytest.raises(tck.CheckpointWriteError):
        mgr.save(2, {"sweep": 2})
    assert tck.CHECKPOINT_STATS["saves"] == failures
    assert mgr.all_steps() == [1]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_checkpoint_stats_count_saves_and_restores(tmp_path):
    tck.reset_checkpoint_stats()
    mgr = _mgr_with_steps(tmp_path, steps=(1, 2))
    mgr.restore()
    st = tck.CHECKPOINT_STATS
    assert st["saves"] == 2 and st["restores"] == 1
    assert st["bytes"] == os.path.getsize(
        os.path.join(mgr._step_dir(2), "arrays.npz"))
    assert st["save_seconds"] > 0 and st["restore_seconds"] > 0
