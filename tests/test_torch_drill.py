"""The port's fault tolerance through its drivers, held against the JAX
drivers.

- The crash/resume drill (``photon_ml_tpu_torch/tools/crash_resume_drill``)
  at a tiny size on the CPU: six driver processes end with exit codes
  0/19/75/0/0/3, and the resumed and relaunched runs end bit-exact to the
  uninterrupted one; the reference role alone through ``run_roles``, then
  the corrupt role on a corrupted copy of its snapshots, end with 0 and
  3 (the roles ``chip_smoke.py`` runs on their own).
- Degraded ingest: four part files, one corrupted, ``--max-shard-loss-frac
  0.3``: both packages' training drivers quarantine the same shard and
  agree per update to rel 1e-4; both scoring drivers score the same rows;
  over the budget both end with exit 3.
- Recovery through ``--recovery-*``: both drivers quarantine the same
  coordinate under the same injected fault.
- Graceful stop through ``--stop-file`` and ``--max-train-seconds``: exit
  75 and one ``PHOTON_PREEMPTED`` line, then the same command finishes
  bit-exact to an uninterrupted run.

The JAX drivers run inside ``jax.enable_x64(False)``, as in
``tests/test_torch_drivers.py``; the port's take ``--device cpu``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.game_scoring_driver import main as jax_score_main
from photon_ml_tpu.cli.game_training_driver import main as jax_train_main
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.utils import faults as jfaults
from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.io.avro import read_container, write_container
from photon_ml_tpu_torch.tools import crash_resume_drill as drill
from photon_ml_tpu_torch.utils import faults as tfaults

torch.set_num_threads(1)
SECTIONS = drill.SECTIONS
TINY = dict(rows=(400, 200), n_users=8, n_movies=10, d_global=6)


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    monkeypatch.delenv("PHOTON_FAULTS_STATE_DIR", raising=False)
    tfaults.disarm_all()
    jfaults.disarm_all()
    yield
    tfaults.disarm_all()
    jfaults.disarm_all()


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixture")
    drill.write_fixture(str(d), **TINY)
    return d


def test_drill_on_the_cpu(fixture_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    record = drill.run_drill(str(fixture_dir), str(tmp_path / "roles"),
                             device="cpu", timeout=300)
    assert {r: v["exit"] for r, v in record["roles"].items()} == \
        drill.EXPECTED_EXIT
    assert record["snapshot_step"] == 2 * drill.SWEEPS
    assert record["states_compared_after_resume"] == {
        "resume": 2 * drill.SWEEPS - 3, "relaunch": 2 * drill.SWEEPS - 2}
    for role in ("reference", "resume", "relaunch"):
        w = record["roles"][role]["worker"]
        assert w["exit"] == 0 and w["snapshot_bytes"] > 0
        assert w["fixed_effect_columns"] == TINY["d_global"] + 1
        # CPU tensors take the plain version: no launch is counted
        assert sum(w["launches_by_path"].values()) == 0
    assert record["roles"]["crash"]["worker"] is None


def test_reference_and_corrupt_roles_alone_on_the_cpu(fixture_dir,
                                                      tmp_path, monkeypatch):
    """The drill's helpers one role at a time: the reference finishes with
    a snapshot of its last update, and a copy of its snapshots with every
    step corrupted is refused with a clean abort (exit 3)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cpu = torch.device("cpu")
    dirs = {r: (str(tmp_path / f"{r}_out"), str(tmp_path / f"{r}_ckpt"))
            for r in ("reference", "corrupt")}
    runs = drill.run_roles({"reference": (drill.role_argv(
        str(fixture_dir), *dirs["reference"], "cpu"), "")}, timeout=300)
    drill.check_launches("reference", runs["reference"], cpu)
    w = runs["reference"]["worker"]
    assert w["exit"] == 0 and w["snapshot_bytes"] > 0
    assert drill._last_snapshot(dirs["reference"][1])["step"] \
        == 2 * drill.SWEEPS
    steps = drill.corrupt_copy(dirs["reference"][1], dirs["corrupt"][1])
    assert steps[-1] == f"step_{2 * drill.SWEEPS:08d}"
    runs = drill.run_roles({"corrupt": (drill.role_argv(
        str(fixture_dir), *dirs["corrupt"], "cpu"), "")}, timeout=300)
    assert runs["corrupt"]["exit"] == drill.EXPECTED_EXIT["corrupt"] == 3
    drill.check_clean_abort(runs["corrupt"])
    assert not os.path.exists(os.path.join(dirs["corrupt"][0],
                                           "metrics.json"))


def _argv(fixture_dir, out, *extra):
    return drill.driver_argv(str(fixture_dir / "train.avro"),
                             str(fixture_dir / "validate.avro"), str(out),
                             "cpu") + list(extra)


def _jax_argv(argv):
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:]


def _states(out):
    (grid,) = json.load(open(os.path.join(out, "metrics.json")))["grid"]
    return grid["states"]


@pytest.mark.parametrize("how", ["stop-file", "max-train-seconds"])
def test_graceful_stop_then_same_command_finishes_bit_exact(
        fixture_dir, tmp_path, capsys, how):
    ref = tmp_path / "ref"
    ttd.run(_argv(fixture_dir, ref))
    out, ckpt, stop = tmp_path / "out", tmp_path / "ckpt", tmp_path / "stop"
    common = ["--checkpoint-dir", str(ckpt)]
    if how == "stop-file":
        stop.touch()
        extra = ["--stop-file", str(stop)]
    else:
        extra = ["--max-train-seconds", "1e-9"]
    with pytest.raises(SystemExit) as e:
        ttd.main(_argv(fixture_dir, out, *common, *extra))
    assert e.value.code == 75
    err = capsys.readouterr().err
    assert "PHOTON_PREEMPTED step=0.0 reason=" in err
    assert "Traceback" not in err
    stop.unlink(missing_ok=True)
    ttd.run(_argv(fixture_dir, out, *common))
    log = open(out / "game-training.log").read()
    assert "resuming from checkpoint at sweep 0 coordinate 0" in log
    assert [s["objective"] for s in _states(out)] == \
        [s["objective"] for s in _states(ref)]


def test_recovery_flags_quarantine_like_jax(fixture_dir, tmp_path):
    flags = ["--recovery-policy", "skip", "--recovery-max-retries", "0",
             "--recovery-quarantine-after", "1"]
    tfaults.arm("cd.update", "raise", tag="0.1")
    jfaults.arm("cd.update", "raise", tag="0.1")
    argv = _argv(fixture_dir, tmp_path / "torch", *flags)
    ttd.run(argv)
    jargv = _jax_argv(_argv(fixture_dir, tmp_path / "jax", *flags))
    with jax.enable_x64(False):
        jax_train_main(jargv)
    rec = {k: json.load(open(tmp_path / k / "metrics.json"))
           for k in ("torch", "jax")}
    assert rec["torch"]["quarantined"] == rec["jax"]["quarantined"] == \
        ["perUser"]
    t, j = _states(tmp_path / "torch"), _states(tmp_path / "jax")
    assert [(s["iteration"], s["coordinate"]) for s in t] == \
        [(s["iteration"], s["coordinate"]) for s in j] == \
        [(0, "fixed"), (1, "fixed")]
    for a, b in zip(t, j):
        assert a["objective"] == pytest.approx(b["objective"], rel=1e-4)


def test_checkpoint_dir_takes_one_grid_point(fixture_dir, tmp_path):
    argv = _argv(fixture_dir, tmp_path / "out", "--checkpoint-dir",
                 str(tmp_path / "ckpt"))
    i = argv.index("--fixed-effect-optimization-configurations")
    argv[i + 1] = "fixed:40,1e-7,10,1,LBFGS,L2;fixed:40,1e-7,1,1,LBFGS,L2"
    with pytest.raises(ValueError, match="single-grid-point"):
        ttd.run(argv)


@pytest.fixture(scope="module")
def parts(fixture_dir, tmp_path_factory):
    """Four part files: the fixture's training rows in parts 0, 2 and 3,
    its validation rows in part 1 (the one the tests corrupt), so that
    the surviving rows are the training set the other tests use."""
    d = tmp_path_factory.mktemp("parts")
    schema, records = read_container(str(fixture_dir / "train.avro"))
    _, extra = read_container(str(fixture_dir / "validate.avro"))
    for i, rows in zip((0, 2, 3), (records[0::3], records[1::3],
                                   records[2::3])):
        write_container(str(d / f"part-{i:05d}.avro"), schema, rows)
    write_container(str(d / "part-00001.avro"), schema, extra)
    return d


def _corrupted_copy(parts, tmp_path, which):
    d = tmp_path / "train"
    d.mkdir()
    for name in sorted(os.listdir(parts)):
        (d / name).write_bytes((parts / name).read_bytes())
    for i in which:
        tfaults.corrupt_path(str(d / f"part-{i:05d}.avro"))
    return d


def test_degraded_ingest_quarantines_the_same_shard(fixture_dir, parts,
                                                    tmp_path):
    train = _corrupted_copy(parts, tmp_path, [1])
    budget = ["--max-shard-loss-frac", "0.3"]

    def argv(out):
        a = _argv(fixture_dir, out, *budget)
        a[a.index("--train-input-dirs") + 1] = str(train)
        return a

    ttd.run(argv(tmp_path / "torch"))
    with jax.enable_x64(False):
        jax_train_main(_jax_argv(argv(tmp_path / "jax")))
    rec = {k: json.load(open(tmp_path / k / "metrics.json"))
           for k in ("torch", "jax")}
    for k in ("torch", "jax"):
        assert rec[k]["data_coverage"] == 0.75
        lost = rec[k]["ingest"]["train"]["shards_quarantined"]
        assert [os.path.basename(q["path"]) for q in lost] == \
            ["part-00001.avro"], k
    t, j = _states(tmp_path / "torch"), _states(tmp_path / "jax")
    assert len(t) == len(j) == 4
    for a, b in zip(t, j):
        assert a["objective"] == pytest.approx(b["objective"], rel=1e-4)

    # both scoring drivers score the three surviving parts
    common = ["--input-data-dirs", str(train),
              "--game-model-input-dir", str(tmp_path / "torch" / "best"),
              "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
              "--random-effect-id-set", "userId", *budget]
    scorer = tsd.run(common + ["--output-dir", str(tmp_path / "st"),
                               "--device", "cpu"])
    with jax.enable_x64(False):
        jax_score_main(common + ["--output-dir", str(tmp_path / "sj")])
    part = os.path.join("scores", "part-00000.avro")
    tu = {r["uid"] for r in tio.load_scored_items(str(tmp_path / "st" /
                                                      part))}
    ju = {r["uid"] for r in jio.load_scored_items(str(tmp_path / "sj" /
                                                      part))}
    assert tu == ju and len(tu) == TINY["rows"][0]
    assert scorer.ingest.coverage_fraction == 0.75


def test_shard_loss_over_budget_ends_both_drivers_with_exit_3(
        fixture_dir, parts, tmp_path, capsys):
    train = _corrupted_copy(parts, tmp_path, [1, 2])

    def argv(out):
        a = _argv(fixture_dir, out, "--max-shard-loss-frac", "0.3")
        a[a.index("--train-input-dirs") + 1] = str(train)
        return a

    with pytest.raises(SystemExit) as e:
        ttd.main(argv(tmp_path / "torch"))
    assert e.value.code == 3
    with jax.enable_x64(False), pytest.raises(SystemExit) as je:
        jax_train_main(_jax_argv(argv(tmp_path / "jax")))
    assert je.value.code == 3
    err = capsys.readouterr().err
    assert err.count("PHOTON_ABORT kind=ShardLossExceededError") == 2
    assert "Traceback" not in err
    # the strict default budget refuses the first lost shard
    (tmp_path / "strict").mkdir()
    one = _corrupted_copy(parts, tmp_path / "strict", [3])
    a = _argv(fixture_dir, tmp_path / "strict_out")
    a[a.index("--train-input-dirs") + 1] = str(one)
    with pytest.raises(SystemExit) as e:
        ttd.main(a)
    assert e.value.code == 3


def test_corrupt_checkpoint_dir_aborts_before_reading_data(fixture_dir,
                                                           tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    ttd.run(_argv(fixture_dir, tmp_path / "out", "--checkpoint-dir",
                  str(ckpt), "--num-iterations", "1"))
    steps = sorted(os.listdir(ckpt))
    assert steps
    for s in steps:
        tfaults.corrupt_path(str(ckpt / s))
    out = tmp_path / "again"
    with pytest.raises(SystemExit) as e:
        ttd.main(_argv(fixture_dir, out, "--checkpoint-dir", str(ckpt)))
    assert e.value.code == 3
    err = capsys.readouterr().err
    assert "PHOTON_ABORT kind=CheckpointCorruptionError" in err
    assert "prepareFeatureMaps" not in open(out /
                                            "game-training.log").read()
