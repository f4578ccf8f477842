"""PyTorch port vs the JAX package: multi-process runs over
``torch.distributed`` (gloo), on the CPU at small sizes.

- ``allgather_ragged``, ``allgather_strings`` and ``allgather_csr`` return
  what the JAX helpers return for the same per-process inputs, array for
  array (strings with NULs and non-ASCII intact).
- The data-sharded fit over 2 processes x 2 CPU shards equals the one
  over 1 process x 4 shards bit for bit (plain and with the sharded
  weight update), and the witness's ``PARITY_OK`` holds.
- The streamed builder's ``entity_shard`` slices, stacked, equal the
  unsharded build; ``(0, 1)`` is the unsharded build array for array.
- The port's 2-process training CLI agrees with the JAX package's
  2-process CLI on the same split part files, with a plain per-user
  coordinate and with a factored one: coefficients within
  ``rtol=atol=5e-3`` (the JAX test's bound against one process,
  ``tests/test_multihost.py:251-258``; measured here ~4e-4 fixed and
  ~1e-3 per user) and the objective within 1e-4 relative (measured
  ~2e-5); both members write the same npz.
- A supervised gang whose member is killed at the top of sweep 1
  re-forms, resumes from process 0's snapshot and ends on the
  uninterrupted gang's npz bit for bit; one member's SIGTERM stops both
  with exit 75 at one coordinate; a member that dies after formation
  makes the survivor fail within ``--heartbeat-timeout``.
- The configuration refusals carry the JAX driver's messages, and the
  scoring driver's process split writes the single run's scores.

Ports are picked as ``tests/test_multihost.py`` picks them; every
``communicate`` has a timeout.
"""

import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from test_multihost import _free_port, _game_cli_args, _write_game_part

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

#: one process of a gang exchanging host data: ``python -c`` with
#: ``<jax|torch> <process id> <port> <out.pkl> [<witness port>]``
_EXCHANGE = r'''
import os, pickle, sys
import numpy as np
import scipy.sparse as sp
pkg, pid, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
rng = np.random.default_rng(100 + pid)
n = (5, 3)[pid]
strings = np.asarray([f"p{pid}-é-{i}" for i in range(n)] + ["nul\x00in", ""],
                     dtype=object)
csr = sp.random(n + 2, 6, density=0.4, random_state=pid, format="csr")
inputs = {"f32": rng.normal(size=(n, 3)).astype(np.float32),
          "i64": np.arange(n, dtype=np.int64) * (pid + 1),
          "empty": np.zeros(0, np.float64)}
if pkg == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from photon_ml_tpu.parallel import multihost as mh
    jax.distributed.initialize(f"127.0.0.1:{port}", 2, pid)
    shutdown = jax.distributed.shutdown
else:
    from photon_ml_tpu_torch.parallel import multihost as mh
    mh._distributed_initialize(f"127.0.0.1:{port}", 2, pid)
    shutdown = mh._distributed_shutdown
res = {k: mh.allgather_ragged(v) for k, v in inputs.items()}
res["strings"] = mh.allgather_strings(strings)
res["csr"] = [(m.indptr, m.indices, m.data, m.shape)
              for m in mh.allgather_csr(csr)]
shutdown()
if pkg == "torch":
    import torch
    from photon_ml_tpu_torch.parallel.distributed import run_glm_shard_map
    from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
    from photon_ml_tpu_torch.data.batch import DenseBatch
    import dataclasses
    torch.set_num_threads(1)
    res["witness"] = mh.run_worker(pid, 2, f"127.0.0.1:{sys.argv[5]}",
                                   device="cpu", local_shards=2)
    span = mh._distributed_initialize(f"127.0.0.1:{sys.argv[6]}", 2, pid)
    X, y = mh._synthetic(512, 16, 11)
    sl = slice(pid * 256, (pid + 1) * 256)
    b = DenseBatch(X=torch.as_tensor(X[sl]), labels=torch.as_tensor(y[sl]),
                   offsets=torch.zeros(256), weights=torch.ones(256))
    prob = dataclasses.replace(mh.witness_problem(), shard_weight_update=True)
    mesh = make_mesh(num_data=2, devices=["cpu"] * 2, span=span,
                     span_axis=DATA_AXIS)
    m, r = run_glm_shard_map(prob, b, mesh)
    res["sharded_update"] = (m.coefficients.means.numpy(), float(r.value))
    mh._distributed_shutdown()
with open(out, "wb") as fh:
    pickle.dump(res, fh)
'''


def _env(n_devices: int = 1) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_ENABLE_X64", None)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    flags.append(f"--xla_force_host_platform_device_count={n_devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    return env


def _gang(argvs, env=None, timeout=240, envs=None):
    """Start one process per argv (from the repo root) and wait for all;
    returns ``[(rc, stdout, stderr)]``. Nothing outlives the call."""
    procs = [subprocess.Popen(
        argv, cwd=_REPO, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        env=(envs[i] if envs is not None else env or _env()))
        for i, argv in enumerate(argvs)]
    return _collect(procs, timeout)


def _collect(procs, timeout):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_allgathers_and_the_witness_equal_jax_and_one_process(tmp_path):
    jport, tport, wport, sport = (_free_port() for _ in range(4))
    argv = [sys.executable, "-c", _EXCHANGE]
    outs = _gang(
        [argv + ["jax", str(i), str(jport), str(tmp_path / f"j{i}.pkl")]
         for i in range(2)]
        + [argv + ["torch", str(i), str(tport), str(tmp_path / f"t{i}.pkl"),
                   str(wport), str(sport)] for i in range(2)])
    for rc, out, err in outs:
        assert rc == 0, err
    assert "PARITY_OK process=0 devices=4" in outs[2][1]
    assert "PARITY_OK process=1 devices=4" in outs[3][1]
    res = {}
    for k in ("j0", "j1", "t0", "t1"):
        with open(tmp_path / f"{k}.pkl", "rb") as fh:
            res[k] = pickle.load(fh)
    for p in ("0", "1"):
        want, got = res["j" + p], res["t" + p]
        for key in ("f32", "i64", "empty", "strings"):
            assert len(got[key]) == len(want[key]) == 2, key
            for g, w in zip(got[key], want[key]):
                assert g.dtype == w.dtype and g.shape == w.shape, key
                np.testing.assert_array_equal(g, w)
        assert list(got["strings"][1][-2:]) == ["nul\x00in", ""]
        for g, w in zip(got["csr"], want["csr"]):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)

    # 2 processes x 2 shards == 1 process x 4 shards, bit for bit
    import dataclasses

    from photon_ml_tpu_torch.data.batch import DenseBatch
    from photon_ml_tpu_torch.parallel import multihost as mh
    from photon_ml_tpu_torch.parallel.distributed import run_glm_shard_map
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    X, y = mh._synthetic(512, 16, 11)
    batch = DenseBatch(X=torch.as_tensor(X), labels=torch.as_tensor(y),
                       offsets=torch.zeros(512), weights=torch.ones(512))
    mesh = make_mesh(num_data=4, devices=["cpu"] * 4)
    for key, problem in (
            ("witness", mh.witness_problem()),
            ("sharded_update", dataclasses.replace(
                mh.witness_problem(), shard_weight_update=True))):
        model, result = run_glm_shard_map(problem, batch, mesh)
        w = model.coefficients.means.numpy()
        for p in ("t0", "t1"):
            got = res[p][key]
            if key == "witness":
                got = (got["coefficients"], got["objective"])
            np.testing.assert_array_equal(got[0], w)
            assert got[1] == float(result.value)


def _re_game_dataset(n=600, users=37, seed=3):
    from photon_ml_tpu_torch.game.dataset import GameDataset

    rng = np.random.default_rng(seed)
    mat = sp.random(n, 12, density=0.5, random_state=seed, format="csr",
                    dtype=np.float64)
    data = GameDataset(responses=(rng.uniform(size=n) < 0.5).astype(float),
                       feature_shards={"u": mat},
                       offsets=rng.normal(size=n),
                       weights=rng.uniform(0.5, 2.0, size=n))
    data.encode_ids("userId", rng.integers(0, users, n).astype(str))
    return data


@pytest.mark.parametrize("keep_host", [False, True])
def test_streamed_entity_shard_slices_stack_to_the_whole(keep_host):
    from photon_ml_tpu_torch.game.dataset import (
        RandomEffectDataConfiguration,
        build_random_effect_dataset_streamed,
        dataset_row_stream,
    )

    data = _re_game_dataset()
    cfg = RandomEffectDataConfiguration(
        "userId", "u", num_active_data_points_upper_bound=12)

    def build(**kw):
        return build_random_effect_dataset_streamed(
            dataset_row_stream(data, cfg, chunk_rows=250), cfg, raw_dim=12,
            num_buckets=2, entity_axis_size=4, device="cpu", **kw)

    def host(a):
        return np.asarray(a) if not torch.is_tensor(a) else a.numpy()

    whole = build()
    same = build(entity_shard=(0, 1), keep_host_blocks=keep_host)
    slices = [build(entity_shard=(k, 2), keep_host_blocks=keep_host)
              for k in range(2)]
    fields = ("X", "labels", "base_offsets", "weights", "row_ids")
    for b, bw in enumerate(whole.buckets):
        for f in fields:
            np.testing.assert_array_equal(host(getattr(same.buckets[b], f)),
                                          host(getattr(bw, f)))
            stacked = np.concatenate([host(getattr(s.buckets[b], f))
                                      for s in slices])
            np.testing.assert_array_equal(stacked, host(getattr(bw, f)))
        e_loc = host(bw.X).shape[0] // 2
        assert [s.buckets[b].local_entity_offset for s in slices] == [
            0, e_loc]
        if keep_host:
            assert isinstance(slices[0].buckets[b].X, np.ndarray)
            assert isinstance(slices[0].buckets[b].labels, np.ndarray)
    for s in slices:
        assert s.entity_shard[1] == 2
        np.testing.assert_array_equal(s.entity_codes, whole.entity_codes)
        for f in ("passive_X", "passive_entity", "passive_row_ids",
                  "passive_offsets"):
            np.testing.assert_array_equal(host(getattr(s, f)),
                                          host(getattr(whole, f)))
    with pytest.raises(ValueError, match="divisible"):
        build(entity_shard=(0, 3))


@pytest.fixture(scope="module")
def gang_fixture(tmp_path_factory):
    """Two split part files and their feature sets, the JAX package's
    2-process CLI run once, and the port's 2-process CLI run once."""
    from photon_ml_tpu.io.data_format import NameAndTermFeatureSets

    root = tmp_path_factory.mktemp("torch_mh")
    data = root / "data"
    data.mkdir()
    _write_game_part(str(data / "part-00000.avro"), n=180, n_users=6,
                     d_g=5, d_u=3, seed=10)
    _write_game_part(str(data / "part-00001.avro"), n=140, n_users=6,
                     d_g=5, d_u=3, seed=11)
    fs = root / "fs"
    NameAndTermFeatureSets.from_paths(
        [str(data)], ["globalFeatures", "userFeatures"]).save(str(fs))

    def gang(pkg, out, extra=(), env=None):
        port = _free_port()
        return _gang([[sys.executable, "-m", f"{pkg}.cli.game_training_driver",
                       *_game_cli_args(str(data), str(out), str(fs)),
                       *extra, "--num-processes", "2", "--process-id", str(i),
                       "--coordinator", f"127.0.0.1:{port}"]
                      for i in range(2)], env=env)

    jax_outs = gang("photon_ml_tpu", root / "jax")
    torch_outs = gang("photon_ml_tpu_torch", root / "torch",
                      ["--device", "cpu"])
    return dict(root=root, data=str(data), fs=str(fs), gang=gang,
                jax=jax_outs, torch=torch_outs)


def _npz(out, i):
    return dict(np.load(os.path.join(out, f"multihost_result.p{i}.npz"),
                        allow_pickle=False))


def test_two_process_cli_agrees_with_the_jax_cli(gang_fixture):
    root = gang_fixture["root"]
    for side in ("jax", "torch"):
        for i, (rc, out, err) in enumerate(gang_fixture[side]):
            assert rc == 0, f"{side} {i}: {err}"
            assert (f"MULTIHOST_GAME_OK process={i} of=2 devices=2 "
                    f"re_entity_axis=2 re_coordinates=u rows=320") in out
    got = [_npz(root / "torch", i) for i in range(2)]
    want = _npz(root / "jax", 0)
    assert sorted(got[0]) == sorted(want)
    for key in got[0]:
        np.testing.assert_array_equal(got[0][key], got[1][key])
    np.testing.assert_array_equal(got[0]["re_ids__u"], want["re_ids__u"])
    np.testing.assert_array_equal(got[0]["re_coordinate_ids"],
                                  want["re_coordinate_ids"])
    for key in ("fixed", "re_coefs__u"):
        assert got[0][key].dtype == want[key].dtype == np.float32
        np.testing.assert_allclose(got[0][key], want[key], rtol=5e-3,
                                   atol=5e-3)
    np.testing.assert_allclose(float(got[0]["objective"]),
                               float(want["objective"]), rtol=1e-4)


def test_factored_gang_agrees_with_the_jax_gang(gang_fixture, tmp_path):
    """A factored per-user coordinate over the gang (one sweep, one inner
    alternation, as ``tests/test_multihost.py`` holds it): the per-entity
    solves over each member's slice, the refit over the gang's data axis;
    the JAX gang's npz within the same bounds."""
    factored = ["--num-iterations", "1",
                "--factored-random-effect-optimization-configurations",
                "u:50,1e-9,0.5,1.0,LBFGS,L2:50,1e-9,0.1,1.0,LBFGS,L2:1,2"]
    outs = {side: gang_fixture["gang"](
        pkg, tmp_path / side,
        factored + (["--device", "cpu"] if side == "torch" else []))
        for side, pkg in (("jax", "photon_ml_tpu"),
                          ("torch", "photon_ml_tpu_torch"))}
    for side, res in outs.items():
        for i, (rc, out, err) in enumerate(res):
            assert rc == 0, f"{side} {i}: {err}"
            assert f"MULTIHOST_GAME_OK process={i}" in out
    got = [_npz(tmp_path / "torch", i) for i in range(2)]
    want = _npz(tmp_path / "jax", 0)
    for key in got[0]:
        np.testing.assert_array_equal(got[0][key], got[1][key])
    np.testing.assert_array_equal(got[0]["re_ids__u"], want["re_ids__u"])
    for key in ("fixed", "re_coefs__u"):
        np.testing.assert_allclose(got[0][key], want[key], rtol=5e-3,
                                   atol=5e-3)
    np.testing.assert_allclose(float(got[0]["objective"]),
                               float(want["objective"]), rtol=1e-4)


def test_supervised_gang_resumes_bit_for_bit(gang_fixture, tmp_path):
    out = tmp_path / "sup"
    env = _env()
    env["PHOTON_FAULTS"] = "cd.sweep@1=kill:1:23"
    env["PHOTON_FAULTS_STATE_DIR"] = str(tmp_path / "fault_state")
    outs = gang_fixture["gang"](
        "photon_ml_tpu_torch", out,
        ["--device", "cpu", "--max-worker-restarts", "1",
         "--worker-backoff-base", "0.2", "--heartbeat-timeout", "20",
         "--checkpoint-dir", str(tmp_path / "ckpt"),
         "--checkpoint-every-coordinates", "1"], env=env)
    for i, (rc, so, err) in enumerate(outs):
        assert rc == 0, err
        assert f"MULTIHOST_GAME_OK process={i}" in so
        assert f"SUPERVISOR_OK worker=p{i} restarts=1" in so, so
    assert "MULTIHOST_RESUME sweep=1 coordinate=0" in outs[0][1]
    ref = _npz(gang_fixture["root"] / "torch", 0)
    for i in range(2):
        got = _npz(out, i)
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])


def test_one_members_sigterm_stops_the_gang_with_75(gang_fixture, tmp_path):
    port = _free_port()
    out = tmp_path / "stop"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.game_training_driver",
         *_game_cli_args(gang_fixture["data"], str(out), gang_fixture["fs"],
                         num_iterations=50),
         "--device", "cpu", "--num-processes", "2", "--process-id", str(i),
         "--coordinator", f"127.0.0.1:{port}"],
        cwd=_REPO, env=_env(), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for i in range(2)]
    log = out / "game-training.p1.log"
    deadline = time.time() + 120
    while time.time() < deadline and not (
            log.exists() and "part file(s)" in log.read_text()):
        time.sleep(0.05)
    procs[1].send_signal(signal.SIGTERM)
    outs = _collect(procs, 240)
    steps = set()
    for rc, so, err in outs:
        assert rc == 75, err
        assert "MULTIHOST_GAME_OK" not in so
        (line,) = [x for x in err.splitlines()
                   if x.startswith("PHOTON_PREEMPTED")]
        steps.add(line.split()[1])
    assert len(steps) == 1, steps
    assert "gang:peer_stop" in outs[0][2]


def test_dead_peer_fails_the_survivor_within_the_heartbeat(gang_fixture,
                                                           tmp_path):
    env = _env()
    env["PHOTON_MH_TEST_EXIT_AFTER_INIT"] = "1"
    t0 = time.time()
    outs = gang_fixture["gang"](
        "photon_ml_tpu_torch", tmp_path / "dead",
        ["--device", "cpu", "--heartbeat-timeout", "10"], env=env)
    elapsed = time.time() - t0
    assert outs[1][0] == 17, outs[1][2]
    assert outs[0][0] not in (0, None), outs[0][1]
    assert "MULTIHOST_GAME_OK" not in outs[0][1]
    assert elapsed < 10 + 40, elapsed


REFUSED = [
    [],
    ["--coordinator", "h:1"],
    ["--coordinator", "h:1", "--feature-name-and-term-set-path", "fs",
     "--model-output-mode", "ALL", "--validate-input-dirs", "v",
     "--evaluator-type", "AUC", "--recovery-policy", "skip",
     "--re-lane-compaction-chunk", "auto", "--re-entity-shards", "2",
     "--cd-block-size", "2", "--cd-pipeline-depth", "1",
     "--max-shard-loss-frac", "0.5"],
    ["--coordinator", "h:1", "--offheap-indexmap-dir", "idx",
     "--model-output-mode", "BEST"],
]


@pytest.mark.parametrize("extra", REFUSED, ids=range(len(REFUSED)))
def test_config_refusals_carry_the_jax_messages(extra, tmp_path):
    from photon_ml_tpu.cli import game_training_driver as jtd
    from photon_ml_tpu_torch.cli import game_training_driver as ttd

    argv = ["--train-input-dirs", "t", "--output-dir", str(tmp_path / "o"),
            "--task-type", "LOGISTIC_REGRESSION",
            "--feature-shard-id-to-feature-section-keys-map",
            "global:globalFeatures", "--updating-sequence", "g",
            "--num-processes", "2", "--max-worker-restarts", "1", *extra]
    with pytest.raises(ValueError) as want:
        jtd._check_multihost_args(jtd.parse_args(argv))
    with pytest.raises(ValueError) as got:
        ttd.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "o").exists()


def test_scoring_driver_splits_the_part_files(gang_fixture, tmp_path):
    from photon_ml_tpu.cli import game_scoring_driver as jsd
    from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.io.model_io import load_scored_items

    model_out = tmp_path / "model"
    train = _game_cli_args(gang_fixture["data"], str(model_out),
                           gang_fixture["fs"], num_iterations=1)
    train[train.index("--model-output-mode") + 1] = "BEST"
    ttd.run(train + ["--device", "cpu"])
    base = ["--input-data-dirs", gang_fixture["data"],
            "--game-model-input-dir", str(model_out / "best"),
            "--feature-name-and-term-set-path", gang_fixture["fs"],
            "--feature-shard-id-to-feature-section-keys-map",
            "global:globalFeatures|user:userFeatures",
            "--random-effect-id-set", "userId", "--device", "cpu"]
    tsd.run(base + ["--output-dir", str(tmp_path / "one")])
    for i in range(2):
        tsd.run(base + ["--output-dir", str(tmp_path / "two"),
                        "--num-processes", "2", "--process-id", str(i)])
    parts = sorted(os.listdir(tmp_path / "two" / "scores"))
    assert parts == ["part-00000.avro", "part-00001.avro"]
    split = [r for p in parts
             for r in load_scored_items(str(tmp_path / "two" / "scores" / p))]
    whole = load_scored_items(
        str(tmp_path / "one" / "scores" / "part-00000.avro"))
    assert sorted(split, key=lambda r: r["uid"]) == sorted(
        whole, key=lambda r: r["uid"])

    for extra in (["--evaluator-type", "AUC"], ["--process-id", "2"],
                  ["--delete-output-dir-if-exists", "true"]):
        argv = base[:-2] + ["--output-dir", str(tmp_path / "r"),
                            "--num-processes", "2", *extra]
        with pytest.raises(ValueError) as want:
            jsd.GameScoringDriver(jsd.parse_args(argv)).run()
        with pytest.raises(ValueError) as got:
            tsd.run(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value)
