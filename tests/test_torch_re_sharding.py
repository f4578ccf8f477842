"""PyTorch port vs the JAX package: the device mesh's entity-sharded path.

Random-effect blocks split over the mesh's entity axis. The JAX side runs
on the suite's 8 virtual CPU devices (a 2 x 4 data x entity mesh); the
port on a 2 x 4 mesh of one repeated ``cpu`` device, one thread per
shard.

- The builders pad each block's entities to the entity axis and order
  them by the balancer over that many bins: equal to the JAX package's.
- Entity-sharded fits (L-BFGS, OWL-QN, TRON; one block whole and with
  per-shard lane compaction, three buckets compacted) equal the port's
  unsharded fits bit for bit, coefficients, iteration counts, values,
  codes and scores; in f64 they agree with the JAX package's sharded
  fits (one block, one dispatch) to rtol 1e-8 / atol 1e-10 (the
  port-vs-JAX bound of the unsharded random effect,
  ``test_torch_game.py``).
- Without a mesh, ``entity_shards`` > 1 logs the "no default mesh"
  reason once and runs unsharded, bit for bit.
- The per-shard compaction counts its padding; the sharded chunked solve
  takes exactly the host fetches of the unsharded one.
- A ``nan`` fault at ``re.shard_dispatch`` rides the coordinate-descent
  recovery ladder back onto the clean trajectory, bit for bit.
- int8 on the score exchange counts its bytes and stays within the
  quantization bound of the exact score.
- One training-driver run with ``--re-entity-shards auto
  --collective-quant int8`` on 8 devices (the port's device enumeration
  patched to 8 CPU devices) against the JAX driver with the same argv.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.game import dataset as jds
from photon_ml_tpu.game import random_effect as jre
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.parallel import mesh as jmesh
from photon_ml_tpu_torch.game import coordinate as tco
from photon_ml_tpu_torch.game import coordinate_descent as tcd
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.parallel import mesh as tmesh
from photon_ml_tpu_torch.utils import faults as tfaults
from photon_ml_tpu_torch.utils import sync_telemetry
from photon_ml_tpu_torch.utils.events import EventEmitter, RecoveryEvent

torch.set_num_threads(1)
TASK_J = jcfg.TaskType.LOGISTIC_REGRESSION
TASK_T = tcfg.TaskType.LOGISTIC_REGRESSION

#: (name, optimizer, regularization, lambda): the three solver paths
SOLVERS = [
    ("lbfgs", "LBFGS", "L2", 0.5),
    ("owlqn", "LBFGS", "L1", 0.3),
    ("tron", "TRON", "L2", 0.5),
]


@pytest.fixture(autouse=True)
def _clean():
    tfaults.disarm_all()
    tmesh.set_default_mesh(None)
    yield
    tfaults.disarm_all()
    tmesh.set_default_mesh(None)


#: iterations of the random-effect solves (the suite's time budget)
MAX_ITER = 25


def _cfg(mod, opt, reg, lam, max_iter=MAX_ITER):
    return mod.GLMOptimizationConfiguration(
        max_iterations=max_iter, tolerance=1e-9, regularization_weight=lam,
        optimizer_type=mod.OptimizerType[opt],
        regularization_context=mod.RegularizationContext(
            mod.RegularizationType[reg]))


def _re_numpy(n=700, d=5, n_entities=33, seed=0):
    """33 entities never divide 4 shards without the entity padding."""
    rng = np.random.default_rng(seed)
    Xe = rng.normal(size=(n, d))
    users = rng.integers(0, n_entities, size=n)
    W = rng.normal(size=(n_entities, d)) * 2.0
    margin = np.einsum("nd,nd->n", Xe, W[users])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return Xe, users, y


def _game_data(mod, Xe, users, y):
    data = mod.GameDataset(responses=y,
                           feature_shards={"per_user": sp.csr_matrix(Xe)})
    data.encode_ids("userId", users)
    return data


def _re_cfg(mod):
    return mod.RandomEffectDataConfiguration(
        random_effect_type="userId", feature_shard_id="per_user",
        num_partitions=1)


def _tmesh():
    return tmesh.make_mesh(num_data=2, num_entity=4, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def re_data():
    Xe, users, y = _re_numpy()
    tdata = _game_data(tds, Xe, users, y)
    jdata = _game_data(jds, Xe, users, y)
    out = {"n": len(y)}
    for nb in (1, 3):
        out["t", nb] = tds.build_random_effect_dataset(
            tdata, _re_cfg(tds), num_buckets=nb, entity_axis_size=4,
            dtype=torch.float64, device="cpu")
        out["j", nb] = jds.build_random_effect_dataset(
            jdata, _re_cfg(jds), num_buckets=nb, entity_axis_size=4,
            dtype=jnp.float64)
    return out


@pytest.fixture(scope="module")
def jax_sharded_fits(re_data):
    """The JAX package's entity-sharded fits of the one-block dataset on a
    2 x 4 mesh (f64, one dispatch), per solver."""
    out = {}
    mesh = jmesh.make_mesh(num_data=2, num_entity=4)
    jmesh.set_default_mesh(mesh)
    try:
        for name, opt, reg, lam in SOLVERS:
            ds = re_data["j", 1]
            off = ds.offsets_with(np.zeros(re_data["n"]))
            coefs = jre.RandomEffectOptimizationProblem(
                _cfg(jcfg, opt, reg, lam, MAX_ITER), TASK_J,
                entity_shards=4).run(ds, off)[0]
            out[name] = np.asarray(coefs)
    finally:
        jmesh.set_default_mesh(None)
    return out


def _offsets(ds, n):
    return ds.offsets_with(torch.zeros(n, dtype=torch.float64))


def _pair(ds, n, cfg, chunk, **kw):
    """(unsharded, sharded over the 4-way entity axis) fits of ``ds``."""
    off = _offsets(ds, n)
    ref = tre.RandomEffectOptimizationProblem(cfg, TASK_T).run(ds, off)
    tmesh.set_default_mesh(_tmesh())
    out = tre.RandomEffectOptimizationProblem(
        cfg, TASK_T, lane_compaction_chunk=chunk, entity_shards=4,
        **kw).run(ds, off)
    return ref, out


@pytest.mark.parametrize("nb", [1, 3])
def test_builders_pad_and_balance_like_jax(re_data, nb):
    t, j = re_data["t", nb], re_data["j", nb]
    np.testing.assert_array_equal(t.entity_codes, j.entity_codes)
    if nb == 1:
        assert tuple(t.X.shape) == tuple(j.X.shape)
        assert t.X.shape[0] % 4 == 0 and t.X.shape[0] > len(t.entity_codes)
        np.testing.assert_array_equal(t.X.numpy(), np.asarray(j.X))
    else:
        for tb, jb in zip(t.buckets, j.buckets):
            assert tuple(tb.X.shape) == tuple(jb.X.shape)
            assert tb.X.shape[0] % 4 == 0
            np.testing.assert_array_equal(tb.X.numpy(), np.asarray(jb.X))


@pytest.mark.parametrize("chunk,nb", [(0, 1), (6, 1), (6, 3)],
                         ids=["one_block", "one_block_chunked",
                              "three_buckets_chunked"])
@pytest.mark.parametrize("name,opt,reg,lam", SOLVERS,
                         ids=[s[0] for s in SOLVERS])
def test_entity_sharded_fit_is_the_unsharded_fit_bit_for_bit(
        re_data, jax_sharded_fits, name, opt, reg, lam, chunk, nb):
    ds = re_data["t", nb]
    ref, out = _pair(ds, re_data["n"], _cfg(tcfg, opt, reg, lam), chunk)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    s_ref = tre.score_random_effect(ds, ref[0])
    s_out = tre.score_random_effect(ds, out[0], entity_shards=4)
    np.testing.assert_array_equal(s_out.numpy(), s_ref.numpy())
    if nb == 1:
        np.testing.assert_allclose(out[0].numpy(), jax_sharded_fits[name],
                                   rtol=1e-8, atol=1e-10)


def test_no_mesh_falls_back_with_the_reason(re_data, caplog):
    ds = re_data["t", 1]
    off = _offsets(ds, re_data["n"])
    cfg = _cfg(tcfg, "LBFGS", "L2", 0.5)
    ref = tre.RandomEffectOptimizationProblem(cfg, TASK_T).run(ds, off)
    tre._SHARD_FALLBACK_WARNED.clear()
    with caplog.at_level(logging.WARNING,
                         logger="photon_ml_tpu_torch.game.random_effect"):
        out = tre.RandomEffectOptimizationProblem(
            cfg, TASK_T, entity_shards=4).run(ds, off)
        tre.RandomEffectOptimizationProblem(
            cfg, TASK_T, entity_shards=4).run(ds, off)
    np.testing.assert_array_equal(out[0].numpy(), ref[0].numpy())
    msgs = [r.getMessage() for r in caplog.records]
    assert sum("no default mesh" in m for m in msgs) == 1
    # a block that does not divide the axis: the "ragged" reason
    tmesh.set_default_mesh(tmesh.make_mesh(num_data=1, num_entity=8,
                                           devices=["cpu"] * 8))
    assert tre._resolve_entity_shards(4, 36) == (None, 1)
    assert any("does not divide 8 entity shards" in r.getMessage()
               for r in caplog.records)


def test_per_shard_padding_accounting(re_data):
    ds = re_data["t", 1]
    tre.reset_solve_stats()
    _pair(ds, re_data["n"], _cfg(tcfg, "LBFGS", "L2", 0.5), chunk=5)
    st = tre.SOLVE_STATS
    assert st["shard_real_lanes"] > 0
    assert st["shard_padded_lanes"] >= st["shard_real_lanes"]
    assert st["chunks"] >= 2
    assert st["shard_lane_counts"]
    for row in st["shard_lane_counts"]:
        assert len(row) == 4 and all(c >= 0 for c in row)


def test_sharded_chunked_solve_takes_no_new_host_fetches(re_data):
    ds = re_data["t", 1]
    off = _offsets(ds, re_data["n"])
    cfg = _cfg(tcfg, "LBFGS", "L2", 0.5)
    sync_telemetry.reset_host_fetches()
    tre.RandomEffectOptimizationProblem(
        cfg, TASK_T, lane_compaction_chunk=6).run(ds, off)
    base = sync_telemetry.host_fetches_by_site()
    tmesh.set_default_mesh(_tmesh())
    sync_telemetry.reset_host_fetches()
    out = tre.RandomEffectOptimizationProblem(
        cfg, TASK_T, lane_compaction_chunk=6, entity_shards=4).run(ds, off)
    assert np.isfinite(out[0].numpy()).all()
    assert sync_telemetry.host_fetches_by_site() == base
    assert set(base) == {"re.compact_mask"}


def test_int8_score_exchange_counts_its_bytes(re_data):
    from photon_ml_tpu_torch.parallel import quantized_collectives as tq

    ds = re_data["t", 1]
    coefs = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(ds.X.shape[::2])))
    exact = tre.score_random_effect(ds, coefs)
    tmesh.set_default_mesh(_tmesh())
    before = tq.REGISTRY.counter("collective_bytes").by_label("site").get(
        "re.score_psum", 0)
    got = tre.score_random_effect(ds, coefs, entity_shards=4,
                                  collective_quant="int8")
    after = tq.REGISTRY.counter("collective_bytes").by_label("site")[
        "re.score_psum"]
    n = re_data["n"]
    assert after - before == tq.collective_payload_bytes(n, 4, "int8")
    # four int8 partials, each off by at most half a step of its block
    bound = 4 * np.abs(exact.numpy()).max() / 127
    assert 0 < np.abs(got.numpy() - exact.numpy()).max() <= bound


def test_shard_dispatch_fault_point_is_registered():
    info = tfaults.FAULT_POINTS["re.shard_dispatch"]
    assert {"nan", "raise"} <= set(info.modes)


def _game_coords(entity_shards, n=240, d_global=6, d_entity=4,
                 n_entities=24):
    rng = np.random.default_rng(11)
    Xg = rng.normal(size=(n, d_global))
    Xe = rng.normal(size=(n, d_entity))
    users = rng.integers(0, n_entities, size=n)
    wg = rng.normal(size=d_global)
    We = rng.normal(size=(n_entities, d_entity))
    margin = Xg @ wg + np.einsum("nd,nd->n", Xe, We[users])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    data = tds.GameDataset(responses=y,
                           feature_shards={"global": sp.csr_matrix(Xg),
                                           "per_user": sp.csr_matrix(Xe)})
    data.encode_ids("userId", users)
    cfg = _cfg(tcfg, "LBFGS", "L2", 1.0, max_iter=15)
    coords = {
        "fixed": tco.FixedEffectCoordinate(
            dataset=tds.build_fixed_effect_dataset(data, "global",
                                                   device="cpu"),
            problem=GLMOptimizationProblem(config=cfg, task=TASK_T)),
        "perUser": tco.RandomEffectCoordinate(
            dataset=tds.build_random_effect_dataset(
                data, _re_cfg(tds), entity_axis_size=4, device="cpu"),
            problem=tre.RandomEffectOptimizationProblem(
                cfg, TASK_T, entity_shards=entity_shards)),
    }
    return data, coords


def _run_cd(data, coords, **kw):
    f32 = dict(dtype=torch.float32)
    return tcd.run_coordinate_descent(
        coords, 1, TASK_T, torch.as_tensor(data.responses, **f32),
        torch.as_tensor(data.weights, **f32),
        torch.as_tensor(data.offsets, **f32), device="cpu", **kw)


def test_shard_dispatch_fault_rides_the_recovery_ladder():
    data, coords = _game_coords(entity_shards=4)
    tmesh.set_default_mesh(_tmesh())
    ref = _run_cd(data, coords)
    tfaults.arm("re.shard_dispatch", "nan", times=1)
    seen = []
    emitter = EventEmitter()
    emitter.register_listener(seen.append)
    res = _run_cd(data, coords,
                  recovery=tcd.RecoveryPolicy(max_retries=2,
                                              on_exhausted="abort",
                                              damping=1.0),
                  events=emitter)
    assert tfaults.hits("re.shard_dispatch") == 1
    assert np.isfinite([s.objective for s in res.states]).all()
    assert res.states[-1].objective == ref.states[-1].objective
    actions = {e.action for e in seen if isinstance(e, RecoveryEvent)}
    assert {"retried", "recovered"} <= actions


def test_driver_re_entity_shards_auto_against_jax(tmp_path, monkeypatch):
    """``--re-entity-shards auto --collective-quant int8`` on 8 devices in
    both drivers: an 8-way entity axis (8 users: no padding), data axis
    1. The gauge and the manifest say 8, the sharded dispatch ran, and
    the models agree to the JAX package's own driver bound for this run
    (rtol 1e-3 / atol 5e-4: f32 solves stopped below the f32 noise
    floor)."""
    from test_drivers import _make_game_avro

    from photon_ml_tpu.cli.game_training_driver import main as jax_main
    from photon_ml_tpu.io.model_io import load_game_model
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.obs.metrics import REGISTRY

    eight = [torch.device("cpu")] * 8
    monkeypatch.setattr(tmesh, "visible_devices",
                        lambda device="cuda": list(eight))
    monkeypatch.setattr(ttd, "visible_devices",
                        lambda device="cuda": list(eight))
    train = str(tmp_path / "train.avro")
    validate = str(tmp_path / "validate.avro")
    _make_game_avro(train, n=300, seed=0)
    _make_game_avro(validate, n=120, seed=1)
    args = [
        "--train-input-dirs", train, "--validate-input-dirs", validate,
        "--task-type", "LOGISTIC_REGRESSION",
        "--feature-shard-id-to-feature-section-keys-map",
        "global:globalFeatures|user:userFeatures",
        "--updating-sequence", "fixed,perUser", "--num-iterations", "1",
        "--fixed-effect-data-configurations", "fixed:global,1",
        "--fixed-effect-optimization-configurations",
        "fixed:30,1e-7,0.1,1,LBFGS,L2",
        "--random-effect-data-configurations", "perUser:userId,user,1",
        "--random-effect-optimization-configurations",
        "perUser:30,1e-7,1.0,1,LBFGS,L2",
        "--evaluator-type", "AUC",
        "--re-entity-shards", "auto", "--collective-quant", "int8"]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_main(args + ["--output-dir", out_j])
    tre.reset_solve_stats()
    driver = ttd.run(args + ["--output-dir", out_t, "--device", "cpu",
                             "--trace-dir", str(tmp_path / "trace")])
    assert driver.ns.re_entity_shards == 8
    assert REGISTRY.gauge("re_entity_shards").value() == 8
    assert tre.SOLVE_STATS["shard_real_lanes"] > 0
    assert tmesh.get_default_mesh() is None  # put back after the run
    import json

    manifest = json.load(open(tmp_path / "trace" / "run_manifest.json"))
    assert manifest["flags"]["re_entity_shards"] == 8  # granted, not auto

    jmodel, _ = load_game_model(os.path.join(out_j, "best"), task=TASK_J)
    tmodel, _ = load_game_model(os.path.join(out_t, "best"), task=TASK_J)
    jre_m, tre_m = jmodel.models["perUser"], tmodel.models["perUser"]
    np.testing.assert_array_equal(tre_m.entity_codes, jre_m.entity_codes)
    np.testing.assert_allclose(np.asarray(tre_m.coefficients),
                               np.asarray(jre_m.coefficients), rtol=1e-3,
                               atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(tmodel.models["fixed"].model.coefficients.means),
        np.asarray(jmodel.models["fixed"].model.coefficients.means),
        rtol=1e-3, atol=5e-4)
