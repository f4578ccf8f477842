"""PyTorch port vs the JAX package: TRON and OWL-QN in both GAME coordinates.

Two configurations of the BASELINE families the port's L-BFGS slice could
not run, on a small MovieLens-shaped GLMix (the recipe of
``bench.py:581``: 2,000 rows, 30 users, 40 movies, 8 global features; the
0/1 responses are valid for both tasks):

- ``linear_tron``: LINEAR_REGRESSION, TRON + L2 in both coordinates;
- ``poisson_enet``: POISSON_REGRESSION, L-BFGS + elastic net (alpha 0.5),
  so OWL-QN with the L2 half in the smooth objective.

- ``RandomEffectOptimizationProblem.run`` in f64 blocks, plain and in four
  buckets: coefficients to rtol 1e-9, iteration counts, convergence codes
  and (OWL-QN) the exact-zero pattern equal.
- The GLMix slice, two sweeps in f32 (the JAX side inside
  ``jax.enable_x64(False)``; ``tests/test_torch_game.py`` says why):
  objectives to rel 1e-5 per update, the coordinate order equal; with
  passive rows a per-user update can raise the sweep-end objective, in
  both packages alike: the linear TRON slice here, and the Poisson
  elastic-net run of both training drivers on ``chip_smoke.py`` phase 6's
  recipe cut to 8,000 rows, where the sweep end rises by over 0.5% in
  both and the two drivers' objectives agree to rel 1e-3 per update.
- A TRON run killed by ``cd.update@1.1`` and resumed from its newest
  snapshot ends ``array_equal`` to the uninterrupted run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.cli.game_training_driver import main as jax_train_main
from photon_ml_tpu.game import coordinate as jco
from photon_ml_tpu.game import coordinate_descent as jcd
from photon_ml_tpu.game import dataset as jds
from photon_ml_tpu.game import random_effect as jre
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.optimize.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.game import coordinate as tco
from photon_ml_tpu_torch.game import coordinate_descent as tcd
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem as TProblem
from photon_ml_tpu_torch.tools.crash_resume_drill import (
    driver_argv,
    write_movielens_avro,
)
from photon_ml_tpu_torch.tools.glmix_cases import GLMIX_CASES, SECOND_ORDER_CASES
from photon_ml_tpu_torch.utils import checkpoint as tck
from photon_ml_tpu_torch.utils import faults as tfaults

torch.set_num_threads(1)
N, USERS, MOVIES, D_GLOBAL = 2000, 30, 40, 8
RE_CONFIG = dict(random_effect_type="userId", feature_shard_id="per_user",
                 num_active_data_points_upper_bound=64,
                 num_features_to_keep_upper_bound=24)
# task, fixed-effect and per-user configurations
CASES = {case: (GLMIX_CASES[case].task, GLMIX_CASES[case].fixed,
                GLMIX_CASES[case].per_user) for case in SECOND_ORDER_CASES}


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    tfaults.disarm_all()
    yield
    tfaults.disarm_all()


def _game_dataset(mod, seed=5):
    rng = np.random.default_rng(seed)
    users = (rng.zipf(1.3, size=N) % USERS).astype(np.int64)
    movies = rng.integers(0, MOVIES, N)
    Xg = (rng.normal(size=(N, D_GLOBAL)) / np.sqrt(D_GLOBAL)).astype(
        np.float32)
    wg = rng.normal(size=D_GLOBAL).astype(np.float32)
    logits = Xg @ wg + 0.5 * rng.normal(size=USERS)[users].astype(np.float32)
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    data = mod.GameDataset(responses=y, feature_shards={
        "global": sp.csr_matrix(Xg),
        "per_user": sp.csr_matrix((np.ones(N, np.float32),
                                   (np.arange(N), movies)),
                                  shape=(N, MOVIES))})
    data.encode_ids("userId", users)
    return data


def _cfg(mod, config):
    return mod.GLMOptimizationConfiguration.parse(config)


@pytest.fixture(scope="module")
def data():
    jdata, tdata = _game_dataset(jds), _game_dataset(tds)
    return dict(
        jdata=jdata, tdata=tdata,
        jfe=jds.build_fixed_effect_dataset(jdata, "global"),
        tfe=tds.build_fixed_effect_dataset(tdata, "global", device="cpu"),
        jre=jds.build_random_effect_dataset(
            jdata, jds.RandomEffectDataConfiguration(**RE_CONFIG),
            num_buckets=4),
        tre=tds.build_random_effect_dataset(
            tdata, tds.RandomEffectDataConfiguration(**RE_CONFIG),
            num_buckets=4, device="cpu"))


def _coords(side, data, case):
    task, fixed, per_user = CASES[case]
    if side == "torch":
        t = tcfg.TaskType[task]
        return {"fixed": tco.FixedEffectCoordinate(
                    dataset=data["tfe"],
                    problem=TProblem(config=_cfg(tcfg, fixed), task=t)),
                "per-user": tco.RandomEffectCoordinate(
                    dataset=data["tre"],
                    problem=tre.RandomEffectOptimizationProblem(
                        config=_cfg(tcfg, per_user), task=t))}
    t = jcfg.TaskType[task]
    return {"fixed": jco.FixedEffectCoordinate(
                dataset=data["jfe"],
                problem=JProblem(config=_cfg(jcfg, fixed), task=t)),
            "per-user": jco.RandomEffectCoordinate(
                dataset=data["jre"],
                problem=jre.RandomEffectOptimizationProblem(
                    config=_cfg(jcfg, per_user), task=t))}


def _port(data, case, sweeps, **kw):
    d = data["tdata"]
    return tcd.run_coordinate_descent(
        _coords("torch", data, case), sweeps,
        tcfg.TaskType[CASES[case][0]], d.responses, d.weights, d.offsets,
        device="cpu", **kw)


def _jax(data, case, sweeps):
    d = data["jdata"]
    with jax.enable_x64(False):
        return jcd.run_coordinate_descent(
            _coords("jax", data, case), sweeps,
            jcfg.TaskType[CASES[case][0]],
            jnp.asarray(d.responses, jnp.float32),
            jnp.asarray(d.weights, jnp.float32),
            jnp.asarray(d.offsets, jnp.float32),
            initial_states={"fixed": jnp.zeros(D_GLOBAL, jnp.float32),
                            "per-user": jnp.zeros(
                                (data["jre"].num_entities,
                                 data["jre"].reduced_dim), jnp.float32)},
            pipeline_depth=0)


def _final_states(res):
    m = res.model.models
    out = {"fixed": m["fixed"].model.coefficients.means,
           "per-user": m["per-user"].coefficients_projected}
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


@pytest.mark.parametrize("num_buckets", [1, 4], ids=["plain", "bucketed"])
@pytest.mark.parametrize("case", list(CASES))
def test_random_effect_problem_matches_jax(data, case, num_buckets):
    """f64 blocks on both sides; offsets from a fixed-effect score so the
    per-user solves start away from the optimum."""
    task, _, per_user = CASES[case]
    j = jds.build_random_effect_dataset(
        data["jdata"], jds.RandomEffectDataConfiguration(**RE_CONFIG),
        num_buckets=num_buckets, dtype=jnp.float64)
    t = tds.build_random_effect_dataset(
        data["tdata"], tds.RandomEffectDataConfiguration(**RE_CONFIG),
        num_buckets=num_buckets, dtype=torch.float64, device="cpu")
    assert (t.buckets is None) == (num_buckets == 1)
    scores = np.random.default_rng(3).normal(size=N) * 0.3
    jout = jre.RandomEffectOptimizationProblem(
        config=_cfg(jcfg, per_user), task=jcfg.TaskType[task]).run(
            j, j.offsets_with(jnp.asarray(scores)))
    tout = tre.RandomEffectOptimizationProblem(
        config=_cfg(tcfg, per_user), task=tcfg.TaskType[task]).run(
            t, t.offsets_with(torch.tensor(scores)))
    jc, jit, jv, jk = (np.asarray(a) for a in jout)
    tc, tit, tv, tk = (a.numpy() for a in tout)
    assert tc.dtype == np.float64
    np.testing.assert_array_equal(tit, jit)
    np.testing.assert_array_equal(tk, jk)
    assert jit.max() >= 2
    np.testing.assert_allclose(tc, jc, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tv, jv, rtol=1e-9)
    np.testing.assert_array_equal(tc == 0.0, jc == 0.0)


@pytest.fixture(scope="module")
def slice_runs(data):
    """Two sweeps of each case through both packages."""
    return {case: (_port(data, case, 2), _jax(data, case, 2))
            for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_glmix_slice_matches_jax(data, slice_runs, case):
    res, jres = slice_runs[case]
    assert [(s.iteration, s.coordinate_id) for s in res.states] == \
        [(s.iteration, s.coordinate_id) for s in jres.states]
    got = [s.objective for s in res.states]
    want = [s.objective for s in jres.states]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the epilogue reads the new penalty: the objective carries it
    fixed = res.model.models["fixed"].model.coefficients.means
    pen = _coords("torch", data, case)["fixed"].problem \
        .regularization_value(fixed)
    assert pen > 0.0


def test_capped_per_user_update_can_raise_the_sweep_end_objective(
        data, slice_runs):
    """With the per-user cap binding (passive rows), a per-user update
    does not see every row of its user and may raise the total
    objective: in both packages the linear TRON run ends sweep 2 above
    sweep 1, while no fixed-effect update (it sees every row) raises it.
    chip_smoke.py's driver phase checks the fixed-effect updates only."""
    assert data["tre"].num_passive > 0
    for res in slice_runs["linear_tron"]:
        objs = [s.objective for s in res.states]
        ends = [objs[1], objs[3]]
        assert ends[1] > ends[0]
        for i, s in enumerate(res.states):
            if i and s.coordinate_id == "fixed":
                assert objs[i] <= objs[i - 1]


def test_capped_per_user_update_raises_the_poisson_sweep_end_in_both_drivers(
        tmp_path):
    """The Poisson elastic-net argv of ``chip_smoke.py`` phase 8 (c) on
    phase 6's recipe (6,040 users, 3,706 movies, 64 global features, the
    per-user cap of 128) cut to 8,000 training rows: each per-user update
    raises the objective through its user's passive rows, and the sweep
    end rises by over 0.5%, in the JAX driver and in the port's alike; no
    fixed-effect update raises it.

    The objectives agree to rel 1e-3, not 1e-5: at the per-user tolerance
    of 1e-7, under f32's resolution of the objective, the iteration at
    which an entity stops follows the rounding of its sums (the port on one
    CPU thread and on two moves the sweep-2 objective by 4e-4 relative,
    with one more entity at its iteration limit). The rise asked of each
    side, 0.5%, is over twice what the tolerance allows two objectives to
    differ by."""
    train, val = str(tmp_path / "t.avro"), str(tmp_path / "v.avro")
    write_movielens_avro(train, val, 8_000, 2_000, 6040, 3706, 64)
    objs = {}
    for side in ("jax", "torch"):
        out = str(tmp_path / side)
        argv = driver_argv(train, val, out, "cpu",
                           extra=GLMIX_CASES["poisson_enet"].argv())
        if side == "jax":
            i = argv.index("--device")
            with jax.enable_x64(False):
                jax_train_main(argv[:i] + argv[i + 2:])
        else:
            ttd.run(argv)
        (grid,) = json.load(open(os.path.join(out, "metrics.json")))["grid"]
        objs[side] = [s["objective"] for s in grid["states"]]
    for o in objs.values():
        assert all(np.isfinite(o)) and len(o) == 4
        assert o[1] > o[0] and o[3] > o[2]  # the per-user updates
        assert o[2] <= o[1]  # the fixed-effect update of sweep 2
        assert o[3] - o[1] > 5e-3 * o[1]  # the sweep end
    np.testing.assert_allclose(objs["torch"], objs["jax"], rtol=1e-3)


def test_tron_resume_after_a_kill_is_bit_exact(data, tmp_path):
    case = "linear_tron"
    uninterrupted = _port(data, case, 2)
    mgr = tck.CheckpointManager(str(tmp_path))
    tfaults.arm("cd.update", "raise", tag="1.1")
    with pytest.raises(tfaults.InjectedFault):
        _port(data, case, 2, checkpoint_manager=mgr,
              checkpoint_every_coordinates=1)
    tfaults.disarm_all()
    snap = mgr.restore()
    assert (snap["sweep"], snap["coordinate_index"]) == (1, 1)
    res = _port(data, case, 2, checkpoint_manager=mgr,
                checkpoint_every_coordinates=1, resume_snapshot=snap)
    assert [(s.iteration, s.coordinate_id) for s in res.states] == \
        [(1, "per-user")]
    assert res.states[0].objective == uninterrupted.states[-1].objective
    want = _final_states(uninterrupted)
    for cid, got in _final_states(res).items():
        assert np.array_equal(got, want[cid]), cid
