"""PyTorch port vs the JAX package: lane compaction with exact carries.

The per-user blocks of a small MovieLens-shaped GLMix (the recipe of
``bench.py:581``: 2,000 rows, 30 users, 40 movies; per-user active cap 64,
feature cap 24), in f64 on both sides, with the per-user configs of
``tools/glmix_cases.GLMIX_CASES`` (L-BFGS + L2, TRON + L2, L-BFGS +
elastic net, so OWL-QN):

- each solver run for ``a`` iterations with ``return_carry`` and resumed
  for ``b`` more equals one run of ``a + b`` bit for bit;
- ``_fit_blocks_impl`` over two chunks (``boundary_convergence``, then
  ``resume``) against the JAX package's: coefficients to rel 1e-10,
  iterations and codes exactly;
- ``RandomEffectOptimizationProblem`` with ``lane_compaction_chunk`` 4
  and auto against the JAX package's compacted solve (coefficients to
  rel 1e-10, iterations and codes exactly) and against the port's single
  dispatch bit for bit, on the plain and the bucketed path;
- a lane that converges on the last iteration of a chunk's budget leaves
  with its real reason (and would have been MaxIterations without
  ``boundary_convergence``), in both packages;
- ``ChunkAutoTuner`` gives the JAX tuner's chunk sequence for the same
  lane counts, ``SOLVE_STATS`` shows the active lanes shrinking, and a
  re-dispatched chunk carries at least 128 lanes x features (pad lanes
  copy a real lane; the per-user blocks here have 24 features, so the
  chunks of 1-5 stragglers above are padded).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.game import dataset as jds
from photon_ml_tpu.game import random_effect as jre
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu_torch.data.batch import DenseBatch
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.common import padded_lane_count
from photon_ml_tpu_torch.optimize.problem import minimize
from photon_ml_tpu_torch.tools.glmix_cases import GLMIX_CASES

torch.set_num_threads(1)
N, USERS, MOVIES, D_GLOBAL = 2000, 30, 40, 8
RE_CONFIG = dict(random_effect_type="userId", feature_shard_id="per_user",
                 num_active_data_points_upper_bound=64,
                 num_features_to_keep_upper_bound=24)
CASES = list(GLMIX_CASES)
SOLVER = {"lbfgs": "lbfgs", "linear_tron": "tron", "poisson_enet": "owlqn"}


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


@pytest.fixture(scope="module")
def blocks():
    """f64 per-user datasets of both packages, plain and in two buckets,
    with offsets from a fixed-effect-like score (solves start away from
    the optimum)."""
    jdata, tdata = _game_dataset(jds), _game_dataset(tds)
    scores = np.random.default_rng(3).normal(size=N) * 0.3
    out = {}
    for nb in (1, 2):
        j = jds.build_random_effect_dataset(
            jdata, jds.RandomEffectDataConfiguration(**RE_CONFIG),
            num_buckets=nb, dtype=jnp.float64)
        t = tds.build_random_effect_dataset(
            tdata, tds.RandomEffectDataConfiguration(**RE_CONFIG),
            num_buckets=nb, dtype=torch.float64, device="cpu")
        out[nb] = (j, j.offsets_with(jnp.asarray(scores)), t,
                   t.offsets_with(torch.tensor(scores)))
    return out


def _problems(case, chunk=0):
    g = GLMIX_CASES[case]
    return (jre.RandomEffectOptimizationProblem(
                config=jcfg.GLMOptimizationConfiguration.parse(g.per_user),
                task=jcfg.TaskType[g.task], lane_compaction_chunk=chunk),
            tre.RandomEffectOptimizationProblem(
                config=tcfg.GLMOptimizationConfiguration.parse(g.per_user),
                task=tcfg.TaskType[g.task], lane_compaction_chunk=chunk))


def _port_args(case, blocks):
    """The plain block's solver inputs on the port's side."""
    _, _, t, toff = blocks[1]
    _, tp = _problems(case)
    cfg = tp.config
    e, _, d = t.X.shape
    l1 = cfg.regularization_context.l1_weight(cfg.regularization_weight)
    return (t.X, t.labels, toff, t.weights,
            torch.zeros((e, d), dtype=torch.float64), tp.objective(),
            torch.full((d,), l1, dtype=torch.float64)), cfg


def _jax_args(case, blocks):
    j, joff, _, _ = blocks[1]
    jp, _ = _problems(case)
    cfg = jp.config
    e, _, d = j.X.shape
    l1 = cfg.regularization_context.l1_weight(cfg.regularization_weight)
    return (j.X, j.labels, joff, j.weights, jnp.zeros((e, d), jnp.float64),
            jp.objective(), jnp.full(d, l1, jnp.float64))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("case", CASES)
def test_resumed_solver_equals_one_run(blocks, case):
    (X, labels, off, weights, x0, obj, l1), cfg = _port_args(case, blocks)
    payload = (obj, DenseBatch(X, labels, off, weights))
    solver = SOLVER[case]
    a, b = 3, cfg.max_iterations - 3
    args = (tre._vg, tre._hvp)
    x1, h1, _, carry = minimize(solver, *args, x0, payload, l1, a,
                                cfg.tolerance, return_carry=True)
    x2, h2, p2 = minimize(solver, *args, x0, payload, l1, b, cfg.tolerance,
                          resume=carry)
    x, h, p = minimize(solver, *args, x0, payload, l1, a + b, cfg.tolerance)
    assert int(h1.num_iterations.max()) == a  # some lanes were cut
    assert torch.equal(x2, x)
    assert torch.equal(h1.num_iterations + h2.num_iterations,
                       h.num_iterations)
    assert torch.equal(p2, p)
    rows = torch.arange(len(x))
    assert torch.equal(h2.values[rows, h2.num_iterations],
                       h.values[rows, h.num_iterations])


@pytest.mark.parametrize("case", CASES)
def test_fit_blocks_chunks_match_jax(blocks, case):
    """Two chunks of ``_fit_blocks_impl``: the first with
    ``boundary_convergence`` and the carry, the second resumed."""
    targs, cfg = _port_args(case, blocks)
    jargs = _jax_args(case, blocks)
    solver, tol, a = SOLVER[case], float(cfg.tolerance), 3
    b = cfg.max_iterations - a
    tout = tre._fit_blocks_impl(*targs, solver, a, tol,
                                boundary_convergence=True,
                                return_carry=True)
    jout = jre._fit_blocks_impl(*jargs, solver, a, tol,
                                boundary_convergence=True,
                                return_carry=True)
    tout2 = tre._fit_blocks_impl(*targs[:4], tout[4].x, *targs[5:], solver,
                                 b, tol, resume=tout[4])
    jout2 = jre._fit_blocks_impl(*jargs[:4], jout[4].x, *jargs[5:], solver,
                                 b, tol, resume=jout[4])
    for t, j in ((tout[:4], jout[:4]), (tout2, jout2)):
        tc, tit, tv, tk = (_np(v) for v in t)
        jc, jit, jv, jk = (_np(v) for v in j)
        np.testing.assert_array_equal(tit, jit)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_allclose(tc, jc, rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(tv, jv, rtol=1e-10)
    # the first chunk cut lanes that the second finished
    assert (_np(tout[3]) == tre.CONV_MAX_ITERATIONS).any()
    assert (_np(tout2[1]) > 0).any()


@pytest.mark.parametrize("num_buckets", [1, 2], ids=["plain", "bucketed"])
@pytest.mark.parametrize("chunk", [4, tre.AUTO_COMPACTION_CHUNK],
                         ids=["chunk4", "auto"])
@pytest.mark.parametrize("case", CASES)
def test_compacted_matches_jax_and_single_dispatch(blocks, case, chunk,
                                                   num_buckets):
    j, joff, t, toff = blocks[num_buckets]
    jp, tp = _problems(case, chunk)
    _, single = _problems(case)
    tre.reset_solve_stats()
    got = tp.run(t, toff)
    stats = dict(tre.SOLVE_STATS)
    want = single.run(t, toff)
    jgot = jp.run(j, joff)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tc, tit, tv, tk = (_np(v) for v in got)
    jc, jit, jv, jk = (_np(v) for v in jgot)
    np.testing.assert_array_equal(tit, jit)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(tc, jc, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(tv, jv, rtol=1e-10)
    if case != "linear_tron":  # TRON converges inside its first chunk
        assert stats["chunks"] > num_buckets
        assert stats["lane_counts"]


def test_solve_stats_show_lanes_shrinking(blocks):
    """Chunks of 2 on the plain block: every re-dispatch carries at least
    the lanes whose solve runs past that chunk's boundary, and fewer lanes
    as the chunks go on."""
    _, _, t, toff = blocks[1]
    _, tp = _problems("lbfgs", 2)
    tre.reset_solve_stats()
    _, iters, _, _ = tp.run(t, toff)
    stats = tre.SOLVE_STATS
    lanes = stats["lane_counts"]
    assert stats["chunks"] == stats["dispatches"] == len(lanes) + 1
    assert len(lanes) >= 3
    assert all(b <= a for a, b in zip(lanes, lanes[1:]))
    assert lanes[-1] < lanes[0] <= t.X.shape[0]
    it = iters.numpy()
    for i, n in enumerate(lanes):
        assert n >= int((it > 2 * (i + 1)).sum())


def test_lane_converging_on_the_boundary_leaves_with_its_reason(blocks):
    """A lane whose single-dispatch solve ends converged after exactly k
    iterations: with a chunk of k it meets its criterion on the chunk's
    last budgeted iteration, and must leave with that reason instead of
    being re-dispatched from its optimum."""
    j, joff, t, toff = blocks[1]
    jsingle, single = _problems("lbfgs")
    _, it, _, codes = single.run(t, toff)
    it, codes = it.numpy(), codes.numpy()
    max_iter = single.config.max_iterations
    ok = (codes != tre.CONV_MAX_ITERATIONS) & (it >= 2) & (it < max_iter)
    lane = int(np.nonzero(ok)[0][0])
    k = int(it[lane])
    targs, cfg = _port_args("lbfgs", blocks)
    tol = float(cfg.tolerance)
    cut = tre._fit_blocks_impl(*targs, "lbfgs", k, tol)
    kept = tre._fit_blocks_impl(*targs, "lbfgs", k, tol,
                                boundary_convergence=True)
    assert int(cut[1][lane]) == int(kept[1][lane]) == k
    assert int(cut[3][lane]) == tre.CONV_MAX_ITERATIONS
    assert int(kept[3][lane]) == int(codes[lane])
    jkept = jre._fit_blocks_impl(*_jax_args("lbfgs", blocks), "lbfgs", k,
                                 tol, boundary_convergence=True)
    np.testing.assert_array_equal(_np(jkept[3]), _np(kept[3]))
    # compacted with that chunk: the same codes and iterations as one
    # dispatch, in both packages
    jp, tp = _problems("lbfgs", k)
    got = tp.run(t, toff)
    assert int(got[3][lane]) == int(codes[lane])
    assert int(got[1][lane]) == k
    np.testing.assert_array_equal(got[3].numpy(), codes)
    np.testing.assert_array_equal(_np(jp.run(j, joff)[3]), codes)


@pytest.mark.parametrize("n,lanes,features,want", [
    (1, 683, 128, 1), (1, 702, 64, 2), (3, 2226, 32, 4), (5, 2429, 16, 8),
    (9, 2429, 16, 9), (1, 5, 16, 5), (2, 3000, 3, 43), (40, 3000, 3, 43)])
def test_padded_lane_count(n, lanes, features, want):
    """At least 128 lanes x features, at most the block's lanes."""
    assert padded_lane_count(n, lanes, features) == want


def test_chunk_auto_tuner_matches_jax():
    sequences = [[100, 90, 5], [100, 10], [100], [100, 50, 20], [0, 1],
                 [64, 60, 59], [64, 2], [7, 7, 7], [100, 80]]
    for max_iter in (3, 4, 5, 8, 20, 100):
        for solver in ("lbfgs", "tron"):
            jt, tt = jre.ChunkAutoTuner(), tre.ChunkAutoTuner()
            jseq, tseq = [], []
            for lanes in sequences:
                jseq.append(jt.chunk_for(solver, max_iter))
                tseq.append(tt.chunk_for(solver, max_iter))
                jt.update(solver, max_iter, lanes)
                tt.update(solver, max_iter, lanes)
            assert tseq == jseq, (max_iter, solver)
            assert len(set(tseq)) > 1 or max_iter <= 8
