"""PyTorch port vs the JAX package: the device mesh's data-sharded path.

The JAX side runs on the suite's 8 virtual CPU devices (``conftest.py``);
the port runs its meshes over a repeated ``cpu`` device
(``make_mesh(devices=["cpu"] * k)``), each shard in its own thread of the
shard runner (``parallel/collectives.py``).

- Mesh construction and ``largest_entity_divisor``: the JAX cases, equal.
- ``shard_batch`` and the row padding of ``run_glm_shard_map``: the padded
  rows carry weight 0 and split evenly; indivisible rows are refused.
- int8 quantization: values and scales equal the JAX package's bit for
  bit; ``qpsum``/``qall_gather`` agree with the JAX collectives under
  ``shard_map`` to 1e-6 (the same bytes, summed in another order), and
  the byte accounting is equal.
- ``run_glm_shard_map`` with L-BFGS, OWL-QN and TRON in f64: within
  1e-10 / 1e-12 of the port's local solve (the JAX package's own bound
  for its sharded fit) and of the JAX sharded fit; with an ELL batch too;
  with STANDARDIZATION within 1e-8 of the local solve and 1e-6 of the JAX
  fit (both packages' normalization factors are f32). The sharded weight update in f64 the same;
  with int8 on the wire (d = 520, so the gathers quantize) the objective
  within rel 1e-6 of the JAX int8 fit's and the coefficients within the
  int8 noise (1e-2) of it and of the exact fit.
- A default mesh with a data axis > 1 routes ``run`` through the shard
  runner; two sharded runs repeat bit for bit; a shard that raises ends
  the run with its error and no shard hangs; bodies without collectives
  on one device run in turn in the caller's thread.
- ``run_game_step`` against the JAX package's on a 4 x 2 mesh (f32,
  within 1e-3), and the ``multichip ok:`` line with ``platform=cpu``.
- The build cache key: the machine fingerprint, ``PHOTON_COMPILE_CACHE_DIR``
  and ``PHOTON_DISABLE_COMPILE_CACHE``.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from photon_ml_tpu.data import batch as jbatch
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.optimize.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_tpu.parallel import mesh as jmesh
from photon_ml_tpu.parallel import multichip_check as jmc
from photon_ml_tpu.parallel import quantized_collectives as jq
from photon_ml_tpu_torch.data import batch as tbatch
from photon_ml_tpu_torch.obs.metrics import MetricsRegistry
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem as TProblem
from photon_ml_tpu_torch.parallel import collectives as tcoll
from photon_ml_tpu_torch.parallel import distributed as tdist
from photon_ml_tpu_torch.parallel import mesh as tmesh
from photon_ml_tpu_torch.parallel import multichip_check as tmc
from photon_ml_tpu_torch.parallel import quantized_collectives as tq

torch.set_num_threads(1)
CPU4 = ["cpu"] * 4

#: (name, optimizer, regularization, lambda): the three solver paths
SOLVERS = [
    ("lbfgs", "LBFGS", "L2", 0.5),
    ("owlqn", "LBFGS", "L1", 0.3),
    ("tron", "TRON", "L2", 0.5),
]


@pytest.fixture(autouse=True)
def _no_port_mesh():
    tmesh.set_default_mesh(None)
    yield
    tmesh.set_default_mesh(None)


def _cfg(mod, opt, reg, lam, max_iter=40):
    return mod.GLMOptimizationConfiguration(
        max_iterations=max_iter, tolerance=1e-9, regularization_weight=lam,
        optimizer_type=mod.OptimizerType[opt],
        regularization_context=mod.RegularizationContext(
            mod.RegularizationType[reg]))


def _problems(opt, reg, lam, **kw):
    task_j = jcfg.TaskType.LOGISTIC_REGRESSION
    task_t = tcfg.TaskType.LOGISTIC_REGRESSION
    return (JProblem(config=_cfg(jcfg, opt, reg, lam), task=task_j, **kw),
            TProblem(config=_cfg(tcfg, opt, reg, lam), task=task_t, **kw))


def _data(seed=0, n=263, d=9):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    w = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ w)))).astype(float)
    return X, y


def _jmesh4():
    return jmesh.make_mesh(num_data=4, num_entity=1,
                           devices=jax.devices()[:4])


def _means(model):
    c = model.coefficients.means
    return c.detach().cpu().numpy() if isinstance(c, torch.Tensor) \
        else np.asarray(c)


# -- mesh ---------------------------------------------------------------


@pytest.mark.parametrize("num_data,num_entity",
                         [(8, 1), (4, 2), (2, 4), (1, 8), (None, 2)])
def test_mesh_construction(num_data, num_entity):
    jm = jmesh.make_mesh(num_data=num_data, num_entity=num_entity)
    tm = tmesh.make_mesh(num_data=num_data, num_entity=num_entity,
                         devices=["cpu"] * 8)
    assert tm.shape == dict(jm.shape)
    assert len(tm.axis_devices(tmesh.DATA_AXIS)) == jm.shape["data"]
    assert len(tm.axis_devices(tmesh.ENTITY_AXIS)) == jm.shape["entity"]
    assert tm.distinct_devices() == [torch.device("cpu")]


def test_mesh_refuses_a_shape_that_is_not_the_devices():
    with pytest.raises(ValueError, match="3x3 != 8"):
        jmesh.make_mesh(num_data=3, num_entity=3)
    with pytest.raises(ValueError, match="3x3 != 8"):
        tmesh.make_mesh(num_data=3, num_entity=3, devices=["cpu"] * 8)


@pytest.mark.parametrize("n,requested,want", [
    (8, 8, 8), (8, 4, 4), (8, 3, 2), (8, 5, 4), (8, 6, 4),
    (8, 1, 1), (8, 12, 8), (6, 4, 3), (7, 3, 1), (1, 5, 1),
])
def test_largest_entity_divisor(n, requested, want):
    assert tmesh.largest_entity_divisor(n, requested) == want
    assert jmesh.largest_entity_divisor(n, requested) == want


@pytest.mark.parametrize("requested,entity,warns",
                         [(3, 2, True), (4, 4, False), (8, 8, False)])
def test_setup_default_mesh_falls_back_like_jax(monkeypatch, caplog,
                                                requested, entity, warns):
    monkeypatch.setattr(tmesh, "visible_devices",
                        lambda device="cuda": [torch.device("cpu")] * 8)
    with caplog.at_level(logging.WARNING,
                         logger="photon_ml_tpu_torch.parallel.mesh"):
        tm = tmesh.setup_default_mesh(num_entity=requested, device="cpu")
    jm = jmesh.setup_default_mesh(num_entity=requested)
    assert tm.shape == dict(jm.shape) == {"data": 8 // entity,
                                          "entity": entity}
    assert tmesh.get_default_mesh() is tm
    assert any("does not divide" in r.getMessage()
               for r in caplog.records) == warns


def test_shard_batch_splits_rows_and_refuses_indivisible():
    X, y = _data(n=264)
    tb = tbatch.dense_batch(X, y, dtype=torch.float64, device="cpu")
    jb = jbatch.dense_batch(X, y, dtype=jnp.float64)
    tm = tmesh.make_mesh(devices=CPU4)
    shards = tmesh.shard_batch(tb, tm)
    js = jmesh.shard_batch(jb, _jmesh4())
    pieces = sorted(js.X.addressable_shards, key=lambda s: s.index[0].start)
    assert [tuple(s.X.shape) for s in shards] \
        == [tuple(p.data.shape) for p in pieces]
    for s, p in zip(shards, pieces):
        np.testing.assert_array_equal(s.X.numpy(), np.asarray(p.data))
    odd = tbatch.dense_batch(X[:263], y[:263], device="cpu")
    with pytest.raises(ValueError, match="pad with zero-weight rows"):
        tmesh.shard_batch(odd, tm)
    padded = tbatch.pad_batch(
        odd, tmesh.pad_rows_to_multiple(263, 4))
    assert padded.labels.shape[0] == 264 == jmesh.pad_rows_to_multiple(263, 4)
    assert float(padded.weights[-1]) == 0.0
    assert len(tmesh.shard_batch(padded, tm)) == 4


# -- quantized collectives ----------------------------------------------


def _quant_inputs():
    rng = np.random.default_rng(5)
    outlier = rng.normal(size=700).astype(np.float32)
    outlier[17] = 3e4
    zeros = np.concatenate([np.zeros(256, np.float32),
                            rng.normal(size=100).astype(np.float32)])
    return {"one": np.array([0.75], np.float32),
            "255": rng.normal(size=255).astype(np.float32),
            "256": rng.normal(size=256).astype(np.float32) * 1e-3,
            "outlier": outlier, "zero_block": zeros,
            "2d": rng.normal(size=(12, 40)).astype(np.float32) * 50}


@pytest.mark.parametrize("name", list(_quant_inputs()))
def test_quantize_blockwise_bit_for_bit(name):
    x = _quant_inputs()[name]
    qj, sj = jq.quantize_blockwise(jnp.asarray(x))
    qt, st = tq.quantize_blockwise(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(
        tq.dequantize_blockwise(qt, st).numpy(),
        np.asarray(jq.dequantize_blockwise(qj, sj)))


def _jax_collective(fn, parts):
    m = _jmesh4()
    f = jdist._shard_map(fn, m, in_specs=(P("data"),), out_specs=P())
    return np.asarray(jax.jit(f)(jnp.asarray(np.concatenate(parts))))


def _port_collective(fn, parts):
    return tcoll.run_shards(fn, [torch.device("cpu")] * len(parts), "data",
                            [(torch.from_numpy(p),) for p in parts])


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_qpsum_and_qall_gather_agree_with_jax(mode):
    rng = np.random.default_rng(9)
    parts = [rng.normal(size=600).astype(np.float32) for _ in range(4)]
    js = _jax_collective(lambda x: jq.qpsum(x, "data", mode=mode), parts)
    ts = _port_collective(lambda x: tq.qpsum(x, "data", mode=mode), parts)
    for t in ts:  # every shard holds the same bits
        np.testing.assert_array_equal(t.numpy(), ts[0].numpy())
    np.testing.assert_allclose(ts[0].numpy(), js, rtol=1e-6, atol=1e-6)
    jg = _jax_collective(lambda x: jq.qall_gather(x, "data", mode=mode),
                         parts)
    tg = _port_collective(lambda x: tq.qall_gather(x, "data", mode=mode),
                          parts)
    np.testing.assert_array_equal(tg[0].numpy(), jg)
    if mode == "int8":
        exact = np.concatenate(parts)
        assert 0 < np.abs(tg[0].numpy() - exact).max() \
            < np.abs(exact).max() / 127


@pytest.mark.parametrize("n,mode", [(1, "int8"), (255, "int8"),
                                    (256, "int8"), (1000, "int8"),
                                    (1000, "none")])
def test_collective_byte_accounting_is_jax_s(n, mode):
    assert tq.collective_payload_bytes(n, 4, mode) \
        == jq.collective_payload_bytes(n, 4, mode)
    reg = MetricsRegistry()
    got = tq.record_collective_bytes("fe.grad_psum", mode, n, rounds=3,
                                     registry=reg)
    assert got == 3 * jq.collective_payload_bytes(n, 4, mode)
    effective = "int8" if mode == "int8" and n >= 256 else "none"
    assert reg.counter("collective_bytes").total() == got
    assert set(reg.counter("collective_bytes").by_label("mode")) \
        == {effective}


def test_unknown_quant_mode_is_refused():
    with pytest.raises(ValueError, match="collective-quant"):
        tq.check_quant_mode("fp8")
    with pytest.raises(ValueError, match="collective-quant"):
        _problems("LBFGS", "L2", 0.5)[1].__class__(
            config=_cfg(tcfg, "LBFGS", "L2", 0.5),
            task=tcfg.TaskType.LOGISTIC_REGRESSION, collective_quant="fp8")


# -- data-sharded solves ------------------------------------------------


@pytest.fixture(scope="module")
def fe_data():
    X, y = _data()
    return {"X": X, "y": y,
            "jb": jbatch.dense_batch(X, y, dtype=jnp.float64),
            "tb": tbatch.dense_batch(X, y, dtype=torch.float64,
                                     device="cpu")}


@pytest.fixture(scope="module")
def jax_sharded(fe_data):
    """The JAX sharded fits (replicated and weight-sharded update) of each
    solver on 4 devices, f64."""
    out = {}
    for name, opt, reg, lam in SOLVERS:
        jp, _ = _problems(opt, reg, lam)
        for upd in (False, True):
            m, _ = jdist.run_glm_shard_map(
                dataclasses.replace(jp, shard_weight_update=upd),
                fe_data["jb"], _jmesh4())
            out[name, upd] = np.asarray(m.coefficients.means)
    return out


@pytest.mark.parametrize("upd", [False, True], ids=["replicated", "sharded"])
@pytest.mark.parametrize("name,opt,reg,lam", SOLVERS,
                         ids=[s[0] for s in SOLVERS])
def test_run_glm_shard_map_f64(fe_data, jax_sharded, name, opt, reg, lam,
                               upd):
    """Rows padded 263 -> 264 over 4 shards; d = 9 pads the weight-sharded
    vector to 12. Within 1e-10 / 1e-12 of the local solve and of the JAX
    sharded fit (the f64 reduction-order bound)."""
    _, tp = _problems(opt, reg, lam)
    local, _ = tp.run(fe_data["tb"])
    sharded, result = tdist.run_glm_shard_map(
        dataclasses.replace(tp, shard_weight_update=upd), fe_data["tb"],
        tmesh.make_mesh(devices=CPU4))
    np.testing.assert_allclose(_means(sharded), _means(local), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(_means(sharded), jax_sharded[name, upd],
                               rtol=1e-10, atol=1e-12)
    assert result.iterations > 0


def test_sharded_update_with_int8_on_the_wire():
    """d = 520: the iterate gathers and the gradient sums quantize. Each
    package's int8 fit lies ~6e-3 from the exact fit (the blocks' rounding
    steers the f32 trajectory); the two int8 fits reach the same objective
    to rel 1e-6 and lie within that noise, 1e-2, of each other and of the
    exact fit."""
    X, y = _data(seed=3, n=400, d=520)
    X = X / np.sqrt(520)
    jp, tp = _problems("LBFGS", "L2", 1.0)
    jp = dataclasses.replace(jp, shard_weight_update=True,
                             collective_quant="int8")
    tp = dataclasses.replace(tp, shard_weight_update=True)
    jm, jr = jdist.run_glm_shard_map(
        jp, jbatch.dense_batch(X, y, dtype=jnp.float32), _jmesh4())
    tb = tbatch.dense_batch(X, y, device="cpu")
    mesh = tmesh.make_mesh(devices=CPU4)
    exact, _ = tdist.run_glm_shard_map(tp, tb, mesh)
    reg_before = tq.REGISTRY.counter("collective_bytes").by_label("mode")
    tm, tr = tdist.run_glm_shard_map(
        dataclasses.replace(tp, collective_quant="int8"), tb, mesh)
    np.testing.assert_allclose(tr.value, jr.value, rtol=1e-6)
    np.testing.assert_allclose(_means(tm), np.asarray(jm.coefficients.means),
                               atol=1e-2)
    np.testing.assert_allclose(_means(tm), _means(exact), atol=1e-2)
    assert not np.array_equal(_means(tm), _means(exact))
    after = tq.REGISTRY.counter("collective_bytes").by_label("mode")
    assert after.get("int8", 0) > reg_before.get("int8", 0)


def test_sharded_fit_with_normalization_f64():
    from photon_ml_tpu.ops import normalization as jnorm
    from photon_ml_tpu.stat.summary import summarize as jsummarize
    from photon_ml_tpu_torch.ops import normalization as tnorm
    from photon_ml_tpu_torch.stat.summary import summarize as tsummarize

    rng = np.random.default_rng(1)
    n, d = 384, 8
    scales = 10.0 ** rng.integers(-2, 4, size=d)
    Xf = rng.normal(size=(n, d)) * scales + scales
    w_true = rng.normal(size=d) / scales
    X = np.concatenate([Xf, np.ones((n, 1))], axis=1)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(Xf @ w_true)))).astype(
        float)
    jn = jnorm.NormalizationContext.build(
        jnorm.NormalizationType.STANDARDIZATION, jsummarize(X),
        intercept_index=d)
    tn = tnorm.NormalizationContext.build(
        tnorm.NormalizationType.STANDARDIZATION,
        tsummarize(X, device="cpu"), intercept_index=d, device="cpu")
    jp, tp = _problems("LBFGS", "L2", 0.1)
    jp = dataclasses.replace(jp, normalization=jn)
    tp = dataclasses.replace(tp, normalization=tn)
    jm, _ = jdist.run_glm_shard_map(
        jp, jbatch.dense_batch(X, y, dtype=jnp.float64), _jmesh4())
    tb = tbatch.dense_batch(X, y, dtype=torch.float64, device="cpu")
    tm, _ = tdist.run_glm_shard_map(tp, tb, tmesh.make_mesh(devices=CPU4))
    local, _ = tp.run(tb)
    np.testing.assert_allclose(_means(tm), _means(local), rtol=1e-8,
                               atol=1e-10)
    # the f32 normalization factors of the two packages' summaries round
    # apart (~2e-8 relative): a looser bound against the JAX fit
    np.testing.assert_allclose(_means(tm), np.asarray(jm.coefficients.means),
                               rtol=1e-6, atol=1e-8)


def test_sharded_fit_on_an_ell_batch():
    import scipy.sparse as sp

    from photon_ml_tpu.game.dataset import csr_to_batch as jcsr
    from photon_ml_tpu_torch.game.dataset import csr_to_batch as tcsr

    rng = np.random.default_rng(7)
    n, d = 250, 40
    X = sp.random(n, d, density=0.2, random_state=7, format="csr")
    w = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ w)))).astype(float)
    args = (X.tocsr(), y, np.zeros(n), np.ones(n))
    jell = jcsr(*args, dtype=jnp.float64, dense_threshold=8)
    tell = tcsr(*args, dtype=torch.float64, dense_threshold=8,
                device="cpu")
    assert isinstance(tell, tbatch.EllBatch)
    jp, tp = _problems("LBFGS", "L2", 0.5)
    jm, _ = jdist.run_glm_shard_map(jp, jell, _jmesh4())
    tm, _ = tdist.run_glm_shard_map(tp, tell, tmesh.make_mesh(devices=CPU4))
    local, _ = tp.run(tell)
    np.testing.assert_allclose(_means(tm), _means(local), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(_means(tm), np.asarray(jm.coefficients.means),
                               rtol=1e-10, atol=1e-12)


def test_default_mesh_routes_run_through_the_shard_runner(fe_data,
                                                          monkeypatch):
    from photon_ml_tpu_torch.obs import trace

    calls = []
    orig = tdist.run_glm_shard_map
    monkeypatch.setattr(tdist, "run_glm_shard_map",
                        lambda *a, **k: calls.append(a[2]) or orig(*a, **k))
    spans = []
    real_span = trace.span
    monkeypatch.setattr(trace, "span", lambda name, **kw: spans.append(
        (name, kw.get("backend"))) or real_span(name, **kw))
    _, tp = _problems("LBFGS", "L2", 0.5)
    local, _ = tp.run(fe_data["tb"])
    mesh = tmesh.make_mesh(num_data=2, num_entity=2, devices=CPU4)
    tmesh.set_default_mesh(mesh)
    routed, _ = tp.run(fe_data["tb"])
    lazy = tp.run_lazy(fe_data["tb"])
    assert calls == [mesh, mesh]
    assert spans.count(("optimizer.solve", "shard_map")) == 2
    np.testing.assert_allclose(_means(routed), _means(local), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_array_equal(lazy.coefficients.numpy(),
                                  routed.coefficients.means.numpy())
    assert lazy.iterations > 0


def test_sharded_runs_repeat_bit_for_bit():
    X, y = _data(seed=4, n=1001, d=30)
    tb = tbatch.dense_batch(X, y, device="cpu")  # f32: order-sensitive
    _, tp = _problems("TRON", "L2", 0.5)
    mesh = tmesh.make_mesh(devices=CPU4)
    a, _ = tdist.run_glm_shard_map(tp, tb, mesh)
    b, _ = tdist.run_glm_shard_map(tp, tb, mesh)
    np.testing.assert_array_equal(_means(a), _means(b))


def test_a_raising_shard_ends_the_run_without_a_hang(monkeypatch):
    monkeypatch.setattr(tcoll, "SHARD_BARRIER_SECONDS", 60.0)

    def body(x):
        if tcoll.axis_index("data") == 2:
            raise ValueError("shard 2 failed")
        return tcoll.psum(x, "data")  # the others wait for shard 2 here

    with pytest.raises(ValueError, match="shard 2 failed"):
        tcoll.run_shards(body, [torch.device("cpu")] * 4, "data",
                         [(torch.ones(3),)] * 4)
    with pytest.raises(NameError, match="unbound axis name"):
        tcoll.psum(torch.ones(2), "data")
    assert tcoll.psum(torch.ones(2), None).tolist() == [1.0, 1.0]


def test_bodies_without_collectives_run_in_turn_on_one_device():
    import threading

    seen = []
    outs = tcoll.run_shards(
        lambda x: seen.append((threading.get_ident(),
                               tcoll.axis_index("entity"))) or x * 2,
        [torch.device("cpu")] * 4, "entity",
        [(torch.tensor(float(i)),) for i in range(4)], collectives=False)
    assert [o.item() for o in outs] == [0.0, 2.0, 4.0, 6.0]
    assert seen == [(threading.get_ident(), i) for i in range(4)]
    with pytest.raises(RuntimeError, match="collectives=False"):
        tcoll.run_shards(lambda x: tcoll.psum(x, "entity"),
                         [torch.device("cpu")] * 2, "entity",
                         [(torch.ones(1),)] * 2, collectives=False)


def test_psum_sums_in_shard_order_and_hands_out_copies():
    vals = [torch.tensor([1e16]), torch.tensor([1.0]), torch.tensor([-1e16]),
            torch.tensor([1.0])]
    outs = tcoll.run_shards(lambda x: tcoll.psum(x, "data"),
                            [torch.device("cpu")] * 4, "data",
                            [(v.double(),) for v in vals])
    # ((1e16 + 1) - 1e16) + 1 in f64, left to right
    assert [o.item() for o in outs] == [1.0] * 4
    assert len({o.data_ptr() for o in outs}) == 4


# -- the multi-device GAME step -----------------------------------------


@pytest.fixture(scope="module")
def game_steps():
    jm = jmesh.make_mesh(num_data=4, num_entity=2)
    with jax.enable_x64(False):
        jout = jmc.run_game_step(n_data=4, n_entity=2, mesh=jm)
    tm = tmesh.make_mesh(num_data=4, num_entity=2, devices=["cpu"] * 8)
    tout = tmc.run_game_step(n_data=4, n_entity=2, mesh=tm, device="cpu")
    tref = tmc.run_game_step(n_data=4, n_entity=2, mesh=None, device="cpu")
    return jout, tout, tref


@pytest.mark.parametrize("key", ["objectives", "fixed", "re_coefficients",
                                 "projection", "latent", "mf_scores",
                                 "shardmap_fixed"])
def test_run_game_step_matches_jax(game_steps, key):
    """f32 on both sides: the mesh step within 1e-3 of the JAX package's
    mesh step and of the port's single-device step (the gate's bound)."""
    jout, tout, tref = game_steps
    assert np.all(np.isfinite(tout[key]))
    np.testing.assert_allclose(tout[key], np.asarray(jout[key]), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(tout[key], tref[key], rtol=1e-3, atol=1e-3)


def test_multichip_gate_prints_its_summary_line(capsys):
    out = tmc.check_game_step_multichip(4, devices=["cpu"] * 4,
                                        parity_summary=True)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("multichip ok: platform=cpu n_devices=4 "
                           "mesh=(data=2,entity=2) coordinates=fixed,")
    assert float(line.rsplit("max_parity_dev=", 1)[1]) < 1e-3
    assert set(out) == {"objectives", "fixed", "re_coefficients",
                        "projection", "latent", "mf_scores",
                        "shardmap_fixed"}


# -- the build cache key ------------------------------------------------


def test_build_cache_key_names_the_machine(monkeypatch, tmp_path):
    from photon_ml_tpu_torch.ops import kernels_build
    from photon_ml_tpu_torch.utils import compile_cache

    monkeypatch.setattr(kernels_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(compile_cache, "nvcc_version",
                        lambda nvcc: "release 12.4")
    monkeypatch.delenv("PHOTON_DISABLE_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("PHOTON_COMPILE_CACHE_DIR", raising=False)
    here = kernels_build._lib_path("fused_value_gradient")
    assert here.startswith(kernels_build.BUILD_DIR)
    # another card, another nvcc or another torch: another library name
    monkeypatch.setattr(compile_cache, "compute_capability",
                        lambda: "sm_80")
    other_card = kernels_build._lib_path("fused_value_gradient")
    monkeypatch.setattr(compile_cache, "nvcc_version",
                        lambda nvcc: "release 12.8")
    other_nvcc = kernels_build._lib_path("fused_value_gradient")
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    other_torch = kernels_build._lib_path("fused_value_gradient")
    assert len({here, other_card, other_nvcc, other_torch}) == 4
    monkeypatch.setenv("PHOTON_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    assert kernels_build._lib_path("fused_value_gradient").startswith(
        str(tmp_path / "cache"))
    monkeypatch.setenv("PHOTON_DISABLE_COMPILE_CACHE", "1")
    monkeypatch.setattr(compile_cache, "_PROCESS_DIR", None)
    fresh = kernels_build._lib_path("fused_value_gradient")
    assert not fresh.startswith(str(tmp_path / "cache"))
    assert not fresh.startswith(kernels_build.BUILD_DIR)
    assert fresh == kernels_build._lib_path("fused_value_gradient")
