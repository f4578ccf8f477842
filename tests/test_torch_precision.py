"""``--precision bf16`` storage in the port, held against the JAX package.

Only X and the random-effect blocks are stored in bf16; labels, offsets,
weights, parameters and every reduction stay f32 (JAX ``data/batch.py``,
``optimize/common.py``). On the CPU, with numpy inputs made from a seed:

- the bf16 fixed-effect batch and random-effect blocks (one block and
  four buckets) the two packages build from the same data are equal bit
  for bit;
- the three solvers on ``tests/test_precision.py:85``'s bf16 batch (L-BFGS,
  OWL-QN through elastic net, TRON) follow the JAX package's objective
  trajectory within rel 1e-5 over their common iterations and end within
  rel 1e-5 of its value (both promote the same bf16 X to f32, so only the
  reduction order differs; the iteration counts may differ by a few as
  f32 stopping noise decides the last ones), and within 2e-2 of the f64
  oracle, the JAX test's bound;
- the lane-batched random-effect ops and solve over bf16 blocks
  accumulate in f32: their results are f32 and equal, bit for bit, the
  same ops over the f32 values of those blocks (bf16 → f32 is exact);
- the streamed builder with ``blocks_dir`` and bf16 (f32 memmap files,
  paged to the device as bf16) gives coordinate descent the same states,
  objectives and scores, bit for bit, as the in-RAM bf16 build;
- the GLMix training driver with ``--precision bf16`` matches the JAX
  driver update by update (x64 off, as the f32 driver tests: objectives
  and the logistic loss rel 1e-4; AUCs within one ordered pair of the
  validation rows, ``AUC_PAIR``), and with ``--random-effect-blocks-dir``
  writes the in-RAM bf16 run's model record for record;
- validation metrics over bf16-trained scores are computed in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.game_training_driver import main as jax_train_main
from photon_ml_tpu.game import dataset as jds
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.optimize.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.cli.args import precision_dtype
from photon_ml_tpu_torch.data.batch import DenseBatch, dense_batch
from photon_ml_tpu_torch.evaluation.evaluators import EvaluatorSpec, \
    evaluate_many
from photon_ml_tpu_torch.game import coordinate as tco
from photon_ml_tpu_torch.game import coordinate_descent as tcd
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem as TProblem
from test_precision import _batch, _config, _noisy_logistic_data
from test_torch_drivers import TRAIN_FLAGS, make_game_avro
from test_torch_game import RE_CONFIG, _game_dataset
from test_torch_streamed import _model_records, _objectives

torch.set_num_threads(1)
BF16 = torch.bfloat16


#: one ordered (positive, negative) pair of the 200 validation rows of
#: ``make_game_avro(n=200, seed=1)`` (110 positive, 90 negative), plus f32
#: rounding: the bf16 runs' scores of one such pair are near tied, and the
#: JAX package (f32 metrics) and the port (f64) order it differently after
#: the last update
AUC_PAIR = 1.0 / (110 * 90) + 1e-6


def _f32(a) -> np.ndarray:
    """Host f32 values of a bf16 (or any) array of either package."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def test_precision_dtype_maps_the_flag():
    assert precision_dtype("f32") is torch.float32
    assert precision_dtype("bf16") is BF16
    with pytest.raises(ValueError, match="precision"):
        precision_dtype("f16")


@pytest.fixture(scope="module")
def data():
    return _game_dataset(jds), _game_dataset(tds)


def test_bf16_fixed_effect_batch_equals_jax(data):
    jdata, tdata = data
    j = jds.build_fixed_effect_dataset(jdata, "global",
                                       dtype=jnp.bfloat16).batch
    t = tds.build_fixed_effect_dataset(tdata, "global", dtype=BF16,
                                       device="cpu").batch
    assert t.X.dtype == BF16 and j.X.dtype == jnp.bfloat16
    assert np.array_equal(_f32(t.X), _f32(j.X))
    for f in ("labels", "offsets", "weights"):
        assert getattr(t, f).dtype == torch.float32
        assert np.array_equal(getattr(t, f).numpy(),
                              np.asarray(getattr(j, f)))


@pytest.mark.parametrize("num_buckets", [1, 4])
def test_bf16_random_effect_blocks_equal_jax(data, num_buckets):
    jdata, tdata = data
    j = jds.build_random_effect_dataset(
        jdata, jds.RandomEffectDataConfiguration(**RE_CONFIG),
        num_buckets=num_buckets, dtype=jnp.bfloat16)
    t = tds.build_random_effect_dataset(
        tdata, tds.RandomEffectDataConfiguration(**RE_CONFIG),
        num_buckets=num_buckets, dtype=BF16, device="cpu")
    jblocks = [j] if j.buckets is None else j.buckets
    tblocks = [t] if t.buckets is None else t.buckets
    assert len(jblocks) == len(tblocks) == num_buckets
    for jb, tb in zip(jblocks, tblocks):
        assert tb.X.dtype == BF16
        assert np.array_equal(_f32(tb.X), _f32(jb.X))
        assert tb.weights.dtype == tb.labels.dtype == torch.float32
    assert t.passive_X.dtype == BF16
    assert np.array_equal(_f32(t.passive_X), _f32(j.passive_X))


@pytest.mark.parametrize("optimizer,l1", [("LBFGS", False), ("LBFGS", True),
                                          ("TRON", False)])
def test_bf16_solvers_follow_the_jax_trajectory(optimizer, l1):
    X, y = _noisy_logistic_data(np.random.default_rng(42))
    with jax.enable_x64(False):
        _, jres = JProblem(
            config=_config(getattr(jcfg.OptimizerType, optimizer), l1),
            task=jcfg.TaskType.LOGISTIC_REGRESSION).run(
                _batch(X, y, jnp.bfloat16))
    reg = (tcfg.RegularizationContext(tcfg.RegularizationType.ELASTIC_NET,
                                      alpha=0.5) if l1
           else tcfg.RegularizationContext(tcfg.RegularizationType.L2))
    cfg = tcfg.GLMOptimizationConfiguration(
        max_iterations=40, tolerance=1e-8, regularization_weight=1.0,
        optimizer_type=getattr(tcfg.OptimizerType, optimizer),
        regularization_context=reg)
    problem = TProblem(config=cfg, task=tcfg.TaskType.LOGISTIC_REGRESSION)
    batch = dense_batch(X, y, dtype=BF16, device="cpu")
    assert batch.X.dtype == BF16 and batch.acc_dtype == torch.float32
    _, tres = problem.run(batch)
    assert tres.coefficients.dtype == torch.float32
    jv, tv = np.asarray(jres.values), np.asarray(tres.values)
    k = min(len(jv), len(tv))
    assert k >= 3
    np.testing.assert_allclose(tv[:k], jv[:k], rtol=1e-5)
    assert tres.value == pytest.approx(jres.value, rel=1e-5)
    _, oracle = problem.run(dense_batch(X, y, dtype=torch.float64,
                                        device="cpu"))
    assert abs(tres.value - oracle.value) / abs(oracle.value) < 2e-2


def test_lane_batched_ops_over_bf16_blocks_accumulate_in_f32(data):
    _, tdata = data
    cfg = tds.RandomEffectDataConfiguration(**RE_CONFIG)
    ds = tds.build_random_effect_dataset(tdata, cfg, dtype=BF16,
                                         device="cpu")
    lifted = tds.build_random_effect_dataset(tdata, cfg, dtype=BF16,
                                             device="cpu")
    lifted.X = ds.X.float()  # the same values, stored f32
    e, n, d = ds.X.shape
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(e, n)).astype(np.float32))
    shift = torch.zeros(e)
    b16 = DenseBatch(ds.X, ds.labels, ds.base_offsets, ds.weights)
    b32 = DenseBatch(lifted.X, ds.labels, ds.base_offsets, ds.weights)
    for op, args in (("margins", (w, shift)),
                     ("weighted_feature_sum", (r,)),
                     ("hadamard_square_sum", (r,))):
        got, want = getattr(b16, op)(*args), getattr(b32, op)(*args)
        assert got.dtype == torch.float32, op
        assert torch.equal(got, want), op
    problem = tre.RandomEffectOptimizationProblem(
        config=tcfg.GLMOptimizationConfiguration(
            max_iterations=15, tolerance=1e-7, regularization_weight=1.0),
        task=tcfg.TaskType.LOGISTIC_REGRESSION)
    zeros = torch.zeros(tdata.num_samples)
    got = problem.run(ds, ds.offsets_with(zeros))
    want = problem.run(lifted, lifted.offsets_with(zeros))
    assert got[0].dtype == torch.float32
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    scores = tre.score_random_effect(ds, got[0])
    assert scores.dtype == torch.float32
    assert torch.equal(scores, tre.score_random_effect(lifted, got[0]))
    # the 2-D fixed-effect batch in bf16 (the kernel-off and Hv paths):
    # the same elementwise products and sums as over its f32 values, so
    # f32 accumulation, within f32 rounding (rel 1e-5) of an f64 sum
    fe = tds.build_fixed_effect_dataset(tdata, "global", dtype=BF16,
                                        device="cpu").batch
    fb = DenseBatch(fe.X, fe.labels, fe.offsets, fe.weights)
    x64 = fe.X.double()
    n2, d2 = fe.X.shape
    w2 = torch.from_numpy(rng.normal(size=d2).astype(np.float32))
    r2 = torch.from_numpy(rng.normal(size=n2).astype(np.float32))
    for op, args, lifted_op, f64 in (
            ("margins", (w2, torch.zeros(())),
             lambda X: (X * w2).sum(-1) + fe.offsets,
             (x64 * w2.double()).sum(-1) + fe.offsets.double()),
            ("weighted_feature_sum", (r2,),
             lambda X: (X * r2.unsqueeze(-1)).sum(-2),
             (x64 * r2.double().unsqueeze(-1)).sum(-2)),
            ("hadamard_square_sum", (r2,),
             lambda X: (X * r2.unsqueeze(-1) * X).sum(-2),
             (x64 * x64 * r2.double().unsqueeze(-1)).sum(-2))):
        got = getattr(fb, op)(*args)
        assert got.dtype == torch.float32, op
        assert torch.equal(got, lifted_op(fe.X.float())), op
        np.testing.assert_allclose(got.numpy(), f64.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(f64.abs().max()),
                                   err_msg=op)


def _coords(tdata, re_ds):
    cfg = tcfg.GLMOptimizationConfiguration.parse("20,1e-7,1.0,1,LBFGS,L2")
    task = tcfg.TaskType.LOGISTIC_REGRESSION
    return {"fixed": tco.FixedEffectCoordinate(
                tds.build_fixed_effect_dataset(tdata, "global", dtype=BF16,
                                               device="cpu"),
                TProblem(config=cfg, task=task)),
            "per-user": tco.RandomEffectCoordinate(
                re_ds, tre.RandomEffectOptimizationProblem(config=cfg,
                                                           task=task))}


def test_streamed_bf16_blocks_dir_equals_in_ram_bf16(data, tmp_path):
    _, tdata = data
    cfg = tds.RandomEffectDataConfiguration(**RE_CONFIG)
    ram = tds.build_random_effect_dataset(tdata, cfg, num_buckets=3,
                                          dtype=BF16, device="cpu")
    streamed = tds.build_random_effect_dataset_streamed(
        tds.dataset_row_stream(tdata, cfg, chunk_rows=701), cfg,
        raw_dim=tdata.feature_shards["per_user"].shape[1], num_buckets=3,
        blocks_dir=str(tmp_path), dtype=BF16, device="cpu")
    assert streamed.storage_dtype == BF16
    for a, b in zip(ram.buckets, streamed.buckets):
        assert isinstance(b.X, np.memmap) and b.X.dtype == np.float32
        assert torch.equal(a.X, tre.device_block(b.X, torch.device("cpu"),
                                                 BF16))
    runs = [tcd.run_coordinate_descent(
        _coords(tdata, ds), 2, tcfg.TaskType.LOGISTIC_REGRESSION,
        tdata.responses, tdata.weights, tdata.offsets, device="cpu")
        for ds in (ram, streamed)]
    assert [s.objective for s in runs[0].states] == \
        [s.objective for s in runs[1].states]
    for cid in ("fixed", "per-user"):
        a, b = (r.model.models[cid] for r in runs)
        a = getattr(a, "coefficients_projected", None) \
            if cid == "per-user" else a.model.coefficients.means
        b = getattr(b, "coefficients_projected", None) \
            if cid == "per-user" else b.model.coefficients.means
        assert torch.equal(a, b), cid
    assert torch.equal(runs[0].model.score(tdata, device="cpu"),
                       runs[1].model.score(tdata, device="cpu"))


@pytest.fixture(scope="module")
def bf16_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("bf16_drivers")
    train, val = str(d / "train.avro"), str(d / "val.avro")
    make_game_avro(train, seed=0)
    make_game_avro(val, n=200, seed=1)
    base = ["--train-input-dirs", train, "--validate-input-dirs", val,
            *TRAIN_FLAGS, "--precision", "bf16"]
    out = {k: str(d / k) for k in ("jax", "torch", "blocks", "f32")}
    with jax.enable_x64(False):
        jax_train_main(base + ["--output-dir", out["jax"]])
    driver = ttd.run(base + ["--output-dir", out["torch"],
                             "--device", "cpu"])
    ttd.run(base + ["--random-effect-blocks-dir", str(d / "blocks_dir"),
                    "--output-dir", out["blocks"], "--device", "cpu"])
    ttd.run(base[:-2] + ["--output-dir", out["f32"], "--device", "cpu"])
    return dict(out=out, driver=driver)


def test_bf16_training_driver_matches_jax_update_by_update(bf16_runs):
    out = bf16_runs["out"]
    t, j = _objectives(out["torch"]), _objectives(out["jax"])
    assert len(t) == len(j) == 4
    for (ti, tc, to, tv), (ji, jc, jo, jv) in zip(t, j):
        assert (ti, tc) == (ji, jc)
        assert to == pytest.approx(jo, rel=1e-4)
        for name in ("AUC", "AUC:userId"):
            assert tv[name] == pytest.approx(jv[name], abs=AUC_PAIR), name
        assert tv["LOGISTIC_LOSS"] == pytest.approx(jv["LOGISTIC_LOSS"],
                                                    rel=1e-4)
    # bf16 is a different result from f32, not a relabelled f32 run
    f32 = _objectives(out["f32"])
    assert [o for _, _, o, _ in t] != [o for _, _, o, _ in f32]
    for (_, _, to, _), (_, _, fo, _) in zip(t, f32):
        assert to == pytest.approx(fo, rel=1e-2)
    assert bf16_runs["driver"].best_result is not None


def test_bf16_training_driver_blocks_dir_equals_in_ram(bf16_runs):
    out = bf16_runs["out"]
    assert _objectives(out["blocks"]) == _objectives(out["torch"])
    assert _model_records(out["blocks"]) == _model_records(out["torch"])


def test_bf16_metrics_are_computed_in_f64():
    rng = np.random.default_rng(2)
    scores = torch.from_numpy(rng.normal(size=600).astype(np.float32))
    labels = torch.from_numpy((rng.uniform(size=600) < 0.5).astype(
        np.float32))
    weights = torch.ones(600)
    specs = [EvaluatorSpec.parse(s) for s in ("AUC", "LOGISTIC_LOSS")]
    got = evaluate_many(specs, scores.to(BF16).float(), labels, weights)
    want = evaluate_many(specs, scores.to(BF16).double(), labels.double(),
                         weights.double())
    assert got == pytest.approx(want, rel=1e-12)
