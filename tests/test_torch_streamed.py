"""PyTorch port vs the JAX package: the streamed random-effect builder.

- The port's ``build_random_effect_dataset_streamed`` (row chunks of 701
  through ``dataset_row_stream``, memmap blocks under a ``blocks_dir``)
  equals its in-RAM ``build_random_effect_dataset`` array for array
  (``np.array_equal``), for INDEX_MAP / RANDOM / IDENTITY projection x 1
  and 3 buckets x with and without the active and feature caps: entity
  order, every bucket array, the passive rows and the projectors. The
  in-RAM build through the numpy scatter (``native_pack=False``) equals
  the native pack, and the port's streamed build equals the JAX
  package's, array for array.
- ``_PairStatsAccumulator`` fed in chunks gives the projectors of
  ``_build_index_map_projectors`` over the same rows.
- With ``blocks_dir`` the feature blocks are ``np.memmap`` files of the
  expected sizes there, and the small arrays are device tensors; with
  ``dtype=bf16`` the files stay f32 and the blocks page in as bf16.
- Coordinate descent on memmap blocks, and its resume from a mid-sweep
  snapshot, equal the in-RAM run bit for bit (objectives, states,
  scores).
- The port's training driver with ``--random-effect-blocks-dir`` writes
  the models (record for record) and objectives of its run without it,
  and agrees with the JAX driver given the same flag (objectives rel
  1e-4, f32, as ``tests/test_torch_drivers.py``).
"""

import json
import os

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.cli.game_training_driver import main as jax_train_main
from photon_ml_tpu.game import dataset as jds
from photon_ml_tpu.projector import projectors as jproj
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.game import coordinate as tco
from photon_ml_tpu_torch.game import coordinate_descent as tcd
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.io.avro import read_records
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem as TProblem
from photon_ml_tpu_torch.projector import projectors as tproj
from photon_ml_tpu_torch.utils import checkpoint as tck
from photon_ml_tpu_torch.utils import faults as tfaults
from test_torch_drivers import TRAIN_FLAGS, make_game_avro

torch.set_num_threads(1)
N, USERS, D = 4000, 50, 120
CHUNK = 701


def _data(mod, seed=3):
    r = np.random.default_rng(seed)
    users = (r.zipf(1.3, size=N) % USERS).astype(np.int64)
    mat = sp.random(N, D, density=0.05, format="csr",
                    random_state=np.random.RandomState(seed))
    data = mod.GameDataset(
        responses=(r.uniform(size=N) < 0.5).astype(np.float64),
        feature_shards={"u": mat, "g": sp.csr_matrix(r.normal(size=(N, 5)))},
        offsets=r.normal(size=N) * 0.1, weights=r.uniform(0.5, 2.0, N))
    data.encode_ids("userId", users)
    return data


@pytest.fixture(scope="module")
def tdata():
    return _data(tds)


def _config(mod, proj_mod, kind, capped):
    proj = {"INDEX_MAP": proj_mod.ProjectorConfig(
                proj_mod.ProjectorType.INDEX_MAP),
            "RANDOM": proj_mod.ProjectorConfig(
                proj_mod.ProjectorType.RANDOM, projected_dim=16, seed=5),
            "IDENTITY": proj_mod.ProjectorConfig(
                proj_mod.ProjectorType.IDENTITY)}[kind]
    return mod.RandomEffectDataConfiguration(
        "userId", "u", 1,
        num_active_data_points_upper_bound=40 if capped else None,
        num_features_to_keep_upper_bound=12 if capped else None,
        projector=proj)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_equal(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and np.array_equal(a, b)


BUCKET_FIELDS = ("X", "labels", "base_offsets", "weights", "row_ids")
PASSIVE_FIELDS = ("passive_X", "passive_entity", "passive_row_ids",
                  "passive_offsets")


def _assert_datasets_equal(a, b):
    """``a`` (single block or bucketed) equals the bucketed ``b``."""
    _assert_equal(a.entity_codes, b.entity_codes)
    blocks = a.buckets if a.buckets is not None else [a]
    assert len(blocks) == len(b.buckets)
    for x, y in zip(blocks, b.buckets):
        for f in BUCKET_FIELDS:
            _assert_equal(getattr(x, f), getattr(y, f))
    assert a.num_passive == b.num_passive
    for f in PASSIVE_FIELDS:
        if a.num_passive:
            _assert_equal(getattr(a, f), getattr(b, f))
    assert a.reduced_dim == b.reduced_dim
    if a.projectors is not None:
        _assert_equal(a.projectors.raw_indices, b.projectors.raw_indices)
        _assert_equal(a.projectors.reduced_dims, b.projectors.reduced_dims)


CASES = [(k, nb, c) for k in ("INDEX_MAP", "RANDOM", "IDENTITY")
         for nb in (1, 3) for c in (False, True)]


@pytest.mark.parametrize("kind,buckets,capped", CASES)
def test_streamed_equals_in_ram(tdata, tmp_path, kind, buckets, capped):
    cfg = _config(tds, tproj, kind, capped)
    ram = tds.build_random_effect_dataset(tdata, cfg, seed=9,
                                          num_buckets=buckets, device="cpu")
    streamed = tds.build_random_effect_dataset_streamed(
        tds.dataset_row_stream(tdata, cfg, chunk_rows=CHUNK), cfg,
        raw_dim=D, seed=9, num_buckets=buckets,
        blocks_dir=str(tmp_path), device="cpu")
    _assert_datasets_equal(ram, streamed)
    assert streamed.device == ram.device == torch.device("cpu")
    if capped:
        assert streamed.num_passive > 0
    if kind == "INDEX_MAP":
        numpy_packed = tds.build_random_effect_dataset(
            tdata, cfg, seed=9, num_buckets=buckets, device="cpu",
            native_pack=False)
        numpy_streamed = tds.build_random_effect_dataset_streamed(
            tds.dataset_row_stream(tdata, cfg, chunk_rows=CHUNK), cfg,
            raw_dim=D, seed=9, num_buckets=buckets, device="cpu",
            native_pack=False)
        _assert_datasets_equal(numpy_packed, streamed)
        _assert_datasets_equal(ram, numpy_streamed)


@pytest.mark.parametrize("kind,buckets", [("INDEX_MAP", 3), ("RANDOM", 1)])
def test_streamed_matches_jax_streamed(tdata, kind, buckets):
    jdata = _data(jds)
    tcfg_, jcfg_ = (_config(tds, tproj, kind, True),
                    _config(jds, jproj, kind, True))
    t = tds.build_random_effect_dataset_streamed(
        tds.dataset_row_stream(tdata, tcfg_, chunk_rows=CHUNK), tcfg_,
        raw_dim=D, seed=9, num_buckets=buckets, device="cpu")
    j = jds.build_random_effect_dataset_streamed(
        jds.dataset_row_stream(jdata, jcfg_, chunk_rows=CHUNK), jcfg_,
        raw_dim=D, seed=9, num_buckets=buckets, keep_host_blocks=True)
    _assert_datasets_equal(j, t)


@pytest.mark.parametrize("capped", [False, True])
def test_pair_stats_accumulator_equals_the_in_ram_projectors(tdata,
                                                             capped):
    cfg = _config(tds, tproj, "INDEX_MAP", capped)
    mat = tdata.feature_shards["u"]
    ent = tdata.id_columns["userId"]
    counts = np.bincount(ent, minlength=USERS)
    want = tds._build_index_map_projectors(mat, ent, counts, tdata.responses,
                                           D, cfg)
    acc = tds._PairStatsAccumulator(D, USERS, capped)
    for lo in range(0, N, 997):
        acc.add(mat[lo:lo + 997], ent[lo:lo + 997],
                tdata.responses[lo:lo + 997])
    got = acc.finalize(counts, cfg)
    _assert_equal(got.raw_indices, want.raw_indices)
    _assert_equal(got.reduced_dims, want.reduced_dims)
    assert got.raw_dim == want.raw_dim == D
    if capped:
        assert int(got.reduced_dims.max()) <= 12


def test_blocks_are_memmap_files_on_disk(tdata, tmp_path):
    cfg = _config(tds, tproj, "INDEX_MAP", True)
    ds = tds.build_random_effect_dataset_streamed(
        tds.dataset_row_stream(tdata, cfg, chunk_rows=CHUNK), cfg,
        raw_dim=D, num_buckets=3, blocks_dir=str(tmp_path), device="cpu")
    names = sorted(os.listdir(tmp_path))
    assert names == sorted([f"bucket{b}_X.f32"
                            for b in range(len(ds.buckets))]
                           + ["passive_X.f32"])
    for b, bucket in enumerate(ds.buckets):
        assert isinstance(bucket.X, np.memmap)
        assert os.path.getsize(tmp_path / f"bucket{b}_X.f32") == \
            bucket.X.size * 4
        for f in BUCKET_FIELDS[1:]:
            assert isinstance(getattr(bucket, f), torch.Tensor)
    assert isinstance(ds.passive_X, np.memmap)
    assert os.path.getsize(tmp_path / "passive_X.f32") == ds.passive_X.size * 4
    in_ram = tds.build_random_effect_dataset_streamed(
        tds.dataset_row_stream(tdata, cfg, chunk_rows=CHUNK), cfg,
        raw_dim=D, num_buckets=3, device="cpu")
    assert all(isinstance(b.X, torch.Tensor) for b in in_ram.buckets)
    # bf16 storage: the memmap files stay f32 (the spill format), the
    # blocks take the dtype when they are paged to the device
    bf16 = tds.build_random_effect_dataset_streamed(
        tds.dataset_row_stream(tdata, cfg, chunk_rows=CHUNK), cfg,
        raw_dim=D, num_buckets=3, blocks_dir=str(tmp_path / "bf16"),
        dtype=torch.bfloat16, device="cpu")
    assert bf16.storage_dtype == torch.bfloat16
    assert sorted(os.listdir(tmp_path / "bf16")) == names
    for b, bucket in zip(bf16.buckets, ds.buckets):
        assert b.X.dtype == np.float32 and np.array_equal(b.X, bucket.X)
        paged = tre.device_block(b.X, torch.device("cpu"),
                                 bf16.storage_dtype)
        assert paged.dtype == torch.bfloat16
        assert torch.equal(paged, torch.from_numpy(np.asarray(
            bucket.X)).to(torch.bfloat16))


def _coords(data, re_ds):
    cfg = tcfg.GLMOptimizationConfiguration.parse("20,1e-7,1.0,1,LBFGS,L2")
    task = tcfg.TaskType.LOGISTIC_REGRESSION
    return {"fixed": tco.FixedEffectCoordinate(
                tds.build_fixed_effect_dataset(data, "g", device="cpu"),
                TProblem(config=cfg, task=task)),
            "per-user": tco.RandomEffectCoordinate(
                re_ds, tre.RandomEffectOptimizationProblem(config=cfg,
                                                           task=task))}


def _cd(data, re_ds, **kw):
    return tcd.run_coordinate_descent(
        _coords(data, re_ds), 2, tcfg.TaskType.LOGISTIC_REGRESSION,
        data.responses, data.weights, data.offsets, device="cpu", **kw)


def _final(res, data):
    m = res.model.models
    return {"fixed": m["fixed"].model.coefficients.means.numpy(),
            "per-user": m["per-user"].coefficients_projected.numpy(),
            "scores": res.model.score(data, device="cpu").numpy()}


def test_coordinate_descent_on_memmap_blocks_is_bit_exact(tdata, tmp_path):
    cfg = _config(tds, tproj, "INDEX_MAP", True)
    ram = tds.build_random_effect_dataset(tdata, cfg, num_buckets=3,
                                          device="cpu")
    want = _cd(tdata, ram)

    def memmap_ds(sub):
        return tds.build_random_effect_dataset_streamed(
            tds.dataset_row_stream(tdata, cfg, chunk_rows=CHUNK), cfg,
            raw_dim=D, num_buckets=3, blocks_dir=str(tmp_path / sub),
            device="cpu")

    got = _cd(tdata, memmap_ds("run"))
    assert [s.objective for s in got.states] == \
        [s.objective for s in want.states]
    for k, v in _final(want, tdata).items():
        assert np.array_equal(_final(got, tdata)[k], v), k
    # a mid-sweep kill on memmap blocks, resumed from its snapshot
    mgr = tck.CheckpointManager(str(tmp_path / "ckpt"))
    tfaults.arm("cd.update", "raise", tag="1.1")
    try:
        with pytest.raises(tfaults.InjectedFault):
            _cd(tdata, memmap_ds("killed"), checkpoint_manager=mgr,
                checkpoint_every_coordinates=1)
    finally:
        tfaults.disarm_all()
    snap = mgr.restore()
    assert (snap["sweep"], snap["coordinate_index"]) == (1, 1)
    resumed = _cd(tdata, memmap_ds("resumed"), checkpoint_manager=mgr,
                  checkpoint_every_coordinates=1, resume_snapshot=snap)
    assert resumed.states[-1].objective == want.states[-1].objective
    for k, v in _final(want, tdata).items():
        assert np.array_equal(_final(resumed, tdata)[k], v), k


def _model_records(out):
    best = os.path.join(out, "best")
    recs = {}
    for root, _, files in os.walk(best):
        for f in files:
            path = os.path.join(root, f)
            recs[os.path.relpath(path, best)] = (
                read_records(path) if f.endswith(".avro")
                else open(path, "rb").read())
    return recs


def _objectives(out):
    metrics = json.load(open(os.path.join(out, "metrics.json")))
    (grid,) = metrics["grid"]
    return [(s["iteration"], s["coordinate"], s["objective"],
             s["validation_metrics"]) for s in grid["states"]]


@pytest.fixture(scope="module")
def blocks_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("blocks_drivers")
    train, val = str(d / "train.avro"), str(d / "val.avro")
    make_game_avro(train, seed=0)
    make_game_avro(val, n=200, seed=1)
    base = ["--train-input-dirs", train, "--validate-input-dirs", val,
            *TRAIN_FLAGS]
    blocks = ["--random-effect-blocks-dir", str(d / "blocks")]
    out = {k: str(d / k) for k in ("plain", "blocks", "jax_blocks")}
    ttd.run(base + ["--output-dir", out["plain"], "--device", "cpu"])
    driver = ttd.run(base + blocks + ["--output-dir", out["blocks"],
                                      "--device", "cpu"])
    with jax.enable_x64(False):
        jax_train_main(base + ["--random-effect-blocks-dir",
                               str(d / "jax_blocks_dir"),
                               "--output-dir", out["jax_blocks"]])
    return dict(dir=d, out=out, driver=driver)


def test_training_driver_with_blocks_dir_equals_the_plain_run(blocks_runs):
    out = blocks_runs["out"]
    assert _objectives(out["blocks"]) == _objectives(out["plain"])
    assert _model_records(out["blocks"]) == _model_records(out["plain"])
    blocks = os.path.join(blocks_runs["dir"], "blocks", "perUser")
    assert any(f.startswith("bucket") for f in os.listdir(blocks))


def test_training_drivers_with_blocks_dir_agree(blocks_runs):
    out = blocks_runs["out"]
    t, j = _objectives(out["blocks"]), _objectives(out["jax_blocks"])
    assert len(t) == len(j) == 4
    for (ti, tc, to, tv), (ji, jc, jo, jv) in zip(t, j):
        assert (ti, tc) == (ji, jc)
        assert to == pytest.approx(jo, rel=1e-4)
        assert tv["AUC"] == pytest.approx(jv["AUC"], abs=1e-4)
    assert os.path.isdir(os.path.join(blocks_runs["dir"], "jax_blocks_dir",
                                      "perUser"))
