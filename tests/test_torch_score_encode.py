"""PyTorch port vs the JAX package: score encoding and random-effect scoring.

- ``save_scored_items`` encodes each block with the port's native encoder
  (``csrc/host/score_encoder.cpp``). Its files read back to the same
  records as the plain record-by-record writer's, with and without uids,
  labels and weights, across more than one block (sync markers differ
  between files, so the bytes need not); each block's record stream is
  byte for byte the JAX package's native encoder's.
- ``RandomEffectModel.score`` runs in O(nnz): equal bit for bit to the
  dense ``[N, D_raw]`` form it replaced and to the JAX package's
  ``RandomEffectModel.score``; an entity without a model scores 0.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.game import models as jmodels
from photon_ml_tpu.game.dataset import GameDataset as JGameDataset
from photon_ml_tpu.io import native_loader as jnative
from photon_ml_tpu_torch.game import models as tmodels
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.io import native_loader as tnative
from photon_ml_tpu_torch.io.avro import DEFAULT_SYNC_INTERVAL

torch.set_num_threads(1)

COLUMNS = [(u, lab, w) for u in (False, True) for lab in (False, True)
           for w in (False, True)]


def _columns(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n), [f"uid-{i}-é" for i in range(n)],
            rng.integers(0, 2, n).astype(np.float64), rng.uniform(size=n))


@pytest.mark.parametrize("with_uid,with_label,with_weight", COLUMNS)
def test_native_score_files_read_back_like_the_records_writer(
        tmp_path, with_uid, with_label, with_weight):
    scores, uids, labels, weights = _columns(300)
    kw = dict(uids=uids if with_uid else None,
              labels=labels if with_label else None,
              weights=weights if with_weight else None)
    native, plain = str(tmp_path / "n.avro"), str(tmp_path / "p.avro")
    tio.save_scored_items(native, scores, "m-1", **kw)
    tio.save_scored_items_records(plain, scores, "m-1", **kw)
    got, want = tio.load_scored_items(native), tio.load_scored_items(plain)
    assert got == want and len(got) == 300
    assert [r["predictionScore"] for r in got] == scores.tolist()


@pytest.mark.parametrize("n", [0, DEFAULT_SYNC_INTERVAL + 17])
def test_native_score_files_block_edges(tmp_path, n):
    scores, uids, labels, weights = _columns(n, seed=1)
    native, plain = str(tmp_path / "n.avro"), str(tmp_path / "p.avro")
    tio.save_scored_items(native, scores, "", uids=uids, labels=labels)
    tio.save_scored_items_records(plain, scores, "", uids=uids,
                                  labels=labels)
    assert tio.load_scored_items(native) == tio.load_scored_items(plain)


@pytest.mark.parametrize("with_uid,with_label,with_weight", COLUMNS[::3])
def test_record_stream_is_the_jax_encoders(with_uid, with_label,
                                           with_weight):
    scores, uids, labels, weights = _columns(500, seed=2)
    kw = dict(uids=uids if with_uid else None,
              labels=labels if with_label else None,
              weights=weights if with_weight else None)
    got = tnative.encode_scores_native(scores, "game-model", **kw)
    want = jnative.encode_scores_native(scores, "game-model", **kw)
    assert want is not None and got == want


def test_refused_block_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tio, "encode_scores_native", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="refused"):
        tio.save_scored_items(str(tmp_path / "s.avro"), np.zeros(3), "m")


def _re_case(seed, n=2_000, d=60, n_entities=30):
    rng = np.random.default_rng(seed)
    mat = sp.random(n, d, density=0.08, format="csr", random_state=seed,
                    dtype=np.float64)
    raw_ids = rng.integers(0, n_entities + 5, n)  # 5 ids without a model
    coefs = rng.normal(size=(n_entities, d)).astype(np.float32)
    return mat, raw_ids, coefs, np.arange(n_entities)


def _datasets(mat, raw_ids):
    out = []
    for cls in (GameDataset, JGameDataset):
        ds = cls(responses=np.zeros(mat.shape[0]),
                 feature_shards={"user": mat})
        ds.encode_ids("userId", np.asarray([f"e{i}" for i in raw_ids],
                                           dtype=object))
        out.append(ds)
    return out


@pytest.mark.parametrize("by", ["code", "raw_id"])
def test_random_effect_scores_in_onnz_equal_dense_and_jax(by):
    mat, raw_ids, coefs, codes = _re_case(3)
    tds, jds = _datasets(mat, raw_ids)
    # model rows by dataset code, or (a model read from disk) by raw id
    vocab = list(tds.id_vocabs["userId"])
    entity_ids = None
    if by == "raw_id":
        entity_ids = np.asarray([f"e{i}" for i in range(len(coefs))],
                                dtype=object)
    else:
        codes = np.asarray([vocab.index(f"e{i}") for i in range(len(coefs))
                            if f"e{i}" in vocab])
        coefs = coefs[:len(codes)]
    kw = dict(random_effect_type="userId", feature_shard_id="user",
              entity_codes=codes, entity_ids=entity_ids)
    tm = tmodels.RandomEffectModel(coefficients=torch.from_numpy(coefs),
                                   **kw)
    got = tm.score(tds, device="cpu").numpy()

    # the dense form the O(nnz) path replaced, on the same rows
    local = (tmodels._codes_via_ids(entity_ids, tds.id_vocabs["userId"],
                                    tds.id_columns["userId"])
             if by == "raw_id"
             else tmodels._match(codes, tds.id_columns["userId"]))
    padded = np.vstack([coefs, np.zeros((1, coefs.shape[1]), np.float32)])
    dense = tmodels.rowwise_sparse_dot(mat, padded[local])
    gathered = tmodels.rowwise_sparse_dot_gathered(mat, padded, local)
    assert gathered.dtype == dense.dtype == np.float64
    assert np.array_equal(gathered, dense)
    assert np.array_equal(got, dense.astype(np.float32))

    with jax.enable_x64(False):
        jm = jmodels.RandomEffectModel(coefficients=coefs, **kw)
        want = np.asarray(jm.score(jds))
    assert want.dtype == np.float32 and np.array_equal(got, want)
    # rows of the 5 ids without a model (cold start) score 0
    cold = raw_ids >= 30
    assert cold.any() and np.all(got[cold] == 0.0)
    assert np.any(got[~cold] != 0.0)


def test_random_effect_width_mismatch_raises():
    mat, raw_ids, coefs, codes = _re_case(4)
    tds, _ = _datasets(mat, raw_ids)
    tm = tmodels.RandomEffectModel(
        random_effect_type="userId", feature_shard_id="user",
        entity_codes=codes, coefficients=torch.from_numpy(coefs[:, :-1]))
    with pytest.raises(ValueError, match="inconsistent shapes"):
        tm.score(tds, device="cpu")
