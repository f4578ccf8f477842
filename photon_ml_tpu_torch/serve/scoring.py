"""Scoring core: feature maps, model load, the summed coordinate score.

Port of ``photon_ml_tpu/serve/scoring.py:58-107`` — ``resolve_index_maps``
(an off-heap store, else name-term set files, else the model files' own
maps), ``load_scoring_model``, ``materialize_model`` (projected and
factored random effects converted to raw space once, ``:86-100``; a model
read from disk holds raw ones already) and ``score_game_dataset``. The
always-on ``ServingScorer``, its tiered coefficient stores and the serve
plane come in a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from photon_ml_tpu_torch.game.models import (
    FactoredRandomEffectModel,
    GameModel,
    RandomEffectModelInProjectedSpace,
)
from photon_ml_tpu_torch.io.data_format import NameAndTermFeatureSets
from photon_ml_tpu_torch.io.feature_index_job import load_feature_index
from photon_ml_tpu_torch.io.model_io import load_game_model


def resolve_index_maps(section_keys: dict[str, list[str]],
                       intercept_map: dict[str, bool],
                       feature_set_path: Optional[str] = None,
                       offheap_dir: Optional[str] = None,
                       offheap_partitions: Optional[int] = None) -> dict:
    """Feature index maps for scoring, by precedence: the off-heap store of
    ``offheap_dir`` (one namespace per shard; a missing store fails), the
    name-term set files, else ``{}`` (``load_game_model`` then rebuilds
    them from the model files)."""
    index_maps: dict = {}
    if offheap_dir:
        index_maps.update(load_feature_index(
            offheap_dir, sorted(section_keys), offheap=True,
            expected_partitions=offheap_partitions))
    elif feature_set_path:
        all_sections = sorted({s for secs in section_keys.values()
                               for s in secs})
        sets = NameAndTermFeatureSets.load(feature_set_path, all_sections)
        for shard, sections in section_keys.items():
            index_maps[shard] = sets.index_map(
                sections, add_intercept=intercept_map.get(shard, True))
    return index_maps


def materialize_model(model: GameModel) -> GameModel:
    """The model with every projected or factored random effect converted
    to raw space once (``to_raw()`` is what their ``score`` does on every
    call); the scores are the same bit for bit."""
    return GameModel({
        cid: (m.to_raw() if isinstance(m, (RandomEffectModelInProjectedSpace,
                                           FactoredRandomEffectModel))
              else m)
        for cid, m in model.models.items()})


def load_scoring_model(model_dir: str, index_maps: Optional[dict]):
    """``(model, index_maps)`` ready to score."""
    return load_game_model(model_dir, index_maps or None)


def score_game_dataset(model: GameModel, data, device="cuda") -> np.ndarray:
    """The summed coordinate score of every row, fetched once."""
    return model.score(data, device=device).cpu().numpy()
