"""Per-entity dimension reduction: index-map remap and random projection.

PyTorch-port copy of ``photon_ml_tpu/projector/projectors.py`` (numpy only;
the port keeps its own copy so it imports nothing of the JAX package).

TPU-native re-design of the reference's projector family
(reference: photon-ml/src/main/scala/com/linkedin/photon/ml/projector/ —
ProjectorType.scala:20-30 selects RandomProjection(d) / IndexMapProjection /
IdentityProjection; IndexMapProjector.scala:83-96 builds a compact remap from
the union of an entity's active feature keys; ProjectionMatrix.scala:90 draws
a shared Gaussian matrix).

Where the reference projects Breeze sparse vectors row-by-row inside Spark
closures, we express projection as array indexing so the random-effect stack
can hold every entity's reduced design matrix in one padded ``[E, N, D_red]``
tensor:

- **Index-map** projection per entity is a *gather*: a ``[D_red]`` int array of
  raw feature ids per entity (padded with ``dim`` pointing past the raw space
  so padded columns read 0 from a zero-extended source).
- **Random** projection is a matmul with a shared ``[D_raw, D_red]`` Gaussian
  matrix — an MXU-friendly op on device; at dataset-build time we apply it on
  host once.
- **Identity** keeps raw indices (D_red = D_raw).

Projected models map back to raw space with a *scatter* of the reduced
coefficients through the same index arrays
(RandomEffectModelInProjectedSpace.scala analog).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class ProjectorType(enum.Enum):
    """Mirrors projector/ProjectorType.scala:20-30."""

    INDEX_MAP = "INDEX_MAP"
    RANDOM = "RANDOM"
    IDENTITY = "IDENTITY"


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    """Parsed projector selection (``index_map`` | ``identity`` | ``random=K``)."""

    kind: ProjectorType = ProjectorType.INDEX_MAP
    projected_dim: int = 0  # only for RANDOM
    seed: int = 0

    @staticmethod
    def parse(s: str) -> "ProjectorConfig":
        t = s.strip().lower()
        if t in ("index_map", "indexmap", "index_map_projection"):
            return ProjectorConfig(ProjectorType.INDEX_MAP)
        if t in ("identity", "identity_projection"):
            return ProjectorConfig(ProjectorType.IDENTITY)
        if t.startswith("random"):
            # "random=64" or "random,64"
            for sep in ("=", ","):
                if sep in t:
                    return ProjectorConfig(
                        ProjectorType.RANDOM, projected_dim=int(t.split(sep)[1]))
            raise ValueError(f"random projector needs a dimension: {s!r}")
        raise ValueError(f"unknown projector type {s!r}")


@dataclasses.dataclass(frozen=True)
class IndexMapProjectors:
    """Per-entity compact feature remaps, batched.

    ``raw_indices[e, j]`` is the raw feature id of entity ``e``'s reduced
    column ``j``; columns ``j >= reduced_dims[e]`` are padded with
    ``raw_dim`` (one past the raw space — gather from a zero-extended raw
    vector yields 0, scatter there is dropped).

    Reference: projector/IndexMapProjectorRDD.scala:118 builds one
    IndexMapProjector per entity from the union of active feature keys
    (IndexMapProjector.scala:83-96); here the union/top-k selection happens at
    dataset build and the maps live as one ``[E, D_red]`` array.
    """

    raw_indices: np.ndarray  # [E, D_red] int32, padded with raw_dim
    reduced_dims: np.ndarray  # [E] int32: valid columns per entity
    raw_dim: int

    @property
    def num_entities(self) -> int:
        return self.raw_indices.shape[0]

    @property
    def max_reduced_dim(self) -> int:
        return self.raw_indices.shape[1]

    def project_row(self, entity: int, indices: np.ndarray,
                    values: np.ndarray) -> np.ndarray:
        """Project one sparse raw row into entity's reduced dense space."""
        out = np.zeros(self.max_reduced_dim, dtype=values.dtype if values.size
                       else np.float32)
        cols = self.raw_indices[entity]
        # host-side inverse lookup (build-time only)
        pos = {int(c): j for j, c in enumerate(cols) if c != self.raw_dim}
        for i, v in zip(indices, values):
            j = pos.get(int(i))
            if j is not None:
                out[j] = v
        return out

    def scatter_coefficients(self, reduced: np.ndarray) -> "ScatteredCoefs":
        """Map reduced coefficients [E, D_red] back to raw ids (sparse form)."""
        return ScatteredCoefs(self.raw_indices, reduced, self.raw_dim)


@dataclasses.dataclass(frozen=True)
class ScatteredCoefs:
    """Sparse raw-space view of projected per-entity coefficients."""

    raw_indices: np.ndarray  # [E, D_red]
    values: np.ndarray  # [E, D_red]
    raw_dim: int

    def dense(self) -> np.ndarray:
        """Densify to [E, raw_dim] (small raw spaces / tests only)."""
        e, _ = self.raw_indices.shape
        out = np.zeros((e, self.raw_dim + 1), dtype=np.asarray(self.values).dtype)
        rows = np.repeat(np.arange(e), self.raw_indices.shape[1])
        np.add.at(out, (rows, self.raw_indices.reshape(-1)),
                  np.asarray(self.values).reshape(-1))
        return out[:, : self.raw_dim]


def build_index_map_projectors(
    per_entity_feature_ids: list[np.ndarray],
    raw_dim: int,
    pad_to_multiple: int = 8,
) -> IndexMapProjectors:
    """Batch per-entity active-feature unions into one padded index array."""
    e = len(per_entity_feature_ids)
    d_red = max((len(ids) for ids in per_entity_feature_ids), default=1)
    d_red = max(1, -(-d_red // pad_to_multiple) * pad_to_multiple)
    raw_indices = np.full((e, d_red), raw_dim, dtype=np.int32)
    reduced_dims = np.zeros(e, dtype=np.int32)
    for i, ids in enumerate(per_entity_feature_ids):
        ids = np.asarray(sorted(int(x) for x in ids), dtype=np.int32)
        raw_indices[i, : len(ids)] = ids
        reduced_dims[i] = len(ids)
    return IndexMapProjectors(raw_indices, reduced_dims, raw_dim)


@dataclasses.dataclass(frozen=True)
class RandomProjector:
    """Shared Gaussian projection matrix (projector/ProjectionMatrix.scala:90).

    Entries ~ N(0, 1/projected_dim); one matrix shared by every entity
    (the reference broadcasts it, ProjectionMatrixBroadcast.scala:81 — here it
    is just an array, replicated in HBM when used on device).
    """

    matrix: np.ndarray  # [D_raw, D_red]

    @property
    def raw_dim(self) -> int:
        return self.matrix.shape[0]

    @property
    def projected_dim(self) -> int:
        return self.matrix.shape[1]

    def project_dense(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X) @ self.matrix

    def project_back(self, reduced_coefs: np.ndarray) -> np.ndarray:
        """Raw-space coefficients w_raw = P w_red (transpose map)."""
        return np.asarray(reduced_coefs) @ self.matrix.T


def build_random_projector(raw_dim: int, projected_dim: int,
                           seed: int = 0) -> RandomProjector:
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(projected_dim)
    m = rng.normal(scale=scale, size=(raw_dim, projected_dim)).astype(np.float32)
    return RandomProjector(m)
