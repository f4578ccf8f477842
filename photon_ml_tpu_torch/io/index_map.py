"""Feature index maps: (name, term) feature keys <-> dense column indices.

Port of the in-RAM half of ``photon_ml_tpu/io/index_map.py`` — the feature
key helpers (``feature_key``/``split_feature_key``, the intercept key
``"(INTERCEPT)\\u0001"``) and the dict-backed ``IndexMap``
(util/IndexMap.scala:23-47, DefaultIndexMapLoader, and the
IdentityIndexMapLoader's ``identity``). The partitioned JSON
store and the memmap-backed ``OffHeapIndexMap`` (the PalDB analog) come
with ``--offheap-indexmap-dir`` in a later slice.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

DELIMITER = "\u0001"
INTERCEPT_NAME = "(INTERCEPT)"
INTERCEPT_TERM = ""
INTERCEPT_KEY = INTERCEPT_NAME + DELIMITER + INTERCEPT_TERM


def feature_key(name: str, term: str = "") -> str:
    """util/Utils.scala:56 getFeatureKey."""
    return f"{name}{DELIMITER}{term}"


def split_feature_key(key: str) -> tuple[str, str]:
    """util/Utils.scala:66,80 getFeatureName/TermFromKey."""
    name, _, term = key.partition(DELIMITER)
    return name, term


class IndexMap:
    """Bidirectional (featureKey <-> index) map (util/IndexMap.scala:23-47)."""

    def __init__(self, key_to_index: dict[str, int]):
        self._fwd = dict(key_to_index)
        self._rev: Optional[dict[int, str]] = None

    def __len__(self) -> int:
        return len(self._fwd)

    def __contains__(self, key: str) -> bool:
        return key in self._fwd

    def index_of(self, key: str) -> int:
        """-1 when absent (IndexMap.getIndex convention)."""
        return self._fwd.get(key, -1)

    def key_of(self, index: int) -> Optional[str]:
        if self._rev is None:
            self._rev = {v: k for k, v in self._fwd.items()}
        return self._rev.get(index)

    def items(self) -> Iterator[tuple[str, int]]:
        return iter(self._fwd.items())

    @property
    def intercept_index(self) -> Optional[int]:
        i = self.index_of(INTERCEPT_KEY)
        return None if i < 0 else i

    @staticmethod
    def from_keys(keys: Iterable[str], add_intercept: bool = False
                  ) -> "IndexMap":
        """Sorted distinct keys, the intercept appended last when asked."""
        uniq = sorted(set(keys))
        if add_intercept and INTERCEPT_KEY not in uniq:
            uniq.append(INTERCEPT_KEY)
        return IndexMap({k: i for i, k in enumerate(uniq)})

    @staticmethod
    def identity(dim: int) -> "IndexMap":
        """IdentityIndexMapLoader analog: key ``str(i)`` <-> index i
        (LibSVM inputs)."""
        return IndexMap({str(i): i for i in range(dim)})

    @staticmethod
    def from_name_terms(pairs: Iterable[tuple[str, str]],
                        add_intercept: bool = False) -> "IndexMap":
        return IndexMap.from_keys(
            (feature_key(n, t) for n, t in pairs), add_intercept)
