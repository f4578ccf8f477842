"""Feature index maps: (name, term) feature keys <-> dense column indices.

Port of ``photon_ml_tpu/io/index_map.py`` — the feature key helpers
(``feature_key``/``split_feature_key``, the intercept key
``"(INTERCEPT)\\u0001"``), ``stable_hash64`` (``:41-47``), the dict-backed
``IndexMap`` (util/IndexMap.scala:23-47, DefaultIndexMapLoader, the
IdentityIndexMapLoader's ``identity``) with its partitioned JSON store
(``save``/``load``/``save_offheap``, ``:108-148``), and the memmap-served
``OffHeapIndexMap`` (``:151-342``; the PalDB analog,
util/PalDBIndexMap.scala:43-160). The on-disk layouts are the JAX
package's, file for file, so each package reads the other's stores.
Loads run under the port's ``io.index_map`` fault point with
``call_with_retry``.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Iterable, Iterator, Optional

import numpy as np

from photon_ml_tpu_torch.utils.faults import fault_point
from photon_ml_tpu_torch.utils.retry import call_with_retry

DELIMITER = "\u0001"
INTERCEPT_NAME = "(INTERCEPT)"
INTERCEPT_TERM = ""
INTERCEPT_KEY = INTERCEPT_NAME + DELIMITER + INTERCEPT_TERM


def feature_key(name: str, term: str = "") -> str:
    """util/Utils.scala:56 getFeatureKey."""
    return f"{name}{DELIMITER}{term}"


def stable_hash64(key: str) -> int:
    """Process-stable 64-bit key hash (blake2b, 8 bytes, big-endian): it
    decides a key's on-disk partition, which Python's salted ``hash``
    cannot."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


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

    # -- partitioned on-disk store (PalDB analog) --------------------------

    def save(self, directory: str, num_partitions: int = 1,
             namespace: str = "global") -> None:
        """Hash-partitioned JSON shards (util/PalDBIndexMap layout analog:
        one store per partition, global index = local * partitions + id)."""
        os.makedirs(directory, exist_ok=True)
        parts: list[dict[str, int]] = [dict() for _ in range(num_partitions)]
        for k, v in self._fwd.items():
            parts[stable_hash64(k) % num_partitions][k] = v
        for p, d in enumerate(parts):
            with open(os.path.join(
                    directory, f"{namespace}-index-map-{p}.json"), "w") as fh:
                json.dump(d, fh)
        with open(os.path.join(directory, f"{namespace}-meta.json"), "w") as fh:
            json.dump({"numPartitions": num_partitions,
                       "size": len(self._fwd)}, fh)

    @staticmethod
    def load(directory: str, namespace: str = "global") -> "IndexMap":
        # transient-I/O retries, drillable at io.index_map; a feature map
        # is required state, so persistent failure surfaces as
        # RetryExhaustedError (the drivers' clean-abort path)
        def attempt():
            fault_point("io.index_map", tag=namespace)
            with open(os.path.join(directory,
                                   f"{namespace}-meta.json")) as fh:
                meta = json.load(fh)
            fwd: dict[str, int] = {}
            for p in range(meta["numPartitions"]):
                with open(os.path.join(
                        directory,
                        f"{namespace}-index-map-{p}.json")) as fh:
                    fwd.update(json.load(fh))
            return IndexMap(fwd)

        return call_with_retry(attempt, site="io.index_map")

    # -- off-heap conversion ----------------------------------------------

    def save_offheap(self, directory: str, num_partitions: int = 1,
                     namespace: str = "global") -> None:
        """Write this map as an :class:`OffHeapIndexMap` store."""
        OffHeapIndexMap.build(self.items(), directory,
                              num_partitions=num_partitions,
                              namespace=namespace)


class OffHeapIndexMap:
    """Memmap-backed feature index store: ``index_of`` without a dict.

    The PalDB role (util/PalDBIndexMap.scala:43-160): serve feature spaces
    too large for driver RAM, as hash-partitioned *sorted arrays* served
    by ``np.memmap`` + binary search — pages fault in on demand, nothing
    is materialized:

    - ``{ns}-part-{p}.hash.npy``    uint64[n_p], ascending ``stable_hash64``
    - ``{ns}-part-{p}.index.npy``   int64[n_p], global index per entry
    - ``{ns}-part-{p}.offsets.npy`` uint64[n_p+1] byte offsets into keys.bin
    - ``{ns}-part-{p}.keys.bin``    UTF-8 key bytes (hash order)
    - ``{ns}-part-{p}.byindex.npy`` int64[n_p], entry ids sorted by index
    - ``{ns}-offheap-meta.json``

    Lookups verify the actual key bytes, so 64-bit hash collisions cannot
    return a wrong index. Partition = ``stable_hash64(key) % partitions``
    (process-stable, unlike the salted builtin ``hash``).
    """

    def __init__(self, directory: str, namespace: str = "global",
                 expected_partitions: Optional[int] = None):
        self._dir = directory
        self._ns = namespace

        def read_meta():
            fault_point("io.index_map", tag=namespace)
            with open(os.path.join(
                    directory, f"{namespace}-offheap-meta.json")) as fh:
                return json.load(fh)

        meta = call_with_retry(read_meta, site="io.index_map")
        self._num_partitions = int(meta["numPartitions"])
        if (expected_partitions is not None
                and expected_partitions != self._num_partitions):
            # the reference requires the flag to "be consistent with the
            # number when offheap storage is built" (GAME Params.scala:406);
            # the meta file lets us enforce that instead of misreading
            raise ValueError(
                f"off-heap store {directory!r} ns={namespace!r} was built "
                f"with {self._num_partitions} partitions, but "
                f"{expected_partitions} were requested")
        self._size = int(meta["size"])
        self._intercept: Optional[int] = None
        self._intercept_probed = False
        p = range(self._num_partitions)
        self._hash = [self._mm(f"part-{i}.hash.npy") for i in p]
        self._index = [self._mm(f"part-{i}.index.npy") for i in p]
        self._offsets = [self._mm(f"part-{i}.offsets.npy") for i in p]
        self._keys = [np.memmap(
            os.path.join(directory, f"{namespace}-part-{i}.keys.bin"),
            dtype=np.uint8, mode="r")
            if os.path.getsize(os.path.join(
                directory, f"{namespace}-part-{i}.keys.bin")) else
            np.zeros(0, np.uint8) for i in p]
        self._byindex = [self._mm(f"part-{i}.byindex.npy") for i in p]

    def _mm(self, suffix: str) -> np.ndarray:
        return np.load(os.path.join(self._dir, f"{self._ns}-{suffix}"),
                       mmap_mode="r")

    # -- build -------------------------------------------------------------

    @staticmethod
    def build(items: Iterable[tuple[str, int]], directory: str,
              num_partitions: int = 1, namespace: str = "global"
              ) -> "OffHeapIndexMap":
        """Single-pass spill build: every (key, index) is appended straight
        to its hash partition's spill files, then each partition is sorted
        and finalized alone — peak memory is O(largest partition), never
        O(total keys) (the PalDB per-partition writer analog,
        FeatureIndexingJob.buildIndexMap :145)."""
        os.makedirs(directory, exist_ok=True)
        meta_fhs, key_fhs = [], []
        for p in range(num_partitions):
            pre = os.path.join(directory, f"{namespace}-part-{p}")
            meta_fhs.append(open(f"{pre}.spill.meta", "wb"))
            key_fhs.append(open(f"{pre}.spill.keys", "wb"))
        total = 0
        pack = struct.Struct("<QqI").pack  # hash u64, index i64, keylen u32
        try:
            for k, v in items:
                kb = k.encode("utf-8")
                h = stable_hash64(k)
                p = h % num_partitions
                meta_fhs[p].write(pack(h, v, len(kb)))
                key_fhs[p].write(kb)
                total += 1
        finally:
            for fh in meta_fhs + key_fhs:
                fh.close()

        meta_dtype = np.dtype(
            [("h", "<u8"), ("i", "<i8"), ("l", "<u4")])
        for p in range(num_partitions):
            pre = os.path.join(directory, f"{namespace}-part-{p}")
            with open(f"{pre}.spill.meta", "rb") as fh:
                meta = np.frombuffer(fh.read(), dtype=meta_dtype)
            with open(f"{pre}.spill.keys", "rb") as fh:
                key_bytes = np.frombuffer(fh.read(), dtype=np.uint8)
            in_offs = np.zeros(len(meta) + 1, dtype=np.uint64)
            np.cumsum(meta["l"], out=in_offs[1:])
            order = np.argsort(meta["h"], kind="stable")
            lens = meta["l"][order].astype(np.uint64)
            offs = np.zeros(len(meta) + 1, dtype=np.uint64)
            np.cumsum(lens, out=offs[1:])
            np.save(f"{pre}.hash.npy", meta["h"][order])
            np.save(f"{pre}.index.npy", meta["i"][order].astype(np.int64))
            np.save(f"{pre}.offsets.npy", offs)
            np.save(f"{pre}.byindex.npy",
                    np.argsort(meta["i"][order], kind="stable"))
            # reorder the variable-length key bytes into hash order with
            # one vectorized gather (no per-key Python loop)
            ln = lens.astype(np.int64)
            seg_src = in_offs[:-1][order].astype(np.int64)
            seg = np.repeat(np.arange(len(order)), ln)
            rank = (np.arange(int(offs[-1]), dtype=np.int64)
                    - np.repeat(offs[:-1].astype(np.int64), ln))
            with open(f"{pre}.keys.bin", "wb") as fh:
                fh.write(key_bytes[seg_src[seg] + rank].tobytes())
            os.remove(f"{pre}.spill.meta")
            os.remove(f"{pre}.spill.keys")
        with open(os.path.join(
                directory, f"{namespace}-offheap-meta.json"), "w") as fh:
            json.dump({"numPartitions": num_partitions, "size": total,
                       "format": "photon-offheap-v1"}, fh)
        return OffHeapIndexMap(directory, namespace)

    # -- IndexMap interface ------------------------------------------------

    def __len__(self) -> int:
        return self._size

    def _entry_key_bytes(self, p: int, e: int) -> bytes:
        lo, hi = int(self._offsets[p][e]), int(self._offsets[p][e + 1])
        return self._keys[p][lo:hi].tobytes()

    def index_of(self, key: str) -> int:
        """-1 when absent (IndexMap.getIndex convention)."""
        h = np.uint64(stable_hash64(key))
        p = int(h % np.uint64(self._num_partitions))
        ha = self._hash[p]
        lo = int(np.searchsorted(ha, h, side="left"))
        kb = key.encode("utf-8")
        for e in range(lo, len(ha)):
            if ha[e] != h:
                break
            if self._entry_key_bytes(p, e) == kb:
                return int(self._index[p][e])
        return -1

    def __contains__(self, key: str) -> bool:
        return self.index_of(key) >= 0

    def key_of(self, index: int) -> Optional[str]:
        for p in range(self._num_partitions):
            by = self._byindex[p]
            idx = self._index[p]
            # manual binary search: O(log n) memmap touches, never the
            # whole array (np.searchsorted over idx[by] would gather it)
            lo, hi = 0, len(by)
            while lo < hi:
                mid = (lo + hi) // 2
                if int(idx[int(by[mid])]) < index:
                    lo = mid + 1
                else:
                    hi = mid
            if lo < len(by) and int(idx[int(by[lo])]) == index:
                return self._entry_key_bytes(p, int(by[lo])).decode("utf-8")
        return None

    def items(self) -> Iterator[tuple[str, int]]:
        for p in range(self._num_partitions):
            idx = self._index[p]
            for e in range(len(idx)):
                yield (self._entry_key_bytes(p, e).decode("utf-8"),
                       int(idx[e]))

    @property
    def intercept_index(self) -> Optional[int]:
        if not self._intercept_probed:
            i = self.index_of(INTERCEPT_KEY)
            self._intercept = None if i < 0 else i
            self._intercept_probed = True
        return self._intercept
