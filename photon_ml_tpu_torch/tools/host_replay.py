"""Replay edge inputs through the four entry points of the host library.

The port of the JAX package's sanitizer replay (``tests/
test_native_sanitize.py`` ``_replay_packers`` and its decode corpus): the
two block packers with ragged, empty and pad-sentinel inputs, the score
encoder with every nullable-field combination (zero rows included), the
LibSVM parser on a corpus of well-formed and malformed files, and the
columnar Avro decoder on a container truncated at every offset and with
single bytes flipped. Well-formed inputs must decode to the expected
values; malformed ones may raise a Python exception but must not touch
memory out of bounds. Imports no ``jax``.

Run it against the ASan+UBSan build of ``io/native_loader.build_sanitized``
in a process of its own:

    PHOTON_TORCH_HOST_LIB=<sanitized .so> LD_PRELOAD=<libasan.so> \\
        python -m photon_ml_tpu_torch.tools.host_replay <workdir>

It prints ``host-replay-ok`` and exits 0; the sanitizer aborts the
process at its first report (``-fno-sanitize-recover=all``).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import scipy.sparse as sp

from photon_ml_tpu_torch.io import native_avro
from photon_ml_tpu_torch.io import native_loader as nl
from photon_ml_tpu_torch.io.avro import write_container

LIBSVM_CORPUS = {
    "plain": b"+1 1:0.5 3:-2\n-1 2:1e-3\n",
    "empty": b"",
    "blank_lines": b"\n\n+1 1:1\n\n",
    "no_newline": b"-1 4:2.5",
    "label_only": b"+1\n-1\n",
    "duplicates": b"+1 2:1 2:3 1:1\n",
    "crlf": b"+1 1:1\r\n-1 2:2\r\n",
    "tabs": b"+1\t1:1\t2:2\n",
    "zero_index": b"+1 0:1 1:2\n",
    "huge_index": b"+1 2147483647:1\n",
    "overflow_index": b"+1 99999999999999999999:1\n",
    "bad_value": b"+1 1:abc\n",
    "bad_pair": b"+1 1-2\n",
    "missing_value": b"+1 1:\n",
    "bad_label": b"x 1:1\n",
    "long_line": b"+1 " + b" ".join(b"%d:1" % i for i in range(1, 5000))
    + b"\n",
}

_SCHEMA = {
    "name": "GameRecord", "type": "record", "namespace": "replay",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "response", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
        {"name": "features", "type": {"type": "array", "items": {
            "name": "NameTermValue", "type": "record",
            "fields": [{"name": "name", "type": "string"},
                       {"name": "term", "type": "string"},
                       {"name": "value", "type": "double"}]}}},
    ]}


def replay_packers(rng: np.random.Generator) -> None:
    """Ragged and empty ELL rows; projected rows through pad-sentinel
    tables, with columns absent from a table skipped."""
    for n, d in ((1, 1), (200, 50), (5, 3)):
        rows, cols, vals = [], [], []
        for i in range(n):
            for _ in range(int(rng.integers(0, 9))):
                rows.append(i)
                cols.append(int(rng.integers(0, d)))
                vals.append(float(rng.random()))
        mat = sp.csr_matrix((vals, (rows, cols)), shape=(n, d))
        mat.sum_duplicates()
        k = max(int(np.diff(mat.indptr).max(initial=0)), 1)
        idx = np.zeros((n, k), np.int32)
        val = np.zeros((n, k), np.float32)
        nl.pack_ell_native(mat.indptr, mat.indices, mat.data, k, idx, val)
        for i in range(n):
            lo, hi = mat.indptr[i], mat.indptr[i + 1]
            assert np.array_equal(idx[i, :hi - lo], mat.indices[lo:hi])
    n_rows, d, n_tables, d_red = 64, 40, 5, 8
    mat = sp.random(n_rows, d, density=0.25, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(3))
    raw = np.full((n_tables, d_red), np.iinfo(np.int32).max, np.int32)
    for t in range(n_tables):
        width = int(rng.integers(1, d_red + 1))
        raw[t, :width] = np.sort(rng.choice(d, size=width, replace=False))
    out = np.zeros((n_rows, d_red), np.float32)
    nl.pack_projected_rows_native(
        mat, rng.integers(0, n_tables, n_rows), np.arange(n_rows), raw, out)
    empty = sp.csr_matrix((0, d), dtype=np.float32)
    nl.pack_projected_rows_native(empty, np.zeros(0, np.int64),
                                  np.zeros(0, np.int64), raw,
                                  np.zeros((1, d_red), np.float32))


def replay_scores(rng: np.random.Generator) -> None:
    for n in (0, 1, 33):
        scores = rng.normal(size=n)
        for uids in (None, [f"user-{i}" for i in range(n)]):
            for labels in (None, rng.normal(size=n)):
                for weights in (None, rng.random(n)):
                    blob = nl.encode_scores_native(
                        scores, "model-1", uids=uids, labels=labels,
                        weights=weights)
                    assert blob is not None


def replay_libsvm(workdir: str) -> None:
    for name, text in LIBSVM_CORPUS.items():
        path = os.path.join(workdir, name + ".libsvm")
        with open(path, "wb") as fh:
            fh.write(text)
        for zero_based in (False, True):
            try:
                nl.parse_libsvm_native(path, zero_based)
            except ValueError:
                pass
    labels, mat, dim = nl.parse_libsvm_native(
        os.path.join(workdir, "plain.libsvm"), False)
    # one-based indices: column j - 1
    assert list(labels) == [1.0, -1.0] and dim == 3
    assert mat.toarray().tolist() == [[0.5, 0.0, -2.0], [0.0, 1e-3, 0.0]]


def replay_avro(workdir: str, rng: np.random.Generator) -> None:
    """A small container decoded whole, then truncated at every offset
    and with single bytes flipped."""
    records = [{"uid": None if i % 3 == 0 else f"u{i}",
                "response": float(i % 2),
                "weight": None if i % 2 else 1.5,
                "metadataMap": {"userId": f"user{i % 4}"} if i % 5 else None,
                "features": [{"name": f"f{j}", "term": "t" * (j % 2),
                              "value": float(rng.normal())}
                             for j in range(i % 4)]}
               for i in range(40)]
    path = os.path.join(workdir, "part-00000.avro")
    write_container(path, _SCHEMA, records, sync_interval=7)
    decoded = native_avro.read_columnar(path)
    assert decoded is not None and decoded[1] == len(records)
    data = open(path, "rb").read()
    broken = os.path.join(workdir, "broken.avro")
    cases = [data[:cut] for cut in range(len(data))]
    for pos in rng.choice(len(data), size=min(len(data), 300),
                          replace=False):
        flipped = bytearray(data)
        flipped[pos] ^= 0xFF
        cases.append(bytes(flipped))
    for blob in cases:
        with open(broken, "wb") as fh:
            fh.write(blob)
        try:
            native_avro.read_columnar(broken)
        except Exception:  # a refusal is fine; an overrun aborts
            pass


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.exit("usage: python -m photon_ml_tpu_torch.tools.host_replay "
                 "<workdir>")
    workdir = argv[0]
    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(7)
    nl.get_host_lib()
    replay_packers(rng)
    replay_scores(rng)
    replay_libsvm(workdir)
    replay_avro(workdir, rng)
    print("host-replay-ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
