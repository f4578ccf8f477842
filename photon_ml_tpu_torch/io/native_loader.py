"""Build and load the port's host library (``csrc/host/*.cpp``) on first use.

Port of ``photon_ml_tpu/io/native_loader.py`` for what the GAME ingest,
the scoring paths and the legacy LibSVM loader run: ``get_native_lib``
becomes :func:`get_host_lib`, and ``parse_libsvm_native`` (``:216-247``)
and ``encode_scores_native`` (``:250-295``) are ported as they are. The
sources are the port's own copies of the JAX package's columnar Avro
decoder, ScoringResultAvro encoder and LibSVM parser. ``g++`` compiles both into one
shared library under the git-ignored ``photon_ml_tpu_torch/_build/``,
with the reference Makefile's flags, through the build helpers of
``ops/kernels_build.py``: the file name carries a hash of the sources,
the flags and the host, and processes building it at once write
per-process ``.tmp`` files that are renamed into place.

Unlike the reference there is no fallback: a missing compiler, a failed
build or a library that does not load raises ``RuntimeError`` (with the
compiler's output), and nothing disables the library. The block packer
and the sanitizer build are not ported yet.
"""

from __future__ import annotations

import ctypes
import os
import platform
import shutil
import threading
from typing import Optional

import numpy as np
import scipy.sparse as sp

from photon_ml_tpu_torch.ops import kernels_build

HOST_DIR = os.path.join(kernels_build.CSRC_DIR, "host")
HOST_SOURCES = ("avro_columnar.cpp", "score_encoder.cpp",
                "libsvm_parser.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: {"seconds": compile wall time (0.0 when reused), "log": g++ output}
BUILD_INFO: dict = {}


def _library_path() -> str:
    # -march=native code runs on the host that built it: the host is part
    # of the key, so a build directory copied to another machine rebuilds
    return kernels_build.cached_library(
        "photon_host", [os.path.join(HOST_DIR, s) for s in HOST_SOURCES],
        CXX_FLAGS, salt=f"{platform.node()}/{platform.machine()}")


def _bind_scores(lib: ctypes.CDLL) -> None:
    f = lib.photon_encode_scores
    f.restype = ctypes.c_int64
    f.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_void_p,  # labels (nullable)
        ctypes.c_void_p,  # weights (nullable)
        ctypes.c_void_p,  # uid arena (nullable)
        ctypes.c_void_p,  # uid offsets (nullable)
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
    ]


def _bind_libsvm(lib: ctypes.CDLL) -> None:
    lib.photon_libsvm_open.restype = ctypes.c_void_p
    lib.photon_libsvm_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.photon_libsvm_fill.restype = ctypes.c_int
    lib.photon_libsvm_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.POINTER(ctypes.c_int64)]
    lib.photon_libsvm_close.restype = None
    lib.photon_libsvm_close.argtypes = [ctypes.c_void_p]


def get_host_lib() -> ctypes.CDLL:
    """The loaded host library, compiled with ``g++`` on first use;
    raises ``RuntimeError`` when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = _library_path()
        if os.path.exists(out):
            BUILD_INFO.update(seconds=0.0, log="reused " + out)
        else:
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError(
                    "g++ not found on PATH: the port's host library is "
                    "built from csrc/host/ on first use")
            job = kernels_build.start_build(
                [cxx, *CXX_FLAGS,
                 *(os.path.join(HOST_DIR, s) for s in HOST_SOURCES)], out)
            BUILD_INFO.update(kernels_build.finish_build(
                job, "csrc/host/*.cpp with g++"))
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            raise RuntimeError(f"cannot load the host library {out}: "
                               f"{e}") from e
        _bind_scores(lib)
        _bind_libsvm(lib)
        _lib = lib
        return _lib


def parse_libsvm_native(path: str, zero_based: bool
                        ) -> tuple[np.ndarray, sp.csr_matrix, int]:
    """(raw labels, CSR without the intercept column, max index + 1) of
    one LibSVM file (``csrc/host/libsvm_parser.cpp``); raises
    ``ValueError`` for a file it cannot open or parse."""
    lib = get_host_lib()
    rows = ctypes.c_int64()
    nnz = ctypes.c_int64()
    handle = lib.photon_libsvm_open(path.encode(), ctypes.byref(rows),
                                    ctypes.byref(nnz))
    if not handle:
        raise ValueError(f"native libsvm parser cannot open {path!r}")
    try:
        n, k = rows.value, nnz.value
        labels = np.empty(n, np.float64)
        indptr = np.empty(n + 1, np.int64)
        indices = np.empty(max(k, 1), np.int32)
        values = np.empty(max(k, 1), np.float64)
        max_index = ctypes.c_int64()
        rc = lib.photon_libsvm_fill(handle, int(zero_based), labels, indptr,
                                    indices, values,
                                    ctypes.byref(max_index))
    finally:
        lib.photon_libsvm_close(handle)
    if rc != 0:
        raise ValueError(
            f"native libsvm parse of {path!r} failed with code {rc}")
    dim = int(max_index.value) + 1
    mat = sp.csr_matrix((values[:k], indices[:k], indptr),
                        shape=(n, max(dim, 0)))
    return labels, mat, dim


def encode_scores_native(scores: np.ndarray, model_id: str,
                         uids=None, labels=None,
                         weights=None) -> Optional[bytes]:
    """ScoringResultAvro record stream for a whole block
    (``csrc/host/score_encoder.cpp``); None when the encoder refuses the
    buffer (it should not, with the exact capacity computed here)."""
    lib = get_host_lib()
    scores = np.ascontiguousarray(scores, np.float64)
    n = len(scores)

    def vp(a):
        return (None if a is None
                else a.ctypes.data_as(ctypes.c_void_p))

    labels_a = (None if labels is None
                else np.ascontiguousarray(labels, np.float64))
    weights_a = (None if weights is None
                 else np.ascontiguousarray(weights, np.float64))
    uid_arena = uid_offsets = None
    uid_bytes = 0
    if uids is not None:
        encoded = [str(u).encode("utf-8") for u in uids]
        uid_offsets = np.zeros(n + 1, np.uint32)
        np.cumsum([len(b) for b in encoded], out=uid_offsets[1:])
        uid_arena = np.frombuffer(b"".join(encoded), np.uint8)
        if uid_arena.size == 0:
            uid_arena = np.zeros(1, np.uint8)
        uid_bytes = int(uid_offsets[-1])
    mid = model_id.encode("utf-8")
    mid_arr = np.frombuffer(mid, np.uint8)
    if mid_arr.size == 0:
        mid_arr = np.zeros(1, np.uint8)
    # worst case per record: 5-byte length varints for uid and modelId
    # plus all value bytes; every byte up to `written` is overwritten so
    # the buffer needs no zero-fill
    cap = n * (38 + len(mid)) + uid_bytes + 64
    out = np.empty(cap, np.uint8)
    written = lib.photon_encode_scores(
        n, scores, vp(labels_a), vp(weights_a), vp(uid_arena),
        vp(uid_offsets), mid_arr, len(mid), out, cap)
    if written < 0:
        return None
    return out[:written].tobytes()
