"""Build and load the port's host library (``csrc/host/*.cpp``) on first use.

Port of ``photon_ml_tpu/io/native_loader.py``: ``get_native_lib`` becomes
:func:`get_host_lib`, and ``pack_ell_native``/``pack_projected_rows_native``
(``:149-213``), ``parse_libsvm_native`` (``:216-247``) and
``encode_scores_native`` (``:250-295``) are ported with their shape
checks. The sources are the port's own copies of the JAX package's
columnar Avro decoder, ScoringResultAvro encoder, LibSVM parser and
entity-block packer. ``g++`` compiles them into one shared library under
the git-ignored ``photon_ml_tpu_torch/_build/``, with the reference
Makefile's flags, through the build helpers of ``ops/kernels_build.py``:
the file name carries a hash of the sources, the flags and the host, and
processes building it at once write per-process ``.tmp`` files that are
renamed into place.

Unlike the reference there is no fallback: a missing compiler, a failed
build or a library that does not load raises ``RuntimeError`` (with the
compiler's output), nothing disables the library, and the packers return
nothing to fall back on. :func:`build_sanitized` builds the same sources
with ASan+UBSan and ``-fno-sanitize-recover=all`` into a file of its own
(the reference Makefile's ``sanitize`` target); a process started with
``PHOTON_TORCH_HOST_LIB`` set to that file loads it instead of the
optimized build (the sanitizer replay,
``photon_ml_tpu_torch/tools/host_replay.py``).
"""

from __future__ import annotations

import ctypes
import os
import platform
import shutil
import threading
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp

from photon_ml_tpu_torch.ops import kernels_build

HOST_DIR = os.path.join(kernels_build.CSRC_DIR, "host")
HOST_SOURCES = ("avro_columnar.cpp", "score_encoder.cpp",
                "libsvm_parser.cpp", "block_packer.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-shared")
SANITIZE_FLAGS = ("-O1", "-g", "-std=c++17", "-fPIC", "-pthread", "-shared",
                  "-fno-omit-frame-pointer", "-fsanitize=address,undefined",
                  "-fno-sanitize-recover=all")
#: a prebuilt host library to load instead of the optimized build
ENV_HOST_LIB = "PHOTON_TORCH_HOST_LIB"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: {"seconds": compile wall time (0.0 when reused), "log": g++ output}
BUILD_INFO: dict = {}


def _library_path(stem: str = "photon_host", flags=CXX_FLAGS) -> str:
    # -march=native code runs on the host that built it: the host is part
    # of the key, so a build directory copied to another machine rebuilds
    return kernels_build.cached_library(
        stem, [os.path.join(HOST_DIR, s) for s in HOST_SOURCES],
        flags, salt=f"{platform.node()}/{platform.machine()}")


def _build(out: str, flags, what: str) -> dict:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the port's host library is "
            "built from csrc/host/ on first use")
    job = kernels_build.start_build(
        [cxx, *flags, *(os.path.join(HOST_DIR, s) for s in HOST_SOURCES)],
        out)
    return kernels_build.finish_build(job, what)


def build_sanitized() -> str:
    """Path of the ASan+UBSan build of the host sources, compiled when it
    is missing; raises ``RuntimeError`` when the build fails."""
    out = _library_path("photon_host_sanitize", SANITIZE_FLAGS)
    if not os.path.exists(out):
        _build(out, SANITIZE_FLAGS, "csrc/host/*.cpp with ASan+UBSan")
    return out


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


def _bind_packers(lib: ctypes.CDLL) -> None:
    nd = np.ctypeslib.ndpointer
    lib.photon_pack_projected_rows.restype = ctypes.c_int
    lib.photon_pack_projected_rows.argtypes = [
        ctypes.c_int64,
        nd(np.int64, flags="C_CONTIGUOUS"),
        nd(np.int32, flags="C_CONTIGUOUS"),
        nd(np.float32, flags="C_CONTIGUOUS"),
        nd(np.int64, flags="C_CONTIGUOUS"),
        nd(np.int64, flags="C_CONTIGUOUS"),
        nd(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        nd(np.float32, flags="C_CONTIGUOUS"),
    ]
    lib.photon_pack_ell.restype = ctypes.c_int
    lib.photon_pack_ell.argtypes = [
        ctypes.c_int64,
        nd(np.int64, flags="C_CONTIGUOUS"),
        nd(np.int32, flags="C_CONTIGUOUS"),
        nd(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        nd(np.int32, flags="C_CONTIGUOUS"),
        nd(np.float32, flags="C_CONTIGUOUS"),
    ]


def get_host_lib() -> ctypes.CDLL:
    """The loaded host library, compiled with ``g++`` on first use (or
    the prebuilt file ``PHOTON_TORCH_HOST_LIB`` names); raises
    ``RuntimeError`` when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = os.environ.get(ENV_HOST_LIB) or _library_path()
        if os.path.exists(out):
            BUILD_INFO.update(seconds=0.0, log="reused " + out)
        elif os.environ.get(ENV_HOST_LIB):
            raise RuntimeError(f"{ENV_HOST_LIB}={out} does not exist")
        else:
            from photon_ml_tpu_torch.obs import compile as obs_compile

            cause = obs_compile.library_cause(out)
            t0 = time.perf_counter_ns()
            BUILD_INFO.update(_build(out, CXX_FLAGS,
                                     "csrc/host/*.cpp with g++"))
            obs_compile.record_build("host.gxx:photon_host", cause, t0,
                                     compiler="g++")
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            raise RuntimeError(f"cannot load the host library {out}: "
                               f"{e}") from e
        _bind_scores(lib)
        _bind_libsvm(lib)
        _bind_packers(lib)
        _lib = lib
        return _lib


def pack_ell_native(indptr: np.ndarray, indices: np.ndarray,
                    data: np.ndarray, k: int, out_idx: np.ndarray,
                    out_val: np.ndarray) -> None:
    """CSR -> fixed-width ELL planes (``photon_pack_ell``). Both outputs
    must be zeroed C-contiguous ``[n, k]``; raises ``ValueError`` for a
    shape the C loop would overrun, a row longer than ``k`` or any other
    refusal."""
    lib = get_host_lib()
    n = len(indptr) - 1
    for a in (out_idx, out_val):
        if not a.flags.c_contiguous:
            raise ValueError("ELL outputs must be C-contiguous")
        if a.shape != (n, k):
            # the C loop strides r*k through the buffer
            raise ValueError(f"ELL output shape {a.shape} != ({n}, {k})")
    nnz = int(indptr[-1]) if len(indptr) else 0
    if len(indices) < nnz or len(data) < nnz:
        raise ValueError("indices/data shorter than indptr[-1]")
    rc = lib.photon_pack_ell(
        n, np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(data, np.float32), k,
        out_idx.reshape(-1), out_val.reshape(-1))
    if rc != 0:
        raise ValueError(f"native ELL pack failed with code {rc}")


def pack_projected_rows_native(sub, table_of: np.ndarray,
                               out_row_of: np.ndarray,
                               raw_indices: np.ndarray,
                               out: np.ndarray) -> None:
    """Stream ``sub``'s (CSR) stored elements into ``out`` rows through
    per-entity sorted feature tables (``photon_pack_projected_rows``):
    row ``r`` goes to flat row ``out_row_of[r]`` through table
    ``table_of[r]``; columns absent from the table are skipped. ``out`` is
    a zeroed C-contiguous f32 array whose last axis is the tables' width
    ``d_red``; ``raw_indices [n_tables, d_red]`` ascending with pad
    sentinels. Raises ``ValueError`` on a shape or index the C loop
    refuses."""
    lib = get_host_lib()
    indptr = np.ascontiguousarray(sub.indptr, np.int64)
    indices = np.ascontiguousarray(sub.indices, np.int32)
    data = np.ascontiguousarray(sub.data, np.float32)
    table_of = np.ascontiguousarray(table_of, np.int64)
    out_row_of = np.ascontiguousarray(out_row_of, np.int64)
    raw_indices = np.ascontiguousarray(raw_indices, np.int32)
    n_tables, d_red = raw_indices.shape
    if not out.flags.c_contiguous:
        # a reshape of a non-contiguous array copies: the writes would
        # land in the discarded temporary
        raise ValueError("out must be C-contiguous")
    flat = out.reshape(-1, out.shape[-1])
    if flat.shape[1] != d_red:
        raise ValueError(
            f"out last dim {flat.shape[1]} != table width {d_red}")
    if len(table_of) != sub.shape[0] or len(out_row_of) != sub.shape[0]:
        raise ValueError("table_of/out_row_of need one entry per row")
    rc = lib.photon_pack_projected_rows(
        sub.shape[0], indptr, indices, data, table_of, out_row_of,
        raw_indices, n_tables, d_red, flat.shape[0], flat)
    if rc != 0:
        raise ValueError(f"native block pack failed with code {rc}")


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
