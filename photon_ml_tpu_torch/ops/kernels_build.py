"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, all sources at once in parallel, under
``photon_ml_tpu_torch/_build/`` (listed in ``.gitignore``). A library's file
name carries a hash of its source and flags, so an edited source rebuilds
and an unchanged one is reused. Libraries are loaded with ``ctypes``;
pointers and the CUDA stream travel as ``c_void_p``. Nothing here touches
``torch.utils.cpp_extension``: a plain C interface builds in seconds.

A CUDA library's hash also covers the machine
(``utils/compile_cache.machine_fingerprint``: the ``nvcc`` version, the
card's compute capability, torch's version), so a build made for another
machine is never loaded; ``PHOTON_COMPILE_CACHE_DIR`` and
``PHOTON_DISABLE_COMPILE_CACHE`` move or bypass the cache.

The build is never attempted at import time — only the first kernel
launch (or an explicit :func:`build_all`) calls it. The hashed file name
and the compile-to-``.tmp``-then-rename step (:func:`cached_library`,
:func:`start_build`, :func:`finish_build`) are shared with the host
library of ``io/native_loader.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Sequence

from photon_ml_tpu_torch.utils import compile_cache

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_C = ctypes
_P = ctypes.c_void_p
#: ctypes signatures of every exported C function, by source stem.
SIGNATURES = {
    "fused_value_gradient": {
        "photon_fused_value_gradient": (
            _C.c_int,
            [_P, _C.c_int, _P, _P, _P, _P, _P, _C.c_longlong, _C.c_int,
             _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
             _P, _P, _P, _P, _P, _P, _P]),
        "photon_fused_vg_rows_per_tile": (_C.c_int, [_C.c_int]),
        "photon_cuda_error_string": (_C.c_char_p, [_C.c_int]),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": compile wall time (0.0 when reused), "log": ptxas}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            path = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(path):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built from csrc/ on first use")
    return path


def cached_library(stem: str, sources: Sequence[str],
                   flags: Sequence[str], salt: str = "") -> str:
    """Path in the build cache (:data:`BUILD_DIR` unless
    ``utils/compile_cache`` moves it) of the library built from
    ``sources`` with ``flags``: the file name carries a hash of the
    sources, the flags and ``salt``, so an edit rebuilds and an unchanged
    build is reused."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    h.update(salt.encode())
    return os.path.join(compile_cache.cache_dir(BUILD_DIR),
                        f"lib{stem}_{h.hexdigest()[:16]}.so")


def start_build(cmd: Sequence[str], out: str) -> tuple:
    """Start ``cmd`` followed by ``-o <tmp>``, where ``<tmp>`` is a
    per-process name beside ``out``: processes building the same
    library at once never write one file. :func:`finish_build` waits for it."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen([*cmd, "-o", tmp], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def finish_build(job: tuple, what: str) -> dict:
    """Wait for a :func:`start_build` job and rename its output into place;
    raises ``RuntimeError`` with the compiler's output when it failed.
    Returns ``{"seconds": compile wall time, "log": compiler output}``."""
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"build of {what} failed "
                           f"(rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return {"seconds": time.perf_counter() - t0, "log": log}


def _lib_path(name: str) -> str:
    return cached_library(name, [os.path.join(CSRC_DIR, name + ".cu")],
                          NVCC_FLAGS,
                          salt=compile_cache.machine_fingerprint(_nvcc()))


def build_all(names: Optional[list] = None) -> dict[str, ctypes.CDLL]:
    """Compile (in parallel, one ``nvcc`` per source) and load every kernel
    library not loaded yet; returns name -> ``ctypes.CDLL``."""
    names = list(SIGNATURES) if names is None else names
    from photon_ml_tpu_torch.obs import compile as obs_compile

    todo = [n for n in names if n not in _LIBS]
    jobs, causes = {}, {}
    t0 = time.perf_counter_ns()
    for name in todo:
        out = _lib_path(name)
        if os.path.exists(out):
            BUILD_INFO[name] = {"seconds": 0.0, "log": "reused " + out}
            continue
        causes[name] = obs_compile.library_cause(out)
        jobs[name] = start_build(
            [_nvcc(), *NVCC_FLAGS, os.path.join(CSRC_DIR, name + ".cu")],
            out)
    for name, job in jobs.items():
        BUILD_INFO[name] = finish_build(job, f"{name}.cu with nvcc")
        obs_compile.record_build(f"kernels.nvcc:{name}", causes[name], t0,
                                 compiler="nvcc")
    for name in todo:
        lib = ctypes.CDLL(_lib_path(name))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[name] = lib
    return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib
