"""The port's block packer (``csrc/host/block_packer.cpp``) against the
numpy scatter and the JAX package's native packer, its shape checks, and
the sanitizer replay of the host library.

- ``pack_ell_native`` fills the planes ``ell_planes_numpy`` fills (ragged,
  empty and full rows), and those of the JAX package's ``pack_ell_native``.
- ``pack_projected_rows_native`` fills the block the numpy
  ``_project_nnz`` scatter fills (columns outside an entity's table
  skipped, pad sentinels never matched), and the JAX package's block.
- Both refuse an output the C loop would overrun or a row/table index
  out of range with ``ValueError``; nothing returns ``False``.
- The ASan+UBSan build (``native_loader.build_sanitized``) replays the
  edge inputs of ``tools/host_replay.py`` in a subprocess that imports no
  ``jax``; it skips, with the reason, where ``g++`` cannot build with
  the sanitizers or ``libasan`` cannot be found.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from photon_ml_tpu.io import native_loader as jnl
from photon_ml_tpu_torch.data.batch import ell_planes_numpy
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.io import native_loader as tnl
from photon_ml_tpu_torch.projector.projectors import IndexMapProjectors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ragged(n, d, seed, max_len=9):
    r = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        k = int(r.integers(0, max_len)) if i % 4 else 0
        for j in r.choice(d, size=min(k, d), replace=False):
            rows.append(i)
            cols.append(int(j))
            vals.append(float(r.normal()))
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(n, d))
    mat.sum_duplicates()
    return mat


@pytest.mark.parametrize("n,d,pad", [(1, 1, 0), (300, 60, 0), (300, 60, 3),
                                     (40, 5000, 8)])
def test_ell_pack_matches_numpy_and_jax(n, d, pad):
    mat = _ragged(n, d, seed=n + d)
    k = max(int(np.diff(mat.indptr).max(initial=0)), 1) + pad
    idx = np.zeros((n, k), np.int32)
    val = np.zeros((n, k), np.float32)
    assert tnl.pack_ell_native(mat.indptr, mat.indices, mat.data, k, idx,
                               val) is None
    want_idx, want_val = ell_planes_numpy(mat, k)
    assert np.array_equal(idx, want_idx) and np.array_equal(val, want_val)
    jidx = np.zeros((n, k), np.int32)
    jval = np.zeros((n, k), np.float32)
    if jnl.pack_ell_native(mat.indptr, mat.indices, mat.data, k, jidx,
                           jval):
        assert np.array_equal(idx, jidx) and np.array_equal(val, jval)


def _projectors(n_ent, d, d_red, seed):
    r = np.random.default_rng(seed)
    raw = np.full((n_ent, d_red), d, np.int32)
    dims = np.zeros(n_ent, np.int32)
    for e in range(n_ent):
        w = int(r.integers(0, d_red + 1))
        raw[e, :w] = np.sort(r.choice(d, size=w, replace=False))
        dims[e] = w
    return IndexMapProjectors(raw, dims, d)


@pytest.mark.parametrize("passive", [False, True])
def test_projected_pack_matches_numpy_and_jax(passive):
    n, d, n_ent, d_red = 500, 40, 12, 8
    mat = _ragged(n, d, seed=3, max_len=12)
    proj = _projectors(n_ent, d, d_red, seed=4)
    r = np.random.default_rng(5)
    ent = r.integers(0, n_ent, n)
    if passive:
        shape, pos = (n, d_red), np.arange(n)
    else:
        shape, pos = (n_ent, 64, d_red), ent * 64 + r.permutation(n) % 64
        # one slot per (entity, row): unique flat positions
        pos = np.unique(pos, return_index=True)[1]
        mat, ent = mat[pos], ent[pos]
        pos = ent * 64 + np.arange(len(pos)) % 64
    native = np.zeros(shape, np.float32)
    numpy_ = np.zeros(shape, np.float32)
    tds._fill_feature_rows(mat, native, pos, proj, None, table_ent=ent,
                           global_ent=ent, raw_indices=proj.raw_indices)
    tds._fill_feature_rows(mat, numpy_, pos, proj, None, global_ent=ent,
                           native_pack=False)
    assert np.array_equal(native, numpy_)
    assert native.any()
    jout = np.zeros(shape, np.float32)
    if jnl.pack_projected_rows_native(mat, ent, pos, proj.raw_indices, jout):
        assert np.array_equal(native, jout)


def test_pack_shape_checks_raise():
    mat = _ragged(20, 10, seed=6)
    k = int(np.diff(mat.indptr).max())
    good = (np.zeros((20, k), np.int32), np.zeros((20, k), np.float32))
    with pytest.raises(ValueError, match="shape"):
        tnl.pack_ell_native(mat.indptr, mat.indices, mat.data, k,
                            np.zeros((19, k), np.int32), good[1])
    with pytest.raises(ValueError, match="C-contiguous"):
        tnl.pack_ell_native(mat.indptr, mat.indices, mat.data, k,
                            np.zeros((k, 20), np.int32).T, good[1])
    with pytest.raises(ValueError, match="shorter"):
        tnl.pack_ell_native(mat.indptr, mat.indices[:-1], mat.data, k,
                            *good)
    with pytest.raises(ValueError, match="code 1"):  # a row longer than k
        tnl.pack_ell_native(mat.indptr, mat.indices, mat.data, k - 1,
                            np.zeros((20, k - 1), np.int32),
                            np.zeros((20, k - 1), np.float32))
    raw = np.sort(np.random.default_rng(0).choice(10, (3, 4)), axis=1)
    ent, pos = np.zeros(20, np.int64), np.arange(20)
    with pytest.raises(ValueError, match="table width"):
        tnl.pack_projected_rows_native(mat, ent, pos, raw.astype(np.int32),
                                       np.zeros((20, 5), np.float32))
    with pytest.raises(ValueError, match="C-contiguous"):
        tnl.pack_projected_rows_native(mat, ent, pos, raw,
                                       np.zeros((4, 20), np.float32).T)
    with pytest.raises(ValueError, match="one entry per row"):
        tnl.pack_projected_rows_native(mat, ent[:-1], pos, raw,
                                       np.zeros((20, 4), np.float32))
    with pytest.raises(ValueError, match="code 1"):  # table out of range
        tnl.pack_projected_rows_native(mat, ent + 3, pos, raw,
                                       np.zeros((20, 4), np.float32))
    with pytest.raises(ValueError, match="code 1"):  # row out of range
        tnl.pack_projected_rows_native(mat, ent, pos + 1, raw,
                                       np.zeros((20, 4), np.float32))


def _sanitizer_reason():
    """None when ASan+UBSan builds and their runtime are available here,
    else the reason to skip."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "no g++ on PATH"
    probe = subprocess.run(
        [cxx, "-x", "c++", "-", "-std=c++17", "-fPIC", "-shared",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-o", os.devnull], input="int f(){return 0;}", text=True,
        capture_output=True, timeout=60)
    if probe.returncode != 0:
        return "g++ cannot build with -fsanitize=address,undefined"
    return None


def _libasan():
    out = subprocess.run(["g++", "-print-file-name=libasan.so"],
                         capture_output=True, text=True,
                         timeout=30).stdout.strip()
    return out if os.path.isabs(out) and os.path.exists(out) else None


def test_sanitized_host_library_replays_edge_inputs(tmp_path):
    reason = _sanitizer_reason()
    if reason is not None:
        pytest.skip(f"sanitized host build unavailable: {reason}")
    libasan = _libasan()
    if libasan is None:
        pytest.skip("libasan.so not found for LD_PRELOAD")
    lib = tnl.build_sanitized()
    assert os.path.exists(lib) and lib != tnl._library_path()
    env = dict(os.environ, PHOTON_TORCH_HOST_LIB=lib, LD_PRELOAD=libasan,
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1",
               PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys\n"
         "try:\n"
         "    runpy.run_module('photon_ml_tpu_torch.tools.host_replay',"
         " run_name='__main__')\n"
         "finally:\n"
         "    bad = sorted(m for m in sys.modules if m == 'jax' or "
         "m.startswith('jax.') or m == 'photon_ml_tpu' or "
         "m.startswith('photon_ml_tpu.'))\n"
         "    print('imported', bad)\n",
         str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert "host-replay-ok" in r.stdout, (r.returncode, r.stdout[-3000:],
                                          r.stderr[-6000:])
    assert "imported []" in r.stdout
    assert r.returncode == 0
