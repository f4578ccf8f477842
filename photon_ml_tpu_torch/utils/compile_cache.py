"""The persistent build cache of the port's compiled libraries.

Port of ``photon_ml_tpu/utils/compile_cache.py:39-145``. The JAX package
keeps XLA's compiled executables on disk under a directory keyed by a
machine fingerprint; the port's counterpart is the cache of ``nvcc`` (and
``g++``) builds that ``ops/kernels_build.py`` keeps, by default in the
git-ignored ``photon_ml_tpu_torch/_build/``, one file per library whose
name carries a hash of its sources and flags.

- :func:`machine_fingerprint` is the part of that hash that names the
  machine: the ``nvcc`` version, the card's compute capability and
  torch's version (with the OS and architecture). A library built for
  another machine has another name, so it is never loaded here: it is
  built again.
- ``PHOTON_COMPILE_CACHE_DIR`` puts the cache in another directory.
- ``PHOTON_DISABLE_COMPILE_CACHE=1`` builds every library afresh into a
  directory of this process's own (under ``TMPDIR``), so nothing built
  earlier is read.

Nothing here runs at import time: the fingerprint is taken when a build
is keyed, which is the first kernel launch.
"""

from __future__ import annotations

import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import Optional

_PROCESS_DIR: Optional[str] = None


def enabled() -> bool:
    """False when ``PHOTON_DISABLE_COMPILE_CACHE`` is set."""
    return not os.environ.get("PHOTON_DISABLE_COMPILE_CACHE")


def cache_dir(default: str) -> str:
    """Where built libraries live: ``PHOTON_COMPILE_CACHE_DIR``, else
    ``default``; with the cache disabled, a fresh directory of this
    process's own."""
    global _PROCESS_DIR
    if not enabled():
        if _PROCESS_DIR is None:
            _PROCESS_DIR = tempfile.mkdtemp(prefix="photon_build_")
        return _PROCESS_DIR
    return os.environ.get("PHOTON_COMPILE_CACHE_DIR") or default


@functools.lru_cache(maxsize=8)
def nvcc_version(nvcc: str) -> str:
    """The last line of ``nvcc --version`` (its release and build)."""
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[-1] if out else ""


def compute_capability() -> str:
    """``sm_<major><minor>`` of the current CUDA card, ``none`` without
    CUDA."""
    import torch

    if not torch.cuda.is_available():
        return "none"
    major, minor = torch.cuda.get_device_capability()
    return f"sm_{major}{minor}"


def machine_fingerprint(nvcc: Optional[str] = None) -> str:
    """Digest of everything that can change the code a build produces or
    whether it runs: OS and architecture, torch's version and its CUDA,
    the card's compute capability and, with ``nvcc``, its version."""
    import torch

    parts = [platform.system(), platform.machine(), torch.__version__,
             str(torch.version.cuda), compute_capability()]
    if nvcc is not None:
        parts.append(nvcc_version(nvcc))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]
