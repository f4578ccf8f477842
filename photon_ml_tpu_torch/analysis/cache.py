"""Incremental lint cache: content-addressed per-file artifacts plus a
whole-program replay artifact.

Port of ``photon_ml_tpu/analysis/cache.py``. The artifacts pickle the
port's own ``ModuleInfo``, so the port keeps them in a directory of its
own (the CLI's default is ``.photonlint_torch_cache/``): unpickling one
of the JAX linter's artifacts would import the JAX package's analysis.
Every key also carries :data:`CACHE_TAG`, the port's own cache version,
so the two linters' artifacts can never collide even in one directory.

photonlint is whole-program — a W101 needs a device-returning function
two modules away, WA01 needs every client send site — so it cannot simply skip
unchanged files. What it CAN skip is re-deriving per-file state
(:class:`~photon_ml_tpu_torch.analysis.package.ModuleInfo`: parse, import
map, constant table, suppression scan) for files whose bytes are
unchanged, and, when *nothing* changed, re-running the rules at all:

- **file artifact** — a pickled ``ModuleInfo`` keyed on
  ``sha256(relpath, file bytes, analyzer signature)``. A hit replaces
  parse + four AST visits with one unpickle.
- **program artifact** — the raw (pre-suppression, pre-baseline)
  findings plus the per-file suppression maps, keyed on the sorted
  file keys, the README bytes and the enabled families. A hit replays
  the whole fixpoint without loading a single module; suppression and
  baseline filtering still run live, so a baseline edit or
  ``--changed-files`` restriction is honored against cached findings.

Keys contain no mtimes: ``touch`` without an edit is still a full hit.
The *analyzer signature* — a digest of every ``analysis/*.py`` source —
folds the linter's own code into every key, so editing a rule, the
dataflow engine, or this file invalidates everything (the classic
stale-lint-cache bug class). Any unpickle failure (corrupt file,
pickle-protocol drift) is treated as a miss, never an error.
"""

from __future__ import annotations

import hashlib
import pickle
from pathlib import Path
from typing import Any, Optional

from photon_ml_tpu_torch.analysis.package import ModuleInfo

CACHE_VERSION = 1
CACHE_TAG = f"photonlint-torch-v{CACHE_VERSION}"

_analyzer_sig: Optional[str] = None


def analyzer_signature() -> str:
    """Digest of the analysis package's own sources (computed once)."""
    global _analyzer_sig
    if _analyzer_sig is None:
        h = hashlib.sha256()
        pkg = Path(__file__).parent
        for src in sorted(pkg.glob("*.py")):
            h.update(src.name.encode())
            h.update(b"\0")
            h.update(src.read_bytes())
            h.update(b"\0")
        _analyzer_sig = h.hexdigest()
    return _analyzer_sig


class LintCache:
    """Content-addressed artifact store under ``cache_dir``.

    Layout: ``files/<key>.pkl`` (one ``ModuleInfo`` each) and
    ``program/<key>.pkl`` (one findings replay each). Hit/miss counts
    accumulate on the instance; ``stats()`` snapshots them for
    ``LintReport.cache_stats``.
    """

    def __init__(self, cache_dir) -> None:
        self.dir = Path(cache_dir)
        self.file_hits = 0
        self.file_misses = 0
        self.program_hit = False

    # -- keys --------------------------------------------------------------

    def file_key(self, relpath: str, source: bytes) -> str:
        h = hashlib.sha256()
        h.update(f"{CACHE_TAG}-file\0".encode())
        h.update(analyzer_signature().encode())
        h.update(b"\0")
        h.update(relpath.encode())
        h.update(b"\0")
        h.update(source)
        return h.hexdigest()

    def program_key(self, file_keys: list[str],
                    readme_bytes: Optional[bytes],
                    families: Optional[set[str]]) -> str:
        h = hashlib.sha256()
        h.update(f"{CACHE_TAG}-program\0".encode())
        for k in sorted(file_keys):
            h.update(k.encode())
            h.update(b"\0")
        h.update(b"readme\0")
        h.update(readme_bytes if readme_bytes is not None else b"<none>")
        h.update(b"\0families\0")
        fams = "all" if families is None else ",".join(sorted(families))
        h.update(fams.encode())
        return h.hexdigest()

    # -- artifacts ---------------------------------------------------------

    def _read(self, kind: str, key: str) -> Any:
        path = self.dir / kind / f"{key}.pkl"
        try:
            with open(path, "rb") as fh:
                return pickle.load(fh)
        except Exception:
            return None

    def _write(self, kind: str, key: str, payload: Any) -> None:
        folder = self.dir / kind
        try:
            folder.mkdir(parents=True, exist_ok=True)
            tmp = folder / f".{key}.tmp"
            with open(tmp, "wb") as fh:
                pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
            tmp.replace(folder / f"{key}.pkl")
        except Exception:
            # A read-only or full cache dir degrades to a cold run.
            pass

    def load_module(self, path: Path, root: Path) -> tuple[ModuleInfo, str]:
        """ModuleInfo for ``path`` — unpickled on a content hit, built
        fresh (and stored) on a miss. Returns ``(module, file_key)``."""
        source = Path(path).read_bytes()
        try:
            relpath = Path(path).relative_to(root).as_posix()
        except ValueError:
            relpath = Path(path).as_posix()
        key = self.file_key(relpath, source)
        mod = self._read("files", key)
        if isinstance(mod, ModuleInfo):
            self.file_hits += 1
            return mod, key
        self.file_misses += 1
        mod = ModuleInfo.load(path, root)
        self._write("files", key, mod)
        return mod, key

    def load_program(self, key: str) -> Optional[dict]:
        payload = self._read("program", key)
        if isinstance(payload, dict) and "findings" in payload:
            self.program_hit = True
            return payload
        return None

    def store_program(self, key: str, payload: dict) -> None:
        self._write("program", key, payload)

    def stats(self) -> dict:
        return {
            "file_hits": self.file_hits,
            "file_misses": self.file_misses,
            "program_hit": self.program_hit,
        }
