"""photonlint runner: load → index → dataflow → rules → filter → report.

Port of ``photon_ml_tpu/analysis/runner.py``: it lints
``photon_ml_tpu_torch`` by default and runs only the families with a
subject in the port (:data:`RULE_MODULES`; W0 rides along). Library
entry point is :func:`lint`; ``photon_ml_tpu_torch/tools/photonlint.py``
is the CLI wrapper. The run is pure (no package code is imported or
executed) and deterministic: findings sort by (path, line, col, rule).

Two kinds of extra inputs ride along with the package modules:

- **auxiliary consumer modules** (``chip_smoke.py`` and the port's drill
  and replay tools) are loaded for the WB telemetry-consumer scan only
  — they honor inline suppressions but are not linted by any other
  family;
- an optional **incremental cache** (``cache_dir=…``): per-file
  ``ModuleInfo`` artifacts keyed on content, plus a whole-program
  findings replay that skips module loading entirely when nothing
  changed. Suppression, baseline and ``changed_paths`` filtering always
  run live on top of replayed findings, so they stay authoritative.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Iterable, Optional

from photon_ml_tpu_torch.analysis import (
    core, dataflow, rules_checkpoint, rules_collectives, rules_dtype,
    rules_faults, rules_protocol, rules_sync, rules_telemetry,
    rules_threads,
)
from photon_ml_tpu_torch.analysis.cache import LintCache
from photon_ml_tpu_torch.analysis.core import Finding, LintReport
from photon_ml_tpu_torch.analysis.package import (
    ModuleInfo, PackageIndex, build_index,
)

RULE_MODULES = {
    "W1": rules_sync,
    "W4": rules_faults,
    "W5": rules_checkpoint,
    "W6": rules_collectives,
    "W8": rules_dtype,
    "W9": rules_threads,
    "WA": rules_protocol,
    "WB": rules_telemetry,
}

DEFAULT_PATHS = ("photon_ml_tpu_torch",)

# the families that read the device dataflow (a per-shard value, f64 on
# the card, a blocking copy of a device tensor)
DATAFLOW_FAMILIES = {"W1", "W6", "W8"}

# The port's own telemetry consumers. Loaded (when present and not
# already in the lint path set) so WB03 sees the reads that check the
# port's runs; every other family ignores them.
AUX_CONSUMER_FILES = (
    "chip_smoke.py",
    "photon_ml_tpu_torch/tools/crash_resume_drill.py",
    "photon_ml_tpu_torch/tools/host_replay.py",
)


@dataclasses.dataclass
class LintContext:
    root: Path
    readme_path: Optional[Path]
    readme_lines: Optional[list[str]]
    readme_relpath: Optional[str]
    aux_modules: Optional[list[ModuleInfo]] = None


def _collect_files(root: Path, paths: Iterable[str]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        path = (root / p) if not Path(p).is_absolute() else Path(p)
        if path.is_dir():
            files.extend(sorted(
                f for f in path.rglob("*.py")
                if "__pycache__" not in f.parts))
        elif path.suffix == ".py":
            files.append(path)
        else:
            raise FileNotFoundError(f"no such file or directory: {p}")
    return files


def _aux_paths(root: Path, files: list[Path]) -> list[Path]:
    taken = {f.resolve() for f in files}
    out: list[Path] = []
    for rel in AUX_CONSUMER_FILES:
        p = root / rel
        if p.exists() and p.resolve() not in taken:
            out.append(p)
    return out


def collect_findings(
    root: Path,
    paths: Optional[Iterable[str]] = None,
    readme: Optional[Path] = None,
    families: Optional[set[str]] = None,
    cache: Optional[LintCache] = None,
) -> tuple[list[Finding], list[ModuleInfo], list[ModuleInfo],
           PackageIndex, dict[str, float]]:
    """Run the rule families and return raw findings (before suppression
    and baseline filtering), the package and auxiliary modules, the
    index, and per-family wall-clock timings."""
    root = Path(root)
    files = _collect_files(root, paths or DEFAULT_PATHS)

    def load(f: Path) -> ModuleInfo:
        if cache is not None:
            return cache.load_module(f, root)[0]
        return ModuleInfo.load(f, root)

    modules = [load(f) for f in files]
    aux_modules = [load(f) for f in _aux_paths(root, files)]
    index = build_index(modules)
    enabled = families or set(RULE_MODULES)
    flows: dict = {}
    if enabled & DATAFLOW_FAMILIES:
        dataflow.infer_device_functions(index)
        flows = {mod.relpath: dataflow.analyze_module(mod, index)
                 for mod in modules}

    if readme is not None and Path(readme).exists():
        readme_path = Path(readme)
        readme_lines = readme_path.read_text().splitlines()
        try:
            readme_relpath = readme_path.relative_to(root).as_posix()
        except ValueError:
            readme_relpath = readme_path.name
    else:
        readme_path = readme_lines = readme_relpath = None
    ctx = LintContext(root=root, readme_path=readme_path,
                      readme_lines=readme_lines,
                      readme_relpath=readme_relpath,
                      aux_modules=aux_modules)

    findings: list[Finding] = []
    timings: dict[str, float] = {}
    for family, rule_mod in sorted(RULE_MODULES.items()):
        if family in enabled:
            t0 = time.perf_counter()
            findings.extend(rule_mod.check(modules, index, flows, ctx))
            timings[family] = time.perf_counter() - t0
    if families is None or "W0" in families:
        for mod in modules:
            findings.extend(mod.malformed)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, modules, aux_modules, index, timings


def _program_key(cache: LintCache, root: Path,
                 paths: Optional[Iterable[str]],
                 readme, families: Optional[set[str]]) -> str:
    """Key the whole-program replay on every input byte the rules can
    see: the lint file set, the auxiliary consumers, and the README.
    Main and aux roles are tagged so the same file set split
    differently cannot collide."""
    files = _collect_files(root, paths or DEFAULT_PATHS)
    keys: list[str] = []
    for role, group in (("main", files), ("aux", _aux_paths(root, files))):
        for f in group:
            try:
                rel = f.relative_to(root).as_posix()
            except ValueError:
                rel = f.as_posix()
            keys.append(f"{role}:{cache.file_key(rel, f.read_bytes())}")
    readme_bytes = None
    if readme is not None and Path(readme).exists():
        readme_bytes = Path(readme).read_bytes()
    return cache.program_key(keys, readme_bytes, families)


def lint(
    root,
    paths: Optional[Iterable[str]] = None,
    readme=None,
    baseline=None,
    families: Optional[set[str]] = None,
    changed_paths: Optional[set[str]] = None,
    cache_dir=None,
) -> LintReport:
    """Full lint pass: rules, then per-line suppressions, then baseline.

    ``baseline`` is a path (entries grandfather existing findings) or
    None to report everything as new. ``changed_paths`` (root-relative
    posix paths) restricts the *report* to findings in those files; the
    analysis itself is always whole-program, so cross-module findings
    (a W101 through a function two modules away, a W904 lock-order
    pair) still resolve against the unchanged half of the package.

    ``cache_dir`` enables the incremental cache (see
    :mod:`photon_ml_tpu_torch.analysis.cache`).
    """
    root = Path(root)
    cache = LintCache(cache_dir) if cache_dir is not None else None
    payload = pkey = None
    timings: Optional[dict[str, float]] = None
    if cache is not None:
        pkey = _program_key(cache, root, paths, readme, families)
        payload = cache.load_program(pkey)
    if payload is not None:
        findings = payload["findings"]
        by_file = payload["by_file"]
        aux_by_file = payload["aux_by_file"]
        files_checked = payload["files_checked"]
    else:
        findings, modules, aux_modules, _, timings = collect_findings(
            root, paths, readme, families, cache=cache)
        by_file = {m.relpath: m.suppressions for m in modules}
        aux_by_file = {m.relpath: m.suppressions for m in aux_modules}
        files_checked = len(modules)
        if pkey is not None:
            cache.store_program(pkey, {
                "findings": findings,
                "by_file": by_file,
                "aux_by_file": aux_by_file,
                "files_checked": files_checked,
            })
    merged = dict(by_file)
    merged.update(aux_by_file)
    kept, suppressed, used = core.apply_suppressions(findings, merged)
    if families is None:
        # W002 needs every family's verdict: on a partial run an
        # off-family directive would merely LOOK unused. Auxiliary
        # consumer files are excluded — only WB ever looks at them, so
        # an off-family directive there is not provably dead.
        w002 = core.unused_suppressions(by_file, used)
        w002_kept, w002_suppressed, _ = core.apply_suppressions(
            w002, merged)
        kept = sorted(kept + w002_kept,
                      key=lambda f: (f.path, f.line, f.col, f.rule))
        suppressed.extend(w002_suppressed)
    if changed_paths is not None:
        kept = [f for f in kept if f.path in changed_paths]
    entries = core.load_baseline(baseline)
    new, baselined, stale = core.apply_baseline(kept, entries)
    return LintReport(new=new, baselined=baselined,
                      suppressed=suppressed, stale_baseline=stale,
                      files_checked=files_checked,
                      cache_stats=cache.stats() if cache else None,
                      timings=timings)


def write_baseline(
    root,
    path,
    paths: Optional[Iterable[str]] = None,
    readme=None,
    families: Optional[set[str]] = None,
) -> int:
    """Grandfather every current (non-suppressed) finding into
    ``path``. Stale entries are pruned by construction: the file is
    rewritten from the findings that exist *now*, so anything fixed
    since the last refresh simply never re-enters. Returns the number
    of baseline entries written."""
    findings, modules, aux_modules, _, _ = collect_findings(
        Path(root), paths, readme, families)
    by_file = {m.relpath: m.suppressions for m in modules}
    merged = dict(by_file)
    merged.update({m.relpath: m.suppressions for m in aux_modules})
    kept, _, used = core.apply_suppressions(findings, merged)
    if families is None:
        w002 = core.unused_suppressions(by_file, used)
        w002_kept, _, _ = core.apply_suppressions(w002, merged)
        kept = kept + w002_kept
    return core.write_baseline(path, kept)
