"""photonlint CLI over the port — static invariant checks for
photon_ml_tpu_torch.

Port of ``tools/photonlint.py``, with its flags and exit codes, over the
port's own analysis (:mod:`photon_ml_tpu_torch.analysis`). Usage (from
the repo root)::

    python -m photon_ml_tpu_torch.tools.photonlint   # photon_ml_tpu_torch/
    python -m photon_ml_tpu_torch.tools.photonlint --format json
    python -m photon_ml_tpu_torch.tools.photonlint --sarif
    python -m photon_ml_tpu_torch.tools.photonlint --write-baseline
    python -m photon_ml_tpu_torch.tools.photonlint --no-baseline
    python -m photon_ml_tpu_torch.tools.photonlint --rules W1,W4
    python -m photon_ml_tpu_torch.tools.photonlint --rules W6,W8
    python -m photon_ml_tpu_torch.tools.photonlint --changed-files
    python -m photon_ml_tpu_torch.tools.photonlint --since origin/main
    python -m photon_ml_tpu_torch.tools.photonlint --stats
    python -m photon_ml_tpu_torch.tools.photonlint --no-cache
    python -m photon_ml_tpu_torch.tools.photonlint --list-rules

Exit codes: 0 clean (no non-baselined findings), 1 findings, 2 usage or
internal error — among them a family or rule the port does not run (W2,
W3, W7, W803) named in ``--rules``, and ``--trace-evidence``, which
feeds W702 of the waiting W7. ``--list-rules`` lists the rules the port
runs, then the waiting ones with their reasons. The default baseline is
``photon_ml_tpu_torch/tools/photonlint_baseline.json``, the default
README the repo's ``README.md`` and the default cache
``.photonlint_torch_cache/`` under ``--root``; paths resolve relative to
this file, so the CLI works from any working directory.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

from photon_ml_tpu_torch.analysis import runner  # noqa: E402
from photon_ml_tpu_torch.analysis.core import (  # noqa: E402
    FAMILIES, RULES, WAITING, load_baseline,
)

DEFAULT_BASELINE = os.path.join(_REPO_ROOT, "photon_ml_tpu_torch", "tools",
                                "photonlint_baseline.json")
DEFAULT_README = os.path.join(_REPO_ROOT, "README.md")
CACHE_DIR_NAME = ".photonlint_torch_cache"


def changed_py_files(root: str, rev: str) -> set[str]:
    """Root-relative posix paths of .py files changed vs ``rev``.

    Union of the working-tree diff against ``rev`` and untracked files,
    so a brand-new module is linted before its first ``git add``.
    """
    import subprocess

    def run(*args: str) -> str:
        return subprocess.run(
            ["git", *args, "--", "*.py"], cwd=root, check=True,
            capture_output=True, text=True).stdout

    lines = (run("diff", "--name-only", rev).splitlines()
             + run("ls-files", "--others", "--exclude-standard")
               .splitlines())
    return {p.strip() for p in lines if p.strip().endswith(".py")}


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="photonlint",
        description="AST-based invariant checks over the port: sync "
                    "discipline, fault-point and checkpoint-schema drift, "
                    "collective safety, precision discipline, thread "
                    "safety, wire-protocol and telemetry drift.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories relative to --root "
                         "(default: photon_ml_tpu_torch)")
    ap.add_argument("--root", default=_REPO_ROOT,
                    help="lint root; finding paths are relative to it")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--sarif", action="store_true",
                    help="shorthand for --format sarif (SARIF 2.1.0, "
                         "for editor/CI consumption)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (grandfathered findings)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write all current findings to --baseline and "
                         "exit 0")
    ap.add_argument("--readme", default=DEFAULT_README,
                    help="README whose PHOTON_FAULTS and taxonomy tables "
                         "W4xx and WBxx check")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule families to run, e.g. "
                         "W1,W4 (default: all the port runs)")
    ap.add_argument("--changed-files", action="store_true",
                    help="report only findings in files changed vs "
                         "--since (default HEAD); the analysis is "
                         "still whole-program")
    ap.add_argument("--since", default=None, metavar="REV",
                    help="git rev for --changed-files (implies it)")
    ap.add_argument("--trace-evidence", default=None, metavar="DIR",
                    help="W702 runtime retrace evidence: refused, the "
                         "port does not run W7")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help=f"incremental-cache directory (default: "
                         f"{CACHE_DIR_NAME}/ under --root)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the incremental cache (cold run)")
    ap.add_argument("--stats", action="store_true",
                    help="print per-family timing and cache hit/miss "
                         "stats to stderr")
    ap.add_argument("--list-rules", action="store_true")
    return ap.parse_args(argv)


def _refuse(message: str) -> int:
    print(f"photonlint: {message}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ns = parse_args(sys.argv[1:] if argv is None else argv)
    if ns.list_rules:
        for rule_id in sorted(RULES):
            print(f"{rule_id}  {RULES[rule_id]}")
        for rule_id in sorted(WAITING):
            print(f"{rule_id}  waiting, not run: {WAITING[rule_id]}")
        return 0
    if ns.trace_evidence is not None:
        return _refuse(f"--trace-evidence drives W702, and the port does "
                       f"not run W7 ({WAITING['W7']})")
    families = None
    if ns.rules:
        families = {f.strip() for f in ns.rules.split(",") if f.strip()}
        waiting = sorted(families & set(WAITING))
        if waiting:
            return _refuse("the port does not run famil(ies) or rule(s) "
                           + "; ".join(f"{f} — {WAITING[f]}"
                                       for f in waiting))
        bad = families - set(FAMILIES)
        if bad:
            return _refuse(f"unknown rule famil(ies) {sorted(bad)}; "
                           f"known: {list(FAMILIES)}")
    paths = ns.paths or None
    changed = None
    if ns.changed_files or ns.since:
        if ns.write_baseline:
            return _refuse("--write-baseline is whole-program; it cannot "
                           "combine with --changed-files/--since")
        rev = ns.since or "HEAD"
        try:
            changed = changed_py_files(ns.root, rev)
        except Exception as e:  # subprocess or git failure
            return _refuse(f"error: git diff vs {rev!r} failed: {e}")
        if not changed:
            print(f"photonlint: no .py files changed vs {rev}; "
                  "nothing to report")
            return 0
    try:
        if ns.write_baseline:
            before = {(e["rule"], e["path"], e["message"])
                      for e in load_baseline(
                          ns.baseline
                          if os.path.exists(ns.baseline) else None)}
            n = runner.write_baseline(
                ns.root, ns.baseline, paths=paths, readme=ns.readme,
                families=families)
            after = {(e["rule"], e["path"], e["message"])
                     for e in load_baseline(ns.baseline)}
            pruned = len(before - after)
            print(f"photonlint: wrote {n} baseline entr(ies) to "
                  f"{ns.baseline}"
                  + (f" ({pruned} stale entr(ies) pruned)"
                     if pruned else ""))
            return 0
        cache_dir = None
        if not ns.no_cache:
            cache_dir = ns.cache_dir or os.path.join(ns.root,
                                                     CACHE_DIR_NAME)
        report = runner.lint(
            ns.root, paths=paths, readme=ns.readme,
            baseline=None if ns.no_baseline else ns.baseline,
            families=families, changed_paths=changed, cache_dir=cache_dir)
    except (OSError, ValueError, SyntaxError) as e:
        return _refuse(f"error: {e}")
    if ns.stats:
        if report.timings is not None:
            for family, secs in sorted(report.timings.items()):
                print(f"photonlint: timing {family}: {secs*1000:.1f} ms",
                      file=sys.stderr)
        else:
            print("photonlint: timing: (program cache replay — rules "
                  "did not run)", file=sys.stderr)
    if report.cache_stats is not None and (ns.stats or not ns.no_cache):
        cs = report.cache_stats
        print(f"photonlint: cache: {cs['file_hits']} file hit(s), "
              f"{cs['file_misses']} miss(es)"
              + (", program replay" if cs["program_hit"] else ""),
              file=sys.stderr)
    fmt = "sarif" if ns.sarif else ns.format
    if fmt == "json":
        print(report.format_json())
    elif fmt == "sarif":
        from photon_ml_tpu_torch.analysis.sarif import format_sarif
        print(format_sarif(report))
    else:
        print(report.format_text())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
