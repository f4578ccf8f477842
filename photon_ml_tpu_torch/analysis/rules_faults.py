"""W4xx — fault-point drift.

Port of ``photon_ml_tpu/analysis/rules_faults.py``; the registry it
resolves is ``photon_ml_tpu_torch.utils.faults.fault_point``.

The ``PHOTON_FAULTS`` README table is operator-facing documentation of
every drillable fault site. These rules keep the two in sync in both
directions:

- **W401** a ``fault_point("name")`` call site whose name has no row in
  the README table;
- **W402** a README table row naming a point with no call site;
- **W403** a ``fault_point`` call whose name argument is not a string
  literal (statically unanalyzable — use a literal, the registry is a
  closed set by design).

The table is located by its markdown header row (first cell ``point``)
inside the README; rows are ``| `name` | ... |``.
"""

from __future__ import annotations

import ast
import re

from photon_ml_tpu_torch.analysis.core import Finding
from photon_ml_tpu_torch.analysis.dataflow import Dataflow
from photon_ml_tpu_torch.analysis.package import ModuleInfo, PackageIndex

_HEADER_RE = re.compile(r"^\s*\|\s*point\s*\|", re.IGNORECASE)
_ROW_RE = re.compile(r"^\s*\|\s*`([\w.\-]+)`\s*\|")
_TABLE_LINE_RE = re.compile(r"^\s*\|")


def parse_fault_table(readme_lines: list[str]) -> dict[str, int]:
    """``{fault point name: 1-based README line}`` from the first
    markdown table whose header's first cell is ``point``."""
    out: dict[str, int] = {}
    in_table = False
    for i, line in enumerate(readme_lines, start=1):
        if not in_table:
            if _HEADER_RE.match(line):
                in_table = True
            continue
        if not _TABLE_LINE_RE.match(line):
            break  # table ended
        m = _ROW_RE.match(line)
        if m:
            out[m.group(1)] = i
    return out


def _is_fault_point(mod: ModuleInfo, call: ast.Call) -> bool:
    d = mod.resolve(call.func)
    return d is not None and (
        d == "photon_ml_tpu_torch.utils.faults.fault_point"
        or d.endswith(".fault_point"))


def check(modules: list[ModuleInfo], index: PackageIndex,
          flows: dict[str, Dataflow], ctx) -> list[Finding]:
    if ctx.readme_lines is None:
        return []  # no README to reconcile against (fixture runs)
    table = parse_fault_table(ctx.readme_lines)
    findings: list[Finding] = []
    seen_sites: set[str] = set()
    for mod in modules:
        if mod.relpath.endswith("utils/faults.py"):
            continue  # the registry itself (docstrings / default wiring)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and _is_fault_point(mod, node)):
                continue
            if not node.args or not (
                    isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                findings.append(Finding(
                    "W403", mod.relpath, node.lineno, node.col_offset,
                    "fault_point() name is not a string literal — the "
                    "fault registry must stay statically enumerable"))
                continue
            name = node.args[0].value
            seen_sites.add(name)
            if name not in table:
                findings.append(Finding(
                    "W401", mod.relpath, node.lineno, node.col_offset,
                    f"fault_point(\"{name}\") has no row in the README "
                    f"PHOTON_FAULTS table — document where it fires "
                    f"and its tag format"))
    for name, line in sorted(table.items()):
        if name not in seen_sites:
            findings.append(Finding(
                "W402", ctx.readme_relpath or "README.md", line, 0,
                f"PHOTON_FAULTS table documents `{name}` but no "
                f"fault_point(\"{name}\") site exists — remove the row "
                f"or restore the site"))
    return findings
