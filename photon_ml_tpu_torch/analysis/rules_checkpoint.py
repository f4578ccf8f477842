"""W5xx — checkpoint-schema drift.

Port of ``photon_ml_tpu/analysis/rules_checkpoint.py``, unchanged in
what it checks.

A snapshot is a dict contract between the save sites
(``game/coordinate_descent.save_snapshot``, the multi-host
``save_snapshot``) and every restore/resume path that indexes into what
``CheckpointManager.restore`` returns. The dict is schemaless by design
(checkpoint.py stays framework-free), so nothing at runtime catches a
writer renaming a field until a resume quietly ``.get(...)``-defaults it
away — the silent flavor of the bug class the bit-exact resume drill
exists for.

- **W501** a key read on a restore path that NO save site writes;
- **W502** a key written by a save site that NO restore path reads.

Writers: dict literals passed (directly or through one local name) to
``<ckpt-ish>.save(step, state)`` calls — receivers whose name matches
``ckpt``/``checkpoint`` — or to a save WRAPPER: a plain call whose
function name mentions both ``ckpt``/``checkpoint`` and ``save`` and
that mirrors the save shape plus the manager up front,
``(manager, step, snapshot, ...)`` — e.g.
``_checkpoint_save_contained(mgr, step, {...})`` — so hoisting the
save into a containment helper keeps the schema visible while a
2-arg name-alike helper doesn't pollute the key union.
Readers: string subscripts and ``.get`` calls
on snapshot variables — names bound from ``<ckpt-ish>.restore()`` or
``loads_state(...)``, plus the conventional names ``snap`` /
``resume_snapshot`` / ``snapshot``. Both directions compare against the
union across the package, so the single-process and multi-host schemas
coexist without cross-flagging.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from photon_ml_tpu_torch.analysis.core import Finding
from photon_ml_tpu_torch.analysis.dataflow import Dataflow
from photon_ml_tpu_torch.analysis.package import ModuleInfo, PackageIndex

_CKPT_RECV_RE = re.compile(r"ckpt|checkpoint", re.IGNORECASE)
_SAVE_WRAPPER_RE = re.compile(r"(?=.*(?:ckpt|checkpoint))(?=.*save)",
                              re.IGNORECASE)
_SNAP_NAMES = {"snap", "snapshot", "resume_snapshot"}


def _receiver_name(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _dict_keys(d: ast.Dict) -> Optional[set[str]]:
    keys = set()
    for k in d.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.add(k.value)
        elif k is None:
            return None  # **spread: key set unknowable, skip this writer
    return keys


def _resolve_dict_arg(fdef_or_mod_body, arg: ast.expr,
                      before_line: int) -> Optional[ast.Dict]:
    """A dict literal argument, or the nearest preceding single-target
    assignment of one to the given name."""
    if isinstance(arg, ast.Dict):
        return arg
    if not isinstance(arg, ast.Name):
        return None
    best: Optional[tuple[int, ast.Dict]] = None
    for n in ast.walk(fdef_or_mod_body):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and n.targets[0].id == arg.id \
                and isinstance(n.value, ast.Dict) \
                and n.lineno < before_line:
            if best is None or n.lineno > best[0]:
                best = (n.lineno, n.value)
    return best[1] if best else None


def _snapshot_vars(mod: ModuleInfo) -> set[str]:
    """Names that hold a restored snapshot somewhere in the module."""
    out = set(_SNAP_NAMES)
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and isinstance(n.value, ast.Call):
            call = n.value
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr == "restore":
                recv = _receiver_name(call.func.value)
                if recv and _CKPT_RECV_RE.search(recv):
                    out.add(n.targets[0].id)
            else:
                d = mod.resolve(call.func)
                if d is not None and d.endswith("loads_state"):
                    out.add(n.targets[0].id)
    return out


def check(modules: list[ModuleInfo], index: PackageIndex,
          flows: dict[str, Dataflow], ctx) -> list[Finding]:
    # ---- writers ---------------------------------------------------------
    from photon_ml_tpu_torch.analysis.rules_sync import build_scope_map

    written: dict[str, list[tuple[ModuleInfo, ast.Call]]] = {}
    any_writer = False
    for mod in modules:
        scope_of = build_scope_map(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            state_args: list[ast.expr] = []
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "save" \
                    and len(node.args) >= 2:
                recv = _receiver_name(node.func.value)
                if recv and _CKPT_RECV_RE.search(recv):
                    state_args = [node.args[1]]
            elif isinstance(node.func, ast.Name) \
                    and _SAVE_WRAPPER_RE.search(node.func.id) \
                    and len(node.args) >= 3:
                # containment wrappers mirror the .save shape plus the
                # manager up front — (manager, step, snapshot, ...) —
                # so only args[2:] are schema candidates; a 2-arg
                # helper that happens to match the name (e.g.
                # save_checkpoint_report(mgr, {...})) is not a save site
                state_args = list(node.args[2:])
            if not state_args:
                continue
            scope = scope_of.get(id(node)) or mod.tree
            d = None
            for arg in state_args:
                d = _resolve_dict_arg(scope, arg, node.lineno)
                if d is not None:
                    break
            if d is None:
                continue
            keys = _dict_keys(d)
            if keys is None:
                continue
            any_writer = True
            for k in keys:
                written.setdefault(k, []).append((mod, node))
    # ---- readers ---------------------------------------------------------
    read: dict[str, list[tuple[ModuleInfo, ast.AST]]] = {}
    any_reader = False
    for mod in modules:
        snap_vars = _snapshot_vars(mod)
        for node in ast.walk(mod.tree):
            key = None
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in snap_vars \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                key = node.slice.value
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "get" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in snap_vars \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                key = node.args[0].value
            if key is not None:
                any_reader = True
                read.setdefault(key, []).append((mod, node))
    # ---- reconcile -------------------------------------------------------
    findings: list[Finding] = []
    if any_writer:
        for key, sites in sorted(read.items()):
            if key in written:
                continue
            for mod, node in sites:
                findings.append(Finding(
                    "W501", mod.relpath, node.lineno, node.col_offset,
                    f"snapshot key '{key}' is read on a restore path "
                    f"but no checkpoint save site writes it — resume "
                    f"will silently default/KeyError"))
    if any_reader:
        for key, sites in sorted(written.items()):
            if key in read:
                continue
            for mod, node in sites:
                findings.append(Finding(
                    "W502", mod.relpath, node.lineno, node.col_offset,
                    f"snapshot key '{key}' is written at this save "
                    f"site but never read by any restore path — dead "
                    f"schema field or a renamed reader"))
    return findings
