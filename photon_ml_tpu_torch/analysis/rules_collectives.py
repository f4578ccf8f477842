"""W6xx — collective safety over the shard runner and the gang, in torch
form.

Port of ``photon_ml_tpu/analysis/rules_collectives.py``: the same codes
and meanings over the port's collectives. The port's mesh runs a body
once per shard in threads (``parallel/collectives.run_shards`` /
``shard_map``) and its collectives are a rendezvous of those threads —
and, on a gang, of every process through ``torch.distributed``
(``collectives.ProcessSpan``, ``parallel/multihost``). A mismatched axis
name or a collective that only some shards or processes reach passes
every single-shard CPU test and then hangs at the barrier (or, past
``SHARD_BARRIER_SECONDS``, fails) on a real mesh or gang. The rules:

- **W601** a shard-runner collective (``collectives.psum`` /
  ``all_gather`` / ``axis_index`` / ``bound_index``, and the quantized
  wrappers ``quantized_collectives.qpsum`` / ``qall_gather``, which
  forward the axis verbatim) whose *literal* axis name matches no axis
  the program defines. The universe (``package.collect_mesh_axes``)
  holds the ``*_AXIS`` string constants and the literal axes given to
  ``run_shards`` / ``shard_map`` — never a collective's own axis. An
  axis that does not resolve to a literal (an ``axis_name`` parameter,
  as in ``ops/aggregators.py``) is skipped: unknown is clean.
- **W602** a collective lexically under an ``if``/``while`` whose
  condition reads a device tensor (the dataflow's ``DEVICE`` tag: a
  per-shard value) or queries the process's or shard's identity
  (``torch.distributed.get_rank`` / ``get_world_size``, ``axis_index``,
  ``bound_index``, a ``ProcessSpan``'s ``.rank``). Here the collectives
  are the W601 set plus the gang's host exchange: a ``ProcessSpan``'s
  ``all_gather`` / ``all_gather_bytes``, ``multihost.allgather_ragged``
  / ``allgather_strings`` / ``allgather_csr`` and the
  ``torch.distributed`` collectives.
- **W603** ``collectives.shard_map(body, devices, axis_name, in_specs,
  out_specs)`` whose literal spec-tuple arity disagrees with ``body``'s
  positional signature (``in_specs``) or with ``body``'s literal tuple
  returns (``out_specs``). Fires only when ``body`` resolves to exactly
  one statically known def — a name also rebound by assignment in scope
  is skipped.
- **W604** the placement-side twin of W601: a literal axis in
  ``Placement(mesh, "…")``, ``mesh.axis_devices("…")`` or
  ``mesh.shape["…"]`` / ``mesh.local_shape["…"]`` that no mesh defines.

A ``ProcessSpan`` receiver is recognised by the dataflow's instance tag
or by a parameter annotated ``ProcessSpan`` (or
``Optional[ProcessSpan]``); ``all_gather_bytes`` is the span's alone.
"""

from __future__ import annotations

import ast
import functools
from typing import Optional

from photon_ml_tpu_torch.analysis.core import Finding
from photon_ml_tpu_torch.analysis.dataflow import (
    Dataflow, inst_class, is_device,
)
from photon_ml_tpu_torch.analysis.package import (
    PACKAGE_PREFIX, ModuleInfo, PackageIndex, call_arg, is_shard_runner,
    literal_in,
)
from photon_ml_tpu_torch.analysis.rules_sync import build_scope_map

_PAR = f"{PACKAGE_PREFIX}parallel."

# collective -> index of its positional axis-name argument
_COLLECTIVES = {
    f"{_PAR}collectives.psum": 1,
    f"{_PAR}collectives.all_gather": 1,
    f"{_PAR}collectives.axis_index": 0,
    f"{_PAR}collectives.bound_index": 0,
    # the quantized wrappers forward their axis to psum / all_gather
    # verbatim — same axis discipline, same findings
    f"{_PAR}quantized_collectives.qpsum": 1,
    f"{_PAR}quantized_collectives.qall_gather": 1,
}

# the gang's host exchange: collectives over processes, with no axis name
_HOST_EXCHANGE = {
    f"{_PAR}multihost.allgather_ragged",
    f"{_PAR}multihost.allgather_strings",
    f"{_PAR}multihost.allgather_csr",
}
_DIST_COLLECTIVES = {
    f"torch.distributed.{name}" for name in (
        "all_gather", "all_gather_object", "all_gather_into_tensor",
        "all_reduce", "all_to_all", "all_to_all_single", "barrier",
        "monitored_barrier", "broadcast", "broadcast_object_list",
        "gather", "gather_object", "reduce", "reduce_scatter",
        "reduce_scatter_tensor", "scatter", "scatter_object_list")
}
_SPAN_METHODS = {"all_gather", "all_gather_bytes"}

_IDENTITY_QUERIES = {
    "torch.distributed.get_rank", "torch.distributed.get_world_size",
    f"{_PAR}collectives.axis_index", f"{_PAR}collectives.bound_index",
}
_SPAN_CLASS = "ProcessSpan"

# shard_map's spec arguments: positional index after (body, devices, axis)
_IN_SPECS_POS, _OUT_SPECS_POS = 3, 4


def _short(dotted: str) -> str:
    return dotted.split(".")[-1]


def _label(dotted: str) -> str:
    if dotted.startswith("torch.distributed."):
        return f"dist.{_short(dotted)}"
    return _short(dotted)


def _axes_label(axes: set[str]) -> str:
    return ", ".join(repr(a) for a in sorted(axes)) if axes \
        else "none defined anywhere in the program"


def _axis_names(mod: ModuleInfo, index: PackageIndex,
                node: Optional[ast.expr]) -> tuple:
    value = literal_in(mod, index, node) if node is not None else None
    if isinstance(value, str):
        return (value,)
    if isinstance(value, tuple):
        return tuple(v for v in value if isinstance(v, str))
    return ()


def _names_span(mod: ModuleInfo, annotation: Optional[ast.expr]) -> bool:
    """True when a parameter annotation names ``ProcessSpan`` (bare,
    dotted, quoted or inside ``Optional[...]``)."""
    if annotation is None:
        return False
    for node in ast.walk(annotation):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _SPAN_CLASS in node.value:
            return True
        if isinstance(node, (ast.Name, ast.Attribute)):
            d = mod.resolve(node)
            name = d if d is not None else (
                node.id if isinstance(node, ast.Name) else node.attr)
            if _short(name) == _SPAN_CLASS:
                return True
    return False


class _Ctx:
    """What the rules need of one module; the scope, parameter and
    branch maps are built on first use (most modules hold no
    collective)."""

    def __init__(self, mod: ModuleInfo, flow: Dataflow):
        self.mod = mod
        self.flow = flow

    @functools.cached_property
    def scope_of(self) -> dict:
        return build_scope_map(self.mod.tree)

    @functools.cached_property
    def span_params(self) -> dict[int, set[str]]:
        """id(function) -> names of its parameters annotated
        ProcessSpan."""
        out: dict[int, set[str]] = {}
        for node in ast.walk(self.mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                out[id(node)] = {
                    p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                    if _names_span(self.mod, p.annotation)}
        return out

    @functools.cached_property
    def branches(self) -> dict[int, tuple]:
        branch_map = _BranchMap()
        branch_map.visit(self.mod.tree)
        return branch_map.branches

    def is_span(self, node: ast.expr) -> bool:
        """Is ``node`` a ``ProcessSpan``?"""
        c = inst_class(self.flow.tag(node))
        if c is not None and _short(c) == _SPAN_CLASS:
            return True
        if isinstance(node, ast.Name):
            scope = self.scope_of.get(id(node))
            while scope is not None:
                if node.id in self.span_params.get(id(scope), ()):
                    return True
                scope = self.scope_of.get(id(scope))
        return False

    def collective(self, call: ast.Call
                   ) -> Optional[tuple[str, Optional[ast.expr]]]:
        """``(label, axis argument)`` when ``call`` is a collective (the
        gang's exchange has no axis)."""
        d = self.mod.resolve(call.func)
        if d in _COLLECTIVES:
            return _label(d), call_arg(call, "axis_name", _COLLECTIVES[d])
        if d in _HOST_EXCHANGE or d in _DIST_COLLECTIVES:
            return _label(d), None
        if d is None and isinstance(call.func, ast.Attribute) \
                and call.func.attr in _SPAN_METHODS:
            if call.func.attr == "all_gather_bytes" \
                    or self.is_span(call.func.value):
                return f"span.{call.func.attr}", None
        return None

    def divergent(self, test: ast.expr) -> Optional[str]:
        """Why a branch condition can differ across shards or processes,
        or None."""
        if is_device(self.flow.tag(test)):
            return "a device tensor (a per-shard value)"
        for node in ast.walk(test):
            if isinstance(node, ast.Call):
                d = self.mod.resolve(node.func)
                if d in _IDENTITY_QUERIES:
                    return f"{_label(d)}() (differs per process or shard)"
            elif isinstance(node, ast.Attribute) and node.attr == "rank" \
                    and self.is_span(node.value):
                return "a ProcessSpan's .rank (differs per process)"
        return None


class _BranchMap(ast.NodeVisitor):
    """id(node) -> enclosing If/While chain, reset at function borders."""

    def __init__(self):
        self.branches: dict[int, tuple] = {}
        self._stack: list = []

    def visit(self, node):
        self.branches[id(node)] = tuple(self._stack)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            saved, self._stack = self._stack, []
            super().generic_visit(node)
            self._stack = saved
            return
        if isinstance(node, (ast.If, ast.While)):
            # the test itself is *outside* the controlled region
            self.branches[id(node.test)] = tuple(self._stack)
            for child in ast.walk(node.test):
                self.branches[id(child)] = tuple(self._stack)
            self._stack.append(node)
            for stmt in node.body + node.orelse:
                self.visit(stmt)
            self._stack.pop()
            return
        super().generic_visit(node)

    def generic_visit(self, node):
        self.visit(node)


def _find_callee(mod: ModuleInfo, scope_of, call: ast.Call,
                 fn_node: ast.expr) -> Optional[ast.AST]:
    """The single FunctionDef/Lambda the shard_map body resolves to, or
    None when unknown or ambiguous (the name is also rebound by an
    Assign somewhere in scope)."""
    if isinstance(fn_node, ast.Lambda):
        return fn_node
    if not isinstance(fn_node, ast.Name):
        return None
    name = fn_node.id
    defs: list[ast.AST] = []
    assigned = False
    scope = scope_of.get(id(call))
    while scope is not None:
        for node in ast.walk(scope):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == name:
                defs.append(node)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and n.id == name:
                            assigned = True
        scope = scope_of.get(id(scope))
    top = mod.toplevel_defs.get(name)
    if isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)):
        defs.append(top)
    if name in mod.constants:
        assigned = True
    if assigned or len(set(id(d) for d in defs)) != 1:
        return None
    return defs[0]


def _positional_arity(fdef) -> int:
    a = fdef.args
    return len(a.posonlyargs) + len(a.args)


def _literal_tuple_arity(node: ast.expr) -> Optional[int]:
    if isinstance(node, (ast.Tuple, ast.List)):
        return len(node.elts)
    return None


def _return_arities(fdef) -> set[Optional[int]]:
    """Literal tuple length of each return in ``fdef``'s own scope
    (None = a non-tuple / unknown-arity return)."""
    if isinstance(fdef, ast.Lambda):
        return set()  # a lambda has no return statement to read
    scope_of = build_scope_map(ast.Module(body=[fdef], type_ignores=[]))
    out: set[Optional[int]] = set()
    for node in ast.walk(fdef):
        if isinstance(node, ast.Return) and scope_of.get(id(node)) is fdef:
            out.add(_literal_tuple_arity(node.value)
                    if node.value is not None else None)
    return out


def _placement_axis(mod: ModuleInfo, node: ast.AST
                    ) -> Optional[tuple[str, ast.expr]]:
    """``(what, axis node)`` for a placement-side axis use."""
    if isinstance(node, ast.Call):
        d = mod.resolve(node.func)
        if d is not None and _short(d) == "Placement":
            axis = call_arg(node, "axis", 1)
            return ("Placement", axis) if axis is not None else None
        if d is None and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "axis_devices":
            axis = call_arg(node, "axis", 0)
            return ("axis_devices()", axis) if axis is not None else None
    elif isinstance(node, ast.Subscript) \
            and isinstance(node.value, ast.Attribute) \
            and node.value.attr in ("shape", "local_shape"):
        return f"mesh.{node.value.attr}[]", node.slice
    return None


def check(modules: list[ModuleInfo], index: PackageIndex,
          flows: dict[str, Dataflow], ctx) -> list[Finding]:
    findings: list[Finding] = []
    axes = index.mesh_axes
    for mod in modules:
        c = _Ctx(mod, flows[mod.relpath])
        for node in ast.walk(mod.tree):
            placed = _placement_axis(mod, node)
            if placed is not None:
                what, axis_node = placed
                for axis in _axis_names(mod, index, axis_node):
                    if axis not in axes:
                        findings.append(Finding(
                            "W604", mod.relpath, node.lineno,
                            node.col_offset,
                            f"{what} axis {axis!r} is not defined by any "
                            f"mesh — known axes: {_axes_label(axes)}"))
                continue
            if not isinstance(node, ast.Call):
                continue
            hit = c.collective(node)
            if hit is not None:
                short, axis_node = hit
                for axis in _axis_names(mod, index, axis_node):
                    if axis not in axes:
                        findings.append(Finding(
                            "W601", mod.relpath, node.lineno,
                            node.col_offset,
                            f"{short}() over unknown axis {axis!r} — no "
                            f"shard runner or *_AXIS constant defines it; "
                            f"known axes: {_axes_label(axes)}"))
                for branch in c.branches.get(id(node), ()):
                    why = c.divergent(branch.test)
                    if why is not None:
                        kind = "if" if isinstance(branch, ast.If) \
                            else "while"
                        findings.append(Finding(
                            "W602", mod.relpath, node.lineno,
                            node.col_offset,
                            f"{short}() under a Python `{kind}` (line "
                            f"{branch.lineno}) branching on {why} — "
                            f"shards or processes that disagree about "
                            f"entering the branch leave the collective's "
                            f"barrier waiting; hoist it out or branch on "
                            f"a value every member agrees on"))
                        break  # one W602 per collective is enough
            elif is_shard_runner(mod, node, "shard_map") and node.args:
                findings.extend(_check_shard_map(mod, c.scope_of, node))
    return findings


def _check_shard_map(mod: ModuleInfo, scope_of,
                     call: ast.Call) -> list[Finding]:
    findings: list[Finding] = []
    callee = _find_callee(mod, scope_of, call, call.args[0])
    if callee is None:
        return findings
    name = getattr(callee, "name", "<lambda>")
    in_specs = call_arg(call, "in_specs", _IN_SPECS_POS)
    out_specs = call_arg(call, "out_specs", _OUT_SPECS_POS)
    if in_specs is not None:
        want = _literal_tuple_arity(in_specs)
        have = _positional_arity(callee)
        if want is not None and want != have:
            findings.append(Finding(
                "W603", mod.relpath, call.lineno, call.col_offset,
                f"shard_map in_specs has {want} spec(s) but "
                f"{name}() takes {have} positional argument(s) — "
                f"each positional argument needs exactly one spec"))
    if out_specs is not None:
        want = _literal_tuple_arity(out_specs)
        if want is not None:
            arities = _return_arities(callee)
            if arities and None not in arities and \
                    all(a != want for a in arities):
                got = sorted(a for a in arities if a is not None)
                findings.append(Finding(
                    "W603", mod.relpath, call.lineno, call.col_offset,
                    f"shard_map out_specs has {want} spec(s) but "
                    f"{name}() returns tuple(s) of length "
                    f"{'/'.join(map(str, got))} — out_specs must "
                    f"mirror the return structure"))
    return findings
