"""Module loading and whole-package name resolution for photonlint.

Port of ``photon_ml_tpu/analysis/package.py``. Everything here is
syntactic: modules are parsed with the stdlib ``ast`` (never imported —
linting must not execute package code or require torch), and names are
resolved through each module's import aliases. Resolution returns
*dotted* names (``torch.cat``,
``photon_ml_tpu_torch.evaluation.metrics.peak_f1``) that the rule modules
classify; a name that cannot be resolved resolves to ``None`` and every
downstream consumer treats unknown as "not mine" (lint stays precise
rather than noisy).

The port traces nothing, so the JAX module's jit bindings and call
graph (which only W2, W3 and W7 read) are left out; the index instead
records which package classes are ``torch.nn.Module`` subclasses, whose
instances the dataflow calls like functions. The mesh-axis universe
(W6) is built from the port's own defining sites: ``*_AXIS`` string
constants and a literal axis given to the shard runner
(``collectives.run_shards`` / ``shard_map``, the port's counterpart of
``jax.pmap(axis_name=...)``).
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Optional

from photon_ml_tpu_torch.analysis.core import Finding, parse_suppressions

PACKAGE_PREFIX = "photon_ml_tpu_torch."

@dataclasses.dataclass
class ModuleInfo:
    """One parsed source file plus its resolution tables."""

    path: Path
    relpath: str  # posix, relative to the lint root
    module_name: str  # dotted guess from relpath ("tools.photonlint")
    source: str
    lines: list[str]
    tree: ast.Module
    imports: dict[str, str]  # local alias -> dotted target
    toplevel_defs: dict[str, ast.AST]  # name -> FunctionDef/ClassDef
    constants: dict[str, ast.expr]  # name -> module-level literal expr
    suppressions: dict[int, list[tuple[str, str]]]
    malformed: list[Finding]

    @classmethod
    def load(cls, path: Path, root: Path) -> "ModuleInfo":
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
        relpath = path.relative_to(root).as_posix()
        module_name = relpath[:-3].replace("/", ".") \
            if relpath.endswith(".py") else relpath.replace("/", ".")
        if module_name.endswith(".__init__"):
            module_name = module_name[: -len(".__init__")]
        imports = _collect_imports(tree, module_name)
        toplevel_defs = {}
        constants = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                toplevel_defs[node.name] = node
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                constants[node.targets[0].id] = node.value
        lines = source.splitlines()
        suppressions, malformed = parse_suppressions(lines, relpath)
        return cls(path=path, relpath=relpath, module_name=module_name,
                   source=source, lines=lines, tree=tree, imports=imports,
                   toplevel_defs=toplevel_defs, constants=constants,
                   suppressions=suppressions, malformed=malformed)

    # -- name resolution ---------------------------------------------------

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name for a Name/Attribute chain, through import aliases.

        A module-local top-level def resolves to
        ``<module_name>.<name>`` so cross-module call edges line up with
        the other side's definition index.
        """
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.imports.get(node.id)
        if base is None:
            if node.id in self.toplevel_defs or node.id in self.constants:
                base = f"{self.module_name}.{node.id}"
            else:
                return None
        parts.append(base)
        return ".".join(reversed(parts))

    def literal(self, node: ast.AST):
        """Best-effort literal value: direct literal or a one-hop
        module-level constant (``static_argnames=_STATIC``). Returns
        ``None`` when unresolvable."""
        if isinstance(node, ast.Name) and node.id in self.constants:
            node = self.constants[node.id]
        try:
            return ast.literal_eval(node)
        except (ValueError, TypeError, SyntaxError):
            return None


def _collect_imports(tree: ast.Module, module_name: str) -> dict[str, str]:
    imports: dict[str, str] = {}
    pkg_parts = module_name.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                target = alias.name if alias.asname else \
                    alias.name.split(".")[0]
                imports[local] = target
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative import: anchor to this package
                anchor = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                base = ".".join(anchor + ([node.module] if node.module
                                          else []))
            else:
                base = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                imports[local] = f"{base}.{alias.name}" if base \
                    else alias.name
    return imports


# -- class index -----------------------------------------------------------


@dataclasses.dataclass
class ClassInfo:
    """One top-level class: its methods plus what its attributes hold.

    ``attr_classes`` maps an attribute name to the dotted name of the
    package class its value is known to be — from dataclass/field
    annotations and from ``self.x = SomeClass(...)`` assignments in
    ``__init__``. This is what lets the dataflow follow
    ``coord.score(...)`` through ``self.opt.step(...)`` chains.
    """

    dotted: str
    mod: ModuleInfo
    node: ast.ClassDef
    methods: dict[str, ast.AST]  # name -> FunctionDef
    attr_classes: dict[str, str]  # attribute -> dotted package class
    bases: list[str]  # resolved dotted base classes


def _class_info(mod: ModuleInfo, node: ast.ClassDef,
                class_names: set[str]) -> ClassInfo:
    dotted = f"{mod.module_name}.{node.name}"
    methods: dict[str, ast.AST] = {}
    attr_classes: dict[str, str] = {}
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods[item.name] = item
        elif isinstance(item, ast.AnnAssign) and \
                isinstance(item.target, ast.Name):
            # dataclass-style field: x: SomeClass
            ann = mod.resolve(item.annotation)
            if ann in class_names:
                attr_classes[item.target.id] = ann
    init = methods.get("__init__")
    if init is not None:
        for stmt in ast.walk(init):
            target = value = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target, value = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and \
                    stmt.value is not None:
                target, value = stmt.target, stmt.value
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                continue
            if isinstance(value, ast.Call):
                callee = mod.resolve(value.func)
                if callee in class_names:
                    attr_classes.setdefault(target.attr, callee)
    bases = [b for b in (mod.resolve(b) for b in node.bases)
             if b in class_names]
    return ClassInfo(dotted=dotted, mod=mod, node=node, methods=methods,
                     attr_classes=attr_classes, bases=bases)


# -- literal resolution ---------------------------------------------------


def literal_in(mod: ModuleInfo, index: "PackageIndex", node: ast.AST):
    """Like ``ModuleInfo.literal`` but resolves Name/Attribute chains
    through the whole-package constant table and evaluates tuples/lists
    elementwise — e.g. ``(DATA_AXIS, ENTITY_AXIS)`` where both names are
    imported from another module. Returns None when unresolvable."""
    if isinstance(node, (ast.Tuple, ast.List)):
        elts = [literal_in(mod, index, e) for e in node.elts]
        if any(e is None for e in elts):
            return None
        return tuple(elts)
    if isinstance(node, (ast.Name, ast.Attribute)):
        dotted = mod.resolve(node)
        if dotted is not None:
            value = index.resolve_constant(dotted)
            if value is not None:
                return value
        if isinstance(node, ast.Name) and node.id in mod.constants:
            return mod.literal(node)
        return None
    try:
        return ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError):
        return None


def name_value(mod: ModuleInfo, index: "PackageIndex",
               node: ast.AST) -> tuple[str, Optional[str]]:
    """Bounded string abstraction for protocol/telemetry names.

    Returns ``("literal", s)`` for a statically known string (direct
    literal or constant resolved through the package),
    ``("prefix", head)`` for an f-string with a non-empty literal head
    (``f"serve.combine[b{n}]"`` → prefix ``serve.combine[b``), and
    ``("dynamic", None)`` for everything else — the WA00/WB00
    "unauditable name" bucket.
    """
    if isinstance(node, ast.JoinedStr):
        head = node.values[0] if node.values else None
        if isinstance(head, ast.Constant) and isinstance(head.value, str) \
                and head.value:
            return ("prefix", head.value)
        return ("dynamic", None)
    value = literal_in(mod, index, node)
    if isinstance(value, str):
        return ("literal", value)
    return ("dynamic", None)


# -- mesh-axis universe ----------------------------------------------------

# The shard runner's entry points: a literal axis given to one of them
# *defines* that axis for its body (``jax.pmap(axis_name=...)``'s role).
# Collectives never add to the universe — otherwise a typo'd psum axis
# would define itself and W601 could not fire.
SHARD_RUNNERS = {"run_shards", "shard_map"}


def call_arg(call: ast.Call, kwarg: str, pos: int) -> Optional[ast.expr]:
    """A call's argument given as ``kwarg=`` or at position ``pos``."""
    for kw in call.keywords:
        if kw.arg == kwarg:
            return kw.value
    if pos < len(call.args):
        return call.args[pos]
    return None


def is_shard_runner(mod: ModuleInfo, call: ast.Call,
                    name: Optional[str] = None) -> bool:
    """True for a call to ``collectives.run_shards`` / ``shard_map``
    (``name`` narrows to one of them). Exact last-component match —
    ``run_glm_shard_map`` is a *user* of the runner, not the runner."""
    names = {name} if name is not None else SHARD_RUNNERS
    d = mod.resolve(call.func)
    if d is not None:
        return d.rsplit(".", 1)[-1] in names
    fname = call.func.id if isinstance(call.func, ast.Name) else (
        call.func.attr if isinstance(call.func, ast.Attribute) else None)
    return fname in names


def collect_mesh_axes(index: "PackageIndex") -> set[str]:
    """Every axis name the program can legitimately collective over:
    ``*_AXIS`` string module constants (the package's naming convention
    for mesh axes, ``parallel/mesh.py``) and the literal axes given to
    the shard runner (``run_shards(body, devices, "mf", ...)``)."""
    axes: set[str] = set()
    for mod in index.modules:
        for name, value in mod.constants.items():
            if name.endswith("_AXIS") and isinstance(value, ast.Constant) \
                    and isinstance(value.value, str):
                axes.add(value.value)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and is_shard_runner(mod, node)):
                continue
            spec = call_arg(node, "axis_name", 2)
            value = literal_in(mod, index, spec) \
                if spec is not None else None
            if isinstance(value, str):
                axes.add(value)
    return axes


# -- package index ---------------------------------------------------------


@dataclasses.dataclass
class PackageIndex:
    """Cross-module facts the rules share."""

    modules: list[ModuleInfo]
    functions: dict[str, tuple[ModuleInfo, ast.AST]]  # top-level defs
    classes: dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    by_module_name: dict[str, ModuleInfo] = dataclasses.field(
        default_factory=dict)
    # dotted names known to return device tensors (filled by the
    # dataflow's fixpoint), and ``<class>.<method>`` keys likewise
    device_fns: set[str] = dataclasses.field(default_factory=set)
    device_methods: set[str] = dataclasses.field(default_factory=set)
    # package classes deriving from torch.nn.Module: calling an instance
    # runs its forward and yields a device tensor
    module_classes: set[str] = dataclasses.field(default_factory=set)
    mesh_axes: set[str] = dataclasses.field(default_factory=set)

    def resolve_constant(self, dotted: str):
        """Literal value of a fully-qualified module constant, following
        the definition across modules (``pkg.parallel.mesh.ENTITY_AXIS``
        → ``"entity"``). None when the module is outside the lint run or
        the value is not a literal."""
        if "." not in dotted:
            return None
        mod_name, attr = dotted.rsplit(".", 1)
        mod = self.by_module_name.get(mod_name)
        if mod is None or attr not in mod.constants:
            return None
        return mod.literal(mod.constants[attr])

    def resolve_alias(self, dotted: Optional[str]) -> Optional[str]:
        """``dotted`` through module-level aliases of a dotted name
        (``Tensor = torch.Tensor`` in a package module, imported or
        local) to what it names; anything else is returned as it is."""
        seen: set[str] = set()
        while dotted is not None and "." in dotted and dotted not in seen:
            seen.add(dotted)
            mod_name, attr = dotted.rsplit(".", 1)
            mod = self.by_module_name.get(mod_name)
            node = mod.constants.get(attr) if mod is not None else None
            if not isinstance(node, (ast.Name, ast.Attribute)):
                break
            target = mod.resolve(node)
            if target is None:
                break
            dotted = target
        return dotted

    def resolve_method(
        self, class_dotted: str, method: str
    ) -> Optional[tuple[ClassInfo, ast.AST]]:
        """Look ``method`` up on a class, walking package base classes."""
        seen: set[str] = set()
        stack = [class_dotted]
        while stack:
            current = stack.pop(0)
            if current in seen:
                continue
            seen.add(current)
            info = self.classes.get(current)
            if info is None:
                continue
            if method in info.methods:
                return info, info.methods[method]
            stack.extend(info.bases)
        return None

    def attr_class(self, class_dotted: str,
                   attr: str) -> Optional[str]:
        """Dotted class of ``<instance of class_dotted>.<attr>``, walking
        package base classes."""
        seen: set[str] = set()
        stack = [class_dotted]
        while stack:
            current = stack.pop(0)
            if current in seen:
                continue
            seen.add(current)
            info = self.classes.get(current)
            if info is None:
                continue
            if attr in info.attr_classes:
                return info.attr_classes[attr]
            stack.extend(info.bases)
        return None


def build_index(modules: list[ModuleInfo]) -> PackageIndex:
    functions: dict[str, tuple[ModuleInfo, ast.AST]] = {}
    class_names: set[str] = set()
    for mod in modules:
        for name, node in mod.toplevel_defs.items():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                functions[f"{mod.module_name}.{name}"] = (mod, node)
            elif isinstance(node, ast.ClassDef):
                class_names.add(f"{mod.module_name}.{name}")
    classes: dict[str, ClassInfo] = {}
    for mod in modules:
        for name, node in mod.toplevel_defs.items():
            if isinstance(node, ast.ClassDef):
                info = _class_info(mod, node, class_names)
                classes[info.dotted] = info
    index = PackageIndex(modules=modules, functions=functions,
                         classes=classes,
                         by_module_name={m.module_name: m
                                         for m in modules})
    index.module_classes = _module_classes(classes)
    index.mesh_axes = collect_mesh_axes(index)
    return index


def _is_nn_class(dotted: Optional[str]) -> bool:
    """``torch.nn.Module`` or one of torch's own layers (``torch.nn.X``
    with a capitalised last part)."""
    return dotted is not None and dotted.startswith("torch.nn.") \
        and dotted.rsplit(".", 1)[-1][:1].isupper()


def _module_classes(classes: dict[str, ClassInfo]) -> set[str]:
    """Package classes with ``torch.nn.Module`` among their (transitive)
    bases."""
    out = {info.dotted for info in classes.values()
           if any(_is_nn_class(info.mod.resolve(b))
                  for b in info.node.bases)}
    grew = True
    while grew:
        grew = False
        for info in classes.values():
            if info.dotted not in out and any(b in out
                                              for b in info.bases):
                out.add(info.dotted)
                grew = True
    return out
