"""WBxx — telemetry-taxonomy drift.

Port of ``photon_ml_tpu/analysis/rules_telemetry.py``. The port emits
the JAX package's names, so it reconciles against the same README
taxonomy tables, read through one more table of the README's port
section: "Telemetry names that differ in the port" (header ``| name |
kind | JAX package | port | why |``). A row the port emits and the JAX
package does not joins the taxonomy (and fires WB02 when nothing in the
port emits it); a row only the JAX package emits leaves it (and fires
WB01 where the port emits it after all). That table is the only place
such a difference may live; without it the rules are the JAX rules.

The observability plane is held together by names: every
``REGISTRY.counter/gauge/histogram("...")`` emit, every
``trace.span("...")`` / ``trace.record_span("...")``, the README
taxonomy tables operators read, and
the consumers that read the stream (in the port: ``chip_smoke.py``'s
checks, the crash/resume drill). A renamed counter breaks the dashboard
silently: the emit side keeps counting, the consumer reads ``None``
forever. These rules reconcile the three corners:

- **WB00** a telemetry name built from a fully dynamic expression —
  statically unauditable (an f-string with a literal head is tracked
  as a prefix and matched by prefix everywhere below; a name drawn
  from a same-scope ``for name, ... in <literal tuple of tuples>``
  loop — the stage-span table idiom — resolves to each row's literal
  first element, constant slices included, so data-driven emit loops
  stay auditable without suppressions).
- **WB01** an emitted metric/span name missing from the README
  taxonomy tables (the ``| span |`` / ``| metric |`` tables).
- **WB02** a README taxonomy row naming a metric/span nothing emits.
- **WB03** a *consumer* reading a metric/span name nothing emits —
  the phantom-consumer / silent-dashboard bug class. Consumer shapes:
  ``totals.get("name")`` / ``totals["name"]`` reads off heartbeat
  ``metric_totals``, record-name comparisons
  (``rec.get("name") == "cd.update"``, directly or through a local),
  registry READS (``.counter("x").total()/.by_label()``), and literal
  arguments to helpers whose parameter flows into a totals lookup.
- **WB04** label-key drift between emit sites sharing one name: the
  per-label breakdown silently fragments when one site tags
  ``reason=`` and another doesn't. Only sites whose mutate call
  (``.inc/.set/.observe``) is statically linked (chained or through a
  same-scope local) contribute a label set; unresolved sites are
  EXCLUDED, not treated as empty.

Reconciliation against the README only runs when the relevant table
exists (fixture runs pass READMEs without them). Consumer files that
are not part of the lint path set (``chip_smoke.py``) are loaded as
*auxiliary* modules by the runner — they are scanned for
reads and honor inline suppressions, but no other family lints them.

The registry/trace implementations themselves (``obs/metrics.py``,
``obs/trace.py``) are skipped — their parameterized emit shims would
read as dynamic-name emits.
"""

from __future__ import annotations

import ast
import re

from photon_ml_tpu_torch.analysis.core import Finding
from photon_ml_tpu_torch.analysis.dataflow import Dataflow
from photon_ml_tpu_torch.analysis.package import (
    ModuleInfo, PackageIndex, name_value,
)

_METRIC_ATTRS = {"counter", "gauge", "histogram"}
_MUTATORS = {"inc", "set", "observe"}
_READERS = {"total", "value", "by_label", "records", "snapshot", "items"}
_SKIP_SUFFIXES = ("obs/metrics.py", "obs/trace.py")

_T_HEADER_RE = re.compile(r"^\s*\|\s*(span|metric)s?\s*\|",
                          re.IGNORECASE)
_TABLE_LINE_RE = re.compile(r"^\s*\|")
_NAME_RE = re.compile(r"`([\w.\-\[\]*]+)`")
_CONSUMED_NAME_RE = re.compile(r"^[a-z][a-z0-9_.]*$")


def parse_taxonomy(readme_lines: list[str]) -> dict[str, dict[str, int]]:
    """``{"span": {name: line}, "metric": {name: line}}`` from every
    markdown table whose header's first cell is ``span`` or ``metric``.
    A namespace that has NO table at all is absent from the result —
    the caller skips reconciliation for it (fixture READMEs). One row's
    first cell may document several names (``ckpt.save`` /
    ``ckpt.restore``)."""
    out: dict[str, dict[str, int]] = {}
    namespace = None
    for i, line in enumerate(readme_lines, start=1):
        if namespace is None:
            m = _T_HEADER_RE.match(line)
            if m:
                namespace = m.group(1).lower()
                out.setdefault(namespace, {})
            continue
        if not _TABLE_LINE_RE.match(line):
            namespace = None
            m = _T_HEADER_RE.match(line)
            if m:
                namespace = m.group(1).lower()
                out.setdefault(namespace, {})
            continue
        cells = line.split("|")
        first = cells[1] if len(cells) > 1 else ""
        for name in _NAME_RE.findall(first):
            out[namespace].setdefault(name, i)
    return out


_DELTA_HEADER_RE = re.compile(
    r"^\s*\|\s*name\s*\|\s*kind\s*\|\s*JAX package\s*\|\s*port\s*\|",
    re.IGNORECASE)
_KIND_NAMESPACE = {"span": "span", "counter": "metric", "gauge": "metric",
                   "histogram": "metric"}


def parse_port_delta(readme_lines: list[str]
                     ) -> dict[str, dict[str, dict[str, int]]]:
    """``{"port": {namespace: {name: line}}, "jax": {...}}`` from the
    README's table of telemetry names that differ in the port: the names
    only the port emits, and the names only the JAX package emits (a
    ``yes`` in one emitter's column and not the other's)."""
    out: dict[str, dict[str, dict[str, int]]] = {"port": {}, "jax": {}}
    in_table = False
    for i, line in enumerate(readme_lines, start=1):
        if not in_table:
            in_table = bool(_DELTA_HEADER_RE.match(line))
            continue
        if not _TABLE_LINE_RE.match(line):
            break
        cells = [c.strip() for c in line.split("|")[1:-1]]
        if len(cells) < 4:
            continue
        namespace = _KIND_NAMESPACE.get(cells[1].strip("`").lower())
        jax_emits = cells[2].lower() == "yes"
        port_emits = cells[3].lower() == "yes"
        if namespace is None or jax_emits == port_emits:
            continue
        side = "port" if port_emits else "jax"
        for name in _NAME_RE.findall(cells[0]):
            out[side].setdefault(namespace, {}).setdefault(name, i)
    return out


def _scoped_walk(root: ast.AST):
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _scopes(mod: ModuleInfo):
    """Every analysis scope: the module top level, then each def."""
    yield mod.tree
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _metric_call(mod: ModuleInfo, index: PackageIndex, node: ast.AST):
    """``(kind, form, name, name_node)`` when ``node`` constructs a
    metric handle (``<reg>.counter("x")``) or opens a span
    (``trace.span("x", ...)``), else None."""
    if not (isinstance(node, ast.Call) and node.args):
        return None
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _METRIC_ATTRS:
        form, name = name_value(mod, index, node.args[0])
        return (node.func.attr, form, name, node.args[0])
    dotted = mod.resolve(node.func)
    if dotted is not None and "trace" in dotted \
            and (dotted.endswith(".span")
                 or dotted.endswith(".record_span")):
        form, name = name_value(mod, index, node.args[0])
        return ("span", form, name, node.args[0])
    return None


def _mutator_labels(call: ast.Call) -> frozenset:
    return frozenset(kw.arg for kw in call.keywords
                     if kw.arg is not None)


class _Site:
    __slots__ = ("kind", "form", "name", "mod", "line", "col", "labels")

    def __init__(self, kind, form, name, mod, node, labels):
        self.kind = kind          # counter | gauge | histogram | span
        self.form = form          # literal | prefix
        self.name = name
        self.mod = mod
        self.line = node.lineno
        self.col = node.col_offset
        self.labels = labels      # frozenset | None (unresolved)


def _literal_seq(node: ast.AST):
    """First-element string literals of a literal tuple/list whose
    every element is itself a tuple/list led by a string constant
    (the ``(("serve.batch_form", s, e), ...)`` span-table idiom);
    None when any row breaks the shape."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    names: list[str] = []
    for elt in node.elts:
        if (isinstance(elt, (ast.Tuple, ast.List)) and elt.elts
                and isinstance(elt.elts[0], ast.Constant)
                and isinstance(elt.elts[0].value, str)):
            names.append(elt.elts[0].value)
        else:
            return None
    return names


def _iter_literal_names(node: ast.AST, seq_vars: dict):
    """Resolve a ``for``-loop iterable to the literal names it yields:
    an inline span table, a local bound to one, or a constant slice of
    such a local (``stage_spans[1:]``)."""
    direct = _literal_seq(node)
    if direct is not None:
        return direct
    if isinstance(node, ast.Name):
        return seq_vars.get(node.id)
    if isinstance(node, ast.Subscript) \
            and isinstance(node.value, ast.Name) \
            and node.value.id in seq_vars \
            and isinstance(node.slice, ast.Slice):
        bounds = []
        for b in (node.slice.lower, node.slice.upper, node.slice.step):
            if b is None:
                bounds.append(None)
            elif isinstance(b, ast.Constant) and isinstance(b.value, int):
                bounds.append(b.value)
            else:
                return None
        return seq_vars[node.value.id][slice(*bounds)]
    return None


def _collect_loop_emits(scope: ast.AST, mod: ModuleInfo,
                        index: PackageIndex) -> dict[int, tuple]:
    """``{id(call): literal names}`` for every telemetry call whose
    name argument is a loop variable bound — by the INNERMOST enclosing
    for-loop, so two loops reusing one variable name never cross — to
    a statically literal span table."""
    seq_vars: dict[str, list] = {}
    for node in _scoped_walk(scope):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            names = _literal_seq(node.value)
            if names is not None:
                seq_vars[node.targets[0].id] = names
    out: dict[int, tuple] = {}

    def visit(node: ast.AST, bindings: dict) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.For):
            names = _iter_literal_names(node.iter, seq_vars)
            if names and isinstance(node.target, ast.Tuple) \
                    and node.target.elts \
                    and isinstance(node.target.elts[0], ast.Name):
                bindings = dict(bindings)
                bindings[node.target.elts[0].id] = tuple(names)
        inner = _metric_call(mod, index, node)
        if inner is not None:
            _kind, form, _name, name_node = inner
            if form == "dynamic" and isinstance(name_node, ast.Name) \
                    and name_node.id in bindings:
                out[id(node)] = bindings[name_node.id]
        for child in ast.iter_child_nodes(node):
            visit(child, bindings)

    for child in ast.iter_child_nodes(scope):
        visit(child, {})
    return out


def _scan_module(mod: ModuleInfo, index: PackageIndex,
                 emits: list, consumes: list, findings: list) -> None:
    """One module's emit sites, registry-read consumes, and WB00s."""
    skip_emits = mod.relpath.endswith(_SKIP_SUFFIXES)
    for scope in _scopes(mod):
        handled: set[int] = set()
        var_metric: dict[str, tuple] = {}
        loop_emits = _collect_loop_emits(scope, mod, index)
        # pass 1: chained forms and handle-variable bindings
        for node in _scoped_walk(scope):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Call):
                inner = _metric_call(mod, index, node.func.value)
                if inner is not None:
                    handled.add(id(node.func.value))
                    kind, form, name, name_node = inner
                    if form == "dynamic":
                        if not skip_emits:
                            findings.append(_wb00(mod, name_node, kind))
                        continue
                    if node.func.attr in _MUTATORS and kind != "span":
                        if not skip_emits:
                            emits.append(_Site(
                                kind, form, name, mod, name_node,
                                _mutator_labels(node)))
                    elif node.func.attr in _READERS:
                        consumes.append((form, name, mod, node))
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                inner = _metric_call(mod, index, node.value)
                if inner is not None and inner[0] != "span":
                    handled.add(id(node.value))
                    var_metric[node.targets[0].id] = inner
        # pass 2: mutations/reads through a bound handle variable
        seen_vars: set[str] = set()
        for node in _scoped_walk(scope):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in var_metric):
                continue
            kind, form, name, name_node = var_metric[node.func.value.id]
            if form == "dynamic":
                if node.func.value.id not in seen_vars \
                        and not skip_emits:
                    findings.append(_wb00(mod, name_node, kind))
                    seen_vars.add(node.func.value.id)
                continue
            if node.func.attr in _MUTATORS:
                if not skip_emits:
                    emits.append(_Site(kind, form, name, mod, node,
                                       _mutator_labels(node)))
            elif node.func.attr in _READERS:
                consumes.append((form, name, mod, node))
        # pass 3: spans and unlinked metric handles
        for node in _scoped_walk(scope):
            inner = _metric_call(mod, index, node)
            if inner is None or id(node) in handled:
                continue
            kind, form, name, name_node = inner
            if kind != "span":
                continue  # bare unlinked handle: neither emit nor read
            if skip_emits:
                continue
            if form == "dynamic":
                names = loop_emits.get(id(node))
                if names is not None:
                    for nm in names:
                        emits.append(_Site(kind, "literal", nm, mod,
                                           name_node,
                                           _mutator_labels(node)))
                else:
                    findings.append(_wb00(mod, name_node, kind))
            else:
                emits.append(_Site(kind, form, name, mod, name_node,
                                   _mutator_labels(node)))


def _wb00(mod: ModuleInfo, node: ast.AST, kind: str) -> Finding:
    return Finding(
        "WB00", mod.relpath, node.lineno, node.col_offset,
        f"{kind} name is a fully dynamic expression — the telemetry "
        f"taxonomy must stay statically auditable (use a literal or an "
        f"f-string with a literal head, or suppress with the reason "
        f"the name is dynamic)")


# -- consumer-side scan ----------------------------------------------------


def _totals_recv(node: ast.AST) -> bool:
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover
        return False
    return text.endswith("totals")


def _literal_names(node: ast.AST):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str)]
    return []


def _totals_helpers(mods: list[ModuleInfo]) -> dict[str, int]:
    """``{dotted function name: param index}`` for helpers whose
    parameter flows into a totals lookup (``totals.get(name)`` /
    ``totals[name]`` / ``name in totals``)."""
    out: dict[str, int] = {}
    for mod in mods:
        for fdef in ast.walk(mod.tree):
            if not isinstance(fdef, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            params = [a.arg for a in fdef.args.posonlyargs
                      + fdef.args.args]
            if not params:
                continue
            flow_params: set[str] = set()
            for node in _scoped_walk(fdef):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "get" and node.args
                        and isinstance(node.args[0], ast.Name)
                        and _totals_recv(node.func.value)):
                    flow_params.add(node.args[0].id)
                elif (isinstance(node, ast.Subscript)
                        and isinstance(node.slice, ast.Name)
                        and _totals_recv(node.value)):
                    flow_params.add(node.slice.id)
                elif (isinstance(node, ast.Compare)
                        and len(node.ops) == 1
                        and isinstance(node.ops[0], (ast.In, ast.NotIn))
                        and isinstance(node.left, ast.Name)
                        and _totals_recv(node.comparators[0])):
                    flow_params.add(node.left.id)
            for p in flow_params:
                if p in params:
                    out[f"{mod.module_name}.{fdef.name}"] = \
                        params.index(p)
    return out


def _scan_consumers(mod: ModuleInfo, helpers: dict[str, int],
                    consumes: list) -> None:
    """Totals reads, record-name comparisons, and helper calls."""
    for scope in _scopes(mod):
        namevars: set[str] = set()
        if scope is not mod.tree:
            for node in _scoped_walk(scope):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Call)
                        and isinstance(node.value.func, ast.Attribute)
                        and node.value.func.attr == "get"
                        and node.value.args
                        and isinstance(node.value.args[0], ast.Constant)
                        and node.value.args[0].value == "name"):
                    namevars.add(node.targets[0].id)
        for node in _scoped_walk(scope):
            # totals.get("x") / totals["x"]
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and _totals_recv(node.func.value)):
                consumes.append(("literal", node.args[0].value, mod,
                                 node))
            elif (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)
                    and _totals_recv(node.value)):
                consumes.append(("literal", node.slice.value, mod,
                                 node))
            # rec.get("name") == "cd.update" / name in ("a", "b")
            elif (isinstance(node, ast.Compare) and len(node.ops) == 1
                    and isinstance(node.ops[0],
                                   (ast.Eq, ast.NotEq, ast.In,
                                    ast.NotIn))):
                left = node.left
                is_name_read = (
                    isinstance(left, ast.Name) and left.id in namevars)
                if not is_name_read and isinstance(left, ast.Call) \
                        and isinstance(left.func, ast.Attribute) \
                        and left.func.attr == "get" and left.args \
                        and isinstance(left.args[0], ast.Constant) \
                        and left.args[0].value == "name":
                    is_name_read = True
                if not is_name_read and isinstance(left, ast.Subscript) \
                        and isinstance(left.slice, ast.Constant) \
                        and left.slice.value == "name":
                    is_name_read = True
                if not is_name_read:
                    continue
                for name in _literal_names(node.comparators[0]):
                    if _CONSUMED_NAME_RE.match(name):
                        consumes.append(("literal", name, mod, node))
            # _serve_metric_total(trace, "retries")-style helper calls
            elif isinstance(node, ast.Call):
                dotted = mod.resolve(node.func)
                if dotted in helpers:
                    pos = helpers[dotted]
                    if pos < len(node.args) and isinstance(
                            node.args[pos], ast.Constant) and isinstance(
                            node.args[pos].value, str):
                        consumes.append(("literal",
                                         node.args[pos].value, mod,
                                         node.args[pos]))


# -- driver ----------------------------------------------------------------


def check(modules: list[ModuleInfo], index: PackageIndex,
          flows: dict[str, Dataflow], ctx) -> list[Finding]:
    findings: list[Finding] = []
    aux = list(getattr(ctx, "aux_modules", None) or [])
    emits: list[_Site] = []
    consumes: list[tuple] = []   # (form, name, mod, node)
    for mod in modules:
        _scan_module(mod, index, emits, consumes, findings)
    helpers = _totals_helpers(modules + aux)
    for mod in modules + aux:
        _scan_consumers(mod, helpers, consumes)

    emitted_literals = {s.name for s in emits if s.form == "literal"}
    emitted_prefixes = {s.name for s in emits if s.form == "prefix"}

    def emitted(name: str) -> bool:
        return name in emitted_literals or any(
            name.startswith(p) for p in emitted_prefixes)

    # WB01/WB02 — README reconcile, per namespace, when a table exists
    taxonomy = parse_taxonomy(ctx.readme_lines) \
        if ctx.readme_lines is not None else {}
    delta = parse_port_delta(ctx.readme_lines) \
        if ctx.readme_lines is not None else {"port": {}, "jax": {}}
    jax_only: dict[str, set[str]] = {}
    for namespace, table in taxonomy.items():
        table.update(delta["port"].get(namespace, {}))
        jax_only[namespace] = set(delta["jax"].get(namespace, {}))
        for name in jax_only[namespace]:
            table.pop(name, None)
    for namespace, is_ns in (("span", lambda s: s.kind == "span"),
                             ("metric", lambda s: s.kind != "span")):
        table = taxonomy.get(namespace)
        if table is None:
            continue
        first_site: dict[str, _Site] = {}
        ns_names: set[str] = set()
        ns_prefixes: set[str] = set()
        for s in sorted((s for s in emits if is_ns(s)),
                        key=lambda s: (s.mod.relpath, s.line, s.col)):
            (ns_prefixes if s.form == "prefix" else ns_names).add(s.name)
            first_site.setdefault(s.name, s)
        for name in sorted(ns_names):
            if name in table:
                continue
            s = first_site[name]
            if name in jax_only[namespace]:
                findings.append(Finding(
                    "WB01", s.mod.relpath, s.line, s.col,
                    f"emitted {namespace} \"{name}\" is listed as "
                    f"emitted only by the JAX package in the README "
                    f"table of telemetry names that differ in the port "
                    f"— remove that row or the emit"))
                continue
            findings.append(Finding(
                "WB01", s.mod.relpath, s.line, s.col,
                f"emitted {namespace} \"{name}\" has no row in the "
                f"README {namespace} taxonomy table — document what it "
                f"measures and its labels"))
        for prefix in sorted(ns_prefixes):
            if any(doc.startswith(prefix) for doc in table):
                continue
            s = first_site[prefix]
            findings.append(Finding(
                "WB01", s.mod.relpath, s.line, s.col,
                f"emitted {namespace} family \"{prefix}*\" has no row "
                f"in the README {namespace} taxonomy table — document "
                f"the family"))
        for doc, line in sorted(table.items()):
            doc_ok = doc in ns_names or any(
                doc.startswith(p) for p in ns_prefixes) or (
                doc.endswith("*") and any(
                    n.startswith(doc[:-1]) for n in ns_names))
            if not doc_ok:
                findings.append(Finding(
                    "WB02", ctx.readme_relpath or "README.md", line, 0,
                    f"README {namespace} taxonomy documents `{doc}` "
                    f"but nothing emits it — remove the row or restore "
                    f"the emit site"))

    # WB03 — phantom consumers
    if emits:
        for form, name, mod, node in consumes:
            if form != "literal" or emitted(name):
                continue
            findings.append(Finding(
                "WB03", mod.relpath, node.lineno, node.col_offset,
                f"reads metric/span \"{name}\" but nothing emits it — "
                f"phantom consumer (this dashboard/assertion went "
                f"silently dark)"))

    # WB04 — label-key drift between emit sites sharing one name
    by_name: dict[str, list[_Site]] = {}
    for s in emits:
        if s.form == "literal" and s.labels is not None:
            by_name.setdefault(s.name, []).append(s)
    for name, sites in sorted(by_name.items()):
        sites.sort(key=lambda s: (s.mod.relpath, s.line, s.col))
        ref = sites[0]
        for s in sites[1:]:
            if s.labels == ref.labels:
                continue
            findings.append(Finding(
                "WB04", s.mod.relpath, s.line, s.col,
                f"emit of \"{name}\" uses label keys "
                f"{{{', '.join(sorted(s.labels)) or ''}}} but the emit "
                f"at {ref.mod.relpath}:{ref.line} uses "
                f"{{{', '.join(sorted(ref.labels)) or ''}}} — per-label "
                f"breakdowns fragment across sites"))
    return findings
