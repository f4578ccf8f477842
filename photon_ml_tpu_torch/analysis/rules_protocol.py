"""WAxx — wire-protocol drift across the serve plane.

Port of ``photon_ml_tpu/analysis/rules_protocol.py``, unchanged in what
it checks, run over the port's ``serve/``.

The NDJSON scoring protocol (``serve/protocol.py``) is a set of string
contracts: request/response ``kind``s, the ``wire_error`` /
``typed_error`` error grammar, and the fleet's transport-classification
set. Nothing enforces them at runtime beyond "the test happened to
exercise that path" (misclassified reply error names and a probe kind
mismatch are this bug class). These rules
make the contracts whole-program, both-directions checks:

- **WA00** a protocol string (message kind) built from a fully dynamic
  expression — statically unauditable; use a literal (an f-string with
  a literal head is tracked as a prefix) or suppress with a reason.
- **WA01** a ``kind`` sent by a client (``.request({...})`` /
  ``.dispatch(shard, {...})``) that no server dispatch compares for —
  the request can only come back ``unknown kind``.
- **WA02** a server dispatch arm for a ``kind`` no client ever sends —
  dead handler or renamed request.
- **WA03** a subclass of the typed client error base
  (``ServeRequestError``) that is raised somewhere (so ``wire_error``
  can put its name on the wire) but is neither a key of the
  ``_TYPED_ERRORS`` parse table nor referenced by ``typed_error()`` —
  the far side demotes it to a generic error.
- **WA04** a name in ``_TRANSPORT_REPLY_ERRORS`` that no code path can
  put on the wire: not producible by any server-side
  ``f"{type(e).__name__}: {e}"`` render (the f-string must START with
  the type name — that is the wire grammar) for a compatible caught
  type, and not the canonical name of anything raised. The classic
  instance: ``"IOError"`` — in Python 3 ``IOError is OSError``, so
  ``type(e).__name__`` can never render it.
- **WA05** a field read off a kind-guarded wire message that no writer
  of that kind ever sets. Writers are dict literals carrying
  ``"kind": K`` (plus same-function ``msg["field"] = ...`` follow-ups);
  a ``**spread`` makes the writer's field set OPEN and exempts the
  kind (``stats`` replies splice dynamic scorer stats in, so absence
  cannot be claimed).

Scope: the kind/field analysis runs over modules with a ``serve`` path
component or that import from one — the telemetry record plane
(``obs/``) speaks its own ``"kind"``-keyed record grammar and must not
cross-contaminate the serve universe. WA03/WA04 anchor on the
``_TYPED_ERRORS`` / ``_TRANSPORT_REPLY_ERRORS`` definitions and scan
package-wide. Everything is syntactic; resolution failures bias toward
silence (an unresolvable receiver contributes nothing, except the
deliberate WA00 signal for dynamic names at true protocol positions).
"""

from __future__ import annotations

import ast
import builtins

from photon_ml_tpu_torch.analysis.core import Finding
from photon_ml_tpu_torch.analysis.dataflow import Dataflow
from photon_ml_tpu_torch.analysis.package import (
    ModuleInfo, PackageIndex, name_value,
)

_TYPED_TABLE_NAME = "_TYPED_ERRORS"
_TRANSPORT_SET_NAME = "_TRANSPORT_REPLY_ERRORS"
_TYPED_BASE = "ServeRequestError"


# -- small AST helpers -----------------------------------------------------


def _scoped_walk(root: ast.AST):
    """Walk statements without descending into nested defs/classes
    (each function scope is analyzed on its own)."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _functions(mod: ModuleInfo):
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _unwrap_recv(node: ast.AST) -> ast.AST:
    # ``(client.hello or {}).get(...)`` guards read through the BoolOp
    while isinstance(node, ast.BoolOp) and node.values:
        node = node.values[0]
    return node


def _recv_key(node: ast.AST) -> str:
    return ast.unparse(_unwrap_recv(node))


def _get_call_key(node: ast.AST):
    """``(receiver, "field")`` when ``node`` is ``<recv>.get("field")``
    (optionally with a default), else None."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get" and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        return node.func.value, node.args[0].value
    return None


def _serve_scope(modules: list[ModuleInfo]) -> list[ModuleInfo]:
    scoped = []
    for mod in modules:
        if "serve" in mod.module_name.split("."):
            scoped.append(mod)
            continue
        if any(".serve." in t or t.startswith("serve.")
               for t in mod.imports.values()):
            scoped.append(mod)
    return scoped


# -- per-function protocol scan -------------------------------------------


class _FnScan:
    """Everything one function scope contributes to the kind universe."""

    def __init__(self, mod: ModuleInfo, index: PackageIndex,
                 fdef: ast.AST):
        self.mod = mod
        self.index = index
        self.fdef = fdef
        self.kindvars: dict[str, ast.AST] = {}   # var -> .get receiver
        self.dict_vars: dict[str, ast.Dict] = {}
        self.sub_writes: dict[str, set[str]] = {}
        self.sends: list[tuple[str, str, ast.AST]] = []
        self.handled: list[tuple[str, str, ast.AST]] = []
        self.dynamic: list[tuple[ast.AST, str]] = []  # WA00 sites
        # (polarity, kind, recv_key, compare node, enclosing If or None)
        self.guards: list[tuple[str, str, str, ast.AST,
                                ast.AST | None]] = []
        self._collect_assigns()
        self._collect_sends()
        self._collect_compares()

    def _collect_assigns(self) -> None:
        for node in _scoped_walk(self.fdef):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
                if isinstance(tgt, ast.Name):
                    if isinstance(val, ast.Dict):
                        self.dict_vars[tgt.id] = val
                    else:
                        got = _get_call_key(val)
                        if got is not None and got[1] == "kind":
                            self.kindvars[tgt.id] = got[0]
                elif (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.value, ast.Name)
                        and isinstance(tgt.slice, ast.Constant)
                        and isinstance(tgt.slice.value, str)):
                    self.sub_writes.setdefault(
                        tgt.value.id, set()).add(tgt.slice.value)

    def _send_candidate(self, call: ast.Call):
        """The wire-message dict of a ``.request({...})`` /
        ``.dispatch(shard, {...})`` call, else None."""
        if not isinstance(call.func, ast.Attribute):
            return None
        if call.func.attr == "request" and call.args:
            cand = call.args[0]
        elif call.func.attr == "dispatch" and len(call.args) >= 2:
            cand = call.args[1]
        else:
            return None
        if isinstance(cand, ast.Name):
            cand = self.dict_vars.get(cand.id)
        return cand if isinstance(cand, ast.Dict) else None

    def _collect_sends(self) -> None:
        for node in _scoped_walk(self.fdef):
            if not isinstance(node, ast.Call):
                continue
            d = self._send_candidate(node)
            if d is None:
                continue
            kind_node = _dict_key_value(d, "kind")
            if kind_node is None:
                continue
            form, val = name_value(self.mod, self.index, kind_node)
            if form == "dynamic":
                self.dynamic.append((kind_node, "request kind"))
            else:
                self.sends.append((form, val, kind_node))

    def _collect_compares(self) -> None:
        for node in _scoped_walk(self.fdef):
            if not (isinstance(node, ast.Compare) and len(node.ops) == 1
                    and isinstance(node.ops[0], (ast.Eq, ast.NotEq))):
                continue
            left, right = node.left, node.comparators[0]
            recv = None
            if isinstance(left, ast.Name) and left.id in self.kindvars:
                recv = self.kindvars[left.id]
            else:
                got = _get_call_key(left)
                if got is not None and got[1] == "kind":
                    recv = got[0]
            if recv is None:
                continue
            form, val = name_value(self.mod, self.index, right)
            if form == "dynamic":
                self.dynamic.append((node, "dispatch kind comparison"))
                continue
            polarity = "eq" if isinstance(node.ops[0], ast.Eq) else "ne"
            if polarity == "eq" and form == "literal":
                self.handled.append((form, val, node))
            self.guards.append(
                (polarity, val if form == "literal" else None,
                 _recv_key(recv), node, None))

    def writer_sets(self) -> list[tuple[str, set[str], bool, ast.AST]]:
        """``(kind, fields, open, node)`` for every dict literal in this
        scope carrying a literal ``"kind"`` entry."""
        out = []
        var_of = {id(d): v for v, d in self.dict_vars.items()}
        for node in _scoped_walk(self.fdef):
            if not isinstance(node, ast.Dict):
                continue
            kind_node = _dict_key_value(node, "kind")
            if kind_node is None:
                continue
            form, val = name_value(self.mod, self.index, kind_node)
            if form != "literal":
                continue
            fields: set[str] = set()
            open_set = False
            for k in node.keys:
                if k is None:  # **spread — unknowable statically
                    open_set = True
                elif isinstance(k, ast.Constant) and isinstance(
                        k.value, str):
                    fields.add(k.value)
                else:
                    open_set = True
            v = var_of.get(id(node))
            if v is not None:
                fields |= self.sub_writes.get(v, set())
            out.append((val, fields, open_set, node))
        return out

    def guarded_reads(self) -> list[tuple[str, str, ast.AST]]:
        """``(kind, field, node)`` for field reads on receivers whose
        wire kind is pinned by a guard in this scope."""
        out: list[tuple[str, str, ast.AST]] = []
        # Eq guards pin the kind inside the If arm they test for.
        for node in _scoped_walk(self.fdef):
            if not isinstance(node, ast.If):
                continue
            guard = self._if_guard(node.test)
            if guard is None:
                continue
            polarity, kind, key = guard
            if kind is None:
                continue
            if polarity == "eq":
                for stmt in node.body:
                    out.extend((kind, f, n)
                               for f, n in self._reads(stmt, key))
        # NotEq guards (bad-reply bail-outs) pin the kind for the whole
        # scope — but only when the receiver is guarded for ONE kind.
        ne_by_key: dict[str, set[str]] = {}
        for polarity, kind, key, _node, _ in self.guards:
            if polarity == "ne" and kind is not None:
                ne_by_key.setdefault(key, set()).add(kind)
        for key, kinds in ne_by_key.items():
            if len(kinds) != 1:
                continue
            kind = next(iter(kinds))
            out.extend((kind, f, n) for f, n in self._reads(
                self.fdef, key))
        return out

    def _if_guard(self, test: ast.AST):
        for polarity, kind, key, node, _ in self.guards:
            if node is test:
                return polarity, kind, key
        return None

    def _reads(self, root: ast.AST, key: str):
        for node in _scoped_walk(root):
            got = _get_call_key(node)
            if got is not None and got[1] != "kind" \
                    and _recv_key(got[0]) == key:
                yield got[1], node
            elif (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)
                    and node.slice.value != "kind"
                    and _recv_key(node.value) == key):
                yield node.slice.value, node


def _dict_key_value(d: ast.Dict, key: str):
    for k, v in zip(d.keys, d.values):
        if isinstance(k, ast.Constant) and k.value == key:
            return v
    return None


# -- WA03: typed-error parse table ----------------------------------------


def _typed_table(modules: list[ModuleInfo]):
    """(set of table key names, True if a table exists)."""
    keys: set[str] = set()
    found = False
    for mod in modules:
        expr = mod.constants.get(_TYPED_TABLE_NAME)
        if isinstance(expr, ast.Dict):
            found = True
            keys.update(k.value for k in expr.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str))
    return keys, found


def _typed_error_refs(index: PackageIndex) -> set[str]:
    refs: set[str] = set()
    for dotted, (_mod, fdef) in index.functions.items():
        if dotted.endswith(".typed_error"):
            refs.update(n.id for n in ast.walk(fdef)
                        if isinstance(n, ast.Name))
    return refs


def _subclasses_of(index: PackageIndex, base_suffix: str) -> set[str]:
    bases = {d for d in index.classes if d.endswith("." + base_suffix)
             or d == base_suffix}
    out: set[str] = set()
    changed = True
    while changed:
        changed = False
        for dotted, info in index.classes.items():
            if dotted in out or dotted in bases:
                continue
            if any(b in bases or b in out for b in info.bases):
                out.add(dotted)
                changed = True
    return out


def _check_typed_errors(modules, index) -> list[Finding]:
    keys, found = _typed_table(modules)
    if not found:
        return []
    refs = _typed_error_refs(index)
    typed = _subclasses_of(index, _TYPED_BASE)
    findings = []
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Raise) and node.exc is not None):
                continue
            exc = node.exc
            cls_node = exc.func if isinstance(exc, ast.Call) else exc
            dotted = mod.resolve(cls_node)
            if dotted is None or dotted not in typed:
                continue
            name = dotted.rsplit(".", 1)[-1]
            if name in keys or name in refs:
                continue
            findings.append(Finding(
                "WA03", mod.relpath, node.lineno, node.col_offset,
                f"{name} raised here can reach the wire via wire_error "
                f"but is missing from typed_error()'s "
                f"{_TYPED_TABLE_NAME} table — clients parse it back as "
                f"a GENERIC ServeRequestError"))
    return findings


# -- WA04: transport-classification set -----------------------------------


def _genuine_builtin_exc(name: str):
    """The builtin exception class truly named ``name`` — alias entries
    (``IOError`` → ``OSError``) resolve to None."""
    cls = getattr(builtins, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException) \
            and cls.__name__ == name:
        return cls
    return None


def _builtin_subclass_names(caught: type) -> set[str]:
    return {n for n in dir(builtins)
            if (c := _genuine_builtin_exc(n)) is not None
            and issubclass(c, caught)}


def _package_subclass_names(index: PackageIndex, dotted: str) -> set[str]:
    names = {dotted.rsplit(".", 1)[-1]}
    seen = {dotted}
    changed = True
    while changed:
        changed = False
        for cand, info in index.classes.items():
            if cand in seen:
                continue
            if any(b in seen for b in info.bases):
                seen.add(cand)
                names.add(cand.rsplit(".", 1)[-1])
                changed = True
    return names


def _renders_leading_type_name(body: list[ast.stmt],
                               bound: str) -> bool:
    """True when the handler body holds an f-string that STARTS with
    ``type(<bound>).__name__`` — the ``Name: message`` wire render."""
    for stmt in body:
        for node in ast.walk(stmt):
            if not (isinstance(node, ast.JoinedStr) and node.values):
                continue
            head = node.values[0]
            if not isinstance(head, ast.FormattedValue):
                continue
            v = head.value
            if (isinstance(v, ast.Attribute) and v.attr == "__name__"
                    and isinstance(v.value, ast.Call)
                    and isinstance(v.value.func, ast.Name)
                    and v.value.func.id == "type"
                    and v.value.args
                    and isinstance(v.value.args[0], ast.Name)
                    and v.value.args[0].id == bound):
                return True
    return False


def _emittable_error_names(modules, index) -> set[str]:
    names: set[str] = set()
    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ExceptHandler) and node.name \
                    and _renders_leading_type_name(node.body, node.name):
                types = node.type.elts if isinstance(
                    node.type, ast.Tuple) else \
                    ([node.type] if node.type is not None else [])
                for t in types:
                    dotted = mod.resolve(t)
                    if dotted is not None and dotted in index.classes:
                        names |= _package_subclass_names(index, dotted)
                        continue
                    seg = t.id if isinstance(t, ast.Name) else (
                        t.attr if isinstance(t, ast.Attribute) else None)
                    if seg is None:
                        continue
                    cls = getattr(builtins, seg, None)
                    if isinstance(cls, type) and issubclass(
                            cls, BaseException):
                        names |= _builtin_subclass_names(cls)
            elif isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc
                cls_node = exc.func if isinstance(exc, ast.Call) else exc
                dotted = mod.resolve(cls_node)
                if dotted is not None and dotted in index.classes:
                    names.add(dotted.rsplit(".", 1)[-1])
                    continue
                seg = cls_node.id if isinstance(cls_node, ast.Name) \
                    else (cls_node.attr if isinstance(
                        cls_node, ast.Attribute) else None)
                if seg is not None:
                    cls = getattr(builtins, seg, None)
                    if isinstance(cls, type) and issubclass(
                            cls, BaseException):
                        names.add(cls.__name__)  # canonical, not alias
    return names


def _transport_set_elements(mod: ModuleInfo):
    expr = mod.constants.get(_TRANSPORT_SET_NAME)
    if expr is None:
        return []
    if isinstance(expr, ast.Call) and expr.args and isinstance(
            expr.func, ast.Name) and expr.func.id in ("frozenset", "set"):
        expr = expr.args[0]
    if isinstance(expr, (ast.Set, ast.Tuple, ast.List)):
        return [e for e in expr.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str)]
    return []


def _check_transport_set(modules, index) -> list[Finding]:
    sets = [(mod, _transport_set_elements(mod)) for mod in modules]
    sets = [(mod, elts) for mod, elts in sets if elts]
    if not sets:
        return []
    emittable = _emittable_error_names(modules, index)
    findings = []
    for mod, elts in sets:
        for e in elts:
            if e.value in emittable:
                continue
            hint = ""
            cls = getattr(builtins, e.value, None)
            if isinstance(cls, type) and issubclass(cls, BaseException) \
                    and cls.__name__ != e.value:
                hint = (f" (in Python 3, {e.value} is an alias of "
                        f"{cls.__name__} — type(e).__name__ can never "
                        f"render it)")
            findings.append(Finding(
                "WA04", mod.relpath, e.lineno, e.col_offset,
                f"{_TRANSPORT_SET_NAME} names \"{e.value}\" but no code "
                f"path can put that name on the wire{hint} — remove the "
                f"dead entry or restore the emitting path"))
    return findings


# -- driver ----------------------------------------------------------------


def check(modules: list[ModuleInfo], index: PackageIndex,
          flows: dict[str, Dataflow], ctx) -> list[Finding]:
    findings: list[Finding] = []
    serve_mods = _serve_scope(modules)

    sends: list[tuple[str, str, ModuleInfo, ast.AST]] = []
    handled: list[tuple[str, ModuleInfo, ast.AST]] = []
    writers: dict[str, dict] = {}
    guarded_reads: list[tuple[str, str, ModuleInfo, ast.AST]] = []
    for mod in serve_mods:
        for fdef in _functions(mod):
            scan = _FnScan(mod, index, fdef)
            for node, what in scan.dynamic:
                findings.append(Finding(
                    "WA00", mod.relpath, node.lineno, node.col_offset,
                    f"{what} is a fully dynamic expression — the wire "
                    f"protocol must stay statically enumerable (use a "
                    f"literal, or suppress with the reason the name is "
                    f"dynamic)"))
            sends.extend((form, val, mod, node)
                         for form, val, node in scan.sends)
            handled.extend((val, mod, node)
                           for _form, val, node in scan.handled)
            for kind, fields, open_set, _node in scan.writer_sets():
                w = writers.setdefault(
                    kind, {"fields": set(), "open": False})
                w["fields"] |= fields
                w["open"] = w["open"] or open_set
            guarded_reads.extend((kind, field, mod, node)
                                 for kind, field, node
                                 in scan.guarded_reads())

    handled_kinds = {val for val, _m, _n in handled}
    sent_literals = {val for form, val, _m, _n in sends
                     if form == "literal"}
    sent_prefixes = {val for form, val, _m, _n in sends
                     if form == "prefix"}
    if handled_kinds:
        for form, val, mod, node in sends:
            ok = (val in handled_kinds if form == "literal"
                  else any(h.startswith(val) for h in handled_kinds))
            if not ok:
                findings.append(Finding(
                    "WA01", mod.relpath, node.lineno, node.col_offset,
                    f"protocol kind \"{val}\" is sent here but no "
                    f"server dispatch handles it — every such request "
                    f"comes back as an unknown-kind error"))
    if sent_literals or sent_prefixes:
        for val, mod, node in handled:
            ok = val in sent_literals or any(
                val.startswith(p) for p in sent_prefixes)
            if not ok:
                findings.append(Finding(
                    "WA02", mod.relpath, node.lineno, node.col_offset,
                    f"server dispatch handles kind \"{val}\" but no "
                    f"client sends it — dead handler or renamed "
                    f"request"))
    for kind, field, mod, node in guarded_reads:
        w = writers.get(kind)
        if w is None or w["open"] or field in w["fields"]:
            continue
        findings.append(Finding(
            "WA05", mod.relpath, node.lineno, node.col_offset,
            f"reads field \"{field}\" off a \"{kind}\" message, but no "
            f"writer of that kind sets it (writers set: "
            f"{', '.join(sorted(w['fields'])) or 'nothing'})"))

    findings.extend(_check_typed_errors(modules, index))
    findings.extend(_check_transport_set(modules, index))
    return findings
