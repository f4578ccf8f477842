"""W1xx — sync discipline in torch form: blocking device→host reads.

Port of ``photon_ml_tpu/analysis/rules_sync.py``. The hot-loop contract
(one blocking fetch per coordinate update, every intentional fetch
instrumented through ``utils/sync_telemetry.record_host_fetch``) is
enforced dynamically only on the paths a test executes. These rules keep
the JAX rules' codes and meaning over torch, with the device-tensor tags
of :mod:`photon_ml_tpu_torch.analysis.dataflow`:

- **W101** ``float()``/``int()``/``bool()`` on a device tensor;
- **W102** ``.item()`` or ``.tolist()`` on a device tensor;
- **W103** ``np.asarray()``/``np.array()``/``np.ascontiguousarray()`` or
  ``.numpy()`` on a device tensor;
- **W104** a blocking copy or wait in a function whose scope chain never
  calls ``record_host_fetch`` — ``.cpu()``, ``.to("cpu")`` /
  ``.to(torch.device("cpu"))`` without ``non_blocking=True``,
  ``torch.cuda.synchronize()`` or a stream's or event's
  ``.synchronize()`` — the torch counterparts of ``jax.device_get``:
  an *uninstrumented* fetch that ``host_syncs_per_update`` telemetry
  cannot see. A ``non_blocking=True`` copy into pinned memory is not a
  wait; the ``synchronize()`` that later waits for it is.
- **W105** pipeline-depth discipline: a deferred epilogue handle (the
  result of a ``dispatch_update``-style call) still unconsumed when a
  SECOND subsequent dispatch is issued — i.e. a fetch that would land
  more than one coordinate late. The double-buffered CD sweep's
  contract is depth ≤ 1: every in-flight block is resolved
  (``resolve_update``/``fetch_update``) before the dispatch after next,
  so divergence recovery only ever has to act ONE update late.

``utils/sync_telemetry.py`` itself is exempt: it IS the instrument.
"""

from __future__ import annotations

import ast
from typing import Optional

from photon_ml_tpu_torch.analysis.core import Finding
from photon_ml_tpu_torch.analysis.dataflow import (
    Dataflow, is_cpu_target, is_device, non_blocking, to_target,
)
from photon_ml_tpu_torch.analysis.package import ModuleInfo, PackageIndex

_EXEMPT_SUFFIX = "utils/sync_telemetry.py"
_RECORD_FETCH = "record_host_fetch"
_CONVERTERS = {"float", "int", "bool"}
_NP_CONVERTERS = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray"}

# W105: calls whose name ends with the dispatch suffix produce a deferred
# epilogue handle; ones ending with a consume suffix resolve it. Suffix
# matching covers both the bare closure names in coordinate_descent.py
# and dotted/imported forms.
_DISPATCH_SUFFIX = "dispatch_update"
_CONSUME_SUFFIXES = ("resolve_update", "fetch_update")
#: Loop bodies are interpreted this many times so a handle created in
#: iteration k and aged by the dispatches of iterations k+1 and k+2 is
#: observed crossing the depth-1 line.
_LOOP_PASSES = 3


def build_scope_map(tree: ast.Module) -> dict[int, Optional[ast.AST]]:
    """Map ``id(node)`` → innermost enclosing function def (None at
    module level), and each function def → its own parent scope."""
    scope_of: dict[int, Optional[ast.AST]] = {}

    def visit(node: ast.AST, scope: Optional[ast.AST]) -> None:
        scope_of[id(node)] = scope
        child_scope = node if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) \
            else scope
        for child in ast.iter_child_nodes(node):
            visit(child, child_scope)

    visit(tree, None)
    return scope_of


def _instrumented_scopes(mod: ModuleInfo,
                         scope_of: dict[int, Optional[ast.AST]]
                         ) -> set[Optional[int]]:
    """Scopes (id of function def, or None for module level) containing
    a direct ``record_host_fetch()`` call."""
    out: set[Optional[int]] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            d = mod.resolve(node.func)
            if d is not None and (d.endswith("." + _RECORD_FETCH)
                                  or d == _RECORD_FETCH):
                scope = scope_of.get(id(node))
                out.add(None if scope is None else id(scope))
    return out


def _call_suffix_name(mod: ModuleInfo, node: ast.Call) -> Optional[str]:
    """Best-effort callable name for suffix matching: the resolved dotted
    name when the package index knows it, else the bare/attr name."""
    d = mod.resolve(node.func)
    if d is not None:
        return d
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


class _PipelineDepthWalker:
    """Abstract interpreter for W105: tracks, per function scope, which
    variables hold a deferred dispatch handle and how many SUBSEQUENT
    dispatches each has survived unconsumed (its "age"). A handle
    reaching age 2 at a dispatch site is a finding — that fetch would
    land more than one coordinate late.

    Consumption = the variable passed to a ``resolve_update``/
    ``fetch_update``-suffixed call, rebound, deleted, or transferred to
    another name (``pending = cur`` moves the handle, it doesn't copy
    it). ``If`` branches merge keeping only handles live on BOTH paths
    (max age) — precision over recall; loop bodies run ``_LOOP_PASSES``
    times so loop-carried ages surface."""

    def __init__(self, mod: ModuleInfo, findings: list):
        self.mod = mod
        self.findings = findings
        self.state: dict[str, int] = {}

    # -- entry points -------------------------------------------------------

    def run(self, body: list) -> None:
        self.state = {}
        self._stmts(body)

    # -- statement dispatch -------------------------------------------------

    def _stmts(self, stmts) -> None:
        for s in stmts or []:
            self._stmt(s)

    def _stmt(self, s: ast.AST) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sub = _PipelineDepthWalker(self.mod, self.findings)
            sub.run(s.body)
            return
        if isinstance(s, ast.ClassDef):
            sub = _PipelineDepthWalker(self.mod, self.findings)
            sub.run(s.body)
            return
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self._expr(s.iter)
            for _ in range(_LOOP_PASSES):
                self._stmts(s.body)
            self._stmts(s.orelse)
            return
        if isinstance(s, ast.While):
            self._expr(s.test)
            for _ in range(_LOOP_PASSES):
                self._stmts(s.body)
            self._stmts(s.orelse)
            return
        if isinstance(s, ast.If):
            self._expr(s.test)
            before = dict(self.state)
            self._stmts(s.body)
            after_body = self.state
            self.state = dict(before)
            self._stmts(s.orelse)
            after_else = self.state
            # keep only handles alive on BOTH paths (precision: a handle
            # consumed on either path may well be consumed at runtime)
            self.state = {
                name: max(after_body[name], after_else[name])
                for name in set(after_body) & set(after_else)}
            return
        if isinstance(s, ast.Try):
            # conservative flattening: body, then handlers, then
            # orelse/finally see the accumulated state — consumption on
            # any of these paths counts
            self._stmts(s.body)
            for h in s.handlers:
                self._stmts(h.body)
            self._stmts(s.orelse)
            self._stmts(s.finalbody)
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self._expr(item.context_expr)
            self._stmts(s.body)
            return
        if isinstance(s, ast.Assign):
            self._assign(s)
            return
        if isinstance(s, ast.AnnAssign) and s.value is not None:
            if isinstance(s.target, ast.Name):
                self._bind(s.target.id, s.value)
            else:
                self._expr(s.value)
            return
        if isinstance(s, ast.Delete):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    self.state.pop(t.id, None)
            return
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _assign(self, s: ast.Assign) -> None:
        # rebinding any tracked name kills its old handle
        for t in s.targets:
            for name_node in ast.walk(t):
                if isinstance(name_node, ast.Name):
                    self.state.pop(name_node.id, None)
        if len(s.targets) == 1 and isinstance(s.targets[0], ast.Name):
            self._bind(s.targets[0].id, s.value)
        else:
            self._expr(s.value)

    def _bind(self, target: str, value: ast.expr) -> None:
        if isinstance(value, ast.Call):
            name = _call_suffix_name(self.mod, value)
            if name is not None and name.endswith(_DISPATCH_SUFFIX):
                self._visit_call_args(value)
                self._age_all(value)
                self.state[target] = 0
                return
        if isinstance(value, ast.Name) and value.id in self.state:
            self.state[target] = self.state.pop(value.id)  # transfer
            return
        self._expr(value)

    # -- expressions --------------------------------------------------------

    def _expr(self, e: Optional[ast.expr]) -> None:
        if e is None:
            return
        for node in ast.walk(e):
            if not isinstance(node, ast.Call):
                continue
            name = _call_suffix_name(self.mod, node)
            if name is None:
                continue
            if any(name.endswith(sfx) for sfx in _CONSUME_SUFFIXES):
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        self.state.pop(arg.id, None)
                for kw in node.keywords:  # fetch_update(p=handle) consumes
                    if isinstance(kw.value, ast.Name):
                        self.state.pop(kw.value.id, None)
            elif name.endswith(_DISPATCH_SUFFIX):
                # un-bound dispatch still advances the pipeline clock
                self._age_all(node)

    def _visit_call_args(self, call: ast.Call) -> None:
        for arg in call.args:
            self._expr(arg)
        for kw in call.keywords:
            self._expr(kw.value)

    def _age_all(self, at: ast.Call) -> None:
        for name in list(self.state):
            self.state[name] += 1
            if self.state[name] >= 2:
                self.findings.append(Finding(
                    "W105", self.mod.relpath, at.lineno, at.col_offset,
                    f"deferred epilogue handle {name!r} is still "
                    f"unconsumed at its second subsequent dispatch — "
                    f"the fetch would land more than one coordinate "
                    f"late (pipeline depth > 1); resolve it "
                    f"(resolve_update/fetch_update) at most one "
                    f"dispatch later"))
                # report once per handle per site chain
                self.state.pop(name, None)


def _blocking_copy(mod: ModuleInfo, flow: Dataflow,
                   node: ast.Call) -> Optional[str]:
    """What blocks, when ``node`` is a W104 copy or wait, else None."""
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    if attr == "synchronize" and not node.args:
        return "synchronize()"
    if not is_device(flow.tag(node.func.value)):
        return None  # on the host already, or unknown: clean
    if attr == "cpu" and not node.args:
        return ".cpu()"
    if attr == "to" and not non_blocking(node):
        target = to_target(node)
        if target is not None and is_cpu_target(mod, target):
            return '.to("cpu")'
    return None


def check(modules: list[ModuleInfo], index: PackageIndex,
          flows: dict[str, Dataflow], ctx) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        if mod.relpath.endswith(_EXEMPT_SUFFIX):
            continue
        flow = flows[mod.relpath]
        scope_of = build_scope_map(mod.tree)
        instrumented = _instrumented_scopes(mod, scope_of)
        _PipelineDepthWalker(mod, findings).run(mod.tree.body)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            d = mod.resolve(node.func)
            method = node.func.attr \
                if isinstance(node.func, ast.Attribute) else None
            # W101: float()/int()/bool() — only the true builtins (a
            # local or imported redefinition resolves to a dotted name)
            if isinstance(node.func, ast.Name) \
                    and node.func.id in _CONVERTERS and d is None \
                    and node.args \
                    and is_device(flow.tag(node.args[0])):
                findings.append(Finding(
                    "W101", mod.relpath, node.lineno, node.col_offset,
                    f"{node.func.id}() on a device tensor forces a "
                    f"blocking device→host sync — batch it into one "
                    f"instrumented copy to the host"))
            # W102: .item() / .tolist()
            elif method in ("item", "tolist") and not node.args \
                    and is_device(flow.tag(node.func.value)):
                findings.append(Finding(
                    "W102", mod.relpath, node.lineno, node.col_offset,
                    f".{method}() on a device tensor forces a blocking "
                    f"device→host sync — batch it into one instrumented "
                    f"copy to the host"))
            # W103: np.asarray(device tensor) / .numpy()
            elif (d in _NP_CONVERTERS and node.args
                    and is_device(flow.tag(node.args[0]))) or (
                    method == "numpy" and not node.args
                    and is_device(flow.tag(node.func.value))):
                what = d.replace("numpy.", "np.") + "()" \
                    if d in _NP_CONVERTERS else ".numpy()"
                findings.append(Finding(
                    "W103", mod.relpath, node.lineno, node.col_offset,
                    f"{what} on a device tensor forces a blocking "
                    f"device→host sync — fetch through an instrumented "
                    f"copy to the host instead"))
            # W104: an uninstrumented blocking copy or wait
            else:
                what = _blocking_copy(mod, flow, node)
                if what is None:
                    continue
                scope = scope_of.get(id(node))
                chain_ok = False
                while True:
                    key = None if scope is None else id(scope)
                    if key in instrumented:
                        chain_ok = True
                        break
                    if scope is None:
                        break
                    scope = scope_of.get(id(scope))
                if not chain_ok:
                    findings.append(Finding(
                        "W104", mod.relpath, node.lineno,
                        node.col_offset,
                        f"{what} without record_host_fetch in the "
                        f"enclosing function — this blocking copy or "
                        f"wait is invisible to host_syncs_per_update "
                        f"telemetry (utils/sync_telemetry.py)"))
    return findings
