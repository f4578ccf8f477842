"""Lightweight device-tensor dataflow over one module's AST.

Port of ``photon_ml_tpu/analysis/dataflow.py`` in torch form. A tiny
abstract interpreter tracks, per scope and in program order, which names
(may) hold tensors on the device. The abstraction has three tags:

- ``DEVICE`` — a tensor on the device, or a container holding one (both
  sync on a host conversion, so the lint treats them alike). It comes
  from ``torch.*`` ops, tensor methods that return tensors,
  ``.to(<device>)`` and ``.cuda()``, parameters annotated ``Tensor`` /
  ``torch.Tensor``, ``nn.Module`` calls, and package functions whose
  returns are device tensors (the fixpoint below);
- ``HOST``   — definitely host data: numpy, ``.cpu()`` / ``.numpy()`` /
  ``.tolist()`` / ``.item()`` results, and tensors made by a ``torch``
  factory with no ``device=`` (they live on the CPU) — conversions on
  these are free;
- ``MODULE`` — an ``nn.Module`` instance built from ``torch.nn``
  (``torch.nn.Linear(...)``): calling it yields ``DEVICE``.

Unknown stays ``None`` and every rule treats unknown as clean — the
tracker keeps the JAX tracker's choice of precision over recall.

Branches merge with may-semantics (``DEVICE`` wins), loops run their body
twice to pick up loop-carried values, and nested ``def``/``lambda``
bodies are analyzed at their definition point with a copy of the
enclosing environment as closure — call-time environments may differ,
which is an accepted approximation for lint purposes.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from photon_ml_tpu_torch.analysis.package import ModuleInfo, PackageIndex

DEVICE = "device"
HOST = "host"
MODULE = "module"
# Literal tuples/lists keep per-element tags — ("tuple", (tag, ...)) —
# so unpacking `a, b = (host_thing, device_thing)` doesn't smear DEVICE
# onto both targets. Any other DEVICE-containing container collapses to
# DEVICE. Instances of package classes carry ("inst", dotted_class):
# method calls on them dispatch through the class index, so
# ``coord.score(...)`` joins the dataflow cross-module.


def inst_class(tag) -> Optional[str]:
    """Dotted class name when ``tag`` is a package-class instance."""
    if isinstance(tag, tuple) and len(tag) == 2 and tag[0] == "inst":
        return tag[1]
    return None


def is_device(tag) -> bool:
    """True when a tag means 'device tensor or a container holding
    one'."""
    if tag == DEVICE:
        return True
    if isinstance(tag, tuple) and tag and tag[0] == "tuple":
        return any(is_device(t) for t in tag[1])
    return False


def _elt_tags(tag):
    """Per-element tags when unpacking ``tag``, or None when unknown
    arity (plain DEVICE unpacks to DEVICE elements)."""
    if isinstance(tag, tuple) and tag and tag[0] == "tuple":
        return tag[1]
    return None


# ``torch.*`` callables whose result is not a tensor (or not one on the
# device): devices, dtypes, streams and events, process-group and
# backend plumbing, RNG seeding, grad-mode contexts.
NON_TENSOR_PREFIXES = (
    "torch.cuda.", "torch.distributed.", "torch.backends.", "torch.utils.",
    "torch.multiprocessing.", "torch.testing.", "torch.library.",
    "torch.autograd.", "torch.profiler.", "torch.version.",
    "torch.set_", "torch.get_", "torch.is_", "torch.use_",
)
NON_TENSOR_EXACT = {
    "torch.device", "torch.dtype", "torch.Size", "torch.finfo",
    "torch.iinfo", "torch.no_grad", "torch.enable_grad",
    "torch.inference_mode", "torch.manual_seed", "torch.seed",
    "torch.Generator", "torch.load", "torch.save", "torch.typename",
    "torch.numel", "torch.compiled_with_cxx11_abi",
}
# ``torch`` factories: a tensor on the CPU unless given ``device=``.
FACTORIES = {
    "torch.tensor", "torch.as_tensor", "torch.zeros", "torch.ones",
    "torch.empty", "torch.full", "torch.arange", "torch.linspace",
    "torch.logspace", "torch.eye", "torch.rand", "torch.randn",
    "torch.randint", "torch.randperm", "torch.empty_strided",
    "torch.sparse_coo_tensor", "torch.sparse_csr_tensor",
}
HOST_PRODUCERS = {"torch.from_numpy"}
# tensor attributes that are themselves tensors on the same device;
# anything else (.shape, .dtype, .device, .ndim, ...) drops the tag.
DEVICE_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "data", "grad"}
# tensor methods whose result is host data, not another device tensor.
HOST_METHODS = {"item", "tolist", "numpy", "cpu"}
# tensor methods that return a plain Python value (no sync, no tensor).
PLAIN_METHODS = {
    "dim", "size", "numel", "nelement", "element_size", "data_ptr",
    "stride", "storage_offset", "is_contiguous", "is_pinned",
    "get_device", "is_floating_point", "is_complex", "type",
    "record_stream", "untyped_storage", "register_hook", "__len__",
}


def is_cpu_target(mod: ModuleInfo, node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` (a literal CPU target)."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return isinstance(node, ast.Call) \
        and mod.resolve(node.func) == "torch.device" \
        and bool(node.args) and isinstance(node.args[0], ast.Constant) \
        and node.args[0].value == "cpu"


def to_target(call: ast.Call) -> Optional[ast.AST]:
    """The device argument of a ``.to(...)`` call (positional or
    ``device=``), or None when it moves nothing but the dtype."""
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return call.args[0] if call.args else None


def non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and isinstance(kw.value,
                                                       ast.Constant)
               and kw.value.value is True for kw in call.keywords)


_TENSOR_ANNOTATIONS = {"torch.Tensor"}


@dataclasses.dataclass
class Dataflow:
    """Result of interpreting one module: a tag for every expression
    node (keyed by ``id(node)``) and the return-value tags of every
    function body encountered."""

    tags: dict[int, Optional[str]]
    fn_returns: dict[int, list[Optional[str]]]  # id(fdef) -> return tags

    def tag(self, node: ast.AST) -> Optional[str]:
        return self.tags.get(id(node))


def analyze_module(mod: ModuleInfo, index: PackageIndex) -> Dataflow:
    """Interpret a whole module: top-level statements in order, then
    every ``def`` (at its definition point, with the enclosing env as
    closure)."""
    interp = _Interp(mod, index)
    interp.run_block(mod.tree.body, env={})
    return Dataflow(tags=interp.tags, fn_returns=interp.fn_returns)


class _Interp:
    def __init__(self, mod: ModuleInfo, index: PackageIndex):
        self.mod = mod
        self.index = index
        self.tags: dict[int, Optional[str]] = {}
        self.fn_returns: dict[int, list[Optional[str]]] = {}
        self._ret_stack: list[list[Optional[str]]] = []

    # -- statements --------------------------------------------------------

    def run_block(self, body, env: dict) -> dict:
        for stmt in body:
            env = self.stmt(stmt, env)
        return env

    def stmt(self, s: ast.stmt, env: dict) -> dict:
        if isinstance(s, ast.Assign):
            t = self.expr(s.value, env)
            for tgt in s.targets:
                self.bind(tgt, t, env)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self.bind(s.target, self.expr(s.value, env), env)
        elif isinstance(s, ast.AugAssign):
            t = self.expr(s.value, env)
            if isinstance(s.target, ast.Name):
                cur = env.get(s.target.id)
                env[s.target.id] = DEVICE \
                    if (is_device(t) or is_device(cur)) else cur
        elif isinstance(s, ast.Return):
            t = self.expr(s.value, env) if s.value is not None else None
            if self._ret_stack:
                self._ret_stack[-1].append(t)
        elif isinstance(s, ast.Expr):
            self.expr(s.value, env)
        elif isinstance(s, ast.If):
            self.expr(s.test, env)
            env_a = self.run_block(s.body, dict(env))
            env_b = self.run_block(s.orelse, dict(env))
            env = _merge(env_a, env_b)
        elif isinstance(s, ast.For):
            it = self.expr(s.iter, env)
            self.bind(s.target, DEVICE if is_device(it) else None, env)
            for _ in range(2):  # pick up loop-carried tags
                env = _merge(env, self.run_block(s.body, dict(env)))
            env = self.run_block(s.orelse, env)
        elif isinstance(s, ast.While):
            self.expr(s.test, env)
            for _ in range(2):
                env = _merge(env, self.run_block(s.body, dict(env)))
            env = self.run_block(s.orelse, env)
        elif isinstance(s, ast.With):
            for item in s.items:
                t = self.expr(item.context_expr, env)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, t, env)
            env = self.run_block(s.body, env)
        elif isinstance(s, ast.Try):
            env = self.run_block(s.body, env)
            base = dict(env)
            for h in s.handlers:
                env = _merge(env, self.run_block(h.body, dict(base)))
            env = self.run_block(s.orelse, env)
            env = self.run_block(s.finalbody, env)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._enter_function(s, env)
            env[s.name] = None
        elif isinstance(s, ast.ClassDef):
            class_dotted = f"{self.mod.module_name}.{s.name}"
            self_tag = ("inst", class_dotted) \
                if class_dotted in self.index.classes else None
            for sub in s.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    self._enter_function(sub, dict(env),
                                         self_tag=self_tag)
            env[s.name] = None
        elif isinstance(s, (ast.Raise, ast.Assert, ast.Delete)):
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self.expr(child, env)
        # Import/Global/Pass/Break/Continue: nothing to track
        return env

    def _enter_function(self, fdef, closure_env: dict,
                        self_tag=None) -> None:
        env = dict(closure_env)
        a = fdef.args
        params = a.posonlyargs + a.args + a.kwonlyargs
        for p in params + [v for v in (a.vararg, a.kwarg) if v]:
            env.pop(p.arg, None)
        pos = a.posonlyargs + a.args
        static = any(isinstance(d, ast.Name)
                     and d.id in ("staticmethod", "classmethod")
                     for d in fdef.decorator_list)
        if self_tag is not None and pos and not static:
            env[pos[0].arg] = self_tag
        for p in params:
            if p.annotation is not None and self.index.resolve_alias(
                    self.mod.resolve(p.annotation)) in _TENSOR_ANNOTATIONS:
                env[p.arg] = DEVICE
        for d in fdef.args.defaults + fdef.args.kw_defaults:
            if d is not None:
                self.expr(d, closure_env)
        self._ret_stack.append([])
        self.run_block(fdef.body, env)
        self.fn_returns[id(fdef)] = self._ret_stack.pop()

    def bind(self, target, tag, env: dict) -> None:
        if isinstance(target, ast.Name):
            if tag is None:
                env.pop(target.id, None)
            else:
                env[target.id] = tag
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts = _elt_tags(tag)
            if elts is not None and len(elts) == len(target.elts) \
                    and not any(isinstance(e, ast.Starred)
                                for e in target.elts):
                for elt, t in zip(target.elts, elts):
                    self.bind(elt, t, env)
            else:
                # unpacking a device tensor/container yields device parts
                for elt in target.elts:
                    self.bind(elt, DEVICE if is_device(tag) else None, env)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, tag, env)
        # attribute/subscript stores: no tracking

    # -- expressions -------------------------------------------------------

    def expr(self, e: Optional[ast.expr], env: dict) -> Optional[str]:
        if e is None:
            return None
        tag = self._expr_inner(e, env)
        self.tags[id(e)] = tag
        return tag

    def _expr_inner(self, e: ast.expr, env: dict) -> Optional[str]:
        if isinstance(e, ast.Name):
            return env.get(e.id)
        if isinstance(e, ast.Call):
            return self._call(e, env)
        if isinstance(e, ast.Attribute):
            base = self.expr(e.value, env)
            if is_device(base) and e.attr in DEVICE_ATTRS:
                return DEVICE
            c = inst_class(base)
            if c is not None:
                ac = self.index.attr_class(c, e.attr)
                if ac is not None:
                    return ("inst", ac)
                hit = self.index.resolve_method(c, e.attr)
                if hit is not None:
                    info, fdef = hit
                    is_prop = any(
                        isinstance(d, ast.Name) and d.id == "property"
                        for d in fdef.decorator_list)
                    if is_prop and f"{info.dotted}.{e.attr}" in \
                            self.index.device_methods:
                        return DEVICE
            return None
        if isinstance(e, ast.BinOp):
            tags = (self.expr(e.left, env), self.expr(e.right, env))
            return DEVICE if any(is_device(t) for t in tags) else None
        if isinstance(e, ast.UnaryOp):
            return self.expr(e.operand, env)
        if isinstance(e, ast.Compare):
            tags = [self.expr(e.left, env)]
            tags.extend(self.expr(c, env) for c in e.comparators)
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return None  # identity/membership checks are host bools
            return DEVICE if any(is_device(t) for t in tags) else None
        if isinstance(e, ast.BoolOp):
            tags = [self.expr(v, env) for v in e.values]
            return DEVICE if any(is_device(t) for t in tags) else None
        if isinstance(e, ast.IfExp):
            self.expr(e.test, env)
            tags = (self.expr(e.body, env), self.expr(e.orelse, env))
            return DEVICE if any(is_device(t) for t in tags) else None
        if isinstance(e, ast.Subscript):
            t = self.expr(e.value, env)
            self.expr(e.slice, env)
            elts = _elt_tags(t)
            if elts is not None and isinstance(e.slice, ast.Constant) \
                    and isinstance(e.slice.value, int) \
                    and -len(elts) <= e.slice.value < len(elts):
                return elts[e.slice.value]
            if t == HOST:
                return HOST
            return DEVICE if is_device(t) else None
        if isinstance(e, (ast.Tuple, ast.List)) and not any(
                isinstance(v, ast.Starred) for v in e.elts):
            tags = tuple(self.expr(v, env) for v in e.elts)
            return ("tuple", tags) if any(t is not None for t in tags) \
                else None
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            tags = [self.expr(v, env) for v in e.elts]
            return DEVICE if any(is_device(t) for t in tags) else None
        if isinstance(e, ast.Dict):
            tags = set()
            for k in e.keys:
                if k is not None:
                    self.expr(k, env)
            tags.update(self.expr(v, env) for v in e.values)
            return DEVICE if any(is_device(t) for t in tags) else None
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            return self._comprehension(e, env)
        if isinstance(e, ast.Starred):
            return self.expr(e.value, env)
        if isinstance(e, ast.JoinedStr):
            for v in e.values:
                if isinstance(v, ast.FormattedValue):
                    self.expr(v.value, env)
            return None
        if isinstance(e, ast.FormattedValue):
            self.expr(e.value, env)
            return None
        if isinstance(e, ast.Lambda):
            inner = dict(env)
            a = e.args
            for p in a.posonlyargs + a.args + a.kwonlyargs:
                inner.pop(p.arg, None)
            self.expr(e.body, inner)
            return None
        if isinstance(e, ast.NamedExpr):
            t = self.expr(e.value, env)
            self.bind(e.target, t, env)
            return t
        if isinstance(e, (ast.Await, ast.YieldFrom)):
            return self.expr(e.value, env)
        if isinstance(e, ast.Yield):
            if e.value is not None:
                self.expr(e.value, env)
            return None
        return None  # Constant, Slice handled via Subscript, etc.

    def _comprehension(self, e, env: dict) -> Optional[str]:
        inner = dict(env)
        for gen in e.generators:
            it = self.expr(gen.iter, inner)
            self.bind(gen.target, DEVICE if is_device(it) else None, inner)
            for cond in gen.ifs:
                self.expr(cond, inner)
        if isinstance(e, ast.DictComp):
            self.expr(e.key, inner)
            elt_dev = is_device(self.expr(e.value, inner))
        else:
            elt_dev = is_device(self.expr(e.elt, inner))
        return DEVICE if elt_dev else None

    def _torch_call(self, d: str, e: ast.Call,
                    arg_tags: list) -> Optional[str]:
        """The tag of a call to ``torch.<...>``."""
        if d in HOST_PRODUCERS:
            return HOST
        if d in NON_TENSOR_EXACT or d.startswith(NON_TENSOR_PREFIXES):
            return None
        if d.startswith("torch.nn.") and \
                d.rsplit(".", 1)[-1][:1].isupper():
            return MODULE  # an nn.Module built from torch's own layers
        if d in FACTORIES:
            dev = next((kw.value for kw in e.keywords
                        if kw.arg == "device"), None)
            return HOST if dev is None or is_cpu_target(self.mod, dev) \
                else DEVICE
        # an op: on the device unless its tensor inputs are all on the
        # host (``*_like`` follow their input the same way)
        if any(is_device(t) for t in arg_tags):
            return DEVICE
        if arg_tags and arg_tags[0] == HOST:
            return HOST
        return DEVICE

    def _method_on_device(self, e: ast.Call) -> Optional[str]:
        """The tag of ``<device tensor>.<method>(...)``."""
        attr = e.func.attr
        if attr in HOST_METHODS:
            return HOST
        if attr in PLAIN_METHODS:
            return None
        if attr == "to":
            target = to_target(e)
            if target is not None and is_cpu_target(self.mod, target):
                return HOST
        return DEVICE

    def _call(self, e: ast.Call, env: dict) -> Optional[str]:
        func_tag = self.expr(e.func, env)
        arg_tags = [self.expr(a, env) for a in e.args]
        for kw in e.keywords:
            self.expr(kw.value, env)
        d = self.mod.resolve(e.func)
        if d is not None:
            if d == "torch" or d.startswith("torch."):
                return self._torch_call(d, e, arg_tags)
            if d in self.index.device_fns:
                return DEVICE
            if d in self.index.classes:
                return ("inst", d)
            if d == "dataclasses.replace" and e.args:
                # replace() preserves the instance's (or pytree's) kind
                return arg_tags[0]
            if d.startswith("numpy."):
                return HOST
            if d in ("float", "int", "bool", "str", "len"):
                return HOST
            if d in ("tuple", "list", "dict", "set", "sorted", "zip"):
                return DEVICE if any(is_device(t) for t in arg_tags) \
                    else None
        if isinstance(e.func, ast.Attribute):
            base = self.tags.get(id(e.func.value))
            # method call on a device tensor: x.sum() is a device tensor,
            # x.item() is host data
            if is_device(base):
                return self._method_on_device(e)
            # host data stays on the host unless moved to the device
            if base == HOST:
                if e.func.attr in PLAIN_METHODS:
                    return None
                if e.func.attr == "cuda":
                    return DEVICE
                if e.func.attr == "to":
                    return self._host_to(e)
                return HOST
            # method call on a package-class instance: dispatch through
            # the class index (cross-module receiver-type inference)
            c = inst_class(base)
            if c is not None:
                hit = self.index.resolve_method(c, e.func.attr)
                if hit is not None:
                    info, _fdef = hit
                    if f"{info.dotted}.{e.func.attr}" in \
                            self.index.device_methods:
                        return DEVICE
        if func_tag == MODULE:
            return DEVICE
        c = inst_class(func_tag)
        if c is not None and c in self.index.module_classes:
            return DEVICE  # an nn.Module instance's forward
        return None

    def _host_to(self, e: ast.Call) -> Optional[str]:
        """The tag of ``<host tensor>.to(...)``: DEVICE for a literal
        device that is not the CPU, HOST for the CPU or a torch dtype,
        unknown for a target held in a variable."""
        target = to_target(e)
        if target is None or is_cpu_target(self.mod, target):
            return HOST
        if isinstance(target, ast.Constant) and \
                isinstance(target.value, str):
            return DEVICE
        d = self.mod.resolve(target.func if isinstance(target, ast.Call)
                             else target)
        if isinstance(target, ast.Call) and d == "torch.device":
            return DEVICE
        if d is not None and d.startswith("torch.") and \
                d.rsplit(".", 1)[-1] in _DTYPE_NAMES:
            return HOST
        return None


_DTYPE_NAMES = {
    "float16", "float32", "float64", "bfloat16", "half", "float",
    "double", "int8", "int16", "int32", "int64", "uint8", "bool", "long",
    "int", "short", "complex64", "complex128",
}

_HOST_ANNOTATIONS = {"float", "int", "bool", "str"}


def _host_annotated(fdef) -> bool:
    ret = fdef.returns
    return isinstance(ret, ast.Name) and ret.id in _HOST_ANNOTATIONS


def _merge(a: dict, b: dict) -> dict:
    """May-union of two branch environments: DEVICE dominates, a name
    bound in either branch stays bound."""
    out = dict(a)
    for k, v in b.items():
        cur = out.get(k)
        if cur == v or cur is None:
            out[k] = v
        elif is_device(v) or is_device(cur):
            out[k] = DEVICE
    return out


def infer_device_functions(index: PackageIndex,
                           max_rounds: int = 4) -> None:
    """Fixpoint: a top-level package function whose (any) return value
    tags DEVICE is itself device-returning — so
    ``float(metrics.peak_f1(...))`` is visible as a sync even though
    ``peak_f1`` lives in another module. Methods get the same treatment
    into ``index.device_methods`` (keyed ``<defining class
    dotted>.<method>``), which is what lets ``float(coord.score(...))``
    fire W1xx through a receiver whose class lives in a different module.
    Bounded for safety.

    A ``-> float/int/bool/str`` return annotation is trusted as a host
    scalar: such a function is a deliberate device→host accessor (the
    sync lives — and is reviewed — inside it), so its *callers* are not
    re-flagged for consuming the already-host result."""
    for _ in range(max_rounds):
        grew = False
        for mod in index.modules:
            flow = analyze_module(mod, index)
            for name, node in mod.toplevel_defs.items():
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    dotted = f"{mod.module_name}.{name}"
                    if dotted in index.device_fns or \
                            _host_annotated(node):
                        continue
                    if any(is_device(t)
                           for t in flow.fn_returns.get(id(node), [])):
                        index.device_fns.add(dotted)
                        grew = True
                elif isinstance(node, ast.ClassDef):
                    info = index.classes.get(
                        f"{mod.module_name}.{name}")
                    if info is None:
                        continue
                    for mname, fdef in info.methods.items():
                        key = f"{info.dotted}.{mname}"
                        if key in index.device_methods or \
                                _host_annotated(fdef):
                            continue
                        if any(is_device(t) for t in
                               flow.fn_returns.get(id(fdef), [])):
                            index.device_methods.add(key)
                            grew = True
        if not grew:
            return
