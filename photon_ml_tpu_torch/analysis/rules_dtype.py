"""W8xx — precision dtype-flow in torch form: bf16/f16 accumulation
discipline and f64 on the card.

Port of ``photon_ml_tpu/analysis/rules_dtype.py``. A second abstract
interpreter rides the same module ASTs as the device dataflow, but
tracks *dtypes*. The lattice is the JAX rule's:

- ``f64``/``f32``/``bf16``/``f16`` — concrete float dtypes, read from
  torch tokens (``torch.bfloat16``, ``torch.half``, ``torch.float``,
  ``"bfloat16"``), ``dtype=`` kwargs and the casts ``.bfloat16()``,
  ``.half()``, ``.float()``, ``.double()``, ``.to(<dtype>)`` and
  ``.type(<dtype>)``;
- ``weak`` — Python float literals (they take the other operand's dtype
  under torch promotion);
- ``dyn`` — a *runtime-selected* dtype: a read of ``x.dtype``, a
  ``.to()`` of a dtype variable holding one, or a selection among
  dtypes of which one may be low precision (``{"f32": torch.float32,
  "bf16": torch.bfloat16}[precision]``, ``a if c else b``). A ``dyn``
  value may be bf16 at run time (``--precision bf16``), so a reduction
  over it needs an explicit accumulator;
- ``None`` — unknown; unknown is clean everywhere (precision over
  recall, the bias of the device dataflow too).

Promotion follows torch: tensor with tensor joins to the higher dtype,
a weak scalar defers to the tensor, and bf16 with f16 gives f32.
``torch.promote_types(a, b)`` is that join, so ``acc_dtype_for``'s
``promote_types(dtype, torch.float32)`` is at least f32 whatever
``dtype`` is. Cross-module: a top-level function (and a method or
property of a package class) whose every return joins to one tag
exports it, fixpoint-style, so ``acc_dtype_for(x.dtype)`` and
``self.acc_dtype`` read as f32 at their callers.

Rules:

- **W801** a reduction — ``torch.sum`` / ``mean`` / ``prod`` /
  ``cumsum`` / ``matmul`` / ``mm`` / ``bmm`` / ``mv`` / ``dot`` /
  ``einsum`` / ``tensordot``, ``@`` (unless an operand is host data:
  numpy holds no bf16), the matching tensor methods on a device tensor, ``index_add_`` / ``scatter_add_``, and the shard
  runner's ``psum`` / ``qpsum`` — over a may-low-precision operand
  (bf16/f16/dyn) with no ``dtype=`` kwarg and no upcast in between.
  Any explicit accumulator kwarg clears the taint (a deliberate low
  precision accumulator is a choice, not an accident).
- **W802** float64 on the card: ``dtype=torch.float64``,
  ``.double()``, ``.to(torch.float64)`` or ``.type(torch.float64)``
  whose result the device dataflow tags as a device tensor. The H100
  runs f64 at a fraction of its f32 rate and moves twice the bytes;
  host-side f64 (numpy, or a cast after ``.cpu()``) is clean.
- **W804** arithmetic mixing a concrete low dtype (bf16/f16) with a
  concrete high one (f32/f64) inside a loss/gradient-named function,
  relying on implicit promotion — make the promotion explicit where it
  decides gradient precision.

W803 (a value round-tripped through numpy and fed back into a jitted
callable, which re-traces on the promoted dtype) waits: the port has no
jit cache (``core.WAITING``).
"""

from __future__ import annotations

import ast
from typing import Optional

from photon_ml_tpu_torch.analysis.core import Finding
from photon_ml_tpu_torch.analysis.dataflow import (
    HOST, Dataflow, inst_class, is_device,
)
from photon_ml_tpu_torch.analysis.package import (
    PACKAGE_PREFIX, ModuleInfo, PackageIndex,
)

F64, F32, BF16, F16, WEAK, DYN = "f64", "f32", "bf16", "f16", "weak", "dyn"
_LOW_CONCRETE = {BF16, F16}
_LOW = {BF16, F16, DYN}
_HIGH = {F32, F64}
_RANK = {WEAK: 0, F16: 1, BF16: 1, F32: 2, F64: 3}
_DTYPES = {F64, F32, BF16, F16, DYN}

# Trailing-component dtype tokens: np.float32, "float16", torch.half.
_DTYPE_TOKENS = {
    "float64": F64, "double": F64, "float32": F32, "single": F32,
    "bfloat16": BF16, "float16": F16, "half": F16,
}
# torch's own aliases: ``torch.float`` is f32 (a bare ``float`` is not).
_TORCH_TOKENS = {**_DTYPE_TOKENS, "float": F32}
# tensor casts with no argument
_CAST_METHODS = {"bfloat16": BF16, "half": F16, "float": F32,
                 "double": F64}

_PAR = f"{PACKAGE_PREFIX}parallel."
# torch (and shard-runner) reductions that accumulate in the operand
# dtype unless told not to.
_REDUCTIONS = {
    f"torch.{name}" for name in (
        "sum", "nansum", "mean", "nanmean", "prod", "cumsum", "matmul",
        "mm", "bmm", "mv", "dot", "einsum", "tensordot")
} | {f"{_PAR}collectives.psum", f"{_PAR}quantized_collectives.qpsum"}
_REDUCE_METHODS = {"sum", "nansum", "mean", "nanmean", "prod", "cumsum",
                   "matmul", "mm", "bmm", "mv", "dot"}
# scatter-adds: the operands are the receiver and the source
_SCATTER_ADDS = {"index_add_": 2, "index_add": 2, "scatter_add_": 2,
                 "scatter_add": 2}
_ACC_KWARGS = ("dtype", "out_dtype", "acc_dtype")
# dtype-preserving tensor methods worth following through chains.
_KEEP_METHODS = {
    "reshape", "view", "view_as", "ravel", "flatten", "transpose",
    "permute", "t", "squeeze", "unsqueeze", "expand", "expand_as",
    "contiguous", "clone", "detach", "cpu", "cuda", "pin_memory",
    "abs", "neg", "exp", "log", "log1p", "expm1", "sqrt", "rsqrt",
    "square", "tanh", "sigmoid", "clamp", "clamp_min", "clamp_max",
    "clip", "narrow", "index_select", "gather", "masked_fill", "flip",
    "roll", "repeat", "nan_to_num", "reciprocal", "select", "amax",
    "amin", "add", "sub", "mul", "div", "pow",
}
# dtype-preserving/promoting torch functions: name -> index of the first
# VALUE argument (where's condition carries no dtype).
_ELEMENTWISE = {
    "where": 1, "maximum": 0, "minimum": 0, "clamp": 0, "clip": 0,
    "abs": 0, "exp": 0, "log": 0, "log1p": 0, "expm1": 0, "sqrt": 0,
    "rsqrt": 0, "square": 0, "tanh": 0, "sigmoid": 0, "neg": 0,
    "negative": 0, "transpose": 0, "permute": 0, "reshape": 0,
    "flatten": 0, "squeeze": 0, "unsqueeze": 0, "broadcast_to": 0,
    "cat": 0, "concat": 0, "concatenate": 0, "stack": 0, "add": 0,
    "sub": 0, "subtract": 0, "mul": 0, "multiply": 0, "div": 0,
    "divide": 0, "pow": 0, "nan_to_num": 0, "index_select": 0,
    "gather": 0, "narrow": 0, "softplus": 0, "logsigmoid": 0,
}
# torch makers whose dtype is their first tensor argument's (the
# ``*_like`` family and the conversions).
_FOLLOW_MAKERS = {"tensor", "as_tensor", "zeros_like", "ones_like",
                  "empty_like", "full_like", "rand_like", "randn_like"}
# makers whose no-dtype default is torch's default float dtype (f32).
_F32_DEFAULT_MAKERS = {"zeros", "ones", "empty", "full", "linspace",
                       "logspace", "eye", "rand", "randn"}
_NEW_MAKERS = {"new_zeros", "new_ones", "new_empty", "new_full",
               "new_tensor"}
# numpy makers: name -> positional index of the dtype argument.
_NP_MAKER_DTYPE_POS = {
    "asarray": 1, "array": 1, "zeros": 1, "ones": 1, "empty": 1,
    "full": 2, "zeros_like": 1, "ones_like": 1, "full_like": 2,
}
_LOSS_PATH_MARKERS = ("loss", "grad", "objective")


def _promote(a: Optional[str], b: Optional[str]) -> Optional[str]:
    """May-join under torch promotion: unknown defers to the known side,
    dyn stays dyn against weak/low (it may BE low) but a concrete f32/f64
    operand dominates the runtime result."""
    if a is None:
        return b
    if b is None:
        return a
    if a == b:
        return a
    if DYN in (a, b):
        other = b if a == DYN else a
        return other if other in _HIGH else DYN
    if {a, b} == {F16, BF16}:
        return F32  # torch promotes mixed half types to f32
    return a if _RANK[a] >= _RANK[b] else b


def _select(tags) -> Optional[str]:
    """The tag of a runtime choice among ``tags``: ``dyn`` when the
    candidates differ and one of them may be low precision, else their
    join."""
    known = {t for t in tags if t is not None}
    if len(known) > 1 and known & _LOW:
        return DYN
    out = None
    for t in known:
        out = _promote(out, t)
    return out


def _elt_tags(tag):
    if isinstance(tag, tuple) and tag and tag[0] == "tuple":
        return tag[1]
    return None


def _scalar(tag):
    """Collapse a tuple tag to the join of its elements (a table of
    dtypes is no dtype until it is subscripted)."""
    if isinstance(tag, tuple) and tag and tag[0] == "dict":
        return None
    elts = _elt_tags(tag)
    if elts is None:
        return tag
    out = None
    for t in elts:
        out = _promote(out, _scalar(t))
    return out


def _tail(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1]


def _is_property(fdef) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property"
               for d in fdef.decorator_list)


class _DtypeInterp:
    """Per-module dtype walker; mirrors the device dataflow's statement
    coverage (may-merge branches, two loop passes, nested defs at their
    definition point with the enclosing env as closure)."""

    def __init__(self, mod: ModuleInfo, index: PackageIndex,
                 flow: Dataflow, fn_dtypes: dict[str, str], emit: bool,
                 findings: Optional[list] = None):
        self.mod = mod
        self.index = index
        self.flow = flow
        self.fn_dtypes = fn_dtypes
        self.emit = emit
        self.findings = findings if findings is not None else []
        self.fn_returns: dict[int, list] = {}
        self._ret_stack: list[list] = []
        self._fn_stack: list[str] = []

    def run_module(self) -> None:
        self.run_block(self.mod.tree.body, {})

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
                env[s.target.id] = _promote(
                    _scalar(env.get(s.target.id)), _scalar(t))
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
            self.expr(s.iter, env)
            self.bind(s.target, None, env)
            for _ in range(2):
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
        elif isinstance(s, ast.ClassDef):
            for sub in s.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._enter_function(sub, dict(env))
        elif isinstance(s, (ast.Raise, ast.Assert, ast.Delete)):
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self.expr(child, env)
        return env

    def _enter_function(self, fdef, closure_env: dict) -> None:
        env = dict(closure_env)
        a = fdef.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            env.pop(p.arg, None)
        if a.vararg:
            env.pop(a.vararg.arg, None)
        if a.kwarg:
            env.pop(a.kwarg.arg, None)
        for d in fdef.args.defaults + fdef.args.kw_defaults:
            if d is not None:
                self.expr(d, closure_env)
        self._ret_stack.append([])
        self._fn_stack.append(fdef.name)
        self.run_block(fdef.body, env)
        self._fn_stack.pop()
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
                for elt in target.elts:
                    self.bind(elt, None, env)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, tag, env)

    # -- expressions -------------------------------------------------------

    def expr(self, e: Optional[ast.expr], env: dict):
        if e is None:
            return None
        if isinstance(e, ast.Constant):
            if isinstance(e.value, float):
                return WEAK
            if isinstance(e.value, str):
                return _DTYPE_TOKENS.get(e.value)
            return None
        if isinstance(e, ast.Name):
            tok = self._token(e)
            return tok if tok is not None else env.get(e.id)
        if isinstance(e, ast.Attribute):
            if e.attr == "dtype":
                self.expr(e.value, env)
                return DYN
            tok = self._token(e)
            if tok is not None:
                return tok
            base = self.expr(e.value, env)
            if e.attr in ("T", "mT", "H", "mH", "real", "imag", "data",
                          "grad"):
                return _scalar(base)
            return self._member(e.value, e.attr, prop=True)
        if isinstance(e, ast.Call):
            return self._call(e, env)
        if isinstance(e, ast.BinOp):
            left = _scalar(self.expr(e.left, env))
            right = _scalar(self.expr(e.right, env))
            if isinstance(e.op, ast.MatMult):
                # a numpy/scipy product on the host holds no bf16
                if HOST not in (self.flow.tag(e.left),
                                self.flow.tag(e.right)):
                    self._check_reduction(e, [left, right], has_acc=False)
            elif self.emit and isinstance(
                    e.op, (ast.Add, ast.Sub, ast.Mult, ast.Div)):
                pair = {left, right}
                if pair & _LOW_CONCRETE and pair & _HIGH and any(
                        m in name for name in self._fn_stack
                        for m in _LOSS_PATH_MARKERS):
                    low = (pair & _LOW_CONCRETE).pop()
                    high = (pair & _HIGH).pop()
                    self.findings.append(Finding(
                        "W804", self.mod.relpath, e.lineno, e.col_offset,
                        f"{low} and {high} mixed by implicit promotion "
                        f"in a loss/gradient path — cast explicitly so "
                        f"the gradient precision is a decision, not a "
                        f"promotion-rule accident"))
            return _promote(left, right)
        if isinstance(e, ast.UnaryOp):
            return self.expr(e.operand, env)
        if isinstance(e, (ast.Compare, ast.BoolOp)):
            for child in ast.iter_child_nodes(e):
                if isinstance(child, ast.expr):
                    self.expr(child, env)
            return None  # boolean results
        if isinstance(e, ast.IfExp):
            self.expr(e.test, env)
            return _select((_scalar(self.expr(e.body, env)),
                            _scalar(self.expr(e.orelse, env))))
        if isinstance(e, ast.Subscript):
            t = self.expr(e.value, env)
            self.expr(e.slice, env)
            if isinstance(t, tuple) and t and t[0] == "dict":
                return t[1]
            elts = _elt_tags(t)
            if elts is not None and isinstance(e.slice, ast.Constant) \
                    and isinstance(e.slice.value, int) \
                    and -len(elts) <= e.slice.value < len(elts):
                return elts[e.slice.value]
            return _scalar(t)
        if isinstance(e, ast.Dict):
            for k in e.keys:
                self.expr(k, env)
            tags = [_scalar(self.expr(v, env)) for v in e.values]
            sel = _select(tags)
            # a lookup in a table of dtypes selects one at run time
            return ("dict", sel) if sel in _DTYPES else None
        if isinstance(e, (ast.Tuple, ast.List)) and not any(
                isinstance(v, ast.Starred) for v in e.elts):
            tags = tuple(self.expr(v, env) for v in e.elts)
            return ("tuple", tags) if any(t is not None for t in tags) \
                else None
        if isinstance(e, ast.NamedExpr):
            t = self.expr(e.value, env)
            self.bind(e.target, t, env)
            return t
        if isinstance(e, ast.Lambda):
            inner = dict(env)
            a = e.args
            for p in a.posonlyargs + a.args + a.kwonlyargs:
                inner.pop(p.arg, None)
            self.expr(e.body, inner)
            return None
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            inner = dict(env)
            for gen in e.generators:
                self.expr(gen.iter, inner)
                self.bind(gen.target, None, inner)
                for cond in gen.ifs:
                    self.expr(cond, inner)
            if isinstance(e, ast.DictComp):
                self.expr(e.key, inner)
                self.expr(e.value, inner)
            else:
                self.expr(e.elt, inner)
            return None
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self.expr(child, env)
        return None

    def _token(self, node) -> Optional[str]:
        d = self.mod.resolve(node)
        if d is None:
            return None
        if d.startswith("torch."):
            return _TORCH_TOKENS.get(_tail(d))
        return _DTYPE_TOKENS.get(_tail(d))

    def _member(self, receiver: ast.expr, attr: str,
                prop: bool) -> Optional[str]:
        """Exported dtype of ``receiver.attr`` (a property when ``prop``,
        else a method call) on a package-class instance."""
        c = inst_class(self.flow.tag(receiver))
        if c is None:
            return None
        hit = self.index.resolve_method(c, attr)
        if hit is None or _is_property(hit[1]) != prop:
            return None
        return self.fn_dtypes.get(f"{hit[0].dotted}.{attr}")

    def _dtype_arg(self, node, env) -> Optional[str]:
        """Dtype tag of an expression used *as a dtype* (kwarg/cast)."""
        if node is None:
            return None
        tok = None
        if isinstance(node, (ast.Name, ast.Attribute)):
            tok = self._token(node)
        if tok is not None:
            return tok
        return _scalar(self.expr(node, env))

    def _acc_kwarg(self, call: ast.Call, env):
        """(present, tag) for an explicit accumulator kwarg."""
        for kw in call.keywords:
            if kw.arg in _ACC_KWARGS:
                return True, self._dtype_arg(kw.value, env)
        return False, None

    def _check_reduction(self, node, operand_tags, has_acc: bool,
                         name: str = "@") -> None:
        if has_acc or not self.emit:
            return
        low = [t for t in operand_tags if t in _LOW]
        if not low:
            return
        tag = DYN if DYN in low else low[0]
        what = ("a value whose dtype is selected at run time (from a "
                ".dtype read or a dtype table)" if tag == DYN
                else f"a {tag} value")
        self.findings.append(Finding(
            "W801", self.mod.relpath, node.lineno, node.col_offset,
            f"{name} reduces {what} without an f32 accumulator — pass "
            f"dtype=torch.float32 (or upcast with .float() / "
            f".to(acc_dtype) first) so bf16/f16 inputs do not accumulate "
            f"in low precision"))

    def _check_f64(self, node, dt, what: str) -> None:
        """W802: an explicit f64 whose result lives on the card."""
        if not self.emit or dt != F64:
            return
        if not is_device(self.flow.tag(node)):
            return
        self.findings.append(Finding(
            "W802", self.mod.relpath, node.lineno, node.col_offset,
            f"float64 on the card via {what} — the H100 runs f64 at a "
            f"fraction of its f32 rate and moves twice the bytes; cast "
            f"after the copy to the host, or keep f32"))

    def _to_target(self, e: ast.Call, env) -> Optional[str]:
        """The dtype a ``.to(...)`` converts to, or None when it moves
        only the device (a device, a device string, or unknown)."""
        for kw in e.keywords:
            if kw.arg == "dtype":
                return self._dtype_arg(kw.value, env)
        for arg in e.args[:2]:
            t = self._dtype_arg(arg, env)
            if t in _DTYPES:
                return t
        return None

    def _method(self, e: ast.Call, env, base, kw_tags):
        """``<value>.<attr>(...)``: casts, reductions, shape methods."""
        attr = e.func.attr
        if attr in _CAST_METHODS and not e.args:
            dt = _CAST_METHODS[attr]
            self._check_f64(e, dt, f".{attr}()")
            return dt
        if attr in ("to", "type"):
            target = self._to_target(e, env)
            if target is None:
                return base if attr == "to" else None
            self._check_f64(e, target, f".{attr}(float64)")
            return target
        if attr in _REDUCE_METHODS:
            has_acc, acc = self._acc_kwarg(e, env)
            if is_device(self.flow.tag(e.func.value)):
                self._check_reduction(e, [base], has_acc,
                                      name=f".{attr}()")
            if has_acc:
                self._check_f64(e, acc, f".{attr}(dtype=float64)")
                return acc
            return base
        if attr in _SCATTER_ADDS:
            pos = _SCATTER_ADDS[attr]
            src = _scalar(self.expr(e.args[pos], env)) \
                if len(e.args) > pos else None
            if is_device(self.flow.tag(e.func.value)):
                self._check_reduction(e, [base, src], False,
                                      name=f".{attr}()")
            return base
        if attr in _NEW_MAKERS:
            if "dtype" in kw_tags:
                dt = self._dtype_arg(next(kw.value for kw in e.keywords
                                          if kw.arg == "dtype"), env)
                self._check_f64(e, dt, f".{attr}(dtype=float64)")
                return dt
            return base
        if attr in _KEEP_METHODS:
            return base
        return self._member(e.func.value, attr, prop=False)

    def _call(self, e: ast.Call, env):
        arg_tags = [_scalar(self.expr(a, env)) for a in e.args]
        kw_tags = {kw.arg: self.expr(kw.value, env) for kw in e.keywords}
        d = self.mod.resolve(e.func)

        # method calls on VALUES: x.to(...), x.sum(), x.reshape(...) — a
        # resolvable dotted func (torch.sum, np.sum) is a module call and
        # is classified below, not here
        if isinstance(e.func, ast.Attribute) and d is None:
            base = _scalar(self.expr(e.func.value, env))
            return self._method(e, env, base, kw_tags)

        if d is None:
            return None
        tail = _tail(d)
        if d in _REDUCTIONS:
            has_acc, acc = self._acc_kwarg(e, env)
            self._check_reduction(e, arg_tags, has_acc, name=tail)
            if has_acc:
                self._check_f64(e, acc, f"{tail}(dtype=float64)")
                return acc
            out = None
            for t in arg_tags:
                out = _promote(out, t)
            return out
        if d == "torch.promote_types" and len(e.args) == 2:
            return _promote(self._dtype_arg(e.args[0], env),
                            self._dtype_arg(e.args[1], env))
        if d.startswith("torch."):
            if "dtype" in kw_tags:
                dt = self._dtype_arg(next(kw.value for kw in e.keywords
                                          if kw.arg == "dtype"), env)
                self._check_f64(e, dt, f"{d}(dtype=float64)")
                return dt
            if tail in _FOLLOW_MAKERS:
                return arg_tags[0] if arg_tags else None
            if tail in _F32_DEFAULT_MAKERS:
                return F32
            if tail in _ELEMENTWISE:
                out = None
                for t in arg_tags[_ELEMENTWISE[tail]:]:
                    out = _promote(out, t)
                return out
            return None
        if d.startswith("numpy."):
            if tail in _NP_MAKER_DTYPE_POS:
                pos = _NP_MAKER_DTYPE_POS[tail]
                node = next((kw.value for kw in e.keywords
                             if kw.arg == "dtype"), None)
                if node is None and len(e.args) > pos:
                    node = e.args[pos]
                dt = self._dtype_arg(node, env)
                if dt is not None:
                    return dt
                if tail in ("asarray", "array", "zeros_like", "ones_like",
                            "full_like") and arg_tags:
                    return arg_tags[0]
                return None
            return _DTYPE_TOKENS.get(tail)
        # cross-module: a package function with a known return dtype
        if d in self.fn_dtypes:
            return self.fn_dtypes[d]
        if d == "dataclasses.replace" and arg_tags:
            return arg_tags[0]
        return None


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        cur = out.get(k)
        out[k] = v if cur is None else (
            cur if cur == v else _promote(_scalar(cur), _scalar(v)))
    return out


def _export(rets) -> Optional[str]:
    """The one tag every return of a function joins to, or None."""
    tags = [_scalar(r) for r in rets]
    if not tags or any(not isinstance(t, str) or t == WEAK for t in tags):
        return None
    out = None
    for t in tags:
        out = _promote(out, t)
    return out


def _infer_fn_dtypes(modules: list[ModuleInfo], index: PackageIndex,
                     flows: dict[str, Dataflow]) -> dict[str, str]:
    """Fixpoint: concrete return dtypes of top-level functions and of
    package-class methods (``<class dotted>.<method>``)."""
    fn_dtypes: dict[str, str] = {}
    for _ in range(3):
        grew = False
        for mod in modules:
            interp = _DtypeInterp(mod, index, flows[mod.relpath],
                                  fn_dtypes, emit=False)
            interp.run_module()
            defs = []
            for name, node in mod.toplevel_defs.items():
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    defs.append((f"{mod.module_name}.{name}", node))
                elif isinstance(node, ast.ClassDef):
                    info = index.classes.get(f"{mod.module_name}.{name}")
                    if info is not None:
                        defs.extend((f"{info.dotted}.{m}", fdef)
                                    for m, fdef in info.methods.items())
            for dotted, node in defs:
                tag = _export(interp.fn_returns.get(id(node), []))
                if tag is not None and fn_dtypes.get(dotted) != tag:
                    fn_dtypes[dotted] = tag
                    grew = True
        if not grew:
            break
    return fn_dtypes


def check(modules: list[ModuleInfo], index: PackageIndex,
          flows: dict[str, Dataflow], ctx) -> list[Finding]:
    fn_dtypes = _infer_fn_dtypes(modules, index, flows)
    findings: list[Finding] = []
    for mod in modules:
        interp = _DtypeInterp(mod, index, flows[mod.relpath], fn_dtypes,
                              emit=True, findings=findings)
        interp.run_module()
    # loop bodies run twice and both If arms run — dedupe repeat visits
    seen: set[tuple] = set()
    out: list[Finding] = []
    for f in findings:
        key = (f.rule, f.path, f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
