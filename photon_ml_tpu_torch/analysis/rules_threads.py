"""W9xx — host-concurrency safety: threads, locks, signal handlers.

Port of ``photon_ml_tpu/analysis/rules_threads.py``, unchanged in what
it checks. In the port the shard runner, the service, the fleet and the
process gang start threads and install handlers beside the modules
named below.

The host side of the system (obs/heartbeat, obs/export, utils/preempt,
the I/O loaders) runs daemon threads, locks, and signal handlers that no
test can exhaustively race. These rules make the conventions structural:

- **W901** unguarded shared state, two variants sharing one rule id:

  *thread-shared* — an attribute (or module global) written inside a
  thread body (the transitive closure of methods reachable from a
  ``threading.Thread(target=...)`` root, resolved through the class
  index) and accessed from a non-thread method with no lock in common;

  *inconsistent guard* — an attribute written under ``with self._lock:``
  in one method but written with no lock at all in another. The lock set
  is inferred from enclosing ``with`` scopes over attributes assigned
  ``threading.Lock()``/``RLock()``/``Condition()`` (and module-level
  lock globals).

  Attributes holding intrinsically thread-safe objects (locks, Events,
  queues, deques, Thread handles) are exempt, as are ``__init__``/
  ``__post_init__`` and the method that constructs the Thread (writes
  there happen-before ``start()``).
- **W902** a signal handler (anything registered via ``signal.signal``)
  doing more than async-signal-safe work: allowed are assignments,
  lock-scoped flag latching, ``Event`` ``set``/``is_set``/``clear``,
  dict ``.get``, ``signal.*``/``os.kill``/``os.getpid`` calls, and
  calls into own methods that themselves pass the same check
  (``utils/preempt.py``'s latch-and-chain handler is the exemplar).
- **W903** a thread started but never joined: a ``Thread`` stored on
  ``self`` with ``.start()`` called and no ``self.<attr>.join(...)``
  anywhere in the class, or a local ``Thread`` started and not joined
  in the same function — shutdown then can't bound the thread's
  lifetime (daemon threads die mid-write on interpreter exit).
- **W904** inconsistent nested lock order: ``with A: with B:`` at one
  site and ``with B: with A:`` at another, anywhere in the package —
  the classic deadlock shape. Lock identity is
  ``<class>.<attr>``/``<module>.<global>``, so the check is
  whole-program.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from photon_ml_tpu_torch.analysis.core import Finding
from photon_ml_tpu_torch.analysis.dataflow import Dataflow
from photon_ml_tpu_torch.analysis.package import (
    ClassInfo, ModuleInfo, PackageIndex,
)

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition"}
_SYNC_CTORS = _LOCK_CTORS | {
    "threading.Event", "threading.Semaphore", "threading.BoundedSemaphore",
    "threading.Barrier", "threading.Thread", "threading.local",
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "collections.deque",
}
_MUTATING_METHODS = {"append", "appendleft", "add", "extend", "insert",
                     "pop", "popleft", "remove", "discard", "update",
                     "setdefault", "clear", "put", "put_nowait"}
_SAFE_HANDLER_ATTRS = {"set", "clear", "is_set", "get"}
_SAFE_HANDLER_CALLS = {"os.kill", "os.getpid", "str", "int", "float",
                       "bool", "len", "repr", "format"}
_EXEMPT_METHODS = {"__init__", "__post_init__"}


# -- shared per-class facts -------------------------------------------------


@dataclasses.dataclass
class _Access:
    attr: str
    write: bool
    method: str
    line: int
    col: int
    locks: frozenset


class _ClassFacts:
    """Everything W901/W903 need about one class: attribute constructor
    kinds, lock attributes, per-method attribute accesses with held
    locks, thread roots and their method closures."""

    def __init__(self, info: ClassInfo, index: PackageIndex,
                 module_locks: set[str]):
        self.info = info
        self.index = index
        self.module_locks = module_locks
        self.attr_ctors: dict[str, str] = {}
        self.thread_targets: list[tuple[str, str, ast.Call]] = []
        # (spawn method, target method, ctor call)
        self.accesses: list[_Access] = []
        self.order_pairs: list[tuple[str, str, str, int]] = []
        self.joined_attrs: set[str] = set()
        self.started_attrs: dict[str, ast.Call] = {}
        self._collect_ctors()
        self.lock_attrs = {a for a, c in self.attr_ctors.items()
                           if c in _LOCK_CTORS}
        self.sync_attrs = {a for a, c in self.attr_ctors.items()
                           if c in _SYNC_CTORS}
        for name, fdef in info.methods.items():
            self._walk_method(name, fdef)

    def _collect_ctors(self) -> None:
        mod = self.info.mod
        for fdef in self.info.methods.values():
            for node in ast.walk(fdef):
                target = value = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target, value = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign) and node.value:
                    target, value = node.target, node.value
                if isinstance(target, ast.Attribute) \
                        and isinstance(target.value, ast.Name) \
                        and isinstance(value, ast.Call):
                    d = mod.resolve(value.func)
                    if d in _SYNC_CTORS:
                        self.attr_ctors.setdefault(target.attr, d)

    # -- lock identity ------------------------------------------------------

    def _lock_name(self, node, self_name: str) -> Optional[str]:
        """Lock identity of a with-item context expression, or None."""
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == self_name \
                and node.attr in self.lock_attrs:
            return f"{self.info.dotted}.{node.attr}"
        if isinstance(node, ast.Name):
            d = self.info.mod.resolve(node)
            if d in self.module_locks:
                return d
        return None

    # -- per-method walk ----------------------------------------------------

    def _walk_method(self, name: str, fdef) -> None:
        pos = fdef.args.posonlyargs + fdef.args.args
        if not pos:
            return
        self_name = pos[0].arg
        self._stmts(fdef.body, name, self_name, frozenset())
        for node in ast.walk(fdef):
            if not isinstance(node, ast.Call):
                continue
            d = self.info.mod.resolve(node.func)
            if d == "threading.Thread":
                tgt = None
                for kw in node.keywords:
                    if kw.arg == "target":
                        tgt = kw.value
                if isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == self_name:
                    self.thread_targets.append((name, tgt.attr, node))
            elif isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Attribute) and \
                    isinstance(node.func.value.value, ast.Name) and \
                    node.func.value.value.id == self_name:
                # self.<attr>.join() / self.<attr>.start()
                if node.func.attr == "join":
                    self.joined_attrs.add(node.func.value.attr)
                elif node.func.attr == "start" and \
                        node.func.value.attr in self.sync_attrs:
                    self.started_attrs.setdefault(
                        node.func.value.attr, node)

    def _stmts(self, stmts, method, self_name, held) -> None:
        for s in stmts or []:
            self._stmt(s, method, self_name, held)

    def _stmt(self, s, method, self_name, held) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later under unknown locks
            self._stmts(s.body, method, self_name, frozenset())
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            new = set(held)
            for item in s.items:
                self._expr(item.context_expr, method, self_name, held)
                nm = self._lock_name(item.context_expr, self_name)
                if nm is not None:
                    for outer in held:
                        self.order_pairs.append(
                            (outer, nm, method, item.context_expr.lineno))
                    new.add(nm)
            self._stmts(s.body, method, self_name, frozenset(new))
            return
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self._expr(s.iter, method, self_name, held)
            self._stmts(s.body, method, self_name, held)
            self._stmts(s.orelse, method, self_name, held)
            return
        if isinstance(s, ast.While):
            self._expr(s.test, method, self_name, held)
            self._stmts(s.body, method, self_name, held)
            self._stmts(s.orelse, method, self_name, held)
            return
        if isinstance(s, ast.If):
            self._expr(s.test, method, self_name, held)
            self._stmts(s.body, method, self_name, held)
            self._stmts(s.orelse, method, self_name, held)
            return
        if isinstance(s, ast.Try):
            self._stmts(s.body, method, self_name, held)
            for h in s.handlers:
                self._stmts(h.body, method, self_name, held)
            self._stmts(s.orelse, method, self_name, held)
            self._stmts(s.finalbody, method, self_name, held)
            return
        if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = s.targets if isinstance(s, ast.Assign) else [s.target]
            for t in targets:
                attr = self._attr_of(t, self_name)
                if attr is not None:
                    self.accesses.append(_Access(
                        attr, True, method, t.lineno, t.col_offset, held))
                else:
                    self._expr(t, method, self_name, held)
            value = s.value
            if value is not None:
                self._expr(value, method, self_name, held)
            if isinstance(s, ast.AugAssign):
                attr = self._attr_of(s.target, self_name)
                if attr is not None:  # x += 1 also reads
                    self.accesses.append(_Access(
                        attr, False, method, s.target.lineno,
                        s.target.col_offset, held))
            return
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.expr):
                self._expr(child, method, self_name, held)

    def _attr_of(self, node, self_name) -> Optional[str]:
        """self.X, self.X[...] (container mutation) → attribute name."""
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == self_name:
            return node.attr
        return None

    def _expr(self, e, method, self_name, held) -> None:
        if e is None:
            return
        for node in ast.walk(e):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == self_name:
                self.accesses.append(_Access(
                    node.attr, False, method, node.lineno,
                    node.col_offset, held))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATING_METHODS:
                attr = self._attr_of(node.func.value, self_name)
                if attr is not None:
                    self.accesses.append(_Access(
                        attr, True, method, node.lineno,
                        node.col_offset, held))

    # -- thread closure -----------------------------------------------------

    def closure(self, root: str) -> set[str]:
        """Methods transitively reachable from a thread root via
        ``self.<m>()`` calls, resolved through the class index."""
        seen: set[str] = set()
        stack = [root]
        while stack:
            m = stack.pop()
            if m in seen:
                continue
            seen.add(m)
            hit = self.index.resolve_method(self.info.dotted, m)
            if hit is None:
                continue
            _, fdef = hit
            pos = fdef.args.posonlyargs + fdef.args.args
            if not pos:
                continue
            self_name = pos[0].arg
            for node in ast.walk(fdef):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id == self_name:
                    stack.append(node.func.attr)
        return seen


# -- W901 -------------------------------------------------------------------


def _w901_class(facts: _ClassFacts, findings: list) -> None:
    info = facts.info
    exempt_attrs = facts.sync_attrs
    spawn_methods = {m for m, _, _ in facts.thread_targets}

    # thread-shared variant
    thread_methods: set[str] = set()
    roots = []
    for _, target, _ in facts.thread_targets:
        thread_methods |= facts.closure(target)
        roots.append(target)
    reported: set[str] = set()
    if thread_methods:
        outside_exempt = _EXEMPT_METHODS | spawn_methods
        by_attr_writes: dict[str, list[_Access]] = {}
        by_attr_outside: dict[str, list[_Access]] = {}
        for a in facts.accesses:
            if a.attr in exempt_attrs or a.attr in reported:
                continue
            if a.method in thread_methods and a.write:
                by_attr_writes.setdefault(a.attr, []).append(a)
            if a.method not in thread_methods and \
                    a.method not in outside_exempt:
                by_attr_outside.setdefault(a.attr, []).append(a)
        for attr in sorted(set(by_attr_writes) & set(by_attr_outside)):
            for w in by_attr_writes[attr]:
                hit = next((o for o in by_attr_outside[attr]
                            if not (w.locks & o.locks)), None)
                if hit is not None:
                    findings.append(Finding(
                        "W901", info.mod.relpath, w.line, w.col,
                        f"attribute {attr!r} is written from the "
                        f"{roots[0]!r} thread body but accessed in "
                        f"{hit.method!r} (line {hit.line}) with no lock "
                        f"in common — guard both sides with one lock or "
                        f"hand the value over via an Event/queue"))
                    reported.add(attr)
                    break

    # inconsistent-guard variant: a class lock guards SOME accesses of an
    # attribute (reads count — an unlocked write races locked readers just
    # as hard as locked writers) while another method writes it bare.
    if not facts.lock_attrs:
        return
    lock_ids = {f"{info.dotted}.{a}" for a in facts.lock_attrs} \
        | facts.module_locks
    by_attr: dict[str, list[_Access]] = {}
    for a in facts.accesses:
        if a.attr not in exempt_attrs \
                and a.method not in _EXEMPT_METHODS:
            by_attr.setdefault(a.attr, []).append(a)
    for attr, accs in sorted(by_attr.items()):
        if attr in reported:
            continue
        locked = [x for x in accs if x.locks & lock_ids]
        bare = [x for x in accs if x.write and not x.locks]
        if locked and bare:
            lk = sorted(locked[0].locks & lock_ids)[0]
            b = bare[0]
            findings.append(Finding(
                "W901", info.mod.relpath, b.line, b.col,
                f"attribute {attr!r} is accessed under "
                f"{lk.rsplit('.', 1)[-1]!r} in {locked[0].method!r} "
                f"(line {locked[0].line}) but written with no lock here "
                f"in {b.method!r} — acquire the same lock on every "
                f"access of a guarded attribute"))


def _module_locks(mod: ModuleInfo) -> set[str]:
    out = set()
    for name, value in mod.constants.items():
        if isinstance(value, ast.Call) and \
                mod.resolve(value.func) in _LOCK_CTORS:
            out.add(f"{mod.module_name}.{name}")
    return out


def _w901_globals(mod: ModuleInfo, locks: set[str],
                  findings: list) -> None:
    """Inconsistent-guard variant for ``global``-declared writes."""
    writes: dict[str, list[tuple[str, int, int, frozenset]]] = {}

    def walk_fn(fdef, declared: set[str]) -> None:
        def stmts(body, held):
            for s in body or []:
                stmt(s, held)

        def stmt(s, held):
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = {n for g in ast.walk(s)
                         if isinstance(g, ast.Global) for n in g.names}
                if inner:
                    walk_fn(s, inner)
                return
            if isinstance(s, (ast.With, ast.AsyncWith)):
                new = set(held)
                for item in s.items:
                    if isinstance(item.context_expr, ast.Name):
                        d = mod.resolve(item.context_expr)
                        if d in locks:
                            new.add(d)
                stmts(s.body, frozenset(new))
                return
            if isinstance(s, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = s.targets if isinstance(s, ast.Assign) \
                    else [s.target]
                for t in targets:
                    if isinstance(t, ast.Name) and t.id in declared:
                        writes.setdefault(t.id, []).append(
                            (fdef.name, t.lineno, t.col_offset, held))
                return
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(s, field, None)
                if isinstance(sub, list):
                    stmts(sub, held)
            for h in getattr(s, "handlers", []) or []:
                stmts(h.body, held)

        stmts(fdef.body, frozenset())

    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            declared = {n for g in ast.walk(node)
                        if isinstance(g, ast.Global) for n in g.names}
            if declared:
                walk_fn(node, declared)
    for name, sites in sorted(writes.items()):
        locked = [s for s in sites if s[3]]
        bare = [s for s in sites if not s[3]]
        if locked and bare and locked[0][0] != bare[0][0]:
            fn, line, col, _ = bare[0]
            lk = sorted(locked[0][3])[0]
            findings.append(Finding(
                "W901", mod.relpath, line, col,
                f"module global {name!r} is written under "
                f"{lk.rsplit('.', 1)[-1]!r} in {locked[0][0]!r} but "
                f"written with no lock here in {fn!r} — acquire the "
                f"same lock on every write"))


# -- W902 -------------------------------------------------------------------


def _handler_violations(info: ClassInfo, index: PackageIndex, fdef,
                        depth: int = 0, seen=None) -> list[tuple]:
    """(node, description) for non-async-signal-safe work in a handler,
    recursing into own methods (depth-limited)."""
    if seen is None:
        seen = set()
    if depth > 3 or id(fdef) in seen:
        return []
    seen.add(id(fdef))
    mod = info.mod
    pos = fdef.args.posonlyargs + fdef.args.args
    self_name = pos[0].arg if pos else None
    out: list[tuple] = []
    for node in ast.walk(fdef):
        if not isinstance(node, ast.Call):
            continue
        d = mod.resolve(node.func)
        if d is not None:
            if d.startswith("signal.") or d in _SAFE_HANDLER_CALLS:
                continue
        if isinstance(node.func, ast.Name) and d is None and \
                node.func.id in _SAFE_HANDLER_CALLS:
            continue
        if isinstance(node.func, ast.Attribute):
            base = node.func.value
            if isinstance(base, ast.Name) and base.id == self_name:
                hit = index.resolve_method(info.dotted, node.func.attr)
                if hit is not None:
                    out.extend(_handler_violations(
                        hit[0], index, hit[1], depth + 1, seen))
                    continue
            if node.func.attr in _SAFE_HANDLER_ATTRS:
                continue
        desc = d or (node.func.attr if isinstance(node.func, ast.Attribute)
                     else getattr(node.func, "id", "<call>"))
        out.append((node, desc))
    return out


def _w902(modules, index, findings) -> None:
    for info in index.classes.values():
        handlers: set[str] = set()
        for fdef in info.methods.values():
            pos = fdef.args.posonlyargs + fdef.args.args
            if not pos:
                continue
            self_name = pos[0].arg
            for node in ast.walk(fdef):
                if isinstance(node, ast.Call) and \
                        info.mod.resolve(node.func) == "signal.signal" \
                        and len(node.args) == 2:
                    h = node.args[1]
                    if isinstance(h, ast.Attribute) and \
                            isinstance(h.value, ast.Name) and \
                            h.value.id == self_name:
                        handlers.add(h.attr)
        for hname in sorted(handlers):
            hit = index.resolve_method(info.dotted, hname)
            if hit is None:
                continue
            for node, desc in _handler_violations(hit[0], index, hit[1]):
                findings.append(Finding(
                    "W902", hit[0].mod.relpath, node.lineno,
                    node.col_offset,
                    f"signal handler {hname!r} calls {desc} — handlers "
                    f"run inside arbitrary interrupted frames and must "
                    f"only latch flags/Events (set/clear, lock-scoped "
                    f"assignment, signal.*/os.kill chaining); move this "
                    f"work to the thread that observes the flag"))


# -- W903 / W904 ------------------------------------------------------------


def _w903(facts: _ClassFacts, findings: list) -> None:
    info = facts.info
    thread_attrs = {a for a, c in facts.attr_ctors.items()
                    if c == "threading.Thread"}
    for attr, start in sorted(facts.started_attrs.items()):
        if attr in thread_attrs and attr not in facts.joined_attrs:
            findings.append(Finding(
                "W903", info.mod.relpath, start.lineno, start.col_offset,
                f"thread {attr!r} is started but no method of "
                f"{info.dotted.rsplit('.', 1)[-1]} ever joins it — "
                f"shutdown cannot bound its lifetime (a daemon thread "
                f"dies mid-write on interpreter exit); add a stop/join "
                f"path"))


def _w903_locals(mod: ModuleInfo, findings: list) -> None:
    """t = threading.Thread(...); t.start() with no t.join in scope.

    A thread handed off — returned, appended to a worker list, passed to
    another call, or stored on an object — is the new owner's problem
    and is not flagged; only a thread whose sole uses in its scope are
    construction and ``.start()`` is a leak."""
    from photon_ml_tpu_torch.analysis.rules_sync import build_scope_map

    scope_of = build_scope_map(mod.tree)
    made: dict[tuple, int] = {}
    started: dict[tuple, ast.Call] = {}
    joined: set[tuple] = set()
    other_uses: dict[tuple, int] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.value, ast.Call) and \
                mod.resolve(node.value.func) == "threading.Thread" and \
                isinstance(node.targets[0], ast.Name):
            sid = scope_of.get(id(node.value))
            made[(None if sid is None else id(sid),
                  node.targets[0].id)] = node.lineno
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name):
            sid = scope_of.get(id(node))
            key = (None if sid is None else id(sid), node.func.value.id)
            if node.func.attr == "start":
                started[key] = node
            elif node.func.attr == "join":
                joined.add(key)
            else:
                other_uses[key] = other_uses.get(key, 0) + 1
        elif isinstance(node, ast.Name) and \
                isinstance(getattr(node, "ctx", None), ast.Load):
            sid = scope_of.get(id(node))
            key = (None if sid is None else id(sid), node.id)
            other_uses[key] = other_uses.get(key, 0) + 1
    for key, line in sorted(made.items(), key=lambda kv: kv[1]):
        if key not in started or key in joined:
            continue
        # every Load of the name counts once for .start()'s receiver;
        # any use beyond that is a hand-off to another owner
        if other_uses.get(key, 0) > 1:
            continue
        start_call = started[key]
        findings.append(Finding(
            "W903", mod.relpath, start_call.lineno,
            start_call.col_offset,
            f"local thread {key[1]!r} is started but never joined in "
            f"this scope — shutdown cannot bound its lifetime; join it "
            f"or hand it to an owner that does"))


def _w904(order_pairs: list[tuple[str, str, str, str, int]],
          findings: list) -> None:
    """order_pairs: (outer, inner, relpath, method, line)."""
    first: dict[tuple[str, str], tuple[str, str, int]] = {}
    for outer, inner, relpath, method, line in order_pairs:
        first.setdefault((outer, inner), (relpath, method, line))
    reported: set[frozenset] = set()
    for (outer, inner), (relpath, method, line) in sorted(
            first.items(), key=lambda kv: (kv[1][0], kv[1][2])):
        rev = first.get((inner, outer))
        pair = frozenset((outer, inner))
        if rev is None or pair in reported or outer == inner:
            continue
        reported.add(pair)
        findings.append(Finding(
            "W904", relpath, line, 0,
            f"lock {inner.rsplit('.', 1)[-1]!r} acquired while holding "
            f"{outer.rsplit('.', 1)[-1]!r} here, but {rev[0]}:{rev[2]} "
            f"({rev[1]}) nests them the other way round — pick one "
            f"global acquisition order to rule out deadlock"))


def check(modules: list[ModuleInfo], index: PackageIndex,
          flows: dict[str, Dataflow], ctx) -> list[Finding]:
    findings: list[Finding] = []
    module_locks_by_mod = {m.module_name: _module_locks(m)
                           for m in modules}
    all_order_pairs: list[tuple] = []
    for info in index.classes.values():
        locks = module_locks_by_mod.get(info.mod.module_name, set())
        facts = _ClassFacts(info, index, locks)
        _w901_class(facts, findings)
        _w903(facts, findings)
        all_order_pairs.extend(
            (outer, inner, info.mod.relpath, f"{info.dotted}.{method}",
             line)
            for outer, inner, method, line in facts.order_pairs)
    for mod in modules:
        locks = module_locks_by_mod.get(mod.module_name, set())
        if locks:
            _w901_globals(mod, locks, findings)
        _w903_locals(mod, findings)
    _w902(modules, index, findings)
    _w904(all_order_pairs, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    # class walks can visit a site twice (AugAssign read+write) — dedupe
    seen: set[tuple] = set()
    out: list[Finding] = []
    for f in findings:
        key = (f.rule, f.path, f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
