"""The port's photonlint held against the JAX package's, rule by rule.

- Parity: for every rule of W0, W4, W5, W9, WA and WB, fixture packages
  (at least one that fires the rule and one that stays clean) go through
  ``photon_ml_tpu.analysis.runner.lint`` and the port's ``lint`` with the
  same families and the same README stub; the findings
  ``(rule, path, line, col, message)`` — new and suppressed — are equal.
- W1 pairs: each JAX W1 fixture translated line for line into torch; the
  JAX linter's ``(rule, line, col)`` on the JAX snippet equals the port
  linter's on the torch snippet. Torch-only idioms (``.tolist()``,
  ``.numpy()``, ``torch.cuda.synchronize()``, a ``non_blocking=True``
  copy into pinned memory) have cases of their own.
- The README table of telemetry names that differ in the port, as the
  port's WB reads it, and the families and rules the port does not run
  (W6 and W8 are held against the JAX rules in
  ``test_torch_photonlint_w6_w8.py``).
"""

import re

import pytest

from photon_ml_tpu.analysis import runner as jax_runner
from photon_ml_tpu_torch.analysis import runner as port_runner
from photon_ml_tpu_torch.analysis.core import FAMILIES, RULES, WAITING


def _write(root, files, readme):
    pkg = root / "pkg"
    for name, src in files.items():
        path = pkg / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    readme_path = None
    if readme is not None:
        readme_path = root / "README.md"
        readme_path.write_text(readme)
    return readme_path


def _lint(lint, root, readme_path, families):
    return lint(root, paths=["pkg"], readme=readme_path, families=families)


def _key(report):
    return ([(f.rule, f.path, f.line, f.col, f.message) for f in report.new],
            [(f.rule, f.path, f.line, f.col, f.message)
             for f in report.suppressed])


def run_both(tmp_path, files, readme=None, families=None):
    readme_path = _write(tmp_path, files, readme)
    return (_lint(jax_runner.lint, tmp_path, readme_path, families),
            _lint(port_runner.lint, tmp_path, readme_path, families))


# -- fixtures (the JAX linter's test snippets, mirrored) ---------------------

FAULT_README = """# fixture
| point | fires | tag |
|---|---|---|
| `cd.update` | after each update | sweep.coord |
| `ghost.point` | documented but gone | — |
"""
FAULT_README_CLEAN = FAULT_README.replace(
    "| `ghost.point` | documented but gone | — |\n", "")

W4_POSITIVE = """
from photon_ml_tpu_torch.utils.faults import fault_point

def body():
    fault_point("cd.update", tag="1.1")
    fault_point("cd.unlisted")      # W401: not in the table
    name = "dyn"
    fault_point(name)               # W403: not a literal
"""

W4_NEGATIVE = """
from photon_ml_tpu_torch.utils.faults import fault_point

def body():
    fault_point("cd.update", tag="1.1")
"""

W4_SUPPRESSED = """
from photon_ml_tpu_torch.utils.faults import fault_point

def body():
    fault_point("cd.update", tag="1.1")
    # photonlint: allow-W401(fixture: experimental point, not yet documented)
    fault_point("cd.unlisted")
"""

W0_MALFORMED_EMPTY = """
def f(x):
    # photonlint: allow-W401()
    return x + 1
"""

W0_MALFORMED_GRAMMAR = """
def f(x):
    # photonlint: please ignore this line
    return x + 1
"""

W0_STALE = """
def f(x):
    # photonlint: allow-W903(stale: the thread was removed)
    return x + 1
"""

W5_POSITIVE = """
def save(ckpt_mgr, sweep, states):
    state = {"sweep": sweep, "states": states, "orphan": 1}  # W502
    ckpt_mgr.save(sweep, state)

def resume(ckpt_mgr):
    snap = ckpt_mgr.restore()
    return snap["sweep"], snap["states"], snap.get("phantom")  # W501
"""

W5_NEGATIVE = """
def save(ckpt_mgr, sweep, states):
    ckpt_mgr.save(sweep, {"sweep": sweep, "states": states})

def resume(ckpt_mgr):
    snap = ckpt_mgr.restore()
    return snap["sweep"], snap.get("states")
"""

W5_SUPPRESSED = """
def save(ckpt_mgr, sweep):
    ckpt_mgr.save(sweep, {"sweep": sweep})

def resume(ckpt_mgr):
    snap = ckpt_mgr.restore()
    # photonlint: allow-W501(fixture: key written by an older release)
    return snap["legacy_field"], snap["sweep"]
"""

W5_WRAPPER = """
def _checkpoint_save_contained(manager, step, snapshot):
    manager.save(step, snapshot)

def save(mgr, sweep, states):
    _checkpoint_save_contained(mgr, sweep,
                               {"sweep": sweep, "states": states})
    save_checkpoint_report(mgr, {"path": "out", "elapsed": 1.0})

def save_checkpoint_report(mgr, info):
    pass

def resume(ckpt_mgr):
    snap = ckpt_mgr.restore()
    return snap["sweep"], snap.get("states")
"""

W5_WRITE_ONLY = """
def save(ckpt_mgr, sweep, states):
    ckpt_mgr.save(sweep, {"sweep": sweep, "states": states, "extra": 2})

def resume(ckpt_mgr):
    snap = ckpt_mgr.restore()
    return snap["sweep"], snap["states"]
"""

W901_POSITIVE = """
import threading

class Worker:
    def __init__(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._count = 0

    def start(self):
        self._thread.start()

    def _run(self):
        while True:
            self._count += 1       # W901: thread write, unlocked reader

    def snapshot(self):
        return self._count

    def stop(self):
        self._thread.join()
"""

W901_NEGATIVE = """
import threading

class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._count = 0

    def start(self):
        self._thread.start()

    def _run(self):
        while True:
            with self._lock:
                self._count += 1

    def snapshot(self):
        with self._lock:
            return self._count

    def stop(self):
        self._thread.join()
"""

W901_GUARD_POSITIVE = """
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._values = {}

    def inc(self, key):
        self._values[key] = self._values.get(key, 0) + 1   # W901: bare

    def total(self):
        with self._lock:
            return sum(self._values.values())
"""

W902_POSITIVE = """
import signal
import time

class Latch:
    def install(self):
        signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, signum, frame):
        time.sleep(0.1)            # W902: not async-signal-safe
"""

W902_NEGATIVE = """
import os
import signal
import threading

class Latch:
    def __init__(self):
        self._event = threading.Event()

    def install(self):
        signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, signum, frame):
        self._event.set()
        os.kill(os.getpid(), signum)
"""

W903_POSITIVE = """
import threading

class Pump:
    def __init__(self):
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()       # W903: never joined

    def _run(self):
        pass
"""

W903_NEGATIVE = W903_POSITIVE.replace(
    "        self._thread.start()       # W903: never joined\n",
    "        self._thread.start()\n\n    def close(self):\n"
    "        self._thread.join()\n")

W903_SUPPRESSED = W903_POSITIVE.replace(
    "        self._thread.start()       # W903: never joined\n",
    "        # photonlint: allow-W903(fixture: process-lifetime daemon by"
    " design)\n        self._thread.start()\n")

W904_POSITIVE = """
import threading

class Pair:
    def __init__(self):
        self._la = threading.Lock()
        self._lb = threading.Lock()

    def one(self):
        with self._la:
            with self._lb:
                pass

    def two(self):
        with self._lb:
            with self._la:         # W904: reversed nesting
                pass
"""

W904_NEGATIVE = W904_POSITIVE.replace(
    "        with self._lb:\n            with self._la:         # W904: "
    "reversed nesting\n",
    "        with self._la:\n            with self._lb:\n")

WA_CLIENT_SCORE_PROBE = """
class Client:
    def request(self, msg):
        return msg

    def score(self, rows):
        return self.request({"kind": "score", "rows": rows})

    def probe(self):
        return self.request({"kind": "probe"})
"""

WA_SERVER_SCORE_ONLY = """
def serve_loop(recv, send):
    msg = recv()
    kind = msg.get("kind")
    if kind == "score":
        send({"kind": "scores", "rows": msg.get("rows")})
"""

WA_SERVER_SCORE_PROBE = """
def serve_loop(recv, send):
    msg = recv()
    kind = msg.get("kind")
    if kind == "score":
        send({"kind": "scores", "rows": msg.get("rows")})
    elif kind == "probe":
        send({"kind": "pong"})
"""

WA_CLIENT_SCORE_ONLY = """
class Client:
    def request(self, msg):
        return msg

    def score(self, rows):
        return self.request({"kind": "score", "rows": rows})
"""

WA00_DYNAMIC = """
def emit(client, kinds):
    for k in kinds:
        client.request({"kind": k})
"""

WA00_PREFIX = """
def emit(client, n):
    client.request({"kind": f"score_b{n}"})


def serve_loop(recv, send):
    msg = recv()
    kind = msg.get("kind")
    if kind == "score_b4":
        send({"kind": "scores"})
"""

WA03_PROTOCOL = """
class ServeRequestError(RuntimeError):
    pass


class ShedError(ServeRequestError):
    pass


class BoomError(ServeRequestError):
    pass


_TYPED_ERRORS = {
    "BoomError": BoomError,
}


def typed_error(resp):
    err = resp.get("error")
    if err is None:
        return None
    name = err.partition(":")[0]
    if name in _TYPED_ERRORS:
        return _TYPED_ERRORS[name](err)
    return ServeRequestError(err)


def fail(shard):
    raise BoomError(f"shard {shard} down")
"""

WA04_FIXTURE = """
_TRANSPORT_REPLY_ERRORS = frozenset({
    "OSError",
    "GhostFault",
})


def run(sock, send):
    try:
        return sock.read()
    except OSError as e:
        send({"kind": "error", "error": f"{type(e).__name__}: {e}"})
"""

WA05_FIXTURE = """
def hello_msg():
    return {"kind": "hello", "proto": 1, "model_id": "m0"}


def read_hello(recv):
    msg = recv()
    if msg.get("kind") == "hello":
        return msg.get("generation")
"""

WB_EMIT_AND_STATUS = """
def work(registry):
    registry.counter("hits").inc(tier="hot")
    registry.counter("misses").inc(tier="hot")


def status(totals):
    return totals.get("hits")
"""

WB_README_TAXONOMY = """# fixture

| metric | type | where | labels |
|--------|------|-------|--------|
| `hits` | counter | work | `tier` |
| `misses` | counter | work | `tier` |
"""

WB_LOOP_SPANS = """
import trace


def work(w):
    stage_spans = (
        ("stage.alpha", 1, 2),
        ("stage.beta", 2, 3),
        ("stage.gamma", 3, 4),
    )
    for name, s, e in stage_spans[1:]:
        trace.record_span(name, s, e, tag="x")
    events = []
    for name, s, e in stage_spans:
        events.append({"name": name})
    return events


def scan(rec):
    return rec.get("name") == "stage.beta"
"""

WB04_DRIFT = """
def a(registry):
    registry.counter("hits").inc(tier="hot")


def b(registry):
    registry.counter("hits").inc()
"""

# (id, rule, fires, files, readme, families)
PARITY_CASES = [
    ("W001-empty-reason", "W001", True, {"mod.py": W0_MALFORMED_EMPTY},
     None, None),
    ("W001-bad-grammar", "W001", True, {"mod.py": W0_MALFORMED_GRAMMAR},
     None, None),
    ("W001-clean", "W001", False, {"mod.py": W4_SUPPRESSED},
     FAULT_README_CLEAN, None),
    ("W002-stale", "W002", True, {"mod.py": W0_STALE}, None, None),
    ("W002-used", "W002", False, {"mod.py": W903_SUPPRESSED}, None, None),
    ("W002-subset-run", "W002", False, {"mod.py": W0_STALE}, None, {"W9"}),
    ("W401-fires", "W401", True, {"mod.py": W4_POSITIVE}, FAULT_README,
     {"W4"}),
    ("W401-clean", "W401", False, {"mod.py": W4_NEGATIVE},
     FAULT_README_CLEAN, {"W4"}),
    ("W401-suppressed", "W401", False, {"mod.py": W4_SUPPRESSED},
     FAULT_README_CLEAN, {"W4"}),
    ("W402-fires", "W402", True, {"mod.py": W4_NEGATIVE}, FAULT_README,
     {"W4"}),
    ("W402-clean", "W402", False, {"mod.py": W4_NEGATIVE},
     FAULT_README_CLEAN, {"W4"}),
    ("W403-fires", "W403", True, {"mod.py": W4_POSITIVE}, FAULT_README,
     {"W4"}),
    ("W403-clean", "W403", False, {"mod.py": W4_NEGATIVE}, FAULT_README,
     {"W4"}),
    ("W501-fires", "W501", True, {"mod.py": W5_POSITIVE}, None, {"W5"}),
    ("W501-clean", "W501", False, {"mod.py": W5_NEGATIVE}, None, {"W5"}),
    ("W501-suppressed", "W501", False, {"mod.py": W5_SUPPRESSED}, None,
     {"W5"}),
    ("W501-save-wrapper", "W501", False, {"mod.py": W5_WRAPPER}, None,
     {"W5"}),
    ("W502-fires", "W502", True, {"mod.py": W5_WRITE_ONLY}, None, {"W5"}),
    ("W502-clean", "W502", False, {"mod.py": W5_NEGATIVE}, None, {"W5"}),
    ("W901-fires", "W901", True, {"mod.py": W901_POSITIVE}, None, {"W9"}),
    ("W901-guard-fires", "W901", True, {"mod.py": W901_GUARD_POSITIVE},
     None, {"W9"}),
    ("W901-clean", "W901", False, {"mod.py": W901_NEGATIVE}, None, {"W9"}),
    ("W902-fires", "W902", True, {"mod.py": W902_POSITIVE}, None, {"W9"}),
    ("W902-clean", "W902", False, {"mod.py": W902_NEGATIVE}, None, {"W9"}),
    ("W903-fires", "W903", True, {"mod.py": W903_POSITIVE}, None, {"W9"}),
    ("W903-clean", "W903", False, {"mod.py": W903_NEGATIVE}, None, {"W9"}),
    ("W903-suppressed", "W903", False, {"mod.py": W903_SUPPRESSED}, None,
     {"W9"}),
    ("W904-fires", "W904", True, {"mod.py": W904_POSITIVE}, None, {"W9"}),
    ("W904-clean", "W904", False, {"mod.py": W904_NEGATIVE}, None, {"W9"}),
    ("WA00-fires", "WA00", True, {"serve/emit.py": WA00_DYNAMIC}, None,
     {"WA"}),
    ("WA00-prefix-clean", "WA00", False, {"serve/mod.py": WA00_PREFIX},
     None, {"WA"}),
    ("WA01-fires", "WA01", True,
     {"serve/client.py": WA_CLIENT_SCORE_PROBE,
      "serve/server.py": WA_SERVER_SCORE_ONLY}, None, {"WA"}),
    ("WA01-clean", "WA01", False,
     {"serve/client.py": WA_CLIENT_SCORE_PROBE,
      "serve/server.py": WA_SERVER_SCORE_PROBE}, None, {"WA"}),
    ("WA02-fires", "WA02", True,
     {"serve/client.py": WA_CLIENT_SCORE_ONLY,
      "serve/server.py": WA_SERVER_SCORE_PROBE}, None, {"WA"}),
    ("WA02-clean", "WA02", False,
     {"serve/client.py": WA_CLIENT_SCORE_ONLY,
      "serve/server.py": WA_SERVER_SCORE_ONLY}, None, {"WA"}),
    ("WA03-fires", "WA03", True,
     {"serve/protocol.py": WA03_PROTOCOL.replace(
         '    "BoomError": BoomError,\n', '')}, None, {"WA"}),
    ("WA03-clean", "WA03", False, {"serve/protocol.py": WA03_PROTOCOL},
     None, {"WA"}),
    ("WA04-fires", "WA04", True, {"serve/fleet.py": WA04_FIXTURE}, None,
     {"WA"}),
    ("WA04-alias-fires", "WA04", True,
     {"serve/fleet.py": WA04_FIXTURE.replace('"GhostFault"', '"IOError"')},
     None, {"WA"}),
    ("WA04-clean", "WA04", False,
     {"serve/fleet.py": WA04_FIXTURE.replace('    "GhostFault",\n', '')},
     None, {"WA"}),
    ("WA05-fires", "WA05", True, {"serve/proto.py": WA05_FIXTURE}, None,
     {"WA"}),
    ("WA05-clean", "WA05", False,
     {"serve/proto.py": WA05_FIXTURE.replace('msg.get("generation")',
                                             'msg.get("model_id")')},
     None, {"WA"}),
    ("WB00-fires", "WB00", True,
     {"mod.py": "def work(registry, name):\n"
                "    registry.counter(name).inc()\n"}, None, {"WB"}),
    ("WB00-loop-literal-clean", "WB00", False, {"mod.py": WB_LOOP_SPANS},
     None, {"WB"}),
    ("WB01-fires", "WB01", True, {"mod.py": WB_EMIT_AND_STATUS},
     WB_README_TAXONOMY.replace("| `misses` | counter | work | `tier` |\n",
                                ""), {"WB"}),
    ("WB01-clean", "WB01", False, {"mod.py": WB_EMIT_AND_STATUS},
     WB_README_TAXONOMY, {"WB"}),
    ("WB01-no-table", "WB01", False, {"mod.py": WB_EMIT_AND_STATUS},
     "# fixture readme, no tables\n", {"WB"}),
    ("WB02-fires", "WB02", True, {"mod.py": WB_EMIT_AND_STATUS},
     WB_README_TAXONOMY + "| `ghost` | counter | nowhere | — |\n", {"WB"}),
    ("WB02-clean", "WB02", False, {"mod.py": WB_EMIT_AND_STATUS},
     WB_README_TAXONOMY, {"WB"}),
    ("WB03-fires", "WB03", True,
     {"mod.py": WB_EMIT_AND_STATUS.replace('totals.get("hits")',
                                           'totals.get("hit_total")')},
     None, {"WB"}),
    ("WB03-span-compare-fires", "WB03", True,
     {"mod.py": WB_LOOP_SPANS.replace('"stage.beta"\n', '"stage.alpha"\n')},
     None, {"WB"}),
    ("WB03-clean", "WB03", False, {"mod.py": WB_EMIT_AND_STATUS}, None,
     {"WB"}),
    ("WB04-fires", "WB04", True, {"mod.py": WB04_DRIFT}, None, {"WB"}),
    ("WB04-clean", "WB04", False, {"mod.py": WB_EMIT_AND_STATUS}, None,
     {"WB"}),
]


def test_parity_cases_cover_every_rule_both_ways():
    ported = {r for r in RULES if r[:2] in ("W0", "W4", "W5", "W9", "WA",
                                            "WB")}
    fired = {rule for _, rule, fires, *_ in PARITY_CASES if fires}
    clean = {rule for _, rule, fires, *_ in PARITY_CASES if not fires}
    assert fired == ported and clean == ported


@pytest.mark.parametrize(
    "rule,fires,files,readme,families",
    [c[1:] for c in PARITY_CASES], ids=[c[0] for c in PARITY_CASES])
def test_findings_equal_the_jax_linter(tmp_path, rule, fires, files,
                                       readme, families):
    jax_report, port_report = run_both(tmp_path, files, readme, families)
    assert _key(port_report) == _key(jax_report)
    fired = {f.rule for f in port_report.new}
    assert (rule in fired) == fires, [f.format() for f in port_report.new]


# -- W1: the JAX fixtures translated line for line into torch ----------------

W1_POSITIVE = ("""
import jax
import jax.numpy as jnp
import numpy as np

def objective():
    x = jnp.zeros((4,))
    loss = float(jnp.sum(x))        # W101
    flag = bool(jnp.all(x > 0))     # W101
    one = jnp.max(x).item()         # W102
    host = np.asarray(x)            # W103
    rest = jax.device_get(x)        # W104 (no record_host_fetch)
    return loss, flag, one, host, rest
""", """
import torch
import torch.nn.functional as F
import numpy as np

def objective():
    x = torch.zeros((4,), device="cuda")
    loss = float(torch.sum(x))      # W101
    flag = bool(torch.all(x > 0))   # W101
    one = torch.max(x).item()       # W102
    host = np.asarray(x)            # W103
    rest = x.cpu()                  # W104 (no record_host_fetch)
    return loss, flag, one, host, rest
""")

W1_NEGATIVE = ("""
import jax
import jax.numpy as jnp
import numpy as np
from photon_ml_tpu.utils.sync_telemetry import record_host_fetch

def objective():
    x = jnp.zeros((4,))
    fetched = jax.device_get((jnp.sum(x), jnp.all(x > 0)))
    record_host_fetch()
    loss, flag = fetched
    host = np.asarray([1.0, 2.0])   # numpy input: free
    return float(loss), bool(flag), host
""", """
import torch
import torch.nn.functional as F
import numpy as np
from photon_ml_tpu_torch.utils.sync_telemetry import record_host_fetch

def objective():
    x = torch.zeros((4,), device="cuda")
    fetched = torch.stack((torch.sum(x), torch.all(x > 0))).cpu()
    record_host_fetch()
    loss, flag = fetched.tolist()
    host = np.asarray([1.0, 2.0])   # numpy input: free
    return float(loss), bool(flag), host
""")

W1_SUPPRESSED = ("""
import jax.numpy as jnp

def objective():
    x = jnp.zeros((4,))
    # photonlint: allow-W101(fixture: intentional scalar sync)
    return float(jnp.sum(x))
""", """
import torch

def objective():
    x = torch.zeros((4,), device="cuda")
    # photonlint: allow-W101(fixture: intentional scalar sync)
    return float(torch.sum(x))
""")

W1_MALFORMED = ("""
import jax.numpy as jnp

def f():
    x = jnp.zeros(())
    # photonlint: allow-W101()
    return float(x)
""", """
import torch

def f():
    x = torch.zeros((), device="cuda")
    # photonlint: allow-W101()
    return float(x)
""")

W1_WILDCARD = ("""
import jax.numpy as jnp

def f():
    x = jnp.zeros(())
    # photonlint: allow-W1xx(fixture: whole-family waiver)
    return float(x)
""", """
import torch

def f():
    x = torch.zeros((), device="cuda")
    # photonlint: allow-W1xx(fixture: whole-family waiver)
    return float(x)
""")

W1_CANARY = ("""
import jax.numpy as jnp

def _photonlint_canary_sync():
    return float(jnp.sum(jnp.zeros((3,))))

def extra():
    return int(jnp.ones(()))
""", """
import torch

def _photonlint_canary_sync():
    return float(torch.sum(torch.zeros((3,), device="cuda")))

def extra():
    return int(torch.ones((), device="cuda"))
""")

RECEIVER_CLASS_MOD = ("""
import jax.numpy as jnp

class Scorer:
    def __init__(self, scale):
        self.scale = scale

    def score(self, x):
        return jnp.sum(x) * self.scale

    def label(self):
        return "scorer"

class Holder:
    def __init__(self):
        self.scorer = Scorer(1.0)
""", """
import torch

class Scorer:
    def __init__(self, scale):
        self.scale = scale

    def score(self, x):
        return torch.sum(x) * self.scale

    def label(self):
        return "scorer"

class Holder:
    def __init__(self):
        self.scorer = Scorer(1.0)
""")

RECEIVER_USE_MOD = """
from pkg.mod_a import Scorer, Holder

def evaluate(x):
    s = Scorer(2.0)
    return float(s.score(x))        # W101: method resolves cross-module

def evaluate_chain(x):
    h = Holder()
    return float(h.scorer.score(x))  # W101: through the attribute index

def describe():
    s = Scorer(2.0)
    return float(len(s.label()))    # str-returning method: clean
"""

HOST_ANNOTATED = ("""
import jax.numpy as jnp

class Penalty:
    def value_device(self, x):
        return jnp.sum(x * x)

    def value(self, x) -> float:
        v = self.value_device(x)
        # photonlint: allow-W101(the designated host accessor syncs here)
        return v if isinstance(v, float) else float(v)
""", """
import torch

class Penalty:
    def value_device(self, x):
        return torch.sum(x * x)

    def value(self, x) -> float:
        v = self.value_device(x)
        # photonlint: allow-W101(the designated host accessor syncs here)
        return v if isinstance(v, float) else float(v)
""")

HOST_ANNOTATED_USE = """
from pkg.mod_a import Penalty

def objective(x):
    p = Penalty()
    return 2.0 * float(p.value(x))   # already host: clean
"""

W105_POSITIVE = """
def sweep(dispatch_update, resolve_update, blocks):
    p0 = dispatch_update(blocks[0])
    p1 = dispatch_update(blocks[1])
    p2 = dispatch_update(blocks[2])   # W105: p0 now two dispatches old
    resolve_update(p0)
    resolve_update(p1)
    resolve_update(p2)
"""

W105_LOOP_POSITIVE = """
def sweep(dispatch_update, resolve_update, blocks):
    older = None
    newer = None
    for b in blocks:
        cur = dispatch_update(b)      # W105: 'older' survives 2 dispatches
        if older is not None:
            resolve_update(older)
        older = newer
        newer = cur
"""

W105_NEGATIVE = """
def sweep(dispatch_update, resolve_update, fetch_update, blocks):
    pending = None
    for b in blocks:
        cur = dispatch_update(b)      # depth 1: pending is one old, fine
        if pending is not None:
            resolve_update(pending)
        pending = cur
    if pending is not None:
        resolve_update(pending)

def ladder(dispatch_update, fetch_update, b):
    p = dispatch_update(b)
    objective, loss = fetch_update(p)
    return objective, loss
"""

W105_SUPPRESSED = """
def sweep(dispatch_update, resolve_update, blocks):
    p0 = dispatch_update(blocks[0])
    p1 = dispatch_update(blocks[1])
    # photonlint: allow-W105(fixture: bounded two-deep drain follows)
    p2 = dispatch_update(blocks[2])
    for p in (p0, p1, p2):
        resolve_update(p)
"""

# (id, {file: (jax source, torch source)}, families, expected new rules)
W1_PAIRS = [
    ("positive", {"mod.py": W1_POSITIVE}, {"W1"},
     ["W101", "W101", "W102", "W103", "W104"]),
    ("negative", {"mod.py": W1_NEGATIVE}, {"W1"}, []),
    ("suppressed", {"mod.py": W1_SUPPRESSED}, {"W1"}, []),
    ("malformed-directive", {"mod.py": W1_MALFORMED}, None,
     ["W001", "W101"]),
    ("family-wildcard", {"mod.py": W1_WILDCARD}, {"W1"}, []),
    ("canary-scalars", {"mod.py": W1_CANARY}, {"W1"}, ["W101", "W101"]),
    ("cross-module-receiver",
     {"mod_a.py": RECEIVER_CLASS_MOD,
      "mod_b.py": (RECEIVER_USE_MOD, RECEIVER_USE_MOD)}, {"W1"},
     ["W101", "W101"]),
    ("host-annotation-trusted",
     {"mod_a.py": HOST_ANNOTATED,
      "mod_b.py": (HOST_ANNOTATED_USE, HOST_ANNOTATED_USE)}, {"W1"}, []),
    ("w105-positive", {"mod.py": (W105_POSITIVE,) * 2}, {"W1"}, ["W105"]),
    ("w105-loop-positive", {"mod.py": (W105_LOOP_POSITIVE,) * 2}, {"W1"},
     ["W105"]),
    ("w105-negative", {"mod.py": (W105_NEGATIVE,) * 2}, {"W1"}, []),
    ("w105-suppressed", {"mod.py": (W105_SUPPRESSED,) * 2}, {"W1"}, []),
]


def _rlc(report):
    return (sorted((f.rule, f.path, f.line, f.col) for f in report.new),
            sorted((f.rule, f.path, f.line, f.col)
                   for f in report.suppressed))


@pytest.mark.parametrize("pair,families,expected",
                         [p[1:] for p in W1_PAIRS],
                         ids=[p[0] for p in W1_PAIRS])
def test_w1_torch_form_matches_the_jax_rules(tmp_path, pair, families,
                                             expected):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    _write(jax_root, {n: src[0] for n, src in pair.items()}, None)
    _write(port_root, {n: src[1] for n, src in pair.items()}, None)
    jax_report = _lint(jax_runner.lint, jax_root, None, families)
    port_report = _lint(port_runner.lint, port_root, None, families)
    assert _rlc(port_report) == _rlc(jax_report)
    assert sorted(f.rule for f in port_report.new) == expected, \
        [f.format() for f in port_report.new]


# -- W1: torch-only idioms ---------------------------------------------------

TORCH_IDIOMS = """
import numpy as np
import torch
from torch import Tensor


def tolist(x: Tensor):
    return x.tolist()                                    # W102


def numpy_of(y):
    z = torch.exp(y)
    return z.numpy()                                     # W103


def wait_all():
    torch.cuda.synchronize()                             # W104


def event_wait(x):
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()                                     # W104


def to_cpu(x: Tensor):
    return x.to("cpu")                                   # W104


def to_cpu_device(x: Tensor):
    return x.to(torch.device("cpu"))                     # W104


def pinned_copy(x: Tensor):
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)                     # clean: no wait
    staged = x.to("cpu", non_blocking=True)              # clean: no wait
    return host, staged


def host_tensors(a: np.ndarray):
    t = torch.from_numpy(a)
    u = torch.zeros(3)
    return t.tolist(), float(u.sum()), u.numpy(), u.cpu()   # all host


def unknown(v):
    return v.tolist(), float(v), v.cpu()                 # unknown: clean


def nn_module(x):
    layer = torch.nn.Linear(4, 1)
    return float(layer(x))                               # W101
"""


def test_torch_only_idioms(tmp_path):
    _write(tmp_path, {"mod.py": TORCH_IDIOMS}, None)
    report = _lint(port_runner.lint, tmp_path, None, {"W1"})
    want = [(i, line.rsplit("# ", 1)[-1])
            for i, line in enumerate(TORCH_IDIOMS.splitlines(), start=1)
            if re.search(r"# W10[1-4]$", line)]
    assert len(want) == 7
    assert [(f.line, f.rule) for f in report.new] == want, \
        [f.format() for f in report.new]


def test_instrumented_scope_clears_the_blocking_copy(tmp_path):
    src = """
import torch
from photon_ml_tpu_torch.utils.sync_telemetry import record_host_fetch


def fetch(p):
    p.ready.synchronize()
    record_host_fetch(site="cd.epilogue")


def fetch_nested(x):
    def inner():
        return torch.exp(x).cpu()
    out = inner()
    record_host_fetch(site="nested")
    return out
"""
    _write(tmp_path, {"mod.py": src}, None)
    report = _lint(port_runner.lint, tmp_path, None, {"W1"})
    assert report.new == [], [f.format() for f in report.new]
    _write(tmp_path, {"mod.py": src.replace(
        '    record_host_fetch(site="cd.epilogue")\n', "")}, None)
    report = _lint(port_runner.lint, tmp_path, None, {"W1"})
    assert [(f.rule, f.line) for f in report.new] == [("W104", 7)]


# -- the README table of names that differ in the port ----------------------

DELTA_README = """# fixture

| span | what | labels |
|------|------|--------|
| `phase.run` | a phase | — |
| `xla.compile` | an XLA compile | `site` |

| metric | type | where | labels |
|--------|------|-------|--------|
| `hits` | counter | work | `tier` |
| `misses` | counter | work | `tier` |

| name | kind | JAX package | port | why |
|------|------|-------------|------|-----|
| `build.compile` | span | no | yes | a run-time build |
| `xla.compile` | span | yes | no | no jit in the port |
"""

DELTA_EMITS = """
import trace


def work(registry):
    registry.counter("hits").inc(tier="hot")
    registry.counter("misses").inc(tier="hot")
    with trace.span("phase.run"):
        trace.record_span("build.compile", 0, 1, site="x")
"""


def test_port_delta_table_reconciles_wb(tmp_path):
    _write(tmp_path, {"mod.py": DELTA_EMITS}, DELTA_README)
    readme = tmp_path / "README.md"
    assert _lint(port_runner.lint, tmp_path, readme, {"WB"}).new == []
    # the JAX linter, which does not read the table, sees both rows
    jax_rules = sorted(f.rule for f in _lint(jax_runner.lint, tmp_path,
                                             readme, {"WB"}).new)
    assert jax_rules == ["WB01", "WB02"]
    # a port-only row that nothing in the port emits is a phantom row
    _write(tmp_path, {"mod.py": DELTA_EMITS.replace(
        '        trace.record_span("build.compile", 0, 1, site="x")\n',
        "        pass\n")}, DELTA_README)
    report = _lint(port_runner.lint, tmp_path, readme, {"WB"})
    assert [(f.rule, f.path, f.line) for f in report.new] == [
        ("WB02", "README.md", 15)]
    # a JAX-only name the port emits after all contradicts the table
    _write(tmp_path, {"mod.py": DELTA_EMITS.replace(
        '"build.compile"', '"xla.compile"')}, DELTA_README)
    report = _lint(port_runner.lint, tmp_path, readme, {"WB"})
    rules = sorted(f.rule for f in report.new)
    assert rules == ["WB01", "WB02"], [f.format() for f in report.new]
    wb01 = next(f for f in report.new if f.rule == "WB01")
    assert "only by the JAX package" in wb01.message


def test_port_runs_only_its_families():
    assert FAMILIES == ("W0", "W1", "W4", "W5", "W6", "W8", "W9", "WA",
                        "WB")
    assert set(port_runner.RULE_MODULES) == set(FAMILIES) - {"W0"}
    assert set(WAITING) == {"W2", "W3", "W7", "W803"}
    assert {r[:2] for r in RULES} == set(FAMILIES)
    assert "W803" not in RULES
