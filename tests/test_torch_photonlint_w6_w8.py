"""The port's W6 (collective safety) and W8 (precision discipline) held
against the JAX linter's, rule by rule.

- Pairs: each JAX W6 and W8 fixture translated line for line into torch
  (``lax.psum`` → ``collectives.psum``, ``jax.process_index()`` →
  ``dist.get_rank()``, ``jax.shard_map(f, mesh=...)`` →
  ``collectives.shard_map(f, devices, axis, ...)``, ``PartitionSpec`` →
  ``Placement``, ``astype`` → ``.to``, a jitted f64 constant → an f64
  tensor made on the card); the JAX linter's ``(rule, line, col)`` on the
  JAX snippet equals the port linter's on the torch snippet, new and
  suppressed. W601-W604, W801, W802 and W804 each have a positive, a
  negative and a suppressed pair.
- Canaries: the JAX rules' seeded violations on the JAX package, seeded
  into the port's counterparts on a copy of the port's tree (the score
  exchange's axis, the kernel's plain version's f32 upcast).
- Torch-only idioms: the gang's identity queries and host exchange
  (W602), the port's placement forms (W604), tensor-method reductions,
  scatter-adds, dtype tables and accumulator dtypes (W801), and f64 on a
  device tensor against f64 on a host copy (W802).
"""

import re
import shutil
from pathlib import Path

import pytest

from photon_ml_tpu.analysis import runner as jax_runner
from photon_ml_tpu_torch.analysis import runner as port_runner

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = "photon_ml_tpu_torch"


def _write(root, files):
    pkg = root / "pkg"
    for name, src in files.items():
        path = pkg / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)


def _rlc(report):
    return (sorted((f.rule, f.path, f.line, f.col) for f in report.new),
            sorted((f.rule, f.path, f.line, f.col)
                   for f in report.suppressed))


def _port_lint(tmp_path, files, families):
    _write(tmp_path, files)
    return port_runner.lint(tmp_path, paths=["pkg"], families=families)


# -- W6: the JAX fixtures, translated -----------------------------------------

MESH_MOD = ("""
import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
ENTITY_AXIS = "entity"

def make_mesh(devs):
    return Mesh(devs, (DATA_AXIS, ENTITY_AXIS))
""", """
import torch
from photon_ml_tpu_torch.parallel import mesh

DATA_AXIS = "data"
ENTITY_AXIS = "entity"

def make_mesh(devs):
    return mesh.make_mesh(num_entity=1, devices=devs)
""")

W601_POSITIVE = ("""
from jax import lax

def exchange(x):
    return lax.psum(x, "entty")     # W601: typo'd axis
""", """
from photon_ml_tpu_torch.parallel import collectives

def exchange(x):
    return collectives.psum(x, "entty")     # W601: typo'd axis
""")

W601_NEGATIVE = ("""
import jax
from jax import lax
from pkg.mesh import ENTITY_AXIS

def score(x, mesh):
    def impl(v):
        return lax.psum(v, ENTITY_AXIS)   # correct psum inside shard_map
    fn = jax.shard_map(impl, mesh=mesh, in_specs=(None,),
                       out_specs=None)
    return fn(x)

def gather(x, axis_name):
    return lax.all_gather(x, axis_name)   # unresolvable param: skipped
""", """
import torch
from photon_ml_tpu_torch.parallel import collectives
from pkg.mesh import ENTITY_AXIS

def score(x, devices):
    def impl(v):
        return collectives.psum(v, ENTITY_AXIS)   # inside the runner
    fn = collectives.shard_map(impl, devices, ENTITY_AXIS, in_specs=(None,),
                               out_specs=(None,))
    return fn(x)

def gather(x, axis_name):
    return collectives.all_gather(x, axis_name)   # a param: skipped
""")

W601_SUPPRESSED = ("""
from jax import lax

def exchange(x):
    # photonlint: allow-W601(fixture: axis is created by the test harness)
    return lax.psum(x, "harness_axis")
""", """
from photon_ml_tpu_torch.parallel import collectives

def exchange(x):
    # photonlint: allow-W601(fixture: axis is created by the test harness)
    return collectives.psum(x, "harness_axis")
""")

W602_POSITIVE = ("""
import jax
import jax.numpy as jnp
from jax import lax

def exchange(x):
    if jax.process_index() == 0:
        return lax.psum(x, "data")  # W602: only host 0 reaches it
    return x

def accept_gate(x):
    flag = jnp.sum(x)
    while flag > 0:                 # traced predicate
        x = lax.pmean(x, "data")    # W602: replicas may disagree
        flag = jnp.sum(x)
    return x
""", """
import torch
import torch.distributed as dist
from photon_ml_tpu_torch.parallel import collectives

def exchange(x):
    if dist.get_rank() == 0:
        return collectives.psum(x, "data")  # W602: only rank 0 reaches it
    return x

def accept_gate(x):
    flag = torch.sum(x)
    while flag > 0:                 # a per-shard device value
        x = collectives.psum(x, "data")    # W602: shards may disagree
        flag = torch.sum(x)
    return x
""")

W602_NEGATIVE = ("""
from jax import lax

def exchange(x, enabled):
    if enabled:                     # host-uniform config flag: fine
        return lax.psum(x, "data")
    return x

def always(x):
    return lax.pmean(x, "data")     # unconditional: fine
""", """
from photon_ml_tpu_torch.parallel import collectives

def exchange(x, enabled):
    if enabled:                     # host-uniform config flag: fine
        return collectives.psum(x, "data")
    return x

def always(x):
    return collectives.psum(x, "data")     # unconditional: fine
""")

W602_SUPPRESSED = ("""
import jax
from jax import lax

def exchange(x):
    if jax.process_index() == 0:
        # photonlint: allow-W602(fixture: a one-host mesh by construction)
        return lax.psum(x, "data")
    return x
""", """
import torch.distributed as dist
from photon_ml_tpu_torch.parallel import collectives

def exchange(x):
    if dist.get_rank() == 0:
        # photonlint: allow-W602(fixture: a one-host mesh by construction)
        return collectives.psum(x, "data")
    return x
""")

W603_POSITIVE = ("""
import jax

def run(x, mesh):
    def impl(a, b):
        return a + b
    fn = jax.shard_map(impl, mesh=mesh, in_specs=(None,),
                       out_specs=None)      # W603: 1 spec, 2 params
    return fn(x)

def run2(x, mesh):
    def impl2(a):
        return a, a
    fn = jax.shard_map(impl2, mesh=mesh, in_specs=(None,),
                       out_specs=(None, None, None))  # W603: 3 vs 2
    return fn(x)
""", """
from photon_ml_tpu_torch.parallel import collectives

def run(x, devices):
    def impl(a, b):
        return a + b
    fn = collectives.shard_map(impl, devices, "data", in_specs=(None,),
                               out_specs=(None,))   # W603: 1 spec, 2 params
    return fn(x)

def run2(x, devices):
    def impl2(a):
        return a, a
    fn = collectives.shard_map(impl2, devices, "data", in_specs=(None,),
                               out_specs=(None, None, None))  # W603: 3 vs 2
    return fn(x)
""")

W603_NEGATIVE = ("""
import jax

def run(x, y, mesh):
    def impl(a, b):
        return a + b, a - b
    fn = jax.shard_map(impl, mesh=mesh, in_specs=(None, None),
                       out_specs=(None, None))
    return fn(x, y)

def run_conditional(x, mesh, fast):
    # a callee name that is ALSO assigned is ambiguous: skipped
    if fast:
        local = _make_impl()
    else:
        def local(a):
            return a
    fn = jax.shard_map(local, mesh=mesh, in_specs=(None, None),
                       out_specs=None)
    return fn(x)

def _make_impl():
    def impl(a, b):
        return a
    return impl
""", """
from photon_ml_tpu_torch.parallel import collectives

def run(x, y, devices):
    def impl(a, b):
        return a + b, a - b
    fn = collectives.shard_map(impl, devices, "data", in_specs=(None, None),
                               out_specs=(None, None))
    return fn(x, y)

def run_conditional(x, devices, fast):
    # a callee name that is ALSO assigned is ambiguous: skipped
    if fast:
        local = _make_impl()
    else:
        def local(a):
            return a
    fn = collectives.shard_map(local, devices, "data",
                               in_specs=(None, None), out_specs=(None,))
    return fn(x)

def _make_impl():
    def impl(a, b):
        return a
    return impl
""")

W603_SUPPRESSED = ("""
import jax

def run(x, mesh):
    def impl(a, b):
        return a + b
    # photonlint: allow-W603(fixture: the second argument is closed over)
    fn = jax.shard_map(impl, mesh=mesh, in_specs=(None,),
                       out_specs=None)
    return fn(x)
""", """
from photon_ml_tpu_torch.parallel import collectives

def run(x, devices):
    def impl(a, b):
        return a + b
    # photonlint: allow-W603(fixture: the second argument is closed over)
    fn = collectives.shard_map(impl, devices, "data", in_specs=(None,),
                               out_specs=(None,))
    return fn(x)
""")

W604_POSITIVE = ("""
from jax.sharding import PartitionSpec as P

def specs():
    return P("bogus_axis")          # W604
""", """
from photon_ml_tpu_torch.parallel.mesh import Placement as P

def specs(mesh):
    return P(mesh, "bogus_axis")          # W604
""")

W604_NEGATIVE = ("""
from jax.sharding import PartitionSpec as P
from pkg.mesh import DATA_AXIS

def specs():
    return P(DATA_AXIS), P("entity"), P()
""", """
from photon_ml_tpu_torch.parallel.mesh import Placement as P
from pkg.mesh import DATA_AXIS

def specs(mesh):
    return P(mesh, DATA_AXIS), P(mesh, "entity"), mesh.shape[DATA_AXIS]
""")

W604_SUPPRESSED = ("""
from jax.sharding import PartitionSpec as P

def specs():
    # photonlint: allow-W604(fixture: a mesh built by the test harness)
    return P("bogus_axis")
""", """
from photon_ml_tpu_torch.parallel.mesh import Placement as P

def specs(mesh):
    # photonlint: allow-W604(fixture: a mesh built by the test harness)
    return P(mesh, "bogus_axis")
""")

# -- W8: the JAX fixtures, translated -----------------------------------------

W801_POSITIVE = ("""
import jax
import jax.numpy as jnp

def total_loss(per_example, a, b):
    acts = per_example.astype(jnp.bfloat16)
    total = jnp.sum(acts)                      # W801: bf16 sum, no acc
    lhs = a.astype(jnp.bfloat16)
    rhs = b.astype(jnp.bfloat16)
    prod = lhs @ rhs                           # W801: bf16 matmul
    return total, prod
""", """
import torch
import torch.nn.functional as F

def total_loss(per_example, a, b):
    acts = per_example.to(torch.bfloat16)
    total = torch.sum(acts)                    # W801: bf16 sum, no acc
    lhs = a.to(torch.bfloat16)
    rhs = b.to(torch.bfloat16)
    prod = lhs @ rhs                           # W801: bf16 matmul
    return total, prod
""")

W801_NEGATIVE = ("""
import jax
import jax.numpy as jnp

def total_loss(per_example, a, b):
    acts = per_example.astype(jnp.bfloat16)
    total = jnp.sum(acts, dtype=jnp.float32)       # explicit accumulator
    upcast = jnp.sum(acts.astype(jnp.float32))     # upcast clears taint
    lhs = a.astype(jnp.bfloat16)
    rhs = b.astype(jnp.bfloat16)
    prod = jax.lax.dot_general(
        lhs, rhs, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)        # f32 accumulation
    kept = jnp.sum(per_example)                    # unknown dtype: clean
    return total, upcast, prod, kept
""", """
import torch
import torch.nn.functional as F

def total_loss(per_example, a, b):
    acts = per_example.to(torch.bfloat16)
    total = torch.sum(acts, dtype=torch.float32)   # explicit accumulator
    upcast = torch.sum(acts.float())               # upcast clears taint
    lhs = a.to(torch.bfloat16)
    rhs = b.to(torch.bfloat16)
    prod = torch.matmul(
        lhs.float(),
        rhs.float())                               # f32 accumulation
    kept = torch.sum(per_example)                  # unknown dtype: clean
    return total, upcast, prod, kept
""")

W801_SUPPRESSED = ("""
import jax.numpy as jnp

def total_loss(per_example):
    acts = per_example.astype(jnp.bfloat16)
    # photonlint: allow-W801(fixture: bf16 partial sum re-reduced in f32)
    return jnp.sum(acts)
""", """
import torch

def total_loss(per_example):
    acts = per_example.to(torch.bfloat16)
    # photonlint: allow-W801(fixture: bf16 partial sum re-reduced in f32)
    return torch.sum(acts)
""")

W802_POSITIVE = ("""
import jax
import jax.numpy as jnp

@jax.jit
def kernel(x):
    scale = jnp.asarray(1.0, dtype=jnp.float64)    # W802: f64 under jit
    return x * scale
""", """
import torch
from torch import Tensor

# x is a device tensor
def kernel(x: Tensor):
    scale = torch.as_tensor(1.0, dtype=torch.float64, device=x.device)
    return x * scale
""")

W802_NEGATIVE = ("""
import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

@jax.jit
def kernel(x):
    scale = jnp.asarray(1.0, dtype=jnp.float64)    # guarded: x64 enabled
    return x * scale

def host_accumulate(xs):
    return jnp.asarray(xs, dtype=jnp.float32)
""", """
import torch
from torch import Tensor

torch.set_default_dtype(torch.float32)

# x is a device tensor
def kernel(x: Tensor):
    scale = torch.as_tensor(1.0, dtype=torch.float64)  # on the host: clean
    return x * scale.to(x.device, torch.float32)

def host_accumulate(xs):
    return torch.as_tensor(xs, dtype=torch.float32)
""")

W802_SUPPRESSED = ("""
import jax
import jax.numpy as jnp

@jax.jit
def kernel(x):
    # photonlint: allow-W802(fixture: caller asserts x64 mode at startup)
    scale = jnp.asarray(1.0, dtype=jnp.float64)
    return x * scale
""", """
import torch
from torch import Tensor

# x is a device tensor
def kernel(x: Tensor):
    # photonlint: allow-W802(fixture: f64 on the card is deliberate here)
    scale = torch.as_tensor(1.0, dtype=torch.float64, device=x.device)
    return x * scale
""")

W804_POSITIVE = ("""
import jax.numpy as jnp

def loss_fn(preds, targets):
    p16 = preds.astype(jnp.bfloat16)
    t32 = targets.astype(jnp.float32)
    return p16 - t32               # W804: implicit promotion in loss path
""", """
import torch

def loss_fn(preds, targets):
    p16 = preds.to(torch.bfloat16)
    t32 = targets.to(torch.float32)
    return p16 - t32               # W804: implicit promotion in loss path
""")

W804_NEGATIVE = ("""
import jax.numpy as jnp

def loss_fn(preds, targets):
    p = preds.astype(jnp.float32)  # explicit cast: the decision is visible
    t = targets.astype(jnp.float32)
    return p - t

def combine(a, b):
    lo = a.astype(jnp.bfloat16)
    hi = b.astype(jnp.float32)
    return lo * hi                 # not a loss/grad path: quiet
""", """
import torch

def loss_fn(preds, targets):
    p = preds.to(torch.float32)    # explicit cast: the decision is visible
    t = targets.to(torch.float32)
    return p - t

def combine(a, b):
    lo = a.to(torch.bfloat16)
    hi = b.to(torch.float32)
    return lo * hi                 # not a loss/grad path: quiet
""")

W804_SUPPRESSED = ("""
import jax.numpy as jnp

def loss_fn(preds, targets):
    p16 = preds.astype(jnp.bfloat16)
    t32 = targets.astype(jnp.float32)
    # photonlint: allow-W804(fixture: promotion to f32 is the intent)
    return p16 - t32
""", """
import torch

def loss_fn(preds, targets):
    p16 = preds.to(torch.bfloat16)
    t32 = targets.to(torch.float32)
    # photonlint: allow-W804(fixture: promotion to f32 is the intent)
    return p16 - t32
""")

# (id, {file: (jax source, torch source)}, family, new rules, suppressed)
PAIRS = [
    ("w601-positive", {"mod.py": W601_POSITIVE}, "W6", ["W601"], []),
    ("w601-negative", {"mod.py": W601_NEGATIVE}, "W6", [], []),
    ("w601-suppressed", {"mod.py": W601_SUPPRESSED}, "W6", [], ["W601"]),
    ("w602-positive", {"mod.py": W602_POSITIVE}, "W6", ["W602", "W602"],
     []),
    ("w602-negative", {"mod.py": W602_NEGATIVE}, "W6", [], []),
    ("w602-suppressed", {"mod.py": W602_SUPPRESSED}, "W6", [], ["W602"]),
    ("w603-positive", {"mod.py": W603_POSITIVE}, "W6", ["W603", "W603"],
     []),
    ("w603-negative", {"mod.py": W603_NEGATIVE}, "W6", [], []),
    ("w603-suppressed", {"mod.py": W603_SUPPRESSED}, "W6", [], ["W603"]),
    ("w604-positive", {"mod.py": W604_POSITIVE}, "W6", ["W604"], []),
    ("w604-negative", {"mod.py": W604_NEGATIVE}, "W6", [], []),
    ("w604-suppressed", {"mod.py": W604_SUPPRESSED}, "W6", [], ["W604"]),
    ("w801-positive", {"mod.py": W801_POSITIVE}, "W8", ["W801", "W801"],
     []),
    ("w801-negative", {"mod.py": W801_NEGATIVE}, "W8", [], []),
    ("w801-suppressed", {"mod.py": W801_SUPPRESSED}, "W8", [], ["W801"]),
    ("w802-positive", {"mod.py": W802_POSITIVE}, "W8", ["W802"], []),
    ("w802-negative", {"mod.py": W802_NEGATIVE}, "W8", [], []),
    ("w802-suppressed", {"mod.py": W802_SUPPRESSED}, "W8", [], ["W802"]),
    ("w804-positive", {"mod.py": W804_POSITIVE}, "W8", ["W804"], []),
    ("w804-negative", {"mod.py": W804_NEGATIVE}, "W8", [], []),
    ("w804-suppressed", {"mod.py": W804_SUPPRESSED}, "W8", [], ["W804"]),
]


def test_pairs_cover_every_w6_w8_rule_three_ways():
    kinds = {(pid.split("-")[0].upper(), pid.split("-", 1)[1])
             for pid, *_ in PAIRS}
    rules = ("W601", "W602", "W603", "W604", "W801", "W802", "W804")
    assert kinds == {(r, k) for r in rules
                     for k in ("positive", "negative", "suppressed")}


@pytest.mark.parametrize("pair,family,expected,suppressed",
                         [p[1:] for p in PAIRS], ids=[p[0] for p in PAIRS])
def test_torch_form_matches_the_jax_rules(tmp_path, pair, family, expected,
                                          suppressed):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    files = dict(pair)
    if family == "W6":
        files["mesh.py"] = MESH_MOD
    _write(jax_root, {n: src[0] for n, src in files.items()})
    _write(port_root, {n: src[1] for n, src in files.items()})
    jax_report = jax_runner.lint(jax_root, paths=["pkg"],
                                 families={family})
    port_report = port_runner.lint(port_root, paths=["pkg"],
                                   families={family})
    assert _rlc(port_report) == _rlc(jax_report)
    assert sorted(f.rule for f in port_report.new) == expected, \
        [f.format() for f in port_report.new]
    assert sorted(f.rule for f in port_report.suppressed) == suppressed


def test_w601_names_the_offender_and_the_candidates(tmp_path):
    report = _port_lint(tmp_path, {"mesh.py": MESH_MOD[1],
                                   "mod.py": W601_POSITIVE[1]}, {"W6"})
    msg = report.new[0].message
    assert "'entty'" in msg
    assert "'data'" in msg and "'entity'" in msg


def test_w602_names_why_the_branch_diverges(tmp_path):
    report = _port_lint(tmp_path, {"mesh.py": MESH_MOD[1],
                                   "mod.py": W602_POSITIVE[1]}, {"W6"})
    messages = [f.message for f in report.new]
    assert any("dist.get_rank()" in m for m in messages)
    assert any("a device tensor (a per-shard value)" in m for m in messages)


# -- canaries: the JAX rules' seeded violations, on the port's counterparts --

def _port_copy(tmp_path) -> Path:
    shutil.copytree(REPO_ROOT / PORT, tmp_path / PORT,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    return tmp_path / PORT


def _seed(path: Path, old: str, new: str) -> None:
    src = path.read_text()
    assert src.count(old) == 1, f"{path.name} lost {old!r}"
    path.write_text(src.replace(old, new))


def test_w601_seeded_axis_typo_in_the_score_exchange(tmp_path):
    """The JAX rule's acceptance scenario on the port: the score
    exchange's ``qpsum`` over a typo'd axis names the offender and the
    candidates."""
    pkg = _port_copy(tmp_path)
    target = pkg / "game" / "random_effect.py"
    _seed(target, "num_samples),\n                     ENTITY_AXIS,",
          'num_samples),\n                     "entty",')
    report = port_runner.lint(tmp_path, families={"W6"})
    assert [(f.rule, f.path) for f in report.new] == [
        ("W601", f"{PORT}/game/random_effect.py")]
    msg = report.new[0].message
    assert "'entty'" in msg and "'data'" in msg and "'entity'" in msg


def test_w801_seeded_upcast_deletion_in_the_kernels_plain_version(tmp_path):
    """The JAX rule's canary on the port: the kernel's plain version
    (``ops/pallas_kernels.py``) upcasts a bf16 ``X`` to f32 before its two
    products; keeping ``X``'s own dtype instead fires W801 on both."""
    pkg = _port_copy(tmp_path)
    target = pkg / "ops" / "pallas_kernels.py"
    _seed(target, "X.to(torch.promote_types(X.dtype, torch.float32))",
          "X.to(X.dtype)")
    report = port_runner.lint(tmp_path, families={"W8"})
    w801 = [f for f in report.new
            if f.path == f"{PORT}/ops/pallas_kernels.py"]
    lines = target.read_text().splitlines()
    assert [f.rule for f in report.new] == ["W801", "W801"], \
        [f.format() for f in report.new]
    assert ["@" in lines[f.line - 1] for f in w801] == [True, True]


# -- torch-only idioms ---------------------------------------------------------

TORCH_W6 = """
import torch
import torch.distributed as dist
from typing import Optional
from photon_ml_tpu_torch.parallel import collectives
from photon_ml_tpu_torch.parallel.collectives import ProcessSpan
from photon_ml_tpu_torch.parallel.multihost import allgather_ragged
from photon_ml_tpu_torch.parallel.quantized_collectives import qpsum

DATA_AXIS = "data"


def rank_zero_sum(x):
    if dist.get_rank() == 0:
        x = qpsum(x, DATA_AXIS, mode="int8")                 # W602
    return x


def span_gather(t, span: Optional[ProcessSpan]):
    if span.rank == 0:
        return span.all_gather(t)                            # W602
    return [t]


def shard_zero_only(x):
    if collectives.axis_index(DATA_AXIS) == 0:
        dist.all_reduce(x)                                   # W602
    while collectives.bound_index(DATA_AXIS) is not None:
        allgather_ragged(x)                                  # W602
        break
    return x


def per_shard_flag(x: torch.Tensor):
    if (x > 0).any():
        return collectives.all_gather(x, DATA_AXIS)          # W602
    return x


def payload_then_gather(process_id, snap):
    payload = b""
    if process_id == 0:              # built on one process ...
        payload = bytes(snap)
    return allgather_ragged(payload)  # ... gathered by every one: clean


def gang_stop(stop):
    if stop is None:                 # every member agrees: clean
        return None
    return allgather_ragged(stop.flags())


def quantized_typo(x):
    return qpsum(x, "dta")                                   # W601
"""


def test_torch_only_collective_idioms(tmp_path):
    report = _port_lint(tmp_path, {"mod.py": TORCH_W6}, {"W6"})
    want = [(i, line.rsplit("# ", 1)[-1])
            for i, line in enumerate(TORCH_W6.splitlines(), start=1)
            if re.search(r"# W60[1-4]$", line)]
    assert len(want) == 6
    assert [(f.line, f.rule) for f in report.new] == want, \
        [f.format() for f in report.new]


TORCH_W604 = """
from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS


def axes(mesh):
    devs = mesh.axis_devices("entity")               # clean
    bad = mesh.axis_devices("entty")                 # W604
    k = mesh.shape["dta"]                            # W604
    lk = mesh.local_shape[ENTITY_AXIS]               # clean
    return devs, bad, k, lk, mesh.devices.shape[0]   # an int index: clean
"""


def test_torch_only_placement_idioms(tmp_path):
    _write(tmp_path, {"mod.py": TORCH_W604})
    (tmp_path / "pkg" / "mesh.py").write_text(MESH_MOD[1])
    report = port_runner.lint(tmp_path, paths=["pkg"], families={"W6"})
    assert [(f.rule, f.path, f.line) for f in report.new] == [
        ("W604", "pkg/mod.py", 7), ("W604", "pkg/mod.py", 8)], \
        [f.format() for f in report.new]


TORCH_W8 = """
import torch
from torch import Tensor
from photon_ml_tpu_torch.parallel.quantized_collectives import qpsum


def acc_dtype_for(dtype):
    return torch.promote_types(dtype, torch.float32)


class Batch:
    def __init__(self, X: Tensor):
        self.X = X

    @property
    def acc_dtype(self):
        return acc_dtype_for(self.X.dtype)

    def margins(self, w: Tensor):
        wa = w.to(self.acc_dtype)
        return (self.X * wa).sum(-1)                  # f32 by promotion


def reductions(x: Tensor, idx: Tensor, src: Tensor, precision: str):
    xb = x.to(torch.bfloat16)
    a = xb.sum(-1)                                    # W801
    b = xb.sum(-1, dtype=torch.float32)               # clean: accumulator
    c = xb.float().mean()                             # clean: upcast
    out = torch.zeros(8, device=x.device)
    out.index_add_(0, idx, src.half())                # W801
    q = qpsum(xb, "data")                             # W801
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    xs = x.to(dtype=dt)
    d = torch.einsum("nd,d->n", xs, x)                # W801
    e = torch.einsum("nd,d->n", xs.to(acc_dtype_for(xs.dtype)), x)  # clean
    same = x.to(x.dtype)
    f = same @ x                                      # W801
    return a, b, c, out, q, d, e, f


def f64_on_the_card(x: Tensor):
    a = x.double()                                    # W802
    b = x.cpu().double()                              # clean: host copy
    c = x.to(torch.float64)                           # W802
    d = x.sum(dtype=torch.float64)                    # W802
    e = torch.zeros(3, dtype=torch.float64, device=x.device)   # W802
    f = torch.zeros(3, dtype=torch.float64)           # clean: on the CPU
    g = x.detach().cpu().to(torch.float64)            # clean: host copy
    return a, b, c, d, e, f, g
"""


def test_torch_only_precision_idioms(tmp_path):
    report = _port_lint(tmp_path, {"mod.py": TORCH_W8}, {"W8"})
    want = [(i, line.rsplit("# ", 1)[-1])
            for i, line in enumerate(TORCH_W8.splitlines(), start=1)
            if re.search(r"# W80[1-4]$", line)]
    assert len(want) == 9
    assert [(f.line, f.rule) for f in report.new] == want, \
        [f.format() for f in report.new]


def test_the_ports_axis_universe():
    from photon_ml_tpu_torch.analysis.package import ModuleInfo, build_index

    files = sorted(p for p in (REPO_ROOT / PORT).rglob("*.py")
                   if "__pycache__" not in p.parts and "_build" not in p.parts)
    index = build_index([ModuleInfo.load(p, REPO_ROOT) for p in files])
    # the mesh's two axes and multichip_check's literal run_shards axis
    assert index.mesh_axes == {"data", "entity", "mf"}


def test_a_module_alias_of_tensor_annotates_a_device_tensor(tmp_path):
    """``Tensor = torch.Tensor`` (the port's modules write it) makes a
    parameter annotated ``Tensor`` a device tensor for every family that
    reads the dataflow, in its module and where the alias is imported."""
    files = {
        "types.py": "import torch\n\nTensor = torch.Tensor\n",
        "local.py": (
            "import torch\n\nTensor = torch.Tensor\n\n\n"
            "def metric(scores: Tensor):\n"
            "    return scores.to(torch.float64)\n"),
        "imported.py": (
            "from pkg.types import Tensor\n\n\n"
            "def value(v: Tensor) -> float:\n"
            "    return float(v)\n"),
    }
    report = _port_lint(tmp_path, files, {"W1", "W8"})
    assert [(f.rule, f.path, f.line) for f in report.new] == [
        ("W101", "pkg/imported.py", 5), ("W802", "pkg/local.py", 7)], \
        [f.format() for f in report.new]
