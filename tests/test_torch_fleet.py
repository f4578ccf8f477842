"""The port's scorer fleet held against the JAX package's, on the CPU.

- ``entity_shard`` / ``entity_of_row`` of ``photon_ml_tpu_torch/serve/fleet``
  against the JAX package's over 10,000 ids (str and int), plus
  ``tests/test_fleet.py``'s pinned values;
- the JAX package's own fleet scenarios (``tests/test_fleet.py``: the
  health machine, degraded mode, the route chain, reply handling, pool
  repair, the live-identity advance, the typed-error round trip), each a
  case of one parametrised test, run with the port's ``Fleet``,
  ``HealthPolicy``, wire helpers and metrics registry in place of the JAX
  package's;
- one shared fixture of members and routers: two port services and one
  single port service in process (``--device cpu`` scorers), two JAX
  services as subprocesses, and four routers in process (the port's and
  the JAX package's, each over the port's members and over the JAX
  package's). The port's router over two port members answers with the
  single service's scores bit for bit; every router over either
  package's members sends the bytes the JAX router sends over the JAX
  package's members; a swap is refused typed;
  a dead member fails over; the route ledger accounts for every dispatch;
  and ``python -m photon_ml_tpu_torch.tools.photon_serve fleet`` runs the
  router as a process that exits 75 on SIGTERM.
"""

from __future__ import annotations

import inspect
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import test_fleet as jtf
from photon_ml_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from photon_ml_tpu.serve import fleet as jfleet
from photon_ml_tpu.serve import router as jrouter
from photon_ml_tpu_torch.obs.metrics import MetricsRegistry
from photon_ml_tpu_torch.serve import fleet as tfleet
from photon_ml_tpu_torch.serve import protocol as tproto
from photon_ml_tpu_torch.serve import router as trouter
from photon_ml_tpu_torch.serve.batcher import MicroBatcher
from photon_ml_tpu_torch.serve.protocol import ServeClient
from photon_ml_tpu_torch.serve.scoring import (
    ServingScorer,
    load_scoring_model,
    materialize_model,
)
from photon_ml_tpu_torch.serve.service import ServeService
from test_serve import (
    SECTIONS,
    _build_model_dir,
    _make_records,
    _serve_args,
    _spawn_serve,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREEMPTED_EXIT = 75


# ---------------------------------------------------------------------------
# the shard function
# ---------------------------------------------------------------------------


def test_entity_shard_equals_the_jax_packages_over_10000_ids():
    str_ids = [f"user{u}" for u in range(5000)]
    int_ids = list(range(5000))
    for k in (1, 2, 3, 4, 7, 16):
        for ids in (str_ids, int_ids):
            assert [tfleet.entity_shard(e, k) for e in ids] == \
                [jfleet.entity_shard(e, k) for e in ids]
    # tests/test_fleet.py's pins
    assert [tfleet.entity_shard(f"user{u}", 2) for u in range(6)] \
        == [0, 1, 0, 1, 1, 1]
    assert tfleet.entity_shard(123, 4) == tfleet.entity_shard("123", 4)


@pytest.mark.parametrize("row,key", [
    ({"uid": "u", "memberId": "top",
      "metadataMap": {"memberId": "m7", "userId": "u3"}}, "memberId"),
    ({"memberId": "top"}, "memberId"),
    ({"uid": "x", "metadataMap": {}}, "memberId"),
    ({"metadataMap": {"z": "last", "a": "first"}}, None),
    ({"uid": "row9"}, None),
    ({}, None),
    ({"uid": 17, "metadataMap": {"userId": 5}}, "userId")])
def test_entity_of_row_equals_the_jax_packages(row, key):
    assert tfleet.entity_of_row(row, key) == jfleet.entity_of_row(row, key)


# ---------------------------------------------------------------------------
# the JAX package's scenarios against the port's Fleet
# ---------------------------------------------------------------------------

#: the names ``tests/test_fleet.py`` reads from its module globals, bound
#: to the port's objects for these cases
PORT_NAMES = {
    "Fleet": tfleet.Fleet, "FleetAdmissionError": tfleet.FleetAdmissionError,
    "HealthPolicy": tfleet.HealthPolicy,
    "MemberReplyError": tfleet.MemberReplyError,
    "entity_of_row": tfleet.entity_of_row,
    "entity_shard": tfleet.entity_shard,
    "reply_exception": tfleet.reply_exception,
    "MetricsRegistry": MetricsRegistry,
    "ModelSwapRefusedError": tproto.ModelSwapRefusedError,
    "ServeClient": tproto.ServeClient,
    "ServeRequestError": tproto.ServeRequestError,
    "ShardUnavailableError": tproto.ShardUnavailableError,
    "ShedError": tproto.ShedError, "encode": tproto.encode,
    "hello": tproto.hello, "typed_error": tproto.typed_error,
    "wire_error": tproto.wire_error}
SCENARIO_CLASSES = (jtf.TestHealthMachine, jtf.TestDegradedMode,
                    jtf.TestRouteChain, jtf.TestReplyException,
                    jtf.TestDispatchReplyHandling, jtf.TestPoolRepair,
                    jtf.TestLiveIdentityAdvance, jtf.TestWireErrorRoundTrip)
SCENARIOS = [(cls, name) for cls in SCENARIO_CLASSES
             for name in sorted(vars(cls)) if name.startswith("test_")]


@pytest.mark.parametrize("cls,name", SCENARIOS,
                         ids=[f"{c.__name__}.{n}" for c, n in SCENARIOS])
def test_jax_fleet_scenario_runs_on_the_ports_fleet(cls, name, monkeypatch,
                                                    tmp_path):
    for attr, value in PORT_NAMES.items():
        monkeypatch.setattr(jtf, attr, value)
    method = getattr(cls(), name)
    if "fake_fleet" not in inspect.signature(method).parameters:
        method()
        return
    # tests/test_fleet.py's fake_fleet fixture, on the port's Fleet
    fakes = [jtf._FakeMember(str(tmp_path / f"fm{k}.sock"))
             for k in range(2)]
    f = tfleet.Fleet([fk.endpoint for fk in fakes],
                     registry=MetricsRegistry(), member_timeout=5.0,
                     connections_per_member=1)
    try:
        f.admit_all()
        assert isinstance(f, tfleet.Fleet)
        method(fake_fleet=(f, fakes))
    finally:
        f.close()
        for fk in fakes:
            fk.close()


# ---------------------------------------------------------------------------
# members and routers
# ---------------------------------------------------------------------------


class _Stop:
    reason = None

    def should_stop(self):
        return self.reason


def _port_member(model_dir: str, sock: str):
    """A port scoring service in process, on the CPU, with a registry of
    its own; returns (endpoint, stop)."""
    reg = MetricsRegistry()
    model, maps = load_scoring_model(model_dir, None)
    scorer = ServingScorer(materialize_model(model), SECTIONS, maps,
                           id_types=["userId"], registry=reg, device="cpu",
                           max_batch_rows=64)
    service = ServeService(scorer, MicroBatcher(8192, 64, registry=reg),
                           "unix:" + sock, model_id="game-model",
                           registry=reg, trace_sample_rate=0.0)
    service.start()
    stop = _Stop()
    loop = threading.Thread(target=service.serve_loop, args=(stop,),
                            daemon=True)
    loop.start()

    def close():
        stop.reason = "test done"
        loop.join(timeout=30)
        service.shutdown()

    return service.endpoint, close


def _router(package, endpoints, sock: str, registry):
    """``package``'s FleetRouter in process over ``endpoints``; returns
    (endpoint, fleet, close)."""
    fleet = package.fleet.Fleet(
        endpoints, health=package.fleet.HealthPolicy(
            suspect_after=1, dead_after=2, heartbeat_seconds=0.05),
        registry=registry, route_key="userId", member_timeout=15.0,
        connections_per_member=2)
    fleet.admit_all()
    router = package.router.FleetRouter(fleet, "unix:" + sock,
                                        registry=registry,
                                        trace_sample_rate=0.0)
    router.start()
    stop = _Stop()
    loop = threading.Thread(target=router.health_loop, args=(stop,),
                            daemon=True)
    loop.start()

    def close():
        stop.reason = "test done"
        loop.join(timeout=30)
        router.shutdown()

    return router.endpoint, fleet, close


class _Pkg:
    def __init__(self, fleet, router):
        self.fleet, self.router = fleet, router


JAX_PKG, PORT_PKG = _Pkg(jfleet, jrouter), _Pkg(tfleet, trouter)


def _raw_reply(endpoint: str, msg: dict) -> bytes:
    """One request's reply line as the bytes on the wire."""
    scheme, addr = tproto.parse_serve_endpoint(endpoint)
    sock = socket.socket(socket.AF_UNIX if scheme == "unix"
                         else socket.AF_INET, socket.SOCK_STREAM)
    sock.settimeout(60)
    sock.connect(addr)
    with sock, sock.makefile("rb") as fh:
        fh.readline()  # hello
        sock.sendall(tproto.encode(msg))
        return fh.readline()


@pytest.fixture(scope="module")
def fleet_rig(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tfleet"))
    model_dir = _build_model_dir(root)
    records = _make_records(n=48)
    closers, procs = [], []
    try:
        # the JAX members first: their interpreters start while the
        # port's members load in this one
        spawned = [None, None]

        def spawn(k):
            spawned[k] = _spawn_serve(_serve_args(
                model_dir, f"unix:{root}/j{k}.sock", f"{root}/j{k}-trace",
                extra=("--model-id", "game-model",
                       "--trace-sample-rate", "0")))

        threads = [threading.Thread(target=spawn, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        port_eps = []
        for k in range(2):
            ep, close = _port_member(model_dir, f"{root}/t{k}.sock")
            port_eps.append(ep)
            closers.append(close)
        single, close = _port_member(model_dir, f"{root}/single.sock")
        closers.append(close)
        for t in threads:
            t.join()
        procs = [p for p, _ in spawned]
        jax_eps = [ep for _, ep in spawned]
        routers = {}
        for rname, pkg, reg in (("port", PORT_PKG, MetricsRegistry),
                                ("jax", JAX_PKG, JaxRegistry)):
            for mname, eps in (("port", port_eps), ("jax", jax_eps)):
                ep, fleet, close = _router(
                    pkg, eps, f"{root}/r-{rname}-{mname}.sock", reg())
                routers[(rname, mname)] = (ep, fleet)
                closers.append(close)
        yield {"root": root, "model_dir": model_dir, "records": records,
               "single": single, "routers": routers,
               "port_members": port_eps, "jax_members": jax_eps}
    finally:
        for close in reversed(closers):
            close()
        for p in procs:
            p.kill()
            p.wait(timeout=30)


def _score(endpoint, records) -> dict:
    with ServeClient(endpoint, timeout=60) as c:
        return c.score(records)


def test_port_router_over_two_members_equals_one_service(fleet_rig):
    records = fleet_rig["records"]
    ref = _score(fleet_rig["single"], records)
    ep, fleet = fleet_rig["routers"][("port", "port")]
    got = _score(ep, records)
    assert got["kind"] == "scores" and ref["kind"] == "scores"
    # the rows straddle both shards, and come back in row order
    shards = {fleet.shard_of_row(r) for r in records}
    assert shards == {0, 1}
    assert got["uids"] == [r["uid"] for r in records]
    assert np.array_equal(np.asarray(got["scores"], np.float64),
                          np.asarray(ref["scores"], np.float64))
    route = fleet._registry.counter("serve_route").by_label("outcome")
    assert route.get("ok", 0) >= 2


@pytest.mark.parametrize("router,members", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_reply_bytes_equal_the_jax_router_over_jax_members(fleet_rig, router,
                                                           members):
    """The JAX router over JAX members is the reference: the port's router
    over either package's members, and the JAX router over the port's,
    send the same reply bytes for the same requests."""
    records = fleet_rig["records"]
    requests = [{"kind": "score", "id": f"r{i}", "rows": records[lo:lo + n]}
                for i, (lo, n) in enumerate(((0, 48), (5, 1), (10, 17)))]
    want = [_raw_reply(fleet_rig["routers"][("jax", "jax")][0], m)
            for m in requests]
    got = [_raw_reply(fleet_rig["routers"][(router, members)][0], m)
           for m in requests]
    assert all(json.loads(b)["kind"] == "scores" for b in want)
    assert got == want


@pytest.mark.parametrize("router", ["port", "jax"])
def test_swap_is_refused_typed_by_either_router(fleet_rig, router):
    ep, _ = fleet_rig["routers"][(router, "port")]
    with ServeClient(ep) as c:
        refusal = c.swap(fleet_rig["model_dir"])
    assert isinstance(tproto.typed_error(refusal),
                      tproto.ModelSwapRefusedError)


def test_a_dead_member_fails_over_and_the_ledger_accounts(fleet_rig,
                                                          tmp_path):
    """A third port member behind its own port router dies: its shard's
    rows go to the fallback member, every request is answered, and the
    ``serve_route`` ledger accounts for every dispatch."""
    model_dir, records = fleet_rig["model_dir"], fleet_rig["records"]
    ref = _score(fleet_rig["single"], records)
    ep0, close0 = _port_member(model_dir, str(tmp_path / "a.sock"))
    ep1, close1 = _port_member(model_dir, str(tmp_path / "b.sock"))
    reg = MetricsRegistry()
    rep, fleet, close_r = _router(PORT_PKG, [ep0, ep1],
                                  str(tmp_path / "r.sock"), reg)
    try:
        assert _score(rep, records)["scores"] == ref["scores"]
        close1()  # member 1 goes away
        deadline = time.monotonic() + 30
        answered = 0
        while time.monotonic() < deadline:
            resp = _score(rep, records)
            answered += 1
            assert resp.get("kind") == "scores" or resp.get("error"), resp
            if fleet.members[1].state == "dead" \
                    and resp.get("kind") == "scores":
                break
        assert fleet.members[1].state == "dead"
        assert resp["scores"] == ref["scores"]
        route = reg.counter("serve_route").by_label("outcome")
        assert route.get("failover", 0) >= 1
        dispatched = sum(route.get(k, 0) for k in ("ok", "error", "shed"))
        assert dispatched >= 1 + answered
    finally:
        close_r()
        close0()


def test_fleet_verb_runs_the_router_and_exits_75(fleet_rig, tmp_path):
    """``photon_serve fleet`` (no ``--device``: the router touches none)
    over the port's members, with ``--trace-dir``: the ready line, scores
    equal to the single service's, a trace directory whose ``run_end`` is
    ``preempted``, and exit 75 on SIGTERM."""
    trace_dir = tmp_path / "trace"
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.tools.photon_serve",
         "fleet", "--listen", f"unix:{tmp_path}/fv.sock", "--members",
         ",".join(fleet_rig["port_members"]), "--route-id", "userId",
         "--heartbeat-seconds", "0.1", "--trace-dir", str(trace_dir),
         "--trace-heartbeat-seconds", "0.2"],
        cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("PHOTON_SERVE ready endpoint="), \
            proc.stderr.read()
        ep = line.split("endpoint=", 1)[1]
        records = fleet_rig["records"]
        assert _score(ep, records)["scores"] == \
            _score(fleet_rig["single"], records)["scores"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == PREEMPTED_EXIT
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [json.loads(ln) for ln in
             (trace_dir / "metrics.jsonl").read_text().splitlines()]
    assert lines[-1]["kind"] == "run_end"
    assert lines[-1]["status"] == "preempted"
    names = {json.loads(ln)["name"] for ln in
             (trace_dir / "spans.jsonl").read_text().splitlines()}
    assert "serve.generation" in names
    manifest = json.loads((trace_dir / "run_manifest.json").read_text())
    assert manifest["device_name"] is None  # the router has no device
