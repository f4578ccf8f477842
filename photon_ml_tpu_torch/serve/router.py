"""The fleet router: one proto-1 endpoint in front of N scorer members.

Port of ``photon_ml_tpu/serve/router.py``: ``FleetRouter`` (``:84``),
``parse_args`` (``:456``) and ``main`` (``:513``) with the same flags,
unchanged but for their imports. Host-only, as in the JAX package: it
takes no ``--device`` and touches none (it imports no torch); the members
it fronts are scoring services, the port's or the JAX package's.

Clients speak the exact ``serve/protocol.py`` NDJSON grammar they
speak to a single service — hello on connect, ``score``/``ping``/
``stats`` — and the router partitions each request's rows by entity
shard (``serve/fleet.py``: the keyed-hash analogue of the entity-sharded
training split), scatters one sub-request per owning member in
parallel over that member's back-end connection pool, and reassembles
the replies in row order. ``swap`` is refused typed: a fleet hot-swap is an operator
action against each member (``photon-serve swap``), not something to
half-apply through a proxy.

The robustness contract is the point:

- **No black holes.** Every routed sub-request resolves in the
  ``serve_route{outcome}`` ledger: ``ok``, retried-then-``ok``,
  ``failover`` to the shard's fallback member, typed ``shed``
  (``ShardUnavailableError`` when a shard is dark), or typed
  ``error``. A member death mid-request surfaces as an OSError to the
  dispatching thread (the health machine kicks the dead member's
  socket), so in-flight work re-routes or sheds — it never hangs.
- **Health-checked routing.** The main thread runs the heartbeat loop
  (``Fleet.heartbeat_tick``): stats-probe live members (liveness plus
  their current model identity — a member-by-member hot-swap advances
  the fleet's live identity once every live member reports the new
  model), mark healthy → suspect → dead on deterministic
  consecutive-failure thresholds, and probe dead members for
  re-admission — which requires a fresh verified hello whose model
  identity matches the fleet's live one (the generation check), so a
  member relaunched by its supervisor mid-hot-swap
  cannot split the fleet. Only transport failures feed the health
  machine: an application error reply (typed shed, bad-row error) is
  forwarded to the client typed, with no retry and no health penalty.

Thread layout mirrors ``serve/service.py``: an accept thread, one
reader thread per client connection (each scatters its own requests
across short-lived per-shard threads, drawing from the per-member
connection pools), and the main thread as the health loop. SLO gauges (``serve_qps``/``serve_p50_ms``/
``serve_p99_ms``) ride heartbeat totals so ``photon_status`` reads the
router like any serving process. Exit discipline is the service's:
SIGTERM drains in-flight dispatches briefly and exits 75;
``--max-serve-seconds``/``--stop-file`` drain and exit 0. On
readiness (listener bound + every reachable member admitted) the
process prints ``PHOTON_SERVE ready endpoint=<endpoint>``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
from typing import Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.serve.fleet import Fleet, HealthPolicy
from photon_ml_tpu_torch.serve.protocol import (
    SERVE_PROTO,
    encode,
    error_response,
    hello,
    parse_serve_endpoint,
    scores_response,
    wire_error,
)
from photon_ml_tpu_torch.serve.reqtrace import (
    HeadSampler,
    TraceIdMinter,
    child_span_id,
    observe_stage,
)

#: Same SLO windows as the single-process service.
_LATENCY_WINDOW = 1024
_QPS_HORIZON_SECS = 30.0


class FleetRouter:
    """Socket front + health loop around one :class:`Fleet`."""

    def __init__(self, fleet: Fleet, listen: str,
                 registry: MetricsRegistry = REGISTRY, warn=None,
                 drain_grace_seconds: float = 2.0,
                 trace_sample_rate: float = 0.05):
        self.fleet = fleet
        self._registry = registry
        self._warn = warn or (lambda msg: None)
        self._drain_grace = float(drain_grace_seconds)
        # request tracing: the router is where trace ids are MINTED for
        # sampled requests (deterministic blake2b counter, no random —
        # serve/reqtrace.py); members inherit the id over the wire
        self._sampler = HeadSampler(trace_sample_rate)
        self._minter = TraceIdMinter()
        self._lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._closed = False
        self._started_at = time.monotonic()
        self._latencies_ms: list[float] = []
        self._done_times: list[float] = []
        scheme, addr = parse_serve_endpoint(listen)
        if scheme == "unix":
            try:
                os.unlink(addr)
            except FileNotFoundError:
                pass
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
            self._listener.bind(addr)
            self.endpoint = f"unix:{addr}"
        else:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind(addr)
            host, port = self._listener.getsockname()
            self.endpoint = f"{host}:{port}"  # real port under :0
        self._listener.listen(128)
        self._listener.settimeout(0.2)
        # the status plane's generation marker, like the service's
        with trace.span("serve.generation",
                        generation=fleet.live_generation(),
                        model_id=fleet.live_model_id() or "fleet"):
            pass

    # -- socket front (accept + reader threads) -------------------------

    def start(self) -> None:
        # daemonic and never joined — no reference kept (an always-on
        # router must not grow a Thread object per accepted connection)
        threading.Thread(target=self._accept_loop,
                         name="route-accept", daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed during shutdown
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             name="route-conn", daemon=True).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        wlock = threading.Lock()
        alive = [True]

        def send(obj: dict) -> bool:
            with wlock:
                if not alive[0]:
                    return False
                try:
                    conn.sendall(encode(obj))
                    return True
                except OSError:
                    alive[0] = False
                    self._registry.counter("serve_shed").inc(
                        reason="dead_client")
                    return False

        send(hello(self.fleet.live_model_id() or "fleet",
                   self.fleet.coordinates(),
                   generation=self.fleet.live_generation()))
        try:
            reader = conn.makefile("rb")
            for line in reader:
                if not line.strip():
                    continue
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError as e:
                    send(error_response(None, f"bad json: {e}"))
                    continue
                rid = msg.get("id")
                kind = msg.get("kind")
                if kind == "ping":
                    send({"kind": "pong", "proto": SERVE_PROTO})
                elif kind == "stats":
                    send({"kind": "stats", "proto": SERVE_PROTO,
                          **self.stats()})
                elif kind == "score":
                    self._handle_score(msg, send)
                elif kind == "swap":
                    send(error_response(
                        rid, "ModelSwapRefusedError: the fleet router "
                             "does not proxy swaps — swap each member "
                             "directly (photon-serve swap)"))
                elif kind == "member":
                    send(error_response(
                        rid, "a fleet router is not a member"))
                else:
                    send(error_response(rid, f"unknown kind {kind!r}"))
        except OSError:
            pass  # connection reset mid-read
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- request routing ------------------------------------------------

    def _handle_score(self, msg: dict, send) -> None:
        """Partition rows by entity shard, dispatch per owning member,
        reassemble in row order. All-or-nothing per request: a shard
        that cannot be served fails the whole request with a typed
        error reply (the client's rows may straddle shards — a partial
        score vector would be silently wrong).

        Tracing: a request that arrives with a wire ``trace_id`` is
        traced; otherwise the head sampler decides and the router MINTS
        the id. Sampled requests get a router-side ``serve.request``
        span over ``route.dispatch{shard}`` ⊃ ``route.member_wait``
        children, every scattered sub-request is stamped with the
        trace context (``parent_span`` = that shard's dispatch span),
        and every reply — scores or error — echoes the ``trace_id``."""
        rid = msg.get("id")
        rows = list(msg.get("rows") or [])
        started = time.monotonic()
        recv_ns = time.perf_counter_ns()
        wire_tid = msg.get("trace_id")
        client_parent = msg.get("parent_span")
        if wire_tid is not None:
            trace_id, sampled = str(wire_tid), True
        elif self._sampler.should_sample():
            trace_id, sampled = self._minter.mint(), True
        else:
            trace_id, sampled = None, False
        client_parent = (str(client_parent)
                         if client_parent is not None else None)
        req_span = (child_span_id(trace_id, "serve.request",
                                  client_parent or 0)
                    if sampled else None)

        def finish(outcome: str) -> None:
            if sampled:
                trace.record_span(
                    "serve.request", recv_ns, time.perf_counter_ns(),
                    trace_id=trace_id, span_id=req_span,
                    parent=client_parent, rows=len(rows),
                    outcome=outcome)

        if not rows:
            send(scores_response(rid, [], trace_id=trace_id))
            self._note_done(started)
            finish("ok")
            return
        groups: dict[int, list[int]] = {}
        for pos, row in enumerate(rows):
            if not isinstance(row, dict):
                send(error_response(
                    rid, f"TypeError: row {pos} is not an object",
                    trace_id=trace_id))
                finish("error:TypeError")
                return
            groups.setdefault(self.fleet.shard_of_row(row),
                              []).append(pos)
        scores: list = [0.0] * len(rows)
        uids: list = [None] * len(rows)
        with_uids = True
        shards = sorted(groups)
        # scatter in parallel — each shard's sub-request draws its own
        # pooled back-end connection, so request latency is the SLOWEST
        # shard's round trip, not the sum over shards
        outcomes: dict[int, object] = {}

        def _scatter(shard: int) -> None:
            sub = {"kind": "score", "id": f"{rid}/s{shard}",
                   "rows": [rows[p] for p in groups[shard]]}
            dspan = None
            if sampled:
                dspan = child_span_id(trace_id, "route.dispatch", shard)
                sub["trace_id"] = trace_id
                sub["parent_span"] = dspan
            timing: dict = {}
            t0 = time.perf_counter_ns()
            try:
                outcomes[shard] = self.fleet.dispatch(shard, sub,
                                                      timing=timing)
            except Exception as e:
                outcomes[shard] = e
            t1 = time.perf_counter_ns()
            # stage timing is always on (ledger-consistent); span
            # emission is what sampling gates
            observe_stage("route.dispatch", (t1 - t0) / 1e6,
                          self._registry)
            wait_s = timing.get("wait_start_ns")
            wait_e = timing.get("wait_end_ns")
            if wait_s is not None and wait_e is not None:
                observe_stage("route.member_wait",
                              (wait_e - wait_s) / 1e6, self._registry)
            if sampled:
                # outcome mirrors the serve_route{outcome} ledger entry
                # this dispatch resolved to (ok/failover/shed/...)
                trace.record_span(
                    "route.dispatch", t0, t1, depth=1,
                    trace_id=trace_id, span_id=dspan, parent=req_span,
                    shard=shard, member=timing.get("member", -1),
                    hops=timing.get("hops", 0),
                    outcome=str(timing.get("outcome", "error")))
                if wait_s is not None and wait_e is not None:
                    trace.record_span(
                        "route.member_wait", wait_s, wait_e, depth=2,
                        trace_id=trace_id,
                        span_id=child_span_id(
                            trace_id, "route.member_wait", shard),
                        parent=dspan,
                        member=timing.get("member", -1))

        if len(shards) == 1:
            _scatter(shards[0])
        else:
            workers = [threading.Thread(
                target=_scatter, args=(shard,),
                name=f"route-scatter-{shard}", daemon=True)
                for shard in shards]
            for t in workers:
                t.start()
            for t in workers:
                t.join()
        for shard in shards:
            positions = groups[shard]
            resp = outcomes[shard]
            if isinstance(resp, Exception):
                self._registry.counter("serve_errors").inc(
                    kind=type(resp).__name__)
                # wire_error keeps the typed grammar intact — a
                # member's shed:queue_full reaches the client as a
                # ShedError, not a generic string
                send(error_response(rid, wire_error(resp),
                                    trace_id=trace_id))
                finish(f"error:{type(resp).__name__}")
                return
            sub_scores = resp.get("scores") or []
            sub_uids = resp.get("uids")
            if len(sub_scores) != len(positions):
                self._registry.counter("serve_errors").inc(
                    kind="ShortReply")
                send(error_response(
                    rid, f"RuntimeError: shard {shard} returned "
                         f"{len(sub_scores)} scores for "
                         f"{len(positions)} rows",
                    trace_id=trace_id))
                finish("error:ShortReply")
                return
            if sub_uids is None or len(sub_uids) != len(positions):
                with_uids = False
            for i, p in enumerate(positions):
                scores[p] = sub_scores[i]
                if with_uids:
                    uids[p] = sub_uids[i]
        send(scores_response(rid, scores,
                             uids if with_uids else None,
                             trace_id=trace_id))
        self._note_done(started)
        finish("ok")

    def _note_done(self, started: float) -> None:
        """SLO bookkeeping — reader threads share the windows, so this
        runs under the router lock (unlike the service, where only the
        device loop writes them)."""
        now = time.monotonic()
        with self._lock:
            self._latencies_ms.append((now - started) * 1000.0)
            del self._latencies_ms[:-_LATENCY_WINDOW]
            self._done_times.append(now)
            horizon = now - _QPS_HORIZON_SECS
            self._done_times = [t for t in self._done_times
                                if t >= horizon]
            window = min(_QPS_HORIZON_SECS,
                         max(now - self._started_at, 1e-3))
            qps = len(self._done_times) / window
            lat = np.asarray(self._latencies_ms)
        self._registry.gauge("serve_qps").set(qps)
        self._registry.gauge("serve_p50_ms").set(
            float(np.percentile(lat, 50)))
        self._registry.gauge("serve_p99_ms").set(
            float(np.percentile(lat, 99)))

    # -- the health loop (main thread) ----------------------------------

    def health_loop(self, stop) -> Optional[str]:
        """Run heartbeats until ``stop`` fires, then drain: give
        in-flight dispatches a bounded grace to resolve (each one
        ALWAYS resolves — reply, typed error, or typed shed — so the
        grace only bounds how long we wait for the replies to flush)
        and return the stop reason. The caller owns the exit code."""
        while True:
            reason = stop.should_stop()
            if reason is not None:
                deadline = time.monotonic() + self._drain_grace
                while (self.fleet.inflight_count()
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
                return reason
            self.fleet.heartbeat_tick()
            time.sleep(self.fleet.health.heartbeat_seconds)

    # -- introspection / shutdown ---------------------------------------

    def stats(self) -> dict:
        g = self._registry.gauge
        return {
            "model_id": self.fleet.live_model_id(),
            "generation": self.fleet.live_generation(),
            "endpoint": self.endpoint,
            "fleet": self.fleet.snapshot(),
            "route": self._registry.counter(
                "serve_route").by_label("outcome"),
            "qps": g("serve_qps").value(),
            "p50_ms": g("serve_p50_ms").value(),
            "p99_ms": g("serve_p99_ms").value(),
            "uptime_secs": time.monotonic() - self._started_at,
        }

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self.fleet.close()


# ---------------------------------------------------------------------------
# entrypoint
# ---------------------------------------------------------------------------


def parse_args(argv: Sequence[str]) -> argparse.Namespace:
    from photon_ml_tpu_torch.cli.args import (
        add_observability_flags,
        check_telemetry_flags,
    )

    p = argparse.ArgumentParser(
        prog="photon-serve fleet",
        description="entity-sharded scorer fleet router")
    p.add_argument("--listen", default="127.0.0.1:0",
                   help="front endpoint clients dial (host:port, port "
                        "0 = kernel-assigned, or unix:/path.sock)")
    p.add_argument("--members", required=True,
                   help="comma-separated member endpoints; list order "
                        "IS the shard order (member k owns shard k, "
                        "falls back to member k+1 mod N)")
    p.add_argument("--route-id", default="",
                   help="the metadataMap id type rows are routed by "
                        "(default: first id in sorted-key order)")
    p.add_argument("--heartbeat-seconds", type=float, default=0.5,
                   help="health-loop tick: ping live members, probe "
                        "dead ones for generation-checked re-admission")
    p.add_argument("--suspect-after", type=int, default=1,
                   help="consecutive failures before healthy → suspect")
    p.add_argument("--dead-after", type=int, default=3,
                   help="consecutive failures before → dead (socket "
                        "kicked; shard served by its fallback member)")
    p.add_argument("--member-timeout", type=float, default=30.0,
                   help="per-dispatch socket timeout on the back-end "
                        "connections (bounds a hung member)")
    p.add_argument("--member-connections", type=int, default=4,
                   help="back-end connection pool size per member — "
                        "concurrent routed sub-requests overlap inside "
                        "the member's micro-batcher instead of "
                        "lock-stepping on one socket")
    p.add_argument("--drain-grace-seconds", type=float, default=2.0,
                   help="stop-drain bound on waiting for in-flight "
                        "dispatch replies to flush")
    p.add_argument("--trace-sample-rate", type=float, default=0.05,
                   help="head-sampling rate for request tracing: this "
                        "fraction of client requests get a minted "
                        "trace id and full router+member span trees "
                        "(deterministic pacing, no RNG; 0 disables, 1 "
                        "traces everything)")
    p.add_argument("--max-serve-seconds", type=float, default=None,
                   help="scheduled stop: drain and exit 0 (SIGTERM "
                        "drains and exits 75 instead — requeue me)")
    p.add_argument("--stop-file")
    p.add_argument("--log-file",
                   help="router log path (default: photon-route.log "
                        "under --trace-dir, else discarded)")
    add_observability_flags(p)
    ns = p.parse_args(argv)
    check_telemetry_flags(p, ns)
    return ns


def main(argv: Optional[Sequence[str]] = None) -> None:
    from photon_ml_tpu_torch.cli import clean_abort, clean_abort_types
    from photon_ml_tpu_torch.cli import preempted_exit
    from photon_ml_tpu_torch.obs.run import start_observed_run_from_flags
    from photon_ml_tpu_torch.utils.logging import PhotonLogger
    from photon_ml_tpu_torch.utils.preempt import (
        PreemptionRequested,
        StopController,
    )

    ns = parse_args(argv if argv is not None else sys.argv[1:])
    log_path = ns.log_file or (
        os.path.join(ns.trace_dir, "photon-route.log")
        if ns.trace_dir else os.devnull)
    logger = PhotonLogger(log_path, echo=False)
    endpoints = [e.strip() for e in ns.members.split(",") if e.strip()]

    stop = StopController(max_train_seconds=ns.max_serve_seconds,
                          stop_file=ns.stop_file)
    stop.install_signal_handlers()
    obs_run = start_observed_run_from_flags(
        ns, warn=logger.warn,
        preserve_existing=bool(os.environ.get("PHOTON_GAME_SUPERVISED")))
    router = None
    fleet = None
    try:
        fleet = Fleet(endpoints,
                      health=HealthPolicy(
                          suspect_after=ns.suspect_after,
                          dead_after=ns.dead_after,
                          heartbeat_seconds=ns.heartbeat_seconds),
                      warn=logger.warn,
                      route_key=ns.route_id or None,
                      member_timeout=ns.member_timeout,
                      connections_per_member=ns.member_connections)
        live = fleet.admit_all()
        router = FleetRouter(fleet, ns.listen, warn=logger.warn,
                             drain_grace_seconds=ns.drain_grace_seconds,
                             trace_sample_rate=ns.trace_sample_rate)
        router.start()
        logger.info(f"routing {fleet.live_model_id()} across "
                    f"{live}/{len(endpoints)} member(s) on "
                    f"{router.endpoint}")
        print(f"PHOTON_SERVE ready endpoint={router.endpoint}",
              flush=True)
        reason = router.health_loop(stop)
        if reason and reason.startswith("signal:"):
            raise PreemptionRequested(reason, 0, 0)
        logger.info(f"scheduled stop ({reason}): drained and done")
        if obs_run is not None:
            obs_run.set_exit_status("ok", reason=reason or "")
    except clean_abort_types() as e:
        if obs_run is not None:
            obs_run.set_exit_status("abort",
                                    reason=f"{type(e).__name__}: {e}")
        raise clean_abort(e, log=logger.error) from None
    except PreemptionRequested as e:
        if obs_run is not None:
            obs_run.set_exit_status("preempted", reason=e.reason)
        raise preempted_exit(e, log=logger.warn) from None
    except KeyboardInterrupt:
        if obs_run is not None:
            obs_run.set_exit_status("abort", reason="KeyboardInterrupt")
        raise clean_abort(KeyboardInterrupt("interrupted by operator"),
                          log=logger.error) from None
    except Exception as e:
        logger.error(f"fleet router failed: {e}")
        if obs_run is not None:
            obs_run.set_exit_status("error",
                                    reason=f"{type(e).__name__}: {e}")
        raise
    finally:
        if router is not None:
            router.shutdown()
        elif fleet is not None:
            fleet.close()
        stop.uninstall_signal_handlers()
        if obs_run is not None:
            obs_run.finish()
        logger.close()


if __name__ == "__main__":
    main()
