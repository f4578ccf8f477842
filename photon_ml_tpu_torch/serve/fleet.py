"""Fleet membership for the entity-sharded scorer fleet.

Port of ``photon_ml_tpu/serve/fleet.py``: ``entity_shard`` (``:102``),
``entity_of_row`` (``:116``), ``reply_exception`` (``:164``),
``HealthPolicy`` (``:186``), ``FleetMember`` (``:196``) and ``Fleet``
(``:230``), unchanged but for their imports. Members are the port's
scoring services (each on its card) or the JAX package's: the wire is the
same, so either package's router fronts either package's members. The
fleet itself is host-only and touches no device.

The router (``serve/router.py``) holds a small pool of persistent
back-end connections per scorer member (so concurrent routed
sub-requests overlap inside the member's micro-batcher instead of
lock-stepping on one socket) and routes each request row to the member
that OWNS the row's entity shard. Ownership is the serving analogue of
the training layout: the JAX package's ``game/dataset.py``
``entity_shard=(k, K)`` splits the sorted entity axis into K contiguous
slices, one per mesh shard. A serving request stream is
open-vocabulary — the router cannot know the model's sorted entity
axis — so :func:`entity_shard` takes the k-th of K contiguous slices
of the *keyed-hash* entity axis instead: the same stable, disjoint,
exhaustive partition discipline (every entity has exactly one owner,
ownership is a pure function of (entity, K)), which is what keeps
per-member device-tier budgets from overlapping and makes aggregate
hot-tier capacity scale linearly with fleet size.

Membership is a health-state machine per member, driven by dispatch
outcomes plus a heartbeat ``stats`` probe each tick::

    (boot) --verified hello--> healthy
    healthy  --suspect_after consecutive failures--> suspect
    suspect  --dead_after consecutive failures----> dead
    suspect  --any success-------------------------> healthy
    dead     --verified hello (generation check)---> healthy

Thresholds are FAILURE COUNTS, not wall-clock, so the machine is
deterministic under test — and only TRANSPORT failures count: a member
that ANSWERS a sub-request with an application error (a typed
``shed:*`` under overload, a deterministic bad-row error) is alive and
takes no health penalty; its typed reply goes straight back to the
client with no retry and no failover (:func:`reply_exception`), so a
poison request stream or an overload shed can never darken a healthy
fleet. A dead member's socket is kicked closed so every dispatch
blocked on it fails immediately (and is then retried, failed over to
the shard's fallback member, or shed with a typed error — never
black-holed); a single connection closed by a mid-wire failure is
re-dialed at its next checkout while the member stays in rotation.
Re-admission requires a fresh verified hello whose ``model_id``
matches the fleet's live identity: a member relaunched mid-hot-swap
with yesterday's model is refused until it catches up, so one fleet
never serves two model generations. The live identity itself follows
the fleet through a member-by-member hot-swap: the heartbeat's
``stats`` replies carry each member's current model, and once every
live member unanimously reports a new one the fleet identity advances
(``_note_member_identity``) — so post-swap relaunches re-admit onto
the NEW generation instead of being refused forever.

Lock discipline: ``Fleet._lock`` guards every
piece of member health/identity/in-flight metadata; each member's
``wire`` lock guards only the pool/clients *references* (connection
checkout is the pool queue's own lock, and each checked-out client
serializes itself). The two are never held together — metadata is read
under ``_lock``, released, then the wire is taken — so there is no
lock order to invert.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from typing import Optional, Sequence

from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.serve.protocol import (
    ServeClient,
    ServeRequestError,
    ShardUnavailableError,
    ShedError,
    typed_error,
)
from photon_ml_tpu_torch.utils.retry import (
    RetryExhaustedError,
    RetryPolicy,
    call_with_retry,
)

#: Per-dispatch bounded retry (site ``serve.route``): a transiently
#: failing member costs a couple of deterministically-jittered
#: backoffs before the router fails over to the shard's fallback.
ROUTE_RETRY_POLICY = RetryPolicy(
    max_attempts=3, base_delay_seconds=0.02, max_delay_seconds=0.25,
    retry_on=(OSError,), permanent_on=())

#: Boot admission: members launched alongside the router (e.g. by
#: a supervisor) take seconds to import torch, load the model and bind,
#: so the first hello is patient.
BOOT_CONNECT_POLICY = RetryPolicy(
    max_attempts=60, base_delay_seconds=0.25, max_delay_seconds=1.0,
    deadline_seconds=120.0, retry_on=(OSError,), permanent_on=())

#: Re-admission probe: one connect attempt per heartbeat tick — the
#: tick cadence IS the backoff.
READMIT_CONNECT_POLICY = RetryPolicy(
    max_attempts=1, base_delay_seconds=0.05, max_delay_seconds=0.05,
    retry_on=(OSError,), permanent_on=())


def entity_shard(entity_id: str, num_shards: int) -> int:
    """Shard owning ``entity_id``: the k-th of ``num_shards`` contiguous
    slices of the 64-bit keyed-hash entity axis (see module docstring
    for how this mirrors the entity-sharded training split). Stable across
    processes and runs — blake2b, not ``hash()``, which is seeded per
    process."""
    if num_shards <= 1:
        return 0
    h = int.from_bytes(
        hashlib.blake2b(str(entity_id).encode("utf-8", "replace"),
                        digest_size=8).digest(), "big")
    return min((h * num_shards) >> 64, num_shards - 1)


def entity_of_row(row: dict, route_key: Optional[str] = None) -> str:
    """The routing entity of a request row: ``route_key``'s value when
    configured (top-level or under ``metadataMap``), else the first
    metadataMap id in sorted-key order (deterministic for rows carrying
    several id types), else the row's ``uid`` — so entity-less rows
    still route deterministically."""
    md = row.get("metadataMap") or {}
    if route_key:
        v = md.get(route_key, row.get(route_key))
        if v is not None:
            return str(v)
        return ""
    if md:
        return str(md[sorted(md)[0]])
    uid = row.get("uid")
    return "" if uid is None else str(uid)


class FleetAdmissionError(RuntimeError):
    """A member's verified-hello admission was refused (bad handshake
    or generation-check mismatch); the member stays out of rotation."""


class MemberReplyError(OSError):
    """A member answered a routed sub-request with a TRANSPORT-grade
    error response (``serve.route`` fault points catch ``(InjectedFault,
    OSError)`` and answer with the exception's type name). An OSError so
    ``ROUTE_RETRY_POLICY`` retries it like a dead wire — a member that
    consumed an injected fault budget answers clean on the retry.
    Application answers (typed sheds, deterministic bad-row errors) are
    NOT this: see :func:`reply_exception`."""


#: Error-reply type names that stand in for WIRE-level failures inside
#: the member: its routed-plane fault point catches ``(InjectedFault,
#: OSError)`` and answers with the exception's type name, so these
#: replies mean "this sub-request hit transport-grade trouble" and take
#: the same bounded-retry / failover / health path a socket error takes.
#: (No ``IOError`` entry: it aliases ``OSError`` in Python 3, so
#: ``type(e).__name__`` can never render it on the wire.)
_TRANSPORT_REPLY_ERRORS = frozenset({
    "InjectedFault", "OSError", "ConnectionError",
    "ConnectionResetError", "ConnectionAbortedError",
    "ConnectionRefusedError", "BrokenPipeError", "TimeoutError",
    "InterruptedError",
})


def reply_exception(resp: dict, member_index: int
                    ) -> Optional[Exception]:
    """The exception a member's reply warrants, or None for clean
    replies. Transport-grade error replies
    (:data:`_TRANSPORT_REPLY_ERRORS`) become :class:`MemberReplyError`
    — retried, failed over, and fed to the health machine like a dead
    wire. Every OTHER error reply is an application ANSWER: the member
    is alive and already did the work of refusing, so its typed
    exception goes straight back to the client — retrying a
    ``shed:queue_full`` amplifies the very overload that caused it,
    and a poison request retried across members would darken a healthy
    fleet (three malformed requests must never mark a member dead)."""
    err = typed_error(resp)
    if err is None:
        return None
    name = str(resp.get("error", "")).partition(":")[0].strip()
    if not isinstance(err, ShedError) and name in _TRANSPORT_REPLY_ERRORS:
        return MemberReplyError(
            f"member {member_index} replied: {resp.get('error')}")
    return err


class HealthPolicy:
    """Deterministic health thresholds (consecutive-failure counts)."""

    def __init__(self, suspect_after: int = 1, dead_after: int = 3,
                 heartbeat_seconds: float = 0.5):
        self.suspect_after = int(suspect_after)
        self.dead_after = int(dead_after)
        self.heartbeat_seconds = float(heartbeat_seconds)


class FleetMember:
    """One scorer member: endpoint, its connection pool, and the
    health/identity metadata the :class:`Fleet` tracks for it. All
    mutable fields are owned by the Fleet's locks (module docstring);
    the member itself only carries them."""

    def __init__(self, index: int, endpoint: str):
        self.index = index
        self.endpoint = endpoint
        self.wire = threading.Lock()  # guards pool/clients swaps
        # the connection POOL: several persistent member-role
        # connections so concurrent routed sub-requests overlap inside
        # the member's micro-batcher instead of lock-stepping on one
        # socket. ``pool`` is the FIFO checkout queue; ``clients`` is
        # the full set (for kick/close). Both guarded by ``wire``;
        # checkout itself is the queue's own lock.
        self.pool: Optional["queue.Queue[ServeClient]"] = None
        self.clients: list[ServeClient] = []
        # guarded by Fleet._lock:
        self.state = "dead"  # healthy | suspect | dead
        self.failures = 0
        self.generation: Optional[int] = None
        self.model_id: Optional[str] = None
        self.coordinates: list = []
        self.admissions = 0

    def kick(self) -> None:
        """Fail any dispatch blocked on this member's sockets NOW
        (mark-dead path). Read-only on the client references: the next
        admission swaps in a fresh pool under the wire lock."""
        for client in list(self.clients):
            client.kick()


class Fleet:
    """Membership + routing for N scorer members behind one router.

    ``dispatch`` is called from the router's per-connection reader
    threads; ``heartbeat_tick`` and admission run on the router's main
    thread. Every outcome on the request plane lands in the
    ``serve_route{outcome}`` counter — summing ``ok`` + ``error`` +
    ``shed`` accounts for every routed sub-request, which is the
    no-black-hole ledger the chaos cells audit.
    """

    def __init__(self, endpoints: Sequence[str],
                 health: Optional[HealthPolicy] = None,
                 registry: MetricsRegistry = REGISTRY,
                 warn=None, route_key: Optional[str] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 member_timeout: float = 30.0,
                 fallbacks: Optional[dict] = None,
                 connections_per_member: int = 4):
        if not endpoints:
            raise ValueError("a fleet needs at least one member endpoint")
        self.members = [FleetMember(i, ep)
                        for i, ep in enumerate(endpoints)]
        self.health = health or HealthPolicy()
        self.route_key = route_key
        self._registry = registry
        self._warn = warn or (lambda msg: None)
        self._retry = retry_policy or ROUTE_RETRY_POLICY
        self._member_timeout = float(member_timeout)
        self._connections = int(max(1, connections_per_member))
        # shard k's fallback member (hedged re-dispatch target when the
        # owner is down); default: the ring successor
        n = len(self.members)
        self._fallback_of = {
            k: (fallbacks.get(k, (k + 1) % n) if fallbacks
                else (k + 1) % n)
            for k in range(n)}
        self._lock = threading.Lock()
        self._live_model_id: Optional[str] = None
        self._inflight: dict[tuple, float] = {}  # token → dispatch start
        self._dispatch_seq = 0
        self._update_member_gauge_locked()

    # -- routing --------------------------------------------------------

    @property
    def num_shards(self) -> int:
        return len(self.members)

    def shard_of_row(self, row: dict) -> int:
        return entity_shard(entity_of_row(row, self.route_key),
                            self.num_shards)

    def route_chain(self, shard: int) -> list:
        """Members eligible to serve ``shard``, in dispatch order:
        the owner, then its configured fallback — dead members are
        skipped. Empty means the shard is dark (degraded mode: the
        caller sheds with :class:`ShardUnavailableError`)."""
        owner = shard % len(self.members)
        order = [owner]
        fb = self._fallback_of[owner]
        if fb != owner:
            order.append(fb)
        with self._lock:
            return [self.members[i] for i in order
                    if self.members[i].state != "dead"]

    # -- dispatch (router reader threads) -------------------------------

    def dispatch(self, shard: int, msg: dict,
                 timing: Optional[dict] = None) -> dict:
        """Route one sub-request to the shard's owner with bounded
        retry, failing over to the fallback member, shedding typed when
        the shard has no live member. Raises on failure — the caller
        turns the exception into a typed error reply, so every routed
        request resolves one way or another.

        ``timing``, when given, is filled with the dispatch's trace
        facts (the router's ``route.dispatch``/``route.member_wait``
        spans ride it): ``outcome`` mirrors the ``serve_route{outcome}``
        ledger entry this dispatch resolved to, ``member`` is the
        member index that answered (or was last tried), ``hops`` counts
        failovers taken, and ``wait_start_ns``/``wait_end_ns`` bracket
        the LAST on-the-wire member round trip
        (``time.perf_counter_ns``)."""
        if timing is None:
            timing = {}
        chain = self.route_chain(shard)
        if not chain:
            self._count("shed")
            timing["outcome"] = "shed"
            raise ShardUnavailableError(
                f"shard {shard} has no live member "
                f"(owner and fallback are dead)")
        last: Optional[BaseException] = None
        for hop, member in enumerate(chain):
            if hop:
                self._count("failover")
            timing["member"] = member.index
            timing["hops"] = hop
            try:
                resp = call_with_retry(
                    lambda m=member: self._dispatch_once(m, msg, timing),
                    "serve.route", policy=self._retry, warn=self._warn)
            except RetryExhaustedError as e:
                self._record_failure(member)
                self._count("member_failed")
                timing["outcome"] = "member_failed"
                last = e.__cause__ or e
                continue
            except ShedError:
                # the member ANSWERED: alive but over budget. The typed
                # shed goes to the client untouched — retrying it on
                # the same member, or hedging it onto the fallback,
                # would amplify the very overload that caused it — and
                # an answering member takes no health penalty.
                self._count("shed")
                timing["outcome"] = "shed"
                raise
            except ServeRequestError:
                # deterministic application error (malformed rows, a
                # refused kind): the error IS the reply, so no retry,
                # no failover, no health penalty — a poison request
                # stream must not darken a healthy fleet.
                self._count("error")
                timing["outcome"] = "error"
                raise
            self._record_success(member)
            self._count("ok")
            timing["outcome"] = "failover" if hop else "ok"
            return resp
        self._count("error")
        timing["outcome"] = "error"
        raise OSError(
            f"shard {shard}: every route attempt failed "
            f"(last: {type(last).__name__}: {last})")

    def _dispatch_once(self, member: FleetMember, msg: dict,
                       timing: Optional[dict] = None) -> dict:
        with self._lock:
            if member.state == "dead":
                raise OSError(f"member {member.index} is dead")
            self._dispatch_seq += 1
            token = (member.index, msg.get("id"), self._dispatch_seq)
            self._inflight[token] = time.monotonic()
        try:
            with member.wire:
                pool = member.pool
            if pool is None:
                raise OSError(f"member {member.index} is not connected")
            try:
                client = pool.get(timeout=self._member_timeout)
            except queue.Empty:
                raise OSError(
                    f"member {member.index}: every pooled connection "
                    f"busy for {self._member_timeout:.0f}s") from None
            client = self._repair(member, pool, client)
            t_wire = time.perf_counter_ns()
            try:
                resp = client.request(msg)
            except BaseException:
                # a request that died mid-wire leaves the framing
                # desynced — close before returning so the slot still
                # exists (pool size is invariant) and the next checkout
                # of THIS slot re-dials it (``_repair``) instead of
                # mis-pairing replies
                try:
                    client.close()
                except OSError:
                    pass
                pool.put(client)
                raise
            else:
                pool.put(client)
            finally:
                if timing is not None:
                    # the LAST attempt's wire bracket (failed attempts
                    # overwrite, so the span shows the round trip that
                    # produced the outcome)
                    timing["wait_start_ns"] = t_wire
                    timing["wait_end_ns"] = time.perf_counter_ns()
        finally:
            with self._lock:
                self._inflight.pop(token, None)
        err = reply_exception(resp, member.index)
        if err is not None:
            raise err
        return resp

    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    def _repair(self, member: FleetMember, pool, client: ServeClient
                ) -> ServeClient:
        """Checkout-time pool repair: a slot whose client was closed
        after a mid-wire failure is re-dialed while the member stays
        healthy, instead of burning a retry attempt (plus backoff) on
        every future draw until a full dead→re-admission cycle rebuilds
        the pool. On failure the dead slot goes back (pool size is
        invariant) and the OSError feeds the normal retry/health
        path."""
        if not client.closed:
            return client
        try:
            return self._revive(member, client)
        except (OSError, FleetAdmissionError) as e:
            pool.put(client)
            raise OSError(
                f"member {member.index}: reconnect of a closed pool "
                f"slot failed: {type(e).__name__}: {e}") from e

    def _revive(self, member: FleetMember, dead: ServeClient
                ) -> ServeClient:
        """One reconnect attempt for one closed pool slot (the member
        is in rotation, so its listener should answer NOW): fresh
        connection, verified hello, member-role handshake, generation
        check — the admission gauntlet, scoped to a single slot."""
        client = ServeClient(member.endpoint,
                             timeout=self._member_timeout,
                             connect_policy=READMIT_CONNECT_POLICY)
        try:
            if (client.hello or {}).get("kind") != "serve_hello":
                raise FleetAdmissionError(
                    f"member {member.index}: bad hello on reconnect: "
                    f"{client.hello!r}")
            ack = client.request({"kind": "member",
                                  "member": member.index,
                                  "fleet": len(self.members)})
            if ack.get("kind") != "member_ack":
                raise FleetAdmissionError(
                    f"member {member.index}: member-role handshake "
                    f"refused on reconnect: {ack!r}")
            with self._lock:
                live = self._live_model_id
            if live is not None and ack.get("model_id") != live:
                raise FleetAdmissionError(
                    f"member {member.index} reconnected serving "
                    f"{ack.get('model_id')!r} but the fleet is live "
                    f"on {live!r}")
        except BaseException:
            client.close()
            raise
        with member.wire:
            try:
                member.clients.remove(dead)
            except ValueError:
                pass  # pool already rebuilt by a re-admission
            member.clients.append(client)
        self._count_member("reconnected")
        return client

    # -- health state machine -------------------------------------------

    def _record_failure(self, member: FleetMember) -> None:
        with self._lock:
            if member.state == "dead":
                return
            member.failures += 1
            previous = member.state
            if member.failures >= self.health.dead_after:
                member.state = "dead"
            elif member.failures >= self.health.suspect_after:
                member.state = "suspect"
            became_dead = (member.state == "dead"
                           and previous != "dead")
            failures = member.failures
            self._update_member_gauge_locked()
        if became_dead:
            self._count_member("dead")
            self._warn(f"fleet member {member.index} "
                       f"({member.endpoint}) marked dead after "
                       f"{failures} consecutive failures")
            # fail every dispatch blocked on its socket immediately —
            # in-flight work re-routes or sheds instead of hanging
            member.kick()

    def _record_success(self, member: FleetMember) -> None:
        with self._lock:
            if member.state == "dead":
                return  # only a verified hello re-admits
            member.failures = 0
            member.state = "healthy"
            self._update_member_gauge_locked()

    def _update_member_gauge_locked(self) -> None:
        counts = {"healthy": 0, "suspect": 0, "dead": 0}
        for m in self.members:
            counts[m.state] += 1
        g = self._registry.gauge("serve_fleet_members")
        for state, n in counts.items():
            g.set(n, state=state)

    def _count(self, outcome: str) -> None:
        self._registry.counter("serve_route").inc(outcome=outcome)

    def _count_member(self, event: str) -> None:
        self._registry.counter("serve_fleet_events").inc(event=event)

    # -- admission (router main thread) ---------------------------------

    def admit_all(self, policy: Optional[RetryPolicy] = None) -> int:
        """Boot admission: verified hello + member-role handshake for
        every member (patient connect — members may still be
        importing). Members that fail stay dead; returns the live
        count. At least one member must admit."""
        live = 0
        for member in self.members:
            try:
                self.admit(member,
                           policy=policy or BOOT_CONNECT_POLICY)
                live += 1
            except (OSError, FleetAdmissionError) as e:
                self._warn(f"fleet member {member.index} "
                           f"({member.endpoint}) failed boot "
                           f"admission: {type(e).__name__}: {e}")
        if not live:
            raise FleetAdmissionError(
                "no fleet member completed a verified hello")
        return live

    def admit(self, member: FleetMember,
              policy: Optional[RetryPolicy] = None) -> None:
        """Connect, verify the hello, run the member-role handshake,
        and generation-check the member's model identity against the
        fleet's live identity before putting it (back) in rotation.

        Builds a pool of ``connections_per_member`` back-end
        connections (each with its own verified hello + member-role
        handshake, so ``serve.route`` covers every wire) — concurrent
        router requests then reach the member in parallel and its
        micro-batcher can actually coalesce them."""
        clients: list[ServeClient] = []
        first_ack: Optional[dict] = None
        try:
            for i in range(self._connections):
                client = ServeClient(
                    member.endpoint, timeout=self._member_timeout,
                    connect_policy=(policy or READMIT_CONNECT_POLICY)
                    if i == 0 else None)
                clients.append(client)
                if (client.hello or {}).get("kind") != "serve_hello":
                    raise FleetAdmissionError(
                        f"member {member.index}: bad hello "
                        f"{client.hello!r}")
                ack = client.request({"kind": "member",
                                      "member": member.index,
                                      "fleet": len(self.members)})
                if ack.get("kind") != "member_ack":
                    raise FleetAdmissionError(
                        f"member {member.index}: member-role handshake "
                        f"refused: {ack!r}")
                model_id = ack.get("model_id")
                with self._lock:
                    live = self._live_model_id
                if live is not None and model_id != live:
                    # the generation check: a member relaunched
                    # mid-swap with a stale model must not split the
                    # fleet
                    raise FleetAdmissionError(
                        f"member {member.index} serves model "
                        f"{model_id!r} but the fleet is live on "
                        f"{live!r} — re-admission refused until it "
                        f"catches up")
                if first_ack is None:
                    first_ack = ack
                elif model_id != first_ack.get("model_id"):
                    raise FleetAdmissionError(
                        f"member {member.index} swapped mid-admission "
                        f"({first_ack.get('model_id')!r} → "
                        f"{model_id!r}) — retry next tick")
        except BaseException:
            for client in clients:
                client.close()
            raise
        ack = first_ack or {}
        model_id = ack.get("model_id")
        pool: "queue.Queue[ServeClient]" = queue.Queue()
        for client in clients:
            pool.put(client)
        with member.wire:
            old = member.clients
            member.clients = clients
            member.pool = pool
        with self._lock:
            member.state = "healthy"
            member.failures = 0
            member.generation = ack.get("generation")
            member.model_id = model_id
            member.coordinates = list(
                (clients[0].hello or {}).get("coordinates") or [])
            member.admissions += 1
            readmission = member.admissions > 1
            if self._live_model_id is None:
                self._live_model_id = model_id
            self._update_member_gauge_locked()
        for client in old:
            try:
                client.close()
            except OSError:
                pass
        self._count_member("readmitted" if readmission else "admitted")

    def heartbeat_tick(self) -> None:
        """One health round (router main thread): probe live members
        with a ``stats`` request (liveness AND the member's current
        model identity in one round trip), re-dial closed pool slots,
        probe dead members for re-admission. A member whose every
        pooled connection is busy with a dispatch is skipped this tick
        — the dispatch results themselves feed the state machine."""
        for member in self.members:
            with self._lock:
                state = member.state
            if state == "dead":
                try:
                    self.admit(member)
                except (OSError, FleetAdmissionError):
                    pass  # still down (or still stale) — next tick
                continue
            with member.wire:
                pool = member.pool
            if pool is None:
                self._record_failure(member)
                continue
            try:
                client = pool.get_nowait()
            except queue.Empty:
                continue  # all connections mid-dispatch — busy ≠ sick
            try:
                client = self._repair(member, pool, client)
            except OSError:
                self._record_failure(member)
                continue
            try:
                reply = client.stats()
                if reply.get("kind") != "stats":
                    raise OSError(f"bad stats reply: {reply!r}")
            except (OSError, ConnectionError):
                pool.put(client)
                self._record_failure(member)
            else:
                pool.put(client)
                self._record_success(member)
                self._note_member_identity(member,
                                           reply.get("model_id"),
                                           reply.get("generation"))

    def _note_member_identity(self, member: FleetMember,
                              model_id, generation) -> None:
        """Heartbeat-fed identity tracking: record what the member says
        it serves NOW, and advance the fleet's live identity once every
        live member unanimously reports a new ``model_id`` — the
        documented fleet-wide hot-swap is member-by-member (the router
        refuses to proxy swaps), so without this the identity would
        stay frozen at the boot model and a member relaunched on the
        NEW generation would be refused re-admission forever. Until
        unanimity the old identity stands, so a straggler relaunched on
        the previous model is still admitted mid-swap."""
        advanced = None
        with self._lock:
            if generation is not None:
                member.generation = int(generation)
            if model_id is None:
                return
            member.model_id = model_id
            live = self._live_model_id
            if model_id != live:
                ids = {m.model_id for m in self.members
                       if m.state != "dead"}
                if ids == {model_id}:
                    self._live_model_id = model_id
                    advanced = live
        if advanced is not None:
            self._count_member("identity_advanced")
            self._warn(f"fleet live model identity advanced "
                       f"{advanced!r} → {model_id!r} (every live "
                       f"member reports the new generation)")

    # -- introspection / shutdown ---------------------------------------

    def live_model_id(self) -> Optional[str]:
        with self._lock:
            return self._live_model_id

    def live_generation(self) -> int:
        """The fleet's serving generation: the max over live members'
        last verified generation (generation counters are per-process;
        ``model_id`` is the cross-process identity)."""
        with self._lock:
            gens = [m.generation for m in self.members
                    if m.state != "dead" and m.generation is not None]
        return max(gens) if gens else 1

    def coordinates(self) -> list:
        with self._lock:
            for m in self.members:
                if m.state != "dead" and m.coordinates:
                    return list(m.coordinates)
        return []

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "shards": len(self.members),
                "live_model_id": self._live_model_id,
                "inflight": len(self._inflight),
                "members": [
                    {"member": m.index, "endpoint": m.endpoint,
                     "state": m.state, "failures": m.failures,
                     "generation": m.generation,
                     "model_id": m.model_id,
                     "admissions": m.admissions}
                    for m in self.members],
            }

    def close(self) -> None:
        for member in self.members:
            with member.wire:
                clients = member.clients
                member.clients = []
                member.pool = None
            for client in clients:
                try:
                    client.close()
                except OSError:
                    pass
