"""Scoring-service wire protocol: versioned NDJSON over TCP/unix.

Port of ``photon_ml_tpu/serve/protocol.py``: the same messages, byte for
byte, so either package's client speaks to either package's service.

Same transport family as the telemetry plane (``obs/export.py``):
newline-delimited JSON objects over a stream socket, with an explicit
protocol version stamped on every server-originated message so
consumers can reject records they don't speak.

Grammar (one JSON object per line):

- server → client on connect::

    {"kind": "serve_hello", "proto": 1, "model_id": ...,
     "generation": <int>, "coordinates": [...]}

- client → server::

    {"kind": "score", "id": <echoed>, "rows": [<record>, ...],
     "trace_id"?: "<16-hex>", "parent_span"?: "<16-hex>"}
    {"kind": "ping"}
    {"kind": "stats"}
    {"kind": "swap", "id": <echoed>, "model_dir": "...",
     "model_id": <optional>}
    {"kind": "member", "member": <int>, "fleet": <int>}

  A ``score`` row is a GAME record in the Avro record shape the batch
  loader reads: feature sections of ``{"name", "term", "value"}``
  entries, entity ids top-level or under ``metadataMap``, optional
  ``uid``/``offset``/``weight``. A ``swap`` asks the service to
  hot-swap to the candidate model under ``model_dir`` (load+validate
  off the hot path, shadow-scoring canary, atomic generation flip —
  see ``serve/service.py``); its reply arrives when the swap RESOLVES
  (flipped or refused), which can be many batches later.

- server → client::

    {"kind": "scores", "proto": 1, "id": ..., "scores": [...], "uids": [...],
     "trace_id"?: "<16-hex>"}
    {"kind": "pong",   "proto": 1}
    {"kind": "stats",  "proto": 1, "generation": ..., "last_swap": ..., ...}
    {"kind": "error",  "proto": 1, "id": ..., "error": "...",
     "trace_id"?: "<16-hex>"}
    {"kind": "swap_result", "proto": 1, "id": ...,
     "outcome": "ok"|"refused", "generation": <now current>,
     "model_id": <now current>, "reason"?: "...", "canary"?: {...},
     "error"?: "ModelSwapRefusedError: ..."}

  A refused swap carries the typed error name in ``error`` (the
  client-side exception is :class:`ModelSwapRefusedError`); a
  post-flip probation ROLLBACK happens after the reply and is
  reported through ``stats``/``photon_status`` (``last_swap``), not
  the ``swap_result``.

  ``member`` is the fleet router's member-role handshake
  (``serve/fleet.py``): the service acknowledges with
  ``{"kind": "member_ack", "proto": 1, "member": <echoed>,
  "generation": ..., "model_id": ...}`` and marks the connection as
  router-originated, which arms the ``serve.route`` fault point on
  that connection's score requests. ``error`` strings follow a typed
  grammar — ``shed:<reason>`` or ``<TypeName>: <message>`` — parsed
  back into exceptions by :func:`typed_error`.

  ``trace_id``/``parent_span`` are the OPTIONAL distributed-tracing
  context (``serve/reqtrace.py``): absent fields mean an untraced
  request, so old clients and old members interoperate unchanged. The
  fleet router mints ids for sampled requests and stamps them onto
  every scattered sub-request; replies — including ``error`` replies,
  so a shed or typed refusal stays attributable — echo the
  ``trace_id`` back to the caller.

Endpoints reuse the telemetry grammar (``host:port`` /
``unix:/path.sock``); ``file:`` endpoints are rejected — a request
protocol needs a peer, not a tail file.
"""

from __future__ import annotations

import json
import socket
from typing import Optional, Sequence

from photon_ml_tpu_torch.obs.export import parse_endpoint
from photon_ml_tpu_torch.utils.retry import (
    RetryExhaustedError,
    RetryPolicy,
    call_with_retry,
)

#: Protocol version stamped on every server message. Bump on any
#: incompatible message-shape change (same discipline as
#: ``obs/export.TELEMETRY_PROTO``).
SERVE_PROTO = 1

#: Client connect/reconnect backoff: bounded exponential with the
#: deterministic keyed jitter every retry site shares. ``permanent_on``
#: is emptied because a unix socket that is not bound yet raises
#: FileNotFoundError — for a connect that is transient, not permanent.
CONNECT_RETRY_POLICY = RetryPolicy(
    max_attempts=5, base_delay_seconds=0.05, max_delay_seconds=1.0,
    retry_on=(OSError,), permanent_on=())


class ServeRequestError(RuntimeError):
    """Base of the typed client-side view of a server ``error``
    response. :func:`typed_error` parses the wire ``error`` string into
    the matching subclass; unknown error shapes land here so callers
    can always catch the base."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class ShedError(ServeRequestError):
    """The service shed the request at admission (``shed:queue_full``
    when the bounded queue is over budget, ``shed:closed`` while
    draining) — retry against a less loaded or live endpoint."""

    def __init__(self, reason: str):
        super().__init__(f"shed:{reason}")
        self.reason = reason


class ShardUnavailableError(ServeRequestError):
    """The fleet router's degraded mode: the entity shard owning these
    rows has no live member (owner and fallback both dead), so the
    request is shed typed instead of hanging (``serve/fleet.py``)."""


class ModelSwapRefusedError(ServeRequestError):
    """A hot-swap candidate was refused (unreadable/corrupt model,
    canary score-diff violation, flip fault, or service draining) —
    the service keeps serving its current generation."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


#: Typed-error names recognized on the wire (``"Name: message"``).
_TYPED_ERRORS = {
    "ShardUnavailableError": ShardUnavailableError,
    "ModelSwapRefusedError": ModelSwapRefusedError,
}


def typed_error(resp: dict) -> Optional[ServeRequestError]:
    """The typed exception a response carries, or None for non-errors.

    Parses the ``error`` field's wire grammar: ``shed:<reason>`` for
    admission sheds, ``<TypeName>: <message>`` for typed errors
    (:data:`_TYPED_ERRORS`), anything else as the generic
    :class:`ServeRequestError`. Works on ``error`` responses and on
    refused ``swap_result`` replies alike (both carry ``error``)."""
    message = resp.get("error")
    if message is None:
        return None
    message = str(message)
    if message.startswith("shed:"):
        return ShedError(message[len("shed:"):])
    name, sep, rest = message.partition(":")
    if sep and name in _TYPED_ERRORS:
        return _TYPED_ERRORS[name](rest.strip())
    return ServeRequestError(message)


def wire_error(exc: BaseException) -> str:
    """Render an exception into the wire ``error`` grammar so
    :func:`typed_error` round-trips it on the far side: a
    :class:`ShedError` keeps its ``shed:<reason>`` form (its message
    already carries the prefix), everything else is rendered
    ``TypeName: message``. The fleet router uses this to forward a
    member's typed refusal to the client without demoting it to a
    generic error."""
    if isinstance(exc, ShedError):
        return exc.message
    return f"{type(exc).__name__}: {exc}"


def parse_serve_endpoint(endpoint: str) -> tuple[str, object]:
    """``("tcp", (host, port))`` or ``("unix", path)``."""
    scheme, addr = parse_endpoint(endpoint)
    if scheme == "file":
        raise ValueError(
            f"serve endpoint {endpoint!r}: a scoring service needs a "
            f"socket endpoint (host:port or unix:/path.sock), not a file")
    return scheme, addr


def encode(obj: dict) -> bytes:
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode()


def hello(model_id: str, coordinates: Sequence[str],
          generation: int = 1) -> dict:
    return {"kind": "serve_hello", "proto": SERVE_PROTO,
            "model_id": model_id, "generation": int(generation),
            "coordinates": list(coordinates)}


def error_response(request_id, message: str,
                   trace_id: Optional[str] = None) -> dict:
    out = {"kind": "error", "proto": SERVE_PROTO, "id": request_id,
           "error": message}
    if trace_id is not None:
        out["trace_id"] = trace_id
    return out


def scores_response(request_id, scores, uids=None,
                    trace_id: Optional[str] = None) -> dict:
    out = {"kind": "scores", "proto": SERVE_PROTO, "id": request_id,
           "scores": [float(s) for s in scores]}
    if uids is not None:
        out["uids"] = [str(u) for u in uids]
    if trace_id is not None:
        out["trace_id"] = trace_id
    return out


def swap_response(request_id, outcome: str, generation: int,
                  model_id: str, reason: Optional[str] = None,
                  canary: Optional[dict] = None) -> dict:
    """``swap_result`` reply; ``generation``/``model_id`` are what is
    CURRENT after resolution (the candidate's on ``ok``, unchanged on
    ``refused``)."""
    out = {"kind": "swap_result", "proto": SERVE_PROTO,
           "id": request_id, "outcome": outcome,
           "generation": int(generation), "model_id": model_id}
    if reason is not None:
        out["reason"] = reason
        if outcome == "refused":
            out["error"] = f"ModelSwapRefusedError: {reason}"
    if canary is not None:
        out["canary"] = canary
    return out


class ServeClient:
    """Blocking convenience client (tests, bench, chaos drills).

    One request in flight at a time; responses are matched by arrival
    order, which the single-connection protocol guarantees. Connecting
    goes through ``utils/retry`` (site ``serve.connect``): a service
    mid-restart costs a bounded, deterministically-jittered backoff
    instead of an immediate ConnectionError. :meth:`reconnect`
    re-dials the same endpoint and re-verifies the hello
    ``generation`` — ``generation_changed`` records whether a
    hot-swap happened while the client was away.

    With ``raise_errors=True`` every response carrying an ``error``
    field raises its typed exception (:func:`typed_error`:
    :class:`ShedError` / :class:`ShardUnavailableError` /
    :class:`ModelSwapRefusedError` / :class:`ServeRequestError`)
    instead of returning the raw dict.
    """

    def __init__(self, endpoint: str, timeout: float = 30.0,
                 connect_policy: Optional[RetryPolicy] = None,
                 raise_errors: bool = False):
        self._endpoint = endpoint
        self._timeout = timeout
        self._scheme, self._addr = parse_serve_endpoint(endpoint)
        self._policy = connect_policy or CONNECT_RETRY_POLICY
        self._raise_errors = bool(raise_errors)
        self._sock: Optional[socket.socket] = None
        self._file = None
        self.hello: Optional[dict] = None
        self.generation: Optional[int] = None
        self.generation_changed = False
        self._connect()

    def _connect(self) -> None:
        def attempt() -> socket.socket:
            family = (socket.AF_UNIX if self._scheme == "unix"
                      else socket.AF_INET)
            sock = socket.socket(family, socket.SOCK_STREAM)
            sock.settimeout(self._timeout)
            try:
                sock.connect(self._addr)
            except BaseException:
                sock.close()
                raise
            return sock

        try:
            self._sock = call_with_retry(attempt, "serve.connect",
                                         policy=self._policy)
        except RetryExhaustedError as e:
            # keep the pre-backoff exception contract: callers (chaos
            # drills, tests) dispatch on ConnectionError/OSError
            raise e.__cause__ from e


        self._file = self._sock.makefile("rb")
        self.hello = self._read()
        self.generation = self.hello.get("generation")

    @property
    def closed(self) -> bool:
        """True once :meth:`close` ran (a kicked-but-unclosed client is
        NOT closed — its owner replaces it wholesale). The fleet's pool
        repair re-dials closed slots at checkout."""
        return self._sock is None

    def reconnect(self) -> dict:
        """Drop the connection and re-dial (same bounded backoff).
        Returns the fresh hello; ``generation_changed`` is True when
        the service's generation moved while we were away."""
        previous = self.generation
        self.close()
        self._connect()
        self.generation_changed = (
            previous is not None and self.generation != previous)
        return self.hello

    def _read(self) -> dict:
        line = self._file.readline()
        if not line:
            raise ConnectionError("scoring service closed the connection")
        return json.loads(line)

    def request(self, obj: dict) -> dict:
        if self._sock is None:
            # an OSError, not AttributeError: a closed client must fail
            # like a dead wire so retry/failover/health paths treat it
            # uniformly (the fleet pool returns closed clients to their
            # slot — the next draw lands here)
            raise ConnectionError("client is closed")
        self._sock.sendall(encode(obj))
        resp = self._read()
        if self._raise_errors:
            err = typed_error(resp)
            if err is not None:
                raise err
        return resp

    def score(self, rows: Sequence[dict],
              request_id: Optional[str] = None,
              trace_id: Optional[str] = None,
              parent_span: Optional[str] = None) -> dict:
        """Score ``rows``; pass ``trace_id`` (and optionally the
        caller's ``parent_span``) to request a traced scoring — the
        reply echoes the id and the far side links its stage spans
        under it. Omitted = untraced (the wire fields stay absent)."""
        msg = {"kind": "score", "id": request_id or "0",
               "rows": list(rows)}
        if trace_id is not None:
            msg["trace_id"] = trace_id
        if parent_span is not None:
            msg["parent_span"] = parent_span
        return self.request(msg)

    def ping(self) -> dict:
        return self.request({"kind": "ping"})

    def stats(self) -> dict:
        return self.request({"kind": "stats"})

    def swap(self, model_dir: str, model_id: Optional[str] = None,
             request_id: Optional[str] = None) -> dict:
        """Request a hot-swap; blocks until the swap RESOLVES (the
        reply rides the same connection, after load + canary + flip).
        Returns the ``swap_result`` dict — check ``outcome``."""
        msg = {"kind": "swap", "id": request_id or "0",
               "model_dir": model_dir}
        if model_id:
            msg["model_id"] = model_id
        return self.request(msg)

    def kick(self) -> None:
        """Fail any request blocked on this connection NOW by shutting
        the socket under it (the fleet health machine's mark-dead
        path). Deliberately leaves the client's state alone — the
        owner reconnects or replaces the client afterwards."""
        sock = self._sock
        if sock is None:
            return
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            self._file.close()
        finally:
            self._sock.close()
            self._sock = None
            self._file = None

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
