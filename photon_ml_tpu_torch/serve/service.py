"""The always-on scoring service process.

Port of ``photon_ml_tpu/serve/service.py``: the same threads, wire
protocol, hot-swap state machine and exit codes, on the card given by
``--device`` (default ``cuda``; without CUDA it raises, there is no
fallback to the CPU). The telemetry flags are the JAX service's:
``--trace-dir`` (the run's trace directory through ``obs/run.py``, its
heartbeats carrying the ``serve_stage_ms`` totals, and the log
``photon-serve.log`` there unless ``--log-file`` says otherwise),
``--trace-heartbeat-seconds``, ``--trace-stall-seconds``,
``--telemetry-endpoint``, ``--device-telemetry`` and
``--trace-exemplar-slots`` (the slowest-N requests keep their full stage
trees in ``exemplars.jsonl`` beside the spans, whatever the sample rate;
``service.py:184-231``, ``:529-616``). Stage timings feed
``serve_stage_ms`` and the ``stats`` reply with or without a trace.

Thread layout (one process, one device context):

- an **accept thread** takes connections on the listen socket;
- one **reader thread per connection** decodes NDJSON requests and
  either answers directly (``ping``/``stats``) or submits
  :class:`~photon_ml_tpu_torch.serve.batcher.ScoreWork` to the micro-batcher
  — admission never blocks: overload sheds with an error response;
- the **device loop** (the main thread) drains micro-batches,
  scores each one through the shared
  :class:`~photon_ml_tpu_torch.serve.scoring.ServingScorer`, and replies per
  request. It is the ONLY thread that touches the device, so the tier
  stores need no locking.

Responses are written by the scoring loop into the request's
connection under a per-connection lock; a write to a dead client is
counted (``serve_shed{reason=dead_client}``) and the connection
closed — a client death never disturbs the loop.

Exit discipline matches the training driver (``cli/__init__.py``):
SIGTERM/SIGINT latch a :class:`~photon_ml_tpu_torch.utils.preempt
.StopController` flag, the loop stops admitting, drains the queue, and
the process exits ``75`` (requeue me: a supervisor relaunches it); ``--max-serve-seconds``/``--stop-file`` drain the same way but
exit ``0`` (a scheduled stop is a finished run); recognized terminal
faults exit ``3`` with a ``PHOTON_ABORT`` line.

**Zero-downtime hot-swap.** A ``swap`` request walks a state machine
that never blocks the hot path:

1. *load* — a loader thread reads + validates the candidate model dir
   through ``utils/retry`` at the ``serve.model_load`` fault point; a
   corrupt/truncated/unreadable candidate is REFUSED
   (``ModelSwapRefusedError`` in the ``swap_result``) and the service
   stays on its current generation;
2. *canary* — the device loop replays the last N live request batches
   (``--swap-canary-batches``) against the candidate, one replayed
   batch interleaved per loop iteration so live latency stays bounded,
   and gates the flip on trace_diff-style noise-aware score-diff
   bounds: a row only violates when its relative diff exceeds
   ``--swap-canary-threshold-pct`` AND its absolute diff clears
   ``--swap-canary-min-delta``; rows where both scores sit under
   ``--swap-canary-min-score`` are sub-noise and ignored;
3. *flip* — the atomic generation flip (``serve.swap`` fault point):
   new requests pin the new generation, in-flight batches complete
   and reply on the old one, and the old generation's device rows are
   released only after its last pinned batch drains;
4. *probation* — for ``--swap-probation-seconds`` after the flip, a
   p99 regression past the pre-flip watermark
   (``--swap-p99-regression-pct`` + ``--swap-p99-min-delta-ms``) or
   more than ``--swap-max-probation-sheds`` sheds trigger automatic
   ROLLBACK to the retained previous generation (reported via
   ``serve_swap{outcome=rolled_back}`` and ``stats`` —
   the ``swap_result`` reply already went out at flip time).

A SIGTERM that races an in-flight swap refuses the swap during the
drain and still exits 75 cleanly.

Run as ``python -m photon_ml_tpu_torch.serve.service`` or via
``python -m photon_ml_tpu_torch.tools.photon_serve``. On readiness the process prints one
``PHOTON_SERVE ready endpoint=<endpoint>`` line on stdout — with
``--listen 127.0.0.1:0`` the endpoint carries the kernel-assigned
port.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.serve.batcher import MicroBatcher, ScoreWork
from photon_ml_tpu_torch.serve.protocol import (
    SERVE_PROTO,
    encode,
    error_response,
    hello,
    parse_serve_endpoint,
    scores_response,
    swap_response,
)
from photon_ml_tpu_torch.serve.reqtrace import (
    ExemplarReservoir,
    HeadSampler,
    TraceIdMinter,
    child_span_id,
    observe_stage,
)
from photon_ml_tpu_torch.serve.scoring import GenerationStore, ServingScorer
from photon_ml_tpu_torch.utils.faults import InjectedFault, fault_point
from photon_ml_tpu_torch.utils.retry import RetryPolicy, call_with_retry

#: Completed-request horizon for the p50/p99/qps gauges.
_LATENCY_WINDOW = 1024
_QPS_HORIZON_SECS = 30.0

#: Candidate-model load retries (the swap loader thread): transient
#: I/O backs off and retries; a missing or corrupt candidate is
#: permanent and refuses the swap immediately.
_MODEL_LOAD_POLICY = RetryPolicy(max_attempts=4,
                                 base_delay_seconds=0.05,
                                 max_delay_seconds=1.0)


def _candidate_fault_path(model_dir: str) -> str:
    """A REGULAR FILE inside the candidate dir for the path-taking
    fault modes (``corrupt``/``partial`` flip bytes in a file; the
    model's artifacts live in nested coordinate dirs). Prefers the
    first coefficient Avro so an armed corruption breaks the load —
    or, failing that, the canary — deterministically."""
    files = []
    for root, dirs, names in os.walk(model_dir):
        dirs.sort()
        files.extend(os.path.join(root, n) for n in sorted(names))
    avro = [p for p in files if p.endswith(".avro")]
    if avro:
        return avro[0]
    return files[0] if files else model_dir


class _SwapTask:
    """One in-flight hot-swap walking load → canary → flip. Fields are
    filled progressively; ``state`` is written LAST by whichever thread
    advances it (loader thread: loading → loaded/load_failed; device
    loop: everything after)."""

    def __init__(self, request_id, send: Callable[[dict], bool],
                 model_dir: str, model_id: str):
        self.request_id = request_id
        self.send = send
        self.model_dir = model_dir
        self.model_id = model_id
        self.state = "loading"
        self.candidate = None        # (model, index_maps) once loaded
        self.error: Optional[BaseException] = None
        self.scorer: Optional[ServingScorer] = None
        self.replay: Optional[list] = None  # [(rows, base_scores)]
        self.canary_idx = 0
        self.checked_rows = 0
        self.violations: list[str] = []
        self.max_rel_pct = 0.0
        self.max_abs = 0.0

    def canary_report(self) -> Optional[dict]:
        if self.replay is None:
            return None
        return {"batches": self.canary_idx,
                "checked_rows": self.checked_rows,
                "max_rel_pct": round(self.max_rel_pct, 6),
                "max_abs": round(self.max_abs, 9),
                "violations": list(self.violations)}


class ServeService:
    """Socket front + device loop around one :class:`ServingScorer`."""

    def __init__(self, scorer: ServingScorer, batcher: MicroBatcher,
                 listen: str, model_id: str = "game-model",
                 registry: MetricsRegistry = REGISTRY, warn=None,
                 loader: Optional[Callable] = None,
                 make_scorer: Optional[Callable] = None,
                 canary_batches: int = 8,
                 canary_threshold_pct: float = 100.0,
                 canary_min_delta: float = 1e-3,
                 canary_min_score: float = 1e-3,
                 probation_secs: float = 5.0,
                 probation_p99_pct: float = 100.0,
                 probation_p99_min_ms: float = 50.0,
                 probation_max_sheds: int = 0,
                 trace_sample_rate: float = 0.05,
                 exemplar_slots: int = 8,
                 exemplar_path: Optional[str] = None):
        self.gens = GenerationStore(scorer, model_id, registry=registry)
        self.batcher = batcher
        self.model_id = model_id  # the BOOT model id; stats track gens
        self._registry = registry
        self._warn = warn or (lambda msg: None)
        self._lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._closed = False
        self._started_at = time.monotonic()
        self._latencies_ms: list[float] = []
        self._done_times: list[float] = []
        # -- hot-swap state (device loop unless noted) -------------------
        self._loader = loader          # model_dir -> (model, index_maps)
        self._make_scorer = make_scorer  # (model, maps, gen) -> scorer
        self._canary_threshold_pct = float(canary_threshold_pct)
        self._canary_min_delta = float(canary_min_delta)
        self._canary_min_score = float(canary_min_score)
        self._probation_secs = float(probation_secs)
        self._probation_p99_pct = float(probation_p99_pct)
        self._probation_p99_min_ms = float(probation_p99_min_ms)
        self._probation_max_sheds = int(probation_max_sheds)
        self._replay: deque = deque(maxlen=max(int(canary_batches), 0))
        self._swap_lock = threading.Lock()  # guards _swap hand-off
        self._swap: Optional[_SwapTask] = None
        self._probation: Optional[dict] = None
        self.last_swap: Optional[dict] = None
        # -- request tracing (serve/reqtrace.py) -------------------------
        # Every score request gets a trace identity (locally minted when
        # the wire carries none) so the slowest-N exemplar reservoir can
        # name its keeps; ``sampled`` additionally gates tracer-span
        # emission and the reply's trace_id echo. Stage timing feeds
        # ``serve_stage_ms`` for EVERY completed request.
        self._sampler = HeadSampler(trace_sample_rate)
        self._minter = TraceIdMinter()
        self._exemplars = ExemplarReservoir(max(int(exemplar_slots), 1))
        self._exemplar_path = exemplar_path
        self._exemplar_spilled_gen = 0
        self._exemplar_last_spill = 0.0
        # boot marker for the status plane: generation + model id ride
        # a span (a no-op while no tracer is enabled)
        with trace.span("serve.generation", generation=1,
                        model_id=model_id):
            pass
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

    # -- socket front (accept + reader threads) -------------------------

    def start(self) -> None:
        # daemonic and never joined — no reference kept (an always-on
        # service must not grow a Thread object per accepted connection)
        threading.Thread(target=self._accept_loop,
                         name="serve-accept", daemon=True).start()

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
                             name="serve-conn", daemon=True).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        wlock = threading.Lock()
        alive = [True]
        member_role: Optional[int] = None  # fleet-router connection?

        def send(obj: dict) -> bool:
            with wlock:
                if not alive[0]:
                    return False
                try:
                    conn.sendall(encode(obj))
                    return True
                except OSError:
                    # the client died with replies owed — account for it
                    # and stop writing; the reader loop ends on its own
                    alive[0] = False
                    self._registry.counter("serve_shed").inc(
                        reason="dead_client")
                    return False

        gen = self.gens.generation
        send(hello(self.gens.model_id(gen),
                   list(self.gens.scorer(gen).model.models),
                   generation=gen))
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
                try:
                    # request-plane faults are CONNECTION-scoped: the
                    # request fails, the service keeps serving
                    fault_point("serve.request", tag=kind)
                except (InjectedFault, OSError) as e:
                    self._registry.counter("serve_errors").inc(
                        kind=type(e).__name__)
                    send(error_response(rid, f"{type(e).__name__}: {e}"))
                    break
                if kind == "ping":
                    send({"kind": "pong", "proto": SERVE_PROTO})
                elif kind == "stats":
                    send({"kind": "stats", "proto": SERVE_PROTO,
                          **self.stats()})
                elif kind == "member":
                    # fleet-router member-role handshake: the ack is
                    # the router's verified hello (generation-checked
                    # admission happens on the router side)
                    member_role = int(msg.get("member") or 0)
                    gen = self.gens.generation
                    send({"kind": "member_ack", "proto": SERVE_PROTO,
                          "member": member_role, "generation": gen,
                          "model_id": self.gens.model_id(gen)})
                elif kind == "score":
                    if member_role is not None:
                        try:
                            # routed-plane faults fire in the member,
                            # per routed sub-request — the router must
                            # retry/fail over/shed, never black-hole
                            fault_point("serve.route",
                                        tag=str(member_role))
                        except (InjectedFault, OSError) as e:
                            self._registry.counter("serve_errors").inc(
                                kind=type(e).__name__)
                            send(error_response(
                                rid, f"{type(e).__name__}: {e}"))
                            continue
                    # pin at admission: the response is scored entirely
                    # by the generation that was current RIGHT NOW,
                    # even if a flip lands while the work is queued
                    recv_ns = time.perf_counter_ns()
                    wire_tid = msg.get("trace_id")
                    parent = msg.get("parent_span")
                    if wire_tid is not None:
                        # the caller (fleet router or a tracing client)
                        # already decided to trace this request
                        trace_id, sampled = str(wire_tid), True
                    else:
                        trace_id = self._minter.mint()
                        sampled = self._sampler.should_sample()
                    parent = str(parent) if parent is not None else None
                    pin = self.gens.pin()
                    work = ScoreWork(rows=list(msg.get("rows") or []),
                                     request_id=rid, reply=send,
                                     generation=pin,
                                     trace_id=trace_id,
                                     span_id=child_span_id(
                                         trace_id, "serve.request",
                                         parent or 0),
                                     parent_span=parent,
                                     sampled=sampled,
                                     read_ns=recv_ns)
                    shed = self.batcher.submit(work)
                    if shed is not None:
                        self.gens.unpin(pin)
                        send(error_response(
                            rid, f"shed:{shed}",
                            trace_id=trace_id if sampled else None))
                        if sampled:
                            trace.record_span(
                                "serve.request", recv_ns,
                                time.perf_counter_ns(),
                                trace_id=trace_id,
                                span_id=work.span_id,
                                parent=parent,
                                rows=len(work.rows),
                                outcome=f"shed:{shed}")
                elif kind == "swap":
                    self._request_swap(msg, send)
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

    # -- the device loop ------------------------------------------------

    @property
    def scorer(self) -> ServingScorer:
        """The CURRENT generation's scorer (live view)."""
        return self.gens.scorer()

    def serve_loop(self, stop) -> Optional[str]:
        """Score until ``stop`` fires, then drain the queue and return
        the stop reason. The caller owns the exit code. Each iteration
        interleaves one hot-swap step (loader hand-off, one canary
        batch, the flip, probation checks, retired-generation reaping)
        between live batches — the swap machinery shares the device
        thread, which is what bounds the flip's latency blackout."""
        reason: Optional[str] = None
        draining = False
        while True:
            if not draining:
                reason = stop.should_stop()
                if reason is not None:
                    draining = True
                    self.batcher.close()  # shed new work, keep the queue
                    # a swap racing the drain is refused, never flipped
                    self._abort_swap("service draining")
            batch = self.batcher.next_batch(
                timeout=0.02 if draining else 0.2)
            if batch:
                self._score_batch(batch)
            elif draining:
                self._maybe_spill_exemplars(force=True)
                return reason
            if not draining:
                self._step_swap()
                self._check_probation()
                self._maybe_spill_exemplars()
            for scorer in self.gens.reap():
                # the retired generation's last pinned batch drained:
                # release its device rows (device loop = the only
                # device-touching thread)
                scorer.release_device()

    def _score_batch(self, batch: list[ScoreWork]) -> None:
        from photon_ml_tpu_torch.cli import clean_abort_types

        # the batcher never mixes generations in one batch, so the
        # head's pin names the scorer for every work item (0 =
        # untagged direct submission: score against current)
        scorer = self.gens.scorer(batch[0].generation)
        stages: dict = {}
        try:
            fault_point("serve.batch", tag=str(len(batch)))
            all_rows = [r for w in batch for r in w.rows]
            formed_ns = time.perf_counter_ns()
            scores, uids = scorer.score_records(all_rows, stages=stages)
            scored_ns = time.perf_counter_ns()
        except InjectedFault:
            raise  # process-scoped: the clean-abort contract applies
        except clean_abort_types():
            raise
        except Exception as e:  # bad rows must not kill the loop
            self._registry.counter("serve_errors").inc(
                kind=type(e).__name__)
            for w in batch:
                w.reply(error_response(
                    w.request_id, f"{type(e).__name__}: {e}",
                    trace_id=w.trace_id if w.sampled else None))
                if w.sampled:
                    trace.record_span(
                        "serve.request", w.read_ns,
                        time.perf_counter_ns(),
                        trace_id=w.trace_id, span_id=w.span_id,
                        parent=w.parent_span, rows=len(w.rows),
                        outcome=f"error:{type(e).__name__}")
                if w.generation:
                    self.gens.unpin(w.generation)
            return
        # retain the batch for the shadow-scoring canary: the next
        # swap candidate replays these rows against these base scores
        if self._replay.maxlen:
            self._replay.append((all_rows, np.asarray(scores)))
        # gauges BEFORE replies: a client that reads stats right after
        # its scores must see its own request reflected in the SLOs
        now = time.monotonic()
        for w in batch:
            self._latencies_ms.append((now - w.enqueued_at) * 1000.0)
            self._done_times.append(now)
        del self._latencies_ms[:-_LATENCY_WINDOW]
        self._update_slo_gauges(now)
        # and the stages up to the scores (the reply stage times the
        # write, so it is observed after it)
        for w in batch:
            self._observe_stages(w, formed_ns, scored_ns, stages)
        off = 0
        for w in batch:
            k = len(w.rows)
            reply_ns = time.perf_counter_ns()
            w.reply(scores_response(
                w.request_id, scores[off:off + k],
                uids[off:off + k] if uids is not None else None,
                trace_id=w.trace_id if w.sampled else None))
            if w.generation:
                self.gens.unpin(w.generation)
            off += k
            self._finish_request_trace(w, formed_ns, scored_ns,
                                       stages, reply_ns,
                                       time.perf_counter_ns())

    def _update_slo_gauges(self, now: float) -> None:
        """p50/p99/qps as process gauges, read by ``stats``."""
        horizon = now - _QPS_HORIZON_SECS
        self._done_times = [t for t in self._done_times if t >= horizon]
        window = min(_QPS_HORIZON_SECS,
                     max(now - self._started_at, 1e-3))
        self._registry.gauge("serve_qps").set(
            len(self._done_times) / window)
        lat = np.asarray(self._latencies_ms)
        self._registry.gauge("serve_p50_ms").set(
            float(np.percentile(lat, 50)))
        self._registry.gauge("serve_p99_ms").set(
            float(np.percentile(lat, 99)))

    # -- request tracing -------------------------------------------------

    def _observe_stages(self, w: ScoreWork, formed_ns: int,
                        scored_ns: int, stages: dict) -> None:
        """One ``serve_stage_ms{stage}`` observation per stage up to the
        scores, for EVERY request (sampling never gates stage timing).

        ``tier_gather``/``device_score`` are batch-level costs — every
        request in the batch waited on them, so each observes the full
        duration; the span tree renders them as contiguous segments
        after batch formation (an attribution convention, not a
        per-request measurement)."""
        for stage, ns in (
                ("batch_form", formed_ns - w.picked_ns),
                ("tier_gather", int(stages.get("tier_gather", 0))),
                ("device_score", int(stages.get("device_score", 0)))):
            observe_stage(stage, ns / 1e6, self._registry)

    def _finish_request_trace(self, w: ScoreWork, formed_ns: int,
                              scored_ns: int, stages: dict,
                              reply_ns: int, end_ns: int) -> None:
        """One replied request's trace bookkeeping: the ``reply`` stage's
        observation; when sampled, the ``serve.request`` span plus its
        stage children on the tracer; and, with a trace directory, an
        offer to the slowest-N exemplar reservoir, whose record carries
        the full stage-event tree whether or not the request was
        sampled."""
        observe_stage("reply", (end_ns - reply_ns) / 1e6, self._registry)
        seq = w.span_id or 0
        gather_ns = int(stages.get("tier_gather", 0))
        device_ns = int(stages.get("device_score", 0))
        stage_spans = (
            ("serve.queue_wait", w.enqueued_ns, w.picked_ns),
            ("serve.batch_form", w.picked_ns, formed_ns),
            ("serve.tier_gather", formed_ns, formed_ns + gather_ns),
            ("serve.device_score", scored_ns - device_ns, scored_ns),
            ("serve.reply", reply_ns, end_ns),
        )
        if w.sampled:
            # serve.queue_wait was emitted at batch pickup
            for name, s_ns, e_ns in stage_spans[1:]:
                trace.record_span(
                    name, s_ns, e_ns, depth=1,
                    trace_id=w.trace_id,
                    span_id=child_span_id(w.trace_id, name, seq),
                    parent=w.span_id)
            trace.record_span(
                "serve.request", w.read_ns, end_ns,
                trace_id=w.trace_id, span_id=w.span_id,
                parent=w.parent_span, rows=len(w.rows), outcome="ok")
        tracer = trace.get_tracer()
        if tracer is None or self._exemplar_path is None:
            return
        tid = threading.get_ident()
        events = [{"name": "serve.request", "tid": tid, "depth": 0,
                   "ts_us": tracer.rel_ts_us(w.read_ns),
                   "dur_us": (end_ns - w.read_ns) / 1e3,
                   "labels": {"trace_id": w.trace_id,
                              "span_id": w.span_id,
                              "parent": w.parent_span,
                              "rows": len(w.rows), "outcome": "ok"}}]
        for name, s_ns, e_ns in stage_spans:
            events.append({
                "name": name, "tid": tid, "depth": 1,
                "ts_us": tracer.rel_ts_us(s_ns),
                "dur_us": (e_ns - s_ns) / 1e3,
                "labels": {"trace_id": w.trace_id,
                           "span_id": child_span_id(w.trace_id, name,
                                                    seq),
                           "parent": w.span_id}})
        self._exemplars.offer(
            (end_ns - w.read_ns) / 1e6,
            {"trace_id": w.trace_id,
             "request_id": str(w.request_id),
             "sampled": w.sampled,
             "latency_ms": (end_ns - w.read_ns) / 1e6,
             "events": events})

    def _maybe_spill_exemplars(self, force: bool = False) -> None:
        """Rewrite ``exemplars.jsonl`` when the reservoir changed
        (throttled to ~2 Hz; an atomic replace, so a reader never sees a
        torn file). At most N records, beside ``spans.jsonl`` on the same
        tracer timeline."""
        if self._exemplar_path is None:
            return
        now = time.monotonic()
        if not force and now - self._exemplar_last_spill < 0.5:
            return
        gen = self._exemplars.generation()
        if gen == self._exemplar_spilled_gen:
            return
        self._exemplar_last_spill = now
        self._exemplar_spilled_gen = gen
        tmp = self._exemplar_path + ".tmp"
        try:
            with open(tmp, "w") as fh:
                for rec in self._exemplars.snapshot():
                    fh.write(json.dumps(rec) + "\n")
            os.replace(tmp, self._exemplar_path)
        except OSError:
            pass  # drop-only: the exemplar spill never hurts serving

    # -- the hot-swap state machine -------------------------------------

    def _request_swap(self, msg: dict, send: Callable[[dict], bool]
                      ) -> None:
        """Reader-thread entry: validate, register the task, and hand
        the load to a loader thread (never the hot path)."""
        rid = msg.get("id")
        model_dir = msg.get("model_dir")

        def refuse(reason: str) -> None:
            send(swap_response(rid, "refused", self.gens.generation,
                               self.gens.model_id(), reason=reason))

        if not model_dir:
            refuse("swap request carries no model_dir")
            return
        if self._loader is None or self._make_scorer is None:
            refuse("this service was started without swap support")
            return
        task = _SwapTask(rid, send, model_dir,
                         msg.get("model_id")
                         or os.path.basename(os.path.normpath(model_dir)))
        with self._swap_lock:
            if self._swap is not None:
                # a busy refusal is not a swap OUTCOME: last_swap and
                # the counters keep the in-flight swap's story
                refuse("a swap is already in progress")
                return
            self._swap = task
        threading.Thread(target=self._swap_load, args=(task,),
                         name="serve-swap-load", daemon=True).start()

    def _swap_load(self, task: _SwapTask) -> None:
        """Loader thread: disk I/O + validation only — no device work.
        ``serve.model_load`` fires inside the retry wrapper, so
        transient injected I/O errors retry exactly like real ones."""
        def load():
            fault_point("serve.model_load", tag=task.model_id,
                        path=_candidate_fault_path(task.model_dir))
            return self._loader(task.model_dir)

        try:
            task.candidate = call_with_retry(
                load, "serve.model_load", policy=_MODEL_LOAD_POLICY)
            task.state = "loaded"
        except Exception as e:
            task.error = e
            task.state = "load_failed"

    def _step_swap(self) -> None:
        """One swap step per device-loop iteration: resolve a finished
        load, score ONE canary batch, or flip — live batches run
        between steps, which bounds the swap's latency blackout."""
        with self._swap_lock:  # the reader-thread hand-off point
            task = self._swap
        if task is None:
            return
        if task.state == "load_failed":
            self._finish_swap(task, "refused",
                              reason=f"model load failed: "
                                     f"{type(task.error).__name__}: "
                                     f"{task.error}")
            return
        if task.state == "loaded":
            # candidate scorer construction touches the device → here
            model, index_maps = task.candidate
            try:
                task.scorer = self._make_scorer(
                    model, index_maps, self.gens.next_generation)
            except Exception as e:
                self._finish_swap(task, "refused",
                                  reason=f"candidate scorer: "
                                         f"{type(e).__name__}: {e}")
                return
            task.replay = list(self._replay)
            task.state = "canary"
        if task.state == "canary":
            if task.canary_idx < len(task.replay):
                rows, base = task.replay[task.canary_idx]
                task.canary_idx += 1
                try:
                    cand, _ = task.scorer.score_records(rows)
                except Exception as e:
                    self._finish_swap(task, "refused",
                                      reason=f"canary scoring failed: "
                                             f"{type(e).__name__}: {e}")
                    return
                self._canary_check(task, base, cand)
                if task.violations:
                    self._finish_swap(
                        task, "refused",
                        reason=f"canary: {task.violations[0]}")
                    return
                if task.canary_idx < len(task.replay):
                    return  # next canary batch next iteration
            task.state = "flip"
        if task.state == "flip":
            self._flip(task)

    def _canary_check(self, task: _SwapTask, base, cand) -> None:
        """trace_diff's noise-aware verdict, applied per score: a row
        only violates when its RELATIVE diff exceeds the threshold AND
        its ABSOLUTE diff clears the floor; rows where both scores sit
        under the sub-noise floor are ignored entirely."""
        base = np.asarray(base, np.float64)
        cand = np.asarray(cand, np.float64)
        ref = np.maximum(np.abs(base), np.abs(cand))
        live = ref >= self._canary_min_score
        task.checked_rows += int(live.sum())
        if not live.any():
            return
        abs_diff = np.abs(cand - base)[live]
        rel_pct = 100.0 * abs_diff / ref[live]
        task.max_rel_pct = max(task.max_rel_pct, float(rel_pct.max()))
        task.max_abs = max(task.max_abs, float(abs_diff.max()))
        bad = ((rel_pct > self._canary_threshold_pct)
               & (abs_diff > self._canary_min_delta))
        if bad.any():
            task.violations.append(
                f"{int(bad.sum())} row(s) beyond "
                f"{self._canary_threshold_pct}% relative + "
                f"{self._canary_min_delta} absolute score-diff bounds "
                f"(max {float(rel_pct.max()):.3f}% / "
                f"{float(abs_diff.max()):.6g})")

    def _flip(self, task: _SwapTask) -> None:
        """The atomic generation flip + probation arming."""
        try:
            fault_point("serve.swap",
                        tag=str(self.gens.next_generation),
                        path=_candidate_fault_path(task.model_dir))
        except (InjectedFault, OSError) as e:
            self._finish_swap(task, "refused",
                              reason=f"flip: {type(e).__name__}: {e}")
            return
        baseline_p99 = float(
            self._registry.gauge("serve_p99_ms").value() or 0.0)
        from_gen = self.gens.generation
        self.gens.activate(task.scorer, task.model_id)
        self._probation = {
            "until": time.monotonic() + self._probation_secs,
            "from_generation": from_gen,
            "p99_baseline_ms": baseline_p99,
            "shed_baseline": self._registry.counter(
                "serve_shed").total(),
        }
        self._finish_swap(task, "ok")

    def _finish_swap(self, task: _SwapTask, outcome: str,
                     reason: Optional[str] = None) -> None:
        """Resolve the swap: reply, count, span, clear. Runs on the
        device loop, so a refused candidate's device rows are released
        here safely."""
        if outcome == "refused" and task.scorer is not None:
            task.scorer.release_device()
        gen = self.gens.generation
        # record BEFORE replying: a client that reads stats right
        # after its swap_result must see the outcome in last_swap
        self._record_swap(outcome, gen, reason=reason)
        task.send(swap_response(task.request_id, outcome, gen,
                                self.gens.model_id(), reason=reason,
                                canary=task.canary_report()))
        with self._swap_lock:
            self._swap = None

    def _abort_swap(self, reason: str) -> None:
        """Refuse whatever swap is in flight (drain/shutdown path). The
        loader thread may still be running; its task is orphaned and
        nothing steps it again."""
        with self._swap_lock:
            task, self._swap = self._swap, None
        if task is None:
            return
        if task.scorer is not None:
            task.scorer.release_device()
        gen = self.gens.generation
        self._record_swap("refused", gen, reason=reason)
        task.send(swap_response(task.request_id, "refused", gen,
                                self.gens.model_id(), reason=reason,
                                canary=task.canary_report()))

    def _check_probation(self) -> None:
        """Post-flip SLO watch: a p99 regression past the pre-flip
        watermark (noise-aware: relative AND absolute, the trace_diff
        rule again) or sheds beyond the budget roll back to the
        retained previous generation; surviving the window releases
        it."""
        p = self._probation
        if p is None:
            return
        sheds = (self._registry.counter("serve_shed").total()
                 - p["shed_baseline"])
        p99 = float(self._registry.gauge("serve_p99_ms").value() or 0.0)
        base = p["p99_baseline_ms"]
        regression: Optional[str] = None
        if sheds > self._probation_max_sheds:
            regression = (f"shed {int(sheds)} request(s) during "
                          f"probation (budget "
                          f"{self._probation_max_sheds})")
        elif (base > 0.0
              and p99 > base * (1.0 + self._probation_p99_pct / 100.0)
              and p99 - base > self._probation_p99_min_ms):
            regression = (f"p99 {p99:.1f}ms regressed past the "
                          f"{base:.1f}ms pre-flip watermark")
        if regression is not None:
            self._probation = None
            back = self.gens.rollback()
            self._warn(f"hot-swap probation failed ({regression}): "
                       f"rolled back to generation {back}")
            self._record_swap("rolled_back", back, reason=regression)
        elif time.monotonic() >= p["until"]:
            self._probation = None
            self.gens.release_previous()

    def _record_swap(self, outcome: str, generation: int,
                     reason: Optional[str] = None) -> None:
        """Count + span + ``last_swap`` (what ``stats`` reports)."""
        self._registry.counter("serve_swap").inc(outcome=outcome)
        self.last_swap = {"outcome": outcome, "reason": reason or "",
                          "generation": generation,
                          "model_id": self.gens.model_id()}
        with trace.span("serve.swap", outcome=outcome,
                        generation=generation,
                        model_id=self.gens.model_id(),
                        reason=reason or ""):
            pass

    # -- introspection / shutdown ---------------------------------------

    def stats(self) -> dict:
        g = self._registry.gauge
        gen = self.gens.generation
        return {
            "model_id": self.gens.model_id(gen),
            "generation": gen,
            "last_swap": self.last_swap,
            "endpoint": self.endpoint,
            "queue_depth": self.batcher.queue_depth(),
            "qps": g("serve_qps").value(),
            "p50_ms": g("serve_p50_ms").value(),
            "p99_ms": g("serve_p99_ms").value(),
            "uptime_secs": time.monotonic() - self._started_at,
            "stage_ms": self._stage_totals(),
            **self.gens.scorer(gen).stats(),
        }

    def _stage_totals(self) -> dict:
        """``serve_stage_ms`` per stage: count, sum, min and max of the
        observations (the heartbeat's ``metric_totals`` carry them too,
        under ``--trace-dir``)."""
        from photon_ml_tpu_torch.serve.reqtrace import STAGE_MS_BUCKETS

        hist = self._registry.histogram("serve_stage_ms",
                                        buckets=STAGE_MS_BUCKETS)
        return {r["labels"].get("stage", ""): {
            k: r[k] for k in ("count", "sum", "min", "max")}
            for r in hist.records()}

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
        self.batcher.close()
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


# ---------------------------------------------------------------------------
# entrypoint
# ---------------------------------------------------------------------------


def parse_args(argv: Sequence[str]) -> argparse.Namespace:
    from photon_ml_tpu_torch.cli.args import (
        add_device_flag,
        add_observability_flags,
        check_telemetry_flags,
    )

    p = argparse.ArgumentParser(
        prog="photon-serve",
        description="always-on GAME scoring service")
    p.add_argument("--game-model-input-dir", required=True)
    p.add_argument("--listen", default="127.0.0.1:0",
                   help="host:port (port 0 = kernel-assigned, printed "
                        "on the PHOTON_SERVE ready line) or "
                        "unix:/path.sock")
    p.add_argument("--feature-shard-id-to-feature-section-keys-map",
                   required=True)
    p.add_argument("--feature-shard-id-to-intercept-map", default="")
    p.add_argument("--feature-name-and-term-set-path")
    p.add_argument("--offheap-indexmap-dir")
    p.add_argument("--offheap-indexmap-num-partitions", type=int,
                   default=None)
    p.add_argument("--random-effect-id-set", default="",
                   help="comma-separated id types request rows carry")
    p.add_argument("--model-id", default="game-model")
    p.add_argument("--max-batch-rows", type=int, default=1024)
    p.add_argument("--max-queue-rows", type=int, default=8192,
                   help="admission bound; requests over it shed with "
                        "an error response, never queue-block")
    p.add_argument("--serve-hbm-budget-mb", type=float, default=64.0,
                   help="device-tier coefficient budget, split across "
                        "the random-effect coordinates")
    p.add_argument("--host-tier-entities", type=int, default=65536)
    p.add_argument("--serve-tier-dtype", choices=("f32", "bf16"),
                   default="f32",
                   help="device-tier storage dtype: bf16 halves row "
                        "bytes (~2x hot-tier capacity under the same "
                        "budget) at the cost of bf16-rounded "
                        "device-tier hits; host/model tiers stay f32")
    p.add_argument("--min-bucket", type=int, default=8,
                   help="smallest power-of-two pad bucket (batches of "
                        "1..min-bucket rows share one device shape)")
    p.add_argument("--swap-canary-batches", type=int, default=8,
                   help="live request batches retained and replayed "
                        "against a hot-swap candidate before the flip "
                        "(0 disables the canary)")
    p.add_argument("--swap-canary-threshold-pct", type=float,
                   default=100.0,
                   help="relative per-row score diff (percent) a "
                        "canary row must exceed to violate the gate")
    p.add_argument("--swap-canary-min-delta", type=float, default=1e-3,
                   help="absolute score-diff floor a violation must "
                        "ALSO clear (noise guard, trace_diff-style)")
    p.add_argument("--swap-canary-min-score", type=float, default=1e-3,
                   help="rows where |base| and |candidate| both sit "
                        "under this are sub-noise: ignored entirely")
    p.add_argument("--swap-probation-seconds", type=float, default=5.0,
                   help="post-flip window during which an SLO "
                        "regression rolls back to the previous "
                        "generation")
    p.add_argument("--swap-p99-regression-pct", type=float,
                   default=100.0,
                   help="relative p99 growth past the pre-flip "
                        "watermark that (with the absolute floor) "
                        "triggers rollback")
    p.add_argument("--swap-p99-min-delta-ms", type=float, default=50.0,
                   help="absolute p99 growth floor a probation "
                        "regression must also clear")
    p.add_argument("--swap-max-probation-sheds", type=int, default=0,
                   help="sheds tolerated during probation before "
                        "rollback")
    p.add_argument("--trace-sample-rate", type=float, default=0.05,
                   help="head-sampling rate for request tracing: this "
                        "fraction of direct-client score requests emit "
                        "full stage-span trees (deterministic pacing, "
                        "no RNG; wire-traced requests from the fleet "
                        "router are always traced; 0 disables, 1 "
                        "traces everything)")
    p.add_argument("--trace-exemplar-slots", type=int, default=8,
                   help="slowest-N exemplar reservoir size: the N "
                        "slowest requests keep full stage traces in "
                        "exemplars.jsonl regardless of the sample rate")
    p.add_argument("--max-serve-seconds", type=float, default=None,
                   help="scheduled stop: drain and exit 0 (SIGTERM "
                        "drains and exits 75 instead — requeue me)")
    p.add_argument("--stop-file")
    p.add_argument("--log-file",
                   help="service log path (default: photon-serve.log "
                        "under --trace-dir, else none)")
    add_observability_flags(p)
    add_device_flag(p)
    ns = p.parse_args(argv)
    check_telemetry_flags(p, ns)
    return ns


def main(argv: Optional[Sequence[str]] = None) -> None:
    from photon_ml_tpu_torch.cli import (
        clean_abort,
        clean_abort_types,
        preempted_exit,
    )
    from photon_ml_tpu_torch.cli.args import (
        parse_key_value_map,
        parse_section_keys_map,
    )
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.obs.run import start_observed_run_from_flags
    from photon_ml_tpu_torch.serve.scoring import (
        load_scoring_model,
        materialize_model,
        resolve_index_maps,
    )
    from photon_ml_tpu_torch.utils import parse_flag
    from photon_ml_tpu_torch.utils.logging import PhotonLogger
    from photon_ml_tpu_torch.utils.preempt import (
        PreemptionRequested,
        StopController,
    )

    ns = parse_args(argv if argv is not None else sys.argv[1:])
    # before any model is read: no CUDA is a RuntimeError, not a CPU run
    device = resolve_device(ns.device)
    log_path = ns.log_file or (
        os.path.join(ns.trace_dir, "photon-serve.log")
        if ns.trace_dir else None)
    logger = PhotonLogger(log_path, echo=False)

    section_keys = parse_section_keys_map(
        ns.feature_shard_id_to_feature_section_keys_map)
    intercept_map = {k: parse_flag(v)
                     for k, v in parse_key_value_map(
                         ns.feature_shard_id_to_intercept_map).items()}
    id_types = sorted({x.strip()
                       for x in ns.random_effect_id_set.split(",")
                       if x.strip()})

    # graceful stop BEFORE model load: a SIGTERM during a slow load
    # still drains (an empty queue) and exits with the documented code
    stop = StopController(max_train_seconds=ns.max_serve_seconds,
                          stop_file=ns.stop_file)
    stop.install_signal_handlers()
    # a supervised relaunch keeps the crashed incarnation's telemetry
    obs_run = start_observed_run_from_flags(
        ns, warn=logger.warn,
        preserve_existing=bool(os.environ.get("PHOTON_GAME_SUPERVISED")))
    service = None
    try:
        def load_model(model_dir):
            # the boot model and every swap candidate go through the same
            # flag-driven index-map resolution and materialized load
            maps = resolve_index_maps(
                section_keys, intercept_map,
                feature_set_path=ns.feature_name_and_term_set_path,
                offheap_dir=ns.offheap_indexmap_dir,
                offheap_partitions=ns.offheap_indexmap_num_partitions)
            model, maps = load_scoring_model(model_dir, maps)
            return materialize_model(model), maps

        model, index_maps = load_model(ns.game_model_input_dir)

        def build_scorer(model, index_maps, generation=1):
            scorer = ServingScorer(
                model, section_keys, index_maps, id_types=id_types,
                hbm_budget_bytes=int(
                    ns.serve_hbm_budget_mb * (1 << 20)),
                host_tier_entities=ns.host_tier_entities,
                tier_dtype=ns.serve_tier_dtype,
                min_bucket=ns.min_bucket,
                max_batch_rows=ns.max_batch_rows, device=device)
            scorer.generation = generation
            return scorer

        scorer = build_scorer(model, index_maps)
        batcher = MicroBatcher(max_queue_rows=ns.max_queue_rows,
                               max_batch_rows=ns.max_batch_rows)
        service = ServeService(
            scorer, batcher, ns.listen, model_id=ns.model_id,
            warn=logger.warn, loader=load_model,
            make_scorer=build_scorer,
            canary_batches=ns.swap_canary_batches,
            canary_threshold_pct=ns.swap_canary_threshold_pct,
            canary_min_delta=ns.swap_canary_min_delta,
            canary_min_score=ns.swap_canary_min_score,
            probation_secs=ns.swap_probation_seconds,
            probation_p99_pct=ns.swap_p99_regression_pct,
            probation_p99_min_ms=ns.swap_p99_min_delta_ms,
            probation_max_sheds=ns.swap_max_probation_sheds,
            trace_sample_rate=ns.trace_sample_rate,
            exemplar_slots=ns.trace_exemplar_slots,
            exemplar_path=(os.path.join(ns.trace_dir, "exemplars.jsonl")
                           if ns.trace_dir else None))
        service.start()
        logger.info(f"serving {ns.model_id} on {service.endpoint} "
                    f"({len(scorer.stores)} tiered coordinate(s), "
                    f"{device})")
        print(f"PHOTON_SERVE ready endpoint={service.endpoint}",
              flush=True)
        reason = service.serve_loop(stop)
        if reason and reason.startswith("signal:"):
            # external preemption: requeue-me semantics, like training
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
        logger.error(f"scoring service failed: {e}")
        if obs_run is not None:
            obs_run.set_exit_status("error",
                                    reason=f"{type(e).__name__}: {e}")
        raise
    finally:
        if service is not None:
            service.shutdown()
        stop.uninstall_signal_handlers()
        if obs_run is not None:
            obs_run.finish()
        logger.close()


if __name__ == "__main__":
    main()
