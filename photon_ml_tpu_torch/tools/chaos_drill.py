"""Chaos campaign over the port: sweep every registered fault point ×
applicable mode and assert the system's robustness invariants under each.

Port of ``tools/chaos_drill.py``: the same cell table, invariants, report
and exit codes, with every child a process of the port — the training
driver (``python -m photon_ml_tpu_torch.cli.game_training_driver``), the
scoring service and the fleet router (``photon_ml_tpu_torch.serve``), the
supervisor (``photon_ml_tpu_torch.tools.photon_supervise``, with
``--module`` or ``--fleet``) and the OTLP bridge
(``photon_ml_tpu_torch.tools.otlp_bridge``). It enumerates the port's
``utils/faults.FAULT_POINTS``, runs a short real GAME training
subprocess under each armed (point, mode) cell via ``PHOTON_FAULTS``,
and asserts the invariant matrix:

1. **Documented exit semantics** — the process ends rc 0 (possibly
   degraded), rc 3 with a ``PHOTON_ABORT`` line (clean abort), rc 75
   with a ``PHOTON_PREEMPTED`` line (graceful stop), or the injected
   kill's exit code. NEVER a stack-trace crash.
2. **Restorable checkpoint directory** — after every cell,
   ``CheckpointManager.restore()`` either returns a snapshot or raises
   one of its documented exceptions; stale ``.tmp`` litter is gone.
3. **Bit-exact resume** — after every ``kill`` or ``signal`` cell, a
   relaunch completes and its final objective equals the fault-free
   reference run's, float-for-float (the resume-anywhere contract).
4. **Surviving observability** — ``metrics.jsonl`` / ``spans.jsonl``
   parse line-complete even after a mid-write kill, and
   ``run_manifest.json`` exists.
5. **Cell-specific**: shard-corruption cells must complete with the
   shard QUARANTINED and ``data_coverage < 1`` recorded in
   ``metrics.json`` (degraded, not dead).

Also runs the acceptance scenario directly: a training run with one
deliberately corrupted Avro shard (no fault injection at all — real
bytes flipped on disk) must complete with the shard quarantined and
coverage reported.

Two differences from the JAX table, both about coverage:

- ``re.shard_dispatch=nan`` has a cell, which the JAX table lacks (its
  full run stops at its own coverage assertion): the random effect's
  entities in two shards (``--re-entity-shards 2``), the recovery ladder
  undamped, and the faulted run bit-exact to its own reference, as
  ``tests/test_re_sharding.py`` and ``tests/test_torch_re_sharding.py``
  define the fault. On the CPU the driver's mesh repeats the CPU once
  for each entity shard asked for (``parallel/mesh.mesh_devices``); on
  CUDA the cell needs N cards and is reported skipped on a host with
  fewer.
- ``worker.start`` is reported skipped, as the JAX campaign reports it:
  the JAX campaign defines no cell for it, and a gang member's death is
  drilled by ``chip_smoke.py`` phase 16 (c).

**Device.** ``--device`` defaults to ``cuda`` and every child gets it;
without CUDA the campaign raises ``RuntimeError`` before it writes a
fixture or starts a child (``--device cpu`` runs it on the CPU). The
fault-free reference and the serving fixture's reference scores are
computed on the same device as the cells.

Usage::

    python -m photon_ml_tpu_torch.tools.chaos_drill [--workdir DIR]
        [--smoke] [--points P1,P2] [--report PATH] [--device cpu]

``--smoke`` runs the curated tier-1 subset; the full campaign covers
every (point, mode) cell. Emits ``chaos_report.json`` and exits 0 on an
all-green matrix, 2 otherwise (``CHAOS_OK`` / ``CHAOS_FAIL``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from photon_ml_tpu_torch.tools.photon_supervise import _flag_value

#: the repository root: every child runs from it, so ``python -m`` finds
#: the port wherever the campaign was started
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

KILL_EXIT = 19
CLEAN_ABORT_EXIT = 3
PREEMPTED_EXIT = 75  # photon_ml_tpu_torch.cli.PREEMPTED_EXIT (EX_TEMPFAIL)
N_SHARDS = 4

TRAIN_MODULE = "photon_ml_tpu_torch.cli.game_training_driver"
SERVE_MODULE = "photon_ml_tpu_torch.serve.service"
ROUTER_MODULE = "photon_ml_tpu_torch.serve.router"
SUPERVISE_MODULE = "photon_ml_tpu_torch.tools.photon_supervise"
BRIDGE_MODULE = "photon_ml_tpu_torch.tools.otlp_bridge"

#: the one registered point with no cell, and why (reported skipped)
SKIPPED_POINTS = {
    "worker.start": "the JAX campaign defines no cell for it; a gang "
                    "member's death is drilled by chip_smoke.py phase "
                    "16 (c)",
}


# ---------------------------------------------------------------------------
# Workload fixture: tiny sharded GAME dataset + pre-built feature sets
# ---------------------------------------------------------------------------


def build_fixture(root: str) -> dict:
    """Synthetic 4-shard GAME input + feature name/term sets. Small
    enough that one driver run is a few seconds; sharded so shard-level
    quarantine has something to lose. The JAX campaign's fixture record
    for record (same seeds, sizes and records), written by the port's
    Avro writer: only the files' random sync markers differ. 4 x 40
    rows by 5 columns with the intercept is far under the fused
    kernel's gate, so no cell launches it."""
    import numpy as np

    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro import write_container

    game_schema = {
        "name": "GameRecord", "type": "record", "namespace": "chaos",
        "fields": [
            {"name": "uid", "type": ["null", "string"], "default": None},
            {"name": "response", "type": "double"},
            {"name": "offset", "type": ["null", "double"],
             "default": None},
            {"name": "weight", "type": ["null", "double"],
             "default": None},
            {"name": "metadataMap",
             "type": ["null", {"type": "map", "values": "string"}],
             "default": None},
            {"name": "globalFeatures",
             "type": {"type": "array", "items": schemas.FEATURE}},
            {"name": "userFeatures",
             "type": {"type": "array", "items": "FeatureAvro"}},
        ],
    }
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir, exist_ok=True)
    d_g, d_u, n_users, rows_per_shard = 4, 2, 5, 40
    w_rng = np.random.default_rng(7)
    w_g = w_rng.normal(size=d_g)
    W_u = w_rng.normal(size=(n_users, d_u))
    for shard in range(N_SHARDS):
        rng = np.random.default_rng(100 + shard)
        records = []
        for i in range(rows_per_shard):
            u = int(rng.integers(0, n_users))
            xg = rng.normal(size=d_g)
            xu = rng.normal(size=d_u)
            margin = xg @ w_g + xu @ W_u[u]
            y = float(rng.uniform() < 1.0 / (1.0 + np.exp(-margin)))
            records.append({
                "uid": f"s{shard}_{i}", "response": y, "offset": None,
                "weight": None, "metadataMap": {"userId": f"user{u}"},
                "globalFeatures": [
                    {"name": f"g{j}", "term": "", "value": float(xg[j])}
                    for j in range(d_g)],
                "userFeatures": [
                    {"name": f"u{j}", "term": "", "value": float(xu[j])}
                    for j in range(d_u)],
            })
        write_container(
            os.path.join(data_dir, f"part-{shard:05d}.avro"),
            game_schema, records)

    fs_dir = os.path.join(root, "feature_sets")
    os.makedirs(fs_dir, exist_ok=True)
    for section, dim in (("globalFeatures", d_g), ("userFeatures", d_u)):
        with open(os.path.join(fs_dir, section), "w") as fh:
            prefix = "g" if section == "globalFeatures" else "u"
            for j in range(dim):
                fh.write(f"{prefix}{j}\t\n")
    return {"data_dir": data_dir, "fs_dir": fs_dir}


def driver_args(data_dir: str, fs_dir: str, out_dir: str, ckpt_dir: str,
                trace_dir: str, device: str = "cuda") -> list[str]:
    """The JAX campaign's driver argv plus ``--device``."""
    # --telemetry-endpoint points at a unix socket NOBODY ever serves:
    # every cell (and the reference) trains under the live plane's
    # worst consumer — a permanently dead one — so the obs.export cells
    # drill the fault modes ON TOP of the dead-consumer fallback, and
    # the bit-exact checks prove the plane never touches training math
    return [
        "--telemetry-endpoint",
        "unix:" + os.path.join(trace_dir, "no_consumer.sock"),
        "--train-input-dirs", data_dir,
        "--output-dir", out_dir,
        "--task-type", "LOGISTIC_REGRESSION",
        "--feature-name-and-term-set-path", fs_dir,
        "--feature-shard-id-to-feature-section-keys-map",
        "global:globalFeatures|per_user:userFeatures",
        "--updating-sequence", "fixed,perUser",
        "--fixed-effect-data-configurations", "fixed:global,1",
        "--random-effect-data-configurations",
        "perUser:userId,per_user,1",
        "--fixed-effect-optimization-configurations",
        "fixed:10,1e-6,0.1,1,LBFGS,L2",
        "--random-effect-optimization-configurations",
        "perUser:10,1e-6,0.5,1,LBFGS,L2",
        "--num-iterations", "2",
        "--checkpoint-dir", ckpt_dir,
        "--checkpoint-every-coordinates", "1",
        "--recovery-policy", "skip",
        "--recovery-max-retries", "2",
        "--recovery-quarantine-after", "2",
        "--max-shard-loss-frac", "0.5",
        "--trace-dir", trace_dir,
        "--trace-heartbeat-seconds", "0.2",
        "--model-output-mode", "NONE",
        "--delete-output-dir-if-exists", "true",
        "--device", device,
    ]


# ---------------------------------------------------------------------------
# Cell matrix
# ---------------------------------------------------------------------------

#: expected ∈ {"ok", "degraded", "abort", "ok_or_abort", "killed",
#: "preempted"}.
#: "degraded" = rc 0 AND metrics.json records data_coverage < 1.
#: "preempted" = rc 75 + PHOTON_PREEMPTED line; resume is bit-exact.
CellDef = dict


def build_cells(smoke: bool) -> list[CellDef]:
    def cell(point, mode, spec, expected, smoke_cell=False,
             pre_run=False, note="", bit_exact=False,
             expect_drops=False, variant="", extra_args=None,
             bridge=False, serve=False):
        return {"point": point, "mode": mode, "spec": spec,
                "expected": expected, "smoke": smoke_cell,
                "pre_run": pre_run, "note": note,
                "bit_exact": bit_exact, "expect_drops": expect_drops,
                "variant": variant, "extra_args": extra_args or [],
                "bridge": bridge, "serve": serve}

    cells = [
        # --- I/O layer: retry → quarantine → coverage budget ----------
        cell("io.shard_open", "io_error", "io.shard_open=io_error:1",
             "ok", smoke_cell=True, note="one transient EIO: retried"),
        cell("io.shard_open", "flaky", "io.shard_open=flaky:999:0.7",
             "ok_or_abort",
             note="seeded flaky I/O; quarantine within or past budget"),
        cell("io.shard_open", "slow", "io.shard_open=slow:2:0.05", "ok"),
        cell("io.shard_open", "raise", "io.shard_open=raise:1", "ok"),
        cell("io.avro_read", "raise", "io.avro_read=raise:1", "ok",
             note="InjectedFault is retryable: recovered"),
        cell("io.avro_read", "io_error", "io.avro_read=io_error:1", "ok"),
        cell("io.avro_read", "corrupt", "io.avro_read=corrupt:1",
             "degraded", smoke_cell=True,
             note="shard bytes flipped on disk → quarantined"),
        cell("io.avro_read", "partial", "io.avro_read=partial:1",
             "degraded", note="shard truncated → quarantined"),
        cell("io.index_map", "raise", "io.index_map=raise:1", "ok"),
        cell("io.index_map", "io_error", "io.index_map=io_error:99",
             "abort", smoke_cell=True,
             note="feature maps are required state: clean abort"),
        # --- checkpoint write path ------------------------------------
        cell("ckpt.write_bytes", "enospc", "ckpt.write_bytes=enospc:1",
             "ok", note="transient full disk: rewrite recovered"),
        cell("ckpt.write_bytes", "io_error",
             "ckpt.write_bytes=io_error:99", "ok",
             note="persistently unwritable: snapshots skipped, "
                  "training continues"),
        cell("ckpt.write_bytes", "partial", "ckpt.write_bytes=partial:1",
             "ok", smoke_cell=True,
             note="torn write that still checksums: restore must fall "
                  "back past it"),
        cell("ckpt.write_bytes", "kill",
             f"ckpt.write_bytes=kill:1:{KILL_EXIT}", "killed",
             note="killed mid-write: stale .tmp cleaned on relaunch"),
        cell("ckpt.write_bytes", "signal",
             "ckpt.write_bytes=signal:1", "preempted",
             note="SIGTERM lands DURING a checkpoint write: the write "
                  "finishes, the run stops at the next barrier"),
        cell("ckpt.save", "raise", "ckpt.save=raise:1", "abort",
             note="post-write fault before rename fails the save "
                  "outright (documented drill semantics)"),
        cell("ckpt.save", "kill", f"ckpt.save=kill:1:{KILL_EXIT}",
             "killed",
             note="killed between fsync and rename (full campaign "
                  "only: smoke's kill+resume proof is cd.update=kill)"),
        cell("ckpt.restore", "raise", "ckpt.restore=raise:1", "abort",
             pre_run=True,
             note="restore drill fails outright → clean abort"),
        cell("ckpt.restore", "corrupt", "ckpt.restore=corrupt:1", "ok",
             pre_run=True,
             note="chosen step corrupted pre-read → falls back"),
        # --- training loop (recovery policy armed) --------------------
        cell("cd.update", "nan", "cd.update=nan:1", "ok",
             smoke_cell=True, note="poisoned update: damped retry"),
        cell("cd.update", "raise", "cd.update=raise:1", "ok"),
        cell("cd.update", "kill", f"cd.update@1.0=kill:1:{KILL_EXIT}",
             "killed", smoke_cell=True,
             note="killed mid-sweep: resume is bit-exact"),
        cell("cd.update", "delay", "cd.update=delay:1:0.2", "ok"),
        cell("cd.update", "signal", "cd.update@0.1=signal:1",
             "preempted", smoke_cell=True, variant="per_update",
             note="SIGTERM mid-update: latched, honored at the next "
                  "block barrier, resume bit-exact"),
        cell("cd.update", "signal", "cd.update@0.0=signal:1",
             "preempted", variant="mid_block",
             extra_args=["--cd-block-size", "2"],
             note="SIGTERM inside a 2-wide block: the WHOLE block "
                  "commits before the stop (barrier-only polling)"),
        cell("cd.sweep", "delay", "cd.sweep=delay:1:0.2", "ok"),
        cell("cd.sweep", "kill", f"cd.sweep@1=kill:1:{KILL_EXIT}",
             "killed"),
        cell("optimizer.gradient", "nan", "optimizer.gradient=nan:1",
             "ok"),
        cell("optimizer.gradient", "raise", "optimizer.gradient=raise:1",
             "ok"),
        # --- the mesh-sharded random effect: a cell the JAX table lacks
        # --- for a point the JAX registry has (see the module doc) ----
        cell("re.shard_dispatch", "nan", "re.shard_dispatch=nan:1", "ok",
             bit_exact=True,
             extra_args=["--re-entity-shards", "2",
                         "--recovery-damping", "1.0"],
             note="NaN on the sharded solve's coefficient block: the "
                  "recovery ladder retries undamped and the run lands "
                  "on its own unfaulted reference bit for bit "
                  "(tests/test_re_sharding.py:366-390, "
                  "tests/test_torch_re_sharding.py:317-330)"),
        # --- observability: must degrade, never kill ------------------
        cell("obs.flush", "io_error", "obs.flush=io_error:99", "ok",
             smoke_cell=True),
        cell("obs.flush", "enospc", "obs.flush=enospc:99", "ok"),
        cell("obs.flush", "flaky", "obs.flush=flaky:999:0.5", "ok"),
        # --- live telemetry plane: a dead/flaky/laggy consumer leaves
        # --- training exit-0 and BIT-EXACT, with only telemetry_dropped
        # --- as evidence anything was ever wrong ----------------------
        cell("obs.export", "io_error", "obs.export=io_error:99", "ok",
             smoke_cell=True, bit_exact=True, expect_drops=True,
             note="telemetry I/O hard down: batches dropped+counted, "
                  "training result bit-exact"),
        cell("obs.export", "slow", "obs.export=slow:20:0.05", "ok",
             bit_exact=True,
             note="laggy consumer path: writer thread absorbs the "
                  "latency, hot loop never blocks"),
        cell("obs.export", "flaky", "obs.export=flaky:999:0.5", "ok",
             bit_exact=True,
             note="seeded flaky telemetry I/O: retried or dropped, "
                  "never fatal"),
        # --- OTLP bridge: the fault point fires in the BRIDGE process
        # --- (training runs fault-free); the bridge posts to a dead
        # --- collector with the fault armed on top and must still exit
        # --- 0 with the batches dropped+counted, the training result
        # --- bit-exact either way ------------------------------------
        cell("obs.otlp", "io_error", "obs.otlp=io_error:99", "ok",
             smoke_cell=True, bridge=True, bit_exact=True,
             note="OTLP POST path hard down: batches dropped, bridge "
                  "exits 0, training untouched"),
        cell("obs.otlp", "flaky", "obs.otlp=flaky:999:0.5", "ok",
             bridge=True, bit_exact=True,
             note="seeded flaky collector I/O on top of a dead "
                  "collector: still dropped, still exit 0"),
        cell("obs.otlp", "slow", "obs.otlp=slow:20:0.05", "ok",
             bridge=True, bit_exact=True,
             note="laggy collector path: the bridge absorbs the "
                  "latency itself"),
        # --- scoring service: the fault point fires in a real
        # --- photon_serve subprocess; invariants are connection-scoped
        # --- failure (the service outlives its worst request) and the
        # --- batch-parity anchor (post-fault scores stay bit-identical
        # --- to the shared batch scoring core) -------------------------
        cell("serve.request", "io_error", "serve.request=io_error:1",
             "ok", serve=True,
             note="one request fails with an error response and drops "
                  "its connection; a fresh connection scores bit-exact"),
        cell("serve.batch", "io_error", "serve.batch=io_error:1", "ok",
             serve=True,
             note="one micro-batch fails, its requests get error "
                  "responses; the next batch scores bit-exact"),
        cell("serve.batch", "signal", "serve.batch=signal:1",
             "preempted", serve=True,
             note="SIGTERM lands during a batch: the batch completes "
                  "and replies, the service drains and exits 75"),
        cell("serve.batch", "kill",
             f"serve.batch=kill:1:{KILL_EXIT}", "killed", serve=True,
             note="killed mid-batch under photon_supervise --module: "
                  "relaunched (kill budget claimed across "
                  "incarnations), scores bit-exact after relaunch, "
                  "stop-file drains the supervisor to done"),
        # --- hot-swap: the swap state machine under fault; invariants
        # --- are "a refused swap leaves the CURRENT generation serving
        # --- bit-exact" and "a completed swap serves the candidate
        # --- bit-exact vs the shared batch core" -----------------------
        cell("serve.model_load", "io_error",
             "serve.model_load=io_error:1", "ok", serve=True,
             variant="swap_retry",
             note="one transient I/O error in the swap loader thread: "
                  "retried (utils/retry), the swap completes, the new "
                  "generation scores bit-exact"),
        cell("serve.model_load", "corrupt",
             "serve.model_load=corrupt:1", "ok", serve=True,
             variant="swap_refused",
             note="candidate coefficient bytes flipped on disk before "
                  "the load: the swap is REFUSED (load failure or "
                  "canary violation) and the service keeps serving "
                  "generation 1 bit-exact"),
        cell("serve.model_load", "slow", "serve.model_load=slow:1:3",
             "preempted", serve=True, variant="swap_drain_race",
             note="SIGTERM lands while the loader thread is stalled: "
                  "the drain refuses the in-flight swap and the "
                  "service still exits 75 cleanly"),
        cell("serve.swap", "io_error", "serve.swap=io_error:1", "ok",
             serve=True, variant="swap_flip_refused",
             note="I/O error at the atomic flip itself: the flip is "
                  "refused, the old generation keeps serving "
                  "bit-exact, and a RE-REQUESTED swap (budget spent) "
                  "completes"),
        cell("serve.swap", "kill",
             f"serve.swap=kill:1:{KILL_EXIT}", "killed", serve=True,
             note="killed mid-flip under photon_supervise --module: "
                  "the relaunch serves exactly one consistent "
                  "generation (the boot model) bit-exact; stop-file "
                  "drains the supervisor to done"),
        # --- scorer fleet: serve.route fires in the MEMBER process on
        # --- routed sub-requests (tag = fleet index), so what's
        # --- drilled is the ROUTER's machinery — bounded retry,
        # --- failover to the shard's fallback member, typed shed —
        # --- and its no-black-hole ledger --------------------------
        cell("serve.route", "io_error", "serve.route@1=io_error:1",
             "ok", serve=True, variant="fleet",
             note="member 1's routed sub-request EIOs once: retried "
                  "on the same member (budget spent), the request "
                  "answers bit-exact, no failover needed"),
        cell("serve.route", "flaky", "serve.route@1=flaky:6:0.5",
             "ok", serve=True, variant="fleet",
             note="seeded flaky member: flaky sub-requests retried "
                  "(or failed over), every request answered "
                  "bit-exact, zero typed errors"),
        cell("serve.route", "slow", "serve.route@1=slow:2:0.05",
             "ok", serve=True, variant="fleet",
             note="a slow member stalls well inside the router's "
                  "member timeout: requests complete bit-exact, "
                  "nothing sheds"),
        cell("serve.route", "kill",
             f"serve.route@1=kill:1:{KILL_EXIT}", "killed",
             serve=True, variant="fleet", smoke_cell=True,
             note="the no-black-hole drill: member 1 dies mid-request "
                  "under photon_supervise --fleet; every submitted "
                  "request is answered (request-id accounting — "
                  "scores or a typed error, zero silent drops), "
                  "answered scores bit-exact, and the relaunched "
                  "member re-admits onto the live generation"),
        # --- serve telemetry plane: fleet traffic with EVERY process
        # --- (members + router) pointed at a permanently dead
        # --- --telemetry-endpoint (a never-writable file: target —
        # --- the terminal mode past the dead-socket fallback) — no
        # --- fault spec, the dead consumer IS the chaos. Scores
        # --- bit-exact, ledger clean, the only evidence
        # --- telemetry_dropped{kind} counters ------------------------
        cell("serve.telemetry", "dead_consumer",
             "--telemetry-endpoint=<never-writable>", "ok",
             serve=True, variant="fleet_dead_telemetry",
             bit_exact=True, expect_drops=True,
             note="fleet traffic under a permanently dead telemetry "
                  "consumer: every request answers bit-exact, the "
                  "route ledger stays clean, and the only evidence is "
                  "telemetry_dropped counters in the run dirs"),
    ]
    if smoke:
        cells = [c for c in cells if c["smoke"]]
    return cells


# ---------------------------------------------------------------------------
# Invariant checks
# ---------------------------------------------------------------------------


def entity_shards_asked(args: list[str]) -> int:
    """The ``--re-entity-shards`` count an argv asks for (1 without it)."""
    value = _flag_value(args, "--re-entity-shards")
    return int(value) if value and value.isdigit() else 1


def _fault_fired(state_dir: str, point: str) -> bool:
    """Whether a firing of ``point`` claimed a marker in the cell's
    ``PHOTON_FAULTS_STATE_DIR``."""
    return os.path.isdir(state_dir) and any(
        n.startswith(point + "_") for n in os.listdir(state_dir))


def _run_driver(args, extra_env=None, timeout=240):
    env = dict(os.environ)
    env.pop("PHOTON_FAULTS", None)
    env.pop("PHOTON_FAULTS_STATE_DIR", None)
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-m", TRAIN_MODULE, *args],
        env=env, cwd=_REPO, text=True, capture_output=True,
        timeout=timeout)


def _final_objective(out_dir: str):
    with open(os.path.join(out_dir, "metrics.json")) as fh:
        record = json.load(fh)
    states = record["grid"][0]["states"]
    return record, (states[-1]["objective"] if states else None)


def _telemetry_dropped_total(trace_dir: str):
    """Sum of the telemetry_dropped counter's label sets in the run's
    final metrics snapshot (None when the stream is missing)."""
    path = os.path.join(trace_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    total = 0.0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            # photonlint: allow-WA02(a telemetry record's kind in metrics.jsonl, not a serve dispatch arm)
            if rec.get("kind") == "counter" \
                    and rec.get("name") == "telemetry_dropped":
                total += rec.get("value", 0.0)
    return total


def _check_no_traceback(proc, failures):
    if "Traceback (most recent call last)" in proc.stderr:
        failures.append("stack-trace crash:\n" + proc.stderr[-2000:])


def _check_checkpoint_restorable(ckpt_dir: str, failures):
    """Invariant 2: restore() returns or raises its DOCUMENTED
    exceptions; no stale .tmp dirs linger after a save/restore cycle."""
    from photon_ml_tpu_torch.utils.checkpoint import (
        CheckpointCorruptionError,
        CheckpointManager,
    )

    if not os.path.isdir(ckpt_dir):
        return
    mgr = CheckpointManager(ckpt_dir)
    try:
        mgr.restore()
    except (FileNotFoundError, CheckpointCorruptionError):
        pass
    except Exception as e:  # noqa: BLE001 — the assertion is the point
        failures.append(
            f"checkpoint dir not restorable: restore() raised "
            f"undocumented {type(e).__name__}: {e}")
    stale = [n for n in os.listdir(ckpt_dir) if n.endswith(".tmp")]
    if stale:
        failures.append(f"stale tmp dirs survive restore(): {stale}")


def _check_trace_survives(trace_dir: str, failures):
    """Invariant 4: every COMPLETE line of the jsonl streams parses and
    the manifest exists (a mid-write kill may tear the last line)."""
    if not os.path.isdir(trace_dir):
        failures.append("trace dir missing entirely")
        return
    if not os.path.exists(os.path.join(trace_dir, "run_manifest.json")):
        failures.append("run_manifest.json missing")
    for name in ("metrics.jsonl", "spans.jsonl"):
        path = os.path.join(trace_dir, name)
        if not os.path.exists(path):
            continue
        with open(path, "rb") as fh:
            raw = fh.read()
        for line in raw.split(b"\n")[:-1]:  # complete lines only
            if not line.strip():
                continue
            try:
                json.loads(line)
            except ValueError:
                failures.append(f"{name}: complete line does not parse: "
                                f"{line[:120]!r}")
                break


def run_cell(c: CellDef, fixture: dict, workdir: str,
             reference_objective, device: str = "cuda") -> dict:
    """One (point, mode) cell: arm via PHOTON_FAULTS, run the driver
    (every child on ``device``), assert the invariant matrix. Cells of
    distinct names work in distinct directories, so they may run side by
    side once the reference objective is known (serve cells read
    none)."""
    if c.get("serve"):
        return _run_serve_cell(c, workdir, device)
    name = f"{c['point']}={c['mode']}"
    if c.get("variant"):
        name += f"@{c['variant']}"
    cell_dir = os.path.join(
        workdir, "cells",
        name.replace("=", "_").replace(".", "_").replace("@", "_"))
    shutil.rmtree(cell_dir, ignore_errors=True)
    os.makedirs(cell_dir)
    # every cell gets its OWN copy of the input: corrupt/partial modes
    # mutate shards on disk and must not leak into other cells
    data_dir = os.path.join(cell_dir, "data")
    shutil.copytree(fixture["data_dir"], data_dir)
    out = os.path.join(cell_dir, "out")
    ckpt = os.path.join(cell_dir, "ckpt")
    tracked = os.path.join(cell_dir, "trace")
    args = driver_args(data_dir, fixture["fs_dir"], out, ckpt, tracked,
                       device)
    args += c.get("extra_args") or []
    failures: list[str] = []
    t0 = time.monotonic()

    if c.get("extra_args"):
        # extra flags (e.g. --cd-block-size) change the training math,
        # so the shared fault-free reference no longer anchors the
        # bit-exact check — this cell runs its own
        ref_out = os.path.join(cell_dir, "ref_out")
        ref = _run_driver(driver_args(
            data_dir, fixture["fs_dir"], ref_out,
            os.path.join(cell_dir, "ref_ckpt"),
            os.path.join(cell_dir, "ref_trace"), device)
            + c["extra_args"])
        if ref.returncode != 0:
            failures.append(f"cell reference run failed "
                            f"rc={ref.returncode}:\n{ref.stderr[-1000:]}")
        else:
            _, reference_objective = _final_objective(ref_out)

    if c["pre_run"]:  # seed checkpoints for restore-path cells
        pre = _run_driver(args)
        if pre.returncode != 0:
            failures.append(f"pre-run failed rc={pre.returncode}:\n"
                            f"{pre.stderr[-1000:]}")

    if c.get("bridge"):
        return _run_bridge_cell(c, name, args, tracked, out,
                                reference_objective, ckpt, failures, t0)

    state_dir = os.path.join(cell_dir, "fault_state")
    proc = _run_driver(args, extra_env={
        "PHOTON_FAULTS": c["spec"],
        "PHOTON_FAULTS_STATE_DIR": state_dir,
        "PHOTON_FAULTS_SEED": "42",
    })
    rc = proc.returncode
    _check_no_traceback(proc, failures)

    expected = c["expected"]
    outcome = "?"
    if expected == "killed":
        if rc != KILL_EXIT:
            failures.append(f"expected injected kill rc={KILL_EXIT}, "
                            f"got rc={rc}:\n{proc.stderr[-1000:]}")
        else:
            # invariant 3: relaunch (same env minus faults) resumes and
            # lands on the fault-free reference objective, float-exact
            resume = _run_driver(args)
            _check_no_traceback(resume, failures)
            if resume.returncode != 0:
                failures.append(
                    f"resume run failed rc={resume.returncode}:\n"
                    f"{resume.stderr[-1000:]}")
            else:
                _, obj = _final_objective(out)
                if obj != reference_objective:
                    failures.append(
                        f"resume NOT bit-exact: final objective {obj!r} "
                        f"vs reference {reference_objective!r}")
        outcome = "killed+resumed"
    elif expected == "preempted":
        if rc != PREEMPTED_EXIT:
            failures.append(f"expected graceful preemption "
                            f"rc={PREEMPTED_EXIT}, got rc={rc}:\n"
                            f"{proc.stderr[-1000:]}")
        elif "PHOTON_PREEMPTED" not in proc.stderr:
            failures.append(f"rc={PREEMPTED_EXIT} without a "
                            f"PHOTON_PREEMPTED line:\n"
                            f"{proc.stderr[-1000:]}")
        else:
            # same resume-anywhere contract as an injected kill, but
            # from the SAFE-POINT snapshot the stop path took itself
            resume = _run_driver(args)
            _check_no_traceback(resume, failures)
            if resume.returncode != 0:
                failures.append(
                    f"resume after preemption failed "
                    f"rc={resume.returncode}:\n{resume.stderr[-1000:]}")
            else:
                _, obj = _final_objective(out)
                if obj != reference_objective:
                    failures.append(
                        f"preempted resume NOT bit-exact: final "
                        f"objective {obj!r} vs reference "
                        f"{reference_objective!r}")
        outcome = "preempted+resumed"
    elif expected == "abort":
        if rc != CLEAN_ABORT_EXIT or "PHOTON_ABORT" not in proc.stderr:
            failures.append(
                f"expected clean abort rc={CLEAN_ABORT_EXIT} with "
                f"PHOTON_ABORT line, got rc={rc}:\n"
                f"{proc.stderr[-1000:]}")
        outcome = "clean_abort"
    elif expected in ("ok", "degraded", "ok_or_abort"):
        allowed = {0, CLEAN_ABORT_EXIT} if expected == "ok_or_abort" \
            else {0}
        if rc not in allowed:
            failures.append(f"expected rc in {sorted(allowed)}, got "
                            f"rc={rc}:\n{proc.stderr[-1500:]}")
        if rc == CLEAN_ABORT_EXIT and "PHOTON_ABORT" not in proc.stderr:
            failures.append("rc=3 without a PHOTON_ABORT line")
        if rc == 0 and expected == "degraded":
            record, _ = _final_objective(out)
            cov = record.get("data_coverage")
            lost = (record.get("ingest") or {}).get("train", {})
            lost = (lost or {}).get("shards_quarantined", [])
            if not (cov is not None and cov < 1.0 and lost):
                failures.append(
                    f"expected quarantined shard + coverage < 1, got "
                    f"coverage={cov} quarantined={lost}")
            outcome = f"degraded(coverage={cov})"
        else:
            outcome = {0: "ok", CLEAN_ABORT_EXIT: "clean_abort"}.get(
                rc, f"rc={rc}")
        if rc == 0 and c.get("bit_exact"):
            # the telemetry-plane contract: a broken consumer changes
            # NOTHING about the training result, float-for-float
            _, obj = _final_objective(out)
            if obj != reference_objective:
                failures.append(
                    f"result NOT bit-exact under {name}: final "
                    f"objective {obj!r} vs reference "
                    f"{reference_objective!r}")
        if rc == 0 and c.get("expect_drops"):
            drops = _telemetry_dropped_total(tracked)
            if not drops:
                failures.append(
                    "expected telemetry_dropped > 0 in the final "
                    f"metrics snapshot, found {drops!r}")
            else:
                outcome += f"+dropped({int(drops)})"
    if entity_shards_asked(args) > 1 \
            and not _fault_fired(state_dir, c["point"]):
        # a one-shard run never reaches the sharded dispatch: the cell
        # would pass without its fault
        failures.append(f"{c['spec']} never fired: the run did not "
                        f"dispatch the random effect sharded")

    # universal invariants for every cell
    _check_checkpoint_restorable(ckpt, failures)
    _check_trace_survives(tracked, failures)

    return {"cell": name, "spec": c["spec"], "expected": expected,
            "rc": rc, "outcome": outcome, "note": c["note"],
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


def _run_bridge_cell(c: CellDef, name: str, args: list[str],
                     tracked: str, out: str, reference_objective,
                     ckpt: str, failures: list[str], t0: float) -> dict:
    """An ``obs.otlp`` cell: the fault point lives in the BRIDGE
    process, not the driver. Train fault-free, then run
    the port's OTLP bridge over the run dir with the fault armed AND
    a dead collector, and assert: bridge rc 0 with its batches
    dropped+counted, training rc 0 and bit-exact."""
    proc = _run_driver(args)
    rc = proc.returncode
    _check_no_traceback(proc, failures)
    if rc != 0:
        failures.append(f"fault-free training run under bridge cell "
                        f"must exit 0, got rc={rc}:\n"
                        f"{proc.stderr[-1500:]}")
    elif c.get("bit_exact"):
        _, obj = _final_objective(out)
        if obj != reference_objective:
            failures.append(
                f"training result NOT bit-exact under {name}: final "
                f"objective {obj!r} vs reference "
                f"{reference_objective!r}")

    env = dict(os.environ)
    env.update({"PHOTON_FAULTS": c["spec"], "PHOTON_FAULTS_SEED": "42"})
    bridge = subprocess.run(
        [sys.executable, "-m", BRIDGE_MODULE,
         "--run-dir", tracked,
         # port 9 (discard) is closed on any sane host: the dead
         # collector every POST must survive
         "--collector", "http://127.0.0.1:9"],
        env=env, cwd=_REPO, text=True, capture_output=True, timeout=180)
    outcome = "bridge_survived"
    if bridge.returncode != 0:
        failures.append(
            f"bridge must exit 0 under {name} + dead collector, got "
            f"rc={bridge.returncode}:\n{bridge.stderr[-1500:]}")
    else:
        m = [w for w in bridge.stderr.split() if w.startswith("dropped=")]
        dropped = int(m[-1].split("=", 1)[1]) if m else None
        if not dropped:
            failures.append(
                f"bridge under a dead collector must report dropped "
                f"batches, stderr: {bridge.stderr[-400:]!r}")
        else:
            outcome += f"+dropped({dropped})"

    _check_checkpoint_restorable(ckpt, failures)
    _check_trace_survives(tracked, failures)
    return {"cell": name, "spec": c["spec"], "expected": c["expected"],
            "rc": rc, "outcome": outcome, "note": c["note"],
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


# ---------------------------------------------------------------------------
# Scoring-service cells
# ---------------------------------------------------------------------------

_SERVE_FIXTURE: dict = {}


def build_serve_fixture(workdir: str, device: str = "cuda") -> dict:
    """Tiny GAME model on disk + request rows + the reference scores
    computed HERE through the shared batch scoring core
    (`serve.scoring`, on ``device``, the services' device): the anchor
    every serve cell's bit-exactness check compares against. Also saves
    a second, "retrained" model (same structure, different coefficients)
    as the hot-swap candidate, with its own reference scores — the
    post-flip bit-exactness anchor. The JAX campaign's models and rows
    (same seed and draws), built with the port's model classes. Cached
    by (workdir, device): build it once before cells run side by
    side."""
    key = (workdir, device)
    if key in _SERVE_FIXTURE:
        return _SERVE_FIXTURE[key]
    import numpy as np
    import torch

    from photon_ml_tpu_torch.game.models import (
        FixedEffectModel,
        GameModel,
        RandomEffectModel,
    )
    from photon_ml_tpu_torch.io.data_format import game_dataset_from_records
    from photon_ml_tpu_torch.io.index_map import IndexMap
    from photon_ml_tpu_torch.io.model_io import save_game_model
    from photon_ml_tpu_torch.models.glm import (
        Coefficients,
        GeneralizedLinearModel,
    )
    from photon_ml_tpu_torch.optimize.config import TaskType
    from photon_ml_tpu_torch.serve.scoring import (
        load_scoring_model,
        score_game_dataset,
    )

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32)

    d_g, d_u, n_users = 4, 2, 6
    rng = np.random.default_rng(11)
    imaps = {
        "global": IndexMap.from_keys([f"g{j}" for j in range(d_g)],
                                     add_intercept=True),
        "user": IndexMap.from_keys([f"u{j}" for j in range(d_u)],
                                   add_intercept=True),
    }
    fixed = FixedEffectModel(GeneralizedLinearModel(
        Coefficients(f32(rng.normal(size=len(imaps["global"])))),
        TaskType.LINEAR_REGRESSION), "global")
    vocab = np.asarray([f"user{u}" for u in range(n_users)])
    re_model = RandomEffectModel(
        random_effect_type="userId", feature_shard_id="user",
        entity_codes=np.arange(n_users),
        coefficients=f32(rng.normal(size=(n_users, len(imaps["user"])))))
    model_dir = os.path.join(workdir, "serve_model")
    save_game_model(GameModel({"fixed": fixed, "per-user": re_model}),
                    model_dir, imaps, entity_vocabs={"userId": vocab})

    # the "retrained" candidate: identical structure/vocab, freshly
    # drawn coefficients (scores genuinely differ from the boot model)
    fixed_b = FixedEffectModel(GeneralizedLinearModel(
        Coefficients(f32(rng.normal(size=len(imaps["global"])))),
        TaskType.LINEAR_REGRESSION), "global")
    re_model_b = RandomEffectModel(
        random_effect_type="userId", feature_shard_id="user",
        entity_codes=np.arange(n_users),
        coefficients=f32(rng.normal(size=(n_users, len(imaps["user"])))))
    candidate_dir = os.path.join(workdir, "serve_model_retrained")
    save_game_model(
        GameModel({"fixed": fixed_b, "per-user": re_model_b}),
        candidate_dir, imaps, entity_vocabs={"userId": vocab})

    records = []
    for i in range(24):
        u = int(rng.integers(0, n_users))
        records.append({
            "uid": f"req_{i}",
            "metadataMap": {"userId": f"user{u}"},
            "globalFeatures": [
                {"name": f"g{j}", "term": "",
                 "value": float(rng.normal())} for j in range(d_g)],
            "userFeatures": [
                {"name": f"u{j}", "term": "",
                 "value": float(rng.normal())} for j in range(d_u)],
        })
    sections = {"global": ["globalFeatures"], "user": ["userFeatures"]}
    # reload model AND index maps from disk — the exact load the serve
    # subprocess performs, so the reference anchors the same mapping
    model, loaded_maps = load_scoring_model(model_dir, None)
    data = game_dataset_from_records(
        records, sections, loaded_maps, id_types=("userId",),
        response_required=False)
    ref = np.asarray(score_game_dataset(model, data, device), np.float64)
    model_b, maps_b = load_scoring_model(candidate_dir, None)
    data_b = game_dataset_from_records(
        records, sections, maps_b, id_types=("userId",),
        response_required=False)
    ref_b = np.asarray(score_game_dataset(model_b, data_b, device),
                       np.float64)
    fix = {"model_dir": model_dir, "records": records, "ref": ref,
           "candidate_dir": candidate_dir, "ref_candidate": ref_b,
           "device": device}
    _SERVE_FIXTURE[key] = fix
    return fix


def serve_args(model_dir: str, listen: str, trace_dir: str,
               extra: list[str] | None = None,
               device: str = "cuda") -> list[str]:
    return [
        "--device", device,
        "--game-model-input-dir", model_dir,
        "--listen", listen,
        "--feature-shard-id-to-feature-section-keys-map",
        "global:globalFeatures|user:userFeatures",
        "--random-effect-id-set", "userId",
        "--max-batch-rows", "64",
        "--trace-dir", trace_dir,
        "--trace-heartbeat-seconds", "0.2",
        *(extra or []),
    ]


def _spawn_serve(args: list[str], extra_env: dict | None = None):
    """Start a real serve subprocess, wait for its ready line, return
    ``(proc, endpoint)``."""
    env = dict(os.environ)
    env.pop("PHOTON_FAULTS", None)
    env.pop("PHOTON_FAULTS_STATE_DIR", None)
    env.update(extra_env or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", SERVE_MODULE, *args],
        env=env, cwd=_REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    line = proc.stdout.readline().strip()  # blocks through model load
    if not line.startswith("PHOTON_SERVE ready endpoint="):
        proc.kill()
        _, err = proc.communicate()
        raise RuntimeError(
            f"serve subprocess never became ready: {line!r}\n{err[-2000:]}")
    return proc, line.split("endpoint=", 1)[1]


def _serve_score_once(endpoint: str, records) -> dict:
    from photon_ml_tpu_torch.serve.protocol import ServeClient

    with ServeClient(endpoint) as client:
        return client.score(records)


def _serve_score_retry(endpoint: str, records, deadline_secs=120.0):
    """Score with reconnect retries — rides out a dead/relaunching
    service until the endpoint answers with real scores."""
    last: object = None
    deadline = time.monotonic() + deadline_secs
    while time.monotonic() < deadline:
        try:
            resp = _serve_score_once(endpoint, records)
            # photonlint: allow-WA02(a client checking a reply's kind, not a server dispatch arm)
            if resp.get("kind") == "scores":
                return resp
            last = resp
        except (ConnectionError, OSError) as e:
            last = e
        time.sleep(0.25)
    raise RuntimeError(f"service never answered with scores: {last!r}")


def _serve_metric_total(trace_dir: str, name: str):
    """The metric's value in the LAST ``metric_totals`` snapshot of the
    serve run's metrics stream (run_end preferred by position)."""
    path = os.path.join(trace_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    total = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("metric_totals") and name in rec["metric_totals"]:
                total = rec["metric_totals"][name]
    return total


def _run_serve_cell(c: CellDef, workdir: str, device: str = "cuda"
                    ) -> dict:
    """One scoring-service (point, mode) cell against a real
    photon_serve subprocess."""
    import numpy as np

    fix = build_serve_fixture(workdir, device)
    name = f"{c['point']}={c['mode']}"
    cell_dir = os.path.join(
        workdir, "cells", name.replace("=", "_").replace(".", "_"))
    shutil.rmtree(cell_dir, ignore_errors=True)
    os.makedirs(cell_dir)
    trace = os.path.join(cell_dir, "trace")
    sock = os.path.join(cell_dir, "serve.sock")
    failures: list[str] = []
    t0 = time.monotonic()
    ref = fix["ref"]
    records = fix["records"]
    expected = c["expected"]

    if c["point"] == "serve.route":
        if expected == "killed":
            return _run_fleet_kill_cell(c, name, fix, cell_dir,
                                        failures, t0)
        return _run_fleet_cell(c, name, fix, cell_dir, failures, t0)
    if c["point"] == "serve.telemetry":
        return _run_fleet_dead_telemetry_cell(c, name, fix, cell_dir,
                                              failures, t0)
    if c["point"] in ("serve.model_load", "serve.swap"):
        if expected == "killed":
            return _run_serve_swap_kill_cell(c, name, fix, cell_dir,
                                             trace, sock, failures, t0)
        return _run_serve_swap_cell(c, name, fix, cell_dir, trace, sock,
                                    failures, t0)
    if expected == "killed":
        return _run_serve_kill_cell(c, name, fix, cell_dir, trace, sock,
                                    failures, t0)

    env = {"PHOTON_FAULTS": c["spec"],
           "PHOTON_FAULTS_STATE_DIR": os.path.join(cell_dir, "fault_state"),
           "PHOTON_FAULTS_SEED": "42"}
    proc, endpoint = _spawn_serve(
        serve_args(fix["model_dir"], "unix:" + sock, trace,
                   device=fix["device"]), extra_env=env)
    rc = None
    outcome = "?"
    try:
        if expected == "preempted":
            # `signal` fires INSIDE the batch: the SIGTERM is latched,
            # the batch still completes and replies, then the service
            # drains and exits preempted
            resp = _serve_score_once(endpoint, records)
            if resp.get("kind") != "scores" or not np.array_equal(
                    np.asarray(resp["scores"], np.float64), ref):
                failures.append(
                    f"signal cell: the in-flight batch must complete "
                    f"bit-exact before the drain, got {str(resp)[:300]}")
            rc = proc.wait(timeout=90)
            if rc != PREEMPTED_EXIT:
                failures.append(f"expected drain to rc={PREEMPTED_EXIT}, "
                                f"got rc={rc}")
            outcome = "preempted(batch completed)"
        else:  # connection-scoped "ok" cells
            first = None
            try:
                first = _serve_score_once(endpoint, records)
            except (ConnectionError, OSError):
                pass  # the faulted connection may just drop
            # photonlint: allow-WA02(a client checking a reply's kind, not a server dispatch arm)
            if first is not None and first.get("kind") == "scores":
                failures.append(
                    f"fault {c['spec']} armed but the first score "
                    f"request succeeded")
            resp = _serve_score_retry(endpoint, records, deadline_secs=30)
            if not np.array_equal(
                    np.asarray(resp["scores"], np.float64), ref):
                failures.append(
                    "post-fault scores NOT bit-exact vs the shared "
                    "batch scoring core")
            proc.terminate()
            rc = proc.wait(timeout=90)
            if rc != PREEMPTED_EXIT:
                failures.append(f"SIGTERM drain must exit "
                                f"rc={PREEMPTED_EXIT}, got rc={rc}")
            outcome = "survived+bit_exact"
    except Exception as e:  # noqa: BLE001 — the report IS the handler
        failures.append(f"serve cell harness error: "
                        f"{type(e).__name__}: {e}")
    finally:
        if proc.poll() is None:
            proc.kill()
        _, err = proc.communicate()
    if "Traceback (most recent call last)" in err:
        failures.append("stack-trace crash:\n" + err[-2000:])
    if rc == PREEMPTED_EXIT and "PHOTON_PREEMPTED" not in err:
        failures.append(f"rc={PREEMPTED_EXIT} without a "
                        f"PHOTON_PREEMPTED line")
    _check_trace_survives(trace, failures)
    return {"cell": name, "spec": c["spec"], "expected": expected,
            "rc": rc, "outcome": outcome, "note": c["note"],
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


def _run_serve_kill_cell(c: CellDef, name: str, fix: dict, cell_dir: str,
                         trace: str, sock: str, failures: list[str],
                         t0: float) -> dict:
    """The supervisor-relaunch drill: photon_supervise --module runs the
    service; an injected kill lands mid-batch (budget claimed once via
    PHOTON_FAULTS_STATE_DIR, so the relaunch runs clean); the client
    rides the outage on reconnect retries; post-relaunch scores must be
    bit-exact; a stop file drains the supervisor to PHOTON_SUPERVISE_OK."""
    import numpy as np

    stop_file = os.path.join(cell_dir, "stop")
    args = serve_args(fix["model_dir"], "unix:" + sock, trace,
                      extra=["--stop-file", stop_file],
                      device=fix["device"])
    env = dict(os.environ)
    env.pop("PHOTON_FAULTS", None)
    env.pop("PHOTON_FAULTS_STATE_DIR", None)
    env.update({
        "PHOTON_FAULTS": c["spec"],
        "PHOTON_FAULTS_STATE_DIR": os.path.join(cell_dir, "fault_state"),
        "PHOTON_FAULTS_SEED": "42",
    })
    sup = subprocess.Popen(
        [sys.executable, "-m", SUPERVISE_MODULE,
         "--module", SERVE_MODULE,
         "--backoff-base", "0.2", "--run-dir", trace, "--", *args],
        env=env, cwd=_REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    rc = None
    outcome = "?"
    try:
        # the first scored batch trips the kill; keep retrying through
        # the death + relaunch until the second incarnation answers
        resp = _serve_score_retry("unix:" + sock, fix["records"],
                                  deadline_secs=150)
        if not np.array_equal(np.asarray(resp["scores"], np.float64),
                              fix["ref"]):
            failures.append("post-relaunch scores NOT bit-exact vs the "
                            "shared batch scoring core")
        with open(stop_file, "w") as fh:
            fh.write("chaos cell done\n")
        rc = sup.wait(timeout=120)
        outcome = "killed+relaunched"
    except Exception as e:  # noqa: BLE001 — the report IS the handler
        failures.append(f"serve kill cell harness error: "
                        f"{type(e).__name__}: {e}")
    finally:
        if sup.poll() is None:
            sup.kill()
        out, err = sup.communicate()
    if rc != 0:
        failures.append(f"supervisor must finish rc=0 after the "
                        f"stop-file drain, got rc={rc}:\n{err[-1500:]}")
    elif "PHOTON_SUPERVISE_OK" not in out:
        failures.append(f"no PHOTON_SUPERVISE_OK line: {out[-400:]!r}")
    else:
        m = [w for w in out.split() if w.startswith("restarts=")]
        restarts = int(m[-1].split("=", 1)[1]) if m else 0
        if restarts < 1:
            failures.append(
                "supervisor reports restarts=0 — the injected kill "
                "never cost an incarnation")
        else:
            outcome += f"(restarts={restarts})"
    if "Traceback (most recent call last)" in err:
        failures.append("stack-trace crash:\n" + err[-2000:])
    _check_trace_survives(trace, failures)
    return {"cell": name, "spec": c["spec"], "expected": c["expected"],
            "rc": rc, "outcome": outcome, "note": c["note"],
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


def _spawn_fleet_router(members: list[str], listen: str, trace: str,
                        extra_env: dict | None = None,
                        extra_args: list | None = None):
    """Start the fleet router subprocess, wait for its ready line
    (printed only after every reachable member admitted)."""
    env = dict(os.environ)
    env.pop("PHOTON_FAULTS", None)
    env.pop("PHOTON_FAULTS_STATE_DIR", None)
    env.update(extra_env or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", ROUTER_MODULE,
         "--listen", listen, "--members", ",".join(members),
         "--route-id", "userId", "--heartbeat-seconds", "0.1",
         "--trace-dir", trace, "--trace-heartbeat-seconds", "0.2",
         *(extra_args or [])],
        env=env, cwd=_REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    line = proc.stdout.readline().strip()
    if not line.startswith("PHOTON_SERVE ready endpoint="):
        proc.kill()
        _, err = proc.communicate()
        raise RuntimeError(
            f"fleet router never became ready: {line!r}\n{err[-2000:]}")
    return proc, line.split("endpoint=", 1)[1]


def _run_fleet_cell(c: CellDef, name: str, fix: dict, cell_dir: str,
                    failures: list[str], t0: float) -> dict:
    """serve.route ok-mode cells: a 2-member fleet behind the router;
    the fault fires in member 1 on routed sub-requests. The invariant
    is the no-black-hole ledger — every request answered with real
    scores (retry/failover absorb the fault), zero typed errors, zero
    sheds, bit-exact against the shared batch scoring core."""
    import numpy as np

    from photon_ml_tpu_torch.serve.protocol import ServeClient

    env = {"PHOTON_FAULTS": c["spec"],
           "PHOTON_FAULTS_STATE_DIR": os.path.join(cell_dir,
                                                   "fault_state"),
           "PHOTON_FAULTS_SEED": "42"}
    members, endpoints = [], []
    router = None
    rc = None
    outcome = "?"
    try:
        for k in range(2):
            proc, ep = _spawn_serve(serve_args(
                fix["model_dir"],
                "unix:" + os.path.join(cell_dir, f"m{k}.sock"),
                os.path.join(cell_dir, f"member{k}"),
                device=fix["device"]), extra_env=env)
            members.append(proc)
            endpoints.append(ep)
        router, endpoint = _spawn_fleet_router(
            endpoints, "unix:" + os.path.join(cell_dir, "router.sock"),
            os.path.join(cell_dir, "router"), extra_env=env)
        answered = 0
        with ServeClient(endpoint) as client:
            for i in range(6):
                resp = client.score(fix["records"])
                if resp.get("kind") != "scores":
                    failures.append(f"request {i} not answered with "
                                    f"scores: {str(resp)[:200]}")
                    continue
                answered += 1
                if not np.array_equal(
                        np.asarray(resp["scores"], np.float64),
                        fix["ref"]):
                    failures.append(f"request {i} NOT bit-exact vs "
                                    f"the shared batch scoring core")
            route = client.stats().get("route") or {}
        for bad in ("error", "shed"):
            if route.get(bad):
                failures.append(f"route ledger shows {bad}="
                                f"{route[bad]} — the fault must be "
                                f"absorbed by retry/failover")
        router.terminate()
        rc = router.wait(timeout=90)
        if rc != PREEMPTED_EXIT:
            failures.append(f"router SIGTERM drain must exit "
                            f"rc={PREEMPTED_EXIT}, got rc={rc}")
        outcome = f"absorbed(answered={answered}, route={route})"
    except Exception as e:  # noqa: BLE001 — the report IS the handler
        failures.append(f"fleet cell harness error: "
                        f"{type(e).__name__}: {e}")
    finally:
        err = ""
        if router is not None:
            if router.poll() is None:
                router.kill()
            _, err = router.communicate()
        for proc in members:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    if "Traceback (most recent call last)" in err:
        failures.append("router stack-trace crash:\n" + err[-2000:])
    _check_trace_survives(os.path.join(cell_dir, "router"), failures)
    return {"cell": name, "spec": c["spec"], "expected": c["expected"],
            "rc": rc, "outcome": outcome, "note": c["note"],
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


def _run_fleet_dead_telemetry_cell(c: CellDef, name: str, fix: dict,
                                   cell_dir: str, failures: list[str],
                                   t0: float) -> dict:
    """The serve-plane dead-consumer drill: a 2-member fleet plus the
    router, EVERY process pointed at a ``--telemetry-endpoint`` that
    can never accept a record. A dead SOCKET consumer diverts to the
    run-dir fallback stream (the training drill's standing posture),
    so this cell arms the terminal mode instead: a ``file:`` target
    whose parent is a regular file — every append fails ENOTDIR and
    every batch is drop-counted. No fault spec is armed — the dead
    consumer is the whole cell. Invariants: every request answers
    bit-exact against the shared batch scoring core, the route ledger
    shows zero errors/sheds, every process drains cleanly, and the
    only evidence anything was wrong is a non-zero
    ``telemetry_dropped`` total in each run dir."""
    import numpy as np

    from photon_ml_tpu_torch.serve.protocol import ServeClient

    blocked = os.path.join(cell_dir, "blocked")
    with open(blocked, "w") as fh:
        fh.write("not a directory\n")
    dead = "file:" + os.path.join(blocked, "telemetry.jsonl")
    members, endpoints = [], []
    router = None
    rc = None
    outcome = "?"
    try:
        for k in range(2):
            proc, ep = _spawn_serve(serve_args(
                fix["model_dir"],
                "unix:" + os.path.join(cell_dir, f"m{k}.sock"),
                os.path.join(cell_dir, f"member{k}"),
                extra=["--telemetry-endpoint", dead],
                device=fix["device"]))
            members.append(proc)
            endpoints.append(ep)
        router, endpoint = _spawn_fleet_router(
            endpoints, "unix:" + os.path.join(cell_dir, "router.sock"),
            os.path.join(cell_dir, "router"),
            extra_args=["--telemetry-endpoint", dead])
        answered = 0
        with ServeClient(endpoint) as client:
            for i in range(6):
                resp = client.score(fix["records"])
                if resp.get("kind") != "scores":
                    failures.append(f"request {i} not answered with "
                                    f"scores: {str(resp)[:200]}")
                    continue
                answered += 1
                if not np.array_equal(
                        np.asarray(resp["scores"], np.float64),
                        fix["ref"]):
                    failures.append(f"request {i} NOT bit-exact vs "
                                    f"the shared batch scoring core "
                                    f"under the dead consumer")
            route = client.stats().get("route") or {}
        for bad in ("error", "shed"):
            if route.get(bad):
                failures.append(f"route ledger shows {bad}="
                                f"{route[bad]} — a dead telemetry "
                                f"consumer must not touch scoring")
        # let at least one sink flush interval elapse so the dropped
        # batches are counted and a heartbeat carries the totals out
        time.sleep(1.0)
        router.terminate()
        rc = router.wait(timeout=90)
        if rc != PREEMPTED_EXIT:
            failures.append(f"router SIGTERM drain must exit "
                            f"rc={PREEMPTED_EXIT}, got rc={rc}")
        for proc in members:
            proc.terminate()
        for proc in members:
            mrc = proc.wait(timeout=90)
            if mrc != PREEMPTED_EXIT:
                failures.append(f"member SIGTERM drain must exit "
                                f"rc={PREEMPTED_EXIT}, got rc={mrc}")
        dropped = {}
        for role in ("member0", "member1", "router"):
            dropped[role] = _serve_metric_total(
                os.path.join(cell_dir, role), "telemetry_dropped")
            if not dropped[role]:
                failures.append(
                    f"{role}: expected a non-zero telemetry_dropped "
                    f"total as the dead-consumer evidence, got "
                    f"{dropped[role]!r}")
        outcome = (f"contained(answered={answered}, "
                   f"dropped={dropped})")
    except Exception as e:  # noqa: BLE001 — the report IS the handler
        failures.append(f"dead-telemetry cell harness error: "
                        f"{type(e).__name__}: {e}")
    finally:
        err = ""
        if router is not None:
            if router.poll() is None:
                router.kill()
            _, err = router.communicate()
        for proc in members:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    if "Traceback (most recent call last)" in err:
        failures.append("router stack-trace crash:\n" + err[-2000:])
    for role in ("member0", "member1", "router"):
        _check_trace_survives(os.path.join(cell_dir, role), failures)
    return {"cell": name, "spec": c["spec"], "expected": c["expected"],
            "rc": rc, "outcome": outcome, "note": c["note"],
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


def _run_fleet_kill_cell(c: CellDef, name: str, fix: dict,
                         cell_dir: str, failures: list[str],
                         t0: float) -> dict:
    """The fleet no-black-hole drill: photon_supervise --fleet runs 4
    members + the router; the injected kill (budget claimed once via
    PHOTON_FAULTS_STATE_DIR) drops member 1 mid-request under
    concurrent load. Request-id accounting proves zero silent drops:
    every submitted request gets a reply carrying its own id — real
    scores (bit-exact) or a typed error. The relaunched member must
    re-admit onto the live generation, and a stop-file drains the
    supervisor to PHOTON_SUPERVISE_OK."""
    import threading

    import numpy as np

    from photon_ml_tpu_torch.serve.protocol import ServeClient

    stop_file = os.path.join(cell_dir, "stop")
    fleet_dir = os.path.join(cell_dir, "fleet")
    rsock = os.path.join(cell_dir, "router.sock")
    env = dict(os.environ)
    env.pop("PHOTON_FAULTS", None)
    env.pop("PHOTON_FAULTS_STATE_DIR", None)
    env.update({
        "PHOTON_FAULTS": c["spec"],
        "PHOTON_FAULTS_STATE_DIR": os.path.join(cell_dir,
                                                "fault_state"),
        "PHOTON_FAULTS_SEED": "42",
    })
    sup = subprocess.Popen(
        [sys.executable, "-m", SUPERVISE_MODULE,
         "--fleet", "4", "--fleet-dir", fleet_dir,
         "--router-listen", "unix:" + rsock,
         "--stop-file", stop_file,
         "--backoff-base", "0.2", "--poll-seconds", "0.1", "--",
         "--game-model-input-dir", fix["model_dir"],
         "--feature-shard-id-to-feature-section-keys-map",
         "global:globalFeatures|user:userFeatures",
         "--random-effect-id-set", "userId",
         "--max-batch-rows", "64",
         "--trace-heartbeat-seconds", "0.2",
         "--device", fix["device"]],
        env=env, cwd=_REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    rc = None
    outcome = "?"
    ledger = {"submitted": 0, "scores": 0, "typed_errors": 0,
              "silent": 0, "not_bit_exact": 0}
    llock = threading.Lock()
    try:
        # wait for the router with rows member 1 does NOT own, so the
        # warm-up cannot consume the kill budget — member 1 dies later,
        # mid-request, under the concurrent load below
        from photon_ml_tpu_torch.serve.fleet import entity_shard
        warm = [r for r in fix["records"]
                if entity_shard(r["metadataMap"]["userId"], 4) != 1]
        _serve_score_retry("unix:" + rsock, warm[:2],
                           deadline_secs=150)

        def load_loop(worker: int) -> None:
            with ServeClient("unix:" + rsock, timeout=60) as client:
                for i in range(8):
                    rid = f"w{worker}r{i}"
                    with llock:
                        ledger["submitted"] += 1
                    try:
                        resp = client.request(
                            {"kind": "score", "id": rid,
                             "rows": fix["records"]})
                    except (ConnectionError, OSError):
                        with llock:
                            ledger["silent"] += 1
                        return
                    with llock:
                        if resp.get("id") != rid:
                            ledger["silent"] += 1
                        # photonlint: allow-WA02(a client checking a reply's kind, not a server dispatch arm)
                        elif resp.get("kind") == "scores":
                            ledger["scores"] += 1
                            if not np.array_equal(
                                    np.asarray(resp["scores"],
                                               np.float64),
                                    fix["ref"]):
                                ledger["not_bit_exact"] += 1
                        elif resp.get("error"):
                            ledger["typed_errors"] += 1
                        else:
                            ledger["silent"] += 1

        workers = [threading.Thread(target=load_loop, args=(w,))
                   for w in range(3)]
        for th in workers:
            th.start()
        for th in workers:
            th.join(timeout=120)
        if ledger["silent"]:
            failures.append(f"{ledger['silent']} request(s) "
                            f"black-holed: {ledger}")
        if ledger["scores"] + ledger["typed_errors"] \
                != ledger["submitted"]:
            failures.append(f"request-id accounting does not balance: "
                            f"{ledger}")
        if ledger["not_bit_exact"]:
            failures.append(f"{ledger['not_bit_exact']} answered "
                            f"request(s) NOT bit-exact vs the shared "
                            f"batch scoring core")

        # the relaunched member must RE-ADMIT onto the live generation
        deadline = time.monotonic() + 90
        states: dict = {}
        model_ids: set = set()
        while time.monotonic() < deadline:
            try:
                with ServeClient("unix:" + rsock, timeout=30) as cl:
                    fleet_stats = cl.stats().get("fleet") or {}
                ms = fleet_stats.get("members") or []
                states = {m["member"]: m["state"] for m in ms}
                model_ids = {m["model_id"] for m in ms
                             if m["model_id"] is not None}
                if ms and all(m["state"] == "healthy" for m in ms):
                    break
            except (ConnectionError, OSError):
                pass
            time.sleep(0.3)
        if not states or any(s != "healthy" for s in states.values()):
            failures.append(f"killed member never re-admitted: "
                            f"states={states}")
        if len(model_ids) > 1:
            failures.append(f"SPLIT FLEET: members serve "
                            f"{sorted(model_ids)}")
        with open(stop_file, "w") as fh:
            fh.write("chaos cell done\n")
        rc = sup.wait(timeout=120)
        outcome = (f"killed+relaunched(answered="
                   f"{ledger['scores']}+{ledger['typed_errors']}e"
                   f"/{ledger['submitted']})")
    except Exception as e:  # noqa: BLE001 — the report IS the handler
        failures.append(f"fleet kill cell harness error: "
                        f"{type(e).__name__}: {e}")
    finally:
        if sup.poll() is None:
            sup.kill()
        out, err = sup.communicate()
    if rc != 0:
        failures.append(f"fleet supervisor must finish rc=0 after the "
                        f"stop-file drain, got rc={rc}:\n{err[-1500:]}")
    elif "PHOTON_SUPERVISE_OK" not in out:
        failures.append(f"no PHOTON_SUPERVISE_OK line: {out[-400:]!r}")
    elif "relaunch_member" not in out:
        failures.append("supervisor log shows no member relaunch — "
                        "the injected kill never cost a member")
    if "Traceback (most recent call last)" in err:
        failures.append("stack-trace crash:\n" + err[-2000:])
    _check_trace_survives(os.path.join(fleet_dir, "router"), failures)
    return {"cell": name, "spec": c["spec"], "expected": c["expected"],
            "rc": rc, "outcome": outcome, "note": c["note"],
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


#: Hot-swap cells where the swap must COMPLETE open the canary gate —
#: the fixture candidate is a genuinely retrained model, so its scores
#: differ from the boot model's by design. Probation is kept short so
#: cells finish fast.
_SWAP_OPEN_GATE = ["--swap-canary-threshold-pct", "1e9",
                   "--swap-probation-seconds", "0.2"]

#: Refusal cells pair the fault with a TIGHT gate instead: a corrupt
#: candidate that still decodes to garbage coefficients must trip the
#: score-diff canary even when the load itself survives.
_SWAP_TIGHT_GATE = ["--swap-canary-threshold-pct", "5",
                    "--swap-canary-min-delta", "1e-4",
                    "--swap-probation-seconds", "0.2"]


def _serve_swap_once(endpoint: str, model_dir: str,
                     model_id: str = "retrained",
                     timeout: float = 120.0) -> dict:
    from photon_ml_tpu_torch.serve.protocol import ServeClient

    with ServeClient(endpoint, timeout=timeout) as client:
        return client.swap(model_dir, model_id=model_id)


def _serve_stats_once(endpoint: str) -> dict:
    from photon_ml_tpu_torch.serve.protocol import ServeClient

    with ServeClient(endpoint) as client:
        return client.stats()


def _run_serve_swap_cell(c: CellDef, name: str, fix: dict,
                         cell_dir: str, trace: str, sock: str,
                         failures: list[str], t0: float) -> dict:
    """Hot-swap (point, mode) cells: the fault fires somewhere in the
    load → canary → flip machine; the invariant is always that score
    traffic lands bit-exact on exactly ONE model — the boot model when
    the swap refuses, the candidate when it completes."""
    import threading

    import numpy as np

    # `corrupt` mutates the candidate ON DISK: every swap cell works
    # on a private copy so the shared fixture stays pristine
    candidate = os.path.join(cell_dir, "candidate_model")
    shutil.copytree(fix["candidate_dir"], candidate)
    env = {"PHOTON_FAULTS": c["spec"],
           "PHOTON_FAULTS_STATE_DIR": os.path.join(cell_dir,
                                                   "fault_state"),
           "PHOTON_FAULTS_SEED": "42"}
    variant = c["variant"]
    gate = (_SWAP_TIGHT_GATE if variant == "swap_refused"
            else _SWAP_OPEN_GATE)
    proc, endpoint = _spawn_serve(
        serve_args(fix["model_dir"], "unix:" + sock, trace, extra=gate,
                   device=fix["device"]),
        extra_env=env)
    rc = None
    outcome = "?"
    try:
        first = _serve_score_once(endpoint, fix["records"])
        if not np.array_equal(np.asarray(first["scores"], np.float64),
                              fix["ref"]):
            failures.append("pre-swap scores NOT bit-exact vs the "
                            "shared batch scoring core")
        if variant == "swap_drain_race":
            # the loader thread is stalled on the injected slow fault;
            # a SIGTERM during the stall must refuse the in-flight
            # swap and still drain to the documented exit
            result: dict = {}

            def _swap_in_background() -> None:
                try:
                    result["resp"] = _serve_swap_once(endpoint,
                                                      candidate)
                except (ConnectionError, OSError) as e:
                    result["error"] = e

            th = threading.Thread(target=_swap_in_background,
                                  daemon=True)
            th.start()
            time.sleep(0.8)  # well inside the 3 s injected stall
            proc.terminate()
            rc = proc.wait(timeout=90)
            th.join(timeout=30)
            resp = result.get("resp")
            if not isinstance(resp, dict) \
                    or resp.get("outcome") != "refused":
                failures.append(f"a swap racing the drain must resolve "
                                f"refused, got {result!r}")
            if rc != PREEMPTED_EXIT:
                failures.append(f"expected drain to "
                                f"rc={PREEMPTED_EXIT}, got rc={rc}")
            outcome = "preempted(swap refused on drain)"
        elif variant == "swap_refused":
            resp = _serve_swap_once(endpoint, candidate)
            if resp.get("outcome") != "refused":
                failures.append(f"corrupt candidate must be refused, "
                                f"got {str(resp)[:300]}")
            elif "ModelSwapRefusedError" not in resp.get("error", ""):
                failures.append(f"refusal carries no typed error: "
                                f"{str(resp)[:300]}")
            stats = _serve_stats_once(endpoint)
            if stats.get("generation") != 1:
                failures.append(f"refused swap must leave generation 1 "
                                f"current, got "
                                f"{stats.get('generation')!r}")
            after = _serve_score_once(endpoint, fix["records"])
            if not np.array_equal(
                    np.asarray(after["scores"], np.float64),
                    fix["ref"]):
                failures.append("scores after the refused swap NOT "
                                "bit-exact vs the boot model")
            proc.terminate()
            rc = proc.wait(timeout=90)
            if rc != PREEMPTED_EXIT:
                failures.append(f"SIGTERM drain must exit "
                                f"rc={PREEMPTED_EXIT}, got rc={rc}")
            outcome = f"refused({resp.get('reason', '')[:40]}...)"
        else:  # swap_retry / swap_flip_refused: the swap COMPLETES
            resp = _serve_swap_once(endpoint, candidate)
            if variant == "swap_flip_refused":
                # the injected flip fault refuses the FIRST attempt;
                # the re-request (budget spent) must complete
                if resp.get("outcome") != "refused" \
                        or "flip" not in resp.get("reason", ""):
                    failures.append(f"flip fault must refuse the first "
                                    f"swap, got {str(resp)[:300]}")
                mid = _serve_score_once(endpoint, fix["records"])
                if not np.array_equal(
                        np.asarray(mid["scores"], np.float64),
                        fix["ref"]):
                    failures.append("scores after the refused flip NOT "
                                    "bit-exact vs the boot model")
                resp = _serve_swap_once(endpoint, candidate)
            if resp.get("outcome") != "ok" \
                    or resp.get("generation") != 2:
                failures.append(f"swap must complete onto generation "
                                f"2, got {str(resp)[:300]}")
            after = _serve_score_once(endpoint, fix["records"])
            if not np.array_equal(
                    np.asarray(after["scores"], np.float64),
                    fix["ref_candidate"]):
                failures.append("post-swap scores NOT bit-exact vs the "
                                "candidate's batch reference")
            proc.terminate()
            rc = proc.wait(timeout=90)
            if rc != PREEMPTED_EXIT:
                failures.append(f"SIGTERM drain must exit "
                                f"rc={PREEMPTED_EXIT}, got rc={rc}")
            outcome = ("swapped(load retried)"
                       if variant == "swap_retry"
                       else "refused-then-swapped")
    except Exception as e:  # noqa: BLE001 — the report IS the handler
        failures.append(f"serve swap cell harness error: "
                        f"{type(e).__name__}: {e}")
    finally:
        if proc.poll() is None:
            proc.kill()
        _, err = proc.communicate()
    if "Traceback (most recent call last)" in err:
        failures.append("stack-trace crash:\n" + err[-2000:])
    if rc == PREEMPTED_EXIT and "PHOTON_PREEMPTED" not in err:
        failures.append(f"rc={PREEMPTED_EXIT} without a "
                        f"PHOTON_PREEMPTED line")
    if variant == "swap_retry" and not failures:
        retried = _serve_metric_total(trace, "retries")
        if not retried:
            failures.append(f"expected retries >= 1 in the final "
                            f"metric totals, found {retried!r}")
    _check_trace_survives(trace, failures)
    return {"cell": name, "spec": c["spec"], "expected": c["expected"],
            "rc": rc, "outcome": outcome, "note": c["note"],
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


def _run_serve_swap_kill_cell(c: CellDef, name: str, fix: dict,
                              cell_dir: str, trace: str, sock: str,
                              failures: list[str], t0: float) -> dict:
    """Killed mid-flip under photon_supervise: the injected kill fires
    at the atomic-flip fault point, the supervisor relaunches, and the
    relaunch must serve exactly ONE consistent generation — the boot
    model, bit-exact, reporting generation 1."""
    import numpy as np

    from photon_ml_tpu_torch.serve.protocol import ServeClient

    candidate = os.path.join(cell_dir, "candidate_model")
    shutil.copytree(fix["candidate_dir"], candidate)
    stop_file = os.path.join(cell_dir, "stop")
    args = serve_args(fix["model_dir"], "unix:" + sock, trace,
                      extra=[*_SWAP_OPEN_GATE,
                             "--stop-file", stop_file],
                      device=fix["device"])
    env = dict(os.environ)
    env.pop("PHOTON_FAULTS", None)
    env.pop("PHOTON_FAULTS_STATE_DIR", None)
    env.update({
        "PHOTON_FAULTS": c["spec"],
        "PHOTON_FAULTS_STATE_DIR": os.path.join(cell_dir,
                                                "fault_state"),
        "PHOTON_FAULTS_SEED": "42",
    })
    sup = subprocess.Popen(
        [sys.executable, "-m", SUPERVISE_MODULE,
         "--module", SERVE_MODULE,
         "--backoff-base", "0.2", "--run-dir", trace, "--", *args],
        env=env, cwd=_REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    rc = None
    outcome = "?"
    try:
        resp = _serve_score_retry("unix:" + sock, fix["records"],
                                  deadline_secs=150)
        if not np.array_equal(np.asarray(resp["scores"], np.float64),
                              fix["ref"]):
            failures.append("pre-swap scores NOT bit-exact")
        try:
            swap_resp = _serve_swap_once("unix:" + sock, candidate)
            # a reply at all means the kill never fired at the flip
            failures.append(f"injected kill at the flip never fired: "
                            f"swap resolved {str(swap_resp)[:200]}")
        except (ConnectionError, OSError):
            pass  # the process died mid-flip, as drilled
        # ride the relaunch: the second incarnation must come back on
        # the BOOT model — one consistent generation, bit-exact
        deadline = time.monotonic() + 150
        relaunch = None
        while time.monotonic() < deadline:
            try:
                with ServeClient("unix:" + sock) as client:
                    relaunch = (client.generation,
                                client.score(fix["records"]))
                break
            except (ConnectionError, OSError):
                time.sleep(0.25)
        if relaunch is None:
            failures.append("service never relaunched after the "
                            "mid-flip kill")
        else:
            gen, resp = relaunch
            if gen != 1:
                failures.append(f"relaunch must serve generation 1 "
                                f"(the boot model), got {gen!r}")
            if not np.array_equal(
                    np.asarray(resp["scores"], np.float64),
                    fix["ref"]):
                failures.append("post-relaunch scores NOT bit-exact vs "
                                "the boot model — the kill left a "
                                "mixed generation behind")
        with open(stop_file, "w") as fh:
            fh.write("chaos cell done\n")
        rc = sup.wait(timeout=120)
        outcome = "killed mid-flip+relaunched(gen 1)"
    except Exception as e:  # noqa: BLE001 — the report IS the handler
        failures.append(f"serve swap kill cell harness error: "
                        f"{type(e).__name__}: {e}")
    finally:
        if sup.poll() is None:
            sup.kill()
        out, err = sup.communicate()
    if rc != 0:
        failures.append(f"supervisor must finish rc=0 after the "
                        f"stop-file drain, got rc={rc}:\n{err[-1500:]}")
    elif "PHOTON_SUPERVISE_OK" not in out:
        failures.append(f"no PHOTON_SUPERVISE_OK line: {out[-400:]!r}")
    else:
        m = [w for w in out.split() if w.startswith("restarts=")]
        restarts = int(m[-1].split("=", 1)[1]) if m else 0
        if restarts < 1:
            failures.append("supervisor reports restarts=0 — the "
                            "injected kill never cost an incarnation")
        else:
            outcome += f"(restarts={restarts})"
    if "Traceback (most recent call last)" in err:
        failures.append("stack-trace crash:\n" + err[-2000:])
    _check_trace_survives(trace, failures)
    return {"cell": name, "spec": c["spec"], "expected": c["expected"],
            "rc": rc, "outcome": outcome, "note": c["note"],
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


def run_serve_canary_violation_scenario(workdir: str,
                                        device: str = "cuda") -> dict:
    """No injection: a hot-swap to a genuinely different model under a
    TIGHT canary gate. The shadow-scoring canary must refuse the flip
    — the service never leaves generation 1, and keeps scoring the
    boot model bit-exact."""
    import numpy as np

    fix = build_serve_fixture(workdir, device)
    cell_dir = os.path.join(workdir, "cells",
                            "scenario_serve_canary_violation")
    shutil.rmtree(cell_dir, ignore_errors=True)
    os.makedirs(cell_dir)
    trace = os.path.join(cell_dir, "trace")
    sock = os.path.join(cell_dir, "serve.sock")
    failures: list[str] = []
    t0 = time.monotonic()
    proc, endpoint = _spawn_serve(
        serve_args(fix["model_dir"], "unix:" + sock, trace,
                   extra=_SWAP_TIGHT_GATE, device=fix["device"]))
    rc = None
    reason = ""
    try:
        first = _serve_score_once(endpoint, fix["records"])
        if not np.array_equal(np.asarray(first["scores"], np.float64),
                              fix["ref"]):
            failures.append("pre-swap scores NOT bit-exact")
        resp = _serve_swap_once(endpoint, fix["candidate_dir"])
        reason = resp.get("reason", "")
        if resp.get("outcome") != "refused" or "canary" not in reason:
            failures.append(f"the canary gate must refuse the flip, "
                            f"got {str(resp)[:300]}")
        stats = _serve_stats_once(endpoint)
        if stats.get("generation") != 1:
            failures.append(f"a canary-refused service must stay on "
                            f"generation 1, got "
                            f"{stats.get('generation')!r}")
        if (stats.get("last_swap") or {}).get("outcome") != "refused":
            failures.append(f"last_swap must record the refusal, got "
                            f"{stats.get('last_swap')!r}")
        after = _serve_score_once(endpoint, fix["records"])
        if not np.array_equal(np.asarray(after["scores"], np.float64),
                              fix["ref"]):
            failures.append("scores after the refused swap NOT "
                            "bit-exact vs the boot model")
        proc.terminate()
        rc = proc.wait(timeout=90)
        if rc != PREEMPTED_EXIT:
            failures.append(f"SIGTERM drain must exit "
                            f"rc={PREEMPTED_EXIT}, got rc={rc}")
    except Exception as e:  # noqa: BLE001 — the report IS the handler
        failures.append(f"canary scenario harness error: "
                        f"{type(e).__name__}: {e}")
    finally:
        if proc.poll() is None:
            proc.kill()
        _, err = proc.communicate()
    if "Traceback (most recent call last)" in err:
        failures.append("stack-trace crash:\n" + err[-2000:])
    _check_trace_survives(trace, failures)
    return {"cell": "scenario.serve_canary_violation",
            "spec": "(retrained candidate under a tight canary gate — "
                    "no injection)",
            "expected": "refused", "rc": rc,
            "outcome": f"refused({reason[:48]})",
            "note": "acceptance scenario: a seeded canary "
                    "violation never flips",
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


def run_serve_dead_client_scenario(workdir: str,
                                   device: str = "cuda") -> dict:
    """No injection: a client sends a score request and vanishes without
    reading the reply. The service must count the dead client as shed
    (`serve_shed{reason=dead_client}`) and keep serving — the next
    connection scores bit-exact."""
    import socket

    import numpy as np

    fix = build_serve_fixture(workdir, device)
    cell_dir = os.path.join(workdir, "cells", "scenario_serve_dead_client")
    shutil.rmtree(cell_dir, ignore_errors=True)
    os.makedirs(cell_dir)
    trace = os.path.join(cell_dir, "trace")
    sock_path = os.path.join(cell_dir, "serve.sock")
    failures: list[str] = []
    t0 = time.monotonic()
    proc, endpoint = _spawn_serve(
        serve_args(fix["model_dir"], "unix:" + sock_path, trace,
                   device=fix["device"]))
    rc = None
    try:
        raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        raw.connect(sock_path)
        reader = raw.makefile("rb")
        reader.readline()  # server hello
        raw.sendall((json.dumps(
            {"kind": "score", "id": "doomed",
             "rows": fix["records"]}) + "\n").encode())
        # vanish before the reply: shutdown() severs the socket even
        # though the makefile() reader still holds a reference
        raw.shutdown(socket.SHUT_RDWR)
        reader.close()
        raw.close()
        resp = _serve_score_retry(endpoint, fix["records"],
                                  deadline_secs=30)
        if not np.array_equal(np.asarray(resp["scores"], np.float64),
                              fix["ref"]):
            failures.append("scores after the dead client NOT bit-exact "
                            "vs the shared batch scoring core")
        proc.terminate()
        rc = proc.wait(timeout=90)
        if rc != PREEMPTED_EXIT:
            failures.append(f"SIGTERM drain must exit "
                            f"rc={PREEMPTED_EXIT}, got rc={rc}")
    except Exception as e:  # noqa: BLE001 — the report IS the handler
        failures.append(f"dead-client scenario harness error: "
                        f"{type(e).__name__}: {e}")
    finally:
        if proc.poll() is None:
            proc.kill()
        _, err = proc.communicate()
    if "Traceback (most recent call last)" in err:
        failures.append("stack-trace crash:\n" + err[-2000:])
    shed = _serve_metric_total(trace, "serve_shed")
    if not shed:
        failures.append(f"expected serve_shed >= 1 in the final metric "
                        f"totals, found {shed!r}")
    _check_trace_survives(trace, failures)
    return {"cell": "scenario.serve_dead_client",
            "spec": "(client sends a score request and closes without "
                    "reading — no injection)",
            "expected": "ok", "rc": rc,
            "outcome": f"survived+shed({shed})",
            "note": "acceptance scenario: the service outlives "
                    "its worst client",
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


def run_corrupt_shard_scenario(fixture: dict, workdir: str,
                               device: str = "cuda") -> dict:
    """The acceptance scenario, with NO fault injection: one
    Avro shard's real bytes are flipped on disk; the training run must
    complete with the shard quarantined and coverage reported."""
    from photon_ml_tpu_torch.utils.faults import corrupt_path

    cell_dir = os.path.join(workdir, "cells", "scenario_corrupt_shard")
    shutil.rmtree(cell_dir, ignore_errors=True)
    os.makedirs(cell_dir)
    data_dir = os.path.join(cell_dir, "data")
    shutil.copytree(fixture["data_dir"], data_dir)
    corrupt_path(os.path.join(data_dir, "part-00002.avro"))
    out = os.path.join(cell_dir, "out")
    args = driver_args(data_dir, fixture["fs_dir"], out,
                       os.path.join(cell_dir, "ckpt"),
                       os.path.join(cell_dir, "trace"), device)
    failures: list[str] = []
    t0 = time.monotonic()
    proc = _run_driver(args)
    _check_no_traceback(proc, failures)
    cov = None
    if proc.returncode != 0:
        failures.append(f"run with one corrupt shard must complete, "
                        f"got rc={proc.returncode}:\n"
                        f"{proc.stderr[-1500:]}")
    else:
        record, _ = _final_objective(out)
        cov = record.get("data_coverage")
        lost = [q["path"] for q in
                (record.get("ingest") or {}).get("train", {})
                .get("shards_quarantined", [])]
        if cov is None or cov >= 1.0 or not any(
                "part-00002" in p for p in lost):
            failures.append(
                f"corrupt shard not quarantined/reported: "
                f"coverage={cov} lost={lost}")
    return {"cell": "scenario.corrupt_shard", "spec": "(real bytes "
            "flipped in part-00002.avro — no injection)",
            "expected": "degraded", "rc": proc.returncode,
            "outcome": f"degraded(coverage={cov})",
            "note": "acceptance scenario",
            "seconds": round(time.monotonic() - t0, 1),
            "failures": failures, "passed": not failures}


# ---------------------------------------------------------------------------
# Campaign driver
# ---------------------------------------------------------------------------


def check_device(device: str) -> None:
    """The device rule: ``RuntimeError`` for CUDA on a host without it
    (:func:`~photon_ml_tpu_torch.device.resolve_device`), before any
    fixture is written or child started."""
    from photon_ml_tpu_torch.device import resolve_device

    resolve_device(device)


def plan_cells(smoke: bool, points: list[str] | None = None,
               device: str = "cuda") -> tuple[list[CellDef], list[dict]]:
    """``(cells to run, skipped report entries)``. The full campaign
    asserts a cell for every registered point but
    :data:`SKIPPED_POINTS`. A cell whose argv asks for more entity shards
    than the host has cards is skipped on CUDA (on the CPU the driver's
    mesh repeats the CPU for each shard)."""
    import torch

    from photon_ml_tpu_torch.utils.faults import FAULT_POINTS

    cells = build_cells(smoke)
    if points:
        cells = [c for c in cells if c["point"] in points]
    covered = {c["point"] for c in cells}
    skipped = [{"cell": f"{p}=*", "outcome": "skipped",
                "note": SKIPPED_POINTS[p], "passed": True}
               for p in FAULT_POINTS
               if p in SKIPPED_POINTS and (not points or p in points)]
    if not smoke and not points:
        uncovered = set(FAULT_POINTS) - set(SKIPPED_POINTS) - covered
        assert not uncovered, \
            f"campaign has no cells for fault points: {sorted(uncovered)}"
    on_cuda = torch.device(device).type == "cuda"
    runnable = []
    for c in cells:
        need = entity_shards_asked(c["extra_args"])
        have = torch.cuda.device_count() if on_cuda and need > 1 else need
        if need > have:
            skipped.append({
                "cell": f"{c['point']}={c['mode']}", "spec": c["spec"],
                "outcome": "skipped",
                "note": f"needs {need} cards for its entity shards, this "
                        f"host has {have}",
                "passed": True})
        else:
            runnable.append(c)
    return runnable, skipped


def run_reference(fixture: dict, workdir: str, device: str = "cuda"):
    """The fault-free reference run, the resume bit-exactness anchor:
    its final objective."""
    ref_dir = os.path.join(workdir, "reference")
    shutil.rmtree(ref_dir, ignore_errors=True)
    args = driver_args(fixture["data_dir"], fixture["fs_dir"],
                       os.path.join(ref_dir, "out"),
                       os.path.join(ref_dir, "ckpt"),
                       os.path.join(ref_dir, "trace"), device)
    t0 = time.monotonic()
    ref = _run_driver(args)
    assert ref.returncode == 0, \
        (f"fault-free reference run failed rc={ref.returncode}\n"
         f"{ref.stdout[-1000:]}\n{ref.stderr[-2000:]}")
    _, reference_objective = _final_objective(os.path.join(ref_dir, "out"))
    print(f"chaos: reference run ok ({time.monotonic() - t0:.1f}s, "
          f"final objective {reference_objective})", flush=True)
    return reference_objective


def print_result(r: dict) -> None:
    print(f"chaos: [{'PASS' if r['passed'] else 'FAIL'}] "
          f"{r['cell']:<28} -> {r['outcome']} ({r['seconds']}s)",
          flush=True)
    for f in r["failures"]:
        print(f"chaos:        {f}", flush=True)


def run_campaign(workdir: str, smoke: bool,
                 points: list[str] | None = None,
                 report_path: str | None = None,
                 device: str = "cuda") -> int:
    check_device(device)
    cells, skipped = plan_cells(smoke, points, device)
    os.makedirs(workdir, exist_ok=True)
    fixture = build_fixture(workdir)
    reference_objective = run_reference(fixture, workdir, device)

    results = []
    for c in cells:
        r = run_cell(c, fixture, workdir, reference_objective, device)
        results.append(r)
        print_result(r)
    if not points:  # --points restricts to injection cells only
        scenarios = [run_corrupt_shard_scenario(fixture, workdir, device)]
        if not smoke:  # the serve scenarios need no training fixture
            scenarios.append(run_serve_dead_client_scenario(workdir,
                                                            device))
            scenarios.append(
                run_serve_canary_violation_scenario(workdir, device))
        for r in scenarios:
            results.append(r)
            print_result(r)
    return write_report(results, skipped, smoke, reference_objective,
                        report_path or os.path.join(workdir,
                                                    "chaos_report.json"))


def write_report(results: list[dict], skipped: list[dict], smoke: bool,
                 reference_objective, report_path: str) -> int:
    """Write ``chaos_report.json`` (the JAX campaign's shape), print
    ``CHAOS_OK`` / ``CHAOS_FAIL`` and return the exit code (0 / 2)."""
    results = list(results)
    results.extend(skipped)
    failed = [r for r in results if not r["passed"]]
    report = {
        "kind": "chaos_report",
        "smoke": smoke,
        "reference_objective": reference_objective,
        "cells_run": len([r for r in results
                          if r.get("outcome") != "skipped"]),
        "cells_failed": len(failed),
        "invariants": [
            "documented exit semantics (0 / 3+PHOTON_ABORT / "
            "75+PHOTON_PREEMPTED / kill code; never a stack-trace "
            "crash)",
            "checkpoint dir restorable after every cell (no stale .tmp)",
            "bit-exact resume after every kill or signal cell",
            "trace/metrics streams parse line-complete after any cell",
            "corrupt shards quarantine with recorded coverage",
            "a dead/flaky/laggy telemetry consumer leaves training "
            "exit-0 and bit-exact, with only telemetry_dropped as "
            "evidence (obs.export cells)",
            "a dead collector leaves the OTLP bridge exit-0 with its "
            "batches dropped+counted, and the run it watches exit-0 "
            "and bit-exact (obs.otlp cells)",
            "a permanently dead --telemetry-endpoint under fleet "
            "traffic leaves every answer bit-exact and every process "
            "draining cleanly, with only telemetry_dropped counters "
            "as evidence (serve.telemetry cell)",
            "a scoring-service fault is connection-scoped: the service "
            "outlives its worst request/client, post-fault scores stay "
            "bit-identical to the shared batch core, and an injected "
            "kill costs one supervised incarnation (serve.* cells)",
            "a hot-swap lands on exactly one model: refused swaps "
            "(corrupt candidate, canary violation, flip fault, drain "
            "race) leave the current generation serving bit-exact, "
            "completed swaps serve the candidate bit-exact, and a "
            "kill mid-flip relaunches onto one consistent generation "
            "(serve.model_load / serve.swap cells)",
        ],
        "cells": results,
    }
    with open(report_path, "w") as fh:
        json.dump(report, fh, indent=1)
    if failed:
        print(f"CHAOS_FAIL cells={len(results)} failed={len(failed)} "
              f"report={report_path}", flush=True)
        return 2
    print(f"CHAOS_OK cells={len(results)} "
          f"(skipped={len(skipped)}) report={report_path}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: fresh tempdir)")
    ap.add_argument("--smoke", action="store_true",
                    help="curated tier-1 subset")
    ap.add_argument("--points", default="",
                    help="comma-separated fault points to restrict to")
    ap.add_argument("--report", default=None,
                    help="where to write chaos_report.json")
    ap.add_argument("--device", default="cuda",
                    help="every child's --device (default cuda; never "
                         "falls back to the CPU)")
    args = ap.parse_args(argv)
    check_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_drill_")
    points = [p.strip() for p in args.points.split(",") if p.strip()]
    return run_campaign(workdir, smoke=args.smoke, points=points or None,
                        report_path=args.report, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
