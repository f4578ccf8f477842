#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU: build, check, drive.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. device — the card's name and power limit, TF32 off for matmuls and cuDNN.
2. build  — ``nvcc`` builds every kernel of the port from ``csrc/``, while
   two threads write the Avro fixtures of phases 6 and 7 (b) (joined
   before phase 4).
3. kernel — each kernel's wrapper on the card against its plain PyTorch
   version on the same inputs (every loss, f32 and bf16 X, ragged and exact
   small shapes that reach every geometry of the stream path and the
   staged path's unvectorised load, the GLMix fixed-effect shape and the
   262,144 x 2,048 shape), on every pass-1 path that takes the shape
   (the public wrapper on the path it picks, ``_launch`` on the other),
   bit-identical repeat calls on each path, autograd through the
   ``autograd.Function`` on each path, and the refusal of a stream request
   for a shape the stream path cannot take.
4. timing — CUDA-event medians of the kernel's wrapper, its plain
   version and the one-call-per-pass PyTorch yardstick, beside the HBM
   bound, two ways: one call at a time (``kernel_ms``, ``plain_ms``,
   ``library_ms``: a caller's single call, the host's work before the
   launch included) and ten calls back to back (``device_ms``,
   ``plain_device_ms``, ``library_device_ms``: the device's time per
   call, as long as the host issues a call faster than the device runs
   it, which ``host_ms`` shows). At the GLMix shape and at the legacy
   driver's 32,561 x 124 both pass-1 paths are timed in turns (stream,
   staged, staged, stream); the 262,144 x 2,048 shape is staged only.
5. glmix  — the port's library path at full width: MovieLens-1M-shaped
   data (1,000,209 rows, 6,040 users, 3,706 movies, 64 global features),
   a fixed-effect plus per-user logistic GLM, L-BFGS + L2, two coordinate
   descent sweeps on the card, then the published GameModel scores the
   data. Kernel launch counts are zeroed just before the run and read
   just after; every launch must have taken the stream path. A small
   GLMix also runs on the card and on the CPU, and the two must agree.
6. driver — the same GLMix through the port's own drivers at full size:
   the recipe written as GAME Avro by the port's writer (1,000,209
   training and 200,000 validation rows, full width, as 16 + 4 part files
   written by a pool of processes), ``cli.game_training_driver.run`` (the
   work of its ``main``) on the card (feature maps, Avro load, two sweeps
   with validation after every update, metrics.json, the GAME Avro
   model), then ``cli.game_scoring_driver`` in a process of its own on
   ``best/`` over the validation Avro (its peak host RSS is reported).
   Every part file must be decoded by the native columnar path
   (``io/data_format.py`` ``INGEST_STATS``: no decline), and one file of
   the same recipe and widths (the drill's 5,000-row validation file of
   phase 7 (b), cut from a 62,513-row training part for phase 17) is
   loaded by the records path too, timed against the native path and
   held equal to it array for array.
   The driver appends an intercept, so the fixed effect has 65 f32
   columns and its launches must all take the path ``kernel_path`` picks
   for them (staged); the scores must equal the library's score of the
   reloaded model, and the scoring driver's AUC the validation AUC that
   metrics.json records for the best state. Both drivers run traced
   (``--trace-dir``, ``--device-telemetry``): the training run streams
   live to a ``unix:`` consumer in this script, which must receive
   heartbeats while the driver runs; its spans must nest as the JAX
   package's driver nests them, its ``hbm_bytes`` peak gauge equal
   ``torch.cuda.max_memory_allocated()`` read just after the run, and one
   epilogue read count per update; the scoring run's endpoint has no
   consumer, so its trace directory holds all five files (the stream in
   ``telemetry.jsonl``). The host fetches per update by site, the span
   self-times and the traced wall time beside PR 12's untraced one are
   printed.
7. resume — (a) the glmix phase's data, coordinates built afresh, two
   sweeps with a checkpoint after every update and ``cd.update@1.1`` armed
   to raise; fresh coordinates resume from the restored snapshot at
   (sweep 1, coordinate 1), and their final states must equal phase 5's
   uninterrupted run bit for bit. (b) the crash/resume drill
   (``photon_ml_tpu_torch/tools/crash_resume_drill.py``) on the card: its
   uninterrupted reference role as a driver process on a 40,000 /
   5,000-row Avro fixture at full width, exit 0, launching the kernel on
   the path ``kernel_path`` picks for 65 f32 columns and reading every
   part through the native path (its scan and load seconds reported).
   Phase 17 holds the drill's other roles to this reference: (a) the
   preempt and relaunch roles' SIGTERM at update 0.1 through the
   supervisor, and a SIGKILLed driver resumed at full width; (c) the
   corrupt role on an all-corrupt copy of its snapshots. The crash and
   resume roles are cut for their time: 17 (a) resumes a SIGKILLed
   driver at this width and phase 18's smoke cell ``cd.update=kill``
   sends the drill's kill at an update, each held to its reference bit
   for bit.

8. second_order — TRON and OWL-QN (L1 / elastic net) on the card:
   (a) BASELINE config 2 at ``bench.py``'s shape (262,144 x 2,048 f32, the
   data of ``bench.py:169 _data()`` with a linear response): linear
   regression, TRON + L2 through ``GLMOptimizationProblem.run`` with
   variances (finite, positive), TRON's accepted values never rising, the
   solution equal to a solve with the kernel gated off within rel 1e-4;
   (b) BASELINE config 3 at ``bench.py:386-425``'s recipe (Poisson
   65,536 x 512, elastic net, OWL-QN): ``solve_ms``, ``iterations``,
   ``nnz_coefficients``, and a solve with the kernel gated off ending
   after as many iterations, with the same exact zeros, within rel 1e-4;
   (d) a small GLMix of each new solver on the card
   and on the CPU, objectives within rel 1e-4; a ``torch.profiler`` pass
   over one per-user update of L-BFGS, TRON and OWL-QN on phase 5's
   per-user coordinate (wall seconds, device busy time and idle share,
   solver reads); (c) the training driver twice on the drill's fixture
   (phase 7 (b), 40,000 / 5,000 rows: cut from phase 6's fixture to
   make room for phase 16) with phase 6's feature sets
   (linear TRON + L2 with ``--compute-variance``, Poisson L-BFGS +
   elastic net; two sweeps, 4 buckets, per-user cap 128): finite
   objectives, no fixed-effect update raising the objective (a per-user
   update may: it sees only each user's 128 active rows, in both
   packages, as ``tests/test_torch_game_second_order.py`` shows; the
   sweep-end objectives are reported), TRON's accepted
   fixed-effect values never rising, then the scoring driver on the
   Poisson run's ``best/``, its POISSON_LOSS equal to the best state's.
   These driver runs read the feature sets of phase 6's scan through
   ``--feature-name-and-term-set-path`` instead of scanning again.
   Every fixed-effect launch of (a)-(d) takes the path
   ``kernel_path`` picks (staged at 8 KB, 2 KB and 260-byte rows) and is
   counted by loss. The timing phase has two more rows: Poisson at
   65,536 x 512 and squared at 262,144 x 2,048, f32.
9. cd_extensions — the coordinate-descent extensions on phase 5's data
   (1,000,209 rows, 6,040 users): (a) two sweeps sequential
   (``pipeline_depth=0``) and two pipelined (1): objectives, final states
   and scores bit for bit equal, ``HOT_LOOP_STATS`` printed; (b) one
   per-user update of L-BFGS (phase 5's config), TRON and OWL-QN (phase
   8's per-user configs) as one dispatch, with lane compaction in chunks
   of 4 and with the auto-tuned chunk: coefficients, iterations and codes
   bit for bit equal, with wall time (the single dispatch's device busy
   time is phase 8's profile of the same update), the solvers' reads
   and the lanes of every re-dispatched chunk, and a
   check at the buckets' shapes that a lane's margins and gradient sums,
   with the lanes padded as compaction pads them, do not depend on how
   many lanes share the dispatch; (c) two sweeps in blocks of two
   coordinates: finite objectives, one epilogue
   read per two updates, the sweep ends beside (a)'s sequential ones, and
   a small blocked GLMix on the card and the CPU within rel 1e-4; (d) the
   blocked pipelined run with a snapshot at every coordinate and
   ``cd.update@1.1`` raising inside sweep 1's block: snapshots only at
   block boundaries, and fresh coordinates resumed from the newest equal
   to (c)'s run bit for bit (states, scores, objectives); (e) the fixed
   effect down-sampled at rate 0.5 (the binary sampler): the weights the
   card samples equal the CPU's for the same keys, two sweeps finite, on
   the stream path; (f) the training driver with the pipelined sweep,
   blocks of two, auto lane compaction and the fixed effect down-sampled
   at 0.5 on the drill's 40,000 / 5,000-row fixture of phase 7 (b) (the
   full fixture would take the script past 750 s): exit 0, finite
   objectives, one read per block, every launch staged, then the scoring
   driver on its ``best/``, its AUC the best state's.

10. factored — factored random effects and BASELINE config 5: (a) phase
   5's data with the fixed effect and ``perUserFac``, a factored random
   effect over ``userId`` on the 64 global features (IDENTITY projection,
   one block, active cap 128; per-entity and latent L-BFGS + L2, lambda
   1, at most 20 iterations each; K = 8, two inner iterations; the movie
   shard's 3,706 one-hot columns would make Kronecker rows past the
   kernel's 4,096), two sweeps: finite objectives, no fixed-effect update
   raising the objective, every refit launch on the staged path (2 KB
   rows), the fixed effect's on the stream path; (b) the kernel on the
   refit's real Kronecker batch (6,040 x 128 rows x 512) against its plain
   version, and timed; (c) a small factored GLMix (40,000 rows) on the
   card and the CPU within rel 1e-3 (``factored_small_phase`` says why
   not 1e-4), depth 0 equal to depth 1 and a run
   killed at (1, 1) and resumed equal to the uninterrupted one, bit for
   bit; (d) the training driver with ``FACTORED_FLAGS`` on the drill's
   fixture (K·D = 8 x 65, every launch staged), then the scoring driver
   on its ``best/`` (a plain random-effect directory), its AUC the best
   state's; (e) BASELINE config 5 at ``bench.py:1226``'s parameters
   (400,000 rows, 32 global features, per-user and per-item caps of 64,
   3 buckets each, one sweep; every launch on the stream path), its
   fixed effect's kernel timed on the real batch, then the MF scoring
   pass over random K = 8 tables: rows per second, equal to a host numpy
   gather-dot, and equal after a LatentFactorAvro round trip.
11. single_glm — the single-GLM path, BASELINE config 1: (a)
   ``train_glm_grid`` at ``bench.py``'s config-1 shape (262,144 x 2,048
   f32, logistic, L-BFGS + L2, lambda 10, 1, 0.1 warm-started, at most
   80 iterations, tol 1e-6): per-lambda iterations and seconds, every
   launch staged (8 KB rows), the grid with the kernel gated off
   reaching the same objectives (rel 1e-4; coefficients rel 1e-3, f32
   stopping noise), ``evaluate_model_grid`` equal to one call a model
   (rel 1e-6), a box on the first 16 coordinates holding with one on a
   bound, the last tracked iterate the solution; (b) an a1a-shaped
   LibSVM fixture (123 one-hot features in 14 groups, a9a's 32,561 /
   16,281 rows) through ``cli/libsvm_to_avro`` and the legacy driver
   with validation, the grid, VALIDATE_FULL, every diagnostic, the
   per-iteration metrics and the summary: every part native, every
   main-grid launch on the stream path (124 f32 columns), the best
   model's AUC from ``best/`` equal to ``metrics.json``'s, the last
   iterate's metrics the final model's; (c) the same LibSVM files
   straight into the driver (in this process), its validation AUCs
   (b)'s within rel 1e-4 and its sorted coefficients' distance to (b)'s
   reported; (d) OWL-QN + L1, TRON + L2 with STANDARDIZATION (never
   rising), and the same with a box on three features (finite and
   boxed: the projection after an accepted step can raise TRON's
   values, in both packages); (e) (b) without the diagnostics on the card and the CPU
   (objectives rel 1e-4). The kernel is held against its plain version
   on (a)'s and (b)'s real batches (x 2,048 staged, x 124 stream).
12. wide_streamed — wide and streamed data: (a) ``bench.py:1966
   bench_ingest``'s data (10,000,000 x 100,000, 8 non-zeros a row, 50,000
   entities, seed 3): the native ELL pack against the numpy scatter
   (equal, timed), ``ell_from_csr`` to the card, the in-RAM random-effect
   build (cap 32, keep 64, INDEX_MAP) native-packed and numpy-packed
   (equal), and the streamed build in ``bench.py:2021``'s 1,000,000-row
   chunks into memmap blocks, equal to the in-RAM one array for array
   (both builders on the generator's first ``INGEST_BUILDER_ROWS``
   rows, a cut of scale made for phase 16),
   with host RSS peaks and the bytes on disk; (b) logistic L-BFGS + L2 on
   that ELL batch (at most 30 iterations): two evaluations equal, an
   evaluation timed against its bytes bound, a solve resumed from its
   iteration-10 carry equal to the uninterrupted one, the first 200,000
   rows solved on the card and the CPU (rel 1e-4), no kernel launch; (c)
   one pipelined sweep of phase 5's GLMix with the per-user blocks in RAM
   on the card, then built streamed into memmap files: states,
   objectives and scores bit for bit, seconds and device memory; (d) a
   wide GAME fixture (25,000 / 6,250 rows, cut for time; 100,000
   hashed global features, 8 a row, a per-user bag over 2,000 users): the
   feature-indexing job with the off-heap store, the training driver
   plain and with ``--random-effect-blocks-dir`` and the off-heap store
   (models record for record and metrics equal, no kernel launch: the
   global shard is ELL; the run with the blocks dir alone was cut for
   phase 17), a wrong partition count refused, and the scoring driver
   with and without the store (equal scores); (e) the legacy driver on
   an rcv1.binary-shaped LibSVM file (20,242 / 10,000 rows, 47,236
   features, ~74 non-zeros a row) with validation and every diagnostic,
   the best model's AUC read back and scored on the card equal to
   metrics.json's (rel 1e-6).

13. bf16_serve — ``--precision bf16`` and the serving path: (a) phase 5's
   GLMix with X and the per-user blocks in bf16 (every launch stream at
   128-byte rows), its objectives and peak device memory beside phase
   5's, and a second run on fresh coordinates equal bit for bit; (b) the
   training driver with ``--precision bf16`` on phase 6's fixture and
   feature sets in RAM, beside phase 6's objectives and AUC, the kernel
   held against its plain version on the bf16 ×65 batch, then on the
   drill's fixture (phase 7 (b)) in RAM and with
   ``--random-effect-blocks-dir`` (the two runs' metrics and models equal
   record for record; every launch of the three staged at ×65 bf16); (c)
   ``python -m photon_ml_tpu_torch.serve.service`` as a process on the
   card serving phase 6's final f32 model (its ``best/`` is the first
   state, with no per-user coefficients) on a unix socket under the
   default 64 MB tier budget: 4 client threads send requests of 1-256
   consecutive records of the drill's 5,000-row validation file (same
   recipe and widths; cut from 50,000 records of phase 6's validation
   for phase 17) (``SERVE_REQUESTS`` each, and a tail past the swap),
   hot-swapped
   to (b)'s model once half are answered with the canary gate open;
   every response equals, bit for bit, the scoring driver's scores
   (run on the same model and rows) before the flip or the library's
   scores of the candidate after it, none is shed, ``stats`` reports
   generation 2, and SIGTERM drains to exit 75; then the bf16 tier (all
   users fit) on 4 x ``BF16_TIER_REQUESTS`` requests, every score within
   its bf16 bound.
   Rows per second, client p50/p99, the tier hit split, the
   ``serve_stage_ms`` totals, the swap's blackout and the service's
   peak device memory are printed. The f32-tier service runs traced
   (``--trace-dir``, ``--trace-exemplar-slots 8``): ``exemplars.jsonl``
   must hold 8 stage trees and the trace ``serve.generation`` and
   ``serve.swap``; the sampled requests' stage split is printed by the
   JAX package's stage names.
14. fleet — the scorer fleet on the card: two port services
   (``--serve-hbm-budget-mb 32`` each) serve phase 6's final f32 model
   (6,040 users x 3,707 columns) behind the port's router
   (``python -m photon_ml_tpu_torch.tools.photon_serve fleet``, traced,
   routing by ``userId``), 4 clients x ``SERVE_REQUESTS`` requests of
   1-256 of phase 13 (c)'s records (read once there, with the scoring
   driver's scores that every fleet score must equal bit for bit);
   member 1 is SIGKILLed once half are answered, every request must
   resolve with scores or a
   typed shed, and the router's ``serve_route`` ledger must account for
   every dispatch; then SIGTERM gives exit 75 for the router and the live
   member. Rows per second, p50/p99, the rows by shard and the failovers
   are printed. A killed member's relaunch, its generation-checked
   re-admission and the checks after it (no shed, both members' tier
   hits, the ledger) are phase 17 (b)'s, under the supervisor (cut here
   for its time).
15. mesh — the device mesh on four shards of the card: the multi-device
   gate, GLMix on data, entity and data x entity meshes (plain and int8
   on the wire) held to phase 5's run, and the training driver with
   ``--re-entity-shards auto --collective-quant int8``.
16. gang — processes joined over ``torch.distributed`` (gloo, staged
   through host memory) on the one card: (a) 2 processes x 2 shards fit
   phase 5's fixed effect, each feeding its half of the rows, and equal
   1 process x 4 shards over the same row layout bit for bit (the
   launches and process-group bytes of each process are printed); (b)
   two members of the training driver (``--num-processes 2``) on phase
   6's fixture and feature sets at full width, both
   ``MULTIHOST_GAME_OK`` with ``devices=2 re_entity_axis=2``, identical
   npz files, coefficients and objective within ``GANG_BOUNDS`` of
   phase 6's final state, then the scoring driver split over two
   processes, whose records equal phase 6's scoring run record for
   record; (c) on the drill's rows as part files, two sweeps, three
   gangs side by side: a supervised gang (``--max-worker-restarts 1``,
   checkpoints) whose member 1 is SIGKILLed after process 0's first
   snapshot re-forms, resumes (``MULTIHOST_RESUME``) and ends on the
   uninterrupted gang's npz bit for bit, and one member's SIGTERM stops
   a fresh gang with exit 75 on both members at one coordinate.
17. supervise — run supervision through the port's own
   ``photon_status`` and ``photon_supervise``: (a) the supervisor runs the
   training driver (the drill's ``--worker-updates`` role, which reads
   the kernel's launch count at every ``cd.update`` fault point) on
   phase 7 (b)'s fixture with the drill's argv, ``--checkpoint-dir`` and
   ``--trace-dir``, through a SIGTERM at update 0.1 (exit 75) and a hang
   at 1.1 that the heartbeat flags (``stall_kill``, then
   ``escalate_kill``): ``PHOTON_SUPERVISE_OK restarts=2``, the
   supervisor's records in order, the last snapshot and the objectives
   after the last resume bit for bit phase 7 (b)'s uninterrupted
   reference, every incarnation launching the kernel on its path, the
   ``.prev`` files (``trace.json.prev`` the preempted incarnation's) and
   two ``run_restart`` records in the trace dir, ``photon_status``
   reading it as finished; the seconds from each fault to the next
   incarnation's first update, the stall verdict's latency and each
   incarnation's wall time are printed (the drill's kill at update 2.0
   is phase 18's smoke cell ``cd.update=kill``, so it is not sent here);
   (b) ``photon_supervise --fleet
   2 --router-listen --stop-file`` serving phase 6's final f32 model as
   phase 14 does (``--serve-hbm-budget-mb 32`` a member), the members
   armed with ``serve.batch@2=kill:1:19``: one client's requests of
   phase 13 (c)'s records before and after one member's death all
   resolve, every score the scoring driver's bit for bit, the member
   relaunched and re-admitted, no request shed after that, both members'
   tier hits non-zero (the relaunched one's since its relaunch), the
   router's ``serve_route`` ledger resolving every dispatch, the stop
   file draining the fleet to exit 0, and ``photon_status --fleet``
   listing both members and the router; (c) the drill's corrupt role, a
   driver process on the card over a copy of phase 7 (b)'s snapshots
   with every step corrupted: exit 3, one ``PHOTON_ABORT
   kind=CheckpointCorruptionError``, no traceback, no output. (a), (b)
   and (c) run side by side.
18. chaos — (a) the port's chaos campaign
   (``photon_ml_tpu_torch/tools/chaos_drill.py``) on the card, its smoke
   subset with every child on ``--device cuda``: the fault-free
   reference, the 11 smoke cells (I/O retry, a corrupt shard quarantined,
   the index map's clean abort, a torn checkpoint write, a poisoned
   update, a kill and a SIGTERM at an update each resumed bit for bit,
   the trace dir's and the telemetry exporter's I/O down, the OTLP
   bridge against a dead collector, a fleet member killed mid-request
   under ``photon_supervise --fleet 4``) and ``scenario.corrupt_shard``,
   side by side through the tool's ``run_cell``: every cell passes, with
   the outcomes the JAX package's gate asserts; (b) the port's OTLP
   bridge over phase 6's traced training run: the document holds the
   ``cd.sweep`` and ``cd.update`` spans and the
   ``photon.telemetry_proto`` attribute. The fixture is the JAX
   campaign's own (4 x 40 rows, 5 columns with the intercept): under the
   kernel's gate, so no cell launches it; what the card adds is the
   port's state on CUDA through every fault.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit) and
no result line is printed. Without CUDA, or outside the repository, it
exits non-zero at once.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# Device-memory rates for the HBM bound (NVIDIA data sheets) and the f32
# CUDA-core peak of the H100 SXM.
HBM_BYTES_PER_S = {"sxm": 3.35e12, "pcie": 2.0e12}
F32_FLOPS_PER_S = 67e12
# Clock cycles of the spin that holds the device while timed calls are
# queued: about 10 ms at the H100's 1.98 GHz, longer than the host takes
# to issue ten calls of the plain version (some 20 PyTorch ops each).
SPIN_CYCLES = 20_000_000
GLMIX_SHAPE = (1_000_209, 64)
# the GLMix fixed effect through the drivers: 64 features + the intercept
DRIVER_SHAPE = (1_000_209, 65)
BIG_SHAPE = (262_144, 2_048)
# BASELINE config 3 (bench.py:398, Poisson elastic net)
CONFIG3_SHAPE = (65_536, 512)
# rows of the driver phase's Avro fixture (training, validation): the
# configuration's 1,000,209 training rows and a fifth as many to validate,
# written as 16 + 4 part files; the widths are the configuration's
DRIVER_ROWS = (1_000_209, 200_000)
# rows of the resume phase's drill fixture: cut further, since six driver
# processes each decode the Avro again, but not below the kernel's gate:
# 40,000 x 65 = 2.6M elements passes ``pallas_supported``'s 2**21, where
# at 20,000 rows the fixed effect takes the plain two-pass form
DRILL_ROWS = (40_000, 5_000)
# the fixed effects of the small card-vs-CPU runs (phases 5, 8-10) and of
# the drill's drivers (phases 7, 9, 10)
SMALL_SHAPE = (40_000, 64)
DRILL_SHAPE = (DRILL_ROWS[0], 65)
DRIVER_SECTIONS = "global:globalFeatures|user:userFeatures"
# BASELINE config 1 is logistic regression on a1a; the fixture keeps
# a1a's encoding (123 binary features in 14 one-hot groups, one for each
# Adult attribute) at the rows of the family's largest set, a9a (32,561
# training and 16,281 test rows): with the intercept 32,561 x 124 passes
# the kernel's 2**21-element gate, where a1a's own 1,605 rows would not
A1A_GROUPS = (5, 8, 5, 16, 5, 7, 14, 6, 5, 2, 2, 2, 5, 41)
A1A_FEATURES = sum(A1A_GROUPS)  # 123
A1A_ROWS = (32_561, 16_281)
A1A_SHAPE = (A1A_ROWS[0], A1A_FEATURES + 1)
CONFIG1_LAMBDAS = (10.0, 1.0, 0.1)
# (shape, tolerance scaled to the sum of |terms|): the small shapes reach
# every stream geometry (1 to 32 lanes a row in f32 or bf16, one and two
# vectors a lane, segments that are not whole, a ragged last batch) and
# the staged path's unvectorised load (d = 63).
CHECK_SHAPES = [((700, 128), False), ((1024, 256), False),
                ((1000, 96), False), ((1001, 24), False),
                ((1001, 8), False), ((777, 256), False),
                ((777, 63), False), (GLMIX_SHAPE, True),
                (DRIVER_SHAPE, True), (CONFIG3_SHAPE, True),
                (BIG_SHAPE, True), (SMALL_SHAPE, True),
                (DRILL_SHAPE, True), (A1A_SHAPE, True)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def movielens_data(rng, n, n_users, n_movies, d_global,
                   with_item_effect=False):
    """MovieLens-shaped synthetic GameDataset: power-law users, uniform
    movies, dense global features, one-hot movie features for the per-user
    coordinate, and with ``with_item_effect`` a per-movie effect in the
    labels, one-hot user features for a per-item coordinate and the
    ``movieId`` column (the recipe of bench.py:581 ``_movielens_data``)."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.game.dataset import GameDataset

    users = (rng.zipf(1.3, size=n) % n_users).astype(np.int64)
    movies = rng.integers(0, n_movies, n)
    Xg = (rng.normal(size=(n, d_global)) / np.sqrt(d_global)).astype(
        np.float32)
    wg = rng.normal(size=d_global).astype(np.float32)
    logits = Xg @ wg + 0.5 * rng.normal(size=n_users)[users].astype(
        np.float32)
    if with_item_effect:
        logits = logits + 0.4 * rng.normal(size=n_movies)[movies].astype(
            np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    one = np.ones(n, np.float32)
    shards = {
        "global": sp.csr_matrix(Xg),
        "per_user": sp.csr_matrix((one, (np.arange(n), movies)),
                                  shape=(n, n_movies)),
    }
    if with_item_effect:
        shards["per_item"] = sp.csr_matrix((one, (np.arange(n), users)),
                                           shape=(n, n_users))
    data = GameDataset(responses=y, feature_shards=shards)
    data.encode_ids("userId", users)
    if with_item_effect:
        data.encode_ids("movieId", movies)
    return data


def glmix_coordinates(data, device, active_cap=128, feature_cap=128,
                      num_buckets=4, case="lbfgs", dtype=None,
                      entity_axis_size=1):
    """Fixed effect + per-user random effect with the configurations of
    ``GLMIX_CASES[case]`` (for "lbfgs": L-BFGS + L2, lambda 10 and 40
    iterations, then lambda 1 and 20 iterations, tolerance 1e-7); X and
    the per-user blocks stored in ``dtype`` (f32 unless given); the
    buckets padded to ``entity_axis_size`` lanes (phase 15)."""
    import torch

    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate, RandomEffectCoordinate)
    from photon_ml_tpu_torch.game.dataset import (
        RandomEffectDataConfiguration, build_fixed_effect_dataset,
        build_random_effect_dataset)
    from photon_ml_tpu_torch.game.random_effect import (
        RandomEffectOptimizationProblem)
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.tools.glmix_cases import GLMIX_CASES

    glmix = GLMIX_CASES[case]
    task = TaskType[glmix.task]
    parse = GLMOptimizationConfiguration.parse
    re_cfg = RandomEffectDataConfiguration(
        random_effect_type="userId", feature_shard_id="per_user",
        num_active_data_points_upper_bound=active_cap,
        num_features_to_keep_upper_bound=feature_cap)
    return {
        "fixed": FixedEffectCoordinate(
            dataset=build_fixed_effect_dataset(
                data, "global", dtype=dtype or torch.float32,
                device=device),
            problem=GLMOptimizationProblem(config=parse(glmix.fixed),
                                           task=task)),
        "per-user": RandomEffectCoordinate(
            dataset=build_random_effect_dataset(
                data, re_cfg, num_buckets=num_buckets,
                dtype=dtype or torch.float32, device=device,
                entity_axis_size=entity_axis_size),
            problem=RandomEffectOptimizationProblem(
                config=parse(glmix.per_user), task=task)),
    }


def kernel_inputs(torch, n, d, seed, device):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d), dtype=np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    w = (rng.normal(size=d) * (0.5 / np.sqrt(d))).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(X), t(y), t(off), t(wt), t(w)


def paths_for(X) -> list:
    """Every pass-1 path that takes X's shape: staged always, stream
    where its rows fit."""
    from photon_ml_tpu_torch.ops.pallas_kernels import kernel_path

    aligned = X.data_ptr() % 16 == 0
    return (["stream", "staged"]
            if kernel_path(X.shape[1], X.dtype, aligned) == "stream"
            else ["staged"])


def check_sums(torch, loss, X, y, off, wt, w, shift, scaled: bool,
               path=None):
    """Kernel against the plain version on the same inputs: through the
    public wrapper when ``path`` is None (the path it picks for X), else
    on the named path. Returns the largest |delta| of the vector sum and
    the worst tolerance ratio."""
    from photon_ml_tpu_torch.ops.pallas_kernels import (
        _launch, fused_value_gradient_sums,
        fused_value_gradient_sums_reference)

    def kernel():
        if path is None:
            return fused_value_gradient_sums(loss, X, y, off, wt, w, shift,
                                             device=X.device)
        return _launch(loss, X, y, off, wt, w, shift, path=path)

    got = kernel()
    torch.cuda.synchronize()
    again = kernel()
    torch.cuda.synchronize()
    where = path or "wrapper's path"
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{loss.name} {where}: two calls are not "
                             f"bit-identical")
    ref = fused_value_gradient_sums_reference(loss, X, y, off, wt, w, shift)
    torch.cuda.synchronize()
    v, vec, pre = (t.double() for t in got)
    rv, rvec, rpre = (t.double() for t in ref)
    if scaled:
        # sums of 1e5-1e6 f32 terms in another order: |delta| is held
        # against 1e-5 * sum_i |term_i|, per entry
        Xa = X.float()
        z = Xa @ w + off + shift
        l, d1 = loss.loss_and_d1(z, y)
        r = (wt * d1).double()
        tol_vec = 1e-5 * (r.abs().float() @ Xa.abs()).double()
        tol_val = 1e-5 * (wt * l).abs().double().sum()
        tol_pre = 1e-5 * r.abs().sum()
        worst = max(float(((vec - rvec).abs() / tol_vec).max()),
                    float((v - rv).abs() / tol_val),
                    float((pre - rpre).abs() / tol_pre))
        del Xa
    else:
        # the small cases of tests/test_pallas.py: value rel 2e-5,
        # prefactor rel 2e-5 / abs 1e-4, vector rtol = atol = 2e-4
        worst = max(float((v - rv).abs() / (2e-5 * rv.abs())),
                    float((pre - rpre).abs()
                          / (1e-4 + 2e-5 * rpre.abs())),
                    float(((vec - rvec).abs()
                           / (2e-4 + 2e-4 * rvec.abs())).max()))
    max_abs = float((vec - rvec).abs().max())
    if not worst <= 1.0 or not np.isfinite(worst):
        raise AssertionError(f"{loss.name} {X.dtype} {tuple(X.shape)} "
                             f"{where}: kernel disagrees with its plain "
                             f"version (worst delta/tolerance {worst:.3g})")
    return max_abs, worst


def cuda_times(torch, fn, reps=25, inner=1, warmup=3) -> dict:
    """CUDA-event time per call of ``inner`` calls back to back (``ms``),
    median over ``reps`` turns, and the host's time to issue a call
    (``host_ms``).

    One call at a time (``inner`` 1) the event time holds the host's work
    before the launch, as a caller's single call does. Back to back a
    spin kernel (``spin_ms`` on the device) holds the device first, so
    that the calls are queued before the timed window opens and the event
    time is the device's alone. A turn whose calls took the host longer
    to issue than the spin lasted is left out of the median;
    ``queued_share`` is the share of turns kept.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    turns = []
    for _ in range(reps):
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        if inner > 1:
            s.record()
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        t = time.perf_counter()
        for _ in range(inner):
            fn()
        issue_ms = (time.perf_counter() - t) * 1e3
        b.record()
        b.synchronize()
        spin_ms = s.elapsed_time(a) if inner > 1 else float("inf")
        turns.append((a.elapsed_time(b) / inner, issue_ms / inner,
                      spin_ms, issue_ms < spin_ms))
    kept = [t for t in turns if t[3]] or turns
    return {"ms": float(np.median([t[0] for t in kept])),
            "host_ms": float(np.median([t[1] for t in turns])),
            "spin_ms": float(np.median([t[2] for t in turns])),
            "queued_share": sum(t[3] for t in turns) / len(turns)}


def time_kernel(torch, hbm, loss, Xc, y, off, wt, w, shift) -> dict:
    """The timing rows of the kernel on ``Xc``, one per pass-1 path that
    takes the shape: the paths in turns on the same inputs (A, B, B, A),
    each turn one call at a time (``kernel_ms``) and then ten back to back
    (``device_ms``), beside the plain version, the one-call-per-pass
    PyTorch yardstick (``library``) and the bound of the bytes the call
    must move (X once, four ``[n]`` vectors, ``w``) or of its f32
    operations, whichever is larger."""
    from photon_ml_tpu_torch.ops import pallas_kernels as pk

    n, d = (int(v) for v in Xc.shape)
    wl = w.to(Xc.dtype)

    def library():
        z = torch.matmul(Xc, wl).float() + off + shift
        r = wt * loss.d1(z, y)
        return ((wt * loss.loss(z, y)).sum(),
                torch.matmul(r.to(Xc.dtype), Xc), r.sum())

    paths = paths_for(Xc)
    single = {p: [] for p in paths}
    back = {p: [] for p in paths}
    for p in paths + paths[::-1]:
        def run(p=p):
            return pk._launch(loss, Xc, y, off, wt, w, shift, path=p)
        single[p].append(cuda_times(torch, run)["ms"])
        back[p].append(cuda_times(torch, run, reps=15, inner=10))

    def plain():
        return pk.fused_value_gradient_sums_reference(loss, Xc, y, off, wt,
                                                      w, shift)
    plain_ms = cuda_times(torch, plain)["ms"]
    plain_dev = cuda_times(torch, plain, reps=15, inner=10)
    library_ms = cuda_times(torch, library)["ms"]
    library_dev = cuda_times(torch, library, reps=15, inner=10)
    nbytes = n * d * Xc.element_size() + 12 * n + 4 * d
    bytes_ms = 1e3 * nbytes / hbm
    ops_ms = 1e3 * 4.0 * n * d / F32_FLOPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    dt = str(Xc.dtype).split(".")[-1]
    rows = {}
    for p in paths:
        kernel_ms = float(np.mean(single[p]))
        device_ms = float(np.mean([r["ms"] for r in back[p]]))
        rows[p] = {
            "n": n, "d": d, "dtype": dt, "path": p, "loss": loss.name,
            "kernel_ms": kernel_ms, "kernel_ms_runs": single[p],
            "device_ms": device_ms,
            "device_ms_runs": [r["ms"] for r in back[p]],
            "host_ms": float(np.mean([r["host_ms"] for r in back[p]])),
            "spin_ms": back[p][0]["spin_ms"],
            "queued_share": min(r["queued_share"] for r in back[p]),
            "plain_ms": plain_ms, "plain_device_ms": plain_dev["ms"],
            "plain_queued_share": plain_dev["queued_share"],
            "library_ms": library_ms,
            "library_device_ms": library_dev["ms"],
            "library_queued_share": library_dev["queued_share"],
            "bytes": nbytes, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": bound_ms / kernel_ms,
            "device_share_of_bound": bound_ms / device_ms,
            "achieved_gb_per_s": nbytes / kernel_ms / 1e6,
            # the staged path's time over this path's, same run
            "staged_over_this": float(np.mean(single["staged"]))
            / kernel_ms,
            "staged_over_this_device": float(np.mean(
                [r["ms"] for r in back["staged"]])) / device_ms}
    return rows


# the scoring driver as its own process. Its peak RSS so far is read after
# the device's first tensor and after each driver phase, as the larger of
# the kernel's high-water mark (VmHWM, where /proc gives it) and the most
# a thread sampling the resident size every 2 ms saw. ru_maxrss is
# reported beside it, but a child can inherit it from its parent's peak
# across exec, so it bounds the child's peak only from above.
SCORING_CHILD = """
import contextlib, json, os, resource, sys, threading, time
sys.path.insert(0, sys.argv[1])
import torch
from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
from photon_ml_tpu_torch.io.data_format import INGEST_STATS
argv = sys.argv[2:]
page = os.sysconf("SC_PAGE_SIZE")
seen = [0]
def resident():
    with open("/proc/self/statm") as f:
        return page * int(f.read().split()[1])
def sample():
    while True:
        seen[0] = max(seen[0], resident())
        time.sleep(0.002)
threading.Thread(target=sample, daemon=True).start()
def peak():
    seen[0] = max(seen[0], resident())
    with open("/proc/self/status") as f:
        hwm = [int(ln.split()[1]) * 1024 for ln in f
               if ln.startswith("VmHWM:")]
    return max([seen[0]] + hwm)
rss = {}
timed = tsd.timed_phase
@contextlib.contextmanager
def phase(name, logger=None, record=None, **kw):
    with timed(name, logger, record, **kw) as t:
        yield t
    rss[name] = peak()
tsd.timed_phase = phase
rss["imports"] = peak()
torch.zeros(1, device=argv[argv.index("--device") + 1])
rss["device_init"] = peak()
d = tsd.run(argv)
rss["end"] = peak()
print("SCORING_DRIVER " + json.dumps({
    "metrics": d.metrics, "phase_seconds": d.phase_seconds,
    "ingest_parts": INGEST_STATS, "max_rss_bytes_after": rss,
    "ru_maxrss_bytes":
        1024 * resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}))
"""


def run_scoring_driver(argv) -> dict:
    """The scoring driver in a process of its own (so that its peak host
    RSS is its own): returns its metrics, phase seconds, ingest part
    counts, the peak RSS after each step (``max_rss_bytes_after``) and
    this process's resident size when it started the child."""
    with open("/proc/self/statm") as f:
        parent_rss = os.sysconf("SC_PAGE_SIZE") * int(f.read().split()[1])
    out = subprocess.run([sys.executable, "-c", SCORING_CHILD, REPO, *argv],
                         capture_output=True, text=True, timeout=900)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("SCORING_DRIVER ")]
    if out.returncode != 0 or not lines:
        raise AssertionError(f"scoring driver exit {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    return {**json.loads(lines[-1].split(" ", 1)[1]),
            "parent_rss_bytes": parent_rss}


#: what the phases that run the scoring driver in this process (8 (c),
#: 9 (f), 10 (d), 13 (c)) say of it; a child of its own, as before PR
#: 19, paid the interpreter's, torch's and the card's start again
SCORING_IN_PROCESS = ("the scoring driver ran in this process, not a child "
                      "of its own (phase 6 keeps the child for its host "
                      "RSS); the checks are the same")


def score_in_process(argv) -> dict:
    """``cli.game_scoring_driver.run(argv)`` in this process: its metrics
    and phase seconds."""
    from photon_ml_tpu_torch.cli import game_scoring_driver as tsd

    d = tsd.run(argv)
    return {"metrics": d.metrics, "phase_seconds": d.phase_seconds}


def datasets_equal(a, b) -> bool:
    """Two GameDatasets equal array for array: every CSR shard, the
    responses, offsets, weights, uids and id codes and vocabularies."""
    if set(a.feature_shards) != set(b.feature_shards) \
            or set(a.id_columns) != set(b.id_columns):
        return False
    for k, x in a.feature_shards.items():
        y = b.feature_shards[k]
        if x.shape != y.shape or x.dtype != y.dtype or not all(
                np.array_equal(getattr(x, f), getattr(y, f))
                for f in ("indptr", "indices", "data")):
            return False
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("responses", "offsets", "weights", "uids")) \
        and all(np.array_equal(a.id_columns[t], b.id_columns[t])
                and np.array_equal(a.id_vocabs[t], b.id_vocabs[t])
                for t in a.id_columns)


def random_effect_scoring(re_model, data) -> dict:
    """A random-effect model's scores on ``data`` two ways: the dense
    ``[N, D_raw]`` form the JAX package runs and the port's O(nnz) form,
    each timed with its peak of traced host allocations (numpy reports
    its buffers to ``tracemalloc``); raises unless they agree bit for
    bit."""
    import tracemalloc

    from photon_ml_tpu_torch.game import models as tm

    coefs = re_model.coefficients.cpu().numpy()
    local = re_model._lookup(data)
    mat = data.feature_shards[re_model.feature_shard_id]
    padded = np.vstack([coefs, np.zeros((1, coefs.shape[1]), coefs.dtype)])
    out, record = {}, {"rows": int(mat.shape[0]), "nnz": int(mat.nnz),
                       "d_raw": int(mat.shape[1])}
    for name, fn in (("dense", lambda: tm.rowwise_sparse_dot(
                          mat, padded[local])),
                     ("onnz", lambda: tm.rowwise_sparse_dot_gathered(
                          mat, padded, local))):
        tracemalloc.start()
        t0 = time.perf_counter()
        out[name] = fn()
        record[f"{name}_secs"] = time.perf_counter() - t0
        record[f"{name}_peak_bytes"] = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
    if not np.array_equal(out["dense"], out["onnz"]):
        raise AssertionError("O(nnz) random-effect scores differ from the "
                             "dense form's")
    record["bit_equal"] = True
    record["onnz_nonzero_rows"] = int(np.count_nonzero(out["onnz"]))
    return record


# -- the run telemetry plane (phases 6, 13 (c) and 14) ---------------------

#: the trace directory's files; ``telemetry.jsonl`` is the live stream's
#: fallback, written when no consumer ever connects
TRACE_FILES = ("run_manifest.json", "trace.json", "spans.jsonl",
               "metrics.jsonl", "telemetry.jsonl")
#: (span, depth) pairs of a traced GLMix training run, as the JAX
#: package's driver nests them (``tests/test_torch_telemetry.py`` holds
#: the two packages' runs equal on the CPU)
TRAINING_NESTING = {
    ("driver.phase", 0), ("cd.sweep", 1), ("cd.update", 2),
    ("cd.dispatch", 2), ("cd.tracker_drain", 2), ("cd.hbm_sample", 2),
    ("cd.hbm_watermark", 2), ("cd.epilogue_fetch", 3),
    ("cd.validation", 3), ("optimizer.solve", 3), ("re.solve", 3)}
#: seconds between heartbeats of the traced runs
TRACE_HEARTBEAT_SECONDS = 2.0
#: PR 12's untraced training driver run of phase 6 (PERF.md §5), beside
#: which the traced run's wall time is printed
UNTRACED_DRIVER_SECS = 52.67
#: the service's request stages, the JAX package's names
SERVE_STAGES = ("serve.queue_wait", "serve.batch_form", "serve.tier_gather",
                "serve.device_score", "serve.reply")


class TelemetryConsumer:
    """A ``--telemetry-endpoint unix:`` consumer on a thread of its own:
    every record it reads, with the ``time.perf_counter`` it arrived at."""

    def __init__(self, path):
        import socket
        import threading

        self.path = path
        self.records = []
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(4)
        self._sock.settimeout(0.1)
        self._closed = False
        self._threads = [threading.Thread(target=self._accept, daemon=True)]
        self._threads[0].start()

    def _accept(self):
        import socket
        import threading

        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._read, args=(conn,),
                                 daemon=True)
            self._threads.append(t)
            t.start()

    def _read(self, conn):
        with conn, conn.makefile("rb") as fh:
            for line in fh:
                self.records.append((time.perf_counter(), json.loads(line)))

    def close(self):
        self._closed = True
        self._sock.close()
        for t in self._threads:
            t.join(timeout=10)
        os.unlink(self.path)


def read_trace_dir(trace_dir) -> dict:
    """The spans and metric records of a ``--trace-dir`` directory; raises
    unless its four files exist (``telemetry.jsonl`` is checked by the
    caller, which knows whether a consumer listened)."""
    missing = [f for f in TRACE_FILES[:4]
               if not os.path.exists(os.path.join(trace_dir, f))]
    if missing:
        raise AssertionError(f"{trace_dir} lacks {missing}")
    with open(os.path.join(trace_dir, "spans.jsonl")) as f:
        spans = [json.loads(ln) for ln in f]
    with open(os.path.join(trace_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(ln) for ln in f]
    with open(os.path.join(trace_dir, "run_manifest.json")) as f:
        manifest = json.load(f)
    if metrics[-1].get("kind") != "run_end":
        raise AssertionError(f"{trace_dir}: metrics.jsonl does not end with "
                             f"run_end: {metrics[-1]}")
    return {"spans": spans, "metrics": metrics, "manifest": manifest,
            "run_end": metrics[-1]}


def span_self_ms(spans) -> dict:
    """Per span name: count, total and self milliseconds (a span's time
    less its direct children's, by containment on its thread)."""
    out = {}
    by_tid = {}
    for s in spans:
        by_tid.setdefault(s["tid"], []).append(s)
    for group in by_tid.values():
        group.sort(key=lambda s: (s["ts_us"], -s["dur_us"]))
        stack = []  # [span, children's us]
        for s in group:
            end = s["ts_us"] + s["dur_us"]
            while stack and stack[-1][0]["ts_us"] + stack[-1][0]["dur_us"] \
                    < end:
                _close_span(out, *stack.pop())
            if stack:
                stack[-1][1] += s["dur_us"]
            stack.append([s, 0.0])
        while stack:
            _close_span(out, *stack.pop())
    return {k: {"count": v[0], "total_ms": v[1] / 1e3, "self_ms": v[2] / 1e3}
            for k, v in sorted(out.items(), key=lambda kv: -kv[1][2])}


def _close_span(out, s, child_us):
    e = out.setdefault(s["name"], [0, 0.0, 0.0])
    e[0] += 1
    e[1] += s["dur_us"]
    e[2] += max(s["dur_us"] - child_us, 0.0)


def training_telemetry(trace_dir, stream, t0, t_end, peak_after,
                       solver_syncs) -> dict:
    """Phase 6's checks of the traced training run: the trace directory's
    files and ``run_end``, the spans of the JAX package's training path
    nested as it nests them, heartbeats on the live stream while the
    driver ran, and the ``hbm_bytes`` peak equal to
    ``torch.cuda.max_memory_allocated()`` read just after the run (and
    to ``run_end``'s ``peak_hbm_bytes``). Returns the record."""
    got = read_trace_dir(trace_dir)
    if got["run_end"]["status"] != "ok":
        raise AssertionError(f"training run_end: {got['run_end']}")
    nesting = {(s["name"], s["depth"]) for s in got["spans"]}
    if not TRAINING_NESTING <= nesting:
        raise AssertionError(f"training spans lack "
                             f"{sorted(TRAINING_NESTING - nesting)}")
    kinds = [r.get("kind") for _, r in stream]
    beats = [at for at, r in stream
             if r.get("kind") == "heartbeat" and t0 <= at <= t_end]
    if not kinds or kinds[0] != "run_manifest" or kinds[-1] != "run_end" \
            or not beats or "span" not in kinds:
        raise AssertionError(f"live stream: {len(beats)} heartbeats while "
                             f"the driver ran, kinds {sorted(set(kinds))}")
    fetches = {dict(k)["site"]: v for k, v in
               metric_values(got["metrics"], "host_fetches").items()}
    updates = sum(1 for s in got["spans"] if s["name"] == "cd.update")
    if fetches.get("cd.epilogue") != updates or updates != 4:
        raise AssertionError(f"host fetches {fetches} over {updates} "
                             f"updates")
    record = {
        "files": sorted(os.listdir(trace_dir)),
        "spans": len(got["spans"]), "nesting_as_jax": True,
        "stream_records": len(stream),
        "stream_heartbeats_during_run": len(beats),
        "host_fetches_by_site": fetches,
        "host_syncs_per_update": sum(fetches.values()) / updates,
        "solver_syncs_per_update": solver_syncs / updates,
        "span_self_ms": span_self_ms(got["spans"]),
        "manifest": {k: got["manifest"][k] for k in (
            "torch_version", "cuda_version", "device_name",
            "device_count")}}
    if peak_after is not None:
        gauge = {dict(k)["kind"]: v for k, v in
                 metric_values(got["metrics"], "hbm_bytes").items()
                 if dict(k)["device"] == "cuda:0"}
        peaks = (gauge.get("peak_bytes_in_use"),
                 got["run_end"].get("peak_hbm_bytes"), peak_after)
        if len(set(peaks)) != 1:
            raise AssertionError(f"hbm_bytes peak gauge, run_end peak and "
                                 f"max_memory_allocated differ: {peaks}")
        record["hbm_bytes"] = gauge
        record["peak_hbm_bytes_equals_max_memory_allocated"] = True
    return record


def scoring_telemetry(trace_dir) -> dict:
    """The traced scoring run (its stream endpoint had no consumer): all
    five files, ``telemetry.jsonl`` from the manifest to ``run_end``."""
    got = read_trace_dir(trace_dir)
    with open(os.path.join(trace_dir, "telemetry.jsonl")) as f:
        kinds = [json.loads(ln)["kind"] for ln in f]
    names = sorted({s["name"] for s in got["spans"]})
    if kinds[0] != "run_manifest" or kinds[-1] != "run_end" \
            or got["run_end"]["status"] != "ok" or "driver.phase" not in names:
        raise AssertionError(f"scoring trace: stream {kinds[:1]}..."
                             f"{kinds[-1:]}, spans {names}")
    return {"files": sorted(os.listdir(trace_dir)),
            "fallback_stream_records": len(kinds), "spans": names,
            "host_fetches_by_site": {
                dict(k)["site"]: v for k, v in metric_values(
                    got["metrics"], "host_fetches").items()}}


def metric_values(metrics, name) -> dict:
    """``{labels as a sorted tuple: value}`` of one metric's final records
    in ``metrics.jsonl``."""
    return {tuple(sorted(m["labels"].items())): m["value"] for m in metrics
            if m.get("name") == name and "value" in m}



def write_driver_fixture(workdir, rows=DRIVER_ROWS, n_users=6040,
                         n_movies=3706, d_global=64) -> float:
    """Phase 6's Avro fixture (``train/`` and ``validate/`` part files,
    written by a spawn pool) in ``workdir``, emptied first; returns the
    seconds the write took."""
    from photon_ml_tpu_torch.tools.crash_resume_drill import (
        FIXTURE_PARTS, write_movielens_avro)

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    write_movielens_avro(os.path.join(workdir, "train"),
                         os.path.join(workdir, "validate"), *rows, n_users,
                         n_movies, d_global, parts=FIXTURE_PARTS)
    return time.perf_counter() - t0


def driver_phase(torch, dev, smi, workdir, one_part, rows=DRIVER_ROWS,
                 n_users=6040, n_movies=3706, d_global=64,
                 avro_write_secs=None):
    """The GLMix main path through the port's drivers (phase 6). Returns
    the phase record, the kernel launches of the training run, the
    kernel-vs-plain check on the driver's own fixed-effect batch and the
    fixture: its (training, validation) directories and the feature sets
    of the driver's scan, saved for ``--feature-name-and-term-set-path``,
    which stay in ``workdir``; raises on any failed check, the kernel's
    last. ``avro_write_secs`` says the fixture is in ``workdir`` already
    (:func:`write_driver_fixture`, run beside phases 2 and 3) and how long
    its write took; without it the fixture is written here. ``one_part``
    is the Avro file of the same recipe and widths that goes through both
    ingest paths."""
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.game.dataset import build_fixed_effect_dataset
    from photon_ml_tpu_torch.io import data_format as tdf
    from photon_ml_tpu_torch.io.model_io import load_scored_items
    from photon_ml_tpu_torch.obs.metrics import REGISTRY
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.ops.losses import get_loss
    from photon_ml_tpu_torch.optimize import common as opt_common
    from photon_ml_tpu_torch.serve.scoring import load_scoring_model
    from photon_ml_tpu_torch.tools.crash_resume_drill import (
        FIXTURE_PARTS, driver_argv)

    if avro_write_secs is None:
        avro_write_secs = write_driver_fixture(workdir, rows, n_users,
                                               n_movies, d_global)
    train, val = (os.path.join(workdir, k) for k in ("train", "validate"))
    out, score_out = (os.path.join(workdir, k) for k in ("train_out",
                                                          "score_out"))
    # traced: the trace directory, the live stream to a consumer here, the
    # device plane armed
    train_trace = os.path.join(workdir, "train_trace")
    consumer = TelemetryConsumer(os.path.join(workdir, "telemetry.sock"))
    argv = driver_argv(train, val, out, str(dev), extra=[
        "--trace-dir", train_trace,
        "--trace-heartbeat-seconds", str(TRACE_HEARTBEAT_SECONDS),
        "--telemetry-endpoint", f"unix:{consumer.path}",
        "--device-telemetry"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tdf.reset_ingest_stats()
    pk.reset_launch_count()
    opt_common.reset_solver_syncs()
    REGISTRY.reset()  # metrics.jsonl counts this run only
    t0 = time.perf_counter()
    try:
        trainer = ttd.run(argv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        driver_secs = t_end - t0
        peak_after = (torch.cuda.max_memory_allocated()
                      if dev.type == "cuda" else None)
        deadline = time.perf_counter() + 10
        while time.perf_counter() < deadline and not any(
                r.get("kind") == "run_end" for _, r in consumer.records):
            time.sleep(0.05)
    finally:
        consumer.close()
    telemetry = training_telemetry(
        train_trace, consumer.records, t0, t_end, peak_after,
        opt_common.SOLVER_SYNCS["count"])
    launches = pk.launch_count()
    by_path = dict(pk.fused_value_gradient_sums.launches_by_path)
    by_loss = launch_counts()["by_loss"]
    train_ingest = dict(tdf.INGEST_STATS)
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    # every part through the native path: the scan and the load of the
    # training parts, the load of the validation parts
    want_parts = 2 * FIXTURE_PARTS[0] + FIXTURE_PARTS[1]
    if train_ingest != {"native_parts": want_parts, "declined_parts": 0,
                        "records_parts": 0}:
        raise AssertionError(f"the training driver's ingest left the "
                             f"native path: {train_ingest}")

    record = json.load(open(os.path.join(out, "metrics.json")))
    (grid,) = record["grid"]
    states = grid["states"]
    if len(states) != 4 or any(
            set(s["validation_metrics"] or {}) != {"AUC", "LOGISTIC_LOSS",
                                                   "AUC:userId"}
            for s in states):
        raise AssertionError(f"metrics.json lacks per-state validation "
                             f"metrics: {states}")
    sweep_obj = [[s["objective"] for s in states if s["iteration"] == it][-1]
                 for it in range(2)]
    if not all(o is not None and np.isfinite(o) for o in sweep_obj):
        raise AssertionError(f"non-finite objective: {sweep_obj}")
    if not sweep_obj[1] <= sweep_obj[0] * (1 + 1e-6):
        raise AssertionError(f"objective rose between sweeps: {sweep_obj}")
    best_auc = record["best"]["metric"]
    best_states = [i for i, s in enumerate(states)
                   if s["validation_metrics"]["AUC"] == best_auc]
    if not best_states:
        raise AssertionError("no state holds the best validation AUC")

    t0 = time.perf_counter()
    # traced, with a stream endpoint that no consumer listens on: the
    # records go to the trace directory's telemetry.jsonl
    score_trace = os.path.join(workdir, "score_trace")
    scorer = run_scoring_driver([
        "--input-data-dirs", val,
        "--game-model-input-dir", os.path.join(out, "best"),
        "--output-dir", score_out,
        "--feature-shard-id-to-feature-section-keys-map", DRIVER_SECTIONS,
        "--random-effect-id-set", "userId", "--evaluator-type", "AUC",
        "--device", str(dev), "--trace-dir", score_trace,
        "--telemetry-endpoint",
        "unix:" + os.path.join(workdir, "no-consumer.sock"),
        "--device-telemetry"])
    scoring_driver_secs = time.perf_counter() - t0
    telemetry["scoring_driver"] = scoring_telemetry(score_trace)
    if scorer["ingest_parts"] != {"native_parts": FIXTURE_PARTS[1],
                                  "declined_parts": 0, "records_parts": 0}:
        raise AssertionError(f"the scoring driver's ingest left the native "
                             f"path: {scorer['ingest_parts']}")
    scored = load_scored_items(os.path.join(score_out, "scores",
                                            "part-00000.avro"))
    scores = np.asarray([r["predictionScore"] for r in scored])
    if scores.shape != (rows[1],) or not np.isfinite(scores).all():
        raise AssertionError("scored rows are missing or not finite")
    # the library's score of the reloaded model on the same dataset
    model, maps = load_scoring_model(os.path.join(out, "best"), {})
    sections = {k: [v] for k, v in (x.split(":") for x in
                                    DRIVER_SECTIONS.split("|"))}
    vdata = tdf.load_game_dataset_avro(val, sections, maps,
                                       id_types=["userId"],
                                       response_required=False)
    lib = model.score(vdata, device=dev).cpu().numpy().astype(np.float64)
    del vdata
    score_gap = float(np.abs(lib - scores).max())
    if not score_gap <= 1e-5:
        raise AssertionError(f"scoring driver vs library score: "
                             f"{score_gap:.3g}")
    auc_gap = abs(scorer["metrics"]["AUC"] - best_auc)
    if not auc_gap <= 1e-6:
        raise AssertionError(f"scoring driver AUC {scorer['metrics']['AUC']}"
                             f" != best validation AUC {best_auc}")

    # the final model's per-user scores on the validation rows: the
    # O(nnz) form against the dense one (best/ may hold an earlier state)
    re_scoring = random_effect_scoring(
        trainer.best_result.model.models["perUser"].to_raw(),
        trainer.validate_data)
    if not re_scoring["nnz"] or not re_scoring["onnz_nonzero_rows"]:
        raise AssertionError(f"the per-user scoring check scored "
                             f"nothing: {re_scoring}")

    # one file through both ingest paths: the same dataset
    part = one_part
    load_args = ([part], trainer.section_keys, trainer.index_maps)
    t0 = time.perf_counter()
    native = tdf.load_game_dataset_avro(*load_args, id_types=["userId"])
    native_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = tdf.load_game_dataset_records(*load_args, id_types=["userId"])
    records_secs = time.perf_counter() - t0
    if not datasets_equal(native, plain):
        raise AssertionError("native and records ingest of one part differ")
    one_part = {"file": os.path.relpath(part, REPO),
                "rows": int(native.num_samples), "native_secs": native_secs,
                "records_secs": records_secs,
                "records_over_native": records_secs / native_secs,
                "datasets_equal": True,
                "reduced": {
                    "rows": {"part": int(native.num_samples),
                             "training_part": rows[0] // FIXTURE_PARTS[0]},
                    "why": "the pure-Python records path took 17.4 s on "
                           "a 62,513-row training part; the drill's "
                           "validation file has the same columns, users "
                           "and movies"}}
    del native, plain

    # the kernel on the driver's own fixed-effect batch, against its plain
    # version (after the counts were read)
    fe = build_fixed_effect_dataset(trainer.train_data, "global",
                                    device=dev)
    X = fe.batch.X
    expected = pk.kernel_path(X.shape[1], X.dtype, X.data_ptr() % 16 == 0)
    w_fe = trainer.best_result.model.models["fixed"].model.coefficients \
        .means.to(dev).contiguous()
    check = None
    if dev.type == "cuda":
        err, worst = check_sums(
            torch, get_loss("logistic"), X, fe.batch.labels,
            fe.batch.offsets, fe.batch.weights, w_fe,
            torch.zeros((), device=dev), scaled=True)
        check = {"shape": list(X.shape), "path": expected,
                 "max_abs_err": err, "worst_delta_over_tolerance": worst}
    secs = trainer.phase_seconds
    phase = {
        "phase": "driver", "nvidia_smi": smi,
        "rows": {"train": rows[0], "validate": rows[1]},
        "reduced": {"sweeps": 2,
                    "why": "depth only: two coordinate-descent sweeps"},
        "fixture_parts": list(FIXTURE_PARTS),
        "users": n_users, "movies": n_movies, "d_global": d_global,
        "fixed_effect_columns": int(X.shape[1]),
        "avro_write_secs": avro_write_secs,
        "feature_map_secs": secs["prepareFeatureMaps"],
        "load_secs": secs["prepareGameDataSet"],
        "train_secs": secs["train grid[0]"],
        "train_secs_per_update": [s["seconds"] for s in states],
        "model_write_secs": secs["saveModels"],
        "training_driver_secs": driver_secs,
        "training_ingest_parts": train_ingest,
        "score_secs": scorer["phase_seconds"],
        "scoring_driver_secs": scoring_driver_secs,
        "scoring_ingest_parts": scorer["ingest_parts"],
        "scoring_driver_max_rss_bytes": scorer["max_rss_bytes_after"]["end"],
        "scoring_driver_max_rss_bytes_after": scorer["max_rss_bytes_after"],
        "scoring_driver_ru_maxrss_bytes": scorer["ru_maxrss_bytes"],
        "rss_bytes_when_scoring_driver_started": scorer["parent_rss_bytes"],
        "one_part_records_vs_native": one_part,
        "random_effect_scoring": re_scoring,
        "objectives": [s["objective"] for s in states],
        "validation_metrics": [s["validation_metrics"] for s in states],
        "best_metric": best_auc,
        "scoring_driver_auc": scorer["metrics"]["AUC"],
        "score_vs_library_max_abs": score_gap,
        "kernel_launches": launches, "launches_by_path": by_path,
        "launches_by_loss": by_loss, "expected_path": expected,
        "max_memory_allocated": peak,
        "kernel_check": check,
        "telemetry": telemetry,
    }
    print("driver phase: " + json.dumps(phase), file=sys.stderr, flush=True)
    print(f"phase 6 traced ({smi}): training driver "
          f"{driver_secs:.2f} s traced beside PR 12's untraced "
          f"{UNTRACED_DRIVER_SECS} s; host syncs per update "
          f"{telemetry['host_syncs_per_update']} by site "
          f"{telemetry['host_fetches_by_site']}; span self ms "
          f"{json.dumps(telemetry['span_self_ms'])}", file=sys.stderr,
          flush=True)
    if dev.type == "cuda" and (launches <= 0
                               or by_path[expected] != launches):
        raise AssertionError(f"the driver's fixed effect did not launch "
                             f"the kernel on the {expected} path: {by_path}")
    # the fixture stays for phases 8, 9, 13 and 16, with the feature sets,
    # the final model (output/grid-0) for phase 13's service and phase 16's
    # gang (best/ is the first state, before any per-user update), and
    # best/ with its scoring run for phase 16's split scoring run
    feature_sets = save_feature_sets(trainer.index_maps,
                                     os.path.join(workdir, "feature_sets"))
    return phase, launches, by_path, check, (train, val, feature_sets)


def save_feature_sets(index_maps, directory) -> str:
    """The (name, term) sets behind the driver's index maps, one section a
    shard as ``DRIVER_SECTIONS`` maps them, saved where
    ``--feature-name-and-term-set-path`` reads them; the maps they give
    must equal the driver's."""
    from photon_ml_tpu_torch.io.data_format import NameAndTermFeatureSets
    from photon_ml_tpu_torch.io.index_map import (INTERCEPT_KEY,
                                                  split_feature_key)

    shards = dict(x.split(":") for x in DRIVER_SECTIONS.split("|"))
    sets = NameAndTermFeatureSets({
        section: {split_feature_key(k) for k, _ in index_maps[shard].items()
                  if k != INTERCEPT_KEY}
        for shard, section in shards.items()})
    for shard, section in shards.items():
        if dict(sets.index_map([section], add_intercept=True).items()) != \
                dict(index_maps[shard].items()):
            raise AssertionError(f"saved feature sets of {shard} do not "
                                 f"give the driver's index map")
    sets.save(directory)
    return directory


def resume_phase(torch, dev, data, want, workdir):
    """Phase 7 (a): the glmix run killed mid-sweep by an injected fault
    and resumed in fresh coordinates from its newest snapshot. ``want`` is
    phase 5's final state per coordinate; the resumed run must end on it
    bit for bit. Returns the record and the launches of both segments."""
    from photon_ml_tpu_torch.game.coordinate_descent import (
        HOT_LOOP_STATS, reset_hot_loop_stats, run_coordinate_descent)
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.optimize.config import TaskType
    from photon_ml_tpu_torch.utils import checkpoint as ck
    from photon_ml_tpu_torch.utils import faults

    task = TaskType.LOGISTIC_REGRESSION
    shutil.rmtree(workdir, ignore_errors=True)
    mgr = ck.CheckpointManager(workdir)
    ck.reset_checkpoint_stats()
    reset_hot_loop_stats()
    faults.disarm_all()

    def run(**kw):
        """Two sweeps in fresh coordinates, launch counts zeroed just
        before."""
        coords = glmix_coordinates(data, dev)
        torch.cuda.synchronize()
        pk.reset_launch_count()
        t = time.perf_counter()
        res = run_coordinate_descent(
            coords, 2, task, data.responses, data.weights, data.offsets,
            device=dev, checkpoint_manager=mgr,
            checkpoint_every_coordinates=1, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    faults.arm("cd.update", "raise", tag="1.1")
    try:
        run()
    except faults.InjectedFault:
        pass
    else:
        raise AssertionError("the armed cd.update@1.1 fault did not fire")
    finally:
        faults.disarm_all()
    crash_by_path = dict(pk.fused_value_gradient_sums.launches_by_path)
    saves = dict(ck.CHECKPOINT_STATS)
    fetches = HOT_LOOP_STATS["snapshot_fetches"]
    torch.cuda.empty_cache()
    t = time.perf_counter()
    snap = mgr.restore()
    restore_secs = time.perf_counter() - t
    point = (snap["sweep"], snap["coordinate_index"])
    if point != (1, 1):
        raise AssertionError(f"resume point {point}, expected (1, 1)")
    res, resumed_secs = run(resume_snapshot=snap)
    resumed_by_path = dict(pk.fused_value_gradient_sums.launches_by_path)
    got = {"fixed": res.model.models["fixed"].model.coefficients.means,
           "per-user": res.model.models["per-user"].coefficients_projected}
    equal = {cid: bool(torch.equal(got[cid], want[cid])) for cid in want}
    if not all(equal.values()):
        raise AssertionError(f"resumed final states differ from phase 5's "
                             f"uninterrupted run: {equal}")
    if dev.type == "cuda" and (sum(crash_by_path.values()) <= 0
                               or crash_by_path["staged"] != 0
                               or resumed_by_path["staged"] != 0):
        raise AssertionError(f"resume phase left the stream path: "
                             f"{crash_by_path} / {resumed_by_path}")
    if fetches != saves["saves"]:
        raise AssertionError(f"{fetches} snapshot fetches for "
                             f"{saves['saves']} snapshots")
    shutil.rmtree(workdir, ignore_errors=True)
    return {
        "rows": int(data.num_samples), "resume_point": list(point),
        "snapshot_bytes": saves["bytes"],
        "snapshots_before_kill": saves["saves"],
        "save_secs_mean": saves["save_seconds"] / saves["saves"],
        "snapshot_fetches_before_kill": fetches,
        "restore_secs": restore_secs,
        "resumed_updates": [[s.iteration, s.coordinate_id]
                            for s in res.states],
        "resumed_objective": res.states[-1].objective,
        "resumed_train_secs": resumed_secs,
        "launches_by_path": {"before_kill": crash_by_path,
                             "resumed": resumed_by_path},
        "final_states_equal_phase5": equal,
    }, crash_by_path, resumed_by_path


def write_drill_fixture(workdir, rows=DRILL_ROWS, n_users=6040,
                        n_movies=3706, d_global=64) -> float:
    """Phase 7 (b)'s fixture in ``workdir/fixture`` (``workdir`` emptied
    first), written by a spawned process: the writer is pure Python, so
    in a thread it would hold the interpreter lock against the main one.
    Returns the seconds the write took."""
    import multiprocessing

    from photon_ml_tpu_torch.tools import crash_resume_drill as drill

    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    proc = multiprocessing.get_context("spawn").Process(
        target=drill.write_fixture, args=(os.path.join(workdir, "fixture"),),
        kwargs=dict(rows=rows, n_users=n_users, n_movies=n_movies,
                    d_global=d_global))
    proc.start()
    proc.join()
    if proc.exitcode != 0:
        raise RuntimeError(f"the drill's fixture writer exited "
                           f"{proc.exitcode}")
    return time.perf_counter() - t0


def drill_phase(dev, workdir, rows=DRILL_ROWS, n_users=6040, n_movies=3706,
                d_global=64, write_secs=None):
    """Phase 7 (b): the crash/resume drill's uninterrupted reference role
    as a driver process on the card, on an Avro fixture at full width
    (the drill's argv and worker role, through its ``run_roles``).
    Returns the record, the launches by role, the fixture's (training,
    validation) files, which stay in ``workdir``, and the reference
    role's output and checkpoint directories (with its kernel path), kept
    in ``workdir/reference`` for phase 17; raises on any failed check.
    ``write_secs`` says the fixture is in ``workdir`` already
    (:func:`write_drill_fixture`, run beside phases 2 and 3) and how long
    its write took; without it the fixture is written here. The drill's
    other roles run elsewhere or not at all (``reduced_roles`` says
    which)."""
    from photon_ml_tpu_torch.tools import crash_resume_drill as drill

    fixture = os.path.join(workdir, "fixture")
    if write_secs is None:
        shutil.rmtree(workdir, ignore_errors=True)
        t = time.perf_counter()
        drill.write_fixture(fixture, rows=rows, n_users=n_users,
                            n_movies=n_movies, d_global=d_global)
        write_secs = time.perf_counter() - t
    # the uninterrupted reference's output and snapshots stay for phase
    # 17, whose supervised run must end on them and whose corrupt role
    # reads a corrupted copy of them
    reference = {"out": os.path.join(workdir, "reference", "out"),
                 "ckpt": os.path.join(workdir, "reference", "ckpt")}
    shutil.rmtree(os.path.join(workdir, "reference"), ignore_errors=True)
    t0 = time.perf_counter()
    run = drill.run_roles({"reference": (drill.role_argv(
        fixture, reference["out"], reference["ckpt"], str(dev)), "")},
        timeout=600)["reference"]
    drill.check_launches("reference", run, dev)
    w = run["worker"]
    secs = w["phase_seconds"]
    # the reference read every part through the native path
    if w["ingest_parts"]["declined_parts"] \
            or w["ingest_parts"]["records_parts"] \
            or not w["ingest_parts"]["native_parts"]:
        raise AssertionError(f"drill reference: ingest left the native "
                             f"path: {w['ingest_parts']}")
    reference["expected_path"] = w["expected_path"]
    role = {"exit": run["exit"], "wall_secs": run["wall_secs"],
            **{k: w.get(k) for k in (
                "launches_by_path", "snapshot_bytes", "snapshots",
                "save_secs", "restore_secs", "phase_seconds",
                "ingest_parts")},
            "feature_map_secs": secs.get("prepareFeatureMaps"),
            "load_secs": secs.get("prepareGameDataSet"),
            "worker_secs": w.get("wall_secs")}
    return {
        "reduced": {"rows": {"train": rows[0], "validate": rows[1],
                             "configuration": 1_000_209},
                    "why": "the drill's driver processes each decode the Avro "
                           "again; the training rows keep the fixed effect "
                           "above the kernel's gate of 2**21 elements"},
        "reduced_roles": {
            "moved": {"preempt, relaunch": "phase 17 (a): the same SIGTERM "
                                           "at update 0.1, relaunched by "
                                           "the supervisor",
                      "corrupt": "phase 17 (c), on a corrupted copy of "
                                 "this reference's snapshots"},
            "left_out": ["crash", "resume"],
            "why": "phase 17 (a) resumes a SIGKILLed driver at this width "
                   "against this reference bit for bit, and phase 18's "
                   "smoke cell cd.update=kill sends the drill's kill at "
                   "an update and holds the resume to its reference bit "
                   "for bit; PERF.md section 4 gives the seconds before "
                   "and after"},
        "sweeps": drill.SWEEPS, "fixture_write_secs": write_secs,
        "fixed_effect_columns": w["fixed_effect_columns"],
        "expected_path": w["expected_path"], "roles": {"reference": role},
        "snapshot_step": drill._last_snapshot(reference["ckpt"])["step"],
        "drill_secs": time.perf_counter() - t0,
    }, {"reference": w["launches_by_path"]}, tuple(
        os.path.join(fixture, f) for f in ("train.avro", "validate.avro")), \
        reference


#: (n, d) -> (generator state after w_true, X, w_true): phases 8 and 11
#: draw the same 262,144 x 2,048 X (~15 s of numpy each), so it is drawn
#: once (to make room for phase 16)
_BENCH_X_W: dict = {}


def bench_x_w(n, d):
    """``bench.py:169-172 _data()``'s generator (seed 0), X and w_true;
    the generator comes back at its state after w_true, as if drawn
    anew, and X is shared between calls (its callers only read it)."""
    if (n, d) not in _BENCH_X_W:
        rng = np.random.default_rng(0)
        X = rng.normal(size=(n, d)).astype(np.float32)
        w_true = (rng.normal(size=d) / np.sqrt(d)).astype(np.float32)
        _BENCH_X_W[(n, d)] = (rng.bit_generator.state, X, w_true)
    state, X, w_true = _BENCH_X_W[(n, d)]
    rng = np.random.default_rng(0)
    rng.bit_generator.state = state
    return rng, X, w_true


def config2_data(n=BIG_SHAPE[0], d=BIG_SHAPE[1]):
    """BASELINE config 2's data: ``bench.py:169-177 _data()`` (seed 0,
    X and w_true), then the linear response y = X w_true + 0.1 N(0, 1),
    its noise drawn next from the same generator."""
    rng, X, w_true = bench_x_w(n, d)
    y = (X @ w_true + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def config3_data(n=CONFIG3_SHAPE[0], d=CONFIG3_SHAPE[1]):
    """BASELINE config 3's data, ``bench.py:398-405`` letter for letter."""
    rng = np.random.default_rng(1)
    X = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    w_true = np.zeros(d, np.float32)
    w_true[: d // 8] = rng.normal(size=d // 8)  # sparse truth for L1
    lam = X @ w_true
    y = rng.poisson(np.exp(np.clip(lam, -6, 3))).astype(np.float32)
    return X, y


def launch_counts() -> dict:
    """The kernel's launches since the last reset, by path and by loss."""
    from photon_ml_tpu_torch.ops import pallas_kernels as pk

    f = pk.fused_value_gradient_sums
    return {"by_path": dict(f.launches_by_path),
            "by_loss": {k: v for k, v in f.launches_by_loss.items() if v}}


def check_launches(run, counts, path, loss, dev) -> None:
    """Every launch of ``run`` on ``path`` with ``loss``, and at least one
    (on the card; CPU tensors launch nothing)."""
    total = sum(counts["by_path"].values())
    if dev.type == "cuda" and (total <= 0 or counts["by_path"][path] != total
                               or counts["by_loss"] != {loss: total}):
        raise AssertionError(f"{run}: launches {counts}, expected all on "
                             f"the {path} path with the {loss} loss")


def solver_counts() -> dict:
    """TRON's work and the solvers' blocking reads since the last reset;
    a CG iteration of the lane-batched loop is one Hessian-vector product
    call for every lane still in CG."""
    from photon_ml_tpu_torch.optimize import common, tron

    t = tron.TRON_STATS
    return {"tron_outer_iterations": t["outer_iterations"],
            "tron_cg_iterations": t["cg_iterations"],
            "hessian_vector_calls": t["cg_iterations"],
            "solver_syncs": common.SOLVER_SYNCS["count"]}


def reset_counts(torch, dev) -> None:
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.optimize import common, tron

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    pk.reset_launch_count()
    tron.reset_tron_stats()
    common.reset_solver_syncs()


def peak_memory(torch, dev):
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def kernel_gated_off():
    """Every fixed-effect evaluation inside takes the plain two-pass form
    (the kernel's element gate raised past any shape)."""
    from photon_ml_tpu_torch.ops import pallas_kernels as pk

    saved = pk.MIN_PALLAS_ELEMENTS
    pk.MIN_PALLAS_ELEMENTS = 1 << 62
    try:
        yield
    finally:
        pk.MIN_PALLAS_ELEMENTS = saved


def config2_phase(torch, dev, shape=BIG_SHAPE):
    """Phase 8 (a): BASELINE config 2 at ``bench.py``'s shape: linear
    regression, TRON + L2 (lambda 1, 15 iterations, tol 1e-5) through
    ``GLMOptimizationProblem.run`` with variances; the solution against a
    solve with the kernel gated off."""
    from photon_ml_tpu_torch.data.batch import dense_batch
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem

    t0 = time.perf_counter()
    X, y = config2_data(*shape)
    batch = dense_batch(X, y, device=dev)
    del X
    sync(torch, dev)
    data_secs = time.perf_counter() - t0
    path = pk.kernel_path(shape[1], torch.float32,
                          batch.X.data_ptr() % 16 == 0)
    problem = GLMOptimizationProblem(
        config=GLMOptimizationConfiguration.parse("15,1e-5,1,1,TRON,L2"),
        task=TaskType.LINEAR_REGRESSION, compute_variances=True)

    def solve(plain):
        """One timed solve; ``plain`` gates the kernel off."""
        t0 = time.perf_counter()
        if plain:
            with kernel_gated_off():
                out = problem.run(batch)
        else:
            out = problem.run(batch)
        sync(torch, dev)
        return out, time.perf_counter() - t0

    # a solve each way first (the first calls' lazy set-up), then the
    # kernel's solve with the counts zeroed just before and read just
    # after, then both in turns (kernel, plain, plain, kernel)
    first_secs = {"kernel": solve(False)[1], "plain": solve(True)[1]}
    reset_counts(torch, dev)
    (model, result), _ = solve(False)
    counts, work = launch_counts(), solver_counts()
    peak = peak_memory(torch, dev)
    times = {False: [], True: []}
    for plain in (False, True, True, False):
        (m, r), secs = solve(plain)
        times[plain].append(secs)
        if plain:
            plain_model, plain_result = m, r
    check_launches("config 2", counts, path, "squared", dev)
    values = result.values
    if not np.all(np.isfinite(values)) or np.any(np.diff(values) > 0):
        raise AssertionError(f"config 2: TRON's accepted values rose or "
                             f"are not finite: {values.tolist()}")
    var = model.coefficients.variances
    if var is None or not bool(torch.isfinite(var).all()) \
            or not bool((var > 0).all()):
        raise AssertionError("config 2: variances missing, not finite or "
                             "not positive")
    w, w_plain = model.coefficients.means, plain_model.coefficients.means
    rel = float((w - w_plain).norm() / w_plain.norm())
    if not rel <= 1e-4:
        raise AssertionError(f"config 2: kernel and plain-path solutions "
                             f"differ (rel {rel:.3g})")
    del batch
    return {
        "shape": list(shape), "data": "bench.py:169-177 _data() (seed 0) "
        "X and w_true; y = X w_true + 0.1 N(0, 1)",
        "config": "LINEAR_REGRESSION, TRON + L2, lambda 1, 15 iterations, "
                  "tol 1e-5, compute_variances",
        "data_secs": data_secs, "first_solve_secs": first_secs,
        "solve_secs": float(np.mean(times[False])),
        "solve_secs_turns": times[False],
        "iterations": result.iterations,
        "convergence": result.convergence_reason.value,
        "values": values.tolist(), "launches": counts, "path": path,
        **work, "max_memory_allocated": peak,
        "variances_finite_positive": True,
        "variance_range": [float(var.min()), float(var.max())],
        "plain_path": {"solve_secs": float(np.mean(times[True])),
                       "solve_secs_turns": times[True],
                       "iterations": plain_result.iterations,
                       "value": plain_result.value,
                       "rel_l2_diff_to_kernel_solution": rel},
        "value": result.value,
    }


def config3_phase(torch, dev, shape=CONFIG3_SHAPE, reps=3):
    """Phase 8 (b): BASELINE config 3 at ``bench.py:386-425``'s recipe,
    letter for letter: Poisson, elastic net (alpha 0.5, lambda 1), L-BFGS
    so OWL-QN, 50 iterations, tol 1e-7; one warm solve, then ``reps``
    timed (``solve_ms``), ``iterations`` and ``nnz_coefficients`` as
    ``bench.py`` reports them; then one solve with the kernel gated off,
    which must stop after as many iterations with the same exact zeros
    and a solution within rel 1e-4."""
    from photon_ml_tpu_torch.data.batch import dense_batch
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, OptimizerType, RegularizationContext,
        RegularizationType, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem

    X, y = config3_data(*shape)
    batch = dense_batch(X, y, device=dev)
    path = pk.kernel_path(shape[1], torch.float32,
                          batch.X.data_ptr() % 16 == 0)
    cfg = GLMOptimizationConfiguration(
        max_iterations=50, tolerance=1e-7, regularization_weight=1.0,
        optimizer_type=OptimizerType.LBFGS,
        regularization_context=RegularizationContext(
            RegularizationType.ELASTIC_NET, alpha=0.5))
    problem = GLMOptimizationProblem(config=cfg,
                                     task=TaskType.POISSON_REGRESSION)
    problem.run(batch)  # warm
    reset_counts(torch, dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        model, result = problem.run(batch)
    sync(torch, dev)
    dt = (time.perf_counter() - t0) / reps
    counts, work = launch_counts(), solver_counts()
    t0 = time.perf_counter()
    with kernel_gated_off():
        plain_model, plain_result = problem.run(batch)
    sync(torch, dev)
    plain_secs = time.perf_counter() - t0
    check_launches("config 3", counts, path, "poisson", dev)
    means = model.coefficients.means
    if not bool(torch.isfinite(means).all()) \
            or not np.all(np.isfinite(result.values)):
        raise AssertionError("config 3: non-finite coefficients or values")
    plain = plain_model.coefficients.means
    rel = float((means - plain).norm() / plain.norm())
    same_zeros = bool(torch.equal(means == 0, plain == 0))
    if plain_result.iterations != result.iterations or not same_zeros \
            or not rel <= 1e-4:
        raise AssertionError(
            f"config 3: the plain path's solve differs: iterations "
            f"{plain_result.iterations} vs {result.iterations}, same zeros "
            f"{same_zeros}, rel {rel:.3g}")
    return {
        "shape": list(shape), "data": "bench.py:398-405 (seed 1)",
        "config": "POISSON_REGRESSION, LBFGS + ELASTIC_NET (OWL-QN), "
                  "alpha 0.5, lambda 1, 50 iterations, tol 1e-7",
        "solve_ms": dt * 1e3, "reps": reps,
        "iterations": result.iterations,
        "convergence": result.convergence_reason.value,
        "nnz_coefficients": int((means.abs() > 1e-8).sum()),
        "exact_zeros": int((means == 0).sum()), "value": result.value,
        "launches": counts, "path": path,
        "solver_syncs_per_solve": work["solver_syncs"] / reps,
        "plain_path": {"solve_secs": plain_secs,
                       "iterations": plain_result.iterations,
                       "value": plain_result.value,
                       "same_exact_zeros": same_zeros,
                       "rel_l2_diff_to_kernel_solution": rel},
    }


def second_order_driver_phase(torch, dev, train, val, feature_sets,
                              workdir):
    """Phase 8 (c): the drivers on a fixture (``main`` passes the drill's,
    phase 7 (b)) and phase 6's feature sets with the second-order argvs
    (two sweeps, 4 buckets, per-user cap 128), then
    the scoring driver on the Poisson run's ``best/``. Returns the record
    and the launches by run."""
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.tools.crash_resume_drill import driver_argv
    from photon_ml_tpu_torch.tools.glmix_cases import (
        GLMIX_CASES, SECOND_ORDER_CASES)

    runs, launches, problems = {}, {}, []
    loss_of = {"linear_tron": "squared", "poisson_enet": "poisson"}
    for case in SECOND_ORDER_CASES:
        extra = GLMIX_CASES[case].argv()
        out = os.path.join(workdir, case)
        argv = driver_argv(train, val, out, str(dev), extra=[
            *extra, "--feature-name-and-term-set-path", feature_sets])
        reset_counts(torch, dev)
        t0 = time.perf_counter()
        trainer = ttd.run(argv)
        sync(torch, dev)
        secs = time.perf_counter() - t0
        counts, work = launch_counts(), solver_counts()
        peak = peak_memory(torch, dev)
        # the fixed effect's columns: the global features + the intercept
        path = pk.kernel_path(len(trainer.index_maps["global"]),
                              torch.float32, True)
        launches[case] = counts
        record = json.load(open(os.path.join(out, "metrics.json")))
        (grid,) = record["grid"]
        states = grid["states"]
        sweep_obj = [[s["objective"] for s in states
                      if s["iteration"] == it][-1] for it in range(2)]
        fixed_values = [s.tracker.result.values.tolist()
                        for s in trainer.best_result.states
                        if s.coordinate_id == "fixed"]
        # every check is run, the failures raised after the record prints
        try:
            check_launches(f"driver {case}", counts, path, loss_of[case],
                           dev)
        except AssertionError as e:
            problems.append(str(e))
        objs = [s["objective"] for s in states]
        # A fixed-effect update sees every row, so it never raises the
        # objective. A per-user update sees only the entity's active rows
        # (the cap of 128) and can raise it through the passive rows, in
        # the JAX package's drivers as in the port's: the sweep-end
        # objectives are recorded, not required to fall.
        fixed_rose = [i for i, st in enumerate(states)
                      if i and st["coordinate"] == "fixed"
                      and not objs[i] <= objs[i - 1] * (1 + 1e-6)]
        if not all(o is not None and np.isfinite(o) for o in objs):
            problems.append(f"{case}: non-finite objective {objs}")
        elif fixed_rose:
            problems.append(f"{case}: a fixed-effect update raised the "
                            f"objective: {objs}")
        if case == "linear_tron" and any(
                np.any(np.diff(v) > 0) for v in fixed_values):
            problems.append(f"{case}: TRON's accepted values rose: "
                            f"{fixed_values}")
        updates = len(states)
        runs[case] = {
            "argv_extra": extra, "training_driver_secs": secs,
            "phase_seconds": trainer.phase_seconds,
            "secs_per_update": [s["seconds"] for s in states],
            "objectives": objs, "sweep_end_objectives": sweep_obj,
            "sweep_end_rose": bool(sweep_obj[1] > sweep_obj[0]),
            "validation_metrics": [s["validation_metrics"] for s in states],
            "convergence_counts": [s["convergence_counts"] for s in states],
            "fixed_effect_iterations": [len(v) - 1 for v in fixed_values],
            "best_metric": record["best"]["metric"],
            "launches": counts, "expected_path": path, **work,
            "solver_syncs_per_update": work["solver_syncs"] / updates,
            "max_memory_allocated": peak}
        del trainer

    best = os.path.join(workdir, "poisson_enet", "best")
    score_out = os.path.join(workdir, "poisson_score")
    t0 = time.perf_counter()
    scorer = score_in_process([
        "--input-data-dirs", val, "--game-model-input-dir", best,
        "--output-dir", score_out,
        "--feature-shard-id-to-feature-section-keys-map", DRIVER_SECTIONS,
        "--random-effect-id-set", "userId",
        "--evaluator-type", "POISSON_LOSS", "--device", str(dev)])
    scoring_secs = time.perf_counter() - t0
    want = runs["poisson_enet"]["best_metric"]
    got = scorer["metrics"]["POISSON_LOSS"]
    if not abs(got - want) <= 1e-6 * abs(want):
        problems.append(f"scoring driver POISSON_LOSS {got} != best "
                        f"validation POISSON_LOSS {want}")
    shutil.rmtree(workdir, ignore_errors=True)
    record = {"fixture": train,
              "reduced": {"why": "the drill's fixture (phase 7 (b)) since "
                                 "phase 16: two full-size driver runs took "
                                 "~90 s, which phase 16 needs",
                          "scoring_driver": SCORING_IN_PROCESS},
              "runs": runs, "scoring_driver_secs": scoring_secs,
              "scoring_driver_poisson_loss": got,
              "scoring_phase_seconds": scorer["phase_seconds"]}
    print("second-order drivers: " + json.dumps(record), file=sys.stderr,
          flush=True)
    if problems:
        raise AssertionError("; ".join(problems))
    return record, launches


def second_order_small_vs_cpu(torch, n=40_000, users=500, movies=300,
                              card="cuda"):
    """Phase 8 (d): a small GLMix of each new solver on the ``card`` and on
    the CPU (as phase 5's ``glmix_small_vs_cpu``); objectives agree to
    rel 1e-4. Returns the record and the card's launches by case."""
    from photon_ml_tpu_torch.game.coordinate_descent import (
        run_coordinate_descent)
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.ops.losses import get_loss
    from photon_ml_tpu_torch.optimize.config import TASK_LOSS_NAME, TaskType
    from photon_ml_tpu_torch.tools.glmix_cases import (
        GLMIX_CASES, SECOND_ORDER_CASES)

    small = movielens_data(np.random.default_rng(3), n, users, movies, 64)
    out, launches = {}, {}
    for case in SECOND_ORDER_CASES:
        task = TaskType[GLMIX_CASES[case].task]
        objs = {}
        for where in ("cpu", card):
            dev = torch.device(where)
            coords = glmix_coordinates(small, dev, active_cap=32,
                                       feature_cap=32, case=case)
            reset_counts(torch, dev)
            res = run_coordinate_descent(
                coords, 2, task, small.responses, small.weights,
                small.offsets, device=dev)
            objs[where] = [s.objective for s in res.states]
            if where == card:
                launches[case] = launch_counts()
                X = coords["fixed"].dataset.batch.X
                check_launches(f"small GLMix {case}", launches[case],
                               pk.kernel_path(X.shape[1], X.dtype,
                                              X.data_ptr() % 16 == 0),
                               get_loss(TASK_LOSS_NAME[task]).name, dev)
        rel = max(abs(a - b) / abs(a) for a, b in zip(objs["cpu"],
                                                      objs[card]))
        if not rel <= 1e-4 or not np.all(np.isfinite(objs[card])):
            raise AssertionError(f"small GLMix {case}: card and CPU "
                                 f"objectives differ (rel {rel:.3g}): "
                                 f"{objs}")
        out[case] = {"objectives_cpu": objs["cpu"],
                       "objectives_card": objs[card],
                       "max_rel_diff": rel, "launches": launches[case]}
    return out, launches


def trace_device_busy_us(prof) -> float | None:
    """Device busy time of a ``torch.profiler`` trace: the union of its
    kernel, memcpy and memset intervals; None when it holds none."""
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name)).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo


def per_user_profile(torch, dev, dataset, extra_scores, reps=2):
    """Satellite of phase 8: one per-user update of each solver on phase
    5's per-user coordinate (1,000,209 rows, 4 buckets), under
    ``torch.profiler``: wall seconds, device busy time, the device's idle
    share and the solvers' blocking reads."""
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
    from photon_ml_tpu_torch.game.random_effect import (
        RandomEffectOptimizationProblem)
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.tools.glmix_cases import GLMIX_CASES

    out = {}
    for case, glmix in GLMIX_CASES.items():
        coord = RandomEffectCoordinate(
            dataset=dataset, problem=RandomEffectOptimizationProblem(
                config=GLMOptimizationConfiguration.parse(glmix.per_user),
                task=TaskType[glmix.task]))
        coord.update(None, extra_scores)  # warm: allocator, handles
        sync(torch, dev)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            coord.update(None, extra_scores)
            sync(torch, dev)
            walls.append(time.perf_counter() - t0)
        reset_counts(torch, dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, tracker = coord.update(None, extra_scores)
            sync(torch, dev)
            wall = time.perf_counter() - t0
        work = solver_counts()
        busy_us = trace_device_busy_us(prof)
        it = tracker.materialize().iterations
        out[case] = {
            "config": f"{glmix.task}, perUser:{glmix.per_user}",
            "wall_secs_unprofiled": walls, "wall_secs_profiled": wall,
            "device_busy_secs": None if busy_us is None else busy_us / 1e6,
            # idle share of the profiled window, and with the same busy
            # time over the unprofiled wall (the profiler slows the host)
            "device_idle_share": (None if busy_us is None
                                  else 1.0 - busy_us / 1e6 / wall),
            "device_idle_share_unprofiled_wall": (
                None if busy_us is None
                else 1.0 - busy_us / 1e6 / float(np.mean(walls))),
            **work, "entities": int(len(it)),
            "iterations_max": int(it.max()),
            "iterations_mean": float(it.mean()),
            "convergence": tracker.counts_by_convergence()}
    return out


def fresh_coordinates(coords, lane_chunk=0, down_sampling_rate=None):
    """New coordinate objects over ``coords``' datasets and configs (update
    counts and chunk tuners start anew): ``lane_chunk`` for every random
    effect, ``down_sampling_rate`` for the fixed effect."""
    import dataclasses

    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate, RandomEffectCoordinate)
    from photon_ml_tpu_torch.game.random_effect import ChunkAutoTuner

    out = {}
    for cid, c in coords.items():
        if isinstance(c, FixedEffectCoordinate):
            problem = c.problem
            if down_sampling_rate is not None:
                problem = dataclasses.replace(problem, config=(
                    dataclasses.replace(problem.config,
                                        down_sampling_rate=(
                                            down_sampling_rate))))
            out[cid] = FixedEffectCoordinate(dataset=c.dataset,
                                             problem=problem)
        else:
            out[cid] = RandomEffectCoordinate(
                dataset=c.dataset, problem=dataclasses.replace(
                    c.problem, lane_compaction_chunk=lane_chunk,
                    chunk_tuner=ChunkAutoTuner()))
    return out


def final_states(res) -> dict:
    return {cid: (m.model.coefficients.means if hasattr(m, "model")
                  else m.coefficients_projected)
            for cid, m in res.model.models.items()}


def runs_equal(torch, a, b, data, dev) -> dict:
    """Objectives, final states and training scores of two runs, each
    compared bit for bit."""
    sa, sb = final_states(a), final_states(b)
    return {
        "objectives": ([s.objective for s in a.states]
                       == [s.objective for s in b.states]),
        "states": {cid: bool(torch.equal(sa[cid], sb[cid])) for cid in sa},
        "scores": bool(torch.equal(a.model.score(data, device=dev),
                                   b.model.score(data, device=dev)))}


def all_equal(eq: dict) -> bool:
    return eq["objectives"] and all(eq["states"].values()) and eq["scores"]


def cd_run(torch, dev, data, coords, **kw):
    """Two sweeps of ``coords`` with the launch, hot-loop and solver counts
    zeroed just before; returns the result, its seconds and counts."""
    from photon_ml_tpu_torch.game.coordinate_descent import (
        HOT_LOOP_STATS, reset_hot_loop_stats, run_coordinate_descent)
    from photon_ml_tpu_torch.optimize.config import TaskType

    reset_counts(torch, dev)
    reset_hot_loop_stats()
    t0 = time.perf_counter()
    res = run_coordinate_descent(
        coords, 2, TaskType.LOGISTIC_REGRESSION, data.responses,
        data.weights, data.offsets, device=dev, **kw)
    sync(torch, dev)
    return res, {"secs": time.perf_counter() - t0,
                 "hot_loop": dict(HOT_LOOP_STATS),
                 "launches": launch_counts(), **solver_counts()}


def lane_count_dependence(torch, dataset, lane_counts=(1, 7, 16, 100)):
    """Phase 9 (b): does a lane's result depend on how many lanes share the
    dispatch? At each per-user bucket's shape and at 700 lanes of 128 rows
    of 2-128 features, on random dense blocks (the buckets' one-hot rows
    sum exactly in any order, so they could not show it): the margins and
    the gradient's row sum of gathered lanes against the same lanes of
    the full dispatch, through ``einsum`` (a batched GEMM), through
    ``DenseBatch`` (the port's elementwise product and ``sum``), and
    through ``DenseBatch`` with the lanes padded as lane compaction pads
    them (``padded_lane_count``). Returns, per shape and form, the lane
    counts whose lanes differ in any bit."""
    from photon_ml_tpu_torch.data.batch import DenseBatch
    from photon_ml_tpu_torch.optimize.common import padded_lane_count

    def forms(X, w, r, port_only=False):
        zero = torch.zeros_like(r)
        b = DenseBatch(X, zero, zero, zero)
        out = {"port_margins": b.margins(w, zero[:, 0]),
               "port_gradient_sum": b.weighted_feature_sum(r)}
        if not port_only:
            out.update(einsum_margins=torch.einsum("end,ed->en", X, w),
                       einsum_gradient_sum=torch.einsum("end,en->ed", X, r))
        return out

    out = {}
    gen = torch.Generator(device="cpu").manual_seed(0)
    dev = dataset.buckets[0].X.device
    # the buckets' shapes, then a grid of widths at 700 lanes of 128 rows
    shapes = [tuple(b.X.shape) for b in dataset.buckets] + [
        (700, 128, d) for d in (2, 4, 8, 16, 32, 64, 128)]
    for e, n, d in shapes:
        X = torch.randn(e, n, d, generator=gen).to(dev)
        w = torch.randn(e, d, generator=gen).to(dev)
        r = torch.randn(e, n, generator=gen).to(dev)
        full = forms(X, w, r)
        rng = np.random.default_rng(e)
        differ = {k: [] for k in (*full, "padded_margins",
                                  "padded_gradient_sum")}
        counts = (*lane_counts, e // 2) if e != 700 else (1, 2, 4, 8, 16,
                                                          32, 64)
        for k_lanes in sorted({min(c, e) for c in counts}):
            real = np.sort(rng.choice(e, k_lanes, replace=False))
            pad = padded_lane_count(k_lanes, e, d) - k_lanes
            rows = torch.as_tensor(real, device=dev)
            padded = torch.as_tensor(
                np.concatenate([real, real[:1].repeat(pad)]), device=dev)
            part = forms(X[rows], w[rows], r[rows])
            part.update({k.replace("port", "padded"): v[:k_lanes]
                         for k, v in forms(X[padded], w[padded], r[padded],
                                           port_only=True).items()})
            for k in differ:
                ref = full[k.replace("padded", "port")]
                if not torch.equal(part[k], ref[rows]):
                    differ[k].append(k_lanes)
        out[f"{e}x{n}x{d}"] = differ
        del X
    return out


def compaction_profile(torch, dev, dataset, extra_scores):
    """Phase 9 (b): one per-user update of each solver (phase 5's per-user
    coordinate; the per-user configs of phases 5 and 8) as one dispatch,
    with chunk 4 and with the auto-tuned chunk: coefficients, iterations
    and codes bit for bit equal; wall time, the solvers' reads and the
    active lanes of every re-dispatched chunk. No run is profiled here:
    the single dispatch's device busy time and idle share are phase 8's
    ``per_user_profile`` of the same update on the same coordinate (a
    profiled update costs ~4 s of trace processing; the chunked runs'
    profiles were cut for phase 16, the single dispatch's for phase
    18)."""
    from photon_ml_tpu_torch.game import random_effect as gre
    from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.tools.glmix_cases import GLMIX_CASES

    out, problems = {}, []
    for case, glmix in GLMIX_CASES.items():
        runs, want = {}, None
        for label, chunk in (("single", 0), ("chunk_4", 4),
                             ("auto", gre.AUTO_COMPACTION_CHUNK)):
            coord = RandomEffectCoordinate(
                dataset=dataset, problem=gre.RandomEffectOptimizationProblem(
                    config=GLMOptimizationConfiguration.parse(
                        glmix.per_user),
                    task=TaskType[glmix.task], lane_compaction_chunk=chunk))
            if want is None:
                coord.update(None, extra_scores)  # warm: allocator, handles
            sync(torch, dev)
            reset_counts(torch, dev)
            gre.reset_solve_stats()
            t0 = time.perf_counter()
            x, tracker = coord.update(None, extra_scores)
            sync(torch, dev)
            wall = time.perf_counter() - t0
            work, stats = solver_counts(), dict(gre.SOLVE_STATS)
            tracker.materialize()
            got = (x, tracker.iterations, tracker.convergence_codes)
            if want is None:
                want = got
            equal = (bool(torch.equal(got[0], want[0]))
                     and np.array_equal(got[1], want[1])
                     and np.array_equal(got[2], want[2]))
            if not equal:
                problems.append(f"{case} {label}: not equal to the single "
                                f"dispatch")
            runs[label] = {
                "wall_secs": wall, "solver_syncs": work["solver_syncs"],
                "dispatches": stats["dispatches"],
                "chunks": stats["chunks"],
                "redispatched_lanes": stats["lane_counts"],
                "compact_secs": stats["compact_secs"],
                "equal_to_single": equal}
        it = want[1]
        out[case] = {"config": f"{glmix.task}, perUser:{glmix.per_user}",
                     "entities": int(len(it)),
                     "iterations_max": int(it.max()),
                     "iterations_mean": float(it.mean()), "runs": runs}
    return out, problems


def blocked_small_vs_cpu(torch, card, n=40_000, users=500, movies=300):
    """Phase 9 (c): a small GLMix in blocks of two on the ``card`` and on
    the CPU; objectives agree to rel 1e-4."""
    small = movielens_data(np.random.default_rng(3), n, users, movies, 64)
    objs, launches = {}, None
    for where in ("cpu", card):
        d = torch.device(where)
        coords = glmix_coordinates(small, d, active_cap=32, feature_cap=32)
        res, counts = cd_run(torch, d, small, coords, block_size=2)
        objs[where] = [s.objective for s in res.states]
        if where == card:
            launches = counts["launches"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(objs["cpu"], objs[card]))
    if not rel <= 1e-4 or not np.all(np.isfinite(objs[card])):
        raise AssertionError(f"small blocked GLMix: card and CPU differ "
                             f"(rel {rel:.3g}): {objs}")
    return {"objectives_cpu": objs["cpu"], "objectives_card": objs[card],
            "max_rel_diff": rel, "launches": launches}, launches


def blocked_resume(torch, dev, data, coords, want, workdir):
    """Phase 9 (d): blocks of two, pipelined, a snapshot at every
    coordinate and ``cd.update@1.1`` raising inside sweep 1's block; fresh
    coordinates resume from the restored snapshot and must end
    ``array_equal`` to the uninterrupted blocked run ``want``."""
    from photon_ml_tpu_torch.utils import checkpoint as ck
    from photon_ml_tpu_torch.utils import faults

    shutil.rmtree(workdir, ignore_errors=True)
    mgr = ck.CheckpointManager(workdir)
    kw = dict(block_size=2, pipeline_depth=1, checkpoint_manager=mgr,
              checkpoint_every_coordinates=1)
    faults.disarm_all()
    faults.arm("cd.update", "raise", tag="1.1")
    try:
        cd_run(torch, dev, data, fresh_coordinates(coords), **kw)
    except faults.InjectedFault:
        pass
    else:
        raise AssertionError("the armed cd.update@1.1 fault did not fire")
    finally:
        faults.disarm_all()
    crash_launches = launch_counts()
    indices = sorted({mgr.restore(step=s)["coordinate_index"]
                      for s in mgr.all_steps()})
    snap = mgr.restore()
    point = (snap["sweep"], snap["coordinate_index"])
    if point != (1, 0) or indices != [0]:
        raise AssertionError(f"blocked snapshots at {indices}, resume "
                             f"point {point}: expected block boundaries "
                             f"only, resuming at (1, 0)")
    res, counts = cd_run(torch, dev, data, fresh_coordinates(coords),
                         resume_snapshot=snap, **kw)
    eq = runs_equal(torch, res, want, data, dev)
    eq["objectives"] = ([s.objective for s in res.states]
                        == [s.objective for s in want.states][2:])
    shutil.rmtree(workdir, ignore_errors=True)
    if not all_equal(eq):
        raise AssertionError(f"the resumed blocked run differs: {eq}")
    return {"resume_point": list(point), "snapshot_indices": indices,
            "equal_to_uninterrupted": eq, "resumed_secs": counts["secs"],
            "launches": {"before_raise": crash_launches,
                         "resumed": counts["launches"]}}, \
        {"before_raise": crash_launches, "resumed": counts["launches"]}


def down_sampling_check(torch, dev, data, coords):
    """Phase 9 (e): the fixed effect at rate 0.5 (logistic: the binary
    sampler). The weights sampled on the card equal the CPU's for the
    same keys; two sweeps run finite."""
    from photon_ml_tpu_torch.sampler.samplers import (
        binary_classification_down_sample)
    from photon_ml_tpu_torch.utils.prng import PRNGKey

    batch = coords["fixed"].dataset.batch
    host = batch._replace(X=batch.X[:1].cpu(), labels=batch.labels.cpu(),
                          offsets=batch.offsets.cpu(),
                          weights=batch.weights.cpu())
    keys = {}
    for seed in (0, 1):
        card = binary_classification_down_sample(batch, 0.5, PRNGKey(seed))
        cpu = binary_classification_down_sample(host, 0.5, PRNGKey(seed))
        w = card.weights.cpu()
        if not torch.equal(w, cpu.weights):
            raise AssertionError(f"down-sampled weights, key {seed}: card "
                                 f"and CPU differ")
        neg = host.labels <= 0.5
        keys[seed] = {"kept_negative_share": float(
            (w[neg] > 0).double().mean()), "weights_equal": True}
    sampled = fresh_coordinates(coords, down_sampling_rate=0.5)
    res, counts = cd_run(torch, dev, data, sampled)
    objs = [s.objective for s in res.states]
    if not np.all(np.isfinite(objs)) or sampled["fixed"]._update_count != 2:
        raise AssertionError(f"down-sampled sweeps: objectives {objs}, "
                             f"{sampled['fixed']._update_count} updates")
    check_launches("down-sampled GLMix", counts["launches"], "stream",
                   "logistic", dev)
    return {"rate": 0.5, "keys": keys, "objectives": objs,
            "secs": counts["secs"], "launches": counts["launches"]}, \
        counts["launches"]


def cd_driver_phase(torch, dev, train, val, workdir):
    """Phase 9 (f): the training driver on the drill's fixture (phase 7
    (b)) with ``CD_EXTENSION_FLAGS`` (pipelined, blocks of two, auto lane
    compaction, the fixed effect down-sampled at 0.5), then the scoring
    driver on its ``best/``."""
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.game import random_effect as gre
    from photon_ml_tpu_torch.game.coordinate_descent import (
        HOT_LOOP_STATS, reset_hot_loop_stats)
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.tools.crash_resume_drill import driver_argv
    from photon_ml_tpu_torch.tools.glmix_cases import CD_EXTENSION_FLAGS

    out = os.path.join(workdir, "train_out")
    argv = driver_argv(train, val, out, str(dev),
                       extra=list(CD_EXTENSION_FLAGS))
    reset_counts(torch, dev)
    reset_hot_loop_stats()
    gre.reset_solve_stats()
    t0 = time.perf_counter()
    trainer = ttd.run(argv)
    sync(torch, dev)
    secs = time.perf_counter() - t0
    counts, hot = launch_counts(), dict(HOT_LOOP_STATS)
    solve = dict(gre.SOLVE_STATS)
    path = pk.kernel_path(len(trainer.index_maps["global"]), torch.float32,
                          True)
    check_launches("driver with the CD extensions", counts, path,
                   "logistic", dev)
    record = json.load(open(os.path.join(out, "metrics.json")))
    (grid,) = record["grid"]
    objs = [s["objective"] for s in grid["states"]]
    if len(objs) != 4 or not all(o is not None and np.isfinite(o)
                                 for o in objs):
        raise AssertionError(f"driver with the CD extensions: objectives "
                             f"{objs}")
    if hot["epilogue_fetches"] * 2 != hot["updates"]:
        raise AssertionError(f"blocks of two: {hot}")
    scorer = score_in_process([
        "--input-data-dirs", val,
        "--game-model-input-dir", os.path.join(out, "best"),
        "--output-dir", os.path.join(workdir, "score_out"),
        "--feature-shard-id-to-feature-section-keys-map", DRIVER_SECTIONS,
        "--random-effect-id-set", "userId", "--evaluator-type", "AUC",
        "--device", str(dev)])
    best = record["best"]["metric"]
    if not abs(scorer["metrics"]["AUC"] - best) <= 1e-6:
        raise AssertionError(f"scoring driver AUC {scorer['metrics']['AUC']}"
                             f" != best validation AUC {best}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {"argv_extra": list(CD_EXTENSION_FLAGS),
            "training_driver_secs": secs,
            "phase_seconds": trainer.phase_seconds,
            "secs_per_update": [s["seconds"] for s in grid["states"]],
            "objectives": objs,
            "validation_metrics": [s["validation_metrics"]
                                   for s in grid["states"]],
            "best_metric": best, "scoring_driver_auc":
                scorer["metrics"]["AUC"],
            "reduced": {"scoring_driver": SCORING_IN_PROCESS},
            "hot_loop": hot, "solve_stats": solve,
            "launches": counts, "expected_path": path}, counts


def cd_extensions_phase(torch, dev, smi, data, coords, fixture, workdir):
    """Phase 9: the coordinate-descent extensions on the card. Returns the
    phase record and the kernel's launches by run."""
    from photon_ml_tpu_torch.game.random_effect import AUTO_COMPACTION_CHUNK

    t_all = time.perf_counter()
    launches, secs, mark = {}, {}, [t_all]

    def lap(part):
        now = time.perf_counter()
        secs[part], mark[0] = now - mark[0], now

    # (a) pipelined against sequential
    seq, seq_counts = cd_run(torch, dev, data, fresh_coordinates(coords),
                             pipeline_depth=0)
    pipe, pipe_counts = cd_run(torch, dev, data, fresh_coordinates(coords),
                               pipeline_depth=1)
    eq = runs_equal(torch, seq, pipe, data, dev)
    if not all_equal(eq):
        raise AssertionError(f"pipelined != sequential: {eq}")
    launches.update(sequential=seq_counts["launches"],
                    pipelined=pipe_counts["launches"])
    pipelined = {"equal": eq,
                 "objectives": [s.objective for s in pipe.states],
                 "sequential": {k: seq_counts[k] for k in (
                     "secs", "hot_loop", "solver_syncs")},
                 "pipelined": {k: pipe_counts[k] for k in (
                     "secs", "hot_loop", "solver_syncs")}}
    print("phase 9 (a): " + json.dumps(pipelined), file=sys.stderr,
          flush=True)
    lap("a")
    # (b) lane compaction, one per-user update of each solver
    extra = coords["fixed"].score(final_states(seq)["fixed"])
    compaction, problems = compaction_profile(
        torch, dev, coords["per-user"].dataset, extra)
    compaction["lane_count_dependence"] = dependence = \
        lane_count_dependence(torch, coords["per-user"].dataset)
    print("phase 9 (b): " + json.dumps(compaction), file=sys.stderr,
          flush=True)
    if any(v["padded_margins"] or v["padded_gradient_sum"]
           for v in dependence.values()):
        problems.append(f"a padded lane's results depend on the lane "
                        f"count: {dependence}")
    if problems:
        raise AssertionError("; ".join(problems))
    lap("b")
    # (c) blocks of two beside the sequential sweep
    blk, blk_counts = cd_run(torch, dev, data, fresh_coordinates(coords),
                             block_size=2)
    objs = [s.objective for s in blk.states]
    hot = blk_counts["hot_loop"]
    if not np.all(np.isfinite(objs)) or \
            hot["epilogue_fetches"] * 2 != hot["updates"]:
        raise AssertionError(f"blocked sweep: objectives {objs}, {hot}")
    small, small_launches = blocked_small_vs_cpu(torch, dev.type)
    launches.update(blocked=blk_counts["launches"],
                    small_blocked_cuda=small_launches)
    blocked = {
        "objectives": objs, "hot_loop": hot, "secs": blk_counts["secs"],
        "sweep_end_objectives": {
            "sequential": [seq.states[1].objective, seq.states[3].objective],
            "blocked": [objs[1], objs[3]]},
        "small_vs_cpu": small}
    lap("c")
    # (d) resume under blocks
    resumed, resume_launches = blocked_resume(
        torch, dev, data, coords, blk, os.path.join(workdir, "ckpt"))
    launches.update({f"blocked_resume_{k}": v
                     for k, v in resume_launches.items()})
    lap("d")
    # (e) down-sampling
    down, down_launches = down_sampling_check(torch, dev, data, coords)
    launches["down_sampled"] = down_launches
    lap("e")
    # (f) the drivers, on the drill's fixture
    driver, driver_launches = cd_driver_phase(
        torch, dev, *fixture, os.path.join(workdir, "driver"))
    launches["driver"] = driver_launches
    lap("f")
    return {"phase": "cd_extensions", "nvidia_smi": smi,
            "rows": int(data.num_samples),
            "auto_compaction_chunk": AUTO_COMPACTION_CHUNK,
            "pipelined": pipelined, "compaction": compaction,
            "blocked": blocked, "blocked_resume": resumed,
            "down_sampling": down, "driver": driver, "part_seconds": secs,
            "reduced": {"b": "the single dispatch's profiled update is not "
                             "run again here: its device busy time and "
                             "idle share are phase 8's per_user_profile "
                             "of the same update (~4 s of trace "
                             "processing a solver); PERF.md section 4 "
                             "gives the seconds before and after"},
            "seconds": time.perf_counter() - t_all}, launches


# BASELINE config 5 (bench.py:1226 bench_game_full): rows, users, movies,
# global features, the data seed, and the MF scoring pass's latent width
CONFIG5 = dict(n=400_000, users=6040, movies=3706, d_global=32, seed=11,
               latent_dim=8)


def factored_coordinates(data, device, active_cap=128, lane_chunk=0):
    """Phase 10's coordinates: ``fixed`` as in phase 5, and ``perUserFac``,
    a factored random effect over ``userId`` on the 64 global features
    (IDENTITY projection, one block, active cap ``active_cap``) with
    ``FACTORED_CONFIG``. The per-user movie shard cannot carry it: over
    its 3,706 one-hot columns the Kronecker rows would be K x 3,706 =
    29,648 wide, past the kernel's 4,096 and some 92 GB at full width."""
    from photon_ml_tpu_torch.cli.game_training_driver import (
        _parse_factored_grid)
    from photon_ml_tpu_torch.game.coordinate import (
        FactoredRandomEffectCoordinate, FixedEffectCoordinate)
    from photon_ml_tpu_torch.game.dataset import (
        RandomEffectDataConfiguration, build_fixed_effect_dataset,
        build_random_effect_dataset)
    from photon_ml_tpu_torch.game.random_effect import (
        RandomEffectOptimizationProblem)
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.projector.projectors import (
        ProjectorConfig, ProjectorType)
    from photon_ml_tpu_torch.tools.glmix_cases import (
        FACTORED_CONFIG, GLMIX_CASES)

    glmix = GLMIX_CASES["lbfgs"]
    task = TaskType[glmix.task]
    (re_cfg, latent_cfg, mf_cfg), = _parse_factored_grid(
        f"perUserFac:{FACTORED_CONFIG}")[0].values()
    data_cfg = RandomEffectDataConfiguration(
        "userId", "global", num_active_data_points_upper_bound=active_cap,
        projector=ProjectorConfig(ProjectorType.IDENTITY))
    return {
        "fixed": FixedEffectCoordinate(
            dataset=build_fixed_effect_dataset(data, "global",
                                               device=device),
            problem=GLMOptimizationProblem(
                config=GLMOptimizationConfiguration.parse(glmix.fixed),
                task=task)),
        "perUserFac": FactoredRandomEffectCoordinate(
            dataset=build_random_effect_dataset(data, data_cfg,
                                                device=device),
            problem=RandomEffectOptimizationProblem(
                config=re_cfg, task=task, lane_compaction_chunk=lane_chunk),
            latent_problem=GLMOptimizationProblem(config=latent_cfg,
                                                  task=task),
            latent_dim=mf_cfg.num_factors,
            num_inner_iterations=mf_cfg.max_number_iterations)}


def factored_final(res) -> dict:
    """The run's final states: the fixed effect's coefficients and the
    factored coordinate's (coefs, B)."""
    m = res.model.models
    return {"fixed": m["fixed"].model.coefficients.means,
            "perUserFac": (m["perUserFac"].coefficients_latent,
                           m["perUserFac"].projection)}


def factored_equal(torch, a, b, skip: int = 0) -> bool:
    """Two factored runs equal bit for bit: the objectives (of ``b``'s
    updates after its first ``skip``, for a run resumed after them) and
    the final states."""
    fa, fb = factored_final(a), factored_final(b)
    return ([s.objective for s in a.states]
            == [s.objective for s in b.states[skip:]]
            and torch.equal(fa["fixed"], fb["fixed"])
            and all(torch.equal(x, y) for x, y in zip(fa["perUserFac"],
                                                      fb["perUserFac"])))


def factored_run(torch, dev, data, coords, sweeps=2, **kw):
    """Coordinate descent of ``coords`` with the launches counted around
    it: (result, {"launches", "secs", "peak_memory"})."""
    from photon_ml_tpu_torch.game.coordinate_descent import (
        run_coordinate_descent)
    from photon_ml_tpu_torch.optimize.config import TaskType

    reset_counts(torch, dev)
    t0 = time.perf_counter()
    res = run_coordinate_descent(
        coords, sweeps, TaskType.LOGISTIC_REGRESSION, data.responses,
        data.weights, data.offsets, device=dev, **kw)
    sync(torch, dev)
    return res, {"launches": launch_counts(),
                 "secs": time.perf_counter() - t0,
                 "peak_memory": peak_memory(torch, dev)}


def refit_batch(torch, model, fac_dataset, data, dev):
    """The refit's Kronecker batch at a trained factored model (a
    ``GameModel`` with ``fixed`` and ``perUserFac``), the fixed effect's
    scores as the other coordinates', and B flattened."""
    from photon_ml_tpu_torch.game.coordinate import (
        FactoredRandomEffectCoordinate)

    fac = model.models["perUserFac"]
    coord = FactoredRandomEffectCoordinate(
        dataset=fac_dataset, problem=None, latent_problem=None,
        latent_dim=int(fac.coefficients_latent.shape[1]))
    extra = model.models["fixed"].score(data, device=dev)
    batch = coord.kronecker_batch(fac.coefficients_latent,
                                  fac_dataset.offsets_with(extra))
    return batch, fac.projection.reshape(-1).contiguous()


def check_refit(torch, model, fac_dataset, data, dev) -> dict:
    """The kernel against its plain version on the refit's batch at a
    trained factored model: the shape, the largest |delta| of the vector
    sum, the worst tolerance ratio."""
    from photon_ml_tpu_torch.ops.losses import get_loss

    batch, w = refit_batch(torch, model, fac_dataset, data, dev)
    err, worst = check_sums(torch, get_loss("logistic"), batch.X,
                            batch.labels, batch.offsets, batch.weights, w,
                            torch.zeros((), device=dev), scaled=True)
    return {"shape": list(batch.X.shape), "max_abs_err": err,
            "worst_delta_over_tolerance": worst}


def factored_library_phase(torch, dev, data, hbm):
    """Phase 10 (a) and (b): the factored GLMix at full width, then the
    kernel on the refit's real Kronecker batch against its plain version,
    and timed."""
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.ops.losses import get_loss

    t0 = time.perf_counter()
    coords = factored_coordinates(data, dev)
    fac = coords["perUserFac"]
    e, n, d = (int(v) for v in fac.dataset.X.shape)
    k = fac.latent_dim
    sync(torch, dev)
    build_secs = time.perf_counter() - t0
    res, counts = factored_run(
        torch, dev, data, coords,
        logger=lambda s: print(s, file=sys.stderr, flush=True))
    states = res.states
    objs = [s.objective for s in states]
    refit_path = pk.kernel_path(k * d, torch.float32, True)
    by_path = counts["launches"]["by_path"]
    problems = []
    if not all(np.isfinite(objs)):
        problems.append(f"objectives {objs}")
    # a fixed-effect update never raises the objective; a capped per-user
    # update may (its passive rows), as in both packages
    for i, s in enumerate(states):
        if s.coordinate_id == "fixed" and i and \
                not s.objective <= states[i - 1].objective * (1 + 1e-6):
            problems.append(f"fixed-effect update {i} raised the "
                            f"objective: {objs}")
    if dev.type == "cuda" and (
            refit_path != "staged" or by_path["staged"] <= 0
            or by_path["stream"] <= 0
            or counts["launches"]["by_loss"] != {
                "logistic": sum(by_path.values())}):
        # the refit's 2 KB rows take the staged path, the fixed effect's
        # 256-byte rows the stream path
        problems.append(f"launches {counts['launches']}, refit path "
                        f"{refit_path}")
    if problems:
        raise AssertionError("factored GLMix: " + "; ".join(problems))
    updates = [{"sweep": s.iteration, "coordinate": s.coordinate_id,
                "objective": s.objective, "seconds": s.seconds,
                **({"inner": [
                    {"latent_iterations_max": int(np.max(
                        re_t.materialize().iterations)),
                     "refit_iterations": fe_t.materialize()
                     .result.iterations,
                     "refit_value": fe_t.result.value}
                    for re_t, fe_t in s.tracker.inner]}
                   if s.coordinate_id == "perUserFac" else
                   {"iterations": s.tracker.result.iterations})}
               for s in states]
    # (b) the kernel on the refit's batch at the final state, against its
    # plain version, then timed (after the counts were read)
    batch, w = refit_batch(torch, res.model, fac.dataset, data, dev)
    kron_bytes = batch.X.numel() * batch.X.element_size()
    loss = get_loss("logistic")
    zero = torch.zeros((), device=dev)
    err, worst = check_sums(torch, loss, batch.X, batch.labels,
                            batch.offsets, batch.weights, w, zero,
                            scaled=True)
    rows = time_kernel(torch, hbm, loss, batch.X, batch.labels,
                       batch.offsets, batch.weights, w, zero)
    del batch
    torch.cuda.empty_cache()
    return {"rows": int(data.num_samples), "entities": e,
            "rows_per_entity": n, "features": d, "latent_dim": k,
            "passive_rows": fac.dataset.num_passive,
            "build_secs": build_secs, "train_secs": counts["secs"],
            "updates": updates, "objectives": objs,
            "kronecker_shape": [e * n, k * d], "kronecker_bytes": kron_bytes,
            "refit_path": refit_path, "launches": counts["launches"],
            "max_memory_allocated": counts["peak_memory"],
            "kernel_vs_plain": {"max_abs_err": err,
                                "worst_delta_over_tolerance": worst}}, \
        counts["launches"], rows


def factored_small_phase(torch, dev, workdir, n=40_000, users=500,
                         movies=300):
    """Phase 10 (c): a small factored GLMix (active cap 32) on the card and
    on the CPU, objectives within rel 1e-3; on the card depth 0 equal to
    depth 1 bit for bit, and a run killed at update (1, 1) and resumed
    equal to the uninterrupted one bit for bit.

    Not rel 1e-4: each alternation's per-entity solves stop on
    FunctionValuesConverged and its refit after all 20 iterations, so the
    card's and the CPU's reduction orders end them at f32 points apart
    that the next step carries on, while a factored update moves the
    objective up to fivefold. On an NVIDIA H100 80GB HBM3 at 700 W the
    card and the CPU differed by 1.19e-4 here, and the JAX package and
    the port, both on the CPU, differ by more than 1e-4 at this size
    too."""
    from photon_ml_tpu_torch.utils import faults
    from photon_ml_tpu_torch.utils.checkpoint import CheckpointManager

    small = movielens_data(np.random.default_rng(3), n, users, movies, 64)
    objs, launches = {}, {}
    for where in ("cpu", dev):
        coords = factored_coordinates(small, where, 32)
        res, counts = factored_run(torch, torch.device(where), small, coords)
        objs[str(where)] = [s.objective for s in res.states]
    refit_check = check_refit(torch, res.model,
                              coords["perUserFac"].dataset, small, dev)
    card = str(dev)
    rel = max(abs(a - b) / abs(a) for a, b in zip(objs["cpu"], objs[card]))
    depth1, launches["depth1"] = res, counts["launches"]
    depth0, counts = factored_run(torch, dev, small,
                                  factored_coordinates(small, dev, 32),
                                  pipeline_depth=0)
    launches["depth0"] = counts["launches"]
    shutil.rmtree(workdir, ignore_errors=True)
    mgr = CheckpointManager(workdir)
    faults.arm("cd.update", "raise", tag="1.1")
    try:
        factored_run(torch, dev, small, factored_coordinates(small, dev, 32),
                     checkpoint_manager=mgr, checkpoint_every_coordinates=1)
    except faults.InjectedFault:
        pass
    else:
        raise AssertionError("the armed fault did not stop the run")
    finally:
        faults.disarm_all()
    snap = mgr.restore()
    resumed, counts = factored_run(torch, dev, small,
                                   factored_coordinates(small, dev, 32),
                                   resume_snapshot=snap)
    launches["resumed"] = counts["launches"]
    resume_equal = factored_equal(torch, resumed, depth1, skip=3)
    record = {"rows": n, "objectives": objs, "max_rel_diff": rel,
              "depth0_equals_depth1": factored_equal(torch, depth0, depth1),
              "resume_step": [snap["sweep"], snap["coordinate_index"]],
              "resumed_equals_uninterrupted": resume_equal,
              "refit_kernel_vs_plain": refit_check}
    if not (rel <= 1e-3 and record["depth0_equals_depth1"]
            and resume_equal and record["resume_step"] == [1, 1]):
        raise AssertionError(f"small factored GLMix: {record}")
    shutil.rmtree(workdir, ignore_errors=True)
    return record, launches


def factored_driver_phase(torch, dev, train, val, workdir):
    """Phase 10 (d): the training driver with ``FACTORED_FLAGS`` on the
    drill's fixture (the fixed effect and the factored coordinate over the
    64 global features + intercept, so K·D = 520), then the scoring driver
    on its ``best/``: its AUC the best state's, the model a plain
    random-effect directory."""
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.tools.crash_resume_drill import driver_argv
    from photon_ml_tpu_torch.tools.glmix_cases import FACTORED_FLAGS

    out = os.path.join(workdir, "train_out")
    argv = driver_argv(train, val, out, str(dev), extra=list(FACTORED_FLAGS))
    reset_counts(torch, dev)
    t0 = time.perf_counter()
    trainer = ttd.run(argv)
    sync(torch, dev)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    check_launches("factored driver", counts, "staged", "logistic", dev)
    record = json.load(open(os.path.join(out, "metrics.json")))
    (grid,) = record["grid"]
    objs = [s["objective"] for s in grid["states"]]
    if len(objs) != 4 or not all(o is not None and np.isfinite(o)
                                 for o in objs):
        raise AssertionError(f"factored driver: objectives {objs}")
    # the refit's shape at the drivers' width (K·D = 8 x 65), against the
    # plain version, on the dataset the driver built (the same seed)
    from photon_ml_tpu_torch.game.dataset import build_random_effect_dataset

    refit_check = check_refit(
        torch, trainer.best_result.model, build_random_effect_dataset(
            trainer.train_data, trainer.random_data_configs["perUserFac"],
            device=dev), trainer.train_data, dev)
    best_dir = os.path.join(out, "best")
    saved = sorted(os.listdir(os.path.join(best_dir, "random-effect")))
    loaded, _ = load_game_model(best_dir)
    kinds = {c: type(m).__name__ for c, m in loaded.models.items()}
    if saved != ["perUserFac"] or kinds["perUserFac"] != "RandomEffectModel":
        raise AssertionError(f"factored driver saved {saved} as {kinds}")
    # both coordinates read the global shard only
    scorer = score_in_process([
        "--input-data-dirs", val, "--game-model-input-dir", best_dir,
        "--output-dir", os.path.join(workdir, "score_out"),
        "--feature-shard-id-to-feature-section-keys-map",
        "global:globalFeatures",
        "--random-effect-id-set", "userId", "--evaluator-type", "AUC",
        "--device", str(dev)])
    best = record["best"]["metric"]
    if not abs(scorer["metrics"]["AUC"] - best) <= 1e-6:
        raise AssertionError(f"scoring driver AUC {scorer['metrics']['AUC']}"
                             f" != best validation AUC {best}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {"argv_extra": list(FACTORED_FLAGS), "training_driver_secs": secs,
            "phase_seconds": trainer.phase_seconds,
            "secs_per_update": [s["seconds"] for s in grid["states"]],
            "objectives": objs, "best_metric": best,
            "scoring_driver_auc": scorer["metrics"]["AUC"],
            "reduced": {"scoring_driver": SCORING_IN_PROCESS},
            "saved_random_effects": saved, "loaded_as": kinds,
            "refit_kernel_vs_plain": refit_check, "launches": counts}, \
        counts


def config5_phase(torch, dev, workdir, hbm, n=CONFIG5["n"],
                  users=CONFIG5["users"], movies=CONFIG5["movies"]):
    """Phase 10 (e): BASELINE config 5 at ``bench.py:1226``'s parameters
    (fixed + per-user + per-item, one sweep), its fixed effect's kernel
    timed on the real batch, then the MF scoring pass over random factor
    tables: rows per second, equal to a host numpy gather-dot, and equal
    again after a LatentFactorAvro round trip."""
    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate, RandomEffectCoordinate)
    from photon_ml_tpu_torch.game.dataset import (
        RandomEffectDataConfiguration, build_fixed_effect_dataset,
        build_random_effect_dataset)
    from photon_ml_tpu_torch.game.models import (
        MatrixFactorizationModel, score_factors)
    from photon_ml_tpu_torch.game.random_effect import (
        RandomEffectOptimizationProblem)
    from photon_ml_tpu_torch.io.model_io import (
        load_matrix_factorization_model, save_matrix_factorization_model)
    from photon_ml_tpu_torch.ops.losses import get_loss
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem

    t0 = time.perf_counter()
    rng = np.random.default_rng(CONFIG5["seed"])
    data = movielens_data(rng, n, users, movies, CONFIG5["d_global"],
                          with_item_effect=True)
    parse = GLMOptimizationConfiguration.parse
    task = TaskType.LOGISTIC_REGRESSION

    def per_entity(id_type, shard):
        return RandomEffectCoordinate(
            dataset=build_random_effect_dataset(
                data, RandomEffectDataConfiguration(
                    id_type, shard, num_active_data_points_upper_bound=64,
                    num_features_to_keep_upper_bound=64),
                num_buckets=3, device=dev),
            problem=RandomEffectOptimizationProblem(
                config=parse("15,1e-7,1,1,LBFGS,L2"), task=task))

    coords = {
        "fixed": FixedEffectCoordinate(
            dataset=build_fixed_effect_dataset(data, "global", device=dev),
            problem=GLMOptimizationProblem(
                config=parse("30,1e-7,10,1,LBFGS,L2"), task=task)),
        "per-user": per_entity("userId", "per_user"),
        "per-item": per_entity("movieId", "per_item")}
    sync(torch, dev)
    build_secs = time.perf_counter() - t0
    res, counts = factored_run(torch, dev, data, coords, sweeps=1)
    fixed_path = paths_for(coords["fixed"].dataset.batch.X)[0]
    check_launches("config 5", counts["launches"], fixed_path, "logistic",
                   dev)
    objs = [s.objective for s in res.states]
    if not all(np.isfinite(objs)):
        raise AssertionError(f"config 5: objectives {objs}")
    # the fixed effect's batch with the two random effects' scores as
    # offsets, kernel against plain, then timed
    m = res.model.models
    batch = coords["fixed"].dataset.with_offsets(
        coords["per-user"].score(m["per-user"].coefficients_projected)
        + coords["per-item"].score(m["per-item"].coefficients_projected))
    loss, zero = get_loss("logistic"), torch.zeros((), device=dev)
    w = m["fixed"].model.coefficients.means.contiguous()
    err, worst = check_sums(torch, loss, batch.X, batch.labels,
                            batch.offsets, batch.weights, w, zero,
                            scaled=True)
    rows = time_kernel(torch, hbm, loss, batch.X, batch.labels,
                       batch.offsets, batch.weights, w, zero)
    # the MF scoring pass (bench.py:1315-1333): tables drawn next from the
    # same generator, cut to the ids the data holds
    k = CONFIG5["latent_dim"]
    rf = rng.normal(size=(users, k)).astype(np.float32)
    cf = rng.normal(size=(movies, k)).astype(np.float32)
    vocabs = {t: data.id_vocabs[t] for t in ("userId", "movieId")}
    mf = MatrixFactorizationModel(
        "userId", "movieId",
        torch.from_numpy(rf[:len(vocabs["userId"])]).to(dev),
        torch.from_numpy(cf[:len(vocabs["movieId"])]).to(dev))
    scores = mf.score(data, device=dev)
    u, v = data.id_columns["userId"], data.id_columns["movieId"]
    host = np.sum(rf[u] * cf[v], axis=-1)
    mf_err = float(np.abs(scores.cpu().numpy() - host).max())
    r_t = torch.as_tensor(u, device=dev)
    c_t = torch.as_tensor(v, device=dev)
    mf_times = cuda_times(torch, lambda: score_factors(
        mf.row_factors, mf.col_factors, r_t, c_t))
    save_matrix_factorization_model(mf, workdir, entity_vocabs=vocabs)
    back = load_matrix_factorization_model(workdir, "userId", "movieId")
    round_trip_equal = bool(torch.equal(back.score(data, device=dev),
                                        scores))
    shutil.rmtree(workdir, ignore_errors=True)
    record = {
        "rows": n, "users": len(vocabs["userId"]),
        "movies": len(vocabs["movieId"]), "d_global": CONFIG5["d_global"],
        "buckets": {c: [list(b.X.shape) for b in coords[c].dataset.buckets]
                    for c in ("per-user", "per-item")},
        "build_secs": build_secs, "sweep_secs": counts["secs"],
        "objectives": objs,
        "secs_per_update": [s.seconds for s in res.states],
        "launches": counts["launches"], "fixed_path": fixed_path,
        "max_memory_allocated": counts["peak_memory"],
        "kernel_vs_plain": {"max_abs_err": err,
                            "worst_delta_over_tolerance": worst},
        "mf": {"latent_dim": k, "score_ms": mf_times["ms"],
               "rows_per_sec": n / (mf_times["ms"] / 1e3),
               "max_abs_err_vs_host": mf_err,
               "latent_factor_round_trip_equal": round_trip_equal}}
    if not (mf_err <= 1e-5 * max(1.0, float(np.abs(host).max()))
            and round_trip_equal):
        raise AssertionError(f"config 5 MF scoring: {record['mf']}")
    return record, counts["launches"], rows


def factored_phase(torch, dev, smi, data, fixture, workdir, hbm):
    """Phase 10: factored random effects, the drivers with them, and
    BASELINE config 5. Returns the phase record, the kernel's launches by
    run, the kernel-vs-plain errors and the new timing rows."""
    t_all = time.perf_counter()
    secs, mark = {}, [t_all]

    def lap(part):
        now = time.perf_counter()
        secs[part], mark[0] = now - mark[0], now

    library, lib_launches, refit_rows = factored_library_phase(
        torch, dev, data, hbm)
    print("phase 10 (a, b): " + json.dumps(library), file=sys.stderr,
          flush=True)
    lap("a_b")
    small, small_launches = factored_small_phase(
        torch, dev, os.path.join(workdir, "small_ckpt"))
    lap("c")
    driver, driver_launches = factored_driver_phase(
        torch, dev, *fixture, os.path.join(workdir, "driver"))
    lap("d")
    config5, c5_launches, c5_rows = config5_phase(
        torch, dev, os.path.join(workdir, "mf"), hbm)
    lap("e")
    launches = {"library": lib_launches, "driver": driver_launches,
                "config5": c5_launches,
                **{f"small_{k}": v for k, v in small_launches.items()}}
    errs = [library["kernel_vs_plain"]["max_abs_err"],
            small["refit_kernel_vs_plain"]["max_abs_err"],
            driver["refit_kernel_vs_plain"]["max_abs_err"],
            config5["kernel_vs_plain"]["max_abs_err"]]
    return {"phase": "factored", "nvidia_smi": smi, "library": library,
            "small": small, "driver": driver, "config5": config5,
            "timing": [*refit_rows.values(), *c5_rows.values()],
            "part_seconds": secs,
            "seconds": time.perf_counter() - t_all}, launches, errs, \
        [*refit_rows.values(), *c5_rows.values()]


# -- phase 11: the single-GLM path (BASELINE config 1) ----------------------



def config1_data(n=BIG_SHAPE[0], d=BIG_SHAPE[1]):
    """BASELINE config 1's library shape: ``bench.py:169-176 _data()``
    letter for letter (seed 0; X, w_true, then the logistic labels)."""
    rng, X, w_true = bench_x_w(n, d)
    p = 1.0 / (1.0 + np.exp(-(X @ w_true)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return X, y


def write_a1a_like(directory, rows=A1A_ROWS, seed=21) -> tuple:
    """The a1a-shaped LibSVM pair (train, test): each row takes one
    feature of each of the 14 groups (a group is skipped with probability
    0.02, as a1a's rows hold about 14 non-zeros), labels from one fixed
    logistic model over the 123 one-hot columns. Returns the two paths."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    starts = np.cumsum((0,) + A1A_GROUPS[:-1])
    w = rng.normal(size=A1A_FEATURES) * 0.8
    paths = []
    for name, n in zip(("a1a.train", "a1a.test"), rows):
        pick = np.stack([s + rng.integers(0, g, size=n)
                         for s, g in zip(starts, A1A_GROUPS)], axis=1)
        keep = rng.random(pick.shape) >= 0.02
        z = (w[pick] * keep).sum(1) - 1.0
        y = rng.random(n) < 1.0 / (1.0 + np.exp(-z))
        lines = []
        for i in range(n):
            feats = " ".join(f"{j + 1}:1" for j in pick[i][keep[i]])
            lines.append(f"{'+1' if y[i] else '-1'} {feats}")
        path = os.path.join(directory, name)
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        paths.append(path)
    return tuple(paths)


@contextlib.contextmanager
def timed_solves(torch, dev, record: list):
    """Each ``GLMOptimizationProblem.run`` of ``train_glm_grid`` inside
    appends ``(lambda, seconds)`` to ``record``, synchronised."""
    from photon_ml_tpu_torch import training

    cls = training.GLMOptimizationProblem
    saved = cls.run

    def run(self, batch, initial=None):
        t0 = time.perf_counter()
        out = saved(self, batch, initial)
        sync(torch, dev)
        record.append((self.config.regularization_weight,
                       time.perf_counter() - t0))
        return out

    cls.run = run
    try:
        yield
    finally:
        cls.run = saved


def rel_diff(torch, a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def config1_library_phase(torch, dev, shape=BIG_SHAPE):
    """Phase 11 (a): ``train_glm_grid`` at ``bench.py``'s config-1 shape
    (logistic, L-BFGS + L2, lambda 10, 1, 0.1 warm-started, at most 80
    iterations, tol 1e-6: the legacy defaults), against the grid with the
    kernel gated off; ``evaluate_model_grid`` against one call a model;
    a box on the first 16 coordinates with the iterates tracked."""
    from photon_ml_tpu_torch.data.batch import dense_batch
    from photon_ml_tpu_torch.evaluation.model_evaluation import (
        evaluate_model, evaluate_model_grid)
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.optimize.common import BoxConstraints
    from photon_ml_tpu_torch.optimize.config import TaskType
    from photon_ml_tpu_torch.training import train_glm_grid

    t0 = time.perf_counter()
    X, y = config1_data(*shape)
    batch = dense_batch(X, y, device=dev)
    del X
    sync(torch, dev)
    data_secs = time.perf_counter() - t0
    task = TaskType.LOGISTIC_REGRESSION
    path = pk.kernel_path(shape[1], torch.float32,
                          batch.X.data_ptr() % 16 == 0)

    def grid(**kw):
        return train_glm_grid(batch, task, CONFIG1_LAMBDAS,
                              max_iterations=80, tolerance=1e-6, **kw)

    reset_counts(torch, dev)
    per_lambda: list = []
    t1 = time.perf_counter()
    with timed_solves(torch, dev, per_lambda):
        models = grid()
    grid_secs = time.perf_counter() - t1
    counts, work = launch_counts(), solver_counts()
    peak = peak_memory(torch, dev)
    check_launches("config 1 grid", counts, path, "logistic", dev)
    t1 = time.perf_counter()
    with kernel_gated_off():
        plain = grid()
    sync(torch, dev)
    plain_secs = time.perf_counter() - t1
    # the two grids sum in other orders and each solve stops where its
    # f32 objective moves by <= 1e-6 of f0: the objectives are held to rel
    # 1e-4, the coefficients (loose by that stopping noise, some 1e-3 of
    # their norm here) to rel 1e-3
    value_rel = [abs(m.result.value - p.result.value) / abs(p.result.value)
                 for m, p in zip(models, plain)]
    coef_rel = [rel_diff(torch, m.model.coefficients.means,
                         p.model.coefficients.means)
                for m, p in zip(models, plain)]
    if not (max(value_rel) <= 1e-4 and max(coef_rel) <= 1e-3):
        raise AssertionError(f"config 1: kernel and plain grids differ: "
                             f"objectives rel {value_rel}, coefficients "
                             f"rel {coef_rel}")
    for m in models:
        if not np.all(np.isfinite(m.result.values)):
            raise AssertionError(f"config 1: non-finite objective at "
                                 f"lambda {m.regularization_weight}")

    # the metric grid against one call a model (cuBLAS picks its GEMM by
    # shape, so not bit for bit)
    glms = [m.model for m in models]
    evaluate_model_grid(glms, batch)
    t1 = time.perf_counter()
    grid_maps = evaluate_model_grid(glms, batch)
    eval_grid_secs = time.perf_counter() - t1
    t1 = time.perf_counter()
    single_maps = [evaluate_model(g, batch) for g in glms]
    eval_single_secs = time.perf_counter() - t1
    eval_rel = max(abs(s[k] - g[k]) / max(abs(g[k]), 1e-12)
                   for g, s in zip(grid_maps, single_maps) for k in g)
    if not eval_rel <= 1e-6:
        raise AssertionError(f"config 1: evaluate_model_grid differs from "
                             f"evaluate_model (rel {eval_rel:.3g}): "
                             f"{grid_maps} against {single_maps}")

    # a box on the first 16 coordinates, the iterates tracked
    box = BoxConstraints.from_map(
        shape[1], {i: (-0.01, 0.01) for i in range(16)}, device=dev)
    boxed = train_glm_grid(batch, task, (1.0,), max_iterations=80,
                           tolerance=1e-6, box=box, track_iterates=True)[0]
    x = boxed.result.coefficients[:16]
    if not bool(((x >= -0.01) & (x <= 0.01)).all()):
        raise AssertionError("config 1: a boxed coefficient left its box")
    on_bound = int(((x == -0.01) | (x == 0.01)).sum())
    if on_bound < 1:
        raise AssertionError("config 1: no coefficient on a bound")
    its = boxed.result.iterates
    if its.shape != (boxed.result.iterations + 1, shape[1]) or not \
            np.array_equal(its[-1], boxed.result.coefficients.cpu().numpy()):
        raise AssertionError("config 1: the last tracked iterate is not "
                             "the solution")
    out = {
        "shape": list(shape),
        "data": "bench.py:169-176 _data() (seed 0), logistic labels",
        "config": "LOGISTIC_REGRESSION, L-BFGS + L2, lambda 10, 1, 0.1 "
                  "warm-started, <= 80 iterations, tol 1e-6",
        "data_secs": data_secs, "grid_secs": grid_secs,
        "per_lambda": [{"lambda": m.regularization_weight,
                        "iterations": m.result.iterations,
                        "convergence": m.result.convergence_reason.value,
                        "value": m.result.value, "seconds": secs}
                       for m, (_, secs) in zip(models, per_lambda)],
        "launches": counts, "path": path, **work,
        "max_memory_allocated": peak,
        "plain_grid_secs": plain_secs,
        "plain_grid_iterations": [p.result.iterations for p in plain],
        "objective_rel_diff_to_plain_grid": value_rel,
        "rel_l2_diff_to_plain_grid": coef_rel,
        "evaluate_grid_secs": eval_grid_secs,
        "evaluate_single_secs": eval_single_secs,
        "evaluate_grid_vs_single_max_rel": eval_rel,
        "metrics": grid_maps,
        "box": {"iterations": boxed.result.iterations,
                "on_bound": on_bound, "value": boxed.result.value,
                "iterates_rows": int(its.shape[0])},
    }
    w_best = models[-1].result.coefficients.contiguous()
    return out, counts, batch, w_best


def legacy_argv(train, val, out, device, *extra) -> list:
    return ["--training-data-directory", train,
            "--validating-data-directory", val,
            "--output-directory", out, "--task", "LOGISTIC_REGRESSION",
            "--regularization-weights", "10,1,0.1",
            "--data-validation-type", "VALIDATE_FULL",
            "--device", device, *extra]


def run_legacy(argv) -> tuple:
    """The legacy driver in this process on ``argv``, with the kernel's
    launches of its main grid (between the training events) and its
    optimization-log events; returns (driver, launches, events)."""
    from photon_ml_tpu_torch.cli import legacy_driver
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.utils.events import (
        PhotonOptimizationLogEvent, TrainingFinishEvent, TrainingStartEvent)

    seen = {}
    events = []

    def listener(e):
        if isinstance(e, TrainingStartEvent):
            pk.reset_launch_count()
        elif isinstance(e, TrainingFinishEvent):
            seen.update(launch_counts())
        elif isinstance(e, PhotonOptimizationLogEvent):
            events.append(e)

    driver = legacy_driver.LegacyDriver(legacy_driver.parse_args(argv))
    driver.register_listener(listener)
    try:
        driver.run()
    finally:
        driver.logger.close()
    return driver, seen, events


def single_glm_driver_phase(torch, dev, workdir, rows=A1A_ROWS):
    """Phase 11 (b)-(e): the drivers on the a1a-shaped fixture."""
    from photon_ml_tpu_torch.cli import libsvm_to_avro
    from photon_ml_tpu_torch.evaluation.model_evaluation import (
        AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS as AUC, evaluate_model)
    from photon_ml_tpu_torch.io import data_format
    from photon_ml_tpu_torch.io.model_io import read_models_text
    from photon_ml_tpu_torch.optimize.config import TaskType

    shutil.rmtree(workdir, ignore_errors=True)
    device = str(dev)
    secs = {}
    t0 = time.perf_counter()
    train_txt, test_txt = write_a1a_like(os.path.join(workdir, "libsvm"),
                                         rows)
    secs["fixture_write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train, val = (os.path.join(workdir, f) for f in ("train.avro",
                                                     "test.avro"))
    for src, dst in ((train_txt, train), (test_txt, val)):
        libsvm_to_avro.main(["--input-path", src, "--output-path", dst,
                             "--feature-dimension", str(A1A_FEATURES),
                             "--device", device])
    secs["libsvm_to_avro"] = time.perf_counter() - t0

    # (b) the legacy driver on the Avro, everything on
    out_b = os.path.join(workdir, "b")
    summary_dir = os.path.join(workdir, "summary")
    data_format.reset_ingest_stats()
    t0 = time.perf_counter()
    drv, grid_launches, events = run_legacy(legacy_argv(
        train, val, out_b, device, "--diagnostic-mode", "ALL",
        "--validate-per-iteration", "true",
        "--summarization-output-dir", summary_dir))
    secs["driver_b"] = time.perf_counter() - t0
    ingest = dict(data_format.INGEST_STATS)
    for name in ("output", "best", "metrics.json", "diagnostic-report.html",
                 "diagnostic-report.txt"):
        if not os.path.exists(os.path.join(out_b, name)):
            raise AssertionError(f"(b): {name} was not written")
    if not os.path.exists(os.path.join(summary_dir, "part-00000.avro")):
        raise AssertionError("(b): the summary Avro was not written")
    if ingest != {"native_parts": 2, "declined_parts": 0,
                  "records_parts": 0}:
        raise AssertionError(f"(b): not every part read natively: {ingest}")
    if drv.train_data.dim != A1A_SHAPE[1] or \
            drv.train_data.num_samples != rows[0]:
        raise AssertionError(f"(b): training data "
                             f"{drv.train_data.features.shape}")
    check_launches("(b) main grid", grid_launches, "stream", "logistic",
                   dev)
    metrics = json.load(open(os.path.join(out_b, "metrics.json")))
    best = drv.best_lambda
    (best_lam, best_glm), = read_models_text(
        os.path.join(out_b, "best"), drv.train_data.index_map,
        TaskType.LOGISTIC_REGRESSION, device=dev)
    scored = evaluate_model(best_glm, drv._validation_batch())
    auc_json = metrics[str(best)][AUC]
    auc_rel = abs(scored[AUC] - auc_json) / auc_json
    if best_lam != best or not auc_rel <= 1e-6:
        raise AssertionError(f"(b): best model AUC {scored[AUC]} != "
                             f"metrics.json's {auc_json}")
    per_iter_rel = 0.0
    for e in events:
        last = e.per_iteration_metrics[-1]
        if len(e.per_iteration_metrics) != e.states.iterations + 1:
            raise AssertionError("(b): per-iteration metrics miss an "
                                 "iterate")
        per_iter_rel = max(per_iter_rel, *(
            abs(last[k] - v) / max(abs(v), 1e-12)
            for k, v in e.metrics.items()))
    if len(events) != 3 or not per_iter_rel <= 1e-6:
        raise AssertionError(f"(b): the last iterate's metrics differ "
                             f"from the final model's (rel "
                             f"{per_iter_rel:.3g})")
    objectives_b = {m.regularization_weight: m.result.value
                    for m in drv.models}
    w_b = drv.models[-1].result.coefficients.contiguous()
    batch_b = drv._batch(drv.train_data)
    rec_b = {
        "ingest_parts": ingest, "grid_launches": grid_launches,
        "phase_seconds": drv.phase_seconds, "best_lambda": best,
        "metrics": metrics, "best_auc_rescored": scored[AUC],
        "best_auc_rel_diff": auc_rel,
        "per_iteration_last_vs_final_max_rel": per_iter_rel,
        "per_lambda": [{"lambda": m.regularization_weight,
                        "iterations": m.result.iterations,
                        "convergence": m.result.convergence_reason.value,
                        "value": m.result.value} for m in drv.models],
    }

    # (c) the same LibSVM files straight into the driver (in this
    # process: see the record's "reduced")
    out_c = os.path.join(workdir, "c")
    t0 = time.perf_counter()
    run_legacy(legacy_argv(train_txt, test_txt, out_c, device,
                           "--input-file-format", "LIBSVM",
                           "--feature-dimension", str(A1A_FEATURES)))
    secs["driver_c"] = time.perf_counter() - t0
    # the one-hot groups each sum to the intercept column, so along those
    # directions the objective is flat but for the L2 term, and where an
    # f32 solve stops on |df| <= 1e-6 |f0| leaves them loose (another
    # column order, another stop): the runs are held to their objectives
    # and validation metrics, and the coefficients' difference is reported
    lib_models = dict(read_models_text(os.path.join(out_c, "output"),
                                       device=dev))
    avro_models = dict(read_models_text(os.path.join(out_b, "output"),
                                        device=dev))
    c_diff = {lam: float(np.abs(
        np.sort(lib_models[lam].coefficients.means.cpu().numpy())
        - np.sort(avro_models[lam].coefficients.means.cpu().numpy())).max())
        for lam in CONFIG1_LAMBDAS}
    metrics_c = json.load(open(os.path.join(out_c, "metrics.json")))
    c_rel = max(abs(metrics_c[k][AUC] - metrics[k][AUC]) / metrics[k][AUC]
                for k in metrics)
    if sorted(metrics_c) != sorted(metrics) or not c_rel <= 1e-4:
        raise AssertionError(f"(c): LibSVM direct and converted AUCs "
                             f"differ (rel {c_rel:.3g})")

    # (d) OWL-QN + L1, and TRON + L2 with a box on three features and
    # STANDARDIZATION
    box = [{"name": str(j), "term": "", "lowerBound": -0.05,
            "upperBound": 0.05} for j in (1, 6, 40)]
    runs_d = {}
    launches_d = {}
    # TRON's accepted values never rise without a box; with one, the
    # projection after an accepted step can raise them, in the JAX package
    # the same (tests/test_torch_legacy_driver.py shows both), so the boxed
    # run is held to its box and finite values
    std = ["--optimizer", "TRON", "--normalization-type", "STANDARDIZATION"]
    for name, extra in (
            ("owlqn_l1", ["--regularization-type", "L1"]),
            ("tron_std", std),
            ("tron_box_std", [*std, "--coefficient-box-constraints",
                              json.dumps(box)])):
        t0 = time.perf_counter()
        d, launches, _ = run_legacy(legacy_argv(
            train, val, os.path.join(workdir, name), device, *extra))
        secs[f"driver_d_{name}"] = time.perf_counter() - t0
        check_launches(f"(d) {name}", launches, "stream", "logistic", dev)
        launches_d[name] = launches
        for m in d.models:
            v = m.result.values
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"(d) {name}: non-finite objective")
            if name == "tron_std" and np.any(np.diff(v) > 0):
                raise AssertionError(f"(d) {name}: TRON's accepted values "
                                     f"rose: {v.tolist()}")
        if name == "tron_box_std":
            imap = d.train_data.index_map
            for m in d.models:
                x = m.result.coefficients.cpu().numpy()
                for b in box:
                    j = imap.index_of(b["name"] + "\x01")
                    if not -0.05 <= x[j] <= 0.05:
                        raise AssertionError(f"(d): feature {b['name']} "
                                             f"left its box: {x[j]}")
        runs_d[name] = {
            "per_lambda": [{"lambda": m.regularization_weight,
                            "iterations": m.result.iterations,
                            "convergence":
                                m.result.convergence_reason.value,
                            "value": m.result.value} for m in d.models],
            "nnz": [int((m.model.coefficients.means != 0).sum())
                    for m in d.models],
            "best_lambda": d.best_lambda, "phase_seconds": d.phase_seconds}

    # (e) (b)'s argv without the diagnostics, card and CPU
    objectives_e = {}
    for side, where in (("card", device), ("cpu", "cpu")):
        t0 = time.perf_counter()
        d, _, _ = run_legacy(legacy_argv(
            train, val, os.path.join(workdir, f"e_{side}"), where,
            "--validate-per-iteration", "true"))
        secs[f"driver_e_{side}"] = time.perf_counter() - t0
        objectives_e[side] = [m.result.value for m in d.models]
    e_rel = max(abs(a - b) / abs(b) for a, b in zip(
        objectives_e["card"], objectives_e["cpu"]))
    if not e_rel <= 1e-4:
        raise AssertionError(f"(e): card and CPU objectives differ "
                             f"(rel {e_rel:.3g}): {objectives_e}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {
        "rows": list(rows), "shape": list(A1A_SHAPE),
        "fixture": "a1a encoding (14 one-hot groups, 123 features), a9a "
                   "row counts, logistic labels, seed 21",
        "b": rec_b, "c": {"sorted_coefficients_max_abs_diff": c_diff,
                          "auc_max_rel_diff": c_rel,
                          "metrics": metrics_c},
        "reduced": {"c": "the LibSVM run goes through the legacy driver in "
                         "this process, not a child of its own (a process "
                         "start on the card is 10-15 s); its checks are "
                         "the same; PERF.md section 4 gives the seconds "
                         "before and after"},
        "d": runs_d, "e": {"objectives": objectives_e, "max_rel": e_rel},
        "objectives_b": objectives_b, "stage_seconds": secs,
    }, {"b_grid": grid_launches, **{f"d_{k}": v
                                    for k, v in launches_d.items()}}, \
        batch_b, w_b


def single_glm_phase(torch, dev, smi, workdir, bench_shape=BIG_SHAPE,
                     rows=A1A_ROWS):
    """Phase 11: the single-GLM path, BASELINE config 1. Returns the phase
    record, the kernel's launches by run and the worst |delta| of the
    kernel against its plain version on the two real batches."""
    from photon_ml_tpu_torch.ops.losses import get_loss

    t0 = time.perf_counter()
    library, lib_counts, big_batch, w_big = config1_library_phase(
        torch, dev, bench_shape)
    library["seconds"] = time.perf_counter() - t0
    print("phase 11 (a): " + json.dumps(library), file=sys.stderr,
          flush=True)
    logistic = get_loss("logistic")
    zero = torch.zeros((), device=dev)
    big_err, big_worst = check_sums(
        torch, logistic, big_batch.X, big_batch.labels, big_batch.offsets,
        big_batch.weights, w_big, zero, scaled=True)
    del big_batch
    t1 = time.perf_counter()
    drivers, driver_counts, a1a_batch, w_a1a = single_glm_driver_phase(
        torch, dev, workdir, rows)
    drivers["seconds"] = time.perf_counter() - t1
    a1a_err, a1a_worst = check_sums(
        torch, logistic, a1a_batch.X, a1a_batch.labels, a1a_batch.offsets,
        a1a_batch.weights, w_a1a, zero, scaled=True)
    record = {"phase": "single_glm", "nvidia_smi": smi,
              "library": library, "drivers": drivers,
              "kernel_vs_plain": {
                  "bench_shape": {"max_abs_err": big_err,
                                  "worst_delta_over_tolerance": big_worst},
                  "a1a_shape": {"path": paths_for(a1a_batch.X)[0],
                                "max_abs_err": a1a_err,
                                "worst_delta_over_tolerance": a1a_worst}},
              "seconds": time.perf_counter() - t0}
    return record, {"config1_grid": lib_counts, **{
        f"single_glm_{k}": v for k, v in driver_counts.items()}}, \
        max(big_err, a1a_err)


# ---------------------------------------------------------------------------
# Phase 12: wide and streamed data
# ---------------------------------------------------------------------------

#: bench.py:1966 bench_ingest's shape: rows, columns, non-zeros a row,
#: entities, seed; bench.py:2021 bench_ingest_streamed's chunk
INGEST = dict(n=10_000_000, d=100_000, nnz=8, entities=50_000, seed=3)
INGEST_CHUNK = 1_000_000
#: rows of the draw on which phase 12 (a) holds the native index-map pack
#: to the numpy scatter: a cut of scale (PERF.md §4), since the scatter
#: took ~24 s at the full 10,000,000 rows of a script over its budget
INGEST_PLAIN_ROWS = 1_000_000
#: rows of the draw on which phase 12 (a) runs both random-effect builders
#: and holds them equal: a cut of scale (PERF.md §4) for phase 16: the two
#: builds took ~66 s at 10,000,000 rows on a slow host, and ~34 s at the
#: later 2,500,000 on another; the ELL pack and (b)'s batch keep the full
#: draw, and the streamed build still spans two of its 1,000,000-row chunks
INGEST_BUILDER_ROWS = 1_250_000
#: phase 12 (d): training / validation rows, hashed global features, users
#: (an eighth of the earlier 200,000 / 50,000, a cut of scale: the
#: fixture write, the indexing job and three training runs took ~103 s,
#: then ~46 s at 50,000 / 12,500 on a slow host)
WIDE_ROWS = (25_000, 6_250)
WIDE_FEATURES, WIDE_USERS = 100_000, 2_000
WIDE_SECTIONS = "global:globalFeatures|user:userFeatures"
#: phase 12 (e): rcv1.binary's training split (rows, features, mean
#: non-zeros a row) and the validation rows
RCV1 = dict(rows=20_242, d=47_236, nnz=74, val=10_000)
#: the small-N slice of (b) solved on the card and the CPU
WIDE_SLICE_ROWS = 200_000


class RssPeak:
    """The most this process's resident size (``VmRSS``) grew while the
    block ran: a thread reads ``/proc/self/status`` every 5 ms. A memmap's
    written pages count in it while they stay resident as file pages,
    which the kernel can drop."""

    def __enter__(self):
        import threading

        self.start = self.peak = self._read()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _read() -> int:
        with open("/proc/self/status") as f:
            return next(int(ln.split()[1]) * 1024 for ln in f
                        if ln.startswith("VmRSS:"))

    def _sample(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self._read())
            time.sleep(0.005)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._read())
        return False

    def record(self) -> dict:
        return {"peak_VmRSS_growth_bytes": self.peak - self.start}


def ingest_data(n, d, nnz, entities, seed):
    """bench.py:1966 bench_ingest's data: a canonical CSR of ``nnz``
    sorted random columns a row, random labels and entity codes."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.game.dataset import GameDataset

    rng = np.random.default_rng(seed)
    cols = np.sort(rng.integers(0, d, size=(n, nnz), dtype=np.int32),
                   axis=1).reshape(-1)
    vals = rng.random(n * nnz).astype(np.float32)
    indptr = np.arange(0, n * nnz + 1, nnz, dtype=np.int64)
    mat = sp.csr_matrix((vals, cols, indptr), shape=(n, d))
    mat.sum_duplicates()
    y = rng.integers(0, 2, n).astype(np.float64)
    codes = rng.integers(0, entities, n).astype(np.int64)
    data = GameDataset(responses=y, feature_shards={"s": mat})
    data.id_columns["u"] = codes
    data.id_vocabs["u"] = np.arange(entities)
    return data


def _on(torch, a, dev):
    return (a if isinstance(a, torch.Tensor)
            else torch.from_numpy(np.asarray(a))).to(dev)


def blocks_equal(torch, dev, a, b, page=1 << 20) -> dict:
    """The in-RAM dataset ``a`` (one block or buckets) against the
    streamed ``b`` array for array, each host (memmap) block copied to
    ``dev`` in pages of ``page`` rows; returns the comparison by field."""
    blocks = a.buckets if a.buckets is not None else [a]
    eq = {"entity_codes": bool(np.array_equal(a.entity_codes,
                                              b.entity_codes)),
          "buckets": len(blocks) == len(b.buckets)}
    for f in ("X", "labels", "base_offsets", "weights", "row_ids"):
        eq[f] = all(
            all(bool(torch.equal(_on(torch, x[lo:lo + page], dev),
                                 _on(torch, y[lo:lo + page], dev)))
                for lo in range(0, int(x.shape[0]), page))
            for x, y in ((getattr(u, f), getattr(v, f))
                         for u, v in zip(blocks, b.buckets)))
    eq["num_passive"] = a.num_passive == b.num_passive
    for f in ("passive_X", "passive_entity", "passive_row_ids",
              "passive_offsets"):
        x, y = getattr(a, f), getattr(b, f)
        eq[f] = x is None and y is None or all(
            bool(torch.equal(_on(torch, x[lo:lo + page], dev),
                             _on(torch, y[lo:lo + page], dev)))
            for lo in range(0, int(x.shape[0]), page))
    if a.projectors is not None:
        eq["projectors"] = bool(
            np.array_equal(a.projectors.raw_indices,
                           b.projectors.raw_indices)
            and np.array_equal(a.projectors.reduced_dims,
                               b.projectors.reduced_dims))
    return eq


def ingest_phase(torch, dev, workdir, shape=INGEST, chunk=INGEST_CHUNK):
    """Phase 12 (a): the ELL pack and both random-effect builders at
    bench_ingest's scale. Returns the record and the ELL batch for (b)."""
    from photon_ml_tpu_torch.data.batch import ell_from_csr, ell_planes_numpy
    from photon_ml_tpu_torch.game.dataset import (
        RandomEffectDataConfiguration, build_random_effect_dataset,
        build_random_effect_dataset_streamed, dataset_row_stream)
    from photon_ml_tpu_torch.io.native_loader import (
        get_host_lib, pack_ell_native)

    rec = {"shape": dict(shape), "chunk_rows": chunk}
    t0 = time.perf_counter()
    data = ingest_data(**shape)
    mat = data.feature_shards["s"]
    n = mat.shape[0]
    rec["data_secs"] = time.perf_counter() - t0
    rec["nnz"] = int(mat.nnz)

    # the host pack, native against the numpy scatter (the library
    # loaded first: its build is not the pack's time)
    get_host_lib()
    k = -(-int(np.diff(mat.indptr).max()) // 8) * 8
    idx = np.zeros((n, k), np.int32)
    val = np.zeros((n, k), np.float32)
    t0 = time.perf_counter()
    pack_ell_native(mat.indptr, mat.indices, mat.data, k, idx, val)
    rec["ell_native_pack_secs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_idx, want_val = ell_planes_numpy(mat, k)
    rec["ell_numpy_pack_secs"] = time.perf_counter() - t0
    rec["ell_native_equals_numpy"] = bool(
        np.array_equal(idx, want_idx) and np.array_equal(val, want_val))
    if not rec["ell_native_equals_numpy"]:
        raise AssertionError("(a): the native ELL pack differs from the "
                             "numpy scatter")
    del idx, val, want_idx, want_val
    rec["ell_pack_rows_per_sec"] = n / rec["ell_native_pack_secs"]
    t0 = time.perf_counter()
    ell = ell_from_csr(mat, data.responses, device=dev)
    sync(torch, dev)
    rec["ell_from_csr_secs"] = time.perf_counter() - t0
    rec["ell_from_csr_rows_per_sec"] = n / rec["ell_from_csr_secs"]
    rec["ell_k"] = k

    cfg = RandomEffectDataConfiguration(
        random_effect_type="u", feature_shard_id="s", num_partitions=1,
        num_active_data_points_upper_bound=32,
        num_features_to_keep_upper_bound=64)
    # the builders on a smaller draw of the same generator
    del data, mat
    data = ingest_data(**{**shape, "n": min(shape["n"],
                                             INGEST_BUILDER_ROWS)})
    mat = data.feature_shards["s"]
    n = mat.shape[0]
    rec["builder_rows"] = n
    with RssPeak() as rss:
        t0 = time.perf_counter()
        ram = build_random_effect_dataset(data, cfg, device=dev)
        sync(torch, dev)
        rec["in_ram_secs"] = time.perf_counter() - t0
    rec["in_ram"] = {"block": list(ram.X.shape),
                     "passive_rows": ram.num_passive,
                     "rows_per_sec": n / rec["in_ram_secs"], **rss.record()}
    # native pack against the numpy scatter, on a smaller draw of the
    # same generator (INGEST_PLAIN_ROWS)
    few = ingest_data(**{**shape, "n": min(shape["n"], INGEST_PLAIN_ROWS)})
    native = build_random_effect_dataset(few, cfg, device=dev)
    t0 = time.perf_counter()
    plain = build_random_effect_dataset(few, cfg, device=dev,
                                        native_pack=False)
    rec["in_ram_numpy_pack_secs"] = time.perf_counter() - t0
    rec["numpy_pack_rows"] = few.num_samples
    rec["in_ram_native_equals_numpy_pack"] = bool(
        torch.equal(native.X, plain.X)
        and torch.equal(native.passive_X, plain.passive_X))
    del plain, native, few
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not rec["in_ram_native_equals_numpy_pack"]:
        raise AssertionError("(a): native-packed index-map blocks differ "
                             "from the numpy-packed ones")

    blocks_dir = os.path.join(workdir, "ingest_blocks")
    with RssPeak() as rss:
        t0 = time.perf_counter()
        streamed = build_random_effect_dataset_streamed(
            dataset_row_stream(data, cfg, chunk_rows=chunk), cfg,
            raw_dim=mat.shape[1], blocks_dir=blocks_dir, device=dev)
        sync(torch, dev)
        rec["streamed_secs"] = time.perf_counter() - t0
    rec["streamed"] = {
        "blocks": [list(b.X.shape) for b in streamed.buckets],
        "passive_rows": streamed.num_passive,
        "bytes_on_disk": sum(os.path.getsize(os.path.join(blocks_dir, f))
                             for f in os.listdir(blocks_dir)),
        "files": sorted(os.listdir(blocks_dir)),
        "rows_per_sec": n / rec["streamed_secs"], **rss.record()}
    t0 = time.perf_counter()
    eq = blocks_equal(torch, dev, ram, streamed)
    rec["streamed_equals_in_ram"] = eq
    rec["compare_secs"] = time.perf_counter() - t0
    if not all(eq.values()):
        raise AssertionError(f"(a): streamed and in-RAM blocks differ: {eq}")
    del ram, streamed
    shutil.rmtree(blocks_dir, ignore_errors=True)
    return rec, ell


def wide_solve_phase(torch, dev, ell, hbm, slice_rows=WIDE_SLICE_ROWS):
    """Phase 12 (b): logistic L-BFGS + L2 on the ELL batch of (a)."""
    from photon_ml_tpu_torch.data.batch import ell_from_csr
    from photon_ml_tpu_torch.optimize import problem as pm
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)

    cfg = GLMOptimizationConfiguration.parse("30,1e-9,1.0,1,LBFGS,L2")
    problem = pm.GLMOptimizationProblem(config=cfg,
                                        task=TaskType.LOGISTIC_REGRESSION)
    obj = problem.objective()
    n, k = ell.indices.shape
    d = ell.dim
    t0 = time.perf_counter()
    plan = ell.plan.build()
    sync(torch, dev)
    rec = {"n": n, "k": k, "d": d,
           "nnz": int((ell.values != 0).sum()),
           "plan_build_secs": time.perf_counter() - t0,
           "plan_width": plan.width,
           "plan_levels": len(plan.levels),
           "plan_slots": int(plan.values.numel())}
    w = torch.from_numpy(np.random.default_rng(5).normal(
        size=d).astype(np.float32) * 0.01).to(dev)
    f1, g1 = obj.calculate(w, ell)
    f2, g2 = obj.calculate(w, ell)
    rec["two_evaluations_equal"] = bool(torch.equal(f1, f2)
                                        and torch.equal(g1, g2))
    if not rec["two_evaluations_equal"]:
        raise AssertionError("(b): two evaluations of the ELL objective "
                             "differ")
    if dev.type == "cuda":
        rec["evaluation"] = cuda_times(torch, lambda: obj.calculate(w, ell),
                                       reps=10)
    # indices and values read once, labels, offsets and weights, w
    rec["bytes_bound"] = {
        "bytes": n * k * 8 + 12 * n + 4 * d,
        "hbm_bytes_per_s": hbm,
        "ms": (n * k * 8 + 12 * n + 4 * d) / hbm * 1e3}

    reset_counts(torch, dev)
    t0 = time.perf_counter()
    model, result = problem.run(ell)
    sync(torch, dev)
    rec["solve_secs"] = time.perf_counter() - t0
    rec["iterations"] = result.iterations
    rec["convergence"] = result.convergence_reason.value
    rec["value"] = result.value
    rec["max_memory_allocated"] = peak_memory(torch, dev)
    rec["kernel_launches"] = launch_counts()["by_path"]
    if sum(rec["kernel_launches"].values()):
        raise AssertionError("(b): an ELL batch reached the dense kernel")

    # resume: the solve cut at half its measured iterations, its carry
    # resumed for the rest of the 30
    x0 = torch.zeros((1, d), dtype=torch.float32, device=dev)
    l1 = torch.zeros(d, dtype=torch.float32, device=dev)
    args = (pm._one_lane_vg, pm._one_lane_hvp)
    full = pm.minimize("lbfgs", *args, x0, (obj, ell), l1, 30,
                       cfg.tolerance)
    done = int(full[1].num_iterations[0])
    if done < 2:
        raise AssertionError(f"(b): the solve ran {done} iteration(s), too "
                             f"few to cut and resume")
    split = done // 2
    first = pm.minimize("lbfgs", *args, x0, (obj, ell), l1, split,
                        cfg.tolerance, return_carry=True)
    if int(first[1].num_iterations[0]) != split:
        raise AssertionError(f"(b): the cut solve stopped before iteration "
                             f"{split}")
    resumed = pm.minimize("lbfgs", *args, x0, (obj, ell), l1, 30 - split,
                          cfg.tolerance, resume=first[3])
    rec["resume"] = {"iterations": done, "cut_at": split,
                     "resumed_iterations":
                         int(resumed[1].num_iterations[0]),
                     "resumed_equals_uninterrupted":
                         bool(torch.equal(resumed[0], full[0])),
                     "solve_equals_problem_run":
                         bool(torch.equal(full[0][0],
                                          result.coefficients))}
    if not all(rec["resume"][k] for k in ("resumed_equals_uninterrupted",
                                          "solve_equals_problem_run")):
        raise AssertionError(f"(b): resume: {rec['resume']}")

    # the first slice_rows rows on the card and the CPU
    import scipy.sparse as sp

    host = {f: getattr(ell, f)[:slice_rows].cpu().numpy()
            for f in ("indices", "values", "labels")}
    m = len(host["labels"])
    keep = host["values"].reshape(-1) != 0
    sub = sp.csr_matrix(
        (host["values"].reshape(-1)[keep],
         (np.repeat(np.arange(m), k)[keep],
          host["indices"].reshape(-1)[keep])), shape=(m, d))
    values = {}
    for where in ("cpu", str(dev)):
        batch = ell_from_csr(sub, host["labels"], device=where)
        values[where] = problem.run(batch)[1].value
    rel = abs(values["cpu"] - values[str(dev)]) / abs(values["cpu"])
    rec["slice_vs_cpu"] = {"rows": m,
                           "values": values, "rel": rel}
    if not rel <= 1e-4:
        raise AssertionError(f"(b): the card's slice solve differs from "
                             f"the CPU's (rel {rel:.3g})")
    return rec


def streamed_glmix_phase(torch, dev, data, workdir):
    """Phase 12 (c): one pipelined sweep of the GLMix recipe with the
    per-user blocks in RAM on the card, then with them built streamed into
    memmap files on the host (the in-RAM blocks freed first): states,
    objectives and scores bit for bit, seconds and device memory."""
    from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
    from photon_ml_tpu_torch.game.dataset import (
        build_random_effect_dataset_streamed, dataset_row_stream)

    runs, secs, mem, counts = {}, {}, {}, {}
    coords = glmix_coordinates(data, dev)
    re_cfg = coords["per-user"].dataset.config
    problem = coords["per-user"].problem
    blocks_dir = os.path.join(workdir, "glmix_blocks")

    def device_bytes():
        return (torch.cuda.memory_allocated() if dev.type == "cuda"
                else None)

    def sweep(name):
        reset_counts(torch, dev)
        held = device_bytes()
        t0 = time.perf_counter()
        runs[name] = run_coordinate_descent_sweep(torch, dev, data, coords)
        secs[name] = time.perf_counter() - t0
        peak = peak_memory(torch, dev)
        mem[name] = {"held_before_bytes": held, "peak_bytes": peak,
                     "peak_growth_bytes": (None if peak is None
                                           else peak - held)}
        counts[name] = launch_counts()

    sweep("in_ram")
    del coords["per-user"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    streamed_ds = build_random_effect_dataset_streamed(
        dataset_row_stream(data, re_cfg), re_cfg,
        raw_dim=data.feature_shards["per_user"].shape[1], num_buckets=4,
        blocks_dir=blocks_dir, device=dev)
    build_secs = time.perf_counter() - t0
    coords["per-user"] = RandomEffectCoordinate(dataset=streamed_ds,
                                                problem=problem)
    sweep("memmap")
    eq = runs_equal(torch, runs["in_ram"], runs["memmap"], data, dev)
    if not all_equal(eq):
        raise AssertionError(f"(c): the memmap sweep differs from the "
                             f"in-RAM sweep: {eq}")
    rec = {"streamed_build_secs": build_secs,
           "blocks": [list(b.X.shape) for b in streamed_ds.buckets],
           "host_blocks": type(streamed_ds.buckets[0].X).__name__,
           "passive_rows": streamed_ds.num_passive,
           "bytes_on_disk": sum(
               os.path.getsize(os.path.join(blocks_dir, f))
               for f in os.listdir(blocks_dir)),
           "objectives": [s.objective for s in runs["memmap"].states],
           "equal": eq, "sweep_secs": secs, "device_memory": mem,
           "launches_by_path": {k: v["by_path"] for k, v in counts.items()}}
    del coords, streamed_ds, runs
    shutil.rmtree(blocks_dir, ignore_errors=True)
    return rec, counts["in_ram"]


def run_coordinate_descent_sweep(torch, dev, data, coords):
    """One pipelined sweep (``pipeline_depth=1``) of ``coords``."""
    from photon_ml_tpu_torch.game.coordinate_descent import (
        run_coordinate_descent)
    from photon_ml_tpu_torch.optimize.config import TaskType

    res = run_coordinate_descent(
        coords, 1, TaskType.LOGISTIC_REGRESSION, data.responses,
        data.weights, data.offsets, pipeline_depth=1, device=dev)
    sync(torch, dev)
    return res


def _write_wide_rows(task: tuple) -> None:
    """One Avro part of the wide fixture (a process-pool task): hashed
    global features ``h<j>``, the user's bag ``b<j>``, ``userId``."""
    from photon_ml_tpu_torch.io.avro import write_container
    from photon_ml_tpu_torch.tools.crash_resume_drill import _glmix_schema

    path, lo, hashed, values, labels, users, bag, bag_values = task

    def records():
        for i in range(len(labels)):
            yield {"uid": str(lo + i), "response": float(labels[i]),
                   "offset": None, "weight": None,
                   "metadataMap": {"userId": str(users[i])},
                   "globalFeatures": [
                       {"name": f"h{j}", "term": "", "value": float(v)}
                       for j, v in zip(hashed[i], values[i])],
                   "userFeatures": [
                       {"name": f"b{j}", "term": "", "value": float(v)}
                       for j, v in zip(bag[i], bag_values[i])]}

    write_container(path, _glmix_schema(), records())


def write_wide_fixture(directory, rows=WIDE_ROWS, features=WIDE_FEATURES,
                       users=WIDE_USERS, per_row=8, bag_size=32,
                       bag_per_row=4, parts=(8, 2), seed=12) -> tuple:
    """The wide GAME fixture of phase 12 (d) as directories of Avro parts
    (a spawn pool writes them): ``per_row`` distinct hashed features of
    ``features`` a row, ``bag_per_row`` of a ``bag_size`` per-user bag,
    ``users`` power-law users, logistic labels from a sparse truth."""
    import multiprocessing

    rng = np.random.default_rng(seed)
    n = sum(rows)
    hashed = np.sort(rng.integers(0, features - per_row, (n, per_row)),
                     axis=1)
    # distinct within a row: a repeat moves to the next column
    for j in range(1, per_row):
        clash = hashed[:, j] <= hashed[:, j - 1]
        hashed[clash, j] = hashed[clash, j - 1] + 1
    values = rng.normal(size=(n, per_row)).astype(np.float32)
    user = (rng.zipf(1.3, size=n) % users).astype(np.int64)
    bag = np.sort(np.argsort(rng.random((n, bag_size)), axis=1)[
        :, :bag_per_row], axis=1)
    bag_values = rng.normal(size=(n, bag_per_row)).astype(np.float32)
    w = rng.normal(size=features) * (rng.uniform(size=features) < 0.05)
    w_user = rng.normal(size=(users, bag_size)) * 0.5
    logits = (values * w[hashed]).sum(1) + (
        bag_values * w_user[user[:, None], bag]).sum(1)
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(
        np.float64)
    tasks, out = [], []
    for name, lo, hi, k in (("train", 0, rows[0], parts[0]),
                            ("validate", rows[0], n, parts[1])):
        path = os.path.join(directory, name)
        os.makedirs(path, exist_ok=True)
        out.append(path)
        bounds = np.linspace(lo, hi, k + 1).astype(np.int64)
        for i in range(k):
            a, b = int(bounds[i]), int(bounds[i + 1])
            tasks.append((os.path.join(path, f"part-{i:05d}.avro"), a,
                          hashed[a:b], values[a:b], labels[a:b], user[a:b],
                          bag[a:b], bag_values[a:b]))
    with multiprocessing.get_context("spawn").Pool(
            min(len(tasks), os.cpu_count() or 1)) as pool:
        pool.map(_write_wide_rows, tasks, chunksize=1)
    return tuple(out)


def wide_driver_argv(train, val, out, device, *extra) -> list:
    return ["--train-input-dirs", train, "--validate-input-dirs", val,
            "--output-dir", out, "--task-type", "LOGISTIC_REGRESSION",
            "--feature-shard-id-to-feature-section-keys-map", WIDE_SECTIONS,
            "--updating-sequence", "fixed,perUser", "--num-iterations", "1",
            "--fixed-effect-data-configurations", "fixed:global,1",
            "--fixed-effect-optimization-configurations",
            "fixed:20,1e-7,10,1,LBFGS,L2",
            "--random-effect-data-configurations",
            "perUser:userId,user,1,128",
            "--random-effect-optimization-configurations",
            "perUser:20,1e-7,1,1,LBFGS,L2",
            "--random-effect-block-buckets", "2",
            "--evaluator-type", "AUC", "--device", device, *extra]


def model_records(out, model="best") -> dict:
    """Every file of the model ``out/<model>``: Avro files by their records
    (the writer draws each file's sync marker at random), the rest by
    bytes."""
    from photon_ml_tpu_torch.io.avro import read_records

    recs = {}
    best = os.path.join(out, model)
    for root, _, files in os.walk(best):
        for f in files:
            path = os.path.join(root, f)
            recs[os.path.relpath(path, best)] = (
                read_records(path) if f.endswith(".avro")
                else open(path, "rb").read())
    return recs


def metrics_without_seconds(out) -> dict:
    metrics = json.load(open(os.path.join(out, "metrics.json")))
    for grid in metrics["grid"]:
        for s in grid["states"]:
            s.pop("seconds")
    return metrics


def wide_drivers_phase(torch, dev, workdir, rows=WIDE_ROWS,
                       features=WIDE_FEATURES, users=WIDE_USERS):
    """Phase 12 (d): the feature-indexing job and the GAME drivers on a
    wide fixture: plain, and with ``--random-effect-blocks-dir`` and the
    off-heap store together; the scoring driver with and without the
    store."""
    from photon_ml_tpu_torch.cli import feature_indexing_job
    from photon_ml_tpu_torch.cli import game_scoring_driver
    from photon_ml_tpu_torch.cli import game_training_driver
    from photon_ml_tpu_torch.io.model_io import load_scored_items

    device = str(dev)
    secs, launches, rec = {}, {}, {}
    t0 = time.perf_counter()
    train, val = write_wide_fixture(os.path.join(workdir, "fixture"), rows,
                                    features, users)
    secs["fixture_write"] = time.perf_counter() - t0
    store = os.path.join(workdir, "store")
    t0 = time.perf_counter()
    feature_indexing_job.main([
        "--input-paths", train, "--output-dir", store,
        "--feature-shard-id-to-feature-section-keys-map", WIDE_SECTIONS,
        "--num-partitions", "4", "--offheap", "true"])
    secs["feature_indexing_job"] = time.perf_counter() - t0
    blocks = ["--random-effect-blocks-dir", os.path.join(workdir, "blocks")]
    offheap = ["--offheap-indexmap-dir", store,
               "--offheap-indexmap-num-partitions", "4"]
    outs = {}
    for name, extra in (("plain", []), ("blocks_offheap", blocks + offheap)):
        outs[name] = os.path.join(workdir, name)
        reset_counts(torch, dev)
        t0 = time.perf_counter()
        drv = game_training_driver.run(wide_driver_argv(
            train, val, outs[name], device, *extra))
        sync(torch, dev)
        secs[f"train_{name}"] = time.perf_counter() - t0
        launches[name] = launch_counts()
        rec[name] = {"phase_seconds": drv.phase_seconds,
                     "max_memory_allocated": peak_memory(torch, dev),
                     "global_dim": int(drv.train_data.feature_shards[
                         "global"].shape[1]),
                     "kernel_launches": launches[name]["by_path"]}
        if sum(launches[name]["by_path"].values()):
            raise AssertionError(f"(d) {name}: the ELL fixed effect "
                                 f"launched the dense kernel")
        del drv
    models = {k: model_records(v) for k, v in outs.items()}
    metrics = {k: metrics_without_seconds(v) for k, v in outs.items()}
    same = {k: {"models": models[k] == models["plain"],
                "metrics": metrics[k] == metrics["plain"]}
            for k in ("blocks_offheap",)}
    if not all(all(v.values()) for v in same.values()):
        raise AssertionError(f"(d): the runs differ: {same}")
    try:
        game_training_driver.run(wide_driver_argv(
            train, val, os.path.join(workdir, "wrong"), device,
            "--offheap-indexmap-dir", store,
            "--offheap-indexmap-num-partitions", "3"))
    except ValueError as e:
        wrong = str(e)
    else:
        raise AssertionError("(d): a wrong partition count was accepted")
    if "built with 4 partitions, but 3" not in wrong:
        raise AssertionError(f"(d): unexpected refusal: {wrong}")
    scores = {}
    for name, extra in (("plain", []), ("offheap", offheap)):
        out = os.path.join(workdir, f"score_{name}")
        t0 = time.perf_counter()
        game_scoring_driver.main([
            "--input-data-dirs", val, "--game-model-input-dir",
            os.path.join(outs["blocks_offheap"], "best"),
            "--output-dir", out,
            "--feature-shard-id-to-feature-section-keys-map", WIDE_SECTIONS,
            "--random-effect-id-set", "userId", "--device", device, *extra])
        secs[f"score_{name}"] = time.perf_counter() - t0
        scores[name] = np.asarray([
            r["predictionScore"] for f in sorted(os.listdir(
                os.path.join(out, "scores")))
            for r in load_scored_items(os.path.join(out, "scores", f))])
    if not (len(scores["plain"]) == rows[1]
            and np.array_equal(scores["plain"], scores["offheap"])):
        raise AssertionError("(d): the scoring driver's scores differ with "
                             "the off-heap store")
    (grid,) = metrics["plain"]["grid"]
    shutil.rmtree(workdir, ignore_errors=True)
    return {"rows": list(rows), "hashed_features": features,
            "users": users, "runs": rec, "equal_to_plain": same,
            "wrong_partitions_refusal": wrong,
            "objectives": [s["objective"] for s in grid["states"]],
            "validation_auc": [s["validation_metrics"]["AUC"]
                               for s in grid["states"]],
            "scores_equal_with_offheap": True,
            "reduced": {
                "left_out": "the run with --random-effect-blocks-dir "
                            "alone",
                "why": "the run with the blocks dir and the off-heap store "
                       "together is held to the plain run; PERF.md "
                       "section 4 gives the seconds before and after"},
            "stage_seconds": secs}, launches


def write_rcv1_like(directory, shape=RCV1, seed=31) -> tuple:
    """rcv1.binary-shaped LibSVM files by numpy: ``shape["rows"]`` training
    and ``shape["val"]`` validation rows over ``shape["d"]`` features,
    row lengths log-normal around ``shape["nnz"]`` (at most 800), column
    popularity power-law, unit-norm non-negative values (tf-idf-like),
    labels from a sparse truth."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    d = shape["d"]
    cdf = np.cumsum(1.0 / np.arange(1, d + 1) ** 0.8)
    cdf /= cdf[-1]
    w = rng.normal(size=d) * (rng.uniform(size=d) < 0.1)
    paths = []
    for name, n in (("train", shape["rows"]), ("test", shape["val"])):
        lens = np.clip(rng.lognormal(np.log(shape["nnz"]) - 0.18, 0.6, n),
                       1, 800).astype(np.int64)
        lines = []
        for ln in lens:
            cols = np.unique(np.minimum(
                np.searchsorted(cdf, rng.random(ln)), d - 1))
            vals = rng.uniform(0.05, 1.0, len(cols))
            vals /= np.sqrt((vals ** 2).sum())
            y = "+1" if vals @ w[cols] * 8 + rng.normal() > 0 else "-1"
            lines.append(y + " " + " ".join(
                f"{c + 1}:{v:.6f}" for c, v in zip(cols, vals)))
        path = os.path.join(directory, f"{name}.libsvm")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        paths.append(path)
    return tuple(paths)


def wide_legacy_phase(torch, dev, workdir, shape=RCV1, diagnostics="ALL"):
    """Phase 12 (e): the legacy driver on an rcv1-shaped LibSVM file with
    validation and the diagnostics; the best model's AUC read back and
    scored on the card against metrics.json."""
    from photon_ml_tpu_torch.data.batch import EllBatch
    from photon_ml_tpu_torch.evaluation.model_evaluation import (
        AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS as AUC, evaluate_model)
    from photon_ml_tpu_torch.io.index_map import (
        IndexMap, feature_key, split_feature_key)
    from photon_ml_tpu_torch.io.model_io import read_models_text
    from photon_ml_tpu_torch.optimize.config import TaskType

    secs = {}
    t0 = time.perf_counter()
    train, test = write_rcv1_like(os.path.join(workdir, "libsvm"), shape)
    secs["fixture_write"] = time.perf_counter() - t0
    out = os.path.join(workdir, "out")
    reset_counts(torch, dev)
    t0 = time.perf_counter()
    drv, grid_launches, _ = run_legacy(legacy_argv(
        train, test, out, str(dev), "--input-file-format", "LIBSVM",
        "--feature-dimension", str(shape["d"]), "--diagnostic-mode",
        diagnostics))
    sync(torch, dev)
    secs["driver"] = time.perf_counter() - t0
    for name in ("best", "metrics.json", "diagnostic-report.html"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"(e): {name} was not written")
    vbatch = drv._validation_batch()
    if not isinstance(vbatch, EllBatch):
        raise AssertionError("(e): the wide validation batch is not ELL")
    metrics = json.load(open(os.path.join(out, "metrics.json")))
    # the TSV names a LibSVM column "<j>" with an empty term: the key the
    # reader builds is "<j>\u0001", the identity map's "<j>"
    tsv_keys = IndexMap({feature_key(*split_feature_key(k)): v
                         for k, v in drv.train_data.index_map.items()})
    (best_lam, best_glm), = read_models_text(
        os.path.join(out, "best"), tsv_keys, TaskType.LOGISTIC_REGRESSION,
        device=dev)
    scored = evaluate_model(best_glm, vbatch)
    auc_json = metrics[str(drv.best_lambda)][AUC]
    rel = abs(scored[AUC] - auc_json) / auc_json
    if best_lam != drv.best_lambda or not rel <= 1e-6:
        raise AssertionError(f"(e): best model AUC {scored[AUC]} != "
                             f"metrics.json's {auc_json}")
    rec = {"shape": dict(shape), "diagnostic_mode": diagnostics,
           "train_nnz": int(drv.train_data.features.nnz),
           "ell_k": int(vbatch.indices.shape[1]),
           "phase_seconds": drv.phase_seconds,
           "best_lambda": drv.best_lambda, "best_auc_json": auc_json,
           "best_auc_rescored": scored[AUC], "best_auc_rel_diff": rel,
           "per_lambda": [{"lambda": m.regularization_weight,
                           "iterations": m.result.iterations,
                           "convergence": m.result.convergence_reason.value,
                           "value": m.result.value} for m in drv.models],
           "grid_launches": grid_launches.get("by_path"),
           "max_memory_allocated": peak_memory(torch, dev),
           "stage_seconds": secs}
    shutil.rmtree(workdir, ignore_errors=True)
    return rec


def wide_streamed_phase(torch, dev, smi, data, workdir, hbm,
                        ingest=INGEST, slice_rows=WIDE_SLICE_ROWS,
                        wide=(WIDE_ROWS, WIDE_FEATURES, WIDE_USERS),
                        rcv1=RCV1, diagnostics="ALL"):
    """Phase 12: wide and streamed data (the keyword arguments cut it
    down for a dry run on the CPU). Returns the phase record and the
    kernel's launches in (c)'s in-RAM sweep."""
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)
    record = {"phase": "wide_streamed", "nvidia_smi": smi}
    t0 = time.perf_counter()
    record["a_ingest"], ell = ingest_phase(torch, dev, workdir, ingest)
    record["a_ingest"]["seconds"] = time.perf_counter() - t0
    print("phase 12 (a): " + json.dumps(record["a_ingest"]),
          file=sys.stderr, flush=True)
    t1 = time.perf_counter()
    record["b_wide_solve"] = wide_solve_phase(torch, dev, ell, hbm,
                                              slice_rows)
    record["b_wide_solve"]["seconds"] = time.perf_counter() - t1
    del ell
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print("phase 12 (b): " + json.dumps(record["b_wide_solve"]),
          file=sys.stderr, flush=True)
    t1 = time.perf_counter()
    record["c_streamed_glmix"], c_launches = streamed_glmix_phase(
        torch, dev, data, workdir)
    record["c_streamed_glmix"]["seconds"] = time.perf_counter() - t1
    print("phase 12 (c): " + json.dumps(record["c_streamed_glmix"]),
          file=sys.stderr, flush=True)
    t1 = time.perf_counter()
    record["d_drivers"], _ = wide_drivers_phase(
        torch, dev, os.path.join(workdir, "drivers"), *wide)
    record["d_drivers"]["seconds"] = time.perf_counter() - t1
    print("phase 12 (d): " + json.dumps(record["d_drivers"]),
          file=sys.stderr, flush=True)
    t1 = time.perf_counter()
    record["e_legacy"] = wide_legacy_phase(
        torch, dev, os.path.join(workdir, "legacy"), rcv1, diagnostics)
    record["e_legacy"]["seconds"] = time.perf_counter() - t1
    shutil.rmtree(workdir, ignore_errors=True)
    record["seconds"] = time.perf_counter() - t0
    return record, c_launches


# -- phase 13: bf16 storage and the serving path ---------------------------

#: phase 13 (c): client threads, requests per thread and the largest
#: request (rows drawn uniformly from 1 to it) against the f32 tier, with
#: the hot-swap when half the requests have been answered; then requests
#: per thread against the bf16 tier
#: (20 requests a client, down from 100, then 50 and 30, a cut of depth
#: for the script's time limit: phases 13 (c) and 14 spent ~43 s on 100 a
#: client on a slow host; 30 to 20 made room for phase 17)
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_MAX_ROWS = 4, 20, 256
BF16_TIER_REQUESTS = 15
#: bf16 rounds a coefficient to 8 significant bits: relative error at
#: most 2^-8 (round to nearest)
BF16_REL = 2.0 ** -8
#: phase 13 (c): the traced service's slowest-N exemplar reservoir
EXEMPLAR_SLOTS = 8


def bf16_library_phase(torch, dev, data, f32_glmix):
    """Phase 13 (a): phase 5's GLMix at full width with X and the per-user
    blocks in bf16, two sweeps, then the same two sweeps again on fresh
    coordinates over the same datasets (bit for bit). Returns the record,
    the launch counts of the first run and the kernel's error on the bf16
    fixed-effect batch against its plain version."""
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.ops.losses import get_loss

    t0 = time.perf_counter()
    # what earlier phases still hold on the card: phase 5's peak was
    # measured with nothing before it, so this run's is taken above this
    held = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    coords = glmix_coordinates(data, dev, dtype=torch.bfloat16)
    sync(torch, dev)
    build_secs = time.perf_counter() - t0
    fe_X = coords["fixed"].dataset.batch.X
    re_ds = coords["per-user"].dataset
    dtypes = {str(fe_X.dtype)} | {str(b.X.dtype) for b in re_ds.buckets}
    if dtypes != {"torch.bfloat16"}:
        raise AssertionError(f"bf16 GLMix stores X as {dtypes}")
    res, info = cd_run(torch, dev, data, coords)
    peak = peak_memory(torch, dev)
    launches = info["launches"]
    expected = pk.kernel_path(fe_X.shape[1], fe_X.dtype,
                              fe_X.data_ptr() % 16 == 0)
    check_launches("bf16 GLMix", launches, expected, "logistic", dev)
    again, info2 = cd_run(torch, dev, data, fresh_coordinates(coords))
    eq = runs_equal(torch, res, again, data, dev)
    if not all_equal(eq):
        raise AssertionError(f"bf16 GLMix is not repeatable: {eq}")
    sweeps = [[s.objective for s in res.states if s.iteration == it][-1]
              for it in range(2)]
    if not all(np.isfinite(o) for o in sweeps):
        raise AssertionError(f"non-finite bf16 objective: {sweeps}")
    if not sweeps[1] <= sweeps[0] * (1 + 1e-6):
        raise AssertionError(f"bf16 objective rose between sweeps: {sweeps}")
    err = None
    if dev.type == "cuda":
        batch = coords["fixed"].dataset.with_offsets(coords["per-user"].score(
            final_states(res)["per-user"]))
        err, worst = check_sums(
            torch, get_loss("logistic"), batch.X, batch.labels,
            batch.offsets, batch.weights,
            final_states(res)["fixed"].contiguous(),
            torch.zeros((), device=dev), scaled=True)
        del batch
    record = {
        "rows": int(data.num_samples), "x_dtype": "bfloat16",
        "re_buckets": [list(b.X.shape) for b in re_ds.buckets],
        "build_secs": build_secs, "train_secs": info["secs"],
        "train_secs_repeat": info2["secs"],
        "objectives": sweeps, "objectives_f32": f32_glmix["objectives"],
        "rel_gap_to_f32": [abs(a - b) / abs(b) for a, b in
                           zip(sweeps, f32_glmix["objectives"])],
        "launches_by_path": launches["by_path"], "expected_path": expected,
        "max_memory_allocated": peak, "held_before": held,
        "max_memory_allocated_above_held": (
            peak - held if peak is not None else None),
        "max_memory_allocated_f32": f32_glmix["max_memory_allocated"],
        "repeat_equal": eq, "kernel_vs_plain_max_abs_err": err}
    del coords, res, again
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return record, launches, err


def bf16_driver_phase(torch, dev, drill_fixture, workdir, f32_out):
    """Phase 13 (b): the training driver on the drill's fixture (phase
    7 (b), ``DRILL_ROWS``): in f32 (into ``f32_out``, which phase 15 (c)
    holds its mesh run to), then with ``--precision bf16`` in RAM and with
    ``--random-effect-blocks-dir``: the two bf16 runs' metrics (seconds
    aside) and models record for record equal, the bf16 objectives and
    best AUC beside the f32 run's. Every launch is on the path
    ``kernel_path`` picks for ×65 rows of its dtype. Returns the record,
    the launches by run, the kernel's error on the bf16 ×65 batch and the
    bf16 in-RAM run's output directory (its final model, ``output/grid-0``,
    is (c)'s swap candidate).

    A cut of scale (PERF.md §4): these runs are on the drill's fixture.
    The memmap run moved there when the script measured 1,122.3 s against
    its 1,100 s budget, and the full-size in-RAM run (~55 s, 46 s of it
    the 1,000,209-row Avro read once more) when the script with phase 15
    measured over 1,100 s again. bf16 at full width stays shown by phase
    13 (a) (the library path, bit for bit repeated) and phase 4's ×65
    bf16 timing row; memmap equal to RAM at full width by phase 12 (c)."""
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.game.dataset import build_fixed_effect_dataset
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.ops.losses import get_loss
    from photon_ml_tpu_torch.tools.crash_resume_drill import driver_argv

    tr, va = drill_fixture
    shutil.rmtree(workdir, ignore_errors=True)
    shutil.rmtree(f32_out, ignore_errors=True)
    os.makedirs(workdir)
    runs, launches, err, paths = {}, {}, None, {}
    bf16 = ["--precision", "bf16"]
    blocks = ["--random-effect-blocks-dir", os.path.join(workdir, "blocks")]
    for name, out, extra, dtype in (
            ("drill_f32", f32_out, [], torch.float32),
            ("drill_in_ram", os.path.join(workdir, "drill_in_ram"), bf16,
             torch.bfloat16),
            ("drill_blocks_dir", os.path.join(workdir, "drill_blocks_dir"),
             bf16 + blocks, torch.bfloat16)):
        reset_counts(torch, dev)
        t0 = time.perf_counter()
        trainer = ttd.run(driver_argv(tr, va, out, str(dev), extra=extra))
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches[name] = launch_counts()
        states = json.load(open(os.path.join(out, "metrics.json")))
        (grid,) = states["grid"]
        phase_secs = trainer.phase_seconds
        runs[name] = {
            "training_driver_secs": secs,
            "load_secs": phase_secs["prepareGameDataSet"],
            "train_secs": phase_secs["train grid[0]"],
            "train_secs_per_update": [s["seconds"] for s in grid["states"]],
            "model_write_secs": phase_secs["saveModels"],
            "objectives": [s["objective"] for s in grid["states"]],
            "best_metric": states["best"]["metric"],
            "launches_by_path": launches[name]["by_path"],
            "max_memory_allocated": peak_memory(torch, dev)}
        fe = build_fixed_effect_dataset(trainer.train_data, "global",
                                        dtype=dtype, device=dev)
        X = fe.batch.X
        paths[name] = pk.kernel_path(X.shape[1], X.dtype,
                                     X.data_ptr() % 16 == 0)
        if name == "drill_in_ram" and dev.type == "cuda":
            w = trainer.best_result.model.models["fixed"].model \
                .coefficients.means.to(dev).contiguous()
            err, _ = check_sums(
                torch, get_loss("logistic"), X, fe.batch.labels,
                fe.batch.offsets, fe.batch.weights, w,
                torch.zeros((), device=dev), scaled=True)
        runs[name]["fixed_effect_shape"] = list(X.shape)
        del fe, X
        check_launches(f"drill driver {name}", launches[name], paths[name],
                       "logistic", dev)
        del trainer
    ram, mm = (os.path.join(workdir, k) for k in ("drill_in_ram",
                                                  "drill_blocks_dir"))
    if metrics_without_seconds(ram) != metrics_without_seconds(mm):
        raise AssertionError("bf16 driver: the --random-effect-blocks-dir "
                             "run's metrics differ from the in-RAM run's")
    for model in ("best", os.path.join("output", "grid-0")):
        if model_records(ram, model) != model_records(mm, model):
            raise AssertionError(f"bf16 driver: the --random-effect-blocks-"
                                 f"dir run's {model} differs from the "
                                 f"in-RAM run's")
    objs = runs["drill_in_ram"]["objectives"]
    f32 = runs["drill_f32"]
    # under the per-user cap only a fixed-effect update must not raise the
    # objective it starts from (PERF.md §2): sweep 2's, from sweep 1's end
    if not all(np.isfinite(o) for o in objs) or not objs[2] <= objs[1] * (
            1 + 1e-6):
        raise AssertionError(f"bf16 driver objectives: {objs}")
    record = {
        "runs": runs, "expected_path": paths,
        "blocks_dir_equals_in_ram": True,
        "reduced": {"rows": list(DRILL_ROWS),
                    "why": "the drill's fixture: the script measured "
                           "1,122.3 s (the memmap run moved) and over "
                           "1,100 s once phase 15 was added (the full-size "
                           "in-RAM run moved) against its 1,100 s budget"},
        "objectives_f32": f32["objectives"],
        "rel_gap_to_f32": [abs(a - b) / abs(b) for a, b in
                           zip(objs, f32["objectives"])],
        "best_auc_f32": f32["best_metric"],
        "best_auc_gap_to_f32": runs["drill_in_ram"]["best_metric"]
        - f32["best_metric"],
        "kernel_vs_plain_max_abs_err": err}
    shutil.rmtree(os.path.join(workdir, "blocks"), ignore_errors=True)
    return record, launches, err, ram


class ServiceProcess:
    """``python -m <module>`` (the scoring service unless told otherwise)
    as a child: :meth:`wait_ready` waits for its ready line (stderr to a
    file under ``workdir``), and :meth:`stop` sends SIGTERM and returns
    the exit code."""

    def __init__(self, args, workdir, name, timeout=300.0, wait=True,
                 module="photon_ml_tpu_torch.serve.service"):
        self.name, self.timeout = name, timeout
        self.err_path = os.path.join(workdir, f"{name}.stderr")
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args], cwd=REPO, text=True,
            stdout=subprocess.PIPE, stderr=self._err)
        self.endpoint = None
        if wait:
            self.wait_ready()

    def wait_ready(self) -> "ServiceProcess":
        import select

        ready, _, _ = select.select([self.proc.stdout], [], [],
                                    self.timeout)
        line = self.proc.stdout.readline().strip() if ready else ""
        if not line.startswith("PHOTON_SERVE ready endpoint="):
            self.proc.kill()
            self.proc.wait()
            raise AssertionError(f"{self.name}: no ready line ({line!r}):\n"
                                 f"{self.stderr()[-3000:]}")
        self.endpoint = line.split("endpoint=", 1)[1]
        return self

    def stderr(self) -> str:
        if not self._err.closed:
            self._err.flush()
        with open(self.err_path) as f:
            return f.read()

    def stop(self, timeout=120.0) -> int:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise
        self._err.close()
        return rc

    def kill(self) -> int:
        """SIGKILL: the process dies with no drain."""
        self.proc.kill()
        rc = self.proc.wait()
        self._err.close()
        return rc


def drive_clients(endpoint, records, requests, seed, on_half=None):
    """``SERVE_CLIENTS`` threads, each sending ``requests`` requests of 1 to
    ``SERVE_MAX_ROWS`` consecutive records; ``on_half`` runs in a thread
    of its own once half of all requests have been answered, and then each
    client goes on until it has returned, and for ``requests // 4`` more
    requests after that. Returns the responses as (sent, done, uids,
    scores), failures, and the seconds."""
    import threading

    from photon_ml_tpu_torch.serve.protocol import ServeClient

    total = SERVE_CLIENTS * requests
    answered = [0]
    half, resolved = threading.Event(), threading.Event()
    if on_half is None:
        resolved.set()
    lock = threading.Lock()
    out, failures = [], []

    def client(ci):
        rng = np.random.default_rng(seed + ci)
        got = []
        try:
            with ServeClient(endpoint, timeout=120.0) as c:
                sent_n, tail = 0, requests // 4 if on_half else 0
                while sent_n < requests or not resolved.is_set() or tail:
                    if sent_n >= requests and resolved.is_set():
                        tail -= 1
                    sent_n += 1
                    n = int(rng.integers(1, SERVE_MAX_ROWS + 1))
                    lo = int(rng.integers(0, len(records) - n))
                    sent = time.perf_counter()
                    resp = c.score(records[lo:lo + n])
                    done = time.perf_counter()
                    if resp.get("kind") != "scores":
                        failures.append(f"client {ci}: {resp}")
                        return
                    got.append((sent, done, resp["uids"], resp["scores"]))
                    with lock:
                        answered[0] += 1
                        if answered[0] * 2 >= total:
                            half.set()
        except Exception as e:  # noqa: BLE001 — reported as a failure
            failures.append(f"client {ci}: {e!r}")
        finally:
            half.set()
        with lock:
            out.extend(got)

    def swap():
        half.wait()
        try:
            on_half()
        finally:
            resolved.set()

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(SERVE_CLIENTS)]
    if on_half is not None:
        threads.append(threading.Thread(target=swap))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, failures, time.perf_counter() - t0


def latency_summary(responses, secs) -> dict:
    lat = np.asarray([(d - s) * 1e3 for s, d, _, _ in responses])
    rows = sum(len(u) for _, _, u, _ in responses)
    return {"requests": len(responses), "rows": rows,
            "rows_per_sec": rows / secs, "seconds": secs,
            "client_p50_ms": float(np.percentile(lat, 50)),
            "client_p99_ms": float(np.percentile(lat, 99))}


def serve_trace_record(trace_dir, status) -> dict:
    """Phase 13 (c)'s and 14's checks of a traced service or router: the
    trace directory's files, ``run_end`` with ``status``, and, where the
    process scored, ``exemplars.jsonl`` (``EXEMPLAR_SLOTS`` records, each
    a request's stage tree) and the ``serve.generation`` / ``serve.swap``
    spans. Returns the stage totals of the sampled requests' spans (ms)
    by the JAX package's stage names, and the exemplars' latencies."""
    got = read_trace_dir(trace_dir)
    if got["run_end"]["status"] != status:
        raise AssertionError(f"{trace_dir}: run_end {got['run_end']}")
    names = collections.Counter(s["name"] for s in got["spans"])
    record = {"files": sorted(os.listdir(trace_dir)),
              "spans": dict(names)}
    if not os.path.exists(os.path.join(trace_dir, "exemplars.jsonl")):
        return record
    with open(os.path.join(trace_dir, "exemplars.jsonl")) as f:
        exemplars = [json.loads(ln) for ln in f]
    stages = ("serve.request",) + SERVE_STAGES
    if len(exemplars) != EXEMPLAR_SLOTS or any(
            [e["name"] for e in ex["events"]] != list(stages)
            for ex in exemplars):
        raise AssertionError(f"exemplars.jsonl: {len(exemplars)} records")
    if not names["serve.generation"] or not names["serve.swap"]:
        raise AssertionError(f"service spans: {dict(names)}")
    stage_ms = {n: 0.0 for n in SERVE_STAGES}
    for s in got["spans"]:
        if s["name"] in stage_ms:
            stage_ms[s["name"]] += s["dur_us"] / 1e3
    record.update(
        stage_ms=stage_ms, sampled_requests=names["serve.request"],
        exemplar_latency_ms=sorted(ex["latency_ms"] for ex in exemplars),
        slowest_exemplar_stage_ms={
            e["name"]: e["dur_us"] / 1e3 for e in max(
                exemplars, key=lambda ex: ex["latency_ms"])["events"]})
    return record


def serve_phase(torch, dev, smi, driver_dir, bf16_model_dir, workdir, pool):
    """Phase 13 (c): the port's scoring service as a process on the card,
    serving phase 6's final f32 model (``output/grid-0``: its ``best/`` is
    the first state, whose per-user model is empty) over a unix socket
    with the default 64 MB device-tier budget, under
    ``SERVE_CLIENTS`` concurrent clients sending records of ``pool`` (an
    Avro file of phase 6's recipe and widths); hot-swapped to (b)'s
    bf16-trained model once half the requests are answered, with the
    canary gate open (as
    ``bench.py:1534-1537``); then SIGTERM. Every score must equal, bit
    for bit, the scoring driver's (run here on that model and the rows)
    for its uid before the flip and the library's score of the candidate
    after it, no request may be
    shed, and the service must exit 75. A second service with the bf16
    tier scores within the bound bf16 rounding of the coefficients
    allows."""
    from photon_ml_tpu_torch.game.models import (
        rowwise_sparse_dot_gathered, rowwise_sparse_dot_on_device)
    from photon_ml_tpu_torch.io import data_format as tdf
    from photon_ml_tpu_torch.io.avro import read_records
    from photon_ml_tpu_torch.io.model_io import load_scored_items
    from photon_ml_tpu_torch.serve.protocol import ServeClient
    from photon_ml_tpu_torch.serve.scoring import (
        load_scoring_model, materialize_model, score_game_dataset)

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    f32_model = os.path.join(driver_dir, "train_out", "output", "grid-0")
    # the requests' records: ``pool``, an Avro file of phase 6's recipe
    # and widths
    part = pool
    t0 = time.perf_counter()
    records = read_records(part)
    read_secs = time.perf_counter() - t0
    score_out = os.path.join(workdir, "score_out")
    t0 = time.perf_counter()
    score_in_process([
        "--input-data-dirs", part, "--game-model-input-dir", f32_model,
        "--output-dir", score_out,
        "--feature-shard-id-to-feature-section-keys-map", DRIVER_SECTIONS,
        "--random-effect-id-set", "userId", "--device", str(dev)])
    scoring_driver_secs = time.perf_counter() - t0
    driver_scores = {r["uid"]: r["predictionScore"] for r in
                     load_scored_items(os.path.join(
                         score_out, "scores", "part-00000.avro"))}
    sections = {k: [v] for k, v in (x.split(":") for x in
                                    DRIVER_SECTIONS.split("|"))}
    # the candidate's scores of these rows through the scoring core, and
    # each row's sum of |x w| over the f32 model's per-user coefficients
    refs = {}
    for name, model_dir in (("f32", f32_model), ("bf16", bf16_model_dir)):
        model, maps = load_scoring_model(model_dir, {})
        model = materialize_model(model)
        data = tdf.load_game_dataset_avro([part], sections, maps,
                                          id_types=["userId"],
                                          response_required=False)
        refs[name] = dict(zip(data.uids, score_game_dataset(
            model, data, device=dev).astype(np.float64)))
        data_uids = data.uids
        if name == "f32":
            re = model.models["perUser"]
            n_entities = int(re.coefficients.shape[0])
            if not n_entities or not re.coefficients.shape[1]:
                raise AssertionError(f"phase 6's model has no per-user "
                                     f"coefficients to serve: "
                                     f"{list(re.coefficients.shape)}")
            coefs = re.coefficients.cpu().numpy()
            padded = np.vstack([coefs, np.zeros((1, coefs.shape[1]),
                                                coefs.dtype)])
            mat = data.feature_shards[re.feature_shard_id]
            local = re._lookup(data)
            # the service's row dot on the card against the scoring
            # driver's on the host, over every validation row
            t1 = time.perf_counter()
            on_card = rowwise_sparse_dot_on_device(
                mat, torch.as_tensor(padded, device=dev), local).cpu()
            row_dot_secs = time.perf_counter() - t1
            on_host = torch.as_tensor(rowwise_sparse_dot_gathered(
                mat, padded, local), dtype=torch.float32)
            if not torch.equal(on_card, on_host):
                raise AssertionError(
                    f"the per-user row dot on the card differs from the "
                    f"host form on {int((on_card != on_host).sum())} of "
                    f"{len(on_host)} rows")
            magnitude = dict(zip(data.uids, rowwise_sparse_dot_gathered(
                abs(mat), np.abs(padded), local)))
        del model, data
    for uid, s in refs["f32"].items():
        if driver_scores[uid] != s:
            raise AssertionError("the scoring core's f32 scores differ from "
                                 "the scoring driver's")
    base = ["--game-model-input-dir", f32_model,
            "--feature-shard-id-to-feature-section-keys-map",
            DRIVER_SECTIONS, "--random-effect-id-set", "userId",
            "--swap-canary-threshold-pct", "1e9",
            "--swap-probation-seconds", "0.5", "--device", str(dev)]
    record = {"phase": "serve", "nvidia_smi": smi, "records": len(records),
              "records_file": os.path.relpath(part, REPO),
              "read_records_secs": read_secs,
              "scoring_driver_secs": scoring_driver_secs,
              "users": n_entities,
              "per_user_columns": int(coefs.shape[1]),
              "row_dot_rows": len(data_uids),
              "row_dot_on_card_equals_host": True,
              "row_dot_on_card_secs": row_dot_secs}

    # -- the f32 tier, with the hot-swap under load, traced -----------------
    serve_trace = os.path.join(workdir, "f32_trace")
    t0 = time.perf_counter()
    svc = ServiceProcess(base + ["--listen", "unix:" + os.path.join(
        workdir, "f32.sock"), "--trace-dir", serve_trace,
        "--trace-heartbeat-seconds", str(TRACE_HEARTBEAT_SECONDS),
        "--trace-exemplar-slots", str(EXEMPLAR_SLOTS)], workdir,
        "serve_f32")
    start_secs = time.perf_counter() - t0
    swap = {}

    def do_swap():
        swap["start"] = time.perf_counter()
        with ServeClient(svc.endpoint, timeout=600.0) as c:
            swap["result"] = c.swap(bf16_model_dir, model_id="bf16-trained")
        swap["end"] = time.perf_counter()

    try:
        responses, failures, secs = drive_clients(
            svc.endpoint, records, SERVE_REQUESTS, seed=31, on_half=do_swap)
        with ServeClient(svc.endpoint) as c:
            stats = c.stats()
    finally:
        rc = svc.stop()
    err = svc.stderr()
    if failures:
        raise AssertionError(f"f32 service: {failures[:3]}")
    if swap.get("result", {}).get("outcome") != "ok":
        raise AssertionError(f"the hot-swap did not complete: {swap}")
    if stats["generation"] != 2:
        raise AssertionError(f"stats after the swap: generation "
                             f"{stats['generation']}")
    if rc != 75 or "PHOTON_PREEMPTED" not in err or "Traceback" in err:
        raise AssertionError(f"f32 service: exit {rc} after SIGTERM:\n"
                             f"{err[-3000:]}")
    by_gen = {1: 0, 2: 0, "either": 0}
    for sent, done, uids, scores in responses:
        # a row whose two models' f32 scores round alike matches both
        old = all(driver_scores[u] == s for u, s in zip(uids, scores))
        new = all(refs["bf16"][u] == s for u, s in zip(uids, scores))
        if not (old or new):
            raise AssertionError("a response matches neither generation's "
                                 "reference bit for bit")
        if new and not old and done < swap["start"]:
            raise AssertionError("a candidate score before the swap began")
        by_gen["either" if old and new else 1 if old else 2] += 1
    if not by_gen[1] or not by_gen[2]:
        raise AssertionError(f"responses by generation: {by_gen}")
    window = [(d - s) * 1e3 for s, d, _, _ in responses
              if d >= swap["start"] and s <= swap["end"]]
    record["f32_tier"] = {
        **latency_summary(responses, secs), "start_secs": start_secs,
        "responses_by_generation": by_gen,
        "scores_equal_scoring_driver": True, "shed": 0,
        "swap": {"outcome": swap["result"]["outcome"],
                 "generation": swap["result"]["generation"],
                 "canary": swap["result"].get("canary"),
                 "seconds": swap["end"] - swap["start"],
                 "blackout_ms": max(window) if window else 0.0},
        "stats_generation": stats["generation"],
        "tiers": stats["tiers"], "tier_hits": stats["tier_hits"],
        "stage_ms": stats["stage_ms"],
        "service_max_memory_allocated":
            stats.get("device_max_memory_allocated"),
        "exit_code": rc,
        "trace": serve_trace_record(serve_trace, "preempted")}
    print("phase 13 (c) f32 tier: " + json.dumps(record["f32_tier"]),
          file=sys.stderr, flush=True)
    sampled = record["f32_tier"]["trace"]["stage_ms"]
    print(f"phase 13 (c) traced ({smi}): stage split of the sampled "
          f"requests (ms) {json.dumps(sampled)}"
          f"; of every request (serve_stage_ms sums) "
          f"{json.dumps({k: v['sum'] for k, v in stats['stage_ms'].items()})}",
          file=sys.stderr, flush=True)

    # -- the bf16 tier ------------------------------------------------------
    t0 = time.perf_counter()
    svc = ServiceProcess(base + ["--serve-tier-dtype", "bf16", "--listen",
                                 "unix:" + os.path.join(workdir, "bf16.sock")],
                         workdir, "serve_bf16")
    start_secs = time.perf_counter() - t0
    try:
        responses, failures, secs = drive_clients(
            svc.endpoint, records, BF16_TIER_REQUESTS, seed=71)
        with ServeClient(svc.endpoint) as c:
            stats = c.stats()
    finally:
        rc = svc.stop()
    err = svc.stderr()
    if failures:
        raise AssertionError(f"bf16-tier service: {failures[:3]}")
    if rc != 75 or "PHOTON_PREEMPTED" not in err:
        raise AssertionError(f"bf16-tier service: exit {rc}:\n{err[-3000:]}")
    worst, moved = 0.0, 0
    for _, _, uids, scores in responses:
        for u, s in zip(uids, scores):
            ref = refs["f32"][u]
            # bf16 rows move the per-user term by at most 2^-8 sum |x w|;
            # the sums' f32 rounding adds at most a few ulps of the terms
            bound = BF16_REL * magnitude[u] + 2.0 ** -21 * (
                abs(ref) + magnitude[u])
            worst = max(worst, abs(s - ref) / bound if bound else 0.0)
            moved += s != ref
    if worst > 1.0:
        raise AssertionError(f"bf16 tier: a score moved {worst:.3g}x its "
                             f"bf16 bound")
    if stats["tiers"][0]["device_capacity"] != n_entities:
        raise AssertionError(f"the bf16 tier does not hold all "
                             f"{n_entities} users: {stats['tiers']}")
    record["bf16_tier"] = {
        **latency_summary(responses, secs), "start_secs": start_secs,
        "worst_gap_over_bound": worst, "rows_moved": int(moved),
        "bound": "2^-8 sum_j |x_j w_j| + 2^-21 (|s| + sum_j |x_j w_j|)",
        "tiers": stats["tiers"], "tier_hits": stats["tier_hits"],
        "stage_ms": stats["stage_ms"],
        "service_max_memory_allocated":
            stats.get("device_max_memory_allocated"),
        "exit_code": rc}
    print("phase 13 (c) bf16 tier: " + json.dumps(record["bf16_tier"]),
          file=sys.stderr, flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    # phase 14 serves the same model to the same rows: it reads neither
    # the Avro nor the scoring driver again
    return record, {"records": records, "model_dir": f32_model,
                    "driver_scores": driver_scores}


# -- phase 14: the scorer fleet ---------------------------------------------

#: phase 14: members behind the router, each with half the service's
#: default 64 MB device-tier budget
FLEET_MEMBERS, FLEET_HBM_BUDGET_MB = 2, 32


def drive_fleet_clients(endpoint, records, requests, seed, num_shards,
                        on_half=None):
    """``SERVE_CLIENTS`` threads sending ``requests`` requests each of 1 to
    ``SERVE_MAX_ROWS`` consecutive records through the router;
    ``on_half`` runs once half are answered. A request resolves with
    scores or a typed shed; anything else (another error, a timeout: a
    hung request) is a failure. Returns the scored responses as (sent,
    done, uids, scores), the sheds, the failures, the dispatches the
    requests make (one per shard their rows touch), the rows sent to
    each shard, and the seconds."""
    import threading

    from photon_ml_tpu_torch.serve.fleet import entity_of_row, entity_shard
    from photon_ml_tpu_torch.serve.protocol import (
        ServeClient, ShardUnavailableError, ShedError, typed_error)

    total = SERVE_CLIENTS * requests
    lock = threading.Lock()
    half = threading.Event()
    out, sheds, failures = [], [], []
    counts = {"answered": 0, "dispatches": 0,
              "shard_rows": [0] * num_shards}

    def client(ci):
        rng = np.random.default_rng(seed + ci)
        try:
            with ServeClient(endpoint, timeout=120.0) as c:
                for _ in range(requests):
                    n = int(rng.integers(1, SERVE_MAX_ROWS + 1))
                    lo = int(rng.integers(0, len(records) - n))
                    rows = records[lo:lo + n]
                    shards = [entity_shard(entity_of_row(r, "userId"),
                                           num_shards) for r in rows]
                    sent = time.perf_counter()
                    resp = c.score(rows)
                    done = time.perf_counter()
                    with lock:
                        counts["dispatches"] += len(set(shards))
                        for k in shards:
                            counts["shard_rows"][k] += 1
                        counts["answered"] += 1
                        if counts["answered"] * 2 >= total:
                            half.set()
                        if resp.get("kind") == "scores":
                            out.append((sent, done, resp["uids"],
                                        resp["scores"]))
                        elif isinstance(typed_error(resp),
                                        (ShedError, ShardUnavailableError)):
                            sheds.append(resp["error"])
                        else:
                            failures.append(f"client {ci}: {resp}")
        except Exception as e:  # noqa: BLE001 — a hung or broken request
            failures.append(f"client {ci}: {e!r}")
        finally:
            half.set()

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(SERVE_CLIENTS)]
    if on_half is not None:
        threads.append(threading.Thread(
            target=lambda: (half.wait(), on_half())))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return (out, sheds, failures, counts["dispatches"],
            counts["shard_rows"], time.perf_counter() - t0)


def router_stats(endpoint) -> dict:
    from photon_ml_tpu_torch.serve.protocol import ServeClient

    with ServeClient(endpoint, timeout=60.0) as c:
        return c.stats()


def wait_member_state(endpoint, member, state, admissions=None,
                      timeout=120.0) -> float:
    """Poll the router's stats until ``member`` is in ``state`` (with at
    least ``admissions`` admissions); returns when it was seen."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        snap = router_stats(endpoint)["fleet"]["members"][member]
        if snap["state"] == state and (
                admissions is None or snap["admissions"] >= admissions):
            return time.perf_counter()
        time.sleep(0.05)
    raise AssertionError(f"fleet member {member} never became {state}: "
                         f"{router_stats(endpoint)['fleet']}")


def fleet_phase(torch, dev, smi, served, workdir):
    """Phase 14: the scorer fleet on the card. ``FLEET_MEMBERS`` port
    services (``--serve-hbm-budget-mb 32`` each) serve phase 6's final
    f32 model behind the port's router (``photon_serve fleet``, traced),
    routing by ``userId``; ``SERVE_CLIENTS`` clients send ``SERVE_REQUESTS``
    requests each of phase 13 (c)'s validation records, and member 1 is
    SIGKILLed once half are answered. Every score equals the scoring
    driver's for its uid bit for bit (phase 13 (c)'s reference), every
    request resolves with scores or a typed shed (none hangs), and the
    router's ``serve_route`` ledger accounts for every dispatch. SIGTERM:
    the router exits 75, then the live member. (Member 1's relaunch and
    re-admission are phase 17 (b)'s.) Returns the phase record."""

    records, model_dir, ref = (served[k] for k in (
        "records", "model_dir", "driver_scores"))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)

    def member_args(k):
        return ["--game-model-input-dir", model_dir,
                "--feature-shard-id-to-feature-section-keys-map",
                DRIVER_SECTIONS, "--random-effect-id-set", "userId",
                "--serve-hbm-budget-mb", str(FLEET_HBM_BUDGET_MB),
                "--listen", "unix:" + os.path.join(workdir, f"m{k}.sock"),
                "--device", str(dev)]

    def check_scores(responses):
        bad = sum(ref[u] != s for _, _, uids, scores in responses
                  for u, s in zip(uids, scores))
        if bad:
            raise AssertionError(f"fleet: {bad} scores differ from the "
                                 f"scoring driver's")

    router_trace = os.path.join(workdir, "router_trace")
    procs = []
    record = {"phase": "fleet", "nvidia_smi": smi,
              "members": FLEET_MEMBERS,
              "member_hbm_budget_mb": FLEET_HBM_BUDGET_MB,
              "records": len(records)}
    try:
        t0 = time.perf_counter()
        members = [ServiceProcess(member_args(k), workdir, f"member{k}",
                                  wait=False) for k in range(FLEET_MEMBERS)]
        procs += members
        for m in members:
            m.wait_ready()
        record["members_ready_secs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        router = ServiceProcess(
            ["fleet", "--listen", "unix:" + os.path.join(workdir, "r.sock"),
             "--members", ",".join(m.endpoint for m in members),
             "--route-id", "userId", "--heartbeat-seconds", "0.2",
             "--trace-dir", router_trace,
             "--trace-heartbeat-seconds", str(TRACE_HEARTBEAT_SECONDS)],
            workdir, "router", module="photon_ml_tpu_torch.tools.photon_serve")
        procs.append(router)
        record["router_ready_secs"] = time.perf_counter() - t0
        killed = {}

        def kill_member():
            killed["at"] = time.perf_counter()
            killed["rc"] = members[1].kill()

        responses, sheds, failures, dispatches, shard_rows, secs = \
            drive_fleet_clients(router.endpoint, records, SERVE_REQUESTS,
                                seed=41, num_shards=FLEET_MEMBERS,
                                on_half=kill_member)
        if failures:
            raise AssertionError(f"fleet under a member kill: {failures[:3]}")
        if "at" not in killed or killed["rc"] != -9:
            raise AssertionError(f"member 1 was not killed: {killed}")
        check_scores(responses)
        wait_member_state(router.endpoint, 1, "dead")
        stats = router_stats(router.endpoint)
        route = stats["route"]
        resolved = sum(route.get(k, 0) for k in ("ok", "error", "shed"))
        if resolved != dispatches:
            raise AssertionError(f"serve_route ledger {route} resolves "
                                 f"{resolved} of {dispatches} dispatches")
        record["under_kill"] = {
            **latency_summary(responses, secs), "sheds": len(sheds),
            "shed_reasons": sorted(set(sheds)),
            "dispatches": dispatches, "serve_route": route,
            "failovers": route.get("failover", 0),
            "rows_by_shard": shard_rows,
            "kill_after_secs": killed["at"] - min(r[0] for r in responses),
            "scores_equal_scoring_driver": True}

        # member 1's relaunch and the router's generation-checked
        # re-admission are phase 17 (b)'s, under the supervisor
        record["reduced"] = {
            "left_out": "member 1's relaunch, its re-admission and 10 "
                        "more requests a client",
            "why": "phase 17 (b) relaunches a killed member of the same "
                   "fleet through photon_supervise and holds its "
                   "re-admission, the scores after it (none shed), both "
                   "members' tier hits and the serve_route ledger; "
                   "PERF.md section 4 gives the seconds before and after"}
        rc = router.stop()
        err = router.stderr()
        if rc != 75 or "PHOTON_PREEMPTED" not in err or "Traceback" in err:
            raise AssertionError(f"router: exit {rc}:\n{err[-3000:]}")
        rcs = [m.stop() for k, m in enumerate(members) if k != 1]
        if rcs != [75] * (FLEET_MEMBERS - 1):
            raise AssertionError(f"members: exit {rcs}")
        record["exit_codes"] = {"router": rc, "members": rcs,
                                "killed_member": killed["rc"]}
        record["router_trace"] = serve_trace_record(router_trace,
                                                    "preempted")
    finally:
        for p in procs:
            if p.proc.poll() is None:
                p.proc.kill()
                p.proc.wait()
    print(f"phase 14 fleet ({smi}): " + json.dumps(record), file=sys.stderr,
          flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    return record


def bf16_serve_phase(torch, dev, smi, data, f32_glmix, drill_fixture,
                     driver_dir, workdir, drill_f32_out):
    """Phase 13: (a) bf16 GLMix in the library, (b) the bf16 training
    drivers, (c) the scoring service with the hot-swap, traced. Returns
    the phase record, the kernel's launches by run, its errors against
    the plain version and what (c) served (its records, the f32 model and
    the scoring driver's scores by uid), which phase 14 serves again."""
    record = {"phase": "bf16_serve", "nvidia_smi": smi}
    t0 = time.perf_counter()
    record["a_library"], a_launches, a_err = bf16_library_phase(
        torch, dev, data, f32_glmix)
    record["a_library"]["seconds"] = time.perf_counter() - t0
    print("phase 13 (a): " + json.dumps(record["a_library"]),
          file=sys.stderr, flush=True)
    t1 = time.perf_counter()
    record["b_drivers"], b_launches, b_err, bf16_out = bf16_driver_phase(
        torch, dev, drill_fixture, os.path.join(workdir, "drivers"),
        drill_f32_out)
    record["b_drivers"]["seconds"] = time.perf_counter() - t1
    print("phase 13 (b): " + json.dumps(record["b_drivers"]),
          file=sys.stderr, flush=True)
    t1 = time.perf_counter()
    record["c_serve"], served = serve_phase(
        torch, dev, smi, driver_dir,
        os.path.join(bf16_out, "output", "grid-0"),
        os.path.join(workdir, "serve"), pool=drill_fixture[1])
    record["c_serve"]["reduced"] = {
        "records": {"served": record["c_serve"]["records"],
                    "validation_part": 50_000},
        "why": "the requests draw 1 to 256 consecutive records from the "
               "drill's 5,000-row validation file, not from the 50,000 of "
               "phase 6's first validation part: its pure-Python read, "
               "the scoring driver's reference and the row-dot check "
               "shrink with it; PERF.md section 4 gives the seconds",
        "scoring_driver": SCORING_IN_PROCESS}
    record["c_serve"]["seconds"] = time.perf_counter() - t1
    shutil.rmtree(workdir, ignore_errors=True)
    record["seconds"] = time.perf_counter() - t0
    launches = {"bf16_glmix": a_launches,
                **{f"bf16_driver_{k}": v for k, v in b_launches.items()}}
    return (record, launches, [e for e in (a_err, b_err) if e is not None],
            served)


# -- phase 15: the device mesh ----------------------------------------------

#: shards of phase 15's meshes: four on the one card ([dev] * 4)
MESH_SHARDS = 4
#: phase 15 (b)'s bound on the int8 run's objectives against the exact
#: ones: the int8 score exchange rounds each sample's per-user score to
#: 1/254 of its 256-sample block's largest, and those scores are the fixed
#: effect's offsets (measured on an NVIDIA H100: PERF.md §6)
INT8_OBJECTIVE_RTOL = 1e-3
#: phase 15 (b)'s bound on a data-sharded run's objectives against the
#: unsharded f32 run: the fixed-effect updates within 1e-5 (the sharded
#: sums reassociate: rel 3.9e-7 measured); the per-user updates after them
#: within 1e-4, since a capped per-user solve amplifies its offsets' f32
#: difference (rel 2.4e-5 after the last one at 4 x 1, 1.0e-6 at 2 x 2, on
#: an NVIDIA H100: PERF.md §6). The witness of :func:`per_user_witness`
#: shows the per-user gap comes from the offsets alone.
SHARDED_FE_RTOL, SHARDED_RE_RTOL = 1e-5, 1e-4


def mesh_coordinates(coords, entity_shards=1, shard_weight_update=False,
                     quant="none"):
    """New coordinates over ``coords``' datasets with the mesh's knobs on
    their problems (update counts start anew)."""
    import dataclasses

    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate, RandomEffectCoordinate)

    out = {}
    for cid, c in coords.items():
        if isinstance(c, FixedEffectCoordinate):
            out[cid] = FixedEffectCoordinate(
                dataset=c.dataset, problem=dataclasses.replace(
                    c.problem, shard_weight_update=shard_weight_update,
                    collective_quant=quant))
        else:
            out[cid] = RandomEffectCoordinate(
                dataset=c.dataset, problem=dataclasses.replace(
                    c.problem, entity_shards=entity_shards,
                    collective_quant=quant))
    return out


def shard_split_bytes(coords, n_data, n_entity) -> dict:
    """The bytes each shard's pieces hold: a data shard's rows of the
    fixed effect's X and its three ``[n]`` vectors (rows padded to the
    axis), an entity shard's lanes of every per-user bucket (X, labels,
    offsets, weights, row ids). On one card they are views of the same
    tensors; on a mesh of cards each would live on its own."""
    from photon_ml_tpu_torch.parallel.mesh import pad_rows_to_multiple

    X = coords["fixed"].dataset.batch.X
    rows = pad_rows_to_multiple(int(X.shape[0]), n_data) // n_data
    row_bytes = int(X.shape[1]) * X.element_size() + 12
    lane_bytes = sum(
        b.X[0].numel() * b.X.element_size() + b.labels[0].numel() * 12
        + b.row_ids[0].numel() * 8
        for b in coords["per-user"].dataset.buckets)
    lanes = sum(int(b.X.shape[0]) for b in coords["per-user"].dataset
                .buckets) // n_entity
    return {"data_shard_bytes": [rows * row_bytes] * n_data,
            "entity_shard_bytes": [lanes * lane_bytes] * n_entity}


def mesh_cd_run(torch, dev, data, coords, mesh):
    """``cd_run`` with ``mesh`` the default mesh, the collective-byte and
    solve counters zeroed; returns the result and its record."""
    from photon_ml_tpu_torch.game import random_effect as re_mod
    from photon_ml_tpu_torch.obs.metrics import REGISTRY
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.parallel.mesh import set_default_mesh

    REGISTRY.counter("collective_bytes").reset()
    re_mod.reset_solve_stats()
    set_default_mesh(mesh)
    try:
        res, counts = cd_run(torch, dev, data, coords)
    finally:
        set_default_mesh(None)
    cb = REGISTRY.counter("collective_bytes")
    return res, {
        "secs": counts["secs"],
        "objectives": [s.objective for s in res.states],
        "launches": counts["launches"],
        "launches_by_shard": dict(
            pk.fused_value_gradient_sums.launches_by_shard),
        "solver_syncs": counts["solver_syncs"],
        "shard_real_lanes": re_mod.SOLVE_STATS["shard_real_lanes"],
        "collective_bytes_by_site": cb.by_label("site"),
        "collective_bytes_by_mode": cb.by_label("mode"),
        "max_memory_allocated": peak_memory(torch, dev)}


def record_last_update(coords, cid) -> dict:
    """Wrap ``coords[cid].update`` so that the returned dict holds the
    inputs (state, offsets) and the new state of its last call."""
    coord = coords[cid]
    inner = coord.update
    last = {}

    def update(state, extra_scores):
        out = inner(state, extra_scores)
        last.update(state=state, extra_scores=extra_scores, out=out[0])
        return out

    coord.update = update
    return last


def per_user_witness(torch, coords, res, last, phase5) -> dict:
    """The 4 x 1 run's last per-user update again, unsharded and with no
    mesh, from the inputs the run gave it (its per-user state and the
    offsets of its data-sharded fixed effect): it must equal the run's
    per-user state bit for bit, so that the per-user objective's gap to
    phase 5 comes from those offsets and not from the mesh. Beside it, how
    far the inputs moved: the fixed effect's coefficients and scores, and
    the final per-user coefficients, against phase 5's."""
    from photon_ml_tpu_torch.parallel.mesh import set_default_mesh

    set_default_mesh(None)
    again, _ = mesh_coordinates(coords)["per-user"].update(
        last["state"], last["extra_scores"])
    num_real = len(coords["per-user"].dataset.entity_codes)
    c_run = res.model.models["per-user"].coefficients_projected
    w4 = res.model.models["fixed"].model.coefficients.means
    w5 = phase5["fixed"]
    s4, s5 = coords["fixed"].score(w4), coords["fixed"].score(w5)
    codes = {int(c): i for i, c in enumerate(
        coords["per-user"].dataset.entity_codes)}
    rows = torch.as_tensor([codes[int(c)] for c in phase5["codes"]],
                           device=c_run.device)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    return {"rerun_equals_run": bool(torch.equal(again, last["out"])),
            "run_state_is_model": bool(torch.equal(last["out"][:num_real],
                                                   c_run)),
            "fixed_coef_rel_to_phase5": rel(w4, w5),
            "fixed_score_rel_to_phase5": rel(s4, s5),
            "per_user_coef_rel_to_phase5": rel(c_run[rows],
                                               phase5["per-user"])}


def rel_by_coordinate(res, ref_objectives) -> dict:
    """The largest relative objective gap to ``ref_objectives`` (one per
    update, in order), over the fixed effect's updates and over the
    per-user ones."""
    out = {}
    for s, r in zip(res.states, ref_objectives):
        gap = abs(s.objective - r) / abs(r)
        out[s.coordinate_id] = max(out.get(s.coordinate_id, 0.0), gap)
    return out


def equals_phase5(torch, res, coords, data, dev, phase5) -> dict:
    """A run against phase 5's, bit for bit: per-update objectives, the
    fixed effect's final state, the per-user states matched entity by
    entity (the padded buckets order and count lanes otherwise), and the
    published model's scores."""
    codes = {int(c): i for i, c in enumerate(
        coords["per-user"].dataset.entity_codes)}
    c15 = res.model.models["per-user"].coefficients_projected
    rows = torch.as_tensor([codes[int(c)] for c in phase5["codes"]],
                           device=c15.device)
    return {
        "objectives": [s.objective for s in res.states]
        == phase5["objectives"],
        "fixed": bool(torch.equal(
            res.model.models["fixed"].model.coefficients.means,
            phase5["fixed"])),
        "per_user": bool(torch.equal(c15[rows], phase5["per-user"])),
        "scores": bool(torch.equal(res.model.score(data, device=dev),
                                   phase5["scores"]))}


def mesh_glmix_phase(torch, dev, data, phase5, hbm):
    """Phase 15 (b): GLMix at full width on phase 5's in-memory data, the
    per-user buckets padded to 4 lanes, on meshes of four shards of the
    one card: 1 x 4 (entity-sharded per-user updates: bit for bit phase
    5's unsharded run, entity by entity); 4 x 1 twice (the fixed effect's
    rows over four shards: the fixed-effect updates' objectives within
    rel 1e-5 of phase 5's and the per-user updates' within 1e-4, the last
    per-user update rerun unsharded from the run's inputs bit for bit
    (:func:`per_user_witness`), the two runs bit for bit, every launch on every shard stream, and the kernel
    against its plain version on shard 0's batch); 2 x 2 with the sharded
    weight update, without and with int8 on the wire. Each run's seconds,
    peak memory and collective bytes; the per-shard byte split; the
    kernel timed at a shard's shape (×64 and the driver's ×65). Returns
    the record, launches by run, the kernel's error and the timing rows."""
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.ops.losses import get_loss
    from photon_ml_tpu_torch.parallel.mesh import (
        make_mesh, pad_rows_to_multiple)

    K = MESH_SHARDS
    t0 = time.perf_counter()
    coords = glmix_coordinates(data, dev, entity_axis_size=K)
    sync(torch, dev)
    build_secs = time.perf_counter() - t0
    runs, launches = {}, {}
    shapes = {"entity_1x4": (1, K), "data_4x1": (K, 1),
              "weight_update_2x2": (2, 2), "weight_update_2x2_int8": (2, 2)}
    knobs = {"entity_1x4": dict(entity_shards=K),
             "data_4x1": dict(),
             "weight_update_2x2": dict(entity_shards=2,
                                       shard_weight_update=True),
             "weight_update_2x2_int8": dict(entity_shards=2,
                                            shard_weight_update=True,
                                            quant="int8")}
    results = {}
    for name, (nd, ne) in shapes.items():
        mesh = make_mesh(num_data=nd, num_entity=ne, devices=[dev] * K)
        for rep in ((0, 1) if name == "data_4x1" else (0,)):
            key = name if rep == 0 else name + "_repeat"
            run_coords = mesh_coordinates(coords, **knobs[name])
            if key == "data_4x1":
                last_update = record_last_update(run_coords, "per-user")
            res, rec = mesh_cd_run(torch, dev, data, run_coords, mesh)
            rec["mesh"] = [nd, ne]
            rec["shard_split"] = shard_split_bytes(coords, nd, ne)
            runs[key] = rec
            launches[f"mesh_{key}"] = rec["launches"]
            results[key] = res
            print(f"phase 15 (b) {key}: " + json.dumps(rec),
                  file=sys.stderr, flush=True)

    eq = equals_phase5(torch, results["entity_1x4"], coords, data, dev,
                       phase5)
    if not all(eq.values()):
        raise AssertionError(f"entity-sharded run != phase 5's: {eq}")
    if runs["entity_1x4"]["shard_real_lanes"] <= 0:
        raise AssertionError("the per-user updates never sharded")
    rep_eq = runs_equal(torch, results["data_4x1"],
                        results["data_4x1_repeat"], data, dev)
    if not all_equal(rep_eq):
        raise AssertionError(f"two 4 x 1 runs differ: {rep_eq}")
    witness = per_user_witness(torch, coords, results["data_4x1"],
                               last_update, phase5)
    print("phase 15 (b) per-user witness: " + json.dumps(witness),
          file=sys.stderr, flush=True)
    if not (witness["rerun_equals_run"] and witness["run_state_is_model"]):
        raise AssertionError(f"4 x 1 per-user witness: {witness}")
    del last_update
    rel = {k: rel_by_coordinate(results[k], phase5["objectives"])
           for k in shapes}
    for k in ("data_4x1", "weight_update_2x2"):
        if not (rel[k]["fixed"] <= SHARDED_FE_RTOL
                and rel[k]["per-user"] <= SHARDED_RE_RTOL):
            raise AssertionError(f"{k}: objectives off by rel {rel[k]}")
    if not max(rel["weight_update_2x2_int8"].values()) \
            <= INT8_OBJECTIVE_RTOL:
        raise AssertionError(f"int8 objectives off by rel "
                             f"{rel['weight_update_2x2_int8']}")
    by_shard = runs["data_4x1"]["launches_by_shard"]
    total = sum(runs["data_4x1"]["launches"]["by_path"].values())
    if dev.type == "cuda" and (sorted(by_shard) != list(range(K))
                               or len(set(by_shard.values())) != 1
                               or sum(by_shard.values()) != total):
        raise AssertionError(f"launches by shard {by_shard} of {total}")
    check_launches("mesh 4x1", runs["data_4x1"]["launches"], "stream",
                   "logistic", dev)
    int8_bytes = runs["weight_update_2x2_int8"]["collective_bytes_by_mode"]
    if not int8_bytes.get("int8", 0) > 0:
        raise AssertionError(f"no int8 bytes: {int8_bytes}")

    # the kernel on shard 0's rows of the final 4 x 1 fixed-effect batch
    res = results["data_4x1"]
    batch = coords["fixed"].dataset.with_offsets(coords["per-user"].score(
        res.model.models["per-user"].coefficients_projected))
    n = int(batch.X.shape[0])
    rows = pad_rows_to_multiple(n, K) // K
    w_fe = res.model.models["fixed"].model.coefficients.means.contiguous()
    err, worst = check_sums(
        torch, get_loss("logistic"), batch.X[:rows].contiguous(),
        batch.labels[:rows].contiguous(), batch.offsets[:rows].contiguous(),
        batch.weights[:rows].contiguous(), w_fe,
        torch.zeros((), device=dev), scaled=True)
    shard_path = pk.kernel_path(int(batch.X.shape[1]), batch.X.dtype, True)
    del batch, coords, results, res
    torch.cuda.empty_cache()

    # the kernel timed at a shard's shape: glmix's ×64 (stream) and the
    # driver's ×65 (staged) over four shards
    timing_rows = []
    for d in (64, 65):
        X, y, off, wt, w = kernel_inputs(torch, rows, d, seed=15,
                                         device=dev)
        for row in time_kernel(torch, hbm, get_loss("logistic"), X, y, off,
                               wt, w, torch.tensor(0.0, device=dev)
                               ).values():
            timing_rows.append(row)
            emit({"phase": "timing", "per_shard_of": K, **row})
        del X, y, off, wt, w
    torch.cuda.empty_cache()
    return {"build_secs": build_secs, "runs": runs,
            "entity_1x4_equals_phase5": eq, "data_4x1_repeat_equal": rep_eq,
            "objectives_rel_to_phase5": rel,
            "data_4x1_per_user_witness": witness,
            "rtol": {"fixed": SHARDED_FE_RTOL, "per-user": SHARDED_RE_RTOL,
                     "int8": INT8_OBJECTIVE_RTOL},
            "shard_batch_kernel": {"rows": rows, "path": shard_path,
                                   "max_abs_err": err,
                                   "worst_delta_over_tolerance": worst}}, \
        launches, err, timing_rows


def mesh_driver_phase(torch, dev, drill_fixture, plain, workdir):
    """Phase 15 (c): the training driver's console entry point (``main``,
    in this process) on the drill's fixture with ``--re-entity-shards auto
    --collective-quant int8``, traced: exit 0, where the flags used to
    exit 3. On one card the mesh grants one entity shard (the manifest and
    the gauge say 1), and the model equals, record for record, phase
    13 (b)'s f32 run with the same argv without the two flags
    (``plain``)."""
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.tools.crash_resume_drill import driver_argv

    train, val = drill_fixture
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    mesh_out = os.path.join(workdir, "mesh")
    trace = os.path.join(workdir, "trace")
    reset_counts(torch, dev)
    t0 = time.perf_counter()
    argv = driver_argv(train, val, mesh_out, str(dev), extra=[
        "--re-entity-shards", "auto", "--collective-quant", "int8",
        "--trace-dir", trace])
    try:
        ttd.main(argv)
        code = 0
    except SystemExit as e:  # clean_abort's exit 3 for a refused flag
        code = e.code
    mesh_secs = time.perf_counter() - t0
    if code != 0:
        raise AssertionError(f"the mesh driver run exited {code}")
    manifest = json.load(open(os.path.join(trace, "run_manifest.json")))
    granted = manifest["flags"]["re_entity_shards"]
    gauges = [r["value"] for r in map(json.loads, open(os.path.join(
        trace, "metrics.jsonl"))) if r.get("name") == "re_entity_shards"]
    gauge = gauges[-1] if gauges else None
    same = model_records(plain) == model_records(mesh_out)
    if granted != 1 or gauge != 1 or not same:
        raise AssertionError(f"mesh driver run: granted {granted}, gauge "
                             f"{gauge}, models equal {same}")
    launches = launch_counts()
    return {"exit_code": code, "granted_entity_shards": granted,
            "re_entity_shards_gauge": gauge, "models_equal": same,
            "mesh_secs": mesh_secs,
            "launches_by_path": launches["by_path"]}, launches


def mesh_phase(torch, dev, smi, data, phase5, drill_fixture, drill_f32,
               workdir, hbm):
    """Phase 15: (a) the multi-device gate on four shards of the card,
    (b) GLMix on meshes (``mesh_glmix_phase``), (c) the driver with the
    mesh's flags (``mesh_driver_phase``). What one card cannot show:
    copies between cards, shards overlapping on several cards, and the
    launch on a card that is not the current one (PERF.md §7)."""
    from photon_ml_tpu_torch.parallel.multichip_check import (
        check_game_step_multichip)

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check_game_step_multichip(MESH_SHARDS, devices=[dev] * MESH_SHARDS,
                                  parity_summary=True)
    gate_line = buf.getvalue().strip().splitlines()[-1]
    print(gate_line, flush=True)
    platform = "gpu" if dev.type == "cuda" else "cpu"
    if not gate_line.startswith(f"multichip ok: platform={platform} "):
        raise AssertionError(f"gate line: {gate_line}")
    gate_secs = time.perf_counter() - t0
    t1 = time.perf_counter()
    glmix, launches, err, timing_rows = mesh_glmix_phase(
        torch, dev, data, phase5, hbm)
    glmix["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    driver, launches["mesh_driver"] = mesh_driver_phase(
        torch, dev, drill_fixture, drill_f32, workdir)
    driver["seconds"] = time.perf_counter() - t1
    return {"phase": "mesh", "nvidia_smi": smi,
            "a_gate": {"line": gate_line, "seconds": gate_secs},
            "b_glmix": glmix, "c_driver": driver,
            "seconds": time.perf_counter() - t0}, launches, err, timing_rows


# -- phase 16: the process gang ---------------------------------------------

#: phase 16 (c): the drill's rows (``DRILL_ROWS``) written as part files,
#: so that each of two members reads a round-robin share of them
GANG_DRILL_PARTS = (4, 1)
#: phase 16 (b): the gang's coefficients against phase 6's single-process
#: final state, max |gap| over max |phase 6| per coordinate, and its
#: objective's relative gap: about twice what the card gave (NVIDIA H100
#: 80GB HBM3, 700.00 W: 3.58e-2, 8.70e-3, 1.43, 7.11e-3). The gang groups
#: the rows by process, so each of the 369 users past the active cap of
#: 128 keeps another reservoir sample of its rows, and the fixed effect
#: moves with their scores; the 5,671 users within the cap keep all their
#: rows and are held tighter.
GANG_BOUNDS = {"fixed": 7.5e-2, "per_user_within_cap": 2e-2,
               "per_user_all": 3.0, "objective": 1.5e-2}

#: phase 16 (a): one member of the witness. argv: repo, workdir, process
#: id, port, the fixed effect's configuration, shards per process, device
GANG_WITNESS_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from photon_ml_tpu_torch.data.batch import DenseBatch
from photon_ml_tpu_torch.ops import pallas_kernels as pk
from photon_ml_tpu_torch.optimize.config import (
    GLMOptimizationConfiguration, TaskType)
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.parallel import multihost as mh
from photon_ml_tpu_torch.parallel.collectives import (
    PROCESS_GROUP_STATS, reset_process_group_stats)
from photon_ml_tpu_torch.parallel.distributed import run_glm_shard_map
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
workdir, pid, port = sys.argv[2], int(sys.argv[3]), sys.argv[4]
cfg, shards = sys.argv[5], int(sys.argv[6])
torch.backends.cuda.matmul.allow_tf32 = False
dev = mh.gang_device(sys.argv[7], pid)
cols = {k: np.load(f"{workdir}/{k}.npy", mmap_mode="r")
        for k in ("X", "labels", "offsets", "weights")}
half = cols["labels"].shape[0] // 2
mine = slice(pid * half, (pid + 1) * half)
batch = DenseBatch(**{k: torch.from_numpy(np.ascontiguousarray(v[mine]))
                      .to(dev) for k, v in cols.items()})
span = mh._distributed_initialize(f"127.0.0.1:{port}", 2, pid,
                                  initialization_timeout=120,
                                  heartbeat_timeout=120)
try:
    mesh = make_mesh(num_data=shards, devices=[dev] * shards, span=span,
                     span_axis=DATA_AXIS)
    problem = GLMOptimizationProblem(
        config=GLMOptimizationConfiguration.parse(cfg),
        task=TaskType.LOGISTIC_REGRESSION)
    pk.reset_launch_count()
    reset_process_group_stats()
    t = time.perf_counter()
    model, result = run_glm_shard_map(problem, batch, mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    np.save(f"{workdir}/w{pid}.npy", model.coefficients.means.cpu().numpy())
    k = pk.fused_value_gradient_sums
    print("GANG_WITNESS " + json.dumps({
        "process": pid, "fit_secs": secs, "objective": float(result.value),
        "iterations": int(result.iterations),
        "launches": pk.launch_count(),
        "launches_by_path": dict(k.launches_by_path),
        "launches_by_loss": dict(k.launches_by_loss),
        "launches_by_shard": {str(s): n
                              for s, n in k.launches_by_shard.items()},
        "process_group": dict(PROCESS_GROUP_STATS)}), flush=True)
finally:
    mh._distributed_shutdown()
"""

#: phase 16 (b): one member of the training driver's gang, reporting its
#: launches, traffic and seconds. argv: repo, raw-coefficients file, the
#: driver's argv
GANG_DRIVER_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.io.data_format import INGEST_STATS
from photon_ml_tpu_torch.ops import pallas_kernels as pk
from photon_ml_tpu_torch.parallel.collectives import PROCESS_GROUP_STATS
torch.backends.cuda.matmul.allow_tf32 = False
pk.reset_launch_count()
t = time.perf_counter()
driver = ttd.run(sys.argv[3:])
cuda = driver.device.type == "cuda"
if cuda:
    torch.cuda.synchronize()
wall = time.perf_counter() - t
res = driver.multihost_result
raw = res["random_effect_raw"]["perUser"]
ids = sorted(raw)
np.savez(sys.argv[2], fixed=res["fixed"]["fixed"], ids=np.asarray(ids),
         per_user=np.stack([raw[i] for i in ids]))
k = pk.fused_value_gradient_sums
print("GANG_MEMBER " + json.dumps({
    "wall_secs": wall, "phase_seconds": driver.phase_seconds,
    "launches": pk.launch_count(),
    "launches_by_path": dict(k.launches_by_path),
    "launches_by_loss": dict(k.launches_by_loss),
    "process_group": dict(PROCESS_GROUP_STATS),
    "ingest_parts": dict(INGEST_STATS),
    "max_memory_allocated": (torch.cuda.max_memory_allocated() if cuda
                             else None)}), flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_gang(argvs, workdir, name):
    """One child per argv (``python`` + argv, from the repository root),
    stdout piped, stderr to ``<workdir>/<name>.p<i>.stderr``."""
    procs = []
    for i, argv in enumerate(argvs):
        err = open(os.path.join(workdir, f"{name}.p{i}.stderr"), "w")
        procs.append(subprocess.Popen([sys.executable, *argv], cwd=REPO,
                                      text=True, stdout=subprocess.PIPE,
                                      stderr=err))
        err.close()
    return procs


def finish_gang(procs, workdir, name, timeout=600.0) -> list:
    """Wait for every child (killing all of them on a timeout or error);
    returns ``[(exit code, stdout, stderr)]``."""
    outs = []
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            with open(os.path.join(workdir, f"{name}.p{i}.stderr")) as f:
                outs.append((p.returncode, out, f.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_gang(argvs, workdir, name, timeout=600.0, ok=True) -> list:
    outs = finish_gang(start_gang(argvs, workdir, name), workdir, name,
                       timeout)
    for i, (rc, out, err) in enumerate(outs):
        if ok and rc != 0:
            raise AssertionError(f"{name} member {i} exited {rc}:\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
    return outs


def tagged(out: str, tag: str) -> dict:
    (line,) = [x for x in out.splitlines() if x.startswith(tag + " ")]
    return json.loads(line[len(tag) + 1:])


def gang_argv(train, out, feature_sets, device, *extra) -> list:
    """Phase 6's training argv (``driver_argv``) for a gang member: no
    validation or evaluators (the multi-process driver refuses both, as
    the JAX one does) and no model directories."""
    from photon_ml_tpu_torch.tools.crash_resume_drill import driver_argv

    argv = driver_argv(train, "", out, device, extra=[
        "--feature-name-and-term-set-path", feature_sets,
        "--model-output-mode", "NONE", *extra])
    for flag in ("--validate-input-dirs", "--evaluator-type"):
        i = argv.index(flag)
        del argv[i:i + 2]
    return argv


def children_of(pid: int) -> list:
    """The pids whose parent is ``pid`` (read from ``/proc``)."""
    kids = []
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                kids.append(int(name))
    return kids


def gang_witness_phase(torch, dev, data, workdir):
    """Phase 16 (a): 2 processes x 2 shards of the card fit phase 5's
    fixed effect, each feeding its half of the padded rows, and must
    equal 1 process x 4 shards over the same row layout bit for bit."""
    from photon_ml_tpu_torch.data.batch import pad_batch
    from photon_ml_tpu_torch.game.dataset import build_fixed_effect_dataset
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration, TaskType)
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.parallel.distributed import run_glm_shard_map
    from photon_ml_tpu_torch.parallel.mesh import (make_mesh,
                                                   pad_rows_to_multiple)
    from photon_ml_tpu_torch.tools.glmix_cases import GLMIX_CASES

    t0 = time.perf_counter()
    cfg = GLMIX_CASES["lbfgs"].fixed
    batch = build_fixed_effect_dataset(data, "global", device=dev).batch
    n = int(batch.labels.shape[0])
    # the padded rows split into two halves of two shards each: the
    # layout of 1 x 4 (``run_glm_shard_map`` pads to 4 shards alike)
    batch = pad_batch(batch, pad_rows_to_multiple(n, MESH_SHARDS))
    for k in ("X", "labels", "offsets", "weights"):
        np.save(os.path.join(workdir, f"{k}.npy"),
                getattr(batch, k).cpu().numpy())
    port = free_port()
    outs = run_gang([["-c", GANG_WITNESS_CHILD, REPO, workdir, str(i),
                      str(port), cfg, str(MESH_SHARDS // 2), str(dev)]
                     for i in range(2)], workdir, "witness", timeout=300)
    members = [tagged(o, "GANG_WITNESS") for _, o, _ in outs]
    problem = GLMOptimizationProblem(
        config=GLMOptimizationConfiguration.parse(cfg),
        task=TaskType.LOGISTIC_REGRESSION)
    pk.reset_launch_count()
    model, result = run_glm_shard_map(
        problem, batch, make_mesh(num_data=MESH_SHARDS,
                                  devices=[dev] * MESH_SHARDS))
    single_launches = pk.launch_count()
    w = model.coefficients.means.cpu().numpy()
    for i, m in enumerate(members):
        wi = np.load(os.path.join(workdir, f"w{i}.npy"))
        if not (np.array_equal(wi, w) and m["objective"] == result.value):
            raise AssertionError(
                f"2 x 2 member {i} differs from 1 x 4: max |dw| "
                f"{float(np.abs(wi - w).max()):.3g}, objective "
                f"{m['objective']} vs {result.value}")
        if dev.type == "cuda" and (m["launches"] <= 0 or set(
                m["launches_by_shard"]) != {str(2 * i), str(2 * i + 1)}):
            raise AssertionError(f"member {i} did not launch the kernel on "
                                 f"its shards: {m}")
    print(f"phase 16 (a): 2 x 2 = 1 x 4 bit for bit; launches per process "
          f"{[m['launches'] for m in members]} (1 x 4: {single_launches}); "
          f"bytes sent through the process group "
          f"{[m['process_group']['bytes_sent'] for m in members]}",
          file=sys.stderr, flush=True)
    return {"rows": n, "padded_rows": int(batch.labels.shape[0]),
            "shards_per_process": MESH_SHARDS // 2, "bit_equal": True,
            "objective": float(result.value),
            "iterations": int(result.iterations),
            "members": members, "single_process_launches": single_launches,
            "seconds": time.perf_counter() - t0}, members


def gang_driver_phase(torch, dev, fixture, driver_dir, workdir,
                      rows=DRIVER_ROWS, n_users=6040):
    """Phase 16 (b): two members of the training driver on phase 6's
    fixture and feature sets, held to phase 6's final state within
    ``GANG_BOUNDS``; then the scoring driver split over two processes,
    equal record for record to phase 6's scoring run."""
    from photon_ml_tpu_torch.io.data_format import NameAndTermFeatureSets
    from photon_ml_tpu_torch.io.model_io import (load_game_model,
                                                 load_scored_items)
    from photon_ml_tpu_torch.tools.crash_resume_drill import FIXTURE_PARTS

    t0 = time.perf_counter()
    train, val, feature_sets = fixture
    out = os.path.join(workdir, "train_out")
    port = free_port()
    argv = gang_argv(train, out, feature_sets, str(dev))
    outs = run_gang([["-c", GANG_DRIVER_CHILD, REPO,
                      os.path.join(workdir, f"raw.p{i}.npz"), *argv,
                      "--num-processes", "2", "--process-id", str(i),
                      "--coordinator", f"127.0.0.1:{port}"]
                     for i in range(2)], workdir, "driver", timeout=600)
    members = []
    for i, (_, so, _) in enumerate(outs):
        line = [x for x in so.splitlines()
                if x.startswith("MULTIHOST_GAME_OK")]
        if len(line) != 1 or f"process={i} of=2 devices=2 re_entity_axis=2 " \
                not in line[0]:
            raise AssertionError(f"member {i}: no MULTIHOST_GAME_OK line "
                                 f"with devices=2 re_entity_axis=2:\n{so}")
        m = tagged(so, "GANG_MEMBER")
        m["line"] = line[0]
        members.append(m)
        if dev.type == "cuda" and (m["launches"] <= 0 or m[
                "launches_by_path"]["staged"] != m["launches"]):
            raise AssertionError(f"member {i} did not launch the kernel "
                                 f"on the staged path: {m}")
        if m["ingest_parts"] != {"native_parts": FIXTURE_PARTS[0] // 2,
                                 "declined_parts": 0, "records_parts": 0}:
            raise AssertionError(f"member {i} left the native ingest: "
                                 f"{m['ingest_parts']}")
    npz = [dict(np.load(os.path.join(out, f"multihost_result.p{i}.npz")))
           for i in range(2)]
    if sorted(npz[0]) != sorted(npz[1]) or not all(
            np.array_equal(npz[0][k], npz[1][k]) for k in npz[0]):
        raise AssertionError("the members' npz files differ")
    raw = [dict(np.load(os.path.join(workdir, f"raw.p{i}.npz")))
           for i in range(2)]
    if not all(np.array_equal(raw[0][k], raw[1][k]) for k in raw[0]):
        raise AssertionError("the members' raw coefficients differ")

    # phase 6's final state (output/grid-0) in the feature sets' indices
    sections = dict(x.split(":") for x in DRIVER_SECTIONS.split("|"))
    sets = NameAndTermFeatureSets.load(feature_sets,
                                       sorted(sections.values()))
    maps = {s: sets.index_map([sec], add_intercept=True)
            for s, sec in sections.items()}
    ref, _ = load_game_model(os.path.join(driver_dir, "train_out", "output",
                                          "grid-0"), maps)
    ref_fixed = ref.models["fixed"].model.coefficients.means.cpu().numpy()
    ref_re = ref.models["perUser"]
    ref_ids = [str(x) for x in ref_re.entity_ids]
    ref_coefs = ref_re.coefficients.cpu().numpy()
    order = {k: i for i, k in enumerate(ref_ids)}
    gang_ids = [str(x) for x in raw[0]["ids"]]
    if sorted(gang_ids) != sorted(ref_ids):
        raise AssertionError("the gang's users differ from phase 6's")
    ref_rows = ref_coefs[[order[k] for k in gang_ids]]
    per_user_gap = np.abs(raw[0]["per_user"] - ref_rows).max(axis=1)
    metrics = json.load(open(os.path.join(driver_dir, "train_out",
                                          "metrics.json")))
    ref_obj = metrics["grid"][0]["states"][-1]["objective"]
    counts = rows_per_user(*rows, n_users=n_users)
    within = np.asarray([counts[int(k)] <= 128 for k in gang_ids])
    scale_re = float(np.abs(ref_rows).max())
    gaps = {
        "fixed": float(np.abs(raw[0]["fixed"] - ref_fixed).max()
                       / np.abs(ref_fixed).max()),
        "per_user_within_cap": float(per_user_gap[within].max()
                                     / scale_re),
        "per_user_all": float(per_user_gap.max() / scale_re),
        "objective": abs(float(npz[0]["objective"]) - ref_obj)
        / abs(ref_obj)}
    print(f"phase 16 (b): gaps to phase 6 {gaps} (bounds {GANG_BOUNDS}); "
          f"users within the cap {int(within.sum())} of {len(within)}",
          file=sys.stderr, flush=True)
    for k, v in gaps.items():
        if not v <= GANG_BOUNDS[k]:
            raise AssertionError(f"the gang's {k} gap {v:.3g} to phase 6 "
                                 f"passes its bound {GANG_BOUNDS[k]}")
    train_secs = time.perf_counter() - t0

    # the scoring driver split over two processes, on phase 6's best/
    t1 = time.perf_counter()
    score_out = os.path.join(workdir, "score_out")
    run_gang([["-m", "photon_ml_tpu_torch.cli.game_scoring_driver",
               "--input-data-dirs", val,
               "--game-model-input-dir", os.path.join(driver_dir,
                                                      "train_out", "best"),
               "--output-dir", score_out,
               "--feature-shard-id-to-feature-section-keys-map",
               DRIVER_SECTIONS, "--random-effect-id-set", "userId",
               "--device", str(dev), "--num-processes", "2",
               "--process-id", str(i)]
              for i in range(2)], workdir, "score", timeout=300)
    parts = sorted(os.listdir(os.path.join(score_out, "scores")))
    if parts != ["part-00000.avro", "part-00001.avro"]:
        raise AssertionError(f"scoring parts: {parts}")
    split = [r for p in parts for r in load_scored_items(
        os.path.join(score_out, "scores", p))]
    whole = load_scored_items(os.path.join(driver_dir, "score_out",
                                           "scores", "part-00000.avro"))
    key = (lambda r: r["uid"])
    if sorted(split, key=key) != sorted(whole, key=key):
        raise AssertionError("the split scoring run's records differ from "
                             "phase 6's")
    score_secs = time.perf_counter() - t1
    return {"rows": {"train": rows[0], "validate": rows[1]},
            "members": members, "gaps_to_phase6": gaps,
            "bounds": GANG_BOUNDS,
            "users_within_cap": int(within.sum()), "users": len(within),
            "objective": float(npz[0]["objective"]),
            "phase6_objective": ref_obj,
            "train_gang_secs": train_secs,
            "scoring_records": len(split), "scoring_records_equal": True,
            "scoring_gang_secs": score_secs,
            "seconds": time.perf_counter() - t0}, members


def rows_per_user(n_train, n_val, n_users=6040, seed=7) -> np.ndarray:
    """Training rows of each user of ``write_movielens_avro``'s fixture
    (its first draw): the users past the active cap of 128 are the ones
    whose active rows are a reservoir sample."""
    users = (np.random.default_rng(seed).zipf(1.3, size=n_train + n_val)
             % n_users)[:n_train]
    return np.bincount(users, minlength=n_users)


def published_steps(ckpt) -> list:
    from photon_ml_tpu_torch.utils.checkpoint import CheckpointManager

    return CheckpointManager(ckpt).all_steps() if os.path.isdir(ckpt) \
        else []


def gang_supervision_phase(torch, dev, workdir, rows=DRILL_ROWS,
                           n_users=6040, n_movies=3706, sweeps=2):
    """Phase 16 (c): on the drill's rows as part files, side by side, an
    uninterrupted gang, a fresh gang whose member 1 is SIGTERMed (both
    members must exit 75 at one coordinate) and a supervised gang whose
    member 1 is SIGKILLed after process 0's first snapshot, which must
    re-form, resume and end on the uninterrupted gang's npz bit for
    bit."""
    import signal

    from photon_ml_tpu_torch.io.data_format import NameAndTermFeatureSets
    from photon_ml_tpu_torch.tools.crash_resume_drill import (
        write_movielens_avro)

    t0 = time.perf_counter()
    train, val = (os.path.join(workdir, k) for k in ("train", "validate"))
    write_movielens_avro(train, val, *rows, n_users, n_movies, 64,
                         parts=GANG_DRILL_PARTS)
    sets = os.path.join(workdir, "feature_sets")
    sections = sorted(x.split(":")[1] for x in DRIVER_SECTIONS.split("|"))
    NameAndTermFeatureSets.from_paths([train], sections).save(sets)
    write_secs = time.perf_counter() - t0

    def members(out, *extra):
        port = free_port()
        return [["-m", "photon_ml_tpu_torch.cli.game_training_driver",
                 *gang_argv(train, out, sets, str(dev), "--num-iterations",
                            str(sweeps), *extra),
                 "--num-processes", "2", "--process-id", str(i),
                 "--coordinator", f"127.0.0.1:{port}"] for i in range(2)]

    def npz(out, i):
        return dict(np.load(os.path.join(out, f"multihost_result.p{i}.npz")))

    # the uninterrupted gang, the SIGTERMed one and the supervised one
    # side by side (six processes on the card): one loop sends the
    # SIGTERM once member 1 of the stopped gang has read its parts, and
    # the SIGKILL to the supervised member 1's worker once process 0 has
    # published a snapshot, then waits for the re-formed gang's next one
    t1 = time.perf_counter()
    ref_out, stop_out, sup_out, ckpt = (
        os.path.join(workdir, k)
        for k in ("reference", "stopped", "supervised", "ckpt"))
    gangs = {}
    try:
        gangs["reference"] = start_gang(members(ref_out), workdir,
                                        "reference")
        gangs["stopped"] = start_gang(
            members(stop_out, "--num-iterations", "1000"), workdir,
            "stopped")
        gangs["supervised"] = procs = start_gang(members(
            sup_out, "--max-worker-restarts", "1", "--worker-backoff-base",
            "0.5", "--heartbeat-timeout", "60", "--checkpoint-dir", ckpt,
            "--checkpoint-every-coordinates", "1"), workdir, "supervised")
        log = os.path.join(stop_out, "game-training.p1.log")
        stopped = worker = t_kill = t_first = at_kill = None
        deadline = time.time() + 180
        while time.time() < deadline and (stopped is None or t_kill is None):
            if stopped is None and os.path.exists(log) \
                    and "part file(s)" in open(log).read():
                gangs["stopped"][1].send_signal(signal.SIGTERM)
                stopped = time.perf_counter()
            if t_kill is None:
                if worker is None:
                    kids = children_of(procs[1].pid)
                    worker = kids[0] if kids else None
                if procs[1].poll() is not None:
                    break
                if worker is not None and published_steps(ckpt):
                    os.kill(worker, signal.SIGKILL)
                    t_kill = time.perf_counter()
                    at_kill = max(published_steps(ckpt))
            time.sleep(0.01)
        if stopped is None or t_kill is None:
            raise AssertionError(
                f"no SIGTERM sent ({stopped is None}) or no worker or "
                f"snapshot to kill after (worker {worker}, steps "
                f"{published_steps(ckpt)})")
        while t_first is None and time.time() < deadline + 180:
            if max(published_steps(ckpt), default=-1) > at_kill:
                t_first = time.perf_counter()
            elif all(p.poll() is not None for p in procs):
                break
            time.sleep(0.01)
    except BaseException:
        for name, gang in gangs.items():
            finish_gang(gang, workdir, name, timeout=1)
        raise
    outs = finish_gang(gangs["stopped"], workdir, "stopped", timeout=300)
    ref_outs = finish_gang(gangs["reference"], workdir, "reference",
                           timeout=300)
    sup_outs = finish_gang(procs, workdir, "supervised", timeout=300)
    steps = set()
    for i, (rc, so, err) in enumerate(outs):
        lines = [x for x in err.splitlines()
                 if x.startswith("PHOTON_PREEMPTED")]
        if rc != 75 or len(lines) != 1:
            raise AssertionError(f"stopped member {i} exited {rc}:\n"
                                 f"{err[-3000:]}")
        steps.add(lines[0].split()[1])
    if len(steps) != 1:
        raise AssertionError(f"the members stopped at {steps}")
    sigterm = {"exits": [o[0] for o in outs], "step": steps.pop()}
    for i, (rc, so, err) in enumerate(ref_outs):
        if rc != 0:
            raise AssertionError(f"reference member {i} exited {rc}:\n"
                                 f"{err[-3000:]}")
    ref = npz(ref_out, 0)
    outs = sup_outs
    for i, (rc, so, err) in enumerate(outs):
        if rc != 0 or f"SUPERVISOR_OK worker=p{i} restarts=1" not in so:
            raise AssertionError(f"supervised member {i} exited {rc}:\n"
                                 f"{so[-2000:]}\n{err[-4000:]}")
    resume = [x for x in outs[0][1].splitlines()
              if x.startswith("MULTIHOST_RESUME")]
    if not resume or t_first is None:
        raise AssertionError(f"the re-formed gang did not resume: "
                             f"{outs[0][1][-2000:]}")
    for i in range(2):
        got = npz(sup_out, i)
        if sorted(got) != sorted(ref) or not all(
                np.array_equal(got[k], ref[k]) for k in ref):
            raise AssertionError(f"the resumed gang's member {i} differs "
                                 f"from the uninterrupted gang")
    supervisor_lines = [x for _, so, _ in outs for x in so.splitlines()
                        if x.startswith("SUPERVISOR_OK")]
    print(f"phase 16 (c): {resume[0]}; " + "; ".join(supervisor_lines)
          + f"; kill to the re-formed gang's first update "
          f"{t_first - t_kill:.2f} s; the resumed npz = the uninterrupted "
          f"gang's bit for bit; SIGTERM: both exit 75 at {sigterm['step']}",
          file=sys.stderr, flush=True)
    return {"rows": {"train": rows[0], "validate": rows[1]},
            "parts": list(GANG_DRILL_PARTS), "fixture_write_secs": write_secs,
            "reference_sigterm_supervised_side_by_side": True,
            "reduced": "the supervised gang runs beside the uninterrupted "
                       "and the SIGTERMed gangs, not after them (each "
                       "gang's times include the others' load); PERF.md "
                       "section 4 gives the seconds before and after",
            "supervised": {"resume": resume[0],
                           "supervisor_lines": supervisor_lines,
                           "kill_to_first_update_secs": t_first - t_kill,
                           "killed_after_step": at_kill,
                           "sigterm_to_kill_secs": t_kill - stopped,
                           "bit_equal": True,
                           "seconds": time.perf_counter() - t1},
            "sigterm": sigterm,
            "seconds": time.perf_counter() - t0}


def gang_phase(torch, dev, smi, data, fixture, driver_dir, workdir,
               driver_kw=None, drill_kw=None):
    """Phase 16: the process gang on the card, (a) to (c); ``driver_kw``
    and ``drill_kw`` give (b) and (c) the sizes of a smaller fixture (a
    dry run on the CPU)."""
    t0 = time.perf_counter()
    shutil.rmtree(workdir, ignore_errors=True)
    for k in ("a", "b", "c"):
        os.makedirs(os.path.join(workdir, k))
    witness, witness_members = gang_witness_phase(
        torch, dev, data, os.path.join(workdir, "a"))
    driver, driver_members = gang_driver_phase(
        torch, dev, fixture, driver_dir, os.path.join(workdir, "b"),
        **(driver_kw or {}))
    supervision = gang_supervision_phase(
        torch, dev, os.path.join(workdir, "c"), **(drill_kw or {}))
    launches = {f"gang_witness_p{i}": m for i, m in
                enumerate(witness_members)}
    launches.update({f"gang_driver_p{i}": m for i, m in
                     enumerate(driver_members)})
    return {"phase": "gang", "nvidia_smi": smi, "a_witness": witness,
            "b_drivers": driver, "c_supervision": supervision,
            "seconds": time.perf_counter() - t0}, launches


# -- phase 17: run supervision -------------------------------------------

#: phase 17 (a)'s faults (the shared state dir fires each once across the
#: incarnations): a SIGTERM in the per-user update of sweep 0 (exit 75 at
#: step 1.0) and a hang in the per-user update of sweep 1 (the stall
#: kill), so that every incarnation runs a fixed-effect update before it
#: ends. The drill's kill at update 2.0 is not sent here: it is phase
#: 18's smoke cell ``cd.update=kill`` (resumed bit for bit), cut here for
#: phase 18's time
SUPERVISE_FAULTS = "cd.update@0.1=signal:1;cd.update@1.1=delay:1:300"
#: the update each of the first two incarnations ends in, and where each
#: relaunch resumes
SUPERVISE_FAULT_TAGS = ("0.1", "1.1")
SUPERVISE_RESUMES_AT = ((1, 0), (1, 1))
SUPERVISE_STALL_SECONDS = 8.0
SUPERVISE_FLAGS = ["--max-restarts", "5", "--backoff-base", "0.05",
                   "--backoff-max", "0.2", "--poll-seconds", "0.2",
                   "--grace-seconds", "3", "--startup-grace-seconds", "10"]
#: the supervisor's records of (a), in order
SUPERVISE_ACTIONS = ["launch", "exit", "backoff", "launch", "stall_kill",
                     "escalate_kill", "exit", "backoff", "launch", "done"]
#: phase 17 (b): one client's requests before and after the member's
#: death, of 1 to ``SUPERVISE_FLEET_MAX_ROWS`` records each. They come
#: one at a time, so each reaches a member as a batch of one request
#: (``serve.batch`` is tagged with a batch's request count); the member
#: dies on its first batch of ``SUPERVISE_KILL_BATCH`` requests, which
#: only the waves of ``SUPERVISE_KILL_WAVE`` concurrent requests of one
#: shard's rows in between can form
SUPERVISE_FLEET_REQUESTS, SUPERVISE_FLEET_MAX_ROWS = 20, 64
SUPERVISE_KILL_BATCH, SUPERVISE_KILL_WAVE, SUPERVISE_KILL_ROWS = 2, 3, 32


def supervisor_records(path) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def status_tool(*args) -> tuple:
    """``python -m photon_ml_tpu_torch.tools.photon_status <args> --json``
    as a process: (exit code, status document)."""
    out = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.tools.photon_status",
         *args, "--json"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    try:
        return out.returncode, json.loads(out.stdout)
    except ValueError:
        raise AssertionError(f"photon_status {args}: exit {out.returncode}"
                             f"\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")


def start_supervisor(args, env, log_path) -> subprocess.Popen:
    """``python -m photon_ml_tpu_torch.tools.photon_supervise <args>`` in a
    session of its own (see :func:`stop_supervisor`), its output to
    ``log_path``."""
    log = open(log_path, "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m",
             "photon_ml_tpu_torch.tools.photon_supervise", *args],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
            text=True, start_new_session=True)
    finally:
        log.close()


def stop_supervisor(proc) -> None:
    """SIGKILL to the supervisor's whole process group: its children die
    with it, whatever state a failed check left them in."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def supervised_run_phase(dev, fixture, reference, workdir, started=None):
    """Phase 17 (a): the port's supervisor runs the port's training driver
    (as the drill's ``--worker-updates`` role, which reads the kernel's
    launch count at every ``cd.update`` fault point) on phase 7 (b)'s
    fixture with the drill's argv, ``--checkpoint-dir`` and
    ``--trace-dir``, through ``SUPERVISE_FAULTS``: a preemption (exit 75)
    and a hang that the heartbeat flags (``stall_kill``, then
    ``escalate_kill``). The supervisor must end with
    ``PHOTON_SUPERVISE_OK restarts=2``; the last snapshot and the
    objectives after the last resume equal the drill's uninterrupted
    ``reference`` role bit for bit; every incarnation launches the
    kernel, all on the reference's path; the trace dir keeps the
    ``.prev`` files and two ``run_restart`` records; ``photon_status``
    reads it as finished. The supervisor's ``Popen`` is appended to
    ``started``, so a caller can end it. Returns the record and the
    launches by incarnation."""
    from photon_ml_tpu_torch.tools import crash_resume_drill as drill

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    out, ckpt, trace = (os.path.join(workdir, n)
                        for n in ("out", "ckpt", "trace"))
    argv = drill.driver_argv(*fixture, out, str(dev),
                             num_iterations=drill.SWEEPS) + [
        "--checkpoint-dir", ckpt, "--checkpoint-every-coordinates", "1",
        "--trace-dir", trace, "--trace-heartbeat-seconds", "0.5",
        "--trace-stall-seconds", str(SUPERVISE_STALL_SECONDS)]
    env = {**os.environ, "PHOTON_FAULTS": SUPERVISE_FAULTS,
           "PHOTON_FAULTS_STATE_DIR": os.path.join(workdir, "fault_state"),
           "PHOTON_FAULTS_SEED": "42"}
    log_path = os.path.join(workdir, "supervisor.out")
    t0 = time.perf_counter()
    proc = start_supervisor(
        [*SUPERVISE_FLAGS, "--module",
         "photon_ml_tpu_torch.tools.crash_resume_drill", "--",
         "--worker-updates", *argv], env, log_path)
    if started is not None:
        started.append(proc)
    try:
        rc = proc.wait(timeout=900)
    finally:
        stop_supervisor(proc)
    secs = time.perf_counter() - t0
    with open(log_path) as f:
        stdout = f.read()
    if rc != 0 or "PHOTON_SUPERVISE_OK restarts=2" not in stdout \
            or "PHOTON_PREEMPTED step=1.0 " not in stdout:
        raise AssertionError(f"supervised run: exit {rc}\n{stdout[-6000:]}")
    incarnations = []
    for line in stdout.splitlines():
        if line.startswith("PHOTON_SUPERVISE launch"):
            incarnations.append({"updates": [], "worker": None})
        elif line.startswith(("DRILL_UPDATE ", "DRILL_WORKER ")):
            rec = json.loads(line.split(" ", 1)[1])
            if line.startswith("DRILL_UPDATE "):
                incarnations[-1]["updates"].append(rec)
            else:
                incarnations[-1]["worker"] = rec
    recs = supervisor_records(os.path.join(trace, "supervisor.jsonl"))
    actions = [r["action"] for r in recs]
    if actions != SUPERVISE_ACTIONS:
        raise AssertionError(f"supervisor actions {actions}")
    exits = [(r["rc"], r["preempted"], r["stall_killed"])
             for r in recs if r["action"] == "exit"]
    if exits != [(75, True, False), (-9, False, True)]:
        raise AssertionError(f"supervised exits {exits}")
    tags = [inc["updates"][-1]["tag"] if inc["updates"] else None
            for inc in incarnations]
    if len(incarnations) != 3 or tags[:2] != list(SUPERVISE_FAULT_TAGS):
        raise AssertionError(f"incarnations ended at updates {tags}")
    # every incarnation reached an update and launched the kernel there,
    # every time on the path the reference's fixed effect takes
    launches = {}
    for k, inc in enumerate(incarnations, 1):
        by_path = (inc["worker"] or inc["updates"][-1])["launches_by_path"]
        total = sum(by_path.values())
        if dev.type == "cuda" and (
                total <= 0 or by_path[reference["expected_path"]] != total):
            raise AssertionError(f"incarnation {k}: kernel launches "
                                 f"{by_path}, expected all on "
                                 f"{reference['expected_path']}")
        launches[f"supervised_{k}"] = by_path
    # each relaunch resumed where the last one stopped (the driver's log
    # is appended to by every incarnation)
    with open(os.path.join(out, "game-training.log")) as f:
        log = f.read()
    for sweep, coordinate in SUPERVISE_RESUMES_AT:
        line = (f"resuming from checkpoint at sweep {sweep} coordinate "
                f"{coordinate}")
        if line not in log:
            raise AssertionError(f"supervised run: the log lacks {line!r}")
    drill._check_ends_like_reference(
        "supervised", drill._last_snapshot(ckpt),
        drill._last_snapshot(reference["ckpt"]))
    compared = drill._check_metrics_after_resume(
        "supervised", out, reference["out"], SUPERVISE_RESUMES_AT[-1])
    # the relaunches kept the evidence: .prev files and run_restart marks
    # (trace.json is written at a graceful exit: the preempted
    # incarnation's is rotated, and the killed one wrote none)
    files = set(os.listdir(trace))
    prev = {"trace.json.prev", "spans.jsonl.prev", "run_manifest.json.prev"}
    if not prev <= files:
        raise AssertionError(f"trace dir without {prev - files}")
    marks = []
    with open(os.path.join(trace, "metrics.jsonl")) as f:
        for line in f:
            try:
                m = json.loads(line)
            except ValueError:
                continue  # a line torn by a killed incarnation
            if m.get("kind") == "run_restart":
                marks.append("run_restart")
            elif m.get("kind") == "run_end":
                marks.append(f"run_end:{m['status']}")
    if marks != ["run_end:preempted"] + ["run_restart"] * 2 \
            + ["run_end:ok"]:
        raise AssertionError(f"metrics.jsonl run marks {marks}")
    status_rc, status = status_tool("--run-dir", trace)
    if status_rc != 0 or status["status"] != "finished":
        raise AssertionError(f"photon_status: exit {status_rc}, "
                             f"{status['status']}")
    t = {a: [r["t"] for r in recs if r["action"] == a]
         for a in ("launch", "exit", "done", "stall_kill")}
    ends = t["exit"] + t["done"]
    fault_t = [next(u["t"] for u in inc["updates"] if u["tag"] == tag)
               for inc, tag in zip(incarnations, SUPERVISE_FAULT_TAGS)]
    first_update = [inc["updates"][0]["t"] for inc in incarnations[1:]]
    return {
        "reduced": {"rows": {"train": DRILL_ROWS[0],
                             "validate": DRILL_ROWS[1],
                             "configuration": 1_000_209},
                    "why": "phase 7 (b)'s fixture and its uninterrupted "
                           "reference; the training rows keep the fixed "
                           "effect above the kernel's gate of 2**21 "
                           "elements"},
        "reduced_faults": {
            "left_out": ["cd.update@2.0=kill:1:19"],
            "why": "phase 18's smoke cell cd.update=kill sends the same "
                   "kill at an update and holds the resume to its "
                   "reference bit for bit, and the hang's escalation "
                   "here ends an incarnation with SIGKILL; PERF.md "
                   "section 4 gives the seconds before and after"},
        "faults": SUPERVISE_FAULTS, "supervisor_flags": SUPERVISE_FLAGS,
        "trace_stall_seconds": SUPERVISE_STALL_SECONDS,
        "exits": exits, "restarts": 2,
        "incarnation_wall_secs": [e - s for s, e in zip(t["launch"], ends)],
        "fault_to_first_update_secs": [
            f - k for k, f in zip(fault_t, first_update)],
        "exit_to_first_update_secs": [
            f - e for e, f in zip(t["exit"], first_update)],
        "stall_verdict_secs": t["stall_kill"][0] - fault_t[1],
        "updates_by_incarnation": [[u["tag"] for u in inc["updates"]]
                                   for inc in incarnations],
        "launches_by_incarnation": launches,
        "expected_path": reference["expected_path"],
        "bit_exact_to_reference": True,
        "states_compared_after_resume": compared,
        "run_marks": marks, "status": status["status"],
        "status_exit": status_rc, "seconds": secs,
    }, launches


def supervised_fleet_phase(dev, served, workdir):
    """Phase 17 (b): ``photon_supervise --fleet 2 --router-listen
    --stop-file`` keeps two port services (``--serve-hbm-budget-mb 32``,
    on the card by default) and the router alive, serving phase 6's final
    f32 model as phase 14 does. The members carry
    ``serve.batch@<SUPERVISE_KILL_BATCH>=kill:1:19`` with a shared state
    dir; one client sends ``SUPERVISE_FLEET_REQUESTS`` requests of phase
    13 (c)'s records, then waves of concurrent requests of one shard's
    rows until that shard's member dies (once), waits for the supervisor
    to relaunch the member and the router to re-admit it, and sends as
    many again.
    Every request resolves with scores or a typed shed, and none after
    the re-admission is shed; every score equals the scoring driver's bit
    for bit; both members' tier hits are non-zero (the relaunched one's
    count only what it scored after its re-admission), and the router's
    ``serve_route`` ledger resolves every dispatch; the stop file drains the
    fleet and the supervisor exits 0; ``photon_status --fleet`` lists
    both members and the router, exit 0. The members get no ``--device``
    on the card, where they default to it. Returns the record."""
    import threading

    from photon_ml_tpu_torch.serve.fleet import entity_of_row, entity_shard
    from photon_ml_tpu_torch.serve.protocol import (
        ServeClient, ShardUnavailableError, ShedError, typed_error)

    records, model_dir, ref = (served[k] for k in (
        "records", "model_dir", "driver_scores"))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    fleet_dir = os.path.join(workdir, "fleet")
    stop_file = os.path.join(workdir, "STOP")
    router_ep = "unix:" + os.path.join(workdir, "r.sock")
    member_args = ["--game-model-input-dir", model_dir,
                   "--feature-shard-id-to-feature-section-keys-map",
                   DRIVER_SECTIONS, "--random-effect-id-set", "userId",
                   "--serve-hbm-budget-mb", str(FLEET_HBM_BUDGET_MB),
                   "--trace-heartbeat-seconds", "0.5"]
    if dev.type != "cuda":
        member_args += ["--device", str(dev)]
    env = {**os.environ,
           "PHOTON_FAULTS":
               f"serve.batch@{SUPERVISE_KILL_BATCH}=kill:1:19",
           "PHOTON_FAULTS_STATE_DIR": os.path.join(workdir, "fault_state")}
    kill_shard = 0
    # the router's default key: the first metadataMap id by name
    kill_rows = [r for r in records if entity_shard(
        entity_of_row(r, None), FLEET_MEMBERS) == kill_shard][
        :SUPERVISE_KILL_WAVE * SUPERVISE_KILL_ROWS]
    if len(kill_rows) != SUPERVISE_KILL_WAVE * SUPERVISE_KILL_ROWS:
        raise AssertionError(f"shard {kill_shard} has {len(kill_rows)} "
                             f"records")
    sup_path = os.path.join(fleet_dir, "supervisor.jsonl")
    log_path = os.path.join(workdir, "supervisor.out")
    scored, sheds, failures = [], [], []
    lock = threading.Lock()
    # the router's dispatches: one per shard a request's rows touch
    dispatches = [0]

    def send(client, rows):
        with lock:
            dispatches[0] += len({entity_shard(entity_of_row(r, None),
                                               FLEET_MEMBERS) for r in rows})
        sent = time.perf_counter()
        try:
            resp = client.score(rows)
        except Exception as e:  # noqa: BLE001 — a hung or broken request
            failures.append(repr(e))
            return
        done = time.perf_counter()
        if resp.get("kind") == "scores":
            scored.append((sent, done, resp["uids"], resp["scores"]))
        elif isinstance(typed_error(resp), (ShedError,
                                            ShardUnavailableError)):
            sheds.append((sent, resp["error"]))
        else:
            failures.append(str(resp))

    def requests(client, seed):
        rng = np.random.default_rng(seed)
        for _ in range(SUPERVISE_FLEET_REQUESTS):
            n = int(rng.integers(1, SUPERVISE_FLEET_MAX_ROWS + 1))
            lo = int(rng.integers(0, len(records) - n))
            send(client, records[lo:lo + n])

    def wait_for(what, test, timeout=300.0):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if proc.poll() is not None:
                with open(log_path) as f:
                    raise AssertionError(f"the fleet supervisor exited "
                                         f"{proc.returncode} waiting for "
                                         f"{what}:\n{f.read()[-4000:]}")
            try:
                if test():
                    return time.perf_counter()
            except (OSError, ConnectionError, ValueError, KeyError):
                pass  # not listening yet
            time.sleep(0.1)
        raise AssertionError(f"the fleet never reached {what}")

    def members_healthy(admissions=None):
        members = router_stats(router_ep)["fleet"]["members"]
        return all(m["state"] == "healthy"
                   and m["admissions"] >= (admissions or {}).get(k, 1)
                   for k, m in enumerate(members))

    def died():
        return any(r["action"] == "member_exit"
                   for r in supervisor_records(sup_path))

    def kill_wave():
        def one(rows):
            with ServeClient(router_ep, timeout=120.0) as c:
                send(c, rows)

        threads = [threading.Thread(target=one, args=(kill_rows[
            i * SUPERVISE_KILL_ROWS:(i + 1) * SUPERVISE_KILL_ROWS],))
            for i in range(SUPERVISE_KILL_WAVE)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    os.makedirs(fleet_dir)
    t0 = time.perf_counter()
    proc = start_supervisor(
        ["--fleet", str(FLEET_MEMBERS), "--fleet-dir", fleet_dir,
         "--router-listen", router_ep, "--stop-file", stop_file,
         "--max-restarts", "3", "--backoff-base", "0.2", "--backoff-max",
         "1", "--poll-seconds", "0.1", "--grace-seconds", "30", "--",
         *member_args], env, log_path)
    try:
        ready = wait_for("two healthy members", members_healthy)
        with ServeClient(router_ep, timeout=120.0) as client:
            requests(client, seed=47)
            t_kill = time.perf_counter()
            waves = 0
            while not died():
                if waves == 20:
                    raise AssertionError("20 waves formed no batch of "
                                         f"{SUPERVISE_KILL_BATCH}")
                kill_wave()
                waves += 1
            t_sent = time.perf_counter()

            def relaunched():
                return any(r["action"] == "relaunch_member"
                           for r in supervisor_records(sup_path))

            t_relaunch = wait_for("the member's relaunch", relaunched)
            killed = next(r["member"] for r in supervisor_records(sup_path)
                          if r["action"] == "member_exit")
            t_admitted = wait_for(
                "the member's re-admission",
                lambda: members_healthy({killed: 2, 1 - killed: 1}))
            requests(client, seed=53)
            stats = router_stats(router_ep)
        # each member's tier hits: the relaunched one's count only what it
        # scored after its re-admission
        hits = []
        for k in range(FLEET_MEMBERS):
            with ServeClient(f"unix:{fleet_dir}/member{k}.sock",
                             timeout=60.0) as c:
                hits.append(c.stats()["tier_hits"])
        with open(stop_file, "w"):
            pass
        t_stop = time.perf_counter()
        rc = proc.wait(timeout=300)
        drain_secs = time.perf_counter() - t_stop
    finally:
        stop_supervisor(proc)
    with open(log_path) as f:
        stdout = f.read()
    if rc != 0 or "PHOTON_SUPERVISE_OK" not in stdout:
        raise AssertionError(f"fleet supervisor: exit {rc}\n"
                             f"{stdout[-6000:]}")
    if failures:
        raise AssertionError(f"supervised fleet: {failures[:3]}")
    late = [e for sent, e in sheds if sent >= t_admitted]
    if late:
        raise AssertionError(f"supervised fleet: {len(late)} sheds after "
                             f"the re-admission: {late[:3]}")
    bad = sum(ref[u] != s for _, _, uids, scores in scored
              for u, s in zip(uids, scores))
    if bad:
        raise AssertionError(f"supervised fleet: {bad} scores differ from "
                             f"the scoring driver's")
    if not all(sum(h.values()) for h in hits):
        raise AssertionError(f"a member scored nothing: {hits}")
    route = stats["route"]
    resolved = sum(route.get(k, 0) for k in ("ok", "error", "shed"))
    if resolved != dispatches[0]:
        raise AssertionError(f"serve_route ledger {route} resolves "
                             f"{resolved} of {dispatches[0]} dispatches")
    recs = supervisor_records(sup_path)
    mine = [r["action"] for r in recs if r.get("member") == killed]
    want = ["launch_member", "member_exit", "backoff", "relaunch_member",
            "launch_member"]
    if mine[:5] != want:
        raise AssertionError(f"member {killed}'s records {mine}")
    (death,) = [r for r in recs if r["action"] == "member_exit"
                and r["rc"] != 0]
    if death["rc"] != 19:
        raise AssertionError(f"member {killed} exit {death['rc']}")
    status_rc, status = status_tool("--fleet", "--run-dir", fleet_dir)
    if status_rc != 0 or [r["member"] for r in status["fleet"]] != list(
            range(FLEET_MEMBERS)) or status["router"] is None:
        raise AssertionError(f"photon_status --fleet: exit {status_rc}, "
                             f"{status}")
    return {
        "members": FLEET_MEMBERS,
        "member_hbm_budget_mb": FLEET_HBM_BUDGET_MB,
        "requests": len(scored) + len(sheds), "sheds": len(sheds),
        "shed_reasons": sorted({e for _, e in sheds}),
        "sheds_after_readmission": 0,
        "dispatches": dispatches[0], "serve_route": route,
        "member_tier_hits": hits,
        "rows": sum(len(u) for _, _, u, _ in scored),
        "scores_equal_scoring_driver": True,
        "killed_member": killed, "killed_rc": death["rc"],
        "fleet_ready_secs": ready - t0,
        "kill_waves": waves, "kill_waves_secs": t_sent - t_kill,
        "kill_to_relaunch_secs": t_relaunch - t_kill,
        "relaunch_to_readmitted_secs": t_admitted - t_relaunch,
        "drain_secs": drain_secs,
        "supervisor_actions": [r["action"] for r in recs],
        "fleet_after_readmission": stats["fleet"],
        "status": status["status"], "status_exit": status_rc,
        "status_members": [r["member"] for r in status["fleet"]],
        "seconds": time.perf_counter() - t0,
    }


def corrupt_role_phase(dev, fixture, reference, workdir) -> dict:
    """Phase 17 (c): the crash/resume drill's corrupt role on the card, a
    driver process (the drill's argv and worker role) over a copy of
    phase 7 (b)'s snapshots with every step corrupted: it must refuse
    them cleanly (exit 3, one ``PHOTON_ABORT
    kind=CheckpointCorruptionError``, no traceback) and write no
    metrics."""
    from photon_ml_tpu_torch.tools import crash_resume_drill as drill

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    out, ckpt = (os.path.join(workdir, n) for n in ("out", "ckpt"))
    steps = drill.corrupt_copy(reference["ckpt"], ckpt)
    run = drill.run_roles({"corrupt": (drill.role_argv(
        os.path.dirname(fixture[0]), out, ckpt, str(dev)), "")},
        timeout=600)["corrupt"]
    drill.check_clean_abort(run)
    if os.path.exists(os.path.join(out, "metrics.json")):
        raise AssertionError("corrupt role: it wrote metrics.json")
    return {"exit": run["exit"], "corrupted_steps": steps,
            "abort": [ln for ln in run["stderr"].splitlines()
                      if ln.startswith("PHOTON_ABORT")],
            "wall_secs": run["wall_secs"]}


def supervise_phase(torch, dev, smi, fixture, reference, served, workdir):
    """Phase 17: (a) a supervised training run through a preemption and a
    stall kill, and beside it (b) the fleet under the supervisor and (c)
    the drill's corrupt role: they share nothing but the card and the
    host, so the phase takes about (a)'s seconds, and each part's times
    include the others' load. Returns the phase record and (a)'s
    launches by incarnation."""
    t0 = time.perf_counter()
    started = []
    pool = concurrent.futures.ThreadPoolExecutor(2)
    run_job = pool.submit(supervised_run_phase, dev, fixture, reference,
                          os.path.join(workdir, "run"), started)
    corrupt_job = pool.submit(corrupt_role_phase, dev, fixture, reference,
                              os.path.join(workdir, "corrupt"))
    try:
        fleet = supervised_fleet_phase(dev, served,
                                       os.path.join(workdir, "fleet"))
    except BaseException:
        for proc in started:  # (b) failed: (a) need not run on
            stop_supervisor(proc)
        raise
    finally:
        pool.shutdown(wait=True)
    run, launches = run_job.result()
    corrupt = corrupt_job.result()
    shutil.rmtree(workdir, ignore_errors=True)
    return {"phase": "supervise", "nvidia_smi": smi, "a_run": run,
            "b_fleet": fleet, "c_corrupt": corrupt,
            "a_b_c_side_by_side": True,
            "seconds": time.perf_counter() - t0}, launches


# -- phase 18: the chaos campaign ------------------------------------------

#: the smoke cells' outcomes that ``tests/test_chaos_drill.py`` asserts
#: (a value ending in "(" is a prefix)
CHAOS_OUTCOMES = {
    "io.avro_read=corrupt": "degraded(",
    "scenario.corrupt_shard": "degraded(",
    "cd.update=kill": "killed+resumed",
    "cd.update=signal@per_update": "preempted+resumed",
    "io.index_map=io_error": "clean_abort",
    "obs.flush=io_error": "ok",
    "obs.export=io_error": "ok+dropped(",
}
#: what the OTLP bridge's document of phase 6's traced training run holds
CHAOS_BRIDGE_SPANS = ("cd.sweep", "cd.update")


def chaos_bridge(train_trace, workdir) -> dict:
    """Phase 18 (b): the port's OTLP bridge as a process over phase 6's
    traced training run (``--run-dir … --out``): exit 0, the
    ``cd.sweep`` and ``cd.update`` spans in the document, and the
    ``photon.telemetry_proto`` attribute on every resource."""
    out = os.path.join(workdir, "phase6_otlp.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.tools.otlp_bridge",
         "--run-dir", train_trace, "--out", out], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"otlp_bridge over phase 6's trace: exit "
                             f"{proc.returncode}\n{proc.stderr[-3000:]}")
    with open(out) as f:
        docs = json.load(f)
    resources = [r["resource"] for r in docs["traces"]["resourceSpans"]
                 + docs["metrics"]["resourceMetrics"]]
    protos = {a["value"].get("intValue") for res in resources
              for a in res["attributes"]
              if a["key"] == "photon.telemetry_proto"}
    spans = collections.Counter(
        s["name"] for rs in docs["traces"]["resourceSpans"]
        for ss in rs["scopeSpans"] for s in ss["spans"])
    metrics = sum(len(sm["metrics"])
                  for rm in docs["metrics"]["resourceMetrics"]
                  for sm in rm["scopeMetrics"])
    if not resources or len(protos) != 1 or None in protos or any(
            not any(a["key"] == "photon.telemetry_proto"
                    for a in res["attributes"]) for res in resources):
        raise AssertionError(f"otlp_bridge: photon.telemetry_proto "
                             f"missing from a resource: {resources}")
    missing = [n for n in CHAOS_BRIDGE_SPANS if not spans[n]]
    if missing:
        raise AssertionError(f"otlp_bridge: no {missing} span in "
                             f"{sorted(spans)}")
    return {"exit": proc.returncode, "stderr": proc.stderr.strip(),
            "telemetry_proto": protos.pop(), "spans": sum(spans.values()),
            "spans_by_name": {n: spans[n] for n in CHAOS_BRIDGE_SPANS},
            "metrics": metrics, "document_bytes": os.path.getsize(out),
            "seconds": secs}


def chaos_campaign(workdir) -> dict:
    """Phase 18 (a): the port's chaos campaign's smoke subset on the card
    (``photon_ml_tpu_torch/tools/chaos_drill.py``, every child with
    ``--device cuda``): the fault-free reference, the 11 smoke cells and
    ``scenario.corrupt_shard``, each through the tool's own ``run_cell``
    in a pool, side by side, in a directory of its own. The serving
    fixture (a model and its reference scores on the card) is built
    before the pool starts; the cells that read no reference objective
    (the serve cells and the scenario) start at once, the others when the
    reference is done (all of them at once with the reference took 60.5
    s against 48.8-51.4 s: 8 cores, some 25 process starts). The report
    is the tool's, in the tool's order; every cell must pass, with the
    outcomes ``tests/test_chaos_drill.py`` asserts. The campaign's lines
    go to stderr."""
    from photon_ml_tpu_torch.tools import chaos_drill as chaos

    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        chaos.check_device("cuda")
        cells, skipped = chaos.plan_cells(True, None, "cuda")
        fixture = chaos.build_fixture(workdir)
        chaos.build_serve_fixture(workdir, "cuda")
        fixture_secs = time.perf_counter() - t0
        with concurrent.futures.ThreadPoolExecutor(len(cells) + 1) as pool:
            jobs = {id(c): pool.submit(chaos.run_cell, c, fixture, workdir,
                                       None, "cuda")
                    for c in cells if c["serve"]}
            scenario = pool.submit(chaos.run_corrupt_shard_scenario,
                                   fixture, workdir, "cuda")
            t1 = time.perf_counter()
            reference = chaos.run_reference(fixture, workdir, "cuda")
            reference_secs = time.perf_counter() - t1
            jobs.update({id(c): pool.submit(chaos.run_cell, c, fixture,
                                            workdir, reference, "cuda")
                         for c in cells if not c["serve"]})
            results = [jobs[id(c)].result() for c in cells]
            results.append(scenario.result())
        for r in results:
            chaos.print_result(r)
        report_path = os.path.join(workdir, "chaos_report.json")
        rc = chaos.write_report(results, skipped, True, reference,
                                report_path)
    with open(report_path) as f:
        report = json.load(f)
    by_name = {r["cell"]: r for r in report["cells"]}
    wrong = {n: by_name[n]["outcome"] for n, want in CHAOS_OUTCOMES.items()
             if not (by_name[n]["outcome"] == want or (
                 want.endswith("(")
                 and by_name[n]["outcome"].startswith(want)))}
    if rc != 0 or report["cells_failed"] != 0 or wrong:
        raise AssertionError(
            f"chaos smoke campaign on the card: exit {rc}, "
            f"{report['cells_failed']} failed, outcomes {wrong}\n"
            + "\n".join(f"{r['cell']}: {r['failures']}"
                        for r in report["cells"] if not r["passed"]))
    return {
        "reduced": {
            "fixture": "the JAX campaign's own: 4 Avro shards of 40 rows, "
                       "4 global features (5 columns with the intercept) "
                       "and a per-user shard of 2 over 5 users",
            "kernel": "4 x 40 rows x 5 columns is under the fused "
                      "kernel's gate (MIN_PALLAS_ELEMENTS, 2**21 "
                      "elements), so no cell launches it; the card holds "
                      "the port's state through every fault: snapshots "
                      "fetched from it and restored onto it, the "
                      "service's device tiers, the fleet"},
        "reference_objective": reference,
        "fixture_secs": fixture_secs, "reference_secs": reference_secs,
        "cells_run": report["cells_run"],
        "cells_failed": report["cells_failed"],
        "cells": [{k: r.get(k) for k in ("cell", "outcome", "rc",
                                         "seconds")}
                  for r in report["cells"]],
        "side_by_side": len(cells) + 1,
        "seconds": time.perf_counter() - t0}


def chaos_phase(smi, train_trace, workdir) -> dict:
    """Phase 18: (a) the chaos campaign's smoke subset on the card, (b) the
    OTLP bridge over phase 6's traced training run."""
    t0 = time.perf_counter()
    campaign = chaos_campaign(workdir)
    bridge = chaos_bridge(train_trace, workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    return {"phase": "chaos", "nvidia_smi": smi, "a_campaign": campaign,
            "b_bridge": bridge, "seconds": time.perf_counter() - t0}


def main() -> int:
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the GPU")
    if not os.path.isdir(os.path.join(REPO, "photon_ml_tpu_torch", "csrc")):
        fail("run from a checkout of the repository (photon_ml_tpu_torch/ "
             "not found beside this script)")
    sys.path.insert(0, REPO)

    from photon_ml_tpu_torch.game.coordinate_descent import (
        HOT_LOOP_STATS, reset_hot_loop_stats, run_coordinate_descent)
    from photon_ml_tpu_torch.ops import kernels_build
    from photon_ml_tpu_torch.ops import pallas_kernels as pk
    from photon_ml_tpu_torch.ops.losses import LOSSES, get_loss
    from photon_ml_tpu_torch.optimize import common as opt_common
    from photon_ml_tpu_torch.optimize.config import TaskType

    dev = torch.device("cuda", 0)

    # -- 1. device ---------------------------------------------------------
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    hbm = HBM_BYTES_PER_S["pcie" if "pcie" in name.lower() else "sxm"]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "hbm_bytes_per_s": hbm,
          "seconds": time.perf_counter() - t0})

    # the Avro fixtures of phases 6 and 7 (b) are written beside phases 2
    # and 3 (CPU-bound writers next to nvcc and a GPU-bound check) and
    # joined before phase 4 times the kernel: a cut of wall time, not of
    # depth (PERF.md §4)
    build = os.path.join(REPO, "photon_ml_tpu_torch", "_build")
    driver_dir = os.path.join(build, "driver_phase")
    writers = concurrent.futures.ThreadPoolExecutor(2)
    driver_write = writers.submit(write_driver_fixture, driver_dir)
    drill_write = writers.submit(write_drill_fixture,
                                 os.path.join(build, "drill"))

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    kernels_build.build_all()
    for kname, info in kernels_build.BUILD_INFO.items():
        print(f"[{kname}] {info['log']}", file=sys.stderr, flush=True)
    emit({"phase": "build",
          "kernels": {k: v["seconds"]
                      for k, v in kernels_build.BUILD_INFO.items()},
          "seconds": time.perf_counter() - t0})

    # -- 3. kernel against its plain version ---------------------------------
    t0 = time.perf_counter()
    worst_all = 0.0
    cases = {"stream": 0, "staged": 0}
    autograd_paths = set()
    for si, ((n, d), scaled) in enumerate(CHECK_SHAPES):
        X, y, off, wt, w = kernel_inputs(torch, n, d, seed=si, device=dev)
        shift = torch.tensor(0.31, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            Xc = X.to(dtype)
            paths = paths_for(Xc)
            for path in paths:
                # the wrapper on the path it picks, _launch on the other
                named = None if path == paths[0] else path
                for lname in sorted(LOSSES):
                    _, worst = check_sums(torch, get_loss(lname), Xc, y,
                                          off, wt, w, shift, scaled, named)
                    worst_all = max(worst_all, worst)
                    cases[path] += 1
            del Xc
        if not scaled:
            # autograd through the autograd.Function equals vector_sum, on
            # the path the wrapper picks for this shape
            wg = w.clone().requires_grad_(True)
            loss = get_loss("logistic")
            val, vec, _ = pk.fused_value_gradient_sums(loss, X, y, off, wt,
                                                       wg, shift, device=dev)
            (grad,) = torch.autograd.grad(val, wg)
            torch.cuda.synchronize()
            if not torch.allclose(grad, vec, rtol=2e-4, atol=2e-4):
                raise AssertionError("autograd gradient != vector_sum")
            autograd_paths.add(paths_for(X)[0])
        if d % 4:
            # the stream path refuses a row that is not whole vectors
            try:
                pk._launch(get_loss("logistic"), X, y, off, wt, w, shift,
                           path="stream")
            except RuntimeError:
                pass
            else:
                raise AssertionError(f"stream path took d={d}")
        del X, y, off, wt, w
        torch.cuda.empty_cache()
    if autograd_paths != set(cases):
        raise AssertionError(f"autograd checked on {autograd_paths} only")
    emit({"phase": "kernel", "name": "fused_value_gradient_sums",
          "cases": sum(cases.values()), "cases_by_path": cases,
          "worst_delta_over_tolerance": worst_all,
          "deterministic": True, "autograd_paths": sorted(autograd_paths),
          "stream_refuses_partial_vector_rows": True,
          "seconds": time.perf_counter() - t0})

    driver_write_secs = driver_write.result()
    drill_write_secs = drill_write.result()
    writers.shutdown()

    # -- 4. timing -------------------------------------------------------------
    t0 = time.perf_counter()
    timings = {}
    f32_bf16 = (torch.float32, torch.bfloat16)
    # (shape, [(loss, dtypes)]): the GLMix shape, the driver's (f32, and
    # bf16 as --precision bf16 runs it: phase 13 (b)), 262,144 x 2,048, and
    # the second-order main path's losses at their shapes (phase 8 (b) and
    # (a)); each shape's inputs are drawn once for all its losses
    for (n, d), cases in (
            (GLMIX_SHAPE, [("logistic", f32_bf16)]),
            (DRIVER_SHAPE, [("logistic", f32_bf16)]),
            (BIG_SHAPE, [("logistic", f32_bf16),
                         ("squared", (torch.float32,))]),
            (CONFIG3_SHAPE, [("poisson", (torch.float32,))]),
            (A1A_SHAPE, [("logistic", (torch.float32,))])):
        X, y, off, wt, w = kernel_inputs(torch, n, d, seed=11, device=dev)
        shift = torch.tensor(0.0, device=dev)
        for lname, dtypes in cases:
            loss = get_loss(lname)
            for dtype in dtypes:
                Xc = X.to(dtype).contiguous()
                for row in time_kernel(torch, hbm, loss, Xc, y, off, wt, w,
                                       shift).values():
                    timings[(n, d, row["dtype"], row["path"], lname)] = row
                    emit({"phase": "timing", **row})
                del Xc
        del X, y, off, wt, w
        torch.cuda.empty_cache()
    emit({"phase": "timing_done", "seconds": time.perf_counter() - t0})

    # -- 5. GLMix end to end at full width -----------------------------------
    t0 = time.perf_counter()
    task = TaskType.LOGISTIC_REGRESSION
    # (a) small GLMix: the card's run agrees with the CPU's
    small = movielens_data(np.random.default_rng(3), 40_000, 500, 300, 64)
    objs = {}
    for where in ("cpu", "cuda"):
        coords = glmix_coordinates(small, where, active_cap=32,
                                   feature_cap=32)
        res = run_coordinate_descent(
            coords, 2, task, small.responses, small.weights, small.offsets,
            device=where)
        objs[where] = [s.objective for s in res.states]
    rel = max(abs(a - b) / abs(a) for a, b in zip(objs["cpu"],
                                                  objs["cuda"]))
    if not rel <= 1e-4:
        raise AssertionError(f"small GLMix: card and CPU objectives differ "
                             f"(rel {rel:.3g}): {objs}")
    emit({"phase": "glmix_small_vs_cpu", "objectives_cpu": objs["cpu"],
          "objectives_cuda": objs["cuda"], "max_rel_diff": rel,
          "seconds": time.perf_counter() - t0})

    # (b) full width
    t0 = time.perf_counter()
    n, n_users, n_movies = 1_000_209, 6040, 3706
    data = movielens_data(np.random.default_rng(7), n, n_users, n_movies, 64)
    coords = glmix_coordinates(data, dev)
    torch.cuda.synchronize()
    build_secs = time.perf_counter() - t0
    re_ds = coords["per-user"].dataset
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launch_count()
    reset_hot_loop_stats()
    opt_common.reset_solver_syncs()
    t1 = time.perf_counter()
    res = run_coordinate_descent(
        coords, 2, task, data.responses, data.weights, data.offsets,
        device=dev, logger=lambda s: print(s, file=sys.stderr, flush=True))
    torch.cuda.synchronize()
    train_secs = time.perf_counter() - t1
    launches = pk.launch_count()
    by_path = dict(pk.fused_value_gradient_sums.launches_by_path)
    glmix_by_loss = launch_counts()["by_loss"]
    solver_syncs = opt_common.SOLVER_SYNCS["count"]
    hot = dict(HOT_LOOP_STATS)
    peak = torch.cuda.max_memory_allocated()
    sweeps = []
    for it in range(2):
        upd = [s for s in res.states if s.iteration == it]
        sweeps.append({
            "sweep": it, "objective": upd[-1].objective,
            "seconds": sum(s.seconds for s in upd),
            "fixed_iterations": upd[0].tracker.result.iterations,
            "re_counts_by_convergence":
                upd[1].tracker.counts_by_convergence()})
    if launches <= 0:
        raise AssertionError("the GLMix run never launched the kernel")
    if by_path["staged"] != 0 or by_path["stream"] != launches:
        raise AssertionError(f"the GLMix fixed effect left the stream "
                             f"path: {by_path}")
    if not all(np.isfinite(s["objective"]) for s in sweeps):
        raise AssertionError(f"non-finite objective: {sweeps}")
    if not sweeps[1]["objective"] <= sweeps[0]["objective"] * (1 + 1e-6):
        raise AssertionError(f"objective rose between sweeps: {sweeps}")
    scores = res.model.score(data, device=dev)
    if scores.shape != (n,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError("published GameModel scores are not finite")
    # phase 13 (a) compares its bf16 run with this one
    f32_glmix = {"objectives": [s["objective"] for s in sweeps],
                 "max_memory_allocated": peak}
    # phase 7 resumes this run and must land on these states
    glmix_final = {
        "fixed": res.model.models["fixed"].model.coefficients.means,
        "per-user": res.model.models["per-user"].coefficients_projected}
    # phase 15 holds its mesh runs to this run: per-update objectives,
    # final states (per-user ones matched entity by entity) and scores
    glmix_phase5 = {"objectives": [s.objective for s in res.states],
                    "fixed": glmix_final["fixed"],
                    "per-user": glmix_final["per-user"],
                    "codes": re_ds.entity_codes, "scores": scores}
    emit({"phase": "glmix", "n": n, "users": n_users, "movies": n_movies,
          "d_global": 64,
          "re_buckets": [list(b.X.shape) for b in re_ds.buckets],
          "build_secs": build_secs, "train_secs": train_secs,
          "sweeps": sweeps, "kernel_launches": launches,
          "launches_by_path": by_path,
          "updates": hot["updates"],
          "epilogue_fetches_per_update":
              hot["epilogue_fetches"] / hot["updates"],
          "solver_syncs": solver_syncs,
          "host_syncs_per_update":
              (hot["epilogue_fetches"] + solver_syncs) / hot["updates"],
          "max_memory_allocated": peak,
          "score_mean": float(scores.mean()),
          "seconds": time.perf_counter() - t0})

    # (c) the fixed-effect objective on the real GLMix batch, kernel
    # against plain version (after the counts were read)
    fe = coords["fixed"]
    batch = fe.dataset.with_offsets(coords["per-user"].score(
        res.model.models["per-user"].coefficients_projected))
    w_fe = res.model.models["fixed"].model.coefficients.means.contiguous()
    main_err, main_worst = check_sums(
        torch, get_loss("logistic"), batch.X, batch.labels, batch.offsets,
        batch.weights, w_fe, torch.zeros((), device=dev), scaled=True)
    emit({"phase": "glmix_batch_kernel_vs_plain",
          "path": paths_for(batch.X)[0], "max_abs_err": main_err,
          "worst_delta_over_tolerance": main_worst,
          "seconds": time.perf_counter() - t0})

    # -- 6. GLMix through the port's drivers ---------------------------------
    t0 = time.perf_counter()
    phase, driver_launches, driver_by_path, driver_check, fixture = \
        driver_phase(torch, dev, smi, driver_dir,
                     os.path.join(build, "drill", "fixture", "validate.avro"),
                     avro_write_secs=driver_write_secs)
    phase["seconds"] = time.perf_counter() - t0
    emit(phase)

    # -- 7. resume: in process at full size, then the drill's processes ----
    t0 = time.perf_counter()
    in_process, resume_crash, resume_resumed = resume_phase(
        torch, dev, data, glmix_final, os.path.join(build, "resume_phase"))
    in_process["seconds"] = time.perf_counter() - t0
    print("resume in process: " + json.dumps(in_process), file=sys.stderr,
          flush=True)
    t1 = time.perf_counter()
    drill_rec, drill_launches, drill_fixture, drill_ref = drill_phase(
        dev, os.path.join(build, "drill"), write_secs=drill_write_secs)
    drill_rec["seconds"] = time.perf_counter() - t1
    emit({"phase": "resume", "nvidia_smi": smi, "in_process": in_process,
          "drill": drill_rec,
          "metric_determinism": (
              "training floats (states, scores, objectives) are compared "
              "bit for bit; validation metrics and best_metric to 1e-12 "
              "relative, since a metric's segment sums on the card are "
              "atomic f64 adds in no fixed order"),
          "seconds": time.perf_counter() - t0})

    # -- 8. second-order solvers: BASELINE configs 2 and 3 ----------------
    t0 = time.perf_counter()
    cfg2 = config2_phase(torch, dev)
    torch.cuda.empty_cache()
    print("config 2: " + json.dumps(cfg2), file=sys.stderr, flush=True)
    cfg3 = config3_phase(torch, dev)
    torch.cuda.empty_cache()
    print("config 3: " + json.dumps(cfg3), file=sys.stderr, flush=True)
    small2, small2_launches = second_order_small_vs_cpu(torch)
    print("small vs CPU: " + json.dumps(small2), file=sys.stderr,
          flush=True)
    profile = per_user_profile(
        torch, dev, coords["per-user"].dataset,
        coords["fixed"].score(glmix_final["fixed"]))
    print("per-user profile: " + json.dumps(profile), file=sys.stderr,
          flush=True)
    drivers2, drivers2_launches = second_order_driver_phase(
        torch, dev, *drill_fixture, fixture[2],
        os.path.join(build, "second_order"))
    emit({"phase": "second_order", "nvidia_smi": smi, "config2": cfg2,
          "config3": cfg3, "drivers": drivers2, "small_vs_cpu": small2,
          "per_user_profile": profile,
          "peak_memory": {"config2": cfg2["max_memory_allocated"],
                          **{f"driver_{k}": v["max_memory_allocated"]
                             for k, v in drivers2["runs"].items()}},
          "seconds": time.perf_counter() - t0})

    # -- 9. coordinate-descent extensions ---------------------------------
    cd_ext, cd_launches = cd_extensions_phase(
        torch, dev, smi, data, coords, drill_fixture,
        os.path.join(build, "cd_extensions"))
    emit(cd_ext)
    del coords
    torch.cuda.empty_cache()

    # -- 10. factored random effects and BASELINE config 5 ----------------
    factored, fac_launches, fac_errs, fac_rows = factored_phase(
        torch, dev, smi, data, drill_fixture,
        os.path.join(build, "factored"), hbm)
    emit(factored)
    for row in fac_rows:
        timings[(row["n"], row["d"], row["dtype"], row["path"],
                 row["loss"])] = row

    # -- 11. the single-GLM path: BASELINE config 1 -------------------------
    single, single_launches, single_err = single_glm_phase(
        torch, dev, smi, os.path.join(build, "single_glm"))
    emit(single)

    # -- 12. wide and streamed data ------------------------------------------
    wide, wide_launches = wide_streamed_phase(
        torch, dev, smi, data, os.path.join(build, "wide_streamed"), hbm)
    emit(wide)

    # -- 13. bf16 storage and the serving path -------------------------------
    drill_f32 = os.path.join(build, "drill_f32")
    bf16, bf16_launches, bf16_errs, served = bf16_serve_phase(
        torch, dev, smi, data, f32_glmix, drill_fixture, driver_dir,
        os.path.join(build, "bf16_serve"), drill_f32)
    emit(bf16)

    # -- 14. the scorer fleet ----------------------------------------------
    t0 = time.perf_counter()
    fleet = fleet_phase(torch, dev, smi, served,
                        os.path.join(build, "fleet"))
    fleet["seconds"] = time.perf_counter() - t0
    emit(fleet)

    # -- 15. the device mesh -------------------------------------------------
    mesh, mesh_launches, mesh_err, mesh_rows = mesh_phase(
        torch, dev, smi, data, glmix_phase5, drill_fixture, drill_f32,
        os.path.join(build, "mesh"), hbm)
    for d in ("drill_f32", "mesh"):
        shutil.rmtree(os.path.join(build, d), ignore_errors=True)
    emit(mesh)
    for row in mesh_rows:
        timings[(row["n"], row["d"], row["dtype"], row["path"],
                 row["loss"])] = row

    # -- 16. the process gang ----------------------------------------------
    gang, gang_launches = gang_phase(torch, dev, smi, data, fixture,
                                     driver_dir, os.path.join(build, "gang"))
    shutil.rmtree(os.path.join(build, "gang"), ignore_errors=True)
    emit(gang)

    # -- 17. run supervision -------------------------------------------------
    supervise, supervise_launches = supervise_phase(
        torch, dev, smi, drill_fixture, drill_ref, served,
        os.path.join(build, "supervise"))
    del served
    shutil.rmtree(os.path.join(build, "drill"), ignore_errors=True)
    emit(supervise)

    # -- 18. the chaos campaign and the OTLP bridge -------------------------
    chaos = chaos_phase(smi, os.path.join(driver_dir, "train_trace"),
                        os.path.join(build, "chaos"))
    shutil.rmtree(driver_dir, ignore_errors=True)
    emit(chaos)

    # -- kernels line, card line, result ---------------------------------------
    cd_runs = {f"cd_{k}": v for k, v in cd_launches.items()}
    fac_runs = {f"factored_{k}": v for k, v in fac_launches.items()}
    second_order_runs = {
        "config2": cfg2["launches"], "config3": cfg3["launches"],
        **{f"driver_{k}": v for k, v in drivers2_launches.items()},
        **{f"small_{k}_cuda": v for k, v in small2_launches.items()}}
    runs = {"glmix": by_path, "driver": driver_by_path,
            "resume_before_kill": resume_crash,
            "resume_resumed": resume_resumed,
            **{f"drill_{r}": v for r, v in drill_launches.items()},
            **supervise_launches,
            **{k: v["by_path"] for k, v in second_order_runs.items()},
            **{k: v["by_path"] for k, v in cd_runs.items()},
            **{k: v["by_path"] for k, v in fac_runs.items()},
            **{k: v["by_path"] for k, v in single_launches.items()},
            "wide_streamed_c_in_ram": wide_launches["by_path"],
            **{k: v["by_path"] for k, v in bf16_launches.items()},
            **{k: v["by_path"] for k, v in mesh_launches.items()},
            **{k: v["launches_by_path"] for k, v in gang_launches.items()}}
    by_loss = {"glmix": glmix_by_loss, "driver": phase["launches_by_loss"],
               **{k: v["by_loss"] for k, v in second_order_runs.items()},
               **{k: v["by_loss"] for k, v in cd_runs.items()},
               **{k: v["by_loss"] for k, v in fac_runs.items()},
               **{k: v["by_loss"] for k, v in single_launches.items()},
               "wide_streamed_c_in_ram": wide_launches["by_loss"],
               **{k: v["by_loss"] for k, v in bf16_launches.items()},
               **{k: v["by_loss"] for k, v in mesh_launches.items()},
               **{k: v["launches_by_loss"]
                  for k, v in gang_launches.items()}}
    total_by_path = {p: sum(r[p] for r in runs.values())
                     for p in by_path}
    main = timings[(*GLMIX_SHAPE, "float32", "stream", "logistic")]
    driver = timings[(*DRIVER_SHAPE, "float32", driver_check["path"],
                      "logistic")]
    staged = timings[(*BIG_SHAPE, "float32", "staged", "logistic")]
    a1a = timings[(*A1A_SHAPE, "float32", "stream", "logistic")]
    emit({"kernels": [{
        "name": "fused_value_gradient_sums",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/csrc/fused_value_gradient.cu",
        "replaces": "photon_ml_tpu/ops/pallas_kernels.py:144",
        "launches": sum(total_by_path.values()),
        "launches_by_run": runs,
        "launches_by_loss": by_loss,
        "max_abs_err": max(main_err, driver_check["max_abs_err"],
                           *fac_errs, single_err, *bf16_errs, mesh_err),
        "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "device_ms": main["device_ms"],
        "paths": {p: {"ms": r["kernel_ms"], "device_ms": r["device_ms"],
                      "bound_ms": r["bound_ms"],
                      "shape": [r["n"], r["d"]], "dtype": r["dtype"],
                      "launches": total_by_path[p]}
                  for p, r in (("stream", main), ("staged", staged))},
        "rows": [{k: r[k] for k in (
            "n", "d", "dtype", "path", "loss", "kernel_ms", "device_ms",
            "host_ms", "plain_ms",
            "plain_device_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by", "share_of_bound",
            "device_share_of_bound")} for r in timings.values()],
        "driver_shape": {"shape": list(DRIVER_SHAPE), "path": driver["path"],
                         "ms": driver["kernel_ms"],
                         "device_ms": driver["device_ms"],
                         "bound_ms": driver["bound_ms"],
                         "share_of_bound": driver["share_of_bound"],
                         "device_share_of_bound":
                             driver["device_share_of_bound"]},
        "launches_by_shard": {
            k: mesh["b_glmix"]["runs"][k]["launches_by_shard"]
            for k in mesh["b_glmix"]["runs"]},
        "launches_per_gang_process": {
            k: v["launches"] for k, v in gang_launches.items()},
        "per_shard_shapes": [
            {"shape": [r["n"], r["d"]], "path": r["path"],
             "ms": r["kernel_ms"], "device_ms": r["device_ms"],
             "bound_ms": r["bound_ms"], "plain_ms": r["plain_ms"],
             "library_ms": r["library_ms"],
             "launches_per_shard": mesh["b_glmix"]["runs"]["data_4x1"][
                 "launches_by_shard"].get(0, 0) if r["d"] == 64 else None}
            for r in mesh_rows],
        "a1a_shape": {"shape": list(A1A_SHAPE), "path": a1a["path"],
                      "ms": a1a["kernel_ms"], "device_ms": a1a["device_ms"],
                      "bound_ms": a1a["bound_ms"],
                      "plain_ms": a1a["plain_ms"],
                      "library_ms": a1a["library_ms"],
                      "share_of_bound": a1a["share_of_bound"],
                      "device_share_of_bound":
                          a1a["device_share_of_bound"]},
        "checked": True,
    }], "seconds_total": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
