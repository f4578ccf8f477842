"""GAME training driver: Avro -> coordinates -> coordinate-descent grid ->
best model, on the card.

Port of ``photon_ml_tpu/cli/game_training_driver.py`` — ``parse_args``
(``:166-411``), ``GameTrainingDriver`` (``:413-879``) for one process and
``main`` (reference: cli/game/training/Driver.scala:66-757)::

    prepareFeatureMaps -> prepareGameDataSet -> train (grid of
    coordinate-descent runs, random-guess baseline, best model) ->
    metrics.json + best/ + output/grid-<i>/

The flags and their value formats are the JAX driver's, so one argv runs
either package; the port adds ``--device`` (default ``cuda``, no fallback
to the CPU). Fault tolerance is wired as the JAX driver wires it
(``:677-743``, ``:1187-1245``): ``--checkpoint-dir`` (one grid point;
an existing directory resumes from its newest intact step, and one whose
steps are all corrupt ends in exit 3 before any data is read),
``--checkpoint-every-coordinates``, ``--recovery-policy`` and the other
``--recovery-*`` flags, ``--max-train-seconds``, ``--stop-file`` and
SIGTERM/SIGINT (exit 75 at the next commit barrier), and
``--max-shard-loss-frac`` (degraded ingest). Every optimizer string of
the JAX driver trains (L-BFGS, OWL-QN for L1 and elastic net, TRON), with
its down-sampling rate (below 1 the fixed effect samples its batch at
every update), and ``--compute-variance`` reaches the fixed-effect
problem as in the JAX driver (``:560-576``); the fixed effect solves
through ``run_lazy``, which computes no variances there either, so a GAME
model carries none. The coordinate-descent flags are the JAX driver's,
with its defaults: ``--cd-block-size`` (1), ``--cd-pipeline-depth`` (1
when unset, ``:741-742``) and ``--re-lane-compaction-chunk`` (0, an int
or ``auto``; ``_lane_chunk``, ``:500-502``). Random effects take every
projection of the data configuration (index map, identity, random).
``--factored-random-effect-optimization-configurations`` trains factored
random effects (``coordId:reCfg:latentCfg:mfCfg``, ``_parse_factored_grid``
``:125-145``, a grid multiplied with the other two, ``:676``): such a
coordinate's dataset has one block whatever
``--random-effect-block-buckets`` says, its per-entity problem takes the
lane chunk and its latent problem no variance flag (``:582-597``); a
factored config for a coordinate that is not a random effect of the
updating sequence is refused (``:1010-1029``).
``--random-effect-blocks-dir`` builds each (non-factored) random effect
through the streamed builder with its feature blocks as memmap files
under ``<dir>/<coordinate id>`` (``:604-619``), which the solver copies
to the card a bucket at a time; ``--offheap-indexmap-dir`` reads the
feature maps from a pre-built off-heap store, one namespace per shard,
instead of scanning the data, and ``--offheap-indexmap-num-partitions``
must match the store's partition count (``prepare_feature_maps``,
``:459-479``). A feature shard wider than 4,096 columns trains as an
ELL batch. ``--precision bf16`` stores every coordinate's design matrix
(fixed effect, random-effect blocks, in RAM or paged from the memmap
files, and the factored coordinate's) in bf16, as the JAX driver does
(``:562-625``); labels, offsets, weights, coefficients and every
reduction stay f32. Flags whose feature is not ported yet raise
``NotImplementedError`` naming the flag and end the run through
``clean_abort`` (exit 3): multi-process runs and their supervision,
entity sharding and quantized collectives. The telemetry flags
(``--trace-dir``, ``--trace-heartbeat-seconds``, ``--trace-stall-seconds``,
``--telemetry-endpoint``, ``--device-telemetry``) are validated as the
JAX driver validates them (``check_telemetry_flags``, exit 2 on misuse)
and run through ``obs/run.py``; ``run_end`` records how the run ended,
on exit 75 and exit 3 too (``:1190-1242``).

Validation rows are matched to the trained per-entity models by raw id:
the validation id columns are re-encoded against the training vocabulary
before training (the JAX driver matches them by code, which agrees only
when both sets hold the same ids).
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import shutil
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.cli import (
    build_event_bus,
    build_ingest_policy,
    clean_abort,
    clean_abort_types,
    preempted_exit,
)
from photon_ml_tpu_torch.cli.args import (
    add_device_flag,
    add_observability_flags,
    add_precision_flags,
    check_telemetry_flags,
    parse_key_value_map,
    precision_dtype,
    parse_section_keys_map,
    refuse_unported,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.obs.run import start_observed_run_from_flags
from photon_ml_tpu_torch.evaluation.evaluators import (
    EvaluatorSpec,
    evaluate_many,
    resolve_entity_ids,
)
from photon_ml_tpu_torch.game.coordinate import (
    FactoredRandomEffectCoordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.coordinate_descent import (
    CoordinateDescentResult,
    RecoveryPolicy,
    run_coordinate_descent,
)
from photon_ml_tpu_torch.game.dataset import (
    FixedEffectDataConfiguration,
    GameDataset,
    RandomEffectDataConfiguration,
    build_fixed_effect_dataset,
    build_random_effect_dataset,
    build_random_effect_dataset_streamed,
    dataset_row_stream,
)
from photon_ml_tpu_torch.game.random_effect import (
    AUTO_COMPACTION_CHUNK,
    RandomEffectOptimizationProblem,
)
from photon_ml_tpu_torch.io.data_format import (
    NameAndTermFeatureSets,
    load_game_dataset_avro,
)
from photon_ml_tpu_torch.io.feature_index_job import load_feature_index
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.io.model_io import save_game_model
from photon_ml_tpu_torch.optimize.config import (
    GLMOptimizationConfiguration,
    MFOptimizationConfiguration,
    TaskType,
)
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.utils import parse_flag
from photon_ml_tpu_torch.utils.checkpoint import CheckpointManager
from photon_ml_tpu_torch.utils.date_range import resolve_input_paths
from photon_ml_tpu_torch.utils.logging import PhotonLogger, timed_phase
from photon_ml_tpu_torch.utils.preempt import (
    PreemptionRequested,
    StopController,
)


class ModelOutputMode:
    """io/ModelOutputMode.scala: ALL / BEST / NONE."""

    ALL = "ALL"
    BEST = "BEST"
    NONE = "NONE"


def _parse_opt_config_grid(s: str) -> list[dict[str,
                                               GLMOptimizationConfiguration]]:
    """``;``-separated grid points of ``|``-separated ``coord:cfg``."""
    return [{k: GLMOptimizationConfiguration.parse(v)
             for k, v in parse_key_value_map(point).items()}
            for point in s.split(";") if point.strip()]


def _parse_factored_grid(s: str) -> list[dict]:
    """``;``-separated grid points of ``|``-separated
    ``coordId:reCfg:latentCfg:mfCfg``."""
    grid = []
    for point in s.split(";"):
        if not point.strip():
            continue
        configs = {}
        for line in point.split("|"):
            if not line.strip():
                continue
            parts = [p.strip() for p in line.split(":")]
            if len(parts) != 4:
                raise ValueError(
                    f"factored config needs coordId:reCfg:latentCfg:mfCfg, "
                    f"got {line!r}")
            key, re_cfg, latent_cfg, mf_cfg = parts
            configs[key] = (GLMOptimizationConfiguration.parse(re_cfg),
                            GLMOptimizationConfiguration.parse(latent_cfg),
                            MFOptimizationConfiguration.parse(mf_cfg))
        grid.append(configs)
    return grid


def _int_or_auto(s: str) -> int:
    """An int, or ``auto`` (-1, ``AUTO_COMPACTION_CHUNK``): the spellings
    of ``--re-lane-compaction-chunk`` and ``--re-entity-shards``."""
    return AUTO_COMPACTION_CHUNK if s.strip().lower() == "auto" else int(s)


def parse_args(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="game-training-torch",
                                description="GAME training on the GPU")
    p.add_argument("--train-input-dirs", required=True)
    p.add_argument("--train-date-range")
    p.add_argument("--train-date-range-days-ago")
    p.add_argument("--validate-input-dirs")
    p.add_argument("--validate-date-range")
    p.add_argument("--validate-date-range-days-ago")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task-type", required=True,
                   choices=[t.name for t in TaskType])
    p.add_argument("--feature-name-and-term-set-path")
    p.add_argument("--feature-shard-id-to-feature-section-keys-map",
                   required=True)
    p.add_argument("--feature-shard-id-to-intercept-map", default="")
    p.add_argument("--updating-sequence", required=True)
    p.add_argument("--num-iterations", type=int, default=1)
    p.add_argument("--fixed-effect-data-configurations", default="")
    p.add_argument("--fixed-effect-optimization-configurations", default="")
    p.add_argument("--random-effect-data-configurations", default="")
    p.add_argument("--random-effect-optimization-configurations", default="")
    p.add_argument("--factored-random-effect-optimization-configurations",
                   default="")
    p.add_argument("--random-effect-block-buckets", type=int, default=1,
                   help="(N, D) size buckets for random-effect entity "
                        "blocks")
    p.add_argument("--re-lane-compaction-chunk", type=_int_or_auto,
                   default=0,
                   help="solve random-effect entity blocks in chunks of "
                        "this many iterations, re-dispatching only the "
                        "lanes still unconverged (one host read a "
                        "chunk; bit-identical results); 0 (default): one "
                        "dispatch; 'auto': a chunk re-tuned between "
                        "solves from the lanes' decay")
    p.add_argument("--re-entity-shards", type=_int_or_auto, default=1)
    add_precision_flags(p)
    p.add_argument("--cd-block-size", type=int, default=1,
                   help="solve this many coordinates of a sweep against "
                        "the block-start score total, then correct the "
                        "total with one epilogue (one read a block); 1 "
                        "(default): the sequential sweep")
    p.add_argument("--cd-pipeline-depth", type=int, default=None,
                   choices=[0, 1],
                   help="1 (default when unset): dispatch each block "
                        "before the previous block's epilogue is read, "
                        "with the floats of 0, the sequential order")
    p.add_argument("--random-effect-blocks-dir", default=None)
    p.add_argument("--max-shard-loss-frac", type=float, default=0.0)
    p.add_argument("--evaluator-type", default="")
    p.add_argument("--model-output-mode", default=None,
                   choices=[ModelOutputMode.ALL, ModelOutputMode.BEST,
                            ModelOutputMode.NONE])
    p.add_argument("--num-output-files-for-random-effect-model", type=int,
                   default=1)
    p.add_argument("--compute-variance", default="false")
    p.add_argument("--delete-output-dir-if-exists", default="false")
    p.add_argument("--application-name", default="game-training")
    p.add_argument("--offheap-indexmap-dir")
    p.add_argument("--offheap-indexmap-num-partitions", type=int,
                   default=None)
    p.add_argument("--checkpoint-dir")
    p.add_argument("--checkpoint-every-coordinates", type=int, default=0)
    p.add_argument("--recovery-policy", default="none",
                   choices=["none", "abort", "skip"])
    p.add_argument("--recovery-max-retries", type=int, default=2)
    p.add_argument("--recovery-damping", type=float, default=0.5)
    p.add_argument("--recovery-max-consecutive-failures", type=int,
                   default=3)
    p.add_argument("--recovery-quarantine-after", type=int, default=0)
    p.add_argument("--max-train-seconds", type=float, default=0.0)
    p.add_argument("--stop-file", default=None)
    p.add_argument("--max-worker-restarts", type=int, default=0)
    p.add_argument("--worker-backoff-base", type=float, default=1.0)
    p.add_argument("--worker-backoff-max", type=float, default=30.0)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--coordinator-timeout", type=int, default=60)
    p.add_argument("--heartbeat-timeout", type=int, default=100)
    add_observability_flags(p)
    add_device_flag(p)
    ns = p.parse_args(argv)
    check_telemetry_flags(p, ns)
    return ns


def check_unported(ns: argparse.Namespace) -> None:
    """``NotImplementedError`` for the first flag set that asks for a
    feature the port does not run yet."""
    refuse_unported(ns, [
        ("--num-processes", ns.num_processes > 1, "multi-process runs"),
        ("--max-worker-restarts", ns.max_worker_restarts > 0,
         "worker supervision"),
        ("--re-entity-shards", ns.re_entity_shards != 1,
         "entity sharding"),
        ("--collective-quant", ns.collective_quant != "none",
         "quantized collectives"),
    ])


class GameTrainingDriver:
    """cli/game/training/Driver.scala analog, one process, on ``device``."""

    def __init__(self, ns: argparse.Namespace,
                 logger: Optional[PhotonLogger] = None):
        check_unported(ns)
        self.ns = ns
        self.device = resolve_device(ns.device)
        self.task = TaskType[ns.task_type]
        self.section_keys = parse_section_keys_map(
            ns.feature_shard_id_to_feature_section_keys_map)
        self.intercept_map = {
            k: parse_flag(v)
            for k, v in parse_key_value_map(
                ns.feature_shard_id_to_intercept_map).items()}
        self.updating_sequence = [
            x.strip() for x in ns.updating_sequence.split(",") if x.strip()]
        self.fixed_data_configs = {
            k: FixedEffectDataConfiguration.parse(v)
            for k, v in parse_key_value_map(
                ns.fixed_effect_data_configurations).items()}
        self.random_data_configs = {
            k: RandomEffectDataConfiguration.parse(v)
            for k, v in parse_key_value_map(
                ns.random_effect_data_configurations).items()}
        self.fixed_opt_grid = _parse_opt_config_grid(
            ns.fixed_effect_optimization_configurations) or [{}]
        self.random_opt_grid = _parse_opt_config_grid(
            ns.random_effect_optimization_configurations) or [{}]
        self.factored_grid = _parse_factored_grid(
            ns.factored_random_effect_optimization_configurations) or [{}]
        random_ids = {c for c in self.updating_sequence
                      if c in self.random_data_configs}
        unknown = sorted({c for point in self.factored_grid for c in point}
                         - random_ids)
        if unknown:
            raise ValueError(
                f"factored configs for unknown coordinates: {unknown} (a "
                f"factored coordinate is a random-effect coordinate of the "
                f"updating sequence; have {sorted(random_ids)})")
        self.evaluators = [EvaluatorSpec.parse(x)
                           for x in ns.evaluator_type.split(",") if x.strip()]
        # the log opens once the configurations parse: a refused argv
        # leaves no output directory behind
        self.logger = logger or PhotonLogger(
            os.path.join(ns.output_dir, "game-training.log"), echo=False)

        self.index_maps: dict[str, IndexMap] = {}
        self.train_data: Optional[GameDataset] = None
        self.validate_data: Optional[GameDataset] = None
        self.train_ingest = None  # IngestPolicy of the training load
        self.validate_ingest = None
        #: the one event bus of the run: ingest and coordinate descent
        #: share its listeners
        self.events = build_event_bus(self.logger.warn)
        #: the StopController polled by coordinate descent (set by run())
        self.stop: Optional[StopController] = None
        self.best_result: Optional[CoordinateDescentResult] = None
        #: phase name -> wall seconds of the last run
        self.phase_seconds: dict[str, float] = {}

    def _lane_chunk(self) -> int:
        """``--re-lane-compaction-chunk``: the auto value, or the chunk
        (a negative one is no chunk)."""
        c = int(self.ns.re_lane_compaction_chunk)
        return c if c == AUTO_COMPACTION_CHUNK else max(0, c)

    # -- pipeline ----------------------------------------------------------

    def prepare_feature_maps(self) -> None:
        """GAMEDriver.prepareFeatureMaps: per-shard index maps from the
        off-heap store of ``--offheap-indexmap-dir``, else from the feature
        name-and-term sets (a saved set directory, else a scan of the
        training data)."""
        if self.ns.offheap_indexmap_dir:
            # offheap=True, not the autodetect: a directory without the
            # off-heap store fails instead of loading its JSON maps
            # unchecked against the partition count
            self.index_maps.update(load_feature_index(
                self.ns.offheap_indexmap_dir, sorted(self.section_keys),
                offheap=True,
                expected_partitions=self.ns.offheap_indexmap_num_partitions))
            self.logger.info(
                f"off-heap feature maps: "
                f"{ {k: len(v) for k, v in self.index_maps.items()} }")
            return
        all_sections = sorted({s for secs in self.section_keys.values()
                               for s in secs})
        if self.ns.feature_name_and_term_set_path:
            sets = NameAndTermFeatureSets.load(
                self.ns.feature_name_and_term_set_path, all_sections)
        else:
            sets = NameAndTermFeatureSets.from_paths(
                resolve_input_paths(self.ns.train_input_dirs,
                                    self.ns.train_date_range,
                                    self.ns.train_date_range_days_ago),
                all_sections, policy=self._ingest_policy())
        for shard, sections in self.section_keys.items():
            self.index_maps[shard] = sets.index_map(
                sections, add_intercept=self.intercept_map.get(shard, True))
        self.logger.info(
            f"feature maps: "
            f"{ {k: len(v) for k, v in self.index_maps.items()} }")

    def _ingest_policy(self):
        return build_ingest_policy(self.ns.max_shard_loss_frac,
                                   events=self.events, warn=self.logger.warn)

    def _id_types(self) -> list[str]:
        id_types = {cfg.random_effect_type
                    for cfg in self.random_data_configs.values()}
        id_types |= {e.id_type for e in self.evaluators if e.id_type}
        return sorted(id_types)

    def prepare_game_dataset(self) -> None:
        train_paths = resolve_input_paths(
            self.ns.train_input_dirs, self.ns.train_date_range,
            self.ns.train_date_range_days_ago)
        self.train_ingest = self._ingest_policy()
        self.train_data = load_game_dataset_avro(
            train_paths, self.section_keys, self.index_maps,
            id_types=self._id_types(), response_required=True,
            policy=self.train_ingest)
        self.train_ingest.finish(log=self.logger.warn)
        self.logger.info(
            f"train dataset: {self.train_data.num_samples} samples "
            f"from {len(train_paths)} path(s), data coverage "
            f"{self.train_ingest.coverage_fraction:.1%}")
        if self.ns.validate_input_dirs:
            self.validate_ingest = self._ingest_policy()
            self.validate_data = load_game_dataset_avro(
                resolve_input_paths(self.ns.validate_input_dirs,
                                    self.ns.validate_date_range,
                                    self.ns.validate_date_range_days_ago),
                self.section_keys, self.index_maps,
                id_types=self._id_types(), response_required=True,
                policy=self.validate_ingest)
            self.validate_ingest.finish(log=self.logger.warn)
            for cfg in self.random_data_configs.values():
                t = cfg.random_effect_type
                self.validate_data.recode_ids(t, self.train_data.id_vocabs[t])
            self.logger.info(f"validation dataset: "
                             f"{self.validate_data.num_samples} samples")

    def _build_coordinates(self, fixed_cfgs, random_cfgs,
                           factored_cfgs) -> dict:
        """One coordinate per updating-sequence entry with this grid
        point's optimization configs (Driver.train :352-533)."""
        coords = {}
        dtype = precision_dtype(self.ns.precision)
        for cid in self.updating_sequence:
            if cid in self.fixed_data_configs:
                ds = build_fixed_effect_dataset(
                    self.train_data,
                    self.fixed_data_configs[cid].feature_shard_id,
                    dtype=dtype, device=self.device)
                coords[cid] = FixedEffectCoordinate(
                    dataset=ds, problem=GLMOptimizationProblem(
                        config=fixed_cfgs.get(
                            cid, GLMOptimizationConfiguration()),
                        task=self.task,
                        compute_variances=parse_flag(
                            self.ns.compute_variance)))
            elif cid in self.random_data_configs and cid in factored_cfgs:
                re_cfg, latent_cfg, mf_cfg = factored_cfgs[cid]
                coords[cid] = FactoredRandomEffectCoordinate(
                    dataset=build_random_effect_dataset(
                        self.train_data, self.random_data_configs[cid],
                        dtype=dtype, device=self.device),
                    problem=RandomEffectOptimizationProblem(
                        config=re_cfg, task=self.task,
                        lane_compaction_chunk=self._lane_chunk()),
                    latent_problem=GLMOptimizationProblem(
                        config=latent_cfg, task=self.task),
                    latent_dim=mf_cfg.num_factors,
                    num_inner_iterations=mf_cfg.max_number_iterations)
            elif cid in self.random_data_configs:
                data_cfg = self.random_data_configs[cid]
                num_buckets = max(1, self.ns.random_effect_block_buckets)
                if self.ns.random_effect_blocks_dir:
                    ds = build_random_effect_dataset_streamed(
                        dataset_row_stream(self.train_data, data_cfg),
                        data_cfg,
                        raw_dim=self.train_data.feature_shards[
                            data_cfg.feature_shard_id].shape[1],
                        num_buckets=num_buckets,
                        blocks_dir=os.path.join(
                            self.ns.random_effect_blocks_dir, cid),
                        dtype=dtype, device=self.device)
                else:
                    ds = build_random_effect_dataset(
                        self.train_data, data_cfg, num_buckets=num_buckets,
                        dtype=dtype, device=self.device)
                coords[cid] = RandomEffectCoordinate(
                    dataset=ds, problem=RandomEffectOptimizationProblem(
                        config=random_cfgs.get(
                            cid, GLMOptimizationConfiguration()),
                        task=self.task,
                        lane_compaction_chunk=self._lane_chunk()))
            else:
                raise ValueError(
                    f"coordinate {cid!r} in updating sequence has no data "
                    f"configuration")
        return coords

    def _validation_evaluator(self):
        """All evaluators over device scores, one fetch per pass."""
        if self.validate_data is None or not self.evaluators:
            return None, None
        vd = self.validate_data
        f32 = dict(dtype=torch.float32, device=self.device)
        labels = torch.as_tensor(vd.responses, **f32)
        weights = torch.as_tensor(vd.weights, **f32)
        ids_by_type, num_by_type = resolve_entity_ids(
            self.evaluators, vd.id_columns, vd.id_vocabs, self.device)

        def evaluator(scores):
            return evaluate_many(
                self.evaluators, scores, labels, weights,
                entity_ids_by_type=ids_by_type,
                num_entities_by_type=num_by_type)

        return evaluator, self.evaluators[0]

    def train(self) -> tuple:
        """Grid over opt-config combinations; each runs coordinate descent
        (Driver.train :324-350); best by the first evaluator, else by the
        lowest final training objective."""
        evaluator, first_spec = self._validation_evaluator()
        if evaluator is not None:
            # random-guess baseline per evaluator (Driver.scala:307-311)
            rand = torch.as_tensor(np.random.default_rng(0).uniform(
                size=self.validate_data.num_samples), dtype=torch.float32,
                device=self.device)
            for name, value in evaluator(rand).items():
                self.logger.info(
                    f"Random guessing based baseline evaluation metric for "
                    f"{name}: {value:.6f}")
        best = None  # (metric, result, description)
        results = []
        combos = list(itertools.product(
            self.fixed_opt_grid, self.random_opt_grid, self.factored_grid))
        ckpt_mgr = resume_snapshot = None
        if self.ns.checkpoint_dir:
            if len(combos) > 1:
                raise ValueError(
                    "--checkpoint-dir supports single-grid-point runs only "
                    f"(got {len(combos)} grid combinations)")
            ckpt_mgr = CheckpointManager(self.ns.checkpoint_dir)
            # the newest step that verifies and loads; a directory with
            # steps but none intact raises, an empty one is a fresh run
            try:
                resume_snapshot = ckpt_mgr.restore()
            except FileNotFoundError:
                resume_snapshot = None
            if resume_snapshot is not None:
                self.logger.info(
                    f"resuming from checkpoint at sweep "
                    f"{resume_snapshot.get('sweep', resume_snapshot.get('iteration', 0))} "
                    f"coordinate "
                    f"{resume_snapshot.get('coordinate_index', 0)}")
        recovery = events = None
        if self.ns.recovery_policy != "none":
            recovery = RecoveryPolicy(
                max_retries=self.ns.recovery_max_retries,
                on_exhausted=self.ns.recovery_policy,
                damping=self.ns.recovery_damping,
                max_consecutive_failures=(
                    self.ns.recovery_max_consecutive_failures),
                quarantine_after=self.ns.recovery_quarantine_after)
            events = self.events
        for gi, (f_cfgs, r_cfgs, fac_cfgs) in enumerate(combos):
            desc = (f"grid[{gi}]: fixed="
                    f"{ {k: v.render() for k, v in f_cfgs.items()} } "
                    f"random={ {k: v.render() for k, v in r_cfgs.items()} }")
            self.logger.info(desc)
            with timed_phase(f"train grid[{gi}]", self.logger,
                             self.phase_seconds):
                coords = self._build_coordinates(f_cfgs, r_cfgs, fac_cfgs)
                result = run_coordinate_descent(
                    coords, self.ns.num_iterations, self.task,
                    self.train_data.responses, self.train_data.weights,
                    self.train_data.offsets,
                    validation_data=self.validate_data,
                    validation_evaluator=evaluator,
                    validation_metric=(first_spec.name if first_spec
                                       else None),
                    higher_is_better=(first_spec.better_than(1.0, 0.0)
                                      if first_spec else True),
                    logger=self.logger,
                    checkpoint_manager=ckpt_mgr,
                    checkpoint_every_coordinates=(
                        self.ns.checkpoint_every_coordinates),
                    resume_snapshot=resume_snapshot,
                    recovery=recovery, events=events, stop=self.stop,
                    block_size=max(1, int(self.ns.cd_block_size)),
                    pipeline_depth=(1 if self.ns.cd_pipeline_depth is None
                                    else int(self.ns.cd_pipeline_depth)),
                    device=self.device)
            if result.quarantined:
                self.logger.warn(
                    f"{desc}: quarantined coordinates (frozen at "
                    f"last-good state): {result.quarantined}")
            results.append((desc, result))
            metric = result.best_metric
            if metric is not None and (
                    best is None or first_spec.better_than(metric, best[0])):
                best = (metric, result, desc)
        if best is None and results:
            desc, result = min(
                results, key=lambda dr: (dr[1].states[-1].objective
                                         if dr[1].states else float("inf")))
            best = (None, result, desc)
        return best, results

    def run(self) -> CoordinateDescentResult:
        ns = self.ns
        # the entity-axis size, as the JAX driver reports it (``:791``):
        # the port runs one shard
        REGISTRY.gauge("re_entity_shards").set(1)
        if os.path.isdir(ns.output_dir) and os.listdir(ns.output_dir):
            if parse_flag(ns.delete_output_dir_if_exists):
                shutil.rmtree(ns.output_dir)
            elif os.path.exists(os.path.join(ns.output_dir, "best")):
                raise FileExistsError(
                    f"output dir {ns.output_dir} is not empty")
        os.makedirs(ns.output_dir, exist_ok=True)
        if ns.checkpoint_dir and os.path.isdir(ns.checkpoint_dir):
            # an all-corrupt directory is terminal: refuse before the data
            # is read (the JAX multi-host driver's pre-flight, :950-959)
            CheckpointManager(ns.checkpoint_dir).raise_if_all_corrupt()
        with timed_phase("prepareFeatureMaps", self.logger,
                         self.phase_seconds):
            self.prepare_feature_maps()
        with timed_phase("prepareGameDataSet", self.logger,
                         self.phase_seconds):
            self.prepare_game_dataset()
        best, results = self.train()
        _, best_result, best_desc = best
        self.logger.info(f"best model: {best_desc}")
        quarantined_all = sorted({cid for _, r in results
                                  for cid in r.quarantined})
        if quarantined_all:
            self.logger.warn(
                f"run summary: {len(quarantined_all)} coordinate(s) "
                f"quarantined (frozen at last-good state): "
                f"{quarantined_all}")

        def _finite(x):
            x = None if x is None else float(x)
            return x if x is not None and math.isfinite(x) else None

        # metrics.json in the JAX driver's schema (:820-858)
        record = {
            "best": {"description": best_desc,
                     "metric": _finite(best_result.best_metric)},
            "quarantined": quarantined_all,
            "data_coverage": self.train_ingest.coverage_fraction,
            "ingest": {
                "train": self.train_ingest.summary(),
                "validate": (self.validate_ingest.summary()
                             if self.validate_ingest is not None
                             else None)},
            "grid": [
                {"description": desc,
                 "quarantined": result.quarantined,
                 "states": [
                     {"iteration": s.iteration,
                      "coordinate": s.coordinate_id,
                      "objective": _finite(s.objective),
                      "seconds": round(float(s.seconds), 3),
                      "convergence_counts": (
                          s.tracker.counts_by_convergence()
                          if hasattr(s.tracker, "counts_by_convergence")
                          else None),
                      "validation_metrics": (
                          None if s.validation_metrics is None else
                          {k: _finite(v)
                           for k, v in s.validation_metrics.items()})}
                     for s in result.states]}
                for desc, result in results],
        }
        with open(os.path.join(ns.output_dir, "metrics.json"), "w") as fh:
            json.dump(record, fh, indent=1)

        output_mode = ns.model_output_mode or ModelOutputMode.ALL
        if output_mode != ModelOutputMode.NONE:
            with timed_phase("saveModels", self.logger, self.phase_seconds,
                             span=False):
                vocabs = dict(self.train_data.id_vocabs)
                save_game_model(
                    best_result.best_model or best_result.model,
                    os.path.join(ns.output_dir, "best"), self.index_maps,
                    entity_vocabs=vocabs,
                    num_output_files=(
                        ns.num_output_files_for_random_effect_model),
                    task=self.task)
                if output_mode == ModelOutputMode.ALL:
                    for gi, (_, result) in enumerate(results):
                        save_game_model(
                            result.model,
                            os.path.join(ns.output_dir, "output",
                                         f"grid-{gi}"),
                            self.index_maps, entity_vocabs=vocabs,
                            num_output_files=(
                                ns.num_output_files_for_random_effect_model),
                            task=self.task)
        self.best_result = best_result
        return best_result


def run(argv: Optional[Sequence[str]] = None) -> GameTrainingDriver:
    """Run the driver; returns it (``best_result``, ``phase_seconds``; the
    models and ``metrics.json`` are on disk). A recognized terminal
    condition (an unported flag, shard loss over budget, an all-corrupt
    checkpoint directory, an unrecovered injected fault, a
    KeyboardInterrupt) ends the run with the ``PHOTON_ABORT`` line and
    exit code 3; a graceful stop with the ``PHOTON_PREEMPTED`` line and
    exit code 75; a missing CUDA device raises ``RuntimeError``."""
    ns = parse_args(list(argv) if argv is not None else sys.argv[1:])
    try:
        check_unported(ns)
    except clean_abort_types() as e:
        raise clean_abort(e) from None
    resolve_device(ns.device)
    driver = GameTrainingDriver(ns)
    # graceful stop: SIGTERM/SIGINT latch the flag (a second delivery
    # forces), --max-train-seconds counts from now (ingest included),
    # --stop-file is polled at commit barriers
    stop = StopController(max_train_seconds=ns.max_train_seconds,
                          stop_file=ns.stop_file)
    stop.install_signal_handlers()
    driver.stop = stop
    obs_run = start_observed_run_from_flags(ns, warn=driver.logger.warn)
    try:
        driver.run()
    except clean_abort_types() as e:
        if obs_run is not None:  # the run_end record says why it ended
            obs_run.set_exit_status("abort",
                                    reason=f"{type(e).__name__}: {e}")
        raise clean_abort(e, log=driver.logger.error) from None
    except PreemptionRequested as e:
        # the final snapshot is on disk: drain the telemetry with status
        # "preempted" and exit 75 so a supervisor requeues
        if obs_run is not None:
            obs_run.set_exit_status("preempted",
                                    reason=f"{e.reason} step={e.step}")
        raise preempted_exit(e, log=driver.logger.warn) from None
    except KeyboardInterrupt:
        if obs_run is not None:
            obs_run.set_exit_status("abort", reason="KeyboardInterrupt")
        raise clean_abort(KeyboardInterrupt("interrupted by operator"),
                          log=driver.logger.error) from None
    except Exception as e:
        driver.logger.error(f"GAME training failed: {e}")
        if obs_run is not None:
            obs_run.set_exit_status("error",
                                    reason=f"{type(e).__name__}: {e}")
        raise
    finally:
        stop.uninstall_signal_handlers()
        if obs_run is not None:
            obs_run.finish()
        driver.logger.close()
    return driver


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Command-line entry point: :func:`run`, returning nothing (a console
    script exits with what ``main`` returns)."""
    run(argv)


if __name__ == "__main__":
    main()
