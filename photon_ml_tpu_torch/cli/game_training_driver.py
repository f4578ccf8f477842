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
reduction stay f32. The device mesh (``:763-790``): the driver builds
the default mesh over every visible device of ``--device``'s type
(``parallel/mesh.setup_default_mesh``; one card or the CPU gives none),
with ``--re-entity-shards`` devices on the entity axis (``auto``: all of
them; a count that does not divide the devices falls back to the largest
divisor, and the manifest records the granted count), the rest on the
data axis. Fixed-effect solves then split their rows over the data axis
(with the sharded weight update when the entity axis is > 1, ``:580``),
random-effect blocks are padded to the entity axis and solved over it,
and ``--collective-quant int8`` ships the sharded collectives in int8.
Multi-process runs (``:882-1182``): ``--num-processes N`` with
``--process-id``, ``--coordinator host:port`` (``--coordinator-timeout``
bounds the gang's formation, ``--heartbeat-timeout`` every collective)
runs this process as one member of a gang over ``torch.distributed``
(``parallel/multihost.run_game_worker``) on its round-robin share of the
part files; the configuration is checked first, with the JAX driver's
refusals and messages (:func:`_check_multihost_args`), and each member
writes ``game-training.p<i>.log`` and ``multihost_result.p<i>.npz``,
prints ``MULTIHOST_GAME_OK``, and exits 75 on a gang stop.
``--max-worker-restarts`` (with ``--worker-backoff-base`` and
``--worker-backoff-max``) re-execs the member as a supervised child and
relaunches it with bounded backoff. A member on the card uses
``cuda:<process id % device count>``. ``check_unported`` refuses nothing
now; it stays the hook for a flag the port takes before it runs it. The
telemetry flags
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
    AUTO_ENTITY_SHARDS,
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
from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ENTITY_AXIS,
    get_default_mesh,
    largest_entity_divisor,
    set_default_mesh,
    setup_default_mesh,
    visible_devices,
)
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
    feature the port does not run yet: none is left."""
    refuse_unported(ns, [])


class GameTrainingDriver:
    """cli/game/training/Driver.scala analog, one process, on ``device``."""

    def __init__(self, ns: argparse.Namespace,
                 logger: Optional[PhotonLogger] = None):
        check_unported(ns)
        if ns.num_processes <= 1:  # a gang member has its own entity axis
            resolve_entity_shards(ns)
        self.ns = ns
        self.device = resolve_device(ns.device)
        # the granted entity axis (``run`` builds the mesh)
        self._entity_shards = 1
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
        #: a gang member's result (``parallel/multihost.run_game_worker``)
        self.multihost_result: Optional[dict] = None

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
        quant = self.ns.collective_quant
        shards = self._entity_shards
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
                            self.ns.compute_variance),
                        # with entity sharding on, the data-axis shards
                        # also split the weight update (engages only on a
                        # data axis > 1)
                        shard_weight_update=shards > 1,
                        collective_quant=quant))
            elif cid in self.random_data_configs and cid in factored_cfgs:
                re_cfg, latent_cfg, mf_cfg = factored_cfgs[cid]
                coords[cid] = FactoredRandomEffectCoordinate(
                    dataset=build_random_effect_dataset(
                        self.train_data, self.random_data_configs[cid],
                        dtype=dtype, device=self.device),
                    problem=RandomEffectOptimizationProblem(
                        config=re_cfg, task=self.task,
                        lane_compaction_chunk=self._lane_chunk(),
                        collective_quant=quant),
                    latent_problem=GLMOptimizationProblem(
                        config=latent_cfg, task=self.task,
                        collective_quant=quant),
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
                        dtype=dtype, device=self.device,
                        entity_axis_size=shards)
                else:
                    ds = build_random_effect_dataset(
                        self.train_data, data_cfg, num_buckets=num_buckets,
                        dtype=dtype, device=self.device,
                        entity_axis_size=shards)
                coords[cid] = RandomEffectCoordinate(
                    dataset=ds, problem=RandomEffectOptimizationProblem(
                        config=random_cfgs.get(
                            cid, GLMOptimizationConfiguration()),
                        task=self.task,
                        lane_compaction_chunk=self._lane_chunk(),
                        entity_shards=shards, collective_quant=quant))
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
        """Train, select and write the models, on the default mesh this
        run builds (the one that was installed before is put back)."""
        prev_mesh = get_default_mesh()
        try:
            return self._run()
        finally:
            set_default_mesh(prev_mesh)

    def _setup_mesh(self) -> None:
        """``--re-entity-shards`` devices on the entity axis (resolved by
        :func:`resolve_entity_shards`), the rest on the data axis
        (``:763-790``); the granted entity axis goes to the
        ``re_entity_shards`` gauge."""
        mesh = setup_default_mesh(num_entity=int(self.ns.re_entity_shards),
                                  device=self.device)
        self._entity_shards = (int(mesh.shape[ENTITY_AXIS])
                               if mesh is not None else 1)
        REGISTRY.gauge("re_entity_shards").set(self._entity_shards)
        if mesh is not None:
            self.logger.info(
                f"device mesh: data={mesh.shape[DATA_AXIS]} x "
                f"entity={self._entity_shards} over "
                f"{len(mesh.distinct_devices())} device(s)")

    def _run(self) -> CoordinateDescentResult:
        ns = self.ns
        self._setup_mesh()
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


def resolve_entity_shards(ns: argparse.Namespace) -> None:
    """Set ``ns.re_entity_shards`` to the entity axis the mesh will grant:
    ``auto`` is every visible device of ``--device``'s type, and a count
    that does not divide them falls back to the largest divisor. The run
    manifest then records the granted count (``:1200-1213``); raises
    ``RuntimeError`` for CUDA without it."""
    n_dev = len(visible_devices(ns.device))
    requested = (n_dev if ns.re_entity_shards == AUTO_ENTITY_SHARDS
                 else ns.re_entity_shards)
    ns.re_entity_shards = largest_entity_divisor(n_dev, max(1, requested))


def _check_multihost_args(ns: argparse.Namespace) -> None:
    """The multi-process configuration check (``:882-959``), run before
    any worker or supervisor starts: a configuration error fails at once
    with the JAX driver's message instead of spending a supervisor's
    restart budget. Flags the multi-process path does not run are
    refused, as in the JAX driver; ``--checkpoint-dir`` is taken (process
    0 owns the snapshots)."""
    if not ns.coordinator:
        raise ValueError(
            "--coordinator host:port is required with --num-processes > 1")
    if not (ns.feature_name_and_term_set_path
            or getattr(ns, "offheap_indexmap_dir", None)):
        raise ValueError(
            "multi-host mode needs pre-built feature maps: pass "
            "--feature-name-and-term-set-path or --offheap-indexmap-dir "
            "(every process must hold identical maps)")
    unsupported = []
    # the default (None) is no request for model output; only an
    # explicit ALL/BEST is refused
    if ns.model_output_mode not in (None, ModelOutputMode.NONE):
        unsupported.append(
            f"--model-output-mode {ns.model_output_mode} (only NONE: "
            f"results are written as multihost_result.p<i>.npz, not avro "
            f"model dirs)")
    if ns.validate_input_dirs:
        unsupported.append("--validate-input-dirs")
    if ns.evaluator_type.strip():
        unsupported.append("--evaluator-type")
    if ns.recovery_policy != "none":
        unsupported.append(
            "--recovery-policy (divergence recovery is wired into the "
            "single-process coordinate-descent loop only)")
    if ns.re_lane_compaction_chunk != 0:  # 0 is "off"; auto (-1) counts
        unsupported.append(
            "--re-lane-compaction-chunk (lane compaction gathers active "
            "lanes with per-chunk host round-trips; the multi-host solve "
            "keeps its entity axis mesh-sharded and runs the "
            "single-dispatch path)")
    if ns.re_entity_shards != 1:  # 1 is "off"; auto counts
        unsupported.append(
            "--re-entity-shards (the multi-host worker already shards its "
            "entity axis over the global mesh via GSPMD; the explicit "
            "shard_map path is wired into the single-process driver only)")
    if ns.cd_block_size != 1:
        unsupported.append(
            "--cd-block-size (the multi-host worker runs its own "
            "gang-synchronous CD loop; block-parallel sweeps are wired "
            "into the single-process coordinate-descent loop only)")
    if ns.cd_pipeline_depth is not None:
        unsupported.append(
            "--cd-pipeline-depth (the multi-host worker runs its own "
            "gang-synchronous CD loop; there is no per-coordinate "
            "dispatch pipeline to configure there)")
    if ns.max_shard_loss_frac > 0:
        unsupported.append(
            "--max-shard-loss-frac (shard quarantine is wired into the "
            "single-process ingest; the multi-host workers must all "
            "agree on the surviving row set, which needs a gang-level "
            "coverage consensus that does not exist yet)")
    if unsupported:
        raise ValueError(
            "multi-host mode (--num-processes > 1) does not support: "
            + "; ".join(unsupported))
    if ns.checkpoint_dir and ns.process_id == 0 \
            and os.path.isdir(ns.checkpoint_dir):
        # an all-corrupt directory is terminal: refuse it here, before a
        # supervisor spends its restarts on it (process 0 alone reads it)
        CheckpointManager(ns.checkpoint_dir).raise_if_all_corrupt()


def _run_multihost(ns: argparse.Namespace) -> GameTrainingDriver:
    """This process as one member of a multi-process run (``:962-1120``):
    its round-robin share of the part files, the gang loop of
    ``parallel/multihost.run_game_worker`` on its device, one
    ``multihost_result.p<i>.npz`` with the JAX keys and the
    ``MULTIHOST_GAME_OK`` line; a gang stop exits 75 on every member.
    Returns the driver, with ``multihost_result``."""
    from photon_ml_tpu_torch.io.avro import expand_part_paths
    from photon_ml_tpu_torch.parallel.multihost import (
        gang_device,
        run_game_worker,
    )

    device = gang_device(ns.device, ns.process_id)  # no CUDA: RuntimeError
    os.makedirs(ns.output_dir, exist_ok=True)
    driver = GameTrainingDriver(ns, logger=PhotonLogger(
        os.path.join(ns.output_dir,
                     f"game-training.p{ns.process_id}.log"), echo=False))
    # any member's signal, deadline or stop file stops the whole gang at
    # one coordinate (the flags are all-gathered at each committed update)
    stop = StopController(max_train_seconds=ns.max_train_seconds,
                          stop_file=ns.stop_file)
    stop.install_signal_handlers()
    # each member writes its own trace.<i>.json / metrics.<i>.jsonl; a
    # relaunched member keeps the crashed one's records
    obs_run = start_observed_run_from_flags(
        ns, process_index=ns.process_id, num_processes=ns.num_processes,
        warn=driver.logger.warn,
        preserve_existing=bool(os.environ.get(_SUPERVISED_ENV)))
    try:
        with timed_phase("prepareFeatureMaps", driver.logger,
                         driver.phase_seconds):
            driver.prepare_feature_maps()
        fixed_ids = [c for c in driver.updating_sequence
                     if c in driver.fixed_data_configs]
        re_ids = [c for c in driver.updating_sequence
                  if c in driver.random_data_configs]
        if len(fixed_ids) != 1 or not re_ids:
            raise ValueError(
                "multi-host mode needs exactly one fixed coordinate and "
                "at least one random-effect coordinate (plain or "
                "factored)")
        if (len(driver.fixed_opt_grid) > 1 or len(driver.random_opt_grid) > 1
                or len(driver.factored_grid) > 1):
            raise ValueError("multi-host mode supports a single grid point")
        f_cid = fixed_ids[0]
        f_opt = driver.fixed_opt_grid[0].get(
            f_cid, GLMOptimizationConfiguration())
        random_coordinates = [
            (cid, driver.random_data_configs[cid],
             driver.random_opt_grid[0].get(
                 cid, GLMOptimizationConfiguration()),
             driver.factored_grid[0].get(cid))
            for cid in re_ids]
        if not 0 <= ns.process_id < ns.num_processes:
            raise ValueError(
                f"--process-id {ns.process_id} out of range for "
                f"--num-processes {ns.num_processes}")
        files = expand_part_paths(resolve_input_paths(
            ns.train_input_dirs, ns.train_date_range,
            ns.train_date_range_days_ago))
        local_files = files[ns.process_id::ns.num_processes]
        if not local_files:
            raise ValueError(
                f"process {ns.process_id} received no part files "
                f"({len(files)} file(s) across {ns.num_processes} "
                "processes)")
        driver.logger.info(
            f"process {ns.process_id}/{ns.num_processes}: "
            f"{len(local_files)} of {len(files)} part file(s)")
        result = run_game_worker(
            ns.process_id, ns.num_processes, ns.coordinator, local_files,
            driver.section_keys, driver.index_maps,
            (f_cid, driver.fixed_data_configs[f_cid], f_opt),
            random_coordinates, driver.task,
            num_iterations=ns.num_iterations,
            num_buckets=max(1, int(ns.random_effect_block_buckets)),
            initialization_timeout=ns.coordinator_timeout,
            heartbeat_timeout=ns.heartbeat_timeout,
            checkpoint_dir=ns.checkpoint_dir,
            checkpoint_every_coordinates=ns.checkpoint_every_coordinates,
            # one subdirectory per member: no two write the same memmaps
            blocks_dir=(os.path.join(ns.random_effect_blocks_dir,
                                     f"p{ns.process_id}")
                        if ns.random_effect_blocks_dir else None),
            precision=ns.precision, collective_quant=ns.collective_quant,
            stop=stop, device=device)
        driver.multihost_result = result
        driver.phase_seconds.update(result["seconds"])
        arrays = {
            "fixed": result["fixed"][f_cid],
            "objective": np.asarray(result["objective"]),
            "re_coordinate_ids": np.asarray(
                sorted(result["random_effect"])),
        }
        for cid, table in result["random_effect"].items():
            ids = sorted(table)
            arrays[f"re_ids__{cid}"] = np.asarray(ids)
            arrays[f"re_coefs__{cid}"] = (
                np.stack([table[i] for i in ids])
                if ids else np.zeros((0, 0)))
        np.savez(os.path.join(ns.output_dir,
                              f"multihost_result.p{ns.process_id}.npz"),
                 **arrays)
        print(f"MULTIHOST_GAME_OK process={ns.process_id} "
              f"of={ns.num_processes} devices={result['global_devices']} "
              f"re_entity_axis={result['re_entity_axis_devices']} "
              f"re_coordinates={','.join(sorted(result['random_effect']))} "
              f"rows={result['rows_global']} "
              f"objective={result['objective']:.6f}", flush=True)
    except PreemptionRequested as e:
        # every member raises at the same coordinate, after the snapshot
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
        driver.logger.error(f"multi-host GAME training failed: {e}")
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


#: set in a supervised member's environment
_SUPERVISED_ENV = "PHOTON_GAME_SUPERVISED"


def _run_supervised(ns: argparse.Namespace, argv: Sequence[str]) -> None:
    """Supervise this host's member (``:1123-1167``): re-exec the driver
    as a child and relaunch it with bounded backoff and jitter when it
    fails (a peer's death included: the survivors' collectives raise
    within the heartbeat bound, and every host's supervisor re-forms the
    gang). Restarts go to ``supervisor.p<i>.log`` and the
    ``SUPERVISOR_OK worker=p<i> restarts=<n>`` line."""
    import subprocess

    from photon_ml_tpu_torch.parallel.multihost import (
        SupervisorExhaustedError,
        WorkerSupervisor,
    )

    if torch.device(ns.device).type == "cuda" \
            and not torch.cuda.is_available():
        # refused here, not by every relaunch (no CUDA context is made)
        resolve_device(ns.device)
    os.makedirs(ns.output_dir, exist_ok=True)
    logger = PhotonLogger(
        os.path.join(ns.output_dir, f"supervisor.p{ns.process_id}.log"),
        echo=False)
    name = f"worker p{ns.process_id}"

    def spawn(attempt: int):
        env = dict(os.environ)
        env[_SUPERVISED_ENV] = "1"
        logger.info(f"{name}: launch attempt {attempt}")
        return subprocess.Popen(
            [sys.executable, "-m",
             "photon_ml_tpu_torch.cli.game_training_driver", *argv],
            env=env)

    sup = WorkerSupervisor(
        spawn, max_restarts=ns.max_worker_restarts,
        backoff_base_seconds=ns.worker_backoff_base,
        backoff_max_seconds=ns.worker_backoff_max,
        name=name, log=logger.warn)
    try:
        restarts = sup.run()
    except SupervisorExhaustedError as e:
        logger.error(f"{name}: {e}")
        logger.close()
        raise SystemExit(
            f"multi-host worker process {ns.process_id} failed permanently "
            f"after {e.restarts} restart(s); see the per-process driver "
            f"log under {ns.output_dir}") from e
    logger.info(f"{name}: completed with {restarts} restart(s)")
    logger.close()
    print(f"SUPERVISOR_OK worker=p{ns.process_id} restarts={restarts}",
          flush=True)


def run(argv: Optional[Sequence[str]] = None
        ) -> Optional[GameTrainingDriver]:
    """Run the driver; returns it (``best_result``, ``phase_seconds``; the
    models and ``metrics.json`` are on disk). A recognized terminal
    condition (shard loss over budget, an all-corrupt checkpoint
    directory, an unrecovered injected fault, a KeyboardInterrupt) ends
    the run with the ``PHOTON_ABORT`` line and exit code 3; a graceful
    stop with the ``PHOTON_PREEMPTED`` line and exit code 75; a missing
    CUDA device raises ``RuntimeError``. With ``--num-processes`` > 1 this
    process is one member of a gang (:func:`_run_multihost`; its driver
    is returned), or, with ``--max-worker-restarts``, the member's
    supervisor (None is returned)."""
    argv = list(argv) if argv is not None else sys.argv[1:]
    ns = parse_args(argv)
    try:
        check_unported(ns)
    except clean_abort_types() as e:
        raise clean_abort(e) from None
    if ns.num_processes > 1:
        _check_multihost_args(ns)
        if ns.max_worker_restarts > 0 and not os.environ.get(
                _SUPERVISED_ENV):
            return _run_supervised(ns, argv)
        return _run_multihost(ns)
    driver = GameTrainingDriver(ns)
    # graceful stop: SIGTERM/SIGINT latch the flag (a second delivery
    # forces), --max-train-seconds counts from now (ingest included),
    # --stop-file is polled at commit barriers
    stop = StopController(max_train_seconds=ns.max_train_seconds,
                          stop_file=ns.stop_file)
    stop.install_signal_handlers()
    driver.stop = stop
    # under a supervisor (photon_ml_tpu_torch/tools/photon_supervise.py or
    # the multi-process re-exec), a relaunched incarnation rotates the
    # previous one's telemetry to .prev instead of truncating the evidence
    obs_run = start_observed_run_from_flags(
        ns, warn=driver.logger.warn,
        preserve_existing=bool(os.environ.get(_SUPERVISED_ENV)))
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
