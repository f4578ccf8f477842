"""GAME scoring driver: load model -> score dataset -> save scores -> evaluate.

Port of ``photon_ml_tpu/cli/game_scoring_driver.py`` — ``parse_args``
(``:46-112``), ``GameScoringDriver`` (``:114-241``) and ``main`` for one
process (reference: cli/game/scoring/Driver.scala:45-246): feature maps
and model through ``serve/scoring.py``, the dataset with optional
responses, the summed coordinate score on ``--device``,
``scores/part-00000.avro`` (ScoringResultAvro) and, when every row has a
response, the evaluators with one device fetch.

The flags are the JAX driver's plus ``--device`` (default ``cuda``).
``--max-shard-loss-frac`` quarantines corrupt or unreadable part files
within its budget, as the JAX driver does (``:196-213``); over it the run
ends with exit 3. ``--offheap-indexmap-dir`` reads the feature maps
from a pre-built off-heap store (``--offheap-indexmap-num-partitions``
must match it; ``:75-79``, ``:160-165``). The telemetry flags run as
in the JAX driver (``:243-279``): ``--trace-dir`` writes the run's trace
directory (``obs/run.py``), and ``run_end`` records how the run ended,
also on exit 3. ``--num-processes N`` with ``--process-id i``
(``:133-196``) scores the i-th round-robin share of the part files into
``scores/part-<i>.avro``; scoring is per row, so the processes need no
coordination. Evaluators (they need every score) and
``--delete-output-dir-if-exists`` (it would delete the other processes'
parts) are refused there, before the output directory is touched.
``check_unported`` refuses nothing now.
"""

from __future__ import annotations

import argparse
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
)
from photon_ml_tpu_torch.cli.args import (
    add_device_flag,
    add_observability_flags,
    check_telemetry_flags,
    parse_key_value_map,
    parse_section_keys_map,
    refuse_unported,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation.evaluators import (
    EvaluatorSpec,
    evaluate_many,
    resolve_entity_ids,
)
from photon_ml_tpu_torch.io.avro import expand_part_paths
from photon_ml_tpu_torch.io.data_format import load_game_dataset_avro
from photon_ml_tpu_torch.io.model_io import save_scored_items
from photon_ml_tpu_torch.obs.run import start_observed_run_from_flags
from photon_ml_tpu_torch.serve.scoring import (
    load_scoring_model,
    resolve_index_maps,
    score_game_dataset,
)
from photon_ml_tpu_torch.utils import parse_flag
from photon_ml_tpu_torch.utils.date_range import resolve_input_paths
from photon_ml_tpu_torch.utils.logging import PhotonLogger, timed_phase


def parse_args(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="game-scoring-torch",
                                description="GAME scoring on the GPU")
    p.add_argument("--input-data-dirs", required=True,
                   help="comma-separated input dirs/files")
    p.add_argument("--date-range")
    p.add_argument("--date-range-days-ago")
    p.add_argument("--game-model-input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-name-and-term-set-path")
    p.add_argument("--feature-shard-id-to-feature-section-keys-map",
                   required=True)
    p.add_argument("--feature-shard-id-to-intercept-map", default="")
    p.add_argument("--random-effect-id-set", default="",
                   help="comma-separated id types present in the data")
    p.add_argument("--max-shard-loss-frac", type=float, default=0.0)
    p.add_argument("--evaluator-type", default="")
    p.add_argument("--model-id", default="")
    p.add_argument("--delete-output-dir-if-exists", default="false")
    p.add_argument("--application-name", default="game-scoring")
    p.add_argument("--offheap-indexmap-dir")
    p.add_argument("--offheap-indexmap-num-partitions", type=int,
                   default=None)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    add_observability_flags(p)
    add_device_flag(p)
    ns = p.parse_args(argv)
    check_telemetry_flags(p, ns)
    return ns


def check_unported(ns: argparse.Namespace) -> None:
    """``NotImplementedError`` for a flag the port does not run yet: none
    is left."""
    refuse_unported(ns, [])


def check_process_split(ns: argparse.Namespace, evaluators) -> None:
    """The multi-process refusals (``:133-148``), before any output-dir
    handling: the output directory is shared by every process."""
    if ns.num_processes <= 1:
        return
    if evaluators:
        raise ValueError(
            "evaluators need the full score set; run them on the "
            "combined output, not under --num-processes > 1")
    if not 0 <= ns.process_id < ns.num_processes:
        raise ValueError(
            f"--process-id {ns.process_id} out of range for "
            f"--num-processes {ns.num_processes}")
    if parse_flag(ns.delete_output_dir_if_exists):
        raise ValueError(
            "--delete-output-dir-if-exists would delete other "
            "processes' score parts; clear the output dir once "
            "before launching the processes")


class GameScoringDriver:
    """cli/game/scoring/Driver.scala analog, one process, on ``device``."""

    def __init__(self, ns: argparse.Namespace,
                 logger: Optional[PhotonLogger] = None):
        check_unported(ns)
        self.ns = ns
        self.device = resolve_device(ns.device)
        self.logger = logger or PhotonLogger(
            os.path.join(ns.output_dir, "game-scoring.log"), echo=False)
        self.section_keys = parse_section_keys_map(
            ns.feature_shard_id_to_feature_section_keys_map)
        self.intercept_map = {
            k: parse_flag(v)
            for k, v in parse_key_value_map(
                ns.feature_shard_id_to_intercept_map).items()}
        self.evaluators = [EvaluatorSpec.parse(x)
                           for x in ns.evaluator_type.split(",")
                           if x.strip()]
        #: metric name -> value of the last run (empty without evaluators)
        self.metrics: dict[str, float] = {}
        #: phase name -> wall seconds of the last run
        self.phase_seconds: dict[str, float] = {}
        #: the IngestPolicy of the last load
        self.ingest = None

    def run(self) -> np.ndarray:
        ns = self.ns
        check_process_split(ns, self.evaluators)
        if os.path.isdir(ns.output_dir) and os.listdir(ns.output_dir) \
                and parse_flag(ns.delete_output_dir_if_exists):
            shutil.rmtree(ns.output_dir)
        os.makedirs(ns.output_dir, exist_ok=True)

        index_maps = resolve_index_maps(
            self.section_keys, self.intercept_map,
            feature_set_path=ns.feature_name_and_term_set_path,
            offheap_dir=ns.offheap_indexmap_dir,
            offheap_partitions=ns.offheap_indexmap_num_partitions)
        with timed_phase("loadModel", self.logger, self.phase_seconds):
            model, index_maps = load_scoring_model(
                ns.game_model_input_dir, index_maps)
        self.logger.info(f"model coordinates: {model.coordinate_ids}")

        id_types = sorted(
            {x.strip() for x in ns.random_effect_id_set.split(",")
             if x.strip()}
            | {e.id_type for e in self.evaluators if e.id_type})
        input_paths = resolve_input_paths(ns.input_data_dirs, ns.date_range,
                                          ns.date_range_days_ago)
        if ns.num_processes > 1:
            # this process's round-robin share of the part files
            files = expand_part_paths(input_paths)
            input_paths = files[ns.process_id::ns.num_processes]
            if not input_paths:
                raise ValueError(
                    f"process {ns.process_id} received no part files "
                    f"({len(files)} file(s) across {ns.num_processes})")
            self.logger.info(
                f"process {ns.process_id}/{ns.num_processes}: scoring "
                f"{len(input_paths)} of {len(files)} part file(s)")
        with timed_phase("prepareGameDataSet", self.logger,
                         self.phase_seconds):
            self.ingest = build_ingest_policy(
                ns.max_shard_loss_frac,
                events=build_event_bus(self.logger.warn),
                warn=self.logger.warn)
            data = load_game_dataset_avro(
                input_paths, self.section_keys, index_maps,
                id_types=id_types, response_required=False,
                policy=self.ingest)
            self.ingest.finish(log=self.logger.warn)
        self.logger.info(
            f"scoring {data.num_samples} samples (data coverage "
            f"{self.ingest.coverage_fraction:.1%})")

        with timed_phase("scoreGameDataSet", self.logger,
                         self.phase_seconds):
            scores = score_game_dataset(model, data, device=self.device)

        with timed_phase("saveScores", self.logger, self.phase_seconds,
                         span=False):
            save_scored_items(
                os.path.join(ns.output_dir, "scores",
                             f"part-{ns.process_id:05d}.avro"),
                scores, ns.model_id or "game-model", uids=data.uids,
                labels=(data.responses
                        if np.isfinite(data.responses).any() else None),
                weights=data.weights)

        if self.evaluators and np.isfinite(data.responses).all():
            f32 = dict(dtype=torch.float32, device=self.device)
            ids_by_type, num_by_type = resolve_entity_ids(
                self.evaluators, data.id_columns, data.id_vocabs,
                self.device)
            self.metrics = evaluate_many(
                self.evaluators, torch.as_tensor(scores, **f32),
                torch.as_tensor(data.responses, **f32),
                torch.as_tensor(data.weights, **f32),
                entity_ids_by_type=ids_by_type,
                num_entities_by_type=num_by_type)
            for spec in self.evaluators:
                self.logger.info(
                    f"evaluation {spec.name}: {self.metrics[spec.name]:.6f}")
        return scores


def run(argv: Optional[Sequence[str]] = None) -> GameScoringDriver:
    """Run the driver; returns it (scores are on disk, metrics in
    ``driver.metrics``). A recognized terminal condition (shard loss over
    budget, a KeyboardInterrupt) ends the run with the ``PHOTON_ABORT``
    line and exit code 3; a missing CUDA device raises ``RuntimeError``;
    a refused process split raises ``ValueError`` before any output."""
    ns = parse_args(list(argv) if argv is not None else sys.argv[1:])
    try:
        check_unported(ns)
    except clean_abort_types() as e:
        raise clean_abort(e) from None
    resolve_device(ns.device)
    check_process_split(ns, [x for x in ns.evaluator_type.split(",")
                             if x.strip()])
    driver = GameScoringDriver(ns)
    obs_run = start_observed_run_from_flags(
        ns, process_index=ns.process_id, num_processes=ns.num_processes,
        warn=driver.logger.warn)
    try:
        driver.run()
    except clean_abort_types() as e:
        if obs_run is not None:  # the run_end record says why it ended
            obs_run.set_exit_status("abort",
                                    reason=f"{type(e).__name__}: {e}")
        raise clean_abort(e, log=driver.logger.error) from None
    except KeyboardInterrupt:
        if obs_run is not None:
            obs_run.set_exit_status("abort", reason="KeyboardInterrupt")
        raise clean_abort(KeyboardInterrupt("interrupted by operator"),
                          log=driver.logger.error) from None
    except Exception as e:
        driver.logger.error(f"GAME scoring failed: {e}")
        if obs_run is not None:
            obs_run.set_exit_status("error",
                                    reason=f"{type(e).__name__}: {e}")
        raise
    finally:
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
