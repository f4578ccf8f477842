"""Legacy single-GLM training driver: preprocess -> train -> validate ->
diagnose -> output, on the card.

Port of ``photon_ml_tpu/cli/legacy_driver.py`` — ``DriverStage``,
``DiagnosticMode``, ``LegacyParams`` (``:105-161``), ``parse_args``
(``:164-252``), ``LegacyDriver`` (``:255-665``) and ``main`` (reference:
Driver.scala:142-638):

- preprocess: the Avro (native columnar, else records) or LibSVM (native
  parser) input, ``sanity_check_data``, the feature summary (optionally
  written as FeatureSummarizationResultAvro), the normalization context
  and the box constraints;
- train: ``train_glm_grid`` over the weights, descending and warm-started,
  every objective evaluation on the card through the fused kernel above
  its gate;
- validate: the metric maps of the whole grid in one evaluation, the best
  weight, and with ``--validate-per-iteration`` the metrics of every
  iterate of a solve, its iterate stack evaluated as one more grid;
- diagnose: the fitting (10 partitions) and bootstrap (4 samples at 0.75)
  diagnostics by refits of the grid, Hosmer-Lemeshow, feature importance
  and prediction-error independence on the validation split, rendered as
  ``diagnostic-report.html`` and ``.txt``;
- output: the TSV models of every weight under ``output/``, the best one
  under ``best/``, and ``metrics.json``.

The flags are the JAX driver's, so one argv runs either package; the
Spark-era flags are accepted and ignored, and ``--device`` is added
(default ``cuda``; no fallback to the CPU). ``--offheap-indexmap-dir``
reads the Avro input's feature map from the ``global`` namespace of a
pre-built off-heap store instead of scanning the data, and
``--offheap-indexmap-num-partitions`` must match the store
(``:204-205``, ``:299-308``). An input wider than 4,096 columns trains
as an ELL batch (``csr_to_batch``), whose margins go through
``batch.margins`` and whose grid metrics through the ELL form of
``evaluate_model_grid``; the validation batch is built once
(``_validation_batch``), since an ELL pack is not free.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.cli import clean_abort, clean_abort_types
from photon_ml_tpu_torch.cli.args import add_device_flag
from photon_ml_tpu_torch.data.validators import (
    DataValidationType,
    sanity_check_data,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.diagnostics import diagnostics as diag
from photon_ml_tpu_torch.diagnostics.reporting import render_html, render_text
from photon_ml_tpu_torch.diagnostics.transformers import (
    build_diagnostic_document,
)
from photon_ml_tpu_torch.evaluation.model_evaluation import (
    evaluate_model_grid,
    select_best_model,
)
from photon_ml_tpu_torch.game.dataset import csr_to_batch
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro import write_container
from photon_ml_tpu_torch.io.data_format import (
    RESPONSE_PREDICTION_FIELD_NAMES,
    TRAINING_EXAMPLE_FIELD_NAMES,
    InputFormatType,
    LabeledData,
    load_labeled_points_avro,
    load_libsvm,
    parse_constraint_map,
)
from photon_ml_tpu_torch.io.index_map import OffHeapIndexMap
from photon_ml_tpu_torch.io.model_io import write_models_text
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationContext,
    NormalizationType,
)
from photon_ml_tpu_torch.optimize.common import BoxConstraints
from photon_ml_tpu_torch.optimize.config import (
    OptimizerType,
    RegularizationContext,
    RegularizationType,
    TaskType,
)
from photon_ml_tpu_torch.parallel.mesh import (
    get_default_mesh,
    set_default_mesh,
    setup_default_mesh,
)
from photon_ml_tpu_torch.stat.summary import summarize
from photon_ml_tpu_torch.training import TrainedModel, train_glm_grid
from photon_ml_tpu_torch.utils import parse_flag
from photon_ml_tpu_torch.utils.events import (
    EventEmitter,
    PhotonOptimizationLogEvent,
    PhotonSetupEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_tpu_torch.utils.logging import PhotonLogger, timed_phase


class DriverStage:
    """DriverStage.scala analog: ordered pipeline stages."""

    INIT = ("INIT", 0)
    PREPROCESSED = ("PREPROCESSED", 1)
    TRAINED = ("TRAINED", 2)
    VALIDATED = ("VALIDATED", 3)
    DIAGNOSED = ("DIAGNOSED", 4)


class DiagnosticMode:
    """diagnostics/DiagnosticMode.scala: NONE / TRAIN / VALIDATE / ALL."""

    NONE = "NONE"
    TRAIN = "TRAIN"
    VALIDATE = "VALIDATE"
    ALL = "ALL"


@dataclasses.dataclass
class LegacyParams:
    """Params.scala:40-195 analog (typed, validated)."""

    training_data_directory: str
    output_directory: str
    task: TaskType = TaskType.LOGISTIC_REGRESSION
    validating_data_directory: Optional[str] = None
    job_name: str = "photon-ml-tpu"
    regularization_weights: Sequence[float] = (10.0,)
    intercept: bool = True
    num_iterations: int = 80
    convergence_tolerance: float = 1e-6
    optimizer: OptimizerType = OptimizerType.LBFGS
    regularization_type: RegularizationType = RegularizationType.L2
    elastic_net_alpha: float = 0.5
    format: str = "TRAINING_EXAMPLE"  # or RESPONSE_PREDICTION
    input_file_format: InputFormatType = InputFormatType.AVRO
    feature_dimension: int = -1  # LibSVM only
    normalization_type: NormalizationType = NormalizationType.NONE
    coefficient_box_constraints: Optional[str] = None
    data_validation_type: DataValidationType = \
        DataValidationType.VALIDATE_DISABLED
    diagnostic_mode: str = DiagnosticMode.NONE
    selected_features_file: Optional[str] = None
    summarization_output_dir: Optional[str] = None
    validate_per_iteration: bool = False
    compute_variance: bool = False
    delete_output_dirs_if_exist: bool = False
    event_listeners: Sequence[str] = ()
    offheap_indexmap_dir: Optional[str] = None
    offheap_indexmap_num_partitions: Optional[int] = None
    device: str = "cuda"

    def validate(self) -> None:
        """Params.validate :201 analog."""
        errors = []
        if (self.regularization_type in (RegularizationType.L1,
                                         RegularizationType.ELASTIC_NET)
                and self.optimizer == OptimizerType.TRON):
            errors.append(
                f"TRON cannot be used with "
                f"{self.regularization_type.name} regularization")
        if (self.diagnostic_mode in (DiagnosticMode.VALIDATE,
                                     DiagnosticMode.ALL)
                and not self.validating_data_directory):
            errors.append(
                f"Diagnostic mode cannot be {self.diagnostic_mode} when the "
                f"validate directory is not specified")
        if (self.input_file_format == InputFormatType.LIBSVM
                and self.feature_dimension <= 0):
            errors.append("LIBSVM input requires --feature-dimension")
        if not 0.0 <= self.elastic_net_alpha <= 1.0:
            errors.append("elastic-net-alpha must be in [0, 1]")
        if errors:
            raise ValueError("; ".join(errors))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-ml-tpu-torch",
                                description="Train GLMs on the card")
    p.add_argument("--training-data-directory", required=True)
    p.add_argument("--validating-data-directory")
    p.add_argument("--output-directory", required=True)
    p.add_argument("--job-name", default="photon-ml-tpu")
    p.add_argument("--task", default="LOGISTIC_REGRESSION",
                   choices=[t.name for t in TaskType])
    p.add_argument("--regularization-weights", default="10",
                   help="comma-separated lambda grid")
    p.add_argument("--intercept", default="true")
    p.add_argument("--num-iterations", type=int, default=80)
    p.add_argument("--convergence-tolerance", type=float, default=1e-6)
    p.add_argument("--optimizer", default="LBFGS",
                   choices=[o.name for o in OptimizerType])
    p.add_argument("--regularization-type", default="L2",
                   choices=[r.name for r in RegularizationType])
    p.add_argument("--elastic-net-alpha", type=float, default=0.5)
    p.add_argument("--format", default="TRAINING_EXAMPLE",
                   choices=["TRAINING_EXAMPLE", "RESPONSE_PREDICTION"])
    p.add_argument("--input-file-format", default="AVRO",
                   choices=["AVRO", "LIBSVM"])
    p.add_argument("--feature-dimension", type=int, default=-1)
    p.add_argument("--normalization-type", default="NONE",
                   choices=[n.name for n in NormalizationType])
    p.add_argument("--coefficient-box-constraints")
    p.add_argument("--data-validation-type", default="VALIDATE_DISABLED",
                   choices=[v.name for v in DataValidationType])
    p.add_argument("--diagnostic-mode", default="NONE",
                   choices=["NONE", "TRAIN", "VALIDATE", "ALL"])
    p.add_argument("--selected-features-file")
    p.add_argument("--summarization-output-dir")
    p.add_argument("--validate-per-iteration", default="false")
    p.add_argument("--coefficient-variance", dest="compute_variance",
                   default="false")
    p.add_argument("--delete-output-dirs-if-exist", default="false")
    p.add_argument("--event-listeners", default="")
    p.add_argument("--offheap-indexmap-dir")
    p.add_argument("--offheap-indexmap-num-partitions", type=int,
                   default=None)
    # Spark-era flags: accepted, ignored
    p.add_argument("--kryo", default="true", help=argparse.SUPPRESS)
    p.add_argument("--min-partitions", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--tree-aggregate-depth", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--optimization-tracker", default="true",
                   help=argparse.SUPPRESS)
    add_device_flag(p)
    return p


def parse_args(argv: Sequence[str]) -> LegacyParams:
    """PhotonMLCmdLineParser analog; raises ``ValueError`` for a
    combination the reference refuses (TRON with L1, a validation
    diagnostic without validation data, LibSVM without a dimension)."""
    ns = _parser().parse_args(argv)
    params = LegacyParams(
        training_data_directory=ns.training_data_directory,
        validating_data_directory=ns.validating_data_directory,
        output_directory=ns.output_directory,
        job_name=ns.job_name,
        task=TaskType[ns.task],
        regularization_weights=[float(x) for x in
                                ns.regularization_weights.split(",") if x],
        intercept=parse_flag(ns.intercept),
        num_iterations=ns.num_iterations,
        convergence_tolerance=ns.convergence_tolerance,
        optimizer=OptimizerType[ns.optimizer],
        regularization_type=RegularizationType[ns.regularization_type],
        elastic_net_alpha=ns.elastic_net_alpha,
        format=ns.format,
        input_file_format=InputFormatType[ns.input_file_format],
        feature_dimension=ns.feature_dimension,
        normalization_type=NormalizationType[ns.normalization_type],
        coefficient_box_constraints=ns.coefficient_box_constraints,
        data_validation_type=DataValidationType[ns.data_validation_type],
        diagnostic_mode=ns.diagnostic_mode,
        selected_features_file=ns.selected_features_file,
        summarization_output_dir=ns.summarization_output_dir,
        validate_per_iteration=parse_flag(ns.validate_per_iteration),
        compute_variance=parse_flag(ns.compute_variance),
        delete_output_dirs_if_exist=parse_flag(
            ns.delete_output_dirs_if_exist),
        event_listeners=[x for x in ns.event_listeners.split(",") if x],
        offheap_indexmap_dir=ns.offheap_indexmap_dir,
        offheap_indexmap_num_partitions=ns.offheap_indexmap_num_partitions,
        device=ns.device,
    )
    params.validate()
    return params


class LegacyDriver(EventEmitter):
    """Driver.scala:142-638 analog on ``params.device``."""

    def __init__(self, params: LegacyParams,
                 logger: Optional[PhotonLogger] = None):
        super().__init__()
        self.params = params
        self.device = resolve_device(params.device)
        self.stage = DriverStage.INIT
        self.stage_history: list[tuple[str, int]] = []
        self.logger = logger or PhotonLogger(
            os.path.join(params.output_directory, "photon.log"), echo=False)
        for name in params.event_listeners:
            self.register_listener_by_name(name)
        self.train_data: Optional[LabeledData] = None
        self.validate_data: Optional[LabeledData] = None
        self.summary = None
        self.normalization = NormalizationContext.identity()
        self.box: Optional[BoxConstraints] = None
        self.models: list[TrainedModel] = []
        self.per_lambda_metrics: dict[float, dict[str, float]] = {}
        self.best_lambda: Optional[float] = None
        #: stage name -> wall seconds
        self.phase_seconds: dict[str, float] = {}
        self._vbatch = None

    # -- stages ------------------------------------------------------------

    def _assert_stage(self, expected: tuple[str, int]) -> None:
        if self.stage != expected:
            raise RuntimeError(
                f"expected driver stage {expected[0]}, got {self.stage[0]}")

    def _advance(self, stage: tuple[str, int]) -> None:
        self.stage_history.append(self.stage)
        self.stage = stage

    def _phase(self, name: str):
        return timed_phase(name, self.logger, record=self.phase_seconds)

    def _load(self, path: str) -> LabeledData:
        p = self.params
        if p.input_file_format == InputFormatType.LIBSVM:
            return load_libsvm(path, p.feature_dimension,
                               use_intercept=p.intercept)
        field_names = (TRAINING_EXAMPLE_FIELD_NAMES
                       if p.format == "TRAINING_EXAMPLE"
                       else RESPONSE_PREDICTION_FIELD_NAMES)
        index_map = (self.train_data.index_map
                     if self.train_data is not None else None)
        if index_map is None and p.offheap_indexmap_dir:
            # InputFormatFactory.scala:49-60: the pre-built store replaces
            # the scan of the data for features
            index_map = OffHeapIndexMap(
                p.offheap_indexmap_dir, namespace="global",
                expected_partitions=p.offheap_indexmap_num_partitions)
            self.logger.info(
                f"off-heap index map: {len(index_map)} features from "
                f"{p.offheap_indexmap_dir}")
        return load_labeled_points_avro(
            path, field_names, index_map=index_map,
            selected_features_file=p.selected_features_file,
            add_intercept=p.intercept)

    def _checked(self, path: str, what: str) -> LabeledData:
        data = self._load(path)
        if not sanity_check_data(data.labels, data.offsets, data.features,
                                 self.params.task,
                                 self.params.data_validation_type,
                                 logger=self.logger):
            raise ValueError(f"{what} data failed validation")
        return data

    def preprocess(self) -> None:
        """Driver.preprocess :267: load, sanity-check, summarize."""
        self._assert_stage(DriverStage.INIT)
        p = self.params
        with self._phase("preprocess"):
            self.train_data = self._checked(p.training_data_directory,
                                            "training")
            if p.validating_data_directory:
                self.validate_data = self._checked(
                    p.validating_data_directory, "validation")
            self.summary = summarize(self.train_data.features)
            if p.summarization_output_dir:
                self._write_summary(p.summarization_output_dir)
            self.normalization = NormalizationContext.build(
                p.normalization_type, self.summary,
                intercept_index=self.train_data.index_map.intercept_index,
                device=self.device)
            self.box = BoxConstraints.from_map(
                self.train_data.dim,
                parse_constraint_map(p.coefficient_box_constraints,
                                     self.train_data.index_map),
                device=self.device)
        self._advance(DriverStage.PREPROCESSED)

    def _write_summary(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        s = self.summary
        rows = []
        for key, idx in self.train_data.index_map.items():
            name, _, term = key.partition("\x01")
            rows.append({
                "featureName": name,
                "featureTerm": term,
                "metrics": {
                    "mean": float(s.mean[idx]),
                    "variance": float(s.variance[idx]),
                    "min": float(s.min[idx]),
                    "max": float(s.max[idx]),
                    "meanAbs": float(s.mean_abs[idx]),
                },
            })
        write_container(os.path.join(out_dir, "part-00000.avro"),
                        schemas.FEATURE_SUMMARIZATION_RESULT, rows)

    def _batch(self, data: LabeledData, rows=None):
        """Dense device batch of ``data`` (of its ``rows`` when given)."""
        csr = data.features.tocsr()
        labels, offsets, weights = (np.asarray(data.labels),
                                    np.asarray(data.offsets),
                                    np.asarray(data.weights))
        if rows is not None:
            csr, labels, offsets, weights = (csr[rows], labels[rows],
                                             offsets[rows], weights[rows])
        return csr_to_batch(csr, labels, offsets, weights,
                            device=self.device)

    def _validation_batch(self):
        """The validation split's batch, built once (validate and diagnose
        both read it)."""
        if self._vbatch is None:
            self._vbatch = self._batch(self.validate_data)
        return self._vbatch

    def _grid(self, batch, **kw) -> list[TrainedModel]:
        p = self.params
        return train_glm_grid(
            batch, p.task, p.regularization_weights,
            optimizer_type=p.optimizer,
            regularization_context=RegularizationContext(
                p.regularization_type, p.elastic_net_alpha),
            max_iterations=p.num_iterations,
            tolerance=p.convergence_tolerance,
            normalization=self.normalization, box=self.box, **kw)

    def train(self) -> None:
        """Driver.train :294 -> ModelTraining.trainGeneralizedLinearModel."""
        self._assert_stage(DriverStage.PREPROCESSED)
        p = self.params
        self.send_event(TrainingStartEvent(time.time()))
        with self._phase("train"):
            self.models = self._grid(
                self._batch(self.train_data),
                compute_variances=p.compute_variance,
                # the iterates are read by validate() only
                track_iterates=(p.validate_per_iteration
                                and self.validate_data is not None))
            for tm in self.models:
                self.logger.info(
                    f"lambda={tm.regularization_weight:g} "
                    f"iters={tm.result.iterations} "
                    f"reason={tm.result.convergence_reason}")
        self.send_event(TrainingFinishEvent(time.time()))
        self._advance(DriverStage.TRAINED)

    def validate(self) -> None:
        """Driver.validate :404: per-lambda metrics, the best model."""
        self._assert_stage(DriverStage.TRAINED)
        p = self.params
        if self.validate_data is None:
            self._advance(DriverStage.VALIDATED)
            return
        with self._phase("validate"):
            batch = self._validation_batch()
            metric_maps = evaluate_model_grid(
                [tm.model for tm in self.models], batch)
            for tm, metrics in zip(self.models, metric_maps):
                self.per_lambda_metrics[tm.regularization_weight] = metrics
                self.logger.info(
                    f"lambda={tm.regularization_weight:g} metrics={metrics}")
                per_iteration = None
                if p.validate_per_iteration and tm.result.iterates is not None:
                    per_iteration = self._per_iteration_metrics(tm, batch)
                self.send_event(PhotonOptimizationLogEvent(
                    tm.regularization_weight, tm.result, metrics,
                    per_iteration_metrics=per_iteration))
            self.best_lambda = select_best_model(self.per_lambda_metrics,
                                                 p.task)
            self.logger.info(f"best lambda: {self.best_lambda:g}")
        self._advance(DriverStage.VALIDATED)

    def _per_iteration_metrics(self, tm, batch) -> list[dict[str, float]]:
        """Metrics of every iterate of the solve (Driver
        .computeAndLogModelMetrics :330-349): the iterates, taken to raw
        space in one call, are one more grid for the evaluator."""
        W = self.normalization.transform_model_coefficients(
            torch.as_tensor(tm.result.iterates, device=self.device))
        per_iteration = evaluate_model_grid(
            [GeneralizedLinearModel(Coefficients(means=w), self.params.task)
             for w in W], batch)
        for i, metrics in enumerate(per_iteration):
            for name in sorted(metrics):
                self.logger.info(
                    f"Iteration: [{i:6d}] Metric: [{name}] value: "
                    f"{metrics[name]}")
        return per_iteration

    def diagnose(self) -> None:
        """Driver.diagnose :525 -> HTML/text report :618-638."""
        if self.stage == DriverStage.TRAINED:
            self._advance(DriverStage.VALIDATED)
        self._assert_stage(DriverStage.VALIDATED)
        p = self.params
        if p.diagnostic_mode == DiagnosticMode.NONE:
            self._advance(DriverStage.DIAGNOSED)
            return
        with self._phase("diagnose"):
            do_train = p.diagnostic_mode in (DiagnosticMode.TRAIN,
                                             DiagnosticMode.ALL)
            do_validate = p.diagnostic_mode in (DiagnosticMode.VALIDATE,
                                                DiagnosticMode.ALL)
            fitting = bootstrap = None
            if do_train:
                fitting = diag.fitting_diagnostic(
                    self.train_data.num_samples, self.train_data.dim,
                    self._model_factory(with_metrics_on_train=True))
                bootstrap = self._bootstrap_diagnostic()
            hl = independence = None
            importance = []
            if do_validate and self.validate_data is not None:
                best = self._best_model()
                vbatch = self._validation_batch()
                means = best.model.coefficients.means
                margins = vbatch.margins(
                    means.to(vbatch.labels.dtype),
                    torch.zeros((), dtype=vbatch.labels.dtype,
                                device=self.device))
                predictions = best.model.mean(margins).cpu().numpy()
                if p.task == TaskType.LOGISTIC_REGRESSION:
                    hl = diag.hosmer_lemeshow(self.validate_data.labels,
                                              predictions)
                independence = diag.prediction_error_independence(
                    self.validate_data.labels, predictions)
                w = means.cpu().numpy()
                importance = [
                    diag.feature_importance(
                        w, self.train_data.index_map,
                        np.asarray(self.summary.mean_abs),
                        "expected magnitude"),
                    diag.feature_importance(
                        w, self.train_data.index_map,
                        np.asarray(self.summary.variance), "variance"),
                ]
            doc = build_diagnostic_document(
                f"Diagnostics: {p.job_name}", hl=hl,
                importance=importance or None,
                independence=independence, fitting=fitting,
                bootstrap=bootstrap, index_map=self.train_data.index_map,
                preamble=json.dumps(
                    {"task": p.task.name,
                     "optimizer": p.optimizer.name,
                     "lambdas": list(p.regularization_weights)}))
            os.makedirs(p.output_directory, exist_ok=True)
            with open(os.path.join(p.output_directory,
                                   "diagnostic-report.html"), "w") as fh:
                fh.write(render_html(doc))
            with open(os.path.join(p.output_directory,
                                   "diagnostic-report.txt"), "w") as fh:
                fh.write(render_text(doc))
        self._advance(DriverStage.DIAGNOSED)

    def _model_factory(self, with_metrics_on_train: bool):
        """``(train_indices, eval_indices, warm_start) -> per-lambda
        results`` for the fitting and bootstrap diagnostics (the
        reference's modelFactory closures; ``legacy_driver.py:539-595``).
        ``eval_indices`` None evaluates on the whole training split. Warm
        starts carry across calls per lambda in normalized space, for
        the lambdas ``warm_start`` names."""
        normalized_warm: dict[float, np.ndarray] = {}

        def factory(train_idx: np.ndarray, eval_idx, warm_start: dict):
            sub = self._batch(self.train_data, train_idx)
            starts = {lam: coef for lam, coef in normalized_warm.items()
                      if lam in warm_start} or None
            models = self._grid(sub, initial_by_weight=starts)
            held = self._batch(self.train_data,
                               None if eval_idx is None
                               else np.asarray(eval_idx))
            glms = [tm.model for tm in models]
            test_maps = evaluate_model_grid(glms, held)
            train_maps = (evaluate_model_grid(glms, sub)
                          if with_metrics_on_train
                          else [None] * len(models))
            out = {}
            for tm, train_metrics, test_metrics in zip(
                    models, train_maps, test_maps):
                normalized_warm[tm.regularization_weight] = \
                    tm.result.coefficients.cpu().numpy()
                coef = tm.model.coefficients.means.cpu().numpy()
                out[tm.regularization_weight] = (
                    (coef, train_metrics, test_metrics)
                    if with_metrics_on_train else (coef, test_metrics))
            return out

        return factory

    def _bootstrap_diagnostic(self):
        try:
            return diag.bootstrap_training(
                self.train_data.num_samples, 4, 0.75,
                self._model_factory(with_metrics_on_train=False))
        except ValueError:
            return None

    def _best_model(self) -> TrainedModel:
        for tm in self.models:
            if tm.regularization_weight == self.best_lambda:
                return tm
        return self.models[-1]

    def output(self) -> None:
        """The TSV models (Driver :196-197 writeModelsInText) and
        ``metrics.json``."""
        p = self.params
        imap = self.train_data.index_map
        write_models_text(
            os.path.join(p.output_directory, "output"),
            [(tm.regularization_weight, tm.model) for tm in self.models],
            imap)
        if self.best_lambda is not None:
            write_models_text(os.path.join(p.output_directory, "best"),
                              [(self.best_lambda, self._best_model().model)],
                              imap)
        with open(os.path.join(p.output_directory, "metrics.json"),
                  "w") as fh:
            json.dump({str(k): v for k, v in self.per_lambda_metrics.items()},
                      fh, indent=2)

    def run(self) -> None:
        """Driver.run :142-202, on the default mesh over every visible
        device of the driver's type (``legacy_driver.py:636-641``): with
        more than one, the grid's solves split their rows over the data
        axis. The mesh installed before is put back."""
        prev_mesh = get_default_mesh()
        setup_default_mesh(device=self.device)
        try:
            self._run()
        finally:
            set_default_mesh(prev_mesh)

    def _run(self) -> None:
        p = self.params
        if os.path.exists(p.output_directory) and os.listdir(
                p.output_directory):
            if p.delete_output_dirs_if_exist:
                shutil.rmtree(p.output_directory)
            elif os.path.exists(os.path.join(p.output_directory, "output")):
                raise FileExistsError(
                    f"output directory {p.output_directory} is not empty")
        os.makedirs(p.output_directory, exist_ok=True)
        self.send_event(PhotonSetupEvent(
            log_dir=p.output_directory,
            input_path=p.training_data_directory,
            params_summary=str(dataclasses.asdict(p))))
        self.preprocess()
        self.train()
        self.validate()
        self.diagnose()
        self.output()
        self.logger.info(
            f"stages completed: "
            f"{[s[0] for s in self.stage_history + [self.stage]]}")


def run(argv: Optional[Sequence[str]] = None) -> LegacyDriver:
    """Run the driver; returns it (``models``, ``per_lambda_metrics``,
    ``best_lambda``, ``phase_seconds``; the models and ``metrics.json``
    are on disk). A recognized terminal condition ends the run with the
    ``PHOTON_ABORT`` line and exit code 3; a refused combination of flags
    raises ``ValueError``; a missing CUDA device raises
    ``RuntimeError``."""
    try:
        params = parse_args(list(argv) if argv is not None
                            else sys.argv[1:])
    except clean_abort_types() as e:
        raise clean_abort(e) from None
    driver = LegacyDriver(params)
    try:
        driver.run()
    except Exception as e:
        driver.logger.error(f"driver failed: {e}")
        raise
    finally:
        driver.logger.close()
    return driver


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Command-line entry point: :func:`run`, returning nothing."""
    run(argv)


if __name__ == "__main__":
    main()
