"""The PyTorch port's boundaries: no JAX inside it, no silent CPU fallback.

- ``photon_ml_tpu_torch`` and ``chip_smoke.py`` import nothing of ``jax``
  or ``photon_ml_tpu`` (checked by importing every submodule in a fresh
  interpreter, and by an AST scan of the sources).
  Every package of the port (``cli``, ``io``, ``evaluation``, ``serve``,
  ``utils``, ``data``, ``tools`` among them) is walked, and the
  fault-tolerance modules (``utils/faults``, ``retry``, ``events``,
  ``checkpoint``, ``preempt``, ``data/ingest``,
  ``tools/crash_resume_drill``), the native ingest modules
  (``io/native_loader``, ``io/native_avro``) and the down-sampling ones
  (``utils/prng``, ``sampler/samplers``) and the single-GLM path's
  (``training``, ``stat/summary``, ``data/validators``,
  ``evaluation/model_evaluation``, ``diagnostics/*``,
  ``cli/legacy_driver``, ``cli/libsvm_to_avro``) are named in both
  checks.
- No port source, C++ source or ``chip_smoke.py`` names a path under the
  JAX package's ``native/``: the port builds its own copies from
  ``csrc/host/``, and importing it builds nothing.
- On a host without CUDA the entry points, called without
  ``device="cpu"`` (or the drivers, the crash/resume drill and the
  LibSVM converter without ``--device cpu``), raise ``RuntimeError``
  instead of running on the CPU.
- The kernel path has no ``try`` that could fall back, and the JAX
  package's ``PHOTON_DISABLE_PALLAS`` switch is not honoured by the port.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import photon_ml_tpu_torch
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.game import coordinate_descent as tcd
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game.models import GameModel, MatrixFactorizationModel
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops import pallas_kernels as tpk
from photon_ml_tpu_torch.optimize import config as tcfg

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(photon_ml_tpu_torch.__file__).resolve().parent
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
FAULT_TOLERANCE_MODULES = [
    "photon_ml_tpu_torch.utils.faults", "photon_ml_tpu_torch.utils.retry",
    "photon_ml_tpu_torch.utils.events", "photon_ml_tpu_torch.utils.checkpoint",
    "photon_ml_tpu_torch.utils.preempt", "photon_ml_tpu_torch.data.ingest",
    "photon_ml_tpu_torch.tools.crash_resume_drill"]
NATIVE_INGEST_MODULES = ["photon_ml_tpu_torch.io.native_loader",
                         "photon_ml_tpu_torch.io.native_avro"]
SECOND_ORDER_MODULES = ["photon_ml_tpu_torch.optimize.owlqn",
                        "photon_ml_tpu_torch.optimize.tron"]
SAMPLER_MODULES = ["photon_ml_tpu_torch.utils.prng",
                   "photon_ml_tpu_torch.sampler.samplers"]
SINGLE_GLM_MODULES = [
    "photon_ml_tpu_torch.training", "photon_ml_tpu_torch.stat.summary",
    "photon_ml_tpu_torch.data.validators",
    "photon_ml_tpu_torch.evaluation.model_evaluation",
    "photon_ml_tpu_torch.diagnostics.diagnostics",
    "photon_ml_tpu_torch.diagnostics.reporting",
    "photon_ml_tpu_torch.diagnostics.reports",
    "photon_ml_tpu_torch.diagnostics.transformers",
    "photon_ml_tpu_torch.cli.legacy_driver",
    "photon_ml_tpu_torch.cli.libsvm_to_avro"]
NAMED_MODULES = (FAULT_TOLERANCE_MODULES + NATIVE_INGEST_MODULES
                 + SECOND_ORDER_MODULES + SAMPLER_MODULES
                 + SINGLE_GLM_MODULES)


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "photon_ml_tpu"
            or module.startswith("photon_ml_tpu."))


def test_importing_every_submodule_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import photon_ml_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'photon_ml_tpu' or "
        "m.startswith('photon_ml_tpu.'))\n"
        f"missing = sorted(set({NAMED_MODULES!r}) - set(sys.modules))\n"
        "from photon_ml_tpu_torch.io import native_loader\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('photon_ml_tpu_torch.')]), missing, bad, "
        "native_loader._lib)\n")
    # -I: a fresh interpreter that reads no PYTHON* variables or user site
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    count, rest = out.stdout.split(" ", 1)
    assert int(count) >= 60
    assert rest.strip() == "[] [] None"


def test_every_port_package_is_walked():
    subpackages = {p.parent.name for p in PKG.rglob("__init__.py")}
    assert {"cli", "io", "evaluation", "serve", "utils", "game", "ops",
            "optimize", "data", "tools", "stat", "diagnostics"} <= subpackages
    walked = {p.relative_to(PKG).parts[0] for p in SOURCES
              if p.is_relative_to(PKG)}
    assert subpackages - {PKG.name} <= walked
    scanned = {".".join(("photon_ml_tpu_torch",) + p.relative_to(PKG)
                        .with_suffix("").parts)
               for p in SOURCES if p.is_relative_to(PKG)}
    assert set(NAMED_MODULES) <= scanned


def test_no_port_source_names_the_jax_native_dir():
    csrc = sorted((PKG / "csrc").rglob("*.c*"))
    assert {p.name for p in csrc} >= {"fused_value_gradient.cu",
                                      "avro_columnar.cpp",
                                      "score_encoder.cpp",
                                      "libsvm_parser.cpp"}
    for path in SOURCES + csrc:
        text = path.read_text()
        assert not re.search(r"(?<![\w.-])native/", text), path.name
        assert "native_build" not in text and "native.build" not in text


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path.name}:{node.lineno} imports {names}"


def test_kernel_path_has_no_fallback():
    for name in ("ops/pallas_kernels.py", "ops/kernels_build.py",
                 "ops/aggregators.py"):
        tree = ast.parse((PKG / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name
    for path in SOURCES:
        assert "PHOTON_DISABLE_PALLAS" not in path.read_text(), path.name


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")


def _tiny_dataset():
    import scipy.sparse as sp

    data = tds.GameDataset(
        responses=np.array([0.0, 1.0, 1.0]),
        feature_shards={"g": sp.csr_matrix(np.eye(3, dtype=np.float32))})
    data.encode_ids("u", np.array([0, 0, 1]))
    return data


def test_entry_points_refuse_cpu_without_being_asked(no_cuda, monkeypatch):
    data = _tiny_dataset()
    # a refused call must not start building on the CPU
    monkeypatch.setattr(tds, "csr_to_batch", lambda *a, **k: pytest.fail(
        "dataset build ran on the CPU"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tds.build_fixed_effect_dataset(data, "g")
    with pytest.raises(RuntimeError, match="CUDA"):
        tds.build_random_effect_dataset(
            data, tds.RandomEffectDataConfiguration("u", "g"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcd.run_coordinate_descent({}, 1, tcfg.TaskType.LOGISTIC_REGRESSION,
                                   np.zeros(3), np.ones(3), np.zeros(3))
    t = torch.zeros(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpk.fused_value_gradient_sums(tl.get_loss("logistic"),
                                      torch.zeros(3, 2), t, t, t,
                                      torch.zeros(2), torch.tensor(0.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        GameModel({}).score(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.states_from_numpy({"a": np.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.matrix_factorization_from_numpy(
            "u", "u", np.zeros((2, 3)), np.zeros((2, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        MatrixFactorizationModel("u", "u", torch.zeros(2, 3),
                                 torch.zeros(2, 3)).score(data)
    assert tpk.launch_count() == 0


def test_drivers_refuse_cpu_without_being_asked(no_cuda, monkeypatch,
                                                tmp_path):
    from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
    from photon_ml_tpu_torch.cli import game_training_driver as ttd

    # a refused run must not start reading data or training on the CPU
    monkeypatch.setattr(ttd.GameTrainingDriver, "run", lambda self: pytest.fail(
        "the training driver ran on the CPU"))
    monkeypatch.setattr(tsd.GameScoringDriver, "run", lambda self: pytest.fail(
        "the scoring driver ran on the CPU"))
    sections = "global:globalFeatures"
    with pytest.raises(RuntimeError, match="CUDA"):
        ttd.main(["--train-input-dirs", str(tmp_path / "t.avro"),
                  "--output-dir", str(tmp_path / "out"),
                  "--task-type", "LOGISTIC_REGRESSION",
                  "--feature-shard-id-to-feature-section-keys-map", sections,
                  "--updating-sequence", "fixed",
                  "--fixed-effect-data-configurations", "fixed:global,1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tsd.main(["--input-data-dirs", str(tmp_path / "t.avro"),
                  "--game-model-input-dir", str(tmp_path / "model"),
                  "--output-dir", str(tmp_path / "score"),
                  "--feature-shard-id-to-feature-section-keys-map",
                  sections])
    assert not os.path.exists(tmp_path / "out")
    assert not os.path.exists(tmp_path / "score")
    assert tpk.launch_count() == 0


def test_single_glm_entry_points_refuse_cpu_without_being_asked(
        no_cuda, monkeypatch, tmp_path):
    import scipy.sparse as sp

    from photon_ml_tpu_torch.cli import legacy_driver as tld
    from photon_ml_tpu_torch.cli import libsvm_to_avro as tla
    from photon_ml_tpu_torch.io import data_format as tdf
    from photon_ml_tpu_torch.io.model_io import read_models_text
    from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
    from photon_ml_tpu_torch.ops.normalization import (
        NormalizationContext, NormalizationType)
    from photon_ml_tpu_torch.stat.summary import summarize

    # a refused run must not start reading data or training on the CPU
    monkeypatch.setattr(tld.LegacyDriver, "run", lambda self: pytest.fail(
        "the legacy driver ran on the CPU"))
    monkeypatch.setattr(tdf, "load_libsvm", lambda *a, **k: pytest.fail(
        "the converter read data"))
    monkeypatch.setattr(tla, "load_libsvm", tdf.load_libsvm)
    libsvm = tmp_path / "d.libsvm"
    libsvm.write_text("1 1:0.5\n")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA"):
        tld.main(["--training-data-directory", str(libsvm),
                  "--output-directory", str(out),
                  "--input-file-format", "LIBSVM",
                  "--feature-dimension", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tla.main(["--input-path", str(libsvm), "--output-path",
                  str(tmp_path / "d.avro"), "--feature-dimension", "1"])
    assert not out.exists() and not (tmp_path / "d.avro").exists()
    summary = summarize(sp.csr_matrix(np.eye(3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        NormalizationContext.build(NormalizationType.STANDARDIZATION,
                                   summary, intercept_index=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        summarize(np.eye(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        GeneralizedLinearModel.zeros(3, tcfg.TaskType.LOGISTIC_REGRESSION)
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "part-00000.txt").write_text("a\t\t1.0\t1.0\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        read_models_text(str(tmp_path / "m"))
    assert tpk.launch_count() == 0


def test_drill_defaults_to_the_card(no_cuda, tmp_path, monkeypatch):
    from photon_ml_tpu_torch.tools import crash_resume_drill as drill

    # a refused drill must not start a worker on the CPU
    monkeypatch.setattr(drill, "_spawn", lambda *a, **k: pytest.fail(
        "the drill started a worker"))
    with pytest.raises(RuntimeError, match="CUDA"):
        drill.run_drill(str(tmp_path), str(tmp_path / "roles"))
    with pytest.raises(RuntimeError, match="CUDA"):
        drill.main(["--fixture-dir", str(tmp_path),
                    "--workdir", str(tmp_path / "w")])
    assert not os.path.exists(tmp_path / "roles")


def test_dense_batch_defaults_to_the_card(no_cuda):
    from photon_ml_tpu_torch.data.batch import dense_batch

    X = np.arange(6, dtype=np.float32).reshape(3, 2)
    y = np.array([0.0, 1.0, 1.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        dense_batch(X, y)
    batch = dense_batch(X, y, device="cpu")
    assert batch.X.device.type == "cpu"
    assert torch.equal(batch.X, torch.from_numpy(X))
    assert torch.equal(batch.labels, torch.tensor([0.0, 1.0, 1.0]))
    assert torch.equal(batch.weights, torch.ones(3))


def test_kernel_build_is_not_triggered_by_import():
    from photon_ml_tpu_torch.ops import kernels_build

    assert kernels_build._LIBS == {}
