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
  ``cli/legacy_driver``, ``cli/libsvm_to_avro``) and the wide and
  streamed data's (``data/batch``, ``io/index_map``,
  ``io/feature_index_job``, ``cli/feature_indexing_job``,
  ``tools/host_replay``) are named in both checks.
- No port source, C++ source or ``chip_smoke.py`` names a path under the
  JAX package's ``native/``: the port builds its own copies from
  ``csrc/host/``, and importing it builds nothing.
- On a host without CUDA the entry points, called without
  ``device="cpu"`` (or the drivers, the crash/resume drill and the
  LibSVM converter without ``--device cpu``), raise ``RuntimeError``
  instead of running on the CPU.
- The kernel path has no ``try`` that could fall back, and the JAX
  package's ``PHOTON_DISABLE_PALLAS`` switch is not honoured by the port.
- The serving path (``obs/metrics``, ``obs/trace``, ``serve/*``,
  ``tools/photon_serve``) is in both import checks; ``ServingScorer``,
  ``TieredCoefficientStore``, the service and its launcher raise without
  CUDA unless given ``device="cpu"`` / ``--device cpu`` (the service
  before it reads a model or binds its socket).
- The fleet and the telemetry plane (``serve/fleet``, ``serve/router``,
  ``obs/export``, ``heartbeat``, ``run``, ``bridge``, ``devicemem``,
  ``compile``, ``otlp``, ``utils/sync_telemetry``) are in both import
  checks; the router imports no torch and takes no ``--device``, while the
  members the fleet verb fronts (services) default to CUDA and raise
  without it; the telemetry flags are no longer refused by the drivers or
  the service.
- The wide and streamed builders (``csr_to_batch`` over 4,096 columns,
  ``build_random_effect_dataset_streamed``) raise without CUDA unless
  given ``device="cpu"``; a failed host build raises from the block
  packers instead of returning ``False``; the flags ported with them
  (``--offheap-indexmap-dir``, ``--offheap-indexmap-num-partitions``,
  ``--random-effect-blocks-dir``), ``--precision bf16``, the telemetry
  flags and the device mesh's (``--re-entity-shards``,
  ``--collective-quant``) are no longer refused, and neither are the
  multi-process ones (``--num-processes``, ``--max-worker-restarts``):
  a multi-process argv is checked (here: refused for its missing
  ``--coordinator``) before anything is written.
- The device mesh (``parallel/*``, ``utils/backend_probe``,
  ``utils/compile_cache``) is in both import checks;
  ``setup_default_mesh``, ``make_mesh`` and the CUDA device probe raise
  without CUDA instead of building a CPU mesh; the kernel's launch runs
  with its tensors' device current, and a shard body runs with its
  shard's device current.
- The gang (``parallel/multihost``) is in both import checks; its entry
  points (``gang_device``, ``run_worker``, ``run_game_worker``) and the
  drivers' multi-process runs raise without CUDA before a gang forms or
  an output is written.
- The port's photonlint (``analysis/*`` and ``tools/photonlint``) is in
  both import checks.
- Run supervision (``tools/photon_status``, ``tools/photon_supervise``)
  is in both import checks; ``photon_status`` imports no torch, and the
  supervisor imports it only for its device check, which refuses a child
  whose ``--device`` is CUDA (the default) on a host without CUDA before
  anything is spawned or written (the router is exempt).
- The chaos campaign and the OTLP bridge (``tools/chaos_drill``,
  ``tools/otlp_bridge``) are in both import checks; the bridge imports no
  torch, and the campaign refuses CUDA on a host without it before it
  writes a fixture or starts a child (``test_torch_chaos_table.py``).
"""

import ast
import json
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
WIDE_STREAMED_MODULES = [
    "photon_ml_tpu_torch.data.batch", "photon_ml_tpu_torch.io.index_map",
    "photon_ml_tpu_torch.io.feature_index_job",
    "photon_ml_tpu_torch.cli.feature_indexing_job",
    "photon_ml_tpu_torch.tools.host_replay"]
SERVE_MODULES = [
    "photon_ml_tpu_torch.obs.metrics", "photon_ml_tpu_torch.obs.trace",
    "photon_ml_tpu_torch.serve.reqtrace", "photon_ml_tpu_torch.serve.batcher",
    "photon_ml_tpu_torch.serve.protocol", "photon_ml_tpu_torch.serve.tiers",
    "photon_ml_tpu_torch.serve.scoring", "photon_ml_tpu_torch.serve.service",
    "photon_ml_tpu_torch.tools.photon_serve"]
FLEET_TELEMETRY_MODULES = [
    "photon_ml_tpu_torch.serve.fleet", "photon_ml_tpu_torch.serve.router",
    "photon_ml_tpu_torch.obs.export", "photon_ml_tpu_torch.obs.heartbeat",
    "photon_ml_tpu_torch.obs.run", "photon_ml_tpu_torch.obs.bridge",
    "photon_ml_tpu_torch.obs.devicemem", "photon_ml_tpu_torch.obs.compile",
    "photon_ml_tpu_torch.obs.otlp",
    "photon_ml_tpu_torch.utils.sync_telemetry"]
MESH_MODULES = [
    "photon_ml_tpu_torch.parallel.mesh",
    "photon_ml_tpu_torch.parallel.collectives",
    "photon_ml_tpu_torch.parallel.quantized_collectives",
    "photon_ml_tpu_torch.parallel.distributed",
    "photon_ml_tpu_torch.parallel.multichip_check",
    "photon_ml_tpu_torch.utils.backend_probe",
    "photon_ml_tpu_torch.utils.compile_cache"]
MULTIHOST_MODULES = ["photon_ml_tpu_torch.parallel.multihost"]
SUPERVISION_MODULES = ["photon_ml_tpu_torch.tools.photon_status",
                       "photon_ml_tpu_torch.tools.photon_supervise"]
CHAOS_MODULES = ["photon_ml_tpu_torch.tools.chaos_drill",
                 "photon_ml_tpu_torch.tools.otlp_bridge"]
ANALYSIS_MODULES = [
    f"photon_ml_tpu_torch.analysis.{m}" for m in (
        "core", "package", "dataflow", "cache", "sarif", "rules_faults",
        "rules_checkpoint", "rules_threads", "rules_protocol",
        "rules_telemetry", "rules_sync", "rules_collectives",
        "rules_dtype", "runner")] + [
    "photon_ml_tpu_torch.tools.photonlint"]
NAMED_MODULES = (FAULT_TOLERANCE_MODULES + NATIVE_INGEST_MODULES
                 + SECOND_ORDER_MODULES + SAMPLER_MODULES
                 + SINGLE_GLM_MODULES + WIDE_STREAMED_MODULES
                 + SERVE_MODULES + FLEET_TELEMETRY_MODULES + MESH_MODULES
                 + MULTIHOST_MODULES + ANALYSIS_MODULES
                 + SUPERVISION_MODULES + CHAOS_MODULES)


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
            "optimize", "data", "tools", "stat", "diagnostics",
            "obs", "parallel", "analysis"} <= subpackages
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
                                      "libsvm_parser.cpp",
                                      "block_packer.cpp"}
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


def test_mesh_and_device_probe_refuse_cpu_without_being_asked(no_cuda):
    from photon_ml_tpu_torch.parallel import mesh as tmesh
    from photon_ml_tpu_torch.utils import backend_probe

    tmesh.set_default_mesh(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.setup_default_mesh(num_entity=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()
    assert tmesh.get_default_mesh() is None
    # the CPU is a mesh of one device only when asked for: no mesh
    assert tmesh.setup_default_mesh(device="cpu") is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend_probe.probe_cuda_devices(timeout_secs=120)


def _record_current_device(monkeypatch):
    """Stand-ins for ``torch.cuda.device`` and ``torch.cuda.set_device``
    (which record the device they make current, per thread) and for the
    stream, event and property lookups, so the launch path and the shard
    runner run on a host without a card."""
    import contextlib
    import threading
    from types import SimpleNamespace

    state = threading.local()

    @contextlib.contextmanager
    def device(d):
        prev = getattr(state, "current", "cuda:0")
        state.current = str(torch.device(d))
        try:
            yield
        finally:
            state.current = prev

    def set_device(d):
        state.current = str(torch.device(d))

    def stream_obj(*a, **k):
        return SimpleNamespace(cuda_stream=0, wait_stream=lambda s: None,
                               wait_event=lambda e: None,
                               record_event=lambda: object())

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "current_stream", stream_obj)
    monkeypatch.setattr(torch.cuda, "Stream", stream_obj)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=1))
    return lambda: getattr(state, "current", "cuda:0")


def test_kernel_launch_runs_under_its_own_device(monkeypatch):
    """The launch on a card that is not the current one makes that card
    current for the ctypes call (a launch onto another device's stream
    fails on a mesh of cards)."""
    current = _record_current_device(monkeypatch)
    seen = []

    class Lib:
        def photon_fused_value_gradient(self, *args):
            seen.append(current())
            return 0

    class OnCard1(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 1)

    real_empty = torch.empty
    monkeypatch.setattr(tpk.kernels_build, "load", lambda name: Lib())
    monkeypatch.setattr(torch, "empty", lambda *a, **k: real_empty(
        *a, **{**k, "device": "cpu"}))
    monkeypatch.setattr(tpk, "_MAX_CTAS", {})

    def card(t):
        return t.as_subclass(OnCard1)

    n, d = 8, 4
    vec = card(torch.zeros(n))
    tpk._launch(tl.get_loss("logistic"), card(torch.zeros(n, d)), vec, vec,
                vec, card(torch.zeros(d)), card(torch.zeros(1)))
    tpk.reset_launch_count()
    assert seen == ["cuda:1"]
    assert current() == "cuda:0"  # put back after the launch


def test_shard_bodies_run_under_their_own_device(monkeypatch):
    from photon_ml_tpu_torch.parallel.collectives import run_shards

    current = _record_current_device(monkeypatch)
    devs = [torch.device("cuda", i) for i in (0, 1, 2, 3)]
    out = run_shards(lambda: current(), devs, "data", [()] * 4)
    assert out == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]


def test_kernel_build_is_not_triggered_by_import():
    from photon_ml_tpu_torch.ops import kernels_build

    assert kernels_build._LIBS == {}


def test_wide_and_streamed_builders_refuse_cpu_without_being_asked(no_cuda,
                                                                   tmp_path):
    import scipy.sparse as sp

    wide = sp.random(4, 5000, density=0.01, format="csr",
                     random_state=np.random.RandomState(0))
    y = np.array([0.0, 1.0, 1.0, 0.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        tds.csr_to_batch(wide, y, np.zeros(4), np.ones(4))
    batch = tds.csr_to_batch(wide, y, np.zeros(4), np.ones(4), device="cpu")
    assert batch.device == torch.device("cpu") and batch.dim == 5000
    data = _tiny_dataset()
    cfg = tds.RandomEffectDataConfiguration("u", "g")
    with pytest.raises(RuntimeError, match="CUDA"):
        tds.build_random_effect_dataset_streamed(
            tds.dataset_row_stream(data, cfg), cfg, raw_dim=3,
            blocks_dir=str(tmp_path / "blocks"))
    assert not (tmp_path / "blocks").exists()
    ds = tds.build_random_effect_dataset_streamed(
        tds.dataset_row_stream(data, cfg), cfg, raw_dim=3, device="cpu")
    assert ds.device == torch.device("cpu")


def test_failed_host_build_raises_from_the_packers(monkeypatch, tmp_path):
    from photon_ml_tpu_torch.io import native_loader
    from photon_ml_tpu_torch.ops import kernels_build

    monkeypatch.setattr(kernels_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.delenv(native_loader.ENV_HOST_LIB, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    out = (np.zeros((1, 1), np.int32), np.zeros((1, 1), np.float32))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_loader.pack_ell_native(np.array([0, 1]), np.array([0]),
                                      np.array([1.0]), 1, *out)
    import scipy.sparse as sp

    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_loader.pack_projected_rows_native(
            sp.csr_matrix(np.ones((1, 1))), np.zeros(1), np.zeros(1),
            np.zeros((1, 1), np.int32), out[1])
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_loader.build_sanitized()
    monkeypatch.setenv(native_loader.ENV_HOST_LIB, str(tmp_path / "x.so"))
    with pytest.raises(RuntimeError, match="does not exist"):
        native_loader.get_host_lib()


PORTED_FLAGS = [
    ["--offheap-indexmap-dir", "idx"],
    ["--offheap-indexmap-dir", "idx", "--offheap-indexmap-num-partitions",
     "2"],
    ["--random-effect-blocks-dir", "blk"],
    ["--precision", "bf16"],
    ["--trace-dir", "trace"],
    ["--trace-dir", "trace", "--telemetry-endpoint", "127.0.0.1:1",
     "--device-telemetry", "--trace-heartbeat-seconds", "0.5",
     "--trace-stall-seconds", "30"],
    ["--re-entity-shards", "2"],
    ["--collective-quant", "int8"]]
#: the multi-process flags, refused with exit 3 until the gang was
#: ported: each argv now reaches the multi-process check
STILL_UNPORTED = [
    ("--num-processes", ["--num-processes", "2"]),
    ("--max-worker-restarts", ["--max-worker-restarts", "1",
                               "--num-processes", "2"])]
_TRAIN = ["--task-type", "LOGISTIC_REGRESSION",
          "--feature-shard-id-to-feature-section-keys-map",
          "global:globalFeatures", "--updating-sequence", "fixed",
          "--fixed-effect-data-configurations", "fixed:global,1",
          "--device", "cpu"]


@pytest.mark.parametrize("extra", PORTED_FLAGS, ids=lambda e: e[0])
def test_ported_flags_are_not_refused(extra, tmp_path):
    from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.cli import legacy_driver as tld

    ns = ttd.parse_args(["--train-input-dirs", "t", "--output-dir",
                         str(tmp_path / "o"), *_TRAIN, *extra])
    ttd.check_unported(ns)
    if extra[0] == "--re-entity-shards":
        assert ns.re_entity_shards == 2
    if extra[0] == "--collective-quant":
        assert ns.collective_quant == "int8"
    if extra[0] == "--precision":
        from photon_ml_tpu_torch.cli.args import precision_dtype

        assert precision_dtype(ns.precision) is torch.bfloat16
    if extra[0] == "--trace-dir":
        sns = tsd.parse_args(
            ["--input-data-dirs", "t", "--game-model-input-dir", "m",
             "--output-dir", str(tmp_path / "s"),
             "--feature-shard-id-to-feature-section-keys-map",
             "global:globalFeatures", "--device", "cpu", *extra])
        tsd.check_unported(sns)
        assert (ns.trace_dir, sns.trace_dir) == ("trace", "trace")
    if extra[0].startswith("--offheap"):
        tsd.check_unported(tsd.parse_args(
            ["--input-data-dirs", "t", "--game-model-input-dir", "m",
             "--output-dir", str(tmp_path / "s"),
             "--feature-shard-id-to-feature-section-keys-map",
             "global:globalFeatures", "--device", "cpu", *extra]))
        params = tld.parse_args(["--training-data-directory", "t",
                                 "--output-directory", str(tmp_path / "l"),
                                 "--device", "cpu", *extra])
        assert params.offheap_indexmap_dir == "idx"


@pytest.mark.parametrize("flag,extra", STILL_UNPORTED,
                         ids=[f for f, _ in STILL_UNPORTED])
def test_unported_flags_still_exit_3(flag, extra, tmp_path, capsys):
    """No longer refused as unported: the argv reaches the multi-process
    check, which refuses it for its missing coordinator with the JAX
    driver's message, before anything is written."""
    from photon_ml_tpu_torch.cli import game_training_driver as ttd

    with pytest.raises(ValueError, match="--coordinator host:port is "
                                         "required"):
        ttd.main(["--train-input-dirs", "t", "--output-dir",
                  str(tmp_path / "o"), *_TRAIN, *extra])
    assert "PHOTON_ABORT" not in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_gang_entry_points_refuse_cpu_without_being_asked(no_cuda,
                                                         tmp_path):
    from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
    from photon_ml_tpu_torch.cli import game_training_driver as ttd
    from photon_ml_tpu_torch.parallel import multihost as tmh

    with pytest.raises(RuntimeError, match="CUDA"):
        tmh.gang_device("cuda", 0)
    # raised before the gang forms: nothing listens on this coordinator
    with pytest.raises(RuntimeError, match="CUDA"):
        tmh.run_worker(0, 2, "127.0.0.1:9")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmh.run_game_worker(0, 2, "127.0.0.1:9", [], {}, {}, None, [],
                            None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttd.main(["--train-input-dirs", "t", "--output-dir",
                  str(tmp_path / "o"), *_TRAIN[:-2], "--num-processes", "2",
                  "--coordinator", "127.0.0.1:9",
                  "--feature-name-and-term-set-path", "fs",
                  "--model-output-mode", "NONE"])
    with pytest.raises(RuntimeError, match="CUDA"):  # the supervisor
        ttd.main(["--train-input-dirs", "t", "--output-dir",
                  str(tmp_path / "o"), *_TRAIN[:-2], "--num-processes", "2",
                  "--coordinator", "127.0.0.1:9",
                  "--feature-name-and-term-set-path", "fs",
                  "--model-output-mode", "NONE",
                  "--max-worker-restarts", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tsd.main(["--input-data-dirs", "t", "--game-model-input-dir", "m",
                  "--output-dir", str(tmp_path / "s"),
                  "--feature-shard-id-to-feature-section-keys-map",
                  "global:globalFeatures", "--num-processes", "2"])
    assert not (tmp_path / "o").exists()
    assert not (tmp_path / "s").exists()


SERVE_TELEMETRY = [
    ("--trace-dir", ["--trace-dir", "trace"]),
    ("--trace-heartbeat-seconds", ["--trace-heartbeat-seconds", "0.2"]),
    ("--trace-stall-seconds", ["--trace-stall-seconds", "30"]),
    ("--trace-exemplar-slots", ["--trace-exemplar-slots", "8"]),
    ("--telemetry-endpoint", ["--telemetry-endpoint", "127.0.0.1:1"]),
    ("--device-telemetry", ["--device-telemetry"])]


@pytest.mark.parametrize("flag,extra", SERVE_TELEMETRY,
                         ids=[f for f, _ in SERVE_TELEMETRY])
def test_service_accepts_the_telemetry_flags(flag, extra, tmp_path,
                                             monkeypatch):
    """With ``--trace-dir`` each telemetry flag is taken, and the service
    goes on to read its model (here a directory that does not exist)
    instead of ending with exit 3."""
    from photon_ml_tpu_torch.serve import scoring as tsc
    from photon_ml_tpu_torch.serve import service as tsvc

    argv = ["--game-model-input-dir", str(tmp_path / "m"),
            "--feature-shard-id-to-feature-section-keys-map",
            "global:globalFeatures", "--listen",
            f"unix:{tmp_path / 's.sock'}", "--device", "cpu",
            "--trace-dir", str(tmp_path / "trace"),
            *(extra if flag != "--trace-dir" else ())]
    ns = tsvc.parse_args(argv)
    assert getattr(ns, flag.lstrip("-").replace("-", "_")) is not None
    read = []

    def load(model_dir, maps):
        read.append(model_dir)
        raise FileNotFoundError(model_dir)

    monkeypatch.setattr(tsc, "load_scoring_model", load)
    with pytest.raises(FileNotFoundError):
        tsvc.main(argv)
    assert read == [str(tmp_path / "m")]
    end = json.loads((tmp_path / "trace" / "metrics.jsonl").read_text()
                     .splitlines()[-1])
    assert end["kind"] == "run_end" and end["status"] == "error"


def test_router_imports_no_torch_and_takes_no_device():
    from photon_ml_tpu_torch.serve import router as trouter

    code = ("import sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "import photon_ml_tpu_torch.serve.router\n"
            "import photon_ml_tpu_torch.tools.photon_serve\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
    assert not hasattr(trouter.parse_args(["--members", "a"]), "device")
    with pytest.raises(SystemExit):
        trouter.parse_args(["--members", "a", "--device", "cuda"])


def test_status_imports_no_torch_and_supervise_only_for_the_device():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "import photon_ml_tpu_torch.tools.photon_status\n"
            "a = 'torch' in sys.modules\n"
            "import photon_ml_tpu_torch.tools.photon_supervise as s\n"
            "b = 'torch' in sys.modules\n"
            "s.check_device([], s.ROUTER_MODULE)\n"
            "print(a, b, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]


def test_supervisor_refuses_cpu_without_being_asked(no_cuda, tmp_path,
                                                    monkeypatch):
    """The supervisor adds no ``--device``: a child whose last
    ``--device`` is CUDA (the default) is refused on a host without CUDA
    before anything is spawned or written; the router is exempt."""
    from photon_ml_tpu_torch.tools import photon_supervise as tsup

    monkeypatch.setattr(tsup.subprocess, "Popen", lambda *a, **k:
                        pytest.fail("the supervisor spawned a child"))
    trace = tmp_path / "trace"
    for args in (["--trace-dir", str(trace)],
                 ["--trace-dir", str(trace), "--device", "cpu",
                  "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tsup.supervise(args)
        with pytest.raises(RuntimeError, match="CUDA"):
            tsup.supervise(args, module=tsup.SERVE_MODULE)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsup.supervise_fleet(["--game-model-input-dir", "m"], fleet=2,
                             fleet_dir=str(tmp_path / "fleet"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tsup.main(["--", "--trace-dir", str(trace)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tsup.main(["--fleet", "2", "--fleet-dir", str(tmp_path / "f2"),
                   "--", "--game-model-input-dir", "m"])
    assert not trace.exists()
    assert not (tmp_path / "fleet").exists()
    assert not (tmp_path / "f2").exists()
    tsup.check_device([], tsup.ROUTER_MODULE)
    tsup.check_device(["--device", "cuda", "--device", "cpu"],
                      tsup.TRAIN_MODULE)


def test_fleet_members_default_to_the_card(no_cuda, tmp_path):
    """A member behind the fleet verb is a service: ``--device`` defaults
    to ``cuda`` and it raises without CUDA before it reads a model."""
    from photon_ml_tpu_torch.serve import service as tsvc
    from photon_ml_tpu_torch.tools import photon_serve

    argv = ["--game-model-input-dir", str(tmp_path / "m"),
            "--feature-shard-id-to-feature-section-keys-map",
            "global:globalFeatures", "--listen",
            f"unix:{tmp_path / 'm0.sock'}", "--trace-dir",
            str(tmp_path / "trace")]
    assert tsvc.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        photon_serve.main(argv)
    assert not (tmp_path / "m0.sock").exists()


def test_serving_entry_points_refuse_cpu_without_being_asked(
        no_cuda, monkeypatch, tmp_path):
    from photon_ml_tpu_torch.serve import scoring as tsc
    from photon_ml_tpu_torch.serve import service as tsvc
    from photon_ml_tpu_torch.serve.tiers import TieredCoefficientStore
    from photon_ml_tpu_torch.tools import photon_serve

    model = GameModel({})
    with pytest.raises(RuntimeError, match="CUDA"):
        tsc.ServingScorer(model, {}, {})
    re_model = _re_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        TieredCoefficientStore("c", re_model, 1 << 20)
    # a refused service must not read the model or bind its socket
    monkeypatch.setattr(tsc, "load_scoring_model", lambda *a, **k:
                        pytest.fail("the service read a model on the CPU"))
    sock = tmp_path / "s.sock"
    argv = ["--game-model-input-dir", str(tmp_path / "m"),
            "--feature-shard-id-to-feature-section-keys-map",
            "global:globalFeatures", "--listen", f"unix:{sock}"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tsvc.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        photon_serve.main(argv)
    assert not sock.exists()
    # and on the CPU only when asked
    assert tsc.ServingScorer(model, {}, {}, device="cpu").device == \
        torch.device("cpu")
    assert TieredCoefficientStore("c", re_model, 1 << 20,
                                  device="cpu").device == torch.device("cpu")


def _re_model():
    from photon_ml_tpu_torch.game.models import RandomEffectModel

    return RandomEffectModel("u", "g", np.arange(2), torch.zeros(2, 3),
                             entity_ids=np.array(["a", "b"]))


def test_bridge_and_campaign_import_no_torch():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "import photon_ml_tpu_torch.tools.otlp_bridge\n"
            "a = 'torch' in sys.modules\n"
            "import photon_ml_tpu_torch.tools.chaos_drill\n"
            "print(a, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def test_campaign_refuses_cpu_without_being_asked(no_cuda, tmp_path,
                                                  monkeypatch):
    """The chaos campaign defaults every child to CUDA: without it, it
    raises before it writes a fixture or starts a child."""
    from photon_ml_tpu_torch.tools import chaos_drill as tchaos

    monkeypatch.setattr(tchaos.subprocess, "run", lambda *a, **k:
                        pytest.fail("the campaign started a child"))
    workdir = tmp_path / "work"
    for call in (lambda: tchaos.run_campaign(str(workdir), smoke=True),
                 lambda: tchaos.main(["--smoke", "--workdir",
                                      str(workdir)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not workdir.exists()
