"""The multi-device GAME acceptance step.

Port of ``photon_ml_tpu/parallel/multichip_check.py:30-290``
(``run_game_step`` and ``check_game_step_multichip``): one small but
complete GAME sweep — a data-sharded fixed effect, an entity-sharded
random effect, a factored random effect (its latent refit rides the data
axis), matrix-factorization scoring split over every device of the mesh,
and the explicit data-sharded fixed-effect fit — run over a
(data x entity) mesh or on one device with IDENTICAL shapes and padding,
so the mesh run can be held to the single-device one.

The mesh's devices may repeat (``make_mesh(devices=[dev] * 4)``): that is
how the CPU tests and one card run 4 shards. ``check_game_step_multichip``
prints the JAX package's one ``multichip ok:`` summary line, with
``platform=gpu`` on a CUDA mesh and ``platform=cpu`` on a CPU one, and
holds the mesh run to the single-device one within 1e-3.
"""

from __future__ import annotations

import numpy as np


def run_game_step(n_data: int = 4, n_entity: int = 2, mesh=None,
                  seed: int = 3, device="cuda") -> dict:
    """One GAME coordinate-descent sweep on a tiny synthetic dataset.

    ``n_data``/``n_entity`` fix the shapes (rows, entity padding), so a
    ``mesh=None`` run on ``device`` compares with a run over an
    ``n_data x n_entity`` mesh (whose first device is then the one the
    data lives on). Returns numpy results: ``objectives``, ``fixed``,
    ``re_coefficients``, ``projection``, ``latent``, ``mf_scores`` and
    ``shardmap_fixed``, as the JAX function does."""
    import scipy.sparse as sp
    import torch

    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.game.coordinate import (
        FactoredRandomEffectCoordinate,
        FixedEffectCoordinate,
        RandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.coordinate_descent import (
        run_coordinate_descent,
    )
    from photon_ml_tpu_torch.game.dataset import (
        GameDataset,
        RandomEffectDataConfiguration,
        build_fixed_effect_dataset,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.game.models import MatrixFactorizationModel
    from photon_ml_tpu_torch.game.random_effect import (
        RandomEffectOptimizationProblem,
    )
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
        TaskType,
    )
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.parallel.collectives import run_shards
    from photon_ml_tpu_torch.parallel.distributed import run_glm_shard_map
    from photon_ml_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        ENTITY_AXIS,
        get_default_mesh,
        host_array,
        set_default_mesh,
        shard_batch,
    )
    from photon_ml_tpu_torch.projector.projectors import (
        ProjectorConfig,
        ProjectorType,
    )
    from photon_ml_tpu_torch.utils.sync_telemetry import record_host_fetch

    if mesh is not None:
        assert mesh.shape[DATA_AXIS] == n_data, mesh.shape
        assert mesh.shape[ENTITY_AXIS] == n_entity, mesh.shape
        device = mesh.devices[0, 0]
    dev = resolve_device(device)

    # tiny GAME dataset: a global shard and a per-user shard, rows that
    # divide the data axis, entities padded to the entity axis
    n_devices = n_data * n_entity
    rng = np.random.default_rng(seed)
    rows, d_g, d_u, n_users = 16 * n_devices, 12, 6, 4 * n_entity
    n_items = 6
    Xg = rng.normal(size=(rows, d_g))
    Xu = rng.normal(size=(rows, d_u))
    users = rng.integers(0, n_users, size=rows)
    y = (rng.uniform(size=rows) < 0.5).astype(np.float64)
    data = GameDataset(responses=y,
                       feature_shards={"global": sp.csr_matrix(Xg),
                                       "user": sp.csr_matrix(Xu)})
    data.encode_ids("userId", users.astype(str))

    task = TaskType.LOGISTIC_REGRESSION

    def cfg(lam):
        return GLMOptimizationConfiguration(
            max_iterations=3, tolerance=1e-6, regularization_weight=lam,
            optimizer_type=OptimizerType.LBFGS,
            regularization_context=RegularizationContext(
                RegularizationType.L2))

    entity_shards = n_entity if mesh is not None else 1
    fe_ds = build_fixed_effect_dataset(data, "global", device=dev)
    fixed = FixedEffectCoordinate(
        dataset=fe_ds,
        problem=GLMOptimizationProblem(config=cfg(0.1), task=task))
    re_ds = build_random_effect_dataset(
        data, RandomEffectDataConfiguration("userId", "user", 1),
        entity_axis_size=n_entity, device=dev)
    rand = RandomEffectCoordinate(
        dataset=re_ds,
        problem=RandomEffectOptimizationProblem(
            config=cfg(0.5), task=task, entity_shards=entity_shards))
    # the factored effect: identity-projected raw blocks; its latent
    # refit's Kronecker batch is sample-major and rides the data axis
    fre_ds = build_random_effect_dataset(
        data, RandomEffectDataConfiguration(
            "userId", "user", 1,
            projector=ProjectorConfig(ProjectorType.IDENTITY)),
        entity_axis_size=n_entity, device=dev)
    factored = FactoredRandomEffectCoordinate(
        dataset=fre_ds,
        problem=RandomEffectOptimizationProblem(
            config=cfg(0.5), task=task, entity_shards=entity_shards),
        latent_problem=GLMOptimizationProblem(config=cfg(0.1), task=task),
        latent_dim=2, num_inner_iterations=1)

    coordinates = {"fixed": fixed, "perUser": rand,
                   "perUserFactored": factored}
    f32 = dict(dtype=torch.float32, device=dev)
    labels = torch.as_tensor(data.responses, **f32)
    weights = torch.as_tensor(data.weights, **f32)
    offsets = torch.as_tensor(data.offsets, **f32)

    # fixed-effect solves go through the shard runner while the mesh is
    # the default, as in the drivers; the caller's mesh is restored
    prev_mesh = get_default_mesh()
    set_default_mesh(mesh)
    try:
        result = run_coordinate_descent(coordinates, 1, task, labels,
                                        weights, offsets, device=dev)
    finally:
        set_default_mesh(prev_mesh)

    fre_model = result.model.models["perUserFactored"]
    re_model = result.model.models["perUser"]

    # matrix-factorization scoring: replicated factor tables, the (row,
    # col) codes split over every device of the mesh, a gather + row dot
    k_lat = 3
    mf = MatrixFactorizationModel(
        row_effect_type="userId", col_effect_type="itemId",
        row_factors=torch.as_tensor(
            rng.normal(size=(n_users, k_lat)).astype(np.float32),
            device=dev),
        col_factors=torch.as_tensor(
            rng.normal(size=(n_items, k_lat)).astype(np.float32),
            device=dev))
    r_codes = torch.as_tensor(users.astype(np.int64), device=dev)
    # every item id appears, so dictionary codes == raw ids below
    items = rng.permutation(np.resize(np.arange(n_items, dtype=np.int64),
                                      rows))
    c_codes = torch.as_tensor(items, device=dev)

    def mf_score(rf, cf, r, c):
        return (rf[r] * cf[c]).sum(-1)

    if mesh is not None:
        devs = list(mesh.devices.reshape(-1))
        step = rows // len(devs)
        pieces = [(mf.row_factors.to(d), mf.col_factors.to(d),
                   r_codes[i * step:(i + 1) * step].to(d),
                   c_codes[i * step:(i + 1) * step].to(d))
                  for i, d in enumerate(devs)]
        outs = run_shards(mf_score, devs, "mf", pieces)
        scores = torch.cat([o.to(dev) for o in outs])
    else:
        scores = mf_score(mf.row_factors, mf.col_factors, r_codes, c_codes)
    mf_scores = host_array(scores)
    record_host_fetch(site="multichip.parity")
    # parity with the model's own scoring path
    data.encode_ids("itemId", items)
    np.testing.assert_allclose(
        mf_scores, mf.score(data, device=dev).cpu().numpy(), rtol=1e-5,
        atol=1e-6)

    # the explicit data-sharded fixed-effect fit (mesh=None: the same
    # problem solved on one device, the parity referent)
    sm_problem = GLMOptimizationProblem(config=cfg(0.1), task=task)
    if mesh is not None:
        sm_model, _ = run_glm_shard_map(
            sm_problem, shard_batch(fe_ds.batch, mesh), mesh)
    else:
        sm_model, _ = sm_problem.run(fe_ds.batch)

    return {
        "objectives": np.asarray(
            [s.objective for s in result.states], dtype=np.float64),
        "fixed": host_array(
            result.model.models["fixed"].model.coefficients.means),
        "re_coefficients": host_array(re_model.to_raw().coefficients),
        "projection": host_array(fre_model.projection),
        "latent": host_array(fre_model.coefficients_latent),
        "mf_scores": mf_scores,
        "shardmap_fixed": host_array(sm_model.coefficients.means),
    }


def check_game_step_multichip(n_devices: int, devices=None,
                              parity_summary: bool = False,
                              device="cuda") -> dict:
    """Build an (n_data x n_entity) mesh over ``n_devices`` devices (the
    first of ``devices``, default every visible device of ``device``'s
    type; one may repeat), run the GAME step on it and assert that every
    result is finite. With ``parity_summary`` the single-device run on
    the mesh's first device is computed too, the largest elementwise
    deviation is held under 1e-3, and one summary line is printed."""
    from photon_ml_tpu_torch.parallel.mesh import make_mesh, visible_devices

    devs = list(devices if devices is not None else visible_devices(device))
    assert len(devs) >= n_devices, (
        f"need {n_devices} devices, have {len(devs)}")
    # data-parallel fixed effects x entity-parallel random effects
    n_entity = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_data = n_devices // n_entity
    mesh = make_mesh(num_data=n_data, num_entity=n_entity,
                     devices=devs[:n_devices])
    out = run_game_step(n_data=n_data, n_entity=n_entity, mesh=mesh)
    for key, val in out.items():
        assert np.all(np.isfinite(val)), f"non-finite {key}"
    if parity_summary:
        ref = run_game_step(n_data=n_data, n_entity=n_entity, mesh=None,
                            device=mesh.devices[0, 0])
        max_dev = max(
            float(np.max(np.abs(np.asarray(out[k], dtype=np.float64)
                                - np.asarray(ref[k], dtype=np.float64))))
            for k in out)
        assert max_dev < 1e-3, (
            f"mesh run deviates from single-device referent by {max_dev}")
        platform = "gpu" if mesh.devices[0, 0].type == "cuda" else "cpu"
        print(
            "multichip ok: "
            f"platform={platform} n_devices={n_devices} "
            f"mesh=(data={n_data},entity={n_entity}) "
            "coordinates=fixed,randomEffect,factoredRandomEffect,"
            "mfScoring,shardMapFixed "
            f"max_parity_dev={max_dev:.3e}",
            flush=True)
    return out
