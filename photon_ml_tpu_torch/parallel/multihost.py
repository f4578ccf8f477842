"""Multi-process execution: a gang of processes over ``torch.distributed``.

Port of ``photon_ml_tpu/parallel/multihost.py``. The reference's runtime
is multi-node (Spark executors; cli/game/training/Driver.scala:642-726);
the JAX package runs it as multi-controller JAX. Here every process of a
gang runs the same program, :func:`_distributed_initialize` joins them in
one gloo process group over ``tcp://<coordinator>``, and the mesh code
that runs in one process runs over the gang with one axis spanning the
processes (``parallel/mesh.make_mesh(span=, span_axis=)``): the shard
runner's collectives over that axis gather every shard of every process
in global shard order (``parallel/collectives.py``).

- Formation is bounded by ``initialization_timeout`` (the driver's
  ``--coordinator-timeout``) and every collective by
  ``heartbeat_timeout`` (``--heartbeat-timeout``): a peer that dies makes
  the survivors' next collective raise within that bound, never hang.
  The group is destroyed in a ``finally``.
- The backend is gloo, and every exchange is staged through host memory
  (pinned for a CUDA tensor): one card can host several members of a
  gang, and NCCL refuses two ranks on one device.
- :func:`allgather_ragged`, :func:`allgather_strings` and
  :func:`allgather_csr` (``:192-260``) are the host-data exchange of the
  JAX helpers, array for array.
- :func:`run_worker` (``:104-184``) is the fixed-effect witness: every
  process makes the same seeded data, feeds only its own rows to the
  data-sharded fit and checks it against a local fit.
- :func:`run_game_worker` (``:266-891``) is the multi-process GAME loop
  and :class:`WorkerSupervisor` (``:899-986``) relaunches a member with
  bounded backoff.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.parallel.collectives import (
    PROCESS_GROUP_STATS,
    ProcessSpan,
)

_SPAN: Optional[ProcessSpan] = None


def current_span() -> ProcessSpan:
    """This process's place in its gang (``RuntimeError`` before one is
    formed)."""
    if _SPAN is None:
        raise RuntimeError("no gang is formed in this process")
    return _SPAN


def _distributed_initialize(coordinator: str, num_processes: int,
                            process_id: int,
                            initialization_timeout: int = 300,
                            heartbeat_timeout: int = 100) -> ProcessSpan:
    """Join the gang: a gloo process group over the TCP store that process
    0 serves at ``coordinator`` (``host:port``), the counterpart of
    ``jax.distributed.initialize`` (``:31-92``). Formation waits at most
    ``initialization_timeout`` seconds for every member; each collective
    after it at most ``heartbeat_timeout``. A supervisor-relaunched
    member re-enters the ``gang.form`` span on its way back in."""
    import torch.distributed as dist

    global _SPAN
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator must be host:port, got "
                         f"{coordinator!r}")
    with trace.span("gang.form", process=process_id,
                    num_processes=num_processes):
        store = dist.TCPStore(
            host, int(port), world_size=num_processes,
            is_master=process_id == 0,
            timeout=datetime.timedelta(seconds=initialization_timeout),
            wait_for_workers=True)
        dist.init_process_group(
            "gloo", store=store, rank=process_id, world_size=num_processes,
            timeout=datetime.timedelta(seconds=heartbeat_timeout))
    _SPAN = ProcessSpan(process_id, num_processes)
    return _SPAN


def _distributed_shutdown() -> None:
    """Leave the gang (``jax.distributed.shutdown``)."""
    import torch.distributed as dist

    global _SPAN
    _SPAN = None
    if dist.is_initialized():
        dist.destroy_process_group()


def gang_device(device, process_id: int) -> torch.device:
    """A gang member's device: ``device`` as given when it names an index
    or is the CPU, else ``cuda:<process_id % device_count>`` (members of
    one host share its cards). ``RuntimeError`` without CUDA: a member
    never carries on on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def _synthetic(rows: int, dim: int, seed: int):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, dim)).astype(np.float32)
    w_true = rng.normal(size=dim).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ w_true)))
    y = (rng.uniform(size=rows) < p).astype(np.float32)
    return X, y


def witness_problem():
    """The witness's L2 logistic problem (``:161-167``)."""
    from photon_ml_tpu_torch.optimize.config import (
        GLMOptimizationConfiguration,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
        TaskType,
    )
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem

    return GLMOptimizationProblem(
        config=GLMOptimizationConfiguration(
            max_iterations=25, tolerance=1e-8, regularization_weight=0.5,
            optimizer_type=OptimizerType.LBFGS,
            regularization_context=RegularizationContext(
                RegularizationType.L2)),
        task=TaskType.LOGISTIC_REGRESSION)


def run_worker(process_id: int, num_processes: int, coordinator: str,
               rows: int = 512, dim: int = 16, seed: int = 11,
               device="cuda", local_shards: int = 1) -> dict:
    """One member of the fixed-effect witness: the data-sharded fit over a
    data axis of ``num_processes`` x ``local_shards`` shards, this process
    feeding only its own contiguous rows, held against a local fit on all
    rows (``rtol=atol=2e-4``). Prints ``PARITY_OK``; returns the fitted
    coefficients, the objective and the iteration count."""
    from photon_ml_tpu_torch.data.batch import DenseBatch
    from photon_ml_tpu_torch.parallel.distributed import run_glm_shard_map
    from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh

    dev = gang_device(device, process_id)
    span = _distributed_initialize(coordinator, num_processes, process_id)
    try:
        n_global = num_processes * local_shards
        if rows % n_global != 0:
            raise ValueError(f"rows {rows} must divide the {n_global} "
                             f"shards of the data axis")
        mesh = make_mesh(num_data=local_shards, devices=[dev] * local_shards,
                         span=span, span_axis=DATA_AXIS)
        X, y = _synthetic(rows, dim, seed)
        per = rows // num_processes
        mine = slice(process_id * per, (process_id + 1) * per)

        def batch(sl):
            n = len(y[sl])
            return DenseBatch(
                X=torch.as_tensor(X[sl], device=dev),
                labels=torch.as_tensor(y[sl], device=dev),
                offsets=torch.zeros(n, dtype=torch.float32, device=dev),
                weights=torch.ones(n, dtype=torch.float32, device=dev))

        problem = witness_problem()
        model, result = run_glm_shard_map(problem, batch(mine), mesh)
        w = model.coefficients.means.detach().cpu().numpy()
        if not np.all(np.isfinite(w)):
            raise FloatingPointError("non-finite witness coefficients")
        local_model, _ = problem.run(batch(slice(None)))
        np.testing.assert_allclose(
            w, local_model.coefficients.means.detach().cpu().numpy(),
            rtol=2e-4, atol=2e-4)
        print(f"PARITY_OK process={process_id} devices={n_global} "
              f"iters={result.iterations}", flush=True)
        return {"coefficients": w, "objective": float(result.value),
                "iterations": int(result.iterations)}
    finally:
        _distributed_shutdown()


# ---------------------------------------------------------------------------
# Host-data exchange (the broadcast/shuffle analog for host metadata)
# ---------------------------------------------------------------------------


def allgather_ragged(arr: np.ndarray) -> list[np.ndarray]:
    """Every process's numeric array (same trailing shape and dtype, any
    length) in process order: lengths first, then the arrays padded to the
    longest, as bytes over the process group."""
    span = current_span()
    arr = np.ascontiguousarray(arr)
    ns = [int(t[0]) for t in span.all_gather(
        torch.tensor([arr.shape[0]], dtype=torch.int64))]
    cap = max(ns)
    if cap == 0:
        return [arr[:0].copy() for _ in ns]
    pad = np.zeros((cap,) + arr.shape[1:], arr.dtype)
    pad[:arr.shape[0]] = arr
    parts = span.all_gather_bytes(
        torch.from_numpy(pad.reshape(-1).view(np.uint8).copy()))
    return [p.numpy().view(arr.dtype).reshape(pad.shape)[:n].copy()
            for p, n in zip(parts, ns)]


def allgather_strings(strings: np.ndarray) -> list[np.ndarray]:
    """Every process's string array in process order, each string
    length-prefixed (UTF-8 bytes), so NULs and non-ASCII round-trip."""
    encoded = [str(s).encode("utf-8") for s in strings]
    lens = np.asarray([len(b) for b in encoded], dtype=np.int64)
    buf = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    out = []
    for ln, b in zip(allgather_ragged(lens), allgather_ragged(buf)):
        if int(ln.sum()) != b.shape[0]:
            raise RuntimeError(f"string exchange: {int(ln.sum())} bytes "
                               f"announced, {b.shape[0]} received")
        if len(ln) == 0:
            out.append(np.zeros(0, dtype=object))
            continue
        ends = np.cumsum(ln)
        raw = b.tobytes()
        out.append(np.asarray(
            [raw[e - n:e].decode("utf-8")
             for n, e in zip(ln.tolist(), ends.tolist())], dtype=object))
    return out


def allgather_csr(mat) -> list:
    """Every process's CSR row block (same column count) in process
    order."""
    import scipy.sparse as sp

    lens = np.diff(mat.indptr).astype(np.int64)
    out = []
    for ln, ix, dv in zip(allgather_ragged(lens),
                          allgather_ragged(np.asarray(mat.indices, np.int64)),
                          allgather_ragged(np.asarray(mat.data, np.float64))):
        indptr = np.concatenate([[0], np.cumsum(ln)])
        out.append(sp.csr_matrix((dv, ix.astype(np.int32), indptr),
                                 shape=(len(ln), mat.shape[1])))
    return out


# ---------------------------------------------------------------------------
# Multi-process GAME training (fixed + random effects)
# ---------------------------------------------------------------------------

#: Pad-row entity id (never a data id: the string exchange is
#: length-prefixed); its coefficient row is dropped from the results.
_PAD_ENTITY = "\x01__pad__\x01"


def run_game_worker(
        process_id: int, num_processes: int, coordinator: str, train_paths,
        feature_shard_sections: dict, index_maps: dict,
        fixed_coordinate: tuple, random_coordinates, task,
        num_iterations: int = 1, num_buckets: int = 1,
        initialization_timeout: int = 60, heartbeat_timeout: int = 100,
        blocks_dir=None, checkpoint_dir=None,
        checkpoint_every_coordinates: int = 0, precision: str = "f32",
        collective_quant: str = "none", stop=None, device="cuda") -> dict:
    """One member of a multi-process GAME run (``:266-378``): every member
    runs this with its own part files (``train_paths``) on ``device``
    (:func:`gang_device`).

    - Fixed-effect rows never leave their process: each member feeds its
      rows, padded to a common L with weight-0 rows, to the data-sharded
      fit over a data axis spanning the gang.
    - Scalar columns and the random-effect shards are all-gathered; each
      member builds only its slice of every entity block (the streamed
      builder's ``entity_shard``) and solves its slice's entities, and the
      slices are gathered into the global coefficient block over the
      gang-spanning entity axis (``game/random_effect.py``). Factored
      coordinates refit their projection over the gang's data axis.
    - ``checkpoint_dir``: process 0 alone reads and writes it; the
      restored snapshot reaches every member as one byte buffer.
    - ``stop`` (``should_stop() -> str | None``): at each committed update
      the members' stop flags are all-gathered, and one member's stop
      stops all of them at the same coordinate (``PreemptionRequested``).
    - ``precision`` / ``collective_quant`` must agree across the gang,
      with the row and shard counts and the checkpoint cadence: a
      mismatch fails at formation with the JAX package's messages.

    Returns the fixed coefficients, a per-coordinate map of per-entity
    coefficients by raw id (the state, and ``random_effect_raw`` in the
    raw feature space), the objective and the gang's sizes, the same on
    every member, with ``seconds`` (load, train, exchange) of this
    member."""
    from photon_ml_tpu_torch.parallel.mesh import (
        get_default_mesh,
        set_default_mesh,
    )
    from photon_ml_tpu_torch.utils.faults import fault_point

    dev = gang_device(device, process_id)
    _distributed_initialize(
        coordinator, num_processes, process_id,
        initialization_timeout=initialization_timeout,
        heartbeat_timeout=heartbeat_timeout)
    prev_mesh = get_default_mesh()
    try:
        # a member that dies after joining, before any collective, must
        # surface on the survivors as a bounded error (the registry point,
        # and the environment hook of the survivor-bound test)
        fault_point("worker.start", tag=str(process_id))
        if os.environ.get("PHOTON_MH_TEST_EXIT_AFTER_INIT") == str(
                process_id):
            os._exit(17)
        return _game_worker_body(
            process_id, num_processes, train_paths, feature_shard_sections,
            index_maps, fixed_coordinate, random_coordinates, task,
            num_iterations, num_buckets, dev, blocks_dir, checkpoint_dir,
            checkpoint_every_coordinates, precision=precision,
            collective_quant=collective_quant, stop=stop)
    finally:
        set_default_mesh(prev_mesh)
        _distributed_shutdown()


def _place_blocks(ds, device: torch.device, dtype: torch.dtype,
                  features: bool) -> None:
    """Put a dataset built with ``keep_host_blocks`` on ``device``: the
    scalar blocks always, the feature blocks (in ``dtype``) when
    ``features`` (memmap blocks stay on the host and are paged in)."""

    def put(a, as_dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=as_dtype or t.dtype)

    for b in ds.buckets:
        if features:
            b.X = put(b.X, dtype)
        b.labels, b.base_offsets = put(b.labels), put(b.base_offsets)
        b.weights, b.row_ids = put(b.weights), put(b.row_ids)
    if ds.passive_X is not None:
        if features:
            ds.passive_X = put(ds.passive_X, dtype)
        ds.passive_entity = put(ds.passive_entity)
        ds.passive_row_ids = put(ds.passive_row_ids)
        ds.passive_offsets = put(ds.passive_offsets, torch.float32)


def _check_gang_signature(n_all: list, n_local: int) -> None:
    """The formation-time signature check (``:459-488``): identical local
    shard counts, checkpoint cadence, precision and wire format on every
    member."""
    from photon_ml_tpu_torch.cli.args import PRECISION_CHOICES
    from photon_ml_tpu_torch.parallel.quantized_collectives import (
        QUANT_MODES,
    )

    dev_per = np.asarray([int(x[1]) for x in n_all])
    if not (dev_per == n_local).all():
        raise RuntimeError(
            f"multi-host GAME needs identical per-process device counts, "
            f"got {dev_per.tolist()}")
    ckpt_per = np.asarray([int(x[2]) for x in n_all])
    if ckpt_per.min() != ckpt_per.max():
        raise RuntimeError(
            f"checkpoint config must be identical on EVERY process of "
            f"the gang (process 0 alone touches --checkpoint-dir, but "
            f"all members issue the snapshot collectives at the same "
            f"--checkpoint-every-coordinates cadence); got per-process "
            f"values {ckpt_per.tolist()} (-1 = checkpointing off)")
    for sig_col, flag, choices in ((3, "--precision", PRECISION_CHOICES),
                                   (4, "--collective-quant", QUANT_MODES)):
        per = np.asarray([int(x[sig_col]) for x in n_all])
        if per.min() != per.max():
            raise RuntimeError(
                f"{flag} must be identical on EVERY process of the gang "
                f"(it shapes the traced collective programs — payload "
                f"dtypes and quantized wire shapes — so a mismatch "
                f"deadlocks the mesh collectives); got per-process "
                f"values {[choices[v] for v in per.tolist()]}")


def _game_worker_body(
        process_id, num_processes, train_paths, feature_shard_sections,
        index_maps, fixed_coordinate, random_coordinates, task,
        num_iterations, num_buckets, dev, blocks_dir=None,
        checkpoint_dir=None, checkpoint_every_coordinates=0,
        precision="f32", collective_quant="none", stop=None):
    """The member's run once the gang is formed (``:381-891``)."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.cli.args import (
        PRECISION_CHOICES,
        precision_dtype,
    )
    from photon_ml_tpu_torch.data.batch import DenseBatch
    from photon_ml_tpu_torch.game.coordinate import (
        FactoredRandomEffectCoordinate,
        RandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.dataset import (
        GameDataset,
        build_random_effect_dataset_streamed,
        dataset_row_stream,
    )
    from photon_ml_tpu_torch.game.random_effect import (
        RandomEffectOptimizationProblem,
        score_random_effect,
    )
    from photon_ml_tpu_torch.io.data_format import load_game_dataset_avro
    from photon_ml_tpu_torch.ops.losses import get_loss
    from photon_ml_tpu_torch.optimize.config import TASK_LOSS_NAME
    from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.parallel.distributed import run_glm_shard_map
    from photon_ml_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        ENTITY_AXIS,
        make_mesh,
        set_default_mesh,
    )
    from photon_ml_tpu_torch.parallel.quantized_collectives import (
        QUANT_MODES,
        check_quant_mode,
    )
    from photon_ml_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        dumps_state,
        loads_state,
    )
    from photon_ml_tpu_torch.utils.faults import fault_point
    from photon_ml_tpu_torch.utils.preempt import PreemptionRequested

    if precision not in PRECISION_CHOICES:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"expected one of {PRECISION_CHOICES}")
    check_quant_mode(collective_quant)
    store_dtype = precision_dtype(precision)
    span = current_span()
    exchange0 = PROCESS_GROUP_STATS["seconds"]
    t_start = time.perf_counter()

    # one shard per member: its device (a gang member is one device)
    n_local = 1
    n_dev = num_processes * n_local
    local_devs = [dev] * n_local
    mesh = make_mesh(num_data=n_local, devices=local_devs, span=span,
                     span_axis=DATA_AXIS)
    ent_mesh = make_mesh(num_data=1, num_entity=n_local, devices=local_devs,
                         span=span, span_axis=ENTITY_AXIS)
    set_default_mesh(ent_mesh)  # the random effect reads the entity axis

    f_cid, f_data_cfg, f_opt_cfg = fixed_coordinate
    id_types = sorted({cfg.random_effect_type
                       for _, cfg, _, _ in random_coordinates})

    # ---- local ingestion: ONLY this process's part files ------------------
    local = load_game_dataset_avro(
        list(train_paths), feature_shard_sections, index_maps,
        id_types=id_types, response_required=True)
    n_loc = local.num_samples
    raw_ids_loc = {t: local.id_vocabs[t][local.id_columns[t]]
                   for t in id_types}

    # ---- padded layout: every member pads its rows to one L ---------------
    ckpt_sig = (-1 if checkpoint_dir is None
                else int(checkpoint_every_coordinates))
    n_all = allgather_ragged(np.asarray(
        [n_loc, n_local, ckpt_sig, PRECISION_CHOICES.index(precision),
         QUANT_MODES.index(collective_quant)], np.int64))
    _check_gang_signature(n_all, n_local)
    n_per = np.asarray([int(x[0]) for x in n_all])
    L = int(-(-int(n_per.max()) // n_local) * n_local)
    n_pad_total = L * num_processes

    def pad_local(a):
        out = np.zeros(L, np.float32)
        out[:n_loc] = a
        return out

    resp_loc = pad_local(local.responses)
    off_loc = pad_local(local.offsets)
    wt_loc = pad_local(local.weights)

    # ---- all-gather the scalar columns and the random-effect shards -------
    resp_g = np.concatenate(allgather_ragged(resp_loc))
    off_g = np.concatenate(allgather_ragged(off_loc))
    wt_g = np.concatenate(allgather_ragged(wt_loc))
    ids_g = {}
    for t in id_types:
        ids_loc = np.full(L, _PAD_ENTITY, dtype=object)
        ids_loc[:n_loc] = raw_ids_loc[t]
        ids_g[t] = np.concatenate(allgather_strings(ids_loc))
    shards_g = {}
    for sname in sorted({cfg.feature_shard_id
                         for _, cfg, _, _ in random_coordinates}):
        mat_loc = local.feature_shards[sname].tocsr()
        padded = sp.vstack([mat_loc, sp.csr_matrix(
            (L - n_loc, mat_loc.shape[1]))]).tocsr()
        shards_g[sname] = sp.vstack(allgather_csr(padded)).tocsr()
    gdata = GameDataset(responses=resp_g, feature_shards=shards_g,
                        offsets=off_g.astype(np.float64),
                        weights=wt_g.astype(np.float64))
    for t in id_types:
        gdata.encode_ids(t, ids_g[t])

    # ---- per coordinate: this member's slice of every entity block --------
    coords = []
    for cid, r_data_cfg, r_opt_cfg, factored in random_coordinates:
        memmap = blocks_dir is not None and factored is None
        re_ds = build_random_effect_dataset_streamed(
            dataset_row_stream(gdata, r_data_cfg), r_data_cfg,
            raw_dim=gdata.feature_shards[r_data_cfg.feature_shard_id]
            .shape[1],
            num_buckets=1 if factored is not None else num_buckets,
            entity_axis_size=n_dev,
            blocks_dir=(os.path.join(blocks_dir, cid) if memmap else None),
            keep_host_blocks=True,
            entity_shard=(process_id, num_processes),
            dtype=store_dtype, device=dev)
        for block in re_ds.buckets:
            if block.local_entity_offset != process_id * block.X.shape[0]:
                raise AssertionError("entity slice out of place")
        _place_blocks(re_ds, dev, store_dtype, features=not memmap)
        fac = None
        if factored is not None:
            fac_re_cfg, fac_latent_cfg, fac_mf_cfg = factored
            b0 = re_ds.buckets[0]
            re_ds = dataclasses.replace(
                re_ds, X=b0.X, labels=b0.labels,
                base_offsets=b0.base_offsets, weights=b0.weights,
                row_ids=b0.row_ids, buckets=None, _reduced_dim=None,
                local_entity_offset=b0.local_entity_offset)
            fac = FactoredRandomEffectCoordinate(
                dataset=re_ds,
                problem=RandomEffectOptimizationProblem(
                    config=fac_re_cfg, task=task, entity_shards=n_dev,
                    collective_quant=collective_quant),
                latent_problem=GLMOptimizationProblem(
                    config=fac_latent_cfg, task=task,
                    collective_quant=collective_quant),
                latent_dim=fac_mf_cfg.num_factors,
                num_inner_iterations=fac_mf_cfg.max_number_iterations)
        coords.append({
            "cid": cid, "id_type": r_data_cfg.random_effect_type,
            "ds": re_ds, "fac": fac,
            "prob": RandomEffectOptimizationProblem(
                config=r_opt_cfg, task=task, entity_shards=n_dev,
                collective_quant=collective_quant)})

    # ---- fixed-effect batch: this member's rows only ----------------------
    f_mat = local.feature_shards[f_data_cfg.feature_shard_id].tocsr()
    X_loc = np.zeros((L, f_mat.shape[1]), np.float32)
    X_loc[:n_loc] = f_mat.toarray()
    f32 = dict(dtype=torch.float32, device=dev)
    X_t = torch.as_tensor(X_loc).to(device=dev, dtype=store_dtype)
    y_t = torch.as_tensor(resp_loc, **f32)
    w_t = torch.as_tensor(wt_loc, **f32)
    del X_loc
    f_problem = GLMOptimizationProblem(config=f_opt_cfg, task=task,
                                       collective_quant=collective_quant)
    t_loaded = time.perf_counter()

    def gather_rows(local_vec: torch.Tensor) -> np.ndarray:
        """This member's [L] row vector -> the gang's [P*L], on the host."""
        return np.concatenate(allgather_ragged(
            local_vec.detach().to(torch.float32).cpu().numpy()))

    # ---- checkpoint/resume: process 0 owns the snapshots ------------------
    loss = get_loss(TASK_LOSS_NAME[task])
    scores_fixed = np.zeros(n_pad_total, np.float32)
    scores_re = {c["cid"]: np.zeros(n_pad_total, np.float32)
                 for c in coords}
    states = {c["cid"]: None for c in coords}
    regs = {c["cid"]: 0.0 for c in coords}
    w_fixed = None
    objective = None
    update_seq = 1 + len(coords)  # fixed + each RE coordinate, in order
    start_it, start_ci = 0, 0

    def to_dev(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(torch.as_tensor(x, **f32) for x in v)
        return torch.as_tensor(v, **f32)

    def to_host(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(x.detach().cpu().numpy() for x in v)
        return v.detach().cpu().numpy()

    ckpt_mgr = None
    if checkpoint_dir is not None:
        snap = None
        if process_id == 0:
            ckpt_mgr = CheckpointManager(checkpoint_dir)
            try:
                snap = ckpt_mgr.restore()
            except FileNotFoundError:
                snap = None
        payload = dumps_state(snap) if snap is not None else b""
        root = allgather_ragged(np.frombuffer(payload, np.uint8))[0]
        if root.size:
            snap = loads_state(root.tobytes())
            start_it = int(snap["sweep"])
            start_ci = int(snap["coordinate_index"])
            if snap["w_fixed"] is not None:
                w_fixed = np.asarray(snap["w_fixed"])
            scores_fixed = np.asarray(snap["scores_fixed"])
            scores_re = {c["cid"]: np.asarray(snap["scores_re"][c["cid"]])
                         for c in coords}
            states = {c["cid"]: to_dev(snap["re_states"][c["cid"]])
                      for c in coords}
            regs = {c["cid"]: snap["regs"][c["cid"]] for c in coords}
            objective = snap["objective"]
            if process_id == 0:
                print(f"MULTIHOST_RESUME sweep={start_it} "
                      f"coordinate={start_ci}", flush=True)

    last_saved_step = [None]

    def save_snapshot(sweep, next_ci):
        # every member holds the whole state; process 0 alone writes
        if checkpoint_dir is None:
            return
        if next_ci >= update_seq:
            sweep, next_ci = sweep + 1, 0
        step = sweep * update_seq + next_ci
        if step == last_saved_step[0]:
            return
        if ckpt_mgr is not None:
            ckpt_mgr.save(step, {
                "sweep": sweep,
                "coordinate_index": next_ci,
                "w_fixed": None if w_fixed is None else np.asarray(w_fixed),
                "scores_fixed": np.asarray(scores_fixed),
                "scores_re": {cid: np.asarray(s)
                              for cid, s in scores_re.items()},
                "re_states": {cid: to_host(states[cid]) for cid in states},
                "regs": {cid: float(r) for cid, r in regs.items()},
                "objective": (None if objective is None
                              else float(objective)),
            })
        last_saved_step[0] = step

    def maybe_save(sweep, next_ci):
        # sweep ends save after the objective; the cadence covers the rest
        if (checkpoint_every_coordinates > 0 and next_ci < update_seq
                and (sweep * update_seq + next_ci)
                % checkpoint_every_coordinates == 0):
            save_snapshot(sweep, next_ci)

    def check_gang_stop(sweep, next_ci):
        # gang-consensus stop at a committed update: one member's flag
        # stops every member at the same coordinate (``:777-798``)
        if stop is None:
            return
        reason = stop.should_stop()
        flags = allgather_ragged(
            np.asarray([1 if reason is not None else 0], np.int32))
        if not any(int(f[0]) for f in flags):
            return
        save_snapshot(sweep, next_ci)
        if next_ci >= update_seq:
            sweep, next_ci = sweep + 1, 0
        raise PreemptionRequested(reason or "gang:peer_stop", sweep,
                                  next_ci)

    # ---- coordinate descent: fixed, then each random effect ---------------
    # offsets of a coordinate = base + the other coordinates' scores
    for it in range(start_it, num_iterations):
        fault_point("cd.sweep", tag=str(it))
        skip_before = start_ci if it == start_it else 0
        if skip_before <= 0:
            re_sum = sum(scores_re.values())
            off_inj = off_loc + re_sum[process_id * L:(process_id + 1) * L]
            batch = DenseBatch(X=X_t, labels=y_t,
                               offsets=torch.as_tensor(off_inj, **f32),
                               weights=w_t)
            model, _ = run_glm_shard_map(
                f_problem, batch, mesh,
                initial=None if w_fixed is None else torch.as_tensor(
                    w_fixed, **f32))
            w_dev = model.coefficients.means
            w_fixed = w_dev.detach().cpu().numpy()
            scores_fixed = gather_rows(X_t.to(torch.float32) @ w_dev)
            maybe_save(it, 1)
            check_gang_stop(it, 1)

        for k, c in enumerate(coords):
            ci = k + 1
            if ci < skip_before:
                continue  # a mid-sweep resume: ran before the stop
            cid = c["cid"]
            extra = torch.as_tensor(scores_fixed + sum(
                s for kk, s in scores_re.items() if kk != cid), **f32)
            if c["fac"] is not None:
                states[cid], _ = c["fac"].update(states[cid], extra)
                scores_re[cid] = c["fac"].score(states[cid]).detach().to(
                    torch.float32).cpu().numpy()
                reg = c["fac"].regularization_value_device(states[cid])
            else:
                offs = c["ds"].offsets_with(extra)
                states[cid], *_ = c["prob"].run(c["ds"], offs,
                                                initial=states[cid])
                scores_re[cid] = score_random_effect(
                    c["ds"], states[cid], entity_shards=n_dev,
                    collective_quant=collective_quant).detach().to(
                        torch.float32).cpu().numpy()
                reg = c["prob"].regularization_value_device(states[cid])
            regs[cid] = float(reg)
            maybe_save(it, ci + 1)
            check_gang_stop(it, ci + 1)

        total = scores_fixed + sum(scores_re.values()) + off_g
        li = loss.loss(torch.as_tensor(total, **f32),
                       torch.as_tensor(resp_g, **f32))
        objective = float((torch.as_tensor(wt_g, **f32) * li).sum())
        objective += float(f_problem.regularization_value(
            torch.as_tensor(w_fixed, **f32)))
        objective += sum(regs.values())
        save_snapshot(it, update_seq)  # sweep end, objective included

    # drop the pad entity from the published tables: the coordinate's
    # state per entity (projected space for a plain coordinate, as in the
    # JAX package) and the raw-space coefficients of the published model
    random_effect, random_effect_raw, factored_flags = {}, {}, {}
    for c in coords:
        vocab = gdata.id_vocabs[c["id_type"]]
        codes = c["ds"].entity_codes
        if c["fac"] is not None:
            lat, B = to_host(states[c["cid"]])
            coefs_host = raw = lat @ B  # FactoredRandomEffectModel.to_raw
        else:
            coefs_host = to_host(states[c["cid"]])
            raw = RandomEffectCoordinate(
                dataset=c["ds"], problem=c["prob"]).publish(
                    states[c["cid"]]).to_raw().coefficients.numpy()
        keep = [(str(vocab[int(code)]), i) for i, code in enumerate(codes)
                if vocab[int(code)] != _PAD_ENTITY]
        random_effect[c["cid"]] = {k: coefs_host[i] for k, i in keep}
        random_effect_raw[c["cid"]] = {k: raw[i] for k, i in keep}
        factored_flags[c["cid"]] = c["fac"] is not None
    t_end = time.perf_counter()
    return {
        "fixed": {f_cid: w_fixed},
        "random_effect": random_effect,
        "random_effect_raw": random_effect_raw,
        "objective": objective,
        "num_processes": num_processes,
        "global_devices": n_dev,
        "rows_global": int(n_per.sum()),
        # witness: the entity axis really spans every member's shard
        "re_entity_axis_devices": int(ent_mesh.shape[ENTITY_AXIS]),
        "factored": factored_flags,
        "seconds": {"load": t_loaded - t_start, "train": t_end - t_loaded,
                    "exchange": PROCESS_GROUP_STATS["seconds"] - exchange0},
    }


# ---------------------------------------------------------------------------
# Worker supervision: relaunch a crashed member with bounded backoff
# ---------------------------------------------------------------------------


class SupervisorExhaustedError(RuntimeError):
    """The supervised worker kept failing past its restart budget."""

    def __init__(self, name: str, restarts: int, last_rc: int):
        super().__init__(
            f"{name}: worker failed permanently after {restarts} "
            f"restart(s) (last exit code {last_rc})")
        self.restarts = restarts
        self.last_rc = last_rc


class WorkerSupervisor:
    """Relaunch a crashed worker process with bounded exponential backoff
    (``:910-986``). Each host runs one supervisor around its member: when
    a member dies the survivors' collectives raise within the heartbeat
    bound, every supervisor relaunches its own member, and the gang
    re-forms on the coordinator. The jitter is derived from
    ``(name, attempt)``: reproducible, and the members of a gang do not
    restart in lockstep. ``spawn(attempt)`` starts the worker and returns
    an object with ``wait() -> returncode`` (``subprocess.Popen``)."""

    def __init__(self, spawn, max_restarts: int = 2,
                 backoff_base_seconds: float = 1.0,
                 backoff_max_seconds: float = 30.0,
                 jitter_fraction: float = 0.25,
                 name: str = "worker", log=None):
        self.spawn = spawn
        self.max_restarts = max_restarts
        self.backoff_base_seconds = backoff_base_seconds
        self.backoff_max_seconds = backoff_max_seconds
        self.jitter_fraction = jitter_fraction
        self.name = name
        self.log = log or (lambda s: None)
        self.restart_count = 0

    def backoff_seconds(self, attempt: int) -> float:
        """Backoff before restart ``attempt`` (1-based): exponential, capped,
        with a deterministic jitter from ``(name, attempt)``."""
        import zlib

        base = min(self.backoff_base_seconds * (2.0 ** (attempt - 1)),
                   self.backoff_max_seconds)
        seed = zlib.crc32(f"{self.name}:{attempt}".encode()) / 0xFFFFFFFF
        return base * (1.0 + self.jitter_fraction * (2.0 * seed - 1.0))

    def run(self) -> int:
        """Run the worker to a clean exit; returns the restarts it took.
        Raises :class:`SupervisorExhaustedError` once ``max_restarts``
        relaunches have failed. An interrupted supervisor terminates its
        live worker before it re-raises: no orphan keeps training."""
        while True:
            proc = self.spawn(self.restart_count)
            try:
                rc = proc.wait()
            except BaseException:
                for method in ("terminate", "kill"):
                    try:
                        getattr(proc, method, lambda: None)()
                    except OSError:
                        pass
                if hasattr(proc, "poll"):
                    proc.wait()
                raise
            if rc == 0:
                return self.restart_count
            self.restart_count += 1
            if self.restart_count > self.max_restarts:
                self.log(f"{self.name}: exit code {rc}; restart budget "
                         f"({self.max_restarts}) exhausted")
                raise SupervisorExhaustedError(
                    self.name, self.restart_count - 1, rc)
            delay = self.backoff_seconds(self.restart_count)
            self.log(f"{self.name}: exit code {rc}; restart "
                     f"{self.restart_count}/{self.max_restarts} in "
                     f"{delay:.1f}s")
            time.sleep(delay)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="photon-ml-tpu multi-process data-sharded fit witness")
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0's store")
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--local-shards", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run_worker(args.process_id, args.num_processes, args.coordinator,
               rows=args.rows, dim=args.dim, device=args.device,
               local_shards=args.local_shards)


if __name__ == "__main__":
    main()
