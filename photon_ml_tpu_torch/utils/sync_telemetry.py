"""Process-wide counter of explicit device→host fetch sites.

Port of ``photon_ml_tpu/utils/sync_telemetry.py`` (``record_host_fetch``
``:35``), with the same ``site=`` names, so one run's
``host_fetches_by_site`` reads alike in either package. Every intentional
blocking device→host read that the JAX package counts calls
:func:`record_host_fetch` next to its read: the coordinate-descent
epilogue (``cd.epilogue``), the lazy tracker and optimizer-history reads
(``tracker.materialize``, ``optimizer.history``), the lane-compaction
mask (``re.compact_mask``), a checkpoint snapshot (``ckpt.snapshot``),
the validation metrics (``eval.metrics``), a model grid's metrics
(``eval.grid``), the coefficient check (``glm.validate``) and a feature
summary (``stat.summary``). A run's count over its coordinate updates is
``host_syncs_per_update``. The port's photonlint (W104) finds a blocking
copy or wait whose function does not call :func:`record_host_fetch`.

A thin shim over the labeled ``host_fetches`` counter in
``photon_ml_tpu_torch.obs.metrics.REGISTRY`` (one storage, two views):
:func:`host_fetch_count` is the label-sum and ``metrics.jsonl`` carries
the per-site records. Callers that pass no ``site`` land under
``"unlabeled"``. Only instrumented sites are counted: a read the code
does not mark is invisible here by construction.
"""

from __future__ import annotations

from photon_ml_tpu_torch.obs.metrics import REGISTRY

#: Name of the labeled counter in ``obs.metrics.REGISTRY``.
HOST_FETCH_COUNTER = "host_fetches"


def record_host_fetch(n: int = 1, site: str = "unlabeled") -> None:
    REGISTRY.counter(HOST_FETCH_COUNTER).inc(n, site=site)


def reset_host_fetches() -> None:
    REGISTRY.counter(HOST_FETCH_COUNTER).reset()


def host_fetch_count() -> int:
    return int(REGISTRY.counter(HOST_FETCH_COUNTER).total())


def host_fetches_by_site() -> dict[str, int]:
    """Per-site fetch counts; values sum to :func:`host_fetch_count`."""
    return {k: int(v) for k, v in
            REGISTRY.counter(HOST_FETCH_COUNTER).by_label("site").items()}
