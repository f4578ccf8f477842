"""The scoring plane (port of ``photon_ml_tpu/serve``): the scoring core
shared with the batch scoring driver, and the always-on service —
``protocol`` (NDJSON wire protocol and client), ``batcher`` (bounded
queue, micro-batches), ``tiers`` (device / host / model coefficient
tiers), ``scoring`` (``ServingScorer``, ``GenerationStore``),
``reqtrace`` and ``service`` (``python -m
photon_ml_tpu_torch.serve.service``); the entity-sharded fleet in front of
several services: ``fleet`` (membership, health, routing) and ``router``
(``python -m photon_ml_tpu_torch.serve.router``, or the ``fleet`` verb of
``tools/photon_serve.py``), host-only."""
