"""The scoring plane (port of ``photon_ml_tpu/serve``): the scoring core
shared with the batch scoring driver, and the always-on service —
``protocol`` (NDJSON wire protocol and client), ``batcher`` (bounded
queue, micro-batches), ``tiers`` (device / host / model coefficient
tiers), ``scoring`` (``ServingScorer``, ``GenerationStore``),
``reqtrace`` and ``service`` (``python -m
photon_ml_tpu_torch.serve.service``). The fleet router comes later."""
