"""Observability (port of ``photon_ml_tpu/obs``): ``metrics`` (the labeled
registry), ``trace`` (the span tracer), ``heartbeat`` (stall-detecting
progress records), ``export`` (the live NDJSON telemetry stream),
``run`` (the ``--trace-dir`` integration of the drivers, the service and
the router), ``bridge`` (event bus → counters), ``devicemem`` (device
memory gauges), ``compile`` (build attribution) and ``otlp`` (NDJSON →
OTLP/HTTP JSON). Importing the package imports none of them."""
