"""Observability (port of ``photon_ml_tpu/obs``): the metrics registry and
the span tracer the serving plane records into. The trace writers, the
heartbeat and the telemetry exporter come later."""
