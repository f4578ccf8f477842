"""Validation metrics and evaluators (port of ``photon_ml_tpu/evaluation``)."""
