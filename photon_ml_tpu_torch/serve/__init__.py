"""Scoring core shared by the batch scoring driver (port of
``photon_ml_tpu/serve``; the always-on service comes later)."""
