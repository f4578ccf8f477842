"""Operator tools of the port (port of the JAX package's ``tools/``)."""
