"""Run-scoped utilities: flag parsing, logging, date ranges.

Port of ``photon_ml_tpu/utils/__init__.py`` (``parse_flag``).
"""

from __future__ import annotations


def parse_flag(value) -> bool:
    """Parse a CLI boolean flag string the way the reference's Scala drivers
    parse "true"/"false" option values."""
    return str(value).strip().lower() in ("true", "1", "yes")
