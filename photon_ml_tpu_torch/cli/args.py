"""Shared CLI flag grammars and the refusal of flags the port cannot run.

Port of ``photon_ml_tpu/cli/args.py`` — ``parse_key_value_map``,
``parse_section_keys_map`` and the precision flag pair — plus
``add_device_flag`` (the port's one extra flag) and
``refuse_unported``: a flag whose feature is not ported yet is never
accepted and ignored, it raises ``NotImplementedError`` naming the flag.
"""

from __future__ import annotations

import argparse

PRECISION_CHOICES = ("f32", "bf16")


def parse_key_value_map(s: str) -> dict[str, str]:
    """``key1:v|key2:v`` -> dict (Params.scala:316-371 line format)."""
    out = {}
    for line in s.split("|"):
        if not line.strip():
            continue
        key, _, value = line.partition(":")
        out[key.strip()] = value.strip()
    return out


def parse_section_keys_map(s: str) -> dict[str, list[str]]:
    return {k: [x.strip() for x in v.split(",") if x.strip()]
            for k, v in parse_key_value_map(s).items()}


def add_precision_flags(p: argparse.ArgumentParser) -> None:
    """``--precision`` and ``--collective-quant``, as the JAX drivers
    spell them; the port runs only ``f32`` and ``none``."""
    p.add_argument("--precision", choices=PRECISION_CHOICES, default="f32",
                   help="storage dtype for design-matrix tiles and entity "
                        "blocks (the port runs f32)")
    p.add_argument("--collective-quant", choices=("none", "int8"),
                   default="none",
                   help="wire format of mesh collectives (the port has no "
                        "mesh: none)")


def add_observability_flags(p: argparse.ArgumentParser) -> None:
    """The ``--trace-dir`` family; the port has no tracing yet, so any of
    them set is refused."""
    p.add_argument("--trace-dir")
    p.add_argument("--trace-heartbeat-seconds", type=float, default=10.0)
    p.add_argument("--trace-stall-seconds", type=float, default=120.0)
    p.add_argument("--telemetry-endpoint")
    p.add_argument("--device-telemetry", action="store_true")


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "fallback to the CPU — pass cpu to run the plain "
                        "PyTorch path)")


def refuse_unported(ns: argparse.Namespace, checks) -> None:
    """Raise ``NotImplementedError`` for the first ``(flag, is_set,
    why)`` of ``checks`` whose flag is set."""
    for flag, is_set, why in checks:
        if is_set:
            raise NotImplementedError(
                f"{flag} is not ported to photon_ml_tpu_torch yet ({why})")
