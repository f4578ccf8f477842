"""Shared CLI flag grammars and the refusal of flags the port cannot run.

Port of ``photon_ml_tpu/cli/args.py`` — ``parse_key_value_map``,
``parse_section_keys_map``, ``check_telemetry_flags`` (``:31``), the
precision flag pair and ``precision_dtype`` (``:54-81``) and
``add_observability_flags`` — plus
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


def check_telemetry_flags(p: argparse.ArgumentParser,
                          ns: argparse.Namespace) -> None:
    """Fail flag misuse at parse time with argparse's one-line usage
    error (exit 2), with the JAX package's messages."""
    if getattr(ns, "device_telemetry", False) and not ns.trace_dir:
        p.error("--device-telemetry requires --trace-dir (compile spans "
                "and hbm gauges ride the run's span spill + heartbeat)")
    if not getattr(ns, "telemetry_endpoint", None):
        return
    if not ns.trace_dir:
        p.error("--telemetry-endpoint requires --trace-dir (the live "
                "stream is fed by the run's span spill + heartbeat)")
    from photon_ml_tpu_torch.obs.export import parse_endpoint

    try:
        parse_endpoint(ns.telemetry_endpoint)
    except ValueError as e:
        p.error(str(e))


def add_precision_flags(p: argparse.ArgumentParser) -> None:
    """``--precision`` and ``--collective-quant``, as the JAX drivers
    spell them; the port runs both precisions and ``--collective-quant
    none`` only."""
    p.add_argument("--precision", choices=PRECISION_CHOICES, default="f32",
                   help="storage dtype for design-matrix tiles and entity "
                        "blocks; labels, offsets, weights, parameters and "
                        "every reduction stay f32")
    p.add_argument("--collective-quant", choices=("none", "int8"),
                   default="none",
                   help="wire format of mesh collectives (the port has no "
                        "mesh: none)")


def precision_dtype(precision: str) -> "torch.dtype":
    """``--precision`` value → torch dtype for dataset storage."""
    import torch

    try:
        return {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    except KeyError:
        raise ValueError(
            f"unknown precision {precision!r}; "
            f"expected one of {PRECISION_CHOICES}") from None


def add_observability_flags(p: argparse.ArgumentParser,
                            heartbeat_default: float = 10.0,
                            stall_default: float = 120.0) -> None:
    """The ``--trace-dir`` flag family every long-running entry point
    shares (training, scoring, serving, the fleet router)."""
    p.add_argument("--trace-dir",
                   help="enable span tracing/metrics for this run and "
                        "write trace.json (Chrome trace events), "
                        "spans.jsonl, metrics.jsonl and "
                        "run_manifest.json here")
    p.add_argument("--trace-heartbeat-seconds", type=float,
                   default=heartbeat_default,
                   help="with --trace-dir: seconds between heartbeat "
                        "records appended to metrics.jsonl (<= 0 "
                        "disables the heartbeat thread)")
    p.add_argument("--trace-stall-seconds", type=float,
                   default=stall_default,
                   help="with --trace-dir: flag the run stalled when no "
                        "span closed for this long")
    p.add_argument("--telemetry-endpoint",
                   help="with --trace-dir: stream telemetry records "
                        "live to this consumer (host:port, "
                        "unix:/path.sock, or file:/path.jsonl)")
    p.add_argument("--device-telemetry", action="store_true",
                   help="with --trace-dir: arm the device plane "
                        "(build.compile spans for kernel, host-library "
                        "and column-sum-plan builds, hbm_bytes gauges, "
                        "peak_hbm_bytes on run_end)")


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
