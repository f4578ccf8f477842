"""Per-span self-time regression diff between two traced runs.

Port of ``tools/trace_diff.py``: ``profile``, ``diff_profiles``,
``format_diff`` and ``main`` with the same flags, verdict rule, output
and exit codes. It reads its traces through its sibling
:mod:`photon_ml_tpu_torch.tools.trace_report` (``load_events``,
``self_times``), the standard library only.

"Did a change slow down ``cd.epilogue_fetch``?" becomes a command: compare a
baseline and a candidate trace (both ``--trace-dir`` ``trace.json``
documents, or ``trace_merge`` merged ones) span-name by span-name on
**self time per occurrence** — the same containment sweep
``trace_report`` ranks by, so a child span getting slower is
charged to the child, not to every ancestor above it.

The verdict is noise-aware, not a raw comparison:

- a span only REGRESSES when its per-occurrence self time grew by more
  than ``--threshold-pct`` (relative) AND the absolute growth clears
  ``--min-delta-ms`` — timer jitter on a microsecond-scale span can be
  300% of nothing;
- spans whose TOTAL self time stays under ``--min-self-ms`` in both
  runs are ignored entirely (sub-noise either way);
- spans present in only one run are reported (``added`` / ``removed``)
  but never fail the verdict by themselves — a new feature legitimately
  adds spans.

Exit codes: 0 = PASS (no regression), 1 = FAIL (at least one span
regressed), 2 = unreadable/empty input.

Usage::

    python -m photon_ml_tpu_torch.tools.trace_diff base/trace.json \\
        new/trace.json [--threshold-pct 30] [--min-self-ms 5] \\
        [--min-delta-ms 2] [--process 0] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

from photon_ml_tpu_torch.tools.trace_report import load_events, self_times


def profile(path: str, process: int | None = None) -> dict[str, dict]:
    """``{span name: {count, total_us, self_us}}`` for one trace."""
    events = load_events(path)
    if process is not None:
        events = [e for e in events if int(e.get("pid", 0)) == process]
    if not events:
        raise ValueError("no complete span events"
                         + (f" for process {process}"
                            if process is not None else ""))
    return self_times(events)


def diff_profiles(base: dict[str, dict], new: dict[str, dict],
                  threshold_pct: float = 30.0,
                  min_self_ms: float = 5.0,
                  min_delta_ms: float = 2.0) -> dict:
    """Span-by-span comparison + verdict (see module docstring for the
    noise rules). Per-occurrence self time is the compared quantity, so
    a run with more sweeps is not 'slower' just for doing more work."""
    min_self_us = min_self_ms * 1e3
    min_delta_us = min_delta_ms * 1e3
    spans = []
    regressions = []
    for name in sorted(set(base) | set(new)):
        b, n = base.get(name), new.get(name)
        if b is None or n is None:
            spans.append({"span": name,
                          "status": "added" if b is None else "removed"})
            continue
        if b["self_us"] < min_self_us and n["self_us"] < min_self_us:
            spans.append({"span": name, "status": "sub-noise"})
            continue
        b_per = b["self_us"] / max(b["count"], 1)
        n_per = n["self_us"] / max(n["count"], 1)
        delta_pct = (100.0 * (n_per - b_per) / b_per if b_per > 0
                     else float("inf"))
        entry = {
            "span": name,
            "base": {"count": b["count"], "self_us": b["self_us"],
                     "self_per_occurrence_us": b_per},
            "new": {"count": n["count"], "self_us": n["self_us"],
                    "self_per_occurrence_us": n_per},
            "delta_pct": delta_pct,
        }
        if (delta_pct > threshold_pct
                and (n_per - b_per) * min(b["count"], n["count"])
                > min_delta_us):
            entry["status"] = "regressed"
            regressions.append(entry)
        elif delta_pct < -threshold_pct:
            entry["status"] = "improved"
        else:
            entry["status"] = "stable"
        spans.append(entry)
    return {
        "kind": "trace_diff",
        "verdict": "FAIL" if regressions else "PASS",
        "thresholds": {"threshold_pct": threshold_pct,
                       "min_self_ms": min_self_ms,
                       "min_delta_ms": min_delta_ms},
        "regressions": [e["span"] for e in regressions],
        "spans": spans,
    }


def format_diff(report: dict) -> str:
    lines = [f"{'span':<24} {'base ms/occ':>12} {'new ms/occ':>12} "
             f"{'Δ%':>8}  status", "-" * 72]
    for e in report["spans"]:
        if "base" not in e:
            lines.append(f"{e['span']:<24} {'—':>12} {'—':>12} {'—':>8}"
                         f"  {e['status']}")
            continue
        lines.append(
            f"{e['span']:<24} "
            f"{e['base']['self_per_occurrence_us'] / 1e3:>12.3f} "
            f"{e['new']['self_per_occurrence_us'] / 1e3:>12.3f} "
            f"{e['delta_pct']:>+7.1f}%  {e['status']}")
    lines.append("")
    if report["regressions"]:
        lines.append(f"TRACE_DIFF_FAIL regressed="
                     f"{','.join(report['regressions'])}")
    else:
        lines.append("TRACE_DIFF_PASS no span regressed past the "
                     "thresholds")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="noise-aware per-span self-time regression diff "
                    "between two --trace-dir traces")
    p.add_argument("base", help="baseline trace.json")
    p.add_argument("new", help="candidate trace.json")
    p.add_argument("--threshold-pct", type=float, default=30.0,
                   help="relative per-occurrence self-time growth that "
                        "counts as a regression (default 30%%)")
    p.add_argument("--min-self-ms", type=float, default=5.0,
                   help="ignore spans whose total self time stays under "
                        "this in BOTH runs (default 5 ms)")
    p.add_argument("--min-delta-ms", type=float, default=2.0,
                   help="absolute total-growth floor a regression must "
                        "also clear (default 2 ms)")
    p.add_argument("--process", type=int, default=None,
                   help="restrict merged multi-process documents to one "
                        "track (pid) on both sides")
    p.add_argument("--json", action="store_true",
                   help="emit the full diff document as JSON")
    ns = p.parse_args(argv)
    try:
        base = profile(ns.base, process=ns.process)
        new = profile(ns.new, process=ns.process)
    except (OSError, ValueError) as e:
        print(f"trace_diff: {e}", file=sys.stderr)
        return 2
    report = diff_profiles(base, new, threshold_pct=ns.threshold_pct,
                           min_self_ms=ns.min_self_ms,
                           min_delta_ms=ns.min_delta_ms)
    print(json.dumps(report, indent=1) if ns.json
          else format_diff(report))
    return 0 if report["verdict"] == "PASS" else 1


if __name__ == "__main__":
    raise SystemExit(main())
