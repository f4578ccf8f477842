"""photonlint core types: findings, suppressions, baseline, rule table.

Port of ``photon_ml_tpu/analysis/core.py``: the same ``Finding``,
``LintReport``, suppression grammar, W0 (suppression hygiene) and
baseline format, with ``RULES`` and ``FAMILIES`` cut to the families the
port runs (W0, W1, W6 and W8 in torch form, W4, W5, W9, WA, WB).

Identity model: a finding's *baseline key* is ``(rule, path, message)``
— deliberately line-number-free, so an unrelated edit that shifts a file
does not churn the committed baseline. Multiple identical findings in
one file are matched by count (the baseline entry carries how many
occurrences are grandfathered; extras are new).

Suppression grammar (checked, not free-form)::

    # photonlint: allow-W104(telemetry counted by the caller)
    # photonlint: allow-W1xx(whole family, e.g. for a fixture file)

The rule token is an exact id (``W104``) or a family wildcard
(``W1xx``). The parenthesized reason is REQUIRED — an empty or missing
reason makes the comment malformed and surfaces as a ``W001`` finding
instead of silently suppressing. A suppression on a comment-only line
applies to the next source line; otherwise it applies to its own line.
"""

from __future__ import annotations

import dataclasses
import json
import re
from collections import Counter
from typing import Iterable

# Rule catalog: id -> one-line description (the single source of truth —
# the CLI's --list-rules and the README table are generated from here).
RULES: dict[str, str] = {
    "W001": "malformed photonlint suppression comment",
    "W002": "photonlint suppression that suppresses nothing (stale "
            "directive)",
    "W101": "float()/int()/bool() on a device tensor forces a blocking "
            "device→host sync",
    "W102": ".item()/.tolist() on a device tensor forces a blocking "
            "device→host sync",
    "W103": "np.asarray()/.numpy() on a device tensor forces a blocking "
            "device→host sync",
    "W104": "blocking copy or wait (.cpu(), .to(\"cpu\") without "
            "non_blocking=True, synchronize()) outside an instrumented "
            "fetch site (no record_host_fetch in the enclosing function)",
    "W105": "deferred epilogue handle still unresolved at its second "
            "subsequent dispatch — pipeline depth exceeds the recovery "
            "contract",
    "W401": "fault_point() site name missing from the README "
            "PHOTON_FAULTS table",
    "W402": "README PHOTON_FAULTS table row names a fault point with no "
            "fault_point() site",
    "W403": "fault_point() called with a non-literal name (statically "
            "unanalyzable)",
    "W501": "snapshot key read on a restore path but never written by "
            "any checkpoint save site",
    "W502": "snapshot key written at a checkpoint save site but never "
            "read by any restore path",
    "W601": "shard-runner collective over an axis name no mesh defines "
            "(no *_AXIS constant, no literal run_shards/shard_map axis)",
    "W602": "collective (shard runner, ProcessSpan, gang exchange, "
            "torch.distributed) under Python control flow that branches "
            "on a device tensor or on the process's or shard's identity "
            "— shards or processes may disagree and hang the barrier",
    "W603": "shard_map in_specs/out_specs arity disagrees with the "
            "body's positional signature or its tuple returns",
    "W604": "Placement / axis_devices / mesh.shape axis that no mesh "
            "defines",
    "W801": "reduction over a bf16/f16/runtime-selected-dtype value "
            "without an f32 accumulator (no dtype= kwarg, no upcast)",
    "W802": "float64 on the card (dtype=torch.float64, .double(), "
            ".to(torch.float64)) — a fraction of the f32 rate and twice "
            "the bytes",
    "W804": "implicit bf16/f16 + f32/f64 promotion inside a loss or "
            "gradient path",
    "W901": "shared attribute/global written without the lock that "
            "guards it elsewhere (thread-body write visible to "
            "unlocked readers, or lock held on some writes but not "
            "all)",
    "W902": "signal handler doing more than async-signal-safe "
            "flag/Event latching",
    "W903": "thread started with no join/stop in any shutdown path — "
            "its lifetime is unbounded at exit",
    "W904": "inconsistent nested lock acquisition order across the "
            "package — deadlock shape",
    "WA00": "wire-protocol string (message kind / error name) built "
            "from a fully dynamic expression — statically unauditable",
    "WA01": "protocol kind sent by a client but handled by no server "
            "dispatch — the request can only come back as an "
            "unknown-kind error",
    "WA02": "server dispatch handles a protocol kind that no client "
            "ever sends (dead handler / renamed request)",
    "WA03": "typed serve error that can reach the wire but parses back "
            "as a generic error — name missing from typed_error()'s "
            "table",
    "WA04": "transport-classification set names an error that no code "
            "path can put on the wire (stale or aliased exception "
            "name)",
    "WA05": "reader accesses a wire-message field that no writer of "
            "that kind ever sets",
    "WB00": "telemetry name (counter/gauge/histogram/span) built from "
            "a fully dynamic expression — statically unauditable",
    "WB01": "emitted telemetry name missing from the README taxonomy "
            "tables",
    "WB02": "README taxonomy table row names a metric/span that "
            "nothing emits",
    "WB03": "consumer reads a metric/span name that nothing emits — "
            "phantom consumer / silent dashboard",
    "WB04": "label-key drift between emit sites sharing one metric "
            "name (per-label breakdowns silently fragment)",
}

FAMILIES = ("W0", "W1", "W4", "W5", "W6", "W8", "W9", "WA", "WB")

# The JAX linter's other families and rules, and why the port does not
# run them yet (``--rules`` naming one exits 2 with this reason, and
# ``--list-rules`` lists them as waiting).
WAITING: dict[str, str] = {
    "W2": "jit purity: the port has no torch.compile and no CUDA graph to "
          "trace; it waits for the first CUDA-graph path",
    "W3": "buffer donation: the port donates no buffer; it waits for the "
          "first CUDA-graph path",
    "W7": "retrace risk: the port has no jit cache to re-trace; it waits "
          "for the first CUDA-graph path",
    "W803": "a value round-tripped through numpy and fed back into a "
            "jitted callable re-traces on the promoted dtype: the port "
            "has no jit cache; it waits for the first CUDA-graph path",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # posix path relative to the lint root
    line: int
    col: int
    message: str

    @property
    def baseline_key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.message)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintReport:
    """Outcome of one lint run, after suppression + baseline filtering."""

    new: list[Finding]
    baselined: list[Finding]
    suppressed: list[Finding]
    stale_baseline: list[dict]  # entries whose findings no longer exist
    files_checked: int = 0
    # populated when an incremental cache is in play / --stats is asked
    cache_stats: dict | None = None
    timings: dict[str, float] | None = None

    @property
    def ok(self) -> bool:
        return not self.new

    def format_text(self) -> str:
        out = [f.format() for f in self.new]
        out.append(
            f"photonlint: {len(self.new)} new finding(s), "
            f"{len(self.baselined)} baselined, "
            f"{len(self.suppressed)} suppressed, "
            f"{self.files_checked} file(s) checked")
        if self.stale_baseline:
            out.append(
                f"photonlint: note: {len(self.stale_baseline)} stale "
                f"baseline entr(ies) no longer match any finding — "
                f"refresh with --write-baseline")
        return "\n".join(out)

    def format_json(self) -> str:
        return json.dumps({
            "version": 1,
            "ok": self.ok,
            "new": [f.to_json() for f in self.new],
            "baselined": [f.to_json() for f in self.baselined],
            "suppressed_count": len(self.suppressed),
            "stale_baseline": self.stale_baseline,
            "files_checked": self.files_checked,
        }, indent=2, sort_keys=True)


# -- suppressions ----------------------------------------------------------

# Valid:   photonlint: allow-W104(reason text)
# Family:  photonlint: allow-W1xx(reason text)
_ALLOW_RE = re.compile(
    r"photonlint:\s*allow-(W[0-9A-Z](?:\d\d|xx))\(([^)]*)\)")
# A comment is a directive only when it STARTS with the marker — prose
# that merely mentions the word is ignored.
_DIRECTIVE_RE = re.compile(r"^#\s*photonlint:")
_COMMENT_ONLY_RE = re.compile(r"^\s*#")


def rule_matches(pattern: str, rule: str) -> bool:
    """``W104`` matches exactly; ``W1xx`` matches the whole family."""
    if pattern.endswith("xx"):
        return rule.startswith(pattern[:-2])
    return rule == pattern


def _comments(lines: list[str]):
    """(line, comment text) for every real comment token — strings and
    docstrings that merely contain '#' are not comments."""
    import io
    import tokenize

    try:
        tokens = tokenize.generate_tokens(
            io.StringIO("\n".join(lines) + "\n").readline)
        return [(tok.start[0], tok.string) for tok in tokens
                if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # fall back to a line scan (still anchored on '#')
        out = []
        for i, raw in enumerate(lines, start=1):
            if "#" in raw:
                out.append((i, raw[raw.index("#"):]))
        return out


def parse_suppressions(
    lines: list[str], relpath: str
) -> tuple[dict[int, list[tuple[str, str]]], list[Finding]]:
    """Scan source comments for suppression directives.

    Returns ``(by_line, malformed)`` where ``by_line`` maps an
    *effective* 1-based line number to ``(rule_pattern, reason)`` pairs
    (a comment-only line's suppressions shift down to the next line, so
    they can sit above a long statement), and ``malformed`` holds W001
    findings for directives that failed to parse or lack a reason.
    """
    by_line: dict[int, list[tuple[str, str]]] = {}
    malformed: list[Finding] = []
    for i, comment in _comments(lines):
        if not _DIRECTIVE_RE.match(comment):
            continue
        raw = lines[i - 1]
        matches = list(_ALLOW_RE.finditer(comment))
        target = i
        if _COMMENT_ONLY_RE.match(raw):
            # standalone comment: guard the next SOURCE line, skipping
            # blank lines and further comment-only lines in between
            target = i + 1
            while target <= len(lines) and (
                    not lines[target - 1].strip()
                    or _COMMENT_ONLY_RE.match(lines[target - 1])):
                target += 1
        if not matches:
            malformed.append(Finding(
                "W001", relpath, i, max(raw.find("#"), 0),
                "unrecognized photonlint directive — expected "
                "# photonlint: allow-<rule>(reason)"))
            continue
        for m in matches:
            pattern, reason = m.group(1), m.group(2).strip()
            if not reason:
                malformed.append(Finding(
                    "W001", relpath, i, max(raw.find("#"), 0),
                    f"suppression allow-{pattern} has no reason — write "
                    f"# photonlint: allow-{pattern}(why this is safe)"))
                continue
            by_line.setdefault(target, []).append((pattern, reason))
    return by_line, malformed


def apply_suppressions(
    findings: Iterable[Finding],
    by_file: dict[str, dict[int, list[tuple[str, str]]]],
) -> tuple[list[Finding], list[Finding], set[tuple[str, int, str]]]:
    """Split findings into (kept, suppressed) using per-line directives.

    Also returns the set of directives that actually fired, as
    ``(path, line, rule_pattern)`` triples — the complement feeds W002
    (stale-suppression) detection.
    """
    kept: list[Finding] = []
    suppressed: list[Finding] = []
    used: set[tuple[str, int, str]] = set()
    for f in findings:
        entries = by_file.get(f.path, {}).get(f.line, [])
        hit = False
        for p, _ in entries:
            if rule_matches(p, f.rule):
                used.add((f.path, f.line, p))
                hit = True
        if hit:
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed, used


def unused_suppressions(
    by_file: dict[str, dict[int, list[tuple[str, str]]]],
    used: set[tuple[str, int, str]],
) -> list[Finding]:
    """W002 findings for directives that suppressed nothing.

    A directive is *used* when at least one finding on its target line
    matched its pattern; everything else is dead weight that would hide
    a future regression, so it surfaces as a finding of its own.
    """
    out: list[Finding] = []
    for path, by_line in sorted(by_file.items()):
        for line, entries in sorted(by_line.items()):
            for pattern, _reason in entries:
                if (path, line, pattern) not in used:
                    out.append(Finding(
                        "W002", path, line, 0,
                        f"suppression allow-{pattern} suppresses "
                        f"nothing — remove the stale directive"))
    return out


# -- baseline --------------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path) -> list[dict]:
    """Read a baseline file; returns its entry list ([] when absent)."""
    import os

    if path is None or not os.path.exists(path):
        return []
    with open(path) as fh:
        data = json.load(fh)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}; this "
            f"photonlint understands version {BASELINE_VERSION}")
    return list(data.get("entries", []))


def write_baseline(path, findings: Iterable[Finding]) -> int:
    """Write all ``findings`` as the new baseline; returns entry count."""
    counts = Counter(f.baseline_key for f in findings)
    entries = [
        {"rule": rule, "path": p, "message": message, "count": n}
        for (rule, p, message), n in sorted(counts.items())
    ]
    with open(path, "w") as fh:
        json.dump({
            "version": BASELINE_VERSION,
            "tool": "photonlint",
            "comment": "Grandfathered findings. Regenerate with "
                       "`python -m photon_ml_tpu_torch.tools.photonlint "
                       "--write-baseline`; "
                       "entries are (rule, path, message)-keyed and "
                       "line-number-free so edits that only move code "
                       "do not churn this file.",
            "entries": entries,
        }, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return len(entries)


def apply_baseline(
    findings: list[Finding], entries: list[dict]
) -> tuple[list[Finding], list[Finding], list[dict]]:
    """Split findings into (new, baselined); also report stale entries.

    Matching is by ``(rule, path, message)`` with per-key counts: a key
    budget of N grandfathers the first N occurrences (ordered by line)
    and everything beyond is new.
    """
    budget: Counter = Counter()
    for e in entries:
        budget[(e["rule"], e["path"], e["message"])] += int(
            e.get("count", 1))
    used: Counter = Counter()
    new: list[Finding] = []
    baselined: list[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col)):
        key = f.baseline_key
        if used[key] < budget[key]:
            used[key] += 1
            baselined.append(f)
        else:
            new.append(f)
    stale = [
        {"rule": r, "path": p, "message": m,
         "count": budget[(r, p, m)] - used[(r, p, m)]}
        for (r, p, m) in budget
        if used[(r, p, m)] < budget[(r, p, m)]
    ]
    return new, baselined, stale
