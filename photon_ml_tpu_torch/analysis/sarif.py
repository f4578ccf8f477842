"""SARIF 2.1.0 output for photonlint — editor and CI consumption.

Port of ``photon_ml_tpu/analysis/sarif.py``; its rule catalog is the
port's ``core.RULES``.

One run, one tool, one result per *new* finding (baselined and
suppressed findings are deliberately omitted: SARIF consumers gate on
what's actionable, and the baseline already owns the grandfathered
set). The rule catalog is generated from ``core.RULES`` so the SARIF
``rules`` array, ``--list-rules`` and the README table can never
drift apart.
"""

from __future__ import annotations

import json

from photon_ml_tpu_torch.analysis.core import Finding, LintReport, RULES

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")
_INFO_URI = "https://github.com/photon-ml-tpu"  # repo docs anchor
# Every rule row lives in the README "Rule catalog" table; SARIF viewers
# surface helpUri as the rule's "more info" link.
_CATALOG_URI = _INFO_URI + "/blob/main/README.md#rule-catalog"


def _result(f: Finding) -> dict:
    return {
        "ruleId": f.rule,
        "level": "warning",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path,
                                     "uriBaseId": "SRCROOT"},
                "region": {"startLine": f.line,
                           "startColumn": f.col + 1},
            },
        }],
    }


def to_sarif(report: LintReport) -> dict:
    rules = [
        {
            "id": rule,
            "name": rule,
            "shortDescription": {"text": text},
            "helpUri": _CATALOG_URI,
            "defaultConfiguration": {"level": "warning"},
        }
        for rule, text in sorted(RULES.items())
    ]
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "photonlint",
                    "informationUri": _INFO_URI,
                    "rules": rules,
                },
            },
            "results": [_result(f) for f in report.new],
        }],
    }


def format_sarif(report: LintReport) -> str:
    return json.dumps(to_sarif(report), indent=2, sort_keys=True)
