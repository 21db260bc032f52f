"""SARIF 2.1.0 serialization of dflint findings.

One run, one tool ("dflint"), every registered rule described in
``tool.driver.rules`` so GitHub code scanning renders help text even for
rules with zero results.  Pure stdlib — this module must stay importable
without torch/numpy/pandas like the rest of the analysis package.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from distributed_forecasting_tpu_torch.analysis.core import REGISTRY, Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")

#: dflint severity -> SARIF result level
_LEVEL = {"error": "error", "warning": "warning", "info": "note"}


def _rule_descriptor(name: str) -> Dict:
    rule_cls = type(REGISTRY[name]())
    doc = (rule_cls.__doc__ or "").strip()
    short = doc.splitlines()[0].strip() if doc else name
    return {
        "id": name,
        "name": rule_cls.__name__,
        "shortDescription": {"text": short},
        "defaultConfiguration": {
            "level": _LEVEL.get(REGISTRY[name]().default_severity, "warning"),
        },
        # the docs catalogue is the canonical help text
        "helpUri": f"docs/static-analysis.md#{name}",
    }


def _location(path: str, line: int, message: str = "") -> Dict:
    loc: Dict = {
        "physicalLocation": {
            "artifactLocation": {
                "uri": path,
                "uriBaseId": "%SRCROOT%",
            },
            "region": {"startLine": line},
        },
    }
    if message:
        loc["message"] = {"text": message}
    return loc


def _result(finding: Finding, rule_index: Dict[str, int]) -> Dict:
    out: Dict = {
        "ruleId": finding.rule,
        "level": _LEVEL.get(finding.severity, "warning"),
        "message": {"text": finding.message},
        "locations": [_location(finding.path, finding.line)],
        # line-insensitive identity, same key the baseline uses — keeps
        # alerts stable across unrelated edits to the file
        "partialFingerprints": {
            "dflint/v1": "|".join(finding.fingerprint()),
        },
    }
    idx = rule_index.get(finding.rule)
    if idx is not None:
        out["ruleIndex"] = idx
    related = getattr(finding, "related", ())
    if related:
        # interprocedural findings carry a source->sink hop list: surface it
        # both as relatedLocations (rendered inline by code scanning) and as
        # one codeFlow/threadFlow ending at the sink, so the CI annotation
        # shows the path rather than just the final line
        out["relatedLocations"] = [
            _location(path, line, msg) for path, line, msg in related
        ]
        hops = [_location(path, line, msg) for path, line, msg in related]
        hops.append(_location(finding.path, finding.line, finding.message))
        out["codeFlows"] = [{
            "threadFlows": [{
                "locations": [{"location": hop} for hop in hops],
            }],
        }]
    return out


def to_sarif(findings: Iterable[Finding]) -> Dict:
    """A complete SARIF log dict for ``json.dumps``."""
    rules: List[Dict] = [_rule_descriptor(name) for name in sorted(REGISTRY)]
    rule_index = {r["id"]: i for i, r in enumerate(rules)}
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "dflint",
                    "informationUri": "docs/static-analysis.md",
                    "rules": rules,
                },
            },
            "results": [_result(f, rule_index) for f in findings],
        }],
    }
