"""CLI: ``python -m ray_tpu_torch.tools.raycheck [paths...]``.

With no paths, scans the installed ``ray_tpu_torch`` package. Exit status 0
means no unsuppressed, non-baselined findings; 1 means findings were
printed; 2 means usage error. ``--json`` emits a machine-readable
report (one object: findings + counts) for CI; ``--sarif PATH``
additionally writes a SARIF 2.1.0 log (the CI-archival interchange
format code-scanning UIs ingest); ``--update-baseline`` rewrites the
baseline file from the current findings so the grandfathering workflow
is mechanical instead of hand-edited."""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ray_tpu_torch.tools import raycheck
from ray_tpu_torch.tools.raycheck import rules as _rules


def to_sarif(findings) -> dict:
    """One SARIF 2.1.0 run: the rule table as reportingDescriptors,
    each finding as a result with a physical location. Paths are kept
    scan-root-relative (uriBaseId REPOROOT) so the log is stable across
    checkouts — the property the round-trip test pins."""
    by_code = {}
    for rule in _rules.all_rules():
        by_code[rule.code] = {
            "id": rule.code,
            "name": rule.title,
            "shortDescription": {"text": rule.title},
            "properties": {
                "scope": "program" if rule.program else "per-file"},
        }
    # RC00 (file does not parse) is synthesized by the loader, not the
    # rule table
    by_code.setdefault("RC00", {
        "id": "RC00", "name": "parse-error",
        "shortDescription": {"text": "file does not parse"},
        "properties": {"scope": "per-file"}})
    results = []
    for f in findings:
        results.append({
            "ruleId": f.code,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path,
                        "uriBaseId": "REPOROOT"},
                    "region": {"startLine": f.line},
                },
            }],
            "partialFingerprints": {"raycheckKey": f.key},
        })
    return {
        "$schema": ("https://json.schemastore.org/sarif-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "raycheck",
                "informationUri":
                    "https://example.invalid/ray_tpu_torch/tools/raycheck",
                "rules": [by_code[c] for c in sorted(by_code)],
            }},
            "results": results,
            "columnKind": "utf16CodeUnits",
        }],
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.tools.raycheck",
        description="repo-specific static analysis: concurrency, "
                    "determinism, wire-protocol, lifecycle, hygiene "
                    "& data-race invariants (RC01..RC17; RC06-RC09 "
                    "and RC12-RC17 are whole-program)")
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to scan (default: the ray_tpu_torch "
             "package)")
    parser.add_argument(
        "--baseline", default=None,
        help="baseline file of grandfathered finding keys "
             "(default: the shipped — empty — baseline.txt)")
    parser.add_argument(
        "--rules", default=None,
        help="comma-separated rule codes to run (default: all)")
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="print a machine-readable report (findings + counts) "
             "instead of human-oriented lines")
    parser.add_argument(
        "--sarif", default=None, metavar="PATH",
        help="also write a SARIF 2.1.0 report to PATH (\"-\" for "
             "stdout) — the machine format CI archives and "
             "code-scanning UIs ingest")
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline file with the current unsuppressed "
             "finding keys (then exit 0); entries are debt, the "
             "shipped baseline is pinned empty by test")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in _rules.all_rules():
            kind = "program " if rule.program else "per-file"
            print(f"{rule.code}  {kind}  {rule.title}")
        return 0

    selected = (args.rules.upper().split(",")
                if args.rules else None)
    paths = args.paths
    if not paths:
        import ray_tpu_torch

        paths = [os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))]

    findings = []
    # timing breakdown accumulated across scan roots: fact-extraction
    # seconds plus per-rule wall time, surfaced by --json (and by
    # check.sh when the scan overruns its budget)
    timings: dict = {}
    for path in paths:
        if not os.path.exists(path):
            print(f"raycheck: no such path: {path}", file=sys.stderr)
            return 2
        t: dict = {}
        findings.extend(raycheck.check_tree(path, rules=selected,
                                            timings=t))
        for k, v in t.items():
            timings[k] = round(timings.get(k, 0.0) + v, 4)

    if args.update_baseline:
        out = raycheck.save_baseline(
            (f.key for f in findings), args.baseline)
        print(f"raycheck: baseline updated with {len(findings)} "
              f"key(s): {out}")
        return 0

    baseline = raycheck.load_baseline(args.baseline)
    fresh = [f for f in findings if f.key not in baseline]
    baselined = len(findings) - len(fresh)
    if args.sarif:
        doc = json.dumps(to_sarif(fresh), indent=2)
        if args.sarif == "-":
            print(doc)
        else:
            with open(args.sarif, "w", encoding="utf-8") as f:
                f.write(doc + "\n")
    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in fresh],
            "count": len(fresh),
            "baselined": baselined,
            "clean": not fresh,
            "timings_s": timings,
        }, indent=2))
        return 1 if fresh else 0
    for finding in fresh:
        print(finding.render())
    tail = f" ({baselined} baselined)" if baselined else ""
    if fresh:
        print(f"raycheck: {len(fresh)} finding(s){tail}")
        return 1
    print(f"raycheck: clean{tail}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
