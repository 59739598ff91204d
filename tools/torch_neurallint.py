#!/usr/bin/env python
"""torch_neurallint: the PyTorch port's static checks (twin of
tools/neurallint.py).

Two engines, one exit code:

  * the contract sweep (``repro_torch.analysis.contracts``): every
    registered ``(op, mode)`` pair of ``repro_torch.ops`` over an
    edge-shape corpus on fake CPU tensors (cells whose plain versions read
    operand values run on seeded CPU operands), checking the dispatch,
    format, metadata, grad, block and shared-memory contracts;
  * the source lint (``repro_torch.analysis.lint``): rule-id'd checks of
    the port's files with per-line ``# neurallint: disable=RULE``
    suppressions.

Usage:
  python tools/torch_neurallint.py                 # both engines
  python tools/torch_neurallint.py --rules         # the rule catalog
  python tools/torch_neurallint.py --lint-only --paths src/repro_torch/ops
  python tools/torch_neurallint.py --select NL-HOST-SYNC,NL-MUTABLE-DEFAULT
  python tools/torch_neurallint.py --junit out.xml # also a JUnit report

Exit status: 0 clean, 1 findings, 2 usage or internal error.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))


def main(argv=None) -> int:
    from repro_torch.analysis import (RULES, junit_xml, lint_paths, render,
                                      verify_contracts)

    ap = argparse.ArgumentParser(prog="torch_neurallint",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--lint-only", action="store_true",
                    help="the source lint only (no contract sweep)")
    ap.add_argument("--contracts-only", action="store_true",
                    help="the contract sweep only (no source lint)")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="files / directories to lint (default: the port)")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to report (default: all)")
    ap.add_argument("--junit", default=None, metavar="FILE",
                    help="write a JUnit XML report")
    args = ap.parse_args(argv)

    if args.rules:
        for rule, desc in RULES.items():
            print(f"{rule}\n    {desc}")
        return 0
    if args.lint_only and args.contracts_only:
        ap.error("--lint-only and --contracts-only are mutually exclusive")

    selected = None
    if args.select:
        selected = {r.strip() for r in args.select.split(",") if r.strip()}
        unknown = selected - set(RULES)
        if unknown:
            ap.error(f"unknown rule id(s): {sorted(unknown)}")

    findings, checked = [], 0
    if not args.contracts_only:
        lint_findings, checked = lint_paths(args.paths, root=REPO)
        findings += lint_findings
        print(f"torch_neurallint: lint over {checked} file(s)")
    if not args.lint_only:
        report = verify_contracts()
        findings += report.findings
        checked += report.cells
        print(f"torch_neurallint: contract sweep: "
              f"{len(report.coverage)}/{len(report.registered)} registered "
              f"(op, mode) pairs covered in {report.cells} cells "
              f"({report.abstract} on fake tensors, {report.concrete} on "
              f"seeded CPU operands; {report.duration_s:.1f} s)")
        if report.uncovered:
            print(f"torch_neurallint: UNCOVERED: "
                  f"{sorted(report.uncovered)}")

    if selected is not None:
        findings = [f for f in findings if f.rule in selected]
    findings.sort(key=lambda f: (f.rule, f.path, f.line))

    if args.junit:
        Path(args.junit).write_text(junit_xml(findings, checked=checked),
                                    encoding="utf-8")
        print(f"torch_neurallint: JUnit report -> {args.junit}")
    print(render(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
