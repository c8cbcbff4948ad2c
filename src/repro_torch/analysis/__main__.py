"""``python -m repro_torch.analysis [paths...]`` — run saralint over a tree.

Exits non-zero when any unsuppressed finding remains (errors *and*
warnings gate: a warning is a contract the author has neither fixed nor
explained).  ``--json`` emits machine-readable findings for tooling.
"""

from __future__ import annotations

import argparse
import sys

from . import CHECKS, run_paths
from .core import render_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="saralint: contract-checking static analysis")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to scan (default: "
                         "src/repro_torch)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON")
    ap.add_argument("--check", action="append", dest="checks", metavar="ID",
                    help="run only this check id (repeatable)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings")
    ap.add_argument("--list-checks", action="store_true",
                    help="list registered checks and exit")
    ns = ap.parse_args(argv)

    if ns.list_checks:
        for cid, (desc, _fn) in sorted(CHECKS.items()):
            print(f"{cid:18s} {desc}")
        return 0

    if ns.checks:
        unknown = [c for c in ns.checks if c not in CHECKS]
        if unknown:
            ap.error(f"unknown check id(s): {', '.join(unknown)}")

    findings = run_paths(ns.paths, only=ns.checks)
    print(render_report(findings, as_json=ns.json,
                        show_suppressed=ns.show_suppressed))
    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
