"""``python -m trivy_tpu_torch.analysis`` — run the repo-invariant
lint over the port's tree; exit 1 on unsuppressed findings, 2 on an
unknown rule (the reference's flags, text and exit codes).

* default root: the ``trivy_tpu_torch`` package;
  positional paths narrow the sweep to files or directories;
* ``--json`` emits the stable-sorted machine report (byte-stable
  across runs over the same tree — CI artifact diffs show exactly
  the new findings);
* ``--rules a,b`` restricts to a rule subset; ``--list-rules``
  prints the catalog.
"""

from __future__ import annotations

import argparse
import os
import sys

from .engine import Engine, analyze_tree, package_root
from .rules import default_rules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trivy_tpu_torch.analysis",
        description="Repo-invariant static analysis "
                    "(docs/static-analysis.md).")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to analyze "
                         "(default: the trivy_tpu_torch package)")
    ap.add_argument("--json", action="store_true",
                    help="stable-sorted JSON report on stdout")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule subset")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    rules = default_rules()
    if args.list_rules:
        for r in sorted(rules, key=lambda r: r.name):
            print(f"{r.name}: {r.summary}")
        return 0
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",")
                  if r.strip()}
        known = {r.name for r in rules}
        bad = wanted - known
        if bad:
            print("unknown rule(s): " + ", ".join(sorted(bad)),
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.name in wanted]
    engine = Engine(rules)

    if args.paths:
        base = package_root()
        files: list = []
        for p in args.paths:
            p = os.path.abspath(p)
            if os.path.isdir(p):
                files.extend(engine.tree_paths(p))
            else:
                files.append(p)
        modules = [engine.load_module(f, base)
                   for f in sorted(set(files))]
        report = engine.analyze(modules)
    else:
        report = analyze_tree(engine=engine)

    if args.json:
        print(report.to_json())
    else:
        print(report.text())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
