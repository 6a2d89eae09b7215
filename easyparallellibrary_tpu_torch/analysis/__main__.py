"""CLI: ``python -m easyparallellibrary_tpu_torch.analysis [paths...]``.

Runs the epl-lint rule set (analysis/rules.py) over the port's package
(or explicit paths), applies the checked-in baseline, and exits non-zero
when any NON-baselined finding remains — the same contract
``tests/test_torch_analysis.py``'s zero-findings test and ``make
lint-torch`` enforce.

The analysis code is stdlib-only and never imports the modules it
scans (pure AST): linting cannot execute package code or touch a
device, and a syntax-broken module is a parse-error report, not a
crash.  It needs no device argument: it runs nothing on one.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from easyparallellibrary_tpu_torch.analysis.core import (
    Analyzer, apply_baseline, default_baseline_path, load_baseline,
    package_root, write_baseline)


def main(argv: Optional[List[str]] = None) -> int:
  parser = argparse.ArgumentParser(
      prog="python -m easyparallellibrary_tpu_torch.analysis",
      description="epl-lint over the PyTorch port: static invariant "
                  "checker (load-once, host-sync, freed storage, metric "
                  "schema, span pairing, lock discipline, device "
                  "introspection)")
  parser.add_argument(
      "paths", nargs="*", default=None,
      help="files/directories to scan (default: the installed "
           "easyparallellibrary_tpu_torch package)")
  parser.add_argument(
      "--baseline", default=None,
      help="baseline JSON of grandfathered findings (default: "
           "analysis/baseline.json for the package scan; none for "
           "explicit paths)")
  parser.add_argument(
      "--write-baseline", action="store_true",
      help="write the current findings to the baseline file and exit 0 "
           "(grandfathering; shrink the file afterwards, never grow it)")
  parser.add_argument(
      "--list-rules", action="store_true",
      help="print the rule ids and one-line descriptions, then exit")
  args = parser.parse_args(argv)

  from easyparallellibrary_tpu_torch.analysis.rules import default_rules
  rules = default_rules()
  if args.list_rules:
    for rule in rules:
      print(f"{rule.name:<22}{rule.description}")
    return 0

  default_scan = not args.paths
  paths = args.paths if args.paths else [package_root()]
  baseline_path = args.baseline
  if baseline_path is None and default_scan:
    baseline_path = default_baseline_path()

  findings = []
  for path in paths:
    findings.extend(Analyzer(path, rules=default_rules()).run())
  findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

  if args.write_baseline:
    if not baseline_path:
      parser.error("--write-baseline needs --baseline for explicit paths")
    write_baseline(baseline_path, findings)
    print(f"epl-lint: wrote {len(findings)} finding(s) to "
          f"{baseline_path}")
    return 0

  baseline = load_baseline(baseline_path) if baseline_path else None
  if baseline:
    new, old = apply_baseline(findings, baseline)
  else:
    new, old = findings, []
  for f in new:
    print(f.format())
  if old:
    print(f"epl-lint: {len(old)} baselined finding(s) suppressed "
          f"({baseline_path})")
  if new:
    print(f"epl-lint: {len(new)} finding(s); fix them, or suppress "
          f"inline with '# epl-lint: disable=<rule> — <reason>'")
    return 1
  scanned = ", ".join(paths)
  print(f"epl-lint: clean ({scanned})")
  return 0


if __name__ == "__main__":
  sys.exit(main())
