"""epl-lint core (port of ``easyparallellibrary_tpu/analysis/core.py``):
findings, suppressions, baseline, and the analyzer driver.

The port defends the same hard invariants as the JAX package — load
once (a kernel library or ``torch.compile`` never mid-loop), no
implicit host syncs on the hot paths, the metric namespace schema,
strict B/E span pairing, tracer/watchdog lock discipline — and this
package is their static half: an AST pass over the port's own source
that checks them on EVERY path, pointing at the ``path:line`` that
breaks them.  The runtime complements stay in place (the engine's
compile sentinel, ``torch.cuda.set_sync_debug_mode`` in the tests).

Pieces:

* :class:`Finding` — one diagnostic: ``rule``, ``path`` (relative to
  the scan root), ``line``/``col``, ``message``.  Its fingerprint
  (rule, path, message) is line-number-free so a checked-in baseline
  survives unrelated edits above a grandfathered finding.
* **Suppressions** — ``# epl-lint: disable=<rule>[,<rule>...] — <why>``
  on the offending line (or on its own line directly above) silences
  those rules there.  The justification is MANDATORY: a disable comment
  with no reason is itself a finding (rule ``suppression``).
* **Baseline** — a checked-in JSON list of fingerprints
  (:func:`load_baseline` / :func:`write_baseline`); findings in the
  baseline are reported separately and do not fail the run.  The
  shipped baseline is empty.
* :class:`Analyzer` — parses every ``*.py`` under a root once, hands
  the module set to each registered rule (``check_module`` per module,
  ``finalize`` for cross-module checks like package-wide B/E span
  pairing), and filters the result through suppressions + baseline.

Pure stdlib (``ast``/``tokenize``) and pure AST: the analyzed modules
are never imported, so linting cannot execute package code or touch a
device.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from collections import Counter
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

# Rule ids are stable API: suppression comments and the baseline file
# reference them by name (the rule table is in analysis/rules.py).
RULE_HOST_SYNC = "host-sync"
RULE_RECOMPILE = "recompile-hazard"
RULE_DONATION = "donation-after-use"
RULE_METRIC_SCHEMA = "metric-schema"
RULE_SPAN_PAIRING = "span-pairing"
RULE_LOCK_DISCIPLINE = "lock-discipline"
RULE_DEVICE_INTROSPECTION = "device-introspection"
RULE_SUPPRESSION = "suppression"

# Rule ids may contain hyphens ("recompile-hazard"), so a bare "-"
# separates the reason only when spaced; em/en dashes, "--" and ":"
# always do.
_DISABLE_RE = re.compile(
    r"#\s*epl-lint:\s*disable=([A-Za-z0-9_,\- ]+?)\s*"
    r"(?:(?:—|–|--|\s-\s|:)\s*(.*))?$")


@dataclasses.dataclass(frozen=True)
class Finding:
  """One diagnostic, pointing at ``path:line``."""
  rule: str
  path: str        # relative to the scan root, posix separators
  line: int
  col: int
  message: str

  def fingerprint(self) -> Tuple[str, str, str]:
    """Line-free identity used by the baseline (unrelated edits must
    not churn grandfathered entries)."""
    return (self.rule, self.path, self.message)

  def format(self) -> str:
    return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
           f"{self.message}"


class Suppressions:
  """Per-module map of line -> set of rule names disabled there.

  A trailing comment suppresses its own line; a comment alone on a line
  suppresses the next line that holds code (so multi-line statements
  can carry the justification above them).  ``findings`` collects
  malformed disables (missing reason / empty rule list) — enforced as
  first-class findings so a suppression can never silently drop its
  why-comment.
  """

  def __init__(self, rel_path: str, source: str):
    self.by_line: Dict[int, set] = {}
    self.findings: List[Finding] = []
    comment_only: List[Tuple[int, set]] = []
    try:
      tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
      return
    lines = source.splitlines()
    for tok in tokens:
      if tok.type != tokenize.COMMENT:
        continue
      m = _DISABLE_RE.search(tok.string)
      if m is None:
        if "epl-lint:" in tok.string:
          self.findings.append(Finding(
              RULE_SUPPRESSION, rel_path, tok.start[0], tok.start[1],
              "malformed epl-lint comment: expected "
              "'# epl-lint: disable=<rule>[,<rule>] — <reason>'"))
        continue
      rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
      reason = (m.group(2) or "").strip()
      if not rules or not reason:
        self.findings.append(Finding(
            RULE_SUPPRESSION, rel_path, tok.start[0], tok.start[1],
            "epl-lint suppression without a justification: write "
            "'# epl-lint: disable=<rule> — <why this is allowed>'"))
        continue
      line_no = tok.start[0]
      code_before = lines[line_no - 1][:tok.start[1]].strip() \
          if line_no - 1 < len(lines) else ""
      if code_before:
        self.by_line.setdefault(line_no, set()).update(rules)
      else:
        comment_only.append((line_no, rules))
    # A standalone comment applies to the next line carrying code (skip
    # over further comment/blank lines so stacked disables all bind to
    # the same statement).
    for line_no, rules in comment_only:
      target = line_no + 1
      while target - 1 < len(lines):
        text = lines[target - 1].strip()
        if text and not text.startswith("#"):
          break
        target += 1
      self.by_line.setdefault(target, set()).update(rules)

  def is_suppressed(self, rule: str, line: int) -> bool:
    return rule in self.by_line.get(line, ())


class ModuleInfo:
  """One parsed source file plus its lazily cached per-rule facts."""

  def __init__(self, path: str, rel: str, source: str,
               tree: Optional[ast.Module], parse_error: Optional[str]):
    self.path = path
    self.rel = rel
    self.source = source
    self.tree = tree
    self.parse_error = parse_error
    self.suppressions = Suppressions(rel, source)
    # Scratch space rules share (e.g. the jit-alias index is computed
    # once and read by host-sync, recompile and donation rules).
    self.facts: Dict[str, Any] = {}


class Rule:
  """Base class: one invariant checker.

  ``check_module`` runs per module; ``finalize`` runs once after every
  module was seen (cross-module checks).  ``ctx`` is the shared
  :class:`AnalysisContext`.
  """
  name = "rule"
  description = ""

  def check_module(self, mod: ModuleInfo, ctx: "AnalysisContext"
                   ) -> Iterator[Finding]:
    return iter(())

  def finalize(self, ctx: "AnalysisContext") -> Iterator[Finding]:
    return iter(())


class AnalysisContext:
  """Shared state across rules for one analyzer run."""

  def __init__(self, root: str, modules: List[ModuleInfo]):
    self.root = root
    self.modules = modules
    # Cross-rule/package facts (rules key their own sub-dicts).
    self.package: Dict[str, Any] = {}


def _iter_py_files(root: str) -> Iterator[str]:
  if os.path.isfile(root):
    yield root
    return
  for dirpath, dirnames, filenames in os.walk(root):
    dirnames[:] = sorted(d for d in dirnames
                         if d not in ("__pycache__", ".git"))
    for name in sorted(filenames):
      if name.endswith(".py"):
        yield os.path.join(dirpath, name)


class Analyzer:
  """Drive the registered rules over every module under ``root``."""

  def __init__(self, root: str, rules: Optional[List[Rule]] = None):
    if rules is None:
      from easyparallellibrary_tpu_torch.analysis.rules import default_rules
      rules = default_rules()
    self.root = os.path.abspath(root)
    self.rules = rules

  def _load_modules(self) -> List[ModuleInfo]:
    modules = []
    base = self.root if os.path.isdir(self.root) \
        else os.path.dirname(self.root)
    for path in _iter_py_files(self.root):
      rel = os.path.relpath(path, base).replace(os.sep, "/")
      try:
        with open(path, encoding="utf-8") as f:
          source = f.read()
      except (OSError, UnicodeDecodeError) as e:
        modules.append(ModuleInfo(path, rel, "", None,
                                  f"{type(e).__name__}: {e}"))
        continue
      try:
        tree = ast.parse(source, filename=path)
        err = None
      except SyntaxError as e:
        tree, err = None, f"SyntaxError: {e}"
      modules.append(ModuleInfo(path, rel, source, tree, err))
    return modules

  def run(self) -> List[Finding]:
    """All findings (suppression-filtered, NOT baseline-filtered),
    sorted by path/line/rule for deterministic output."""
    modules = self._load_modules()
    ctx = AnalysisContext(self.root, modules)
    findings: List[Finding] = []
    for mod in modules:
      findings.extend(mod.suppressions.findings)
      if mod.tree is None:
        continue
      for rule in self.rules:
        for f in rule.check_module(mod, ctx):
          findings.append(f)
    for rule in self.rules:
      findings.extend(rule.finalize(ctx))
    by_rel = {m.rel: m for m in modules}
    kept, seen = [], set()
    for f in findings:
      if f in seen:
        continue  # two rule passes reaching one site report it once
      seen.add(f)
      sup = by_rel.get(f.path)
      if sup is not None and sup.suppressions.is_suppressed(f.rule, f.line):
        continue
      kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule, f.message))
    return kept


# ----------------------------------------------------------- baseline --


def load_baseline(path: str) -> Counter:
  """Fingerprint multiset of grandfathered findings (empty when the
  file is absent — an absent baseline means nothing is grandfathered)."""
  if not path or not os.path.exists(path):
    return Counter()
  with open(path, encoding="utf-8") as f:
    doc = json.load(f)
  entries = doc.get("findings", []) if isinstance(doc, dict) else doc
  return Counter(
      (e["rule"], e["path"], e["message"]) for e in entries)


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
  doc = {
      "comment": "epl-lint grandfathered findings of the PyTorch port; "
                 "new findings FAIL the run. Shrink this file, never "
                 "grow it.",
      "findings": [
          {"rule": f.rule, "path": f.path, "message": f.message}
          for f in findings],
  }
  with open(path, "w", encoding="utf-8") as f:
    json.dump(doc, f, indent=1, sort_keys=False)
    f.write("\n")


def apply_baseline(findings: List[Finding], baseline: Counter
                   ) -> Tuple[List[Finding], List[Finding]]:
  """Split findings into (new, baselined).  Each baseline fingerprint
  absorbs as many occurrences as it was recorded with."""
  budget = Counter(baseline)
  new, old = [], []
  for f in findings:
    fp = f.fingerprint()
    if budget.get(fp, 0) > 0:
      budget[fp] -= 1
      old.append(f)
    else:
      new.append(f)
  return new, old


def default_baseline_path() -> str:
  return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "baseline.json")


def package_root() -> str:
  """The easyparallellibrary_tpu_torch package directory (the default
  scan target for ``python -m easyparallellibrary_tpu_torch.analysis``)."""
  return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
