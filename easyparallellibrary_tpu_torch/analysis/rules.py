"""epl-lint rule set of the PyTorch port (port of
``easyparallellibrary_tpu/analysis/rules.py``): the port's hard
invariants as AST checks.

Carried over as they are (plain Python in both packages):

* ``metric-schema`` — every literal namespace fed to
  ``registry.publish``/``publish_many``/``namespaced`` parses under the
  schema roots in ``observability/registry.py``;
* ``span-pairing`` — ``tracer.span(...)`` is entered, and every
  ``tracer.begin``/``end`` name has its counterpart somewhere in the
  package;
* ``lock-discipline`` — in classes that own a ``threading`` lock,
  attributes written under it anywhere are written under it
  everywhere (outside ``__init__``), and thread-entry paths never write
  shared attributes without it;
* ``suppression`` (core.py) — a disable comment carries its reason.

Retargeted to PyTorch:

* ``host-sync`` — no IMPLICIT device->host transfer on a hot path
  (serving/, observability/, sim/, runtime/loop.py): ``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``float()``/``int()``/
  ``bool()``, ``np.*``, f-string interpolation or a branch test of a
  value that flows from a step call.  A step call is a call of the
  ``step_fn`` a loop is handed, of a ``torch.compile`` alias, or of the
  model (``functional_call``, a ``*_logits`` step function).  The
  allowed crossing is the explicit fetch (``_fetch``: the serving
  engine's one device-to-host copy of a step), or a site suppressed with
  a justification.
* ``recompile-hazard`` — the port's counterpart of a compile is a
  kernel-library load (``_build.load`` / ``_build.build`` /
  ``ctypes.CDLL``: nvcc and the driver's module load, what the serving
  engine's compile sentinel counts) and ``torch.compile``.  Flagged: any
  of them inside a loop, ``torch.compile(...)(...)`` (a fresh wrapper
  per call compiles per call), and a string argument into a
  ``torch.compile`` alias (each distinct value guards anew).
* ``donation-after-use`` — the port donates no buffer (its steps write
  the KV caches and the optimizer state in place, and no argument dies
  at a call).  The nearest construct is a tensor whose storage was
  freed (``x.untyped_storage().resize_(0)`` or ``x.resize_(0)``):
  reading ``x`` afterwards in the same function, before reassigning
  it, reads a freed buffer.  The package has no such site today.
* ``device-introspection`` — ``torch.cuda.memory_stats`` /
  ``max_memory_allocated`` / ``mem_get_info``, ``torch.profiler.
  profile`` and ``FlopCounterMode`` live in observability/ and
  profiler/; elsewhere they are flagged on a hot path (serving/,
  runtime/loop.py) and inside any loop.

All analysis is intra-module (plus package-wide span pairing): the
rules trade whole-program soundness for zero-setup precision on this
codebase's idioms.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set, Tuple

from easyparallellibrary_tpu_torch.analysis.core import (
    RULE_DEVICE_INTROSPECTION, RULE_DONATION, RULE_HOST_SYNC,
    RULE_LOCK_DISCIPLINE, RULE_METRIC_SCHEMA, RULE_RECOMPILE,
    RULE_SPAN_PAIRING, AnalysisContext, Finding, ModuleInfo, Rule)

# Fallback when the scanned tree does not include observability/registry.py
# (fixture runs); the real run parses the authoritative tuple from source.
_DEFAULT_NAMESPACES = ("train", "serving", "comm", "resilience")

# Modules whose function bodies are hot paths for the host-sync rule:
# the serving loop, the training loop, the observability layer (which
# promises zero added syncs) and the fleet simulator's sweep loop.
_HOT_MARKERS = ("serving/", "observability/", "sim/")
_HOT_SUFFIXES = ("runtime/loop.py",)

# Callable parameter names treated as step entries (fit() receives the
# step as an argument).
_STEP_PARAM_NAMES = ("step_fn",)
# Model forwards whose results are device tensors: functional_call and
# the step functions named *_logits (models/gpt.py).
_FORWARD_FUNCS = ("functional_call", "torch.func.functional_call")
_FORWARD_SUFFIX = "_logits"
# The explicit device->host fetch (serving/engine.py ``_fetch``): its
# result is host data.
_FETCH_FUNCS = ("_fetch", "self._fetch")

# torch.compile: the wrapper whose calls hold compiled code.
_JIT_FUNCS = ("torch.compile",)
# Kernel-library loads: nvcc and the driver's module load.
_LOAD_FUNCS = ("_build.load", "_build.build", "ctypes.CDLL")


def _unparse(node: ast.AST, limit: int = 60) -> str:
  try:
    text = ast.unparse(node)
  except Exception:  # pragma: no cover - unparse of synthetic nodes
    text = f"<{type(node).__name__}>"
  return text if len(text) <= limit else text[:limit - 3] + "..."


def _expr_key(node: ast.AST) -> Optional[str]:
  """Stable key for a Name / dotted-attribute chain (``self._kv``),
  None for anything unkeyable."""
  if isinstance(node, ast.Name):
    return node.id
  if isinstance(node, ast.Attribute):
    base = _expr_key(node.value)
    return f"{base}.{node.attr}" if base else None
  return None


def _func_text(node: ast.AST) -> str:
  """Dotted text of a call's func for coarse matching."""
  key = _expr_key(node)
  return key if key is not None else _unparse(node, 80)


def _is_jit_call(node: ast.AST) -> bool:
  """A ``torch.compile(...)`` call (its result holds compiled code)."""
  return (isinstance(node, ast.Call)
          and _func_text(node.func) in _JIT_FUNCS)


def _is_load_call(node: ast.AST) -> bool:
  """A kernel-library load or a ``torch.compile``: the port's compiles."""
  return (isinstance(node, ast.Call)
          and (_func_text(node.func) in _LOAD_FUNCS or _is_jit_call(node)))


@dataclasses.dataclass
class JitInfo:
  """What is statically known about one ``torch.compile`` wrapper."""
  line: int = 0


def _jit_info(call: ast.Call) -> JitInfo:
  return JitInfo(line=call.lineno)


def _iter_functions(tree: ast.Module
                    ) -> Iterator[Tuple[str, Optional[str], ast.AST]]:
  """Yield (qualname, enclosing_class_or_None, node) for every def,
  outermost first.  Nested defs are yielded too (their ``self`` is the
  enclosing method's, which the per-class passes ignore safely)."""

  def walk(node, cls: Optional[str], prefix: str):
    for child in ast.iter_child_nodes(node):
      if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
        qual = f"{prefix}{child.name}"
        yield qual, cls, child
        yield from walk(child, cls, f"{qual}.<locals>.")
      elif isinstance(child, ast.ClassDef):
        yield from walk(child, child.name, f"{child.name}.")

  yield from walk(tree, None, "")


# --------------------------------------------------- compile alias index --


class _JitIndex:
  """Per-module map of names/attributes that hold ``torch.compile``
  wrappers (the JAX rule set's jit-alias index).

  Alias keys:
    * ``<Class>::self.<attr>``   — ``self._step_fn = ...`` in a method
    * ``<qual>::<name>``         — a local in function ``<qual>``
    * ``<module>::<name>``       — a module-level name
    * ``<qual>::<name>[<key>]``  — literal-key dict slot (zero.py idiom)

  Built with a small fixpoint so helper chains resolve:
  ``self._step_fn = self._build_step(...)`` where ``_build_step``
  returns ``self._compiled(...)`` which returns ``torch.compile(step)``.
  """

  def __init__(self, mod: ModuleInfo):
    self.aliases: Dict[str, JitInfo] = {}
    # qualname -> JitInfo for functions whose returns are jit wrappers.
    self.jit_returning: Dict[str, JitInfo] = {}
    self._functions = list(_iter_functions(mod.tree))
    self._module_body = [s for s in mod.tree.body
                         if not isinstance(s, (ast.FunctionDef,
                                               ast.AsyncFunctionDef,
                                               ast.ClassDef))]
    self._build()

  def _resolve_callee(self, call: ast.Call, cls: Optional[str]
                      ) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
      return f.id
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
        and f.value.id == "self" and cls):
      return f"{cls}.{f.attr}"
    return None

  def _producing_info(self, value: ast.AST, cls: Optional[str]
                      ) -> Optional[JitInfo]:
    """JitInfo when ``value`` evaluates to a jit wrapper, else None."""
    if isinstance(value, ast.IfExp):
      return (self._producing_info(value.body, cls)
              or self._producing_info(value.orelse, cls))
    if not isinstance(value, ast.Call):
      return None
    if _is_jit_call(value):
      return _jit_info(value)
    callee = self._resolve_callee(value, cls)
    if callee is not None and callee in self.jit_returning:
      return self.jit_returning[callee]
    return None

  def _build(self):
    # Fixpoint over jit-returning functions (helper chains are short;
    # two or three iterations settle everything in this repo).
    for _ in range(4):
      changed = False
      for qual, cls, fn in self._functions:
        if qual in self.jit_returning:
          continue
        for node in ast.walk(fn):
          if isinstance(node, ast.Return) and node.value is not None:
            info = self._producing_info(node.value, cls)
            if info is not None:
              self.jit_returning[qual] = info
              changed = True
              break
      if not changed:
        break
    # Alias assignments, scoped.  Module-level assignments scan as the
    # pseudo-scope "<module>" (every function's lookup falls back to
    # it, mirroring Python name resolution).
    scopes = [("<module>", None, s) for s in self._module_body]
    scopes += [(qual, cls, fn) for qual, cls, fn in self._functions]
    for qual, cls, fn in scopes:
      for node in ast.walk(fn):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
          continue
        value = node.value
        if value is None:
          continue
        info = self._producing_info(value, cls)
        if info is None:
          continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
          key = self._target_key(t, qual, cls)
          if key is not None:
            self.aliases[key] = info

  @staticmethod
  def _target_key(t: ast.AST, qual: str, cls: Optional[str]
                  ) -> Optional[str]:
    if isinstance(t, ast.Name):
      return f"{qual}::{t.id}"
    if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)):
      if t.value.id == "self" and cls:
        return f"{cls}::self.{t.attr}"
      return f"{qual}::{t.value.id}.{t.attr}"
    if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
        and isinstance(t.slice, ast.Constant)):
      return f"{qual}::{t.value.id}[{t.slice.value!r}]"
    return None

  def lookup_call(self, call: ast.Call, qual: str, cls: Optional[str]
                  ) -> Optional[JitInfo]:
    """JitInfo when ``call`` invokes a known jit alias from scope
    ``qual`` (method of ``cls``), else None."""
    f = call.func
    candidates: List[str] = []
    key = _expr_key(f)
    if key is not None:
      if key.startswith("self.") and cls:
        candidates.append(f"{cls}::{key}")
      candidates.append(f"{qual}::{key}")
      # Enclosing-function locals are visible to nested defs.
      parts = qual.split(".<locals>.")
      for i in range(len(parts) - 1, 0, -1):
        candidates.append(f"{'.<locals>.'.join(parts[:i])}::{key}")
      candidates.append(f"<module>::{key}")
    elif (isinstance(f, ast.Subscript) and isinstance(f.value, ast.Name)
          and isinstance(f.slice, ast.Constant)):
      sub = f"{f.value.id}[{f.slice.value!r}]"
      candidates.append(f"{qual}::{sub}")
      parts = qual.split(".<locals>.")
      for i in range(len(parts) - 1, 0, -1):
        candidates.append(f"{'.<locals>.'.join(parts[:i])}::{sub}")
    for c in candidates:
      if c in self.aliases:
        return self.aliases[c]
    return None


def jit_index(mod: ModuleInfo) -> _JitIndex:
  idx = mod.facts.get("jit_index")
  if idx is None:
    idx = mod.facts["jit_index"] = _JitIndex(mod)
  return idx


# ------------------------------------------------------------ host-sync --


_SYNC_BUILTINS = ("float", "int", "bool")
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy", "__array__")
_NP_NAMES = ("np", "numpy")


def _is_hot(mod: ModuleInfo) -> bool:
  # Match on the ABSOLUTE path, not the scan-root-relative one: when
  # the CLI is pointed at `.../serving` (or one file inside it) the rel
  # path no longer carries the `serving/` prefix, and the hot-path rule
  # must not go silently inert on exactly the file being linted.
  path = mod.path.replace("\\", "/")
  return (any(m in path for m in _HOT_MARKERS)
          or any(path.endswith(s) for s in _HOT_SUFFIXES))


class _TaintScan:
  """Intra-function taint from step-call results to implicit
  host-sync sinks.  Statements are processed in source order; branch
  bodies are processed sequentially (flow-insensitive within a
  statement list — precise enough for this codebase's straight-line
  hot loops)."""

  def __init__(self, rel: str, qual: str, cls: Optional[str],
               fn: ast.AST, index: _JitIndex,
               class_tainted: Set[str]):
    self.rel = rel
    self.qual = qual
    self.cls = cls
    self.fn = fn
    self.index = index
    self.class_tainted = class_tainted
    self.tainted: Set[str] = set()
    self.findings: List[Finding] = []
    self.attr_writes_tainted: Set[str] = set()  # 'self.x' keys
    self._seen_sites: Set[Tuple[int, int]] = set()

  # ---- expression taint

  def _is_seed_call(self, node: ast.Call) -> bool:
    if self.index.lookup_call(node, self.qual, self.cls) is not None:
      return True
    ftext = _func_text(node.func)
    return ((isinstance(node.func, ast.Name)
             and node.func.id in _STEP_PARAM_NAMES)
            or ftext in _FORWARD_FUNCS
            or ftext.endswith(_FORWARD_SUFFIX))

  def taint_of(self, node: ast.AST) -> bool:
    if node is None:
      return False
    if isinstance(node, (ast.Name, ast.Attribute)):
      key = _expr_key(node)
      if key is None:
        return isinstance(node, ast.Attribute) and self.taint_of(node.value)
      return key in self.tainted or key in self.class_tainted
    if isinstance(node, ast.Call):
      ftext = _func_text(node.func)
      if ftext in _FETCH_FUNCS:
        return False            # the sanctioned explicit fetch boundary
      if self._is_seed_call(node):
        return True
      if (isinstance(node.func, ast.Name)
          and node.func.id in _SYNC_BUILTINS):
        return False            # result is a host scalar (flagged below)
      if (isinstance(node.func, ast.Attribute)
          and isinstance(node.func.value, ast.Name)
          and node.func.value.id in _NP_NAMES):
        return False            # np result is host (flagged below)
      # A method on a tainted object keeps the device value
      # (x.astype, x.sum, metrics.get(...)).
      if isinstance(node.func, ast.Attribute) \
          and self.taint_of(node.func.value):
        return True
      return False
    if isinstance(node, ast.Subscript):
      return self.taint_of(node.value)
    if isinstance(node, (ast.BinOp,)):
      return self.taint_of(node.left) or self.taint_of(node.right)
    if isinstance(node, ast.UnaryOp):
      return self.taint_of(node.operand)
    if isinstance(node, ast.BoolOp):
      return any(self.taint_of(v) for v in node.values)
    if isinstance(node, ast.Compare):
      return self.taint_of(node.left) or any(
          self.taint_of(c) for c in node.comparators)
    if isinstance(node, ast.IfExp):
      return self.taint_of(node.body) or self.taint_of(node.orelse)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
      return any(self.taint_of(e) for e in node.elts)
    if isinstance(node, ast.Starred):
      return self.taint_of(node.value)
    return False

  # ---- sinks

  def _flag(self, node: ast.AST, what: str, expr: ast.AST):
    site = (node.lineno, node.col_offset)
    if site in self._seen_sites:
      return
    self._seen_sites.add(site)
    self.findings.append(Finding(
        RULE_HOST_SYNC, self.rel, node.lineno, node.col_offset,
        f"implicit host sync: {what} on {_unparse(expr)!r}, which "
        f"dataflows from a step result; fetch once via the explicit "
        f"fetch (_fetch) at a designated sync point, or suppress "
        f"with a justification"))

  def _scan_sinks(self, node: ast.AST):
    for sub in ast.walk(node):
      if isinstance(sub, ast.Call):
        if (isinstance(sub.func, ast.Name)
            and sub.func.id in _SYNC_BUILTINS and sub.args
            and self.taint_of(sub.args[0])):
          self._flag(sub, f"{sub.func.id}()", sub.args[0])
        elif (isinstance(sub.func, ast.Attribute)
              and isinstance(sub.func.value, ast.Name)
              and sub.func.value.id in _NP_NAMES):
          for a in list(sub.args) + [k.value for k in sub.keywords]:
            if self.taint_of(a):
              self._flag(sub, f"np.{sub.func.attr}()", a)
              break
        elif (isinstance(sub.func, ast.Attribute)
              and sub.func.attr in _SYNC_METHODS
              and self.taint_of(sub.func.value)):
          self._flag(sub, f".{sub.func.attr}()", sub.func.value)
      elif isinstance(sub, ast.FormattedValue) \
          and self.taint_of(sub.value):
        self._flag(sub, "f-string interpolation", sub.value)

  def _scan_branch_test(self, test: ast.AST):
    """Implicit bool() in a branch position forces a sync AND is a
    traced-branch hazard when the value is a device array."""
    values = test.values if isinstance(test, ast.BoolOp) else [test]
    for v in values:
      if isinstance(v, ast.UnaryOp) and isinstance(v.op, ast.Not):
        v = v.operand
      if isinstance(v, (ast.Name, ast.Attribute, ast.Subscript,
                        ast.Call)) and self.taint_of(v):
        self._flag(v, "implicit bool() in a branch condition", v)
      elif isinstance(v, ast.Compare) and not all(
          isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
          for op in v.ops):
        if self.taint_of(v):
          self._flag(v, "implicit bool() of an array comparison", v)

  # ---- statements

  def _assign_targets(self, targets: List[ast.AST], tainted: bool):
    for t in targets:
      if isinstance(t, (ast.Tuple, ast.List)):
        self._assign_targets(list(t.elts), tainted)
        continue
      if isinstance(t, ast.Starred):
        t = t.value
      key = _expr_key(t)
      if key is None:
        continue
      if tainted:
        self.tainted.add(key)
        if key.startswith("self."):
          self.attr_writes_tainted.add(key)
      else:
        self.tainted.discard(key)

  def run(self) -> "_TaintScan":
    body = getattr(self.fn, "body", [])
    self._run_body(body)
    return self

  def _run_body(self, body: List[ast.stmt]):
    for stmt in body:
      self._stmt(stmt)

  def _stmt(self, stmt: ast.stmt):
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
      return  # nested defs are scanned as their own functions
    if isinstance(stmt, ast.Assign):
      self._scan_sinks(stmt.value)
      self._assign_targets(stmt.targets, self.taint_of(stmt.value))
      return
    if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
      self._scan_sinks(stmt.value)
      self._assign_targets([stmt.target], self.taint_of(stmt.value))
      return
    if isinstance(stmt, ast.AugAssign):
      self._scan_sinks(stmt.value)
      if self.taint_of(stmt.value):
        self._assign_targets([stmt.target], True)
      return
    if isinstance(stmt, (ast.If, ast.While)):
      self._scan_branch_test(stmt.test)
      self._scan_sinks(stmt.test)
      self._run_body(stmt.body)
      self._run_body(stmt.orelse)
      return
    if isinstance(stmt, ast.For):
      self._scan_sinks(stmt.iter)
      self._assign_targets([stmt.target], self.taint_of(stmt.iter))
      self._run_body(stmt.body)
      self._run_body(stmt.orelse)
      return
    if isinstance(stmt, ast.With):
      for item in stmt.items:
        self._scan_sinks(item.context_expr)
      self._run_body(stmt.body)
      return
    if isinstance(stmt, ast.Try):
      self._run_body(stmt.body)
      for handler in stmt.handlers:
        self._run_body(handler.body)
      self._run_body(stmt.orelse)
      self._run_body(stmt.finalbody)
      return
    if isinstance(stmt, ast.Assert):
      self._scan_branch_test(stmt.test)
      self._scan_sinks(stmt.test)
      return
    if isinstance(stmt, (ast.Expr, ast.Return)) and stmt.value is not None:
      self._scan_sinks(stmt.value)
      return
    for sub in ast.iter_child_nodes(stmt):
      if isinstance(sub, ast.expr):
        self._scan_sinks(sub)


class HostSyncRule(Rule):
  name = RULE_HOST_SYNC
  description = ("no implicit device->host transfer on hot paths; "
                 "step results cross via the explicit fetch only")

  def check_module(self, mod: ModuleInfo, ctx: AnalysisContext
                   ) -> Iterator[Finding]:
    if not _is_hot(mod):
      return
    index = jit_index(mod)
    functions = list(_iter_functions(mod.tree))
    # Pass A: which self.<attr>s hold device values anywhere in each
    # class (assigned from a step result) — a method that only
    # READS the cache must still see `np.asarray(self._cursors)` as a
    # sync.
    class_tainted: Dict[str, Set[str]] = {}
    for qual, cls, fn in functions:
      scan = _TaintScan(mod.rel, qual, cls, fn, index, set()).run()
      if cls is not None and scan.attr_writes_tainted:
        class_tainted.setdefault(cls, set()).update(
            scan.attr_writes_tainted)
    # Pass B: report, with the class-wide device attrs seeded.
    for qual, cls, fn in functions:
      seeded = class_tainted.get(cls, set()) if cls else set()
      scan = _TaintScan(mod.rel, qual, cls, fn, index, seeded).run()
      yield from scan.findings


# ------------------------------------------------------ recompile-hazard --


class RecompileRule(Rule):
  name = RULE_RECOMPILE
  description = ("load-once discipline: no kernel-library load or "
                 "torch.compile in a loop, no per-call compile wrapper, "
                 "no strings into a compiled callable")

  def check_module(self, mod: ModuleInfo, ctx: AnalysisContext
                   ) -> Iterator[Finding]:
    index = jit_index(mod)
    for qual, cls, fn in _iter_functions(mod.tree):
      # (a) a load or a torch.compile inside a loop body: a library
      # load (nvcc, the driver's module load) or a fresh compiled
      # wrapper per iteration.
      for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.While)):
          for sub in ast.walk(node):
            if sub is node:
              continue
            if _is_load_call(sub):
              yield Finding(
                  self.name, mod.rel, sub.lineno, sub.col_offset,
                  f"{_func_text(sub.func)} inside a loop loads (or "
                  f"compiles) every iteration; hoist it out of the "
                  f"loop")
      # (b) torch.compile(...)(...) invoked at once inside a function:
      # the compile cache keys on the wrapped function OBJECT, so a
      # nested def/lambda compiled per call compiles per call.
      for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Call)
            and _is_jit_call(node.func)):
          yield Finding(
              self.name, mod.rel, node.lineno, node.col_offset,
              "torch.compile(...)(...) builds and invokes a fresh "
              "wrapper on every call of the enclosing function — each "
              "call compiles; cache the wrapper (or suppress for "
              "one-shot build/init paths)")
      # (c) string-typed arguments into a compiled callable: every
      # distinct string guards anew (and an f-string varies per call).
      for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
          continue
        if index.lookup_call(node, qual, cls) is None:
          continue
        for a in list(node.args) + [k.value for k in node.keywords]:
          is_str = (isinstance(a, ast.JoinedStr)
                    or (isinstance(a, ast.Constant)
                        and isinstance(a.value, str)))
          if is_str:
            yield Finding(
                self.name, mod.rel, a.lineno, a.col_offset,
                f"string argument {_unparse(a)!r} into a torch.compile "
                f"wrapper: each distinct value guards and compiles anew")


# ---------------------------------------------------- donation-after-use --


def _flat_statements(fn: ast.AST) -> List[ast.stmt]:
  """Every statement in ``fn`` (not nested defs), preorder."""
  out: List[ast.stmt] = []

  def walk(body):
    for stmt in body:
      if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
        continue
      out.append(stmt)
      for field in ("body", "orelse", "finalbody"):
        walk(getattr(stmt, field, []) or [])
      for handler in getattr(stmt, "handlers", []) or []:
        walk(handler.body)

  walk(getattr(fn, "body", []))
  return out


def _stores_key(stmt: ast.stmt, key: str) -> bool:
  targets: List[ast.AST] = []
  if isinstance(stmt, ast.Assign):
    targets = list(stmt.targets)
  elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
    targets = [stmt.target]
  elif isinstance(stmt, ast.For):
    targets = [stmt.target]
  flat: List[ast.AST] = []
  for t in targets:
    if isinstance(t, (ast.Tuple, ast.List)):
      flat.extend(t.elts)
    else:
      flat.append(t)
  return any(_expr_key(t if not isinstance(t, ast.Starred) else t.value)
             == key for t in flat)


def _loads_key(node: ast.AST, key: str,
               skip: Optional[ast.AST] = None) -> Optional[ast.AST]:
  for sub in ast.walk(node):
    if sub is skip:
      continue
    if isinstance(sub, (ast.Name, ast.Attribute)) \
        and isinstance(getattr(sub, "ctx", None), ast.Load) \
        and _expr_key(sub) == key:
      return sub
  return None


def _freed_key(stmt: ast.stmt) -> Optional[Tuple[str, ast.Call]]:
  """``(key, call)`` when ``stmt`` frees a tensor's storage in place:
  ``x.untyped_storage().resize_(0)`` / ``x.storage().resize_(0)`` /
  ``x.resize_(0)``."""
  if not isinstance(stmt, ast.Expr) or not isinstance(stmt.value, ast.Call):
    return None
  call = stmt.value
  f = call.func
  if not (isinstance(f, ast.Attribute) and f.attr == "resize_"
          and len(call.args) == 1 and isinstance(call.args[0], ast.Constant)
          and call.args[0].value == 0):
    return None
  target = f.value
  if (isinstance(target, ast.Call) and isinstance(target.func, ast.Attribute)
      and target.func.attr in ("untyped_storage", "storage")):
    target = target.func.value
  key = _expr_key(target)
  return (key, call) if key is not None else None


class DonationRule(Rule):
  """The port's counterpart of a read after donation: a tensor whose
  storage was freed in place (``resize_(0)``) read again in the same
  function before it is reassigned (module docstring)."""
  name = RULE_DONATION
  description = ("a tensor whose storage was freed (resize_(0)) is dead; "
                 "no reads before reassignment")

  @staticmethod
  def _own_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """Expressions belonging to ``stmt`` itself, EXCLUDING nested
    statement lists (a nested statement is visited on its own, in flat
    order)."""
    if isinstance(stmt, (ast.If, ast.While)):
      return [stmt.test]
    if isinstance(stmt, ast.For):
      return [stmt.iter]
    if isinstance(stmt, ast.With):
      return [i.context_expr for i in stmt.items]
    if isinstance(stmt, ast.Try):
      return []
    return [stmt]

  def check_module(self, mod: ModuleInfo, ctx: AnalysisContext
                   ) -> Iterator[Finding]:
    for qual, cls, fn in _iter_functions(mod.tree):
      stmts = _flat_statements(fn)
      for i, stmt in enumerate(stmts):
        freed = _freed_key(stmt)
        if freed is None:
          continue
        key, call = freed
        for later in stmts[i + 1:]:
          load = None
          for root in self._own_exprs(later):
            load = _loads_key(root, key)
            if load is not None:
              break
          if load is not None:
            yield Finding(
                self.name, mod.rel, load.lineno, load.col_offset,
                f"{key!r} is read after its storage was freed "
                f"(resize_(0) at line {call.lineno}): the buffer is "
                f"dead — reassign it first or keep the storage")
            break
          if _stores_key(later, key):
            break


# -------------------------------------------------------- metric-schema --


def _load_namespaces(ctx: AnalysisContext) -> Tuple[str, ...]:
  cached = ctx.package.get("namespaces")
  if cached is not None:
    return cached
  roots: Tuple[str, ...] = _DEFAULT_NAMESPACES
  for mod in ctx.modules:
    # Absolute-path match, like _is_hot: the authoritative tuple must
    # be found even when the scan root is observability/ itself.
    if not mod.path.replace("\\", "/").endswith(
        "observability/registry.py") or mod.tree is None:
      continue
    for node in ast.walk(mod.tree):
      if (isinstance(node, ast.Assign) and len(node.targets) == 1
          and isinstance(node.targets[0], ast.Name)
          and node.targets[0].id == "NAMESPACES"
          and isinstance(node.value, (ast.Tuple, ast.List))
          and all(isinstance(e, ast.Constant) for e in node.value.elts)):
        roots = tuple(e.value for e in node.value.elts)
  ctx.package["namespaces"] = roots
  return roots


def _literal_root(node: ast.AST) -> Optional[str]:
  """Root namespace segment of a literal/f-string key, or None when it
  cannot be determined statically."""
  if isinstance(node, ast.Constant) and isinstance(node.value, str):
    return node.value.split("/", 1)[0]
  if isinstance(node, ast.JoinedStr) and node.values:
    head = node.values[0]
    if isinstance(head, ast.Constant) and isinstance(head.value, str):
      if "/" in head.value:
        return head.value.split("/", 1)[0]
      if len(node.values) == 1:
        return head.value
  return None


class MetricSchemaRule(Rule):
  name = RULE_METRIC_SCHEMA
  description = ("literal namespaces fed to registry.publish*/"
                 "namespaced() parse under the schema roots")

  def check_module(self, mod: ModuleInfo, ctx: AnalysisContext
                   ) -> Iterator[Finding]:
    roots = _load_namespaces(ctx)

    def check(node: ast.AST) -> Iterator[Finding]:
      root = _literal_root(node)
      if root is not None and root not in roots:
        yield Finding(
            self.name, mod.rel, node.lineno, node.col_offset,
            f"metric namespace {_unparse(node)!r} is outside the "
            f"schema roots {list(roots)} "
            f"(observability/registry.py NAMESPACES)")

    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call) \
          or not isinstance(node.func, ast.Attribute):
        continue
      attr = node.func.attr
      if attr == "publish":
        ns = None
        if len(node.args) >= 3:
          ns = node.args[2]
        for kw in node.keywords:
          if kw.arg == "namespace":
            ns = kw.value
        if ns is not None:
          yield from check(ns)
      elif attr == "publish_many":
        mapping = node.args[1] if len(node.args) >= 2 else None
        for kw in node.keywords:
          if kw.arg == "by_namespace":
            mapping = kw.value
        if isinstance(mapping, ast.Dict):
          for k in mapping.keys:
            if k is not None:
              yield from check(k)
      elif attr == "namespaced" and node.args:
        yield from check(node.args[0])


# --------------------------------------------------------- span-pairing --


def _span_name_key(node: ast.AST) -> Optional[Tuple]:
  """Matchable key for a span name argument: literal text, or the
  f-string's literal skeleton with ``None`` at each placeholder (so
  ``f"request {req.uid}"`` and ``f"request {state.req.uid}"`` pair)."""
  if isinstance(node, ast.Constant) and isinstance(node.value, str):
    return ("lit", node.value)
  if isinstance(node, ast.JoinedStr):
    parts: List[Optional[str]] = []
    for v in node.values:
      if isinstance(v, ast.Constant):
        parts.append(v.value)
      else:
        parts.append(None)
    return ("fstr",) + tuple(parts)
  return None


def _is_tracer_expr(node: ast.AST) -> bool:
  if isinstance(node, ast.Name):
    return "tracer" in node.id
  if isinstance(node, ast.Attribute):
    return "tracer" in node.attr
  if isinstance(node, ast.Call):
    return _func_text(node.func).endswith("get_tracer")
  return False


class SpanPairingRule(Rule):
  name = RULE_SPAN_PAIRING
  description = ("span() entered as a context manager; every begin()/"
                 "end() name has its counterpart in the package")

  def __init__(self):
    self._begins: Dict[Tuple, List[Tuple[str, int, int]]] = {}
    self._ends: Dict[Tuple, List[Tuple[str, int, int]]] = {}

  def check_module(self, mod: ModuleInfo, ctx: AnalysisContext
                   ) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
        call = node.value
        if (isinstance(call.func, ast.Attribute)
            and call.func.attr == "span"
            and _is_tracer_expr(call.func.value)):
          yield Finding(
              self.name, mod.rel, call.lineno, call.col_offset,
              "tracer.span(...) discarded without entering it: the "
              "span records nothing — use `with tracer.span(...):` "
              "(or begin()/end() for cross-function spans)")
      if not isinstance(node, ast.Call) \
          or not isinstance(node.func, ast.Attribute):
        continue
      if node.func.attr in ("begin", "end") \
          and _is_tracer_expr(node.func.value) and node.args:
        key = _span_name_key(node.args[0])
        if key is None:
          continue
        book = self._begins if node.func.attr == "begin" else self._ends
        book.setdefault(key, []).append(
            (mod.rel, node.lineno, node.col_offset))

  def finalize(self, ctx: AnalysisContext) -> Iterator[Finding]:
    def describe(key: Tuple) -> str:
      if key[0] == "lit":
        return repr(key[1])
      return "f-string " + repr("".join(
          p if p is not None else "{...}" for p in key[1:]))

    for key, sites in sorted(self._begins.items()):
      if key not in self._ends:
        for rel, line, col in sites:
          yield Finding(
              self.name, rel, line, col,
              f"tracer.begin({describe(key)}) has no matching "
              f"tracer.end anywhere in the package: the span never "
              f"closes and the trace fails validate_trace")
    for key, sites in sorted(self._ends.items()):
      if key not in self._begins:
        for rel, line, col in sites:
          yield Finding(
              self.name, rel, line, col,
              f"tracer.end({describe(key)}) has no matching "
              f"tracer.begin anywhere in the package: the E event "
              f"closes nothing and breaks strict B/E pairing")
    self._begins.clear()
    self._ends.clear()


# ------------------------------------------------ device-introspection --


# Device introspection: the allocator's statistics and the card's memory
# (driver calls), a profiler window and the FLOP counter.
_INTROSPECTION_ATTRS = ("memory_stats", "max_memory_allocated",
                        "mem_get_info")
_INTROSPECTION_FUNCS = ("torch.profiler.profile", "profiler.profile",
                        "FlopCounterMode",
                        "torch.utils.flop_counter.FlopCounterMode",
                        "flop_counter.FlopCounterMode")
# Modules where introspection LIVES — exempt from the rule entirely.
_INTROSPECTION_HOMES = ("observability/", "profiler/")


def _introspection_name(call: ast.Call) -> Optional[str]:
  text = _func_text(call.func)
  if text in _INTROSPECTION_FUNCS:
    return text
  if isinstance(call.func, ast.Attribute) \
      and call.func.attr in _INTROSPECTION_ATTRS:
    return f".{call.func.attr}"
  return None


class DeviceIntrospectionRule(Rule):
  """Device introspection (the allocator's statistics, the card's
  memory, a ``torch.profiler`` window, the FLOP counter) is warmup-time
  or on-demand work: one read per cost card, one gauge sample on the
  stats cadence.  It lives in observability/ and profiler/.  The rule
  flags (a) ANY introspection call in a hot module (serving/,
  runtime/loop.py) and (b) introspection inside a loop anywhere outside
  the homes."""

  name = RULE_DEVICE_INTROSPECTION
  description = ("memory_stats/max_memory_allocated/mem_get_info, "
                 "torch.profiler.profile and FlopCounterMode only in "
                 "observability//profiler/, never on the per-step hot loop")

  def check_module(self, mod: ModuleInfo, ctx: AnalysisContext
                   ) -> Iterator[Finding]:
    path = mod.path.replace("\\", "/")
    if any(h in path for h in _INTROSPECTION_HOMES):
      return
    hot = ("serving/" in path
           or any(path.endswith(s) for s in _HOT_SUFFIXES))
    for qual, cls, fn in _iter_functions(mod.tree):
      loop_nodes: Set[int] = set()
      for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.While)):
          for sub in ast.walk(node):
            if sub is not node:
              loop_nodes.add(id(sub))
      for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
          continue
        what = _introspection_name(node)
        if what is None:
          continue
        if hot:
          yield Finding(
              self.name, mod.rel, node.lineno, node.col_offset,
              f"{what}() on a hot path: device introspection belongs in "
              f"observability/ (cost-card capture / gauge sampling) or "
              f"profiler/, never inline in the serving or training step")
        elif id(node) in loop_nodes:
          yield Finding(
              self.name, mod.rel, node.lineno, node.col_offset,
              f"{what}() inside a loop: per-iteration device "
              f"introspection stalls the very program it describes — "
              f"capture once (observability/device.py)")


# ------------------------------------------------------ lock-discipline --


_LOCK_CTORS = ("threading.Lock", "threading.RLock", "threading.Condition",
               "Lock", "RLock", "Condition")


def _class_methods(cls: ast.ClassDef
                   ) -> List[Tuple[str, ast.FunctionDef]]:
  return [(n.name, n) for n in cls.body
          if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _self_attr_stores(node: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
  """(attr_name, site) for every write to ``self.<attr>`` (plain
  assign/augassign and subscript stores like ``self._tracks[k] = v``)
  in ``node``, nested defs excluded."""
  for sub in ast.walk(node):
    targets: List[ast.AST] = []
    if isinstance(sub, ast.Assign):
      targets = list(sub.targets)
    elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
      targets = [sub.target]
    for t in targets:
      flat = list(t.elts) if isinstance(t, (ast.Tuple, ast.List)) else [t]
      for f in flat:
        if isinstance(f, ast.Starred):
          f = f.value
        if isinstance(f, ast.Subscript):
          f = f.value
        if (isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name) and f.value.id == "self"):
          yield f.attr, f


class _LockWalker:
  """Per-method split of self-attr writes into locked vs unlocked."""

  def __init__(self, lock_attrs: Set[str]):
    self.lock_attrs = lock_attrs
    self.locked: List[Tuple[str, ast.AST]] = []
    self.unlocked: List[Tuple[str, ast.AST]] = []

  def _is_lock_item(self, item: ast.withitem) -> bool:
    e = item.context_expr
    return (isinstance(e, ast.Attribute)
            and isinstance(e.value, ast.Name) and e.value.id == "self"
            and e.attr in self.lock_attrs)

  def walk(self, body: List[ast.stmt], held: bool):
    for stmt in body:
      if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
        continue
      if isinstance(stmt, ast.With):
        now_held = held or any(self._is_lock_item(i)
                               for i in stmt.items)
        for item in stmt.items:
          self._collect(item.context_expr, held)
        self.walk(stmt.body, now_held)
        continue
      for field in ("body", "orelse", "finalbody"):
        sub_body = getattr(stmt, field, None)
        if sub_body:
          self.walk(sub_body, held)
      for handler in getattr(stmt, "handlers", []) or []:
        self.walk(handler.body, held)
      if not any(getattr(stmt, f, None)
                 for f in ("body", "orelse", "finalbody", "handlers")):
        self._collect(stmt, held)

  def _collect(self, node: ast.AST, held: bool):
    for attr, site in _self_attr_stores(node):
      (self.locked if held else self.unlocked).append((attr, site))


class LockDisciplineRule(Rule):
  name = RULE_LOCK_DISCIPLINE
  description = ("attributes written under a class's lock anywhere are "
                 "written under it everywhere; thread-entry paths "
                 "never write shared attributes unlocked")

  def check_module(self, mod: ModuleInfo, ctx: AnalysisContext
                   ) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.ClassDef):
        yield from self._check_class(mod, node)

  def _check_class(self, mod: ModuleInfo, cls: ast.ClassDef
                   ) -> Iterator[Finding]:
    methods = _class_methods(cls)
    lock_attrs: Set[str] = set()
    for _, m in methods:
      for sub in ast.walk(m):
        if (isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call)
            and _func_text(sub.value.func) in _LOCK_CTORS):
          for attr, _site in _self_attr_stores(sub):
            lock_attrs.add(attr)
    if not lock_attrs:
      return
    per_method: Dict[str, _LockWalker] = {}
    for name, m in methods:
      walker = _LockWalker(lock_attrs)
      walker.walk(m.body, held=False)
      per_method[name] = walker
    guarded: Set[str] = set()
    for name, walker in per_method.items():
      if name != "__init__":
        guarded.update(attr for attr, _ in walker.locked)
    guarded -= lock_attrs
    lock_name = "/".join(sorted(lock_attrs))
    reported: Set[Tuple[int, int]] = set()
    # Violation A: inconsistent locking.
    for name, walker in per_method.items():
      if name == "__init__":
        continue
      for attr, site in walker.unlocked:
        if attr in guarded:
          key = (site.lineno, site.col_offset)
          if key not in reported:
            reported.add(key)
            yield Finding(
                self.name, mod.rel, site.lineno, site.col_offset,
                f"'{attr}' is written under self.{lock_name} elsewhere "
                f"in {cls.name} but written here without it — take the "
                f"lock or document why this write cannot race")
    # Violation B: thread-entry paths publishing shared state unlocked.
    entries: Set[str] = set()
    for _, m in methods:
      for sub in ast.walk(m):
        if isinstance(sub, ast.Call) \
            and _func_text(sub.func).endswith("Thread"):
          for kw in sub.keywords:
            if (kw.arg == "target" and isinstance(kw.value, ast.Attribute)
                and isinstance(kw.value.value, ast.Name)
                and kw.value.value.id == "self"):
              entries.add(kw.value.attr)
    if not entries:
      return
    calls: Dict[str, Set[str]] = {}
    for name, m in methods:
      calls[name] = set()
      for sub in ast.walk(m):
        if (isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and isinstance(sub.func.value, ast.Name)
            and sub.func.value.id == "self"):
          calls[name].add(sub.func.attr)
    reachable = set(entries)
    frontier = list(entries)
    while frontier:
      for callee in calls.get(frontier.pop(), ()):
        if callee in per_method and callee not in reachable:
          reachable.add(callee)
          frontier.append(callee)
    for name in sorted(reachable):
      for attr, site in per_method[name].unlocked:
        if attr in lock_attrs:
          continue
        if attr in guarded or not attr.startswith("_"):
          key = (site.lineno, site.col_offset)
          if key not in reported:
            reported.add(key)
            yield Finding(
                self.name, mod.rel, site.lineno, site.col_offset,
                f"'{attr}' is written on the monitor-thread path "
                f"({'/'.join(sorted(entries))}) of {cls.name} without "
                f"holding self.{lock_name}, while other threads read "
                f"it — guard the write")


def default_rules() -> List[Rule]:
  return [
      HostSyncRule(),
      RecompileRule(),
      DonationRule(),
      MetricSchemaRule(),
      SpanPairingRule(),
      LockDisciplineRule(),
      DeviceIntrospectionRule(),
  ]
