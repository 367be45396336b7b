"""REPRO-B*: Backend capability contracts.

The reference's seed bug: a backend without per-transaction timers silently
returned *read* anchors for a *write* capture.  The repo's answer is the
``supports_*`` flag + ``UnsupportedCapability`` contract — an Engine
method gated by a flag must find the backend either declaring the
capability (and implementing the method) or raising.  This checker makes
the contract structural across every ``Backend`` subclass under
``src/repro_torch`` (sim, cuda, torchgrid, fault-injected, and whatever
comes next).

Invariants:

* **REPRO-B001** — a gated method is implemented while the resolved flag
  says ``False`` (an undeclared capability: Engine-level gates will skip
  a working path, or worse, a later edit flips the method to a stub and
  nothing notices).
* **REPRO-B002** — the flag resolves ``True`` while the method resolves
  to the raising stub (a phantom capability: the Engine gate passes and
  the call explodes at measurement time).
* **REPRO-B003** — the flag is assigned dynamically in ``__init__`` from
  something other than another backend's same flag (an opaque
  declaration the static contract cannot vouch for; wrappers must mirror
  ``inner.supports_*``).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.astutil import parse_module
from repro_torch.analysis.findings import Finding

# Engine-gated Backend methods and the flags that gate them
# (core/engine.py: capture_latency_list -> supports_latency,
# evaluate_contention fan-out -> supports_contention).
GATED_METHODS: Dict[str, str] = {
    "latency": "supports_latency",
    "contended_throughput": "supports_contention",
}

BASE_CLASS = "Backend"
GUARD_EXCEPTION = "UnsupportedCapability"


class _ClassFacts:
    def __init__(self, node: ast.ClassDef, path: str):
        self.node = node
        self.path = path
        self.name = node.name
        self.bases = [b.attr if isinstance(b, ast.Attribute) else b.id
                      for b in node.bases
                      if isinstance(b, (ast.Name, ast.Attribute))]
        self.methods: Dict[str, ast.FunctionDef] = {
            m.name: m for m in node.body
            if isinstance(m, ast.FunctionDef)}
        # flag -> True / False / "mirror" / "opaque"
        self.flags: Dict[str, object] = {}
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) \
                    and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id.startswith("supports_") \
                    and isinstance(stmt.value, ast.Constant):
                self.flags[stmt.targets[0].id] = bool(stmt.value.value)
        init = self.methods.get("__init__")
        if init is not None:
            for stmt in ast.walk(init):
                if not (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1):
                    continue
                target = stmt.targets[0]
                if not (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                        and target.attr.startswith("supports_")):
                    continue
                mirrored = any(
                    isinstance(n, ast.Attribute) and n.attr == target.attr
                    for n in ast.walk(stmt.value))
                self.flags[target.attr] = "mirror" if mirrored else "opaque"
                if not mirrored:
                    self.flags[target.attr + "__line"] = stmt.lineno


def _is_raising_stub(fn: ast.FunctionDef) -> bool:
    """The method's body is the contract stub: it raises the capability
    exception (docstrings and message-building assignments allowed)."""
    for stmt in fn.body:
        if isinstance(stmt, ast.Raise) and stmt.exc is not None:
            exc = stmt.exc
            name = ""
            if isinstance(exc, ast.Call):
                exc = exc.func
            if isinstance(exc, ast.Attribute):
                name = exc.attr
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name == GUARD_EXCEPTION:
                return True
    return False


def _collect_backends(paths: Sequence[Path],
                      repo_root: Optional[Path]) -> Dict[str, _ClassFacts]:
    classes: Dict[str, _ClassFacts] = {}
    for path in paths:
        rel = str(path.relative_to(repo_root)) if repo_root else str(path)
        tree = parse_module(path)
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                classes[node.name] = _ClassFacts(node, rel)
    return classes


def _backend_subclasses(classes: Dict[str, _ClassFacts]
                        ) -> List[_ClassFacts]:
    def derives(name: str, seen: frozenset = frozenset()) -> bool:
        if name == BASE_CLASS:
            return True
        facts = classes.get(name)
        if facts is None or name in seen:
            return False
        return any(derives(b, seen | {name}) for b in facts.bases)

    return [facts for name, facts in classes.items()
            if name != BASE_CLASS and derives(name)]


def _resolve(classes: Dict[str, _ClassFacts], cls: _ClassFacts,
             kind: str, key: str):
    """Walk the (single-inheritance) base chain for a flag value or a
    method definition; returns (value, defining class) or (None, None).
    Instance-level flag assignments shadow class attributes, matching
    Python attribute lookup."""
    current: Optional[_ClassFacts] = cls
    while current is not None:
        table = current.flags if kind == "flag" else current.methods
        if key in table:
            return table[key], current
        nxt = None
        for base in current.bases:
            if base in classes:
                nxt = classes[base]
                break
        current = nxt
    return None, None


def check_capability_contracts(paths: Sequence[Path], *,
                               repo_root: Optional[Path] = None
                               ) -> List[Finding]:
    classes = _collect_backends(paths, repo_root)
    findings: List[Finding] = []
    for cls in sorted(_backend_subclasses(classes), key=lambda c: c.name):
        for method, flag in sorted(GATED_METHODS.items()):
            flag_value, flag_owner = _resolve(classes, cls, "flag", flag)
            method_fn, method_owner = _resolve(classes, cls, "method",
                                               method)
            implemented = (method_fn is not None
                           and not _is_raising_stub(method_fn))
            if flag_value is None:
                # No declaration anywhere on the chain (fixture-only:
                # the real Backend base declares every flag False).
                if implemented:
                    findings.append(Finding(
                        invariant="REPRO-B001", path=cls.path,
                        line=cls.node.lineno,
                        message=(f"{cls.name} implements gated method "
                                 f"{method}() but never declares "
                                 f"{flag}"),
                        hint=(f"declare {flag} = True on {cls.name} (or "
                              f"raise {GUARD_EXCEPTION} from "
                              f"{method}())")))
                continue
            if flag_value == "opaque":
                line = cls.flags.get(flag + "__line", cls.node.lineno)
                findings.append(Finding(
                    invariant="REPRO-B003", path=cls.path,
                    line=int(line),  # type: ignore[arg-type]
                    message=(f"{cls.name} assigns {flag} dynamically "
                             f"from something other than a wrapped "
                             f"backend's {flag}"),
                    hint=(f"mirror the inner backend "
                          f"(self.{flag} = inner.{flag}) or declare a "
                          f"constant class attribute")))
                continue
            if flag_value == "mirror":
                # Wrapper contract: the flag tracks the wrapped backend,
                # so the wrapper must forward the method (a raising stub
                # under a mirrored-True flag is B002-equivalent).
                if not implemented:
                    findings.append(Finding(
                        invariant="REPRO-B002", path=cls.path,
                        line=cls.node.lineno,
                        message=(f"{cls.name} mirrors {flag} from its "
                                 f"inner backend but {method}() does "
                                 f"not delegate — a capable inner "
                                 f"backend would still raise"),
                        hint=f"delegate {method}() to the inner backend"))
                continue
            if implemented and flag_value is False:
                findings.append(Finding(
                    invariant="REPRO-B001", path=cls.path,
                    line=(method_fn.lineno
                          if method_owner is cls else cls.node.lineno),
                    message=(f"{cls.name}.{method}() is implemented but "
                             f"{flag} resolves False (declared on "
                             f"{flag_owner.name}) — Engine gates will "
                             f"skip a working path"),
                    hint=f"declare {flag} = True on {cls.name}"))
            elif not implemented and flag_value is True:
                findings.append(Finding(
                    invariant="REPRO-B002", path=cls.path,
                    line=cls.node.lineno,
                    message=(f"{cls.name} declares {flag} = True but "
                             f"{method}() resolves to the "
                             f"{GUARD_EXCEPTION} stub"
                             + (f" on {method_owner.name}"
                                if method_owner and method_owner is not cls
                                else "")),
                    hint=(f"implement {method}() or declare "
                          f"{flag} = False")))
    return findings
