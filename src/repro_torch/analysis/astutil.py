"""Shared AST machinery for the repro-lint checkers.

The load-bearing abstraction is *root dependency tracing*
(:class:`DepTracer`): within one function, every expression is reduced to
the set of **root dependencies** it transitively reads, where a root is a
function parameter (``pt``) or one of its fields (``pt.params``).  Local
assignments are followed flow-sensitively in source order (last
assignment wins), so at any statement the tracer can answer "which
``pt.*`` fields does this value depend on?" — which is exactly the
question cache-key completeness asks.

The **receiver rule** encodes the repo's channel-broadcast invariant
(DESIGN.md §4): in *receiver-exclusive* mode, a method call's bare-name
receiver (``eng`` in ``eng.evaluate_latency(...)``) contributes nothing,
because on deterministic backends engine identity must not affect the
result — its *arguments* are what flow in.  Flight-key checks run
*receiver-inclusive* (non-deterministic backends are per-engine, so the
receiver's own dependencies count).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set


def parse_module(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def find_class(tree: ast.Module, name: str) -> Optional[ast.ClassDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def find_function(body: Sequence[ast.stmt],
                  name: str) -> Optional[ast.FunctionDef]:
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node  # type: ignore[return-value]
    return None


def module_functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    return {node.name: node for node in tree.body
            if isinstance(node, ast.FunctionDef)}


def public_functions(tree: ast.Module) -> List[ast.FunctionDef]:
    return [node for node in tree.body
            if isinstance(node, ast.FunctionDef)
            and not node.name.startswith("_")]


def dataclass_info(cls: ast.ClassDef) -> Dict[str, object]:
    """Decorator + field facts for a (possible) dataclass.

    Returns ``{"is_dataclass", "frozen", "eq", "fields", "no_compare"}``
    where ``fields`` is the ordered field-name list and ``no_compare``
    the subset declared with ``field(compare=False)``.
    """
    is_dc = False
    frozen = False
    eq = True
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = target.attr if isinstance(target, ast.Attribute) else (
            target.id if isinstance(target, ast.Name) else "")
        if name != "dataclass":
            continue
        is_dc = True
        if isinstance(dec, ast.Call):
            for kw in dec.keywords:
                if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                    frozen = bool(kw.value.value)
                if kw.arg == "eq" and isinstance(kw.value, ast.Constant):
                    eq = bool(kw.value.value)
    fields: List[str] = []
    no_compare: Set[str] = set()
    for stmt in cls.body:
        if not isinstance(stmt, ast.AnnAssign):
            continue
        if not isinstance(stmt.target, ast.Name):
            continue
        if isinstance(stmt.annotation, ast.Name) \
                and stmt.annotation.id == "ClassVar":
            continue
        fields.append(stmt.target.id)
        value = stmt.value
        if isinstance(value, ast.Call):
            fn = value.func
            fn_name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            if fn_name == "field":
                for kw in value.keywords:
                    if kw.arg == "compare" \
                            and isinstance(kw.value, ast.Constant) \
                            and kw.value.value is False:
                        no_compare.add(stmt.target.id)
    return {"is_dataclass": is_dc, "frozen": frozen, "eq": eq,
            "fields": fields, "no_compare": no_compare}


def statements_in_order(body: Sequence[ast.stmt]) -> Iterator[ast.stmt]:
    """Every statement, depth-first in source order (branch bodies are
    visited where they appear; good enough for the straight-line +
    guarded-branch shape of the cache methods)."""
    for stmt in body:
        yield stmt
        for attr in ("body", "orelse", "finalbody"):
            inner = getattr(stmt, attr, None)
            if inner:
                yield from statements_in_order(inner)
        for handler in getattr(stmt, "handlers", []) or []:
            yield from statements_in_order(handler.body)


class DepTracer:
    """Flow-sensitive root-dependency tracing over one function.

    ``roots`` are the parameter names whose (fields') flow is traced;
    dependency items are ``"pt"`` (the whole object) or ``"pt.field"``.
    Call :meth:`process` on each statement in source order; query an
    expression's dependencies with :meth:`deps` at any point.
    """

    def __init__(self, roots: Sequence[str], *,
                 include_receivers: bool = False):
        self.roots = set(roots)
        self.include_receivers = include_receivers
        self.env: Dict[str, Set[str]] = {}

    # -------------------------------------------------------------- query
    def deps(self, node: ast.AST, *,
             include_receivers: Optional[bool] = None) -> Set[str]:
        inc = (self.include_receivers if include_receivers is None
               else include_receivers)
        out: Set[str] = set()
        self._collect(node, out, inc)
        return out

    def _collect(self, node: ast.AST, out: Set[str], inc: bool) -> None:
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) \
                    and node.value.id in self.roots:
                out.add(f"{node.value.id}.{node.attr}")
                return
            self._collect(node.value, out, inc)
            return
        if isinstance(node, ast.Name):
            if node.id in self.roots:
                out.add(node.id)
            elif node.id in self.env:
                out |= self.env[node.id]
            return
        if isinstance(node, ast.Call):
            # Receiver rule: a bare-name method receiver is excluded in
            # receiver-exclusive mode (channel broadcast); field-valued
            # receivers (pt.params.validate(...)) always count.
            func = node.func
            if isinstance(func, ast.Attribute) \
                    and isinstance(func.value, ast.Name):
                if inc:
                    self._collect(func.value, out, inc)
            else:
                self._collect(func, out, inc)
            for arg in node.args:
                self._collect(arg, out, inc)
            for kw in node.keywords:
                self._collect(kw.value, out, inc)
            return
        for child in ast.iter_child_nodes(node):
            self._collect(child, out, inc)

    # ------------------------------------------------------------- update
    def process(self, stmt: ast.stmt) -> None:
        """Record the bindings a statement makes (last assignment wins)."""
        if isinstance(stmt, ast.Assign):
            value_deps = self.deps(stmt.value)
            for target in stmt.targets:
                self._bind(target, value_deps)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._bind(stmt.target, self.deps(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Name):
                prior = self.env.get(stmt.target.id, set())
                self.env[stmt.target.id] = prior | self.deps(stmt.value)

    def _bind(self, target: ast.expr, value_deps: Set[str]) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = set(value_deps)
        elif isinstance(target, (ast.Tuple, ast.List)):
            # Tuple unpack: every name carries the full RHS dependency
            # set (enabled, extra = eng.latency_config(...)).
            for elt in target.elts:
                self._bind(elt, value_deps)


def covers(required: Set[str], covered: Set[str], *,
           identity_attrs: Sequence[str] = ("name",)) -> Set[str]:
    """Required items NOT covered.

    A required item is covered by itself, by its whole root object
    (``pt`` covers ``pt.params``), or — for registry objects — by an
    identity attribute (``spec.name`` covers ``spec``, since registered
    specs are identified by name).
    """
    missing: Set[str] = set()
    for item in required:
        if item in covered:
            continue
        root = item.split(".", 1)[0]
        if root in covered:
            continue
        if any(f"{item}.{attr}" in covered for attr in identity_attrs):
            continue
        missing.add(item)
    return missing


def call_name(node: ast.Call) -> str:
    """Trailing name of the called function (``pl.BlockSpec`` →
    ``BlockSpec``)."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def int_const(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = int_const(node.operand)
        return -inner if inner is not None else None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.LShift):
        left, right = int_const(node.left), int_const(node.right)
        if left is not None and right is not None:
            return left << right
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        left, right = int_const(node.left), int_const(node.right)
        if left is not None and right is not None:
            return left * right
    return None
