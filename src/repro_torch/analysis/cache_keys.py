"""REPRO-C*: memo/dedup cache-key completeness.

The bug family this prevents shipped twice in the reference before its
Sweep keys were hardened: a parameter (``placement``, ``arbitration``,
``burst_beats``) flowed into an evaluation but not into the memo key, so
two different grid points served one cached result.  The checker re-derives, per cache-store
site, which ``SweepPoint`` fields the *stored value* transitively depends
on (``astutil.DepTracer``) and requires each to be covered by the key
expression.

Invariants:

* **REPRO-C001** — a cache/flight store's value depends on a traced field
  the key does not cover.
* **REPRO-C002** — a class used as (part of) a cache key is not a frozen
  ``eq`` dataclass.
* **REPRO-C003** — a keyword parameter of a public timing-model function
  has no corresponding ``SweepPoint`` field (direct or derived), i.e. the
  axis exists in the model but cannot be keyed by the sweep layer.
* **REPRO-C004** — the service dedup key omits request state: an
  ``ExperimentRequest`` field is excluded from comparison
  (``compare=False``) while the execution path reads it, or the response
  cache is keyed by less than the whole request.

Memo-cache stores (attribute name contains ``cache``) are checked
receiver-exclusively — the channel-broadcast invariant says engine
identity must not affect deterministic results.  Flight stores
(``flight`` in the name) coalesce on *non-deterministic* backends, where
the engine's own dependencies (its channel) must be part of the key, so
they are checked receiver-inclusively.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.astutil import (DepTracer, covers, dataclass_info,
                                    find_class, parse_module,
                                    statements_in_order)
from repro_torch.analysis.findings import Finding

# Timing-model keyword parameters that no SweepPoint field matches by
# name, with the fields they are derived from (Engine.latency_config
# folds dst_channel + switch_enabled into switch_extra_cycles).
DERIVED_PARAMS: Dict[str, Tuple[str, ...]] = {
    "switch_extra_cycles": ("dst_channel", "switch_enabled"),
}

# Positional evaluation operands: params carries the RST tuple, mapping
# carries the policy, spec is fixed per Sweep/Engine instance.
_EXEMPT_PARAMS = frozenset({"p", "mapping", "spec", "trace"})

_TIMING_PUBLIC_KEYED = ("serial_latencies", "throughput",
                       "contended_throughput", "contended_throughput_mix")


def _rel(path: Path, root: Optional[Path]) -> str:
    if root is not None:
        try:
            return str(path.relative_to(root))
        except ValueError:
            pass
    return str(path)


def _class_store_findings(cls: ast.ClassDef, path: str,
                          point_class: str) -> List[Finding]:
    findings: List[Finding] = []
    for meth in cls.body:
        if not isinstance(meth, ast.FunctionDef):
            continue
        roots = [a.arg for a in meth.args.args if a.arg != "self"]
        roots += [a.arg for a in meth.args.kwonlyargs]
        if not roots:
            continue
        exclusive = DepTracer(roots, include_receivers=False)
        inclusive = DepTracer(roots, include_receivers=True)
        for stmt in statements_in_order(meth.body):
            store = _cache_store(stmt)
            if store is not None:
                attr, key_expr, value_expr = store
                tracer = inclusive if "flight" in attr else exclusive
                required = tracer.deps(value_expr)
                covered = tracer.deps(key_expr)
                missing = covers(required, covered)
                if missing:
                    fields = ", ".join(sorted(missing))
                    findings.append(Finding(
                        invariant="REPRO-C001",
                        path=path, line=stmt.lineno,
                        message=(f"{cls.name}.{meth.name} stores into "
                                 f"self.{attr} under a key that misses "
                                 f"{fields}"),
                        hint=(f"add {fields} to the key tuple for "
                              f"self.{attr} (or stop the value depending "
                              f"on it); see DESIGN.md §11.1")))
            exclusive.process(stmt)
            inclusive.process(stmt)
    return findings


def _cache_store(stmt: ast.stmt, extra_attrs: Sequence[str] = ()
                 ) -> Optional[Tuple[str, ast.expr, ast.expr]]:
    """(cache attr, key expr, value expr) if `stmt` assigns into a memo
    or flight map on self (or one of `extra_attrs` by exact name)."""
    if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
        return None
    target = stmt.targets[0]
    if not isinstance(target, ast.Subscript):
        return None
    container = target.value
    if not (isinstance(container, ast.Attribute)
            and isinstance(container.value, ast.Name)
            and container.value.id == "self"):
        return None
    attr = container.attr
    if "cache" not in attr and "flight" not in attr \
            and attr not in extra_attrs:
        return None
    return attr, target.slice, stmt.value


def _check_keyed_dataclass(tree: ast.Module, path: str,
                           name: str) -> List[Finding]:
    cls = find_class(tree, name)
    if cls is None:
        return [Finding(
            invariant="REPRO-C002", path=path, line=1,
            message=f"keyed dataclass {name} not found",
            hint=f"define {name} or update the analyzer configuration")]
    info = dataclass_info(cls)
    problems = []
    if not info["is_dataclass"]:
        problems.append("not a dataclass")
    if not info["frozen"]:
        problems.append("not frozen")
    if not info["eq"]:
        problems.append("eq=False")
    if problems:
        return [Finding(
            invariant="REPRO-C002", path=path, line=cls.lineno,
            message=(f"{name} participates in cache keys but is "
                     f"{' and '.join(problems)}"),
            hint=f"declare @dataclasses.dataclass(frozen=True) on {name}")]
    return []


def check_sweep_cache_keys(sweep_path: Path, *,
                           repo_root: Optional[Path] = None,
                           sweep_class: str = "Sweep",
                           point_class: str = "SweepPoint") -> List[Finding]:
    """C001/C002 over the sweep module's memo and flight stores."""
    path = _rel(sweep_path, repo_root)
    tree = parse_module(sweep_path)
    findings = _check_keyed_dataclass(tree, path, point_class)
    cls = find_class(tree, sweep_class)
    if cls is None:
        findings.append(Finding(
            invariant="REPRO-C001", path=path, line=1,
            message=f"sweep class {sweep_class} not found",
            hint="update the analyzer configuration"))
        return findings
    findings += _class_store_findings(cls, path, point_class)
    return findings


def check_timing_signature_coverage(
        timing_path: Path, sweep_path: Path, *,
        repo_root: Optional[Path] = None,
        point_class: str = "SweepPoint",
        functions: Sequence[str] = _TIMING_PUBLIC_KEYED) -> List[Finding]:
    """C003: every keyable timing-model parameter has a SweepPoint field.

    This is the other direction of completeness: C001 proves the key
    covers what flows in *today*; C003 proves a newly added model axis
    cannot exist without a sweep-layer field (and therefore, via C001, a
    key slot) to carry it.
    """
    timing_rel = _rel(timing_path, repo_root)
    timing_tree = parse_module(timing_path)
    sweep_tree = parse_module(sweep_path)
    point = find_class(sweep_tree, point_class)
    fields = set(dataclass_info(point)["fields"]) if point else set()

    findings: List[Finding] = []
    for fn in timing_tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name not in functions:
            continue
        keyed = [a.arg for a in fn.args.kwonlyargs]
        defaulted = fn.args.args[len(fn.args.args) - len(fn.args.defaults):]
        keyed += [a.arg for a in defaulted]
        for param in keyed:
            if param in _EXEMPT_PARAMS or param in fields:
                continue
            derived = DERIVED_PARAMS.get(param)
            if derived is not None and set(derived) <= fields:
                continue
            findings.append(Finding(
                invariant="REPRO-C003", path=timing_rel, line=fn.lineno,
                message=(f"{fn.name}() parameter {param!r} has no "
                         f"{point_class} field to carry it"),
                hint=(f"add a {point_class} field (and key slot) for "
                      f"{param!r}, or register it in "
                      f"analysis.cache_keys.DERIVED_PARAMS with the "
                      f"fields it derives from")))
    return findings


def check_request_dedup(campaign_path: Path, *,
                        repo_root: Optional[Path] = None,
                        request_class: str = "ExperimentRequest",
                        service_class: str = "CampaignService",
                        response_map: str = "_responses") -> List[Finding]:
    """C002/C004 over the campaign service's request-is-the-key dedup."""
    path = _rel(campaign_path, repo_root)
    tree = parse_module(campaign_path)
    findings = _check_keyed_dataclass(tree, path, request_class)

    req_cls = find_class(tree, request_class)
    no_compare = set(dataclass_info(req_cls)["no_compare"]) if req_cls \
        else set()

    svc = find_class(tree, service_class)
    if svc is None:
        findings.append(Finding(
            invariant="REPRO-C004", path=path, line=1,
            message=f"service class {service_class} not found",
            hint="update the analyzer configuration"))
        return findings

    # The dedup key must be the whole request object, not a projection.
    store_found = False
    for meth in svc.body:
        if not isinstance(meth, ast.FunctionDef):
            continue
        params = {a.arg for a in meth.args.args if a.arg != "self"}
        for stmt in statements_in_order(meth.body):
            store = _cache_store(stmt, extra_attrs=(response_map,))
            if store is None or store[0] != response_map:
                continue
            store_found = True
            key_expr = store[1]
            if not (isinstance(key_expr, ast.Name)
                    and key_expr.id in params):
                findings.append(Finding(
                    invariant="REPRO-C004", path=path, line=stmt.lineno,
                    message=(f"{service_class}.{meth.name} keys "
                             f"self.{response_map} by a projection of the "
                             f"request instead of the request itself"),
                    hint=("key the response cache by the full "
                          f"{request_class} (it is frozen and hashable "
                          "by construction)")))
        # Fields excluded from comparison must not influence execution.
        if no_compare:
            for node in ast.walk(meth):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id in params \
                        and node.attr in no_compare:
                    findings.append(Finding(
                        invariant="REPRO-C004", path=path,
                        line=node.lineno,
                        message=(f"{request_class}.{node.attr} is "
                                 f"compare=False but "
                                 f"{service_class}.{meth.name} reads it — "
                                 f"two requests differing only in "
                                 f"{node.attr} would dedup to one "
                                 f"response"),
                        hint=(f"make {node.attr} participate in equality "
                              f"or stop the execution path depending on "
                              f"it")))
    if not store_found:
        findings.append(Finding(
            invariant="REPRO-C004", path=path, line=svc.lineno,
            message=(f"{service_class} never stores into "
                     f"self.{response_map}; the dedup path the analyzer "
                     f"guards has moved"),
            hint="update analysis.cache_keys.check_request_dedup"))

    # The oracle memo inside the service is a plain keyed cache too.
    findings += _class_store_findings(svc, path, request_class)
    return findings


def check_engine_mix_keyed(engine_mix_path: Path, *,
                           repo_root: Optional[Path] = None,
                           mix_class: str = "EngineMix") -> List[Finding]:
    """C002 over the heterogeneous-mix value type (DESIGN.md §13).

    ``EngineMix`` rides inside every contention memo/flight key (the
    ``pt.mix`` slot C001 traces through the Sweep stores), so it must be
    a frozen ``eq`` dataclass like ``SweepPoint`` itself — a mutable or
    identity-compared mix would fork cache entries between the two
    spellings of one request.
    """
    path = _rel(engine_mix_path, repo_root)
    tree = parse_module(engine_mix_path)
    return _check_keyed_dataclass(tree, path, mix_class)


def check_cache_keys(sweep_path: Path, campaign_path: Path,
                     timing_path: Path,
                     engine_mix_path: Optional[Path] = None, *,
                     repo_root: Optional[Path] = None) -> List[Finding]:
    """The whole REPRO-C family over the real tree's modules."""
    findings = check_sweep_cache_keys(sweep_path, repo_root=repo_root)
    findings += check_timing_signature_coverage(timing_path, sweep_path,
                                                repo_root=repo_root)
    findings += check_request_dedup(campaign_path, repo_root=repo_root)
    if engine_mix_path is not None:
        findings += check_engine_mix_keyed(engine_mix_path,
                                           repo_root=repo_root)
    return findings
