"""REPRO-O*: loop-oracle and parity-test coverage of the timing model.

The reference's contract, kept by the port: the vectorized model in
``core/timing_model.py`` is only trusted because
``core/_timing_reference.py`` keeps the original per-transaction loop
implementation and a parity test pins them together (bit-exact for serial
latencies, 1e-9 for throughput).  A public model
function without an oracle — or an oracle nobody tests against — is
exactly how vectorization drift ships silently.

Invariants:

* **REPRO-O001** — a public ``timing_model`` function has no loop oracle
  in ``_timing_reference.py`` (per the ORACLE_EQUIVALENTS map below).
* **REPRO-O002** — an (function, oracle) pair has no parity test that
  references both the vectorized and the reference implementation.

``serial_latencies`` is one vectorized entry point with three oracles
(read, write, contended — the reference keeps per-direction loops), so
deleting *any one* reference oracle fails the pass.

The port's test modules import both packages, the port's and the JAX
reference's, so a module alias is bound only to an import from
``repro_torch.``: a test that imports the reference's ``timing_model``
first must not make the port's coverage look complete.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import (find_class, parse_module,
                                          public_functions)
from repro_torch.analysis.findings import Finding

# vectorized public function -> reference oracles that must ALL exist.
ORACLE_EQUIVALENTS: Dict[str, Tuple[str, ...]] = {
    "throughput": ("throughput",),
    "contended_throughput": ("contended_throughput",),
    "contended_throughput_mix": ("contended_throughput_mix",),
    "serial_latencies": ("serial_read_latencies", "serial_write_latencies",
                         "serial_contended_latencies"),
    "serial_read_latencies": ("serial_read_latencies",),
}

# vectorized names a parity test may call to exercise a public function
# (serial_latencies is usually reached through its read wrapper).
VEC_ALIASES: Dict[str, Tuple[str, ...]] = {
    "serial_latencies": ("serial_latencies", "serial_read_latencies"),
}

# Public model functions that legitimately have no loop oracle, with the
# reason (surfaced in the finding if the exemption goes stale).
EXEMPT_PUBLIC: Dict[str, str] = {
    "refresh_interval_estimate":
        "post-processing estimator over an existing LatencyTrace; it has "
        "no vectorized/loop split (direct unit tests cover it)",
}


PACKAGE = "repro_torch"


def _in_package(module: str) -> bool:
    return module == PACKAGE or module.startswith(PACKAGE + ".")


def _module_alias(tree: ast.Module, module_suffix: str) -> Optional[str]:
    """The local name a test binds `repro_torch.core.<module_suffix>` to;
    imports from any other package (the reference's ``repro.``) are
    ignored."""
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            if node.level or not _in_package(node.module or ""):
                continue
            for alias in node.names:
                if alias.name == module_suffix \
                        or alias.name.endswith("." + module_suffix):
                    return alias.asname or alias.name
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if _in_package(alias.name) \
                        and alias.name.endswith("." + module_suffix):
                    return alias.asname or alias.name.split(".")[0]
    return None


def _attr_uses(fn: ast.FunctionDef, owner: str) -> Set[str]:
    return {node.attr for node in ast.walk(fn)
            if isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == owner}


def check_oracle_parity(timing_path: Path, reference_path: Path,
                        parity_test_path: Path, *,
                        repo_root: Optional[Path] = None) -> List[Finding]:
    def rel(p: Path) -> str:
        if repo_root is not None:
            try:
                return str(p.relative_to(repo_root))
            except ValueError:
                pass
        return str(p)

    timing_tree = parse_module(timing_path)
    reference_tree = parse_module(reference_path)
    test_tree = parse_module(parity_test_path)

    oracles = {fn.name: fn for fn in reference_tree.body
               if isinstance(fn, ast.FunctionDef)}
    findings: List[Finding] = []

    vec_alias = _module_alias(test_tree, "timing_model")
    ref_alias = _module_alias(test_tree, "_timing_reference")
    if vec_alias is None or ref_alias is None:
        findings.append(Finding(
            invariant="REPRO-O002", path=rel(parity_test_path), line=1,
            message=("parity test module does not import both "
                     "timing_model and _timing_reference"),
            hint="import both modules so parity tests can pin them"))
        return findings

    # (vec attr set, ref attr set) per test function.
    test_uses = [( _attr_uses(fn, vec_alias), _attr_uses(fn, ref_alias))
                 for fn in ast.walk(test_tree)
                 if isinstance(fn, ast.FunctionDef)
                 and fn.name.startswith("test_")]

    for fn in public_functions(timing_tree):
        name = fn.name
        if name in EXEMPT_PUBLIC:
            continue
        required = ORACLE_EQUIVALENTS.get(name)
        if required is None:
            findings.append(Finding(
                invariant="REPRO-O001", path=rel(timing_path),
                line=fn.lineno,
                message=(f"public timing-model function {name}() has no "
                         f"registered loop oracle"),
                hint=("add the loop implementation to "
                      "_timing_reference.py and map it in "
                      "analysis.oracle_parity.ORACLE_EQUIVALENTS (or "
                      "record an exemption with its reason)")))
            continue
        vec_names = set(VEC_ALIASES.get(name, (name,)))
        for oracle in required:
            oracle_fn = oracles.get(oracle)
            if oracle_fn is None:
                findings.append(Finding(
                    invariant="REPRO-O001", path=rel(reference_path),
                    line=1,
                    message=(f"loop oracle {oracle}() for "
                             f"timing_model.{name}() is missing from the "
                             f"reference module"),
                    hint=(f"restore {oracle}() in _timing_reference.py — "
                          f"the vectorized path is untrusted without "
                          f"it")))
                continue
            hit = any(vec_names & vec and oracle in ref
                      for vec, ref in test_uses)
            if not hit:
                findings.append(Finding(
                    invariant="REPRO-O002", path=rel(parity_test_path),
                    line=1,
                    message=(f"no parity test references both "
                             f"timing_model.{name}() and reference "
                             f"{oracle}()"),
                    hint=(f"add a test calling {vec_alias}."
                          f"{sorted(vec_names)[0]} and {ref_alias}."
                          f"{oracle} on the same inputs")))

    # Exemptions must stay real: an exempt name that disappears from the
    # module means the exemption table is stale.
    timing_names = {fn.name for fn in public_functions(timing_tree)}
    for name, reason in EXEMPT_PUBLIC.items():
        if name not in timing_names:
            findings.append(Finding(
                invariant="REPRO-O001", path=rel(timing_path), line=1,
                message=(f"oracle exemption for {name}() is stale — the "
                         f"function no longer exists (exempt because: "
                         f"{reason})"),
                hint="drop the entry from EXEMPT_PUBLIC"))
    return findings


# ---------------------------------------------------------------------------
# REPRO-O003/O004 — the torch tier of the three-implementation tower.
#
# The grid tier in ``core/timing_torch.py`` is only trusted because every
# public function names its NumPy mid-level oracle (the timing_model
# function the differential tests pin it against within
# ``timing_torch.REL_TOLERANCE``), and because that pair actually appears
# in ``tests/test_torch_grid.py``.  The grid entry points
# (`evaluate_points`, `evaluate_grid`) answer to ``contended_throughput``:
# a grid lane IS one contended-throughput evaluation, recombined over
# placements.
# ---------------------------------------------------------------------------

# public timing_torch function -> the timing_model counterpart it must be
# differentially tested against.
TORCH_EQUIVALENTS: Dict[str, str] = {
    "throughput": "throughput",
    "contended_throughput": "contended_throughput",
    "contended_throughput_mix": "contended_throughput_mix",
    "evaluate_points": "contended_throughput",
    "evaluate_grid": "contended_throughput",
}

# Public timing_torch names that legitimately need no NumPy counterpart,
# with the reason (surfaced if the exemption goes stale).
TORCH_EXEMPT: Dict[str, str] = {}


def _function_attr_uses(tree: ast.Module, owner: str) -> Dict[str, Set[str]]:
    """attr uses of `owner` per module-level function, with one level of
    local helper calls folded in (differential tests route shared
    assertions through module helpers)."""
    fns = {fn.name: fn for fn in tree.body
           if isinstance(fn, ast.FunctionDef)}
    direct = {name: _attr_uses(fn, owner) for name, fn in fns.items()}
    calls = {name: {node.func.id for node in ast.walk(fn)
                    if isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)}
             for name, fn in fns.items()}
    # Two folding rounds cover helper-calls-helper chains.
    for _ in range(2):
        for name in fns:
            for callee in calls[name]:
                if callee in direct:
                    direct[name] = direct[name] | direct[callee]
    return direct


def check_torch_parity(torch_path: Path, timing_path: Path,
                       differential_test_path: Path, *,
                       repo_root: Optional[Path] = None) -> List[Finding]:
    def rel(p: Path) -> str:
        if repo_root is not None:
            try:
                return str(p.relative_to(repo_root))
            except ValueError:
                pass
        return str(p)

    torch_tree = parse_module(torch_path)
    timing_tree = parse_module(timing_path)
    test_tree = parse_module(differential_test_path)

    timing_names = {fn.name for fn in public_functions(timing_tree)}
    findings: List[Finding] = []

    torch_alias = _module_alias(test_tree, "timing_torch")
    vec_alias = _module_alias(test_tree, "timing_model")
    if torch_alias is None or vec_alias is None:
        findings.append(Finding(
            invariant="REPRO-O004", path=rel(differential_test_path),
            line=1,
            message=("differential test module does not import both "
                     "timing_torch and timing_model"),
            hint="import both modules so differential tests can pin them"))
        return findings

    torch_uses = _function_attr_uses(test_tree, torch_alias)
    vec_uses = _function_attr_uses(test_tree, vec_alias)
    test_pairs = [(torch_uses[name], vec_uses[name])
                  for name in torch_uses if name.startswith("test_")]

    for fn in public_functions(torch_tree):
        name = fn.name
        if name in TORCH_EXEMPT:
            continue
        counterpart = TORCH_EQUIVALENTS.get(name)
        if counterpart is None:
            findings.append(Finding(
                invariant="REPRO-O003", path=rel(torch_path),
                line=fn.lineno,
                message=(f"public timing_torch function {name}() names no "
                         f"NumPy counterpart"),
                hint=("map it to its timing_model oracle in "
                      "analysis.oracle_parity.TORCH_EQUIVALENTS (or "
                      "record an exemption with its reason)")))
            continue
        if counterpart not in timing_names:
            findings.append(Finding(
                invariant="REPRO-O003", path=rel(timing_path), line=1,
                message=(f"NumPy counterpart {counterpart}() for "
                         f"timing_torch.{name}() is not a public "
                         f"timing_model function"),
                hint="fix the TORCH_EQUIVALENTS mapping"))
            continue
        hit = any(name in tier and counterpart in vec
                  for tier, vec in test_pairs)
        if not hit:
            findings.append(Finding(
                invariant="REPRO-O004", path=rel(differential_test_path),
                line=1,
                message=(f"no differential test references both "
                         f"timing_torch.{name}() and "
                         f"timing_model.{counterpart}()"),
                hint=(f"add a test calling {torch_alias}.{name} and "
                      f"{vec_alias}.{counterpart} on the same inputs")))

    torch_names = {fn.name for fn in public_functions(torch_tree)}
    for name, reason in TORCH_EXEMPT.items():
        if name not in torch_names:
            findings.append(Finding(
                invariant="REPRO-O003", path=rel(torch_path), line=1,
                message=(f"torch parity exemption for {name}() is stale — "
                         f"the function no longer exists (exempt because: "
                         f"{reason})"),
                hint="drop the entry from TORCH_EXEMPT"))
    return findings


# ---------------------------------------------------------------------------
# REPRO-O005 — envelope-math coverage of the measured roofline.
#
# ``core/roofline_empirical.py`` is pure reduction math (no loop-oracle
# split to pin), so its trust story is a designated coverage tier
# instead: every public module-level function, and every public method
# of ``RooflineEnvelope``, must be exercised by some test function of
# the envelope test module.  Untested closed-form roofline math is how
# a wrong knee ships in a report nobody can falsify.
# ---------------------------------------------------------------------------

# Public envelope names that legitimately need no coverage in the
# designated test module, with the reason (surfaced if stale).
ENVELOPE_EXEMPT: Dict[str, str] = {}

ENVELOPE_CLASS = "RooflineEnvelope"


def check_envelope_coverage(envelope_path: Path, coverage_test_path: Path, *,
                            repo_root: Optional[Path] = None
                            ) -> List[Finding]:
    def rel(p: Path) -> str:
        if repo_root is not None:
            try:
                return str(p.relative_to(repo_root))
            except ValueError:
                pass
        return str(p)

    env_tree = parse_module(envelope_path)
    test_tree = parse_module(coverage_test_path)
    findings: List[Finding] = []

    required: Dict[str, int] = {
        fn.name: fn.lineno for fn in public_functions(env_tree)}
    env_cls = find_class(env_tree, ENVELOPE_CLASS)
    if env_cls is None:
        findings.append(Finding(
            invariant="REPRO-O005", path=rel(envelope_path), line=1,
            message=(f"envelope class {ENVELOPE_CLASS} not found in the "
                     f"roofline module"),
            hint="keep the public envelope dataclass where the analyzer "
                 "can see it"))
        return findings
    for node in env_cls.body:
        if isinstance(node, ast.FunctionDef) \
                and not node.name.startswith("_"):
            required[node.name] = node.lineno

    # Anything a test function touches counts: bare names (from-imports)
    # and attribute access through module aliases or envelope instances.
    used: Set[str] = set()
    for fn in ast.walk(test_tree):
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute):
                used.add(node.attr)
            elif isinstance(node, ast.Name):
                used.add(node.id)

    for name, lineno in sorted(required.items(), key=lambda t: t[1]):
        if name in ENVELOPE_EXEMPT or name in used:
            continue
        findings.append(Finding(
            invariant="REPRO-O005", path=rel(envelope_path), line=lineno,
            message=(f"public envelope function/method {name}() is not "
                     f"referenced by any test in "
                     f"{rel(coverage_test_path)}"),
            hint=(f"exercise {name}() in the envelope coverage module (or "
                  f"record an exemption with its reason in "
                  f"analysis.oracle_parity.ENVELOPE_EXEMPT)")))

    for name, reason in ENVELOPE_EXEMPT.items():
        if name not in required:
            findings.append(Finding(
                invariant="REPRO-O005", path=rel(envelope_path), line=1,
                message=(f"envelope coverage exemption for {name}() is "
                         f"stale — the name no longer exists (exempt "
                         f"because: {reason})"),
                hint="drop the entry from ENVELOPE_EXEMPT"))
    return findings
