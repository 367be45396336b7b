"""repro-lint CLI for the port: run every invariant family against the
port's tree.

Usage::

    python -m repro_torch.analysis.lint --baseline analysis_baseline_torch.json

Exit status is non-zero on any finding not in the baseline (*new*
violations) **and** on any baseline entry no longer reproduced (*stale*
— the baseline must shrink with the fix, keeping the pass ratchet-only).
``--write-baseline`` regenerates the file; ``--json`` dumps findings for
tooling (``python -m repro_torch.bench --lint-report`` times the families
through :data:`FAMILIES`).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, List, Sequence, Tuple

from repro_torch.analysis import cache_keys, capabilities, kernel_shapes
from repro_torch.analysis import oracle_parity
from repro_torch.analysis.findings import (Finding, diff_baseline,
                                           load_baseline, sort_findings,
                                           to_json, write_baseline)

PKG = "src/repro_torch"
BASELINE = "analysis_baseline_torch.json"


def default_root() -> Path:
    """Repo root, assuming the canonical src/repro_torch/analysis layout."""
    return Path(__file__).resolve().parents[3]


def _run_cache_keys(root: Path) -> List[Finding]:
    findings = cache_keys.check_cache_keys(
        root / PKG / "core/sweep.py",
        root / PKG / "service/campaign.py",
        root / PKG / "core/timing_model.py",
        root / PKG / "core/engine_mix.py",
        repo_root=root)
    # The layout tuner keeps its own probe-score cache; its keys must
    # cover the same contention fields as the Sweep memo.
    findings.extend(cache_keys.check_sweep_cache_keys(
        root / PKG / "core/autotune.py", repo_root=root,
        sweep_class="LayoutTuner", point_class="LayoutConfig"))
    return findings


def _run_oracle_parity(root: Path) -> List[Finding]:
    findings = oracle_parity.check_oracle_parity(
        root / PKG / "core/timing_model.py",
        root / PKG / "core/_timing_reference.py",
        root / "tests/test_torch_timing_reference.py",
        repo_root=root)
    findings.extend(oracle_parity.check_torch_parity(
        root / PKG / "core/timing_torch.py",
        root / PKG / "core/timing_model.py",
        root / "tests/test_torch_grid.py",
        repo_root=root))
    findings.extend(oracle_parity.check_envelope_coverage(
        root / PKG / "core/roofline_empirical.py",
        root / "tests/test_torch_roofline.py",
        repo_root=root))
    return findings


def _run_capabilities(root: Path) -> List[Finding]:
    return capabilities.check_capability_contracts(
        sorted((root / PKG).rglob("*.py")), repo_root=root)


def _run_kernel_shapes(root: Path) -> List[Finding]:
    return kernel_shapes.check_kernel_safety(root / PKG / "kernels",
                                             repo_root=root)


FAMILIES: Tuple[Tuple[str, Callable[[Path], List[Finding]]], ...] = (
    ("cache_keys", _run_cache_keys),
    ("oracle_parity", _run_oracle_parity),
    ("capabilities", _run_capabilities),
    ("kernel_shapes", _run_kernel_shapes),
)

# Every file a family reads by name; run_analysis refuses to run without
# one, so a moved file cannot pass as a clean one.
REQUIRED = tuple(f"{PKG}/{rel}" for rel in (
    "core/sweep.py",
    "core/engine_mix.py",
    "core/timing_model.py",
    "core/timing_torch.py",
    "core/_timing_reference.py",
    "core/autotune.py",
    "core/roofline_empirical.py",
    "core/engine.py",
    "service/campaign.py",
    "service/faults.py",
    "kernels/ops.py",
    "kernels/_build.py",
    "kernels/rst_read.py",
    "kernels/rst_write.py",
    "kernels/rst_contend.py",
    "kernels/csrc/rst.cu",
    "kernels/csrc/rst_contend.cu",
    "kernels/csrc/rst_common.cuh",
)) + (
    "tests/test_torch_timing_reference.py",
    "tests/test_torch_grid.py",
    "tests/test_torch_roofline.py",
)


def run_analysis(root: Path) -> List[Finding]:
    """Every family over the port's tree; fails loudly if the tree moved
    out from under the analyzer's configured paths."""
    missing = [rel for rel in REQUIRED if not (root / rel).exists()]
    if missing:
        raise FileNotFoundError(
            f"repro-lint: analyzed files missing under {root}: {missing} "
            f"(moved files must be re-pointed in repro_torch.analysis.lint)")
    findings: List[Finding] = []
    for _, runner in FAMILIES:
        findings.extend(runner(root))
    return sort_findings(findings)


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="AST-driven invariant analysis of the PyTorch/CUDA port")
    parser.add_argument("--root", type=Path, default=None,
                        help="repo root (default: inferred from layout)")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="ratchet baseline JSON to compare against")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline from current findings")
    parser.add_argument("--json", type=Path, default=None,
                        help="dump full findings JSON to this path")
    args = parser.parse_args(argv)

    root = (args.root or default_root()).resolve()
    findings = run_analysis(root)

    if args.json is not None:
        args.json.write_text(json.dumps(to_json(findings), indent=2,
                                        sort_keys=True) + "\n")

    if args.write_baseline:
        if args.baseline is None:
            parser.error("--write-baseline requires --baseline")
        write_baseline(args.baseline, findings)
        print(f"repro-lint: wrote {len(findings)} finding(s) to "
              f"{args.baseline}")
        return 0

    if args.baseline is not None:
        diff = diff_baseline(findings, load_baseline(args.baseline))
        for f in diff.new:
            print(f.render())
        for key in diff.stale:
            print(f"{key[1]}: stale baseline entry {key[0]} "
                  f"({key[2]!r}) — the violation is fixed; remove it "
                  f"from {args.baseline}")
        status = "clean" if diff.clean else (
            f"{len(diff.new)} new, {len(diff.stale)} stale")
        print(f"repro-lint: {len(findings)} finding(s), baseline "
              f"{args.baseline}: {status}")
        return 0 if diff.clean else 1

    for f in findings:
        print(f.render())
    print(f"repro-lint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
