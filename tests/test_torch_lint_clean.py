"""The port's lint as a user runs it, on the cases of
tests/analysis/test_lint_clean.py and test_style_gate.py: zero findings
on the shipped tree, the committed baseline empty and in sync, the CLI's
exit codes (a stale baseline entry fails, a violation put into a copied
tree fails, --write-baseline round-trips, --json dumps), the bench's
--lint-report rows, and a style gate over the analysis, core and
examples packages and the analytic roofline.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import bench
from repro_torch.analysis.findings import load_baseline
from repro_torch.analysis.lint import (BASELINE, REQUIRED, default_root,
                                       main, run_analysis)

REPO = Path(__file__).resolve().parents[1]
BASELINE_PATH = REPO / BASELINE
# Besides the required files: what the B family scans for backends and
# the K family follows to the RST base.
EXTRA = ("src/repro_torch/core/rst.py",)
# The reference's gate scope (tests/analysis/test_style_gate.py) in the
# port's tree, with its examples.
STYLE_SCOPE = ("src/repro_torch/analysis", "src/repro_torch/core",
               "src/repro_torch/examples",
               "src/repro_torch/launch/roofline.py")
LINE_LIMIT = 95  # keep in sync with [tool.ruff] line-length


def _copy_tree(tmp_path: Path) -> Path:
    root = tmp_path / "tree"
    for rel in REQUIRED + EXTRA:
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, dst)
    return root


def _clean_baseline(tmp_path: Path) -> Path:
    baseline = tmp_path / "baseline.json"
    baseline.write_text('{"version": 1, "findings": []}\n')
    return baseline


def test_default_root_is_the_repo():
    assert default_root() == REPO


def test_shipped_tree_has_no_findings():
    assert run_analysis(REPO) == []


def test_copied_tree_has_no_findings(tmp_path):
    assert run_analysis(_copy_tree(tmp_path)) == []


def test_committed_baseline_is_empty():
    assert BASELINE_PATH.exists(), f"commit {BASELINE} at the root"
    assert load_baseline(BASELINE_PATH) == []


def test_a_moved_file_fails_loudly(tmp_path):
    root = _copy_tree(tmp_path)
    (root / "src/repro_torch/kernels/_build.py").unlink()
    with pytest.raises(FileNotFoundError, match="kernels/_build.py"):
        run_analysis(root)


def test_cli_exits_zero_on_shipped_tree(capsys):
    status = main(["--root", str(REPO), "--baseline", str(BASELINE_PATH)])
    assert status == 0
    assert "clean" in capsys.readouterr().out


def test_cli_json_dump(tmp_path, capsys):
    out = tmp_path / "findings.json"
    status = main(["--root", str(REPO), "--baseline", str(BASELINE_PATH),
                   "--json", str(out)])
    assert status == 0
    capsys.readouterr()
    assert json.loads(out.read_text()) == {"version": 1, "findings": []}


def test_cli_json_dump_lists_findings(tmp_path, capsys):
    root = _copy_tree(tmp_path)
    read = root / "src/repro_torch/kernels/rst_read.py"
    read.write_text(read.read_text().replace("torch.int8: 2}",
                                             "torch.int8: 3}"))
    out = tmp_path / "findings.json"
    assert main(["--root", str(root), "--json", str(out)]) == 1
    capsys.readouterr()
    (entry,) = json.loads(out.read_text())["findings"]
    assert entry["invariant"] == "REPRO-K005"
    assert entry["path"] == "src/repro_torch/kernels/rst_read.py"
    assert entry["line"] > 1 and entry["hint"]


def test_stale_baseline_entry_fails_the_ratchet(tmp_path, capsys):
    stale = tmp_path / "baseline.json"
    stale.write_text(json.dumps({
        "version": 1,
        "findings": [{"invariant": "REPRO-K001",
                      "path": "src/repro_torch/kernels/_build.py",
                      "message": "a violation that no longer exists"}],
    }))
    status = main(["--root", str(REPO), "--baseline", str(stale)])
    assert status == 1
    assert "stale" in capsys.readouterr().out


def test_cli_fails_on_introduced_violation(tmp_path, capsys):
    root = _copy_tree(tmp_path)
    build = root / "src/repro_torch/kernels/_build.py"
    src = build.read_text()
    mutated = src.replace("_c_i64, _c_i64, _c_i64, _c_i64, _c_i64, _c_int,",
                          "_c_i64, _c_i64, _c_i64, _c_i64, _c_int, _c_int,")
    assert mutated != src, "contend signature moved; update the probe"
    build.write_text(mutated)
    status = main(["--root", str(root), "--baseline",
                   str(_clean_baseline(tmp_path))])
    out = capsys.readouterr().out
    assert status == 1
    assert "REPRO-K001" in out and "rst_contend_read_launch()" in out


def test_write_baseline_round_trips(tmp_path, capsys):
    root = _copy_tree(tmp_path)
    engine = root / "src/repro_torch/core/engine.py"
    src = engine.read_text()
    mutated = src.replace(
        "    supports_latency = False\n    supports_contention = True\n"
        "    supports_grid = True",
        "    supports_latency = False\n    supports_contention = False\n"
        "    supports_grid = True")
    assert mutated != src
    engine.write_text(mutated)
    baseline = tmp_path / "baseline.json"
    assert main(["--root", str(root), "--baseline", str(baseline),
                 "--write-baseline"]) == 0
    (entry,) = json.loads(baseline.read_text())["findings"]
    assert entry["invariant"] == "REPRO-B001"
    assert set(entry) == {"invariant", "path", "message"}
    assert main(["--root", str(root), "--baseline", str(baseline)]) == 0
    engine.write_text(src)
    assert main(["--root", str(root), "--baseline", str(baseline)]) == 1
    capsys.readouterr()


def test_module_entry_point_runs_in_a_subprocess(tmp_path):
    out = tmp_path / "findings.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--baseline",
         BASELINE, "--json", str(out)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(out.read_text())["findings"] == []


def test_bench_lint_report_rows():
    rows = bench.bench_lint_report()
    names = [name for name, _, _ in rows]
    assert names == ["lint_cache_keys", "lint_oracle_parity",
                     "lint_capabilities", "lint_kernel_shapes", "lint_total"]
    assert all(us > 0 for _, us, _ in rows)
    assert rows[-1][2] == ("findings=0;baseline=0;new=0;stale=0;"
                           "clean=True")


def test_bench_lint_report_json_and_exclusive_modes(tmp_path, capsys):
    out = tmp_path / "lint.json"
    bench.main(["--lint-report", "--json", str(out)])
    payload = json.loads(out.read_text())
    assert payload["benchmark"] == "shuhai-lint-torch"
    assert payload["failures"] == 0
    assert payload["rows"][-1]["name"] == "lint_total"
    assert "lint_total" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        bench.main(["--lint-report", "--grid"])
    capsys.readouterr()


# ------------------------------------------------------------ style gate
def _scope_files():
    for rel in STYLE_SCOPE:
        path = REPO / rel
        if path.is_file():
            yield path
        else:
            yield from sorted(path.glob("*.py"))


def test_ruff_clean_if_available():
    if shutil.which("ruff") is None:
        pytest.skip("ruff not installed")
    proc = subprocess.run(["ruff", "check", *STYLE_SCOPE], cwd=REPO,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_mypy_clean_if_available():
    if shutil.which("mypy") is None:
        pytest.skip("mypy not installed")
    proc = subprocess.run(
        [sys.executable, "-m", "mypy", "--ignore-missing-imports",
         *STYLE_SCOPE], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, MYPYPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_unused_imports_in_gate_scope():
    # AST approximation of ruff F401; __init__.py facades are exempt and
    # `from __future__` is always used.
    problems = []
    for path in _scope_files():
        if path.name == "__init__.py":
            continue
        tree = ast.parse(path.read_text())
        imported = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = (alias.asname or alias.name).split(".")[0]
                    imported[name] = node.lineno
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for alias in node.names:
                    if alias.name != "*":
                        imported[alias.asname or alias.name] = node.lineno
        used = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                base = node
                while isinstance(base, ast.Attribute):
                    base = base.value
                if isinstance(base, ast.Name):
                    used.add(base.id)
        text = path.read_text()
        for name, line in imported.items():
            if name not in used and f'"{name}"' not in text \
                    and f"'{name}'" not in text:
                problems.append(f"{path}:{line}: unused import {name}")
    assert not problems, "\n".join(problems)


def test_line_length_in_gate_scope():
    problems = []
    for path in _scope_files():
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            if len(line) > LINE_LIMIT:
                problems.append(
                    f"{path}:{lineno}: {len(line)} > {LINE_LIMIT} chars")
    assert not problems, "\n".join(problems)
