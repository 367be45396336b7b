"""The port's copied repro-lint families against the reference's analyzers
on the same inputs.

`repro_torch.analysis` keeps its own copies of `findings`, `astutil` and
the C, O and B families of `repro.analysis`.  Here both packages run on
the reference's fixtures (tests/analysis/fixtures/), on the port's own
tree and on mutated copies of it, and every list of (invariant, path,
line, message, hint) must be equal.  Two differences are by design:

* the O003/O004 tier is `timing_torch` where the reference's is
  `timing_jax`, so its messages and hints are compared after that rename;
* the port binds a test module's aliases only to imports from
  `repro_torch.`, the reference to the first import with the module's
  name, so the copies the reference reads have the reference-package
  imports blanked out (lines kept), and fixtures importing `repro.core`
  are read with `repro_torch.core` by both.
"""
import ast
import shutil
from pathlib import Path

import pytest

from repro.analysis import astutil as ref_astutil
from repro.analysis import cache_keys as ref_cache_keys
from repro.analysis import capabilities as ref_capabilities
from repro.analysis import findings as ref_findings
from repro.analysis import oracle_parity as ref_oracle_parity
from repro_torch.analysis import astutil, cache_keys, capabilities, findings
from repro_torch.analysis import oracle_parity

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests/analysis/fixtures"
PORT_CORE = "src/repro_torch/core"
TIER_RENAMES = (("timing_jax", "timing_torch"),
                ("JAX_EQUIVALENTS", "TORCH_EQUIVALENTS"),
                ("JAX_EXEMPT", "TORCH_EXEMPT"),
                ("JAX parity", "torch parity"))


def rows(found, *, tier_rename=False):
    out = []
    for f in found:
        message, hint = f.message, f.hint
        if tier_rename:
            for old, new in TIER_RENAMES:
                message, hint = message.replace(old, new), hint.replace(old, new)
        out.append((f.invariant, f.path, f.line, message, hint))
    return sorted(out)


def without_reference_imports(text: str) -> str:
    """`text` with its module-level imports of the reference package
    blanked, line numbers kept."""
    lines = text.splitlines(keepends=True)
    for node in ast.parse(text).body:
        if isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        else:
            continue
        if any(n == "repro" or n.startswith("repro.") for n in names):
            for i in range(node.lineno - 1, node.end_lineno):
                lines[i] = "\n"
    return "".join(lines)


def copy_tree(root: Path, rels, edit=None) -> Path:
    """The repo files `rels` under `root` at the same relative paths,
    each passed through `edit(rel, text)` when given."""
    for rel in rels:
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        text = (REPO / rel).read_text()
        dst.write_text(edit(rel, text) if edit else text)
    return root


def mutate(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert old in text, f"{path.name} moved; update the probe"
    path.write_text(text.replace(old, new))


def port_and_reference_roots(tmp_path, rels, mutation=None,
                             reference_edit=None):
    """Two copies of `rels` (the port's, the reference's), with the
    mutation (rel, old, new) applied to both."""
    port = copy_tree(tmp_path / "port", rels)
    ref = copy_tree(tmp_path / "ref", rels, reference_edit)
    if mutation is not None:
        rel, old, new = mutation
        mutate(port / rel, old, new)
        mutate(ref / rel, old, new)
    return port, ref


# ------------------------------------------------------------- C family
@pytest.mark.parametrize("check", ["sweep_keys", "signature_coverage",
                                   "request_dedup"])
def test_c_family_matches_the_reference_on_its_fixtures(check):
    def run(mod):
        if check == "sweep_keys":
            return mod.check_sweep_cache_keys(FIXTURES / "bad_sweep.py",
                                              repo_root=REPO)
        if check == "signature_coverage":
            return mod.check_timing_signature_coverage(
                FIXTURES / "bad_timing.py", FIXTURES / "bad_sweep.py",
                repo_root=REPO, functions=("throughput", "frobnicate"))
        return mod.check_request_dedup(FIXTURES / "bad_campaign.py",
                                       repo_root=REPO)

    port = rows(run(cache_keys))
    assert port
    assert port == rows(run(ref_cache_keys))


C_FILES = [f"{PORT_CORE}/sweep.py", "src/repro_torch/service/campaign.py",
           f"{PORT_CORE}/timing_model.py", f"{PORT_CORE}/engine_mix.py",
           f"{PORT_CORE}/autotune.py"]
_MIX_KEY = ("        key = (pt.params, pt.policy, pt.op, pt.num_engines,\n"
            "               pt.arbitration, pt.burst_beats, pt.placement, "
            "pt.mix)")
_NO_MIX_KEY = ("        key = (pt.params, pt.policy, pt.op, pt.num_engines,\n"
               "               pt.arbitration, pt.burst_beats, pt.placement)")


@pytest.mark.parametrize("mutation", [
    None,
    (f"{PORT_CORE}/sweep.py", _MIX_KEY, _NO_MIX_KEY),
    (f"{PORT_CORE}/sweep.py",
     "                   pt.arbitration, pt.burst_beats, pt.placement, "
     "pt.mix,\n",
     "                   pt.arbitration, pt.burst_beats, pt.placement,\n"),
    (f"{PORT_CORE}/autotune.py", _MIX_KEY, _NO_MIX_KEY),
    (f"{PORT_CORE}/engine_mix.py",
     "@dataclasses.dataclass(frozen=True)\nclass EngineMix:",
     "@dataclasses.dataclass\nclass EngineMix:"),
], ids=["clean", "sweep_memo", "sweep_flight", "tuner_probe",
        "engine_mix_unfrozen"])
def test_c_family_matches_the_reference_on_the_port_tree(tmp_path,
                                                         mutation):
    def run(mod, root):
        found = mod.check_cache_keys(*(root / rel for rel in C_FILES[:4]),
                                     repo_root=root)
        return found + mod.check_sweep_cache_keys(
            root / C_FILES[4], repo_root=root, sweep_class="LayoutTuner",
            point_class="LayoutConfig")

    port, ref = port_and_reference_roots(tmp_path, C_FILES, mutation)
    found = rows(run(cache_keys, port))
    assert bool(found) == (mutation is not None)
    assert found == rows(run(ref_cache_keys, ref))


# ------------------------------------------------------------- B family
def test_b_family_matches_the_reference_on_its_fixture():
    paths = [FIXTURES / "bad_backend.py"]
    port = rows(capabilities.check_capability_contracts(paths,
                                                        repo_root=REPO))
    assert {r[0] for r in port} == {"REPRO-B001", "REPRO-B002", "REPRO-B003"}
    assert port == rows(ref_capabilities.check_capability_contracts(
        paths, repo_root=REPO))


@pytest.mark.parametrize("mutation", [
    None,
    (f"{PORT_CORE}/engine.py",
     "    supports_latency = False\n    supports_contention = True\n\n"
     "    def __init__(self, device: \"torch.device | str | None\" = None):",
     "    supports_latency = True\n    supports_contention = True\n\n"
     "    def __init__(self, device: \"torch.device | str | None\" = None):"),
    (f"{PORT_CORE}/engine.py",
     "    supports_contention = True\n    supports_grid = True",
     "    supports_contention = False\n    supports_grid = True"),
    ("src/repro_torch/service/faults.py",
     "        self.supports_latency = self.inner.supports_latency",
     "        self.supports_latency = bool(script)"),
], ids=["clean", "cuda_latency", "torchgrid_contention", "opaque_fault"])
def test_b_family_matches_the_reference_on_the_port_tree(tmp_path,
                                                         mutation):
    rels = sorted(str(p.relative_to(REPO))
                  for p in (REPO / "src/repro_torch").rglob("*.py"))
    port, ref = port_and_reference_roots(tmp_path, rels, mutation)

    def run(mod, root):
        return mod.check_capability_contracts(
            sorted((root / "src/repro_torch").rglob("*.py")), repo_root=root)

    found = rows(run(capabilities, port))
    assert bool(found) == (mutation is not None)
    assert found == rows(run(ref_capabilities, ref))


# ------------------------------------------------------------- O family
def _as_port_imports(text: str) -> str:
    return text.replace("from repro.core import", "from repro_torch.core import")


@pytest.mark.parametrize("parity_test,expect", [("fixture", "REPRO-O001"),
                                                ("emptied", "REPRO-O002")])
def test_o001_o002_match_the_reference_on_its_fixtures(tmp_path,
                                                       parity_test, expect):
    test = tmp_path / "bad_parity_test.py"
    text = _as_port_imports((FIXTURES / "bad_parity_test.py").read_text())
    if parity_test == "emptied":
        text = text[:text.index("\n\ndef test_")] + "\n"
    test.write_text(text)

    def run(mod):
        return mod.check_oracle_parity(FIXTURES / "bad_timing.py",
                                       FIXTURES / "bad_reference.py", test,
                                       repo_root=REPO)

    port = rows(run(oracle_parity))
    assert expect in {r[0] for r in port}
    assert port == rows(run(ref_oracle_parity))


O12_FILES = [f"{PORT_CORE}/timing_model.py",
             f"{PORT_CORE}/_timing_reference.py",
             "tests/test_torch_timing_reference.py"]


def _blank_reference_imports(rel: str, text: str) -> str:
    return without_reference_imports(text) if rel.startswith("tests/") \
        else text


@pytest.mark.parametrize("mutation", [
    None,
    (f"{PORT_CORE}/_timing_reference.py", "def serial_write_latencies(",
     "def _serial_write_latencies_gone("),
    ("tests/test_torch_timing_reference.py",
     "def test_serial_read_latencies_parity(",
     "def untested_serial_read_latencies_parity("),
    ("tests/test_torch_timing_reference.py",
     "def test_contended_mix_loop_matches_reference(",
     "def untested_contended_mix_loop_matches_reference("),
    ("tests/test_torch_timing_reference.py",
     "def test_throughput_loop_matches_reference(",
     "def untested_throughput_loop_matches_reference("),
], ids=["clean", "oracle_gone", "serial_read", "contended_mix", "throughput"])
def test_o001_o002_match_the_reference_on_the_port_tree(tmp_path, mutation):
    port, ref = port_and_reference_roots(tmp_path, O12_FILES, mutation,
                                         _blank_reference_imports)

    def run(mod, root):
        return mod.check_oracle_parity(*(root / rel for rel in O12_FILES),
                                       repo_root=root)

    found = rows(run(oracle_parity, port))
    assert bool(found) == (mutation is not None)
    assert found == rows(run(ref_oracle_parity, ref))


def _tier_for_the_reference(rel: str, text: str) -> str:
    """The differential test module as the reference's O003/O004 reads
    it: its tier imported under the reference tier's name."""
    if not rel.startswith("tests/"):
        return text
    return without_reference_imports(text).replace(
        "import timing_torch as", "import timing_jax as")


O34_FILES = [f"{PORT_CORE}/timing_torch.py", f"{PORT_CORE}/timing_model.py",
             "tests/test_torch_grid.py"]


@pytest.mark.parametrize("mutation", [
    None, "fixture_tier",
    ("tests/test_torch_grid.py", "def test_evaluate_grid_matches_port_model(",
     "def untested_evaluate_grid_matches_port_model("),
    ("tests/test_torch_grid.py",
     "def test_evaluate_points_matches_port_model(",
     "def untested_evaluate_points_matches_port_model("),
    ("tests/test_torch_grid.py", "def test_mix_point_matches_port_model(",
     "def untested_mix_point_matches_port_model("),
], ids=["clean", "fixture_tier", "evaluate_grid", "evaluate_points", "mix"])
def test_o003_o004_match_the_reference_after_the_tier_rename(tmp_path,
                                                             mutation):
    fixture = mutation == "fixture_tier"
    port, ref = port_and_reference_roots(
        tmp_path, O34_FILES, None if fixture else mutation,
        _tier_for_the_reference)
    if fixture:
        for root in (port, ref):
            shutil.copy(FIXTURES / "bad_timing_jax.py",
                        root / O34_FILES[0])
    found = rows(oracle_parity.check_torch_parity(
        *(port / rel for rel in O34_FILES), repo_root=port))
    assert bool(found) == (mutation is not None)
    assert found == rows(ref_oracle_parity.check_jax_parity(
        *(ref / rel for rel in O34_FILES), repo_root=ref), tier_rename=True)


@pytest.mark.parametrize("coverage", ["port_tests", "stub"])
def test_o005_matches_the_reference(tmp_path, coverage):
    envelope = REPO / PORT_CORE / "roofline_empirical.py"
    test = REPO / "tests/test_torch_roofline.py"
    if coverage == "stub":
        test = tmp_path / "test_torch_roofline.py"
        test.write_text("from repro_torch.core import roofline_empirical "
                        "as rf\n\n\ndef test_nothing():\n    assert rf\n")
    found = rows(oracle_parity.check_envelope_coverage(envelope, test,
                                                       repo_root=REPO))
    assert bool(found) == (coverage == "stub")
    assert found == rows(ref_oracle_parity.check_envelope_coverage(
        envelope, test, repo_root=REPO))


# ----------------------------------------------------- findings, astutil
def _fixture_findings(mod):
    return mod.check_sweep_cache_keys(FIXTURES / "bad_sweep.py",
                                      repo_root=REPO)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_baseline_round_trips_between_the_packages(tmp_path, writer):
    port_found = _fixture_findings(cache_keys)
    ref_found = _fixture_findings(ref_cache_keys)
    write, read = ((findings, ref_findings) if writer == "port"
                   else (ref_findings, findings))
    found = port_found if writer == "port" else ref_found
    other = ref_found if writer == "port" else port_found
    baseline = tmp_path / "baseline.json"
    write.write_baseline(baseline, found)
    assert read.load_baseline(baseline) == write.load_baseline(baseline)
    assert read.diff_baseline(other, read.load_baseline(baseline)).clean
    stale = read.diff_baseline(other[1:], read.load_baseline(baseline))
    assert not stale.clean and len(stale.stale) == 1
    assert findings.to_json(port_found) == ref_findings.to_json(ref_found)
    assert [f.render() for f in findings.sort_findings(port_found)] == \
        [f.render() for f in ref_findings.sort_findings(ref_found)]


PORT_MODULES = sorted(str(p.relative_to(REPO))
                      for p in (REPO / "src/repro_torch").rglob("*.py"))


def _astutil_view(mod, tree):
    fns = mod.module_functions(tree)
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    return {
        "functions": sorted(fns),
        "public": [f.name for f in mod.public_functions(tree)],
        "classes": [(c.name, mod.find_class(tree, c.name) is not None,
                     mod.dataclass_info(c)) for c in classes],
        "calls": [mod.call_name(n) for n in ast.walk(tree)
                  if isinstance(n, ast.Call)],
        "ints": [mod.int_const(n) for n in ast.walk(tree)],
        "order": [[type(s).__name__ for s in mod.statements_in_order(
            f.body)] for f in fns.values()],
    }


@pytest.mark.parametrize("rel", PORT_MODULES)
def test_astutil_matches_the_reference(rel):
    tree = astutil.parse_module(REPO / rel)
    assert _astutil_view(astutil, tree) == _astutil_view(ref_astutil, tree)
