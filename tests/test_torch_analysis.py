"""The port's repro-lint (`repro_torch.analysis`) on its own fixtures and
on mutated copies of the port's tree, on the cases of
tests/analysis/test_analyzer.py: every invariant family flags its fixture
with the right ID, and a violation put into a copy of the real tree is
caught.  Fixtures are written as strings into `tmp_path` and parsed,
never imported.
"""
import shutil
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis.cache_keys import (check_engine_mix_keyed,
                                             check_request_dedup,
                                             check_sweep_cache_keys,
                                             check_timing_signature_coverage)
from repro_torch.analysis.capabilities import check_capability_contracts
from repro_torch.analysis.kernel_shapes import (check_dtype_codes,
                                                check_entry_points,
                                                check_kernel_safety,
                                                check_operand_guards,
                                                check_operand_shapes,
                                                check_working_buffers,
                                                extern_c_functions)
from repro_torch.analysis.oracle_parity import (check_envelope_coverage,
                                                check_oracle_parity,
                                                check_torch_parity)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src/repro_torch"
CORE = PKG / "core"
KERNELS = PKG / "kernels"


def ids(findings):
    return {f.invariant for f in findings}


def message_of(findings, invariant):
    return " | ".join(f.message for f in findings
                      if f.invariant == invariant)


def write(tmp_path, name, text):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(text))
    return path


def mutate(src: Path, dst: Path, old: str, new: str) -> Path:
    text = src.read_text()
    mutated = text.replace(old, new)
    assert mutated != text, f"{src.name} moved; update the probe"
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(mutated)
    return dst


# ------------------------------------------------------------- C family
BAD_SWEEP = '''
    import dataclasses


    @dataclasses.dataclass
    class SweepPoint:
        params: object
        policy: str = "RBC"
        op: str = "read"
        arbitration: str = "round_robin"


    class Sweep:
        def __init__(self):
            self._tp_cache = {}

        def _run_throughput(self, pt):
            key = (pt.params, pt.policy, pt.op)
            base = self._tp_cache.get(key)
            if base is None:
                base = evaluate(pt.params, pt.policy, op=pt.op,
                                arbitration=pt.arbitration)
                self._tp_cache[key] = base
            return base


    def evaluate(p, policy, *, op, arbitration):
        return (p, policy, op, arbitration)
'''

BAD_TIMING = '''
    def throughput(p, mapping, spec, *, op="read"):
        return 0.0


    def frobnicate(p, mapping, spec, *, mystery_axis=3):
        return float(mystery_axis)
'''

BAD_CAMPAIGN = '''
    import dataclasses


    @dataclasses.dataclass(frozen=True)
    class ExperimentRequest:
        experiment: str
        spec: str = "hbm"
        quick: bool = dataclasses.field(default=False, compare=False)


    class CampaignService:
        def __init__(self):
            self._responses = {}

        def submit(self, request):
            cached = self._responses.get(request.experiment)
            if cached is not None:
                return cached
            resp = self._execute(request)
            self._responses[request.experiment] = resp
            return resp

        def _execute(self, req):
            return (req.experiment, req.spec, req.quick)
'''


def test_fixture_missing_cache_key_field_is_c001(tmp_path):
    findings = check_sweep_cache_keys(write(tmp_path, "sweep.py", BAD_SWEEP))
    assert "REPRO-C001" in ids(findings)
    assert "pt.arbitration" in message_of(findings, "REPRO-C001")


def test_fixture_unfrozen_point_is_c002(tmp_path):
    findings = check_sweep_cache_keys(write(tmp_path, "sweep.py", BAD_SWEEP))
    assert "REPRO-C002" in ids(findings)
    assert "not frozen" in message_of(findings, "REPRO-C002")


def test_fixture_unkeyable_model_axis_is_c003(tmp_path):
    findings = check_timing_signature_coverage(
        write(tmp_path, "timing.py", BAD_TIMING),
        write(tmp_path, "sweep.py", BAD_SWEEP),
        functions=("throughput", "frobnicate"))
    assert ids(findings) == {"REPRO-C003"}
    assert "mystery_axis" in message_of(findings, "REPRO-C003")


def test_fixture_partial_dedup_key_is_c004(tmp_path):
    findings = check_request_dedup(write(tmp_path, "campaign.py",
                                         BAD_CAMPAIGN))
    msgs = message_of(findings, "REPRO-C004")
    assert "projection" in msgs
    assert "compare=False" in msgs


@pytest.mark.parametrize("target,old,new", [
    ("sweep.py",
     "        key = (pt.params, pt.policy, pt.op, pt.num_engines,\n"
     "               pt.arbitration, pt.burst_beats, pt.placement, pt.mix)",
     "        key = (pt.params, pt.policy, pt.op, pt.num_engines,\n"
     "               pt.arbitration, pt.burst_beats, pt.placement)"),
    ("sweep.py",
     "            key = (\"cont\", pt.params, pt.policy, pt.op, "
     "pt.num_engines,\n"
     "                   pt.arbitration, pt.burst_beats, pt.placement, "
     "pt.mix,\n",
     "            key = (\"cont\", pt.params, pt.policy, pt.op, "
     "pt.num_engines,\n"
     "                   pt.arbitration, pt.burst_beats, pt.placement,\n"),
    ("autotune.py",
     "        key = (pt.params, pt.policy, pt.op, pt.num_engines,\n"
     "               pt.arbitration, pt.burst_beats, pt.placement, pt.mix)",
     "        key = (pt.params, pt.policy, pt.op, pt.num_engines,\n"
     "               pt.arbitration, pt.burst_beats, pt.placement)"),
], ids=["sweep_memo", "sweep_flight", "tuner_probe"])
def test_dropping_the_mix_from_a_key_fails_the_pass(tmp_path, target, old,
                                                    new):
    mutated = mutate(CORE / target, tmp_path / target, old, new)
    kw = (dict(sweep_class="LayoutTuner", point_class="LayoutConfig")
          if target == "autotune.py" else {})
    findings = check_sweep_cache_keys(mutated, **kw)
    assert "REPRO-C001" in ids(findings)
    assert "pt.mix" in message_of(findings, "REPRO-C001")


def test_unfreezing_engine_mix_fails_the_pass(tmp_path):
    mutated = mutate(CORE / "engine_mix.py", tmp_path / "engine_mix.py",
                     "@dataclasses.dataclass(frozen=True)\nclass EngineMix:",
                     "@dataclasses.dataclass\nclass EngineMix:")
    findings = check_engine_mix_keyed(mutated)
    assert "REPRO-C002" in ids(findings)
    assert "EngineMix" in message_of(findings, "REPRO-C002")
    assert check_engine_mix_keyed(CORE / "engine_mix.py") == []


def test_real_tuner_tree_is_clean():
    assert check_sweep_cache_keys(
        CORE / "autotune.py", repo_root=REPO, sweep_class="LayoutTuner",
        point_class="LayoutConfig") == []


# ------------------------------------------------------------- O family
BAD_REFERENCE = '''
    def throughput(p, mapping, spec, *, op="read"):
        total = 0.0
        for _ in range(p.n):
            total += 1.0
        return total
'''

BAD_PARITY_TEST = '''
    from repro_torch.core import _timing_reference as ref
    from repro_torch.core import timing_model as vec


    def test_throughput_parity():
        assert vec.throughput is not ref.throughput
'''


def test_fixture_missing_oracle_is_o001(tmp_path):
    findings = check_oracle_parity(
        write(tmp_path, "timing.py", BAD_TIMING),
        write(tmp_path, "reference.py", BAD_REFERENCE),
        write(tmp_path, "parity_test.py", BAD_PARITY_TEST))
    assert "REPRO-O001" in ids(findings)
    assert "frobnicate" in message_of(findings, "REPRO-O001")


def test_fixture_untested_pair_is_o002(tmp_path):
    empty = write(tmp_path, "parity_test.py", '''
        from repro_torch.core import _timing_reference as ref
        from repro_torch.core import timing_model as vec
    ''')
    findings = check_oracle_parity(
        write(tmp_path, "timing.py", BAD_TIMING),
        write(tmp_path, "reference.py", BAD_REFERENCE), empty)
    assert "REPRO-O002" in ids(findings)
    assert "throughput" in message_of(findings, "REPRO-O002")


def test_reference_imports_do_not_bind_the_port_aliases(tmp_path):
    """The trouble spot of the port's tests: they import both packages.
    A test pinning the *reference's* modules, imported first, must not
    count as the port's coverage."""
    tests = write(tmp_path, "parity_test.py", '''
        from repro.core import _timing_reference as ref_loop
        from repro.core import timing_model as ref_vec
        from repro_torch.core import _timing_reference as loop
        from repro_torch.core import timing_model as vec


        def test_throughput_parity():
            assert ref_vec.throughput is not ref_loop.throughput
    ''')
    timing = write(tmp_path, "timing.py", BAD_TIMING)
    reference = write(tmp_path, "reference.py", BAD_REFERENCE)
    findings = check_oracle_parity(timing, reference, tests)
    assert "REPRO-O002" in ids(findings)
    assert "throughput" in message_of(findings, "REPRO-O002")
    only_reference = write(tmp_path, "ref_only_test.py", '''
        from repro.core import _timing_reference as ref
        from repro.core import timing_model as vec


        def test_throughput_parity():
            assert vec.throughput is not ref.throughput
    ''')
    findings = check_oracle_parity(timing, reference, only_reference)
    assert "does not import both" in message_of(findings, "REPRO-O002")


def test_deleting_an_oracle_fails_the_pass(tmp_path):
    mutated = mutate(CORE / "_timing_reference.py",
                     tmp_path / "_timing_reference.py",
                     "def serial_write_latencies(",
                     "def _serial_write_latencies_gone(")
    findings = check_oracle_parity(
        CORE / "timing_model.py", mutated,
        REPO / "tests/test_torch_timing_reference.py")
    assert "REPRO-O001" in ids(findings)
    assert "serial_write_latencies" in message_of(findings, "REPRO-O001")


@pytest.mark.parametrize("test_name,oracle", [
    ("test_serial_read_latencies_parity", "serial_read_latencies"),
    ("test_contended_mix_loop_matches_reference", "contended_throughput_mix"),
    ("test_throughput_loop_matches_reference", "throughput"),
])
def test_dropping_a_parity_test_fails_the_pass(tmp_path, test_name, oracle):
    mutated = mutate(REPO / "tests/test_torch_timing_reference.py",
                     tmp_path / "test_torch_timing_reference.py",
                     f"def {test_name}(", f"def untested_{test_name}(")
    findings = check_oracle_parity(CORE / "timing_model.py",
                                   CORE / "_timing_reference.py", mutated)
    assert "REPRO-O002" in ids(findings)
    assert f"reference {oracle}()" in message_of(findings, "REPRO-O002")


def test_fixture_unmapped_torch_function_is_o003(tmp_path):
    tier = write(tmp_path, "timing_torch.py", '''
        def throughput(p, mapping, spec, *, op="read", device=None):
            return None


        def frobnicate_grid(spec, axes, *, device=None):
            return None
    ''')
    findings = check_torch_parity(tier, CORE / "timing_model.py",
                                  REPO / "tests/test_torch_grid.py")
    assert "REPRO-O003" in ids(findings)
    assert "frobnicate_grid" in message_of(findings, "REPRO-O003")


@pytest.mark.parametrize("test_name,entry", [
    ("test_evaluate_grid_matches_port_model", "evaluate_grid"),
    ("test_evaluate_points_matches_port_model", "evaluate_points"),
    ("test_mix_point_matches_port_model", "contended_throughput_mix"),
])
def test_deleting_a_differential_case_fails_the_pass(tmp_path, test_name,
                                                     entry):
    mutated = mutate(REPO / "tests/test_torch_grid.py",
                     tmp_path / "test_torch_grid.py",
                     f"def {test_name}(", f"def untested_{test_name}(")
    findings = check_torch_parity(CORE / "timing_torch.py",
                                  CORE / "timing_model.py", mutated)
    assert "REPRO-O004" in ids(findings)
    assert f"timing_torch.{entry}()" in message_of(findings, "REPRO-O004")


def test_real_torch_tier_is_clean():
    assert check_torch_parity(CORE / "timing_torch.py",
                              CORE / "timing_model.py",
                              REPO / "tests/test_torch_grid.py") == []


def test_real_envelope_coverage_is_clean():
    assert check_envelope_coverage(
        CORE / "roofline_empirical.py", REPO / "tests/test_torch_roofline.py",
        repo_root=REPO) == []


def test_unreferenced_envelope_math_is_o005(tmp_path):
    stub = write(tmp_path, "test_roofline.py", '''
        from repro_torch.core import roofline_empirical as rf


        def test_nothing():
            assert rf is not None
    ''')
    findings = check_envelope_coverage(CORE / "roofline_empirical.py", stub)
    assert ids(findings) == {"REPRO-O005"}
    msgs = message_of(findings, "REPRO-O005")
    for name in ("build_envelope", "measure_envelope", "config_ceiling_gbps",
                 "attainable", "knee_ai"):
        assert name in msgs


# ------------------------------------------------------------- B family
BAD_BACKEND = '''
    class UnsupportedCapability(NotImplementedError):
        pass


    class Backend:
        supports_latency = False
        supports_contention = False

        def latency(self, spec, p, mapping, **kw):
            raise UnsupportedCapability("no serial timers")

        def contended_throughput(self, spec, p, mapping, **kw):
            raise UnsupportedCapability("no shared-port model")


    class UndeclaredBackend(Backend):
        def latency(self, spec, p, mapping, **kw):
            return [1.0] * p.n


    class PhantomBackend(Backend):
        supports_contention = True


    class OpaqueBackend(Backend):
        def __init__(self, enable):
            self.supports_latency = enable

        def latency(self, spec, p, mapping, **kw):
            return [1.0] * p.n
'''


def test_fixture_capability_contracts_b001_b002_b003(tmp_path):
    findings = check_capability_contracts(
        [write(tmp_path, "backend.py", BAD_BACKEND)])
    assert ids(findings) == {"REPRO-B001", "REPRO-B002", "REPRO-B003"}
    assert "UndeclaredBackend" in message_of(findings, "REPRO-B001")
    assert "PhantomBackend" in message_of(findings, "REPRO-B002")
    assert "OpaqueBackend" in message_of(findings, "REPRO-B003")


def test_declaring_latency_on_the_cuda_backend_fails_the_pass(tmp_path):
    """CudaBackend has no serial timers: flipping its flag makes the
    Engine's gate pass into the raising stub."""
    mutated = mutate(
        CORE / "engine.py", tmp_path / "engine.py",
        "    supports_latency = False\n    supports_contention = True\n\n"
        "    def __init__(self, device: \"torch.device | str | None\" = None):",
        "    supports_latency = True\n    supports_contention = True\n\n"
        "    def __init__(self, device: \"torch.device | str | None\" = None):")
    findings = check_capability_contracts(
        [mutated, PKG / "service/faults.py"])
    assert "REPRO-B002" in ids(findings)
    assert "CudaBackend" in message_of(findings, "REPRO-B002")


def test_undeclaring_contention_on_torchgrid_fails_the_pass(tmp_path):
    mutated = mutate(
        CORE / "engine.py", tmp_path / "engine.py",
        "    supports_contention = True\n    supports_grid = True",
        "    supports_contention = False\n    supports_grid = True")
    findings = check_capability_contracts([mutated])
    assert "REPRO-B001" in ids(findings)
    assert "TorchGridBackend" in message_of(findings, "REPRO-B001")


def test_an_opaque_fault_wrapper_flag_fails_the_pass(tmp_path):
    mutated = mutate(
        PKG / "service/faults.py", tmp_path / "faults.py",
        "        self.supports_latency = self.inner.supports_latency",
        "        self.supports_latency = bool(script)")
    findings = check_capability_contracts([CORE / "engine.py", mutated])
    assert "REPRO-B003" in ids(findings)
    assert "FaultInjectingBackend" in message_of(findings, "REPRO-B003")


def test_every_port_backend_is_covered():
    classes = {"SimBackend", "CudaBackend", "TorchGridBackend",
               "FaultInjectingBackend"}
    findings = check_capability_contracts(
        [CORE / "engine.py", PKG / "service/faults.py"])
    assert findings == []
    text = (CORE / "engine.py").read_text() + (
        PKG / "service/faults.py").read_text()
    assert all(f"class {name}(" in text for name in classes)


# ------------------------------------------------------------- K family
C_SOURCE = '''
    #include <stdint.h>

    namespace {
    constexpr int kFloat32 = 0;
    constexpr int kBFloat16 = 1;
    __global__ void read_kernel(const float* buf, int64_t n) {}
    }  // namespace

    extern "C" {

    // Launches the read; returns the cudaError_t.
    int toy_read_launch(int device, const void* buf, int dtype,
                        int64_t tile_bytes, int64_t n, void* stream) {
      if (n < 0) { return 1; }
      return 0;
    }

    const char* toy_error_string(int err) { return "x"; }

    }  // extern "C"
'''

BUILD = '''
    import ctypes

    _c_int, _c_i64, _c_ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    _SIGNATURES = {
        # device, buf, dtype, tile_bytes, n, stream
        "toy_read_launch": (_c_int, _c_ptr, _c_int, _c_i64, _c_i64, _c_ptr),
    }


    def library():
        lib = ctypes.CDLL("libtoy.so")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.toy_error_string.argtypes = [ctypes.c_int]
        lib.toy_error_string.restype = ctypes.c_char_p
        return lib
'''

WRAPPER = '''
    from toy import _build

    DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


    def toy_read(params, buf):
        lib = _build.library()
        return lib.toy_read_launch(buf.device.index, buf.data_ptr(),
                                   DTYPE_CODES[buf.dtype], 4096, 8, 0)
'''


def _toy_kernels(tmp_path, *, c_source=C_SOURCE, build=BUILD,
                 wrapper=WRAPPER):
    """(build, [source], [callers]) of a toy kernels package."""
    src = write(tmp_path, "csrc/toy.cu", c_source)
    build_path = write(tmp_path, "_build.py", build)
    wrapper_path = write(tmp_path, "rst_toy.py", wrapper)
    return build_path, [src], [wrapper_path, build_path]


def test_extern_c_parse_of_the_toy_source(tmp_path):
    build, srcs, _ = _toy_kernels(tmp_path)
    fns = {f.name: f for f in extern_c_functions(srcs)}
    assert set(fns) == {"toy_read_launch", "toy_error_string"}
    assert [t for t, _ in fns["toy_read_launch"].params] == [
        "int", "pointer", "int", "int64_t", "int64_t", "pointer"]
    assert fns["toy_error_string"].returns == "char pointer"
    assert fns["toy_read_launch"].line == 13
    assert check_entry_points(build, srcs, []) == []


def test_extern_c_parse_of_the_real_sources():
    fns = {f.name: f for f in extern_c_functions(
        sorted((KERNELS / "csrc").glob("*.cu")))}
    assert set(fns) == {"rst_read_launch", "rst_write_launch",
                        "rst_contend_read_launch",
                        "rst_contend_mix_read_launch", "rst_error_string"}
    assert len(fns["rst_read_launch"].params) == 13
    assert len(fns["rst_contend_read_launch"].params) == 16
    assert fns["rst_contend_mix_read_launch"].params[4] == ("pointer",
                                                           "table")


def test_signature_one_argument_short_is_k001(tmp_path):
    build, srcs, callers = _toy_kernels(tmp_path, build=BUILD.replace(
        "(_c_int, _c_ptr, _c_int, _c_i64, _c_i64, _c_ptr)",
        "(_c_int, _c_ptr, _c_int, _c_i64, _c_ptr)"))
    findings = check_entry_points(build, srcs, callers)
    assert ids(findings) == {"REPRO-K001"}
    assert "typed with 5 arguments" in message_of(findings, "REPRO-K001")
    assert "takes 6" in message_of(findings, "REPRO-K001")


def test_c_int_where_c_takes_int64_is_k001(tmp_path):
    build, srcs, callers = _toy_kernels(tmp_path, build=BUILD.replace(
        "(_c_int, _c_ptr, _c_int, _c_i64, _c_i64, _c_ptr)",
        "(_c_int, _c_ptr, _c_int, _c_i64, _c_int, _c_ptr)"))
    findings = check_entry_points(build, srcs, callers)
    assert ids(findings) == {"REPRO-K001"}
    msg = message_of(findings, "REPRO-K001")
    assert "argument 4 (n) is int64_t in C" in msg and "c_int in" in msg


def test_call_site_with_a_surplus_argument_is_k001(tmp_path):
    build, srcs, callers = _toy_kernels(tmp_path, wrapper=WRAPPER.replace(
        "DTYPE_CODES[buf.dtype], 4096, 8, 0)",
        "DTYPE_CODES[buf.dtype], 4096, 8, 0, 0)"))
    findings = check_entry_points(build, srcs, callers)
    assert ids(findings) == {"REPRO-K001"}
    assert "passes 7 arguments to toy_read_launch(), which takes 6" in \
        message_of(findings, "REPRO-K001")


def test_untyped_and_unknown_entry_points_are_k001(tmp_path):
    c_source = C_SOURCE.replace(
        "const char* toy_error_string",
        "int toy_write_launch(int device, void* stream) { return 0; }\n"
        "    const char* toy_error_string")
    build, srcs, callers = _toy_kernels(
        tmp_path, c_source=c_source,
        wrapper=WRAPPER + "\n    _build.library().toy_reed_launch(1)\n")
    msgs = message_of(check_entry_points(build, srcs, callers), "REPRO-K001")
    assert "toy_write_launch() has no ctypes signature" in msgs
    assert "calls toy_reed_launch()" in msgs


def test_a_wrong_restype_is_k001(tmp_path):
    build, srcs, callers = _toy_kernels(tmp_path, build=BUILD.replace(
        "lib.toy_error_string.restype = ctypes.c_char_p", ""))
    findings = check_entry_points(build, srcs, callers)
    assert "returns char pointer in C" in message_of(findings, "REPRO-K001")


def test_deleting_the_error_string_typing_fails_the_pass(tmp_path):
    kernels = _copy_kernels(tmp_path)
    mutate(kernels / "_build.py", kernels / "_build.py",
           "        lib.rst_error_string.argtypes = [ctypes.c_int]\n"
           "        lib.rst_error_string.restype = ctypes.c_char_p\n", "")
    findings = check_kernel_safety(kernels)
    assert "REPRO-K001" in ids(findings)
    assert "rst_error_string() has no ctypes signature" in message_of(
        findings, "REPRO-K001")


TOY_OPS = textwrap.dedent('''
    import torch

    from repro_torch.kernels.rst_toy import toy_read


    def _require_int32_index_range(stride_b, wset_b, base_b, n,
                                   num_engines=1):
        pass


    def params_operand(p):
        """Pack the int32[4] operand."""
        _require_int32_index_range(p.s, p.w, p.a, p.n)
        return torch.tensor([p.s, p.w, p.a, p.n], dtype=torch.int32)


    def contended_params_operand(p, num_engines):
        """Pack the int32[6] operand."""
        base = params_operand(p)
        _require_int32_index_range(p.s, p.w, p.a, p.n, num_engines=num_engines)
        return torch.cat([base, torch.tensor([num_engines, 1])])


    def make_working_buffer(p, dtype, *, num_engines=1):
        span = p.a + num_engines * p.w
        return torch.zeros(span // 512, 128, dtype=dtype)


    def make_mix_working_buffer(mix, dtype):
        span = max(p.a + p.w for p, _ in mix.entries)
        return torch.zeros(span // 512, 128, dtype=dtype)


    def measure(p):
        operand = contended_params_operand(p, 2)
        return toy_read(operand, make_working_buffer(p, torch.float32))
''')

TOY_KERNEL = '''
    OPERAND_LEN = 4
    CONTENDED_OPERAND_LEN = 6


    def toy_scalars(params):
        """(stride, wset, base, n) of the int32[4] operand."""
        values = torch.as_tensor(params).reshape(-1).tolist()
        if len(values) != OPERAND_LEN:
            raise ValueError(values)
        return values


    def toy_read(params, buf):
        """params: int32[6] = (stride, wset, base, n, engines, bb)."""
        values = torch.as_tensor(params).reshape(-1).tolist()
        if len(values) != CONTENDED_OPERAND_LEN:
            raise ValueError(values)
        stride, wset, base, n, engines, bb = (int(v) for v in values)
        return buf
'''


def _toy_ops(tmp_path, ops=TOY_OPS, kernel=TOY_KERNEL):
    """(ops.py, [its kernel wrapper module]) of a toy kernels package."""
    wrapper = write(tmp_path, "rst_toy.py", kernel)
    return write(tmp_path, "ops.py", ops), [wrapper]


def test_toy_ops_are_clean(tmp_path):
    ops, wrappers = _toy_ops(tmp_path)
    assert check_operand_guards(ops) == []
    assert check_operand_shapes(ops, wrappers) == []
    assert check_working_buffers(ops) == []


def test_packer_without_the_guard_is_k002(tmp_path):
    ops, _ = _toy_ops(tmp_path, TOY_OPS.replace(
        "    _require_int32_index_range(p.s, p.w, p.a, p.n)\n", ""))
    findings = check_operand_guards(ops)
    assert ids(findings) == {"REPRO-K002"}
    assert "params_operand() packs operands" in message_of(findings,
                                                           "REPRO-K002")


def test_guard_without_the_engine_count_is_k002(tmp_path):
    ops, _ = _toy_ops(tmp_path, TOY_OPS.replace(
        "p.n, num_engines=num_engines)", "p.n)"))
    findings = check_operand_guards(ops)
    assert ids(findings) == {"REPRO-K002"}
    assert "contended_params_operand() packs an engine count" in \
        message_of(findings, "REPRO-K002")


def test_an_int32_cast_is_not_the_guard_k002(tmp_path):
    """Only the guard by its name counts: a packer that casts with
    np.int32 or ctypes.c_int32 and never reaches it gets K002."""
    ops, _ = _toy_ops(tmp_path, TOY_OPS.replace(
        "    _require_int32_index_range(p.s, p.w, p.a, p.n)\n",
        "    stride = np.int32(p.s)\n    n = ctypes.c_int32(p.n)\n"))
    findings = check_operand_guards(ops)
    assert ids(findings) == {"REPRO-K002"}
    assert "params_operand() packs operands" in message_of(findings,
                                                           "REPRO-K002")


def test_documented_int32_5_over_a_6_wide_pack_is_k003(tmp_path):
    ops, wrappers = _toy_ops(tmp_path, TOY_OPS.replace(
        '"""Pack the int32[6] operand."""', '"""Pack the int32[5] operand."""'))
    findings = check_operand_shapes(ops, wrappers)
    assert ids(findings) == {"REPRO-K003"}
    assert "documents an int32[5] operand but contended_params_operand() " \
        "packs int32[6]" in message_of(findings, "REPRO-K003")


def test_wrapper_docstring_and_unpacking_are_held_to_the_pack(tmp_path):
    ops, wrappers = _toy_ops(tmp_path, kernel=TOY_KERNEL.replace(
        "params: int32[6]", "params: int32[4]").replace(
        "CONTENDED_OPERAND_LEN = 6", "CONTENDED_OPERAND_LEN = 5"))
    msgs = message_of(check_operand_shapes(ops, wrappers), "REPRO-K003")
    assert "toy_read() documents an int32[4] operand" in msgs
    assert "contended_params_operand() packs int32[6] but" in msgs
    assert "sets CONTENDED_OPERAND_LEN = 5" in msgs


def test_an_unchecked_operand_length_is_k003(tmp_path):
    ops, wrappers = _toy_ops(tmp_path, kernel=TOY_KERNEL.replace(
        "len(values) != OPERAND_LEN", "len(values) != 4"))
    findings = check_operand_shapes(ops, wrappers)
    assert ids(findings) == {"REPRO-K003"}
    assert "no kernel wrapper checks an operand against OPERAND_LEN" in \
        message_of(findings, "REPRO-K003")


def test_a_packer_without_a_named_length_is_k003(tmp_path):
    ops, wrappers = _toy_ops(tmp_path, kernel=TOY_KERNEL.replace(
        "    OPERAND_LEN = 4\n", ""))
    assert "params_operand() packs int32[4] but no kernel wrapper defines " \
        "OPERAND_LEN" in message_of(check_operand_shapes(ops, wrappers),
                                    "REPRO-K003")


def test_buffer_sized_without_the_base_is_k004(tmp_path):
    ops, _ = _toy_ops(tmp_path, TOY_OPS.replace(
        "span = p.a + num_engines * p.w", "span = num_engines * p.w"))
    findings = check_working_buffers(ops)
    assert ids(findings) == {"REPRO-K004"}
    assert "make_working_buffer() sizes the buffer without the RST base" \
        in message_of(findings, "REPRO-K004")


def test_dtype_code_off_by_one_is_k005(tmp_path):
    _, srcs, _ = _toy_kernels(tmp_path)
    wrapper = write(tmp_path, "rst_read.py", WRAPPER.replace(
        "torch.bfloat16: 1", "torch.bfloat16: 2"))
    findings = check_dtype_codes(wrapper, srcs)
    assert ids(findings) == {"REPRO-K005"}
    assert "DTYPE_CODES[torch.bfloat16] = 2 but" in message_of(
        findings, "REPRO-K005")
    assert "kBFloat16 = 1" in message_of(findings, "REPRO-K005")
    assert check_dtype_codes(write(tmp_path, "rst_ok.py", WRAPPER), srcs) \
        == []


# ------------------------------------- mutations of a copy of the kernels
def _copy_kernels(tmp_path) -> Path:
    """The port's kernels package and the core module its buffers read
    the base through, under tmp_path/src/repro_torch/."""
    root = tmp_path / "src/repro_torch"
    shutil.copytree(KERNELS, root / "kernels",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "core").mkdir(parents=True)
    shutil.copy(CORE / "rst.py", root / "core/rst.py")
    return root / "kernels"


def test_real_kernels_package_is_clean(tmp_path):
    assert check_kernel_safety(KERNELS, repo_root=REPO) == []
    assert check_kernel_safety(_copy_kernels(tmp_path)) == []


@pytest.mark.parametrize("packer,old,new", [
    ("params_operand",
     "    n = p.n if grid_txns is None else min(p.n, grid_txns)\n"
     "    _require_int32_index_range(stride_b, wset_b, base_b, n)\n"
     "    return torch.tensor(",
     "    n = p.n if grid_txns is None else min(p.n, grid_txns)\n"
     "    return torch.tensor("),
    ("contended_params_operand",
     "    _require_int32_index_range(stride_b, wset_b, base_b, n,\n"
     "                               num_engines=num_engines)\n", ""),
    ("mix_params_operand",
     "        _require_int32_index_range(stride_b, wset_b, base_k, n)\n", ""),
])
def test_removing_a_packers_guard_fails_the_pass(tmp_path, packer, old, new):
    kernels = _copy_kernels(tmp_path)
    mutate(kernels / "ops.py", kernels / "ops.py", old, new)
    findings = check_kernel_safety(kernels)
    assert ids(findings) == {"REPRO-K002"}
    assert f"{packer}()" in message_of(findings, "REPRO-K002")


@pytest.mark.parametrize("target,old,new,expect", [
    ("_build.py", "_c_i64,\n                         _c_i64, _c_ptr),",
     "_c_i64,\n                         _c_ptr),",
     "rst_write_launch() is typed with 8"),
    ("rst_contend.py", "CONTENDED_OPERAND_LEN = 6",
     "CONTENDED_OPERAND_LEN = 5",
     "rst_contend.py sets CONTENDED_OPERAND_LEN = 5"),
    ("rst_contend.py", "tuple(table.shape) != (num_engines + 1, MIX_ROW)",
     "tuple(table.shape) != (num_engines + 1, 4)",
     "no kernel wrapper checks an operand against MIX_ROW"),
    ("rst_contend.py", 'int32[N+1, 4] table."""', 'int32[N, 4] table."""',
     "shared_memory_bytes() documents an int32[N, 4] operand"),
    ("rst_read.py", "    params: int32[4] =", "    params: int32[6] =",
     "rst_read() documents an int32[6] operand"),
    ("rst_read.py", "torch.int8: 2}", "torch.int8: 3}",
     "DTYPE_CODES[torch.int8] = 3"),
    ("ops.py", "    span = p.a + num_engines * p.w",
     "    span = num_engines * p.w", "make_working_buffer() sizes"),
])
def test_mutating_the_launch_path_fails_the_pass(tmp_path, target, old, new,
                                                 expect):
    kernels = _copy_kernels(tmp_path)
    mutate(kernels / target, kernels / target, old, new)
    findings = check_kernel_safety(kernels)
    assert expect in " | ".join(f.message for f in findings)


def test_findings_carry_location_id_and_hint(tmp_path):
    findings = check_sweep_cache_keys(write(tmp_path, "sweep.py", BAD_SWEEP))
    build, srcs, callers = _toy_kernels(tmp_path, build=BUILD.replace(
        "_c_i64, _c_i64, _c_ptr)", "_c_i64, _c_ptr)"))
    findings += check_entry_points(build, srcs, callers)
    for f in findings:
        assert f.line >= 1
        assert f.hint
        assert f.invariant.startswith("REPRO-")
