"""The port's multi-engine contention path against the reference: the
contention kernels' plain versions against the Pallas kernels in
interpret mode, the contention operands, wrappers and error texts of
`ops`, the `cuda` backend through `Sweep.add_contention`, the placement
fold, and the bench CLI's contention flags.

On the CPU the port's wrappers run their plain PyTorch versions; the
tests marked `cuda` hold the CUDA kernels against those plain versions
and skip where there is no card.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core import RSTParams as RefParams
from repro.core.engine import combine_placement_ports as ref_combine
from repro.core.engine_mix import EngineMix as RefMix
from repro.kernels import ops as ref_ops
from repro.kernels.rst_contend import rst_contend_mix_read as ref_mix_read
from repro.kernels.rst_contend import rst_contend_read as ref_contend_read
from repro.kernels.rst_read import rst_read as ref_read
from repro_torch import bench
from repro_torch.core import EngineMix, RSTParams
from repro_torch.core.engine import CudaBackend
from repro_torch.kernels import ops
from repro_torch.kernels import rst_contend as rst_contend_module
from repro_torch.kernels.rst_contend import (SHARED_MEMORY_LIMIT,
                                             check_shared_memory,
                                             contend_tile_indices,
                                             rst_contend_mix_read,
                                             rst_contend_mix_read_plain,
                                             rst_contend_read,
                                             rst_contend_read_plain,
                                             shared_memory_bytes,
                                             total_steps)
from repro_torch.kernels.rst_read import LANE, grid_shape, rst_read

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
TILE = 8 * LANE * 4  # burst_rows=8, float32

# tests/kernels/test_rst_kernels.py::TestContendedKernel as kernel
# operands, with a nonzero base, a burst_rows-16 tile and a grid clamp
# added: (burst_rows, stride, wset, base, n, engines, grant beats, grid).
CONTEND_CASES = (
    [(8, 2, 8, 0, 12, e, 1, 16) for e in (1, 2, 3, 4)]
    + [(8, 2, 16, 0, 9, 1, 1, 16)]
    + [(8, 2, 8, 0, 11, e, bb, 16) for e in (2, 3) for bb in (2, 4, 8)]
    + [(8, 2, 8, 0, 9, 2, 16, 16),     # exclusive, clamped to the grid
       (8, 2, 8, 0, 11, 2, 16, 16),    # an oversized burst, clamped
       (8, 1, 16, 0, 8, 2, 1, 16), (8, 1, 16, 0, 8, 2, 4, 16),
       (8, 2, 8, 3, 11, 3, 4, 16),     # nonzero base, ragged n % bb
       (16, 1, 4, 1, 7, 2, 2, 8),
       (8, 1, 8, 0, 99, 2, 3, 16)])    # n past the grid: whole grants
# TestMixKernel as tables: (engine rows, grant beats, grid).
MIX_ROWS = [[2, 8, 0, 12], [1, 4, 8, 9], [8, 16, 12, 16]]
MIX_CASES = (
    [(MIX_ROWS, bb, 16) for bb in (1, 4, 16)]
    + [([[2, 8, 0, 8], [1, 4, 8, 6]], 4, 16),
       ([[1, 4, 0, 8], [2, 8, 4, 8]], 1, 16),
       ([[3, 8, 2, 11], [1, 4, 10, 5], [2, 6, 14, 13]], 3, 13),
       ([[1, 8, 0, 20], [2, 8, 8, 5]], 4, 8)])

# The reference names its own substrate where the port names the card's.
_SUBSTRATE = [("pallas", "cuda"), ("sim/jaxgrid", "sim/torchgrid"),
              ("on TPU the burst is the BlockSpec tile",
               "the burst is the kernel's tile")]


def as_port_text(text: str) -> str:
    for ref, port in _SUBSTRATE:
        text = text.replace(ref, port)
    return text


def _mk(rows, jdtype, seed=0):
    """tests/kernels/test_rst_kernels.py::_mk: the same numpy input for
    both packages, returned as the reference's array."""
    rng = np.random.default_rng(seed)
    if jnp.dtype(jdtype) == jnp.int8:
        x = rng.integers(-4, 5, size=(rows, LANE), dtype=np.int8)
    else:
        x = rng.standard_normal((rows, LANE)).astype(np.float32)
    return jnp.asarray(x, dtype=jdtype)


def _rtol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-5


def _params(**kw):
    return RSTParams(**kw), RefParams(**kw)


def _mixes(entries):
    """The same engine mix in both packages; entries are (kwargs, op)."""
    return (EngineMix.of([(RSTParams(**kw), op) for kw, op in entries]),
            RefMix(tuple((RefParams(**kw), op) for kw, op in entries)))


# ----------------------------------------------------------- the kernels


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CONTEND_CASES, ids=str)
def test_contend_read_matches_pallas(dtype, case):
    burst_rows, stride, wset, base, n, engines, bb, grid = case
    jdt, tdt = DTYPES[dtype]
    buf = _mk((base + engines * wset) * burst_rows, jdt, seed=3)
    params = jnp.array([stride, wset, base, n, engines, bb], jnp.int32)
    want = ref_contend_read(params, buf, grid_txns=grid, num_engines=engines,
                            burst_beats=bb, burst_rows=burst_rows)
    tbuf, tparams = ops.from_reference(np.asarray(buf), np.asarray(params),
                                       device="cpu")
    assert tbuf.dtype == tdt
    got = rst_contend_read(tparams, tbuf, grid_txns=grid, num_engines=engines,
                           burst_beats=bb, burst_rows=burst_rows)
    assert got.dtype == torch.float32 and got.shape == (burst_rows, LANE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=_rtol(dtype), atol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MIX_CASES, ids=str)
def test_contend_mix_read_matches_pallas(dtype, case):
    rows, bb, grid = case
    jdt, _ = DTYPES[dtype]
    span = max(base + wset for _, wset, base, _ in rows)
    buf = _mk(span * 8, jdt, seed=4)
    table = jnp.array([[len(rows), bb, 0, 0]] + rows, jnp.int32)
    want = ref_mix_read(table, buf, grid_txns=grid, num_engines=len(rows),
                        burst_beats=bb)
    tbuf, ttable = ops.from_reference(np.asarray(buf), np.asarray(table),
                                      device="cpu")
    assert ttable.shape == (len(rows) + 1, 4)
    got = rst_contend_mix_read(ttable, tbuf, grid_txns=grid,
                               num_engines=len(rows), burst_beats=bb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=_rtol(dtype), atol=1e-4)


@pytest.mark.parametrize("kernel", ["contend", "mix"])
@pytest.mark.parametrize("bad,kw", [
    ((64, 64), {}), ((64, LANE), {"burst_rows": 12}),
    ((60, LANE), {"burst_rows": 8}), ((64, LANE), {"num_engines": 0}),
    ((64, LANE), {"burst_beats": 0})])
def test_kernel_checks_keep_the_reference_texts(kernel, bad, kw):
    args = dict(grid_txns=8, num_engines=2, burst_beats=1)
    args.update(kw)
    if kernel == "contend":
        ref_fn, fn = ref_contend_read, rst_contend_read
        operand = [1, 4, 0, 8, args["num_engines"], args["burst_beats"]]
    else:
        ref_fn, fn = ref_mix_read, rst_contend_mix_read
        operand = [[2, args["burst_beats"], 0, 0], [1, 4, 0, 8],
                   [1, 4, 4, 8]]
    with pytest.raises(ValueError) as want:
        ref_fn(jnp.array(operand, jnp.int32), jnp.zeros(bad, jnp.float32),
               **args)
    with pytest.raises(ValueError) as got:
        fn(torch.tensor(operand, dtype=torch.int32), torch.zeros(bad),
           **args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad,burst_rows", [((64, 64), 8),
                                            ((64, LANE), 12),
                                            ((60, LANE), 8)])
def test_read_buffer_checks_keep_the_reference_texts(bad, burst_rows):
    """The buffer checks the contention kernels share with the read
    engine (`rst_read.check_buffer`) raise the reference read kernel's
    texts too."""
    with pytest.raises(ValueError) as want:
        ref_read(jnp.array([1, 4, 0, 8], jnp.int32),
                 jnp.zeros(bad, jnp.float32), grid_txns=8,
                 burst_rows=burst_rows)
    with pytest.raises(ValueError) as got:
        rst_read(torch.tensor([1, 4, 0, 8], dtype=torch.int32),
                 torch.zeros(bad), grid_txns=8, burst_rows=burst_rows)
    assert str(got.value) == str(want.value)


def test_mix_table_shape_keeps_the_reference_text():
    table = [[3, 1, 0, 0], [1, 4, 0, 8], [1, 4, 4, 8]]
    with pytest.raises(ValueError) as want:
        ref_mix_read(jnp.array(table, jnp.int32),
                     jnp.zeros((64, LANE), jnp.float32), grid_txns=8,
                     num_engines=3)
    with pytest.raises(ValueError) as got:
        rst_contend_mix_read(torch.tensor(table, dtype=torch.int32),
                             torch.zeros((64, LANE)), grid_txns=8,
                             num_engines=3)
    assert str(got.value) == str(want.value)


def test_windows_past_the_buffer_are_refused():
    """The TPU's index maps cannot leave the buffer; the card's kernels
    could, so the wrappers refuse before a launch."""
    buf = torch.zeros((64, LANE))
    with pytest.raises(ValueError, match="past the buffer"):
        rst_contend_read(torch.tensor([1, 4, 0, 8, 3, 1]), buf,
                         grid_txns=8, num_engines=3)
    with pytest.raises(ValueError, match="past the buffer"):
        rst_contend_mix_read(torch.tensor([[2, 1, 0, 0], [1, 4, 0, 8],
                                           [1, 4, 6, 8]]), buf,
                             grid_txns=8, num_engines=2)
    with pytest.raises(ValueError, match="launch"):
        rst_contend_read(torch.tensor([1, 4, 0, 8, 2, 1]), buf,
                         grid_txns=8, num_engines=2, burst_beats=2)


def test_cpu_tensors_run_the_plain_versions():
    buf = torch.arange(64 * LANE, dtype=torch.float32).reshape(64, LANE)
    params = torch.tensor([3, 4, 0, 7, 2, 2], dtype=torch.int32)
    table = torch.tensor([[2, 2, 0, 0], [3, 4, 0, 7], [1, 4, 4, 5]],
                         dtype=torch.int32)
    kw = dict(grid_txns=8, num_engines=2, burst_beats=2)
    before = (rst_contend_read.launches, rst_contend_mix_read.launches)
    assert torch.equal(rst_contend_read(params, buf, **kw),
                       rst_contend_read_plain(params, buf, **kw))
    assert torch.equal(rst_contend_mix_read(table, buf, **kw),
                       rst_contend_mix_read_plain(table, buf, **kw))
    assert (rst_contend_read.launches,
            rst_contend_mix_read.launches) == before


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("num_engines", [1, 2, 3, 4])
def test_contended_checksum_matches_reference(num_engines):
    kw = dict(n=12, b=TILE, s=2 * TILE, w=8 * TILE)
    port_p, ref_p = _params(**kw)
    got = ops.measure_contended_bandwidth(port_p, num_engines=num_engines,
                                          grid_txns=16, device="cpu")
    want = ref_ops.measure_contended_bandwidth(ref_p, num_engines=num_engines,
                                               grid_txns=16)
    assert got.bytes_moved == want.bytes_moved == num_engines * 12 * TILE
    assert got.seconds > 0
    np.testing.assert_allclose(got.checksum, np.asarray(want.checksum),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("arbitration,burst_beats,num_engines,grid", [
    ("burst", 2, 2, 16), ("burst", 4, 3, 16), ("burst", 8, 2, 16),
    ("burst", 10 ** 9, 2, 16), ("exclusive", 1, 2, 16),
    ("round_robin", 1, 3, None), ("exclusive", 1, 3, None)])
def test_arbitrations_match_reference(arbitration, burst_beats, num_engines,
                                      grid):
    kw = dict(n=11, b=TILE, s=2 * TILE, w=8 * TILE, a=2 * TILE)
    port_p, ref_p = _params(**kw)
    args = dict(num_engines=num_engines, arbitration=arbitration,
                burst_beats=burst_beats, grid_txns=grid)
    got = ops.measure_contended_bandwidth(port_p, device="cpu", **args)
    want = ref_ops.measure_contended_bandwidth(ref_p, **args)
    assert got.bytes_moved == want.bytes_moved
    np.testing.assert_allclose(got.checksum, np.asarray(want.checksum),
                               rtol=1e-5, atol=1e-4)


def test_single_engine_matches_read_engine():
    p = RSTParams(n=9, b=TILE, s=2 * TILE, w=16 * TILE)
    cont = ops.measure_contended_bandwidth(p, num_engines=1, device="cpu")
    read = ops.measure_read_bandwidth(p, device="cpu")
    np.testing.assert_array_equal(cont.checksum, read.checksum)
    assert cont.bytes_moved == read.bytes_moved


@pytest.mark.parametrize("arbitration,burst_beats",
                         [("round_robin", 1), ("burst", 4), ("exclusive", 1)])
def test_mix_measurement_matches_reference(arbitration, burst_beats):
    port_mix, ref_mix = _mixes([
        (dict(n=12, b=TILE, s=2 * TILE, w=8 * TILE), "read"),
        (dict(n=9, b=TILE, s=TILE, w=4 * TILE), "read"),
        (dict(n=16, b=TILE, s=8 * TILE, w=16 * TILE), "read")])
    args = dict(arbitration=arbitration, burst_beats=burst_beats,
                grid_txns=16)
    got = ops.measure_contended_mix_bandwidth(port_mix, device="cpu", **args)
    want = ref_ops.measure_contended_mix_bandwidth(ref_mix, **args)
    assert got.bytes_moved == want.bytes_moved
    np.testing.assert_allclose(got.checksum, np.asarray(want.checksum),
                               rtol=1e-5, atol=1e-4)
    buf = ops.make_mix_working_buffer(port_mix, torch.float32, grid_txns=16,
                                      device="cpu")
    ref_buf = ref_ops.make_mix_working_buffer(ref_mix, jnp.float32,
                                              grid_txns=16)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(ref_buf))


def test_uniform_mix_delegates_bit_identically():
    p = RSTParams(n=12, b=TILE, s=2 * TILE, w=8 * TILE)
    via_mix = ops.measure_contended_mix_bandwidth(
        EngineMix.of([(p, "read")] * 3), grid_txns=16, device="cpu")
    homo = ops.measure_contended_bandwidth(p, num_engines=3, grid_txns=16,
                                           device="cpu")
    assert np.array_equal(via_mix.checksum, homo.checksum)
    assert via_mix.bytes_moved == homo.bytes_moved


@pytest.mark.parametrize("num_engines,burst_beats,grid,a_tiles", [
    (4, 2, None, 0), (3, 1, 16, 2), (1, 5, 8, 1)])
def test_contended_operand_matches_reference(num_engines, burst_beats, grid,
                                             a_tiles):
    kw = dict(n=16, b=TILE, s=TILE, w=16 * TILE, a=a_tiles * TILE)
    port_p, ref_p = _params(**kw)
    got = ops.contended_params_operand(port_p, num_engines, torch.float32,
                                       grid_txns=grid,
                                       burst_beats=burst_beats)
    want = ref_ops.contended_params_operand(ref_p, num_engines, jnp.float32,
                                            grid_txns=grid,
                                            burst_beats=burst_beats)
    assert got.dtype == torch.int32 and got.shape == (6,)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("entries,grid,burst_beats,layout", [
    ([(dict(n=8, b=TILE, s=2 * TILE, w=8 * TILE), "read"),
      (dict(n=6, b=TILE, s=TILE, w=4 * TILE), "read")], 16, 4,
     [[2, 4, 0, 0], [2, 8, 0, 8], [1, 4, 8, 6]]),
    ([(dict(n=40, b=TILE, s=TILE, w=8 * TILE, a=2 * TILE), "read"),
      (dict(n=9, b=TILE, s=3 * TILE, w=4 * TILE, a=TILE), "read"),
      (dict(n=5, b=TILE, s=TILE, w=2 * TILE), "read")], 32, 1, None)])
def test_mix_operand_matches_reference(entries, grid, burst_beats, layout):
    port_mix, ref_mix = _mixes(entries)
    got = ops.mix_params_operand(port_mix, torch.float32, grid_txns=grid,
                                 burst_beats=burst_beats)
    want = ref_ops.mix_params_operand(ref_mix, jnp.float32, grid_txns=grid,
                                      burst_beats=burst_beats)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()
    if layout is not None:
        assert got.tolist() == layout


@pytest.mark.parametrize("arbitration,burst_beats,grid,want", [
    ("burst", 10 ** 9, 16, 16), ("burst", 6, 16, 6), ("exclusive", 1, 16, 16),
    ("round_robin", 1, 16, 1)])
def test_grant_beats_clamped_to_grid(arbitration, burst_beats, grid, want):
    assert ops._resolve_grant_beats(arbitration, burst_beats, grid) == want
    assert ref_ops._resolve_grant_beats(arbitration, burst_beats,
                                        grid) == want


# ------------------------------------- errors, as the reference raises them


def _same_error(port_call, ref_call):
    with pytest.raises(ValueError) as want:
        ref_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == as_port_text(str(want.value))


def test_overflowing_engine_span_rejected():
    # test_operand_safety: base + N * wset_blocks > 2**31.
    port_p, ref_p = _params(n=8, b=TILE, w=1 << 30, s=TILE)
    _same_error(
        lambda: ops.contended_params_operand(port_p, 8192, torch.float32),
        lambda: ref_ops.contended_params_operand(ref_p, 8192, jnp.float32))


def test_contended_small_config_unaffected():
    p = RSTParams(n=16, b=TILE, w=16 * TILE, s=TILE)
    operand = ops.contended_params_operand(p, 4, torch.float32,
                                           burst_beats=2)
    assert operand.shape == (6,)
    assert int(operand[4]) == 4 and int(operand[5]) == 2


def test_contended_buffer_spans_base_plus_all_windows():
    kw = dict(n=8, b=TILE, w=4 * TILE, s=TILE, a=2 * TILE)
    port_p, ref_p = _params(**kw)
    buf = ops.make_working_buffer(port_p, torch.float32, num_engines=3,
                                  device="cpu")
    assert buf.shape[0] * LANE * 4 == kw["a"] + 3 * kw["w"]
    np.testing.assert_array_equal(
        buf.numpy(), np.asarray(ref_ops.make_working_buffer(
            ref_p, jnp.float32, num_engines=3)))


def test_rejects_bad_engine_count():
    port_p, ref_p = _params(n=8, b=TILE, s=TILE, w=16 * TILE)
    _same_error(
        lambda: ops.measure_contended_bandwidth(port_p, num_engines=0,
                                                device="cpu"),
        lambda: ref_ops.measure_contended_bandwidth(ref_p, num_engines=0))


@pytest.mark.parametrize("arbitration,burst_beats", [("lottery", 1),
                                                     ("round_robin", 4),
                                                     ("burst", 0)])
def test_rejects_bad_arbitration(arbitration, burst_beats):
    port_p, ref_p = _params(n=8, b=TILE, s=TILE, w=16 * TILE)
    kw = dict(num_engines=2, arbitration=arbitration,
              burst_beats=burst_beats)
    _same_error(
        lambda: ops.measure_contended_bandwidth(port_p, device="cpu", **kw),
        lambda: ref_ops.measure_contended_bandwidth(ref_p, **kw))


def test_contention_burst_must_match_tile():
    port_p, ref_p = _params(n=8, b=32, s=32, w=16 * 32)
    _same_error(
        lambda: ops.measure_contended_bandwidth(port_p, num_engines=2,
                                                device="cpu"),
        lambda: ref_ops.measure_contended_bandwidth(ref_p, num_engines=2))


def test_non_read_entries_are_routed_away():
    kw = dict(n=8, b=TILE, s=TILE, w=4 * TILE)
    port_mix, ref_mix = _mixes([(kw, "read"), (kw, "write")])
    _same_error(
        lambda: ops.measure_contended_mix_bandwidth(port_mix, device="cpu"),
        lambda: ref_ops.measure_contended_mix_bandwidth(ref_mix))
    _same_error(lambda: ops.mix_params_operand(port_mix, torch.float32),
                lambda: ref_ops.mix_params_operand(ref_mix, jnp.float32))
    port_all, ref_all = _mixes([(kw, "duplex")] * 2)
    _same_error(
        lambda: ops.measure_contended_mix_bandwidth(port_all, device="cpu"),
        lambda: ref_ops.measure_contended_mix_bandwidth(ref_all))


def test_mismatched_burst_names_the_entry():
    port_mix, ref_mix = _mixes([
        (dict(n=8, b=TILE, s=TILE, w=4 * TILE), "read"),
        (dict(n=8, b=2 * TILE, s=2 * TILE, w=16 * TILE), "read")])
    _same_error(lambda: ops.mix_params_operand(port_mix, torch.float32),
                lambda: ref_ops.mix_params_operand(ref_mix, jnp.float32))


def test_oversized_mix_entry_names_itself():
    port_mix, ref_mix = _mixes([
        (dict(n=8, b=TILE, s=TILE, w=4 * TILE), "read"),
        (dict(n=1 << 14, b=TILE, s=1 << 30, w=1 << 30), "read")])
    _same_error(lambda: ops.mix_params_operand(port_mix, torch.float32),
                lambda: ref_ops.mix_params_operand(ref_mix, jnp.float32))


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; nothing to refuse")
    p = RSTParams(n=8, b=TILE, s=TILE, w=8 * TILE)
    mix = EngineMix.of([(p, "read"), (RSTParams(n=4, b=TILE, s=TILE,
                                                w=4 * TILE), "read")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.measure_contended_bandwidth(p, num_engines=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.measure_contended_mix_bandwidth(mix)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.make_mix_working_buffer(mix, torch.float32)


# ------------------------------------------- the cuda backend, on the CPU


@pytest.fixture
def cpu_cuda_backend():
    """The registered `cuda` backend swapped for one that runs the
    kernels' plain versions on the CPU, restored afterwards."""
    original = port_core.get_backend("cuda")
    port_core.register_backend(CudaBackend(device="cpu"), override=True)
    try:
        yield
    finally:
        port_core.register_backend(original, override=True)


def _ref_pallas(p, **kw):
    return ref_core.get_backend("pallas").contended_throughput(
        ref_core.HBM, p, ref_core.get_mapping(ref_core.HBM), **kw)


@pytest.mark.parametrize("num_engines", [1, 2, 3])
@pytest.mark.parametrize("arbitration,burst_beats",
                         [("round_robin", 1), ("burst", 4), ("exclusive", 1)])
def test_sweep_contention_matches_pallas(cpu_cuda_backend, num_engines,
                                         arbitration, burst_beats):
    kw = dict(n=8, b=TILE, s=TILE, w=16 * TILE)
    port_p, ref_p = _params(**kw)
    sweep = port_core.Sweep(port_core.HBM, backend="cuda")
    sweep.add_contention(port_p, num_engines=num_engines,
                         arbitration=arbitration, burst_beats=burst_beats)
    (result,) = sweep.run()
    res = result.value
    args = dict(num_engines=num_engines, arbitration=arbitration,
                burst_beats=burst_beats)
    want = _ref_pallas(ref_p, **args)
    sample = ref_ops.measure_contended_bandwidth(ref_p, **args)
    assert (res.bound, res.num_engines, res.arbitration, res.burst_beats,
            res.mix) == (want.bound, want.num_engines, want.arbitration,
                         want.burst_beats, None) == (
        "measured", num_engines, arbitration, burst_beats, None)
    assert res.detail["bytes"] == want.detail["bytes"]
    assert np.isnan(res.queueing_delay_cycles)
    assert res.aggregate_gbps > 0
    assert res.detail["checksum"] == pytest.approx(
        float(np.sum(np.asarray(sample.checksum), dtype=np.float64)),
        rel=1e-6)


def test_sweep_mix_contention_matches_pallas(cpu_cuda_backend):
    entries = [(dict(n=8, b=TILE, s=TILE, w=4 * TILE), "read"),
               (dict(n=8, b=TILE, s=2 * TILE, w=8 * TILE), "read")]
    port_mix, ref_mix = _mixes(entries)
    sweep = port_core.Sweep(port_core.HBM, backend="cuda")
    sweep.add_contention(port_mix.entries[0][0], mix=port_mix,
                         arbitration="burst", burst_beats=2)
    (result,) = sweep.run()
    res = result.value
    want = _ref_pallas(ref_mix.entries[0][0], num_engines=2, mix=ref_mix,
                       arbitration="burst", burst_beats=2)
    sample = ref_ops.measure_contended_mix_bandwidth(
        ref_mix, arbitration="burst", burst_beats=2)
    assert res.mix == port_mix and want.mix == ref_mix
    assert (res.bound, res.num_engines) == (want.bound, want.num_engines)
    assert res.detail["bytes"] == want.detail["bytes"]
    assert res.detail["checksum"] == pytest.approx(
        float(np.sum(np.asarray(sample.checksum), dtype=np.float64)),
        rel=1e-6)


def test_contention_refusals_match_pallas(cpu_cuda_backend):
    kw = dict(n=8, b=TILE, s=TILE, w=16 * TILE)
    port_p, ref_p = _params(**kw)
    eng = port_core.Engine(channel=0, spec=port_core.HBM, backend="cuda")
    _same_error(lambda: eng.evaluate_contention(port_p, num_engines=2,
                                                op="write"),
                lambda: _ref_pallas(ref_p, num_engines=2, op="write"))
    port_mix, ref_mix = _mixes([(kw, "read"), (kw, "duplex")])
    _same_error(lambda: eng.evaluate_contention(port_p, mix=port_mix),
                lambda: _ref_pallas(ref_p, num_engines=2, mix=ref_mix))


@pytest.mark.parametrize("placement", ["same_channel", "same_switch",
                                       "cross_switch"])
@pytest.mark.parametrize("mixed", [False, True])
def test_placement_fold_matches_reference(cpu_cuda_backend, monkeypatch,
                                          placement, mixed):
    """The placement fold on the `cuda` backend: the port's per-port
    measurements, handed to the reference's fold, give the port's
    capped aggregate, bound and capacity fields."""
    kw = dict(n=8, b=TILE, s=TILE, w=8 * TILE)
    port_p, ref_p = _params(**kw)
    if mixed:
        port_mix, ref_mix = _mixes([(kw, "read"),
                                    (dict(kw, s=2 * TILE), "read")] * 2)
    else:
        port_mix = ref_mix = None
    ports = []
    measure = CudaBackend.contended_throughput

    def spy(self, *args, **kwargs):
        res = measure(self, *args, **kwargs)
        ports.append(res)
        return res

    monkeypatch.setattr(CudaBackend, "contended_throughput", spy)
    eng = port_core.Engine(channel=0, spec=port_core.HBM, backend="cuda")
    got = eng.evaluate_contention(port_p, num_engines=4, placement=placement,
                                  mix=port_mix)
    assert got.num_engines == 4 and got.placement == placement
    if placement == "same_channel":
        assert len(ports) == 1 and got.bound == "measured"
        assert got.detail["bytes"] == 4 * 8 * TILE
        return
    ref_eng = ref_core.Engine(channel=0, spec=ref_core.HBM, backend="sim")
    sw = ref_eng._switch_model()
    effective, counts = ref_core.engine.placement_port_counts(sw, placement,
                                                              4)
    by_count = {r.num_engines: r for r in ports}
    ref_ports = []
    for c in counts:
        r = ports.pop(0) if mixed else by_count[c]
        ref_ports.append((c, ref_core.ContentionResult(
            num_engines=r.num_engines, aggregate_gbps=r.aggregate_gbps,
            bound=r.bound, queueing_delay_cycles=r.queueing_delay_cycles,
            detail=dict(r.detail), arbitration=r.arbitration,
            burst_beats=r.burst_beats)))
    want = ref_combine(sw, placement, effective, 4, ref_ports,
                       arbitration="round_robin", burst_beats=1,
                       mix=ref_mix)
    assert got.aggregate_gbps == want.aggregate_gbps
    assert got.bound == want.bound
    for key in ("ports", "engines_per_port_max", "uncapped_aggregate_gbps",
                "capacity_cap_gbps", "placement_degraded"):
        assert got.detail[key] == want.detail[key], key


# ---------------------------------------------------------- the bench CLI


@pytest.mark.parametrize("flags", [
    dict(engines=4, arbitration="burst", burst=8),
    dict(engines="2r+1w+1d"), dict(arbitration="exclusive")])
def test_bench_contention_flags_match_reference(flags):
    from benchmarks import run as ref_bench
    names = ("fig9_channel_contention,arbitration_granularity_sweep,"
             "contended_latency_classes,engine_mix_sweep")
    got = bench.bench_experiments(True, names, **flags)
    want = ref_bench.bench_experiments(True, names, **flags)
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]


def test_bench_engines_argument_matches_reference():
    from benchmarks import run as ref_bench
    assert bench.engine_ladder(16) == ref_bench.engine_ladder(16)
    assert bench.engine_ladder(5) == ref_bench.engine_ladder(5) == (1, 2, 4,
                                                                     5)
    assert bench.parse_engines_arg("4") == 4
    assert bench.parse_engines_arg("2r+1w") == "2r+1w"
    for bad in ("0", "2x"):
        with pytest.raises(SystemExit) as got:
            bench.parse_engines_arg(bad)
        with pytest.raises(SystemExit) as want:
            ref_bench.parse_engines_arg(bad)
        assert str(got.value) == str(want.value).replace("benchmarks.run",
                                                         "repro_torch.bench")


@pytest.mark.parametrize("argv", [
    ["--burst", "4"], ["--arbitration", "burst", "--burst", "0"],
    ["--arbitration", "lottery"]])
def test_bench_refuses_bad_contention_flags(argv):
    with pytest.raises(SystemExit) as exc:
        bench.main(["--experiments", "fig4_refresh", *argv])
    assert exc.value.code == 2


# ------------------------------------ the card's schedule, on the host
#
# A host emulation of csrc/rst_contend.cu's schedule, step by step as the
# CUDA code advances it: CTA c indexes its steps j = c + m * C in batches
# of kBatch, streams each batch in increasing m, skips gated steps, and
# stores its partial row; then the cross-CTA sum of csrc/rst_common.cuh
# in its fixed order.  Held
# against the plain versions: exactly on small integers (every partial
# sum stays below 2**24, so no order of the float32 adds rounds), within
# rtol 1e-5 on normal floats (the kernel adds in another order than the
# plain version's single sum).  The constants are read from the sources.

SMS = 132  # the H100 SXM's SMs, for the launch geometry
CSRC = Path(rst_contend_module.__file__).parent / "csrc"


def _cuda_constant(name):
    """The value of `constexpr int <name> = <value>;` in csrc/."""
    for path in sorted(CSRC.glob("*.cu*")):
        found = re.search(rf"constexpr int {name} = ([^;]+);",
                          path.read_text())
        if found:
            return eval(found.group(1), {},  # e.g. "32 * kSumWarps"
                        {k: _cuda_constant(k) for k in
                         re.findall(r"k[A-Z]\w*", found.group(1))})
    raise KeyError(name)


def _uniform_tile(stride, wset, base, n, engines, bb):
    """UniformEngines::tile: the tile of merged step j, None if gated."""
    def tile(j):
        g, r = divmod(j, bb * engines)
        k, rr = divmod(r, bb)
        t = g * bb + rr
        return None if t >= n else base + k * wset + (t * stride) % wset
    return tile


def _mix_tile(rows, bb):
    """MixEngines::tile over the table's engine rows."""
    def tile(j):
        g, r = divmod(j, bb * len(rows))
        k, rr = divmod(r, bb)
        t = g * bb + rr
        stride, wset, base, n = rows[k]
        return None if t >= n else base + (t * stride) % wset
    return tile


def _cross_cta_sum(partial):
    """rst_sum_kernel's fixed order (tests/test_torch_kernels.py holds it
    against an exact sum): lane l of warp w sums rows [s * per, (s + 1) *
    per), s = w * 32 + l, from 0.0; shuffle-down offsets 16 .. 1 fold each
    warp; the warps' sums are added in warp order from 0.0."""
    warps = _cuda_constant("kSumWarps")
    rows = len(partial)
    per = -(-rows // (32 * warps))
    total = np.zeros(partial.shape[1], np.float32)
    for w in range(warps):
        lanes = np.zeros((32, partial.shape[1]), np.float32)
        for lane in range(32):
            first = min(rows, (w * 32 + lane) * per)
            for row in partial[first:min(rows, first + per)]:
                lanes[lane] = lanes[lane] + row
        for offset in (16, 8, 4, 2, 1):
            source = [lane + offset if lane + offset < 32 else lane
                      for lane in range(32)]
            lanes = lanes + lanes[source]
        total = total + lanes[0]
    return total


def _emulate_contend(tiles, tile_of, steps, ctas):
    """contend_partial and the cross-CTA sum.  Returns the sum and, per
    CTA, its batches of steps in order and the tiles it loaded."""
    batch_size = _cuda_constant("kBatch")
    partial = np.zeros((ctas, tiles.shape[1]), np.float32)
    taken, loaded = [], []
    for c in range(ctas):
        mine = -(-(steps - c) // ctas) if steps > c else 0
        batches, ts = [], []
        for m0 in range(0, mine, batch_size):
            js = [c + m * ctas for m in range(m0, min(m0 + batch_size, mine))]
            index = [tile_of(j) for j in js]   # one thread a step
            for t in index:
                if t is not None:               # a gated step loads nothing
                    partial[c] = partial[c] + tiles[t]
                    ts.append(t)
            batches.append(js)
        taken.append(batches)
        loaded.append(ts)
    return _cross_cta_sum(partial), taken, loaded


def _host_buffer(rows, values, seed):
    rng = np.random.default_rng(seed)
    shape = (rows, LANE)
    return (rng.integers(0, 4, shape) if values == "integers"
            else rng.standard_normal(shape)).astype(np.float32)


# (stride, wset, base, n, engines, bb, grid, ctas): n below the CTA count;
# revisits (n > W/S); stride a multiple of wset; more than one index
# batch per CTA with a ragged last batch and a step count that is not a
# multiple of the unroll (8); gated steps (n < grid); grants of 1, 16 and
# n beats; and the main path's CTA count at a size the host can replay.
CONTEND_SCHEDULES = [
    (1, 8, 0, 5, 2, 1, 8, 528), (3, 8, 0, 40, 2, 1, 40, 7),
    (8, 8, 1, 13, 3, 16, 16, 5), (1, 512, 0, 701, 2, 1, 701, 3),
    (1, 64, 0, 50, 3, 16, 64, 5), (2, 64, 2, 60, 4, 60, 60, 9),
    (1, 16, 0, 16, 4, 16, 16, 1), (5, 32, 0, 45, 3, 45, 45, 40),
    (1, 1024, 0, 1024, 4, 1, 1024, grid_shape(4096, 256, SMS)[0])]


@pytest.mark.parametrize("values", ["integers", "normal"])
@pytest.mark.parametrize("case", CONTEND_SCHEDULES, ids=str)
def test_contend_schedule_matches_plain(values, case):
    stride, wset, base, n, engines, bb, grid, ctas = case
    host = _host_buffer((base + engines * wset) * 8, values, seed=n)
    params = torch.tensor([stride, wset, base, n, engines, bb],
                          dtype=torch.int32)
    kw = dict(grid_txns=grid, num_engines=engines, burst_beats=bb)
    steps = total_steps(grid, engines, bb)
    got, taken, loaded = _emulate_contend(
        host.reshape(-1, 8 * LANE),
        _uniform_tile(stride, wset, base, n, engines, bb), steps, ctas)
    # CTA c takes j = c, c + C, ... in increasing order, in batches of at
    # most kBatch steps; together the CTAs take every step once, and load
    # every tile the plain version reads.
    for c, batches in enumerate(taken):
        assert sum(batches, []) == list(range(c, steps, ctas))
        assert all(len(b) == _cuda_constant("kBatch") for b in batches[:-1])
    tiles = host.shape[0] // 8
    want_idx = contend_tile_indices(params, tiles, device="cpu", **kw)
    assert sorted(t for ts in loaded for t in ts) == sorted(
        want_idx.tolist())
    want = rst_contend_read_plain(params, torch.from_numpy(host), **kw)
    want = want.reshape(-1).numpy()
    if values == "integers":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("values", ["integers", "normal"])
@pytest.mark.parametrize("case", MIX_CASES[:4], ids=str)
@pytest.mark.parametrize("ctas", [1, 5, 40])
def test_mix_schedule_matches_plain(values, case, ctas):
    rows, bb, grid = case
    span = max(base + wset for _, wset, base, _ in rows)
    host = _host_buffer(span * 8, values, seed=ctas)
    table = torch.tensor([[len(rows), bb, 0, 0]] + rows, dtype=torch.int32)
    kw = dict(grid_txns=grid, num_engines=len(rows), burst_beats=bb)
    got = _emulate_contend(host.reshape(-1, 8 * LANE), _mix_tile(rows, bb),
                           total_steps(grid, len(rows), bb), ctas)[0]
    want = rst_contend_mix_read_plain(table, torch.from_numpy(host), **kw)
    want = want.reshape(-1).numpy()
    if values == "integers":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_oversized_mix_table_is_refused():
    """A mix whose table cannot fit a CTA's shared memory is refused with
    the sizes, before the launch."""
    engines = (SHARED_MEMORY_LIMIT - shared_memory_bytes()) // 16
    with pytest.raises(ValueError, match=f"{engines} engines needs"):
        check_shared_memory(engines)
    check_shared_memory(engines - 1)


# ------------------------------------------------------- on the card only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_contend_kernels_match_plain(cuda_device, dtype):
    _, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    for burst_rows, stride, wset, base, n, engines, bb, grid in CONTEND_CASES:
        buf = torch.from_numpy(rng.standard_normal(
            ((base + engines * wset) * burst_rows, LANE)).astype(
                np.float32)).to(tdt).to(cuda_device)
        params = torch.tensor([stride, wset, base, n, engines, bb],
                              dtype=torch.int32)
        kw = dict(grid_txns=grid, num_engines=engines, burst_beats=bb,
                  burst_rows=burst_rows)
        before = rst_contend_read.launches
        got = rst_contend_read(params, buf, **kw)
        assert rst_contend_read.launches == before + 1
        want = rst_contend_read_plain(params, buf, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=_rtol(dtype), atol=1e-4)
    for rows, bb, grid in MIX_CASES:
        span = max(base + wset for _, wset, base, _ in rows)
        buf = torch.from_numpy(rng.standard_normal(
            (span * 8, LANE)).astype(np.float32)).to(tdt).to(cuda_device)
        table = torch.tensor([[len(rows), bb, 0, 0]] + rows,
                             dtype=torch.int32)
        kw = dict(grid_txns=grid, num_engines=len(rows), burst_beats=bb)
        got = rst_contend_mix_read(table, buf, **kw)
        want = rst_contend_mix_read_plain(table, buf, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=_rtol(dtype), atol=1e-4)


@pytest.mark.cuda
def test_cuda_single_engine_matches_read_kernel(cuda_device):
    p = RSTParams(n=4096, b=TILE, s=TILE, w=4096 * TILE)
    buf = ops.make_working_buffer(p, torch.float32)
    contended = rst_contend_read(
        ops.contended_params_operand(p, 1, torch.float32), buf,
        grid_txns=p.n, num_engines=1)
    read = rst_read(ops.params_operand(p, torch.float32), buf, grid_txns=p.n)
    assert torch.equal(contended, read)


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["integers", "normal"])
def test_cuda_contend_schedules_match_plain(cuda_device, values):
    """The host-emulated schedules on the card, through the library at
    their CTA counts: exactly on small integers, to rtol 1e-5 on normal
    floats."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rst_read import DTYPE_CODES, sum_scratch

    for case in CONTEND_SCHEDULES:
        stride, wset, base, n, engines, bb, grid, ctas = case
        host = _host_buffer((base + engines * wset) * 8, values, seed=n)
        buf = torch.from_numpy(host).to(cuda_device)
        params = torch.tensor([stride, wset, base, n, engines, bb],
                              dtype=torch.int32)
        partial, out = sum_scratch(buf, ctas, 8)
        _build.check(_build.library().rst_contend_read_launch(
            buf.device.index, buf.data_ptr(), DTYPE_CODES[buf.dtype],
            8 * LANE * 4, stride, wset, base, n, engines, bb,
            total_steps(grid, engines, bb), ctas, 256, partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "rst_contend_read")
        want = rst_contend_read_plain(params, buf, grid_txns=grid,
                                      num_engines=engines, burst_beats=bb)
        torch.cuda.synchronize()
        if values == "integers":
            assert torch.equal(out, want), case
        else:
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
