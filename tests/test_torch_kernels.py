"""The port's RST engines (repro_torch.kernels) against the reference's
Pallas kernels in interpret mode, at the reference tests' tolerances.

On the CPU the port's wrappers run their plain PyTorch versions; the
tests marked `cuda` hold the CUDA kernels against those plain versions
and skip where there is no card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RSTParams as RefParams
from repro.kernels import ops as ref_ops
from repro.kernels.rst_read import rst_read as ref_rst_read
from repro.kernels.rst_write import rst_write as ref_rst_write
from repro_torch.core import RSTParams
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rst_read_checksum_ref
from repro_torch.kernels.rst_read import LANE, rst_read, rst_read_plain
from repro_torch.kernels.rst_write import rst_write, rst_write_plain

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
TILE = 8 * LANE * 4  # burst_rows=8, float32

READ_CASES = [
    (8, 1, 8, 8),      # pure sequential, one pass
    (8, 1, 8, 20),     # wraps the working set
    (8, 2, 16, 16),    # strided
    (8, 4, 8, 9),      # stride wraps within W
    (16, 1, 4, 7),     # bigger burst
    (8, 8, 8, 5),      # stride == W: hammer one tile
]
WRITE_CASES = [
    (8, 1, 8, 8, 0),
    (8, 3, 8, 12, 0),    # revisits: last write wins
    (8, 2, 8, 3, 2),     # nonzero base, partial coverage
    (16, 1, 6, 4, 1),
]


def _mk(rows, jdtype, seed=0):
    """tests/kernels/test_rst_kernels.py::_mk: the same numpy input for
    both packages, returned as the reference's array."""
    rng = np.random.default_rng(seed)
    if jnp.dtype(jdtype) == jnp.int8:
        x = rng.integers(-4, 5, size=(rows, LANE), dtype=np.int8)
    else:
        x = rng.standard_normal((rows, LANE)).astype(np.float32)
    return jnp.asarray(x, dtype=jdtype)


def _port(buf_jnp, params):
    return ops.from_reference(np.asarray(buf_jnp), np.asarray(params),
                              device="cpu")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("burst_rows,stride,wset,n", READ_CASES)
def test_read_matches_pallas(dtype, burst_rows, stride, wset, n):
    jdt, tdt = DTYPES[dtype]
    buf = _mk(wset * burst_rows, jdt)
    params = jnp.array([stride, wset, 0, n], jnp.int32)
    want = ref_rst_read(params, buf, grid_txns=max(n, 4),
                        burst_rows=burst_rows)
    tbuf, tparams = _port(buf, params)
    assert tbuf.dtype == tdt
    got = rst_read(tparams, tbuf, grid_txns=max(n, 4), burst_rows=burst_rows)
    assert got.dtype == torch.float32 and got.shape == (burst_rows, LANE)
    rtol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("burst_rows,stride,wset,n,base", WRITE_CASES)
def test_write_matches_pallas(dtype, burst_rows, stride, wset, n, base):
    jdt, _ = DTYPES[dtype]
    buf = _mk((base + wset) * burst_rows, jdt, seed=1)
    params = jnp.array([stride, wset, base, n], jnp.int32)
    tbuf, tparams = _port(buf, params)
    want = np.asarray(ref_rst_write(params, jnp.array(buf),
                                    grid_txns=max(n, 4),
                                    burst_rows=burst_rows))
    got = rst_write(tparams, tbuf, grid_txns=max(n, 4), burst_rows=burst_rows)
    assert got is tbuf     # in place
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("stride,wset,n", [
    (s, w, n) for w in (2, 4, 16) for s in (1, 2, 8) if s <= w
    for n in (1, 5, 33)])
def test_read_stream_grid(stride, wset, n):
    """The reference's property test, as a fixed grid."""
    buf = _mk(wset * 8, jnp.float32, seed=42)
    params = jnp.array([stride, wset, 0, n], jnp.int32)
    want = ref_rst_read(params, buf, grid_txns=64, burst_rows=8)
    got = rst_read(*reversed(_port(buf, params)), grid_txns=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_n_beyond_grid_is_clamped():
    buf = _mk(8 * 8, jnp.float32)
    params = jnp.array([1, 8, 0, 99], jnp.int32)
    want = ref_rst_read(params, buf, grid_txns=16)
    tbuf, tparams = _port(buf, params)
    got = rst_read(tparams, tbuf, grid_txns=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), rst_read_checksum_ref(np.asarray(buf), 1, 8, 0, 16, 8),
        rtol=1e-5)


def test_write_beyond_grid_is_clamped():
    buf = _mk(8 * 8, jnp.float32)
    params = jnp.array([3, 8, 0, 99], jnp.int32)
    tbuf, tparams = _port(buf, params)
    want = np.asarray(ref_rst_write(params, jnp.array(buf), grid_txns=16))
    np.testing.assert_array_equal(rst_write(tparams, tbuf, grid_txns=16),
                                  want)


def test_wrappers_reject_bad_buffers():
    buf = torch.zeros((64, LANE))
    params = torch.tensor([1, 8, 0, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="minor dim|rows, 128"):
        rst_read(params, torch.zeros((64, 64)), grid_txns=8)
    with pytest.raises(ValueError, match="burst_rows"):
        rst_read(params, buf, grid_txns=8, burst_rows=12)
    with pytest.raises(ValueError, match="exceeds the buffer"):
        rst_read(torch.tensor([1, 16, 0, 8]), buf, grid_txns=8)
    with pytest.raises(ValueError, match="dtype"):
        rst_write(params, buf.to(torch.int8), grid_txns=8)
    with pytest.raises(ValueError, match="contiguous"):
        rst_read(params, torch.zeros((LANE, 64)).t(), grid_txns=8)


def test_cpu_tensors_run_the_plain_versions():
    """The wrappers take the plain version for a CPU tensor and count no
    kernel launch."""
    buf = torch.arange(64 * LANE, dtype=torch.float32).reshape(64, LANE)
    params = torch.tensor([3, 8, 0, 12], dtype=torch.int32)
    before = (rst_read.launches, rst_write.launches)
    assert torch.equal(rst_read(params, buf, grid_txns=16),
                       rst_read_plain(params, buf, grid_txns=16))
    assert torch.equal(rst_write(params, buf.clone(), grid_txns=16),
                       rst_write_plain(params, buf.clone(), grid_txns=16))
    assert (rst_read.launches, rst_write.launches) == before


# -------------------------------------------------------------------- ops


def test_grid_bucketing_matches_reference():
    for n in (1, 16, 17, 1024, 1025):
        assert ops.grid_bucket(n) == ref_ops.grid_bucket(n)
        assert ops.default_grid(n, torch.device("cpu")) == \
            ref_ops.default_grid(n, interpret=True)
        assert ops.default_grid(n, torch.device("cuda")) == \
            ref_ops.default_grid(n, interpret=False)
    with pytest.raises(ValueError):
        ops.grid_bucket(0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tile_bytes_and_operands_match(dtype):
    jdt, tdt = DTYPES[dtype]
    for burst_rows in (8, 16):
        tb = ops.tile_bytes(tdt, burst_rows)
        assert tb == ref_ops.tile_bytes(jdt, burst_rows)
        for s_tiles, w_tiles, a_tiles, n, grid in (
                (1, 16, 0, 16, None), (2, 8, 4, 12, 16), (4, 64, 1, 99, 32)):
            kw = dict(n=n, b=tb, s=tb * s_tiles, w=tb * w_tiles,
                      a=tb * a_tiles)
            got = ops.params_operand(RSTParams(**kw), tdt, burst_rows, grid)
            want = ref_ops.params_operand(RefParams(**kw), jdt, burst_rows,
                                          grid)
            assert got.dtype == torch.int32
            assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("measure", ["read", "write", "duplex"])
@pytest.mark.parametrize("n,s_tiles,w_tiles,a_tiles,grid", [
    (16, 1, 16, 0, None), (13, 2, 16, 0, None), (8, 2, 16, 0, None),
    (12, 2, 8, 4, 16), (40, 4, 8, 0, 32)])
def test_measurements_match_reference(measure, n, s_tiles, w_tiles, a_tiles,
                                      grid):
    """Checksums and bytes of measure_{read,write,duplex}_bandwidth against
    the reference's: bytes and checksums, never seconds (the reference
    times its first, compiling call)."""
    kw = dict(n=n, b=TILE, s=TILE * s_tiles, w=TILE * w_tiles,
              a=TILE * a_tiles)
    got = getattr(ops, f"measure_{measure}_bandwidth")(
        RSTParams(**kw), grid_txns=grid, device="cpu")
    want = getattr(ref_ops, f"measure_{measure}_bandwidth")(
        RefParams(**kw), grid_txns=grid)
    assert got.bytes_moved == want.bytes_moved
    assert got.seconds > 0 and got.gbps > 0
    np.testing.assert_allclose(got.checksum, np.asarray(want.checksum),
                               rtol=1e-5, atol=1e-4)


# ------------------------------------------- tests/kernels/test_operand_safety


class TestInt32OverflowGuard:
    def test_small_operands_unaffected(self):
        p = RSTParams(n=16, b=TILE, w=16 * TILE, s=TILE)
        operand = ops.params_operand(p, torch.float32)
        assert operand.dtype == torch.int32
        assert operand.shape == (4,)

    def test_overflowing_product_rejected(self):
        kw = dict(n=1 << 14, b=TILE, w=1 << 30, s=1 << 30)
        with pytest.raises(ValueError, match="int32") as got:
            ops.params_operand(RSTParams(**kw), torch.float32)
        with pytest.raises(ValueError) as want:
            ref_ops.params_operand(RefParams(**kw), jnp.float32)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("num_engines,raises", [(8192, True),
                                                    (4, False)])
    def test_engine_span_guard(self, num_engines, raises):
        # The reference's contended_params_operand cases: the guard on the
        # N disjoint windows (base + N * wset blocks).
        kw = dict(n=8 if raises else 16, b=TILE,
                  w=(1 << 30) if raises else 16 * TILE, s=TILE)
        from repro.core.rst import block_params as ref_block_params
        terms = ref_block_params(RefParams(**kw), TILE)
        args = (*terms, kw["n"])
        if not raises:
            ops._require_int32_index_range(*args, num_engines=num_engines)
            ref_ops.contended_params_operand(RefParams(**kw), num_engines,
                                             jnp.float32)
            return
        with pytest.raises(ValueError, match="int32") as got:
            ops._require_int32_index_range(*args, num_engines=num_engines)
        with pytest.raises(ValueError) as want:
            ref_ops.contended_params_operand(RefParams(**kw), num_engines,
                                             jnp.float32)
        assert str(got.value) == str(want.value)

    def test_grid_clamp_keeps_large_n_packable(self):
        p = RSTParams(n=1 << 14, b=TILE, w=1 << 30, s=1 << 30)
        operand = ops.params_operand(p, torch.float32, grid_txns=64)
        assert int(operand[3]) == 64

    def test_burst_must_match_tile(self):
        with pytest.raises(ValueError, match="tile"):
            ops.params_operand(RSTParams(n=8, b=64, s=4096, w=16 * 4096),
                               torch.float32)


class TestWorkingBufferCoversBase:
    @pytest.mark.parametrize("a_tiles,w_tiles,engines", [
        (2, 8, 1), (2, 4, 3), (0, 8, 1)])
    def test_buffer_matches_reference(self, a_tiles, w_tiles, engines):
        kw = dict(n=8, b=TILE, w=w_tiles * TILE, s=TILE, a=a_tiles * TILE)
        got = ops.make_working_buffer(RSTParams(**kw), torch.float32,
                                      num_engines=engines, device="cpu")
        want = ref_ops.make_working_buffer(RefParams(**kw), jnp.float32,
                                           num_engines=engines)
        assert got.shape[0] * LANE * 4 == kw["a"] + engines * kw["w"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_buffer_above_2_24_elements_matches_reference(self, dtype):
        """Above 2**24 elements the reference's float32 index rounds to
        even, and index % 251 taken in integers no longer agrees."""
        jdt, tdt = DTYPES[dtype]
        size = tdt.itemsize
        kw = dict(n=8, b=1024 * size, s=1024 * size, w=(1 << 20) * size,
                  a=(1 << 24) * size)
        got = ops.make_working_buffer(RSTParams(**kw), tdt, device="cpu")
        want = np.asarray(ref_ops.make_working_buffer(RefParams(**kw), jdt))
        assert got.numel() == (1 << 24) + (1 << 20)
        old = (torch.arange(got.numel(), dtype=torch.int64) % 251).to(
            torch.float32).reshape(got.shape).to(tdt)
        assert not np.array_equal(old.to(torch.float32).numpy(),
                                  want.astype(np.float32))
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      want.astype(np.float32))

    def test_bfloat16_buffer_matches_reference(self):
        kw = dict(n=8, b=2048, w=8 * 2048, s=2048)
        got = ops.make_working_buffer(RSTParams(**kw), torch.bfloat16,
                                      device="cpu")
        want = ref_ops.make_working_buffer(RefParams(**kw), jnp.bfloat16)
        np.testing.assert_array_equal(
            got.to(torch.float32).numpy(),
            np.asarray(want).astype(np.float32))

    def test_read_measurement_with_nonzero_base_matches_oracle(self):
        p = RSTParams(n=12, b=TILE, w=8 * TILE, s=2 * TILE, a=4 * TILE)
        sample = ops.measure_read_bandwidth(p, grid_txns=16, device="cpu")
        buf = ops.make_working_buffer(p, torch.float32, device="cpu")
        want = rst_read_checksum_ref(buf.numpy(), 2, 8, 4, p.n, burst_rows=8)
        np.testing.assert_allclose(sample.checksum, want, rtol=1e-5)

    def test_indivisible_base_rejected(self):
        kw = dict(n=8, b=TILE, w=8 * TILE, s=TILE, a=100)
        with pytest.raises(ValueError, match="rows") as got:
            ops.make_working_buffer(RSTParams(**kw), torch.float32,
                                    device="cpu")
        with pytest.raises(ValueError) as want:
            ref_ops.make_working_buffer(RefParams(**kw), jnp.float32)
        assert str(got.value) == str(want.value)

    def test_seeded_buffer_is_reproducible(self):
        p = RSTParams(n=8, b=TILE, w=8 * TILE, s=TILE)
        a = ops.make_working_buffer(p, torch.float32,
                                    torch.Generator().manual_seed(3),
                                    device="cpu")
        b = ops.make_working_buffer(p, torch.float32,
                                    torch.Generator().manual_seed(3),
                                    device="cpu")
        assert torch.equal(a, b) and a.std() > 0.5


def test_from_reference_keeps_bfloat16_bits():
    buf = _mk(16, jnp.bfloat16)
    tbuf, operand = ops.from_reference(np.asarray(buf),
                                       np.array([1, 2, 0, 3]), device="cpu")
    assert tbuf.dtype == torch.bfloat16 and operand.dtype == torch.int32
    np.testing.assert_array_equal(tbuf.view(torch.int16).numpy(),
                                  np.asarray(buf).view(np.int16))


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; nothing to refuse")
    p = RSTParams(n=8, b=TILE, w=8 * TILE, s=TILE)
    for measure in (ops.measure_read_bandwidth, ops.measure_write_bandwidth,
                    ops.measure_duplex_bandwidth):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            measure(p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.make_working_buffer(p, torch.float32)


# ------------------------------------------------------- on the card only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_read_kernel_matches_plain(cuda_device, dtype):
    _, tdt = DTYPES[dtype]
    for burst_rows, stride, wset, n in READ_CASES:
        rng = np.random.default_rng(0)
        buf = torch.from_numpy(rng.standard_normal(
            (wset * burst_rows, LANE)).astype(np.float32)).to(tdt)
        buf = buf.to(cuda_device)
        params = torch.tensor([stride, wset, 0, n], dtype=torch.int32)
        before = rst_read.launches
        got = rst_read(params, buf, grid_txns=max(n, 4),
                       burst_rows=burst_rows)
        assert rst_read.launches == before + 1
        want = rst_read_plain(params, buf, grid_txns=max(n, 4),
                              burst_rows=burst_rows)
        torch.cuda.synchronize()
        rtol = 2e-2 if dtype == "bfloat16" else 1e-5
        torch.testing.assert_close(got, want, rtol=rtol, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_write_kernel_matches_plain(cuda_device, dtype):
    _, tdt = DTYPES[dtype]
    for burst_rows, stride, wset, n, base in WRITE_CASES + [(8, 3, 64, 1000,
                                                             0)]:
        buf = torch.randn(((base + wset) * burst_rows, LANE),
                          generator=torch.Generator().manual_seed(1)).to(tdt)
        buf = buf.to(cuda_device)
        params = torch.tensor([stride, wset, base, n], dtype=torch.int32)
        got = rst_write(params, buf.clone(), grid_txns=max(n, 4),
                        burst_rows=burst_rows)
        want = rst_write_plain(params, buf.clone(), grid_txns=max(n, 4),
                               burst_rows=burst_rows)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
