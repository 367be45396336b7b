"""The port's RST engines (repro_torch.kernels) against the reference's
Pallas kernels in interpret mode, at the reference tests' tolerances.

On the CPU the port's wrappers run their plain PyTorch versions; the
tests marked `cuda` hold the CUDA kernels against those plain versions
and skip where there is no card.
"""
import math
import re
from pathlib import Path

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
from repro_torch.kernels.rst_contend import (SHARED_MEMORY_LIMIT,
                                             shared_memory_bytes)
from repro_torch.kernels import rst_read as rst_read_module
from repro_torch.kernels.rst_read import (CTAS_PER_SM, LANE, MIN_TXNS_PER_CTA,
                                          grid_shape, rst_read,
                                          rst_read_plain, sum_scratch)
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


# ------------------------------------- the card's schedules, on the host
#
# Host emulations of csrc/rst.cu's schedules, written step by step as the
# CUDA code advances them, held against the plain versions.  The write is
# compared exactly: every store carries its tile's final payload, so the
# bytes cannot depend on which CTA stores last.  The sums are exact on
# small integers (every partial sum stays below 2**24, so no order of the
# float32 adds rounds) and within rtol 1e-5 on normal floats, which the
# kernel adds in another order than the plain version's single sum.  The
# schedules' constants are read from the CUDA sources.

SMS = 132  # the H100 SXM's SMs, for the launch geometry
CSRC = Path(rst_read_module.__file__).parent / "csrc"


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


def _emulate_write(stride, wset, base, n, tile_vecs):
    """rst_write_kernel: CTA i is transaction i; thread t of kWriteThreads
    stores the payload at vector slots t, t + kWriteThreads, ... of tile
    base + (i * stride) % wset.  Returns the stores as columns (cta,
    thread, tile, slot, payload)."""
    threads = _cuda_constant("kWriteThreads")
    period = wset // math.gcd(stride % wset, wset)
    slots = np.arange(tile_vecs)
    stores = []
    for i in range(n):
        reach, later = i * stride, n - 1 - i
        off = reach if reach < wset else (i % wset) * (stride % wset) % wset
        last = i if later < period else i + period * (later // period)
        stores.append(np.stack([np.full(tile_vecs, i), slots % threads,
                                np.full(tile_vecs, base + off), slots,
                                np.full(tile_vecs, last + 1)]))
    return np.concatenate(stores, axis=1)


# (stride, wset, base, n): n below the write CTA's thread count, n not a
# multiple of any unroll (4, 8), revisits (n > W/S), stride = 0 and
# stride a multiple of wset (one tile), a stride past the window, one
# transaction, a window the host replays at the main path's stride.
WRITE_SCHEDULES = [
    (1, 8, 0, 5), (1, 64, 2, 1001), (3, 8, 0, 100), (2, 16, 1, 77),
    (8, 8, 0, 13), (0, 4, 3, 9), (13, 8, 0, 40), (1, 8, 0, 1),
    (5, 64, 0, 130), (1, 1024, 0, 1024)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("burst_rows", [8, 64])
@pytest.mark.parametrize("stride,wset,base,n", WRITE_SCHEDULES)
def test_write_schedule_matches_plain(dtype, burst_rows, stride, wset, base,
                                      n):
    tdt = DTYPES[dtype][1]
    tile_vecs = burst_rows * LANE * tdt.itemsize // 16
    buf = torch.randn(((base + wset) * burst_rows, LANE),
                      generator=torch.Generator().manual_seed(3)).to(tdt)
    params = torch.tensor([stride, wset, base, n], dtype=torch.int32)
    cta, thread, tile, slot, payload = _emulate_write(stride, wset, base, n,
                                                      tile_vecs)
    # Every transaction stores its whole tile once: n * B bytes.
    assert len(cta) == n * tile_vecs
    assert np.unique(cta * tile_vecs + slot).size == n * tile_vecs
    assert (tile == base + (cta * stride) % wset).all()
    assert (thread < _cuda_constant("kWriteThreads")).all()
    # Applied in a seeded random order of the stores: the bytes do not
    # depend on which CTA stores last.
    got = buf.clone()
    vecs = got.view(-1, 16 // tdt.itemsize)
    order = np.random.default_rng(n).permutation(len(cta))
    values = torch.from_numpy(payload[order].astype(np.float32)).to(tdt)
    vecs[torch.from_numpy(tile[order] * tile_vecs + slot[order])] = \
        values[:, None]
    want = rst_write_plain(params, buf.clone(), grid_txns=n,
                           burst_rows=burst_rows)
    assert torch.equal(got, want)


def _cross_cta_sum(partial):
    """rst_sum_kernel's order for every column at once: lane l of warp w
    (s = w * 32 + l) sums rows [s * per, (s + 1) * per) in row order from
    0.0; each warp folds its lanes with shuffle-down offsets 16 .. 1 (a
    lane whose source is past the warp adds its own value); the warps'
    sums are added in warp order from 0.0."""
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


def _emulate_read(tiles, stride, wset, base, n, ctas):
    """rst_read_partial_kernel: CTA x sums transactions [x * chunk,
    (x + 1) * chunk) in order, (i * stride) % wset stepped by adds; then
    the cross-CTA sum."""
    chunk = -(-n // ctas) if n > 0 else 1
    step = stride % wset
    partial = np.zeros((ctas, tiles.shape[1]), np.float32)
    for x in range(ctas):
        i0, i1 = x * chunk, min(x * chunk + chunk, n)
        off = (i0 % wset) * step % wset if i0 < n else 0
        for _ in range(i0, i1):
            partial[x] = partial[x] + tiles[base + off]
            off += step
            if off >= wset:
                off -= wset
    return _cross_cta_sum(partial)


@pytest.mark.parametrize("values", ["integers", "normal"])
@pytest.mark.parametrize("stride,wset,base,n,ctas", [
    (1, 8, 0, 5, 528), (1, 64, 2, 1001, 7), (3, 8, 0, 100, 5),
    (8, 8, 0, 13, 3), (5, 64, 0, 700, 33), (1, 64, 0, 2000, 129),
    (1, 512, 0, 4000, grid_shape(4000, 256, SMS)[0]), (0, 4, 1, 9, 1),
    (1, 64, 0, 1000, 1000)])
def test_read_schedule_matches_plain(values, stride, wset, base, n, ctas):
    rng = np.random.default_rng(n)
    shape = ((base + wset) * 8, LANE)
    host = (rng.integers(0, 4, shape) if values == "integers"
            else rng.standard_normal(shape)).astype(np.float32)
    params = torch.tensor([stride, wset, base, n], dtype=torch.int32)
    got = _emulate_read(host.reshape(-1, 8 * LANE), stride, wset, base, n,
                        ctas)
    want = rst_read_plain(params, torch.from_numpy(host), grid_txns=n)
    want = want.reshape(-1).numpy()
    if values == "integers":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rows", [1, 7, 128, 129, 528, 1000, 1025])
def test_cross_cta_sum_order_is_exact_on_integers(rows):
    """The sum's fixed order gives the exact sum wherever every partial
    sum is exact, at every row count (ragged last slices, more rows than
    slices, fewer)."""
    partial = np.random.default_rng(rows).integers(
        0, 1 << 12, (rows, 16)).astype(np.float32)
    np.testing.assert_array_equal(_cross_cta_sum(partial),
                                  partial.astype(np.float64).sum(0))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("burst_rows", [8, 16, 64])
def test_launch_geometry(dtype, burst_rows):
    """Every launch the wrappers make fits a Hopper CTA, and the scratch
    covers every CTA and slice."""
    itemsize = DTYPES[dtype][1].itemsize
    tile_vecs = burst_rows * LANE * itemsize // 16
    tile_elems = burst_rows * LANE
    sum_threads = _cuda_constant("kSumThreads")
    sum_columns = _cuda_constant("kSumColumns")
    assert sum_threads <= 1024 and sum_threads % 32 == 0
    assert _cuda_constant("kWriteThreads") <= 1024
    for n in (1, 7, 16, 17, 4096, 65536, 262144):
        ctas, slices, threads = grid_shape(n, tile_vecs, SMS)
        assert 32 <= threads <= 1024 and threads % 32 == 0
        assert (slices - 1) * threads < tile_vecs <= slices * threads
        assert 1 <= ctas <= CTAS_PER_SM * SMS
        assert ctas <= -(-n // MIN_TXNS_PER_CTA)
        # The sum's grid covers every float4 column of the partial rows.
        assert -(-tile_elems // 4 // sum_columns) * sum_columns * 4 >= \
            tile_elems
    assert shared_memory_bytes() == _cuda_constant("kBatch") * 8
    assert shared_memory_bytes() <= SHARED_MEMORY_LIMIT
    assert shared_memory_bytes(1000) <= SHARED_MEMORY_LIMIT


def test_sum_scratch_sizes():
    buf = torch.zeros((64 * 8, LANE), dtype=torch.bfloat16)
    partial, out = sum_scratch(buf, 33, 16)
    assert partial.shape == (33, 16 * LANE) and partial.dtype == torch.float32
    assert out.shape == (16, LANE) and out.dtype == torch.float32


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_write_schedules_match_plain(cuda_device, dtype):
    """The host-emulated write schedules on the card, exactly."""
    _, tdt = DTYPES[dtype]
    for stride, wset, base, n in WRITE_SCHEDULES:
        for burst_rows in (8, 64):
            buf = torch.randn(((base + wset) * burst_rows, LANE),
                              generator=torch.Generator().manual_seed(3))
            buf = buf.to(tdt).to(cuda_device)
            params = torch.tensor([stride, wset, base, n], dtype=torch.int32)
            got = rst_write(params, buf.clone(), grid_txns=n,
                            burst_rows=burst_rows)
            want = rst_write_plain(params, buf.clone(), grid_txns=n,
                                   burst_rows=burst_rows)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ctas", [1, 3, 40, 528, 1000])
def test_cuda_read_at_any_cta_count_matches_plain(cuda_device, ctas):
    """The read through the library at CTA counts the wrapper never
    chooses (one CTA, more CTAs than transactions), exactly on small
    integers."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rst_read import DTYPE_CODES

    for stride, wset, base, n in [(1, 8, 0, 5), (3, 8, 0, 100),
                                  (1, 512, 0, 4000), (0, 4, 1, 9)]:
        buf = torch.randint(0, 4, ((base + wset) * 8, LANE),
                            dtype=torch.float32, device=cuda_device)
        params = torch.tensor([stride, wset, base, n], dtype=torch.int32)
        partial, out = sum_scratch(buf, ctas, 8)
        _build.check(_build.library().rst_read_launch(
            buf.device.index, buf.data_ptr(), DTYPE_CODES[buf.dtype],
            8 * LANE * 4, stride, wset, base, n, ctas, 256,
            partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "rst_read")
        want = rst_read_plain(params, buf, grid_txns=n)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
