// RST read and write engines for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (repro_torch/kernels/_build.py).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/rst_read.py::rst_read   (_rst_read_kernel, _index_map)
//   src/repro/kernels/rst_write.py::rst_write (_rst_write_kernel)
//
// What they compute (paper Eq. 1 at tile granularity): transaction i in
// [0, n) touches the tile  base + (i * stride) % wset  of a (rows, 128)
// buffer, a tile being burst_rows * 128 elements (B bytes).  The read
// engine sums every tile it reads into one float32 tile; the write engine
// fills each tile it writes with float32(i + 1) cast to the buffer's type,
// the last write of a tile winning.  n is already clamped to the reference
// grid (n = min(n, grid_txns)) by the Python wrapper.
//
// What bounds them: device-memory bytes.  The read moves n*B bytes in and
// one tile out, the write n*B bytes out; against the H100 SXM's 3.35 TB/s
// a 256 MiB traversal needs about 80 us, and the arithmetic (one add per
// element read) is far below the card's rate.  So the design has to keep
// enough 16-byte loads or stores in flight, and keep the fixed cost of a
// call (launches, ramp, the cross-CTA sum) small beside 80 us:
//
// * The read.  The TPU grid runs its steps in order on one core and
//   carries the checksum in VMEM from step to step.  Here the stream is
//   cut into contiguous chunks, one per CTA in gridDim.x (a few CTAs per
//   SM, set by the wrapper), and gridDim.y cuts a tile into slices of
//   blockDim.x 16-byte vectors.  Each thread owns one vector position of
//   the tile, accumulates it in float32 registers over its chunk
//   (converting bf16 or int8 as it loads) and keeps kUnroll independent
//   loads in flight; (i * stride) % wset advances by an add and a
//   compare.  The per-CTA partial tiles are added by rst_sum_kernel
//   (rst_common.cuh): wide, in a fixed order, launched as a programmatic
//   dependent so that its launch overlaps the stream.
// * The write is laid out as fill_ lays out its blocks: CTA i is
//   transaction i, and its kWriteThreads threads store the tile's 16-byte
//   vectors side by side, so neighbouring CTAs write neighbouring tiles
//   (at stride B) and each warp writes 512 contiguous bytes.  A CTA that
//   owned a long chunk of tiles, as the read's do, kept some 500 write
//   streams half a MiB apart and reached 88 % of the bound where fill_
//   reaches 94 %.  The CTA's index arithmetic is one remainder and one
//   quotient, in 32 bits whenever the operands fit.
// * When n exceeds the period P = wset / gcd(stride, wset), transactions
//   revisit tiles, and CTAs running in parallel would race where the
//   TPU's ordered grid made the last write win.  Every transaction i
//   therefore stores the FINAL payload of its tile,
//   1 + i + P * floor((n - 1 - i) / P) = 1 + max{j < n : T[j] = T[i]},
//   so all stores to one tile carry identical bytes and the race is
//   harmless.  The kernel still writes n*B bytes, like the TPU kernel:
//   revisits are written, not skipped.  The float32 payload is cast to
//   bf16 with round-to-nearest-even, as JAX casts it.
// * stride, wset, base and n are runtime arguments, so one binary serves
//   every RST variant (the paper's challenge C2); all index arithmetic is
//   64-bit where a product can pass 2**32.

#include "rst_common.cuh"

namespace {

// Threads of a write CTA; each stores every blockDim.x-th vector of its
// tile (two per thread for a 4 KiB tile).
constexpr int kWriteThreads = 128;

// CTA x sums transactions [x * chunk, min((x+1) * chunk, n)) at vector
// slot v = blockIdx.y * blockDim.x + threadIdx.x of the tile into row x
// of `partial`.
template <typename T>
__global__ void rst_read_partial_kernel(const uint4* __restrict__ buf,
                                        int64_t tile_vecs, int64_t stride,
                                        int64_t wset, int64_t base,
                                        int64_t n, int64_t chunk,
                                        float* __restrict__ partial) {
  constexpr int kElems = Vec<T>::kElems;
  allow_dependent_launch();
  const int64_t v =
      static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (v >= tile_vecs) return;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t i1 = min64(i0 + chunk, n);

  float acc[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) acc[e] = 0.0f;

  const int64_t step = stride % wset;
  int64_t off = i0 < n ? (i0 % wset) * step % wset : 0;
  int64_t i = i0;
  for (; i + kUnroll <= i1; i += kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      raw[u] = __ldg(buf + (base + off) * tile_vecs + v);
      off += step;
      if (off >= wset) off -= wset;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate<T>(acc, raw[u]);
  }
  for (; i < i1; ++i) {
    accumulate<T>(acc, __ldg(buf + (base + off) * tile_vecs + v));
    off += step;
    if (off >= wset) off -= wset;
  }

  store_partial<T>(partial, blockIdx.x, tile_vecs, v, acc);
}

// Sixteen bytes of `payload` converted to T.
template <typename T>
__device__ uint4 splat(float payload);

template <>
__device__ __forceinline__ uint4 splat<float>(float payload) {
  const uint32_t w = __float_as_uint(payload);
  return make_uint4(w, w, w, w);
}

template <>
__device__ __forceinline__ uint4 splat<__nv_bfloat16>(float payload) {
  const uint32_t h = static_cast<uint32_t>(
      __bfloat16_as_ushort(__float2bfloat16_rn(payload)));
  const uint32_t w = h | (h << 16);
  return make_uint4(w, w, w, w);
}

// CTA i is transaction i: its threads store the tile's final payload at
// vector slots threadIdx.x, threadIdx.x + blockDim.x, ... of tile
// base + (i * stride) % wset.  A CTA whose transaction does not wrap the
// window, or is its tile's last visit, skips that division (all of them
// on a stream with n * stride <= wset).
template <typename T>
__global__ void rst_write_kernel(uint4* __restrict__ buf, int64_t tile_vecs,
                                 int64_t stride, int64_t wset, int64_t base,
                                 int64_t n, int64_t period) {
  const int64_t i = blockIdx.x;
  const int64_t reach = i * stride;
  const int64_t off =
      reach < wset ? reach
                   : mod_u(mod_u(i, wset) * mod_u(stride, wset), wset);
  const int64_t later = n - 1 - i;
  const int64_t last =
      later < period ? i : i + period * div_u(later, period);
  const uint4 payload = splat<T>(static_cast<float>(last + 1));
  uint4* const tile = buf + (base + off) * tile_vecs;
#pragma unroll 4
  for (int64_t v = threadIdx.x; v < tile_vecs; v += blockDim.x) {
    tile[v] = payload;
  }
}

int64_t gcd64(int64_t a, int64_t b) {
  while (b != 0) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T>
cudaError_t launch_read(const void* buf, int64_t tile_bytes, int64_t stride,
                        int64_t wset, int64_t base, int64_t n, int n_ctas,
                        int threads, float* partial, float* out,
                        cudaStream_t stream) {
  const int64_t tile_vecs = tile_bytes / kVecBytes;
  const int64_t chunk = n > 0 ? ceil_div(n, n_ctas) : 1;
  rst_read_partial_kernel<T><<<tile_grid(n_ctas, tile_vecs, threads),
                               threads, 0, stream>>>(
      static_cast<const uint4*>(buf), tile_vecs, stride, wset, base, n,
      chunk, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(partial, tile_vecs * Vec<T>::kElems, n_ctas, out,
                       stream);
}

template <typename T>
cudaError_t launch_write(void* buf, int64_t tile_bytes, int64_t stride,
                         int64_t wset, int64_t base, int64_t n,
                         cudaStream_t stream) {
  const int64_t tile_vecs = tile_bytes / kVecBytes;
  const int64_t period = wset / gcd64(stride % wset, wset);
  rst_write_kernel<T><<<static_cast<unsigned>(n), kWriteThreads, 0,
                        stream>>>(static_cast<uint4*>(buf), tile_vecs,
                                  stride, wset, base, n, period);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// On CUDA device `device`, sums the n tiles of the RST read stream into
// `out` (tile_bytes / itemsize float32 values).  `partial` holds n_ctas
// times that many float32 values.  Returns the cudaError_t of the
// launches (0 on success).
int rst_read_launch(int device, const void* buf, int dtype,
                    int64_t tile_bytes, int64_t stride, int64_t wset,
                    int64_t base, int64_t n, int n_ctas, int threads,
                    float* partial, float* out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_read<float>(buf, tile_bytes, stride, wset, base, n,
                                n_ctas, threads, partial, out, s);
    case kBFloat16:
      return launch_read<__nv_bfloat16>(buf, tile_bytes, stride, wset, base,
                                        n, n_ctas, threads, partial, out, s);
    case kInt8:
      return launch_read<int8_t>(buf, tile_bytes, stride, wset, base, n,
                                 n_ctas, threads, partial, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// On CUDA device `device`, writes the n tiles of the RST write stream in
// place, one CTA a transaction.  n must be >= 1.
// Returns the cudaError_t of the launch (0 on success).
int rst_write_launch(int device, void* buf, int dtype, int64_t tile_bytes,
                     int64_t stride, int64_t wset, int64_t base, int64_t n,
                     void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_write<float>(buf, tile_bytes, stride, wset, base, n, s);
    case kBFloat16:
      return launch_write<__nv_bfloat16>(buf, tile_bytes, stride, wset, base,
                                         n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The runtime's text for a cudaError_t returned above.
const char* rst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
