// Multi-engine contention for Hopper (sm_90a): N RST read engines sharing
// the card's memory under grant arbitration, with a plain C interface
// loaded through ctypes (repro_torch/kernels/_build.py).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/rst_contend.py::rst_contend_read
//     (_rst_contend_kernel, _contend_index_map, _grant_position)
//   src/repro/kernels/rst_contend.py::rst_contend_mix_read
//     (_rst_contend_mix_kernel, _mix_index_map, _mix_grant_position)
//
// What they compute.  The N engines' streams are merged into one step
// sequence j in [0, steps), steps = ceil(grid / bb) * bb * N.  Rotation
// g = j / (bb * N) hands every engine a grant of bb consecutive beats:
// within it, engine k = r / bb (r = j % (bb * N)) issues its transaction
// t = g * bb + r % bb.  Round robin is bb = 1, an exclusive grant bb = the
// whole stream.  Step j reads the tile
//   base + k * wset + (t * stride) % wset              (rst_contend_read)
//   base_k + (t * stride_k) % wset_k                   (rst_contend_mix_read)
// unless t >= n (n_k for the mix): such a step is padding of the last
// grant and reads nothing.  The result is the float32 sum of every tile
// read, one (burst_rows, 128) tile.  The mix's int32[N+1][4] table holds
// the header (N, bb, 0, 0) and one (stride, wset, base, n) row per engine.
//
// What bounds them: device-memory bytes.  A run reads N * n * B bytes
// (the sum of n_k * B for the mix) with one float32 add per element, far
// below the card's arithmetic rate; four 256 MiB engines need about
// 0.32 ms at 3.35 TB/s.  What the design does about it:
//
// * The grant order is the point of the kernel: the timing model
//   analyses the issue order over j.  So the steps are dealt out round by
//   round, CTA c taking j = c, c + C, c + 2C, ... in increasing order, and
//   not in contiguous chunks as rst_read does: a chunk would lie inside
//   one engine's window, and round robin and exclusive grants would put
//   the same mix of windows in flight.  Dealt out this way, the card has a
//   run of about C * kUnroll consecutive steps in flight at any moment:
//   round robin spreads it over all N windows, an exclusive grant keeps it
//   in one.  There is no barrier across CTAs, which would measure itself.
// * Each CTA computes the tile index of its next kBatch steps once, one
//   thread a step (two 64-bit divisions and a remainder each), into
//   shared memory; then every thread streams those tiles, one 16-byte
//   slot of the tile per thread, kUnroll loads in flight, summing in
//   float32 registers.  Index arithmetic is 64-bit throughout.
// * A gated step (t >= n) is marked and skipped: it loads nothing, where
//   the TPU re-fetched the engine's last block.
// * The cross-CTA sum is rst_read's second pass over an [n_ctas, tile]
//   float32 scratch in a fixed order: deterministic, no float atomics.
// * The mix table lives in device memory and every CTA copies it into
//   shared memory at start; N is not bounded by a fixed-size struct, and
//   above 48 KB of table the launch raises the kernel's shared-memory
//   limit.

#include "rst_common.cuh"

namespace {

// Steps whose tile indices a CTA computes together before streaming them.
constexpr int kBatch = 256;
// Tile index of a step that reads nothing.
constexpr int64_t kGated = -1;

// (engine k, transaction t) of merged step j: _grant_position.
__device__ __forceinline__ void grant_position(int64_t j, int64_t engines,
                                               int64_t bb, int64_t* k,
                                               int64_t* t) {
  const int64_t per_round = bb * engines;
  const int64_t g = j / per_round;
  const int64_t r = j - g * per_round;
  *k = r / bb;
  *t = g * bb + (r - *k * bb);
}

// N engines with one (stride, wset, base, n), windows side by side.
struct UniformEngines {
  int64_t stride, wset, base, n, engines, bb;

  __device__ __forceinline__ int64_t tile(int64_t j) const {
    int64_t k, t;
    grant_position(j, engines, bb, &k, &t);
    if (t >= n) return kGated;
    return base + k * wset + (t * stride) % wset;
  }
};

// N engines with a row each of the mix table (a shared-memory copy).
struct MixEngines {
  const int* table;

  __device__ __forceinline__ int64_t tile(int64_t j) const {
    int64_t k, t;
    grant_position(j, table[0], table[1], &k, &t);
    const int* row = table + 4 * (k + 1);
    if (t >= row[3]) return kGated;
    return row[2] + (t * static_cast<int64_t>(row[0])) % row[1];
  }
};

// CTA blockIdx.x sums the tiles of steps j = blockIdx.x + m * gridDim.x at
// vector slot v = blockIdx.y * blockDim.x + threadIdx.x, in increasing j,
// into its row of `partial`.
template <typename T, typename Engines>
__device__ __forceinline__ void contend_partial(
    const uint4* __restrict__ buf, int64_t tile_vecs, int64_t steps,
    const Engines& engines, float* __restrict__ partial) {
  constexpr int kElems = Vec<T>::kElems;
  __shared__ int64_t tiles[kBatch];
  const int64_t v =
      static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  const int64_t cta = blockIdx.x;
  const int64_t ctas = gridDim.x;
  const int64_t mine = steps > cta ? ceil_div(steps - cta, ctas) : 0;

  float acc[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) acc[e] = 0.0f;

  for (int64_t m0 = 0; m0 < mine; m0 += kBatch) {
    const int batch = static_cast<int>(min64(kBatch, mine - m0));
    __syncthreads();  // every thread is done with the previous batch
    for (int s = threadIdx.x; s < batch; s += blockDim.x) {
      tiles[s] = engines.tile(cta + (m0 + s) * ctas);
    }
    __syncthreads();
    if (v >= tile_vecs) continue;
    int s = 0;
    for (; s + kUnroll <= batch; s += kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t t = tiles[s + u];
        raw[u] = t != kGated ? __ldg(buf + t * tile_vecs + v)
                             : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (tiles[s + u] != kGated) accumulate<T>(acc, raw[u]);
      }
    }
    for (; s < batch; ++s) {
      const int64_t t = tiles[s];
      if (t != kGated) accumulate<T>(acc, __ldg(buf + t * tile_vecs + v));
    }
  }
  if (v < tile_vecs) store_partial<T>(partial, cta, tile_vecs, v, acc);
}

template <typename T>
__global__ void rst_contend_partial_kernel(const uint4* __restrict__ buf,
                                           int64_t tile_vecs, int64_t steps,
                                           UniformEngines engines,
                                           float* __restrict__ partial) {
  contend_partial<T>(buf, tile_vecs, steps, engines, partial);
}

template <typename T>
__global__ void rst_contend_mix_partial_kernel(
    const uint4* __restrict__ buf, int64_t tile_vecs, int64_t steps,
    const int* __restrict__ table, int table_ints,
    float* __restrict__ partial) {
  extern __shared__ int table_smem[];
  for (int i = threadIdx.x; i < table_ints; i += blockDim.x) {
    table_smem[i] = table[i];
  }
  // contend_partial's first barrier orders these stores before any read.
  contend_partial<T>(buf, tile_vecs, steps, MixEngines{table_smem},
                     partial);
}

template <typename T>
cudaError_t launch_contend(const void* buf, int64_t tile_bytes,
                           UniformEngines engines, int64_t steps, int n_ctas,
                           int threads, float* partial, float* out,
                           cudaStream_t stream) {
  const int64_t tile_vecs = tile_bytes / kVecBytes;
  rst_contend_partial_kernel<T><<<tile_grid(n_ctas, tile_vecs, threads),
                                  threads, 0, stream>>>(
      static_cast<const uint4*>(buf), tile_vecs, steps, engines, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(partial, tile_vecs * Vec<T>::kElems, n_ctas, out,
                       stream);
}

template <typename T>
cudaError_t launch_contend_mix(const void* buf, int64_t tile_bytes,
                               const int* table, int64_t engines,
                               int64_t steps, int n_ctas, int threads,
                               float* partial, float* out,
                               cudaStream_t stream) {
  const int64_t tile_vecs = tile_bytes / kVecBytes;
  const int64_t table_ints = (engines + 1) * 4;
  const size_t smem = static_cast<size_t>(table_ints) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rst_contend_mix_partial_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rst_contend_mix_partial_kernel<T><<<tile_grid(n_ctas, tile_vecs, threads),
                                      threads, smem, stream>>>(
      static_cast<const uint4*>(buf), tile_vecs, steps, table,
      static_cast<int>(table_ints), partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(partial, tile_vecs * Vec<T>::kElems, n_ctas, out,
                       stream);
}

}  // namespace

extern "C" {

// On CUDA device `device`, sums into `out` every tile the N = `engines`
// grant-interleaved read engines read over `steps` merged steps, each
// engine with (stride, wset, base, n) and its window at base + k * wset.
// `partial` holds n_ctas tiles of float32.  Returns the cudaError_t of
// the launches (0 on success).
int rst_contend_read_launch(int device, const void* buf, int dtype,
                            int64_t tile_bytes, int64_t stride, int64_t wset,
                            int64_t base, int64_t n, int64_t engines,
                            int64_t burst_beats, int64_t steps, int n_ctas,
                            int threads, float* partial, float* out,
                            void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const UniformEngines eng{stride, wset, base, n, engines, burst_beats};
  switch (dtype) {
    case kFloat32:
      return launch_contend<float>(buf, tile_bytes, eng, steps, n_ctas,
                                   threads, partial, out, s);
    case kBFloat16:
      return launch_contend<__nv_bfloat16>(buf, tile_bytes, eng, steps,
                                           n_ctas, threads, partial, out, s);
    case kInt8:
      return launch_contend<int8_t>(buf, tile_bytes, eng, steps, n_ctas,
                                    threads, partial, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// As rst_contend_read_launch, with each engine's parameters in `table`,
// an int32[engines + 1][4] array on the device.
int rst_contend_mix_read_launch(int device, const void* buf, int dtype,
                                int64_t tile_bytes, const void* table,
                                int64_t engines, int64_t steps, int n_ctas,
                                int threads, float* partial, float* out,
                                void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  switch (dtype) {
    case kFloat32:
      return launch_contend_mix<float>(buf, tile_bytes, t, engines, steps,
                                       n_ctas, threads, partial, out, s);
    case kBFloat16:
      return launch_contend_mix<__nv_bfloat16>(buf, tile_bytes, t, engines,
                                               steps, n_ctas, threads,
                                               partial, out, s);
    case kInt8:
      return launch_contend_mix<int8_t>(buf, tile_bytes, t, engines, steps,
                                        n_ctas, threads, partial, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
