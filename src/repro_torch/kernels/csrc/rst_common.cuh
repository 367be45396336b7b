// Pieces shared by the RST engines of rst.cu and rst_contend.cu: the dtype
// codes of the Python wrappers, the widening of a 16-byte load into
// float32 accumulators, and the fixed-order reduction of per-CTA partial
// tiles.  Everything here has internal linkage, so each source that
// includes it gets its own copy and the library links without clashes.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kVecBytes = 16;
constexpr int kUnroll = 8;

// dtype codes shared with the Python wrapper (rst_read.DTYPE_CODES).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;

template <typename T>
struct Vec {
  static constexpr int kElems = kVecBytes / sizeof(T);
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// acc[e] += element e of the 16-byte vector `raw`, widened to float32.
template <typename T>
__device__ void accumulate(float* acc, uint4 raw);

template <>
__device__ __forceinline__ void accumulate<float>(float* acc, uint4 raw) {
  acc[0] += __uint_as_float(raw.x);
  acc[1] += __uint_as_float(raw.y);
  acc[2] += __uint_as_float(raw.z);
  acc[3] += __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void accumulate<__nv_bfloat16>(float* acc,
                                                          uint4 raw) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // A bf16 is the high half of a float32: widen by shifting.
    acc[2 * k] += __uint_as_float(words[k] << 16);
    acc[2 * k + 1] += __uint_as_float(words[k] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void accumulate<int8_t>(float* acc, uint4 raw) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      acc[4 * k + b] += static_cast<float>(
          static_cast<int8_t>((words[k] >> (8 * b)) & 0xffu));
    }
  }
}

// Store a thread's kElems float32 sums at its vector slot v of CTA row
// `cta` of the [n_ctas, tile_elems] partial scratch.
template <typename T>
__device__ __forceinline__ void store_partial(float* partial, int64_t cta,
                                              int64_t tile_vecs, int64_t v,
                                              const float* acc) {
  constexpr int kElems = Vec<T>::kElems;
  float4* dst = reinterpret_cast<float4*>(
      partial + cta * tile_vecs * kElems + v * kElems);
#pragma unroll
  for (int q = 0; q < kElems / 4; ++q) {
    dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                         acc[4 * q + 3]);
  }
}

// out[e] = sum over CTAs c, in order, of partial[c][e].
__global__ void rst_read_reduce_kernel(const float* __restrict__ partial,
                                       int64_t tile_elems, int n_ctas,
                                       float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= tile_elems) return;
  float sum = 0.0f;
  for (int c = 0; c < n_ctas; ++c) sum += partial[c * tile_elems + e];
  out[e] = sum;
}

__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

inline dim3 tile_grid(int64_t n_ctas, int64_t tile_vecs, int threads) {
  return dim3(static_cast<unsigned>(n_ctas),
              static_cast<unsigned>(ceil_div(tile_vecs, threads)));
}

// The second pass: adds the n_ctas partial tiles into `out` in CTA order,
// then returns the cudaError_t of the launch.
inline cudaError_t launch_reduce(const float* partial, int64_t tile_elems,
                                 int n_ctas, float* out,
                                 cudaStream_t stream) {
  constexpr int kReduceThreads = 256;
  rst_read_reduce_kernel<<<static_cast<unsigned>(
                               ceil_div(tile_elems, kReduceThreads)),
                           kReduceThreads, 0, stream>>>(partial, tile_elems,
                                                        n_ctas, out);
  return cudaGetLastError();
}

}  // namespace
