// Pieces shared by the RST engines of rst.cu and rst_contend.cu: the dtype
// codes of the Python wrappers, the widening of a 16-byte load into
// float32 accumulators, divisions in 32 bits where they fit, and the
// cross-CTA sum of the per-CTA partial tiles (rst_sum_kernel), launched as
// a programmatic dependent of the streaming kernel.  Everything here has
// internal linkage, so each source that includes it gets its own copy and
// the library links without clashes.

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

__device__ __forceinline__ void add4(float4* sum, float4 v) {
  sum->x += v.x;
  sum->y += v.y;
  sum->z += v.z;
  sum->w += v.w;
}

// a / b and a % b for a >= 0 and b > 0, in 32 bits when both fit them
// (always on the main paths), where a 64-bit division takes about four
// times the instructions.
__device__ __forceinline__ int64_t div_u(int64_t a, int64_t b) {
  return (a | b) >> 32 ? a / b
                       : static_cast<uint32_t>(a) / static_cast<uint32_t>(b);
}

__device__ __forceinline__ int64_t mod_u(int64_t a, int64_t b) {
  return a - div_u(a, b) * b;
}

__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

inline dim3 tile_grid(int64_t n_ctas, int64_t tile_vecs, int threads) {
  return dim3(static_cast<unsigned>(n_ctas),
              static_cast<unsigned>(ceil_div(tile_vecs, threads)));
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

// Programmatic dependent launch (Hopper): a streaming kernel lets the sum
// kernel that follows it on the stream be scheduled once all its CTAs
// have started; the sum kernel's CTAs wait in griddepcontrol.wait until
// the streaming grid has finished and its stores are visible.  The sum's
// launch then overlaps the streaming pass instead of following it.
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The cross-CTA sum: out = the sum of the `rows` partial rows, wide and in
// a fixed order.  A CTA takes kSumColumns float4 columns of the tile;
// kSumWarps warps share a column, and lane l of warp w sums the fixed
// contiguous range of rows [s * per, (s + 1) * per), s = (w % kSumWarps)
// * 32 + l, per = ceil(rows / kSumSlices), in row order from 0.  Each warp
// folds its 32 lanes with a fixed shuffle-down tree (offsets 16, 8, 4, 2,
// 1) and the column's kSumWarps warp sums are added in warp order.  So the
// result is deterministic, every load of a thread is in flight at once
// for up to 8 rows a slice, and no float atomics are used.
constexpr int kSumColumns = 2;
constexpr int kSumWarps = 4;
constexpr int kSumSlices = 32 * kSumWarps;
constexpr int kSumThreads = kSumColumns * kSumSlices;

__global__ void __launch_bounds__(kSumThreads)
    rst_sum_kernel(const float4* __restrict__ partial, int64_t quads,
                   int64_t rows, float4* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t column = static_cast<int64_t>(blockIdx.x) * kSumColumns +
                         warp / kSumWarps;
  const int64_t slice = (warp % kSumWarps) * 32 + lane;
  const int64_t per = ceil_div(rows, kSumSlices);
  const int64_t r0 = min64(rows, slice * per);
  const int64_t r1 = min64(rows, r0 + per);
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  wait_for_prerequisite();
  if (column < quads) {
    int64_t r = r0;
    for (; r + kUnroll <= r1; r += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = __ldcg(partial + (r + u) * quads + column);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add4(&sum, v[u]);
    }
    for (; r < r1; ++r) add4(&sum, __ldcg(partial + r * quads + column));
  }
#pragma unroll
  for (int offset = 16; offset >= 1; offset /= 2) {
    float4 other;
    other.x = __shfl_down_sync(0xffffffffu, sum.x, offset);
    other.y = __shfl_down_sync(0xffffffffu, sum.y, offset);
    other.z = __shfl_down_sync(0xffffffffu, sum.z, offset);
    other.w = __shfl_down_sync(0xffffffffu, sum.w, offset);
    add4(&sum, other);
  }
  __shared__ float4 warp_sums[kSumThreads / 32];
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (threadIdx.x < kSumColumns) {
    const int64_t c = static_cast<int64_t>(blockIdx.x) * kSumColumns +
                      threadIdx.x;
    if (c < quads) {
      float4 total = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kSumWarps; ++w) {
        add4(&total, warp_sums[threadIdx.x * kSumWarps + w]);
      }
      out[c] = total;
    }
  }
}

// The second pass: adds the `rows` partial tiles into `out` with
// rst_sum_kernel, launched as a programmatic dependent of the streaming
// kernel before it on `stream`; returns the cudaError_t of the launch.
inline cudaError_t launch_reduce(const float* partial, int64_t tile_elems,
                              int64_t rows, float* out,
                              cudaStream_t stream) {
  const int64_t quads = tile_elems / 4;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(ceil_div(quads, kSumColumns)));
  config.blockDim = dim3(kSumThreads);
  config.stream = stream;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, rst_sum_kernel,
                            reinterpret_cast<const float4*>(partial), quads,
                            rows, reinterpret_cast<float4*>(out));
}

}  // namespace
