// The previous design of the RST kernels (csrc/, kept verbatim as the
// yardstick chip_smoke.py times the package's kernels against), with
// entry points that launch each of its two passes alone, so that a run
// can split a call's time into the streaming pass and the cross-CTA sum.
// chip_smoke.py copies this directory under build/ and compiles it there.

#include "csrc/rst.cu"
#include "csrc/rst_contend.cu"

extern "C" {

// rst_read's first pass: per-CTA partial tiles of one float32 stream.
int baseline_read_partial(const void* buf, int64_t tile_bytes, int64_t stride,
                          int64_t wset, int64_t base, int64_t n, int n_ctas,
                          int threads, float* partial, void* stream) {
  const int64_t tile_vecs = tile_bytes / kVecBytes;
  const int64_t chunk = n > 0 ? ceil_div(n, n_ctas) : 1;
  rst_read_partial_kernel<float><<<tile_grid(n_ctas, tile_vecs, threads),
                                   threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), tile_vecs, stride, wset, base, n,
      chunk, partial);
  return cudaGetLastError();
}

// rst_contend_read's first pass, float32.
int baseline_contend_partial(const void* buf, int64_t tile_bytes,
                             int64_t stride, int64_t wset, int64_t base,
                             int64_t n, int64_t engines, int64_t burst_beats,
                             int64_t steps, int n_ctas, int threads,
                             float* partial, void* stream) {
  const int64_t tile_vecs = tile_bytes / kVecBytes;
  const UniformEngines eng{stride, wset, base, n, engines, burst_beats};
  rst_contend_partial_kernel<float><<<tile_grid(n_ctas, tile_vecs, threads),
                                      threads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), tile_vecs, steps, eng, partial);
  return cudaGetLastError();
}

// The second pass both share: out = the n_ctas partial rows in CTA order.
int baseline_reduce(const float* partial, int64_t tile_elems, int n_ctas,
                    float* out, void* stream) {
  return launch_reduce(partial, tile_elems, n_ctas, out,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
