// Window gather: k windows of (h, w) cut out of a device-resident
// (C, T) f32 record or ring at (k, 2) int32 origins, written as the
// (k, h, w, 1) contiguous conv input batch of the model's forward.
//
// Replaces the device program the JAX package built by hand from lax in
// dasmtl/export.py:137-165 (make_resident_forward): a vmapped
// lax.dynamic_slice over the origin rows.  dynamic_slice never faults: a
// negative start counts once from the end of its axis (start + dim, JAX's
// allow_negative_indices default), then every start is CLAMPED into
// [0, dim - size].  This kernel does the same:
//   out[j, y, x] = rec[c_j + y, t_j + x],
//   c_j = clamp(wrap(origins[j, 0], C), 0, C - h),
//   t_j = clamp(wrap(origins[j, 1], T), 0, T - w).
//
// What bounds it: bytes.  It reads k*h*w floats of the record and writes as
// many; no arithmetic beyond the index.  At the offline path's k = 256,
// 100x250 that is 51.2 MB, about 15 us at 3.35 TB/s.  Its design: one block
// per output row (j, y) -- a grid of k*h blocks -- with the threads along x,
// so that every warp reads w consecutive floats of one record row and writes
// w consecutive floats of the output: both sides coalesced whatever the
// (unaligned) time origin.  The launch goes on the caller's stream; the C
// entry point returns the cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ int64_t start_index(int64_t o, int64_t dim, int64_t size) {
  if (o < 0) o += dim;
  return o < 0 ? 0 : (o > dim - size ? dim - size : o);
}

__global__ void window_gather_kernel(const float* __restrict__ rec, int64_t C,
                                     int64_t T,
                                     const int32_t* __restrict__ origins,
                                     int h, int w, float* __restrict__ out) {
  const int64_t row = blockIdx.x;  // j * h + y
  const int64_t j = row / h;
  const int64_t y = row - j * h;
  const int64_t c0 = start_index(origins[2 * j], C, h);
  const int64_t t0 = start_index(origins[2 * j + 1], T, w);
  const float* src = rec + (c0 + y) * T + t0;
  float* dst = out + row * w;
  for (int x = threadIdx.x; x < w; x += blockDim.x) dst[x] = src[x];
}

}  // namespace

// rec is (C, T) row-major f32, origins (k, 2) int32, out (k, h, w) f32.
// Needs 1 <= h <= C and 1 <= w <= T.
extern "C" int dasmtl_window_gather(const float* rec, int64_t C, int64_t T,
                                    const int32_t* origins, int k, int h,
                                    int w, float* out, void* stream) {
  if (h < 1 || w < 1 || h > C || w > T || k < 0)
    return cudaErrorInvalidValue;
  if (k == 0) return cudaSuccess;
  const int64_t rows = static_cast<int64_t>(k) * h;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  window_gather_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      rec, C, T, origins, h, w, out);
  return cudaGetLastError();
}
