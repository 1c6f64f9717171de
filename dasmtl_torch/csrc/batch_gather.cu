// Batch gather of the device-resident training path: B rows of the whole
// training set, scaled by their plan weight, and their two labels, in ONE
// launch:
//   out_x[b, :] = x[idx[b], :] * w[b]     (B, H*W) f32
//   out_d[b]    = distance[idx[b]]        (B,) int32
//   out_e[b]    = event[idx[b]]           (B,) int32
//
// Replaces the device program the JAX package built by hand from lax in
// dasmtl/train/steps.py:200-208 (make_scan_train_step), also at :248-256
// (the CV scan) and :415-423 (make_gather_eval_step):
// jnp.take(x, idx, 0) * w[:, None, None, None] and the two label takes.
// It is a product, not a select: a padded row (w = 0) of a negative value
// comes out as -0.0 and a NaN stays NaN, bit for bit as in JAX.  Indices
// are checked on the host when the plan is built (0 <= idx < N); unlike
// jnp.take's fill mode the kernel never reads out of range: a bad index
// traps instead.
//
// What bounds it on this card: bytes, and the latency of a short launch.
// B*H*W floats read and as many written (plus 4*B*3 bytes of indices,
// weights and labels); at B = 32, 100x250 that is 6.4 MB, 1.9 us at 3.35
// TB/s, from a resident set (4,096 windows, 410 MB) far larger than the 50
// MB L2.  So little data is a few DRAM latencies long, and the launch
// between two dependent kernels weighs as much as the bytes.  The first
// design spent a third round trip too, loading w[b] only after idx[b].
// This design:
//
// - Two round trips: idx[b] and w[b] load together (w does not depend on
//   the index), then x's row; every thread of block (c, b) loads the same
//   two words, one broadcast per warp from L1, and block (0, b) writes row
//   b's labels.
// - Programmatic dependent launch (pdl.cuh): the launch overlaps the tail
//   of the kernel before it, and each block lets the next launch begin once
//   its loads are in flight.
// - One float4 per thread, 25 blocks of 256 threads per 100x250 row, all
//   resident at once at B = 32 (800 of the card's 1,056 blocks of 256):
//   every load is in flight after one scheduling pass.  Runs of 2, 4 or 8
//   float4 per thread over a grid of fewer blocks, and 128-thread blocks,
//   measured no faster on the H100 (PERF.md's findings).  A larger batch
//   keeps the grid to one wave and loops (ops/batch_gather.py:batch_plan).
// - The loads of x are evict-first (__ldcs): each row is read once an
//   epoch and should not push the step's weights and activations out of
//   L2.  The stores keep the normal policy: conv1 reads the batch straight
//   back.
// The float4 branch needs H*W % 4 == 0 and 16-byte aligned x and out_x;
// the scalar branch (one float per load, the same grid) takes the rest.
// The launch goes on the caller's stream with no synchronisation, no
// allocation and no attribute call, so a CUDA graph captures it; the C
// entry point returns the cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ int64_t checked_row(const int32_t* idx, int b,
                                               int64_t n) {
  const int32_t i = __ldg(idx + b);
  if (i < 0 || static_cast<int64_t>(i) >= n) __trap();
  return i;
}

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  v.x *= s;
  v.y *= s;
  v.z *= s;
  v.w *= s;
  return v;
}

__device__ __forceinline__ float scaled(float v, float s) { return v * s; }

// V is float4 (the vector branch) or float; `units` V's per row.
template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
    batch_gather_kernel(const V* __restrict__ x,
                        const int32_t* __restrict__ dist,
                        const int32_t* __restrict__ event, int64_t n,
                        int64_t units, const int32_t* __restrict__ idx,
                        const float* __restrict__ w, V* __restrict__ out_x,
                        int32_t* __restrict__ out_d,
                        int32_t* __restrict__ out_e) {
  const int b = blockIdx.y;
  dasmtl_pdl::wait_prior_grid();
  const float s = __ldg(w + b);
  const int64_t i = checked_row(idx, b, n);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out_d[b] = dist[i];
    out_e[b] = event[i];
  }
  const V* src = x + i * units;
  V* dst = out_x + static_cast<int64_t>(b) * units;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < units; j += stride) {
    const V v = __ldcs(src + j);
    dasmtl_pdl::allow_next_grid();
    dst[j] = scaled(v, s);
  }
}

template <typename V>
cudaError_t launch(dim3 grid, int threads, cudaStream_t s, bool pdl,
                   const float* x, const int32_t* dist, const int32_t* event,
                   int64_t n, int64_t units, const int32_t* idx,
                   const float* w, float* out_x, int32_t* out_d,
                   int32_t* out_e) {
  return dasmtl_pdl::launch_pdl(&batch_gather_kernel<V>, grid, threads, s,
                                pdl, reinterpret_cast<const V*>(x), dist,
                                event, n, units, idx, w,
                                reinterpret_cast<V*>(out_x), out_d, out_e);
}

}  // namespace

// x is (n, row) row-major f32, dist / event (n,) int32, idx (b,) int32 with
// every entry in [0, n), w (b,) f32; out_x (b, row) f32, out_d / out_e (b,)
// int32.  Needs n >= 1, row >= 1 and 0 <= b <= 65535.  The launch geometry
// comes from ops/batch_gather.py:batch_plan: `vec` the float4 branch
// (row % 4 == 0, x and out_x 16-byte aligned), `threads` per block (a
// multiple of 32, at most 256), `blocks` per row (at least 1; a
// grid-stride loop covers the rest).  `pdl` launches with programmatic
// stream serialization (pdl.cuh).
extern "C" int dasmtl_batch_gather(const float* x, const int32_t* dist,
                                   const int32_t* event, int64_t n,
                                   int64_t row, const int32_t* idx,
                                   const float* w, int b, float* out_x,
                                   int32_t* out_d, int32_t* out_e, int vec,
                                   int threads, int blocks, int pdl,
                                   void* stream) {
  if (n < 1 || row < 1 || b < 0 || b > 65535 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || blocks < 1)
    return cudaErrorInvalidValue;
  if (vec && (row % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out_x) % 16 != 0))
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(b));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    return launch<float4>(grid, threads, s, pdl, x, dist, event, n, row / 4,
                          idx, w, out_x, out_d, out_e);
  return launch<float>(grid, threads, s, pdl, x, dist, event, n, row, idx, w,
                       out_x, out_d, out_e);
}
