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
// What bounds it: bytes.  B*H*W floats read and as many written (plus
// 4*B*3 bytes of indices, weights and labels); at B = 32, 100x250 that is
// 6.4 MB, about 1.9 us at 3.35 TB/s.  Its design: a grid of (blocks per
// row, B); each thread moves one float4 (16-byte loads and stores, both
// sides coalesced) when H*W % 4 == 0 and both bases are 16-byte aligned,
// else one float; the first block of each row writes its labels.  The
// launch goes on the caller's stream with no synchronisation, so a CUDA
// graph captures it; the C entry point returns the cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t checked_row(const int32_t* idx, int b,
                                               int64_t n) {
  const int32_t i = idx[b];
  if (i < 0 || static_cast<int64_t>(i) >= n) __trap();
  return i;
}

__global__ void batch_gather_vec4(const float4* __restrict__ x,
                                  const int32_t* __restrict__ dist,
                                  const int32_t* __restrict__ event,
                                  int64_t n, int64_t row4,
                                  const int32_t* __restrict__ idx,
                                  const float* __restrict__ w,
                                  float4* __restrict__ out_x,
                                  int32_t* __restrict__ out_d,
                                  int32_t* __restrict__ out_e) {
  const int b = blockIdx.y;
  const int64_t i = checked_row(idx, b, n);
  const float s = w[b];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out_d[b] = dist[i];
    out_e[b] = event[i];
  }
  const float4* src = x + i * row4;
  float4* dst = out_x + static_cast<int64_t>(b) * row4;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < row4; j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float4 v = src[j];
    v.x *= s;
    v.y *= s;
    v.z *= s;
    v.w *= s;
    dst[j] = v;
  }
}

__global__ void batch_gather_scalar(const float* __restrict__ x,
                                    const int32_t* __restrict__ dist,
                                    const int32_t* __restrict__ event,
                                    int64_t n, int64_t row,
                                    const int32_t* __restrict__ idx,
                                    const float* __restrict__ w,
                                    float* __restrict__ out_x,
                                    int32_t* __restrict__ out_d,
                                    int32_t* __restrict__ out_e) {
  const int b = blockIdx.y;
  const int64_t i = checked_row(idx, b, n);
  const float s = w[b];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out_d[b] = dist[i];
    out_e[b] = event[i];
  }
  const float* src = x + i * row;
  float* dst = out_x + static_cast<int64_t>(b) * row;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < row; j += static_cast<int64_t>(gridDim.x) * blockDim.x)
    dst[j] = src[j] * s;
}

}  // namespace

// x is (n, row) row-major f32, dist / event (n,) int32, idx (b,) int32 with
// every entry in [0, n), w (b,) f32; out_x (b, row) f32, out_d / out_e (b,)
// int32.  Needs n >= 1, row >= 1 and 0 <= b <= 65535.
extern "C" int dasmtl_batch_gather(const float* x, const int32_t* dist,
                                   const int32_t* event, int64_t n,
                                   int64_t row, const int32_t* idx,
                                   const float* w, int b, float* out_x,
                                   int32_t* out_d, int32_t* out_e,
                                   void* stream) {
  if (n < 1 || row < 1 || b < 0 || b > 65535) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const bool vec = row % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(out_x) % 16) == 0;
  const int64_t units = vec ? row / 4 : row;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;  // the grid-stride loop covers it
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(b));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    batch_gather_vec4<<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), dist, event, n, units, idx, w,
        reinterpret_cast<float4*>(out_x), out_d, out_e);
  } else {
    batch_gather_scalar<<<grid, kThreads, 0, s>>>(
        x, dist, event, n, row, idx, w, out_x, out_d, out_e);
  }
  return cudaGetLastError();
}
