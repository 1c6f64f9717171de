// int8_dot: the int8 preset's dequantize-free dense layer, one launch per
// model-C int8 forward (its 2048 -> 32 `fc`).
//
// Replaces dasmtl/models/precision.py:116-137 int8_dot, which XLA lowers to
// a row max, a quantize, an int8 x int8 -> int32 dot_general and a rescale:
//   xscale[r] = max_k |x[r,k]| / 127            (1 where that max is not > 0)
//   xq[r,k]   = int8(clip(round(x[r,k] / xscale[r]), -127, 127))
//   y[r,n]    = f32(sum_k xq[r,k] * q[n,k]) * xscale[r] * scale[n] + bias[n]
// q is stored (N, K), the Linear weight's layout (the Flax kernel's
// transpose), one f32 scale per output channel.
//
// Bit-exactness with XLA's f32 output.  The integer sum is exact in any
// order, so everything rests on the float steps, each spelled with an
// intrinsic so nvcc neither contracts nor reorders them:
//   - xscale = __fdiv_rn(xmax, 127), the quantizer divides with __fdiv_rn
//     (never a multiply by a reciprocal), rintf rounds half to even like
//     jnp.round;
//   - the epilogue is ((f32(acc) * xscale) * scale) + bias, the
//     left-to-right order of precision.py:134-136, with __fmul_rn /
//     __fadd_rn (nvcc would contract a*b+c into an FMA);
//   - NaN follows XLA: a row max that is NaN makes xscale 1 (NaN > 0 is
//     false), and a NaN quotient converts to int8 0.  fmaxf would drop the
//     NaN and __float2int_rn(NaN) is not 0, so both are handled by hand.
//     +-Inf elements clip to +-127; an Inf row max gives xscale = Inf, and
//     then Inf / Inf is NaN -> 0, every finite element -> 0, and the row's
//     outputs are 0 * Inf = NaN, as in the reference.
//
// What bounds it: bytes.  At the serving shapes (B <= 32 rows of K = 2048,
// N = 32) it moves x once (256 KB at B = 32), q once (64 KB), y, scale and
// bias: ~332 KB, about 0.1 us at 3.35 TB/s, and 4.2 MOP of int8 work, far
// below the tensor cores' int8 rate.  So the kernel is launch-bound and its
// design is the simple one: one block per row reduces the row's |x| max,
// quantizes the row into shared memory (K bytes, 2 KB at K = 2048), and
// each warp takes every 8th output column, accumulating int32 with __dp4a
// over packed int8 words (a scalar loop when K % 4 != 0 or q is not 4-byte
// aligned) and reducing with shuffles.  Tensor-core (IMMA / wgmma) tiles
// are later work.  The launch goes on the caller's stream; the C entry
// point returns the launch's cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32768;  // xq lives in dynamic shared memory
constexpr float kQmax = 127.0f;

// max that keeps NaN, as XLA's reduce-max does.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ int8_t quantize(float v, float xscale) {
  const float t = rintf(__fdiv_rn(v, xscale));
  if (isnan(t)) return 0;
  return static_cast<int8_t>(fminf(fmaxf(t, -kQmax), kQmax));
}

__global__ void int8_dot_kernel(const float* __restrict__ x,
                                const int8_t* __restrict__ q,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                float* __restrict__ y, int k_dim, int n_dim,
                                bool words) {
  extern __shared__ int32_t xq_words[];
  int8_t* xq = reinterpret_cast<int8_t*>(xq_words);
  __shared__ float warp_max[kWarps];
  __shared__ float row_scale;
  const int64_t r = blockIdx.x;
  const float* xr = x + r * k_dim;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. max |x| of the row (|x| >= 0, so 0 is a neutral start).
  float m = 0.0f;
  for (int k = tid; k < k_dim; k += kThreads) m = nan_max(fabsf(xr[k]), m);
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(__shfl_xor_sync(0xffffffffu, m, off), m);
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float mm = warp_max[0];
    for (int w = 1; w < kWarps; ++w) mm = nan_max(warp_max[w], mm);
    row_scale = mm > 0.0f ? __fdiv_rn(mm, kQmax) : 1.0f;
  }
  __syncthreads();
  const float xscale = row_scale;

  // 2. the row, quantized into shared memory.
  for (int k = tid; k < k_dim; k += kThreads) xq[k] = quantize(xr[k], xscale);
  __syncthreads();

  // 3. one warp per output column at a time; exact int32 sums.
  for (int n = warp; n < n_dim; n += kWarps) {
    const int8_t* qn = q + static_cast<int64_t>(n) * k_dim;
    int acc = 0;
    if (words) {
      const int* qw = reinterpret_cast<const int*>(qn);
      for (int i = lane; i < k_dim / 4; i += 32)
        acc = __dp4a(xq_words[i], __ldg(qw + i), acc);
    } else {
      for (int k = lane; k < k_dim; k += 32)
        acc += static_cast<int>(xq[k]) * static_cast<int>(qn[k]);
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xscale), scale[n]);
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      y[r * n_dim + n] = v;
    }
  }
}

}  // namespace

// x (rows, k) f32, q (n, k) int8, scale (n,) f32, bias (n,) f32 or null,
// y (rows, n) f32; all row-major contiguous.
extern "C" int dasmtl_int8_dot(const float* x, const int8_t* q,
                               const float* scale, const float* bias, float* y,
                               int64_t rows, int k_dim, int n_dim,
                               void* stream) {
  if (k_dim < 1 || k_dim > kMaxK || n_dim < 1 || rows > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  const bool words =
      k_dim % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  const size_t smem = static_cast<size_t>((k_dim + 3) / 4) * 4;
  int8_dot_kernel<<<static_cast<unsigned>(rows), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, q, scale, bias, y, k_dim, n_dim, words);
  return cudaGetLastError();
}
