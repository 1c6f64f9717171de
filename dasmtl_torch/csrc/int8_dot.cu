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
// What bounds it on this card: neither bytes nor operations.  At the
// serving shapes (B <= 32 rows of K = 2048, N = 32) it must move x once
// (256 KB at B = 32), q once (64 KB), y, scale and bias: ~332 KB, 0.1 us at
// 3.35 TB/s, and 4.2 MOP of int8 work, 2 ns at the tensor cores' int8 rate.
// What is left is latency: the launch, and the chain of dependent steps
// inside a block.  The first design (one 256-thread block per row)
// put 32 blocks on 132 SMs at B = 32 and one at B = 1, read each row
// twice, loaded q only after two barriers and scale and bias only at the
// end, and sent NaN and Inf elements through __fdiv_rn's slow
// subroutine.  This design:
//
// - A grid of rows x column groups.  A block takes one row and `cols`
//   (1, 2, 4 or 8) output columns; the wrapper picks the fewest columns
//   whose grid still fits one block per SM (ops/int8.py:int8_plan): 32
//   blocks at B = 1, 128 at B = 8 and 32.  Each block reduces its own
//   row's |x| max: nan_max is exact and order-free, NaN included, so every
//   block of a row finds the same xscale.
// - The dot split over the whole block: each thread owns 16 consecutive
//   elements of K (a 128-thread block covers K = 2048 in one chunk) and
//   the same 16 bytes of each of its columns of q.
// - One round trip to memory: a thread issues its columns' 16-byte loads
//   of q, and the epilogue's scale and bias, before it reads x, so all
//   their latencies overlap the row's.
// - x read once: four 16-byte loads a thread, kept in registers from the
//   max to the quantize step (a K longer than 16 x threads re-reads its
//   later chunks; no serving shape does).
// - Two barriers: one for the row max (every thread then reduces the
//   warps' maxima itself), one for the column sums.  __dp4a over packed
//   int8 words; shuffles, then shared memory, for the sums.
// - The quantizer settles NaN, Inf (and zero) by hand before it divides.
// - Programmatic dependent launch (pdl.cuh): the launch overlaps the tail
//   of the kernel before it.
// The vector branch needs K % 16 == 0 and 16-byte aligned x and q; the
// scalar branch (one element at a time, same steps) takes the rest.  Tensor
// cores (mma.sync s8 / wgmma) are not used: at 4.2 MOP they bound nothing,
// and their fragment layouts would add a pass of x through shared memory
// to the chain.  The launch goes on the caller's stream; the C entry point
// returns the launch's cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

using dasmtl_pdl::allow_next_grid;
using dasmtl_pdl::wait_prior_grid;

constexpr int kPerThread = 16;  // elements of K a thread owns per chunk
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCols = 8;
constexpr int kMaxK = 32768;
constexpr float kQmax = 127.0f;

// max that keeps NaN, as XLA's reduce-max does.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// round(v / xscale) clipped to +-127, NaN -> 0.  xscale is 1 or in
// (0, Inf].  NaN and Inf operands take __fdiv_rn off its fast path into a
// slow subroutine, so they (and 0) are settled first, with the results
// the division gives them: NaN / s and v / Inf are NaN or +-0 -> 0,
// 0 / s = +-0 -> 0, +-Inf / s = +-Inf -> +-127.  The rest divide; their
// quotients are finite or +-Inf, never NaN.
__device__ __forceinline__ int quantize(float v, float xscale) {
  if (isnan(v) || isinf(xscale) || v == 0.0f) return 0;
  if (isinf(v)) return v > 0.0f ? 127 : -127;
  const float t = rintf(__fdiv_rn(v, xscale));
  return static_cast<int>(fminf(fmaxf(t, -kQmax), kQmax));
}

__device__ __forceinline__ unsigned byte(int v) {
  return static_cast<unsigned>(v) & 0xffu;
}

// Four quantized elements as one word, element i in byte i (q's order).
__device__ __forceinline__ int pack4(float a, float b, float c, float d,
                                     float xscale) {
  return static_cast<int>(
      byte(quantize(a, xscale)) | (byte(quantize(b, xscale)) << 8) |
      (byte(quantize(c, xscale)) << 16) | (byte(quantize(d, xscale)) << 24));
}

// The thread's 16 elements of x at k0 (zeros past K).
template <bool kVec>
__device__ __forceinline__ void load_x(const float* xr, int k0, int k_dim,
                                       float (&v)[kPerThread]) {
  if constexpr (kVec) {
    // K % 16 == 0: the 16 elements are all inside the row or all past it.
    if (k0 < k_dim) {
      const float4* p = reinterpret_cast<const float4*>(xr + k0);
#pragma unroll
      for (int i = 0; i < kPerThread / 4; ++i) {
        const float4 f = __ldg(p + i);
        v[4 * i] = f.x;
        v[4 * i + 1] = f.y;
        v[4 * i + 2] = f.z;
        v[4 * i + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) v[i] = 0.0f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      v[i] = k0 + i < k_dim ? __ldg(xr + k0 + i) : 0.0f;
  }
}

// The thread's 16 bytes of column n at k0, as 4 words (zeros past K or N).
template <bool kVec>
__device__ __forceinline__ int4 load_q(const int8_t* q, int n, int n_dim,
                                       int k0, int k_dim) {
  int4 w = make_int4(0, 0, 0, 0);
  if (n >= n_dim || k0 >= k_dim) return w;
  const int8_t* p = q + static_cast<int64_t>(n) * k_dim + k0;
  if constexpr (kVec) {
    w = __ldg(reinterpret_cast<const int4*>(p));
  } else {
    unsigned b[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      b[i] = k0 + i < k_dim ? byte(__ldg(p + i)) : 0u;
    w.x = static_cast<int>(b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24));
    w.y = static_cast<int>(b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24));
    w.z = static_cast<int>(b[8] | (b[9] << 8) | (b[10] << 16) |
                           (b[11] << 24));
    w.w = static_cast<int>(b[12] | (b[13] << 8) | (b[14] << 16) |
                           (b[15] << 24));
  }
  return w;
}

template <int kCols>
__device__ __forceinline__ void dot_chunk(const float (&v)[kPerThread],
                                          float xscale,
                                          const int4 (&qw)[kCols],
                                          int (&acc)[kCols]) {
  const int x0 = pack4(v[0], v[1], v[2], v[3], xscale);
  const int x1 = pack4(v[4], v[5], v[6], v[7], xscale);
  const int x2 = pack4(v[8], v[9], v[10], v[11], xscale);
  const int x3 = pack4(v[12], v[13], v[14], v[15], xscale);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    acc[j] = __dp4a(x0, qw[j].x, acc[j]);
    acc[j] = __dp4a(x1, qw[j].y, acc[j]);
    acc[j] = __dp4a(x2, qw[j].z, acc[j]);
    acc[j] = __dp4a(x3, qw[j].w, acc[j]);
  }
}

// Block (row r = blockIdx.x, columns [blockIdx.y * kCols, + kCols)).
template <int kCols, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    int8_dot_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int k_dim, int n_dim) {
  __shared__ float warp_max[kMaxWarps];
  __shared__ int warp_sum[kMaxCols][kMaxWarps];
  const int64_t r = blockIdx.x;
  const int n0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int chunk = blockDim.x * kPerThread;
  const int k0 = tid * kPerThread;
  const float* xr = x + r * k_dim;
  wait_prior_grid();

  // 1. The epilogue's scale and bias, q's bytes of chunk 0, then the
  // row's: every load of the block in flight at once.
  const bool writer = tid < kCols && n0 + tid < n_dim;
  float col_scale = 0.0f, col_bias = 0.0f;
  if (writer) {
    col_scale = __ldg(scale + n0 + tid);
    if (bias != nullptr) col_bias = __ldg(bias + n0 + tid);
  }
  int4 qw[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    qw[j] = load_q<kVec>(q, n0 + j, n_dim, k0, k_dim);
  float v[kPerThread];
  load_x<kVec>(xr, k0, k_dim, v);
  allow_next_grid();

  // 2. max |x| of the row (|x| >= 0, so 0 is a neutral start); chunk 0
  // stays in registers, later chunks (K > 16 x threads) are read again.
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) m = nan_max(fabsf(v[i]), m);
  for (int k = k0 + chunk; k < k_dim; k += chunk) {
    float u[kPerThread];
    load_x<kVec>(xr, k, k_dim, u);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) m = nan_max(fabsf(u[i]), m);
  }
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(__shfl_xor_sync(0xffffffffu, m, off), m);
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  float mm = warp_max[0];
  for (int w = 1; w < warps; ++w) mm = nan_max(warp_max[w], mm);
  const float xscale = mm > 0.0f ? __fdiv_rn(mm, kQmax) : 1.0f;

  // 3. quantize and multiply; exact int32 sums.
  int acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0;
  dot_chunk<kCols>(v, xscale, qw, acc);
  for (int k = k0 + chunk; k < k_dim; k += chunk) {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      qw[j] = load_q<kVec>(q, n0 + j, n_dim, k, k_dim);
    load_x<kVec>(xr, k, k_dim, v);
    dot_chunk<kCols>(v, xscale, qw, acc);
  }

  // 4. the block's column sums, then the float epilogue.
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    int a = acc[j];
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) warp_sum[j][warp] = a;
  }
  __syncthreads();
  if (writer) {
    int a = 0;
    for (int w = 0; w < warps; ++w) a += warp_sum[tid][w];
    float out = __fmul_rn(__fmul_rn(__int2float_rn(a), xscale), col_scale);
    if (bias != nullptr) out = __fadd_rn(out, col_bias);
    y[r * n_dim + n0 + tid] = out;
  }
}

template <int kCols>
cudaError_t launch(bool vec, dim3 grid, int threads, cudaStream_t s, bool pdl,
                   const float* x, const int8_t* q, const float* scale,
                   const float* bias, float* y, int k_dim, int n_dim) {
  return dasmtl_pdl::launch_pdl(
      vec ? &int8_dot_kernel<kCols, true> : &int8_dot_kernel<kCols, false>,
      grid, threads, s, pdl, x, q, scale, bias, y, k_dim, n_dim);
}

}  // namespace

// x (rows, k) f32, q (n, k) int8, scale (n,) f32, bias (n,) f32 or null,
// y (rows, n) f32; all row-major contiguous.  The launch geometry comes
// from ops/int8.py:int8_plan: `threads` (a multiple of 32, at most 256)
// per block, `cols` (1, 2, 4 or 8) output columns per block, `vec` the
// 16-byte branch, which needs k % 16 == 0 and 16-byte aligned x and q.
// `pdl` launches with programmatic stream serialization (pdl.cuh).
extern "C" int dasmtl_int8_dot(const float* x, const int8_t* q,
                               const float* scale, const float* bias, float* y,
                               int64_t rows, int k_dim, int n_dim, int threads,
                               int cols, int vec, int pdl, void* stream) {
  if (k_dim < 1 || k_dim > kMaxK || n_dim < 1 || rows > 0x7fffffff ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  if (vec && (k_dim % kPerThread != 0 ||
              reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(q) % 16 != 0))
    return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  if (cols != 1 && cols != 2 && cols != 4 && cols != kMaxCols)
    return cudaErrorInvalidValue;
  const int groups = (n_dim + cols - 1) / cols;
  if (groups > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(groups));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 1: return launch<1>(vec, grid, threads, s, pdl, x, q, scale, bias, y,
                             k_dim, n_dim);
    case 2: return launch<2>(vec, grid, threads, s, pdl, x, q, scale, bias, y,
                             k_dim, n_dim);
    case 4: return launch<4>(vec, grid, threads, s, pdl, x, q, scale, bias, y,
                             k_dim, n_dim);
    default: return launch<8>(vec, grid, threads, s, pdl, x, q, scale, bias, y,
                              k_dim, n_dim);
  }
}
