// Sigmoid attention gate, forward and backward.
//
//   forward:   o_t[i] = features[i] / (1 + expf(-mask_logits_t[i])),  t < T
//   backward:  s = sigmoid(l[i]);  dl[i] = g[i] * f[i] * s * (1 - s);  df[i] = s * g[i]
//
// The forward replaces the Pallas kernel `_gate_kernel`, launched by
// `_gate_pallas_fwd_impl` through pl.pallas_call (git show
// 16944ec^:dasmtl/ops/gating.py:47-69); the function it computes is today's
// dasmtl/ops/gating.py:23-25 gate_apply, run 8 times per MTL forward (4 stages
// x 2 tasks, dasmtl/models/two_level.py:66-78).  The backward replaces that
// kernel's custom VJP, `_gate_fwd` / `_gate_bwd` (16944ec^:...gating.py:26-44):
// like the VJP it keeps only the logits and features from the forward and
// recomputes s, so nothing of size n is saved beyond the operands.
//
// What bounds the forward on the H100: HBM bytes, and the fixed cost of a
// launch.  At T = 1 each element reads 8 B (logit and feature) and writes
// 4 B, for about four f32 operations -- far under the card's ridge of ~20
// f32 operations per byte.  The maps are small (2.7-16.8 MB per stage at
// batch 32, 0.8-5.0 us at 3.35 TB/s), so a launch and the ramp of its first
// loads weigh as much as the bytes.  The design answers with three things:
//
// - The T gates that share their features, in ONE launch.  Both tasks of a
//   stage gate the same shared map (models/two_level.py); at T = 2 the kernel
//   reads f[i] once for both, 20 B per element instead of 24 B in two
//   launches, and an eval forward makes 4 launches instead of 8.  Every
//   output keeps the T = 1 expression, so it is bit-identical to a T = 1
//   launch.  Training (the order of its autograd graph) and model B use T = 1.
// - A grid of whole waves.  The map is cut into tiles of one float4 per
//   thread of a 128-thread block; the grid is min(tiles, resident blocks),
//   resident blocks being cudaOccupancyMaxActiveBlocksPerMultiprocessor x the
//   SM count (asked once per device), and a block walks ceil(tiles / grid)
//   tiles.  No stage runs a ragged second wave, and even the smallest stage
//   (batch 32, 225,280 elements: 440 tiles) spreads over every SM.
// - Loads in flight.  Each thread issues its 1 + T independent 16-byte loads
//   before it stores.  Two or four float4 per operand and thread measured
//   slower at every stage (fewer blocks, so fewer SMs, on the small maps).
//   Nothing else reads the logits, so they load evict-first (__ldcs, which
//   measured faster than __ldg); the features and the outputs keep the
//   normal policy, since the next resblock and output layer read them
//   from L2.
//
// A size that is no multiple of 4 ends in a scalar tail inside the same
// launch; pointers that are not 16-byte aligned take the scalar
// instantiation of the same kernel: one launch either way.
//
// The backward is bound by bytes too: each element reads 12 B (l, f, g) and
// writes 8 B (dl, df), 20 B for about nine f32 operations.  Both gradients
// come out of ONE pass (one launch, one read of each operand) where the plain
// version makes six elementwise passes.  At l = +-100, s is exactly 1 or 0,
// so dl is exactly 0.
//
// `expf`, not `__expf`, keeps the result within a few ulp of
// torch.sigmoid(l) * f; l = -100 gives 0, l = +100 gives f, and a NaN in
// either operand passes through.
//
// The launch goes on the caller's stream (PyTorch's current stream); the C
// entry point returns the cudaError_t of the launch, and the Python wrapper
// raises on anything but cudaSuccess.

#include <atomic>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks per SM is plenty
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float gate(float l, float f) {
  return f / (1.0f + expf(-l));
}

// -- forward ------------------------------------------------------------------

// The forward's operands: T logits and T outputs around one feature map.
struct GateFwdArgs {
  const float* l[2];
  const float* f;
  float* o[2];
};

constexpr int kFwdThreads = 128;

__device__ __forceinline__ float4 gate_v(float4 l, float4 f) {
  return make_float4(gate(l.x, f.x), gate(l.y, f.y), gate(l.z, f.z),
                     gate(l.w, f.w));
}
__device__ __forceinline__ float gate_v(float l, float f) { return gate(l, f); }

// Thread i of the grid gates units i, i + grid size, ... (float4 when kVec,
// else float): it issues its 1 + T loads, then its T stores.  When kVec,
// block 0 also gates the scalar tail [4 * units, n).
template <int T, bool kVec>
__global__ void __launch_bounds__(kFwdThreads)
    gate_fwd_kernel(GateFwdArgs a, int64_t units, int64_t n) {
  using V = typename std::conditional<kVec, float4, float>::type;
  const V* f = reinterpret_cast<const V*>(a.f);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kFwdThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kFwdThreads + threadIdx.x;
       i < units; i += stride) {
    const V fv = __ldg(f + i);
    V lv[T];
#pragma unroll
    for (int t = 0; t < T; ++t)
      lv[t] = __ldcs(reinterpret_cast<const V*>(a.l[t]) + i);
#pragma unroll
    for (int t = 0; t < T; ++t)
      reinterpret_cast<V*>(a.o[t])[i] = gate_v(lv[t], fv);
  }
  if constexpr (kVec) {
    const int64_t i = 4 * units + threadIdx.x;
    if (blockIdx.x == 0 && i < n) {
#pragma unroll
      for (int t = 0; t < T; ++t) a.o[t][i] = gate(a.l[t][i], a.f[i]);
    }
  }
}

// Blocks of `kernel` that fit on the card at once: its occupancy at
// kFwdThreads threads x the SM count, asked once per device.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, std::atomic<int>* cache,
                            int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = cache[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kFwdThreads, 0);
    if (err != cudaSuccess) return err;
    n = sms * (per_sm > 0 ? per_sm : 1);
    cache[dev].store(n, std::memory_order_relaxed);
  }
  *out = n;
  return cudaSuccess;
}

template <int T, bool kVec>
cudaError_t launch_fwd(const GateFwdArgs& a, int64_t n, cudaStream_t s) {
  static std::atomic<int> cache[kMaxDevices];
  auto kernel = gate_fwd_kernel<T, kVec>;
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, cache, &resident);
  if (err != cudaSuccess) return err;
  const int64_t units = kVec ? n / 4 : n;
  int64_t tiles = (units + kFwdThreads - 1) / kFwdThreads;
  if (tiles < 1) tiles = 1;  // n < 4: the tail alone, in block 0
  const int64_t per_block = (tiles + resident - 1) / resident;
  const int64_t grid = (tiles + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(grid), kFwdThreads, 0, s>>>(a, units, n);
  return cudaGetLastError();
}

// -- backward -----------------------------------------------------------------

__device__ __forceinline__ void gate_grad(float l, float f, float g, float& dl,
                                          float& df) {
  const float s = 1.0f / (1.0f + expf(-l));
  df = s * g;
  dl = g * f * s * (1.0f - s);
}

__global__ void gate_bwd_vec4(const float4* __restrict__ l,
                              const float4* __restrict__ f,
                              const float4* __restrict__ g,
                              float4* __restrict__ dl, float4* __restrict__ df,
                              int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 a = l[i];
    const float4 b = f[i];
    const float4 c = g[i];
    float4 x, y;
    gate_grad(a.x, b.x, c.x, x.x, y.x);
    gate_grad(a.y, b.y, c.y, x.y, y.y);
    gate_grad(a.z, b.z, c.z, x.z, y.z);
    gate_grad(a.w, b.w, c.w, x.w, y.w);
    dl[i] = x;
    df[i] = y;
  }
}

__global__ void gate_bwd_scalar(const float* __restrict__ l,
                                const float* __restrict__ f,
                                const float* __restrict__ g,
                                float* __restrict__ dl, float* __restrict__ df,
                                int64_t begin, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = begin + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    gate_grad(l[i], f[i], g[i], dl[i], df[i]);
  }
}

int blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

}  // namespace

// tasks (T) is 1 or 2: l1 and o1 are read only at T = 2.  One launch.
extern "C" int dasmtl_gate_fwd(int tasks, const float* l0, const float* l1,
                               const float* f, float* o0, float* o1, int64_t n,
                               void* stream) {
  if (tasks < 1 || tasks > 2 || (tasks == 2 && (l1 == nullptr || o1 == nullptr)))
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GateFwdArgs a{{l0, tasks == 2 ? l1 : l0}, f, {o0, tasks == 2 ? o1 : o0}};
  uintptr_t addr_bits = reinterpret_cast<uintptr_t>(l0) |
                        reinterpret_cast<uintptr_t>(f) |
                        reinterpret_cast<uintptr_t>(o0);
  if (tasks == 2)
    addr_bits |= reinterpret_cast<uintptr_t>(l1) | reinterpret_cast<uintptr_t>(o1);
  const bool vec = (addr_bits & 15) == 0;
  if (tasks == 2)
    return vec ? launch_fwd<2, true>(a, n, s) : launch_fwd<2, false>(a, n, s);
  return vec ? launch_fwd<1, true>(a, n, s) : launch_fwd<1, false>(a, n, s);
}

extern "C" int dasmtl_gate_bwd(const float* l, const float* f, const float* g,
                               float* dl, float* df, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(l) | reinterpret_cast<uintptr_t>(f) |
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dl) |
      reinterpret_cast<uintptr_t>(df);
  int64_t done = 0;
  if ((addr_bits & 15) == 0) {
    const int64_t n4 = n / 4;
    if (n4 > 0) {
      gate_bwd_vec4<<<blocks_for(n4), kThreads, 0, s>>>(
          reinterpret_cast<const float4*>(l), reinterpret_cast<const float4*>(f),
          reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(dl),
          reinterpret_cast<float4*>(df), n4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    done = n4 * 4;
  }
  if (done < n) {
    gate_bwd_scalar<<<blocks_for(n - done), kThreads, 0, s>>>(l, f, g, dl, df,
                                                              done, n);
    return cudaGetLastError();
  }
  return cudaSuccess;
}
