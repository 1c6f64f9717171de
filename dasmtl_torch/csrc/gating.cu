// Sigmoid attention gate, forward and backward.
//
//   forward:   out[i] = features[i] / (1 + expf(-mask_logits[i]))
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
// What bounds it on the H100: HBM bytes.  Each element reads 8 B (logit and
// feature) and writes 4 B, 12 B in all, for about four f32 operations -- far
// under the card's ridge of ~20 f32 operations per byte.  The Pallas kernel
// made one VMEM-resident pass per batch row; here blocks run in parallel with
// nothing carried between them, so the kernel is a flat grid-stride loop:
// 16-byte float4 loads and stores when all three pointers are 16-byte aligned,
// then a scalar tail (every main-path size is a multiple of 4 elements per
// sample, but any size works).  No shared memory: nothing is reused.
//
// The backward is bound the same way: each element reads 12 B (l, f, g) and
// writes 8 B (dl, df), 20 B for about nine f32 operations.  Both gradients
// come out of ONE pass (one launch, one read of each operand) where the plain
// version makes six elementwise passes.  At l = +-100, s is exactly 1 or 0,
// so dl is exactly 0.
//
// At serving batch sizes a launch moves 2.7-16.8 MB (batch 32), a few
// microseconds at HBM rate, so the gate is launch-bound there.  Folding it
// into the following convolution's prologue, or capturing the forward in a
// CUDA graph, is later work.  `expf`, not `__expf`, keeps the result within a
// few ulp of torch.sigmoid(l) * f; l = -100 gives 0, l = +100 gives f, and a
// NaN in either operand passes through.
//
// The launch goes on the caller's stream (PyTorch's current stream); the C
// entry point returns the cudaError_t of the launch, and the Python wrapper
// raises on anything but cudaSuccess.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks per SM is plenty

__device__ __forceinline__ float gate(float l, float f) {
  return f / (1.0f + expf(-l));
}

__global__ void gate_fwd_vec4(const float4* __restrict__ l,
                              const float4* __restrict__ f,
                              float4* __restrict__ o, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 a = l[i];
    const float4 b = f[i];
    o[i] = make_float4(gate(a.x, b.x), gate(a.y, b.y), gate(a.z, b.z),
                       gate(a.w, b.w));
  }
}

__global__ void gate_fwd_scalar(const float* __restrict__ l,
                                const float* __restrict__ f,
                                float* __restrict__ o, int64_t begin,
                                int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = begin + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    o[i] = gate(l[i], f[i]);
  }
}

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

extern "C" int dasmtl_gate_fwd(const float* l, const float* f, float* o,
                               int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(l) |
                              reinterpret_cast<uintptr_t>(f) |
                              reinterpret_cast<uintptr_t>(o);
  int64_t done = 0;
  if ((addr_bits & 15) == 0) {
    const int64_t n4 = n / 4;
    if (n4 > 0) {
      gate_fwd_vec4<<<blocks_for(n4), kThreads, 0, s>>>(
          reinterpret_cast<const float4*>(l), reinterpret_cast<const float4*>(f),
          reinterpret_cast<float4*>(o), n4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    done = n4 * 4;
  }
  if (done < n) {
    gate_fwd_scalar<<<blocks_for(n - done), kThreads, 0, s>>>(l, f, o, done, n);
    return cudaGetLastError();
  }
  return cudaSuccess;
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
