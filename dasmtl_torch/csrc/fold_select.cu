// Per-fold select of the cross-validation step: a fold whose batch holds no
// real row keeps its whole train state, bit for bit.
//
// Replaces dasmtl/train/steps.py:255-260 (make_cv_scan_train_step.one_fold):
//
//   has_real = w_k.sum() > 0
//   new_state = jax.tree.map(lambda new, old: jnp.where(has_real, new, old),
//                            new_state, state)
//
// over every leaf of every fold's state: the parameters, the BatchNorm
// running stats and counters, Adam's moments and step.  It is a select,
// not a product: the bytes of the kept state come back as they were, so
// NaN payloads, -0.0 and +-Inf survive in any dtype.
//
// The port updates each fold's state in place, so `new` and `old` never
// coexist.  has_real is known before the step (it comes from the plan), so
// the select is two passes of this kernel around the F fold steps:
//
//   save    (restore = 0): for each fold with no real row, copy its state
//                          into its slice of a snapshot buffer;
//   restore (restore = 1): for each such fold, copy the snapshot back.
//
// A fold with a real row is untouched by both passes, which is
// where(has_real, new, old) with new = the stepped state.  Each block reads
// the step's (F, B) weights itself and computes has_real[f] = (sum_b
// w[f, b]) > 0 on the card, as JAX does; the weights are 0/1, so the
// order of the sum does not matter.
//
// What bounds it on this card: bytes when a fold is padded, the launch when
// none is.  A padded fold's pass reads and writes its state once (model
// A's train state is 13.66 MB: 8.2 us a pass at 3.35 TB/s); a normal step
// moves no state bytes, and each pass is one launch whose blocks read the
// (F, B) weights (640 bytes at F = 5, B = 32) and exit.  The design:
//
// - A work list built on the host (ops/fold_select.py:select_plan) and
//   cached on the card with the state's pointers, as ops/digest.py caches
//   its list: 32-byte records
//       struct Item { begin; snap; count; leaf; mode; pad; }
//   `begin` the item's first byte in its leaf, `snap` its first byte in a
//   fold's snapshot slice, `count` its bytes, `leaf` the leaf's column in
//   the (F, L) table of state pointers that follows the records, `mode`
//   bit 0 the 16-byte branch.  The records describe ONE fold's layout,
//   which every fold shares (the same model); each block loops over the
//   padded folds, so the grid is one fold's work, not F folds'.
// - Large leaves (more than 2 KB) are cut into items of about equal bytes,
//   multiples of 16, sized so that the grid is at most one wave; each such
//   item is one block, 4 16-byte loads in flight a thread before its
//   stores.  Small leaves are copied whole, one warp a leaf, eight to a
//   block.
// - The 16-byte branch takes a leaf whose pointers are 16-byte aligned in
//   every fold (the snapshot slices always are); its last count % 16
//   bytes go one byte a thread.  Other leaves (views) go byte by byte.
// - Programmatic dependent launch (pdl.cuh): the launch overlaps the tail
//   of the kernel before it; each block lets the next launch begin once it
//   knows its folds.
// The launch goes on the caller's stream with no synchronisation, no
// allocation and no attribute call, so a CUDA graph captures it; the C
// entry point returns the cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;     // 16-byte loads a thread before its stores
constexpr int kMaxFolds = 32; // folds in the block's bit mask

struct alignas(16) Item {
  long long begin;
  long long snap;
  int count;
  int leaf;
  int mode;
  int pad;
};
static_assert(sizeof(Item) == 32, "a work record is two 16-byte loads");

__device__ __forceinline__ Item load_item(const Item* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  union {
    int4 v[2];
    Item it;
  } u;
  u.v[0] = __ldg(q);
  u.v[1] = __ldg(q + 1);
  return u.it;
}

// Copy `count` bytes from `src` to `dst`, thread `t` of `n` cooperating:
// 16-byte units when `vec` (both 16-byte aligned), kLoads loads in flight
// a thread, then the tail bytes; else byte by byte.
__device__ __forceinline__ void copy_bytes(char* __restrict__ dst,
                                           const char* __restrict__ src,
                                           int count, bool vec, int t,
                                           int n) {
  int done = 0;
  if (vec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const int units = count >> 4;
    for (int base = t; base < units; base += kLoads * n) {
      uint4 v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int j = base + k * n;
        if (j < units) v[k] = s[j];
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int j = base + k * n;
        if (j < units) d[j] = v[k];
      }
    }
    done = units << 4;
  }
  for (int j = done + t; j < count; j += n) dst[j] = src[j];
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    fold_select_kernel(const Item* __restrict__ plan, int big, int items,
                       int F, int L, char* __restrict__ snap,
                       long long stride, const float* __restrict__ w, int B,
                       int restore) {
  dasmtl_pdl::wait_prior_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool small = static_cast<int>(blockIdx.x) >= big;
  const int r = small ? big + (static_cast<int>(blockIdx.x) - big) * kWarps +
                            warp
                      : static_cast<int>(blockIdx.x);
  Item it = {};
  if (r < items) it = load_item(plan + r);  // in flight during the sums
  __shared__ unsigned padded;
  if (threadIdx.x == 0) padded = 0u;
  __syncthreads();
  for (int f = warp; f < F; f += kWarps) {
    float acc = 0.f;
    for (int b = lane; b < B; b += 32) acc += __ldg(w + f * B + b);
    acc = warp_sum(acc);
    if (lane == 0 && !(acc > 0.f)) atomicOr(&padded, 1u << f);
  }
  __syncthreads();
  const unsigned mask = padded;
  dasmtl_pdl::allow_next_grid();
  if (mask == 0u || r >= items) return;
  const unsigned long long* ptrs =
      reinterpret_cast<const unsigned long long*>(plan + items);
  const bool vec = (it.mode & 1) != 0;
  for (unsigned m = mask; m != 0u; m &= m - 1u) {
    const int f = __ffs(static_cast<int>(m)) - 1;
    char* state =
        reinterpret_cast<char*>(ptrs[static_cast<long long>(f) * L +
                                     it.leaf]) + it.begin;
    char* kept = snap + f * stride + it.snap;
    char* dst = restore ? state : kept;
    const char* src = restore ? kept : state;
    if (small)
      copy_bytes(dst, src, it.count, vec, lane, 32);
    else
      copy_bytes(dst, src, it.count, vec, threadIdx.x, kThreads);
  }
}

}  // namespace

// plan: `items` 32-byte records (the last `small` of them small leaves, 8
// a block) followed by the (F, L) table of the folds' leaf pointers (8
// bytes each), all on the card; snap: F slices of `stride` bytes; w: the
// step's (F, B) float32 weights.  `restore` 0 saves the padded folds'
// state into `snap`, 1 writes it back.  `pdl` launches with programmatic
// stream serialization (pdl.cuh).
extern "C" int dasmtl_fold_select(const void* plan, int items, int small,
                                  int F, int L, void* snap, long long stride,
                                  const float* w, int B, int restore, int pdl,
                                  void* stream) {
  if (items < 1 || small < 0 || small > items || F < 1 || F > kMaxFolds ||
      L < 1 || B < 1 || stride < 0)
    return cudaErrorInvalidValue;
  const int big = items - small;
  const unsigned blocks =
      static_cast<unsigned>(big) +
      static_cast<unsigned>((small + kWarps - 1) / kWarps);
  return dasmtl_pdl::launch_pdl(fold_select_kernel, dim3(blocks), kThreads,
                                static_cast<cudaStream_t>(stream), pdl != 0,
                                static_cast<const Item*>(plan), big, items, F,
                                L, static_cast<char*>(snap), stride, w, B,
                                restore);
}

// Resident blocks per SM of the kernel (the occupancy API, on the current
// device): ops/fold_select.py sizes the work list to one wave with it.
extern "C" int dasmtl_fold_select_blocks_per_sm(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fold_select_kernel, kThreads, 0);
}
