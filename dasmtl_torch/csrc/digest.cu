// Leaf digest: one order-sensitive uint32 fingerprint per tensor, for every
// tensor of a train state, in one kernel launch.
//
// Replaces dasmtl/analysis/sanitize/fingerprint.py:41-81: leaf_digest
// (:62-73), which digest_vector (:76-81) stacks over the leaves of a state,
// reading each leaf's bits as uint32 words (_as_uint32_words, :41-59):
//
//   digest = sum_i words[i] * (i * 2654435761 + 0x9E3779B9)   mod 2^32
//
// Words per element kind (the rules of _as_uint32_words):
//   kB32   4-byte elements as they are (f32 bits, int32, uint32);
//   kU16   2-byte elements zero-extended (f16 / bf16 bits, uint16);
//   kI16   int16 sign-extended (its low 32 bits);
//   kU8    uint8 and bool zero-extended;
//   kI8    int8 sign-extended (-1 -> 0xFFFFFFFF);
//   kB64Lo 8-byte integers: the low word (int64 counters);
//   kF64   f64 rounded to f32, then its bits.
//
// The work: model A's train state on the card is 694 leaves, 3,413,592
// words (13.65 MB): 27 large f32 leaves of up to 147,456 words, and 613
// leaves of at most 4,096 words that together hold 97,368 words (2.9 % of
// the bytes); 577 of them hold at most 512 words, 184 a single word.
//
// What bounds it: bytes.  13.65 MB read and 694 words written, 4.08 us at
// 3.35 TB/s.  What stands between a launch and that bound is latency: the
// launch, one round trip for the work list, one for the data.  The design:
//
// - A work list built on the host (ops/digest.py:digest_plan), cached with
//   the leaves' pointers, so a block finds its work with two 16-byte loads
//   of its own record and no search:
//       struct Item { ptr; begin; count; leaf; mode; slot; }   32 bytes
//   ptr the leaf's first element, [begin, begin + count) the item's words
//   counted from the leaf's start, leaf the digest's index in `out`, mode
//   the element kind (bits 0-3), the branch (bits 4-7) and the items its
//   leaf is cut into (bits 8-23), slot the split leaf's scratch slot or -1
//   when the item owns its leaf.  Block b < big sums item b with all its
//   256 threads; the blocks after them each take 8 small leaves (at most
//   512 words, whole), one warp a leaf, its lanes over the words.  The
//   slots follow the records in the same allocation.
// - Large leaves are cut into items of about equal bytes (multiples of 4
//   words), sized so that the grid is at most one wave: the card's SMs
//   times the kernel's resident blocks from the occupancy API.  Model A's
//   state takes ~1,000 blocks, 73 of them for its 577 small leaves.
// - The vector branch (4-byte kinds whose item starts 16-byte aligned, the
//   branch chosen on the host): four uint4 loads per thread issued before
//   the first multiply (64 bytes in flight a thread, 16 KB a block), loaded
//   evict-first (__ldcs: nothing reads the state again), each word's weight
//   stepped by kMul within a vector.  The scalar branch (views off 16 bytes,
//   2-, 1- and 8-byte kinds) issues eight word_at<K> loads a thread at
//   stride 256 before the first multiply.
// - No memset and one launch.  An item that owns its leaf writes out[leaf].
//   The items of a split leaf fold through their slot: one 64-bit
//   atomicAdd of (1 << 48) + partial, the ticket in bits 48-63, the exact
//   sum of the partials in bits 0-47 (each partial < 2^32, fewer than 2^16
//   of them: no carry reaches the ticket).  The atomicAdd that brings the
//   ticket to the leaf's item count returns every partial in its sum: that
//   item writes out[leaf] and stores 0 back to the slot.  The partial and
//   the ticket travel in one atomic, so no fence is needed between them.
// - Exact in any order: uint32 multiplies and adds wrap mod 2^32, and
//   addition mod 2^32 (the low 32 bits of the 48-bit sum) is associative
//   and commutative, so per-thread, per-warp, per-block and per-slot sums
//   give the bit-exact digest whatever the order in which blocks arrive.
// - Back to back on one stream the slots are safe: every slot is 0 when a
//   grid ends, and the next grid touches the work list and the slots only
//   after griddepcontrol.wait, i.e. after this grid has completed and its
//   writes are visible.  Two streams never share slots: the wrapper keys
//   its cached plans, slots included, by stream.
// - Programmatic dependent launch (pdl.cuh): the launch overlaps the tail
//   of the kernel before it, and each block lets the next launch begin once
//   its loads are out.

#include <cstdint>
#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecLoads = 4;     // uint4 loads a thread before multiplying
constexpr int kScalarLoads = 8;  // word_at loads a thread before multiplying
constexpr int kWarpLoads = 16;   // a warp's 512 words of a small leaf
constexpr uint32_t kMul = 2654435761u;
constexpr uint32_t kAdd = 0x9E3779B9u;

enum Kind : int { kB32 = 0, kU16 = 1, kI16 = 2, kU8 = 3, kI8 = 4,
                  kB64Lo = 5, kF64 = 6 };
enum Branch : int { kVec = 0, kScalar = 1, kWarp = 2 };

struct alignas(16) Item {
  const void* ptr;
  long long begin;
  int count;
  int leaf;
  int mode;
  int slot;
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

__device__ __forceinline__ uint32_t weight(uint32_t i) {
  return i * kMul + kAdd;
}

template <int K>
__device__ __forceinline__ uint32_t word_at(const void* p, int64_t i) {
  if (K == kB32) return static_cast<const uint32_t*>(p)[i];
  if (K == kU16) return static_cast<const uint16_t*>(p)[i];
  if (K == kI16)
    return static_cast<uint32_t>(
        static_cast<int32_t>(static_cast<const int16_t*>(p)[i]));
  if (K == kU8) return static_cast<const uint8_t*>(p)[i];
  if (K == kI8)
    return static_cast<uint32_t>(
        static_cast<int32_t>(static_cast<const int8_t*>(p)[i]));
  if (K == kB64Lo)
    return static_cast<uint32_t>(static_cast<const uint64_t*>(p)[i]);
  return __float_as_uint(__double2float_rn(static_cast<const double*>(p)[i]));
}

// This thread's share of a 4-byte item that starts 16-byte aligned.
__device__ __forceinline__ uint32_t item_vec(const Item& it) {
  const uint32_t* words = static_cast<const uint32_t*>(it.ptr) + it.begin;
  const uint4* v = reinterpret_cast<const uint4*>(words);
  const int nvec = it.count >> 2;
  const uint32_t w0 = weight(static_cast<uint32_t>(it.begin));
  uint32_t acc = 0;
  for (int base = threadIdx.x; base < nvec; base += kVecLoads * kThreads) {
    uint4 x[kVecLoads];
#pragma unroll
    for (int k = 0; k < kVecLoads; ++k) {
      const int j = base + k * kThreads;
      x[k] = j < nvec ? __ldcs(v + j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kVecLoads; ++k) {
      uint32_t w = w0 + 4u * static_cast<uint32_t>(base + k * kThreads) * kMul;
      acc += x[k].x * w;
      w += kMul;
      acc += x[k].y * w;
      w += kMul;
      acc += x[k].z * w;
      w += kMul;
      acc += x[k].w * w;
    }
  }
  const int tail = 4 * nvec + static_cast<int>(threadIdx.x);
  if (tail < it.count)  // the last count % 4 words of a leaf's last item
    acc += __ldcs(words + tail) *
           weight(static_cast<uint32_t>(it.begin + tail));
  return acc;
}

// This thread's share of any item, eight word_at<K> loads at a time.
template <int K>
__device__ __forceinline__ uint32_t item_scalar(const Item& it) {
  uint32_t acc = 0;
  for (int base = threadIdx.x; base < it.count;
       base += kScalarLoads * kThreads) {
    uint32_t x[kScalarLoads];
#pragma unroll
    for (int k = 0; k < kScalarLoads; ++k) {
      const int j = base + k * kThreads;
      x[k] = j < it.count ? word_at<K>(it.ptr, it.begin + j) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kScalarLoads; ++k)
      acc += x[k] * weight(static_cast<uint32_t>(it.begin + base +
                                                 k * kThreads));
  }
  return acc;
}

// This lane's share of a small leaf summed by one warp.
template <int K>
__device__ __forceinline__ uint32_t leaf_warp(const Item& it, int lane) {
  uint32_t acc = 0;
  for (int base = lane; base < it.count; base += kWarpLoads * 32) {
    uint32_t x[kWarpLoads];
#pragma unroll
    for (int k = 0; k < kWarpLoads; ++k) {
      const int j = base + 32 * k;
      x[k] = j < it.count ? word_at<K>(it.ptr, it.begin + j) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kWarpLoads; ++k)
      acc += x[k] * weight(static_cast<uint32_t>(it.begin + base + 32 * k));
  }
  return acc;
}

template <template <int> class F, typename... Args>
__device__ __forceinline__ uint32_t by_kind(int kind, Args... args) {
  switch (kind) {
    case kB32: return F<kB32>::run(args...);
    case kU16: return F<kU16>::run(args...);
    case kI16: return F<kI16>::run(args...);
    case kU8: return F<kU8>::run(args...);
    case kI8: return F<kI8>::run(args...);
    case kB64Lo: return F<kB64Lo>::run(args...);
    default: return F<kF64>::run(args...);
  }
}

template <int K>
struct Scalar {
  static __device__ __forceinline__ uint32_t run(const Item& it) {
    return item_scalar<K>(it);
  }
};

template <int K>
struct Warp {
  static __device__ __forceinline__ uint32_t run(const Item& it, int lane) {
    return leaf_warp<K>(it, lane);
  }
};

__device__ __forceinline__ uint32_t warp_sum(uint32_t acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    leaf_digest_kernel(const Item* __restrict__ plan, int big, int items,
                       uint32_t* __restrict__ out) {
  dasmtl_pdl::wait_prior_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (static_cast<int>(blockIdx.x) >= big) {  // small leaves, one a warp
    const int r = big + (static_cast<int>(blockIdx.x) - big) * kWarps + warp;
    if (r >= items) {
      dasmtl_pdl::allow_next_grid();
      return;
    }
    const Item it = load_item(plan + r);
    uint32_t acc = by_kind<Warp>(it.mode & 15, it, lane);
    dasmtl_pdl::allow_next_grid();
    acc = warp_sum(acc);
    if (lane == 0) out[it.leaf] = acc;
    return;
  }
  const Item it = load_item(plan + blockIdx.x);
  uint32_t acc = ((it.mode >> 4) & 15) == kVec
                     ? item_vec(it)
                     : by_kind<Scalar>(it.mode & 15, it);
  dasmtl_pdl::allow_next_grid();
  __shared__ uint32_t warp_sums[kWarps];
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int w = 1; w < kWarps; ++w) acc += warp_sums[w];
  if (it.slot < 0) {
    out[it.leaf] = acc;
    return;
  }
  // A split leaf: ticket and partial in one atomic (see the header).
  unsigned long long* slot =
      reinterpret_cast<unsigned long long*>(
          const_cast<Item*>(plan + items)) + it.slot;
  const unsigned long long add = (1ull << 48) | acc;
  const unsigned long long now = atomicAdd(slot, add) + add;
  if (static_cast<int>(now >> 48) == ((it.mode >> 8) & 0xFFFF)) {
    out[it.leaf] = static_cast<uint32_t>(now);
    *slot = 0ull;
  }
}

}  // namespace

// Resident blocks per SM of the kernel (the occupancy API, on the current
// device): ops/digest.py sizes the work list to one wave with it.
extern "C" int dasmtl_leaf_digest_blocks_per_sm(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, leaf_digest_kernel, kThreads, 0);
}

// plan: `items` 32-byte records (the last `small` of them small leaves, 8
// a block) followed by the split leaves' 8-byte slots, all on the card,
// the slots 0 between launches; out: L uint32 words, each written once.
// `pdl` launches with programmatic stream serialization (pdl.cuh).
extern "C" int dasmtl_leaf_digest(const void* plan, int items, int small,
                                  int L, uint32_t* out, int pdl,
                                  void* stream) {
  if (items < 1 || small < 0 || small > items || L < 1)
    return cudaErrorInvalidValue;
  const int big = items - small;
  const unsigned blocks =
      static_cast<unsigned>(big) + static_cast<unsigned>((small + kWarps - 1) /
                                                         kWarps);
  return dasmtl_pdl::launch_pdl(leaf_digest_kernel, dim3(blocks), kThreads,
                                static_cast<cudaStream_t>(stream), pdl != 0,
                                static_cast<const Item*>(plan), big, items,
                                out);
}
