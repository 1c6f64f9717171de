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
// where(has_real, new, old) with new = the stepped state.  Every warp reads
// the step's (F, B) weights and computes has_real[f] = (sum_b w[f, b]) > 0
// on the card, as JAX does; the weights are 0/1, so the order of the sum
// does not matter.
//
// What bounds it on this card: bytes when a fold is padded, the launch when
// none is.  A padded fold's pass reads and writes its state once (model
// A's train state is 13.65 MB: 8.15 us a pass at 3.35 TB/s); a normal step
// moves no state bytes, and each pass is one launch whose warps read the
// (F, B) weights (640 bytes at F = 5, B = 32) and exit.  The design:
//
// - A persistent grid of equal shares.  The grid is the resident block
//   count at this kernel's shared memory (1 block an SM), and the work
//   list (ops/fold_select.py:select_plan, built on the host and cached on
//   the card with the state's pointers) cuts one fold's state into bulk
//   chunks of at most kChunk bytes and thread pieces, and deals them out
//   one at a time to the block with the fewest bytes: every block's bytes
//   are within one chunk of the mean, and the blocks' n-th chunks lie side
//   by side, so the grid sweeps the state in one front, which the card's
//   memory serves faster than one contiguous range a block (12.2 against
//   13.4 us on an H100, the same kernel).  The records describe ONE fold's
//   layout, which every fold shares (the same model); each block walks its
//   share once for each padded fold.  32-byte records
//       struct Item { begin; snap; count; leaf; mode; pad; }
//   give a piece's first byte in its leaf, its first byte in a fold's
//   snapshot slice, its bytes, the leaf's column in the (F, L) table of
//   state pointers, and mode bit 0 (16-byte aligned in every fold).
// - Bulk chunks: 16-byte-aligned pieces, multiples of 16, of the leaves of
//   more than 2 KB aligned in every fold.  Warp 0 streams them through a
//   ring of kStages slots of kChunk bytes in shared memory: its lane 0
//   issues cp.async.bulk loads (completion on each slot's mbarrier)
//   kStages - 1 chunks ahead, and as each slot fills, a cp.async.bulk
//   store of it (one bulk group a chunk); before a slot is loaded again,
//   cp.async.bulk.wait_group.read waits for the store that last read it.
//   No register holds the data, and a block's whole share (about 103 KB
//   of model A's state) is in flight at once.  Both copies carry an L2
//   evict-first policy: the state and snapshot stream through once.
// - Head records: each block's first kHead chunks again, at a fixed place
//   a block, with their state addresses in every fold.  The work list is
//   written once, before any launch that reads it, so warp 0 loads them,
//   and every thread its span and first record, BEFORE it waits for the
//   grid before it: under PDL those loads overlap that grid's tail, and
//   once the mask is known lane 0 issues its loads without another trip
//   to memory.  Later chunks come 32 at a time, a record and a pointer a
//   lane, and lane 0 takes them with shuffles.
// - Thread pieces: each leaf's last count % 16 bytes, the leaves of at
//   most 2 KB, and every leaf misaligned in some fold, cut into pieces of
//   at most 256 bytes (64 when misaligned).  Warps 1-7 take one piece a
//   thread, 16-byte units where aligned, bytes otherwise, at the same time
//   as warp 0's ring.
// - A short prelude: every warp sums the weights itself (eight folds'
//   loads at once), so there is no __syncthreads and no shared memory
//   before the mask is known, and a block of a normal step (no padded
//   fold) exits at once.
// - Programmatic dependent launch (pdl.cuh): the launch overlaps the tail
//   of the kernel before it; each block lets the next launch begin once it
//   knows its folds.
// The launch goes on the caller's stream with no synchronisation, no
// allocation and no attribute call (the shared-memory attribute is set
// once, by dasmtl_fold_select_blocks_per_sm, which the wrapper calls
// before its first launch), so a CUDA graph captures it; the C entry point
// returns the cudaError_t.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWorkers = kThreads - 32;  // warps 1-7: the thread pieces
constexpr int kChunk = 16384;            // bytes of a ring slot
constexpr int kStages = 12;              // ring slots
constexpr int kRingBytes = kChunk * kStages;
constexpr int kBlocksPerSm = 1;  // one 192 KB ring an SM
constexpr int kPieceUnits = 16;  // 16-byte units of an aligned piece
constexpr int kHead = 8;         // bulk chunks a block has at hand
constexpr int kHeadFolds = 8;    // folds whose head addresses it preloads
constexpr int kMaxFolds = 32;    // folds in the warp's bit mask
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// The padded folds (sum_b w[f, b] not above 0), as a bit mask; every lane
// of the calling warp gets the same mask.  Eight folds' loads are issued
// together, so F <= 8 costs one trip to L2.
__device__ __forceinline__ unsigned padded_folds(const float* __restrict__ w,
                                                 int F, int B, int lane) {
  unsigned mask = 0u;
  for (int f0 = 0; f0 < F; f0 += 8) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int b = lane; b < B; b += 32) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (f0 + i < F) acc[i] += __ldg(w + (f0 + i) * B + b);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sum = warp_sum(acc[i]);
      if (f0 + i < F && !(sum > 0.f)) mask |= 1u << (f0 + i);
    }
  }
  return mask;
}

// -- the ring (warp 0) --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// An L2 policy that evicts the lines it touches first: the state and the
// snapshot stream through once (0.6 us off a padded pass on an H100).
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_load(char* dst, const char* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store(char* dst, const char* src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, %3;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes), "l"(policy)
      : "memory");
}

// Wait until at most N of this thread's bulk stores still read shared
// memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Where a record's bytes come from and go to in fold f.
struct Ends {
  unsigned long long src, dst;
};

__device__ __forceinline__ Ends ends(const Item& it,
                                     const unsigned long long* ptrs, int L,
                                     int f, char* snap, long long stride,
                                     int restore) {
  const unsigned long long state =
      __ldg(ptrs + static_cast<long long>(f) * L + it.leaf) +
      static_cast<unsigned long long>(it.begin);
  const unsigned long long kept = reinterpret_cast<unsigned long long>(
      snap + f * stride + it.snap);
  return restore ? Ends{kept, state} : Ends{state, kept};
}

// The work list on the card: `n` records, then one span a block, then
// kHead head records a block (its first bulk chunks, count 0 past its
// last), their state addresses in each of the F folds, and the (F, L)
// table of the folds' leaf pointers.
struct Plan {
  const Item* items;
  const int4* spans;
  const Item* heads;
  const unsigned long long* head_addrs;
  const unsigned long long* ptrs;
  int F, L;
};

__device__ __forceinline__ Plan plan_at(const Item* items, int n, int F,
                                        int L) {
  Plan p;
  p.items = items;
  p.spans = reinterpret_cast<const int4*>(items + n);
  p.heads = reinterpret_cast<const Item*>(p.spans + gridDim.x);
  p.head_addrs = reinterpret_cast<const unsigned long long*>(
      p.heads + gridDim.x * kHead);
  p.ptrs = p.head_addrs + static_cast<long long>(gridDim.x) * kHead * F;
  p.F = F;
  p.L = L;
  return p;
}

// A head record of warp 0's lane (lane < kHead) with its state address in
// the first kHeadFolds folds, loaded before the block waits for the grid
// before it: the work list is written once, before any launch that reads
// it, so those loads overlap the earlier grid's tail under PDL.
struct Head {
  Item it;
  unsigned long long state[kHeadFolds];
};

__device__ __forceinline__ Head load_head(const Plan& p, int lane) {
  Head h = {};
  if (lane < kHead) {
    const long long slot = static_cast<long long>(blockIdx.x) * kHead + lane;
    h.it = load_item(p.heads + slot);
#pragma unroll
    for (int f = 0; f < kHeadFolds; ++f)
      if (f < p.F) h.state[f] = __ldg(p.head_addrs + slot * p.F + f);
  }
  return h;
}

// Lane `lane`'s head chunk's state address in fold f.
__device__ __forceinline__ unsigned long long head_state(const Plan& p,
                                                         const Head& h,
                                                         int f, int lane) {
  unsigned long long a = 0;
#pragma unroll
  for (int g = 0; g < kHeadFolds; ++g)
    if (g == f) a = h.state[g];
  if (f >= kHeadFolds)
    a = __ldg(p.head_addrs +
              (static_cast<long long>(blockIdx.x) * kHead + lane) * p.F + f);
  return a;
}

// Warp 0: the block's bulk chunks [first, last) of the records, for every
// fold of `mask`, through the ring.  Lane 0 issues every copy; the lanes
// hold 32 chunks' sources, destinations and sizes for the shuffles, the
// first kHead from the head records.
__device__ __forceinline__ void ring_pass(const Plan& p, int first, int last,
                                          const Head& head, unsigned mask,
                                          char* snap, long long stride,
                                          int restore, int lane) {
  extern __shared__ __align__(128) char ring[];
  __shared__ uint64_t full[kStages];
  __shared__ unsigned long long slot_dst[kStages];
  __shared__ uint32_t slot_bytes[kStages];
  const int n = last - first;
  if (n <= 0) return;
  uint64_t policy = 0;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    policy = evict_first();
  }
  __syncwarp();
  // The producer's cursor: fold f (the lowest bit of m) and chunk j; lane
  // i holds chunk base + i of fold f.
  unsigned m = mask;
  int f = __ffs(static_cast<int>(m)) - 1, j = 0, base = 0;
  Ends mine = {0, 0};
  int count = 0;
  auto load_batch = [&]() {
    count = 0;
    if (base + lane >= n) return;
    if (base == 0 && lane < kHead) {
      const unsigned long long state = head_state(p, head, f, lane);
      const unsigned long long kept = reinterpret_cast<unsigned long long>(
          snap + f * stride + head.it.snap);
      mine = restore ? Ends{kept, state} : Ends{state, kept};
      count = head.it.count;
    } else {
      const Item it = load_item(p.items + first + base + lane);
      mine = ends(it, p.ptrs, p.L, f, snap, stride, restore);
      count = it.count;
    }
  };
  load_batch();
  int issued = 0, stored = 0;
  bool more = true;
  auto produce = [&]() {
    const int i = j - base;
    const unsigned long long src = __shfl_sync(0xffffffffu, mine.src, i);
    const unsigned long long dst = __shfl_sync(0xffffffffu, mine.dst, i);
    const uint32_t bytes =
        static_cast<uint32_t>(__shfl_sync(0xffffffffu, count, i));
    if (lane == 0) {
      const int s = issued % kStages;
      slot_dst[s] = dst;
      slot_bytes[s] = bytes;
      mbar_expect_tx(&full[s], bytes);
      bulk_load(ring + s * kChunk, reinterpret_cast<const char*>(src), bytes,
                &full[s], policy);
    }
    ++issued;
    if (++j == n) {
      m &= m - 1u;
      if (m == 0u) {
        more = false;
        return;
      }
      f = __ffs(static_cast<int>(m)) - 1;
      j = base = 0;
      load_batch();
    } else if (j - base == 32) {
      base = j;
      load_batch();
    }
  };
  for (int k = 0; k < kStages - 1 && more; ++k) produce();
  while (stored < issued) {
    const int s = stored % kStages;
    if (lane == 0) {
      mbar_wait(&full[s], static_cast<uint32_t>((stored / kStages) & 1));
      bulk_store(reinterpret_cast<char*>(slot_dst[s]), ring + s * kChunk,
                 slot_bytes[s], policy);
    }
    ++stored;
    if (more) {
      // The next load goes to the slot of chunk stored - 2, whose store
      // must have finished reading it; chunk stored - 1's may still run.
      if (lane == 0) bulk_wait_read<1>();
      produce();
    }
  }
  if (lane == 0) bulk_wait_all();
}

// -- the thread pieces (warps 1-7) --------------------------------------------

// Copy a piece of `count` bytes: 16-byte units when `vec` (both ends
// 16-byte aligned; at most kPieceUnits of them), loaded together before
// their stores, then the last count % 16 bytes; else byte by byte.
__device__ __forceinline__ void copy_piece(char* __restrict__ dst,
                                           const char* __restrict__ src,
                                           int count, bool vec) {
  int done = 0;
  if (vec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const int units = count >> 4;
    uint4 v[kPieceUnits];
#pragma unroll
    for (int k = 0; k < kPieceUnits; ++k)
      if (k < units) v[k] = s[k];
#pragma unroll
    for (int k = 0; k < kPieceUnits; ++k)
      if (k < units) d[k] = v[k];
    done = units << 4;
  }
#pragma unroll 8
  for (int j = done; j < count; ++j) dst[j] = src[j];
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    fold_select_kernel(const Item* __restrict__ items, int n_items, int F,
                       int L, char* __restrict__ snap, long long stride,
                       const float* __restrict__ w, int B, int restore) {
  const int lane = threadIdx.x & 31;
  const bool ring_warp = threadIdx.x < 32;
  const Plan p = plan_at(items, n_items, F, L);
  // The work list is not written by any grid this launch may overlap, so
  // the block reads its span, warp 0 its head records and their
  // addresses, and each other thread its first piece before it waits for
  // the grid before it (the weights and the state it may have written).
  const int4 span = __ldg(p.spans + blockIdx.x);
  const Head head = ring_warp ? load_head(p, lane) : Head{};
  const int r0 = span.y + static_cast<int>(threadIdx.x) - 32;
  Item first = {};
  if (!ring_warp && r0 < span.z) first = load_item(items + r0);
  dasmtl_pdl::wait_prior_grid();
  const unsigned mask = padded_folds(w, F, B, lane);
  dasmtl_pdl::allow_next_grid();
  if (mask == 0u) return;
  if (ring_warp) {
    ring_pass(p, span.x, span.y, head, mask, snap, stride, restore, lane);
    return;
  }
  for (int r = r0; r < span.z; r += kWorkers) {
    const Item it = r == r0 ? first : load_item(items + r);
    for (unsigned m = mask; m != 0u; m &= m - 1u) {
      const Ends e = ends(it, p.ptrs, L, __ffs(static_cast<int>(m)) - 1,
                          snap, stride, restore);
      copy_piece(reinterpret_cast<char*>(e.dst),
                 reinterpret_cast<const char*>(e.src), it.count,
                 (it.mode & 1) != 0);
    }
  }
}

// Let the kernel take kRingBytes of dynamic shared memory: once per device.
cudaError_t allow_ring(int dev) {
  static std::atomic<bool> done[kMaxDevices];
  if (done[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fold_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRingBytes);
  if (err != cudaSuccess) return err;
  done[dev].store(true, std::memory_order_relaxed);
  return cudaSuccess;
}

cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev < 0 || *dev >= kMaxDevices ? cudaErrorInvalidDevice
                                         : cudaSuccess;
}

}  // namespace

// plan: `items` 32-byte records, then `grid` 16-byte spans (one a block),
// `grid` x kHead head records, their (grid x kHead, F) state addresses and
// the (F, L) table of the folds' leaf pointers (8 bytes each), all on the
// card; snap: F slices of `stride` bytes; w: the step's (F, B) float32
// weights.  `restore` 0 saves the padded folds' state into `snap`, 1
// writes it back.  `pdl` launches with programmatic stream serialization
// (pdl.cuh).  One launch of `grid` blocks.
extern "C" int dasmtl_fold_select(const void* plan, int items, int grid,
                                  int F, int L, void* snap, long long stride,
                                  const float* w, int B, int restore, int pdl,
                                  void* stream) {
  if (items < 0 || grid < 1 || F < 1 || F > kMaxFolds || L < 1 || B < 1 ||
      stride < 0)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  err = allow_ring(dev);  // set by the occupancy query before any capture
  if (err != cudaSuccess) return err;
  return dasmtl_pdl::launch_pdl_smem(
      fold_select_kernel, dim3(static_cast<unsigned>(grid)), kThreads,
      kRingBytes, static_cast<cudaStream_t>(stream), pdl != 0,
      static_cast<const Item*>(plan), items, F, L, static_cast<char*>(snap),
      stride, w, B, restore);
}

// Resident blocks per SM of the kernel at its ring's shared memory (the
// occupancy API, on the current device), after allowing that shared
// memory: ops/fold_select.py sizes the persistent grid with it.
extern "C" int dasmtl_fold_select_blocks_per_sm(int* blocks) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  err = allow_ring(dev);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fold_select_kernel, kThreads, kRingBytes);
}
