// Window gather: k windows of (h, w) cut out of a device-resident
// (C, T) f32 or bf16 record or ring at (k, 2) int32 origins, written as the
// (k, h, w, 1) contiguous conv input batch of the model's forward, in the
// record's dtype (a reduced preset's ring is bf16, as in JAX, whose
// dynamic_slice then cuts bf16 windows that the preset's forward takes).
//
// Replaces the device program the JAX package built by hand from lax in
// dasmtl/export.py:137-165 (make_resident_forward): a vmapped
// lax.dynamic_slice over the origin rows.  dynamic_slice never faults: a
// negative start counts once from the end of its axis (start + dim, JAX's
// allow_negative_indices default), then every start is CLAMPED into
// [0, dim - size].  This kernel does the same, and copies bit for bit:
//   out[j, y, x] = rec[c_j + y, t_j + x],
//   c_j = clamp(wrap(origins[j, 0], C), 0, C - h),
//   t_j = clamp(wrap(origins[j, 1], T), 0, T - w).
//
// What bounds it: bytes.  It reads k*h*w elements of the record and writes
// as many; no arithmetic beyond the index.  At the offline path's k = 256,
// 100x250 that is 51.2 MB in f32, about 15 us at 3.35 TB/s (25.6 MB, 7.6 us
// in bf16); the live tier's k = 16 moves 3.2 MB (1.6 MB), under 1 us, so
// there the launch and the first loads' latency weigh most.  A block per output row moves only 1,000 B and repeats a
// divide and two origin loads for it, so the design works on longer runs:
//
// Below, V is the elements in 16 bytes: 4 for f32, 8 for bf16.  Both
// dtypes run the same templated kernels; a bf16 element is copied as its
// 16-bit word, bit for bit.
//
// - Work unit: a RUN of r consecutive rows of one window (r = 4 unless a
//   very wide window must take fewer rows to fit shared memory).  Its output
//   is one contiguous stretch of rows * w elements; every run starts on a
//   16-byte boundary whenever h * w and r * w are multiples of V (100x250
//   is, in both dtypes).  At 100x250 a window is 25 runs, so the live tier's
//   k = 16 still gives 400 blocks work.
// - Loads, the bulk branch (T % V == 0 and a 16-byte aligned record): one
//   thread brings each source row's 16-byte aligned superset
//   [t0 & ~(V-1), round_up(t0 + w, V)) into shared memory with
//   cp.async.bulk (whose source, destination and size must all be
//   multiples of 16 bytes), completion on an mbarrier.  T % V == 0 keeps
//   the superset inside the record: round_up(t0 + w, V) <= T.
// - Stores: each thread realigns V consecutive outputs out of shared memory
//   (the shift t0 & (V-1)) and writes them as one 16-byte store; a window
//   shape whose runs do not start on 16 bytes stores one element at a time.
// - A persistent grid of one wave: resident blocks from the occupancy at
//   this shared-memory size x the SM count, each block walking
//   ceil(runs / resident) runs or one fewer: no ragged second wave.  A
//   block walks its runs through two shared-memory
//   buffers: the next run's bulk loads are in flight while the block
//   stores the current one.
// - The scalar branch, for what the bulk copy cannot take (T % V != 0, or a
//   record view whose data pointer is not 16-byte aligned): the same runs and
//   stores, loading straight from the record.
// - The rows branch, for a gather too small to give every SM a run (k <= 5
//   at 100x250): one block per output row, the shortest chain of dependent
//   loads, which is all such a gather costs.
// The wrapper chooses the branch and r from the shapes and the pointer
// before the launch.
//
// The launch goes on the caller's stream; the C entry point returns the
// cudaError_t of the launch.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDevices = 64;
// Shared memory one bulk block may take (two buffers); above 48 KB only
// after cudaFuncSetAttribute.
constexpr int kMaxBulkSmem = 96 * 1024;

// Elements of E in 16 bytes.
template <typename E>
constexpr int kVec = 16 / static_cast<int>(sizeof(E));

__device__ __forceinline__ int64_t start_index(int64_t o, int64_t dim,
                                               int64_t size) {
  if (o < 0) o += dim;
  return o < 0 ? 0 : (o > dim - size ? dim - size : o);
}

// E is float (f32) or uint16_t (a bf16 element's bits).
template <typename E>
struct Gather {
  const E* rec;
  int64_t C, T;
  const int32_t* origins;
  int h, w;
  int rows_per_run;      // r
  int runs_per_window;   // ceil(h / r)
  int64_t runs;          // k * runs_per_window
  int row_stride;        // shared-memory elements per row (bulk branch)
  E* out;
};

// Where run `run` lies: window j, first row y0, its rows, and its origin.
struct Run {
  int64_t j;
  int y0, rows;
  int64_t c0, t0;
};

template <typename E>
__device__ __forceinline__ Run locate(const Gather<E>& g, int64_t run) {
  Run r;
  // runs < 2^31 (checked at the launch): a 32-bit divide.
  const uint32_t q = static_cast<uint32_t>(run) /
                     static_cast<uint32_t>(g.runs_per_window);
  r.j = q;
  r.y0 = (static_cast<int>(run) - static_cast<int>(q) * g.runs_per_window) *
         g.rows_per_run;
  r.rows = min(g.rows_per_run, g.h - r.y0);
  r.c0 = start_index(g.origins[2 * r.j], g.C, g.h);
  r.t0 = start_index(g.origins[2 * r.j + 1], g.T, g.w);
  return r;
}

template <bool kGlobal, typename E>
__device__ __forceinline__ E load(const E* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// Copy one run: rows * w elements out of rows of `src` (`stride` elements
// apart, the window's first column at `shift`) to the contiguous `dst`.
template <bool kVecStore, bool kGlobal, typename E>
__device__ __forceinline__ void copy_run(const E* src, int64_t stride,
                                         int shift, int rows, int w, E* dst) {
  constexpr int V = kVec<E>;
  if constexpr (kVecStore) {
    const int n = rows * w;
    for (int q = threadIdx.x; q < n / V; q += kThreads) {
      int y = (V * q) / w;
      int x = V * q - y * w;
      union {
        uint4 u;
        E e[V];
      } v;
#pragma unroll
      for (int m = 0; m < V; ++m) {
        v.e[m] = load<kGlobal>(src + y * stride + shift + x);
        if (++x == w) {
          x = 0;
          ++y;
        }
      }
      reinterpret_cast<uint4*>(dst)[q] = v.u;
    }
  } else {
    for (int y = 0; y < rows; ++y)
      for (int x = threadIdx.x; x < w; x += kThreads)
        dst[y * w + x] = load<kGlobal>(src + y * stride + shift + x);
  }
}

template <typename E>
__device__ __forceinline__ E* run_output(const Gather<E>& g, const Run& r) {
  return g.out + (r.j * g.h + r.y0) * static_cast<int64_t>(g.w);
}

// -- the bulk branch ----------------------------------------------------------

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

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One thread: arm `bar` for run r's bytes and start its row copies.
template <typename E>
__device__ __forceinline__ void issue_run(const Gather<E>& g, const Run& r,
                                          E* buf, uint64_t* bar) {
  constexpr int64_t V = kVec<E>;
  const int64_t a0 = r.t0 & ~(V - 1);
  const uint32_t row_bytes = static_cast<uint32_t>(
      (((r.t0 + g.w + V - 1) & ~(V - 1)) - a0) * sizeof(E));
  mbar_expect_tx(bar, row_bytes * r.rows);
  const E* src = g.rec + (r.c0 + r.y0) * g.T + a0;
  for (int y = 0; y < r.rows; ++y)
    bulk_load(buf + y * g.row_stride, src + y * g.T, row_bytes, bar);
}

template <bool kVecStore, typename E>
__global__ void __launch_bounds__(kThreads) window_gather_bulk(Gather<E> g) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  E* const smem = reinterpret_cast<E*>(smem_bytes);
  __shared__ uint64_t full[2];
  const int buf_elems = g.rows_per_run * g.row_stride;
  int64_t run = blockIdx.x;
  Run cur = locate(g, run);
  // Thread 0 starts the first run's copies before the block's first
  // barrier: no other thread touches the mbarriers before it.
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue_run(g, cur, smem, &full[0]);
  }
  __syncthreads();
  for (int64_t i = 0; run < g.runs; ++i, run += gridDim.x) {
    const int b = static_cast<int>(i & 1);
    const int64_t next = run + gridDim.x;
    // Every thread locates the next run while the current one's copies
    // are in flight; buffer b ^ 1 was last read in iteration i - 1,
    // before its __syncthreads.
    Run nxt = cur;
    if (next < g.runs) {
      nxt = locate(g, next);
      if (threadIdx.x == 0)
        issue_run(g, nxt, smem + (b ^ 1) * buf_elems, &full[b ^ 1]);
    }
    mbar_wait(&full[b], static_cast<uint32_t>((i >> 1) & 1));
    copy_run<kVecStore, false>(smem + b * buf_elems,
                               static_cast<int64_t>(g.row_stride),
                               static_cast<int>(cur.t0 & (kVec<E> - 1)),
                               cur.rows, g.w, run_output(g, cur));
    __syncthreads();
    cur = nxt;
  }
}

// -- the scalar branch --------------------------------------------------------

template <bool kVecStore, typename E>
__global__ void __launch_bounds__(kThreads) window_gather_scalar(Gather<E> g) {
  for (int64_t run = blockIdx.x; run < g.runs; run += gridDim.x) {
    const Run r = locate(g, run);
    copy_run<kVecStore, true>(g.rec + (r.c0 + r.y0) * g.T + r.t0, g.T, 0,
                              r.rows, g.w, run_output(g, r));
  }
}

// -- the rows branch ----------------------------------------------------------

// A gather too small to give every SM a run (k * ceil(h / 4) < the SM count,
// k <= 5 at 100x250) is one chain of dependent loads, the origins then the
// record, and its length is the cost.  One 256-thread block per output row
// (j, y), one element load and store per thread, is the shortest chain, and
// measured faster there (f32) than runs of either branch.
constexpr int kRowThreads = 256;

template <typename E>
__global__ void window_gather_rows(const E* __restrict__ rec, int64_t C,
                                   int64_t T,
                                   const int32_t* __restrict__ origins, int h,
                                   int w, E* __restrict__ out) {
  const int64_t row = blockIdx.x;  // j * h + y
  const int64_t j = row / h;
  const int64_t y = row - j * h;
  const int64_t c0 = start_index(origins[2 * j], C, h);
  const int64_t t0 = start_index(origins[2 * j + 1], T, w);
  const E* src = rec + (c0 + y) * T + t0;
  E* dst = out + row * w;
  for (int x = threadIdx.x; x < w; x += blockDim.x) dst[x] = src[x];
}

// Let both bulk kernels of E take up to kMaxBulkSmem of dynamic shared
// memory: once per device.
template <typename E>
cudaError_t allow_bulk_smem(int dev) {
  static std::atomic<bool> done[kMaxDevices];
  if (done[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  void (*const kernels[])(Gather<E>) = {window_gather_bulk<true, E>,
                                        window_gather_bulk<false, E>};
  for (auto kernel : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBulkSmem);
    if (err != cudaSuccess) return err;
  }
  done[dev].store(true, std::memory_order_relaxed);
  return cudaSuccess;
}

// Blocks of `kernel` resident on the card at `smem` bytes of shared memory:
// its occupancy x the SM count, asked of the runtime once per device, kernel
// (`slot`) and shared-memory size in a row (a cache per element type).
template <typename E>
cudaError_t resident_blocks(void (*kernel)(Gather<E>), int slot, int smem,
                            int dev, int64_t* out) {
  static std::atomic<int64_t> cache[kMaxDevices][4];  // smem << 32 | blocks
  const int64_t hit = cache[dev][slot].load(std::memory_order_relaxed);
  if (hit != 0 && (hit >> 32) == smem) {
    *out = hit & 0xffffffff;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  *out = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  cache[dev][slot].store((static_cast<int64_t>(smem) << 32) | *out,
                         std::memory_order_relaxed);
  return cudaSuccess;
}

// One wave: at most the resident blocks, each walking ceil(runs / resident)
// runs.  Slots: 0-1 the scalar kernels, 2-3 the bulk ones (+1: 16-byte
// stores).
template <typename E>
cudaError_t launch(bool bulk, bool vec, const Gather<E>& g, int smem,
                   cudaStream_t s) {
  void (*const kernels[])(Gather<E>) = {
      window_gather_scalar<false, E>, window_gather_scalar<true, E>,
      window_gather_bulk<false, E>, window_gather_bulk<true, E>};
  const int slot = 2 * bulk + vec;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024) {
    err = allow_bulk_smem<E>(dev);
    if (err != cudaSuccess) return err;
  }
  int64_t resident = 0;
  err = resident_blocks<E>(kernels[slot], slot, smem, dev, &resident);
  if (err != cudaSuccess) return err;
  // Every block walks the same number of runs, give or take one.
  const int64_t per_block = (g.runs + resident - 1) / resident;
  const int64_t grid = (g.runs + per_block - 1) / per_block;
  kernels[slot]<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(g);
  return cudaGetLastError();
}

template <typename E>
int gather(const E* rec, int64_t C, int64_t T, const int32_t* origins, int k,
           int h, int w, E* out, int branch, int rows_per_run, void* stream) {
  constexpr int V = kVec<E>;
  if (h < 1 || w < 1 || h > C || w > T || k < 0 || rows_per_run < 1 ||
      branch < 0 || branch > 2)
    return cudaErrorInvalidValue;
  if (k == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (branch == 2) {
    const int64_t rows = static_cast<int64_t>(k) * h;
    if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
    window_gather_rows<E><<<static_cast<unsigned>(rows), kRowThreads, 0, s>>>(
        rec, C, T, origins, h, w, out);
    return cudaGetLastError();
  }
  Gather<E> g;
  g.rec = rec;
  g.C = C;
  g.T = T;
  g.origins = origins;
  g.h = h;
  g.w = w;
  g.rows_per_run = rows_per_run < h ? rows_per_run : h;
  g.runs_per_window = (h + g.rows_per_run - 1) / g.rows_per_run;
  g.runs = static_cast<int64_t>(k) * g.runs_per_window;
  if (g.runs > 0x7fffffffLL) return cudaErrorInvalidValue;
  // round_up(w + V - 1, V): the aligned superset of any shift.
  g.row_stride = (w + 2 * V - 2) / V * V;
  g.out = out;
  // 16-byte stores need every run to start on 16 bytes.
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                   (static_cast<int64_t>(h) * w) % V == 0 &&
                   (static_cast<int64_t>(g.rows_per_run) * w) % V == 0;
  if (branch == 0) return launch<E>(false, vec, g, 0, s);
  const int64_t smem =
      2LL * g.rows_per_run * g.row_stride * static_cast<int64_t>(sizeof(E));
  if (T % V != 0 || (reinterpret_cast<uintptr_t>(rec) & 15) != 0 ||
      smem > kMaxBulkSmem)
    return cudaErrorInvalidValue;
  return launch<E>(true, vec, g, static_cast<int>(smem), s);
}

}  // namespace

// rec is (C, T) row-major f32, origins (k, 2) int32, out (k, h, w) f32.
// Needs 1 <= h <= C and 1 <= w <= T.  branch: 0 the scalar branch, 1 the bulk
// branch (T % 4 == 0 and a 16-byte aligned record, else
// cudaErrorInvalidValue), 2 the rows branch; rows_per_run is r.  One launch.
extern "C" int dasmtl_window_gather(const float* rec, int64_t C, int64_t T,
                                    const int32_t* origins, int k, int h,
                                    int w, float* out, int branch,
                                    int rows_per_run, void* stream) {
  return gather<float>(rec, C, T, origins, k, h, w, out, branch,
                       rows_per_run, stream);
}

// The same for a bf16 record and bf16 output; the bulk branch needs
// T % 8 == 0 and a 16-byte aligned record.
extern "C" int dasmtl_window_gather_bf16(const __nv_bfloat16* rec, int64_t C,
                                         int64_t T, const int32_t* origins,
                                         int k, int h, int w,
                                         __nv_bfloat16* out, int branch,
                                         int rows_per_run, void* stream) {
  return gather<uint16_t>(reinterpret_cast<const uint16_t*>(rec), C, T,
                          origins, k, h, w, reinterpret_cast<uint16_t*>(out),
                          branch, rows_per_run, stream);
}
