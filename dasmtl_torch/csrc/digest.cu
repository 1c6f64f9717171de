// Leaf digest: one order-sensitive uint32 fingerprint per tensor, for every
// tensor of a train state, in one kernel launch.
//
// Replaces dasmtl/analysis/sanitize/fingerprint.py:62-73 (leaf_digest), which
// digest_vector (:76-81) stacks over the leaves of a state, reading each
// leaf's bits as uint32 words (_as_uint32_words, :41-59):
//
//   digest = sum_i words[i] * (i * 2654435761 + 0x9E3779B9)   mod 2^32
//
// uint32 multiply and add wrap mod 2^32 by definition, and addition mod 2^32
// is associative and commutative, so per-thread, per-warp and per-block
// partial sums combined by atomicAdd give the bit-exact result in any order.
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
// The leaves arrive as one int64 table on the card:
//   ptr[L] | words[L] | first_block[L + 1] | kind[L]
// first_block is the exclusive prefix sum of ceil(words / kChunk): block b
// works on the leaf l with first_block[l] <= b < first_block[l + 1], found by
// binary search, and on that leaf's words [(b - first_block[l]) * kChunk,
// + kChunk).  The caller zeroes nothing: the entry point clears the L output
// words with cudaMemsetAsync on the same stream before the launch.
//
// What bounds it: bytes.  Model A's train state is ~3.41 M words (13.65 MB):
// ~4.1 us at 3.35 TB/s.  The design: 256 threads a block, 16 words a thread
// at stride 256 (a warp reads 128 consecutive bytes of a 4-byte leaf), a
// warp reduction with __shfl_down_sync, one atomicAdd a block.  Small leaves
// (a bias of 16 words) take one block each, so the ~550 leaves of the state
// cost ~550 mostly idle blocks beside the ~830 full ones.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int64_t kChunk = kThreads * kPerThread;
constexpr uint32_t kMul = 2654435761u;
constexpr uint32_t kAdd = 0x9E3779B9u;

enum Kind : int64_t { kB32 = 0, kU16 = 1, kI16 = 2, kU8 = 3, kI8 = 4,
                      kB64Lo = 5, kF64 = 6 };

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

template <int K>
__device__ __forceinline__ uint32_t chunk_sum(const void* p, int64_t begin,
                                              int64_t end) {
  uint32_t acc = 0;
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    acc += word_at<K>(p, i) * (static_cast<uint32_t>(i) * kMul + kAdd);
  }
  return acc;
}

__global__ void leaf_digest_kernel(const int64_t* __restrict__ table, int L,
                                   uint32_t* __restrict__ out) {
  const int64_t* ptrs = table;
  const int64_t* words = table + L;
  const int64_t* first_block = table + 2 * L;
  const int64_t* kinds = table + 3 * L + 1;
  const int64_t b = blockIdx.x;

  int lo = 0, hi = L - 1;  // the largest l with first_block[l] <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (first_block[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int64_t begin = (b - first_block[lo]) * kChunk;
  const int64_t end =
      begin + kChunk < words[lo] ? begin + kChunk : words[lo];
  const void* p = reinterpret_cast<const void*>(ptrs[lo]);

  uint32_t acc;
  switch (kinds[lo]) {
    case kB32: acc = chunk_sum<kB32>(p, begin, end); break;
    case kU16: acc = chunk_sum<kU16>(p, begin, end); break;
    case kI16: acc = chunk_sum<kI16>(p, begin, end); break;
    case kU8: acc = chunk_sum<kU8>(p, begin, end); break;
    case kI8: acc = chunk_sum<kI8>(p, begin, end); break;
    case kB64Lo: acc = chunk_sum<kB64Lo>(p, begin, end); break;
    default: acc = chunk_sum<kF64>(p, begin, end); break;
  }

  __shared__ uint32_t warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) atomicAdd(&out[lo], acc);
  }
}

}  // namespace

// table: the (4L + 1) int64 layout above, on the card; blocks =
// first_block[L], which the caller computed on the host (>= 1); out: L
// uint32 words, cleared here.
extern "C" int dasmtl_leaf_digest(const int64_t* table, int L, int64_t blocks,
                                  uint32_t* out, void* stream) {
  if (L < 1 || blocks < 1 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * L, s);
  if (err != cudaSuccess) return err;
  leaf_digest_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      table, L, out);
  return cudaGetLastError();
}
