// Ring append: one flushed chunk into a fiber's sliding-contiguous ring.
//
// Replaces the donated device program of dasmtl/stream/resident.py:127-132
// (ResidentFeed._append): jnp.roll(ring, -w_c, axis=1) followed by
// lax.dynamic_update_slice(ring, chunk, (0, R - w_c)).  The ring keeps the
// JAX layout -- column j holds absolute sample total - R + j -- so slot()
// and check_window() keep their absolute addressing and every retained
// window stays one contiguous slice for the window gather.
//
//   out[c, x] = ring[c, x + w_c]        for x <  R - w_c
//   out[c, x] = chunk[c, x - (R - w_c)] for x >= R - w_c
//
// An in-place left shift would read what it overwrites, so the kernel
// writes a second buffer and the caller swaps the two (ping-pong): the
// counterpart of JAX's donation.  Ordering against the gathers that read
// either buffer comes from the caller's stream.
//
// Two element types, one kernel: the ring is f32 (the f32 preset) or bf16
// (the bf16 and int8 presets stage their windows in bf16, and JAX's ring
// then holds bf16: ResidentFeed(dtype=ex.input_dtype)).  The append moves
// bits and does no arithmetic, so the bf16 entry copies them as 2-byte
// words, or as wider units of V words when every row of the three buffers
// starts on a multiple of V: V divides w_c and R (the source row starts w_c
// words into a ring row) and all three pointers are 2V-byte aligned.  The
// wrapper picks V (ops/ring.py:ring_plan), from the byte offsets and not
// the element count: at the live tier's w_c = 500 the shift is 1,000 bytes,
// a multiple of 8 but not of 16, so V = 4 (8-byte units); w_c = 1,000 gives
// V = 8 (16-byte units) and w_c = 125 V = 1.
//
// What bounds it: bytes.  It reads C*(R - w_c) + C*w_c elements and writes
// C*R: about 2*C*R*s bytes for s-byte elements, 13.1 MB for a 100 x 16384
// f32 ring (3.9 us at 3.35 TB/s), 26.2 MB for a 400 x 16384 bf16 ring (7.8
// us).  Its design: a 2-D grid, one row of blocks per channel and each
// block a 1024-unit segment of it, 256 threads a block, 4 units a thread at
// stride 256 so that a warp's loads and stores stay consecutive.  The f32
// entry copies 4-byte floats, unvectorised: its shift by w_c leaves the
// source unaligned in general.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kSegment = kThreads * kPerThread;

// R and w_c in units of U.
template <typename U>
__global__ void ring_append_kernel(const U* __restrict__ ring,
                                   const U* __restrict__ chunk, int64_t R,
                                   int64_t w_c, U* __restrict__ out) {
  const int64_t c = blockIdx.y;
  const int64_t keep = R - w_c;
  const U* src = ring + c * R + w_c;
  const U* add = chunk + c * w_c;
  U* dst = out + c * R;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSegment;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int64_t x = base + i * kThreads + threadIdx.x;
    if (x < keep) {
      dst[x] = src[x];
    } else if (x < R) {
      dst[x] = add[x - keep];
    }
  }
}

bool valid(int64_t C, int64_t R, int64_t w_c) {
  return C >= 1 && R >= 1 && w_c >= 1 && w_c <= R && C <= 65535 &&
         (R + kSegment - 1) / kSegment <= 0x7fffffffLL;
}

template <typename U>
int launch(const void* ring, const void* chunk, int64_t C, int64_t R,
           int64_t w_c, void* out, void* stream) {
  const int64_t segments = (R + kSegment - 1) / kSegment;
  const dim3 grid(static_cast<unsigned>(segments), static_cast<unsigned>(C));
  ring_append_kernel<U><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(ring), static_cast<const U*>(chunk), R, w_c,
      static_cast<U*>(out));
  return cudaGetLastError();
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

}  // namespace

// ring and out are (C, R) row-major f32 and must not overlap; chunk is
// (C, w_c) f32 with 1 <= w_c <= R.
extern "C" int dasmtl_ring_append(const float* ring, const float* chunk,
                                  int64_t C, int64_t R, int64_t w_c,
                                  float* out, void* stream) {
  if (!valid(C, R, w_c)) return cudaErrorInvalidValue;
  return launch<float>(ring, chunk, C, R, w_c, out, stream);
}

// The same for bf16 buffers, copied in units of `vec` bf16 words (1, 2, 4
// or 8): vec must divide w_c and R, and the three pointers must be 2*vec-
// byte aligned (else cudaErrorInvalidValue).
extern "C" int dasmtl_ring_append_bf16(const __nv_bfloat16* ring,
                                       const __nv_bfloat16* chunk, int64_t C,
                                       int64_t R, int64_t w_c,
                                       __nv_bfloat16* out, int vec,
                                       void* stream) {
  if (!valid(C, R, w_c) || (vec != 1 && vec != 2 && vec != 4 && vec != 8) ||
      R % vec != 0 || w_c % vec != 0 || !aligned(ring, 2 * vec) ||
      !aligned(chunk, 2 * vec) || !aligned(out, 2 * vec))
    return cudaErrorInvalidValue;
  const int64_t Rv = R / vec, wv = w_c / vec;
  switch (vec) {
    case 1:
      return launch<uint16_t>(ring, chunk, C, Rv, wv, out, stream);
    case 2:
      return launch<uint32_t>(ring, chunk, C, Rv, wv, out, stream);
    case 4:
      return launch<uint2>(ring, chunk, C, Rv, wv, out, stream);
    default:
      return launch<uint4>(ring, chunk, C, Rv, wv, out, stream);
  }
}
