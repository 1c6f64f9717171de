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
// What bounds it: bytes.  It reads C*(R - w_c) + C*w_c floats and writes
// C*R: about 2*C*R*4 bytes, 13.1 MB for a 100 x 16384 ring, about 3.9 us at
// 3.35 TB/s.  Its design: a 2-D grid, one row of blocks per channel and
// each block a 1024-column segment of it, 256 threads a block, 4 columns a
// thread at stride 256 so that a warp's loads and stores stay consecutive.
// Loads are not vectorised: the shift by w_c leaves the source unaligned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kSegment = kThreads * kPerThread;

__global__ void ring_append_kernel(const float* __restrict__ ring,
                                   const float* __restrict__ chunk, int64_t R,
                                   int64_t w_c, float* __restrict__ out) {
  const int64_t c = blockIdx.y;
  const int64_t keep = R - w_c;
  const float* src = ring + c * R + w_c;
  const float* add = chunk + c * w_c;
  float* dst = out + c * R;
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

}  // namespace

// ring and out are (C, R) row-major f32 and must not overlap; chunk is
// (C, w_c) f32 with 1 <= w_c <= R.
extern "C" int dasmtl_ring_append(const float* ring, const float* chunk,
                                  int64_t C, int64_t R, int64_t w_c,
                                  float* out, void* stream) {
  if (C < 1 || R < 1 || w_c < 1 || w_c > R || C > 65535)
    return cudaErrorInvalidValue;
  const int64_t segments = (R + kSegment - 1) / kSegment;
  if (segments > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(segments), static_cast<unsigned>(C));
  ring_append_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ring, chunk, R, w_c, out);
  return cudaGetLastError();
}
