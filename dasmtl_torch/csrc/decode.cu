// Decode tail of the serve forward: one launch per batch covers every head.
//
// Replaces the device program the JAX package built by hand from lax/jnp
// primitives and fused into its serve forward (dasmtl/export.py:112-126
// make_serve_infer_fn):
//   - log_softmax of each head        dasmtl/export.py:76-85 (make_infer_fn)
//   - first-max argmax -> int32       dasmtl/models/registry.py:41-49
//   - any non-finite log-prob -> bad  dasmtl/export.py:90-109 (nonfinite_rows)
// For each row and each head (at most 2 heads of at most 32 classes) it
// computes m, the max, and pred, the first index of the max (a NaN counts
// as the max, as in torch.argmax and jnp.argmax); then
// lp = (x - m) - log(sum(exp(x - m))), and over all heads of the row
// bad = any(!isfinite(lp)).  The log_softmax is idempotent on TwoLevelNet's
// log-prob heads; it is kept so the `log_probs_<i>` contract also holds for
// heads that emit raw logits.  NaN rows, -inf entries and all -inf rows
// come out as torch.log_softmax gives them (NaN rows and all -inf rows all
// NaN, a -inf entry -inf), so all of them are bad.
//
// What bounds it: the launch and one DRAM round trip.  The bytes -- each
// head read once, the log-probs written once, 4 B per head and 1 B per row
// besides -- are 4.9 KB for model A at B = 32 (heads 16 + 2), 1.5 ns at
// 3.35 TB/s; a launch costs ~2.5-3 us on the H100 (PERF.md) and a load from
// DRAM some 0.6-1 us.  So the design puts every load of the launch in
// flight at once and leaves a short chain behind it:
//
// - One warp per row, lane c of a head's lane segment on class c: one
//   coalesced load covers a head-row.  A segment is `span` lanes, a power
//   of two no narrower than the head.  Two heads whose spans fit 16 lanes
//   sit side by side in the warp, head 1 from lane `span` (model A: 16 + 2;
//   model B's single heads and model C's 32-wide head take one segment).  A
//   pair that does not fit (32 + 32, 17 + 16) takes a warp per head-row,
//   the row's two warps in one block, their bad flags joined through
//   shared memory.  Where both fit, packing is the faster: on model A's
//   heads at B = 16 to 256 the split layout measured 0.07-0.10 us slower a
//   launch (PERF.md).  The geometry comes from ops/decode.py:decode_plan.
// - Reductions are butterflies of __shfl_xor_sync over offsets span/2 .. 1,
//   which stay inside each aligned block of `span` lanes.  A padding lane
//   holds each reduction's identity: (-inf, index 32) for the argmax, 0 for
//   the sum, false for bad.  Every lane of a segment ends with bit-equal
//   results (IEEE addition commutes exactly), so each lane stores its own
//   log-prob with its own copy of log(sum): one coalesced store.
// - The argmax combine rule on (value, index) pairs: a NaN beats a non-NaN;
//   between two NaNs, or two equal values, the lower index wins; otherwise
//   the greater value wins.  That is the maximum under a total order, so it
//   is associative and commutative, and any butterfly order gives exactly
//   the serial loop's answer (the first index of the max, the first NaN if
//   any), which is jnp.argmax's and torch.argmax's.  The padding's
//   (-inf, 32) loses to every real lane, so an all -inf row gives index 0.
// - The sum: each lane takes expf(x - m), a butterfly adds them, one logf
//   follows, then lp = (x - m) - log_sum, the order of operations of the
//   serial version.  PyTorch's CUDA log_softmax sums these widths by the
//   same butterfly (one class a lane, offsets from half the padded width
//   down), so the two add in the same order.
// - Programmatic dependent launch (pdl.cuh): the launch overlaps the tail
//   of the kernel before it; griddepcontrol.wait comes before the first
//   load.
// The launch goes on the caller's stream; the C entry point returns the
// cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

constexpr int kMaxWidth = 32;
constexpr int kMaxWarps = 8;
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Heads {
  const float* x[2];
  float* lp[2];
  int32_t* pred[2];
  int width[2];
};

// True when (v2, i2) beats (v1, i1) under the argmax combine rule.
__device__ __forceinline__ bool beats(float v1, int i1, float v2, int i2) {
  const bool n1 = isnan(v1), n2 = isnan(v2);
  if (n1 != n2) return n2;
  if (n1 || v1 == v2) return i2 < i1;
  return v2 > v1;
}

// kSplit: a warp per head-row (two heads that do not fit one warp); else a
// warp per row, head 1 (if any) from lane `span`.
template <bool kSplit>
__global__ void __launch_bounds__(kMaxWarps * 32)
    decode_heads_kernel(Heads h, int n_heads, int span, int64_t rows,
                        bool* __restrict__ bad) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t task =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  int64_t r;
  int head, c;
  if (kSplit) {
    r = task >> 1;
    head = static_cast<int>(task & 1);
    c = lane;
  } else {
    r = task;
    head = n_heads > 1 && lane >= span ? 1 : 0;
    c = lane - head * span;
  }
  // Selects, not h.x[head]: a run-time index into the parameter struct
  // would copy it to local memory.
  const int w = head ? h.width[1] : h.width[0];
  const float* xh = head ? h.x[1] : h.x[0];
  const bool live = r < rows && c < w;
  dasmtl_pdl::wait_prior_grid();
  const float x = live ? xh[r * w + c] : neg_inf();
  dasmtl_pdl::allow_next_grid();

  float m = x;
  int arg = live ? c : kMaxWidth;
  for (int o = span >> 1; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFullWarp, m, o);
    const int arg2 = __shfl_xor_sync(kFullWarp, arg, o);
    if (beats(m, arg, m2, arg2)) {
      m = m2;
      arg = arg2;
    }
  }
  float sum = live ? expf(x - m) : 0.0f;
  for (int o = span >> 1; o > 0; o >>= 1)
    sum += __shfl_xor_sync(kFullWarp, sum, o);
  const float v = (x - m) - logf(sum);
  if (live) {
    (head ? h.lp[1] : h.lp[0])[r * w + c] = v;
    if (c == 0) (head ? h.pred[1] : h.pred[0])[r] = arg;
  }
  const bool any_bad = __any_sync(kFullWarp, live && !isfinite(v));
  if (kSplit) {
    __shared__ bool flags[kMaxWarps];
    if (lane == 0) flags[warp] = any_bad;
    __syncthreads();
    if (lane == 0 && head == 0 && r < rows) bad[r] = any_bad || flags[warp + 1];
  } else if (lane == 0 && r < rows) {
    bad[r] = any_bad;
  }
}

}  // namespace

// Head 1 is absent when x1 is null.  Every array is row-major contiguous:
// x_i and lp_i are (rows, w_i) f32, pred_i is (rows,) int32, bad (rows,)
// bool.  The geometry comes from ops/decode.py:decode_plan: `split` a warp
// per head-row (two heads only), else a warp per row; `span` the lanes of
// a head's segment (a power of two, at least every head's width, at most
// 16 when two heads share a warp); `warps` per block (1-8, even when
// split); `blocks` enough for every row.  `pdl` launches with programmatic
// stream serialization (pdl.cuh).
extern "C" int dasmtl_decode_heads(const float* x0, int w0, const float* x1,
                                   int w1, int64_t rows, float* lp0, float* lp1,
                                   int32_t* pred0, int32_t* pred1, bool* bad,
                                   int split, int span, int warps, int blocks,
                                   int pdl, void* stream) {
  const int n_heads = x1 == nullptr ? 1 : 2;
  if (w0 < 1 || w0 > kMaxWidth || (n_heads > 1 && (w1 < 1 || w1 > kMaxWidth)))
    return cudaErrorInvalidValue;
  const int widest = n_heads > 1 && w1 > w0 ? w1 : w0;
  if (span < widest || span > kMaxWidth || (span & (span - 1)) != 0 ||
      warps < 1 || warps > kMaxWarps || blocks < 1)
    return cudaErrorInvalidValue;
  if (split ? n_heads != 2 || warps % 2 != 0
            : n_heads == 2 && 2 * span > kMaxWidth)
    return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  if (static_cast<int64_t>(blocks) * warps < (split ? 2 * rows : rows))
    return cudaErrorInvalidValue;
  const Heads h{{x0, x1}, {lp0, lp1}, {pred0, pred1}, {w0, w1}};
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split)
    return dasmtl_pdl::launch_pdl(&decode_heads_kernel<true>, grid, 32 * warps,
                                  s, pdl, h, n_heads, span, rows, bad);
  return dasmtl_pdl::launch_pdl(&decode_heads_kernel<false>, grid, 32 * warps,
                                s, pdl, h, n_heads, span, rows, bad);
}

// ---------------------------------------------------------------------------
// event_prob_q: the resident live path's quantized event confidence.
//
// Replaces the tail of make_resident_serve_fn.serve_body
// (dasmtl/export.py:184-193):
//   event_prob_q = round(exp(max(log_probs_event, axis=-1)) * 2^20) as int32
// jnp.round rounds half to even, so this uses rintf (not roundf, which
// rounds half away from zero), and expf (not the faster __expf) to stay
// within one rounding of XLA's exp.  A NaN max gives 0.
//
// Why it stays a launch of its own: the only infer fn that emits
// log_probs_event is the analytic oracle (dasmtl_torch/stream/selftest.py:
// 30-58), which is plain PyTorch and emits its own bad_rows, so no kernel
// of the port runs between it and event_prob_q to fold it into: the
// decode tail never sees the oracle's heads.
//
// What bounds it: the launch and one DRAM round trip.  At the oracle's
// rungs (k <= 16 rows of 2 classes) it reads 128 B and writes 64 B, far
// under a nanosecond at 3.35 TB/s.  One thread per row, no early exit on a
// NaN, the row's loads two at a time, so the 2-wide event head issues both
// of its loads before the first compare.  At the launch floor the kernel's
// own code size shows: a float2 path and a loop unrolled over all 32
// classes were measured slower than this short loop (PERF.md).
// Programmatic dependent launch (pdl.cuh), griddepcontrol.wait before the
// first load.

namespace {

__global__ void event_prob_q_kernel(const float* __restrict__ lp, int width,
                                    int64_t rows, int32_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  dasmtl_pdl::wait_prior_grid();
  if (r >= rows) return;
  const float* row = lp + r * width;
  float m = neg_inf();
  bool nan = false;
  for (int j = 0; j < width; j += 2) {
    const float a = __ldg(row + j);
    const float b = j + 1 < width ? __ldg(row + j + 1) : neg_inf();
    nan |= isnan(a) || isnan(b);
    m = fmaxf(m, fmaxf(a, b));
  }
  dasmtl_pdl::allow_next_grid();
  const float q = rintf(expf(m) * 1048576.0f);
  out[r] = nan || isnan(q) ? 0 : static_cast<int32_t>(q);
}

}  // namespace

// lp is (rows, width) row-major f32, out (rows,) int32.  The geometry comes
// from ops/decode.py:prob_q_plan: `threads` per block (a multiple of 32, at
// most 256), `blocks` enough for every row.  `pdl` launches with
// programmatic stream serialization (pdl.cuh).
extern "C" int dasmtl_event_prob_q(const float* lp, int width, int64_t rows,
                                   int32_t* out, int threads, int blocks,
                                   int pdl, void* stream) {
  if (width < 1 || width > kMaxWidth || threads < 32 || threads > 256 ||
      threads % 32 != 0 || blocks < 1)
    return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  if (static_cast<int64_t>(blocks) * threads < rows)
    return cudaErrorInvalidValue;
  return dasmtl_pdl::launch_pdl(&event_prob_q_kernel,
                                dim3(static_cast<unsigned>(blocks)), threads,
                                static_cast<cudaStream_t>(stream), pdl, lp,
                                width, rows, out);
}
