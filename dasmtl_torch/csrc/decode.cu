// Decode tail of the serve forward: one launch per batch covers every head.
//
// Replaces the device program the JAX package built by hand from lax/jnp
// primitives and fused into its serve forward (dasmtl/export.py:112-126
// make_serve_infer_fn):
//   - log_softmax of each head        dasmtl/export.py:76-85 (make_infer_fn)
//   - first-max argmax -> int32       dasmtl/models/registry.py:41-49
//   - any non-finite log-prob -> bad  dasmtl/export.py:90-109 (nonfinite_rows)
// For each row and each head (at most 2 heads of at most 32 classes) it
// computes the max, the log-sum-exp, log_probs = x - max - log(sum), and the
// first index of the max (a NaN counts as the max, as in torch.argmax and
// jnp.argmax); over all heads of the row it writes
// bad = any(!isfinite(log_probs)).  The log_softmax is idempotent on
// TwoLevelNet's log-prob heads; it is kept so the `log_probs_<i>` contract
// also holds for heads that emit raw logits.
//
// What bounds it: bytes in principle -- each head is read once, the
// log-probs written once, 4 B per head and 1 B per row besides -- but at
// serving batch sizes (B <= 32, widths 16 and 2) that is a few KB, far under
// a microsecond at HBM rate, so the kernel is launch-bound.  Its design is
// therefore the simplest one: one thread per row, the row's few classes in a
// loop, and ONE launch for all heads so the count stays at 1 per forward.
// The launch goes on the caller's stream; the C entry point returns the
// cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWidth = 32;

struct Head {
  const float* x;
  int width;
  float* lp;
  int32_t* pred;
};

__device__ bool decode_row(const float* x, int w, float* lp, int32_t* pred) {
  float m = x[0];
  int arg = 0;
  bool nan = isnan(m);
  for (int c = 1; c < w && !nan; ++c) {
    const float v = x[c];
    if (isnan(v)) {
      nan = true;
      m = v;
      arg = c;
    } else if (v > m) {
      m = v;
      arg = c;
    }
  }
  *pred = arg;
  float sum = 0.0f;
  for (int c = 0; c < w; ++c) sum += expf(x[c] - m);
  const float log_sum = logf(sum);
  bool bad = false;
  for (int c = 0; c < w; ++c) {
    const float v = x[c] - m - log_sum;
    lp[c] = v;
    bad |= !isfinite(v);
  }
  return bad;
}

__global__ void decode_heads_kernel(Head h0, Head h1, int n_heads,
                                    int64_t rows, bool* __restrict__ bad) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  bool b = decode_row(h0.x + r * h0.width, h0.width, h0.lp + r * h0.width,
                      h0.pred + r);
  if (n_heads > 1) {
    b |= decode_row(h1.x + r * h1.width, h1.width, h1.lp + r * h1.width,
                    h1.pred + r);
  }
  bad[r] = b;
}

}  // namespace

// Head 1 is absent when x1 is null.  Every array is row-major contiguous:
// x_i and lp_i are (rows, w_i) f32, pred_i is (rows,) int32, bad (rows,) bool.
extern "C" int dasmtl_decode_heads(const float* x0, int w0, const float* x1,
                                   int w1, int64_t rows, float* lp0, float* lp1,
                                   int32_t* pred0, int32_t* pred1, bool* bad,
                                   void* stream) {
  const int n_heads = x1 == nullptr ? 1 : 2;
  if (w0 < 1 || w0 > kMaxWidth || (n_heads > 1 && (w1 < 1 || w1 > kMaxWidth)))
    return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  const Head h0{x0, w0, lp0, pred0};
  const Head h1{x1, w1, lp1, pred1};
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  decode_heads_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(h0, h1, n_heads,
                                                             rows, bad);
  return cudaGetLastError();
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
// It is its own launch, after the decode tail and not folded into it: the
// log_probs_event head it reads is produced only by an infer fn that names
// its heads so (the analytic oracle), which does not go through
// decode_heads.  Launch-bound at every size it sees (k <= 256 rows of 2
// classes: 2 KB), so one thread per row is the whole design.

namespace {

__global__ void event_prob_q_kernel(const float* __restrict__ lp, int width,
                                    int64_t rows, int32_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* x = lp + r * width;
  float m = x[0];
  for (int c = 1; c < width && !isnan(m); ++c) {
    const float v = x[c];
    if (isnan(v) || v > m) m = v;
  }
  const float q = rintf(expf(m) * 1048576.0f);
  out[r] = isnan(q) ? 0 : static_cast<int32_t>(q);
}

}  // namespace

// lp is (rows, width) row-major f32, out (rows,) int32.
extern "C" int dasmtl_event_prob_q(const float* lp, int width, int64_t rows,
                                   int32_t* out, void* stream) {
  if (width < 1 || width > kMaxWidth) return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  event_prob_q_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(lp, width, rows,
                                                             out);
  return cudaGetLastError();
}
