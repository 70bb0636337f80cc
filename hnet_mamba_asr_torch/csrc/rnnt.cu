// The RNN-T (transducer) lattice, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the transducer loss to
// XLA (hnet_mamba_asr_tpu/ops/rnnt_loss.py:72-96, a lax.scan over frames
// with a log-space associative scan over labels inside each frame). In eager
// PyTorch that loop is ~10 launches a frame, and autograd's mirror of it,
// with T saved [B, U+1] rows; here it is one launch each way. The log-softmax
// over V+1 and the two gathers stay PyTorch ops around the kernels
// (ops/rnnt_cuda.py).
//
// Per batch row b, with T_b = clamp(feat_length, 1, T) (a row of
// feat_length 0 gives the value of feat_length 1, as in JAX) and
// U_b = clamp(target_length, 0, U), over the fp32 log-probs blank [B, T, U+1]
// and label [B, T, U]:
//
//   forward:   alpha[0, 0] = 0
//              alpha[t, u] = logaddexp(a, c),  a = alpha[t-1, u] + blank[t-1, u]
//                                              c = alpha[t, u-1] + label[t, u-1]
//              w[t, u] = exp(a - alpha[t, u])  (the share of the cell's mass
//                                              that came in by the blank)
//              loss_b = -(alpha[T_b-1, U_b] + blank[T_b-1, U_b])
//   backward:  the gradient of a transition is -g_b times the probability
//              that an alignment takes it (g_b: the loss's incoming
//              gradient). With gam[t, u] the probability that an alignment
//              passes through (t, u): gam[T_b-1, U_b] = 1 (its blank out of
//              the lattice), and walking back,
//              dblank[t, u] = -g_b gam[t+1, u] w[t+1, u]
//              dlabel[t, u] = -g_b gam[t, u+1] (1 - w[t, u+1])
//              gam[t, u]    = -(dblank[t, u] + dlabel[t, u]) / g_b
//              and exactly 0 outside the row's lattice (t >= T_b; u > U_b for
//              blank, u >= U_b for label), and for blank at t = T_b-1, u < U_b.
//
// Why the shares and not exp(alpha + beta - logP). alpha and beta are sums of
// T + U log-probs, as large as the loss (~5e3 at U 512), and each is rounded
// in fp32 at that size on every diagonal; the gradient exp(alpha + s + beta -
// logP) carries both roundings, which do not cancel (up to 7.6e-3 of the
// largest gradient against fp64 at B 2 T 300 U 512 on the H100). The shares
// w come from the difference of the two incoming terms of one cell, which is
// small, so no quantity as large as the loss enters the backward; the
// probabilities split at each cell by w and 1 - w and stay conserved: each frame's blank gradients sum to
// -g_b, as each label's do (chip_smoke.py phase 2 holds both sums).
//
// The forward stores w [B, T, U+1] for the backward (cells outside a row's
// lattice are not written and never read); the backward reads nothing else
// of the forward's inputs.
//
// What bounds it. The work is a few transcendental functions a lattice cell;
// the bytes are each cell's blank and label read once and w written once
// (forward), and w read and dblank, dlabel written once (backward): at B 32
// T 249 U 64 about 6 MB forward, ~2 us at 3.35 TB/s. The recurrence is a
// wavefront: the cells of one anti-diagonal d = t + u are independent, each
// diagonal depends on the one before. So the kernel is bound by latency,
// T_b + U_b dependent steps a row, not by bytes or operations.
//
// The design: one CTA per batch row, its threads striding over u, walks the
// anti-diagonals (forward from (0, 0), backward from (T_b-1, U_b)), one
// barrier per diagonal. The previous diagonal (alpha forward, gam backward)
// lives in shared memory, two buffers of U+1 floats that swap each step; the
// current cell reads its predecessors from there and its scores or shares
// from global memory. The backward writes both gradients of a cell on the
// diagonal where its gam is made, and zero-fills the cells outside the
// lattice itself, so every output element is written exactly once. No
// atomics: two calls give the same bits. No U cap from threads (they
// stride); the shared memory, 8 (U+1) bytes, caps U below 6144, which the
// wrapper checks.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1.0e30f;

// logaddexp(a, c), and the share exp(a - logaddexp(a, c)) of the first term
__device__ __forceinline__ float log_add_share(float a, float c, float* share) {
  const float e = expf(-fabsf(a - c));
  const float s = 1.0f / (1.0f + e);
  *share = a >= c ? s : e * s;
  return fmaxf(a, c) + log1pf(e);
}

__device__ __forceinline__ int row_frames(const int* feat_lens, int b, int T) {
  return min(max(feat_lens[b], 1), T);
}

__device__ __forceinline__ int row_labels(const int* tgt_lens, int b, int U) {
  return min(max(tgt_lens[b], 0), U);
}

__global__ void rnnt_fwd_kernel(const float* __restrict__ blank,
                                const float* __restrict__ label,
                                const int* __restrict__ feat_lens,
                                const int* __restrict__ tgt_lens,
                                float* __restrict__ share, float* __restrict__ loss,
                                int T, int U) {
  extern __shared__ float diag[];              // 2 x (U+1) alpha: previous, current
  const int b = blockIdx.x;
  const int U1 = U + 1;
  const int Tb = row_frames(feat_lens, b, T);
  const int Ub = row_labels(tgt_lens, b, U);
  const float* bl = blank + static_cast<size_t>(b) * T * U1;
  const float* lb = label + static_cast<size_t>(b) * T * U;
  float* w = share + static_cast<size_t>(b) * T * U1;
  float* prev = diag;
  float* cur = diag + U1;
  for (int d = 0; d <= Tb - 1 + Ub; ++d) {
    const int u_hi = min(d, Ub);
    for (int u = max(0, d - (Tb - 1)) + threadIdx.x; u <= u_hi; u += blockDim.x) {
      const int t = d - u;
      float v = 0.0f, s = 0.0f;
      if (d > 0) {
        const float a = t > 0 ? prev[u] + bl[static_cast<size_t>(t - 1) * U1 + u] : kNegInf;
        const float c = u > 0 ? prev[u - 1] + lb[static_cast<size_t>(t) * U + u - 1] : kNegInf;
        v = log_add_share(a, c, &s);
      }
      cur[u] = v;
      w[static_cast<size_t>(t) * U1 + u] = s;
    }
    __syncthreads();
    float* s = prev;
    prev = cur;
    cur = s;
  }
  if (threadIdx.x == 0) loss[b] = -(prev[Ub] + bl[static_cast<size_t>(Tb - 1) * U1 + Ub]);
}

__global__ void rnnt_bwd_kernel(const float* __restrict__ share,
                                const int* __restrict__ feat_lens,
                                const int* __restrict__ tgt_lens,
                                const float* __restrict__ grad,
                                float* __restrict__ dblank, float* __restrict__ dlabel,
                                int T, int U) {
  extern __shared__ float diag[];              // 2 x (U+1) gam: of d+1, of d
  const int b = blockIdx.x;
  const int U1 = U + 1;
  const int Tb = row_frames(feat_lens, b, T);
  const int Ub = row_labels(tgt_lens, b, U);
  const float* w = share + static_cast<size_t>(b) * T * U1;
  float* db = dblank + static_cast<size_t>(b) * T * U1;
  float* dl = dlabel + static_cast<size_t>(b) * T * U;
  // zeros outside the lattice (disjoint from the cells the walk writes)
  for (int i = threadIdx.x; i < T * U1; i += blockDim.x) {
    if (i / U1 >= Tb || i % U1 > Ub) db[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < T * U; i += blockDim.x) {
    if (i / U >= Tb || i % U >= Ub) dl[i] = 0.0f;
  }
  const float g = grad[b];
  float* prev = diag;
  float* cur = diag + U1;
  for (int d = Tb - 1 + Ub; d >= 0; --d) {
    const int u_hi = min(d, Ub);
    for (int u = max(0, d - (Tb - 1)) + threadIdx.x; u <= u_hi; u += blockDim.x) {
      const int t = d - u;
      const size_t i1 = static_cast<size_t>(t) * U1 + u;
      // through the blank to (t+1, u), or out of the lattice after (T_b-1, U_b)
      float via_blank = 0.0f;
      if (t < Tb - 1) {
        via_blank = prev[u] * w[i1 + U1];
      } else if (u == Ub) {
        via_blank = 1.0f;
      }
      float via_label = 0.0f;
      if (u < Ub) {
        via_label = prev[u + 1] * (1.0f - w[i1 + 1]);
        dl[static_cast<size_t>(t) * U + u] = -g * via_label;
      }
      db[i1] = (t == Tb - 1 && u != Ub) ? 0.0f : -g * via_blank;
      cur[u] = via_blank + via_label;
    }
    __syncthreads();
    float* s = prev;
    prev = cur;
    cur = s;
  }
}

size_t shared_bytes(int U) { return 2 * static_cast<size_t>(U + 1) * sizeof(float); }

}  // namespace

extern "C" {

// The largest U the kernels take (their two diagonals in 48 KB of shared
// memory, the default limit without an opt-in).
int hnet_rnnt_max_labels() { return static_cast<int>(48 * 1024 / (2 * sizeof(float))) - 1; }

int hnet_rnnt_fwd(const void* blank, const void* label, const void* feat_lens,
                  const void* tgt_lens, void* share, void* loss, int B, int T, int U,
                  int threads, void* stream) {
  rnnt_fwd_kernel<<<B, threads, shared_bytes(U), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank), static_cast<const float*>(label),
      static_cast<const int*>(feat_lens), static_cast<const int*>(tgt_lens),
      static_cast<float*>(share), static_cast<float*>(loss), T, U);
  return static_cast<int>(cudaGetLastError());
}

int hnet_rnnt_bwd(const void* share, const void* feat_lens, const void* tgt_lens,
                  const void* grad, void* dblank, void* dlabel, int B, int T, int U,
                  int threads, void* stream) {
  rnnt_bwd_kernel<<<B, threads, shared_bytes(U), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(share), static_cast<const int*>(feat_lens),
      static_cast<const int*>(tgt_lens), static_cast<const float*>(grad),
      static_cast<float*>(dblank), static_cast<float*>(dlabel), T, U);
  return static_cast<int>(cudaGetLastError());
}

const char* hnet_rnnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
