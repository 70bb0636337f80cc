// The RNN-T (transducer) loss from the joint's logits, forward and backward,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the transducer loss to
// XLA (hnet_mamba_asr_tpu/ops/rnnt_loss.py:34-111: the fp32 log-softmax over
// the logits, the gathers of the blank and target columns, and a lax.scan
// over frames with a log-space associative scan over labels inside each
// frame). Here the whole function is four launches: two forward, two
// backward.
//
// Per batch row b, with T_b = clamp(feat_length, 1, T) (a row of
// feat_length 0 gives the value of feat_length 1, as in JAX) and
// U_b = clamp(target_length, 0, U), over the logits x [B, T, U+1, V] (bf16 or
// fp32; rows ld elements apart, so the joint GEMM's output padded past V is
// read in place), targets y clipped to [0, V):
//
//   lse[t, u]   = log sum_v exp(x[t, u, v])                   (fp32)
//   blank(t, u) = x[t, u, blank_id] - lse[t, u]
//   label(t, u) = x[t, u, y_u] - lse[t, u]                    (u < U_b)
//   forward:   alpha[0, 0] = 0
//              alpha[t, u] = logaddexp(a, c),  a = alpha[t-1, u] + blank(t-1, u)
//                                              c = alpha[t, u-1] + label(t, u-1)
//              w[t, u] = exp(a - alpha[t, u])  (the share of the cell's mass
//                                              that came in by the blank)
//              loss_b = -(alpha[T_b-1, U_b] + blank(T_b-1, U_b))
//   backward:  with g_b the loss's incoming gradient and gam[t, u] the
//              probability that an alignment passes through (t, u):
//              gam[T_b-1, U_b] = 1 (its blank out of the lattice), and
//              walking back,
//              cb[t, u]  = -g_b gam[t+1, u] w[t+1, u]          (d loss / d blank)
//              cl[t, u]  = -g_b gam[t, u+1] (1 - w[t, u+1])    (d loss / d label)
//              gam[t, u] = -(cb[t, u] + cl[t, u]) / g_b
//              cb = 0 for t = T_b-1, u < U_b; cl = 0 for u = U_b; both 0
//              outside the lattice (t >= T_b or u > U_b), and
//              dlogit[t, u, v] = cb 1{v = blank_id} + cl 1{v = y_u}
//                                - softmax(x[t, u])[v] (cb + cl)
//              in the logits' dtype, exactly 0 outside the lattice and in
//              the columns from V to ld.
//
// Why the shares and not exp(alpha + beta - logP): alpha and beta are sums
// of T + U log-probs, as large as the loss, rounded in fp32 at that size on
// every diagonal; their sum carries both roundings into every gradient. The
// shares come from the difference of the two incoming terms of one cell, so
// nothing as large as the loss enters the backward, and the probabilities
// split at each cell by w and 1 - w and stay conserved: each frame's cb sum
// to -g_b, as each label's cl do (chip_smoke.py phase 2 holds both sums).
//
// What bounds it. The function reads the logits of every lattice cell once
// forward, and again backward where it writes dlogits once over the whole
// buffer: at bf16 B 32 T 249 U 64 V 501 (the training micro-batch) ~0.3 GB
// forward and ~0.8 GB backward (tools/measure.py::rnnt_cost /
// rnnt_bwd_cost), a few operations a logit: bound by bytes. The lattice
// recurrence itself moves ~10 MB but is a wavefront of T_b + U_b dependent
// diagonals a row: bound by latency.
//
// The design, four launches:
// - rnnt_fwd_scores / rnnt_bwd_dlogits, the passes over the logits, spread
//   over every SM: a warp (the forward: a half-warp, where 16 lanes hold a
//   row) per (b, t, u) row of V logits, as many CTAs as the card holds at
//   once striding over the rows, the next row loaded while the current one
//   is reduced or written. 16-byte loads where the row pointer and the row
//   stride allow them, else element loads. The forward pass takes the
//   row's fp32 log-sum-exp (a lane's max and sum, then the row's), writes
//   lse and the cell's two scores; the backward pass recomputes the
//   softmax from the logits and lse and writes the row of dlogits (zeros
//   for rows outside the lattice, where it also writes the coefficients'
//   zeros). Both are bound more by their instructions a row than by bytes
//   (PERF.md, section 6).
// - rnnt_fwd_walk / rnnt_bwd_walk, the wavefront: for U + 1 <= 256 one warp
//   walks a row, kWalkRows rows a CTA, no barrier: the diagonal lives in
//   registers, lane l holding the K consecutive cells u = l K + k, the one
//   neighbour in another lane taken by a shuffle. The scores (forward) and
//   shares (backward) a diagonal needs do not depend on the walk, so a ring
//   of kRing diagonals of them comes into shared memory by cp.async ahead
//   of the walk: no global load sits on the dependent chain. Each lane
//   copies the values it will read itself, so the ring needs no barrier.
//   Beyond 256 cells a diagonal, one CTA walks a row with the previous
//   diagonal in shared memory and one barrier a diagonal, the next
//   diagonal's values loaded into registers ahead (U <= 6143).
// - Scores, shares and coefficients are stored by anti-diagonal,
//   [B, T+U, U+1] with cell (t, u) at [b, t+u, u], so a diagonal is
//   contiguous: the walks' loads and stores are coalesced. lse is
//   [B, T, U+1].
// No atomics: two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreads = 256;   // the row passes: 8 warps a CTA, a warp per row
constexpr int kUnroll = 4;         // 16-byte loads a lane has in flight in a row pass
constexpr int kWalkRows = 4;       // the warp walk: batch rows (warps) a CTA
constexpr int kRing = 8;           // diagonals a walking warp has in flight
constexpr int kMaxK = 8;           // cells a lane holds in the warp walk: U + 1 <= 256
constexpr int kMaxCtaThreads = 1024;
constexpr int kMaxKC = 6;          // cells a thread holds in the CTA walk: U + 1 <= 6144

// A logit by storage type: fp32, or bf16 as its 16 bits; 16 bytes of them.
template <typename S> struct Elem;
template <> struct Elem<float> {
  static constexpr int kPerVec = 4;
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float put(float v) { return v; }
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Elem<uint16_t> {
  static constexpr int kPerVec = 8;
  static __device__ __forceinline__ float get(uint16_t v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  static __device__ __forceinline__ uint16_t put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = static_cast<uint32_t>(put(f[2 * i])) |
             (static_cast<uint32_t>(put(f[2 * i + 1])) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ int row_frames(const int* feat_lens, int b, int T) {
  return min(max(feat_lens[b], 1), T);
}

__device__ __forceinline__ int row_labels(const int* tgt_lens, int b, int U) {
  return min(max(tgt_lens[b], 0), U);
}

// cell (t, u) of row b in the anti-diagonal layout [B, T+U, U+1]
__device__ __forceinline__ size_t skew(int b, int t, int u, int T, int U) {
  return (static_cast<size_t>(b) * (T + U) + t + u) * (U + 1) + u;
}

// 2^x (2 ulp; results below 2^-126, and -inf, give 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// logaddexp(a, c), and the share exp(a - logaddexp(a, c)) of the first term
__device__ __forceinline__ float log_add_share(float a, float c, float* share) {
  const float e = exp2_ftz(-fabsf(a - c) * kLog2e);
  const float s = __fdividef(1.0f, 1.0f + e);
  *share = a >= c ? s : e * s;
  return fmaxf(a, c) + __logf(1.0f + e);
}

// (m, s) <- the online max and sum of exp(x - m) of both sets
__device__ __forceinline__ void lse_merge(float& m, float& s, float om, float os) {
  const float nm = fmaxf(m, om);
  s = (m == nm ? s : s * exp2_ftz((m - nm) * kLog2e)) +
      (om == nm ? os : os * exp2_ftz((om - nm) * kLog2e));
  m = nm;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 bytes global -> shared, or 4 zero bytes (nothing read) when !pred
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A (b, t, u) row of the logits, r = (b T + t)(U+1) + u, stepped through a
// warp's stride of the rows without a division per row.
struct Cell {
  long long r;
  int b, t, u;
};

__device__ __forceinline__ Cell cell_at(long long r, int T, int U1) {
  const long long bt = r / U1;
  return Cell{r, static_cast<int>(bt / T), static_cast<int>(bt % T), static_cast<int>(r % U1)};
}

// c + s, s the stride decomposed as a Cell (s.t < T, s.u < U+1)
__device__ __forceinline__ void advance(Cell& c, const Cell& s, int T, int U1) {
  c.r += s.r;
  c.u += s.u;
  const int cu = c.u >= U1;
  c.u -= cu * U1;
  c.t += s.t + cu;
  const int ct = c.t >= T;
  c.t -= ct * T;
  c.b += s.b + ct;
}

__device__ __forceinline__ bool in_lattice(const Cell& c, int T, int U,
                                           const int* __restrict__ feat_lens,
                                           const int* __restrict__ tgt_lens) {
  return c.t < row_frames(feat_lens, c.b, T) && c.u <= row_labels(tgt_lens, c.b, U);
}

// the first cell at or after c in the stride that lies in its row's
// lattice (c.r >= rows: none)
__device__ __forceinline__ void next_cell(Cell& c, const Cell& s, long long rows, int T, int U,
                                          const int* __restrict__ feat_lens,
                                          const int* __restrict__ tgt_lens) {
  while (c.r < rows && !in_lattice(c, T, U, feat_lens, tgt_lens)) advance(c, s, T, U + 1);
}

// the cell's target id (clipped), or -1 at u = U_b (no label leaves it)
__device__ __forceinline__ int cell_target(const Cell& c, int U, int V,
                                           const int* __restrict__ targets,
                                           const int* __restrict__ tgt_lens) {
  return c.u < row_labels(tgt_lens, c.b, U)
             ? min(max(targets[static_cast<size_t>(c.b) * U + c.u], 0), V - 1)
             : -1;
}

// 16-byte vectors i0 + L j + lane (j < kUnroll) of a row of n, 0 past n:
// the chunk of a row that L lanes take
template <int L = 32>
__device__ __forceinline__ void load_chunk(const uint4* __restrict__ xv, int n, int i0, int lane,
                                           uint4 (&buf)[kUnroll]) {
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int i = i0 + L * j + lane;
    buf[j] = i < n ? __ldg(xv + i) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// fold the logits of a chunk (vectors i0 + 32 j + lane, columns < V) into
// the lane's online max and sum: the chunk's max, then one exp a logit
template <typename S, int L = 32>
__device__ __forceinline__ void lse_chunk(const uint4 (&buf)[kUnroll], int nvec, int V, int i0,
                                          int lane, float& m, float& s) {
  constexpr int E = Elem<S>::kPerVec;
  float f[kUnroll][E];
  float cm = -INFINITY;
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    if (i0 + L * j >= nvec) break;   // all L lanes: no vector of the row left
    const int i = i0 + L * j + lane;
    Elem<S>::unpack(buf[j], f[j]);
    if (i >= nvec || (i + 1) * E > V) {   // columns past V (or past the row): -inf
#pragma unroll
      for (int e = 0; e < E; ++e) f[j][e] = i * E + e < V && i < nvec ? f[j][e] : -INFINITY;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) cm = fmaxf(cm, f[j][e]);
  }
  if (cm == -INFINITY) return;   // the lane holds no column of the chunk
  float cs = 0.0f;
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    if (i0 + L * j >= nvec) break;
#pragma unroll
    for (int e = 0; e < E; ++e) cs += exp2_ftz((f[j][e] - cm) * kLog2e);
  }
  lse_merge(m, s, cm, cs);
}

// the log-sum-exp of a row from the online max and sum of each of its L
// lanes (a warp, or a half-warp): the max over the lanes, then the lanes'
// sums scaled to it (each of the L lanes returns it, bitwise the same)
template <int L = 32>
__device__ __forceinline__ float warp_lse(float m, float s) {
  float wm = m;
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) wm = fmaxf(wm, __shfl_xor_sync(kFull, wm, off));
  s = m == wm ? s : s * exp2_ftz((m - wm) * kLog2e);
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return wm + logf(s);
}

// ---- forward: logits -> lse and the lattice scores --------------------------------
// L lanes take a row: a half-warp where a row's 16-byte vectors fit one
// chunk of 16 lanes (a warp then reduces two rows at once), else a warp.
// Each takes the lattice cells of its stride in turn, with 16-byte rows the
// next cell's first chunk (and its target id) loaded while the current row
// is reduced; without them (kVec false, L 32) element loads.
template <typename S, bool kVec, int L>
__global__ void __launch_bounds__(kRowThreads) rnnt_fwd_scores_kernel(
    const S* __restrict__ logits, long long ld, int V, int blank_id,
    const int* __restrict__ targets, const int* __restrict__ feat_lens,
    const int* __restrict__ tgt_lens, int B, int T, int U, float* __restrict__ lse,
    float* __restrict__ sblank, float* __restrict__ slabel) {
  const int lane = threadIdx.x & (L - 1);
  const int U1 = U + 1;
  const long long rows = static_cast<long long>(B) * T * U1;
  const long long slots = static_cast<long long>(gridDim.x) * (kRowThreads / L);
  const Cell step = cell_at(slots, T, U1);
  Cell c = cell_at(static_cast<long long>(blockIdx.x) * (kRowThreads / L) + (threadIdx.x / L),
                   T, U1);
  auto finish = [&](const Cell& q, const S* x, float l, int y) {
    if (lane == 0) {
      lse[q.r] = l;
      sblank[skew(q.b, q.t, q.u, T, U)] = Elem<S>::get(x[blank_id]) - l;
    } else if (lane == 1 && y >= 0) {
      slabel[skew(q.b, q.t, q.u, T, U)] = Elem<S>::get(x[y]) - l;
    }
  };
  next_cell(c, step, rows, T, U, feat_lens, tgt_lens);
  if constexpr (kVec) {
    constexpr int E = Elem<S>::kPerVec;
    const int nvec = (V + E - 1) / E;
    uint4 buf[kUnroll];
    int y = -1;
    if (c.r < rows) {
      load_chunk<L>(reinterpret_cast<const uint4*>(logits + c.r * ld), nvec, 0, lane, buf);
      y = cell_target(c, U, V, targets, tgt_lens);
    }
    // a half-warp's rows may end before the other half's: both stay for the
    // shuffles (a warp's rows end together)
    while (L == 32 ? c.r < rows : __any_sync(kFull, c.r < rows)) {
      const bool live = L == 32 || c.r < rows;
      Cell n = c;
      if (live) {
        advance(n, step, T, U1);
        next_cell(n, step, rows, T, U, feat_lens, tgt_lens);
      }
      uint4 nbuf[kUnroll];
      int yn = -1;
      if (n.r < rows) {
        load_chunk<L>(reinterpret_cast<const uint4*>(logits + n.r * ld), nvec, 0, lane, nbuf);
        yn = cell_target(n, U, V, targets, tgt_lens);
      }
      const S* x = logits + (live ? c.r : 0) * ld;
      float m = -INFINITY, s = 0.0f;
      if (live) {
        lse_chunk<S, L>(buf, nvec, V, 0, lane, m, s);
        for (int i0 = L * kUnroll; i0 < nvec; i0 += L * kUnroll) {
          uint4 more[kUnroll];
          load_chunk<L>(reinterpret_cast<const uint4*>(x), nvec, i0, lane, more);
          lse_chunk<S, L>(more, nvec, V, i0, lane, m, s);
        }
      }
      const float l = warp_lse<L>(m, s);
      if (live) finish(c, x, l, y);
      c = n;
      y = yn;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) buf[j] = nbuf[j];
    }
  } else {
    while (c.r < rows) {
      const S* x = logits + c.r * ld;
      float m = -INFINITY, s = 0.0f;
      for (int v = lane; v < V; v += 32) lse_merge(m, s, Elem<S>::get(x[v]), 1.0f);
      finish(c, x, warp_lse(m, s), cell_target(c, U, V, targets, tgt_lens));
      advance(c, step, T, U1);
      next_cell(c, step, rows, T, U, feat_lens, tgt_lens);
    }
  }
}

// ---- forward: the wavefront, a warp per row ----------------------------------------
// Lane l holds the K consecutive cells u = l K + k of the diagonal, so a
// cell's neighbour (t, u-1) on the diagonal before is the lane's own cell
// k-1, and for k = 0 the last cell of the lane before: one shuffle a
// diagonal. Lanes past U hold no cell.
template <int K>
__global__ void __launch_bounds__(32 * kWalkRows) rnnt_fwd_walk_warp_kernel(
    const float* __restrict__ sblank, const float* __restrict__ slabel,
    const int* __restrict__ feat_lens, const int* __restrict__ tgt_lens,
    float* __restrict__ share, float* __restrict__ loss, int B, int T, int U) {
  extern __shared__ float ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWalkRows + warp;
  if (b >= B) return;   // the warp's own row; the CTA shares no barrier
  const int U1 = U + 1, Tb = row_frames(feat_lens, b, T), Ub = row_labels(tgt_lens, b, U);
  const int D = Tb - 1 + Ub;   // the last diagonal
  const int u0 = lane * K;     // the lane's first cell
  const size_t base = static_cast<size_t>(b) * (T + U) * U1 + u0;
  const float* sb = sblank + base;   // + (d-1) U1 + k: blank(t-1, u) of cell k on diagonal d
  const float* sl = slabel + base;   // + (d-1) U1 + k - 1: label(t, u-1)
  float* w = share + base;
  float* my = ring + warp * (kRing * 2 * K * 32) + lane;
  // slot d % kRing: what the cells of diagonal d add, [2][K][32] (blank,
  // label); cells of the skew grid outside the lattice load values that
  // are never read
  auto issue = [&](int d) {
    float* slot = my + (d % kRing) * (2 * K * 32);
    const bool on = d <= D;
    const size_t i = static_cast<size_t>(d - 1) * U1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool cell = on && u0 + k <= U;
      cp_async4(slot + k * 32, cell ? sb + i + k : sblank, cell);
      cp_async4(slot + (K + k) * 32, cell && u0 + k >= 1 ? sl + i + k - 1 : sblank,
                cell && u0 + k >= 1);
    }
    cp_async_commit();
  };
  float alpha[K];   // diagonal d-1 at u0 + k
#pragma unroll
  for (int k = 0; k < K; ++k) alpha[k] = u0 + k == 0 ? 0.0f : kNegInf;
  if (lane == 0) w[0] = 0.0f;
  for (int d = 1; d <= kRing; ++d) issue(d);
  for (int d = 1; d <= D; ++d) {
    cp_async_wait<kRing - 1>();
    const float* slot = my + (d % kRing) * (2 * K * 32);
    const int u_lo = max(0, d - (Tb - 1)), u_hi = min(d, Ub);
    // a cell off [u_lo, u_hi] is never read before it is written again:
    // the cells of a diagonal read only cells of the one before inside it
    const float up = __shfl_up_sync(kFull, alpha[K - 1], 1);
    // every cell computed, the ones off the diagonal's range discarded: no
    // branch, so the K cells' chains interleave
    float next[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = u0 + k;
      const float left = k > 0 ? alpha[k > 0 ? k - 1 : 0] : (lane > 0 ? up : kNegInf);
      const float a = d - u > 0 ? alpha[k] + slot[k * 32] : kNegInf;
      const float c = u > 0 ? left + slot[(K + k) * 32] : kNegInf;
      float s;
      const float v = log_add_share(a, c, &s);
      const bool on = u >= u_lo && u <= u_hi;
      next[k] = on ? v : alpha[k];
      if (on) w[static_cast<size_t>(d) * U1 + k] = s;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) alpha[k] = next[k];
    issue(d + kRing);   // into the slot just read
  }
  cp_async_wait<0>();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (u0 + k == Ub) loss[b] = -(alpha[k] + sb[static_cast<size_t>(D) * U1 + k]);
  }
}

// ---- forward: the wavefront, a CTA per row (U + 1 > 256) ---------------------------
template <int KC>
__global__ void __launch_bounds__(kMaxCtaThreads) rnnt_fwd_walk_cta_kernel(
    const float* __restrict__ sblank, const float* __restrict__ slabel,
    const int* __restrict__ feat_lens, const int* __restrict__ tgt_lens,
    float* __restrict__ share, float* __restrict__ loss, int T, int U) {
  extern __shared__ float diag[];   // alpha of two diagonals, 2 x (U+1)
  const int b = blockIdx.x, nt = blockDim.x, tid = threadIdx.x;
  const int U1 = U + 1, Tb = row_frames(feat_lens, b, T), Ub = row_labels(tgt_lens, b, U);
  const int D = Tb - 1 + Ub;
  const size_t base = static_cast<size_t>(b) * (T + U) * U1;
  const float* sb = sblank + base;
  const float* sl = slabel + base;
  float* w = share + base;
  float* prev = diag;
  float* cur = diag + U1;
  // the scores of the next two diagonals, loaded ahead: [0] d+1, [1] d+2
  float nb[2][KC], nl[2][KC];
  auto load = [&](int d, float (&b)[KC], float (&l)[KC]) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int u = tid + nt * k, t = d - u;
      const bool live = d <= D && u <= Ub && t >= 0 && t < Tb;
      b[k] = live && t >= 1 ? sb[static_cast<size_t>(d - 1) * U1 + u] : 0.0f;
      l[k] = live && u >= 1 ? sl[static_cast<size_t>(d - 1) * U1 + u - 1] : 0.0f;
    }
  };
  if (tid == 0) {
    prev[0] = 0.0f;
    w[0] = 0.0f;
  }
  load(1, nb[0], nl[0]);
  load(2, nb[1], nl[1]);
  __syncthreads();
  for (int d = 1; d <= D; ++d) {
    float vb[KC], vl[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      vb[k] = nb[0][k];
      vl[k] = nl[0][k];
      nb[0][k] = nb[1][k];
      nl[0][k] = nl[1][k];
    }
    load(d + 2, nb[1], nl[1]);
    const int u_lo = max(0, d - (Tb - 1)), u_hi = min(d, Ub);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int u = tid + nt * k, t = d - u;
      if (u >= u_lo && u <= u_hi) {
        const float a = t > 0 ? prev[u] + vb[k] : kNegInf;
        const float c = u > 0 ? prev[u - 1] + vl[k] : kNegInf;
        float s;
        cur[u] = log_add_share(a, c, &s);
        w[static_cast<size_t>(d) * U1 + u] = s;
      }
    }
    __syncthreads();
    float* x = prev;
    prev = cur;
    cur = x;
  }
  if (tid == 0) loss[b] = -(prev[Ub] + sb[static_cast<size_t>(D) * U1 + Ub]);
}

// ---- backward: the reverse wavefront, a warp per row ------------------------------
// The cells as in the forward walk: (t, u+1) on the diagonal after is the
// lane's own cell k+1, and for k = K-1 the first cell of the lane after.
template <int K>
__global__ void __launch_bounds__(32 * kWalkRows) rnnt_bwd_walk_warp_kernel(
    const float* __restrict__ share, const int* __restrict__ feat_lens,
    const int* __restrict__ tgt_lens, const float* __restrict__ grad, float* __restrict__ cb,
    float* __restrict__ cl, int B, int T, int U) {
  extern __shared__ float ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWalkRows + warp;
  if (b >= B) return;
  const int U1 = U + 1, Tb = row_frames(feat_lens, b, T), Ub = row_labels(tgt_lens, b, U);
  const int D = Tb - 1 + Ub;
  const int u0 = lane * K;
  const size_t base = static_cast<size_t>(b) * (T + U) * U1 + u0;
  const float* w = share + base;   // + (d+1) U1 + k: w(t+1, u); + 1: w(t, u+1)
  float* ob = cb + base;
  float* ol = cl + base;
  const float g = grad[b];
  float* my = ring + warp * (kRing * 2 * K * 32) + lane;
  // slot (D - d) % kRing: the shares the cells of diagonal d read, [2][K][32]
  auto issue = [&](int d) {
    float* slot = my + ((D - d) % kRing) * (2 * K * 32);
    const bool on = d >= 0 && d < D;   // diagonal D reads no share
    const size_t i = static_cast<size_t>(d + 1) * U1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool cell = on && u0 + k <= U;
      cp_async4(slot + k * 32, cell ? w + i + k : share, cell);
      cp_async4(slot + (K + k) * 32, cell && u0 + k < U ? w + i + k + 1 : share,
                cell && u0 + k < U);
    }
    cp_async_commit();
  };
  float gam[K];   // diagonal d+1 at u0 + k
#pragma unroll
  for (int k = 0; k < K; ++k) gam[k] = 0.0f;
  for (int i = 0; i < kRing; ++i) issue(D - i);
  for (int d = D; d >= 0; --d) {
    cp_async_wait<kRing - 1>();
    const float* slot = my + ((D - d) % kRing) * (2 * K * 32);
    const int u_lo = max(0, d - (Tb - 1)), u_hi = min(d, Ub);
    const float down = __shfl_down_sync(kFull, gam[0], 1);
    float next[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = u0 + k, t = d - u;
      const float right = k + 1 < K ? gam[k + 1 < K ? k + 1 : k] : (lane < 31 ? down : 0.0f);
      // through the blank to (t+1, u), or out of the lattice after (T_b-1, U_b)
      const float vb = t < Tb - 1 ? gam[k] * slot[k * 32] : (u == Ub ? 1.0f : 0.0f);
      const float vl = u < Ub ? right * (1.0f - slot[(K + k) * 32]) : 0.0f;
      const bool on = u >= u_lo && u <= u_hi;
      next[k] = on ? vb + vl : gam[k];
      if (on) {
        const size_t i = static_cast<size_t>(d) * U1 + k;
        ob[i] = (t == Tb - 1 && u != Ub) ? 0.0f : -g * vb;
        ol[i] = u < Ub ? -g * vl : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) gam[k] = next[k];
    issue(d - kRing);
  }
  cp_async_wait<0>();
}

// ---- backward: the reverse wavefront, a CTA per row (U + 1 > 256) ------------------
template <int KC>
__global__ void __launch_bounds__(kMaxCtaThreads) rnnt_bwd_walk_cta_kernel(
    const float* __restrict__ share, const int* __restrict__ feat_lens,
    const int* __restrict__ tgt_lens, const float* __restrict__ grad, float* __restrict__ cb,
    float* __restrict__ cl, int T, int U) {
  extern __shared__ float diag[];   // gam of two diagonals: d+1, d
  const int b = blockIdx.x, nt = blockDim.x, tid = threadIdx.x;
  const int U1 = U + 1, Tb = row_frames(feat_lens, b, T), Ub = row_labels(tgt_lens, b, U);
  const int D = Tb - 1 + Ub;
  const size_t base = static_cast<size_t>(b) * (T + U) * U1;
  const float* w = share + base;
  float* ob = cb + base;
  float* ol = cl + base;
  const float g = grad[b];
  float* next = diag;
  float* cur = diag + U1;
  // the shares of the next two diagonals, loaded ahead: [0] d-1, [1] d-2
  float nwb[2][KC], nwl[2][KC];
  auto load = [&](int d, float (&b)[KC], float (&l)[KC]) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int u = tid + nt * k, t = d - u;
      const bool live = d >= 0 && u <= Ub && t >= 0 && t < Tb;
      const size_t i = static_cast<size_t>(d + 1) * U1 + u;
      b[k] = live && t < Tb - 1 ? w[i] : 0.0f;
      l[k] = live && u < Ub ? w[i + 1] : 0.0f;
    }
  };
  load(D, nwb[0], nwl[0]);
  load(D - 1, nwb[1], nwl[1]);
  for (int d = D; d >= 0; --d) {
    float wb[KC], wl[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      wb[k] = nwb[0][k];
      wl[k] = nwl[0][k];
      nwb[0][k] = nwb[1][k];
      nwl[0][k] = nwl[1][k];
    }
    load(d - 2, nwb[1], nwl[1]);
    const int u_lo = max(0, d - (Tb - 1)), u_hi = min(d, Ub);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int u = tid + nt * k, t = d - u;
      if (u >= u_lo && u <= u_hi) {
        const float vb = t < Tb - 1 ? next[u] * wb[k] : (u == Ub ? 1.0f : 0.0f);
        const float vl = u < Ub ? next[u + 1] * (1.0f - wl[k]) : 0.0f;
        const size_t i = static_cast<size_t>(d) * U1 + u;
        ob[i] = (t == Tb - 1 && u != Ub) ? 0.0f : -g * vb;
        ol[i] = u < Ub ? -g * vl : 0.0f;
        cur[u] = vb + vl;
      }
    }
    __syncthreads();
    float* x = next;
    next = cur;
    cur = x;
  }
}

// ---- backward: the coefficients -> dlogits ------------------------------------------
// A warp takes a row (a half-warp a row measured slower here: the pass's
// work a row is its writes, not a reduction). The warps first write the zero
// rows of their stride (cells outside the lattices), then take their
// lattice cells in turn; with 16-byte rows the next cell's first chunk, its
// lse, cb, cl and target id are loaded while the current row is written.
template <typename S, bool kVec>
__global__ void __launch_bounds__(kRowThreads) rnnt_bwd_dlogits_kernel(
    const S* __restrict__ logits, S* __restrict__ dlogits, long long ld, int V, int blank_id,
    const int* __restrict__ targets, const int* __restrict__ feat_lens,
    const int* __restrict__ tgt_lens, int B, int T, int U, const float* __restrict__ lse,
    float* __restrict__ cb, float* __restrict__ cl) {
  constexpr int E = Elem<S>::kPerVec, L = 32;
  const int lane = threadIdx.x & (L - 1);
  const int U1 = U + 1;
  const long long rows = static_cast<long long>(B) * T * U1;
  const Cell step = cell_at(static_cast<long long>(gridDim.x) * (kRowThreads / L), T, U1);
  const Cell first = cell_at(
      static_cast<long long>(blockIdx.x) * (kRowThreads / L) + (threadIdx.x / L), T, U1);
  for (Cell z = first; z.r < rows; advance(z, step, T, U1)) {   // outside the lattice: zeros
    if (in_lattice(z, T, U, feat_lens, tgt_lens)) continue;
    S* out = dlogits + z.r * ld;
    if constexpr (kVec) {
      uint4* ov = reinterpret_cast<uint4*>(out);
      for (long long i = lane; i < ld / E; i += L) ov[i] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (long long v = lane; v < ld; v += L) out[v] = Elem<S>::put(0.0f);
    }
    if (lane == 0) {
      const size_t sk = skew(z.b, z.t, z.u, T, U);
      cb[sk] = 0.0f;
      cl[sk] = 0.0f;
    }
  }
  // dlogit[v] = cb 1{v = blank} + cl 1{v = y} - exp(x[v] - lse) (cb + cl), 0 from V on
  auto dlogit = [&](float x, int v, float fb, float fl, float l, int y) {
    const float hot = (v == blank_id ? fb : 0.0f) + (v == y ? fl : 0.0f);
    return v < V ? fmaf(-exp2_ftz((x - l) * kLog2e), fb + fl, hot) : 0.0f;
  };
  Cell c = first;
  next_cell(c, step, rows, T, U, feat_lens, tgt_lens);
  if constexpr (kVec) {
    const int nin = (V + E - 1) / E, nout = static_cast<int>(ld / E);
    // the row's values and the cell's coefficients, lse and target
    auto fetch = [&](const Cell& q, uint4 (&buf)[kUnroll], float& fb, float& fl, float& l,
                     int& y) {
      load_chunk<L>(reinterpret_cast<const uint4*>(logits + q.r * ld), nin, 0, lane, buf);
      const size_t sk = skew(q.b, q.t, q.u, T, U);
      fb = cb[sk];
      fl = cl[sk];
      l = lse[q.r];
      y = cell_target(q, U, V, targets, tgt_lens);
    };
    auto write = [&](uint4* ov, const uint4 (&buf)[kUnroll], int i0, float fb, float fl, float l,
                     int y) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int i = i0 + L * j + lane;
        if (i < nout) {
          float f[E];
          Elem<S>::unpack(buf[j], f);
          const int v0 = i * E;
          if (v0 + E <= V && static_cast<unsigned>(blank_id - v0) >= E &&
              static_cast<unsigned>(y - v0) >= E) {   // no one-hot term, no pad column
            const float sum = fb + fl;
#pragma unroll
            for (int e = 0; e < E; ++e) f[e] = -exp2_ftz((f[e] - l) * kLog2e) * sum;
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) f[e] = dlogit(f[e], v0 + e, fb, fl, l, y);
          }
          ov[i] = Elem<S>::pack(f);
        }
      }
    };
    uint4 buf[kUnroll];
    float fb = 0.0f, fl = 0.0f, l = 0.0f;
    int y = -1;
    if (c.r < rows) fetch(c, buf, fb, fl, l, y);
    while (c.r < rows) {
      Cell n = c;
      advance(n, step, T, U1);
      next_cell(n, step, rows, T, U, feat_lens, tgt_lens);
      uint4 nbuf[kUnroll];
      float nfb = 0.0f, nfl = 0.0f, nl = 0.0f;
      int ny = -1;
      if (n.r < rows) fetch(n, nbuf, nfb, nfl, nl, ny);
      uint4* ov = reinterpret_cast<uint4*>(dlogits + c.r * ld);
      write(ov, buf, 0, fb, fl, l, y);
      for (int i0 = L * kUnroll; i0 < nout; i0 += L * kUnroll) {
        uint4 more[kUnroll];
        load_chunk<L>(reinterpret_cast<const uint4*>(logits + c.r * ld), nin, i0, lane, more);
        write(ov, more, i0, fb, fl, l, y);
      }
      c = n;
      fb = nfb;
      fl = nfl;
      l = nl;
      y = ny;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) buf[j] = nbuf[j];
    }
  } else {
    while (c.r < rows) {
      const size_t sk = skew(c.b, c.t, c.u, T, U);
      const float fb = cb[sk], fl = cl[sk], l = lse[c.r];
      const int y = cell_target(c, U, V, targets, tgt_lens);
      const S* x = logits + c.r * ld;
      S* out = dlogits + c.r * ld;
      for (long long v = lane; v < ld; v += L) {
        out[v] = Elem<S>::put(dlogit(v < V ? Elem<S>::get(x[v]) : 0.0f, static_cast<int>(v), fb,
                                     fl, l, y));
      }
      advance(c, step, T, U1);
      next_cell(c, step, rows, T, U, feat_lens, tgt_lens);
    }
  }
}

// ---- launches -------------------------------------------------------------------------
struct Problem {
  const void* logits;
  long long ld;
  int V, blank_id;
  const int* targets;
  const int* feat_lens;
  const int* tgt_lens;
  int B, T, U;
  cudaStream_t stream;
};

// a row pass's grid: as many CTAs as fit on the card at once (no partial
// second wave; the warps stride over the rows), at most a CTA per 8 rows
template <typename Kernel>
int row_blocks(Kernel kernel, const Problem& p) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, 0);
  const long long rows = static_cast<long long>(p.B) * p.T * (p.U + 1);
  const long long need = (rows + kRowThreads / 32 - 1) / (kRowThreads / 32);
  const long long fit = static_cast<long long>(max(per_sm, 1)) * max(sms, 1);
  return static_cast<int>(need < fit ? need : fit);
}

template <int K>
int fwd_walk_warp(const Problem& p, const float* sblank, const float* slabel, float* share,
                  float* loss) {
  const size_t smem = static_cast<size_t>(kWalkRows) * kRing * 2 * K * 32 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(rnnt_fwd_walk_warp_kernel<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  rnnt_fwd_walk_warp_kernel<K><<<(p.B + kWalkRows - 1) / kWalkRows, 32 * kWalkRows, smem,
                                 p.stream>>>(sblank, slabel, p.feat_lens, p.tgt_lens, share,
                                             loss, p.B, p.T, p.U);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int bwd_walk_warp(const Problem& p, const float* share, const float* grad, float* cb,
                  float* cl) {
  const size_t smem = static_cast<size_t>(kWalkRows) * kRing * 2 * K * 32 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(rnnt_bwd_walk_warp_kernel<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  rnnt_bwd_walk_warp_kernel<K><<<(p.B + kWalkRows - 1) / kWalkRows, 32 * kWalkRows, smem,
                                 p.stream>>>(share, p.feat_lens, p.tgt_lens, grad, cb, cl,
                                             p.B, p.T, p.U);
  return static_cast<int>(cudaGetLastError());
}

int cta_threads(int U) { return min(kMaxCtaThreads, (U + 1 + 31) / 32 * 32); }

template <int KC>
int fwd_walk_cta(const Problem& p, const float* sblank, const float* slabel, float* share,
                 float* loss) {
  rnnt_fwd_walk_cta_kernel<KC><<<p.B, cta_threads(p.U), 2 * (p.U + 1) * sizeof(float),
                                 p.stream>>>(sblank, slabel, p.feat_lens, p.tgt_lens, share,
                                             loss, p.T, p.U);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int bwd_walk_cta(const Problem& p, const float* share, const float* grad, float* cb, float* cl) {
  rnnt_bwd_walk_cta_kernel<KC><<<p.B, cta_threads(p.U), 2 * (p.U + 1) * sizeof(float),
                                 p.stream>>>(share, p.feat_lens, p.tgt_lens, grad, cb, cl, p.T,
                                             p.U);
  return static_cast<int>(cudaGetLastError());
}

// the warp walk's cells a lane (1 .. kMaxK), or 0: the CTA walk
int warp_cells(int U) {
  const int k = (U + 1 + 31) / 32;
  return k <= kMaxK ? k : 0;
}

int cta_cells(int U) {
  const int nt = cta_threads(U);
  return (U + 1 + nt - 1) / nt;
}

int fwd_walk(const Problem& p, const float* sblank, const float* slabel, float* share,
             float* loss) {
  switch (warp_cells(p.U)) {
    case 1: return fwd_walk_warp<1>(p, sblank, slabel, share, loss);
    case 2: return fwd_walk_warp<2>(p, sblank, slabel, share, loss);
    case 3: return fwd_walk_warp<3>(p, sblank, slabel, share, loss);
    case 4: return fwd_walk_warp<4>(p, sblank, slabel, share, loss);
    case 5: return fwd_walk_warp<5>(p, sblank, slabel, share, loss);
    case 6: return fwd_walk_warp<6>(p, sblank, slabel, share, loss);
    case 7: return fwd_walk_warp<7>(p, sblank, slabel, share, loss);
    case 8: return fwd_walk_warp<8>(p, sblank, slabel, share, loss);
    default: break;
  }
  switch (cta_cells(p.U)) {
    case 1: return fwd_walk_cta<1>(p, sblank, slabel, share, loss);
    case 2: return fwd_walk_cta<2>(p, sblank, slabel, share, loss);
    case 3: return fwd_walk_cta<3>(p, sblank, slabel, share, loss);
    case 4: return fwd_walk_cta<4>(p, sblank, slabel, share, loss);
    case 5: return fwd_walk_cta<5>(p, sblank, slabel, share, loss);
    case 6: return fwd_walk_cta<6>(p, sblank, slabel, share, loss);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int bwd_walk(const Problem& p, const float* share, const float* grad, float* cb, float* cl) {
  switch (warp_cells(p.U)) {
    case 1: return bwd_walk_warp<1>(p, share, grad, cb, cl);
    case 2: return bwd_walk_warp<2>(p, share, grad, cb, cl);
    case 3: return bwd_walk_warp<3>(p, share, grad, cb, cl);
    case 4: return bwd_walk_warp<4>(p, share, grad, cb, cl);
    case 5: return bwd_walk_warp<5>(p, share, grad, cb, cl);
    case 6: return bwd_walk_warp<6>(p, share, grad, cb, cl);
    case 7: return bwd_walk_warp<7>(p, share, grad, cb, cl);
    case 8: return bwd_walk_warp<8>(p, share, grad, cb, cl);
    default: break;
  }
  switch (cta_cells(p.U)) {
    case 1: return bwd_walk_cta<1>(p, share, grad, cb, cl);
    case 2: return bwd_walk_cta<2>(p, share, grad, cb, cl);
    case 3: return bwd_walk_cta<3>(p, share, grad, cb, cl);
    case 4: return bwd_walk_cta<4>(p, share, grad, cb, cl);
    case 5: return bwd_walk_cta<5>(p, share, grad, cb, cl);
    case 6: return bwd_walk_cta<6>(p, share, grad, cb, cl);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 16-byte rows: the pointers and the row stride in bytes on 16 bytes
bool vector_rows(const void* a, const void* b, long long ld, int itemsize) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         (ld * itemsize) % 16 == 0;
}

// The score pass: 16-byte rows taken by a half-warp where a chunk of 16
// lanes holds a row's vectors (bf16 rows of 501 logits: 0.18 against 0.27
// ms a warp a row at B 32 T 249 U 64 on the H100), by a warp where not;
// element loads (a warp) where the rows are not on 16 bytes.
template <typename S>
int fwd_scores(const Problem& p, float* lse, float* sblank, float* slabel) {
  const S* x = static_cast<const S*>(p.logits);
  auto launch = [&](auto kernel) {
    kernel<<<row_blocks(kernel, p), kRowThreads, 0, p.stream>>>(
        x, p.ld, p.V, p.blank_id, p.targets, p.feat_lens, p.tgt_lens, p.B, p.T, p.U, lse,
        sblank, slabel);
  };
  if (!vector_rows(x, x, p.ld, sizeof(S))) {
    launch(rnnt_fwd_scores_kernel<S, false, 32>);
  } else if ((p.V + Elem<S>::kPerVec - 1) / Elem<S>::kPerVec <= 16 * kUnroll) {
    launch(rnnt_fwd_scores_kernel<S, true, 16>);
  } else {
    launch(rnnt_fwd_scores_kernel<S, true, 32>);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int bwd_dlogits(const Problem& p, void* dlogits, const float* lse, float* cb, float* cl) {
  const S* x = static_cast<const S*>(p.logits);
  S* dx = static_cast<S*>(dlogits);
  auto launch = [&](auto kernel) {
    kernel<<<row_blocks(kernel, p), kRowThreads, 0, p.stream>>>(
        x, dx, p.ld, p.V, p.blank_id, p.targets, p.feat_lens, p.tgt_lens, p.B, p.T, p.U, lse,
        cb, cl);
  };
  if (vector_rows(x, dx, p.ld, sizeof(S))) {
    launch(rnnt_bwd_dlogits_kernel<S, true>);
  } else {
    launch(rnnt_bwd_dlogits_kernel<S, false>);
  }
  return static_cast<int>(cudaGetLastError());
}

int max_labels() { return kMaxKC * kMaxCtaThreads - 1; }

bool bad(const Problem& p, int dtype) {
  return (dtype != 0 && dtype != 1) || p.B < 1 || p.T < 1 || p.U < 0 || p.U > max_labels() ||
         p.V < 1 || p.ld < p.V || p.blank_id < 0 || p.blank_id >= p.V;
}

Problem problem(const void* logits, long long ld, int V, int blank_id, const void* targets,
                const void* feat_lens, const void* tgt_lens, int B, int T, int U, void* stream) {
  return Problem{logits, ld, V, blank_id, static_cast<const int*>(targets),
                 static_cast<const int*>(feat_lens), static_cast<const int*>(tgt_lens), B, T, U,
                 static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// The largest U the kernels take (the CTA walk's 1024 threads x kMaxKC cells;
// its two diagonals, 48 KB, in shared memory without an opt-in).
int hnet_rnnt_max_labels() { return max_labels(); }

// dtype: 0 = float32, 1 = bfloat16 logits [B, T, U+1, ld] (V classes each row,
// ld >= V); targets [B, U], feat_lens and tgt_lens [B] int32. Writes lse
// [B, T, U+1], the scores sblank / slabel and the shares [B, T+U, U+1] (the
// cells of each row's lattice; the rest is not written) and loss [B]. Two
// launches on `stream`; returns a cudaError_t code, 0 on success.
int hnet_rnnt_fwd(int dtype, const void* logits, long long ld, int V, int blank_id,
                  const void* targets, const void* feat_lens, const void* tgt_lens, void* lse,
                  void* sblank, void* slabel, void* share, void* loss, int B, int T, int U,
                  void* stream) {
  const Problem p = problem(logits, ld, V, blank_id, targets, feat_lens, tgt_lens, B, T, U,
                            stream);
  if (bad(p, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  float* sb = static_cast<float*>(sblank);
  float* sl = static_cast<float*>(slabel);
  const int code = dtype == 0 ? fwd_scores<float>(p, static_cast<float*>(lse), sb, sl)
                              : fwd_scores<uint16_t>(p, static_cast<float*>(lse), sb, sl);
  if (code != 0) return code;
  return fwd_walk(p, sb, sl, static_cast<float*>(share), static_cast<float*>(loss));
}

// From the forward's lse and shares and the loss's gradient grad [B]: the
// coefficients cb, cl [B, T+U, U+1] (every cell (t, u) of [T, U+1] written,
// 0 outside the lattice) and dlogits in the logits' dtype and layout (every
// element of the B T (U+1) rows of ld written). Two launches.
int hnet_rnnt_bwd(int dtype, const void* logits, void* dlogits, long long ld, int V,
                  int blank_id, const void* targets, const void* feat_lens, const void* tgt_lens,
                  const void* lse, const void* share, const void* grad, void* cb, void* cl, int B,
                  int T, int U, void* stream) {
  const Problem p = problem(logits, ld, V, blank_id, targets, feat_lens, tgt_lens, B, T, U,
                            stream);
  if (bad(p, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  float* b = static_cast<float*>(cb);
  float* l = static_cast<float*>(cl);
  const int code = bwd_walk(p, static_cast<const float*>(share), static_cast<const float*>(grad),
                            b, l);
  if (code != 0) return code;
  return dtype == 0 ? bwd_dlogits<float>(p, dlogits, static_cast<const float*>(lse), b, l)
                    : bwd_dlogits<uint16_t>(p, dlogits, static_cast<const float*>(lse), b, l);
}

const char* hnet_rnnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
