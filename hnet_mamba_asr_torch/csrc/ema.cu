// Causal EMA of the H-Net dechunk (paper Eq. 5), forward and backward, for
// Hopper (sm_90a).
//
// Replaces hnet_mamba_asr_tpu/ops/ema.py::ema_smooth, which the JAX package
// leaves to XLA as an [M x M] masked-exp matmul per row (a TPU form: the
// MXU wants a matmul). On the card it is the recurrence itself. Per batch
// row b, channel d, with P clamped to [lo, hi] and the state in fp32:
//
//   forward:   zbar_0 = z_0,  zbar_t = P_t z_t + (1 - P_t) zbar_{t-1}
//   backward:  given g = dL/dzbar,
//              h_t   = g_t + (1 - P_{t+1}) h_{t+1}          (h_{M-1} = g_{M-1})
//              dz_t  = P_t h_t (t >= 1),  dz_0 = h_0
//              dP_t  = sum_d h_{t,d} (z_{t,d} - zbar_{t-1,d}) for t >= 1 where
//                      lo <= p_t <= hi (torch.clamp's gradient), else 0
//
// zbar_{t-1} in the backward is the forward's output, which autograd keeps
// (in z's dtype), not a recomputation. The specification of the
// decomposition below, its order of steps in plain torch, is
// tests/test_torch_ema.py (chunk-local chains, aggregates, carries in chunk
// order, the fix-up, the reverse carries and the dP partials per tile); it
// rounds its folds twice where fmaf rounds once, so it fixes the order,
// not the bits.
//
// What bounds it. The forward reads z and p once and writes zbar once; the
// backward reads z, zbar, g and p and writes dz and dP
// (tools/measure.py::ema_cost / ema_bwd_cost). A few FLOPs per element, so
// both are bound by bytes: at bf16 B 64 M 256 D 384 the forward moves
// 25.2 MB (7.53 us at 3.35 TB/s), the backward 50.5 MB (15.06 us).
//
// The design: a chunked linear scan. The recurrence is x_t = a_t x_{t-1} +
// b_t with a_t = 1 - P_t, b_t = P_t z_t ((a_0, b_0) = (0, z_0)); the
// backward's is h_t = a_{t+1} h_{t+1} + g_t, the same scan run from the end.
// What it does about the limits of the design it replaced (one CTA per
// batch row, one thread per channel, M steps in a row):
// - Few CTAs: one CTA per (batch row, tile of kDT = 128 channels, chunk of
//   kC = 64 slots). B 64 M 256 D 384 runs 768 CTAs, B 8 M 880 336, B 1
//   M 880 42 (was 64, 8 and 1).
// - A long chain: inside a chunk a thread takes a pair of channels and one
//   of kS = 4 sub-chunks of 16 slots (256 threads), and runs its chains
//   over them from a zero state out of shared memory: no global load on a
//   chain. The sub-chunks' end states and decay products fold, in order,
//   into the chunk's aggregate (end state from zero) and decay product A.
//   Across chunks a single-pass chained scan with decoupled look-back per
//   (row, tile): a CTA takes its chunk from an atomic ticket (chunks in
//   scan order, so it only ever waits on CTAs that already run), publishes
//   its aggregate, then warp 0 reads the flags of the 32 nearest chunks
//   until it finds the nearest inclusive prefix with an aggregate at every
//   nearer chunk. The carry is that prefix folded forward through those
//   aggregates in chunk order, fmaf(A_k, carry, agg_k), and a chunk's own
//   inclusive prefix is the same fmaf of its carry: the carry's bits do not
//   depend on where the look-back stopped, so two calls are bitwise equal.
//   Each thread then runs its chains again from its carry (the chunk's,
//   folded through the sub-chunks before it), casts once, and writes the
//   result into the tile.
// - Narrow loads: the CTA's [kC x kDT] tiles (z; for the backward g, z and
//   zbar over slots [c kC - 1, c kC + kC - 1)) come into shared memory by
//   cp.async, 16 bytes a copy, its kC values of P with them, and results
//   leave by 16-byte stores. A D that 16 bytes of channels do not divide,
//   or a pointer off 16 bytes, takes the same kernel with element loads
//   (kVec false); the ragged last chunk and tile are masked in the kernel.
// - The dP sum on the chain: the backward's second pass writes dz in place
//   of g and each pair's h_t (z_t - zbar_{t-1}) in place of its z; then 4
//   threads per slot add the slot's pair terms in a fixed order (a diagonal
//   walk, then a butterfly) into one fp32 partial per (row, slot, tile).
//   The last tile CTA of a (row, chunk), found by a counter, adds the
//   partials in tile order and applies the clamp's mask and dP_0 = 0. No
//   float atomics anywhere.
// - The channel cap (D <= 1024): gone; any D.
// The flags carry the call's epoch (the wrapper counts calls), so they need
// no reset; the ticket and the counters wrap to zero at the end of every
// call (atomicInc). The wrapper allocates the scratch, per (device, stream),
// and refuses a CUDA graph capture: every replay of a graph would reuse the
// captured epoch and take the flags of the replay before for this one's.
// __launch_bounds__ caps the registers so that as many CTAs fit an SM as
// their shared memory allows (8 forward, 4 backward in bf16).
//
// The sizes: chunks of 32 or 128 slots, tiles of 64 channels, 2 or 8
// sub-chunks, or 1 or 16 slots loaded ahead were none faster over the EMA
// shapes (PERF.md, section 6); tools/measure.py ema_phases shows where a CTA's
// time goes. Measured (tools/measure.py ema, this design against the one it
// replaced in one call; NVIDIA H100 80GB HBM3, 700.00 W), bf16, kernel time
// per call and share of the bound:
// B 64 M 256 D 384 forward 0.0116 ms (65 %; was 0.0243), backward 0.0284
// ms (53 %; was 0.1146); B 8 M 880 forward 0.0088 ms (was 0.0806),
// backward 0.0127 ms (was 0.2810). The rest in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kC = 64;                    // slots per chunk
constexpr int kDT = 128;                  // channels per tile
constexpr int kPairs = kDT / 2;           // a thread per pair of channels ...
constexpr int kS = 4;                     // ... and sub-chunk of the chunk
constexpr int kSub = kC / kS;             // slots per sub-chunk
constexpr int kThreads = kPairs * kS;
constexpr int kR = kThreads / kC;         // threads per slot in the dP sums
constexpr int kRun = kPairs / kR;         // pair terms each of them adds
static_assert(kC % kS == 0 && kPairs % 32 == 0 && kThreads <= 1024 && kThreads % kC == 0,
              "whole warps, sub-chunks and slots");
static_assert(kR <= 32 && (kR & (kR - 1)) == 0 && kPairs % kR == 0 && (kRun & (kRun - 1)) == 0,
              "a slot's dP threads in one warp; a power-of-two diagonal walk");
// slots whose tile values a second pass loads into registers before it
// writes its results back into the tile
constexpr int kU = 8;
static_assert(kSub % kU == 0, "whole blocks of a sub-chunk");
// CTAs per SM that the tiles' shared memory allows (228 KB an SM, 1 KB of
// it per CTA for the system, ~3 KB of static arrays), at most the SM's 2048
// threads: __launch_bounds__ caps the registers so that they fit too
template <typename S>
constexpr int blocks_per_sm(int tiles) {
  return 2048 / kThreads < 233472 / (tiles * kC * kDT * (int)sizeof(S) + 4096)
             ? 2048 / kThreads : 233472 / (tiles * kC * kDT * (int)sizeof(S) + 4096);
}
constexpr uint32_t kAgg = 1, kInc = 2;   // flag states, below the call's epoch
constexpr uint32_t kEpochs = 1u << 30;   // epochs are 1 .. kEpochs - 1
// polls of the look-back before it traps (seconds: a fault, never a hang)
constexpr uint32_t kMaxPolls = 1u << 24;

#ifdef EMA_PHASE_CLOCKS
// Built with -DEMA_PHASE_CLOCKS (tools/measure.py ema_phases): thread 0 of
// each CTA stamps the global timer at the bounds of its phases. Off by
// default, and then it costs nothing.
constexpr int kPhaseCtas = 16384;
__device__ unsigned long long g_phase_ns[kPhaseCtas][16];
#define PHASE(k)                                                                    \
  do {                                                                              \
    if (threadIdx.x == 0 && blockIdx.x < kPhaseCtas) {                              \
      unsigned long long t;                                                         \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                         \
      g_phase_ns[blockIdx.x][k] = t;                                                \
    }                                                                               \
  } while (0)
#else
#define PHASE(k) do {} while (0)
#endif

// A pair of channels by storage type: fp32 as float2, bf16 as 32 bits.
template <typename S> struct Pair;
template <> struct Pair<float> {
  using T = float2;
  static __device__ __forceinline__ float2 get(float2 v) { return v; }
  static __device__ __forceinline__ float2 put(float2 v) { return v; }
};
template <> struct Pair<uint16_t> {
  using T = uint32_t;
  static __device__ __forceinline__ float2 get(uint32_t v) {
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  }
  static __device__ __forceinline__ uint32_t put(float2 v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v.x)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(v.y)) << 16);
  }
};

// torch.clamp(p, lo, hi) = min(max(p, lo), hi)
__device__ __forceinline__ float clamp_p(float p, float lo, float hi) {
  return fminf(fmaxf(p, lo), hi);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}
// atomicInc with acquire and release at gpu scope
__device__ __forceinline__ uint32_t inc_acq_rel(uint32_t* p, uint32_t wrap) {
  uint32_t old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(wrap) : "memory");
  return old;
}

// Scratch, per call, in three buffers of the wrapper: counts = [ticket,
// counters[B * nC]] (zero before and after every call), flags[S] (epoch
// words: zeroed once), floats = [agg[S * kDT], inc[S * kDT], decay[S],
// part[B * nT * M]] (never read before written); S = B * nT * nC records,
// one per (row, tile, chunk). The counts and flags live apart because a
// call's regions move with its shape, and a counter must start at zero.
struct Layout {
  int nC, nT;
  long long S, n_counts, n_flags, n_floats;
};

Layout layout(int B, int M, int D) {
  Layout l;
  l.nC = (M + kC - 1) / kC;
  l.nT = (D + kDT - 1) / kDT;
  l.S = (long long)B * l.nT * l.nC;
  l.n_counts = 1 + (long long)B * l.nC;
  l.n_flags = l.S;
  l.n_floats = l.S * (1 + 2 * kDT) + (long long)B * l.nT * M;
  return l;
}

template <typename S>
struct Args {
  const S* z; const float* p;
  S* out;                               // forward
  const S* zbar; const S* g; S* dz;     // backward
  float* dp;
  int B, M, D, nC, nT;
  float lo, hi;
  uint32_t* ticket; uint32_t* flags; uint32_t* count;
  float* agg; float* inc; float* decay; float* part;
  uint32_t epoch;
};

template <typename S>
Args<S> args_for(const void* z, const float* p, int B, int M, int D, float lo, float hi,
                 void* counts, void* flags, void* floats, uint32_t epoch) {
  const Layout l = layout(B, M, D);
  Args<S> a = {};
  a.z = static_cast<const S*>(z);
  a.p = p;
  a.B = B; a.M = M; a.D = D; a.nC = l.nC; a.nT = l.nT;
  a.lo = lo; a.hi = hi;
  a.ticket = static_cast<uint32_t*>(counts);
  a.count = a.ticket + 1;
  a.flags = static_cast<uint32_t*>(flags);
  a.agg = static_cast<float*>(floats);     // float2 records: 8-byte aligned
  a.inc = a.agg + l.S * kDT;
  a.decay = a.inc + l.S * kDT;
  a.part = a.decay + l.S;
  a.epoch = epoch;
  return a;
}

// Slots [t_lo, n) x channels [0, nd) of a matrix with rows of D elements,
// from `src` (the source of slot t_lo, channel 0; slot t at src + (t - t_lo)
// D) into the [kC][kDT] tile `s`.
template <typename S, bool kVec>
__device__ __forceinline__ void load_tile(S* s, const S* src, int t_lo, int n, int nd, int D) {
  if constexpr (kVec) {
    constexpr int kV = 16 / sizeof(S), kRow = kDT / kV;
    const int nv = nd / kV;
    for (int i = threadIdx.x; i < kC * kRow; i += kThreads) {
      const int t = i / kRow, v = i % kRow;
      if (t >= t_lo && t < n && v < nv)
        cp_async16(s + t * kDT + v * kV, src + (long long)(t - t_lo) * D + v * kV);
    }
  } else {
    for (int i = threadIdx.x; i < kC * kDT; i += kThreads) {
      const int t = i / kDT, d = i % kDT;
      if (t >= t_lo && t < n && d < nd) s[i] = src[(long long)(t - t_lo) * D + d];
    }
  }
}

template <typename S, bool kVec>
__device__ __forceinline__ void store_tile(S* dst, const S* s, int n, int nd, int D) {
  if constexpr (kVec) {
    constexpr int kV = 16 / sizeof(S), kRow = kDT / kV;
    const int nv = nd / kV;
    for (int i = threadIdx.x; i < kC * kRow; i += kThreads) {
      const int t = i / kRow, v = i % kRow;
      if (t < n && v < nv)
        *reinterpret_cast<uint4*>(dst + (long long)t * D + v * kV) =
            *reinterpret_cast<const uint4*>(s + t * kDT + v * kV);
    }
  } else {
    for (int i = threadIdx.x; i < kC * kDT; i += kThreads) {
      const int t = i / kDT, d = i % kDT;
      if (t < n && d < nd) dst[(long long)t * D + d] = s[i];
    }
  }
}

// The CTA's chunk from the ticket: chunks in scan order (from the last one
// when `reverse`), the (row, tile) pairs of one chunk together.
struct Work { int row, tile, c; };

__device__ __forceinline__ Work take_ticket(uint32_t* ticket, int B, int nT, int nC, bool reverse) {
  __shared__ uint32_t s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicInc(ticket, gridDim.x - 1);
  __syncthreads();
  const uint32_t per = (uint32_t)B * nT, k = s_ticket / per, rt = s_ticket % per;
  return {(int)(rt / nT), (int)(rt % nT), reverse ? nC - 1 - (int)k : (int)k};
}

// Write this chunk's record (by the threads of sub-chunk 0, a pair of
// channels each, and the decay) and raise its flag to `word`: the CTA's
// barrier, then one thread's release store (the barrier orders the other
// threads' writes before it; the reader acquires the flag, then its CTA's
// barrier orders its reads after).
__device__ __forceinline__ void publish(float* vec, float2 v, float* decay, float A,
                                        uint32_t* flag, uint32_t word) {
  if (threadIdx.x < kPairs) __stcg(reinterpret_cast<float2*>(vec) + threadIdx.x, v);
  if (threadIdx.x == 0 && decay != nullptr) __stcg(decay, A);
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, word);
}

// The carry into chunk c of one (row, tile), into carry[kPairs]: records
// k = c + step, c + 2 step, ... (flags, decay and vectors at index k of the
// (row, tile)'s arrays). Warp 0 reads the flags of the 32 nearest chunks
// until it finds the nearest inclusive prefix with an aggregate at every
// nearer chunk (the nearest chunk's prefix always comes); then each thread
// of sub-chunk 0 folds that prefix forward through the aggregates, in chunk
// order, for its pair of channels.
__device__ __forceinline__ void look_back(float2* carry, const uint32_t* flags,
                                          const float* decay, const float* agg, const float* inc,
                                          int c, int step, int nC, uint32_t epoch) {
  __shared__ int s_from;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int k = c + step * (1 + lane);
    const bool in = k >= 0 && k < nC;
    for (uint32_t poll = 0;; ++poll) {
      if (poll == kMaxPolls) __trap();
      uint32_t st = 0;
      if (in) {
        const uint32_t f = ld_acquire(flags + k);
        st = (f >> 2) == epoch ? (f & 3u) : 0u;
      }
      const uint32_t incl = __ballot_sync(0xffffffffu, st == kInc);
      const uint32_t ready = __ballot_sync(0xffffffffu, st != 0);
      if (incl != 0) {
        const int i = __ffs(incl) - 1;
        const uint32_t nearer = (1u << i) - 1u;
        if ((ready & nearer) == nearer) {
          if (lane == 0) s_from = i;
          break;
        }
      }
      __nanosleep(32);
    }
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j < kPairs) {
    const int i = s_from;
    const float2* inc2 = reinterpret_cast<const float2*>(inc);
    const float2* agg2 = reinterpret_cast<const float2*>(agg);
    float2 x = __ldcg(inc2 + (long long)(c + step * (1 + i)) * kPairs + j);
    for (int m0 = i - 1; m0 >= 0; m0 -= 4) {      // 4 chunks' loads at a time, then their folds
      float A4[4];
      float2 v4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = c + step * (1 + m0 - u);
        if (m0 - u >= 0) {
          A4[u] = __ldcg(decay + k);
          v4[u] = __ldcg(agg2 + (long long)k * kPairs + j);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (m0 - u >= 0) x = make_float2(fmaf(A4[u], x.x, v4[u].x), fmaf(A4[u], x.y, v4[u].y));
    }
    carry[j] = x;
  }
}

__device__ __forceinline__ float2 fold(float A, float2 x, float2 v) {   // A x + v
  return make_float2(fmaf(A, x.x, v.x), fmaf(A, x.y, v.y));
}

template <typename S, bool kVec>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<S>(1)) ema_fwd_kernel(Args<S> a) {
  using P2 = Pair<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  S* sz = reinterpret_cast<S*>(smem);            // [kC][kDT]: z, then zbar
  auto* sz2 = reinterpret_cast<typename P2::T*>(smem);
  __shared__ float sa[kC], sw[kC];               // a_t and the weight of z_t
  __shared__ float2 s_end[kS][kPairs];           // each sub-chunk's end state from zero
  __shared__ float s_dec[kS];                    // and its decay product
  __shared__ float2 s_carry[kPairs];             // the chunk's carry
  PHASE(0);
  const Work w = take_ticket(a.ticket, a.B, a.nT, a.nC, false);
  PHASE(1);
  const int c0 = w.c * kC, n = min(kC, a.M - c0);
  const int d0 = w.tile * kDT, nd = min(kDT, a.D - d0);
  const int tid = threadIdx.x, j = tid % kPairs, sub = tid / kPairs, t0 = sub * kSub;
  const long long base = ((long long)w.row * a.M + c0) * a.D + d0;
  load_tile<S, kVec>(sz, a.z + base, 0, n, nd, a.D);
  if (tid < n) {
    const int t = c0 + tid;
    const float P = clamp_p(a.p[(long long)w.row * a.M + t], a.lo, a.hi);
    sa[tid] = t == 0 ? 0.f : 1.f - P;
    sw[tid] = t == 0 ? 1.f : P;
  }
  if constexpr (kVec) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  PHASE(2);

  // pass 1: each sub-chunk's chains from a zero state, and its decay product
  float2 x = make_float2(0.f, 0.f);
  float A = 1.f;
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
    const int t = t0 + u;
    if (t < n) {
      const float2 zt = P2::get(sz2[t * kPairs + j]);
      x = fold(sa[t], x, make_float2(sw[t] * zt.x, sw[t] * zt.y));
      A *= sa[t];
    }
  }
  s_end[sub][j] = x;
  if (j == 0) s_dec[sub] = A;
  __syncthreads();
  // the chunk's aggregate: the sub-chunks folded in order
  float2 agg = s_end[0][j];
  float Ac = s_dec[0];
#pragma unroll
  for (int k = 1; k < kS; ++k) {
    agg = fold(s_dec[k], agg, s_end[k][j]);
    Ac *= s_dec[k];
  }
  PHASE(3);
  const long long rec = ((long long)w.row * a.nT + w.tile) * a.nC;   // the (row, tile)'s records
  if (w.c > 0) {
    publish(a.agg + (rec + w.c) * kDT, agg, a.decay + rec + w.c, Ac, a.flags + rec + w.c,
            a.epoch << 2 | kAgg);
    look_back(s_carry, a.flags + rec, a.decay + rec, a.agg + rec * kDT, a.inc + rec * kDT, w.c,
              -1, a.nC, a.epoch);
  } else if (tid < kPairs) {
    s_carry[j] = make_float2(0.f, 0.f);
  }
  PHASE(4);
  __syncthreads();
  const float2 carry = s_carry[j];
  PHASE(5);
  if (w.c + 1 < a.nC)
    publish(a.inc + (rec + w.c) * kDT, w.c > 0 ? fold(Ac, carry, agg) : agg, nullptr, 0.f,
            a.flags + rec + w.c, a.epoch << 2 | kInc);
  PHASE(6);

  // pass 2: each sub-chunk's chains again from its carry (the chunk's folded
  // through the sub-chunks before it); zbar in place of z
  // (kU slots' values come into registers before their results go back:
  // a store inside the chain would hold up the chain's later loads)
  x = carry;
  for (int k = 0; k < sub; ++k) x = fold(s_dec[k], x, s_end[k][j]);
#pragma unroll
  for (int b = 0; b < kSub; b += kU) {
    typename P2::T zu[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (t0 + b + u < n) zu[u] = sz2[(t0 + b + u) * kPairs + j];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + b + u;
      if (t < n) {
        const float2 zt = P2::get(zu[u]);
        x = fold(sa[t], x, make_float2(sw[t] * zt.x, sw[t] * zt.y));
        sz2[t * kPairs + j] = P2::put(x);
      }
    }
  }
  __syncthreads();
  PHASE(7);
  store_tile<S, kVec>(a.out + base, sz, n, nd, a.D);
  PHASE(8);
}

template <typename S, bool kVec>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<S>(3)) ema_bwd_kernel(Args<S> a) {
  using P2 = Pair<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  S* sg = reinterpret_cast<S*>(smem);            // [kC][kDT]: g, then dz
  S* sz = sg + kC * kDT;                         // z, then the dP terms
  S* szb = sz + kC * kDT;                        // zbar_{t-1}
  auto* sg2 = reinterpret_cast<typename P2::T*>(sg);
  auto* sz2 = reinterpret_cast<typename P2::T*>(sz);
  auto* szb2 = reinterpret_cast<typename P2::T*>(szb);
  // the dP term of a slot and pair of channels, fp32, in place of the pair's
  // z (the first of its two floats in fp32)
  float* sv = reinterpret_cast<float*>(sz);
  constexpr int kVStep = sizeof(S) / 2;
  __shared__ float sa[kC], sw[kC];               // a_{t+1} and dz's weight P_t
  __shared__ float2 s_end[kS][kPairs];           // each sub-chunk's h at its first slot from zero
  __shared__ float s_dec[kS];                    // and its decay product
  __shared__ float2 s_carry[kPairs];             // the chunk's carry (h one slot past it)
  __shared__ bool s_last;
  PHASE(0);
  const Work w = take_ticket(a.ticket, a.B, a.nT, a.nC, true);
  PHASE(1);
  const int c0 = w.c * kC, n = min(kC, a.M - c0);
  const int d0 = w.tile * kDT, nd = min(kDT, a.D - d0);
  const int tid = threadIdx.x, j = tid % kPairs, sub = tid / kPairs, t0 = sub * kSub;
  const long long prow = (long long)w.row * a.M;
  const long long base = (prow + c0) * a.D + d0;
  // g first: pass 1 and the look-back run while z and zbar are in flight
  load_tile<S, kVec>(sg, a.g + base, 0, n, nd, a.D);
  if constexpr (kVec) cp_async_commit();
  load_tile<S, kVec>(sz, a.z + base, 0, n, nd, a.D);
  // zbar_{t-1} for slot t: none for the row's first slot
  load_tile<S, kVec>(szb, c0 == 0 ? a.zbar + base : a.zbar + base - a.D, c0 == 0 ? 1 : 0, n, nd,
                     a.D);
  if (tid < n) {
    const int t = c0 + tid;
    sa[tid] = t + 1 < a.M ? 1.f - clamp_p(a.p[prow + t + 1], a.lo, a.hi) : 0.f;
    sw[tid] = t == 0 ? 1.f : clamp_p(a.p[prow + t], a.lo, a.hi);
  }
  if constexpr (kVec) {
    cp_async_commit();
    cp_async_wait<1>();
  }
  __syncthreads();
  PHASE(2);

  // pass 1: each sub-chunk's reverse chains from a zero state, and its decay
  // product
  float2 h = make_float2(0.f, 0.f);
  float A = 1.f;
#pragma unroll
  for (int u = kSub - 1; u >= 0; --u) {
    const int t = t0 + u;
    if (t < n) {
      h = fold(sa[t], h, P2::get(sg2[t * kPairs + j]));
      A *= sa[t];
    }
  }
  s_end[sub][j] = h;
  if (j == 0) s_dec[sub] = A;
  __syncthreads();
  // the chunk's aggregate: the sub-chunks folded from the last one
  float2 agg = s_end[kS - 1][j];
  float Ac = s_dec[kS - 1];
#pragma unroll
  for (int k = kS - 2; k >= 0; --k) {
    agg = fold(s_dec[k], agg, s_end[k][j]);
    Ac *= s_dec[k];
  }
  PHASE(3);
  const long long rec = ((long long)w.row * a.nT + w.tile) * a.nC;
  if (w.c + 1 < a.nC) {
    publish(a.agg + (rec + w.c) * kDT, agg, a.decay + rec + w.c, Ac, a.flags + rec + w.c,
            a.epoch << 2 | kAgg);
    look_back(s_carry, a.flags + rec, a.decay + rec, a.agg + rec * kDT, a.inc + rec * kDT, w.c,
              1, a.nC, a.epoch);
  } else if (tid < kPairs) {
    s_carry[j] = make_float2(0.f, 0.f);
  }
  PHASE(4);
  __syncthreads();
  const float2 carry = s_carry[j];
  PHASE(5);
  if (w.c > 0)
    publish(a.inc + (rec + w.c) * kDT, w.c + 1 < a.nC ? fold(Ac, carry, agg) : agg, nullptr,
            0.f, a.flags + rec + w.c, a.epoch << 2 | kInc);
  PHASE(6);

  // pass 2: each sub-chunk's reverse chains from its carry (the chunk's
  // folded through the sub-chunks after it); dz in place of g, and the pair's
  // dP term h_t (z_t - zbar_{t-1}), summed over its two channels, in place
  // of its z
  if constexpr (kVec) cp_async_wait<0>();
  __syncthreads();
  PHASE(7);
  // (kU slots' values come into registers first, as in the forward)
  h = carry;
  for (int k = kS - 1; k > sub; --k) h = fold(s_dec[k], h, s_end[k][j]);
  const bool first = 2 * j < nd, second = 2 * j + 1 < nd;   // the pair's channels exist
#pragma unroll
  for (int b = kSub - kU; b >= 0; b -= kU) {
    typename P2::T gu[kU], zu[kU], zpu[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = (t0 + b + u) * kPairs + j;
      if (t0 + b + u < n) {
        gu[u] = sg2[i];
        zu[u] = sz2[i];
        zpu[u] = szb2[i];
      }
    }
#pragma unroll
    for (int u = kU - 1; u >= 0; --u) {
      const int t = t0 + b + u, i = t * kPairs + j;
      if (t < n) {
        h = fold(sa[t], h, P2::get(gu[u]));
        sg2[i] = P2::put(make_float2(sw[t] * h.x, sw[t] * h.y));
        float v = 0.f;
        if (first && c0 + t > 0) {
          const float2 zt = P2::get(zu[u]), zp = P2::get(zpu[u]);
          v = h.x * (zt.x - zp.x);
          if (second) v += h.y * (zt.y - zp.y);
        }
        sv[i * kVStep] = v;
      }
    }
  }
  __syncthreads();
  PHASE(8);

  // dP: kR threads per slot each add kRun of its pair terms in a fixed order
  // (a diagonal walk, free of bank conflicts), then a butterfly; one partial
  // per (row, slot, tile). The last tile CTA of the (row, chunk) adds the
  // partials in tile order.
  {
    const int t = tid / kR, q = tid % kR;
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < n) {
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        s4[k & 3] += sv[(t * kPairs + q * kRun + ((k + t) & (kRun - 1))) * kVStep];
    }
    float sum = (s4[0] + s4[1]) + (s4[2] + s4[3]);
#pragma unroll
    for (int off = 1; off < kR; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (t < n && q == 0) __stcg(a.part + ((long long)w.row * a.nT + w.tile) * a.M + c0 + t, sum);
  }
  __syncthreads();
  PHASE(9);
  if (tid == 0)
    s_last = inc_acq_rel(a.count + (long long)w.row * a.nC + w.c, a.nT - 1) == (uint32_t)(a.nT - 1);
  store_tile<S, kVec>(a.dz + base, sg, n, nd, a.D);    // while the counter answers
  __syncthreads();
  PHASE(10);
  if (s_last && tid < n) {
    float s = 0.f;
    for (int k = 0; k < a.nT; ++k)
      s += __ldcg(a.part + ((long long)w.row * a.nT + k) * a.M + c0 + tid);
    const int t = c0 + tid;
    const float raw = a.p[prow + t];
    a.dp[prow + t] = t > 0 && raw >= a.lo && raw <= a.hi ? s : 0.f;
  }
  PHASE(11);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool (&ready)[64], int dev) {
  if (ready[dev]) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ready[dev] = true;
  return 0;
}

template <typename S, bool kVec>
int launch(bool backward, const Args<S>& a, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  static bool ready_fwd[64] = {}, ready_bwd[64] = {};
  const long long grid = (long long)a.B * a.nT * a.nC;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (backward) {
    const int bytes = 3 * kC * kDT * (int)sizeof(S);
    if (int e = set_smem(ema_bwd_kernel<S, kVec>, bytes, ready_bwd, dev)) return e;
    ema_bwd_kernel<S, kVec><<<(unsigned)grid, kThreads, bytes, stream>>>(a);
  } else {
    const int bytes = kC * kDT * (int)sizeof(S);
    if (int e = set_smem(ema_fwd_kernel<S, kVec>, bytes, ready_fwd, dev)) return e;
    ema_fwd_kernel<S, kVec><<<(unsigned)grid, kThreads, bytes, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch(bool backward, Args<S> a, std::initializer_list<const void*> ptrs, void* stream) {
  bool vec = a.D % (16 / (int)sizeof(S)) == 0;
  for (const void* q : ptrs) vec = vec && aligned16(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<S, true>(backward, a, s) : launch<S, false>(backward, a, s);
}

bool bad_shape(int batch, int M, int D, uint32_t epoch) {
  return batch <= 0 || M <= 0 || D <= 0 || epoch == 0 || epoch >= kEpochs;
}

}  // namespace

extern "C" {

// Scratch a call at this shape needs, in elements: int32 counts and flags
// (each zeroed once, then kept for the (device, stream)) and fp32 floats.
void hnet_ema_scratch(int batch, int M, int D, long long* sizes) {
  const Layout l = layout(batch, M, D);
  sizes[0] = l.n_counts;
  sizes[1] = l.n_flags;
  sizes[2] = l.n_floats;
}

// dtype: 0 = float32, 1 = bfloat16 (z and out); p is float32 [batch, M].
// lo, hi: the clamp of P. counts / flags / floats: the scratch of
// hnet_ema_scratch; epoch: 1 .. 2^30 - 1, a new one for every call on those
// flags since they were zeroed. Returns a cudaError_t code, 0 on success;
// launches asynchronously on `stream`.
int hnet_ema_fwd(int dtype, const void* z, const float* p, void* out, int batch, int M, int D,
                 float lo, float hi, void* counts, void* flags, void* floats, unsigned epoch,
                 void* stream) {
  if (bad_shape(batch, M, D, epoch)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    Args<float> a = args_for<float>(z, p, batch, M, D, lo, hi, counts, flags, floats, epoch);
    a.out = static_cast<float*>(out);
    return dispatch(false, a, {z, out}, stream);
  }
  if (dtype == 1) {
    Args<uint16_t> a = args_for<uint16_t>(z, p, batch, M, D, lo, hi, counts, flags, floats, epoch);
    a.out = static_cast<uint16_t*>(out);
    return dispatch(false, a, {z, out}, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// z, zbar (the forward's output), g (dL/dzbar) and dz in `dtype`; p and dp
// float32 [batch, M]; the scratch and epoch as for the forward.
int hnet_ema_bwd(int dtype, const void* z, const float* p, const void* zbar, const void* g,
                 void* dz, float* dp, int batch, int M, int D, float lo, float hi, void* counts,
                 void* flags, void* floats, unsigned epoch, void* stream) {
  if (bad_shape(batch, M, D, epoch)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    Args<float> a = args_for<float>(z, p, batch, M, D, lo, hi, counts, flags, floats, epoch);
    a.zbar = static_cast<const float*>(zbar);
    a.g = static_cast<const float*>(g);
    a.dz = static_cast<float*>(dz);
    a.dp = dp;
    return dispatch(true, a, {z, zbar, g, dz}, stream);
  }
  if (dtype == 1) {
    Args<uint16_t> a = args_for<uint16_t>(z, p, batch, M, D, lo, hi, counts, flags, floats, epoch);
    a.zbar = static_cast<const uint16_t*>(zbar);
    a.g = static_cast<const uint16_t*>(g);
    a.dz = static_cast<uint16_t*>(dz);
    a.dp = dp;
    return dispatch(true, a, {z, zbar, g, dz}, stream);
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef EMA_PHASE_CLOCKS
// Copy the stamps of the first n CTAs (grid order) to host [n][16].
int hnet_ema_phase_times(unsigned long long* host, int n) {
  if (n > kPhaseCtas) n = kPhaseCtas;
  return (int)cudaMemcpyFromSymbol(host, g_phase_ns, (size_t)n * 16 * sizeof(unsigned long long));
}
#endif

const char* hnet_ema_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
