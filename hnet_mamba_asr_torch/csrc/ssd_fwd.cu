// Mamba-2 SSD scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hnet_mamba_asr_tpu/ops/ssd_pallas.py
// (`_ssd_kernel`, launched by `ssd_pallas`). It computes what
// hnet_mamba_asr_torch/ops/ssd.py::ssd_chunked computes with chunk_size kQ:
//
//   per (batch b, head h), over chunks k of kQ positions, S [N, P] fp32:
//     ac    = within-chunk cumsum of a = dt * A_h            (<= 0)
//     W     = (C B^T) * exp(ac_q - ac_s) * dt_s  for s <= q   (masked BEFORE exp)
//     dS_k  = (B * exp(ac_last - ac) * dt)^T x                (chunk k's own term)
//     S_k   = exp(ac_last) * S_{k-1} + dS_k                   (S_{-1}: initial state)
//     y     = W x + exp(ac_q) * (C S_{k-1})
//
// x, B, C are fp32 or bf16; dt and A are fp32; accumulation and S are fp32;
// y is written in x's type. G <= H groups share B and C through index
// arithmetic (g = h / (H / G)), so the grouped tensors are never expanded.
// With bf16 inputs the operands of the products are rounded to bf16 where
// ssd_chunked rounds them: W (under intra_dtype bf16 also the scores, the
// decays and dt, and W is formed in bf16), B * exp(ac_last - ac) * dt, and
// S_{k-1}. With fp32 inputs only intra_dtype bf16 rounds (the scores, the
// decays, dt and their first product).
//
// What bounds it on the card. At the serving shapes (bf16, P 64, N 128,
// L 248 to 1000, H 12 or 16, batch 1 to 8) a call reads x, B, C and dt once
// and writes y once: 7 to 33 MB, 2 to 10 us at 3.35 TB/s, against 1.4 to
// 6.6 GFLOP in the chunked form, 1.4 to 6.7 us at 989 TFLOP/s. So the bound
// is bytes. The first version of this kernel reached ~2 % of it: one block
// per (b, h) walked its chunks in order on SIMT FMAs, 12 to 128 blocks on
// 132 SMs, with scalar loads not overlapped with the math.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 7.6-9 % of that bound
// at batch 8 and 2.4-5.4 % at batch 1, 3.5-5.2x and 11-23x faster than the
// first version. A round of one chunk per CTA takes ~11 us, spread over loads,
// state term, two cluster barriers, chain and output; no one phase holds
// more than a third of it.
//
// What the bf16 kernel does about it:
// - Work spread across chunks. One thread-block cluster of up to 8 CTAs per
//   (b, h), one launch per call. Each CTA owns one chunk of every round of
//   8 chunks (L 512; a longer L takes several rounds, the state passing
//   from one to the next in shared memory) and computes its chunk's dS_k
//   from zero. After a cluster barrier the chain S_k = exp(ac_last) S_{k-1}
//   + dS_k runs in order of k, in fp32, every CTA on its own slice of the
//   N * P elements, reading dS_k from the owning CTA's shared memory and
//   writing bf16(S_{k-1}) back to it through distributed shared memory.
//   After a second barrier each CTA finishes y for its chunk. Every position's
//   arithmetic is fixed by kQ alone (chunks start at multiples of kQ from
//   t = 0, dS_k from zero, the chain in order of k), so a row's result
//   depends neither on the batch nor on L.
// - Tensor cores. The four products (C B^T, W x, C S_{k-1}, (B coef)^T x)
//   are mma.sync.m16n8k16 bf16 MMAs with fp32 accumulation, fed by ldmatrix
//   from padded shared-memory rows (conflict-free). W stays in registers
//   between C B^T and W x (the accumulator layout of one is the A-operand
//   layout of the next). mma.sync rather than wgmma: at ~2 GFLOP per call
//   the math is not the bound, and the 16-row warp tiles map onto the
//   causal 64 x 64 W without the 64-row warpgroup tiles wgmma needs.
// - Asynchronous loads. x, B, C and dt arrive by cp.async (16 bytes a copy,
//   zero-filled past L, so padding has dt = 0) in two commit groups: C's
//   copies fly while the chunk's state term is computed from x, B and dt.
//   One chunk per CTA keeps a CTA at ~100 KB of shared memory and <= 128
//   registers a thread, so two CTAs (two clusters) share each SM and one's
//   loads overlap the other's MMAs and barriers; a second chunk buffer per
//   CTA would have left room for one CTA per SM.
//
// The fp32 kernel is not on the serving path. It keeps the first version's
// SIMT loops (a TF32 tensor-core product would not be fp32), one block per
// (b, h), and takes the same intra_dtype epilogue.

#include <cooperative_groups.h>

#include "ssd_common.cuh"

namespace cg = cooperative_groups;

#ifdef SSD_PHASE_CLOCKS
// Built with -DSSD_PHASE_CLOCKS (hnet_mamba_asr_torch/tools/measure.py
// phases): thread 0 of each bf16 CTA stamps the global timer at the phase
// bounds of round 0. Off by default, and then it costs nothing.
constexpr int kPhaseCtas = 16384;
__device__ unsigned long long g_phase_ns[kPhaseCtas][8];
#define PHASE_STAMP(j, round)                                                        \
  do {                                                                               \
    const unsigned cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); \
    if (threadIdx.x == 0 && (round) == 0 && cta < kPhaseCtas) {                      \
      unsigned long long t;                                                          \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                          \
      g_phase_ns[cta][j] = t;                                                        \
    }                                                                                \
  } while (0)
#else
#define PHASE_STAMP(j, round) do {} while (0)
#endif

namespace {

// =========================================================================
// fp32: one block per (b, h), SIMT FMAs (the first version of the kernel)
// =========================================================================

constexpr int kTile = 16;      // threads per side of the thread grid
constexpr int kThreads32 = kTile * kTile;
constexpr int kQT = kQ / kTile;

// Shared-memory layout, in floats.
template <int P, int N>
struct Smem32 {
  static constexpr int kBStride = N + 1;                  // padded B / C rows
  static constexpr int kX = 0;                            // x    [Q][P]
  static constexpr int kB = kX + kQ * P;                  // B    [Q][N+1]
  static constexpr int kC = kB + kQ * kBStride;           // C    [Q][N+1]
  static constexpr int kS = kC + kQ * kBStride;           // S    [N][P]
  static constexpr int kW = kS + N * P;                   // W    [Q][Q]
  static constexpr int kDt = kW + kQ * kQ;                // dt   [Q]
  static constexpr int kAc = kDt + kQ;                    // ac   [Q]
  static constexpr int kScan = kAc + kQ;                  // warp scans [Q]
  static constexpr int kCoef = kScan + kQ;                // exp(ac_last - ac) dt [Q]
  static constexpr int kFloats = kCoef + kQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads32)
ssd_fwd_fp32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ s0,
                    float* __restrict__ y, float* __restrict__ s_final,
                    float* __restrict__ s_chunks, int L, int H, int G, int intra_bf16) {
  static_assert(P % kTile == 0 && N % kTile == 0, "P and N must be multiples of 16");
  constexpr int kPT = P / kTile;
  constexpr int kNT = N / kTile;
  using Lay = Smem32<P, N>;
  constexpr int kBS = Lay::kBStride;

  extern __shared__ float smem32[];
  float* sx = smem32 + Lay::kX;
  float* sB = smem32 + Lay::kB;
  float* sC = smem32 + Lay::kC;
  float* sS = smem32 + Lay::kS;
  float* sW = smem32 + Lay::kW;
  float* sdt = smem32 + Lay::kDt;
  float* sac = smem32 + Lay::kAc;
  float* sscan = smem32 + Lay::kScan;
  float* scoef = smem32 + Lay::kCoef;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid % kTile;
  const int ty = tid / kTile;
  const float a_h = A[h];

  const size_t x_row = (size_t)H * P;      // elements between time steps of x / y
  const size_t bc_row = (size_t)G * N;     // ... of B / C
  const float* xb = x + (size_t)b * L * x_row + (size_t)h * P;
  const float* Bb = Bm + (size_t)b * L * bc_row + (size_t)g * N;
  const float* Cb = Cm + (size_t)b * L * bc_row + (size_t)g * N;
  const float* dtb = dt + (size_t)b * L * H + h;
  float* yb = y + (size_t)b * L * x_row + (size_t)h * P;
  const size_t state_off = ((size_t)b * H + h) * N * P;

  for (int i = tid; i < N * P; i += kThreads32) {
    sS[i] = s0 != nullptr ? s0[state_off + i] : 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += kQ) {
    // 1. Load the chunk; positions past L load as zeros (dt = 0 is an exact
    //    no-op for the recurrence).
    for (int i = tid; i < kQ * P; i += kThreads32) {
      const int q = i / P, p = i % P, t = t0 + q;
      sx[i] = t < L ? xb[(size_t)t * x_row + p] : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads32) {
      const int q = i / N, n = i % N, t = t0 + q;
      const bool in = t < L;
      sB[q * kBS + n] = in ? Bb[(size_t)t * bc_row + n] : 0.f;
      sC[q * kBS + n] = in ? Cb[(size_t)t * bc_row + n] : 0.f;
    }
    // The state before this chunk, for the backward kernel.
    if (s_chunks != nullptr) {
      float* out = s_chunks + (state_off * ((L + kQ - 1) / kQ) + (size_t)(t0 / kQ) * N * P);
      for (int i = tid; i < N * P; i += kThreads32) out[i] = sS[i];
    }
    // 2. Within-chunk inclusive cumsum of a = dt * A.
    if (tid < kQ) {
      const int t = t0 + tid;
      const float d = t < L ? dtb[(size_t)t * H] : 0.f;
      sdt[tid] = d;
      sscan[tid] = warp_inclusive_scan(d * a_h);
    }
    __syncthreads();
    if (tid < kQ) sac[tid] = tid < 32 ? sscan[tid] : sscan[tid] + sscan[31];
    __syncthreads();
    if (tid < kQ) scoef[tid] = expf(sac[kQ - 1] - sac[tid]) * sdt[tid];

    // 3. W[q][s] = (C_q . B_s) * exp(ac_q - ac_s) * dt_s, zero for s > q.
    {
      float acc[kQT][kQT];
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int j = 0; j < kQT; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float c[kQT], bv[kQT];
#pragma unroll
        for (int i = 0; i < kQT; ++i) c[i] = sC[(ty + kTile * i) * kBS + n];
#pragma unroll
        for (int j = 0; j < kQT; ++j) bv[j] = sB[(tx + kTile * j) * kBS + n];
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int j = 0; j < kQT; ++j) acc[i][j] = fmaf(c[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const int q = ty + kTile * i;
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          const int s = tx + kTile * j;
          float w = 0.f;
          if (s <= q) {          // only s <= q reaches the exp
            const float decay = expf(sac[q] - sac[s]);
            w = intra_bf16 ? round_bf16(round_bf16(acc[i][j]) * round_bf16(decay)) *
                                 round_bf16(sdt[s])
                           : acc[i][j] * decay * sdt[s];
          }
          sW[q * kQ + s] = w;
        }
      }
    }
    __syncthreads();

    // 4. y = W x + exp(ac_q) * (C S), with S the state before this chunk.
    {
      float acc[kQT][kPT], inter[kQT][kPT];
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int j = 0; j < kPT; ++j) acc[i][j] = inter[i][j] = 0.f;
      for (int s = 0; s < kQ; ++s) {
        float w[kQT], xv[kPT];
#pragma unroll
        for (int i = 0; i < kQT; ++i) w[i] = sW[(ty + kTile * i) * kQ + s];
#pragma unroll
        for (int j = 0; j < kPT; ++j) xv[j] = sx[s * P + tx + kTile * j];
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int j = 0; j < kPT; ++j) acc[i][j] = fmaf(w[i], xv[j], acc[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float c[kQT], sv[kPT];
#pragma unroll
        for (int i = 0; i < kQT; ++i) c[i] = sC[(ty + kTile * i) * kBS + n];
#pragma unroll
        for (int j = 0; j < kPT; ++j) sv[j] = sS[n * P + tx + kTile * j];
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int j = 0; j < kPT; ++j) inter[i][j] = fmaf(c[i], sv[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const int q = ty + kTile * i;
        const int t = t0 + q;
        if (t < L) {
          const float e = expf(sac[q]);
#pragma unroll
          for (int j = 0; j < kPT; ++j) {
            yb[(size_t)t * x_row + tx + kTile * j] = acc[i][j] + e * inter[i][j];
          }
        }
      }
    }
    __syncthreads();

    // 5. S = exp(ac_last) * S + sum_s (B_s * exp(ac_last - ac_s) * dt_s) x_s^T.
    //    Each thread updates only the entries it owns.
    {
      const float decay = expf(sac[kQ - 1]);
      float acc[kNT][kPT];
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int j = 0; j < kPT; ++j) acc[i][j] = decay * sS[(ty + kTile * i) * P + tx + kTile * j];
      for (int s = 0; s < kQ; ++s) {
        const float cf = scoef[s];
        float bv[kNT], xv[kPT];
#pragma unroll
        for (int i = 0; i < kNT; ++i) bv[i] = sB[s * kBS + ty + kTile * i] * cf;
#pragma unroll
        for (int j = 0; j < kPT; ++j) xv[j] = sx[s * P + tx + kTile * j];
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int j = 0; j < kPT; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int j = 0; j < kPT; ++j) sS[(ty + kTile * i) * P + tx + kTile * j] = acc[i][j];
    }
    __syncthreads();
  }

  if (s_final != nullptr) {
    for (int i = tid; i < N * P; i += kThreads32) s_final[state_off + i] = sS[i];
  }
}

#if SSD_BF16
// =========================================================================
// bf16: a cluster of CTAs per (b, h), tensor-core MMAs, cp.async loads
// =========================================================================

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 8;            // portable cluster size: chunks in a round
constexpr int kXS = kP + 8;               // bf16 row strides, +16 bytes so
constexpr int kBS = kN + 8;               //   ldmatrix rows hit distinct banks
constexpr int kSS = kP + 8;               // fp32 / bf16 state rows
constexpr int kPairs = kN * kP / 2;       // element pairs of the state

// Shared memory of a CTA (bytes; every array 16-byte aligned): one chunk.
struct Smem16 {
  static constexpr int kX = 0;                                   // x    [Q][kXS]  bf16
  static constexpr int kB = kX + kQ * kXS * 2;                   // B    [Q][kBS]  bf16
  static constexpr int kC = kB + kQ * kBS * 2;                   // C    [Q][kBS]  bf16
  static constexpr int kDS = kC + kQ * kBS * 2;                  // dS_k [N][kSS]  fp32
  static constexpr int kSB = kDS + kN * kSS * 4;                 // bf16(S_{k-1}) [N][kSS]
  static constexpr int kCarry = kSB + kN * kSS * 2;              // S between rounds, fp32
  static constexpr int kDt = kCarry + kPairs / kMaxCluster * 8;  // dt   [Q] fp32
  static constexpr int kAc = kDt + kQ * 4;                       // ac   [Q] fp32
  static constexpr int kCoef = kAc + kQ * 4;                     // exp(ac_last - ac) dt [Q]
  static constexpr int kScan = kCoef + kQ * 4;                   // warp scans [Q]
  static constexpr int kDecay = kScan + kQ * 4;                  // exp(ac_last), 16 bytes
  static constexpr int kBytes = kDecay + 16;
};

struct Bf16Args {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  const float* s0;
  __nv_bfloat16* y;
  float* s_final;
  float* s_chunks;          // [B, H, K, N, P] state before each chunk, or null
  int L, H, G, K, intra_bf16;
};

// Issue the copies of chunk k (all threads), in two commit groups: x, B and
// dt, which the chunk's state term needs first, then C, which only its
// output needs, so that C's copies fly while the state term is computed.
// Past the last chunk the groups are empty.
__device__ __forceinline__ void load_chunk(const Bf16Args& a, char* smem, int k,
                                           int b, int h, int g) {
  const int tid = threadIdx.x;
  const bool any = k < a.K;
  const int t0 = k * kQ;
  const size_t x_row = (size_t)a.H * kP, bc_row = (size_t)a.G * kN;
  const __nv_bfloat16* xb = a.x + (size_t)b * a.L * x_row + (size_t)h * kP;
  const __nv_bfloat16* Bb = a.B + (size_t)b * a.L * bc_row + (size_t)g * kN;
  const __nv_bfloat16* Cb = a.C + (size_t)b * a.L * bc_row + (size_t)g * kN;
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem + Smem16::kX);
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem + Smem16::kB);
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem + Smem16::kC);
  float* sdt = reinterpret_cast<float*>(smem + Smem16::kDt);
  if (any) {
    // x: kQ rows of kP / 8 16-byte pieces; B: kQ rows of kN / 8
    for (int i = tid; i < kQ * (kP / 8); i += kThreads) {
      const int q = i / (kP / 8), c = i % (kP / 8), t = t0 + q;
      const bool in = t < a.L;
      cp_async16(sx + q * kXS + c * 8, xb + (size_t)(in ? t : 0) * x_row + c * 8, in);
    }
    for (int i = tid; i < kQ * (kN / 8); i += kThreads) {
      const int q = i / (kN / 8), c = i % (kN / 8), t = t0 + q;
      const bool in = t < a.L;
      cp_async16(sB + q * kBS + c * 8, Bb + (size_t)(in ? t : 0) * bc_row + c * 8, in);
    }
    if (tid < kQ) {
      const int t = t0 + tid;
      const bool in = t < a.L;
      cp_async4(sdt + tid, a.dt + ((size_t)b * a.L + (in ? t : 0)) * a.H + h, in);
    }
  }
  cp_async_commit();
  if (any) {
    for (int i = tid; i < kQ * (kN / 8); i += kThreads) {
      const int q = i / (kN / 8), c = i % (kN / 8), t = t0 + q;
      const bool in = t < a.L;
      cp_async16(sC + q * kBS + c * 8, Cb + (size_t)(in ? t : 0) * bc_row + c * 8, in);
    }
  }
  cp_async_commit();
}

// Grid (cluster size, H, batch), one cluster per (b, h); CTA `rank` owns
// chunk rank of every round of cluster-size chunks.
__global__ void __launch_bounds__(kThreads, 2)
ssd_fwd_bf16_kernel(const Bf16Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) char smem[];
  const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(smem + Smem16::kX);
  const __nv_bfloat16* sB = reinterpret_cast<const __nv_bfloat16*>(smem + Smem16::kB);
  const __nv_bfloat16* sC = reinterpret_cast<const __nv_bfloat16*>(smem + Smem16::kC);
  const __nv_bfloat16* sSB = reinterpret_cast<const __nv_bfloat16*>(smem + Smem16::kSB);
  float* sdS = reinterpret_cast<float*>(smem + Smem16::kDS);
  float2* scarry = reinterpret_cast<float2*>(smem + Smem16::kCarry);
  const float* sdt = reinterpret_cast<const float*>(smem + Smem16::kDt);
  float* sac = reinterpret_cast<float*>(smem + Smem16::kAc);
  float* scoef = reinterpret_cast<float*>(smem + Smem16::kCoef);
  float* sscan = reinterpret_cast<float*>(smem + Smem16::kScan);
  float* sdecay = reinterpret_cast<float*>(smem + Smem16::kDecay);

  const int cs = (int)gridDim.x;                  // the cluster spans x: CTAs of (b, h)
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;         // mma fragment row / column pair
  const int mi = lane / 8, ri = lane % 8;         // ldmatrix: matrix and row of the lane
  const float a_h = a.A[h];
  const int rounds = (a.K + cs - 1) / cs;
  const size_t state_off = ((size_t)b * a.H + h) * kN * kP;
  const size_t x_row = (size_t)a.H * kP;
  __nv_bfloat16* yb = a.y + (size_t)b * a.L * x_row + (size_t)h * kP;

  PHASE_STAMP(0, 0);
  load_chunk(a, smem, rank, b, h, g);

  for (int r = 0; r < rounds; ++r) {
    const int k_first = r * cs;
    const int nk = min(a.K - k_first, cs);       // chunks of this round
    const int k = k_first + rank;                 // this CTA's chunk
    const bool mine = k < a.K;                    // uniform over the CTA

    // ---- A: the chunk's cumsum and dS_k = (B coef)^T x ---------------------
    cp_async_wait<1>();                           // x, B, dt (C may still fly)
    __syncthreads();
    PHASE_STAMP(1, r);
    if (mine) {
      if (tid < kQ) sscan[tid] = warp_inclusive_scan(sdt[tid] * a_h);
      __syncthreads();
      if (tid < kQ) sac[tid] = tid < 32 ? sscan[tid] : sscan[tid] + sscan[31];
      __syncthreads();
      if (tid < kQ) scoef[tid] = expf(sac[kQ - 1] - sac[tid]) * sdt[tid];
      if (tid == 0) sdecay[0] = expf(sac[kQ - 1]);
      __syncthreads();

      // warp w: rows n in [16w, 16w + 16) of dS, all kP columns
      float acc[kP / 8][4];
#pragma unroll
      for (int i = 0; i < kP / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      const int n0 = 16 * warp;
#pragma unroll
      for (int s0 = 0; s0 < kQ; s0 += 16) {
        // A = (B coef)^T [n][s] from B stored [s][n]: ldmatrix.trans, then
        // each element times its coef and rounded to bf16
        uint32_t af[4];
        ldmatrix_x4_trans(af, sB + (s0 + ri + 8 * (mi / 2)) * kBS + n0 + 8 * (mi % 2));
        const float c0 = scoef[s0 + 2 * tq], c1 = scoef[s0 + 2 * tq + 1];
        const float c8 = scoef[s0 + 2 * tq + 8], c9 = scoef[s0 + 2 * tq + 9];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = unpack_bf16(af[e]);
          af[e] = e < 2 ? pack_bf16(v.x * c0, v.y * c1) : pack_bf16(v.x * c8, v.y * c9);
        }
#pragma unroll
        for (int p0 = 0; p0 < kP; p0 += 16) {
          // B = x [s][p]: ldmatrix.trans, two 8-column tiles
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, sx + (s0 + ri + 8 * (mi % 2)) * kXS + p0 + 8 * (mi / 2));
          mma_bf16(acc[p0 / 8], af, bf[0], bf[1]);
          mma_bf16(acc[p0 / 8 + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < kP / 8; ++i) {
        const int p = 8 * i + 2 * tq;
        *reinterpret_cast<float2*>(sdS + (n0 + gq) * kSS + p) = make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(sdS + (n0 + gq + 8) * kSS + p) = make_float2(acc[i][2], acc[i][3]);
      }
    }
    PHASE_STAMP(2, r);
    cluster.sync();                 // every dS_k of the round is visible
    PHASE_STAMP(3, r);

    // ---- B: the chain over the round's chunks, in order of k -------------
    // Pair i of the state's element pairs is (n, p) = (i / (kP/2), 2 (i % (kP/2))),
    // taken by CTA i / kThreads % cs. The round's dS_k and decays are all
    // loaded before the chain starts: they do not depend on it, so the
    // remote loads overlap instead of each waiting behind the previous
    // chunk's store. Several rounds only happen with a full cluster, where a
    // thread holds at most kPairs / (kMaxCluster kThreads) pairs; their state
    // waits for the next round in this CTA's shared memory.
    {
      float decay[kMaxCluster];
#pragma unroll
      for (int kk = 0; kk < kMaxCluster; ++kk)
        if (kk < nk)
          decay[kk] = *reinterpret_cast<const float*>(
              cluster.map_shared_rank(smem, kk) + Smem16::kDecay);
      int it = 0;
      for (int i = rank * kThreads + tid; i < kPairs; i += cs * kThreads, ++it) {
        const int n = i / (kP / 2), p = 2 * (i % (kP / 2));
        const int off = n * kSS + p;
        float2 dS[kMaxCluster];
#pragma unroll
        for (int kk = 0; kk < kMaxCluster; ++kk)
          if (kk < nk)
            dS[kk] = *reinterpret_cast<const float2*>(
                cluster.map_shared_rank(smem, kk) + Smem16::kDS + 4 * off);
        const size_t st = state_off + (size_t)n * kP + p;
        float2 S = make_float2(0.f, 0.f);
        if (r > 0) S = scarry[it * kThreads + tid];
        else if (a.s0 != nullptr) S = *reinterpret_cast<const float2*>(a.s0 + st);
#pragma unroll
        for (int kk = 0; kk < kMaxCluster; ++kk) {
          if (kk < nk) {
            *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(smem, kk) + Smem16::kSB +
                                         2 * off) = pack_bf16(S.x, S.y);
            if (a.s_chunks != nullptr)
              *reinterpret_cast<float2*>(a.s_chunks + state_off * a.K +
                                         (size_t)(k_first + kk) * kN * kP + n * kP + p) = S;
            S.x = __fadd_rn(__fmul_rn(decay[kk], S.x), dS[kk].x);
            S.y = __fadd_rn(__fmul_rn(decay[kk], S.y), dS[kk].y);
          }
        }
        if (r + 1 < rounds) scarry[it * kThreads + tid] = S;
        else if (a.s_final != nullptr) *reinterpret_cast<float2*>(a.s_final + st) = S;
      }
    }
    PHASE_STAMP(4, r);
    cluster.sync();                 // every bf16(S_{k-1}) is in its owner
    PHASE_STAMP(5, r);

    // ---- C: y = W x + exp(ac_q) C S_{k-1} for this CTA's chunk -------------
    // warp w: rows q in [16 rb, 16 rb + 16), columns p in [32 ph, 32 ph + 32)
    cp_async_wait<0>();                           // C
    __syncthreads();
    if (mine) {
      const int rb = warp % 4, ph = warp / 4;
      const int q0 = 16 * rb, pc = 32 * ph;
      const int crow = (q0 + ri + 8 * (mi % 2)) * kBS + 8 * (mi / 2);   // C as A operand

      // scores C B^T for the s-tiles up to the diagonal
      float sc[kQ / 8][4];
#pragma unroll
      for (int i = 0; i < kQ / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t cf[4];
        ldmatrix_x4(cf, sC + crow + 16 * kk);
#pragma unroll
        for (int st = 0; st < kQ / 16; ++st) {
          if (st > rb) continue;
          uint32_t bf[4];
          ldmatrix_x4(bf, sB + (16 * st + ri + 8 * (mi / 2)) * kBS + 16 * kk + 8 * (mi % 2));
          mma_bf16(sc[2 * st], cf, bf[0], bf[1]);
          mma_bf16(sc[2 * st + 1], cf, bf[2], bf[3]);
        }
      }

      // W in registers, rounded to bf16 as ssd_chunked rounds it; the
      // accumulator layout of C B^T is the A-operand layout of W x
      const int qa = q0 + gq, qb = qa + 8;
      const float ac_a = sac[qa], ac_b = sac[qb];
      uint32_t wf[kQ / 16][4];
#pragma unroll
      for (int st = 0; st < kQ / 16; ++st) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int tile = 2 * st + half;
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = e < 2 ? qa : qb;
            const int s = 8 * tile + 2 * tq + (e & 1);
            w[e] = 0.f;
            if (st <= rb && s <= q) {       // only s <= q reaches the exp
              const float decay = expf((e < 2 ? ac_a : ac_b) - sac[s]);
              w[e] = a.intra_bf16
                  ? round_bf16(round_bf16(sc[tile][e]) * round_bf16(decay)) *
                        round_bf16(sdt[s])
                  : sc[tile][e] * decay * sdt[s];
            }
          }
          wf[st][2 * half] = pack_bf16(w[0], w[1]);
          wf[st][2 * half + 1] = pack_bf16(w[2], w[3]);
        }
      }

      // W x and C S_{k-1} over this warp's 32 columns
      float yi[4][4], yc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) yi[i][e] = yc[i][e] = 0.f;
#pragma unroll
      for (int st = 0; st < kQ / 16; ++st) {
        if (st > rb) continue;
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, sx + (16 * st + ri + 8 * (mi % 2)) * kXS + pc + 16 * pt + 8 * (mi / 2));
          mma_bf16(yi[2 * pt], wf[st], bf[0], bf[1]);
          mma_bf16(yi[2 * pt + 1], wf[st], bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t cf[4];
        ldmatrix_x4(cf, sC + crow + 16 * kk);
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, sSB + (16 * kk + ri + 8 * (mi % 2)) * kSS + pc + 16 * pt + 8 * (mi / 2));
          mma_bf16(yc[2 * pt], cf, bf[0], bf[1]);
          mma_bf16(yc[2 * pt + 1], cf, bf[2], bf[3]);
        }
      }

      const float ea = expf(ac_a), eb = expf(ac_b);
      const int ta = k * kQ + qa, tb = ta + 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = pc + 8 * i + 2 * tq;
        if (ta < a.L)
          *reinterpret_cast<uint32_t*>(yb + (size_t)ta * x_row + p) =
              pack_bf16(yi[i][0] + yc[i][0] * ea, yi[i][1] + yc[i][1] * ea);
        if (tb < a.L)
          *reinterpret_cast<uint32_t*>(yb + (size_t)tb * x_row + p) =
              pack_bf16(yi[i][2] + yc[i][2] * eb, yi[i][3] + yc[i][3] * eb);
      }
    }
    __syncthreads();                // the chunk's buffers are free
    PHASE_STAMP(6, r);
    if (r + 1 < rounds) load_chunk(a, smem, k + cs, b, h, g);
  }
  // No CTA touches another's shared memory after the second cluster barrier
  // of the last round, so the CTAs may exit independently.
}

#endif  // SSD_BF16

int launch_fp32(const void* x, const float* dt, const float* A, const void* B,
                const void* C, const float* s0, void* y, float* s_final, float* s_chunks,
                int batch, int L, int H, int G, int intra_bf16, cudaStream_t stream) {
  auto kernel = ssd_fwd_fp32_kernel<kP, kN>;
  const size_t smem = Smem32<kP, kN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, batch), kThreads32, smem, stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
      static_cast<const float*>(C), s0, static_cast<float*>(y), s_final, s_chunks, L, H, G,
      intra_bf16);
  return (int)cudaGetLastError();
}

#if SSD_BF16
// CTAs per cluster: one per chunk, up to the portable cluster size; a
// longer L takes several rounds of that many chunks.
int cluster_size(int L) {
  const int K = (L + kQ - 1) / kQ;
  return K < kMaxCluster ? K : kMaxCluster;
}

int launch_bf16(const void* x, const float* dt, const float* A, const void* B,
                const void* C, const float* s0, void* y, float* s_final, float* s_chunks,
                int batch, int L, int H, int G, int intra_bf16, cudaStream_t stream) {
  const int K = (L + kQ - 1) / kQ;
  const int cs = cluster_size(L);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // per device: the shared-memory attribute set, and the clusters that fit
  static bool ready[64] = {};
  static int max_clusters[64][kMaxCluster + 1] = {};
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ssd_fwd_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Smem16::kBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  Bf16Args args{static_cast<const __nv_bfloat16*>(x), dt, A,
                static_cast<const __nv_bfloat16*>(B), static_cast<const __nv_bfloat16*>(C),
                s0, static_cast<__nv_bfloat16*>(y), s_final, s_chunks, L, H, G, K, intra_bf16};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, H, batch);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Smem16::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters[dev][cs] == 0) {
    // every CTA of a cluster must be resident at once
    err = cudaOccupancyMaxActiveClusters(&max_clusters[dev][cs], ssd_fwd_bf16_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (max_clusters[dev][cs] == 0) return (int)cudaErrorInvalidConfiguration;
  }
  err = cudaLaunchKernelEx(&cfg, ssd_fwd_bf16_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#endif  // SSD_BF16

}  // namespace

extern "C" {

// Whether the library is built for (P, N); the Python wrapper asks before
// launching so that it can refuse other shapes by name.
int hnet_ssd_fwd_supported(int P, int N) { return P == kP && N == kN; }

// Whether the library holds the bf16 kernel (built for P 64, N 128 only).
int hnet_ssd_fwd_has_bf16() { return SSD_BF16; }

// CTAs per (b, h) of a bf16 call at this L (the fp32 kernel takes one).
int hnet_ssd_fwd_bf16_cluster_size(int L) {
#if SSD_BF16
  return cluster_size(L);
#else
  return 0;
#endif
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y). s0, s_final and
// s_chunks may be null; s_chunks [B, H, K = ceil(L / 64), N, P] receives the
// fp32 state before each chunk, which the backward kernel (ssd_bwd.cu) reads.
// intra_bf16: 1 forms the intra-chunk weights in bf16. Returns a cudaError_t
// code, 0 on success; launches asynchronously on `stream`.
int hnet_ssd_fwd(int dtype, const void* x, const float* dt, const float* A,
                 const void* B, const void* C, const float* s0, void* y,
                 float* s_final, float* s_chunks, int batch, int L, int H, int G, int P,
                 int N, int intra_bf16, void* stream) {
  if (batch <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      !hnet_ssd_fwd_supported(P, N))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fp32(x, dt, A, B, C, s0, y, s_final, s_chunks, batch, L, H, G, intra_bf16, s);
#if SSD_BF16
  if (dtype == 1)
    return launch_bf16(x, dt, A, B, C, s0, y, s_final, s_chunks, batch, L, H, G, intra_bf16, s);
#endif
  return (int)cudaErrorInvalidValue;
}

#ifdef SSD_PHASE_CLOCKS
// Copy the stamps of the first n CTAs (grid order) to host [n][8].
int hnet_ssd_fwd_phase_times(unsigned long long* host, int n) {
  if (n > kPhaseCtas) n = kPhaseCtas;
  return (int)cudaMemcpyFromSymbol(host, g_phase_ns, (size_t)n * 8 * sizeof(unsigned long long));
}
#endif

const char* hnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
