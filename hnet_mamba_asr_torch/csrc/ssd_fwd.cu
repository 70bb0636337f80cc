// Mamba-2 SSD scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hnet_mamba_asr_tpu/ops/ssd_pallas.py
// (`_ssd_kernel`, launched by `ssd_pallas`). It computes what
// hnet_mamba_asr_torch/ops/ssd.py::ssd_chunked computes:
//
//   per (batch b, head h), over chunks of kQ positions, S [N, P] fp32:
//     ac    = within-chunk cumsum of a = dt * A_h            (<= 0)
//     W     = (C B^T) * exp(ac_q - ac_s) * dt_s  for s <= q   (masked BEFORE exp)
//     y     = W x + exp(ac_q) * (C S)
//     S     = exp(ac_last) * S + (B * exp(ac_last - ac) * dt)^T x
//
// x, B, C are fp32 or bf16; dt and A are fp32; accumulation and S are fp32;
// y is written in x's type. G <= H groups share B and C through index
// arithmetic (g = h / (H / G)), so the grouped tensors are never expanded.
//
// What bounds it on the card. At the serving shapes (P 64, N 128, L 248 to
// 873, H 12 or 16, B up to 8) one (b, h) pair is ~1.8M multiply-adds per
// 64-position chunk, ~15 MFLOP at L 248. B * H is 12 to 128 pairs, fewer
// than the 132 SMs, so the kernel is latency-bound: one wave of blocks,
// each walking its chunks in order, with the shared-memory loads that feed
// the FMAs as the limit inside a block.
//
// What the design does about it:
// - One block per (b, h) keeps S on chip for the whole sequence and loops
//   over the chunks itself; the TPU's sequential grid axis has no
//   counterpart on the card, and nothing needs to cross blocks.
// - The chunk is 64 positions, not the TPU's 256: the [Q, Q] fp32 weight
//   tile is then 16 KB, and x, B, C, S and W together take ~130 KB of the
//   227 KB a block may use (set with cudaFuncSetAttribute).
// - The within-chunk cumsum is a warp-shuffle scan in the kernel, so dt
//   and A go in as they are and no auxiliary tensor is built outside.
// - Each thread of a 16 x 16 grid owns a strided register tile of every
//   product, so each shared-memory value it loads feeds 4 to 8 FMAs. B and C
//   rows are padded by one float so the column reads of B hit distinct
//   banks.
// Tensor cores (wgmma) and TMA loads are later work; this version is the
// simple, exact one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;         // chunk length
constexpr int kTile = 16;      // threads per side of the thread grid
constexpr int kThreads = kTile * kTile;
constexpr int kQT = kQ / kTile;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared-memory layout, in floats.
template <int P, int N>
struct Smem {
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

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ s0,
               T* __restrict__ y, float* __restrict__ s_final,
               int L, int H, int G) {
  static_assert(P % kTile == 0 && N % kTile == 0, "P and N must be multiples of 16");
  static_assert(kQ % 32 == 0, "the cumsum scans whole warps");
  constexpr int kPT = P / kTile;
  constexpr int kNT = N / kTile;
  using Lay = Smem<P, N>;
  constexpr int kBS = Lay::kBStride;

  extern __shared__ float smem[];
  float* sx = smem + Lay::kX;
  float* sB = smem + Lay::kB;
  float* sC = smem + Lay::kC;
  float* sS = smem + Lay::kS;
  float* sW = smem + Lay::kW;
  float* sdt = smem + Lay::kDt;
  float* sac = smem + Lay::kAc;
  float* sscan = smem + Lay::kScan;
  float* scoef = smem + Lay::kCoef;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid % kTile;
  const int ty = tid / kTile;
  const float a_h = A[h];

  const size_t x_row = (size_t)H * P;      // elements between time steps of x / y
  const size_t bc_row = (size_t)G * N;     // ... of B / C
  const T* xb = x + (size_t)b * L * x_row + (size_t)h * P;
  const T* Bb = Bm + (size_t)b * L * bc_row + (size_t)g * N;
  const T* Cb = Cm + (size_t)b * L * bc_row + (size_t)g * N;
  const float* dtb = dt + (size_t)b * L * H + h;
  T* yb = y + (size_t)b * L * x_row + (size_t)h * P;
  const size_t state_off = ((size_t)b * H + h) * N * P;

  for (int i = tid; i < N * P; i += kThreads) {
    sS[i] = s0 != nullptr ? s0[state_off + i] : 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += kQ) {
    // 1. Load the chunk; positions past L load as zeros (dt = 0 is an exact
    //    no-op for the recurrence).
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int q = i / P, p = i % P, t = t0 + q;
      sx[i] = t < L ? to_f32(xb[(size_t)t * x_row + p]) : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int q = i / N, n = i % N, t = t0 + q;
      const bool in = t < L;
      sB[q * kBS + n] = in ? to_f32(Bb[(size_t)t * bc_row + n]) : 0.f;
      sC[q * kBS + n] = in ? to_f32(Cb[(size_t)t * bc_row + n]) : 0.f;
    }
    // 2. Within-chunk inclusive cumsum of a = dt * A: a shuffle scan per
    //    warp, then each warp adds the totals of the warps before it.
    if (tid < kQ) {
      const int t = t0 + tid;
      const float d = t < L ? dtb[(size_t)t * H] : 0.f;
      sdt[tid] = d;
      float v = d * a_h;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if ((tid & 31) >= off) v += u;
      }
      sscan[tid] = v;
    }
    __syncthreads();
    if (tid < kQ) {
      float v = sscan[tid];
      for (int w = 0; w < tid / 32; ++w) v += sscan[w * 32 + 31];
      sac[tid] = v;
    }
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
          // only s <= q reaches the exp: the masked differences are positive
          sW[q * kQ + s] = s <= q ? acc[i][j] * expf(sac[q] - sac[s]) * sdt[s] : 0.f;
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
            yb[(size_t)t * x_row + tx + kTile * j] = from_f32<T>(acc[i][j] + e * inter[i][j]);
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
    for (int i = tid; i < N * P; i += kThreads) s_final[state_off + i] = sS[i];
  }
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* s0, void* y, float* s_final, int batch,
           int L, int H, int G, cudaStream_t stream) {
  auto kernel = ssd_fwd_kernel<T, P, N>;
  const size_t smem = Smem<P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), s0, static_cast<T*>(y), s_final, L, H, G);
  return (int)cudaGetLastError();
}

// The one (headdim P, d_state N) the library is built for: Mamba-2's
// defaults, which every config in the repository uses.
constexpr int kP = 64;
constexpr int kN = 128;

}  // namespace

extern "C" {

// Whether the library is built for (P, N); the Python wrapper asks before
// launching so that it can refuse other shapes by name.
int hnet_ssd_fwd_supported(int P, int N) { return P == kP && N == kN; }

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y). s0 and s_final may be
// null. Returns a cudaError_t code, 0 on success; launches asynchronously
// on `stream`.
int hnet_ssd_fwd(int dtype, const void* x, const float* dt, const float* A,
                 const void* B, const void* C, const float* s0, void* y,
                 float* s_final, int batch, int L, int H, int G, int P, int N,
                 void* stream) {
  if (batch <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      !hnet_ssd_fwd_supported(P, N))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kP, kN>(x, dt, A, B, C, s0, y, s_final, batch, L, H, G, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kP, kN>(x, dt, A, B, C, s0, y, s_final, batch, L, H, G, s);
  return (int)cudaErrorInvalidValue;
}

const char* hnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
