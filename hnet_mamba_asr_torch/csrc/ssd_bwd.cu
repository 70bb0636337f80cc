// Mamba-2 SSD scan, backward, for Hopper (sm_90a).
//
// Replaces, as the gradient of the Pallas TPU kernel
// hnet_mamba_asr_tpu/ops/ssd_pallas.py (`_ssd_kernel`, which has no
// backward), the autodiff of hnet_mamba_asr_tpu/ops/ssd.py::ssd_chunked and
// its hand-written intra-chunk VJP `_intra_attn_bwd`. It computes the VJP of
// hnet_mamba_asr_torch/ops/ssd.py::ssd_chunked at chunk_size kQ: given dy, it
// returns dx, ddt, dA, dB, dC and d(initial_state), and takes d(final
// state). The forward kernel (ssd_fwd.cu) hands it the fp32 state before
// every chunk, S_{k-1}, so that nothing of the forward is recomputed but the
// chunk-local products.
//
// Per (batch b, head h), with D_k the gradient of the state after chunk k
// (D_{K-1} = d(final state)), over chunks k = K-1 .. 0, in fp32:
//   ac, coef_s = exp(ac_last - ac_s) dt_s, e_q = exp(ac_q)    (as the forward)
//   CB = C B^T, W = CB * exp(ac_q - ac_s) * dt_s (s <= q, masked BEFORE exp)
//   dW   = dy x^T (s <= q);  Nm = dW * CB * exp(ac_q - ac_s)
//   dx   = W^T dy + coef * (B D_k)
//   dB_h = (dW * exp(..) * dt)^T C + coef * (x D_k^T)
//   dC_h = (dW * exp(..) * dt) B + e * (dy S_{k-1}^T)
//   d(ac_q) = sum_s dt_s Nm[q,s] - dt_q sum_q' Nm[q',q] + C_q . dC_h,inter[q]
//             - coef_q dcoef_q  (+ at q = last: sum_s coef_s dcoef_s
//             + exp(ac_last) <D_k, S_{k-1}>),  dcoef_s = x_s . (B D_k)_s
//   da = reverse cumsum of d(ac); ddt = colsum Nm + exp(ac_last - ac) dcoef
//        + A da;  dA_h += sum dt da
//   D_{k-1} = exp(ac_last) D_k + C^T (e * dy)
// and d(initial_state) = D_{-1}. With bf16 inputs the forward values are
// rounded where the forward rounds them (W, and S_{k-1} in C S_{k-1}; under
// intra_dtype bf16 also the scores, decays and dt). Autograd of the bf16
// ssd_chunked also rounds the gradients at those casts; this kernel keeps
// them in fp32, so the two part by about a bf16 ulp of each term (the
// tolerances in tests/test_torch_cuda.py and chip_smoke.py).
//
// What bounds it on the card. At the training shapes (bf16, B 32, L 249,
// H 16, P 64, N 128, G 1) the function must read x, dy, B, C, dt and write
// dx, dB, dC, ddt: 58 MB, 17.4 us at 3.35 TB/s. This kernel also reads the
// 16.8 MB of chunk states and writes 130 MB of per-head dB / dC partials,
// ~205 MB in all (~61 us). The chunked backward needs 11.1 GFLOP of products
// a call (C B^T and the intra dB / dC products once per group of heads, the
// rest per head; tools/measure.py::ssd_bwd_cost): 11.3 us at 989 TFLOP/s
// (bf16 tensor cores), so the function is bound by its bytes. This kernel
// forms C B^T and the intra dB / dC products per head (16x the group's
// work at G 1, 17.2 GFLOP) on fp32 SIMT at 67 TFLOP/s: 256 us, so this
// version is bound by its own fp32 operations, by design: it is the simple,
// right first version (0.98 ms on an H100 at 700 W). One block per (b, h)
// walks its chunks in reverse, the carried D_k in shared memory, every
// product on SIMT FMAs over shared-memory tiles; the sums over the heads of
// a group (dB, dC) and over batch and length (dA) are left to a plain
// reduction of per-head fp32 partials after the kernel, so that the result
// does not depend on the order in which blocks run (no atomics). Tensor-core products (mma.sync / wgmma) and
// work spread across chunks are the redesign's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;           // chunk length (the forward kernel's)
constexpr int kP = 64;           // headdim the library is built for
constexpr int kN = 128;          // d_state the library is built for
constexpr int kTile = 16;        // threads per side of the thread grid
constexpr int kThreads = kTile * kTile;
constexpr int kQT = kQ / kTile;  // 4
constexpr int kPT = kP / kTile;  // 4
constexpr int kNT = kN / kTile;  // 8

// Padded fp32 row strides: a column walked by 16 rows hits 16 banks.
constexpr int kXS = kP + 1;      // x, dy, D, S rows
constexpr int kBS = kN + 1;      // B, C rows
constexpr int kWS = kQ + 1;      // Q x Q rows

// Shared-memory layout, in floats.
struct Smem {
  static constexpr int kX = 0;                     // x     [Q][kXS]
  static constexpr int kG = kX + kQ * kXS;         // dy    [Q][kXS]
  static constexpr int kB = kG + kQ * kXS;         // B     [Q][kBS]
  static constexpr int kC = kB + kQ * kBS;         // C     [Q][kBS]
  static constexpr int kD = kC + kQ * kBS;         // D_k   [N][kXS]
  static constexpr int kS = kD + kN * kXS;         // S_{k-1} [N][kXS]
  static constexpr int kW = kS + kN * kXS;         // W     [Q][kWS]
  static constexpr int kDCB = kW + kQ * kWS;       // dW * decay * dt [Q][kWS]
  static constexpr int kNm = kDCB + kQ * kWS;      // dW * CB * decay [Q][kWS]
  static constexpr int kDt = kNm + kQ * kWS;       // dt    [Q]
  static constexpr int kAc = kDt + kQ;             // ac    [Q]
  static constexpr int kScan = kAc + kQ;           // warp scans [Q]
  static constexpr int kCoef = kScan + kQ;         // exp(ac_last - ac) dt [Q]
  static constexpr int kE = kCoef + kQ;            // exp(ac) [Q]
  static constexpr int kRow = kE + kQ;             // sum_s dt_s Nm[q, s] [Q]
  static constexpr int kCol = kRow + kQ;           // sum_q Nm[q, s] [Q]
  static constexpr int kDcoef = kCol + kQ;         // dcoef [Q]
  static constexpr int kInter = kDcoef + kQ;       // C_q . dC_inter[q] [Q]
  static constexpr int kRed = kInter + kQ;         // block reduction [8]
  static constexpr int kFloats = kRed + 8;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};
static_assert(Smem::kBytes <= 232448, "shared memory exceeds the SM's 227 KB");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Inclusive scan over a warp (all 32 lanes call it).
__device__ __forceinline__ float warp_inclusive_scan(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) >= off) v += u;
  }
  return v;
}

// Sum over the 16 lanes that share a thread-grid row (tx = lane % 16).
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const void* dy;
  const float* s_chunks;     // [B, H, K, N, P] state before each chunk
  const float* ds_final;     // [B, H, N, P] or null
  void* dx;                  // [B, L, H, P] in x's type
  float* ddt;                // [B, L, H]
  float* dA_part;            // [B, H]
  float* dB_part;            // [B, L, H, N]
  float* dC_part;            // [B, L, H, N]
  float* ds0;                // [B, H, N, P] or null
  int L, H, G, K, intra_bf16;
};

// Grid (H, batch), one block per (b, h), chunks in reverse order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const Args a) {
  constexpr bool kLow = sizeof(T) == 2;            // bf16 inputs
  extern __shared__ float sm[];
  float* sx = sm + Smem::kX;
  float* sg = sm + Smem::kG;
  float* sB = sm + Smem::kB;
  float* sC = sm + Smem::kC;
  float* sD = sm + Smem::kD;
  float* sS = sm + Smem::kS;
  float* sW = sm + Smem::kW;
  float* sDCB = sm + Smem::kDCB;
  float* sNm = sm + Smem::kNm;
  float* sdt = sm + Smem::kDt;
  float* sac = sm + Smem::kAc;
  float* sscan = sm + Smem::kScan;
  float* scoef = sm + Smem::kCoef;
  float* se = sm + Smem::kE;
  float* srow = sm + Smem::kRow;
  float* scol = sm + Smem::kCol;
  float* sdcoef = sm + Smem::kDcoef;
  float* sinter = sm + Smem::kInter;
  float* sred = sm + Smem::kRed;

  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H, L = a.L;
  const int g = h / (H / a.G);
  const int tid = threadIdx.x, tx = tid % kTile, ty = tid / kTile;
  const float a_h = a.A[h];
  const bool intra = a.intra_bf16 != 0;

  const size_t x_row = (size_t)H * kP;              // elements between time steps of x
  const size_t bc_row = (size_t)a.G * kN;            // ... of B / C
  const size_t n_row = (size_t)H * kN;               // ... of the dB / dC partials
  const T* xb = static_cast<const T*>(a.x) + (size_t)b * L * x_row + (size_t)h * kP;
  const T* gb = static_cast<const T*>(a.dy) + (size_t)b * L * x_row + (size_t)h * kP;
  const T* Bb = static_cast<const T*>(a.B) + (size_t)b * L * bc_row + (size_t)g * kN;
  const T* Cb = static_cast<const T*>(a.C) + (size_t)b * L * bc_row + (size_t)g * kN;
  const float* dtb = a.dt + (size_t)b * L * H + h;
  T* dxb = static_cast<T*>(a.dx) + (size_t)b * L * x_row + (size_t)h * kP;
  float* ddtb = a.ddt + (size_t)b * L * H + h;
  float* dBb = a.dB_part + (size_t)b * L * n_row + (size_t)h * kN;
  float* dCb = a.dC_part + (size_t)b * L * n_row + (size_t)h * kN;
  const size_t state_off = ((size_t)b * H + h) * kN * kP;

  for (int i = tid; i < kN * kP; i += kThreads) {
    sD[(i / kP) * kXS + i % kP] = a.ds_final != nullptr ? a.ds_final[state_off + i] : 0.f;
  }
  float dA_acc = 0.f;                                // thread 0's sum of dt * da

  for (int k = a.K - 1; k >= 0; --k) {
    const int t0 = k * kQ;
    // ---- 1. Load the chunk (zeros past L: dt = 0 is an exact no-op) and
    //         the state before it; the within-chunk cumsum of a = dt * A.
    for (int i = tid; i < kQ * kP; i += kThreads) {
      const int q = i / kP, p = i % kP, t = t0 + q;
      const bool in = t < L;
      sx[q * kXS + p] = in ? to_float(xb[(size_t)t * x_row + p]) : 0.f;
      sg[q * kXS + p] = in ? to_float(gb[(size_t)t * x_row + p]) : 0.f;
    }
    for (int i = tid; i < kQ * kN; i += kThreads) {
      const int q = i / kN, n = i % kN, t = t0 + q;
      const bool in = t < L;
      sB[q * kBS + n] = in ? to_float(Bb[(size_t)t * bc_row + n]) : 0.f;
      sC[q * kBS + n] = in ? to_float(Cb[(size_t)t * bc_row + n]) : 0.f;
    }
    const float* sk = a.s_chunks + (state_off * a.K + (size_t)k * kN * kP);
    for (int i = tid; i < kN * kP; i += kThreads) sS[(i / kP) * kXS + i % kP] = sk[i];
    if (tid < kQ) {
      const int t = t0 + tid;
      const float d = t < L ? dtb[(size_t)t * H] : 0.f;
      sdt[tid] = d;
      sscan[tid] = warp_inclusive_scan(d * a_h);
    }
    __syncthreads();
    if (tid < kQ) sac[tid] = tid < 32 ? sscan[tid] : sscan[tid] + sscan[31];
    __syncthreads();
    const float ac_last = sac[kQ - 1];
    if (tid < kQ) {
      scoef[tid] = expf(ac_last - sac[tid]) * sdt[tid];
      se[tid] = expf(sac[tid]);
    }

    // ---- 2. Q x Q: CB = C B^T and dW = dy x^T on the causal triangle; W,
    //         dW * decay * dt and Nm = dW * CB * decay per element.
    {
      float cb[kQT][kQT], dw[kQT][kQT];
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int j = 0; j < kQT; ++j) cb[i][j] = dw[i][j] = 0.f;
      for (int n = 0; n < kN; ++n) {
        float c[kQT], bv[kQT];
#pragma unroll
        for (int i = 0; i < kQT; ++i) c[i] = sC[(ty + kTile * i) * kBS + n];
#pragma unroll
        for (int j = 0; j < kQT; ++j) bv[j] = sB[(tx + kTile * j) * kBS + n];
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int j = 0; j < kQT; ++j) cb[i][j] = fmaf(c[i], bv[j], cb[i][j]);
      }
      for (int p = 0; p < kP; ++p) {
        float gv[kQT], xv[kQT];
#pragma unroll
        for (int i = 0; i < kQT; ++i) gv[i] = sg[(ty + kTile * i) * kXS + p];
#pragma unroll
        for (int j = 0; j < kQT; ++j) xv[j] = sx[(tx + kTile * j) * kXS + p];
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int j = 0; j < kQT; ++j) dw[i][j] = fmaf(gv[i], xv[j], dw[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const int q = ty + kTile * i;
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          const int s = tx + kTile * j;
          float w = 0.f, dcb = 0.f, nm = 0.f;
          if (s <= q) {                      // only s <= q reaches the exp
            float decay = expf(sac[q] - sac[s]);
            float cbd, dtv = sdt[s];
            if (intra) {
              decay = round_bf16(decay);
              dtv = round_bf16(dtv);
              cbd = round_bf16(round_bf16(cb[i][j]) * decay);
            } else {
              cbd = cb[i][j] * decay;
            }
            w = cbd * dtv;
            if (kLow) w = round_bf16(w);
            dcb = dw[i][j] * decay * dtv;
            nm = dw[i][j] * cbd;
          }
          sW[q * kWS + s] = w;
          sDCB[q * kWS + s] = dcb;
          sNm[q * kWS + s] = nm;
        }
      }
    }
    __syncthreads();

    // ---- 3. Row and column sums of Nm (fixed order).
    if (tid < kQ) {
      float r = 0.f;
      for (int s = 0; s <= tid; ++s) r = fmaf(sdt[s], sNm[tid * kWS + s], r);
      srow[tid] = r;
    } else if (tid < 2 * kQ) {
      const int s = tid - kQ;
      float c = 0.f;
      for (int q = s; q < kQ; ++q) c += sNm[q * kWS + s];
      scol[s] = c;
    }

    // ---- 4a. dx = W^T dy + coef * (B D); dcoef = x . (B D).
    {
      float acc[kQT][kPT], u[kQT][kPT];
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int j = 0; j < kPT; ++j) acc[i][j] = u[i][j] = 0.f;
      for (int q = 0; q < kQ; ++q) {
        float w[kQT], gv[kPT];
#pragma unroll
        for (int i = 0; i < kQT; ++i) w[i] = sW[q * kWS + ty + kTile * i];
#pragma unroll
        for (int j = 0; j < kPT; ++j) gv[j] = sg[q * kXS + tx + kTile * j];
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int j = 0; j < kPT; ++j) acc[i][j] = fmaf(w[i], gv[j], acc[i][j]);
      }
      for (int n = 0; n < kN; ++n) {
        float bv[kQT], dv[kPT];
#pragma unroll
        for (int i = 0; i < kQT; ++i) bv[i] = sB[(ty + kTile * i) * kBS + n];
#pragma unroll
        for (int j = 0; j < kPT; ++j) dv[j] = sD[n * kXS + tx + kTile * j];
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int j = 0; j < kPT; ++j) u[i][j] = fmaf(bv[i], dv[j], u[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const int s = ty + kTile * i;
        const int t = t0 + s;
        const float cf = scoef[s];
        float dc = 0.f;
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
          const int p = tx + kTile * j;
          dc = fmaf(sx[s * kXS + p], u[i][j], dc);
          if (t < L) dxb[(size_t)t * x_row + p] = from_float<T>(fmaf(cf, u[i][j], acc[i][j]));
        }
        dc = row16_sum(dc);
        if (tx == 0) sdcoef[s] = dc;
      }
    }

    // ---- 4b. dB_h = dCB^T C + coef * (x D^T).
    {
      float acc[kQT][kNT], xd[kQT][kNT];
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) acc[i][j] = xd[i][j] = 0.f;
      for (int q = 0; q < kQ; ++q) {
        float d[kQT], c[kNT];
#pragma unroll
        for (int i = 0; i < kQT; ++i) d[i] = sDCB[q * kWS + ty + kTile * i];
#pragma unroll
        for (int j = 0; j < kNT; ++j) c[j] = sC[q * kBS + tx + kTile * j];
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) acc[i][j] = fmaf(d[i], c[j], acc[i][j]);
      }
      for (int p = 0; p < kP; ++p) {
        float xv[kQT], dv[kNT];
#pragma unroll
        for (int i = 0; i < kQT; ++i) xv[i] = sx[(ty + kTile * i) * kXS + p];
#pragma unroll
        for (int j = 0; j < kNT; ++j) dv[j] = sD[(tx + kTile * j) * kXS + p];
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) xd[i][j] = fmaf(xv[i], dv[j], xd[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const int s = ty + kTile * i;
        const int t = t0 + s;
        if (t < L) {
          const float cf = scoef[s];
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            dBb[(size_t)t * n_row + tx + kTile * j] = fmaf(cf, xd[i][j], acc[i][j]);
        }
      }
    }

    // ---- 4c. dC_h = e * (dy S^T) + dCB B; the inter term of d(ac).
    {
      float acc[kQT][kNT];
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) acc[i][j] = 0.f;
      for (int p = 0; p < kP; ++p) {
        float gv[kQT], sv[kNT];
#pragma unroll
        for (int i = 0; i < kQT; ++i) gv[i] = sg[(ty + kTile * i) * kXS + p];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float v = sS[(tx + kTile * j) * kXS + p];
          sv[j] = kLow ? round_bf16(v) : v;          // the forward's C S_{k-1} operand
        }
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) acc[i][j] = fmaf(gv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const int q = ty + kTile * i;
        const float eq = se[q];
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          acc[i][j] *= eq;
          dot = fmaf(sC[q * kBS + tx + kTile * j], acc[i][j], dot);
        }
        dot = row16_sum(dot);
        if (tx == 0) sinter[q] = dot;
      }
      for (int s = 0; s < kQ; ++s) {
        float d[kQT], bv[kNT];
#pragma unroll
        for (int i = 0; i < kQT; ++i) d[i] = sDCB[(ty + kTile * i) * kWS + s];
#pragma unroll
        for (int j = 0; j < kNT; ++j) bv[j] = sB[s * kBS + tx + kTile * j];
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) acc[i][j] = fmaf(d[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const int t = t0 + ty + kTile * i;
        if (t < L) {
#pragma unroll
          for (int j = 0; j < kNT; ++j) dCb[(size_t)t * n_row + tx + kTile * j] = acc[i][j];
        }
      }
    }
    __syncthreads();                   // every read of D_k is done

    // ---- 5. <D_k, S_{k-1}> and D_{k-1} = exp(ac_last) D_k + C^T (e dy).
    {
      const float chain = expf(ac_last);
      float acc[kNT][kPT];
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
          const int off = (ty + kTile * i) * kXS + tx + kTile * j;
          dot = fmaf(sD[off], sS[off], dot);
          acc[i][j] = chain * sD[off];
        }
      for (int q = 0; q < kQ; ++q) {
        const float eq = se[q];
        float c[kNT], gv[kPT];
#pragma unroll
        for (int i = 0; i < kNT; ++i) c[i] = sC[q * kBS + ty + kTile * i] * eq;
#pragma unroll
        for (int j = 0; j < kPT; ++j) gv[j] = sg[q * kXS + tx + kTile * j];
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int j = 0; j < kPT; ++j) acc[i][j] = fmaf(c[i], gv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int j = 0; j < kPT; ++j) sD[(ty + kTile * i) * kXS + tx + kTile * j] = acc[i][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if ((tid & 31) == 0) sred[tid / 32] = dot;
    }
    __syncthreads();

    // ---- 6. d(ac) -> da (reverse cumsum) -> ddt and dA, in one thread
    //         (64 positions; a fixed order).
    if (tid == 0) {
      float dot = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) dot += sred[w];
      float dlast = expf(ac_last) * dot;
      for (int s = 0; s < kQ; ++s) dlast = fmaf(scoef[s], sdcoef[s], dlast);
      float da = 0.f;
      for (int q = kQ - 1; q >= 0; --q) {
        float dac = srow[q] - sdt[q] * scol[q] + sinter[q] - scoef[q] * sdcoef[q];
        if (q == kQ - 1) dac += dlast;
        da += dac;
        const int t = t0 + q;
        if (t < L) {
          ddtb[(size_t)t * H] = scol[q] + expf(ac_last - sac[q]) * sdcoef[q] + a_h * da;
        }
        dA_acc = fmaf(sdt[q], da, dA_acc);
      }
    }
    __syncthreads();                   // the chunk's buffers are free
  }

  if (tid == 0) a.dA_part[(size_t)b * H + h] = dA_acc;
  if (a.ds0 != nullptr) {
    for (int i = tid; i < kN * kP; i += kThreads) a.ds0[state_off + i] = sD[(i / kP) * kXS + i % kP];
  }
}

template <typename T>
int launch(const Args& args, int batch, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool ready[64] = {};
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Smem::kBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  ssd_bwd_kernel<T><<<dim3(args.H, batch), kThreads, Smem::kBytes, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Whether the library is built for (P, N).
int hnet_ssd_bwd_supported(int P, int N) { return P == kP && N == kN; }

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy and dx). s_chunks holds the
// fp32 state before each of the K = ceil(L / 64) chunks, as the forward
// kernel writes it. ds_final and ds0 may be null. dB_part / dC_part are the
// per-head gradients [B, L, H, N] and dA_part [B, H] the per-(b, h) sums,
// which the caller reduces. Returns a cudaError_t code, 0 on success;
// launches asynchronously on `stream`.
int hnet_ssd_bwd(int dtype, const void* x, const float* dt, const float* A, const void* B,
                 const void* C, const void* dy, const float* s_chunks, const float* ds_final,
                 void* dx, float* ddt, float* dA_part, float* dB_part, float* dC_part,
                 float* ds0, int batch, int L, int H, int G, int P, int N, int intra_bf16,
                 void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      !hnet_ssd_bwd_supported(P, N))
    return (int)cudaErrorInvalidValue;
  const Args args{x, dt, A, B, C, dy, s_chunks, ds_final, dx, ddt, dA_part, dB_part, dC_part,
                  ds0, L, H, G, (L + kQ - 1) / kQ, intra_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(args, batch, s);
  if (dtype == 1) return launch<__nv_bfloat16>(args, batch, s);
  return (int)cudaErrorInvalidValue;
}

const char* hnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
