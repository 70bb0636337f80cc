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
// (D_{K-1} = d(final state)), over chunks k, in fp32:
//   ac, coef_s = exp(ac_last - ac_s) dt_s, e_q = exp(ac_q)    (as the forward)
//   CB = C B^T, W = CB * exp(ac_q - ac_s) * dt_s (s <= q, masked BEFORE exp)
//   dW   = dy x^T (s <= q);  Nm = dW * CB * exp(ac_q - ac_s);  dcb = dW * exp(..) * dt
//   dx   = W^T dy + coef * (B D_k)
//   dB   = sum over the group's heads of dcb^T C + coef * (x D_k^T)
//   dC   = sum over the group's heads of dcb B + e * (dy S_{k-1}^T)
//   d(ac_q) = sum_s dt_s Nm[q,s] - dt_q sum_q' Nm[q',q] + e_q C_q . (dy S_{k-1}^T)_q
//             - coef_q dcoef_q  (+ at q = last: sum_s coef_s dcoef_s
//             + exp(ac_last) <D_k, S_{k-1}>),  dcoef_s = x_s . (B D_k)_s
//   da = reverse cumsum of d(ac); ddt = colsum Nm + exp(ac_last - ac) dcoef
//        + A da;  dA_h = sum over b and k of sum dt da
//   D_{k-1} = exp(ac_last) D_k + C^T (e * dy)
// and d(initial_state) = D_{-1}. With bf16 inputs the forward values are
// rounded where the forward rounds them (W, and S_{k-1} in C S_{k-1}; under
// intra_dtype bf16 also the scores, decays and dt). Autograd of the bf16
// ssd_chunked also rounds the gradients at those casts; this kernel keeps
// them in fp32 but for D_k as a product operand (below), so the two part by
// about a bf16 ulp of each term (the tolerances in tests/test_torch_cuda.py
// and chip_smoke.py).
//
// Which dtype takes which path. bf16 inputs (the training path) take the two
// launches below. fp32 inputs keep the first version of this kernel: one
// block per (b, h) walking its chunks in reverse on SIMT fp32 FMAs (a TF32
// tensor-core product would not be fp32), per-head fp32 dB / dC partials
// and per-(b, h) dA that the caller sums.
//
// What bounds it on the card. At the training shape (bf16, B 32, L 249,
// H 16, P 64, N 128, G 1, K 4) the function must read x, dy, B, C, dt and
// write dx, dB, dC, ddt: 58 MB, 17.35 us at 3.35 TB/s, against 11.1 GFLOP
// of products in the chunked form (C B^T and the intra dB / dC products
// once per group, the rest per head; tools/measure.py::ssd_bwd_cost), 11.3
// us at 989 TFLOP/s. So the function is bound by its bytes. This design
// adds its own: the forward's fp32 chunk states read once (67 MB: B H K N P
// floats), and D_k written by launch 1 and read by launch 2 (2 x 33.5 MB in
// bf16): 134 MB more, ~40 us, so ~57 us is the least this design could
// take.
//
// The first version (0.98 ms there, 1.8 % of the bound) was held back by
// four things; what this one does about each:
// 1. Every product on SIMT fp32 FMAs, C B^T and the intra dB / dC products
//    once per head (17.2 GFLOP a call, >= 256 us at 67 TFLOP/s). Now every
//    product is an mma.sync.m16n8k16 bf16 MMA with fp32 accumulation, fed by
//    ldmatrix from padded shared-memory rows (ssd_common.cuh, the forward's
//    helpers), and C B^T, dcb^T C and dcb B run once per group. The operands
//    are exact bf16 (x, dy, B, C, W, and S_{k-1}, rounded from the forward's
//    fp32 state as the forward rounds it) but for three fp32 values: C e
//    (launch 1) and the group's sum of dcb are split into bf16 hi + lo (two
//    MMAs, ~fp32), and D_k is rounded once to bf16, also in the dot
//    <D_k, S_{k-1}> with the fp32 state. On the CPU mirror
//    (tests/test_torch_ssd_grad.py) at the training widths that moved no
//    gradient's max error against autograd of the bf16 ssd_chunked, while
//    a single rounding of dcb doubled dB's.
// 2. One block per (b, h), 218 KB of shared memory, its chunks in turn.
//    Launch 1, the reverse chain, mirrors the forward's: one thread-block
//    cluster of up to 8 CTAs per (b, h), one chunk per CTA per round (a
//    longer L takes several rounds, D passing between them in shared
//    memory). Each CTA forms its chunk's dD_k = C^T (e dy) from zero; after a
//    cluster barrier the chain D_{k-1} = exp(ac_last) D_k + dD_k runs in
//    reverse order of k in fp32, each CTA on its slice of the N P elements,
//    reading dD_k through distributed shared memory and writing D_k in bf16
//    for launch 2. ~67 KB and 80 registers a thread (a few spilled): 3
//    CTAs an SM, which measured faster than 2 without the spills.
//    Launch 2, the chunk terms: one CTA of 16 warps per (b, group g, chunk
//    k) that loops over the group's heads; B, C and every head's dt are
//    loaded once, each head's x, dy, D_k and fp32 S_{k-1} by cp.async into
//    one of two stages, so that the next head's copies fly while this one
//    computes (~210 KB, one CTA an SM). At B 32 K 4 G 1 that is 128 CTAs
//    on 132 SMs. Where the (b, g, k) CTAs would fill less than half the card
//    (B 1 at L 249: 4 CTAs) the group's heads are split evenly over several
//    CTAs, each writing fp32 dB / dC partials (a few MB) that the caller
//    sums over the splits in a fixed order; at the training shape there is
//    one split and no partial. The first version of this design formed the
//    dot in launch 1 from the fp32 states and handed launch 2 bf16 copies of
//    them: 67 MB more traffic, and launch 1 was then the slower of the two.
// 3. Per-head fp32 dB / dC partials [B, L, H, N] (130 MB) and their
//    torch.sum. Now each launch-2 CTA keeps the group's sums in fp32
//    registers across its heads (sum dcb; sum coef (x D^T); sum e (dy S^T))
//    and writes dB and dC once, in bf16. The heads are summed in a fixed
//    order and no float atomics are used, so two calls on the same inputs
//    give bitwise-equal gradients. dA leaves as [B, H, K] fp32 partials.
// 4. One thread for the serial tail, 255 threads waiting. Now one warp per
//    head turns the warps' partial sums into d(ac), its reverse cumsum (warp
//    suffix scans), ddt and the dA partial, and another forms the next
//    head's cumsum, both in warps whose tile of the causal Q x Q product is
//    empty, while the other warps compute (the per-head sums are kept in
//    three sets, by head modulo 3): two barriers per head.
//
// Measured on an H100 (PERF.md): 5-6x the first version at the
// training shape, ~10 % of the bound. Launch 2 takes two thirds of a call
// and is bound by its compute, not its copies (tools/measure.py
// bwd_phases): its products are few, but the 16 x 16 warp tiles make four
// warps load each operand fragment, and a head's phases wait on each
// other's latency. wgmma on 64-row tiles, which share their shared-memory
// operands across a warpgroup, is the next step.

#include <cooperative_groups.h>

#include "ssd_common.cuh"

namespace cg = cooperative_groups;

namespace {

// =========================================================================
// fp32: one block per (b, h), SIMT FMAs (the first version of the kernel)
// =========================================================================

namespace simt {

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

// Sum over the 16 lanes that share a thread-grid row (tx = lane % 16).
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* dy;
  const float* s_chunks;     // [B, H, K, N, P] state before each chunk
  const float* ds_final;     // [B, H, N, P] or null
  float* dx;                 // [B, L, H, P]
  float* ddt;                // [B, L, H]
  float* dA_part;            // [B, H]
  float* dB_part;            // [B, L, H, N]
  float* dC_part;            // [B, L, H, N]
  float* ds0;                // [B, H, N, P] or null
  int L, H, G, K, intra_bf16;
};

// Grid (H, batch), one block per (b, h), chunks in reverse order.
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_fp32_kernel(const Args a) {
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
  const float* xb = a.x + (size_t)b * L * x_row + (size_t)h * kP;
  const float* gb = a.dy + (size_t)b * L * x_row + (size_t)h * kP;
  const float* Bb = a.B + (size_t)b * L * bc_row + (size_t)g * kN;
  const float* Cb = a.C + (size_t)b * L * bc_row + (size_t)g * kN;
  const float* dtb = a.dt + (size_t)b * L * H + h;
  float* dxb = a.dx + (size_t)b * L * x_row + (size_t)h * kP;
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
      sx[q * kXS + p] = in ? xb[(size_t)t * x_row + p] : 0.f;
      sg[q * kXS + p] = in ? gb[(size_t)t * x_row + p] : 0.f;
    }
    for (int i = tid; i < kQ * kN; i += kThreads) {
      const int q = i / kN, n = i % kN, t = t0 + q;
      const bool in = t < L;
      sB[q * kBS + n] = in ? Bb[(size_t)t * bc_row + n] : 0.f;
      sC[q * kBS + n] = in ? Cb[(size_t)t * bc_row + n] : 0.f;
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
          if (t < L) dxb[(size_t)t * x_row + p] = fmaf(cf, u[i][j], acc[i][j]);
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
          sv[j] = sS[(tx + kTile * j) * kXS + p];
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

int launch(const Args& args, int batch, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool ready[64] = {};
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ssd_bwd_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Smem::kBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  ssd_bwd_fp32_kernel<<<dim3(args.H, batch), kThreads, Smem::kBytes, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace simt

#if SSD_BF16
// =========================================================================
// bf16: launch 1, the reverse state chain, one cluster of CTAs per (b, h)
// =========================================================================

constexpr int kWarps1 = 8;
constexpr int kThreads1 = 32 * kWarps1;
constexpr int kMaxCluster = 8;            // portable cluster size: chunks in a round
constexpr int kRowX = kP + 8;             // bf16 rows of 64 (x, dy, W, D, S), +16 bytes
constexpr int kRowB = kN + 8;             // bf16 rows of 128 (B, C), +16 bytes
constexpr int kRowD = kP + 8;             // fp32 rows of dD_k
constexpr int kPairs = kN * kP / 2;       // element pairs of a state

struct Bf16Args {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  const __nv_bfloat16* dy;
  const float* s_chunks;        // [B, H, K, N, P] fp32 state before each chunk (forward)
  const float* ds_final;        // [B, H, N, P] or null
  __nv_bfloat16* Db;            // [B, H, K, N, P] D_k, rounded: launch 1 -> launch 2
  __nv_bfloat16* dx;            // [B, L, H, P]
  float* ddt;                   // [B, L, H]
  float* dA_part;               // [B, H, K]
  __nv_bfloat16* dB;            // [B, L, G, N] when the heads of a group are not split
  __nv_bfloat16* dC;
  float* dB_part;               // [splits, B, L, G, N] when they are
  float* dC_part;
  float* ds0;                   // [B, H, N, P] or null
  int batch, L, H, G, K, intra_bf16, splits, heads_per_split;
};

// Shared memory of a chain CTA (bytes; every array 16-byte aligned).
struct ChainSmem {
  static constexpr int kC = 0;                                    // C    [Q][kRowB] bf16
  static constexpr int kG = kC + kQ * kRowB * 2;                  // dy   [Q][kRowX] bf16
  static constexpr int kDD = kG + kQ * kRowX * 2;                 // dD_k [N][kRowD] fp32
  static constexpr int kCarry = kDD + kN * kRowD * 4;             // D between rounds
  static constexpr int kDt = kCarry + kPairs / kMaxCluster * 8;   // dt   [Q]
  static constexpr int kE = kDt + kQ * 4;                         // exp(ac) [Q]
  static constexpr int kDecay = kE + kQ * 4;                      // exp(ac_last), 16 bytes
  static constexpr int kBytes = kDecay + 16;
};

// The copies of chunk k (C, dy, dt), zero-filled past L; none for k < 0.
__device__ __forceinline__ void load_chain_chunk(const Bf16Args& a, char* smem, int k, int b,
                                                 int h, int g) {
  const int tid = threadIdx.x;
  if (k >= 0) {
    const int t0 = k * kQ;
    const size_t x_row = (size_t)a.H * kP, bc_row = (size_t)a.G * kN;
    const __nv_bfloat16* gb = a.dy + (size_t)b * a.L * x_row + (size_t)h * kP;
    const __nv_bfloat16* Cb = a.C + (size_t)b * a.L * bc_row + (size_t)g * kN;
    __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem + ChainSmem::kC);
    __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem + ChainSmem::kG);
    float* sdt = reinterpret_cast<float*>(smem + ChainSmem::kDt);
    for (int i = tid; i < kQ * (kN / 8); i += kThreads1) {
      const int q = i / (kN / 8), c = i % (kN / 8), t = t0 + q;
      const bool in = t < a.L;
      cp_async16(sC + q * kRowB + c * 8, Cb + (size_t)(in ? t : 0) * bc_row + c * 8, in);
    }
    for (int i = tid; i < kQ * (kP / 8); i += kThreads1) {
      const int q = i / (kP / 8), c = i % (kP / 8), t = t0 + q;
      const bool in = t < a.L;
      cp_async16(sg + q * kRowX + c * 8, gb + (size_t)(in ? t : 0) * x_row + c * 8, in);
    }
    if (tid < kQ) {
      const int t = t0 + tid;
      const bool in = t < a.L;
      cp_async4(sdt + tid, a.dt + ((size_t)b * a.L + (in ? t : 0)) * a.H + h, in);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Grid (cluster size, H, batch), one cluster per (b, h). Chunks are taken
// from the last: in round r, CTA `rank` owns chunk k = K - 1 - (r cs + rank).
__global__ void __launch_bounds__(kThreads1, 3)
ssd_bwd_chain_kernel(const Bf16Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) char smem[];
  const __nv_bfloat16* sC = reinterpret_cast<const __nv_bfloat16*>(smem + ChainSmem::kC);
  const __nv_bfloat16* sg = reinterpret_cast<const __nv_bfloat16*>(smem + ChainSmem::kG);
  float* sdD = reinterpret_cast<float*>(smem + ChainSmem::kDD);
  float2* scarry = reinterpret_cast<float2*>(smem + ChainSmem::kCarry);
  const float* sdt = reinterpret_cast<const float*>(smem + ChainSmem::kDt);
  float* se = reinterpret_cast<float*>(smem + ChainSmem::kE);
  float* sdecay = reinterpret_cast<float*>(smem + ChainSmem::kDecay);

  const int cs = (int)gridDim.x;
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tq = lane % 4;                        // mma fragment column pair
  const int mi = lane / 8, ri = lane % 8;         // ldmatrix: matrix and row of the lane
  const float a_h = a.A[h];
  const int K = a.K;
  const int rounds = (K + cs - 1) / cs;
  const size_t state_off = ((size_t)b * a.H + h) * kN * kP;

  load_chain_chunk(a, smem, K - 1 - rank, b, h, g);

  for (int r = 0; r < rounds; ++r) {
    const int j_first = r * cs;
    const int nk = min(K - j_first, cs);          // chunks of this round
    const int k = K - 1 - (j_first + rank);       // this CTA's chunk
    const bool mine = k >= 0;                     // uniform over the CTA

    // ---- A: dD_k = C^T (e dy) from zero, on tensor cores -------------------
    cp_async_wait<0>();
    __syncthreads();
    if (mine) {
      if (warp == 0) {                            // the chunk's cumsum, as the forward's
        const float s0 = warp_inclusive_scan(sdt[lane] * a_h);
        const float s1 = warp_inclusive_scan(sdt[lane + 32] * a_h) +
                         __shfl_sync(0xffffffffu, s0, 31);
        se[lane] = expf(s0);
        se[lane + 32] = expf(s1);
        const float last = __shfl_sync(0xffffffffu, s1, 31);
        if (lane == 0) sdecay[0] = expf(last);
      }
      __syncthreads();
      // warp w: rows n in [16w, 16w + 16) of dD, all kP columns. A = (C e)^T
      // [n][q] from C stored [q][n] (ldmatrix.trans), each element times its
      // e_q and split into bf16 hi + lo: two products, ~fp32 exact
      float acc[kP / 8][4];
#pragma unroll
      for (int i = 0; i < kP / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      const int n0 = 16 * warp;
#pragma unroll
      for (int s0 = 0; s0 < kQ; s0 += 16) {
        uint32_t af[4], hi[4], lo[4];
        ldmatrix_x4_trans(af, sC + (s0 + ri + 8 * (mi / 2)) * kRowB + n0 + 8 * (mi % 2));
        const float e0 = se[s0 + 2 * tq], e1 = se[s0 + 2 * tq + 1];
        const float e8 = se[s0 + 2 * tq + 8], e9 = se[s0 + 2 * tq + 9];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = unpack_bf16(af[i]);
          const float px = v.x * (i < 2 ? e0 : e8), py = v.y * (i < 2 ? e1 : e9);
          hi[i] = pack_bf16(px, py);
          const float2 hv = unpack_bf16(hi[i]);
          lo[i] = pack_bf16(px - hv.x, py - hv.y);
        }
#pragma unroll
        for (int p0 = 0; p0 < kP; p0 += 16) {
          uint32_t bf[4];                         // B = dy [q][p]: ldmatrix.trans
          ldmatrix_x4_trans(bf, sg + (s0 + ri + 8 * (mi % 2)) * kRowX + p0 + 8 * (mi / 2));
          mma_bf16(acc[p0 / 8], hi, bf[0], bf[1]);
          mma_bf16(acc[p0 / 8 + 1], hi, bf[2], bf[3]);
          mma_bf16(acc[p0 / 8], lo, bf[0], bf[1]);
          mma_bf16(acc[p0 / 8 + 1], lo, bf[2], bf[3]);
        }
      }
      const int gq = lane / 4;
#pragma unroll
      for (int i = 0; i < kP / 8; ++i) {
        const int p = 8 * i + 2 * tq;
        *reinterpret_cast<float2*>(sdD + (n0 + gq) * kRowD + p) = make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(sdD + (n0 + gq + 8) * kRowD + p) =
            make_float2(acc[i][2], acc[i][3]);
      }
    }
    __syncthreads();                  // C, dy, dt and e of this chunk are read
    if (r + 1 < rounds) load_chain_chunk(a, smem, k - cs, b, h, g);   // flies over the chain
    cluster.sync();                   // every dD_k of the round is visible

    // ---- B: the chain over the round's chunks, k decreasing ----------------
    // Pair i of the state's element pairs is (n, p) = (i / (kP/2), 2 (i % (kP/2))),
    // taken by CTA i / kThreads1 % cs. For each chunk it writes D_k, rounded
    // to bf16, for launch 2 and steps D_{k-1} = exp(ac_last) D_k + dD_k in
    // fp32.
    {
      float decay[kMaxCluster];
#pragma unroll
      for (int kk = 0; kk < kMaxCluster; ++kk) {
        if (kk < nk)
          decay[kk] = *reinterpret_cast<const float*>(
              cluster.map_shared_rank(smem, kk) + ChainSmem::kDecay);
      }
      int it = 0;
      for (int i = rank * kThreads1 + tid; i < kPairs; i += cs * kThreads1, ++it) {
        const int n = i / (kP / 2), p = 2 * (i % (kP / 2));
        float2 dD[kMaxCluster];
#pragma unroll
        for (int kk = 0; kk < kMaxCluster; ++kk)
          if (kk < nk)
            dD[kk] = *reinterpret_cast<const float2*>(
                cluster.map_shared_rank(smem, kk) + ChainSmem::kDD + 4 * (n * kRowD + p));
        const size_t st = state_off + (size_t)n * kP + p;
        float2 D = make_float2(0.f, 0.f);
        if (r > 0) D = scarry[it * kThreads1 + tid];
        else if (a.ds_final != nullptr) D = *reinterpret_cast<const float2*>(a.ds_final + st);
#pragma unroll
        for (int kk = 0; kk < kMaxCluster; ++kk) {
          if (kk < nk) {
            const size_t idx = state_off * K + (size_t)(K - 1 - (j_first + kk)) * kN * kP +
                               (size_t)n * kP + p;
            *reinterpret_cast<uint32_t*>(a.Db + idx) = pack_bf16(D.x, D.y);
            D.x = __fadd_rn(__fmul_rn(decay[kk], D.x), dD[kk].x);
            D.y = __fadd_rn(__fmul_rn(decay[kk], D.y), dD[kk].y);
          }
        }
        if (r + 1 < rounds) scarry[it * kThreads1 + tid] = D;
        else if (a.ds0 != nullptr) *reinterpret_cast<float2*>(a.ds0 + st) = D;
      }
    }
    cluster.sync();                   // every read of the round's dD_k is done
  }
  // No CTA touches another's shared memory after the last cluster barrier.
}

// =========================================================================
// bf16: launch 2, the chunk terms, one CTA per (b, group, chunk[, heads])
// =========================================================================

constexpr int kWarps2 = 16;               // launch 2: warp w takes row block w % 4
constexpr int kThreads2 = 32 * kWarps2;   //   and column quarter w / 4 of each product
constexpr int kRowS = kP + 8;             // fp32 rows of S_{k-1}: conflict-free 8-byte loads
constexpr int kMaxHeads = 32;             // heads of a launch-2 CTA (dt of all of them kept)
constexpr int kScalarWarp = 4;            // (rb 0, cq 1): no Q x Q tile, forms the next head's scalars
constexpr int kFinishWarp = 12;           // (rb 0, cq 3): no Q x Q tile, finishes the last head

// One head's copies (x, dy, D_k and the forward's fp32 S_{k-1}), in bytes.
struct Stage {
  static constexpr int kX = 0;                        // x   [Q][kRowX] bf16
  static constexpr int kG = kX + kQ * kRowX * 2;      // dy  [Q][kRowX] bf16
  static constexpr int kD = kG + kQ * kRowX * 2;      // D_k [N][kRowX] bf16
  static constexpr int kS = kD + kN * kRowX * 2;      // S_{k-1} [N][kRowS] fp32
  static constexpr int kBytes = kS + kN * kRowS * 4;
};

// One head's scalars and the warps' partial sums (floats); three sets, by
// head modulo 3: while head i runs, one warp finishes head i - 1 and another
// forms head i + 1's scalars.
struct HeadVec {
  static constexpr int kAc = 0;                       // ac [Q]
  static constexpr int kCoef = kAc + kQ;              // exp(ac_last - ac) dt [Q]
  static constexpr int kE = kCoef + kQ;               // exp(ac) [Q]
  static constexpr int kDt = kE + kQ;                 // dt [Q]
  static constexpr int kRow = kDt + kQ;               // sum_s dt_s Nm[q, s], per column quarter [4][Q]
  static constexpr int kCol = kRow + 4 * kQ;          // sum_q Nm[q, s], per row block [4][Q]
  static constexpr int kInter = kCol + 4 * kQ;        // C_q . (dy S^T)_q, per column quarter [4][Q]
  static constexpr int kDcoef = kInter + 4 * kQ;      // x_s . (B D)_s, per column quarter [4][Q]
  static constexpr int kDot = kDcoef + 4 * kQ;        // <D_k, S_{k-1}>, per warp [kWarps2]
  static constexpr int kFloats = kDot + kWarps2;
};

struct ChunkSmem {
  static constexpr int kB = 0;                                  // B [Q][kRowB] bf16
  static constexpr int kC = kB + kQ * kRowB * 2;                // C [Q][kRowB] bf16
  static constexpr int kW = kC + kQ * kRowB * 2;                // W [Q][kRowX] bf16
  static constexpr int kDt = kW + kQ * kRowX * 2;               // dt [kMaxHeads][Q] fp32
  static constexpr int kA = kDt + kMaxHeads * kQ * 4;           // A [kMaxHeads] fp32
  static constexpr int kStage = kA + kMaxHeads * 4;             // two Stages
  static constexpr int kHead = kStage + 2 * Stage::kBytes;      // three HeadVecs
  static constexpr int kBytes = kHead + 3 * HeadVec::kFloats * 4;
};
static_assert(ChunkSmem::kBytes <= 232448, "shared memory exceeds the SM's 227 KB");

__device__ __forceinline__ void load_head(const Bf16Args& a, char* stage, int b, int h, int k) {
  const int tid = threadIdx.x;
  const int t0 = k * kQ;
  const size_t x_row = (size_t)a.H * kP;
  const size_t xoff = (size_t)b * a.L * x_row + (size_t)h * kP;
  const size_t soff = (((size_t)b * a.H + h) * a.K + k) * kN * kP;
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(stage + Stage::kX);
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(stage + Stage::kG);
  __nv_bfloat16* sD = reinterpret_cast<__nv_bfloat16*>(stage + Stage::kD);
  float* sS = reinterpret_cast<float*>(stage + Stage::kS);
  for (int i = tid; i < kQ * (kP / 8); i += kThreads2) {
    const int q = i / (kP / 8), c = i % (kP / 8), t = t0 + q;
    const bool in = t < a.L;
    const size_t src = xoff + (size_t)(in ? t : 0) * x_row + c * 8;
    cp_async16(sx + q * kRowX + c * 8, a.x + src, in);
    cp_async16(sg + q * kRowX + c * 8, a.dy + src, in);
  }
  for (int i = tid; i < kN * (kP / 8); i += kThreads2) {
    const int n = i / (kP / 8), c = i % (kP / 8);
    cp_async16(sD + n * kRowX + c * 8, a.Db + soff + n * kP + c * 8, true);
  }
  for (int i = tid; i < kN * (kP / 4); i += kThreads2) {
    const int n = i / (kP / 4), c = i % (kP / 4);
    cp_async16(sS + n * kRowS + c * 4, a.s_chunks + soff + n * kP + c * 4, true);
  }
  cp_async_commit();
}

// One warp: head h's cumsum (as the forward's), coef = exp(ac_last - ac) dt
// and e = exp(ac), from its dt in shared memory.
__device__ __forceinline__ void head_scalars(const float* sdt, float a_h, float* hv) {
  const int lane = threadIdx.x & 31;
  const float d0 = sdt[lane], d1 = sdt[lane + 32];
  const float s0 = warp_inclusive_scan(d0 * a_h);
  const float s1 = warp_inclusive_scan(d1 * a_h) + __shfl_sync(0xffffffffu, s0, 31);
  const float last = __shfl_sync(0xffffffffu, s1, 31);
  hv[HeadVec::kAc + lane] = s0;
  hv[HeadVec::kAc + lane + 32] = s1;
  hv[HeadVec::kDt + lane] = d0;
  hv[HeadVec::kDt + lane + 32] = d1;
  hv[HeadVec::kCoef + lane] = expf(last - s0) * d0;
  hv[HeadVec::kCoef + lane + 32] = expf(last - s1) * d1;
  hv[HeadVec::kE + lane] = expf(s0);
  hv[HeadVec::kE + lane + 32] = expf(s1);
}

// Suffix sums over a warp: lane l gets the sum of lanes l..31.
__device__ __forceinline__ float warp_suffix_scan(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) + off < 32) v += u;
  }
  return v;
}

// One warp: a head's d(ac) from the warps' partial sums, its reverse cumsum
// to da, then ddt and the head's dA partial. Lane l takes positions l, l + 32.
__device__ void finish_head(const Bf16Args& a, const float* hv, float a_h, int b, int h, int k) {
  const int lane = threadIdx.x & 31;
  float dot = 0.f;
  for (int w = 0; w < kWarps2; ++w) dot += hv[HeadVec::kDot + w];
  float dac[2], col[2], dco[2], ac[2], dt[2], cd[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = lane + 32 * j;
    float row = 0.f, inter = 0.f;
    col[j] = dco[j] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      row += hv[HeadVec::kRow + c * kQ + q];
      col[j] += hv[HeadVec::kCol + c * kQ + q];
      inter += hv[HeadVec::kInter + c * kQ + q];
      dco[j] += hv[HeadVec::kDcoef + c * kQ + q];
    }
    dt[j] = hv[HeadVec::kDt + q];
    ac[j] = hv[HeadVec::kAc + q];
    cd[j] = hv[HeadVec::kCoef + q] * dco[j];
    dac[j] = row - dt[j] * col[j] + hv[HeadVec::kE + q] * inter - cd[j];
  }
  const float tot = warp_sum(cd[0] + cd[1]);
  const float last = hv[HeadVec::kAc + kQ - 1];
  if (lane == 31) dac[1] += tot + expf(last) * dot;
  const float da1 = warp_suffix_scan(dac[1]);
  const float da0 = warp_suffix_scan(dac[0]) + __shfl_sync(0xffffffffu, da1, 0);
  const float da[2] = {da0, da1};
  float* ddtb = a.ddt + (size_t)b * a.L * a.H + h;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = k * kQ + lane + 32 * j;
    if (t < a.L) ddtb[(size_t)t * a.H] = col[j] + expf(last - ac[j]) * dco[j] + a_h * da[j];
  }
  const float s = warp_sum(fmaf(dt[0], da0, dt[1] * da1));
  if (lane == 0) a.dA_part[((size_t)b * a.H + h) * a.K + k] = s;
}

// Grid (K, G x splits, batch), 16 warps. Warp w works on row block
// rb = w % 4 (16 positions) and column quarter cq = w / 4 of each product.
__global__ void __launch_bounds__(kThreads2, 1)
ssd_bwd_chunk_kernel(const Bf16Args a) {
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem + ChunkSmem::kB);
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem + ChunkSmem::kC);
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(smem + ChunkSmem::kW);
  float* hv0 = reinterpret_cast<float*>(smem + ChunkSmem::kHead);

  const int k = blockIdx.x, b = blockIdx.z;
  const int g = blockIdx.y / a.splits, sp = blockIdx.y % a.splits;
  const int hg = a.H / a.G;
  const int h0 = g * hg + sp * a.heads_per_split;
  const int nh = min(a.heads_per_split, hg - sp * a.heads_per_split);
  const int t0 = k * kQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int mi = lane / 8, ri = lane % 8;
  const int rb = warp % 4, cq = warp / 4;
  const int q0 = 16 * rb, qa = q0 + gq, qb = qa + 8;
  const bool intra = a.intra_bf16 != 0;

  float* sdt = reinterpret_cast<float*>(smem + ChunkSmem::kDt);
  float* sA = reinterpret_cast<float*>(smem + ChunkSmem::kA);
  {                                                 // B, C and every head's dt and A, once
    const size_t bc_row = (size_t)a.G * kN;
    const size_t off = (size_t)b * a.L * bc_row + (size_t)g * kN;
    for (int i = tid; i < kQ * (kN / 8); i += kThreads2) {
      const int q = i / (kN / 8), c = i % (kN / 8), t = t0 + q;
      const bool in = t < a.L;
      const size_t src = off + (size_t)(in ? t : 0) * bc_row + c * 8;
      cp_async16(sB + q * kRowB + c * 8, a.B + src, in);
      cp_async16(sC + q * kRowB + c * 8, a.C + src, in);
    }
    for (int i = tid; i < nh * kQ; i += kThreads2) {
      const int j = i / kQ, q = i % kQ, t = t0 + q;
      const bool in = t < a.L;
      cp_async4(sdt + j * kQ + q, a.dt + ((size_t)b * a.L + (in ? t : 0)) * a.H + h0 + j, in);
    }
    if (tid < nh) cp_async4(sA + tid, a.A + h0 + tid, true);
    cp_async_commit();
  }
  load_head(a, smem + ChunkSmem::kStage, b, h0, k);
  cp_async_wait<1>();
  __syncthreads();
  if (warp == 0) head_scalars(sdt, sA[0], hv0);

  // C B^T on this warp's 16 x 16 tile (rb, cq) of the causal Q x Q; tiles
  // above the diagonal (cq > rb) are never formed
  float cb[2][4], dcb[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[t][e] = dcb[t][e] = 0.f;
  if (cq <= rb) {
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t af[4], bf[4];
      ldmatrix_x4(af, sC + (q0 + ri + 8 * (mi % 2)) * kRowB + 16 * kk + 8 * (mi / 2));
      ldmatrix_x4(bf, sB + (16 * cq + ri + 8 * (mi / 2)) * kRowB + 16 * kk + 8 * (mi % 2));
      mma_bf16(cb[0], af, bf[0], bf[1]);
      mma_bf16(cb[1], af, bf[2], bf[3]);
    }
  }
  // the group's sums in this warp's rows and columns [32 cq, 32 cq + 32) of
  // [Q][N]: sum coef (x D^T) for dB and sum e (dy S^T) for dC
  float dBa[4][4], dCa[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dBa[t][e] = dCa[t][e] = 0.f;

  for (int i = 0; i < nh; ++i) {
    const int par = i & 1, h = h0 + i;
    char* stage = smem + ChunkSmem::kStage + par * Stage::kBytes;
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(stage + Stage::kX);
    const __nv_bfloat16* sg = reinterpret_cast<const __nv_bfloat16*>(stage + Stage::kG);
    const __nv_bfloat16* sD = reinterpret_cast<const __nv_bfloat16*>(stage + Stage::kD);
    const float* sS = reinterpret_cast<const float*>(stage + Stage::kS);
    float* hv = hv0 + (i % 3) * HeadVec::kFloats;

    cp_async_wait<0>();
    __syncthreads();                // head i's copies and scalars are in; head i - 1 is done
    if (i + 1 < nh)                 // the next head's copies fly while this one computes
      load_head(a, smem + ChunkSmem::kStage + (par ^ 1) * Stage::kBytes, b, h + 1, k);
    // two warps without a Q x Q tile: the next head's scalars, the last head's end
    if (warp == kScalarWarp && i + 1 < nh)
      head_scalars(sdt + (i + 1) * kQ, sA[i + 1], hv0 + ((i + 1) % 3) * HeadVec::kFloats);
    else if (warp == kFinishWarp && i > 0)
      finish_head(a, hv0 + ((i + 2) % 3) * HeadVec::kFloats, sA[i - 1], b, h - 1, k);

    // ---- Q x Q: dW = dy x^T; W, the group's dcb and Nm's row / column sums
    {
      float dw[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) dw[t][e] = 0.f;
      if (cq <= rb) {
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, sg + (q0 + ri + 8 * (mi % 2)) * kRowX + 16 * kk + 8 * (mi / 2));
          ldmatrix_x4(bf, sx + (16 * cq + ri + 8 * (mi / 2)) * kRowX + 16 * kk + 8 * (mi % 2));
          mma_bf16(dw[0], af, bf[0], bf[1]);
          mma_bf16(dw[1], af, bf[2], bf[3]);
        }
      }
      const float* hac = hv + HeadVec::kAc;
      const float* hdt = hv + HeadVec::kDt;
      const float ac_a = hac[qa], ac_b = hac[qb];
      float row_a = 0.f, row_b = 0.f, colv[2][2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int s0 = 16 * cq + 8 * t + 2 * tq;
        float w[4];
        colv[t][0] = colv[t][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = e < 2 ? qa : qb;
          const int s = s0 + (e & 1);
          float wv = 0.f, nm = 0.f;
          if (cq <= rb && s <= q) {               // only s <= q reaches the exp
            float decay = expf((e < 2 ? ac_a : ac_b) - hac[s]);
            float dtv = hdt[s], cbd;
            if (intra) {
              decay = round_bf16(decay);
              dtv = round_bf16(dtv);
              cbd = round_bf16(round_bf16(cb[t][e]) * decay);
            } else {
              cbd = cb[t][e] * decay;
            }
            wv = cbd * dtv;
            dcb[t][e] += dw[t][e] * decay * dtv;
            nm = dw[t][e] * cbd;
          }
          w[e] = wv;
          if (e < 2) row_a = fmaf(hdt[s], nm, row_a);
          else row_b = fmaf(hdt[s], nm, row_b);
          colv[t][e & 1] += nm;
        }
        *reinterpret_cast<uint32_t*>(sW + qa * kRowX + s0) = pack_bf16(w[0], w[1]);
        *reinterpret_cast<uint32_t*>(sW + qb * kRowX + s0) = pack_bf16(w[2], w[3]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        row_a += __shfl_xor_sync(0xffffffffu, row_a, off);
        row_b += __shfl_xor_sync(0xffffffffu, row_b, off);
      }
      if (tq == 0) {
        hv[HeadVec::kRow + cq * kQ + qa] = row_a;
        hv[HeadVec::kRow + cq * kQ + qb] = row_b;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = colv[t][c];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (gq == 0) hv[HeadVec::kCol + rb * kQ + 16 * cq + 8 * t + 2 * tq + c] = v;
        }
    }

    // ---- [Q][N], columns [32 cq, 32 cq + 32): coef * (x D^T) into dB's sum;
    //      e * (dy S^T) into dC's sum and its row dots with C (the inter
    //      term of d(ac)); <D_k, S_{k-1}> over this warp's share of S
    {
      float tmp[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, sx + (q0 + ri + 8 * (mi % 2)) * kRowX + 16 * kk + 8 * (mi / 2));
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t bf[4];
          ldmatrix_x4(bf, sD + (32 * cq + 16 * jj + ri + 8 * (mi / 2)) * kRowX + 16 * kk +
                              8 * (mi % 2));
          mma_bf16(tmp[2 * jj], af, bf[0], bf[1]);
          mma_bf16(tmp[2 * jj + 1], af, bf[2], bf[3]);
        }
      }
      const float ca = hv[HeadVec::kCoef + qa], cb_ = hv[HeadVec::kCoef + qb];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        dBa[t][0] = fmaf(ca, tmp[t][0], dBa[t][0]);
        dBa[t][1] = fmaf(ca, tmp[t][1], dBa[t][1]);
        dBa[t][2] = fmaf(cb_, tmp[t][2], dBa[t][2]);
        dBa[t][3] = fmaf(cb_, tmp[t][3], dBa[t][3]);
        tmp[t][0] = tmp[t][1] = tmp[t][2] = tmp[t][3] = 0.f;
      }
      // B = S^T [p][n]: each lane's fragment is two fp32 pairs of row n,
      // rounded to bf16 here as the forward rounds its C S_{k-1} operand;
      // the warp adds D . S over k-step rb of its rows, so that the 16
      // warps cover S once
      float dotv = 0.f;
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, sg + (q0 + ri + 8 * (mi % 2)) * kRowX + 16 * kk + 8 * (mi / 2));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = 32 * cq + 8 * nt + gq;
          const float* srow = sS + n * kRowS + 16 * kk + 2 * tq;
          const float2 v0 = *reinterpret_cast<const float2*>(srow);
          const float2 v1 = *reinterpret_cast<const float2*>(srow + 8);
          mma_bf16(tmp[nt], af, pack_bf16(v0.x, v0.y), pack_bf16(v1.x, v1.y));
          if (kk == rb) {
            const __nv_bfloat16* drow = sD + n * kRowX + 16 * kk + 2 * tq;
            const float2 d0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(drow));
            const float2 d1 = unpack_bf16(*reinterpret_cast<const uint32_t*>(drow + 8));
            dotv = fmaf(d1.y, v1.y, fmaf(d1.x, v1.x, fmaf(d0.y, v0.y, fmaf(d0.x, v0.x, dotv))));
          }
        }
      }
      dotv = warp_sum(dotv);
      if (lane == 0) hv[HeadVec::kDot + warp] = dotv;
      const float ea = hv[HeadVec::kE + qa], eb = hv[HeadVec::kE + qb];
      float in_a = 0.f, in_b = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = 32 * cq + 8 * t + 2 * tq;
        const float2 c_a = unpack_bf16(*reinterpret_cast<const uint32_t*>(sC + qa * kRowB + n));
        const float2 c_b = unpack_bf16(*reinterpret_cast<const uint32_t*>(sC + qb * kRowB + n));
        in_a = fmaf(c_a.y, tmp[t][1], fmaf(c_a.x, tmp[t][0], in_a));
        in_b = fmaf(c_b.y, tmp[t][3], fmaf(c_b.x, tmp[t][2], in_b));
        dCa[t][0] = fmaf(ea, tmp[t][0], dCa[t][0]);
        dCa[t][1] = fmaf(ea, tmp[t][1], dCa[t][1]);
        dCa[t][2] = fmaf(eb, tmp[t][2], dCa[t][2]);
        dCa[t][3] = fmaf(eb, tmp[t][3], dCa[t][3]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        in_a += __shfl_xor_sync(0xffffffffu, in_a, off);
        in_b += __shfl_xor_sync(0xffffffffu, in_b, off);
      }
      if (tq == 0) {
        hv[HeadVec::kInter + cq * kQ + qa] = in_a;
        hv[HeadVec::kInter + cq * kQ + qb] = in_b;
      }
    }
    // ---- u = B D for dx's rows s of block rb, columns p in [16 cq,
    //      16 cq + 16); it needs no W, so it fills the wait for the barrier
    float u[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) u[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t af[4], bf[4];
      ldmatrix_x4(af, sB + (q0 + ri + 8 * (mi % 2)) * kRowB + 16 * kk + 8 * (mi / 2));
      ldmatrix_x4_trans(bf, sD + (16 * kk + ri + 8 * (mi % 2)) * kRowX + 16 * cq + 8 * (mi / 2));
      mma_bf16(u[0], af, bf[0], bf[1]);
      mma_bf16(u[1], af, bf[2], bf[3]);
    }
    __syncthreads();                // W is in shared memory

    // ---- dx = W^T dy + coef * u; dcoef = x . u
    {
      float acc[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      const int pc = 16 * cq;
#pragma unroll
      for (int kq = 0; kq < kQ / 16; ++kq) {
        if (kq < rb) continue;                  // W[q][s] = 0 for q < s
        uint32_t af[4], bf[4];                  // A = W^T [s][q] from W [q][s]
        ldmatrix_x4_trans(af, sW + (16 * kq + ri + 8 * (mi / 2)) * kRowX + q0 + 8 * (mi % 2));
        ldmatrix_x4_trans(bf, sg + (16 * kq + ri + 8 * (mi % 2)) * kRowX + pc + 8 * (mi / 2));
        mma_bf16(acc[0], af, bf[0], bf[1]);
        mma_bf16(acc[1], af, bf[2], bf[3]);
      }
      const float cfa = hv[HeadVec::kCoef + qa], cfb = hv[HeadVec::kCoef + qb];
      const int ta = t0 + qa, tb = t0 + qb;
      const size_t x_row = (size_t)a.H * kP;
      __nv_bfloat16* dxb = a.dx + (size_t)b * a.L * x_row + (size_t)h * kP;
      float dc_a = 0.f, dc_b = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int p = pc + 8 * t + 2 * tq;
        const float2 xa = unpack_bf16(*reinterpret_cast<const uint32_t*>(sx + qa * kRowX + p));
        const float2 xb = unpack_bf16(*reinterpret_cast<const uint32_t*>(sx + qb * kRowX + p));
        dc_a = fmaf(xa.y, u[t][1], fmaf(xa.x, u[t][0], dc_a));
        dc_b = fmaf(xb.y, u[t][3], fmaf(xb.x, u[t][2], dc_b));
        if (ta < a.L)
          *reinterpret_cast<uint32_t*>(dxb + (size_t)ta * x_row + p) =
              pack_bf16(fmaf(cfa, u[t][0], acc[t][0]), fmaf(cfa, u[t][1], acc[t][1]));
        if (tb < a.L)
          *reinterpret_cast<uint32_t*>(dxb + (size_t)tb * x_row + p) =
              pack_bf16(fmaf(cfb, u[t][2], acc[t][2]), fmaf(cfb, u[t][3], acc[t][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        dc_a += __shfl_xor_sync(0xffffffffu, dc_a, off);
        dc_b += __shfl_xor_sync(0xffffffffu, dc_b, off);
      }
      if (tq == 0) {
        hv[HeadVec::kDcoef + cq * kQ + qa] = dc_a;
        hv[HeadVec::kDcoef + cq * kQ + qb] = dc_b;
      }
    }
  }
  __syncthreads();                  // the last head's sums are in; W and the stages are free
  if (warp == kFinishWarp)
    finish_head(a, hv0 + ((nh - 1) % 3) * HeadVec::kFloats, sA[nh - 1], b, h0 + nh - 1, k);

  // ---- the group's sum of dcb, split into bf16 hi (in W's place) + lo (in
  //      the first stage's x), then dB += dcb^T C and dC += dcb B
  __nv_bfloat16* shi = sW;
  __nv_bfloat16* slo = reinterpret_cast<__nv_bfloat16*>(smem + ChunkSmem::kStage + Stage::kX);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int s = 16 * cq + 8 * t + 2 * tq;
    const uint32_t ha = pack_bf16(dcb[t][0], dcb[t][1]), hb = pack_bf16(dcb[t][2], dcb[t][3]);
    const float2 fa = unpack_bf16(ha), fb = unpack_bf16(hb);
    *reinterpret_cast<uint32_t*>(shi + qa * kRowX + s) = ha;
    *reinterpret_cast<uint32_t*>(shi + qb * kRowX + s) = hb;
    *reinterpret_cast<uint32_t*>(slo + qa * kRowX + s) = pack_bf16(dcb[t][0] - fa.x, dcb[t][1] - fa.y);
    *reinterpret_cast<uint32_t*>(slo + qb * kRowX + s) = pack_bf16(dcb[t][2] - fb.x, dcb[t][3] - fb.y);
  }
  __syncthreads();
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const __nv_bfloat16* sd = part == 0 ? shi : slo;
#pragma unroll
    for (int ks = 0; ks < kQ / 16; ++ks) {      // dC[q] += sum_{s <= q} dcb[q][s] B[s]
      if (ks > rb) continue;
      uint32_t af[4];
      ldmatrix_x4(af, sd + (q0 + ri + 8 * (mi % 2)) * kRowX + 16 * ks + 8 * (mi / 2));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, sB + (16 * ks + ri + 8 * (mi % 2)) * kRowB + 32 * cq + 16 * jj +
                                  8 * (mi / 2));
        mma_bf16(dCa[2 * jj], af, bf[0], bf[1]);
        mma_bf16(dCa[2 * jj + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int kq = 0; kq < kQ / 16; ++kq) {      // dB[s] += sum_{q >= s} dcb[q][s] C[q]
      if (kq < rb) continue;
      uint32_t af[4];
      ldmatrix_x4_trans(af, sd + (16 * kq + ri + 8 * (mi / 2)) * kRowX + q0 + 8 * (mi % 2));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, sC + (16 * kq + ri + 8 * (mi % 2)) * kRowB + 32 * cq + 16 * jj +
                                  8 * (mi / 2));
        mma_bf16(dBa[2 * jj], af, bf[0], bf[1]);
        mma_bf16(dBa[2 * jj + 1], af, bf[2], bf[3]);
      }
    }
  }
  const int ta = t0 + qa, tb = t0 + qb;
  const size_t row = (size_t)a.G * kN;
  const size_t off = (size_t)b * a.L * row + (size_t)g * kN;
  const size_t split_off = (size_t)sp * a.batch * a.L * row;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int n = 32 * cq + 8 * t + 2 * tq;
    const size_t ia = off + (size_t)ta * row + n, ib = off + (size_t)tb * row + n;
    if (a.splits == 1) {
      if (ta < a.L) {
        *reinterpret_cast<uint32_t*>(a.dB + ia) = pack_bf16(dBa[t][0], dBa[t][1]);
        *reinterpret_cast<uint32_t*>(a.dC + ia) = pack_bf16(dCa[t][0], dCa[t][1]);
      }
      if (tb < a.L) {
        *reinterpret_cast<uint32_t*>(a.dB + ib) = pack_bf16(dBa[t][2], dBa[t][3]);
        *reinterpret_cast<uint32_t*>(a.dC + ib) = pack_bf16(dCa[t][2], dCa[t][3]);
      }
    } else {
      if (ta < a.L) {
        *reinterpret_cast<float2*>(a.dB_part + split_off + ia) = make_float2(dBa[t][0], dBa[t][1]);
        *reinterpret_cast<float2*>(a.dC_part + split_off + ia) = make_float2(dCa[t][0], dCa[t][1]);
      }
      if (tb < a.L) {
        *reinterpret_cast<float2*>(a.dB_part + split_off + ib) = make_float2(dBa[t][2], dBa[t][3]);
        *reinterpret_cast<float2*>(a.dC_part + split_off + ib) = make_float2(dCa[t][2], dCa[t][3]);
      }
    }
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Heads of a group per launch-2 CTA. One CTA takes all of them unless the
// (b, group, chunk) CTAs fill less than half the card; then the group's heads
// are split evenly over as many CTAs as fill it, each writing fp32 dB / dC
// partials that the caller sums in a fixed order.
int head_splits(int batch, int L, int H, int G, int* heads_per_split) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return -err;
  const long ctas = (long)batch * ((L + kQ - 1) / kQ) * G;
  const int hg = H / G;
  int s = ctas >= sms ? 1 : (int)(sms / ctas);
  if (s > hg) s = hg;
  if (s < (hg + kMaxHeads - 1) / kMaxHeads) s = (hg + kMaxHeads - 1) / kMaxHeads;
  const int per = (hg + s - 1) / s;
  *heads_per_split = per;
  return (hg + per - 1) / per;
}

int launch_bf16(Bf16Args args, cudaStream_t stream) {
  const int cs = args.K < kMaxCluster ? args.K : kMaxCluster;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool ready[64] = {};
  static int max_clusters[64][kMaxCluster + 1] = {};
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ssd_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ChainSmem::kBytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ChunkSmem::kBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, args.H, args.batch);
  cfg.blockDim = dim3(kThreads1, 1, 1);
  cfg.dynamicSmemBytes = ChainSmem::kBytes;
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
    err = cudaOccupancyMaxActiveClusters(&max_clusters[dev][cs], ssd_bwd_chain_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (max_clusters[dev][cs] == 0) return (int)cudaErrorInvalidConfiguration;
  }
  err = cudaLaunchKernelEx(&cfg, ssd_bwd_chain_kernel, args);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<<<dim3(args.K, args.G * args.splits, args.batch), kThreads2,
                         ChunkSmem::kBytes, stream>>>(args);
  return (int)cudaGetLastError();
}

#endif  // SSD_BF16

}  // namespace

extern "C" {

// Whether the library is built for (P, N).
int hnet_ssd_bwd_supported(int P, int N) { return P == kP && N == kN; }

#if SSD_BF16
// For a bf16 call: how many CTAs share the heads of a group (>= 1), or a
// negative cudaError_t code. With more than one, the caller passes fp32
// dB_part / dC_part [splits, B, L, G, N] and sums them over the first axis.
int hnet_ssd_bwd_bf16_splits(int batch, int L, int H, int G) {
  if (batch <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0) return -(int)cudaErrorInvalidValue;
  int per = 0;
  return head_splits(batch, L, H, G, &per);
}

// bf16 x, B, C, dy and dx; fp32 dt, A, ddt, dA_part [B, H, K] (per chunk,
// which the caller sums), s_chunks [B, H, K, N, P] (the forward kernel's
// states before each chunk of 64). Db [B, H, K, N, P] bf16 is scratch that
// launch 1 fills with D_k for launch 2. dB / dC are
// written in bf16 when hnet_ssd_bwd_bf16_splits gives 1, else dB_part /
// dC_part in fp32. ds_final and ds0 may be null. Returns a cudaError_t code,
// 0 on success; launches asynchronously on `stream`.
int hnet_ssd_bwd_bf16(const void* x, const float* dt, const float* A, const void* B,
                      const void* C, const void* dy, const float* s_chunks,
                      const float* ds_final, void* Db, void* dx,
                      float* ddt, float* dA_part, void* dB, void* dC, float* dB_part,
                      float* dC_part, float* ds0, int batch, int L, int H, int G, int P,
                      int N, int intra_bf16, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || H <= 0 || H > 65535 || G <= 0 || H % G != 0 ||
      !hnet_ssd_bwd_supported(P, N))
    return (int)cudaErrorInvalidValue;
  int per = 0;
  const int splits = head_splits(batch, L, H, G, &per);
  if (splits < 0) return -splits;
  if (splits > 1 && (dB_part == nullptr || dC_part == nullptr)) return (int)cudaErrorInvalidValue;
  const Bf16Args args{static_cast<const __nv_bfloat16*>(x), dt, A,
                      static_cast<const __nv_bfloat16*>(B), static_cast<const __nv_bfloat16*>(C),
                      static_cast<const __nv_bfloat16*>(dy), s_chunks, ds_final,
                      static_cast<__nv_bfloat16*>(Db),
                      static_cast<__nv_bfloat16*>(dx), ddt, dA_part,
                      static_cast<__nv_bfloat16*>(dB), static_cast<__nv_bfloat16*>(dC), dB_part,
                      dC_part, ds0, batch, L, H, G, (L + kQ - 1) / kQ, intra_bf16, splits, per};
  return launch_bf16(args, static_cast<cudaStream_t>(stream));
}

#endif  // SSD_BF16

// fp32 x, B, C, dy and dx (PR-3 SIMT kernel). dB_part / dC_part are the
// per-head gradients [B, L, H, N] and dA_part [B, H] the per-(b, h) sums,
// which the caller reduces. Returns a cudaError_t code, 0 on success.
int hnet_ssd_bwd_fp32(const float* x, const float* dt, const float* A, const float* B,
                      const float* C, const float* dy, const float* s_chunks,
                      const float* ds_final, float* dx, float* ddt, float* dA_part,
                      float* dB_part, float* dC_part, float* ds0, int batch, int L, int H,
                      int G, int P, int N, int intra_bf16, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      !hnet_ssd_bwd_supported(P, N))
    return (int)cudaErrorInvalidValue;
  const simt::Args args{x, dt, A, B, C, dy, s_chunks, ds_final, dx, ddt, dA_part, dB_part,
                        dC_part, ds0, L, H, G, (L + kQ - 1) / kQ, intra_bf16};
  return simt::launch(args, batch, static_cast<cudaStream_t>(stream));
}

const char* hnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
