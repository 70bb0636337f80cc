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
// (in z's dtype), not a recomputation.
//
// What bounds it on the card. The function reads z (and p) once and writes
// zbar once; its backward reads z, zbar, g and p and writes dz and dP. A few
// FLOPs per element: both are bound by bytes (a bf16 forward at B 64, M 256,
// D 384 moves ~25 MB, ~7.5 us at 3.35 TB/s). The time along a row is a chain
// of M dependent steps.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at that shape the
// forward takes ~31 % of its bound and the backward ~13 %. Its 64 CTAs use
// 64 of the 132 SMs; issuing the loads of more steps at once did not help.
//
// What this design does about it:
// - One CTA per batch row, one thread per channel (D <= 1024): each step's
//   loads of z_t (and g_t, zbar_{t-1}) are coalesced across d, and P_t is
//   clamped once and broadcast through shared memory, a tile of kTile slots
//   at a time.
// - The loads of kUnroll steps are issued before their arithmetic, so that
//   kUnroll loads per thread are in flight across the dependent chain.
// - dP's sum over d: a warp shuffle per step, one partial per warp in
//   shared memory, then one thread per slot adds the warps' partials in a
//   fixed order. No atomics: two calls give bitwise-equal gradients.
// Not done: more CTAs than rows (split D, with per-split dP partials summed
// in a fixed order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // slots per shared-memory tile of P (and dP partials)
constexpr int kUnroll = 8;     // steps whose loads are issued together
constexpr int kMaxChannels = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// torch.clamp(p, lo, hi) = min(max(p, lo), hi)
__device__ __forceinline__ float clamp_p(float p, float lo, float hi) {
  return fminf(fmaxf(p, lo), hi);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void ema_fwd_kernel(const T* __restrict__ z, const float* __restrict__ p,
                               T* __restrict__ out, int M, int D, float lo, float hi) {
  __shared__ float sp[kTile];
  const int d = threadIdx.x;
  const bool active = d < D;
  const size_t row = (size_t)blockIdx.x * M;
  const T* zr = z + row * D + d;
  T* outr = out + row * D + d;
  const float* pr = p + row;
  float s = 0.f;
  for (int t0 = 0; t0 < M; t0 += kTile) {
    const int n = min(kTile, M - t0);
    __syncthreads();                   // the last tile's P are read
    for (int i = threadIdx.x; i < n; i += blockDim.x) sp[i] = clamp_p(pr[t0 + i], lo, hi);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; j += kUnroll) {
      float zv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        zv[u] = j + u < n ? to_f(zr[(size_t)(t0 + j + u) * D]) : 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u < n) {
          const int t = t0 + j + u;
          const float P = sp[j + u];
          s = t == 0 ? zv[u] : P * zv[u] + (1.f - P) * s;
          outr[(size_t)t * D] = from_f<T>(s);
        }
      }
    }
  }
}

template <typename T>
__global__ void ema_bwd_kernel(const T* __restrict__ z, const float* __restrict__ p,
                               const T* __restrict__ zbar, const T* __restrict__ g,
                               T* __restrict__ dz, float* __restrict__ dp, int M, int D,
                               float lo, float hi) {
  __shared__ float sp[kTile + 1];      // clamped P of the tile's slots and the next slot
  __shared__ float red[kTile][33];     // dP partials, one per warp (<= 32 warps)
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5, nwarps = blockDim.x >> 5;
  const bool active = d < D;
  const size_t row = (size_t)blockIdx.x * M;
  const float* pr = p + row;
  float h = 0.f;                       // dL/dzbar_t through every later slot
  for (int t0 = (M - 1) / kTile * kTile; t0 >= 0; t0 -= kTile) {
    const int n = min(kTile, M - t0);
    __syncthreads();                   // the last tile's sp and red are read
    for (int i = threadIdx.x; i <= n; i += blockDim.x)
      sp[i] = t0 + i < M ? clamp_p(pr[t0 + i], lo, hi) : 0.f;
    __syncthreads();
    for (int j = n - 1; j >= 0; j -= kUnroll) {
      // slots t0 + j, t0 + j - 1, ...: loads first, then the chain
      float gv[kUnroll], zv[kUnroll], zp[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + j - u;
        const bool ok = active && j - u >= 0;
        const size_t at = (row + t) * D + d;
        gv[u] = ok ? to_f(g[at]) : 0.f;
        zv[u] = ok ? to_f(z[at]) : 0.f;
        zp[u] = ok && t > 0 ? to_f(zbar[at - D]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = j - u;           // the same for every thread of the CTA
        if (i < 0) break;
        const int t = t0 + i;
        h = gv[u] + (1.f - sp[i + 1]) * h;
        if (active) dz[(row + t) * D + d] = from_f<T>(t > 0 ? sp[i] * h : h);
        const float v = warp_sum(t > 0 ? h * (zv[u] - zp[u]) : 0.f);
        if (lane == 0) red[i][warp] = v;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += red[i][w];
      const int t = t0 + i;
      const float raw = pr[t];
      dp[row + t] = t > 0 && raw >= lo && raw <= hi ? s : 0.f;
    }
  }
}

int threads_for(int D) { return (D + 31) / 32 * 32; }

}  // namespace

extern "C" {

// The widest D the kernels take (one thread per channel).
int hnet_ema_max_channels() { return kMaxChannels; }

// dtype: 0 = float32, 1 = bfloat16 (z and out); p is float32 [batch, M].
// lo, hi: the clamp of P. Returns a cudaError_t code, 0 on success; launches
// asynchronously on `stream`.
int hnet_ema_fwd(int dtype, const void* z, const float* p, void* out, int batch, int M,
                 int D, float lo, float hi, void* stream) {
  if (batch <= 0 || M <= 0 || D <= 0 || D > kMaxChannels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch), block(threads_for(D));
  if (dtype == 0)
    ema_fwd_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(z), p,
                                                 static_cast<float*>(out), M, D, lo, hi);
  else if (dtype == 1)
    ema_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), p, static_cast<__nv_bfloat16*>(out), M, D,
        lo, hi);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// z, zbar (the forward's output), g (dL/dzbar) and dz in `dtype`; p and dp
// float32 [batch, M].
int hnet_ema_bwd(int dtype, const void* z, const float* p, const void* zbar, const void* g,
                 void* dz, float* dp, int batch, int M, int D, float lo, float hi,
                 void* stream) {
  if (batch <= 0 || M <= 0 || D <= 0 || D > kMaxChannels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch), block(threads_for(D));
  if (dtype == 0)
    ema_bwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(z), p, static_cast<const float*>(zbar),
        static_cast<const float*>(g), static_cast<float*>(dz), dp, M, D, lo, hi);
  else if (dtype == 1)
    ema_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), p, static_cast<const __nv_bfloat16*>(zbar),
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dz), dp, M, D,
        lo, hi);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* hnet_ema_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
