// Shared by the Hopper SSD kernels (ssd_fwd.cu, ssd_bwd.cu): the chunk and
// head sizes the libraries are built for, and the device helpers of the bf16
// kernels (cp.async copies, ldmatrix, mma.sync bf16 products, bf16 packing,
// warp scans). ops/cuda_build.py hashes this header with each source.
//
// A library is built for one (headdim P, d_state N): 64 and 128 by default,
// another pair with -DSSD_HEADDIM=... -DSSD_DSTATE=... (multiples of 16).
// The bf16 kernels are written for (64, 128) only; a build for another pair
// holds the fp32 kernels (SSD_BF16 is 0 there).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef SSD_HEADDIM
#define SSD_HEADDIM 64
#endif
#ifndef SSD_DSTATE
#define SSD_DSTATE 128
#endif
#define SSD_BF16 (SSD_HEADDIM == 64 && SSD_DSTATE == 128)

constexpr int kQ = 64;                 // chunk length
constexpr int kP = SSD_HEADDIM;        // headdim the library is built for
constexpr int kN = SSD_DSTATE;         // d_state the library is built for
static_assert(kP % 16 == 0 && kN % 16 == 0, "P and N must be multiples of 16");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Inclusive scan over a warp (all 32 lanes call it). The chunk's cumsum is
// two of these, the second warp's then adding the first warp's total.
__device__ __forceinline__ float warp_inclusive_scan(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) >= off) v += u;
  }
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when `valid` is false (the source
// must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// D[16x8] += A[16x16] B[16x8], bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

}  // namespace
