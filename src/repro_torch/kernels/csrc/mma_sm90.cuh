// The Hopper helpers that the port's kernels share: the bf16 mma.sync
// kernels (prefill_attn's flash_fwd_mma and flash_fwd_mma_f32,
// fused_prefill's fused_mma) and the cp.async rings (those kernels' and
// decode_attn's decode_ring). Header only; each kernel's .cu includes it.
//
//  - cp.async: 16-byte copies from global to shared memory that bypass L1,
//    zero-filled where the source is not valid, grouped and waited on, and
//    a block's copy of a flat run of bytes made of them;
//  - ldmatrix: four 8 x 8 bf16 matrices from shared memory into the
//    fragments of mma.sync, as they lie (B of a row-major K tile) or
//    transposed (B of a row-major V tile);
//  - mma.sync m16n8k16 with bf16 inputs and f32 accumulators;
//  - split2: two f32 values as a two-part bf16 pair (hi + lo), which keeps
//    16 significant bits where one bf16 keeps 8; split3 as three parts,
//    which keep all 24.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A block of NT threads copies the first n_valid of n_cap bytes (both
// multiples of 16) at src to the shared byte address dst, 16 bytes a
// thread a step; zeros past n_valid. Not waited on: the caller commits.
template <int NT>
__device__ __forceinline__ void copy_flat(uint32_t dst, const void* src,
                                          int n_valid, int n_cap) {
  const char* s = static_cast<const char*>(src);
  for (int i = threadIdx.x * 16; i < n_cap; i += NT * 16) {
    const bool valid = i < n_valid;
    cp_async16(dst + i, valid ? s + i : s, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two f32 values of neighbouring columns as a two-part bf16 pair: hi
// rounds each value to bf16, lo rounds what hi left out.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The same as three parts, hi + mid + lo, which keep all 24 significant
// bits of an f32 value: mid rounds what hi left out, lo what both left.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;   // exact
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

}  // namespace sm90
