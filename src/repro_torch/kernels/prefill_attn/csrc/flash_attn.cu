// Causal flash attention for prefill, GQA, for Hopper (sm_90a). Plain C
// interface, loaded with ctypes (see ../kernel.py).
//
// Replaces the TPU kernel flash_attention (body _flash_kernel) of
// src/repro/kernels/prefill_attn/kernel.py:73 together with the GQA
// wrapper ops.causal_attention (src/repro/kernels/prefill_attn/ops.py),
// which repeats each KV head over its query heads in memory first. Here
// the kernel reads the model layout directly: q (B, S, H, hd), k and v
// (B, S, Kv, hd), f32 or bf16, computed in f32; out (B, S, H, hd) f32.
// Query head h reads KV head h / (H / Kv), so no repeated copy exists.
//
// What bounds it: operations. Causal attention does 4 hd S(S+1)/2
// operations per (batch, head) against 3 S hd input values; at S = 4096
// that is thousands of operations a byte. With f32 FFMA on the CUDA cores
// (no TF32, so the tolerance of the reference's own tests holds) the
// floor is 67 TFLOP/s: about 2 ms for B = 1, H = 32, hd = 128. The tensor
// cores (wgmma) would lower it many times; they are later work.
// What the design does about it: one block per (32 query rows, head,
// batch), heaviest row blocks first; it walks key tiles of 32 up to its
// last row only, so tiles above the diagonal cost nothing, and masks the
// diagonal tile with -1e30 as the reference does. Key and value tiles are
// staged in shared memory as f32 and serve all 32 rows (flash_tile.cuh).
#include <cuda_bf16.h>

#include "../../csrc/flash_tile.cuh"

namespace {

using flash::kThreads;
using flash::kTile;
using flash::kWarps;

constexpr int kRpw = 8;
constexpr int kRb = kWarps * kRpw;

template <typename In>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const In* __restrict__ q, const In* __restrict__ k,
              const In* __restrict__ v, float* __restrict__ out, int S,
              int H, int Kv, int hd, float scale) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kRb * hd;
  float* v_s = k_s + kTile * (hd + 4);
  float* p_s = v_s + kTile * hd;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRb;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / Kv);
  const int64_t q_stride = static_cast<int64_t>(H) * hd;
  const int64_t kv_stride = static_cast<int64_t>(Kv) * hd;
  const int64_t q_base = static_cast<int64_t>(b) * S * q_stride +
                         static_cast<int64_t>(h) * hd;
  const int64_t kv_base = static_cast<int64_t>(b) * S * kv_stride +
                          static_cast<int64_t>(kvh) * hd;
  flash::load_rows(q + q_base, q_stride, r0, kRb, S, hd, q_s);
  flash::Rows<kRpw> st;
  st.init();
  const int t_end = min(S, r0 + kRb);
  for (int t0 = 0; t0 < t_end; t0 += kTile) {
    const int n = min(kTile, S - t0);
    __syncthreads();
    flash::load_dense_tile(k + kv_base, v + kv_base, kv_stride, t0, n, hd,
                           k_s, v_s);
    __syncthreads();
    flash::tile_step<kRpw>(st, q_s, k_s, v_s, p_s, hd, scale,
                           [=](int r, int t, float s) {
                             return t >= n ? -INFINITY
                                           : (t0 + t <= r0 + r
                                                  ? s : flash::kNegInf);
                           });
  }
  flash::store_rows<kRpw>(st, r0, S, hd, out + q_base, q_stride);
}

template <typename In>
cudaError_t launch(const void* q, const void* k, const void* v, float* out,
                   int B, int S, int H, int Kv, int hd, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd<In>;
  static const cudaError_t smem_err = flash::allow_smem(kernel, kRb);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid((S + kRb - 1) / kRb, H, B);
  const size_t smem = flash::smem_floats(kRb, hd) * sizeof(float);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(q), static_cast<const In*>(k),
      static_cast<const In*>(v), out, S, H, Kv, hd, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, hd), k/v (B, S, Kv, hd), all f32 (dtype 0) or all bf16
// (dtype 1), contiguous; out (B, S, H, hd) f32. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without
// launching, for a shape the kernel does not take).
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int H, int Kv, int hd,
                          int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 ||
      !flash::hd_ok(hd) || H > 65535 || B > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch<float>(q, k, v, o, B, S, H, Kv, hd, scale, st)
          : launch<__nv_bfloat16>(q, k, v, o, B, S, H, Kv, hd, scale, st);
  return static_cast<int>(err);
}
