// Flash-decode attention of Gq query rows per plane over KIVI-packed K/V,
// dequantized on the fly, for Hopper (sm_90a). Plain C interface, loaded
// with ctypes (see ../kernel.py).
//
// Replaces the TPU kernel fused_decode_attention (body _decode_kernel) of
// src/repro/kernels/decode_attn/kernel.py:133. Per plane (batch x KV
// head): out = softmax(q k^T / sqrt(hd), tokens >= cur_len masked with
// -1e30) v, with K and V read in their packed layout (kivi_planes.cuh).
//
// What bounds it: bytes, and the few planes. A decode step does 4 Gq hd
// operations per token against about hd (bits/4 + 16/group) bytes, far
// below the card's f32 balance, so reading the packed plane (8 planes x
// 4096 tokens x 128 channels is 5 MB at 4 bits) sets the floor: a few
// microseconds. But one request has only P = 8 planes against 132 SMs,
// and the TPU kernel walks the tokens of a plane in sequence.
// What the design does about it (flash-decoding): the tokens of a plane
// are cut into splits of split_len tokens; grid (splits, row blocks,
// planes) puts a few hundred blocks on the card, each dequantizing its
// tiles once into shared memory for all Gq rows and keeping an
// unnormalised (m, l, acc) per row; a second kernel (flash::merge_splits)
// weights every split by exp(m_split - m_all) and normalises. A split
// wholly past cur_len carries m = -1e30 and l = its token count, so with
// cur_len = 0 every split weighs 1 and the result is the uniform mean of
// all T values, as the reference gives. Tensor cores, cp.async/TMA
// staging and a shared-memory ring are later work.
#include "kivi_planes.cuh"

namespace {

using flash::kThreads;
using flash::kWarps;

template <int BITS, int RPW>
__global__ void __launch_bounds__(kThreads)
    decode_split(const float* __restrict__ q, const uint8_t* __restrict__ kp,
                 const float* __restrict__ ks, const float* __restrict__ kz,
                 const uint8_t* __restrict__ vp,
                 const float* __restrict__ vs, const float* __restrict__ vz,
                 const int* __restrict__ cur_len, float* __restrict__ m_ws,
                 float* __restrict__ l_ws, float* __restrict__ acc_ws,
                 int rows, int T, int hd, int kg, int vg, int split_len,
                 float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int RB = kWarps * RPW;
  const int split = blockIdx.x, r0 = blockIdx.y * RB, p = blockIdx.z;
  const kivi_planes::Plane pl = kivi_planes::plane_at<BITS>(
      kp, ks, kz, vp, vs, vz, p, T, hd, kg, vg);
  flash::load_rows(q + static_cast<int64_t>(p) * rows * hd, hd, r0, RB,
                   rows, hd, smem);
  flash::Rows<RPW> st;
  st.init();
  const int t_begin = split * split_len;
  kivi_planes::attend_split<BITS, RPW>(st, pl, t_begin,
                                       min(T, t_begin + split_len),
                                       cur_len[p], hd, kg, vg, scale, smem,
                                       RB);
  const int64_t base =
      (static_cast<int64_t>(p) * gridDim.x + split) * rows;
  flash::store_partial<RPW>(st, r0, rows, hd, base, m_ws, l_ws, acc_ws);
}

template <int BITS, int RPW>
cudaError_t launch(const float* q, const uint8_t* kp, const float* ks,
                   const float* kz, const uint8_t* vp, const float* vs,
                   const float* vz, const int* cur_len, float* m_ws,
                   float* l_ws, float* acc_ws, int P, int rows, int T,
                   int hd, int kg, int vg, int split_len, float scale,
                   cudaStream_t stream) {
  constexpr int RB = kWarps * RPW;
  auto kernel = decode_split<BITS, RPW>;
  static const cudaError_t smem_err = flash::allow_smem(kernel, RB);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid((T + split_len - 1) / split_len, (rows + RB - 1) / RB, P);
  const size_t smem = flash::smem_floats(RB, hd) * sizeof(float);
  kernel<<<grid, kThreads, smem, stream>>>(q, kp, ks, kz, vp, vs, vz,
                                           cur_len, m_ws, l_ws, acc_ws,
                                           rows, T, hd, kg, vg, split_len,
                                           scale);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(const float* q, const uint8_t* kp, const float* ks,
                        const float* kz, const uint8_t* vp, const float* vs,
                        const float* vz, const int* cur_len, float* m_ws,
                        float* l_ws, float* acc_ws, int P, int rows, int T,
                        int hd, int kg, int vg, int split_len, float scale,
                        cudaStream_t stream) {
  switch (flash::rows_per_warp(rows)) {
    case 1:
      return launch<BITS, 1>(q, kp, ks, kz, vp, vs, vz, cur_len, m_ws, l_ws,
                             acc_ws, P, rows, T, hd, kg, vg, split_len,
                             scale, stream);
    case 2:
      return launch<BITS, 2>(q, kp, ks, kz, vp, vs, vz, cur_len, m_ws, l_ws,
                             acc_ws, P, rows, T, hd, kg, vg, split_len,
                             scale, stream);
    default:
      return launch<BITS, 8>(q, kp, ks, kz, vp, vs, vz, cur_len, m_ws, l_ws,
                             acc_ws, P, rows, T, hd, kg, vg, split_len,
                             scale, stream);
  }
}

}  // namespace

// q (P, rows, hd) f32; packed K/V planes as in kivi_planes.cuh; cur_len
// (P,) i32; workspace m_ws/l_ws (P, n_splits, rows) and acc_ws (P,
// n_splits, rows, hd) f32 with n_splits = ceil(T / split_len); out (P,
// rows, hd) f32. Launches the split kernel and the merge kernel on
// ``stream`` and returns cudaGetLastError() (cudaErrorInvalidValue,
// without launching, for a layout the kernels do not take).
extern "C" int decode_attn(const void* q, const void* kp, const void* ks,
                           const void* kz, const void* vp, const void* vs,
                           const void* vz, const void* cur_len, void* m_ws,
                           void* l_ws, void* acc_ws, void* out, int P,
                           int rows, int T, int hd, int bits, int k_group,
                           int v_group, int split_len, float scale,
                           void* stream) {
  if (!kivi_planes::layout_ok(T, hd, bits, k_group, v_group) || P <= 0 ||
      rows <= 0 || split_len <= 0 || split_len % flash::kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kpb = static_cast<const uint8_t*>(kp);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* kzf = static_cast<const float*>(kz);
  const auto* vpb = static_cast<const uint8_t*>(vp);
  const auto* vsf = static_cast<const float*>(vs);
  const auto* vzf = static_cast<const float*>(vz);
  const auto* cl = static_cast<const int*>(cur_len);
  auto* m = static_cast<float*>(m_ws);
  auto* l = static_cast<float*>(l_ws);
  auto* a = static_cast<float*>(acc_ws);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bits) {
    case 2:
      err = launch_bits<2>(qf, kpb, ksf, kzf, vpb, vsf, vzf, cl, m, l, a, P,
                           rows, T, hd, k_group, v_group, split_len, scale,
                           st);
      break;
    case 4:
      err = launch_bits<4>(qf, kpb, ksf, kzf, vpb, vsf, vzf, cl, m, l, a, P,
                           rows, T, hd, k_group, v_group, split_len, scale,
                           st);
      break;
    default:
      err = launch_bits<8>(qf, kpb, ksf, kzf, vpb, vsf, vzf, cl, m, l, a, P,
                           rows, T, hd, k_group, v_group, split_len, scale,
                           st);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_splits = (T + split_len - 1) / split_len;
  flash::merge_splits<<<dim3(rows, P), (hd + 31) / 32 * 32, 0, st>>>(
      m, l, a, static_cast<float*>(out), n_splits, rows, hd);
  return static_cast<int>(cudaGetLastError());
}
