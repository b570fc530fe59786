// Chunk-prefill attention of C query rows per plane over a KIVI-packed
// prefix plus the chunk's own causal block, for Hopper (sm_90a). Plain C
// interface, loaded with ctypes (see ../kernel.py).
//
// Replaces the TPU kernel fused_chunk_prefill (body _fused_chunk_kernel)
// of src/repro/kernels/fused_prefill/kernel.py:127. Per plane: the chunk's
// rows attend (a) the T-token packed prefix, every column visible unless
// it lies at or past cur_len (masked with -1e30), and (b) the chunk's own
// f32 keys under the causal mask, whose diagonal is always visible. One
// softmax runs over [prefix; chunk].
//
// What bounds it: operations. Each prefix token costs 4 C hd f32
// operations against about hd (bits/4 + 16/group) bytes; at C = 32 that
// is some 250 operations a byte, above the card's f32 balance of 20, so
// the f32 FFMA rate sets the floor (the tensor cores would move it; they
// are later work). The dequantize rides inside: each block unpacks a
// 32-token tile once into shared memory and all its C rows use it, and
// the dequantized prefix never reaches device memory.
// What the design does about it: planes are few (P = 32 at full width),
// so the prefix is split across blocks as in decode_attn (flash-decoding);
// the chunk's own causal block is one more split. Grid (prefix splits +
// 1, row blocks of 32, planes); flash::merge_splits combines the splits.
// The scores and P @ V loops read shared memory as float4 with each
// warp owning 8 rows, about 2.7 FFMA per shared-memory wavefront.
#include "../../decode_attn/csrc/kivi_planes.cuh"

namespace {

using flash::kThreads;
using flash::kTile;
using flash::kWarps;

constexpr int kRpw = 8;
constexpr int kRb = kWarps * kRpw;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
    fused_split(const float* __restrict__ q, const uint8_t* __restrict__ kp,
                const float* __restrict__ ks, const float* __restrict__ kz,
                const uint8_t* __restrict__ vp, const float* __restrict__ vs,
                const float* __restrict__ vz, const float* __restrict__ kc,
                const float* __restrict__ vc,
                const int* __restrict__ cur_len, float* __restrict__ m_ws,
                float* __restrict__ l_ws, float* __restrict__ acc_ws, int C,
                int T, int hd, int kg, int vg, int split_len, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int split = blockIdx.x, r0 = blockIdx.y * kRb, p = blockIdx.z;
  const int64_t plane_rows = static_cast<int64_t>(p) * C * hd;
  flash::load_rows(q + plane_rows, hd, r0, kRb, C, hd, smem);
  flash::Rows<kRpw> st;
  st.init();
  if (split + 1 < static_cast<int>(gridDim.x)) {
    // a split of the packed prefix
    const kivi_planes::Plane pl = kivi_planes::plane_at<BITS>(
        kp, ks, kz, vp, vs, vz, p, T, hd, kg, vg);
    const int t_begin = split * split_len;
    kivi_planes::attend_split<BITS, kRpw>(st, pl, t_begin,
                                          min(T, t_begin + split_len),
                                          cur_len[p], hd, kg, vg, scale,
                                          smem, kRb);
  } else {
    // the chunk's own keys, causal: tiles past the block's last row are
    // wholly masked and skipped
    float* k_s = smem + kRb * hd;
    float* v_s = k_s + kTile * (hd + 4);
    float* p_s = v_s + kTile * hd;
    const int t_end = min(C, r0 + kRb);
    for (int t0 = 0; t0 < t_end; t0 += kTile) {
      const int n = min(kTile, C - t0);
      __syncthreads();
      flash::load_dense_tile(kc + plane_rows, vc + plane_rows, hd, t0, n,
                             hd, k_s, v_s);
      __syncthreads();
      flash::tile_step<kRpw>(st, smem, k_s, v_s, p_s, hd, scale,
                             [=](int r, int t, float s) {
                               return t >= n ? -INFINITY
                                             : (t0 + t <= r0 + r
                                                    ? s : flash::kNegInf);
                             });
    }
  }
  const int64_t base = (static_cast<int64_t>(p) * gridDim.x + split) * C;
  flash::store_partial<kRpw>(st, r0, C, hd, base, m_ws, l_ws, acc_ws);
}

template <int BITS>
cudaError_t launch(const float* q, const uint8_t* kp, const float* ks,
                   const float* kz, const uint8_t* vp, const float* vs,
                   const float* vz, const float* kc, const float* vc,
                   const int* cur_len, float* m_ws, float* l_ws,
                   float* acc_ws, int P, int C, int T, int hd, int kg, int vg,
                   int split_len, float scale, cudaStream_t stream) {
  auto kernel = fused_split<BITS>;
  static const cudaError_t smem_err = flash::allow_smem(kernel, kRb);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid((T + split_len - 1) / split_len + 1, (C + kRb - 1) / kRb,
                  P);
  const size_t smem = flash::smem_floats(kRb, hd) * sizeof(float);
  kernel<<<grid, kThreads, smem, stream>>>(q, kp, ks, kz, vp, vs, vz, kc, vc,
                                           cur_len, m_ws, l_ws, acc_ws, C, T,
                                           hd, kg, vg, split_len, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k_chunk, v_chunk (P, C, hd) f32; packed prefix planes as in
// kivi_planes.cuh; cur_len (P,) i32; workspace m_ws/l_ws (P, n_splits, C)
// and acc_ws (P, n_splits, C, hd) f32 with n_splits = ceil(T / split_len)
// + 1; out (P, C, hd) f32. Launches the split kernel and the merge kernel
// on ``stream`` and returns cudaGetLastError() (cudaErrorInvalidValue,
// without launching, for a layout the kernels do not take).
extern "C" int fused_prefill(const void* q, const void* kp, const void* ks,
                             const void* kz, const void* vp, const void* vs,
                             const void* vz, const void* k_chunk,
                             const void* v_chunk, const void* cur_len,
                             void* m_ws, void* l_ws, void* acc_ws, void* out,
                             int P, int C, int T, int hd, int bits,
                             int k_group, int v_group, int split_len,
                             float scale, void* stream) {
  if (!kivi_planes::layout_ok(T, hd, bits, k_group, v_group) || P <= 0 ||
      C <= 0 || split_len <= 0 || split_len % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kpb = static_cast<const uint8_t*>(kp);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* kzf = static_cast<const float*>(kz);
  const auto* vpb = static_cast<const uint8_t*>(vp);
  const auto* vsf = static_cast<const float*>(vs);
  const auto* vzf = static_cast<const float*>(vz);
  const auto* kcf = static_cast<const float*>(k_chunk);
  const auto* vcf = static_cast<const float*>(v_chunk);
  const auto* cl = static_cast<const int*>(cur_len);
  auto* m = static_cast<float*>(m_ws);
  auto* l = static_cast<float*>(l_ws);
  auto* a = static_cast<float*>(acc_ws);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bits) {
    case 2:
      err = launch<2>(qf, kpb, ksf, kzf, vpb, vsf, vzf, kcf, vcf, cl, m, l, a,
                      P, C, T, hd, k_group, v_group, split_len, scale, st);
      break;
    case 4:
      err = launch<4>(qf, kpb, ksf, kzf, vpb, vsf, vzf, kcf, vcf, cl, m, l, a,
                      P, C, T, hd, k_group, v_group, split_len, scale, st);
      break;
    default:
      err = launch<8>(qf, kpb, ksf, kzf, vpb, vsf, vzf, kcf, vcf, cl, m, l, a,
                      P, C, T, hd, k_group, v_group, split_len, scale, st);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_splits = (T + split_len - 1) / split_len + 1;
  flash::merge_splits<<<dim3(C, P), (hd + 31) / 32 * 32, 0, st>>>(
      m, l, a, static_cast<float*>(out), n_splits, C, hd);
  return static_cast<int>(cudaGetLastError());
}
